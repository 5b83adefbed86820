"""Texture descriptors (host side).

Mirrors the reference's ``src/material/texture.rs``. At scene-compile time all
textures are packed into a single flat *texture arena* — one (N, 3) float32
device array plus per-texture (offset, width, height) records — so texture
lookup inside the wavefront kernel is a single vectorized gather with no
per-texture dispatch. Solid colors become 1×1 arena entries, which unifies
texture sampling AND makes every material color differentiable through one
parameter array.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils import height_to_normal_map


class Texture:
    pass


class SolidColor(Texture):
    """Uniform color texture (texture.rs:101-124)."""

    def __init__(self, r, g=None, b=None):
        if g is None:
            # vec3-like
            r, g, b = np.asarray(r, np.float64)
        self.rgb = np.array([r, g, b], np.float64)

    @staticmethod
    def new_from_vec3(v):
        return SolidColor(*np.asarray(v, np.float64))


class ImageMap(Texture):
    """Image-backed texture; nearest-neighbor sampling with abs-wrap UVs and
    flipped v (texture.rs:167-180)."""

    def __init__(self, image_u8):
        self.image = np.ascontiguousarray(np.asarray(image_u8, np.uint8))
        if self.image.ndim != 3 or self.image.shape[2] != 3:
            raise ValueError("ImageMap expects an (H, W, 3) u8 image")

    @staticmethod
    def load(path):
        return ImageMap(_read_rgb(path, "image"))


def _read_rgb(path, kind):
    """Decode an image to (H, W, 3) u8 RGB with descriptive errors matching
    the reference loader (texture.rs:53-66, 137-153)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Failed to open {kind} texture {path}: No such file or directory")
    from PIL import Image

    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    except Exception as err:  # noqa: BLE001 — map to reference error text
        raise ValueError(f"Failed to decode {kind} texture {path}: {err}") from err


def load_bump_map(path):
    """Load a bump texture and auto-detect normal-vs-height map by pixel
    statistics (texture.rs:53-86). Returns ("normal"|"height", image)."""
    image = _read_rgb(path, "bump")
    p = image.astype(np.float64) / 255.0
    lengths = np.sqrt((p * p).sum(axis=-1))
    num_normal = int(np.count_nonzero(np.abs(lengths - 1.0) < 0.05))
    grayish = (np.abs(p[..., 0] - p[..., 1]) < 0.05) & (np.abs(p[..., 1] - p[..., 2]) < 0.05)
    num_height = int(np.count_nonzero(grayish))
    return ("height", image) if num_height > num_normal else ("normal", image)


def load_normal_texture(path):
    """Load a normal map; height maps are converted via the Sobel filter
    (texture.rs:89-97, height_map.rs:68-86)."""
    kind, image = load_bump_map(path)
    if kind == "height":
        image = height_to_normal_map(image)
    return ImageMap(image)
