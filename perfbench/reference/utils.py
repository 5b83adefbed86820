"""Tone mapping and height -> normal maps: a frozen copy of part of
``solstrale_tpu_torch``'s ``utils``, with the upstream library's
``src/util/`` semantics.
"""
from __future__ import annotations

import numpy as np
import torch

COLOR_INTENSITY_MIN = -0.999
COLOR_INTENSITY_MAX = 0.999


def to_float(col, samples_per_pixel):
    """Normalize an accumulated color sum by sample count, gamma-2 correct
    (sqrt) and clamp to +-0.999 (rgb_color.rs:21-34). Works on (..., 3)."""
    scale = 1.0 / samples_per_pixel
    c = torch.sqrt(torch.clamp(col * scale, min=0.0))
    return torch.clamp(c, COLOR_INTENSITY_MIN, COLOR_INTENSITY_MAX)


def to_rgb_u8(col, samples_per_pixel):
    """Accumulated color sum -> u8 image; x256 then truncate like the
    reference's `as u8` cast (rgb_color.rs:14-17)."""
    c = to_float(col, samples_per_pixel)
    return torch.clamp(torch.floor(256.0 * c), 0, 255).to(torch.uint8)


HEIGHT_MAP_STRENGTH = 6.0


def height_to_normal_map(height_u8):
    """Sobel-like height->normal conversion (height_map.rs:49-95).

    height_u8: (H, W, 3) u8 image; uses the red channel scaled to [0,1].
    Returns a (H, W, 3) u8 normal map (x,y,z scaled to 0..1 -> 0..255).
    """
    img = np.asarray(height_u8, np.float32)[..., 0] / 255.0
    # duplicate edge pixels (height_map.rs:20-45)
    p = np.pad(img, 1, mode="edge")
    nw, n_, ne = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    w_, e_ = p[1:-1, :-2], p[1:-1, 2:]
    sw, s_, se = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    x_norm = -(se - sw + 2.0 * (e_ - w_) + ne - nw)
    y_norm = -(nw - sw + 2.0 * (n_ - s_) + ne - se)
    z_norm = np.full_like(x_norm, 1.0 / HEIGHT_MAP_STRENGTH)
    v = np.stack([x_norm, y_norm, z_norm], axis=-1)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v01 = v * 0.5 + 0.5
    return (v01 * 255.0).astype(np.uint8)


