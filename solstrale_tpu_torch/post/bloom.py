"""Bloom post processor (the reference's ``post/bloom.rs``).

The bright pass is elementwise; the blur is separable, horizontal then
vertical, each axis one depthwise ``F.conv2d`` over the image padded by
repeating its border pixels (bloom.rs:157-162 clamps to the edge). The
convolutions run in f32: cuDNN's TF32 default would put the result ~1e-3
off the JAX package's f32 blur.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import create_gaussian_blur_weights
from . import PostProcessor, exact_conv


class BloomPostProcessor(PostProcessor):
    def __init__(self, kernel_size_fraction, threshold=None,
                 max_intensity=None):
        if not (0.0 <= kernel_size_fraction <= 0.5):
            raise ValueError("kernel_size_fraction must be between 0 and 0.5")
        self.kernel_size_fraction = float(kernel_size_fraction)
        # default threshold = |(1,1,1)| (bloom.rs:38)
        self.threshold = (float(np.sqrt(3.0)) if threshold is None
                          else float(threshold))
        self.max_intensity = (float("inf") if max_intensity is None
                              else float(max_intensity))

    def intermediate_post_process(self, pixel_sums, albedo_sums, normal_sums,
                                  width, height, num_samples):
        # thresholds scale by num_samples: buffers are unnormalized sums
        # (bloom.rs:85-86)
        threshold = self.threshold * num_samples
        max_intensity = self.max_intensity * num_samples
        kernel_size = int(self.kernel_size_fraction * width) * 2 + 1
        weights = torch.tensor(
            create_gaussian_blur_weights(kernel_size, kernel_size / 5.0),
            dtype=torch.float32, device=pixel_sums.device)
        return _bloom(pixel_sums.to(torch.float32), weights, threshold,
                     max_intensity)


def _bloom(img, weights, threshold, max_intensity):
    """(H, W, 3) sums plus the blurred bright pass: pixels whose color norm
    reaches ``threshold``, capped to norm ``max_intensity``
    (bloom.rs:92-105), blurred by the odd-length ``weights`` along the width
    and then the height."""
    norm = torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    capped = torch.where(norm > max_intensity,
                         img / torch.clamp(norm, min=1e-30) * max_intensity,
                         img)
    bright = torch.where(norm >= threshold, capped, 0.0)

    k = weights.shape[0]
    half = k // 2
    x = bright.permute(2, 0, 1)[None]               # (1, 3, H, W)
    with exact_conv():
        x = F.conv2d(F.pad(x, (half, half, 0, 0), mode="replicate"),
                     weights.view(1, 1, 1, k).expand(3, 1, 1, k), groups=3)
        x = F.conv2d(F.pad(x, (0, 0, half, half), mode="replicate"),
                     weights.view(1, 1, k, 1).expand(3, 1, k, 1), groups=3)
    return img + x[0].permute(1, 2, 0)
