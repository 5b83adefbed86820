"""Denoiser post processor with the OIDN interface semantics (the
reference's ``post/oidn.rs``): final-only (oidn.rs:66-78), takes the albedo
and normal aux channels, works on tone-mapped floats (oidn.rs:131-138) and
outputs u8. It runs on the device of the sums it is given.
"""
from __future__ import annotations

import os

import torch

from ..models.denoiser import (denoise_bilateral, load_weights,
                               params_from_flax)
from ..utils import to_float
from . import PostProcessor, exact_conv

BUNDLED_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models", "denoiser_weights.pkl")


class DenoiserPostProcessor(PostProcessor):
    """The CNN denoiser with the bundled weights (or ``weights_path``'s);
    the cross-bilateral filter when ``use_cnn`` is False and no weights are
    named, or the named file does not exist (the JAX package's choice)."""

    def __init__(self, weights_path=None, use_cnn=True):
        if weights_path is None and use_cnn and \
                os.path.exists(BUNDLED_WEIGHTS):
            weights_path = BUNDLED_WEIGHTS
        self.weights_path = weights_path
        self._model = None
        if weights_path and os.path.exists(weights_path):
            self._model = params_from_flax(load_weights(weights_path)).eval()

    def needs_albedo_and_normal_colors(self):
        return True

    def intermediate_post_process(self, *args, **kwargs):
        # oidn.rs:66-78: cannot be an intermediate processor
        raise ValueError("DenoiserPostProcessor can not be used as an "
                         "intermediate post processor")

    def denoise(self, color, albedo, normal):
        """Tone-mapped (H, W, 3) color, albedo and normal -> denoised color,
        on their device."""
        if self._model is None:
            return denoise_bilateral(color, albedo, normal)
        model = self._model.to(color.device)
        with torch.no_grad(), exact_conv():
            return model(color, albedo, normal)

    def post_process(self, pixel_sums, albedo_sums, normal_sums, width,
                     height, num_samples):
        color = to_float(pixel_sums.to(torch.float32), num_samples)
        albedo = to_float(albedo_sums.to(torch.float32), num_samples)
        normal = normal_sums.to(torch.float32) / num_samples
        out = torch.clamp(self.denoise(color, albedo, normal), 0.0, 0.999)
        return torch.clamp(torch.floor(256.0 * out), 0, 255).to(
            torch.uint8).cpu().numpy()


class OidnPostProcessor(DenoiserPostProcessor):
    """Name-parity alias for users porting from the reference
    (post/oidn.rs:19-83); runs the learned / bilateral denoiser instead of
    the Intel OIDN C++ library."""
