"""Post-processing framework, mirroring the reference's ``src/post/mod.rs``.

Processors operate on *unnormalized accumulated* color sums (the renderer's
progressive buffers) plus the sample count. The last processor in the chain
produces the u8 image; the others transform the float accumulation. The
albedo / normal aux planes are filled iff a processor asks for them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import to_rgb_u8


def exact_conv():
    """The context bloom's and the denoiser's convolutions run in: cuDNN in
    f32 (not TF32, its default, which is ~1e-3 off the JAX package's f32
    result), with deterministic algorithms, so a resumed render repeats the
    straight one bit for bit."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class PostProcessor:
    def needs_albedo_and_normal_colors(self) -> bool:
        return False

    def intermediate_post_process(self, pixel_sums, albedo_sums, normal_sums,
                                  width, height, num_samples):
        """(H, W, 3) accumulated sums -> transformed sums."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot be used as an intermediate post "
            "processor")

    def post_process(self, pixel_sums, albedo_sums, normal_sums, width,
                     height, num_samples):
        """(H, W, 3) accumulated sums -> u8 image (numpy, H x W x 3)."""
        sums = self.intermediate_post_process(
            pixel_sums, albedo_sums, normal_sums, width, height, num_samples)
        return to_rgb_u8(sums, num_samples).cpu().numpy()


class NopPostProcessor(PostProcessor):
    """Identity: tone-map the accumulation to an image (post/nop.rs:18-46)."""

    def intermediate_post_process(self, pixel_sums, albedo_sums, normal_sums,
                                  width, height, num_samples):
        return pixel_sums

    def post_process(self, pixel_sums, albedo_sums, normal_sums, width,
                     height, num_samples):
        return np.asarray(to_rgb_u8(pixel_sums, num_samples).cpu())


from .bloom import BloomPostProcessor  # noqa: E402,F401
from .denoise import DenoiserPostProcessor, OidnPostProcessor  # noqa: E402,F401
