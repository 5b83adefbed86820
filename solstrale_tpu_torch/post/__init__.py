"""Post-processing framework, mirroring the reference's ``src/post/mod.rs``.

Processors operate on *unnormalized accumulated* color sums (the renderer's
progressive buffers) plus the sample count. The last processor in the chain
produces the u8 image; the others transform the float accumulation. Bloom
and the denoiser are not ported yet (ROADMAP queue A: bloom and
denoiser).
"""
from __future__ import annotations

import numpy as np

from ..utils import to_rgb_u8


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
