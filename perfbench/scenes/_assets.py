"""Stand-ins for the image assets of the benchmark's scenes, as procedural
numpy images made from a seed (frozen from ``solstrale_tpu_torch``'s
``fixtures.bench_textures``). Both sides of a run get the same arrays."""
from __future__ import annotations

import numpy as np


def tex_stand_in(size=1024, seed=5):
    """The (size, size, 3) u8 colour-noise stand-in of the upstream's
    ``tex.jpg``, one draw a texel: ``fixtures.bench_textures(size, seed)
    ["tex"]``, whose generator first draws the four other stand-ins'
    noise (skipped here, the stream advanced alike)."""
    rng = np.random.default_rng(seed)
    rng.standard_normal((size, size, 3))
    rng.uniform(0, 2 * np.pi, 3)
    rng.standard_normal((size, size))
    return (np.clip(rng.random((size, size, 3)), 0, 1) * 255).astype(np.uint8)
