"""Checkpoint / resume of the progressive render state.

The accumulation planes, the sample cursor and the seed round-trip through
one ``.npz`` file with the JAX package's keys and dtypes (f32 planes, int64
scalars), so either package resumes the other's checkpoint. The
counter-based RNG makes a resumed render draw the same remaining samples.
"""
from __future__ import annotations

import numpy as np
import torch


def save_checkpoint(path, pixel_sums, albedo_sums, normal_sums,
                    samples_done, seed):
    """Write the three (H, W, 3) f32 planes (tensors on any device or
    arrays), ``samples_done`` and ``seed`` to ``path``."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    np.savez_compressed(
        path,
        pixel_sums=host(pixel_sums),
        albedo_sums=host(albedo_sums),
        normal_sums=host(normal_sums),
        samples_done=np.int64(samples_done),
        seed=np.int64(seed),
    )


def load_checkpoint(path):
    """The checkpoint at ``path`` as numpy planes and int counters."""
    with np.load(path) as z:
        return dict(
            pixel_sums=z["pixel_sums"],
            albedo_sums=z["albedo_sums"],
            normal_sums=z["normal_sums"],
            samples_done=int(z["samples_done"]),
            seed=int(z["seed"]),
        )
