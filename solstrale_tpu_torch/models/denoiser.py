"""Denoisers with OIDN's interface, (color, albedo, normal) -> color, on
(H, W, 3) tensors in tone-mapped space:

- ``denoise_bilateral``: a cross-bilateral filter guided by the albedo and
  normal aux channels; no weights.
- ``DenoiserCNN``: the JAX package's small U-Net with its flax layout
  (``Conv_0`` .. ``Conv_5``), whose trained weights ``params_from_flax``
  loads; ``load_weights`` reads the bundled pickle without flax.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def denoise_bilateral(color, albedo, normal, radius=3, sigma_spatial=2.0,
                      sigma_color=0.2, sigma_albedo=0.1, sigma_normal=0.3):
    """Cross-bilateral denoiser: weights combine spatial, color, albedo and
    normal similarity over a (2 radius + 1)^2 window. The neighbours are
    shifted with wrap-around borders, as the JAX version's ``jnp.roll``."""
    acc = torch.zeros_like(color)
    wacc = torch.zeros(color.shape[:2] + (1,), dtype=color.dtype,
                       device=color.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            c, a, n = (torch.roll(x, (dy, dx), dims=(0, 1))
                       for x in (color, albedo, normal))
            w_sp = math.exp(-(dy * dy + dx * dx) / (2 * sigma_spatial ** 2))
            dc = torch.sum((c - color) ** 2, -1, keepdim=True)
            da = torch.sum((a - albedo) ** 2, -1, keepdim=True)
            dn = torch.sum((n - normal) ** 2, -1, keepdim=True)
            w = w_sp * torch.exp(-dc / (2 * sigma_color ** 2)
                                 - da / (2 * sigma_albedo ** 2)
                                 - dn / (2 * sigma_normal ** 2))
            acc = acc + c * w
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-8)


class DenoiserCNN(nn.Module):
    """Small U-Net-style denoiser on concat(color, albedo, normal): two 3x3
    convolutions at full size, a 2x2 average pool, two at half size, a
    bilinear resize back, a concat with the full-size features, two more
    convolutions, a residual on the color and a clip to [0, 1]. The layers
    carry the flax module's names."""

    def __init__(self, features=32):
        super().__init__()
        f = features
        for i, (cin, cout) in enumerate(((9, f), (f, f), (f, 2 * f),
                                         (2 * f, 2 * f), (3 * f, f),
                                         (f, 3))):
            # 3x3 'SAME' (stride 1): one pixel of zeros on every side
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, color, albedo, normal):
        x = torch.cat([color, albedo, normal], -1).permute(2, 0, 1)[None]
        h1 = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        h2 = F.avg_pool2d(h1, 2, 2)
        h2 = F.relu(self.Conv_3(F.relu(self.Conv_2(h2))))
        # jax.image.resize 'bilinear': half-pixel centres, the weights
        # renormalised at the borders, which is align_corners=False
        h3 = F.interpolate(h2, size=h1.shape[2:], mode="bilinear",
                           align_corners=False, antialias=False)
        h = F.relu(self.Conv_4(torch.cat([h1, h3], 1)))
        out = self.Conv_5(h)
        return torch.clamp(x[:, :3] + out, 0.0, 1.0)[0].permute(1, 2, 0)


def params_from_flax(params, model=None):
    """Load a flax ``DenoiserCNN`` parameter tree (``{"params": {"Conv_k":
    {"kernel": (3, 3, I, O), "bias": (O,)}}}``, numpy arrays) into
    ``model`` (a new ``DenoiserCNN`` if None): each HWIO kernel becomes
    OIHW. Returns the model."""
    if model is None:
        model = DenoiserCNN()
    tree = params.get("params", params)
    state = {}
    for name, layer in tree.items():
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["kernel"], np.float32)
                                 .transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(
            np.asarray(layer["bias"], np.float32))
    model.load_state_dict(state)
    return model


class _ArraysOnly(pickle.Unpickler):
    """Unpickles dicts of numpy arrays and nothing else: the array
    reconstructor, ``ndarray`` and ``dtype`` are the only globals it
    resolves (the reconstructor under numpy 1's ``numpy.core`` or numpy 2's
    ``numpy._core``)."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("multiarray", "_reconstruct")}

    def find_class(self, module, name):
        key = (module.rsplit(".", 1)[-1], name)
        if key not in self._ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not allowed "
                                         "in a weights file")
        if key[0] == "multiarray":
            core = getattr(np, "_core", None) or np.core
            return getattr(core.multiarray, name)
        return getattr(np, name)


def load_weights(path):
    """The flax parameter tree pickled at ``path`` (numpy arrays only)."""
    with open(path, "rb") as f:
        return _ArraysOnly(f).load()
