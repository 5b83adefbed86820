"""Train the DenoiserCNN on this renderer's own output: noisy low-spp
renders (with the albedo and normal aux planes) against high-spp targets.

Port of the JAX package's ``models/train_denoiser.py``: the same pairs at
2, 4 and 8 spp, the same two flip augmentations, L1 loss, the same pair
order (``numpy.random.default_rng(0)``), Adam with optax's defaults under
optax's cosine decay from 1e-3, written in closed form. The weights are
saved in the flax layout (``params_to_flax``), which both packages load.

Usage: python -m solstrale_tpu_torch.models.train_denoiser [steps] [out.pkl]
"""
from __future__ import annotations

import math
import pickle
import sys

import numpy as np
import torch

from .denoiser import DenoiserCNN

# optax.adam's defaults, and the JAX trainer's peak learning rate
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)
LR = 1e-3


def _training_scenes(size=128):
    """Training scenes from the asset-free fixtures, in the JAX list's
    roles: the kitchen sink (normal-mapped ground), the README scene with a
    medium, the solid kitchen sink (media, every material), a triangle mesh
    (the OBJ scene's role) and an image-textured scene. The held-out
    evaluation scenes (tests/test_denoiser_heldout.py: blend, uv,
    normal-mapped sphere) never appear here; neither does a Blend
    material."""
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures

    def cfg(spp):
        return T.RenderConfig(width=size, height=size, samples_per_pixel=spp,
                              seed=3)

    return [
        lambda spp: fixtures.kitchen_sink_scene(cfg(spp)),
        lambda spp: fixtures.small_scene(cfg(spp)),
        lambda spp: fixtures.kitchen_sink_solid_scene(cfg(spp)),
        lambda spp: fixtures.sponza_class_scene(cfg(spp), n_cells=24),
        lambda spp: fixtures.kitchen_sink_scene(cfg(spp), normal_map=False),
    ]


def _render_pair(make_scene, noisy_spp=4, clean_spp=128, size=128,
                 device="cuda"):
    """(noisy, albedo, normal, clean) (size, size, 3) planes on ``device``:
    a noisy batch with aux from sample 1 and a clean one from sample 1000,
    both seed 3."""
    from ..renderer import integrator
    from ..scene.compile import compile_scene
    from ..utils import to_float

    cs = compile_scene(make_scene(noisy_spp), device=device)
    kw = dict(width=size, height=size, max_depth=50,
              shader_kind=integrator.SHADER_PATH)
    noisy, albedo, normal, _ = integrator.render_sample_batch(
        cs, 1, 3, need_aux=True, n_samples=noisy_spp, **kw)
    clean, _, _, _ = integrator.render_sample_batch(
        cs, 1000, 3, need_aux=False, n_samples=clean_spp, **kw)
    return (to_float(noisy, noisy_spp), to_float(albedo, noisy_spp),
            normal / noisy_spp, to_float(clean, clean_spp))


def cosine_decay(init_value, decay_steps):
    """optax.cosine_decay_schedule(init_value, decay_steps) (alpha 0) in
    closed form: the learning rate at update ``count``."""
    def lr(count):
        t = min(count, decay_steps) / decay_steps
        return init_value * 0.5 * (1.0 + math.cos(math.pi * t))

    return lr


def make_optimizer(model, steps):
    """Adam with optax's defaults under ``cosine_decay(LR, steps)`` as a
    ``LambdaLR`` (its factor at each step computed afresh, not recursively
    as ``CosineAnnealingLR`` does, which drifts). Returns (optimizer,
    scheduler); call ``scheduler.step()`` after each ``optimizer.step()``."""
    opt = torch.optim.Adam(model.parameters(), lr=LR, **ADAM)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt,
                                                  cosine_decay(1.0, steps))


def init_like_flax(model, seed=0):
    """flax's default Conv init from a seeded torch generator: kernels
    lecun_normal (a normal truncated at 2 sigma, scaled to variance
    1/fan_in), biases zero. Returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in model.children():
            w = conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            # 0.8796...: the std of a unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                        generator=g)
            conv.bias.zero_()
    return model


def train_step(model, opt, sched, noisy, albedo, normal, clean):
    """One Adam step on the L1 loss of one (H, W, 3) pair, the convolutions
    in f32 (``post.exact_conv``). Returns the loss (a 0-dim tensor)."""
    from ..post import exact_conv

    with exact_conv():
        loss = torch.mean(torch.abs(model(noisy, albedo, normal) - clean))
        opt.zero_grad(set_to_none=True)
        loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def params_to_flax(model):
    """The model's weights as the flax ``DenoiserCNN`` parameter tree
    (``{"params": {"Conv_k": {"kernel": (3, 3, I, O), "bias": (O,)}}}``,
    numpy f32): the inverse of ``denoiser.params_from_flax``, and what the
    JAX package's ``OidnPostProcessor`` unpickles."""
    tree = {}
    for name, conv in model.named_children():
        tree[name] = {
            "kernel": np.ascontiguousarray(
                conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)),
            "bias": conv.bias.detach().cpu().numpy().copy()}
    return {"params": tree}


def train(steps=600, out_path="solstrale_tpu_torch/models/denoiser_weights.pkl",
          size=128, noisy_spp=4, clean_spp=128, scenes=None, device="cuda"):
    """Render the training pairs, train ``steps`` Adam steps from flax's
    init, save the weights (flax layout) to ``out_path`` (None: no file)
    and return the model. ``scenes``: callables spp -> Scene (default
    ``_training_scenes(size)``); ``noisy_spp`` is unused, as in the JAX
    trainer, which renders every scene at 2, 4 and 8 spp."""
    print("rendering training pairs...")
    scenes = _training_scenes(size) if scenes is None else scenes
    # noise-level variety (2/4/8 spp) and flips: the net must denoise, not
    # memorize its fixtures
    pairs = [_render_pair(m, spp, clean_spp, size, device)
             for m in scenes for spp in (2, 4, 8)]
    pairs += [tuple(torch.flip(a, dims=(1,)) for a in p) for p in pairs]
    pairs += [tuple(torch.flip(a, dims=(0,)) for a in p)
              for p in pairs[:len(pairs) // 2]]
    print(f"{len(pairs)} training pairs")

    model = init_like_flax(DenoiserCNN()).to(device)
    opt, sched = make_optimizer(model, steps)
    order = np.random.default_rng(0).permutation(len(pairs))
    for i in range(steps):
        loss = train_step(model, opt, sched, *pairs[order[i % len(pairs)]])
        if i % 25 == 0:
            print(f"step {i}: L1 {float(loss):.5f}")

    if out_path is not None:
        with open(out_path, "wb") as f:
            pickle.dump(params_to_flax(model), f)
        print("saved", out_path)
    return model


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    out = sys.argv[2] if len(sys.argv) > 2 else \
        "solstrale_tpu_torch/models/denoiser_weights.pkl"
    train(steps, out)
