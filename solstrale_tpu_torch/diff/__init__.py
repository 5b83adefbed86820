"""Differentiable rendering: gradients of the image with respect to scene
parameters.

Port of the JAX package's ``diff``. The fixed-trip ``integrator.trace``
(``early_exit=False``) carries autograd through every bounce; under grad it
runs its bounces in chunks under ``torch.utils.checkpoint``, so the backward
is a path replay that keeps only the lane carry between chunks. The
estimator is detached-sampling (``integrator.scatter`` detaches sample
directions and pdf weights) with detached geometry (``ops/detached.py``):
gradients flow through material albedos, texture maps, emitter radiance and
the background.

Because the RNG is counter-based, finite differences with a fixed seed
probe the same path set, so the gradient agrees with them to first order
for parameters that change no sampling decision.
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel import all_reduce, tile_ids
from ..renderer import integrator
from ..scene.compile import CompiledScene


def set_texture_params(cs: CompiledScene, params) -> CompiledScene:
    """The compiled scene with its texture arena pixels (the differentiable
    parameter bank) swapped for ``params``. The copy shares the scene's
    geometry, and with it the packed media tables."""
    out = dataclasses.replace(
        cs, textures=dataclasses.replace(cs.textures, pixels=params))
    integrator.share_geometry_tables(cs, out)
    return out


def render_linear(cs: CompiledScene, *, width, height, max_depth, n_samples,
                  seed, sample_start=1):
    """Differentiable expected-radiance image: the mean of ``n_samples``
    sample passes (``render_pixels`` with the fixed trip), linear color,
    shape (height*width, 3) in pixel-id order."""
    pix = torch.arange(width * height, dtype=torch.int64, device=cs.device)
    total = 0.0
    for s in range(n_samples):
        color, _, _ = integrator.render_pixels(
            cs, pix, sample_start + s, seed, width=width, height=height,
            max_depth=max_depth, shader_kind=integrator.SHADER_PATH,
            need_aux=False, early_exit=False)
        total = total + color
    return total / n_samples


def image_and_texture_grad(cs: CompiledScene, target, *, width, height,
                           max_depth, n_samples, seed):
    """L2 loss against a target image ((height*width, 3) in pixel-id order,
    or any shape of that size) and its gradient with respect to the texture
    arena: the core inverse-rendering step. Returns (loss, grad), both
    detached."""
    params = cs.textures.pixels.detach().requires_grad_(True)
    with torch.enable_grad():
        img = render_linear(set_texture_params(cs, params), width=width,
                            height=height, max_depth=max_depth,
                            n_samples=n_samples, seed=seed)
        loss = torch.mean((img - target.reshape(-1, 3)) ** 2)
        grad, = torch.autograd.grad(loss, params)
    return loss.detach(), grad


def train_step_sharded(cs: CompiledScene, target, mesh, *, width, height,
                       max_depth, lr, seed):
    """One sharded inverse-rendering SGD step (``parallel``'s mesh; every
    rank calls it): each rank renders its pixel tile (``tile``) at sample
    ``1 + its sample rank`` (``sample``), takes its partial L2 loss and
    arena gradient, and both are all-reduced over the whole mesh; every
    rank then applies the same update. ``target`` is (height*width, 3) in
    pixel-id order (or any shape of that size) on the rank's device.
    Returns (loss, the scene with the new arena) on every rank.

    JAX's XLA overlaps the psum with the backward replay; here the
    all-reduce follows the backward."""
    n_pix = width * height
    ids, _ = tile_ids(n_pix, mesh)
    valid = (ids < n_pix).to(torch.float32)[:, None]
    pix = torch.clamp(ids, max=n_pix - 1)
    tgt = target.reshape(-1, 3)[pix]
    params = cs.textures.pixels.detach().requires_grad_(True)
    with torch.enable_grad():
        color, _, _ = integrator.render_pixels(
            set_texture_params(cs, params), pix,
            1 + mesh.get_local_rank("sample"), seed, width=width,
            height=height, max_depth=max_depth,
            shader_kind=integrator.SHADER_PATH, need_aux=False,
            early_exit=False)
        err = torch.sum((color - tgt) ** 2 * valid)
        grad, = torch.autograd.grad(err, params)
    loss = all_reduce(err.detach().reshape(1), mesh)[0]
    grad = all_reduce(grad, mesh)
    denom = n_pix * 3 * mesh.size(1)
    new_params = params.detach() - lr * grad / denom
    return loss / denom, set_texture_params(cs, new_params)
