"""Differentiable rendering: gradients of the image with respect to scene
parameters.

Port of the JAX package's ``diff``. The fixed-trip ``integrator.trace``
(``early_exit=False``) on its differentiable route carries autograd through
every bounce: the hit kernels, then S1 with its hand-written backward S1B
(``ops.step.step_shade_grad``; their plain versions on the CPU). Under grad
it runs its bounces in chunks under ``torch.utils.checkpoint``, so the
backward is a path replay that keeps only the lane carry between chunks
and reruns S1 for each chunk's records. The estimator is detached-sampling
(sample directions and pdf weights are constants) with detached geometry
(``ops/detached.py``): gradients flow through material albedos, texture
maps and emitter radiance (the texture arena) and the background.

The inverse step (``image_and_texture_grad``, and each rank's loss and
gradient in ``train_step_sharded``) is one ``_GradStep`` per scene geometry
and key. On the card its forward, its chunked replay and the gradient are
one CUDA graph, captured at the first call and replayed on every later one,
as the JAX package's ``jax.jit`` makes them one XLA program; on the CPU the
same code runs eagerly.

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
    geometry, and with it the packed media tables and the captured inverse
    steps."""
    out = dataclasses.replace(
        cs, textures=dataclasses.replace(cs.textures, pixels=params))
    integrator.share_geometry_tables(cs, out)
    return out


def render_linear(cs: CompiledScene, *, width, height, max_depth, n_samples,
                  seed, sample_start=1):
    """Differentiable expected-radiance image: the mean of ``n_samples``
    sample passes (``render_pixels`` with the fixed trip on the
    differentiable route), linear color, shape (height*width, 3) in
    pixel-id order."""
    pix = torch.arange(width * height, dtype=torch.int64, device=cs.device)
    total = 0.0
    for s in range(n_samples):
        color, _, _ = integrator.render_pixels(
            cs, pix, sample_start + s, seed, width=width, height=height,
            max_depth=max_depth, shader_kind=integrator.SHADER_PATH,
            need_aux=False, early_exit=False, differentiable=True)
        total = total + color
    return total / n_samples


def _geometry(cs: CompiledScene):
    """The data pointers of every table of ``cs`` but the texture arena:
    the tensors a captured step reads by address. A dataclass counts by its
    fields, so the tables cached on first use (``Solids.sph_table``,
    ``pl_table``), which belong to the same object, do not change it."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x.data_ptr())
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif hasattr(x, "__dict__"):
            for v in vars(x).values():
                walk(v)

    walk(dataclasses.replace(cs, textures=dataclasses.replace(
        cs.textures, pixels=None)))
    return tuple(out)


class _GradStep:
    """One inverse step in fixed tensors: the leaf arena the gradient is
    taken against, the target and, for a shard, its pixel ids and valid
    mask, in; the loss and the arena gradient, out. ``run`` is the step
    (the forward, the checkpointed chunks of the fixed trip and
    ``autograd.grad``: the path replay); a call copies the caller's arena
    and inputs in, runs it (on the card, replays its CUDA graph) and
    returns clones of the outputs, which the next call overwrites.

    A full image (``pix`` None) is ``render_linear``'s mean over
    ``n_samples`` and the mean square error; a shard renders its pixel ids
    at sample ``sample`` and sums the squared error of its valid rows.

    The capture, at the first call on the card, is the wavefront's
    (``integrator._WavefrontGraphs``): one step on a side stream first
    (``integrator.warm_up``), then the capture in a private memory pool,
    which keeps the step's peak resident for as long as the step lives,
    with the kernel wrappers' launches counted on every replay
    (``integrator.capture_counted``). A failed capture raises; nothing
    falls back to the eager step on the card. The graph reads the scene's
    tables by address: a call on a scene whose tables are other tensors
    raises."""

    captures = 0

    def __init__(self, cs, target, *, width, height, max_depth, n_samples,
                 seed, pix=None, sample=None):
        px = cs.textures.pixels
        dev = px.device
        self.kw = dict(width=width, height=height, max_depth=max_depth,
                       seed=seed)
        self.n_samples, self.sample = n_samples, sample
        self.arena = torch.zeros(px.shape, dtype=px.dtype, device=dev,
                                 requires_grad=True)
        self.cs = set_texture_params(cs, self.arena)
        self.geometry = _geometry(cs)
        self.target = torch.zeros(target.shape, dtype=target.dtype,
                                  device=dev)
        self.pix = self.valid = None
        if pix is not None:
            self.pix = torch.zeros_like(pix)
            self.valid = torch.zeros((pix.shape[0], 1), dtype=torch.float32,
                                     device=dev)
        color = torch.promote_types(torch.float32, px.dtype)
        self.loss = torch.zeros((), dtype=torch.promote_types(
            color, target.dtype), device=dev)
        self.grad = torch.zeros_like(px)
        self.graph = self.counts = None

    def run(self):
        """The step on the fixed tensors, its loss and gradient written
        into ``loss`` and ``grad``. Reads nothing back to the host."""
        with torch.enable_grad():
            if self.pix is None:
                img = render_linear(self.cs, n_samples=self.n_samples,
                                    **self.kw)
                loss = torch.mean((img - self.target.reshape(-1, 3)) ** 2)
            else:
                color, _, _ = integrator.render_pixels(
                    self.cs, self.pix, self.sample,
                    shader_kind=integrator.SHADER_PATH, need_aux=False,
                    early_exit=False, differentiable=True, **self.kw)
                loss = torch.sum((color - self.target) ** 2 * self.valid)
            grad, = torch.autograd.grad(loss, self.arena)
        with torch.no_grad():
            self.loss.copy_(loss)
            self.grad.copy_(grad)

    def load(self, cs, target, pix=None, valid=None):
        """Copy ``cs``'s arena and the inputs into the fixed tensors."""
        if _geometry(cs) != self.geometry:
            raise ValueError("inverse step: the scene's tables are not the "
                             "tensors the step was built on")
        with torch.no_grad():
            self.arena.copy_(cs.textures.pixels)
            self.target.copy_(target)
            if self.pix is not None:
                self.pix.copy_(pix)
                self.valid.copy_(valid)

    def __call__(self, cs, target, pix=None, valid=None):
        """(loss, arena gradient) of ``cs``'s arena: one replay on the card,
        ``run`` elsewhere."""
        self.load(cs, target, pix, valid)
        if self.arena.device.type == "cuda":
            if self.graph is None:
                integrator.warm_up(self.arena.device, self.run)
                self.graph, self.counts = integrator.capture_counted(
                    self.run)
                _GradStep.captures += 1
            integrator.replay_counted(self.graph, self.counts)
        else:
            self.run()
        return self.loss.clone(), self.grad.clone()

    def eager(self, cs, target, pix=None, valid=None):
        """The same step with ``run`` dispatched op by op on any device: the
        card's plain version of a replay."""
        self.load(cs, target, pix, valid)
        self.run()
        return self.loss.clone(), self.grad.clone()


def grad_step(cs: CompiledScene, target, *, width, height, max_depth,
              n_samples, seed, pix=None, sample=None):
    """The ``_GradStep`` of ``cs``'s geometry and this key, made at its first
    use and carried by ``set_texture_params`` to every copy of the scene:
    the key is (width, height, max_depth, n_samples, the seed as an int, the
    arena's and the target's shape and dtype, and for a shard its shape and
    sample)."""
    seed = int(seed)
    px = cs.textures.pixels
    key = (integrator.GRAD_STEP, width, height, max_depth, n_samples, seed,
           tuple(px.shape), px.dtype, tuple(target.shape), target.dtype,
           None if pix is None else tuple(pix.shape), sample)
    return integrator.per_scene(cs, key, lambda: _GradStep(
        cs, target, width=width, height=height, max_depth=max_depth,
        n_samples=n_samples, seed=seed, pix=pix, sample=sample))


def image_and_texture_grad(cs: CompiledScene, target, *, width, height,
                           max_depth, n_samples, seed):
    """L2 loss against a target image ((height*width, 3) in pixel-id order,
    or any shape of that size) and its gradient with respect to the texture
    arena: the core inverse-rendering step. Returns (loss, grad), both
    detached. On the card, a replay of the step's CUDA graph (``grad_step``;
    the first call of a geometry and key captures it)."""
    step = grad_step(cs, target, width=width, height=height,
                     max_depth=max_depth, n_samples=n_samples, seed=seed)
    return step(cs, target)


def shard_loss_and_grad(cs: CompiledScene, target, mesh, *, width, height,
                        max_depth, seed):
    """This rank's part of ``train_step_sharded``, no collective: the
    summed squared error of its pixel tile (``tile``; the padding's rows
    weigh 0) at sample ``1 + its sample rank`` (``sample``) and its arena
    gradient, from ``grad_step`` (a graph replay on the card). ``target``
    is (height*width, 3) in pixel-id order (or any shape of that size).
    Returns (error sum, gradient), both detached."""
    n_pix = width * height
    ids, _ = tile_ids(n_pix, mesh)
    valid = (ids < n_pix).to(torch.float32)[:, None]
    pix = torch.clamp(ids, max=n_pix - 1)
    tgt = target.reshape(-1, 3)[pix]
    step = grad_step(cs, tgt, width=width, height=height,
                     max_depth=max_depth, n_samples=1, seed=seed, pix=pix,
                     sample=1 + mesh.get_local_rank("sample"))
    return step(cs, tgt, pix, valid)


def train_step_sharded(cs: CompiledScene, target, mesh, *, width, height,
                       max_depth, lr, seed):
    """One sharded inverse-rendering SGD step (``parallel``'s mesh; every
    rank calls it): each rank takes its tile's partial L2 loss and arena
    gradient (``shard_loss_and_grad``), both are all-reduced over the whole
    mesh, and every rank then applies the same update. ``target`` is
    (height*width, 3) in pixel-id order (or any shape of that size) on the
    rank's device. Returns (loss, the scene with the new arena) on every
    rank.

    The all-reduces follow the replay. The arena's cannot overlap it: S1B
    adds every chunk's gradient into one buffer of the backward pass
    (``ops.step.GradSums``), which is complete only after the last chunk.
    Only the scalar loss's reduce could run beside the backward."""
    err, grad = shard_loss_and_grad(cs, target, mesh, width=width,
                                    height=height, max_depth=max_depth,
                                    seed=seed)
    loss = all_reduce(err.reshape(1), mesh)[0]
    grad = all_reduce(grad, mesh)
    denom = width * height * 3 * mesh.size(1)
    new_params = cs.textures.pixels.detach() - lr * grad / denom
    return loss / denom, set_texture_params(cs, new_params)
