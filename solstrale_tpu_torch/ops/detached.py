"""Detached geometry for the hit kernels: a zero backward.

Port of the JAX package's ``ops/detached.py``. A kernel launched through
ctypes builds no autograd graph, while its plain PyTorch version on CPU
tensors would differentiate ``t`` with respect to the rays and the
geometry. ``detached_call`` runs either with grad off, recorded as one
``torch.autograd.Function`` whose backward returns no gradient for any
input, so both devices give the same gradients.

That zero is exact for what the renderer differentiates: the estimator is
detached-sampling (``integrator.scatter`` detaches the sampled direction
and the pdf weight), so texture arena values, emitter radiance and the
background never reach the hit's inputs. What is dropped, by design, is the
geometry derivative (dt/dvertices): the detached-geometry choice.
"""
from __future__ import annotations

import functools

import torch


def _tensors(args):
    """The tensors among ``args``, one level into tuples and lists (rays
    are component tuples)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


class _Detached(torch.autograd.Function):
    """``fn(*args, **kwargs)`` with no gradient to any input. The tensors
    of ``args`` come again as direct inputs so that autograd records the
    call; the forward runs with grad off, as every Function's does."""

    @staticmethod
    def forward(ctx, fn, args, kwargs, *tensors):
        out = fn(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.mark_non_differentiable(
            *(x for x in outs if not x.is_floating_point()))
        ctx.n_inputs = 3 + len(tensors)
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * ctx.n_inputs


def detached_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a zero backward, whatever requires
    grad: ``fn`` always runs with grad off, so neither the rays nor the
    geometry held in the scene's tables get a graph through it. Where a ray
    tensor requires grad, the call is recorded as ``_Detached`` (its
    outputs require grad and give that tensor no gradient, as JAX's
    ``custom_vjp`` does); otherwise ``fn`` runs under ``torch.no_grad()``
    with no autograd record on the render loop."""
    tensors = _tensors(args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Detached.apply(fn, args, kwargs, *tensors)
    with torch.no_grad():
        return fn(*args, **kwargs)


def detached(fn):
    """Decorator: every call of ``fn`` goes through ``detached_call``."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        return detached_call(fn, *args, **kwargs)

    return run
