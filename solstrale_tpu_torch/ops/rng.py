"""Counter-based stateless RNG (PCG4D), bit-exact with the JAX package's
``ops/rng.py``.

Every random draw is a pure function of ``(pixel_id, sample, bounce,
purpose, seed)``: renders are bit-reproducible for a fixed seed and
independent of batch shape, and there is no hidden generator state.

torch has partial uint32 coverage, so the uint32 lanes are int64 tensors
masked to 32 bits after every multiply and add. An int64 product wraps mod
2^64, which keeps its low 32 bits exact; right shifts run only on masked
(non-negative) values, so they are logical.

Hash: PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020).

The draws (``uniform4``, ``uniform``) have a hand-written CUDA kernel
(``csrc/rng.cu``, one launch a draw, in place of the JAX package's fused
PCG4D chains) and a plain PyTorch version (``uniform4_plain``: the int64
chain above, the CPU path and the kernel's oracle). The wrapper picks by
the counters' device only: CPU tensors and Python ints take the plain
version, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import math

import torch

from . import _build

# Purpose tags: draw-site identifiers (same values as the JAX package).
P_JITTER = 0
P_LENS = 1
P_MIX_COIN = 2
P_LIGHT_PICK = 3
P_LIGHT_SAMPLE = 4
P_COSINE = 5
P_DIELECTRIC = 6
P_FUZZ = 7
P_MEDIUM = 8
P_BLEND_SCATTER = 9
P_BLEND_NORMAL = 10
P_PHASE = 11
P_MEDIUM_BASE = 16   # + m: medium m's free-flight draw (the scene hit)

_M32 = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223


def _u32(x, like):
    """Int tensor or Python int -> int64 tensor holding its low 32 bits
    (two's complement wrap, like ``astype(uint32)``). A Python int becomes
    a fill of ``like``'s shape and device: no host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.full_like(like, int(x) & _M32, dtype=torch.int64)


def pcg4d(a, b, c, d):
    """PCG4D mixing on four 32-bit lanes held in int64 tensors."""
    a = (a * _MUL + _INC) & _M32
    b = (b * _MUL + _INC) & _M32
    c = (c * _MUL + _INC) & _M32
    d = (d * _MUL + _INC) & _M32
    a = (a + b * d) & _M32
    b = (b + c * a) & _M32
    c = (c + a * b) & _M32
    d = (d + b * c) & _M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + b * d) & _M32
    b = (b + c * a) & _M32
    c = (c + a * b) & _M32
    d = (d + b * c) & _M32
    return a, b, c, d


def to_unit_float(u):
    """32-bit word -> float32 in [0, 1) from the top 24 bits."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def words4(pixel_id, sample, bounce, purpose, seed):
    """The four raw 32-bit PCG4D words per counter tuple (int64 tensors).
    pixel_id / sample / bounce may be tensors (broadcastable) or ints;
    purpose is a Python int; seed is an int or a 0-dim tensor."""
    like = next((x for x in (pixel_id, sample, bounce, seed)
                 if isinstance(x, torch.Tensor)), None)
    if like is None:
        like = torch.zeros((), dtype=torch.int64)
    a = _u32(pixel_id, like)
    b = _u32(sample, like)
    c = ((_u32(bounce, like) << 8) & _M32) | int(purpose)
    d = _u32(seed, like)
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    return pcg4d(a, b, c, d)


def uniform4_plain(pixel_id, sample, bounce, purpose, seed):
    """Four independent uniforms in [0,1) per counter tuple: the plain
    PyTorch chain (``words4``, ``to_unit_float``)."""
    return tuple(to_unit_float(w) for w in
                 words4(pixel_id, sample, bounce, purpose, seed))


def kernel_counter(x, shape, dev):
    """One counter as the draw kernel reads it: (tensor, stride, value).
    A one-element tensor on ``dev`` is read there by every lane (stride 0:
    no host read); a tensor of the broadcast ``shape`` one value a lane
    (stride 1; any other broadcastable form is first made a contiguous
    tensor of that shape); a Python int is passed by value (no tensor).
    The lane's word is the value's low 32 bits, as ``_u32`` takes it."""
    if isinstance(x, torch.Tensor) and x.dtype not in (torch.int32,
                                                       torch.int64):
        raise TypeError(f"uniform4: counters must be ints or int32 / int64 "
                        f"tensors, not {x.dtype}")
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x) & _M32
    if x.device != dev:
        raise ValueError(f"uniform4: counters on {x.device} and {dev}")
    if x.numel() == 1:
        return x, 0, 0
    if x.shape != shape or not x.is_contiguous():
        x = x.expand(shape).contiguous()
    return x, 1, 0


def uniform4(pixel_id, sample, bounce, purpose, seed):
    """Four independent uniforms in [0,1) per counter tuple. pixel_id /
    sample / bounce may be tensors (broadcastable) or ints; purpose is a
    Python int; seed is an int or a 0-dim tensor. With a CUDA tensor among
    the counters, one launch of the draw kernel (``csrc/rng.cu``; counters
    as ``kernel_counter`` gives them) writes a (4, ...) f32 tensor whose
    rows are returned; else the plain chain."""
    args = (pixel_id, sample, bounce, seed)
    tensors = [x for x in args if isinstance(x, torch.Tensor)]
    dev = next((x.device for x in tensors if x.device.type != "cpu"), None)
    if dev is None:
        return uniform4_plain(pixel_id, sample, bounce, purpose, seed)
    if dev.type != "cuda":
        raise ValueError(f"uniform4: unsupported device {dev}")
    shape = torch.broadcast_shapes(*(x.shape for x in tensors))
    counters = [kernel_counter(x, shape, dev) for x in args]
    c_args = []
    for t, stride, value in counters:
        c_args.append([None, 0, 0, value] if t is None else
                      [_build.ptr(t), t.element_size(), stride, 0])
    out = torch.empty((4, *shape), dtype=torch.float32, device=dev)
    err = _build.library().rng_uniform4_launch(
        *c_args[0], *c_args[1], *c_args[2], int(purpose) & _M32,
        *c_args[3], out[0].numel(), _build.ptr(out), _build.stream_of(out))
    _build.check(err, "rng_uniform4")
    uniform4.launches += 1
    return tuple(out.unbind(0))


uniform4.launches = 0


def uniform(pixel_id, sample, bounce, purpose, seed):
    """Single uniform in [0,1): the first of ``uniform4``'s (on the card,
    the first row of the same launch)."""
    return uniform4(pixel_id, sample, bounce, purpose, seed)[0]


# --- distribution samplers (component tuples of (R,) tensors) -------------

def cosine_direction3(r1, r2):
    """Cosine-weighted hemisphere direction, local (t, b, n) frame
    (vec3.rs:417-428)."""
    z = torch.sqrt(1.0 - r2)
    phi = 2.0 * math.pi * r1
    sq_r2 = torch.sqrt(r2)
    return (torch.cos(phi) * sq_r2, torch.sin(phi) * sq_r2, z)


def unit_vector3(r1, r2):
    """Uniform direction on the unit sphere (CDF inversion in place of the
    reference's rejection loop, vec3.rs:395-397)."""
    z = 1.0 - 2.0 * r1
    phi = 2.0 * math.pi * r2
    zz = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return (torch.cos(phi) * zz, torch.sin(phi) * zz, z)


def in_unit_sphere3(r1, r2, r3):
    """Uniform point in the unit ball; cbrt written as exp(log/3) like the
    JAX package (vec3.rs:380-392)."""
    d = unit_vector3(r1, r2)
    radius = torch.exp(torch.log(torch.clamp(r3, min=1e-12)) / 3.0)
    return (d[0] * radius, d[1] * radius, d[2] * radius)


def in_unit_disc3(r1, r2):
    """Uniform point in the unit disc, z = 0 (vec3.rs:400-412)."""
    r = torch.sqrt(r1)
    phi = 2.0 * math.pi * r2
    return (r * torch.cos(phi), r * torch.sin(phi), torch.zeros_like(r))


def to_sphere3(radius, distance_squared, r1, r2):
    """Cone sample towards a sphere light (sphere.rs:142-153)."""
    z = 1.0 + r2 * (torch.sqrt(torch.clamp(
        1.0 - radius * radius / distance_squared, min=0.0)) - 1.0)
    phi = 2.0 * math.pi * r1
    zz = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return (torch.cos(phi) * zz, torch.sin(phi) * zz, z)
