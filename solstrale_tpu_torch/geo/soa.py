"""Vector math on tensors: a vector batch is a tuple of three (R,) tensors.

Layout choice: the tuples keep the association order of the JAX package's
``geo/soa.py`` op for op — ``a.x*b.x + a.y*b.y + a.z*b.z`` evaluated left
to right — so the port's arithmetic matches the reference draw for draw.
That parity is the reason for the layout, not memory access: an add or a
scale on an (R, 3) tensor would be one contiguous kernel, where a tuple
costs three launches per vector op. Fusing the shading ops into kernels
is what removes that cost.
"""
from __future__ import annotations

import torch


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a):
    return (-a[0], -a[1], -a[2])


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def length_squared3(a):
    return dot3(a, a)


def length3(a):
    return torch.sqrt(length_squared3(a))


def unit3(a):
    inv = 1.0 / length3(a)
    return vscale(a, inv)


def where3(m, a, b):
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def reflect3(v, n):
    """Mirror reflection about normal n (vec3.rs:333-335)."""
    k = 2.0 * dot3(v, n)
    return (v[0] - n[0] * k, v[1] - n[1] * k, v[2] - n[2] * k)


def refract3(v, n, ir):
    """Snell refraction; v unit, n unit normal, ir ratio (vec3.rs:345-350)."""
    cos_theta = torch.clamp(dot3(vneg(v), n), max=1.0)
    perp = vscale(vadd(vscale(n, cos_theta), v), ir)
    par_k = -torch.sqrt(torch.abs(1.0 - length_squared3(perp)))
    return vadd(perp, vscale(n, par_k))


def onb_from_w3(w):
    """Orthonormal basis from a direction (geo/mod.rs:245-258): returns
    (tangent, bi_tangent, normal) with normal = unit(w)."""
    uw = unit3(w)
    pick = torch.abs(uw[0]) > 0.9
    ax = torch.where(pick, 0.0, 1.0)
    ay = torch.where(pick, 1.0, 0.0)
    a = (ax, ay, torch.zeros_like(ax))
    v = unit3(cross3(uw, a))
    u = cross3(uw, v)
    return u, v, uw


def onb_local3(t, b, n, v):
    """Express local-frame v in world space (geo/mod.rs:260-263)."""
    return (t[0] * v[0] + b[0] * v[1] + n[0] * v[2],
            t[1] * v[0] + b[1] * v[1] + n[1] * v[2],
            t[2] * v[0] + b[2] * v[1] + n[2] * v[2])
