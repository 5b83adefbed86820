"""The yardstick of the roofline shares: one H100's published peaks, the
least time a kernel's work could take on it, and the operation counts of
the hit kernels, frozen here so that a change to the program cannot move
them.

Peaks (NVIDIA's H100 SXM data sheet, dense, without sparsity): 67 TFLOP/s
in float32 outside the tensor cores and 3.35 TB/s of HBM3. They assume the
card's full 700 W: the result line of a run states the card's power limit
beside every share.

The operation counts are those ``solstrale_tpu_torch``'s ``chip_smoke.py``
counted line by line from its CUDA sources (``csrc/hit.cuh``,
``csrc/megakernel.cu``): an add, subtract, multiply,
division, square root, min or max is one f32 operation; a call of sinf,
cosf, acosf, atan2f, expf or logf is one; compares, selects, sign changes
and the integer hash are not counted. They count the work these rays need,
not how a kernel does it: K4's and K5's brute-force sweep of every
prim.
"""
from __future__ import annotations

PEAK_F32 = 67e12      # f32 operations a second
HBM_BPS = 3.35e12     # bytes a second

# f32 operations of one ray-prim test (csrc/hit.cuh)
FLOPS_SPHERE = 31
FLOPS_PLANAR = 32
# the media loop of K4 and K5: per live ray of a scene with media the
# direction's reciprocals; per ray and medium the box reach (8 per axis);
# per ray that reaches the box, beyond its two boundary sweeps, the flight
# uniform, t1 + 1e-4 and the medium event
MEDIUM_INV = 3
MEDIUM_BOX = 24
MEDIUM_EVENT = 14
# K5's operations beyond the sweeps (csrc/megakernel.cu); where the work
# depends on a branch the count does not split, the cheapest branch
K5_SEGMENT = 16     # every segment: the ray 15, the path length 1
K5_PATH = 58        # every path: the camera ray 46, the terminal fold 12
K5_HIT = 24         # every emission and scatter: the hit point, the
#                     cheapest attributes, the texture sample
K5_BLEND = 3        # every emission and scatter of a scene with blends
K5_PDF = 127        # every NEE scatter beyond its light pdfs
K5_BASIC = 51       # every metal or dielectric scatter
K5_NORMAL_MAP = 26  # every scatter off a normal map
K5_LIGHT = {0: 31, 1: 55, 2: 57}   # light pdf per sphere / quad / triangle
#                                    light, per NEE scatter
# K5's table flags
FLAG_BLEND = 1
FLAG_NORMAL_MAPS = 2
def bound_s(nbytes, flops):
    """(seconds, "bytes" or "operations"): the least time one H100 could
    take to move ``nbytes`` and do ``flops`` f32 operations, and which of
    the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_F32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_flops(n_sph, n_pl):
    """f32 operations of one ray's brute-force sweep of ``n_sph`` spheres
    and ``n_pl`` planar rows."""
    return n_sph * FLOPS_SPHERE + n_pl * FLOPS_PLANAR


def media_segment_flops(n_media):
    """The media loop's operations a segment, beyond its sweeps."""
    return MEDIUM_INV + MEDIUM_BOX * n_media if n_media else 0


def medium_sweep_flops(media_sizes):
    """Operations of one segment-medium pair whose ray reaches the medium's
    box: the event and the cheapest medium's two boundary sweeps.
    ``media_sizes`` lists each medium's (spheres, planar rows)."""
    return MEDIUM_EVENT + min((2 * sweep_flops(s, p) for s, p in media_sizes),
                              default=0)


def k5_flops(n_sph, n_pl, media_sizes, flags, light_kinds, n_paths,
             segments, ev, sweeps):
    """K5's f32 operations for a batch: ``n_paths`` paths of ``segments``
    segments over tables of ``n_sph`` spheres and ``n_pl`` planar rows and
    media of ``media_sizes``; ``ev`` the segments' kinds (``emit``,
    ``pdf``: NEE scatters, ``basic``: metal or dielectric scatters,
    ``mapped``: scatters off a normal map) and ``sweeps`` the
    segment-medium pairs whose ray could reach the medium's box."""
    per_segment = (K5_SEGMENT + sweep_flops(n_sph, n_pl)
                   + media_segment_flops(len(media_sizes)))
    hits = ev["emit"] + ev["pdf"] + ev["basic"]
    maps_blend = (flags & FLAG_NORMAL_MAPS) and (flags & FLAG_BLEND)
    return (segments * per_segment
            + sweeps * medium_sweep_flops(media_sizes) + n_paths * K5_PATH
            + hits * (K5_HIT + K5_BLEND * (flags & FLAG_BLEND))
            + ev["pdf"] * (K5_PDF + sum(K5_LIGHT[k] for k in light_kinds))
            + ev["basic"] * K5_BASIC + ev["mapped"] * K5_NORMAL_MAP
            + (ev["pdf"] + ev["basic"]) * K5_BLEND * bool(maps_blend))


def k4_flops(n_sph, n_pl, media_sizes, segments, sweeps):
    """K4's f32 operations: ``segments`` live rays, each a brute-force
    sweep of every sphere and planar row and the media loop, and ``sweeps``
    segment-medium pairs whose ray reaches the medium's box."""
    return (segments * (sweep_flops(n_sph, n_pl)
                        + media_segment_flops(len(media_sizes)))
            + sweeps * medium_sweep_flops(media_sizes))
