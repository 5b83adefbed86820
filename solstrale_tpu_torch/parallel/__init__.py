"""Sharded rendering and training on ``torch.distributed``.

Port of the JAX package's ``parallel``: a (tile, sample) ``DeviceMesh``
over the ranks of the process group, one rank per device; the image split
into contiguous pixel tiles along ``tile``, consecutive samples along
``sample``, the scene replicated on every rank, and all-reduces where JAX
runs ``psum``. The RNG is keyed on the pixel id, so any partition renders
the same values as one device.

Each rank runs this code on its own shard (SPMD): every function here is a
collective, so every rank of the mesh calls it with the same arguments.
The backend follows the device: NCCL for a ``"cuda"`` mesh, gloo for a
``"cpu"`` one (``parallel.distributed.initialize``); a tensor on the other
kind of device raises.

Axes:
- ``tile``: pixels partitioned into contiguous tiles;
- ``sample``: independent samples, summed by an all-reduce.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..renderer import integrator
from ..scene.compile import to_device


def make_mesh(n_tile=None, n_sample=1, device_type="cuda"):
    """A ``DeviceMesh`` with dims ("tile", "sample") over every rank of the
    initialised process group, in row-major rank order (rank r is tile
    r // n_sample, sample r % n_sample), as the JAX mesh reshapes its
    devices."""
    world = dist.get_world_size()
    if n_tile is None:
        n_tile = world // n_sample
    if n_tile * n_sample != world:
        raise ValueError(f"make_mesh: {n_tile} x {n_sample} does not cover "
                         f"the {world} ranks")
    return init_device_mesh(device_type, (n_tile, n_sample),
                            mesh_dim_names=("tile", "sample"))


def mesh_device(mesh):
    """The torch device of this rank in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate_scene(cs, mesh):
    """The compiled scene on this rank's device (every rank holds a full
    copy, as the JAX mesh replicates it per chip)."""
    return to_device(cs, mesh_device(mesh))


def _check(mesh, *tensors):
    for x in tensors:
        if x.device.type != mesh.device_type:
            raise ValueError(f"a {x.device.type} tensor on a "
                             f"{mesh.device_type} mesh")


def all_reduce(x, mesh, dim=None):
    """Sum ``x`` in place over one mesh dim ("tile" or "sample"), or over
    the whole mesh when ``dim`` is None; returns ``x``."""
    _check(mesh, x)
    group = None if dim is None else mesh.get_group(dim)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_tiles(x, mesh):
    """Every tile rank's ``x`` (same shape on each), concatenated along dim
    0 in tile order, on every rank."""
    _check(mesh, x)
    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("tile"))
    return torch.cat(parts)


def tile_ids(n_pix, mesh):
    """(pixel ids of this rank's tile, how many of them are below n_pix):
    contiguous tiles of the image padded to a multiple of the tile
    count."""
    n_tile = mesh.size(0)
    per_tile = (n_pix + n_tile - 1) // n_tile
    start = mesh.get_local_rank("tile") * per_tile
    ids = torch.arange(start, start + per_tile, dtype=torch.int64,
                       device=mesh_device(mesh))
    return ids, max(0, min(per_tile, n_pix - start))


def render_sample_sharded(cs, sample, seed, mesh, *, width, height, max_depth,
                          shader_kind, need_aux):
    """One full-image sample pass sharded over the mesh: pixels over
    ``tile`` (padding ids clamped to the last pixel, their results dropped),
    consecutive samples over ``sample`` (sample rank k renders
    ``sample + k``), the planes summed over ``sample``: the sum of
    ``n_sample`` passes, as the renderer's progressive accumulator. Returns
    (pixel, albedo, normal) images (height, width, 3) on every rank."""
    n_pix = width * height
    ids, _ = tile_ids(n_pix, mesh)
    pix = torch.clamp(ids, max=n_pix - 1)
    planes = integrator.render_pixels(
        cs, pix, sample + mesh.get_local_rank("sample"), seed, width=width,
        height=height, max_depth=max_depth, shader_kind=shader_kind,
        need_aux=need_aux)
    out = []
    for c in planes:
        c = all_reduce(c.contiguous(), mesh, "sample")
        out.append(integrator.to_image(gather_tiles(c, mesh)[:n_pix],
                                        width, height))
    return tuple(out)


def shard_batch(cs, sample_start, n_samples, seed, mesh, *, width, height,
                max_depth):
    """This rank's part of ``render_batch_sharded``, no collective: its tile
    of pixels over its share of the batch's samples (sample rank k renders
    samples [start + k q, start + (k + 1) q), q = n_samples / n_sample),
    drained by ``integrator.trace_queued``. Padding (pixel 0, only in the
    last tile) is left out of the queue by ``n_valid``, so the segments
    stay exact. Returns (accum (per_tile, 3) in tile order, zero rows for
    the padding; segments as a 0-dim int64 tensor)."""
    n_sample = mesh.size(1)
    if n_samples % n_sample:
        raise ValueError(f"render_batch_sharded: {n_samples} samples do not "
                         f"split over {n_sample} sample ranks")
    per_shard = n_samples // n_sample
    n_pix = width * height
    ids, n_valid = tile_ids(n_pix, mesh)
    pix = torch.where(ids < n_pix, ids, 0)
    return integrator.trace_queued(
        cs, sample_start + mesh.get_local_rank("sample") * per_shard,
        per_shard, seed, width=width, height=height, max_depth=max_depth,
        pix_ids=pix, n_valid=n_valid)


def render_batch_sharded(cs, sample_start, n_samples, seed, mesh, *, width,
                         height, max_depth, shard_stats=False):
    """A whole progressive sample batch sharded over the mesh, each tile
    rank draining the work queue over its own pixels (``shard_batch``), the
    sample ranks' sums all-reduced over ``sample`` and the tiles gathered.

    Returns (color image (H, W, 3) summed over n_samples, total segments),
    on every rank; with ``shard_stats`` also the (n_tile,) segments of each
    tile (its load)."""
    accum, segs = shard_batch(cs, sample_start, n_samples, seed, mesh,
                              width=width, height=height, max_depth=max_depth)
    accum = all_reduce(accum, mesh, "sample")
    segs_tile = all_reduce(segs.reshape(1), mesh, "sample")
    per_tile = gather_tiles(segs_tile, mesh)
    color = integrator.to_image(gather_tiles(accum, mesh)[:width * height],
                                 width, height)
    if shard_stats:
        return color, per_tile.sum(), per_tile
    return color, per_tile.sum()
