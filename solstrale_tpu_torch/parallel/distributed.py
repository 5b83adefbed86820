"""Multi-process orchestration: one process (rank) per device.

Port of the JAX package's ``parallel/distributed.py`` on
``torch.distributed``: a process group (NCCL for CUDA, gloo for the CPU),
a global (tile, sample) mesh over every rank, the scene compiled on each
rank's device, and rank 0 assembling the progressive output.

Run the same command on every rank, e.g. two CPU ranks on one host:

    python -m solstrale_tpu_torch.parallel.distributed \\
        --init-method tcp://localhost:29500 --world-size 2 --rank 0 \\
        --device-type cpu &
    python -m solstrale_tpu_torch.parallel.distributed \\
        --init-method tcp://localhost:29500 --world-size 2 --rank 1 \\
        --device-type cpu

or under ``torchrun`` (``--init-method env://``, which reads the world
size and rank from the environment).
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import _build
from ..scene.compile import compile_scene
from ..utils import to_rgb_u8
from . import make_mesh, mesh_device, render_sample_sharded

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(init_method=None, world_size=None, rank=None,
               device_type="cuda"):
    """Join the process group at ``init_method`` (``tcp://host:port``,
    ``file:///path`` or ``env://``) with the backend of ``device_type``
    (NCCL for "cuda", gloo for "cpu"); a CUDA rank takes device
    ``rank % device_count``. Without ``init_method`` nothing is started.
    Returns (world size, rank): (1, 0) for a single process."""
    if init_method is not None:
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("initialize: device_type 'cuda' but "
                               "torch.cuda.is_available() is false")
        ids = {} if world_size is None else dict(world_size=world_size,
                                                 rank=rank)
        dist.init_process_group(BACKENDS[device_type],
                                init_method=init_method, **ids)
        if device_type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def global_mesh(n_sample=1, device_type="cuda"):
    """Mesh over every rank of the group, tile-major: neighbouring image
    tiles sit on neighbouring ranks."""
    return make_mesh(n_tile=dist.get_world_size() // n_sample,
                     n_sample=n_sample, device_type=device_type)


def render_distributed(scene, n_sample_axis=1, abort=None,
                       device_type="cuda"):
    """Progressive render over every rank: each rank renders its tile of
    each sample pass (``render_sample_sharded``), ``n_sample_axis`` passes
    at a time.

    Yields (progress, u8 image as a numpy (H, W, 3) array) on rank 0 and
    (progress, None) elsewhere. ``abort`` (a callable) is asked before each
    pass; every rank must give the same answer."""
    cfg = scene.render_config
    mesh = global_mesh(n_sample_axis, device_type)
    cs = compile_scene(scene, device=mesh_device(mesh))

    w, h, spp = cfg.width, cfg.height, cfg.samples_per_pixel
    pixel_sums = torch.zeros((h, w, 3), dtype=torch.float32,
                             device=cs.device)
    sample = 0
    while sample < spp:
        if abort is not None and abort():
            return
        color, _, _ = render_sample_sharded(
            cs, sample + 1, cfg.seed, mesh, width=w, height=h,
            max_depth=cfg.shader.max_depth, shader_kind=cfg.shader.kind,
            need_aux=False)
        pixel_sums = pixel_sums + color
        sample += n_sample_axis
        image = None
        if dist.get_rank() == 0:
            image = to_rgb_u8(pixel_sums, min(sample, spp)).cpu().numpy()
        yield min(sample, spp) / spp, image


def host_only(x, where="result"):
    """Raise TypeError where ``x`` (a number, a string, numpy, a tensor, or
    a tuple, list or dict of them) holds a tensor off the CPU: a rank's
    result crosses to the launcher, which must open no context on the
    ranks' cards. Returns ``x``."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError(f"{where}: a {x.device} tensor; a rank returns "
                            f"CPU values only")
    elif isinstance(x, dict):
        for k, v in x.items():
            host_only(v, f"{where}[{k!r}]")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            host_only(v, f"{where}[{i}]")
    return x


def _rank_main(fn, rank, world_size, init_method, device_type, args,
               results):
    """One process of ``launch``: join the group, run ``fn``, report. The
    result must hold CPU values only (``host_only``) and travels as plain
    pickle bytes (the queue's own pickler would share tensors by file
    descriptor, which dies with this process); the report is flushed
    before the group is torn down, which can block while another rank
    waits in a collective. A gloo rank runs one intra-op thread: the ranks
    share the host's cores, and intra-op threads that spin while they wait
    oversubscribe them (four ranks of eight threads each ran a 21x11 batch
    in 20 s that one rank runs in 0.25 s)."""
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        initialize(init_method, world_size, rank, device_type)
        item = (rank, pickle.dumps(host_only(fn(*args))), None)
    except BaseException as e:  # reported to the launcher, which raises
        item = (rank, None, f"{type(e).__name__}: {e}")
    results.put(item)
    results.close()
    results.join_thread()
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn, world_size, args=(), device_type="cuda", timeout=300.0):
    """Run ``fn(*args)`` on ``world_size`` new processes (spawned), each a
    rank of one process group (a FileStore in a temporary directory) with
    the backend of ``device_type``: NCCL on the card, rank r on card r
    (``world_size`` must not exceed the cards; the kernel library is built
    here, once, before the ranks start), or gloo for ``"cpu"``. ``fn`` must
    be importable by name and return CPU values only (``host_only``).
    Returns the ranks' results in rank order; a rank that raises, or a run
    that outlasts ``timeout`` seconds, raises here (the processes are
    ended)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: device_type 'cuda' but "
                               "torch.cuda.is_available() is false")
        if world_size > torch.cuda.device_count():
            raise RuntimeError(f"launch: {world_size} ranks but "
                               f"{torch.cuda.device_count()} cards: NCCL "
                               f"takes one card a rank")
        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, init_method,
                                   device_type, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        end = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, res, err = results.get(
                        timeout=max(0.0, end - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(f"launch: {world_size} ranks did "
                                       f"not finish in {timeout} s") from None
                if err is not None:
                    raise RuntimeError(f"launch: rank {rank}: {err}")
                out[rank] = pickle.loads(res)
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]


def scaling_efficiency(rays_per_s_by_ranks):
    """Scaling efficiency against the one-rank rate: {n: rate_n / (n *
    rate_1)}."""
    base = rays_per_s_by_ranks[1]
    return {n: r / (n * base) for n, r in rays_per_s_by_ranks.items()}


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--init-method", default=None)
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--device-type", default="cuda", choices=sorted(BACKENDS))
    args = p.parse_args()
    n, i = initialize(args.init_method, args.world_size, args.rank,
                      args.device_type)
    print(f"distributed runtime up: {n} processes, this is {i}")
    if dist.is_initialized():
        dist.destroy_process_group()
