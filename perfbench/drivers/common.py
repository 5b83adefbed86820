"""Pieces the drivers share: the scene built through either package, the
device's bookkeeping, the limits of a cell's checks, and the work counts
of K5 taken from the reference's paths."""
from __future__ import annotations

import importlib

from .. import roofline


def build_scene(api, run, width, height, render_config):
    """The configuration's scene (``perfbench/scenes/<scene>.py``) built
    through ``api`` with its parameters."""
    mod = importlib.import_module(f"perfbench.scenes.{run.config['scene']}")
    return mod.build(api, render_config, **run.config.get("params", {}))


def reference_scene(run, width, height, quantize=None):
    """(compiled scene, media tables) of the plain reference, built from
    the same generator and compiled by the reference itself on the run's
    device; with ``quantize`` every float table rounded to that dtype."""
    from .. import reference
    from ..reference import integrator
    from ..reference.scene.compile import compile_scene

    scene = build_scene(reference, run, width, height,
                        reference.RenderConfig(width, height))
    cs = compile_scene(scene, device=run.device)
    if quantize is not None:
        cs = integrator.quantized(cs, quantize)
    return cs, integrator.media_tables(cs)


def limits(run):
    """The cell's limits: the traffic mix's for this configuration, else
    the configuration's for this traffic mix."""
    by_config = run.traffic.get("limits", {})
    if run.config["name"] in by_config:
        return by_config[run.config["name"]]
    return run.config["limits"][run.cell["traffic"]]


def sync(dev):
    import torch

    if dev == "cuda":
        torch.cuda.synchronize()


def free(dev):
    import gc

    import torch

    gc.collect()
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(dev):
    import torch

    return torch.cuda.max_memory_allocated() if dev == "cuda" else 0


def device_info(dev):
    import torch

    if dev != "cuda":
        return {"kind": "cpu"}
    return {"kind": torch.cuda.get_device_name(0)}


def stretch_updates(run, updates):
    """The updates (or steps) whose call lies inside the profiled
    stretch."""
    return [u for u in updates if run.in_stretch(*u["t"])]


class Observer:
    """Sees every bounce of the reference's paths and counts the work K5
    needs for them: the segments' kinds and medium reaches. ``finish``
    scales the sample's counts to the segments of the profiled stretch."""

    @classmethod
    def wanted(cls, run):
        """Whether the run is traced and reports K5's share."""
        return run.trace and any(m["name"] == "k5_roofline"
                                 for m in run.layer)

    def __init__(self, run, cs, media):
        self.cs, self.media = cs, media
        self.ev = dict(miss=0, capped=0, emit=0, pdf=0, basic=0, mapped=0)
        self.sweeps = 0
        self.segments = 0

    def __call__(self, o, d, st, lanes, bounce):
        from ..reference.geo import INF, RAY_T_MIN
        from ..reference.ops import sweep

        self.segments += int(lanes.numel())
        scat, pdf = st["scat"], st["is_pdf"]
        for k, v in (("miss", st["miss"]), ("capped", st["capped"]),
                     ("emit", st["emit"]), ("pdf", scat & pdf),
                     ("basic", scat & ~pdf), ("mapped", st["mapped"])):
            self.ev[k] += int(v.sum())
        if self.media.n_media:
            s = self.cs.solids
            t, _ = sweep.closest_hit_plain(s.sph_table, s.pl_table, o, d,
                                           RAY_T_MIN, INF)
            for m in range(self.media.n_media):
                self.sweeps += int(sweep.box_reach_plain(
                    o, d, self.media.box[m], t).sum())

    def finish(self, run, updates, paths_per_update, pixels):
        """``run.work["K5"]`` over the stretch's updates."""
        if run.stretch_summary is None:
            return
        inside = stretch_updates(run, updates)
        if not inside or not self.segments:
            return
        segs = sum(int(u["segs"]) for u in inside)
        run.work["K5"] = self._k5(segs, segs / self.segments, len(inside),
                                  paths_per_update, pixels,
                                  run.stretch_summary["kernels"])

    def _k5(self, segs, scale, n_updates, paths_per_update, pixels,
            kernels):
        from ..harness import kernel_seconds

        cs, media = self.cs, self.media
        s = cs.solids
        ev = {k: v * scale for k, v in self.ev.items()}
        flags = ((roofline.FLAG_BLEND if "blend" in cs.features else 0)
                 | (roofline.FLAG_NORMAL_MAPS if "normal_maps" in cs.features
                    else 0))
        media_sizes = [(x.shape[0], y.shape[0]) for x, y in
                       (media.boundary(m) for m in range(media.n_media))]
        flops = roofline.k5_flops(
            s.sph_center.shape[0], s.pl_n.shape[0], media_sizes, flags,
            cs.light_kinds, n_updates * paths_per_update, segs, ev,
            self.sweeps * scale)
        launches, _ = kernel_seconds(kernels, r"\bk5_render\b")
        n_pl, n_sph = s.pl_n.shape[0], s.sph_center.shape[0]
        table_floats = (24 + n_sph * 8 + n_pl * 28
                        + cs.lights.kind.shape[0] * 20
                        + cs.materials.attr.numel() + cs.textures.attr.numel()
                        + cs.textures.pixels.numel() + media.sph.numel()
                        + media.pln.numel() + media.n_media * 12)
        # each launch reads the tables once and writes 16 bytes a pixel
        return (launches * (table_floats * 4 + pixels * 16), flops)
