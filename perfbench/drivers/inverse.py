"""The texture-fitting driver: a user fits the scene's texture arena to a
reference image, one gradient step after another.

Each step calls the library's inverse step, ``diff.image_and_texture_grad``
(the L2 loss of the ``samples``-sample render against the target, and its
gradient with respect to the texture arena; on the card one CUDA graph
replay), hands the gradient to a plain-torch Adam on the arena, and gives
the updated arena to the next step through ``diff.set_texture_params`` of
the last step's scene (the copy carries the captured step, so the loop
captures it once). The
loss is read back each step, as a fitting loop logs it. The render seed
stays the same for the whole run: the step's graph is keyed on it.

- ``step_ms``: the window's seconds over the steps it completed;
- ``setup_s``: from the process's start to the first timed step: the
  imports, CUDA's start, the scene's generation and compile, the target,
  and the first ``checked_steps`` steps through the window's own call (the
  first captures the step's graph).

``correct`` (checked once the window has closed and the program's state is
freed): the set-up's first ``checked_steps`` steps are followed by the
plain reference (its own compile of the scene, the same target; the loss
and the arena gradient by autograd through the plain path tracer in blocks
of pixels; the same Adam). Compared, each as a gap of norms over the
reference's norm: each step's loss, the norm of the first gradient as the
optimiser got it (from Adam's first moment after one step) and the norm of
the arena's change after the checked steps; and the norms of the
differences of those gradients and changes, which see where a gradient
lands. One more step after the window, through the window's own call from
the state the window left, is checked too: its loss and gradient against
the reference's from the same arena (the one place where the reference
starts from the program's state).
"""
from __future__ import annotations

import dataclasses
import time

from .. import harness
from . import common


def make_target(seed, width, height, cells, dev):
    """The image to fit, (height * width, 3) f32 in pixel-id order: seeded
    uniform noise on a ``cells`` x ``cells`` grid, upsampled bilinearly."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    low = torch.rand((1, 3, cells, cells), generator=g, device=dev)
    img = torch.nn.functional.interpolate(low, size=(height, width),
                                          mode="bilinear",
                                          align_corners=True)
    return img[0].permute(1, 2, 0).reshape(-1, 3).contiguous()


def adam_step(p, g, state, t, lr, betas, eps):
    """One Adam update of ``p`` (in place) by gradient ``g``: torch.optim.
    Adam's formula without weight decay or amsgrad."""
    import math

    import torch

    b1, b2 = betas
    if not state:
        state["m"] = torch.zeros_like(p)
        state["v"] = torch.zeros_like(p)
    state["m"].lerp_(g, 1 - b1)
    state["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
    step_size = lr / (1 - b1 ** t)
    denom = (state["v"].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
    p.addcdiv_(state["m"], denom, value=-step_size)


def run(run):
    import torch

    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import diff
    from solstrale_tpu_torch.scene import compile as scene_compile

    cfg, mix = run.config, run.traffic
    width, height = int(mix["width"]), int(mix["height"])
    max_depth = int(cfg["max_depth"])
    n_checked = int(mix["checked_steps"])
    rec, dev = run.rec, run.device
    kw = dict(width=width, height=height, max_depth=max_depth,
              n_samples=int(mix["samples"]), seed=run.render_seed)

    restore = [rec.wrap(scene_compile, "compile_scene"),
               rec.wrap(diff, "image_and_texture_grad")]
    try:
        scene = common.build_scene(T, run, width, height, T.RenderConfig(
            width=width, height=height, seed=run.render_seed))
        cs = scene_compile.compile_scene(scene, device=dev)
        target = make_target(run.seed, width, height,
                             int(mix["target_cells"]), dev)
        arena = cs.textures.pixels.detach().clone().requires_grad_(True)
        arena0 = arena.detach().clone()
        opt = torch.optim.Adam([arena], lr=mix["lr"],
                               betas=tuple(mix["betas"]), eps=mix["eps"])

        cur = [cs]

        def step():
            # each step's scene is the last one's with the new arena: the
            # copy carries the captured step along, which replays
            cur[0] = diff.set_texture_params(cur[0], arena.detach())
            loss, grad = diff.image_and_texture_grad(cur[0], target, **kw)
            arena.grad = grad
            opt.step()
            return float(loss)

        losses = []
        for k in range(n_checked):
            losses.append(step())
            if k == 0:
                grad1 = (opt.state[arena]["exp_avg"]
                         / (1 - mix["betas"][0])).cpu()
        change = (arena.detach() - arena0).cpu()
        common.sync(dev)
        run.warm_profiler()
        setup_peak = common.memory_peak(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()

        steps = []
        t_start = time.perf_counter()
        deadline = t_start + run.args.seconds
        setup_s = t_start - run.t_process
        t_end = t_start
        while t_end < deadline:
            t0 = time.perf_counter()
            step()
            t_end = time.perf_counter()
            steps.append(dict(t=(t0, t_end)))
            run.maybe_stretch(t_start, t_end)
        run.close_stretch()
        # one more step through the window's own call, from the state the
        # window left: its loss and gradient are checked too
        arena_w = arena.detach().to("cpu", copy=True)
        loss_w = step()
        grad_w = arena.grad.detach().to("cpu", copy=True)
    finally:
        for r in restore:
            r()
    window_s = t_end - t_start
    run.attempted = len(steps)
    window_peak = common.memory_peak(dev)
    rec.counters["window_peak_bytes"] = window_peak
    run.memory_peak_bytes = max(setup_peak, window_peak)
    run.metric("step_ms", window_s / len(steps) * 1e3, "ms")
    run.metric("setup_s", setup_s, "s")
    run.info.update(common.device_info(dev), steps=len(steps),
                    window_s=window_s)
    if dev == "cuda":
        run.power_limit = harness.power_limit(run)
    if run.trace and run.stretch.t1 is not None:
        run.stretch_summary = run.stretch.summary(set(rec.spans))
    prog = dict(losses=losses, grad1=grad1, change=change, loss_w=loss_w,
                grad_w=grad_w)
    del cs, cur, arena, arena0, opt, step, scene
    common.free(dev)
    check(run, prog, target, arena_w, steps, width, height)
    if run.trace:
        harness.read_layer_metrics(run)


class _Counts:
    """The live lanes of every bounce of the reference's forward, and the
    segment-medium pairs whose ray reaches the medium's box: K4's work."""

    def __init__(self, cs, media):
        self.cs, self.media = cs, media
        self.per_bounce = {}
        self.sweeps = {}

    def __call__(self, o, d, st, lanes, b):
        from ..reference.geo import INF, RAY_T_MIN
        from ..reference.ops import sweep

        self.per_bounce[b] = self.per_bounce.get(b, 0) + int(lanes.numel())
        if self.media.n_media:
            s = self.cs.solids
            t, _ = sweep.closest_hit_plain(s.sph_table, s.pl_table,
                                           tuple(c.detach() for c in o),
                                           tuple(c.detach() for c in d),
                                           RAY_T_MIN, INF)
            n = sum(int(sweep.box_reach_plain(
                tuple(c.detach() for c in o), tuple(c.detach() for c in d),
                self.media.box[m], t).sum()) for m in range(
                    self.media.n_media))
            self.sweeps[b] = self.sweeps.get(b, 0) + n


def reference_loss_grad(cs, target, width, height, max_depth, samples, seed,
                        block, observe=None, quantize=None, fault=None):
    """The plain reference's loss (the mean square error of the
    ``samples``-sample mean image against ``target``) and its gradient
    with respect to ``cs``'s texture arena, by autograd through the plain
    path tracer, ``block`` pixels at a time. ``fault`` plants one in the
    reference (the faults the check must catch): ``"half"`` takes the mean
    over the even pixels only, ``"swap"`` swaps the image's red and blue
    channels, ``"mirror"`` sends each texel's gradient to the texel at the
    mirrored place in the arena."""
    import torch

    from ..reference import integrator as ref

    leaf = cs.textures.pixels.detach().clone().requires_grad_(True)
    rcs = dataclasses.replace(cs, textures=dataclasses.replace(
        cs.textures, pixels=leaf))
    media = ref.media_tables(rcs)
    n_pix = width * height
    n_loss = (n_pix + 1) // 2 if fault == "half" else n_pix
    loss = 0.0
    for a in range(0, n_pix, block):
        pix = torch.arange(a, min(a + block, n_pix), device=leaf.device)
        if fault == "half":
            pix = pix[pix % 2 == 0]
        with torch.enable_grad():
            img = 0.0
            for s in range(samples):
                img = img + ref.trace_paths(
                    rcs, pix, torch.full_like(pix, 1 + s), seed, width=width,
                    height=height, max_depth=max_depth, media=media,
                    quantize=quantize, observe=observe)
            img = img / samples
            if fault == "swap":
                img = img[:, [2, 1, 0]]
            part = ((img - target[pix]) ** 2).sum() / (n_loss * 3)
            part.backward()
        loss += float(part.detach())
    return loss, leaf.grad.flip(0) if fault == "mirror" else leaf.grad


def _reference_cs(run, width, height, quantize):
    cs, _ = common.reference_scene(run, width, height, quantize=quantize)
    return cs


def _loss_grad(run, cs, pixels, target, width, height, quantize=None,
               fault=None, observe=None):
    mix = run.traffic
    rcs = dataclasses.replace(cs, textures=dataclasses.replace(
        cs.textures, pixels=pixels))
    return reference_loss_grad(
        rcs, target, width, height, int(run.config["max_depth"]),
        int(mix["samples"]), run.render_seed, int(mix["reference_block"]),
        observe=observe, quantize=quantize, fault=fault)


def reference_trajectory(run, target, width, height, steps, quantize=None,
                         fault=None, observe=None):
    """The reference's ``steps`` inverse steps from its own compile of the
    scene: each step's loss, the first gradient as Adam got it
    (``grad1``), the arena's change after the steps (``change``) and the
    arena then (``arena``). With ``quantize`` every float table, the lane
    state and the arena after each update are rounded to that dtype;
    ``fault`` as ``reference_loss_grad`` takes it; ``observe`` sees the
    first step's bounces. Tensors come back on the CPU."""
    mix = run.traffic
    cs = _reference_cs(run, width, height, quantize)
    arena0 = cs.textures.pixels.detach().clone()
    arena = arena0.clone()
    state, losses = {}, []
    for k in range(steps):
        loss, grad = _loss_grad(run, cs, arena, target, width, height,
                                quantize, fault,
                                observe if k == 0 else None)
        losses.append(loss)
        adam_step(arena, grad, state, k + 1, mix["lr"], tuple(mix["betas"]),
                  mix["eps"])
        if k == 0:
            grad1 = (state["m"] / (1 - mix["betas"][0])).cpu()
        if quantize is not None:
            arena.copy_(arena.to(quantize).to(arena.dtype))
    return dict(losses=losses, grad1=grad1, change=(arena - arena0).cpu(),
                arena=arena.cpu())


def reference_window_step(run, target, width, height, arena_w,
                          quantize=None, fault=None):
    """The reference's loss and gradient (``loss_w``, ``grad_w``, on the
    CPU) of one more step from the arena ``arena_w``, the state a window
    left."""
    cs = _reference_cs(run, width, height, quantize)
    pixels = arena_w.to(cs.textures.pixels.device)
    if quantize is not None:
        pixels = pixels.to(quantize).to(pixels.dtype)
    loss, grad = _loss_grad(run, cs, pixels, target, width, height,
                            quantize, fault)
    return dict(loss_w=loss, grad_w=grad.cpu())


def _rel(x, ref):
    return abs(x - ref) / abs(ref)


def gaps(prog, ref):
    """The compared numbers of a trajectory ``prog`` against the
    reference's ``ref``, each over the reference's value or norm:

    - ``loss_gap``: the largest gap of a step's loss, the checked steps'
      and the step after the window;
    - ``grad_norm_gap``, ``change_norm_gap``: the gap of the norms of the
      first gradient and of the arena's change after the checked steps;
    - ``grad_diff_norm``: the norm of the difference of the gradients,
      the first and the step's after the window, the larger;
    - ``change_diff_norm``: the norm of the difference of the arena's
      changes.

    The norms of differences see where a gradient lands, which the gaps
    of norms cannot."""
    g1, r1 = prog["grad1"].double(), ref["grad1"].double()
    gw, rw = prog["grad_w"].double(), ref["grad_w"].double()
    dc, rc = prog["change"].double(), ref["change"].double()
    return dict(
        loss_gap=max(_rel(p, r) for p, r in
                     zip(prog["losses"] + [prog["loss_w"]],
                         ref["losses"] + [ref["loss_w"]])),
        grad_norm_gap=_rel(float(g1.norm()), float(r1.norm())),
        change_norm_gap=_rel(float(dc.norm()), float(rc.norm())),
        grad_diff_norm=max(float((g1 - r1).norm() / r1.norm()),
                           float((gw - rw).norm() / rw.norm())),
        change_diff_norm=float((dc - rc).norm() / rc.norm()))


def check(run, prog, target, arena_w, steps, width, height):
    """The comparisons of ``correct`` (see the module's docstring)."""
    lim = common.limits(run)
    counts = None
    if run.trace:
        cs, media = common.reference_scene(run, width, height)
        counts = _Counts(cs, media)
    t0 = time.perf_counter()
    ref_t = reference_trajectory(run, target, width, height,
                                 len(prog["losses"]), observe=counts)
    ref_t.update(reference_window_step(run, target, width, height, arena_w))
    run.info["reference_s"] = time.perf_counter() - t0
    for name, value in gaps(prog, ref_t).items():
        run.check(name, value, lim[name])
    run.info.update(
        program=dict(losses=prog["losses"], loss_w=prog["loss_w"]),
        reference=dict(losses=ref_t["losses"], loss_w=ref_t["loss_w"]))
    if counts is not None and run.stretch_summary is not None:
        k4_work(run, counts, steps)


def k4_work(run, counts, steps):
    """``run.work["K4"]`` over the stretch's steps: each step's forward
    traces every bounce's live lanes once and its path replay the first
    ``max_depth`` bounces again (checkpointed chunks)."""
    from .. import roofline

    inside = common.stretch_updates(run, steps)
    if not inside:
        return
    max_depth = int(run.config["max_depth"])
    segs = sum(n * (2 if b < max_depth else 1)
               for b, n in counts.per_bounce.items())
    sweeps = sum(n * (2 if b < max_depth else 1)
                 for b, n in counts.sweeps.items())
    cs, media = counts.cs, counts.media
    s = cs.solids
    media_sizes = [(x.shape[0], y.shape[0]) for x, y in
                   (media.boundary(m) for m in range(media.n_media))]
    flops = roofline.k4_flops(s.sph_table.shape[0], s.pl_table.shape[0],
                              media_sizes, segs, sweeps) * len(inside)
    # each live ray in (24 bytes) and its hit out (12)
    run.work["K4"] = (segs * 36 * len(inside), flops)
