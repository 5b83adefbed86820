"""Renderer orchestration: the progressive sample loop, progress/abort
protocol and post-processing chain (the reference's
``renderer/mod.rs:138-358``), with the accumulation buffers on the
renderer's device, checkpoint / resume (``checkpoint.py``) and an optional
``torch.profiler`` trace of the loop.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class RenderImageStrategy:
    """When progress reports carry an image (renderer/mod.rs:86-118)."""

    def should_generate_image(self, sample, total_samples, now, last_time):
        raise NotImplementedError


class EverySample(RenderImageStrategy):
    def should_generate_image(self, sample, total_samples, now, last_time):
        return True


@dataclass
class Interval(RenderImageStrategy):
    seconds: float = 1.0

    def should_generate_image(self, sample, total_samples, now, last_time):
        return sample == total_samples or (now - last_time) > self.seconds


class OnlyFinal(RenderImageStrategy):
    def should_generate_image(self, sample, total_samples, now, last_time):
        return sample == total_samples


@dataclass
class RenderProgress:
    """Progress report (renderer/mod.rs:75-84)."""

    progress: float
    fps: float | None = None
    estimated_time_left: float = 0.0
    render_image: np.ndarray | None = None


class RenderConfig:
    """Render parameters; defaults match renderer/mod.rs:41-52 plus a
    ``seed`` (the RNG is a counter hash, so a seed fixes the image)."""

    def __init__(self, width=300, height=200, samples_per_pixel=50,
                 shader=None, post_processors=None,
                 render_image_strategy=None, seed=0, samples_per_batch=1):
        from .shader import PathTracingShader

        self.width = int(width)
        self.height = int(height)
        self.samples_per_pixel = int(samples_per_pixel)
        self.shader = shader if shader is not None else PathTracingShader(50)
        self.post_processors = list(post_processors or [])
        self.render_image_strategy = render_image_strategy or OnlyFinal()
        self.seed = int(seed)
        # samples traced per progress step (one work queue)
        self.samples_per_batch = int(samples_per_batch)

    def needs_albedo_and_normal_colors(self):
        return any(p.needs_albedo_and_normal_colors()
                   for p in self.post_processors)


class Renderer:
    """Executes the progressive render loop (renderer/mod.rs:138-358) on
    ``device``. A CUDA device that is not available raises; nothing falls
    back to the CPU."""

    def __init__(self, scene, device="cuda"):
        from ..post import NopPostProcessor
        from ..scene.compile import _target_device, compile_scene

        self.device = _target_device(device, "Renderer")
        self.scene = scene
        self.config = scene.render_config
        # raises "Scene should have at least one light" (renderer/mod.rs:143)
        self.compiled = compile_scene(scene, device=self.device)
        self.post_processors = list(self.config.post_processors)
        if not self.post_processors:
            self.post_processors.append(NopPostProcessor())
        # samples accumulated by the last render() (also when it was
        # aborted or closed early)
        self.samples_done = 0

    def render(self, abort=None, resume_from=None, checkpoint_path=None,
               checkpoint_every=0, profile_dir=None):
        """Generator yielding a RenderProgress per sample batch.

        - ``abort``: zero-arg callable checked between batches (the
          cooperative abort channel of renderer/mod.rs:237-239);
        - ``resume_from``: path of a checkpoint (this package's or the JAX
          package's) to continue from;
        - ``checkpoint_path`` + ``checkpoint_every``: write the
          accumulation state every N samples and at the end;
        - ``profile_dir``: run a ``torch.profiler`` session over the loop
          and write its Chrome trace to ``profile_dir/trace.json`` when the
          loop ends, is aborted or is closed.

        Each batch is one ``integrator.render_sample_batch``, on the card
        one device program: K5's launch, or the wavefront's graph replays
        for the path shader, and one replay of the first-hit pass's graph
        (``integrator.first_hit_pass``) for a debug shader, or for the aux
        planes a denoiser needs.
        """
        from . import integrator
        from .checkpoint import load_checkpoint, save_checkpoint

        cfg = self.config
        w, h = cfg.width, cfg.height
        spp = cfg.samples_per_pixel
        need_aux = cfg.needs_albedo_and_normal_colors()
        strategy = cfg.render_image_strategy

        pixel_sums = torch.zeros((h, w, 3), dtype=torch.float32,
                                 device=self.device)
        albedo_sums = torch.zeros_like(pixel_sums)
        normal_sums = torch.zeros_like(pixel_sums)
        sample = 0
        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            pixel_sums, albedo_sums, normal_sums = (
                torch.from_numpy(ck[k]).to(self.device)
                for k in ("pixel_sums", "albedo_sums", "normal_sums"))
            sample = ck["samples_done"]
        self.samples_done = sample
        start = time.monotonic()
        last_image_time = -1e30
        profiler = None
        if profile_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
        try:
            while sample < spp:
                batch = min(cfg.samples_per_batch, spp - sample)
                if abort is not None and abort():
                    return
                color, albedo, normal, _segs = integrator.render_sample_batch(
                    self.compiled, sample + 1, cfg.seed, width=w, height=h,
                    max_depth=cfg.shader.max_depth,
                    shader_kind=cfg.shader.kind, need_aux=need_aux,
                    n_samples=batch)
                sample += batch
                pixel_sums = pixel_sums + color
                if need_aux:
                    albedo_sums = albedo_sums + albedo
                    normal_sums = normal_sums + normal
                if checkpoint_path and checkpoint_every and \
                        (sample % checkpoint_every == 0 or sample == spp):
                    save_checkpoint(checkpoint_path, pixel_sums, albedo_sums,
                                    normal_sums, sample, cfg.seed)

                now = time.monotonic()
                render_image = None
                if strategy.should_generate_image(sample, spp, now,
                                                  last_image_time):
                    last_image_time = now
                    if abort is not None and abort():
                        return
                    inter = pixel_sums
                    for p in self.post_processors[:-1]:
                        inter = p.intermediate_post_process(
                            inter, albedo_sums, normal_sums, w, h, sample)
                    render_image = self.post_processors[-1].post_process(
                        inter, albedo_sums, normal_sums, w, h, sample)

                elapsed = max(now - start, 1e-3)
                yield RenderProgress(
                    progress=sample / spp,
                    fps=sample / elapsed,
                    estimated_time_left=elapsed / sample * (spp - sample),
                    render_image=render_image,
                )
        finally:
            # runs on completion, abort and generator close alike
            self.samples_done = sample
            if profiler is not None:
                profiler.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(profile_dir, "trace.json"))

    def render_final(self, abort=None):
        """Run to completion, return the final u8 image (H, W, 3)."""
        image = None
        for progress in self.render(abort):
            if progress.render_image is not None:
                image = progress.render_image
        return image


def ray_trace(scene, abort=None, device="cuda"):
    """Library entry point (lib.rs:93-99): yields RenderProgress."""
    yield from Renderer(scene, device=device).render(abort)
