"""Checkpoint / resume and the profiler session of Renderer.render on the
CPU: the port's checkpoint has the JAX package's keys and dtypes, each
package resumes the other's checkpoint, the port's own resume repeats the
straight render bit for bit, and ``profile_dir`` writes a trace and closes
the profiler after an abort.
"""
import json
import os

import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu.post as JP
import solstrale_tpu_torch as T
import solstrale_tpu_torch.post as TP
from solstrale_tpu.renderer.checkpoint import (load_checkpoint as jload,
                                               save_checkpoint as jsave)
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.renderer.checkpoint import (load_checkpoint as tload,
                                                     save_checkpoint as tsave)

torch.set_num_threads(2)

W, H, SPP, SEED = 32, 24, 4, 1
PLANES = ("pixel_sums", "albedo_sums", "normal_sums")


def _scene(api, spp=SPP):
    """The small scene with the denoiser in its chain, so the aux planes
    are rendered and checkpointed too."""
    return fixtures.small_scene(api.RenderConfig(
        width=W, height=H, samples_per_pixel=spp, seed=SEED,
        samples_per_batch=1,
        post_processors=[{J: JP, T: TP}[api].DenoiserPostProcessor()],
        render_image_strategy=api.OnlyFinal()), api=api)


def _render(api, stop_after=None, **kw):
    """Render through ``api``'s Renderer; stop (close the generator) after
    ``stop_after`` progress reports. Returns the last image."""
    renderer = (api.Renderer(_scene(api)) if api is J
                else api.Renderer(_scene(api), device="cpu"))
    image = None
    for n, p in enumerate(renderer.render(**kw), 1):
        if p.render_image is not None:
            image = p.render_image
        if n == stop_after:
            break
    return image


def test_checkpoint_keys_and_dtypes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    planes = [rng.uniform(0, 2, (H, W, 3)).astype(np.float32)
              for _ in PLANES]
    jsave(tmp_path / "j.npz", *planes, 3, SEED)
    tsave(tmp_path / "t.npz", *(torch.from_numpy(p) for p in planes), 3,
          SEED)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape
            np.testing.assert_array_equal(zt[k], zj[k])
    assert tload(tmp_path / "j.npz").keys() == jload(tmp_path / "t.npz").keys()


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_cross_package_resume(tmp_path, first, second):
    """One package renders 2 of 4 samples into a checkpoint, the other
    resumes from it to the end; its final checkpoint is within 1e-4 of a
    straight JAX run's."""
    api = {"jax": J, "port": T}
    _render(J, checkpoint_path=str(tmp_path / "straight.npz"),
            checkpoint_every=2)
    _render(api[first], stop_after=2, checkpoint_path=str(tmp_path /
                                                          "half.npz"),
            checkpoint_every=2)
    half = tload(tmp_path / "half.npz")
    assert half["samples_done"] == 2 and half["seed"] == SEED
    image = _render(api[second], resume_from=str(tmp_path / "half.npz"),
                    checkpoint_path=str(tmp_path / "resumed.npz"),
                    checkpoint_every=2)
    assert image is not None and image.shape == (H, W, 3)
    straight, resumed = (jload(tmp_path / f) for f in ("straight.npz",
                                                       "resumed.npz"))
    assert resumed["samples_done"] == SPP
    for k in PLANES:
        assert float(np.abs(resumed[k]).sum()) > 0
        np.testing.assert_allclose(resumed[k], straight[k], rtol=1e-4,
                                   atol=1e-4)


def test_port_resume_is_bit_identical(tmp_path):
    """Stopped after sample 2 and resumed, the port's render equals the
    straight render exactly: final image and every plane."""
    straight = _render(T, checkpoint_path=str(tmp_path / "a.npz"),
                       checkpoint_every=1)
    _render(T, stop_after=2, checkpoint_path=str(tmp_path / "half.npz"),
            checkpoint_every=1)
    resumed = _render(T, resume_from=str(tmp_path / "half.npz"),
                      checkpoint_path=str(tmp_path / "b.npz"),
                      checkpoint_every=1)
    np.testing.assert_array_equal(resumed, straight)
    a, b = tload(tmp_path / "a.npz"), tload(tmp_path / "b.npz")
    for k in PLANES:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["samples_done"] == b["samples_done"] == SPP


@pytest.mark.parametrize("abort_after", [None, 1])
def test_profile_dir_writes_trace_and_closes(tmp_path, abort_after):
    """profile_dir: a Chrome trace of the loop, written and the profiler
    closed when the loop ends and when it is aborted."""
    calls = []

    def abort():
        calls.append(1)
        return abort_after is not None and len(calls) > abort_after

    renderer = T.Renderer(_scene(T, spp=2), device="cpu")
    reports = list(renderer.render(abort=abort,
                                   profile_dir=str(tmp_path / "prof")))
    assert len(reports) == (2 if abort_after is None else abort_after)
    assert not torch.autograd._profiler_enabled()
    with open(os.path.join(tmp_path, "prof", "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
