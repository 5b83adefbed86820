"""Post-processing on the CPU against the JAX package: the Gaussian weights
and rgb_to_vec3, bloom, the bilateral and CNN denoisers (the CNN through
params_from_flax against flax's apply on the bundled weights, at sizes where
the pool floors and the resize is not an exact 2x), the denoiser post
processor's u8 output, the bundled weights file, and ray_trace with bloom
and the denoiser in its chain.
"""
import hashlib
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu.post as JP
import solstrale_tpu_torch as T
import solstrale_tpu_torch.post as TP
from solstrale_tpu import utils as JU
from solstrale_tpu.models import denoiser as JD
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch import utils as TU
from solstrale_tpu_torch.models import denoiser as TD

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_WEIGHTS = os.path.join(ROOT, "solstrale_tpu", "models",
                           "denoiser_weights.pkl")
PORT_WEIGHTS = os.path.join(ROOT, "solstrale_tpu_torch", "models",
                            "denoiser_weights.pkl")


def _u8_close(got, want):
    """u8 images equal on >= 99.9% of pixels and never more than 1 apart."""
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).all(axis=-1).mean() >= 0.999


@pytest.mark.parametrize("size,std", [(1, 0.2), (7, 1.4), (33, 6.6)])
def test_gaussian_blur_weights_match_jax(size, std):
    got = TU.create_gaussian_blur_weights(size, std)
    np.testing.assert_array_equal(got, JU.create_gaussian_blur_weights(
        size, std))
    assert got.dtype == np.float64 and abs(got.sum() - 1.0) < 1e-12


def test_rgb_to_vec3_matches_jax():
    px = np.arange(0, 256, 17, dtype=np.uint8).reshape(-1, 4)[:, :3]
    np.testing.assert_array_equal(TU.rgb_to_vec3(px), JU.rgb_to_vec3(px))


@pytest.mark.parametrize("max_intensity", [None, 3.0])
@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.5])
def test_bloom_matches_jax(fraction, max_intensity):
    """intermediate_post_process on 33x24 sums of 2 samples (about a third
    of the pixels above the threshold); rtol 1e-5 (the sums of the blur run
    in another order: the JAX version adds tap by tap)."""
    rng = np.random.default_rng(7)
    sums = rng.uniform(0.0, 8.0, (24, 33, 3)).astype(np.float32)
    want = JP.BloomPostProcessor(fraction, max_intensity=max_intensity) \
        .intermediate_post_process(sums, None, None, 33, 24, 2)
    got = TP.BloomPostProcessor(fraction, max_intensity=max_intensity) \
        .intermediate_post_process(torch.from_numpy(sums), None, None, 33,
                                   24, 2)
    assert got.shape == (24, 33, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    if fraction > 0:
        assert not np.array_equal(got.numpy(), sums)


def test_bloom_rejects_fraction_outside_range():
    with pytest.raises(ValueError, match="between 0 and 0.5"):
        TP.BloomPostProcessor(0.7)


def _aux_inputs(h, w, seed=0):
    rng = np.random.default_rng(seed)
    color, albedo = (rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
                     for _ in range(2))
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return color, albedo, normal


@pytest.mark.parametrize("h,w", [(24, 32), (25, 33)])
def test_cnn_matches_flax(h, w):
    """The bundled weights through params_from_flax against flax's apply.
    At 25x33 the pool floors to 12x16 and the bilinear resize back is not
    an exact 2x. atol 1e-5."""
    with open(JAX_WEIGHTS, "rb") as f:
        params = pickle.load(f)
    inputs = _aux_inputs(h, w)
    want = JD.DenoiserCNN().apply(params, *(jnp.asarray(x) for x in inputs))
    model = TD.params_from_flax(TD.load_weights(PORT_WEIGHTS))
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in inputs))
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_denoise_bilateral_matches_jax():
    """Wrap-around borders (jnp.roll / torch.roll); atol 1e-5."""
    inputs = _aux_inputs(24, 33, seed=1)
    want = JD.denoise_bilateral(*(jnp.asarray(x) for x in inputs))
    got = TD.denoise_bilateral(*(torch.from_numpy(x) for x in inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("use_cnn", [True, False])
def test_denoiser_post_process_matches_jax(use_cnn):
    """The u8 image from accumulated sums of 3 samples: the CNN with the
    bundled weights, or the bilateral filter when asked for no CNN."""
    rng = np.random.default_rng(2)
    sums = [rng.uniform(0, 3, (24, 32, 3)).astype(np.float32)
            for _ in range(2)] + [rng.normal(size=(24, 32, 3))
                                  .astype(np.float32)]
    want = JP.DenoiserPostProcessor(use_cnn=use_cnn).post_process(
        *sums, 32, 24, 3)
    proc = TP.DenoiserPostProcessor(use_cnn=use_cnn)
    assert (proc._model is not None) == use_cnn
    got = proc.post_process(*(torch.from_numpy(x) for x in sums), 32, 24, 3)
    _u8_close(got, np.asarray(want))
    with pytest.raises(ValueError, match="intermediate"):
        proc.intermediate_post_process(*sums, 32, 24, 3)
    assert proc.needs_albedo_and_normal_colors()
    assert issubclass(TP.OidnPostProcessor, TP.DenoiserPostProcessor)


def test_weights_loader_takes_numpy_arrays_only(tmp_path):
    """The weights file is read by an unpickler that resolves numpy's array
    reconstructor and nothing else."""
    good = {"params": {"Conv_0": {"bias": np.arange(3, dtype=np.float32)}}}
    with open(tmp_path / "good.pkl", "wb") as f:
        pickle.dump(good, f)
    np.testing.assert_array_equal(
        TD.load_weights(tmp_path / "good.pkl")["params"]["Conv_0"]["bias"],
        good["params"]["Conv_0"]["bias"])
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"params": os.path.join}, f)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        TD.load_weights(tmp_path / "bad.pkl")


def test_bundled_weights_are_the_jax_packages():
    digests = []
    for path in (JAX_WEIGHTS, PORT_WEIGHTS):
        with open(path, "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]


def test_ray_trace_with_bloom_and_denoiser_matches_jax():
    """The small scene at 32x24, 2 spp, with [Bloom(0.1), Denoiser] in its
    chain: the aux channels are rendered, bloom transforms the sums and the
    CNN makes the u8 image."""
    def final(api, post, **kw):
        scene = fixtures.small_scene(api.RenderConfig(
            width=32, height=24, samples_per_pixel=2, seed=1,
            post_processors=[post.BloomPostProcessor(0.1),
                             post.DenoiserPostProcessor()]), api=api)
        images = [p.render_image for p in api.ray_trace(scene, **kw)]
        return images[-1]

    got = final(T, TP, device="cpu")
    _u8_close(got, final(J, JP))
    assert got.mean() > 10
