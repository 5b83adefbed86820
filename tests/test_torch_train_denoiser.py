"""The denoiser trainer (``solstrale_tpu_torch.models.train_denoiser``) on
the CPU against flax + optax: Adam steps from the bundled weights on a
seeded batch, the cosine-decay schedule at every step, the flax-layout
weights file both packages read, and a short ``train`` run.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import solstrale_tpu.post as JP
import solstrale_tpu_torch as T
from solstrale_tpu.models import denoiser as JD
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.models import denoiser as TD
from solstrale_tpu_torch.models import train_denoiser as TT

torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "solstrale_tpu", "models", "denoiser_weights.pkl")
H, W, STEPS = 20, 24, 10


def _batch(seed):
    rng = np.random.default_rng(seed)
    color, albedo, clean = (rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
                            for _ in range(3))
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return color, albedo, normal, clean


def _leaves(tree):
    return {f"{k}.{p}": np.asarray(v[p]) for k, v in tree["params"].items()
            for p in ("kernel", "bias")}


def test_adam_step_matches_optax():
    """One Adam step from the bundled weights on a seeded batch against
    flax's apply + optax.adam under cosine_decay_schedule(1e-3, 10): the
    loss (rtol 1e-5) and the gradient (rtol 1e-5, atol 1e-6 of its
    largest entry) of ``train_step``, and the step itself on the same
    gradient, every parameter at rtol 1e-5 and atol 5e-8: weights reach
    0.3, where an f32 ulp is 3e-8, and each package's step lies within
    2.1e-8 of the step in f64. (A weight whose gradient is near Adam's eps,
    1e-8, moves by lr * g / (|g| + eps), so comparing the two packages'
    steps end to end would amplify the gradients' last-bit differences
    there.)"""
    with open(WEIGHTS, "rb") as f:
        params = pickle.load(f)
    model = JD.DenoiserCNN()
    opt = optax.adam(optax.cosine_decay_schedule(1e-3, STEPS))
    batch = _batch(1)

    def loss_fn(p):
        out = model.apply(p, *(jnp.asarray(x) for x in batch[:3]))
        return jnp.mean(jnp.abs(out - jnp.asarray(batch[3])))

    loss_j, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = opt.update(grads, opt.init(params))
    want = _leaves(optax.apply_updates(params, updates))
    grads = _leaves(grads)

    net = TD.params_from_flax(TD.load_weights(WEIGHTS))
    t_opt, t_sched = TT.make_optimizer(net, STEPS)
    loss_t = TT.train_step(net, t_opt, t_sched,
                           *(torch.from_numpy(x) for x in batch))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    scale = max(np.abs(g).max() for g in grads.values())
    got = _leaves(TT.params_to_flax(_grads_as_params(net)))
    for k in grads:
        np.testing.assert_allclose(got[k], grads[k], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=k)

    net = TD.params_from_flax(TD.load_weights(WEIGHTS))
    t_opt, _ = TT.make_optimizer(net, STEPS)
    for name, conv in net.named_children():
        conv.weight.grad = torch.from_numpy(np.ascontiguousarray(
            grads[f"{name}.kernel"].transpose(3, 2, 0, 1)))
        conv.bias.grad = torch.from_numpy(grads[f"{name}.bias"].copy())
    t_opt.step()
    got = _leaves(TT.params_to_flax(net))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-8,
                                   err_msg=k)


def _grads_as_params(net):
    """A model holding ``net``'s gradients as its weights."""
    out = TD.DenoiserCNN()
    with torch.no_grad():
        for p, q in zip(out.parameters(), net.parameters()):
            p.copy_(q.grad)
    return out


@pytest.mark.parametrize("steps", [1, 10, 600])
def test_schedule_matches_optax(steps):
    """The LambdaLR learning rate before each update equals optax's
    cosine_decay_schedule(1e-3, steps) at that count, past the end too:
    rtol 1e-6, and atol 1e-10 for optax's f32 rounding of 1 + cos near the
    end of the decay."""
    net = TD.DenoiserCNN(features=2)
    opt, sched = TT.make_optimizer(net, steps)
    want = optax.cosine_decay_schedule(1e-3, steps)
    for count in range(steps + 3):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(count)), rtol=1e-6, atol=1e-10)
        opt.step()
        sched.step()


def test_params_to_flax_round_trip(tmp_path):
    """params_to_flax inverts params_from_flax exactly, and the file it
    makes is read by the JAX package's denoiser and by the port's loader,
    which then denoise alike."""
    tree = TD.load_weights(WEIGHTS)
    out = TT.params_to_flax(TD.params_from_flax(tree))
    for k, v in _leaves(tree).items():
        assert _leaves(out)[k].dtype == np.float32
        np.testing.assert_array_equal(_leaves(out)[k], v)
    path = str(tmp_path / "w.pkl")
    with open(path, "wb") as f:
        pickle.dump(out, f)
    jax_proc = JP.DenoiserPostProcessor(weights_path=path)
    assert _leaves(jax_proc._params).keys() == _leaves(tree).keys()
    color, albedo, normal, _ = _batch(3)
    want = JD.DenoiserCNN().apply(jax_proc._params, color, albedo, normal)
    with torch.no_grad():
        got = TD.params_from_flax(TD.load_weights(path))(
            *(torch.from_numpy(x) for x in (color, albedo, normal)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flax_init_statistics():
    """init_like_flax: seeded, zero biases, kernels inside 2 sigma of
    lecun_normal with its variance."""
    a = TT.init_like_flax(TD.DenoiserCNN(), seed=0)
    b = TT.init_like_flax(TD.DenoiserCNN(), seed=0)
    for (name, ca), cb in zip(a.named_children(), b.children()):
        assert torch.equal(ca.weight, cb.weight) and not ca.bias.any()
        fan_in = ca.weight[0].numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert ca.weight.abs().max() <= 2 * std + 1e-7, name
    w = a.Conv_4.weight.detach()
    np.testing.assert_allclose(float(w.std()), (1.0 / w[0].numel()) ** 0.5,
                               rtol=0.05)


def test_train_two_steps(tmp_path, capsys):
    """A 2-step CPU train on two fixture scenes at 16x16: finite losses,
    parameters moved from the init, the weights file written."""
    cfg = dict(width=16, height=16, seed=3)
    scenes = [
        lambda spp: fixtures.small_scene(
            T.RenderConfig(samples_per_pixel=spp, **cfg)),
        lambda spp: fixtures.kitchen_sink_solid_scene(
            T.RenderConfig(samples_per_pixel=spp, **cfg)),
    ]
    path = str(tmp_path / "w.pkl")
    net = TT.train(2, path, size=16, clean_spp=2, scenes=scenes,
                   device="cpu")
    printed = capsys.readouterr().out
    assert "18 training pairs" in printed and "step 0: L1" in printed
    loss = float(printed.split("step 0: L1")[1].split()[0])
    assert np.isfinite(loss) and loss > 0
    init = TT.init_like_flax(TD.DenoiserCNN())
    assert not torch.equal(net.Conv_0.weight, init.Conv_0.weight)
    assert all(torch.isfinite(p).all() for p in net.parameters())
    assert _leaves(TD.load_weights(path)).keys() == \
        _leaves(TT.params_to_flax(net)).keys()
