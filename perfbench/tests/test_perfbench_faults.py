"""``correct`` comes out false when the timed path is broken underneath, and
the control (the plain reference in bfloat16 in the program's place) and
the planted faults fail the cell's limits: each cell on the CPU at a tiny
size, the harness driven whole but for its look for a card."""
import pytest
import torch

from .conftest import run_tiny, tiny


def _preview_faults():
    """Faults of the progressive loop's batch (``render_sample_batch``):
    its answer altered (red and blue swapped), half of the batch left out
    (half the samples, the sum scaled from the rest; at one sample a pixel,
    every other row left black), a step that returns its state unchanged
    (every update the first update's colour)."""
    def swap(orig):
        def f(*a, **k):
            c, al, n, s = orig(*a, **k)
            return c[..., [2, 1, 0]], al, n, s
        return f

    def half(orig):
        def f(*a, **k):
            n = k["n_samples"]
            if n > 1:
                c, al, nm, s = orig(*a, **{**k, "n_samples": n // 2})
                return c * (n / (n // 2)), al, nm, s
            c, al, nm, s = orig(*a, **k)
            c = c.clone()
            c[1::2] = 0.0
            return c, al, nm, s
        return f

    def stale(orig):
        first = []

        def f(*a, **k):
            out = orig(*a, **k)
            if not first:
                first.append(out)
            return first[0]
        return f

    return {"swap": swap, "half": half, "stale": stale}


@pytest.mark.parametrize("fault", ("swap", "half", "stale"))
@pytest.mark.parametrize("cell", ("kitchen_preview",))
def test_preview_fault_is_caught(cell, fault, monkeypatch):
    from solstrale_tpu_torch.renderer import integrator

    monkeypatch.setattr(integrator, "render_sample_batch", _preview_faults()[
        fault](integrator.render_sample_batch))
    run = run_tiny(cell, seconds=1.5, check_updates=4)
    assert run.attempted >= 2
    assert not run.correct, run.checks


def _inverse_fault(name, monkeypatch):
    """Faults of the inverse step: a step that returns its state unchanged
    (a zero gradient), half of the batch left out (the loss's mean over
    the even pixels), the rendered image altered (red and blue swapped),
    each gradient sent to the wrong texel (the arena's order mirrored)."""
    from solstrale_tpu_torch import diff

    if name in ("unchanged", "mirror"):
        orig = diff.image_and_texture_grad

        def bad_grad(*a, **k):
            loss, grad = orig(*a, **k)
            return loss, (torch.zeros_like(grad) if name == "unchanged"
                          else grad.flip(0))
        monkeypatch.setattr(diff, "image_and_texture_grad", bad_grad)
    elif name == "half":
        def run_half(self):
            with torch.enable_grad():
                img = diff.render_linear(self.cs, n_samples=self.n_samples,
                                         **self.kw)
                tgt = self.target.reshape(-1, 3)
                loss = torch.mean((img[::2] - tgt[::2]) ** 2)
                grad, = torch.autograd.grad(loss, self.arena)
            with torch.no_grad():
                self.loss.copy_(loss)
                self.grad.copy_(grad)
        monkeypatch.setattr(diff._GradStep, "run", run_half)
    else:
        orig = diff.render_linear

        def swapped(*a, **k):
            return orig(*a, **k)[:, [2, 1, 0]]
        monkeypatch.setattr(diff, "render_linear", swapped)


@pytest.mark.parametrize("fault", ("unchanged", "half", "swap", "mirror"))
def test_inverse_fault_is_caught(fault, monkeypatch):
    _inverse_fault(fault, monkeypatch)
    run = run_tiny("kitchen_inverse", seconds=0.5)
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", ("kitchen_preview", "kitchen_inverse"))
def test_control_and_planted_faults_fail_the_limits(cell):
    """The readings the limits are set against, at the tiny size: each of
    the control's and the planted faults' readings fails one of the cell's
    numbers."""
    import argparse

    from perfbench import control, harness
    from perfbench.drivers import common

    torch.set_num_threads(2)
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 5, seconds=0,
                              trace=0)
    readings = control.readings(args, "cpu", tiny(cell))
    lim = common.limits(harness.make_run(args, "cpu", tiny(cell)))
    for kind, numbers in readings.items():
        assert any(v > lim[k] for k, v in numbers.items()), (kind, numbers)
