"""The four-card check (``solstrale_tpu_torch.parallel.four_card``) on its
CPU twin: the same rank functions on four gloo ranks at small sizes, each
route on the 4x1 and the 2x2 mesh held to a one-rank group, with the
tolerances the card is held to: ``render_batch_sharded`` within rtol 1e-6,
atol 1e-6 of ``render_sample_batch`` with the segments exactly equal,
``render_sample_sharded`` and ``render_distributed`` bit for bit,
``train_step_sharded``'s loss within rtol 1e-5 and its gradient within rtol
1e-4, atol 1e-7, every rank's new arena the same bits. The launcher gets
back CPU values only, and on the card the check raises without four
cards.
"""
import numpy as np
import pytest
import torch

from solstrale_tpu_torch.parallel import distributed as PD
from solstrale_tpu_torch.parallel import four_card as F

torch.set_num_threads(2)

SZ = F.SIZES["cpu"]
MESHES = {"4x1": 1, "2x2": 2}      # mesh -> sample ranks
LR = F.LR


@pytest.fixture(scope="module")
def runs():
    ref, ranks, _ = F.collect("cpu")
    return ref, ranks


def _meta_result():
    """A rank result that holds a tensor off the CPU."""
    return {"image": torch.empty((2, 3), device="meta")}


def test_ranks_in_rank_order_on_gloo(runs):
    ref, ranks = runs
    assert ref["device"] == dict(rank=0, backend="gloo")
    assert [r["device"] for r in ranks] == [
        dict(rank=i, backend="gloo") for i in range(4)]


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_sharded_held_to_one_rank(runs, mesh):
    """The image within rtol 1e-6, atol 1e-6 of the one-rank
    render_sample_batch (rank 0 sends it, every rank the same digest), the
    segments exactly equal on every rank."""
    ref, ranks = runs
    got = [r["meshes"][mesh]["batch"] for r in ranks]
    torch.testing.assert_close(got[0]["image"], ref["batch_image"],
                               rtol=1e-6, atol=1e-6)
    assert all(g["image"] is None for g in got[1:])
    assert len({g["digest"] for g in got}) == 1
    assert [g["segments"] for g in got] == [ref["batch_segments"]] * 4
    one = ref["routes"]["batch"]
    assert torch.equal(one["image"], ref["batch_image"])
    assert one["segments"] == ref["batch_segments"]


@pytest.mark.parametrize("mesh", MESHES)
def test_per_tile_segments_sum_to_one_rank_total(runs, mesh):
    ref, ranks = runs
    n_tile = 4 // MESHES[mesh]
    for r in ranks:
        tiles = r["meshes"][mesh]["batch"]["per_tile"]
        assert len(tiles) == n_tile and min(tiles) > 0
        assert sum(tiles) == ref["batch_segments"]
    assert ref["routes"]["batch"]["per_tile"] == [ref["batch_segments"]]


@pytest.mark.parametrize("shader", ["path", "simple"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sample_sharded_bit_equal(runs, mesh, shader):
    """4x1: render_sample at sample 1; 2x2: samples 1 and 2 summed; every
    plane bit for bit, every rank the same digests."""
    ref, ranks = runs
    s1, s2 = ref["sample"][shader]
    want = s1 if MESHES[mesh] == 1 else [a + b for a, b in zip(s1, s2)]
    got = [r["meshes"][mesh]["sample"][shader] for r in ranks]
    for g, w in zip(got[0]["planes"], want):
        assert torch.equal(g, w)
    assert all(g["digests"] == got[0]["digests"] for g in got)
    if shader == "simple":
        assert all(float(p.abs().sum()) > 0 for p in got[0]["planes"])


@pytest.mark.parametrize("mesh", MESHES)
def test_distributed_equal_to_one_rank(runs, mesh):
    ref, ranks = runs
    got = [r["meshes"][mesh]["distributed"] for r in ranks]
    want = ref["routes"]["distributed"]
    np.testing.assert_array_equal(got[0]["image"], want["image"])
    assert want["passes"] == SZ.distributed[2]
    assert got[0]["passes"] == want["passes"] // MESHES[mesh]
    assert all(g["image"] is None for g in got[1:])


@pytest.mark.parametrize("scene", ["mixed", "kitchen"])
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_sharded_held_to_one_rank(runs, mesh, scene):
    """Loss within rtol 1e-5 and gradient (old - new) / lr within rtol 1e-4,
    atol 1e-7 of the one-rank shard steps over the whole image (sample 1;
    samples 1 and 2 summed); every rank's new arena rank 0's bits."""
    ref, ranks = runs
    n = MESHES[mesh]
    w, h = SZ.mixed if scene == "mixed" else SZ.kitchen
    shard = ref["shard_steps"][scene]
    denom = w * h * 3 * n
    got = [r["meshes"][mesh][scene] for r in ranks]
    np.testing.assert_allclose(got[0]["loss"], sum(shard["errs"][:n]) / denom,
                               rtol=1e-5)
    grad = (shard["arena"] - got[0]["arena"]) / LR
    want = sum(shard["grads"][:n]) / denom
    torch.testing.assert_close(grad, want, rtol=1e-4, atol=1e-7)
    assert float(want.abs().max()) > 1e-3
    assert all(torch.equal(g["arena"], got[0]["arena"]) for g in got)
    assert len({g["loss"] for g in got}) == 1


def test_launcher_gets_back_host_values_only(runs):
    """Every result the launcher got holds CPU tensors, numpy and numbers
    alone, as the launch checks in each rank."""
    ref, ranks = runs
    found = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            found.append(x.device.type)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            assert x is None or isinstance(x, (int, float, str, bool,
                                                np.ndarray)), type(x)

    walk([ref, ranks])
    assert found and set(found) == {"cpu"}
    PD.host_only([ref, ranks])


def test_rank_returning_a_device_tensor_raises():
    """A rank whose result holds a tensor off the CPU (here on the meta
    device) fails in the rank, and the launch reports it."""
    with pytest.raises(RuntimeError, match=r"rank 0: TypeError: .*meta"):
        PD.launch(_meta_result, 1, device_type="cpu", timeout=120.0)


def test_cuda_raises_without_four_cards():
    """On the card the check needs four cards: with fewer it raises before
    any rank starts, and the launch refuses NCCL ranks without a card."""
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards are visible: the check would run")
    with pytest.raises(RuntimeError, match="4 cards needed"):
        F.run("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            PD.launch(_meta_result, 4, device_type="cuda")


def test_report_every_check_ok_and_host_clocks_only(runs):
    """The launcher's report: every check ok; the measurements at one
    rank, 4x1 and 2x2 with the tiles' imbalance and the scaling efficiency,
    and on the CPU no device number (no profile, no step by CUDA events)."""
    ref, ranks = runs
    lines = F.report(ref, ranks, "cpu")
    checks = {x["four_card"]: x["ok"] for x in lines if "ok" in x}
    assert len(checks) == 14 and all(checks.values()), checks
    by = {x["four_card"]: x for x in lines}
    for key in ("1", "4x1", "2x2"):
        rate = by[f"batch_rate_{key}"]
        assert rate["segments"] == ref["batch_segments"]
        assert rate["imbalance"] >= 1.0 and rate["mrays_per_s"] > 0
        assert by[f"path_pass_{key}"]["profile"] == [None] * rate["ranks"]
        assert f"step_time_{key}" not in by
    assert set(by["scaling_efficiency"]) >= {"4x1", "2x2"}
