"""The on-device LBVH build on the card against the same build on the CPU
and the host build, exactly; and an OBJ scene compiled with it. Marked
``cuda``: they skip where no GPU is present. On a GPU machine (no JAX
needed), from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_bvh_build_cuda.py -q
"""
import numpy as np
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import accel, fixtures
from solstrale_tpu_torch.scene.compile import compile_scene

pytestmark = pytest.mark.cuda

FIELDS = ("node_min", "node_max", "lp_kind", "lp_idx")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_bvh_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        x = x.cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(x)
        y = y.cpu() if isinstance(y, torch.Tensor) else torch.from_numpy(y)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("n_cells", [40, 224])
def test_device_build_on_card_equals_cpu_and_host(cuda, n_cells):
    """3,200 triangles (host build: numpy) and 100,352 (host build: the
    native sort): the card's build equals the CPU's and the host's."""
    cs = compile_scene(fixtures.sponza_class_scene(
        T.RenderConfig(width=8, height=8), n_cells=n_cells), use_bvh=True,
        device="cpu")
    kinds, idxs, mins, maxs = accel.solids_aabbs(cs.solids)
    args = [torch.from_numpy(a) for a in (mins.astype(np.float32),
                                          maxs.astype(np.float32), kinds,
                                          idxs)]
    on_card = accel.build_bvh_device(*(a.to(cuda) for a in args))
    assert on_card.node_min.device.type == "cuda"
    _assert_bvh_equal(on_card, accel.build_bvh_device(*args))
    _assert_bvh_equal(on_card, cs.bvh)


def test_compile_obj_scene_device_bvh_on_card(cuda, tmp_path):
    fixtures.write_obj_scene(str(tmp_path), n_cells=32)
    scene = fixtures.obj_scene(T.RenderConfig(width=8, height=8),
                               str(tmp_path))
    dev = compile_scene(scene, use_bvh="device", device=cuda)
    host = compile_scene(scene, use_bvh=True, device=cuda)
    assert dev.bvh.node_min.device.type == "cuda"
    _assert_bvh_equal(dev.bvh, host.bvh)
    for k in ("nodes", "prims", "node_min", "node_max"):
        assert torch.equal(getattr(dev.kbvh, k), getattr(host.kbvh, k))
