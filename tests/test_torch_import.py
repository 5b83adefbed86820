"""The port stands alone: with JAX made unimportable, importing
solstrale_tpu_torch and its modules (diff, parallel, the denoiser trainer,
the OBJ loader, the native library's bindings and the throughput script
among them), building a scene, loading an OBJ, building a BVH on the
device, rendering, measuring a bench workload and taking a texture
gradient on the CPU works (``models`` exporting ``DenoiserCNN`` and
``denoise_bilateral`` as the JAX package's does), and none of it builds or
loads a CUDA kernel or imports the JAX package's test fixtures."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import _build
from solstrale_tpu_torch.renderer import integrator
from solstrale_tpu_torch.scene.compile import compile_scene
from solstrale_tpu_torch import diff, parallel
from solstrale_tpu_torch.models import train_denoiser
from solstrale_tpu_torch.models import DenoiserCNN, denoise_bilateral
from solstrale_tpu_torch.models import denoiser
assert (DenoiserCNN, denoise_bilateral) == (denoiser.DenoiserCNN,
                                            denoiser.denoise_bilateral)
from solstrale_tpu_torch.ops import detached
from solstrale_tpu_torch.parallel import distributed
from solstrale_tpu_torch import native
from solstrale_tpu_torch.scene import loader
from solstrale_tpu_torch import bench
import contextlib, dataclasses, io, tempfile

assert _build.library.cache_info().currsize == 0
cs = compile_scene(fixtures.small_scene(T.RenderConfig(width=8, height=8)),
                   device="cpu")
img, _, _, segs = integrator.render_sample_batch(
    cs, 1, 1, width=8, height=8, max_depth=50, shader_kind=0,
    need_aux=False, n_samples=1)
assert img.shape == (8, 8, 3) and float(img.sum()) > 0 and int(segs) >= 64
loss, grad = diff.image_and_texture_grad(
    cs, img.reshape(-1, 3) * 0.5, width=8, height=8, max_depth=3,
    n_samples=1, seed=1)
assert float(loss) > 0 and bool(grad.isfinite().all())
assert distributed.initialize() == (1, 0)
with tempfile.TemporaryDirectory() as d:
    fixtures.write_obj_scene(d, n_cells=4)
    obj = compile_scene(fixtures.obj_scene(T.RenderConfig(width=8, height=8),
                                           d), use_bvh="device", device="cpu")
assert int(obj.solids.tr_valid.sum()) == 32 and obj.bvh is not None
tiny = dataclasses.replace(
    bench.WORKLOADS[-1], width=8, height=8,
    scene=lambda c: fixtures.sponza_production_scene(c, n_cells=16,
                                                     tex_size=16))
with contextlib.redirect_stdout(io.StringIO()):
    lines = bench.run([tiny], "cpu", runs=1)
assert "error" not in lines[0] and lines[0]["value"] > 0
assert "scenes" not in sys.modules
assert _build.library.cache_info().currsize == 0   # no kernel was loaded
assert not any(m == "jax" or m.startswith(("jax.", "solstrale_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", int(segs))
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_source_has_no_jax_import():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package."""
    bad = []
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "solstrale_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1 and \
                        (words[1].split(".")[0] in ("jax", "solstrale_tpu")):
                    bad.append(f"{path}:{n}: {line.strip()}")
    assert not bad, bad
    scanned = {os.path.relpath(p, ROOT) for p in paths}
    assert {"solstrale_tpu_torch/native/__init__.py",
            "solstrale_tpu_torch/scene/loader.py",
            "solstrale_tpu_torch/bench.py"} <= scanned
