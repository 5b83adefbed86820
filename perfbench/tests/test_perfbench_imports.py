"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference and the yardstick import nothing of the program. Module names are
compared by their top-level name whole: ``solstrale_tpu_torch`` is the
program, not the JAX package ``solstrale_tpu``."""
import ast
import subprocess
import sys

import pytest

from .conftest import ROOT

BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "solstrale_tpu"}


def imported_tops(path):
    """Top-level names of every absolute import in a source file."""
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN, path


YARDSTICK = sorted(p for d in ("reference", "roofline", "scenes")
                   for p in (BENCH / d).rglob("*.py"))


@pytest.mark.parametrize("path", YARDSTICK,
                         ids=[str(p.relative_to(BENCH)) for p in YARDSTICK])
def test_yardstick_imports_nothing_of_the_program(path):
    assert "solstrale_tpu_torch" not in imported_tops(path), path


def test_yardstick_loads_nothing_of_the_program():
    """Importing the reference, the yardstick and the scenes, and running
    the reference, loads no module of the program."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "import perfbench.reference as R\n"
        "from perfbench.reference import integrator\n"
        "from perfbench.reference.scene.compile import compile_scene\n"
        "import perfbench.roofline\n"
        "from perfbench.scenes import kitchen_sink\n"
        "cs = compile_scene(kitchen_sink.build(R, R.RenderConfig(8, 6), "
        "tex_size=8))\n"
        "pix = torch.arange(48)\n"
        "integrator.trace_paths(cs, pix, pix * 0 + 1, 3, width=8, height=6, "
        "max_depth=50)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'solstrale_tpu_torch', 'solstrale_tpu', 'jax'}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_whole_name_comparison():
    from perfbench import harness

    sys.modules.setdefault("solstrale_tpu_torch_probe_x", sys)
    try:
        assert "solstrale_tpu" not in harness.forbidden_loaded()
    finally:
        del sys.modules["solstrale_tpu_torch_probe_x"]


def test_a_run_loads_no_jax():
    """A run of a cell on the CPU, in a process of its own, holds no JAX
    module and no module of the JAX package once its window has closed."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import run_tiny\n"
        "from perfbench import harness\n"
        "run = run_tiny('kitchen_preview', seconds=0.5)\n"
        "print(harness.forbidden_loaded(), run.correct)\n"
        % (str(ROOT), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True", out.stdout
