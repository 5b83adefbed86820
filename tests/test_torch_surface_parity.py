"""The port's public surface covers the JAX package's. Every module of
``solstrale_tpu`` (``pkgutil.walk_packages``) has a counterpart module of
the same path in ``solstrale_tpu_torch``, and each public name the module
defines (a top-level function, class or assigned constant, outside a
``__main__`` block) or a package ``__init__`` exports (its ``__all__`` and
its ``from .x import`` names) is there too. The exceptions are listed here
with their reasons: ``RENAMED`` (the counterpart has another name or
module) and ``DO_NOT_PORT`` (TPU workarounds and AoS helpers the port
leaves behind). ROADMAP.md's "Do not port" list names the same set, each
entry as a dotted ``module.name`` in backticks; the last test holds the two
to each other."""
import ast
import importlib
import inspect
import os
import pkgutil
import re

import pytest

import solstrale_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX module or name -> the port's counterpart, with the reason
RENAMED = {
    "ops.pallas_bvh": ("ops.bvh", "K1's module: the hand kernel and its "
                       "plain version replace the Pallas kernel"),
    "ops.pallas_sweep": ("ops.sweep", "K2-K4's module: the hand kernels and "
                         "their plain versions replace the Pallas kernels"),
    "ops.intersect.closest_solid_hit": (
        "ops.sweep.closest_hit_plain", "the XLA brute-force hit; the plain "
        "sweep computes the same function"),
    "ops.intersect.medium_hit": (
        "ops.sweep.medium_hit_plain", "the XLA free flight; the plain "
        "medium sweep computes the same function"),
    "ops.pallas_bvh.bvh_planar_hit_pallas": (
        "ops.bvh.bvh_planar_hit", "K1's wrapper"),
    "ops.pallas_bvh.bvh_closest_hit_pallas": (
        "ops.bvh.bvh_closest_hit", "K1 min-combined with the sphere sweep "
        "(K2)"),
    "ops.pallas_bvh.TOP_LEVELS": (
        "accel.TOP_LEVELS", "survives only as the treelet size that fixes "
        "the kernel BVH's leaf order"),
    "ops.pallas_sweep.closest_hit_pallas": (
        "ops.sweep.closest_hit_plain", "the same (t, slot) sweep; on the "
        "card its spheres-only mode is K2, fused with the BVH min-combine"),
    "ops.pallas_sweep.closest_solid_hit_pallas": (
        "ops.sweep.closest_hit_plain", "the (t, kind, idx) decode of "
        "closest_hit_pallas; the port decodes in bvh_closest_hit and K4"),
    "ops.pallas_sweep.medium_hit_pallas": (
        "ops.sweep.media_hit", "K3: every medium in one launch"),
    "ops.pallas_sweep.scene_hit_pallas": (
        "ops.sweep.scene_hit", "K4's wrapper"),
    "ops.pallas_sweep.scene_hit_fused": (
        "ops.sweep.scene_hit", "K4 with its draws and decode in the launch"),
}

_AOS = "an AoS helper of the AoS hit_attributes and JAX's tests; the " \
       "port's path uses the SoA forms"
_TPU_SIZE = "a Pallas block, SMEM or VMEM size of the TPU kernel"
DO_NOT_PORT = {
    "accel.bvh_closest_hit": "JAX's CPU traversal; the port's CPU route is "
                             "K1's plain version",
    **{f"geo.{n}": _AOS for n in (
        "dot", "cross", "length_squared", "length", "unit", "reflect",
        "refract", "near_zero", "onb_from_w", "onb_local", "ray_at")},
    **{f"geo.soa.{n}": _AOS for n in ("from_aos", "to_aos", "splat",
                                      "vmul")},
    **{f"ops.rng.{n}": _AOS for n in (
        "cosine_direction", "unit_vector", "in_unit_sphere", "in_unit_disc",
        "to_sphere")},
    "ops.intersect.hit_attributes": "AoS; only tests and tools call it",
    "ops.intersect.sample_light_direction": "AoS; only tests and tools "
                                            "call it",
    "ops.intersect.onehot_matmul": "an MXU gather workaround; the port "
                                   "indexes directly",
    "ops.intersect.onehot_matmul_t": "an MXU gather workaround",
    "ops.intersect.CHUNK": "the TPU sweep's primitive chunk",
    "ops.intersect.ONEHOT_MAX_ROWS": "the MXU one-hot lookup's table limit",
    **{f"ops.pallas_bvh.{n}": _TPU_SIZE for n in (
        "BLOCK", "FB", "DB", "FQ", "TL_CAP", "WIN", "N_WIN")},
    "ops.pallas_sweep.BLOCK": _TPU_SIZE,
    "renderer.integrator.trace_regenerative": "nothing calls it",
    "renderer.integrator.bounce_step": "the port's trace and trace_queued "
                                       "are built on path_step",
    "renderer.megakernel.TILE": "the TPU kernel's (8, 128) tile",
    "renderer.megakernel.ARENA_SMEM_BYTES": "the u8 SMEM texture arena's "
                                            "size",
    "native.load": "JAX's fallback to the plain parse; the port's native "
                   "build raises",
}

# a shared library beside the JAX package's bindings, not a Python module
NOT_MODULES = {"native.libsolstrale_native"}


def _modules():
    mods = [("", True)]
    for info in pkgutil.walk_packages(solstrale_tpu.__path__,
                                      "solstrale_tpu."):
        rel = info.name[len("solstrale_tpu."):]
        if rel not in NOT_MODULES:
            mods.append((rel, info.ispkg))
    return mods


def _full(rel):
    return "solstrale_tpu" + (f".{rel}" if rel else "")


def _top_level(body):
    """Top-level statements, into if/try blocks but not ``__main__``'s."""
    for node in body:
        if isinstance(node, ast.If):
            if "__main__" in ast.unparse(node.test):
                continue
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            for block in (node.body, node.orelse, node.finalbody,
                          *(h.body for h in node.handlers)):
                yield from _top_level(block)
        else:
            yield node


def public_names(rel, ispkg):
    """The public names module ``rel`` of the JAX package defines, and for a
    package the names its ``__init__`` exports."""
    mod = importlib.import_module(_full(rel))
    names = set(getattr(mod, "__all__", ()))
    for node in _top_level(ast.parse(inspect.getsource(mod)).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif ispkg and isinstance(node, ast.ImportFrom) and node.level == 1:
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _port(path):
    """The port's module, or attribute at a dotted path."""
    try:
        return importlib.import_module("solstrale_tpu_torch" +
                                       (f".{path}" if path else ""))
    except ModuleNotFoundError:
        mod, _, name = path.rpartition(".")
        return getattr(_port(mod), name)


def _counterpart(rel):
    return RENAMED[rel][0] if rel in RENAMED else rel


@pytest.mark.parametrize("rel,ispkg", _modules(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_module_has_every_public_name(rel, ispkg):
    port = _port(_counterpart(rel))
    missing = []
    for name in sorted(public_names(rel, ispkg)):
        key = f"{rel}.{name}" if rel else name
        if key in DO_NOT_PORT:
            continue
        if key in RENAMED:
            _port(RENAMED[key][0])       # the counterpart exists
        elif not hasattr(port, name):
            missing.append(key)
    assert not missing, f"no counterpart in the port: {missing}"


def test_exceptions_are_current():
    """Every entry names a public name of the JAX package; a DO_NOT_PORT
    name has no counterpart of the same name, and every reason is given."""
    names = {f"{rel}.{n}" if rel else n for rel, ispkg in _modules()
             for n in public_names(rel, ispkg)}
    modules = {rel for rel, _ in _modules()}
    for key, (target, reason) in RENAMED.items():
        assert key in names or key in modules, key
        assert _port(target) is not None and reason, key
    for key, reason in DO_NOT_PORT.items():
        assert key in names and reason, key
        mod, _, name = key.rpartition(".")
        assert not hasattr(_port(_counterpart(mod)), name), \
            f"{key} is ported: take it off the list"


def _roadmap_do_not_port():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    start = text.index("**Do not port.**")
    end = text.index("\n### ", start)
    return set(re.findall(r"`([A-Za-z_][\w.]*)`", text[start:end]))


def test_do_not_port_is_the_roadmap_list():
    """ROADMAP.md's "Do not port" list names each DO_NOT_PORT entry as a
    dotted ``module.name``, and every dotted name it gives that is a public
    name of the JAX package is in DO_NOT_PORT."""
    listed = _roadmap_do_not_port()
    assert set(DO_NOT_PORT) <= listed, sorted(set(DO_NOT_PORT) - listed)
    public = {}
    for rel, ispkg in _modules():
        for n in public_names(rel, ispkg):
            public[f"{rel}.{n}" if rel else n] = True
    extra = {t for t in listed if t in public and t not in DO_NOT_PORT}
    assert not extra, sorted(extra)
