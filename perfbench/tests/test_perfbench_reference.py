"""The plain reference and the frozen scenes against the program on the
CPU at a tiny size: the scenes equal the program's fixtures, the
reference's compile equals the program's tables, and its paths give the
program's plain render bit for bit. These tests import the program; the
reference does not."""
import dataclasses

import pytest
import torch

# the benchmark's kitchen, and the port's fixture of it with a normal map
# on the ground (built through either package), for the reference's
# normal-map path
SCENES = {
    "kitchen_sink": (dict(tex_size=16), 20, 14),
    "kitchen_sink_mapped": (dict(tex_size=16, normal_map=True), 20, 14),
}


def _tables(cs):
    out = {}

    def walk(path, x):
        if isinstance(x, torch.Tensor):
            out[path] = x
        elif isinstance(x, tuple):
            for i, v in enumerate(x):
                walk(f"{path}.{i}", v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                if f.name not in ("bvh", "kbvh"):
                    walk(f"{path}.{f.name}", getattr(x, f.name))

    walk("cs", cs)
    return out


def _both(name):
    import importlib

    import solstrale_tpu_torch as T

    import perfbench.reference as R

    params, w, h = SCENES[name]
    if name == "kitchen_sink":
        build = importlib.import_module("perfbench.scenes.kitchen_sink").build
    else:
        from solstrale_tpu_torch import fixtures

        def build(api, cfg, **kw):
            return fixtures.kitchen_sink_scene(cfg, api=api, **kw)
    return (build(T, T.RenderConfig(width=w, height=h), **params),
            build(R, R.RenderConfig(w, h), **params), w, h)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_reference_compiles_the_programs_tables(name):
    from solstrale_tpu_torch.scene.compile import compile_scene

    from perfbench.reference.scene.compile import compile_scene as ref_compile

    prog, ref, _, _ = _both(name)
    a = _tables(compile_scene(prog, device="cpu", use_bvh=False))
    b = _tables(ref_compile(ref, device="cpu"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_reference_paths_equal_the_programs_plain_render(name):
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    from perfbench.reference import integrator as ref
    from perfbench.reference.scene.compile import compile_scene as ref_compile

    torch.set_num_threads(2)
    prog, rscene, w, h = _both(name)
    cs = compile_scene(prog, device="cpu")
    color, _, _, _ = integrator.render_sample_batch(
        cs, 5, 2 ** 31 - 3, width=w, height=h, max_depth=50, shader_kind=0,
        need_aux=False, n_samples=2)
    rcs = ref_compile(rscene, device="cpu")
    pix = torch.arange(w * h)
    total = sum(ref.trace_paths(rcs, pix, torch.full_like(pix, s),
                                2 ** 31 - 3, width=w, height=h, max_depth=50)
                for s in (5, 6))
    assert torch.equal(color, torch.flip(total.reshape(h, w, 3), (0,)))


@pytest.mark.parametrize("tex_size", (16, 64))
def test_frozen_scene_equals_the_fixture(tex_size):
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.scene.compile import compile_scene

    from perfbench.scenes import kitchen_sink

    cfg = T.RenderConfig(width=20, height=14)
    a = _tables(compile_scene(kitchen_sink.build(T, cfg, tex_size=tex_size),
                              device="cpu", use_bvh=False))
    b = _tables(compile_scene(fixtures.kitchen_sink_scene(
        cfg, normal_map=False, tex_size=tex_size), device="cpu",
        use_bvh=False))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_quantized_control_differs():
    """The bfloat16 control changes the tables and the paths."""
    from perfbench.reference import integrator as ref
    from perfbench.reference.scene.compile import compile_scene as ref_compile

    _, rscene, w, h = _both("kitchen_sink")
    rcs = ref_compile(rscene, device="cpu")
    q = ref.quantized(rcs, torch.bfloat16)
    assert not torch.equal(q.solids.pl_n, rcs.solids.pl_n)
    pix = torch.arange(w * h)
    s = torch.ones_like(pix)
    a = ref.trace_paths(rcs, pix, s, 9, width=w, height=h, max_depth=50)
    b = ref.trace_paths(q, pix, s, 9, width=w, height=h, max_depth=50,
                        quantize=torch.bfloat16)
    assert not torch.equal(a, b)
