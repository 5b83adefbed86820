"""OBJ + MTL ingest: the port's ``Obj`` loader on the files
``fixtures.write_obj_scene`` writes (a quad face, negative indices, faces
before any usemtl, a Kd colour, a PNG albedo, a normal map and a height
map) against the JAX package's loader on the same files; its native parser
against the plain Python one on every triangle; its error paths with the
JAX package's messages; and a small render of the loaded scene against the
JAX package's."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu.native as jnative
import solstrale_tpu_torch as T
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.scene import loader as jloader
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures, native
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene import TriangleMesh, loader
from solstrale_tpu_torch.scene.compile import compile_scene, tables_of
from solstrale_tpu_torch.scene.textures import load_bump_map
from solstrale_tpu_torch.utils import height_to_normal_map

from test_torch_scene import assert_tables_equal

torch.set_num_threads(2)

N_CELLS = 8
W, H, SPP, SEED = 64, 48, 2, 1


@pytest.fixture(scope="module")
def objdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("obj")
    fixtures.write_obj_scene(str(d), n_cells=N_CELLS)
    return str(d)


def _prefix(d):
    return os.path.join(d, "")


def _copy(objdir, tmp_path):
    d = tmp_path / "copy"
    shutil.copytree(objdir, d)
    return d


def _load_error(api_loader, d):
    with pytest.raises(Exception) as err:
        api_loader.Obj(_prefix(str(d)), fixtures.OBJ_FILE).load(
            T.NopTransformer())
    return err


@pytest.mark.parametrize("case", ["obj", "mtl", "image", "undecodable"])
def test_error_paths_match_jax(objdir, tmp_path, case):
    d = _copy(objdir, tmp_path)
    if case == "obj":
        os.remove(d / fixtures.OBJ_FILE)
    elif case == "mtl":
        os.remove(d / fixtures.MTL_FILE)
    elif case == "image":
        os.remove(d / "albedo.png")
    else:
        (d / "normal.png").write_bytes(b"not a png")
    want = {"obj": (FileNotFoundError, "failed to load obj model from "
                    f"{d}/{fixtures.OBJ_FILE}"),
            "mtl": (FileNotFoundError, "failed to load MTL file for "
                    f"{d}/{fixtures.OBJ_FILE}"),
            "image": (FileNotFoundError, "Failed to open image texture "
                      f"{d}/albedo.png"),
            "undecodable": (ValueError, "Failed to decode bump texture "
                            f"{d}/normal.png")}[case]
    got = _load_error(loader, d)
    ref = _load_error(jloader, d)
    assert got.type is want[0] and str(got.value).startswith(want[1])
    assert got.type is ref.type and str(got.value) == str(ref.value)


def test_structure(objdir):
    """2*N_CELLS^2 triangles after the quad's fan triangulation; one
    TriangleMesh per used material, the default first (the faces before
    any usemtl); the normal map kept as written, the grey height map
    detected and converted."""
    default = T.Lambertian(T.SolidColor(0.1, 0.2, 0.3))
    world = loader.Obj(_prefix(objdir), fixtures.OBJ_FILE).load(
        T.NopTransformer(), default)
    meshes = world.children
    assert all(isinstance(m, TriangleMesh) for m in meshes)
    assert len(meshes) == 1 + len(fixtures.OBJ_GROUPS)
    assert sum(len(m) for m in meshes) == 2 * N_CELLS ** 2
    assert [len(m) for m in meshes] == [32, 32, 32, 32]
    assert meshes[0].material is default
    assert meshes[0].uvs[0].tolist() == [[0.0, 0.0]] * 3   # the quad: no vt
    colour, textured, bumpy = (m.material for m in meshes[1:])
    np.testing.assert_allclose(colour.albedo.rgb, [0.73, 0.73, 0.73])
    assert colour.normal is None
    albedo, height = fixtures.procedural_textures()
    np.testing.assert_array_equal(textured.albedo.image, albedo)
    normal = os.path.join(objdir, "normal.png")
    height_png = os.path.join(objdir, "height.png")
    assert load_bump_map(normal)[0] == "normal"
    assert load_bump_map(height_png)[0] == "height"
    np.testing.assert_array_equal(textured.normal.image,
                                  height_to_normal_map(height))
    np.testing.assert_array_equal(bumpy.normal.image,
                                  height_to_normal_map(height))
    np.testing.assert_allclose(bumpy.albedo.rgb, [0.6, 0.5, 0.4])


def test_native_parse_equals_plain_on_every_triangle(objdir):
    path = os.path.join(objdir, fixtures.OBJ_FILE)
    got = native.parse_obj(path)
    want = loader.parse_obj_arrays(path)
    assert got[0].shape == (2 * N_CELLS ** 2, 3, 3)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    names_g = np.array(["-"] + got[3])[got[2] + 1]
    names_w = np.array(["-"] + want[3])[want[2] + 1]
    np.testing.assert_array_equal(names_g, names_w)
    assert got[3] == list(fixtures.OBJ_GROUPS)
    assert got[4:] == want[4:] == ([fixtures.MTL_FILE], True)
    # the same parse as the JAX package's native library, too
    jgot = jnative.parse_obj(path)
    for g, w in zip(got, jgot):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _both(objdir, use_bvh=True):
    assert jnative.load() is not None   # the JAX side takes its native route
    cfg = dict(width=W, height=H, samples_per_pixel=SPP, seed=SEED,
               samples_per_batch=SPP)
    cj = jcompile(fixtures.obj_scene(J.RenderConfig(**cfg), objdir, api=J),
                  use_bvh=use_bvh)
    ct = compile_scene(fixtures.obj_scene(T.RenderConfig(**cfg), objdir),
                       use_bvh=use_bvh, device="cpu")
    return cj, ct


def test_compiled_tables_equal_jax(objdir):
    """The same files loaded by both packages and compiled on the CPU with
    the BVH: every table equal, tolerance 0."""
    cj, ct = _both(objdir)
    assert ct.bvh is not None and ct.kbvh is not None
    assert {"image_tex", "normal_maps"} <= set(ct.features)
    assert_tables_equal(tables_of(cj), tables_of(ct))


def test_render_matches_jax(objdir, monkeypatch):
    """64x48, 2 spp: the port's render of the loaded scene against the JAX
    package's (its Pallas kernels interpreted, SOLSTRALE_PALLAS=1, as for
    the textured kitchen in test_torch_render.py), same tolerance."""
    monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    cj, ct = _both(objdir, use_bvh=None)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=0,
              need_aux=False, n_samples=SPP)
    img_j, _, _, seg_j = JI.render_sample_batch(cj, jnp.int32(1),
                                                jnp.int32(SEED), **kw)
    img_t, _, _, seg_t = TI.render_sample_batch(ct, 1, SEED, **kw)
    assert img_t.shape == (H, W, 3) and float(img_t.mean()) > 0.1
    assert int(seg_t) == int(seg_j)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4,
                               atol=1e-4)
