"""Asset-free fixture scenes, buildable through either package.

Every scene function takes the API module as ``api`` (default: this
package), so the same code builds one scene through ``solstrale_tpu_torch``
and through the JAX package ``solstrale_tpu`` from the same numpy arrays —
the parity tests compare what the two make of it. Textures are procedural
numpy images made from a seed; nothing is read from disk but the files
``write_obj_scene`` writes.
"""
from __future__ import annotations

import importlib
import os

import numpy as np


def _api(api):
    if api is None:
        import solstrale_tpu_torch as api
    return api


def _submodule(api, name):
    return importlib.import_module(f"{api.__name__}.{name}")


def _terrain_grid(n_cells, seed):
    """The terrain's (n_cells+1, n_cells+1) grid of points (x, y, z) over
    [-10, 10]^2, displaced in y, and of tiled UVs (one texture repeat per
    8x8 cells)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-10.0, 10.0, n_cells + 1)
    zs = np.linspace(-10.0, 10.0, n_cells + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = (np.sin(X * 0.7) * np.cos(Z * 0.9)
         + 0.15 * rng.standard_normal(X.shape))
    UV = np.stack([X / 20.0 * (n_cells / 8.0), Z / 20.0 * (n_cells / 8.0)],
                  -1)
    return np.stack([X, Y, Z], -1), UV


def _cells(P, UV=None):
    """Triangle soup of a grid block: cell (i, j) with corners a = (i, j),
    b = (i+1, j), c = (i+1, j+1), d = (i, j+1) gives triangles abc and
    acd (all abc triangles first); plus the UVs of the same corners when
    ``UV`` is given."""
    a, b, c, d = P[:-1, :-1], P[1:, :-1], P[1:, 1:], P[:-1, 1:]
    verts = np.concatenate(
        [np.stack([a, b, c], axis=2).reshape(-1, 3, 3),
         np.stack([a, c, d], axis=2).reshape(-1, 3, 3)], 0)
    if UV is None:
        return verts, None
    ua, ub, uc, ud = UV[:-1, :-1], UV[1:, :-1], UV[1:, 1:], UV[:-1, 1:]
    uvs = np.concatenate(
        [np.stack([ua, ub, uc], axis=2).reshape(-1, 3, 2),
         np.stack([ua, uc, ud], axis=2).reshape(-1, 3, 2)], 0)
    return verts, uvs


def _terrain(n_cells, seed, with_uvs):
    """Displaced-terrain triangle soup of 2*n_cells^2 triangles (the
    sponza-class fixture's geometry), with the tiled UVs when asked."""
    P, UV = _terrain_grid(n_cells, seed)
    return _cells(P, UV if with_uvs else None)


def _region_mesh(api, P, UV, i0, i1, j0, j1, material):
    """TriangleMesh over the cell block [i0, i1) x [j0, j1) of the grid."""
    verts, uvs = _cells(P[i0:i1 + 1, j0:j1 + 1], UV[i0:i1 + 1, j0:j1 + 1])
    return _submodule(api, "scene").TriangleMesh(verts, material, uvs=uvs)


def _room(api, floor_material, light=15.0):
    """Room shell (floor, back and front walls) and the ceiling quad light
    of the sponza-class fixture."""
    return [
        api.Quad((-12, -3, -12), (24, 0, 0), (0, 0, 24), floor_material),
        api.Quad((-12, -3, -12), (24, 0, 0), (0, 14, 0),
                 api.Lambertian(api.SolidColor(0.6, 0.5, 0.4))),
        api.Quad((-12, -3, 12), (24, 0, 0), (0, 14, 0),
                 api.Lambertian(api.SolidColor(0.4, 0.5, 0.6))),
        api.Quad((-4, 10.5, -4), (8, 0, 0), (0, 0, 8),
                 api.DiffuseLight(light, light, light)),
    ]


def _interior_camera(api):
    # camera inside the room (the far wall is at z=12)
    return api.CameraConfig(vertical_fov_degrees=40.0, aperture_size=0.0,
                            look_from=(0.0, 6.0, 9.0),
                            look_at=(0.0, 0.0, 0.0))


def sponza_class_scene(render_config, n_cells=362, seed=7, api=None):
    """The untextured sponza-class interior: a displaced terrain of
    2*n_cells^2 triangles (262,088 at the default) inside a lit room shell
    of 4 quads — the geometry of the JAX package's
    ``tests/scenes.py::create_sponza_class_scene(textured=False)``, line
    for line."""
    api = _api(api)
    verts, _ = _terrain(n_cells, seed, with_uvs=False)
    terrain = _submodule(api, "scene").TriangleMesh(
        verts, api.Lambertian(api.SolidColor(0.73, 0.73, 0.73)))
    world = [terrain] + _room(
        api, api.Lambertian(api.SolidColor(0.5, 0.5, 0.5)))
    return api.Scene(api.Bvh(world), _interior_camera(api), (0.0, 0.0, 0.0),
                     render_config)


def procedural_textures(size=64, seed=11):
    """(albedo, height) u8 (size, size, 3) images: a tinted checker with
    noise, and a smooth bump field for the normal map."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size]
    checker = ((x // 8 + y // 8) % 2).astype(np.float64)
    base = np.stack([0.25 + 0.6 * checker, 0.35 + 0.4 * checker,
                     0.55 - 0.2 * checker], -1)
    albedo = np.clip(base + 0.05 * rng.standard_normal(base.shape), 0, 1)
    h = 0.5 + 0.25 * np.sin(x * 2 * np.pi / 16) * np.cos(y * 2 * np.pi / 16)
    height = np.repeat(h[..., None], 3, axis=-1)
    return ((albedo * 255).astype(np.uint8),
            (np.clip(height, 0, 1) * 255).astype(np.uint8))


def bench_textures(size=1024, seed=5):
    """Stand-ins for the five image assets the benchmark scenes of the JAX
    package load (``tests/scenes.py``), as procedural (size, size, 3) u8
    images keyed by the asset's name:

    - ``wall_color``: a tinted checker (8 x 8 squares) with noise;
    - ``wall_n``: a tangent-space normal map, ``height_to_normal_map`` of a
      smooth bump field (one bump per 64 x 64 texels, at least one): what
      ``load_normal_texture`` makes of a height image;
    - ``tex``: colour noise, one draw per texel;
    - ``checker``: a black and white checker (8 x 8 squares);
    - ``earth_height``: a smooth grey field with noise (the production
      scene uses it as an albedo).

    The originals' sizes are not known here. 1024 x 1024 is a common
    wall-texture size: the five then hold 15.7 M texels, 62,914,560 bytes
    of f32 in the compiled texture arena, so texel reads miss the cache
    as a real scene's do."""
    from .utils import height_to_normal_map

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    checker = ((np.floor(x * 8) + np.floor(y * 8)) % 2)[..., None]
    tint = np.array([0.25, 0.35, 0.55]) + checker * np.array([0.6, 0.4, -0.2])
    wall = tint + 0.05 * rng.standard_normal(tint.shape)
    n_bumps = max(1, size // 64)
    bumps = 0.5 + 0.25 * np.sin(2 * np.pi * n_bumps * x) * np.cos(
        2 * np.pi * n_bumps * y)
    phase = rng.uniform(0, 2 * np.pi, 3)
    earth = (0.5 + 0.2 * np.sin(2 * np.pi * 3 * x + phase[0])
             * np.cos(2 * np.pi * 2 * y + phase[1])
             + 0.1 * np.sin(2 * np.pi * 7 * (x + y) + phase[2])
             + 0.03 * rng.standard_normal(x.shape))

    def u8(img):
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def grey(img):
        return np.repeat(u8(img)[..., None], 3, axis=-1)

    return {"wall_color": u8(wall),
            "wall_n": height_to_normal_map(grey(bumps)),
            "tex": u8(rng.random((size, size, 3))),
            "checker": np.repeat(u8(checker), 3, axis=-1),
            "earth_height": grey(earth)}


def sponza_textured_scene(render_config, n_cells=362, seed=7, tex_size=1024,
                          api=None):
    """The benchmark's headline interior: ``sponza_class_scene`` with the
    terrain image-textured and normal-mapped (tiled UVs, one texture repeat
    per 8x8 cells) — the JAX package's
    ``tests/scenes.py::create_sponza_class_scene(textured=True)``, line for
    line, with ``bench_textures``' ``wall_color`` and ``wall_n`` for the
    loaded images."""
    api = _api(api)
    images = bench_textures(tex_size)
    verts, uvs = _terrain(n_cells, seed, with_uvs=True)
    terrain = _submodule(api, "scene").TriangleMesh(
        verts, api.Lambertian(api.ImageMap(images["wall_color"]),
                              api.ImageMap(images["wall_n"])), uvs=uvs)
    world = [terrain] + _room(
        api, api.Lambertian(api.SolidColor(0.5, 0.5, 0.5)))
    return api.Scene(api.Bvh(world), _interior_camera(api), (0.0, 0.0, 0.0),
                     render_config)


def sponza_production_scene(render_config, n_cells=360, seed=7,
                            tex_size=1024, api=None):
    """The production-diversity interior: the displaced terrain (2*n_cells^2
    = 259,200 triangles at the default) split into a 4x4 grid of material
    regions covering every material kind (image-textured and solid
    lambertians, some normal-mapped, fuzzy and textured metals,
    dielectrics, blends with a metal and with a dielectric), 5 image
    textures and 4 emitters of all three light shapes — the JAX package's
    ``tests/scenes.py::create_sponza_production_scene``, line for line,
    with ``bench_textures`` for the loaded images."""
    api = _api(api)
    images = bench_textures(tex_size)
    wall_c = api.ImageMap(images["wall_color"])
    wall_n = api.ImageMap(images["wall_n"])
    tex_j = api.ImageMap(images["tex"])
    checker = api.ImageMap(images["checker"])
    earth = api.ImageMap(images["earth_height"])
    L, M, D = api.Lambertian, api.Metal, api.Dielectric
    S = api.SolidColor

    mats = [
        L(wall_c, wall_n),
        L(tex_j),
        L(checker),
        L(S(0.8, 0.3, 0.25)),
        M(S(0.9, 0.8, 0.6), None, 0.1),
        M(checker, None, 0.3),
        D(S(1.0, 1.0, 1.0), None, 1.5),
        api.Blend(L(wall_c), M(S(0.8, 0.8, 0.9), None, 0.05), 0.5),
        L(earth),
        M(S(0.7, 0.7, 0.8), None, 0.05),
        api.Blend(L(checker), D(S(1.0, 1.0, 1.0), None, 1.3), 0.3),
        L(S(0.2, 0.5, 0.8), wall_n),
        M(wall_c, None, 0.2),
        D(S(0.9, 0.95, 1.0), None, 1.1),
        api.Blend(M(tex_j, None, 0.4), L(S(0.6, 0.6, 0.2)), 0.7),
        L(tex_j, wall_n),
    ]
    P, UV = _terrain_grid(n_cells, seed)
    step = n_cells // 4
    world = [_region_mesh(api, P, UV, i * step, (i + 1) * step, j * step,
                          (j + 1) * step, mats[i * 4 + j])
             for i in range(4) for j in range(4)]
    world += _room(api, L(S(0.5, 0.5, 0.5)), light=12.0) + [
        api.Sphere((-8.0, 7.0, -8.0), 1.2, api.DiffuseLight(18.0, 14.0, 8.0)),
        api.Sphere((8.0, 7.0, 8.0), 1.2, api.DiffuseLight(8.0, 12.0, 18.0)),
        api.Triangle((-3, 9.0, 11.5), (3, 9.0, 11.5), (0, 11.5, 11.5),
                     api.DiffuseLight(14.0, 14.0, 14.0)),
    ]
    return api.Scene(api.Bvh(world), _interior_camera(api), (0.0, 0.0, 0.0),
                     render_config)


def many_light_scene(render_config, n_lights=64, n_cells=96, seed=3,
                     api=None):
    """A displaced-terrain BVH scene lit by one quad emitter and a grid of
    ``n_lights - 1`` sphere emitters (colours and heights drawn from
    ``seed``): above 16 lights next-event estimation takes the batched
    (rays, lights) light-pdf form — the JAX package's
    ``tests/scenes.py::create_many_light_scene``, line for line, with the
    same draws in the same order."""
    api = _api(api)
    verts, _ = _terrain(n_cells, seed, with_uvs=False)
    world = [_submodule(api, "scene").TriangleMesh(
                 verts, api.Lambertian(api.SolidColor(0.7, 0.7, 0.7))),
             api.Quad((-4, 10.5, -4), (8, 0, 0), (0, 0, 8),
                      api.DiffuseLight(6.0, 6.0, 6.0))]
    side = int(np.ceil(np.sqrt(n_lights - 1)))
    rng = np.random.default_rng(seed)
    for k in range(n_lights - 1):
        i, j = divmod(k, side)
        x = -9.0 + 18.0 * i / max(side - 1, 1)
        z = -9.0 + 18.0 * j / max(side - 1, 1)
        col = 4.0 + 8.0 * rng.random(3)
        world.append(api.Sphere((x, 6.0 + 2.0 * rng.random(), z), 0.3,
                                api.DiffuseLight(*col)))
    return api.Scene(api.Bvh(world), _interior_camera(api), (0.0, 0.0, 0.0),
                     render_config)


OBJ_FILE = "terrain.obj"
MTL_FILE = "terrain.mtl"
# the OBJ's material groups, in file order: faces before any usemtl (the
# loader's default material), then these
OBJ_GROUPS = ("colour", "textured", "bumpy")
_MTL = """# terrain materials
newmtl colour
Kd 0.73 0.73 0.73
newmtl textured
Kd 1 1 1
map_Kd albedo.png
map_Bump normal.png
newmtl bumpy
Kd 0.6 0.5 0.4
map_Bump -bm 1.0 height.png
"""


def write_obj_scene(dirpath, n_cells=362, seed=7):
    """Write the sponza-class terrain (2*n_cells^2 triangles, 262,088 at
    the default) as a Wavefront OBJ into ``dirpath``, with its MTL and PNG
    textures; returns the OBJ's path.

    The cells go in row-major order, split into four runs: the first before
    any ``usemtl`` (the default material), then ``colour`` (a Kd colour),
    ``textured`` (a map_Kd albedo and a map_Bump normal map) and ``bumpy``
    (a Kd colour and a grey map_Bump height map), the last run with
    negative (relative) indices. The first cell is one quad face without
    UVs (fan-triangulated into its two triangles), the first face of
    ``colour`` carries a normal index. Every coordinate is written as
    ``%.9g`` of its f32 value, so a native f32 parse and Python's float
    rounded to f32 read the same number."""
    from PIL import Image

    from .utils import height_to_normal_map

    P, UV = _terrain_grid(n_cells, seed)
    m = n_cells + 1
    n_verts = m * m
    lines = [f"mtllib {MTL_FILE}"]
    lines += ["v %.9g %.9g %.9g" % tuple(p) for p in
              P.reshape(-1, 3).astype(np.float32).astype(np.float64).tolist()]
    lines += ["vt %.9g %.9g" % tuple(t) for t in
              UV.reshape(-1, 2).astype(np.float32).astype(np.float64).tolist()]
    lines.append("vn 0 1 0")
    i, j = np.divmod(np.arange(n_cells * n_cells), n_cells)
    a, b = i * m + j + 1, (i + 1) * m + j + 1     # 1-based vertex ids
    c, d = b + 1, a + 1
    runs = np.array_split(np.arange(n_cells * n_cells), 4)
    tri = "f {0}/{0} {1}/{1} {2}/{2}\nf {0}/{0} {2}/{2} {3}/{3}"
    for run, group in zip(runs, (None,) + OBJ_GROUPS):
        if group is not None:
            lines.append(f"usemtl {group}")
        rel = -n_verts - 1 if group == OBJ_GROUPS[-1] else 0
        cells = np.stack([a[run], b[run], c[run], d[run]], 1) + rel
        faces = [tri.format(*q) for q in cells.tolist()]
        if group is None:
            faces[0] = "f %d %d %d %d" % tuple(cells[0])
        elif group == OBJ_GROUPS[0]:
            q = cells[0]
            faces[0] = (f"f {q[0]}/{q[0]}/1 {q[1]}/{q[1]}/1 {q[2]}/{q[2]}/1"
                        f"\nf {q[0]}/{q[0]} {q[2]}/{q[2]} {q[3]}/{q[3]}")
        lines += faces
    path = os.path.join(dirpath, OBJ_FILE)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(dirpath, MTL_FILE), "w") as f:
        f.write(_MTL)
    albedo, height = procedural_textures()
    for name, image in (("albedo", albedo), ("height", height),
                        ("normal", height_to_normal_map(height))):
        Image.fromarray(image).save(os.path.join(dirpath, f"{name}.png"))
    return path


def obj_scene(render_config, dirpath, api=None):
    """The terrain that ``write_obj_scene`` wrote into ``dirpath``, loaded
    with the API's ``Obj`` loader, inside the sponza-class room and lights
    (``sponza_class_scene``'s shell and camera)."""
    api = _api(api)
    loader = _submodule(api, "scene.loader")
    terrain = loader.Obj(os.path.join(dirpath, ""), OBJ_FILE).load(
        api.NopTransformer())
    world = [terrain] + _room(
        api, api.Lambertian(api.SolidColor(0.5, 0.5, 0.5)))
    return api.Scene(api.Bvh(world), _interior_camera(api), (0.0, 0.0, 0.0),
                     render_config)


def mixed_bvh_scene(render_config, n_cells=48, seed=7, api=None):
    """A BVH scene (terrain above 512 solids) with every ported feature
    together: an image-textured, normal-mapped terrain (the normal map made
    through ``height_to_normal_map``), a Blend floor, a dielectric sphere,
    a fuzzy metal sphere, a ConstantMedium box and a quad light. It drives
    the BVH kernel, the sphere sweep (spheres-only mode) and the medium
    kernel in one frame."""
    api = _api(api)
    albedo, height = procedural_textures()
    normal = _submodule(api, "utils").height_to_normal_map(height)
    verts, uvs = _terrain(n_cells, seed, with_uvs=True)
    terrain = _submodule(api, "scene").TriangleMesh(
        verts, api.Lambertian(api.ImageMap(albedo), api.ImageMap(normal)),
        uvs=uvs)
    floor = api.Blend(api.Lambertian(api.SolidColor(0.5, 0.5, 0.5)),
                      api.Metal(api.SolidColor(0.8, 0.8, 0.9), None, 0.2),
                      0.5)
    world = [terrain] + _room(api, floor) + [
        api.Sphere((-3.0, 3.0, 0.0), 1.2,
                   api.Dielectric(api.SolidColor(1.0, 1.0, 1.0), None, 1.5)),
        api.Sphere((3.0, 2.5, -2.0), 1.0,
                   api.Metal(api.SolidColor(0.8, 0.7, 0.6), None, 0.3)),
        api.ConstantMedium(
            api.Bvh(api.new_box((-1.0, 1.5, 2.0), (1.0, 3.5, 4.0),
                                api.Lambertian(api.SolidColor(1, 1, 1)))),
            0.3, (0.9, 0.9, 0.9)),
    ]
    return api.Scene(api.Bvh(world), _interior_camera(api), (0.0, 0.0, 0.0),
                     render_config)


def kitchen_sink_solid_scene(render_config, api=None):
    """The render megakernel's workload: the solid-colour analogue of the
    kitchen-sink scene, with every material kind K5 dispatches (lambertian,
    metal, dielectric, light, blend), a constant medium, an attenuated quad
    light and a thin-lens camera — the JAX package's
    ``tests/test_megakernel.py::_mini_kitchen_sink``, line for line."""
    api = _api(api)
    camera = api.CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                              look_from=(-5.0, 3.0, 6.0),
                              look_at=(0.25, 1.0, 0.0))
    red = api.Lambertian(api.SolidColor(1, 0, 0))
    world = [
        api.Quad((-5, 0, -15), (20, 0, 0), (0, 0, 20),
                 api.Blend(api.Lambertian(api.SolidColor(0.3, 0.6, 0.3)),
                           api.Metal(api.SolidColor(0.8, 0.8, 0.9), None,
                                     0.2), 0.4)),
        api.Sphere((-1, 1, 0), 1.0,
                   api.Dielectric(api.SolidColor(1, 1, 1), None, 1.5)),
        api.ConstantMedium(
            api.Bvh(api.new_box((0, 0, 0.5), (1, 2, 1.5), red)), 0.1,
            (1, 1, 1)),
        api.Sphere((10, 5, 10), 10.0, api.DiffuseLight(10, 10, 10)),
        api.Quad((-1, 10, -1), (2, 0, 0), (0, 0, 2),
                 api.DiffuseLight(12, 12, 12, attenuation_half_length=10.0)),
    ]
    world += api.new_box((0, 0, -0.5), (1, 2, 0.5), red)
    return api.Scene(api.Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def kitchen_sink_scene(render_config, api=None, normal_map=True,
                       tex_size=None):
    """The reference's kitchen-sink scene (quads, glass sphere, boxes, a
    constant medium, a triangle grid, sphere / quad / triangle lights) —
    the JAX package's ``tests/scenes.py::create_test_scene``, line for line,
    with the ground's image texture made by ``procedural_textures`` instead
    of loaded, and a normal map (``height_to_normal_map``) on the ground.
    The port renders it with the megakernel (K5's normal-map
    instantiation); the JAX package's gate refuses normal maps, so there it
    takes the wavefront with the fused scene hit. Without the map
    (``normal_map=False``) it is K5's case in both packages, with an image
    texture, triangle prims and a triangle light.
    With ``tex_size`` the ground's image is ``bench_textures(tex_size)``'s
    ``tex``, the stand-in for ``tex.jpg`` that the production interior
    loads too: with ``normal_map=False`` that is ``create_test_scene``
    itself, the benchmark's kitchen."""
    api = _api(api)
    albedo, height = procedural_textures()
    if tex_size is not None:
        albedo = bench_textures(tex_size)["tex"]
    normal = (api.ImageMap(_submodule(api, "utils").height_to_normal_map(
        height)) if normal_map else None)
    camera = api.CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                              look_from=(-5.0, 3.0, 6.0),
                              look_at=(0.25, 1.0, 0.0))
    world = []
    ground = api.Lambertian(api.ImageMap(albedo), normal)
    glass = api.Dielectric(api.SolidColor(1.0, 1.0, 1.0), None, 1.5)
    light = api.DiffuseLight(10.0, 10.0, 10.0)
    red = api.Lambertian(api.SolidColor(1.0, 0.0, 0.0))

    world.append(api.Quad((-5, 0, -15), (20, 0, 0), (0, 0, 20), ground))
    world.append(api.Sphere((-1, 1, 0), 1.0, glass))
    world += api.new_box((0, 0, -0.5), (1, 2, 0.5), red, api.RotationY(15.0))
    world.append(api.ConstantMedium(
        api.Bvh(api.new_box((0, 0, -0.5), (1, 2, 0.5), red,
                            api.Translation((0, 0, 1)))),
        0.1, (1, 1, 1)))
    world += api.new_box((-1, 2, 0), (-0.5, 2.5, 0.5), red)

    balls = []
    for ii in range(0, 10, 2):
        i = ii * 0.1
        for jj in range(0, 10, 2):
            j = jj * 0.1
            for kk in range(0, 10, 2):
                k = kk * 0.1
                balls.append(api.Triangle((i, j + 0.05, k + 0.8),
                                          (i, j, k + 0.8),
                                          (i, j + 0.05, k), red))
    world.append(api.Bvh(balls))
    world.append(api.Triangle((1, 0.1, 2), (3, 0.1, 2), (2, 0.1, 1), red))

    # lights
    world.append(api.Sphere((10, 5, 10), 10.0, light))
    world.append(api.Quad((0, 0, 0), (2, 0, 0), (0, 0, 2), light,
                          api.Transformations([api.RotationY(45.0),
                                               api.Translation((-1, 10,
                                                                -1))])))
    world.append(api.Triangle((-2, 1, -3), (0, 1, -3), (-1, 2, -3), light))

    return api.Scene(api.Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def many_material_scene(render_config, n_side=24, seed=13, api=None):
    """A closed room whose floor and ceiling are ``n_side``^2 quad tiles
    each (1,152 at the default: a BVH scene, planar prims only), a floor
    tile and the ceiling tile above it sharing a material of its own
    (Lambertian, every fifth a fuzzy metal, colors from a seed), grey
    walls and a quad light under the ceiling: its material and texture
    tables are too large for S1 to stage in shared memory
    (``ops.step.STAGE_MAX_BYTES``)."""
    api = _api(api)
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.05, 0.95, (n_side * n_side, 3))
    size = 20.0 / n_side
    world = []
    for k, (r, g, b) in enumerate(colors.tolist()):
        i, j = divmod(k, n_side)
        color = api.SolidColor(r, g, b)
        mat = (api.Metal(color, None, 0.3) if k % 5 == 4 else
               api.Lambertian(color))
        for y in (0.0, 10.0):
            world.append(api.Quad((-10.0 + i * size, y, -10.0 + j * size),
                                  (size, 0.0, 0.0), (0.0, 0.0, size), mat))
    wall = api.Lambertian(api.SolidColor(0.6, 0.6, 0.6))
    world += [
        api.Quad((-10.0, 0.0, -10.0), (20.0, 0.0, 0.0), (0.0, 10.0, 0.0),
                 wall),
        api.Quad((-10.0, 0.0, 10.0), (20.0, 0.0, 0.0), (0.0, 10.0, 0.0),
                 wall),
        api.Quad((-10.0, 0.0, -10.0), (0.0, 0.0, 20.0), (0.0, 10.0, 0.0),
                 wall),
        api.Quad((10.0, 0.0, -10.0), (0.0, 0.0, 20.0), (0.0, 10.0, 0.0),
                 wall),
        api.Quad((-2.0, 9.9, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0),
                 api.DiffuseLight(15, 15, 15)),
    ]
    camera = api.CameraConfig(vertical_fov_degrees=60.0, aperture_size=0.0,
                              look_from=(0.0, 6.0, 9.0),
                              look_at=(0.0, 1.0, 0.0))
    return api.Scene(api.Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def small_scene(render_config, api=None):
    """The README scene (a sphere light above a yellow sphere, below 512
    solids: the sweep path) plus one constant-medium box."""
    api = _api(api)
    world = [
        api.Sphere((0, 100, 0), 20.0, api.DiffuseLight(10, 10, 10)),
        api.Sphere((0, 0, 0), 0.5, api.Lambertian(api.SolidColor(1, 1, 0))),
        api.ConstantMedium(
            api.Bvh(api.new_box((0.4, -0.5, -0.6), (1.0, 0.3, 0.0),
                                api.Lambertian(api.SolidColor(1, 1, 1)))),
            2.0, (0.7, 0.8, 0.9)),
    ]
    camera = api.CameraConfig(vertical_fov_degrees=20, aperture_size=0.1,
                              look_from=(0, 0, 4), look_at=(0, 0, 0))
    return api.Scene(api.Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


# the tables ``table_scene`` grows, one at a time (K5's gate sweep)
TABLES = ("planar", "spheres", "lights", "materials", "media")


def _tessellated_box(api, lo, hi, k, material):
    """The six faces of the box [lo, hi], each cut into k x k quads:
    6 k^2 planar rows."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    size = hi - lo
    quads = []
    for axis in range(3):
        a, b = (axis + 1) % 3, (axis + 2) % 3
        du, dv = np.zeros(3), np.zeros(3)
        du[a], dv[b] = size[a] / k, size[b] / k
        for side in (lo[axis], hi[axis]):
            for i in range(k):
                for j in range(k):
                    q = lo.copy()
                    q[axis] = side
                    q = q + i * du + j * dv
                    quads.append(api.Quad(tuple(q), tuple(du), tuple(dv),
                                          material))
    return quads


def table_scene(render_config, table, n, normal_map=False, seed=17,
                api=None):
    """A small scene grown along one table (``TABLES``), K5's gate sweep:
    a ground quad (solid grey, with ``normal_map`` a tangent-space normal
    map), a quad light above and a sky, and a grid of ``n`` items over
    [-4, 4]^2 of the table named:

    - ``planar``: n small tilted quads and triangles, every other one
      metal (n + 2 planar rows);
    - ``spheres``: n spheres, every other one metal (n spheres);
    - ``lights``: n small quad lights in place of the one light, their
      total power the one light's, over eight spheres (n lights, n + 1
      planar rows);
    - ``materials``: 256 quads whose materials cycle through n Lambertians,
      each with a solid colour of its own (n + 2 materials and about as
      many textures);
    - ``media``: eight spheres and one constant medium whose box boundary
      has each face cut into k x k quads, n = 6 k^2 boundary rows.

    Every table but the one grown keeps its size from one n to the next."""
    api = _api(api)
    rng = np.random.default_rng(seed)
    normal = None
    if normal_map:
        _, height = procedural_textures()
        normal = api.ImageMap(_submodule(api, "utils").height_to_normal_map(
            height))
    ground = api.Lambertian(api.SolidColor(0.6, 0.6, 0.6), normal)
    mats = [api.Lambertian(api.SolidColor(0.8, 0.3, 0.2)),
            api.Metal(api.SolidColor(0.7, 0.7, 0.8), None, 0.2)]
    world = [api.Quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), ground)]
    if table != "lights":
        world.append(api.Quad((-1, 6, -1), (2, 0, 0), (0, 0, 2),
                              api.DiffuseLight(8.0, 8.0, 8.0)))
    count = {"lights": 8, "materials": 256, "media": 8}.get(table, n)
    side = int(np.ceil(np.sqrt(count)))
    step = 8.0 / side
    cells = [(-4.0 + (i % side + 0.5) * step, -4.0 + (i // side + 0.5) * step)
             for i in range(count)]
    if table == "planar":
        size = 0.4 * step
        for i, (x, z) in enumerate(cells):
            y = 0.1 + 0.5 * float(rng.uniform())
            if i % 2:
                world.append(api.Triangle((x - size / 2, y, z),
                                          (x + size / 2, y, z),
                                          (x, y + size, z), mats[i % 4 // 2]))
            else:
                world.append(api.Quad((x - size / 2, y, z - size / 2),
                                      (size, 0.3 * size, 0), (0, 0, size),
                                      mats[i % 4 // 2]))
    elif table == "materials":
        size = 0.6 * step
        colours = [api.Lambertian(api.SolidColor(*rng.uniform(0.1, 0.9, 3)))
                   for _ in range(n)]
        for i, (x, z) in enumerate(cells):
            world.append(api.Quad((x - size / 2, 0.2, z - size / 2),
                                  (size, 0.2 * size, 0), (0, 0, size),
                                  colours[i % n]))
    else:
        radius = 0.35 * step
        world += [api.Sphere((x, radius, z), radius, mats[i % 2])
                  for i, (x, z) in enumerate(cells)]
    if table == "lights":
        k = int(np.ceil(np.sqrt(n)))
        size = 0.3 * 8.0 / k
        power = 8.0 * 4.0 / (n * size * size)
        light = api.DiffuseLight(power, power, power)
        for i in range(n):
            x = -4.0 + (i % k + 0.5) * 8.0 / k
            z = -4.0 + (i // k + 0.5) * 8.0 / k
            world.append(api.Quad((x - size / 2, 5.0, z - size / 2),
                                  (size, 0, 0), (0, 0, size), light))
    if table == "media":
        k = int(round(np.sqrt(n / 6)))
        if 6 * k * k != n:
            raise ValueError(f"media: n = 6 k^2 boundary rows, not {n}")
        world.append(api.ConstantMedium(
            api.Bvh(_tessellated_box(api, (-1.5, 0.0, -1.5), (1.5, 2.0, 1.5),
                                     k, mats[0])), 0.3, (0.8, 0.8, 0.9)))
    camera = api.CameraConfig(vertical_fov_degrees=45.0,
                              look_from=(0.0, 5.0, 9.0),
                              look_at=(0.0, 0.5, 0.0))
    return api.Scene(api.Bvh(world), camera, (0.3, 0.4, 0.6), render_config)


def edge_rays(solids, n, seed=1, origin=(0.0, 6.0, 9.0)):
    """``n`` rays from around ``origin`` aimed at the valid triangles' first
    vertices and edge midpoints of compiled ``solids``: where neighbouring
    triangles of a mesh meet, so several prims often give the closest t
    exactly (ties, which resolve to the smallest slot). Returns (origins,
    directions), (n, 3) f32 numpy arrays."""
    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)

    valid = host(solids.tr_valid) > 0
    v0, e1, e2 = (host(x)[valid] for x in (solids.tr_v0, solids.tr_e1,
                                           solids.tr_e2))
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, len(v0), n)
    offsets = np.stack([np.zeros_like(e1), 0.5 * e1, 0.5 * (e1 + e2),
                        0.5 * e2], axis=1)[tri]
    target = v0[tri] + offsets[np.arange(n), rng.integers(0, 4, n)]
    o = np.asarray(origin, np.float64) + rng.uniform(-1.0, 1.0, (n, 3))
    return o.astype(np.float32), (target - o).astype(np.float32)
