"""The upstream library's kitchen-sink scene (``tests/scenes.rs::
create_test_scene``, its profiling workload ``src/bin/profiling.rs``):
quads, a glass sphere, two red boxes (one rotated), a constant medium in a
box, a grid of 125 small triangles, one more triangle, and a sphere, a quad
and a triangle light. A frozen copy of ``solstrale_tpu_torch``'s
``fixtures.kitchen_sink_scene(normal_map=False)``, with the ground's
``tex.jpg`` the ``_assets.tex_stand_in`` colour noise at ``tex_size``."""
from __future__ import annotations

from . import _assets


def build(api, render_config, tex_size=1024, tex_seed=5):
    """The scene through ``api``."""
    albedo = _assets.tex_stand_in(tex_size, tex_seed)
    camera = api.CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                              look_from=(-5.0, 3.0, 6.0),
                              look_at=(0.25, 1.0, 0.0))
    ground = api.Lambertian(api.ImageMap(albedo))
    glass = api.Dielectric(api.SolidColor(1.0, 1.0, 1.0), None, 1.5)
    light = api.DiffuseLight(10.0, 10.0, 10.0)
    red = api.Lambertian(api.SolidColor(1.0, 0.0, 0.0))

    world = [api.Quad((-5, 0, -15), (20, 0, 0), (0, 0, 20), ground),
             api.Sphere((-1, 1, 0), 1.0, glass)]
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

    world.append(api.Sphere((10, 5, 10), 10.0, light))
    world.append(api.Quad((0, 0, 0), (2, 0, 0), (0, 0, 2), light,
                          api.Transformations([api.RotationY(45.0),
                                               api.Translation((-1, 10,
                                                                -1))])))
    world.append(api.Triangle((-2, 1, -3), (0, 1, -3), (-1, 2, -3), light))
    return api.Scene(api.Bvh(world), camera, (0.2, 0.3, 0.5), render_config)
