"""The benchmark's plain reference: a path tracer in plain PyTorch that the
benchmark holds the program's outputs to.

It imports nothing of the program (``solstrale_tpu_torch``) and nothing of
the JAX package: its modules are frozen copies of the port's plain
versions (scene description, scene compile, the counter-hash draws, the
brute-force sweeps, the hit attributes and light sampling, the bounce),
so a later change to the program cannot move the yardstick. It works out
again, from the scene description that the benchmark's scene generators
build through it (``api=perfbench.reference``, as through the port's
API), every table the program derives: the prim, light, material and
texture tables and the camera. It builds no BVH: its scene hit is the
brute-force sweep over every prim, which finds the same closest hit as a
tree walk (the first slot wins a tie).

The names below are the scene-construction surface the generators use.
"""
from .geo.transformation import (NopTransformer, RotationX, RotationY,
                                 RotationZ, Scale, Transformations,
                                 Translation)
from .scene import (Blend, Bvh, CameraConfig, ConstantMedium, Dielectric,
                    DiffuseLight, ImageMap, Isotropic, Lambertian, Metal,
                    Quad, Scene, SolidColor, Sphere, Triangle,
                    load_normal_texture, new_box)


class RenderConfig:
    """The image size the camera is compiled for (the only part of a
    render configuration the scene tables depend on)."""

    def __init__(self, width, height, **_):
        self.width = int(width)
        self.height = int(height)
