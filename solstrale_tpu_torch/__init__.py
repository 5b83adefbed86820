"""solstrale_tpu_torch — the path tracer on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``solstrale_tpu`` (which stays the reference):
the same Scene / ray_trace library surface, the same compiled scene tables
and the same counter-hash RNG, so a render draws the same numbers for the
same path. Every tensor lives on the device the caller names
(``ray_trace(scene, device="cuda")``); the intersection kernels run as CUDA
kernels on CUDA tensors and as their plain PyTorch versions on CPU tensors.
Importing the package builds no kernel and needs neither JAX nor a GPU.
"""
from .geo.transformation import (NopTransformer, RotationX, RotationY,
                                 RotationZ, Scale, Transformations,
                                 Translation)
from .renderer import (EverySample, Interval, OnlyFinal, RenderConfig,
                       Renderer, RenderProgress, ray_trace)
from .renderer.shader import (AlbedoShader, NormalShader, PathTracingShader,
                              SimpleShader)
from .scene import (Blend, Bvh, CameraConfig, ConstantMedium, Dielectric,
                    DiffuseLight, ImageMap, Isotropic, Lambertian, Metal,
                    Quad, Scene, SolidColor, Sphere, Triangle,
                    load_normal_texture, new_box)
from .scene.loader import Obj

__version__ = "0.1.0"
