"""Shader descriptors (host side), mirroring ``renderer/shader.rs:35-44``."""
from __future__ import annotations

from . import integrator


class Shader:
    kind = integrator.SHADER_PATH
    max_depth = 50


class PathTracingShader(Shader):
    """Full path tracing with a bounce-depth cap (shader.rs:46-107);
    reference default max_depth = 50 (renderer/mod.rs:47)."""

    kind = integrator.SHADER_PATH

    def __init__(self, max_depth: int = 50):
        self.max_depth = int(max_depth)


class AlbedoShader(Shader):
    """Flat scatter-color shader (shader.rs:127-151)."""

    kind = integrator.SHADER_ALBEDO


class NormalShader(Shader):
    """Shading-normal visualization (shader.rs:153-173)."""

    kind = integrator.SHADER_NORMAL


class SimpleShader(Shader):
    """Quick flat shading with a fixed light direction (shader.rs:175-215)."""

    kind = integrator.SHADER_SIMPLE
