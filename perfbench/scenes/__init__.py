"""The benchmark's scenes: frozen copies of ``solstrale_tpu_torch``'s
asset-free fixture scenes (``fixtures.py``), one module a scene, each with
``build(api, render_config, **params)``. ``api`` is the package the scene is
built through: the program's (``solstrale_tpu_torch``) for the run, the
plain reference's (``perfbench.reference``) for the check, from the same
numpy arrays. A configuration file names its scene module and its
parameters.
"""
import importlib


def submodule(api, name):
    """``api``'s submodule ``name`` (``scene``: where ``TriangleMesh``
    lives in both packages)."""
    return importlib.import_module(f"{api.__name__}.{name}")
