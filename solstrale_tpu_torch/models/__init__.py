"""Learned and analytic denoisers (``denoiser.py``) with the bundled CNN
weights (``denoiser_weights.pkl``)."""
from .denoiser import DenoiserCNN, denoise_bilateral  # noqa: F401
