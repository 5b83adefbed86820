"""Learned and analytic denoisers (``denoiser.py``) with the bundled CNN
weights (``denoiser_weights.pkl``)."""
