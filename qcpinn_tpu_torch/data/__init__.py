"""Problem data of the PyTorch port."""

from . import diffusion
from .diffusion import Sampler, gaussian_pulse_samplers, sine_samplers

__all__ = ["diffusion", "Sampler", "gaussian_pulse_samplers", "sine_samplers"]
