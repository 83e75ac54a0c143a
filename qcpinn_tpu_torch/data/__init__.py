"""Problem data of the PyTorch port."""

from . import diffusion
from .cz_loader import DataStats, choose_calibration_subset, infer_boundary_masks, load_cz_data
from .diffusion import Sampler, gaussian_pulse_samplers, sine_samplers
from .scaler import Scaler

__all__ = [
    "diffusion",
    "Sampler",
    "gaussian_pulse_samplers",
    "sine_samplers",
    "infer_boundary_masks",
    "DataStats",
    "choose_calibration_subset",
    "load_cz_data",
    "Scaler",
]
