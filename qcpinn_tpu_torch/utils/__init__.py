"""Utilities of the PyTorch port."""

from .checkpoint import load_checkpoint, save_checkpoint
from .evaluation import evaluate_cz_fields, evaluate_relative_l2, meshgrid_points
from .logger import Logging

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "evaluate_cz_fields",
    "evaluate_relative_l2",
    "meshgrid_points",
    "Logging",
]
