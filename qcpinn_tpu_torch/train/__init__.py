"""Training pieces of the PyTorch port."""

from . import losses, optim
from .crystal import CrystalConfig, train_crystal
from .cz_pipeline import CzConfig, make_pretrain_epoch, run_finetune, run_pretrain
from .lbfgs import lbfgs_refine, make_fixed_batch_loss
from .loop import (TermSpec, diffusion_terms, inject_balancer_params,
                   make_train_step, make_val_fn, train)

__all__ = [
    "losses",
    "optim",
    "TermSpec",
    "diffusion_terms",
    "make_train_step",
    "make_val_fn",
    "inject_balancer_params",
    "train",
    "lbfgs_refine",
    "make_fixed_batch_loss",
    "CzConfig",
    "make_pretrain_epoch",
    "run_pretrain",
    "run_finetune",
    "CrystalConfig",
    "train_crystal",
]
