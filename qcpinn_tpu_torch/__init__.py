"""qcpinn_tpu_torch: the PyTorch + CUDA port of qcpinn_tpu for NVIDIA Hopper.

The JAX package ``qcpinn_tpu`` is the reference; this package imports
nothing of it (nor JAX). Public functions keep the JAX package's layouts:
states are ``[B, 2^n]`` complex64 with wire 0 the most significant bit, and
block unitaries are ``M[in, out]``.

Numerics: the JAX package runs every matmul at ``Precision.HIGHEST``
(bf16 one-pass matmuls cost about 1e-2 on the PDE residuals), so the port
turns TF32 off once, here, for every matmul and convolution.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is missing: the CPU runs
    only when the caller asks for it (``device="cpu"``), as the tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but CUDA is not available")
    return device
