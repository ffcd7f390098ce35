"""Device selection and numeric settings shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; it raises where there is none.

    The port's entry points run on the card unless the caller asks for the
    CPU explicitly (``device="cpu"``), so a missing card never turns into a
    silent CPU run.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def pin_fp32() -> None:
    """Full fp32 matmuls and convolutions: the JAX oracle pins
    ``Precision.HIGHEST``, and TF32 keeps only ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
