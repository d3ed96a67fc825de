"""Device selection and matmul precision for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    visible: the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def full_precision():
    """True-f32 matmuls: TF32 keeps ~3 decimal digits, which the normal
    equations cannot afford (the JAX bench forces "highest" likewise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
