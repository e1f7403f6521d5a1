"""Device and dtype policy of the port.

Every entry point takes an explicit `device`; the default is `cuda`, and the
CPU is used only when the caller asks for it (the CPU tests do). float32
matrix products and convolutions run in full float32 — TF32 is switched off
so the port holds float32 parity with the JAX reference on the card.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def set_precision_policy() -> None:
    """Full-float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """`None` → cuda. Asking for cuda without a card raises: the port never
    falls back to the CPU on its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    set_precision_policy()
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]
