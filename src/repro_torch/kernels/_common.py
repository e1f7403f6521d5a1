"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def kernel_arg(t: torch.Tensor, device: torch.device, dtype=None
               ) -> torch.Tensor:
    """A contiguous, 16-byte aligned tensor on `device` for a raw pointer
    argument. Raises on a wrong device or dtype — it never moves data
    between devices."""
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, kernel runs on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def per_row(x, B: int, device: torch.device) -> torch.Tensor:
    """A scalar or [B] tensor → an int32 [B] tensor on `device`."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device, dtype=torch.int32)
        return x.expand(B).contiguous() if x.ndim == 0 else x.contiguous()
    return torch.full((B,), int(x), dtype=torch.int32, device=device)
