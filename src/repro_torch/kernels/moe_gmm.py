"""Slot-batched grouped matmul with per-slot valid rows — the MoE expert
FFN's hot op.

`moe_gmm` launches the hand-written CUDA kernel `csrc/moe_gmm.cu` (the port
of the TPU kernel src/repro/kernels/moe_gmm.py) for tensors on a CUDA
device, and runs `moe_gmm_plain` — the same function in plain PyTorch — for
tensors on the CPU. `moe_gmm.launches` counts kernel launches (nothing else
adds to it).

    out[s, c, :] = x[s, c, :] @ w[s]   for c < n_valid[s],   0 otherwise

After dispatch each slot's buffer is filled from row 0 (models/moe.py), so
the rows below n_valid[s] are exactly the slot's tokens and the rest are
capacity padding. Accumulation is float32; the output has x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import DTYPE_CODES, kernel_arg


def moe_gmm_plain(x, w, n_valid):
    """x [s, C, D] @ w [s, D, F] with rows c >= n_valid[s] masked → [s, C,
    F] in x's dtype (the reference's `kernels/ref.py::moe_gmm_ref`)."""
    C = x.shape[1]
    nv = n_valid.to(device=x.device, dtype=torch.int64)
    mask = torch.arange(C, device=x.device)[None, :, None] < nv[:, None, None]
    xm = torch.where(mask, x.float(), torch.zeros((), device=x.device))
    return torch.bmm(xm, w.float()).to(x.dtype)


def moe_gmm(x, w, n_valid):
    """x [s, C, D] float32/bfloat16; w [s, D, F] of x's dtype; n_valid [s]
    int → [s, C, F]. On the card a slot with n_valid = 0 never reads its
    weights, and a row tile past n_valid writes zeros without reading."""
    if x.device.type != "cuda":
        return moe_gmm_plain(x, w, n_valid)
    S, C, D = x.shape
    if w.ndim != 3 or w.shape[0] != S or w.shape[1] != D:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"moe_gmm kernel takes float32/bfloat16 x and w of "
                         f"the same dtype, got {x.dtype} and {w.dtype}")
    if n_valid.shape != (S,):
        raise ValueError(f"n_valid {tuple(n_valid.shape)} is not [{S}]")
    dev = x.device
    F = w.shape[2]
    xa = kernel_arg(x, dev)
    wa = kernel_arg(w, dev)
    nv = kernel_arg(n_valid.to(torch.int32), dev, torch.int32)
    out = torch.empty((S, C, F), dtype=x.dtype, device=dev)
    lib = build.load("moe_gmm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.moe_gmm_launch(DTYPE_CODES[x.dtype], xa.data_ptr(),
                                wa.data_ptr(), nv.data_ptr(), out.data_ptr(),
                                S, C, D, F, stream)
    build.check_launch("moe_gmm", rc)
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
