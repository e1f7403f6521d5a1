"""Slot-batched grouped matmul with per-slot valid rows — the MoE expert
FFN's hot op.

`moe_gmm` launches the hand-written CUDA kernel `csrc/moe_gmm.cu` (the port
of the TPU kernel src/repro/kernels/moe_gmm.py) for tensors on a CUDA
device, and runs `moe_gmm_plain` — the same function in plain PyTorch — for
tensors on the CPU. The kernel's grid (`gmm_ctas`) comes from shapes alone:
its CTAs list the live work items on the device, so the host never reads
n_valid. `moe_gmm.launches` counts kernel launches (nothing else adds to
it).

    out[s, c, :] = x[s, c, :] @ w[s]   for c < n_valid[s],   0 otherwise

After dispatch each slot's buffer is filled from row 0 (models/moe.py), so
the rows below n_valid[s] are exactly the slot's tokens and the rest are
capacity padding. Accumulation is float32; the output has x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, kernel_arg,
                                         refuse_autograd)
from repro_torch.kernels.paged_decode import _sm_count

# the kernel's work item and occupancy (csrc/moe_gmm.cu BN, RT, CTAS_PER_SM)
GMM_COLS, GMM_ROWS, GMM_CTAS_PER_SM = 64, 32, 4


def gmm_ctas(S: int, C: int, F: int, n_sm: int) -> int:
    """The kernel's grid from shapes alone → n CTAs. The work items are
    (slot, GMM_ROWS-row tile, GMM_COLS-column tile) triples; on the device
    each CTA lists the live ones (row tiles below n_valid) in slot order
    and takes items b, b + n, ...; output row r of the S·C rows is zeroed
    (if at or past n_valid) by CTA r mod n. GMM_CTAS_PER_SM CTAs per SM,
    never more than there are items."""
    items = S * -(-C // GMM_ROWS) * -(-F // GMM_COLS)
    return max(1, min(items, GMM_CTAS_PER_SM * n_sm))


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
    weights, and rows at or past n_valid are written as zeros without
    being read."""
    if x.device.type != "cuda":
        return moe_gmm_plain(x, w, n_valid)
    refuse_autograd("moe_gmm", x, w)
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
    n_cta = gmm_ctas(S, C, F, _sm_count(dev.index))
    lib = build.load("moe_gmm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.moe_gmm_launch(DTYPE_CODES[x.dtype], xa.data_ptr(),
                                wa.data_ptr(), nv.data_ptr(), out.data_ptr(),
                                S, C, D, F, n_cta, stream)
    build.check_launch("moe_gmm", rc)
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
