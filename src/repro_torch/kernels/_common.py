"""Argument checks shared by the kernel wrappers, the one list of their
launch counters, and the meta-tensor path every wrapper takes for a dry
run (`meta_call`)."""
from __future__ import annotations

import importlib

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims each wrapper's kernel is instantiated for. flash_prefill and
# the split-KV decode routine (paged_decode, sink_decode) also take 80
# (hubert-xlarge) and 96 (phi-3-vision); the paged-history routine
# (paged_prefill, spec_verify) and block_topk take the powers of two only
# (ROADMAP B17b).
HEAD_DIMS = (32, 64, 128, 256)
WIDE_HEAD_DIMS = (32, 64, 80, 96, 128, 256)

# Every launch counter of the kernel wrappers, as (module, wrapper,
# attribute): a wrapper adds one where it launches its kernel on the card.
# The counters live in Python, so a CUDA-graph replay does not advance
# them; the hot-loop entries (serving/placement.py) read them around a
# capture through this list and add the capture's deltas at each replay.
# A new counted kernel goes here.
LAUNCH_COUNTERS = (
    ("paged_decode", "paged_decode", "launches"),
    ("paged_decode", "paged_decode", "int8_launches"),
    ("paged_prefill", "paged_prefill", "launches"),
    ("paged_prefill", "paged_prefill", "int8_launches"),
    ("flash_prefill", "flash_prefill", "launches"),
    ("sink_decode", "sink_decode", "launches"),
    ("spec_verify", "spec_verify", "launches"),
    ("spec_verify", "spec_verify", "int8_launches"),
    ("block_topk", "block_topk_scores", "launches"),
    ("block_topk", "block_topk_select_scores", "launches"),
    ("moe_gmm", "moe_gmm", "launches"))


# The active cost meters of a dry run (launch/cost.py's CostCounter adds
# itself while it counts): each takes a `charge` per kernel call on meta
# tensors.
METERS: list = []


def meta_call(name: str, out, cost: tuple, dtype):
    """A kernel wrapper's call on meta tensors (a dry run): neither the
    kernel nor its plain twin runs. Every active meter is charged once
    with the kernel's bytes and operations, `cost` being the wrapper's
    bound from launch/cost.py, (ms, by, bytes, operations), reckoned at
    the full occupancy of the tensors given. → out, the empty output of
    the kernel's shape. No launch counter moves: nothing is launched."""
    for m in METERS:
        m.charge(name, cost[2], cost[3], dtype)
    return out


def _wrapper(module: str, name: str):
    return getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                   name)


def launch_counts() -> dict:
    """{"wrapper.attribute": count} of every counter in LAUNCH_COUNTERS."""
    return {f"{n}.{a}": getattr(_wrapper(m, n), a)
            for m, n, a in LAUNCH_COUNTERS}


def count_delta(before: dict, after: dict) -> dict:
    """after - before, per counter, leaving out the counters that did not
    move."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add_launch_counts(delta: dict, sign: int = 1) -> None:
    """Add `sign` × delta to the counters (sign -1 takes it back)."""
    for m, n, a in LAUNCH_COUNTERS:
        k = f"{n}.{a}"
        if k in delta:
            fn = _wrapper(m, n)
            setattr(fn, a, getattr(fn, a) + sign * delta[k])


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input of a kernel launch requires
    grad. A kernel launched through ctypes is no autograd op: its output
    has no grad_fn, so a backward through it would succeed and leave every
    parameter upstream of it without its gradient. The train path
    (`stack_apply(mode="train")`) runs plain PyTorch instead, and serving
    runs under torch.no_grad(), where this costs one flag read."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and would drop the "
            f"gradients of an input that requires grad; train through "
            f"stack_apply(mode='train') (plain PyTorch), or call it under "
            f"torch.no_grad()")


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


def gather_kv(pages, tables, scale=None, tok=None):
    """Tabled blocks of an arena [N,K,bs,h] as a linear [B,K,nb·bs,h] cache
    (the plain versions' gather). int8 pages with their scale plane (scale
    [N,K,h], tok [N,K,bs]) come out dequantized, one float32 product per
    element: q · where(scale != 0, scale, tok), decided per channel."""
    B, nb = tables.shape
    K, bs, h = pages.shape[1:]
    tl = tables.long()
    g = pages[tl]                                  # [B, nb, K, bs, h]
    if scale is not None:
        sc = scale[tl][..., None, :]
        g = g.float() * torch.where(sc != 0, sc, tok[tl][..., None])
    return g.permute(0, 2, 1, 3, 4).reshape(B, K, nb * bs, h)


def scale_plane_args(k_pages, scales, dev):
    """Check the scale plane of int8 arenas for a kernel launch → the four
    contiguous float32 tensors (k_scale, k_tok, v_scale, v_tok). scales is
    that tuple; each `*_scale` is [N,K,h], each `*_tok` [N,K,bs]."""
    N, K, bs, h = k_pages.shape
    out = []
    for t, shp in zip(scales, ((N, K, h), (N, K, bs)) * 2):
        if tuple(t.shape) != shp:
            raise ValueError(f"scale plane {tuple(t.shape)} does not match "
                             f"int8 pages {tuple(k_pages.shape)}")
        out.append(kernel_arg(t, dev, torch.float32))
    return out
