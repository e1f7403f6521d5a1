"""Cost of one step of the port on an NVIDIA H100, counted on meta
tensors: the port's counterpart of the reference's
src/repro/launch/hlo_cost.py, which walks a compiled HLO module.

`CostCounter` is a `TorchDispatchMode` around one step (`LM.prefill`,
`LM.decode`, a train step) whose tensors live on the "meta" device. It
counts, for one rank:

- flops: 2·M·N·K for each matrix product, by the registry of
  `torch.utils.flop_counter` (the aten products FlopCounterMode counts),
  plus each kernel call's own operations;
- bytes_per_device: the traffic of the port's ops as traced (every input
  and output of each aten op that is not a view or a fresh allocation),
  plus each kernel call's bytes; min_bytes (see `CostCounter.finish`): every
  argument of the step read once and every output written once, the
  memory term of the roofline, so that it stays a least time;
- collective bytes and counts per kind, as the dry backend of `RankCtx`
  records them (distributed/ctx.py: what this rank would send);
- peak-live bytes: the most bytes held at once by the storages the step
  creates (each storage's life is followed with `weakref.finalize`), the
  counterpart of XLA's memory_analysis.

A kernel wrapper given meta tensors runs neither its kernel nor its plain
twin: it returns an empty output of the kernel's shape and charges every
active counter once (`kernels._common.meta_call`) with the bytes and
operations of the functions below, reckoned at the full occupancy of the
tensors it is given (meta tensors have no values to read). The same
functions give `chip_smoke.py`'s `bound_ms` for its timed kernel calls,
where they read the real lens, offsets and valid rows.

The card's figures (datasheet peaks, not measurements) are those of an
NVIDIA H100 SXM5 80GB HBM3, as `nvidia-smi --query-gpu=name,power.limit`
gives it: "NVIDIA H100 80GB HBM3, 700.00 W". A card set below 700 W runs
slower under load, so a measured time against these bounds names its
card's limit."""
from __future__ import annotations

import weakref
from collections import Counter, defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

CARD = "NVIDIA H100 80GB HBM3"
CARD_POWER_LIMIT = "700.00 W"
CARD_MEMORY_BYTES = 80e9                     # the card's 80 GB
HBM_BYTES_S = 3.35e12                        # H100 SXM HBM3
# float32 products at float32 accuracy: the tensor cores' 3xTF32 split
# (three TF32 products per float32 product) at the dense TF32 peak of 495
# TF/s gives 165 TF/s, above the 67 TF/s of float32 outside tensor cores,
# so the least time of float32 work is reckoned at this rate
F32_3XTF32_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12                          # bf16 tensor cores, dense
PEAK_FLOPS = {torch.float32: F32_3XTF32_FLOPS,
              torch.bfloat16: BF16_FLOPS}
NVLINK_BYTES_S = 450e9                       # NVLink 4, each way


# ----------------------------------------------------------------------
# Kernel bounds: (ms, "bytes" | "operations", bytes, operations)
def bound(nbytes, flops, dtype):
    t_mem = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops
            else "operations", nbytes, flops)


def host_rows(x, n: int, full: int) -> np.ndarray:
    """The int64 values of x (an int or a tensor of one or n entries) as
    n host ints; on meta, which holds no values, `full` each."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "meta":
            return np.full(n, full, dtype=np.int64)
        a = x.detach().cpu().numpy().astype(np.int64).reshape(-1)
        return np.broadcast_to(a, (n,)) if a.size == 1 else a
    return np.full(n, int(x), dtype=np.int64)


def block_bytes(kp):
    """Bytes one resident block moves per kv head, K and V together: the
    payload, plus on int8 arenas the block's float32 scale rows (h seal
    scales + bs token scales, each for K and V)."""
    bs, h = kp.shape[2], kp.shape[3]
    nbytes = 2 * bs * h * kp.element_size()
    if kp.dtype == torch.int8:
        nbytes += 2 * (h + bs) * 4
    return nbytes


def decode_bound(q, kp, tables, lens):
    """paged_decode: q read and the output written, the table and lens, and
    every resident block of each (sequence, kv head) once; 4·h operations
    per (query row, resident key). On meta every table entry is
    resident."""
    B, K, G, h = q.shape
    bs, e = kp.shape[2], q.element_size()
    nb = tables.shape[1]
    ln = host_rows(lens, B, nb * bs)
    blocks = np.minimum(-(-ln // bs), nb).sum()
    nbytes = (2 * q.numel() * e + tables.numel() * 4 + B * 4
              + int(blocks) * K * block_bytes(kp))
    flops = 4 * K * G * h * int(ln.sum())
    return bound(nbytes, flops, q.dtype)


def prefill_bound(q, kn, kp, tables, off, cl):
    """paged_prefill and spec_verify: q, the new keys and values read and
    the output written, the table, offsets and lengths, and the resident
    history blocks once; 4·h operations per visible (query row, key) pair.
    On meta the whole table is history and every row is real."""
    B, K, SG, h = q.shape
    S = kn.shape[2]
    G = SG // S
    bs, e = kp.shape[2], q.element_size()
    nb = tables.shape[1]
    o = host_rows(off, B, nb * bs)
    c = host_rows(cl, B, S)
    blocks = np.minimum(-(-o // bs), nb).sum()
    i = np.arange(S)
    visible = sum(int(G * (ob + np.minimum(i + 1, cb)).sum())
                  for ob, cb in zip(o, c))               # keys per row, summed
    nbytes = (2 * q.numel() * e + 2 * kn.numel() * e + tables.numel() * 4
              + 8 * B + int(blocks) * K * block_bytes(kp))
    flops = 4 * K * h * visible
    return bound(nbytes, flops, q.dtype)


def topk_bound(q, tables, lens, bs):
    """Bytes and operations of one block_topk call: q, the table, lens and
    the scores once, and the two float32 summary rows of every resident
    (block, kv head); 4 operations (2 products, max, add) per (resident
    block, kv head, query row, channel), in float32."""
    B, K, G, h = q.shape
    nb = tables.shape[1]
    ln = host_rows(lens, B, nb * bs)
    blocks = int(np.minimum(-(-ln // bs), nb).sum())
    nbytes = (q.numel() * q.element_size() + tables.numel() * 4 + 4 * B
              + 4 * B * nb + 2 * blocks * K * h * 4)
    return bound(nbytes, 4 * blocks * K * G * h, torch.float32)


def topk_select_bound(q, tables, lens, bs, k_static):
    """block_topk_select: the scoring's bytes and operations (topk_bound)
    plus its outputs written once (the compacted table, lens, counts and
    the [B, nb] bool mask); the ranking is integer work and adds none."""
    B, nb = tables.shape
    nbytes, flops = topk_bound(q, tables, lens, bs)[2:]
    nbytes += 4 * B * k_static + 8 * B + B * nb
    return bound(nbytes, flops, torch.float32)


def topk_given_bound(tables, lens, bs, k_static):
    """block_topk_select_scores: the scores and lens read once, the kept
    blocks' table entries read, the compacted table, lens, counts, mask and
    stats written once; the ranking is integer work and adds no
    operations."""
    B, nb = tables.shape
    nbytes = 4 * B * nb + 4 * B + 4 * B * k_static + 4 * B * k_static \
        + 8 * B + B * nb + 16
    return bound(nbytes, 0, torch.float32)


def flash_bound(q, k, causal, window, sink):
    """Bytes and flops of one flash_prefill call: q, k, v read once, the
    output written once; 4·h flops per visible (query row, key) pair."""
    N, SG, h = q.shape
    S = k.shape[1]
    G = SG // S
    e = q.element_size()
    # visible keys per query token, summed over the S tokens (closed form:
    # an [S, S] mask would not fit at S = 32,768)
    p = np.arange(S, dtype=np.int64)
    lo = np.zeros(S, dtype=np.int64)
    hi = p + 1 if causal else np.full(S, S, dtype=np.int64)
    if window > 0:
        lo = np.maximum(p - window + 1, 0)
        n = np.maximum(hi - lo, 0) + np.minimum(sink, lo)
    else:
        n = hi - lo
    visible = N * G * int(n.sum())
    nbytes = 2 * q.numel() * e + 2 * k.numel() * e
    return bound(nbytes, 4 * h * visible, q.dtype)


def sink_bound(q, kc, t):
    """Bytes and flops of one sink_decode call: the live slots min(t, W) of
    each (sequence, kv head) read once, q read and the output written. On
    meta every slot is live."""
    B, K, G, h = q.shape
    W = kc.shape[2]
    e = q.element_size()
    live = int(np.minimum(host_rows(t, B, W), W).sum())
    nbytes = 2 * q.numel() * e + 2 * live * K * h * e + 4 * B
    return bound(nbytes, 4 * K * G * h * live, q.dtype)


def moe_gmm_bound(x, w, n_valid):
    """Bytes and operations of one moe_gmm call: the weights of every slot
    with a valid row, the valid rows of x (the rows at or past n_valid are
    never read), the whole output (written, zeros included) and n_valid,
    once each; 2 operations per (valid row, D, F). On meta every row of
    every slot is valid."""
    S, C, D = x.shape
    F = w.shape[2]
    nv = host_rows(n_valid, S, C)
    e = x.element_size()
    nbytes = (int((nv > 0).sum()) * D * F * e + int(nv.sum()) * D * e
              + S * C * F * e + 4 * S)
    return bound(nbytes, 2 * int(nv.sum()) * D * F, x.dtype)


# ----------------------------------------------------------------------
def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def distinct_bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors (views of one
    storage count once)."""
    seen = {}
    for t in _tensors(tree):
        seen.setdefault(storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


# ops that move no bytes: fresh allocations (their storage is followed
# for peak-live bytes, their contents are not written)
_ALLOC_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "empty_permuted"}


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None \
        and not rets[0].alias_info.is_write


class CostCounter(TorchDispatchMode):
    """Counts one rank's step; see the module docstring. Use:

        with CostCounter(args) as c:
            out = step(*args)
        rec = c.finish(out)

    `args` are the step's arguments: their storages are not the step's own
    (not followed for peak-live bytes) and make up min_bytes' reads."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.args = args
        self._arg_keys = {storage_key(t) for t in _tensors(args)}
        self.product_flops = defaultdict(int)     # dtype name → flops
        self.kernel_flops = defaultdict(int)
        self.traced_bytes = 0
        self.kernel_bytes = 0
        self.kernel_charges = []                  # (name, bytes, flops)
        self.collective_bytes = defaultdict(int)  # kind → bytes
        self.collective_counts = defaultdict(int)
        self.collective_calls = defaultdict(int)  # RankCtx method → calls
        self._live = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0

    # ---- the hooks ----------------------------------------------------
    def __enter__(self):
        from repro_torch.distributed import ctx as ctx_mod
        from repro_torch.kernels import _common
        _common.METERS.append(self)
        ctx_mod.DRY_SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.distributed import ctx as ctx_mod
        from repro_torch.kernels import _common
        _common.METERS.remove(self)
        ctx_mod.DRY_SINKS.remove(self)
        return super().__exit__(*exc)

    def charge(self, name: str, nbytes: int, flops: int, dtype) -> None:
        """One kernel call (kernels._common.meta_call)."""
        self.kernel_bytes += int(nbytes)
        self.kernel_flops[str(dtype).replace("torch.", "")] += int(flops)
        self.kernel_charges.append((name, int(nbytes), int(flops)))

    def collective(self, kind: str, method: str, nbytes: int) -> None:
        """One collective of the dry backend (distributed/ctx.py)."""
        self.collective_bytes[kind] += int(nbytes)
        self.collective_counts[kind] += 1
        self.collective_calls[method] += 1

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_view(func):
            return out
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        packet = func._overloadpacket
        if packet in self._registry:
            dt = ins[0].dtype if ins else torch.float32
            self.product_flops[str(dt).replace("torch.", "")] += int(
                self._registry[packet](*args, **kwargs, out_val=out))
        if name not in _ALLOC_OPS:
            self.traced_bytes += sum(t.numel() * t.element_size()
                                     for t in ins + outs)
        if not func._schema.is_mutable:
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in self._live or key in self._arg_keys:
                    continue
                self._live[key] = st.nbytes()
                self.live_bytes += st.nbytes()
                weakref.finalize(st, self._free, key)
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self.live_bytes)
        return out

    # ---- the record -----------------------------------------------------
    def finish(self, out) -> dict:
        """The counts as a record, `out` the step's result (its storages
        that are not arguments' are the step's outputs)."""
        arg_bytes = distinct_bytes(self.args)
        seen = {}
        for t in _tensors(out):
            k = storage_key(t)
            if k not in self._arg_keys:
                seen.setdefault(k, t.untyped_storage().nbytes())
        out_bytes = sum(seen.values())
        flops = {d: self.product_flops.get(d, 0) + self.kernel_flops.get(d, 0)
                 for d in set(self.product_flops) | set(self.kernel_flops)}
        # a dtype without a tensor-core rate here is priced as float32
        compute_s = sum(f / PEAK_FLOPS.get(getattr(torch, d),
                                           F32_3XTF32_FLOPS)
                        for d, f in flops.items())
        min_bytes = arg_bytes + out_bytes
        coll = dict(self.collective_bytes)
        coll_total = sum(coll.values())
        terms = {"compute_s": compute_s,
                 "memory_s": min_bytes / HBM_BYTES_S,
                 "collective_s": coll_total / NVLINK_BYTES_S}
        return {
            "flops_per_device": float(sum(flops.values())),
            "flops_by_dtype": flops,
            "product_flops": float(sum(self.product_flops.values())),
            "kernel_flops": float(sum(self.kernel_flops.values())),
            "bytes_per_device": float(self.traced_bytes + self.kernel_bytes),
            "kernel_bytes": float(self.kernel_bytes),
            "min_bytes_per_device": float(min_bytes),
            "collective_bytes_per_device": dict(
                coll, total=coll_total,
                counts=dict(self.collective_counts),
                calls=dict(self.collective_calls)),
            "kernel_calls": dict(Counter(n for n, _, _ in
                                         self.kernel_charges)),
            "memory_analysis": {"argument_bytes": arg_bytes,
                                "output_bytes": out_bytes,
                                "peak_live_bytes": self.peak_live_bytes},
            "roofline": {"terms": terms,
                         "dominant": max(terms, key=terms.get),
                         "time_s": max(terms.values())},
        }
