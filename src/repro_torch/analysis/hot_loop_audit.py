"""ContractGuard layer 2 for the port — the live hot-loop auditor.

Layer 1 reads source; this layer watches what a step actually ran. Every
serving step built through `DevicePlacement.hot_loop` lands in the
placement's `HotLoopRegistry`. The reference's auditor
(src/repro/analysis/jaxpr_audit.py) re-traces each entry from abstract
arguments; the port has no trace to re-read, and its entries write their
arenas in place, so this auditor observes real calls and never runs a step
a second time. Attached to a registry (`audit_placement` / `audit_server`,
as a context manager around serving), it runs each entry key's first call
— an eager call in every mode: on the card it is also the warm-up before
the key's capture; with capture off, later calls of the key are not
watched — under a `TorchDispatchMode` that sees every aten op of the step
(on the card also under `torch.cuda.set_sync_debug_mode("error")`, except
over gloo, whose collectives synchronise their own streams). A graph
replay is never audited: it replays exactly what its capture recorded, and
a capture cannot contain a sync. The hand-written kernels are ctypes
calls, invisible to a dispatch mode; per key the auditor reports the
kernel launches of the call from the launch counters' deltas instead.

Checks on each observed call:

  · **purity** — no op that needs the host: `_local_scalar_dense`
    (`.item()`, `int(t)`), `nonzero`, `masked_select`, the `unique`
    family, `is_nonzero`, `equal`, `repeat_interleave` of a repeats tensor
    without `output_size`, and any op that turns a device tensor into a
    CPU one (`.cpu()`, `.to("cpu")`, a copy into a host tensor);
  · **f64** — no op output is float64 or complex128;
  · **quant-upcast** — where the entry's static inputs or arenas hold
    int8 KV payloads (ndim ≥ 4), no freshly allocated float op output
    carries the trailing [N, K, bs, h] shape of a whole int8 leaf: the
    arena was upcast in memory instead of dequantized in-tile (the
    reference's check, src/repro/analysis/jaxpr_audit.py:183-215);
  · **in-place** — the counterpart of donation: every arena leaf (the
    entry's `arenas`: paged KV, rings, dense caches, Mamba-2 state) and
    static input keeps its `data_ptr` across the call, and no op allocates
    a tensor with the element count, dtype and last dim of a whole leaf of
    the shared paged arena (a full copy every step: a step gathers only
    its tabled blocks, a few of the pool's N, whereas a slot's ring blocks
    or dense cache are read whole every step, so they are not counted);
  · **rank-local** — the counterpart of out-shardings, at world > 1 with
    the model's config: every paged arena leaf holds this rank's
    `head_layout(cfg, tp).nk` KV heads, and every Mamba-2 state its
    `mamba_layout(cfg, tp)` heads and channels.

A finding is recorded before the op runs where it can be (purity), so a
step that then fails under the sync debug mode still leaves it; the
auditor catches no failure.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels._common import count_delta, launch_counts
from repro_torch.models.stack import head_layout, mamba_layout

HOST_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique",
            "_unique2", "unique_dim", "unique_consecutive",
            "unique_dim_consecutive", "is_nonzero", "equal"}
F64_DTYPES = (torch.float64, torch.complex128)
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclass
class AuditFinding:
    entry: str
    key: object
    check: str          # purity | f64 | quant-upcast | in-place | rank-local
    detail: str         # | called

    def format(self) -> str:
        return f"[{self.check}] {self.entry} {self.key!r}: {self.detail}"


@dataclass
class AuditReport:
    audited: list = field(default_factory=list)   # entry names observed
    skipped: list = field(default_factory=list)   # registered, not observed
    findings: list = field(default_factory=list)
    checks: dict = field(default_factory=dict)    # check → times performed
    # entry name → {"keys": keys observed, "ops": [ops a call], "launches":
    # [{counter: launches} a call]}, one list item per observed call
    entries: dict = field(default_factory=dict)
    seconds: float = 0.0    # host wall time of the observed calls, summed

    def ok(self) -> bool:
        return not self.findings

    def line(self) -> str:
        """One line: per entry its keys, ops and kernel launches a call."""
        parts = []
        for name, e in self.entries.items():
            ln = sorted({k.split(".")[0] + ":" + str(v)
                         for d in e["launches"] for k, v in d.items()})
            parts.append(f"{name}: {e['keys']} keys, ops a call "
                         f"{min(e['ops'])}-{max(e['ops'])}, launches a call "
                         + (",".join(ln) or "none"))
        return ("; ".join(parts) + f"; skipped {self.skipped or 'none'}; "
                f"checks " + ", ".join(f"{k}={v}" for k, v in
                                       sorted(self.checks.items()))
                + f"; {len(self.findings)} finding(s); observed calls "
                f"{self.seconds:.3f} s")

    def format(self) -> str:
        return "\n".join([f.format() for f in self.findings]
                         + [f"hot-loop audit: {self.line()}"])


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _OpWatch(TorchDispatchMode):
    """Every aten op of one call: counted, checked for host needs before
    it runs, and for f64 / whole-leaf outputs after."""

    def __init__(self, call: "_Call"):
        super().__init__()
        self.call = call

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.call
        c.ops += 1
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        if name in HOST_OPS:
            c.find("purity", f"`{func}` needs the host (a device->host "
                   f"sync)")
        elif name == "repeat_interleave" and func._overloadname != \
                "self_int" and kwargs.get("output_size") is None:
            c.find("purity", f"`{func}` without output_size reads its "
                   f"repeats on the host")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(t.device.type != "cpu" for t in ins) and \
                any(t.device.type == "cpu" for t in outs):
            c.find("purity", f"`{func}` copies a device tensor to the host")
        in_storages = {_storage(t) for t in ins}
        for t in outs:
            if t.dtype in F64_DTYPES:
                c.find("f64", f"`{func}` produces a {t.dtype} tensor "
                       f"{tuple(t.shape)}")
            if _storage(t) in in_storages:
                continue            # a view or an in-place write
            if (t.numel(), t.dtype, t.shape[-1:]) in c.leaf_sigs:
                c.find("in-place", f"`{func}` allocates {tuple(t.shape)} "
                       f"{t.dtype}: the element count of a whole paged "
                       f"arena leaf, a full copy every step")
            if t.dtype in FLOAT_DTYPES and t.ndim >= 4 \
                    and tuple(t.shape[-4:]) in c.int8_sigs:
                c.find("quant-upcast", f"`{func}` materializes a {t.dtype}"
                       f" tensor {tuple(t.shape)} with a quantized arena "
                       f"leaf's full block shape — the int8 arena was "
                       f"upcast in memory instead of dequantized in-tile")
        return out


@dataclass
class _Call:
    """One observed call's running state."""
    auditor: "HotLoopAuditor"
    entry: object
    key: object
    leaf_sigs: set = field(default_factory=set)
    int8_sigs: set = field(default_factory=set)
    ops: int = 0

    def find(self, check: str, detail: str) -> None:
        self.auditor.findings.append(
            AuditFinding(self.entry.name, self.key, check, detail))


def _arena_layers(entry) -> list:
    """The entry's arena layer entries (none without `arenas`)."""
    return [] if entry.arenas is None else entry.arenas()


def _leaves(layers) -> dict:
    """{"layer.leaf": tensor} of arena layer entries."""
    return {f"{i}.{n}": t for i, e in enumerate(layers) if e is not None
            for n, t in e.items() if isinstance(t, torch.Tensor)}


class HotLoopAuditor:
    """The live audit of one placement's hot loops. `attach()` hands it to
    the registry (every entry, and every one built later, calls `observe`
    on each key's first call); `detach()` takes it back; as a context
    manager it does both. `cfg` (the served model's config) arms the
    rank-local check at world > 1. `entries` narrows the audit to those
    entries (one server's, where servers share a placement); the others
    run unwatched."""

    def __init__(self, placement, cfg=None, require_called: bool = False,
                 entries: Optional[list] = None):
        self.placement = placement
        self.cfg = cfg
        self.require_called = require_called
        self.entries = entries
        self.findings: list = []
        self.checks: dict = {}
        # entry name → [(key, ops, launches, seconds)] of observed calls
        self.calls: dict = {}

    def attach(self) -> "HotLoopAuditor":
        self.placement.hot_loops.attach(self)
        return self

    def detach(self) -> None:
        self.placement.hot_loops.attach(None)

    def __enter__(self) -> "HotLoopAuditor":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()

    def _count(self, check: str) -> None:
        self.checks[check] = self.checks.get(check, 0) + 1

    def observe(self, entry, key, static_inputs: tuple):
        """Run `entry.fn(key, *static_inputs)` once, watched; → its
        result."""
        if self.entries is not None and \
                not any(entry is e for e in self.entries):
            return entry.fn(key, *static_inputs)
        layers = _arena_layers(entry)
        arenas = _leaves(layers)
        statics = [t for t in static_inputs if isinstance(t, torch.Tensor)]
        call = _Call(self, entry, key)
        # the shared paged arena's layers are the ones with block
        # summaries; a copy keeps a leaf's element count, dtype and last
        # dim whatever it does to the others
        call.leaf_sigs = {(t.numel(), t.dtype, t.shape[-1:])
                          for t in _leaves([e for e in layers if e is not None
                                            and "kmin" in e]).values()}
        call.int8_sigs = {tuple(t.shape[-4:])
                          for t in list(arenas.values()) + statics
                          if t.dtype == torch.int8 and t.ndim >= 4}
        for check in ("purity", "f64", "in-place") + (
                ("quant-upcast",) if call.int8_sigs else ()):
            self._count(check)
        self._check_rank_local(call, layers)
        ptrs = ({n: t.data_ptr() for n, t in arenas.items()},
                [t.data_ptr() for t in statics])
        dev = self.placement.device
        sync = dev.type == "cuda" and self.placement.ctx.backend != "gloo"
        before = launch_counts()
        t0 = time.perf_counter()
        mode = torch.cuda.get_sync_debug_mode() if sync else None
        if sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with _OpWatch(call):
                out = entry.fn(key, *static_inputs)
        finally:
            if sync:
                torch.cuda.set_sync_debug_mode(mode)
        seconds = time.perf_counter() - t0
        launches = count_delta(before, launch_counts())
        after = {n: t.data_ptr()
                 for n, t in _leaves(_arena_layers(entry)).items()}
        moved = sorted(n for n in ptrs[0] if after.get(n) != ptrs[0][n])
        moved += [f"static input {i}" for i, (t, p) in
                  enumerate(zip(statics, ptrs[1])) if t.data_ptr() != p]
        if moved:
            call.find("in-place", f"left its storage: {moved[:6]}")
        self.calls.setdefault(entry.name, []).append(
            (key, call.ops, launches, seconds))
        return out

    def _check_rank_local(self, call: _Call, layers: list) -> None:
        ctx = self.placement.ctx
        if self.cfg is None or ctx.world == 1 or not any(layers):
            return
        self._count("rank-local")
        nk = head_layout(self.cfg, ctx.tp).nk
        bad = []
        for e in (e for e in layers if e is not None):
            if "kmin" in e:          # a paged arena layer: [N, K, ...]
                bad += [f"{n} {tuple(t.shape)} (K {nk})"
                        for n, t in e.items() if t.shape[1] != nk]
            if "state" in e:         # a Mamba-2 layer
                ml = mamba_layout(self.cfg, ctx.tp)
                if e["state"].shape[1] != ml.nh:
                    bad.append(f"state {tuple(e['state'].shape)} (heads "
                               f"{ml.nh})")
                if e["conv_x"].shape[-1] != ml.nc:
                    bad.append(f"conv_x {tuple(e['conv_x'].shape)} "
                               f"(channels {ml.nc})")
        if bad:
            call.find("rank-local", f"not this rank's layout (tp "
                      f"{ctx.tp}): {bad[:4]}")

    def report(self) -> AuditReport:
        rep = AuditReport(findings=list(self.findings),
                          checks=dict(self.checks))
        scope = self.placement.hot_loops.entries if self.entries is None \
            else self.entries
        for name in dict.fromkeys(e.name for e in scope):
            calls = self.calls.get(name)
            if not calls:
                rep.skipped.append(name)
                if self.require_called:
                    rep.findings.append(AuditFinding(
                        name, None, "called", "registered but never "
                        "observed (not called while the audit was on)"))
                continue
            rep.audited.append(name)
            rep.entries[name] = {
                "keys": len({repr(c[0]) for c in calls}),
                "ops": [c[1] for c in calls],
                "launches": [c[2] for c in calls]}
            rep.seconds += sum(c[3] for c in calls)
        return rep


def audit_placement(placement, cfg=None, *, require_called: bool = False
                    ) -> HotLoopAuditor:
    """An auditor of every hot loop of `placement` — attach it (or use it
    as a context manager) before the entries' first calls, then read
    `report()`."""
    return HotLoopAuditor(placement, cfg, require_called)


def audit_server(server, *, require_called: bool = False) -> HotLoopAuditor:
    """An auditor of `server`'s own hot loops (its engines' entries: other
    servers may share its placement), with its config for the rank-local
    check."""
    engines = server.prefills + server.decodes
    own = [e for e in server.placement.hot_loops.entries
           if any(getattr(e.fn, "__self__", None) is g for g in engines)]
    return HotLoopAuditor(server.placement, server.cfg, require_called, own)
