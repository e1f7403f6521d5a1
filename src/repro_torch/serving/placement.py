"""DevicePlacement — the device layer every serving engine is built through,
and the choke point of its hot loops.

It holds the torch device (cuda unless the caller asks for the CPU) and
the `RankCtx` (`ctx`): one rank by default, or, through `build(tp, ep)`,
this process's rank of an `ep × tp` world over `torch.distributed` —
`data` the expert-parallel axis, `model` the tensor-parallel one, as in
the reference's `DevicePlacement` (src/repro/serving/placement.py). Each
rank holds its shard of the parameters (`place_params`, `transfer_params`,
cut by `LM.param_cuts`) and its KV heads of every arena block
(`stack.head_layout`: K / tp under 'kv', the one shared head under
'wseq', all of them for a replicated sublayer); slot state, block tables
and host bookkeeping are replicated.

`hot_loop` is the port's counterpart of the reference's `donate_jit` and
`HotLoopRegistry` (src/repro/serving/placement.py): every serving step that
runs once per decode round or prefill chunk is built through it. Where the
reference compiles one XLA program per shape, an entry captures one CUDA
graph per key on `cuda` and replays it: the first call for a key runs the
step eagerly (a real step, and the warm-up: modules load, the allocator
settles), the second captures it on a side stream and replays the graph
once to do that step's work, and every later call only replays. The key
carries every Python value that reaches a captured op; everything else the
step reads or writes lives as long as the engine and is updated in place.
All graphs of one placement share one memory pool. The kernels' launch
counters live in Python, so an entry takes back what the capture added to
them (it launched nothing) and adds those deltas at every replay.

`capture=False` runs the same entries eagerly on the card. It exists only
so that tests and chip_smoke.py can compare the two modes (as
`jax.disable_jit` does for the reference); nothing chooses it on its own.
On the CPU the entries run eagerly and still count their calls per key;
`capture=True` there raises. A failed capture or replay raises: it never
falls back to eager. Over NCCL the collectives inside a step are
captured with it (warmed by the first, eager call) — the psums and
all_to_alls of every layer and, with online top-k at tp > 1, each paged
full layer's `pmax_model` of its [B, nb] block scores between the two
block-topk launches; it adds no key and no static buffer, since its
scores are a temporary of the step. gloo's cannot be captured, so a gloo
placement on the card takes capture=False explicitly.
"""
from __future__ import annotations

import gc
from collections import Counter
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Callable, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.ctx import RankCtx
from repro_torch.kernels._common import (add_launch_counts, count_delta,
                                         launch_counts)
from repro_torch.models.lm import SLOT_LEAVES


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _flat(tree: dict) -> dict:
    """A parameter tree's leaves by name ("embed", "layers.3.wq", ...)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


def _shapes(lm, local: bool = False) -> dict:
    """{leaf name: shape} of `lm`'s parameters: the whole model's, or with
    `local` this rank's part (each dim cut by `param_cuts`)."""
    cuts = _flat(lm.param_cuts())
    return {k: tuple(c[1] if local and c is not None else n
                     for n, c in zip(d[0], cuts[k]))
            for k, d in _flat(lm.param_defs()).items()}


def shard_leaf(t: torch.Tensor, cut: tuple) -> torch.Tensor:
    """This rank's part of a whole leaf: each dim with a (start, length)
    in `cut` (`LM.param_cuts`) narrowed to it."""
    for d, c in enumerate(cut):
        if c is not None:
            t = t.narrow(d, *c)
    return t.contiguous()


def _signature(static_inputs: tuple) -> tuple:
    return tuple((x.data_ptr(), tuple(x.shape), x.dtype)
                 if isinstance(x, torch.Tensor) else x
                 for x in static_inputs)


@dataclass
class HotLoopEntry:
    """One serving step built through `DevicePlacement.hot_loop`, called as
    `entry(key, static_inputs)`: `fn(key, *static_inputs)` on an eager
    call. `static_inputs` are the tensors the step reads or writes that
    the caller hands it (its table, its static outputs); a key's first
    call fixes them, and a later call with other storage raises. fn must
    write every result into tensors allocated outside the capture and
    return those."""
    name: str
    fn: Callable
    placement: "DevicePlacement"
    eager: Counter = field(default_factory=Counter)      # key → calls
    captures: Counter = field(default_factory=Counter)
    replays: Counter = field(default_factory=Counter)
    graphs: dict = field(default_factory=dict)     # key → CUDAGraph
    outputs: dict = field(default_factory=dict)    # key → fn's result
    deltas: dict = field(default_factory=dict)     # key → counts a replay adds
    inputs: dict = field(default_factory=dict)     # key → static signature

    @property
    def keys(self) -> list:
        return list(self.inputs)

    def __call__(self, key, static_inputs: tuple = ()):
        static_inputs = tuple(static_inputs)
        sig = _signature(static_inputs)
        if key not in self.inputs:
            self.inputs[key] = sig
        elif sig != self.inputs[key]:
            raise RuntimeError(
                f"hot loop '{self.name}', key {key}: static inputs changed "
                f"storage since the key's first call")
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            add_launch_counts(self.deltas[key])
            self.replays[key] += 1
            return self.outputs[key]
        if not self.placement.capture or self.eager[key] == 0:
            self.eager[key] += 1
            return self.fn(key, *static_inputs)
        return self._capture(key, static_inputs)

    def _capture(self, key, static_inputs: tuple):
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # a dead server's graphs must not be freed mid-capture (freeing a
        # graph invalidates the capture): collect them first, and keep the
        # collector off while capturing
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.placement.graph_pool):
                out = self.fn(key, *static_inputs)
        finally:
            gc.enable()
        delta = count_delta(before, launch_counts())
        add_launch_counts(delta, sign=-1)      # the capture launched nothing
        self.graphs[key], self.outputs[key] = graph, out
        self.deltas[key] = delta
        self.captures[key] += 1
        graph.replay()
        add_launch_counts(delta)
        self.replays[key] += 1
        return out

    def summary(self) -> dict:
        return {"keys": self.keys, "eager": sum(self.eager.values()),
                "captures": sum(self.captures.values()),
                "replays": sum(self.replays.values())}


@dataclass
class HotLoopRegistry:
    entries: list = field(default_factory=list)

    def add(self, entry: HotLoopEntry) -> HotLoopEntry:
        self.entries.append(entry)
        return entry

    def names(self) -> list:
        return [e.name for e in self.entries]

    def called(self) -> list:
        return [e for e in self.entries if e.inputs]

    def summary(self) -> dict:
        """{entry name: {"keys", "eager", "captures", "replays",
        "replays_each"}}: summed over the entries of one name (one per
        engine), and each entry's replays in the order the engines
        registered them."""
        out: dict = {}
        for e in self.entries:
            s = e.summary()
            acc = out.setdefault(e.name, {"keys": [], "eager": 0,
                                          "captures": 0, "replays": 0,
                                          "replays_each": []})
            acc["keys"] += [k for k in s["keys"] if k not in acc["keys"]]
            for k in ("eager", "captures", "replays"):
                acc[k] += s[k]
            acc["replays_each"].append(s["replays"])
        return out


@dataclass(frozen=True)
class DevicePlacement:
    device: torch.device
    capture: Optional[bool] = None     # None → on for cuda, off for the CPU
    ctx: RankCtx = RankCtx()

    def __post_init__(self):
        on_cuda = self.device.type == "cuda"
        gloo_cuda = on_cuda and self.ctx.backend == "gloo"
        if self.capture is None:
            if gloo_cuda:
                raise ValueError(
                    "gloo collectives cannot be captured in a CUDA graph: "
                    "pass capture=False for a gloo placement on the card")
            object.__setattr__(self, "capture", on_cuda)
        elif self.capture and not on_cuda:
            raise ValueError(f"CUDA-graph capture needs a CUDA device, not "
                             f"{self.device}")
        elif self.capture and gloo_cuda:
            raise ValueError("gloo collectives cannot be captured in a CUDA "
                             "graph (capture=True over gloo)")

    @staticmethod
    def build(tp: int = 1, ep: int = 1, device=None,
              backend: Optional[str] = None, *,
              capture: Optional[bool] = None,
              check_lockstep: bool = False) -> "DevicePlacement":
        """This process's placement in an (ep, tp) world: rank e · tp + t
        over the default process group, which must be initialised already
        with world size tp · ep (and `backend`, when given). `device` None
        → cuda:(rank mod the visible cards) over NCCL, which needs a card
        per rank, else cuda. `check_lockstep` makes the server compare a
        digest of its host decisions across ranks every round."""
        if backend is not None and dist.is_initialized() and \
                dist.get_backend() != backend:
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()}, not {backend}")
        ctx = RankCtx.build(tp, ep, check_lockstep=check_lockstep)
        if ctx.backend == "nccl":
            n = torch.cuda.device_count()
            if n < ctx.world:
                raise RuntimeError(
                    f"nccl needs a card per rank: {ctx.world} ranks, {n} "
                    f"visible (use gloo to share a card)")
            if device is None:
                device = torch.device("cuda", ctx.rank % n)
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return DevicePlacement(dev, capture, ctx)

    @staticmethod
    def of(obj: Union[None, str, torch.device, "DevicePlacement"] = None,
           *, capture: Optional[bool] = None) -> "DevicePlacement":
        """None → cuda; a device name or torch.device; or a placement.
        `capture` None → on for cuda (see the module docstring)."""
        if isinstance(obj, DevicePlacement):
            if capture is not None and capture != obj.capture:
                raise ValueError(f"placement has capture={obj.capture}, "
                                 f"asked for {capture}")
            return obj
        return DevicePlacement(resolve_device(obj), capture)

    def place_params(self, params, lm=None):
        """Every tensor of a parameter tree on this placement's device. Over
        several ranks (`lm`, built on this placement, then required) the
        tree is either one-rank parameters (`lm.one_rank()`'s shapes:
        `LM.init`, a bridged tree, a checkpoint restore), carried into this
        rank's part by `transfer_params`, or this rank's part already (what
        `transfer_params` returns); any other tree raises."""
        if self.ctx.world == 1:
            return _to(params, self.device)
        if lm is None:
            raise ValueError("place_params over several ranks needs the LM "
                             "(its param_cuts)")
        got = {k: tuple(v.shape) for k, v in _flat(params).items()}
        one = lm.one_rank()
        whole, local = _shapes(one), _shapes(lm, local=True)
        if got == whole:
            return self.transfer_params(one, params, lm)
        if got == local:
            return _to(params, self.device)
        bad = sorted(set(got) ^ set(local))
        if bad:
            raise ValueError(f"parameter tree does not match {lm.cfg.arch_id}"
                             f": leaves {bad[:4]} differ")
        k = next((k for k in local if got[k] not in (local[k], whole[k])),
                 None)
        if k is None:
            raise ValueError("parameter tree mixes one-rank and rank-local "
                             "leaves")
        raise ValueError(
            f"parameter {k} has shape {got[k]}: neither the one-rank "
            f"{whole[k]} nor this rank's {local[k]} (tp {self.ctx.tp}, ep "
            f"{self.ctx.ep})")

    def transfer_params(self, lm_src, params, lm_dst):
        """Whole parameters laid out for `lm_src` (one rank, or the whole
        [ep, s, ...] slot layout of its ctx.ep) → this rank's part for
        `lm_dst`, built on this placement, on its device (the reference's
        `DevicePlacement.transfer_params`, src/repro/serving/placement.py:
        265-300). Only the MoE slot tensors depend on the layout: each of
        this rank's destination slots takes its expert's canonical rows,
        found through the source replica tables' first replica, then every
        leaf is cut by `lm_dst.param_cuts()` (whole heads for attention and
        Mamba-2 leaves). Leaf by leaf: nothing larger than one whole leaf
        is built."""
        if lm_dst.device != self.device or lm_dst.ctx != self.ctx:
            raise ValueError("lm_dst is not built on this placement")
        ctx, dev = self.ctx, self.device
        specs = lm_dst.param_cuts()
        cut = lambda t, c: shard_leaf(t, c).to(dev)
        out = {k: cut(v, specs[k]) for k, v in params.items()
               if k != "layers"}
        slots = None
        if lm_dst.cfg.moe.n_experts:
            src_t = lm_src.default_tables()
            rr = src_t["rep_rank"][:, 0].long().cpu()
            rs = src_t["rep_slot"][:, 0].long().cpu()
            se = lm_dst.default_tables()["slot_expert"][ctx.e].long().cpu()
            slots = (rr, rs, se)
        layers = []
        for p, sp in zip(params["layers"], specs["layers"]):
            q = {}
            for k, v in p.items():
                if k in SLOT_LEAVES:
                    rr, rs, se = slots
                    x = se.clamp(min=0)
                    rows = v[rr[x].to(v.device), rs[x].to(v.device)]
                    rows = rows * (se >= 0).to(v.device, v.dtype).view(
                        -1, *([1] * (v.ndim - 2)))
                    q[k] = cut(rows[None], (None,) + sp[k][1:])
                else:
                    q[k] = cut(v, sp[k])
            layers.append(q)
        out["layers"] = layers
        return out

    # ---- the hot-loop choke point --------------------------------------
    @cached_property
    def hot_loops(self) -> HotLoopRegistry:
        """Every entry built through `hot_loop` (one registry per
        placement, i.e. per server)."""
        return HotLoopRegistry()

    @cached_property
    def graph_pool(self) -> Any:
        """The memory pool every graph of this placement is captured into."""
        return torch.cuda.graph_pool_handle()

    def hot_loop(self, fn: Callable, *, name: str) -> HotLoopEntry:
        """Build a serving step through the choke point: → the registered
        entry, called as `entry(key, static_inputs)`."""
        return self.hot_loops.add(HotLoopEntry(name=name, fn=fn,
                                               placement=self))

    def graph_pool_bytes(self) -> int:
        """Bytes the CUDA caching allocator holds in this placement's graph
        pool (0 before the first capture, and off the card)."""
        if not self.capture or "graph_pool" not in self.__dict__:
            return 0
        pool = tuple(self.graph_pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)
