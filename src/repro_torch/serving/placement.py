"""DevicePlacement — the device layer every serving engine is built through,
and the choke point of its hot loops.

On this slice it is single-device: it holds the torch device (cuda unless
the caller asks for the CPU) and moves parameter trees onto it.

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
falls back to eager. Multi-device (TP/EP) placement comes with a later
slice.
"""
from __future__ import annotations

import gc
from collections import Counter
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._common import (add_launch_counts, count_delta,
                                         launch_counts)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


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

    def __post_init__(self):
        on_cuda = self.device.type == "cuda"
        if self.capture is None:
            object.__setattr__(self, "capture", on_cuda)
        elif self.capture and not on_cuda:
            raise ValueError(f"CUDA-graph capture needs a CUDA device, not "
                             f"{self.device}")

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

    def place_params(self, params):
        """Every tensor of a parameter tree on this placement's device."""
        return _to(params, self.device)

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
