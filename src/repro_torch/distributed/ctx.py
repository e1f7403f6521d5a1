"""Rank context: the port's counterpart of the reference's `MeshCtx`
(src/repro/distributed/ctx.py).

The world is `ep × tp` processes, one rank each, laid out as
`jax.make_mesh((ep, tp), ("data", "model"))` orders its devices: rank =
e · tp + t. `data` is the expert-parallel (EP) axis, `model` the
tensor-parallel (TP) axis. Where XLA inserts the collectives for the
reference, the layers of the port call them here, explicitly, over
`torch.distributed` subgroups: `psum_model` / `pmax_model` /
`all_gather_model` over the ranks that share e, `all_to_all_data` /
`all_gather_data` / `psum_batch` over the ranks that share t.
`broadcast_floats`, `all_gather_ints` and `pmax_world` run over the whole
world: the server keeps its ranks in lockstep with the first two, and
takes every recovery decision that reads rank-local device state (which
arena blocks are corrupt) from the third.

`RankCtx.local()` is one rank and no process group: every collective is
the identity, so a one-rank model runs exactly as it did before TP and EP.

`RankCtx.dry(tp, ep, rank)` is one rank of a world that does not exist:
backend "dry", no process group. Its collectives take meta tensors and
return results of the right shape and dtype (a sum or max keeps its
input's, a gather concatenates copies, an all_to_all keeps its shape), and
tell each sink in DRY_SINKS what this rank would send (launch/cost.py's
counter is one): `sink.collective(kind, method, bytes)`, the kind as the
reference's HLO names it ("all-reduce", "all-gather", "all-to-all").
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any, Optional

import torch
import torch.distributed as dist


# RankCtx method → the collective kind it runs
COLLECTIVE_KINDS = {
    "psum_model": "all-reduce", "pmax_model": "all-reduce",
    "psum_batch": "all-reduce", "pmax_world": "all-reduce",
    "all_gather_model": "all-gather", "all_gather_data": "all-gather",
    "all_to_all_data": "all-to-all", "all_to_all_rows": "all-to-all"}
# what the dry backend's collectives are reported to (a dry run's counter)
DRY_SINKS: list = []


def _dry(method: str, x: torch.Tensor) -> None:
    for sink in DRY_SINKS:
        sink.collective(COLLECTIVE_KINDS[method], method,
                        x.numel() * x.element_size())


@dataclass(frozen=True)
class RankCtx:
    ep: int = 1
    tp: int = 1
    rank: int = 0
    backend: Optional[str] = None     # None: one rank, no process group
    data_group: Any = None            # the ep ranks that share t
    model_group: Any = None           # the tp ranks that share e
    check_lockstep: bool = False      # the server compares a digest a round

    # ---- constructors -------------------------------------------------
    @staticmethod
    def local() -> "RankCtx":
        return RankCtx()

    @staticmethod
    def dry(tp: int = 1, ep: int = 1, rank: int = 0) -> "RankCtx":
        """Rank `rank` of an (ep, tp) world without a process group: the
        layout of a dry run on meta tensors (launch/dryrun.py). Its
        collectives compute nothing; they return right-shaped results and
        report their bytes to DRY_SINKS."""
        if tp < 1 or ep < 1 or not 0 <= rank < tp * ep:
            raise ValueError(f"tp={tp}, ep={ep}, rank={rank}")
        return RankCtx(ep, tp, rank, "dry")

    @staticmethod
    def build(tp: int = 1, ep: int = 1, *,
              check_lockstep: bool = False) -> "RankCtx":
        """The (ep, tp) context of this process over the default process
        group, which must be initialised already with world size tp · ep.
        Every rank calls this in the same order: `new_group` is collective."""
        if tp < 1 or ep < 1:
            raise ValueError(f"tp={tp}, ep={ep}: both must be >= 1")
        if not dist.is_initialized():
            raise RuntimeError(
                f"tp={tp}, ep={ep} needs an initialised process group "
                f"(torch.distributed.init_process_group with world size "
                f"{tp * ep})")
        world = dist.get_world_size()
        if world != tp * ep:
            raise ValueError(f"world size {world} != tp {tp} x ep {ep}")
        rank = dist.get_rank()
        data = model = None
        for e in range(ep):
            g = dist.new_group([e * tp + t for t in range(tp)])
            if rank // tp == e:
                model = g
        for t in range(tp):
            g = dist.new_group([e * tp + t for e in range(ep)])
            if rank % tp == t:
                data = g
        return RankCtx(ep, tp, rank, dist.get_backend(), data, model,
                       check_lockstep)

    # ---- facts ---------------------------------------------------------
    @property
    def world(self) -> int:
        return self.ep * self.tp

    @property
    def e(self) -> int:               # this rank's coordinate on `data`
        return self.rank // self.tp

    @property
    def t(self) -> int:               # this rank's coordinate on `model`
        return self.rank % self.tp

    def size(self, axis: Optional[str]) -> int:
        return {"data": self.ep, "model": self.tp}.get(axis, 1)

    def coord(self, axis: str) -> int:
        return {"data": self.e, "model": self.t}[axis]

    def part_if(self, axis: Optional[str], dim_size: int):
        """`axis` if dim_size divides over it, else None (replicated) — the
        reference's `MeshCtx.part_if` for one axis name."""
        if axis is None:
            return None
        return axis if dim_size % self.size(axis) == 0 else None

    @cached_property
    def host_device(self) -> torch.device:
        """Where the world-group host values travel: NCCL moves only CUDA
        tensors, gloo takes CPU ones."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    # ---- collectives (identities on one rank) ---------------------------
    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the `model` axis, in place when x is contiguous."""
        if self.tp == 1:
            return x
        if self.backend == "dry":
            _dry("psum_model", x)
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.model_group)
        return x

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the `model` axis, in place when x is
        contiguous: OmniAttn's top-k block scores, each rank's max over its
        own heads, become the max over every head (the reference's
        `ub.max(axis=(2, 3))` over all of them)."""
        if self.tp == 1:
            return x
        if self.backend == "dry":
            _dry("pmax_model", x)
            return x
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.model_group)
        return x

    def all_gather_model(self, x: torch.Tensor, dim: int = -1
                         ) -> torch.Tensor:
        """The tp parts of a `model`-sharded dim, concatenated in t order."""
        if self.tp == 1:
            return x
        if self.backend == "dry":
            _dry("all_gather_model", x)
            return torch.cat([x] * self.tp, dim=dim)
        return _all_gather(x, dim, self.tp, self.model_group)

    def all_to_all_data(self, x: torch.Tensor) -> torch.Tensor:
        """`jax.lax.all_to_all(x, "data", 0, 0, tiled=True)`: dim 0 of x
        [ep·n, ...] splits into ep tiles, tile j goes to data rank j, and the
        tile from rank i lands at i."""
        if self.ep == 1:
            return x
        if self.backend == "dry":
            _dry("all_to_all_data", x)
            return torch.empty_like(x)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.data_group)
        return out

    def all_to_all_rows(self, x: torch.Tensor, send: list, recv: list
                        ) -> torch.Tensor:
        """An uneven all_to_all over `data`: send[j] rows of x (in j order)
        go to data rank j, recv[i] rows arrive from rank i (in i order)."""
        if self.ep == 1:
            return x
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        if self.backend == "dry":
            _dry("all_to_all_rows", x)
            return out
        dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                               input_split_sizes=send, group=self.data_group)
        return out

    def all_gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.ep == 1:
            return x
        if self.backend == "dry":
            _dry("all_gather_data", x)
            return torch.cat([x] * self.ep, dim=dim)
        return _all_gather(x, dim, self.ep, self.data_group)

    def psum_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis tokens are sharded on (`data`): the expert
        counts of a batch split over EP ranks."""
        if self.ep == 1:
            return x
        if self.backend == "dry":
            _dry("psum_batch", x)
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.data_group)
        return x

    def pmax_world(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over every rank of the world (the identity on
        one rank): FaultPlane's corruption mask and its "written anywhere"
        bit, each rank's view of its own KV heads, become the union over
        all of them. A bool tensor travels as int32 (NCCL reduces no bool)
        and comes back bool; other tensors are reduced in place when
        contiguous."""
        if self.world == 1:
            return x
        if self.backend == "dry":
            _dry("pmax_world", x)
            return x
        y = x.to(torch.int32) if x.dtype == torch.bool else x.contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y.bool() if x.dtype == torch.bool else y

    def broadcast_floats(self, values: list) -> list:
        """Rank 0's float64 values on every rank (one broadcast over the
        world)."""
        if self.world == 1 or self.backend == "dry":
            return list(values)
        t = torch.tensor(values, dtype=torch.float64,
                         device=self.host_device)
        dist.broadcast(t, src=0)
        return t.tolist()

    def all_gather_ints(self, values: list) -> list:
        """Every rank's int64 values, in rank order."""
        if self.world == 1:
            return [list(values)]
        if self.backend == "dry":
            return [list(values) for _ in range(self.world)]
        t = torch.tensor(values, dtype=torch.int64, device=self.host_device)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return [p.tolist() for p in parts]


def _all_gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
