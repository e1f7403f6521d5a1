"""Rank context: the port's counterpart of the reference's `MeshCtx`
(src/repro/distributed/ctx.py).

The world is `ep × tp` processes, one rank each, laid out as
`jax.make_mesh((ep, tp), ("data", "model"))` orders its devices: rank =
e · tp + t. `data` is the expert-parallel (EP) axis, `model` the
tensor-parallel (TP) axis. Where XLA inserts the collectives for the
reference, the layers of the port call them here, explicitly, over
`torch.distributed` subgroups: `psum_model` / `pmax_model` /
`all_gather_model` over the ranks that share e, `all_to_all_data` /
`all_gather_data` / `psum_batch` / `gather_params` over the ranks that
share t.
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
reference's HLO names it ("all-reduce", "all-gather", "all-to-all",
"reduce-scatter").

Training over ranks (autograd). Where grad mode is on and the input
requires grad, every collective runs as a `torch.autograd.Function` with
its transpose; everywhere else (serving, its CUDA graphs, `no_grad`) it
is the bare call above, in place where it was. The transposes follow one
cotangent convention:

  every rank computes the whole loss (replicated over `model`; over
  `data` the global loss, each rank's rows summed into it); the cotangent
  of a tensor replicated over `model` is replicated, whole, on every
  rank, and the cotangent of a rank's shard is that shard's.

Inside a `model`-sharded region (an attention or Mamba-2 sublayer split by
heads, a dense or expert FFN split by width, the vocabulary-sharded head)
a tensor that every rank computes alike (the sublayer's normed input as
each branch reads it, the router's logits, Mamba-2's B/C rows, a 'wseq'
KV head several ranks read) gets only this rank's share of its cotangent;
the sum over `model` is the whole. Hence:

  psum_model            output replicated: backward the identity.
  enter_model           Megatron's "f" at a sharded region's entry:
                        identity forward, psum over `model` backward.
                        Before a psum_model whose sum feeds each rank's
                        own shard (rms_norm_over_model's sum of squares,
                        which each rank applies to its own channels) it
                        makes that psum's backward a psum too.
  all_gather_model /    backward takes this rank's slice.
  all_gather_data
  all_to_all_data       backward is the same tiled all_to_all (the op is
                        its own transpose); all_to_all_rows swaps its
                        send and receive counts.
  psum_batch            output replicated over `data` (the loss's global
                        sums, the expert counts): backward the identity.
  share_over_data       a loss each `data` rank computes whole from the
                        same replicated rows: identity forward, backward
                        times 1 / ep, so that summing the parameters'
                        gradients over `data` gives the gradient once.
  gather_params         FSDP: a parameter's `data`-sharded dim whole for
                        use. Backward: a reduce-scatter — every `data`
                        rank's share of the whole leaf's gradient summed,
                        this rank's slice kept. Not all_gather_data's
                        transpose, which only takes the rank's slice: the
                        leaf is one tensor every `data` rank reads whole,
                        so its gradient is the sum of their shares.

Each parameter's gradient is then this rank's share: whole for a
`model`-sharded leaf, partial over `data` for a leaf replicated over it
(the trainer sums it), and partial over `model` for a leaf that a sharded
region reads whole (the trainer sums it over the ranks that hold the same
part: `LM.grad_sync`). An FSDP slice's gradient leaves its backward
summed over `data` already (`gather_params`). On one rank every Function
is skipped (the identity), and on the dry backend each reports its bytes,
the backward's included.
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
    "psum_batch": "all-reduce", "pmax_batch": "all-reduce",
    "pmax_world": "all-reduce",
    "all_gather_model": "all-gather", "all_gather_data": "all-gather",
    "all_to_all_data": "all-to-all", "all_to_all_rows": "all-to-all",
    "gather_params": "all-gather", "scatter_grads": "reduce-scatter"}
# what the dry backend's collectives are reported to (a dry run's counter)
DRY_SINKS: list = []


def _dry(method: str, x: torch.Tensor) -> None:
    for sink in DRY_SINKS:
        sink.collective(COLLECTIVE_KINDS[method], method,
                        x.numel() * x.element_size())


def _grad_path(x: torch.Tensor) -> bool:
    """True where a collective must be differentiable: grad mode on and
    an input that requires grad."""
    return torch.is_grad_enabled() and x.requires_grad


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
        """Sum over the `model` axis, in place when x is contiguous (out of
        place on the autograd path, whose backward is the identity)."""
        if self.tp == 1:
            return x
        if _grad_path(x):
            return _Psum.apply(x, self, "model")
        return self._psum("model", x)

    def enter_model(self, x: torch.Tensor) -> torch.Tensor:
        """The entry of a `model`-sharded region (Megatron's "f"): x as it
        is, and on the autograd path a backward that sums x's cotangent
        over `model` (each rank's region adds only its share)."""
        if self.tp == 1 or not _grad_path(x):
            return x
        return _EnterModel.apply(x, self)

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the `model` axis, in place when x is
        contiguous: OmniAttn's top-k block scores, each rank's max over its
        own heads, become the max over every head (the reference's
        `ub.max(axis=(2, 3))` over all of them). No backward."""
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
        """The tp parts of a `model`-sharded dim, concatenated in t order.
        Backward: this rank's slice."""
        if self.tp == 1:
            return x
        if _grad_path(x):
            return _AllGather.apply(x, self, "model", dim)
        return self._gather("model", x, dim)

    def all_to_all_data(self, x: torch.Tensor) -> torch.Tensor:
        """`jax.lax.all_to_all(x, "data", 0, 0, tiled=True)`: dim 0 of x
        [ep·n, ...] splits into ep tiles, tile j goes to data rank j, and the
        tile from rank i lands at i. Backward: the same all_to_all."""
        if self.ep == 1:
            return x
        if _grad_path(x):
            return _AllToAll.apply(x, self, None, None)
        return self._all_to_all(x)

    def all_to_all_rows(self, x: torch.Tensor, send: list, recv: list
                        ) -> torch.Tensor:
        """An uneven all_to_all over `data`: send[j] rows of x (in j order)
        go to data rank j, recv[i] rows arrive from rank i (in i order).
        Backward: the all_to_all with send and recv swapped."""
        if self.ep == 1:
            return x
        if _grad_path(x):
            return _AllToAll.apply(x, self, list(send), list(recv))
        return self._all_to_all(x, send, recv)

    def all_gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ep parts of a `data`-sharded dim, in e order. Backward:
        this rank's rows."""
        if self.ep == 1:
            return x
        if _grad_path(x):
            return _AllGather.apply(x, self, "data", dim)
        return self._gather("data", x, dim)

    def gather_params(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """FSDP: the ep slices of a parameter whose dim `dim` is sharded
        over `data`, concatenated in e order into the whole leaf (one
        `all_gather_into_tensor`). Backward: one `reduce_scatter_tensor`
        of the whole leaf's cotangent — the sum over `data`, cut to this
        rank's slice. Raises on ep 1: a cut leaf without its group is a
        fault, never kept as it is."""
        if self.ep == 1:
            raise ValueError(f"gather_params of a leaf cut over data on "
                             f"ep 1 (shape {tuple(x.shape)}, dim {dim})")
        if _grad_path(x):
            return _GatherParams.apply(x, self, dim)
        return self._gather_params(x, dim)

    def psum_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis tokens are sharded on (`data`): the expert
        counts of a batch split over EP ranks, the loss's global sums.
        Backward: the identity (the sum is replicated over `data`)."""
        if self.ep == 1:
            return x
        if _grad_path(x):
            return _Psum.apply(x, self, "data")
        return self._psum("data", x)

    def pmax_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over `data`, in place when x is contiguous (a
        slot leaf's int8 gradient scale). No backward."""
        if self.ep == 1:
            return x
        if self.backend == "dry":
            _dry("pmax_batch", x)
            return x
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.data_group)
        return x

    def share_over_data(self, loss: torch.Tensor) -> torch.Tensor:
        """A loss that every `data` rank computes whole, from the same
        replicated rows: the loss as it is, and a backward that gives each
        rank 1 / ep of the cotangent, so that the trainer's sum over
        `data` counts the gradient once (an expert slot, which every rank
        dispatches its copy of the rows to, sums the ep shares itself)."""
        if self.ep == 1 or not _grad_path(loss):
            return loss
        return _ShareOverData.apply(loss, self.ep)

    # ---- the bare calls -------------------------------------------------
    def _group(self, axis: str):
        return self.model_group if axis == "model" else self.data_group

    def _psum(self, axis: str, x: torch.Tensor) -> torch.Tensor:
        if self.backend == "dry":
            _dry("psum_model" if axis == "model" else "psum_batch", x)
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self._group(axis))
        return x

    def _gather(self, axis: str, x: torch.Tensor, dim: int) -> torch.Tensor:
        n = self.size(axis)
        if self.backend == "dry":
            _dry(f"all_gather_{axis}", x)
            return torch.cat([x] * n, dim=dim)
        return _all_gather(x, dim, n, self._group(axis))

    def _gather_params(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        n = self.ep
        if self.backend == "dry":
            _dry("gather_params", x)
            return torch.cat([x] * n, dim=dim)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.data_group)
        return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)

    def _scatter_grads(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        n = self.ep
        shape = list(g.shape)
        shape[dim] //= n
        if self.backend == "dry":
            _dry("scatter_grads", g)
            return g.new_empty(shape)
        parts = g.contiguous() if dim == 0 else \
            torch.cat(g.chunk(n, dim=dim), 0)
        out = g.new_empty(shape)
        dist.reduce_scatter_tensor(out, parts, group=self.data_group)
        return out

    def _all_to_all(self, x: torch.Tensor, send: Optional[list] = None,
                    recv: Optional[list] = None) -> torch.Tensor:
        if send is None:
            if self.backend == "dry":
                _dry("all_to_all_data", x)
                return torch.empty_like(x)
            x = x.contiguous()
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.data_group)
            return out
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        if self.backend == "dry":
            _dry("all_to_all_rows", x)
            return out
        dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                               input_split_sizes=send, group=self.data_group)
        return out

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


# ---- the autograd Functions (module docstring: the convention) ----------
# Inside forward and backward grad mode is off, so the RankCtx methods they
# call take the bare paths; each forward reduces a copy, never its input.
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, rctx, axis):
        return rctx._psum(axis, x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(fc, g):
        return g, None, None


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, rctx):
        fc.rctx = rctx
        return x.view_as(x)

    @staticmethod
    def backward(fc, g):
        return fc.rctx._psum("model", g.clone(
            memory_format=torch.contiguous_format)), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, rctx, axis, dim):
        fc.coord, fc.n, fc.dim = rctx.coord(axis), x.shape[dim], dim
        return rctx._gather(axis, x, dim)

    @staticmethod
    def backward(fc, g):
        return g.narrow(fc.dim, fc.coord * fc.n, fc.n), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, rctx, send, recv):
        fc.rctx, fc.send, fc.recv = rctx, send, recv
        return rctx._all_to_all(x, send, recv)

    @staticmethod
    def backward(fc, g):
        return fc.rctx._all_to_all(g, fc.recv, fc.send), None, None, None


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, rctx, dim):
        fc.rctx, fc.dim = rctx, dim
        return rctx._gather_params(x, dim)

    @staticmethod
    def backward(fc, g):
        return fc.rctx._scatter_grads(g, fc.dim), None, None


class _ShareOverData(torch.autograd.Function):
    @staticmethod
    def forward(fc, loss, ep):
        fc.ep = ep
        return loss.view_as(loss)

    @staticmethod
    def backward(fc, g):
        return g / fc.ep, None
