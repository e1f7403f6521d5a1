"""Rank layouts of the port: its counterpart of the reference's
src/repro/launch/mesh.py.

The reference builds a `jax.make_mesh` over (data, model) axes; its
default meshes are TPU pods (16x16 and 2x16x16). The port's world is one
process a rank, `ep × tp` of them (distributed/ctx.py: `data` is the
expert-parallel axis, `model` tensor parallelism), and its default layouts
are the chip counts its runs use: one card, and four cards as (ep 1, tp 4)
and (ep 2, tp 2). `parse_mesh_shape` takes any other as "EPxTP".
"""
from __future__ import annotations

from repro_torch.distributed.ctx import RankCtx

# (ep, tp) of the dry run's default layouts
DEFAULT_LAYOUTS = ((1, 1), (1, 4), (2, 2))


def parse_mesh_shape(text: str) -> tuple:
    """"EPxTP" (e.g. "1x8") → (ep, tp)."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                  for p in parts):
        raise ValueError(f"mesh shape {text!r} is not EPxTP, e.g. 2x2")
    return int(parts[0]), int(parts[1])


def layout_name(ep: int, tp: int) -> str:
    return f"ep{ep}_tp{tp}"


def make_production_ctx(*, tp: int = 1, ep: int = 1,
                        check_lockstep: bool = False) -> RankCtx:
    """This process's rank of an (ep, tp) world over the default process
    group, which the caller has initialised with world size tp · ep
    (`torch.distributed.init_process_group`); one rank needs none."""
    if tp * ep == 1:
        return RankCtx.local()
    return RankCtx.build(tp, ep, check_lockstep=check_lockstep)


def dry_ctx(tp: int = 1, ep: int = 1, rank: int = 0) -> RankCtx:
    """Rank `rank` of an (ep, tp) world for a dry run on meta tensors: the
    layout alone, with the dry backend's collectives and no process
    group."""
    return RankCtx.dry(tp, ep, rank)
