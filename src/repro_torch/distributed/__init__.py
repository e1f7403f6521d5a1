"""Multi-rank placement of the port: the rank context (`RankCtx`) with
its `data` (EP) and `model` (TP) subgroups and explicit collectives."""
from repro_torch.distributed.ctx import RankCtx

__all__ = ["RankCtx"]
