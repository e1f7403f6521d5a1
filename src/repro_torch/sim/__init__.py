"""The cluster simulator of the port: a copy of the reference's
src/repro/sim/ bound to the port's OmniProxy (`core.proxy`) and
OmniPlacement scheduler (`core.placement`). It is pure Python and numpy
and runs no device code.

It models the paper's deployment, Ascend 910C nodes serving DeepSeek-R1
INT8 (`hardware.py`), to reproduce the paper's Tables 1-2. Its times,
QPM, TTFT and TPOT are that model's figures, not measurements of any card
and not H100 numbers."""
from repro_torch.sim.cluster import ClusterSim, SimConfig
from repro_torch.sim.hardware import AscendNodeModel, DeepSeekR1Model
from repro_torch.sim.workload import WorkloadConfig, closed_loop_requests

__all__ = ["ClusterSim", "SimConfig", "AscendNodeModel", "DeepSeekR1Model",
           "WorkloadConfig", "closed_loop_requests"]
