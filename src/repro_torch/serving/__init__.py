from repro_torch.core.proxy.params import (BackpressureError, RequestOutput,
                                           SamplingParams)
from repro_torch.serving.arena import BlockHandoff, KVArena
from repro_torch.serving.decode import DecodeEngine
from repro_torch.serving.faults import FaultConfig, FaultPlane, FaultSpec
from repro_torch.serving.placement import DevicePlacement
from repro_torch.serving.prefill import (PrefillEngine, PrefillResult,
                                         PrefillTask)
from repro_torch.serving.server import Server, ServerConfig

__all__ = ["BlockHandoff", "DecodeEngine", "DevicePlacement", "KVArena",
           "PrefillEngine", "PrefillResult", "PrefillTask",
           "Server", "ServerConfig", "SamplingParams", "RequestOutput",
           "BackpressureError", "FaultConfig", "FaultPlane", "FaultSpec"]
