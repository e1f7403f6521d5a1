from repro_torch.core.proxy.radix import RadixTree
from repro_torch.core.proxy.lifecycle import Phase, Request
from repro_torch.core.proxy.oas import InstanceStats, OASConfig, OmniProxy
from repro_torch.core.proxy.metrics import MetricsAggregator
from repro_torch.core.proxy.params import (GREEDY, BackpressureError, RequestOutput,
                                     SamplingParams, device_row, seed_key)

__all__ = ["RadixTree", "Phase", "Request", "InstanceStats", "OASConfig",
           "OmniProxy", "MetricsAggregator", "SamplingParams",
           "RequestOutput", "BackpressureError", "GREEDY", "device_row",
           "seed_key"]
