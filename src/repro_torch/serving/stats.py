"""Device-side stat accumulators: the shared drain pattern.

Engine counters that accumulate on the device (a tensor in the decode
engine's slot-state dict that each step adds to) are fetched and reset only
at monitor ticks or at the end of a run, never in the per-step loop, so a
decode step keeps exactly one device→host fetch (`host_fetches == steps`).
The online-sparsity, speculation and MoE expert-count windows all drain
through this one helper.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def drain_accumulator(state: dict, key: str) -> Optional[np.ndarray]:
    """Fetch the accumulator `state[key]` as float64 numpy and zero it in
    place. None when the accumulator was never installed. This is a HOST
    SYNC — call it at monitor ticks / run end, never per step."""
    acc = state.get(key)
    if acc is None:
        return None
    v = acc.detach().to("cpu", dtype=torch.float64).numpy()
    acc.zero_()
    return v

