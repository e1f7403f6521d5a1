"""DevicePlacement — the device layer every serving engine is built through.

On this slice it is single-device: it holds the torch device (cuda unless
the caller asks for the CPU) and moves parameter trees onto it.

The JAX reference's placement also owns `donate_jit` (the choke point that
builds every donated serving jit) and the `HotLoopRegistry` of those jits.
Neither has a counterpart here: PyTorch runs eagerly, and the port updates
the KV arenas and the decode slot state IN PLACE, so there is no buffer to
donate and no jit to register. Multi-device (TP/EP) placement comes with a
later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from repro_torch.device import resolve_device


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


@dataclass(frozen=True)
class DevicePlacement:
    device: torch.device

    @staticmethod
    def of(obj: Union[None, str, torch.device, "DevicePlacement"] = None
           ) -> "DevicePlacement":
        """None → cuda; a device name or torch.device; or a placement."""
        if isinstance(obj, DevicePlacement):
            return obj
        return DevicePlacement(resolve_device(obj))

    def place_params(self, params):
        """Every tensor of a parameter tree on this placement's device."""
        return _to(params, self.device)
