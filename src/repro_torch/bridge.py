"""Bridge from the JAX reference's parameters to the port's.

The reference's `LM.init` pytree, converted leaf by leaf to numpy (for
example `jax.tree.map(np.asarray, params)`), is turned into the port's
parameter dict. Period-stacked leaves `[n_rep, ...]` are unstacked into one
dict per layer in layer order (repeat r, period position i), then the
remainder layers follow — the order of the reference's `unstack_params`.
The optimizer's state crosses the same way (`opt_from_numpy`), and
`params_to_numpy` carries parameters back, so two frameworks' parameters
after k steps compare leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

# The parameters outside the layer stack: the frontend families' input
# projection "frontend" [frontend_dim, d_model] beside the token ones.
TOP_LEVEL = ("embed", "final_norm", "head", "frontend")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # numpy has no native bfloat16
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: dict, cfg, plan, device=None) -> dict:
    """tree: {"stack": {"period": (layer dict [n_rep, ...], ...),
    "rem": (layer dict, ...)}, "embed", "final_norm"[, "head"][,
    "frontend"]} of numpy arrays → {"layers": [layer dict, ...], "embed",
    "final_norm"[, "head"][, "frontend"]} of tensors on `device` (None →
    cuda)."""
    dev = resolve_device(device)
    stack = tree["stack"]
    period, rem = list(stack["period"]), list(stack["rem"])
    if len(period) != len(plan.period) or len(rem) != len(plan.rem):
        raise ValueError("parameter tree does not match the stack plan")
    layers = []
    for r in range(plan.n_rep):
        for entry in period:
            layers.append({k: _tensor(np.asarray(v)[r], dev)
                           for k, v in entry.items()})
    for entry in rem:
        layers.append({k: _tensor(v, dev) for k, v in entry.items()})
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers bridged, config has "
                         f"{cfg.n_layers}")
    out = {"layers": layers}
    for k in TOP_LEVEL:
        if k in tree:
            out[k] = _tensor(tree[k], dev)
    return out


def opt_from_numpy(opt: dict, cfg, plan, device=None) -> dict:
    """The reference's AdamW state ({"m", "v": parameter-shaped trees,
    "step"} of `adamw_init` / `adamw_update`, as numpy) → the port's, the
    moments unstacked as `params_from_numpy` unstacks parameters and the
    step a 0-d int32 tensor."""
    dev = resolve_device(device)
    return {"m": params_from_numpy(opt["m"], cfg, plan, dev),
            "v": params_from_numpy(opt["v"], cfg, plan, dev),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32, device=dev)}


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # exact in float32
        t = t.float()
    return t.numpy()


def params_to_numpy(params: dict, plan) -> dict:
    """The inverse of `params_from_numpy`: the port's parameter dict (or
    a moment tree of its structure) → the reference's layout of numpy
    arrays, period layers restacked [n_rep, ...] and the remainder after
    them. bfloat16 leaves come out as float32 (exact; numpy has no
    bfloat16)."""
    layers, P = params["layers"], len(plan.period)
    period = tuple({k: np.stack([_array(layers[r * P + i][k])
                                 for r in range(plan.n_rep)])
                    for k in layers[i]} for i in range(P))
    rem = tuple({k: _array(v) for k, v in layers[plan.n_rep * P + j].items()}
                for j in range(len(plan.rem)))
    out = {"stack": {"period": period, "rem": rem}}
    for k in TOP_LEVEL:
        if k in params:
            out[k] = _array(params[k])
    return out
