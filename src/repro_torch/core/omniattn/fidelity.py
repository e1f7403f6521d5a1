"""Attention-output fidelity under KV sparsification (paper eq. 5-6).

Measures || softmax(QK_M^T/√d) V_M  −  softmax(QK^T/√d) V || for a token
subset M — the quantity OmniAttn's approximation bounds. M defaults to the
static sink ∪ recent pattern (eq. 6); an arbitrary `indices` subset scores
any sparsification, in particular the blocks picked by the online top-k
selection (`block_subset_indices` maps selected block ids to token
indices).
"""
from __future__ import annotations

import numpy as np
import torch


def sink_recent_indices(M: int, n_sink: int, n_recent: int) -> np.ndarray:
    """Token index subset per eq. 6: first n_sink + last n_recent of M."""
    n_sink = min(n_sink, M)
    n_recent = min(n_recent, M - n_sink)
    return np.concatenate([np.arange(n_sink), np.arange(M - n_recent, M)])


def block_subset_indices(M: int, blocks, block_size: int) -> np.ndarray:
    """Token index subset covered by the given KV block ids (logical block
    j spans tokens [j·bs, (j+1)·bs) ∩ [0, M)) — the online top-k
    selection's M, in eq. 5-6 terms."""
    out = [np.arange(b * block_size, min((b + 1) * block_size, M))
           for b in sorted(int(b) for b in blocks)]
    return (np.concatenate(out) if out
            else np.zeros((0,), np.int64))


def attention_fidelity(q, k, v, n_sink: int = 0, n_recent: int = 0, *,
                       indices=None):
    """q [Nq, d]; k, v [M, d] (tensors or arrays; computed in float32 on
    their device). Scores the token subset `indices` (or the eq. 6
    sink∪recent subset built from n_sink/n_recent when omitted). → dict
    with the relative L2 output error and the total attention mass the
    subset captures."""
    q, k, v = (torch.as_tensor(x).float() for x in (q, k, v))
    M, d = k.shape
    idx = torch.as_tensor(
        np.asarray(indices, np.int64) if indices is not None
        else sink_recent_indices(M, n_sink, n_recent), device=k.device)
    scale = d ** -0.5
    p_full = torch.softmax((q @ k.T) * scale, dim=-1)
    out_full = p_full @ v
    p_sub = torch.softmax((q @ k[idx].T) * scale, dim=-1)
    out_sub = p_sub @ v[idx]
    rel = torch.linalg.norm(out_sub - out_full) / torch.clamp(
        torch.linalg.norm(out_full), min=1e-9)
    mass = p_full[:, idx].sum(-1).mean()
    return {"rel_err": float(rel), "attn_mass": float(mass)}
