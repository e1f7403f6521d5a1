"""Mamba-2 SSD (state-space duality) of the port: chunked prefill and the
O(1) decode step, in PyTorch ops (the reference's `repro.models.ssd`, which
XLA compiles from einsums; the reference has no Pallas kernel for it).

Intra-chunk quadratic ("attention-like") term plus the inter-chunk linear
recurrence, carried by a loop over the chunks. Everything runs in float32
and the output is cast back to x's dtype.

Shapes: x [B, S, Hm, Pm], dt [B, S, Hm], B/C mats [B, S, N] (one group).
State [B, Hm, Pm, N].
"""
from __future__ import annotations

import torch


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Log-decay lower-triangular matrix: out[..., i, j] = sum_{k=j+1..i}
    a[..., k] for i >= j, -inf otherwise. a: [..., Q]."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def chunk_size(S: int, chunk: int) -> int:
    """The SSD chunk of an S-token call: min(chunk, S), halved until it
    divides S."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """→ (y [B, S, Hm, Pm] in x's dtype, final_state [B, Hm, Pm, N] float32).
    The inter-chunk recurrence is a loop over the S / Q chunks, a count set
    by the shapes alone, so a captured call replays it as it is."""
    Bsz, S, Hm, Pm = x.shape
    N = Bm.shape[-1]
    Q = chunk_size(S, chunk)
    C = S // Q

    f32 = torch.float32
    xq = x.reshape(Bsz, C, Q, Hm, Pm).to(f32)
    dtq = dt.reshape(Bsz, C, Q, Hm).to(f32)
    Bq = Bm.reshape(Bsz, C, Q, N).to(f32)
    Cq = Cm.reshape(Bsz, C, Q, N).to(f32)

    dA = dtq * A.to(f32)[None, None, None, :]               # [B,C,Q,Hm]
    dA_cs = torch.cumsum(dA, dim=2)                          # inclusive

    # ---- intra-chunk (quadratic) term
    L = torch.exp(segsum(dA.movedim(2, 3)))                  # [B,C,Hm,Q,Q]
    G = torch.einsum("bcln,bcsn->bcls", Cq, Bq)              # [B,C,Q,Q]
    M = G[:, :, None] * L * dtq.movedim(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", M, xq)

    # ---- chunk states: S_c = sum_s exp(dA_end - dA_cs_s) dt_s B_s ⊗ x_s
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # [B,C,Q,Hm]
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bq, decay_states * dtq,
                          xq)

    # ---- inter-chunk recurrence over the C chunks
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # [B,C,Hm]
    if initial_state is None:
        s = torch.zeros((Bsz, Hm, Pm, N), dtype=f32, device=x.device)
    else:
        s = initial_state.to(f32)
    prevs = []
    for c in range(C):
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                      # [B,C,Hm,Pm,N]

    # ---- inter-chunk output: y_off = C_l · (exp(dA_cs_l) S_prev)
    state_decay = torch.exp(dA_cs)                           # [B,C,Q,Hm]
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cq, s_prevs, state_decay)

    y = (y_diag + y_off).reshape(Bsz, S, Hm, Pm)
    return y.to(x.dtype), s


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token state update. x [B, Hm, Pm], dt [B, Hm], Bm/Cm [B, N].
    → (y [B, Hm, Pm] in x's dtype, new_state [B, Hm, Pm, N] float32)."""
    f32 = torch.float32
    x32, dt32 = x.to(f32), dt.to(f32)
    dA = torch.exp(dt32 * A.to(f32)[None, :])                # [B,Hm]
    upd = torch.einsum("bn,bh,bhp->bhpn", Bm.to(f32), dt32, x32)
    new_state = state.to(f32) * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), new_state)
    return y.to(x.dtype), new_state


def causal_conv(x, w, cache=None):
    """Causal depthwise convolution of width cw. x [B, S, Cd], w [cw, Cd];
    cache [B, cw-1, Cd] the previous inputs (decode, continued prefill) or
    None (zeros). → (y [B, S, Cd], new cache [B, cw-1, Cd]: the last cw-1
    rows of (cache ‖ x), a new tensor)."""
    cw = w.shape[0]
    if cache is None:
        xp = torch.nn.functional.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0][None, None, :]
    for i in range(1, cw):
        y = y + xp[:, i:i + S] * w[i][None, None, :]
    return y, xp[:, xp.shape[1] - (cw - 1):]
