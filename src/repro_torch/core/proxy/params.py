"""Request-level serving API types: per-request decoding configuration and
the incremental output record.

These are pure-python (numpy only) so the proxy layer — which must stay
runtime-agnostic and importable without torch — can carry them on every
`Request`. The device-side fused sampler that consumes them lives in
`repro_torch.serving.sampling`.

Determinism contract: the random draw for the token sampled after `n`
context tokens is a counter-based hash of `(seed_key(seed), n)`. Because the draw is a pure function
of (seed, position), the sampled stream is invariant to engine layout
(paged vs slot-dense), admission batching, and preemption/resume — the same
`SamplingParams(seed=...)` always yields the same tokens.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

FINISH_STOP = "stop"        # hit one of the request's stop_token_ids
FINISH_LENGTH = "length"    # generated max_tokens
FINISH_ABORT = "abort"      # cancelled via Server.abort(rid)
FINISH_ERROR = "error"      # retries exhausted (instance death / KV loss)
FINISH_TIMEOUT = "timeout"  # retired by the no-progress watchdog


class BackpressureError(RuntimeError):
    """Typed admission rejection (graceful load shedding): raised by
    Server.add_request/submit when a request could never be served (prompt
    larger than the whole KV pool) or when the admission backlog exceeds
    `ServerConfig.admission_queue_cap`. Shedding at the door replaces the
    livelock of a request deferring forever inside the engines; callers
    retry later or route elsewhere. Counted in `MetricsAggregator.n_shed`."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding configuration (vLLM-style).

    temperature=0 (the default) is greedy argmax — bit-identical to the
    pre-sampling engines, so closed-batch callers keep their outputs.
    top_k <= 0 and top_p >= 1 disable the respective filters. seed=None
    derives the PRNG stream from the request id (still reproducible for a
    fixed rid assignment; pass an explicit seed for cross-run determinism).
    stop_token_ids=() falls back to the deprecated server-global
    `ServerConfig.eos_token`.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop_token_ids: tuple = ()
    max_tokens: int = 16

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        object.__setattr__(self, "top_k", int(self.top_k))
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


@dataclass
class RequestOutput:
    """One request's delta for one `Server.step()`: the tokens generated
    this step (empty for an abort notification) and, on the final record,
    the finish reason."""
    rid: int
    new_tokens: tuple = ()
    finished: bool = False
    finish_reason: Optional[str] = None     # FINISH_STOP/LENGTH/ABORT/
                                            # ERROR/TIMEOUT
    n_generated: int = 0                    # total output tokens so far


def seed_key(seed: int) -> np.ndarray:
    """uint32[2] base key for `seed`: the high and low 32-bit words of the
    seed (negative seeds wrap into the same 64-bit space)."""
    s = int(seed) & ((1 << 64) - 1)
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def device_row(params: Optional[SamplingParams], rid: int = 0) -> tuple:
    """(temperature, top_k, top_p, base_key) scalars for one slot of the
    engines' device-side parameter tensors."""
    p = params if params is not None else GREEDY
    seed = p.seed if p.seed is not None else rid
    return float(p.temperature), int(p.top_k), float(p.top_p), seed_key(seed)
