"""Unified request lifecycle — paper §5.1 (eight phases)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class Phase(enum.IntEnum):
    TOKENIZE = 0
    APC_MATCH = 1
    PREFILL_WAIT = 2
    PREFILL_SCHEDULED = 3
    PREFILL_RUNNING = 4
    DECODE_WAIT = 5
    DECODE_SCHEDULED = 6
    DECODE_RUNNING = 7
    DONE = 8
    FAILED = 9


@dataclass
class Request:
    rid: int
    tokens: tuple                      # prompt token ids
    max_tokens: int                    # generation budget (T_max)
    arrival: float = 0.0
    phase: Phase = Phase.TOKENIZE
    phase_times: dict = field(default_factory=dict)
    prefix_match: int = 0              # Match_P(i) on the chosen instance
    prefill_instance: Optional[int] = None
    decode_instance: Optional[int] = None
    output_tokens: list = field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_retries: int = 0                 # straggler/failure re-dispatches
    not_before: float = 0.0            # retry backoff: earliest re-dispatch
    sampling: Optional[object] = None  # SamplingParams (None → greedy legacy)
    finish_reason: Optional[str] = None   # "stop" | "length" | "abort" |
                                          # "error" | "timeout"

    def advance(self, phase: Phase, now: float):
        self.phase = phase
        self.phase_times[phase.name] = now

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    @property
    def effective_load(self) -> int:
        """ℓ_i = T_prompt + T_max (paper eq. 9) — LPT key for decode."""
        return self.prompt_len + self.max_tokens

    # ---- derived metrics --------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = max(len(self.output_tokens) - 1, 1)
        return (self.finish_time - self.first_token_time) / n

    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival
