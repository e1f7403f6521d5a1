"""Serving metrics aggregation — the columns of paper Table 2:
TTFT / p99 TTFT / TPOT / p99 TPOT / QPM / E2E / p99 E2E / OTT / TTT."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.proxy.lifecycle import Request


@dataclass
class MetricsAggregator:
    done: list = field(default_factory=list)
    aborted: list = field(default_factory=list)
    # robustness plane (FaultPlane recovery machinery): requests retired
    # with finish_reason="error" (retries exhausted) / "timeout" (watchdog),
    # admissions shed at the door (BackpressureError), arena blocks pulled
    # from circulation by the summary-plane corruption scan, and the total
    # re-dispatch count — the columns that make robustness regressions
    # visible next to the latency figures.
    errors: list = field(default_factory=list)
    timeouts: list = field(default_factory=list)
    n_shed: int = 0
    blocks_quarantined: int = 0
    # PD transfer-cost model: true bytes = the KV payload actually resident
    # (prompt tokens), padded bytes = what a dense max_len handoff pytree
    # would meter. The old model reported only the padded figure — a
    # 64-token prompt in a max_len=2048 cache charged 32× its real bytes.
    kv_transfer_true_bytes: int = 0
    kv_transfer_padded_bytes: int = 0
    # OmniAttn online sparsity (layer-averaged engine figures): resident
    # blocks scored vs blocks actually attended per decode across the run,
    # and the exact attention mass the selected blocks captured (weighted
    # mean; only measured when the engine runs with topk_measure_mass).
    blocks_scored: int = 0
    blocks_attended: int = 0
    attn_mass_sum: float = 0.0
    attn_mass_n: float = 0.0
    # SpecPlane (model-free speculative decoding): draft tokens proposed vs
    # accepted by the batched verify, tokens emitted by verify steps, and
    # the verify-step count — the figures behind the `draft_acceptance` and
    # `tokens_per_verify` summary columns.
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_emitted: int = 0
    spec_verifies: int = 0

    def add(self, req: Request):
        if req.finish_time is not None:
            self.done.append(req)

    def add_aborted(self, req: Request):
        """Cancelled requests are tracked separately: they count in
        `n_aborted` but never pollute the latency distributions."""
        self.aborted.append(req)

    def add_error(self, req: Request):
        """Request retired after exhausting its retry budget."""
        self.errors.append(req)

    def add_timeout(self, req: Request):
        """Request retired by the no-progress watchdog."""
        self.timeouts.append(req)

    def note_shed(self, n: int = 1):
        """Admission rejected with BackpressureError (never entered
        the lifecycle, so there is no Request to keep)."""
        self.n_shed += n

    def note_quarantine(self, n: int = 1):
        """Arena blocks pulled from circulation by the corruption scan."""
        self.blocks_quarantined += n

    def note_kv_transfer(self, true_bytes: int, padded_bytes: int):
        """Record one admission round's KV handoff payload (both figures,
        so the padding distortion stays visible in summaries)."""
        self.kv_transfer_true_bytes += true_bytes
        self.kv_transfer_padded_bytes += padded_bytes

    def note_sparsity(self, scored: int, attended: int, mass_sum: float,
                      mass_n: float):
        """Record one decode engine's drained online-sparsity window
        (layer-averaged block counts + attention-mass accumulators)."""
        self.blocks_scored += int(scored)
        self.blocks_attended += int(attended)
        self.attn_mass_sum += mass_sum
        self.attn_mass_n += mass_n

    def note_spec(self, drafted, accepted, emitted, verifies):
        """Record one decode engine's drained speculation window
        ([drafted, accepted, emitted, verify steps])."""
        self.spec_drafted += int(round(float(drafted)))
        self.spec_accepted += int(round(float(accepted)))
        self.spec_emitted += int(round(float(emitted)))
        self.spec_verifies += int(round(float(verifies)))

    def _spec(self) -> dict:
        d, n = self.spec_drafted, self.spec_verifies
        return {"spec_drafted": d,
                "spec_accepted": self.spec_accepted,
                "spec_verifies": n,
                "draft_acceptance": (self.spec_accepted / d if d
                                     else float("nan")),
                "tokens_per_verify": (self.spec_emitted / n if n
                                      else float("nan"))}

    def _sparsity(self) -> dict:
        mass = (self.attn_mass_sum / self.attn_mass_n
                if self.attn_mass_n else float("nan"))
        return {"blocks_scored": self.blocks_scored,
                "blocks_attended": self.blocks_attended,
                "attn_mass_kept": mass}

    def _reasons(self) -> dict:
        n_stop = sum(1 for r in self.done if r.finish_reason == "stop")
        n_length = sum(1 for r in self.done if r.finish_reason == "length")
        return {"n_stop": n_stop, "n_length": n_length,
                "n_aborted": len(self.aborted)}

    def _robustness(self) -> dict:
        n_retries = sum(r.n_retries for pool in
                        (self.done, self.aborted, self.errors, self.timeouts)
                        for r in pool)
        return {"n_errors": len(self.errors),
                "n_timeouts": len(self.timeouts),
                "n_shed": self.n_shed,
                "n_retries": n_retries,
                "blocks_quarantined": self.blocks_quarantined}

    def summary(self, wall_time: float) -> dict:
        if not self.done:
            # zero-done is a normal state now (every request aborted, or the
            # wall clock expired): keep the full key set so consumers that
            # index n_done / latency columns unconditionally don't KeyError
            nan = float("nan")
            return {"n_done": 0, "qpm": 0.0, **self._reasons(),
                    **self._robustness(),
                    "ttft_mean": nan, "ttft_p99": nan,
                    "tpot_mean_ms": nan, "tpot_p99_ms": nan,
                    "e2e_mean": nan, "e2e_p99": nan,
                    "ott_tok_s": 0.0, "ttt_tok_s": 0.0,
                    "kv_transfer_true_bytes": self.kv_transfer_true_bytes,
                    "kv_transfer_padded_bytes": self.kv_transfer_padded_bytes,
                    **self._sparsity(), **self._spec()}
        ttft = np.array([r.ttft() for r in self.done if r.ttft() is not None])
        tpot = np.array([r.tpot() for r in self.done if r.tpot() is not None])
        e2e = np.array([r.e2e() for r in self.done])
        out_toks = sum(len(r.output_tokens) for r in self.done)
        tot_toks = out_toks + sum(r.prompt_len for r in self.done)
        wall = max(wall_time, 1e-9)
        pct = lambda a, p: float(np.percentile(a, p)) if len(a) else float("nan")
        return {
            "n_done": len(self.done),
            **self._reasons(),
            **self._robustness(),
            "qpm": 60.0 * len(self.done) / wall,
            "ttft_mean": float(ttft.mean()) if len(ttft) else float("nan"),
            "ttft_p99": pct(ttft, 99),
            "tpot_mean_ms": 1e3 * float(tpot.mean()) if len(tpot) else float("nan"),
            "tpot_p99_ms": 1e3 * pct(tpot, 99),
            "e2e_mean": float(e2e.mean()),
            "e2e_p99": pct(e2e, 99),
            "ott_tok_s": out_toks / wall,
            "ttt_tok_s": tot_toks / wall,
            "kv_transfer_true_bytes": self.kv_transfer_true_bytes,
            "kv_transfer_padded_bytes": self.kv_transfer_padded_bytes,
            **self._sparsity(), **self._spec(),
        }
