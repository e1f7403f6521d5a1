"""End-to-end demo on the PyTorch port: PD-disaggregated serving of a
small MoE model with streaming `generate()`, a failure drill (one prefill
instance dies mid-stream; OmniProxy requeues its work), and a mid-flight
`abort()`. The port's counterpart of examples/serve_disaggregated.py, with
the same prints.

    PYTHONPATH=src python examples/torch_serve_disaggregated.py   # the card
    PYTHONPATH=src python examples/torch_serve_disaggregated.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.core.placement import calculate_imbalance
from repro_torch.core.proxy import OASConfig, SamplingParams
from repro_torch.serving import Server, ServerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(n_layers=2)
    print(f"arch={cfg.arch_id}: {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
          f" + {cfg.moe.n_shared_experts} shared")

    # small per-tick prefill budget: first tokens stream out while later
    # prompts are still queued, so the mid-stream failure has work to requeue
    srv = Server(cfg, ServerConfig(n_prefill=2, n_decode=1, decode_slots=4,
                                   max_len=64, chunk_tokens=8,
                                   prefill_tick_budget=8,
                                   oas=OASConfig(defer_window=0.0)),
                 device=args.device)
    se = srv.tables["slot_expert"].cpu().numpy()
    print(f"expert slots per EP rank: {se.shape[1]} (layout {se.tolist()})")

    rng = np.random.default_rng(1)
    prompts = [tuple(rng.integers(0, 500, int(rng.integers(6, 20))).tolist())
               for _ in range(8)]
    params = [SamplingParams(temperature=0.7, top_k=32, seed=i, max_tokens=4)
              for i in range(len(prompts))]

    # stream through generate(); after the first outputs arrive (some
    # requests still queued / mid-prefill) fail a prefill instance, then
    # abort one still-running request mid-flight
    dead, drilled, abort_rid, n_requeued = 0, False, None, 0
    streamed: dict[int, int] = {}
    for out in srv.generate(prompts, params, max_wall_s=180):
        streamed[out.rid] = streamed.get(out.rid, 0) + len(out.new_tokens)
        if not drilled and out.new_tokens:
            requeued = srv.proxy.mark_unhealthy("prefill", dead, 0.0)
            srv.proxy.mark_healthy("prefill", dead)
            n_requeued = len(requeued)
            print(f"\n!! failed prefill instance {dead} mid-stream: "
                  f"{n_requeued} requests requeued by OmniProxy")
            drilled = True
        if drilled and abort_rid is None:
            live = [r for r in srv.proxy.inflight if streamed.get(r, 0) == 0]
            if live:
                abort_rid = live[-1]
                srv.abort(abort_rid)
                print(f"!! aborted rid {abort_rid} mid-flight")
        if out.finished:
            print(f"  rid {out.rid}: {out.n_generated} tokens "
                  f"({out.finish_reason})")

    s = srv.metrics.summary(1.0)
    print(f"\ncompleted {s['n_done']}/{len(prompts)} despite the failure "
          f"({s['n_aborted']} aborted); ttft={s['ttft_mean']:.2f}s")
    print(f"robustness: n_retries={s['n_retries']} n_errors={s['n_errors']} "
          f"n_timeouts={s['n_timeouts']} n_shed={s['n_shed']} "
          f"blocks_quarantined={s['blocks_quarantined']}")

    # quiescent-point hygiene: the failure drill + abort must leak nothing —
    # pool invariants hold and only prefix-store snapshots remain mapped
    leaked = []
    if srv.kv_arena is not None:
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
        leaked = [k for k in srv.kv_arena.pool.per_request
                  if not (isinstance(k, tuple) and k[0] == "store")]
        assert not leaked, f"leaked blocks: {leaked}"
        print("KV pool invariants OK: zero leaked blocks, "
              "zero stale summaries")

    # expert-load imbalance picture from this run's routing
    counts = np.ones(cfg.moe.n_experts)  # uniform placeholder at tiny scale
    placement = np.zeros((srv.ctx.ep, cfg.moe.n_experts), np.int8)
    for r in range(se.shape[0]):
        for s_ in range(se.shape[1]):
            if se[r, s_] >= 0:
                placement[r, se[r, s_]] = 1
    print(f"placement imbalance B = "
          f"{calculate_imbalance(placement, counts):.3f}")
    return {"n_requests": len(prompts), "n_done": s["n_done"],
            "n_aborted": s["n_aborted"], "n_requeued": n_requeued,
            "aborted_rid": abort_rid, "leaked": leaked,
            "arena": srv.kv_arena is not None}


if __name__ == "__main__":
    main()
