"""Quickstart on the PyTorch port: build a reduced model, stream requests
through the full OmniInfer serving stack (OmniProxy → chunked prefill → KV
transfer → batched decode with per-request sampling) via the `generate()`
iterator, print serving metrics. The port's counterpart of
examples/quickstart.py, with the same prints, then one more request: a
repeat of the first prompt, adopted whole from the prefix store.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

`REPRO_SMOKE=1` runs a 2-layer model and three requests.
"""
import argparse
import os
import time

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.core.proxy import OASConfig, SamplingParams
from repro_torch.serving import Server, ServerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    smoke = bool(os.environ.get("REPRO_SMOKE"))    # CI: tiny, fast config
    cfg = reduced_config("qwen2-1.5b")
    if smoke:
        cfg = cfg.with_updates(n_layers=2)
    print(f"arch={cfg.arch_id} (reduced: {cfg.n_layers}L d{cfg.d_model}) "
          f"compression pattern={cfg.default_compression_pattern()}")

    srv = Server(cfg, ServerConfig(n_prefill=1, n_decode=1, decode_slots=4,
                                   max_len=96,
                                   oas=OASConfig(defer_window=0.0)),
                 device=args.device)
    rng = np.random.default_rng(0)
    shared = tuple(rng.integers(0, 500, 16).tolist())   # shared system prompt
    prompts, params = [], []
    for i in range(3 if smoke else 6):
        prompt = shared + tuple(rng.integers(0, 500, 4 + 3 * i).tolist()) \
            if i % 2 == 0 else \
            tuple(rng.integers(0, 500, int(rng.integers(8, 24))).tolist())
        prompts.append(prompt)
        # every request carries its own decoding config: even rids greedy,
        # odd rids seeded temperature sampling
        params.append(SamplingParams(max_tokens=6) if i % 2 == 0 else
                      SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                     seed=i, max_tokens=6))

    t0 = time.monotonic()
    streamed: dict[int, list] = {}
    for out in srv.generate(prompts, params, max_wall_s=180):
        streamed.setdefault(out.rid, []).extend(out.new_tokens)
        if out.finished:
            print(f"  rid {out.rid}: {out.n_generated} tokens "
                  f"({out.finish_reason})  {streamed[out.rid]}")
    wall = time.monotonic() - t0

    summary = srv.metrics.summary(wall)
    print(f"\nserved {summary['n_done']} requests in {wall:.1f}s "
          f"(stop={summary['n_stop']} length={summary['n_length']} "
          f"aborted={summary['n_aborted']})")
    print(f"  QPM        {summary['qpm']:.1f}")
    print(f"  TTFT mean  {summary['ttft_mean']*1e3:.0f} ms")
    print(f"  TPOT mean  {summary['tpot_mean_ms']:.0f} ms")
    hits = sum(e.stats['cache_hits'] for e in srv.prefills)
    print(f"  APC hits   {hits}")
    kv = sum(e.stats['kv_transfer_bytes'] for e in srv.decodes)
    print(f"  P→D KV transferred {kv/1e6:.2f} MB")

    # a returning client re-sends request 0's prompt: the whole prompt is
    # adopted from the prefix store (an APC hit) and, greedy, streams the
    # same tokens
    again = []
    for out in srv.generate([prompts[0]], [params[0]], max_wall_s=180):
        again.extend(out.new_tokens)
    hits_after = sum(e.stats['cache_hits'] for e in srv.prefills)
    print(f"  repeat of rid 0: APC hits {hits_after}, same stream: "
          f"{again == streamed[0]}")
    return {"n_requests": len(prompts), "n_done": summary["n_done"],
            "apc_hits": hits_after, "repeat_equal": again == streamed[0],
            "streamed": streamed, "wall_s": wall, "kv_transfer_bytes": kv}


if __name__ == "__main__":
    main()
