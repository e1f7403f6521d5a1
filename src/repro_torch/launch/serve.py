"""Serving launcher of the port: --arch <id> through the full OmniInfer
stack (the reference's src/repro/launch/serve.py, plus --device). The same
request mix (a 16-token shared prefix on every third request) and the same
summary JSON. Per-request decoding config rides on SamplingParams:
--temperature > 0 switches the batch from greedy to seeded sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --device cpu --requests 8 --max-tokens 6

--tp / --ep above 1 raise NotImplementedError: multi-GPU placement is
ROADMAP A16. So do the encoder-only and frontend archs (hubert-xlarge,
phi-3-vision-4.2b): the Server serves token requests only
(`serving.server.check_servable`).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.proxy import OASConfig, SamplingParams
from repro_torch.serving.server import Server, ServerConfig, check_servable


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width (ROADMAP A16: 1 only)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel width (ROADMAP A16: 1 only)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=6)
    ap.add_argument("--prefill", type=int, default=1)
    ap.add_argument("--decode", type=int, default=1)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--no-proxy", action="store_true",
                    help="round-robin baseline (ablation)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 → greedy (default); > 0 → seeded sampling")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--stop-token", type=int, default=-1,
                    help="per-request stop token id (-1 → none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tp > 1 or args.ep > 1:
        raise NotImplementedError(
            f"--tp {args.tp} --ep {args.ep}: multi-GPU placement is not "
            f"ported yet (ROADMAP A16)")
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    check_servable(cfg)
    oas = OASConfig(defer_window=0.0, cache_aware=not args.no_proxy,
                    lpt=not args.no_proxy, deferred=False)
    srv = Server(cfg, ServerConfig(n_prefill=args.prefill,
                                   n_decode=args.decode,
                                   decode_slots=args.slots,
                                   max_len=args.max_len, oas=oas),
                 device=args.device)
    rng = np.random.default_rng(args.seed)
    shared = tuple(rng.integers(0, min(cfg.vocab_size, 500), 16).tolist())
    stop = (args.stop_token,) if args.stop_token >= 0 else ()
    reqs = []
    for i in range(args.requests):
        if i % 3 == 0:
            p = shared + tuple(rng.integers(0, 500, 4 + i).tolist())
        else:
            p = tuple(rng.integers(0, 500, int(rng.integers(8, 32))).tolist())
        reqs.append((p, SamplingParams(temperature=args.temperature,
                                       top_k=args.top_k, top_p=args.top_p,
                                       seed=args.seed + i,
                                       stop_token_ids=stop,
                                       max_tokens=args.max_tokens)))
    s = srv.run(reqs, max_wall_s=600)
    print(json.dumps({k: v for k, v in s.items()
                      if not isinstance(v, list)}, indent=1, default=float))
    return s


if __name__ == "__main__":
    main()
