"""Serving launcher of the port: --arch <id> through the full OmniInfer
stack (the reference's src/repro/launch/serve.py, plus --device). The same
request mix (a 16-token shared prefix on every third request) and the same
summary JSON. Per-request decoding config rides on SamplingParams:
--temperature > 0 switches the batch from greedy to seeded sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --reduced --device cpu --requests 8 --max-tokens 6

--tp / --ep above 1 serve over tp · ep ranks, one process each (rank =
e · tp + t), every rank running the same Server in lockstep: under
`torchrun` (its RANK / WORLD_SIZE environment) this process is one rank,
otherwise the launcher starts the tp · ep processes itself
(torch.multiprocessing) and prints rank 0's summary. --backend nccl, the
default on cuda, needs a card per rank; --backend gloo runs on the CPU,
or lets several ranks share one card (its collectives are not captured
into CUDA graphs there). Over ranks, as on one, the model is the config's
OmniAttn default pattern (ring layers of sink + recent, sliding windows,
online top-k where the config sets a budget); --full-attention serves
every attention layer full instead (pattern [0] * n_layers). Every
servable config lays out at any --tp (`models.stack.head_layout`,
`mamba_layout`), as the reference's launcher accepts it:

    config                tp 2          tp 4          tp 8
    qwen2-1.5b (12/2)     kv            wseq          replicated
    qwen3-32b (64/8)      kv            kv            kv
    gemma3-4b (8/4)       kv            kv            wseq
    granite-34b (48/1)    wseq          wseq          wseq
    qwen2-moe (16/16)     kv            kv            kv
    qwen3-moe (64/4)      kv            kv            wseq
    jamba (64/8)          kv            kv            kv
    mamba2-130m           24 SSD heads split over tp

'kv': K / tp KV heads a rank. 'wseq': the rank's H / tp query heads and
the one KV head they read (a rank's caches hold that head). 'replicated':
every rank holds and computes every head, and adds no psum. jamba's
Mamba-2 mixers split their 256 SSD heads over tp.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        qwen2-moe-a2.7b --reduced --tp 2 --ep 2 --backend gloo --device cpu

The tests that hold this path to the JAX reference on the CPU:
`PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_distributed.py tests/test_torch_distributed_omniattn.py
tests/test_torch_launch.py -q`.

The encoder-only and frontend archs (hubert-xlarge, phi-3-vision-4.2b)
raise NotImplementedError: the Server serves token requests only
(`serving.server.check_servable`).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import tempfile
from datetime import timedelta

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.proxy import OASConfig, SamplingParams
from repro_torch.serving.server import Server, ServerConfig, check_servable

# how long a rank waits in a collective before the group gives up
COLLECTIVE_TIMEOUT_S = 600


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width (the `model` axis)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel width (the `data` axis)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collectives over tp·ep > 1 ranks (None → nccl on "
                         "cuda, gloo on the CPU)")
    ap.add_argument("--full-attention", action="store_true",
                    help="every attention layer full (pattern [0] * "
                         "n_layers) instead of the config's OmniAttn default")
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
    return ap


def _requests(args, cfg) -> list:
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
    return reqs


def _model(args):
    """→ (config, pattern) of the --arch: None → its OmniAttn default."""
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    check_servable(cfg)
    return cfg, [0] * cfg.n_layers if args.full_attention else None


def _serve(args, placement=None) -> dict:
    """Build the Server (on `placement`, or the --device) and run the
    request mix → the summary."""
    cfg, pattern = _model(args)
    oas = OASConfig(defer_window=0.0, cache_aware=not args.no_proxy,
                    lpt=not args.no_proxy, deferred=False)
    srv = Server(cfg, ServerConfig(n_prefill=args.prefill,
                                   n_decode=args.decode,
                                   decode_slots=args.slots,
                                   max_len=args.max_len, oas=oas),
                 pattern=pattern, device=args.device, placement=placement)
    return srv.run(_requests(args, cfg), max_wall_s=600)


def _backend(args) -> str:
    backend = args.backend or ("nccl" if args.device.startswith("cuda")
                               else "gloo")
    world = args.tp * args.ep
    if backend == "nccl":
        n = torch.cuda.device_count()
        if n < world:
            raise RuntimeError(
                f"--backend nccl needs a card per rank: tp {args.tp} x ep "
                f"{args.ep} = {world} ranks, {n} visible (use --backend gloo "
                f"to share a card or to run on the CPU)")
    return backend


def _rank_main(rank: int, args, backend: str, init: str, out=None):
    """One rank: join the group, build its placement, serve → the summary
    (rank 0 also puts it on `out`). Ranks on the CPU split its cores."""
    from repro_torch.serving.placement import DevicePlacement
    world = args.tp * args.ep
    if not args.device.startswith("cuda"):
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.distributed.init_process_group(
        backend, init_method=init, rank=rank, world_size=world,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    device = None if backend == "nccl" else args.device
    on_card = args.device.startswith("cuda")
    pl = DevicePlacement.build(
        args.tp, args.ep, device, backend,
        capture=False if backend == "gloo" and on_card else None)
    summary = {k: v for k, v in _serve(args, pl).items()
               if not isinstance(v, list)}
    if rank == 0 and out is not None:
        out.put(summary)
    # the server and its captured graphs go before the communicators (a
    # failed rank skips this: its process exits with the error)
    gc.collect()
    torch.distributed.destroy_process_group()
    return summary


def main(argv=None):
    args = _parser().parse_args(argv)
    world = args.tp * args.ep
    if world == 1:
        s = _serve(args)
        print(json.dumps({k: v for k, v in s.items()
                          if not isinstance(v, list)}, indent=1,
                         default=float))
        return s
    # what no rank can serve (the frontend families) is refused here,
    # before any process starts
    _model(args)
    backend = _backend(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # torchrun: this process is one rank of the world it names
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"WORLD_SIZE {os.environ['WORLD_SIZE']} != tp "
                             f"{args.tp} x ep {args.ep}")
        rank = int(os.environ["RANK"])
        s = _rank_main(rank, args, backend, "env://")
        if rank != 0:
            return s
    else:
        mp = torch.multiprocessing.get_context("spawn")
        q = mp.SimpleQueue()
        # a file rendezvous of this run's own (a free TCP port picked here
        # could be bound by another process before rank 0 listens on it)
        with tempfile.TemporaryDirectory() as d:
            torch.multiprocessing.start_processes(
                _rank_main, args=(args, backend, f"file://{d}/store", q),
                nprocs=world, start_method="spawn")
            s = q.get()
    if s is not None:
        print(json.dumps(s, indent=1, default=float))
    return s


if __name__ == "__main__":
    main()
