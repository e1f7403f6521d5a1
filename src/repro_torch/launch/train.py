"""Training launcher of the port: --arch <id> + data pipeline + AdamW +
checkpoint/resume (the reference's src/repro/launch/train.py, plus
--device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --device cpu --steps 20 --ckpt-dir /tmp/ck --ckpt-every 5

Fault tolerance drill: `--preempt-at N` exits with code 42 after step N
(a simulated preemption); relaunching with the same --ckpt-dir resumes from
the latest committed checkpoint.

--tp / --ep above 1 train over tp · ep ranks, one process each (rank =
e · tp + t), exactly as launch/serve.py serves over them: under `torchrun`
(its RANK / WORLD_SIZE environment) this process is one rank, otherwise
the launcher starts the tp · ep processes itself (torch.multiprocessing)
and returns rank 0's last loss. --backend nccl, the default on cuda, needs
a card per rank; --backend gloo runs on the CPU or lets the ranks share
one card. Every rank takes the same global batch and trains on its rows
over `data`; the parameters and moments are each rank's part (the seed's
one-rank model carried over, `init_state`); rank 0 logs. A checkpoint
holds whole leaves (rank 0 writes them) and restores onto any layout, one
rank included; the preemption drill exits 42 from every rank.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --tp 2 --ep 2 --backend gloo --device cpu --steps 8 \
        --ckpt-dir /tmp/ck --ckpt-every 2 --preempt-at 4
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from datetime import timedelta

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.models.lm import LM
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optim import adamw_init
from repro_torch.training.trainer import init_state, make_train_step

# how long a rank waits in a collective before the group gives up
COLLECTIVE_TIMEOUT_S = 600
PREEMPT_EXIT = 42


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--preempt-at", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width (the `model` axis)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel / data width (the `data` axis)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collectives over tp·ep > 1 ranks (None → nccl on "
                         "cuda, gloo on the CPU)")
    ap.add_argument("--device", default="cuda")
    return ap


def _train(args, lm: LM, on_step=None) -> float:
    """The training loop on `lm` (one rank, or this process's rank) → the
    last step's loss."""
    cfg, ctx = lm.cfg, lm.ctx
    log = ctx.rank == 0
    tables = lm.default_tables()
    step_fn = make_train_step(lm, lr=args.lr)

    mgr = CheckpointManager(args.ckpt_dir, lm=lm) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        shapes = lm.shapes()
        tmpl = {"params": shapes,
                "opt": adamw_init(shapes, cfg.optimizer_dtype)}
        state, start, _ = mgr.restore(template=tmpl, device=lm.device)
        params, opt = state["params"], state["opt"]
        if log:
            print(f"resumed from step {start}", flush=True)
    else:
        st = init_state(lm, 0)
        params, opt = st.params, st.opt

    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = make_batch(cfg, dcfg, step, device=lm.device)
        params, opt, metrics = step_fn(params, opt, batch, tables)
        if on_step is not None:
            on_step(step, params, opt, metrics)
        if log and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt})
        if args.preempt_at and step + 1 >= args.preempt_at:
            if log:
                print(f"simulated preemption at step {step + 1}", flush=True)
            sys.exit(PREEMPT_EXIT)
    return float(metrics["loss"])


def _config(args):
    return reduced_config(args.arch) if args.reduced else \
        get_config(args.arch)


def _backend(args) -> str:
    backend = args.backend or ("nccl" if args.device.startswith("cuda")
                               else "gloo")
    world = args.tp * args.ep
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"--backend nccl needs a card per rank: tp {args.tp} x ep "
            f"{args.ep} = {world} ranks, {torch.cuda.device_count()} "
            f"visible (use --backend gloo to share a card or to run on the "
            f"CPU)")
    return backend


def _rank_main(rank: int, args, backend: str, init: str, out=None,
               on_step=None):
    """One rank: join the group, build its LM, train → the last loss (rank
    0 also puts it on `out`). Ranks on the CPU split its cores."""
    from repro_torch.serving.placement import DevicePlacement
    world = args.tp * args.ep
    if not args.device.startswith("cuda"):
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.distributed.init_process_group(
        backend, init_method=init, rank=rank, world_size=world,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    pl = DevicePlacement.build(args.tp, args.ep,
                               None if backend == "nccl" else args.device,
                               backend, capture=False)
    lm = LM.build(_config(args), device=pl.device, ctx=pl.ctx)
    loss = _train(args, lm, on_step)
    if rank == 0 and out is not None:
        out.put(loss)
    torch.distributed.destroy_process_group()
    return loss


def main(argv=None, on_step=None):
    """Run the launcher on `argv` → the last step's loss (over ranks rank
    0's). `on_step(step, params, opt, metrics)`, if given, is called after
    each step's update and before its checkpoint (a caller's view of the
    run; over ranks only in this process's rank, under torchrun)."""
    args = _parser().parse_args(argv)
    world = args.tp * args.ep
    if world == 1:
        return _train(args, LM.build(_config(args), device=args.device),
                      on_step)
    backend = _backend(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # torchrun: this process is one rank of the world it names
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"WORLD_SIZE {os.environ['WORLD_SIZE']} != tp "
                             f"{args.tp} x ep {args.ep}")
        return _rank_main(int(os.environ["RANK"]), args, backend, "env://",
                          on_step=on_step)
    mp = torch.multiprocessing.get_context("spawn")
    q = mp.SimpleQueue()
    # a file rendezvous of this run's own: a free TCP port picked here could
    # be bound by another process before rank 0 listens on it
    with tempfile.TemporaryDirectory() as d:
        try:
            torch.multiprocessing.start_processes(
                _rank_main, args=(args, backend, f"file://{d}/store", q),
                nprocs=world, start_method="spawn")
        except torch.multiprocessing.ProcessExitedException as exc:
            if exc.exit_code == PREEMPT_EXIT:
                sys.exit(PREEMPT_EXIT)
            raise
        return q.get()


if __name__ == "__main__":
    main()
