"""Training launcher of the port: --arch <id> + data pipeline + AdamW +
checkpoint/resume (the reference's src/repro/launch/train.py, plus
--device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --device cpu --steps 20 --ckpt-dir /tmp/ck --ckpt-every 5

Fault tolerance drill: `--preempt-at N` exits with code 42 after step N
(a simulated preemption); relaunching with the same --ckpt-dir resumes from
the latest committed checkpoint.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.models.lm import LM
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optim import adamw_init
from repro_torch.training.trainer import make_train_step


def main(argv=None, on_step=None):
    """Run the launcher on `argv` → the last step's loss. `on_step(step,
    params, opt, metrics)`, if given, is called after each step's update
    and before its checkpoint (a caller's view of the run)."""
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    lm = LM.build(cfg, device=args.device)
    tables = lm.default_tables()
    step_fn = make_train_step(lm, lr=args.lr)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        shapes = lm.shapes()
        tmpl = {"params": shapes,
                "opt": adamw_init(shapes, cfg.optimizer_dtype)}
        state, start, _ = mgr.restore(template=tmpl, device=lm.device)
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}", flush=True)
    else:
        params = lm.init(0)
        opt = adamw_init(params, cfg.optimizer_dtype)

    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = make_batch(cfg, dcfg, step, device=lm.device)
        params, opt, metrics = step_fn(params, opt, batch, tables)
        if on_step is not None:
            on_step(step, params, opt, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt})
        if args.preempt_at and step + 1 >= args.preempt_at:
            print(f"simulated preemption at step {step + 1}", flush=True)
            sys.exit(42)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
