"""Train with checkpointing on the PyTorch port, then demonstrate
preemption recovery: the port's counterpart of
examples/train_with_recovery.py, through `repro_torch.launch.train.main`,
with the same prints.

The default settings run mamba2-130m for 200 steps at batch 4 x 256 on the
card. Pass --tiny for a fast demonstration run (reduced qwen2-1.5b, 30
steps at batch 2 x 64).

    PYTHONPATH=src python examples/torch_train_with_recovery.py --tiny
    PYTHONPATH=src python examples/torch_train_with_recovery.py --tiny \
        --device cpu
"""
import argparse
import math
import tempfile


def main(argv=None) -> dict:
    from repro_torch.launch.train import main as train_main
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    args = ap.parse_args(argv)

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="omniinfer_ck_")
    if args.tiny:
        preempt_at = (args.steps or 30) // 2
        # every 10 steps, or often enough that a short run saves one
        # before its preemption
        every = min(10, max(1, preempt_at - 1))
        base = ["--arch", "qwen2-1.5b", "--reduced",
                "--steps", str(args.steps or 30), "--batch", "2",
                "--seq", "64", "--ckpt-dir", ckpt, "--ckpt-every",
                str(every)]
    else:
        preempt_at, every = 100, 50
        base = ["--arch", "mamba2-130m", "--steps", str(args.steps or 200),
                "--batch", "4", "--seq", "256", "--ckpt-dir", ckpt,
                "--ckpt-every", str(every)]
    base += ["--device", args.device]
    # the latest checkpoint at or before the preemption: the relaunch's
    # first step
    resume_step = preempt_at // every * every

    print(f"== phase 1: train with simulated preemption (ckpt: {ckpt})")
    code = None
    try:
        train_main(base + ["--preempt-at", str(preempt_at)])
    except SystemExit as e:
        code = e.code
        print(f"   (preempted, exit {e.code})")

    print("== phase 2: relaunch — resumes from the latest checkpoint")
    first = []
    loss = train_main(base, on_step=lambda step, *_: first.append(step)
                      if not first else None)
    print(f"final loss {loss:.4f}")
    return {"preempt_exit": code, "resumed_at": first[0] if first else None,
            "expected_resume": resume_step, "final_loss": loss,
            "finite": math.isfinite(loss), "ckpt_dir": ckpt}


if __name__ == "__main__":
    main()
