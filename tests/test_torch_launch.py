"""The port's launchers on the CPU, reduced configs.

- `launch.train.main`: a preemption drill (`--preempt-at 4` exits 42
  after committing step 4), a relaunch that resumes at step 4 and runs to
  6, and an uninterrupted 6-step run: the resumed steps' losses and
  gradient norms are bit-equal to the uninterrupted run's, and so are the
  final parameters;
- `launch.serve.main`: the summary's keys are the reference launcher's
  (`repro.launch.serve`) on the same flags, every request completes, and
  --tp / --ep above 1 serve over four gloo ranks (reduced qwen2-moe at its
  default pattern and every layer full, reduced mamba2-130m with its
  Mamba-2 mixers split over tp) with one rank's summary counts.
"""
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve, train
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

ARGS = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
        "--batch", "2", "--seq", "32", "--lr", "1e-3", "--steps", "6",
        "--log-every", "1"]


def _run(argv):
    log = {}

    def on_step(step, params, opt, metrics):
        log[step] = (float(metrics["loss"]), float(metrics["grad_norm"]))
        log["params"] = [p.clone() for p in tree_leaves(params)]
    try:
        last = train.main(argv, on_step=on_step)
        code = None
    except SystemExit as e:
        last, code = None, e.code
    return log, last, code


def test_train_preempt_and_resume_bit_equal(tmp_path, capsys):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    first, _, code = _run(ARGS + ck + ["--preempt-at", "4"])
    assert code == 42
    assert sorted(k for k in first if k != "params") == [0, 1, 2, 3]
    assert (tmp_path / "step_00000004" / "manifest.json").exists()
    resumed, last, code = _run(ARGS + ck)
    assert code is None
    assert sorted(k for k in resumed if k != "params") == [4, 5]
    out = capsys.readouterr().out
    assert "simulated preemption at step 4" in out
    assert "resumed from step 4" in out
    whole, last_whole, _ = _run(ARGS)
    for s in (0, 1, 2, 3):
        assert first[s] == whole[s]
    for s in (4, 5):
        assert resumed[s] == whole[s]
    assert last == last_whole == whole[5][0]
    for a, b in zip(resumed["params"], whole["params"]):
        assert torch.equal(a, b)
    assert whole[5][0] < whole[0][0]


def test_serve_summary_keys_match_reference(capsys):
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--requests", "3",
            "--max-tokens", "2"]
    got = serve.main(argv + ["--device", "cpu"])
    want = jserve.main(argv)
    keys = lambda s: sorted(k for k, v in s.items()
                            if not isinstance(v, list))
    assert keys(got) == keys(want)
    assert got["n_done"] == want["n_done"] == 3


def test_serve_refuses_multi_gpu():
    """--backend nccl needs a card per rank: with fewer visible (none on
    this CPU) the launcher raises before it starts a process."""
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="nccl needs a card per rank"):
        serve.main(["--reduced", "--full-attention", "--device", "cpu",
                    "--tp", "2", "--ep", str(n + 1), "--backend", "nccl"])


def test_serve_default_pattern_over_four_gloo_ranks(capsys):
    """Over ranks the launcher serves the config's default OmniAttn
    pattern (reduced qwen2-moe-a2.7b: both layers sink + recent rings)
    without --full-attention: four gloo ranks, every request done by its
    length, as on one rank."""
    argv = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
            "--requests", "4", "--max-tokens", "3"]
    one = serve.main(argv)
    s = serve.main(argv + ["--tp", "2", "--ep", "2", "--backend", "gloo"])
    assert s["n_done"] == one["n_done"] == 4
    assert s["n_length"] == one["n_length"] == 4


def test_serve_mamba2_over_four_gloo_ranks(capsys):
    """Mamba-2 layers at tp 2 (each rank half the SSD heads, `ssm_norm`
    reduced over `model`): four gloo ranks serve reduced mamba2-130m, every
    request done by its length, as on one rank."""
    argv = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
            "--requests", "4", "--max-tokens", "3"]
    one = serve.main(argv)
    s = serve.main(argv + ["--tp", "2", "--ep", "2", "--backend", "gloo"])
    assert s["n_done"] == one["n_done"] == 4
    assert s["n_length"] == one["n_length"] == 4


def test_serve_over_four_gloo_ranks(capsys):
    """--tp 2 --ep 2 over gloo on the CPU: the launcher starts four ranks,
    each serves reduced qwen2-moe-a2.7b (every layer full) in lockstep,
    and rank 0's summary comes back with every request done."""
    s = serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                    "--full-attention", "--tp", "2", "--ep", "2",
                    "--backend", "gloo", "--device", "cpu",
                    "--requests", "4", "--max-tokens", "3"])
    assert s["n_done"] == 4
    assert '"n_done": 4' in capsys.readouterr().out
