"""The port's examples (examples/torch_*.py) on the CPU at their smoke
sizes, with the checks chip_smoke.py phase 20 (a) makes on the card:
quickstart serves every request and its repeat is an APC hit with the same
greedy stream; serve_disaggregated completes or aborts every request, the
failure drill requeues work, the pool invariants hold and no block leaks;
train_with_recovery --tiny resumes from its checkpoint step with a finite
final loss."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

torch.set_num_threads(2)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(monkeypatch):
    monkeypatch.setenv("REPRO_SMOKE", "1")
    r = _load("torch_quickstart").main(["--device", "cpu"])
    assert r["n_done"] == r["n_requests"] == 3
    assert r["apc_hits"] > 0 and r["repeat_equal"]


def test_serve_disaggregated():
    r = _load("torch_serve_disaggregated").main(["--device", "cpu"])
    assert r["n_done"] + r["n_aborted"] == r["n_requests"] == 8
    assert r["n_requeued"] >= 1 and r["aborted_rid"] is not None
    assert r["arena"] and r["leaked"] == []


def test_train_with_recovery(tmp_path):
    r = _load("torch_train_with_recovery").main(
        ["--tiny", "--steps", "6", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)])
    assert r["preempt_exit"] == 42
    assert r["resumed_at"] == r["expected_resume"] == 2
    assert r["finite"] and math.isfinite(r["final_loss"])


def test_examples_default_to_the_card():
    """Without a card the default device raises the port's error."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_quickstart").main([])
