"""The train path on the card. Marked `gpu`: it skips without a CUDA
device. This file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -o markers=gpu -q tests/test_torch_training_gpu.py

- every kernel wrapper raises when grad mode is on and a CUDA input
  requires grad (a ctypes launch is no autograd op: a backward through it
  would leave the parameters upstream without their gradients), before it
  builds or launches anything;
- one float32 train step of reduced qwen2-1.5b on the card equals the
  same step on the CPU from the same parameters and batch: loss within
  1e-5 relative, gradient norm within 1e-4 relative (the same float32
  math, summed in other orders), and it launches no kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import _common as kcommon
from repro_torch.kernels.block_topk import (block_topk_scores,
                                            block_topk_select)
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.paged_prefill import paged_prefill
from repro_torch.kernels.sink_decode import sink_decode
from repro_torch.kernels.spec_verify import spec_verify
from repro_torch.models.lm import LM
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optim import adamw_init
from repro_torch.training.trainer import make_train_step
from repro_torch.tree import tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _calls(dev):
    """(name, call) per wrapper, the query requiring grad."""
    f = dict(device=dev)
    q4 = torch.randn(2, 2, 3, 64, **f, requires_grad=True)     # [B,K,G,h]
    qp = torch.randn(2, 2, 6, 64, **f, requires_grad=True)     # [B,K,S·G,h]
    kn = torch.randn(2, 2, 2, 64, **f)
    pages = torch.randn(8, 2, 16, 64, **f)
    tables = torch.ones(2, 2, dtype=torch.int32, device=dev)
    lens = torch.full((2,), 20, dtype=torch.int32, device=dev)
    summ = torch.randn(8, 2, 64, **f)
    dense = torch.randn(2, 2, 32, 64, **f)
    return (
        ("flash_prefill", lambda: flash_prefill(
            torch.randn(4, 32, 64, **f, requires_grad=True),
            torch.randn(4, 32, 64, **f), torch.randn(4, 32, 64, **f))),
        ("paged_prefill", lambda: paged_prefill(
            qp, kn, kn, pages, pages, tables, 4, 2)),
        ("paged_decode", lambda: paged_decode(q4, pages, pages, tables,
                                              lens)),
        ("sink_decode", lambda: sink_decode(q4, dense, dense, 20)),
        ("spec_verify", lambda: spec_verify(qp, kn, kn, pages, pages,
                                            tables, lens, 2)),
        ("block_topk_scores", lambda: block_topk_scores(
            q4, summ, summ, tables, lens, block_size=16)),
        ("block_topk_select", lambda: block_topk_select(
            q4, summ, summ, tables, lens, block_size=16, k_static=1)),
        ("moe_gmm", lambda: moe_gmm(
            torch.randn(2, 8, 64, **f, requires_grad=True),
            torch.randn(2, 64, 32, **f),
            torch.full((2,), 8, dtype=torch.int32, device=dev))))


@pytest.mark.parametrize("i", range(8))
def test_wrapper_refuses_grad_inputs(cuda, i):
    name, call = _calls(cuda)[i]
    before = kcommon.launch_counts()
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="no backward"):
        call()
    assert kcommon.launch_counts() == before, name


def test_train_step_card_equals_cpu(cuda):
    cfg = reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", remat=True)
    out = {}
    before = kcommon.launch_counts()
    for dev in ("cpu", cuda):
        lm = LM.build(cfg, device=dev)
        params = lm.init(0) if dev == "cpu" else \
            tree_map(lambda t: t.to(dev), out["cpu_params"])
        if dev == "cpu":
            out["cpu_params"] = tree_map(torch.clone, params)
        batch = make_batch(cfg, DataConfig(cfg.vocab_size, 64, 4), 0,
                           device=dev)
        _, _, m = make_train_step(lm)(params, adamw_init(params), batch)
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
    assert kcommon.launch_counts() == before
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
