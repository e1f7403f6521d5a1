"""The frontend families of the port against the JAX reference, on the CPU:
phi-3-vision-4.2b (a vlm: patch embeddings projected by `frontend` in
front of the tokens, causal, h 96 at full width) and hubert-xlarge (audio:
frames projected by `frontend`, an encoder-only bidirectional stack, h 80
at full width).

- `get_config` gives both configs equal to the reference's, field for
  field, and `reduced_config` too;
- on the bridged `LM.init(PRNGKey(0))` weights (float32), at the reduced
  configs (h 32) and at the same configs with the real head dims (80, 96):
  the vlm's `prefill` with patches (the last logits, the cache position
  counting the patch rows) and a `decode` step at position S + P, and
  hubert's per-frame logits [B, S, V], equal the reference's within 1e-5
  (two frameworks' float32 sums in another order through a 2-layer stack;
  the differences seen are ~4e-7);
- the vlm's prefill-then-decode equals one longer prefill (the reference's
  tests/test_consistency.py, every layer full attention), within its 2e-3;
- the port twins of the reference's `test_prefill_decode_smoke[phi-3-
  vision-4.2b]` and `test_encoder_only_forward` (tests/test_arch_smoke.py;
  its `test_train_step_smoke` twins for both archs are
  tests/test_torch_training.py::test_train_step_smoke);
- the Server and the serve launcher refuse vlm, audio and encoder-only
  configs with NotImplementedError (the reference's Server feeds tokens
  only), and `chunked_prefill_support` is (False, 0) for them;
- the wrappers whose kernels were not taught h 80 / 96 (paged_prefill,
  spec_verify, block_topk: ROADMAP B17b) still take only the powers of two,
  and the three that were (flash_prefill, sink_decode, paged_decode) take
  80 and 96.
tests/test_torch_frontends_train.py holds `train_loss`, its gradients,
`make_batch` and the launcher.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_frontends.py -q
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config
from repro.distributed.ctx import local_mesh_ctx
from repro.models import LM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.kernels import _common as kcommon
from repro_torch.kernels import (block_topk, flash_prefill, paged_decode,
                                 paged_prefill, sink_decode, spec_verify)
from repro_torch.launch import serve
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.server import Server, ServerConfig

torch.set_num_threads(2)

VLM, AUDIO = "phi-3-vision-4.2b", "hubert-xlarge"
F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(arch, pattern=None, **kw):
    """(reference LM, its params, port LM, bridged params), float32."""
    cfg = reduced_config(arch).with_updates(**F32, **kw)
    lm = LM.build(cfg, local_mesh_ctx(), pattern=pattern)
    params = lm.init(jax.random.PRNGKey(0))
    tlm = TLM.build(t_reduced_config(arch).with_updates(**F32, **kw),
                    pattern=pattern, device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tlm.cfg, tlm.plan, device="cpu")
    return lm, params, tlm, tparams


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(t_reduced_config(arch)) == \
        dataclasses.asdict(reduced_config(arch))


@pytest.mark.parametrize("hd", [32, 96])
def test_vlm_prefill_and_decode_match_reference(hd):
    lm, params, tlm, tparams = _models(VLM, head_dim=hd)
    cfg = lm.cfg
    P = cfg.num_patches
    rng = np.random.default_rng(hd)
    S = 24
    toks = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    pat = rng.standard_normal((1, P, cfg.frontend_dim)).astype(np.float32)
    assert tparams["frontend"].shape == (cfg.frontend_dim, cfg.d_model)
    cache, want, _ = lm.prefill(params, {"tokens": jnp.asarray(toks),
                                         "patches": jnp.asarray(pat)},
                                max_len=64)
    tcache, got, _ = tlm.prefill(tparams, torch.from_numpy(toks),
                                 patches=torch.from_numpy(pat), max_len=64)
    assert tcache["pos"] == P + S
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nxt = rng.integers(0, cfg.vocab_size, (1, 1)).astype(np.int32)
    _, want, _ = lm.decode(params, cache, jnp.asarray(nxt), jnp.int32(P + S))
    _, got, _ = tlm.decode(tparams, tcache, torch.from_numpy(nxt),
                           torch.tensor([[P + S]]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the frontend is live: zero patches give other logits
    _, zero, _ = tlm.prefill(tparams, torch.from_numpy(toks),
                             patches=torch.zeros(1, P, cfg.frontend_dim),
                             max_len=64)
    assert float((zero - tlm.prefill(tparams, torch.from_numpy(toks),
                                     patches=torch.from_numpy(pat),
                                     max_len=64)[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("hd", [32, 96])
def test_vlm_prefill_then_decode_matches_full_prefill(hd):
    """The reference's test_prefill_then_decode_matches_full_prefill[phi-3-
    vision-4.2b] on the port: every layer full attention, ones patches,
    B 2 × 24 tokens, the decode at position 23 + P (2e-3, its tolerance)."""
    cfg = t_reduced_config(VLM).with_updates(**F32, head_dim=hd)
    tlm = TLM.build(cfg, pattern=[0] * cfg.n_layers, device="cpu")
    params = tlm.init(0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    pat = torch.ones(2, cfg.num_patches, cfg.frontend_dim)
    _, full, _ = tlm.prefill(params, toks, patches=pat, max_len=48)
    cache, _, _ = tlm.prefill(params, toks[:, :-1], patches=pat, max_len=48)
    pos = 23 + cfg.num_patches
    _, dec, _ = tlm.decode(params, cache, toks[:, -1:],
                           torch.full((2, 1), pos))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("hd", [32, 80])
def test_encoder_logits_match_reference(hd):
    lm, params, tlm, tparams = _models(AUDIO, head_dim=hd)
    cfg = lm.cfg
    fr = np.random.default_rng(hd).standard_normal(
        (2, 32, cfg.frontend_dim)).astype(np.float32)
    cache, want, _ = lm.prefill(params, {"frames": jnp.asarray(fr)},
                                max_len=32)
    tcache, got, _ = tlm.prefill(tparams, frames=torch.from_numpy(fr))
    assert cache is None and tcache is None
    assert got.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bidirectional: the first frame's logits see the last frame
    fr2 = fr.copy()
    fr2[:, -1] += 1.0
    _, got2, _ = tlm.prefill(tparams, frames=torch.from_numpy(fr2))
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-6


def test_prefill_decode_smoke_vlm():
    """Port twin of tests/test_arch_smoke.py::test_prefill_decode_smoke
    [phi-3-vision-4.2b] (reduced config, bfloat16 as registered)."""
    cfg = t_reduced_config(VLM)
    lm = TLM.build(cfg, device="cpu")
    params = lm.init(0)
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    pat = torch.ones(B, cfg.num_patches, cfg.frontend_dim)
    cache, logits, _ = lm.prefill(params, toks, patches=pat,
                                  max_len=S + cfg.num_patches + 8)
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    pos = S + cfg.num_patches
    cache, logits, _ = lm.decode(params, cache, toks[:, :1],
                                 torch.full((B, 1), pos))
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()


def test_encoder_only_forward():
    """Port twin of tests/test_arch_smoke.py::test_encoder_only_forward."""
    cfg = t_reduced_config(AUDIO)
    lm = TLM.build(cfg, device="cpu")
    params = lm.init(0)
    B, S = 2, 32
    _, logits, _ = lm.prefill(params, frames=torch.ones(B, S,
                                                        cfg.frontend_dim),
                              max_len=S)
    assert logits.shape == (B, S, cfg.vocab_size)   # per-frame logits
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", [VLM, AUDIO, "encoder"])
def test_server_and_serve_launcher_refuse(arch):
    cfg = t_reduced_config("qwen2-1.5b").with_updates(encoder_only=True) \
        if arch == "encoder" else t_reduced_config(arch)
    lm = TLM.build(cfg, device="cpu")
    assert lm.chunked_prefill_support == (False, 0)
    with pytest.raises(NotImplementedError, match="token ids only"):
        Server(cfg, ServerConfig(), device="cpu")
    if arch != "encoder":
        with pytest.raises(NotImplementedError, match="token ids only"):
            serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_head_dims_each_wrapper_takes():
    """flash_prefill, sink_decode and paged_decode were taught h 80 and 96;
    paged_prefill, spec_verify and block_topk were not (ROADMAP B17b: on
    the card they raise ValueError at 80 / 96,
    tests/test_torch_kernels_gpu.py::
    test_head_dims_outside_the_kernels_raise)."""
    for mod in (flash_prefill, sink_decode, paged_decode):
        assert mod.WIDE_HEAD_DIMS == (32, 64, 80, 96, 128, 256)
        assert "WIDE_HEAD_DIMS" in vars(mod) and "HEAD_DIMS" not in vars(mod)
    for mod in (paged_prefill, spec_verify, block_topk):
        assert mod.HEAD_DIMS == (32, 64, 128, 256)
        assert "WIDE_HEAD_DIMS" not in vars(mod)
    assert kcommon.HEAD_DIMS == (32, 64, 128, 256)
