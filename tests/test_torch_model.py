"""Model slice of the PyTorch port against the JAX reference: the same
weights (JAX `LM.init(PRNGKey(0))`, bridged through numpy) give the same
logits through paged chunked prefill and paged decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.distributed.ctx import local_mesh_ctx
from repro.models import LM
from repro.models import stack as jstack
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.models import stack as tstack
from repro_torch.models.lm import LM as TLM

torch.set_num_threads(2)

# the tolerance of tests/test_consistency.py:40 (f32 logits, two stacks
# summing in different orders)
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def models():
    cfg = reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    lm = LM.build(cfg, local_mesh_ctx(), pattern=[0, 0])
    params = lm.init(jax.random.PRNGKey(0))
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    tlm = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, tlm.plan, device="cpu")
    return lm, params, tlm, tparams


def test_bridge_unstacks_period_leaves(models):
    lm, params, tlm, tparams = models
    assert len(tparams["layers"]) == 2
    for r in range(2):
        np.testing.assert_array_equal(
            tparams["layers"][r]["wq"].numpy(),
            np.asarray(params["stack"]["period"][0]["wq"][r]))
    np.testing.assert_array_equal(tparams["embed"].numpy(),
                                  np.asarray(params["embed"]))


def test_init_matches_reference_schema(models):
    """The port's seeded init has the reference's shapes and scales."""
    lm, params, tlm, tparams = models
    fresh = tlm.init(seed=3)
    assert fresh.keys() == tparams.keys()
    for a, b in zip(fresh["layers"], tparams["layers"]):
        assert {k: tuple(v.shape) for k, v in a.items()} == \
            {k: tuple(v.shape) for k, v in b.items()}
    assert float(fresh["layers"][0]["wq"].std()) == pytest.approx(0.02,
                                                                  rel=0.1)
    assert float(fresh["layers"][0]["bq"].abs().max()) == 0.0


@pytest.mark.parametrize("chunk,bs", [(8, 16), (64, 8)])
def test_paged_prefill_and_decode_logits_match(models, chunk, bs):
    """Chunks of `chunk` tokens after a first chunk that ends mid-block
    (history offset 5), over a scrambled block table, then decode steps."""
    lm, params, tlm, tparams = models
    cfg, tcfg = lm.cfg, tlm.cfg
    max_len, N = 160, 48
    nb = -(-max_len // bs)
    rng = np.random.default_rng(chunk * 31 + bs)
    prompt = rng.integers(0, cfg.vocab_size, 5 + chunk + 3).tolist()
    row = np.zeros((1, nb), np.int32)
    row[0] = rng.permutation(np.arange(1, N))[:nb]
    tbl_j, tbl_t = jnp.asarray(row), torch.from_numpy(row)

    jarena = jstack.alloc_arena_kv(cfg, lm.mesh, lm.plan, N, bs)
    jcache = jstack.merge_arena_cache(
        cfg, lm.plan,
        jstack.alloc_prefill_private_cache(cfg, lm.mesh, lm.plan, max_len),
        jarena)
    tarena = tstack.alloc_arena_kv(tcfg, tlm.plan, N, bs, "cpu")
    tcache = tstack.merge_arena_cache(
        tcfg, tlm.plan,
        tstack.alloc_prefill_private_cache(tcfg, tlm.plan, max_len, "cpu"),
        tarena)

    # the reference runs jitted, as its engines run it
    jprefill = jax.jit(lambda p, t, c, cl, bt: lm.prefill_resume(
        p, {"tokens": t}, c, max_len=max_len, chunk_len=cl,
        block_tables=bt)[:2])
    jdecode = jax.jit(lambda p, c, t, pos, bt: lm.decode(
        p, c, t, pos, block_tables=bt)[:2])
    cur = 0
    for cl in (5, chunk, 3):
        toks = prompt[cur:cur + cl] + [0] * (chunk - cl)
        jcache, jl = jprefill(params, jnp.asarray([toks], jnp.int32), jcache,
                              jnp.int32(cl), tbl_j)
        tcache, tl, _ = tlm.prefill_resume(
            tparams, torch.tensor([toks], dtype=torch.int32), tcache,
            chunk_len=cl, block_tables=tbl_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cur += cl
    assert tcache["pos"] == cur == int(jcache["pos"])

    tok = int(np.argmax(np.asarray(jl)[0]))
    for _ in range(4):
        jcache, jl = jdecode(params, jcache, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([[cur]], jnp.int32), tbl_j)
        tcache, tl, _ = tlm.decode(tparams, tcache,
                                torch.tensor([[tok]], dtype=torch.int32),
                                torch.tensor([[cur]], dtype=torch.int32),
                                block_tables=tbl_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))
        cur += 1
    # the arenas and their summaries agree too, outside the null block 0
    # (padded rows collide there; which duplicate write lands is unordered)
    jent = jcache["period"][0]                  # leaves [n_rep, N, ...]
    for li in range(2):
        for name in ("k", "v", "kmin", "kmax", "kmean"):
            np.testing.assert_allclose(
                tcache["layers"][li][name].numpy()[1:],
                np.asarray(jent[name])[li, 1:], rtol=1e-4, atol=1e-4,
                err_msg=name)


def test_unsupported_configs_raise():
    tcfg = t_reduced_config("qwen2-1.5b")
    TLM.build(tcfg, pattern=None, device="cpu")         # ring layers serve
    # ... and so does chunked prefill over a dense B=1 cache: a full chunk
    # and a padded one (5 real rows of 8, wrapping the 16-slot rings) give
    # the logits of whole-prompt prefill under prefill_sparse
    scfg = tcfg.with_updates(prefill_sparse=True, compute_dtype="float32",
                             param_dtype="float32")
    lm = TLM.build(scfg, pattern=None, device="cpu")
    params = lm.init(0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, scfg.vocab_size, (1, 24)).astype(np.int32))
    cache = tstack.alloc_cache(scfg, lm.plan, 1, 64, "cpu")
    cache, _, _ = lm.prefill_resume(params, toks[:, :16], cache)
    cache, got, _ = lm.prefill_resume(params, toks[:, 16:], cache,
                                      chunk_len=5)
    assert cache["pos"] == 21
    _, want, _ = lm.prefill(params, toks, max_len=64, true_len=21)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    # online top-k builds (it is served on paged KV), and so do SSM layers:
    # attn_period=2 makes layers off its attention offset Mamba-2 layers,
    # the plan the reference's
    import dataclasses

    from repro.models import stack as jstack
    TLM.build(tcfg.with_updates(omniattn_topk_blocks=2), pattern=[0, 0],
              device="cpu")
    hcfg = tcfg.with_updates(omniattn_topk_blocks=2, attn_period=2)
    hyb = TLM.build(hcfg, pattern=[0, 0], device="cpu")
    assert "mamba" in [s.kind for s in hyb.plan.all_specs()]
    assert hyb.plan.all_specs() == \
        jstack.StackPlan.from_config(hcfg, [0, 0]).all_specs()
    # encoder-only and frontend families build, with the reference's plan
    # and a frontend projection; an unknown family stays refused
    enc = TLM.build(tcfg.with_updates(encoder_only=True), pattern=[0, 0],
                    device="cpu")
    assert enc.chunked_prefill_support == (False, 0)
    acfg = tcfg.with_updates(family="audio", frontend_dim=64)
    aud = TLM.build(acfg, pattern=[0, 0], device="cpu")
    assert aud.plan.all_specs() == \
        jstack.StackPlan.from_config(acfg, [0, 0]).all_specs()
    assert aud.param_defs()["frontend"][0] == (64, acfg.d_model)
    with pytest.raises(NotImplementedError):
        TLM.build(tcfg.with_updates(family="diffusion"), pattern=[0, 0],
                  device="cpu")
    # the registry: qwen3-moe, mamba2-130m and the encoder hubert-xlarge
    # (and the other architectures the stack models) are registered with
    # the reference's configuration; an unknown id is not
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    for arch in ("qwen3-moe-235b-a22b", "mamba2-130m", "hubert-xlarge"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(j_get_config(arch))
    with pytest.raises(NotImplementedError):            # not registered
        get_config("hubert-base")
    # MoE serves, with online top-k too: the model's selection plan is the
    # reference's (tests/test_torch_compositions.py holds the served
    # streams to the JAX Server)
    from repro.models import LM as JLM
    from repro.serving.sparsity import SparsityController as JSC
    from repro_torch.serving.sparsity import SparsityController as TSC
    mcfg = t_reduced_config("qwen2-moe-a2.7b")
    TLM.build(mcfg, pattern=[0, 0], device="cpu")
    tk = TLM.build(mcfg.with_updates(omniattn_topk_blocks=2), pattern=[0, 0],
                   device="cpu")
    jk = JLM.build(reduced_config("qwen2-moe-a2.7b").with_updates(
        omniattn_topk_blocks=2), local_mesh_ctx(), pattern=[0, 0])
    assert dataclasses.asdict(TSC.from_model(tk.cfg, tk.plan, 8, 12).plan) \
        == dataclasses.asdict(JSC.from_model(jk.cfg, jk.plan, 8, 12).plan)
