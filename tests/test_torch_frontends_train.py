"""Training the frontend families on the port against the JAX reference,
on the CPU: phi-3-vision-4.2b (patches in front of the tokens, a zero loss
mask over them) and hubert-xlarge (frames, bidirectional, encoder-only).

- `make_batch` gives the reference's frames / patches / tokens / labels /
  mask element for element (the same seeded numpy streams);
- `LM.train_loss` and every parameter's gradient, the `frontend`
  projection's included, equal `jax.value_and_grad` of the reference's on
  the bridged `LM.init(PRNGKey(0))` weights (float32), at the reduced
  configs (h 32) and with the real head dims (96, 80): the loss within 1e-5
  relative, each gradient leaf within 2e-3 of its largest magnitude
  (tests/test_torch_training.py's tolerances: two frameworks summing in
  different orders through a whole stack); train mode launches no kernel;
- `launch/train.py --arch <id> --reduced` runs two steps of both (finite
  losses, the `frontend` projection moved, no kernel launched), and the
  checkpoint it writes restores the `frontend` leaf bit for bit.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_frontends_train.py -q
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.distributed.ctx import local_mesh_ctx
from repro.models import LM
from repro.training import data as jdata
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.kernels import _common as kcommon
from repro_torch.launch import train
from repro_torch.models.lm import LM as TLM
from repro_torch.training import data as tdata
from repro_torch.training.optim import adamw_init
from repro_torch.training.trainer import loss_and_grads
from repro_torch.tree import tree_unflatten

torch.set_num_threads(2)

VLM, AUDIO = "phi-3-vision-4.2b", "hubert-xlarge"
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _close_to_max(got, want, frac, what):
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = frac * float(np.abs(want).max()) + 1e-12
    assert err <= lim, f"{what}: max |diff| {err:.3g} > {lim:.3g}"


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_make_batch_matches_reference(arch):
    cfg = reduced_config(arch)
    for step in (0, 7):
        want = jdata.make_batch(cfg, jdata.DataConfig(cfg.vocab_size, 48, 3,
                                                      seed=2), step)
        got = tdata.make_batch(t_reduced_config(arch),
                               tdata.DataConfig(cfg.vocab_size, 48, 3,
                                                seed=2), step, device="cpu")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch,hd", [(VLM, 32), (VLM, 96), (AUDIO, 32),
                                     (AUDIO, 80)])
def test_train_loss_and_grads_match_reference(arch, hd):
    cfg = reduced_config(arch).with_updates(**F32, head_dim=hd)
    lm = LM.build(cfg, local_mesh_ctx())
    params = lm.init(jax.random.PRNGKey(0))
    tlm = TLM.build(t_reduced_config(arch).with_updates(**F32, head_dim=hd),
                    device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tlm.cfg, tlm.plan, device="cpu")
    jb = jdata.make_batch(cfg, jdata.DataConfig(cfg.vocab_size, 48, 2), 1)
    tb = tdata.make_batch(tlm.cfg, tdata.DataConfig(cfg.vocab_size, 48, 2),
                          1, device="cpu")
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: lm.train_loss(p, jb), has_aux=True))(params)
    before = kcommon.launch_counts()
    # hubert's token embedding is not read: a zero gradient, as jax.grad's
    loss, g = loss_and_grads(tlm, tparams, tb)
    g = tree_unflatten(tparams, g)
    assert kcommon.launch_counts() == before
    loss = float(loss)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert 0 < loss < 50
    got = bridge.params_to_numpy(g, tlm.plan)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jg)
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    assert "frontend" in got
    for (path, a), (_, b) in zip(gl, wl):
        assert a.shape == b.shape, path
        _close_to_max(a, b, 2e-3, f"{arch} {jax.tree_util.keystr(path)}")
    assert float(np.abs(got["frontend"]).max()) > 0


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_launcher_and_checkpoint(arch, tmp_path):
    seen = {}

    def on_step(step, params, opt, metrics):
        seen[step] = float(metrics["loss"])
        seen["frontend"] = params["frontend"].clone()
    before = kcommon.launch_counts()
    last = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--seq", "32", "--steps", "2",
                       "--lr", "1e-3", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "2"], on_step=on_step)
    assert kcommon.launch_counts() == before
    assert np.isfinite([seen[0], seen[1]]).all() and last == seen[1]
    lm = TLM.build(t_reduced_config(arch), device="cpu")
    shapes = lm.shapes()
    state, step, _ = CheckpointManager(tmp_path).restore(
        template={"params": shapes,
                  "opt": adamw_init(shapes, lm.cfg.optimizer_dtype)},
        device="cpu")
    assert step == 2
    assert torch.equal(state["params"]["frontend"], seen["frontend"])
    assert not torch.equal(seen["frontend"], lm.init(0)["frontend"])
