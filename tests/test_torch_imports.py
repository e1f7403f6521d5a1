"""The PyTorch port stands alone: importing it (and each of its modules)
loads neither jax nor the JAX package `repro`, and no file of the port,
nor chip_smoke.py, chip_profile.py or chip_variants.py, imports either. The import check runs in
a subprocess because the test process has imported jax already
(tests/conftest.py)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_profile.py",
                                        ROOT / "chip_variants.py"]


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {n}"


def test_every_slice_module_is_checked():
    """The import check above walks the package; the modules of each slice
    (paged serving, the OmniAttn ring path, online top-k and SpecPlane,
    MoE with OmniPlacement, QuantPlane, training, checkpoints, the
    launchers, the frontend families' configs and the rank context of
    multi-rank placement) are among the ones it loads."""
    mods = set(_modules())
    for m in ("repro_torch.kernels.paged_decode",
              "repro_torch.kernels.sink_decode",
              "repro_torch.kernels.block_topk",
              "repro_torch.kernels.spec_verify",
              "repro_torch.serving.sparsity", "repro_torch.serving.spec",
              "repro_torch.core.omniattn.fidelity",
              "repro_torch.core.omniattn.search",
              "repro_torch.kernels.moe_gmm", "repro_torch.models.moe",
              "repro_torch.configs.qwen2_moe_a2_7b",
              "repro_torch.core.placement.static",
              "repro_torch.core.placement.dynamic",
              "repro_torch.core.placement.migration",
              "repro_torch.serving.quant", "repro_torch.tree",
              "repro_torch.training.optim", "repro_torch.training.data",
              "repro_torch.training.trainer", "repro_torch.checkpoint.store",
              "repro_torch.launch.train", "repro_torch.launch.serve",
              "repro_torch.configs.hubert_xlarge",
              "repro_torch.configs.phi3_vision",
              "repro_torch.distributed", "repro_torch.distributed.ctx"):
        assert m in mods, m
