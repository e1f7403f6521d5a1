"""ContractGuard for the PyTorch port: linter fixtures (a good/bad pair per
rule, the reference's four waiver cases, the CLI's exit codes), the
HotLoopRegistry completeness contract, the live hot-loop audit over
reduced qwen2-1.5b port servers (clean, and each planted fault caught by
its check), and parity with the reference's JAX-free pieces
(`repro.analysis.diagnostics`, `repro.analysis.rules.hygiene`).

Fixture snippets run through the exact production pipeline via
`run_lint(files=...)` — same parsing, same rules, same waiver handling
the CLI uses on the real tree. No JAX `Server` is built here.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.lint import run_lint

REPO = Path(__file__).resolve().parents[1]
IGNORES = "__pycache__/\n*.pyc\nsrc/repro_torch/kernels/_build/\n"

torch.set_num_threads(2)


def rules_hit(files, **kw):
    rep = run_lint(files=files, tracked_files=kw.pop("tracked_files", []),
                   gitignore_text=kw.pop("gitignore_text", IGNORES), **kw)
    return rep, {d.rule for d in rep.diagnostics if not d.waived}


def lines_of(rep, rule):
    return sorted((d.path, d.line) for d in rep.diagnostics
                  if d.rule == rule)


# ---------------------------------------------------------------------------
# rule fixtures: one good/bad pair per rule
# ---------------------------------------------------------------------------

def test_hot_loop_choke_point_pair():
    bad = {"src/repro_torch/serving/decode.py":
           "import torch\n"
           "class D:\n"
           "    def __post_init__(self):\n"
           "        self.g = torch.cuda.CUDAGraph()\n"
           "        with torch.cuda.graph(self.g):\n"
           "            pass\n"}
    rep, hit = rules_hit(bad)
    assert lines_of(rep, "hot-loop-choke-point") == [
        ("src/repro_torch/serving/decode.py", 4),
        ("src/repro_torch/serving/decode.py", 5)]
    good = {"src/repro_torch/serving/decode.py":
            "class D:\n"
            "    def __post_init__(self):\n"
            "        self._step = self.placement.hot_loop(\n"
            "            self._step_impl, name='decode.step')\n",
            # the choke point itself is allowed to capture
            "src/repro_torch/serving/placement.py":
            "import torch\n"
            "def capture(fn, pool):\n"
            "    g = torch.cuda.CUDAGraph()\n"
            "    with torch.cuda.graph(g, pool=pool):\n"
            "        fn()\n"
            "    return g\n",
            # outside serving/ the rule does not look
            "src/repro_torch/models/lm.py":
            "import torch\nf = torch.compile(lambda x: x)\n"}
    _, hit = rules_hit(good)
    assert "hot-loop-choke-point" not in hit


def test_choke_point_catches_every_spelling():
    bad = {"src/repro_torch/serving/prefill.py":
           "import functools\n"
           "import torch\n"
           "import torch.cuda as tc\n"
           "from torch.cuda import make_graphed_callables as mgc\n"
           "@torch.compile\n"
           "def f(x):\n"
           "    return x\n"
           "@functools.partial(torch.compile, mode='reduce-overhead')\n"
           "def g(x):\n"
           "    return x\n"
           "h = torch.jit.script(f)\n"
           "k = mgc(f, (torch.zeros(1),))\n"
           "gr = tc.CUDAGraph()\n"
           "t = torch.jit.trace(f, torch.zeros(1))\n"
           "c = torch.compile(g, fullgraph=True)\n"}
    rep, _ = rules_hit(bad)
    lines = {ln for _, ln in lines_of(rep, "hot-loop-choke-point")}
    assert lines == {5, 8, 11, 12, 13, 14, 15}


def test_proxy_torch_free_direct_import():
    bad = {"src/repro_torch/core/proxy/params.py": "import numpy as np\n"
           "def f():\n"
           "    from torch.nn import functional as F\n"
           "    return F\n"}
    rep, hit = rules_hit(bad)
    assert lines_of(rep, "proxy-torch-free") == [
        ("src/repro_torch/core/proxy/params.py", 3)]
    good = {"src/repro_torch/core/proxy/params.py": "import numpy as np\n"}
    _, hit = rules_hit(good)
    assert "proxy-torch-free" not in hit


def test_proxy_torch_free_transitive_import():
    files = {
        "src/repro_torch/core/proxy/oas.py":
            "import numpy as np\n"
            "from repro_torch.serving.helper import f\n",
        "src/repro_torch/serving/helper.py":
            # two hops: helper itself is torch-free but pulls in a module
            # that is not
            "from repro_torch.serving.deep import g\ndef f():\n    pass\n",
        "src/repro_torch/serving/deep.py":
            "import torch.distributed as dist\ndef g():\n    pass\n"}
    rep, hit = rules_hit(files)
    (d,) = [x for x in rep.diagnostics if x.rule == "proxy-torch-free"]
    assert (d.path, d.line) == ("src/repro_torch/core/proxy/oas.py", 2)
    assert ("repro_torch.core.proxy.oas -> repro_torch.serving.helper -> "
            "repro_torch.serving.deep") in d.msg
    # numpy-only intra-repo deps stay clean
    ok = {"src/repro_torch/core/proxy/oas.py":
          "from repro_torch.core.proxy.radix import RadixTree\n",
          "src/repro_torch/core/proxy/radix.py": "import numpy as np\n"}
    _, hit = rules_hit(ok)
    assert "proxy-torch-free" not in hit


def test_host_sync_flags_every_fetch_in_impl():
    bad = {"src/repro_torch/serving/decode.py":
           "import numpy as np\n"
           "import torch\n"
           "class D:\n"
           "    def _step_impl(self, key, tbl, out):\n"
           "        v = self.state['t'].item()\n"
           "        n = int(tbl[0])\n"
           "        a = out.cpu()\n"
           "        b = out.tolist()\n"
           "        c = out.numpy()\n"
           "        torch.cuda.synchronize()\n"
           "        d = out.to('cpu')\n"
           "        e = out.to(device='cpu')\n"
           "        f = np.asarray(out)\n"
           "        if bool(out.any()):\n"
           "            pass\n"
           "        return out\n"}
    rep, _ = rules_hit(bad)
    lines = {ln for _, ln in lines_of(rep, "no-host-sync-in-impl")}
    assert lines == set(range(5, 15))


def test_host_sync_covers_functions_handed_to_hot_loop():
    bad = {"src/repro_torch/serving/spec.py":
           "def draft(key, x):\n"
           "    return x.max().item()\n"
           "class S:\n"
           "    def __init__(self, pl):\n"
           "        self.d = pl.hot_loop(draft, name='spec.draft')\n"}
    rep, _ = rules_hit(bad)
    assert lines_of(rep, "no-host-sync-in-impl") == [
        ("src/repro_torch/serving/spec.py", 2)]


def test_host_sync_allows_host_glue_key_and_shapes():
    good = {"src/repro_torch/serving/decode.py":
            "import numpy as np\n"
            "class D:\n"
            "    def __init__(self, pl):\n"
            "        self._r = pl.hot_loop(self._r_impl, name='decode.r')\n"
            "    def _r_impl(self, key, x, out):\n"
            "        npad, greedy = key\n"          # the key is host data
            "        a = int(x.shape[0]) + x.size(1) + x.dim()\n"
            "        b = int(npad) + len(x) + bool(greedy)\n"
            "        c = np.asarray(x.shape)\n"
            "        return out.copy_(x[:a + b])\n"
            "    def step_host(self, out):\n"       # not a hot-loop body
            "        return int(np.asarray(out.cpu())[0])\n"}
    _, hit = rules_hit(good)
    assert "no-host-sync-in-impl" not in hit


def test_seeded_rng_only_pair():
    bad = {"src/repro_torch/serving/sched.py":
           "import time, random\n"
           "import numpy as np\n"
           "import torch\n"
           "def schedule(x):\n"
           "    a = (time.time(), np.random.rand(3),\n"
           "         np.random.default_rng(), random.randint(0, 5))\n"
           "    torch.manual_seed(0)\n"
           "    torch.cuda.manual_seed_all(0)\n"
           "    b = torch.rand(3)\n"
           "    c = torch.multinomial(x, 1)\n"
           "    d = torch.randn_like(x)\n"
           "    x.uniform_()\n"
           "    x.exponential_()\n"
           "    return a, b, c, d\n"}
    rep, hit = rules_hit(bad)
    assert lines_of(rep, "seeded-rng-only") == [
        ("src/repro_torch/serving/sched.py", ln)
        for ln in (5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13)]
    good = {"src/repro_torch/core/placement/sched.py":
            "import time, random\n"
            "import numpy as np\n"
            "import torch\n"
            "def schedule(seed, x):\n"
            "    rng = np.random.default_rng(seed)\n"
            "    r2 = random.Random(seed)\n"
            "    t = time.monotonic()\n"
            "    g = torch.Generator().manual_seed(seed)\n"
            "    a = torch.rand(3, generator=g)\n"
            "    x.exponential_(generator=g)\n"
            "    return rng, r2, t, a\n",
            # out of scope: launch/ may use wall-clock and the global seed
            "src/repro_torch/launch/bench.py":
            "import time, torch\nt = time.time()\ntorch.manual_seed(0)\n"}
    _, hit = rules_hit(good)
    assert "seeded-rng-only" not in hit


def test_no_shape_leak_pair():
    src = ("class P:\n"
           "    def __init__(self, pl):\n"
           "        self._chunk_step = pl.hot_loop(self._chunk_impl,\n"
           "                                       name='prefill.chunk')\n"
           "    def go(self, toks, row):\n"
           "        return self._chunk_step(({}, self.layout),\n"
           "                                (toks, row))\n")
    bad = {"src/repro_torch/serving/prefill.py":
           src.replace("{}", "toks.shape[1]")}
    rep, _ = rules_hit(bad)
    assert lines_of(rep, "no-shape-leak") == [
        ("src/repro_torch/serving/prefill.py", 6)]
    good = {"src/repro_torch/serving/prefill.py":
            src.replace("{}", "_bucket(toks.shape[1])")}
    _, hit = rules_hit(good)
    assert "no-shape-leak" not in hit


def test_repo_hygiene_tracked_artifacts_and_gitignore():
    rep, hit = rules_hit({}, tracked_files=[
        "src/repro_torch/__pycache__/x.pyc", "tests/.pytest_cache/v/cache",
        "src/repro_torch/kernels/_build/paged_decode.so",
        "src/repro_torch/kernels/csrc/paged_decode.cu"],
        gitignore_text="")
    assert lines_of(rep, "repo-hygiene") == [
        (".gitignore", 1)] * 3 + [
        ("src/repro_torch/__pycache__/x.pyc", 1),
        ("src/repro_torch/kernels/_build/paged_decode.so", 1),
        ("tests/.pytest_cache/v/cache", 1)]
    rep, hit = rules_hit({}, tracked_files=[
        "src/repro_torch/kernels/csrc/paged_decode.cu",
        "src/repro_torch/serving/decode.py"])
    assert "repo-hygiene" not in hit


# ---------------------------------------------------------------------------
# waiver handling (the reference's four cases)
# ---------------------------------------------------------------------------

BAD_IMPL = ("class D:\n"
            "    def _step_impl(self, key, state):\n"
            "        {}\n"
            "        return state\n")


def _lint_impl(line):
    return run_lint(files={"src/repro_torch/serving/decode.py":
                           BAD_IMPL.format(line)},
                    tracked_files=[], gitignore_text=IGNORES)


def test_waiver_downgrades_and_echoes_justification():
    rep = _lint_impl("v = state.item()  # contract: waive "
                     "no-host-sync-in-impl -- warmup-only probe, never "
                     "reached in a captured step")
    assert rep.ok() and rep.ok(strict=True)
    (d,) = rep.waived()
    assert d.justification.startswith("warmup-only probe")
    assert "warmup-only probe" in rep.format()  # report echoes the why


def test_waiver_on_line_above():
    rep = _lint_impl("# contract: waive no-host-sync-in-impl -- fixture "
                     "reason\n        v = state.item()")
    assert rep.ok() and len(rep.waived()) == 1


def test_waiver_is_rule_and_line_narrow():
    # wrong rule id -> violation stays, waiver goes stale
    rep = _lint_impl("v = state.item()  # contract: waive seeded-rng-only "
                     "-- wrong rule")
    assert not rep.ok()
    assert any(d.rule == "stale-waiver" for d in rep.errors(strict=True))


def test_waiver_without_justification_fails_strict():
    rep = _lint_impl("v = state.item()  # contract: waive "
                     "no-host-sync-in-impl")
    assert rep.ok() and not rep.ok(strict=True)  # --strict still fails
    assert any(d.rule == "waiver-missing-justification"
               for d in rep.errors(strict=True))


# ---------------------------------------------------------------------------
# the real tree is contract-clean; the CLI's exit codes
# ---------------------------------------------------------------------------

def test_cli_strict_is_clean_on_the_real_tree():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--strict"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "contract lint: 0 error(s)" in res.stdout
    from repro_torch.analysis import contract_gate
    assert contract_gate().ok(strict=True)


def test_cli_exit_codes_on_fixtures(monkeypatch, capsys):
    import repro_torch.analysis.__main__ as cli
    files = {"src/repro_torch/serving/decode.py": BAD_IMPL.format(
        "v = state.item()  # contract: waive no-host-sync-in-impl")}
    monkeypatch.setattr(cli, "run_lint", lambda rules=None: run_lint(
        files=files, rules=rules, tracked_files=[], gitignore_text=IGNORES))
    assert cli.main([]) == 0                     # waived: not strict
    assert cli.main(["--strict"]) == 1           # no justification
    assert "waiver-missing-justification" in capsys.readouterr().out
    assert cli.main(["--list-rules"]) == 0
    listed = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()}
    assert listed == {"hot-loop-choke-point", "no-host-sync-in-impl",
                      "no-shape-leak", "proxy-torch-free", "repo-hygiene",
                      "seeded-rng-only"}
    with pytest.raises(SystemExit) as e:
        cli.main(["--rule", "no-such-rule"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# HotLoopRegistry completeness and the live audit on reduced port servers
# ---------------------------------------------------------------------------

def _hot_loop_sites():
    """(fn name, entry name) of every hot_loop(...) call in serving/*.py."""
    sites = set()
    for f in sorted((REPO / "src/repro_torch/serving").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "hot_loop" and node.args:
                tgt = node.args[0]
                name = next(k.value.value for k in node.keywords
                            if k.arg == "name")
                sites.add((tgt.attr if isinstance(tgt, ast.Attribute)
                           else tgt.id, name))
    return sites


def _cfg(**kw):
    from repro_torch.configs import reduced_config
    return reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2, **kw)


def _server(pattern=(0, 0), **knobs):
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    scfg = ServerConfig(n_prefill=1, n_decode=1, decode_slots=3, max_len=96,
                        chunk_tokens=16, prefill_tick_budget=32,
                        kv_blocks=40, kv_block_size=8,
                        oas=OASConfig(defer_window=0.0), **knobs)
    return Server(_cfg(), scfg, pattern=None if pattern is None
                  else list(pattern), device="cpu", seed=0)


def _requests(vocab):
    """Three prompts over a shared prefix that draft, one short prompt and
    one seeded sampled request: 4 new tokens each."""
    from repro_torch.core.proxy import SamplingParams
    rng = np.random.default_rng(7)
    base = tuple(int(t) for t in rng.integers(0, vocab, 40))
    prompts = [base + tuple(int(t) for t in rng.integers(0, vocab, 8))
               for _ in range(3)]
    prompts.append(tuple(int(t) for t in rng.integers(0, vocab, 6)))
    return [(p, SamplingParams(max_tokens=4)) for p in prompts] + [
        (prompts[0], SamplingParams(temperature=0.8, seed=3, max_tokens=4))]


def _audited_run(srv, require_called=True, plant=None):
    """Serve the requests with the audit attached from the start; `plant`
    {entry name: wrapper(fn, entry) → fn} swaps entries' fns first."""
    from repro_torch.analysis.hot_loop_audit import audit_server
    audit = audit_server(srv, require_called=require_called)
    for e in srv.placement.hot_loops.entries:
        if plant and e.name in plant:
            e.fn = plant[e.name](e.fn, e)
    with audit:
        s = srv.run(_requests(srv.cfg.vocab_size), max_wall_s=120)
    assert s["n_done"] == 5
    return audit.report()


SERVERS = ("paged_spec", "quant", "whole")


def _build(kind):
    """Paged KV with SpecConfig(k=4), int8 arenas, or whole-prompt prefill
    under the default OmniAttn pattern."""
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    if kind == "paged_spec":
        return _server(spec=SpecConfig(k=4))
    if kind == "quant":
        return _server(quant=QuantConfig())
    return _server(pattern=None)


def test_registry_covers_every_serving_hot_loop_site():
    sites = _hot_loop_sites()
    assert len(sites) == 5, sites
    registered = set()
    for kind in ("paged_spec", "whole"):
        srv = _build(kind)
        registered |= {(e.fn.__name__, e.name)
                       for e in srv.placement.hot_loops.entries}
    missing = sites - registered
    assert not missing, f"hot_loop call sites never registered: {missing}"


@pytest.mark.parametrize("kind", SERVERS)
def test_audit_of_a_reduced_server_is_clean(kind):
    srv = _build(kind)
    rep = _audited_run(srv)
    assert rep.ok(), rep.format()
    assert rep.audited == srv.placement.hot_loops.names() and \
        not rep.skipped, rep.format()
    calls = sum(len(e["ops"]) for e in rep.entries.values())
    for check in ("purity", "f64", "in-place"):
        assert rep.checks[check] == calls, rep.format()
    # QuantPlane arms the upcast check on every entry that holds the arena
    assert rep.checks.get("quant-upcast", 0) == (
        sum(len(rep.entries[n]["ops"]) for n in rep.entries
            if n != "prefill.first") if kind == "quant" else 0)
    assert all(min(e["ops"]) > 0 for e in rep.entries.values())
    # a key's first call only: one observed call per key
    for name, e in rep.entries.items():
        assert len(e["ops"]) == e["keys"], (name, e)


def test_audit_skips_entries_never_called_unless_required():
    from repro_torch.analysis.hot_loop_audit import audit_server
    srv = _build("paged_spec")
    with audit_server(srv) as a:
        pass
    rep = a.report()
    assert rep.ok() and rep.skipped == srv.placement.hot_loops.names()
    with audit_server(srv, require_called=True) as a:
        pass
    rep = a.report()
    assert {f.check for f in rep.findings} == {"called"}
    assert all(e.auditor is None for e in srv.placement.hot_loops.entries)


def _item(fn, entry):
    def bad(key, *static):
        out = fn(key, *static)
        out.float().sum().item()
        return out
    return bad


def _f64(fn, entry):
    def bad(key, *static):
        out = fn(key, *static)
        (out.double() * 2).sum()
        return out
    return bad


def _dequant(fn, entry):
    def bad(key, *static):
        out = fn(key, *static)
        e = next(x for x in entry.arenas() if x is not None)
        (e["k"].float() * e["kscale"][:, :, None, :]).sum()
        return out
    return bad


def _out_of_place(fn, entry):
    def bad(key, *static):
        out = fn(key, *static)
        e = next(x for x in entry.arenas() if x is not None)
        e["v"] = e["v"].clone()
        return out
    return bad


@pytest.mark.parametrize("kind,plant,check", [
    ("paged_spec", _item, "purity"), ("paged_spec", _f64, "f64"),
    ("quant", _dequant, "quant-upcast"), ("paged_spec", _out_of_place,
                                          "in-place")],
    ids=["item", "float64", "whole_arena_dequant", "out_of_place_arena"])
def test_audit_catches_a_planted_fault(kind, plant, check):
    srv = _build(kind)
    rep = _audited_run(srv, plant={"decode.step": plant})
    hits = {(f.entry, f.check) for f in rep.findings}
    assert ("decode.step", check) in hits, rep.format()
    assert {e for e, _ in hits} == {"decode.step"}, rep.format()
    if plant is _out_of_place:
        assert any("left its storage" in f.detail for f in rep.findings)


def test_audit_catches_a_device_to_host_copy_and_a_host_op():
    """A throwaway placement's entries on the CPU: `nonzero` and
    `repeat_interleave` without output_size need the host; the same work
    on the device path stays clean."""
    from repro_torch.analysis.hot_loop_audit import audit_placement
    from repro_torch.serving import DevicePlacement
    pl = DevicePlacement.of("cpu")
    x = torch.tensor([0.0, 1.0, 2.0])
    host = pl.hot_loop(lambda key, t: torch.nonzero(t).sum()
                       + t.repeat_interleave(torch.tensor([1, 2, 1])).sum(),
                       name="host")
    dev = pl.hot_loop(lambda key, t: (t > 0).sum() + t.repeat_interleave(
        torch.tensor([1, 2, 1]), output_size=4).sum(), name="device")
    with audit_placement(pl) as a:
        host(0, (x,))
        dev(0, (x,))
        host(0, (x,))          # a key's later calls are not observed
    rep = a.report()
    assert {(f.entry, f.check) for f in rep.findings} == {("host", "purity")}
    assert len(rep.findings) == 2, rep.format()
    assert rep.entries["host"]["ops"] and len(rep.entries["host"]["ops"]) == 1


# ---------------------------------------------------------------------------
# parity with the reference where it imports no JAX
# ---------------------------------------------------------------------------

WAIVER_LINES = [
    "x = 1",
    "v = s.item()  # contract: waive no-host-sync-in-impl -- warmup only",
    "# contract: waive seeded-rng-only -- replayed from the seed",
    "y = 2  #contract:waive repo-hygiene",
    "z = 3  # contract: waive no-shape-leak --   spaced why  ",
    "w = 4  # contract: waive Bad_Rule -- not a rule id",
]


def test_diagnostics_match_the_reference():
    from repro.analysis import diagnostics as ref
    from repro_torch.analysis import diagnostics as port
    got = port.scan_waivers("src/x.py", WAIVER_LINES)
    want = ref.scan_waivers("src/x.py", WAIVER_LINES)
    assert [vars(w) for w in got] == [vars(w) for w in want] and len(got) == 4
    diags = [("no-host-sync-in-impl", "src/x.py", 2, "item"),
             ("seeded-rng-only", "src/x.py", 4, "rng"),
             ("no-shape-leak", "src/a.py", 9, "shape"),
             ("repo-hygiene", ".gitignore", 1, "missing")]
    for strict in (False, True):
        reps = []
        for mod in (port, ref):
            r = mod.Report([mod.Diagnostic(*d) for d in diags],
                           mod.scan_waivers("src/x.py", WAIVER_LINES))
            r.apply_waivers()
            reps.append((r.format(strict), r.ok(strict),
                         [vars(d) for d in r.errors(strict)]))
        assert reps[0] == reps[1]


@pytest.mark.parametrize("tracked,ignore", [
    ([], "__pycache__/\n*.pyc\n"),
    (["src/repro/__pycache__/x.pyc", "a/.DS_Store", "b.egg-info/PKG-INFO",
      "nb/.ipynb_checkpoints/x", "src/repro_torch/x.py"], ""),
    (["tests/.pytest_cache/v", "src/repro_torch/kernels/_build/k.so"],
     "*.pyc\n"),
    (["src/repro_torch/kernels/csrc/paged_decode.cu"],
     "__pycache__/\n  *.pyc  \n"),
], ids=["clean", "artifacts", "partial", "spaced"])
def test_hygiene_matches_the_reference(tracked, ignore):
    """The port's rule gives the reference's diagnostics on the same
    tracked list and .gitignore, its own `_build/` and kernel-object
    requirements left out."""
    from repro.analysis.lint import run_lint as ref_lint
    from repro.analysis.rules.hygiene import repo_hygiene as ref_rule
    from repro_torch.analysis.rules.hygiene import (BUILD_DIR,
                                                    KERNEL_OBJECT_RE)
    from repro_torch.analysis.rules.hygiene import repo_hygiene as port_rule

    def diags(lint, rule):
        rep = lint(files={}, rules={"repo-hygiene": rule},
                   tracked_files=tracked, gitignore_text=ignore)
        return [(d.rule, d.path, d.line, d.msg) for d in rep.diagnostics]
    port = [d for d in diags(run_lint, port_rule)
            if BUILD_DIR not in d[3] and not (
                d[1].startswith("src/repro_torch/")
                and KERNEL_OBJECT_RE.search(d[1]))]
    assert port == diags(ref_lint, ref_rule)
