"""seeded-rng-only: randomness in serving/ and core/ flows from a seed.

FaultPlane's chaos soaks, the bit-equal sampling draw (serving/prng.py's
threefry, keyed by each request's seed) and the rank lockstep all depend
on bit-reproducible schedules: a fault schedule, sampler or dispatch
tiebreak that draws from wall-clock time, an unseeded generator or the
process-global torch generator cannot be replayed, so the soak loses its
oracle and the ranks drift apart. In `serving/` and `core/` this rule
flags

  · `time.time()` — wall-clock entropy (time.monotonic / perf_counter for
    *measuring* durations stay fine),
  · the stdlib `random` module's global functions — `random.Random(seed)`
    instances are fine,
  · legacy `np.random.*` globals and `np.random.default_rng()` called
    without a seed,
  · the global torch generator: `torch.manual_seed`, `torch.seed`,
    `torch.cuda.manual_seed*`; `torch.rand`, `randn`, `randint`,
    `randperm`, `multinomial`, `bernoulli`, `normal` and `rand*_like`
    called without `generator=`; in-place `.uniform_`, `.normal_`,
    `.exponential_`, `.bernoulli_` (and their siblings) without
    `generator=`.

The first three are the reference's (src/repro/analysis/rules/rng.py).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.lint import (LintContext, imported_names,
                                       qualified_name)
from repro_torch.analysis.rules import register

RULE = "seeded-rng-only"
SCOPES = ("serving", "core")
TORCH_RESEED = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                "torch.random.seed", "torch.cuda.seed", "torch.cuda.seed_all"}
TORCH_DRAWS = {f"torch.{f}" for f in (
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli",
    "normal", "poisson", "rand_like", "randn_like", "randint_like")}
INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "bernoulli_",
                 "random_", "geometric_", "cauchy_", "log_normal_"}


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _check_call(node: ast.Call, names: dict):
    name = qualified_name(node.func, names)
    if name is None:
        return None
    parts = name.split(".")
    if name == "time.time":
        return ("time.time() is wall-clock entropy — schedules must be "
                "seed-derived (time.monotonic for duration measurement "
                "is fine)")
    if parts[0] == "random" and len(parts) == 2 and parts[1] != "Random":
        return (f"global `{name}()` draws from unseeded process state; "
                "use np.random.default_rng(seed) or random.Random(seed)")
    if len(parts) == 3 and parts[:2] == ["numpy", "random"]:
        fn = parts[2]
        if fn == "default_rng":
            if not node.args and not node.keywords:
                return ("np.random.default_rng() without a seed is "
                        "OS-entropy seeded — pass the component's explicit "
                        "seed")
        elif fn != "Generator":
            return (f"legacy np.random.{fn} uses the unseeded global state;"
                    " use np.random.default_rng(seed)")
        return None
    if name in TORCH_RESEED or name.startswith("torch.cuda.manual_seed"):
        return (f"`{name}()` sets the process-global torch generator, which "
                "every caller shares; hand a seeded torch.Generator to the "
                "draw instead")
    if name in TORCH_DRAWS and not _has_generator(node):
        return (f"`{name}()` without generator= draws from the "
                "process-global torch generator; pass a seeded "
                "torch.Generator")
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in INPLACE_DRAWS and not _has_generator(node):
        return (f"`.{node.func.attr}()` without generator= draws from the "
                "process-global torch generator; pass a seeded "
                "torch.Generator")
    return None


def _check_file(sf) -> list[Diagnostic]:
    names = imported_names(sf.tree)
    diags = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            msg = _check_call(node, names)
            if msg:
                diags.append(Diagnostic(RULE, sf.path, node.lineno, msg))
    return diags


@register(RULE)
def seeded_rng_only(ctx: LintContext) -> list[Diagnostic]:
    diags = []
    for scope in SCOPES:
        for sf in ctx.in_dir(scope):
            diags.extend(_check_file(sf))
    return diags
