"""hot-loop-choke-point: serving steps are captured in exactly one place.

Every per-round serving step must be built through
`DevicePlacement.hot_loop` (serving/placement.py) — that choke point keys
one CUDA graph per Python value the step reads, holds the step's static
inputs to their storage, captures every graph of a server into one shared
memory pool, carries the kernels' launch counts across replays, and
registers the entry in the HotLoopRegistry the live audit
(`repro_torch.analysis.hot_loop_audit`) walks. A capture or compile built
anywhere else in serving/ bypasses all of it, so outside placement.py this
rule flags `torch.cuda.graph(...)`, `torch.cuda.CUDAGraph(...)`,
`torch.cuda.make_graphed_callables(...)`, `torch.compile` (a call or a
decorator) and `torch.jit.script` / `torch.jit.trace`, under any import
spelling (`from torch.cuda import graph`, `import torch.cuda as tc`, ...).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.lint import (LintContext, imported_names,
                                       qualified_name)
from repro_torch.analysis.rules import register

RULE = "hot-loop-choke-point"
CHOKE_POINT = "src/repro_torch/serving/placement.py"
BANNED = {"torch.cuda.graph", "torch.cuda.graphs.graph",
          "torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
          "torch.cuda.make_graphed_callables",
          "torch.cuda.graphs.make_graphed_callables",
          "torch.compile", "torch.jit.script", "torch.jit.trace"}


def _capture_uses(sf) -> list[tuple[int, str]]:
    """(line, name) of every banned call, decorator (bare, called, or
    through functools.partial) and reference passed as an argument."""
    names = imported_names(sf.tree)

    def banned(node: ast.AST):
        q = qualified_name(node, names)
        return q if q in BANNED else None

    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            q = banned(node.func)
            if q:
                out.append((node.lineno, q))
            # functools.partial(torch.compile, ...), map(torch.jit.script..)
            out += [(node.lineno, q) for q in map(banned, node.args) if q]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                q = banned(dec)      # @torch.compile without arguments
                if q:
                    out.append((dec.lineno, q))
    return sorted(set(out))


@register(RULE)
def hot_loop_choke_point(ctx: LintContext) -> list[Diagnostic]:
    diags = []
    for sf in ctx.in_dir("serving"):
        if sf.path == CHOKE_POINT:
            continue
        for line, name in _capture_uses(sf):
            diags.append(Diagnostic(
                RULE, sf.path, line,
                f"`{name}` in serving/ — build the step through "
                "DevicePlacement.hot_loop so its graphs are keyed, share the "
                "placement's pool, carry the launch counts and land in the "
                "HotLoopRegistry"))
    return diags
