"""no-shape-leak: hot-loop keys never carry raw data-dependent shapes.

A hot-loop entry (`DevicePlacement.hot_loop`, serving/placement.py)
captures one CUDA graph per distinct key, each into the placement's shared
memory pool, so the serving engines bound the key set by pow2-bucketing
every shape-like value before it reaches a key (`_bucket` /
`_pow2_floor` in serving/arena.py and friends). Feeding a key a raw
`.shape`-derived value — `self._step((toks.shape[1], g), ...)` — captures
one more graph per distinct length and grows the pool without bound.

The rule pairs the two halves up per module, as the reference's does for
static_argnums (src/repro/analysis/rules/shape_leak.py): pass 1 records
every `<placement>.hot_loop(...)` construction assigned to a name; pass 2
checks the `key` argument (the first, or `key=`) of each call through that
name and flags it if it mentions `.shape` / `.ndim` / `.size` outside a
bucketing call (`_bucket(x.shape[0])`, `_pow2_floor(...)`,
`next_pow2(...)` are the sanctioned spellings).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.lint import LintContext
from repro_torch.analysis.rules import register

RULE = "no-shape-leak"
SHAPE_ATTRS = {"shape", "ndim", "size"}
BUCKET_FNS = {"_bucket", "bucket", "_pow2_floor", "pow2_floor", "next_pow2",
              "_next_pow2"}


def _hot_loop_bindings(tree) -> set:
    """Names bound to `self._f = pl.hot_loop(...)` style assignments (bare
    name targets too)."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "hot_loop"):
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Attribute):
            out.add(tgt.attr)
        elif isinstance(tgt, ast.Name):
            out.add(tgt.id)
    return out


def _raw_shape_use(node: ast.AST) -> bool:
    """Does this expression read .shape/.ndim/.size outside a bucketing
    call?"""
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else None
        if name in BUCKET_FNS:
            return False  # bucketed: pow2-bounded by construction
    if isinstance(node, ast.Attribute) and node.attr in SHAPE_ATTRS:
        return True
    return any(_raw_shape_use(c) for c in ast.iter_child_nodes(node))


@register(RULE)
def no_shape_leak(ctx: LintContext) -> list[Diagnostic]:
    diags = []
    for path in sorted(ctx.files):
        sf = ctx.files[path]
        bindings = _hot_loop_bindings(sf.tree)
        if not bindings:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name not in bindings:
                continue
            key = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "key"), None)
            if key is not None and _raw_shape_use(key):
                diags.append(Diagnostic(
                    RULE, sf.path, node.lineno,
                    f"the key of hot loop `{name}` is fed a raw "
                    ".shape-derived value — every distinct shape captures "
                    "another graph into the placement's pool; bucket it "
                    "first (_bucket / _pow2_floor) so the keys stay "
                    "O(log n)"))
    return diags
