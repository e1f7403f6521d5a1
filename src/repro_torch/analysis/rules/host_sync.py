"""no-host-sync-in-impl: hot-loop bodies never pull values to the host.

The serving stack's `host_fetches == steps` contract means every decode
step costs exactly one device->host fetch, made by the *engine glue* after
the hot-loop entry returns (serving/decode.py, serving/prefill.py). A host
sync **inside** an entry's body — `.item()`, `.tolist()`, `.cpu()`,
`.numpy()`, `.to("cpu")`, `.synchronize()`, `np.asarray` / `np.array` or
`int()` / `float()` / `bool()` on a tensor — fails CUDA-graph capture on
the card, and where capture is off (every gloo placement and every CPU
run) nothing else stops it from serializing the step.

"Hot-loop bodies" are functions named `_*_impl` (the serving impl
convention) and functions handed to a `<x>.hot_loop(...)` construction
call in the same module. Host values stay allowed: constants, `.shape`,
`.ndim`, `.dtype`, `len()`, `.size()` / `.dim()` / `.numel()`, the entry's
`key` parameter (the first one after `self`: every Python value a step
reads rides in its key, the counterpart of static_argnums), names
assigned only from these, and arithmetic on any of them.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.lint import (LintContext, hot_loop_targets,
                                       imported_names, qualified_name)
from repro_torch.analysis.rules import register

RULE = "no-host-sync-in-impl"
IMPL_RE = re.compile(r"^_\w*_impl$")
SHAPE_ATTRS = {"shape", "ndim", "dtype"}
SHAPE_METHODS = {"size", "dim", "numel"}
HOST_FNS = {"len", "min", "max", "abs", "int", "float", "bool"}
FETCH_METHODS = {"item", "tolist", "cpu", "numpy"}


def _key_param(fn: ast.FunctionDef):
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if params[:1] == ["self"]:
        params = params[1:]
    return params[0] if params else None


def _host_safe(node: ast.AST, safe: set) -> bool:
    """True if the expression is a host value: constants, shapes / dtypes
    / len of anything, the key and names derived from it, and arithmetic
    thereof."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in safe
    if isinstance(node, ast.Attribute):
        return node.attr in SHAPE_ATTRS
    if isinstance(node, ast.Subscript):
        return _host_safe(node.value, safe) and _host_safe(node.slice, safe)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in SHAPE_METHODS:
            return all(_host_safe(a, safe) for a in node.args)
        return isinstance(f, ast.Name) and f.id in HOST_FNS \
            and all(_host_safe(a, safe) for a in node.args)
    if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
                         ast.Tuple, ast.List, ast.IfExp, ast.Slice)):
        return all(_host_safe(c, safe)
                   for c in ast.iter_child_nodes(node)
                   if not isinstance(c, (ast.operator, ast.unaryop,
                                         ast.boolop, ast.cmpop,
                                         ast.expr_context)))
    return False


def _safe_names(fn: ast.FunctionDef) -> set:
    """The key parameter and every local assigned only host values (in
    line order: `npad, all_greedy = key`)."""
    key = _key_param(fn)
    safe = {key} if key else set()
    assigns = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)),
                     key=lambda n: (n.lineno, n.col_offset))
    for a in assigns:
        names = [n.id for t in a.targets for n in ast.walk(t)
                 if isinstance(n, ast.Name)]
        if _host_safe(a.value, safe):
            safe.update(names)
        else:
            safe.difference_update(names)
    return safe


def _to_cpu(call: ast.Call, names: dict) -> bool:
    """`.to("cpu")`, `.to(device="cpu")`, `.to(torch.device("cpu"))`."""
    def is_cpu(v):
        if isinstance(v, ast.Constant):
            return isinstance(v.value, str) and v.value.split(":")[0] == "cpu"
        return isinstance(v, ast.Call) \
            and qualified_name(v.func, names) == "torch.device" \
            and bool(v.args) and is_cpu(v.args[0])
    vals = call.args[:1] + [k.value for k in call.keywords
                            if k.arg == "device"]
    return any(is_cpu(v) for v in vals)


def _message(node: ast.Call, safe: set, names: dict):
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in FETCH_METHODS:
            return f".{f.attr}() forces a device->host transfer inside a " \
                   "hot-loop body"
        if f.attr == "synchronize":
            return ".synchronize() inside a hot-loop body serializes the " \
                   "step (and fails its capture)"
        if f.attr == "to" and _to_cpu(node, names):
            return ".to('cpu') inside a hot-loop body is a device->host " \
                   "transfer"
        q = qualified_name(f, names)
        if q in ("numpy.asarray", "numpy.array") \
                and not all(_host_safe(a, safe) for a in node.args):
            return f"np.{f.attr} on a tensor copies it to the host"
    elif isinstance(f, ast.Name) and f.id in ("int", "float", "bool") \
            and node.args and not all(_host_safe(a, safe)
                                      for a in node.args):
        return f"{f.id}() on a tensor is a host sync; keep the value on " \
               "the device (or carry it in the hot-loop key if it is a " \
               "Python value)"
    return None


@register(RULE)
def no_host_sync_in_impl(ctx: LintContext) -> list[Diagnostic]:
    diags = []
    for path in sorted(ctx.files):
        sf = ctx.files[path]
        entries = hot_loop_targets(sf.tree)
        names = imported_names(sf.tree)
        seen = set()
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in entries and not IMPL_RE.match(fn.name):
                continue
            safe = _safe_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                msg = _message(node, safe, names)
                if msg and (node.lineno, msg) not in seen:
                    seen.add((node.lineno, msg))
                    diags.append(Diagnostic(
                        RULE, sf.path, node.lineno,
                        f"in hot-loop body `{fn.name}`: {msg}"))
    return diags
