"""proxy-torch-free: the OmniProxy never sees torch.

The PD-disaggregation contract keeps `core/proxy/` a pure-Python/numpy
control plane: dispatch math, radix trees, request lifecycle and metrics
must be runnable on a frontend host with no accelerator runtime. This rule
flags

  · any direct `import torch` / `import torch.x` (or `from torch...`) in a
    module under core/proxy/, and
  · any intra-repo import whose transitive closure reaches a module that
    imports torch — so a "harmless" `from repro_torch.serving.x import
    helper` cannot smuggle the dependency in; the message names the chain.

Function-local (lazy) torch imports count too: the proxy has no business
importing torch even lazily. The reference's rule is `proxy-jax-free`
(src/repro/analysis/rules/proxy_imports.py).
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.lint import LintContext, SourceFile
from repro_torch.analysis.rules import register

RULE = "proxy-torch-free"
PKG = "repro_torch"
PROXY_PREFIX = "repro_torch.core.proxy"


def _torch_import_line(sf: SourceFile) -> Optional[int]:
    """First line importing torch (any spelling), or None."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    return node.lineno
        elif isinstance(node, ast.ImportFrom) and not node.level:
            m = node.module or ""
            if m == "torch" or m.startswith("torch."):
                return node.lineno
    return None


def _intra_repo_imports(sf: SourceFile) -> list[tuple[str, int]]:
    """(imported repro_torch.* module, lineno) pairs, relative imports
    resolved."""
    pkg = sf.module if sf.path.endswith("__init__.py") \
        else sf.module.rsplit(".", 1)[0]
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == PKG or a.name.startswith(PKG + "."):
                    out.append((a.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: resolve against the package
                base = pkg.split(".")
                if node.level > 1:
                    base = base[: -(node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod == PKG or mod.startswith(PKG + "."):
                out.append((mod, node.lineno))
                # `from repro_torch.x import y` may name submodules
                for a in node.names:
                    out.append((f"{mod}.{a.name}", node.lineno))
    return out


def _resolve(ctx: LintContext, modname: str) -> Optional[SourceFile]:
    sf = ctx.module_file(modname)
    if sf is None and "." in modname:  # attr import: try the parent module
        sf = ctx.module_file(modname.rsplit(".", 1)[0])
    return sf


@register(RULE)
def proxy_torch_free(ctx: LintContext) -> list[Diagnostic]:
    diags = []
    # memoized "does this module reach torch" over the intra-repo graph
    reaches: dict[str, Optional[list[str]]] = {}

    def chain_to_torch(modname: str, stack: tuple) -> Optional[list[str]]:
        if modname in reaches:
            return reaches[modname]
        if modname in stack:  # import cycle: break, no new info
            return None
        sf = _resolve(ctx, modname)
        if sf is None:
            reaches[modname] = None
            return None
        if _torch_import_line(sf) is not None:
            reaches[modname] = [sf.module]
            return reaches[modname]
        reaches[modname] = None  # provisional (cycle safety)
        for dep, _ in _intra_repo_imports(sf):
            sub = chain_to_torch(dep, stack + (modname,))
            if sub:
                reaches[modname] = [sf.module] + sub
                return reaches[modname]
        return None

    for sf in ctx.in_dir("core/proxy"):
        line = _torch_import_line(sf)
        if line is not None:
            diags.append(Diagnostic(
                RULE, sf.path, line,
                "OmniProxy modules must stay torch-free (the proxy is a "
                "pure-host control plane); move device work behind the "
                "serving engines"))
        seen = set()
        for dep, lineno in _intra_repo_imports(sf):
            if dep.startswith(PROXY_PREFIX):
                continue  # proxy-internal imports are vetted by this walk
            chain = chain_to_torch(dep, (sf.module,))
            if chain and (lineno, tuple(chain)) not in seen:
                seen.add((lineno, tuple(chain)))
                diags.append(Diagnostic(
                    RULE, sf.path, lineno,
                    f"transitive torch dependency: {sf.module} -> "
                    + " -> ".join(chain)
                    + " (imports torch); the proxy must not depend on "
                    "device-side modules"))
    return diags
