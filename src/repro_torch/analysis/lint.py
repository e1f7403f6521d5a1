"""ContractGuard layer 1 for the port — the AST contract linter.

Walks every Python file under `src/repro_torch/`, parses it once, and runs
the pluggable rule set from `repro_torch.analysis.rules` over the shared
`LintContext`. Rules are pure functions `rule(ctx) -> [Diagnostic]`; the
engine owns file discovery, waiver application (see diagnostics.py) and
report assembly. `run_lint(files=...)` accepts an in-memory
{relpath: source} mapping so the test suite can lint fixture snippets
through the exact same pipeline the CLI runs.

The rules encode the contracts the port's speed rests on (the catalog is
`python -m repro_torch.analysis --list-rules`): every per-round serving
step is built through `DevicePlacement.hot_loop` and captured there, a
hot-loop body never pulls a value to the host, randomness flows from
explicit seeds, hot-loop keys never carry raw data-dependent shapes, the
OmniProxy stays torch-free, and no build artifact is ever tracked. The
engine is the reference's (src/repro/analysis/lint.py); this module
imports no torch, so the lint stays cheap.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from repro_torch.analysis.diagnostics import Report, scan_waivers

# repo root = parents[3] of this file (src/repro_torch/analysis/lint.py)
REPO_ROOT = Path(__file__).resolve().parents[3]
SRC_PREFIX = "src/repro_torch"


@dataclass
class SourceFile:
    path: str                 # repo-relative posix path
    source: str
    tree: ast.AST
    lines: list[str]

    @property
    def module(self) -> str:
        """src/repro_torch/serving/decode.py -> repro_torch.serving.decode"""
        p = self.path
        if p.startswith("src/"):
            p = p[len("src/"):]
        if p.endswith("/__init__.py"):
            p = p[: -len("/__init__.py")]
        elif p.endswith(".py"):
            p = p[:-3]
        return p.replace("/", ".")


@dataclass
class LintContext:
    root: Path
    files: dict[str, SourceFile]
    # overridable for tests; None -> rules that need them ask git / disk
    tracked_files: Optional[list[str]] = None
    gitignore_text: Optional[str] = None
    _by_module: dict = field(default_factory=dict)

    def __post_init__(self):
        self._by_module = {sf.module: sf for sf in self.files.values()}

    def module_file(self, modname: str) -> Optional[SourceFile]:
        """Resolve `repro_torch.x.y` to its SourceFile (package __init__
        counts)."""
        return self._by_module.get(modname)

    def in_dir(self, prefix: str):
        """All files under a src/repro_torch-relative dir, e.g. 'serving'."""
        full = f"{SRC_PREFIX}/{prefix.rstrip('/')}/"
        return [sf for p, sf in sorted(self.files.items())
                if p.startswith(full)]


def _parse(path: str, source: str) -> Optional[SourceFile]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    return SourceFile(path, source, tree, source.splitlines())


def build_context(root: Optional[Path] = None,
                  files: Optional[dict[str, str]] = None,
                  **kw) -> LintContext:
    root = Path(root) if root is not None else REPO_ROOT
    srcs: dict[str, SourceFile] = {}
    if files is not None:
        for relpath, source in files.items():
            sf = _parse(relpath, source)
            if sf is not None:
                srcs[relpath] = sf
    else:
        for f in sorted((root / SRC_PREFIX).rglob("*.py")):
            rel = f.relative_to(root).as_posix()
            sf = _parse(rel, f.read_text())
            if sf is not None:
                srcs[rel] = sf
    return LintContext(root, srcs, **kw)


def run_rules(ctx: LintContext,
              rules: Optional[dict[str, Callable]] = None) -> Report:
    from repro_torch.analysis.rules import RULES
    rules = RULES if rules is None else rules
    report = Report()
    for name in sorted(rules):
        for d in rules[name](ctx):
            report.diagnostics.append(d)
    for sf in ctx.files.values():
        report.waivers.extend(scan_waivers(sf.path, sf.lines))
    report.apply_waivers()
    return report


def run_lint(root: Optional[Path] = None,
             files: Optional[dict[str, str]] = None,
             rules: Optional[dict[str, Callable]] = None,
             **kw) -> Report:
    """One-call entry: build the context, run every rule, apply waivers."""
    return run_rules(build_context(root, files, **kw), rules)


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------

def imported_names(tree: ast.AST) -> dict[str, str]:
    """{local name: the dotted name it stands for} of every import in the
    module, function-local ones included: `import torch` → torch: torch,
    `import torch.cuda as tc` → tc: torch.cuda, `from torch.cuda import
    graph as g` → g: torch.cuda.graph, `import numpy.random` → numpy:
    numpy. Relative imports are left out (they name repo modules)."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def qualified_name(func: ast.AST, names: dict[str, str]) -> Optional[str]:
    """The dotted name an expression stands for, its root resolved through
    `imported_names`: `tc.graph` with `import torch.cuda as tc` →
    'torch.cuda.graph'. None if the chain bottoms out in anything but a
    Name; an unimported root stays as written."""
    name = dotted_name(func)
    if name is None:
        return None
    root, _, rest = name.partition(".")
    root = names.get(root, root)
    return f"{root}.{rest}" if rest else root


def dotted_name(func: ast.AST) -> Optional[str]:
    """`np.random.default_rng` -> 'np.random.default_rng' (None if the
    chain bottoms out in anything but a Name)."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if not isinstance(func, ast.Name):
        return None
    parts.append(func.id)
    return ".".join(reversed(parts))


def hot_loop_targets(tree: ast.AST) -> set[str]:
    """The names of every function handed to a `<x>.hot_loop(fn, ...)`
    construction call (`self._step_impl` → '_step_impl'; a bare name, or
    `fn=`, too)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "hot_loop"):
            continue
        tgt = node.args[0] if node.args else next(
            (k.value for k in node.keywords if k.arg == "fn"), None)
        if isinstance(tgt, ast.Attribute):
            out.add(tgt.attr)
        elif isinstance(tgt, ast.Name):
            out.add(tgt.id)
    return out
