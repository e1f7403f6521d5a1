"""repo-hygiene: no build artifacts in the index, .gitignore stays armed.

Fails the lint the moment a bytecode/cache artifact gets committed: any
tracked path containing `__pycache__`, `*.pyc`, `.pytest_cache`,
`*.egg-info`, `.ipynb_checkpoints` or `.DS_Store` is flagged, and
`.gitignore` must carry the `__pycache__/` and `*.pyc` patterns so the
artifacts never show up as untracked noise in the first place (the
reference's rule, src/repro/analysis/rules/hygiene.py). The port adds its
kernels: nvcc builds them on first use into `src/repro_torch/kernels/
_build/`, which `.gitignore` must list, and no compiled object (`.so`,
`.o`, `.cubin`, `.ptx`) under `src/repro_torch/` may be tracked.
Working-tree-only cache dirs are fine — only the git index counts.

The tracked-file list and .gitignore text are injectable on the
LintContext for tests; by default they come from `git ls-files` at the
repo root (silently skipped when git/the index is unavailable, e.g. a
source tarball).
"""
from __future__ import annotations

import re
import subprocess

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.lint import SRC_PREFIX, LintContext
from repro_torch.analysis.rules import register

RULE = "repo-hygiene"
ARTIFACT_RE = re.compile(
    r"(^|/)__pycache__(/|$)|\.pyc$|(^|/)\.pytest_cache(/|$)"
    r"|\.egg-info(/|$)|(^|/)\.ipynb_checkpoints(/|$)|(^|/)\.DS_Store$")
REQUIRED_IGNORES = ("__pycache__/", "*.pyc")
BUILD_DIR = f"{SRC_PREFIX}/kernels/_build/"
KERNEL_OBJECT_RE = re.compile(r"\.(so|o|cubin|ptx)$")


def _tracked_files(ctx: LintContext):
    if ctx.tracked_files is not None:
        return ctx.tracked_files
    try:
        out = subprocess.run(
            ["git", "-C", str(ctx.root), "ls-files"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.splitlines()


def _gitignore(ctx: LintContext):
    if ctx.gitignore_text is not None:
        return ctx.gitignore_text
    p = ctx.root / ".gitignore"
    return p.read_text() if p.exists() else ""


@register(RULE)
def repo_hygiene(ctx: LintContext) -> list[Diagnostic]:
    diags = []
    tracked = _tracked_files(ctx)
    if tracked is None:
        return diags  # no git index to audit (tarball checkout)
    for path in tracked:
        if ARTIFACT_RE.search(path):
            diags.append(Diagnostic(
                RULE, path, 1,
                "build artifact tracked in git — `git rm --cached` it; "
                ".gitignore should be keeping it out"))
        elif path.startswith(SRC_PREFIX + "/") \
                and KERNEL_OBJECT_RE.search(path):
            diags.append(Diagnostic(
                RULE, path, 1,
                "compiled kernel object tracked in git — the kernels are "
                "built from kernels/csrc/ on first use; `git rm --cached` "
                "it"))
    ignore_lines = {ln.strip() for ln in _gitignore(ctx).splitlines()}
    for pat in REQUIRED_IGNORES:
        if pat not in ignore_lines:
            diags.append(Diagnostic(
                RULE, ".gitignore", 1,
                f"missing `{pat}` pattern — bytecode artifacts would "
                "show up as untracked noise and eventually get committed"))
    if BUILD_DIR not in ignore_lines:
        diags.append(Diagnostic(
            RULE, ".gitignore", 1,
            f"missing `{BUILD_DIR}` — the kernels' nvcc build directory "
            "would show up as untracked noise and eventually get "
            "committed"))
    return diags
