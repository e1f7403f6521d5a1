"""Diagnostics + inline-waiver syntax for the port's contract linter.

The port's own copy of the reference's `repro.analysis.diagnostics`
(src/repro/analysis/diagnostics.py): the same classes, the same waiver
grammar and the same report text, so a reader of one reads the other.

A rule emits `Diagnostic`s with a (path, line) anchor. A diagnostic can be
waived **narrowly** — one rule, one line — with an inline comment on the
flagged line or the line directly above it:

    x = int(flags)  # contract: waive <rule-id> -- flags is a host int
                    # carried in the hot-loop key

(with `<rule-id>` e.g. `no-host-sync-in-impl`). The justification after
`--` is mandatory: a waiver without one is itself reported
(`waiver-missing-justification`), and a waiver comment that never matches
a diagnostic is reported as stale (`stale-waiver`) so waivers cannot
outlive the violation they excuse. `--strict` fails on both. Waived
diagnostics are echoed in the report together with their justification —
a waiver hides nothing, it just downgrades the exit code.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

WAIVER_RE = re.compile(
    r"#\s*contract:\s*waive\s+(?P<rule>[a-z0-9-]+)"
    r"(?:\s*--\s*(?P<why>.*\S))?\s*$")

# internal rule ids used for waiver bookkeeping problems
WAIVER_STALE = "stale-waiver"
WAIVER_NO_WHY = "waiver-missing-justification"


@dataclass
class Diagnostic:
    rule: str
    path: str          # repo-relative, posix separators
    line: int          # 1-indexed
    msg: str
    waived: bool = False
    justification: str = ""

    def format(self) -> str:
        tag = "WAIVED" if self.waived else "ERROR"
        s = f"{self.path}:{self.line}: [{self.rule}] {tag}: {self.msg}"
        if self.waived:
            s += f"\n    waiver: {self.justification or '(no justification)'}"
        return s


@dataclass
class Waiver:
    rule: str
    path: str
    line: int                   # line the waiver comment sits on
    justification: str
    used: bool = False

    def covers(self, d: Diagnostic) -> bool:
        # a waiver covers its own line and the line below it (comment-above
        # style); it never reaches further
        return (d.rule == self.rule and d.path == self.path
                and d.line in (self.line, self.line + 1))


def scan_waivers(path: str, lines: list[str]) -> list[Waiver]:
    out = []
    for i, text in enumerate(lines, start=1):
        m = WAIVER_RE.search(text)
        if m:
            out.append(Waiver(m.group("rule"), path, i,
                              (m.group("why") or "").strip()))
    return out


@dataclass
class Report:
    diagnostics: list[Diagnostic] = field(default_factory=list)
    waivers: list[Waiver] = field(default_factory=list)

    def apply_waivers(self) -> None:
        for d in self.diagnostics:
            for w in self.waivers:
                if w.covers(d):
                    d.waived, d.justification = True, w.justification
                    w.used = True
                    break

    def waiver_problems(self) -> list[Diagnostic]:
        """Strict-mode extras: stale waivers and missing justifications."""
        probs = []
        for w in self.waivers:
            if not w.used:
                probs.append(Diagnostic(
                    WAIVER_STALE, w.path, w.line,
                    f"waiver for '{w.rule}' matches no diagnostic — "
                    f"remove it (the violation it excused is gone)"))
            elif not w.justification:
                probs.append(Diagnostic(
                    WAIVER_NO_WHY, w.path, w.line,
                    f"waiver for '{w.rule}' has no justification — "
                    f"append `-- <why this is sound>`"))
        return probs

    def errors(self, strict: bool = False) -> list[Diagnostic]:
        errs = [d for d in self.diagnostics if not d.waived]
        if strict:
            errs += self.waiver_problems()
        return errs

    def waived(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.waived]

    def format(self, strict: bool = False) -> str:
        chunks = []
        errs = self.errors(strict)
        for d in sorted(errs, key=lambda d: (d.path, d.line, d.rule)):
            chunks.append(d.format())
        for d in sorted(self.waived(), key=lambda d: (d.path, d.line)):
            chunks.append(d.format())
        n_w = len(self.waived())
        chunks.append(f"contract lint: {len(errs)} error(s), "
                      f"{n_w} waived diagnostic(s)")
        return "\n".join(chunks)

    def ok(self, strict: bool = False) -> bool:
        return not self.errors(strict)
