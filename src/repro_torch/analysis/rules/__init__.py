"""Pluggable rule registry for the port's contract linter.

A rule is a function `rule(ctx: LintContext) -> list[Diagnostic]`
registered under its kebab-case id. Importing this package populates
`RULES`; `repro_torch.analysis.lint.run_rules` consumes it. Adding a rule
= adding a module here with a `@register("my-rule")` function whose module
docstring's first line is its catalog entry (`--list-rules`).
"""
from __future__ import annotations

from typing import Callable

RULES: dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        RULES[name] = fn
        fn.rule_name = name
        return fn
    return deco


# importing the rule modules registers them (must come after register())
from repro_torch.analysis.rules import host_sync      # noqa: E402,F401
from repro_torch.analysis.rules import hygiene        # noqa: E402,F401
from repro_torch.analysis.rules import jit_choke      # noqa: E402,F401
from repro_torch.analysis.rules import proxy_imports  # noqa: E402,F401
from repro_torch.analysis.rules import rng            # noqa: E402,F401
from repro_torch.analysis.rules import shape_leak     # noqa: E402,F401
