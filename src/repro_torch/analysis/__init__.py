"""ContractGuard for the port — the checker of the serving stack's
contracts, the counterpart of the reference's `repro.analysis`.

Two layers:

  · `repro_torch.analysis.lint` — AST contract linter over
    src/repro_torch with pluggable rules (`repro_torch.analysis.rules`)
    and inline waivers (`# contract: waive <rule> -- <why>`); run as
    `python -m repro_torch.analysis [--strict]`.
  · `repro_torch.analysis.hot_loop_audit` — a live auditor over the
    `HotLoopRegistry` that `DevicePlacement.hot_loop` populates: it
    watches each entry key's first (eager) call through a torch dispatch
    mode and checks what the step ran (no op that needs the host, no
    float64, no whole-arena dequant or copy, arenas kept in place, the
    rank-local layout). It imports torch; import it by name.

This package imports no torch, so the lint stays cheap.
"""
from repro_torch.analysis.diagnostics import Diagnostic, Report
from repro_torch.analysis.lint import run_lint

__all__ = ["Diagnostic", "Report", "run_lint", "contract_gate"]


def contract_gate() -> Report:
    """Assert-gated preamble for benchmarks and chip_smoke.py: refuse to
    run on a tree that fails the contract lint (strict: stale or
    unjustified waivers fail too). → the report, for its counts."""
    report = run_lint()
    assert report.ok(strict=True), \
        "contract lint failed — fix or waive before measuring:\n" \
        + report.format(strict=True)
    return report
