"""Static analysis over emitted plans: the PA-rule plan analyzer, the
mutation harness that proves each rule has teeth, and the AST-based
concurrency lint for the serving layer."""

from repro_torch.analysis.diagnostics import (RULES, TIME_EPS, Diagnostic,
                                        Severity, errors_only)
from repro_torch.analysis.plan_analyzer import (analyze, analyze_errors,
                                          analyze_memory, analyze_multi_plan,
                                          analyze_plan, summarize)

__all__ = [
    "RULES", "TIME_EPS", "Diagnostic", "Severity", "errors_only",
    "analyze", "analyze_errors", "analyze_memory", "analyze_multi_plan",
    "analyze_plan", "summarize",
]
