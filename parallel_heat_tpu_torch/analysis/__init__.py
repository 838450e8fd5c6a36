"""Static verification of the port's contracts (``heatlint``).

The counterpart of ``parallel_heat_tpu/analysis/``, for the PyTorch/CUDA
port. Two layers:

- :mod:`astlint` — **AST-level** lint (rules ``HL2xx``) over the port's
  Python and, as text, its CUDA sources: blocking host syncs in dispatch
  regions, wall-clock/RNG in traced or captured code, kernel names and
  the build registry's entry points, lock discipline, import hygiene.
- :mod:`kernels` — **Hopper kernel-safety** audits (rules ``HL4xx``):
  every kernel's launch plan (:mod:`plans`) is checked for in-bounds
  windows and TMA boxes, its shared-memory budget and residency, its
  cp.async / mbarrier schedule, and the coverage of its output tiles.

The reference's trace-level (``HL1xx``) and SPMD (``HL3xx``) layers
audit jaxprs; they have no counterpart here yet (ROADMAP queue 1 item
14). ``python -m parallel_heat_tpu_torch.tools.heatlint`` is the CLI;
intentionally kept findings live in ``analysis/heatlint.baseline.json``
with a one-line justification each (:mod:`findings`).
"""

from parallel_heat_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    apply_baseline,
    load_baseline,
    render_findings,
)
from parallel_heat_tpu_torch.analysis.astlint import (  # noqa: F401
    AST_RULES,
    lint_paths,
)
from parallel_heat_tpu_torch.analysis.kernels import (  # noqa: F401
    KERNEL_RULES,
    run_kernels,
)

ALL_RULES = {**AST_RULES, **KERNEL_RULES}

# Layer name -> (rule table, runner). The CLI's --layer flag and the
# per-layer timing summary both read this; a new analyzer layer lands
# by adding one row.
LAYERS = {
    "ast": (AST_RULES, lambda rules=None: lint_paths(None, rules=rules)),
    "kernels": (KERNEL_RULES, lambda rules=None: run_kernels(rules)),
}


def layer_of(rule_id: str) -> str:
    """The layer name a rule id belongs to (``HL2xx`` -> ast, ...)."""
    for name, (table, _run) in LAYERS.items():
        if rule_id in table:
            return name
    return "?"


def run_all(paths=None, baseline=None):
    """Run every layer; returns ``(findings, stale_baseline_entries)``.

    ``paths`` scopes the AST layer (defaults inside
    :func:`astlint.lint_paths`); the kernel layer always audits the
    package's plans. ``baseline`` (a parsed baseline, see
    :func:`findings.load_baseline`) suppresses matched findings."""
    out = list(lint_paths(paths))
    out.extend(run_kernels())
    return apply_baseline(out, baseline)
