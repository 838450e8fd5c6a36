"""Finding/severity/baseline plumbing shared by the analyzer layers.

A finding is one rule violation at one source location. The baseline
file (``parallel_heat_tpu_torch/analysis/heatlint.baseline.json`` by
default) is the
justified-keeps ledger: findings the team has inspected and decided to
keep, each with a one-line justification. Baseline entries match on
``(rule, file, symbol)`` — the enclosing function/class, not the line
number, so unrelated edits above a kept finding don't invalidate the
entry — and every entry must carry a non-empty justification; entries
that no longer match anything are reported as stale so the ledger can
never silently outlive the code it excuses.

Format::

    {
      "version": 1,
      "entries": [
        {"rule": "HL205", "file": "parallel_heat_tpu_torch/utils/io.py",
         "symbol": "<module>", "justification": "re-export shim"}
      ]
    }

The format is the JAX package's own (version 1), so a baseline file
written for it loads here unchanged.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

BASELINE_VERSION = 1
BASELINE_DEFAULT = "parallel_heat_tpu_torch/analysis/heatlint.baseline.json"

# Severity order for --fail-on thresholds.
SEVERITIES = ("info", "warning", "error")


@dataclass
class Finding:
    """One rule violation: ``rule`` id (``HLxxx``), ``severity``
    (``error``/``warning``/``info``), ``file`` (repo-relative when
    possible), 1-based ``line`` (0 = whole-file/whole-audit),
    ``symbol`` (enclosing function/class, ``<module>`` at top level —
    the baseline match key), human ``message``."""

    rule: str
    severity: str
    file: str
    line: int
    symbol: str
    message: str
    # Set when a baseline entry suppressed this finding (carried in
    # to_dict() output; suppressed findings never gate).
    justification: Optional[str] = None
    # True for audit-soundness sentinels (exhaustion bounds, unprovable
    # schedules, vacuous target matrices): they report that an audit
    # could not run to completion, so a rule-subset run must surface
    # them even when their nominal rule id was filtered out — otherwise
    # "clean" can mean "silently skipped".
    soundness: bool = False

    def key(self):
        return (self.rule, _norm(self.file), self.symbol)

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "file": _norm(self.file), "line": self.line,
             "symbol": self.symbol, "message": self.message}
        if self.justification is not None:
            d["justification"] = self.justification
        if self.soundness:
            # Machine consumers must be able to tell "the audit could
            # not run" from an ordinary violation of the same rule id.
            d["soundness"] = True
        return d


@dataclass
class Baseline:
    """Parsed baseline file: entry key -> justification."""

    entries: dict = field(default_factory=dict)
    path: Optional[str] = None


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _norm(path: str) -> str:
    """Repo-relative forward-slash path (baseline keys must not depend
    on the machine — or the cwd — the analyzer ran from)."""
    p = os.path.normpath(str(path)).replace(os.sep, "/")
    for root in (_REPO_ROOT.replace(os.sep, "/") + "/",
                 os.getcwd().replace(os.sep, "/") + "/"):
        if p.startswith(root):
            return p[len(root):]
    return p


def load_baseline(path: Optional[str] = None) -> Baseline:
    """Load and validate a baseline file; a missing default file is an
    empty baseline, a malformed file or an entry without a justification
    raises (a silent bad ledger would un-gate CI)."""
    explicit = path is not None
    # The default ledger is the port's, wherever the analyzer runs from.
    path = path or os.path.join(_REPO_ROOT, BASELINE_DEFAULT)
    if not os.path.exists(path):
        if explicit:
            raise FileNotFoundError(f"baseline file {path!r} not found")
        return Baseline()
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path!r}: unsupported version {doc.get('version')!r}"
            f" (expected {BASELINE_VERSION})")
    out = {}
    for i, e in enumerate(doc.get("entries", [])):
        missing = [k for k in ("rule", "file", "symbol", "justification")
                   if not isinstance(e.get(k), str)]
        if missing:
            raise ValueError(
                f"baseline {path!r} entry {i}: missing/non-string "
                f"field(s) {missing}")
        if not e["justification"].strip():
            raise ValueError(
                f"baseline {path!r} entry {i} ({e['rule']} {e['file']} "
                f"{e['symbol']}): empty justification — every kept "
                f"finding must say why")
        out[(e["rule"], _norm(e["file"]), e["symbol"])] = e["justification"]
    return Baseline(entries=out, path=path)


def apply_baseline(findings, baseline: Optional[Baseline],
                   assessed_rules=None, assessed_paths=None,
                   path_rules=()):
    """Split findings into (active, suppressed-but-annotated) and
    report stale entries. Returns ``(active, stale)`` where ``active``
    excludes suppressed findings and ``stale`` is a list of baseline
    keys that matched nothing (each rendered as an ``HL000`` warning by
    the CLI so the ledger shrinks when code improves).

    ``assessed_rules`` (a set of rule ids, default: all) scopes
    stale-ness: an entry whose rule was NOT assessed this run — its
    layer skipped via ``--layer``/``--rules`` — is neither matched nor
    stale, just unassessed. Without this, any partial run
    (``make lint-fast``) would flag every entry of the layers it
    skipped, and ``--strict-baseline`` would turn that into a spurious
    gate.

    ``assessed_paths`` (normalized path roots, default: everything)
    scopes stale-ness for the rules in ``path_rules`` (the AST layer):
    an entry whose file lies outside every scanned root was never given
    a chance to match — its violation may still be alive in the
    unscanned file — so it is unassessed, not stale. Entries whose
    files WERE scanned still go stale normally."""
    if baseline is None:
        baseline = Baseline()
    matched = set()
    active = []
    for f in findings:
        just = baseline.entries.get(f.key())
        if just is not None:
            matched.add(f.key())
            f.justification = just
            continue
        active.append(f)

    def _path_assessed(rule, fpath):
        if assessed_paths is None or rule not in path_rules:
            return True
        return any(fpath == root or fpath.startswith(root + "/")
                   for root in assessed_paths)

    stale = [k for k in baseline.entries
             if k not in matched
             and (assessed_rules is None or k[0] in assessed_rules)
             and _path_assessed(k[0], k[1])]
    return active, stale


def gates(findings, fail_on: str) -> bool:
    """True when any finding is at/above the ``fail_on`` severity."""
    threshold = SEVERITIES.index(fail_on)
    return any(SEVERITIES.index(f.severity) >= threshold
               for f in findings)


def render_findings(findings, stale=()) -> str:
    """Human rendering, one line per finding: file:line: [RULE/sev]
    symbol: message."""
    lines = []
    order = {s: i for i, s in enumerate(SEVERITIES)}
    for f in sorted(findings,
                    key=lambda f: (-order[f.severity], _norm(f.file),
                                   f.line, f.rule)):
        lines.append(f"{_norm(f.file)}:{f.line}: [{f.rule}/{f.severity}]"
                     f" {f.symbol}: {f.message}")
    for rule, fpath, symbol in stale:
        lines.append(f"{fpath}:0: [HL000/warning] {symbol}: stale "
                     f"baseline entry for {rule} — the finding it kept "
                     f"no longer exists; delete it")
    return "\n".join(lines)
