"""heatlint — static contract verification for parallel_heat_tpu_torch.

The counterpart of the JAX package's ``tools/heatlint.py``, with the same
flags, JSON schema and exit codes. Two layers (see
``parallel_heat_tpu_torch/analysis/``): the AST-level lint (HL2xx —
blocking syncs in dispatch regions, wall-clock/RNG in traced or captured
code, kernel names and the build registry, lock discipline, import
hygiene) and the Hopper kernel-safety audits (HL4xx — windows and TMA
boxes in bounds, shared memory and residency, cp.async and mbarrier
discipline, output coverage, over every kernel's launch plans). Neither
needs a card or ``nvcc``. The reference's trace (HL1xx) and SPMD (HL3xx)
layers have no counterpart yet: ``--layer trace`` or ``--layer spmd`` is
refused.

Usage::

    python -m parallel_heat_tpu_torch.tools.heatlint                 # full run
    python -m parallel_heat_tpu_torch.tools.heatlint --fail-on error # the gate
    python -m parallel_heat_tpu_torch.tools.heatlint --layer ast src/
    python -m parallel_heat_tpu_torch.tools.heatlint --layer kernels
    python -m parallel_heat_tpu_torch.tools.heatlint --rules HL401,HL403
    python -m parallel_heat_tpu_torch.tools.heatlint --list-rules
    python -m parallel_heat_tpu_torch.tools.heatlint --format json

Exit codes: 0 clean (below the --fail-on threshold), 1 usage/internal
error, 2 findings at/above the threshold (or stale baseline entries
under --strict-baseline). Intentionally-kept findings live in
``parallel_heat_tpu_torch/analysis/heatlint.baseline.json``
(``--baseline``) — every entry needs a one-line justification, and stale
entries are reported so the ledger shrinks when the code improves.
"""

import argparse
import json
import os
import pathlib
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# --format json schema. Version 2 added: schema_version itself, the
# per-layer "timings" map, and the "layers" list actually run.
JSON_SCHEMA_VERSION = 2

# SARIF severity mapping (SARIF has no "warning"/"error"/"info" —
# it has level: error/warning/note).
_SARIF_LEVEL = {"error": "error", "warning": "warning", "info": "note"}

LAYER_ORDER = ("trace", "ast", "spmd", "kernels")
# The reference's layers that audit jaxprs: no counterpart in the port.
_NOT_PORTED = ("trace", "spmd")


def _parse_layers(arg: str):
    """``--layer`` value -> ordered tuple of layer names (or an error
    string). Accepts ``all`` or a comma-separated subset."""
    wanted = [w.strip() for w in arg.split(",") if w.strip()]
    if not wanted:
        return None, f"--layer {arg!r}: no layer named"
    if "all" in wanted:
        if len(wanted) > 1:
            return None, "--layer all cannot be combined with others"
        return tuple(l for l in LAYER_ORDER if l not in _NOT_PORTED), None
    unknown = [w for w in wanted if w not in LAYER_ORDER]
    if unknown:
        return None, (f"unknown layer(s) {unknown} (choose from "
                      f"{', '.join(LAYER_ORDER)} or all)")
    missing = [w for w in wanted if w in _NOT_PORTED]
    if missing:
        return None, (f"layer(s) {missing} audit jaxprs and have no "
                      f"counterpart in the port yet (ROADMAP queue 1 item "
                      f"14); run ast and/or kernels")
    # Preserve canonical order, drop duplicates.
    return tuple(l for l in LAYER_ORDER if l in wanted), None


def _sarif_doc(active, stale, rule_table, layer_of):
    """Render findings as a SARIF 2.1.0 document (one run, one driver).

    Suppressed (baselined) findings are omitted — SARIF suppression
    objects confuse more CI annotators than they help; the baseline
    ledger itself is the audit trail. Stale baseline entries surface as
    HL000 warnings so the PR annotation shows the ledger rotting.
    """
    from parallel_heat_tpu_torch.analysis.findings import _norm

    rules_used = sorted({f.rule for f in active} | ({"HL000"} if stale
                                                    else set()))
    rule_index = {r: i for i, r in enumerate(rules_used)}

    def artifact(fpath):
        # Repo-relative paths resolve against SRCROOT (the repo root);
        # paths outside the repo (e.g. an explicit scan target under
        # /tmp) become self-contained absolute file URIs — a relative
        # URI against the wrong base would point at nothing.
        p = _norm(fpath)
        if os.path.isabs(p):
            return {"uri": pathlib.Path(p).as_uri()}
        return {"uri": p.replace(os.sep, "/"), "uriBaseId": "SRCROOT"}

    def rule_obj(rid):
        if rid == "HL000":
            return {"id": "HL000", "name": "stale-baseline-entry",
                    "shortDescription": {
                        "text": "baseline entry matches no finding"}}
        sev, summary, _fn = rule_table[rid]
        return {"id": rid, "name": f"{layer_of(rid)}-{rid}",
                "shortDescription": {"text": summary},
                "defaultConfiguration": {
                    "level": _SARIF_LEVEL.get(sev, "warning")}}

    def result(f):
        region = {"startLine": max(1, f.line)}
        res = {
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": _SARIF_LEVEL.get(f.severity, "warning"),
            "message": {"text": f"{f.symbol}: {f.message}"},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": artifact(f.file),
                    "region": region,
                }}],
        }
        if f.soundness:
            res["properties"] = {"soundness": True}
        return res

    results = [result(f) for f in active]
    for rule, fpath, symbol in stale:
        results.append({
            "ruleId": "HL000",
            "ruleIndex": rule_index["HL000"],
            "level": "warning",
            "message": {"text": f"{symbol}: stale baseline entry for "
                                f"{rule} — the finding it kept no "
                                f"longer exists; delete it"},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": artifact(fpath),
                    "region": {"startLine": 1},
                }}],
        })
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "heatlint",
                "informationUri": "docs/API.md",
                "rules": [rule_obj(r) for r in rules_used],
            }},
            "originalUriBaseIds": {
                "SRCROOT": {"uri": pathlib.Path(_REPO_ROOT).as_uri()
                            + "/"}},
            "results": results,
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/directories for the AST layer "
                         "(default: parallel_heat_tpu_torch chip_smoke.py)")
    ap.add_argument("--layer", default="all",
                    help="comma-separated analyzer layer subset: ast, "
                         "kernels, or all (default; trace and spmd have no "
                         "counterpart in the port and are refused). 'ast' "
                         "takes under a second")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule-id subset (e.g. "
                         "HL101,HL301); layers with no selected rule "
                         "are skipped entirely")
    ap.add_argument("--fail-on", choices=("error", "warning", "info"),
                    default="error", dest="fail_on",
                    help="exit 2 when any finding is at/above this "
                         "severity (default error)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file of justified keeps (default: "
                         "parallel_heat_tpu_torch/analysis/"
                         "heatlint.baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file (show everything)")
    ap.add_argument("--strict-baseline", action="store_true",
                    dest="strict_baseline",
                    help="stale baseline entries gate like findings "
                         "(exit 2) instead of warning — the CI ledger "
                         "mode: the ledger can never outlive the code "
                         "it excuses")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default=None, dest="format",
                    help="output format (default text; sarif emits a "
                         "SARIF 2.1.0 document for CI PR annotation)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="alias for --format json")
    ap.add_argument("--no-timings", action="store_true",
                    help="suppress the per-layer timing summary line")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.as_json and args.format not in (None, "json"):
        print("heatlint: --json conflicts with --format "
              f"{args.format}", file=sys.stderr)
        return 1
    fmt = args.format or ("json" if args.as_json else "text")

    layers, err = _parse_layers(args.layer)
    if err:
        print(f"heatlint: {err}", file=sys.stderr)
        return 1

    # The kernel layer imports torch only when it runs, so reading the
    # rule tables is cheap.
    from parallel_heat_tpu_torch.analysis import ALL_RULES, LAYERS, layer_of
    from parallel_heat_tpu_torch.analysis.astlint import lint_paths
    from parallel_heat_tpu_torch.analysis.findings import (
        apply_baseline, gates, load_baseline, render_findings)

    if args.list_rules:
        for rid in sorted(ALL_RULES):
            sev, summary, _fn = ALL_RULES[rid]
            print(f"{rid}  [{layer_of(rid)}/{sev}]  {summary}")
        return 0

    rules = None
    if args.rules:
        rules = {r.strip().upper() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(ALL_RULES)
        if unknown:
            print(f"heatlint: unknown rule id(s): {sorted(unknown)} "
                  f"(--list-rules shows the table)", file=sys.stderr)
            return 1

    # Layers that will actually run given --rules (a layer with no
    # selected rule is skipped entirely).
    run_layers = tuple(
        l for l in layers
        if rules is None or (rules & set(LAYERS[l][0])))

    try:
        baseline = None
        if not args.no_baseline:
            baseline = load_baseline(args.baseline)
    except (ValueError, FileNotFoundError, json.JSONDecodeError) as e:
        print(f"heatlint: bad baseline: {e}", file=sys.stderr)
        return 1

    findings = []
    timings = {}
    # Rules assessed this run — the stale-ness scope: a baseline entry
    # whose rule's layer was skipped (--layer / --rules subset) was
    # never given a chance to match, so it is unassessed, not stale —
    # otherwise an AST-only run would gate on every kernels ledger entry
    # it never ran.
    assessed = set()
    for layer in run_layers:
        table, run = LAYERS[layer]
        t0 = time.perf_counter()
        if layer == "ast":
            findings.extend(lint_paths(args.paths or None, rules=rules))
        else:
            findings.extend(run(rules))
        assessed |= (set(table) if rules is None
                     else set(table) & rules)
        timings[layer] = time.perf_counter() - t0

    # An explicit path subset leaves the rest of the repo unscanned:
    # an AST-rule ledger entry for an unscanned file may still have
    # its violation alive there, so only entries under the scanned
    # roots are stale-assessable.
    from parallel_heat_tpu_torch.analysis.findings import _norm
    assessed_paths = (tuple(_norm(p).rstrip("/") for p in args.paths)
                      if args.paths else None)
    active, stale = apply_baseline(
        findings, baseline, assessed_rules=assessed,
        assessed_paths=assessed_paths,
        path_rules=frozenset(LAYERS["ast"][0]))
    timing_line = ", ".join(f"{k} {v:.2f}s" for k, v in timings.items())

    if fmt == "json":
        print(json.dumps({
            "schema_version": JSON_SCHEMA_VERSION,
            "findings": [f.to_dict() for f in active],
            "stale_baseline": [
                {"rule": r, "file": p, "symbol": s}
                for r, p, s in stale],
            "fail_on": args.fail_on,
            "strict_baseline": args.strict_baseline,
            "layers": list(timings),
            "timings": {k: round(v, 3) for k, v in timings.items()},
        }, indent=2))
    elif fmt == "sarif":
        print(json.dumps(_sarif_doc(active, stale, ALL_RULES, layer_of),
                         indent=2))
    else:
        text = render_findings(active, stale)
        if text:
            print(text)
        n_err = sum(f.severity == "error" for f in active)
        n_warn = sum(f.severity == "warning" for f in active)
        print(f"heatlint: {n_err} error(s), {n_warn} warning(s), "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}"
              + (f" [{baseline.path}]"
                 if baseline and baseline.path else ""))
        if timing_line and not args.no_timings:
            print(f"heatlint: layer timings: {timing_line}")
    if gates(active, args.fail_on):
        return 2
    if args.strict_baseline and stale:
        if fmt == "text":
            print("heatlint: --strict-baseline: stale entries gate",
                  file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
