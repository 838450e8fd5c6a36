"""Layer 2: AST-level lint over the port's source (``HL2xx``).

The counterpart of ``parallel_heat_tpu/analysis/astlint.py``, over
``parallel_heat_tpu_torch`` and ``chip_smoke.py``. Pure ``ast`` and text:
no torch import, no card, no ``nvcc``, so the layer runs in well under a
second. Each rule is a function ``rule(tree, src_lines, path) ->
[Finding]``; the registry ``AST_RULES`` maps rule id -> (severity,
summary, fn).

Rules:

- **HL201 blocking-in-dispatch** — no blocking host syncs inside
  *dispatch regions*: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, any ``.synchronize()`` (``torch.cuda.synchronize``,
  ``Event.synchronize``, ``Stream.synchronize``), ``float()/int()/
  bool()`` on non-literals, ``time.sleep``, and the JAX forms the
  reference names (``block_until_ready``, ``device_get``,
  ``np.asarray``, ``sync(...)``). A region is a function whose ``def``
  line (or the line above it) carries ``# heatlint: dispatch-region``,
  or the lines between ``# heatlint: begin dispatch-region`` / ``#
  heatlint: end dispatch-region`` markers. The timed loops of
  ``bench_kernels.py`` carry the markers, with each timer's closing sync
  outside its region.
- **HL202 wallclock-in-traced** — no wall-clock or host-RNG calls
  (``time.*``, ``datetime.*``, ``random.*``, ``np.random.*``, ``uuid``,
  ``secrets``, ``os.urandom``) inside traced code: functions decorated
  with or passed to ``torch.compile``, ``torch.jit.script`` /
  ``trace``, ``torch.cuda.make_graphed_callables`` (and the JAX entries
  the reference names), and the body of a ``with torch.cuda.graph(...)``
  capture. Such a call runs once while the program is captured, and the
  replay reuses its value forever. The port has no traced code today;
  the rule runs all the same.
- **HL203 kernel-name**, in its Hopper form — every ``__global__``
  function under ``csrc/`` is named ``heat_*`` (profiles attribute
  device time by that prefix), and every entry of ``kernels/build.py``'s
  ``KERNELS`` and ``TOOLS`` names an ``extern "C"`` function defined in
  its own source. The sources are read as text (the CPU has no
  ``nvcc``). In Python, a ``pallas_call`` without a literal
  ``name="heat_*"`` is flagged as the reference flags it.
- **HL204 lock-discipline** — in classes holding a ``threading.Lock``/
  ``RLock`` attribute, any attribute the class mutates under ``with
  self.<lock>`` somewhere is *lock-guarded*; mutating it anywhere else
  (outside ``__init__``) is a race.
- **HL205 unused-import** — a module-level import never referenced (by
  name, in ``__all__``, or via a ``# noqa`` waiver). ``__init__.py``
  re-export surfaces are skipped.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional

from parallel_heat_tpu_torch.analysis.findings import Finding

_PRAGMA_FUNC = "heatlint: dispatch-region"
_PRAGMA_BEGIN = "heatlint: begin dispatch-region"
_PRAGMA_END = "heatlint: end dispatch-region"

# Repo root, derived from this file's location — the default scan
# scope must NOT depend on the invoker's cwd: a gate run from any
# other directory would otherwise scan zero files and report clean.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Default AST-layer scan scope, relative to the repo root.
DEFAULT_PATHS = ("parallel_heat_tpu_torch", "chip_smoke.py")

# CUDA sources the HL203 rule reads as text.
CUDA_SUFFIXES = (".cu", ".cuh", ".inc")


def default_scan_paths():
    """The default scope resolved against the repo root; raises when
    nothing resolves (a silently-empty scan set would un-gate CI)."""
    paths = [os.path.join(REPO_ROOT, p) for p in DEFAULT_PATHS]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        raise RuntimeError(
            f"heatlint: none of the default scan paths {DEFAULT_PATHS} "
            f"exist under {REPO_ROOT!r} — refusing to report a clean "
            f"result for an empty scan")
    return paths


def _iter_files(paths, suffixes):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(suffixes):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git", "build"))
            for name in sorted(files):
                if name.endswith(suffixes):
                    yield os.path.join(root, name)


def _qual_name(node) -> Optional[str]:
    """Dotted name of a call target: ``jax.block_until_ready`` ->
    'jax.block_until_ready', bare ``sync`` -> 'sync'."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _enclosing_symbol(stack) -> str:
    names = [n.name for n in stack
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    return ".".join(names) if names else "<module>"


class _Walker(ast.NodeVisitor):
    """Generic visitor that tracks the def/class stack."""

    def __init__(self):
        self.stack: list = []

    def generic_visit(self, node):
        push = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
        if push:
            self.stack.append(node)
        super().generic_visit(node)
        if push:
            self.stack.pop()

    visit_FunctionDef = generic_visit
    visit_AsyncFunctionDef = generic_visit
    visit_ClassDef = generic_visit


# ---------------------------------------------------------------------------
# HL201 blocking-in-dispatch
# ---------------------------------------------------------------------------

# Method tails that wait for the device: the torch forms and the JAX
# forms of the reference; these also as bare calls (a bound
# ``event.synchronize`` or an imported ``synchronize``).
_BLOCKING_TAILS = ("item", "cpu", "tolist", "numpy", "synchronize",
                   "block_until_ready", "device_get")
_BLOCKING_BARE = ("block_until_ready", "device_get", "synchronize")
_BLOCKING_CALLS = ("sync", "time.sleep")
_BLOCKING_ASARRAY = ("np.asarray", "numpy.asarray", "onp.asarray")
_SCALAR_CASTS = ("float", "int", "bool")


def _cpu_target(node) -> bool:
    """Is ``node`` (an argument of ``.to``) the CPU: ``"cpu"``,
    ``"cpu:N"``, ``torch.device("cpu")`` or a name ending in ``cpu``?"""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and (
            node.value == "cpu" or node.value.startswith("cpu:"))
    if isinstance(node, ast.Call):
        q = _qual_name(node.func) or ""
        return q.rsplit(".", 1)[-1] == "device" and bool(node.args) \
            and _cpu_target(node.args[0])
    q = _qual_name(node)
    return q is not None and q.rsplit(".", 1)[-1].lower().endswith("cpu")


def _blocking_to(node) -> bool:
    """``x.to(<the CPU>)`` without ``non_blocking=True``: a copy to the
    host that waits for the device."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    targets = list(node.args[:1]) + [k.value for k in node.keywords
                                     if k.arg == "device"]
    if not any(_cpu_target(t) for t in targets):
        return False
    return not any(k.arg == "non_blocking" and isinstance(k.value,
                                                         ast.Constant)
                   and k.value.value is True for k in node.keywords)


def _string_lines(tree):
    """Lines covered by string literals (docstrings included) — a
    marker mentioned in documentation is not a marker."""
    lines = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Constant, ast.JoinedStr)) and (
                isinstance(node, ast.JoinedStr)
                or isinstance(node.value, str)):
            lines.update(range(node.lineno, (node.end_lineno or
                                             node.lineno) + 1))
    return lines


def _dispatch_regions(tree, src_lines, path):
    """``(line ranges covered by a dispatch-region pragma, marker
    findings)``. An unterminated ``begin`` marker still covers
    begin..EOF (conservative) but is reported — a deleted ``end`` line
    must never silently disable the rule."""
    regions = []
    findings = []
    in_string = _string_lines(tree)
    # Function-level pragma: on the def line or the line above it.
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cand = [src_lines[node.lineno - 1]]
        if node.lineno >= 2:
            cand.append(src_lines[node.lineno - 2])
        if any(_PRAGMA_FUNC in c and _PRAGMA_BEGIN not in c
               for c in cand):
            regions.append((node.lineno, node.end_lineno))
    # Block markers.
    begin = None
    for i, line in enumerate(src_lines, start=1):
        if i in in_string:
            continue
        if _PRAGMA_BEGIN in line:
            if begin is not None:
                findings.append(Finding(
                    "HL201", "error", path, begin, "<module>",
                    f"'# {_PRAGMA_BEGIN}' marker at line {begin} has "
                    f"no matching end before the next begin at line "
                    f"{i} — add '# {_PRAGMA_END}'"))
            begin = i
        elif _PRAGMA_END in line and begin is not None:
            regions.append((begin, i))
            begin = None
    if begin is not None:
        findings.append(Finding(
            "HL201", "error", path, begin, "<module>",
            f"unterminated '# {_PRAGMA_BEGIN}' marker — no matching "
            f"'# {_PRAGMA_END}' before end of file (scanning "
            f"begin..EOF conservatively; terminate the region)"))
        regions.append((begin, len(src_lines)))
    return regions, findings


def rule_hl201(tree, src_lines, path) -> List[Finding]:
    regions, out0 = _dispatch_regions(tree, src_lines, path)
    if not regions:
        return out0

    def in_region(lineno):
        return any(lo <= lineno <= hi for lo, hi in regions)

    out = out0

    class V(_Walker):
        def visit_Call(self, node):
            if in_region(node.lineno):
                why = None
                q = _qual_name(node.func)
                if q is None and isinstance(node.func, ast.Attribute):
                    q = f"<expr>.{node.func.attr}"
                if _blocking_to(node):
                    why = (f"{q}() copies to the host without "
                           f"non_blocking=True")
                elif q is not None:
                    tail = q.rsplit(".", 1)[-1]
                    if tail in _BLOCKING_TAILS and (
                            "." in q or tail in _BLOCKING_BARE):
                        why = f"{q}() synchronizes with the device"
                    elif q in _BLOCKING_CALLS:
                        why = f"{q}() blocks the dispatch path"
                    elif q in _BLOCKING_ASARRAY or q.endswith(".asarray") \
                            and not q.startswith(("jnp", "jax")):
                        why = (f"{q}() gathers the array to host "
                               f"(a full device sync + transfer)")
                    elif q in _SCALAR_CASTS and node.args and not \
                            isinstance(node.args[0], ast.Constant):
                        why = (f"{q}() on a possible device value reads "
                               f"it to host (blocks on the stream)")
                if why is not None:
                    out.append(Finding(
                        "HL201", "error", path, node.lineno,
                        _enclosing_symbol(self.stack),
                        f"blocking call inside a dispatch region: {why} "
                        f"— drain observers outside the region or use a "
                        f"non-blocking copy (copy_to_host_async)"))
            self.generic_visit(node)

    V().visit(tree)
    return out


# ---------------------------------------------------------------------------
# HL202 wallclock-in-traced
# ---------------------------------------------------------------------------

# Calls whose function arguments are traced or captured: torch's, and
# the reference's JAX entries (so that its fixtures read the same here).
_TRACE_ENTRY_CALLS = {
    "compile", "script", "trace", "make_graphed_callables",
    "fori_loop", "while_loop", "scan", "cond", "switch", "pallas_call",
    "shard_map", "_shard_map", "jit", "named_call", "checkpoint",
    "remat", "vmap", "pmap", "grad", "value_and_grad",
}
# Decorators that trace the function they wrap.
_TRACE_DECORATORS = ("jit", "compile", "script", "trace")
# ``with <ctx>:`` blocks whose body is captured (CUDA graphs).
_CAPTURE_CONTEXTS = ("graph",)
_HOST_CLOCK_RNG_PREFIXES = (
    "time.", "datetime.", "random.", "np.random.", "numpy.random.",
    "uuid.", "secrets.",
)
_HOST_CLOCK_RNG_EXACT = ("os.urandom",)


def _is_trace_decorator(dec) -> bool:
    def traced(q):
        return q.rsplit(".", 1)[-1] in _TRACE_DECORATORS
    q = _qual_name(dec) or ""
    if traced(q):
        return True
    if isinstance(dec, ast.Call):
        # functools.partial(torch.compile, ...) or torch.compile(mode=...)
        fq = _qual_name(dec.func) or ""
        if traced(fq):
            return True
        if fq.endswith("partial") and dec.args:
            if traced(_qual_name(dec.args[0]) or ""):
                return True
    return False


def rule_hl202(tree, src_lines, path) -> List[Finding]:
    # Pass 1: collect traced roots — decorated defs, defs/lambdas passed
    # (by name or inline) to trace-entry calls, and capture blocks.
    module_defs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_defs.setdefault(node.name, node)
    traced_nodes = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_trace_decorator(d) for d in node.decorator_list):
                traced_nodes.append(node)
        elif isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    q = _qual_name(expr.func) or ""
                    if (q.rsplit(".", 1)[-1] in _CAPTURE_CONTEXTS
                            and "cuda" in q):
                        traced_nodes.append(node)
        elif isinstance(node, ast.Call):
            q = _qual_name(node.func) or ""
            if q.rsplit(".", 1)[-1] not in _TRACE_ENTRY_CALLS:
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    traced_nodes.append(arg)
                elif isinstance(arg, ast.Name) and arg.id in module_defs:
                    traced_nodes.append(module_defs[arg.id])
    if not traced_nodes:
        return []
    spans = sorted({(n.lineno, n.end_lineno) for n in traced_nodes})

    def in_traced(lineno):
        return any(lo <= lineno <= hi for lo, hi in spans)

    out = []

    class V(_Walker):
        def visit_Call(self, node):
            if in_traced(node.lineno):
                q = _qual_name(node.func) or ""
                if (q in _HOST_CLOCK_RNG_EXACT
                        or any(q.startswith(p)
                               for p in _HOST_CLOCK_RNG_PREFIXES)):
                    out.append(Finding(
                        "HL202", "error", path, node.lineno,
                        _enclosing_symbol(self.stack),
                        f"host wall-clock/RNG call {q}() inside traced "
                        f"code: it evaluates ONCE while the program is "
                        f"traced or captured and the replay reuses that "
                        f"value forever — hoist it to the host side, or "
                        f"draw randomness on the device"))
            self.generic_visit(node)

    V().visit(tree)
    return out


# ---------------------------------------------------------------------------
# HL203 kernel-name (Hopper form)
# ---------------------------------------------------------------------------

_C_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_EXTERN_C = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')
_IDENT = re.compile(r"[A-Za-z_]\w*")


def _strip_comments(text: str) -> str:
    """C++ text with its comments blanked, newlines kept (so that line
    numbers stay those of the file)."""
    return _C_COMMENT.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                          text)


def _skip_parens(text: str, i: int) -> int:
    """Index just past the balanced parentheses that open at ``i``."""
    depth = 0
    while i < len(text):
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return i


def cuda_globals(path: str) -> List[tuple]:
    """``[(name, line)]`` of every ``__global__`` function defined in the
    CUDA source ``path`` (comments ignored; ``__launch_bounds__(...)``
    and a return type skipped)."""
    with open(path, encoding="utf-8") as f:
        text = _strip_comments(f.read())
    out = []
    for m in re.finditer(r"\b__global__\b", text):
        i = m.end()
        name = None
        while i < len(text):
            while i < len(text) and text[i].isspace():
                i += 1
            t = _IDENT.match(text, i)
            if t is None:
                break
            word = t.group(0)
            i = t.end()
            while i < len(text) and text[i].isspace():
                i += 1
            if word == "__launch_bounds__" and text[i:i + 1] == "(":
                i = _skip_parens(text, i)
                continue
            if text[i:i + 1] == "(":
                name = word
                break
        if name is not None:
            out.append((name, text.count("\n", 0, m.start()) + 1))
    return out


def cuda_extern_c(path: str) -> dict:
    """``{name: line}`` of every ``extern "C"`` function defined (not
    only declared) in the CUDA source ``path``."""
    with open(path, encoding="utf-8") as f:
        text = _strip_comments(f.read())
    out = {}
    for m in _EXTERN_C.finditer(text):
        j = _skip_parens(text, m.end() - 1)
        if text[j:].lstrip().startswith("{"):
            out[m.group(1)] = text.count("\n", 0, m.start()) + 1
    return out


def lint_cuda_file(path, rules=None) -> List[Finding]:
    """HL203 over one CUDA source: every ``__global__`` named ``heat_*``."""
    if rules is not None and "HL203" not in rules:
        return []
    return [Finding(
        "HL203", "error", path, line, name,
        f"__global__ function {name!r} is not named heat_* — every "
        f"kernel must carry the heat_ prefix so profiler traces attribute "
        f"device time to the kernel family (SEMANTICS.md annotations "
        f"contract)")
        for name, line in cuda_globals(path) if not name.startswith("heat_")]


def _registry_entries(tree):
    """``[(table, name, source, line)]`` of the module-level ``KERNELS``
    and ``TOOLS`` dict literals of a build module."""
    out = []
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("KERNELS", "TOOLS")
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Tuple) and v.elts
                    and isinstance(v.elts[0], ast.Constant)):
                continue
            out.append((node.targets[0].id, k.value, v.elts[0].value,
                        k.lineno))
    return out


def _hl203_registry(tree, path) -> List[Finding]:
    """Each ``KERNELS``/``TOOLS`` entry of a build module names an
    ``extern "C"`` function defined in its own source under the
    package's ``csrc/``."""
    entries = _registry_entries(tree)
    if not entries:
        return []
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(path))), "csrc")
    out = []
    for table, name, source, line in entries:
        src_path = os.path.join(csrc, str(source))
        if not os.path.isfile(src_path):
            why = f"its source {source!r} does not exist under csrc/"
        elif name not in cuda_extern_c(src_path):
            why = (f"{source!r} defines no extern \"C\" function "
                   f"{name!r}")
        elif not name.startswith("heat_"):
            why = "the entry point is not named heat_*"
        else:
            continue
        out.append(Finding(
            "HL203", "error", path, line, table,
            f"{table} entry {name!r}: {why} — the loader binds the "
            f"library's symbol by the entry's name"))
    return out


def _hl203_python(tree, path) -> List[Finding]:
    out = []

    class V(_Walker):
        def visit_Call(self, node):
            q = _qual_name(node.func) or ""
            if q.rsplit(".", 1)[-1] == "pallas_call":
                name_kw = next((k.value for k in node.keywords
                                if k.arg == "name"), None)
                sym = _enclosing_symbol(self.stack)
                if name_kw is None:
                    out.append(Finding(
                        "HL203", "error", path, node.lineno, sym,
                        "pallas_call without a name= — every kernel "
                        "must carry a literal name=\"heat_*\" so "
                        "profiler traces attribute device time to the "
                        "kernel family (SEMANTICS.md annotations "
                        "contract)"))
                elif not (isinstance(name_kw, ast.Constant)
                          and isinstance(name_kw.value, str)
                          and name_kw.value.startswith("heat_")):
                    out.append(Finding(
                        "HL203", "error", path, node.lineno, sym,
                        "pallas_call name= must be a string literal "
                        "starting with 'heat_' (got "
                        f"{ast.dump(name_kw)[:60]})"))
            self.generic_visit(node)

    V().visit(tree)
    return out


def rule_hl203(tree, src_lines, path) -> List[Finding]:
    return _hl203_python(tree, path) + _hl203_registry(tree, path)


# ---------------------------------------------------------------------------
# HL204 lock-discipline
# ---------------------------------------------------------------------------

_MUTATOR_METHODS = ("append", "extend", "insert", "add", "update",
                    "pop", "popleft", "remove", "clear", "discard",
                    "appendleft", "setdefault", "put", "put_nowait")


def _self_attr(node) -> Optional[str]:
    """'x' for ``self.x``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_attrs(cls) -> set:
    """Attributes assigned a threading.Lock()/RLock() anywhere in the
    class."""
    locks = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            q = _qual_name(node.value.func) or ""
            if q.rsplit(".", 1)[-1] in ("Lock", "RLock"):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        locks.add(attr)
    return locks


def _attr_mutations(node):
    """Yield (attr_name, lineno) for ``self.X = ...``, ``self.X += ...``
    and ``self.X.append(...)``-style mutations inside ``node``."""
    for n in ast.walk(node):
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    yield attr, n.lineno
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr in _MUTATOR_METHODS:
                attr = _self_attr(n.func.value)
                if attr is not None:
                    yield attr, n.lineno


def rule_hl204(tree, src_lines, path) -> List[Finding]:
    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods = [m for m in cls.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        # Line spans inside `with self.<lock>:` blocks, per method.
        locked_spans = []
        for m in methods:
            for n in ast.walk(m):
                if isinstance(n, ast.With):
                    for item in n.items:
                        expr = item.context_expr
                        # with self._lock:  /  with self._lock, other:
                        attr = _self_attr(expr)
                        if attr is None and isinstance(expr, ast.Call):
                            attr = _self_attr(expr.func)
                        if attr in locks:
                            locked_spans.append((n.lineno, n.end_lineno))
                            break

        def under_lock(lineno):
            return any(lo <= lineno <= hi for lo, hi in locked_spans)

        # Infer the guarded set: attrs mutated under a lock anywhere
        # outside __init__.
        guarded = set()
        for m in methods:
            if m.name == "__init__":
                continue
            for attr, lineno in _attr_mutations(m):
                if under_lock(lineno) and attr not in locks:
                    guarded.add(attr)
        if not guarded:
            continue
        for m in methods:
            if m.name == "__init__":
                continue
            for attr, lineno in _attr_mutations(m):
                if attr in guarded and not under_lock(lineno):
                    out.append(Finding(
                        "HL204", "error", path, lineno,
                        f"{cls.name}.{m.name}",
                        f"thread-shared attribute self.{attr} is "
                        f"mutated without holding the class lock — "
                        f"elsewhere in {cls.name} it is only written "
                        f"under `with self.{'/'.join(sorted(locks))}`; "
                        f"an unlocked write races those critical "
                        f"sections"))
    return out


# ---------------------------------------------------------------------------
# HL205 unused-import
# ---------------------------------------------------------------------------

def rule_hl205(tree, src_lines, path) -> List[Finding]:
    if os.path.basename(path) == "__init__.py":
        return []  # re-export surface: unused-by-design
    imports = {}  # binding name -> (lineno, display)
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                binding = alias.asname or alias.name.split(".")[0]
                imports[binding] = (node.lineno, alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                binding = alias.asname or alias.name
                imports[binding] = (
                    node.lineno,
                    f"{'.' * node.level}{node.module or ''}.{alias.name}")
    if not imports:
        return []
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                           str):
            # __all__ entries / docstring references by exact name are
            # counted as use only for __all__-style short strings.
            if node.value.isidentifier():
                used.add(node.value)
    out = []
    for binding, (lineno, display) in imports.items():
        if binding in used:
            continue
        if "noqa" in src_lines[lineno - 1]:
            continue
        out.append(Finding(
            "HL205", "error", path, lineno, "<module>",
            f"unused import: {display!r} (bound as {binding!r}) is "
            f"never referenced in this module"))
    return out


# ---------------------------------------------------------------------------
# registry / entry points
# ---------------------------------------------------------------------------

AST_RULES = {
    "HL201": ("error", "blocking host sync inside a dispatch region",
              rule_hl201),
    "HL202": ("error", "wall-clock/RNG call inside traced code",
              rule_hl202),
    "HL203": ("error", "kernel not named heat_* or registry entry unbound",
              rule_hl203),
    "HL204": ("error", "lock-guarded attribute mutated without the lock",
              rule_hl204),
    "HL205": ("error", "unused module-level import", rule_hl205),
}


def lint_file(path, rules=None) -> List[Finding]:
    """The AST rules over one Python file (or HL203 over one CUDA
    source)."""
    if str(path).endswith(CUDA_SUFFIXES):
        return lint_cuda_file(path, rules)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("HL200", "error", path, e.lineno or 0,
                        "<module>", f"syntax error: {e.msg}")]
    src_lines = src.splitlines() or [""]
    out = []
    for rule_id, (_sev, _summary, fn) in AST_RULES.items():
        if rules is not None and rule_id not in rules:
            continue
        out.extend(fn(tree, src_lines, path))
    return out


def lint_paths(paths=None, rules=None) -> List[Finding]:
    """Run the AST rules over ``paths`` (files or directories; their
    Python files and CUDA sources; defaults to the port's package and
    ``chip_smoke.py``, anchored to the repo root so the gate works from
    any cwd)."""
    if paths is None:
        paths = default_scan_paths()
    out = []
    for f in _iter_files(paths, (".py",) + CUDA_SUFFIXES):
        out.extend(lint_file(f, rules=rules))
    return out
