"""The lint rules, one per bug class the reference shipped, in the port's form.

Each rule keeps the reference's id (``repro.analysis.lints.rules``) and
matches the torch shape of its bug:

- REP001: a key of the counter-based draws (``utils/draws.py``: ``key``,
  ``leaf_keys``, ``fold``) passed to two consumers without a ``fold``
  between them; and two ``torch.Generator``s seeded from the same
  expression in one scope;
- REP002: ``torch.from_numpy(x)`` / ``torch.as_tensor(x)`` (zero-copy
  aliases of host memory) where ``x`` is mutated later in the scope;
- REP003: float32 casts of count-like names (``.float()``,
  ``.to(torch.float32)``, ``.type(torch.float32)``,
  ``torch.tensor/as_tensor(..., dtype=torch.float32)``, and the numpy
  forms);
- REP004: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``float()``/``int()`` of a tensor expression and ``np.asarray`` inside a
  loop under a span (``obs.trace.span`` / ``annotate_scope``,
  ``torch.profiler.record_function``, NVTX ranges) or a clock-timed region
  (``torch.cuda.synchronize()`` ends a timed region and is not flagged);
- REP005, REP006: as the reference's.

False positives are suppressed inline with ``# repro-noqa: REPxxx`` and the
reason on the same line.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lints import rule

# ---------------------------------------------------------------------------
# Shared AST helpers (the reference's)
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ("torch.cuda.synchronize")."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def scopes(tree: ast.AST):
    """Yield (scope_node, is_module) for the module and every function."""
    yield tree, True
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, False


def walk_scope(scope: ast.AST):
    """ast.walk that does not descend into nested function/class bodies
    (those are their own scopes); lambdas stay in the enclosing scope."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def pos(node: ast.AST) -> tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


def end_pos(node: ast.AST) -> tuple[int, int]:
    return (getattr(node, "end_lineno", getattr(node, "lineno", 0)),
            getattr(node, "end_col_offset", 0))


# ---------------------------------------------------------------------------
# REP001 — key reuse
# ---------------------------------------------------------------------------

_KEY_DERIVERS = ("draws.key", "draws.leaf_keys", "draws.fold")


def _is_deriver(name: str) -> bool:
    return name.endswith(_KEY_DERIVERS) or name == "leaf_keys"


def _is_key_source(node: ast.AST) -> bool:
    """True when the expression evaluates to a key: a deriver's call (or an
    element of one), not a consumer whose result is data."""
    if isinstance(node, ast.Call):
        return _is_deriver(dotted(node.func))
    if isinstance(node, ast.Subscript):
        return _is_key_source(node.value)
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_is_key_source(e) for e in node.elts)
    if isinstance(node, ast.Starred):
        return _is_key_source(node.value)
    return False


def _branch_path(scope: ast.AST) -> dict[int, tuple]:
    """Map id(node) -> tuple of (branch_node_id, arm) pairs above it: two
    events in the two arms of one ``if`` never both run."""
    paths: dict[int, tuple] = {}

    def visit(node, path):
        paths[id(node)] = path
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not scope:
            return
        if isinstance(node, ast.If):
            for child in node.body:
                visit(child, path + ((id(node), "body"),))
            for child in node.orelse:
                visit(child, path + ((id(node), "else"),))
            visit(node.test, path)
            return
        if isinstance(node, ast.Try):
            for child in node.body:
                visit(child, path + ((id(node), "try"),))
            for h in node.handlers:
                visit(h, path + ((id(node), "except"),))
            for child in node.orelse + node.finalbody:
                visit(child, path)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, path)

    for child in ast.iter_child_nodes(scope):
        visit(child, ())
    return paths


def _exclusive(p1: tuple, p2: tuple) -> bool:
    """True when the two branch paths sit in different arms of one branch."""
    arms1 = dict(p1)
    return any(bid in arms1 and arms1[bid] != arm for bid, arm in p2)


def _key_reuse(scope, paths, path) -> list[Finding]:
    """A draws key consumed twice with no rebinding in between."""
    key_names: set[str] = set()
    for node in walk_scope(scope):
        if isinstance(node, ast.Assign) and _is_key_source(node.value):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        key_names.add(n.id)
    if not key_names:
        return []
    events = []  # (pos, kind, name, node)
    for node in walk_scope(scope):
        if isinstance(node, ast.Call):
            if _is_deriver(dotted(node.func)):
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in key_names:
                    events.append((pos(arg), "use", arg.id, node))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id in key_names:
                        # barrier at statement END: `k = f(k)` uses k first
                        events.append((end_pos(node), "assign", n.id, node))
    events.sort(key=lambda e: e[0])
    findings = []
    last_use: dict[str, tuple[int, tuple]] = {}
    for (line, _col), kind, name, node in events:
        if kind == "assign":
            last_use.pop(name, None)
            continue
        here = paths.get(id(node), ())
        prev = last_use.get(name)
        if prev is None:
            last_use[name] = (line, here)
        elif not _exclusive(prev[1], here):
            findings.append(Finding(
                "REP001", path, line,
                f"draws key `{name}` already consumed at line {prev[0]}; fold a counter "
                f"into it (draws.fold / a longer draws.key chain) before reusing — reuse "
                f"correlates the two streams"))
    return findings


def _seed_reuse(scope, paths, path) -> list[Finding]:
    """Two generators seeded from the same expression in one scope."""
    seeds: dict[str, tuple[int, tuple]] = {}
    findings = []
    calls = [n for n in walk_scope(scope) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "manual_seed"
             and len(n.args) == 1]
    for node in sorted(calls, key=pos):
        expr = ast.unparse(node.args[0])
        here = paths.get(id(node), ())
        prev = seeds.get(expr)
        if prev is not None and not _exclusive(prev[1], here):
            findings.append(Finding(
                "REP001", path, node.lineno,
                f"a generator seeded from `{expr}` already at line {prev[0]}; derive "
                f"distinct seeds — two generators of one seed draw the same stream"))
        else:
            seeds[expr] = (node.lineno, here)
    return findings


@rule("REP001", "prng-key-reuse",
      doc="a draws key (utils/draws.py key/leaf_keys/fold) passed to two consumers "
          "without a fold between them, or two torch.Generators seeded from the same "
          "expression in one scope (correlated streams)",
      history="reference PR 4: launch/serve.py drew served prompts and weight init "
              "from the same key — inputs were correlated with the weights")
def prng_key_reuse(tree: ast.AST, path: str) -> list[Finding]:
    findings = []
    for scope, _ in scopes(tree):
        paths = _branch_path(scope)
        findings += _key_reuse(scope, paths, path)
        findings += _seed_reuse(scope, paths, path)
    return findings


# ---------------------------------------------------------------------------
# REP002 — a zero-copy tensor of a host buffer that is mutated afterwards
# ---------------------------------------------------------------------------

_INPLACE_METHODS = {"fill", "sort", "put", "partition", "resize", "itemset",
                    "setfield", "setflags"}
_ALIASERS = ("torch.from_numpy", "torch.as_tensor")


@rule("REP002", "device-put-alias",
      doc="torch.from_numpy(x) / torch.as_tensor(x) where the host buffer `x` is "
          "mutated later in the same scope (the tensor aliases the numpy memory, and "
          "an asynchronous copy from it may read the mutated bytes)",
      history="reference PR 6: the serve engine device_put its block tables, then "
              "mutated them before async dispatch read them — ~15% of fresh "
              "processes corrupted a slot's decode")
def device_put_alias(tree: ast.AST, path: str) -> list[Finding]:
    findings = []
    for scope, _ in scopes(tree):
        aliases = []  # (name, pos, line, call)
        for node in walk_scope(scope):
            if (isinstance(node, ast.Call) and dotted(node.func) in _ALIASERS
                    and node.args and isinstance(node.args[0], ast.Name)):
                aliases.append((node.args[0].id, pos(node), node.lineno,
                                dotted(node.func)))
        if not aliases:
            continue
        for node in walk_scope(scope):
            mutated = mline = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                        mutated, mline = t.value.id, t.lineno
                    elif isinstance(node, ast.AugAssign) and isinstance(t, ast.Name):
                        mutated, mline = t.id, t.lineno
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_METHODS
                  and isinstance(node.func.value, ast.Name)):
                mutated, mline = node.func.value.id, node.lineno
            if mutated is None:
                continue
            for name, apos, aline, fn in aliases:
                if name == mutated and pos(node) > apos:
                    findings.append(Finding(
                        "REP002", path, aline,
                        f"`{fn}({name})` aliases the host buffer, which is mutated at "
                        f"line {mline}; snapshot it with .copy() first"))
    return findings


# ---------------------------------------------------------------------------
# REP003 — float32 casts of count/byte quantities
# ---------------------------------------------------------------------------

_COUNTISH = re.compile(
    r"(^|_)(nnz|count|counts|bytes|n_bytes|total_params|param_count|"
    r"n_params|num_params)($|_)", re.IGNORECASE)


def _countish_expr(node: ast.AST) -> str | None:
    """Name of the first count-like identifier inside ``node``, else None."""
    for sub in ast.walk(node):
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            ident = sub.value
        if ident and _COUNTISH.search(ident):
            return ident
    return None


def _is_f32(node: ast.AST | None) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Attribute):
        return node.attr == "float32" or dotted(node) == "torch.float"
    if isinstance(node, ast.Name):
        return node.id == "float32"
    if isinstance(node, ast.Constant):
        return node.value == "float32"
    return False


def _dtype_arg(node: ast.Call, position: int) -> ast.AST | None:
    dt = node.args[position] if len(node.args) > position else None
    for k in node.keywords:
        if k.arg == "dtype":
            dt = k.value
    return dt


def _cast_target(node: ast.Call) -> ast.AST | None:
    """The expression ``node`` casts to float32, else None."""
    fname = dotted(node.func)
    method = node.func.attr if isinstance(node.func, ast.Attribute) else None
    if method == "float" and not node.args and not node.keywords:
        return node.func.value                                 # x.float()
    if method in ("to", "type", "astype") and (
            any(_is_f32(a) for a in node.args) or _is_f32(_dtype_arg(node, 99))):
        return node.func.value                                 # x.to(torch.float32)
    if fname.endswith("float32") and node.args:
        return node.args[0]                                    # np.float32(x)
    if fname.endswith((".asarray", ".array")) and node.args and _is_f32(_dtype_arg(node, 1)):
        return node.args[0]                                    # np.asarray(x, np.float32)
    if fname in ("torch.tensor", "torch.as_tensor") and node.args \
            and _is_f32(_dtype_arg(node, 99)):
        return node.args[0]                                    # torch.tensor(x, dtype=f32)
    return None


@rule("REP003", "float32-count-cast",
      doc="casting a count/byte quantity to float32 (.float(), .to/.type(torch.float32), "
          "torch.tensor/as_tensor(..., dtype=torch.float32), the numpy casts): exact only "
          "to 2^24 — count in int32/int64 on the device, in float64 on the host",
      history="reference PR 4: tree_nnz counted in float32 and the ledger's byte "
              "totals drifted at ≥1B params before the host accounting ever saw them")
def float32_count_cast(tree: ast.AST, path: str) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        target = _cast_target(node)
        if target is None:
            continue
        ident = _countish_expr(target)
        if ident:
            findings.append(Finding(
                "REP003", path, node.lineno,
                f"float32 cast of count-like quantity `{ident}` — float32 is exact only "
                f"to 2^24; keep counts int32/int64 on the device and do byte arithmetic "
                f"in float64 on the host (core/accounting.py owns that conversion)"))
    return findings


# ---------------------------------------------------------------------------
# REP004 — host syncs inside span-timed / clock-timed loops
# ---------------------------------------------------------------------------

_SPAN_CALLS = ("span", "annotate_scope", "record_function", "TraceAnnotation")
_TIMER_CALLS = ("time.time", "time.perf_counter", "time.monotonic", "time.perf_counter_ns",
                "time.monotonic_ns", "timeit.default_timer")
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")


def _is_span_with(node: ast.With) -> str | None:
    for item in node.items:
        c = item.context_expr
        if isinstance(c, ast.Call):
            name = dotted(c.func)
            if name.split(".")[-1] in _SPAN_CALLS or name.endswith("nvtx.range"):
                return name
    return None


def _host_sync(node: ast.Call) -> str | None:
    """A label when ``node`` reads a device value on the host."""
    name = dotted(node.func)
    last = name.split(".")[-1]
    base = name.split(".")[0] if "." in name else ""
    if last in ("asarray", "array") and base in ("np", "numpy") and node.args:
        # literals and comprehensions build host data; no device involved
        if not isinstance(node.args[0], (ast.Constant, ast.List, ast.Tuple, ast.ListComp,
                                         ast.GeneratorExp)):
            return name
    if isinstance(node.func, ast.Attribute) and last in _SYNC_METHODS and not node.args:
        return f".{last}()"
    if isinstance(node.func, ast.Name) and node.func.id in ("float", "int") and node.args:
        a = node.args[0]
        # float(call(...)) is usually host math; ALL_CAPS names are module
        # constants; the device-sync shape is float(metrics["x"]) / int(info.nnz)
        if isinstance(a, (ast.Constant, ast.Call)):
            return None
        if isinstance(a, ast.Name) and a.id.isupper():
            return None
        return f"{node.func.id}()"
    return None


def _syncs_in(body: list[ast.stmt]) -> list[tuple[int, str]]:
    out = []
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                label = _host_sync(node)
                if label:
                    out.append((node.lineno, label))
    return out


@rule("REP004", "host-sync-in-timed-loop",
      doc=".item()/.cpu()/.tolist()/.numpy()/float()/int()/np.asarray inside a loop "
          "under a span (obs.trace.span/annotate_scope, torch.profiler.record_function, "
          "NVTX) or a clock-timed region — each iteration waits for the device and the "
          "measurement times the transfer, not the compute",
      history="reference PR 4: launch/serve.py ran a per-step np.asarray D2H sync "
              "inside the timed decode loop; tokens now stack on device and transfer once")
def host_sync_in_timed_loop(tree: ast.AST, path: str) -> list[Finding]:
    findings = []
    seen = set()

    def flag(line, label, marker):
        if (line, label) in seen:
            return
        seen.add((line, label))
        findings.append(Finding(
            "REP004", path, line,
            f"host sync {label} inside a loop under {marker} — move the transfer out of "
            f"the timed region (stack on the device, transfer once after the loop)"))

    # (a) loops lexically under a span `with`, or spans inside loops
    for node in ast.walk(tree):
        if isinstance(node, ast.With):
            span_name = _is_span_with(node)
            if span_name:
                for sub in node.body:
                    for loop in ast.walk(sub):
                        if isinstance(loop, (ast.For, ast.While)):
                            for line, label in _syncs_in(loop.body):
                                flag(line, label, f"span `{span_name}`")
        elif isinstance(node, (ast.For, ast.While)):
            for sub in node.body:
                for w in ast.walk(sub):
                    if isinstance(w, ast.With):
                        span_name = _is_span_with(w)
                        if span_name:
                            for line, label in _syncs_in(w.body):
                                flag(line, label, f"span `{span_name}` (inside a loop)")

    # (b) clock-timed regions: t0 = time.perf_counter() ... loop ... reads t0
    for scope, _ in scopes(tree):
        body = getattr(scope, "body", [])
        timers: dict[str, int] = {}  # name -> assignment line
        for i, stmt in enumerate(body):
            if (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)
                    and dotted(stmt.value.func) in _TIMER_CALLS
                    and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name)):
                timers[stmt.targets[0].id] = stmt.lineno
                continue
            if not timers:
                continue
            reads_timer = any(
                isinstance(n, ast.Name) and n.id in timers and isinstance(n.ctx, ast.Load)
                for later in body[i:] for n in ast.walk(later))
            if not reads_timer:
                continue
            for loop in ast.walk(stmt):
                if isinstance(loop, (ast.For, ast.While)):
                    tname = next(iter(timers))
                    for line, label in _syncs_in(loop.body):
                        flag(line, label, f"the `{tname} = time.*()` timed region")
                    break  # outermost loop per statement is enough
    return findings


# ---------------------------------------------------------------------------
# REP005 — module-level importorskip gating tests that don't need the dep
# ---------------------------------------------------------------------------


@rule("REP005", "module-importorskip",
      doc="module-level pytest.importorskip that gates test functions which never use "
          "the skipped dependency (the whole file skips, hiding unrelated tests when the "
          "optional dep is absent)",
      history="reference PR 4: a module-level importorskip(hypothesis) skipped "
              "non-property tests whenever the dev extra was missing; it was narrowed so "
              "they run everywhere")
def module_importorskip(tree: ast.AST, path: str) -> list[Finding]:
    if not isinstance(tree, ast.Module):
        return []
    findings = []
    skips = []  # (module_name, line, bound_name|None)
    for stmt in tree.body:
        call = None
        bound = None
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
        elif (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)
              and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name)):
            call = stmt.value
            bound = stmt.targets[0].id
        if (call is not None and dotted(call.func).endswith("importorskip")
                and call.args and isinstance(call.args[0], ast.Constant)):
            skips.append((call.args[0].value, stmt.lineno, bound))
    for modname, line, bound in skips:
        top = modname.split(".")[0]
        # names the module-level imports bind from the gated dependency
        gated: set[str] = set()
        if bound:
            gated.add(bound)
        for stmt in tree.body:
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if a.name.split(".")[0] == top:
                        gated.add((a.asname or a.name).split(".")[0])
            elif isinstance(stmt, ast.ImportFrom) and stmt.module \
                    and stmt.module.split(".")[0] == top:
                for a in stmt.names:
                    gated.add(a.asname or a.name)
        if gated:
            # a module-level import of the dependency requires the skip to
            # stay module-level
            continue
        findings.append(Finding(
            "REP005", path, line,
            f"module-level importorskip({modname!r}) but {top!r} is never imported at "
            f"module level — move the skip into the tests that need it, or suppress with "
            f"a justification if it guards subprocess-only usage"))
    return findings


# ---------------------------------------------------------------------------
# REP006 — mutable defaults (function args and dataclass field defaults)
# ---------------------------------------------------------------------------


def _mutable_default(node: ast.AST | None) -> bool:
    if node is None:
        return False
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                         ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = dotted(node.func).split(".")[-1]
        return name in ("dict", "list", "set", "zeros", "ones", "empty", "zeros_like",
                        "ones_like", "tree_zeros_like")
    return False


@rule("REP006", "mutable-default-pytree",
      doc="mutable default (dict/list/set display, or a tensor/tree constructor such as "
          "torch.zeros) in a function signature or dataclasses.field default — one shared "
          "instance leaks state across calls/configs",
      history="the reference's compensation-state seams hold mutable trees; a shared "
              "default {} as an EF residual would silently couple every config "
              "constructed without the argument")
def mutable_default_pytree(tree: ast.AST, path: str) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if _mutable_default(d):
                    findings.append(Finding(
                        "REP006", path, d.lineno,
                        "mutable default argument — every call shares one instance; "
                        "default to None and construct inside"))
        elif isinstance(node, ast.Call) and dotted(node.func).split(".")[-1] == "field":
            for k in node.keywords:
                if k.arg == "default" and _mutable_default(k.value):
                    findings.append(Finding(
                        "REP006", path, k.value.lineno,
                        "dataclasses.field(default=<mutable>) — every instance shares one "
                        "object (dataclasses only rejects bare list/dict/set defaults, not "
                        "these); use default_factory"))
    return findings
