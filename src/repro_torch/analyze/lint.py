"""Repo-specific AST lint over the port's sources (NSF101-NSF105).

The port of ``repro.analyze.lint``.  These are rules a generic linter
cannot know:

* **NSF101**: the serving stack is virtual-clock-driven: every timestamp
  must come from an injectable ``clock``/``wall`` parameter so the
  front-door, the soak benches and the tests can replace time.  A raw
  ``time.perf_counter()`` (or ``time.time/monotonic/sleep``) *call* in
  ``serve/`` silently anchors stats to the host clock.  Parameter
  defaults like ``clock=time.perf_counter`` are attribute references,
  not calls, and pass.
* **NSF102**: a hot body must not wait for the device.  ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` / ``np.array``
  and ``torch.cuda.synchronize()`` each copy a CUDA tensor to the host
  (or block on the stream), once per call.  Hot bodies are found
  structurally: a function handed to ``StageSpec(name, stream, fn)``, by
  name or as a lambda (the stage bodies ``configs/base.py`` builds, which
  the engine calls once per admission group), and the inner functions of
  ``_make_*`` builders (the engine convention: the builder's return value
  is called per step).
* **NSF103**: per-request randomness must derive from the root seed and
  the request: the port's contract is ``serve.engine.stream_seed(seed,
  uid, index)``.  A ``manual_seed(...)`` call (``torch.manual_seed`` or
  ``torch.Generator(...).manual_seed``) in a function that derives no
  seed means every request shares one stream.  A derivation is a call of
  ``stream_seed`` or a ``np.random.SeedSequence`` over a list of two or
  more words in the same function, the counterparts of the reference's
  ``fold_in``.  ``serve/deploy.py``'s ``SeedSequence([seed, i])`` counts:
  it derives model ``i``'s stream from the root seed as ``fold_in(root,
  i)`` does in the reference's ``deploy``; that generator draws the
  model's constants, which every request shares by design, while the
  requests' own streams come from ``stream_seed``.
* **NSF104**: ``EngineProtocol.submit`` implementations must stamp
  ``rec.dispatch_t`` (directly, via a same-class helper such as
  ``_admit``, or by delegating to another engine's ``.submit``) and must
  stamp it *before* any blocking call, or queue/service latency
  attribution silently charges the wait to the wrong side.
  ``typing.Protocol`` classes are declarations, not implementations, and
  are skipped.
* **NSF105**: overload-control hygiene, two halves.  (a) Every append
  to a queue-like container (name containing queue/pending/inflight/
  backlog/waiting, or the LM engine's ``_open``) in ``serve/`` must be
  *dominated by a bound check*: the same function must compare a
  ``len(...)`` or a cap/depth/bound/limit/max-named value.  (b)
  Control-plane modules (``control.py`` / ``slo.py`` / ``sim.py``) may
  not reference ``time`` at all, not even as a parameter default: they
  take explicit ``clock``/``now`` arguments.

Only :data:`SERVE_RULES` apply under ``serve/``; elsewhere in the tree
only the scope-safe NSF102 runs (training code legitimately seeds
generators, benches legitimately read the host clock).  Results are
memoized per ``(path, mtime)`` so ``deploy()`` preflight can call this on
every deployment for free.
"""

from __future__ import annotations

import ast
import os

from repro_torch.analyze.findings import AnalysisReport, Finding, finding

_CLOCK_ATTRS = {"time", "perf_counter", "monotonic", "sleep",
                "process_time"}
# (module alias, attribute) calls that copy device data to the host, and
# the tensor methods that do
_HOST_CALLS = {("np", "asarray"), ("np", "array"),
               ("numpy", "asarray"), ("numpy", "array"),
               ("onp", "asarray"), ("onp", "array"),
               ("cuda", "synchronize")}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_BLOCKING_ATTRS = {"synchronize", "block_until_ready", "drain_all",
                   "drain_ready", "_drain_one", "result", "join", "sleep"}
# NSF105 (a): queue-like container names whose append sites need a bound
# check, and the value names a Compare counts as a bound
_QUEUE_NAME_HINTS = ("queue", "pending", "inflight", "backlog", "waiting")
_QUEUE_NAMES_EXACT = {"_open"}
_APPEND_ATTRS = {"append", "extend", "appendleft"}
_BOUND_NAME_HINTS = ("cap", "depth", "bound", "limit", "max")
# NSF105 (b): control-plane modules with the strict no-time contract
_CONTROL_PLANE_FILES = {"control.py", "slo.py", "sim.py"}

SERVE_RULES = ("NSF101", "NSF102", "NSF103", "NSF104", "NSF105")
GENERAL_RULES = ("NSF102",)

_CACHE: dict[str, tuple[float, tuple[str, ...], tuple[Finding, ...]]] = {}


def _attr_chain(node: ast.expr) -> list[str]:
    """`torch.cuda.synchronize` -> ["torch", "cuda", "synchronize"] (best
    effort)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _stage_fns(tree: ast.AST) -> tuple[set[str], list[ast.Lambda]]:
    """Names and lambdas handed to ``StageSpec(name, stream, fn)`` as its
    ``fn`` (third positional argument or ``fn=``)."""
    names: set[str] = set()
    lambdas: list[ast.Lambda] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _attr_chain(node.func)[-1:] == ["StageSpec"]):
            continue
        fns = node.args[2:3] + [k.value for k in node.keywords
                                if k.arg == "fn"]
        for fn in fns:
            if isinstance(fn, ast.Name):
                names.add(fn.id)
            elif isinstance(fn, ast.Lambda):
                lambdas.append(fn)
    return names, lambdas


def _hot_bodies(tree: ast.AST) -> list[ast.AST]:
    """Every function or lambda that runs per call (see module docstring)."""
    names, hot = _stage_fns(tree)
    hot = list(hot)
    seen: set[int] = {id(fn) for fn in hot}

    def add(fn: ast.AST):
        if id(fn) not in seen:
            seen.add(id(fn))
            hot.append(fn)

    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if node.name in names:
            add(node)
        if node.name.startswith("_make_"):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.Lambda)) \
                        and sub is not node:
                    add(sub)
    return hot


def _host_call(node: ast.Call) -> str | None:
    """The rendered host materialization ``node`` makes, or None."""
    chain = _attr_chain(node.func)
    if len(chain) >= 2 and tuple(chain[-2:]) in _HOST_CALLS \
            and (chain[-2] != "cuda" or chain[0] == "torch"):
        return ".".join(chain) + "()"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _HOST_METHODS and not node.args:
        return f".{node.func.attr}()"
    return None


def _check_clock_calls(tree: ast.AST, rel: str) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if len(chain) == 2 and chain[0] == "time" \
                    and chain[1] in _CLOCK_ATTRS:
                out.append(finding(
                    "NSF101", f"{rel}:{node.lineno}",
                    f"raw time.{chain[1]}() call — read the injectable "
                    "clock/wall parameter instead (defaults may still be "
                    "time.perf_counter)"))
    return out


def _check_host_materialization(tree: ast.AST, rel: str) -> list[Finding]:
    out = []
    for fn in _hot_bodies(tree):
        name = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                what = _host_call(node)
                if what is not None:
                    out.append(finding(
                        "NSF102", f"{rel}:{node.lineno}",
                        f"{what} inside hot body {name!r}: a device->host "
                        "copy or sync per call; keep stage bodies on the "
                        "device"))
    return out


def _derives_seed(fn: ast.AST) -> bool:
    """A ``stream_seed(...)`` call, or a ``SeedSequence([...])`` over two or
    more words, in fn (the counterparts of ``fold_in``)."""
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        last = _attr_chain(sub.func)[-1:]
        if last == ["stream_seed"]:
            return True
        if last == ["SeedSequence"] and sub.args \
                and isinstance(sub.args[0], (ast.List, ast.Tuple)) \
                and len(sub.args[0].elts) >= 2:
            return True
    return False


def _check_rng_derivation(tree: ast.AST, rel: str) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        seed_lines = [
            sub.lineno for sub in ast.walk(node)
            if isinstance(sub, ast.Call)
            and _attr_chain(sub.func)[-1:] == ["manual_seed"]]
        if seed_lines and not _derives_seed(node):
            out.append(finding(
                "NSF103", f"{rel}:{seed_lines[0]}",
                f"{node.name!r} seeds a generator but derives no seed "
                "(stream_seed or SeedSequence([seed, ...])): per-request "
                "streams must come from (seed, uid, index)"))
    return out


def _is_protocol(cls: ast.ClassDef) -> bool:
    return any(_attr_chain(b)[-1:] == ["Protocol"] for b in cls.bases)


def _stamps_dispatch_t(fn: ast.FunctionDef) -> int | None:
    """Line of the first ``<x>.dispatch_t = ...`` store in fn, else None."""
    lines = []
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "dispatch_t":
                lines.append(node.lineno)
    return min(lines) if lines else None


def _check_dispatch_stamp(tree: ast.AST, rel: str) -> list[Finding]:
    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) or _is_protocol(cls):
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        submit = methods.get("submit")
        if submit is None:
            continue
        body = [n for n in submit.body
                if not (isinstance(n, ast.Expr)
                        and isinstance(n.value, ast.Constant))]
        if not body:
            continue   # stub body (shouldn't happen outside Protocols)

        stampers = {m for m, f in methods.items()
                    if _stamps_dispatch_t(f) is not None}
        # one transitive hop: helpers that call a stamping helper
        stampers |= {
            m for m, f in methods.items()
            if any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and isinstance(n.func.value, ast.Name)
                   and n.func.value.id == "self"
                   and n.func.attr in stampers
                   for n in ast.walk(f))}

        stamp_line = _stamps_dispatch_t(submit)
        delegate_line = None
        block_line = None
        for node in ast.walk(submit):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr == "submit" and not (
                        isinstance(f.value, ast.Name)
                        and f.value.id == "self"):
                    delegate_line = min(delegate_line or node.lineno,
                                        node.lineno)
                if isinstance(f.value, ast.Name) and f.value.id == "self" \
                        and f.attr in stampers:
                    stamp_line = min(stamp_line or node.lineno, node.lineno)
                if f.attr in _BLOCKING_ATTRS:
                    block_line = min(block_line or node.lineno, node.lineno)

        where = f"{rel}:{submit.lineno}"
        if stamp_line is None and delegate_line is None:
            out.append(finding(
                "NSF104", where,
                f"{cls.name}.submit never stamps dispatch_t (directly, via "
                "a self-method, or by delegating to another .submit) — "
                "latency attribution needs the dispatch timestamp"))
        elif block_line is not None and stamp_line is not None \
                and block_line < stamp_line:
            out.append(finding(
                "NSF104", f"{rel}:{block_line}",
                f"{cls.name}.submit blocks before stamping dispatch_t "
                f"(block at line {block_line}, stamp at {stamp_line}) — "
                "the wait would be charged to queueing, not service"))
    return out


def _container_name(node: ast.expr) -> str | None:
    """The container identifier of an append target: ``self._queue`` ->
    ``_queue``; ``pending[model]`` -> ``pending``; ``q`` -> ``q``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_queue_name(name: str | None) -> bool:
    if name is None:
        return False
    low = name.lower()
    return name in _QUEUE_NAMES_EXACT or \
        any(h in low for h in _QUEUE_NAME_HINTS)


def _scope_nodes(fn: ast.AST):
    """Nodes of ``fn``'s own scope (nested function bodies excluded — a
    bound check inside a closure doesn't dominate the outer append)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _has_bound_check(fn: ast.AST) -> bool:
    """A Compare in fn's scope involving len(...) or a bound-named value."""
    for node in _scope_nodes(fn):
        if not isinstance(node, ast.Compare):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Name) and sub.func.id == "len":
                return True
            name = sub.attr if isinstance(sub, ast.Attribute) else \
                sub.id if isinstance(sub, ast.Name) else None
            if name and any(h in name.lower() for h in _BOUND_NAME_HINTS):
                return True
    return False


def _check_overload_hygiene(tree: ast.AST, rel: str) -> list[Finding]:
    out = []
    # (a) queue appends must be dominated by a bound check
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        appends = [
            node for node in _scope_nodes(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _APPEND_ATTRS
            and _is_queue_name(_container_name(node.func.value))]
        if appends and not _has_bound_check(fn):
            for node in appends:
                out.append(finding(
                    "NSF105", f"{rel}:{node.lineno}",
                    f"queue append ({_container_name(node.func.value)}."
                    f"{node.func.attr}) in {fn.name!r} with no bound "
                    "check in the same function — unbounded queue growth "
                    "under overload; compare len()/a cap before growing"))
    # (b) control-plane modules must not reference time at all
    if os.path.basename(rel) in _CONTROL_PLANE_FILES:
        for node in ast.walk(tree):
            bad_line = None
            what = None
            if isinstance(node, ast.Import) and \
                    any(a.name.split(".")[0] == "time" for a in node.names):
                bad_line, what = node.lineno, "import time"
            elif isinstance(node, ast.ImportFrom) and \
                    (node.module or "").split(".")[0] == "time":
                bad_line, what = node.lineno, "from time import ..."
            elif isinstance(node, ast.Attribute):
                chain = _attr_chain(node)
                if len(chain) == 2 and chain[0] == "time" \
                        and chain[1] in _CLOCK_ATTRS:
                    bad_line, what = node.lineno, f"time.{chain[1]} reference"
            if bad_line is not None:
                out.append(finding(
                    "NSF105", f"{rel}:{bad_line}",
                    f"{what} in a control-plane module — policy must be "
                    "deterministic under the virtual clock: take explicit "
                    "clock/now parameters (no time.* even as a default)"))
    return out


_RULE_CHECKS = {
    "NSF101": _check_clock_calls,
    "NSF102": _check_host_materialization,
    "NSF103": _check_rng_derivation,
    "NSF104": _check_dispatch_stamp,
    "NSF105": _check_overload_hygiene,
}


def rules_for_path(path: str) -> tuple[str, ...]:
    """Serve sources get the full serving rule set; the rest of the tree
    gets only the scope-safe rules."""
    norm = path.replace(os.sep, "/")
    if "/serve/" in norm or norm.endswith("/serve"):
        return SERVE_RULES
    return GENERAL_RULES


def lint_file(path: str, rules: tuple[str, ...] | None = None,
              root: str | None = None) -> list[Finding]:
    """Lint one source file; memoized on (path, mtime, rules)."""
    rules = tuple(rules if rules is not None else rules_for_path(path))
    mtime = os.path.getmtime(path)
    hit = _CACHE.get(path)
    if hit is not None and hit[0] == mtime and hit[1] == rules:
        return list(hit[2])
    rel = os.path.relpath(path, root) if root else path
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out: list[Finding] = []
    for rule in rules:
        out.extend(_RULE_CHECKS[rule](tree, rel))
    _CACHE[path] = (mtime, rules, tuple(out))
    return out


def lint_tree(root: str) -> AnalysisReport:
    """Lint every ``*.py`` under ``root`` (rule set chosen per path)."""
    report = AnalysisReport()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            report.extend(lint_file(path, root=root))
            report.covered("lint_files")
    return report
