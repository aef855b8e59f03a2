"""Control-flow helpers for the SPMD / hot-path rules (the port's copy of
:mod:`fluxmpi_tpu.analysis.flow`; the rank spellings of the port added).

Three analyses, all deliberately conservative (lint-grade, not
verifier-grade — when unsure, classify as "unrelated" so the rules stay
quiet rather than noisy):

- **Rank conditionality** (:func:`rank_condition`): does an ``if`` test
  depend on *which process* is running — ``dist.get_rank()``,
  ``process_index()``, ``fm.local_rank()``/``runtime.local_rank()``,
  ``is_lead()``, a mesh coordinate (``mesh.coords(...)``,
  ``mesh.block_index(...)``, ``mesh.my_rank()``) — directly or through a
  local bool (``lead = dist.get_rank() == 0``)? World-size tests
  (``process_count()``, ``get_world_size()``) are NOT rank-conditional:
  every process evaluates them identically, so they cannot diverge the
  collective sequence.
- **Guard classification** (:func:`classify_guard`): is a condition the
  instrumentation fast-guard — a call ending in ``_instrumentation_on``,
  an ``.enabled`` attribute read, or a local bool resolved from one
  (``instrumented = _instrumentation_on()``, ``gp_on = gp.enabled``)?
  Conditions classify as GUARD_ON (true ⇒ instrumentation enabled),
  GUARD_OFF (true ⇒ disabled), or OTHER.
- **Termination** (:func:`terminates`): does a block never fall through
  (trailing return/raise/continue/break, an if whose branches both
  terminate, or a ``while True`` with no break)? Used for the early-exit
  guard idiom (``if not instrumented: return fast_path()``) and for the
  divergent-early-exit half of the SPMD rule.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

GUARD_ON = "on"
GUARD_OFF = "off"
OTHER = "other"

# Terminal callable names whose result depends on the calling process's
# rank. process_count / device_count are absent on purpose (world-size
# conditions are SPMD-consistent).
RANK_FUNCS = frozenset(
    {
        "process_index",
        "process_index_or_zero",
        "local_rank",
        "is_distributed",
        "is_lead",
        "_is_lead",
        # torch.distributed and the port's mesh coordinates.
        "get_rank",
        "my_rank",
        "coords",
        "block_index",
    }
)

# Terminal callable names of the instrumentation fast-guard family.
GUARD_FUNCS = frozenset({"_instrumentation_on", "instrumentation_on"})


def terminal_name(func: ast.expr) -> str | None:
    """The rightmost name of a call target: ``f`` for ``f(...)``,
    ``meth`` for ``a.b.meth(...)``; None for anything fancier."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def value_root(func: ast.expr) -> str | None:
    """The leftmost name of an attribute chain: ``comm`` for
    ``comm.allreduce``; None for bare names / computed values."""
    node = func
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def walk_no_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested function/class
    definitions (they get their own analysis pass)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
            ):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# Rank conditionality
# ---------------------------------------------------------------------------


def _mentions_rank(expr: ast.expr, rank_names: set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            name = terminal_name(node.func)
            if name in RANK_FUNCS:
                return True
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in rank_names:
                return True
    return False


def rank_derived_names(fn: ast.AST) -> set[str]:
    """Local names assigned from a rank-dependent expression
    (``lead = dist.get_rank() == 0``), one transitive pass."""
    names: set[str] = set()
    for _ in range(2):  # two passes: catch one level of chaining
        for node in walk_no_nested_functions(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if isinstance(target, ast.Name) and _mentions_rank(
                    node.value, names
                ):
                    names.add(target.id)
    return names


def rank_condition(test: ast.expr, rank_names: set[str]) -> bool:
    """True when an ``if`` test depends on the process rank."""
    return _mentions_rank(test, rank_names)


# ---------------------------------------------------------------------------
# Guard classification
# ---------------------------------------------------------------------------


def _is_guard_expr(expr: ast.expr, guard_names: dict[str, str]) -> bool:
    """A positive instrumentation-guard expression (no negation).
    ``guard_names`` maps derived local names to their polarity; only
    GUARD_ON names count here — an ``off = not reg.enabled`` local is
    truthy precisely when instrumentation is DISABLED."""
    if isinstance(expr, ast.Call):
        name = terminal_name(expr.func)
        if name in GUARD_FUNCS:
            return True
        return False
    if isinstance(expr, ast.Attribute) and expr.attr == "enabled":
        return True
    if isinstance(expr, ast.Name):
        return guard_names.get(expr.id) == GUARD_ON
    return False


def _is_none_const(expr: ast.expr) -> bool:
    return isinstance(expr, ast.Constant) and expr.value is None


def guard_derived_names(fn: ast.AST) -> dict[str, str]:
    """Local names resolved from guard expressions, with POLARITY:
    ``instrumented = _instrumentation_on()`` / ``gp_on = gp.enabled`` →
    GUARD_ON (truthy ⇒ instrumentation enabled);
    ``off = not reg.enabled`` → GUARD_OFF (truthy ⇒ disabled);
    ``depth = g.gauge(...) if reg.enabled else None`` → GUARD_ON (the
    value is non-None exactly when enabled). Two passes catch one level
    of chaining."""
    names: dict[str, str] = {}
    for _ in range(2):
        for node in walk_no_nested_functions(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if not isinstance(target, ast.Name):
                    continue
                cls = classify_guard(node.value, names)
                if cls in (GUARD_ON, GUARD_OFF):
                    names[target.id] = cls
    return names


def classify_guard(test: ast.expr, guard_names: dict[str, str]) -> str:
    """GUARD_ON / GUARD_OFF / OTHER for an ``if``/``while`` test, an
    ``IfExp`` condition, or an assigned value whose truthiness tracks
    the guard (semantics in the module docstring)."""
    if _is_guard_expr(test, guard_names):
        return GUARD_ON
    if isinstance(test, ast.Name):
        return guard_names.get(test.id, OTHER)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = classify_guard(test.operand, guard_names)
        if inner == GUARD_ON:
            return GUARD_OFF
        if inner == GUARD_OFF:
            return GUARD_ON
        return OTHER
    if isinstance(test, ast.IfExp):
        # `x if guard else None`: non-None (truthy-ish) exactly when the
        # guard is — the resolved-handle idiom. Symmetric for OFF.
        tcls = classify_guard(test.test, guard_names)
        if tcls == GUARD_ON and _is_none_const(test.orelse):
            return GUARD_ON
        if tcls == GUARD_OFF and _is_none_const(test.orelse):
            return GUARD_OFF
        if tcls == GUARD_ON and _is_none_const(test.body):
            return GUARD_OFF
        if tcls == GUARD_OFF and _is_none_const(test.body):
            return GUARD_ON
        return OTHER
    if isinstance(test, ast.BoolOp):
        parts = [classify_guard(v, guard_names) for v in test.values]
        if isinstance(test.op, ast.And):
            # `guard and x` runs only with the guard on; `not g and not h`
            # only with both off.
            if GUARD_ON in parts:
                return GUARD_ON
            if parts and all(p == GUARD_OFF for p in parts):
                return GUARD_OFF
            if GUARD_OFF in parts:
                return GUARD_OFF
            return OTHER
        # Or: truth implies nothing unless every arm agrees.
        if parts and all(p == parts[0] for p in parts):
            return parts[0]
        return OTHER
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        left_cls = OTHER
        if _is_guard_expr(test.left, guard_names):
            left_cls = GUARD_ON
        elif isinstance(test.left, ast.Name):
            left_cls = guard_names.get(test.left.id, OTHER)
        if left_cls != OTHER and _is_none_const(test.comparators[0]):
            flip = left_cls == GUARD_OFF
            if isinstance(test.ops[0], ast.IsNot):
                return GUARD_OFF if flip else GUARD_ON
            if isinstance(test.ops[0], ast.Is):
                return GUARD_ON if flip else GUARD_OFF
    return OTHER


# ---------------------------------------------------------------------------
# Termination
# ---------------------------------------------------------------------------


def _while_true_no_break(node: ast.While) -> bool:
    if not (isinstance(node.test, ast.Constant) and node.test.value is True):
        return False
    for child in walk_no_nested_functions(node):
        if child is node:
            continue
        if isinstance(child, (ast.While, ast.For)):
            # breaks inside an inner loop bind to that loop — prune by
            # not descending (walk_no_nested_functions cannot prune
            # mid-walk, so re-walk with an explicit check)
            continue
        if isinstance(child, ast.Break) and _innermost_loop_is(node, child):
            return False
    return True


def _innermost_loop_is(loop: ast.AST, brk: ast.Break) -> bool:
    # Structural check: is `brk` inside `loop` but not inside a nested
    # loop of it? Walk loop's body tracking loop nesting.
    def scan(stmts: Iterable[ast.stmt], depth: int) -> bool | None:
        for stmt in stmts:
            if stmt is brk:
                return depth == 0
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    d = depth + (
                        1 if isinstance(stmt, (ast.While, ast.For)) else 0
                    )
                    found = scan(sub, d)
                    if found is not None:
                        return found
            handlers = getattr(stmt, "handlers", None)
            if handlers:
                for h in handlers:
                    found = scan(h.body, depth)
                    if found is not None:
                        return found
        return None

    return bool(scan(loop.body, 0))


def terminates(block: list[ast.stmt]) -> bool:
    """Does this block never fall through to the statement after it?"""
    if not block:
        return False
    last = block[-1]
    if isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
        return True
    if isinstance(last, ast.If):
        return terminates(last.body) and terminates(last.orelse)
    if isinstance(last, ast.While):
        return _while_true_no_break(last)
    if isinstance(last, ast.Try):
        final_ok = terminates(last.finalbody) if last.finalbody else False
        if final_ok:
            return True
        body_ok = terminates(last.body)
        handlers_ok = all(terminates(h.body) for h in last.handlers)
        return body_ok and handlers_ok and bool(last.handlers)
    if isinstance(last, ast.With):
        return terminates(last.body)
    return False
