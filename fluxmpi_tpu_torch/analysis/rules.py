"""The port's fluxlint rule set: six of the JAX package's seven rules
(:mod:`fluxmpi_tpu.analysis.rules`), over the port's idioms and
registries.

Each rule's docstring names the contract it enforces;
docs/torch_static_analysis.md carries the catalogue. The seventh JAX
rule, ``jax-compat-drift``, has no counterpart: it guards the one seam
(``fluxmpi_tpu/parallel/_compat.py``) through which the JAX package
spells jax APIs that drifted across jax versions, and the port imports
no jax and has no such seam (``tests/test_torch_isolation.py`` guards
what the port must not import).
"""

from __future__ import annotations

import ast
import difflib
import re
from typing import Any, Iterator

from .core import Finding, ModuleSource, Rule
from .flow import (
    GUARD_OFF,
    GUARD_ON,
    classify_guard,
    guard_derived_names,
    rank_condition,
    rank_derived_names,
    terminal_name,
    terminates,
    value_root,
    walk_no_nested_functions,
)

# ---------------------------------------------------------------------------
# Collective-call matching (shared by the SPMD rule)
# ---------------------------------------------------------------------------

# comm.<attr> / _comm.<attr> / fm.<attr> — the port's eager collective
# surface (fluxmpi_tpu_torch/comm.py, re-exported by the package).
_COMM_ATTRS = frozenset(
    {
        "allreduce",
        "bcast",
        "reduce",
        "iallreduce",
        "ibcast",
        "barrier",
        "host_allreduce",
        "host_allgather",
        "host_bcast",
        "unshard_ranks",
        "synchronize",
    }
)
_COMM_ROOTS = ("comm", "_comm", "fm")

# dist.<attr> / torch.distributed.<attr> / dfn.<attr> — the
# torch.distributed rendezvous the port calls; new_group too, which every
# rank must call in the same order.
_DIST_ATTRS = frozenset(
    {
        "all_reduce",
        "broadcast",
        "all_gather",
        "all_gather_object",
        "all_gather_into_tensor",
        "reduce_scatter_tensor",
        "all_to_all_single",
        "batch_isend_irecv",
        "barrier",
        "new_group",
        "broadcast_object_list",
    }
)
_DIST_ROOTS = ("dist", "torch", "dfn")

# <anything>.<attr> — names specific enough to match on any receiver
# (checkpoint module objects, ...).
_ANY_ATTRS = frozenset(
    {
        "host_allreduce",
        "host_allgather",
        "host_bcast",
        "save_checkpoint",
        "restore_checkpoint",
    }
)

# Bare names (from-imports / module-local helpers). `reduce` and
# `broadcast` are absent on purpose: bare `reduce` is functools
# territory, bare `broadcast` numpy's.
_BARE_NAMES = _ANY_ATTRS | (_DIST_ATTRS - {"broadcast", "barrier"}) | frozenset(
    {
        "allreduce",
        "bcast",
        "iallreduce",
        "ibcast",
        "barrier",
        "synchronize",
        "unshard_ranks",
        "_process_barrier",
    }
)


def _collective_call(node: ast.Call) -> str | None:
    """The collective's name when ``node`` is a cross-process
    rendezvous every rank must reach; None otherwise."""
    func = node.func
    if isinstance(func, ast.Attribute):
        root = value_root(func)
        if func.attr in _COMM_ATTRS and root in _COMM_ROOTS:
            return func.attr
        if func.attr in _DIST_ATTRS and root in _DIST_ROOTS:
            return func.attr
        if func.attr in _ANY_ATTRS:
            return func.attr
        return None
    if isinstance(func, ast.Name) and func.id in _BARE_NAMES:
        return func.id
    return None


def _functions_with_qualnames(
    tree: ast.AST,
) -> Iterator[tuple[str, ast.AST]]:
    """Yield every function definition with its dotted qualname
    (``Class.method`` / ``outer.inner``)."""

    def visit(node: ast.AST, prefix: str) -> Iterator[tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from visit(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


class SpmdDivergentCollective(Rule):
    """A collective reachable by only a subset of ranks is a hang, not a
    bug report: the excluded ranks never join the rendezvous and the
    world wedges inside NCCL or gloo (lead-only code stranding its peers
    at a barrier).

    Two shapes are flagged, per function:

    1. a collective call nested (at any depth, nested defs excluded)
       under a rank-conditional branch — ``if dist.get_rank() == 0:``
       and friends, including through a local bool
       (``lead = dist.get_rank() == 0``);
    2. a rank-conditional branch that *exits* (return/raise) followed —
       later in the same block — by a collective: the exiting ranks
       never reach it.

    World-size conditions (``process_count() > 1``,
    ``dist.get_world_size() > 1``) are SPMD-consistent and never
    flagged.
    """

    id = "spmd-divergent-collective"
    severity = "error"
    description = "collective reachable only under a rank-conditional branch"

    def check(self, module: ModuleSource, ctx: Any) -> Iterator[Finding]:
        for qual, fn in _functions_with_qualnames(module.tree):
            rank_names = rank_derived_names(fn)
            yield from self._scan_block(module, qual, fn.body, rank_names)
            yield from self._scan_expressions(module, qual, fn, rank_names)

    def _scan_expressions(
        self,
        module: ModuleSource,
        qual: str,
        fn: ast.AST,
        rank_names: set[str],
    ) -> Iterator[Finding]:
        """Rank-conditional *expressions* that gate a collective: the
        short-circuit form (``rank_ok and comm.allreduce(x)`` — the
        collective runs only where the left operand is true) and the
        conditional form (``comm.barrier() if lead else None``)."""
        for node in walk_no_nested_functions(fn):
            if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
                seen_rank = False
                for value in node.values:
                    if seen_rank:
                        for call in self._collectives_in_expr(value):
                            name = _collective_call(call)
                            yield self.finding(
                                module.path,
                                call,
                                f"collective {name}() in {qual} is "
                                f"short-circuited by a rank-conditional "
                                f"operand (line {node.lineno}): only a "
                                f"subset of ranks evaluates it — the rest "
                                f"never join the rendezvous",
                                f"{qual}:{name}:shortcircuit",
                            )
                    if rank_condition(value, rank_names):
                        seen_rank = True
            elif isinstance(node, ast.IfExp) and rank_condition(
                node.test, rank_names
            ):
                for arm in (node.body, node.orelse):
                    for call in self._collectives_in_expr(arm):
                        name = _collective_call(call)
                        yield self.finding(
                            module.path,
                            call,
                            f"collective {name}() in {qual} sits in a "
                            f"rank-conditional conditional expression "
                            f"(line {node.lineno}) — only a subset of "
                            f"ranks evaluates it",
                            f"{qual}:{name}:shortcircuit",
                        )

    def _collectives_in_expr(self, expr: ast.expr) -> Iterator[ast.Call]:
        for node in walk_no_nested_functions(expr):
            if isinstance(node, ast.Call) and _collective_call(node):
                yield node

    def _collectives_in(self, stmts: list[ast.stmt]) -> Iterator[ast.Call]:
        for stmt in stmts:
            for node in walk_no_nested_functions(stmt):
                if isinstance(node, ast.Call):
                    if _collective_call(node) is not None:
                        yield node

    def _scan_block(
        self,
        module: ModuleSource,
        qual: str,
        block: list[ast.stmt],
        rank_names: set[str],
    ) -> Iterator[Finding]:
        diverged_at: ast.If | None = None
        for stmt in block:
            if isinstance(stmt, ast.If) and rank_condition(
                stmt.test, rank_names
            ):
                for call in self._collectives_in(stmt.body + stmt.orelse):
                    name = _collective_call(call)
                    yield self.finding(
                        module.path,
                        call,
                        f"collective {name}() inside a rank-conditional "
                        f"branch (condition at line {stmt.lineno}) in "
                        f"{qual}: ranks that skip the branch never join "
                        f"the rendezvous — hoist the collective out, or "
                        f"make the condition SPMD-consistent",
                        f"{qual}:{name}:branch",
                    )
                body_exits = terminates(stmt.body) and not terminates(
                    stmt.orelse or []
                )
                orelse_exits = bool(stmt.orelse) and terminates(
                    stmt.orelse
                ) and not terminates(stmt.body)
                if (body_exits or orelse_exits) and diverged_at is None:
                    diverged_at = stmt
                continue
            if diverged_at is not None:
                for call in self._collectives_in([stmt]):
                    name = _collective_call(call)
                    yield self.finding(
                        module.path,
                        call,
                        f"collective {name}() in {qual} is unreachable "
                        f"for ranks that exited at the rank-conditional "
                        f"early return/raise on line "
                        f"{diverged_at.lineno} — the remaining ranks "
                        f"hang at the rendezvous",
                        f"{qual}:{name}:after-exit",
                    )
            # Recurse into compound statements (their inner blocks get
            # their own early-exit tracking).
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub and not isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    if isinstance(stmt, ast.If) and rank_condition(
                        stmt.test, rank_names
                    ):
                        continue  # already reported above
                    yield from self._scan_block(
                        module, qual, sub, rank_names
                    )
            for handler in getattr(stmt, "handlers", []) or []:
                yield from self._scan_block(
                    module, qual, handler.body, rank_names
                )


# ---------------------------------------------------------------------------
# Rule 2: unguarded hot-path instrumentation
# ---------------------------------------------------------------------------

# (path suffix, dotted qualname, scope) — scope "function" scans the
# whole body; "loops" scans only loop bodies (drivers like train_loop
# legitimately time at run/flush granularity outside the dispatch loop).
# The port's counterpart of each JAX hot function: comm.py's
# _instrumented and _start for _run_collective, barrier, train_loop's
# loops, and the loader's batch iterators (DistributedDataLoader.__iter__
# for _timed_batches, _batches for _iter_batches).
DEFAULT_HOT_FUNCTIONS: tuple[tuple[str, str, str], ...] = (
    ("fluxmpi_tpu_torch/comm.py", "_instrumented", "function"),
    ("fluxmpi_tpu_torch/comm.py", "_start", "function"),
    ("fluxmpi_tpu_torch/comm.py", "barrier", "function"),
    ("fluxmpi_tpu_torch/parallel/loop.py", "train_loop", "loops"),
    ("fluxmpi_tpu_torch/data.py", "DistributedDataContainer.__iter__", "function"),
    ("fluxmpi_tpu_torch/data.py", "DistributedDataLoader.__iter__", "function"),
    ("fluxmpi_tpu_torch/data.py", "DistributedDataLoader._batches", "function"),
)

_TIME_ATTRS = frozenset(
    {"perf_counter", "time", "monotonic", "process_time", "thread_time"}
)

# Attribute-call names that resolve registry handles, record into them,
# or talk to the tracer/flight recorder. `get_tracer`/`_flight_recorder`
# are deliberately absent: fetching the object to READ `.enabled` is how
# the guard itself is resolved; recording through it trips `.instant` /
# `.add_complete_event` / the comm helpers instead.
_INSTR_ATTRS = frozenset(
    {
        "counter",
        "gauge",
        "histogram",
        "observe",
        "instant",
        "add_complete_event",
        "segment",
    }
)

# Module-local instrumentation helpers (comm.py's flight/trace plumbing).
_INSTR_EXTRA = frozenset({"_begin_op", "_record_op", "_abort_op"})


def _instr_call(node: ast.Call) -> str | None:
    func = node.func
    name = terminal_name(func)
    if name is None:
        return None
    if isinstance(func, ast.Attribute):
        if name in _TIME_ATTRS and value_root(func) == "time":
            return f"time.{name}"
        if name in _INSTR_ATTRS or name in _INSTR_EXTRA:
            return name
        return None
    if name == "perf_counter" or name in _INSTR_EXTRA:
        return name
    if name in ("add_complete_event", "instant"):
        return name
    return None


class UnguardedHotPathInstrumentation(Rule):
    """The zero-cost-when-off contract: with telemetry, tracing, and the
    flight recorder all disabled, the designated hot paths (``comm.py``'s
    ``_instrumented`` and ``_start``, ``barrier``, the ``train_loop``
    dispatch loop, the loader's batch iterators) perform **no**
    ``perf_counter`` reads, no
    registry-handle lookups, and no tracer calls. Every instrumentation
    call there must be dominated by the fast-guard —
    ``_instrumentation_on()``, an ``.enabled`` read, or a local bool
    resolved from one (``instrumented`` / ``gp_on``) — either by
    enclosing ``if guard:`` or by an early ``if not guard: return``.
    """

    id = "unguarded-hot-path-instrumentation"
    severity = "error"
    description = "instrumentation call on a hot path without the fast-guard"

    def __init__(
        self,
        hot_functions: tuple[tuple[str, str, str], ...] = DEFAULT_HOT_FUNCTIONS,
    ):
        self.hot_functions = hot_functions

    def check(self, module: ModuleSource, ctx: Any) -> Iterator[Finding]:
        hot = {
            qual: scope
            for suffix, qual, scope in self.hot_functions
            if module.path.endswith(suffix)
        }
        if not hot:
            return
        for qual, fn in _functions_with_qualnames(module.tree):
            scope = hot.get(qual)
            if scope is None:
                continue
            guard_names = guard_derived_names(fn)
            if scope == "function":
                yield from self._scan_block(
                    module, qual, fn.body, guard_names, False
                )
            else:
                # loops: only the OUTERMOST For/While bodies — each is
                # scanned with full recursion so inner loops keep the
                # guard context of their enclosing branches (scanning
                # every loop independently would both drop that context
                # and double-report nested violations).
                for node in self._outermost_loops(fn.body):
                    guarded = isinstance(
                        node, ast.While
                    ) and classify_guard(node.test, guard_names) == GUARD_ON
                    yield from self._scan_block(
                        module, qual, node.body, guard_names, guarded
                    )

    def _outermost_loops(
        self, block: list[ast.stmt]
    ) -> Iterator[ast.For | ast.While]:
        for stmt in block:
            if isinstance(stmt, (ast.For, ast.While)):
                yield stmt  # do not descend: inner loops ride along
                continue
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    yield from self._outermost_loops(sub)
            for handler in getattr(stmt, "handlers", []) or []:
                yield from self._outermost_loops(handler.body)

    # -- statement walk with guard state --------------------------------

    def _scan_block(
        self,
        module: ModuleSource,
        qual: str,
        block: list[ast.stmt],
        guard_names: dict[str, str],
        guarded: bool,
    ) -> Iterator[Finding]:
        # _scan_expr reads the guard names from this slot so the
        # expression walk keeps a flat signature.
        self._guard_names = guard_names
        for stmt in block:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(stmt, ast.If):
                cls = classify_guard(stmt.test, guard_names)
                yield from self._scan_expr(
                    module, qual, stmt.test, guarded
                )
                yield from self._scan_block(
                    module, qual, stmt.body, guard_names,
                    guarded or cls == GUARD_ON,
                )
                yield from self._scan_block(
                    module, qual, stmt.orelse, guard_names,
                    guarded or cls == GUARD_OFF,
                )
                if cls == GUARD_OFF and terminates(stmt.body):
                    guarded = True
                if cls == GUARD_ON and stmt.orelse and terminates(stmt.orelse):
                    guarded = True
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                inner = guarded
                if isinstance(stmt, ast.While):
                    yield from self._scan_expr(
                        module, qual, stmt.test, guarded
                    )
                    if classify_guard(stmt.test, guard_names) == GUARD_ON:
                        inner = True
                else:
                    yield from self._scan_expr(
                        module, qual, stmt.iter, guarded
                    )
                yield from self._scan_block(
                    module, qual, stmt.body, guard_names, inner
                )
                yield from self._scan_block(
                    module, qual, stmt.orelse, guard_names, guarded
                )
                continue
            if isinstance(stmt, ast.Try):
                yield from self._scan_block(
                    module, qual, stmt.body, guard_names, guarded
                )
                for handler in stmt.handlers:
                    yield from self._scan_block(
                        module, qual, handler.body, guard_names, guarded
                    )
                yield from self._scan_block(
                    module, qual, stmt.orelse, guard_names, guarded
                )
                yield from self._scan_block(
                    module, qual, stmt.finalbody, guard_names, guarded
                )
                continue
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    yield from self._scan_expr(
                        module, qual, item.context_expr, guarded
                    )
                yield from self._scan_block(
                    module, qual, stmt.body, guard_names, guarded
                )
                continue
            # Plain statement: scan its expressions.
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    yield from self._scan_expr(module, qual, child, guarded)

    # -- expression walk honoring IfExp / short-circuit guards -----------

    def _scan_expr(
        self, module: ModuleSource, qual: str, expr: ast.expr, guarded: bool
    ) -> Iterator[Finding]:
        guard_names = self._guard_names
        if isinstance(expr, ast.IfExp):
            cls = classify_guard(expr.test, guard_names)
            yield from self._scan_expr(module, qual, expr.test, guarded)
            yield from self._scan_expr(
                module, qual, expr.body, guarded or cls == GUARD_ON
            )
            yield from self._scan_expr(
                module, qual, expr.orelse, guarded or cls == GUARD_OFF
            )
            return
        if isinstance(expr, ast.BoolOp) and isinstance(expr.op, ast.And):
            g = guarded
            for v in expr.values:
                yield from self._scan_expr(module, qual, v, g)
                if classify_guard(v, guard_names) == GUARD_ON:
                    g = True
            return
        if isinstance(expr, ast.Call):
            name = _instr_call(expr)
            if name is not None and not guarded:
                yield self.finding(
                    module.path,
                    expr,
                    f"{name}() in hot path {qual} is not dominated by the "
                    f"instrumentation fast-guard (_instrumentation_on() / "
                    f"a resolved .enabled bool) — the fully-off path must "
                    f"pay no timing or registry work",
                    f"{qual}:{name}",
                )
            for child in ast.iter_child_nodes(expr):
                if isinstance(child, (ast.expr, ast.keyword)):
                    sub = child.value if isinstance(child, ast.keyword) else child
                    yield from self._scan_expr(module, qual, sub, guarded)
            return
        if isinstance(expr, ast.Lambda):
            return
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                yield from self._scan_expr(module, qual, child, guarded)

    _guard_names: dict[str, str] = {}


# ---------------------------------------------------------------------------
# Rule 3: unknown metric name
# ---------------------------------------------------------------------------


def _const_prefix(expr: ast.expr) -> str | None:
    """Constant leading prefix of a dynamic string build (``"a." + x``,
    f-string with a literal head); None when nothing constant leads."""
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = expr.left
        if isinstance(left, ast.Constant) and isinstance(left.value, str):
            return left.value
        return _const_prefix(left)
    if isinstance(expr, ast.JoinedStr) and expr.values:
        head = expr.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value
    return None


def _docstring_constants(tree: ast.AST) -> set[int]:
    """ids of the Constant nodes that are module/class/function
    docstrings — prose naming a metric is documentation, not a read."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                out.add(id(body[0].value))
    return out


class UnknownMetricName(Rule):
    """Metric-name literals handed to ``counter()``/``gauge()``/
    ``histogram()`` must come from ``schema.KNOWN_METRIC_NAMES`` — the
    names are the JSONL contract ``check_metrics_schema.py`` validates,
    and a producer-side typo (the drift class the closed ``fault.`` /
    ``checkpoint.`` / ``goodput.`` / ``anomaly.`` namespaces were
    created to stop) otherwise only surfaces when a consumer's dashboard
    goes blank. ``instant()`` trace-event names check against the same
    schema constants (``PREEMPTION_EVENT``, the ``anomaly.`` prefix).
    Dynamic names are skipped unless their constant prefix sits in a
    closed namespace with no known name under it.

    **Consumer side**: scripts under ``scripts/`` read metric keys as
    PLAIN string literals — no instrument call to hook —
    so a key that drifts from the schema there fails only at runtime,
    as a silently blank panel. Any string literal in a ``scripts/``
    module that is *shaped* like a metric name (dotted lowercase) and
    whose first segment names a known metric family must itself be a
    schema-known name or a family prefix (the ``"monitor."``
    ``startswith`` idiom). Dotted strings outside the known families
    (module paths, file suffixes) are ignored, as are docstrings."""

    id = "unknown-metric-name"
    severity = "error"
    description = "metric/trace name not in telemetry/schema.py"

    def check(self, module: ModuleSource, ctx: Any) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute) or not node.args:
                continue
            if func.attr in ("counter", "gauge", "histogram"):
                yield from self._check_metric(module, node, ctx)
            elif func.attr == "instant":
                yield from self._check_instant(module, node, ctx)
        if module.path.startswith("scripts/"):
            yield from self._check_consumer_literals(module, ctx)

    _METRIC_SHAPE_RE = re.compile(
        r"[a-z][a-z0-9_]*(?:\.[a-z0-9_]+)+\.?"
    )

    def _check_consumer_literals(
        self, module: ModuleSource, ctx: Any
    ) -> Iterator[Finding]:
        known = ctx.known_metric_names
        allowed = set(known) | {ctx.preemption_event}
        families = {name.split(".", 1)[0] + "." for name in known}
        docstrings = _docstring_constants(module.tree)
        seen: set[str] = set()
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
            ):
                continue
            if id(node) in docstrings:
                continue
            text = node.value
            if not self._METRIC_SHAPE_RE.fullmatch(text):
                continue
            if text in allowed or text.startswith(ctx.anomaly_event_prefix):
                continue
            if text.split(".", 1)[0] + "." not in families:
                continue  # dotted, but not a metric-family string
            if text.endswith("."):
                # Prefix reads ('monitor.', used with startswith) are
                # fine when some known name lives under the prefix; a
                # family-shaped prefix nothing lives under (a
                # trailing-dot typo like 'train.loss.', a sub-namespace
                # that was renamed away) is the same blank-panel drift
                # as a full-name typo.
                if any(k.startswith(text) for k in allowed):
                    continue
            key = text if not text.endswith(".") else f"prefix:{text}"
            if key in seen:
                continue
            seen.add(key)
            close = difflib.get_close_matches(text, known, n=1)
            hint = f" (did you mean {close[0]!r}?)" if close else ""
            yield self.finding(
                module.path,
                node,
                f"metric key literal {text!r} consumed here is not in "
                f"telemetry/schema.py KNOWN_METRIC_NAMES{hint} — a "
                f"dashboard reading an unknown key goes blank at "
                f"runtime; fix the key or add it to the schema",
                key,
            )

    def _check_metric(
        self, module: ModuleSource, node: ast.Call, ctx: Any
    ) -> Iterator[Finding]:
        arg = node.args[0]
        known = ctx.known_metric_names
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            if name in known:
                return
            close = difflib.get_close_matches(name, known, n=1)
            hint = f" (did you mean {close[0]!r}?)" if close else ""
            yield self.finding(
                module.path,
                node,
                f"metric name {name!r} is not in "
                f"telemetry/schema.py KNOWN_METRIC_NAMES{hint} — add it "
                f"to the schema (and the docs table) or fix the typo",
                name,
            )
            return
        prefix = _const_prefix(arg)
        if prefix and prefix.startswith(tuple(ctx.closed_namespaces)):
            if not any(k.startswith(prefix) for k in known):
                yield self.finding(
                    module.path,
                    node,
                    f"dynamic metric name with constant prefix {prefix!r} "
                    f"sits in a closed namespace but matches no known "
                    f"metric — closed-namespace names must be enumerable "
                    f"in the schema",
                    f"prefix:{prefix}",
                )

    def _check_instant(
        self, module: ModuleSource, node: ast.Call, ctx: Any
    ) -> Iterator[Finding]:
        arg = node.args[0]
        allowed = set(ctx.known_metric_names) | {ctx.preemption_event}
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            if name in allowed or name.startswith(ctx.anomaly_event_prefix):
                return
            yield self.finding(
                module.path,
                node,
                f"trace instant name {name!r} is not a schema-known "
                f"event (KNOWN_METRIC_NAMES, PREEMPTION_EVENT, or the "
                f"{ctx.anomaly_event_prefix!r} family) — the validator "
                f"will reject streams carrying it",
                name,
            )
            return
        prefix = _const_prefix(arg)
        if prefix and not (
            prefix.startswith(ctx.anomaly_event_prefix)
            or any(k.startswith(prefix) for k in allowed)
        ):
            yield self.finding(
                module.path,
                node,
                f"dynamic trace instant with constant prefix {prefix!r} "
                f"matches no schema-known event family",
                f"prefix:{prefix}",
            )


# ---------------------------------------------------------------------------
# Rule 4: unregistered fault site
# ---------------------------------------------------------------------------


class UnregisteredFaultSite(Rule):
    """``faults.check("...")`` literals must name a site registered in
    ``faults.KNOWN_SITES`` — an unregistered site is a chaos hook no
    schedule can reach by its documented name (and, since the registry
    feeds ``install()`` validation, a site string that drifts from the
    registry silently disarms every schedule targeting it). The project
    half of the rule closes the loop the other way: every registered
    site must be exercised by at least one test (substring grep over
    ``tests/`` at lint time), so the registry cannot accrete sites whose
    failure path nothing proves."""

    id = "unregistered-fault-site"
    severity = "error"
    description = "faults.check() site not in the canonical registry"

    def check(self, module: ModuleSource, ctx: Any) -> Iterator[Finding]:
        sites = ctx.known_fault_sites
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            if not (
                isinstance(func, ast.Attribute)
                and func.attr == "check"
                and value_root(func) in ("faults", "_faults")
            ):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                site = arg.value
                if site in sites:
                    continue
                close = difflib.get_close_matches(site, sites, n=1)
                hint = f" (nearest: {close[0]!r})" if close else ""
                yield self.finding(
                    module.path,
                    node,
                    f"fault site {site!r} is not registered in "
                    f"faults.KNOWN_SITES{hint} — register it (and add a "
                    f"test exercising it) or fix the name",
                    site,
                )
            else:
                prefix = _const_prefix(arg)
                if prefix and not any(s.startswith(prefix) for s in sites):
                    yield self.finding(
                        module.path,
                        node,
                        f"dynamic fault site with constant prefix "
                        f"{prefix!r} matches no registered site",
                        f"prefix:{prefix}",
                    )

    def project_check(
        self, modules: list[ModuleSource], ctx: Any
    ) -> Iterator[Finding]:
        if not ctx.tests_corpus:
            return
        for site in sorted(ctx.known_fault_sites):
            if site not in ctx.tests_corpus:
                yield Finding(
                    self.id,
                    self.severity,
                    ctx.faults_path,
                    0,
                    0,
                    f"registered fault site {site!r} is not exercised by "
                    f"any port test under tests/ — a chaos hook nothing proves "
                    f"is dead weight; add a faults.scope() test or drop "
                    f"the site",
                    f"untested:{site}",
                )


# ---------------------------------------------------------------------------
# Rule 5: hand-built mesh / hard-coded axis names
# ---------------------------------------------------------------------------

# Call names whose string arguments ARE mesh axis names: the sharding
# spec constructors.
_AXIS_CONSUMER_NAMES = frozenset({"P", "PartitionSpec"})
# Keyword names that carry an axis name in any call signature.
_AXIS_KEYWORDS = frozenset(
    {
        "axis_name",
        "batch_axis_name",
        "dp_axis",
        "fsdp_axis",
        "tp_axis",
        "pp_axis",
        "sp_axis",
        "ep_axis",
    }
)
# Calls that build a mesh or a process group of one: the port's Mesh, the
# torch DeviceMesh, and dist.new_group.
_MESH_BUILDERS = frozenset({"Mesh", "init_device_mesh"})


class HandBuiltMesh(Rule):
    """The ParallelConfig composition contract (parallel/plan.py): ONE
    mesh, resolved from ONE declarative plan, and its process groups made
    in one place — framework modules must not regrow private meshes or
    process groups, or hard-code mesh-axis-name literals.

    Flagged, for modules under ``fluxmpi_tpu_torch/`` other than the
    files that own the mesh and its groups (``parallel/plan.py``,
    ``parallel/sharding.py``, ``runtime.py``) and the axis-name registry
    (``config.py``):

    1. any ``Mesh(...)`` or ``init_device_mesh(...)`` construction, and
       any ``dist.new_group(...)`` (a group every rank must make in the
       same order: ``Mesh.group`` makes them);
    2. a default-axis-name literal (the ``*_axis_name`` values of
       ``config._DEFAULTS`` — ``"dp"``/``"tp"``/... today) passed to a
       ``PartitionSpec``/``P`` constructor or any ``axis_name=``-family
       keyword. Spell it ``config.DP_AXIS_NAME`` (or resolve it from
       the plan via ``plan_axis_name``) so a renamed axis — or a
       composed plan with different names — reaches every module.
    """

    id = "hand-built-mesh"
    severity = "error"
    description = "hand-built Mesh / process group / axis-name literal outside the plan"

    _ALLOWED = (
        "fluxmpi_tpu_torch/parallel/plan.py",
        "fluxmpi_tpu_torch/parallel/sharding.py",
        "fluxmpi_tpu_torch/runtime.py",
        "fluxmpi_tpu_torch/config.py",
    )

    def check(self, module: ModuleSource, ctx: Any) -> Iterator[Finding]:
        if not module.path.startswith("fluxmpi_tpu_torch/"):
            return
        if module.path in self._ALLOWED:
            return
        axis_literals = getattr(ctx, "axis_name_literals", frozenset())
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = terminal_name(func)
            if name in _MESH_BUILDERS or name == "new_group" and (
                isinstance(func, ast.Name) or value_root(func) in _DIST_ROOTS
            ):
                yield self.finding(
                    module.path,
                    node,
                    f"hand-built {name}(...) in {module.path} — meshes come "
                    f"from ONE ParallelConfig (fluxmpi_tpu_torch.init("
                    f"parallel=) / ParallelConfig.resolve()) and their "
                    f"process groups from Mesh.group; a private one re-forms "
                    f"the parallelism islands the plan engine removed",
                    "mesh" if name != "new_group" else "new_group",
                )
                continue
            if not axis_literals:
                continue
            checked: list[ast.expr] = []
            if name in _AXIS_CONSUMER_NAMES:
                checked.extend(node.args)
            for kw in node.keywords:
                if kw.arg in _AXIS_KEYWORDS:
                    checked.append(kw.value)
            for arg in checked:
                for lit in self._axis_literals_in(arg, axis_literals):
                    yield self.finding(
                        module.path,
                        lit,
                        f"hard-coded mesh axis name {lit.value!r} — use "
                        f"the config *_AXIS_NAME constant (or "
                        f"plan_axis_name) so composed ParallelConfig "
                        f"layouts and renamed axes reach this call",
                        f"axis:{lit.value}",
                    )

    @staticmethod
    def _axis_literals_in(
        expr: ast.expr, axis_literals: frozenset[str]
    ) -> Iterator[ast.Constant]:
        if isinstance(expr, ast.Constant) and expr.value in axis_literals:
            yield expr
        elif isinstance(expr, (ast.Tuple, ast.List)):
            for elt in expr.elts:
                if (
                    isinstance(elt, ast.Constant)
                    and elt.value in axis_literals
                ):
                    yield elt


# ---------------------------------------------------------------------------
# Rule 6: undocumented env var
# ---------------------------------------------------------------------------


class UndocumentedEnvVar(Rule):
    """Every ``FLUXMPI_TPU_*`` variable the port reads must have a row in
    the docs/torch_static_analysis.md reference table, and every table
    row must correspond to a variable some scanned code actually reads —
    a one-sided check would let the table rot."""

    id = "undocumented-env-var"
    severity = "error"
    description = "FLUXMPI_TPU_* var missing from the docs table (or vice versa)"

    def project_check(
        self, modules: list[ModuleSource], ctx: Any
    ) -> Iterator[Finding]:
        from .context import env_vars_in_source

        documented = ctx.documented_env_vars
        used: dict[str, tuple[str, int]] = {}
        for module in modules:
            vars_here = env_vars_in_source(module.text, module.tree)
            for var, line in vars_here.items():
                used.setdefault(var, (module.path, line))
        for var in sorted(used):
            if var not in documented:
                path, line = used[var]
                yield Finding(
                    self.id,
                    self.severity,
                    path,
                    line,
                    0,
                    f"env var {var} is read here but has no row in the "
                    f"{ctx.env_doc_path} reference table — document it "
                    f"(or remove the dead knob)",
                    var,
                )
        # The reverse direction (documented but read nowhere) is only
        # meaningful over the full scan set; linting a subset would call
        # every table row stale. Proxy for "full scan": the faults
        # module is among the scanned files.
        if not any(m.path == ctx.faults_path for m in modules):
            return
        all_used = set(used) | set(ctx.extra_env_vars)
        for var in sorted(documented):
            if var not in all_used:
                yield Finding(
                    self.id,
                    self.severity,
                    ctx.env_doc_path,
                    documented[var],
                    0,
                    f"env var {var} is documented in the reference table "
                    f"but read by no scanned code (fluxmpi_tpu_torch/, "
                    f"examples_torch/, chip_smoke.py, the port's scripts) "
                    f"— delete the stale row or restore the knob",
                    f"unread:{var}",
                )


def default_rules() -> list[Rule]:
    return [
        SpmdDivergentCollective(),
        UnguardedHotPathInstrumentation(),
        UnknownMetricName(),
        UnregisteredFaultSite(),
        HandBuiltMesh(),
        UndocumentedEnvVar(),
    ]
