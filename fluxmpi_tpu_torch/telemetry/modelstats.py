"""Model-internals plane: per-layer training dynamics, computed in the
step (counterpart of :mod:`fluxmpi_tpu.telemetry.modelstats`: the same
groups, stats, noise scale, ``model.*`` metrics and wiring).

The system planes watch the host and the device; this one watches the
*model*: the anomaly detector can name the layer whose gradients went
NaN, and per-layer norms are in the stream. The step already holds the
gradients, the optimizer updates and the parameters, so the stats are a
handful of extra reductions over tensors it has, and they change nothing
about the update (a run with the plane on is bit-identical to one with it
off, on both the pipelined and the fused-window path; inside a CUDA
graph the stats are computed by the graph into its static output
buffers, so they add no host launch per update).

What the stats carry, grouped by a configurable **path depth** so the
output stays O(layers) not O(leaves): each parameter's path is the JAX
package's (``params/<state-dict name with "." as "/">``, the spelling of
the port's manifests), so ``depth=2`` turns
``params/encoder/block_0/ff1/kernel`` into the ``params/encoder`` group
and the groups are the JAX package's for the same model:

- ``grad_norm`` / ``param_norm`` — per-group L2 norms of the gradients
  the optimizer consumed and of the pre-update parameters;
- ``update_norm`` — per-group L2 norm of the optimizer update, reported
  downstream as the **update-to-weight ratio** ``‖Δw‖/‖w‖``;
- ``nonfinite`` — count of NaN/Inf gradient elements per group: **NaN
  provenance**. The first group (in the JAX package's leaf order) with a
  nonzero count names the layer in the ``nan_grad``/``nan_loss`` anomaly
  event, trace instant, and diagnostics bundle;
- and, with a ``grad_reduce`` (the port's step is the JAX package's
  ``style="shard_map"`` step), the **gradient noise scale** ingredients:
  the mean over workers of each worker's pre-all-reduce gradient
  sq-norm and the all-reduced gradient's sq-norm — the two numbers the
  critical-batch-size estimator **B_simple** from McCandlish et al.,
  *An Empirical Model of Large-Batch Training* (2018) needs
  (:func:`noise_scale`).

Consumption is flush-granular: ``train_loop`` copies the stats to the
host once per flush (riding the drain the flush already pays), and
:meth:`ModelStats.observe_flush` emits the closed ``model.*`` metric
namespace, feeds the anomaly detector's ``layer_grad_explosion`` /
``dead_layer`` rules and NaN provenance, and powers the MODEL board on
``/status`` / ``fluxmpi_top`` and ``scripts/modelstats_report.py``.

Wiring follows the package convention: ``init(model_stats=...)`` /
``FLUXMPI_TPU_MODEL_STATS`` (depth via ``FLUXMPI_TPU_MODEL_STATS_DEPTH``,
dashboard top-k via ``FLUXMPI_TPU_MODEL_STATS_TOPK``) /
:func:`configure`; zero-cost-when-off (no plane installed means
``make_train_step`` builds nothing into the step and ``train_loop``
reads one module attribute per run) and full reset in
``telemetry.shutdown()``.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any

from .registry import MetricsRegistry, get_registry

__all__ = [
    "ModelStats",
    "get_model_stats",
    "set_model_stats",
    "configure",
    "shutdown",
    "group_paths",
    "compute_stats",
    "stats_zeros",
    "noise_scale",
    "resolve_step_spec",
    "StatsPlan",
    "stats_tensor",
    "stats_tree",
    "DEFAULT_DEPTH",
    "DEFAULT_TOP_K",
]

_ENV_VAR = "FLUXMPI_TPU_MODEL_STATS"
_ENV_DEPTH = "FLUXMPI_TPU_MODEL_STATS_DEPTH"
_ENV_TOPK = "FLUXMPI_TPU_MODEL_STATS_TOPK"

DEFAULT_DEPTH = 2
DEFAULT_TOP_K = 5


def _env_int(var: str, default: int) -> int:
    """Positive-int env knob via the ONE shared warn-and-default parser
    (``config.env_int`` — an env typo must never crash a training job)."""
    from ..config import env_int

    return int(env_int(var, default, minimum=1))


# ---------------------------------------------------------------------------
# In-step collection: torch reductions over the step's own tensors.
# ---------------------------------------------------------------------------


def _leaf_paths(params: dict) -> list[tuple[str, str]]:
    """``[(path, key)]`` of a parameter dict keyed by state-dict names, in
    the JAX package's leaf order: ``path`` is the leaf's flax path under
    the ``params`` collection (``params/a/b`` for ``a.b``), and the leaves
    come sorted by path level by level, as ``jax.tree_util`` flattens a
    dict."""
    pairs = [("/".join(("params", *key.split("."))), key) for key in params]
    return sorted(pairs, key=lambda pk: pk[0].split("/"))


def group_paths(tree: dict, depth: int) -> dict[str, list[int]]:
    """Ordered mapping of group name → flat leaf indices (in the JAX
    package's leaf order, :func:`_leaf_paths`), grouping a parameter
    dict's leaf paths at ``depth`` path components — the JAX package's
    group names for the same model. The groups are fixed by the dict's
    keys, which is what keeps the stats fixed-shape (and capturable in a
    CUDA graph)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    groups: dict[str, list[int]] = {}
    for i, (path, _key) in enumerate(_leaf_paths(tree)):
        name = "/".join(path.split("/")[:depth]) or "<root>"
        groups.setdefault(name, []).append(i)
    return groups


class StatsPlan:
    """The fixed layout of one step's stats: the parameter keys in the JAX
    package's leaf order, the group names, and each group's slice of that
    order (a group is a path prefix, so its leaves are contiguous)."""

    def __init__(self, params: dict, depth: int):
        pairs = _leaf_paths(params)
        self.keys = [key for _path, key in pairs]
        self.depth = depth
        groups = group_paths(params, depth)
        self.names = list(groups)
        self.slices = [(idx[0], idx[-1] + 1) for idx in groups.values()]
        self._sizes = [params[k].numel() for k in self.keys]
        self._numel: dict = {}

    def numel(self, device: Any) -> Any:
        """The leaves' element counts as a tensor on ``device``, made once
        (an eager step makes it before any CUDA-graph capture, which could
        not copy it from the host)."""
        import torch

        t = self._numel.get(device)
        if t is None:
            t = self._numel[device] = torch.tensor(self._sizes, device=device)
        return t

    def mask(self, owned: list, device: Any) -> Any:
        """``owned`` as an f32 ``0/1`` tensor on ``device``, made once (as
        :meth:`numel`)."""
        import torch

        key = (device, tuple(owned))
        t = self._numel.get(key)
        if t is None:
            t = self._numel[key] = torch.tensor(owned, dtype=torch.float32,
                                                device=device)
        return t


def _sq_norms(tensors: list) -> Any:
    """Each tensor's sum of squares, accumulated in f32, as one [n]
    tensor."""
    import torch

    vals = [t if t.dtype == torch.float32 else t.float() for t in tensors]
    return torch.stack(torch._foreach_norm(vals)).square()


def stats_tensor(plan: StatsPlan, grads: dict, params: dict, updates: dict,
                 owned: list | None = None) -> Any:
    """The stats as one ``[groups, 4]`` f32 tensor, rows in
    ``plan.names`` order, columns ``grad_norm``, ``param_norm``,
    ``update_norm``, ``nonfinite`` (the form a captured graph writes into
    its static output). ``params`` are the PRE-update parameters; nothing
    is recorded for autograd. ``owned`` (one bool per ``plan.keys``): the
    tensors are this worker's blocks of a layout, and each leaf's sums of
    squares and nonfinite counts add over the world from the workers that
    own a block (one all-reduce), so every block counts once."""
    import torch

    with torch.no_grad():
        return _stats_tensor(plan, grads, params, updates, owned)


def _stats_tensor(plan: StatsPlan, grads: dict, params: dict, updates: dict,
                  owned: list | None = None) -> Any:
    import torch

    g = [grads[k] for k in plan.keys]
    gsq = _sq_norms(g)
    psq = _sq_norms([params[k] for k in plan.keys])
    usq = _sq_norms([updates[k] for k in plan.keys])
    finite = torch.stack([torch.isfinite(x).sum() for x in g])
    bad = (plan.numel(finite.device) - finite).float()
    if owned is not None:
        import torch.distributed as dist

        rows = torch.stack([gsq, psq, usq, bad]) * plan.mask(owned, finite.device)
        dist.all_reduce(rows)
        gsq, psq, usq, bad = rows.unbind(0)
    cols = []
    for a, b in plan.slices:
        cols.append(torch.stack([gsq[a:b].sum().sqrt(), psq[a:b].sum().sqrt(),
                                 usq[a:b].sum().sqrt(), bad[a:b].sum()]))
    return torch.stack(cols)


def stats_tree(names: list, table: Any, noise: Any = None) -> dict[str, Any]:
    """The host-side stats tree of :func:`compute_stats`' structure (plain
    floats) from a :func:`stats_tensor` result over the groups ``names``
    (and the ``[2]`` noise ingredients ``local_sqnorm``,
    ``global_sqnorm``)."""
    rows = table.detach().cpu().tolist()
    out: dict[str, Any] = {"layers": {
        name: dict(zip(("grad_norm", "param_norm", "update_norm", "nonfinite"), row))
        for name, row in zip(names, rows)}}
    if noise is not None:
        local, glob = noise.detach().cpu().tolist()
        out["noise"] = {"local_sqnorm": local, "global_sqnorm": glob}
    return out


def compute_stats(grads: Any, params: Any, updates: Any, *, depth: int) -> Any:
    """The stats tree: ``{"layers": {group: {"grad_norm", "param_norm",
    "update_norm", "nonfinite"}}}`` of f32 scalar tensors, over the
    gradients the optimizer consumed, the PRE-update parameters (the μP
    ratio's denominator), and the optimizer updates (dicts keyed like
    ``params``). All sq-norm accumulation happens in f32 so bf16 leaves
    don't overflow the reduction."""
    plan = StatsPlan(params, depth)
    table = stats_tensor(plan, grads, params, updates)
    cols = ("grad_norm", "param_norm", "update_norm", "nonfinite")
    return {"layers": {name: {c: table[i, j] for j, c in enumerate(cols)}
                       for i, name in enumerate(plan.names)}}


def stats_zeros(params: Any, *, depth: int, noise: bool = False) -> Any:
    """A zeros tree with :func:`compute_stats`' exact structure."""
    import torch

    def z():
        return torch.zeros((), dtype=torch.float32)

    out: dict[str, Any] = {
        "layers": {
            name: {
                "grad_norm": z(),
                "param_norm": z(),
                "update_norm": z(),
                "nonfinite": z(),
            }
            for name in group_paths(params, depth)
        }
    }
    if noise:
        out["noise"] = {"local_sqnorm": z(), "global_sqnorm": z()}
    return out


# ---------------------------------------------------------------------------
# Gradient noise scale (B_simple, McCandlish et al. 2018).
# ---------------------------------------------------------------------------


def noise_scale(
    local_sqnorm: float,
    global_sqnorm: float,
    *,
    batch_examples: float,
    workers: int,
) -> float | None:
    """The critical-batch-size estimate **B_simple = tr(Σ) / |G|²**
    from the two gradient norms a data-parallel allreduce produces for
    free: ``local_sqnorm`` = the mean over ranks of each rank's
    pre-allreduce gradient sq-norm (a gradient estimate at batch
    ``B_small = batch_examples / workers``) and ``global_sqnorm`` = the
    sq-norm of the averaged gradient (batch ``B_big = batch_examples``).
    Each |g_B|² estimates |G|² + tr(Σ)/B, so the pair solves for both
    unknowns (McCandlish et al. 2018, appendix A.1):

        |G|²  ≈ (B_big·|g_big|² − B_small·|g_small|²) / (B_big − B_small)
        tr(Σ) ≈ (|g_small|² − |g_big|²) / (1/B_small − 1/B_big)

    Returns ``None`` when the estimate is undefined or the noisy
    single-step estimators land outside their valid region (|G|² ≤ 0 or
    tr(Σ) < 0 — near convergence individual steps do this routinely;
    average the *ingredient* gauges over time before dividing for a
    stable reading — ``scripts/modelstats_report.py --history``
    aggregates the ingredient means and, given ``--batch``/``--workers``,
    derives B_simple from them)."""
    if workers <= 1 or batch_examples <= 0:
        return None
    b_big = float(batch_examples)
    b_small = b_big / float(workers)
    if not (
        math.isfinite(local_sqnorm) and math.isfinite(global_sqnorm)
    ):
        return None
    g2 = (b_big * global_sqnorm - b_small * local_sqnorm) / (b_big - b_small)
    trace_sigma = (local_sqnorm - global_sqnorm) / (
        1.0 / b_small - 1.0 / b_big
    )
    if not math.isfinite(g2) or g2 <= 0.0:
        return None
    if not math.isfinite(trace_sigma) or trace_sigma < 0.0:
        return None
    return trace_sigma / g2


# ---------------------------------------------------------------------------
# The host-side plane: flush-boundary emission + summaries.
# ---------------------------------------------------------------------------


class ModelStats:
    """Model-internals plane configuration + flush-boundary consumer.

    Args:
      registry: registry the ``model.*`` gauges record into by default
        (default: the process-global one, resolved at observe time).
      depth: leaf-path components per stats group (default
        ``FLUXMPI_TPU_MODEL_STATS_DEPTH`` or 2 — ``params/<module>``
        for flax trees), the O(layers)-not-O(leaves) knob. Steps bake
        the depth in at build time (:func:`resolve_step_spec`).
      top_k: layers on the ``/status`` MODEL board / ``fluxmpi_top``
        panel, ranked by gradient norm (default
        ``FLUXMPI_TPU_MODEL_STATS_TOPK`` or 5).
    """

    def __init__(
        self,
        *,
        registry: MetricsRegistry | None = None,
        depth: int | None = None,
        top_k: int | None = None,
    ):
        self.enabled = True
        self._registry = registry
        self.depth = (
            int(depth) if depth is not None
            else _env_int(_ENV_DEPTH, DEFAULT_DEPTH)
        )
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        self.top_k = (
            int(top_k) if top_k is not None
            else _env_int(_ENV_TOPK, DEFAULT_TOP_K)
        )
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")

    def observe_flush(
        self,
        stats: Any,
        *,
        step: int | None = None,
        registry: MetricsRegistry | None = None,
        batch_examples: float | None = None,
        workers: int | None = None,
    ) -> dict[str, Any]:
        """Consume one host-side stats tree (the device→host copy of
        :func:`compute_stats`' output, last update of the flush
        interval): emit the ``model.*`` gauges and return the summary
        the anomaly detector and the status board consume —
        ``{"layers": {name: grad_norm}, "update_ratios", "param_norms",
        "nonfinite_layer", "nonfinite_total", "noise_scale", "top"}``.
        ``batch_examples``/``workers`` feed :func:`noise_scale` when the
        tree carries the allreduce ingredients."""
        layers_in = (stats or {}).get("layers") or {}
        grad_norms: dict[str, float] = {}
        param_norms: dict[str, float] = {}
        update_ratios: dict[str, float] = {}
        nonfinite: dict[str, int] = {}
        nonfinite_layer: str | None = None
        for name, st in layers_in.items():
            gnorm = float(st["grad_norm"])
            pnorm = float(st["param_norm"])
            unorm = float(st["update_norm"])
            bad = int(st["nonfinite"])
            grad_norms[name] = gnorm
            param_norms[name] = pnorm
            update_ratios[name] = unorm / pnorm if pnorm > 0.0 else 0.0
            nonfinite[name] = bad
            if bad > 0 and nonfinite_layer is None:
                nonfinite_layer = name
        ns: float | None = None
        local_sq: float | None = None
        global_sq: float | None = None
        noise = (stats or {}).get("noise")
        if noise is not None:
            local_sq = float(noise["local_sqnorm"])
            global_sq = float(noise["global_sqnorm"])
            if batch_examples and workers:
                ns = noise_scale(
                    local_sq,
                    global_sq,
                    batch_examples=batch_examples,
                    workers=workers,
                )
        reg = registry
        if reg is None:
            reg = (
                self._registry if self._registry is not None
                else get_registry()
            )
        if getattr(reg, "enabled", True):
            for name in grad_norms:
                reg.gauge("model.layer_grad_norm", layer=name).set(
                    grad_norms[name]
                )
                reg.gauge("model.layer_param_norm", layer=name).set(
                    param_norms[name]
                )
                reg.gauge("model.update_ratio", layer=name).set(
                    update_ratios[name]
                )
                reg.gauge("model.nonfinite", layer=name).set(
                    float(nonfinite[name])
                )
            if local_sq is not None:
                reg.gauge("model.grad_sqnorm_local").set(local_sq)
                reg.gauge("model.grad_sqnorm_global").set(global_sq)
            if ns is not None:
                reg.gauge("model.grad_noise_scale").set(ns)
        top = sorted(
            (
                (name, g)
                for name, g in grad_norms.items()
                if math.isfinite(g)
            ),
            key=lambda item: item[1],
            reverse=True,
        )[: self.top_k]
        return {
            "step": step,
            "layers": grad_norms,
            "param_norms": param_norms,
            "update_ratios": update_ratios,
            "nonfinite_layer": nonfinite_layer,
            "nonfinite_total": sum(nonfinite.values()),
            "noise_scale": ns,
            "top": top,
        }


# ---------------------------------------------------------------------------
# Module wiring (init kwarg / env var) — the anomaly/export shape.
# ---------------------------------------------------------------------------

_active: ModelStats | None = None
_active_lock = threading.Lock()


def get_model_stats() -> ModelStats | None:
    """The installed plane, if any (None = plane off). ``train_loop``
    and ``make_train_step`` read this once per run/build — the
    zero-cost-when-off gate."""
    return _active


def set_model_stats(plane: ModelStats | None) -> ModelStats | None:
    """Install (or, with None, remove) the process model-stats plane;
    returns the previous one."""
    global _active
    with _active_lock:
        prev, _active = _active, plane
    return prev


def resolve_step_spec(spec: Any) -> int | None:
    """Normalize a ``make_train_step(model_stats=)`` spec to the stats
    depth built into the step, or None for off:

    - ``None`` — follow the installed plane (its depth when enabled,
      else off — the ``init(model_stats=)`` / env route);
    - ``False`` — force off regardless of the plane;
    - ``True`` — on, at the installed plane's depth (default depth when
      no plane is installed — explicit opt-in works standalone);
    - an int ≥ 1 — on, at that depth;
    - a :class:`ModelStats` — on, at its depth.
    """
    if spec is None:
        plane = get_model_stats()
        if plane is not None and plane.enabled:
            return plane.depth
        return None
    if spec is False:
        return None
    if spec is True:
        plane = get_model_stats()
        return plane.depth if plane is not None else DEFAULT_DEPTH
    if isinstance(spec, ModelStats):
        return spec.depth
    if isinstance(spec, int) and not isinstance(spec, bool) and spec >= 1:
        return spec
    raise ValueError(
        f"model_stats must be None, a bool, a depth int >= 1, or a "
        f"ModelStats; got {spec!r}"
    )


def configure(spec: Any = None) -> ModelStats | None:
    """Wire the model-internals plane from a one-value spec (mirror of
    :func:`fluxmpi_tpu_torch.telemetry.configure`):

    - ``None`` — read ``FLUXMPI_TPU_MODEL_STATS`` (same forms; no-op
      when unset/empty);
    - ``False`` / ``"0"`` — uninstall;
    - ``True`` / ``"1"`` — install a default :class:`ModelStats`
      (depth/top-k from their env knobs; ``"1"`` is the repo-wide "on"
      spelling, so a grouping depth of 1 needs the explicit
      ``ModelStats(depth=1)`` / ``FLUXMPI_TPU_MODEL_STATS_DEPTH=1``
      form);
    - an int / digit string ≥ 2 — install with that grouping depth;
    - a :class:`ModelStats` — install it.

    Called by ``fluxmpi_tpu_torch.init(model_stats=...)``; idempotent — an
    installed plane with a matching depth is kept on a replay. Note the
    plane gates *collection at step-build time*: steps built while it is
    off carry no stats (and keep running, stats-less, after it turns
    on).
    """
    if spec is None:
        spec = os.environ.get(_ENV_VAR)
        if spec is None or spec == "":
            return _active
    if isinstance(spec, ModelStats):
        spec.enabled = True
        set_model_stats(spec)
        return spec
    if spec is False or spec == "0":
        set_model_stats(None)
        return None
    depth: int | None = None
    if isinstance(spec, str) and spec.isdigit():
        spec = int(spec)
    if spec is True or spec == 1:
        depth = None
    elif isinstance(spec, int) and not isinstance(spec, bool) and spec > 1:
        depth = spec
    else:
        raise ValueError(
            f"model_stats spec must be a bool, '0'/'1', a depth int, or "
            f"a ModelStats; got {spec!r}"
        )
    if _active is not None and (depth is None or _active.depth == depth):
        _active.enabled = True
        return _active
    plane = ModelStats(depth=depth)
    set_model_stats(plane)
    return plane


def shutdown() -> None:
    """Uninstall the plane — depth/top-k config must never leak into
    the next init cycle (the fault-plane leak rule)."""
    set_model_stats(None)
