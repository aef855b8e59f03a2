"""Layout autotuner: ``init(parallel="auto")`` — enumerate, prune, trial, bank.

Counterpart of :mod:`fluxmpi_tpu.parallel.autotune`: the same four
stages, names, record, environment variables, errors and warnings.

Stage 1 — **enumerate** (:func:`enumerate_candidates`): every ordered
``dp × fsdp × tp`` factorization of the worker count, each resolved
through :meth:`ParallelConfig.resolve` and laid out by the plan's own
rule; a candidate whose rules had to warn and degrade (a tp dim the axis
does not divide), a tp axis that matched nothing or an fsdp axis that
claimed no leaf is dropped. ``pp``/``sp``/``ep`` stay out of the search,
as in the JAX package.

Stage 2 — **prune without executing**: :func:`layout_bytes`, the
parameters, optimizer state and one gradient per device under the plan
(from a :func:`state_template` on the meta device, counted as the JAX
package counts optax's state), against the memory plane's
``bytes_limit``; then a relative score ``flops + 4 * bytes_accessed``
from :func:`~fluxmpi_tpu_torch.utils.flops.update_cost`, the port's own
model of one update (no compiler cost analysis exists here; the FLOPs are
one forward and backward counted on a worker's rows of the sample batch,
the attention kernels' own count included). Memory-infeasible candidates
die first (``pruned="memory"``), then everything past the trial budget
(``pruned="dominated"``), pure dp always kept.

Stage 3 — **profile** (:func:`_run_trial`): each survivor trains on
seeded shuffles of the sample batch through the real
``make_train_step(parallel=plan)`` and ``train_loop``: a warmup run that
builds the step (on the card, in any world: the eager first window and
the CUDA-graph capture of the second, one graph per card), then a timed
run from a fresh state copied into the warm run's tensors, so the
captured graph replays without a re-capture (a re-capture counts as a
steady compile). Every trial runs fused windows (``fuse="auto"``, which
fuses every dp x fsdp x tp candidate across workers); a trial that did
not fuse raises, naming its layout.

Stage 4 — **bank**: the winner and the candidate table as a
``fluxmpi_tpu.autotune/v1`` record, validated, kept in-process, in the
``FLUXMPI_TPU_AUTOTUNE_BANK`` file and beside every checkpoint saved
under the autotuned plan (:func:`write_bank_sidecar`).

Every rank runs :func:`autotune` and ends with the same winner: the
static stages are deterministic, ``bytes_limit`` is the smallest of the
ranks', each trial's rate is its slowest rank's, and rank 0 alone reads
and writes the bank file (its read is broadcast). The fingerprint and the
record equal the JAX package's for the same model, so a bank written by
one package names the same model in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..telemetry.schema import (
    AUTOTUNE_PRUNE_REASONS,
    AUTOTUNE_SCHEMA,
    validate_autotune_record,
)
from .plan import ParallelConfig, ResolvedPlan

__all__ = [
    "AutotuneResult",
    "autotune",
    "clear_bank",
    "enumerate_candidates",
    "layout_bytes",
    "model_fingerprint",
]

TRIALS_ENV = "FLUXMPI_TPU_AUTOTUNE_TRIALS"
BANK_ENV = "FLUXMPI_TPU_AUTOTUNE_BANK"

_DEFAULT_TRIALS = 4

# Score weighting, the JAX package's: one byte moved costs about four
# FLOPs. The score only ranks candidates of one model on one topology.
_BYTE_COST_FLOPS = 4.0

# In-process bank: (model fingerprint, topology key) → banked record. It
# survives shutdown()/init() cycles, as in the JAX package.
_BANK: dict[tuple[str, str], dict[str, Any]] = {}

# The record of the last completed (or bank-reused) tune in this process
# — what save_checkpoint's sidecar write reads.
_LAST_RECORD: dict[str, Any] | None = None


class Candidate:
    """One enumerated layout: its axes, resolved plan, and the evidence
    the stages attach (memory, static score, trial result, prune
    reason)."""

    def __init__(self, axes: dict[str, int], plan: ResolvedPlan):
        self.axes = axes
        self.plan = plan
        self.mem_bytes_per_device: int | None = None
        self.flops: float | None = None
        self.bytes_accessed: float | None = None
        self.score: float | None = None
        self.pruned: str | None = None
        self.trial: dict[str, Any] | None = None

    def describe(self) -> dict[str, Any]:
        return {
            "axes": dict(self.axes),
            "mem_bytes_per_device": self.mem_bytes_per_device,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "score": self.score,
            "pruned": self.pruned,
            "trial": self.trial,
        }


class AutotuneResult:
    """What :func:`autotune` returns: the winning resolved plan (carrying
    ``autotune_fingerprint``), the schema'd record, and whether the bank
    answered (``from_bank=True`` → zero trials ran)."""

    def __init__(self, plan: ResolvedPlan, record: dict[str, Any], from_bank: bool):
        self.plan = plan
        self.record = record
        self.from_bank = from_bank

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        axes = ", ".join(f"{a}={s}" for a, s in self.record["winner"]["axes"].items()
                         if s != 1)
        src = "bank" if self.from_bank else "trials"
        return f"AutotuneResult({axes or 'dp=1'}, from {src})"


# ---------------------------------------------------------------------------
# Identity: what makes a banked winner reusable.
# ---------------------------------------------------------------------------


def _param_dict(params: Any) -> dict:
    """A model's parameters as the dict a ``TrainState`` holds (its
    named parameters for an ``nn.Module``)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _variables(params: Any) -> dict:
    """The parameters spelled as the JAX package's flax ``variables``
    (``params/<path>``), the tree its autotuner walks."""
    return {"params": _param_dict(params)}


def _dtype_name(leaf: Any) -> str:
    dtype = getattr(leaf, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype) if dtype is not None else "?"


def model_fingerprint(params: Any) -> str:
    """Stable identity of a model's parameter tree: sha256 over the leaf
    walk (path, shape, dtype per leaf) truncated to 16 hex chars — the
    JAX package's, over the paths of its flax ``variables`` for the same
    model (``params/encoder/block_0/...``), in the order JAX flattens them,
    with numpy dtype names, so both packages give a model one
    fingerprint."""
    from .sharding import leaf_paths

    rows = leaf_paths(_variables(params), lambda path, leaf: (
        f"{path}:{tuple(int(d) for d in getattr(leaf, 'shape', ()) or ())}"
        f":{_dtype_name(leaf)}"))
    digest = hashlib.sha256("\n".join(rows.values()).encode("utf-8")).hexdigest()
    return digest[:16]


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def topology_signature(devices: Sequence[int]) -> dict[str, Any]:
    """The topology half of the bank key: the device (worker) count, the
    card's name (``"cpu"`` without one) and the process world."""
    devs = list(devices)
    from .. import runtime

    dev = runtime.worker_device() if runtime.is_initialized() else None
    if dev is not None and dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    return {
        "n_devices": len(devs),
        "device_kind": kind if devs else "none",
        "process_count": _world(),
    }


def _topology_key(sig: dict[str, Any]) -> str:
    return f"{sig['n_devices']}x{sig['device_kind']}x{sig['process_count']}proc"


# ---------------------------------------------------------------------------
# Stage 1: enumerate.
# ---------------------------------------------------------------------------


def _factorizations(n: int) -> list[tuple[int, int, int]]:
    """All ordered (dp, fsdp, tp) triples with product ``n``, dp
    descending (pure dp first)."""
    out = []
    for dp in range(n, 0, -1):
        if n % dp:
            continue
        rest = n // dp
        for fsdp in range(rest, 0, -1):
            if rest % fsdp:
                continue
            out.append((dp, fsdp, rest // fsdp))
    return out


def enumerate_candidates(params: Any, devices: Sequence[int], *,
                         fsdp_min_size: int = 1024) -> list[Candidate]:
    """Stage 1: every valid ``dp × fsdp × tp`` layout for this model on
    these workers (ranks). Each candidate resolves through the plan path
    and lays the parameters out with the plan's rule; one whose rules
    warned and degraded, whose tp axis matched nothing or whose fsdp axis
    claimed no leaf is dropped. Plain data: no world is needed."""
    devs = [int(d) for d in devices]
    tree = _variables(params)
    out: list[Candidate] = []
    for dp, fsdp, tp in _factorizations(len(devs)):
        cfg = ParallelConfig(dp=dp, fsdp=fsdp, tp=tp, fsdp_min_size=fsdp_min_size)
        try:
            plan = cfg.resolve(devs)
        except Exception:
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                plan.partition_specs(tree)
            except Exception:
                continue
        if caught:
            continue
        if tp > 1 and not plan.rule_hits.get("tp"):
            continue
        if fsdp > 1 and not plan.rule_hits.get("fsdp"):
            continue
        out.append(Candidate({"dp": dp, "fsdp": fsdp, "tp": tp}, plan))
    return out


# ---------------------------------------------------------------------------
# Stage 2: prune without executing.
# ---------------------------------------------------------------------------


def _spec_shard_factor(spec: Any, mesh: Any) -> int:
    factor = 1
    for entry in tuple(spec or ()):
        if entry is None:
            continue
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        for name in names:
            factor *= int(mesh.shape[name])
    return factor


def _leaf_nbytes(leaf: Any) -> int:
    """A leaf's bytes: a tensor's, or 4 for a Python int (the int32 step
    and counts of the JAX package's state)."""
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, (bool, int, float)):
        return 4
    arr = np.asarray(leaf)
    return int(arr.size) * arr.dtype.itemsize


def _tree_bytes_per_device(tree: Any, specs: dict, mesh: Any) -> int:
    """Bytes per device of ``tree`` laid out by ``specs`` (``{leaf path:
    PartitionSpec}``), each sharded leaf rounded up, never undercounted."""
    from .sharding import leaf_paths

    sizes = leaf_paths(tree, lambda path, leaf: _leaf_nbytes(leaf))
    return int(sum(-(-nbytes // _spec_shard_factor(specs.get(path), mesh))
                   for path, nbytes in sizes.items()))


def state_template(params: Any, optimizer: Any, model_state: Any = None) -> Any:
    """A :class:`~fluxmpi_tpu_torch.parallel.TrainState` of the model on
    the meta device (its optimizer state built by the rule's ``init``):
    the shapes and dtypes of the state without allocating a byte of it."""
    from .train import TrainState

    def meta(t):
        return torch.empty_like(t, device="meta") if torch.is_tensor(t) else t

    params = {k: meta(v.detach()) for k, v in _param_dict(params).items()}
    return TrainState.create(params, optimizer, pytree.tree_map(meta, model_state))


def layout_bytes(template: Any, plan: ResolvedPlan) -> int:
    """Stage 2's static memory model: steady-state training bytes per
    device under ``plan`` — the sharded state (parameters and optimizer
    state, laid out by the plan's rule) plus one gradient tree laid out as
    the parameters. Activations and batch staging are excluded, so the
    check against ``bytes_limit`` is a floor."""
    mesh = plan.mesh
    total = _tree_bytes_per_device(template, plan._specs_by_path(template), mesh)
    params = getattr(template, "params", None)
    if params is not None:
        total += _tree_bytes_per_device(params, plan._specs_by_path(params), mesh)
    return total


def _first_leaf(batch: Any) -> Any:
    return pytree.tree_leaves(batch)[0]


def _update_flops(loss_fn: Any, params: Any, model_state: Any, sample_batch: Any,
                  n_devices: int) -> float:
    """FLOPs of one update's forward and backward over the whole sample
    batch: counted (:func:`~fluxmpi_tpu_torch.utils.flops.count_flops`) on
    one worker's rows, the first ``lead / n_devices``, and scaled to the
    batch. The same rows on every rank, so the same count."""
    from .. import runtime
    from ..utils.flops import count_flops

    lead = int(np.shape(_first_leaf(sample_batch))[0])
    rows = max(1, lead // n_devices)
    dev = runtime.worker_device() if runtime.is_initialized() else None
    live = _param_dict(params)
    dev = dev or next(iter(live.values())).device

    def part(x):
        return torch.as_tensor(np.asarray(x)[:rows]).to(dev)

    batch = pytree.tree_map(part, sample_batch)
    p = {k: v.detach().requires_grad_(v.requires_grad) for k, v in live.items()}
    with count_flops() as counted:
        loss, _ = loss_fn(p, model_state, batch)
        torch.autograd.grad(loss, [v for v in p.values() if v.requires_grad],
                            allow_unused=True)
    return counted.total * lead / rows


def _static_cost(loss_fn: Any, optimizer: Any, template: Any, sample_batch: Any,
                 plan: ResolvedPlan, *, params: Any = None, model_state: Any = None,
                 flops: float | None = None) -> dict[str, float] | None:
    """Per-device FLOPs and bytes of one full update under ``plan``
    (:func:`~fluxmpi_tpu_torch.utils.flops.update_cost`): ``flops`` the
    whole batch's count (counted from ``params`` when not given). Runs no
    collective and launches nothing on the candidate's mesh."""
    from .sharding import leaf_paths
    from ..utils.flops import update_cost

    mesh = plan.mesh
    if flops is None:
        flops = _update_flops(loss_fn, params, model_state, sample_batch, mesh.size)
    specs = plan._specs_by_path(template.params)
    leaves = leaf_paths(template.params, lambda path, leaf: (
        _leaf_nbytes(leaf), specs[path], tuple(leaf.shape)))
    first = np.shape(_first_leaf(sample_batch))
    tokens = int(first[0]) // plan.data_parallel_size * int(np.prod(first[1:], dtype=np.int64))
    return update_cost(plan, flops=flops, state_bytes=layout_bytes(template, plan),
                       leaves=leaves, tokens=tokens)


def _score(cost: dict[str, float] | None) -> float | None:
    if not cost:
        return None
    flops = cost.get("flops") or 0.0
    bytes_accessed = cost.get("bytes_accessed") or 0.0
    if flops <= 0 and bytes_accessed <= 0:
        return None
    return flops + _BYTE_COST_FLOPS * bytes_accessed


def _prune(candidates: list[Candidate], *, bytes_limit: int | None,
           max_trials: int) -> list[Candidate]:
    """Stage 2's verdict, the JAX package's: memory-infeasible layouts die
    first (``pruned="memory"``); the rest are ranked by the static score
    (ties by the memory floor, then axes) and everything past the trial
    budget is ``pruned="dominated"``, the feasible pure-dp layout always
    kept. Returns the survivors best-score-first."""
    for cand in candidates:
        if (bytes_limit and cand.mem_bytes_per_device is not None
                and cand.mem_bytes_per_device > bytes_limit):
            cand.pruned = "memory"
    alive = [c for c in candidates if c.pruned is None]

    def sort_key(c: Candidate) -> tuple:
        return (c.score if c.score is not None else float("inf"),
                c.mem_bytes_per_device or 0, tuple(sorted(c.axes.items())))

    alive.sort(key=sort_key)
    survivors = alive[:max_trials]
    pure_dp = next((c for c in alive
                    if all(s == 1 for a, s in c.axes.items() if a != "dp")), None)
    if pure_dp is not None and pure_dp not in survivors:
        survivors[-1] = pure_dp
    for cand in alive:
        if cand not in survivors:
            cand.pruned = "dominated"
    return survivors


# ---------------------------------------------------------------------------
# Stage 3: profile — trials on the real train_loop.
# ---------------------------------------------------------------------------


def _trial_dataset(sample_batch: Any, window: int, seed: int) -> Any:
    """``window`` seeded shuffles of the sample batch, concatenated —
    every candidate trains on the identical synthetic stream."""
    rng = np.random.default_rng(seed)
    lead = int(np.shape(_first_leaf(sample_batch))[0])
    perms = [rng.permutation(lead) for _ in range(window)]
    return pytree.tree_map(
        lambda x: np.concatenate([np.asarray(x)[p] for p in perms]), sample_batch)


def _state_leaves(state: Any) -> list:
    return [t for t in pytree.tree_leaves((state.params, state.opt_state,
                                           state.model_state)) if torch.is_tensor(t)]


def _run_trial(loss_fn: Any, optimizer: Any, host_params: Any, model_state: Any,
               sample_batch: Any, plan: ResolvedPlan, *, window: int, epochs: int,
               seed: int) -> dict[str, Any]:
    """One candidate's trial: place a fresh state under the plan, build
    the real ``make_train_step(parallel=plan)``, and drive ``train_loop``
    twice — a warmup of two windows that builds the step (the eager
    window, then the CUDA-graph capture on the card), then the timed
    epochs from a fresh state copied into the warm run's tensors, which
    must replay the captured window: zero new programs, zero re-captures,
    zero retraces. ``examples_per_sec`` is the global batch's rate (this
    worker's rows times the plan's data shards), ``captures`` the run's
    CUDA-graph captures (0 on the CPU), ``fused_window`` the timed run's
    window width (a run that did not fuse raises). This is the
    module's one trial entry point, which tests replace."""
    from .. import runtime
    from ..data import ArrayDataset, DistributedDataLoader
    from ..telemetry.compileplane import get_compile_monitor
    from .loop import train_loop
    from .train import TrainState, make_train_step

    t0 = time.perf_counter()
    gbs = int(np.shape(_first_leaf(sample_batch))[0])
    dataset = ArrayDataset(_trial_dataset(sample_batch, window, seed))
    axes = plan.data_axes
    device = runtime.worker_device() if runtime.is_initialized() else None
    loader = DistributedDataLoader(
        dataset, gbs, mesh=plan.mesh, device=device,
        axis_name=axes[0] if len(axes) == 1 else list(axes))
    source = {k: v.detach() for k, v in _param_dict(host_params).items()}

    def fresh_state():
        params = {k: v.clone().requires_grad_() for k, v in source.items()}
        state = TrainState.create(params, optimizer, model_state)
        if plan.shards_parameters:
            state, _ = plan.shard_state(state)
        return state

    # The first placement banks the layout on the plan, which
    # make_train_step(parallel=plan) reads: the state comes first.
    state = fresh_state()
    step = make_train_step(loss_fn, optimizer, parallel=plan)
    cp = get_compile_monitor()
    if cp is not None:
        cp.reset_run()
    # Every candidate is timed on the fused path, as the JAX package times
    # its trials with fuse="window": one that did not fuse raises.
    state, warm = train_loop(step, state, loader, epochs=2, fuse="auto",
                             flush_every=window, metrics=False)
    _require_fused(warm, plan)
    # The timed run starts from a fresh state held in the warm run's
    # tensors: a captured window replays against the same addresses.
    with torch.no_grad():
        for dst, src in zip(_state_leaves(state), _state_leaves(fresh_state())):
            dst.copy_(src)
    state.step = 0
    if cp is not None:
        cp.reset_run()
    _, timed = train_loop(step, state, loader, epochs=epochs, fuse="auto",
                          flush_every=window, metrics=False)
    _require_fused(timed, plan)
    cache = timed.get("window_cache") or {}
    programs = (getattr(step, "__fluxmpi_window_cache__", None) or {}).values()
    # The loop counts this worker's rows; the layouts are ranked by the
    # global batch's rate (as the JAX package's one controller counts it):
    # the workers of one data shard share its rows.
    shards = plan.data_parallel_size if _world() > 1 else 1
    return {
        "examples_per_sec": round(float(timed["examples_per_sec"]) * shards, 3),
        "updates": int(timed["updates"]),
        "compile_seconds": round(float(warm.get("window_compile_seconds") or 0.0), 4),
        "steady_compiles": int(cache.get("misses", 0)),
        "retraces": len(cp.retraces) if cp is not None else None,
        "captures": sum(p.captures for p in programs),
        "fused_window": int(timed["fused_window"]),
        "seconds": round(time.perf_counter() - t0, 3),
    }


def _require_fused(summary: dict[str, Any], plan: ResolvedPlan) -> None:
    """Raise unless the trial run ``summary`` reports ran fused windows, so
    no candidate is timed on another path than its peers."""
    if not summary.get("fused_window"):
        raise RuntimeError(
            f"the trial of layout {dict(plan.sizes)} ran pipelined, not in fused "
            f"windows (train_loop(fuse=\"auto\") declined it), so it cannot be "
            f"ranked beside the other candidates")


def _agree(trial: dict[str, Any]) -> dict[str, Any]:
    """A trial as the slowest rank saw it: the smallest rate, the largest
    counts and times over the world, so every rank ranks the same
    numbers."""
    import torch.distributed as dist

    if _world() == 1:
        return trial
    from .. import runtime

    keys = ["examples_per_sec", "compile_seconds", "steady_compiles", "retraces",
            "captures", "seconds"]
    vals = torch.tensor([-float(trial["examples_per_sec"])]
                        + [float(trial.get(k) or 0.0) for k in keys[1:]],
                        dtype=torch.float64)
    dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=runtime._state.host_group)
    out = dict(trial, examples_per_sec=-float(vals[0]))
    for k, v in zip(keys[1:], vals[1:].tolist()):
        if trial.get(k) is not None:
            out[k] = int(v) if isinstance(trial[k], int) else v
    return out


# ---------------------------------------------------------------------------
# Stage 4: bank.
# ---------------------------------------------------------------------------


def _bank_path(bank: Any) -> str | None:
    if isinstance(bank, str) and bank:
        return bank
    if bank is None:
        path = os.environ.get(BANK_ENV, "").strip()
        return path or None
    return None


def _read_bank(fingerprint: str, topo_key: str, bank: Any) -> dict[str, Any] | None:
    rec = _BANK.get((fingerprint, topo_key))
    if rec is not None:
        return rec
    path = _bank_path(bank)
    if path and os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if (isinstance(rec, dict)
                and rec.get("model_fingerprint") == fingerprint
                and _topology_key(rec.get("topology") or {}) == topo_key
                and not validate_autotune_record(rec)):
            return rec
    return None


def _bank_lookup(fingerprint: str, topo_key: str, bank: Any) -> dict[str, Any] | None:
    """The banked record for (model, topology): rank 0's in-process bank
    or bank file, broadcast to every rank."""
    import torch.distributed as dist

    from .. import runtime

    if _world() == 1:
        return _read_bank(fingerprint, topo_key, bank)
    box = [_read_bank(fingerprint, topo_key, bank) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=runtime._state.host_group)
    if box[0] is not None:
        _BANK[(fingerprint, topo_key)] = box[0]
    return box[0]


def _bank_store(record: dict[str, Any], bank: Any) -> None:
    import torch.distributed as dist

    key = (record["model_fingerprint"], _topology_key(record["topology"]))
    _BANK[key] = record
    path = _bank_path(bank)
    if path and (_world() == 1 or dist.get_rank() == 0):
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as exc:
            warnings.warn(
                f"could not write the autotune bank at {path} ({exc!r}); "
                f"the winner stays usable in-process, a later run re-tunes",
                stacklevel=2,
            )


def clear_bank() -> None:
    """Drop every in-process banked winner (test helper — file banks are
    the caller's to remove)."""
    global _LAST_RECORD
    _BANK.clear()
    _LAST_RECORD = None


def last_record() -> dict[str, Any] | None:
    """The record of this process's most recent tune (or bank reuse) —
    what the checkpoint sidecar write reads. None before any."""
    return _LAST_RECORD


def write_bank_sidecar(path: str) -> bool:
    """Write the last tune's record as ``<path>.autotune.json`` next to
    the checkpoint manifest — but only when the runtime's installed plan
    IS that tune's winner (a hand-pinned plan must not inherit another
    layout's evidence). Returns True when a sidecar was written."""
    from ..runtime import global_plan

    record = _LAST_RECORD
    if record is None:
        return False
    plan = global_plan()
    if plan is None or getattr(plan, "autotune_fingerprint", None) != (
            record["model_fingerprint"]):
        return False
    target = path + ".autotune.json"
    with open(target, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    return True


# ---------------------------------------------------------------------------
# Observability: autotune.* gauges + the AUTOTUNE /status board.
# ---------------------------------------------------------------------------


def _post_observability(record: dict[str, Any], from_bank: bool) -> None:
    from ..telemetry import export as _export
    from ..telemetry import get_registry

    pruned: dict[str, int] = {reason: 0 for reason in AUTOTUNE_PRUNE_REASONS}
    best = None
    for cand in record["candidates"]:
        if cand["pruned"] in pruned:
            pruned[cand["pruned"]] += 1
        trial = cand.get("trial")
        if trial and (best is None or trial["examples_per_sec"] > best):
            best = trial["examples_per_sec"]
    trial_seconds = sum((c.get("trial") or {}).get("seconds") or 0.0
                        for c in record["candidates"])
    registry = get_registry()
    registry.gauge("autotune.candidates_total").set(float(len(record["candidates"])))
    for reason, count in pruned.items():
        registry.gauge("autotune.pruned", reason=reason).set(float(count))
    registry.gauge("autotune.trials").set(float(record["trials"]))
    registry.gauge("autotune.trial_seconds").set(float(trial_seconds))
    if from_bank:
        registry.counter("autotune.bank_hits").inc()
    exporter = _export.get_exporter()
    if exporter is not None and exporter.enabled:
        exporter.note_autotune(
            fingerprint=record["model_fingerprint"],
            winner=dict(record["winner"]["axes"]),
            candidates=len(record["candidates"]),
            pruned_memory=pruned.get("memory", 0),
            pruned_dominated=pruned.get("dominated", 0),
            trials=record["trials"],
            best_examples_per_sec=best,
            bank="hit" if from_bank else "tuned",
        )


# ---------------------------------------------------------------------------
# The entry point.
# ---------------------------------------------------------------------------


def _plan_from_record(record: dict[str, Any], devices: Sequence[int]) -> ResolvedPlan:
    axes = {axis: int(size) for axis, size in record["winner"]["axes"].items()
            if axis in ("dp", "fsdp", "tp")}
    plan = ParallelConfig(**axes, fsdp_min_size=int(record["fsdp_min_size"])).resolve(
        list(devices))
    plan.autotune_fingerprint = record["model_fingerprint"]
    return plan


def _trials_budget(trials: int | None) -> int:
    if trials is not None:
        return max(1, int(trials))
    raw = os.environ.get(TRIALS_ENV, "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            warnings.warn(
                f"ignoring {TRIALS_ENV}={raw!r} (not an int); using the "
                f"default {_DEFAULT_TRIALS}",
                stacklevel=3,
            )
    return _DEFAULT_TRIALS


def _min_over_world(value: int | None) -> int | None:
    """The smallest of every rank's ``value`` (None where a rank has
    none); the same answer on every rank."""
    import torch.distributed as dist

    if _world() == 1:
        return value
    from .. import runtime

    t = torch.tensor([float(value) if value else float("inf")], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=runtime._state.host_group)
    return None if t.item() == float("inf") else int(t.item())


def autotune(
    loss_fn: Any,
    optimizer: Any,
    params: Any,
    sample_batch: Any,
    *,
    model_state: Any = None,
    devices: Sequence[int] | None = None,
    trials: int | None = None,
    window: int = 4,
    trial_epochs: int = 2,
    fsdp_min_size: int = 1024,
    bytes_limit: int | None = None,
    bank: Any = None,
    seed: int = 0,
    force: bool = False,
) -> AutotuneResult:
    """Search the layout space for (this model, this topology) and bank
    the winner. Under ``init(parallel="auto")`` the winning plan is also
    installed as the global plan, so ``make_train_step(parallel="auto")``
    and the loader defaults pick it up. Every rank calls it with the same
    arguments (the same parameters on every rank, as for any step).

    Args:
      loss_fn: ``(params, model_state, batch) -> (loss, new_model_state)``,
        the callable :func:`make_train_step` takes; trials train with it.
      optimizer: the :mod:`~fluxmpi_tpu_torch.optim` rule trials (and the
        memory model's optimizer-state accounting) use.
      params: the model (an ``nn.Module``) or its parameters (a dict of
        tensors keyed by state-dict name) — fingerprinted for the bank
        key, walked by the rule engine, copied for the trials (the model
        itself is not trained).
      sample_batch: one global batch (a tree of arrays or tensors, leading
        dim the global batch size, which must divide by the worker count).
        Trials train on ``window`` seeded shuffles of it.
      model_state: mutable model state for ``TrainState.create``.
      devices: the worker ranks to tune for (default: the runtime mesh's
        when initialized, else every worker of the world). A different
        worker set than a banked record's re-tunes.
      trials: trial budget (default ``FLUXMPI_TPU_AUTOTUNE_TRIALS`` or 4).
      window / trial_epochs: the flush-window width and timed epochs per
        trial.
      fsdp_min_size: forwarded to every candidate's :class:`ParallelConfig`.
      bytes_limit: per-device memory budget for stage 2 (default: the
        memory plane's ``bytes_limit`` — reserved plus free card memory —
        the smallest over the ranks; none on the CPU, so no memory
        pruning there).
      bank: bank file path (default ``FLUXMPI_TPU_AUTOTUNE_BANK``; the
        in-process bank always participates).
      seed: the synthetic-stream seed.
      force: re-tune even when the bank has a matching winner.

    Returns:
      :class:`AutotuneResult` — ``.plan`` (resolved, fingerprint-tagged),
      ``.record`` (the validated ``fluxmpi_tpu.autotune/v1`` table), and
      ``.from_bank``.
    """
    global _LAST_RECORD
    from .. import runtime as _runtime

    if devices is None:
        if _runtime.is_initialized():
            devices = [int(d) for d in _runtime.global_mesh().devices.flat]
        else:
            devices = list(range(_world()))
    devices = [int(d) for d in devices]
    if not devices:
        raise ValueError("autotune needs at least one device")
    lead = int(np.shape(_first_leaf(sample_batch))[0])
    if lead % len(devices):
        raise ValueError(
            f"sample_batch leading dim {lead} must divide by the device "
            f"count {len(devices)} so every candidate layout shards it "
            f"evenly"
        )
    fingerprint = model_fingerprint(params)
    topology = topology_signature(devices)
    topo_key = _topology_key(topology)

    if not force:
        banked = _bank_lookup(fingerprint, topo_key, bank)
        if banked is not None:
            plan = _plan_from_record(banked, devices)
            _LAST_RECORD = banked
            _post_observability(banked, from_bank=True)
            _runtime._install_autotuned_plan(plan)
            return AutotuneResult(plan, banked, from_bank=True)

    max_trials = _trials_budget(trials)
    candidates = enumerate_candidates(params, devices, fsdp_min_size=fsdp_min_size)
    if not candidates:
        raise RuntimeError(
            f"autotune found no valid layout for {len(devices)} device(s) "
            f"— the Megatron tp table matched nothing it can divide and "
            f"fsdp_min_size={fsdp_min_size} left nothing to shard; pin a "
            f"ParallelConfig by hand"
        )

    # Stage 2a: the static memory model, against the memory plane's
    # per-device budget when one is reported (the CPU reports none).
    template = state_template(params, optimizer, model_state)
    if bytes_limit is None:
        from ..telemetry.memory import device_memory_stats

        dev = _runtime.worker_device() if _runtime.is_initialized() else "cpu"
        limit = device_memory_stats(dev).get("bytes_limit")
        bytes_limit = _min_over_world(int(limit) if limit else None)
    for cand in candidates:
        cand.mem_bytes_per_device = layout_bytes(template, cand.plan)

    # Stage 2b: the static score, for the memory-feasible layouts only.
    flops = None
    for cand in candidates:
        if bytes_limit and cand.mem_bytes_per_device > bytes_limit:
            continue
        if flops is None:
            flops = _update_flops(loss_fn, params, model_state, sample_batch,
                                  len(devices))
        cost = _static_cost(loss_fn, optimizer, template, sample_batch, cand.plan,
                            flops=flops)
        if cost:
            cand.flops = cost.get("flops")
            cand.bytes_accessed = cost.get("bytes_accessed")
        cand.score = _score(cost)

    survivors = _prune(candidates, bytes_limit=bytes_limit, max_trials=max_trials)
    if not survivors:
        raise RuntimeError(
            f"every candidate layout exceeds the {bytes_limit}-byte "
            f"per-device budget — this model does not fit this topology "
            f"under dp×fsdp×tp alone (add pp by hand, or more devices)"
        )

    # Stage 3: trials on the real train_loop, each rank's slowest rate.
    for cand in survivors:
        cand.trial = _agree(_run_trial(
            loss_fn, optimizer, params, model_state, sample_batch,
            cand.plan, window=window, epochs=trial_epochs, seed=seed))
    winner = max(survivors, key=lambda c: (c.trial["examples_per_sec"],
                                           -(c.score or 0.0)))

    record = {
        "schema": AUTOTUNE_SCHEMA,
        "time_unix": time.time(),
        "model_fingerprint": fingerprint,
        "topology": topology,
        "fsdp_min_size": int(fsdp_min_size),
        "winner": {
            "axes": dict(winner.axes),
            "axis_names": dict(winner.plan.axis_names),
        },
        "trials": len(survivors),
        "candidates": [c.describe() for c in candidates],
    }
    errors = validate_autotune_record(record)
    if errors:  # pragma: no cover - producer drift guard
        raise ValueError("autotune produced an invalid record: " + "; ".join(errors))
    _bank_store(record, bank)
    _LAST_RECORD = record
    winner.plan.autotune_fingerprint = fingerprint
    _post_observability(record, from_bank=False)
    _runtime._install_autotuned_plan(winner.plan)
    return AutotuneResult(winner.plan, record, from_bank=False)
