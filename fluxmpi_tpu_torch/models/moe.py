"""Mixture-of-experts layers with expert parallelism over the mesh.

Counterpart of :mod:`fluxmpi_tpu.models.moe`: Switch top-1 routing by
default, GShard top-2 with ``top_k=2`` (renormalized gates, first choices
claim capacity first), and expert choice with ``routing="experts"``
(each expert takes its top-capacity tokens), all grouped (capacity,
cumsum and dispatch per group; by default one group per batch row) and
built from dense one-hot dispatch and combine einsums over static shapes,
so a step captures into a CUDA graph. Tokens over capacity are dropped
(the residual carries them). The parameters keep flax's names and
layouts: ``moe/router`` ``[d, E]``, ``moe/w1`` ``[E, d, d_ff]``,
``moe/b1`` ``[E, d_ff]``, ``moe/w2`` ``[E, d_ff, d]``, ``moe/b2``
``[E, d]``, so :func:`~fluxmpi_tpu_torch.models.load_flax_params` is a
copy.

Sowed losses: the layer's ``forward(..., losses=d)`` stores the Switch
load-balancing loss under ``d["moe_aux_loss"]`` and the ST-MoE router
z-loss under ``d["moe_router_z_loss"]``, each a tuple as flax's ``sow``
keeps them; the models thread a nested dict down
(``TransformerLM.forward(losses=...)``), the port's spelling of flax's
``mutable=["losses"]``. :func:`collect_moe_losses` sums them.

Expert parallelism: with a ``mesh`` whose ``ep`` axis is above 1, each
worker holds ``E / ep`` experts (its block of the ``ep``-sharded expert
weights, :func:`expert_parallel_rules`). The expert-major ``[G, E, C, d]``
activations are exchanged over the ``ep`` process group with the
differentiable ``all_to_all_single``, the local experts run on every
worker's tokens, and the result is exchanged back before the combine,
where in JAX the sharding pins let the partitioner insert the same
all-to-alls. With ``mesh=None`` the layer is dense.

Sequence parallelism: under a layout step over a plan with ``sp > 1``
(:mod:`fluxmpi_tpu_torch._sequence_parallel`) the layer gets this
worker's block of each sequence, and it routes each group as a whole, as
the JAX package's partitioned step does: the router probabilities of the
sp group's tokens are all-gathered (detached, ``[N, E]`` per worker), so
every worker picks each token's experts, its slot in an expert's capacity
(the cumulative count over the whole group, first choices first) and,
under expert choice, each expert's top tokens over the whole group, then
builds the dispatch and combine of its own tokens only
(:meth:`MoEMLP.route_block`). A capacity slot belongs to one token, so a
worker's expert inputs hold its own tokens' slots and its combine reads
only those: no sum of expert inputs over sp. The capacity comes from the
whole group's size; the balance loss's router-probability factor and the
z-loss sum over sp (:func:`~fluxmpi_tpu_torch._collective_ops.sum_shared`),
so every worker sows the group's values. Groups (``n_groups``) may cut
across the sequence blocks; a worker's tokens of one group are then
padded to the largest count. Under ``ep`` the all-to-all runs in the ep
group at the worker's own sp index. Inside a pipeline stage a layer built
with ``mesh=`` raises ``ValueError``, as the JAX package's sharding pins do
there.

Explicit ``n_groups`` under the ``style="auto"`` step: JAX cuts the global
batch's token order into ``n_groups`` groups, so the port's layer routes
this worker's share of that grouping
(:mod:`~fluxmpi_tpu_torch._batch_parallel`). Where the groups fall whole
inside each of the ``W`` workers' rows it routes ``n_groups / W`` groups
of its own tokens and no data moves; where a group spans workers, each
group is routed whole as under sp, the router probabilities gathered over
the batch axes (with sp, over both) and the group statistics summed over
them. The default grouping (one group per row) needs neither.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import _batch_parallel
from .. import _sequence_parallel as _sp
from .. import config, runtime
from .._collective_ops import sum_shared
from ..runtime import resolve_device
from ._layers import _Init, lecun_normal
from .transformer import EncoderBlock, TransformerEncoder, TransformerLM

__all__ = [
    "MoEEncoder",
    "MoEEncoderBlock",
    "MoEMLP",
    "MoETransformerLM",
    "collect_moe_losses",
    "expert_parallel_rules",
]


def collect_moe_losses(losses_collection: Any) -> tuple[Any, Any]:
    """Sum the sowed MoE losses across every layer of a (possibly nested)
    losses collection: returns ``(balance_loss, router_z_loss)``. Add each
    to the task loss with its own coefficient (typical: 1e-2 for balance,
    1e-3 for z)."""
    aux, z = 0.0, 0.0

    def walk(node, key):
        nonlocal aux, z
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, key + (str(k),))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, key)
        elif "moe_aux_loss" in key:
            aux = aux + node
        elif "moe_router_z_loss" in key:
            z = z + node

    walk(losses_collection, ())
    return aux, z


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in f32: rows out of ``[0, n)`` are all
    zero. A comparison, so no host check (capture-safe)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last dim, descending,
    ties to the lower index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class TokenShare(NamedTuple):
    """This worker's share of the global token order: sequence block ``i``
    of ``n`` of row block ``d`` of ``D``; ``axis`` the members that share
    its groups (size ``n * D``, ``ranks`` row block first), over which the
    router probabilities are gathered and the group statistics summed."""

    axis: Any
    n: int
    i: int
    d: int
    D: int


class BlockLayout(NamedTuple):
    """Where this worker's tokens sit in their routing groups under
    sequence parallelism: ``groups`` groups of ``gs`` tokens over the sp
    group's sequences; this worker's tokens of group ``g`` are local tokens
    ``index[g, :count]`` (a contiguous run; padded to ``m`` with the index
    ``n_local``, a zero row) at group positions ``pos[g]``; ``valid`` marks
    the real ones and ``back[t]`` is local token ``t``'s flat ``g * m +
    j``. ``regular``: the runs are ``reshape(groups, m)`` of the local
    tokens (one group per row, the default)."""

    groups: int
    gs: int
    m: int
    index: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    back: torch.Tensor
    regular: bool


@functools.lru_cache(maxsize=64)
def block_layout(b: int, s_local: int, n: int, i: int, n_groups: int | None,
                 device: torch.device, d: int = 0, D: int = 1) -> BlockLayout:
    """The :class:`BlockLayout` of sequence block ``i`` of ``n`` of the
    ``d``-th of ``D`` row blocks (``b`` rows of ``s_local`` tokens each,
    row ``r``'s block at ``(d * b + r) * S + i * s_local`` of the global
    batch's flattened tokens, ``S = n * s_local``), grouped as the JAX
    package groups the whole batch: ``n_groups`` groups, or one per row.
    Made once per shape (host lists, then one copy)."""
    seq = n * s_local
    total = D * b * seq
    groups = D * b if n_groups is None else n_groups
    if total % groups:
        raise ValueError(f"n_groups {groups} must divide token count {total}")
    gs = total // groups
    rows: list[list[tuple[int, int]]] = [[] for _ in range(groups)]
    for t in range(b * s_local):
        f = (d * b + t // s_local) * seq + i * s_local + t % s_local
        rows[f // gs].append((t, f % gs))
    m = max(1, max(len(r) for r in rows))
    n_local = b * s_local
    index = [[t for t, _ in r] + [n_local] * (m - len(r)) for r in rows]
    pos = [[q for _, q in r] + [0] * (m - len(r)) for r in rows]
    valid = [[True] * len(r) + [False] * (m - len(r)) for r in rows]
    back = [0] * n_local
    for g, r in enumerate(rows):
        for j, (t, _) in enumerate(r):
            back[t] = g * m + j
    regular = groups * m == n_local and back == list(range(n_local))
    as_long = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return BlockLayout(groups, gs, m, as_long(index), as_long(pos),
                       torch.tensor(valid, dtype=torch.bool, device=device),
                       as_long(back), regular)


def _own(x: torch.Tensor, lay: BlockLayout) -> torch.Tensor:
    """Local rows ``x [n_local, ...]`` as ``[groups, m, ...]`` by the
    layout (padding rows zero)."""
    if lay.regular:
        return x.reshape(lay.groups, lay.m, *x.shape[1:])
    padded = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])
    return padded[lay.index]


def _local(y: torch.Tensor, lay: BlockLayout) -> torch.Tensor:
    """``y [groups, m, ...]`` back to the local rows ``[n_local, ...]``."""
    flat = y.reshape(lay.groups * lay.m, *y.shape[2:])
    return flat if lay.regular else flat[lay.back]


class MoEMLP(nn.Module):
    """Mixture-of-experts feed-forward layer with grouped routing
    (:class:`fluxmpi_tpu.models.moe.MoEMLP`, the same fields).

    Input/output ``(..., d_model)``; ``d_model`` is given at construction
    (flax infers it at the first call). Tokens route per group:
    ``n_groups`` explicit groups, or one group per leading row for inputs
    of rank >= 3. Per-expert capacity per group: ``max(1, int(-(-gs * cf *
    top_k // E)))``, the reference's float floor division. The router runs
    in f32; the experts in ``dtype``. ``router_noise`` adds Gaussian noise
    to the router logits in training, drawn from the ``torch.Generator``
    passed to :meth:`forward` as ``rng`` (flax's ``"router"`` rng)."""

    flax_name = "moe"

    def __init__(self, num_experts: int = 8, d_ff: int = 256,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32,
                 router_noise: float = 0.0, n_groups: int | None = None,
                 top_k: int = 1, routing: str = "tokens", mesh: Any = None,
                 ep_axis: str | None = None, dp_axis: str | None = None, *,
                 d_model: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_experts, self.d_ff, self.d_model = num_experts, d_ff, d_model
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router_noise = float(router_noise)
        self.n_groups, self.top_k, self.routing = n_groups, top_k, routing
        self.mesh, self.ep_axis, self.dp_axis = mesh, ep_axis, dp_axis
        init = _Init(resolve_device(device),
                     generator or torch.Generator().manual_seed(0))
        e = num_experts
        self.router = lecun_normal(init, (d_model, e), d_model)
        # flax's lecun_normal on [E, in, out]: fan_in = in * E.
        self.w1 = lecun_normal(init, (e, d_model, d_ff), d_model * e)
        self.b1 = init.fill((e, d_ff), 0.0)
        self.w2 = lecun_normal(init, (e, d_ff, d_model), d_ff * e)
        self.b2 = init.fill((e, d_model), 0.0)

    def _ep(self) -> tuple[Any, int, int]:
        """``(group, size, index)`` of this worker on the ``ep`` axis."""
        if self.mesh is None:
            return None, 1, 0
        name = self.ep_axis or config.EP_AXIS_NAME
        size = self.mesh.shape.get(name, 1)
        if size == 1:
            return None, 1, 0
        if self.num_experts % size:
            raise ValueError(f"num_experts {self.num_experts} not divisible by "
                             f"the {name!r} axis size {size}")
        index, _ = self.mesh.block_index(self.mesh.my_rank(), name)
        return self.mesh.group((name,)), size, index

    def _sequence_axis(self, x: torch.Tensor):
        """The bound sp axis when this worker holds a block of each
        sequence (a layout step over a plan with sp), else None; inside a
        pipeline stage a layer built with ``mesh=`` raises."""
        seq = _sp.current()
        if seq is None:
            return None
        if seq.stage and self.mesh is not None:
            raise ValueError(
                "an MoEMLP built with mesh= cannot run inside a pipeline stage: "
                "the pipeline replicates every mesh axis but pp, so the expert "
                "layout's sharding pins have no axis to bind there (the JAX "
                "package's pins raise there too); build the stage's MoE layer "
                "with mesh=None")
        if seq.sp is None:
            return None
        axis = seq.axis(seq.sp)
        if axis.size == 1:
            return None
        if x.ndim < 3:
            raise ValueError(
                f"under a plan with sp the MoE layer takes [batch, sequence block, "
                f"d_model] inputs, got shape {tuple(x.shape)}")
        return axis

    def _token_share(self, x: torch.Tensor):
        """Where this worker's tokens sit in the global grouping: ``(share,
        n_groups)``, ``share`` a :class:`TokenShare` when a group can span
        workers (sp blocks, or ``n_groups`` that cut across the batch
        axes' rows), else None; ``n_groups`` the groups to route here
        (``n_groups / W`` when the groups fall whole inside each of the
        ``W`` workers' rows, so no data moves)."""
        axis = self._sequence_axis(x)
        n_groups = self.n_groups
        if n_groups is None and x.ndim < 3:
            n_groups = 1  # every token in one group, as JAX groups 2-D inputs
        rows = _batch_parallel.current() if n_groups is not None else None
        if rows is not None and n_groups % rows.size == 0:
            n_groups, rows = n_groups // rows.size, None
        if rows is None:
            if axis is None:
                return None, n_groups
            return TokenShare(axis, axis.size, axis.index, 0, 1), n_groups
        if axis is None:
            return TokenShare(rows, 1, 0, rows.index, rows.size), n_groups
        both = rows.with_axis(axis.name)
        return TokenShare(both, axis.size, axis.index, rows.index, rows.size), n_groups

    def forward(self, x: torch.Tensor, *, train: bool = True,
                rng: torch.Generator | None = None, losses: dict | None = None):
        share, n_groups = self._token_share(x)
        if share is not None:
            return self._block_forward(x, share, n_groups, train, rng, losses)
        *lead, d_model = x.shape
        n_tokens = math.prod(lead)
        if n_groups is not None:
            groups = n_groups
            if n_tokens % groups:
                raise ValueError(
                    f"n_groups {self.n_groups or groups} must divide token count "
                    f"{n_tokens * (self.n_groups or groups) // groups}")
        else:
            groups = lead[0] if len(lead) >= 2 else 1
        gs = n_tokens // groups
        e = self.num_experts
        tokens = x.reshape(groups, gs, d_model).to(self.dtype)
        # Router in f32: tiny, and argmax/softmax stability matters.
        logits = torch.einsum("gsd,de->gse", tokens.float(), self.router.float())
        if self.router_noise > 0.0 and train:
            if rng is None:
                raise ValueError("router_noise > 0 in training needs rng (a "
                                 "torch.Generator), as flax needs the "
                                 "'router' rng")
            logits = logits + self.router_noise * _router_noise(logits, rng)
        probs = torch.softmax(logits, dim=-1)  # [G, S, E]
        if self.routing not in ("tokens", "experts"):
            raise ValueError(
                f"routing={self.routing!r} must be 'tokens' or 'experts'")
        if self.routing == "experts":
            if self.top_k != 1:
                raise ValueError(
                    "expert-choice routing has no top_k (capacity_factor "
                    "sets each expert's token budget); leave top_k=1")
            return self._expert_choice(x, tokens, probs, logits, losses)
        if not 1 <= self.top_k <= e:
            raise ValueError(
                f"top_k={self.top_k} must be in [1, num_experts={e}]")
        dispatch, combine, _, onehot1 = self.route(probs)
        # Switch eq. 4 per group, averaged: E * mean_g sum_e f_ge * P_ge.
        aux = e * torch.mean(torch.sum(onehot1.mean(dim=1) * probs.mean(dim=1), dim=-1))
        self._sow(losses, aux, logits)
        expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(self.dtype), tokens)
        out = self._apply_experts(expert_in)
        y = torch.einsum("gsec,gecd->gsd", combine.to(self.dtype), out)
        return y.reshape(*lead, d_model).to(x.dtype)

    def capacity(self, group_size: int) -> int:
        """Per-expert capacity of a group (token choice)."""
        return max(1, int(-(-group_size * self.capacity_factor * self.top_k
                            // self.num_experts)))

    def expert_capacity(self, group_size: int) -> int:
        """Per-expert capacity of a group (expert choice)."""
        return min(group_size, max(1, int(-(-group_size * self.capacity_factor
                                              // self.num_experts))))

    def route(self, probs: torch.Tensor):
        """Token-choice routing of router probabilities ``[G, S, E]``:
        ``(dispatch, combine, topk_idx, first_onehot)``, dispatch and
        combine ``[G, S, E, C]`` f32 (:meth:`route_block` of every token).
        Every first choice claims expert capacity before any second
        choice."""
        every = _every_position(probs)
        return self.route_block(probs, probs, every, torch.ones_like(every, dtype=torch.bool))

    def route_block(self, probs: torch.Tensor, probs_own: torch.Tensor,
                    pos: torch.Tensor, valid: torch.Tensor):
        """:meth:`route` of a sequence block: ``probs`` ``[G, S, E]`` are the
        whole groups' router probabilities (gathered over sp; they pick the
        experts and the capacity slots), ``probs_own`` ``[G, M, E]`` this
        worker's tokens' (the gates, differentiable) at group positions
        ``pos`` ``[G, M]``, ``valid`` marking real tokens. Returns
        ``(dispatch, combine, topk_idx, first_onehot)``: dispatch and
        combine ``[G, M, E, C]`` of this worker's tokens, equal to those
        rows of the whole groups' routing, and the whole groups' chosen
        experts ``[G, S, K]`` and first-choice one-hot ``[G, S, E]``."""
        groups, gs, e = probs.shape
        capacity = self.capacity(gs)
        _, topk_idx = _top_k(probs, self.top_k)  # [G, S, K]
        at = pos[..., None]
        idx_own = torch.gather(topk_idx, 1, at.expand(-1, -1, self.top_k))
        gates = torch.gather(probs_own, -1, idx_own)
        if self.top_k > 1:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        dispatch = combine = onehot1 = None
        counts = torch.zeros((groups, 1, e), dtype=torch.float32, device=probs.device)
        live = valid[..., None].float()
        for choice in range(self.top_k):
            onehot = _one_hot(topk_idx[..., choice], e)  # [G, S, E]
            if onehot1 is None:
                onehot1 = onehot
            # Position in the expert's buffer: earlier choices' totals
            # offset this choice's group-wide cumsum.
            slot = (torch.cumsum(onehot, dim=1) - 1.0 + counts) * onehot
            pick = at.expand(-1, -1, e)
            slot_own = torch.gather(slot, 1, pick)
            chosen = torch.gather(onehot, 1, pick) * live
            kept = (slot_own < capacity) & (chosen > 0)
            d = _one_hot(slot_own.to(torch.int32), capacity) * kept[..., None].float()
            dispatch = d if dispatch is None else dispatch + d
            dc = d * gates[..., choice, None, None]
            combine = dc if combine is None else combine + dc
            counts = counts + onehot.sum(dim=1, keepdim=True)
        return dispatch, combine, topk_idx, onehot1

    def choose_block(self, probs: torch.Tensor, probs_own: torch.Tensor,
                     pos: torch.Tensor, valid: torch.Tensor):
        """Expert choice for a sequence block (arguments as
        :meth:`route_block`): each expert's top-capacity tokens over the
        whole groups; returns ``(own, gates)``, ``own`` ``[G, E, C, M]``
        the one-hot of the picks that are this worker's tokens (the rows
        of the whole one-hot ``[G, E, C, S]`` at ``pos``) and ``gates``
        ``[G, E, C]`` their router probabilities (zero for others')."""
        _, idx = _top_k(probs.transpose(1, 2), self.expert_capacity(probs.shape[1]))
        own = ((idx[..., None] == pos[:, None, None, :])
               & valid[:, None, None, :]).float()  # [G, E, C, M]
        return own, torch.einsum("gecm,gme->gec", own, probs_own)

    def _block_forward(self, x, share, n_groups, train, rng, losses):
        """:meth:`forward` on this worker's tokens where a group spans
        workers: its sequence block of each row under sp, its rows of the
        global batch under the batch axes, or both (module docstring)."""
        axis = share.axis
        b, d_model = x.shape[0], x.shape[-1]
        s_local = math.prod(x.shape[1:-1])
        n_local = b * s_local
        e = self.num_experts
        lay = block_layout(b, s_local, share.n, share.i, n_groups, x.device, share.d,
                           share.D)
        tokens = x.reshape(n_local, d_model).to(self.dtype)
        logits = torch.einsum("nd,de->ne", tokens.float(), self.router.float())
        if self.router_noise > 0.0 and train:
            if rng is None:
                raise ValueError("router_noise > 0 in training needs rng (a "
                                 "torch.Generator), as flax needs the "
                                 "'router' rng")
            # The noise of this worker's rows and sequence block.
            logits = logits + self.router_noise * _router_noise(
                logits, rng, (b, s_local, e), [(1, share.i, share.n)] if share.n > 1 else ())
        probs = torch.softmax(logits, dim=-1)  # [n_local, E]
        if self.routing not in ("tokens", "experts"):
            raise ValueError(
                f"routing={self.routing!r} must be 'tokens' or 'experts'")
        whole = _gather_blocks(probs.detach(), axis, b, s_local, share.D).reshape(
            lay.groups, lay.gs, e)
        probs_own = _own(probs, lay)
        tokens_own = _own(tokens, lay)
        z = None
        if losses is not None:
            lse2 = (torch.logsumexp(logits, dim=-1) ** 2).sum()
            z = sum_shared(lse2, axis) / (n_local * axis.size)
        if self.routing == "experts":
            if self.top_k != 1:
                raise ValueError(
                    "expert-choice routing has no top_k (capacity_factor "
                    "sets each expert's token budget); leave top_k=1")
            own, gates = self.choose_block(whole, probs_own, lay.pos, lay.valid)
            self._sow(losses, torch.zeros((), dtype=torch.float32, device=x.device), z=z)
            expert_in = torch.einsum("gecm,gmd->gecd", own.to(self.dtype), tokens_own)
            out = self._apply_experts(expert_in)
            y = torch.einsum("gecm,gec,gecd->gmd", own.to(self.dtype),
                             gates.to(self.dtype), out)
        else:
            if not 1 <= self.top_k <= e:
                raise ValueError(
                    f"top_k={self.top_k} must be in [1, num_experts={e}]")
            dispatch, combine, _, onehot1 = self.route_block(whole, probs_own, lay.pos,
                                                             lay.valid)
            if losses is not None:
                frac = sum_shared(probs_own.sum(dim=1), axis) / lay.gs
                aux = e * torch.mean(torch.sum(onehot1.mean(dim=1) * frac, dim=-1))
                self._sow(losses, aux, z=z)
            expert_in = torch.einsum("gmec,gmd->gecd", dispatch.to(self.dtype), tokens_own)
            out = self._apply_experts(expert_in)
            y = torch.einsum("gmec,gecd->gmd", combine.to(self.dtype), out)
        return _local(y, lay).reshape(x.shape).to(x.dtype)

    @staticmethod
    def _z_loss(logits: torch.Tensor) -> torch.Tensor:
        """ST-MoE router z-loss: mean squared logsumexp of the logits."""
        return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    def _sow(self, losses: dict | None, aux: torch.Tensor, logits: torch.Tensor = None,
             z: torch.Tensor | None = None):
        if losses is None:
            return
        losses["moe_aux_loss"] = losses.get("moe_aux_loss", ()) + (aux,)
        losses["moe_router_z_loss"] = losses.get("moe_router_z_loss", ()) + (
            self._z_loss(logits) if z is None else z,)

    def _local_experts(self, index: int, size: int) -> tuple[torch.Tensor, ...]:
        """This worker's expert weights: the parameters as they are when
        they hold ``E / ep`` experts (a layout from the plan), else their
        ``index``-th block."""
        ws = (self.w1, self.b1, self.w2, self.b2)
        if size == 1 or self.w1.shape[0] * size == self.num_experts:
            return ws
        n = self.num_experts // size
        return tuple(w[index * n:(index + 1) * n] for w in ws)

    def _apply_experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """The per-expert FFN on expert-major ``[G, E, C, d]``, its
        activations exchanged over the ``ep`` group around the local
        experts when the mesh has one."""
        group, size, index = self._ep()
        w1, b1, w2, b2 = self._local_experts(index, size)
        g, e, c, d = expert_in.shape
        if group is not None:
            from torch.distributed.nn.functional import all_to_all_single

            # [G, E, C, d] -> [ep, G, E/ep, C, d]: chunk j goes to worker j.
            send = expert_in.reshape(g, size, e // size, c, d).transpose(0, 1).contiguous()
            expert_in = all_to_all_single(torch.empty_like(send), send, group=group)
            expert_in = expert_in.reshape(size * g, e // size, c, d)
        dt = self.dtype
        h = torch.einsum("gecd,edf->gecf", expert_in, w1.to(dt))
        h = F.gelu(h + b1[None, :, None, :].to(dt), approximate="tanh")
        out = torch.einsum("gecf,efd->gecd", h, w2.to(dt))
        out = out + b2[None, :, None, :].to(dt)
        if group is not None:
            from torch.distributed.nn.functional import all_to_all_single

            back = out.reshape(size, g, e // size, c, d).contiguous()
            out = all_to_all_single(torch.empty_like(back), back, group=group)
            out = out.transpose(0, 1).reshape(g, e, c, d)
        return out

    def _expert_choice(self, x, tokens, probs, logits, losses):
        """Expert-choice routing (Zhou et al. 2022): each expert takes its
        top-capacity tokens by router probability; the aux loss is sowed
        as 0, the z-loss on the raw logits."""
        every = _every_position(probs)
        onehot, gates = self.choose_block(probs, probs, every,
                                          torch.ones_like(every, dtype=torch.bool))
        self._sow(losses, torch.zeros((), dtype=torch.float32, device=x.device), logits)
        expert_in = torch.einsum("gecs,gsd->gecd", onehot.to(self.dtype), tokens)
        out = self._apply_experts(expert_in)
        y = torch.einsum("gecs,gec,gecd->gsd", onehot.to(self.dtype),
                         gates.to(self.dtype), out)
        return y.reshape(*x.shape[:-1], x.shape[-1]).to(x.dtype)


def _router_noise(logits: torch.Tensor, rng: torch.Generator, shape=None,
                  cuts=()) -> torch.Tensor:
    """Standard normal noise of the logits' shape from ``rng``, which is
    noted for CUDA-graph windows
    (:func:`~fluxmpi_tpu_torch.runtime.note_graph_generator`), so every
    replay of a captured window draws afresh. The noise is the global
    batch's, drawn whole, of which this worker keeps its block
    (:func:`~fluxmpi_tpu_torch._batch_parallel.draw`: its rows under the
    step's batch axes, its sequence block of ``shape``, the logits'
    ``[rows, tokens, experts]``, by ``cuts``)."""
    runtime.note_graph_generator(rng)
    noise = _batch_parallel.draw(
        lambda s: torch.randn(s, generator=rng, device=logits.device),
        logits.shape if shape is None else shape, cuts)
    return noise.reshape(logits.shape)


def _every_position(probs: torch.Tensor) -> torch.Tensor:
    """``[G, S]``: each token's position in its group, for the block
    routing of whole groups."""
    groups, gs = probs.shape[:2]
    return torch.arange(gs, device=probs.device).expand(groups, gs)


def _gather_blocks(x: torch.Tensor, axis, b: int, s_local: int, D: int = 1) -> torch.Tensor:
    """The group's rows ``[D * b, n * s_local, ...]`` from every member's
    ``x [b * s_local, ...]`` (forward only: ``x`` is detached), in the
    global batch's order: ``axis.ranks`` lists the members row block
    first, sequence block innermost."""
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    order = dist.get_process_group_ranks(axis.group)
    blocks = [parts[order.index(r)].reshape(b, s_local, *x.shape[1:]) for r in axis.ranks]
    n = len(blocks) // D
    return torch.cat([torch.cat(blocks[k * n:(k + 1) * n], dim=1) for k in range(D)])


class MoEEncoderBlock(EncoderBlock):
    """Pre-LN encoder block whose feed-forward sublayer is a
    :class:`MoEMLP` named ``moe``; ``decode=True`` decodes as
    :class:`~fluxmpi_tpu_torch.models.transformer.EncoderBlock` does (by
    default each decoded token is a group of its own)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float,
                 dtype: torch.dtype, attention_fn=None, decode: bool = False,
                 attention: str = "naive", attention_causal: bool = False,
                 ln_eps: float = 1e-6, num_experts: int = 8,
                 capacity_factor: float = 1.25, n_groups: int | None = None,
                 mesh: Any = None, ep_axis: str | None = None,
                 dp_axis: str | None = None, top_k: int = 1,
                 routing: str = "tokens", *, device=None,
                 generator: torch.Generator | None = None):
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.n_groups, self.top_k, self.routing = n_groups, top_k, routing
        self.mesh, self.ep_axis, self.dp_axis = mesh, ep_axis, dp_axis
        super().__init__(d_model, num_heads, d_ff, dropout, dtype, attention_fn,
                         decode, attention, attention_causal, ln_eps,
                         device=device, generator=generator)

    def make_ff(self) -> nn.Module:
        return MoEMLP(self.num_experts, self.d_ff, self.capacity_factor, self.dtype,
                      n_groups=self.n_groups, top_k=self.top_k, routing=self.routing,
                      mesh=self.mesh, ep_axis=self.ep_axis, dp_axis=self.dp_axis,
                      d_model=self.d_model, device=self._init.device,
                      generator=self._init.generator)


_MOE_FIELDS = ("num_experts", "capacity_factor", "n_groups", "mesh", "ep_axis",
               "dp_axis", "top_k", "routing")


class MoEEncoder(TransformerEncoder):
    """Encoder stack of :class:`MoEEncoderBlock`."""

    def __init__(self, num_layers: int = 4, d_model: int = 128, num_heads: int = 4,
                 d_ff: int = 512, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, attention_fn=None,
                 decode: bool = False, attention: str = "naive",
                 attention_causal: bool = False, ln_eps: float = 1e-6,
                 num_experts: int = 8, capacity_factor: float = 1.25,
                 n_groups: int | None = None, mesh: Any = None,
                 ep_axis: str | None = None, dp_axis: str | None = None,
                 top_k: int = 1, routing: str = "tokens", *, device=None,
                 generator: torch.Generator | None = None):
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.n_groups, self.top_k, self.routing = n_groups, top_k, routing
        self.mesh, self.ep_axis, self.dp_axis = mesh, ep_axis, dp_axis
        super().__init__(num_layers, d_model, num_heads, d_ff, dropout, dtype,
                         attention_fn, decode, attention, attention_causal, ln_eps,
                         device=device, generator=generator)

    def make_block(self, i: int) -> nn.Module:
        return MoEEncoderBlock(
            self.d_model, self.num_heads, self.d_ff, self.dropout, self.dtype,
            self.attention_fn, self.decode, self.attention, self.attention_causal,
            self.ln_eps, **{f: getattr(self, f) for f in _MOE_FIELDS},
            device=self.device, generator=self._generator)


class MoETransformerLM(TransformerLM):
    """Token LM where every block's feed-forward is a :class:`MoEMLP`
    (expert weights at ``encoder.block_i.moe.{w1,b1,w2,b2}``).
    ``routing="experts"`` warns: expert choice sees future positions, so
    it is not causal."""

    # Capacity-based routing can drop over-capacity tokens in a batched
    # prompt forward that one-token decoding never drops, so generate()'s
    # "auto" prefill keeps the scan for MoE.
    batched_prefill_safe = False

    def __init__(self, vocab_size: int = 1024, max_len: int = 512,
                 num_layers: int = 4, d_model: int = 128, num_heads: int = 4,
                 d_ff: int = 512, *, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, attention_fn=None,
                 decode: bool = False, attention: str = "naive",
                 ln_eps: float = 1e-6, num_experts: int = 8,
                 capacity_factor: float = 1.25, n_groups: int | None = None,
                 mesh: Any = None, ep_axis: str | None = None,
                 dp_axis: str | None = None, top_k: int = 1,
                 routing: str = "tokens", device=None,
                 generator: torch.Generator | None = None):
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.n_groups, self.top_k, self.routing = n_groups, top_k, routing
        self.mesh, self.ep_axis, self.dp_axis = mesh, ep_axis, dp_axis
        super().__init__(vocab_size, max_len, num_layers, d_model, num_heads, d_ff,
                         dropout=dropout, dtype=dtype, attention_fn=attention_fn,
                         decode=decode, attention=attention, ln_eps=ln_eps,
                         device=device, generator=generator)

    def make_encoder(self) -> nn.Module:
        if self.routing == "experts":
            warnings.warn(
                "MoETransformerLM with routing='experts': expert-choice "
                "routing is not causal (an expert's top-capacity token "
                "selection sees future positions) — next-token training "
                "losses are optimistic and autoregressive decoding routes "
                "differently. Intended for non-autoregressive objectives.",
                stacklevel=3,
            )
        return MoEEncoder(
            self.num_layers, self.d_model, self.num_heads, self.d_ff, self.dropout,
            self.dtype, self.attention_fn, self.decode, attention=self.attention,
            attention_causal=True, ln_eps=self.ln_eps,
            **{f: getattr(self, f) for f in _MOE_FIELDS},
            device=self.device, generator=self._generator)


def expert_parallel_rules(ep_axis: str | None = None):
    """Sharding rule laying the leading ``num_experts`` dimension of every
    MoE expert weight over the ``ep`` mesh axis (the router stays
    replicated). Compose with ``transformer_tp_rules``/``fsdp_rule`` via
    ``combine_rules``."""
    from ..parallel.sharding import P, rule_from_table

    ep = ep_axis or config.EP_AXIS_NAME
    return rule_from_table(
        [
            (r"moe/(w1|w2)$", P(ep, None, None)),
            (r"moe/(b1|b2)$", P(ep, None)),
        ]
    )
