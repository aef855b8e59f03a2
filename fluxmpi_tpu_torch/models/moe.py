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
"""

from __future__ import annotations

import math
import warnings
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .. import config
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

    def forward(self, x: torch.Tensor, *, train: bool = True,
                rng: torch.Generator | None = None, losses: dict | None = None):
        *lead, d_model = x.shape
        n_tokens = math.prod(lead)
        if self.n_groups is not None:
            groups = self.n_groups
            if n_tokens % groups:
                raise ValueError(
                    f"n_groups {groups} must divide token count {n_tokens}")
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
            logits = logits + self.router_noise * torch.randn(
                logits.shape, generator=rng, device=logits.device)
        probs = torch.softmax(logits, dim=-1)  # [G, S, E]
        if self.routing not in ("tokens", "experts"):
            raise ValueError(
                f"routing={self.routing!r} must be 'tokens' or 'experts'")
        if self.routing == "experts":
            if self.top_k != 1:
                raise ValueError(
                    "expert-choice routing has no top_k (capacity_factor "
                    "sets each expert's token budget); leave top_k=1")
            return self._expert_choice(x, tokens, probs, logits, gs, losses)
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

    def route(self, probs: torch.Tensor):
        """Token-choice routing of router probabilities ``[G, S, E]``:
        ``(dispatch, combine, topk_idx, first_onehot)``, dispatch and
        combine ``[G, S, E, C]`` f32. Every first choice claims expert
        capacity before any second choice."""
        groups, gs, e = probs.shape
        capacity = self.capacity(gs)
        _, topk_idx = _top_k(probs, self.top_k)  # [G, S, K]
        gates = torch.gather(probs, -1, topk_idx)
        if self.top_k > 1:
            # GShard: the kept gates renormalized over the chosen experts.
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        dispatch = combine = onehot1 = None
        counts = torch.zeros((groups, 1, e), dtype=torch.float32, device=probs.device)
        for choice in range(self.top_k):
            onehot = _one_hot(topk_idx[..., choice], e)  # [G, S, E]
            if onehot1 is None:
                onehot1 = onehot
            # Position in the expert's buffer: earlier choices' totals
            # offset this choice's group-local cumsum.
            pos = (torch.cumsum(onehot, dim=1) - 1.0 + counts) * onehot
            kept = (pos < capacity) & (onehot > 0)
            d = _one_hot(pos.to(torch.int32), capacity) * kept[..., None].float()
            dispatch = d if dispatch is None else dispatch + d
            dc = d * gates[..., choice, None, None]
            combine = dc if combine is None else combine + dc
            counts = counts + onehot.sum(dim=1, keepdim=True)
        return dispatch, combine, topk_idx, onehot1

    @staticmethod
    def _z_loss(logits: torch.Tensor) -> torch.Tensor:
        """ST-MoE router z-loss: mean squared logsumexp of the logits."""
        return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    def _sow(self, losses: dict | None, aux: torch.Tensor, logits: torch.Tensor):
        if losses is None:
            return
        losses["moe_aux_loss"] = losses.get("moe_aux_loss", ()) + (aux,)
        losses["moe_router_z_loss"] = losses.get("moe_router_z_loss", ()) + (
            self._z_loss(logits),)

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

    def _expert_choice(self, x, tokens, probs, logits, gs, losses):
        """Expert-choice routing (Zhou et al. 2022): each expert takes its
        top-capacity tokens by router probability; the aux loss is sowed
        as 0, the z-loss on the raw logits."""
        e = self.num_experts
        capacity = min(gs, max(1, int(-(-gs * self.capacity_factor // e))))
        scores = probs.transpose(1, 2)  # [G, E, S]
        gates, idx = _top_k(scores, capacity)  # [G, E, C]
        onehot = _one_hot(idx, gs)  # [G, E, C, S]
        self._sow(losses, torch.zeros((), dtype=torch.float32, device=x.device), logits)
        expert_in = torch.einsum("gecs,gsd->gecd", onehot.to(self.dtype), tokens)
        out = self._apply_experts(expert_in)
        y = torch.einsum("gecs,gec,gecd->gsd", onehot.to(self.dtype),
                         gates.to(self.dtype), out)
        return y.reshape(*x.shape[:-1], x.shape[-1]).to(x.dtype)


class MoEEncoderBlock(EncoderBlock):
    """Pre-LN encoder block whose feed-forward sublayer is a
    :class:`MoEMLP` named ``moe``."""

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
            self.attention_fn, False, self.attention, self.attention_causal,
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
            self.dtype, self.attention_fn, attention=self.attention,
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
