"""Diffusion UNet (DDPM) with its objective and sampler.

Counterpart of :mod:`fluxmpi_tpu.models.unet`: NHWC images, bf16 compute
with f32 GroupNorm and an f32 output head; downsampling is a strided 3x3
convolution, upsampling a nearest 2x resize and a convolution; attention
blocks over the flattened spatial grid at the sides listed in
``attn_resolutions`` (and one in the middle) take the ``attention_fn`` hook,
so :func:`~fluxmpi_tpu_torch.ops.flash_attention_fn` drops in as it does
for the transformers. ``conv2`` of every :class:`ResBlock`, the attention
blocks' ``out`` kernels and ``conv_out`` are zero-initialised, so the
model starts by predicting zero. Names and layouts are flax's
(``down0_block0.conv1.kernel`` HWIO, ``mid_attn.attn.query.kernel``,
``gn_out.scale``, ...).

:func:`ddpm_loss` (epsilon or velocity prediction at uniformly drawn
timesteps), :func:`cosine_beta_schedule` and :func:`ddim_sample` as in JAX.
Their random draws come from a ``torch.Generator`` (the JAX key's place);
each draw is one helper (:func:`_ddpm_draws`, :func:`_ddim_noise`). A CUDA
generator that a loss draws from inside ``train_loop``'s CUDA-graph windows
is registered with the graph (``runtime.note_graph_generator``), so every
replay draws afresh, as the pipelined updates do.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .. import _batch_parallel, runtime
from ..runtime import resolve_device
from ._layers import Conv, Dense, GroupNorm, MultiHeadDotProductAttention, _Init, zeros_init

__all__ = ["AttnBlock", "ResBlock", "UNet", "cosine_beta_schedule", "ddim_sample",
           "ddpm_loss", "timestep_embedding"]


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embeddings of integer timesteps, ``[B] -> [B, dim]``, in
    f32 whatever the model's dtype."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, a per-channel (scale, shift) from the time
    embedding after the second GroupNorm, SiLU -> zero-initialised conv,
    and a 1x1 ``skip`` conv where the channels change. NCHW in and out."""

    def __init__(self, in_features: int, channels: int, groups: int, dtype, *,
                 temb_features: int, init: _Init):
        super().__init__()
        c = channels
        self.channels, self.dtype = c, dtype
        self.gn1 = GroupNorm(groups, in_features, init=init)
        self.conv1 = Conv(in_features, c, (3, 3), init=init, dtype=dtype, use_bias=True)
        self.temb_proj = Dense((temb_features, 2 * c), (2 * c,), init, temb_features)
        self.gn2 = GroupNorm(groups, c, init=init)
        self.conv2 = Conv(c, c, (3, 3), init=init, dtype=dtype, use_bias=True,
                          kernel_init=zeros_init)
        if in_features != c:
            self.skip = Conv(in_features, c, (1, 1), init=init, dtype=dtype, use_bias=True)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        c = self.channels
        h = F.silu(self.gn1(x)).to(self.dtype)
        h = self.conv1(h)
        ss = self.temb_proj(F.silu(temb.to(torch.float32)), torch.float32)
        scale, shift = ss[:, :c, None, None], ss[:, c:, None, None]
        h = self.gn2(h) * (1.0 + scale) + shift
        h = self.conv2(F.silu(h).to(self.dtype))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class AttnBlock(nn.Module):
    """Self-attention over the flattened spatial grid (tokens = H*W, NHWC
    order), its ``out`` kernel zero-initialised. NCHW in and out."""

    def __init__(self, channels: int, num_heads: int, groups: int, dtype,
                 attention_fn: Callable | None, *, init: _Init):
        super().__init__()
        self.dtype = dtype
        self.gn = GroupNorm(groups, channels, init=init)
        self.attn = MultiHeadDotProductAttention(num_heads, channels, init=init,
                                                 dtype=dtype, attention_fn=attention_fn,
                                                 out_kernel_init=zeros_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.gn(x).to(self.dtype).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.attn(h)
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(x, 2x, "nearest")`` on NCHW: each pixel repeated
    twice along H and W (expand + reshape, so the backward is a plain sum,
    the same bits on every run)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


class UNet(nn.Module):
    """DDPM UNet over NHWC images; ``forward(x, t)`` predicts the per-pixel
    noise (or velocity), f32 ``[b, H, W, out_channels]``.

    ``channel_mults`` sets the stages (the side halves between them),
    ``attn_resolutions`` the sides with attention blocks. A torch module is
    built with its shapes, where flax infers them at the first call:
    ``in_features`` (image channels) and ``image_size`` (the side, which
    decides where attention blocks sit). Weights from the CPU
    ``generator`` (default seeded with 0) on ``device`` (default CUDA;
    ``"cpu"`` only when asked)."""

    def __init__(self, out_channels: int = 3, base_channels: int = 64,
                 channel_mults: Sequence[int] = (1, 2, 4), blocks_per_stage: int = 2,
                 attn_resolutions: Sequence[int] = (8,), num_heads: int = 4,
                 groups: int = 8, dtype: torch.dtype = torch.float32,
                 attention_fn: Callable | None = None, *, in_features: int = 3,
                 image_size: int = 32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        init = _Init(self.device, generator or torch.Generator().manual_seed(0))
        self.dtype, self.image_size = dtype, image_size
        self.channel_mults = tuple(channel_mults)
        self.blocks_per_stage = blocks_per_stage
        ch = self.base_channels = base_channels
        conv = dict(init=init, dtype=dtype, use_bias=True)

        def res(name, cin, c):
            self.add_module(name, ResBlock(cin, c, groups, dtype, temb_features=4 * ch,
                                           init=init))

        def attn(name, c):
            self.add_module(name, AttnBlock(c, num_heads, groups, dtype, attention_fn,
                                            init=init))

        self.temb1 = Dense((ch, 4 * ch), (4 * ch,), init, ch)
        self.temb2 = Dense((4 * ch, 4 * ch), (4 * ch,), init, 4 * ch)
        self.conv_in = Conv(in_features, ch, (3, 3), **conv)
        # The layout, in call order: (kind, name) for the forward to walk.
        self.plan: list[tuple[str, str]] = []
        side, width, skips = image_size, ch, [ch]
        for i, mult in enumerate(self.channel_mults):
            c = ch * mult
            for j in range(blocks_per_stage):
                res(f"down{i}_block{j}", width, c)
                self.plan.append(("res", f"down{i}_block{j}"))
                width = c
                if side in attn_resolutions:
                    attn(f"down{i}_attn{j}", c)
                    self.plan.append(("attn", f"down{i}_attn{j}"))
                self.plan.append(("push", ""))
                skips.append(c)
            if i != len(self.channel_mults) - 1:
                self.add_module(f"down{i}_downsample", Conv(c, c, (3, 3), (2, 2), **conv))
                self.plan += [("conv", f"down{i}_downsample"), ("push", "")]
                skips.append(c)
                side //= 2
        c_mid = ch * self.channel_mults[-1]
        res("mid_block1", width, c_mid)
        attn("mid_attn", c_mid)
        res("mid_block2", c_mid, c_mid)
        self.plan += [("res", "mid_block1"), ("attn", "mid_attn"), ("res", "mid_block2")]
        width = c_mid
        for i, mult in reversed(list(enumerate(self.channel_mults))):
            c = ch * mult
            for j in range(blocks_per_stage + 1):
                self.plan.append(("pop", ""))
                res(f"up{i}_block{j}", width + skips.pop(), c)
                self.plan.append(("res", f"up{i}_block{j}"))
                width = c
                if side in attn_resolutions:
                    attn(f"up{i}_attn{j}", c)
                    self.plan.append(("attn", f"up{i}_attn{j}"))
            if i != 0:
                self.add_module(f"up{i}_upsample", Conv(c, c, (3, 3), **conv))
                self.plan += [("up", ""), ("conv", f"up{i}_upsample")]
                side *= 2
        assert not skips
        self.gn_out = GroupNorm(groups, width, init=init)
        self.conv_out = Conv(width, out_channels, (3, 3), init=init, dtype=torch.float32,
                             use_bias=True, kernel_init=zeros_init)

    def forward(self, x, t) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        if x.ndim != 4:
            raise ValueError(f"expected NHWC images, got shape {tuple(x.shape)}")
        if tuple(x.shape[1:3]) != (self.image_size, self.image_size):
            raise ValueError(f"this UNet was built for {self.image_size}x"
                             f"{self.image_size} images, got {tuple(x.shape[1:3])}")
        temb = timestep_embedding(torch.as_tensor(t, device=self.device),
                                  self.base_channels)
        temb = self.temb1(temb, torch.float32)
        temb = self.temb2(F.silu(temb), torch.float32)
        h = self.conv_in(x.permute(0, 3, 1, 2).to(self.dtype))
        skips = [h]
        for kind, name in self.plan:
            if kind == "res":
                h = getattr(self, name)(h, temb)
            elif kind in ("attn", "conv"):
                h = getattr(self, name)(h)
            elif kind == "push":
                skips.append(h)
            elif kind == "pop":
                h = torch.cat([h, skips.pop()], dim=1)  # NHWC's last axis
            else:
                h = _upsample2x(h)
        h = F.silu(self.gn_out(h)).to(self.dtype)
        # f32 head, zero-initialised: the model starts by predicting 0.
        return self.conv_out(h).permute(0, 2, 3, 1)


def cosine_beta_schedule(timesteps: int, s: float = 0.008, *, device=None) -> torch.Tensor:
    """Nichol & Dhariwal's cosine schedule: per-step betas ``[T]``, f32,
    computed on the CPU and placed on ``device`` (default CUDA)."""
    steps = torch.arange(timesteps + 1, dtype=torch.float32) / timesteps
    alpha_bar = torch.cos((steps + s) / (1.0 + s) * math.pi / 2) ** 2
    betas = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
    return torch.clamp(betas, 0.0, 0.999).to(resolve_device(device))


def _alpha_bars(betas: torch.Tensor) -> torch.Tensor:
    return torch.cumprod(1.0 - betas, dim=0)


def _check_generator(rng: torch.Generator, device: torch.device) -> None:
    """A generator must draw on the batch's device; a CUDA one is noted for
    the CUDA graph being captured around the loss, which a CPU one cannot
    join (its draws would be fixed at capture)."""
    if rng.device.type != device.type or (
            device.type == "cuda" and rng.device.index not in (None, device.index)):
        raise ValueError(f"rng draws on {rng.device}, the batch lies on {device}: "
                         f"pass a torch.Generator(device=...) of the batch's device")
    runtime.note_graph_generator(rng)


def _ddpm_draws(rng: torch.Generator, b: int, timesteps: int, shape, device):
    """The loss's random draws: timesteps ``[b]`` uniform in ``[0, T)``
    (int64) and the noise ``shape`` (f32 standard normal). Under the
    step's batch axes both are the global batch's, drawn whole in that
    order, and this worker keeps its rows
    (:func:`~fluxmpi_tpu_torch._batch_parallel.draw`)."""
    tsteps = _batch_parallel.draw(
        lambda s: torch.randint(0, timesteps, s, generator=rng, device=device), (b,))
    eps = _batch_parallel.draw(
        lambda s: torch.randn(s, generator=rng, dtype=torch.float32, device=device), shape)
    return tsteps, eps


def _apply(model: nn.Module, params, *args):
    """``model``'s forward with ``params`` (a dict keyed by state-dict
    name, as a ``TrainState`` or :func:`~fluxmpi_tpu_torch.utils.ema_params`
    holds them) in place of its own."""
    return functional_call(model, params, args)


def ddpm_loss(model: nn.Module, params, batch: torch.Tensor, rng: torch.Generator,
              betas: torch.Tensor, *, pred_type: str = "eps") -> torch.Tensor:
    """Diffusion MSE at uniformly drawn timesteps (scalar f32).

    ``batch`` is NHWC in [-1, 1]; ``rng`` a ``torch.Generator`` on the
    batch's device (each call draws afresh, as JAX's example folds the
    step into its key); ``params`` the model's parameters by state-dict
    name. All schedule math is f32. ``pred_type``: ``"eps"`` predicts the
    added noise, ``"v"`` the velocity ``sqrt(ab)·eps − sqrt(1−ab)·x0``;
    train and sample with the same one."""
    if pred_type not in ("eps", "v"):
        raise ValueError(f"pred_type must be 'eps' or 'v', got {pred_type!r}")
    batch = torch.as_tensor(batch)
    _check_generator(rng, batch.device)
    tsteps, eps = _ddpm_draws(rng, batch.shape[0], betas.shape[0], batch.shape,
                              batch.device)
    return _ddpm_loss_from(model, params, batch, tsteps, eps, betas, pred_type)


def _ddpm_loss_from(model, params, batch, tsteps, eps, betas, pred_type="eps"):
    """:func:`ddpm_loss` given its draws."""
    x0 = batch.to(torch.float32)
    ab = _alpha_bars(betas.to(x0.device))[tsteps][:, None, None, None]
    x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    target = eps if pred_type == "eps" else torch.sqrt(ab) * eps - torch.sqrt(1.0 - ab) * x0
    pred = _apply(model, params, x_t, tsteps)
    return torch.mean((pred.to(torch.float32) - target) ** 2)


def _ddim_noise(rng: torch.Generator, shape, device) -> torch.Tensor:
    """One of the sampler's draws: f32 standard normal of ``shape``."""
    return torch.randn(shape, generator=rng, dtype=torch.float32, device=device)


def ddim_sample(model: nn.Module, params, rng: torch.Generator, *,
                shape: tuple[int, ...], betas: torch.Tensor, num_steps: int = 50,
                eta: float = 0.0, clip_x0: float | None = 1.0,
                pred_type: str = "eps") -> torch.Tensor:
    """Deterministic (``eta=0``) or stochastic DDIM sampler over
    ``num_steps`` timesteps subsampled from ``T-1`` down to 0, no host read
    inside the loop. Returns f32 NHWC samples of ``shape`` in model space.
    ``clip_x0`` clamps each step's x0 estimate to ``[-clip_x0, clip_x0]``
    (``None``: no clamp) and recomputes eps from it; ``pred_type`` as the
    model was trained (``"v"`` converts the output to eps first). The
    first draw is the starting noise, then one per step when ``eta > 0``,
    all from ``rng`` (a generator on the model's device)."""
    if pred_type not in ("eps", "v"):
        raise ValueError(f"pred_type must be 'eps' or 'v', got {pred_type!r}")
    T = betas.shape[0]
    if not 1 <= num_steps <= T:
        raise ValueError(f"num_steps must be in [1, {T}], got {num_steps}")
    dev = betas.device
    ab = _alpha_bars(betas)
    ts = torch.linspace(T - 1, 0, num_steps, dtype=torch.float32).round().to(torch.int64)
    ab_t = ab[ts.to(dev)]
    ab_prev = torch.cat([ab[ts[1:].to(dev)], torch.ones((1,), dtype=torch.float32,
                                                        device=dev)])
    _check_generator(rng, dev)
    x = _ddim_noise(rng, shape, dev)
    with torch.no_grad():
        for i in range(num_steps):
            a_t, a_p = ab_t[i], ab_prev[i]
            t_vec = torch.full((shape[0],), int(ts[i]), dtype=torch.int64, device=dev)
            out = _apply(model, params, x, t_vec).to(torch.float32)
            eps = torch.sqrt(a_t) * out + torch.sqrt(1.0 - a_t) * x if pred_type == "v" \
                else out
            x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            if clip_x0 is not None:
                x0 = torch.clamp(x0, -clip_x0, clip_x0)
                eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
            sigma = eta * torch.sqrt((1.0 - a_p) / (1.0 - a_t) * (1.0 - a_t / a_p))
            dir_xt = torch.sqrt(torch.clamp_min(1.0 - a_p - sigma ** 2, 0.0)) * eps
            x = torch.sqrt(a_p) * x0 + dir_xt
            if eta:
                x = x + sigma * _ddim_noise(rng, shape, dev)
    return x
