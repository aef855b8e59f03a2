"""Deep Equilibrium Model with implicit gradients (BASELINE config 4).

Counterpart of :mod:`fluxmpi_tpu.models.deq`: an implicit layer whose
output is the fixed point ``z* = f(params, x, z*)``, found by one of three
solvers (``"damped"`` iteration, ``"anderson"`` acceleration, limited-memory
good ``"broyden"``) and differentiated by the implicit-function theorem, not
by unrolling: :func:`fixed_point_solve` is a ``torch.autograd.Function``
whose backward solves the adjoint fixed point ``u = v + (df/dz)^T u`` with
the same solver (each step one vector-Jacobian product of ``f`` at ``z*``)
and pulls ``u*`` back through ``params`` and ``x``. The autograd graph of a
solve is one node whatever the number of iterations.

**Stopping on the device.** The JAX solvers are ``lax.while_loop``s that
stop once the batch-global residual ``max|z - prev|`` (Broyden:
``max|f(z) - z|``) is at most ``tol``. Here each solver runs its full
``max_iter`` trip on the device and, once the residual is at most ``tol``,
freezes its iterate with ``torch.where``: the same ``z*`` as the early
exit, and no value is read back to the host, so a DEQ step can run inside
``train_loop(fuse="auto")``'s CUDA graph (a loop that read the residual
with ``.item()`` each iteration would sync the host every iteration and
could not be captured). The price is ``max_iter`` evaluations of ``f`` per
solve whatever the convergence. Anderson's per-sample ``[n, m, m]`` ridge
solve is ``torch.linalg.solve_ex`` without its error check (the check reads
the device).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..runtime import resolve_device
from ._layers import lecun_normal
from .transformer import Dense, _Init

__all__ = ["DEQ", "fixed_point_solve"]


def _damped_iteration(g: Callable, z0: torch.Tensor, tol: float, max_iter: int,
                      damping: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``z <- (1 - damping) z + damping g(z)`` until ``max|z - prev| <=
    tol`` or ``max_iter`` evaluations. Returns ``(z*, iterations)``."""
    z = (1.0 - damping) * z0 + damping * g(z0)
    prev = z0
    iters = torch.ones((), dtype=torch.int64, device=z0.device)
    for _ in range(max_iter - 1):
        active = (z - prev).abs().max() > tol
        z_new = (1.0 - damping) * z + damping * g(z)
        z, prev = torch.where(active, z_new, z), torch.where(active, z, prev)
        iters = iters + active
    return z, iters


def _flatten_batched(g: Callable, z0: torch.Tensor):
    """``z`` viewed as ``[n, d]`` f32 (batched over the leading axis), and
    ``g`` wrapped to match. Returns ``(gf, z0_flat, unflatten)``."""
    shape = z0.shape
    n = shape[0] if z0.ndim > 1 else 1

    def gf(zf):
        return g(zf.reshape(shape)).reshape(n, -1).float()

    def unflatten(zf):
        return zf.reshape(shape).to(z0.dtype)

    return gf, z0.reshape(n, -1).float(), unflatten


def _anderson_iteration(g: Callable, z0: torch.Tensor, tol: float, max_iter: int,
                        m: int = 5, beta: float = 1.0, ridge: float = 1e-8):
    """Anderson acceleration (type II) of ``g``: the last ``m`` iterates and
    residuals, extrapolation weights from a regularized per-sample least
    squares (one batched ``[n, m, m]`` solve). The history is seeded with
    up to ``min(m, max_iter)`` plain iterations (``max_iter`` bounds all
    evaluations); unfilled slots hold a huge residual, so they get ~zero
    weight. Returns ``(z*, iterations)``."""
    gf, z, unflatten = _flatten_batched(g, z0)
    n, d = z.shape
    dev = z.device
    m_seed = min(m, int(max_iter))
    Z = torch.zeros((m, n, d), device=dev)
    F = torch.full((m, n, d), 1e6, device=dev)
    res = torch.full((), float("inf"), device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    # Once the residual is at most tol the iterate freezes; what the
    # history holds from then on never reaches it.
    for it in range(m_seed):
        active = res > tol
        gz = gf(z)
        f = gz - z
        Z[it], F[it] = z, f
        # A plain step: |z_new - z| is the fixed-point residual |f|.
        z, res = torch.where(active, gz, z), torch.where(active, f.abs().max(), res)
        iters = iters + active
    eye = torch.eye(m, device=dev)
    ones = torch.ones((n, m, 1), device=dev)
    for it in range(m_seed, int(max_iter)):
        active = res > tol
        gz = gf(z)
        f = gz - z
        Z[it % m], F[it % m] = z, f
        # Per-sample normal equations G a = 1, alpha = a / sum(a): the
        # constrained least squares min |sum alpha_i F_i|, sum alpha = 1.
        Fs = F.transpose(0, 1)  # [n, m, d]
        G = torch.einsum("nid,njd->nij", Fs, Fs)
        trace = G.diagonal(dim1=1, dim2=2).sum(-1)
        G = G + ridge * (1.0 + trace)[:, None, None] * eye
        alpha = torch.linalg.solve_ex(G, ones, check_errors=False)[0][..., 0]
        alpha = alpha / alpha.sum(1, keepdim=True)
        z_new = torch.einsum("nm,nmd->nd", alpha, Z.transpose(0, 1) + beta * Fs)
        res = torch.where(active, (z_new - z).abs().max(), res)
        z = torch.where(active, z_new, z)
        iters = iters + active
    return unflatten(z), iters


def _broyden_iteration(g: Callable, z0: torch.Tensor, tol: float, max_iter: int,
                       m: int = 8):
    """Limited-memory good-Broyden root solve of ``g(z) - z = 0``: the
    inverse-Jacobian estimate ``B = -I + sum u_i v_i^T`` held as two
    ``[m, n, d]`` histories, reset to ``B = -I`` when the window fills
    (each stored pair was computed against every earlier one, so dropping
    the oldest would break the secant conditions). Returns ``(z*,
    iterations)``."""
    gf, z, unflatten = _flatten_batched(g, z0)
    n, d = z.shape

    def b_apply(U, V, x):  # B x = -x + sum_i u_i (v_i . x)
        return -x + torch.einsum("mnd,mn->nd", U, torch.einsum("mnd,nd->mn", V, x))

    def bt_apply(U, V, x):  # B^T x = -x + sum_i v_i (u_i . x)
        return -x + torch.einsum("mnd,mn->nd", V, torch.einsum("mnd,nd->mn", U, x))

    F = gf(z) - z
    U = torch.zeros((m, n, d), device=z.device)
    V = torch.zeros((m, n, d), device=z.device)
    iters = torch.ones((), dtype=torch.int64, device=z.device)
    for it in range(1, int(max_iter)):
        active = F.abs().max() > tol
        dz = -b_apply(U, V, F)
        z_new = z + dz
        F_new = gf(z_new) - z_new
        dF = F_new - F
        slot = (it - 1) % m
        if slot == 0 and it > 1:
            # Window full: reset to B = -I before the secant update.
            U, V = torch.zeros_like(U), torch.zeros_like(V)
        bdf = b_apply(U, V, dF)
        denom = (dz * bdf).sum(1, keepdim=True)
        safe = denom.abs() > 1e-12
        u = torch.where(safe, (dz - bdf) / torch.where(safe, denom, 1.0), 0.0)
        v = torch.where(safe, bt_apply(U, V, dz), 0.0)
        U[slot], V[slot] = u, v
        z, F = torch.where(active, z_new, z), torch.where(active, F_new, F)
        iters = iters + active
    return unflatten(z), iters


def _solve(g, z0, tol, max_iter, damping, solver, anderson_m, anderson_beta):
    if solver == "damped":
        return _damped_iteration(g, z0, tol, max_iter, damping)
    if solver == "anderson":
        return _anderson_iteration(g, z0, tol, max_iter, m=anderson_m, beta=anderson_beta)
    if solver == "broyden":
        return _broyden_iteration(g, z0, tol, max_iter, m=anderson_m)
    raise ValueError(f"unknown solver {solver!r} (damped | anderson | broyden)")


class _FixedPoint(torch.autograd.Function):
    """``z*`` of ``f(params, x, z) = z``; the backward is the implicit
    gradient (the adjoint solved with the same solver)."""

    @staticmethod
    def forward(ctx, f, spec, opts, x, z0, *leaves):
        params = pytree.tree_unflatten(list(leaves), spec)
        with torch.no_grad():
            z, _ = _solve(lambda z: f(params, x, z), z0, *opts)
        ctx.f, ctx.spec, ctx.opts = f, spec, opts
        ctx.save_for_backward(x, z, *leaves)
        return z

    @staticmethod
    def backward(ctx, v):
        x, z, *leaves = ctx.saved_tensors
        f, spec, opts = ctx.f, ctx.spec, ctx.opts
        with torch.enable_grad():
            ps = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
            xx = x.detach().requires_grad_(x.is_floating_point())
            zz = z.detach().requires_grad_()
            params = pytree.tree_unflatten(ps, spec)
            fz = f(params, xx, zz)

            def adjoint_map(u):
                # u = v + (df/dz)^T u: one vector-Jacobian product per step.
                vjp = torch.autograd.grad(fz, zz, u.to(fz.dtype), retain_graph=True)[0]
                return v + vjp

            with torch.no_grad():
                u, _ = _solve(adjoint_map, v, *opts)
            wrt = [t for t in [xx, *ps] if t.requires_grad]
            grads = iter(torch.autograd.grad(fz, wrt, u.to(fz.dtype), allow_unused=True))
        gx, *gps = [next(grads) if t.requires_grad else None for t in [xx, *ps]]
        return (None, None, None, gx, None, *gps)


def fixed_point_solve(f: Callable, params: Any, x: torch.Tensor, z0: torch.Tensor,
                      tol: float, max_iter: int, damping: float,
                      solver: str = "damped", anderson_m: int = 5,
                      anderson_beta: float = 1.0) -> torch.Tensor:
    """Solve ``z = f(params, x, z)`` from ``z0``.

    ``solver="damped"`` iterates ``z <- (1 - damping) z + damping f(z)``;
    ``"anderson"`` runs Anderson acceleration with history ``anderson_m``
    and mixing ``anderson_beta``; ``"broyden"`` runs limited-memory good
    Broyden on ``f(z) - z`` (window ``anderson_m``). ``params`` is a tree
    of tensors. Gradients reach ``params`` and ``x`` by the implicit
    function theorem, the adjoint solved with the same solver; ``z0`` gets
    none."""
    leaves, spec = pytree.tree_flatten(params)
    opts = (tol, int(max_iter), damping, solver, anderson_m, anderson_beta)
    return _FixedPoint.apply(f, spec, opts, x, z0, *leaves)


def _cell(params, x, z):
    W, U, b = params
    return torch.tanh(z @ W + x @ U + b)


class DEQ(nn.Module):
    """Single-cell DEQ: ``z* = tanh(W z* + U x + b)`` followed by a Dense
    head. ``W ~ N(0, 1) * 0.25 / sqrt(hidden)`` (so the iteration
    contracts), ``U`` lecun-normal, ``b`` zero, as in the JAX package.
    Weights from the CPU ``generator`` (default seeded with 0) on
    ``device`` (default CUDA; ``"cpu"`` only when asked); ``in_features``
    is the input width (flax infers it)."""

    def __init__(self, hidden: int = 64, out: int = 1, tol: float = 1e-4,
                 max_iter: int = 50, damping: float = 0.7, solver: str = "damped",
                 anderson_m: int = 5, anderson_beta: float = 1.0, *,
                 in_features: int = 1, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.device = resolve_device(device)
        init = _Init(self.device, generator or torch.Generator().manual_seed(0))
        self.hidden, self.out = hidden, out
        self.opts = (tol, int(max_iter), damping, solver, anderson_m, anderson_beta)
        self.W = init.normal((hidden, hidden), 0.25 / math.sqrt(hidden))
        self.U = lecun_normal(init, (in_features, hidden), in_features)
        self.b = init.fill((hidden,), 0.0)
        self.head = Dense((hidden, out), (out,), init, hidden)

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        z0 = torch.zeros((*x.shape[:-1], self.hidden), dtype=x.dtype, device=x.device)
        z = fixed_point_solve(_cell, (self.W, self.U, self.b), x, z0, *self.opts)
        return self.head(z, torch.float32)
