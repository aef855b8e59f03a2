"""Optimizer rules with optax's arithmetic.

The JAX package and its tests train with optax; these are the port's own
versions of the rules they use, as ``(init, update)`` pairs over a dict of
parameter tensors, the shape of an optax ``GradientTransformation``:

- ``init(params) -> state``;
- ``update(grads, state, params) -> (updates, state)``: the step to add
  to each parameter (:func:`apply_updates` adds it in place). The state's
  tensors are updated in place and the same state is returned.

The arithmetic follows optax step for step, so a parity test can hold
the port to it: ``adam`` is ``scale_by_adam`` (bias-corrected moments, the
corrections ``1 - b ** count`` computed in f32 from the step count) then
``-lr``; ``adamw``
adds ``weight_decay * param`` to the Adam direction before the ``-lr``
scale (optax's ``add_decayed_weights``, not torch's decoupled
``lr * wd`` form); ``sgd`` is ``trace(decay=momentum)`` then ``-lr``.
The per-tensor arithmetic runs as PyTorch's multi-tensor ``_foreach``
ops, one launch per op for the whole parameter list. The step count is an
int32 tensor on the parameters' device (optax's ``count``), advanced in
place, and the bias corrections are computed from it on the device: an
update reads nothing back to the host, so a CUDA graph that captured it
advances the count on every replay.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["GradientTransformation", "adam", "adamw", "apply_updates", "sgd"]


class GradientTransformation(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple[dict, Any]]


def apply_updates(params: dict, updates: dict) -> dict:
    """``param += update`` in place, for every key; returns ``params``."""
    keys = list(params)
    with torch.no_grad():
        torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])
    return params


def _f32_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count`` computed in f32 on the count's device, as
    optax's bias correction computes it."""
    return 1 - torch.pow(decay, count.float())


def _zeros_like(p: torch.Tensor) -> torch.Tensor:
    """A zero moment of ``p``: a placed block's moment keeps its layout tag,
    so a sharded checkpoint records it as the block it is."""
    from .parallel.sharding import sharding_of, with_sharding

    return with_sharding(torch.zeros_like(p), sharding_of(p))


def _adam(learning_rate: float, b1: float, b2: float, eps: float,
          weight_decay: float | None) -> GradientTransformation:
    def init(params):
        device = next(iter(params.values())).device if params else None
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: _zeros_like(p) for k, p in params.items()},
            "nu": {k: _zeros_like(p) for k, p in params.items()},
        }

    def update(grads, state, params=None):
        keys = list(grads)
        g = [grads[k] for k in keys]
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        with torch.no_grad():
            c = state["count"]
            c.add_(1)
            # mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            mu_hat = torch._foreach_div(mu, _f32_correction(b1, c))
            nu_hat = torch._foreach_div(nu, _f32_correction(b2, c))
            den = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(mu_hat, den)
            if weight_decay:
                if params is None:
                    raise ValueError("adamw's update needs the params")
                torch._foreach_add_(upd, [params[k] for k in keys],
                                    alpha=weight_decay)
            torch._foreach_mul_(upd, -learning_rate)
        return dict(zip(keys, upd)), state

    return GradientTransformation(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam."""
    return _adam(learning_rate, b1, b2, eps, None)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: the Adam direction plus ``weight_decay * param``, all
    scaled by ``-learning_rate`` (decay applied to every parameter)."""
    return _adam(learning_rate, b1, b2, eps, weight_decay)


def sgd(learning_rate: float,
        momentum: float | None = None) -> GradientTransformation:
    """optax.sgd: with ``momentum``, ``trace = g + momentum * trace``, then
    ``-lr``."""

    def init(params):
        if not momentum:
            return {}
        return {"trace": {k: _zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        keys = list(grads)
        g = [grads[k] for k in keys]
        with torch.no_grad():
            if momentum:
                g = [state["trace"][k] for k in keys]
                torch._foreach_mul_(g, momentum)
                torch._foreach_add_(g, [grads[k] for k in keys])
            upd = torch._foreach_mul(g, -learning_rate)
        return dict(zip(keys, upd)), state

    return GradientTransformation(init, update)
