"""Mixed-precision policies and dynamic loss scaling.

Counterpart of :mod:`fluxmpi_tpu.utils.precision`:

- :class:`Policy`: a (param, compute, output) dtype triple with cast
  helpers over trees. The canonical training policy is
  ``params=float32, compute=bfloat16, output=float32``: parameters and
  optimizer state stay f32 (an update increment sits below bf16's
  resolution at realistic learning rates), the matmuls run in bf16 on the
  tensor cores, and losses and logits come back in f32.
- :class:`DynamicLossScale`: scale the loss up before the backward,
  unscale the gradients, halve the scale on inf/nan and grow it back after
  a run of finite steps. bfloat16 does not need it (f32's exponent
  range); it is there for float16.

Casts touch floating-point leaves only: integer ids and bool masks pass
through untouched.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "DynamicLossScale",
    "Policy",
    "all_finite",
    "get_policy",
    "loss_scale_init",
]


def _is_float(x: Any) -> bool:
    if torch.is_tensor(x):
        return x.is_floating_point()
    if isinstance(x, np.ndarray):
        return np.issubdtype(x.dtype, np.floating)
    return isinstance(x, float)


def _cast_floating(tree: Any, dtype: torch.dtype | None) -> Any:
    if dtype is None:
        return tree
    return pytree.tree_map(
        lambda x: torch.as_tensor(x).to(dtype) if _is_float(x) else x, tree)


class Policy(NamedTuple):
    """(param, compute, output) dtype triple with tree cast helpers.

    ``None`` in a slot means "leave as is". :func:`get_policy` parses the
    string spelling (``"params=float32,compute=bfloat16,output=float32"``
    or the ``"bf16"``/``"f32"``/``"f16"`` shorthands).
    """

    param_dtype: torch.dtype | None = None
    compute_dtype: torch.dtype | None = None
    output_dtype: torch.dtype | None = None

    def cast_to_param(self, tree: Any) -> Any:
        """Float leaves → ``param_dtype`` (checkpoint and init layout)."""
        return _cast_floating(tree, self.param_dtype)

    def cast_to_compute(self, tree: Any) -> Any:
        """Float leaves → ``compute_dtype`` (entering the forward; the cast
        is differentiable, so gradients return in the leaves' dtype)."""
        return _cast_floating(tree, self.compute_dtype)

    def cast_to_output(self, tree: Any) -> Any:
        """Float leaves → ``output_dtype`` (leaving the forward)."""
        return _cast_floating(tree, self.output_dtype)


_SHORTHANDS = {
    "bf16": ("float32", "bfloat16", "float32"),
    "bfloat16": ("float32", "bfloat16", "float32"),
    "f32": ("float32", "float32", "float32"),
    "float32": ("float32", "float32", "float32"),
    "f16": ("float32", "float16", "float32"),
    "float16": ("float32", "float16", "float32"),
}


def _dtype(name: str) -> torch.dtype:
    """A dtype by its numpy name (what ``jnp.dtype`` accepts; bfloat16
    included). Raises ``TypeError`` for anything else."""
    if name == "bfloat16":
        return torch.bfloat16
    dt = getattr(torch, np.dtype(name).name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype for {name!r}")
    return dt


def get_policy(spec: str) -> Policy:
    """Parse ``"bf16"`` / ``"f32"`` / ``"f16"`` or the explicit
    ``"params=<dtype>,compute=<dtype>,output=<dtype>"`` form (any subset of
    the three keys; omitted slots mean "leave as is")."""
    spec = spec.strip().lower()
    if spec in _SHORTHANDS:
        return Policy(*(_dtype(n) for n in _SHORTHANDS[spec]))
    slots: dict[str, torch.dtype | None] = {
        "params": None, "compute": None, "output": None}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        key = key.strip()
        if not sep or key not in slots:
            raise ValueError(
                f"bad policy spec {spec!r}: expected 'params=<dtype>,"
                f"compute=<dtype>,output=<dtype>' (any subset) or one of "
                f"{sorted(set(_SHORTHANDS))}"
            )
        if slots[key] is not None:
            raise ValueError(f"bad policy spec {spec!r}: duplicate {key!r}")
        try:
            slots[key] = _dtype(value.strip())
        except TypeError as e:
            raise ValueError(
                f"bad policy spec {spec!r}: {value.strip()!r} is not a "
                f"dtype (use full numpy/jax names, e.g. 'bfloat16', "
                f"'float16', 'float32')"
            ) from e
    if all(v is None for v in slots.values()):
        raise ValueError(f"bad policy spec {spec!r}: no slots given")
    return Policy(slots["params"], slots["compute"], slots["output"])


def all_finite(tree: Any) -> torch.Tensor:
    """Scalar bool tensor: every float leaf is free of inf/nan."""
    leaves = [torch.isfinite(torch.as_tensor(x)).all()
              for x in pytree.tree_leaves(tree) if _is_float(x)]
    if not leaves:
        return torch.tensor(True)
    dev = leaves[0].device
    return torch.stack([t.to(dev) for t in leaves]).all()


class DynamicLossScale(NamedTuple):
    """Loss-scale state, tensors only. Per step::

        scaled_loss = ls.scale_loss(loss)      # before the backward
        grads = ls.unscale(grads)              # after
        finite = all_finite(grads)
        ls = ls.adjust(finite)                 # halve on overflow, grow
        # apply the update only where `finite`

    Growth doubles the scale after ``growth_interval`` consecutive finite
    steps; an overflow halves it and resets the counter. The scale stays
    in ``[1, 2**24]``.
    """

    scale: torch.Tensor            # f32 scalar
    counter: torch.Tensor          # i32 scalar: consecutive finite steps
    growth_interval: torch.Tensor  # i32 scalar

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        # In f32: an f16 loss would overflow at scale >= 2**16.
        return torch.as_tensor(loss).float() * self.scale

    def unscale(self, tree: Any) -> Any:
        inv = (1.0 / self.scale).float()

        def un(g):
            if not _is_float(g):
                return g
            g = torch.as_tensor(g)
            return (g.float() * inv).to(g.dtype)

        return pytree.tree_map(un, tree)

    def adjust(self, grads_finite: torch.Tensor) -> "DynamicLossScale":
        finite = torch.as_tensor(grads_finite, device=self.scale.device)
        counter = torch.where(finite, self.counter + 1, 0)
        grow = counter >= self.growth_interval
        grown = torch.where(grow, self.scale * 2.0, self.scale)
        counter = torch.where(grow, 0, counter)
        scale = torch.where(finite, grown, self.scale * 0.5)
        scale = scale.clamp(1.0, 2.0 ** 24)
        return DynamicLossScale(scale=scale.float(),
                                counter=counter.to(torch.int32),
                                growth_interval=self.growth_interval)


def loss_scale_init(initial: float = 2.0 ** 15,
                    growth_interval: int = 2000) -> DynamicLossScale:
    """A fresh :class:`DynamicLossScale` (start at 2^15, double after 2000
    clean steps)."""
    if initial < 1:
        raise ValueError(f"initial scale must be >= 1, got {initial}")
    if growth_interval < 1:
        raise ValueError(f"growth_interval must be >= 1, got {growth_interval}")
    return DynamicLossScale(
        scale=torch.tensor(float(initial), dtype=torch.float32),
        counter=torch.tensor(0, dtype=torch.int32),
        growth_interval=torch.tensor(int(growth_interval), dtype=torch.int32),
    )
