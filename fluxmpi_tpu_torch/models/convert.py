"""Convert parameters between the JAX package and the port.

The port's modules keep flax's parameter names and layouts, so the
conversion is a copy both ways: the flax path
``encoder/block_0/attn/query/kernel`` is the state-dict key
``encoder.block_0.attn.query.kernel``, with the same shape.
:func:`load_flax_params` copies a JAX parameter tree in (any missing,
extra or mis-shaped leaf raises); :func:`to_flax_params` gives the port's
parameters (or gradients keyed like them) back as numpy arrays keyed by
flax path, so tests compare the two leaf by leaf.

Models with BatchNorm (:class:`~fluxmpi_tpu_torch.models.CNN`,
:class:`~fluxmpi_tpu_torch.models.ResNet`) carry flax's two collections:
the BatchNorm ``scale``/``bias`` are parameters, and ``batch_stats``
(``mean``, ``var``) is the model state, a dict keyed like the parameters
(``bn_0.mean``). :func:`load_flax_variables` takes ``{"params",
"batch_stats"}`` and gives the model (its parameters copied in) and its
model state; :func:`to_flax_variables` is its inverse. Conv kernels keep
flax's HWIO layout, so they copy as they are.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["load_flax_params", "load_flax_variables", "to_flax_params",
           "to_flax_variables"]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict:
    """``{"params": {...}}`` (or the inner dict) of array leaves →
    ``{"a/b/c": numpy array}``."""
    if prefix == "" and set(tree) == {"params"}:
        tree = tree["params"]
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def load_flax_params(model: torch.nn.Module, params: Mapping[str, Any]):
    """Copy a JAX model's parameter tree ``params`` (numpy or any array
    leaves, keyed by flax paths: ``TransformerLM``, ``TransformerEncoder``,
    ``ViT``, ``UNet``, ...) into the port's ``model`` in place; returns
    ``model``."""
    flat = {p.replace("/", "."): a for p, a in _flatten(params).items()}
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError(
            f"parameter trees differ: missing {missing}, unexpected {extra}"
        )
    bad = [
        f"{name}: {tuple(arr.shape)} vs {tuple(own[name].shape)}"
        for name, arr in flat.items() if tuple(arr.shape) != tuple(own[name].shape)
    ]
    if bad:
        raise ValueError("mis-shaped parameters: " + "; ".join(bad))
    with torch.no_grad():
        for name, arr in flat.items():
            own[name].copy_(torch.from_numpy(np.array(arr, np.float32)))
    return model


def to_flax_params(tree) -> dict[str, np.ndarray]:
    """``{"a/b/c": numpy array}`` for a module's parameters, or for any
    mapping keyed by state-dict names (``"a.b.c"``), such as the gradients
    a train step computes. Arrays are f32 copies on the host."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    return {
        name.replace(".", "/"): t.detach().float().cpu().numpy().copy()
        for name, t in tree.items()
    }


def load_flax_variables(model: torch.nn.Module, variables: Mapping[str, Any]):
    """Copy a flax variable dict ``{"params": ..., "batch_stats": ...}``
    into ``model`` (parameters, in place) and its model state; returns
    ``(model, model_state)``, the state's f32 tensors on the model's
    device, keyed like :meth:`init_batch_stats` gives them (any missing,
    extra or mis-shaped statistic raises)."""
    load_flax_params(model, variables["params"])
    own = model.init_batch_stats()
    flat = {p.replace("/", "."): a
            for p, a in _flatten(variables.get("batch_stats", {})).items()}
    if set(flat) != set(own):
        raise ValueError(f"batch_stats differ: missing {sorted(set(own) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(own))}")
    state = {}
    for name, ref in own.items():
        if tuple(flat[name].shape) != tuple(ref.shape):
            raise ValueError(f"mis-shaped statistic {name}: {tuple(flat[name].shape)} "
                             f"vs {tuple(ref.shape)}")
        state[name] = torch.from_numpy(np.array(flat[name], np.float32)).to(ref.device)
    return model, state


def to_flax_variables(model: torch.nn.Module, model_state: Mapping[str, Any]) -> dict:
    """``{"params": {"a/b": array}, "batch_stats": {"a/b/mean": array}}``
    for ``model``'s parameters and a model state of its BatchNorms, f32
    numpy copies keyed by flax path."""
    return {"params": to_flax_params(model),
            "batch_stats": to_flax_params(dict(model_state))}
