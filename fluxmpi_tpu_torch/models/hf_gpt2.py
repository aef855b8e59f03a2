"""Import HuggingFace GPT-2 checkpoints into :class:`TransformerLM`
(counterpart of :mod:`fluxmpi_tpu.models.hf_gpt2`).

:func:`lm_from_gpt2` reads ``hf_model.config`` and
``hf_model.state_dict()`` only, so any object with those two (a
``transformers.GPT2LMHeadModel``, pretrained or random, or a plain
namespace carrying the same keys) converts; ``transformers`` is never
imported. The architectures line up:

- pre-LN blocks, final LayerNorm, learned positions, weight-tied head;
- GPT-2's ``gelu_new`` is the tanh-approximate GELU the LM uses;
- HF ``Conv1D`` stores weights ``[in, out]``, the Dense kernel
  orientation, so the MLP weights copy as they are; the fused ``c_attn``
  ``[d, 3d]`` splits into the ``query/key/value`` kernels ``[d, heads,
  head_dim]`` and ``c_proj`` reshapes to the ``out`` kernel ``[heads,
  head_dim, d]``;
- GPT-2's LayerNorm epsilon rides in ``TransformerLM(ln_eps=)``.

The converted tree must name exactly the model's own parameters with
their shapes (the drift guard), so a future mismatch between the two
architectures fails at conversion, not as silently wrong logits.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .convert import load_flax_params
from .transformer import TransformerLM

__all__ = ["lm_from_gpt2"]


def lm_from_gpt2(hf_model, *, device=None) -> tuple[TransformerLM, dict]:
    """Convert a ``GPT2LMHeadModel`` (or anything with its ``config`` and
    ``state_dict()``) to ``(TransformerLM, {"params": ...})``.

    The model is the float32 configuration on ``device`` (default CUDA)
    with the converted weights loaded, and the checkpoint's
    ``resid_pdrop`` carried into its ``dropout`` field (0.1 on stock GPT-2;
    ``TransformerLM`` has one rate, so an ``embd_pdrop``/``attn_pdrop``
    that differs from it converts with a ``UserWarning``). Inference
    (``train=False``, ``generate``, the serving engine) ignores the rate;
    fine-tuning passes ``TransformerLM.forward(dropout_rng=)``.
    ``variables`` is the flax-layout tree (numpy float32 leaves) that
    :func:`~fluxmpi_tpu_torch.models.load_flax_params` takes, so
    ``model, variables = lm_from_gpt2(hf)`` reads as in the JAX package.
    For bf16 compute, build ``TransformerLM(dtype=torch.bfloat16, ...)``
    with the same fields and load ``variables`` into it.

    Raises ``ValueError`` for a config knob the mapping does not cover,
    and when the converted tree disagrees with the model's own parameter
    names or shapes (the drift guard).
    """
    cfg = hf_model.config
    # The mapping assumes GPT-2's stock computation; shape checks cannot
    # catch these knobs, so they are refused by name.
    unsupported = {
        "activation_function": (
            getattr(cfg, "activation_function", "gelu_new"),
            ("gelu_new", "gelu_pytorch_tanh")),
        "tie_word_embeddings": (getattr(cfg, "tie_word_embeddings", True), (True,)),
        "scale_attn_weights": (getattr(cfg, "scale_attn_weights", True), (True,)),
        "scale_attn_by_inverse_layer_idx": (
            getattr(cfg, "scale_attn_by_inverse_layer_idx", False), (False,)),
        "reorder_and_upcast_attn": (
            getattr(cfg, "reorder_and_upcast_attn", False), (False,)),
    }
    for knob, (value, allowed) in unsupported.items():
        if value not in allowed:
            raise ValueError(
                f"lm_from_gpt2 supports stock GPT-2 computation only: "
                f"config.{knob}={value!r} (supported: {allowed})")
    sd = {k: np.asarray(v.detach().cpu().float().numpy())
          for k, v in hf_model.state_dict().items()}
    d, heads = int(cfg.n_embd), int(cfg.n_head)
    if d % heads:
        raise ValueError(f"n_embd {d} not divisible by n_head {heads}")
    hd = d // heads
    d_ff = int(cfg.n_inner) if getattr(cfg, "n_inner", None) else 4 * d
    # One dropout rate here, three there: carry resid_pdrop and say which
    # rates it cannot represent.
    dropout = float(getattr(cfg, "resid_pdrop", 0.0) or 0.0)
    mismatched = {
        knob: float(rate)
        for knob in ("embd_pdrop", "attn_pdrop")
        if (rate := float(getattr(cfg, knob, 0.0) or 0.0)) != dropout
    }
    if mismatched:
        warnings.warn(
            f"TransformerLM has a single dropout rate; using "
            f"resid_pdrop={dropout} and ignoring "
            + ", ".join(f"{k}={v}" for k, v in sorted(mismatched.items())),
            stacklevel=2)
    model = TransformerLM(
        vocab_size=int(cfg.vocab_size), max_len=int(cfg.n_positions),
        num_layers=int(cfg.n_layer), d_model=d, num_heads=heads, d_ff=d_ff,
        dropout=dropout, dtype=torch.float32,
        ln_eps=float(cfg.layer_norm_epsilon), device=device)

    def ln(prefix: str) -> dict:
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    enc: dict = {}
    for i in range(int(cfg.n_layer)):
        p = f"transformer.h.{i}"
        qw, kw, vw = np.split(sd[f"{p}.attn.c_attn.weight"], 3, axis=1)  # [d, 3d]
        qb, kb, vb = np.split(sd[f"{p}.attn.c_attn.bias"], 3)
        enc[f"block_{i}"] = {
            "ln1": ln(f"{p}.ln_1"),
            "attn": {
                "query": {"kernel": qw.reshape(d, heads, hd), "bias": qb.reshape(heads, hd)},
                "key": {"kernel": kw.reshape(d, heads, hd), "bias": kb.reshape(heads, hd)},
                "value": {"kernel": vw.reshape(d, heads, hd), "bias": vb.reshape(heads, hd)},
                "out": {"kernel": sd[f"{p}.attn.c_proj.weight"].reshape(heads, hd, d),
                        "bias": sd[f"{p}.attn.c_proj.bias"]},
            },
            "ln2": ln(f"{p}.ln_2"),
            "ff1": {"kernel": sd[f"{p}.mlp.c_fc.weight"], "bias": sd[f"{p}.mlp.c_fc.bias"]},
            "ff2": {"kernel": sd[f"{p}.mlp.c_proj.weight"],
                    "bias": sd[f"{p}.mlp.c_proj.bias"]},
        }
    enc["ln_out"] = ln("transformer.ln_f")
    params = {"embed": {"embedding": sd["transformer.wte.weight"]},
              "pos_embed": sd["transformer.wpe.weight"], "encoder": enc}

    # Drift guard: the converted tree must name the model's own parameters
    # with their shapes (load_flax_params refuses anything else).
    try:
        load_flax_params(model, params)
    except ValueError as exc:
        raise ValueError(f"converted GPT-2 tree does not match TransformerLM's "
                         f"parameters: {exc}") from None
    return model, {"params": params}
