"""The port's public callables take the JAX package's arguments, by the
same names, in the same positional order, with the same literal defaults.

For every name that a module of the port exports (its ``__all__``) and the
counterpart module of the JAX package exports too (its ``__all__``, or its
public attributes where it has none), every JAX call must be a valid port
call: the JAX positional parameters come in the same order, every JAX
keyword is accepted by name, a default given by both is the same literal,
and the port adds no parameter of its own. The allow-list holds only:

- the port's deliberate extras: ``device=`` (torch places tensors on a
  device, JAX on a mesh) and ``generator=`` (torch draws weights from a
  generator, flax from a PRNG key), ``init(timeout=)``, the
  ``torch.distributed`` process group's timeout, and ``in_features=`` of
  ``MLP``, ``CNN``, ``ResNet`` (and its blocks), ``DEQ``, ``ViT`` and
  ``UNet``, and ``image_size=`` of ``ViT`` and ``UNet`` (a torch module is
  built with its shapes; flax infers the input width, the position
  table's length and where the UNet's attention blocks sit at the first
  call);
- the TPU-only arguments ``block_q``, ``block_k``, ``interpret``,
  ``mesh`` and ``axis_name`` where the port does not take them (the port
  has no Pallas tiling and no device mesh; its sync-BN models take
  ``axis_name``, which is then compared);
- the arguments that the port takes through ``**waiting`` and still
  refuses with ``NotImplementedError``, each named in ``REFUSED`` (and
  shown to raise). Arguments that the port spells as parameters but
  refuses when set are named in ``REFUSED_WHEN_SET`` and shown to raise
  too;
- flax's own module fields (``parent``, ``name``; also through a
  ``functools.partial`` such as ``ResNet50``) and the flax ``params``
  beside a ``model`` where the port leaves it out: a torch module holds
  its own weights (where the port takes it, as ``ddpm_loss`` and
  ``ddim_sample`` do to run a model with other weights such as the EMA's,
  it is compared).
"""

from __future__ import annotations

import functools
import importlib
import inspect
import time

import pytest

flax_linen = pytest.importorskip("flax.linen")

MODULES = ["", ".comm", ".config", ".data", ".errors", ".faults", ".logging",
           ".optimizer", ".runtime", ".sync", ".models", ".models.cnn", ".models.deq",
           ".models.generate", ".models.resnet", ".models.transformer",
           ".models.unet", ".models.vit",
           ".ops", ".ops.flash_attention", ".ops.fused_ce", ".parallel",
           ".parallel.loop", ".parallel.train", ".serving", ".serving.cache",
           ".serving.engine", ".utils", ".utils.checkpoint", ".utils.ema",
           ".utils.manifest", ".utils.precision"]
# Public callables the JAX module defines but leaves out of its __all__,
# compared all the same: (module, name).
UNLISTED = [(".models.transformer", "EncoderBlock")]

EXTRAS = {"device", "generator"}
TPU_ONLY = {"block_q", "block_k", "interpret", "mesh", "axis_name"}
FLAX_FIELDS = {"parent", "name"}
# Port-only parameters beyond EXTRAS, by callable.
PORT_ONLY = {"init": {"timeout"},
             **{name: {"in_features"} for name in (
                 "MLP", "CNN", "DEQ", "ResNet", "ResNet18", "ResNet34", "ResNet50",
                 "ResNet101", "BottleneckBlock", "BasicBlock")},
             **{name: {"in_features", "image_size"} for name in ("ViT", "UNet")}}
# Arguments the port takes through **waiting and refuses, by callable.
REFUSED = {
    "init": {"devices", "mesh_shape", "parallel", "distributed", "telemetry",
             "trace", "watchdog", "preemption", "faults", "goodput", "anomaly",
             "model_stats", "compileplane", "memory", "profile",
             "compile_cache", "export", "serving", "request_log", "fleet",
             "resize"},
    "make_train_step": {"parallel", "style", "donate",
                        "state_sharding", "batch_spec", "metrics",
                        "model_stats"},
    "make_eval_step": {"parallel", "state_sharding", "batch_spec"},
}
# Parameters the port spells as the JAX package does but refuses with
# NotImplementedError when set: (module, callable) -> {argument: a value}.
REFUSED_WHEN_SET = {
    (".serving.engine", "ServingRequest"): {"clock": time.monotonic},
    (".serving.engine", "InferenceEngine"): {
        "max_len": 64, "slo_ttft_s": 1.0, "slo_token_s": 0.1, "registry": object(),
        "clock": time.monotonic, "flush_every": 4, "check_memory": False,
        "attention": "flash"},
    (".models.transformer", "TransformerLM"): {"decode": True},
    (".models.transformer", "TransformerEncoder"): {"decode": True},
    (".models.transformer", "EncoderBlock"): {"decode": True},
    (".models.generate", "generate"): {"temperature": 0.7, "top_k": 4, "top_p": 0.9,
                                       "prefill": "scan"},
}
# The smallest positional arguments each of them takes.
_REFUSED_ARGS = {"ServingRequest": ([1], 1), "InferenceEngine": (None,),
                 "TransformerLM": (), "TransformerEncoder": (),
                 "EncoderBlock": (32, 4, 64, 0.0, None), "generate": (None, [[1]], 1)}
LITERALS = (type(None), bool, int, float, str)


def _exports(module, port: bool) -> set[str]:
    names = getattr(module, "__all__", None)
    if names is None and not port:
        names = [n for n in dir(module) if not n.startswith("_")]
    return set(names or ())


def _pairs():
    seen = set()
    for suffix in MODULES:
        port = importlib.import_module("fluxmpi_tpu_torch" + suffix)
        ref = importlib.import_module("fluxmpi_tpu" + suffix)
        for name in sorted(_exports(port, True) & _exports(ref, False)):
            p, r = getattr(port, name), getattr(ref, name)
            if inspect.ismodule(p) or not callable(p) or not callable(r):
                continue
            if (id(p), id(r)) in seen:
                continue
            seen.add((id(p), id(r)))
            yield f"{suffix or '.'}:{name}", name, p, r
    for suffix, name in UNLISTED:
        p = getattr(importlib.import_module("fluxmpi_tpu_torch" + suffix), name)
        r = getattr(importlib.import_module("fluxmpi_tpu" + suffix), name)
        yield f"{suffix}:{name}", name, p, r


PAIRS = list(_pairs())


def test_the_comparison_covers_the_ported_surface():
    names = {name for _, name, _, _ in PAIRS}
    for expected in ("init", "synchronize", "allreduce", "barrier",
                     "DistributedDataLoader", "make_train_step", "train_loop",
                     "RequestRejectedError", "InferenceEngine", "generate",
                     "restore_checkpoint", "CheckpointManager",
                     "flash_attention", "TransformerLM",
                     # Slice 5: the rest of the FluxMPI surface and the
                     # vision models.
                     "Request", "iallreduce", "ibcast", "host_allreduce",
                     "host_allgather", "host_bcast", "cpu", "device",
                     "local_device_count", "TopologyMismatchError",
                     "FluxModelWrapper", "FlatParamVector", "load_preference",
                     "set_preference", "delete_preference",
                     "disable_device_collectives", "env_int", "CNN", "ResNet",
                     "ResNet18", "ResNet34", "ResNet50", "ResNet101",
                     "BottleneckBlock", "BasicBlock", "DEQ", "fixed_point_solve",
                     # Slice 6: the zoo's ViT and UNet through the flash
                     # kernels' attention_fn hook, and the EMA.
                     "TransformerEncoder", "EncoderBlock", "flash_attention_fn", "ViT",
                     "UNet", "cosine_beta_schedule", "ddpm_loss", "ddim_sample",
                     "EMAState", "ema_init", "ema_update", "ema_params"):
        assert expected in names, expected
    assert len(PAIRS) >= 60


def _mismatches(name, port, ref):
    try:
        sp, sr = inspect.signature(port), inspect.signature(ref)
    except (TypeError, ValueError):
        return []
    pp, rp = dict(sp.parameters), dict(sr.parameters)
    var_kw = any(p.kind is p.VAR_KEYWORD for p in pp.values())
    # A TPU-only argument that the port does take (axis_name of the
    # sync-BN models) is compared like any other.
    skip = {n for n in TPU_ONLY if n not in pp}
    base = ref.func if isinstance(ref, functools.partial) else ref
    if inspect.isclass(base) and issubclass(base, flax_linen.Module):
        skip |= FLAX_FIELDS
    rnames = list(rp)
    if rnames[:2] == ["model", "params"] and "params" not in pp:
        skip.add("params")
    out = []
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ref_pos = [n for n in rnames if rp[n].kind in positional and n not in skip]
    port_pos = [n for n, p in pp.items() if p.kind in positional]
    if port_pos != ref_pos[:len(port_pos)]:
        out.append(f"positional order {port_pos} vs {ref_pos}")
    for n, r in rp.items():
        if n in skip or r.kind in (r.VAR_POSITIONAL, r.VAR_KEYWORD):
            continue
        p = pp.get(n)
        if p is None:
            if not (var_kw and n in REFUSED.get(name, ())):
                out.append(f"missing {n}")
            continue
        if p.kind is p.POSITIONAL_ONLY and r.kind is not r.POSITIONAL_ONLY:
            out.append(f"{n} is positional-only")
        if r.default is not r.empty and p.default is p.empty:
            out.append(f"{n} has no default (JAX: {r.default!r})")
        elif (r.default is not r.empty and isinstance(r.default, LITERALS)
              and isinstance(p.default, LITERALS) and p.default != r.default):
            out.append(f"{n} default {p.default!r} vs {r.default!r}")
    for n, p in pp.items():
        if n in rp or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if n not in EXTRAS | PORT_ONLY.get(name, set()):
            out.append(f"port-only {n}")
        elif p.default is p.empty:
            out.append(f"port-only {n} has no default")
    return out


@pytest.mark.parametrize("where,name,port,ref", PAIRS, ids=[w for w, *_ in PAIRS])
def test_signature_matches_the_jax_package(where, name, port, ref):
    assert _mismatches(name, port, ref) == []


def test_refused_arguments_raise_not_implemented():
    import fluxmpi_tpu_torch as tfm
    from fluxmpi_tpu_torch.parallel import make_eval_step, make_train_step
    from fluxmpi_tpu_torch.parallel import train as ttrain

    assert REFUSED["init"] <= set(tfm.runtime._WAITING)
    assert REFUSED["make_train_step"] | REFUSED["make_eval_step"] <= set(ttrain._WAITING)
    for arg in sorted(REFUSED["init"]):
        with pytest.raises(NotImplementedError, match=arg):
            tfm.init(device="cpu", **{arg: object()})
    assert not tfm.is_initialized()
    for arg in sorted(REFUSED["make_train_step"]):
        with pytest.raises(NotImplementedError, match=arg):
            make_train_step(lambda p, s, b: (None, s), None, **{arg: object()})
    for arg in sorted(REFUSED["make_eval_step"]):
        with pytest.raises(NotImplementedError, match=arg):
            make_eval_step(lambda p, s, b: None, **{arg: object()})


def test_the_two_spellings_that_differed():
    """``synchronize(tree, ...)`` and ``RequestRejectedError(reject_reason)``
    with the JAX package's message."""
    import fluxmpi_tpu as jfm
    import fluxmpi_tpu_torch as tfm

    assert list(inspect.signature(tfm.synchronize).parameters)[0] == "tree"
    port = tfm.errors.RequestRejectedError(reject_reason="queue_full")
    ref = jfm.errors.RequestRejectedError(reject_reason="queue_full")
    assert str(port) == str(ref) == "request rejected (queue_full)"
    assert port.reject_reason == ref.reject_reason == "queue_full"


@pytest.mark.parametrize("where,name,arg", [
    (where, name, arg) for (where, name), args in REFUSED_WHEN_SET.items()
    for arg in args])
def test_parameters_refused_when_set(where, name, arg):
    """Each argument of ``REFUSED_WHEN_SET`` is a parameter of the port's
    callable with the JAX package's default, and setting it raises
    ``NotImplementedError`` naming it (before any other work: no world,
    model or device is needed)."""
    fn = getattr(importlib.import_module("fluxmpi_tpu_torch" + where), name)
    ref = getattr(importlib.import_module("fluxmpi_tpu" + where), name)
    assert arg in inspect.signature(fn).parameters
    assert arg in inspect.signature(ref).parameters
    with pytest.raises(NotImplementedError, match=arg):
        fn(*_REFUSED_ARGS[name], **{arg: REFUSED_WHEN_SET[(where, name)][arg]})
