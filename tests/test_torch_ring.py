"""Ring, zigzag and Ulysses attention in real 2- and 4-rank gloo worlds (the
ranks run ``tests/_torch_seq_worker.py`` group ``ring``, each world spawned
once and running all of its cases), held to the JAX package's
``fluxmpi_tpu.parallel.ring``/``ulysses`` under ``shard_map`` over as many
of its 8 CPU devices, from the same numpy inputs:

- ``make_ring_attention`` (contiguous and zigzag) and
  ``make_ulysses_attention``, dense and flash, causal and not, with
  segment ids, grouped-query K/V and windows {3, 12, 100}: the global
  output and the gradients of q, k and v of ``sum(out * cot)`` on every
  rank. A port flash case is held to the JAX package's ring of the same
  configuration: the flash ring itself (interpret-mode kernels) for the
  windowed (band-only ticks) and zigzag cases, else its dense ring, which
  computes the same function;
- the flash dropout cases with equal seeds against JAX's flash ring with
  the same seed (interpret-mode kernels), so the folded per-attend seeds
  and the kernels' masks must equal JAX's;
- the merged lse of the port's ring schedules against JAX's
  whole-sequence ``flash_attention_with_lse``;
- ``ulysses_attention`` called on the blocks with segment ids (and
  grouped K/V), and an
  encoder with ``ring_attention_fn`` against JAX's dense encoder;
- the refusals (same messages), and the unbound-axis fallback of the
  three layers in one process against JAX's outside ``shard_map``.

Tolerances (f32): outputs and lse max|Δ| 3e-5, gradients 1e-4, as the
reference's own tests hold its ring against dense attention.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from _torch_worlds import join_world, start_world

OUT_ATOL = 3e-5
GRAD_ATOL = 1e-4
B, S, H, HKV, DH = 2, 32, 4, 2, 16

torch.set_num_threads(1)


def _case(kind, qkv="", seg=False, refused=False, **kw):
    return dict(kind=kind, qkv=qkv, seg=seg, refused=refused, kw=kw)


RING = "ring"
CASES = {
    4: {
        "ring_dense": _case(RING),
        "ring_dense_causal": _case(RING, causal=True),
        "ring_flash": _case(RING, use_flash=True),
        "ring_flash_causal": _case(RING, causal=True, use_flash=True),
        "ring_seg_dense_causal": _case(RING, seg=True, causal=True),
        "ring_seg_flash": _case(RING, seg=True, use_flash=True),
        "ring_seg_flash_causal": _case(RING, seg=True, causal=True, use_flash=True),
        "ring_gqa_dense_causal": _case(RING, qkv="_gqa", causal=True),
        "ring_gqa_flash": _case(RING, qkv="_gqa", use_flash=True),
        "ring_window_dense_12": _case(RING, causal=True, window=12),
        "ring_window_flash_3": _case(RING, causal=True, use_flash=True, window=3),
        "ring_window_flash_12": _case(RING, causal=True, use_flash=True, window=12),
        "ring_window_flash_100": _case(RING, causal=True, use_flash=True, window=100),
        "ring_window_flash_gqa": _case(RING, qkv="_gqa", causal=True, use_flash=True,
                                       window=9),
        "zigzag_dense": _case(RING, causal=True, schedule="zigzag"),
        "zigzag_flash": _case(RING, causal=True, schedule="zigzag", use_flash=True),
        "zigzag_seg_flash": _case(RING, seg=True, causal=True, schedule="zigzag",
                                  use_flash=True),
        "zigzag_gqa_flash": _case(RING, qkv="_gqa", causal=True, schedule="zigzag",
                                  use_flash=True),
        "ulysses_dense": _case("ulysses"),
        "ulysses_flash_causal": _case("ulysses", causal=True, use_flash=True),
        "ulysses_window_flash": _case("ulysses", causal=True, use_flash=True, window=12),
        "ulysses_gqa_refused": _case("ulysses", qkv="_gqa", refused=True, causal=True),
        "ulysses_blocks_seg": _case("ulysses_blocks", seg=True, causal=True),
        "ring_flash_dropout": _case(RING, use_flash=True, dropout_rate=0.3,
                                    dropout_seed=77),
        "ring_window_flash_dropout": _case(RING, causal=True, use_flash=True, window=20,
                                           dropout_rate=0.3, dropout_seed=78),
        "zigzag_flash_dropout": _case(RING, causal=True, schedule="zigzag",
                                      use_flash=True, dropout_rate=0.2, dropout_seed=5),
        "ulysses_flash_dropout": _case("ulysses", causal=True, use_flash=True,
                                       dropout_rate=0.2, dropout_seed=5),
        "lse_ring_causal": _case("lse", causal=True),
        "lse_ring_window": _case("lse", causal=True, window=12),
        "lse_zigzag": _case("lse", zigzag=True),
        "encoder": _case("encoder", axis_name="sp"),
    },
    2: {
        "ring_dense_causal": _case(RING, causal=True),
        "ring_flash_causal": _case(RING, causal=True, use_flash=True),
        "ring_window_flash_12": _case(RING, causal=True, use_flash=True, window=12),
        "zigzag_flash": _case(RING, causal=True, schedule="zigzag", use_flash=True),
        "ulysses_flash_causal": _case("ulysses", causal=True, use_flash=True),
        "ulysses_gqa": _case("ulysses", qkv="_gqa", causal=True),
        "ulysses_blocks_seg_gqa": _case("ulysses_blocks", qkv="_gqa", seg=True,
                                        use_flash=True),
        "lse_ring_window": _case("lse", causal=True, window=12),
    },
}
# Port flash cases of the 4-rank world held to JAX's flash ring
# (interpret-mode kernels); the rest of the flash cases to JAX's dense
# ring of the same configuration.
JAX_FLASH = {"ring_window_flash_12", "zigzag_flash", "ring_flash_dropout",
             "ring_window_flash_dropout", "zigzag_flash_dropout",
             "ulysses_flash_dropout"}
OUTPUT_CASES = [(n, c) for n in (4, 2) for c, s in CASES[n].items()
                if s["kind"] in (RING, "ulysses", "ulysses_blocks") and not s["refused"]]


def _segments():
    seg = np.zeros((B, S), np.int32)
    seg[0, :10], seg[0, 10:24] = 1, 2  # two documents, then padding
    seg[1, :20], seg[1, 20:] = 1, 3
    return seg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from fluxmpi_tpu.models import TransformerEncoder as JaxEncoder
    from fluxmpi_tpu.parallel.ring import zigzag_indices

    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    d = dict(q=arr(B, S, H, DH), k=arr(B, S, H, DH), v=arr(B, S, H, DH),
             q_gqa=arr(B, S, H, DH), k_gqa=arr(B, S, HKV, DH), v_gqa=arr(B, S, HKV, DH),
             cot=arr(B, S, H, DH), seg=_segments(), enc_x=arr(2, S, 32))
    enc = JaxEncoder(num_layers=2, d_model=32, num_heads=4, d_ff=64)
    enc_params = enc.init(jax.random.PRNGKey(0), jnp.asarray(d["enc_x"]),
                          train=False)["params"]
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(enc_params)[0]}
    paths = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"ring{n}") / "data.npz"
        np.savez(path, **d, zigzag_idx=zigzag_indices(S, n),
                 cases=np.array(json.dumps(CASES[n])),
                 **{f"enc/{k}": v for k, v in flat.items()})
        paths[n] = path
    return dict(d, enc_params=enc_params, paths=paths)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data):
    """Each rank's results in the 4- and the 2-rank world (both run at
    once, beside the JAX references)."""
    started = {n: start_world("ring", tmp_path_factory.mktemp(f"ringworld{n}"), n,
                              data["paths"][n]) for n in (4, 2)}
    return {n: join_world(*started[n]) for n in (4, 2)}


_JAX: dict = {}


def _jax_ref(data, n, case):
    """JAX's global output and q/k/v gradients for ``case`` on ``n``
    devices, once per module."""
    from fluxmpi_tpu.parallel import make_ulysses_attention, ulysses_attention
    from fluxmpi_tpu.parallel._compat import shard_map_unchecked
    from fluxmpi_tpu.parallel.ring import make_ring_attention

    spec = CASES[n][case]
    kw = dict(spec["kw"])
    seed = kw.pop("dropout_seed", None)
    if kw.get("use_flash"):
        if case in JAX_FLASH and n == 4:
            kw.update(block_q=4, block_k=4)
        else:
            kw["use_flash"] = False
    # Cases that share JAX's configuration share its run.
    key = (n, spec["kind"], spec["qkv"], spec["seg"], seed, json.dumps(kw, sort_keys=True))
    if key in _JAX:
        return _JAX[key]
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    q, k, v = (jnp.asarray(data[x + spec["qkv"]]) for x in ("q", "k", "v"))
    seg = jnp.asarray(data["seg"]) if spec["seg"] else None
    if spec["kind"] == "ulysses_blocks":
        from jax.sharding import PartitionSpec as JP

        spec_ = JP(None, "sp")
        mapped = jax.jit(shard_map_unchecked(
            lambda q, k, v, s: ulysses_attention(q, k, v, axis_name="sp", segment_ids=s,
                                                 **kw),
            mesh, in_specs=(spec_,) * 4, out_specs=spec_))

        def f(q, k, v):
            return mapped(q, k, v, seg)
    elif spec["kind"] == "ulysses":
        fn = make_ulysses_attention(mesh, axis_name="sp", **kw)

        def f(q, k, v):
            return fn(q, k, v, dropout_seed=seed)
    else:
        fn = make_ring_attention(mesh, axis_name="sp", **kw)

        def f(q, k, v):
            return fn(q, k, v, segment_ids=seg, dropout_seed=seed)
    out, vjp = jax.vjp(f, q, k, v)
    grads = vjp(jnp.asarray(data["cot"]))
    _JAX[key] = tuple(np.asarray(x) for x in (out, *grads))
    return _JAX[key]


@pytest.mark.parametrize("n,case", OUTPUT_CASES, ids=[f"{n}-{c}" for n, c in OUTPUT_CASES])
def test_sequence_parallel_attention_equals_jax(world, worlds, data, n, case):
    """The eager wrappers' global output and input gradients on every
    rank of the world against JAX's on as many devices."""
    out, dq, dk, dv = _jax_ref(data, n, case)
    for r, res in enumerate(worlds[n]):
        np.testing.assert_allclose(res[f"{case}/out"], out, atol=OUT_ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name, ref in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(res[f"{case}/{name}"], ref, atol=GRAD_ATOL,
                                       rtol=0, err_msg=f"rank {r} {name}")


def test_dropout_draws_jax_masks(world, worlds, data):
    """With dropout the output moves away from the undropped one, and by
    the same entries as JAX's (the equality above holds at 3e-5, far
    below a dropped term): the masks are JAX's."""
    for case, plain in (("ring_flash_dropout", "ring_flash"),
                        ("zigzag_flash_dropout", "zigzag_flash")):
        got = worlds[4][0][f"{case}/out"]
        assert np.abs(got - worlds[4][0][f"{plain}/out"]).max() > 1e-2
        np.testing.assert_allclose(got, _jax_ref(data, 4, case)[0], atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("n,case", [(4, "lse_ring_causal"), (4, "lse_ring_window"),
                                    (4, "lse_zigzag"), (2, "lse_ring_window")])
def test_merged_lse_equals_jax_whole_sequence(world, worlds, data, n, case):
    """The lse the ring merges (each rank's block, ``[b, sq, h]``) equals
    the lse of JAX's whole-sequence flash call (interpret mode) at the
    same positions."""
    from fluxmpi_tpu.ops.flash_attention import flash_attention_with_lse
    from fluxmpi_tpu.parallel.ring import zigzag_indices

    kw = dict(CASES[n][case]["kw"])
    zig = kw.pop("zigzag", False)
    q, k, v = (jnp.asarray(data[x]) for x in ("q", "k", "v"))
    _, lse = flash_attention_with_lse(q, k, v, causal=True, window=kw.get("window"),
                                      block_q=8, block_k=8)
    lse = np.moveaxis(np.asarray(lse), 1, -1)  # [b, S, h]
    if zig:
        lse = lse[:, zigzag_indices(S, n)]
    for r, res in enumerate(worlds[n]):
        np.testing.assert_allclose(res[f"{case}/lse"], np.split(lse, n, axis=1)[r],
                                   atol=OUT_ATOL, rtol=0, err_msg=f"rank {r}")


def test_ulysses_refuses_indivisible_kv_heads_in_the_world(world, worlds, data):
    """Grouped K/V with fewer heads than the axis: the wrapper refuses on
    every rank, as JAX's does."""
    from fluxmpi_tpu.parallel import make_ulysses_attention

    fn = make_ulysses_attention(Mesh(np.asarray(jax.devices()[:4]), ("sp",)),
                                axis_name="sp", causal=True)
    with pytest.raises(ValueError) as j:
        fn(*(jnp.asarray(data[x + "_gqa"]) for x in ("q", "k", "v")))
    for res in worlds[4]:
        assert str(res["ulysses_gqa_refused/raised"]) == f"ValueError: {j.value}"


def test_encoder_with_ring_attention_fn_equals_jax(world, worlds, data):
    """A TransformerEncoder whose attention is ``ring_attention_fn`` on
    each rank's sequence block equals JAX's dense encoder (the reference's
    own oracle, ``test_transformer_with_ring_attention``)."""
    from fluxmpi_tpu.models import TransformerEncoder as JaxEncoder

    enc = JaxEncoder(num_layers=2, d_model=32, num_heads=4, d_ff=64)
    want = np.asarray(enc.apply({"params": data["enc_params"]},
                                jnp.asarray(data["enc_x"]), train=False))
    for r, res in enumerate(worlds[4]):
        np.testing.assert_allclose(res["encoder/out"], np.split(want, 4, axis=1)[r],
                                   atol=OUT_ATOL, rtol=0, err_msg=f"rank {r}")


def _bound(n):
    """The port's counterpart of running inside ``shard_map`` over an
    ``sp`` axis of ``n``, for checks that raise before any exchange."""
    from fluxmpi_tpu_torch import _sequence_parallel as sp
    from fluxmpi_tpu_torch.parallel.sharding import Mesh as PortMesh

    return sp.active(sp.SequenceParallel(PortMesh(np.arange(n), ("sp",)), "sp"))


def _same_error(jax_call, port_call, exc=ValueError):
    with pytest.raises(exc) as j:
        jax_call()
    with pytest.raises(exc) as t:
        port_call()
    assert str(t.value) == str(j.value)


def test_refusals_equal_jax(world):
    """The layers' and wrappers' refusals, message for message."""
    from jax.sharding import PartitionSpec as JP

    import fluxmpi_tpu.parallel as jp
    import fluxmpi_tpu_torch.parallel as tp
    from fluxmpi_tpu.parallel._compat import shard_map_unchecked
    from fluxmpi_tpu_torch.parallel.sharding import Mesh as PortMesh

    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    tmesh = PortMesh(np.arange(4), ("sp",))
    x = np.ones((2, 8, 4, 8), np.float32)
    for kw in [dict(schedule="zigzag", causal=True, window=4),
               dict(schedule="zigzag"), dict(schedule="spiral"),
               dict(dropout_rate=0.2)]:
        _same_error(lambda: jp.make_ring_attention(jmesh, axis_name="sp", **kw),
                    lambda: tp.make_ring_attention(tmesh, axis_name="sp", **kw))
    _same_error(lambda: jp.make_ulysses_attention(jmesh, axis_name="sp", dropout_rate=0.2),
                lambda: tp.make_ulysses_attention(tmesh, axis_name="sp", dropout_rate=0.2))
    for name in ("ring_attention", "ulysses_attention"):
        for kw in [dict(window=4), dict(dropout_rate=0.2),
                   dict(dropout_rate=0.2, use_flash=True)]:
            _same_error(lambda: getattr(jp, name)(jnp.asarray(x), jnp.asarray(x),
                                                  jnp.asarray(x), **kw),
                        lambda: getattr(tp, name)(torch.tensor(x), torch.tensor(x),
                                                  torch.tensor(x), **kw))
    for kw in [dict(dropout_rate=0.2), dict(dropout_rate=0.2, use_flash=True)]:
        _same_error(lambda: jp.zigzag_ring_attention(jnp.asarray(x), jnp.asarray(x),
                                                     jnp.asarray(x), **kw),
                    lambda: tp.zigzag_ring_attention(torch.tensor(x), torch.tensor(x),
                                                     torch.tensor(x), **kw))
    # Inside a bound axis of 4: indivisible heads, kv heads, an odd zigzag
    # block.
    for name, shapes in [("ulysses_attention", ((2, 8, 3, 8), (2, 8, 3, 8))),
                         ("ulysses_attention", ((2, 8, 4, 8), (2, 8, 2, 8))),
                         ("zigzag_ring_attention", ((2, 3, 4, 8), (2, 3, 4, 8)))]:
        qs, ks = shapes
        body = lambda q, k: getattr(jp, name)(q, k, k, axis_name="sp")  # noqa: E731
        mapped = shard_map_unchecked(body, jmesh, in_specs=(JP(None, "sp"), JP(None, "sp")),
                                     out_specs=JP(None, "sp"))
        with pytest.raises(ValueError) as j:
            jax.jit(mapped)(jnp.ones((qs[0], qs[1] * 4, *qs[2:])),
                            jnp.ones((ks[0], ks[1] * 4, *ks[2:])))
        with _bound(4), pytest.raises(ValueError) as t:
            getattr(tp, name)(torch.ones(qs), torch.ones(ks), torch.ones(ks), axis_name="sp")
        assert str(t.value) == str(j.value)


@pytest.mark.parametrize("use_flash", [False, True])
def test_unbound_axis_falls_back_to_local_attention_like_jax(world, data, use_flash):
    """Outside a bound axis (no context, no runtime mesh with ``sp``) the
    three layers compute single-worker attention, as JAX's do outside
    ``shard_map``."""
    import fluxmpi_tpu.parallel as jp
    import fluxmpi_tpu_torch.parallel as tp

    q, k, v = (data[x][:, :16] for x in ("q", "k", "v"))
    for name, kw in [("ring_attention", dict(causal=True)),
                     ("ring_attention", dict(causal=True, window=5)),
                     ("zigzag_ring_attention", {}),
                     ("ulysses_attention", dict(causal=False))]:
        want = getattr(jp, name)(*(jnp.asarray(a) for a in (q, k, v)), axis_name="sp",
                                 use_flash=use_flash, **kw)
        got = getattr(tp, name)(*(torch.from_numpy(a) for a in (q, k, v)), axis_name="sp",
                                use_flash=use_flash, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL, rtol=0,
                                   err_msg=f"{name} {kw}")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zigzag_schedule_and_indices_equal_jax(world, n):
    """The port's own copies of the schedule and the permutation."""
    from fluxmpi_tpu.parallel import ring as jring
    from fluxmpi_tpu_torch.parallel import ring as tring

    for i in range(n):
        for s in range(n):
            assert tring.zigzag_tick_work(i, s, n) == jring.zigzag_tick_work(i, s, n)
    np.testing.assert_array_equal(tring.zigzag_indices(8 * n, n),
                                  jring.zigzag_indices(8 * n, n))
    _same_error(lambda: jring.zigzag_indices(8 * n + 2, n),
                lambda: tring.zigzag_indices(8 * n + 2, n))


def test_fold_seed_equals_jax(world):
    """The per-attend dropout seed: JAX's uint32 fold, for an int seed and
    for a tensor seed folded on its device (no host read)."""
    from fluxmpi_tpu.parallel import ring as jring
    from fluxmpi_tpu_torch.parallel import ring as tring

    for seed, salts in [(77, (3, 1)), (2**32 - 1, (0, 7)), (123456789, (5, 4, 2, 9))]:
        want = int(jring._fold_seed(seed, *salts))
        assert tring._fold_seed(seed, *salts) == want
        got = tring._fold_seed(torch.tensor(seed, dtype=torch.int64), *salts)
        assert got.dtype == torch.int64 and int(got) == want
