"""``ParallelConfig``/``ResolvedPlan`` against the JAX package's, in one
process: the port's mesh is plain data, so a plan resolves over 8 workers
here as JAX's does over its 8 CPU devices.

- the errors and the ``-1`` inference, the canonical mesh-axis order, the
  batch spec and the axis-name overrides;
- ``partition_specs``, ``rule_hits``, ``describe()`` and the
  degrade-to-replicated warnings equal JAX's for the training state (the
  parameters under flax's names and adamw's moments) of the LM, the MoE LM,
  ViT and ResNet-18, under fsdp, tp, fsdp x tp, ep with
  ``expert_parallel_rules``, a user table, and ``strict=True`` (its error
  too);
- the memo's hits, ``match_partition_rules`` raising, and ``post_board``'s
  gauges and ``/status`` board.

Exact comparisons throughout (specs are names, counts and sizes).
"""

import warnings

import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import fluxmpi_tpu as jfm
import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.errors import TopologyMismatchError
from fluxmpi_tpu_torch.parallel import TrainState
from fluxmpi_tpu_torch.parallel.sharding import P

torch.set_num_threads(1)

LM = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32, num_heads=4, d_ff=64)


def _spec(s):
    return tuple(s)


def _jax_flat_specs(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                     for p in path): _spec(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _trees(name):
    """The JAX state (shapes only) and the port's state for model
    ``name``."""
    from fluxmpi_tpu import models as jm
    from fluxmpi_tpu.models import moe as jmoe
    from fluxmpi_tpu.parallel import TrainState as JaxTrainState
    from fluxmpi_tpu_torch import models as tm

    key = jax.random.PRNGKey(0)
    if name == "lm":
        jmodel, x = jm.TransformerLM(**LM), jnp.zeros((2, 8), jnp.int32)
        port = tm.TransformerLM(**LM, device="cpu")
    elif name == "moe":
        jmodel, x = jmoe.MoETransformerLM(**LM, num_experts=4), jnp.zeros((2, 8), jnp.int32)
        port = tm.MoETransformerLM(**LM, num_experts=4, device="cpu")
    elif name == "vit":
        kw = dict(num_classes=10, patch=4, num_layers=2, d_model=32, num_heads=4, d_ff=64)
        jmodel, x = jm.ViT(**kw), jnp.zeros((2, 16, 16, 3))
        port = tm.ViT(**kw, image_size=16, device="cpu")
    else:
        jmodel, x = jm.ResNet18(num_classes=10, num_filters=8), jnp.zeros((2, 32, 32, 3))
        port = tm.ResNet18(num_classes=10, num_filters=8, device="cpu")

    def make():
        v = jmodel.init(key, x, train=False)
        return JaxTrainState.create({"params": v["params"]}, optax.adamw(1e-3),
                                    model_state=v.get("batch_stats"))

    jstate = jax.eval_shape(make)
    mstate = port.init_batch_stats() if name == "resnet" else None
    return jstate, TrainState.create(port, optim.adamw(1e-3), model_state=mstate)


PLANS = {
    "fsdp": dict(fsdp=8, fsdp_min_size=64),
    "tp": dict(dp=-1, tp=2),
    "fsdp_tp": dict(dp=2, fsdp=2, tp=2, fsdp_min_size=64),
    "ep": dict(dp=-1, ep=2),
    "table": dict(dp=4, tp=2, rules=[(r"pos_embed$", ("dp", None)),
                                     (r"ln_out/scale$", ("tp",))]),
    "strict": dict(dp=-1, tp=2, strict=True,
                   rules=[(r"(bias|scale|mean|var|count)$", ())]),
}


def _configs(name):
    """``(jax ParallelConfig, port ParallelConfig)`` of plan ``name``."""
    from fluxmpi_tpu.models.moe import expert_parallel_rules as jax_ep
    from fluxmpi_tpu_torch.models import expert_parallel_rules as port_ep

    kw = dict(PLANS[name])
    jkw, tkw = dict(kw), dict(kw)
    if "rules" in kw:
        jkw["rules"] = [(pat, JP(*s)) for pat, s in kw["rules"]]
        tkw["rules"] = [(pat, P(*s)) for pat, s in kw["rules"]]
    if name == "ep":
        jkw["rules"], tkw["rules"] = jax_ep(), port_ep()
    return jfm.ParallelConfig(**jkw), tfm.ParallelConfig(**tkw)


def _specs_and_warnings(plan, tree, flat):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        specs = plan.partition_specs(tree)
    return flat(specs), sorted(str(w.message) for w in caught)


@pytest.mark.parametrize("model", ["lm", "moe", "vit", "resnet"])
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_partition_specs_equal_jax(world, model, plan_name):
    jstate, tstate = _trees(model)
    jcfg, tcfg = _configs(plan_name)
    jplan, tplan = jcfg.resolve(jax.devices()), tcfg.resolve(8)
    if plan_name == "strict":
        jerr = terr = None
        try:
            jplan.partition_specs(jstate)
        except ValueError as e:
            jerr = str(e)
        try:
            tplan.partition_specs(tstate)
        except ValueError as e:
            terr = str(e)
        assert terr == jerr
        if terr is not None:
            return
    jspecs, jwarn = _specs_and_warnings(jplan, jstate, _jax_flat_specs)
    tspecs, twarn = _specs_and_warnings(
        tplan, tstate, lambda _: {p: _spec(s) for p, s in tplan._specs_by_path(tstate).items()})
    assert tspecs == jspecs
    assert twarn == jwarn
    assert tplan.rule_hits == jplan.rule_hits
    assert tplan.describe() == jplan.describe()
    assert _spec(tplan.batch_spec) == _spec(jplan.batch_spec)
    assert tplan.shards_parameters == jplan.shards_parameters
    # The memo: the same tree again is a hit, restoring the same counts.
    hits = tplan.spec_cache_hits
    tplan.partition_specs(tstate)
    assert (tplan.spec_cache_hits, tplan.spec_cache_misses) == (hits + 1, 1)
    assert tplan.rule_hits == jplan.rule_hits


def test_config_errors_inference_and_axis_order():
    cases = [dict(dp=3, tp=2), dict(dp=-1, tp=3)]
    for kw in cases:
        with pytest.raises(TopologyMismatchError) as t:
            tfm.ParallelConfig(**kw).resolve(8)
        with pytest.raises(jfm.errors.TopologyMismatchError) as j:
            jfm.ParallelConfig(**kw).resolve(jax.devices())
        assert str(t.value) == str(j.value)
    for kw in [dict(dp=-1, tp=-1), dict(dp=0), dict(dp=True), dict(dp=8, axis_names={"zz": "z"}),
               dict(dp=8, axis_names={"tp": "dp"})]:
        with pytest.raises(ValueError) as t:
            tfm.ParallelConfig(**kw)
        with pytest.raises(ValueError) as j:
            jfm.ParallelConfig(**kw)
        assert str(t.value) == str(j.value)
    for kw in [{}, dict(fsdp=2, tp=2, dp=-1), dict(dp=4, sp=2), dict(pp=2, ep=2, dp=-1),
               dict(dp=4, tp=2, axis_names={"dp": "data", "tp": "model"})]:
        t, j = tfm.ParallelConfig(**kw).resolve(8), jfm.ParallelConfig(**kw).resolve(jax.devices())
        assert tuple(t.mesh.axis_names) == tuple(j.mesh.axis_names)
        assert t.mesh.shape == dict(j.mesh.shape)
        assert t.data_axes == j.data_axes
        assert t.data_parallel_size == j.data_parallel_size
        assert _spec(t.batch_spec) == _spec(j.batch_spec)
        assert t.describe() == j.describe()
        for kind in ("dp", "fsdp", "tp", "pp", "sp", "ep"):
            assert t.axis_name(kind) == j.axis_name(kind)
        tr, jr = (x.rule("encoder/block_0/ff1/kernel", (32, 64)) for x in (t, j))
        assert (tr is None and jr is None) or tuple(tr) == tuple(jr)
    # The mesh's worker layout is row-major, as JAX lays out devices.
    t = tfm.ParallelConfig(fsdp=2, tp=2, dp=-1).resolve(8)
    assert t.mesh.coords(5) == {"dp": 1, "fsdp": 0, "tp": 1}
    assert t.mesh.block_index(5, ("dp", "fsdp")) == (2, 4)


def test_match_partition_rules_strict_raises():
    tree = {"dense.kernel": torch.ones(8, 4), "dense.bias": torch.ones(4),
            "scalar": torch.ones(())}
    specs = tfm.match_partition_rules([(r"kernel$", P("dp", None)), (r"bias$", P())], tree)
    assert specs["dense.kernel"] == P("dp", None) and specs["scalar"] == P()
    with pytest.raises(ValueError, match="dense/bias") as t:
        tfm.match_partition_rules([(r"kernel$", P("dp", None))], tree)
    jtree = {"dense": {"kernel": jnp.ones((8, 4)), "bias": jnp.ones((4,))},
             "scalar": jnp.ones(())}
    with pytest.raises(ValueError) as j:
        jfm.match_partition_rules([(r"kernel$", JP("dp", None))], jtree)
    assert str(t.value) == str(j.value)


def test_post_board_gauges_and_status(world):
    from fluxmpi_tpu.parallel.plan import post_board as jax_post
    from fluxmpi_tpu.telemetry import MetricsRegistry as JaxRegistry
    from fluxmpi_tpu.telemetry import export as jexport
    from fluxmpi_tpu.telemetry import set_registry as jax_set_registry
    from fluxmpi_tpu_torch.parallel.plan import post_board
    from fluxmpi_tpu_torch.telemetry import MetricsRegistry, set_registry
    from fluxmpi_tpu_torch.telemetry import export as texport

    boards, gauges = [], []
    for pkg, post, reg_cls, set_reg, exp in (
            ("jax", jax_post, JaxRegistry, jax_set_registry, jexport),
            ("port", post_board, MetricsRegistry, set_registry, texport)):
        cfg = (jfm if pkg == "jax" else tfm).ParallelConfig(dp=4, fsdp=2, fsdp_min_size=64)
        plan = cfg.resolve(jax.devices() if pkg == "jax" else 8)
        w = jnp.ones((64, 64)) if pkg == "jax" else torch.ones(64, 64)
        plan.partition_specs({"w": w})
        exporter = exp.Exporter(port=0, addr="127.0.0.1")
        prev_exp, reg = exp.set_exporter(exporter), reg_cls()
        prev_reg = set_reg(reg)
        try:
            post(plan)
            board = exporter.build_status()["parallel"]
            board.pop("noted_unix")
            boards.append(board)
            gauges.append(sorted((m["name"], tuple(sorted(m.get("labels", {}).items())),
                                  m["value"]) for m in reg.snapshot()
                                 if m["name"].startswith("parallel.")))
        finally:
            exp.set_exporter(prev_exp)
            set_reg(prev_reg)
            exporter.stop()
    assert boards[0] == boards[1]
    assert boards[1]["mesh"] == {"dp": 4, "fsdp": 2} and boards[1]["rule_hits"] == {"fsdp": 1}
    assert gauges[0] == gauges[1] and gauges[1]


def test_init_installs_the_plan():
    """``init(parallel=)`` installs the plan and its mesh; a repeated
    ``init`` with another plan warns and keeps the first; ``"auto"`` arms
    the layout autotuner with no plan installed yet; ``resize=`` stays
    refused."""
    cfg = tfm.ParallelConfig()
    try:
        assert tfm.init(device="cpu", parallel=cfg).type == "cpu"
        plan = tfm.global_plan()
        assert plan.config is cfg and tfm.global_mesh() is plan.mesh
        assert tfm.dp_axis_name() == "dp"
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tfm.init(device="cpu", parallel=tfm.ParallelConfig(dp=1))
        with pytest.warns(UserWarning, match="cannot rebuild the global mesh"):
            tfm.init(device="cpu", parallel=tfm.ParallelConfig(tp=1, fsdp_min_size=1))
        assert tfm.global_plan() is plan
    finally:
        tfm.shutdown()
    assert tfm.global_plan() is None
    try:
        tfm.init(device="cpu", parallel="auto")
        assert tfm.runtime.auto_parallel() and tfm.global_plan() is None
    finally:
        tfm.shutdown()
    with pytest.raises(ValueError, match="not both"):
        tfm.init(device="cpu", parallel=cfg, mesh_shape={"dp": 1})
    try:
        tfm.init(device="cpu", mesh_shape={"dp": -1}, distributed=False)
        assert tfm.global_plan() is None and tfm.global_mesh().shape == {"dp": 1}
    finally:
        tfm.shutdown()
    # init(resize=) is ported: it arms the live-resize plane, and shutdown
    # disarms it.
    from fluxmpi_tpu_torch.fleet import resize

    try:
        tfm.init(device="cpu", resize=True)
        assert resize.enabled()
    finally:
        tfm.shutdown()
    assert not tfm.is_initialized() and not resize.enabled()
