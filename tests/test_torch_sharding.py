"""The sharding rules against the JAX package's
(``fluxmpi_tpu.parallel.sharding``):

- ``rule_from_table``, ``combine_rules``, ``fsdp_rule`` and
  ``transformer_tp_rules`` give JAX's spec for every leaf of a
  ``TransformerLM``'s parameters (the port hands each rule the ``/`` path
  its state-dict key spells);
- ``tree_partition_specs`` degrades a non-divisible dim, a missing axis and
  an over-long spec to replicated with JAX's warnings, word for word;
  ``validated_spec_strict`` raises JAX's ``TopologyMismatchError``s;
- ``shard_tree`` in a 2-rank gloo world (a ``FileStore``, one thread per
  rank, a join timeout): each rank's block of every leaf has the shape and
  the values of JAX's addressable shard on the same mesh coordinate (tp
  and fsdp meshes), ``NamedSharding.shard_shape`` equals JAX's, and the
  mesh's ``DeviceMesh`` carries the axis names.

Exact comparisons.
"""

import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JP

from fluxmpi_tpu.parallel import sharding as jsh
from fluxmpi_tpu_torch.errors import TopologyMismatchError
from fluxmpi_tpu_torch.models import TransformerLM, to_flax_params
from fluxmpi_tpu_torch.parallel import sharding as tsh

ROOT = Path(__file__).resolve().parents[1]
LM = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32, num_heads=4, d_ff=64)

torch.set_num_threads(1)


def _params():
    return {k: v.detach() for k, v in TransformerLM(**LM, device="cpu").named_parameters()}


def _meshes(n, names):
    return (JaxMesh(np.asarray(jax.devices()[:n]).reshape(-1, *([2] if len(names) == 2 else [])),
                    names),
            tsh.Mesh(np.arange(n).reshape(-1, *([2] if len(names) == 2 else [])), names))


def test_rules_give_jax_specs_for_every_leaf():
    jmesh, tmesh = _meshes(8, ("fsdp", "tp"))
    table = [(r"pos_embed$", ("fsdp", None)), (r"ln_out/scale$", ("tp",))]
    rules = [
        (jsh.rule_from_table([(p, JP(*s)) for p, s in table]),
         tsh.rule_from_table([(p, tsh.P(*s)) for p, s in table])),
        (jsh.transformer_tp_rules(), tsh.transformer_tp_rules()),
        (jsh.transformer_tp_rules("model"), tsh.transformer_tp_rules("model")),
        (jsh.fsdp_rule(jmesh, axis_name="fsdp", min_size=64),
         tsh.fsdp_rule(tmesh, axis_name="fsdp", min_size=64)),
    ]
    rules.append((jsh.combine_rules(*(j for j, _ in rules)),
                  tsh.combine_rules(*(t for _, t in rules))))
    for name, t in _params().items():
        path = name.replace(".", "/")
        for jrule, trule in rules:
            want, got = jrule(path, tuple(t.shape)), trule(path, tuple(t.shape))
            assert (want is None and got is None) or tuple(got) == tuple(want), path


def _warned(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, sorted(str(w.message) for w in caught)


def test_degrade_to_replicated_with_jax_warnings():
    jmesh, tmesh = _meshes(8, ("dp", "tp"))
    table = [(r"embed/embedding$", ("tp", None)),        # 64 % 2: kept
             (r"pos_embed$", ("dp", None)),              # 16 % 4: kept
             (r"ff1/kernel$", (None, "ep")),             # missing axis
             (r"ff2/bias$", ("dp", None)),               # rank too long
             (r"ln1/scale$", (("dp", "tp"),)),           # 32 % 8: kept
             (r"ff1/bias$", ("tp",))]                    # 64 % 2: kept
    odd = {"encoder.block_0.ln2.scale": torch.ones(6)}   # 6 % 4: degraded
    tree = {**_params(), **odd}
    jtree = {**{k: jnp.zeros(v.shape) for k, v in tree.items()}}
    jrule = jsh.combine_rules(jsh.rule_from_table([(p, JP(*s)) for p, s in table]),
                              jsh.rule_from_table([(r"ln2/scale$", JP("dp"))]))
    trule = tsh.combine_rules(tsh.rule_from_table([(p, tsh.P(*s)) for p, s in table]),
                              tsh.rule_from_table([(r"ln2/scale$", tsh.P("dp"))]))
    # JAX's paths are the port's keys with "/" (a flat dict keyed by path).
    jtree = {k.replace(".", "/"): v for k, v in jtree.items()}
    jspecs, jwarn = _warned(lambda: jsh.tree_partition_specs(jtree, jmesh, jrule))
    tspecs, twarn = _warned(lambda: tsh.tree_partition_specs(tree, tmesh, trule))
    assert {k.replace(".", "/"): tuple(v) for k, v in tspecs.items()} == {
        k: tuple(v) for k, v in jspecs.items()}
    assert twarn == jwarn and len(twarn) >= 3
    assert any("absent from mesh axes" in w for w in twarn)
    assert any("more dims" in w for w in twarn)
    assert any("not divisible" in w for w in twarn)


def test_validated_spec_strict_raises_jax_errors():
    jmesh, tmesh = _meshes(8, ("dp", "tp"))
    for spec, shape in [(("dp", None, None), (4, 4)), ((None, "ep"), (4, 4)),
                        (("dp",), (6,)), (("dp", "tp"), (8, 4))]:
        jerr = terr = None
        try:
            jsh.validated_spec_strict(JP(*spec), shape, jmesh, path="w")
        except Exception as e:  # the JAX package's TopologyMismatchError
            jerr = (type(e).__name__, str(e))
        try:
            got = tsh.validated_spec_strict(tsh.P(*spec), shape, tmesh, path="w")
        except TopologyMismatchError as e:
            terr = (type(e).__name__, str(e))
        assert terr == jerr
        if terr is None:
            assert tuple(got) == spec


WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, store_path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch.models import TransformerLM
    from fluxmpi_tpu_torch.parallel import sharding as tsh

    fm.init(device="cpu")
    params = {k: v.detach() for k, v in TransformerLM(
        vocab_size=64, max_len=16, num_layers=2, d_model=32, num_heads=4, d_ff=64,
        device="cpu").named_parameters()}
    res = {}
    for name, mesh, rule in [
            ("tp", tsh.Mesh(np.arange(2), ("tp",)), tsh.transformer_tp_rules()),
            ("fsdp", tsh.Mesh(np.arange(2), ("fsdp",)), None)]:
        rule = rule or tsh.fsdp_rule(mesh, axis_name="fsdp", min_size=64)
        placed, shardings = tsh.shard_tree(params, mesh, rule)
        for k, v in placed.items():
            res[f"{name}/{k}"] = v.numpy()
            res[f"{name}/shape/{k}"] = np.array(shardings[k].shard_shape(params[k].shape))
        res[f"{name}/dims"] = np.array(mesh.device_mesh.mesh_dim_names)
    np.savez(out, **res)
    fm.shutdown()
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard2")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp / "store"),
                               str(tmp / f"rank{r}.npz")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_shard_tree_blocks_equal_jax_in_two_ranks(two_ranks, name):
    params = to_flax_params(_params())
    jmesh = JaxMesh(np.asarray(jax.devices()[:2]), (name,))
    rule = (jsh.transformer_tp_rules() if name == "tp"
            else jsh.fsdp_rule(jmesh, axis_name="fsdp", min_size=64))
    placed, shardings = jsh.shard_tree(params, jmesh, rule)
    sharded = 0
    for r, res in enumerate(two_ranks):
        assert tuple(res[f"{name}/dims"]) == (name,)
        for k, arr in placed.items():
            (shard,) = [s for s in arr.addressable_shards if s.device.id == r]
            got = res[f"{name}/{k.replace('/', '.')}"]
            assert got.shape == shard.data.shape, k
            np.testing.assert_array_equal(got, np.asarray(shard.data))
            assert tuple(res[f"{name}/shape/{k.replace('/', '.')}"]) == tuple(
                shardings[k].shard_shape(arr.shape))
            sharded += got.shape != arr.shape
    assert sharded > 0
    assert isinstance(shardings[next(iter(shardings))], JaxNamedSharding)
