"""Sharded checkpoints and elastic resume in the port
(``fluxmpi_tpu_torch.utils.{checkpoint,manifest}``, the loader's
``elastic_order`` and cursor remap, ``train_loop``'s elastic resume)
against the JAX package (``tests/test_elastic.py``'s cases that exist in
the port).

Three gloo worlds run once for the module, in order, over one temporary
directory (``tests/_torch_elastic_worker.py``, ``FileStore``, one thread
per rank): 2 ranks, then 4, then 2 again. They save the same tiny LM state
(weights and adamw moments made from a seed here) sharded under
``fsdp_rule`` and the tp table, restore it across worker counts, abort a
save whose write fails on one rank, iterate ``elastic_order`` loaders, and
resize a tiny MLP's run from 4 workers to 2. Held against the JAX package
on its CPU devices:

- the manifests of the same state on the same mesh, field by field. Left
  out: ``time_unix``, and ``process_count``, which differs by
  construction: JAX runs one process over ``n`` devices, the port one
  process per device;
- the restores 2→4, 4→2 (the banked specs, and a rule), 4→1 (here, with
  ``parallel=`` and a meta ``like``) and replicated→sharded: each port
  worker's block bit-identical to JAX's addressable shard at the same mesh
  coordinate (pure data movement: tolerance 0);
- the refusals: a mesh missing an axis (the same leaf named), no manifest
  and no rule, the wrong layout family;
- the loader's cursor remap (cursor, batches and warnings) and the
  ``elastic_order`` batches (batch-major: the workers' rows, in rank
  order, are JAX's batch ``b``);
- ``train_loop``'s elastic resume (the consumed ids equal JAX's run) and
  the 4→2 resize (the ids of both worlds, as a multiset, JAX's order; the
  final loss within ``rtol=5e-3`` of JAX's).

The crash windows of the manifest sidecar run in one process, as the JAX
package's tests run them.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import fluxmpi_tpu as jfm
from fluxmpi_tpu import faults as jfaults
from fluxmpi_tpu.data import ArrayDataset as JArrayDataset
from fluxmpi_tpu.data import DistributedDataLoader as JLoader
from fluxmpi_tpu.parallel import TrainState as JaxTrainState
from fluxmpi_tpu.parallel import make_train_step as jax_make_train_step
from fluxmpi_tpu.parallel import train_loop as jax_train_loop
from fluxmpi_tpu.parallel.sharding import fsdp_rule as jfsdp_rule
from fluxmpi_tpu.parallel.sharding import shard_tree as jshard_tree
from fluxmpi_tpu.parallel.sharding import transformer_tp_rules as jtp_rules
from fluxmpi_tpu.parallel.train import replicate as jreplicate
from fluxmpi_tpu.telemetry.schema import validate_manifest as jvalidate_manifest
from fluxmpi_tpu.telemetry.schema import validate_resize_record as jvalidate_resize
from fluxmpi_tpu.utils import manifest as jmanifest
from fluxmpi_tpu.utils import restore_checkpoint as jrestore
from fluxmpi_tpu.utils import save_checkpoint as jsave

import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu_torch import faults, optim
from fluxmpi_tpu_torch.errors import FaultInjectedError, TopologyMismatchError
from fluxmpi_tpu_torch.models import MLP, TransformerLM
from fluxmpi_tpu_torch.parallel import ParallelConfig, TrainState, make_train_step, train_loop
from fluxmpi_tpu_torch.parallel.sharding import Mesh
from fluxmpi_tpu_torch.telemetry import MetricsRegistry
from fluxmpi_tpu_torch.telemetry.schema import validate_resize_record
from fluxmpi_tpu_torch.utils import CheckpointManager, manifest, restore_checkpoint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_elastic_worker.py"
JOIN_TIMEOUT = 180
LM = dict(vocab_size=64, max_len=16, num_layers=2, d_model=32, num_heads=4, d_ff=64)
LOOP = {"updates": 5, "examples": 80, "epochs": 0}
LOADER = {"epoch": 0, "cursor": 5, "seed": 7, "process_count": 4,
          "global_batch_size": 16, "num_batches": 8, "elastic_order": 1}


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# Inputs (made here, from a seed) and the worlds
# ---------------------------------------------------------------------------


def _inputs() -> dict:
    model = TransformerLM(**LM, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    out = {}
    for k, p in model.named_parameters():
        w = p.detach().numpy() + 0.1 * rng.standard_normal(p.shape).astype(np.float32)
        out[f"lm/{k}"] = w.astype(np.float32)
        out[f"mu/{k}"] = (0.5 * w).astype(np.float32)
        out[f"nu/{k}"] = (w * w).astype(np.float32)
    mlp = MLP(features=(16, 1), device="cpu", generator=torch.Generator().manual_seed(1))
    for k, p in mlp.named_parameters():
        out[f"mlp/{k}"] = p.detach().numpy().copy()
    out["x"] = rng.uniform(-2, 2, size=(128, 1)).astype(np.float32)
    out["ids"] = np.arange(128, dtype=np.int32)
    for k, v in LOOP.items():
        out[f"loop/{k}"] = np.int64(v)
    for k, v in LOADER.items():
        out[f"loader/{k}"] = np.int64(v)
    return out


def _launch(tmp: Path, phase: str, n: int) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    env.pop("FLUXMPI_TPU_RESIZE", None)
    procs, logs = [], []
    for rank in range(n):
        log = open(tmp / f"{phase}.rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), str(n), str(tmp / f"{phase}.store"),
             str(tmp / f"{phase}.rank{rank}.json"), str(tmp), phase],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    text = "\n".join((tmp / f"{phase}.rank{r}.log").read_text() for r in range(n))
    assert not hung, f"a rank of {phase} hung past {JOIN_TIMEOUT}s:\n{text}"
    assert all(p.returncode == 0 for p in procs), text
    out = []
    for r in range(n):
        res = json.loads((tmp / f"{phase}.rank{r}.json").read_text())
        res["blocks"] = dict(np.load(tmp / f"{phase}.rank{r}.json.npz"))
        out.append(res)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``(tmp, {phase: [each rank's results]})`` of the three worlds."""
    tmp = tmp_path_factory.mktemp("elastic")
    np.savez(tmp / "inputs.npz", **_inputs())
    return tmp, {phase: _launch(tmp, phase, n)
                 for phase, n in (("w2a", 2), ("w4", 4), ("w2b", 2))}


# ---------------------------------------------------------------------------
# The same state in the JAX package
# ---------------------------------------------------------------------------


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return {"params": out}


def _pick(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _jax_payload(inputs: dict, state=None):
    params = _nest(_pick(inputs, "lm/"))
    if state is None:
        opt = optax.adamw(1e-3).init(params)
        adam = opt[0]._replace(count=np.int32(3), mu=_nest(_pick(inputs, "mu/")),
                               nu=_nest(_pick(inputs, "nu/")))
        state = JaxTrainState(step=np.int32(3), params=params,
                              opt_state=(adam,) + tuple(opt[1:]), model_state=None)
    return {"state": state,
            "loop": {k: np.asarray(int(inputs[f"loop/{k}"]), np.int64) for k in LOOP},
            "loader": {k: np.asarray(int(inputs[f"loader/{k}"]), np.int64)
                       for k in LOADER}}


def _jmesh(kind: str, n: int) -> JMesh:
    devs = np.asarray(jax.devices()[:n])
    if kind == "fsdp":
        return JMesh(devs.reshape(n), ("dp",))
    return JMesh(devs.reshape(n // 2, 2), ("dp", "tp"))


def _jrule(kind: str, mesh: JMesh, min_size: int = 64):
    return jfsdp_rule(mesh, min_size=min_size) if kind == "fsdp" else jtp_rules()


def _jax_sharded_payload(inputs, kind, n):
    payload = _jax_payload(inputs)
    mesh = _jmesh(kind, n)
    state, _ = jshard_tree(payload["state"], mesh, _jrule(kind, mesh))
    return {**payload, "state": state}


def _host_zeros(tree):
    return jax.tree_util.tree_map(
        lambda x: np.zeros_like(np.asarray(jax.device_get(x)))
        if isinstance(x, (jax.Array, np.ndarray)) else x, tree)


def _jax_leaves(tree) -> dict:
    return {jmanifest._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n", [("fsdp", 2), ("fsdp", 4), ("tp", 2), ("tp", 4)])
def test_manifests_equal_jax_field_by_field(worlds, inputs, world, kind, n):
    tmp, res = worlds
    man = res["w2a" if n == 2 else "w4"][0]["manifest"][kind]
    jman = jmanifest.build_manifest(_jax_sharded_payload(inputs, kind, n),
                                    layout="sharded", step=5)
    assert jvalidate_manifest(man) == [] == jvalidate_manifest(jman)
    # time_unix is the clock; process_count differs by construction (JAX:
    # one process over n devices; the port: one process per device).
    assert man["process_count"] == n and jman["process_count"] == 1
    for key in ("schema", "step", "layout", "mesh", "loader", "counters", "parallel"):
        assert man[key] == jman[key], key
    leaves = {x["path"]: x for x in man["leaves"]}
    jleaves = {x["path"]: x for x in jman["leaves"]}
    assert leaves == jleaves
    sharded = [p for p, x in leaves.items() if x["spec"] and any(x["spec"])]
    assert len(sharded) >= 6, sharded
    # Each worker's file holds a share of the state's bytes, not all of it.
    sizes = [r["shard_bytes"][kind] for r in res["w2a" if n == 2 else "w4"]]
    total = sum(int(np.prod(x["shape"])) * 4 for x in man["leaves"])
    assert max(sizes) < 0.8 * total and sum(sizes) >= total * 0.9, (sizes, total)


# ---------------------------------------------------------------------------
# Restores across worker counts: the blocks are JAX's shards, bit for bit
# ---------------------------------------------------------------------------


def _jax_restore_case(tmp: Path, inputs: dict, case: str):
    """JAX's restored payload for ``case`` and the mesh it lands on."""
    root = tmp / "jax"
    root.mkdir(exist_ok=True)
    if case == "rep_to_4":
        payload = _jax_payload(inputs)
        state = jreplicate(payload["state"], _jmesh("fsdp", 4))
        path = str(root / "rep")
        if not os.path.exists(path):
            jsave(path, {**payload, "state": state})
        mesh = _jmesh("fsdp", 4)
        return jrestore(path, _host_zeros({**payload, "state": state}), mesh=mesh,
                        rule=jfsdp_rule(mesh, min_size=64)), mesh
    src = {"2to4": 2, "4to2": 4, "4to2_rule": 4, "4to1": 4}[case]
    dst = {"2to4": 4, "4to2": 2, "4to2_rule": 2, "4to1": 1}[case]
    saved = _jax_sharded_payload(inputs, "fsdp", src)
    path = str(root / f"ck{src}")
    if not os.path.exists(path):
        jsave(path, saved)
    mesh = _jmesh("fsdp", dst)
    rule = jfsdp_rule(mesh, min_size=256) if case == "4to2_rule" else None
    return jrestore(path, _host_zeros(saved), mesh=mesh, rule=rule), mesh


@pytest.mark.parametrize("case", ["2to4", "4to2", "4to2_rule", "rep_to_4", "4to1"])
def test_restore_blocks_are_jax_shards_bit_for_bit(worlds, inputs, world, case):
    tmp, res = worlds
    restored, mesh = _jax_restore_case(tmp, inputs, case)
    jleaves = _jax_leaves(restored)
    if case == "4to1":
        # The card's case: a world of one restores the 4-worker checkpoint
        # with parallel= and a like of meta tensors.
        like = manifest.map_with_path(
            lambda p, x: torch.empty(x.shape, dtype=x.dtype, device="meta")
            if torch.is_tensor(x) else x, _port_payload(inputs))
        out = restore_checkpoint(str(tmp / "ck_fsdp_4"), like,
                                 parallel=ParallelConfig(dp=1))
        got = dict(manifest.named_leaves(out))
        ranks = [{"blocks": {f"4to1/{p}": manifest.leaf_tensor(x).numpy()
                             for p, x in got.items() if manifest.leaf_tensor(x) is not None}}]
        assert all(x.device.type == "cpu" for x in got.values() if torch.is_tensor(x))
    else:
        ranks = res["w4" if case in ("2to4", "rep_to_4") else "w2b"]
    n_sharded = 0
    for r, rank_res in enumerate(ranks):
        dev = mesh.devices.flat[r]
        for path, leaf in jleaves.items():
            if not isinstance(leaf, jax.Array):
                continue
            shard = next(s for s in leaf.addressable_shards if s.device == dev)
            want = np.asarray(shard.data)
            got = rank_res["blocks"][f"{case}/{path}"]
            assert got.shape == want.shape, (path, got.shape)
            # (JAX without x64 holds the loop's int64 counters as int32.)
            assert got.dtype == want.dtype or want.dtype.kind == "i", path
            np.testing.assert_array_equal(got, want, err_msg=f"{case} rank {r} {path}")
            n_sharded += want.shape != leaf.shape
        if case != "4to1":
            # The restored blocks carry the spec JAX's arrays do.
            for path, spec in rank_res["specs"][case].items():
                assert spec == jmanifest._encode_spec(jleaves[path].sharding.spec), path
    assert (n_sharded > 0) == (case != "4to1")


def _port_payload(inputs):
    params = {k: torch.tensor(v) for k, v in _pick(inputs, "lm/").items()}
    st = TrainState(step=3, params=params, opt_state={
        "count": torch.tensor(3, dtype=torch.int32),
        "mu": {k: torch.tensor(v) for k, v in _pick(inputs, "mu/").items()},
        "nu": {k: torch.tensor(v) for k, v in _pick(inputs, "nu/").items()}})
    return {"state": st,
            "loop": {k: torch.tensor(v, dtype=torch.int64) for k, v in LOOP.items()},
            "loader": {k: torch.tensor(v, dtype=torch.int64) for k, v in LOADER.items()}}


def test_restore_refusals_match_jax(worlds, inputs, world, tmp_path):
    tmp, _ = worlds
    like = _port_payload(inputs)
    jsaved = _jax_sharded_payload(inputs, "fsdp", 4)
    jpath = str(tmp / "jax" / "ck4")
    if not os.path.exists(jpath):
        jsave(jpath, jsaved)
    # A mesh whose size divides nothing: the same first leaf named.
    with pytest.raises(TopologyMismatchError) as port_err:
        restore_checkpoint(str(tmp / "ck_fsdp_4"), like, mesh=Mesh(np.arange(3), ("dp",)))
    with pytest.raises(jfm.errors.TopologyMismatchError) as jax_err:
        jrestore(jpath, _host_zeros(jsaved), mesh=JMesh(np.asarray(jax.devices()[:3]),
                                                        ("dp",)))
    name = re.search(r"cannot restore '([^']+)'", str(jax_err.value)).group(1)
    assert f"cannot restore {name!r}" in str(port_err.value)
    assert "'dp'" in str(port_err.value)
    # A mesh without the banked axis.
    with pytest.raises(TopologyMismatchError, match="which the current mesh does not have"):
        restore_checkpoint(str(tmp / "ck_fsdp_4"), like, mesh=Mesh(np.arange(2), ("fsdp",)))
    # No manifest and no rule: JAX's ValueError.
    bare = tmp_path / "bare"
    shutil.copytree(tmp / "ck_fsdp_4", bare)
    shutil.copy(str(tmp / "ck_fsdp_4") + ".fluxmpi_layout", str(bare) + ".fluxmpi_layout")
    with pytest.warns(UserWarning, match="no topology manifest"):
        with pytest.raises(ValueError, match="manifest"):
            restore_checkpoint(str(bare), like, mesh=Mesh(np.arange(1), ("dp",)))
    # The wrong layout family: the marker's error, unless allowed.
    with pytest.raises(ValueError, match="saved with sharded layout"):
        restore_checkpoint(str(tmp / "ck_fsdp_4"), like)
    whole = restore_checkpoint(str(tmp / "ck_fsdp_4"), like, allow_layout_change=True)
    for path, leaf in _jax_leaves(jsaved).items():
        got = manifest.leaf_tensor(dict(manifest.named_leaves(whole))[path])
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf), err_msg=path)


def test_peer_write_failure_aborts_on_every_worker(worlds):
    _, res = worlds
    first, second = res["w2a"]
    assert first["abort_error"] == "OSError"  # told by rank 1's sentinel
    assert second["abort_error"] == "FaultInjectedError"
    for r in (first, second):
        assert r["abort_steps"] == [1] and r["abort_leftovers"] == []
        assert r["abort_restored"] == [1, True]


def test_moments_created_from_placed_params_survive_a_sharded_save(worlds, inputs):
    _, res = worlds
    for r in res["w2a"]:
        assert r["created_tagged"] and r["created_restored"] == []
        assert "carries no layout tag" in r["guard_error"]
        named = re.search(r"shards '([^']+)'", r["guard_error"]).group(1)
        assert f"lm/{named}" in inputs
    leaves = {leaf["path"]: leaf for leaf in res["w2a"][0]["created_manifest"]["leaves"]}
    for path, leaf in leaves.items():
        if "/mu/" in path or "/nu/" in path:
            twin = leaves[path.replace("opt_state/0/mu/", "params/")
                          .replace("opt_state/0/nu/", "params/")]
            assert (leaf["shape"], leaf["spec"]) == (twin["shape"], twin["spec"]), path


# ---------------------------------------------------------------------------
# The manifest sidecar's crash windows (one process, as in the JAX tests)
# ---------------------------------------------------------------------------


def _small():
    return {"w": torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8),
            "b": torch.ones(8)}


@pytest.mark.parametrize("site,sidecar", [("ckpt.manifest", False), ("ckpt.commit", True)])
def test_crash_windows_quarantine_with_the_sidecar(tmp_path, site, sidecar):
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    mgr.save(1, _small())
    with faults.scope(f"{site}@step=1"):
        with pytest.raises(FaultInjectedError):
            mgr.save(2, _small())
    assert mgr.all_steps() == [1]
    assert os.path.exists(tmp_path / "run" / "step_00000002.manifest.json") == sidecar
    with pytest.warns(UserWarning, match="quarantined"):
        again = CheckpointManager(str(tmp_path / "run"), async_save=False)
    assert "step_00000002" in again.quarantined
    q = sorted(os.listdir(tmp_path / "run" / "_quarantine"))
    assert ("step_00000002.manifest.json" in q) == sidecar
    assert not os.path.exists(tmp_path / "run" / "step_00000002.manifest.json")
    assert again.latest_step() == 1


def test_manifest_write_failure_commits_without_sidecar(tmp_path, monkeypatch):
    def boom(path, man):
        raise OSError("disk full")

    monkeypatch.setattr(manifest, "write_manifest", boom)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    with pytest.warns(UserWarning, match="without it"):
        mgr.save(3, _small())
    assert mgr.all_steps() == [3] and mgr.read_manifest() is None
    step, back = mgr.restore({"w": torch.zeros(64, 8), "b": torch.zeros(8)})
    assert step == 3 and torch.equal(back["w"], _small()["w"])


def test_corrupt_manifest_sidecar_does_not_block_a_resume(tmp_path):
    step, state, loader, _ = _mlp_pieces(32)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    train_loop(step, state, loader, steps=2, checkpoint=mgr, save_every=2)
    (tmp_path / "run" / "step_00000002.manifest.json").write_text("{not json")
    step, state, loader, _ = _mlp_pieces(32)
    with pytest.warns(UserWarning, match="unreadable"):
        _, summary = train_loop(step, state, loader, steps=4, resume=True,
                                checkpoint=CheckpointManager(str(tmp_path / "run"),
                                                             async_save=False))
    assert summary["resumed_from"] == 2 and summary["updates"] == 4


def test_corrupt_manifest_sidecar_elastic_resume_is_sample_exact(tmp_path):
    """The sidecar is lost, the checkpoint still banks the loader's
    geometry: a resume at another global batch (8 → 16) remaps the cursor
    from that geometry and consumes the uninterrupted order."""
    seen: list = []
    step, state, loader, _ = _mlp_pieces(8, seen)
    train_loop(step, state, loader, epochs=1, fuse=False)
    reference = [i for b in seen for i in b]
    seen.clear()
    step, state, loader, _ = _mlp_pieces(8, seen)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    with faults.scope("data.fetch@step=5"):
        with pytest.raises(FaultInjectedError):
            train_loop(step, state, loader, epochs=1, checkpoint=mgr, save_every=1)
    assert mgr.latest_step() == 4
    prefix = [i for b in seen[:4] for i in b]
    (tmp_path / "run" / "step_00000004.manifest.json").write_text("{not json")
    seen.clear()
    step, state, loader, _ = _mlp_pieces(16, seen)
    with pytest.warns(UserWarning, match="unreadable"):
        _, summary = train_loop(step, state, loader, epochs=1, resume=True,
                                checkpoint=CheckpointManager(str(tmp_path / "run"),
                                                             async_save=False))
    assert summary["resumed_from"] == 4 and summary["epochs"] == 1
    assert prefix + [i for b in seen for i in b] == reference


def test_pre_manifest_checkpoint_resumes_with_the_legacy_template(tmp_path):
    """A checkpoint from before manifests banks no loader geometry: the
    full template misses those leaves and the resume retries with the
    legacy one, at the same geometry."""
    step, state, loader, _ = _mlp_pieces(32)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    train_loop(step, state, loader, steps=2, checkpoint=mgr, save_every=2)
    data_path = tmp_path / "run" / "step_00000002" / "state.pt"
    data = torch.load(data_path, weights_only=True)
    geometry = [k for k in data if k.startswith("loader/")
                and k.split("/")[-1] not in ("epoch", "cursor", "seed")]
    assert geometry
    torch.save({k: v for k, v in data.items() if k not in geometry}, data_path)
    (tmp_path / "run" / "step_00000002.manifest.json").unlink()
    step, state, loader, _ = _mlp_pieces(32)
    with pytest.warns(UserWarning, match="no topology manifest"):
        _, summary = train_loop(step, state, loader, steps=4, resume=True,
                                checkpoint=CheckpointManager(str(tmp_path / "run"),
                                                             async_save=False))
    assert summary["resumed_from"] == 2 and summary["updates"] == 4


def test_shutdown_destroys_the_checkpoint_group_over_an_adopted_world(tmp_path):
    """Under a default group the caller brought up, ``shutdown`` leaves it
    up and destroys the checkpoints' own gloo group."""
    import torch.distributed as dist

    from fluxmpi_tpu_torch import runtime

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        tfm.init(device="cpu")
        group = runtime.checkpoint_group()
        assert dist.get_process_group_ranks(group) == [0]
        tfm.shutdown()
        assert dist.is_initialized()
        with pytest.raises(KeyError):
            dist.get_process_group_ranks(group)
    finally:
        tfm.shutdown()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The loader's cursor remap and elastic_order, against the JAX loader
# ---------------------------------------------------------------------------


def _dataset(n=128):
    ids = np.arange(n, dtype=np.int32)
    x = np.linspace(-2, 2, n, dtype=np.float32)[:, None]
    return x, ids


def _loaders(gbs, n=128):
    x, ids = _dataset(n)
    port = tfm.DistributedDataLoader(tfm.ArrayDataset((x, x ** 2, ids)), gbs, shuffle=True,
                                     seed=7, prefetch=0, device_gather=False, device="cpu")
    jax_loader = JLoader(JArrayDataset((x, x ** 2, ids)), gbs, shuffle=True, seed=7,
                         prefetch=0, device_gather=False)
    return port, jax_loader


def _remap(which, n, old_gbs, consumed, cursor, new_gbs):
    """Bank an old loader's position, load it into a new one: the new
    cursor, state, the ids it then yields, and the warnings' (category,
    numbers)."""
    old = _loaders(old_gbs, n)[which]
    it = iter(old)
    for _ in range(consumed):
        next(it)
    banked = {**old.state_dict(), **old.geometry()}
    if cursor is not None:
        banked["cursor"] = cursor
    new = _loaders(new_gbs, n)[which]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        new.load_state_dict(banked)
    ids = [np.asarray(b[2]).tolist() for b in new]
    return (new.resume_cursor, new.state_dict(), ids,
            [(w.category.__name__, re.findall(r"\d+", str(w.message))) for w in caught])


@pytest.mark.parametrize("n,old_gbs,consumed,cursor,new_gbs", [
    (128, 32, 2, None, 16),   # shrink the width mid-epoch: exact
    (128, 16, 4, None, 32),   # grow it
    (128, 8, 0, 3, 16),       # a ragged offset rounds down, counted
    (128, 32, 0, 4, 16),      # a complete epoch resumes at the next
    (112, 32, 0, 3, 16),      # ... and stays complete under wider coverage
    (112, 8, 0, 13, 32),      # an incomplete pass past the new coverage
])
def test_cursor_remap_equals_jax(world, n, old_gbs, consumed, cursor, new_gbs):
    port = _remap(0, n, old_gbs, consumed, cursor, new_gbs)
    want = _remap(1, n, old_gbs, consumed, cursor, new_gbs)
    assert port == want


def test_pre_elastic_state_names_topology_in_error():
    loader = _loaders(32)[0]
    with pytest.raises(ValueError) as e:
        loader.load_state_dict({"epoch": 0, "cursor": 99, "seed": 7})
    assert "process count" in str(e.value) and "batch size" in str(e.value)
    with pytest.raises(ValueError, match="saved geometry"):
        loader.load_state_dict({"epoch": 0, "cursor": 99, "seed": 7, "process_count": 1,
                                "global_batch_size": 16, "num_batches": 8,
                                "elastic_order": 0})


@pytest.mark.parametrize("phase", ["w2a", "w4"])
def test_elastic_order_batches_are_jax_batch_major(worlds, world, inputs, phase):
    _, res = worlds
    ranks = res[phase]
    ds = JArrayDataset((inputs["x"], inputs["ids"]))
    want = [np.asarray(b[1]).tolist() for b in JLoader(
        ds, 16, shuffle=True, seed=7, prefetch=0, device_gather=False,
        elastic_order=True)]
    got = [sum((r["order"][b] for r in ranks), []) for b in range(len(ranks[0]["order"]))]
    assert got == want and len(got) == 8
    assert all(r["geometry"]["elastic_order"] == 1 for r in ranks)
    assert "DistributedDataContainer" in ranks[0]["order_errors"]["container"]
    assert "drop_last=True" in ranks[0]["order_errors"]["drop_last"]


# ---------------------------------------------------------------------------
# train_loop's elastic resume
# ---------------------------------------------------------------------------


def _mlp_pieces(gbs, seen=None):
    x, ids = _dataset()
    model = MLP(features=(16, 1), device="cpu", generator=torch.Generator().manual_seed(1))

    def loss_fn(p, ms, b):
        bx, by, bid = b
        if seen is not None:
            seen.append(bid.tolist())
        return ((torch.func.functional_call(model, p, (bx,)) - by) ** 2).mean(), ms

    opt = optim.adam(1e-3)
    state = TrainState.create({k: v.detach().clone().requires_grad_()
                               for k, v in model.named_parameters()}, opt)
    loader = tfm.DistributedDataLoader(tfm.ArrayDataset((x, x ** 2, ids)), gbs,
                                       shuffle=True, seed=7, prefetch=0,
                                       device_gather=False, device="cpu")
    # One process, no world: nothing to reduce.
    return make_train_step(loss_fn, opt, grad_reduce=None), state, loader, model


def _jax_elastic_ids(world, tmp):
    """The JAX package's test_elastic.py:696 flow: the ids of the gbs-32
    prefix (2 batches) and of the gbs-16 resumed tail."""
    from fluxmpi_tpu.models import MLP as JMLP
    from fluxmpi_tpu.utils import CheckpointManager as JManager

    x, ids = _dataset()
    model = JMLP(features=(16, 1))
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((2, 1))))
    opt = optax.adam(1e-3)
    consumed = []

    def track(batch):
        consumed.append(np.asarray(batch[2]).tolist())
        return batch

    def loss_fn(p, ms, b):
        return jnp.mean((model.apply(p, b[0]) - b[1]) ** 2), ms

    def loader(gbs):
        return JLoader(JArrayDataset((x, x ** 2, ids)), gbs, mesh=world, shuffle=True,
                       seed=7, prefetch=0, device_gather=False, transform=track)

    step = jax_make_train_step(loss_fn, opt, mesh=world)
    with jfaults.scope("data.fetch@step=3"):
        with pytest.raises(jfm.errors.FaultInjectedError):
            jax_train_loop(step, jreplicate(JaxTrainState.create(params, opt), world),
                           loader(32), epochs=1, checkpoint=JManager(str(tmp), async_save=False),
                           save_every=1)
    prefix = consumed[:2]
    consumed.clear()
    jax_train_loop(step, jreplicate(JaxTrainState.create(params, opt), world), loader(16),
                   epochs=1, checkpoint=JManager(str(tmp), async_save=False), resume=True)
    return [i for b in prefix + consumed for i in b]


def test_train_loop_elastic_resume_is_sample_exact_and_equals_jax(world, tmp_path):
    seen: list = []
    step, state, loader, _ = _mlp_pieces(32, seen)
    train_loop(step, state, loader, epochs=1, fuse=False)
    reference = [i for b in seen for i in b]
    assert len(reference) == 128
    seen.clear()
    step, state, loader, _ = _mlp_pieces(32, seen)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    with faults.scope("data.fetch@step=3"):
        with pytest.raises(FaultInjectedError):
            train_loop(step, state, loader, epochs=1, checkpoint=mgr, save_every=1)
    assert mgr.latest_step() == 2
    prefix = [i for b in seen[:2] for i in b]
    seen.clear()
    step, state, loader, _ = _mlp_pieces(16, seen)
    reg = MetricsRegistry()
    _, summary = train_loop(step, state, loader, epochs=1, resume=True, metrics=reg,
                            checkpoint=CheckpointManager(str(tmp_path / "run"),
                                                         async_save=False))
    tail = [i for b in seen for i in b]
    assert summary["resumed_from"] == 2 and summary["epochs"] == 1
    assert prefix + tail == reference
    assert reg.counter("train.resumes").value == 1
    assert reg.counter("train.resumes", topology_changed="true").value == 1
    assert prefix + tail == _jax_elastic_ids(world, tmp_path / "jax")


def test_train_loop_same_topology_resume_label_stays_false(tmp_path):
    step, state, loader, _ = _mlp_pieces(32)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    train_loop(step, state, loader, steps=2, checkpoint=mgr, save_every=2)
    reg = MetricsRegistry()
    step, state, loader, _ = _mlp_pieces(32)
    _, summary = train_loop(step, state, loader, steps=4, checkpoint=mgr, resume=True,
                            metrics=reg)
    assert summary["updates"] == 4
    assert reg.counter("train.resumes").value == 1
    assert reg.counter("train.resumes", topology_changed="true").value == 0


def test_train_loop_remap_reseats_scan_group_boundary(tmp_path):
    step, state, loader, _ = _mlp_pieces(16)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=False)
    with faults.scope("data.fetch@step=4"):
        with pytest.raises(FaultInjectedError):
            train_loop(step, state, loader, epochs=1, checkpoint=mgr, save_every=1)
    assert mgr.latest_step() == 3
    _, state, loader, model = _mlp_pieces(32)
    step2 = make_train_step(
        lambda p, ms, b: (((torch.func.functional_call(model, p, (b[0],)) - b[1]) ** 2)
                          .mean(), ms), optim.adam(1e-3), scan_steps=2, grad_reduce=None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the re-seen round-down warning
        _, summary = train_loop(step2, state, loader, epochs=1, checkpoint=mgr,
                                resume=True)
    assert summary["resumed_from"] == 3
    assert summary["updates"] == 7 and summary["epochs"] == 1


def test_resize_four_to_two_workers_is_sample_exact(worlds, world, inputs):
    """The 4-worker world drains at the flush after rank 0's request and
    hands off; the 2-worker world resumes and finishes the epoch. The ids
    both consumed are JAX's single-process order; the final loss is
    JAX's within rtol 5e-3; one valid record is banked."""
    tmp, res = worlds
    four = [r["resize"] for r in res["w4"]]
    two = [r["resize"] for r in res["w2b"]]
    assert all(r["summary"]["resized_to"] == 2 and r["summary"]["updates"] == 4
               for r in four)
    assert four[0]["stamp"]["from_processes"] == 4 and four[0]["stamp"]["step"] == 4
    assert all(r["summary"]["resumed_from"] == 4 and r["summary"]["updates"] == 8
               and r["summary"]["epochs"] == 1 and r["stamp"] is None for r in two)
    ids = sorted(i for r in four + two for b in r["consumed"] for i in b)
    from fluxmpi_tpu.models import MLP as JMLP

    x = inputs["x"]
    ds = JArrayDataset((x, x ** 2, inputs["ids"]))
    order = [i for b in JLoader(ds, 16, shuffle=True, seed=7, prefetch=0,
                                device_gather=False) for i in np.asarray(b[2]).tolist()]
    assert ids == sorted(order) and len(ids) == 128
    # Batch by batch: each update's rows over the world are JAX's batch.
    batches = [sum((r["consumed"][u] for r in four), []) for u in range(4)]
    batches += [sum((r["consumed"][u] for r in two), []) for u in range(4)]
    assert [sorted(b) for b in batches] == [sorted(order[16 * u:16 * u + 16])
                                             for u in range(8)]
    # JAX's uninterrupted run from the same weights.
    model = JMLP(features=(16, 1))
    params = {"params": {k.split(".")[0]: {} for k in _pick(inputs, "mlp/")}}
    for k, v in _pick(inputs, "mlp/").items():
        layer, leaf = k.split(".")
        params["params"][layer][leaf] = v

    def loss_fn(p, ms, b):
        return jnp.mean((model.apply(p, b[0]) - b[1]) ** 2), ms

    opt = optax.adam(1e-3)
    _, jsum = jax_train_loop(jax_make_train_step(loss_fn, opt, mesh=world),
                             jreplicate(JaxTrainState.create(params, opt), world),
                             JLoader(ds, 16, mesh=world, shuffle=True, seed=7, prefetch=0,
                                     device_gather=False), epochs=1, flush_every=2)
    np.testing.assert_allclose(two[0]["summary"]["loss"], jsum["loss"], rtol=5e-3)
    with open(tmp / "resize_bank.jsonl") as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert len(records) == 1
    rec = records[0]
    assert validate_resize_record(rec) == [] == jvalidate_resize(rec)
    assert (rec["from_processes"], rec["to_processes"], rec["step"]) == (4, 2, 4)
    assert rec["reason"] == "test-shrink"
