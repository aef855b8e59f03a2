"""The host-staging collectives (the reference's CPU-staging fallback for
CUDA-unaware MPI) in 2- and 4-rank gloo worlds, against the device path
and the JAX package's host path.

Each rank is a process started with
``FLUXMPI_TPU_DISABLE_DEVICE_COLLECTIVES=1`` (gloo over a ``FileStore`` in
the test's temporary directory, one thread each). It runs ``allreduce``
(sum, prod, min, max, mean), ``bcast`` (two roots), ``reduce`` (sum and
mean at the last rank) and ``iallreduce`` (sum, max) on a tree of f32 and
int32 leaves through the staged path, then the same calls with
``config.DEVICE_COLLECTIVES_DISABLED`` set to False (the device path;
gloo here), and ``synchronize``. The test holds every staged result equal
to the device path's and, per leaf, to the JAX package's
``_host_collective`` over as many CPU devices (``config.
DEVICE_COLLECTIVES_DISABLED`` patched on there), bit for bit: the values
are small multiples of 1/2, exact in f32 in any summation order. Each
rank also checks that ``donate=True`` warns that it has no effect, that
the ``comm.calls`` rows and the flight recorder carry path ``"host"``,
and that a ``comm.allreduce`` fault fires before any staging."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import fluxmpi_tpu as jfm
from fluxmpi_tpu import config as jconfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 180
ALLREDUCE_OPS = ("sum", "prod", "min", "max", "mean")


def values(rank: int, world: int) -> dict:
    """Rank ``rank``'s tree: small multiples of 1/2 (f32) and small ints."""
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    return {"f": (base - 2 + rank) / 2 + (rank == world - 1),
            "i": (np.arange(4, dtype=np.int32) * (rank + 1) - rank)}


WORKER = textwrap.dedent('''
    import sys
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import comm, config, faults, telemetry
    from test_torch_host_staging import ALLREDUCE_OPS, values

    assert config.DEVICE_COLLECTIVES_DISABLED
    fm.init(device="cpu")
    reg = telemetry.MetricsRegistry()
    telemetry.set_registry(reg)
    tree = {k: torch.from_numpy(v) for k, v in values(rank, world).items()}

    def run_all():
        res = {}
        for op in ALLREDUCE_OPS:
            r = fm.allreduce(tree, op)
            res.update({f"allreduce_{op}_{k}": v.numpy() for k, v in r.items()})
        for root in (0, world - 1):
            r = fm.bcast(tree, root)
            res.update({f"bcast_{root}_{k}": v.numpy() for k, v in r.items()})
        for op in ("sum", "mean"):
            r = fm.reduce(tree, op, root=world - 1)
            res.update({f"reduce_{op}_{k}": v.numpy() for k, v in r.items()})
        for op in ("sum", "max"):
            value, req = fm.iallreduce(tree, op)
            r = req.wait()
            res.update({f"iallreduce_{op}_{k}": v.numpy() for k, v in r.items()})
        r = fm.synchronize({k: v + rank for k, v in tree.items()}, root_rank=world - 1)
        res.update({f"synchronize_{k}": v.numpy() for k, v in r.items()})
        return res

    staged = run_all()
    calls = {(m["labels"]["op"], m["labels"]["path"]): m["value"]
             for m in reg.snapshot() if m["name"] == "comm.calls"}
    flight = {(e["op"], e["path"]) for e in
              telemetry.get_flight_recorder().dump()["entries"]}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        donated = fm.allreduce(tree, donate=True)
    donate_warned = any("donate=True has no effect" in str(w.message) for w in caught)
    staging_calls = []
    real = comm._host_buffer
    comm._host_buffer = lambda flat: staging_calls.append(1) or real(flat)
    faults.install("comm.allreduce@step=1")
    try:
        fm.allreduce(tree)
        fault_fired = False
    except fm.FaultInjectedError:
        fault_fired = True
    faults.clear()
    comm._host_buffer = real
    config.DEVICE_COLLECTIVES_DISABLED = False
    device = run_all()
    np.savez(out, **{"staged/" + k: v for k, v in staged.items()},
             **{"device/" + k: v for k, v in device.items()},
             calls=np.array(sorted(f"{o}/{p}={n}" for (o, p), n in calls.items())),
             flight=np.array(sorted(f"{o}/{p}" for o, p in flight)),
             donate_warned=donate_warned, donate_new=donated is not tree,
             fault_fired=fault_fired, staged_before_fault=len(staging_calls))
    fm.shutdown()
    # No rank tears its group down while a peer's last collective is in
    # flight with it.
    dist.barrier()
    dist.destroy_process_group()
''')


def _run_world(world, tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               FLUXMPI_TPU_DISABLE_DEVICE_COLLECTIVES="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(tmp / "store"),
         str(tmp / f"rank{r}.npz"), str(ROOT / "tests")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _jax_host(world, monkeypatch):
    """The JAX package's host path over ``world`` CPU devices: per leaf,
    the stacked per-worker values through its allreduce/bcast/reduce."""
    monkeypatch.setattr(jconfig, "DEVICE_COLLECTIVES_DISABLED", True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("dp",))
    stacked = {k: np.stack([values(r, world)[k] for r in range(world)])
               for k in values(0, world)}
    out = {}
    for k, x in stacked.items():
        for op in ALLREDUCE_OPS:
            if op == "mean" and k == "i":
                continue  # JAX's mean of integers is a float; the port floors
            out[f"allreduce_{op}_{k}"] = np.asarray(jfm.allreduce(x, op, mesh=mesh))
        for root in (0, world - 1):
            out[f"bcast_{root}_{k}"] = np.asarray(jfm.bcast(x, root, mesh=mesh))
        for op in ("sum", "mean"):
            if op == "mean" and k == "i":
                continue
            out[f"reduce_{op}_{k}"] = np.asarray(
                jfm.reduce(x, op, world - 1, mesh=mesh))
        for op in ("sum", "max"):
            value, req = jfm.iallreduce(x, op, mesh=mesh)
            req.wait()
            out[f"iallreduce_{op}_{k}"] = np.asarray(value)
    return out


@pytest.mark.parametrize("world_size", [2, 4])
def test_staged_collectives_equal_the_device_path_and_jax(world, world_size, tmp_path,
                                                          monkeypatch):
    ranks = _run_world(world_size, tmp_path)
    ref = _jax_host(world_size, monkeypatch)
    for rank, res in enumerate(ranks):
        staged = {k[len("staged/"):]: v for k, v in res.items() if k.startswith("staged/")}
        device = {k[len("device/"):]: v for k, v in res.items() if k.startswith("device/")}
        assert set(staged) == set(device) and len(staged) == 2 * 12
        for name, v in staged.items():
            assert v.dtype == device[name].dtype, name
            np.testing.assert_array_equal(v, device[name], err_msg=name)
        for name, stacked in ref.items():
            np.testing.assert_array_equal(staged[name], stacked[rank], err_msg=name)
        root = values(world_size - 1, world_size)
        for k in ("f", "i"):
            np.testing.assert_array_equal(staged[f"synchronize_{k}"],
                                          root[k] + world_size - 1)
        assert list(res["calls"]) == ["allreduce/host=7.0", "bcast/host=2.0",
                                      "reduce/host=2.0"]
        assert list(res["flight"]) == ["allreduce/host", "bcast/host", "reduce/host"]
        assert bool(res["donate_warned"]) and bool(res["donate_new"])
        assert bool(res["fault_fired"]) and int(res["staged_before_fault"]) == 0


def test_staging_off_keeps_the_device_path(monkeypatch):
    """Without the preference every collective records path ``device``
    (a one-process gloo world here)."""
    import fluxmpi_tpu_torch as tfm
    from fluxmpi_tpu_torch import comm, config, telemetry

    monkeypatch.setattr(config, "DEVICE_COLLECTIVES_DISABLED", False)
    staged = []
    monkeypatch.setattr(comm, "_host_buffer", lambda flat: staged.append(1))
    tfm.init(device="cpu")
    reg = telemetry.MetricsRegistry()
    prev = telemetry.set_registry(reg)
    try:
        tfm.allreduce({"a": torch.ones(3)})
        tfm.bcast(torch.ones(2))
        tfm.synchronize({"b": torch.ones(2)})
    finally:
        telemetry.set_registry(prev)
        tfm.shutdown()
    assert {m["labels"]["path"] for m in reg.snapshot() if m["name"] == "comm.calls"} \
        == {"device"}
    assert staged == []
