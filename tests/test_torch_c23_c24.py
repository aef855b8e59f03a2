"""ROADMAP C.23 and C.24 in real gloo worlds of the port.

C.23: a replicated ``CheckpointManager.save`` is written by the lead
worker, and every worker takes part in its commit (the JAX package runs
its named barriers on every process), so on every worker
``wait_until_finished()`` returns only after the commit and
``latest_step()`` then reads the committed step; sync and async, at 2 and
4 ranks (a ``FileStore`` in the test's temporary directory, one thread
each). The lead's file write is slowed on purpose, so a worker that does
not wait for the commit reads ``None``; an async ``save()`` still returns
on every worker before the commit.

C.24: three ``shutdown()``/``init()`` cycles in a 4-worker launcher world
(:mod:`fluxmpi_tpu_torch.launch`), as ``examples/parallelism_3d.py``
makes them (a plan with ``dp``, ``sp`` and ``tp``, then ``dp`` x ``ep``,
then ``dp`` x ``pp``), with rank 0 late to every shutdown: the early
workers initialize the next world while rank 0 still holds the previous
one. Each world runs an all-reduce over its workers. The run has its own
time limit; a hang fails the test with the workers' output.
"""

import os
import re
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT = 180

C23_WORKER = textwrap.dedent('''
    import sys
    import time
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store_path, ckdir, out = (int(sys.argv[1]), int(sys.argv[2]),
                                           sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState
    from fluxmpi_tpu_torch.utils import CheckpointManager
    from fluxmpi_tpu_torch.utils import checkpoint as ck

    # The lead's write takes a while: a worker that does not wait for the
    # commit reads no step.
    write = ck._write_file

    def slow_write(target, obj):
        time.sleep(0.5)
        write(target, obj)

    ck._write_file = slow_write
    fm.init(device="cpu")
    model = MLP(features=(8, 1), device="cpu", generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, optim.sgd(0.1))
    res = {}
    for mode in ("sync", "async"):
        mgr = CheckpointManager(f"{ckdir}_{mode}", async_save=mode == "async")
        mgr.save(5, {"state": state})
        res[f"{mode}/after_save"] = -1 if mgr.latest_step() is None else mgr.latest_step()
        mgr.wait_until_finished()
        res[f"{mode}/after_wait"] = -1 if mgr.latest_step() is None else mgr.latest_step()
        mgr.save(6, {"state": state})
        mgr.wait_until_finished()
        res[f"{mode}/steps"] = np.array(mgr.all_steps())
        res[f"{mode}/writes"] = len(mgr.write_seconds)
        mgr.close()
    np.savez(out, **res)
    fm.shutdown()
    dist.barrier()
    dist.destroy_process_group()
''')


def _run_world(tmp_path, world):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp_path / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", C23_WORKER, str(rank), str(world),
             str(tmp_path / "store"), str(tmp_path / "ck"), str(tmp_path / f"out{rank}.npz")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    text = "\n".join((tmp_path / f"rank{r}.log").read_text() for r in range(world))
    assert [p.returncode for p in procs] == [0] * world, text
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_c23_every_worker_sees_the_replicated_commit_after_its_wait(tmp_path, world):
    results = _run_world(tmp_path, world)
    for rank, res in enumerate(results):
        for mode in ("sync", "async"):
            assert int(res[f"{mode}/after_wait"]) == 5, (rank, mode)
            assert list(res[f"{mode}/steps"]) == [5, 6], (rank, mode)
            # The lead writes; the others only take part in the commit.
            assert int(res[f"{mode}/writes"]) == (2 if rank == 0 else 0), (rank, mode)
        # A sync save returns after the commit, an async one before it.
        assert int(res["sync/after_save"]) == 5, rank
        assert int(res["async/after_save"]) == -1, rank


REINIT = textwrap.dedent('''
    import os
    import sys
    import time
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import launch, runtime

    status = launch.spawn(4, cpu=True)
    if status is not None:
        sys.exit(status)
    rank = int(os.environ["RANK"])
    worlds = [dict(parallel=fm.ParallelConfig(dp=1, sp=2, tp=2)),
              dict(mesh_shape={"dp": 1, "ep": 4}),
              dict(mesh_shape={"dp": 1, "pp": 4})]
    for cycle, kw in enumerate(worlds):
        fm.init(device="cpu", **kw)
        t = torch.full((1,), float(rank + 1))
        dist.all_reduce(t)
        assert t.item() == 10.0, (cycle, t)
        assert dict(runtime.global_mesh().shape) == dict(
            kw.get("mesh_shape") or {"dp": 1, "sp": 2, "tp": 2}), runtime.global_mesh().shape
        if rank == 0:
            time.sleep(0.5)  # late to the shutdown: the others init first
        fm.shutdown()
        print(f"REINIT rank {rank} cycle {cycle}", flush=True)
''')


def test_c24_three_shutdown_init_cycles_in_a_four_worker_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "CUDA_VISIBLE_DEVICES"):
        env.pop(name, None)
    script = tmp_path / "reinit.py"
    script.write_text(REINIT)
    log = tmp_path / "reinit.log"
    with open(log, "w") as f:
        launcher = subprocess.Popen([sys.executable, str(script)], cwd=ROOT, env=env,
                                    stdout=f, stderr=subprocess.STDOUT)
        try:
            launcher.wait(timeout=120)
        except subprocess.TimeoutExpired:
            # SIGTERM: the launcher stops its workers on the way out.
            launcher.send_signal(signal.SIGTERM)
            try:
                launcher.wait(timeout=20)
            except subprocess.TimeoutExpired:
                launcher.kill()
                launcher.wait()
    text = log.read_text()
    assert launcher.returncode == 0, f"rc {launcher.returncode}:\n{text}"
    # The workers share the log: lines may interleave.
    done = set(re.findall(r"REINIT rank (\d) cycle (\d)", text))
    assert done == {(str(r), str(c)) for r in range(4) for c in range(3)}, text
