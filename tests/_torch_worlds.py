"""Start and join the gloo worlds of ``tests/_torch_seq_worker.py`` (one
process per rank, a ``FileStore`` in the world's directory, one thread
each, a join timeout): shared by the sequence- and pipeline-parallel test
modules."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_seq_worker.py"
JOIN_TIMEOUT = 300


def start_world(group, tmp, world, data_path, worker=WORKER):
    """Start the ranks of one world of ``worker`` (a script taking ``GROUP
    RANK WORLD STORE OUT DATA``); :func:`join_world` joins them."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), group, str(rank), str(world),
             str(tmp / "store"), str(tmp / f"rank{rank}.npz"), str(data_path)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return tmp, world, procs, logs


def join_world(tmp, world, procs, logs, timeout=JOIN_TIMEOUT):
    """Each rank's results (a dict per rank); fails with every rank's log
    when a rank failed or hung (past ``timeout`` seconds)."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    text = "\n".join((tmp / f"rank{r}.log").read_text() for r in range(world))
    assert not hung, f"a rank hung past {timeout}s:\n{text}"
    assert all(p.returncode == 0 for p in procs), text
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=False)) for r in range(world)]
