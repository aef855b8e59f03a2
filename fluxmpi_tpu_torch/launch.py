"""Start a script's workers on this machine, one process per worker, with
the launcher's environment that :func:`~fluxmpi_tpu_torch.init` reads
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them).

A script that wants ``n`` workers calls :func:`spawn` first: in a process
the launcher started it returns None and the script runs as one worker;
otherwise it starts the ``n`` workers (the same script and arguments),
waits for them and returns the exit status to end with (the first
failing worker's, and the others are stopped then).
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Sequence

__all__ = ["spawn"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(nproc: int, cmd: Sequence[str], *, cpu_threads: int | None = None) -> int:
    """Run ``cmd`` as ``nproc`` workers on localhost and wait for them:
    the first non-zero exit status (the rest are then stopped), else 0.
    ``cpu_threads`` sets each worker's ``OMP_NUM_THREADS``."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(nproc))
    if cpu_threads is not None:
        env["OMP_NUM_THREADS"] = str(cpu_threads)
    procs = [subprocess.Popen(list(cmd), env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(nproc)]
    status = 0
    # A launcher ended by SIGTERM stops its workers on the way out.
    previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                status = failed[0]
                break
            time.sleep(0.05)
        else:
            status = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        signal.signal(signal.SIGTERM, previous)
    return status


def spawn(nproc: int, *, cpu: bool = False) -> int | None:
    """Start ``nproc`` workers of this script unless this process is one
    (the launcher's ``RANK`` is set) or ``nproc`` is 1: then None, and the
    caller runs as a worker. Otherwise the workers' exit status, after
    they ended. ``cpu=True`` gives each worker one CPU thread."""
    if "RANK" in os.environ or nproc == 1:
        return None
    return run_workers(nproc, [sys.executable, *sys.argv],
                       cpu_threads=1 if cpu else None)

