"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`. The
build happens at first use, into ``ops/_build/`` (ignored by git), under a
name that carries a hash of the source, so an edited kernel is rebuilt and
an unchanged one is loaded as it is. Nothing is compiled when a module is
imported.

:func:`set_build_dir` points the build at another directory: the
persistent store of compiled kernels that ``init(compile_cache=)`` and
``FLUXMPI_TPU_COMPILE_CACHE`` name (the counterpart of the JAX package's
persistent XLA compilation cache), so repeat runs and every process that
shares the directory skip the build. Each ``nvcc`` is timed and reported
to the compile plane (:mod:`fluxmpi_tpu_torch.telemetry.compileplane`) as
a compile event.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "loaded", "set_build_dir"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# The mask, dropout and launch arguments every flash kernel entry ends with:
# b sq sk h hkv d, causal has_window window, dropout seed threshold
# keep_prob, dtype, stream.
_FLASH_TAIL = [_I, _I, _I, _I, _I, _I,
               _I, _I, _I,
               _I, _P, _U, _F,
               _I, _P]
# The C signature of every kernel entry: pointers (the dropout seed's
# device address among them) and the stream as c_void_p (a bare Python int
# would be cut to 32 bits), ints as c_int, the dropout threshold as
# c_uint, keep_prob as c_float.
SOURCES: dict[str, list] = {
    # q k v qseg kseg o lse
    "flash_fwd": [_P] * 7 + _FLASH_TAIL,
    # q k v qseg kseg dout lse dterm dq
    "flash_bwd_dq": [_P] * 9 + _FLASH_TAIL,
    # q k v qseg kseg dout lse dterm dk dv
    "flash_bwd_dkv": [_P] * 10 + _FLASH_TAIL,
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output for each library built by this process (ptxas -v lines).
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ on a machine with the CUDA toolkit"
    )


def set_build_dir(path: str | os.PathLike | None) -> Path:
    """Build and look up the kernels' libraries under ``path`` (``None``:
    the package's own ``ops/_build/``); returns the directory in use.
    Libraries this process has already loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path).expanduser().resolve() if path is not None else _HERE / "_build"
    return BUILD_DIR


def _target(name: str) -> Path:
    # The shared headers are part of every source.
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=None) -> dict[str, Path]:
    """Compile every named source that has no library yet, one ``nvcc``
    per source, all started together. Returns the library paths."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        # One compile event per nvcc, timed from the common start (the
        # builds run together).
        from ..telemetry import compileplane

        compileplane.note_duration(compileplane.BUILD_EVENT, time.perf_counter() - t0)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            fn = getattr(lib, name)
            fn.argtypes = SOURCES[name]
            fn.restype = ctypes.c_int
            lib.device_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), _I]
            lib.device_launches.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def loaded(name: str) -> ctypes.CDLL | None:
    """The library for ``csrc/<name>.cu`` if this process has loaded it."""
    with _lock:
        return _loaded.get(name)
