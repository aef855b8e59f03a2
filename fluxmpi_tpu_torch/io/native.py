"""ctypes bindings for the native data-pipeline runtime.

Counterpart of :mod:`fluxmpi_tpu.io.native`. Builds this package's copy of
``native_loader.cpp`` into a shared library at first use (``g++ -O3
-march=native -shared``; the ABI is C and the binding ctypes) and exposes:

- :func:`gather_rows`: a multithreaded gather of scattered dataset rows
  into one contiguous batch buffer (the hot host-side op of batch
  assembly);
- :class:`NativePrefetcher`: a bounded producer/consumer queue building
  the next batches on C++ threads while the device runs the current step.

The library goes to ``_build/`` beside this file (git-ignored), named by a
hash of the host, its architecture and the source, since ``-march=native``
binds it to the machine that built it. Without a working ``g++`` both fall
back to numpy (``native_available()`` is then False), as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

__all__ = ["NativePrefetcher", "gather_rows", "native_available"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "native_loader.cpp"
BUILD_DIR = _HERE / "_build"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _lib_path() -> Path:
    """The library's path, keyed by host, architecture and source."""
    key = hashlib.sha1(
        f"{platform.node()}|{platform.machine()}|".encode() + _SRC.read_bytes()
    ).hexdigest()[:16]
    return BUILD_DIR / f"native_loader_{key}.so"


def _build(lib_path: Path) -> bool:
    # Write to a unique temporary name, then rename: two processes racing
    # the build never leave a torn library at the final path.
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", str(_SRC), "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, lib_path)
        return True
    except Exception as e:  # the toolchain is missing or refused the source
        warnings.warn(f"native loader build failed ({e}); using numpy fallback")
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib_path = _lib_path()
        if not lib_path.exists() and not _build(lib_path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            # A stale or torn artifact: rebuild once, then give up to the
            # numpy fallback rather than fail mid-epoch.
            if not _build(lib_path):
                _build_failed = True
                return None
            try:
                lib = ctypes.CDLL(str(lib_path))
            except OSError as e:
                warnings.warn(f"native loader unusable ({e}); numpy fallback")
                _build_failed = True
                return None
        p, u64 = ctypes.c_void_p, ctypes.c_uint64
        lib.fm_gather.argtypes = [p, u64, p, u64, p, ctypes.c_int]
        lib.fm_gather.restype = None
        lib.fm_prefetch_create.argtypes = [p, u64, p, u64, u64, u64, ctypes.c_int]
        lib.fm_prefetch_create.restype = p
        lib.fm_prefetch_next.argtypes = [p, p]
        lib.fm_prefetch_next.restype = ctypes.c_int64
        lib.fm_prefetch_destroy.argtypes = [p]
        lib.fm_prefetch_destroy.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the C++ runtime is built (or buildable)."""
    return _load() is not None


def _as_2d_rows(array: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(array)
    return a.reshape(a.shape[0], -1)


def _default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def gather_rows(array: np.ndarray, indices: np.ndarray, *,
                threads: int | None = None) -> np.ndarray:
    """``array[indices]`` along axis 0, gathered by the C++ thread pool
    (numpy when the native library is unavailable)."""
    lib = _load()
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(array)):
        # The C++ gather is a raw memcpy: bounds are enforced here.
        raise IndexError(
            f"gather index out of range [0, {len(array)}): "
            f"min={idx.min()}, max={idx.max()}"
        )
    if lib is None:
        return array[idx]
    flat_idx = idx.reshape(-1)  # numpy's result for multi-dim index arrays
    a2 = _as_2d_rows(array)
    out = np.empty((flat_idx.size, a2.shape[1]), dtype=array.dtype)
    lib.fm_gather(a2.ctypes.data_as(ctypes.c_void_p), a2.shape[1] * array.dtype.itemsize,
                  flat_idx.ctypes.data_as(ctypes.c_void_p), flat_idx.size,
                  out.ctypes.data_as(ctypes.c_void_p), threads or _default_threads())
    return out.reshape(idx.shape + array.shape[1:])


class NativePrefetcher:
    """Assemble an epoch's batches on background C++ threads.

    Wraps one contiguous dataset array; ``__iter__`` yields the gathered
    batch arrays ``array[order[b * batch_rows:(b + 1) * batch_rows]]`` in
    epoch order (whole batches only) while the next ones build
    concurrently. ``NativePrefetcher.served`` counts, over the process,
    the batches the C++ queue handed out (the numpy fallback adds none).
    """

    served = 0

    def __init__(self, array: np.ndarray, order: np.ndarray, batch_rows: int, *,
                 queue_capacity: int = 3, threads: int | None = None):
        self._array = np.ascontiguousarray(array)
        self._order = np.ascontiguousarray(order, dtype=np.int64)
        if self._order.size and (self._order.min() < 0
                                 or self._order.max() >= len(array)):
            raise IndexError(
                f"order index out of range [0, {len(array)}): "
                f"min={self._order.min()}, max={self._order.max()}"
            )
        self._batch_rows = int(batch_rows)
        self._n_batches = len(self._order) // self._batch_rows
        self._row_shape = array.shape[1:]
        self._dtype = array.dtype
        self._lib = _load()
        self._capacity = queue_capacity
        self._threads = threads or _default_threads()

    def __len__(self) -> int:
        return self._n_batches

    def __iter__(self):
        if self._lib is None:
            for b in range(self._n_batches):
                idx = self._order[b * self._batch_rows:(b + 1) * self._batch_rows]
                yield self._array[idx]
            return
        a2 = _as_2d_rows(self._array)
        handle = self._lib.fm_prefetch_create(
            a2.ctypes.data_as(ctypes.c_void_p), a2.shape[1] * self._dtype.itemsize,
            self._order.ctypes.data_as(ctypes.c_void_p), len(self._order),
            self._batch_rows, self._capacity, self._threads)
        if not handle:
            raise RuntimeError("fm_prefetch_create failed")
        try:
            for _ in range(self._n_batches):
                out = np.empty((self._batch_rows,) + self._row_shape, dtype=self._dtype)
                got = self._lib.fm_prefetch_next(handle, out.ctypes.data_as(ctypes.c_void_p))
                if got < 0:
                    return
                NativePrefetcher.served += 1
                yield out
        finally:
            self._lib.fm_prefetch_destroy(handle)
