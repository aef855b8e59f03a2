"""One fixed-shape decode step run as a CUDA graph: the decode paths'
counterpart of the JAX package's scanned and jitted programs
(``generate``'s and ``beam_search``'s ticks, the serving engine's decode
step and its prefill per prompt bucket).

A :class:`StepGraph` wraps ``body()``, a function of no arguments that
reads and writes only tensors that stay where they are between calls
(static buffers; the model's parameters; the KV pools). On the CPU every
call runs ``body`` eagerly. On the card the first call runs it eagerly on
the program's own stream, as a real step (kernel builds, cuBLAS handles
and the allocator warm up there), the second captures it as one CUDA graph
and replays it, and every later call is one replay. A call given other
``bound`` addresses than the graph was captured against (new parameter
tensors, new pools) captures anew. A capture or a replay that fails
raises, naming the program; nothing falls back to eager steps.

Launch accounting, as :class:`~fluxmpi_tpu_torch.parallel.train.WindowProgram`
keeps it: a capture raises the attention wrappers' counters and launches
nothing, a replay launches the graph's kernels without the wrappers.
:func:`graph_launches` sums, over every step graph of the process, the
replayed launches less the captured ones, so the device ran the wrappers'
counts plus that.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Callable

import torch

__all__ = ["StepGraph", "graph_launches"]

# Replayed less captured launches per kernel, over every StepGraph.
_launch_delta: Counter = Counter()
_delta_lock = threading.Lock()


def graph_launches() -> dict[str, int]:
    """Per attention kernel, what every step graph's replays added to the
    wrappers' launch counters less what its captures added without
    launching: the device ran the wrappers' counts plus this."""
    from ..ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd

    with _delta_lock:
        return {f.__name__: _launch_delta.get(f.__name__, 0)
                for f in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)}


def _launch_counts() -> dict[str, int]:
    from ..ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd

    return {f.__name__: f.launches for f in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)}


class StepGraph:
    """``body()`` as one CUDA graph per call on the card (module
    docstring). ``name`` names the program in errors and in the compile
    plane; ``generators`` are CUDA generators ``body`` draws from, each
    registered with every capture so that a replay draws afresh;
    ``track``: report each capture to the compile monitor under ``name``
    (:meth:`~fluxmpi_tpu_torch.telemetry.compileplane.CompileMonitor.note_aot_compile`).

    Counters: ``captures``, ``recaptures`` (captures that replaced a graph
    because ``bound`` moved), ``replays``, ``capture_seconds`` (capture
    and instantiation), ``pool_bytes`` (what the last capture's private
    memory pool reserved), ``captured_launches`` (the current graph's, per
    kernel), ``capture_counted`` and ``replayed_launches`` (over every
    capture and replay)."""

    def __init__(self, name: str, body: Callable[[], object], device, *,
                 generators=(), track: bool = False):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.generators = list(generators)
        self.track = track
        self.graph = None
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.captured_launches: dict[str, int] = {}
        self.capture_counted: Counter = Counter()
        self.replayed_launches: Counter = Counter()
        self._warm = False
        self._stream = None
        self._bound: tuple = ()

    @property
    def built(self) -> bool:
        """Whether the next call replays a built program (on the CPU:
        whether ``body`` has run once)."""
        return self.graph is not None or (self.device.type != "cuda" and self._warm)

    def __call__(self, bound: tuple = ()) -> None:
        if self.device.type != "cuda":
            self._warm = True
            with torch.no_grad():
                self.body()
            return
        if not self._warm:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream), torch.no_grad():
                self.body()
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            self._warm = True
            self._bound = bound
            return
        if self.graph is None or bound != self._bound:
            self.recaptures += self.graph is not None
            self._capture()
            self._bound = bound
        try:
            self.graph.replay()
        except Exception as exc:
            raise RuntimeError(f"replaying {self.name} as a CUDA graph failed "
                               f"({exc})") from exc
        self.replays += 1
        self.replayed_launches.update(self.captured_launches)
        with _delta_lock:
            _launch_delta.update(self.captured_launches)

    def _capture(self) -> None:
        from .. import runtime
        from ..telemetry import compileplane
        from .profiling import capture_lock

        self.graph = None
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _launch_counts()
        # No profiler starts or stops while the graph is captured.
        with capture_lock:
            # torch.cuda.graph empties the allocator's cache before the
            # capture; done here first, the growth is the graph's pool.
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            try:
                # thread_local: the engine's serve thread may capture while
                # other threads use CUDA.
                with torch.cuda.graph(graph, stream=self._stream,
                                      capture_error_mode="thread_local"), \
                        torch.no_grad():
                    self.body()
            except Exception as exc:
                raise RuntimeError(
                    f"capturing {self.name} as a CUDA graph failed ({exc}); the "
                    f"step must run without reading device values on the host"
                ) from exc
            seconds = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        after = _launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.capture_counted.update(self.captured_launches)
        with _delta_lock:
            _launch_delta.subtract(self.captured_launches)
        self.capture_seconds += seconds
        self.captures += 1
        self.graph = graph
        compileplane.note_duration(compileplane.CAPTURE_EVENT, seconds)
        mon = compileplane.get_compile_monitor() if self.track else None
        if mon is not None:
            mon.note_aot_compile(self.name, seconds)
        runtime.note_captured_graph(self)

    def release_graph(self) -> None:
        """Drop the captured graph and its memory pool (the next call
        captures anew)."""
        self.graph, self._bound = None, ()
