"""CUDA graphs of the optimiser iterations: the port's counterpart of the
JAX package's jitted `lax.scan` bodies (nice_slam_tpu/tracking.py:164-212,
nice_slam_tpu/mapping.py:444-471), which compile one optimiser iteration
once and replay it as one program.

`StepGraphs` keeps, for each *signature* of a step, a captured
`torch.cuda.CUDAGraph` of one iteration.  A signature's key holds every
Python value that enters the step (stage, shapes, frozen set, learning
rates, render spec, ...) and the static buffers it reads and writes: the
optimised leaves, Adam's moments, the step counter and the inputs live in
buffers that the step updates in place, so one graph serves every
iteration.  Per signature:

- the first iteration runs eagerly (the warm-up: lazy cuBLAS workspaces,
  the kernels' one-time attributes, the weight-image index and the grid
  constants are made here, outside any capture);
- the second is captured and then replayed;
- every later iteration is a replay.

Warm-up and capture run on a side stream of the runner (the legacy
default stream cannot be captured) fenced both ways against the caller's
stream; replays run on the caller's stream.  All graphs of one runner
share one memory pool; a runner is one side (tracker or mapper) of an
engine, and replays of one runner never overlap.  The capture uses
`capture_error_mode="thread_local"`: the pipelined engine's other thread
allocates while this one captures.  The step's generators are registered
with each graph, so every replay advances their Philox offsets as the
eager calls would.

A capture executes nothing: the fused-decode launch counters record what
a capture launches (`fused_decode.count_captured`) and each replay credits
it.  On a CPU device (and for `capture=False`) every iteration runs the
step eagerly, so the CPU tests run the same step code that the card
captures.  A failed capture raises; nothing falls back to eager.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from nice_slam_torch.ops import fused_decode


def tensor_key(tensors: Sequence[torch.Tensor]) -> tuple:
    """Where and what each tensor is (address, shape, strides, dtype): a
    graph reads its inputs by address, so a signature that holds this
    replays on whatever those buffers hold at replay time."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


class _Graph:
    # the generators are held so that no other generator can take their
    # id (a signature holds it) while the graph that advances them lives
    __slots__ = ("graph", "launches", "generators")

    def __init__(self, graph, launches, generators):
        self.graph = graph
        self.launches = launches
        self.generators = generators


class StepGraphs:
    """Captured iterations of one side of an engine on `device`.

    `buffers(key, make)` caches a step's static buffers (made once by
    `make()`).  `step(key, fn, generators)` runs one iteration `fn()` of
    the signature `key` (None: eagerly, the static choice of the paths
    that are not graphed).  `max_iters` sizes the step counters' tables
    and loss records of the buffers made through this runner (at least the
    iterations of one optimisation call)."""

    def __init__(self, device, capture: Optional[bool] = None,
                 max_iters: int = 0):
        self.device = torch.device(device)
        self.capture = (self.device.type == "cuda" if capture is None
                        else capture)
        if self.capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.max_iters = max_iters
        self._buffers: Dict[Hashable, object] = {}
        self._graphs: Dict[Hashable, _Graph] = {}
        self._warm: set = set()
        self._pool = None
        self._side = None
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.capture_s = 0.0

    def buffers(self, key: Hashable, make: Callable):
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = make()
        return buf

    def step(self, key: Optional[Hashable], fn: Callable,
             generators: Sequence[Optional[torch.Generator]] = ()) -> None:
        if key is None or not self.capture:
            self.eager_steps += 1
            fn()
            return
        g = self._graphs.get(key)
        if g is None:
            if key not in self._warm:
                self._warm.add(key)
                self.eager_steps += 1
                self._on_side(fn)
                return
            g = self._graphs[key] = self._capture(key, fn, generators)
        g.graph.replay()
        fused_decode.credit_launches(g.launches)
        self.replays += 1

    def stats(self) -> dict:
        return {"graphs": len(self._graphs), "captures": self.captures,
                "replays": self.replays, "eager_steps": self.eager_steps,
                "capture_s": self.capture_s}

    def pool_bytes(self) -> int:
        """Bytes of the device segments that belong to this runner's
        memory pool (from the caching allocator's snapshot)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _on_side(self, fn: Callable) -> None:
        """fn() on the side stream, after the caller's stream's work and
        before its next."""
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)

    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _capture(self, key, fn: Callable, generators) -> _Graph:
        t0 = time.perf_counter()
        graph = self._new_graph()
        defaults = torch.cuda.default_generators
        for gen in generators:
            if gen is not None and all(gen is not d for d in defaults):
                graph.register_generator_state(gen)
        launches = self._record(graph, fn, key)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return _Graph(graph, launches, tuple(generators))

    def _record(self, graph, fn: Callable, key) -> dict:
        """Capture fn() into `graph` on the side stream; returns the
        fused-decode launches it recorded."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(side), \
                fused_decode.count_captured(side) as launches:
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                fn()
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture is already invalid: report fn's error
                raise RuntimeError(
                    f"CUDA graph capture of the step {key[0]!r} failed at "
                    f"the op below: {e}") from e
            graph.capture_end()
        cur.wait_stream(side)
        return launches
