"""CUDA graphs of the optimiser iterations: the port's counterpart of the
JAX package's jitted `lax.scan` bodies (nice_slam_tpu/tracking.py:164-212,
nice_slam_tpu/mapping.py:444-471, and the jitted `shard_map`s of
nice_slam_tpu/parallel/data_parallel.py:53-150 and grid_sharded.py:287-386),
which compile one optimiser iteration once and replay it as one program.
Every optimiser step is graphed, in every mode (NICE, iMAP*,
occupancy-guided sampling, with the panels, data-parallel and
grid-sharded): the tracking iteration ("track"), init_select's candidate
renders ("init_select"), each Gauss-Newton iteration of tracking and BA
("gn"), each mapping stage's iteration ("map") and each grid-sharded
mapping iteration ("gs").

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

A step with collectives inside (data-parallel and grid-sharded mapping,
the data-parallel Gauss-Newton polish) is *segmented*
(`step_segments`): it is cut at its collectives into segments, segment i
its own graph under the key (*key, ("segment", i)), and between two
segments a host call runs the collective eagerly on static buffers.  A
gloo all_reduce of a CUDA tensor copies through the host and cannot be
captured; it waits on the caller's stream, on which the replays run.
Each segment warms up, is captured and replays as a step does; its
launches are credited at each of its replays, and it registers the
generators that it draws from.

Warm-up and capture run on a side stream of the runner (the legacy
default stream cannot be captured) fenced both ways against the caller's
stream; replays and host calls run on the caller's stream.  All graphs
of one runner share one memory pool; a runner is one side (tracker or
mapper) of an engine, and replays of one runner never overlap.  The
capture uses `capture_error_mode="thread_local"`: the pipelined engine's
other thread allocates while this one captures.  The step's generators
are registered with each graph, so every replay advances their Philox
offsets as the eager calls would.

A capture executes nothing: the kernels' launch counts record what a
capture launches (ops/launches.py `count_captured`) and each replay
credits it.  On a CPU device (and for `capture=False`) every iteration
runs the step eagerly, so the CPU tests run the same step code that the
card captures.  A failed capture raises; nothing falls back to eager.

Each warm-up and capture is a span "graphs.capture" of the engine's
tracer (utils/profiling.span), whose id is the signature's first key
element.  A replay runs no host code, so nothing inside a graph is a
span.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from nice_slam_torch.ops.launches import count_captured, credit
from nice_slam_torch.utils.profiling import span


def tensor_key(tensors: Sequence[torch.Tensor]) -> tuple:
    """Where and what each tensor is (address, shape, strides, dtype): a
    graph reads its inputs by address, so a signature that holds this
    replays on whatever those buffers hold at replay time."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


@torch.no_grad()
def load_draws(bufs, draws) -> None:
    """One iteration's given draws into their static buffers
    (`StepGraphs.draw_buffers`), between two replays."""
    for buf, x in zip(bufs, draws):
        buf.copy_(x)


def _is_segment(key) -> bool:
    """Whether `key` is the signature of one segment of a segmented step."""
    last = key[-1] if isinstance(key, tuple) and key else None
    return isinstance(last, tuple) and len(last) == 2 \
        and last[0] == "segment"


class Bucket:
    """Tensors of fixed shapes end to end in one flat static fp32 buffer:
    one segment packs them, a host call sums the buffer in place over a
    process group (the collective between two segments), and a later
    segment reads the sums through `views()`."""

    __slots__ = ("flat", "shapes")

    def __init__(self, flat: torch.Tensor, shapes):
        self.flat = flat
        self.shapes = shapes

    def views(self) -> list:
        out, k = [], 0
        for shape in self.shapes:
            n = math.prod(shape)
            out.append(self.flat[k:k + n].view(shape))
            k += n
        return out

    @torch.no_grad()
    def pack(self, tensors) -> None:
        for v, t in zip(self.views(), tensors):
            v.copy_(t.reshape(v.shape))


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
    the signature `key`.  `step_segments(key, segments,
    between, generators)` runs one iteration of a segmented step.
    `max_iters` sizes the step counters' tables and loss records of the
    buffers made through this runner (at least the iterations of one
    optimisation call)."""

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
        self.host_calls = 0
        self.capture_s = 0.0

    def buffers(self, key: Hashable, make: Callable):
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = make()
        return buf

    def bucket(self, key: Hashable, shapes) -> Bucket:
        """The static `Bucket` of `shapes` under `key`."""
        shapes = tuple(tuple(x) for x in shapes)
        n = sum(math.prod(x) for x in shapes)
        return self.buffers(("bucket", key, shapes), lambda: Bucket(
            torch.zeros(n, device=self.device), shapes))

    @torch.no_grad()
    def hold(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """`t` copied into this runner's static buffer (name, shape,
        dtype): a value that one segment hands to a later one of the same
        iteration (a graph reads it there by address)."""
        buf = self.buffers(("hold", name, tuple(t.shape), t.dtype),
                           lambda: torch.empty(t.shape, dtype=t.dtype,
                                               device=t.device))
        return buf.copy_(t)

    def draw_buffers(self, pixels):
        """Static buffers for given per-iteration draws (`pixels`: a list
        of (i, j)), or None: each iteration's draws are copied in
        (`load_draws`) before its replay, so a graph of the step reads
        them where they stay."""
        if pixels is None:
            return None
        return tuple(self.buffers(
            ("draws", k, tuple(x.shape), x.dtype),
            lambda x=x: torch.empty(x.shape, dtype=x.dtype,
                                    device=self.device))
            for k, x in enumerate(pixels[0]))

    def step(self, key: Hashable, fn: Callable,
             generators: Sequence[Optional[torch.Generator]] = ()) -> None:
        if not self.capture:
            self.eager_steps += 1
            fn()
            return
        self._segment(key, fn, generators)

    def step_segments(self, key: Hashable, segments: Sequence[Callable],
                      between: Sequence[Callable],
                      generators: Sequence[Sequence[
                          Optional[torch.Generator]]] = ()) -> None:
        """One iteration of a step made of len(segments) segments:
        segments[i]() (under the signature (*key, ("segment", i))), then
        the host call between[i]() on the caller's stream, outside any
        capture, for every i but the last.  generators[i]: the generators
        segment i draws from.  A failed capture raises, naming its
        segment, and leaves no graph of the step."""
        if len(between) != len(segments) - 1:
            raise ValueError(f"{len(segments)} segments need "
                             f"{len(segments) - 1} host calls, not "
                             f"{len(between)}")
        for i, fn in enumerate(segments):
            gens = generators[i] if i < len(generators) else ()
            if not self.capture:
                self.eager_steps += 1
                fn()
            else:
                sk = (*key, ("segment", i))
                capturing = sk in self._warm and sk not in self._graphs
                try:
                    self._segment(sk, fn, gens)
                except BaseException as e:
                    if not capturing:
                        raise
                    for j in range(i):
                        self._graphs.pop((*key, ("segment", j)), None)
                    raise RuntimeError(
                        f"segment {i} of the step {key[0]!r}: {e}") from e
            if i < len(between):
                self._host(between[i])

    def _segment(self, key: Hashable, fn: Callable, generators) -> None:
        """One iteration of the signature `key`: its eager warm-up, its
        capture and first replay, or a replay."""
        g = self._graphs.get(key)
        if g is None:
            with span("graphs.capture", id=key[0], graphs=self):
                if key not in self._warm:
                    self._warm.add(key)
                    self.eager_steps += 1
                    self._on_side(fn)
                    return
                g = self._graphs[key] = self._capture(key, fn, generators)
        self._replay(g)

    def _replay(self, g: _Graph) -> None:
        g.graph.replay()
        credit(g.launches)
        self.replays += 1

    def _host(self, fn: Callable) -> None:
        self.host_calls += 1
        fn()

    def stats(self) -> dict:
        """signatures warmed up, graphs (of them `segments`: graphs of a
        segmented step's segments), captures, replays, eager steps
        (warm-ups, and every step or segment a runner that does not
        capture runs), host calls between segments, capture seconds."""
        segments = sum(1 for k in self._graphs if _is_segment(k))
        return {"signatures": len(self._warm), "graphs": len(self._graphs),
                "segments": segments, "captures": self.captures,
                "replays": self.replays, "eager_steps": self.eager_steps,
                "host_calls": self.host_calls, "capture_s": self.capture_s}

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
        kernel launches it recorded."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(side), \
                count_captured(side) as launches:
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
