"""Launch counts of the port's hand-written kernels.

A kernel's wrapper calls `count(device, *names)` after each launch: one
more under every name it gives (the kernel's, and any by-kind names).  The
counts change under one lock: the pipelined engine launches from its
tracker's and its mapper's threads, and a backward runs on the autograd
engine's device thread.

A capture into a CUDA graph executes nothing, so a launch made while a
graph is captured on a stream that `count_captured` watches goes into that
capture's record instead, and each replay of the graph credits the record
once (`credit`: graphs.StepGraphs does).  A launch into a capture that no
`count_captured` watches raises: no replay would count it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

_lock = threading.Lock()
_counts: Dict[str, int] = {}
# stream handle -> launches recorded while a graph is captured there
_captures: Dict[int, Dict[str, int]] = {}


def _stream_state(device):
    """(handle of `device`'s current stream, whether it is capturing)."""
    with torch.cuda.device(device):
        return (torch.cuda.current_stream().cuda_stream,
                torch.cuda.is_current_stream_capturing())


def _add(into: Dict[str, int], names) -> None:
    for name in names:
        into[name] = into.get(name, 0) + 1


def count(device, *names: str) -> None:
    """One more launch under each of `names` on `device`'s current stream:
    into the record of the capture on that stream, if one is watched, else
    into the counts."""
    stream, capturing = _stream_state(device)
    with _lock:
        rec = _captures.get(stream)
        if rec is None and capturing:
            raise RuntimeError(
                f"a {names[0]} launch is being captured on a stream that "
                "no count_captured watches")
        _add(_counts if rec is None else rec, names)


@contextlib.contextmanager
def count_captured(stream):
    """Record the launches captured on `stream` in this block (the
    backward's too: the autograd engine runs a node on its forward's
    stream) instead of counting them; yields the record for `credit`."""
    rec: Dict[str, int] = {}
    with _lock:
        _captures[stream.cuda_stream] = rec
    try:
        yield rec
    finally:
        with _lock:
            del _captures[stream.cuda_stream]


def credit(rec: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    with _lock:
        for name, n in rec.items():
            _counts[name] = _counts.get(name, 0) + n


def counts(prefix: str = "") -> Dict[str, int]:
    """The counts whose names start with `prefix`."""
    with _lock:
        return {k: n for k, n in _counts.items() if k.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Set the counts whose names start with `prefix` to 0."""
    with _lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


@contextlib.contextmanager
def uncounted():
    """The counts as they were before this block, whatever it launches (a
    check's own launches)."""
    with _lock:
        saved = dict(_counts)
    try:
        yield
    finally:
        with _lock:
            _counts.clear()
            _counts.update(saved)
