"""Transient-failure detection and retry for the PyTorch port (the
counterpart of nice_slam_tpu/utils/retry.py, with the same names and
structure).  `run_torch.py` retries a single-process run with it and
resumes each retry from the newest checkpoint.

What counts as transient here, matched against "TypeName: message":
- rendezvous and transport failures of torch.distributed: the classes
  `DistStoreError` and `DistNetworkError` (by name, so the module needs no
  process group to load), and the messages "Connection reset", "Broken
  pipe", "failed to connect", "Connection refused", "Socket closed" /
  "socket closed", "connection closed", "Connection closed by peer".

What never is:
- the sticky CUDA errors ("illegal memory access", "unspecified launch
  failure", "device-side assert triggered", "misaligned address"): the
  context is lost, so the same process fails again;
- `torch.cuda.OutOfMemoryError`: the same run asks for the same memory;
- the deterministic classes of the JAX module without `jax.errors`:
  TypeError, ValueError, KeyError, IndexError, AttributeError,
  AssertionError, NotImplementedError.
The deterministic checks win over the markers.

In a multi-rank launch a rank does not retry alone: it would rejoin a
group whose other ranks are in another step, or wait in a rendezvous
that nobody else enters.  There the failure ends the launch, and
`run_torch.py --resume <output>` restarts every rank from the newest
checkpoint.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

# exception class names of torch.distributed's rendezvous and transport
# layer (torch.distributed.DistStoreError / DistNetworkError)
_TRANSIENT_CLASSES = ("DistStoreError", "DistNetworkError")

# substrings of a transport failure, matched against "TypeName: message"
_TRANSIENT_MARKERS = (
    "Connection reset",
    "connection reset",
    "Broken pipe",
    "failed to connect",
    "Connection refused",
    "Socket closed",
    "socket closed",
    "connection closed",
    "Connection closed by peer",
)

# a CUDA context that raised one of these is lost: the same process fails
# again, whatever the retry does
_STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert triggered",
    "misaligned address",
)


def _deterministic_classes():
    """Exception classes that are always program bugs, never transient
    (matched by isinstance, so subclasses are covered), with the out-of-
    memory error of the CUDA allocator."""
    classes = [TypeError, ValueError, KeyError, IndexError, AttributeError,
               AssertionError, NotImplementedError]
    import torch

    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom is not None:
        classes.append(oom)
    return tuple(classes)


def is_transient(exc: BaseException) -> bool:
    """True if `exc` looks like a transient rendezvous or transport failure
    worth a retry (vs a deterministic program error or a lost CUDA
    context, which would fail again)."""
    if isinstance(exc, _deterministic_classes()):
        return False
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _STICKY_CUDA_MARKERS):
        return False
    names = {c.__name__ for c in type(exc).__mro__}
    if names & set(_TRANSIENT_CLASSES):
        return True
    return any(m in text for m in _TRANSIENT_MARKERS)


def retry_transient(fn: Callable[[], T], attempts: int = 3,
                    sleep_s: float = 5.0,
                    cleanup: Optional[Callable[[], None]] = None,
                    label: str = "operation",
                    stats: Optional[dict] = None) -> T:
    """Run `fn()`; on a transient failure, run `cleanup()` (if given),
    sleep, and retry up to `attempts` tries in all.  Non-transient errors
    and the last failure propagate.  `fn` must be safe to run again from
    scratch.

    If `stats` is given, it is filled with {"attempts": tries used,
    "transient_errors": [str, ...]}."""
    errors: list = []
    if stats is not None:
        stats["attempts"] = 0
        stats["transient_errors"] = errors
    for attempt in range(1, attempts + 1):
        if stats is not None:
            stats["attempts"] = attempt
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 - classified below
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            if attempt >= attempts or not is_transient(e):
                raise
            errors.append(f"{type(e).__name__}: {e}"[:300])
            print(f"[retry] transient failure in {label} "
                  f"(attempt {attempt}/{attempts}): "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
            if cleanup is not None:
                try:
                    cleanup()
                except Exception:
                    pass
            time.sleep(sleep_s * attempt)
    raise AssertionError("unreachable: the last attempt raises")
