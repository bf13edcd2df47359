"""Staged-snapshot handles: capture now, materialize off the hot path.

The synchronous contract (``Application.checkpoint_state`` returning a
fully materialized pytree) forces the device→host copy *under the app's
state lock*, stalling the train loop for the whole transfer. The staged
contract splits a snapshot into two phases:

  1. **capture** (microseconds, under the lock): pin an immutable
     *reference* to the state. JAX arrays are immutable and the train
     loop swaps whole state dicts, so holding references IS a consistent
     snapshot — no copy needed.
  2. **resolve** (milliseconds→seconds, off the lock): materialize the
     pytree — ``jax.device_get`` for lossless images, or device-side
     int8 encode (``kernels.qsnap.qsnap_encode_chunks``) that leaves the
     accelerator at ~1/4 the bytes.

``SnapshotHandle.resolve()`` runs at most once and caches its result, so
the control plane (CheckpointManager / AppManager) can hand the same
handle to a blocking save, an async writer thread, or a retried save
without re-materializing — and a resolve error surfaces identically on
every path.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional


class SnapshotHandle:
    """A checkpoint snapshot captured but not necessarily materialized.

    ``resolve()`` returns the checkpoint pytree; it is thread-safe and
    idempotent (the materialization function runs exactly once, failures
    are cached and re-raised so every consumer sees the same outcome).
    """

    def __init__(self, fn: Callable[[], Any], *,
                 step: Optional[int] = None):
        self._fn: Optional[Callable[[], Any]] = fn
        self._lock = threading.Lock()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = False
        self.step = step

    def resolve(self) -> Any:
        with self._lock:
            if not self._done:
                try:
                    self._value = self._fn()
                except BaseException as e:         # noqa: BLE001
                    self._error = e
                finally:
                    self._fn = None               # drop captured refs
                    self._done = True
            if self._error is not None:
                raise self._error
            return self._value


class ReadySnapshot(SnapshotHandle):
    """A handle over an already-materialized pytree (legacy adapter)."""

    def __init__(self, state: Any, *, step: Optional[int] = None):
        super().__init__(lambda: state, step=step)


class DeferredSnapshot(SnapshotHandle):
    """A handle whose pytree is built lazily by ``fn`` (the common case:
    ``fn`` closes over device-array references captured under the app's
    state lock and does the D2H copy / device encode when called)."""


def resolve_state(obj: Any) -> Any:
    """Materialize ``obj`` if it is a handle; pass pytrees through."""
    if isinstance(obj, SnapshotHandle):
        return obj.resolve()
    return obj
