"""Background commits of the batched sweep (``SweepConfig.async_commit``).

Every shard and checkpoint commit of ``core.sweep`` is host I/O on numpy
arrays, and with the fsync'd atomic renames of ``checkpoint.store`` it lies
on the sweep's critical path.  ``ChunkCommitter`` runs those commits on ONE
background thread, so chunk N+1 runs on the card while chunk N's npz write
and fsync run on the host, and keeps every guarantee of the synchronous
path:

  * **Order.**  One worker drains a FIFO queue, so commits land in the
    order they were submitted: a later chunk of a pod never becomes visible
    before an earlier one (the resume rule, ``results.pod_prefix_spans``).
  * **A bounded queue.**  ``submit`` blocks once ``max_pending`` commits
    wait, so host memory holds a few chunks of rows at most.
  * **No lost errors.**  The first worker exception re-raises on the
    calling thread at the next ``submit``/``drain``/``close`` and poisons
    the queue: commits queued after a failed one are dropped, never run,
    so a failed span is never followed on disk by a committed successor.
  * **Drain on every exit.**  ``close`` (and the context manager, on a
    normal exit and on ``KeyboardInterrupt`` or any exception) waits for
    the queued commits before returning.

The worker receives host numpy arrays only and makes no CUDA call.  The
bytes it commits are the synchronous path's, so ``async_commit`` stays out
of the grid fingerprint.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable

__all__ = ["ChunkCommitter"]

_STOP = object()


class ChunkCommitter:
    """Bounded single-worker executor of ordered commit callables.

    Args:
      max_pending: commits that may wait in the queue before ``submit``
        blocks; the worker may hold one more in execution.
    """

    def __init__(self, max_pending: int = 2):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._error: BaseException | None = None
        self._closed = False
        self.committed = 0   # commits that ran to completion
        self.dropped = 0     # commits skipped after a poisoning failure
        self._thread = threading.Thread(target=self._worker,
                                        name="sweep-committer", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                self._q.task_done()
                return
            fn, args, kwargs = item
            if self._error is None:
                try:
                    fn(*args, **kwargs)
                    self.committed += 1
                except BaseException as e:  # noqa: BLE001 (re-raised later)
                    self._error = e
            else:
                # poisoned: a failed span must not be followed by a
                # committed successor
                self.dropped += 1
            self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            raise self._error

    def submit(self, fn: Callable[..., Any], *args, **kwargs) -> None:
        """Queue one commit; blocks while ``max_pending`` wait.  Re-raises
        the first worker exception before queueing, where the synchronous
        path would have raised."""
        if self._closed:
            raise RuntimeError("submit on a closed ChunkCommitter")
        self._raise_pending()
        self._q.put((fn, args, kwargs))

    def drain(self, raise_errors: bool = True) -> None:
        """Wait until every queued commit ran (or was dropped); then
        re-raise the first worker exception unless ``raise_errors=False``
        (while another exception unwinds, so as not to mask it)."""
        self._q.join()
        if raise_errors:
            self._raise_pending()

    def close(self, raise_errors: bool = True) -> None:
        """Drain, stop the worker and join it.  Idempotent."""
        if not self._closed:
            self._closed = True
            self._q.join()
            self._q.put(_STOP)
            self._thread.join()
        if raise_errors:
            self._raise_pending()

    def __enter__(self) -> "ChunkCommitter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # drain on an exception too (KeyboardInterrupt included), without
        # letting a worker error mask the exception in flight
        self.close(raise_errors=exc_type is None)
