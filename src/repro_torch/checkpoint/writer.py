"""Background checkpoint writer: snapshot-then-write off the hot path.

The Runtime takes a synchronous ``checkpoint.snapshot`` (host copies of
every leaf — the only part that must see a consistent learner state) and
hands it here; the single writer thread does the disk I/O, so the learner
never blocks on disk.

One thread, one FIFO queue: writes land in submission order, so a later
step can never become the "latest" checkpoint before an earlier one.
``flush()`` blocks until the queue drains and re-raises the first
background failure; ``close()`` additionally joins the thread — the
Runtime calls it on every exit path, so no writer thread outlives its
run.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from repro_torch.checkpoint import checkpoint as _ckpt


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed; raised at the next
    ``flush()``/``close()`` so the failure surfaces on the main thread."""


class AsyncCheckpointWriter:
    def __init__(self, print_fn: Callable[[str], None] = print):
        self._print_fn = print_fn
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[tuple] = None          # (path, exception)

    def submit(self, path: str, snap, metadata: Optional[dict] = None,
               ) -> None:
        """Queue one snapshot for persistence; returns immediately."""
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="ckpt-writer", daemon=True)
                self._thread.start()
        self._q.put((path, snap, metadata))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, snap, metadata = item
                try:
                    _ckpt.write_snapshot(path, snap, metadata)
                    self._print_fn(f"saved {path}")
                except Exception as exc:
                    with self._lock:
                        if self._error is None:
                            self._error = (path, exc)
                    self._print_fn(
                        f"checkpoint write failed for {path}: {exc!r}")
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            err = self._error
        if err is not None:
            path, exc = err
            raise CheckpointWriteError(
                f"background checkpoint write failed for {path}: "
                f"{exc!r}") from exc

    def flush(self) -> None:
        """Block until every submitted write has landed; re-raise the
        first background failure."""
        self._q.join()
        self._raise_pending()

    def close(self, raise_on_error: bool = True) -> None:
        """Drain the queue and join the writer thread. With
        ``raise_on_error=False`` (the Runtime's ``finally`` path) a
        pending failure is left to the log line it already printed
        instead of masking the in-flight exception."""
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:
            self._q.put(None)
            thread.join()
        if raise_on_error:
            self._raise_pending()
