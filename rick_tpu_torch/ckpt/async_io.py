"""Checkpoints written off the training thread.  Port of
`rick_tpu/ckpt/async_io.py`.

The phases update params and optimizer state in place (`train/steps.py`),
so a save takes a snapshot first: `Snapshot` copies every tensor of a tree
(e.g. `ckpt.state_dicts(state)`) to the host, into pinned buffers by copies
queued on the card's stream behind the work that produced them, and
records an event.  The next phase's updates are queued behind the copies,
so they cannot reach the snapshot; the writer thread waits for the event
before it reads, and never sees the live modules.  On the CPU the snapshot
is a plain copy.

`AsyncSaver` runs the writers on one thread: `submit` in order, each one
run (periodic checkpoints), at most `max_pending` unfinished at once;
`submit_latest(key)` replaces a job of the same key that has not started
(best.pt: only the newest best matters).  A writer's error is printed when
it happens and raised by `wait` / `close`.  Writers write through
`atomic_write` (tmp + rename), so a kill mid-save leaves no truncated file.

A checkpoint is durable once its writer finished: a crash before that
loses the work back to the previous one.  Call `wait()` where durability
matters more than throughput.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import traceback
from typing import Any, Callable, Dict, List

import torch


class Snapshot:
    """A host copy of a tree (nested dicts and lists) of tensors, started at
    construction; `get()` returns it once complete."""

    def __init__(self, tree):
        self._devices = set()
        self._tree = self._copy(tree)
        self._events = []
        for dev in self._devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self._events.append(ev)

    def _copy(self, tree):
        if isinstance(tree, dict):
            return {k: self._copy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._copy(v) for v in tree]
        if not isinstance(tree, torch.Tensor):
            return tree
        t = tree.detach()
        if t.device.type != "cuda":
            return t.to("cpu", copy=True)
        self._devices.add(t.device)
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    def get(self):
        for ev in self._events:
            ev.synchronize()
        return self._tree


class AsyncSaver:
    """One writer thread; see the module docstring."""

    def __init__(self, max_pending: int = 2):
        self._pool = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="AsyncSaver")
        self._max_pending = max_pending
        self._fifo: List[cf.Future] = []
        self._latest: Dict[str, cf.Future] = {}
        self._jobs: List[cf.Future] = []

    @staticmethod
    def _run(fn: Callable[[Any], None], snap: Snapshot) -> None:
        fn(snap.get())

    @staticmethod
    def _report(fut: cf.Future) -> None:
        # at once: wait() may not run before the end of training, and a full
        # disk must not go unnoticed for hours
        if not fut.cancelled() and fut.exception() is not None:
            print(f"[AsyncSaver] checkpoint write FAILED: {fut.exception()!r}", flush=True)
            traceback.print_exception(fut.exception())

    def _start(self, fn, snap: Snapshot) -> cf.Future:
        fut = self._pool.submit(self._run, fn, snap)
        fut.add_done_callback(self._report)
        self._jobs.append(fut)
        return fut

    def submit(self, fn: Callable[[Any], None], snap: Snapshot) -> None:
        """Queue `fn(snap.get())`; blocks while `max_pending` such jobs are
        unfinished."""
        self._fifo = [f for f in self._fifo if not f.done()]
        if len(self._fifo) >= self._max_pending:
            cf.wait(self._fifo[: len(self._fifo) - self._max_pending + 1])
        self._fifo.append(self._start(fn, snap))

    def submit_latest(self, key: str, fn: Callable[[Any], None], snap: Snapshot) -> None:
        """Queue `fn(snap.get())` in place of a not yet started job of `key`."""
        old = self._latest.get(key)
        if old is not None:
            old.cancel()  # no-op once it runs; a cancelled job's snapshot is freed
        self._latest[key] = self._start(fn, snap)

    def wait(self) -> None:
        """Block until every queued job finished; raise the first error."""
        jobs, self._jobs = self._jobs, []
        cf.wait(jobs)
        errors = [f.exception() for f in jobs if not f.cancelled() and f.exception() is not None]
        if errors:
            raise errors[0]

    def close(self) -> None:
        """Finish every job, stop the thread, then raise the first error."""
        self._pool.shutdown(wait=True)
        self.wait()


class atomic_write:
    """`with atomic_write(path) as tmp: write(tmp)` -> os.replace(tmp, path)."""

    def __init__(self, path: str):
        self.path = path
        self.tmp = path + ".tmp"

    def __enter__(self) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        return self.tmp

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            os.replace(self.tmp, self.path)
        elif os.path.exists(self.tmp):
            os.remove(self.tmp)
        return False
