"""Preemption-safe training: checkpoint-on-SIGTERM for preemptible VMs.

Spot/preemptible cloud VMs (and on-demand hosts during maintenance events) get
a SIGTERM with a short grace window before the host is reclaimed. The
reference has nothing here — its fault tolerance is HF Trainer's periodic
checkpoint resume only (SURVEY.md §5; reference llava/train/train.py:1177-1181
relies on `trainer.train(resume_from_checkpoint=...)`), so a preemption loses
everything since the last `save_steps` boundary.

Here a :class:`PreemptionGuard` installs a SIGTERM handler that only flips a
flag (async-signal-safe; no I/O in the handler). The trainer polls the flag
between steps — the one point where the train state is consistent — writes a
final ``state-<step>`` checkpoint through the normal Orbax path, and returns,
so the next boot's ``latest_checkpoint()`` discovery resumes bit-exactly.

Multi-host note: every process installs its own guard; the flag is only acted
on between steps, and the save itself goes through Orbax's multi-host
serialization, so all hosts fall out of the step loop at the same step as long
as the platform signals them within the same step interval (GCE preemption
signals all workers of a slice together).
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Context manager: latch termination signals into a pollable flag.

    Only the main thread may install signal handlers (CPython restriction);
    :meth:`install_ok` reports whether that is the case so callers can degrade
    to unguarded operation (e.g. a trainer driven from a server thread).
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signals = tuple(signals)
        self._prev = {}

    @staticmethod
    def install_ok() -> bool:
        return threading.current_thread() is threading.main_thread()

    def __enter__(self) -> "PreemptionGuard":
        if self.install_ok():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def _on_signal(self, signum, frame) -> None:  # handler: flag only
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:
        """Mark as preempted programmatically (tests; cooperative shutdown)."""
        self._flag.set()
