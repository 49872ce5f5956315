"""Latest-wins mailboxes (host threading).

The port's copy of ``acmpc_tpu/runtime/mailbox.py``: the runtime's
threads hand data to each other through a single-writer latest-wins
mailbox: one lock, a monotonically increasing version, and an event for
consumers that want to block instead of spin.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional, Tuple


class Mailbox:
    """Single-slot, latest-wins, versioned."""

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._value: Any = None
        self._version = 0
        self._timestamp = 0.0

    def post(self, value: Any):
        with self._lock:
            self._value = value
            self._version += 1
            self._timestamp = time.monotonic()
        self._event.set()

    def read(self) -> Tuple[Any, int, float]:
        """(value, version, timestamp) — value may be None before the
        first post."""
        with self._lock:
            return self._value, self._version, self._timestamp

    def read_fresh(
        self, last_version: int, timeout: Optional[float] = None
    ) -> Tuple[Any, int, float]:
        """Block until a version newer than ``last_version`` is posted (or
        timeout); returns the current (value, version, timestamp)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._version > last_version:
                    return self._value, self._version, self._timestamp
                self._event.clear()
            remaining = (
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
            if remaining == 0.0:
                with self._lock:
                    return self._value, self._version, self._timestamp
            self._event.wait(remaining)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def is_stale(self, max_age_s: float) -> bool:
        with self._lock:
            if self._version == 0:
                return True
            return (time.monotonic() - self._timestamp) > max_age_s
