"""Worker-thread template (host threading).

The port's copy of ``acmpc_tpu/runtime/worker.py``: a daemon worker with
a _setup/_runtime_setup/_work template, as a thread (PyTorch releases
the GIL while it launches work on the card and while its CPU operators
run, and threads share the built kernels and the loaded weights). Waits
on a mailbox instead of busy-spinning on staleness flags.
"""

from __future__ import annotations

import threading
from typing import Optional

from acmpc_tpu_torch.runtime.mailbox import Mailbox


class WorkerThread(threading.Thread):
    """Subclass and implement ``_work(item)``; optionally ``_setup`` (on
    the caller thread) and ``_runtime_setup`` (first thing on the worker
    thread, e.g. model loading so weights live where they are used)."""

    def __init__(self, inbox: Optional[Mailbox] = None, name: str = "acmpc-worker"):
        super().__init__(daemon=True, name=name)
        self.inbox = inbox or Mailbox()
        self._stop_event = threading.Event()
        self._version = 0
        self._setup()

    # -- template hooks --------------------------------------------------
    def _setup(self):
        pass

    def _runtime_setup(self):
        pass

    def _work(self, item):
        raise NotImplementedError

    # -- lifecycle -------------------------------------------------------
    @property
    def is_running(self) -> bool:
        return not self._stop_event.is_set()

    def submit(self, item):
        self.inbox.post(item)

    def stop(self, join: bool = True, timeout: float = 5.0):
        self._stop_event.set()
        self.inbox.post(None)
        if join and self.is_alive():
            self.join(timeout=timeout)

    def run(self):
        self._runtime_setup()
        while not self._stop_event.is_set():
            item, version, _ = self.inbox.read_fresh(self._version, timeout=0.5)
            if version == self._version or item is None:
                continue
            self._version = version
            try:
                self._work(item)
            except Exception:  # keep the loop alive
                import traceback

                traceback.print_exc()
