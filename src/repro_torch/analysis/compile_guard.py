"""Runtime complement to the static pass: a CUDA-graph capture counter,
the port's twin of the JAX package's ``CompileCounter``.

``CaptureCounter`` is a context manager that listens to the port's capture
helper (``core/capture.py``), which reports one event per capture, naming
the function and its key, and counts them while the context is active.
The serving invariant it enforces is JAX's: a warm-up drain may capture
(``count > 0``), the steady state must not (``reset()``, then drive
identical-shape drains and assert ``count == 0``).  A capture inside the
tick loop costs a warm-up run and a capture, hundreds of times a replay.

Used by the card tests (``tests/test_torch_cuda.py``) and by
``chip_smoke.py``'s ``[graphs]`` phase.
"""
from __future__ import annotations

from typing import List


class CaptureCounter:
    """Count CUDA-graph captures while the context is active.

    >>> with CaptureCounter() as cc:
    ...     warm_up()          # captures: cc.count > 0
    ...     cc.reset()
    ...     steady_state()     # must not: cc.count == 0
    """

    def __init__(self):
        self.events: List[str] = []

    @property
    def count(self) -> int:
        return len(self.events)

    def reset(self):
        self.events = []

    def _on_capture(self, event: str) -> None:
        self.events.append(event)

    def __enter__(self) -> "CaptureCounter":
        from repro_torch.core import capture

        capture.add_listener(self._on_capture)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import capture

        capture.remove_listener(self._on_capture)
        return False
