"""Fixed-slot continuous-batching scheduler (the shared serving substrate).

One scheduler serves both engines in this package: the LM ``ServeEngine``
(slot recycling across decode depths) and the ``SurrogateServeEngine``
(ensemble rollout slots).  The model it implements is the production one:

  * a FIFO request queue, optionally with per-request **arrival times**
    (open-loop load: a request only becomes admissible once the serving
    clock passes its arrival -- latency is measured from arrival, queueing
    included);
  * a fixed table of ``num_slots`` batch slots.  The engine's jitted step
    always runs at full width; the scheduler tracks which slots hold a live
    request (an explicit flag -- never a sentinel token count) so freed
    slots are refilled MID-FLIGHT instead of waiting for the whole batch
    generation to drain (no lockstep ``steps = max(...)``).

The scheduler is deliberately engine-agnostic: it knows nothing about
caches, tokens, or rollouts -- engines attach that state per slot index.
"""
from __future__ import annotations

from collections import deque
from typing import Any, List, Optional, Tuple


class SlotScheduler:
    """Queue + fixed slot table with mid-flight refill."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"need at least one slot, got {num_slots}")
        self.num_slots = num_slots
        self._queue: deque = deque()         # (arrival, seq, request) FIFO
        self._slots: List[Optional[Any]] = [None] * num_slots
        self._seq = 0
        self.admitted = 0
        self.completed = 0

    # -- queue side ---------------------------------------------------------

    def submit(self, request: Any, arrival: float = 0.0) -> None:
        """Enqueue a request; ``arrival`` gates admission (open-loop load)."""
        self._queue.append((float(arrival), self._seq, request))
        self._seq += 1

    def submit_all(self, requests, arrivals=None) -> None:
        if arrivals is None:
            for r in requests:
                self.submit(r, getattr(r, "arrival", 0.0))
        else:
            for r, a in zip(requests, arrivals):
                self.submit(r, a)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def next_arrival(self) -> Optional[float]:
        """Earliest queued arrival time (None when the queue is empty)."""
        return min(a for a, _, _ in self._queue) if self._queue else None

    # -- slot side ----------------------------------------------------------

    @property
    def busy(self) -> int:
        return sum(s is not None for s in self._slots)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def is_active(self, slot: int) -> bool:
        return self._slots[slot] is not None

    def occupant(self, slot: int) -> Any:
        r = self._slots[slot]
        if r is None:
            raise ValueError(f"slot {slot} is not occupied")
        return r

    def active_items(self) -> List[Tuple[int, Any]]:
        return [(i, s) for i, s in enumerate(self._slots) if s is not None]

    def admit(self, now: float = float("inf")) -> List[Tuple[int, Any]]:
        """Fill free slots with ripe requests (arrival <= now), FIFO order.

        Returns the newly seated ``(slot, request)`` pairs; the engine
        prefills / initializes exactly these and leaves running slots
        untouched -- this is the continuous-batching refill.
        """
        seated: List[Tuple[int, Any]] = []
        free = self.free_slots()
        while free and self._queue:
            arrival, _, req = self._queue[0]
            if arrival > now:
                break
            self._queue.popleft()
            slot = free.pop(0)
            self._slots[slot] = req
            self.admitted += 1
            seated.append((slot, req))
        return seated

    def complete(self, slot: int) -> Any:
        """Retire the request in ``slot``; the slot becomes refillable."""
        req = self.occupant(slot)
        self._slots[slot] = None
        self.completed += 1
        return req

    @property
    def done(self) -> bool:
        return not self._queue and self.busy == 0
