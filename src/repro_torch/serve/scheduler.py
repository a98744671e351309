"""Admission scheduling + per-slot request lifecycle.

Lifecycle (one request):

    QUEUED   submitted, not yet assigned a slot
    PREFILL  owns a slot; prompt streaming in, `prefill_chunk` tokens/tick
    DECODE   prompt consumed; one generated token per tick
    DONE     hit eos / max_new_tokens; slot freed (and feedback recycled)

The scheduler only decides *which* queued request takes a freed slot;
state transitions and slot bookkeeping live in the engine. Two policies:

* `FIFOScheduler` — arrival order (stable; the fairness baseline).
* `LongestContextFirstScheduler` — longest prompt first, the policy that
  maximizes what GVR amortizes: long-context requests spend the most ticks
  decoding, so their slots hold valid temporal feedback longest ("Learn
  from the Past" / Vegas both admit by reuse potential).
"""

from __future__ import annotations

from typing import List, Optional

# Lifecycle phases (plain strings: cheap to log/assert against)
QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"


class Scheduler:
    """Base admission policy over a queue of not-yet-admitted requests."""

    def __init__(self):
        self._queue: List = []
        self.admitted = 0

    def submit(self, request) -> None:
        self._queue.append(request)

    def pending(self, now: Optional[int] = None) -> int:
        return len(self._ready(now))

    def _ready(self, now: Optional[int]):
        if now is None:
            return self._queue
        return [r for r in self._queue if r.arrival <= now]

    def peek(self, now: Optional[int] = None):
        """The request `pick` would admit next, without removing it. The
        paged engine plans pages against the peeked request and only `take`s
        it once the pages are secured — a failed plan leaves the queue (and
        its order) untouched."""
        ready = self._ready(now)
        return self._choose(ready) if ready else None

    def take(self, request) -> None:
        """Commit an admission planned via `peek`."""
        self._queue.remove(request)
        self.admitted += 1

    def requeue(self, request) -> None:
        """Return a preempted request to the FRONT of the queue: it already
        won admission once, so it outranks everything still waiting (FIFO
        fairness is preserved; priority policies re-rank as usual)."""
        self._queue.insert(0, request)

    def pick(self, now: Optional[int] = None):
        """Pop the next request to admit (or None). `now` gates on arrival
        time so traces with future arrivals don't admit early."""
        choice = self.peek(now)
        if choice is not None:
            self.take(choice)
        return choice

    def _choose(self, ready):
        raise NotImplementedError


class FIFOScheduler(Scheduler):
    def _choose(self, ready):
        return ready[0]


class LongestContextFirstScheduler(Scheduler):
    def _choose(self, ready):
        # stable on ties: max() keeps the earliest-submitted of equals
        return max(ready, key=lambda r: len(r.prompt))


_POLICIES = {
    "fifo": FIFOScheduler,
    "longest": LongestContextFirstScheduler,
    "longest-context-first": LongestContextFirstScheduler,
}


def make_scheduler(policy: str = "fifo") -> Scheduler:
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown scheduler policy {policy!r}; "
                         f"have {sorted(_POLICIES)}") from None
