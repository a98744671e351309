"""Fault tolerance & elasticity runtime for 1000+-node operation, the JAX
package's `runtime/fault_tolerance.py` (plain Python, copied).

Three mechanisms, all host-level (device failures surface as Python
exceptions from the step call or as missing heartbeats in an external
orchestrator):

  1. `resilient_step` — retry-with-backoff + checkpoint-rollback wrapper
     around a train step. Transient faults (preemption glitches, flaky
     interconnect) retry in place; persistent faults raise `StepFailed`
     carrying the last good step for the orchestrator to restart from.

  2. `ElasticPlan` — recompute the (hosts → data-shard) layout after node
     loss. Because the data pipeline is a pure function of
     (step, host_id, num_hosts) and checkpoints are mesh-agnostic
     (checkpoint.py), a restart on H-1 hosts resumes the *identical* global
     batch stream — only per-host shard sizes change.

  3. `StragglerMonitor` — per-step duration EWMA with an outlier rule; on
     real clusters the flagged hosts get their data shards re-assigned via
     the deterministic ownership function below (work stealing without
     coordination: ownership is a pure function of (step, shard, alive-set)).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence


class StepFailed(RuntimeError):
    def __init__(self, step: int, last_good_step: int, cause: Exception):
        super().__init__(f"step {step} failed after retries: {cause!r}; "
                         f"restart from checkpoint step {last_good_step}")
        self.step = step
        self.last_good_step = last_good_step
        self.cause = cause


def resilient_step(step_fn: Callable, *, max_retries: int = 2,
                   backoff_s: float = 0.5,
                   on_retry: Optional[Callable[[int, Exception], None]] = None):
    """Wrap a step function with bounded retry + backoff."""

    def wrapped(step_idx: int, last_good_step: int, *args, **kwargs):
        delay = backoff_s
        for attempt in range(max_retries + 1):
            try:
                return step_fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — deliberate: retry any fault
                if attempt == max_retries:
                    raise StepFailed(step_idx, last_good_step, e) from e
                if on_retry:
                    on_retry(attempt, e)
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")

    return wrapped


@dataclasses.dataclass
class ElasticPlan:
    """Data-shard layout over the currently-alive hosts."""
    alive_hosts: List[int]
    global_batch: int

    def shard_for(self, host: int) -> tuple:
        """(host_id, num_hosts) arguments for data.pipeline.batch_for_step."""
        if host not in self.alive_hosts:
            raise ValueError(f"host {host} is not alive")
        rank = self.alive_hosts.index(host)
        return rank, len(self.alive_hosts)

    def rebalanced(self, lost: Sequence[int]) -> "ElasticPlan":
        alive = [h for h in self.alive_hosts if h not in set(lost)]
        if not alive:
            raise RuntimeError("no hosts left")
        if self.global_batch % len(alive) != 0:
            # shrink to the largest divisor of global_batch <= len(alive):
            # deterministic, so every surviving host computes the same plan
            n = len(alive)
            while self.global_batch % n != 0:
                n -= 1
            alive = alive[:n]
        return ElasticPlan(alive, self.global_batch)


def shard_owner(step: int, shard: int, alive_hosts: Sequence[int]) -> int:
    """Deterministic work-stealing ownership: pure function of
    (step, shard, alive-set) — no coordination needed to agree on who picks
    up a straggler's shard."""
    return alive_hosts[(shard * 1_000_003 + step) % len(alive_hosts)]


class StragglerMonitor:
    """EWMA step-duration outlier detection."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.count = 0
        self.flagged: List[int] = []

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.count += 1
        if self.ewma is None:
            self.ewma = duration_s
            return False
        is_outlier = (self.count > self.warmup
                      and duration_s > self.threshold * self.ewma)
        if is_outlier:
            self.flagged.append(step)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration_s
        return is_outlier
