"""Fault tolerance for serving: retry with backoff, a per-step watchdog, and
the profiling degradation ladder (port of the serving part of
:mod:`repro.distributed.fault`; ``FaultTolerantLoop``, checkpoints and
preemption come with the train slice).  Pure Python, no tensors.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, List


@dataclasses.dataclass
class StragglerReport:
    host: int
    latency: float
    median: float

    @property
    def slowdown(self) -> float:
        return self.latency / max(self.median, 1e-9)


class Heartbeats:
    """Rolling per-host step-latency monitor with straggler flagging."""

    def __init__(self, n_hosts: int, window: int = 16,
                 straggler_factor: float = 2.0):
        self.n_hosts = n_hosts
        self.window = window
        self.factor = straggler_factor
        self._lat: List[collections.deque] = [
            collections.deque(maxlen=window) for _ in range(n_hosts)]

    def record(self, host: int, latency_s: float):
        self._lat[host].append(latency_s)

    def medians(self) -> List[float]:
        return [statistics.median(d) if d else 0.0 for d in self._lat]

    def stragglers(self) -> List[StragglerReport]:
        latest = [d[-1] if d else 0.0 for d in self._lat]
        flat = [x for d in self._lat for x in d]
        if not flat:
            return []
        med = statistics.median(flat)
        return [
            StragglerReport(host=h, latency=l, median=med)
            for h, l in enumerate(latest)
            if med > 0 and l > self.factor * med
        ]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    retries: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    backoff: float = 2.0


def retry_with_backoff(fn: Callable, *args, policy: RetryPolicy = RetryPolicy(),
                       retryable=(RuntimeError, OSError), on_retry=None,
                       sleep=time.sleep, **kwargs):
    """Call ``fn``; on a retryable exception, back off exponentially and
    retry up to ``policy.retries`` times, then re-raise the last error."""
    delay = policy.base_delay
    for attempt in range(policy.retries + 1):
        try:
            return fn(*args, **kwargs)
        except retryable as e:
            if attempt == policy.retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
            delay = min(delay * policy.backoff, policy.max_delay)


class Watchdog:
    """Per-step wall-clock budget monitor.

    ``observe`` returns True when the step breached its budget;
    ``breaches`` counts consecutive breaches (reset by a healthy step) —
    the supervisor's overhead trigger.
    """

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.breaches = 0
        self.total_breaches = 0

    def observe(self, latency_s: float) -> bool:
        if latency_s > self.budget_s:
            self.breaches += 1
            self.total_breaches += 1
            return True
        self.breaches = 0
        return False


PROFILING_LADDER = ("inline", "shortcut", "off")


@dataclasses.dataclass
class DegradationEvent:
    step: int
    from_policy: str
    to_policy: str
    reason: str


class ProfilingSupervisor:
    """Graceful degradation of the profiling path: inline → shortcut → off.

    The data path always keeps serving; only the *profiling* fidelity is
    traded away.  Each rung down is taken after ``failure_threshold``
    consecutive integrity failures or overhead-budget breaches; healthy
    steps reset the streak.  The ladder never climbs back up on its own —
    re-arming is an operator decision (``reset``).
    """

    def __init__(self, policy: str = "inline", *, failure_threshold: int = 2,
                 overhead_budget: float = 0.25):
        if policy not in PROFILING_LADDER:
            raise ValueError(f"policy must be one of {PROFILING_LADDER}")
        self.policy = policy
        self.failure_threshold = failure_threshold
        self.overhead_budget = overhead_budget
        self.events: List[DegradationEvent] = []
        self._streak = 0
        self._hb_streak = 0
        self._step = 0

    @property
    def active(self) -> bool:
        return self.policy != "off"

    def step_ok(self) -> str:
        """A healthy profiled step: resets the failure streak."""
        self._step += 1
        self._streak = 0
        return self.policy

    def record_integrity_failure(self, detail: str = "") -> str:
        return self._strike(f"profile-integrity failure {detail}".strip())

    def record_overhead(self, overhead_frac: float) -> str:
        """Report profiling overhead as a fraction of the step budget."""
        self._step += 1
        if overhead_frac <= self.overhead_budget:
            self._streak = 0
            return self.policy
        return self._strike(
            f"profiling overhead {overhead_frac:.2f} > "
            f"budget {self.overhead_budget:.2f}", counted=True)

    def observe_heartbeats(self, heartbeats: Heartbeats) -> str:
        """Fold straggler reports into the degradation ladder, on their own
        streak (healthy heartbeats clear it, healthy ingests do not)."""
        reports = heartbeats.stragglers()
        if not reports:
            self._hb_streak = 0
            return self.policy
        self._hb_streak += 1
        if self._hb_streak >= self.failure_threshold and self.active:
            worst = max(reports, key=lambda r: r.slowdown)
            self._step_down(
                f"straggler host {worst.host}: latency {worst.latency:.3f}s "
                f"= {worst.slowdown:.1f}x median")
            self._hb_streak = 0
        return self.policy

    def _strike(self, reason: str, counted: bool = False) -> str:
        if not counted:
            self._step += 1
        self._streak += 1
        if self._streak >= self.failure_threshold and self.active:
            self._step_down(reason)
            self._streak = 0
        return self.policy

    def _step_down(self, reason: str) -> None:
        i = PROFILING_LADDER.index(self.policy)
        nxt = PROFILING_LADDER[min(i + 1, len(PROFILING_LADDER) - 1)]
        self.events.append(DegradationEvent(
            step=self._step, from_policy=self.policy, to_policy=nxt,
            reason=reason))
        self.policy = nxt

    def reset(self, policy: str = "inline") -> None:
        self.policy = policy
        self._streak = 0
        self._hb_streak = 0

    def summary(self) -> str:
        if not self.events:
            return f"profiling policy: {self.policy} (no degradations)"
        path = " -> ".join([self.events[0].from_policy]
                           + [e.to_policy for e in self.events])
        return (f"profiling policy: {path}; "
                + "; ".join(f"step {e.step}: {e.reason}" for e in self.events))
