"""Port copy of ``trino_tpu/server/retrypolicy.py`` (no edits).

Shared retry policy: exponential backoff with decorrelated jitter.

Reference: the reference engine spreads its retry ceremony across
HttpRemoteTask's error trackers, the FTE scheduler's task-retry delays
(EventDrivenFaultTolerantQueryScheduler's retry backoff) and the client's
advance() loop. This runtime previously retried immediately at every one
of those sites, which under a flapping coordinator or a saturated worker
turns recovery into a synchronized retry storm. One policy object now
serves all of them: client nextUri polling, worker announce, the
scheduler's task-retry rounds, and the dispatcher's QUERY-retry loop.

The jitter is the decorrelated variant: each delay is drawn uniformly
from [base, prev * 3] and capped at max_delay, so expected growth stays
exponential while concurrent retriers decorrelate instead of herding.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + attempt/deadline budget.

    `max_attempts` counts total tries (first try included); `deadline_s`
    bounds the cumulative time `call()` may spend including the sleep it
    is about to take — whichever budget exhausts first stops retrying.
    A `seed` makes the jitter deterministic (chaos soak reproducibility).
    """

    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    max_attempts: int = 5
    deadline_s: float = float("inf")
    seed: Optional[int] = None
    # metrics label: which control-plane loop is retrying (announce,
    # dispatch, drain, ...) — rendered on /v1/metrics as
    # trino_tpu_retry_attempts_total{component=...}
    name: str = "retry"

    def delays(self) -> Iterator[float]:
        """Sleep durations between attempts (max_attempts - 1 entries)."""
        rng = random.Random(self.seed)
        prev = self.base_delay_s
        for _ in range(max(0, self.max_attempts - 1)):
            prev = min(self.max_delay_s,
                       rng.uniform(self.base_delay_s, max(self.base_delay_s,
                                                          prev * 3)))
            yield prev

    def call(self, fn: Callable, retry_on: Tuple = (OSError,),
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Optional[Callable] = None):
        """Run `fn`, retrying on `retry_on` per the schedule.

        The final attempt's exception propagates unchanged so callers
        keep their existing error handling; `on_retry(attempt, delay, e)`
        is an observability hook (never raises into the retry loop).
        """
        t0 = time.monotonic()
        schedule = list(self.delays())
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on as e:
                last_try = attempt >= self.max_attempts - 1
                delay = schedule[attempt] if not last_try else 0.0
                if last_try or \
                        time.monotonic() - t0 + delay > self.deadline_s:
                    raise
                from ..metrics import RETRY_ATTEMPTS
                RETRY_ATTEMPTS.inc(component=self.name)
                if on_retry is not None:
                    try:
                        on_retry(attempt, delay, e)
                    except Exception:   # noqa: BLE001 — hook must not mask
                        pass
                sleep(delay)
        raise AssertionError("unreachable")   # pragma: no cover
