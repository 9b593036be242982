"""Port copy of ``trino_tpu/server/failureinjector.py`` (no edits).

Fault injection for failure-recovery testing — the chaos layer.

Reference: FailureInjector is part of the engine proper
(execution/FailureInjector.java:35,51 — injected failure types fired at
task-management and results-fetch boundaries), driven by
BaseFailureRecoveryTest (testing/trino-testing/.../BaseFailureRecoveryTest.java:85)
to kill work mid-query and assert identical results under retry.

Round 7 grows the two coordinator-side points (DISPATCH/EXECUTION) into a
seeded, pluggable chaos schedule covering the whole distributed control
plane — worker task create/run, the coordinator's exchange drain, spool
read/write, heartbeat pings — with fault *types* beyond a clean raise:

    RAISE    clean exception at the point (the original behavior)
    CRASH    worker-crash analog: kills the task executor mid-split
    DELAY    fixed/random sleep — a straggling node
    DROP     connection drop (raises a ConnectionResetError subclass so
             it takes the same path as a real peer reset)
    CORRUPT  payload corruption: bit-flip a spooled/served page frame
             (detected downstream by the pageserde CRC32C checksum)

`FailureInjector.from_seed` generates a randomized schedule from a seed so
a chaos soak (tests/test_chaos.py, `bench.py --chaos`) is reproducible:
same seed, same faults, same query matrix, bit-identical results required.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Injection points in the query lifecycle (the reference's
# InjectedFailureType values, mapped to this runtime's boundaries).
DISPATCH = "DISPATCH"                  # before planning (task management)
EXECUTION = "EXECUTION"                # during stage execution
STAGE_BOUNDARY = "STAGE_BOUNDARY"      # between build/source/final stages
WORKER_TASK_CREATE = "WORKER_TASK_CREATE"  # worker POST /v1/task intake
WORKER_TASK_RUN = "WORKER_TASK_RUN"    # worker executor, per split
EXCHANGE_DRAIN = "EXCHANGE_DRAIN"      # coordinator pulling result pages
SPOOL_READ = "SPOOL_READ"              # durable exchange get()
SPOOL_WRITE = "SPOOL_WRITE"            # durable exchange put()
HEARTBEAT_PING = "HEARTBEAT_PING"      # failure detector /v1/status probe
SCAN_PREFETCH = "SCAN_PREFETCH"        # chunked-driver prefetch worker,
                                       # per staged chunk (exec/chunked.py)
WRITE_STAGE = "WRITE_STAGE"            # write task staging an attempt file
WRITE_COMMIT = "WRITE_COMMIT"          # coordinator journaling the commit
WRITE_PUBLISH = "WRITE_PUBLISH"        # per-file atomic rename publish

POINTS = (DISPATCH, EXECUTION, STAGE_BOUNDARY, WORKER_TASK_CREATE,
          WORKER_TASK_RUN, EXCHANGE_DRAIN, SPOOL_READ, SPOOL_WRITE,
          HEARTBEAT_PING, SCAN_PREFETCH, WRITE_STAGE, WRITE_COMMIT,
          WRITE_PUBLISH)

# The write-protocol boundaries, for `bench.py --write-chaos` and targeted
# soaks (kept out of the from_seed default so the round-7 chaos series
# keeps its historical schedule).
WRITE_POINTS = (WRITE_STAGE, WRITE_COMMIT, WRITE_PUBLISH)

# Fault types.
RAISE = "RAISE"
CRASH = "CRASH"
DELAY = "DELAY"
DROP = "DROP"
CORRUPT = "CORRUPT"
# Infinite-delay straggler: the site blocks until the injector's hangs
# are released (clear() / release_hangs()) or the rule's delay_s safety
# bound passes. Kept OUT of the from_seed default rotation — adding it
# would rewrite every historical seeded chaos schedule — so only the
# deadline/overload soaks (`bench.py --overload`) and targeted tests
# schedule it explicitly.
HANG = "HANG"

FAULTS = (RAISE, CRASH, DELAY, DROP, CORRUPT)


class InjectedFailure(Exception):
    pass


class InjectedCrash(InjectedFailure):
    """Worker-crash analog: the task executor dies mid-split."""


class InjectedDrop(InjectedFailure, ConnectionResetError):
    """Connection drop: an OSError so it rides the same retry path as a
    real peer reset (the scheduler/client catch (URLError, OSError))."""


@dataclass
class ChaosRule:
    point: str
    fault: str = RAISE
    remaining: int = 1             # fire this many times, then let through
    match: Optional[str] = None    # substring filter on the site key
    delay_s: float = 0.05          # DELAY faults sleep this long


class FailureInjector:
    """Fires scheduled faults at chaos points a fixed number of times.

    One injector instance may be shared by every component of a cluster
    (dispatcher, scheduler, spool, workers' task managers, detector) —
    the `point` argument disambiguates the site. Thread-safe.
    """

    def __init__(self, seed: Optional[int] = None):
        self._rules: List[ChaosRule] = []
        self._lock = threading.Lock()
        self.injected_count = 0
        self.injected_by_fault: Dict[str, int] = {f: 0 for f in FAULTS}
        # (wall time, point, fault, key) — bench.py --chaos correlates
        # these with recovery latencies
        self.events: List[tuple] = []
        self._rng = random.Random(seed)
        # HANG faults block on this event; release_hangs()/clear() set
        # it so soak teardown can unstick every hung thread at once
        self._hang_release = threading.Event()

    # -- scheduling --------------------------------------------------------

    def inject(self, point: str, times: int = 1,
               match_sql: Optional[str] = None, fault: str = RAISE,
               delay_s: float = 0.05) -> None:
        """Backward-compatible entry: schedule `times` faults at `point`
        (optionally filtered by a substring of the site key/SQL)."""
        self.add_rule(ChaosRule(point, fault, times, match_sql, delay_s))

    def add_rule(self, rule: ChaosRule) -> None:
        with self._lock:
            self._rules.append(rule)

    @classmethod
    def from_seed(cls, seed: int, n_faults: Optional[int] = None,
                  points=None, faults=None,
                  max_delay_s: float = 0.5) -> "FailureInjector":
        """Seeded randomized chaos schedule: `n_faults` rules drawn over
        `points` x `faults` (defaults: every distributed-runtime point,
        every fault type). Deterministic per seed."""
        inj = cls(seed=seed)
        rng = random.Random(seed)
        if points is None:
            points = (STAGE_BOUNDARY, WORKER_TASK_CREATE, WORKER_TASK_RUN,
                      EXCHANGE_DRAIN, SPOOL_READ, SPOOL_WRITE,
                      HEARTBEAT_PING)
        if faults is None:
            faults = FAULTS
        if n_faults is None:
            n_faults = rng.randint(1, 3)
        for _ in range(n_faults):
            point = rng.choice(points)
            fault = rng.choice(faults)
            if fault == CORRUPT:
                # corruption only applies where a page payload exists
                point = rng.choice((SPOOL_WRITE, EXCHANGE_DRAIN))
            if point == HEARTBEAT_PING and fault == CRASH:
                fault = RAISE          # no task executor at a ping
            if point in (SPOOL_READ, SPOOL_WRITE) and fault == CRASH:
                fault = RAISE
            inj.add_rule(ChaosRule(point, fault,
                                   remaining=rng.randint(1, 2),
                                   delay_s=rng.uniform(0.05, max_delay_s)))
        return inj

    def schedule(self) -> List[ChaosRule]:
        with self._lock:
            return [ChaosRule(r.point, r.fault, r.remaining, r.match,
                              r.delay_s) for r in self._rules]

    # -- firing ------------------------------------------------------------

    def _take(self, point: str, key: str,
              payload_site: bool) -> Optional[ChaosRule]:
        """Consume one matching rule, or None. CORRUPT rules only match
        at payload sites (corrupt_page); everything else at maybe_fail."""
        with self._lock:
            for rule in self._rules:
                if rule.point != point or rule.remaining <= 0:
                    continue
                if (rule.fault == CORRUPT) != payload_site:
                    continue
                if rule.match is not None and rule.match not in key:
                    continue
                rule.remaining -= 1
                self.injected_count += 1
                self.injected_by_fault[rule.fault] = \
                    self.injected_by_fault.get(rule.fault, 0) + 1
                self.events.append((time.time(), point, rule.fault, key))
                return rule
        return None

    def maybe_fail(self, point: str, sql: str = "") -> None:
        """Fire a non-payload fault scheduled at `point`, if any: RAISE /
        CRASH / DROP raise, DELAY sleeps then returns. `sql` doubles as
        the site key (query text, task id, node id — whatever identifies
        the work at that point)."""
        rule = self._take(point, sql, payload_site=False)
        if rule is None:
            return
        if rule.fault == DELAY:
            time.sleep(rule.delay_s)
            return
        if rule.fault == HANG:
            # infinite-delay straggler: block until released (or the
            # rule's delay_s safety bound — schedule HANG rules with a
            # large delay_s; the default 0.05 makes a mere hiccup)
            self._hang_release.wait(rule.delay_s)
            return
        if rule.fault == CRASH:
            raise InjectedCrash(
                f"injected {point} crash ({rule.remaining} left)")
        if rule.fault == DROP:
            raise InjectedDrop(
                f"injected {point} connection drop "
                f"({rule.remaining} left)")
        raise InjectedFailure(
            f"injected {point} failure ({rule.remaining} left)")

    def corrupt_page(self, point: str, key: str, page: bytes) -> bytes:
        """Apply a scheduled CORRUPT fault to a page frame: flip one
        seeded bit. Returns the page unchanged when no rule matches."""
        if not isinstance(page, (bytes, bytearray)) or len(page) == 0:
            return page
        rule = self._take(point, key, payload_site=True)
        if rule is None:
            return page
        buf = bytearray(page)
        bit = self._rng.randrange(len(buf) * 8)
        buf[bit >> 3] ^= 1 << (bit & 7)
        return bytes(buf)

    def release_hangs(self) -> None:
        """Unblock every thread currently stuck in a HANG fault."""
        self._hang_release.set()

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
        self._hang_release.set()
