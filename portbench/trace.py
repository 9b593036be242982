"""The traced run: the benchmark's own spans and launch shapes around the
program's entry points, and the reduction of torch.profiler's trace to
what the per-layer readers read.

Spans are intervals named ``pb:<name>``, kept in memory on the wall
clock in ns, the clock of torch.profiler's trace (a profiler range
records only the thread that started the profiler, and the program's
work runs on its dispatch threads):

    pb:window             the measured window
    pb:client.submit      a client's POST /v1/statement
    pb:client.poll        a client's GET of a nextUri
    pb:session.plan       the serving layer's parse, plan and prune
    pb:session.execute    the program's execution of a planned query
    pb:kernels.K1/K3      a hand-written kernel's launch wrapper

Each wrapped launch also records its bytes (``roofline.py``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from . import roofline

SPAN_ORDER = ("pb:kernels.K1", "pb:kernels.K3", "pb:session.plan",
              "pb:session.execute", "pb:client.submit", "pb:client.poll")


@dataclass
class Reading:
    """What a per-layer reader gets from one traced run."""
    workload: str
    queries: list                 # the window's QueryRecords
    window_s: float = 0.0
    busy_s: float = 0.0
    dtoh: int = 0                 # Memcpy DtoH activities in the window
    torch_kernel_s: float = 0.0   # device s in kernels not from csrc/
    kernel_s: Dict[str, float] = field(default_factory=dict)
    kernel_bytes: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    span_s: Dict[str, List[float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def answered(self) -> int:
        return sum(1 for q in self.queries if q.ok)


class Spans:
    """Installs the wrappers; ``recording`` gates the launch records, so
    only the window's launches count."""

    def __init__(self):
        self.recording = False
        self.bytes: Dict[str, int] = defaultdict(int)
        self.launches: Dict[str, int] = defaultdict(int)
        self.host: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()
        self._undo = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.host.append((name, t0, time.time_ns()))

    def _wrap(self, owner, attr, name, count=None):
        real = getattr(owner, attr)

        def wrapper(*args, **kwargs):
            with self.span(name):
                if count is not None and self.recording:
                    b = count(*args, **kwargs)
                    with self._lock:
                        self.bytes[name] += b
                        self.launches[name] += 1
                return real(*args, **kwargs)

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, real))

    def install(self) -> None:
        from trino_tpu_torch.exec.session import Session
        from trino_tpu_torch.ops import gather, hashtable
        from trino_tpu_torch.server.serving import ServingLayer
        self._wrap(ServingLayer, "plan_entry", "pb:session.plan")
        self._wrap(Session, "execute_planned", "pb:session.execute")
        self._wrap(gather, "_launch", "pb:kernels.K1",
                   lambda tables, idx, fills: roofline.k1_bytes(tables, idx))
        self._wrap(hashtable, "_launch", "pb:kernels.K3",
                   lambda key, mask, tid, planes, layout, nstates, T, G,
                   pairs: roofline.k3_bytes(key, mask, tid, planes,
                                            nstates, T, G, pairs))

    def uninstall(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()


@contextlib.contextmanager
def profiled(device: str):
    """torch.profiler over the device's activities (the host's own only
    where there is no card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU if device == "cpu"
            else ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=False,
                 profile_memory=False, with_stack=False) as prof:
        yield prof
        if device != "cpu":
            torch.cuda.synchronize()


def _events(prof):
    """(name, start_s, end_s, on_device) of every activity, on one clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type().name == "CUDA"
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9, dev))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(prof, spans: Spans, reading: Reading, top: int = 10) -> Reading:
    t0 = time.monotonic()
    host: Dict[str, list] = defaultdict(list)
    for name, s, e in spans.host:
        host[name].append((s * 1e-9, e * 1e-9))
    if not host.get("pb:window"):
        raise RuntimeError("no pb:window span")
    w0, w1 = host["pb:window"][0]
    reading.window_s = w1 - w0
    device = []
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e, on_dev in _events(prof):
        if not on_dev:
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        device.append((s, e))
        by_name[name] += e - s
        if name.startswith("Memcpy DtoH"):
            reading.dtoh += 1
        elif not name.startswith(("Memcpy", "Memset")):
            k = roofline.kernel_of(name)
            if k is None:
                reading.torch_kernel_s += e - s
            else:
                reading.kernel_s[k] = reading.kernel_s.get(k, 0.0) + e - s
    merged = _union(device)
    reading.busy_s = sum(e - s for s, e in merged)
    reading.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    if merged:
        gaps += [(merged[0][0] - w0, w0, merged[0][0]),
                 (w1 - merged[-1][1], merged[-1][1], w1)]
    else:
        gaps.append((w1 - w0, w0, w1))
    gaps = sorted(g for g in gaps if g[0] > 0)[::-1][:top]
    reading.idle_gaps = [(_doing(host, (a + b) / 2), g) for g, a, b in gaps]
    for name, ivs in host.items():
        inside = [e - s for s, e in ivs if s >= w0 and e <= w1]
        reading.span_s[name[3:]] = inside
    for name, b in spans.bytes.items():
        reading.kernel_bytes[name.rsplit(".", 1)[1]] = b
    for name, n in spans.launches.items():
        reading.launches[name.rsplit(".", 1)[1]] = n
    reading.span_s["reduce_s"] = [time.monotonic() - t0]
    return reading


def _doing(host: Dict[str, list], t: float) -> str:
    """What the host was doing at `t`: the first of SPAN_ORDER open then."""
    for name in SPAN_ORDER:
        for s, e in host.get(name, ()):
            if s <= t <= e:
                return name[3:]
    return "none of the spans"

