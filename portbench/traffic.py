"""The one traffic generator: a workload file's streams of SQL texts.

A workload (``workloads/<cell>.json``) names its templates, its number of
streams and its loop. Each stream runs its own permutation of the
templates, drawn from the seed, over and over.

Each query draws its own substitution parameters from its template's
domains (``templates/<bench>/<qNN>.json``), as TPC-H Clause 2.4 asks,
with a generator keyed by the seed, the stream and the query's place,
so the same seed sends the same texts. The warm-up's stream ("warm") is
drawn the same way under a key of its own. Each text starts with a
comment that names its seed, stream and place, so no two texts of a run
are the same, whichever parameters repeat.

Parameter domains, by kind:
    {"choice": [...]}            one of the values
    {"int": [lo, hi]}            an integer in [lo, hi]
    {"day": [from, to]}          an ISO day in [from, to]
    {"year_start": [y0, y1]}     January 1 of a year in [y0, y1]
    {"month_start": [from, to]}  the first day of a month in [from, to]
    {"distinct": [...]}          for "A,B": two different values
"""

from __future__ import annotations

import datetime
import json
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# the words that key each draw, after the seed
ORDER, PARAMS = 0, 1
WARM_WORD = 1 << 32


@dataclass(frozen=True)
class Query:
    stream: str
    index: int
    template: str
    params: Dict[str, object]
    sql: str


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_template(bench: str, name: str):
    with open(os.path.join(HERE, "templates", bench, name + ".sql")) as f:
        text = f.read()
    return text, load_json("templates", bench, name + ".json")


def _months(lo: str, hi: str) -> List[str]:
    a, b = datetime.date.fromisoformat(lo), datetime.date.fromisoformat(hi)
    out = []
    y, m = a.year, a.month
    while (y, m) <= (b.year, b.month):
        out.append(f"{y:04d}-{m:02d}-01")
        y, m = (y + 1, 1) if m == 12 else (y, m + 1)
    return out


def draw(domains: dict, rng: np.random.Generator) -> Dict[str, object]:
    """One value for each parameter of a template, in the file's order."""
    out: Dict[str, object] = {}
    for names, dom in domains.items():
        (kind, arg), = dom.items()
        if kind == "choice":
            out[names] = arg[int(rng.integers(len(arg)))]
        elif kind == "int":
            out[names] = int(rng.integers(arg[0], arg[1] + 1))
        elif kind == "day":
            lo, hi = (datetime.date.fromisoformat(d) for d in arg)
            n = (hi - lo).days + 1
            out[names] = (lo + datetime.timedelta(
                days=int(rng.integers(n)))).isoformat()
        elif kind == "year_start":
            out[names] = f"{int(rng.integers(arg[0], arg[1] + 1))}-01-01"
        elif kind == "month_start":
            months = _months(*arg)
            out[names] = months[int(rng.integers(len(months)))]
        elif kind == "distinct":
            keys = names.split(",")
            picks = rng.choice(len(arg), size=len(keys), replace=False)
            for k, i in zip(keys, picks):
                out[k] = arg[int(i)]
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
    return out


def render(text: str, params: Dict[str, object]) -> str:
    for k, v in params.items():
        text = text.replace(f"[{k}]", str(v))
    if "[" in text and "]" in text:
        raise ValueError(f"unfilled parameter in {text!r}")
    return text


class Traffic:
    """The workload's queries: ``query(stream, i)`` is the i-th query of
    a stream; streams are named "0", "1", ... and "warm" for set-up."""

    def __init__(self, workload: dict, seed: int):
        self.workload = workload
        self.seed = int(seed)
        self.bench = workload["bench"]
        self.templates = {name: load_template(self.bench, name)
                          for name in workload["templates"]}
        self._perms: Dict[str, List[str]] = {}

    def _rng(self, kind: int, stream: str, i: int = 0):
        word = WARM_WORD if stream == "warm" else int(stream)
        return np.random.default_rng([self.seed, kind, word, i])

    def order(self, stream: str) -> List[str]:
        if stream not in self._perms:
            names = list(self.workload["templates"])
            perm = self._rng(ORDER, stream).permutation(len(names))
            self._perms[stream] = [names[int(i)] for i in perm]
        return self._perms[stream]

    def query(self, stream: str, i: int) -> Query:
        order = self.order(stream)
        name = order[i % len(order)]
        text, spec = self.templates[name]
        params = draw(spec["params"], self._rng(PARAMS, stream, i))
        head = (f"-- portbench {self.workload['name']} seed {self.seed} "
                f"stream {stream} query {i} ({name})\n")
        return Query(stream, i, name, params, head + render(text, params))

