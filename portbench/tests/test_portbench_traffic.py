"""The traffic: parameters within their clauses' domains, the same texts
for a seed, and no text sent twice in a window."""

import datetime

import pytest

from portbench.traffic import Traffic, _months, load_json, load_template

CELLS = ["tpch-sf10.joins"]


def _within(dom, names, params):
    (kind, arg), = dom.items()
    keys = names.split(",")
    vals = [params[k] for k in keys]
    if kind == "choice":
        return vals[0] in arg
    if kind == "int":
        return arg[0] <= vals[0] <= arg[1]
    if kind == "day":
        return arg[0] <= vals[0] <= arg[1]
    if kind == "year_start":
        return vals[0].endswith("-01-01") and \
            arg[0] <= int(vals[0][:4]) <= arg[1]
    if kind == "month_start":
        return vals[0] in _months(*arg)
    if kind == "distinct":
        return len(set(vals)) == len(vals) and set(vals) <= set(arg)
    raise AssertionError(kind)


@pytest.mark.parametrize("cell", CELLS)
def test_parameters_stay_in_their_domains(cell):
    wl = load_json("workloads", cell + ".json")
    t = Traffic(wl, 2**31 + 99)
    seen = {}
    for s in range(wl["streams"]):
        for i in range(300):
            q = t.query(str(s), i)
            spec = t.templates[q.template][1]
            for names, dom in spec["params"].items():
                assert _within(dom, names, q.params), (q.template, names,
                                                       q.params)
            seen.setdefault(q.template, set()).add(
                tuple(sorted(q.params.items())))
    assert set(seen) == set(wl["templates"])
    # the draws do vary
    assert all(len(v) > 1 for v in seen.values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_window_s_texts_are_distinct_and_fixed_by_the_seed(cell):
    wl = load_json("workloads", cell + ".json")
    a, b = Traffic(wl, 12345), Traffic(wl, 12345)
    texts = [a.query(str(s), i).sql for s in range(wl["streams"])
             for i in range(500)] + [a.query("warm", i).sql
                                     for i in range(20)]
    assert len(set(texts)) == len(texts)
    assert texts[:50] == [b.query(str(s), i).sql
                          for s in range(wl["streams"])
                          for i in range(500)][:50]


@pytest.mark.parametrize("cell", CELLS)
def test_each_stream_runs_a_permutation_of_the_templates(cell):
    wl = load_json("workloads", cell + ".json")
    t = Traffic(wl, 7)
    n = len(wl["templates"])
    for s in range(wl["streams"]):
        first = [t.query(str(s), i).template for i in range(n)]
        assert sorted(first) == sorted(wl["templates"])
        assert [t.query(str(s), n + i).template for i in range(n)] == first


@pytest.mark.parametrize("bench,names,clause", [
    ("tpch", ("q03", "q05", "q10", "q12", "q14", "q19"),
     "TPC-H 3.0.1 Clause 2.4.")])
def test_every_template_declares_its_clause_and_columns(bench, names,
                                                        clause):
    for name in names:
        text, spec = load_template(bench, name)
        assert spec["clause"].startswith(clause)
        for p in spec["params"]:
            for k in p.split(","):
                assert f"[{k}]" in text
        for dom in spec["params"].values():
            (kind, arg), = dom.items()
            if kind in ("day", "month_start"):
                for d in arg:
                    datetime.date.fromisoformat(d)


@pytest.mark.parametrize("cell", CELLS)
def test_each_query_draws_its_own_parameters(cell):
    """Clause 2.4: every query draws its parameters from its template's
    whole domain, keyed by the seed, the stream and its place; no fixed
    set of parameter sets is dealt out."""
    wl = load_json("workloads", cell + ".json")
    a, b = Traffic(wl, 2**31 + 1), Traffic(wl, 2**31 + 2)
    key = lambda q: tuple(sorted(q.params.items()))
    seen = {}
    for s in range(wl["streams"]):
        for i in range(300):
            q = a.query(str(s), i)
            seen.setdefault(q.template, set()).add(key(q))
    # the smallest domains (q5's 25 sets, q10's 24) are covered
    assert all(len(v) > 20 for v in seen.values()), \
        {k: len(v) for k, v in seen.items()}
    # another seed asks for other parameters at nearly every place
    places = [(str(s), i) for s in range(wl["streams"]) for i in range(30)]
    differ = sum(key(a.query(*p)) != key(b.query(*p)) for p in places)
    assert differ >= 0.8 * len(places)
