"""The generators: the same seed gives the same columns, and the row
counts are the configuration's."""

import pytest
import torch

from portbench.gen import tpch
from portbench.traffic import load_json

from .conftest import TINY_ROWS


def _tiny(name):
    cfg = load_json("configs", name + ".json")
    return {**cfg, "rows": TINY_ROWS[name]}


def test_tpch_same_seed_same_columns_other_seed_other():
    cfg = _tiny("tpch-sf10")
    a = tpch.generate(cfg, 2**31 + 5, "cpu")
    b = tpch.generate(cfg, 2**31 + 5, "cpu")
    c = tpch.generate(cfg, 2**31 + 6, "cpu")
    for name, t in a.items():
        assert t.columns.keys() == b[name].columns.keys()
        for col, v in t.columns.items():
            assert torch.equal(v, b[name].columns[col]), (name, col)
    assert not torch.equal(a["lineitem"].columns["l_partkey"],
                           c["lineitem"].columns["l_partkey"])


def test_tpch_row_counts_and_columns_are_the_configuration_s():
    cfg = _tiny("tpch-sf10")
    t = tpch.generate(cfg, 11, "cpu")
    assert t["region"].num_rows == 5 and t["nation"].num_rows == 25
    for name in ("supplier", "customer", "part", "orders"):
        assert t[name].num_rows == cfg["rows"][name]
    n_ord = cfg["rows"]["orders"]
    assert n_ord <= t["lineitem"].num_rows <= 7 * n_ord
    for name, cols in cfg["columns"].items():
        assert sorted(t[name].columns) == sorted(cols)


@pytest.mark.parametrize("table,base", [("supplier", 10_000),
                                        ("customer", 150_000),
                                        ("part", 200_000),
                                        ("orders", 1_500_000)])
def test_tpch_sf10_counts_are_clause_4_2_5_s(table, base):
    cfg = load_json("configs", "tpch-sf10.json")
    assert cfg["rows"][table] == cfg["scale_factor"] * base


def test_tpch_values_keep_dbgen_s_formulas():
    t = tpch.generate(_tiny("tpch-sf10"), 3, "cpu")
    li, o = t["lineitem"].columns, t["orders"].columns
    qty = li["l_quantity"] // 100
    assert torch.equal(li["l_extendedprice"],
                       qty * tpch.retail_price_cents(li["l_partkey"]))
    assert bool(((li["l_discount"] >= 0) & (li["l_discount"] <= 10)).all())
    assert bool((li["l_receiptdate"] > li["l_shipdate"]).all())
    assert bool((o["o_custkey"] % 3 != 0).all())
    assert bool((o["o_orderkey"] % 32).le(8).all())

