"""TPC-H q10, the returned item reporting query: the 20 customers with
the most revenue lost to returns in a quarter."""

import torch

from ..common import (add_months, code, dec, days, key_lut, lookup, pick,
                      top_with_ties)


def answer(t, p, arith):
    c, o, li, n = t["customer"], t["orders"], t["lineitem"], t["nation"]
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 3)
    od = o.columns["o_orderdate"]
    orders = key_lut(o.columns["o_orderkey"], (od >= lo) & (od < hi))
    lm = li.columns["l_returnflag"] == code(li, "l_returnflag", "R")
    orow = lookup(orders, li.columns["l_orderkey"][lm])
    keep = orow >= 0
    cust = key_lut(c.columns["c_custkey"])
    crow = lookup(cust, o.columns["o_custkey"][orow[keep]])
    rev = (li.columns["l_extendedprice"][lm][keep] *
           (100 - li.columns["l_discount"][lm][keep]))
    sums = arith.group_sum(crow, rev, c.num_rows, 4)
    has = torch.zeros(c.num_rows, dtype=torch.bool, device=crow.device)
    has[crow] = True
    g = has.nonzero().flatten()
    top = g[top_with_ties([-sums[g]], 20)]
    cc = {k: v[top] for k, v in c.columns.items()}
    nation = key_lut(n.columns["n_nationkey"])
    n_names = pick(n.pools["n_name"], n.columns["n_name"][
        lookup(nation, cc["c_nationkey"])])
    return list(zip(
        cc["c_custkey"].tolist(), pick(c.pools["c_name"], cc["c_name"]),
        [dec(v, 4) for v in sums[top].tolist()],
        [dec(v, 2) for v in cc["c_acctbal"].tolist()], n_names,
        pick(c.pools["c_address"], cc["c_address"]),
        pick(c.pools["c_phone"], cc["c_phone"]),
        pick(c.pools["c_comment"], cc["c_comment"])))
