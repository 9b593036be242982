"""TPC-H q3, the shipping priority query: revenue of the orders of one
market segment not yet shipped on a day, the 10 largest."""

import torch

from ..common import code, dec, days, iso, key_lut, lookup, top_with_ties


def answer(t, p, arith):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    date = days(p["DATE"])
    seg = code(c, "c_mktsegment", p["SEGMENT"])
    cust = key_lut(c.columns["c_custkey"],
                   c.columns["c_mktsegment"] == seg)
    ocols = o.columns
    om = (ocols["o_orderdate"] < date) & \
        (lookup(cust, ocols["o_custkey"]) >= 0)
    orders = key_lut(ocols["o_orderkey"], om)
    lm = li.columns["l_shipdate"] > date
    row = lookup(orders, li.columns["l_orderkey"][lm])
    keep = row >= 0
    row = row[keep]
    rev = (li.columns["l_extendedprice"][lm][keep] *
           (100 - li.columns["l_discount"][lm][keep]))
    sums = arith.group_sum(row, rev, o.num_rows, 4)
    has = torch.zeros(o.num_rows, dtype=torch.bool, device=row.device)
    has[row] = True
    g = has.nonzero().flatten()
    top = g[top_with_ties([-sums[g], ocols["o_orderdate"][g]], 10)]
    return [(int(k), dec(s, 4), iso(d), int(sp)) for k, s, d, sp in zip(
        ocols["o_orderkey"][top].tolist(), sums[top].tolist(),
        ocols["o_orderdate"][top].tolist(),
        ocols["o_shippriority"][top].tolist())]
