"""TPC-H q5, the local supplier volume query: revenue by nation of one
region in one year, where customer and supplier share the nation."""

import torch

from ..common import add_months, code, dec, days, key_lut, lookup


def answer(t, p, arith):
    r, n, s = t["region"], t["nation"], t["supplier"]
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 12)
    rk = r.columns["r_regionkey"][
        r.columns["r_name"] == code(r, "r_name", p["REGION"])]
    nations = n.columns["n_nationkey"][
        torch.isin(n.columns["n_regionkey"], rk)]
    cust = key_lut(c.columns["c_custkey"])
    od = o.columns["o_orderdate"]
    om = (od >= lo) & (od < hi)
    o_nation = c.columns["c_nationkey"][
        lookup(cust, o.columns["o_custkey"]).clamp(min=0)]
    om &= torch.isin(o_nation, nations)
    orders = key_lut(o.columns["o_orderkey"], om)
    orow = lookup(orders, li.columns["l_orderkey"])
    keep = orow >= 0
    supp = key_lut(s.columns["s_suppkey"])
    s_nation = s.columns["s_nationkey"][
        lookup(supp, li.columns["l_suppkey"][keep]).clamp(min=0)]
    match = s_nation == o_nation[orow[keep]]
    nat = s_nation[match]
    rev = (li.columns["l_extendedprice"][keep][match] *
           (100 - li.columns["l_discount"][keep][match]))
    sums = arith.group_sum(nat, rev, 25, 4)
    counts = torch.bincount(nat, minlength=25)
    names = n.pools["n_name"]
    name_of = dict(zip(n.columns["n_nationkey"].tolist(),
                       n.columns["n_name"].tolist()))
    return [(names[name_of[k]], dec(sums[k], 4))
            for k in range(25) if int(counts[k]) > 0]
