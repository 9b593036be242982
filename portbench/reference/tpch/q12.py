"""TPC-H q12, the shipping modes and order priority query: late lines
of two ship modes in a year, counted by the order's priority."""

import torch

from ..common import add_months, code, days, key_lut, lookup


def answer(t, p, arith):
    o, li = t["orders"], t["lineitem"]
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 12)
    modes = [code(li, "l_shipmode", p["SHIPMODE1"]),
             code(li, "l_shipmode", p["SHIPMODE2"])]
    L = li.columns
    m = torch.isin(L["l_shipmode"], torch.tensor(modes,
                                                 device=L["l_shipmode"].device))
    m &= (L["l_commitdate"] < L["l_receiptdate"]) & \
        (L["l_shipdate"] < L["l_commitdate"]) & \
        (L["l_receiptdate"] >= lo) & (L["l_receiptdate"] < hi)
    orders = key_lut(o.columns["o_orderkey"])
    pri = o.columns["o_orderpriority"][
        lookup(orders, L["l_orderkey"][m]).clamp(min=0)]
    urgent = [code(o, "o_orderpriority", "1-URGENT"),
              code(o, "o_orderpriority", "2-HIGH")]
    high = torch.isin(pri, torch.tensor(urgent, device=pri.device))
    mode = L["l_shipmode"][m].to(torch.int64)
    width = len(li.pools["l_shipmode"])
    n_high = torch.bincount(mode[high], minlength=width).tolist()
    n_all = torch.bincount(mode, minlength=width).tolist()
    pool = li.pools["l_shipmode"]
    return [(pool[k], n_high[k], n_all[k] - n_high[k])
            for k in range(width) if n_all[k] > 0]
