"""TPC-H q14, the promotion effect query: the share of a month's revenue
from promotional parts, as decimal(38,6) (100.00 * decimal(38,4) /
decimal(38,4): the scale of the dividend, rounded half up)."""

import torch

from ..common import add_months, dec, days, key_lut, lookup


def answer(t, p, arith):
    li, part = t["lineitem"], t["part"]
    lo, hi = days(p["DATE"]), add_months(p["DATE"], 1)
    L = li.columns
    m = (L["l_shipdate"] >= lo) & (L["l_shipdate"] < hi)
    prow = lookup(key_lut(part.columns["p_partkey"]), L["l_partkey"][m])
    keep = prow >= 0
    if not bool(keep.any()):
        return [(None,)]
    promo_codes = [i for i, s in enumerate(part.pools["p_type"])
                   if s.startswith("PROMO")]
    promo = torch.isin(part.columns["p_type"][prow[keep]],
                       torch.tensor(promo_codes, device=prow.device))
    rev = L["l_extendedprice"][m][keep] * (100 - L["l_discount"][m][keep])
    total = arith.total(rev, 4)
    num = arith.total(rev[promo], 4)
    if total == 0:
        return [(None,)]
    q, r = divmod(10 ** 8 * num, total)
    if 2 * r >= total:
        q += 1
    return [(dec(q, 6),)]
