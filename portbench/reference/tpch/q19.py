"""TPC-H q19, the discounted revenue query: revenue of three brand,
container, size and quantity ranges shipped by air in person."""

import torch

from ..common import code, dec, key_lut, lookup

GROUPS = (("BRAND1", "QUANTITY1", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
           5),
          ("BRAND2", "QUANTITY2", ("MED BAG", "MED BOX", "MED PKG",
                                   "MED PACK"), 10),
          ("BRAND3", "QUANTITY3", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
           15))


def answer(t, p, arith):
    li, part = t["lineitem"], t["part"]
    L, P = li.columns, part.columns
    dev = L["l_partkey"].device
    air = torch.tensor([code(li, "l_shipmode", m) for m in ("AIR", "AIR REG")],
                       device=dev)
    m = torch.isin(L["l_shipmode"], air) & \
        (L["l_shipinstruct"] == code(li, "l_shipinstruct",
                                     "DELIVER IN PERSON"))
    prow = lookup(key_lut(P["p_partkey"]), L["l_partkey"][m]).clamp(min=0)
    qty = L["l_quantity"][m]
    hit = torch.zeros_like(qty, dtype=torch.bool)
    for brand, quantity, containers, size in GROUPS:
        q = int(p[quantity]) * 100
        cont = torch.tensor([code(part, "p_container", s)
                             for s in containers], device=dev)
        hit |= (P["p_brand"][prow] == code(part, "p_brand", p[brand])) & \
            torch.isin(P["p_container"][prow], cont) & \
            (qty >= q) & (qty <= q + 1000) & \
            (P["p_size"][prow] >= 1) & (P["p_size"][prow] <= size)
    if not bool(hit.any()):
        return [(None,)]
    rev = L["l_extendedprice"][m][hit] * (100 - L["l_discount"][m][hit])
    return [(dec(arith.total(rev, 4), 4),)]
