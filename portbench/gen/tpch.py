"""TPC-H columns on the device, from a seed.

A frozen copy of the distributions of the program's TPC-H generator
(``connectors/tpch/datagen.py``, itself after dbgen): sparse order keys
(8 of every 32), orders only from customers whose key is not a multiple
of 3, dbgen's retail price formula, 1 to 7 lines an order, ship, commit
and receipt dates after the order date, the return flag from the
receipt date against 1995-06-17. The value streams are torch's on the
generating device, so they are not dbgen's text streams and not the
program generator's numpy streams. Only the columns named in the
configuration's ``columns`` are made, each table in a few large calls.

    generate(config, seed, device) -> {table name: Table}
"""

from __future__ import annotations

from typing import Dict

import torch

from .common import Table, codes_of, days, keep_columns, randint, word_pool

STARTDATE = days("1992-01-01")
CURRENTDATE = days("1995-06-17")
ENDDATE = days("1998-12-31")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN"]
TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_SYL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
LEXICON = (
    "the special packages requests accounts deposits foxes ideas theodolites "
    "pinto beans instructions dependencies excuses platelets asymptotes "
    "courts dolphins carefully quickly furiously slyly blithely express "
    "regular final ironic pending unusual even bold silent").split()
# text columns that no predicate reads draw from a pool this large
TEXT_POOL = 1024

D122 = "decimal(12,2)"


def retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    """dbgen: 90000 + ((partkey/10) % 20001) + 100 * (partkey % 1000)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def phone_pool():
    """dbgen's '<country>-ddd-ddd-dddd' with country = nation + 10; the
    local part is a function of the nation, as in the program's copy."""
    per_nation = [f"{10 + nk}-{100 + (nk * 7919) % 900}"
                  f"-{100 + (nk * 7919) % 900}-{100 + (nk * 7919) % 900}0"
                  for nk in range(25)]
    pool = sorted(set(per_nation))
    return pool, [pool.index(s) for s in per_nation]


def generate(config: dict, seed: int, device) -> Dict[str, Table]:
    rows = config["rows"]
    wanted = config.get("columns", {})
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    dev = torch.device(device)
    out: Dict[str, Table] = {}

    def keep(t: Table) -> None:
        out[t.name] = keep_columns(t, wanted.get(t.name))

    r_pool = sorted(REGIONS)
    keep(Table("region",
               {"r_regionkey": torch.arange(5, device=dev),
                "r_name": codes_of(REGIONS, r_pool, dev)},
               {"r_regionkey": "bigint", "r_name": "varchar"},
               {"r_name": r_pool}, ("r_regionkey",)))
    names = [n for n, _ in NATIONS]
    n_pool = sorted(names)
    keep(Table("nation",
               {"n_nationkey": torch.arange(25, device=dev),
                "n_name": codes_of(names, n_pool, dev),
                "n_regionkey": torch.tensor([r for _, r in NATIONS],
                                            device=dev)},
               {"n_nationkey": "bigint", "n_name": "varchar",
                "n_regionkey": "bigint"},
               {"n_name": n_pool}, ("n_nationkey",)))

    n_supp = int(rows["supplier"])
    keep(Table("supplier",
               {"s_suppkey": torch.arange(1, n_supp + 1, device=dev),
                "s_nationkey": randint(gen, 0, 25, n_supp, dev)},
               {"s_suppkey": "bigint", "s_nationkey": "bigint"},
               {}, ("s_suppkey",)))

    n_cust = int(rows["customer"])
    custkey = torch.arange(1, n_cust + 1, device=dev)
    c_nation = randint(gen, 0, 25, n_cust, dev)
    ph_pool, ph_of_nation = phone_pool()
    c_cols = {
        "c_custkey": custkey,
        "c_name": torch.arange(n_cust, dtype=torch.int32, device=dev),
        "c_address": randint(gen, 0, TEXT_POOL, n_cust, dev, torch.int32),
        "c_nationkey": c_nation,
        "c_phone": torch.tensor(ph_of_nation, dtype=torch.int32,
                                device=dev)[c_nation],
        "c_acctbal": randint(gen, -99999, 999999, n_cust, dev),
        "c_mktsegment": randint(gen, 0, 5, n_cust, dev, torch.int32),
        "c_comment": randint(gen, 0, TEXT_POOL, n_cust, dev, torch.int32),
    }
    c_wanted = wanted.get("customer")
    c_pools = {"c_phone": ph_pool, "c_mktsegment": sorted(SEGMENTS)}
    if c_wanted is None or "c_name" in c_wanted:
        # keys ascending, so the pool is sorted already
        c_pools["c_name"] = [f"Customer#{k:09d}"
                             for k in range(1, n_cust + 1)]
    c_pools["c_address"] = word_pool(seed % (1 << 32), TEXT_POOL, 3,
                                     LEXICON)
    c_pools["c_comment"] = word_pool(seed % (1 << 32) + 1, TEXT_POOL, 4,
                                     LEXICON)
    keep(Table("customer", c_cols,
               {"c_custkey": "bigint", "c_name": "varchar",
                "c_address": "varchar", "c_nationkey": "bigint",
                "c_phone": "varchar", "c_acctbal": D122,
                "c_mktsegment": "varchar", "c_comment": "varchar"},
               c_pools, ("c_custkey",)))

    n_part = int(rows["part"])
    partkey = torch.arange(1, n_part + 1, device=dev)
    mfgr = randint(gen, 1, 6, n_part, dev)
    brand_id = mfgr * 10 + randint(gen, 1, 6, n_part, dev)
    brand_pool = sorted(f"Brand#{m}{b}" for m in range(1, 6)
                        for b in range(1, 6))
    brand_lut = torch.zeros(56, dtype=torch.int32, device=dev)
    for i, s in enumerate(brand_pool):
        brand_lut[int(s[-2:])] = i
    type_pool = sorted(f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2
                       for c in TYPE_SYL3)
    cont_pool = sorted(f"{a} {b}" for a in CONTAINER_SYL1
                       for b in CONTAINER_SYL2)
    keep(Table("part",
               {"p_partkey": partkey,
                "p_brand": brand_lut[brand_id],
                "p_type": randint(gen, 0, len(type_pool), n_part, dev,
                                  torch.int32),
                "p_size": randint(gen, 1, 51, n_part, dev, torch.int32),
                "p_container": randint(gen, 0, len(cont_pool), n_part, dev,
                                       torch.int32)},
               {"p_partkey": "bigint", "p_brand": "varchar",
                "p_type": "varchar", "p_size": "integer",
                "p_container": "varchar"},
               {"p_brand": brand_pool, "p_type": type_pool,
                "p_container": cont_pool}, ("p_partkey",)))

    n_ord = int(rows["orders"])
    idx = torch.arange(n_ord, device=dev)
    orderkey = (idx // 8) * 32 + (idx % 8) + 1
    m_active = max(1, n_cust - n_cust // 3)
    j = randint(gen, 1, m_active + 1, n_ord, dev)
    o_custkey = torch.clamp(j + (j - 1) // 2, 1, n_cust)
    o_orderdate = randint(gen, STARTDATE, ENDDATE - 151 + 1, n_ord, dev,
                          torch.int32)
    lines = randint(gen, 1, 8, n_ord, dev)
    keep(Table("orders",
               {"o_orderkey": orderkey, "o_custkey": o_custkey,
                "o_orderdate": o_orderdate,
                "o_orderpriority": randint(gen, 0, 5, n_ord, dev,
                                           torch.int32),
                "o_shippriority": torch.zeros(n_ord, dtype=torch.int32,
                                              device=dev)},
               {"o_orderkey": "bigint", "o_custkey": "bigint",
                "o_orderdate": "date", "o_orderpriority": "varchar",
                "o_shippriority": "integer"},
               {"o_orderpriority": sorted(PRIORITIES)}, ("o_orderkey",)))

    l_orderkey = torch.repeat_interleave(orderkey, lines)
    l_orderdate = torch.repeat_interleave(o_orderdate, lines)
    del idx, j, o_custkey
    n_li = int(l_orderkey.shape[0])
    l_partkey = randint(gen, 1, n_part + 1, n_li, dev)
    li_i = randint(gen, 0, 4, n_li, dev)
    l_suppkey = ((l_partkey + li_i * (n_supp // 4 + (l_partkey - 1)
                                      // n_supp)) % n_supp) + 1
    del li_i
    quantity = randint(gen, 1, 51, n_li, dev)
    price = quantity * retail_price_cents(l_partkey)
    ship = l_orderdate + randint(gen, 1, 122, n_li, dev, torch.int32)
    commit = l_orderdate + randint(gen, 30, 91, n_li, dev, torch.int32)
    receipt = ship + randint(gen, 1, 31, n_li, dev, torch.int32)
    del l_orderdate
    coin = torch.rand(n_li, generator=gen, device=dev) < 0.5
    # A (0) or R (2) once received by 1995-06-17, else N (1)
    flag = torch.where(receipt <= CURRENTDATE,
                       torch.where(coin, 0, 2), 1).to(torch.int32)
    del coin
    keep(Table("lineitem",
               {"l_orderkey": l_orderkey, "l_partkey": l_partkey,
                "l_suppkey": l_suppkey, "l_quantity": quantity * 100,
                "l_extendedprice": price,
                "l_discount": randint(gen, 0, 11, n_li, dev),
                "l_returnflag": flag, "l_shipdate": ship,
                "l_commitdate": commit, "l_receiptdate": receipt,
                "l_shipinstruct": randint(gen, 0, 4, n_li, dev,
                                          torch.int32),
                "l_shipmode": randint(gen, 0, 7, n_li, dev, torch.int32)},
               {"l_orderkey": "bigint", "l_partkey": "bigint",
                "l_suppkey": "bigint", "l_quantity": D122,
                "l_extendedprice": D122, "l_discount": D122,
                "l_returnflag": "varchar", "l_shipdate": "date",
                "l_commitdate": "date", "l_receiptdate": "date",
                "l_shipinstruct": "varchar", "l_shipmode": "varchar"},
               {"l_returnflag": ["A", "N", "R"],
                "l_shipinstruct": sorted(INSTRUCTIONS),
                "l_shipmode": sorted(SHIPMODES)}))
    return out
