"""Port copy of ``trino_tpu/connectors/tpch/datagen.py`` (no edits beyond
import targets noted inline).

Deterministic in-memory TPC-H data generator.

Role of the reference's ``plugin/trino-tpch`` connector (TpchRecordSet.java:44):
a deterministic benchmark data source that needs no files. We generate with
vectorized numpy from a fixed seed, following dbgen's schema, referential
structure, and key distributions:

- sparse orderkeys (8 per 32-block, like dbgen)
- only 2/3 of customers place orders (custkey % 3 != 0)
- retail price formula p_retailprice(partkey) per dbgen
- l_extendedprice = quantity * retailprice(partkey)
- returnflag/linestatus driven by ship/receipt dates vs 1995-06-17
- o_totalprice aggregated from line items

Value *distributions* match dbgen; exact dbgen text streams are not
reproduced (comments come from a seeded lexicon). Correctness testing always
runs the oracle on *this* data (SURVEY.md §4.4's H2QueryRunner pattern), so
engine results are checked end-to-end regardless.

All decimals are scaled int64 (cents, or 1e-2 units).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ...batch import Field, Schema
from ...types import BIGINT, DATE, DOUBLE, INTEGER, VARCHAR, decimal

EPOCH = datetime.date(1970, 1, 1)


def days(s: str) -> int:
    return (datetime.date.fromisoformat(s) - EPOCH).days


STARTDATE = days("1992-01-01")
CURRENTDATE = days("1995-06-17")
ENDDATE = days("1998-12-31")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey) — dbgen's nation table
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
# dbgen's P_NAME color vocabulary (subset): q9 greps '%green%', q20
# 'forest%' — part names must be built from these words to exercise them
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue "
    "blush brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder "
    "puff purple red rose rosy royal saddle salmon sandy seashell sienna "
    "sky slate smoke snow spring steel tan thistle tomato turquoise "
    "violet wheat white yellow").split()


@dataclass
class TableData:
    """Host-side generated table: schema + numpy columns (valids all-true).

    VARCHAR columns are already dictionary codes; pools live in the schema.
    `primary_key` feeds the planner's build-side uniqueness reasoning (the
    role statistics play in DetermineJoinDistributionType.java:51).
    Optional `valids` carries per-column null masks (None = all valid).
    """
    name: str
    schema: Schema
    columns: List[np.ndarray]
    primary_key: tuple = ()
    valids: Optional[List[Optional[np.ndarray]]] = None

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0


PRIMARY_KEYS = {
    "region": ("r_regionkey",),
    "nation": ("n_nationkey",),
    "supplier": ("s_suppkey",),
    "customer": ("c_custkey",),
    "part": ("p_partkey",),
    "partsupp": ("ps_partkey", "ps_suppkey"),
    "orders": ("o_orderkey",),
    "lineitem": ("l_orderkey", "l_linenumber"),
}


def _dict_field(name: str, pool: List[str]) -> Field:
    return Field(name, VARCHAR, dictionary=tuple(pool))


def _codes_for(values: List[str], pool: List[str]) -> np.ndarray:
    index = {s: i for i, s in enumerate(pool)}
    return np.array([index[v] for v in values], dtype=np.int32)


_POOL_CAP = 1 << 16


def _comments(rng: np.random.Generator, n: int, words: int = 4,
              lexicon=None, inject=None, inject_every: int = 0) -> tuple:
    """Seeded comment strings from the lexicon; returns (codes, pool).

    The pool is bounded at 64k distinct strings and rows draw codes from
    it vectorized — Python-level string work is O(pool), not O(rows), so
    SF10/SF100 tables generate in numpy time and the engine's dictionary
    pools stay HBM-friendly (the DictionaryBlock discipline). Text
    *diversity* differs from dbgen above 64k rows; distributions and the
    grep-able patterns benchmark predicates rely on are preserved, and
    the oracle always runs on this same data.

    inject/inject_every: stamp a two-word marker (e.g. 'Customer',
    'Complaints') into every k-th string, mirroring dbgen's deliberate
    pattern injection that q13/q16 predicates grep for."""
    lex = np.array(lexicon if lexicon is not None else LEXICON)
    pool_n = int(min(n, _POOL_CAP))
    picks = rng.integers(0, len(lex), size=(pool_n, words))
    base = [" ".join(lex[row]) for row in picks]
    variants = []
    if inject and inject_every:
        a, b = inject
        n_var = max(1, min(64, pool_n))
        variants = [f"{base[i][:4]}{a} the slyly {b} {base[i]}"
                    for i in range(n_var)]
    pool = sorted(set(base + variants))
    index = {s: i for i, s in enumerate(pool)}
    base_codes = np.array([index[s] for s in base], dtype=np.int32)
    codes = base_codes[rng.integers(0, pool_n, size=n)]
    if inject and inject_every:
        var_codes = np.array([index[s] for s in variants], dtype=np.int32)
        pos = np.arange(0, n, inject_every)
        codes[pos] = var_codes[rng.integers(0, len(var_codes),
                                            size=len(pos))]
    return codes, pool


def _phones(nationkey: np.ndarray) -> tuple:
    """dbgen phone format: '<country>-ddd-ddd-dddd', country = nation+10
    (q22 takes substring(phone,1,2) as the country code). The local part
    is a pure function of nationkey, so the pool has 25 entries and codes
    come from a LUT gather — no per-row strings."""
    per_nation = [f"{10 + nk}-{100 + (nk * 7919) % 900}"
                  f"-{100 + (nk * 7919) % 900}-{100 + (nk * 7919) % 900}0"
                  for nk in range(25)]
    pool = sorted(set(per_nation))
    index = {s: i for i, s in enumerate(pool)}
    lut = np.array([index[s] for s in per_nation], dtype=np.int32)
    return lut[nationkey], pool


def _formula_names(prefix: str, keys: np.ndarray) -> tuple:
    strings = [f"{prefix}#{k:09d}" for k in keys]
    # keys ascending => pool is sorted already
    pool = list(strings)
    return np.arange(len(strings), dtype=np.int32), pool


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """dbgen: 90000 + ((partkey/10) % 20001) + 100 * (partkey % 1000)."""
    pk = partkey.astype(np.int64)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def generate(scale: float, seed: int = 19920101) -> Dict[str, TableData]:
    rng = np.random.default_rng(seed)
    tables: Dict[str, TableData] = {}

    # ---- region / nation --------------------------------------------------
    r_comment_codes, r_comment_pool = _comments(rng, len(REGIONS))
    tables["region"] = TableData(
        "region",
        Schema.of(Field("r_regionkey", BIGINT),
                  _dict_field("r_name", sorted(REGIONS)),
                  _dict_field("r_comment", r_comment_pool)),
        [np.arange(5, dtype=np.int64),
         _codes_for(REGIONS, sorted(REGIONS)),
         r_comment_codes])

    n_names = [n for n, _ in NATIONS]
    n_comment_codes, n_comment_pool = _comments(rng, len(NATIONS))
    tables["nation"] = TableData(
        "nation",
        Schema.of(Field("n_nationkey", BIGINT),
                  _dict_field("n_name", sorted(n_names)),
                  Field("n_regionkey", BIGINT),
                  _dict_field("n_comment", n_comment_pool)),
        [np.arange(25, dtype=np.int64),
         _codes_for(n_names, sorted(n_names)),
         np.array([r for _, r in NATIONS], dtype=np.int64),
         n_comment_codes])

    # ---- supplier ---------------------------------------------------------
    n_supp = max(1, int(scale * 10_000))
    suppkey = np.arange(1, n_supp + 1, dtype=np.int64)
    s_name_codes, s_name_pool = _formula_names("Supplier", suppkey)
    s_addr_codes, s_addr_pool = _comments(rng, n_supp, words=2)
    s_nation = rng.integers(0, 25, n_supp).astype(np.int64)
    # dbgen plants 'Customer ... Complaints' in a sliver of supplier
    # comments (q16's NOT IN subquery greps for it)
    s_comment_codes, s_comment_pool = _comments(
        rng, n_supp, inject=("Customer", "Complaints"), inject_every=13)
    s_phone_codes, s_phone_pool = _phones(s_nation)
    tables["supplier"] = TableData(
        "supplier",
        Schema.of(Field("s_suppkey", BIGINT),
                  _dict_field("s_name", s_name_pool),
                  _dict_field("s_address", s_addr_pool),
                  Field("s_nationkey", BIGINT),
                  _dict_field("s_phone", s_phone_pool),
                  Field("s_acctbal", decimal(12, 2)),
                  _dict_field("s_comment", s_comment_pool)),
        [suppkey, s_name_codes, s_addr_codes,
         s_nation,
         s_phone_codes,
         rng.integers(-99999, 999999, n_supp).astype(np.int64),
         s_comment_codes])

    # ---- customer ---------------------------------------------------------
    n_cust = max(1, int(scale * 150_000))
    custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    c_name_codes, c_name_pool = _formula_names("Customer", custkey)
    c_addr_codes, c_addr_pool = _comments(rng, n_cust, words=2)
    c_comment_codes, c_comment_pool = _comments(rng, n_cust)
    c_nation = rng.integers(0, 25, n_cust).astype(np.int64)
    c_phone_codes, c_phone_pool = _phones(c_nation)
    seg_pool = sorted(SEGMENTS)
    tables["customer"] = TableData(
        "customer",
        Schema.of(Field("c_custkey", BIGINT),
                  _dict_field("c_name", c_name_pool),
                  _dict_field("c_address", c_addr_pool),
                  Field("c_nationkey", BIGINT),
                  _dict_field("c_phone", c_phone_pool),
                  Field("c_acctbal", decimal(12, 2)),
                  _dict_field("c_mktsegment", seg_pool),
                  _dict_field("c_comment", c_comment_pool)),
        [custkey, c_name_codes, c_addr_codes,
         c_nation,
         c_phone_codes,
         rng.integers(-99999, 999999, n_cust).astype(np.int64),
         rng.integers(0, 5, n_cust).astype(np.int32),
         c_comment_codes])

    # ---- part -------------------------------------------------------------
    n_part = max(1, int(scale * 200_000))
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    p_name_codes, p_name_pool = _comments(rng, n_part, words=3,
                                          lexicon=COLORS)
    mfgr_id = rng.integers(1, 6, n_part)
    brand_id = mfgr_id * 10 + rng.integers(1, 6, n_part)
    mfgr_pool = [f"Manufacturer#{i}" for i in range(1, 6)]
    brand_pool = [f"Brand#{m}{b}" for m in range(1, 6) for b in range(1, 6)]
    brand_pool_sorted = sorted(brand_pool)
    _brand_index = {s: i for i, s in enumerate(brand_pool_sorted)}
    _brand_lut = np.array(
        [_brand_index.get(f"Brand#{v}", 0) for v in range(56)],
        dtype=np.int32)
    brand_codes = _brand_lut[brand_id]
    types = [f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2
             for c in TYPE_SYL3]
    type_pool = sorted(types)
    type_codes = rng.integers(0, len(type_pool), n_part).astype(np.int32)
    containers = [f"{a} {b}" for a in CONTAINER_SYL1 for b in CONTAINER_SYL2]
    cont_pool = sorted(containers)
    p_comment_codes, p_comment_pool = _comments(rng, n_part, words=2)
    tables["part"] = TableData(
        "part",
        Schema.of(Field("p_partkey", BIGINT),
                  _dict_field("p_name", p_name_pool),
                  _dict_field("p_mfgr", mfgr_pool),
                  _dict_field("p_brand", brand_pool_sorted),
                  _dict_field("p_type", type_pool),
                  Field("p_size", INTEGER),
                  _dict_field("p_container", cont_pool),
                  Field("p_retailprice", decimal(12, 2)),
                  _dict_field("p_comment", p_comment_pool)),
        [partkey, p_name_codes,
         (mfgr_id - 1).astype(np.int32),
         brand_codes,
         type_codes,
         rng.integers(1, 51, n_part).astype(np.int32),
         rng.integers(0, len(cont_pool), n_part).astype(np.int32),
         retail_price_cents(partkey),
         p_comment_codes])

    # ---- partsupp ---------------------------------------------------------
    # dbgen: 4 suppliers per part, spread deterministically
    ps_partkey = np.repeat(partkey, 4)
    i = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_suppkey = ((ps_partkey + i * (n_supp // 4 + (ps_partkey - 1)
                                     // n_supp)) % n_supp) + 1
    n_ps = len(ps_partkey)
    ps_comment_codes, ps_comment_pool = _comments(rng, n_ps, words=2)
    tables["partsupp"] = TableData(
        "partsupp",
        Schema.of(Field("ps_partkey", BIGINT),
                  Field("ps_suppkey", BIGINT),
                  Field("ps_availqty", INTEGER),
                  Field("ps_supplycost", decimal(12, 2)),
                  _dict_field("ps_comment", ps_comment_pool)),
        [ps_partkey, ps_suppkey,
         rng.integers(1, 10_000, n_ps).astype(np.int32),
         rng.integers(100, 100_001, n_ps).astype(np.int64),
         ps_comment_codes])

    # ---- orders + lineitem ------------------------------------------------
    n_ord = max(1, int(scale * 1_500_000))
    idx = np.arange(n_ord, dtype=np.int64)
    orderkey = (idx // 8) * 32 + (idx % 8) + 1      # sparse, like dbgen
    # dbgen: only customers with custkey % 3 != 0 place orders;
    # j-th such key is j + (j-1)//2 (1,2,4,5,7,8,...)
    m_active = max(1, n_cust - n_cust // 3)
    j = rng.integers(1, m_active + 1, n_ord).astype(np.int64)
    o_custkey = np.clip(j + (j - 1) // 2, 1, n_cust)
    o_orderdate = rng.integers(STARTDATE, ENDDATE - 151 + 1,
                               n_ord).astype(np.int32)
    lines_per_order = rng.integers(1, 8, n_ord)
    o_comment_codes, o_comment_pool = _comments(rng, n_ord)
    o_clerk_codes, o_clerk_pool = _formula_names(
        "Clerk", np.arange(1, max(2, int(scale * 1000)) + 1))
    clerk_assign = rng.integers(0, len(o_clerk_pool), n_ord).astype(np.int32)

    # lineitem (expand orders)
    l_orderkey = np.repeat(orderkey, lines_per_order)
    l_orderdate = np.repeat(o_orderdate, lines_per_order)
    n_li = len(l_orderkey)
    starts = np.concatenate([[0], np.cumsum(lines_per_order)[:-1]])
    l_linenumber = (np.arange(n_li, dtype=np.int64)
                    - np.repeat(starts, lines_per_order) + 1)
    l_partkey = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    # supplier for (part, i): same formula as partsupp with i in 0..3
    li_i = rng.integers(0, 4, n_li).astype(np.int64)
    l_suppkey = ((l_partkey + li_i * (n_supp // 4 + (l_partkey - 1)
                                      // n_supp)) % n_supp) + 1
    l_quantity = rng.integers(1, 51, n_li).astype(np.int64)
    l_extendedprice = l_quantity * retail_price_cents(l_partkey)
    l_discount = rng.integers(0, 11, n_li).astype(np.int64)   # 0.00-0.10
    l_tax = rng.integers(0, 9, n_li).astype(np.int64)         # 0.00-0.08
    l_shipdate = l_orderdate + rng.integers(1, 122, n_li)
    l_commitdate = l_orderdate + rng.integers(30, 91, n_li)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_li)
    shipped = l_receiptdate <= CURRENTDATE
    rf = np.where(shipped,
                  np.where(rng.random(n_li) < 0.5, 0, 2),  # A or R
                  1)                                        # N
    rf_pool = ["A", "N", "R"]
    ls = np.where(l_shipdate > CURRENTDATE, 1, 0)           # O else F
    ls_pool = ["F", "O"]
    l_comment_codes, l_comment_pool = _comments(rng, n_li, words=2)

    tables["lineitem"] = TableData(
        "lineitem",
        Schema.of(Field("l_orderkey", BIGINT),
                  Field("l_partkey", BIGINT),
                  Field("l_suppkey", BIGINT),
                  Field("l_linenumber", BIGINT),
                  Field("l_quantity", decimal(12, 2)),
                  Field("l_extendedprice", decimal(12, 2)),
                  Field("l_discount", decimal(12, 2)),
                  Field("l_tax", decimal(12, 2)),
                  _dict_field("l_returnflag", rf_pool),
                  _dict_field("l_linestatus", ls_pool),
                  Field("l_shipdate", DATE),
                  Field("l_commitdate", DATE),
                  Field("l_receiptdate", DATE),
                  _dict_field("l_shipinstruct", sorted(INSTRUCTIONS)),
                  _dict_field("l_shipmode", sorted(SHIPMODES)),
                  _dict_field("l_comment", l_comment_pool)),
        [l_orderkey, l_partkey, l_suppkey, l_linenumber,
         l_quantity * 100,       # decimal(12,2) representation
         l_extendedprice, l_discount, l_tax,
         rf.astype(np.int32), ls.astype(np.int32),
         l_shipdate.astype(np.int32), l_commitdate.astype(np.int32),
         l_receiptdate.astype(np.int32),
         rng.integers(0, 4, n_li).astype(np.int32),
         rng.integers(0, 7, n_li).astype(np.int32),
         l_comment_codes])

    # order status/totalprice from line items
    disc_price = l_extendedprice * (100 - l_discount) // 100
    charge = disc_price * (100 + l_tax) // 100
    order_index = np.repeat(np.arange(n_ord), lines_per_order)
    # bincount-based segment reductions (np.add.at's buffered scatter is
    # ~20x slower at SF10's 60M rows)
    o_totalprice = np.bincount(order_index, weights=charge,
                               minlength=n_ord).astype(np.int64)
    n_f_lines = np.bincount(order_index, weights=(ls == 0),
                            minlength=n_ord)
    all_f = n_f_lines == lines_per_order
    any_f = n_f_lines > 0
    status_pool = ["F", "O", "P"]
    status_codes = np.where(all_f, 0, np.where(any_f, 2, 1))  # F / P / O

    tables["orders"] = TableData(
        "orders",
        Schema.of(Field("o_orderkey", BIGINT),
                  Field("o_custkey", BIGINT),
                  _dict_field("o_orderstatus", status_pool),
                  Field("o_totalprice", decimal(12, 2)),
                  Field("o_orderdate", DATE),
                  _dict_field("o_orderpriority", sorted(PRIORITIES)),
                  _dict_field("o_clerk", o_clerk_pool),
                  Field("o_shippriority", INTEGER),
                  _dict_field("o_comment", o_comment_pool)),
        [orderkey, o_custkey, status_codes.astype(np.int32), o_totalprice,
         o_orderdate,
         rng.integers(0, 5, n_ord).astype(np.int32),
         clerk_assign, np.zeros(n_ord, dtype=np.int32), o_comment_codes])

    for name, t in tables.items():
        t.primary_key = PRIMARY_KEYS[name]
    return tables
