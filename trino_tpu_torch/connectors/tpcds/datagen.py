"""Port copy of ``trino_tpu/connectors/tpcds/datagen.py`` (no edits: its
relative imports resolve to this package's ``batch``, ``types`` and
``connectors/tpch/datagen``).

Deterministic in-memory TPC-DS data generator.

Role of the reference's ``plugin/trino-tpcds`` connector (backed by the
Teradata tpcds row generators, TpcdsRecordSet): a deterministic benchmark
source needing no files. Schemas follow the TPC-DS specification's table
definitions (surrogate-key star schema: date_dim/item/customer/... dimension
tables around store_sales/catalog_sales/web_sales/store_returns facts);
value distributions are seeded-random rather than dsdgen-exact. Correctness
testing always runs the sqlite oracle on *this* generated data (the
H2QueryRunner pattern, SURVEY.md §4.4), so engine results are verified
end-to-end regardless of distribution fidelity.

Facts carry NULL foreign keys at ~4% (dsdgen also nulls fact FKs), so
benchmark queries exercise three-valued logic and join NULL semantics.

Decimals are scaled int64 at scale 2.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional

import numpy as np

from ...batch import Field, Schema
from ...types import BIGINT, DATE, INTEGER, VARCHAR, decimal
from ..tpch.datagen import TableData, _codes_for, _dict_field

D72 = decimal(7, 2)

EPOCH = datetime.date(1970, 1, 1)
FIRST_DATE = datetime.date(1998, 1, 1)
N_DAYS = 1826                       # 1998-01-01 .. 2002-12-31
FIRST_SK = 2450815                  # spec's julian-ish base for 1998-01-01

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES = ["accent", "archery", "arts", "athletic", "audio", "baseball",
           "basketball", "bathroom", "bedding", "birdal", "blinds",
           "camcorders", "camping", "classical", "computers", "country"]
BRAND_BASES = ["amalg", "edu pack", "exporti", "importo", "scholar",
               "brand", "corp", "maxi", "univ", "nameless"]
COLORS_DS = ["aquamarine", "azure", "beige", "black", "blue", "brown",
             "burlywood", "chartreuse", "chiffon", "coral", "cornflower",
             "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
             "firebrick", "floral", "forest", "frosted", "gainsboro",
             "ghost", "goldenrod", "green", "grey", "honeydew", "hot",
             "indian", "ivory", "khaki", "lace", "lavender"]
SIZES = ["N/A", "economy", "extra large", "large", "medium", "petite",
         "small"]
UNITS = sorted(["Bunch", "Bundle", "Box", "Carton", "Case", "Cup",
                "Dozen", "Each", "Gram", "Gross", "Lb", "N/A", "Ounce",
                "Oz", "Pallet", "Pound", "Tbl", "Ton", "Tsp",
                "Unknown"])
GENDERS = ["F", "M"]
MARITAL = ["D", "M", "S", "U", "W"]
EDUCATION = ["2 yr Degree", "4 yr Degree", "Advanced Degree", "College",
             "Primary", "Secondary", "Unknown"]
CREDIT = ["Good", "High Risk", "Low Risk", "Unknown"]
BUY_POTENTIAL = sorted(["0-500", "1001-5000", "501-1000", ">10000",
                        "5001-10000", "Unknown"])
STATES = ["AL", "CA", "GA", "IL", "KS", "KY", "LA", "MI", "MN", "MO",
          "NC", "NE", "NY", "OH", "OK", "SD", "TN", "TX", "VA", "WA"]
COUNTIES = ["Barrow County", "Bronx County", "Daviess County",
            "Fairfield County", "Franklin Parish", "Luce County",
            "Mobile County", "Oglethorpe County", "Richland County",
            "Walker County", "Williamson County", "Ziebach County"]
CITIES = ["Antioch", "Bethel", "Centerville", "Clinton", "Edgewood",
          "Fairview", "Five Points", "Friendship", "Georgetown",
          "Glendale", "Greenfield", "Liberty", "Midway", "Mount Olive",
          "Mount Zion", "Oak Grove", "Oak Ridge", "Oakland", "Pleasant "
          "Grove", "Pleasant Hill", "Riverside", "Salem", "Springdale",
          "Springfield", "Sulphur Springs", "Union", "Unionville",
          "Walnut Grove", "Wildwood", "Woodland", "Woodville"]
FIRST_NAMES = sorted(["James", "John", "Robert", "Michael", "William",
                      "David", "Mary", "Patricia", "Linda", "Barbara",
                      "Elizabeth", "Jennifer", "Maria", "Susan",
                      "Margaret", "Dorothy"])
LAST_NAMES = sorted(["Smith", "Johnson", "Williams", "Jones", "Brown",
                     "Davis", "Miller", "Wilson", "Moore", "Taylor",
                     "Anderson", "Thomas", "Jackson", "White", "Harris",
                     "Martin"])
WEEKDAYS = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday"]
DAY_NAMES = sorted(WEEKDAYS)
REASONS = ["Did not fit", "Did not like the color", "Did not like the "
           "model", "Found a better price", "Gift exchange", "Lost my job",
           "No service location", "Not working any more", "Package was "
           "damaged", "Parts missing", "Stopped working", "unknown"]
YN = ["N", "Y"]

PRIMARY_KEYS = {
    "date_dim": ("d_date_sk",),
    "time_dim": ("t_time_sk",),
    "item": ("i_item_sk",),
    "customer": ("c_customer_sk",),
    "customer_address": ("ca_address_sk",),
    "customer_demographics": ("cd_demo_sk",),
    "household_demographics": ("hd_demo_sk",),
    "store": ("s_store_sk",),
    "promotion": ("p_promo_sk",),
    "warehouse": ("w_warehouse_sk",),
    "reason": ("r_reason_sk",),
    "web_site": ("web_site_sk",),
    "call_center": ("cc_call_center_sk",),
    "catalog_page": ("cp_catalog_page_sk",),
    "web_page": ("wp_web_page_sk",),
    "income_band": ("ib_income_band_sk",),
    "ship_mode": ("sm_ship_mode_sk",),
    "store_sales": ("ss_item_sk", "ss_ticket_number"),
    "store_returns": ("sr_item_sk", "sr_ticket_number"),
    "catalog_sales": ("cs_item_sk", "cs_order_number"),
    "catalog_returns": ("cr_item_sk", "cr_order_number"),
    "web_sales": ("ws_item_sk", "ws_order_number"),
    "web_returns": ("wr_item_sk", "wr_order_number"),
    "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk"),
}

SHIP_MODE_TYPES = ["EXPRESS", "LIBRARY", "NEXT DAY", "OVERNIGHT",
                   "REGULAR", "TWO DAY"]
CARRIERS = sorted(["AIRBORNE", "ALLIANCE", "BARIAN", "BOXBUNDLES", "DHL",
                   "FEDEX", "GERMA", "GREAT EASTERN", "HARMSTORF", "LATVIAN",
                   "MSC", "ORIENTAL", "PRIVATECARRIER", "RUPEKSA", "TBS",
                   "UPS", "USPS", "ZHOU", "ZOUROS", "DIAMOND"])
SALUTATIONS = sorted(["Dr.", "Miss", "Mr.", "Mrs.", "Ms.", "Sir"])
COUNTRIES = sorted(["UNITED STATES", "CANADA", "MEXICO", "GERMANY",
                    "FRANCE", "JAPAN", "BRAZIL", "INDIA", "CHINA",
                    "AUSTRALIA", "ITALY", "SPAIN", "NIGERIA", "KENYA",
                    "EGYPT", "PERU"])


def _pick(rng, pool: List[str], n: int) -> np.ndarray:
    return rng.integers(0, len(pool), n).astype(np.int32)


def _id_strings(prefix: str, keys: np.ndarray):
    strings = [f"{prefix}{int(k):016d}" for k in keys]
    return np.arange(len(strings), dtype=np.int32), list(strings)


def generate(scale: float, seed: int = 19980101) -> Dict[str, TableData]:
    """scale 0.01 ('tiny'): ~120k store_sales rows; row counts scale
    linearly for facts, slower for dimensions (as in dsdgen)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, TableData] = {}

    def table(name, fields, columns, valids=None):
        pks = PRIMARY_KEYS.get(name, ())
        out[name] = TableData(name, Schema(tuple(fields)), columns,
                              primary_key=pks, valids=valids)

    # ---- date_dim -------------------------------------------------------
    n_dates = N_DAYS
    d_sk = FIRST_SK + np.arange(n_dates, dtype=np.int64)
    first_days = (FIRST_DATE - EPOCH).days
    d_date = first_days + np.arange(n_dates, dtype=np.int32)
    dates = [FIRST_DATE + datetime.timedelta(days=int(i))
             for i in range(n_dates)]
    d_year = np.array([d.year for d in dates], dtype=np.int32)
    d_moy = np.array([d.month for d in dates], dtype=np.int32)
    d_dom = np.array([d.day for d in dates], dtype=np.int32)
    d_qoy = (d_moy - 1) // 3 + 1
    d_dow = np.array([(d.weekday() + 1) % 7 for d in dates], dtype=np.int32)
    d_day_name = _codes_for([WEEKDAYS[int(w)] for w in d_dow],
                            DAY_NAMES)
    # spec-like sequences: d_week_seq continuous over weeks, d_month_seq
    # over months (q2/q59's 53-week self-joins, q6/q54's month windows)
    d_week_seq = ((d_date - int(d_date[0]) + int(d_dow[0])) // 7 +
                  5270).astype(np.int32)
    d_month_seq = ((d_year - 1998) * 12 + d_moy - 1 + 1176).astype(np.int32)
    table("date_dim",
          [Field("d_date_sk", BIGINT), Field("d_date", DATE),
           Field("d_year", INTEGER), Field("d_moy", INTEGER),
           Field("d_dom", INTEGER), Field("d_qoy", INTEGER),
           Field("d_dow", INTEGER), _dict_field("d_day_name", DAY_NAMES),
           Field("d_week_seq", INTEGER), Field("d_month_seq", INTEGER)],
          [d_sk, d_date, d_year, d_moy, d_dom, d_qoy, d_dow, d_day_name,
           d_week_seq, d_month_seq])

    # ---- time_dim -------------------------------------------------------
    n_times = 86400 // 60            # per-minute grain (spec is per-second)
    t_sk = np.arange(n_times, dtype=np.int64)
    t_hour = (t_sk // 60).astype(np.int32)
    t_minute = (t_sk % 60).astype(np.int32)
    table("time_dim",
          [Field("t_time_sk", BIGINT), Field("t_hour", INTEGER),
           Field("t_minute", INTEGER)],
          [t_sk, t_hour, t_minute])

    # ---- item -----------------------------------------------------------
    n_item = max(200, int(18000 * min(scale, 1.0) ** 0.5))
    i_sk = 1 + np.arange(n_item, dtype=np.int64)
    _, i_id_pool = _id_strings("AAAAAAAA", i_sk)
    i_id_codes = np.arange(n_item, dtype=np.int32)
    i_category_id = _pick(rng, CATEGORIES, n_item) + 1
    i_class_id = _pick(rng, CLASSES, n_item) + 1
    i_manufact_id = rng.integers(1, 1000, n_item).astype(np.int64)
    i_brand_id = (i_category_id.astype(np.int64) * 1000000 +
                  rng.integers(1, 10, n_item) * 1000 +
                  rng.integers(1, 100, n_item))
    brand_strings = [f"{BRAND_BASES[int(b) % 10]} #{int(b) % 1000}"
                     for b in i_brand_id]
    brand_pool = sorted(set(brand_strings))
    manufact_strings = [f"able{int(m):04d}" for m in i_manufact_id]
    manufact_pool = sorted(set(manufact_strings))
    i_current_price = rng.integers(10, 9900, n_item).astype(np.int64)
    i_manager_id = rng.integers(1, 101, n_item).astype(np.int64)
    i_wholesale_cost = rng.integers(5, 7000, n_item).astype(np.int64)
    # bounded pools for desc/product_name (dsdgen text, pool-capped like
    # the tpch comment columns)
    desc_pool = sorted({f"{COLORS_DS[a]} {COLORS_DS[b]} {CLASSES[c]}"
                        for a in range(len(COLORS_DS))
                        for b in range(0, len(COLORS_DS), 5)
                        for c in range(0, len(CLASSES), 3)})
    i_desc = rng.integers(0, len(desc_pool), n_item).astype(np.int32)
    prod_pool = sorted({f"{BRAND_BASES[a]}{BRAND_BASES[b]}"
                        for a in range(10) for b in range(10)})
    i_prod = rng.integers(0, len(prod_pool), n_item).astype(np.int32)
    table("item",
          [Field("i_item_sk", BIGINT),
           Field("i_item_id", VARCHAR, dictionary=tuple(i_id_pool)),
           _dict_field("i_category", CATEGORIES),
           Field("i_category_id", INTEGER),
           _dict_field("i_class", CLASSES), Field("i_class_id", INTEGER),
           Field("i_brand_id", BIGINT),
           Field("i_brand", VARCHAR, dictionary=tuple(brand_pool)),
           Field("i_manufact_id", BIGINT),
           Field("i_manufact", VARCHAR, dictionary=tuple(manufact_pool)),
           Field("i_current_price", D72),
           _dict_field("i_color", COLORS_DS), _dict_field("i_size", SIZES),
           _dict_field("i_units", UNITS), Field("i_manager_id", BIGINT),
           Field("i_wholesale_cost", D72),
           _dict_field("i_item_desc", desc_pool),
           _dict_field("i_product_name", prod_pool)],
          [i_sk, i_id_codes, i_category_id - 1, i_category_id,
           i_class_id - 1, i_class_id, i_brand_id,
           _codes_for(brand_strings, brand_pool), i_manufact_id,
           _codes_for(manufact_strings, manufact_pool), i_current_price,
           _pick(rng, COLORS_DS, n_item), _pick(rng, SIZES, n_item),
           _pick(rng, UNITS, n_item), i_manager_id,
           i_wholesale_cost, i_desc, i_prod])

    # ---- customer_demographics (cross product, spec: 1,920,800 rows;
    #      shrunk grid with same fields) --------------------------------
    grid = [(g, m, e, p, c, d1, d2, d3)
            for g in range(2) for m in range(5) for e in range(7)
            for p in (500, 1000, 5000, 10000) for c in range(4)
            for d1 in range(0, 4) for d2 in range(0, 2)
            for d3 in range(0, 2)]
    n_cd = len(grid)
    ga = np.array([g[0] for g in grid], dtype=np.int32)
    ma = np.array([g[1] for g in grid], dtype=np.int32)
    ea = np.array([g[2] for g in grid], dtype=np.int32)
    pa = np.array([g[3] for g in grid], dtype=np.int64)
    ca = np.array([g[4] for g in grid], dtype=np.int32)
    d1a = np.array([g[5] for g in grid], dtype=np.int64)
    d2a = np.array([g[6] for g in grid], dtype=np.int64)
    d3a = np.array([g[7] for g in grid], dtype=np.int64)
    table("customer_demographics",
          [Field("cd_demo_sk", BIGINT), _dict_field("cd_gender", GENDERS),
           _dict_field("cd_marital_status", MARITAL),
           _dict_field("cd_education_status", EDUCATION),
           Field("cd_purchase_estimate", BIGINT),
           _dict_field("cd_credit_rating", CREDIT),
           Field("cd_dep_count", BIGINT),
           Field("cd_dep_employed_count", BIGINT),
           Field("cd_dep_college_count", BIGINT)],
          [1 + np.arange(n_cd, dtype=np.int64), ga, ma, ea, pa, ca,
           d1a, d2a, d3a])

    # ---- household_demographics ----------------------------------------
    n_hd = 7200
    hd_sk = 1 + np.arange(n_hd, dtype=np.int64)
    table("household_demographics",
          [Field("hd_demo_sk", BIGINT), Field("hd_income_band_sk", BIGINT),
           _dict_field("hd_buy_potential", BUY_POTENTIAL),
           Field("hd_dep_count", BIGINT),
           Field("hd_vehicle_count", BIGINT)],
          [hd_sk, 1 + hd_sk % 20, _pick(rng, BUY_POTENTIAL, n_hd),
           (hd_sk % 10).astype(np.int64), (hd_sk % 5).astype(np.int64)])

    # ---- customer_address ----------------------------------------------
    n_ca = max(1000, int(50000 * min(scale, 1.0) ** 0.5))
    ca_sk = 1 + np.arange(n_ca, dtype=np.int64)
    _, ca_id_pool = _id_strings("AAAAAAAA", ca_sk)
    zips = 10000 + (rng.integers(0, 400, n_ca) * 171) % 90000
    zip_strings = [f"{int(z):05d}" for z in zips]
    zip_pool = sorted(set(zip_strings))
    table("customer_address",
          [Field("ca_address_sk", BIGINT),
           Field("ca_address_id", VARCHAR, dictionary=tuple(ca_id_pool)),
           _dict_field("ca_city", CITIES),
           _dict_field("ca_county", COUNTIES),
           _dict_field("ca_state", STATES),
           Field("ca_zip", VARCHAR, dictionary=tuple(zip_pool)),
           _dict_field("ca_country", ["United States"]),
           Field("ca_gmt_offset", decimal(5, 2))],
          [ca_sk, np.arange(n_ca, dtype=np.int32),
           _pick(rng, CITIES, n_ca), _pick(rng, COUNTIES, n_ca),
           _pick(rng, STATES, n_ca), _codes_for(zip_strings, zip_pool),
           np.zeros(n_ca, dtype=np.int32),
           -rng.integers(500, 801, n_ca).astype(np.int64)])

    # ---- customer -------------------------------------------------------
    n_cust = max(1000, int(100000 * min(scale, 1.0) ** 0.5))
    c_sk = 1 + np.arange(n_cust, dtype=np.int64)
    _, c_id_pool = _id_strings("AAAAAAAA", c_sk)
    table("customer",
          [Field("c_customer_sk", BIGINT),
           Field("c_customer_id", VARCHAR, dictionary=tuple(c_id_pool)),
           Field("c_current_cdemo_sk", BIGINT),
           Field("c_current_hdemo_sk", BIGINT),
           Field("c_current_addr_sk", BIGINT),
           _dict_field("c_first_name", FIRST_NAMES),
           _dict_field("c_last_name", LAST_NAMES),
           Field("c_birth_year", INTEGER),
           Field("c_birth_month", INTEGER),
           _dict_field("c_preferred_cust_flag", YN),
           _dict_field("c_salutation", SALUTATIONS),
           _dict_field("c_birth_country", COUNTRIES)],
          [c_sk, np.arange(n_cust, dtype=np.int32),
           rng.integers(1, n_cd + 1, n_cust).astype(np.int64),
           rng.integers(1, n_hd + 1, n_cust).astype(np.int64),
           rng.integers(1, n_ca + 1, n_cust).astype(np.int64),
           _pick(rng, FIRST_NAMES, n_cust), _pick(rng, LAST_NAMES, n_cust),
           rng.integers(1924, 1993, n_cust).astype(np.int32),
           rng.integers(1, 13, n_cust).astype(np.int32),
           _pick(rng, YN, n_cust), _pick(rng, SALUTATIONS, n_cust),
           _pick(rng, COUNTRIES, n_cust)])

    # ---- store ----------------------------------------------------------
    n_store = max(12, int(12 * max(scale, 0.01) ** 0.5 * 10))
    s_sk = 1 + np.arange(n_store, dtype=np.int64)
    _, s_id_pool = _id_strings("AAAAAAAA", s_sk)
    store_names = sorted(["ese", "ought", "able", "pri", "cally",
                          "ation", "eing", "bar", "anti", "cation"])
    table("store",
          [Field("s_store_sk", BIGINT),
           Field("s_store_id", VARCHAR, dictionary=tuple(s_id_pool)),
           _dict_field("s_store_name", store_names),
           Field("s_number_employees", INTEGER),
           Field("s_floor_space", INTEGER),
           _dict_field("s_city", CITIES), _dict_field("s_county", COUNTIES),
           _dict_field("s_state", STATES),
           Field("s_zip", VARCHAR, dictionary=tuple(zip_pool)),
           Field("s_market_id", INTEGER),
           Field("s_gmt_offset", decimal(5, 2))],
          [s_sk, np.arange(n_store, dtype=np.int32),
           _pick(rng, store_names, n_store),
           rng.integers(200, 300, n_store).astype(np.int32),
           rng.integers(5000000, 10000000, n_store).astype(np.int32),
           _pick(rng, CITIES, n_store), _pick(rng, COUNTIES, n_store),
           _pick(rng, STATES, n_store),
           rng.integers(0, len(zip_pool), n_store).astype(np.int32),
           rng.integers(1, 11, n_store).astype(np.int32),
           -rng.integers(500, 801, n_store).astype(np.int64)])

    # ---- promotion ------------------------------------------------------
    n_promo = max(300, int(300 * min(scale, 1.0) ** 0.5))
    p_sk = 1 + np.arange(n_promo, dtype=np.int64)
    _, p_id_pool = _id_strings("AAAAAAAA", p_sk)
    table("promotion",
          [Field("p_promo_sk", BIGINT),
           Field("p_promo_id", VARCHAR, dictionary=tuple(p_id_pool)),
           _dict_field("p_channel_dmail", YN),
           _dict_field("p_channel_email", YN),
           _dict_field("p_channel_tv", YN),
           _dict_field("p_channel_event", YN)],
          [p_sk, np.arange(n_promo, dtype=np.int32),
           _pick(rng, YN, n_promo), _pick(rng, YN, n_promo),
           _pick(rng, YN, n_promo), _pick(rng, YN, n_promo)])

    # ---- warehouse / reason / web_site ---------------------------------
    n_wh = 5
    wh_names = sorted(["Conventional childr", "Important issues liv",
                       "Doors canno", "Bad cards must make.",
                       "Rooms cook "])
    table("warehouse",
          [Field("w_warehouse_sk", BIGINT),
           _dict_field("w_warehouse_name", wh_names),
           Field("w_warehouse_sq_ft", INTEGER),
           _dict_field("w_state", STATES)],
          [1 + np.arange(n_wh, dtype=np.int64),
           np.arange(n_wh, dtype=np.int32),
           rng.integers(50000, 1000000, n_wh).astype(np.int32),
           _pick(rng, STATES, n_wh)])
    n_reason = len(REASONS)
    table("reason",
          [Field("r_reason_sk", BIGINT),
           _dict_field("r_reason_desc", REASONS)],
          [1 + np.arange(n_reason, dtype=np.int64),
           np.arange(n_reason, dtype=np.int32)])
    n_web = 30
    web_names = sorted(f"site_{i}" for i in range(n_web))
    table("web_site",
          [Field("web_site_sk", BIGINT),
           Field("web_name", VARCHAR, dictionary=tuple(web_names))],
          [1 + np.arange(n_web, dtype=np.int64),
           np.arange(n_web, dtype=np.int32)])

    # ---- call_center / catalog_page / web_page / income_band /
    #      ship_mode (the remaining spec dimensions) ---------------------
    n_cc = 6
    cc_names = sorted(["NY Metro", "Mid Atlantic", "North Midwest",
                       "Pacific Northwest", "California", "Hawaii/Alaska"])
    cc_mgrs = sorted(["Bob Belcher", "Felipe Perkins", "Mark Hightower",
                      "Larry Mccray", "Julius Durham", "Terry Askew"])
    table("call_center",
          [Field("cc_call_center_sk", BIGINT),
           _dict_field("cc_name", cc_names),
           _dict_field("cc_manager", cc_mgrs),
           _dict_field("cc_county", COUNTIES)],
          [1 + np.arange(n_cc, dtype=np.int64),
           np.arange(n_cc, dtype=np.int32),
           _pick(rng, cc_mgrs, n_cc), _pick(rng, COUNTIES, n_cc)])

    n_cp = max(100, int(11718 * min(scale, 1.0) ** 0.5))
    _, cp_id_pool = _id_strings("AAAAAAAA",
                                1 + np.arange(n_cp, dtype=np.int64))
    table("catalog_page",
          [Field("cp_catalog_page_sk", BIGINT),
           Field("cp_catalog_page_id", VARCHAR,
                 dictionary=tuple(cp_id_pool))],
          [1 + np.arange(n_cp, dtype=np.int64),
           np.arange(n_cp, dtype=np.int32)])

    n_wp = max(60, int(60 * min(scale, 1.0) ** 0.5))
    table("web_page",
          [Field("wp_web_page_sk", BIGINT),
           Field("wp_char_count", INTEGER)],
          [1 + np.arange(n_wp, dtype=np.int64),
           rng.integers(100, 8000, n_wp).astype(np.int32)])

    n_ib = 20
    ib_sk = 1 + np.arange(n_ib, dtype=np.int64)
    table("income_band",
          [Field("ib_income_band_sk", BIGINT),
           Field("ib_lower_bound", INTEGER),
           Field("ib_upper_bound", INTEGER)],
          [ib_sk, ((ib_sk - 1) * 10000).astype(np.int32),
           (ib_sk * 10000).astype(np.int32)])

    n_sm = 20
    sm_types = [SHIP_MODE_TYPES[i % len(SHIP_MODE_TYPES)]
                for i in range(n_sm)]
    sm_codes = sorted(["AIR", "SURFACE", "SEA"])
    table("ship_mode",
          [Field("sm_ship_mode_sk", BIGINT),
           _dict_field("sm_type", sorted(SHIP_MODE_TYPES)),
           _dict_field("sm_code", sm_codes),
           _dict_field("sm_carrier", CARRIERS)],
          [1 + np.arange(n_sm, dtype=np.int64),
           _codes_for(sm_types, sorted(SHIP_MODE_TYPES)),
           _pick(rng, sm_codes, n_sm),
           np.arange(n_sm, dtype=np.int32)])

    # ---- fact helper ----------------------------------------------------
    def fk(n, hi, null_frac=0.04):
        vals = rng.integers(1, hi + 1, n).astype(np.int64)
        valid = rng.random(n) >= null_frac
        return vals, valid

    def money(n, lo, hi):
        return rng.integers(lo, hi, n).astype(np.int64)

    # ---- store_sales ----------------------------------------------------
    n_ss = max(1000, int(12_000_000 * scale))   # linear in scale (dsdgen)
    n_tickets = max(1, n_ss // 12)
    ss_ticket = rng.integers(1, n_tickets + 1, n_ss).astype(np.int64)
    ss_sold_date = FIRST_SK + rng.integers(0, n_dates, n_ss).astype(
        np.int64)
    ss_date_v = rng.random(n_ss) >= 0.04
    ss_item = rng.integers(1, n_item + 1, n_ss).astype(np.int64)
    ss_cust, ss_cust_v = fk(n_ss, n_cust)
    ss_cdemo, ss_cdemo_v = fk(n_ss, n_cd)
    ss_hdemo, ss_hdemo_v = fk(n_ss, n_hd)
    ss_addr, ss_addr_v = fk(n_ss, n_ca)
    ss_store, ss_store_v = fk(n_ss, n_store)
    ss_promo, ss_promo_v = fk(n_ss, n_promo)
    ss_time = rng.integers(0, n_times, n_ss).astype(np.int64)
    ss_qty = rng.integers(1, 101, n_ss).astype(np.int64)
    ss_wholesale = money(n_ss, 100, 10000)
    ss_list = (ss_wholesale * (100 + rng.integers(0, 100, n_ss)) //
               100).astype(np.int64)
    ss_sales_price = (ss_list * rng.integers(20, 101, n_ss) //
                      100).astype(np.int64)
    ss_ext_sales = ss_sales_price * ss_qty
    ss_ext_list = ss_list * ss_qty
    ss_ext_wholesale = ss_wholesale * ss_qty
    ss_ext_discount = ss_ext_list - ss_ext_sales
    ss_ext_tax = ss_ext_sales * rng.integers(0, 9, n_ss) // 100
    ss_coupon = np.where(rng.random(n_ss) < 0.1,
                         ss_ext_sales * rng.integers(0, 50, n_ss) // 100,
                         0).astype(np.int64)
    ss_net_paid = ss_ext_sales - ss_coupon
    ss_net_paid_tax = ss_net_paid + ss_ext_tax
    ss_net_profit = ss_net_paid - ss_ext_wholesale
    table("store_sales",
          [Field("ss_sold_date_sk", BIGINT),
           Field("ss_sold_time_sk", BIGINT),
           Field("ss_item_sk", BIGINT), Field("ss_customer_sk", BIGINT),
           Field("ss_cdemo_sk", BIGINT), Field("ss_hdemo_sk", BIGINT),
           Field("ss_addr_sk", BIGINT), Field("ss_store_sk", BIGINT),
           Field("ss_promo_sk", BIGINT), Field("ss_ticket_number", BIGINT),
           Field("ss_quantity", BIGINT), Field("ss_wholesale_cost", D72),
           Field("ss_list_price", D72), Field("ss_sales_price", D72),
           Field("ss_ext_discount_amt", D72),
           Field("ss_ext_sales_price", D72),
           Field("ss_ext_wholesale_cost", D72),
           Field("ss_ext_list_price", D72), Field("ss_ext_tax", D72),
           Field("ss_coupon_amt", D72), Field("ss_net_paid", D72),
           Field("ss_net_paid_inc_tax", D72), Field("ss_net_profit", D72)],
          [ss_sold_date, ss_time, ss_item, ss_cust, ss_cdemo, ss_hdemo,
           ss_addr, ss_store, ss_promo, ss_ticket, ss_qty, ss_wholesale,
           ss_list, ss_sales_price, ss_ext_discount, ss_ext_sales,
           ss_ext_wholesale, ss_ext_list, ss_ext_tax, ss_coupon,
           ss_net_paid, ss_net_paid_tax, ss_net_profit],
          valids=[ss_date_v, None, None, ss_cust_v, ss_cdemo_v, ss_hdemo_v,
                  ss_addr_v, ss_store_v, ss_promo_v] + [None] * 14)

    # ---- store_returns (~10% of sales get returned) --------------------
    n_sr = n_ss // 10
    ridx = rng.choice(n_ss, n_sr, replace=False)
    sr_item = ss_item[ridx]
    sr_ticket = ss_ticket[ridx]
    sr_returned_date = np.minimum(ss_sold_date[ridx] +
                                  rng.integers(1, 60, n_sr),
                                  FIRST_SK + n_dates - 1).astype(np.int64)
    sr_cust = ss_cust[ridx]
    sr_cust_v = ss_cust_v[ridx]
    sr_store = ss_store[ridx]
    sr_store_v = ss_store_v[ridx]
    sr_reason, sr_reason_v = fk(n_sr, n_reason)
    sr_qty = np.maximum(1, ss_qty[ridx] // 2).astype(np.int64)
    sr_amt = ss_sales_price[ridx] * sr_qty
    sr_net_loss = sr_amt // 10 + money(n_sr, 50, 1000)
    table("store_returns",
          [Field("sr_returned_date_sk", BIGINT),
           Field("sr_item_sk", BIGINT), Field("sr_customer_sk", BIGINT),
           Field("sr_store_sk", BIGINT), Field("sr_reason_sk", BIGINT),
           Field("sr_ticket_number", BIGINT),
           Field("sr_return_quantity", BIGINT),
           Field("sr_return_amt", D72), Field("sr_net_loss", D72)],
          [sr_returned_date, sr_item, sr_cust, sr_store, sr_reason,
           sr_ticket, sr_qty, sr_amt, sr_net_loss],
          valids=[None, None, sr_cust_v, sr_store_v, sr_reason_v,
                  None, None, None, None])

    # ---- catalog_sales --------------------------------------------------
    n_cs = n_ss // 2
    cs_order = rng.integers(1, max(2, n_cs // 8), n_cs).astype(np.int64)
    cs_sold_date = FIRST_SK + rng.integers(0, n_dates, n_cs).astype(
        np.int64)
    cs_date_v = rng.random(n_cs) >= 0.04
    cs_ship_date = np.minimum(cs_sold_date + rng.integers(2, 90, n_cs),
                              FIRST_SK + n_dates - 1).astype(np.int64)
    cs_item = rng.integers(1, n_item + 1, n_cs).astype(np.int64)
    cs_cust, cs_cust_v = fk(n_cs, n_cust)
    cs_cdemo, cs_cdemo_v = fk(n_cs, n_cd)
    cs_hdemo, cs_hdemo_v = fk(n_cs, n_hd)
    cs_addr, cs_addr_v = fk(n_cs, n_ca)
    cs_wh, cs_wh_v = fk(n_cs, n_wh)
    cs_promo, cs_promo_v = fk(n_cs, n_promo)
    cs_qty = rng.integers(1, 101, n_cs).astype(np.int64)
    cs_wholesale = money(n_cs, 100, 10000)
    cs_list = (cs_wholesale * (100 + rng.integers(0, 100, n_cs)) //
               100).astype(np.int64)
    cs_sales_price = (cs_list * rng.integers(20, 101, n_cs) //
                      100).astype(np.int64)
    cs_ext_sales = cs_sales_price * cs_qty
    cs_ext_discount = (cs_list - cs_sales_price) * cs_qty
    cs_net_paid = cs_ext_sales
    cs_net_profit = cs_net_paid - cs_wholesale * cs_qty
    cs_cc, cs_cc_v = fk(n_cs, n_cc)
    cs_cp, cs_cp_v = fk(n_cs, n_cp)
    cs_sm, cs_sm_v = fk(n_cs, n_sm)
    cs_ship_cust, cs_ship_cust_v = fk(n_cs, n_cust)
    cs_ship_addr, cs_ship_addr_v = fk(n_cs, n_ca)
    cs_ext_list = cs_list * cs_qty
    cs_ext_wholesale = cs_wholesale * cs_qty
    cs_ext_tax = cs_ext_sales * rng.integers(0, 9, n_cs) // 100
    cs_coupon = np.where(rng.random(n_cs) < 0.1,
                         cs_ext_sales * rng.integers(0, 50, n_cs) // 100,
                         0).astype(np.int64)
    cs_ext_ship = money(n_cs, 0, 5000) * cs_qty // 10
    cs_net_paid_tax = cs_net_paid + cs_ext_tax
    table("catalog_sales",
          [Field("cs_sold_date_sk", BIGINT),
           Field("cs_ship_date_sk", BIGINT), Field("cs_item_sk", BIGINT),
           Field("cs_bill_customer_sk", BIGINT),
           Field("cs_bill_cdemo_sk", BIGINT),
           Field("cs_bill_hdemo_sk", BIGINT),
           Field("cs_bill_addr_sk", BIGINT),
           Field("cs_warehouse_sk", BIGINT), Field("cs_promo_sk", BIGINT),
           Field("cs_order_number", BIGINT), Field("cs_quantity", BIGINT),
           Field("cs_wholesale_cost", D72), Field("cs_list_price", D72),
           Field("cs_sales_price", D72), Field("cs_ext_discount_amt", D72),
           Field("cs_ext_sales_price", D72), Field("cs_net_paid", D72),
           Field("cs_net_profit", D72),
           Field("cs_call_center_sk", BIGINT),
           Field("cs_catalog_page_sk", BIGINT),
           Field("cs_ship_mode_sk", BIGINT),
           Field("cs_ship_customer_sk", BIGINT),
           Field("cs_ship_addr_sk", BIGINT),
           Field("cs_ext_list_price", D72),
           Field("cs_ext_wholesale_cost", D72),
           Field("cs_ext_tax", D72), Field("cs_coupon_amt", D72),
           Field("cs_ext_ship_cost", D72),
           Field("cs_net_paid_inc_tax", D72)],
          [cs_sold_date, cs_ship_date, cs_item, cs_cust, cs_cdemo,
           cs_hdemo, cs_addr, cs_wh, cs_promo, cs_order, cs_qty,
           cs_wholesale, cs_list, cs_sales_price, cs_ext_discount,
           cs_ext_sales, cs_net_paid, cs_net_profit,
           cs_cc, cs_cp, cs_sm, cs_ship_cust, cs_ship_addr, cs_ext_list,
           cs_ext_wholesale, cs_ext_tax, cs_coupon, cs_ext_ship,
           cs_net_paid_tax],
          valids=[cs_date_v, None, None, cs_cust_v, cs_cdemo_v, cs_hdemo_v,
                  cs_addr_v, cs_wh_v, cs_promo_v] + [None] * 9 +
                 [cs_cc_v, cs_cp_v, cs_sm_v, cs_ship_cust_v,
                  cs_ship_addr_v] + [None] * 6)

    # ---- catalog_returns (~10% of catalog sales) -----------------------
    n_cr = n_cs // 10
    cridx = rng.choice(n_cs, n_cr, replace=False)
    cr_returned_date = np.minimum(cs_sold_date[cridx] +
                                  rng.integers(1, 60, n_cr),
                                  FIRST_SK + n_dates - 1).astype(np.int64)
    cr_qty = np.maximum(1, cs_qty[cridx] // 2).astype(np.int64)
    cr_amt = cs_sales_price[cridx] * cr_qty
    cr_reason, cr_reason_v = fk(n_cr, n_reason)
    table("catalog_returns",
          [Field("cr_returned_date_sk", BIGINT),
           Field("cr_item_sk", BIGINT), Field("cr_order_number", BIGINT),
           Field("cr_returning_customer_sk", BIGINT),
           Field("cr_returning_addr_sk", BIGINT),
           Field("cr_call_center_sk", BIGINT),
           Field("cr_catalog_page_sk", BIGINT),
           Field("cr_warehouse_sk", BIGINT),
           Field("cr_reason_sk", BIGINT),
           Field("cr_return_quantity", BIGINT),
           Field("cr_return_amount", D72),
           Field("cr_return_amt_inc_tax", D72),
           Field("cr_refunded_cash", D72),
           Field("cr_net_loss", D72)],
          [cr_returned_date, cs_item[cridx], cs_order[cridx],
           cs_cust[cridx], cs_addr[cridx], cs_cc[cridx], cs_cp[cridx],
           cs_wh[cridx], cr_reason, cr_qty, cr_amt,
           cr_amt + cr_amt * 8 // 100,
           cr_amt * rng.integers(50, 101, n_cr) // 100,
           cr_amt // 10 + money(n_cr, 50, 1000)],
          valids=[None, None, None, cs_cust_v[cridx], cs_addr_v[cridx],
                  cs_cc_v[cridx], cs_cp_v[cridx], cs_wh_v[cridx],
                  cr_reason_v] + [None] * 5)

    # ---- web_sales ------------------------------------------------------
    n_ws = n_ss // 4
    ws_order = rng.integers(1, max(2, n_ws // 8), n_ws).astype(np.int64)
    ws_sold_date = FIRST_SK + rng.integers(0, n_dates, n_ws).astype(
        np.int64)
    ws_date_v = rng.random(n_ws) >= 0.04
    ws_item = rng.integers(1, n_item + 1, n_ws).astype(np.int64)
    ws_cust, ws_cust_v = fk(n_ws, n_cust)
    ws_addr, ws_addr_v = fk(n_ws, n_ca)
    ws_site, ws_site_v = fk(n_ws, n_web)
    ws_promo, ws_promo_v = fk(n_ws, n_promo)
    ws_qty = rng.integers(1, 101, n_ws).astype(np.int64)
    ws_wholesale = money(n_ws, 100, 10000)
    ws_list = (ws_wholesale * (100 + rng.integers(0, 100, n_ws)) //
               100).astype(np.int64)
    ws_sales_price = (ws_list * rng.integers(20, 101, n_ws) //
                      100).astype(np.int64)
    ws_ext_sales = ws_sales_price * ws_qty
    ws_net_paid = ws_ext_sales
    ws_net_profit = ws_net_paid - ws_wholesale * ws_qty
    ws_ship_date = np.minimum(ws_sold_date + rng.integers(2, 90, n_ws),
                              FIRST_SK + n_dates - 1).astype(np.int64)
    ws_time = rng.integers(0, n_times, n_ws).astype(np.int64)
    ws_wh, ws_wh_v = fk(n_ws, n_wh)
    ws_sm, ws_sm_v = fk(n_ws, n_sm)
    ws_wp, ws_wp_v = fk(n_ws, n_wp)
    ws_ship_cust, ws_ship_cust_v = fk(n_ws, n_cust)
    ws_ship_addr, ws_ship_addr_v = fk(n_ws, n_ca)
    ws_ship_hd, ws_ship_hd_v = fk(n_ws, n_hd)
    ws_ext_list = ws_list * ws_qty
    ws_ext_wholesale = ws_wholesale * ws_qty
    ws_ext_discount = ws_ext_list - ws_ext_sales
    ws_ext_tax = ws_ext_sales * rng.integers(0, 9, n_ws) // 100
    ws_coupon = np.where(rng.random(n_ws) < 0.1,
                         ws_ext_sales * rng.integers(0, 50, n_ws) // 100,
                         0).astype(np.int64)
    ws_ext_ship = money(n_ws, 0, 5000) * ws_qty // 10
    ws_net_paid_tax = ws_net_paid + ws_ext_tax
    table("web_sales",
          [Field("ws_sold_date_sk", BIGINT), Field("ws_item_sk", BIGINT),
           Field("ws_bill_customer_sk", BIGINT),
           Field("ws_bill_addr_sk", BIGINT),
           Field("ws_web_site_sk", BIGINT), Field("ws_promo_sk", BIGINT),
           Field("ws_order_number", BIGINT), Field("ws_quantity", BIGINT),
           Field("ws_sales_price", D72), Field("ws_ext_sales_price", D72),
           Field("ws_net_paid", D72), Field("ws_net_profit", D72),
           Field("ws_ship_date_sk", BIGINT),
           Field("ws_sold_time_sk", BIGINT),
           Field("ws_warehouse_sk", BIGINT),
           Field("ws_ship_mode_sk", BIGINT),
           Field("ws_web_page_sk", BIGINT),
           Field("ws_ship_customer_sk", BIGINT),
           Field("ws_ship_addr_sk", BIGINT),
           Field("ws_ship_hdemo_sk", BIGINT),
           Field("ws_wholesale_cost", D72), Field("ws_list_price", D72),
           Field("ws_ext_list_price", D72),
           Field("ws_ext_wholesale_cost", D72),
           Field("ws_ext_discount_amt", D72), Field("ws_ext_tax", D72),
           Field("ws_coupon_amt", D72), Field("ws_ext_ship_cost", D72),
           Field("ws_net_paid_inc_tax", D72)],
          [ws_sold_date, ws_item, ws_cust, ws_addr, ws_site, ws_promo,
           ws_order, ws_qty, ws_sales_price, ws_ext_sales, ws_net_paid,
           ws_net_profit,
           ws_ship_date, ws_time, ws_wh, ws_sm, ws_wp, ws_ship_cust,
           ws_ship_addr, ws_ship_hd, ws_wholesale, ws_list, ws_ext_list,
           ws_ext_wholesale, ws_ext_discount, ws_ext_tax, ws_coupon,
           ws_ext_ship, ws_net_paid_tax],
          valids=[ws_date_v, None, ws_cust_v, ws_addr_v, ws_site_v,
                  ws_promo_v] + [None] * 6 +
                 [None, None, ws_wh_v, ws_sm_v, ws_wp_v, ws_ship_cust_v,
                  ws_ship_addr_v, ws_ship_hd_v] + [None] * 9)

    # ---- web_returns (~10% of web sales) -------------------------------
    n_wr = n_ws // 10
    wridx = rng.choice(n_ws, n_wr, replace=False)
    wr_returned_date = np.minimum(ws_sold_date[wridx] +
                                  rng.integers(1, 60, n_wr),
                                  FIRST_SK + n_dates - 1).astype(np.int64)
    wr_qty = np.maximum(1, ws_qty[wridx] // 2).astype(np.int64)
    wr_amt = ws_sales_price[wridx] * wr_qty
    wr_reason, wr_reason_v = fk(n_wr, n_reason)
    table("web_returns",
          [Field("wr_returned_date_sk", BIGINT),
           Field("wr_item_sk", BIGINT), Field("wr_order_number", BIGINT),
           Field("wr_returning_customer_sk", BIGINT),
           Field("wr_returning_addr_sk", BIGINT),
           Field("wr_refunded_customer_sk", BIGINT),
           Field("wr_web_page_sk", BIGINT),
           Field("wr_reason_sk", BIGINT),
           Field("wr_return_quantity", BIGINT),
           Field("wr_return_amt", D72),
           Field("wr_refunded_cash", D72),
           Field("wr_net_loss", D72)],
          [wr_returned_date, ws_item[wridx], ws_order[wridx],
           ws_cust[wridx], ws_addr[wridx], ws_cust[wridx], ws_wp[wridx],
           wr_reason, wr_qty, wr_amt,
           wr_amt * rng.integers(50, 101, n_wr) // 100,
           wr_amt // 10 + money(n_wr, 50, 1000)],
          valids=[None, None, None, ws_cust_v[wridx], ws_addr_v[wridx],
                  ws_cust_v[wridx], ws_wp_v[wridx], wr_reason_v] +
                 [None] * 4)

    # ---- inventory ------------------------------------------------------
    # weekly grain: every ~7th date x item sample x warehouse
    inv_dates = d_sk[::7]
    n_inv_items = min(n_item, 400)
    inv_d, inv_i, inv_w = np.meshgrid(
        inv_dates, i_sk[:n_inv_items], 1 + np.arange(n_wh, dtype=np.int64),
        indexing="ij")
    inv_d = inv_d.ravel()
    inv_i = inv_i.ravel()
    inv_w = inv_w.ravel()
    inv_qty = rng.integers(0, 1000, inv_d.shape[0]).astype(np.int64)
    table("inventory",
          [Field("inv_date_sk", BIGINT), Field("inv_item_sk", BIGINT),
           Field("inv_warehouse_sk", BIGINT),
           Field("inv_quantity_on_hand", BIGINT)],
          [inv_d, inv_i, inv_w, inv_qty])

    return out
