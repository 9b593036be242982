"""approx_distinct and TIMESTAMP statements shared by the port's CPU
tests (tests/test_torch_hll.py, tests/test_torch_timestamp.py), its
card tests and `chip_smoke.py`. Plain Python: no torch, no JAX."""

import datetime

# approx_distinct over lineitem; `hll_sql` spells each as the estimate
# or as the exact count it estimates
HLL_QUERIES = (
    "SELECT AGG(l_orderkey) FROM lineitem",
    "SELECT l_returnflag, AGG(l_orderkey) FROM lineitem "
    "GROUP BY l_returnflag ORDER BY l_returnflag",
    "SELECT l_shipmode, AGG(l_extendedprice) FROM lineitem "
    "GROUP BY l_shipmode ORDER BY l_shipmode",
    "SELECT AGG(CAST(l_extendedprice AS double)) FROM lineitem",
)
# the reference's standard error (Trino's default for approx_distinct):
# a standard error, not a bound — of the twelve estimates above at
# tpch.tiny one lies 1.4 of them off — so checks allow three
HLL_STD_ERR = 0.023
HLL_SIGMAS = 3

# micros of one day; a row's seeded time of day, and every first line
# of an order moved back 10,958 days (to 1962-1968)
DAY_US = 86_400_000_000
TS_SEED = 104_729
TS_SHIFT_US = 10_958 * DAY_US


def hll_sql(template, exact=False):
    return template.replace(
        "AGG(", "count(DISTINCT " if exact else "approx_distinct(")


def hll_close(got, want):
    """Within HLL_SIGMAS standard errors of the exact count, with the
    reference's absolute floor of 5 for small counts."""
    return abs(got - want) <= max(HLL_SIGMAS * HLL_STD_ERR * want, 5)


def ts_literal_micros(rng, n=24):
    """Micros since the epoch for the literal rows: day boundaries on
    both sides of 1970 and seeded instants from 1900 to 2100."""
    edges = [0, -1, 1, DAY_US - 1, DAY_US, -DAY_US, -DAY_US - 1,
             -DAY_US + 1, -2_208_988_800_000_000, 4_102_444_800_000_000]
    drawn = rng.integers(-2_208_988_800_000_000, 4_102_444_800_000_000,
                         n - len(edges))
    return edges + [int(x) for x in drawn]


def ts_literal(micros):
    t = datetime.datetime(1970, 1, 1) + \
        datetime.timedelta(microseconds=micros)
    return t.strftime("%Y-%m-%d %H:%M:%S.%f")


def ts_setup(schema, rng):
    """The statements that build memory.ts.events over
    tpch.<schema>.lineitem: a CTAS of every line's ship date plus a
    seeded time of day, then literal rows (negative keys)."""
    ctas = (
        "CREATE TABLE memory.ts.events AS SELECT l_orderkey AS k, "
        "l_linenumber AS n, l_shipdate AS d, CAST(CAST(CAST(l_shipdate "
        "AS timestamp) AS bigint) + (l_orderkey * 2654435761 + "
        f"l_linenumber * {TS_SEED}) % {DAY_US} - CASE WHEN "
        f"l_linenumber = 1 THEN {TS_SHIFT_US} ELSE 0 END AS timestamp) "
        f"AS at FROM tpch.{schema}.lineitem")
    rows = []
    for i, m in enumerate(ts_literal_micros(rng)):
        day = datetime.date(1970, 1, 1) + \
            datetime.timedelta(days=m // DAY_US)
        rows.append(f"(-{i + 1}, 0, DATE '{day.isoformat()}', "
                    f"TIMESTAMP '{ts_literal(m)}')")
    return [ctas, "INSERT INTO memory.ts.events VALUES " + ", ".join(rows)]


_FIELDS = ("YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND")
_DAY_TRUNCS = ("year", "quarter", "month", "week", "day")
_TIME_TRUNCS = ("hour", "minute", "second")

# every statement over memory.ts.events; the table's size does not
# matter to them (they aggregate, or read the literal rows only)
TS_QUERIES = (
    # the literal rows whole
    "SELECT k, at, " + ", ".join(f"EXTRACT({f} FROM at)" for f in _FIELDS)
    + ", CAST(at AS date), "
    + ", ".join(f"date_trunc('{u}', at)" for u in _DAY_TRUNCS + _TIME_TRUNCS)
    + " FROM memory.ts.events WHERE k < 0 ORDER BY k",
    # each field and each truncation over every row, by year
    "SELECT EXTRACT(YEAR FROM at) AS y, count(*), "
    + ", ".join(f"sum(EXTRACT({f} FROM at))" for f in _FIELDS[1:])
    + ", sum(CAST(CAST(at AS date) AS bigint)), "
    + ", ".join(f"sum(CAST(CAST(date_trunc('{u}', at) AS date) AS bigint))"
                for u in _DAY_TRUNCS) + ", "
    + ", ".join(f"sum(CAST(at AS bigint) - "
                f"CAST(date_trunc('{u}', at) AS bigint))"
                for u in _TIME_TRUNCS)
    + " FROM memory.ts.events GROUP BY EXTRACT(YEAR FROM at) ORDER BY y",
    # grouped min/max
    "SELECT n, min(at), max(at), count(*) FROM memory.ts.events "
    "GROUP BY n ORDER BY n",
    # comparisons against a DATE
    "SELECT count(*), sum(CASE WHEN at > d THEN 1 ELSE 0 END), "
    "sum(CASE WHEN at < DATE '1970-01-01' THEN 1 ELSE 0 END), "
    "sum(CASE WHEN at >= DATE '1995-06-17' THEN 1 ELSE 0 END), "
    "sum(CASE WHEN CAST(at AS date) = d THEN 1 ELSE 0 END) "
    "FROM memory.ts.events",
    "SELECT k, n, at FROM memory.ts.events "
    "WHERE at BETWEEN TIMESTAMP '1969-12-31 23:59:59' "
    "AND DATE '1970-01-02' ORDER BY k, n",
)

# literals the reference refuses: the port refuses them the same way
TS_BAD_LITERALS = ("1969-02-30 00:00:00", "1969-12-31 24:00:00",
                   "1969-12-31T23:00:00x")
