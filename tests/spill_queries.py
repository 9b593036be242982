"""Queries of the memory-pressure tests, shared by the CPU tests
(tests/test_torch_spill.py), the card tests (tests/test_torch_cuda.py)
and chip_smoke.py's memory-pressure phase. JOIN_Q and AGG_Q are the texts
of tests/test_memory_pressure.py (this module imports nothing, so the
card machine can read it)."""

JOIN_Q = """
SELECT o_custkey, count(*) AS c, sum(o_totalprice) AS s
FROM orders JOIN customer ON o_custkey = c_custkey
WHERE c_acctbal > 0
GROUP BY o_custkey
ORDER BY s DESC, o_custkey LIMIT 50
"""

AGG_Q = """
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS q, count(*) AS c,
       min(l_discount) AS mn, max(l_tax) AS mx
FROM lineitem GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

# AGG_Q's sums and counts alone: K5 takes only sum/count over integer
# columns, so this is the four-group aggregate K5 runs under mxu_agg
SUMAGG_Q = """
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS q, count(*) AS c
FROM lineitem GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

# one group per order: the hash strategy (K3) on every partition
GROUP_Q = ("SELECT l_orderkey, sum(l_quantity) AS q FROM lineitem "
           "GROUP BY l_orderkey ORDER BY q DESC, l_orderkey LIMIT 20")

# GROUP_Q without its LIMIT: every group of the spilled aggregate is
# compared, not only the 20 largest
GROUP_ALL_Q = ("SELECT l_orderkey, sum(l_quantity) AS q FROM lineitem "
               "GROUP BY l_orderkey ORDER BY l_orderkey")

SORT_Q = ("SELECT l_orderkey, l_extendedprice FROM lineitem "
          "ORDER BY l_extendedprice DESC, l_orderkey LIMIT 100")
