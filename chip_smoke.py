"""On-card smoke test of the PyTorch/CUDA port (trino_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit:

1. card and toolchain: `nvidia-smi` name and power limit, torch/CUDA
   versions, and the build of every kernel from ``trino_tpu_torch/csrc``
   (one nvcc per source, all started together);
2. K1 (gather) against its plain torch version on the card, bit-exact
   (five lane types in one launch, misses and wild indices, an 8M-entry
   int32 LUT, and a star's 18 tables in one launch); K2
   (windowed gather) against its plain version, words and escape totals
   bit-exact: q12's shape (1,048,576 near-sorted indices into an
   8,388,609-entry int8 LUT, no escapes), random indices (escapes), each
   word dtype, misses and out-of-range indices, a LUT shorter than two
   windows;
3. K3 (hash insert) against its plain version on the card: multiset of
   groups exact, a forced overflow escapes, join-build duplicates counted
   exactly, and the hash-join probe equal; the multi-table entry with 16
   tables in one launch (one forced over its cap, the others equal to
   the plain version table by table), and a star's four builds in one
   launch (a duplicated and an over-cap dimension) equal to four single
   builds;
4. K4 (multiway star probe) against its plain version on a synthetic star
   (4M fact rows, 4 dimensions at 65,536 slots, hits, misses, NULL keys,
   dead rows and a chain longer than MAX_PROBES), `found` and `miss`
   bit-exact, through the slot-plane entry and the keys-in entry (on the
   interleaved table, and on two planes that the wrapper interleaves);
5. K5 (a whole direct aggregate in one launch) against its plain
   version, every output column bit-exact: q12's shape (32,768 rows, an
   int32 key over 7 groups, two sums), the full-width shape (6,001,215
   rows, 16 groups, eight int64 sums near +-2^58 with NULLs), and G = 1
   to 16 over every key dtype and aggregate mix; its summing
   part also against `index_add_`;
6. the main paths, each with every launch counter set to 0 just before
   and read just after: ``Session()`` on cuda over ``tpch.sf1`` runs
   TPC-H q1, q6 and q3 (one cold run, three steady; K1 and K3 must
   launch); over ``tpcds.sf1`` the star queries q3, q7, q19 and q96 (one
   cold, three steady; every run through a fused `multiway[k>=2]` with K4
   launches; q3, q7, q96 against a numpy oracle; one EXPLAIN ANALYZE of
   q7; after the counts are read, all four against the same query on the
   pairwise ladder); and TPC-H q12 at ``tpch.sf1`` under
   ``mxu_agg = 'true'`` (K5 launches, rows equal the oracle and the
   `false` run; under `auto` K5 must not launch); and the chunked driver
   under ``SET SESSION spill_chunk_rows = 1048576``: TPC-H q1, q6, q12 and
   q3 at ``tpch.sf1`` (lineitem in 6 chunks, four runs each: the first
   plain and recording, the later ones adapted — q12's packed orders join
   through K2 once per chunk, fused, from the fact cache, with no window
   rerun; q3 through K3), TPC-DS q7 at ``tpcds.sf1`` (store_sales in 12
   chunks, K4 once per chunk), each beside its unchunked wall, and one
   join whose Scan build streams (``stream_build_min_kb = 1``); after the
   counts are read, one more steady run of chunked q12 and q3 each under
   cProfile (where their host time goes); after every path, one more
   steady run of TPC-H q3 and TPC-DS q3 and q19 each under torch.profiler
   (the card's busy time, its idle share of the wall, the torch
   elementwise kernels, the device-to-host copies, the top kernels);
   and, before those profiles, the corpus paths, each with the counters
   set to 0 just before and read just after, one cold and three steady
   runs: TPC-H q4 (a dense-LUT semi join: K1 must launch), q21 (semi and
   anti joins with the `<>` residual through ``join_mark``) and q22 (an
   anti join and a scalar subquery) at ``tpch.sf1`` against numpy
   oracles; TPC-DS q12 (a window sum) and q38 (INTERSECT) at
   ``tpcds.sf1`` against numpy oracles, q86 (ROLLUP and rank) against the
   port's ``Session(device="cpu")`` over the same tables; the strategy
   each semi/anti/mark join ran (a dense-LUT or hash one without K1, or
   a hash one without K3, fails the run); then a host cProfile of q21
   and q22 and a torch.profiler run of q21 and ds q38;
   ``cumsum_like_reference`` on 6,000,000 doubles on the card, bit for
   bit its CPU result, timed against ``torch.cumsum``; and one UNNEST on
   the card against the CPU's rows; then the whole corpus
   (``phase_corpus_card``): every generated table of ``tpch.sf1`` and
   ``tpcds.sf1`` against the reference's digests in
   ``tests/torch_corpus_sf1.json``, then all 22 TPC-H and 99 TPC-DS
   queries, each with the counters set to 0 just before and read just
   after, twice under ``auto`` and once with every kernel forced on, each
   run's canonical rows (``tests/torch_corpus.py``) equal to the
   reference's (for the five queries the reference did not answer at
   sf1, to the port CPU Session's answer kept in the file), and TPC-H
   q12 chunked twice (K2); each of K1-K5 must launch, and a difference
   is printed beside the port CPU Session's rows before the run fails;
   then the write path, in a Session of
   its own over the same catalog, counters set to 0 just before and read
   just after: CREATE TABLE AS SELECT of lineitem, orders and customer
   at ``tpch.sf1`` into ``memory.sf1``, DELETE (~1/7 of lineitem), UPDATE
   (~1/4: a decimal and a VARCHAR column, with a value new to the pool),
   INSERT ... SELECT (~1/10 back) and a MERGE INTO orders (~10% matched,
   ~3% new keys), each reporting the row count of a numpy replica that
   applies the same mutation; after the CTAS and the MERGE (whose state
   holds the DELETE, the UPDATE and the INSERT) the stored tables
   equal their replicas, TPC-H q1, q6 and q3 over the memory tables
   equal the numpy oracles over the replicas (one cold, two steady
   runs), q12 under ``mxu_agg = 'true'`` (K5) equals its oracle, and q1
   and q12 chunked twice equal their unchunked rows; the MERGE statement
   must launch K1 (its NOT EXISTS anti join probes a dense LUT), and
   the same MERGE into a copy of orders runs once more under
   torch.profiler; then, on a catalog of the phase's own, orders' first
   sixth into a Parquet and an ORC catalog as a CTAS and INSERTs over
   key ranges (a part file each), read back equal to the generated
   table, scanned whole by SQL and, through a hand-driven executor call
   with the connector's cache cleared, by the pruned decode (groups
   skipped, no fallback), and a CSV table of customer written, loaded
   and aggregated against a numpy oracle; then DROP TABLE of the memory
   tables; then the memory-pressure path (``phase_memory_pressure``, a
   Session of its own per run, counters set to 0 just before and read
   just after): JOIN_Q, GROUP BY l_orderkey, AGG_Q's sums and counts
   under ``mxu_agg = 'true'``, AGG_Q and a TopN at ``tpch.sf1``, each
   resident with its decisions replayed from disk (pool peak, wall, the
   card's peak), then with the pool at a quarter of that peak: rows
   equal the resident rows and the numpy oracles, every query spills, K3 launches in the spilled GROUP BY and K5 in the
   chunk-and-merge aggregate; JOIN_Q with every partition forced to disk
   (``TRINO_TPU_SPILL_DIR`` in a temporary directory), and again under
   SPOOL_WRITE faults (recovered to the RAM copy, counted); GROUP BY
   with spill disabled at 1 MiB (it must raise, and the session must
   answer again); and two fresh processes that run TPC-H q3 once each
   with the port's decision file removed first: the second must sync
   fewer times (``fetch_ints``) for the same rows; then SQL over HTTP
   (``phase_http_path``: a port ``CoordinatorServer`` over a CUDA Session
   of its own at ``tpch.sf1``, history in a fresh file, talked to only
   through the port's Client, counters set to 0 just before and read just
   after): TPC-H q1, q6 and q3 (one cold, three steady; rows equal the
   oracles and the in-process rows, route ``device``, K1 and K3 launch)
   beside the in-process walls, q12 under ``mxu_agg = 'true'`` (K5), a
   120,000-row result over many nextUri pages, the host/device crossover
   (a filter and count/sum/min/max over region, nation, supplier,
   customer, orders and lineitem under ``routing_mode = 'host'`` and
   ``'device'``, rows equal between routes, the host route launching
   nothing), q6 ten times under history routing (each route, reason and
   wall printed), 64 host-routed point queries from 16 threads beside a
   q3 on the card, 32 concurrent point queries on orders through the
   micro-batcher, a result-cache hit with no launch, a DELETE of a
   running q3 (USER_CANCELED) and q3 under a 1 ms budget
   (QUERY_EXCEEDED_RUN_TIME), each followed by a correct q6, and the
   read-backs (EXPLAIN's routing line, /v1/metrics, the ``cuda_build.*``
   sites of /v1/jit, ``system.runtime.queries``); then the cluster
   (``phase_cluster_path``: a port coordinator over a CUDA Session of its
   own at ``tpch.sf1`` schedules stages onto two port ``WorkerServer``s
   in this process, each with its own CUDA executor on the one card,
   with a heartbeat failure detector and ``split_rows`` 250,000, the
   spool cleared before every run, counters set to 0 just before and
   read just after): TPC-H q1, q6, q3 and q12 (``mxu_agg = 'true'`` on
   the coordinator and the workers' executors: K5 a split), one cold and
   three steady runs each, every run distributed with tasks on both
   workers and rows equal to the oracles, the in-process rows and the
   same coordinator running them itself over HTTP (the three walls
   printed with tasks, splits and page bytes); K1, K3 and K5 must
   launch; one traced q1 (its spans summed by name); EXPLAIN ANALYZE of
   q3 (a ``Stage source: tasks=`` line); q3 with a third worker killed
   while its task hangs and q1 with a worker drained under it
   (DRAINING, DRAINED, LEFT), both exact; a distributed CTAS of orders'
   first 250,000 keys into ORC (committed by the workers' staged writes)
   and a CTAS of orders into memory (run by the coordinator, as in the
   reference), each equal to its source; the port verifier over TPC-H
   q1, q3, q6, q12 and q14 at ``tpch.tiny`` on the card against sqlite;
   and, after the counts are read, the rows of lineitem where the card's
   ln and power (csrc/glibc_math.cu, glibc's algorithms) and exp and
   sqrt (the CPU's replay) differ from the port's CPU result (all must
   be 0), the glibc kernel against its plain replay and timed beside
   torch.log / torch.pow; then the fault-tolerance tier
   (``phase_fault_tolerance``, counters set to 0 just before and read
   just after): a coordinator and three workers on the card at
   ``tpch.sf1`` run TPC-H q1, q3, q6 and a multiset scan fault-free and
   under seeds 0-5 of ``FailureInjector.from_seed(seed, max_delay_s =
   0.2)`` on the scheduler, the detector and every worker, then under
   the reference's explicit crash mid-split, corrupted drained page,
   dropped task creates and hedged straggler: every run bit-equal to the
   fault-free rows, CRASH, DELAY, DROP and CORRUPT each fired, every
   corrupted drained page counted in ``checksum_failures`` and retried,
   every corrupted spool container rejected on a replay, K1 and K3
   launched, the card's allocation after each seed within 256 MiB of
   the first; a primary and a warm standby over one ledger and spool
   root (two workers, a two-address Client): the primary killed while
   q3 runs (its executor's device caches freed, the standby promoted
   by its detector, the oracle's rows) and a second pair killed at
   WRITE_COMMIT of a distributed CTAS of customer into ORC (the admin
   promotes; customer's rows exactly once); a resource group of one
   slot (two q6 queue; with one queue place the third gets
   QUERY_QUEUE_FULL); a traced, profiled q3 with a worker delayed:
   progress monotonic in [0, 1], the live surfaces filled, device busy
   time in the utilization rows, the timeline's phases summing to the
   wall with a device phase; and approx_distinct (four statements) and
   TIMESTAMP (tests/torch_time_cases.py: pre-epoch rows, every field and
   truncation) on the card equal to the port's CPU Session; then the
   seven soaks of ``trino_tpu_torch/soak.py`` at smoke length
   (``phase_soaks``, counters set to 0 just before the first and read
   just after the last; each soak brings up its own cluster over
   ``tpch.tiny`` with every Session and worker on cuda): chaos 10 seeds,
   write chaos 6, coordinator chaos 5 (one kill a phase), overload with
   its fixed schedule, memory pressure 20 queries, concurrency 100
   clients x 1, elastic 20 s; every gate of each record must hold, the
   elastic soak's per-tenant p99 SLOs included, K1 and K3 must launch,
   and each soak's line prints its gates, wall, launches and the writes
   that took the coordinator's local path (Queue C 6); then the mesh
   (``phase_mesh_path``, counters
   set to 0 just before and read just after): ``SET SESSION distributed
   = true`` on a CUDA Session (the card's default mesh, one shard: q1,
   q6), then a MeshExecutor over ``make_mesh(8, "cuda")`` (eight shards
   on the one card, each scan split into their blocks and the filters,
   projections, partial aggregates and join probes run per shard) with
   partitioned joins: TPC-H q1, q6, q3 and the
   SELECTIVE and PROBE_ROWS joins of tests/test_mesh_dynamic_filter.py,
   one cold and three steady runs each, rows equal to numpy oracles and
   the single card's, K3 eight launches a partitioned join, SELECTIVE
   pruning rows, each query's ``mesh_gathers`` (none for q1 and q6) and
   each card's bytes after the scans, q3 once more with broadcast joins,
   EXPLAIN's ``join distribution: partitioned``, the
   card's idle share over one steady q3; ``mesh_cards: N`` and, with two
   cards or more, q1, q6 and q3 on a mesh over every card with each
   card's K1 and K3 launches (with one card, q3 on a 2-shard mesh over
   cuda:0 twice checks that count); TPC-DS q3 on the ladder
   (degrade reason mesh, no K4); and, after the counts are read, the
   join and aggregate stage programs called directly over lineitem and
   orders, bit-exact against the single card's operators; then the
   introspection tier (``phase_introspection``, counters set to 0 just
   before and read just after): TPC-H q3 (K1, K3), q12 under ``mxu_agg =
   'true'`` (K5), TPC-DS q3 (K4) and chunked q12 each once under
   ``enable_profiling = true`` inside torch.profiler, rows bit-equal to
   the unprofiled run, every node's device + host + compile equal to its
   wall to 1 us, the summed device ms beside the card's busy ms, the
   idle share, and the EXPLAIN ANALYZE split; the executor's Prometheus
   families: three steady TPC-DS q3 runs move MULTIJOIN_FUSED_PROBES and
   JOIN_STRATEGY_DECISIONS{multiway} by `multijoin_fused_probes`' delta
   (K4's launches beside it), a steady chunked q1 hits the fact cache, a
   chunked selective scan (``l_orderkey < ZONE_KEY``, against numpy)
   counts its skipped chunks in SCAN_ZONES_PRUNED, from the fact cache
   and through the prefetch pipeline, and every family's delta over the
   whole run; a fresh process with an empty kernel build directory
   (``TRINO_TPU_CUDA_BUILD_DIR``) runs TPC-H q3 at ``tpch.tiny`` profiled
   twice: the nvcc seconds land on the nodes whose first launch built a
   library, the second run compiles nothing; EXPLAIN ANALYZE of q3 on a
   port coordinator with two workers (deviceMs > 0 in every task's
   TaskStats and in the operator rollup); and q3's steady wall with
   profiling off and on, five runs each, interleaved; then the scale
   phase (``phase_scale``, counters set to 0 just before and read just
   after): the reference's end-to-end configurations through
   ``trino_tpu_torch/e2e.run_e2e`` with their data in a temporary
   directory outside the checkout (generated, with the oracles'
   results, by a child process running ``e2e.prepare`` from the end of
   the kernel build on, beside the phases before), q5-shaped at SF10
   (cut from the reference's SF100; 59,994,842 lineitem rows in two
   chunks of 33,554,432 from the narrowed fact cache) and TPC-H q3 at
   ``tpch.sf10``, each once cold and three times steady, then one more
   steady q5 under torch.profiler and a cold q5 in a fresh Session
   under cProfile; rows equal to the numpy oracles to the cent, q5's
   steady runs slice their chunks from the fact cache, K1 launches, no
   file is left under the checkout, and each star dimension's verdict
   (fused, its degrade reason, or the ladder) is printed; then the
   bench-modes phase (``phase_bench_modes``, counters set to 0 just
   before and read just after): the four kernel micro-benchmarks of
   ``trino_tpu_torch/micro.py`` at the card's shapes (K1 and K2 against
   ``index_select`` over tables of 4,096-65,536 rows and 2^22 probes; the
   sort, direct and hash arms from 10^2 to 10^7 groups over 2^24 rows;
   the fused star against the pairwise ladder at four widths and hit
   rates over 2^22 fact rows; the scan path at 2^22 rows), each record
   written into a temporary directory and parsed back by
   ``regressions.load_bench_round``, then ``coldstart.cold_start`` for
   q3, q5 and q6 at ``tpch.tiny`` with fresh child processes and an
   empty kernel build directory; K1's outputs equal ``index_select``'s,
   K2's words and escapes its plain version's, the aggregate arms the
   same groups, every star equal to its ladder and fused unless K3's
   build of a dimension escaped (the reference's gate), the scan's
   rows identical with pruning on and off and at both prefetch depths,
   the decode counts equal to a CPU process's run of the same function,
   every cold child's rows the steady session's, K1-K4 launched and no
   file left under the checkout; the cold gate's ratios and verdict are
   printed, not required; each phase's wall is logged as ``<phase> took
   N s``;
7. timing of each kernel on the inputs of its largest launch in the main
   paths before the corpus paths (whose launches are counted but whose
   inputs are not kept, so the timed shapes stay comparable): K1 on each
   of its two paths (big tiles, the largest launch with
   a table that L1 can hold, a star's payload gather; small tiles, the
   largest whose tables are all past that, q3's dense-LUT probe; K1's
   and K2's calls each after a 1 GiB read that flushes the 50 MB L2, so
   that their times and their HBM bounds describe the same state):
   `ms` (CUDA events around one wrapper call on an idle stream, median of
   10), `device_ms` (the card's own time per call: for K3–K5
   torch.profiler over 10 calls, every kernel, memset and memcpy of the
   call summed, or CUDA events around 100 back-to-back calls where the
   trace holds no device activity; for K1 and K2 CUDA events around each
   call queued behind the flush, which hides the host's enqueue), the
   plain version's ms, one library call's ms where one computes the same
   function (for K2, ``index_select`` of the same words, a gather without
   the window semantics), and the least time the card could take (bound);
   K3 with a row per launch shape (one table: the largest table of the
   star's builds alone; a star's builds; a partitioned aggregate's
   partitions; a mesh shard's join build; each against its plain
   version, the groups of every table
   that did not escape and a join build's interleaved table), its
   launches per call site, its host ms per call, and the star's public
   ``build_join_tables`` call with its torch prep; K4 through the public
   ``multiway_probe`` (prep included), its host ms and device activities
   per call, and apart the torch encoding of the same keys that callers
   ran before K4 derived the slots itself; K5 through the public
   ``direct_group_aggregate_mxu`` on q12's batch and on the 6M-row
   shape, its host ms, device activities per call (one kernel: no
   memset, no torch kernel, no [A, n] planes allocated) and
   ``index_add_`` of the reference's lanes as the summing part's library
   time; beside K5, the two arms of a direct aggregate (K5's `mxu` arm and the
   masked-sum `direct` arm) on q12's batch, with its key redrawn over 2 to
   16 groups, to place the crossover that `mxu_agg = auto` models;
   and each launch of the scale and bench-modes phases larger than the
   main paths' largest of the same kernel (K1 per path), timed the same
   way;
8. a `kernels` JSON line (K1 with a row per tile size), the card line, and
   last the result line ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result. It never imports jax or the reference package.
"""

from __future__ import annotations

import datetime
import json
import os
import statistics
import subprocess
import sys
import threading
import time

# the H100's data-sheet memory rate (SXM part), bytes/s
HBM_BYTES_PER_S = 3.35e12
TPCH_SCHEMA = "sf1"
TPCDS_SCHEMA = "sf1"
STAR_QUERIES = (3, 7, 19, 96)
CHUNK_ROWS = 1_048_576
HERE = os.path.dirname(os.path.abspath(__file__))

Q1 = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

Q3 = """
SELECT l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING'
  AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate, l_orderkey
LIMIT 10
"""

Q6 = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01'
  AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------------
# numpy oracle over the generated tables (decimals are scaled int64)
# --------------------------------------------------------------------------

def _days(s: str) -> int:
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


def _col(table, name):
    import numpy as np
    return np.asarray(table.columns[table.schema.index_of(name)])


def _dec(v: int, scale: int):
    from decimal import Decimal
    return Decimal(int(v)).scaleb(-scale)


def _avg_half_up(total: int, count: int) -> int:
    q, r = divmod(abs(total), count)
    q += 2 * r >= count
    return q if total >= 0 else -q


def oracle_q1(li):
    import numpy as np
    m = _col(li, "l_shipdate") <= _days("1998-09-02")
    rf, ls = _col(li, "l_returnflag")[m], _col(li, "l_linestatus")[m]
    qty, ext = _col(li, "l_quantity")[m], _col(li, "l_extendedprice")[m]
    disc, tax = _col(li, "l_discount")[m], _col(li, "l_tax")[m]
    rf_pool = li.schema.field("l_returnflag").dictionary
    ls_pool = li.schema.field("l_linestatus").dictionary
    disc_price = ext * (100 - disc)
    charge = disc_price * (100 + tax)
    out = []
    for r in range(len(rf_pool)):
        for s in range(len(ls_pool)):
            g = (rf == r) & (ls == s)
            n = int(g.sum())
            if n == 0:
                continue
            sq, se, sd = int(qty[g].sum()), int(ext[g].sum()), \
                int(disc[g].sum())
            out.append((rf_pool[r], ls_pool[s], _dec(sq, 2), _dec(se, 2),
                        _dec(int(disc_price[g].sum()), 4),
                        _dec(int(charge[g].sum()), 6),
                        _dec(_avg_half_up(sq, n), 2),
                        _dec(_avg_half_up(se, n), 2),
                        _dec(_avg_half_up(sd, n), 2), n))
    return sorted(out, key=lambda t: (t[0], t[1]))


def oracle_q6(li):
    d = _col(li, "l_shipdate")
    disc = _col(li, "l_discount")
    m = (d >= _days("1994-01-01")) & (d < _days("1995-01-01")) & \
        (disc >= 5) & (disc <= 7) & (_col(li, "l_quantity") < 2400)
    return [(_dec(int((_col(li, "l_extendedprice")[m] * disc[m]).sum()),
                  4),)]


def oracle_q3(cust, orders, li):
    import numpy as np
    seg_pool = cust.schema.field("c_mktsegment").dictionary
    seg = _col(cust, "c_mktsegment") == seg_pool.index("BUILDING")
    ck = _col(cust, "c_custkey")
    cust_ok = np.zeros(int(ck.max()) + 1, np.bool_)
    cust_ok[ck[seg]] = True
    ok_o = cust_ok[_col(orders, "o_custkey")] & \
        (_col(orders, "o_orderdate") < _days("1995-03-15"))
    okey = _col(orders, "o_orderkey")
    lut = np.full(int(okey.max()) + 1, -1, np.int64)
    lut[okey[ok_o]] = np.nonzero(ok_o)[0]
    lk = _col(li, "l_orderkey")
    m = (_col(li, "l_shipdate") > _days("1995-03-15")) & (lut[lk] >= 0)
    rev = _col(li, "l_extendedprice")[m] * (100 - _col(li, "l_discount")[m])
    keys, inv = np.unique(lk[m], return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, rev)
    orow = lut[keys]
    odate = _col(orders, "o_orderdate")[orow]
    oprio = _col(orders, "o_shippriority")[orow]
    order = np.lexsort((keys, odate, -sums))[:10]
    epoch = datetime.date(1970, 1, 1)
    return [(int(keys[i]), _dec(int(sums[i]), 4),
             (epoch + datetime.timedelta(days=int(odate[i]))).isoformat(),
             int(oprio[i])) for i in order]


def oracle_stream(orders, cust):
    """The streaming-build query (STREAM_SQL): orders before 1993 joined to
    their customer, first 200 by order key."""
    import numpy as np
    m = _col(orders, "o_orderdate") < _days("1993-01-01")
    okey = _col(orders, "o_orderkey")[m]
    order = np.argsort(okey, kind="stable")[:200]
    crow = _row_of(cust, "c_custkey", _col(orders, "o_custkey")[m][order])
    names = cust.schema.field("c_name").dictionary
    return [(int(okey[i]),
             _dec(int(_col(orders, "o_totalprice")[m][i]), 2),
             names[int(_col(cust, "c_name")[c])],
             _dec(int(_col(cust, "c_acctbal")[c]), 2))
            for i, c in zip(order, crow)]


STREAM_SQL = ("SELECT o_orderkey, o_totalprice, c_name, c_acctbal"
              " FROM orders o JOIN customer c ON o.o_custkey = c.c_custkey"
              " WHERE o_orderdate < DATE '1993-01-01'"
              " ORDER BY o_orderkey LIMIT 200")


def oracle_q12(orders, li):
    import numpy as np
    mode_pool = li.schema.field("l_shipmode").dictionary
    prio_pool = orders.schema.field("o_orderpriority").dictionary
    okey = _col(orders, "o_orderkey")
    prio = np.full(int(okey.max()) + 1, -1, np.int64)
    prio[okey] = _col(orders, "o_orderpriority")
    mode = _col(li, "l_shipmode")
    commit, receipt = _col(li, "l_commitdate"), _col(li, "l_receiptdate")
    m = np.isin(mode, [mode_pool.index("MAIL"), mode_pool.index("SHIP")]) \
        & (commit < receipt) & (_col(li, "l_shipdate") < commit) & \
        (receipt >= _days("1994-01-01")) & (receipt < _days("1995-01-01"))
    high = np.isin(prio[_col(li, "l_orderkey")[m]],
                   [prio_pool.index("1-URGENT"), prio_pool.index("2-HIGH")])
    out = []
    for code in sorted(set(mode[m].tolist()), key=lambda c: mode_pool[c]):
        g = mode[m] == code
        out.append((mode_pool[code], int((g & high).sum()),
                    int((g & ~high).sum())))
    return out


def _valid(table, name):
    import numpy as np
    i = table.schema.index_of(name)
    v = None if table.valids is None else table.valids[i]
    return np.ones(table.num_rows, np.bool_) if v is None else \
        np.asarray(v)


def _row_of(table, name, keys):
    """Row index of each key in `table`'s unique key column `name`."""
    import numpy as np
    k = _col(table, name)
    lut = np.full(int(k.max()) + 1, -1, np.int64)
    lut[k] = np.arange(len(k))
    return lut[np.clip(keys, 0, len(lut) - 1)]


def _code(table, name, value):
    return table.schema.field(name).dictionary.index(value)


def oracle_ds_q3(t):
    import numpy as np
    ss, dd, it = t["store_sales"], t["date_dim"], t["item"]
    drow = _row_of(dd, "d_date_sk", _col(ss, "ss_sold_date_sk"))
    irow = _row_of(it, "i_item_sk", _col(ss, "ss_item_sk"))
    m = _valid(ss, "ss_sold_date_sk") & \
        (_col(dd, "d_moy")[drow] == 11) & \
        (_col(it, "i_manufact_id")[irow] == 128)
    year = _col(dd, "d_year")[drow[m]].astype(np.int64)
    bid = _col(it, "i_brand_id")[irow[m]]
    bcode = _col(it, "i_brand")[irow[m]].astype(np.int64)
    price = _col(ss, "ss_ext_sales_price")[m]
    keys, inv = np.unique(np.stack([year, bid, bcode], 1), axis=0,
                          return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv.ravel(), price)
    pool = it.schema.field("i_brand").dictionary
    rows = [(int(y), int(b), pool[int(c)], int(v))
            for (y, b, c), v in zip(keys, sums)]
    rows.sort(key=lambda r: (r[0], -r[3], r[1]))
    return [(y, b, c, _dec(v, 2)) for y, b, c, v in rows[:100]]


def oracle_ds_q7(t):
    import numpy as np
    ss, cd, dd = t["store_sales"], t["customer_demographics"], \
        t["date_dim"]
    it, pr = t["item"], t["promotion"]
    crow = _row_of(cd, "cd_demo_sk", _col(ss, "ss_cdemo_sk"))
    drow = _row_of(dd, "d_date_sk", _col(ss, "ss_sold_date_sk"))
    prow = _row_of(pr, "p_promo_sk", _col(ss, "ss_promo_sk"))
    irow = _row_of(it, "i_item_sk", _col(ss, "ss_item_sk"))
    m = _valid(ss, "ss_cdemo_sk") & _valid(ss, "ss_sold_date_sk") & \
        _valid(ss, "ss_promo_sk") & \
        (_col(cd, "cd_gender")[crow] == _code(cd, "cd_gender", "M")) & \
        (_col(cd, "cd_marital_status")[crow] ==
         _code(cd, "cd_marital_status", "S")) & \
        (_col(cd, "cd_education_status")[crow] ==
         _code(cd, "cd_education_status", "College")) & \
        ((_col(pr, "p_channel_email")[prow] ==
          _code(pr, "p_channel_email", "N")) |
         (_col(pr, "p_channel_event")[prow] ==
          _code(pr, "p_channel_event", "N"))) & \
        (_col(dd, "d_year")[drow] == 2000)
    ids = _col(it, "i_item_id")[irow[m]].astype(np.int64)
    pool = it.schema.field("i_item_id").dictionary
    keys, inv = np.unique(ids, return_inverse=True)
    n = np.bincount(inv, minlength=len(keys))
    sums = []
    for name in ("ss_quantity", "ss_list_price", "ss_coupon_amt",
                 "ss_sales_price"):
        acc = np.zeros(len(keys), np.int64)
        np.add.at(acc, inv, _col(ss, name)[m])
        sums.append(acc)
    rows = []
    for j, code in enumerate(keys):
        c = int(n[j])
        rows.append((pool[int(code)], int(sums[0][j]) / c,
                     *[_dec(_avg_half_up(int(a[j]), c), 2)
                       for a in sums[1:]]))
    rows.sort(key=lambda r: r[0])
    return rows[:100]


def oracle_ds_q96(t):
    ss, hd, td, st = t["store_sales"], t["household_demographics"], \
        t["time_dim"], t["store"]
    trow = _row_of(td, "t_time_sk", _col(ss, "ss_sold_time_sk"))
    hrow = _row_of(hd, "hd_demo_sk", _col(ss, "ss_hdemo_sk"))
    srow = _row_of(st, "s_store_sk", _col(ss, "ss_store_sk"))
    m = _valid(ss, "ss_sold_time_sk") & _valid(ss, "ss_hdemo_sk") & \
        _valid(ss, "ss_store_sk") & (_col(td, "t_hour")[trow] == 20) & \
        (_col(td, "t_minute")[trow] >= 30) & \
        (_col(hd, "hd_dep_count")[hrow] == 7) & \
        (_col(st, "s_store_name")[srow] ==
         _code(st, "s_store_name", "ese"))
    return [(int(m.sum()),)]


def oracle_q4(orders, li):
    """TPC-H q4: orders of 1993 Q3 with a line received after its commit
    date, counted per priority."""
    import numpy as np
    od = _col(orders, "o_orderdate")
    okey = _col(orders, "o_orderkey")
    late = _col(li, "l_commitdate") < _col(li, "l_receiptdate")
    has = np.zeros(int(okey.max()) + 1, np.bool_)
    has[_col(li, "l_orderkey")[late]] = True
    m = (od >= _days("1993-07-01")) & (od < _days("1993-10-01")) & \
        has[okey]
    pool = orders.schema.field("o_orderpriority").dictionary
    n = np.bincount(_col(orders, "o_orderpriority")[m],
                    minlength=len(pool))
    return sorted((pool[c], int(n[c])) for c in range(len(pool)) if n[c])


def oracle_q21(supplier, nation, orders, li):
    """TPC-H q21: per order with o_orderstatus = 'F', a late line of a
    SAUDI ARABIA supplier counts when the order has at least two distinct
    suppliers and that line's supplier is its only late one."""
    import numpy as np
    lk, ls = _col(li, "l_orderkey"), _col(li, "l_suppkey")
    late = _col(li, "l_receiptdate") > _col(li, "l_commitdate")
    size = int(lk.max()) + 1

    def distinct_suppliers(mask):
        pairs = np.unique(lk[mask] * (1 << 20) + ls[mask])
        return np.bincount(pairs >> 20, minlength=size)
    n_supp = distinct_suppliers(np.ones(len(lk), np.bool_))
    n_late = distinct_suppliers(late)
    status = np.full(size, -1, np.int64)
    status[_col(orders, "o_orderkey")] = _col(orders, "o_orderstatus")
    srow = _row_of(supplier, "s_suppkey", ls)
    nrow = _row_of(nation, "n_nationkey",
                   _col(supplier, "s_nationkey")[srow])
    m = late & (n_supp[lk] >= 2) & (n_late[lk] == 1) & \
        (status[lk] == _code(orders, "o_orderstatus", "F")) & \
        (_col(nation, "n_name")[nrow] ==
         _code(nation, "n_name", "SAUDI ARABIA"))
    names = supplier.schema.field("s_name").dictionary
    codes, n = np.unique(_col(supplier, "s_name")[srow[m]],
                         return_counts=True)
    rows = sorted(((names[int(c)], int(k)) for c, k in zip(codes, n)),
                  key=lambda r: (-r[1], r[0]))
    return rows[:100]


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def oracle_q22(cust, orders):
    """TPC-H q22: customers of seven country codes with a balance above
    those codes' positive average and no orders, per code."""
    import numpy as np
    pool = cust.schema.field("c_phone").dictionary
    code_of = np.array([p[:2] for p in pool])
    cc = code_of[_col(cust, "c_phone")]
    bal = _col(cust, "c_acctbal")
    inlist = np.isin(cc, Q22_CODES)
    pos = inlist & (bal > 0)
    avg = _avg_half_up(int(bal[pos].sum()), int(pos.sum()))
    ck = _col(cust, "c_custkey")
    has = np.zeros(int(ck.max()) + 1, np.bool_)
    ok = _col(orders, "o_custkey")
    has[ok[ok <= ck.max()]] = True
    m = inlist & (bal > avg) & ~has[ck]
    out = []
    for code in sorted(set(cc[m].tolist())):
        g = m & (cc == code)
        out.append((code, int(g.sum()), _dec(int(bal[g].sum()), 2)))
    return out


def oracle_ds_q12(t):
    """TPC-DS q12 without its revenueratio column (a double, compared
    apart): web sales of three categories in 31 days, per item, with the
    i_class total the window sums."""
    import numpy as np
    ws, it, dd = t["web_sales"], t["item"], t["date_dim"]
    irow = _row_of(it, "i_item_sk", _col(ws, "ws_item_sk"))
    drow = _row_of(dd, "d_date_sk", _col(ws, "ws_sold_date_sk"))
    cat = _col(it, "i_category")
    cpool = it.schema.field("i_category").dictionary
    cats = [cpool.index(c) for c in ("Sports", "Books", "Home")]
    d = _col(dd, "d_date")[drow]
    m = _valid(ws, "ws_item_sk") & _valid(ws, "ws_sold_date_sk") & \
        np.isin(cat[irow], cats) & (d >= _days("1999-02-22")) & \
        (d <= _days("1999-03-24"))
    cols = ("i_item_id", "i_item_desc", "i_category", "i_class",
            "i_current_price")
    keys = np.stack([_col(it, c)[irow[m]].astype(np.int64) for c in cols],
                    1)
    groups, inv = np.unique(keys, axis=0, return_inverse=True)
    rev = np.zeros(len(groups), np.int64)
    np.add.at(rev, inv.ravel(), _col(ws, "ws_ext_sales_price")[m])
    cls = groups[:, 3]
    total = {c: int(rev[cls == c].sum()) for c in set(cls.tolist())}
    pools = [it.schema.field(c).dictionary for c in cols[:4]]
    rows = []
    for g, r in zip(groups, rev):
        rows.append((*(p[int(v)] for p, v in zip(pools, g[:4])),
                     _dec(int(g[4]), 2), _dec(int(r), 2),
                     int(r) * 100 / total[int(g[3])]))
    rows.sort(key=lambda r: (r[2], r[3], r[0], r[1], r[6]))
    return rows[:100]


def oracle_ds_q38(t):
    """TPC-DS q38: the (last name, first name, date) triples of customers
    who bought in the 12 months through all three channels."""
    import numpy as np
    cust, dd = t["customer"], t["date_dim"]
    seq_ok = (_col(dd, "d_month_seq") >= 1200) & \
        (_col(dd, "d_month_seq") <= 1211)
    sets = []
    for fact, date_col, cust_col in (
            ("store_sales", "ss_sold_date_sk", "ss_customer_sk"),
            ("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk"),
            ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")):
        f = t[fact]
        drow = _row_of(dd, "d_date_sk", _col(f, date_col))
        crow = _row_of(cust, "c_customer_sk", _col(f, cust_col))
        m = _valid(f, date_col) & _valid(f, cust_col) & seq_ok[drow] & \
            (crow >= 0)
        crow = crow[m]
        # NULL names compare equal in a set operation: code -1
        last = np.where(_valid(cust, "c_last_name")[crow],
                        _col(cust, "c_last_name")[crow], -1) + 1
        first = np.where(_valid(cust, "c_first_name")[crow],
                         _col(cust, "c_first_name")[crow], -1) + 1
        date = _col(dd, "d_date")[drow[m]].astype(np.int64)
        sets.append(np.unique((last.astype(np.int64) << 40) |
                              (first.astype(np.int64) << 20) | date))
    both = np.intersect1d(np.intersect1d(sets[0], sets[1]), sets[2])
    return [(int(len(both)),)]


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def time_cuda(fn, reps: int = 10, flush=None) -> float:
    """Median ms of `fn` over `reps` runs, CUDA events around each, on an
    idle stream; `flush` (if given) runs and finishes before each."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
            torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_activities(prof):
    """(name, us) of every kernel, memset and memcpy in a torch.profiler
    trace."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_time(fn, reps: int = 10, flush=None):
    """(ms, method, parts): the device time of one call of `fn`.

    `profiler`: torch.profiler (CUPTI) over `reps` calls, the summed
    duration of every kernel, memset and memcpy those calls ran, over
    `reps`; `parts` splits it by activity name (us per call). CUPTI sees
    kernels launched through ctypes too. A trace that holds no device
    activity (CUPTI drops one now and then) is taken again, twice at most;
    after that, `events_100`: CUDA events around 100 back-to-back calls,
    over 100 (that also counts any gap the host leaves between launches).

    With `flush` (l2_flush's), `events_behind_flush`: each of `reps` calls
    is queued behind a flush that keeps the card busy longer than the
    call's host work takes, so that the events around the call hold the
    card's time alone; the median. `parts` gives the flush's median device
    ms and the call's longest host ms: the method holds where the second
    is the smaller."""
    import torch
    fn()
    torch.cuda.synchronize()
    if flush is not None:
        times, flush_ms, host_ms = [], [], []
        for _ in range(reps):
            c, a, b = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
            c.record()
            flush()
            a.record()
            t0 = time.perf_counter()
            fn()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            flush_ms.append(c.elapsed_time(a))
        return statistics.median(times), "events_behind_flush", {
            "flush_ms": round(statistics.median(flush_ms), 4),
            "host_ms_max": round(max(host_ms), 4)}
    from torch.profiler import ProfilerActivity, profile
    parts = {}
    for _attempt in range(3):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        except Exception as exc:      # no CUPTI: fall back to events
            log(f"torch.profiler failed ({exc!r}); timing with CUDA "
                f"events")
            break
        for name, us in _device_activities(prof):
            parts[name] = parts.get(name, 0.0) + us / reps
        if parts:
            break
    total_us = sum(parts.values())
    if total_us > 0:
        return total_us / 1e3, "profiler", {
            k[:60]: round(v, 3) for k, v in parts.items()}
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(100):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 100, "events_100", {}


def l2_flush():
    """A function that reads 1 GiB on the card (one torch sum, ~0.3 ms):
    it leaves none of the 50 MB L2 to what ran before it (a read, so no
    dirty lines are left to write back during the next call), and keeps
    the card busy while the host enqueues a call behind it
    (device_time)."""
    import torch
    buf = torch.ones(1 << 27, dtype=torch.int64, device="cuda")
    return lambda: buf.sum()


def with_device_time(entry: dict, fn, flush=None) -> dict:
    """`entry` (a kernels-line row) with `device_ms` and `device_method`
    of one call of `fn` (device_time), its parts logged."""
    ms, method, parts = device_time(fn, flush=flush)
    log(f"device time {entry['name']}: {ms:.4f} ms per call ({method}; "
        f"events-around-one-call {entry['ms']:.4f} ms); parts (us per "
        f"call) {json.dumps(parts)}")
    return {**entry, "device_ms": ms, "device_method": method}


def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _max_abs_err(pairs) -> float:
    import torch
    err = 0.0
    for a, b in pairs:
        if a.numel():
            err = max(err, float((a.to(torch.float64) -
                                  b.to(torch.float64)).abs().max()))
    return err


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from trino_tpu_torch.ops import cuda_build
    secs = cuda_build.build_all()
    log(f"kernel build: {secs:.3f} s for {list(cuda_build.KERNEL_SOURCES)}")
    return smi


def phase_k1(dev):
    import torch
    from trino_tpu_torch.ops import gather as k1
    g = torch.Generator().manual_seed(1)
    W, n = 1_500_000, 6_000_000
    tables = [
        torch.randint(-2 ** 62, 2 ** 62, (W,), generator=g),
        torch.randn(W, generator=g, dtype=torch.float64),
        torch.randint(-2 ** 31, 2 ** 31 - 1, (W,), generator=g).to(
            torch.int32),
        torch.randn(W, generator=g).to(torch.float32),
        torch.randint(0, 2, (W,), generator=g).to(torch.bool)]
    fills = [-7, 2.5, -1, -0.5, True]
    idx = torch.randint(-1000, W + 1000, (n,), generator=g)
    idx[:64] = torch.tensor([-(2 ** 62), 2 ** 62, -1, W] * 16)  # wild
    tc = [t.to(dev) for t in tables]
    ic = idx.to(dev)
    got = k1.gather_columns(tc, ic, fills)
    want = k1.gather_columns_plain(tc, ic, fills)
    torch.cuda.synchronize()
    for t, a, b in zip(tc, got, want):
        require(_bits_equal(a, b), f"K1 differs from plain for {t.dtype}")
    # the q3-shaped LUT probe: an 8M-entry int32 row LUT
    D = 8_388_608
    lut = torch.randint(-1, 1_500_000, (D + 1,), generator=g).to(
        torch.int32).to(dev)
    pidx = torch.randint(0, D + 1, (n,), generator=g).to(dev)
    a = k1.gather_columns([lut], pidx)[0]
    b = k1.gather_columns_plain([lut], pidx)[0]
    torch.cuda.synchronize()
    require(_bits_equal(a, b), "K1 differs from plain on the 8M LUT")
    # a star's payload shape: 18 tables of 18,432 rows, int32 indices
    Ws = 18_432
    star = [tables[i % len(tables)][:Ws].to(dev) for i in range(18)]
    sfills = [fills[i % len(fills)] for i in range(18)]
    sidx = torch.randint(-100, Ws + 100, (n,), generator=g).to(
        torch.int32).to(dev)
    want = k1.gather_columns_plain(star, sidx, sfills)
    before = k1.gather_columns.launches
    got = k1.gather_columns(star, sidx, sfills)
    torch.cuda.synchronize()
    require(k1.gather_columns.launches == before + 1,
            "K1 took more than one launch for 18 tables")
    for t, a, b in zip(star, got, want):
        require(_bits_equal(a, b), f"K1 differs from plain for {t.dtype} "
                f"at the star's shape")
    log(f"K1 check: bit-exact on {len(tc)} dtypes (W={W}, n={n}, misses "
        f"and wild indices), the {D + 1}-entry LUT and 18 tables of {Ws} "
        f"rows in one launch")


def phase_k2(dev):
    import torch
    from trino_tpu_torch.ops import gather as k2
    g = torch.Generator().manual_seed(21)
    cases = []
    # (a) q12's shape: an 8,388,609-entry int8 LUT, 1,048,576 near-sorted
    # indices over a span of ~1.05M keys
    D = 8_388_609
    lut = torch.randint(-128, 128, (D,), generator=g).to(torch.int8)
    lo = 3_000_000
    near = torch.sort(torch.randint(lo, lo + 1_050_000, (1 << 20,),
                                    generator=g)).values
    cases.append(("q12 shape", lut, near, "int8", False))
    # (b) random indices into the same LUT: escapes
    cases.append(("random", lut, torch.randint(0, D, (1 << 20,),
                                               generator=g), "int8", True))
    # (c) each word dtype, near-sorted with jitter and (d) misses and
    # out-of-range indices
    for word, tdt in (("int8", torch.int8), ("int16", torch.int16),
                      ("int32", torch.int32), ("int64", torch.int64)):
        info = torch.iinfo(tdt)
        w = 2_000_003
        t = torch.randint(info.min, info.max, (w,), generator=g,
                          dtype=torch.int64).to(tdt)
        idx = torch.sort(torch.randint(0, w, (500_000,),
                                       generator=g)).values
        idx = (idx + torch.randint(-3, 4, idx.shape, generator=g)).clamp(
            0, w - 1)
        idx[::9] = -1
        idx[5::17] = -(1 << 40)
        idx[7::23] = 1 << 40
        idx[11::29] = w + 70_000
        cases.append((f"{word} with misses", t, idx, word, None))
    # (d) a LUT shorter than two windows
    short = torch.randint(-(1 << 60), 1 << 60, (9000,), generator=g)
    cases.append(("short LUT", short, torch.randint(-5, 9005, (70_000,),
                                                    generator=g),
                  "int64", None))
    summary = []
    for name, t, idx, word, escapes in cases:
        planes = k2.prepare_word_planes(t.to(dev))
        ic = idx.to(dev)
        got_w, got_e = k2.gather_word_windowed(planes, ic, word)
        want_w, want_e = k2.gather_word_windowed_plain(planes, ic, word)
        torch.cuda.synchronize()
        require(_bits_equal(got_w, want_w), f"K2 words differ on {name}")
        require(int(got_e) == int(want_e), f"K2 escapes differ on {name}: "
                f"{int(got_e)} vs {int(want_e)}")
        if escapes is not None:
            require((int(got_e) > 0) == escapes,
                    f"K2 on {name}: {int(got_e)} escapes")
        summary.append(f"{name} ({int(got_e)} escapes)")
    log("K2 check: words and escape totals bit-exact with plain on "
        + ", ".join(summary))


def _agg_specs(*funcs):
    from trino_tpu_torch.ops.aggregate import AggSpec
    return tuple(AggSpec(f, None if f == "count_star" else 0)
                 for f in funcs)


def _group_rows(tkey, st):
    from trino_tpu_torch.ops.hashtable import EMPTY_KEY
    import torch
    m = tkey != EMPTY_KEY
    return sorted(map(tuple, torch.cat([tkey[m][None], st[:, m]]).T
                      .tolist()))


def _groups_by_key(tkey, st):
    """A table's occupied slots as one [1 + states, groups] tensor in key
    order (a table holds each key once): two tables hold the same groups
    iff these are equal."""
    import torch
    from trino_tpu_torch.ops.hashtable import EMPTY_KEY
    m = tkey != EMPTY_KEY
    rows = torch.cat([tkey[m][None], st[:, m]])
    return rows[:, torch.argsort(rows[0])]


def phase_k3(dev):
    import torch
    from trino_tpu_torch.batch import Batch, Column
    from trino_tpu_torch.ops import hashtable as ht
    g = torch.Generator().manual_seed(2)
    # the largest table: at this load (0.09) no chain nears MAX_PROBES,
    # so neither version escapes and the states must agree exactly
    rows, groups, T = 6_000_000, 12_000, 1 << 17
    key = torch.randint(0, groups, (rows,), generator=g) * 1_000_003 + 17
    slot = ht.hash_slot(key, T)
    slot[::97] = -1                                   # dead rows
    big = torch.randint(2 ** 61, 2 ** 62, (rows,), generator=g)
    vals = torch.stack([big, torch.randint(-2 ** 62, 2 ** 62, (rows,),
                                           generator=g)])
    layout, ns, nv = ht.agg_layout(_agg_specs("sum", "count", "min",
                                              "max"))
    planes = torch.stack([vals[0], vals[1], vals[1]])[:nv]
    vbits = torch.randint(0, 16, (rows,), generator=g).to(torch.int32)
    args = [t.to(dev) for t in (slot, key, vbits, planes)]
    tk, st, esc, occ = ht.hash_insert(*args, layout, ns, T)
    tk2, st2, esc2, occ2 = ht.hash_insert_plain(*args, layout, ns, T)
    torch.cuda.synchronize()
    require(int(esc) == 0 and int(esc2) == 0, "K3 escaped on 12k groups")
    require(int(occ) == int(occ2) == groups, "K3 occupancy differs")
    require(_group_rows(tk, st) == _group_rows(tk2, st2),
            "K3 group states differ from plain")
    # forced overflow: 200k distinct keys into 1024 slots
    fk = torch.arange(200_000, dtype=torch.int64, device=dev)
    fslot = ht.hash_slot(fk, 1024)
    _, _, fesc, focc = ht.hash_insert(
        fslot, fk, torch.zeros(200_000, dtype=torch.int32, device=dev),
        torch.zeros((1, 200_000), dtype=torch.int64, device=dev), (), 0,
        1024)
    require(int(fesc) > 0, "K3 forced overflow did not escape")
    # join build with duplicate keys, then the probe
    nb = 60_000                   # within the largest table's load cap
    bkeys = torch.randint(0, 48_000, (nb,), generator=g)
    dups = nb - len(torch.unique(bkeys))
    bcol = Column(bkeys.to(dev), torch.ones(nb, dtype=torch.bool,
                                            device=dev))
    pay = Column(torch.arange(nb, device=dev),
                 torch.ones(nb, dtype=torch.bool, device=dev))
    build = Batch((bcol, pay), torch.ones(nb, dtype=torch.bool, device=dev))
    slots, fits = ht.join_table_slots(nb)
    require(fits, "join table sizing")
    tkey, src, dup, jesc = ht.build_join_table(build, (0,), slots)
    require(int(jesc) == 0, "K3 join build escaped")
    require(int(dup) == dups, f"dup_rows {int(dup)} != {dups}")
    np_ = 300_000
    pkeys = torch.randint(-10, 60_000, (np_,), generator=g).to(dev)
    probe = Batch((Column(pkeys, torch.ones(np_, dtype=torch.bool,
                                            device=dev)),),
                  torch.ones(np_, dtype=torch.bool, device=dev))
    out_k = ht.hash_join_probe(probe, build, tkey, src, (0,), (0,),
                               "inner", "on")
    out_p = ht.hash_join_probe(probe, build, tkey, src, (0,), (0,),
                               "inner", "off")
    torch.cuda.synchronize()
    require(torch.equal(out_k.live, out_p.live), "hash probe live differs")
    for ca, cb in zip(out_k.columns, out_p.columns):
        require(torch.equal(ca.data[out_k.live], cb.data[out_p.live]),
                "hash probe payload differs")
    log(f"K3 check: {groups} groups over {rows} rows equal as multisets "
        f"(sums of ~500 values >= 2^61 wrap), forced overflow escaped "
        f"{int(fesc)} rows, join dup_rows={int(dup)} exact, probe equal")
    _check_k3_multi(dev, g)


def _check_k3_multi(dev, g):
    """K3's multi-table entry: 16 tables in one launch against the plain
    version per table (table 5 forced over its cap, the others clean:
    per-table counters independent), and a star's builds in one launch
    against one build_join_table per dimension (a duplicated and an
    over-cap dimension beside clean ones)."""
    import torch
    from trino_tpu_torch.batch import Batch, Column
    from trino_tpu_torch.ops import hashtable as ht
    G, T, n = 16, 1 << 14, 2_000_000
    tid = torch.randint(0, G, (n,), generator=g).to(torch.int32)
    key = torch.randint(0, 3000, (n,), generator=g) * 1_000_003 + tid
    over = tid == 5
    key[over] = torch.randint(0, 1 << 40, (int(over.sum()),), generator=g)
    mask = torch.rand(n, generator=g) > 0.03
    valid = torch.rand(n, generator=g) > 0.1
    v64 = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g)
    v32 = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g).to(
        torch.int32)
    key, tid, mask, valid, v64, v32 = (t.to(dev) for t in (
        key, tid, mask, valid, v64, v32))
    layout, ns, _ = ht.agg_layout(_agg_specs("sum", "count", "min", "max"))
    planes = ((v64, valid), (None, valid), (v32, valid), (v64, None))
    args = (key, mask, planes, layout, ns, T, G, tid)
    before = ht.hash_insert_multi.launches
    tk, st, cnt, _ = ht.hash_insert_multi(*args)
    tk2, st2, cnt2, _ = ht.hash_insert_multi_plain(*args)
    torch.cuda.synchronize()
    require(ht.hash_insert_multi.launches == before + 1,
            "K3 took more than one launch for 16 tables")
    c, c2 = cnt.tolist(), cnt2.tolist()
    for t in range(G):
        if t == 5:
            require(c[t][0] > 0 and c2[t][0] > 0 and
                    c[t][1] <= T * ht.LOAD_NUM // ht.LOAD_DEN,
                    f"K3 table 5 did not escape: {c[t]}")
            continue
        require(c[t] == c2[t] and c[t][0] == 0,
                f"K3 table {t} counters {c[t]} != plain {c2[t]}")
        require(_group_rows(tk[t], st[:, t]) == _group_rows(tk2[t],
                                                           st2[:, t]),
                f"K3 table {t} groups differ from plain")
    # a star's builds: clean, duplicated, over its cap, clean
    T = 1 << 15
    cap = T * ht.LOAD_NUM // ht.LOAD_DEN
    builds, want = [], []
    for d, (m, distinct) in enumerate(((18_432, 18_432), (9_000, 6_000),
                                       (cap + 500, cap + 500),
                                       (2_000, 2_000))):
        keys = torch.randperm(1 << 24, generator=g)[:distinct]
        keys = keys[torch.randint(0, distinct, (m,), generator=g)] \
            if distinct < m else keys
        keys = (keys * 8 + d).to(dev)
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        b = Batch((Column(keys, ones),), ones)
        builds.append(b)
        want.append(ht.build_join_table(b, (0,), T))
    before = ht.hash_insert_multi.launches
    tkey, src, dup, esc = ht.build_join_tables(builds, [(0,)] * 4, T)
    torch.cuda.synchronize()
    require(ht.hash_insert_multi.launches == before + 1,
            "the star's builds took more than one K3 launch")
    for d, (wk, ws, wd, we) in enumerate(want):
        require((int(esc[d]) > 0) == (int(we) > 0),
                f"dimension {d}: escaped {int(esc[d])} vs {int(we)}")
        if int(we) > 0:
            continue
        require(int(dup[d]) == int(wd), f"dimension {d}: dup_rows "
                f"{int(dup[d])} vs {int(wd)}")
        require(_group_rows(tkey[d], src[d][None]) ==
                _group_rows(wk, ws[None]),
                f"dimension {d}: {{key, row id}} slots differ")
    log(f"K3 multi check: 16 tables in one launch equal plain per table "
        f"(table 5 over its cap escaped {c[5][0]} rows alone); a star's 4 "
        f"builds in one launch equal 4 single builds (dup_rows "
        f"{dup.tolist()}, escaped {esc.tolist()})")


def _star_probe_inputs(dev, g):
    """A synthetic star for K4: n = 4M fact rows, k = 4 dimension tables
    built by K3 at one shared T = 65,536, then a crafted run of 17 keys of
    one home slot h written into dimension 0 at h..h+16 (a probe for the
    last one exhausts MAX_PROBES and misses). Fact keys: ~85% hits, the
    rest misses; 2% NULL keys (slot -1); 3% dead rows (slot -2)."""
    import torch
    from trino_tpu_torch.batch import Batch, Column
    from trino_tpu_torch.ops import hashtable as ht
    n, T = 4_000_000, 1 << 16
    sizes = (36_000, 24_000, 12_000, 6_000)
    tkeys, srcs, slots, keys = [], [], [], []
    dead = torch.rand(n, generator=g) < 0.03
    for d, m in enumerate(sizes):
        dim_keys = (torch.randperm(1 << 22, generator=g)[:m] * 7 + d).to(dev)
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        build = Batch((Column(dim_keys, ones),), ones)
        tkey, src, _dup, _esc = ht.build_join_table(build, (0,), T)
        if d == 0:
            h = int(ht.hash_slot(dim_keys[:1], T)[0])
            cands = torch.arange(1 << 40, (1 << 40) + (1 << 24),
                                 device=dev)
            crafted = cands[ht.hash_slot(cands, T) == h][:17]
            pos = (h + torch.arange(17, device=dev)) % T
            tkey[pos] = crafted
            src[pos] = 4_000_000 + torch.arange(17, device=dev)
        hit = torch.rand(n, generator=g) < 0.85
        fk = torch.where(
            hit.to(dev), dim_keys[torch.randint(0, m, (n,), generator=g)
                                  .to(dev)],
            torch.randint(1 << 30, 1 << 40, (n,), generator=g).to(dev))
        if d == 0:
            fk[:4096:2] = crafted[16]          # exhausts its chain
            fk[1:4096:2] = crafted[15]         # hits on the 16th probe
        null = (torch.rand(n, generator=g) < 0.02).to(dev)
        slot = torch.where(null, -1, ht.hash_slot(fk, T))
        slot = torch.where(dead.to(dev), -2, slot)
        slots.append(slot)
        keys.append(torch.where(slot >= 0, fk, 0))
        tkeys.append(tkey)
        srcs.append(src)
    return (torch.stack(slots), torch.stack(keys), torch.stack(tkeys),
            torch.stack(srcs))


def phase_k4(dev):
    import torch
    from trino_tpu_torch.ops import hashtable as ht
    g = torch.Generator().manual_seed(4)
    slot, key, tkey, src = _star_probe_inputs(dev, g)
    found, miss = ht.multiway_probe_slots(slot, key, tkey, src)
    found2, miss2 = ht.multiway_probe_plain(slot, key, tkey, src)
    torch.cuda.synchronize()
    require(torch.equal(found, found2), "K4 found differs from plain")
    require(torch.equal(miss, miss2), "K4 miss differs from plain")
    require(bool((found[0, :4096:2] == -1).all()),
            "K4: the exhausted chain did not miss")
    deep = slot[0, 1:4096:2] >= 0
    require(bool((found[0, 1:4096:2][deep] == 4_000_015).all()),
            "K4: the 16th probe did not hit")
    # the keys-in entry on the same rows: key columns as they lie (a NULL
    # key is an invalid row), the tables as planes and interleaved
    from trino_tpu_torch.batch import Batch, Column
    k = slot.shape[0]
    probe = Batch(tuple(Column(key[d], slot[d] >= 0) for d in range(k)),
                  slot[0] != -2)
    pairs = torch.stack((tkey, src), -1)
    for name, tk, sr in (("planes", tkey, src),
                         ("interleaved", pairs[..., 0], pairs[..., 1])):
        before = ht.multiway_probe.launches
        f3, m3 = ht.multiway_probe(probe, tk, sr,
                                   tuple((d,) for d in range(k)))
        torch.cuda.synchronize()
        require(ht.multiway_probe.launches == before + 1,
                "K4 keys-in took more than one launch")
        require(torch.equal(f3, found2) and torch.equal(m3, miss2),
                f"K4 keys-in ({name} tables) differs from plain")
    log(f"K4 check: found and miss bit-exact on n={slot.shape[1]} k="
        f"{slot.shape[0]} T={tkey.shape[1]}; misses per dim "
        f"{miss.tolist()}; fused hits "
        f"{int((found[-1] >= 0).sum())}; exhausted chain missed; the "
        f"keys-in entry equal on planes and on the interleaved table")


K5_SUMS = {"counts": (("count_star", None), ("count", 0)),
           "two sums": (("sum", 0), ("sum", 1)),
           "four sums": tuple(("sum", c) for c in range(4)),
           "eight sums": tuple(("sum", c) for c in range(8)),
           "mixed": (("sum", 0), ("count", 1), ("count_star", None),
                     ("sum", 2), ("sum", 3))}
K5_Q12 = (32_768, ("int32",), (7,), "two sums")
K5_FULL = (6_001_215, ("int32",), (16,), "eight sums")


def k5_inputs(dev, case, seed):
    """A direct aggregate's input on the card from a seed: (batch, key
    indices, domains, aggregates). Eight int64 value columns near
    +-2^58 with 10% NULLs, then the keys, drawn two past their domain on
    each side (the kernel clamps; an int64 key also carries high bits its
    int32 cast drops) with 5% NULLs; 5% of rows dead."""
    import torch
    from trino_tpu_torch.batch import Batch, Column
    from trino_tpu_torch.ops.aggregate import AggSpec
    n, dtypes, domains, aggs = case
    g = torch.Generator(device=dev).manual_seed(seed)

    def valid(frac):
        return torch.rand(n, generator=g, device=dev) >= frac
    cols = [Column(torch.randint(-(1 << 58), 1 << 58, (n,), generator=g,
                                 device=dev), valid(0.1)) for _ in range(8)]
    for dt, d in zip(dtypes, domains):
        key = torch.randint(-2, d + 2, (n,), generator=g, device=dev)
        if dt == "int64":
            key += torch.randint(0, 2, (n,), generator=g, device=dev) << 32
        cols.append(Column(key.to(getattr(torch, dt)), valid(0.05)))
    return (Batch(tuple(cols), valid(0.05)), tuple(range(8, len(cols))),
            tuple(domains), tuple(AggSpec(f, c) for f, c in K5_SUMS[aggs]))


def k5_sweep():
    """G = 1..16 over every key dtype, the aggregates cycling through
    counts, two, four and eight sums and a mix (A = 3 to 17); even G
    with two keys."""
    dts = ("int8", "int16", "int32", "int64")
    sets = ("counts", "two sums", "four sums", "eight sums", "mixed")
    for g in range(1, 17):
        keys = ((dts[g % 4],), (g,)) if g % 2 else \
            ((dts[g % 4], dts[(g + 1) % 4]), (2, g // 2))
        yield (100_003 + g, keys[0], keys[1], sets[g % 5])


def phase_k5(dev):
    import torch
    from test_torch_k5_cases import same_batch
    from trino_tpu_torch.ops import direct_agg as k5
    cases = [K5_Q12, K5_FULL, *k5_sweep()]
    for i, case in enumerate(cases):
        args = k5_inputs(dev, case, 50 + i)
        before = k5.direct_group_aggregate_mxu.launches
        got = k5.direct_group_aggregate_mxu(*args)
        want = k5.direct_group_aggregate_mxu_plain(*args)
        torch.cuda.synchronize()
        require(k5.direct_group_aggregate_mxu.launches == before + 1,
                f"K5 took other than one launch on {case}")
        require(same_batch(got, want), f"K5 differs from plain on {case}")
        if case is K5_FULL:
            gid, planes = k5.group_lanes(*args)
            lib = torch.zeros((17, planes.shape[0]), dtype=torch.int64,
                              device=dev)
            lib.index_add_(0, gid.long(), planes.T)
            require(all(torch.equal(c.data, lib[:16, 1 + 2 * j]) for j, c in
                        enumerate(got.columns[1:])),
                    "K5 differs from index_add_")
    log(f"K5 check: bit-exact with plain on {len(cases)} cases (q12's "
        f"shape, {K5_FULL[0]} rows at G = 16 with eight sums, G = 1..16 "
        f"over int8..int64 keys), the sums with index_add_ too")


def _strategy_lines(session, sql):
    rows = session.execute("EXPLAIN " + sql).rows
    return [r[0] for r in rows if r[0].startswith(("agg strategy",
                                                   "join strategy"))]


def _counters():
    from trino_tpu_torch.e2e import kernel_counters
    return kernel_counters()


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _timed_runs(session, sql, runs):
    import torch
    walls, rows = [], None
    for _ in range(runs):
        t = time.monotonic()
        res = session.execute(sql)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t)
        require(rows is None or res.rows == rows,
                "a rerun returned other rows")
        rows = res.rows
    return rows, walls


def _host_profile(session, sql, top=15):
    """One more run of `sql` under cProfile (uncounted; the profiler slows
    Python-heavy code more than torch calls): its wall and the `top`
    functions by cumulative host seconds, as [file:function, s, calls]."""
    import cProfile
    import pstats
    import torch
    pr = cProfile.Profile()
    t = time.monotonic()
    pr.enable()
    session.execute(sql)
    torch.cuda.synchronize()
    pr.disable()
    wall = time.monotonic() - t
    stats = pstats.Stats(pr).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][3])[:top]
    return {"wall_s": wall, "top": [
        [f"{os.path.basename(f)}:{fn}", round(ct, 4), nc]
        for (f, _line, fn), (_cc, nc, _tt, ct, _callers) in rows]}


def _profiled_run(session, sql):
    """One run of `sql` under torch.profiler: (result, wall s, the
    device activities as (name, us))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        res = session.execute(sql)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
    return res, wall, _device_activities(prof)


def _device_profile(session, sql, top=8):
    """One more steady run of `sql` under torch.profiler (uncounted): its
    wall, the card's busy time (every kernel, memset and memcpy summed;
    the port runs on one stream, so they do not overlap), the idle share
    1 - busy / wall, the torch elementwise kernels' ms and count, the
    device-to-host copies, and the `top` activities by device ms."""
    _res, wall, acts = _profiled_run(session, sql)
    parts = {}
    for name, us in acts:
        n, total = parts.get(name[:50], (0, 0.0))
        parts[name[:50]] = (n + 1, total + us)
    busy_ms = sum(us for _n, us in parts.values()) / 1e3
    elem = [us for name, us in acts if "elementwise" in name]
    ranked = sorted(parts.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": round(wall * 1e3, 4), "device_busy_ms":
            round(busy_ms, 4), "idle_share": round(1 - busy_ms /
                                                   (wall * 1e3), 4),
            "elementwise_ms": round(sum(elem) / 1e3, 4),
            "elementwise_launches": len(elem),
            "dtoh_copies": sum(1 for name, _us in acts
                               if name.startswith("Memcpy DtoH")),
            "top": [[k, n, round(us / 1e3, 4)] for k, (n, us) in ranked]}


def phase_tpch_path(recorder):
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.ops import gather as k1
    from trino_tpu_torch.ops import hashtable as ht
    t0 = time.monotonic()
    session = Session(default_schema=TPCH_SCHEMA)
    require(session.device.type == "cuda", "Session() is not on cuda")
    conn = session.catalog.connector("tpch")
    tables = {t: conn.get_table(TPCH_SCHEMA, t)
              for t in ("customer", "orders", "lineitem")}
    log(f"tpch.{TPCH_SCHEMA} ready in {time.monotonic() - t0:.1f} s "
        f"(lineitem {tables['lineitem'].num_rows} rows)")
    expected = {"q1": oracle_q1(tables["lineitem"]),
                "q6": oracle_q6(tables["lineitem"]),
                "q3": oracle_q3(tables["customer"], tables["orders"],
                                tables["lineitem"])}
    reset_counts()
    recorder.active = True
    per_query = {}
    for name, sql in (("q1", Q1), ("q6", Q6), ("q3", Q3)):
        before = (k1.gather_columns.launches,
                  ht.hash_insert_multi.launches)
        rows, walls = _timed_runs(session, sql, 4)
        require(rows == expected[name],
                f"{name} differs from the numpy oracle:\n{rows[:3]}\nvs\n"
                f"{expected[name][:3]}")
        per_query[name] = {
            "cold_s": walls[0], "steady_median_s": statistics.median(
                walls[1:]),
            "k1_launches": k1.gather_columns.launches - before[0],
            "k3_launches": ht.hash_insert_multi.launches - before[1],
            "strategy": dict(session.executor.strategy_decisions)}
        log(f"{name}: {len(rows)} rows match the oracle; cold "
            f"{walls[0]:.4f} s, steady median "
            f"{per_query[name]['steady_median_s']:.4f} s (runs "
            f"{[round(w, 4) for w in walls]}); launches K1 "
            f"{per_query[name]['k1_launches']} K3 "
            f"{per_query[name]['k3_launches']}; ran "
            f"{per_query[name]['strategy']}")
        log(f"{name} EXPLAIN: {_strategy_lines(session, sql)}")
    # per-node device-synchronised times of one more q3 run
    for row in session.execute("EXPLAIN ANALYZE " + Q3).rows:
        log("q3 EXPLAIN ANALYZE | " + row[0])
    recorder.active = False
    launches = read_counts()
    require(per_query["q3"]["k1_launches"] > 0, "q3 did not launch K1")
    require(per_query["q3"]["k3_launches"] > 0, "q3 did not launch K3")
    log("tpch path: " + json.dumps({"queries": per_query,
                                     "launches": launches}))
    return session, tables, launches


def phase_tpcds_path(recorder):
    """TPC-DS star queries at sf1 through the fused multiway probe."""
    from tpcds_queries import QUERIES
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.ops import hashtable as ht
    t0 = time.monotonic()
    session = Session(default_cat="tpcds", default_schema=TPCDS_SCHEMA)
    conn = session.catalog.connector("tpcds")
    names = ("store_sales", "date_dim", "item", "customer_demographics",
             "promotion", "household_demographics", "time_dim", "store")
    tables = {t: conn.get_table(TPCDS_SCHEMA, t) for t in names}
    log(f"tpcds.{TPCDS_SCHEMA} ready in {time.monotonic() - t0:.1f} s "
        f"(store_sales {tables['store_sales'].num_rows} rows, item "
        f"{tables['item'].num_rows}, customer "
        f"{conn.get_table(TPCDS_SCHEMA, 'customer').num_rows})")
    expected = {3: oracle_ds_q3(tables), 7: oracle_ds_q7(tables),
                96: oracle_ds_q96(tables)}
    reset_counts()
    recorder.active = True
    per_query, fused_rows = {}, {}
    for q in STAR_QUERIES:
        sql = QUERIES[q]
        before = ht.multiway_probe.launches
        fused_before = session.executor.stats.multijoin_fused_probes
        degrades_before = dict(
            session.executor.stats.multijoin_degrade_reasons)
        rows, walls = _timed_runs(session, sql, 4)
        ran = dict(session.executor.strategy_decisions)
        k4 = ht.multiway_probe.launches - before
        require(ran.get("MultiJoinNode", "").startswith("multiway[k="),
                f"ds q{q} did not run a fused multiway join: {ran}")
        require(session.executor.stats.multijoin_fused_probes -
                fused_before == 4 and k4 == 4,
                f"ds q{q}: {k4} K4 launches in 4 runs")
        if q in expected:
            require(rows == expected[q],
                    f"ds q{q} differs from the numpy oracle:\n{rows[:3]}"
                    f"\nvs\n{expected[q][:3]}")
        fused_rows[q] = rows
        per_query[f"ds_q{q}"] = {
            "rows": len(rows), "cold_s": walls[0],
            "steady_median_s": statistics.median(walls[1:]),
            "k4_launches": k4, "strategy": ran,
            "degrades": {
                r: c - degrades_before.get(r, 0) for r, c in
                session.executor.stats.multijoin_degrade_reasons.items()
                if c != degrades_before.get(r, 0)}}
        log(f"ds q{q}: {len(rows)} rows"
            f"{' equal the numpy oracle' if q in expected else ''}; cold "
            f"{walls[0]:.4f} s, steady median "
            f"{per_query[f'ds_q{q}']['steady_median_s']:.4f} s (runs "
            f"{[round(w, 4) for w in walls]}); K4 launches {k4}; ran "
            f"{ran}; degrades {per_query[f'ds_q{q}']['degrades']}")
        log(f"ds q{q} EXPLAIN: {_strategy_lines(session, sql)}")
    for row in session.execute("EXPLAIN ANALYZE " + QUERIES[7]).rows:
        log("ds q7 EXPLAIN ANALYZE | " + row[0])
    recorder.active = False
    launches = read_counts()
    require(launches["K4"] > 0, "the star path did not launch K4")
    log("tpcds path: " + json.dumps({"queries": per_query,
                                      "launches": launches,
                                      "degrades": dict(
        session.executor.stats.multijoin_degrade_reasons)}))
    # the pairwise ladder on the card, run after the counts were read so
    # that its K1/K3 launches are not counted as the star path's
    session.execute("SET SESSION enable_multiway_join = 'false'")
    for q in STAR_QUERIES:
        require(session.execute(QUERIES[q]).rows == fused_rows[q],
                f"ds q{q} fused differs from the ladder")
    session.execute("SET SESSION enable_multiway_join = 'auto'")
    log(f"tpcds ladder: q{', q'.join(map(str, STAR_QUERIES))} fused rows "
        f"equal the pairwise ladder (enable_multiway_join = 'false')")
    return launches, session, tables, expected, per_query


def phase_device_profiles(session, ds_session):
    """One more steady run each of TPC-H q3 and TPC-DS q3 and q19 under
    torch.profiler, after every main path's walls were taken (a profiler
    session can leave tracing hooks that slow later launches). Each is
    run once before, unprofiled: the chunked and streaming paths evicted
    their columns from the scan cache."""
    from tpcds_queries import QUERIES
    for name, sess, sql in (("q3", session, Q3),
                            ("ds q3", ds_session, QUERIES[3]),
                            ("ds q19", ds_session, QUERIES[19])):
        sess.execute(sql)
        log(f"{name} device profile (one more steady run): "
            + json.dumps(_device_profile(sess, sql)))


def phase_q12_path(recorder, session, tables):
    """TPC-H q12 at sf1 through the direct-aggregation arm's K5."""
    from tpch_full import QUERIES
    from trino_tpu_torch.ops import direct_agg as k5
    orders = session.catalog.connector("tpch").get_table(TPCH_SCHEMA,
                                                         "orders")
    expected = oracle_q12(orders, tables["lineitem"])
    sql = QUERIES[12]
    session.execute("SET SESSION mxu_agg = 'false'")
    plain_rows = session.execute(sql).rows
    session.execute("SET SESSION mxu_agg = 'auto'")
    before = k5.direct_group_aggregate_mxu.launches
    auto_rows = session.execute(sql).rows
    require(k5.direct_group_aggregate_mxu.launches == before and
            session.executor.strategy_decisions["AggregateNode"] ==
            "direct", "q12 took K5 under mxu_agg = auto (7 groups)")
    session.execute("SET SESSION mxu_agg = 'true'")
    reset_counts()
    recorder.active = True
    rows, walls = _timed_runs(session, sql, 4)
    recorder.active = False
    launches = read_counts()
    session.execute("SET SESSION mxu_agg = 'auto'")
    require(rows == expected, f"q12 differs from the numpy oracle:\n"
            f"{rows}\nvs\n{expected}")
    require(rows == plain_rows == auto_rows,
            "q12 under mxu_agg = true differs from false/auto")
    require(launches["K5"] == 4, f"q12 launched K5 {launches['K5']} "
            f"times in 4 runs")
    log(f"q12 (mxu_agg = true): {len(rows)} rows match the oracle and the "
        f"false/auto runs; cold {walls[0]:.4f} s, steady median "
        f"{statistics.median(walls[1:]):.4f} s (runs "
        f"{[round(w, 4) for w in walls]}); launches {launches}")
    return launches


def _chunk_counters(ex):
    st = ex.stats
    return {k: getattr(st, k) for k in (
        "fused_chunk_pipelines", "fact_cache_chunks", "agg_spill_chunks",
        "escaped_window_reruns", "chunk_lut_joins", "streamed_build_joins")}


def phase_chunked_path(recorder, session, tables):
    """TPC-H q1, q6, q12 and q3 at sf1 through the chunked driver
    (lineitem in 6 chunks of CHUNK_ROWS), four runs each in one session:
    the first plain and recording, the later ones adapted. Each query's
    unchunked wall is measured first, outside the counted run."""
    import torch
    from tpch_full import QUERIES
    from trino_tpu_torch.ops import gather as k1
    from trino_tpu_torch.ops import hashtable as ht
    orders = session.catalog.connector("tpch").get_table(TPCH_SCHEMA,
                                                         "orders")
    li = tables["lineitem"]
    chunks = -(-li.num_rows // CHUNK_ROWS)
    queries = (("q1", Q1, oracle_q1(li)), ("q6", Q6, oracle_q6(li)),
               ("q12", QUERIES[12], oracle_q12(orders, li)),
               ("q3", Q3, oracle_q3(tables["customer"], orders, li)))
    unchunked = {}
    for name, sql, _ in queries:
        rows, walls = _timed_runs(session, sql, 2)
        unchunked[name] = walls
    session.execute(f"SET SESSION spill_chunk_rows = {CHUNK_ROWS}")
    ex = session.executor
    reset_counts()
    recorder.active = True
    per_query = {}
    for name, sql, expected in queries:
        before_c = _chunk_counters(ex)
        k2_runs, k3_before = [], ht.hash_insert_multi.launches
        walls, rows = [], None
        for run in range(4):
            k2_before = k1.gather_word_windowed.launches
            t = time.monotonic()
            res = session.execute(sql)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t)
            k2_runs.append(k1.gather_word_windowed.launches - k2_before)
            require(res.rows == expected, f"chunked {name} run {run} "
                    f"differs from the numpy oracle:\n{res.rows[:3]}\nvs"
                    f"\n{expected[:3]}")
            rows = res.rows
        c = {k: v - before_c[k] for k, v in _chunk_counters(ex).items()}
        require(c["agg_spill_chunks"] == 4 * chunks,
                f"chunked {name}: {c['agg_spill_chunks']} chunks in 4 runs")
        require(c["escaped_window_reruns"] == 0,
                f"chunked {name}: a window rerun fired")
        if name == "q12":
            require(c["fused_chunk_pipelines"] > 0 and
                    c["fact_cache_chunks"] > 0,
                    f"chunked q12 did not run fused from the fact cache: {c}")
            require(k2_runs == [0] + [chunks] * 3,
                    f"chunked q12: K2 launches per run {k2_runs}, want 0 "
                    f"then {chunks} per adapted run")
        if name == "q3":
            require(ht.hash_insert_multi.launches > k3_before,
                    "chunked q3 did not launch K3")
        per_query[name] = {
            "rows": len(rows), "cold_s": walls[0],
            "steady_median_s": statistics.median(walls[1:]),
            "unchunked_cold_s": unchunked[name][0],
            "unchunked_steady_s": unchunked[name][1],
            "k2_launches_per_run": k2_runs, "counters": c,
            "last_run_chunk_spans": dict(ex.chunk_spans),
            "strategy": dict(ex.strategy_decisions)}
        log(f"chunked {name}: {len(rows)} rows match the oracle on all 4 "
            f"runs; cold {walls[0]:.4f} s, steady median "
            f"{per_query[name]['steady_median_s']:.4f} s (runs "
            f"{[round(w, 4) for w in walls]}); unchunked "
            f"{unchunked[name][0]:.4f} / {unchunked[name][1]:.4f} s; K2 per "
            f"run {k2_runs}; {c}")
    recorder.active = False
    launches = read_counts()
    # where a steady chunked run's host time goes, for q12 (fused, K2) and
    # q3 (the per-node loop), run after the counts are read
    for name, sql, _ in queries:
        if name in ("q12", "q3"):
            log(f"chunked {name} host profile: "
                + json.dumps(_host_profile(session, sql)))
    session.execute("SET SESSION spill_chunk_rows = 0")
    adapt = {str(v) for k, v in ex._decision_cache.items()
             if k[0] == "fusedadapt"}
    log("chunked tpch path: " + json.dumps({
        "chunk_rows": CHUNK_ROWS, "chunks": chunks, "queries": per_query,
        "fusedadapt_records": sorted(adapt), "launches": launches}))
    return launches


def phase_ds_chunked(recorder, session, tables, expected, unchunked):
    """TPC-DS q7 at sf1 through the chunked driver: store_sales in 12
    chunks, the star re-probed per chunk through K4 with the dimension
    tables pinned by the chunk-mode caches."""
    from tpcds_queries import QUERIES
    ss = tables["store_sales"].num_rows
    chunks = -(-ss // CHUNK_ROWS)
    session.execute(f"SET SESSION spill_chunk_rows = {CHUNK_ROWS}")
    reset_counts()
    recorder.active = True
    rows, walls = _timed_runs(session, QUERIES[7], 2)
    recorder.active = False
    launches = read_counts()
    ran = dict(session.executor.strategy_decisions)
    session.execute("SET SESSION spill_chunk_rows = 0")
    require(rows == expected[7], "chunked ds q7 differs from the oracle")
    require(launches["K4"] == 2 * chunks,
            f"chunked ds q7: {launches['K4']} K4 launches in 2 runs of "
            f"{chunks} chunks")
    log(f"chunked ds q7: {len(rows)} rows equal the numpy oracle; "
        f"{chunks} chunks; cold {walls[0]:.4f} s, steady {walls[1]:.4f} s "
        f"(unchunked {unchunked['ds_q7']['cold_s']:.4f} / "
        f"{unchunked['ds_q7']['steady_median_s']:.4f} s); ran {ran}; "
        f"launches {launches}")
    return launches


def phase_stream_build(recorder, session):
    """One join whose build side (a Scan of customer) streams through the
    dense LUT in 65,536-row chunks (`stream_build_min_kb = 1`); its TopN
    keeps the chunked driver out of the plan."""
    conn = session.catalog.connector("tpch")
    expected = oracle_stream(conn.get_table(TPCH_SCHEMA, "orders"),
                             conn.get_table(TPCH_SCHEMA, "customer"))
    plan = [r[0] for r in session.execute("EXPLAIN " + STREAM_SQL).rows]
    session.execute("SET SESSION stream_build_min_kb = 1")
    session.execute("SET SESSION spill_chunk_rows = 65536")
    before = session.executor.stats.streamed_build_joins
    reset_counts()
    recorder.active = True
    rows, walls = _timed_runs(session, STREAM_SQL, 2)
    recorder.active = False
    launches = read_counts()
    streamed = session.executor.stats.streamed_build_joins - before
    session.execute("SET SESSION stream_build_min_kb = 0")
    session.execute("SET SESSION spill_chunk_rows = 0")
    require(rows == expected, "the streaming-build query differs from the "
            f"oracle:\n{rows[:3]}\nvs\n{expected[:3]}")
    require(streamed == 2, f"streaming_build_join ran {streamed} times in "
            "2 runs")
    log(f"streaming build: {len(rows)} rows equal the numpy oracle; "
        f"streamed {streamed} builds; walls {[round(w, 4) for w in walls]}"
        f"; plan {[ln.strip()[:60] for ln in plan if 'Join' in ln or 'Scan' in ln]}")
    return launches


CORPUS_TPCH = (4, 21, 22)
CORPUS_TPCDS = (12, 38, 86)
UNNEST_SQL = ("SELECT x, o FROM UNNEST(ARRAY[30, 10, 20, NULL]) "
              "WITH ORDINALITY AS t(x, o)")


class JoinLog:
    """The strategy each semi, anti and mark join ran with, in call order:
    the executor's own verdict inside run_membership_join and
    run_mark_join (dense-lut, hybrid-hash, sorted), `residual` where the
    join_mark expansion decided, `null-aware` where NOT IN's NULL check
    emptied the result; mark joins note no verdict, so theirs is read
    from the domain and the domain-fallback counter."""

    def __init__(self):
        self.calls = []
        self._stack = []

    def install(self):
        from trino_tpu_torch.exec.executor import Executor
        jlog = self
        real_note = Executor._note_strategy

        def note(ex, op, strategy, kind):
            if jlog._stack and op == "JoinNode":
                jlog._stack[-1].append(strategy)
            return real_note(ex, op, strategy, kind)
        Executor._note_strategy = note

        def wrap(real):
            def run(ex, node, probe, build):
                jlog._stack.append([])
                fallbacks = ex.stats.join_domain_fallbacks
                try:
                    return real(ex, node, probe, build)
                finally:
                    noted = jlog._stack.pop()
                    if noted:
                        what = noted[-1]
                    elif node.residual is not None:
                        what = "residual"
                    elif node.kind != "mark":
                        what = "null-aware"
                    elif node.build_key_domain is not None and \
                            ex.stats.join_domain_fallbacks == fallbacks:
                        what = "dense-lut"
                    else:
                        what = "sorted"
                    jlog.calls.append(f"{node.kind}:{what}")
            return run
        for method in ("run_membership_join", "run_mark_join"):
            setattr(Executor, method, wrap(getattr(Executor, method)))


def _corpus_run(recorder, jlog, session, name, sql, expected=None):
    """One corpus path: counters to 0, one cold and three steady runs,
    counters read; rows against `expected` where given. Returns (rows,
    launches, record)."""
    from collections import Counter
    reset_counts()
    jlog.calls = []
    recorder.active, recorder.keep = True, False
    try:
        rows, walls = _timed_runs(session, sql, 4)
    finally:
        recorder.active, recorder.keep = False, True
    launches = read_counts()
    joins = dict(Counter(jlog.calls))
    if expected is not None:
        require(rows == expected, f"{name} differs from the numpy oracle:"
                f"\n{rows[:3]}\nvs\n{expected[:3]}")
    if any(j.endswith((":dense-lut", ":hybrid-hash")) for j in joins):
        require(launches["K1"] > 0, f"{name}: a dense-LUT or hash "
                f"membership join ran without K1 ({joins})")
    if any(j.endswith(":hybrid-hash") for j in joins):
        require(launches["K3"] > 0, f"{name}: a hash membership join ran "
                f"without K3 ({joins})")
    record = {"rows": len(rows), "cold_s": walls[0],
              "steady_median_s": statistics.median(walls[1:]),
              "steady_s": walls[1:], "launches": launches,
              "membership_joins_4_runs": joins,
              "strategy": dict(session.executor.strategy_decisions)}
    log(f"{name}: {len(rows)} rows"
        f"{' equal the numpy oracle' if expected is not None else ''}; "
        f"cold {walls[0]:.4f} s, steady median "
        f"{record['steady_median_s']:.4f} s (runs "
        f"{[round(w, 4) for w in walls]}); launches {launches}; semi/anti/"
        f"mark joins over 4 runs {joins}; ran {record['strategy']}")
    return rows, launches, record


def phase_corpus_paths(recorder, session, tables, ds_session):
    """The corpus paths this port added last: TPC-H q4 (semi join, K1),
    q21 (semi and anti joins with the <> residual, join_mark) and q22
    (anti join and a scalar subquery) at tpch.sf1, and TPC-DS q12 (window
    sum), q38 (INTERSECT) and q86 (ROLLUP and rank) at tpcds.sf1, each
    with the counters set to 0 just before and read just after; then the
    reference-order cumsum on the card against its CPU bits, and an
    UNNEST on the card against the CPU."""
    import numpy as np
    import torch
    from tpcds_queries import QUERIES as DS
    from tpch_full import QUERIES as H
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.ops.aggregate import cumsum_like_reference
    jlog = JoinLog()
    jlog.install()
    conn = session.catalog.connector("tpch")
    t = dict(tables)
    for name in ("supplier", "nation", "orders"):
        t[name] = conn.get_table(TPCH_SCHEMA, name)
    expected = {4: oracle_q4(t["orders"], t["lineitem"]),
                21: oracle_q21(t["supplier"], t["nation"], t["orders"],
                               t["lineitem"]),
                22: oracle_q22(t["customer"], t["orders"])}
    total = {k: 0 for k in _counters()}
    records = {}
    for q in CORPUS_TPCH:
        _rows, launches, records[f"q{q}"] = _corpus_run(
            recorder, jlog, session, f"corpus q{q}", H[q], expected[q])
        for k, v in launches.items():
            total[k] += v
    # where the slowest corpus queries' time goes, after their counts
    # were read: host cProfile of q21 and q22, the card's share of q21
    for q in (21, 22):
        records[f"q{q}"]["host_profile"] = _host_profile(session, H[q], 12)
        log(f"corpus q{q} host profile (one more steady run): "
            + json.dumps(records[f"q{q}"]["host_profile"]))
    records["q21"]["device_profile"] = _device_profile(session, H[21])
    log("corpus q21 device profile (one more steady run): "
        + json.dumps(records["q21"]["device_profile"]))
    require(records["q4"]["launches"]["K1"] > 0, "q4 did not launch K1")
    require(any(j.startswith(("semi:", "anti:")) for r in records.values()
                for j in r["membership_joins_4_runs"]),
            "no semi or anti join ran on the TPC-H corpus paths")

    dconn = ds_session.catalog.connector("tpcds")
    dt = {n: dconn.get_table(TPCDS_SCHEMA, n) for n in (
        "web_sales", "catalog_sales", "store_sales", "item", "date_dim",
        "customer")}
    ds_expected = {12: oracle_ds_q12(dt), 38: oracle_ds_q38(dt)}
    for q in CORPUS_TPCDS:
        rows, launches, records[f"ds_q{q}"] = _corpus_run(
            recorder, jlog, ds_session, f"corpus ds q{q}", DS[q],
            ds_expected[38] if q == 38 else None)
        for k, v in launches.items():
            total[k] += v
        if q == 12:
            want = ds_expected[12]
            require([r[:6] for r in rows] == [w[:6] for w in want],
                    "ds q12 differs from the numpy oracle")
            err = max(abs(r[6] - w[6]) / abs(w[6]) for r, w in
                      zip(rows, want))
            require(err <= 1e-12, f"ds q12 revenueratio off by {err}")
            log(f"ds q12: {len(rows)} rows equal the numpy oracle, "
                f"revenueratio within rel {err:.3g} (1e-12 allowed)")
        if q == 86:
            cpu = Session(ds_session.catalog, default_cat="tpcds",
                          default_schema=TPCDS_SCHEMA, device="cpu")
            t0 = time.monotonic()
            want = cpu.execute(DS[86]).rows
            cpu_s = time.monotonic() - t0
            require(rows == want, "ds q86 on the card differs from the "
                    "port's CPU Session")
            records["ds_q86"]["cpu_session_s"] = cpu_s
            log(f"ds q86: {len(rows)} rows equal the port's "
                f"Session(device='cpu') over the same tables ({cpu_s:.4f}"
                f" s there)")

    records["ds_q38"]["device_profile"] = _device_profile(ds_session,
                                                          DS[38])
    log("corpus ds q38 device profile (one more steady run): "
        + json.dumps(records["ds_q38"]["device_profile"]))

    # the reference-order cumsum: the card's bits are the CPU's
    x = np.random.default_rng(7).standard_normal(6_000_000) * \
        np.random.default_rng(8).integers(1, 10 ** 6, 6_000_000)
    xc = torch.from_numpy(x).cuda()
    got = cumsum_like_reference(xc).cpu().numpy()
    want = cumsum_like_reference(torch.from_numpy(x)).numpy()
    require(got.view(np.int64).tobytes() == want.view(np.int64).tobytes(),
            "cumsum_like_reference: card bits differ from the CPU's")
    plain = torch.cumsum(xc, 0).cpu().numpy()
    cum = {"n": len(x), "bits_equal_cpu": True,
           "ms": time_cuda(lambda: cumsum_like_reference(xc)),
           "torch_cumsum_ms": time_cuda(lambda: torch.cumsum(xc, 0)),
           "activities_per_call": activities_per_call(
               lambda: cumsum_like_reference(xc)),
           "torch_cumsum_activities": activities_per_call(
               lambda: torch.cumsum(xc, 0)),
           "torch_cumsum_prefixes_differing": int(
               (plain.view(np.int64) != want.view(np.int64)).sum()),
           "bound_ms": 2 * x.nbytes / HBM_BYTES_PER_S * 1e3}
    log("cumsum_like_reference on the card: " + json.dumps(cum))

    cpu = Session(device="cpu")
    got = session.execute(UNNEST_SQL).rows
    require(got == cpu.execute(UNNEST_SQL).rows and len(got) == 4,
            "UNNEST on the card differs from the CPU")
    log(f"unnest: {got} on the card equals the CPU")
    log("corpus paths: " + json.dumps({"queries": records,
                                        "launches": total,
                                        "cumsum": cum}))
    return total


# every kernel forced on: the corpus phase's third run of each query
FORCED = {"enable_pallas_gather": "true", "enable_pallas_hash": "true",
          "enable_multiway_join": "true", "mxu_agg": "true"}
# the query that K2 runs in: its adapted chunked runs (the second on)
CORPUS_CHUNKED = 12


def _corpus_rows(session, sql, props=None):
    """One run of `sql` (under `props` where given, restored after): its
    rows and wall."""
    import torch
    saved = {k: session.properties[k] for k in props or {}}
    session.properties.update(props or {})
    try:
        t = time.monotonic()
        rows = session.execute(sql).rows
        torch.cuda.synchronize()
        return rows, time.monotonic() - t
    finally:
        session.properties.update(saved)


def _corpus_mismatch(session, schema, suite, sql, rows, want, label):
    """What a run that differs from the reference's rows looks like: the
    first canonical row that differs from the reference's head rows,
    beside the port's CPU Session's answer over the same tables."""
    import torch_corpus as tc
    from trino_tpu_torch.exec.session import Session
    cpu = Session(session.catalog, default_cat=suite, default_schema=schema,
                  device="cpu")
    cpu_sum = tc.summary(sql, cpu.execute(sql).rows)
    got = tc.summary(sql, rows)
    first = tc.first_difference(sql, rows, want.get("head", []))
    return (f"{label}: {got['rows']} rows (sha256 {got['sha256'][:12]}) "
            f"against the reference's {want.get('rows')} "
            f"({want.get('sha256', '')[:12]}); first differing row "
            f"{first if first else 'past the reference head'}; "
            f"card head {got['head']}; reference head {want.get('head')}; "
            f"port CPU Session {cpu_sum['rows']} rows (sha256 "
            f"{cpu_sum['sha256'][:12]}, equal to the reference: "
            f"{cpu_sum['sha256'] == want.get('sha256')}) head "
            f"{cpu_sum['head']}")


def phase_corpus_card(recorder, session, ds_session):
    """The whole SQL corpus on the card: all 22 TPC-H queries over
    tpch.sf1 and all 99 TPC-DS queries over tpcds.sf1 through the two
    cuda Sessions, each held against the reference's rows in
    tests/torch_corpus_sf1.json (tools/corpus_reference.py), doubles to
    the last bit. First every generated table's digest against the
    file's; then, for each query with the counters set to 0 just before
    and read just after, two runs under `auto` and one with every kernel
    forced on (FORCED): each run's canonical rows equal the reference's
    (a query the reference did not answer at sf1 is held against the
    port CPU Session's answer, which the file keeps as `port_cpu`), the
    two `auto` runs equal each other; then TPC-H q12 chunked twice
    (spill_chunk_rows = CHUNK_ROWS; the adapted runs' joins go through
    K2) against the reference too.
    Each of K1-K5 must launch in the phase. Every difference is printed
    with the port CPU Session's rows beside it, and then the run fails."""
    import torch_corpus as tc
    ref = tc.load()
    t0 = time.monotonic()
    for suite, s, schema in (("tpch", session, TPCH_SCHEMA),
                             ("tpcds", ds_session, TPCDS_SCHEMA)):
        require(schema == ref["schema"], f"the file holds {ref['schema']} "
                f"rows, the {suite} Session runs {schema}")
        conn = s.catalog.connector(suite)
        for name, want in sorted(ref["tables"][suite].items()):
            require(tc.table_digest(conn.get_table(schema, name)) == want,
                    f"{suite}.{schema}.{name}: generated data differs "
                    f"from the reference's")
    log(f"corpus on the card: {sum(map(len, ref['tables'].values()))} "
        f"generated tables equal the reference's digests "
        f"({time.monotonic() - t0:.1f} s)")
    total = {k: 0 for k in _counters()}
    records, mismatches = {}, []
    for suite, s, schema in (("tpch", session, TPCH_SCHEMA),
                             ("tpcds", ds_session, TPCDS_SCHEMA)):
        queries = tc.suite_queries(suite)
        for q in sorted(queries):
            sql, key = queries[q], tc.key(suite, q)
            want = ref["queries"][key]
            if "error" in want:
                # the reference did not answer at sf1: the port CPU
                # Session's answer, kept in the file by the same tool
                want = dict(want["port_cpu"],
                            held_against="port CPU Session")
            reset_counts()
            recorder.active, recorder.keep = True, False
            try:
                runs = [_corpus_rows(s, sql), _corpus_rows(s, sql)]
                auto_ran = dict(s.executor.strategy_decisions)
                runs.append(_corpus_rows(s, sql, FORCED))
                forced_ran = dict(s.executor.strategy_decisions)
            except Exception as e:      # counted as a difference below
                mismatches.append(f"{key}: raised {type(e).__name__}: {e}")
                log("CORPUS MISMATCH " + mismatches[-1])
                continue
            finally:
                recorder.active, recorder.keep = False, True
            launches = read_counts()
            for k, v in launches.items():
                total[k] += v
            digests = [tc.summary(sql, rows)["sha256"] for rows, _ in runs]
            for label, d, (rows, _) in zip(("auto 1", "auto 2", "forced"),
                                           digests, runs):
                if d != want["sha256"]:
                    mismatches.append(_corpus_mismatch(
                        s, schema, suite, sql, rows, want,
                        f"{key} {label}"))
                    log("CORPUS MISMATCH " + mismatches[-1])
            if digests[0] != digests[1]:
                mismatches.append(f"{key}: the two auto runs differ")
            records[key] = {
                "rows": len(runs[0][0]), "walls_s": [w for _, w in runs],
                "launches": launches, "auto": auto_ran,
                "forced": forced_ran}
            held = want.get("held_against")
            if held:
                records[key]["held_against"] = held
            log(f"corpus card {key}: {len(runs[0][0])} rows; auto "
                f"{runs[0][1]:.4f} s, {runs[1][1]:.4f} s; forced "
                f"{runs[2][1]:.4f} s; launches {launches}; auto ran "
                f"{auto_ran}; forced ran {forced_ran}"
                + (f"; held against the {held}" if held else ""))

    # K2 runs only in the chunked driver's adapted runs
    sql, key = tc.suite_queries("tpch")[CORPUS_CHUNKED], \
        tc.key("tpch", CORPUS_CHUNKED)
    session.execute(f"SET SESSION spill_chunk_rows = {CHUNK_ROWS}")
    reset_counts()
    recorder.active, recorder.keep = True, False
    try:
        runs = [_corpus_rows(session, sql), _corpus_rows(session, sql)]
    finally:
        recorder.active, recorder.keep = False, True
        session.execute("SET SESSION spill_chunk_rows = 0")
    launches = read_counts()
    for k, v in launches.items():
        total[k] += v
    for label, (rows, _) in zip(("chunked 1", "chunked 2"), runs):
        if tc.summary(sql, rows)["sha256"] != ref["queries"][key]["sha256"]:
            mismatches.append(_corpus_mismatch(
                session, TPCH_SCHEMA, "tpch", sql, rows,
                ref["queries"][key], f"{key} {label}"))
            log("CORPUS MISMATCH " + mismatches[-1])
    records[key + " chunked"] = {"rows": len(runs[0][0]),
                                 "walls_s": [w for _, w in runs],
                                 "launches": launches}
    log(f"corpus card {key} chunked ({CHUNK_ROWS} rows a chunk): "
        f"{runs[0][1]:.4f} s, {runs[1][1]:.4f} s; launches {launches}")
    log("corpus on the card: " + json.dumps({"queries": records,
                                              "launches": total}))
    # the largest joins' blocks back to the card for the later phases'
    # child processes
    import torch
    torch.cuda.empty_cache()
    require(not mismatches, f"{len(mismatches)} corpus runs differ from "
            f"the reference: " + " | ".join(mismatches[:5]))
    missing = [k for k, v in total.items() if v == 0]
    require(not missing, f"corpus on the card: {missing} never launched")
    log(f"corpus on the card: {len(records) - 1} queries, 3 runs each, "
        f"equal the reference's rows; launches {total}")
    return total


# --------------------------------------------------------------------------
# the write path: DDL and DML on the memory connector, the file connectors
# --------------------------------------------------------------------------

WRITE_TABLES = ("lineitem", "orders", "customer")
# the file tables hold orders' first sixth (o_orderkey < FILE_KEYS, 250,000
# rows): the Python writers take ~3 (Parquet) and ~8 s (ORC) a million
# rows, and each INSERT first decodes the stored table whole. Each is
# written as a CTAS of its first FILE_PART_KEYS keys and an INSERT of each
# later range: a part file each, with its own row-group or stripe
# statistics for the pruned decode. o_shippriority is written as BIGINT,
# the kind ORC reads any integer back as (an INSERT's kinds must match the
# stored table's).
FILE_KEYS = 1_000_000
FILE_PART_KEYS = 250_000
FILE_SELECT = ("SELECT o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
               "o_orderdate, o_orderpriority, o_clerk, CAST(o_shippriority "
               "AS BIGINT) AS o_shippriority, o_comment FROM tpch.{s}.orders "
               "WHERE o_orderkey >= {lo} AND o_orderkey < {hi}")
# the statements, over memory.<s> and tpch.<s> for s = TPCH_SCHEMA
DELETE_SQL = ("DELETE FROM memory.{s}.lineitem "
              "WHERE l_shipdate < DATE '1993-01-01'")
UPDATE_SQL = ("UPDATE memory.{s}.lineitem SET l_extendedprice = "
              "l_extendedprice + 1.00, l_shipmode = 'DRONE' "
              "WHERE l_orderkey % 4 = 1")
INSERT_SQL = ("INSERT INTO memory.{s}.lineitem SELECT * FROM "
              "tpch.{s}.lineitem WHERE l_shipdate < DATE '1992-09-01'")
MERGE_SQL = (
    "MERGE INTO memory.{s}.{tbl} t USING (SELECT CASE WHEN "
    "o_orderkey % 10 = 3 THEN o_orderkey ELSE o_orderkey + 10000000 END "
    "AS k, o_custkey AS c, o_totalprice AS p, o_orderdate AS d, "
    "o_orderpriority AS pr FROM tpch.{s}.orders WHERE o_orderkey % 10 = 3 "
    "OR o_orderkey % 100 IN (7, 17, 27)) s ON t.o_orderkey = s.k "
    "WHEN MATCHED THEN UPDATE SET o_totalprice = s.p * 2, "
    "o_shippriority = 1 WHEN NOT MATCHED THEN INSERT (o_orderkey, "
    "o_custkey, o_orderstatus, o_totalprice, o_orderdate, "
    "o_orderpriority, o_shippriority) VALUES (s.k, s.c, 'O', s.p, s.d, "
    "s.pr, 0)")


def _memory_sql(sql: str) -> str:
    """A TPC-H text over the memory copies of lineitem, orders, customer."""
    for name in ("customer", "orders", "lineitem"):
        sql = sql.replace(f" {name},", f" memory.{TPCH_SCHEMA}.{name},") \
            .replace(f" {name}\n", f" memory.{TPCH_SCHEMA}.{name}\n")
    return sql


class Replica:
    """A table's columns in numpy with the mutations applied in plain
    numpy: the oracles' input after each statement, and what the stored
    memory table must equal."""

    def __init__(self, data):
        import numpy as np
        self.name = data.name
        self.fields = list(data.schema.fields)
        self.cols = [np.array(c) for c in data.columns]
        self.valids = [np.ones(data.num_rows, np.bool_)
                       if data.valids is None or data.valids[i] is None
                       else np.array(data.valids[i])
                       for i in range(len(self.cols))]

    def col(self, name):
        return self.cols[[f.name for f in self.fields].index(name)]

    def table(self):
        from trino_tpu_torch.batch import Schema
        from trino_tpu_torch.connectors.tpch.datagen import TableData
        return TableData(self.name, Schema(tuple(self.fields)), self.cols,
                         valids=self.valids)

    def keep(self, mask):
        self.cols = [c[mask] for c in self.cols]
        self.valids = [v[mask] for v in self.valids]

    def append(self, cols, valids):
        import numpy as np
        self.cols = [np.concatenate([a, b.astype(a.dtype)])
                     for a, b in zip(self.cols, cols)]
        self.valids = [np.concatenate([a, b])
                       for a, b in zip(self.valids, valids)]

    def add_string(self, name, value):
        """Put `value` into a VARCHAR pool at its sorted place and renumber
        the stored codes; returns its code."""
        import numpy as np
        from trino_tpu_torch.batch import Field
        i = [f.name for f in self.fields].index(name)
        f = self.fields[i]
        pool = tuple(sorted(set(f.dictionary) | {value}))
        remap = np.array([pool.index(s) for s in f.dictionary], np.int32)
        self.cols[i] = remap[self.cols[i]]
        self.fields[i] = Field(f.name, f.dtype, dictionary=pool)
        return pool.index(value)


def _check_stored(session, rep, keys):
    """The stored memory table equals the replica: rows, pools, every
    column and validity, compared in key order."""
    import numpy as np
    got = session.catalog.connector("memory").get_table(TPCH_SCHEMA,
                                                        rep.name)
    require(got.num_rows == len(rep.cols[0]),
            f"memory.{rep.name}: {got.num_rows} rows, want "
            f"{len(rep.cols[0])}")
    names = [f.name for f in rep.fields]

    def order(cols):
        return np.lexsort(tuple(cols[names.index(k)] for k in keys[::-1]))
    go = order([np.asarray(c) for c in got.columns])
    ro = order(rep.cols)
    for i, (gf, rf) in enumerate(zip(got.schema.fields, rep.fields)):
        require(gf.name == rf.name and gf.dictionary == rf.dictionary,
                f"memory.{rep.name}.{rf.name}: field or pool differs")
        gv = np.ones(got.num_rows, np.bool_) if got.valids is None or \
            got.valids[i] is None else np.asarray(got.valids[i])[go]
        require(np.array_equal(gv, rep.valids[i][ro]),
                f"memory.{rep.name}.{rf.name}: validity differs")
        gc, rc = np.asarray(got.columns[i])[go], rep.cols[i][ro]
        require(np.array_equal(np.where(gv, gc, 0),
                               np.where(rep.valids[i][ro], rc, 0)),
                f"memory.{rep.name}.{rf.name}: values differ")


def _write_state(session, reps, label, record):
    """After one statement: the stored tables against their replicas, q1,
    q6 and q3 over the memory tables against the numpy oracles (a cold and
    two steady runs), q12 under mxu_agg = 'true' (K5) against its oracle,
    and q1 and q12 chunked twice against their unchunked rows."""
    import torch
    from tpch_full import QUERIES
    t0 = time.monotonic()
    _check_stored(session, reps["lineitem"], ("l_orderkey", "l_linenumber"))
    _check_stored(session, reps["orders"], ("o_orderkey",))
    _check_stored(session, reps["customer"], ("c_custkey",))
    li, orders = reps["lineitem"].table(), reps["orders"].table()
    cust = reps["customer"].table()
    expected = {"q1": oracle_q1(li), "q6": oracle_q6(li),
                "q3": oracle_q3(cust, orders, li),
                "q12": oracle_q12(orders, li)}
    check_s = time.monotonic() - t0
    walls = {}
    for name, sql in (("q1", Q1), ("q6", Q6), ("q3", Q3)):
        rows, w = _timed_runs(session, _memory_sql(sql), 3)
        require(rows == expected[name], f"{label}: {name} over the memory "
                f"tables differs from the oracle:\n{rows[:3]}\nvs\n"
                f"{expected[name][:3]}")
        walls[name] = {"cold_s": w[0], "steady_s": w[1:]}
    q12 = _memory_sql(QUERIES[12])
    session.execute("SET SESSION mxu_agg = 'true'")
    rows, w = _timed_runs(session, q12, 1)
    session.execute("SET SESSION mxu_agg = 'auto'")
    require(rows == expected["q12"], f"{label}: q12 (mxu) over the memory "
            f"tables differs from the oracle:\n{rows}\nvs\n"
            f"{expected['q12']}")
    walls["q12_mxu"] = w[0]
    unchunked = {"q1": expected["q1"], "q12": session.execute(q12).rows}
    session.execute(f"SET SESSION spill_chunk_rows = {CHUNK_ROWS}")
    chunks_before = session.executor.stats.agg_spill_chunks
    for name, sql in (("q1", _memory_sql(Q1)), ("q12", q12)):
        rows, w = _timed_runs(session, sql, 2)
        require(rows == unchunked[name], f"{label}: chunked {name} differs "
                f"from its unchunked rows")
        walls[f"chunked_{name}"] = w
    session.execute("SET SESSION spill_chunk_rows = 0")
    require(session.executor.stats.agg_spill_chunks > chunks_before,
            f"{label}: the chunked runs streamed no chunk")
    torch.cuda.synchronize()
    record[label] = {"walls": walls, "check_s": check_s}
    log(f"write path, after {label}: tables equal their replicas; q1, q6, "
        f"q3, q12 equal the oracles, chunked q1 and q12 equal unchunked ("
        f"{ {k: (round(v['cold_s'], 4), [round(x, 4) for x in v['steady_s']]) if isinstance(v, dict) else v for k, v in walls.items()} })")


def _statement(session, sql, label, want, record):
    import torch
    t = time.monotonic()
    res = session.execute(sql)
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    require(res.rows == [(want,)], f"{label} reported {res.rows}, want "
            f"{want} rows")
    record.setdefault("statements", {})[label] = {"rows": want,
                                                  "wall_s": wall}
    log(f"write path: {label} {want} rows in {wall:.4f} s")
    return wall


def _file_phase(tpch, tmp, record):
    """On a catalog of the phase's own (the connector `tpch` and the file
    connectors under `tmp`): orders' first sixth into a Parquet and an
    ORC catalog as a CTAS and INSERTs over key ranges, read back whole
    and pruned; a CSV table of customer written here and queried. SQL
    scans decode a file table whole (planning fills the connector's
    cache first), so the pruned decode is reached by an executor call
    made by hand over the planned query, the connector's cache
    cleared."""
    import numpy as np
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.connectors.csvfile import CsvConnector
    from trino_tpu_torch.connectors.orcdir import OrcConnector
    from trino_tpu_torch.connectors.parquetdir import ParquetConnector
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.planner.optimizer import prune_plan
    from trino_tpu_torch.sql.parser import parse
    cat = Catalog()
    cat.register("tpch", tpch)
    cat.register("pq", ParquetConnector(os.path.join(tmp, "pq")))
    cat.register("orc", OrcConnector(os.path.join(tmp, "orc")))
    session = Session(cat, default_schema=TPCH_SCHEMA)
    orders = cat.connector("tpch").get_table(TPCH_SCHEMA, "orders")
    okey = _col(orders, "o_orderkey")
    part = okey < FILE_KEYS
    n = int(part.sum())
    bounds = list(range(0, FILE_KEYS + 1, FILE_PART_KEYS))
    pruned_sql = ("SELECT count(*), sum(o_totalprice), max(o_orderdate) "
                  "FROM {t} WHERE o_orderkey < " + str(FILE_KEYS // 5))
    want_pruned = session.execute(pruned_sql.format(
        t=f"tpch.{TPCH_SCHEMA}.orders")).rows
    for c in ("pq", "orc"):
        conn = cat.connector(c)
        table = f"{c}.{TPCH_SCHEMA}.orders"
        t = time.monotonic()
        written = []
        for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            select = FILE_SELECT.format(s=TPCH_SCHEMA, lo=lo, hi=hi)
            res = session.execute(f"CREATE TABLE {table} AS {select}"
                                  if i == 0 else
                                  f"INSERT INTO {table} {select}")
            want = int(((okey >= lo) & (okey < hi)).sum())
            require(res.rows == [(want,)], f"{c}: the write of keys "
                    f"[{lo}, {hi}) reported {res.rows}, want {want}")
            written.append(time.monotonic() - t)
        write_s = written[-1]
        conn._cache.clear()
        t = time.monotonic()
        back = conn.get_table(TPCH_SCHEMA, "orders")
        read_s = time.monotonic() - t
        require(back.num_rows == n, f"{c}: read back {back.num_rows} rows")
        # both sides in key order
        order = np.argsort(np.asarray(back.columns[0]))
        worder = np.flatnonzero(part)[np.argsort(okey[part])]
        for i, f in enumerate(orders.schema.fields):
            got = np.asarray(back.columns[i])[order]
            want = np.asarray(orders.columns[i])[worder]
            if f.dictionary is not None:
                got = np.asarray(back.schema.fields[i].dictionary,
                                 dtype=object)[got]
                want = np.asarray(f.dictionary, dtype=object)[want]
            require(np.array_equal(got, want),
                    f"{c}: column {f.name} read back differs")
        full = session.execute(pruned_sql.format(t=table)).rows
        require(full == want_pruned, f"{c}: full scan {full} differs from "
                f"tpch's {want_pruned}")
        # the pruned decode: the executor's scan of the planned query with
        # the connector's cache cleared (a hand-driven call; no SQL
        # statement reaches it)
        sql = pruned_sql.format(t=table)
        rel = session.planner().plan_query(parse(sql))
        root = prune_plan(rel.node)
        conn._cache.clear()
        cold = Session(cat, default_schema=TPCH_SCHEMA)
        t = time.monotonic()
        batch = cold.executor.execute(root)
        names, arrays, valids = cold.executor.result_to_host(root, batch)
        rows = cold.decode_rows(rel, arrays, valids)
        pruned_s = time.monotonic() - t
        st = cold.executor.stats
        require(rows == want_pruned, f"{c}: pruned scan {rows} differs")
        require(st.pruned_decodes == 1 and st.pruned_groups_skipped > 0,
                f"{c}: the scan did not take the pruned decode ({st})")
        require(st.pruned_decode_fallbacks == 0,
                f"{c}: the pruned decode fell back to the full decode")
        groups = len(bounds) - 1
        record["files"][c] = {
            "rows": n, "parts": groups, "write_s": write_s,
            "ctas_s": written[0], "rows_per_s": n / write_s,
            "full_read_s": read_s,
            "pruned_executor_call_s": pruned_s,
            "groups_skipped": st.pruned_groups_skipped,
            "pruned_decode_fallbacks": st.pruned_decode_fallbacks,
            "bytes": sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(os.path.join(tmp, c))
                         for f in fs)}
        log(f"write path, {c}: CTAS and {groups - 1} INSERTs of {n} rows "
            f"in {write_s:.4f} s ({n / write_s:.0f} rows/s; the CTAS "
            f"{written[0]:.4f} s), read back in {read_s:.4f} s equal to "
            f"tpch's orders; pruned decode by a hand-driven executor call "
            f"(connector cache cleared, not a SQL statement) "
            f"{pruned_s:.4f} s, skipped {st.pruned_groups_skipped} of "
            f"{groups} groups, fallbacks 0")
    # a CSV table, written here from customer and loaded by the connector
    cust = cat.connector("tpch").get_table(TPCH_SCHEMA, "customer")
    names = np.asarray(cust.schema.field("c_name").dictionary,
                       dtype=object)[_col(cust, "c_name")]
    ck, nk = _col(cust, "c_custkey"), _col(cust, "c_nationkey")
    bal = _col(cust, "c_acctbal")
    os.makedirs(os.path.join(tmp, "csv", TPCH_SCHEMA))
    t = time.monotonic()
    with open(os.path.join(tmp, "csv", TPCH_SCHEMA, "customer.csv"),
              "w") as f:
        f.write("c_custkey,c_name,c_nationkey,c_acctbal\n")
        f.writelines(f"{k},{s},{x},{'-' if b < 0 else ''}{abs(b) // 100}."
                     f"{abs(b) % 100:02d}\n"
                     for k, s, x, b in zip(ck.tolist(), names.tolist(),
                                           nk.tolist(), bal.tolist()))
    cat.register("csv", CsvConnector(os.path.join(tmp, "csv")))
    sql = ("SELECT c_nationkey, count(*), sum(c_custkey), max(c_acctbal) "
           f"FROM csv.{TPCH_SCHEMA}.customer GROUP BY c_nationkey "
           "ORDER BY c_nationkey")
    rows = session.execute(sql).rows
    csv_s = time.monotonic() - t
    want = []
    for x in np.unique(nk):
        m = nk == x
        want.append((int(x), int(m.sum()), int(ck[m].sum()),
                     float(str(_dec(int(bal[m].max()), 2)))))
    require(rows == want, f"csv: {rows[:2]} differs from {want[:2]}")
    one = session.execute(f"SELECT c_custkey, c_acctbal FROM csv."
                          f"{TPCH_SCHEMA}.customer WHERE c_name = "
                          f"'{names[6]}'").rows
    require(one == [(int(ck[6]), float(str(_dec(int(bal[6]), 2))))],
            f"csv: the row of {names[6]} is {one}")
    record["files"]["csv"] = {"rows": len(ck), "write_load_query_s": csv_s}
    require(session.executor.stats.pruned_decode_fallbacks == 0,
            "a file scan's pruned decode fell back to the full decode")
    log(f"write path, csv: {len(ck)} customer rows written, loaded and "
        f"aggregated in {csv_s:.4f} s, equal to the numpy oracle")


def phase_write_path(recorder, main_session):
    """CREATE TABLE AS SELECT of TPC-H lineitem, orders and customer at
    sf1 into the memory catalog, then DELETE (~1/7 of lineitem), UPDATE
    (~1/4: a decimal and a VARCHAR column, with a value new to the
    pool), INSERT ... SELECT (~1/10 back) and one MERGE INTO orders (~10%
    matched, ~3% new keys; it must launch K1, and runs once more into a
    copy of orders under torch.profiler), each reporting the replica's
    row count; after the CTAS and the MERGE, `_write_state` (the MERGE's
    state holds the DELETE, the UPDATE and the INSERT). Then the file
    connectors (`_file_phase`), and DROP TABLE of the memory tables.
    Counters set to 0 before, read after. A Session of its own over the
    same catalog, so that the writes' cache invalidations leave the other
    paths' caches (and their later profiles) as they were."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from trino_tpu_torch.exec.session import Session
    session = Session(main_session.catalog, default_schema=TPCH_SCHEMA)
    conn = session.catalog.connector("tpch")
    src = {t: conn.get_table(TPCH_SCHEMA, t) for t in WRITE_TABLES}
    reps = {t: Replica(src[t]) for t in WRITE_TABLES}
    record = {"files": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    reset_counts()
    recorder.active, recorder.keep = True, False
    t_phase = time.monotonic()
    try:
        for t in WRITE_TABLES:
            wall = _statement(
                session, f"CREATE TABLE memory.{TPCH_SCHEMA}.{t} AS SELECT "
                f"* FROM tpch.{TPCH_SCHEMA}.{t}", f"CTAS {t}",
                src[t].num_rows, record)
            record["statements"][f"CTAS {t}"]["rows_per_s"] = \
                src[t].num_rows / wall
        _write_state(session, reps, "CTAS", record)

        li = reps["lineitem"]
        m = li.col("l_shipdate") < _days("1993-01-01")
        _statement(session, DELETE_SQL.format(s=TPCH_SCHEMA),
                   "DELETE", int(m.sum()), record)
        li.keep(~m)

        m = li.col("l_orderkey") % 4 == 1
        _statement(session, UPDATE_SQL.format(s=TPCH_SCHEMA),
                   "UPDATE", int(m.sum()), record)
        li.col("l_extendedprice")[m] += 100
        li.col("l_shipmode")[m] = li.add_string("l_shipmode", "DRONE")
        # the DELETE, the UPDATE and the INSERT are checked in the state
        # after the MERGE (which leaves lineitem as they left it): a check
        # of its own after each would hold the script over its time

        orig = src["lineitem"]
        m = _col(orig, "l_shipdate") < _days("1992-09-01")
        _statement(session, INSERT_SQL.format(s=TPCH_SCHEMA),
                   "INSERT", int(m.sum()), record)
        cols = [np.asarray(c)[m] for c in orig.columns]
        i = [f.name for f in li.fields].index("l_shipmode")
        pool = li.fields[i].dictionary
        cols[i] = np.array([pool.index(s) for s in
                            orig.schema.fields[i].dictionary],
                           np.int32)[cols[i]]
        li.append(cols, [np.ones(int(m.sum()), np.bool_)] * len(cols))

        od = reps["orders"]
        ok = _col(src["orders"], "o_orderkey")
        matched = ok % 10 == 3
        new = np.isin(ok % 100, (7, 17, 27))
        want = int(matched.sum() + new.sum())
        # a copy of orders as it stands, for the profiled run below
        session.execute(f"CREATE TABLE memory.{TPCH_SCHEMA}.orders_p AS "
                        f"SELECT * FROM memory.{TPCH_SCHEMA}.orders")
        k1_before = read_counts()["K1"]
        _statement(session, MERGE_SQL.format(s=TPCH_SCHEMA, tbl="orders"),
                   "MERGE", want, record)
        k1_merge = read_counts()["K1"] - k1_before
        require(k1_merge > 0, "the MERGE statement did not launch K1 (its "
                "NOT EXISTS anti join probes a dense LUT)")
        # the same MERGE into the copy under torch.profiler: the card's
        # busy time and idle share (the wall above is taken without it)
        res, pwall, acts = _profiled_run(
            session, MERGE_SQL.format(s=TPCH_SCHEMA, tbl="orders_p"))
        require(res.rows == [(want,)], f"the profiled MERGE reported "
                f"{res.rows}, want {want} rows")
        session.execute(f"DROP TABLE memory.{TPCH_SCHEMA}.orders_p")
        busy_ms = sum(us for _name, us in acts) / 1e3
        prof = {"profiled_wall_ms": round(pwall * 1e3, 4),
                "device_busy_ms": round(busy_ms, 4),
                "idle_share": round(1 - busy_ms / (pwall * 1e3), 4)}
        record["statements"]["MERGE"].update(k1_launches=k1_merge,
                                             profile=prof)
        log(f"write path: MERGE launched K1 {k1_merge} times; the same "
            f"MERGE into a copy under torch.profiler: {json.dumps(prof)}")
        hit = np.isin(od.col("o_orderkey"), ok[matched])
        od.col("o_totalprice")[hit] *= 2
        od.col("o_shippriority")[hit] = 1
        s = [f.name for f in od.fields]
        srcc = {f.name: _col(src["orders"], f.name)[new]
                for f in src["orders"].schema.fields}
        n_new = int(new.sum())
        add = {"o_orderkey": srcc["o_orderkey"] + 10_000_000,
               "o_custkey": srcc["o_custkey"],
               "o_orderstatus": np.full(n_new, od.fields[s.index(
                   "o_orderstatus")].dictionary.index("O"), np.int32),
               "o_totalprice": srcc["o_totalprice"],
               "o_orderdate": srcc["o_orderdate"],
               "o_orderpriority": srcc["o_orderpriority"],
               "o_shippriority": np.zeros(n_new, np.int32)}
        od.append([add.get(name, np.zeros(n_new, od.col(name).dtype))
                   for name in s],
                  [np.full(n_new, name in add, np.bool_) for name in s])
        _write_state(session, reps, "MERGE", record)
        memory_s = time.monotonic() - t_phase
        _file_phase(conn, tmp, record)
        torch.cuda.synchronize()
    finally:
        recorder.active, recorder.keep = False, True
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts()
    record["memory_part_s"] = memory_s
    record["phase_s"] = time.monotonic() - t_phase
    require(launches["K5"] > 0, "the write path's q12 (mxu_agg = true) did "
            "not launch K5")
    require(session.executor.stats.pruned_decode_fallbacks == 0,
            "a pruned decode fell back to the full decode")
    for t in WRITE_TABLES:
        session.execute(f"DROP TABLE memory.{TPCH_SCHEMA}.{t}")
    require(session.executor.device.type == "cuda" and
            session.catalog.connector("memory").table_names(
                TPCH_SCHEMA) == [],
            "DROP TABLE left a table behind or the executor off the card")
    record["launches"] = launches
    log("write path: " + json.dumps(record, default=str))
    return launches


# -- the memory-pressure tier (exec/spill.py) --------------------------------

def oracle_join_q(orders, cust):
    """JOIN_Q: per customer with c_acctbal > 0, its orders' count and
    total price, the 50 largest totals."""
    import numpy as np
    ck = _col(cust, "c_custkey")
    ok = np.zeros(int(ck.max()) + 1, np.bool_)
    ok[ck[_col(cust, "c_acctbal") > 0]] = True
    oc = _col(orders, "o_custkey")
    m = ok[oc]
    keys, inv = np.unique(oc[m], return_inverse=True)
    cnt = np.bincount(inv)
    tot = np.zeros(len(keys), np.int64)
    np.add.at(tot, inv, _col(orders, "o_totalprice")[m])
    order = np.lexsort((keys, -tot))[:50]
    return [(int(keys[i]), int(cnt[i]), _dec(int(tot[i]), 2))
            for i in order]


def oracle_group_q(li):
    """GROUP_Q: sum(l_quantity) per order, the 20 largest."""
    import numpy as np
    keys, inv = np.unique(_col(li, "l_orderkey"), return_inverse=True)
    q = np.zeros(len(keys), np.int64)
    np.add.at(q, inv, _col(li, "l_quantity"))
    order = np.lexsort((keys, -q))[:20]
    return [(int(keys[i]), _dec(int(q[i]), 2)) for i in order]


def oracle_group_all_q(li):
    """GROUP_ALL_Q: sum(l_quantity) of every order, by l_orderkey."""
    import numpy as np
    keys, inv = np.unique(_col(li, "l_orderkey"), return_inverse=True)
    q = np.zeros(len(keys), np.int64)
    np.add.at(q, inv, _col(li, "l_quantity"))
    return [(int(k), _dec(int(v), 2)) for k, v in zip(keys.tolist(),
                                                      q.tolist())]


def oracle_sumagg_q(li):
    """SUMAGG_Q: sum(l_quantity) and count(*) per (returnflag,
    linestatus)."""
    import numpy as np
    rf, ls = _col(li, "l_returnflag"), _col(li, "l_linestatus")
    rpool = li.schema.field("l_returnflag").dictionary
    lpool = li.schema.field("l_linestatus").dictionary
    out = []
    for r in sorted(set(rf.tolist()), key=lambda c: rpool[c]):
        for s in sorted(set(ls.tolist()), key=lambda c: lpool[c]):
            m = (rf == r) & (ls == s)
            if m.any():
                out.append((rpool[r], lpool[s],
                            _dec(int(_col(li, "l_quantity")[m].sum()), 2),
                            int(m.sum())))
    return out


def oracle_sort_q(li):
    """SORT_Q: the 100 largest l_extendedprice, ties by l_orderkey."""
    import numpy as np
    k, p = _col(li, "l_orderkey"), _col(li, "l_extendedprice")
    order = np.lexsort((k, -p))[:100]
    return [(int(k[i]), _dec(int(p[i]), 2)) for i in order]


# a fresh interpreter that runs TPC-H q3 once, cold, at sf1 and reports
# how many fetch_ints calls synced with the card (a call whose key the
# decision cache already holds does not); it must import neither jax nor
# the reference package
_DECISION_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.exec.session import Session
real = Executor.fetch_ints
syncs = [0]

def fetch_ints(self, node, tag, *vals):
    hits = self.stats.decision_hits
    out = real(self, node, tag, *vals)
    syncs[0] += self.stats.decision_hits == hits
    return out

Executor.fetch_ints = fetch_ints
session = Session(default_schema=sys.argv[2])
session.catalog.connector("tpch").get_table(sys.argv[2], "lineitem")
t = time.monotonic()
rows = session.execute(sys.argv[3]).rows
torch.cuda.synchronize()
wall = time.monotonic() - t
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu"))
print(json.dumps({"syncs": syncs[0], "wall_s": wall,
                  "pool_peak": session.executor.pool.peak,
                  "rows": repr(rows), "leaked": leaked,
                  "hits": session.executor.stats.decision_hits}))
"""


def remove_decision_file():
    """Delete the port's decision file, so that a run starts from the
    same state whatever an earlier run in this checkout left."""
    from trino_tpu_torch.connectors.diskcache import cache_root
    from trino_tpu_torch.exec.executor import Executor
    path = os.path.join(cache_root(), Executor._DECISION_CACHE_FILE)
    if os.path.exists(path):
        os.remove(path)


def _decision_children():
    """Two fresh processes run TPC-H q3 once each, cold, with the port's
    decision file removed first: the second replays the first's
    decisions from disk, so it syncs fewer times for the same rows."""
    remove_decision_file()
    env = dict(os.environ, TRINO_TPU_DECISION_CACHE="1")
    out = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", _DECISION_CHILD, HERE, TPCH_SCHEMA, Q3],
            env=env, cwd=HERE, capture_output=True, text=True, timeout=300)
        require(proc.returncode == 0,
                f"decision child failed:\n{proc.stderr[-2000:]}")
        out.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = out
    require(not first["leaked"] and not second["leaked"],
            f"a decision child imported {first['leaked'] + second['leaked']}")
    require(second["hits"] > 0 and second["rows"] == first["rows"],
            "the replaying child returned other rows")
    require(second["syncs"] < first["syncs"],
            f"the replaying child synced {second['syncs']} times, the "
            f"cold one {first['syncs']}")
    for rec in out:
        rec.pop("rows")
    return {"cold": first, "replayed": second}


def phase_memory_pressure(recorder, main_session, tables):
    """JOIN_Q, GROUP BY l_orderkey (K3 on each partition; its 20 largest
    groups, and every group in order of l_orderkey), the four-group sums
    under mxu_agg = 'true' (K5 on each chunk), AGG_Q and a TopN at
    tpch.sf1, each resident with its decisions warm (pool peak, wall, the
    card's peak), then at a quarter of its resident pool peak: rows equal
    the resident rows and the numpy oracles, every query spills, K3 and
    K5 launch there. The largest K3 launch of the
    GROUP BYs over the whole input and of their spilled partitions are
    kept for the timing phase, which holds them against K3's plain
    version. Then JOIN_Q with every
    partition forced to disk, the same under SPOOL_WRITE faults (a raise
    and a corrupted page, twice each), GROUP BY l_orderkey with spill
    disabled at 1 MiB (it must raise, and the session must answer again), and the decision cache
    across two fresh processes. A Session of its own over the same
    catalog, counters set to 0 before and read after."""
    import shutil
    import tempfile
    import torch
    from spill_queries import (AGG_Q, GROUP_ALL_Q, GROUP_Q, JOIN_Q, SORT_Q,
                               SUMAGG_Q)
    from trino_tpu_torch.exec.memory import ExceededMemoryLimitError
    from trino_tpu_torch.exec import spill as spill_mod
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.exec.spill import get_spiller
    from trino_tpu_torch.metrics import SPILL_PARTITIONS
    from trino_tpu_torch.ops import direct_agg as k5
    from trino_tpu_torch.ops import hashtable as ht
    from trino_tpu_torch.server.failureinjector import FailureInjector
    li = tables["lineitem"]
    queries = {
        "join": (JOIN_Q, oracle_join_q(tables["orders"], tables["customer"])),
        "group": (GROUP_Q, oracle_group_q(li)),
        "group_all": (GROUP_ALL_Q, oracle_group_all_q(li)),
        "sumagg": (SUMAGG_Q, oracle_sumagg_q(li)),
        "agg": (AGG_Q, None),
        "sort": (SORT_Q, oracle_sort_q(li))}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    old_dir = os.environ.get("TRINO_TPU_SPILL_DIR")
    os.environ["TRINO_TPU_SPILL_DIR"] = tmp

    def fresh(name, limit=None):
        s = Session(main_session.catalog, default_schema=TPCH_SCHEMA)
        if name == "sumagg":
            s.execute("SET SESSION mxu_agg = 'true'")
        if limit is not None:
            s.executor.pool.set_limit(limit)
            s.properties["query_max_memory_mb"] = max(1, limit >> 20)
        return s

    def run(s, sql):
        """Rows, wall, and the card's peak above what the process held
        before the query (the other paths' cached tables stay resident)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        rows = s.execute(sql).rows
        torch.cuda.synchronize()
        return (rows, time.monotonic() - t,
                torch.cuda.max_memory_allocated() - base)

    def spill_aggregate(executor, node):
        """The spilled partitions' K3 launches under a capture of their
        own (the attempt over the whole input launches before it)."""
        whole = recorder.capture
        recorder.capture = MEMORY_K3[1] if whole else None
        try:
            return real_spill_aggregate(executor, node)
        finally:
            recorder.capture = whole

    real_spill_aggregate = spill_mod.spill_aggregate
    spill_mod.spill_aggregate = spill_aggregate
    record = {"queries": {}}
    reset_counts()
    recorder.active, recorder.keep = True, False
    t_phase = time.monotonic()
    try:
        for name, (sql, want) in queries.items():
            grouped = name in ("group", "group_all")
            recorder.capture = MEMORY_K3[0] if grouped else None
            cold, _, _ = run(fresh(name), sql)    # records the decisions
            s = fresh(name)                       # replays them from disk
            rows, wall, card_peak = run(s, sql)
            require(rows == cold and (want is None or rows == want),
                    f"{name}: resident rows differ from the oracle:\n"
                    f"{rows[:3]}\nvs\n{(want or [])[:3]}")
            peak = s.executor.pool.peak
            rec = {"resident": {"pool_peak": peak, "wall_s": wall,
                                "card_peak_above_bytes": card_peak}}
            for frac in (4,):
                s = fresh(name, max(1, peak // frac))
                k3n, k5n = ht.hash_insert_multi.launches, \
                    k5.direct_group_aggregate_mxu.launches
                p0 = SPILL_PARTITIONS.value()
                got, wall, card_peak = run(s, sql)
                st = s.executor.stats
                spilled = (st.spilled_joins, st.spilled_aggregations,
                           st.spilled_sorts)
                sp = s.executor.spiller
                require(got == rows, f"{name} at 1/{frac} of its peak "
                        f"differs from its resident rows")
                if frac == 4:
                    require(sum(spilled) >= 1,
                            f"{name} did not spill at 1/4 of its peak")
                rec[f"1/{frac}"] = {
                    "limit_bytes": s.executor.pool.limit,
                    "pool_peak": s.executor.pool.peak, "wall_s": wall,
                    "card_peak_above_bytes": card_peak,
                    "spilled_joins_aggs_sorts": spilled,
                    "partitions_spilled": SPILL_PARTITIONS.value() - p0,
                    "bytes_spilled": sp.bytes_spilled if sp else 0,
                    "disk_writes": sp.disk_writes if sp else 0,
                    "k3_launches": ht.hash_insert_multi.launches - k3n,
                    "k5_launches":
                        k5.direct_group_aggregate_mxu.launches - k5n}
            if grouped:
                require(rec["1/4"]["k3_launches"] > 0, f"the spilled "
                        f"GROUP BY l_orderkey ({name}) did not launch K3")
            if name == "sumagg":
                require(rec["1/4"]["k5_launches"] > 0, "the chunk-and-"
                        "merge aggregate did not launch K5")
            record["queries"][name] = rec
            log(f"memory pressure {name}: " + json.dumps(rec, default=str))
        recorder.capture = None
        quarter = max(1, record["queries"]["join"]["resident"]["pool_peak"]
                      // 4)
        for label in ("forced disk", "chaos"):
            s = fresh("join", quarter)
            s.executor.spill_force_disk = True
            spiller = get_spiller(s.executor)
            require(spiller.root == tmp, "the spiller ignored "
                    "TRINO_TPU_SPILL_DIR")
            inj = None
            if label == "chaos":
                inj = FailureInjector()
                inj.inject("SPOOL_WRITE", times=2, fault="RAISE")
                inj.inject("SPOOL_WRITE", times=2, fault="CORRUPT")
                spiller.injector = inj
            rows, wall, _ = run(s, JOIN_Q)
            require(rows == queries["join"][1], f"JOIN_Q ({label}) "
                    f"differs from its resident rows")
            require(spiller.disk_writes >= 1, f"{label}: no disk write")
            if inj is not None:
                require(spiller.write_recoveries >= 1 and
                        inj.injected_count >= 1,
                        "SPOOL_WRITE faults were not recovered")
            record[label] = {"wall_s": wall,
                             "disk_writes": spiller.disk_writes,
                             "bytes_spilled": spiller.bytes_spilled,
                             "write_recoveries": spiller.write_recoveries,
                             "faults_injected":
                                 inj.injected_count if inj else 0}
        s = fresh("group")
        s.execute("SET SESSION spill_enabled = false")
        s.execute("SET SESSION query_max_memory_mb = 1")
        try:
            s.execute(GROUP_Q)
            raised = False
        except ExceededMemoryLimitError:
            raised = True
        require(raised, "spill disabled at 1 MiB did not raise")
        s.execute("SET SESSION query_max_memory_mb = 65536")
        require(s.execute(GROUP_Q).rows == queries["group"][1],
                "the session did not answer again after the limit rose")
        record["spill disabled"] = "raised ExceededMemoryLimitError, then " \
            "answered at 64 GiB"
    finally:
        recorder.active, recorder.keep, recorder.capture = False, True, None
        spill_mod.spill_aggregate = real_spill_aggregate
        if old_dir is None:
            os.environ.pop("TRINO_TPU_SPILL_DIR", None)
        else:
            os.environ["TRINO_TPU_SPILL_DIR"] = old_dir
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts()
    record["launches"] = launches
    t_children = time.monotonic()
    record["decision cache"] = _decision_children()
    record["decision_children_s"] = time.monotonic() - t_children
    record["phase_s"] = time.monotonic() - t_phase
    log("memory pressure: " + json.dumps(record, default=str))
    return launches


# ---------------------------------------------------------------------------
# SQL over HTTP: the port's coordinator, serving layer and router
# ---------------------------------------------------------------------------

# rows of the paged result (orders' smallest keys)
PAGED_ROWS = 120_000
# the crossover's tables, each with its key column and a decimal column
CROSSOVER = (("region", "r_regionkey", None),
             ("nation", "n_nationkey", None),
             ("supplier", "s_suppkey", "s_acctbal"),
             ("customer", "c_custkey", "c_acctbal"),
             ("orders", "o_orderkey", "o_totalprice"),
             ("lineitem", "l_orderkey", "l_extendedprice"))


def _crossover_sql(table, data, key, dec):
    """A filter and a global count/sum/min/max over an integer and a
    decimal column: host-eligible, and free of doubles, so both routes
    give the same bits. The filter keeps the keys up to the median."""
    import numpy as np
    bound = int(np.median(_col(data, key)))
    cols = [key] + ([dec] if dec else [])
    aggs = ", ".join(f"sum({c}), min({c}), max({c})" for c in cols)
    return (f"SELECT count(*), {aggs} FROM {table} "
            f"WHERE {key} <= {bound}")


class HttpProbe:
    """The phase's client side: every statement goes through the port's
    Client, and each run reports its rows, its /v1/query info and its
    wall as the client saw it."""

    def __init__(self, uri):
        import threading
        from trino_tpu_torch.client.client import Client
        self.uri = uri
        self.client = Client(uri, user="chip", poll_interval_s=0.001)
        self.statements = 0       # statements sent, from every thread
        self._lock = threading.Lock()

    def count(self):
        with self._lock:
            self.statements += 1

    def new_client(self, user):
        from trino_tpu_torch.client.client import Client
        return Client(self.uri, user=user, poll_interval_s=0.001)

    def run(self, sql, client=None):
        """(rows, info, wall s). The rows are decoded on the host when
        the last page arrives, so the wall needs no device sync (a sync
        would also wait for other queries' work on the card)."""
        cl = client or self.client
        t = time.monotonic()
        res = cl.execute(sql)
        wall = time.monotonic() - t
        self.count()
        return res.rows, cl.query_info(res.query_id), wall

    def set(self, name, value):
        self.client.execute(f"SET SESSION {name} = '{value}'")
        self.count()

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(self.uri + path, timeout=60) as resp:
            return resp.read().decode()


def phase_http_path(recorder, main_session, tables):
    """SQL over HTTP on the card: a port CoordinatorServer over its own
    CUDA Session at tpch.sf1 (the tables already generated), talked to
    only through the port's Client, counters set to 0 just before and
    read just after. TPC-H q1/q6/q3 (K1, K3) and q12 under mxu_agg =
    'true' (K5) against the oracles and the in-process rows, a paged
    result of PAGED_ROWS rows, the host/device crossover over six tables,
    history routing of q6, host-routed point queries beside a q3 on the
    card, the micro-batcher, the result cache, cancel and deadline, and
    the read-backs (EXPLAIN's routing line, /v1/metrics, /v1/jit,
    system.runtime.queries)."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    from tpch_full import QUERIES
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.client.client import QueryError
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.metrics import (MICROBATCH_BATCHES,
                                         MICROBATCH_QUERIES)
    from trino_tpu_torch.server.coordinator import (CoordinatorServer,
                                                    _rows_json)
    t_phase = time.monotonic()
    conn = main_session.catalog.connector("tpch")
    cat = Catalog()
    cat.register("tpch", conn)
    cat.register("memory", MemoryConnector())
    tmp = tempfile.mkdtemp(prefix="chip-smoke-http-")
    saved = {k: os.environ.get(k) for k in ("TRINO_TPU_HISTORY_PATH",
                                            "TRINO_TPU_QUERY_HISTORY")}
    # every run starts with no history; the tracker keeps every query of
    # the phase, so system.runtime.queries can count them
    os.environ["TRINO_TPU_HISTORY_PATH"] = os.path.join(tmp, "h.jsonl")
    os.environ["TRINO_TPU_QUERY_HISTORY"] = "100000"
    session = Session(cat, default_schema=TPCH_SCHEMA)
    require(session.device.type == "cuda", "the coordinator's Session() "
            "is not on cuda")
    coord = CoordinatorServer(session, max_concurrency=16).start()
    lock = coord.state.dispatcher.exec_lock
    probe = HttpProbe(coord.uri)
    record = {}
    reset_counts()
    recorder.active, recorder.keep = True, False

    def in_process(sql, runs):
        with lock:
            rows, walls = _timed_runs(session, sql, runs)
        return _rows_json(rows), walls

    def counts_during(fn):
        before = read_counts()
        out = fn()
        after = read_counts()
        return out, {k: after[k] - before[k] for k in after}

    try:
        orders = conn.get_table(TPCH_SCHEMA, "orders")
        expected = {
            "q1": oracle_q1(tables["lineitem"]),
            "q6": oracle_q6(tables["lineitem"]),
            "q3": oracle_q3(tables["customer"], orders,
                            tables["lineitem"]),
            "q12": oracle_q12(orders, tables["lineitem"])}
        expected = {k: _rows_json(v) for k, v in expected.items()}
        # 1. q1, q6, q3: one cold and three steady runs each
        per_query = {}
        for name, sql in (("q1", Q1), ("q6", Q6), ("q3", Q3)):
            def runs(sql=sql):
                return [probe.run(sql) for _ in range(4)]
            out, delta = counts_during(runs)
            local_rows, local_walls = in_process(sql, 4)
            for rows, info, _wall in out:
                require(rows == expected[name] == local_rows,
                        f"{name} over HTTP differs from the oracle or the "
                        f"in-process rows:\n{rows[:3]}\nvs\n"
                        f"{expected[name][:3]}")
                require(info["route"] == "device", f"{name} routed "
                        f"{info['route']} ({info['routeReason']})")
            walls = [w for _r, _i, w in out]
            per_query[name] = {
                "walls_s": walls, "in_process_walls_s": local_walls,
                "steady_median_s": statistics.median(walls[1:]),
                "in_process_steady_median_s":
                    statistics.median(local_walls[1:]),
                "route_reason": out[-1][1]["routeReason"],
                "launches": delta}
            per_query[name]["protocol_cost_s"] = \
                per_query[name]["steady_median_s"] - \
                per_query[name]["in_process_steady_median_s"]
            log(f"http {name}: rows match the oracle and the in-process "
                f"rows; walls {[round(w, 4) for w in walls]} s over HTTP, "
                f"{[round(w, 4) for w in local_walls]} s in process "
                f"(steady medians {per_query[name]['steady_median_s']:.4f}"
                f" / {per_query[name]['in_process_steady_median_s']:.4f}"
                f" s); route device ({out[-1][1]['routeReason']}); "
                f"launches {delta}")
        require(per_query["q3"]["launches"]["K1"] > 0 and
                per_query["q3"]["launches"]["K3"] > 0,
                "q3 over HTTP did not launch K1 and K3")
        record["tpch"] = per_query
        # 2. q12 under mxu_agg = 'true'
        probe.set("mxu_agg", "true")
        (rows, info, wall), delta = counts_during(
            lambda: probe.run(QUERIES[12]))
        probe.set("mxu_agg", "auto")
        require(rows == expected["q12"], f"q12 over HTTP differs from the "
                f"oracle:\n{rows}\nvs\n{expected['q12']}")
        require(delta["K5"] >= 1 and info["route"] == "device",
                f"q12 under mxu_agg = 'true' launched K5 {delta['K5']} "
                f"times, route {info['route']}")
        record["q12"] = {"wall_s": wall, "launches": delta}
        log(f"http q12 (mxu_agg = true): rows match the oracle; wall "
            f"{wall:.4f} s; launches {delta}")
        # 3. a result of 120,000 rows over many pages
        okey = np.sort(_col(orders, "o_orderkey"))
        big_sql = (f"SELECT o_orderkey, o_totalprice FROM orders WHERE "
                   f"o_orderkey <= {int(okey[PAGED_ROWS - 1])} "
                   f"ORDER BY o_orderkey")
        doc = json.loads(_http_post(coord.uri, big_sql))
        pages, n_rows, t = 0, 0, time.monotonic()
        big_rows = []
        while "nextUri" in doc:
            doc = json.loads(probe.get(doc["nextUri"][len(coord.uri):]))
            if "data" in doc:
                pages += 1
                big_rows.extend(doc["data"])
        probe.count()
        paged_s = time.monotonic() - t
        local_rows, _w = in_process(big_sql, 1)
        require(big_rows == local_rows and len(big_rows) == PAGED_ROWS,
                f"the paged result ({len(big_rows)} rows) differs from "
                f"the in-process rows ({len(local_rows)})")
        record["paged"] = {"rows": len(big_rows), "pages": pages,
                           "wall_s": paged_s}
        log(f"http paging: {len(big_rows)} rows over {pages} nextUri "
            f"pages in {paged_s:.4f} s, equal to the in-process rows")
        # 4. the host/device crossover
        crossover = []
        for table, key, dec in CROSSOVER:
            data = conn.get_table(TPCH_SCHEMA, table)
            sql = _crossover_sql(table, data, key, dec)
            per_mode, rows_of = {}, {}
            for mode in ("host", "device"):
                probe.set("routing_mode", mode)
                out, delta = counts_during(
                    lambda sql=sql: [probe.run(sql) for _ in range(4)])
                for rows, info, _w in out:
                    require(info["route"] == mode, f"{table} under "
                            f"routing_mode = {mode} routed "
                            f"{info['route']} ({info['routeReason']})")
                    require(rows == out[0][0], f"{table}: a rerun "
                            f"returned other rows")
                if mode == "host":
                    require(not any(delta.values()), f"{table}: the host "
                            f"route launched kernels {delta}")
                rows_of[mode] = out[0][0]
                per_mode[mode] = {
                    "walls_s": [w for _r, _i, w in out],
                    "elapsed_s": [i["elapsedSeconds"] for _r, i, _w
                                  in out]}
            probe.set("routing_mode", "auto")
            require(rows_of["host"] == rows_of["device"],
                    f"{table}: host rows {rows_of['host']} differ from "
                    f"device rows {rows_of['device']}")
            entry = {"table": table, "rows": data.num_rows, "sql": sql}
            for mode in ("host", "device"):
                entry[f"{mode}_steady_median_s"] = statistics.median(
                    per_mode[mode]["elapsed_s"][1:])
                entry[f"{mode}_steady_wall_median_s"] = statistics.median(
                    per_mode[mode]["walls_s"][1:])
                entry[f"{mode}_cold_s"] = per_mode[mode]["elapsed_s"][0]
            crossover.append(entry)
            log(f"http crossover {table} ({data.num_rows} rows): steady "
                f"medians host {entry['host_steady_median_s']:.5f} s, "
                f"device {entry['device_steady_median_s']:.5f} s "
                f"(server elapsed; client walls "
                f"{entry['host_steady_wall_median_s']:.5f} / "
                f"{entry['device_steady_wall_median_s']:.5f} s); rows "
                f"equal between routes")
        # where a device run's host time goes on the table whose device
        # median sits furthest above its host median
        worst = max(crossover, key=lambda e: e["device_steady_median_s"] /
                    e["host_steady_median_s"])
        with lock:
            record["crossover_device_profile"] = {
                "table": worst["table"],
                **_host_profile(session, worst["sql"], top=8)}
        log("http crossover: a device run of the " + worst["table"] +
            " statement under cProfile: " +
            json.dumps(record["crossover_device_profile"]))
        wins = [e["rows"] for e in crossover
                if e["device_steady_median_s"] < e["host_steady_median_s"]]
        record["crossover"] = crossover
        record["device_wins_from_rows"] = min(wins) if wins else None
        log(f"http crossover: the device wins from {min(wins) if wins else None}"
            f" rows on (router_host_max_rows = 200,000)")
        # 5. history routing of q6 on the card's timings
        history = []
        for _ in range(10):
            rows, info, wall = probe.run(Q6)
            require(rows == expected["q6"], f"q6 ({info['route']}) "
                    f"differs from the oracle: {rows}")
            history.append({"route": info["route"],
                            "reason": info["routeReason"],
                            "wall_s": wall,
                            "elapsed_s": info["elapsedSeconds"]})
        record["history_q6"] = history
        log("http history routing, q6 ten times: " + json.dumps(history))
        # 6. host routes run beside a q3 that holds the card
        nation_sql = ("SELECT n_name, n_regionkey FROM nation "
                      "WHERE n_nationkey = {}")
        point_rows = {k: in_process(nation_sql.format(k), 1)[0]
                      for k in range(25)}
        out, delta = counts_during(
            lambda: [probe.run(nation_sql.format(k)) for k in range(8)])
        require(not any(delta.values()) and
                all(i["route"] == "host" for _r, i, _w in out),
                f"host-routed point queries launched kernels {delta}")
        alone_walls = sorted(w for _r, _i, w in out)
        q3_done = {}

        def run_q3():
            rows, info, wall = probe.run(Q3, probe.new_client("q3"))
            q3_done.update(rows=rows, info=info, at=time.monotonic(),
                           wall=wall)
        q3_thread = threading.Thread(target=run_q3)
        q3_thread.start()
        _wait_running(coord, Q3)
        done, errors = [], []
        done_lock = threading.Lock()

        def points(t):
            cl = probe.new_client(f"point{t}")
            for i in range(4):
                k = (4 * t + i) % 25
                rows, info, wall = probe.run(nation_sql.format(k), cl)
                with done_lock:
                    if rows != point_rows[k] or info["route"] != "host":
                        errors.append((k, rows, info["route"]))
                    done.append((time.monotonic(), wall))
        threads = [threading.Thread(target=points, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        q3_thread.join(timeout=120)
        require(not errors and len(done) == 64,
                f"point queries beside q3: {len(done)} done, errors "
                f"{errors[:3]}")
        require(q3_done.get("rows") == expected["q3"],
                "q3 beside the point queries differs from the oracle")
        point_walls = sorted(w for _at, w in done)
        record["host_beside_q3"] = {
            "p50_s": point_walls[len(point_walls) // 2],
            "p99_s": point_walls[min(63, int(0.99 * 64))],
            "before_q3": sum(at < q3_done["at"] for at, _w in done),
            "q3_route": q3_done["info"]["route"],
            "q3_wall_s": q3_done["wall"],
            "alone_p50_s": alone_walls[len(alone_walls) // 2]}
        log("http host routes beside q3: "
            + json.dumps(record["host_beside_q3"]))
        # 7. the micro-batcher: 32 point queries on orders at once
        keys = okey[np.linspace(0, len(okey) - 1, 32).astype(np.int64)]
        row_of = {int(k): i for i, k in
                  enumerate(_col(orders, "o_orderkey"))}
        custkey, price = _col(orders, "o_custkey"), \
            _col(orders, "o_totalprice")
        mb_expected = {int(k): _rows_json([(int(custkey[row_of[int(k)]]),
                                            _dec(price[row_of[int(k)]],
                                                 2))])
                       for k in keys}
        probe.set("enable_microbatch", "true")
        probe.set("microbatch_window_ms", "40")
        q0, b0 = MICROBATCH_QUERIES.value(), MICROBATCH_BATCHES.value()
        mb_out, mb_err = {}, []
        barrier = threading.Barrier(32)

        def point_order(k):
            cl = probe.new_client(f"mb{k}")
            barrier.wait()
            try:
                mb_out[k] = probe.run(
                    f"SELECT o_custkey, o_totalprice FROM orders "
                    f"WHERE o_orderkey = {k}", cl)
            except Exception as e:  # noqa: BLE001 — reported below
                mb_err.append((k, repr(e)))
        (_, delta) = counts_during(lambda: _join_all(
            [threading.Thread(target=point_order, args=(int(k),))
             for k in keys]))
        probe.set("enable_microbatch", "false")
        probe.set("microbatch_window_ms", "4")
        dq = MICROBATCH_QUERIES.value() - q0
        db = MICROBATCH_BATCHES.value() - b0
        require(not mb_err, f"micro-batched point queries failed: "
                f"{mb_err[:3]}")
        for k, (rows, info, _w) in mb_out.items():
            require(rows == mb_expected[k], f"o_orderkey = {k}: {rows} vs "
                    f"{mb_expected[k]}")
        routes = sorted({i["route"] for _r, i, _w in mb_out.values()})
        require(db >= 1 and dq > db, f"no coalescing: {dq} queries in "
                f"{db} micro-batches")
        record["microbatch"] = {"queries": dq, "batches": db,
                                "routes": routes, "launches": delta,
                                "walls_s": sorted(w for _r, _i, w in
                                                  mb_out.values())}
        log(f"http micro-batcher: 32 point queries on orders, each its own "
            f"row; {dq} queries in {db} batches; routes {routes}; launches "
            f"{delta}")
        # 8. the result cache
        probe.set("enable_result_cache", "true")
        first = probe.run(Q6)
        second, delta = counts_during(lambda: probe.run(Q6))
        probe.set("enable_result_cache", "false")
        require(second[1]["route"] == "cache" and
                not any(delta.values()) and
                second[0] == first[0] == expected["q6"],
                f"result cache: route {second[1]['route']}, launches "
                f"{delta}")
        record["result_cache"] = {"first_route": first[1]["route"],
                                  "first_wall_s": first[2],
                                  "hit_wall_s": second[2]}
        log(f"http result cache: q6 {first[1]['route']} {first[2]:.4f} s, "
            f"then a hit in {second[2]:.4f} s with no launch")
        # 9. cancel and deadline
        doc = json.loads(_http_post(coord.uri, Q3))
        probe.count()
        _wait_state(coord, doc["id"], "RUNNING")
        # the DELETE should land while the executor runs q3 on the card
        pool = coord.state.dispatcher.session.executor.pool
        t = time.monotonic()
        while pool._current_tag != doc["id"] and time.monotonic() - t < 5:
            time.sleep(0.0005)
        executing = pool._current_tag == doc["id"]
        _http_delete(coord.uri + f"/v1/statement/executing/{doc['id']}/0")
        while "nextUri" in doc:
            doc = json.loads(probe.get(doc["nextUri"][len(coord.uri):]))
        cancel_name = doc.get("error", {}).get("errorName")
        require(cancel_name == "USER_CANCELED", f"DELETE of a running q3 "
                f"ended {doc.get('stats', {}).get('state')} "
                f"({cancel_name})")
        rows, _i, _w = probe.run(Q6)
        require(rows == expected["q6"], "q6 after the cancel")
        probe.set("query_max_run_time_s", "0.001")
        try:
            probe.run(Q3)
            deadline_name = None
        except QueryError as e:
            deadline_name = e.error_name
        with lock:
            # not through the protocol: the SET itself would run under
            # the 1 ms budget
            session.execute("SET SESSION query_max_run_time_s = 0")
        require(deadline_name == "QUERY_EXCEEDED_RUN_TIME",
                f"q3 under a 1 ms budget: {deadline_name}")
        rows, _i, _w = probe.run(Q6)
        require(rows == expected["q6"], "q6 after the deadline")
        record["cancel"] = {"error": cancel_name,
                            "canceled_while_executing": executing,
                            "deadline_error": deadline_name}
        log("http cancel and deadline: " + json.dumps(record["cancel"]))
        # 10. read-backs
        rows, _i, _w = probe.run("EXPLAIN " + Q6)
        routing = [r[0] for r in rows if r[0].startswith("routing: ")]
        require(len(routing) == 1, "EXPLAIN q6 has no routing line")
        metrics = probe.get("/v1/metrics")
        require("trino_tpu_http_requests_total" in metrics and
                "trino_tpu_plan_cache_hits_total" in metrics and
                "trino_tpu_plan_cache_misses_total" in metrics,
                "/v1/metrics lacks the HTTP or plan-cache counters")
        jit = json.loads(probe.get("/v1/jit"))
        sites = sorted({e["site"] for e in jit["entries"]})
        require({"cuda_build.gather", "cuda_build.hash_insert",
                 "cuda_build.direct_agg"} <= set(sites),
                f"/v1/jit lists {sites}")
        ran = probe.statements + 1
        rows, _i, _w = probe.run("SELECT count(*) FROM system.runtime.queries")
        require(rows[0][0] >= ran, f"system.runtime.queries counts "
                f"{rows[0][0]} < {ran} statements")
        record["readbacks"] = {"routing": routing[0], "jit_sites": sites,
                               "jit_totals": jit["totals"],
                               "queries_counted": rows[0][0],
                               "statements": probe.statements}
        log("http read-backs: " + json.dumps(record["readbacks"]))
    finally:
        recorder.active, recorder.keep = False, True
        coord.stop()
        coord.state.dispatcher.pool.shutdown(wait=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts()
    require(launches["K1"] > 0 and launches["K3"] > 0 and
            launches["K5"] > 0, f"the HTTP path launched {launches}")
    record["launches"] = launches
    record["phase_s"] = time.monotonic() - t_phase
    log("http path: " + json.dumps(record, default=str))
    return launches


def _http_post(uri, sql):
    import urllib.request
    req = urllib.request.Request(uri + "/v1/statement", data=sql.encode(),
                                 method="POST",
                                 headers={"X-Trino-User": "chip"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode()


def _http_delete(url):
    import urllib.request
    req = urllib.request.Request(url, method="DELETE",
                                 headers={"X-Trino-User": "chip"})
    urllib.request.urlopen(req, timeout=60).close()


def _wait_state(coord, qid, state, timeout_s=60.0):
    t = time.monotonic()
    while time.monotonic() - t < timeout_s:
        if coord.state.tracker.get(qid).state == state:
            return
        time.sleep(0.0005)
    raise SmokeFailure(f"{qid} never reached {state}")


def _wait_running(coord, sql, timeout_s=60.0):
    """Wait until a tracked query with this text is RUNNING."""
    t = time.monotonic()
    while time.monotonic() - t < timeout_s:
        if any(q.sql == sql and q.state == "RUNNING"
               for q in coord.state.tracker.all()):
            return
        time.sleep(0.0005)
    raise SmokeFailure("the query never started")


def _join_all(threads):
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)


# the cluster path's statements: a distributed CTAS of orders' first
# CLUSTER_ORC_ROWS keys into ORC (a staged write on the workers) and of
# all of orders into the memory connector (which stages no writes: the
# coordinator runs it, as the reference's does)
CLUSTER_ORC_ROWS = 250_000
# the reference's default split size: lineitem at sf1 in 25 splits
CLUSTER_SPLIT_ROWS = 250_000
CLUSTER_ORC_SQL = ("CREATE TABLE orc.out.orders_c AS SELECT o_orderkey, "
                   "o_custkey, o_orderstatus, o_totalprice FROM orders "
                   "WHERE o_orderkey <= {bound}")
CLUSTER_MEMORY_SQL = "CREATE TABLE memory.sf1.orders_c AS SELECT * FROM orders"
VERIFY_QUERIES = (1, 3, 6, 12, 14)


def _put_state(uri, state):
    import urllib.request
    from trino_tpu_torch.server.security import internal_headers
    req = urllib.request.Request(
        uri + "/v1/info/state", data=json.dumps({"state": state}).encode(),
        method="PUT", headers={"Content-Type": "application/json",
                               **internal_headers()})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status


def _wait_for(cond, what, timeout_s=60.0):
    t = time.monotonic()
    while time.monotonic() - t < timeout_s:
        if cond():
            return
        time.sleep(0.002)
    raise SmokeFailure(f"timed out waiting for {what}")


def _decoded(data, name):
    """A column's values as the user sees them (pool strings for VARCHAR
    codes) with NULLs as None-free zeros, for comparing tables whose
    pools may be numbered apart."""
    import numpy as np
    i = data.schema.index_of(name)
    col = np.asarray(data.columns[i])
    pool = data.schema.fields[i].dictionary
    return np.array(pool, dtype=object)[col] if pool else col


def _math_card_counts(tables):
    """Rows of lineitem where the card's sqrt, exp, ln and power differ
    from the port's CPU result (ops/project.py *_like_reference): the CPU
    rounds as the reference's compiled code does (sqrt correctly rounded,
    exp replayed, ln and power through glibc); the card runs the same
    sqrt and exp replay, and ln and power through csrc/glibc_math.cu
    (glibc's algorithms). The arguments are the SQL statements' (ROADMAP
    Queue C 2): ln(l_extendedprice) and sqrt(l_quantity) take the
    unscaled decimal, power(CAST(l_quantity AS double), 1.5) the double,
    exp(CAST(l_extendedprice AS double) / 1000) a spread of 0.9 to 105.
    Every count must be 0. The glibc kernel is also held to its plain
    torch replay on the card, and timed beside that replay and beside
    torch.log / torch.pow on the same columns."""
    import numpy as np
    import torch
    from trino_tpu_torch.ops import project as P
    li = tables["lineitem"]
    price = _col(li, "l_extendedprice").astype(np.float64)
    qty = _col(li, "l_quantity").astype(np.float64)
    cases = {
        "ln": (P.log_like_reference, (price,)),
        "power": (P.pow_like_reference,
                  (qty * (1.0 / 100), np.full(len(qty), 1.5))),
        "exp": (P.exp_like_reference, (price * (1.0 / 100) / 1000,)),
        "sqrt": (P.sqrt_like_reference, (qty,))}
    out = {}
    for name, (fn, args) in cases.items():
        t = time.monotonic()
        # each function is elementwise and only its first argument
        # varies: the CPU computes each distinct argument once (glibc a
        # call at a time) and spreads it over the rows; the card computes
        # every row
        uniq, inv = np.unique(args[0], return_inverse=True)
        rest = (a[:len(uniq)] for a in args[1:])
        cpu = fn(torch.from_numpy(uniq),
                 *(torch.from_numpy(a) for a in rest)).numpy()[inv]
        cpu_s = time.monotonic() - t
        card = fn(*(torch.from_numpy(a).cuda() for a in args)).cpu().numpy()
        differ = int((cpu.view(np.int64) != card.view(np.int64)).sum())
        out[name] = {"rows": len(cpu), "distinct": len(uniq),
                     "differ": differ, "cpu_s": round(cpu_s, 3)}
    require(all(v["differ"] == 0 for v in out.values()),
            f"the card's math differs from the CPU's: {out}")
    # the glibc kernel against its plain replay on the card, and its time
    # beside the replay's and torch's own log / pow (not glibc's bits)
    x = torch.from_numpy(price).cuda()
    q = torch.from_numpy(qty * (1.0 / 100)).cuda()
    h = torch.full_like(q, 1.5)
    for name, kern, plain, lib in (
            ("ln", lambda: P.glibc_math_kernel("log", x),
             lambda: P.glibc_log_plain(x), lambda: torch.log(x)),
            ("power", lambda: P.glibc_math_kernel("pow", q, h),
             lambda: P.glibc_pow_plain(q, h), lambda: torch.pow(q, h))):
        got, want = kern(), plain()
        require(torch.equal(got.view(torch.int64), want.view(torch.int64)),
                f"the glibc {name} kernel differs from its plain replay")
        n_in = 1 if name == "ln" else 2
        out[name].update({
            "kernel_ms": time_cuda(kern), "plain_ms": time_cuda(plain),
            "torch_ms": time_cuda(lib),
            "bound_ms": (n_in + 1) * 8 * x.numel() / HBM_BYTES_PER_S * 1e3,
            "torch_differs_from_glibc": int((lib() != got).sum())})
    return out


def _task_profile(worker, probe, sched, sql, top=15):
    """Where a worker task's host time goes: run `sql` on the cluster
    once, keep the first task with splits that `worker` received, and run
    that task again on this thread under cProfile (one thread: cProfile's
    times stay whole), through the worker's own TaskManager. Its wall, its
    splits, and the `top` functions by cumulative host seconds, as
    [file:function, s, calls]."""
    import cProfile
    import pstats
    import torch
    from trino_tpu_torch.server.tasks import WorkerTask
    tm = worker.task_manager
    seen = []
    real = tm.create_or_update

    def capture(task_id, fragment_blob, splits, *args, **kwargs):
        if splits and not seen:
            seen.append((fragment_blob, list(splits)))
        return real(task_id, fragment_blob, splits, *args, **kwargs)
    tm.create_or_update = capture
    try:
        sched.spool.clear()
        probe.run(sql)
    finally:
        del tm.create_or_update
    require(seen, f"{worker.node_id} received no task with splits")
    task = WorkerTask("profiled-task", *seen[0])
    pr = cProfile.Profile()
    t = time.monotonic()
    pr.enable()
    tm._run(task)
    torch.cuda.synchronize()
    pr.disable()
    wall = time.monotonic() - t
    require(task.state == "FINISHED", f"the profiled task ended "
            f"{task.state}: {task.error[:300]}")
    stats = pstats.Stats(pr).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][3])[:top]
    return {"wall_s": wall, "splits": len(task.splits), "top": [
        [f"{os.path.basename(f)}:{fn}", round(ct, 4), nc]
        for (f, _line, fn), (_cc, nc, _tt, ct, _callers) in rows]}


def phase_cluster_path(recorder, main_session, tables):
    """The cluster on the card: a port CoordinatorServer over its own CUDA
    Session at tpch.sf1 schedules stages onto two port WorkerServers in
    this process, each with its own CUDA executor on the one card (HTTP
    workers share no communicator), with a HeartbeatFailureDetector and
    the reference's default split_rows (250,000: lineitem in 25 splits).
    Counters set to 0 just before and read just after; the spool cleared
    before every run, since a spooled fragment replays without dispatch.
    TPC-H q1, q6, q3 and q12 (K5 under mxu_agg = 'true') one cold and
    three steady runs each, every run distributed (no fallback reason)
    with tasks on both workers and rows equal to the oracles and the
    in-process rows, beside the in-process walls and the same coordinator
    running them itself over HTTP; EXPLAIN ANALYZE of q3 (its stage
    line); q3 with a third worker killed while its task hangs; q1 with a
    worker drained under it (DRAINING -> DRAINED -> LEFT); a distributed
    CTAS of orders' first 250,000 keys into ORC and a CTAS of orders into
    memory, each equal to its source; the port verifier over TPC-H q1,
    q3, q6, q12 and q14 at tpch.tiny on the card against sqlite; and the
    card's ln and power against the CPU's over lineitem."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    from tpch_full import QUERIES
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.orcdir import OrcConnector
    from trino_tpu_torch.connectors.tpch.connector import TABLE_NAMES
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import (CoordinatorServer,
                                                    _rows_json)
    from trino_tpu_torch.server.failuredetector import \
        HeartbeatFailureDetector
    from trino_tpu_torch.server.failureinjector import (DELAY, HANG,
                                                        FailureInjector)
    from trino_tpu_torch.server.worker import WorkerServer
    from trino_tpu_torch.verifier import Verifier
    t_phase = time.monotonic()
    conn = main_session.catalog.connector("tpch")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    os.makedirs(os.path.join(tmp, "orc", "out"))
    cat = Catalog()
    cat.register("tpch", conn)
    cat.register("memory", MemoryConnector())
    cat.register("orc", OrcConnector(os.path.join(tmp, "orc")))
    saved = os.environ.get("TRINO_TPU_HISTORY_PATH")
    os.environ["TRINO_TPU_HISTORY_PATH"] = os.path.join(tmp, "h.jsonl")
    session = Session(cat, default_schema=TPCH_SCHEMA)
    require(session.device.type == "cuda", "the coordinator's Session() "
            "is not on cuda")
    coord = CoordinatorServer(session, max_concurrency=16).start()
    sched = coord.state.scheduler
    sched.split_rows = split_rows = CLUSTER_SPLIT_ROWS
    workers = [WorkerServer(f"chip-w{i}", coord.uri, announce_interval_s=0.1,
                            catalog=cat).start() for i in range(2)]
    extra = []
    detector = HeartbeatFailureDetector(coord.state, interval_s=0.2).start()
    lock = coord.state.dispatcher.exec_lock
    probe = HttpProbe(coord.uri)
    record = {}
    try:
        _wait_for(lambda: len(coord.state.active_nodes()) == 2,
                  "two workers to announce")
        for w in workers:
            require(w.task_manager.device.type == "cuda",
                    f"{w.node_id} runs on {w.task_manager.device}")
        reset_counts()
        recorder.active, recorder.keep = True, False
        stats0 = dict(sched.stats)
        orders = conn.get_table(TPCH_SCHEMA, "orders")
        expected = {
            "q1": oracle_q1(tables["lineitem"]),
            "q6": oracle_q6(tables["lineitem"]),
            "q3": oracle_q3(tables["customer"], orders,
                            tables["lineitem"]),
            "q12": oracle_q12(orders, tables["lineitem"])}
        expected = {k: _rows_json(v) for k, v in expected.items()}

        def cluster_run(sql):
            sched.spool.clear()
            rows, info, wall = probe.run(sql)
            tasks = (sched.last_query or {}).get("tasks", [])
            return rows, info, wall, {
                "tasks": len(tasks),
                "splits": sum(t["splits"] for t in tasks),
                "page_bytes": sum(t["bytes"] for t in tasks),
                "nodes": sorted({t["node"] for t in tasks})}

        def in_process(sql, runs):
            with lock:
                rows, walls = _timed_runs(session, sql, runs)
            return _rows_json(rows), walls

        def local_http(sql, runs):
            """The same coordinator runs the statement itself: no scan is
            larger than split_rows, so the scheduler declines it."""
            sched.split_rows = 1 << 62
            try:
                out = [probe.run(sql) for _ in range(runs)]
            finally:
                sched.split_rows = split_rows
            for _rows, info, _w in out:
                require(info["fallbackReason"] is not None,
                        "the single-coordinator run went distributed")
            return [r for r, _i, _w in out], [w for _r, _i, w in out]

        # 1. q1, q6, q3, then q12 under mxu_agg = 'true' (the workers'
        # executors too: a task's fragment carries no session property,
        # in the reference as here)
        per_query = {}
        for name, sql in (("q1", Q1), ("q6", Q6), ("q3", Q3),
                          ("q12", QUERIES[12])):
            if name == "q12":
                probe.set("mxu_agg", "true")
                for w in workers:
                    w.task_manager._executor.enable_mxu_agg = "true"
            before = read_counts()
            out = [cluster_run(sql) for _ in range(4)]
            after = read_counts()
            delta = {k: after[k] - before[k] for k in after}
            local_rows, local_walls = in_process(sql, 4)
            http_rows, http_walls = local_http(sql, 4)
            if name == "q12":
                probe.set("mxu_agg", "auto")
                for w in workers:
                    w.task_manager._executor.enable_mxu_agg = "auto"
            for rows, info, _w, st in out:
                require(rows == expected[name] == local_rows and
                        all(r == rows for r in http_rows),
                        f"{name} on the cluster differs from the oracle, "
                        f"the in-process or the local HTTP rows:\n"
                        f"{rows[:3]}\nvs\n{expected[name][:3]}")
                require(info["fallbackReason"] is None,
                        f"{name} did not run distributed: "
                        f"{info['fallbackReason']}")
                require(st["nodes"] == sorted(w.node_id for w in workers),
                        f"{name}: tasks ran on {st['nodes']}")
            walls = [w for _r, _i, w, _s in out]
            per_query[name] = {
                "walls_s": walls, "in_process_walls_s": local_walls,
                "local_http_walls_s": http_walls,
                "steady_median_s": statistics.median(walls[1:]),
                "in_process_steady_median_s":
                    statistics.median(local_walls[1:]),
                "local_http_steady_median_s":
                    statistics.median(http_walls[1:]),
                "tasks": out[-1][3]["tasks"],
                "splits": out[-1][3]["splits"],
                "page_bytes": out[-1][3]["page_bytes"],
                "launches": delta}
            log(f"cluster {name}: rows match the oracle, the in-process "
                f"and the local HTTP rows; steady medians cluster "
                f"{per_query[name]['steady_median_s']:.4f} s, in process "
                f"{per_query[name]['in_process_steady_median_s']:.4f} s, "
                f"one coordinator over HTTP "
                f"{per_query[name]['local_http_steady_median_s']:.4f} s; "
                f"cluster walls {[round(w, 4) for w in walls]}; "
                f"{out[-1][3]}; launches {delta}")
        require(per_query["q3"]["launches"]["K1"] > 0 and
                per_query["q3"]["launches"]["K3"] > 0,
                f"q3 on the cluster launched {per_query['q3']['launches']}")
        require(per_query["q12"]["launches"]["K5"] > 0,
                f"q12 on the cluster launched "
                f"{per_query['q12']['launches']}")
        record["tpch"] = per_query
        record["busy_ms"] = {w.node_id: w.task_manager.busy_ms()
                             for w in workers}
        # where a cluster run's time goes: one traced q1, its spans summed
        # by name (under tracing the workers time each operator, with a
        # device sync a node, so its walls are an upper bound)
        probe.set("enable_tracing", "true")
        sched.spool.clear()
        rows, info, wall = probe.run(Q1)
        probe.set("enable_tracing", "false")
        require(rows == expected["q1"], "the traced q1 differs")
        spans = json.loads(probe.get(
            f"/v1/query/{info['queryId']}/trace"))["spans"]
        by_name = {}
        for sp in spans:
            agg = by_name.setdefault(sp["name"], [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += sp.get("durationMs", 0.0)
            agg[2] = max(agg[2], sp.get("durationMs", 0.0))
        record["q1_trace"] = {"wall_s": wall, "spans": {
            k: {"count": c, "total_ms": round(t, 3), "max_ms": round(m, 3)}
            for k, (c, t, m) in sorted(by_name.items())}}
        log("cluster q1 traced, spans by name: " +
            json.dumps(record["q1_trace"]))
        record["q1_task_profile"] = _task_profile(workers[0], probe,
                                                  sched, Q1)
        log("cluster q1, one worker task again under cProfile: " +
            json.dumps(record["q1_task_profile"]))
        log("cluster workers' busy ms (device / host): "
            + json.dumps(record["busy_ms"]))
        # 2. EXPLAIN ANALYZE of q3
        sched.spool.clear()
        rows, info, _w = probe.run("EXPLAIN ANALYZE " + Q3)
        text = "\n".join(r[0] for r in rows)
        require("Stage source: tasks=" in text, "EXPLAIN ANALYZE of q3 "
                "has no `Stage source: tasks=` line")
        record["explain_analyze"] = [line for line in text.splitlines()
                                     if line.lstrip().startswith("Stage")]
        log("cluster EXPLAIN ANALYZE q3: " +
            json.dumps(record["explain_analyze"]))
        # 3. q3 with a third worker killed while its task hangs
        doomed = WorkerServer("chip-doomed", coord.uri,
                              announce_interval_s=0.1, catalog=cat).start()
        extra.append(doomed)
        _wait_for(lambda: len(coord.state.active_nodes()) == 3,
                  "the third worker to announce")
        hang = FailureInjector(seed=11)
        hang.inject("WORKER_TASK_RUN", times=1, fault=HANG, delay_s=120.0)
        doomed.task_manager.injector = hang
        redone = sched.stats["task_retries"] + sched.stats["hedged_tasks"]
        done = {}

        def run(sql, key):
            sched.spool.clear()
            try:
                done[key] = probe.run(sql)
            except Exception as e:  # noqa: BLE001 — reported below
                done[key] = e
        th = threading.Thread(target=run, args=(Q3, "killed"))
        th.start()
        _wait_for(lambda: doomed.task_manager.inflight(),
                  "a task on the third worker")
        t_kill = time.monotonic()
        doomed.kill()
        th.join(timeout=300)
        hang.clear()                  # the dead worker's thread ends
        killed = done.get("killed")
        require(isinstance(killed, tuple), f"q3 with a killed worker: "
                f"{killed!r}")
        require(killed[0] == expected["q3"] and
                killed[1]["fallbackReason"] is None,
                f"q3 with a killed worker: {killed[1]['fallbackReason']}, "
                f"rows {killed[0][:2]}")
        record["killed"] = {"wall_s": killed[2],
                            "after_kill_s": time.monotonic() - t_kill,
                            "retried_or_hedged":
                                sched.stats["task_retries"] +
                                sched.stats["hedged_tasks"] - redone}
        require(record["killed"]["retried_or_hedged"] > 0, "no task was "
                "retried or hedged after the kill")
        log("cluster q3 with a worker killed mid-query: rows match the "
            "oracle; " + json.dumps(record["killed"]))
        # 4. q1 with a worker drained under it
        drainer = workers[1]
        slow = FailureInjector(seed=12)
        slow.inject("WORKER_TASK_RUN", times=1, fault=DELAY, delay_s=1.0)
        drainer.task_manager.injector = slow
        th = threading.Thread(target=run, args=(Q1, "drained"))
        th.start()
        _wait_for(lambda: drainer.task_manager.inflight(),
                  "a task on the worker to drain")
        status = _put_state(drainer.uri, "DRAINING")
        th.join(timeout=300)
        drained = done.get("drained")
        require(isinstance(drained, tuple) and
                drained[0] == expected["q1"] and
                drained[1]["fallbackReason"] is None,
                f"q1 under a drain: {drained!r}"[:400])
        _wait_for(drainer.drained, "DRAINING -> DRAINED -> LEFT")
        _wait_for(lambda: drainer.node_id not in coord.state.nodes,
                  "the drained worker to deregister")
        require(drainer.task_manager.inflight() == [],
                "the drained worker still has tasks")
        record["drained"] = {"status": status, "wall_s": drained[2]}
        log("cluster q1 under a drain: rows match the oracle; the worker "
            "walked to LEFT; " + json.dumps(record["drained"]))
        # 5. CTAS into ORC (distributed) and into memory (the coordinator)
        okey = np.sort(_col(orders, "o_orderkey"))
        bound = int(okey[CLUSTER_ORC_ROWS - 1])
        sched.spool.clear()
        rows, info, wall = probe.run(CLUSTER_ORC_SQL.format(bound=bound))
        write = (sched.last_query or {}).get("write") or {}
        require(rows == [[CLUSTER_ORC_ROWS]] and
                info["fallbackReason"] is None and
                write.get("phase") == "committed",
                f"ORC CTAS: {rows}, {info['fallbackReason']}, {write}")
        got = cat.connector("orc").get_table("out", "orders_c")
        keep = _col(orders, "o_orderkey") <= bound
        go = np.argsort(_col(got, "o_orderkey"), kind="stable")
        so = np.argsort(_col(orders, "o_orderkey")[keep], kind="stable")
        for name in ("o_orderkey", "o_custkey", "o_orderstatus",
                     "o_totalprice"):
            require(np.array_equal(_decoded(got, name)[go],
                                   _decoded(orders, name)[keep][so]),
                    f"orc.out.orders_c.{name} differs from orders")
        record["ctas_orc"] = {"rows": CLUSTER_ORC_ROWS, "wall_s": wall,
                              "write": write}
        rows, info, wall = probe.run(CLUSTER_MEMORY_SQL)
        require(rows == [[orders.num_rows]], f"memory CTAS: {rows}")
        rep = Replica(orders)
        rep.name = "orders_c"
        _check_stored(session, rep, ["o_orderkey"])
        record["ctas_memory"] = {"rows": orders.num_rows, "wall_s": wall,
                                 "fallback": info["fallbackReason"]}
        log("cluster CTAS: " + json.dumps({k: record[k] for k in
                                           ("ctas_orc", "ctas_memory")},
                                          default=str))
        # 6. the verifier on the card at tpch.tiny against sqlite
        t = time.monotonic()
        verifier = Verifier(Session(default_schema="tiny"),
                            list(TABLE_NAMES))
        results = verifier.run_suite({q: QUERIES[q] for q in VERIFY_QUERIES})
        bad = [(r.name, r.status, r.detail) for r in results
               if r.status != "MATCH"]
        require(not bad, f"verifier: {bad}")
        record["verifier"] = {"queries": [r.name for r in results],
                              "wall_s": time.monotonic() - t}
        log("cluster verifier on the card: every query MATCH; " +
            json.dumps(record["verifier"]))
        stats = {k: sched.stats.get(k, 0) - stats0.get(k, 0)
                 for k in ("tasks", "task_retries", "hedged_tasks",
                           "hedge_wins", "spool_hits", "splits_migrated")}
        record["scheduler"] = stats
        log("cluster scheduler: " + json.dumps(stats))
    finally:
        recorder.active, recorder.keep = False, True
        detector.stop()
        for w in workers + extra:
            w.stop(graceful=False)
        coord.stop()
        coord.state.dispatcher.pool.shutdown(wait=True)
        if saved is None:
            os.environ.pop("TRINO_TPU_HISTORY_PATH", None)
        else:
            os.environ["TRINO_TPU_HISTORY_PATH"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts()
    require(launches["K1"] > 0 and launches["K3"] > 0 and
            launches["K5"] > 0, f"the cluster path launched {launches}")
    record["launches"] = launches
    # not a main-path measurement: after the counts are read
    record["math_card_vs_cpu"] = _math_card_counts(tables)
    log("cluster ln/power/exp/sqrt, card against CPU over lineitem: " +
        json.dumps(record["math_card_vs_cpu"]))
    record["phase_s"] = time.monotonic() - t_phase
    log("cluster path: " + json.dumps(record, default=str))
    return launches


# --------------------------------------------------------------------------
# the fault-tolerance tier on the card
# --------------------------------------------------------------------------

FT_SEEDS = tuple(range(6))        # 0-7 put the phase past 150 s
FT_CONCAT_SQL = ("SELECT l_orderkey, l_quantity FROM lineitem "
                 "WHERE l_shipdate > DATE '1998-11-01'")
FT_MEMORY_SLACK = 256 << 20       # card growth allowed over the seeds
FT_CTAS_SPLIT_ROWS = 50_000       # customer's 150,000 rows in 3 splits
FT_FAILOVER_TIMEOUT_S = 120
FT_CTAS_SQL = ("CREATE TABLE orc.out.customer_ft AS SELECT c_custkey, "
               "c_name, c_nationkey, c_acctbal, c_mktsegment FROM customer")
FT_CTAS_COLUMNS = ("c_custkey", "c_name", "c_nationkey", "c_acctbal",
                   "c_mktsegment")
FT_INSERT_SQL = ("INSERT INTO orc.out.customer_ft SELECT c_custkey, c_name, "
                 "c_nationkey, c_acctbal, c_mktsegment FROM customer")
# the coordinator-chaos soak's WRITE_COMMIT seeds (4: detector promotion,
# 9: admin promotion) with every coordinator at split_rows 4096
FT_FENCE_SEEDS = (4, 9)
FT_FENCE_SPLIT_ROWS = 4096


def _allocated() -> int:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _ft_catalog(conn, orc_root=None):
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.orcdir import OrcConnector
    cat = Catalog()
    cat.register("tpch", conn)
    cat.register("memory", MemoryConnector())
    if orc_root is not None:
        cat.register("orc", OrcConnector(orc_root))
    return cat


def _ft_chaos(record, coord, workers, probe, expected):
    """(a) seeds 0-5 of FailureInjector.from_seed on the scheduler, the
    failure detector and every worker, then the reference's explicit
    injections for a crash mid-split, a corrupted drained page, dropped
    task creates and a hedged straggler; every run bit-equal to the
    fault-free run."""
    from trino_tpu_torch.server.failureinjector import (CORRUPT, CRASH,
                                                        DELAY, DROP,
                                                        FailureInjector)
    sched = coord.state.scheduler
    det = coord.state.failure_detector
    counts0 = read_counts()
    queries = (("q1", Q1, False), ("q3", Q3, False), ("q6", Q6, False),
               ("concat", FT_CONCAT_SQL, True))

    def run(sql, unordered, clear=True):
        if clear:
            sched.spool.clear()
        rows, info, wall = probe.run(sql)
        require(info["state"] == "FINISHED", f"state {info['state']}")
        if unordered:
            rows = sorted(map(tuple, rows))
        return rows, info, wall

    base = {}
    for name, sql, unordered in queries:
        walls = []
        for i in range(4):          # the first warms the workers' caches
            rows, info, wall = run(sql, unordered)
            require(rows == expected[name], f"fault-free {name} differs "
                    f"from its oracle: {rows[:2]}")
            require(info["fallbackReason"] is None,
                    f"fault-free {name}: {info['fallbackReason']}")
            walls.append(wall)
        base[name] = statistics.median(walls[1:])
    record["fault_free_walls_s"] = base

    def arm(inj, on_workers=None):
        sched.failure_injector = inj
        if det is not None:
            det.injector = inj
        for w in (workers if on_workers is None else on_workers):
            w.task_manager.injector = inj

    def disarm(inj):
        sched.failure_injector = None
        sched.spool.injector = None
        if det is not None:
            det.injector = None
        for w in workers:
            w.task_manager.injector = None
        inj.clear()
        _wait_for(lambda: len(coord.state.active_nodes()) == len(workers),
                  "every worker to be ACTIVE again", timeout_s=30)

    def schedule(label, inj, names, on_workers=None):
        keys = ("task_retries", "hedged_tasks", "checksum_failures")
        s0 = {k: sched.stats[k] for k in keys}
        rej0 = sched.spool.checksum_rejects
        arm(inj, on_workers)
        runs = []
        try:
            for name, sql, unordered in queries:
                if name not in names:
                    continue
                n0 = len(inj.events)
                rows, info, wall = run(sql, unordered)
                require(rows == expected[name],
                        f"{label} changed the rows of {name}")
                events = inj.events[n0:]
                fired = [(p, f) for _t, p, f, _k in events]
                # one flip a page: a container's pages may take several
                spool_corrupt = len({k for _t, p, f, k in events
                                     if (p, f) == ("SPOOL_WRITE", CORRUPT)})
                if spool_corrupt:
                    # the spool's CRC catches each corrupted container on
                    # the next read: replay from the spool, faults off
                    saved = sched.failure_injector
                    sched.failure_injector = sched.spool.injector = None
                    r0 = sched.spool.checksum_rejects
                    again, _i, _w = run(sql, unordered, clear=False)
                    require(again == expected[name], f"{label}: the spool "
                            f"replay of {name} differs")
                    require(sched.spool.checksum_rejects - r0 ==
                            spool_corrupt, f"{label}: {spool_corrupt} "
                            f"corrupted spool containers, "
                            f"{sched.spool.checksum_rejects - r0} caught")
                    sched.failure_injector = saved
                runs.append({"query": name, "wall_s": wall,
                             "recovery_s": wall - base[name],
                             "fired": fired})
        finally:
            disarm(inj)
        delta = {k: sched.stats[k] - s0[k] for k in keys}
        drain_corrupt = sum(r["fired"].count(("EXCHANGE_DRAIN", CORRUPT))
                            for r in runs)
        require(delta["checksum_failures"] == drain_corrupt,
                f"{label}: {drain_corrupt} corrupted drained pages, "
                f"{delta['checksum_failures']} checksum failures")
        if drain_corrupt:
            require(delta["task_retries"] >= drain_corrupt,
                    f"{label}: corrupted pages were not retried")
        out = {"label": label, "runs": runs, **delta,
               "spool_rejects": sched.spool.checksum_rejects - rej0,
               "allocated": _allocated()}
        log(f"fault tolerance chaos {label}: rows equal the fault-free "
            f"runs; fired {[f for r in runs for f in r['fired']]}; "
            f"retries {delta['task_retries']}, hedges "
            f"{delta['hedged_tasks']}, checksum failures "
            f"{delta['checksum_failures']}; walls "
            f"{[round(r['wall_s'], 4) for r in runs]}; card allocation "
            f"{out['allocated']} B")
        return out

    all_names = {q[0] for q in queries}
    seeds = [schedule(f"seed {s}",
                      FailureInjector.from_seed(s, max_delay_s=0.2),
                      all_names) for s in FT_SEEDS]
    growth = seeds[-1]["allocated"] - seeds[0]["allocated"]
    require(growth <= FT_MEMORY_SLACK, f"the card's allocation grew by "
            f"{growth} B over the seeds")
    # the reference's explicit injections (tests/test_chaos.py): a crash
    # mid-split on one worker, a corrupted drained page, two dropped task
    # creates, and a straggler the scheduler hedges
    crash = FailureInjector(seed=103)
    crash.inject("WORKER_TASK_RUN", times=1, fault=CRASH)
    corrupt = FailureInjector(seed=101)
    corrupt.inject("EXCHANGE_DRAIN", times=1, fault=CORRUPT)
    drop = FailureInjector(seed=104)
    drop.inject("WORKER_TASK_CREATE", times=2, fault=DROP)
    slow = FailureInjector(seed=102)
    slow.inject("WORKER_TASK_RUN", times=1, fault=DELAY, delay_s=1.5)
    explicit = [schedule("crash mid-split", crash, {"q3"},
                         on_workers=[workers[1]]),
                schedule("corrupt drain", corrupt, {"q1"}),
                schedule("dropped creates", drop, {"q6"})]
    hedge = (sched.hedge_min_s, sched.hedge_multiplier)
    sched.hedge_min_s, sched.hedge_multiplier = 0.1, 2.0
    try:
        explicit.append(schedule("straggler", slow, {"q3"},
                                 on_workers=[workers[0]]))
    finally:
        sched.hedge_min_s, sched.hedge_multiplier = hedge
    require(explicit[-1]["hedged_tasks"] > 0, "the straggler was not "
            "hedged")
    by_type = {}
    for sch in seeds + explicit:
        for r in sch["runs"]:
            for _p, fault in r["fired"]:
                t = by_type.setdefault(fault, {"fired": 0, "runs": 0,
                                               "recovery_s": []})
                t["fired"] += 1
            for fault in {f for _p, f in r["fired"]}:
                by_type[fault]["runs"] += 1
                by_type[fault]["recovery_s"].append(r["recovery_s"])
        for fault in {f for r in sch["runs"] for _p, f in r["fired"]}:
            by_type[fault].setdefault("retries", 0)
            by_type[fault].setdefault("hedges", 0)
            by_type[fault]["retries"] += sch["task_retries"]
            by_type[fault]["hedges"] += sch["hedged_tasks"]
    for fault in (CRASH, DELAY, DROP, CORRUPT):
        require(fault in by_type, f"no {fault} fired over the matrix")
    counts = read_counts()
    chaos_launches = {k: counts[k] - counts0[k] for k in counts}
    require(chaos_launches["K1"] > 0 and chaos_launches["K3"] > 0,
            f"the chaos runs launched {chaos_launches}")
    for t in by_type.values():
        t["recovery_median_s"] = statistics.median(t["recovery_s"])
    record["chaos"] = {
        "seeds": [{k: v for k, v in s.items() if k != "runs"}
                  | {"walls_s": [r["wall_s"] for r in s["runs"]]}
                  for s in seeds],
        "explicit": [{k: v for k, v in s.items() if k != "runs"}
                     | {"walls_s": [r["wall_s"] for r in s["runs"]]}
                     for s in explicit],
        "by_fault": by_type, "allocation_growth_b": growth,
        "launches": chaos_launches}
    log("fault tolerance chaos by fault type: " + json.dumps(by_type))


def _ft_pair_state(standby, workers) -> str:
    """What a stuck failover left on the standby and the workers."""
    st = standby.state
    tasks = {w.node_id: [(t.task_id, t.state, (t.error or "")[:300])
                         for t in list(w.task_manager.tasks.values())[-3:]]
             for w in workers}
    queries = [(q.query_id, q.state, getattr(q, "resumed", None))
               for q in st.tracker.all()]
    return (f"standby role {st.role}, nodes "
            f"{sorted(n.node_id for n in st.active_nodes())}, "
            f"queries {queries}, scheduler {dict(st.scheduler.stats)}, "
            f"worker tasks {tasks}")


def _ft_failover(record, conn, tables, expected, tmp):
    """(b) a primary and a warm standby over one ledger and spool root,
    two workers on the card and a two-address Client: the primary killed
    while q3 runs (the standby promoted by its detector), then a second
    pair killed at WRITE_COMMIT of a distributed CTAS of customer into
    ORC (the standby promoted by the admin PUT)."""
    import numpy as np
    from trino_tpu_torch.client.client import Client
    from trino_tpu_torch.connectors.orcdir import OrcConnector
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server import writeprotocol as wp
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.failureinjector import (HANG,
                                                        FailureInjector)
    from trino_tpu_torch.server.worker import WorkerServer

    def pair(tag, auto_promote, split_rows, orc_root=None):
        ledger = os.path.join(tmp, f"{tag}.ledger")
        spool = os.path.join(tmp, f"{tag}-spool")
        cats = [_ft_catalog(conn, orc_root) for _ in range(3)]
        primary = CoordinatorServer(
            Session(cats[0], default_schema=TPCH_SCHEMA),
            max_concurrency=8, ledger_path=ledger, node_id=f"{tag}-p",
            spool_root=spool).start()
        standby = CoordinatorServer(
            Session(cats[1], default_schema=TPCH_SCHEMA),
            max_concurrency=8, ledger_path=ledger, node_id=f"{tag}-s",
            role="standby", peer_uri=primary.uri, spool_root=spool,
            standby_interval_s=0.1, auto_promote=auto_promote).start()
        for c in (primary, standby):
            c.state.scheduler.split_rows = split_rows
        workers = [WorkerServer(f"{tag}-w{i}", primary.uri,
                                announce_interval_s=0.1,
                                catalog=cats[2]).start() for i in range(2)]
        _wait_for(lambda: len(primary.state.active_nodes()) == 2,
                  f"{tag}: two workers to announce")
        for w in workers:
            w.announce_once()          # learn the standby's address
        return primary, standby, workers

    def down(primary, standby, workers):
        for w in workers:
            w.stop(graceful=False)
        for c in (primary, standby):
            try:
                c.kill()
            except Exception:  # noqa: BLE001 — killed servers die twice
                pass
            c.state.dispatcher.pool.shutdown(wait=False)

    def client_run(client, sql, out):
        try:
            out["result"] = client.execute(sql)
        except Exception as e:  # noqa: BLE001 — reported below
            out["error"] = e

    # kill 1: q3 RUNNING on the primary, the detector promotes
    primary, standby, workers = pair("fo1", True, CLUSTER_SPLIT_ROWS)
    hold = FailureInjector()
    try:
        client = Client([primary.uri, standby.uri], user="ft",
                        timeout_s=300, poll_interval_s=0.001)
        r = client.execute(Q3)
        require(r.rows == expected["q3"], "q3 before the kill differs")
        # the primary's own executor holds lineitem on the card: q6 run
        # by the coordinator itself (no scan above split_rows)
        primary.state.scheduler.split_rows = 1 << 62
        client.execute("SET SESSION routing_mode = 'device'")
        r = client.execute(Q6)
        client.execute("SET SESSION routing_mode = 'auto'")
        primary.state.scheduler.split_rows = CLUSTER_SPLIT_ROWS
        require(r.rows == expected["q6"], "local q6 differs")
        held = primary.state.session.executor.device_cache_bytes()
        require(held > 0, "the primary's executor caches nothing")
        # q3 holds inside its execution until the pair comes down: the
        # killed primary's thread does no more work, as a dead process
        # would (released, it would dispatch the query id's tasks beside
        # the standby's)
        inj = hold = FailureInjector()
        primary.state.dispatcher.failure_injector = inj
        inj.inject("EXECUTION", times=1, fault=HANG, delay_s=600.0,
                   match_sql="c_mktsegment")
        out = {}
        th = threading.Thread(target=client_run, args=(client, Q3, out))
        alloc_before = _allocated()
        th.start()
        _wait_for(lambda: any(q.state == "RUNNING"
                              for q in primary.state.tracker.all()
                              if "c_mktsegment" in q.sql),
                  "q3 RUNNING on the primary")
        ex = primary.state.session.executor
        at_kill = ex.device_cache_bytes()
        t_kill = time.monotonic()
        primary.kill()
        left = ex.device_cache_bytes()
        require(left == 0, f"the dead primary kept {left} B of device "
                f"caches")
        th.join(timeout=FT_FAILOVER_TIMEOUT_S)
        after_kill_s = time.monotonic() - t_kill
        require("result" in out, f"q3 across the failover: "
                f"{out.get('error')!r}; {_ft_pair_state(standby, workers)}")
        r = out["result"]
        require(r.rows == expected["q3"], "q3 across the failover differs "
                "from its oracle")
        require(r.failovers >= 1, "the client saw no failover")
        require(standby.state.role == "PRIMARY", "the standby was not "
                "promoted")
        tq = standby.state.tracker.get(r.query_id)
        require(tq is not None and tq.state == "FINISHED",
                "the standby does not hold the query FINISHED")
        alloc_after = _allocated()
        record["kill_running"] = {
            "query_id": r.query_id, "resumed": tq.resumed,
            "failovers": r.failovers,
            "kill_to_result_s": after_kill_s,
            "dead_primary_cache_released_b": at_kill,
            "allocated_before_b": alloc_before,
            "allocated_after_b": alloc_after}
        log("fault tolerance failover, q3 killed RUNNING: oracle rows "
            "through the promoted standby; " +
            json.dumps(record["kill_running"]))
    finally:
        down(primary, standby, workers)
        hold.clear()

    # kill 2: the primary dies inside WRITE_COMMIT; the admin promotes
    orc_root = os.path.join(tmp, "orc")
    os.makedirs(os.path.join(orc_root, "out"))
    primary, standby, workers = pair("fo2", False, FT_CTAS_SPLIT_ROWS,
                                     orc_root)
    inj = FailureInjector()
    try:
        inj.inject("WRITE_COMMIT", times=1, fault=HANG, delay_s=600.0)
        primary.state.scheduler.failure_injector = inj
        client = Client([primary.uri, standby.uri], user="ft",
                        timeout_s=300, poll_interval_s=0.001)
        out = {}
        th = threading.Thread(target=client_run,
                              args=(client, FT_CTAS_SQL, out))
        th.start()
        _wait_for(lambda: any(p == "WRITE_COMMIT"
                              for _t, p, _f, _k in inj.events),
                  "the CTAS to reach WRITE_COMMIT", timeout_s=120)
        t_kill = time.monotonic()
        primary.kill()
        status = _put_state(standby.uri, "PRIMARY")
        th.join(timeout=FT_FAILOVER_TIMEOUT_S)
        after_kill_s = time.monotonic() - t_kill
        require("result" in out, f"CTAS across the failover: "
                f"{out.get('error')!r}; {_ft_pair_state(standby, workers)}")
        r = out["result"]
        n = tables["customer"].num_rows
        require(r.rows == [[n]], f"CTAS across the failover: {r.rows}")
        table_dir = os.path.join(orc_root, "out", "customer_ft")

        got = OrcConnector(orc_root).get_table("out", "customer_ft")
        cust = tables["customer"]
        require(got.num_rows == n, f"after the failover: {got.num_rows} "
                f"rows, customer has {n}")
        go = np.argsort(_col(got, "c_custkey"), kind="stable")
        so = np.argsort(_col(cust, "c_custkey"), kind="stable")
        for name in FT_CTAS_COLUMNS:
            require(np.array_equal(_decoded(got, name)[go],
                                   _decoded(cust, name)[so]),
                    f"after the failover: orc.out.customer_ft.{name} "
                    f"differs from customer")
        tq = standby.state.tracker.get(r.query_id)
        # the standby's commit, distributed or on its own path, is keyed
        # by the query id (ROADMAP Queue C 6)
        committed = wp.published_rows_for(table_dir, r.query_id)
        require(committed == n, f"CTAS across the failover: {committed} "
                f"rows published under {r.query_id}, customer has {n}")
        parts = wp.list_parts(table_dir)
        # the dead primary's thread, released from its hang, goes on into
        # its commit: the fence refuses the commit and the abort, and the
        # standby's table stays as it is (Queue C 7)
        dead = [q for q in primary.state.tracker.all()
                if q.query_id == r.query_id]
        inj.release_hangs()
        _wait_for(lambda: all(q.state_machine.is_done() for q in dead),
                  "the dead primary's CTAS to end", timeout_s=60)
        refusals = [(f["op"], f["why"])
                    for f in primary.state.ledger.fence_refusals]
        require(dead and all(q.state == "FAILED" and "fenced" in (
            q.state_machine.error or "") for q in dead),
            f"the dead primary's CTAS: "
            f"{[(q.state, q.state_machine.error) for q in dead]}")
        require(("commit", "sealed") in refusals and
                ("abort", "sealed") in refusals,
                f"the dead primary's fence refusals: {refusals}")
        require(wp.list_parts(table_dir) == parts and
                wp.published_rows_for(table_dir, r.query_id) == n,
                "the dead primary's commit changed the table")
        record["kill_write_commit"] = {
            "query_id": r.query_id, "status": status,
            "resumed": getattr(tq, "resumed", None),
            "standby_tasks": standby.state.scheduler.stats["tasks"],
            "committed_under_query_id": committed == n,
            "dead_primary_refusals": refusals,
            "failovers": r.failovers, "kill_to_result_s": after_kill_s,
            "parts": len(parts)}
        log("fault tolerance failover, CTAS killed at WRITE_COMMIT: "
            "customer exactly once; " +
            json.dumps(record["kill_write_commit"]))
    finally:
        down(primary, standby, workers)
        inj.clear()

    # the same CTAS resumed a second time: a third coordinator boots on
    # the ledger without its terminal records
    record["ctas_resumed_again"] = _ft_resume_again(
        conn, orc_root, os.path.join(tmp, "fo2.ledger"), r.query_id,
        "customer_ft", n, n)
    log("fault tolerance failover, CTAS resumed again: "
        + json.dumps(record["ctas_resumed_again"]))

    # a local INSERT on a coordinator with no workers (the path Queue
    # C 6 broke), then resumed twice the same way
    ledger = os.path.join(tmp, "fo3.ledger")
    coord = CoordinatorServer(
        Session(_ft_catalog(conn, orc_root), default_schema=TPCH_SCHEMA),
        max_concurrency=8, ledger_path=ledger, node_id="fo3-c").start()
    try:
        t0 = time.monotonic()
        r = Client(coord.uri, user="ft", timeout_s=300).execute(
            FT_INSERT_SQL)
        wall = time.monotonic() - t0
        require(r.rows == [[n]], f"local INSERT: {r.rows}")
        info = Client(coord.uri, user="ft").query_info(r.query_id)
        require(info.get("fallbackReason") == "no active workers",
                f"local INSERT ran {info.get('fallbackReason')!r}")
        committed = wp.published_rows_for(table_dir, r.query_id)
        require(committed == n, f"local INSERT: {committed} rows "
                f"published under {r.query_id}")
    finally:
        coord.kill()
        coord.state.dispatcher.pool.shutdown(wait=False)
    out = {"query_id": r.query_id, "wall_s": wall}
    for k in ("first", "second"):
        out[k] = _ft_resume_again(conn, orc_root, ledger, r.query_id,
                                  "customer_ft", n, 2 * n)
    record["local_insert_resumed"] = out
    log("fault tolerance failover, local INSERT resumed twice: "
        + json.dumps(out))


def _ft_resume_again(conn, orc_root, ledger, qid, table, rows, total):
    """Resume the write `qid` once more: the ledger rewritten without its
    terminal records and a coordinator booted on it (the crash between a
    commit and its terminal record). The resumption must find the commit
    under `qid`, return `rows`, and leave the parts as they were and the
    table at `total` rows."""
    from trino_tpu_torch.connectors.orcdir import OrcConnector
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server import writeprotocol as wp
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    table_dir = os.path.join(orc_root, "out", table)
    parts = wp.list_parts(table_dir)
    records, _ = wp.replay_journal(ledger)
    with open(ledger, "wb") as f:
        for rec in records:
            if rec.get("rec") != "terminal":
                f.write(wp._frame(rec))
    os.unlink(ledger + ".epoch")
    t0 = time.monotonic()
    coord = CoordinatorServer(
        Session(_ft_catalog(conn, orc_root), default_schema=TPCH_SCHEMA),
        ledger_path=ledger, node_id=f"resume-{time.monotonic_ns()}")
    try:
        tq = coord.state.tracker.get(qid)
        require(tq is not None and tq.resumed, f"{qid} was not resumed")
        _wait_for(lambda: tq.state_machine.is_done(),
                  f"the resumed {qid} to end", timeout_s=120)
        boot_to_rows_s = time.monotonic() - t0
        require(tq.state == "FINISHED", f"resumed {qid}: {tq.state} "
                f"{tq.state_machine.error}")
        require([tuple(x) for x in tq.result.rows] == [(rows,)],
                f"resumed {qid} returned {tq.result.rows}")
        require(wp.list_parts(table_dir) == parts,
                f"resumed {qid} changed the parts of {table}")
        require(wp.published_rows_for(table_dir, qid) == rows,
                f"resumed {qid}: published rows changed")
        got = OrcConnector(orc_root).get_table("out", table).num_rows
        require(got == total, f"after resuming {qid}: {table} has {got} "
                f"rows, {total} expected")
    finally:
        coord.kill()
        coord.state.dispatcher.pool.shutdown(wait=False)
    return {"resumed": tq.resumed, "boot_to_rows_s": boot_to_rows_s,
            "parts": len(parts)}


class _LocalPathWrites:
    """Counts the staged writes a coordinator's dispatch thread commits
    with no query id (`local_<uuid>`, ROADMAP Queue C 6) while active."""

    def __enter__(self):
        from trino_tpu_torch.server import writeprotocol as wp
        self.ids, self._wp, self._commit = [], wp, wp.commit

        def counting(table_dir, query_id, *args, **kwargs):
            if query_id.startswith("local_") and threading.current_thread(
                    ).name.startswith("dispatch"):
                self.ids.append(query_id)
            return self._commit(table_dir, query_id, *args, **kwargs)

        wp.commit = counting
        return self

    def __exit__(self, *exc):
        self._wp.commit = self._commit


def _ft_write_fence(record):
    """(f) Queue C 7's configuration: the coordinator-chaos soak's
    WRITE_COMMIT seeds with both coordinators' sessions at split_rows
    4096, so the standby's resumed CTAS of orders goes distributed while
    the killed primary's dispatch thread runs on (its CRASH at
    WRITE_COMMIT injected). Its fence refusals are printed; no client
    error, no lost or duplicate row, the table published under the
    client's query id, and no local-path write."""
    from trino_tpu_torch import soak
    from trino_tpu_torch.exec.session import SESSION_PROPERTY_DEFAULTS
    saved = SESSION_PROPERTY_DEFAULTS["split_rows"]
    SESSION_PROPERTY_DEFAULTS["split_rows"] = (FT_FENCE_SPLIT_ROWS, int)
    out = {}
    try:
        for seed in FT_FENCE_SEEDS:
            with _LocalPathWrites() as local:
                one = soak.coordinator_chaos_seed(seed, device=SOAK_DEVICE)
            line = {"phase": one["phase"],
                    "promotion": "admin" if one["admin_promotions"]
                    else "detector",
                    "client_error": one["client_error"],
                    "error": one.get("error"),
                    "kill_to_rows_s": None if one["failover_ms"] is None
                    else one["failover_ms"] / 1000,
                    "resumed": one["resumed"],
                    "lost_rows": one["lost_rows"],
                    "dup_rows": one["dup_rows"],
                    "committed_rows": one["committed_rows"],
                    "local_path_writes": len(local.ids),
                    "dead_primary_refusals": [
                        (f["op"], f["why"], f["target"])
                        for f in one["fence_refusals"]]}
            out[seed] = line
            log(f"fault tolerance write fence, seed {seed}: "
                + json.dumps(line))
            require(one["phase"] == "WRITE_COMMIT" and
                    not one["client_error"] and one["lost_rows"] == 0 and
                    one["dup_rows"] == 0 and
                    one["committed_rows"] == 15000 and not local.ids,
                    f"write fence seed {seed}: {line}")
    finally:
        SESSION_PROPERTY_DEFAULTS["split_rows"] = saved
    record["write_fence"] = out


def _ft_resource_groups(record, coord, expected):
    """(c) hard_concurrency_limit = 1: three clients submit q6 together,
    one runs and two queue; then max_queued = 1 rejects the third."""
    from trino_tpu_torch.client.client import Client, QueryError
    from trino_tpu_torch.server.failureinjector import (DELAY,
                                                        FailureInjector)
    from trino_tpu_torch.server.resourcegroups import (ResourceGroupConfig,
                                                       ResourceGroupManager)
    disp = coord.state.dispatcher
    saved_rg, saved_inj = disp.resource_groups, disp.failure_injector

    def together(max_queued):
        disp.resource_groups = rgm = ResourceGroupManager(
            ResourceGroupConfig("root", hard_concurrency_limit=1,
                                max_queued=max_queued))
        inj = FailureInjector()
        # the first q6 holds the one slot for a second
        inj.inject("EXECUTION", times=1, fault=DELAY, delay_s=1.0,
                   match_sql="l_discount BETWEEN")
        disp.failure_injector = inj
        coord.state.scheduler.spool.clear()
        outs = [{} for _ in range(3)]

        def go(i):
            try:
                outs[i]["rows"] = Client(coord.uri, user=f"rg{i}",
                                         poll_interval_s=0.001).execute(
                    Q6).rows
            except QueryError as e:
                outs[i]["error"] = e.error_name
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(3)]
        threads[0].start()
        _wait_for(lambda: rgm.info()[0]["running"] == 1,
                  "the first q6 to take the slot")
        for th in threads[1:]:
            th.start()
        for th in threads:
            th.join(timeout=300)
        require(not any(th.is_alive() for th in threads),
                "a queued q6 never finished")
        return outs, rgm.info()[0]

    try:
        outs, info = together(10)
        require(all(o.get("rows") == expected["q6"] for o in outs),
                f"queued q6 runs: {outs}")
        require(info["peakQueued"] == 2 and info["totalAdmitted"] == 3,
                f"resource group after three q6: {info}")
        outs2, info2 = together(1)
        errors = [o["error"] for o in outs2 if "error" in o]
        require(errors == ["QUERY_QUEUE_FULL"] and
                sum(o.get("rows") == expected["q6"] for o in outs2) == 2,
                f"max_queued = 1: {outs2}")
        record["resource_groups"] = {
            "queued_s": info["totalQueueWaitSeconds"],
            "avg_queued_s": info["avgQueueWaitSeconds"],
            "peak_queued": info["peakQueued"],
            "queue_full": errors, "after_queue_full": info2}
        log("fault tolerance resource groups: one q6 ran and two queued, "
            "all equal the oracle; max_queued = 1 rejected the third "
            "with QUERY_QUEUE_FULL; " +
            json.dumps(record["resource_groups"]))
    finally:
        disp.resource_groups, disp.failure_injector = saved_rg, saved_inj


def _ft_live_and_timeline(record, coord, workers, probe, expected):
    """(d) q3 traced and profiled with a 1 s DELAY on one worker: the
    progress pages stay in [0, 1] and never fall, the live surfaces fill,
    the utilization rows show the card; the timeline's phases sum to the
    wall, with a device phase."""
    from trino_tpu_torch.client.client import Client
    from trino_tpu_torch.server.failureinjector import (DELAY,
                                                        FailureInjector)
    ls = coord.state.livestats
    ratios, seen = [], {"live_queries": 0, "live_tasks": 0, "http": []}
    # session properties live on the coordinator; traced tasks fence
    # their operators, which is what puts card time in `device`
    for name in ("enable_tracing", "enable_profiling"):
        probe.set(name, "true")
    inj = FailureInjector(seed=21)
    inj.inject("WORKER_TASK_RUN", times=1, fault=DELAY, delay_s=1.0)
    workers[0].task_manager.injector = inj
    client = Client(coord.uri, user="chip", poll_interval_s=0.001,
                    on_progress=lambda st: ratios.append(
                        st.get("progressRatio")))
    done = threading.Event()

    def poll():
        while not done.is_set():
            for q in ls.live_queries():
                if q["state"] == "RUNNING" and q["tasks"] > 0:
                    seen["live_queries"] += 1
                    seen["live_tasks"] = max(seen["live_tasks"],
                                             len(ls.live_tasks()))
                    doc = json.loads(probe.get(
                        f"/v1/query/{q['query_id']}"))
                    seen["http"].append(doc.get("progressRatio"))
            time.sleep(0.02)
    th = threading.Thread(target=poll)
    coord.state.scheduler.spool.clear()
    th.start()
    try:
        r = client.execute(Q3)
    finally:
        done.set()
        th.join()
        workers[0].task_manager.injector = None
        inj.clear()
        for name in ("enable_tracing", "enable_profiling"):
            probe.set(name, "false")
    require(r.rows == expected["q3"], "the live q3 differs")
    got = [x for x in ratios if x is not None]
    require(got and all(0.0 <= x <= 1.0 for x in got) and
            all(b >= a for a, b in zip(got, got[1:])) and got[-1] == 1.0,
            f"progress pages {got}")
    http = [x for x in seen["http"] if x is not None]
    require(all(0.0 <= x <= 1.0 for x in http) and
            all(b >= a for a, b in zip(http, http[1:])),
            f"/v1/query progress {http}")
    require(seen["live_queries"] > 0 and seen["live_tasks"] > 0,
            f"the live surfaces stayed empty: {seen}")
    util = ls.utilization()
    device = {u["node_id"]: u["busy_ms"] for u in util
              if u["tier"] == "device"}
    require(any(v > 0 for v in device.values()),
            f"no card worker shows device busy time: {util}")
    tl = json.loads(probe.get(f"/v1/query/{r.query_id}/timeline"))
    require(sum(tl["phases"].values()) == tl["wall_s"],
            f"timeline phases {tl['phases']} do not sum to "
            f"{tl['wall_s']}")
    require(tl["phases"]["device"] > 0, f"no device phase: {tl['phases']}")
    record["live"] = {"progress_pages": got, "http_progress": http,
                      "live_polls": seen["live_queries"],
                      "live_tasks_max": seen["live_tasks"],
                      "device_busy_ms": device,
                      "utilization": util}
    record["timeline"] = {k: tl[k] for k in ("wall_s", "phases",
                                             "dominant", "breakdown",
                                             "criticalPathSeconds")}
    log("fault tolerance live stats: progress monotonic in [0, 1] "
        f"({len(got)} pages, {len(http)} polls); live tasks up to "
        f"{seen['live_tasks']}; device busy ms {device}")
    log("fault tolerance timeline of the profiled q3: " +
        json.dumps(record["timeline"]))


def _ft_hll_timestamp(record, conn, main_session):
    """(e) approx_distinct and TIMESTAMP on the card against the port's
    CPU Session over the same tables."""
    import numpy as np
    from torch_time_cases import (HLL_QUERIES, TS_BAD_LITERALS, TS_QUERIES,
                                  hll_close, hll_sql, ts_setup)
    from trino_tpu_torch.exec.session import Session
    cpu = Session(_ft_catalog(conn), default_schema=TPCH_SCHEMA,
                  device="cpu")
    card = Session(_ft_catalog(conn), default_schema=TPCH_SCHEMA)
    hll = []
    for q in HLL_QUERIES:
        sql, exact_sql = hll_sql(q), hll_sql(q, exact=True)
        before = read_counts()
        rows, walls = _timed_runs(card, sql, 2)
        after = read_counts()
        exact, exact_walls = _timed_runs(card, exact_sql, 2)
        want = cpu.execute(sql).rows
        require(rows == want, f"approx_distinct on the card {rows} vs the "
                f"CPU {want}: {sql}")
        require([r[:-1] for r in rows] == [r[:-1] for r in exact] and
                all(hll_close(a[-1], e[-1]) for a, e in zip(rows, exact)),
                f"approx_distinct {rows} vs exact {exact}")
        hll.append({"sql": sql, "rows": rows, "exact": exact,
                    "rel_err": [abs(a[-1] - e[-1]) / e[-1]
                                for a, e in zip(rows, exact)],
                    "approx_walls_s": walls, "exact_walls_s": exact_walls,
                    "strategy": _strategy_lines(card, sql),
                    "launches": {k: after[k] - before[k] for k in after}})
        log(f"fault tolerance approx_distinct equals the CPU Session: "
            f"{json.dumps(hll[-1])}")
    record["approx_distinct"] = hll
    ts = []
    for sess in (card, cpu):
        for sql in ts_setup(TPCH_SCHEMA, np.random.default_rng(7)):
            sess.execute(sql)
    for sql in TS_QUERIES:
        t = time.monotonic()
        rows = card.execute(sql).rows
        wall = time.monotonic() - t
        want = cpu.execute(sql).rows
        require(rows and rows == want, f"TIMESTAMP on the card differs "
                f"from the CPU: {sql}\n{rows[:2]}\nvs\n{want[:2]}")
        ts.append({"rows": len(rows), "wall_s": wall})
    for lit in TS_BAD_LITERALS:
        errs = []
        for sess in (card, cpu):
            try:
                sess.execute(f"SELECT TIMESTAMP '{lit}'")
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — compared below
                errs.append((type(e).__name__, str(e)))
        require(errs[0] is not None and errs[0] == errs[1],
                f"TIMESTAMP '{lit}': {errs}")
    n_before = card.execute(
        "SELECT count(*) FROM memory.ts.events "
        "WHERE at < TIMESTAMP '1970-01-01 00:00:00'").rows[0][0]
    record["timestamp"] = {"queries": ts, "pre_epoch_rows": n_before}
    log("fault tolerance TIMESTAMP equals the CPU Session: " +
        json.dumps(record["timestamp"]))


def phase_fault_tolerance(recorder, main_session, tables):
    """The fault-tolerance and operations tier on the card at tpch.sf1,
    counters set to 0 just before and read just after: (a) seeded chaos
    on a coordinator and three workers, (b) coordinator failover with a
    killed query and a write killed at its commit, (c) resource groups
    over HTTP, (d) live stats and the timeline, (e) approx_distinct and
    TIMESTAMP against the port's CPU Session, (f) exactly-once writes
    across failover: the CTAS and a local INSERT resumed a second time,
    and the write fence under the coordinator-chaos soak's WRITE_COMMIT
    seeds with a distributed standby."""
    import shutil
    import tempfile
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import (CoordinatorServer,
                                                    _rows_json)
    from trino_tpu_torch.server.failuredetector import \
        HeartbeatFailureDetector
    from trino_tpu_torch.server.worker import WorkerServer
    t_phase = time.monotonic()
    conn = main_session.catalog.connector("tpch")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ft-")
    saved = os.environ.get("TRINO_TPU_HISTORY_PATH")
    os.environ["TRINO_TPU_HISTORY_PATH"] = os.path.join(tmp, "h.jsonl")
    orders = conn.get_table(TPCH_SCHEMA, "orders")
    expected = {
        "q1": _rows_json(oracle_q1(tables["lineitem"])),
        "q6": _rows_json(oracle_q6(tables["lineitem"])),
        "q3": _rows_json(oracle_q3(tables["customer"], orders,
                                   tables["lineitem"])),
        "concat": sorted(map(tuple, _rows_json(
            main_session.execute(FT_CONCAT_SQL).rows)))}
    record, walls = {}, {}
    session = Session(_ft_catalog(conn), default_schema=TPCH_SCHEMA)
    require(session.device.type == "cuda", "the phase's Session() is not "
            "on cuda")
    coord = CoordinatorServer(session, max_concurrency=16,
                              retry_policy="QUERY").start()
    coord.state.scheduler.split_rows = CLUSTER_SPLIT_ROWS
    workers = [WorkerServer(f"ft-w{i}", coord.uri, announce_interval_s=0.1,
                            heartbeat_interval_s=0.05,
                            catalog=session.catalog).start()
               for i in range(3)]
    detector = HeartbeatFailureDetector(coord.state, interval_s=0.2).start()
    probe = HttpProbe(coord.uri)
    try:
        _wait_for(lambda: len(coord.state.active_nodes()) == 3,
                  "three workers to announce")
        for w in workers:
            require(w.task_manager.device.type == "cuda",
                    f"{w.node_id} runs on {w.task_manager.device}")
        reset_counts()
        recorder.active, recorder.keep = True, False
        for name, part in (
                ("chaos", lambda: _ft_chaos(record, coord, workers, probe,
                                            expected)),
                ("failover", lambda: _ft_failover(record, conn, tables,
                                                  expected, tmp)),
                ("write_fence", lambda: _ft_write_fence(record)),
                ("resource_groups", lambda: _ft_resource_groups(
                    record, coord, expected)),
                ("live_timeline", lambda: _ft_live_and_timeline(
                    record, coord, workers, probe, expected)),
                ("hll_timestamp", lambda: _ft_hll_timestamp(
                    record, conn, main_session))):
            t = time.monotonic()
            part()
            walls[name] = time.monotonic() - t
            log(f"fault tolerance ({name}) took {walls[name]:.1f} s")
    finally:
        recorder.active, recorder.keep = False, True
        detector.stop()
        for w in workers:
            w.stop(graceful=False)
        coord.stop()
        coord.state.dispatcher.pool.shutdown(wait=True)
        if saved is None:
            os.environ.pop("TRINO_TPU_HISTORY_PATH", None)
        else:
            os.environ["TRINO_TPU_HISTORY_PATH"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts()
    require(launches["K1"] > 0 and launches["K3"] > 0,
            f"the fault-tolerance path launched {launches}")
    record["launches"] = launches
    record["part_walls_s"] = walls
    record["phase_s"] = time.monotonic() - t_phase
    log("fault tolerance path: " + json.dumps(record, default=str))
    return launches


# the seven soaks (trino_tpu_torch/soak.py) at smoke length on the
# card: name -> (function, arguments, the record's gates)
SOAK_DEVICE = "cuda"
SOAKS = (
    ("chaos", "chaos_soak", {"n_seeds": 10},
     lambda r: {"wrong_answers==0": r["wrong_answers"] == 0,
                "failed_queries==0": r["failed_queries"] == 0,
                "injected_total>0": r["injected_total"] > 0}),
    ("write_chaos", "write_chaos_soak", {"n_seeds": 6},
     lambda r: {"lost_rows==0": r["lost_rows"] == 0,
                "dup_rows==0": r["dup_rows"] == 0,
                "orphans==0": r["orphans"] == 0,
                "passed": r["passed"]}),
    ("coordinator_chaos", "coordinator_chaos_soak", {"n_seeds": 5},
     lambda r: {"wrong_results==0": r["wrong_results"] == 0,
                "lost_rows==0": r["lost_rows"] == 0,
                "dup_rows==0": r["dup_rows"] == 0,
                "client_errors==0": r["client_errors"] == 0,
                "passed": r["passed"]}),
    ("overload", "overload_soak", {},
     lambda r: {"wrong_answers==0": r["wrong_answers"] == 0,
                "deadline_kills==3": r["deadline_kills"] == 3,
                "canceled==4": r["canceled"] == 4,
                "tasks_terminal": r["tasks_terminal"],
                "pools_drained": r["pools_drained"],
                "rejected_total>0": r["rejected_total"] > 0,
                "passed": r["passed"]}),
    ("memory_pressure", "memory_pressure_soak", {"n_queries": 20},
     lambda r: {"wrong_answers==0": r["wrong_answers"] == 0,
                "worker_crashes==0": r["worker_crashes"] == 0,
                "passed": r["passed"]}),
    ("concurrency", "concurrency_soak",
     {"n_clients": 100, "queries_per_client": 1},
     lambda r: {"wrong_answers==0": r["wrong_answers"] == 0,
                "failed_queries==0": r["failed_queries"] == 0,
                "result_cache_hits>0": r["result_cache_hits"] > 0,
                "plan_cache_hits>0": r["plan_cache_hits"] > 0,
                "router_host>0": r["router_host"] > 0,
                "router_device>0": r["router_device"] > 0,
                "invalidation_proven": r["invalidation_proven"],
                "passed": r["passed"]}),
    ("elastic", "elastic_soak", {"duration_s": 20.0},
     lambda r: {"wrong_answers==0": r["wrong_answers"] == 0,
                "failed_queries==0": r["failed_queries"] == 0,
                "orphaned_splits==0": r["orphaned_splits"] == 0,
                "drain_completed": r["drain_completed"],
                "drained_node_deregistered":
                    r["drained_node_deregistered"],
                "join_received_splits": r["join_received_splits"],
                "writes_visible": r["writes_visible"],
                "slo_ok": all(t["slo_ok"] for t in r["tenants"].values()),
                "fair_share_held": r["fair_share_held"],
                "passed": r["passed"]}),
)
# the numbers beside the gates on each soak's line
SOAK_FIELDS = ("schedules", "seeds", "queries", "queries_run",
               "injected_total", "recovery_p50_s", "recovery_p95_s",
               "failover_to_result_p50_ms", "failover_to_result_p99_ms",
               "resumed_by_mode", "cancel_terminal_p50_ms",
               "deadline_overshoot_p50_ms", "spill_bytes", "revocations",
               "working_set_bytes", "pool_limit_bytes", "throughput_qps",
               "router_host", "router_device", "task_retries",
               "hedged_tasks", "splits_migrated", "elapsed_s")


def phase_soaks(recorder):
    """The server tier's seven soaks (trino_tpu_torch/soak.py) on
    the card at smoke length, each bringing up its own cluster over
    `tpch.tiny` with every Session and worker on cuda, counters set to 0
    just before the first and read just after the last; every gate of
    each record must hold, the elastic soak's per-tenant p99 SLOs
    included, and K1 and K3 must launch."""
    import contextlib
    import io
    from trino_tpu_torch import soak
    t_phase = time.monotonic()
    failed, per_soak = [], {}
    reset_counts()
    recorder.active, recorder.keep = True, False
    try:
        for name, fn, kwargs, gates in SOAKS:
            before = read_counts()
            t = time.monotonic()
            out = io.StringIO()
            # each soak prints its whole record: keep it off this
            # script's output, whose JSON lines the contract fixes;
            # Queue C 6: a coordinator's write commits under its query id
            with contextlib.redirect_stdout(out), \
                    _LocalPathWrites() as local:
                rec = getattr(soak, fn)(device=SOAK_DEVICE, **kwargs)
            wall = time.monotonic() - t
            after = read_counts()
            launches = {k: after[k] - before[k] for k in after}
            held = gates(rec)
            if name == "coordinator_chaos":
                held["local_path_writes==0"] = not local.ids
            per_soak[name] = {"wall_s": round(wall, 3),
                              "launches": launches}
            line = {"gates": held, "wall_s": round(wall, 3),
                    "launches": launches,
                    "local_path_writes": len(local.ids)}
            line.update({k: rec[k] for k in SOAK_FIELDS if k in rec})
            if name == "concurrency":
                line["mixes"] = rec["mixes"]
            if name == "elastic":
                line["tenants"] = rec["tenants"]
                line["busy_fraction_mean"] = \
                    rec["telemetry"]["busy_fraction_mean"]
            log(f"soak {name}: " + json.dumps(line, default=str))
            failed += [f"{name}: {g}" for g, ok in held.items() if not ok]
            if not all(held.values()):
                log(f"soak {name} record: " + json.dumps(rec, default=str))
    finally:
        recorder.active, recorder.keep = False, True
    launches = read_counts()
    log(f"soaks took {time.monotonic() - t_phase:.1f} s, launches "
        + json.dumps(launches))
    require(not failed, f"soak gates failed: {failed}")
    require(launches["K1"] > 0 and launches["K3"] > 0,
            f"the soaks launched {launches} ({per_soak})")
    return launches


# the scale phase: the reference's end-to-end configurations (bench.py's
# default mode) through trino_tpu_torch/e2e.py. q5-shaped is cut from
# the reference's SF100 to SF10 (at SF100 its generation and upload alone
# take minutes of the script's limit); q3 runs at the reference's own
# tpch.sf10
SCALE_Q5 = 10
SCALE_CHUNK_ROWS = 33_554_432
SCALE_Q3_SCHEMA = "sf10"
SCALE_RUNS = 3


# the scale phase's set-up, run by a child process from the script's
# start: its tables and oracles' results into the phase's data root
_SCALE_PREPARE = (
    "import sys\n"
    "from trino_tpu_torch import e2e\n"
    "print(e2e.prepare('q5,q3', float(sys.argv[1]), "
    "q3_schema=sys.argv[2]))\n")


class ScaleData:
    """The scale phase's data root: a temporary directory outside the
    checkout, filled by a child process (``e2e.prepare``: generation and
    the numpy oracles) that runs beside the phases before the scale
    phase; on close the child is stopped and the directory removed."""

    def __init__(self):
        import tempfile
        self.root = tempfile.mkdtemp(prefix="chip_smoke_scale_")
        self.log_path = os.path.join(self.root, "prepare.log")
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _SCALE_PREPARE, str(SCALE_Q5),
                 SCALE_Q3_SCHEMA], cwd=HERE, stdout=out,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, TRINO_TPU_DATA_CACHE=self.root))

    def wait(self, timeout_s: float = 600.0) -> str:
        """Wait for the child; its output (the seconds each
        configuration's set-up took)."""
        t = time.monotonic()
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        with open(self.log_path) as f:
            text = f.read().strip()
        require(rc == 0, f"the scale data's child process ended with "
                         f"{rc}: {text[-2000:]}")
        log(f"scale data ready (waited {time.monotonic() - t:.1f} s for "
            f"the child): {text[-300:]}")
        return text

    def close(self) -> None:
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)


def _tree_files() -> set:
    """Every file of the checkout this script runs from, but git's,
    Python's caches, the kernel build and the git-ignored run-output
    folder: what a phase may not leave behind."""
    skip = {".git", "__pycache__", "_build", "chiprun_out"}
    out = set()
    for dirpath, dirnames, files in os.walk(HERE):
        dirnames[:] = [d for d in dirnames if d not in skip]
        out.update(os.path.join(dirpath, f) for f in files)
    return out


class _StarDimensions:
    """Wraps the executor's star sizing (``_multijoin_tables``) while
    active: per star, each dimension's tables and whether it was fused
    or the reason it degraded to the pairwise ladder."""

    def __enter__(self):
        from trino_tpu_torch.exec import executor as X
        self.stars = {}
        real = self._real = X.Executor._multijoin_tables
        stars = self.stars

        def sized(ex, node, fact, dims):
            noted = []
            note = ex._note_multijoin_degrade

            def noting(reason, count=1):
                noted.append(reason)
                return note(reason, count)
            ex._note_multijoin_degrade = noting
            try:
                fused, degraded = real(ex, node, fact, dims)
            finally:
                del ex._note_multijoin_degrade
            verdict = dict(zip(degraded, noted))
            for d in (fused[0] if fused is not None else ()):
                verdict[d] = "fused"
            # a dimension that fit, left alone: a star needs two fused
            # dimensions, or the whole star runs the pairwise ladder
            alone = "ladder (the only dimension that fit)"
            names = [",".join(sorted(sc.table for sc in
                                     X._subtree_scans(node.dims[d])))
                     for d in range(len(node.dims))]
            stars[id(node)] = {names[d]: verdict.get(d, alone)
                               for d in range(len(names))}
            return fused, degraded
        X.Executor._multijoin_tables = sized
        return self

    def __exit__(self, *exc):
        from trino_tpu_torch.exec import executor as X
        X.Executor._multijoin_tables = self._real
        return False


def phase_scale(recorder, data):
    """The reference's end-to-end configurations at scale
    (``trino_tpu_torch/e2e.run_e2e``), counters set to 0 just before and
    read just after: q5-shaped at SF10 streamed through the chunked
    driver from the narrowed fact cache (33,554,432-row chunks) and
    TPC-H q3 at ``tpch.sf10``, each once cold and three times steady,
    with its data under a temporary directory outside the checkout
    (generated by `data`'s child process beside the earlier phases),
    then one more steady q5 under torch.profiler and a cold q5 in a
    fresh Session under cProfile. Gates: rows equal to
    the numpy oracles, q5's steady runs slicing chunks from the fact
    cache, K1 launched, and no file left under the checkout."""
    from trino_tpu_torch import e2e
    from trino_tpu_torch.exec.session import Session
    t_phase = time.monotonic()
    before = _tree_files()
    data.wait()
    profiles, cold = {}, {}

    def on_session(key, session, rec):
        if key.startswith("q5_"):
            profiles[key] = _device_profile(session, e2e.Q5, top=10)
            # a cold run in a fresh Session over the same tables (the
            # narrowed columns come back from the disk tier): where its
            # host time goes
            fresh = Session(catalog=session.catalog, default_cat="bench",
                            default_schema="q5")
            fresh.properties["spill_chunk_rows"] = SCALE_CHUNK_ROWS
            fresh.executor.spill_chunk_rows = SCALE_CHUNK_ROWS
            cold[key] = _host_profile(fresh, e2e.Q5, top=30)

    reset_counts()
    recorder.active, recorder.keep = True, False
    recorder.scale = recorder.extra = ScaleLaunches()
    try:
        with _StarDimensions() as stars:
            rec = e2e.run_e2e(only="q5,q3", q5_scale=SCALE_Q5,
                              chunk_rows=SCALE_CHUNK_ROWS,
                              q3_schema=SCALE_Q3_SCHEMA, runs=SCALE_RUNS,
                              data_cache=data.root, log=log,
                              on_session=on_session)
    finally:
        recorder.active, recorder.keep = False, True
        recorder.extra = None
        data.close()
    launches = read_counts()
    left = sorted(_tree_files() - before)
    d = rec["detail"]
    q5, q3 = d[f"q5_sf{SCALE_Q5:g}"], d[f"q3_{SCALE_Q3_SCHEMA}"]
    for key, c in ((f"q5 SF{SCALE_Q5:g}", q5),
                   (f"q3 tpch.{SCALE_Q3_SCHEMA}", q3)):
        line = {k: c.get(k) for k in (
            "verified", "gen_s", "cpu_ms", "cold_ms", "steady_ms",
            "steady_runs_ms", "rows_lineitem", "fact_cache_chunks",
            "steady_fact_cache_chunks", "chunk_lut_joins", "launches",
            "peak_allocated_bytes", "fact_cache_device_bytes",
            "scan_cache_bytes", "pool_peak_bytes",
            "multijoin_degrade_reasons", "strategy")}
        log(f"scale {key}: " + json.dumps(line))
    verdicts = {json.dumps(v, sort_keys=True) for v in stars.stars.values()}
    log("scale q5 star dimensions (fused or the degrade reason), each "
        "distinct verdict of its runs: " + ", ".join(sorted(verdicts)))
    for key, prof in profiles.items():
        log(f"scale {key} device profile (one more steady run): "
            + json.dumps(prof))
        log(f"scale {key} host profile of a cold run in a fresh Session "
            f"(narrowed columns from the disk tier): "
            + json.dumps(cold[key]))
    log(f"scale: card {d['card']}, {d['power_limit']}; host "
        f"{d['host_mem_total_kb']} kB, {d['host_cpus']} CPUs; phase "
        f"{time.monotonic() - t_phase:.1f} s, launches "
        + json.dumps(launches) + "; by size: "
        + json.dumps(recorder.scale.sizes))
    require(q5["verified"] and q3["verified"],
            f"scale rows differ from the oracles: q5 "
            f"{q5.get('rows')} vs {q5.get('want')}; q3 {q3.get('rows')} "
            f"vs {q3.get('want')}")
    require(q5["steady_fact_cache_chunks"] > 0,
            "q5's steady runs sliced no chunk from the fact cache")
    require(launches["K1"] > 0, f"the scale phase launched {launches}")
    require(not left and not os.path.exists(data.root),
            f"the scale phase left data under the checkout: {left[:5]}")
    return launches


# the bench-modes phase: bench.py's measurement modes through
# trino_tpu_torch/micro.py and coldstart.py. The scan micro is cut from
# its 2^24 rows to 2^22 (its zlib ORC write and reads are host work of
# tens of seconds at 2^24; `python -m trino_tpu_torch.micro scan` runs
# the full size), the cold start to one prewarmed child a query beside
# the seed child (the reference's default is two)
BENCH_SCAN_ROWS = 1 << 22
BENCH_COLD_RUNS = 1

# the scan micro's decode counts in a process of their own on the CPU
# (host work only), started with the phase and read at its end
_DECODE_CHILD = (
    "import json, sys\n"
    "from trino_tpu_torch import micro\n"
    "rows = int(sys.argv[1])\n"
    "print(json.dumps(micro.decode_counts(micro.scan_table(rows), "
    "micro.zone_rows_for(rows))))\n")


def phase_bench_modes(recorder):
    """The four kernel micro-benchmarks at the card's shapes, then the
    fresh-process cold start of q3, q5 and q6 with an empty kernel
    build directory, counters set to 0 just before and read just after.
    Each record is written into a temporary directory outside the
    checkout, parsed back by ``regressions.load_bench_round`` (the
    gather record, which no series of the gate reads, loaded back),
    printed and checked: K1 equal to ``index_select``, K2 to its plain
    version, the aggregate arms the same groups, every star equal to its
    ladder and fused unless K3's build escaped (the reference's gate:
    its own K3 escapes one key of a 4,096-key dimension at 8,192
    slots), the scan identical with pruning on and off and across
    prefetch depths, its decode counts equal to a CPU process's, every
    cold child's rows the steady session's. The cold gate's ratios and
    verdict are measured outcomes: printed, not required."""
    import shutil
    import tempfile

    import torch
    from trino_tpu_torch import coldstart, e2e, micro, regressions
    before = _tree_files()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    decode_child = subprocess.Popen(
        [sys.executable, "-c", _DECODE_CHILD, str(BENCH_SCAN_ROWS)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    saved_build = os.environ.get("TRINO_TPU_CUDA_BUILD_DIR")
    records, walls = {}, {}
    reset_counts()
    recorder.active, recorder.keep = True, False
    recorder.bench = recorder.extra = ScaleLaunches()
    try:
        for mode in micro.MODES:
            kwargs = {"rows": BENCH_SCAN_ROWS} if mode == "scan" else {}
            t = time.monotonic()
            records[mode] = micro.RUNNERS[mode](
                out_path=os.path.join(tmp, micro.FILES[mode]), **kwargs)
            walls[mode] = round(time.monotonic() - t, 1)
            log(f"bench {mode}_micro ({walls[mode]} s): "
                + json.dumps(records[mode]))
            e2e._release(torch.device("cuda"))
        # the children build every kernel library they launch into an
        # empty directory: the seed child of the first query runs nvcc
        os.environ["TRINO_TPU_CUDA_BUILD_DIR"] = os.path.join(tmp, "build")
        t = time.monotonic()
        cold = coldstart.cold_start(
            cold_runs=BENCH_COLD_RUNS,
            out_path=os.path.join(tmp, "BENCH_cold_r01.json"), log=log)
        walls["cold_start"] = round(time.monotonic() - t, 1)
    finally:
        recorder.active, recorder.keep = False, True
        recorder.extra = None
        if saved_build is None:
            os.environ.pop("TRINO_TPU_CUDA_BUILD_DIR", None)
        else:
            os.environ["TRINO_TPU_CUDA_BUILD_DIR"] = saved_build
        try:
            decode_out, _ = decode_child.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            decode_child.kill()
            decode_out, _ = decode_child.communicate()
        # the gate's series parse into their configs; the gather record
        # belongs to none (as in the reference's gate) and reads back
        parsed = {name: regressions.load_bench_round(os.path.join(tmp, name))
                  for name in ("BENCH_agg_micro.json",
                               "BENCH_star_micro.json",
                               "BENCH_scan_micro.json",
                               "BENCH_cold_r01.json")}
        gather_path = os.path.join(tmp, micro.FILES["gather"])
        gather_back = None
        if os.path.exists(gather_path):
            with open(gather_path) as f:
                gather_back = json.load(f)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts()
    log(f"bench cold start ({walls['cold_start']} s): " + json.dumps(cold))
    for r in cold["records"]:
        log(f"bench cold gate {r['query']}: ratio {r['ratio']} (cold "
            f"{r['cold_ms']} ms / steady {r['steady_ms']} ms, gate "
            f"{cold['ratio_gate']}), passed {r['passed']}; seed "
            f"{r['seed_ms']} ms with {r['seed_fresh_compiles']} nvcc "
            f"builds in {r['seed_compile_s']} s")
    log(f"bench cold gate passed {cold['passed']}")
    log("bench modes: launches " + json.dumps(launches) + " (by mode: "
        + json.dumps({m: records[m]["launches"] for m in records})
        + "), walls " + json.dumps(walls) + ", parsed rounds "
        + json.dumps(parsed))
    for r in records["star"]["records"]:
        log(f"bench star k={r['dims']} hit rate {r['hit_rate']}: "
            f"{r['fused_probes']} fused runs, degrades "
            f"{r['degrade_reasons']}, fused {r['fused_ms']} ms, pairwise "
            f"{r['pairwise_ms']} ms")
    # a star may take the ladder only where K3's build escaped (the
    # reference's own verdict on these dimensions)
    bad = [b for rec in records.values() for b in micro.failures(rec)]
    require(not bad, f"the micro-benchmarks' arms disagree: {bad[:3]}")
    try:
        cpu_decode = json.loads(decode_out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        cpu_decode = None
    require(decode_child.returncode == 0 and
            cpu_decode == records["scan"]["decode"],
            f"the scan micro's decode counts differ from the CPU run's: "
            f"{records['scan']['decode']} vs {decode_out[-2000:]}")
    require(all(r["answers_steady"] for r in cold["records"]),
            "a cold child's rows differ from the steady session's")
    require(all(parsed.values()) and gather_back == records["gather"],
            f"a record does not parse as a round: {parsed}")
    require(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")),
            f"the bench modes launched {launches}")
    left = sorted(_tree_files() - before)
    require(not left and not os.path.exists(tmp),
            f"the bench modes left files under the checkout: {left[:5]}")
    return launches


MESH_SHARDS = 8
# SELECTIVE and PROBE_ROWS of tests/test_mesh_dynamic_filter.py (that file
# imports the JAX package, which this script must not load)
SELECTIVE = """
    SELECT count(*) FROM lineitem, orders
    WHERE l_orderkey = o_orderkey AND o_totalprice > 500000"""
PROBE_ROWS = """
    SELECT l_orderkey, l_linenumber, o_totalprice
    FROM lineitem, orders
    WHERE l_orderkey = o_orderkey AND o_totalprice > 400000
    ORDER BY l_orderkey, l_linenumber"""


def oracle_selective(orders, li):
    """SELECTIVE of tests/test_mesh_dynamic_filter.py: lineitem rows of
    orders above 500,000."""
    import numpy as np
    okey = _col(orders, "o_orderkey")
    big = np.zeros(int(okey.max()) + 1, np.bool_)
    big[okey[_col(orders, "o_totalprice") > 50_000_000]] = True
    return [(int(big[_col(li, "l_orderkey")].sum()),)]


def oracle_probe_rows(orders, li):
    """PROBE_ROWS of tests/test_mesh_dynamic_filter.py: each lineitem row
    of an order above 400,000 with its price, by key and line."""
    import numpy as np
    okey = _col(orders, "o_orderkey")
    price = np.full(int(okey.max()) + 1, -1, np.int64)
    keep = _col(orders, "o_totalprice") > 40_000_000
    price[okey[keep]] = _col(orders, "o_totalprice")[keep]
    lk, ln = _col(li, "l_orderkey"), _col(li, "l_linenumber")
    m = price[lk] >= 0
    order = np.lexsort((ln[m], lk[m]))
    return [(int(a), int(b), _dec(int(c), 2)) for a, b, c in
            zip(lk[m][order], ln[m][order], price[lk[m]][order])]


def _sorted_live_rows(batch, keys):
    """A batch's live rows as numpy columns (data and validity), sorted by
    the `keys` columns: the same rows in any order compare equal."""
    import numpy as np
    from trino_tpu_torch.batch import batch_to_numpy
    arrays, valids = batch_to_numpy(batch)
    order = np.lexsort([arrays[k] for k in reversed(keys)])
    return [a[order] for a in arrays], [v[order] for v in valids]


def _mesh_stage_checks(mesh, tables):
    """`partitioned_hash_join_step` and `sharded_agg_step` called directly
    on the 8-shard mesh over lineitem and orders at sf1, against the
    single-card operators on the same batches: the join's rows (sorted)
    against `join_unique_build`, bit for bit; the aggregate against
    `direct_group_aggregate` (its integer states single-device, its
    double sum against `sum_like_reference` of each group's rows in 8
    blocks, the order a mesh sums in)."""
    import numpy as np
    import torch
    from trino_tpu_torch import ir
    from trino_tpu_torch.batch import Column, batch_from_numpy
    from trino_tpu_torch.ops import hashtable as ht
    from trino_tpu_torch.ops.aggregate import (AggSpec,
                                               direct_group_aggregate,
                                               sum_like_reference)
    from trino_tpu_torch.ops.join import join_unique_build
    from trino_tpu_torch.ops.project import apply_filter
    from trino_tpu_torch.parallel.mesh import concat_rows
    from trino_tpu_torch.parallel.stages import (partitioned_hash_join_step,
                                                 sharded_agg_step)
    from trino_tpu_torch.types import DATE
    li, orders = tables["lineitem"], tables["orders"]
    dev = mesh.devices[0]
    probe = batch_from_numpy([_col(li, n) for n in (
        "l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice",
        "l_returnflag", "l_linestatus", "l_shipdate")], device=dev)
    build = batch_from_numpy([_col(orders, n) for n in (
        "o_orderkey", "o_totalprice", "o_orderdate")], device=dev)
    # a sixteenth of the orders (every sixteenth run of 32 order keys,
    # which come 8 to a run), about 11,700 keys a shard in 131,072 slots:
    # at a quarter (0.36 of the slots) K3 ran 7 of 375,000 rows out of
    # probes on an H100, and an escaped table is incomplete
    build = build.with_live(build.live &
                            ((build.columns[0].data // 32) % 16 == 0))
    n = mesh.size
    slots, _ = ht.join_table_slots(max(ht.MIN_TABLE_SLOTS,
                                       2 * build.capacity // n))
    k3 = ht.hash_insert_multi.launches
    t = time.monotonic()
    shards, dup, esc, pruned = partitioned_hash_join_step(
        mesh, n, (0,), (0,), "inner", slots, "on")(probe, build)
    joined = concat_rows(shards)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t
    k3 = ht.hash_insert_multi.launches - k3
    require(int(dup) == 0 and int(esc) == 0, f"the direct partitioned "
            f"join: dup {int(dup)}, escaped {int(esc)}")
    require(k3 == n, f"the direct partitioned join launched K3 {k3} times")
    single, sdup = join_unique_build(probe, build, (0,), (0,), "inner")
    got, want = _sorted_live_rows(joined, (0, 1)), \
        _sorted_live_rows(single, (0, 1))
    require(int(sdup) == 0 and len(got[0][0]) == len(want[0][0]) > 0 and
            all(np.array_equal(a, b) for a, b in zip(got[0] + got[1],
                                                     want[0] + want[1])),
            "the partitioned join's rows differ from the single card's")
    ext = probe.columns[3].data.to(torch.float64) * 0.01
    fact = type(probe)(columns=probe.columns + (Column(
        ext, probe.columns[3].valid),), live=probe.live)
    flt = ir.Compare("<=", ir.ColumnRef(6, DATE),
                     ir.Literal(_days("1998-09-02"), DATE))
    pools = [len(li.schema.field(c).dictionary)
             for c in ("l_returnflag", "l_linestatus")]
    aggs = (AggSpec("sum", 2), AggSpec("sum", 7), AggSpec("count_star",
                                                          None),
            AggSpec("min", 3), AggSpec("max", 2))
    t = time.monotonic()
    merged = sharded_agg_step(mesh, flt, None, (4, 5), tuple(pools),
                              aggs)(fact)
    torch.cuda.synchronize()
    agg_s = time.monotonic() - t
    local = apply_filter(fact, flt)
    plain = direct_group_aggregate(local, (4, 5), tuple(pools), aggs)
    # the double sum in the sharded order: each group's masked column
    # summed by `sum_like_reference` in n blocks, then in block order
    gid = local.columns[4].data.to(torch.int32).clamp(0, pools[0] - 1) * \
        pools[1] + local.columns[5].data.to(torch.int32).clamp(
            0, pools[1] - 1)
    rows = local.live & local.columns[4].valid & local.columns[5].valid & \
        local.columns[7].valid
    sharded_sum = torch.stack([sum_like_reference(torch.where(
        rows & (gid == g), local.columns[7].data, 0.0), shards=n)
        for g in range(pools[0] * pools[1])])
    require(torch.equal(merged.live, plain.live), "the sharded aggregate's "
            "groups differ")
    for i, (m, p) in enumerate(zip(merged.columns, plain.columns)):
        want = (sharded_sum.view(torch.int64) if i == 3 else
                p.data.view(torch.int64) if p.data.dtype == torch.float64
                else p.data)
        require(torch.equal(m.valid, p.valid) and
                torch.equal(m.data.view(torch.int64) if
                            m.data.dtype == torch.float64 else m.data,
                            want),
                f"sharded_agg_step's column {i} differs from the single "
                f"card's")
    return {"join_rows": len(got[0][0]), "join_step_s": step_s,
            "join_k3_launches": k3, "join_pruned": int(pruned),
            "table_slots": slots, "agg_step_s": agg_s,
            "double_sum_single_vs_sharded_equal": bool(torch.equal(
                plain.columns[3].data, sharded_sum))}


def _mesh_scan_bytes(executor):
    """Bytes the mesh executor's cached scans hold, per card."""
    out = {}
    for b in executor._scan_cache.values():
        for d, n in b.bytes_by_device().items():
            out[d] = out.get(d, 0) + n
    return out


def _mesh_every_card(cat, sqls, expected, main_session):
    """q1, q6 and q3 on a mesh over every card, partitioned, each run
    twice: rows against the oracles and the single card's, each card's K1
    and K3 launches (a spy on the launch helper of the two wrappers'
    modules attributes each launch to the card it entered; the wrappers
    count inside that helper's block). With one card the several cards
    are not measured; the same code then runs q3 once on a 2-shard mesh
    over cuda:0 twice, which checks the spy's count on the card."""
    import contextlib

    import torch
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.ops import gather as k1
    from trino_tpu_torch.ops import hashtable as ht
    from trino_tpu_torch.ops.cuda_build import _card
    from trino_tpu_torch.parallel.dist_executor import MeshExecutor
    from trino_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    if n >= 2:
        log(f"mesh_cards: {n}")
        mesh, names, runs = make_mesh(device="cuda"), ("q1", "q6", "q3"), 2
    else:
        log("mesh_cards: 1 (the several-cards part did not run: it needs "
            "two cards; this is not a failure; its per-card launch count "
            "is checked on a 2-shard mesh over cuda:0 twice)")
        mesh, names, runs = make_mesh(2, "cuda"), ("q3",), 1
    cards = sorted({str(d) for d in mesh.devices})
    by_card = {}

    def spy(module, counter, name):
        real = module.launch_on

        @contextlib.contextmanager
        def entered(device):
            before = counter.launches
            with real(device) as stream:
                yield stream
                key = f"{name}@{_card(device)}"
                by_card[key] = by_card.get(key, 0) + \
                    counter.launches - before
        return real, entered
    real1, spy1 = spy(k1, k1.gather_columns, "K1")
    real3, spy3 = spy(ht, ht.hash_insert_multi, "K3")
    session = Session(cat, default_schema=TPCH_SCHEMA, device="cuda")
    session.executor = MeshExecutor(cat, mesh)
    session.execute("SET SESSION join_distribution_type = 'partitioned'")
    session.execute("SET SESSION enable_pallas_hash = true")
    out = {"cards": n, "ran": n >= 2, "mesh": [str(d) for d in mesh.devices],
           "queries": {}}
    k3_0 = ht.hash_insert_multi.launches
    k1.launch_on, ht.launch_on = spy1, spy3
    try:
        for name in names:
            g0 = session.executor.stats.mesh_gathers
            rows, walls = _timed_runs(session, sqls[name], runs)
            single = main_session.execute(sqls[name]).rows
            require(rows == expected[name] == single,
                    f"{name} on the mesh over {cards} differs from the "
                    f"oracle or the single card")
            out["queries"][name] = {
                "walls_s": walls,
                "mesh_gathers": (session.executor.stats.mesh_gathers -
                                 g0) / runs}
    finally:
        k1.launch_on, ht.launch_on = real1, real3
    k3 = ht.hash_insert_multi.launches - k3_0
    out["launches_by_card"] = by_card
    out["scan_bytes_by_card"] = _mesh_scan_bytes(session.executor)
    require(k3 > 0 and sum(v for k, v in by_card.items()
                           if k.startswith("K3@")) == k3,
            f"the spy attributed {by_card} of K3's {k3} launches")
    require(all(by_card.get(f"K3@{c}", 0) > 0 for c in cards),
            f"K3 did not launch on every card of the mesh: {by_card}")
    log(f"mesh over {cards}: rows equal the oracles and the single card; "
        + json.dumps(out))
    return out


def phase_mesh_path(recorder, main_session, tables, ds_session):
    """The mesh tier on the card (trino_tpu_torch/parallel/), counters set
    to 0 just before and read just after. (1) `SET SESSION distributed =
    true` on a CUDA Session: a MeshExecutor over the card's default mesh
    (one card, one shard), TPC-H q1 and q6 against the oracles. (2) A
    MeshExecutor over make_mesh(8, "cuda"), eight shards on the one card,
    under join_distribution_type = 'partitioned' and enable_pallas_hash =
    true: TPC-H q1, q6, q3 and SELECTIVE and PROBE_ROWS of
    tests/test_mesh_dynamic_filter.py, one cold and three steady runs
    each, rows equal to the oracles and to the single-card Session's,
    every partitioned join building one K3 table per shard, SELECTIVE
    pruning rows; each query's all-gathers (`mesh_gathers`: none for q1
    and q6) and each card's bytes of the sharded scans; q3 once more
    under the broadcast distribution (the probe per shard, the build
    replicated); EXPLAIN's `join distribution: partitioned`; the card's
    idle share over one steady q3. (2b) With two cards or more, q1, q6
    and q3 on a mesh over every card (`make_mesh("cuda")`), partitioned:
    rows equal to the oracles and the single card's, each card's K1 and
    K3 launches counted and K3 required on every card; with one card the
    part does not run, which `mesh_cards: 1` says, and q3 on a 2-shard
    mesh over cuda:0 twice checks the per-card count instead. (3) TPC-DS
    q3 on the 8-shard mesh: the star degrades to the ladder (reason
    mesh), no K4 launch, rows equal to the single card's. (4)
    `partitioned_hash_join_step` and `sharded_agg_step` called directly
    over lineitem and orders, bit-exact against the single-card
    operators."""
    import statistics as st
    from tpcds_queries import QUERIES as DS
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.metrics import MESH_REPARTITION_BYTES
    from trino_tpu_torch.parallel.dist_executor import MeshExecutor
    from trino_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.monotonic()
    orders = main_session.catalog.connector("tpch").get_table(
        TPCH_SCHEMA, "orders")
    expected = {"q1": oracle_q1(tables["lineitem"]),
                "q6": oracle_q6(tables["lineitem"]),
                "q3": oracle_q3(tables["customer"], orders,
                                tables["lineitem"]),
                "selective": oracle_selective(orders, tables["lineitem"]),
                "probe_rows": oracle_probe_rows(orders,
                                                tables["lineitem"])}
    sqls = {"q1": Q1, "q6": Q6, "q3": Q3, "selective": SELECTIVE,
            "probe_rows": PROBE_ROWS}
    cat = Catalog()
    cat.register("tpch", main_session.catalog.connector("tpch"))
    record = {}
    reset_counts()
    recorder.active, recorder.keep = True, False
    try:
        # 1. distributed = true on the card's default mesh
        dev = main_session.device
        dist = Session(cat, default_schema=TPCH_SCHEMA, device=dev)
        dist.execute("SET SESSION distributed = true")
        require(isinstance(dist.executor, MeshExecutor) and
                dist.executor.device.type == dev.type,
                f"distributed = true gave {type(dist.executor).__name__} "
                f"on {dist.executor.device}")
        for name in ("q1", "q6"):
            rows, walls = _timed_runs(dist, sqls[name], 2)
            require(rows == expected[name], f"{name} under distributed = "
                    f"true differs from the oracle")
            record[f"distributed_{name}_walls_s"] = walls
        record["default_mesh_shards"] = dist.executor.n_shards
        log(f"mesh: distributed = true -> MeshExecutor over "
            f"{dist.executor.n_shards} shard(s) on {dist.executor.device}; "
            f"q1, q6 equal the oracles")
        # 2. eight shards on the one card, partitioned joins
        mesh = make_mesh(MESH_SHARDS, dev)
        session = Session(cat, default_schema=TPCH_SCHEMA, device=dev)
        session.executor = MeshExecutor(cat, mesh)
        session.execute("SET SESSION join_distribution_type = "
                        "'partitioned'")
        session.execute("SET SESSION enable_pallas_hash = true")
        ex = session.executor
        per_query = {}
        for name, sql in sqls.items():
            pj0 = ex.stats.mesh_partitioned_joins
            pruned0 = ex.stats.dynamic_filter_rows_pruned
            gathers0 = ex.stats.mesh_gathers
            bytes0 = MESH_REPARTITION_BYTES.value()
            before = read_counts()
            rows, walls = _timed_runs(session, sql, 4)
            after = read_counts()
            delta = {k: after[k] - before[k] for k in after}
            joins = ex.stats.mesh_partitioned_joins - pj0
            gathers = (ex.stats.mesh_gathers - gathers0) / len(walls)
            single_rows, single_walls = _timed_runs(main_session, sql, 2)
            require(rows == expected[name] == single_rows,
                    f"{name} on the 8-shard mesh differs from the oracle "
                    f"or the single card:\n{rows[:3]}\nvs\n"
                    f"{expected[name][:3]}")
            require(delta["K3"] >= MESH_SHARDS * joins,
                    f"{name}: {joins} partitioned joins, K3 launched "
                    f"{delta['K3']} times")
            per_query[name] = {
                "walls_s": walls, "single_card_walls_s": single_walls,
                "steady_median_s": st.median(walls[1:]),
                "single_card_steady_s": single_walls[1],
                "partitioned_joins": joins,
                "k3_per_partitioned_join": delta["K3"] / joins if joins
                else None,
                "rows_pruned": ex.stats.dynamic_filter_rows_pruned - pruned0,
                "repartition_bytes": MESH_REPARTITION_BYTES.value() - bytes0,
                "mesh_gathers": gathers,
                "launches": delta}
            log(f"mesh {name}: rows equal the oracle and the single card; "
                + json.dumps(per_query[name]))
            log(f"mesh_gathers {name}: {gathers:g} a run")
        require(per_query["q1"]["mesh_gathers"] == 0 and
                per_query["q6"]["mesh_gathers"] == 0,
                "q1 or q6 all-gathered on the mesh")
        record["scan_bytes_by_card"] = _mesh_scan_bytes(ex)
        log("mesh scans, bytes each card holds: " +
            json.dumps(record["scan_bytes_by_card"]))
        # q3 under the broadcast distribution: the probe per shard, the
        # build replicated, the dynamic filter per shard
        bcast = Session(cat, default_schema=TPCH_SCHEMA, device=dev)
        bcast.executor = MeshExecutor(cat, mesh)
        g0 = bcast.executor.stats.mesh_gathers
        rows, walls = _timed_runs(bcast, Q3, 3)
        require(rows == expected["q3"], "q3 under the broadcast "
                "distribution on the mesh differs from the oracle")
        record["q3_broadcast"] = {
            "walls_s": walls, "strategies": bcast.executor.strategy_decisions,
            "mesh_gathers": (bcast.executor.stats.mesh_gathers - g0) / 3}
        log("mesh q3, broadcast joins: " + json.dumps(record["q3_broadcast"]))
        del bcast
        # 2b. a mesh over every card
        record["several_cards"] = _mesh_every_card(cat, sqls, expected,
                                                   main_session)
        require(sum(q["partitioned_joins"] for q in per_query.values()) > 0,
                "no join ran partitioned on the mesh")
        require(per_query["selective"]["rows_pruned"] > 0,
                "SELECTIVE pruned no rows on the mesh")
        text = "\n".join(r[0] for r in session.execute("EXPLAIN " +
                                                       Q3).rows)
        require("join distribution: partitioned" in text,
                "EXPLAIN of q3 on the mesh has no `join distribution: "
                "partitioned`")
        record["tpch"] = per_query
        record["q3_device_profile"] = _device_profile(session, Q3)
        log("mesh q3, one steady run under torch.profiler: " +
            json.dumps(record["q3_device_profile"]))
        # 3. a TPC-DS star on the 8-shard mesh: the ladder, no K4
        ds = Session(ds_session.catalog, default_cat="tpcds",
                     default_schema=TPCDS_SCHEMA, device=dev)
        ds.executor = MeshExecutor(ds_session.catalog, mesh)
        before = read_counts()
        rows, walls = _timed_runs(ds, DS[3], 2)
        after = read_counts()
        want = ds_session.execute(DS[3]).rows
        require(rows == want, "TPC-DS q3 on the mesh differs from the "
                "single card")
        reasons = ds.executor.stats.multijoin_degrade_reasons
        require(reasons.get("mesh", 0) > 0 and after["K4"] == before["K4"],
                f"TPC-DS q3 on the mesh: degrades {reasons}, K4 launched "
                f"{after['K4'] - before['K4']} times")
        record["tpcds_q3"] = {"walls_s": walls, "degrades": reasons}
        log("mesh TPC-DS q3: the ladder (degrade reason mesh), no K4, rows "
            "equal the single card; " + json.dumps(record["tpcds_q3"]))
    finally:
        recorder.active, recorder.keep = False, True
    launches = read_counts()
    require(launches["K3"] > 0, f"the mesh path launched {launches}")
    record["launches"] = launches
    # not a main-path measurement: after the counts are read
    record["stage_checks"] = _mesh_stage_checks(mesh, {
        "lineitem": tables["lineitem"], "orders": orders})
    log("mesh stage programs called directly: " +
        json.dumps(record["stage_checks"]))
    record["phase_s"] = time.monotonic() - t_phase
    log("mesh path: " + json.dumps(record, default=str))
    return launches


# --------------------------------------------------------------------------
# the introspection tier: fenced device/host/compile attribution and the
# Prometheus families the executor feeds
# --------------------------------------------------------------------------

# the eleven families of the executor tier (trino_tpu_torch/metrics.py)
FAMILIES = ("OPERATOR_ROWS", "OPERATOR_DEVICE_MS", "OPERATOR_COMPILE_MS",
            "AGG_STRATEGY_DECISIONS", "JOIN_STRATEGY_DECISIONS",
            "MULTIJOIN_FUSED_PROBES", "MULTIJOIN_DEGRADES",
            "DEVICE_CACHE_HITS", "DEVICE_CACHE_MISSES", "SCAN_ZONES_PRUNED",
            "SCAN_PREFETCH_BUFFERS", "SCAN_PREFETCH_STALL_SECONDS")
# the chunked selective query: lineitem is sorted by l_orderkey, so zone
# maps skip every chunk past the keys below ZONE_KEY (a sixth of them)
ZONE_KEY = 1_000_000
ZONE_SQL = ("SELECT count(*) AS c, sum(l_quantity) AS q FROM lineitem "
            "WHERE l_orderkey < {key}")
INTRO_RUNS = 5


def families_snapshot():
    """Every sample of the executor tier's families, keyed by (family,
    labels): the registry's own values."""
    import trino_tpu_torch.metrics as M
    return {(f, k): v for f in FAMILIES
            for k, v in dict(getattr(M, f)._values).items()}


def families_delta(before, after=None):
    after = families_snapshot() if after is None else after
    return {f"{f}{list(k) if k else ''}": round(v - before.get((f, k), 0.0),
                                                6)
            for (f, k), v in after.items()
            if v != before.get((f, k), 0.0)}


def _fam(delta, family, *labels):
    return delta.get(f"{family}{list(labels) if labels else ''}", 0.0)


def oracle_zone(li, key):
    m = _col(li, "l_orderkey") < key
    return [(int(m.sum()), _dec(int(_col(li, "l_quantity")[m].sum()), 2))]


def _split_check(name, node_stats):
    """Every profiled node's device + host + compile equals its wall to
    1 us. Returns, in ms, the device time summed over the nodes (each
    node's closing fence: they never overlap) and the split of the node
    with the largest wall (times are inclusive of a node's children)."""
    require(node_stats, f"{name}: the profiled run left no node stats")
    for st in node_stats.values():
        require(len(st) == 5, f"{name}: a node's stats are {st}")
        wall, _rows, dev, host, comp = st
        require(min(dev, host, comp) >= 0 and
                abs(wall - (dev + host + comp)) <= 1e-6,
                f"{name}: device {dev} + host {host} + compile {comp} != "
                f"wall {wall}")
    top = max(node_stats.values(), key=lambda st: st[0])
    return {"device_ms": round(sum(st[2] for st in node_stats.values())
                               * 1e3, 4),
            "top_node_ms": [round(top[i] * 1e3, 4) for i in (0, 2, 3, 4)]}


def _profiled_statement(session, name, sql):
    """`sql` unprofiled (its rows), then under enable_profiling inside
    torch.profiler: rows bit-equal, every node's split summing to its
    wall, the summed device ms beside the card's busy ms for the same
    statement, the idle share; then its EXPLAIN ANALYZE text."""
    want = session.execute(sql).rows
    session.execute("SET SESSION enable_profiling = true")
    try:
        before = read_counts()
        res, wall, acts = _profiled_run(session, sql)
        launched = {k: v - before[k] for k, v in read_counts().items()
                    if v != before[k]}
        split = _split_check(name, session.executor.node_stats)
        text = [r[0] for r in session.execute("EXPLAIN ANALYZE " +
                                              sql).rows]
        _split_check(f"{name} EXPLAIN ANALYZE", session.executor.node_stats)
    finally:
        session.execute("SET SESSION enable_profiling = false")
    require(res.rows == want, f"{name}: profiled rows differ from the "
            "unprofiled run's")
    busy_ms = sum(us for _n, us in acts) / 1e3
    out = dict(split, wall_ms=round(wall * 1e3, 4),
               device_busy_ms=round(busy_ms, 4),
               device_over_busy=round(split["device_ms"] / busy_ms, 4)
               if busy_ms else None,
               idle_share=round(1 - busy_ms / (wall * 1e3), 4),
               nodes=len(session.executor.node_stats), launches=launched)
    log(f"introspection {name}: " + json.dumps(out))
    for line in text:
        if "(device " in line:
            log(f"introspection {name} EXPLAIN ANALYZE | {line}")
    require(any("(device " in line and " + compile " in line
                for line in text),
            f"{name}: EXPLAIN ANALYZE renders no device/host/compile split")
    return out


_COLD_BUILD_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from trino_tpu_torch.exec import executor as ex_mod
from trino_tpu_torch.exec.profiler import RECORDER
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import cuda_build
parent, names, stack = {}, {}, []
real = ex_mod.Executor._dispatch_timed

def spy(self, node):
    parent[id(node)] = stack[-1] if stack else None
    names[id(node)] = type(node).__name__
    stack.append(id(node))
    try:
        return real(self, node)
    finally:
        stack.pop()

ex_mod.Executor._dispatch_timed = spy
session = Session(default_schema=sys.argv[2])
session.catalog.connector("tpch").get_table(sys.argv[2], "lineitem")
session.execute("SET SESSION enable_profiling = true")
runs = []
for _ in range(2):
    parent.clear()
    before = RECORDER.totals()["compileSeconds"]
    t = time.monotonic()
    rows = session.execute(sys.argv[3]).rows
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    ns = session.executor.node_stats
    child_c = {}
    for i, st in ns.items():
        p = parent.get(i)
        if p is not None:
            child_c[p] = child_c.get(p, 0.0) + st[4]
    # the compile a node charged itself, not through a child
    own = {i: st[4] - child_c.get(i, 0.0) for i, st in ns.items()}
    runs.append({"wall_s": wall, "rows": repr(rows),
                 "compile_s": RECORDER.totals()["compileSeconds"] - before,
                 "build_nodes": [[names[i], round(c, 6)] for i, c in own.items()
                              if c > 1e-9],
                 "node_compile_s": sum(c for c in own.values()),
                 "split_ok": all(abs(st[0] - st[2] - st[3] - st[4]) <= 1e-6
                                 for st in ns.values())})
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu"))
print(json.dumps({"runs": runs, "build_dir": str(cuda_build.BUILD_DIR),
                  "sites": [e["site"] for e in RECORDER.snapshot()
                            if e["compiles"]],
                  "leaked": leaked}))
"""


def _cold_build_child():
    """A fresh process with an empty kernel build directory runs TPC-H q3
    profiled twice: the first run's compile (the nvcc builds its first
    launches trigger) lands on the nodes that launched the kernels, the
    second compiles nothing."""
    import shutil
    import tempfile
    build = tempfile.mkdtemp(prefix="chip-smoke-build-")
    try:
        env = dict(os.environ, TRINO_TPU_CUDA_BUILD_DIR=build)
        proc = subprocess.run(
            [sys.executable, "-c", _COLD_BUILD_CHILD, HERE, "tiny", Q3],
            env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(build, ignore_errors=True)
    require(proc.returncode == 0,
            f"cold-build child failed:\n{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    first, second = rec["runs"]
    require(not rec["leaked"], f"the cold-build child imported "
            f"{rec['leaked']}")
    require(rec["build_dir"] == build, "the child ignored "
            "TRINO_TPU_CUDA_BUILD_DIR")
    require(first["rows"] == second["rows"], "the cold-build child's runs "
            "returned other rows")
    require(first["split_ok"] and second["split_ok"], "the cold-build "
            "child's split does not sum to the wall")
    require(first["build_nodes"] and first["compile_s"] > 0,
            f"the cold run charged no compile to a node: {first}")
    require(abs(first["node_compile_s"] - first["compile_s"]) <= 1e-6,
            f"the nodes' compile {first['node_compile_s']} s is not the "
            f"recorder's {first['compile_s']} s")
    require(second["compile_s"] == 0 and not second["build_nodes"],
            f"the second run compiled: {second}")
    for r in rec["runs"]:
        r.pop("rows")
    return rec


def _introspection_cluster(main_session):
    """EXPLAIN ANALYZE of q3 on a port coordinator and two workers on the
    card (split_rows 250,000): every worker task of the profiled run
    carries deviceMs > 0 in its TaskStats, as does the distributed
    EXPLAIN ANALYZE's operator rollup."""
    import re
    import tempfile
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer
    cat = Catalog()
    cat.register("tpch", main_session.catalog.connector("tpch"))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-intro-")
    saved = os.environ.get("TRINO_TPU_HISTORY_PATH")
    os.environ["TRINO_TPU_HISTORY_PATH"] = os.path.join(tmp, "h.jsonl")
    coord = CoordinatorServer(Session(cat, default_schema=TPCH_SCHEMA),
                              max_concurrency=4).start()
    sched = coord.state.scheduler
    sched.split_rows = CLUSTER_SPLIT_ROWS
    workers = [WorkerServer(f"intro-w{i}", coord.uri,
                            announce_interval_s=0.1, catalog=cat).start()
               for i in range(2)]
    try:
        _wait_for(lambda: len(coord.state.active_nodes()) == 2,
                  "two workers to announce")
        probe = HttpProbe(coord.uri)
        sched.spool.clear()
        t = time.monotonic()
        rows, info, _w = probe.run("EXPLAIN ANALYZE " + Q3)
        wall = time.monotonic() - t
        require(info.get("fallbackReason") is None,
                f"EXPLAIN ANALYZE q3 ran locally: {info.get('fallbackReason')}")
        text = "\n".join(r[0] for r in rows)
        tasks = list((sched.last_query or {}).get("tasks", []))
        require(len({t["node"] for t in tasks}) == 2,
                f"the profiled q3 ran tasks on {[t['node'] for t in tasks]}")
        require(all(t["device_ms"] > 0 for t in tasks),
                "a worker task's TaskStats carry deviceMs 0: " +
                json.dumps([[t["node"], t["device_ms"]] for t in tasks]))
        ops = re.findall(r"operator (\w+): rows=\d+, wall=([\d.]+)ms "
                         r"\(device ([\d.]+) \+ host ([\d.]+) \+ compile "
                         r"([\d.]+)\)", text)
        require(ops and sum(float(o[2]) for o in ops) > 0,
                "the distributed EXPLAIN ANALYZE shows no device ms:\n" +
                text)
        for line in text.splitlines():
            if line.lstrip().startswith(("operator ", "Stage ")):
                log("introspection cluster EXPLAIN ANALYZE | " + line)
        out = {"wall_s": round(wall, 4), "tasks": [
            {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in t.items() if k in ("node", "stage", "splits",
                                             "wall_ms", "device_ms",
                                             "host_ms", "compile_ms")}
            for t in tasks]}
        log("introspection cluster: " + json.dumps(out))
        return out
    finally:
        for w in workers:
            w.stop(graceful=False)
        coord.stop()
        coord.state.dispatcher.pool.shutdown(wait=True)
        if saved is None:
            os.environ.pop("TRINO_TPU_HISTORY_PATH", None)
        else:
            os.environ["TRINO_TPU_HISTORY_PATH"] = saved
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def phase_introspection(recorder, session, tables, ds_session, smi,
                        fam_before):
    """The introspection tier on the card, after every other path:
    counters set to 0 just before and read just after. TPC-H q3, TPC-DS
    q3 (the fused star, K4), q12 under mxu_agg = 'true' (K5) and chunked
    q12 each run profiled under torch.profiler (rows bit-equal to the
    unprofiled run; every node's device + host + compile = wall to 1 us;
    the summed device ms beside the card's busy ms and the idle share)
    and through EXPLAIN ANALYZE; the families: the fused probes of three
    star runs against `multijoin_fused_probes` and K4's launches, a
    steady chunked rerun's fact-cache hit, the chunked selective query's
    skipped chunks as zones pruned (and again through the prefetch
    pipeline), every family's delta over the whole run; a fresh process
    with an empty build directory (compile on the node that built the
    kernel, none on the second run); EXPLAIN ANALYZE of q3 on a
    two-worker cluster (deviceMs > 0 in every task); and q3's steady wall
    with enable_profiling off and on, INTRO_RUNS runs each."""
    t_phase = time.monotonic()
    record = {}
    reset_counts()
    # count K1/K3 launches per path and site; the timed shapes stay the
    # earlier paths' (as in the cluster path)
    recorder.active, recorder.keep = True, False
    try:
        _introspection_runs(record, session, tables, ds_session, smi,
                            fam_before)
    finally:
        recorder.active, recorder.keep = False, True
    launches = read_counts()
    record["launches"] = launches
    record["phase_s"] = round(time.monotonic() - t_phase, 2)
    log("introspection path: " + json.dumps(record, default=str))
    return launches


def _introspection_runs(record, session, tables, ds_session, smi,
                        fam_before):
    from tpcds_queries import QUERIES as DS
    from tpch_full import QUERIES
    import trino_tpu_torch.metrics as M
    # 1. profiled statements
    session.execute("SET SESSION mxu_agg = 'true'")
    try:
        record["q3"] = _profiled_statement(session, "q3", Q3)
        record["q12"] = _profiled_statement(session, "q12", QUERIES[12])
        record["ds_q3"] = _profiled_statement(ds_session, "ds q3", DS[3])
        session.execute(f"SET SESSION spill_chunk_rows = {CHUNK_ROWS}")
        record["chunked_q12"] = _profiled_statement(session, "chunked q12",
                                                    QUERIES[12])
    finally:
        session.execute("SET SESSION spill_chunk_rows = 0")
        session.execute("SET SESSION mxu_agg = 'auto'")
    require(record["q3"]["launches"].get("K1", 0) > 0 and
            record["q3"]["launches"].get("K3", 0) > 0,
            f"profiled q3 launched {record['q3']['launches']}")
    require(record["ds_q3"]["launches"].get("K4", 0) > 0,
            f"profiled ds q3 launched {record['ds_q3']['launches']}")
    require(record["q12"]["launches"].get("K5", 0) > 0,
            f"profiled q12 launched {record['q12']['launches']}")
    # 2. the families over controlled runs
    ex = ds_session.executor
    fam0, probes0 = families_snapshot(), ex.stats.multijoin_fused_probes
    k4_0 = read_counts()["K4"]
    for _ in range(3):
        ds_session.execute(DS[3])
    d = families_delta(fam0)
    d_probes = ex.stats.multijoin_fused_probes - probes0
    d_k4 = read_counts()["K4"] - k4_0
    record["star_families"] = {
        "multijoin_fused_probes_stat": d_probes, "k4_launches": d_k4,
        "MULTIJOIN_FUSED_PROBES": _fam(d, "MULTIJOIN_FUSED_PROBES"),
        "JOIN_STRATEGY_DECISIONS[multiway]": _fam(
            d, "JOIN_STRATEGY_DECISIONS", "multiway")}
    log("introspection star families (3 steady ds q3 runs): "
        + json.dumps(record["star_families"]))
    require(d_probes == 3 and _fam(d, "MULTIJOIN_FUSED_PROBES") == d_probes
            and _fam(d, "JOIN_STRATEGY_DECISIONS", "multiway") == d_probes
            and d_k4 >= d_probes,
            f"star families: {record['star_families']}")
    li = tables["lineitem"]
    session.execute(f"SET SESSION spill_chunk_rows = {CHUNK_ROWS}")
    try:
        session.execute(Q1)
        fam0 = families_snapshot()
        require(session.execute(Q1).rows == oracle_q1(li),
                "chunked q1 differs from the oracle")
        d = families_delta(fam0)
        record["steady_chunked_q1"] = d
        require(_fam(d, "DEVICE_CACHE_HITS") >= 1 and
                _fam(d, "DEVICE_CACHE_MISSES") == 0,
                f"a steady chunked q1 did not hit the fact cache: {d}")
        # through the pipeline, three chunks survive: it stages them
        for label, fact_cache, key in (
                ("fact cache", True, ZONE_KEY),
                ("prefetch pipeline", False, 3 * ZONE_KEY)):
            zone_want = oracle_zone(li, key)
            session.executor.enable_fact_cache = fact_cache
            fam0 = families_snapshot()
            skipped0 = session.executor.stats.scan_chunks_skipped
            stalls0 = session.executor.stats.scan_prefetch_stalls
            got = session.execute(ZONE_SQL.format(key=key)).rows
            d = families_delta(fam0)
            skipped = session.executor.stats.scan_chunks_skipped - skipped0
            require(got == zone_want, f"chunked zone query ({label}) "
                    f"differs from the oracle: {got} vs {zone_want}")
            require(skipped > 0 and _fam(d, "SCAN_ZONES_PRUNED") == skipped,
                    f"chunked zone query ({label}): {skipped} chunks "
                    f"skipped, SCAN_ZONES_PRUNED {d}")
            record[f"zone_query_{label}"] = dict(
                d, chunks_skipped=skipped,
                prefetch_stalls=session.executor.stats.scan_prefetch_stalls
                - stalls0, spans=dict(session.executor.chunk_spans))
            log(f"introspection chunked zone query ({label}): "
                + json.dumps(record[f"zone_query_{label}"]))
        require(M.SCAN_PREFETCH_BUFFERS.value() == 0,
                "staged prefetch buffers left after the run")
    finally:
        session.executor.enable_fact_cache = True
        session.execute("SET SESSION spill_chunk_rows = 0")
    require("trino_tpu_scan_prefetch_stall_seconds" in M.REGISTRY.render(),
            "/v1/metrics lacks trino_tpu_scan_prefetch_stall_seconds")
    d = families_delta(fam_before)
    record["whole_run"] = d
    log("introspection families, the whole run's deltas: " + json.dumps(d))
    require(sum(v for k, v in d.items()
                if k.startswith("AGG_STRATEGY_DECISIONS")) > 0,
            "AGG_STRATEGY_DECISIONS did not rise")
    require(_fam(d, "MULTIJOIN_FUSED_PROBES") == _fam(
        d, "JOIN_STRATEGY_DECISIONS", "multiway") > 0,
        "MULTIJOIN_FUSED_PROBES and the multiway decisions disagree")
    # 3. a kernel build on the node that launched it
    record["cold_build"] = _cold_build_child()
    log("introspection cold build: " + json.dumps(record["cold_build"]))
    # 4. the cluster
    record["cluster"] = _introspection_cluster(session)
    # 5. the fences' cost on steady q3
    walls = {"false": [], "true": []}
    for _ in range(INTRO_RUNS):         # interleaved, one run at a time
        for setting in ("false", "true"):
            session.execute(f"SET SESSION enable_profiling = {setting}")
            walls[setting].extend(_timed_runs(session, Q3, 1)[1])
    session.execute("SET SESSION enable_profiling = false")
    record["fence_cost"] = {
        "card": smi, "runs_each": INTRO_RUNS,
        "off_median_s": statistics.median(walls["false"]),
        "on_median_s": statistics.median(walls["true"]),
        "off_s": [round(w, 4) for w in walls["false"]],
        "on_s": [round(w, 4) for w in walls["true"]]}
    log("introspection q3 steady wall, profiling off / on: "
        + json.dumps(record["fence_cost"]))


K1_PATHS = ("big tiles", "small tiles")
# the memory-pressure path's K3 captures (LaunchRecorder.capture)
MEMORY_K3 = ("GROUP BY l_orderkey, whole input",
             "GROUP BY l_orderkey, spilled partitions")
# K3's call sites on the main paths (the innermost running one takes the
# launch; a launch under none of them is "other hash aggregates")
K3_SITES = {"star builds": "_multijoin_tables",
            "partitioned aggregates": "_partitioned_hash_agg",
            "chunked merges": "merge_group_aggregate",
            "hybrid join builds": "try_hash_join"}
# ... and the mesh's partitioned joins (one table a shard)
K3_MESH_SITES = {"mesh shard builds": "_mesh_partitioned_join"}


def k1_path(tables) -> str:
    """Which of K1's two paths a call takes (ops/gather.plan_gather):
    `big tiles` where a table of the call is small enough to stay in L1
    (a star's payload gather), else `small tiles` (q3's dense-LUT
    probe)."""
    from trino_tpu_torch.ops import gather as k1
    plans = k1.plan_gather([t.element_size() for t in tables],
                           tables[0].shape[0])
    return K1_PATHS[0] if any(p.big_tile for p in plans) else K1_PATHS[1]


class ScaleLaunches:
    """A phase's largest launch of each kernel (K1's per path) and its
    launch counts (the scale and bench-modes phases), kept apart from
    the main-path shapes the timing phase times; read with the same
    timing helpers."""

    def __init__(self):
        self.k1, self.k1_launches = {}, {}
        self.k2 = self.k3 = self.k4 = None
        self.sizes = {}
        self.launches = {"K2": 0, "K3": 0, "K4": 0}

    def keep(self, kernel: str, args, size: int) -> None:
        self.launches[kernel] += 1
        if size > self.sizes.get(kernel, -1):
            self.sizes[kernel] = size
            setattr(self, kernel.lower(), args)

    def keep_k1(self, path: str, args, launches: int) -> None:
        self.k1_launches[path] = self.k1_launches.get(path, 0) + launches
        kept = self.k1.get(path)
        if kept is None or args[1].shape[0] > kept[1].shape[0]:
            self.k1[path] = args


class LaunchRecorder:
    """Keeps the inputs of the largest launch of each kernel in the main
    paths (by rows) so that the timing phase times the kernels on them.
    Wraps the launch functions without touching the wrappers' counters."""

    def __init__(self):
        self.active = False
        # False: count K1/K3 launches per path and site, but keep the
        # largest launches recorded so far (the corpus paths run after
        # the timed shapes were chosen)
        self.keep = True
        self.k1 = {}              # K1's largest launch per path
        self.k1_launches = {}     # K1's main-path launches per path
        self.k3 = {}              # K3's largest launch per call site
        self.k3_launches = {}     # K3's main-path launches per call site
        # the executor methods being run, per thread (the cluster path's
        # workers launch from threads of their own)
        self._sites = threading.local()
        # K1's per-path count reads the wrappers' counter around a launch:
        # one launch at a time, or two workers' launches mix
        self._k1_lock = threading.Lock()
        self.k4 = None
        self.star_build = None    # the largest build_join_tables call
        self.k5 = None            # K5's largest launch: its public args
        self.k2 = None
        # a label: count K3's launches under it and keep the largest (the
        # memory-pressure path's resident and spilled aggregates)
        self.capture = None
        self.captured = {}        # label -> (largest launch, launches)
        # the scale and bench-modes phases' largest launches, apart from
        # the timed main-path shapes (ScaleLaunches); `extra` is the one
        # the running phase fills
        self.scale = self.bench = self.extra = None

    def recording(self) -> bool:
        return self.active and self.keep

    def k3_site(self) -> list:
        if not hasattr(self._sites, "stack"):
            self._sites.stack = []
        return self._sites.stack

    def install(self):
        from trino_tpu_torch.ops import direct_agg as k5
        from trino_tpu_torch.ops import gather as k1
        from trino_tpu_torch.ops import hashtable as ht
        from trino_tpu_torch.exec.executor import Executor
        real_k1, real_k3 = k1._launch, ht._launch
        real_k4, real_k5 = ht._launch_multiprobe, k5._launch
        real_k2 = k1._launch_window

        def k2_launch(planes, idx):
            if self.recording() and (self.k2 is None or
                                     idx.shape[0] > self.k2[1].shape[0]):
                self.k2 = (planes, idx)
            if self.active and self.extra is not None:
                self.extra.keep("K2", (planes, idx), idx.shape[0])
            return real_k2(planes, idx)
        k1._launch_window = k2_launch

        def k4_launch(live, keys, tkey, src):
            if self.recording() and (self.k4 is None or len(keys) *
                                     live.shape[0] > len(self.k4[1]) *
                                     self.k4[0].shape[0]):
                self.k4 = (live, list(keys), tkey, src)
            if self.active and self.extra is not None:
                self.extra.keep("K4", (live, list(keys), tkey, src),
                                len(keys) * live.shape[0])
            return real_k4(live, keys, tkey, src)

        def k5_launch(batch, key_indices, domains, aggs):
            if self.recording() and (self.k5 is None or batch.capacity >
                                     self.k5[0].capacity):
                self.k5 = (batch, key_indices, domains, aggs)
            return real_k5(batch, key_indices, domains, aggs)

        real_build = ht.build_join_tables

        def build_tables(builds, keys_per_build, table_slots):
            def size(b):
                return sum(x.capacity for x in b) * len(b)
            if self.recording() and (self.star_build is None or
                                     size(builds) >
                                     size(self.star_build[0])):
                self.star_build = (list(builds), list(keys_per_build),
                                   table_slots)
            return real_build(builds, keys_per_build, table_slots)

        ht._launch_multiprobe = k4_launch
        ht.build_join_tables = build_tables
        k5._launch = k5_launch

        def k1_launch(tables, idx, fills):
            if not self.active:
                return real_k1(tables, idx, fills)
            path = k1_path(tables)
            kept = self.k1.get(path)
            if self.keep and (kept is None or
                              idx.shape[0] > kept[1].shape[0]):
                self.k1[path] = (list(tables), idx, list(fills))
            with self._k1_lock:
                before = k1.gather_columns.launches
                out = real_k1(tables, idx, fills)
                n = k1.gather_columns.launches - before
                self.k1_launches[path] = self.k1_launches.get(path, 0) + n
            if self.extra is not None:
                self.extra.keep_k1(path, (list(tables), idx, list(fills)),
                                   n)
            return out

        def k3_launch(key, mask, tid, planes, layout, nstates, T, G,
                      pairs):
            args = (key, mask, tid, planes, layout, nstates, T, G, pairs)
            if not self.active:
                return real_k3(*args)
            if self.capture is not None:
                kept, n = self.captured.get(self.capture, (None, 0))
                if kept is None or key.shape[0] * G > kept[0].shape[0] * \
                        kept[7]:
                    kept = args
                self.captured[self.capture] = (kept, n + 1)
            sites = self.k3_site()
            site = sites[-1] if sites else "other hash aggregates"
            kept = self.k3.get(site)
            # the mesh's shard builds run only after the timed shapes
            # were chosen: their site keeps its largest launch regardless
            if (self.keep or site in K3_MESH_SITES) and (
                    kept is None or key.shape[0] * G >
                    kept[0].shape[0] * kept[7]):
                self.k3[site] = args
            self.k3_launches[site] = self.k3_launches.get(site, 0) + 1
            if self.extra is not None:
                self.extra.keep("K3", args, key.shape[0] * G)
            return real_k3(*args)

        def at_site(name, method):
            def run(*args, **kwargs):
                self.k3_site().append(name)
                try:
                    return method(*args, **kwargs)
                finally:
                    self.k3_site().pop()
            return run

        for name, method in K3_SITES.items():
            setattr(Executor, method, at_site(name, getattr(Executor,
                                                            method)))
        from trino_tpu_torch.parallel.dist_executor import MeshExecutor
        for name, method in K3_MESH_SITES.items():
            setattr(MeshExecutor, method,
                    at_site(name, getattr(MeshExecutor, method)))
        k1._launch = k1_launch
        ht._launch = k3_launch


def phase_timing(recorder, launches):
    require(None not in (recorder.k2, recorder.k4, recorder.k5,
                         recorder.star_build) and
            "star builds" in recorder.k3 and
            set(recorder.k1) == set(K1_PATHS) and
            set(recorder.captured) == set(MEMORY_K3),
            f"a kernel's launch was not recorded on the main paths "
            f"(K1: {sorted(recorder.k1)}, K3: {sorted(recorder.k3)}, "
            f"memory pressure: {sorted(recorder.captured)})")
    require(sum(recorder.k1_launches.values()) == launches["K1"],
            "K1's launches per path do not add up")
    require(sum(recorder.k3_launches.values()) == launches["K3"],
            "K3's launches per call site do not add up")
    log("K3 launches on the main paths per call site: "
        + json.dumps(recorder.k3_launches))
    log(f"events around an empty call: {time_cuda(lambda: None):.4f} ms "
        f"(the floor under every `ms` below)")
    flush = l2_flush()
    out = [_time_k1(recorder, path, flush) for path in K1_PATHS]
    out.append(_time_k2(recorder, launches, flush))
    out.extend(_time_k3(recorder))
    out.append(_time_k4(recorder, launches))
    out.extend(_time_k5(recorder, launches))
    out.extend(_time_beyond(recorder, recorder.scale, flush,
                            "the scale phase",
                            f" at scale (q5-shaped SF{SCALE_Q5:g}, q3 "
                            f"tpch.{SCALE_Q3_SCHEMA})"))
    out.extend(_time_beyond(recorder, recorder.bench, flush,
                            "the bench-modes phase",
                            " at the micro-benchmarks' shapes"))
    return out


def _time_beyond(recorder, sc, flush, phase, tag):
    """A phase's launches (`sc`) that are larger than the main-path
    launch the rows above time for the same kernel (K1 per path), each
    timed the same way and named with `tag`."""
    if sc is None:
        return []
    out = []
    for path in K1_PATHS:
        if path in sc.k1 and \
                sc.k1[path][1].shape[0] > recorder.k1[path][1].shape[0]:
            out.append(_time_k1(sc, path, flush))
    if sc.k2 is not None and \
            sc.k2[1].shape[0] > recorder.k2[1].shape[0]:
        out.append(_time_k2(sc, sc.launches, flush))
    main_k3 = max([a[0].shape[0] * a[7] for a in recorder.k3.values()] +
                  [a[0].shape[0] * a[7]
                   for a, _n in recorder.captured.values()])
    if sc.k3 is not None and sc.sizes["K3"] > main_k3:
        out.append(_k3_row(f"{phase}'s largest", sc.k3,
                           sc.launches["K3"]))
    if sc.k4 is not None and \
            sc.sizes["K4"] > len(recorder.k4[1]) * recorder.k4[0].shape[0]:
        out.append(_time_k4(sc, sc.launches))
    for row in out:
        row["name"] += tag
    log(f"{phase}'s launches beyond the main paths' largest: "
        + json.dumps([row["name"] for row in out]))
    return out


def host_ms(fn, calls: int = 200) -> float:
    """Host ms per call of `fn` over `calls` calls back to back (the card
    runs behind; its queue is drained before and after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def activities_per_call(fn, reps: int = 5) -> float:
    """Device activities (kernels, memsets, memcpys) one call of `fn` runs,
    from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return len(_device_activities(prof)) / reps


def _time_k1(recorder, path, flush):
    """K1 on its largest main-path launch of one path, every call (kernel,
    plain and library) after an L2 flush."""
    import torch
    from trino_tpu_torch.ops import gather as k1
    tables, idx, fills = recorder.k1[path]
    n = idx.shape[0]
    w = tables[0].shape[0]
    got = k1.gather_columns(tables, idx, fills)
    want = k1.gather_columns_plain(tables, idx, fills)
    require(all(_bits_equal(a, b) for a, b in zip(got, want)),
            "K1 differs from plain on the main-path inputs")
    ms = time_cuda(lambda: k1.gather_columns(tables, idx, fills),
                   flush=flush)
    plain_ms = time_cuda(lambda: k1.gather_columns_plain(tables, idx,
                                                         fills), flush=flush)
    idx_c = idx.clamp(0, w - 1)
    lib_ms = time_cuda(lambda: [torch.index_select(t, 0, idx_c)
                                for t in tables], flush=flush)
    out_bytes = sum(t.element_size() for t in tables) * n
    in_bytes = idx.element_size() * n + \
        sum(t.numel() * t.element_size() for t in tables)
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    sector_ms = (idx.element_size() * n + out_bytes +
                 32 * n * len(tables)) / HBM_BYTES_PER_S * 1e3
    rows = int(torch.unique(idx[(idx >= 0) & (idx < w)]).numel())
    log(f"timing K1 ({path}): n={n} W={w} idx {idx.dtype} (touching "
        f"{rows} rows) tables="
        f"{[str(t.dtype).replace('torch.', '') for t in tables]} "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(index_select per table) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms"
        f" (each input read once from HBM, L2 flushed before each call), "
        f"{sector_ms:.4f} ms (one DRAM sector per random read)")
    return with_device_time(
        {"name": f"K1 gather_columns ({path})", "route": "cuda",
         "source": "trino_tpu_torch/csrc/gather.cu",
         "replaces": "trino_tpu/ops/pallas_gather.py:155",
         "launches": recorder.k1_launches[path],
         "max_abs_err": _max_abs_err(zip(got, want)),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": "bytes", "library_ms": lib_ms},
        lambda: k1.gather_columns(tables, idx, fills), flush=flush)


def _time_k3(recorder):
    """K3 on its largest main-path launch per multi-table call site (a
    star's builds, a partitioned aggregate's partitions), and on one
    table of the star's launch alone: the single build of the parent's
    row."""
    import torch
    from trino_tpu_torch.ops import hashtable as ht
    key, mask, tid, planes, layout, ns, T, G, pairs = \
        recorder.k3["star builds"]
    rows = [int(((tid == g) if tid is not None else mask).sum())
            for g in range(G)]
    g = rows.index(max(rows))
    one = tid == g if tid is not None else torch.ones_like(mask)
    single = (key[one], mask[one], None,
              tuple((None if v is None else v[one],
                     None if ok is None else ok[one]) for v, ok in planes),
              layout, ns, T, 1, False)
    multi_launches = sum(recorder.k3_launches.get(site, 0) for site in
                         ("star builds", "partitioned aggregates",
                          "mesh shard builds"))
    out = [_k3_row("one table", single,
                   sum(recorder.k3_launches.values()) - multi_launches)]
    builds, keys_per_build, slots = recorder.star_build
    out.append(_k3_row("star builds", recorder.k3["star builds"],
                       recorder.k3_launches["star builds"],
                       lambda: ht.build_join_tables(builds, keys_per_build,
                                                    slots)))
    for site in ("partitioned aggregates", "mesh shard builds"):
        if site in recorder.k3:
            out.append(_k3_row(site, recorder.k3[site],
                               recorder.k3_launches[site]))
    # the memory-pressure path's largest launches, resident and spilled
    # (their launches are also in the per-site rows above)
    for label in MEMORY_K3:
        args, n = recorder.captured[label]
        row = _k3_row(f"memory pressure, {label}", args, n)
        row["note"] = "launches also counted in the per-site rows"
        out.append(row)
    return out


def _k3_row(what, args, launches, public=None):
    """K3's kernels-line row on one recorded launch: the kernel against
    its plain version (the groups of every table that did not escape, and
    the interleaved {key, row id} table of a join build; a table where
    only the plain version's row order ran a row out of probes against
    the plain version over its rows in a table four times as large),
    timed; with
    `public`, also the public call that made the launch, its torch prep
    included."""
    import torch
    from trino_tpu_torch.ops import hashtable as ht
    key, mask, tid, planes, layout, ns, T, G, pairs = args
    n = key.shape[0]

    def call():
        return ht.hash_insert_multi(key, mask, planes, layout, ns, T, G,
                                    tid, pairs)

    def plain():
        return ht.hash_insert_multi_plain(key, mask, planes, layout, ns, T,
                                          G, tid, pairs)
    tk, st, cnt, pr = call()
    tk2, st2, cnt2, pr2 = plain()
    c, c2 = cnt.tolist(), cnt2.tolist()

    def groups(tk, st, pr, t):
        out = [_groups_by_key(tk[t], st[:, t])]
        if pairs:
            out.append(_groups_by_key(pr[t, :, 0], pr[t, :, 1][None]))
        return out
    compared, kernel_only, plain_only = [], [], []
    for t in range(G):
        if c[t][0]:
            # discarded by the caller; its slots depend on which racing
            # row won
            if not c2[t][0]:
                kernel_only.append(t)
            continue
        if c2[t][0]:
            # which rows run out of probes depends on the order of
            # insertion: the kernel placed every row where the plain
            # version's row order did not, so hold the kernel against
            # the plain version over this table's rows in a table four
            # times as large, where no row escapes
            rows = mask & (tid == t) if tid is not None else mask
            tk3, st3, cnt3, pr3 = ht.hash_insert_multi_plain(
                key, rows, planes, layout, ns, 4 * T, 1, None, pairs)
            require(int(cnt3[0, 0]) == 0, f"K3 ({what}) table {t}: the "
                    f"plain version escaped at four times the slots")
            want, want_occ = groups(tk3, st3, pr3, 0), int(cnt3[0, 1])
            plain_only.append(t)
        else:
            want, want_occ = groups(tk2, st2, pr2, t), c2[t][1]
        got = groups(tk, st, pr, t)
        require(c[t][1] == want_occ and all(
            torch.equal(a, b) for a, b in zip(got, want)),
            f"K3 ({what}) table {t} differs from plain")
        compared += zip(got, want)
    require(compared, f"K3 ({what}): every table escaped, none compared")
    err = _max_abs_err(compared)
    ms = time_cuda(call)
    plain_ms = time_cuda(plain, reps=3)
    host = host_ms(call)
    in_bytes = n * (8 + 1 + (4 if tid is not None else 0)) + sum(
        n * ((0 if v is None else v.element_size()) +
             (0 if ok is None else 1)) for v, ok in planes)
    out_bytes = G * T * 8 * (1 + ns) + (16 * G * T if pairs else 0) + 8 * G
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"timing K3 ({what}): n={n} G={G} T={T} states={ns} groups="
        f"{sum(x[1] for x in c)} escaped tables "
        f"{sum(1 for x in c if x[0] > 0)}, {G - sum(1 for x in c if x[0])}"
        f" tables compared with plain{' (groups and pairs)' if pairs else ''}"
        f"; by insertion order, escapes of the kernel alone in tables "
        f"{kernel_only} and of the plain version alone in {plain_only}"
        f"; kernel {ms:.4f} ms, host {host:.4f} ms per call, plain "
        f"{plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms (bytes: "
        f"inputs read once, tables written once)")
    row = {"name": f"K3 hash_insert_multi ({what})", "route": "cuda",
           "source": "trino_tpu_torch/csrc/hash_insert.cu",
           "replaces": "trino_tpu/ops/pallas_hash.py:189",
           "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "library_ms": None, "host_ms": host,
           "rows": n, "tables": G,
           "escaped_kernel_only": len(kernel_only),
           "escaped_plain_only": len(plain_only)}
    if public is not None:
        row["call_ms"] = time_cuda(public)
        row["call_device_ms"], method, parts = device_time(public)
        row["call_host_ms"] = host_ms(public)
        log(f"timing K3 ({what}) public call with its torch prep: "
            f"{row['call_ms']:.4f} ms, device {row['call_device_ms']:.4f} "
            f"ms ({method}; {len(parts)} activity kinds), host "
            f"{row['call_host_ms']:.4f} ms per call")
    return with_device_time(row, call)


def _time_k2(recorder, launches, flush):
    """K2 on its largest main-path launch, every call (kernel, plain and
    library) after an L2 flush."""
    import torch
    from trino_tpu_torch.ops import gather as k2
    planes, idx = recorder.k2
    n = idx.shape[0]
    word = str(planes.dtype).replace("torch.", "")
    got_w, got_e = k2.gather_word_windowed(planes, idx, word)
    want_w, want_e = k2.gather_word_windowed_plain(planes, idx, word)
    require(_bits_equal(got_w, want_w) and int(got_e) == int(want_e),
            "K2 differs from plain on the main-path inputs")
    ms = time_cuda(lambda: k2.gather_word_windowed(planes, idx, word),
                   flush=flush)
    plain_ms = time_cuda(lambda: k2.gather_word_windowed_plain(
        planes, idx, word), flush=flush)
    ok = (idx >= 0) & (idx < planes.shape[0])
    idx_c = torch.where(ok, idx, 0)
    lib_ms = time_cuda(lambda: torch.index_select(planes, 0, idx_c),
                       flush=flush)
    # bytes this run's data needs: the int64 index read once, the int64
    # word written once, and the LUT bytes the in-range key span touches
    live = idx[ok]
    span = int(live.max() - live.min() + 1) if live.numel() else 0
    need = 8 * n + 8 * n + span * planes.element_size()
    bound_ms = need / HBM_BYTES_PER_S * 1e3
    log(f"timing K2: n={n} LUT={planes.shape[0]} {word} words, key span "
        f"{span}, escapes {int(got_e)}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_select of the same words (a gather "
        f"without the window semantics) {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (bytes: index read and word written once, the "
        f"span's LUT bytes once, from HBM: L2 flushed before each call)")
    return with_device_time(
        {"name": "K2 gather_word_windowed", "route": "cuda",
         "source": "trino_tpu_torch/csrc/window_gather.cu",
         "replaces": "trino_tpu/ops/pallas_gather.py:206",
         "launches": launches["K2"],
         "max_abs_err": _max_abs_err([(got_w, want_w)]),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": "bytes", "library_ms": lib_ms},
        lambda: k2.gather_word_windowed(planes, idx, word), flush=flush)


def _time_k4(recorder, launches):
    """K4 on its largest main-path launch through the public
    ``multiway_probe`` (its fact batch rebuilt from the launch's key
    columns, one column a dimension, the tables as the star built them);
    and, apart, the reference wrapper's encoding in torch on the same
    rows (``encode_probe_keys``, the prep a caller ran before K4 read
    keys itself)."""
    import torch
    from trino_tpu_torch.batch import Batch, Column
    from trino_tpu_torch.ops import hashtable as ht
    live, keys, tkey, src = recorder.k4
    k, n, T = len(keys), live.shape[0], tkey.shape[1]
    probe = Batch(tuple(Column(key, ok) for key, ok in keys), live)
    pk = tuple((d,) for d in range(k))

    def call():
        return ht.multiway_probe(probe, tkey, src, pk)

    def plain():
        return ht._multiway_probe_keys_plain(live, keys, tkey, src)
    found, miss = call()
    found2, miss2 = plain()
    require(_bits_equal(found, found2) and _bits_equal(miss, miss2),
            "K4 differs from plain on the main-path inputs")
    ms = time_cuda(call)
    plain_ms = time_cuda(plain)
    host = host_ms(call)
    acts = activities_per_call(call)
    # what this run's data needs: every row's live byte; dimension d's
    # key and validity byte only for the rows alive entering it; found
    # (int32) for every row and dimension; each table once
    alive = int(live.sum())
    need = n + 4 * k * n + 16 * k * T
    for d, (key, _ok) in enumerate(keys):
        need += alive * (key.element_size() + 1)
        alive -= int(miss[d])
    bound_ms = need / HBM_BYTES_PER_S * 1e3
    require(ht._is_interleaved(tkey, src),
            "the star's tables reached K4 as planes")

    def prep():
        return ht.encode_probe_keys(live, keys, T)
    prep_ms = time_cuda(prep)
    prep_dev = device_time(prep)[0]
    log(f"timing K4: k={k} n={n} T={T} key bytes "
        f"{[kk.element_size() for kk, _ in keys]} misses {miss.tolist()}; "
        f"public multiway_probe {ms:.4f} ms, host {host:.4f} ms per call, "
        f"{acts:.1f} device activities per call, plain {plain_ms:.4f} ms, "
        f"library none, bound {bound_ms:.4f} ms (bytes this data needs: "
        f"live bytes, dimension d's key and validity only for rows alive "
        f"entering it, int32 found for all, tables once); the torch "
        f"encoding of the same keys (encode_probe_keys) {prep_ms:.4f} ms, "
        f"device {prep_dev:.4f} ms")
    return with_device_time(
        {"name": "K4 multiway_probe", "route": "cuda",
         "source": "trino_tpu_torch/csrc/multiprobe.cu",
         "replaces": "trino_tpu/ops/pallas_hash.py:568",
         "launches": launches["K4"],
         "max_abs_err": _max_abs_err([(found, found2), (miss, miss2)]),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": "bytes", "library_ms": None, "host_ms": host,
         "device_activities_per_call": acts, "prep_ms": prep_ms,
         "prep_device_ms": prep_dev}, call)


def _k5_public(k5, args) -> dict:
    """K5's public call on `args` (batch, keys, domains, aggregates),
    timed as K3's and K4's public calls are: `call_ms` (events around one
    call), `call_device_ms` (torch.profiler), `call_host_ms` (200 calls
    back to back), the device activities one call runs with their names,
    and the bytes one call allocates above what was allocated before it
    (peak)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call():
        return k5.direct_group_aggregate_mxu(*args)
    out = {"call_ms": time_cuda(call)}
    out["call_device_ms"], out["call_device_method"], _ = device_time(call)
    out["call_host_ms"] = host_ms(call)
    names = None
    for _attempt in range(5):     # CUPTI now and then drops a trace
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        traced = [name for name, _us in _device_activities(prof)]
        require(len(traced) <= 5 and all("k5_" in n for n in traced),
                f"K5's public call ran other device work: {traced}")
        if len(traced) == 5:
            names = traced
            break
    if names is None:
        log("K5's public call: no whole trace of 5 calls came back in 5 "
            "tries; device activities per call not measured")
    out["device_activities_per_call"] = None if names is None else 1.0
    out["device_activity_names"] = sorted(set(names or ()))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    out["call_alloc_bytes"] = torch.cuda.max_memory_allocated() - base
    return out


def _k5_bytes(batch, keys, domains, aggs):
    """(what this run's data needs, what reading every row needs) in
    bytes: every row's live byte; each key's value and validity for the
    rows still contributing when it is read; each count's validity and
    each sum's validity for the contributing rows, a sum's value for
    those of them that are not NULL; the output columns once."""
    from trino_tpu_torch.ops import direct_agg as k5
    n = batch.capacity
    need, every = n, n
    alive = batch.live
    for ki in keys:
        col = batch.columns[ki]
        width = col.data.element_size() + 1
        need += int(alive.sum()) * width
        every += n * width
        alive = alive & col.valid
    rows = int(alive.sum())
    for a in aggs:
        if a.func == "count_star":
            continue
        col = batch.columns[a.arg_index]
        need += rows
        every += n
        if a.func == "sum":
            need += int((alive & col.valid).sum()) * col.data.element_size()
            every += n * col.data.element_size()
    groups = 1
    for d in domains:
        groups *= d
    out = k5.output_layout([batch.columns[k].data.dtype for k in keys],
                           [a.func for a in aggs], groups)[-1]
    return need + out, every + out


def _k5_row(what, args, launches) -> dict:
    """K5's kernels-line row on one direct aggregate: the public call
    (one launch) against the plain version, every output column
    bit-exact; `library_ms` is `index_add_` of the reference's lanes
    (group_lanes, made before the clock) into [G + 1, A], the summing
    part alone."""
    import torch
    from test_torch_k5_cases import same_batch
    from trino_tpu_torch.ops import direct_agg as k5
    batch, keys, domains, aggs = args
    n = batch.capacity
    G = int(torch.tensor(domains).prod())

    def call():
        return k5.direct_group_aggregate_mxu(*args)

    def plain():
        return k5.direct_group_aggregate_mxu_plain(*args)
    got, want = call(), plain()
    require(same_batch(got, want), f"K5 ({what}) differs from plain")
    gid, planes = k5.group_lanes(*args)
    gl, pt = gid.long(), planes.T.contiguous()
    A = planes.shape[0]

    def library():
        lib = torch.zeros((G + 1, A), dtype=torch.int64, device=gid.device)
        lib.index_add_(0, gl, pt)
        return lib
    require(torch.equal(library()[:G], k5.group_sums_plain(gid, planes, G)),
            f"K5 ({what}): index_add_ differs from the masked sums")
    ms = time_cuda(call)
    plain_ms = time_cuda(plain)
    lib_ms = time_cuda(library)
    need, every = _k5_bytes(batch, keys, domains, aggs)
    bound_ms = need / HBM_BYTES_PER_S * 1e3
    public = _k5_public(k5, args)
    require(public["call_alloc_bytes"] < A * n * 8,
            f"K5 ({what}): the public call allocated "
            f"{public['call_alloc_bytes']} bytes")
    log(f"timing K5 ({what}): n={n} G={G} A={A} keys "
        f"{[str(batch.columns[k].data.dtype) for k in keys]}; public call "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (index_add_ of the "
        f"lanes into [G+1, A]) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes this data needs; every row read: "
        f"{every / HBM_BYTES_PER_S * 1e3:.4f} ms); "
        + json.dumps(public))
    return with_device_time(
        {"name": f"K5 direct_group_aggregate_mxu ({what})", "route": "cuda",
         "source": "trino_tpu_torch/csrc/direct_agg.cu",
         "replaces": "trino_tpu/ops/pallas_agg.py:73",
         "launches": launches,
         "max_abs_err": _max_abs_err([(a.data, b.data) for a, b in
                                      zip(got.columns, want.columns)]),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": "bytes", "library_ms": lib_ms,
         "host_ms": public["call_host_ms"], "rows": n, "groups": G,
         "planes": A, "every_row_bound_ms":
         every / HBM_BYTES_PER_S * 1e3,
         **{k: v for k, v in public.items()
            if k != "device_activity_names"}}, call)


def _time_k5(recorder, launches):
    """K5 on q12's main-path batch, and on the full-width shape, which no
    main path launches: its row's `launches` is null."""
    _time_direct_arms(recorder)
    full = _k5_row("6M rows, G = 16, eight sums",
                   k5_inputs(recorder.k5[0].device, K5_FULL, 7), None)
    full["note"] = "a synthetic shape, not a main-path launch"
    return [_k5_row("q12's batch", recorder.k5, launches["K5"]), full]


def _same_groups(x, y) -> bool:
    import torch
    if not torch.equal(x.live, y.live) or len(x.columns) != len(y.columns):
        return False
    return all(torch.equal(a.valid, b.valid) and
               torch.equal(a.data[a.valid], b.data[b.valid])
               for a, b in zip(x.columns, y.columns))


def _time_direct_arms(recorder):
    """Both arms of a direct aggregate on q12's batch: K5's `mxu` arm and
    the masked-sum `direct` arm, at q12's own domain and with its first
    key redrawn uniformly over G groups, so that the log shows where, on
    this card, K5's arm starts to beat the one it replaces."""
    import torch
    from trino_tpu_torch.batch import Batch, Column
    from trino_tpu_torch.ops import direct_agg as k5
    from trino_tpu_torch.ops.aggregate import direct_group_aggregate
    batch, keys, domains, aggs = recorder.k5
    g = torch.Generator(device=batch.device).manual_seed(12)
    cases = [("q12", batch, keys, domains)]
    key = batch.columns[keys[0]]
    for n_groups in (2, 4, 8, 12, 16):
        redrawn = torch.randint(0, n_groups, key.data.shape, generator=g,
                                device=batch.device).to(key.data.dtype)
        cols = list(batch.columns)
        cols[keys[0]] = Column(data=redrawn, valid=key.valid)
        cases.append((f"G={n_groups}", Batch(columns=tuple(cols),
                                              live=batch.live),
                      keys[:1], (n_groups,)))
    arms = []
    for name, b, ks, ds in cases:
        require(_same_groups(k5.direct_group_aggregate_mxu(b, ks, ds, aggs),
                             direct_group_aggregate(b, ks, ds, aggs)),
                f"the mxu and direct arms differ on {name}")
        mxu_ms = time_cuda(lambda: k5.direct_group_aggregate_mxu(
            b, ks, ds, aggs))
        direct_ms = time_cuda(lambda: direct_group_aggregate(b, ks, ds,
                                                             aggs))
        arms.append({"case": name, "groups": int(torch.tensor(ds).prod()),
                     "mxu_ms": mxu_ms, "direct_ms": direct_ms})
    wins = [a["groups"] for a in arms[1:] if a["mxu_ms"] < a["direct_ms"]]
    log(f"direct-aggregate arms on q12's batch ({batch.capacity} rows, "
        f"{len(aggs)} aggregates; K5's arm vs the masked-sum arm, median "
        f"ms): " + json.dumps({"arms": arms, "mxu_wins_from_groups":
                               min(wins) if wins else None}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))    # the query texts
    dev = torch.device("cuda")
    # no decisions on disk at the start: the phases after the first
    # statement replay only what this run recorded
    remove_decision_file()
    smi = phase_card()
    scale_data = ScaleData()
    try:
        kernels = _run_phases(dev, smi, scale_data)
    finally:
        scale_data.close()
    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "trino_tpu."))
              or m == "trino_tpu"]
    require(not leaked, f"imported {leaked[:5]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _timed(fn, *args):
    """Run one phase and log its wall."""
    t = time.monotonic()
    out = fn(*args)
    log(f"{fn.__name__} took {time.monotonic() - t:.1f} s")
    return out


def _run_phases(dev, smi, scale_data) -> list:
    """Every phase after the card's: the kernels against their plain
    versions, the main paths (their launches summed), the device
    profiles and the timing; returns the kernels line's rows."""
    for check in (phase_k1, phase_k2, phase_k3, phase_k4, phase_k5):
        _timed(check, dev)
    recorder = LaunchRecorder()
    recorder.install()
    fam_before = families_snapshot()
    session, tables, launches = _timed(phase_tpch_path, recorder)
    ds_launches, ds_session, ds_tables, ds_expected, ds_walls = \
        _timed(phase_tpcds_path, recorder)
    paths = [ds_launches,
             _timed(phase_q12_path, recorder, session, tables),
             _timed(phase_chunked_path, recorder, session, tables),
             _timed(phase_ds_chunked, recorder, ds_session, ds_tables,
                    ds_expected, ds_walls),
             _timed(phase_stream_build, recorder, session),
             _timed(phase_corpus_paths, recorder, session, tables,
                    ds_session),
             _timed(phase_corpus_card, recorder, session, ds_session),
             _timed(phase_write_path, recorder, session),
             _timed(phase_memory_pressure, recorder, session, tables),
             _timed(phase_http_path, recorder, session, tables),
             _timed(phase_cluster_path, recorder, session, tables),
             _timed(phase_fault_tolerance, recorder, session, tables),
             _timed(phase_soaks, recorder),
             _timed(phase_mesh_path, recorder, session, tables,
                    ds_session),
             _timed(phase_introspection, recorder, session, tables,
                    ds_session, smi, fam_before),
             _timed(phase_scale, recorder, scale_data),
             _timed(phase_bench_modes, recorder)]
    for path in paths:
        for name, count in path.items():
            launches[name] += count
    log("main paths, launches in all: " + json.dumps(launches))
    _timed(phase_device_profiles, session, ds_session)
    return _timed(phase_timing, recorder, launches)


if __name__ == "__main__":
    sys.exit(main())
