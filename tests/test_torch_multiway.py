"""K4 and the fused multiway star join (trino_tpu_torch/ops/hashtable.py
multiway_probe, exec/executor.py run_multijoin) against the reference's
`pallas_hash.multiway_probe` in interpret mode and its run_multijoin.

Tolerances: the probe's `found` row ids and per-dimension `miss` counts
are bit-exact with the reference, dead rows, NULL keys, sentinel keys and
an exhausted probe chain included. Star queries are bit-exact between the
fused path and the pairwise ladder (rows equal in order), and every
degrade is counted by reason with the reference's counts.

Shapes stay small (<= 4k fact rows, tables of <= 4096 slots): the
interpreter runs the reference's per-row probe loop in XLA on the CPU.
On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against it on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import bench
import jax.numpy as jnp
from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.datagen import TableData
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.metrics import MULTIJOIN_DEGRADES
from trino_tpu.ops import pallas_hash as ph
from trino_tpu.sql.parser import parse as jax_parse
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch.catalog import Catalog, port_table
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import hashtable as ht
from trino_tpu_torch.sql.parser import parse

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

REASONS = ("kernel_off", "vmem", "dup", "escape", "dtype")
CRAFTED_SRC = 1 << 20        # row ids of the crafted keys (above any other)


# ---- the probe kernel on synthetic tables --------------------------------

def _home(keys, slots):
    return ht.hash_slot(torch.from_numpy(np.asarray(keys, np.int64)),
                        slots).numpy()


def _crafted_table(rng, n_keys, slots, key_base):
    """A valid linear-probing table: first a crafted run of 17 keys that
    all hash home to one slot h (16 colliders at h..h+15, then key X at
    h+16, which a probe can never reach within MAX_PROBES), then random
    keys inserted in order (a key whose chain would pass MAX_PROBES is
    left out). Returns (tkey, src, table keys, X, colliders)."""
    tkey = np.full(slots, ht.EMPTY_KEY, np.int64)
    src = np.zeros(slots, np.int64)
    cands = key_base + np.arange(1, 400_000, dtype=np.int64)
    homes = _home(cands, slots)
    h = int(homes[0])
    crafted = cands[homes == h][:ht.MAX_PROBES + 1]
    assert len(crafted) == ht.MAX_PROBES + 1
    for j, key in enumerate(crafted):
        tkey[(h + j) % slots] = key
        src[(h + j) % slots] = CRAFTED_SRC + j
    keys = key_base + 500_000 + rng.choice(1 << 20, n_keys, replace=False)
    placed = []
    for row, (key, home) in enumerate(zip(keys, _home(keys, slots))):
        for p in range(ht.MAX_PROBES):
            s = (int(home) + p) % slots
            if tkey[s] == ht.EMPTY_KEY:
                tkey[s] = key
                src[s] = row
                placed.append(key)
                break
    return tkey, src, np.array(placed), crafted[-1], crafted[:-1]


def _star_inputs(k=3, n=3000, slots=4096, seed=3):
    rng = np.random.default_rng(seed)
    tables, cols, valids = [], [], []
    for d in range(k):
        tkey, src, keys, x, colliders = _crafted_table(
            rng, 1200 + 300 * d, slots, key_base=d << 40)
        tables.append((tkey, src))
        pool = np.concatenate([keys, colliders, [x] * 40,
                               rng.integers(-(1 << 40), 1 << 40, 400)])
        col = rng.choice(pool, n)
        col[rng.random(n) < 0.01] = ht.EMPTY_KEY     # the sentinel key
        cols.append(col)
        valids.append(rng.random(n) > 0.05)          # NULL keys
    dead = rng.random(n) < 0.05
    return tables, cols, valids, dead


def test_multiway_probe_matches_reference():
    """found and miss bit-exact vs the interpreted TPU kernel: hits at
    every chain depth, misses, NULL and sentinel keys, dead rows, and an
    exhausted chain (key X present past MAX_PROBES)."""
    tables, cols, valids, dead = _star_inputs()
    k, n = len(tables), len(cols[0])
    jb = jax_batch(cols, valids=valids)
    jb = jb.with_live(jb.live & jnp.asarray(np.pad(~dead, (0, jb.capacity
                                                            - n))))
    tb = torch_batch(cols, valids=valids, device="cpu")
    tb = tb.with_live(tb.live & torch.from_numpy(
        np.pad(~dead, (0, tb.capacity - n))))
    tkey = np.stack([t[0] for t in tables])
    src = np.stack([t[1] for t in tables])
    lo, hi = ph._split64(jnp.asarray(tkey))
    probe_keys = tuple((d,) for d in range(k))
    jfound, jmiss = ph.multiway_probe(jb, lo, hi,
                                      jnp.asarray(src.astype(np.int32)),
                                      probe_keys, "interpret")
    found, miss = ht.multiway_probe(tb, torch.from_numpy(tkey),
                                    torch.from_numpy(src), probe_keys)
    assert found.dtype == torch.int32 and miss.dtype == torch.int64
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    assert np.array_equal(miss.numpy(), np.asarray(jmiss))
    # the craft did its job: some row probed X and missed on dim 0
    x = tables[0][0][tables[0][1] == CRAFTED_SRC + ht.MAX_PROBES][0]
    x_rows = (cols[0] == x) & valids[0] & ~dead
    assert x_rows.any() and (found[0, :n].numpy()[x_rows] == -1).all()
    # and the deepest collider (16th probe) hit
    deep = tables[0][0][tables[0][1] == CRAFTED_SRC + ht.MAX_PROBES - 1][0]
    deep_rows = (cols[0] == deep) & valids[0] & ~dead
    assert deep_rows.any() and (found[0, :n].numpy()[deep_rows] ==
                                CRAFTED_SRC + ht.MAX_PROBES - 1).all()


def _key_variant(cols, valids, variant):
    """The fact key columns of one dimension in the variant's form:
    `int32` (the keys fit), `int64`, or `two-column` (hi and lo halves
    that _combined_key packs back into the int64 key). Returns (columns,
    valids, probe key index tuple) relative to the column's slot."""
    if variant == "int32":
        return [cols.astype(np.int32)], [valids], 1
    if variant == "int64":
        return [cols], [valids], 1
    hi = cols >> 32
    lo = cols & 0xFFFFFFFF
    return [hi, lo], [valids, valids], 2


@pytest.mark.parametrize("variant", ["int32", "int64", "two-column"])
def test_multiway_probe_keys_in_matches_reference(variant):
    """The keys-in probe against the interpreted TPU kernel, bit-exact on
    `found` (int32) and `miss`, per key form: one int32 column, one int64
    column with EMPTY_KEY-valued keys, and a two-column key (dimension 1);
    NULL keys, dead rows and an exhausted chain throughout."""
    rng = np.random.default_rng(31)
    k, n, slots = 3, 2500, 4096
    base = (lambda d: d << 26) if variant == "int32" else \
        (lambda d: d << 40)
    tables, arrays, valids, probe_keys = [], [], [], []
    for d in range(k):
        tkey, src, keys, x, colliders = _crafted_table(
            rng, 900 + 200 * d, slots, key_base=base(d))
        tables.append((tkey, src))
        span = (1 << 31) - 1 if variant == "int32" else 1 << 40
        pool = np.concatenate([keys, colliders, [x] * 30,
                               rng.integers(-span, span, 300)])
        col = rng.choice(pool, n)
        if variant != "int32":
            col[rng.random(n) < 0.01] = ht.EMPTY_KEY
        cs, vs, width = _key_variant(col, rng.random(n) > 0.05,
                                     variant if d == 1 or
                                     variant != "two-column" else "int64")
        probe_keys.append(tuple(range(len(arrays), len(arrays) + width)))
        arrays.extend(cs)
        valids.extend(vs)
    dead = rng.random(n) < 0.05
    jb = jax_batch(arrays, valids=valids)
    jb = jb.with_live(jb.live & jnp.asarray(np.pad(~dead, (0, jb.capacity
                                                            - n))))
    tb = torch_batch(arrays, valids=valids, device="cpu")
    tb = tb.with_live(tb.live & torch.from_numpy(
        np.pad(~dead, (0, tb.capacity - n))))
    tkey = np.stack([t[0] for t in tables])
    src = np.stack([t[1] for t in tables])
    lo, hi = ph._split64(jnp.asarray(tkey))
    jfound, jmiss = ph.multiway_probe(jb, lo, hi,
                                      jnp.asarray(src.astype(np.int32)),
                                      tuple(probe_keys), "interpret")
    # the tables interleaved, as build_join_tables gives them
    pairs = torch.from_numpy(np.stack([tkey, src], -1))
    found, miss = ht.multiway_probe(tb, pairs[..., 0], pairs[..., 1],
                                    tuple(probe_keys))
    assert found.dtype == torch.int32
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    assert np.array_equal(miss.numpy(), np.asarray(jmiss))
    assert int(miss[0]) > 0 and int((found[-1] >= 0).sum()) > 0


def test_multiway_probe_short_circuit_and_dead_rows():
    """A row that misses dimension 0 is dead for dimension 1 (found -1,
    no second miss counted); dead rows count nowhere."""
    slots = 1024
    keys = np.array([11, 22, 33], np.int64)
    tkey = np.full((2, slots), ht.EMPTY_KEY, np.int64)
    src = np.zeros((2, slots), np.int64)
    for d in range(2):
        for r, key in enumerate(keys):
            s = int(_home([key], slots)[0])
            while tkey[d, s] != ht.EMPTY_KEY:
                s = (s + 1) % slots
            tkey[d, s], src[d, s] = key, r
    h = _home(keys, slots)
    slot = torch.tensor([[h[0], h[1], -1, -2], [h[2], h[2], h[2], -2]])
    key = torch.tensor([[11, 99, 0, 0], [33, 33, 33, 0]])
    found, miss = ht.multiway_probe_plain(slot, key, torch.from_numpy(tkey),
                                          torch.from_numpy(src))
    assert found.tolist() == [[0, -1, -1, -1], [2, -1, -1, -1]]
    assert miss.tolist() == [2, 0]


def test_resolve_multiway_mode_follows_the_setting():
    for v, want in (("auto", "on"), ("true", "on"), ("1", "on"),
                    ("false", "off"), ("0", "off")):
        assert ht.resolve_multiway_mode(v) == want


def test_multiway_table_bytes_is_the_reference_budget():
    for k, t in ((2, 1024), (5, 1 << 17)):
        assert ht.multiway_table_bytes(k, t) == \
            ph.multiway_table_bytes(k, t)
    assert ht.MAX_MULTI_DIMS == ph.MAX_MULTI_DIMS


# ---- synthetic star sessions, both engines -------------------------------

def _np_splitmix64(x):
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def default_star(k=3, fact_rows=1 << 12, dim_rows=256, hit_rate=0.7):
    return bench._star_tables(k, fact_rows, dim_rows, hit_rate)


def star_sql(k, agg=False):
    joins = " ".join(f"JOIN dim{i} ON f_d{i}key = d{i}_key"
                     for i in range(k))
    if agg:
        exprs = "".join(f" + d{i}_attr" for i in range(k))
        return f"SELECT sum(f_value{exprs}) FROM fact {joins}"
    cols = ", ".join(f"d{i}_attr" for i in range(k))
    return f"SELECT f_value, {cols} FROM fact {joins}"


def _sessions(tables, props=()):
    cat = JaxCatalog()
    cat.register("bench", bench.BenchConnector(tables, "star"))
    js = JaxSession(catalog=cat, default_cat="bench", default_schema="star")
    tcat = Catalog()
    tcat.register("bench", bench.BenchConnector(
        {name: port_table(t) for name, t in tables.items()}, "star"))
    ts = Session(tcat, default_cat="bench", default_schema="star",
                 device="cpu")
    for name, value in props:
        js.execute(f"SET SESSION {name} = '{value}'")
        ts.execute(f"SET SESSION {name} = '{value}'")
    return js, ts


def _jax_degrades():
    return {r: MULTIJOIN_DEGRADES.value(reason=r) for r in REASONS}


def _run_counted(js, ts, sql):
    """Run `sql` on both engines; returns (jax rows, port rows, jax
    degrade deltas, port degrade deltas)."""
    before_j = _jax_degrades()
    jrows = js.execute(sql).rows
    dj = {r: int(v - before_j[r]) for r, v in _jax_degrades().items()
          if v != before_j[r]}
    before_t = dict(ts.executor.stats.multijoin_degrade_reasons)
    trows = ts.execute(sql).rows
    dt = {r: v - before_t.get(r, 0) for r, v in
          ts.executor.stats.multijoin_degrade_reasons.items()
          if v != before_t.get(r, 0)}
    return jrows, trows, dj, dt


def _ladder_rows(ts, sql):
    ts.execute("SET SESSION enable_multiway_join = 'false'")
    try:
        return ts.execute(sql).rows
    finally:
        ts.execute("SET SESSION enable_multiway_join = 'true'")


ON = (("enable_multiway_join", "true"),)


def test_star_fused_equals_ladder_and_reference():
    js, ts = _sessions(default_star(k=3), ON)
    before = ts.executor.stats.multijoin_fused_probes
    jrows, trows, dj, dt = _run_counted(js, ts, star_sql(3))
    assert ts.executor.strategy_decisions["MultiJoinNode"] == \
        js.executor.strategy_decisions["MultiJoinNode"] == "multiway[k=3]"
    assert ts.executor.stats.multijoin_fused_probes == before + 1
    assert trows == jrows == _ladder_rows(ts, star_sql(3))
    assert dj == dt == {}


def test_partial_fuse_vmem_degrade():
    """The largest dim blows the pinned budget: it alone degrades
    (vmem), the other two fuse, rows equal the ladder's."""
    tables = default_star(k=3)
    rng = np.random.default_rng(5)
    tables["dim2"] = TableData(
        "dim2", tables["dim2"].schema,
        [np.arange(2048, dtype=np.int64),
         rng.integers(0, 1000, 2048).astype(np.int64)],
        primary_key=("d2_key",))
    js, ts = _sessions(tables, ON + (("multiway_vmem_kb", "56"),))
    jrows, trows, dj, dt = _run_counted(js, ts, star_sql(3))
    assert ts.executor.strategy_decisions["MultiJoinNode"] == \
        js.executor.strategy_decisions["MultiJoinNode"] == "multiway[k=2]"
    assert dt == dj == {"vmem": 1}
    assert trows == jrows == _ladder_rows(ts, star_sql(3))


def test_vmem_full_ladder_degrade():
    js, ts = _sessions(default_star(k=3), ON + (("multiway_vmem_kb", "8"),))
    jrows, trows, dj, dt = _run_counted(js, ts, star_sql(3))
    assert ts.executor.strategy_decisions["MultiJoinNode"] == \
        js.executor.strategy_decisions["MultiJoinNode"] == "ladder"
    assert dt == dj == {"vmem": 3}
    assert trows == jrows == _ladder_rows(ts, star_sql(3))


def test_kernel_off_counts_degrades():
    """Plan with the kernel on, then flip the executor's knob off under
    the planned MultiJoinNode: the wholesale kernel_off degrade."""
    js, ts = _sessions(default_star(k=3), ON)
    ref = ts.execute(star_sql(3)).rows
    jrel = js.planner().plan_query(jax_parse(star_sql(3)))
    trel = ts.planner().plan_query(parse(star_sql(3)))
    before_j = _jax_degrades()
    before_t = dict(ts.executor.stats.multijoin_degrade_reasons)
    js.executor.enable_multiway_join = "false"
    ts.executor.enable_multiway_join = "false"
    js.executor.execute(jrel.node)
    out = ts.executor.execute(trel.node)
    dj = {r: int(v - before_j[r]) for r, v in _jax_degrades().items()
          if v != before_j[r]}
    dt = {r: v - before_t.get(r, 0) for r, v in
          ts.executor.stats.multijoin_degrade_reasons.items()
          if v != before_t.get(r, 0)}
    assert dt == dj == {"kernel_off": 3}
    assert int(out.live.sum()) == len(ref)


def test_dup_dim_degrades_bitexact():
    tables = default_star(k=3, hit_rate=0.9)
    dup = tables["dim1"]
    keys = np.asarray(dup.columns[0]).copy()
    keys[1::2] = keys[0::2]                      # every key twice
    tables["dim1"] = TableData("dim1", dup.schema,
                               [keys, np.asarray(dup.columns[1])],
                               primary_key=("d1_key",))
    js, ts = _sessions(tables, ON)
    jrows, trows, dj, dt = _run_counted(js, ts, star_sql(3))
    assert dt == dj == {"dup": 1}
    assert trows == jrows == _ladder_rows(ts, star_sql(3))


def test_escape_dim_degrades_bitexact():
    """More than MAX_PROBES dim keys share one home slot of the shared
    table: the build escapes, that dim degrades (escape)."""
    slots, fits = ht.join_table_slots(1024)
    assert fits
    cands = np.arange(1, 500_000, dtype=np.int64)
    home = (_np_splitmix64(cands.view(np.uint64) + ph._SLOT_SEED)
            % np.uint64(slots)).astype(np.int64)
    colliders = cands[home == home[0]][:ht.MAX_PROBES + 4]
    assert len(colliders) == ht.MAX_PROBES + 4
    tables = default_star(k=3, dim_rows=64, hit_rate=0.9)
    esc = tables["dim2"]
    rng = np.random.default_rng(7)
    tables["dim2"] = TableData(
        "dim2", esc.schema,
        [colliders, rng.integers(0, 1000, len(colliders)).astype(np.int64)],
        primary_key=("d2_key",))
    fact = tables["fact"]
    fcols = [np.asarray(c) for c in fact.columns]
    fcols[2] = rng.choice(colliders, len(fcols[2]))
    tables["fact"] = TableData("fact", fact.schema, fcols)
    js, ts = _sessions(tables, ON)
    jrows, trows, dj, dt = _run_counted(js, ts, star_sql(3))
    assert dt == dj == {"escape": 1}
    assert trows == jrows == _ladder_rows(ts, star_sql(3))


def test_mis_sized_fact_stays_probe():
    js, ts = _sessions(default_star(k=3, fact_rows=64, dim_rows=512,
                                    hit_rate=0.9), ON)
    jrows, trows, _dj, _dt = _run_counted(js, ts, star_sql(3))
    assert trows == jrows == _ladder_rows(ts, star_sql(3))


@pytest.mark.parametrize("props,k", [((), 3),
                                     ((("multiway_max_dims", "2"),), 2)])
def test_explain_star_lines_equal_reference(props, k):
    """EXPLAIN's plan text and strategy lines equal the reference's, with
    the kernel on and with it off (the star verdict either way)."""
    js, ts = _sessions(default_star(k=3), ON + props)

    def lines(s):
        return [r[0] for r in s.execute("EXPLAIN " + star_sql(3)).rows]
    on = lines(ts)
    assert on == lines(js)
    assert f"join strategy: multiway[k={k}]" in on
    assert any(f"MultiJoin[star, k={k}" in ln for ln in on)
    js.execute("SET SESSION enable_multiway_join = 'false'")
    ts.execute("SET SESSION enable_multiway_join = 'false'")
    off = lines(ts)
    assert off == lines(js)
    assert not any(ln.lstrip().startswith("MultiJoin") for ln in off)
    assert any(ln.startswith("multiway star: fusable") for ln in off)


def test_explain_analyze_ran_divergence():
    _, ts = _sessions(default_star(k=3), ON + (("multiway_vmem_kb", "8"),))
    text = "\n".join(r[0] for r in ts.execute(
        "EXPLAIN ANALYZE " + star_sql(3)).rows)
    assert "join strategy: multiway[k=3] [ran: ladder]" in text


def test_explain_declined_star():
    _, ts = _sessions(default_star(k=2), ON)
    sql = ("SELECT f_value FROM fact JOIN dim0 ON f_d0key = d0_key "
           "LEFT JOIN dim1 ON f_d1key = d1_key")
    text = "\n".join(r[0] for r in ts.execute("EXPLAIN " + sql).rows)
    assert "MultiJoin" not in text
    assert "multiway star: declined" in text


def test_star_aggregate_fused_equals_reference():
    js, ts = _sessions(default_star(k=3, hit_rate=0.9), ON)
    jrows, trows, dj, dt = _run_counted(js, ts, star_sql(3, agg=True))
    assert trows == jrows == _ladder_rows(ts, star_sql(3, agg=True))
    assert dj == dt == {}


# ---- q5: the TPU's star decision on the CPU --------------------------------

def _plan_shape(node, logical):
    """Pre-order (node type, join keys) of a plan."""
    out = []

    def walk(n):
        if isinstance(n, logical.JoinNode):
            out.append(("JoinNode", tuple(n.left_keys),
                        tuple(n.right_keys)))
        elif isinstance(n, logical.MultiJoinNode):
            out.append(("MultiJoinNode", tuple(map(tuple, n.fact_keys)),
                        tuple(map(tuple, n.dim_keys))))
        else:
            out.append((type(n).__name__,))
        for c in logical.children(n):
            walk(c)
    walk(node)
    return out


@pytest.mark.parametrize("setting", ["auto", "true", "false"])
def test_q5_plan_models_the_tpu_star_decision(setting):
    """The port plans TPC-H q5's spine as a MultiJoinNode under `auto` on
    the CPU, where the reference's CPU planner keeps pairwise JoinNodes:
    `auto` resolves K4 on in the port on every device, as the reference
    does on a TPU. The port's `auto` plan is the reference's plan under
    `true`; under `false` both keep every inner join single-key (the
    reference's test_q5_joins_stay_single_key_dense)."""
    from test_optimizer_reorder import Q5
    from trino_tpu.planner import logical as JL
    from trino_tpu_torch.planner import logical as TL
    ts = Session(default_schema="tiny", device="cpu")
    js = JaxSession(default_schema="tiny")
    ts.execute(f"SET SESSION enable_multiway_join = '{setting}'")
    # the reference's TPU decision, asked for on the CPU
    ref_setting = "true" if setting == "auto" else setting
    js.execute(f"SET SESSION enable_multiway_join = '{ref_setting}'")
    ours = _plan_shape(ts.planner().plan_query(parse(Q5)).node, TL)
    ref = _plan_shape(js.planner().plan_query(jax_parse(Q5)).node, JL)
    assert ours == ref
    stars = [n for n in ours if n[0] == "MultiJoinNode"]
    if setting == "false":
        assert not stars
        joins = [n for n in ours if n[0] == "JoinNode"]
        assert len(joins) >= 4 and all(len(j[1]) == 1 for j in joins)
    else:
        assert len(stars) == 1
    if setting == "auto":
        js.execute("SET SESSION enable_multiway_join = 'auto'")
        cpu_ref = _plan_shape(js.planner().plan_query(jax_parse(Q5)).node,
                              JL)
        assert not [n for n in cpu_ref if n[0] == "MultiJoinNode"]
