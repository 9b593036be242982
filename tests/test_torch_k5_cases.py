"""K5's grid of cases, shared by the CPU tests of its plain version
(tests/test_torch_direct_agg.py) and its card tests
(tests/test_torch_cuda.py), and the bit-exact comparison of two result
batches. Imports neither jax nor the reference package, so the card
tests can use it without them."""

import numpy as np
import torch

# K5's grid of cases: (rows, key dtypes, key domains, aggregates). Rows
# need not be a multiple of any block; "dead" marks every row dead.
# Value columns: 0-7 int64 near +-2^58, 8 int32, 9 int16, 10 uint8.
K5_AGGS = {
    "q12": (("sum", 8), ("sum", 9)),
    "counts": (("count_star", None), ("count", 0)),
    "mixed": (("sum", 0), ("count", 0), ("sum", 8), ("count_star", None),
              ("count", 9), ("sum", 9), ("sum", 10)),
    "eight sums": tuple(("sum", c) for c in range(8)),
}
K5_CASES = [
    (20_000, ("int32",), (7,), "q12"),
    (20_000, ("int8",), (16,), "counts"),
    (5_003, ("int16", "int64"), (4, 4), "mixed"),
    (5_003, ("int64",), (1,), "eight sums"),
    (5_003, ("int8", "int32", "int16"), (2, 4, 2), "eight sums"),
    (5_003, ("int64", "int8"), (7, 1), "mixed"),
    (1_024, ("int16", "int8", "int64"), (1, 7, 1), "dead"),
    (20_000, ("int32", "int64"), (4, 4), "q12"),
    (20_000, ("int16",), (16,), "eight sums"),
    (5_003, ("int8", "int8", "int8"), (1, 1, 1), "mixed"),
    (5_003, ("int32",), (4,), "counts"),
    (0, ("int64",), (7,), "q12"),
]


def k5_case_id(case):
    n, dtypes, domains, aggs = case
    return f"{n}-{'+'.join(dtypes)}-G{int(np.prod(domains))}-{aggs}"


def k5_case(case, seed):
    """Numpy inputs of a K5 case: (arrays, valids, live, key indices,
    domains, aggregates as (func, column)). Keys are drawn past their
    domain on both sides (the kernel clamps) and an int64 key carries
    high bits that its cast to int32 drops; about 5% of keys and 10% of
    values are NULL and 5% of rows dead."""
    n, dtypes, domains, agg_set = case
    rng = np.random.default_rng(seed)
    values = [rng.integers(-(1 << 58), 1 << 58, n) for _ in range(8)]
    values += [rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
               rng.integers(-(1 << 15), 1 << 15, n).astype(np.int16),
               rng.integers(0, 256, n).astype(np.uint8)]
    keys = []
    for dt, d in zip(dtypes, domains):
        k = rng.integers(-2, d + 2, n)
        if dt == "int64":
            k = k + (rng.integers(0, 2, n) << 32)
        keys.append(k.astype(dt))
    arrays = values + keys
    valids = [rng.random(n) >= 0.1 for _ in values] + \
        [rng.random(n) >= 0.05 for _ in keys]
    live = rng.random(n) >= 0.05
    if agg_set == "dead":
        live[:] = False
        agg_set = "mixed"
    key_indices = tuple(range(len(values), len(arrays)))
    return arrays, valids, live, key_indices, tuple(domains), \
        K5_AGGS[agg_set]


def same_batch(x, y) -> bool:
    """Every column's data and validity and the live mask equal, bit for
    bit and dtype for dtype, over all groups."""
    return torch.equal(x.live, y.live) and len(x.columns) == \
        len(y.columns) and all(
            a.data.dtype == b.data.dtype and torch.equal(a.data, b.data)
            and torch.equal(a.valid, b.valid)
            for a, b in zip(x.columns, y.columns))
