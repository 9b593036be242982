"""The port's Batch helpers against the reference's (trino_tpu/batch.py):
`num_columns`, `column` and `select_columns` on the same seeded numpy
columns."""

import numpy as np
import torch

from trino_tpu.batch import batch_from_numpy as j_batch
from trino_tpu_torch.batch import batch_from_numpy as t_batch

torch.set_num_threads(1)


def test_column_helpers_equal_reference():
    rng = np.random.default_rng(20)
    cols = [rng.integers(-9, 9, 700).astype(np.int32),
            rng.normal(size=700), rng.integers(0, 2, 700).astype(bool),
            rng.integers(-(1 << 40), 1 << 40, 700)]
    valids = [rng.random(700) > 0.1 for _ in cols]
    jb = j_batch(cols, valids=valids)
    tb = t_batch(cols, valids=valids, device="cpu")
    assert tb.num_columns == jb.num_columns == 4
    for i in range(4):
        jc, tc = jb.column(i), tb.column(i)
        assert tc is tb.columns[i]
        assert np.array_equal(np.asarray(jc.data), tc.data.numpy())
        assert np.array_equal(np.asarray(jc.valid), tc.valid.numpy())
    for idx in ([3, 0], [1], [], [2, 2, 1]):
        js, ts = jb.select_columns(idx), tb.select_columns(idx)
        assert ts.num_columns == js.num_columns == len(idx)
        assert ts.live is tb.live
        for jc, tc in zip(js.columns, ts.columns):
            assert np.array_equal(np.asarray(jc.data), tc.data.numpy())
            assert np.array_equal(np.asarray(jc.valid), tc.valid.numpy())
