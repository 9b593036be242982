"""K1's launch plan (trino_tpu_torch/ops/gather.py `plan_gather`): how a
call's tables split into launches of at most MAX_TABLES, and which
launches take big tiles (a table of W * itemsize within L1_BYTES). The
plan is a pure function of the element sizes and W, so it is checked here
on the CPU; the kernel that follows it runs on a card
(tests/test_torch_cuda.py)."""

import pytest

from trino_tpu_torch.ops import gather as k1

STAR = [8, 8, 4, 4, 4, 8, 4, 1, 4, 4, 2, 4, 8, 4, 4, 8, 4, 4]


def _check_plan(plans, esizes, width):
    """Invariants every plan keeps."""
    flat = [p for plan in plans for p in plan.tables]
    assert flat == list(range(len(esizes)))
    for plan in plans:
        assert 1 <= len(plan.tables) <= k1.MAX_TABLES
        assert plan.big_tile == any(
            0 < width * esizes[p] <= k1.L1_BYTES for p in plan.tables)


def test_star_and_lut_probe():
    """The star's payload gather is one launch in big tiles, q3's
    dense-LUT probe one in small tiles; an empty table takes small
    tiles."""
    (plan,) = k1.plan_gather(STAR, 18_432)
    assert plan.big_tile and plan.tables == tuple(range(18))
    _check_plan([plan], STAR, 18_432)
    (plan,) = k1.plan_gather([4], 8_388_609)
    assert not plan.big_tile
    (plan,) = k1.plan_gather([8], 0)
    assert not plan.big_tile


@pytest.mark.parametrize("width", [18_432, 8_388_609])
@pytest.mark.parametrize("ntab,launches", [(1, 1), (16, 1), (17, 1),
                                           (18, 1), (64, 1), (65, 2),
                                           (128, 2), (130, 3)])
def test_tables_split_into_launches(ntab, launches, width):
    """Launches of MAX_TABLES tables in order, the last holding the rest,
    with tables that fit L1 (big tiles) and with tables past it."""
    esizes = [8, 4, 2, 1] * (ntab // 4) + [8] * (ntab % 4)
    plans = k1.plan_gather(esizes, width)
    assert len(plans) == launches
    assert [len(p.tables) for p in plans[:-1]] == \
        [k1.MAX_TABLES] * (launches - 1)
    assert all(p.big_tile == (width == 18_432) for p in plans)
    _check_plan(plans, esizes, width)


@pytest.mark.parametrize("esize", [1, 2, 4, 8])
@pytest.mark.parametrize("delta,big", [(-1, True), (0, True), (1, False)])
def test_big_tile_boundary(esize, delta, big):
    """W one row below, exactly at and one row past L1_BYTES."""
    width = k1.L1_BYTES // esize + delta
    assert (width * esize <= k1.L1_BYTES) == big
    plans = k1.plan_gather([esize], width)
    assert plans[0].big_tile == big
    _check_plan(plans, [esize], width)


def test_mixed_sizes_across_the_boundary():
    """One launch holding tables on both sides of L1_BYTES takes big
    tiles; a later launch whose tables are all past it does not."""
    width = k1.L1_BYTES // 4          # int32 exactly at it, int64 past it
    esizes = [8] * k1.MAX_TABLES + [1, 8, 4] + [8] * k1.MAX_TABLES
    plans = k1.plan_gather(esizes, width)
    assert [p.big_tile for p in plans] == [False, True, False]
    _check_plan(plans, esizes, width)


def test_plan_is_deterministic():
    assert k1.plan_gather([8, 4], 18_432) == \
        k1.plan_gather((8, 4), 18_432)
    assert k1.plan_gather(STAR, 18_432) is k1.plan_gather(STAR, 18_432)
