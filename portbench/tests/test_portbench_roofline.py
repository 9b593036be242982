"""The kernels' byte counts on shapes worked by hand, and the trace's
names of the kernels."""

import torch

from portbench import roofline


def test_k1_bytes():
    idx = torch.zeros(1000, dtype=torch.int32)
    tables = [torch.zeros(64, dtype=torch.int64),
              torch.zeros(64, dtype=torch.int32)]
    # 4,000 B of indices; 512 + 256 B of tables; 8,000 + 4,000 B out
    assert roofline.k1_bytes(tables, idx) == 4000 + 512 + 256 + 12000


def test_k3_bytes():
    key = torch.zeros(100, dtype=torch.int64)
    mask = torch.zeros(100, dtype=torch.bool)
    val = torch.zeros(100, dtype=torch.int64)
    ok = torch.zeros(100, dtype=torch.bool)
    # 800 + 100 B in, 800 + 100 B of one aggregate, and 2 tables of 16
    # slots of (1 key + 2 states) words
    assert roofline.k3_bytes(key, mask, None, [(val, ok), (None, None)], 2,
                             16, 2, False) == 900 + 900 + 8 * 2 * 16 * 3
    assert roofline.k3_bytes(key, mask, None, [], 1, 16, 1, True) == \
        900 + 8 * 16 * 4


def test_kernel_names():
    k = roofline.kernel_of
    assert k("void gather_kernel<long, 8>(long const*, long, long, "
             "K1Args)") == "K1"
    assert k("void window_gather_kernel<long>(...)") == "K2"
    assert k("insert_kernel(long long const*, ...)") == "K3"
    assert k("epilogue_kernel(unsigned long long*, ...)") == "K3"
    assert k("multiprobe_kernel(unsigned char const*, Dims, ...)") == "K4"
    assert k("void at::native::vectorized_elementwise_kernel<4, ...>") \
        is None
