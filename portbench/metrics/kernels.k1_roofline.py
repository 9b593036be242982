"""kernels.k1_roofline: the least time of K1's launches in the window
(their bytes, roofline.k1_bytes, over the HBM peak) over their device
time in the trace, in %. Nothing when K1 did not launch."""

from portbench.roofline import PEAK_HBM_BYTES_S


def read(r):
    s = r.kernel_s.get("K1", 0.0)
    b = r.kernel_bytes.get("K1", 0)
    if s <= 0 or b <= 0:
        return None
    return 100.0 * (b / PEAK_HBM_BYTES_S) / s
