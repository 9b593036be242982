"""kernels.k3_roofline: the least time of K3's launches in the window
(their bytes, roofline.k3_bytes, over the HBM peak) over their device
time in the trace, in %. Nothing when K3 did not launch."""

from portbench.roofline import PEAK_HBM_BYTES_S


def read(r):
    s = r.kernel_s.get("K3", 0.0)
    b = r.kernel_bytes.get("K3", 0)
    if s <= 0 or b <= 0:
        return None
    return 100.0 * (b / PEAK_HBM_BYTES_S) / s
