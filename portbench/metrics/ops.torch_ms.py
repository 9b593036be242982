"""ops.torch_ms: device ms per answered query in kernels that are not
built from the program's csrc/ (torch's elementwise, reduction, sort and
scan kernels), from the trace."""


def read(r):
    if not r.answered or r.torch_kernel_s <= 0:
        return None
    return 1000.0 * r.torch_kernel_s / r.answered
