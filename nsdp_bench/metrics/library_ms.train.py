"""Device time per train step of every kernel that is none of the program's
own (``nsdp_bench/kernels``): cuBLAS, PyTorch's elementwise, BatchNorm and
reduction kernels."""


def read(o):
    if o.slice is None:
        return None
    return 1e3 * o.slice.library_s / o.slice.requests
