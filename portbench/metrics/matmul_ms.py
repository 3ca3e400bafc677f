"""Device ms a request of the matrix products (cuBLAS: gemm, nvjet, xmma,
cutlass kernels)."""
from portbench.classes import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "matmul")
