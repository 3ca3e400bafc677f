"""Device operations by kind, by name, as the port's profiler split has
them (``launch/profile_serve.py``), and the per-request device time of a
kind in a traced window."""
from __future__ import annotations

ATTENTION = ("flash",)  # flash_kernel_bf16_tc, or any flash-attention kernel
SSD = ("ssd_",)  # ssd_cum, ssd_cb, ssd_state, ssd_pass, ssd_out kernels
MATMUL = ("gemm", "nvjet", "xmma", "cutlass")  # cuBLAS's products


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, parts in (("attention", ATTENTION), ("ssd", SSD),
                        ("matmul", MATMUL)):
        if any(p in low for p in parts):
            return kind
    return "other"


def ms_per_request(ctx: dict, kind: str) -> float | None:
    """Device ms a request of the operations of ``kind`` (``all`` for
    every one), or None without a traced request or any such operation."""
    trace = ctx.get("trace")
    if not trace or not trace["requests"]:
        return None
    secs = sum(s for n, s in trace["by_name"].items()
               if kind == "all" or kind_of(n) == kind)
    return secs * 1e3 / trace["requests"] if secs > 0 else None
