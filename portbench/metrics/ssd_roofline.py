"""The SSD scan's least time a request, from the benchmark's own count of
its FLOPs and bytes (the ``ssd`` part of the reference's ``work``), over
the SSD kernels' device time, in %."""
from portbench.classes import ms_per_request


def read(ctx):
    ms = ms_per_request(ctx, "ssd")
    least = ctx["least_s"].get("ssd")
    return 100 * least * 1e3 / ms if ms and least else None
