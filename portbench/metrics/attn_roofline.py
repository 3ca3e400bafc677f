"""The attention's least time a request, from the benchmark's own count of
its FLOPs and bytes (the ``attention`` part of the reference's ``work``),
over the attention kernels' device time, in %."""
from portbench.classes import ms_per_request


def read(ctx):
    ms = ms_per_request(ctx, "attention")
    least = ctx["least_s"].get("attention")
    return 100 * least * 1e3 / ms if ms and least else None
