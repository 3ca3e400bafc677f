"""Device ms a request of the attention kernels (the flash kernel)."""
from portbench.classes import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "attention")
