"""Device ms a request of every other device operation: elementwise passes,
norms, copies, fills and the mixer's gating."""
from portbench.classes import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "other")
