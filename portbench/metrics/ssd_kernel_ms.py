"""Device ms a request of the SSD scan's launches (``ssd_*``)."""
from portbench.classes import ms_per_request


def read(ctx):
    return ms_per_request(ctx, "ssd")
