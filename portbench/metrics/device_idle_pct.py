"""The share of the traced window in which no device operation ran, in %."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100 * (1 - trace["busy_s"] / trace["window_s"])
