"""The whole request's share of the card's bf16 peak over the traced
window: model FLOPs of the requests traced, over the window and the peak,
in %."""
from portbench.counts import PEAK_BF16_FLOPS


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["requests"] or trace["busy_s"] <= 0:
        return None
    flops = ctx["flops"]["total"] * trace["requests"]
    return 100 * flops / trace["window_s"] / PEAK_BF16_FLOPS
