"""Extract collective-communication byte counts from lowered/compiled HLO text.

``compiled.cost_analysis()`` reports FLOPs and HBM bytes but not collective
traffic, so the roofline collective term is derived here: we scan the HLO for
``all-gather`` / ``all-reduce`` / ``reduce-scatter`` / ``all-to-all`` /
``collective-permute`` ops and sum their operand sizes.

The parser is intentionally conservative: it reads the *result* shape of each
collective instruction (for all-reduce/all-gather this equals the payload a
device sends/receives up to a small ring factor; we report raw payload bytes
and let the roofline model apply the ring multiplier).
"""
from __future__ import annotations

import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1,
    "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# e.g.  "bf16[8,128,4096]{2,1,0}"  or "f32[]"
_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")

_COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# matches an HLO instruction line:  "%name = TYPE[SHAPE] op-name(...)"
_INSTR_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\][^\s]*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        nbytes = _DTYPE_BYTES.get(dtype)
        if nbytes is None:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * nbytes
    return total


def collective_breakdown(hlo_text: str) -> dict:
    """Return {op_kind: {"count": int, "bytes": int}} summed over the module.

    ``-done`` variants are skipped (their payload was counted at ``-start``).
    """
    out: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if m is None:
            continue
        if "-done(" in line:
            continue  # async completion: payload counted at -start
        shape_str, kind = m.group(1), m.group(2)
        out[kind]["count"] += 1
        out[kind]["bytes"] += _shape_bytes(shape_str)
    return dict(out)


def collective_bytes_from_hlo(hlo_text: str) -> int:
    return sum(v["bytes"] for v in collective_breakdown(hlo_text).values())
