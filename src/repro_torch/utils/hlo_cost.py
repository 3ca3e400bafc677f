"""Trip-count-aware cost extraction from compiled HLO text.

XLA's ``compiled.cost_analysis()`` counts each while-loop body ONCE, so for
scan-over-layers models it undercounts FLOPs/bytes/collectives by ~n_layers
(verified: a 2-layer and an 8-layer scanned MLP report identical flops).
This module re-derives costs by walking the HLO computation graph:

  * computations are parsed into scopes; ``while`` instructions multiply
    their body's cost by the trip count recovered from the loop condition
    (the ``compare(iter, constant)`` pattern XLA emits for lax.scan);
  * ``fusion``/``call``/``conditional`` recurse into their callees
    (conditional branches are summed — upper bound, documented);
  * dot FLOPs = 2 x result_elements x contraction_size per dot;
  * collective bytes = operand payloads of all-gather / all-reduce /
    reduce-scatter / all-to-all / collective-permute;
  * dot operand bytes give a lower-bound memory-traffic term (fusion makes
    exact HBM bytes unknowable from text; the roofline memory term instead
    uses the analytic model in repro.launch.roofline).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COMP_NAME = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^\s]*)\s+"
    r"([\w\-]+)\((.*)$")
_CALLED = re.compile(r"(?:body|condition|to_apply|calls|branch_computations)="
                     r"\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?")
_CONST = re.compile(r"constant\((\d+)\)")
_CONTRACT = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def _parse_shape(s: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(s):
        if dt in _DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _shape_bytes(s: str) -> int:
    total = 0
    for dt, dims in _parse_shape(s):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


def _elems(dims: List[int]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


@dataclass
class Instr:
    name: str
    shape_str: str
    op: str
    rest: str
    callees: List[str] = field(default_factory=list)


@dataclass
class Computation:
    name: str
    instrs: List[Instr] = field(default_factory=list)
    constants: Dict[str, int] = field(default_factory=dict)
    shapes: Dict[str, str] = field(default_factory=dict)  # instr name -> shape


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


_HEADER_START = re.compile(r"^\s*(?:ENTRY\s+)?%[\w.\-]+ \(")


def parse_computations(hlo: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    entry: List[str] = []
    header_buf: Optional[List[str]] = None
    for line in hlo.splitlines():
        stripped = line.rstrip()
        # computation headers ("name (params...) -> result {") may wrap
        # across lines when tuple parameter lists are long — accumulate.
        if header_buf is not None:
            header_buf.append(stripped)
            if stripped.endswith("{"):
                joined = " ".join(header_buf)
                header_buf = None
                m = _COMP_NAME.match(joined)
                if m and "->" in joined:
                    cur = Computation(m.group(1))
                    comps[cur.name] = cur
                    if joined.lstrip().startswith("ENTRY"):
                        entry.append(cur.name)
            continue
        if cur is None and _HEADER_START.match(stripped) and " = " not in stripped:
            if stripped.endswith("{") and "->" in stripped:
                m = _COMP_NAME.match(stripped)
                if m:
                    cur = Computation(m.group(1))
                    comps[cur.name] = cur
                    if stripped.lstrip().startswith("ENTRY"):
                        entry.append(cur.name)
            else:
                header_buf = [stripped]
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        mi = _INSTR.match(line)
        if not mi:
            continue
        name, shape_str, op, rest = mi.groups()
        callees: List[str] = []
        for mc in _CALLED.finditer(rest):
            for nm in mc.group(1).split(","):
                callees.append(nm.strip().lstrip("%"))
        ins = Instr(name, shape_str, op, rest, callees)
        cur.instrs.append(ins)
        cur.shapes[name] = shape_str
        mk = _CONST.search(rest) if op == "constant" else None
        if mk:
            cur.constants[name] = int(mk.group(1))
    comps["__entry__"] = comps.get(entry[0]) if entry else None
    return comps


def _trip_count(comps: Dict[str, Computation], ins: Instr,
                cond_name: Optional[str]) -> int:
    """Trip count: XLA annotates lax.scan whiles with known_trip_count in
    backend_config; fall back to the condition's compare constant."""
    m = _TRIP.search(ins.rest)
    if m:
        return int(m.group(1))
    cond = comps.get(cond_name) if cond_name else None
    if cond is None:
        return 1
    consts = list(cond.constants.values())
    for i in cond.instrs:
        if i.op == "compare" and consts:
            return max(consts)
    return max(consts) if consts else 1


def _operand_entries(ins: Instr) -> List[str]:
    """Raw operand texts from 'dot(f32[64,32]{1,0} %a, ...), attrs' — up to
    the closing paren. Commas inside shape brackets ([64,32]) or layout
    braces ({1,0}) are NOT operand separators, so bracket/brace depth is
    tracked alongside paren depth."""
    depth, nest, out, cur = 1, 0, [], []
    for ch in ins.rest:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                break
        elif ch in "{[":
            nest += 1
        elif ch in "}]":
            nest -= 1
        if ch == "," and depth == 1 and nest == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return [o for o in out if o]


def _operand_shape(comp: Computation, entry: str) -> str:
    """Shape text of one operand: prefer the defining instruction's recorded
    shape; fall back to the shape annotation inlined in the operand itself."""
    name = entry.split()[-1].lstrip("%")
    return comp.shapes.get(name) or entry


def _dot_flops(ins: Instr, comp: Computation) -> float:
    shapes = _parse_shape(ins.shape_str)
    if not shapes:
        return 0.0
    result_elems = sum(_elems(dims) for _, dims in shapes)
    mc = _CONTRACT.search(ins.rest)
    entries = _operand_entries(ins)
    if not mc or not entries:
        return 0.0
    lhs = _parse_shape(_operand_shape(comp, entries[0]))
    if not lhs:
        return 0.0
    lhs_dims = lhs[0][1]
    csize = 1
    for d in mc.group(1).split(","):
        if d and int(d) < len(lhs_dims):
            csize *= lhs_dims[int(d)]
    return 2.0 * result_elems * csize


def _dot_bytes(ins: Instr, comp: Computation) -> int:
    total = _shape_bytes(ins.shape_str)
    for entry in _operand_entries(ins):
        total += _shape_bytes(_operand_shape(comp, entry))
    return total


@dataclass
class Cost:
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.dot_flops += other.dot_flops * mult
        self.dot_bytes += other.dot_bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.collectives.items():
            slot = self.collectives.setdefault(k, {"count": 0.0, "bytes": 0.0})
            slot["count"] += v["count"] * mult
            slot["bytes"] += v["bytes"] * mult


def _comp_cost(comps: Dict[str, Computation], name: str,
               memo: Dict[str, Cost]) -> Cost:
    if name in memo:
        return memo[name]
    memo[name] = Cost()  # cycle guard
    comp = comps.get(name)
    if comp is None:
        return memo[name]
    total = Cost()
    for ins in comp.instrs:
        if ins.op == "dot":
            total.dot_flops += _dot_flops(ins, comp)
            total.dot_bytes += _dot_bytes(ins, comp)
        elif any(ins.op.startswith(c) for c in _COLLECTIVES):
            if ins.op.endswith("-done"):
                continue
            base = next(c for c in _COLLECTIVES if ins.op.startswith(c))
            nbytes = _shape_bytes(ins.shape_str)
            total.collective_bytes += nbytes
            slot = total.collectives.setdefault(
                base, {"count": 0.0, "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += nbytes
        if ins.op == "while":
            mb = re.search(r"body=%?([\w.\-]+)", ins.rest)
            mc = re.search(r"condition=%?([\w.\-]+)", ins.rest)
            if mb:
                trips = _trip_count(comps, ins, mc.group(1) if mc else None)
                total.add(_comp_cost(comps, mb.group(1), memo),
                          mult=max(trips, 1))
        elif ins.op in ("fusion", "call", "conditional", "map", "reduce",
                        "reduce-window", "sort", "scatter", "custom-call",
                        "select-and-scatter", "all-reduce", "reduce-scatter"):
            for callee in ins.callees:
                # conditional: sum over branches (upper bound)
                total.add(_comp_cost(comps, callee, memo), mult=1.0)
    memo[name] = total
    return total


def hlo_cost(hlo: str) -> Cost:
    comps = parse_computations(hlo)
    entry_comp = comps.pop("__entry__", None)
    if entry_comp is not None:
        entry = entry_comp.name
    elif comps:
        entry = max(comps, key=lambda n: len(comps[n].instrs))
    else:
        return Cost()
    return _comp_cost(comps, entry, {})
