"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names each cell's configuration and traffic, its end-to-end
metrics and its per-layer metrics; ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``workloads/<cell>.json`` (the limits of
the cell's ``correct``) hold the rest, ``kinds/<kind>.py`` serves and
checks a traffic's request kind, and ``metrics/<metric>.py`` reads a
per-layer metric. Adding a cell, a configuration, a request kind or a
metric adds files and entries; no file that is there changes.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == _name(name)]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    here = root / HERE.name
    config = load(here / "configs" / f"{_name(w['config'])}.json")
    traffic = load(here / "traffic" / f"{_name(w['traffic'])}.json")
    limits = load(here / "workloads" / f"{name}.json")["limits"]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                root=root)


def _module(folder: str, name: str, root: Path):
    """The module ``<folder>/<name>.py`` of the benchmark under ``root``."""
    import importlib.util

    path = root / HERE.name / folder / f"{_name(name)}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric, root).read


def kind(name: str, root: Path = ROOT):
    """The request kind ``kinds/<name>.py``: its ``Entry(model, params)``
    (one request a call, returning the record the check reads),
    ``head_positions(seq)``, ``SAMPLE``, ``numbers`` and
    ``control_record``."""
    return _module("kinds", name, root)
