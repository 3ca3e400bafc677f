"""The system under test: the PyTorch/CUDA port ``repro_torch`` in
``src/`` beside this folder, built from a configuration; a request kind
(``kinds/<kind>.py``) drives it through one of its serving entries. The
benchmark takes from it only the model it serves, its outputs and its
kernels' launch counters.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PACKAGE = "repro_torch"


def import_port():
    """``repro_torch`` from ``src/`` of this checkout; raises when it is
    not there."""
    if not (SRC / PACKAGE / "__init__.py").is_file():
        raise RuntimeError(f"the program is missing: no {PACKAGE} package "
                           f"under {SRC}")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    return importlib.import_module(PACKAGE)


def build(config: dict, sizes: dict | None = None):
    """``(model, cfg)``: the port's architecture ``config["program_arch"]``
    through its hand-written kernels (``use_pallas=True``). The port's
    config must agree with every size the configuration file states.
    ``sizes`` replaces the stated sizes (the CPU tests' small models)."""
    import_port()
    from repro_torch.configs import get_arch_config
    from repro_torch.models import build_model

    cfg = get_arch_config(config["program_arch"])
    want = sizes if sizes is not None else config["sizes"]
    if sizes is not None:
        fields = {f.name for f in dataclasses.fields(cfg)}
        cfg = dataclasses.replace(
            cfg, **{k: v for k, v in sizes.items() if k in fields})
    wrong = {k: (v, getattr(cfg, k, None)) for k, v in want.items()
             if getattr(cfg, k, None) != v}
    if wrong:
        raise ValueError(f"{config['name']}: the program's config differs "
                         f"from the stated sizes (stated, program): {wrong}")
    return build_model(cfg, use_pallas=True), cfg


def launch_counters() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    from repro_torch.kernels import flash_attention, ssd_scan

    return {"flash_attention": flash_attention.KERNEL.launches,
            "ssd_scan": ssd_scan.KERNEL.launches}
