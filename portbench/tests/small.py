"""Small cells for the CPU tests: each configuration at the program's smoke
widths (``get_smoke_config``) and its own full depth, served in bfloat16 as
the full one is, with short prompts that still cross the sliding window and
several SSD chunks. Depth is kept because the bf16 program's and the fp8
control's gaps grow with it, and the limits were set at full depth."""
from __future__ import annotations

import dataclasses

from portbench import program, spec

PROMPT_LEN = 96  # past the smoke window of 64; three SSD chunks of 32
BATCH = 2


def sizes(config: dict) -> dict:
    program.import_port()
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(config["program_arch"]),
                              param_dtype="bfloat16",
                              n_layers=config["sizes"]["n_layers"])
    return {k: getattr(cfg, k) for k in config["sizes"]}


def cell(name: str) -> tuple[spec.Cell, dict]:
    """``(cell, sizes)``: the benchmark's cell ``name`` with small prompts
    and small sizes."""
    c = spec.cell(name)
    traffic = {**c.traffic, "batch": BATCH, "prompt_len": PROMPT_LEN}
    return dataclasses.replace(c, traffic=traffic), sizes(c.config)
