"""On the card: each cell for a short window, traced and not, comes out
correct with its result line whole. Marked ``cuda``; skips without a
card."""
import pytest
import torch

from portbench import harness, spec
from portbench.tests.test_portbench_data import _check_line

CELLS = [w["name"] for w in spec.load(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, traced):
    r = harness.run(spec.cell(name), 2**31 + 901, 2.0, traced, "cuda", 0.0)
    _check_line(r, traced)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu"
    torch.cuda.empty_cache()
