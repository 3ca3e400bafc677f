"""The port stands alone and never carries on silently on the CPU.

An AST scan shows that no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``. With
no CUDA device present, the entry points that default to ``cuda`` raise. The
kernel wrappers run their plain versions only because the tensors they are
given lie on the CPU; ``tests/test_torch_segment_reduce.py``,
``tests/test_torch_fedavg_reduce.py``, ``tests/test_torch_flash_attention.py``
and ``tests/test_torch_ssd_scan.py`` check that no launch is counted then.
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert all(p.is_file() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card paths do not run")


def test_entry_points_raise_without_cuda():
    _no_card()
    from repro_torch.data import cifar10
    from repro_torch.fl import DTWNSystem, FLConfig
    from repro_torch.utils.device import default_device

    data = cifar10.load(max_train=64, max_test=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DTWNSystem(FLConfig(n_users=4, n_bs=2), data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_take_plain_version_only_for_cpu_tensors():
    _no_card()
    sr = importlib.import_module("repro_torch.kernels.segment_reduce")
    fr = importlib.import_module("repro_torch.kernels.fedavg_reduce")
    vals, ids = torch.ones((4, 2)), torch.tensor([0, 1, 1, 0],
                                                  dtype=torch.int32)
    np.testing.assert_array_equal(sr.segment_reduce_kernel(vals, ids, 2),
                                  [[2, 2], [2, 2]])
    np.testing.assert_array_equal(fr.fedavg_reduce(vals, torch.ones(4)),
                                  [1, 1])
    # a CUDA tensor cannot even be made here; a CPU tensor paired with a
    # non-CPU one is refused rather than moved
    meta = torch.ones((4, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sr.segment_reduce_kernel(meta, ids, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fr.fedavg_reduce(meta, torch.ones(4))


def test_lm_entry_points_raise_without_cuda():
    _no_card()
    from repro_torch.launch import serve

    for arch in ("h2o-danube-1.8b", "mamba2-2.7b"):
        for argv in ([], ["--full"], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                serve.main(["--arch", arch, *argv])
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q, k = torch.ones((1, 4, 2, 8)), torch.ones((1, 4, 1, 8))
    before = fa.KERNEL.launches
    assert fa.flash_attention(q, k, k).shape == q.shape
    assert fa.KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q.to("meta"), k, k)
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    x, dt, A = torch.ones((1, 8, 2, 4)), torch.ones((1, 8, 2)), -torch.ones(2)
    bc = torch.ones((1, 8, 3))
    before = ssd.KERNEL.launches
    assert ssd.ssd_scan(x, dt, A, bc, bc, chunk=4).shape == x.shape
    assert ssd.KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(x.to("meta"), dt, A, bc, bc, chunk=4)
