"""The port stands alone and never carries on silently on the CPU.

An AST scan shows that no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, the reference package ``repro`` or
``ml_dtypes`` (which the card's machine does not have). With
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
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


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
    # the MARL controller: the trainer and the FL round hook
    from repro_torch.core.marl import (DDPGConfig, EnvConfig, TrainConfig,
                                       maddpg_init, train, train_host_loop)

    cfgs = (EnvConfig(n_twins=4, n_bs=2, bs_freqs_ghz=(2.6, 1.8)),
            DDPGConfig(batch_size=2, hidden=(8, 8)),
            TrainConfig(steps=2, warmup=1, replay_capacity=4))
    for run in (train, train_host_loop):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(*cfgs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(*cfgs, 0, device="cuda")
    agent = maddpg_init(cfgs[0], cfgs[1], torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DTWNSystem(FLConfig(n_users=4, n_bs=2), data).marl_actions(agent)
    # the scenario runners, the serve loop's state and draws, the CLI
    from repro_torch.core import scenario, serve
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.migration import MigrationConfig
    from repro_torch.fl import stream
    from repro_torch.launch import serve_dtwn

    env_cfg, batch = cfgs[0], scenario.make_batch(0, 2)
    runners = (
        lambda **kw: scenario.run_baselines(env_cfg, batch, **kw),
        lambda **kw: scenario.run_faults(env_cfg, FaultConfig(), batch, 2,
                                         **kw),
        lambda **kw: scenario.run_migration(env_cfg, MigrationConfig(),
                                            batch, 2, **kw),
        lambda **kw: scenario.run_consensus(env_cfg, ConsensusConfig(),
                                            batch, 2, **kw),
        lambda **kw: scenario.run_policy(env_cfg, agent, batch, 2, **kw))
    for run in runners:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(device="cuda")
    scfg = serve.ServeConfig(capacity=4, join_rate=0.1)
    row = scenario.knob_row(scenario.stream_knobs(batch), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_init(env_cfg, scfg, row)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.stream_draws(env_cfg, scfg, 0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.fl_init(stream.FLServeConfig(model="tiny"),
                       torch.Generator(), data, np.ones(4, bool))
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_dtwn.main(["--capacity", "8", "--rounds", "1", *argv])
    # the LM trainer
    from repro_torch.launch import train

    for argv in ([], ["--full"], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "h2o-danube-1.8b", "--steps", "1", *argv])
    # on the CPU on purpose, the serve loop runs
    st = serve.serve_init(env_cfg, scfg, row, device="cpu")
    _, m = serve.serve_rounds(env_cfg, scfg, st,
                              serve.stream_draws(env_cfg, scfg, 0, 2, "cpu"),
                              row)
    assert m["round_time"].device.type == "cpu"


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


def test_kernel_variant_counts():
    """A library's launches are counted in all and per variant, and set to
    0 together."""
    from repro_torch.kernels import _build

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert set(fa.KERNEL.variant_launches) == {"bf16_tc", "fp32"}
    q = torch.ones((1, 4, 2, 16), dtype=torch.bfloat16)
    before = dict(fa.KERNEL.variant_launches)
    fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert fa.KERNEL.variant_launches == before  # CPU: the plain version
    k = _build.CudaKernel("flash_attention.cu", {}, variants=("a", "b"))
    k.count("a")
    k.count("a")
    k.count("b")
    assert k.launches == 3 and k.variant_launches == {"a": 2, "b": 1}
    k.reset()
    assert k.launches == 0 and k.variant_launches == {"a": 0, "b": 0}
    assert k.target == fa.KERNEL.target  # one library a source


def test_row_strides():
    """The kernels' wrappers pass the leading strides as they are, and 0
    for an axis of length 1 (read only at index 0)."""
    from repro_torch.kernels._build import row_strides

    t = torch.zeros((2, 1, 3, 4))
    assert row_strides(t, 3) == [12, 0, 4]
    view = torch.zeros((3, 5, 2, 8)).transpose(0, 1)[:, :1]  # (5, 1, 2, 8)
    assert row_strides(view, 3) == [16, 0, 8]
    assert row_strides(view, 2) == [16, 0]
