"""The port's always-on serving CLI (``repro_torch.launch.serve_dtwn``) on
the CPU at a small capacity: the reference CLI's flags and printed lines,
``--device cpu``, and ``--shards 2`` (two gloo ranks) against the
reference's serve loop and against one rank."""
import re

import pytest

from repro_torch.launch import serve_dtwn


def _run(capsys, *argv):
    rc = serve_dtwn.main([*argv, "--device", "cpu"])
    return rc, capsys.readouterr().out


def test_cli_streams_fl_with_every_axis(capsys):
    rc, out = _run(capsys, "--capacity", "48", "--rounds", "5", "--fl",
                   "--fl-model", "tiny", "--fl-iters", "2", "--join", "0.05",
                   "--leave", "0.05", "--faults", "--migration",
                   "--consensus", "--evolve", "--n-bs", "4")
    assert rc == 0
    assert "device=cpu" in out and "axes=[MFCL]" in out
    assert re.search(r"5 rounds in [\d.]+s wall \([\d.]+ rounds/s\)", out)
    assert re.search(r"round_time  mean=[\d.]+s  p95=[\d.]+s", out)
    assert re.search(r"population  start=\d+ end=\d+ joined=\d+ left=\d+",
                     out)
    for k in ("straggler_frac", "migration_rate", "honest_stake_share"):
        assert k in out
    assert re.search(r"fl_loss     [\d.]+ -> [\d.]+", out)


def test_cli_policy_and_blocking(capsys):
    rc, out = _run(capsys, "--capacity", "24", "--rounds", "3", "--policy",
                   "factorized", "--no-overlap", "--live", "20", "--join",
                   "0.1")
    assert rc == 0
    assert "policy=factorized" in out and "overlap=False" in out
    assert "live=20" in out


def test_cli_refuses_shards():
    """``--shards 2 --device cpu`` (two gloo ranks) on the reference's
    knob row and draws, every axis but FL, churn and dynamics: the metrics
    against the reference's single-device ``serve_rounds`` (counts exact,
    fractions at rtol 1e-6, the rest at the gate's rtol 1e-5), the final
    active mask and associations equal to the reference's. With ``--fl``
    on the CLI's own draws, two ranks against one: masks and associations
    equal, metrics at rtol 1e-5, the FL buffers within atol 2e-6 (the
    reference gate's serve tolerances). nccl is refused on the CPU and
    where there are fewer cards than shards, naming gloo."""
    import numpy as np
    import torch

    from repro.core import consensus as j_cons
    from repro.core import faults as j_faults
    from repro.core import migration as j_mig
    from repro.core import serve as j_serve
    from repro.core.marl import env as j_env
    from repro_torch.core import consensus as t_cons
    from repro_torch.core import faults as t_faults
    from repro_torch.core import migration as t_mig
    from repro_torch.core.marl import env as t_env
    from repro_torch.launch import mesh
    from torch_scenario_helpers import (batches, init_draws, knob_rows,
                                        round_draws)

    k, n, m = 4, 37, 4
    jc = j_env.EnvConfig(n_twins=n, n_bs=m,
                         migration=j_mig.MigrationConfig(),
                         faults=j_faults.FaultConfig(),
                         consensus=j_cons.ConsensusConfig())
    tc = t_env.EnvConfig(n_twins=n, n_bs=m,
                         migration=t_mig.MigrationConfig(),
                         faults=t_faults.FaultConfig(),
                         consensus=t_cons.ConsensusConfig())
    jscfg = j_serve.ServeConfig(capacity=n, join_rate=0.05, leave_rate=0.05,
                                evolve_channels=True)
    jb, tb = batches(1, straggler=(0.1, 0.3), outage=(0.05, 0.2),
                     byzantine=(0.0, 0.3), quorum=(1.0, 2.0))
    jrow, trow = knob_rows(jb, tb, jc, tc, 0)
    key = jb.key[0]
    st_j = j_serve.serve_init(jc, jscfg, key, jrow)
    st_j, want = j_serve.serve_rounds(jc, jscfg, st_j,
                                      j_serve.stream_keys(key, k), jrow,
                                      overlap=False)
    want = j_serve.stack_metrics(want)
    argv = ["--capacity", str(n), "--rounds", str(k), "--join", "0.05",
            "--leave", "0.05", "--faults", "--migration", "--consensus",
            "--evolve", "--n-bs", str(m), "--device", "cpu"]
    two = serve_dtwn.run(
        argv + ["--shards", "2", "--dist-backend", "gloo"], final_state=True,
        inputs={"row": trow, "init_draws": init_draws(jc, key),
                "draws": round_draws(jc, jscfg, key, k)})
    assert two["rc"] == 0
    assert set(two["metrics"]) == set(want)
    for name, w in want.items():
        got = two["metrics"][name]
        assert got.shape == w.shape, name
        if name in ("n_active", "n_joined", "n_left"):
            np.testing.assert_array_equal(got, w, err_msg=name)
        elif name in ("straggler_frac", "outage_frac", "migration_rate",
                      "accept_frac"):
            np.testing.assert_allclose(got, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, w, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(two["state"]["active"].numpy(),
                                  np.asarray(st_j.active))
    np.testing.assert_array_equal(two["state"]["assoc"].numpy(),
                                  np.asarray(st_j.env.assoc))

    argv = ["--capacity", "37", "--rounds", "4", "--fl", "--fl-model",
            "tiny", "--fl-iters", "2", "--join", "0.05", "--leave", "0.05",
            "--faults", "--migration", "--consensus", "--evolve", "--n-bs",
            "4", "--device", "cpu"]
    one = serve_dtwn.run(argv, final_state=True)
    two = serve_dtwn.run(argv + ["--shards", "2", "--dist-backend", "gloo"],
                         final_state=True)
    assert one["rc"] == two["rc"] == 0
    assert set(one["metrics"]) == set(two["metrics"])
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(two["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    for k in ("active", "assoc"):
        np.testing.assert_array_equal(two["state"][k].numpy(),
                                      one["state"][k].numpy())
    for buf in ("twin_params", "twin_mom"):
        for k, v in one["state"][buf].items():
            np.testing.assert_allclose(two["state"][buf][k].numpy(),
                                       v.numpy(), atol=2e-6, err_msg=k)
    assert "state" not in serve_dtwn.run(argv[:2] + ["--rounds", "1",
                                                      "--device", "cpu"])
    with pytest.raises(ValueError, match="gloo"):
        mesh.spawn_twin_ranks(print, 2, backend="nccl", device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises((ValueError, RuntimeError), match="gloo|CUDA"):
            serve_dtwn.main(["--capacity", "16", "--shards", "2",
                             "--dist-backend", "nccl"])
