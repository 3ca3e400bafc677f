"""The port's always-on serving CLI (``repro_torch.launch.serve_dtwn``) on
the CPU at a small capacity: the reference CLI's flags and printed lines,
``--device cpu``, and ``--shards`` above 1 refused (ROADMAP A10)."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        serve_dtwn.main(["--capacity", "16", "--shards", "2", "--device",
                         "cpu"])
