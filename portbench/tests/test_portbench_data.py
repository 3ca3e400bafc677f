"""The harness is driven by data: a cell, a configuration, a traffic mix and
a per-layer metric are added as files (and entries of BENCHMARK.json), and
no file of the benchmark that is there changes. The result line's schema,
and the run's refusals."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, spec
from portbench.tests import small

ROOT = spec.ROOT


def _digests(folder: Path) -> dict:
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_cell_config_traffic_kind_metric_as_files(copy):
    before = _digests(copy / "portbench")
    pb = copy / "portbench"
    config = json.loads((pb / "configs" / "h2o-danube-1.8b.json").read_text())
    config["name"] = "danube-copy"
    (pb / "configs" / "danube-copy.json").write_text(json.dumps(config))
    # a new request kind: a copy of first_token under a name of its own
    shutil.copy(pb / "kinds" / "first_token.py", pb / "kinds" / "prefill2.py")
    traffic = json.loads((pb / "traffic" / "prefill-16x1024.json").read_text())
    (pb / "traffic" / "prefill-8x256.json").write_text(
        json.dumps({**traffic, "kind": "prefill2", "batch": 8,
                    "prompt_len": 256}))
    (pb / "workloads" / "copy-prefill-256.json").write_text(
        json.dumps({"limits": {"logits": 1.0}}))
    (pb / "metrics" / "request_count.py").write_text(
        "def read(ctx):\n    return float(ctx['trace']['requests'])\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "danube-copy", "source": "x",
                             "file": "portbench/configs/danube-copy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "copy-prefill-256",
                               "config": "danube-copy",
                               "traffic": "prefill-8x256", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "request_count", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "tokens_per_s",
                               "workloads": ["copy-prefill-256"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {k: v for k, v in _digests(pb).items() if k in before}
    assert after == before

    cell = spec.cell("copy-prefill-256", root=copy)
    assert cell.config["name"] == "danube-copy"
    assert (cell.traffic["batch"], cell.traffic["prompt_len"]) == (8, 256)
    assert [m["name"] for m in cell.per_layer][-1] == "request_count"
    assert cell.limits == {"logits": 1.0}
    kind = spec.kind("prefill2", root=copy)
    assert kind.__file__ == str(pb / "kinds" / "prefill2.py")
    # a traced run of the new cell reads the new metric (small sizes)
    s = small.sizes(cell.config)
    import dataclasses
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "batch": 2,
                                              "prompt_len": small.PROMPT_LEN})
    r = harness.run(cell, 9, 0.3, True, "cpu", 0.0, sizes=s)
    assert r["metrics"]["request_count"]["value"] == r["info"]["requests"] > 0
    assert set(r["check"]) == {"logits", "kv", "token_gap"}


def test_unknown_kind_is_refused(copy):
    pb = copy / "portbench"
    traffic = json.loads((pb / "traffic" / "score-8x2048.json").read_text())
    (pb / "traffic" / "score-8x2048.json").write_text(
        json.dumps({**traffic, "kind": "decode"}))
    cell = spec.cell("mamba2-score-2048", root=copy)
    with pytest.raises(KeyError, match="kinds/decode.py"):
        harness.run(cell, 1, 0.1, False, "cpu", 0.0,
                    sizes=small.sizes(cell.config))


@pytest.mark.parametrize("size,room", [(8, 6), (2, 0)])
def test_sample(size, room):
    """The sample: one of the first EARLY, a reservoir over the rest, the
    last; the same seed draws the same requests."""
    def draw(seed, n):
        s = harness.Sample(size, seed)
        for i in range(n):
            s.offer(i, {"i": i})
        return s.records()

    got = draw(2**40 + 3, 200)
    assert all(rec["i"] == i for i, rec in got.items())
    assert 199 in got and min(got) < harness.EARLY
    assert len(got) == min(size, 200) == 2 + room
    assert draw(2**40 + 3, 200).keys() == got.keys()
    picks = {i for seed in range(40) for i in draw(seed, 200)}
    assert len(picks) > 100 if room else picks <= set(range(4)) | {199}
    assert draw(5, 1).keys() == {0} and draw(5, 0) == {}


def _check_line(r, traced):
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "check"
    assert isinstance(r["correct"], bool)
    assert isinstance(r["attempted"], int) and isinstance(r["failed"], int)
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            entries = r["breakdown"][part]
            assert len(entries) <= 10
            assert all(isinstance(n, str) and isinstance(s, float)
                       for n, s in entries)
    for c in r["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("name", ["danube-prefill-7680", "mamba2-score-2048"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(name, traced):
    cell, s = small.cell(name)
    r = harness.run(cell, 2**33 + 1, 0.3, traced, "cpu", 0.0, sizes=s)
    _check_line(r, traced)
    if not traced:
        assert set(r["metrics"]) == {"tokens_per_s", "latency_p95_ms", "mfu",
                                     "setup_s"}
    assert r["attempted"] == r["info"]["requests"] > 0
    assert set(r["check"]) == {"first_token": {"logits", "kv", "token_gap"},
                               "score": {"logits"}}[cell.traffic["kind"]]


def test_same_seed_same_inputs():
    from portbench import traffic, weights
    cell, s = small.cell("danube-prefill-7680")
    from portbench import check
    spec_ = check.reference(cell.config).param_spec(s)
    a, _ = weights.make(spec_, 2**31 + 5, "cpu")
    b, _ = weights.make(spec_, 2**31 + 5, "cpu")
    c, _ = weights.make(spec_, 2**31 + 6, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    p = traffic.draw(cell.traffic, s, 2**40, 3, "cpu")
    assert torch.equal(p, traffic.draw(cell.traffic, s, 2**40, 3, "cpu"))
    assert p.shape == (3, 2, small.PROMPT_LEN)


def test_leaked_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert harness.leaked_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert {"jax", "repro"} <= set(harness.leaked_modules())


def _run_cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "danube-prefill-7680", "--seed", "1", "--seconds",
                           "1", "--trace", "0", *extra], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run_cli(ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "needs 1 CUDA card" in r.stderr


def test_cli_refuses_without_the_program(copy):
    r = _run_cli(copy)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_json_names_its_files():
    """Every name in BENCHMARK.json is well formed and finds its file: each
    configuration, traffic mix, cell and per-layer metric."""
    import re
    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
    unit = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
    bench = spec.load(ROOT / "BENCHMARK.json")
    pb = ROOT / "portbench"
    for c in bench["configs"]:
        assert name.fullmatch(c["name"]) and (ROOT / c["file"]).is_file()
        assert spec.load(ROOT / c["file"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert name.fullmatch(w["name"]) and len(w["why"]) <= 200
        assert (pb / "traffic" / f"{w['traffic']}.json").is_file()
        assert (pb / "workloads" / f"{w['name']}.json").is_file()
        assert spec.cell(w["name"]).limits
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.fullmatch(m["name"]) and unit.fullmatch(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
