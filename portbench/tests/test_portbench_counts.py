"""The benchmark's own counts against the figures they were derived with,
the band-pair count against a brute-force one, and sizes that a reference
does not know refused."""
import pytest

from portbench import check, counts, spec


def _work(name, **sizes):
    c = spec.cell(name)
    s = {**c.config["sizes"], **sizes}
    return counts.request_work(check.reference(c.config),
                               spec.kind(c.traffic["kind"]), s, c.traffic)


@pytest.mark.parametrize("name,total", [("danube-prefill-7680", 6.2558e13),
                                        ("danube-prefill-1024", 5.6698e13),
                                        ("mamba2-score-2048", 9.4051e13)])
def test_request_flops(name, total):
    assert counts.flops(_work(name))["total"] == pytest.approx(total,
                                                               rel=5e-5)


@pytest.mark.parametrize("config,batch,seq,positions,total", [
    ("danube-prefill-7680", 4, 4608, 1, 7.177e13),
    ("danube-prefill-7680", 32, 512, 1, 5.567e13),
    ("mamba2-score-2048", 4, 4608, 4608, 1.058e14)])
def test_figures_of_the_first_shapes(config, batch, seq, positions, total):
    # the totals the program's records give at 4 x 4,608 and 32 x 512
    c = spec.cell(config)
    work = check.reference(c.config).work(c.config["sizes"], batch, seq,
                                          positions)
    assert counts.flops(work)["total"] == pytest.approx(total, rel=5e-4)


def test_flop_parts_danube_7680():
    f = counts.flops(_work("danube-prefill-7680"))
    # 1,667,235,840 matrix parameters in the trunk
    assert f["dense"] == 2 * 1_667_235_840 * 2 * 7680
    assert f["head"] == 2 * 2560 * 32000 * 2  # the last position only
    # pairs of one sequence under the 4,096 window
    pairs = 4096 * 4097 // 2 + (7680 - 4096) * 4096
    assert f["attention"] == 24 * 4 * 80 * 32 * 2 * pairs
    assert set(f) == {"dense", "head", "attention", "total"}


def test_flop_parts_danube_1024():
    f = counts.flops(_work("danube-prefill-1024"))
    assert f["attention"] == 24 * 4 * 80 * 32 * 16 * (1024 * 1025 // 2)
    assert f["head"] == 2 * 2560 * 32000 * 16


def test_flop_parts_mamba2():
    f = counts.flops(_work("mamba2-score-2048"))
    # 2,571,632,640 matrix parameters in the trunk
    assert f["dense"] == 2 * 2_571_632_640 * 8 * 2048
    assert f["head"] == 2 * 2560 * 50280 * 8 * 2048  # every position
    assert f["ssd"] == 64 * 8 * 2048 * 5_308_416
    assert set(f) == {"dense", "head", "ssd", "total"}


@pytest.mark.parametrize("seq,window", [(1, 0), (7, 3), (64, 64), (100, 16),
                                        (513, 0), (300, 299)])
def test_band_pairs_brute_force(seq, window):
    want = sum(1 for i in range(seq) for j in range(seq)
               if j <= i and (window <= 0 or j > i - window))
    assert counts.band_pairs(seq, window) == want


def test_least_times():
    # one layer of danube's attention at 4 x 4,608 and of mamba2's SSD at
    # the same shape: the figures of the kernel table (PERF.md)
    least = counts.least_by_part(_work("danube-prefill-7680"))
    assert set(least) == {"attention"}
    from portbench.reference import gqa_lm, mamba2_lm
    s = spec.cell("danube-prefill-7680").config["sizes"]
    a = counts.least_by_part(gqa_lm.work(s, 4, 4608, 1))["attention"]
    assert a / 24 == pytest.approx(0.4344e-3, rel=1e-3)
    s = spec.cell("mamba2-score-2048").config["sizes"]
    w = mamba2_lm.work(s, 4, 4608, 4608)["ssd"]
    assert counts.least_by_part({"ssd": w})["ssd"] / 64 == pytest.approx(
        0.1736e-3, rel=1e-3)
    # the SSD is bound by its bytes: x, B, C in bf16, dt and y in fp32
    assert w["bytes"] / counts.HBM_BYTES_PER_S > \
        w["flops"] / counts.PEAK_BF16_FLOPS


@pytest.mark.parametrize("name,sizes,match", [
    ("danube-prefill-7680", {"n_experts": 8}, "does not know"),
    ("danube-prefill-7680", {"attn_pattern": "local_global"}, "not written"),
    ("danube-prefill-1024", {"tie_embeddings": True}, "not written"),
    ("mamba2-score-2048", {"n_heads": 32}, "does not know"),
    ("mamba2-score-2048", {"ssm_groups": 8}, "does not know"),
])
def test_unknown_shape_is_refused(name, sizes, match):
    """A shape the reference's count was not written for (experts, a
    hybrid's attention in an SSM, grouped B/C) raises, never mis-counts."""
    with pytest.raises(ValueError, match=match):
        _work(name, **sizes)


def test_missing_size_is_refused():
    c = spec.cell("mamba2-score-2048")
    s = dict(c.config["sizes"])
    del s["ssm_chunk"]
    with pytest.raises(ValueError, match="lacks"):
        counts.request_work(check.reference(c.config), spec.kind("score"), s,
                            c.traffic)
