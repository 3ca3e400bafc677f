"""The trace reduction on a hand-made timeline: busy time as the union of
device operations, idle gaps named by the host's activity, requests
counted, and the per-layer readers on it."""
import pytest

from portbench import classes, spec, trace

CPU = [("portbench.window", 0, 100), ("portbench.request", 5, 50),
       ("aten::mm", 8, 12), ("portbench.request", 55, 95),
       ("cudaDeviceSynchronize", 60, 90)]
DEV = [("nvjet_tst_192x192", 10, 30), ("flash_kernel_bf16_tc<80>", 25, 40),
       ("ssd_out_kernel", 60, 70), ("elementwise_kernel", 120, 130)]


def test_reduce():
    red = trace.reduce((DEV, CPU))
    assert red["window_s"] == pytest.approx(100e-9)
    assert red["busy_s"] == pytest.approx(40e-9)  # [10, 40] and [60, 70]
    assert red["requests"] == 2
    assert red["by_name"]["flash_kernel_bf16_tc<80>"] == pytest.approx(15e-9)
    assert "elementwise_kernel" not in red["by_name"]  # outside the window
    idle = red["idle_by_host"]
    assert idle["portbench.request"] == pytest.approx(10e-9)  # [0, 10]
    assert idle["portbench.window"] == pytest.approx(20e-9)  # [40, 60]
    assert idle["portbench.request > cudaDeviceSynchronize"] == \
        pytest.approx(30e-9)  # [70, 100]
    b = trace.breakdown(red)
    assert b["device_ops"][0][0] == "nvjet_tst_192x192"


def test_no_window_no_reduction():
    assert trace.reduce((DEV, CPU[1:])) is None


def test_kinds_and_readers():
    assert classes.kind_of("void flash_kernel_bf16_tc<80>(Params)") == "attention"
    assert classes.kind_of("ssd_state_kernel") == "ssd"
    assert classes.kind_of("sm90_xmma_gemm_bf16") == "matmul"
    assert classes.kind_of("vectorized_elementwise_kernel") == "other"
    ctx = {"trace": trace.reduce((DEV, CPU)), "flops": {"total": 1e6},
           "least_s": {"attention": 5e-9, "ssd": 2e-9}}
    read = {m: spec.reader(m)(ctx) for m in
            ("attn_kernel_ms", "attn_roofline", "ssd_kernel_ms",
             "ssd_roofline", "matmul_ms", "other_kernel_ms",
             "device_idle_pct", "step_mfu")}
    assert read["attn_kernel_ms"] == pytest.approx(15e-9 * 1e3 / 2)
    assert read["attn_roofline"] == pytest.approx(100 * 5e-9 / 7.5e-9)
    assert read["ssd_roofline"] == pytest.approx(100 * 2e-9 / 5e-9)
    assert read["matmul_ms"] == pytest.approx(20e-9 * 1e3 / 2)
    assert read["other_kernel_ms"] is None  # nothing else in the window
    assert read["device_idle_pct"] == pytest.approx(60.0)
    # nothing to read: every reader is silent, none reports 0
    empty = {"trace": None, "flops": {"total": 1.0}, "least_s": {}}
    assert all(spec.reader(m)(empty) is None for m in read)
