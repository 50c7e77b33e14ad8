"""The device timeline's reduction: busy time as a union, device time by
kernel name, idle gaps charged to the innermost open host span."""
from perfbench.devtrace import Timeline


def test_busy_device_time_and_gaps():
    ms = 1_000_000
    tl = Timeline(
        device=[(0, 10 * ms, "prefill_tc_kernel<bf16>"),
                (5 * ms, 12 * ms, "gemm"),
                (20 * ms, 25 * ms, "gemm"),
                (40 * ms, 41 * ms, "prefill_tc_kernel<bf16>")],
        spans=[(0, 50 * ms, "bench.step"),
               (13 * ms, 19 * ms, "bench.admit"),
               (30 * ms, 39 * ms, "bench.wave")])
    assert abs(tl.busy_s - (12 + 5 + 1) / 1000) < 1e-12
    assert abs(tl.device_s("prefill_tc_kernel") - 0.011) < 1e-12
    assert abs(tl.device_s("gemm", "prefill") - 0.023) < 1e-12
    # gap 12-20 (mid 16: in admit), gap 25-40 (mid 32.5: in wave)
    gaps = tl.idle_by_host()
    assert abs(gaps["bench.admit"] - 0.008) < 1e-12
    assert abs(gaps["bench.wave"] - 0.015) < 1e-12
    b = tl.breakdown()
    assert b["device_ops"][0][0] == "gemm"
    assert [n for n, _ in b["idle_gaps"]] == ["bench.wave", "bench.admit"]
