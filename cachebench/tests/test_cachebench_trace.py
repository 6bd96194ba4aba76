"""The reductions of a traced run and the per-layer readers, on made-up
records."""
import pytest

from cachebench import harness, roofline, spec, trace
from cachebench.trace import SpanRec


def _run(**kw):
    run = harness.Run("tpch_sf1.fused", window_start=0, window_end=1000,
                      completed=2)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_union_and_idle_gaps_by_span():
    busy = trace.busy([("a", 100, 200), ("b", 150, 300), ("c", 600, 700),
                       ("d", 990, 1200)], 0, 1000)
    assert busy == [(100, 300), (600, 700), (990, 1000)]
    spans = [SpanRec("sql.execute", 0, 800, "e", ""),
             SpanRec("sql.fused_star", 350, 550, "s", "e")]
    gaps = dict(trace.idle_gaps(busy, spans, 0, 1000))
    # [0,100) in sql.execute, [300,600) middle 450 in the star span,
    # [700,990) middle 845 outside every span
    assert gaps == {"sql.execute": 100e-9, "sql.fused_star": 300e-9,
                    "harness": 290e-9}


def test_profiler_clock_is_matched_to_the_host_clock():
    raw = [("k", 5_000_100, 5_000_200)]
    assert trace._clock_shift(raw, 5_000_000, 0, 1000) == 5_000_000
    assert trace._clock_shift([("k", 100, 200)], 5_000_000, 0, 1000) == 0


def test_host_self_time():
    spans = [SpanRec("sql.execute", 0, 100, "e1", ""),
             SpanRec("sql.fused_aggregate", 10, 60, "a", "e1"),
             SpanRec("cache.get", 20, 30, "g", "a"),
             SpanRec("sql.execute", 200, 300, "e2", ""),
             SpanRec("sql.fused_star", 250, 290, "s", "e2")]
    ms = spec.metric("sql.host_self_ms").read(_run(spans=spans))
    assert ms == pytest.approx((50 + 60) / 1e6 / 2)
    # the host's waits for the card are the device's time: one inside the
    # first span's self time, one inside a child, one across the second
    # span's start and one outside every span
    waits = [(70, 80), (40, 45), (190, 210), (500, 600)]
    ms = spec.metric("sql.host_self_ms").read(
        _run(spans=spans, host_waits=waits))
    assert ms == pytest.approx((40 + 50) / 1e6 / 2)


def test_blocking_runtime_calls():
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy"):
        assert trace.blocking(name), name
    for name in ("cudaLaunchKernel", "cudaEventRecord", "cudaMalloc"):
        assert not trace.blocking(name), name


def test_rooflines_count_the_launches_bytes_over_kernel_time():
    k1 = spec.metric("k1_roofline")
    calls = {key: [] for key in k1.HOOKS}
    key_i, key_s = list(k1.HOOKS)
    calls[key_i] = [(733, 20, True), (0, 20, True)]
    calls[key_s] = [(1, 0, False)]
    ev = [("void cmp_const_many_kernel<true>(...)", 0, 10_000),
          ("other", 0, 99_999)]
    got = k1.read(_run(hook_calls=calls, device_events=ev))
    want = 100 * roofline.k1_bytes(733, 20, True) / 3.35e12 / 1e-5
    assert got == pytest.approx(want)
    assert k1.read(_run(hook_calls=calls, device_events=[])) is None
    k2 = spec.metric("k2_roofline")
    (key,) = k2.HOOKS
    got = k2.read(_run(hook_calls={key: [(400, 1200, 10, 3)]},
                       device_events=[("group_accumulate_kernel", 0, 1000)]))
    assert got == pytest.approx(
        100 * (400 + 1200 + 8 * 11 * 3) / 3.35e12 / 1e-6)


def test_idle_share():
    run = _run(device_events=[("k", 0, 250), ("k", 500, 750)])
    assert spec.metric("device.idle_share").read(run) == pytest.approx(50.0)
    assert spec.metric("device.idle_share").read(_run()) is None


def test_hooks_record_the_launch_shapes():
    import torch
    from liquid_tpu_torch.ops import bitpack_cuda, grouphist_cuda
    k1, k2 = spec.metric("k1_roofline"), spec.metric("k2_roofline")
    planes = torch.zeros((3, 5, 256), dtype=torch.int32)
    cs = torch.zeros(3, dtype=torch.int64)
    slot = torch.zeros(8, dtype=torch.int32)
    cols = [torch.ones(8, dtype=torch.int32)] * 2
    with trace.Hooks({**k1.HOOKS, **k2.HOOKS}) as hk:
        bitpack_cuda.in_interval_many(planes, cs, cs)
        bitpack_cuda.cmp_const_many(planes, cs)
        grouphist_cuda.group_accumulate(slot, cols, 4)
    assert bitpack_cuda.in_interval_many.__name__ == "in_interval_many"
    calls = {k: v for k, v in hk.calls.items()}
    assert calls[("liquid_tpu_torch.ops.bitpack_cuda",
                  "in_interval_many")] == [(3, 5, True)]
    assert calls[("liquid_tpu_torch.ops.bitpack_cuda",
                  "cmp_const_many")] == [(3, 5, False)]
    assert calls[("liquid_tpu_torch.ops.grouphist_cuda",
                  "group_accumulate")] == [(32, 64, 4, 2)]
