"""Rate, tail, idle share and trace reading on synthetic timelines."""

import pytest

from harness import profile, timeline


def test_rate_counts_all_work_over_the_whole_window_with_a_stall():
    # three renders of 1e6 paths; the second stalls 3 s; the window starts at 10
    renders = [(10.0, 11.0, 1e6), (11.0, 15.0, 1e6), (15.0, 16.0, 1e6)]
    assert timeline.rate_per_s(renders, 10.0) == pytest.approx(3e6 / 6.0)
    with pytest.raises(ValueError):
        timeline.rate_per_s([], 0.0)


def test_p95_is_the_nearest_rank_over_every_frame():
    frames = [10.0] * 95 + [50.0] * 5
    assert timeline.percentile(frames, 95.0) == 10.0
    assert timeline.percentile(frames + [60.0], 95.0) == 50.0
    assert timeline.percentile([7.0], 95.0) == 7.0
    # a stall in one frame of twenty is the tail
    assert timeline.percentile([1.0] * 19 + [100.0], 95.0) == 1.0
    assert timeline.percentile([1.0] * 18 + [100.0, 100.0], 95.0) == 100.0


def test_busy_and_gaps_merge_overlaps_and_clip_to_the_window():
    busy, gaps = timeline.busy_and_gaps([(1, 3), (2, 4), (6, 7), (9, 20)], 0, 10)
    assert busy == pytest.approx(3 + 1 + 1)  # [1,4] + [6,7] + [9,10]
    assert gaps == [(0, 1), (4, 6), (7, 9)]
    assert timeline.idle_pct(busy, 10.0) == pytest.approx(50.0)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(lose=False):
    ev = [_ev("user_annotation", "bench.render", 0, 100), _ev("user_annotation", "bench.render",
                                                              100, 100)]
    for k in range(4):
        t = 50 * k
        ev.append(_ev("cpu_op", "aten::add", t, 5))
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t + 5, 2, corr=k))
        if not (lose and k == 3):
            ev.append(_ev("kernel", "void pathk_kernel<true>(...)" if k % 2 else "elementwise",
                          t + 10, 20, corr=k))
    ev.append(_ev("gpu_memcpy", "Memcpy DtoH", 190, 5, corr=99))
    return ev


def test_read_trace_busy_idle_launches_and_breakdown():
    t = profile.read_trace(_trace(), renders=2, paths=8.0, pixels=4.0)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx((4 * 20 + 5) * 1e-6)
    assert t.launches == 4
    assert t.kernel_seconds("pathk_kernel") == (pytest.approx(40e-6), 2)
    ops = dict(t.breakdown["device_ops"])
    assert ops["elementwise"] == pytest.approx(40e-6)
    assert sum(v for _, v in t.breakdown["idle_gaps"]) == pytest.approx(t.window_s - t.busy_s)


def test_read_trace_refuses_a_trace_that_lost_device_events():
    with pytest.raises(profile.TraceLost):
        profile.read_trace(_trace(lose=True), renders=2, paths=8.0, pixels=4.0)
