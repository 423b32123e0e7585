"""benchmark/spans.py: the reduction of the program's spans on a
hand-built window (nested spans, a launch from a second thread inside a
span, an idle gap split between a parent's own time and a child's), the
synchronising calls by span, and each per-layer number of METRICS on a
record with and without its span or counter."""
import pytest

from benchmark import spans


def X(name, ts, dur, cat, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": 7, "tid": tid, "args": args}


def launch(c, ts, tid=1):
    return X("cudaLaunchKernel", ts, 5, "cuda_runtime", tid, correlation=c)


def kernel(c, ts, dur):
    return X(f"k{c}", ts, dur, "kernel", tid=99, correlation=c)


EVENTS = [
    X("nmb.window", 0, 1000, "user_annotation"),
    X("nm.render.frame", 100, 800, "user_annotation"),
    X("nm.ctx.build", 200, 200, "user_annotation"),
    X("nm.surface.secant", 500, 300, "user_annotation"),
    X("nm.weights.pack", 550, 50, "user_annotation"),
    # another thread's span is not the window's
    X("nm.elsewhere", 100, 800, "user_annotation", tid=2),
    # the benchmark's own wrapper spans are not the program's
    X("nmb.secant_refine.0", 540, 200, "user_annotation"),
    launch(1, 250), kernel(1, 260, 100),
    # launched from a second thread inside weights.pack
    launch(2, 560, tid=2), kernel(2, 600, 100),
    # before the frame
    launch(3, 50), kernel(3, 60, 30),
    X("cudaMemcpyAsync", 575, 2, "cuda_runtime"),
    X("cudaStreamSynchronize", 580, 10, "cuda_runtime"),
    X("cudaStreamSynchronize", 950, 10, "cuda_runtime"),
]


def test_reduce_nested_spans_threads_and_idle():
    got = spans.reduce(EVENTS)
    assert set(got) == {"nm.render.frame", "nm.ctx.build",
                        "nm.surface.secant", "nm.weights.pack"}
    us = 1e-6
    # busy: [60, 90], [260, 360], [600, 700]
    want = {
        "nm.render.frame": dict(calls=1, host_s=800 * us,
                                self_host_s=300 * us, device_s=200 * us,
                                idle_s=600 * us, self_idle_s=300 * us),
        "nm.ctx.build": dict(calls=1, host_s=200 * us, self_host_s=200 * us,
                             device_s=100 * us, idle_s=100 * us,
                             self_idle_s=100 * us),
        "nm.surface.secant": dict(calls=1, host_s=300 * us,
                                  self_host_s=250 * us, device_s=100 * us,
                                  idle_s=200 * us, self_idle_s=150 * us),
        "nm.weights.pack": dict(calls=1, host_s=50 * us, self_host_s=50 * us,
                                device_s=100 * us, idle_s=50 * us,
                                self_idle_s=50 * us),
    }
    for name, w in want.items():
        for k, v in w.items():
            assert got[name][k] == pytest.approx(v, abs=1e-12), (name, k)


def test_syncs_by_innermost_span_inside_frames():
    assert spans.syncs(EVENTS) == {"nm.weights.pack": 1}


FULL = {"iters": 2,
        "spans": {n: dict(calls=2, host_s=0.1, self_host_s=0.05,
                          device_s=0.004, idle_s=0.01, self_idle_s=0.002)
                  for n in ("nm.render.frame", "nm.ctx.build",
                            "nm.ctx.bounds", "nm.weights.fold",
                            "nm.weights.pack", "nm.train.adam")},
        "counters": {"host_read": 12, "secant.rays_refined": 1000,
                     "secant.rays_bracketed": 250}}
WANT = {"frame_idle_ms.render": 5.0, "ctx_build_ms.render": 4.0,
        "weight_prep_ms.render": 4.0, "host_reads_per_frame": 6.0,
        "secant_bracket_share.render": 25.0, "adam_ms": 2.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_metric_with_and_without_what_it_reads(name):
    assert set(spans.METRICS) == set(WANT)
    read = spans.METRICS[name]
    assert read(FULL) == pytest.approx(WANT[name])
    # a program without the spans and counters (as the parent's)
    assert read({"iters": 2}) is None
    assert read({"iters": 2, "spans": {}, "counters": {}}) is None
