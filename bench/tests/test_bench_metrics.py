import statistics

import numpy as np
import pytest

from bench import trace
from bench.spec import load_reader


def window_rec(flush_s, ops_per_flush=100):
    return {"window": {"flushes": len(flush_s), "ops": ops_per_flush *
                       len(flush_s), "ingest_s": sum(flush_s),
                       "flush_s": flush_s}}


def test_rate_is_all_ops_over_all_ingest_time():
    fs = [0.1] * 50 + [1.0] * 2
    rec = window_rec(fs)
    got = load_reader("updates_per_s").read(rec)
    assert got == pytest.approx(100 * 52 / (5.0 + 2.0))
    # not the mean of per-flush rates, which a slow flush barely moves
    assert got < statistics.mean(100 / f for f in fs) * 0.9


def test_p95_is_taken_over_every_flush():
    fs = list(np.linspace(0.01, 0.2, 200))
    got = load_reader("flush_p95_ms").read(window_rec(fs))
    assert got == pytest.approx(np.percentile(fs, 95) * 1e3)
    # every flush counts: a slow tail of 6% moves it
    fs2 = fs[:188] + [5.0] * 12
    assert load_reader("flush_p95_ms").read(window_rec(fs2)) > 1000


def test_counter_readers():
    rec = window_rec([0.5] * 10, ops_per_flush=200_000)
    rec["counters"] = {"host_syncs": 30, "defrag_stream": 3,
                       "defrag_dense": 1, "defrag_wide": 0}
    rec["spans"] = {"defrag_ms": 250.0, "ingest_ms": 5000.0}
    rec["cycles"] = [{"num_edges": 1000, "num_vertices": 10,
                      "memory_bytes": 250_000}]
    assert load_reader("host_syncs_per_flush").read(rec) == 3.0
    assert load_reader("rebuilds_per_mop").read(rec) == 2.0
    assert load_reader("rebuild_ms_pct").read(rec) == 5.0
    assert load_reader("bytes_per_edge").read(rec) == 250.0
    rec["cycles"] = []
    assert load_reader("bytes_per_edge").read(rec) is None


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """Two flushes over [0, 100) us: kernels overlap at 10-30 and 20-40,
    one at 60-70 whose launch has no kept event, a copy at 80-85."""
    return [
        _ev("user_annotation", trace.FLUSH, 0, 50),
        _ev("user_annotation", trace.FLUSH, 50, 50),
        _ev("cpu_op", "aten::nonzero", 40, 20),
        _ev("cpu_op", "aten::add", 5, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 9, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=4),
        _ev("cuda_runtime", "cudaMemcpyAsync", 75, 1, corr=5),
        _ev("kernel", "append_kernel(int*, float*)", 10, 20, corr=1),
        _ev("kernel", "sort_lookup_kernel(long long const*)", 20, 20,
            corr=2),
        _ev("kernel", "sort_lookup_kernel(long long const*)", 60, 10,
            corr=4),
        _ev("gpu_memcpy", "Memcpy DtoH", 80, 5, corr=5),
    ]


def test_summarize_a_trace():
    s = trace.summarize(synthetic_trace())
    assert s["flushes"] == 2
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)       # 10-40, 60-70, 80-85
    assert s["launches"] == 4 and s["launches_kept"] == 3
    assert s["kernels"]["sort_lookup_kernel(long long const*)"] == {
        "count": 2, "seconds": pytest.approx(30e-6)}
    assert s["device_ops"][0] == ["sort_lookup_kernel(long long const*)",
                                  pytest.approx(30e-6)]
    gaps = dict(s["idle_gaps"])
    # 0-10 (the middle at 5: aten::add), 40-60 (aten::nonzero), 70-80
    # (the copy's call spans 75), 85-100 (no op: python)
    assert gaps == {"aten::add": pytest.approx(10e-6),
                    "aten::nonzero": pytest.approx(20e-6),
                    "cudaMemcpyAsync": pytest.approx(10e-6),
                    "python": pytest.approx(15e-6)}
    rec = {"profile": s, "profile_launches": {"sort_lookup": 4}}
    # 2 kept events of 4 launches: the kept time is scaled up
    assert load_reader("sort_lookup_ms_per_flush").read(rec) == \
        pytest.approx(30e-6 * 2 * 1e3 / 2)
    assert load_reader("device_idle_pct").read(rec) == pytest.approx(55.0)
    assert load_reader("launches_per_flush").read(rec) == 2.0


def test_roofline_reader_takes_bound_over_device_time():
    s = trace.summarize(synthetic_trace())
    rec = {"roofline": s, "roofline_launches": {"append": 1},
           "hooks": {"append_roofline": [5e-6, 3e-6]}}
    assert load_reader("append_roofline").read(rec) == pytest.approx(40.0)
    # no kernel event kept: nothing to read, never 0
    rec["roofline"] = {"kernels": {}}
    assert load_reader("append_roofline").read(rec) is None


def test_device_readers_read_nothing_without_device_events():
    s = trace.summarize([e for e in synthetic_trace()
                         if e["cat"] in ("user_annotation", "cpu_op")])
    rec = {"profile": s, "profile_launches": {}}
    for name in ("device_idle_pct", "launches_per_flush",
                 "sort_lookup_ms_per_flush"):
        assert load_reader(name).read(rec) is None


def test_union_merges_and_clips():
    assert trace.union([(5, 8), (0, 3), (2, 4), (9, 20)], 1, 10) == \
        [[1, 4], [5, 8], [9, 10]]
