"""One run of one cell: set-up, the measured window, the traced stretches,
the comparison with the reference, and the result line.

What the traffic does comes from its generator's ``Mix`` (``streams``):
the timed stream of one cycle, a preload for every new store, and whether
a cycle ends with a new store. The harness only feeds and times. The
window is a closed loop of one writer. Each flush is ``batch`` ops of the
cycle's stream, applied through ``LocalStore.apply(OpBatch.edges(...))``
and acknowledged by ``torch.cuda.synchronize()``; its host-clock time,
submit to acknowledgement, is one flush time. At a cycle's end the
store's counts are read and, where the mix re-makes, a new store is made
and preloaded, all timed apart from the flushes. The window closes at the
end of the cycle in which ``--seconds`` runs out, so it holds whole
cycles, and the store compared with the reference is always a whole
cycle's.

A traced run (``--trace 1``) profiles two stretches of flushes of the
first cycle, at the traffic's ``trace.at_cycle_share``: the first
untouched (device time, idle, launches, breakdown), the second with each
metric's ``HOOK`` reading what a kernel call needs before the call (the
rooflines take their kernels' device time from that stretch only, by
kernel name). Each stretch's trace is read as it ends, between flushes.
"""
from __future__ import annotations

import gc
import importlib
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np

from . import reference, streams, trace as trace_mod
from .spec import Cell

__all__ = ["run", "ControlStore", "program_answers", "gather"]


def gather(log: list) -> tuple:
    """The ops a store was given, from its log of ``(stream, lo, hi)``
    slices in order: (src_idx, dst_idx, weight) NumPy arrays."""
    parts = [(s.src_idx[lo:hi], s.dst_idx[lo:hi], s.weight[lo:hi])
             for s, lo, hi in log]
    if not parts:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    return tuple(np.concatenate(c) for c in zip(*parts))


class ControlStore:
    """The control: the reference put in the program's place, computed one
    precision step below the configuration's (bfloat16 weights for its
    float32). ``apply`` only counts ops; the answers are the reference's
    over the ops of the store's log."""

    precision = "bfloat16"

    def __init__(self, ids, log: list):
        self.ids, self.log = ids, log
        self.stats = {}

    def apply(self, batch):
        return SimpleNamespace(applied=len(batch), dropped=0)

    def answers(self, device="cpu") -> reference.Answers:
        return reference.expected(self.ids, *gather(self.log),
                                  self.precision, device)


def program_answers(store, query_ids, times: dict) -> reference.Answers:
    """The store's answers, read through ``LocalStore.read``: lookup of
    every queried ID, the two counts and the live pairs of its CSR
    snapshot, mapped to vertex IDs through the snapshot's row IDs (on the
    store's device). ``times`` gets each read's seconds."""
    import torch
    from repro_torch.api import ReadOp
    t = time.perf_counter()
    found = store.read(ReadOp("lookup", ids=query_ids))
    times["lookup_s"] = time.perf_counter() - t
    nv = store.read(ReadOp("num_vertices"))
    ne = store.read(ReadOp("num_edges"))
    t = time.perf_counter()
    snap = store.read(ReadOp("snapshot"))
    m = min(int(snap.m), snap.dst.shape[0])
    times["snapshot_s"] = time.perf_counter() - t
    counts = (snap.indptr[1:] - snap.indptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)[:m]
    row_id = reference.pair_keys(snap.ids[:, 0], snap.ids[:, 1])
    keys = reference.pair_keys(row_id[rows],
                               row_id[snap.dst[:m].to(torch.int64)])
    return reference.Answers(torch.from_numpy(np.asarray(found, bool)),
                             int(nv), int(ne), keys, snap.weight[:m])


def _counts(store, store_device) -> tuple:
    if isinstance(store, ControlStore):
        a = store.answers(device=store_device)
        return a.num_edges, a.num_vertices
    from repro_torch.api import ReadOp
    return (int(store.read(ReadOp("num_edges"))),
            int(store.read(ReadOp("num_vertices"))))


class _Hooks:
    """Each metric's ``HOOK`` installed on its program function for one
    stretch: the hook's value for every call lands in ``out[metric]``."""

    def __init__(self, readers: dict):
        self.hooks = [(name, *mod.HOOK) for name, mod in readers.items()
                      if getattr(mod, "HOOK", None)]
        self.out = defaultdict(list)
        self._orig = []

    def install(self):
        for name, modname, attr, fn in self.hooks:
            mod = importlib.import_module(modname)
            orig = getattr(mod, attr)
            self._orig.append((mod, attr, orig))

            def hooked(*a, _fn=fn, _orig=orig, _name=name, **k):
                self.out[_name].append(_fn(*a, **k))
                return _orig(*a, **k)
            setattr(mod, attr, hooked)

    def remove(self):
        for mod, attr, orig in reversed(self._orig):
            setattr(mod, attr, orig)
        self._orig = []


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False, wrap_store=None,
        t_start: float = None, log=None) -> dict:
    """One run of ``cell``. Returns the result object (the keys of the
    result line) with ``rec``, the records the metric readers read.
    ``control`` puts the reference in the program's place; ``wrap_store``
    wraps each store made (tests plant faults with it)."""
    import torch
    from repro_torch.api import OpBatch, make_store
    from repro_torch.core import edgepool
    from repro_torch.kernels import ops as kops

    t_start = time.perf_counter() if t_start is None else t_start
    say = log or (lambda msg: None)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config, traffic = cell.config, cell.traffic
    mix = streams.make_mix(config, traffic, seed, device, cell.here)
    ops = mix.ops
    B = int(config["store"]["batch"])
    F = len(ops) // B
    if F * B != len(ops) or F < 1:
        raise ValueError("a cycle must be a whole number of flushes")
    kwargs = dict(config["store"], device=device)

    def feed(store, ops_log, stream, lo, hi):
        """Apply ``stream[lo:hi]`` and note it in the store's log."""
        if ops_log and ops_log[-1][0] is stream and ops_log[-1][2] == lo:
            ops_log[-1] = (stream, ops_log[-1][1], hi)
        else:
            ops_log.append((stream, lo, hi))
        return store.apply(OpBatch.edges(stream.src[lo:hi],
                                         stream.dst[lo:hi],
                                         stream.weight[lo:hi]))

    def new_store(preload=True):
        """A new store, preloaded unless told not; its log; the ops it
        dropped."""
        ops_log = []
        store = ControlStore(mix.ids, ops_log) if control else \
            make_store("local", **kwargs)
        store = wrap_store(store) if wrap_store else store
        lost = 0
        pre = mix.preload if preload else None
        for lo in range(0, len(pre) if pre is not None else 0, B):
            lost += int(feed(store, ops_log, pre, lo,
                             min(lo + B, len(pre))).dropped)
        sync()
        return store, ops_log, lost

    # ---- set-up: the kernels and the flush path, warmed on a store that
    # is then dropped (and not preloaded: the window's store is); a traced
    # run also starts the profiler once
    store, ops_log, _ = new_store(preload=False)
    for f in range(min(int(traffic["warm_flushes"]), F)):
        feed(store, ops_log, ops, f * B, (f + 1) * B)
    sync()
    if trace:
        warm = trace_mod.Profile(cuda)
        torch.ones(1, device=device).add_(1)
        sync()
        warm.stop()
    del store
    gc.collect()
    store, ops_log, dropped = new_store()
    setup_s = time.perf_counter() - t_start

    # ---- the window: whole cycles
    P = int(traffic["trace"]["flushes"])
    at = max(0, min(int(F * traffic["trace"]["at_cycle_share"]), F - 2 * P))
    stretch = {at: "profile", at + P: "roofline"}
    hooks = _Hooks(cell.readers)
    prof, profiles, launches = None, {}, {}
    flush_s, cycles, cycle_logs = [], [], []
    n_ops = 0
    ingest_s = remake_s = 0.0
    spans = {"defrag_ms": 0.0, "ingest_ms": 0.0}   # unprofiled flushes
    syncs0 = dict(edgepool.SYNCS)
    f = cycle = 0
    t_w0 = time.perf_counter()
    while True:
        traced = trace and cycle == 0 and at <= f < at + 2 * P
        if traced and f in stretch:
            if stretch[f] == "roofline":
                hooks.install()
            l_before = kops.launch_counts()
            prof = trace_mod.Profile(cuda)
        d0 = store.stats.get("defrag_ms", 0.0)
        t = time.perf_counter()
        if traced:
            with torch.profiler.record_function(trace_mod.FLUSH):
                res = feed(store, ops_log, ops, f * B, (f + 1) * B)
                sync()
        else:
            res = feed(store, ops_log, ops, f * B, (f + 1) * B)
            sync()
        dt = time.perf_counter() - t
        flush_s.append(dt)
        ingest_s += dt
        n_ops += B
        dropped += int(res.dropped)
        if not traced:
            spans["ingest_ms"] += dt * 1e3
            spans["defrag_ms"] += store.stats.get("defrag_ms", 0.0) - d0
        f += 1
        if traced and f - P in stretch:
            prof.stop()
            kind = stretch[f - P]
            # read at once: the next session of the profiler drops the
            # device events of this one
            profiles[kind] = trace_mod.summarize(prof.events())
            launches[kind] = {k: v - l_before[k]
                              for k, v in kops.launch_counts().items()}
            if kind == "roofline":
                hooks.remove()
        if f < F:
            continue
        # ---- a cycle's end
        tc = time.perf_counter()
        ne, nv = _counts(store, device)
        rec_c = {"num_edges": ne, "num_vertices": nv}
        if trace and cycle == 0 and not control:
            rec_c["memory_bytes"] = int(store.graph.memory_bytes())
        cycles.append(rec_c)
        cycle_logs.append(tuple(ops_log))
        cycle += 1
        f = 0
        if time.perf_counter() - t_w0 >= seconds:
            break
        if mix.remake:
            del store
            store, ops_log, lost = new_store()
            dropped += lost
        remake_s += time.perf_counter() - tc
    window_s = time.perf_counter() - t_w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    syncs = {k: v - syncs0[k] for k, v in edgepool.SYNCS.items()}

    # ---- the comparison, after the window: the store's answers, then the
    # reference once the store is freed
    times = {}
    t_c = time.perf_counter()
    si, di, w = gather(ops_log)
    query = mix.ids[reference.touched(len(mix.ids), si, di)]
    got = (store.answers(device=device) if control
           else program_answers(store, query, times))
    del store
    gc.collect()
    times["program_reads_s"] = time.perf_counter() - t_c
    t_c = time.perf_counter()
    want = reference.expected(mix.ids, si, di, w, device=device)
    checks = {"dropped_ops": dropped, **reference.compare(got, want)}
    del got, want, si, di, w
    # each cycle's counts, against the reference over that store's ops
    counts = {}
    off = 0
    for c, c_log in zip(cycles, cycle_logs):
        sig = tuple((id(s), lo, hi) for s, lo, hi in c_log)
        if sig not in counts:
            a = reference.expected(mix.ids, *gather(c_log), device=device)
            counts[sig] = (a.num_edges, a.num_vertices)
        off += abs(c["num_edges"] - counts[sig][0]) + \
            abs(c["num_vertices"] - counts[sig][1])
    checks["cycle_counts_off"] = off
    times["reference_s"] = time.perf_counter() - t_c

    rec = {"setup_s": setup_s,
           "window": {"seconds": window_s, "flushes": len(flush_s),
                      "ops": n_ops, "ingest_s": ingest_s, "flush_s": flush_s,
                      "remake_s": remake_s, "cycles_done": len(cycles)},
           "counters": syncs, "spans": spans,
           "cycles": cycles, "hooks": dict(hooks.out),
           "device": {"memory_peak_bytes": int(peak)},
           "check_s": times}
    for kind, summary in profiles.items():
        rec[kind] = summary
        rec[kind + "_launches"] = launches[kind]
    prof_a = rec.get("profile") or {}
    if prof_a.get("launches"):
        say(f"trace: {prof_a['launches_kept']} of {prof_a['launches']} "
            "kernel launches have their kernel event in the trace "
            f"({100.0 * prof_a['launches_kept'] / prof_a['launches']}%)")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1 if cuda else 0, "memory_peak_bytes": int(peak)}
    out = {"correct": all(checks[c] <= reference.LIMITS[c] for c in checks),
           "attempted": n_ops, "failed": dropped, "metrics": metrics,
           "device": dev}
    if trace and prof_a:
        dev["busy_s"] = prof_a["busy_s"]
        dev["window_s"] = prof_a["window_s"]
        out["breakdown"] = {"device_ops": prof_a["device_ops"],
                            "idle_gaps": prof_a["idle_gaps"]}
    out["checks"] = {c: {"value": v, "limit": reference.LIMITS[c]}
                     for c, v in checks.items()}
    out["rec"] = rec
    return out
