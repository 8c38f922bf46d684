#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RadixGraph on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--ingest-ops 4194304] [--mixed-ops 1048576]
                          [--analytics-edges 2097152]
                          [--sharded-ops 786432] [--lm-requests 32]
                          [--parent DIR]

Phases (any failure raises and the script exits non-zero):

1. card: print the card's name and power limit; require CUDA;
2. build: compile every kernel of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and check each on a tiny input;
3. main path, through ``make_store("local", device="cuda")``, with state
   sized for SNAP soc-LiveJournal1 (4,847,571 vertices; n_max = 2^23, 2^23
   pool blocks of 16 entries): a powerlaw ingest stream, a mixed stream
   with 25% tombstones, one explicit rebuild, lookup / degree / neighbors
   for 4096 IDs and one snapshot. Launch counters are zeroed just before
   and read just after; a host numpy last-writer-wins oracle over the
   same stream checks the answers. Every rebuild must stream (hubs past
   ``dmax`` through the wide tier); each rebuild's path, ms and wide tier
   are printed;
   then the final state rebuilt from two copies, by the dense reference
   and by the streaming path: every leaf equal, both times printed;
4. kernels: each kernel against its plain PyTorch version on inputs taken
   from the main path's final state at main-path shapes (bit-exact):
   ``defrag_rows`` at every (rows, width) shape the path called and at
   the final state's wide tier; ``sort_lookup``'s latency floor from a
   separate pointer-chase kernel (one dependent load a layer) and from
   the same kernel on its first 1 .. l layers. Each
   row has two times: ``ms`` (= ``kernel_ms``), back-to-back wrapper calls
   between two CUDA events, host work included; and ``device_ms``, the
   hand-written kernels' own time per call from ``torch.profiler`` kernel
   events (PyTorch's own output fills apart; kernels per call from the
   wrapper's launch counter); ``graph_ms``, a CUDA graph of 20 calls
   replayed, per call, fills included. ``host_us`` is the wrapper's host
   time per call, ``loss_ms`` calls x (device ms - bound ms) over the
   main path's shapes (launches x for the kernels of one shape). With
   ``--parent DIR`` (a checkout of an earlier commit, e.g. from ``git
   archive``) every wrapper of that checkout with this one's name is
   timed on the same inputs, in turns (parent, this, this, parent);
   then ``torch.profiler`` over a few more batches (host ops, device
   busy share), one rebuild and one snapshot timed alone, and one more
   rebuild whose ``defrag_rows`` calls are timed alone on their inputs;
5. durability, on the main path's store wrapped in a ``DurableStore``
   (group commit 32; the directory under ``build/``, removed at the end;
   the phase fails first if the disk there holds under 3 x a full
   checkpoint): a full checkpoint, 2^18 mixed ops through the WAL, a
   checkpoint that must be a delta (one more segment first if a rebuild
   voided it), 2^16 ops left in the WAL; the WAL's share of the apply
   time and each checkpoint's bytes and ms (device-to-host copy,
   touched-block scan, CRC, write + fsync) are printed. Then recovery
   into a fresh store on the card, launch counters zeroed just before:
   read + CRC, host-to-device and replay timed, the replay's launches by
   kernel (``append``, ``compact_rows`` and ``sort_lookup`` must run, no
   rebuild may go dense); every state leaf equal to the live store's (the
   pool's entries on owned blocks: a delta leaves blocks vacated since
   its base with the base's bytes), and lookup / degree / neighbors of
   4096 IDs and ``num_edges`` equal. Then ``python -m
   repro_torch.storage.crash_smoke --device cuda`` at the same state size
   (2^17 ops in batches of 4096, group commit 8, a checkpoint every 10
   batches): the child dies by SIGKILL, prefix and resumed stream match
   a control store;
6. sharded path, after the main store is freed: ``make_store("sharded",
   device="cuda")`` with 4 shards on the one card (2^23 vertex rows and
   2^21 pool blocks of 16 a shard: the pools total the main path's), a
   prefix of the main path's stream (``--sharded-ops``: 3 x 2^18 of its
   5,242,880 ops, printed under ``reduced``) in ``apply`` calls of
   4096 ops, launch counters zeroed just before and read just after
   (``append``, ``compact_rows`` and ``sort_lookup`` must run; a rebuild
   must run, and every rebuild must stream); updates/s, the batches
   after which a rebuild ran, per-batch p50 / p99 ms, rebuilds per
   shard, route fallbacks, sync runs and skips, host syncs and launches
   per batch, the state's bytes by part, peak memory, each shard's row
   high-water mark; lookup / degree / neighbors of 4096 sampled source
   IDs (the host view's and the snapshots' builds timed apart),
   ``num_edges`` and ``num_vertices``, held to the host oracle over the
   ops applied; each kernel against its plain version (bit-exact) at
   every shape the phase called it with (rows x width for the
   compactions, ops for ``append``, keys for ``sort_lookup``), on inputs
   from a shard of the final state, each shape timed alone; then 2
   more batches under ``torch.profiler`` (sync share, device busy share,
   host ops per batch);
7. sharded analytics, on the sharded phase's final store before it is
   freed (``m_cap`` 2^21 and ``query_batch`` 64 a shard): a ``LocalStore``
   of the port on the card takes the same ops as the reference; bfs and
   sssp from the hub, pagerank (20 iterations, and to ``PR_ADVANCE_TOL``),
   wcc, bc over 8 sources (16 levels), khop k = 1, 2, 3 over 16 sources,
   the degree map, ``num_edges`` and a bfs from an absent source, each
   once through ``store.analytics_result`` (the program alone timed
   apart: device ms against host ms; iterations, host fetches, frontier
   and lookup launches), equal to the LocalStore's (PageRank and BC
   within 1e-5 relative) and to numpy/scipy (WCC: labels along
   out-edges, the store being directed); then advances of bfs, sssp,
   wcc, pagerank (tol), the degree map and ``num_edges`` over an
   insert-only delta of 4096 edges, each incremental and equal to a
   scratch run (PageRank in L1 to float64 iterations from the same
   seed). Launch counters are zeroed before and read after, less the
   reference's and the checks' launches; the frontier kernel and
   ``sort_lookup`` must have run. Then ``sort_lookup`` at every key
   count the sharded phase did not call (the dense route's 2^25 keys a
   shard among them) and the frontier kernel at the largest BFS level
   of a shard, each against its plain version (bit-exact), timed alone;
8. sharded durability, on that store (the analytics' reference freed):
   a ``DurableStore`` (group commit 32; the directory under ``build/``,
   removed at the end; the phase fails first if the disk there holds
   under 3 x the state): a full checkpoint, 2^17 mixed ops, a checkpoint
   that must be a delta, 2^15 ops left in the WAL; recovery into a fresh
   ``make_store("sharded")`` of the same spec, launch counters zeroed just
   before (``append``, ``compact_rows`` and ``sort_lookup`` must run, no
   rebuild may go dense); every leaf (the pool's entries on owned
   blocks), the sync watermark, reads of 4096 IDs, ``num_edges`` and
   ``num_vertices`` equal the live store's; both take 4 more batches and
   stay leaf-equal. Durable updates/s, the WAL's share, each
   checkpoint's bytes and ms by part, recovery ms by part, replay ops/s
   and launches are printed;
9. sharded service: a ``GraphQueryService`` with durable-ack over the
   recovered durable store: 8 write micro-batches of 4096 ops (fewer,
   and ``reduced`` printed, where the time so far projects past the
   script's limit), a 4096-ID degree query every step, bfs from the hub, wcc and PageRank
   (tol 1e-4) every 4th; at the last sealed epoch every answer equals a
   scratch ``analytics_result`` (PageRank: |a - b| / max(1, |b|) <=
   1e-5), a read submitted with a write answers from the previous epoch,
   ``durable_syncs`` counts the writing steps and the WAL scans back
   whole; ops/s, step p50 / p99 ms, incremental and scratch counts;
10. launch modes: ``python -m repro_torch.launch.dryrun_graph --mode
   persist``, ``--mode serve``, ``--mode ingest`` and ``--mode analytics
   --incremental --algs bfs,pagerank,wcc,sssp,bc`` at 4 shards, each a
   subprocess on the card, side by side: exit code 0, recovery
   bit-exact, no dropped op; the ingest record's all-to-all elements a
   shard equal the route buffer's (4 x its ``batch_per_shard`` rows of 6
   words), BFS's equal its levels' dense routes (4 x the record's
   ``n_cap`` rows of 3 words each), every other algorithm exchanged;
   each record's ``memory.argument_size_in_bytes`` equals its
   ``state_bytes`` (the mode's state) over 4; all four records; their
   launches join the
   ``kernels`` line (``launch_modes_launches``);
11. baselines at LiveJournal's vertex count (4,847,571 IDs from 2^32):
   ``HashIndex`` and ``TorchART`` (7.5 GB of tree; its insert is one
   ``art_insert`` launch) insert every ID and look up the n IDs and n
   absent ones, held to a host map, beside the port's SORT on the same
   IDs; the n-ID tree's nodes, dense rows and overflow equal a host count
   of its prefixes, and no row past them was written; ``art_insert``
   against its plain per-key loop on a 2^14-ID prefix (every
   ``ArtState`` tensor bit-exact, in trees of the n-ID tree's
   capacities; the plain loop runs on the CPU, and on the card on 256
   IDs); both indices on the card
   against their CPU runs at 2^16 IDs with repeats (the scatter winner
   rule); then ``benchmarks/torch_table5_sort_vs_art.py`` at scale 1;
12. analytics path, on a second store with the same LiveJournal-sized
   state, undirected, after the first is freed: 2^21 powerlaw edges
   (``--analytics-edges``; the CSR pad ``m_cap`` holds every edge the
   phase writes), then each of the nine registered analytics
   once through ``store.analytics_result`` (device and host time apart),
   checked against an independent numpy/scipy oracle; incremental
   advances over an insert-only delta of 4096 edges, each held to a
   scratch run (PageRank in L1, to the push's own guarantee); a
   ``GraphQueryService`` run of 16 write micro-batches with degree, bfs
   and wcc queries, held to scratch at its last sealed epoch. Launch
   counters are zeroed before and read after, less the launches of the
   runs made only to time or check; the frontier kernel must have run.
   Then the frontier kernel against its plain version on the largest BFS
   level's inputs (bit-exact);
13. whole-path parity at small size: the same stream with every kernel, and
   with every impl forced to its plain version, gives identical state,
   and bfs / khop give identical depths and counts; the same for the
   sharded engine (4 shards, route budget 64 so that the compacted route
   and its dense fallback both run, a budgeted vertex sync after each
   batch, the degree and snapshot reads, then bfs, khop k = 2, wcc and
   sssp with frontier budget 64): every stacked leaf and answer
   identical, and the plain run launches nothing;
14. LM serving (``repro_torch.serve.ServeEngine`` over
   ``repro_torch.models``): internlm2-1.8b at its published width in
   bf16 (1,889,110,016 params, random from ``--seed``), ``--lm-requests``
   requests (32; fewer, a multiple of 8, and ``reduced`` printed, where
   the time so far projects past the script's limit) with prompts of
   16-512 tokens and 32 new tokens each on 8 slots of 1,024, RadixKV
   blocks of 16: tokens/s, prefill ms a request and decode-step ms (p50 /
   p99, the first of each apart), RadixKV defrags, overflow and
   utilisation, the bf16 tokens against the train-mode forward
   teacher-forced (printed), and 8 decode steps under ``torch.profiler``
   (launches a step, the device's busy share, the step's bytes bound);
   it fails unless every request finishes with tokens in the vocabulary
   and finite logits, no admission overflows, a defrag runs and no graph
   kernel launches. Then the float32 gate at full width (TF32 off): 8
   requests of 16 new tokens on 4 slots, every served token equal to the
   teacher-forced argmax wherever its top-2 gap exceeds 4e-3, and a
   prefill plus 8 decode steps on a batch of 4 within rtol 2e-2 / atol
   2e-3 of the forward's logits;
15. ``lm_ssm``: mamba2-1.3b at its published width in bf16 (1,343,532,032
   params) through ``ServeEngine``: 16 requests (fewer, one a slot at the
   least, and ``reduced`` printed, where the time so far projects past
   the script's limit with the later phases at their floors) of 16-512
   tokens, 32 new each, 8 slots of 1,024: tokens/s, prefill and decode-step
   p50 / p99, the decode state's bytes a slot, the served tokens against
   the teacher-forced argmax from each request's admission state (the JAX
   engine's prefill reads a reused slot's conv tails), and 8 profiled
   decode steps (launches, busy share, the bytes bound: weights and the
   state read and written). The float32 gate (TF32 off; weights at a
   trained model's scale, 1/sqrt(fan-in): at the init's 1/sqrt(L) float32
   cannot hold a deep random model's answer), as ``lm_serve``'s: 8
   requests of 16 new tokens on 4 slots, each served token equal to the
   teacher-forced argmax from its admission state where the top-2 gap
   exceeds 4e-3 (the count that differs from the zero-state forward
   printed), then a batch-4 prefill and 8 decode steps within rtol 2e-2
   / atol 2e-3;
16. ``lm_hybrid``: recurrentgemma-9b the same way (9,396,088,832 params;
   8 slots with ``smax`` 4,096, so the attention cache is the 2,048-entry
   ring; prompts of 16-3,072 tokens, at least one past the window); its
   float32 gate on 4 requests after the bf16 model is freed;
17. ``lm_moe``: kimi-k2-1t-a32b at its published width, 1 of its 61
   layers (``reduced``; 19,378,623,488 params, 38.76 GB): 16 requests of
   16-512 tokens, 32 new each, 8 slots of 1,024; dropped (token, expert)
   pairs a prefill and a decode step, expert load (max / mean) and the
   aux loss from every MoE call's input, the decode step's bytes bound
   (the experts its tokens chose; beside it the dense dispatch's, every
   expert read). The gate: the first prefill's and a decode step's
   MoE inputs through ``layers.moe_ffn`` against a float32 loop over the
   experts on the card from the same bf16 weights (routing of its own on
   the host): expert choice, ranks and kept slots equal, the layer in
   float32 within rtol 2e-2 / atol 2e-3 of the output's scale, the layer
   as served (bf16) within rtol 2e-2 / atol 2e-2 of it. Then the same
   two inputs and layer-0 weights through ``models.moe_a2a.moe_ffn_a2a``
   on a stacked expert mesh of 8 (``make_local_mesh(data=8)``, tokens
   on the same axis: the prefill's batch of 8 = slots): each token's
   experts equal the dense dispatch's, the kept pairs equal a host count
   of the per-shard capacity, the layer (float32 / as served) within the
   same tolerances of the float32 loop run shard by shard at the
   per-shard capacity, the aux loss the mean of the per-shard losses;
   dropped pairs beside the dense dispatch's, and the a2a and dense
   layers' ms. Before the gate, the engine serves 8 more requests under
   ``set_rules(MOE_SERVE_RULES, mesh)`` (the a2a dispatch; fewer, or
   none, and ``reduced`` printed, where the time so far projects past the
   script's limit);
18. ``lm_encdec``: whisper-small at its published width (238,060,800
   params): 8 requests of 1,500 stub frame embeddings and decoder prompts
   of 4-64 tokens, each prefilled through ``model.prefill`` into its row,
   then 63 ``model.decode`` steps of the batch with ``enc_out``; at the
   init's scale the float32 encoder against float64 (``encdec_f64``,
   printed); the float32 gate (1/sqrt(fan-in)): 4 of them, every decode
   logit within rtol 2e-2 / atol 2e-3 of the train-mode forward on the
   same ``enc_out``.
   Each of 15-18 fails if a request does not finish, a token is outside
   the vocabulary, a logit is not finite, RadixKV overflows (15-17) or a
   graph kernel's launch counter moves;
19. ``lm_train`` (``repro_torch.launch.train``, ``repro_torch.train``):
   internlm2-1.8b at its published width, bf16 params and grads, float32
   AdamW moments, remat on; seq 4,096, a global batch of 4 as 2
   accumulated micro-batches of 2. ``launch.train.main`` trains 2 steps on
   the card; then, on a fresh state from ``--seed``, one warm step and 4
   timed steps through the same ``make_train_step`` (CUDA events; fewer,
   then a batch of 2, and ``reduced`` printed, where the time so far
   projects past the script's limit) and one step under
   ``torch.profiler``: step ms p50 / max, tokens/s, peak memory, the
   state's bytes, launches a step and the device's busy share, the FLOP
   bound (6 x params x tokens at 989 TFLOP/s) and its share of the step
   (``mfu``). The float32 gate: the same model cut to 2 layers
   (``reduced``), weights at 1/sqrt(fan-in), one step in float64 and one
   in float32 (TF32 off) on the same batch: the loss within 1e-5
   relative and every gradient leaf within 1e-4 (|g32 - g64| / |g64|);
   the bf16 step's loss printed beside. The SMOKE loop gates through
   ``launch.train.main``: the loss decreases over 120 steps, and a run
   checkpointed at 20 (under ``build/``) and resumed to 30 equals an
   uninterrupted one. Launch counters are zeroed before these parts and
   must read 0 after (synthetic tokens); then 3 SMOKE steps on ``--data
   graph`` (walks over a 4,096-row ``RadixGraph`` on the card) must
   launch ``append`` and ``sort_lookup``;
20. ``lm_dryrun`` (``repro_torch.launch.dryrun``: fake DTensors on a
   fake process group, nothing computed on any device): six cells, six
   subprocesses side by side after ``lm_train`` (no timed phase shares
   the host's cores with them): internlm2-1.8b x train_4k on the 16 x 16
   mesh, kimi-k2 x decode_32k on the 2 x 16 x 16 mesh, internlm2-1.8b
   on a 1 x 1 mesh at ``lm_train``'s batch and sequence, and on the 16 x
   16 mesh one cell a module that ``dist.local_ops`` writes per rank:
   kimi-k2 x train_4k (the dense MoE dispatch, at 1,024 positions),
   mamba2-1.3b x train_4k (the SSD chunk scan) and recurrentgemma-9b x
   prefill_32k (the RG-LRU scan and the ring cache's roll, at 4,096
   positions); each cut printed under ``reduced``.
   Each record must be ``ok`` (an op DTensor cannot place fails the
   cell: no figure is made up); kimi's must count all-to-all bytes (the
   ``moe_a2a`` dispatch); the 1 x 1 cell's argument bytes of params and
   of the optimizer state (AdamW m, v and count) must equal those that
   ``lm_train`` measured on the card. A cell still running when the
   script must end is stopped and printed under ``reduced``.

The ``kernels`` line gives each kernel's main-path ``launches``, the
durability replay's ``replay_launches``, the sharded phase's
``sharded_launches`` and the largest error of its sharded shapes
(``sharded_max_abs_err``, null where the phase did not call it), and the
sharded analytics' ``sharded_analytics_launches`` and
``sharded_analytics_max_abs_err``, the sharded recovery's
``sharded_replay_launches``, the sharded service's
``sharded_service_launches``, the launch modes' ingest and analytics
runs' ``launch_modes_launches`` and the graph-fed training run's
``train_launches``; each of the five TPU kernels'
entries has ``tpu_kernel`` true, and ``art_insert`` (a port of the JAX
function ``_art_insert``, no TPU kernel) follows with ``tpu_kernel``
false, its launches in the baselines phase and its times on the 2^14-ID
prefix. The last two lines are the ``kernels`` JSON object and the
``ok`` object.
Nothing here imports JAX or the ``repro`` package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

T_START = time.perf_counter()   # every printed line's ``t_s`` counts from here
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

LJ_VERTICES = 4_847_571          # SNAP soc-LiveJournal1
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM, non-tensor float32
TPU_KERNELS = {
    "append": ("src/repro_torch/kernels/csrc/append.cu",
               "src/repro/kernels/append.py:137"),
    "compact_rows": ("src/repro_torch/kernels/csrc/compact.cu",
                     "src/repro/kernels/compact.py:85"),
    "defrag_rows": ("src/repro_torch/kernels/csrc/compact.cu",
                    "src/repro/kernels/compact.py:230"),
    "sort_lookup": ("src/repro_torch/kernels/csrc/sort_lookup.cu",
                    "src/repro/kernels/sort_lookup.py:66"),
    "frontier_expand": ("src/repro_torch/kernels/csrc/frontier.cu",
                        "src/repro/kernels/frontier.py:57"),
}
INGEST_KERNELS = ("append", "compact_rows", "defrag_rows", "sort_lookup")
ANALYTICS_KERNELS = ("frontier_expand",)
SSSP_ITERS = 256        # Bellman-Ford stops early once nothing relaxes
DAMPING = 0.85
PR_TOL = 1e-7
# the residual push's work budget (32 m edge pushes) holds a 4096-edge
# advance at this tolerance on the LiveJournal-sized graph. At PR_TOL it
# does not: the push must bring the warm start's own L1 residual (the
# scratch loop stops on max|dpr|, not on L1) down to (1 - d) tol / 2,
# whatever the delta; ``analytics_advance`` prints both
PR_ADVANCE_TOL = 1e-4
LJ_N_MAX = 2 ** 23
LJ_POOL_BLOCKS = 2 ** 23
SERVICE_STEPS = 16
DELTA_EDGES = 4096
# the main path's store: state sized for SNAP soc-LiveJournal1
LJ_STORE = dict(device="cuda", n_max=LJ_N_MAX, expected_n=LJ_VERTICES,
                key_bits=32, pool_blocks=LJ_POOL_BLOCKS, block_size=16)
# the durability phase: ops applied through the durable store before the
# delta checkpoint, ops left in the WAL only, the group commit, and the
# crash smoke's cut stream (a checkpoint every 10 of its 32 batches)
DURABLE_OPS = 1 << 18
WAL_ONLY_OPS = 1 << 16
GROUP_COMMIT = 32
CRASH_ARGS = ["--scale", "lj", "--ops", str(1 << 17), "--batch", "4096",
              "--group-commit", "8"]


def say(tag, **kw):
    print(json.dumps({"phase": tag, **kw,
                      "t_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# stream and oracle (host, numpy)
# --------------------------------------------------------------------------

def powerlaw_stream(rng, n_vertices, n_ops, ids=None):
    """``benchmarks/common.edge_stream`` shape: IDs drawn from 2^32 without
    replacement, endpoints chosen with p ~ rank^-0.8. Returns endpoint
    INDICES into ``ids`` (the oracle works on indices)."""
    if ids is None:
        ids = rng.choice(2 ** 32, size=n_vertices, replace=False).astype(
            np.uint64)
    p = 1.0 / np.arange(1, n_vertices + 1) ** 0.8
    p /= p.sum()
    si = rng.choice(n_vertices, n_ops, p=p)
    di = rng.choice(n_vertices, n_ops, p=p)
    return ids, si, di


def oracle(n_vertices, si, di, w):
    """Last writer wins per (src, dst); tombstones (w == 0) delete.
    Returns the live pairs (src idx, dst idx, weight)."""
    key = si.astype(np.int64) * n_vertices + di.astype(np.int64)
    rev = key[::-1]
    uk, first_rev = np.unique(rev, return_index=True)
    last = len(key) - 1 - first_rev
    lw = w[last]
    live = lw != 0
    return si[last][live], di[last][live], lw[live]


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def leaves(tree):
    """Tensors of a (nested) NamedTuple state, in order."""
    out = []
    for x in tree:
        out.extend(leaves(x) if isinstance(x, tuple) else [x])
    return out


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def cuda_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, launched, reps=20):
    """The kernels' own time on the card per call of ``fn``, from the
    kernel events of a ``torch.profiler`` trace of ``reps`` calls: for the
    hand-written kernels (``device_ms``) and, apart, for PyTorch's own
    (``torch_kernels_ms``: the wrapper's output fills). ``launched()``
    reads the wrapper's launch counter: its rise over the traced calls
    gives the hand-written kernels per call exactly (a wide
    ``defrag_rows`` call runs its merge kernel once per pass), and the
    share of their events the trace kept (CUPTI may drop some, and
    ``graph_ms`` checks the mean). ``device_ms`` is the mean kept event
    times the kernels per call, and each kernel's share of it
    (``device_ms_by_kernel``) its kept time over the kept share. A trace
    that kept none of them is taken again, up to five in all
    (``profiler_traces``): in two runs on the H100 with the sharded phase
    before the analytics, the frontier kernel's one trace kept no event.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for traces in range(1, 6):      # a trace that kept no event is retaken
        n0 = launched()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = (launched() - n0) / reps
        ours, theirs = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and \
                    not e.name.startswith(("Memcpy", "Memset")):
                by = theirs if "at::" in e.name else ours
                by.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if ours:
            break
    if not ours or per <= 0:
        raise AssertionError("the profiler saw no kernel on the card "
                             f"in {traces} traces")
    kept = sum(map(len, ours.values())) / (reps * per)
    fills = sum(sum(v) / len(v) * max(1, round(len(v) / reps))
                for v in theirs.values()) / 1e3
    return dict(device_ms=sum(map(sum, ours.values())) / (reps * kept) / 1e3,
                kernels_per_call=per,
                device_ms_by_kernel={k.split("(")[0]: sum(v) / (reps * kept)
                                     / 1e3 for k, v in ours.items()},
                profiler_events_kept=kept, profiler_traces=traces,
                torch_kernels_ms=fills)


def graph_ms(fn, calls=20, replays=10):
    """Device time per call of ``fn`` with no host work between calls:
    ``calls`` calls captured once in a CUDA graph, the graph replayed
    ``replays`` times between two CUDA events. Every kernel of a call is
    in it, PyTorch's output fills included."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (replays * calls)
    g.reset()
    return ms


def timings(fn, launched):
    """Every time of one kernel row: call ms (CUDA events around
    back-to-back calls), the profiler's kernel times, and the graph's."""
    return dict(call_ms=cuda_ms(fn), **device_ms(fn, launched),
                graph_ms=graph_ms(fn))


def device_busy_us(prof):
    """Device time of a trace: the sum over its device-side events. (The
    sum of self device time over ``key_averages()`` counts each kernel
    twice, on its own event and on the CPU event that launched it.)"""
    from torch.autograd import DeviceType
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)


def load_parent(root):
    """A lookup ``(module, function) -> wrapper`` into the kernel package
    of the checkout at ``root`` (an earlier commit), imported as package
    ``parent_repro_torch`` beside this checkout's ``repro_torch``, with
    every kernel source it has built. The lookup gives None for a wrapper
    the parent does not have."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_repro_torch"] = mod
    spec.loader.exec_module(mod)
    build = importlib.import_module("parent_repro_torch.kernels._build")
    say("parent_build", root=root, per_source=build.build())

    def lookup(module, fn):
        try:
            m = importlib.import_module(f"parent_repro_torch.kernels.{module}")
        except ImportError:
            return None
        return getattr(m, fn, None)
    return lookup


def wrappers(parent, module, fn, *args, **kw):
    """Calls of this checkout's wrapper ``kernels.<module>.<fn>`` on
    ``args``, and of the parent's of the same name (None without a parent
    or when it lacks the wrapper)."""
    import importlib
    this = getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                   fn)
    old = parent(module, fn) if parent else None
    return (lambda: this(*args, **kw)), \
        (None if old is None else lambda: old(*args, **kw))


def probe_work(dst, pstart, psize, pv):
    """What the append probes of this data read: the entries probed (each
    enabled probe's extent, inside the pool), those matching their probe's
    destination, and the probes with a match (a winner each)."""
    import torch
    flat_dst = dst.reshape(-1)
    on = torch.nonzero((pstart >= 0) & (pv >= 0) & (psize > 0)).flatten()
    reps = psize[on].long()
    q = torch.repeat_interleave(on, reps)
    first = torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps)
    e = torch.arange(q.numel(), device=dst.device) - first
    flat = pstart[q].long() * dst.shape[1] + e
    inside = flat < flat_dst.numel()
    hit = inside & (flat_dst[flat.clamp(max=flat_dst.numel() - 1)] == pv[q])
    return (int(inside.sum()), int(hit.sum()),
            int(torch.unique(q[hit]).numel()))


def row_work(dst, size, w):
    """What a row compactor needs of these rows: the occupied entries
    (positions below size, up to the width), the last writers (one per
    distinct valid dst of a row) and the survivors (last writers with a
    non-zero weight); also the most entries one dst holds in one row (the
    hash path's contention)."""
    import torch
    K, D = dst.shape
    pos = torch.arange(D, device=dst.device)
    occ = pos[None, :] < size.clamp(0, D)[:, None]
    valid = occ & (dst >= 0) & (dst < 2 ** 30)
    key = torch.arange(K, device=dst.device)[:, None] * 2 ** 30 + dst
    key = torch.where(valid, key, -1)
    # the last writer of a (row, dst) is its highest valid position
    flat, fpos = key.reshape(-1), pos.expand(K, D).reshape(-1)
    uk, inv, reps = torch.unique(flat, return_inverse=True,
                                 return_counts=True)
    top = torch.full((uk.numel(),), -1, dtype=torch.long,
                     device=dst.device)
    top.scatter_reduce_(0, inv, fpos, "amax")
    is_last = valid.reshape(-1) & (fpos == top[inv])
    alive = is_last & (w.reshape(-1) != 0)
    most = int(reps[uk >= 0].max()) if bool((uk >= 0).any()) else 0
    return int(occ.sum()), int(is_last.sum()), int(alive.sum()), most


def next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


TIMES = ("call_ms", "device_ms", "torch_kernels_ms", "graph_ms")


def kernel_entry(torch, name, shape, kerns, plain, check, nbytes, nops):
    """Hold a kernel against its plain version (``check`` returns both
    outputs), time its calls, its kernels and a graph of its calls, time
    the plain version, and compute the bound from the bytes and operations
    these inputs need. ``kerns`` is (this wrapper's call, the parent's or
    None): the parent's is held to this one's output and timed in turns
    with it (parent, this, this, parent)."""
    from repro_torch.kernels import ops as kops
    kern, old = kerns
    out_k, out_p = check()
    match = len(out_k) == len(out_p) and all(
        torch.equal(x, y) for x, y in zip(out_k, out_p))
    err = max_abs_err(out_k, out_p)   # raises when they differ
    c0, h0 = kops.call_counts()[name], kops.host_ns()[name]
    ms = cuda_ms(kern)
    host_us = (kops.host_ns()[name] - h0) / 1e3 / max(
        1, kops.call_counts()[name] - c0)
    launched = (lambda: kops.launch_counts()[name])
    t = dict(call_ms=ms, **device_ms(kern, launched), graph_ms=graph_ms(kern))
    extra = {}
    if old is not None:
        out_par = old()
        out_par = list(out_par) if isinstance(out_par, tuple) else [out_par]
        max_abs_err(out_par, out_k[:len(out_par)])
        parent_counts = sys.modules["parent_repro_torch.kernels._build"]
        old_launched = (lambda: parent_counts.LAUNCHES[name])
        p1 = timings(old, old_launched)
        t2 = timings(kern, launched)
        p2 = timings(old, old_launched)
        extra["parent"] = dict(
            {k: [p1[k], p2[k]] for k in TIMES},
            kernels_per_call=p1["kernels_per_call"],
            **{f"this_{k}": [t[k], t2[k]] for k in TIMES})
        t.update({k: (t[k] + t2[k]) / 2 for k in TIMES})
    pms = cuda_ms(plain, reps=5, warm=1)
    bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
    return dict(name=name, shape=shape, match=match, max_abs_err=err,
                ms=t["call_ms"], device_ms=t["device_ms"],
                torch_kernels_ms=t["torch_kernels_ms"],
                graph_ms=t["graph_ms"],
                kernels_per_call=t["kernels_per_call"],
                device_ms_by_kernel=t["device_ms_by_kernel"],
                profiler_events_kept=t["profiler_events_kept"],
                profiler_traces=t["profiler_traces"],
                host_us=host_us, plain_ms=pms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
                nops / F32_OPS_PER_S else "operations",
                bytes=int(nbytes), library_ms=None, **extra)


MS_IS = ("ms = kernel_ms: back-to-back wrapper calls between CUDA events; "
         "device_ms: the hand-written kernels' own time per call, "
         "torch.profiler kernel events, the mean kept event times the "
         "kernels per call that the wrapper counted (PyTorch's output "
         "fills apart, in torch_kernels_ms); graph_ms: a CUDA graph of "
         "20 calls replayed, per call, fills included; host_us: the "
         "wrapper's host time per call")


def kernel_line(name, row, launches, loss=None):
    src, replaces = TPU_KERNELS[name]
    line = dict(name=name, route="cuda", tpu_kernel=True, source=src,
                replaces=replaces, launches=launches, match=row["match"],
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                kernel_ms=row["ms"], device_ms=row["device_ms"],
                torch_kernels_ms=row["torch_kernels_ms"],
                graph_ms=row["graph_ms"], host_us=row["host_us"],
                kernels_per_call=row["kernels_per_call"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                shape=row["shape"], ms_is=MS_IS)
    line["loss_ms"] = launches * (row["device_ms"] - row["bound_ms"]) \
        if loss is None else loss
    return line


def shape_loss(name, entries, tally):
    """calls x (device ms - bound ms) summed over the main path's calls of
    ``name`` by row shape (``tally``), for the shapes measured; the device
    ms summed over the same calls; those calls; and the calls at shapes
    not measured."""
    by = {tuple(e["shape"]): e for e in entries if e["name"] == name}
    loss, dev, measured, unmeasured = 0.0, 0.0, 0, 0
    for (n, *shape), calls in tally.items():
        if n != name:
            continue
        e = by.get(tuple(shape))
        if e is None:
            unmeasured += calls
        else:
            e["path_calls"] = calls
            e["loss_ms"] = calls * (e["device_ms"] - e["bound_ms"])
            loss += e["loss_ms"]
            dev += calls * e["device_ms"]
            measured += calls
    return loss, dev, measured, unmeasured


def max_abs_err(xs, ys):
    import torch
    err = 0.0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, float((x.double() - y.double()).abs().max()))
        if not torch.equal(x, y):
            raise AssertionError(f"kernel and plain version differ "
                                 f"(max abs err {err})")
    return err


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import append as ka, compact as kc, \
        frontier as kf, sort_lookup as ks
    t0 = time.perf_counter()
    chase = start_chase_build()
    secs = _build.build()
    chase_lib = chase()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        per_source={k: round(v, 3) for k, v in secs.items()},
        build_dir=str(_build.build_dir()))
    for name in _build.SOURCES:
        log = (_build.build_dir() / f"{name}.ptxas.txt")
        if log.exists():
            lines = [ln for ln in log.read_text().splitlines()
                     if "Compiling entry" in ln or "registers" in ln or
                     "spill" in ln]
            say("ptxas", source=name, report=lines[:48])
    # tiny first launch of each kernel, held against its plain version
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    d = torch.randint(-1, 20, (3, 40), generator=g, dtype=torch.int32)
    w = torch.randint(0, 3, (3, 40), generator=g).float()
    t = torch.randperm(120, generator=g).reshape(3, 40).to(torch.int32)
    z = torch.tensor([40, 17, 0], dtype=torch.int32)
    args = [x.to(dev) for x in (d, w, t, z)]
    max_abs_err(kc.compact_rows(*args), kc.compact_rows_plain(*args))
    max_abs_err(kc.defrag_rows(*args), kc.defrag_rows_plain(*args))
    max_abs_err(kc.defrag_rows(*args, keep_all=True),
                kc.defrag_rows_plain(*args, keep_all=True))
    # rows past one block's sort: sorted runs in device memory, merged
    d = torch.randint(-1, 4000, (2, 20000), generator=g, dtype=torch.int32)
    w = torch.randint(0, 3, (2, 20000), generator=g).float()
    t = torch.randperm(40000, generator=g).reshape(2, 20000).to(torch.int32)
    z = torch.tensor([20000, 300], dtype=torch.int32)
    args = [x.to(dev) for x in (d, w, t, z)]
    for keep_all in (False, True):
        max_abs_err(kc.defrag_rows(*args, keep_all=keep_all),
                    kc.defrag_rows_plain(*args, keep_all=keep_all))
    pools = [torch.tensor([0, -1, 1, -1], dtype=torch.int32, device=dev),
             torch.tensor([5, 6, -1, 7], dtype=torch.int32, device=dev)]
    keys = torch.tensor([[0, 0], [0, 1], [0, 2], [0, 3]], dtype=torch.int64,
                        device=dev)
    kw = dict(fanout_bits=(1, 1), bit_offsets=(1, 0))
    max_abs_err([ks.sort_lookup(pools, keys, **kw)],
                [ks.sort_lookup_plain(pools, keys, **kw)])
    pd = torch.full((8, 4), -1, dtype=torch.int32, device=dev)
    pd[0, :3] = torch.tensor([2, 3, 2], dtype=torch.int32)
    pw = torch.ones((8, 4), device=dev)
    pt = torch.arange(32, dtype=torch.int32, device=dev).reshape(8, 4) + 1
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    ops = (i32([0, 1]), i32([3, 0]), torch.tensor([True, True], device=dev),
           i32([2, 9]), torch.tensor([0.0, 2.0], device=dev), i32([50, 51]),
           i32([0, 0, -1]), i32([3, 3, 0]), i32([2, 4, 1]))
    a = [x.clone() for x in (pd, pw, pt)]
    b = [x.clone() for x in (pd, pw, pt)]
    wa = ka.append_edges(*a, *ops)
    wb = ka.append_edges_plain(*b, *ops)
    max_abs_err([wa, *a], [wb, *b])
    fargs = (i32([0, 1, -1, 40]), i32([[1, 2], [3, 70], [4, 5], [6, 7]]),
             torch.ones((4, 2), dtype=torch.bool, device=dev), i32([3, 0]),
             i32([2, 0]))
    max_abs_err([kf.frontier_expand(*fargs)],
                [kf.frontier_expand_plain(*fargs)])
    from repro_torch.baselines import TorchART
    arts = [TorchART(n_max=64, key_bits=16, device=d) for d in (dev, "cpu")]
    small = np.arange(48, dtype=np.uint64) * 1361 % 65536
    for a in arts:
        a.insert(small, np.arange(48))
    art_states_equal(arts[0].state, arts[1].state, "art_insert (build)")
    torch.cuda.synchronize()
    say("build_check", ok=True)
    return chase_lib


def tally_shapes(mod, names, tally, arg=0):
    """Count the calls of ``mod``'s functions ``names`` by the shape of
    their argument ``arg`` into ``tally`` (keys (name, *shape)); returns
    the function that puts the originals back."""
    orig = {n: getattr(mod, n) for n in names}

    def counted(n, f):
        def g(*a, **k):
            key = (n, *a[arg].shape)
            tally[key] = tally.get(key, 0) + 1
            return f(*a, **k)
        return g
    for n, f in orig.items():
        setattr(mod, n, counted(n, f))
    return lambda: [setattr(mod, n, f) for n, f in orig.items()]


def lj_stream(args):
    """The main path's stream from ``--seed``: 2^22 powerlaw inserts, then
    2^20 mixed ops with 25% tombstones. Returns the generator (its state
    after the stream) with the IDs, endpoint indices and weights."""
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    ids, si, di = powerlaw_stream(rng, LJ_VERTICES, args.ingest_ops)
    _, msi, mdi = powerlaw_stream(rng, LJ_VERTICES, args.mixed_ops, ids)
    w_in = rng.uniform(0.5, 2.0, args.ingest_ops).astype(np.float32)
    w_mx = rng.uniform(0.5, 2.0, args.mixed_ops).astype(np.float32)
    w_mx[rng.random(args.mixed_ops) < 0.25] = 0.0
    say("stream", seconds=round(time.perf_counter() - t0, 3),
        ingest_ops=args.ingest_ops, mixed_ops=args.mixed_ops,
        vertices=LJ_VERTICES, seed=args.seed)
    return rng, ids, si, di, w_in, msi, mdi, w_mx


def phase_main(args, torch, stream):
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.core import edgepool as ep
    from repro_torch.kernels import compact as kc, ops as kops

    rng, ids, si, di, w_in, msi, mdi, w_mx = stream

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = make_store("local", **LJ_STORE)
    g = store.graph
    torch.cuda.synchronize()
    say("store", seconds=round(time.perf_counter() - t0, 3),
        fanout_bits=list(g.sort_spec.fanout_bits),
        sort_pool_bytes=nbytes(g.state.sort),
        vertex_table_bytes=nbytes(g.state.vt),
        edge_pool_bytes=nbytes(g.state.pool),
        batch=g.batch, dmax=g.dmax, k_max=g.k_max, k_big=g.k_big,
        pipeline_depth=g.pipeline_depth)

    B = g.batch
    tally = {}       # row-compactor calls by shape, for the loss split
    untally = tally_shapes(kc, ("compact_rows", "defrag_rows"), tally)
    kops.reset_launch_counts()
    s0 = dict(ep.SYNCS)
    lat = []
    rebuild_ms = {"defrag_stream": 0.0, "defrag_dense": 0.0}
    rebuilds = []    # one record per rebuild, in order

    def timed_rebuilds(fn, cause):
        """Run ``fn`` and add the rebuild time it paid (the facade's
        ``defrag_ms``: the whole batch that paid it) to the bucket of the
        rebuild path it took, with a record of the rebuild."""
        before, ms0 = dict(ep.SYNCS), g.defrag_ms
        out = fn()
        for path in rebuild_ms:
            if ep.SYNCS[path] > before[path]:
                rebuild_ms[path] += g.defrag_ms - ms0
                wide = ep.SYNCS["defrag_wide"] > before["defrag_wide"]
                width, rows = (ep.DEFRAG_WIDE["width"],
                               ep.DEFRAG_WIDE["rows"]) if wide else (None, 0)
                rebuilds.append(dict(cause=cause, path=path,
                                     ms=g.defrag_ms - ms0, wide_width=width,
                                     wide_rows=rows))
        return out

    def run(si_, di_, w_, tag, rebuild_after=None):
        t_start = time.perf_counter()
        for lo in range(0, len(si_), B):
            hi = min(lo + B, len(si_))
            t = time.perf_counter()
            res = timed_rebuilds(lambda: store.apply(OpBatch.edges(
                ids[si_[lo:hi]], ids[di_[lo:hi]], w_[lo:hi])), "traffic")
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
            if res.dropped:
                raise AssertionError(f"{tag}: {res.dropped} ops dropped")
            if rebuild_after is not None and hi == rebuild_after:
                # one maintenance rebuild while every extent still fits
                # dmax: the streaming (defrag_rows) path
                before = ep.SYNCS["defrag_stream"]
                timed_rebuilds(g.defrag, "explicit")
                if ep.SYNCS["defrag_stream"] == before:
                    raise AssertionError("explicit rebuild did not stream")
        return time.perf_counter() - t_start

    t_ing = run(si, di, w_in, "ingest", rebuild_after=min(8 * B,
                                                          args.ingest_ops))
    t_mix = run(msi, mdi, w_mx, "mixed")

    # reads for 4096 distinct source IDs of the stream, drawn uniformly
    sample = np.sort(rng.choice(np.unique(np.concatenate([si, msi])), 4096,
                                replace=False))
    q = ids[sample]
    t0 = time.perf_counter()
    found = store.read(ReadOp("lookup", ids=q))
    deg = store.read(ReadOp("degree", ids=q))
    nbrs = store.read(ReadOp("neighbors", ids=q))
    torch.cuda.synchronize()
    t_reads = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = store.read(ReadOp("snapshot"))
    m_snap = int(snap.m)
    t_snap = time.perf_counter() - t0
    n_edges = store.read(ReadOp("num_edges"))
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    calls = kops.call_counts()
    host_ns = kops.host_ns()
    untally()
    syncs = {k: ep.SYNCS[k] - s0[k] for k in s0}
    peak = torch.cuda.max_memory_allocated()
    # every rebuild streams: the wide tier takes hubs past dmax
    if syncs["defrag_dense"] or any(r["path"] != "defrag_stream"
                                    for r in rebuilds):
        raise AssertionError(f"a rebuild took the dense path: {rebuilds}")

    vt_f = g.state.vt
    sz_final = torch.where((vt_f.del_time == 0) & (vt_f.start_block >= 0),
                           vt_f.size, 0)

    # ---- checks against the host oracle ----
    t0 = time.perf_counter()
    osrc, odst, ow = oracle(LJ_VERTICES, np.concatenate([si, msi]),
                            np.concatenate([di, mdi]),
                            np.concatenate([w_in, w_mx]))
    m = len(osrc)
    if not (n_edges == m_snap == m):
        raise AssertionError(f"edge count: num_edges {n_edges}, snapshot "
                             f"{m_snap}, oracle {m}")
    odeg = np.bincount(osrc, minlength=LJ_VERTICES)
    if not found.all():
        raise AssertionError("a sampled source vertex is missing")
    # reads scan at most ``dmax`` entries of an edge array (the JAX
    # package's read width); a vertex whose array is longer is answered
    # from its first dmax entries, so only those within it are checked
    offs = torch.from_numpy(g.lookup(q)).to(g.device).long()
    within = (g.state.vt.size[offs] <= g.dmax).cpu().numpy()
    if within.mean() < 0.9:
        raise AssertionError("too few sampled vertices within the read width")
    if not np.array_equal(deg[within], odeg[sample][within]):
        raise AssertionError("degree disagrees with the oracle")
    order = np.argsort(osrc, kind="stable")
    starts = np.searchsorted(osrc[order], sample)
    for j, v in enumerate(sample):
        if not within[j]:
            continue
        e = order[starts[j]:starts[j] + odeg[v]]
        exp = dict(zip(ids[odst[e]].tolist(), ow[e].tolist()))
        got = dict(zip(nbrs[j][0].tolist(), nbrs[j][1].tolist()))
        if got != exp:
            raise AssertionError(f"neighbors of {int(q[j])} disagree")
    t_oracle = time.perf_counter() - t0
    for k in INGEST_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    n_batches = len(lat)
    total_ops = args.ingest_ops + args.mixed_ops
    say("main_path", card=card_line(), live_edges=m,
        vertices=int(store.read(ReadOp("num_vertices"))),
        updates_per_s=total_ops / (t_ing + t_mix),
        ingest_updates_per_s=args.ingest_ops / t_ing,
        mixed_updates_per_s=args.mixed_ops / t_mix,
        batch_p50_ms=float(np.percentile(lat, 50)),
        batch_p99_ms=float(np.percentile(lat, 99)),
        batches=n_batches, defrags=g.num_defrags,
        defrag_ms=g.defrag_ms, defrag_stream=syncs["defrag_stream"],
        defrag_dense=syncs["defrag_dense"],
        defrag_stream_ms=rebuild_ms["defrag_stream"],
        defrag_dense_ms=rebuild_ms["defrag_dense"],
        defrag_wide=syncs["defrag_wide"], rebuilds=rebuilds,
        widest_extent_final=int(sz_final.max()),
        widest_wide_tier=max([r["wide_width"] or 0 for r in rebuilds]),
        batch_max_ms=float(np.max(lat)),
        host_branch_syncs_per_batch=syncs["host_syncs"] / n_batches,
        reads_checked=int(within.sum()),
        reads_4096_s=t_reads, snapshot_s=t_snap,
        peak_memory_bytes=peak, oracle_check_s=t_oracle,
        launches=launches, calls=calls, host_us_per_call={
            k: host_ns[k] / 1e3 / calls[k] for k in calls if calls[k]},
        compactor_calls_by_shape={"x".join(map(str, k)): v
                                  for k, v in tally.items()},
        oracle="agrees")
    return store, ids, sample, launches, tally


def phase_rebuild_check(store, torch):
    """The main path's final state rebuilt from two copies: by the dense
    reference (``_defrag_dense``, a full-pool lexsort in plain PyTorch) and
    by the streaming path (``defrag``: size segments and the wide tier
    through ``defrag_rows``). Every leaf of the two must be equal. Returns
    the streaming rebuild's ``defrag_rows`` calls by shape."""
    from repro_torch.core import edgepool as ep
    from repro_torch.kernels import compact as kc
    g = store.graph
    spec, st = g.pool_spec, g.state
    tally = {}       # the streaming rebuild's defrag_rows calls by shape

    def copy(nt):
        return type(nt)(*[x.clone() for x in nt])

    out, ms, took = {}, {}, {}
    for path in ("dense", "stream"):
        pool, vt = copy(st.pool), copy(st.vt)
        torch.cuda.synchronize()
        s0 = dict(ep.SYNCS)
        t0 = time.perf_counter()
        if path == "dense":
            out[path] = ep._defrag_dense(spec, pool, vt,
                                         torch.zeros_like(vt.size))
        else:
            untally = tally_shapes(kc, ("defrag_rows",), tally)
            out[path] = ep.defrag(spec, pool, vt)
            untally()
        torch.cuda.synchronize()
        ms[path] = (time.perf_counter() - t0) * 1e3
        took[path] = {k: ep.SYNCS[k] - s0[k] for k in s0}
    if took["stream"]["defrag_stream"] != 1 or \
            took["stream"]["defrag_dense"] != 0:
        raise AssertionError(f"the streaming rebuild did not stream: "
                             f"{took['stream']}")
    la, lb = leaves(out["dense"]), leaves(out["stream"])
    if len(la) != len(lb) or not all(torch.equal(a, b)
                                     for a, b in zip(la, lb)):
        raise AssertionError("streaming and dense rebuilds of the final "
                             "state differ")
    vt = st.vt
    sz = torch.where((vt.del_time == 0) & (vt.start_block >= 0), vt.size, 0)
    say("rebuild_check", card=card_line(), identical=True, leaves=len(la),
        dense_ms=ms["dense"], stream_ms=ms["stream"],
        wide_tier=took["stream"]["defrag_wide"] == 1,
        wide_width=ep.DEFRAG_WIDE["width"], wide_rows=ep.DEFRAG_WIDE["rows"],
        widest_extent=int(sz.max()),
        extents_past_dmax=int((sz > spec.dmax).sum()),
        occupied_entries=int(sz.sum()),
        live_m=int(out["stream"][0].live_m))
    del out
    return tally


def rows_by_size(sz, lo, hi, k, gen):
    """``k`` random rows whose size ``sz`` is in (lo, hi], -1 past the
    rows there are."""
    import torch
    cand = torch.nonzero((sz > lo) & (sz <= hi)).flatten()
    cand = cand[torch.randperm(cand.numel(), device=sz.device,
                               generator=gen)[:k]]
    u = torch.full((k,), -1, dtype=torch.int32, device=sz.device)
    u[:cand.numel()] = cand.to(torch.int32)
    return u


def live_sizes(vt):
    """Each row's extent size, 0 for rows deleted or without an extent."""
    import torch
    return torch.where((vt.del_time == 0) & (vt.start_block >= 0), vt.size, 0)


def sort_lookup_case(record, sort, sspec, keys, old=None):
    """``sort_lookup`` of ``keys`` on the SORT pools ``sort``; returns its
    keyword arguments."""
    import torch
    from repro_torch.core.keys import extract_bits
    from repro_torch.kernels import sort_lookup as ks
    kw = dict(fanout_bits=sspec.fanout_bits, bit_offsets=sspec.bit_offsets)
    pools, dev = sort.pools, keys.device
    # loads this data needs: one per layer the descent reaches
    node = torch.zeros(keys.shape[0], dtype=torch.int32, device=dev)
    alive = torch.ones(keys.shape[0], dtype=torch.bool, device=dev)
    loads = 0
    for pool, a, boff in zip(pools, *kw.values()):
        loads += int(alive.sum())
        slot = node * (1 << a) + extract_bits(keys, boff, a)
        child = pool[slot.clamp(0, pool.shape[0] - 1).long()]
        alive = alive & (child >= 0)
        node = child.clamp_min(0)
    record("sort_lookup", [keys.shape[0], 2],
           wrappers(old, "sort_lookup", "sort_lookup", pools, keys, **kw),
           lambda: ks.sort_lookup_plain(pools, keys, **kw),
           lambda: ([ks.sort_lookup(pools, keys, **kw)],
                    [ks.sort_lookup_plain(pools, keys, **kw)]),
           keys.numel() * 8 + loads * 4 + keys.shape[0] * 4,
           loads * 4)
    return kw


def append_case(record, st, spec, off, old=None):
    """``append`` of one op per vertex row of ``off`` at its next free
    slot, with a probe of each row's whole extent for one of its own dsts,
    into copies of ``st``'s pool."""
    import torch
    from repro_torch.kernels import append as ka
    vt, dev = st.vt, off.device
    P = off.shape[0]
    pstart = vt.start_block[off].contiguous()
    psize = vt.size[off].contiguous()
    cap = vt.cap[off]
    pick = (torch.rand(P, device=dev, generator=torch.Generator(
        device=dev).manual_seed(2)) * psize.clamp_min(1)).long()
    flat = pstart.long() * spec.block_size + pick
    pv = st.pool.dst.view(-1)[flat.clamp(0, spec.capacity_entries - 1)]
    pv = torch.where(psize > 0, pv, -1).to(torch.int32).contiguous()
    wval = (psize < cap) & (pstart >= 0)
    wblk = (pstart + psize // spec.block_size).to(torch.int32).contiguous()
    wlane = (psize % spec.block_size).to(torch.int32).contiguous()
    wd = pv.clamp_min(0).contiguous()
    ww = torch.full((P,), 1.5, device=dev)
    wts = (st.pool.clock + torch.arange(P, device=dev,
                                        dtype=torch.int32)).contiguous()
    ops = (wblk, wlane, wval, wd, ww, wts, pstart, psize, pv)
    pk = [t.clone() for t in (st.pool.dst, st.pool.weight, st.pool.ts)]
    pp = [t.clone() for t in pk]
    was_k = ka.append_edges(*pk, *ops)
    was_p = ka.append_edges_plain(*pp, *ops)
    probed, matches, winners = probe_work(st.pool.dst, pstart, psize, pv)
    landed = int((wval & (wblk < spec.n_blocks)).sum())   # all >= 0 here
    # the bytes this function needs: dst of every probed entry, ts of each
    # match, the weight of each probe's winner; pstart, psize, pv and the
    # was_live byte per probe; wval per op, (wblk, wlane) per valid op, and
    # (wd, ww, wts) read and written per landed op
    record("append", [spec.n_blocks, spec.block_size, P],
           wrappers(old, "append", "append_edges", *pk, *ops),
           lambda: ka.append_edges_plain(*pp, *ops),
           lambda: ([was_k, *pk], [was_p, *pp]),
           4 * (probed + matches + winners) + 13 * P + P +
           8 * int(wval.sum()) + 24 * landed, probed)


def compact_case(record, st, spec, u, width, name="compact_rows",
                 defrag=False, old=None, cut=False):
    """``compact_rows`` (or ``defrag_rows``) of ``st``'s rows ``u``
    gathered at ``width``; ``cut``: extents wider than the rows give their
    first ``width`` entries."""
    from repro_torch.core import edgepool as ep
    from repro_torch.kernels import compact as kc
    d, w, t, s = ep._gather_vertex_entries(spec, st.pool, st.vt, u, width)
    if cut:
        s = s.clamp_max(width)
    d, w, t, s = (x.contiguous() for x in (d, w, t, s))
    occupied, last, kept, most = row_work(d, s, w)
    # the bytes this function needs: dst of every occupied entry, the
    # weight of each dst's last writer, ts of each survivor; size;
    # the (dst, w, ts) output rows in full, count (and live)
    K = d.shape[0]
    nbytes = 4 * occupied + w.element_size() * last + 4 * kept + \
        4 * K + d.numel() * (8 + w.element_size()) + 4 * K * (1 + defrag)
    # a table insert per occupied entry; the sort path compares
    nops = occupied * (max(1, int(np.log2(max(width, 2)))) if defrag
                       else 1)
    if defrag:
        f, fp = "defrag_rows", kc.defrag_rows_plain
    else:
        f, fp = "compact_rows", kc.compact_rows_plain
    mine = getattr(kc, f)
    record(name, [K, width], wrappers(old, "compact", f, d, w, t, s),
           lambda: fp(d, w, t, s),
           lambda: (list(mine(d, w, t, s)), list(fp(d, w, t, s))),
           nbytes, nops).update(occupied=occupied, last_writers=last,
                                survivors=kept, max_dst_repeats=most)


def defrag_case(record, st, spec, n_cap, K, W, gen, old=None):
    """``defrag_rows`` at a rebuild's chunk shape (K, W): a size segment's
    chunk takes random rows of ``st`` from the segment; a wide tier's
    (wider than the top segment) takes ``st``'s widest extents, cut to its
    width."""
    import torch
    from repro_torch.core import edgepool as ep
    widths = [x for x, _ in ep._defrag_tiers(spec, n_cap)]
    sz = live_sizes(st.vt)
    if W <= widths[-1]:
        u = rows_by_size(sz, max([x for x in widths if x < W], default=0), W,
                         K, gen)
    else:
        u = torch.argsort(sz, descending=True)[:K].to(torch.int32)
    # the parent's defrag_rows stops at 16384
    compact_case(record, st, spec, u.contiguous(), W, "defrag_rows",
                 defrag=True, old=old if W <= 16384 else None,
                 cut=W > widths[-1])


def phase_kernels(store, ids, sample, launches, tally, final_tally,
                  chase_lib, torch, parent):
    """Each kernel against its plain version at main-path shapes, on
    inputs taken from the main path's final state: ``defrag_rows`` at
    every (rows, width) shape the path called (``tally``) and at the wide
    tier of the final state's streaming rebuild (``final_tally``).
    ``parent`` is None or the lookup of ``load_parent``: each wrapper the
    parent has is timed beside this checkout's."""
    from repro_torch.core import edgepool as ep
    from repro_torch.core.keys import pack_keys

    g = store.graph
    st, spec = g.state, g.pool_spec
    dev = g.device
    rng = np.random.default_rng(1)
    rows, shapes = {}, []

    def record(name, shape, kerns, plain, check, nbytes, nops):
        entry = kernel_entry(torch, name, shape, kerns, plain, check, nbytes,
                             nops)
        shapes.append(entry)
        rows.setdefault(name, entry)
        return entry

    # ---- sort_lookup: 2 x batch keys (the ingest shape) ----
    keys = pack_keys(ids[rng.choice(len(ids), 2 * g.batch)], 32, dev)
    keys[::7, 1] ^= 1                      # some absent IDs
    kw = sort_lookup_case(record, st.sort, g.sort_spec, keys, parent)
    pools = st.sort.pools

    # ---- append: one op per distinct vertex of the sample ----
    off = torch.from_numpy(g.lookup(ids[sample])).to(dev).long()
    off = off[off >= 0][:g.batch]
    append_case(record, st, spec, off, parent)

    # ---- compact_rows: the three main-path shapes, from real rows ----
    sz = live_sizes(st.vt)
    pick_rows = torch.Generator(device=dev).manual_seed(3)
    for u, W in ((off.to(torch.int32)[:g.batch], spec.dmax),
                 (rows_by_size(sz, 0, spec.probe_width, spec.k_max,
                               pick_rows), spec.probe_width),
                 (rows_by_size(sz, spec.probe_width, spec.dmax, spec.k_big,
                               pick_rows), spec.dmax)):
        compact_case(record, st, spec, u.contiguous(), W, old=parent)
    # defrag_rows at every shape the path called, then the wide tier of
    # this state's rebuild
    widths = [W for W, _ in ep._defrag_tiers(spec, g.n_max)]
    final_wide = {k for k in final_tally if k[2] > widths[-1]}
    for n, K, W in sorted(set(tally) | final_wide, key=lambda k: k[::-1]):
        if n == "defrag_rows":
            defrag_case(record, st, spec, g.n_max, K, W, pick_rows, parent)
    torch.cuda.synchronize()
    say("kernel_shapes", card=card_line(), shapes=shapes)
    floor = sort_lookup_floor(chase_lib, pools, keys, kw,
                              rows["sort_lookup"])
    lines = []
    for name in INGEST_KERNELS:
        loss = None
        if name in ("compact_rows", "defrag_rows"):
            loss, dev, calls, unmeasured = shape_loss(name, shapes, tally)
            if unmeasured:
                raise AssertionError(f"{name}: {unmeasured} calls of the "
                                     "path at shapes not timed")
            say("loss_by_shape", kernel=name, loss_ms=loss,
                path_device_ms=dev, path_calls=calls,
                path_launches=launches[name], by_shape={
                    "x".join(map(str, e["shape"])): e.get("loss_ms", 0.0)
                    for e in shapes if e["name"] == name})
        lines.append(kernel_line(name, rows[name], launches[name], loss))
        if name == "sort_lookup":
            lines[-1]["latency_floor_ms"] = floor
            lines[-1]["latency_floor_layers"] = len(pools)
    return lines


# The least a SORT descent of these keys can take with this layout: one
# dependent load a layer, nothing else. Each key's per-layer slot bits
# are computed beforehand and loaded up front (independent loads), so
# the chain holds only the pool loads; 64 threads a block spread the
# keys over every SM. It stands apart from ``sort_lookup`` so that the
# floor does not move with the kernel being judged.
CHASE_CU = r"""
#include <cuda_runtime.h>
#define MAX_LAYERS 8
struct ChaseArgs {
  const int* pools[MAX_LAYERS];
  long long sizes[MAX_LAYERS];
  int bits[MAX_LAYERS];
  int layers;
};
__global__ void chase_kernel(const int* __restrict__ idx,
                             int* __restrict__ out, int B, ChaseArgs a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= B) return;
  int ix[MAX_LAYERS];
#pragma unroll
  for (int i = 0; i < MAX_LAYERS; ++i)
    ix[i] = i < a.layers ? idx[(long long)i * B + k] : 0;
  long long node = 0;
#pragma unroll
  for (int i = 0; i < MAX_LAYERS; ++i) {
    if (i >= a.layers) break;
    long long slot = (node << a.bits[i]) + ix[i];
    slot = slot < a.sizes[i] ? slot : a.sizes[i] - 1;
    const int child = __ldg(a.pools[i] + slot);
    if (child < 0) { node = -1; break; }
    node = child;
  }
  out[k] = (int)node;
}
extern "C" int chase_launch(const int* idx, int* out, int B,
                            const void* const* pools, const long long* sizes,
                            const int* bits, int layers, void* stream) {
  if (layers < 1 || layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  ChaseArgs a = {};
  for (int i = 0; i < layers; ++i) {
    a.pools[i] = (const int*)pools[i];
    a.sizes[i] = sizes[i];
    a.bits[i] = bits[i];
  }
  a.layers = layers;
  chase_kernel<<<(B + 63) / 64, 64, 0, (cudaStream_t)stream>>>(idx, out, B,
                                                                 a);
  return (int)cudaGetLastError();
}
"""


def start_chase_build():
    """Start ``nvcc`` on ``CHASE_CU`` into the kernels' build directory;
    returns the function that waits for it and loads the library."""
    import ctypes
    import hashlib
    from repro_torch.kernels import _build
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(CHASE_CU.encode()).hexdigest()[:12]
    src, lib = out_dir / f"chase-{tag}.cu", out_dir / f"chase-{tag}.so"
    src.write_text(CHASE_CU)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(lib), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the pointer chase:\n{log}")
        return ctypes.CDLL(str(lib))
    return wait


def sort_lookup_floor(chase_lib, pools, keys, kw, row):
    """The SORT descent's latency floor, two ways, on the first i layers,
    i = 1 .. l (device ms from the profiler, and graph ms): the pointer
    chase of ``CHASE_CU`` (one dependent load a layer, the same pools and
    keys; its time at l layers is the floor the decision rests on, and its
    answers must equal ``sort_lookup``'s), and ``sort_lookup`` itself,
    whose least-squares slope is its own cost of a layer."""
    import ctypes
    import torch
    from repro_torch.core.keys import extract_bits
    from repro_torch.kernels import ops as kops, sort_lookup as ks
    L, B = len(pools), int(keys.shape[0])
    idx = torch.stack([extract_bits(keys, o, a) for a, o in
                       zip(kw["fanout_bits"], kw["bit_offsets"])]).contiguous()
    out = torch.empty(B, dtype=torch.int32, device=keys.device)
    fn = chase_lib.chase_launch
    fn.restype = ctypes.c_int
    chased = [0]

    def chase(i):
        arr = (ctypes.c_void_p * i)(*[p.data_ptr() for p in pools[:i]])
        sizes = (ctypes.c_longlong * i)(*[p.shape[0] for p in pools[:i]])
        bits = (ctypes.c_int * i)(*kw["fanout_bits"][:i])
        rc = fn(ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(
            out.data_ptr()), B, arr, sizes, bits, i, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"pointer chase: CUDA error {rc}")
        chased[0] += 1
        return out

    chase(L)
    if not torch.equal(out, ks.sort_lookup(pools, keys, **kw)):
        raise AssertionError("the pointer chase and sort_lookup disagree")
    lookup_launched = (lambda: kops.launch_counts()["sort_lookup"])
    fit = {}
    for what, make, launched in (
            ("chase", lambda i: (lambda: chase(i)), lambda: chased[0]),
            ("sort_lookup", lambda i: (lambda p=pools[:i], k=dict(
                fanout_bits=kw["fanout_bits"][:i],
                bit_offsets=kw["bit_offsets"][:i]):
                ks.sort_lookup(p, keys, **k)), lookup_launched)):
        dev = [device_ms(make(i), launched)["device_ms"]
               for i in range(1, L + 1)]
        gr = [graph_ms(make(i)) for i in range(1, L + 1)]
        slope, icpt = np.polyfit(np.arange(1, L + 1), dev, 1)
        fit[what] = dict(device_ms_by_layers=dev, graph_ms_by_layers=gr,
                         slope_device_ms=float(slope),
                         intercept_device_ms=float(icpt))
    floor = fit["chase"]["device_ms_by_layers"][-1]
    say("sort_lookup_floor", card=card_line(), layers=L, keys=B,
        chase=fit["chase"], sort_lookup=fit["sort_lookup"],
        latency_floor_ms=floor,
        latency_floor_graph_ms=fit["chase"]["graph_ms_by_layers"][-1],
        self_slope_floor_ms=L * fit["sort_lookup"]["slope_device_ms"],
        bound_ms=row["bound_ms"], device_ms=row["device_ms"],
        share_of_floor=floor / row["device_ms"],
        binds="latency" if floor > row["bound_ms"] else "bytes")
    return floor


def _ev_attr(e, *names):
    for n in names:
        if hasattr(e, n):
            return getattr(e, n)
    return 0.0


def phase_profile(store, ids, torch, n_batches=8):
    """Where a steady-state batch's time goes: ``n_batches`` mixed batches
    under ``torch.profiler`` (host ops by self CPU time, device busy
    share), then one explicit rebuild and one snapshot, timed alone, and
    one more rebuild whose ``defrag_rows`` calls are timed alone on their
    own inputs."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import OpBatch, ReadOp
    from repro_torch.core import edgepool as ep
    from repro_torch.kernels import compact as kc, ops as kops
    g = store.graph
    rng = np.random.default_rng(3)
    _, si, di = powerlaw_stream(rng, LJ_VERTICES, (n_batches + 2) * g.batch,
                                ids)
    w = rng.uniform(0.5, 2.0, len(si)).astype(np.float32)
    w[rng.random(len(si)) < 0.25] = 0.0
    B = g.batch

    def batch(i):
        sl = slice(i * B, (i + 1) * B)
        store.apply(OpBatch.edges(ids[si[sl]], ids[di[sl]], w[sl]))

    batch(0)
    batch(1)
    torch.cuda.synchronize()
    d0 = g.num_defrags
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, n_batches + 2):
            batch(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:14]
    say("profile_batches", card=card_line(), batches=n_batches,
        defrags_in_window=g.num_defrags - d0,
        batch_ms=wall * 1e3 / n_batches,
        device_busy_share=device_busy_us(prof) / (wall * 1e6),
        host_ops_per_batch=sum(e.count for e in ka
                               if e.key.startswith("aten::")) / n_batches,
        top_host_ops=[dict(op=e.key, calls=e.count,
                           self_cpu_ms=e.self_cpu_time_total / 1e3,
                           device_ms=_ev_attr(e, "self_device_time_total",
                                              "self_cuda_time_total") / 1e3)
                      for e in top])
    s0 = dict(ep.SYNCS)
    t0 = time.perf_counter()
    g.defrag()
    torch.cuda.synchronize()
    t_defrag = time.perf_counter() - t0
    path = "stream" if ep.SYNCS["defrag_stream"] > s0["defrag_stream"] \
        else "dense"
    t0 = time.perf_counter()
    m = int(store.read(ReadOp("snapshot")).m)
    torch.cuda.synchronize()
    snap_s = time.perf_counter() - t0
    # one more rebuild with its defrag_rows calls' inputs kept, then each
    # call timed alone on those inputs: the rebuild's kernel time at its
    # own shapes and data (a profiler trace of the rebuild itself keeps
    # too few of its kernel events to sum)
    calls = []
    orig = kc.defrag_rows

    def keep(*a, **kw):
        calls.append(([x.clone() if torch.is_tensor(x) else x for x in a],
                      kw))
        return orig(*a, **kw)
    kc.defrag_rows = keep
    try:
        g.defrag()
    finally:
        kc.defrag_rows = orig
    launched = (lambda: kops.launch_counts()["defrag_rows"])
    timed = [device_ms(lambda a=a, kw=kw: orig(*a, **kw), launched, reps=5)
             for a, kw in calls]
    say("profile_rebuild", card=card_line(), defrag_s=t_defrag,
        defrag_path=path, snapshot_s=snap_s, snapshot_m=m,
        defrag_rows_calls=len(calls),
        defrag_rows_launches=sum(t["kernels_per_call"] for t in timed),
        defrag_rows_device_ms=sum(t["device_ms"] for t in timed),
        least_events_kept=min(t["profiler_events_kept"] for t in timed))
    del calls


def phase_durability(args, store, ids, sample, torch):
    """The durable path on the main path's store: a full checkpoint, 2^18
    mixed ops through a ``DurableStore`` (the WAL written before each
    apply), a delta checkpoint, 2^16 more ops left in the WAL, then
    recovery into a fresh store on the card (counters zeroed just before)
    held to the live store, and the crash smoke on a state of the same
    size in a subprocess. The directory is under ``build/`` and removed
    at the end. Returns the replay's launches by kernel."""
    import pathlib
    import shutil
    root = pathlib.Path(ROOT) / "build" / "durability"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    full_bytes = nbytes(store.graph.state)
    free = shutil.disk_usage(root).free
    if free < 3 * full_bytes:
        raise AssertionError(
            f"durability: {free} bytes free under {root}, under 3 x a full "
            f"checkpoint ({full_bytes} bytes)")
    try:
        launches = durable_path(args, store, ids, sample, torch, root,
                                dict(free_bytes=free,
                                     full_state_bytes=full_bytes))
        crash_smoke(args, root / "crash", torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def durable_path(args, store, ids, sample, torch, root, disk):
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.core import edgepool as ep
    from repro_torch.kernels import ops as kops
    from repro_torch.storage import DurableStore, recover
    from repro_torch.storage.checkpoint import flatten_named
    from repro_torch.storage.crash_smoke import assert_states_equal
    g = store.graph
    B = g.batch
    ddir = root / "store"
    dur = DurableStore(store, ddir, group_commit=GROUP_COMMIT)
    ckpts = []

    def checkpoint(after_ops):
        parts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        man = dur.checkpoint(timings=parts)
        ms = (time.perf_counter() - t0) * 1e3
        ckpts.append(dict(
            after_ops=after_ops, kind=man["kind"], why_full=man["why_full"],
            bytes=man["bytes"], ms=ms,
            **{f"{k}_ms": v for k, v in parts.items()},
            touched_blocks=(man["delta"] or {}).get("n_blocks"),
            pool_blocks=int(g.state.pool.owner.shape[0])))
        return man

    rng = np.random.default_rng(args.seed + 7)
    extra = 16 * B          # one more segment if a rebuild voids the delta
    n = DURABLE_OPS + extra + WAL_ONLY_OPS
    _, si, di = powerlaw_stream(rng, LJ_VERTICES, n, ids)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.25] = 0.0
    tot = dict(ops=0, s=0.0, wal_ms=0.0, records=0, bytes=0, syncs=0)

    def run(lo, hi):
        """Apply ops [lo, hi) through the durable store, timed; WAL
        records, bytes and group-commit syncs added up over segments."""
        wal = dur.wal
        r0, b0, y0 = wal.records_written, wal.bytes_written, wal.syncs
        torch.cuda.synchronize()
        t0, wal0 = time.perf_counter(), dur.wal_stats["wal_ms"]
        for a in range(lo, hi, B):
            b = min(a + B, hi)
            res = dur.apply(OpBatch.edges(ids[si[a:b]], ids[di[a:b]],
                                          w[a:b]))
            if res.dropped:
                raise AssertionError(f"durability: {res.dropped} ops "
                                     "dropped")
        torch.cuda.synchronize()
        tot["s"] += time.perf_counter() - t0
        tot["wal_ms"] += dur.wal_stats["wal_ms"] - wal0
        tot["ops"] += hi - lo
        tot["records"] += wal.records_written - r0
        tot["bytes"] += wal.bytes_written - b0
        tot["syncs"] += wal.syncs - y0
        return hi

    checkpoint(0)
    pos = run(0, DURABLE_OPS)
    man = checkpoint(pos)
    if man["kind"] != "delta":
        say("durability_full_again", why_full=man["why_full"])
        pos = run(pos, pos + extra)
        man = checkpoint(pos)
    if not any(c["kind"] == "delta" for c in ckpts):
        raise AssertionError(f"durability: no delta checkpoint: {ckpts}")
    wal_only = dur.wal.records_written
    pos = run(pos, pos + WAL_ONLY_OPS)     # stays in the WAL only
    wal_only = dur.wal.records_written - wal_only
    dur.sync()
    dur.close()
    say("durability", card=card_line(), **disk, group_commit=GROUP_COMMIT,
        durable_ops=tot["ops"],
        durable_updates_per_s=tot["ops"] / tot["s"], apply_s=tot["s"],
        wal_ms=tot["wal_ms"],
        wal_share_of_apply=tot["wal_ms"] / (tot["s"] * 1e3),
        wal_records=tot["records"], wal_bytes=tot["bytes"],
        wal_syncs_group_commit=tot["syncs"], checkpoints=ckpts,
        delta_over_full_bytes=[c["bytes"] / ckpts[0]["bytes"]
                               for c in ckpts if c["kind"] == "delta"])

    # ---- recovery into a fresh store on the card ----
    parts = {}
    kops.reset_launch_counts()
    s0 = dict(ep.SYNCS)
    t0 = time.perf_counter()
    rec, report = recover(ddir, lambda: make_store("local", **LJ_STORE),
                          timings=parts, group_commit=GROUP_COMMIT)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = kops.launch_counts()
    syncs = {k: ep.SYNCS[k] - s0[k] for k in s0}
    if syncs["defrag_dense"]:
        raise AssertionError("durability: a replayed rebuild went dense")
    for k in ("append", "compact_rows", "sort_lookup") + (
            ("defrag_rows",) if syncs["defrag_stream"] else ()):
        if launches[k] <= 0:
            raise AssertionError(f"durability: the replay did not launch "
                                 f"{k}")
    if report["replayed"] != wal_only or report["gap_at"] is not None \
            or str(report["wal_tail"]) != "ok" \
            or report["checkpoint_kind"] != ckpts[-1]["kind"]:
        raise AssertionError(f"durability: recovery report {report}")
    dead = assert_states_equal(g.state, rec.graph.state, "recovered")
    q = ids[sample]
    for kind in ("lookup", "degree"):
        if not np.array_equal(store.read(ReadOp(kind, ids=q)),
                              rec.read(ReadOp(kind, ids=q))):
            raise AssertionError(f"durability: recovered {kind} differs")
    for (ia, wa), (ib, wb) in zip(store.read(ReadOp("neighbors", ids=q)),
                                  rec.read(ReadOp("neighbors", ids=q))):
        if not (np.array_equal(ia, ib) and np.array_equal(wa, wb)):
            raise AssertionError("durability: recovered neighbors differ")
    m_live = store.read(ReadOp("num_edges"))
    m_rec = rec.read(ReadOp("num_edges"))
    if m_live != m_rec:
        raise AssertionError(f"durability: num_edges {m_rec} != {m_live}")
    say("recovery", card=card_line(), seconds=rec_s,
        report={k: str(v) if k == "wal_tail" else v
                for k, v in report.items()},
        read_ms=parts.get("read", 0.0), crc_ms=parts.get("crc", 0.0),
        h2d_ms=parts.get("h2d", 0.0), replay_ms=parts["replay"],
        replayed_ops=parts["replayed_ops"],
        replayed_ops_per_s=parts["replayed_ops"] / parts["replay"] * 1e3,
        replay_launches=launches,
        replay_rebuilds_stream=syncs["defrag_stream"],
        replay_rebuilds_dense=syncs["defrag_dense"],
        state_leaves=len(flatten_named(g.state)),
        unowned_blocks_differing=dead, reads_checked=len(q),
        num_edges=m_rec,
        equal="every leaf; the pool's entries on owned blocks")
    rec.close()
    del rec
    torch.cuda.empty_cache()
    return launches


def crash_smoke(args, cdir, torch):
    """``python -m repro_torch.storage.crash_smoke`` on the card at the
    main path's state size (``CRASH_ARGS``): the child must die by
    SIGKILL, and the recovered prefix and resumed stream match a control
    store."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "repro_torch.storage.crash_smoke",
           "--device", LJ_STORE["device"], "--seed", str(args.seed),
           "--dir", str(cdir),
           "--json", *CRASH_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"crash smoke failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    crash = json.loads(proc.stdout[proc.stdout.index("{"):])
    say("crash_smoke", card=card_line(), seconds=time.perf_counter() - t0,
        **crash)


# the sharded phase's store: 4 shards on the one card. The pools total the
# main path's 2^23 blocks of 16; each vertex table is as large as the main
# path's (at LiveJournal scale nearly every vertex gets a stub row in every
# source shard). ``m_cap``, the CSR pad a shard's snapshot and analytics
# take, is the least power of two over the largest shard's live edges plus
# the analytics delta (~1.27M a shard; the phase fails if a snapshot
# reaches it). ``query_batch`` 64 keeps k-hop's dense route to a
# (2^23, 2 + 2) payload a shard (2^25 routed rows of 5 int32 words: 0.67 GB
# a shard); the degree reads ride the same chunks. Every other knob keeps
# the JAX package's default
# the sharded phase applies this prefix of the main path's 5,242,880-op
# stream (printed under ``reduced``): its state keeps its size (4 shards,
# 5.40 GB) and its first rebuild streams (H100 runs: rebuilds after
# batches 127 and 241 of a 2^20-op prefix, 9 in the whole stream's 1,280)
SHARDED_OPS = 3 << 18
SHARDED_STORE = dict(device="cuda", n_shards=4, n_per_shard=2 ** 23,
                     expected_n=LJ_VERTICES, key_bits=32,
                     pool_blocks=2 ** 21, block_size=16, k_max=256,
                     dmax=4096, batch=4096, query_batch=64, m_cap=2 ** 21)


def phase_sharded(args, torch, stream):
    """The sharded backend at the main path's state size: the main path's
    stream (``stream``, from ``lj_stream``; cut to ``--sharded-ops``)
    through ``make_store("sharded")`` in ``apply`` calls of 4096 ops,
    launch counters zeroed just before and
    read just after; then lookup / degree / neighbors of 4096 sampled
    source IDs (the host view's and the snapshots' builds timed apart),
    ``num_edges`` and ``num_vertices``, all held to the host oracle over
    the ops applied. Returns the launches by kernel."""
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.core import edgepool as ep
    from repro_torch.dist import graph_engine as ge
    from repro_torch.kernels import append as ka, compact as kc, \
        ops as kops, sort_lookup as ks
    rng, ids, si, di, w_in, msi, mdi, w_mx = stream
    n_ops = min(args.sharded_ops, len(si) + len(msi))
    si = np.concatenate([si, msi])[:n_ops]
    di = np.concatenate([di, mdi])[:n_ops]
    w = np.concatenate([w_in, w_mx])[:n_ops]
    del msi, mdi, w_in, w_mx
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = make_store("sharded", **SHARDED_STORE)
    st = store.state
    torch.cuda.synchronize()
    say("sharded_store", seconds=round(time.perf_counter() - t0, 3),
        n_shards=store.n_shards, fanout_bits=list(store.sspec.fanout_bits),
        sort_pool_bytes=nbytes(st.sort), vertex_table_bytes=nbytes(st.vt),
        edge_pool_bytes=nbytes(st.pool), state_bytes=nbytes(st),
        sync_budget=store.sync_budget, pipeline_depth=store.pipeline_depth)

    B = store.batch
    # every kernel call of the phase by shape (ops for append, keys for
    # sort_lookup, rows x width for the compactions)
    tally = {}
    untally = [tally_shapes(kc, ("compact_rows", "defrag_rows"), tally),
               tally_shapes(ka, ("append_edges",), tally, arg=3),
               tally_shapes(ks, ("sort_lookup",), tally, arg=1)]
    kops.reset_launch_counts()
    s0, r0 = dict(ep.SYNCS), dict(ge.ROUTES)
    lat = []
    rebuild_batches = []        # (batch, rebuilds so far) where one ran
    t_start = time.perf_counter()
    for lo in range(0, n_ops, B):
        t = time.perf_counter()
        res = store.apply(OpBatch.edges(ids[si[lo:lo + B]],
                                        ids[di[lo:lo + B]], w[lo:lo + B]))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        if res.dropped:
            raise AssertionError(f"sharded: {res.dropped} ops dropped")
        if store.stats["defrags"] != (rebuild_batches[-1][1]
                                      if rebuild_batches else 0):
            rebuild_batches.append((len(lat) - 1, store.stats["defrags"]))
    t_apply = time.perf_counter() - t_start
    launches = kops.launch_counts()
    syncs = {k: ep.SYNCS[k] - s0[k] for k in s0}
    routes = {k: ge.ROUTES[k] - r0[k] for k in r0}
    st = store.state
    n_batches = len(lat)

    sample = np.sort(rng.choice(np.unique(si), 4096, replace=False))
    q = ids[sample]
    t0 = time.perf_counter()
    view = store._host_view(st)
    t_view = time.perf_counter() - t0
    t0 = time.perf_counter()
    snaps = store._snapshots(st)
    torch.cuda.synchronize()
    t_snap = time.perf_counter() - t0
    read_ms = {}
    for kind in ("lookup", "degree", "neighbors"):
        t0 = time.perf_counter()
        out = store.read(ReadOp(kind, ids=q))
        torch.cuda.synchronize()
        read_ms[kind] = (time.perf_counter() - t0) * 1e3
        if kind == "lookup":
            found = out
        elif kind == "degree":
            deg = out
        else:
            nbrs = out
    t0 = time.perf_counter()
    n_edges = store.read(ReadOp("num_edges"))
    read_ms["num_edges"] = (time.perf_counter() - t0) * 1e3
    n_vertices = store.read(ReadOp("num_vertices"))
    for u in untally:
        u()

    # ---- the host oracle over the ops this phase applied ----
    osrc, odst, ow = oracle(LJ_VERTICES, si, di, w)
    if n_edges != len(osrc):
        raise AssertionError(f"sharded num_edges {n_edges}, oracle "
                             f"{len(osrc)}")
    if not found.all():
        raise AssertionError("sharded: a sampled source vertex is missing")
    # the sync gives every vertex of the stream exactly one owner row
    if n_vertices != len(np.unique(np.concatenate([si, di]))):
        raise AssertionError(f"sharded num_vertices {n_vertices} is not "
                             "the stream's vertex count")
    odeg = np.bincount(osrc, minlength=LJ_VERTICES)
    # degree reads scan at most dmax entries of an edge array, as on the
    # main path: a vertex whose array is longer is checked by neighbors
    # (the CSR) only
    owner = ge.shard_of_keys(store._keys(q), store.n_shards).cpu().numpy()
    row = np.array([view["row_of"][s][np.searchsorted(view["row_vid"][s],
                                                      x)]
                    for s, x in zip(owner, q)])
    size = st.vt.size[torch.from_numpy(owner).long(),
                      torch.from_numpy(row).long()].cpu().numpy()
    within = size <= store.pspec.dmax
    if within.mean() < 0.9:
        raise AssertionError("too few sampled vertices within the read width")
    if not np.array_equal(deg[within], odeg[sample][within]):
        raise AssertionError("sharded degree disagrees with the oracle")
    order = np.argsort(osrc, kind="stable")
    starts = np.searchsorted(osrc[order], sample)
    for j, v in enumerate(sample):
        e = order[starts[j]:starts[j] + odeg[v]]
        exp = dict(zip(ids[odst[e]].tolist(), ow[e].tolist()))
        got = dict(zip(nbrs[j][0].tolist(), nbrs[j][1].tolist()))
        if got != exp:
            raise AssertionError(f"sharded neighbors of {int(q[j])} "
                                 "disagree")
    for k in ("append", "compact_rows", "sort_lookup"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "sharded path")
    rebuilds = st.pool.defrags.tolist()
    if not sum(rebuilds) or launches["defrag_rows"] <= 0:
        raise AssertionError("no sharded rebuild, or one that launched no "
                             "defrag_rows")
    if syncs["defrag_dense"]:
        raise AssertionError("a sharded rebuild took the dense path")
    errs = sharded_kernel_checks(store, st, tally, launches, torch)
    profile, (psi, pdi, pw) = sharded_profile(store, ids, torch)
    m_shard = snaps.m.tolist()
    if max(m_shard) + DELTA_EDGES >= store.m_cap:
        raise AssertionError(f"a shard's snapshot reaches m_cap: {m_shard}")
    say("sharded", card=card_line(), ops=n_ops, batches=n_batches,
        seconds=round(time.perf_counter() - t_start, 3),
        updates_per_s=n_ops / t_apply,
        batch_p50_ms=float(np.percentile(lat, 50)),
        batch_p99_ms=float(np.percentile(lat, 99)),
        batch_max_ms=float(np.max(lat)),
        rebuilds_per_shard=rebuilds, rebuild_batches=rebuild_batches,
        defrag_wide=syncs["defrag_wide"],
        route_fallbacks=routes["dense_fallback"],
        compact_routes=routes["compact"],
        sync_runs=store.stats["sync_runs"],
        sync_skips=store.stats["sync_skips"],
        host_syncs_per_batch=syncs["host_syncs"] / n_batches,
        launches=launches,
        launches_per_batch={k: v / n_batches for k, v in launches.items()},
        row_high_water=st.vt.num_rows.tolist(),
        vertices=n_vertices, live_edges=n_edges, live_edges_per_shard=m_shard,
        m_cap=store.m_cap, query_batch=store.query_batch,
        host_view_build_ms=t_view * 1e3, snapshots_build_ms=t_snap * 1e3,
        read_4096_ms=read_ms, reads_checked=dict(
            lookup=len(q), degree=int(within.sum()), neighbors=len(q)),
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        state_copies=store.state_copies, oracle="agrees", **profile)
    del st, snaps, view
    # the store and every op it took (the profiled batches too) go on to
    # the sharded analytics
    return launches, errs, dict(
        store=store, ids=ids, si=np.concatenate([si, psi]),
        di=np.concatenate([di, pdi]), w=np.concatenate([w, pw]),
        tally=tally)


def sharded_kernel_checks(store, st, tally, launches, torch, level=None,
                          must=INGEST_KERNELS, line="sharded_kernel_shapes"):
    """Each kernel of a sharded phase against its plain version at every
    shape the phase called it with (``tally``), on inputs from a shard
    view of ``st`` (shape i on shard i mod n_shards), and the frontier
    kernel on ``level`` (the largest BFS level: shard, its (m_cap, 1) CSR
    view, the frontier bitmap, the level, its vertices), each timed alone
    (CUDA events, 5 calls; the plain version 3). Fails when a kernel of
    ``must`` was launched and not checked. Returns each kernel's largest
    error."""
    from repro_torch.dist import graph_engine as ge
    n, spec, dev = store.n_shards, store.pspec, store.device
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes, at = [], {}

    def record(name, shape, kerns, plain, check, nbytes, nops):
        out_k, out_p = check()
        entry = dict(name=name, shape=shape, max_abs_err=max_abs_err(
            out_k, out_p), ms=cuda_ms(kerns[0], reps=5, warm=1),
            plain_ms=cuda_ms(plain, reps=3, warm=1),
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         nops / F32_OPS_PER_S) * 1e3, **at)
        shapes.append(entry)
        return entry

    for i, key in enumerate(sorted(tally)):
        name, *shape = key
        at.update(shard=i % n, path_calls=tally[key])
        v = ge.shard_view(st, i % n)
        if name == "sort_lookup":        # live IDs of the shard, some absent
            rows = torch.nonzero(v.vt.del_time == 0).flatten()
            keys = v.vt.ids[rows[torch.randint(
                rows.numel(), (shape[0],), device=dev, generator=gen)]]
            keys[::7, 1] ^= 1
            sort_lookup_case(record, v.sort, store.sspec, keys)
        elif name == "append_edges":     # distinct rows with an extent
            rows = torch.nonzero((v.vt.del_time == 0) &
                                 (v.vt.start_block >= 0)).flatten()
            append_case(record, v, spec, rows[torch.randperm(
                rows.numel(), device=dev, generator=gen)[:shape[0]]])
        elif name == "compact_rows":
            K, W = shape
            if W == spec.probe_width:    # the fast path's probe window
                lo, hi = 0, W
            elif K == spec.k_big:        # its big tier
                lo, hi = spec.probe_width, W
            else:                        # degree reads: any row
                lo, hi = 0, torch.iinfo(torch.int32).max
            compact_case(record, v, spec, rows_by_size(
                live_sizes(v.vt), lo, hi, K, gen).contiguous(), W)
        else:
            defrag_case(record, v, spec, store.n_per_shard, *shape, gen)
    if level is not None:
        s_, view, fb, lv, size = level
        at.update(shard=s_, path_calls=launches["frontier_expand"],
                  bfs_level=lv, frontier_vertices=size)
        frontier_case(record, *view, fb)
    torch.cuda.synchronize()
    errs = {}
    for e in shapes:
        errs[e["name"]] = max(errs.get(e["name"], 0.0), e["max_abs_err"])
    missing = [k for k in must if launches[k] and k not in errs]
    if missing:
        raise AssertionError(f"sharded kernels launched but not checked: "
                             f"{missing}")
    empty = [(e["name"], e["shape"]) for e in shapes if e.get("occupied") == 0]
    if empty:
        raise AssertionError(f"sharded shapes checked on empty rows: {empty}")
    say(line, card=card_line(), shapes=shapes,
        ms_is="kernel wrapper calls between CUDA events, 5 calls (plain "
        "version: 3)", seconds=round(time.perf_counter() - t0, 3))
    return errs


def frontier_case(record, owner, dst, valid, fb):
    """``frontier_expand`` of the frontier bitmap ``fb`` over a CSR view,
    visited empty (as a distributed BFS level expands it)."""
    import torch
    from repro_torch.kernels import frontier as kf
    args_ = (owner, dst, valid, fb, torch.zeros_like(fb))
    NB, BS = dst.shape
    W = fb.shape[0]
    record("frontier_expand", [NB, BS, W],
           (lambda: kf.frontier_expand(*args_), None),
           lambda: kf.frontier_expand_plain(*args_),
           lambda: ([kf.frontier_expand(*args_)],
                    [kf.frontier_expand_plain(*args_)]),
           NB * 4 + NB * BS * 5 + 3 * W * 4, NB * BS)


def sharded_profile(store, ids, torch, n_batches=2):
    """Where a steady-state sharded batch's time goes: ``n_batches`` more
    mixed batches (after the oracle checks) under ``torch.profiler``:
    wall ms a batch, the share of it in the vertex sync, host ops a batch
    and the device's busy share. Returns them and the ops applied. Two
    batches: a trace of 8 (~60,000 kernel events) was followed by a
    frontier-kernel trace that kept no event."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import OpBatch
    rng = np.random.default_rng(4)
    B = store.batch
    _, si, di = powerlaw_stream(rng, LJ_VERTICES, n_batches * B, ids)
    w = rng.uniform(0.5, 2.0, len(si)).astype(np.float32)
    w[rng.random(len(si)) < 0.25] = 0.0
    sync_s = []
    inner = store._maybe_sync_live

    def timed_sync(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner(*a)
        torch.cuda.synchronize()
        sync_s.append(time.perf_counter() - t)
    store._maybe_sync_live = timed_sync
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n_batches):
                sl = slice(i * B, (i + 1) * B)
                store.apply(OpBatch.edges(ids[si[sl]], ids[di[sl]], w[sl]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del store._maybe_sync_live
    ka = prof.key_averages()
    return dict(
        profile_batch_ms=wall * 1e3 / n_batches,
        profile_sync_share=sum(sync_s) / wall,
        profile_device_busy_share=device_busy_us(prof) / (wall * 1e6),
        profile_host_ops_per_batch=sum(
            e.count for e in ka if e.key.startswith("aten::")) / n_batches
    ), (si, di, w)


def sharded_parity(torch, device="cuda"):
    """A small stream through the sharded engine (4 shards, route budget
    64: both routes run) twice, with every kernel and with every plain
    version, plus a budgeted vertex sync, the degree and snapshot reads
    and the analytics programs (bfs, k-hop k = 2, wcc, sssp; frontier
    budget 64): every stacked leaf and every answer identical, and the
    plain run launches nothing. The engine functions are driven
    directly."""
    import dataclasses
    from repro_torch.core import edgepool as ep
    from repro_torch.core.keys import pack_keys
    from repro_torch.core.sort import SortSpec
    from repro_torch.core.sort_optimizer import optimize_sort
    from repro_torch.dist import graph_engine as ge
    from repro_torch.kernels import ops as kops
    n, B = 4, 1024
    rng = np.random.default_rng(6)
    ids, si, di = powerlaw_stream(rng, 3000, 40_960)
    w = rng.uniform(0.5, 2.0, len(si)).astype(np.float32)
    w[rng.random(len(si)) < 0.25] = 0.0
    si[8192:12288] = np.arange(4096) % 40         # 40 medium hubs at once
    mask = np.ones(len(si), bool)
    mask[20480:30720] = (np.arange(10240) % B) < 96    # compacted batches
    dev = torch.device(device)
    sk, dk = pack_keys(ids[si], 32, dev), pack_keys(ids[di], 32, dev)
    tw, tm = torch.from_numpy(w).to(dev), torch.from_numpy(mask).to(dev)
    q = pack_keys(ids[:4096], 32, dev)
    sspec = SortSpec.from_config(optimize_sort(3000, 32, 5), 8192)
    pspec = ep.PoolSpec(n_blocks=4096, block_size=16, dmax=512, k_max=32,
                        k_big=4, probe_width=64)
    plain = (dataclasses.replace(sspec, lookup_impl="ref"),
             dataclasses.replace(pspec, append_impl="plain",
                                 compact_impl="ref"))
    src_key = pack_keys(ids[si[:1]], 32, dev)[0]
    m_cap = pspec.capacity_entries
    runs = []
    for (ss, ps), walk in (((sspec, pspec), "auto"), (plain, "ref")):
        kops.reset_launch_counts()
        r0 = dict(ge.ROUTES)
        apply = ge.make_apply_edges(ss, ps, n, route_budget=64)
        sync = ge.make_sync_vertices(ss, ps, n, budget=256,
                                     incremental=True)
        state = ge.make_sharded_state(ss, ps, n, 8192, dev)
        drops = []
        for lo in range(0, len(si), B):
            rows = state.vt.num_rows.clone()
            state, d = apply(state, sk[lo:lo + B], dk[lo:lo + B],
                             tw[lo:lo + B], tm[lo:lo + B])
            state = sync(state, rows)
            drops.append(d)
        deg = ge.make_khop_counts(ss, ps, n)(state, q)
        snap = ge.make_snapshot(ss, ps, n, ps.capacity_entries)(state)
        # the analytics programs, budgeted as the apply (both routes)
        kw = dict(frontier_budget=64)
        bfs = ge.make_bfs(ss, ps, n, m_cap, impl=walk, **kw)(state, src_key)
        khop = ge.make_khop_counts(ss, ps, n, k=2, m_cap=m_cap, impl=walk,
                                   **kw)(state, q[:64])
        wcc = ge.make_wcc(ss, ps, n, m_cap, **kw)(state)
        sssp = ge.make_sssp(ss, ps, n, m_cap, **kw)(state, src_key)
        torch.cuda.synchronize()
        runs.append(dict(state=state, drops=torch.stack(drops), deg=deg,
                         snap=snap, bfs=bfs, khop=khop, wcc=wcc, sssp=sssp,
                         launches=kops.launch_counts(),
                         routes={k: ge.ROUTES[k] - r0[k] for k in r0}))
    a, b = runs
    la, lb = leaves(a["state"]), leaves(b["state"])
    if len(la) != len(lb) or not all(torch.equal(x, y)
                                     for x, y in zip(la, lb)):
        raise AssertionError("sharded kernel path and plain path states "
                             "differ")
    for k in ("drops", "deg", "bfs", "khop", "wcc", "sssp"):
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"sharded kernel and plain {k} differ")
    if not all(torch.equal(x, y) for x, y in zip(a["snap"], b["snap"])):
        raise AssertionError("sharded kernel and plain snapshots differ")
    if max(b["launches"].values()) != 0 or min(
            a["launches"][k] for k in INGEST_KERNELS +
            ANALYTICS_KERNELS) <= 0:
        raise AssertionError(f"sharded launch counts {a['launches']} "
                             f"{b['launches']}")
    if not (a["routes"]["compact"] and a["routes"]["dense_fallback"]):
        raise AssertionError(f"both routes must run: {a['routes']}")
    if int(a["drops"].sum()):
        raise AssertionError("sharded parity stream dropped ops")
    if int(a["bfs"].max()) < 2 or int(a["khop"].sum()) <= 0:
        raise AssertionError("sharded parity analytics are trivial")
    say("sharded_parity", identical=True, leaves=len(la), n_shards=n,
        defrags=a["state"].pool.defrags.tolist(), routes=a["routes"],
        kernel_launches=a["launches"], plain_launches=b["launches"],
        live_edges=int(a["snap"].m.sum()),
        bfs_levels=int(a["bfs"].max()), khop_counts=a["khop"].tolist()[:16])


def pagerank_steps(n_vertices, present, osrc, odst, x0=None):
    """float64 power iteration with the port's dangling rule: dangling
    mass spreads uniformly over the active (present) vertices. It starts
    uniform, or from ``x0`` (one value per vertex index). Yields the
    start, then (iterate, max |change|) after each step, without end."""
    act = np.zeros(n_vertices, bool)
    act[present] = True
    n_act = float(len(present))
    deg = np.bincount(osrc, minlength=n_vertices).astype(np.float64)
    x = np.where(act, 1.0 / n_act, 0.0) if x0 is None else \
        np.where(act, x0, 0.0)
    yield x
    while True:
        contrib = np.where(deg > 0, x / np.maximum(deg, 1.0), 0.0)
        dangling = x[act & (deg == 0)].sum()
        inflow = np.bincount(odst, weights=contrib[osrc],
                             minlength=n_vertices)
        nx = np.where(act, (1 - DAMPING) / n_act +
                      DAMPING * (inflow + dangling / n_act), 0.0)
        ch = np.abs(nx - x).max()
        x = nx
        yield x, ch


def host_pagerank(n_vertices, present, osrc, odst, iters, tol=None,
                  x0=None):
    """``pagerank_steps`` for ``iters`` steps, or until a step changes no
    rank by ``tol`` or more. Returns the iterate and its steps."""
    steps = pagerank_steps(n_vertices, present, osrc, odst, x0)
    x, it = next(steps), 0
    while it < iters:
        x, ch = next(steps)
        it += 1
        if tol is not None and not ch >= tol:
            break
    return x, it


def host_pagerank_at(n_vertices, present, osrc, odst, at, tol=None,
                     cap=100):
    """One run of ``pagerank_steps`` from uniform: the iterates after each
    step count in ``at``, and the step at which ``host_pagerank`` with
    ``tol`` would stop (``cap`` if it would not before)."""
    steps = pagerank_steps(n_vertices, present, osrc, odst)
    next(steps)
    kept, stop, it = {}, None, 0
    while it < max(at) or (tol is not None and stop is None and it < cap):
        x, ch = next(steps)
        it += 1
        if it in at:
            kept[it] = x
        if tol is not None and stop is None and not ch >= tol:
            stop = it
    return kept, stop or cap


def host_oracle_checks(n_vertices, ids, present, rows, osrc, odst, ow, hub,
                       khop_src, results, bfs_iters):
    """Independent answers from numpy and scipy over the same edge list
    (never the port's code), held to the store's answers."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    t0 = time.perf_counter()
    A = sp.csr_matrix((ow.astype(np.float64), (osrc, odst)),
                      shape=(n_vertices, n_vertices))
    out = {}

    def raw(key):
        return results[key].raw[rows]

    hops = csgraph.shortest_path(A, method="D", unweighted=True,
                                 indices=hub)[present]
    want = np.where(np.isfinite(hops) & (hops <= bfs_iters), hops, -1)
    if not np.array_equal(raw("bfs").astype(np.int64),
                          want.astype(np.int64)):
        raise AssertionError("bfs depths disagree with the host oracle")
    out["bfs_reached"] = int((want >= 0).sum())

    ncomp, lab = csgraph.connected_components(A, directed=True,
                                              connection="weak")
    minid = np.full(ncomp, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(minid, lab[present], ids[present])
    if not np.array_equal(raw("wcc"), minid[lab[present]]):
        raise AssertionError("wcc labels disagree with the host oracle")
    out["components"] = int(np.unique(lab[present]).size)

    got = results["khop"].value
    for j, s_ in enumerate(khop_src):
        n1 = A.indices[A.indptr[s_]:A.indptr[s_ + 1]]
        n2 = A[n1].indices
        if got[j] != np.unique(np.concatenate([[s_], n1, n2])).size - 1:
            raise AssertionError(f"khop count of source {j} disagrees")
    out["khop_max"] = int(max(got))

    dist = csgraph.dijkstra(A, directed=True, indices=hub)[present]
    d32 = raw("sssp").astype(np.float64)
    fin = np.isfinite(dist)
    if not np.array_equal(fin, d32 < 1e38):
        raise AssertionError("sssp reachability disagrees with Dijkstra")
    rel = np.abs(d32[fin] - dist[fin]) / np.maximum(dist[fin], 1e-30)
    out["sssp_max_rel_err"] = float(rel.max()) if rel.size else 0.0
    if out["sssp_max_rel_err"] > 1e-5:
        raise AssertionError(f"sssp relative error {rel.max()}")

    # the tolerance run against float64 over as many iterations as the
    # port ran: its float32 loop may run to its cap where float64 stops
    # earlier (the ``pagerank_float32`` line records why)
    its = results["pagerank_tol"].iters
    xs, out["pagerank_tol_iters_float64"] = host_pagerank_at(
        n_vertices, present, osrc, odst, (20, its), PR_TOL)
    x20, xt = xs[20], xs[its]
    out["pagerank_l1"] = float(np.abs(
        raw("pagerank").astype(np.float64) - x20[present]).sum())
    out["pagerank_tol_l1"] = float(np.abs(
        raw("pagerank_tol").astype(np.float64) - xt[present]).sum())
    out["pagerank_tol_iters"] = its
    if max(out["pagerank_l1"], out["pagerank_tol_l1"]) > 1e-4:
        raise AssertionError(f"pagerank L1 distance {out}")
    out["oracle_s"] = time.perf_counter() - t0
    return out


def pagerank_residual_l1(csr, x):
    """``||F(x) - x||_1`` in float64 over a host CSR, ``F`` the damped
    step whose dangling mass spreads over the active rows. Since ``F`` is
    a d-contraction in L1, ``x`` lies within this / (1 - d) of the fixed
    point."""
    n = csr.n_cap
    deg = csr.deg.astype(np.float64)
    act = csr.active
    n_act = max(int(act.sum()), 1)
    x = np.where(act, np.asarray(x, np.float64), 0.0)
    src = np.repeat(np.arange(n), csr.deg)
    contrib = np.where(deg > 0, x / np.maximum(deg, 1.0), 0.0)
    inflow = np.bincount(csr.dst[:csr.m].astype(np.int64),
                         weights=contrib[src], minlength=n)[:n]
    dangling = x[act & (deg == 0)].sum()
    fx = np.where(act, (1 - DAMPING) / n_act +
                  DAMPING * (inflow + dangling / n_act), 0.0)
    return float(np.abs(fx - x).sum())


def check_pagerank_advance(csr, ri, rs, tol):
    """Hold an incremental PageRank to the push's own guarantee, L1
    within tol/2 of the fixed point (so a residual of at most
    (1 - d) tol / 2), and to the scratch run within tol/2 plus the
    scratch run's own distance. ``slack`` is the float32 rounding of the
    stored ranks (2^-24 relative per entry, through I - dP)."""
    adv = ri.raw.astype(np.float64)
    scr = rs.raw.astype(np.float64)
    slack = (1 + DAMPING) * 2.0 ** -24 * np.abs(adv).sum()
    res_adv = pagerank_residual_l1(csr, adv)
    res_scr = pagerank_residual_l1(csr, scr)
    l1 = float(np.abs(adv - scr).sum())
    if res_adv > (1 - DAMPING) * tol / 2 + slack:
        raise AssertionError(f"pagerank advance residual {res_adv} above "
                             f"its guarantee at tol {tol}")
    if l1 > tol / 2 + (res_scr + slack) / (1 - DAMPING):
        raise AssertionError(f"pagerank advance L1 {l1} from scratch")
    return dict(l1_from_scratch=l1, residual_l1=res_adv,
                scratch_residual_l1=res_scr)


def pagerank_float32_probe(snap, torch):
    """Why the tol run stops at its cap. 100 iterations of the port's
    float32 step (atomic adds, in no fixed order) and of the same step
    summed in a fixed order, with max|dpr| per iteration of each, and
    each step taken twice on the same ranks. The graph is symmetric, so
    a row's inflow is the sum of its neighbours' contributions over its
    own CSR row: one ``segment_reduce`` segment per row."""
    from repro_torch.analytics import algorithms as alg
    deg, edges, active, n_act = alg._pagerank_setup(snap)
    atomic = alg._pagerank_step(snap, edges, active, deg, n_act, DAMPING)
    _, ok, dst = edges
    offsets = snap.indptr.long()
    m = int(offsets[-1])
    n = offsets.shape[0] - 1

    def fixed(pr):
        contrib = alg.pagerank_contrib(snap, pr)
        vals = torch.where(ok, contrib[dst.clamp(0, n - 1).long()], 0.0)
        inflow = torch.segment_reduce(vals[:m], "sum", offsets=offsets)
        dangling = torch.where(active & (deg == 0), pr, 0.0).sum()
        return torch.where(active, (1 - DAMPING) / n_act + DAMPING *
                           (inflow + dangling / n_act), 0.0)

    out = {}
    pr0 = torch.where(active, torch.ones_like(n_act) / n_act, 0.0)
    for name, step in (("atomic", atomic), ("fixed_order", fixed)):
        pr, changes = pr0, []
        for _ in range(100):
            nxt = step(pr)
            changes.append(float((nxt - pr).abs().max()))
            pr = nxt
        a, b = step(pr), step(pr)
        out[name] = dict(
            max_change=changes,
            first_below_tol=next((i + 1 for i, c in enumerate(changes)
                                  if c < PR_TOL), None),
            step_twice_max_abs_diff=float((a - b).abs().max()),
            step_twice_differ_entries=int((a != b).sum()))
    # the two steps compute one function: they differ by rounding only
    out["steps_max_abs_diff"] = float((atomic(pr0) - fixed(pr0)).abs().max())
    if out["steps_max_abs_diff"] > 1e-6:
        raise AssertionError(f"fixed-order PageRank step differs: {out}")
    return out


def launch_excluder():
    """``(uncounted, excluded)``: ``uncounted(fn)`` runs ``fn`` and adds
    the kernel launches it made to ``excluded`` (by kernel), so that runs
    made only to time or check an answer can be taken out of a path's
    counts."""
    from repro_torch.kernels import ops as kops
    excluded = dict.fromkeys(kops.launch_counts(), 0)

    def uncounted(fn):
        before = kops.launch_counts()
        out = fn()
        for k, v in kops.launch_counts().items():
            excluded[k] += v - before[k]
        return out
    return uncounted, excluded


def by_vertex(value: dict, vids: np.ndarray) -> np.ndarray:
    """A per-vertex answer ``{vertex ID: value}`` as an array in the order
    of ``vids`` (each must be a key)."""
    keys = np.fromiter(value.keys(), np.uint64, len(value))
    vals = np.array(list(value.values()))
    order = np.argsort(keys)
    pos = np.searchsorted(keys[order], vids)
    if not np.array_equal(keys[order][np.minimum(pos, len(keys) - 1)],
                          vids):
        raise AssertionError("a vertex is missing from a per-vertex answer")
    return vals[order][pos]


def float_errs(a: dict, b: dict, rtol=1e-5, atol=1e-7) -> dict:
    """Two per-vertex float answers with the same keys: the largest
    ``|a - b|``; the JAX suite's cross-backend error, the largest
    ``|a - b| / max(1, |b|)`` (held to 1e-5); the largest ``|a - b| /
    max(|b|, atol)``, and the vertices outside ``|a - b| <= atol + rtol
    |b|`` (1e-5 relative with an absolute floor of 1e-7; reported)."""
    if set(a) != set(b):
        raise AssertionError("per-vertex answers over different vertices")
    ks = np.fromiter(b.keys(), np.uint64, len(b))
    x, y = by_vertex(a, ks).astype(np.float64), by_vertex(
        b, ks).astype(np.float64)
    d = np.abs(x - y)
    return dict(max_abs_err=float(d.max(initial=0.0)),
                jax_suite_err=float((d / np.maximum(np.abs(y), 1.0)).max(
                    initial=0.0)),
                max_rel_err=float((d / np.maximum(np.abs(y), atol)).max(
                    initial=0.0)),
                outside_rel_1e5_abs_1e7=int(
                    (d > atol + rtol * np.abs(y)).sum()))


def sharded_program(store, name, params):
    """The sharded program of a store call alone (its ID resolution, no
    per-vertex dict): what ``analytics_result`` runs on the device."""
    from repro_torch.api import analytics_spec
    spec = analytics_spec(name)
    p = dict(params)
    dyn, queries = store._resolve_dyn(spec, p)
    fn = store.analytics_program(name, **p)
    if queries is None:
        return fn(store.state, *dyn)
    import torch
    keys, Q = store._keys(queries), store.query_batch
    for lo in range(0, len(queries), Q):
        buf = torch.full((Q, 2), 0xFFFFFFFF, dtype=torch.int64,
                         device=store.device)
        buf[:min(Q, len(queries) - lo)] = keys[lo:lo + Q]
        fn(store.state, buf)


def sharded_oracle_checks(n_vertices, ids, present, osrc, odst, ow, hub,
                          khop_src, res, local_pr, bfs_iters=32):
    """The sharded store's answers against numpy/scipy over the oracle's
    edge list: bfs depths, k-hop counts, sssp distances, PageRank (L1 to
    float64), the edge count, and WCC's labels (on this directed graph
    they flow along out-edges: the least ID of a vertex's ancestors, not
    scipy's weak components). PageRank is held per vertex as well: its
    largest relative error to float64 (over ranks past 1e-7) at most
    twice the LocalStore's (``local_pr``, the same runs) or 1e-5, so
    that the sharded sums are as accurate as the single store's."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    t0 = time.perf_counter()
    A = sp.csr_matrix((ow.astype(np.float64), (osrc, odst)),
                      shape=(n_vertices, n_vertices))
    vids = ids[present]
    out = {}
    hops = csgraph.shortest_path(A, method="D", unweighted=True,
                                 indices=hub)[present]
    want = np.where(np.isfinite(hops) & (hops <= bfs_iters), hops, -1)
    if not np.array_equal(by_vertex(res["bfs"].value, vids).astype(
            np.int64), want.astype(np.int64)):
        raise AssertionError("sharded bfs depths disagree with the oracle")
    out["bfs_reached"] = int((want >= 0).sum())
    for j, s_ in enumerate(khop_src):       # hop by hop, k = 1, 2, 3
        seen = np.zeros(n_vertices, bool)
        seen[s_] = True
        front = np.array([s_])
        for k in (1, 2, 3):
            nb = np.unique(A[front].indices) if len(front) else front
            front = nb[~seen[nb]]
            seen[front] = True
            if res[f"khop{k}"].value[j] != int(seen.sum()) - 1:
                raise AssertionError(f"sharded khop k={k} of source {j}")
    for k in (1, 2, 3):
        out[f"khop{k}_max"] = int(max(res[f"khop{k}"].value))
    dist = csgraph.dijkstra(A, directed=True, indices=hub)[present]
    d32 = by_vertex(res["sssp"].value, vids).astype(np.float64)
    fin = np.isfinite(dist)
    if not np.array_equal(fin, d32 < 1e38):
        raise AssertionError("sharded sssp reachability disagrees")
    rel = np.abs(d32[fin] - dist[fin]) / np.maximum(dist[fin], 1e-30)
    out["sssp_max_rel_err"] = float(rel.max()) if rel.size else 0.0
    if out["sssp_max_rel_err"] > 1e-5:
        raise AssertionError(f"sharded sssp relative error {rel.max()}")
    at = {"pagerank": 20, "pagerank_tol": res["pagerank_tol"].iters}
    xs, _ = host_pagerank_at(n_vertices, present, osrc, odst,
                             tuple(at.values()))
    for key, iters in at.items():
        x = xs[iters]
        d = np.abs(by_vertex(res[key].value, vids) - x[present])
        dl = np.abs(by_vertex(local_pr[key], vids) - x[present])
        out[f"{key}_l1"] = float(d.sum())
        out[f"{key}_max_rel_to_float64"] = rel = float(
            (d / np.maximum(x[present], 1e-7)).max(initial=0.0))
        out[f"{key}_local_max_rel_to_float64"] = rel_l = float(
            (dl / np.maximum(x[present], 1e-7)).max(initial=0.0))
        if out[f"{key}_l1"] > 1e-4 or rel > max(2 * rel_l, 1e-5):
            raise AssertionError(f"sharded {key} against float64 {out}")
    if res["num_edges"].value != len(osrc):
        raise AssertionError("sharded num_edges disagrees with the oracle")
    # WCC's labels flow along out-edges: each round every vertex takes the
    # least label of itself and its in-neighbours (one hop, as the owners
    # merge once a round); 64 rounds at most, as the program
    order = np.argsort(odst, kind="stable")
    ds, ss = odst[order], osrc[order]
    heads = np.flatnonzero(np.r_[True, ds[1:] != ds[:-1]])
    lab = ids.astype(np.int64)
    rounds, changed = 0, True
    while changed and rounds < 64:
        pulled = np.minimum.reduceat(lab[ss], heads) if len(ss) else lab[:0]
        new = lab.copy()
        new[ds[heads]] = np.minimum(lab[ds[heads]], pulled)
        changed = bool((new[present] < lab[present]).any())
        lab, rounds = new, rounds + 1
    if not np.array_equal(by_vertex(res["wcc"].value, vids).astype(
            np.int64), lab[present]):
        raise AssertionError("sharded wcc labels disagree with the oracle")
    out.update(wcc_rounds=rounds, wcc_labels=int(np.unique(
        lab[present]).size))
    out["oracle_s"] = time.perf_counter() - t0
    return out


def sharded_analytics_profile(store, torch, iters=2):
    """Where a sharded PageRank iteration's time goes: ``iters``
    iterations of the store's program under ``torch.profiler`` (after a
    run that builds the route): wall ms an iteration, the device's busy
    share, host ops an iteration, and the five kernels with the most
    device time (ms an iteration)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dist import graph_engine as ge
    fn = ge.make_pagerank(store.sspec, store.pspec, store.n_shards,
                          store.m_cap, iters=iters)
    fn(store.state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(store.state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = e.name.split("(")[0][:80]
            by[k] = by.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:5]
    return dict(pagerank_profile_ms_per_program=wall * 1e3,
                pagerank_profile_iters=iters,
                pagerank_profile_device_busy_share=device_busy_us(prof) /
                (wall * 1e6),
                pagerank_profile_host_ops=sum(
                    e.count for e in prof.key_averages()
                    if e.key.startswith("aten::")),
                pagerank_profile_top_kernels_ms={k: v for k, v in top})


def phase_sharded_analytics(args, torch, sh):
    """Distributed analytics on the sharded phase's final store (4 shards,
    the main path's state size): every registered analytics with a
    sharded program once through ``store.analytics_result`` (the program
    alone timed apart: device ms against host ms), held exactly to a
    ``LocalStore`` of the port on the card that took the same ops (PageRank
    and BC within 1e-5 relative) and to numpy/scipy; then advances over an
    insert-only delta of 4096 edges, each incremental and equal to a
    scratch run (PageRank in L1 to a float64 power iteration from the same
    seed). Launch counters are zeroed before and read after, less the
    launches of the reference, the timings and the checks. Returns the
    launches by kernel and each checked kernel's largest error."""
    from repro_torch.analytics import algorithms as alg
    from repro_torch.api import AnalyticsOp, OpBatch, ReadOp, make_store
    from repro_torch.core import edgepool as ep
    from repro_torch.dist import graph_engine as ge
    from repro_torch.kernels import ops as kops, sort_lookup as ks
    from repro_torch.kernels.frontier import pack_bits
    t_phase = time.perf_counter()
    card = card_line()
    store, ids, si, di, w = (sh[k] for k in ("store", "ids", "si", "di",
                                             "w"))
    n = store.n_shards
    B = store.batch
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    uncounted, excluded = launch_excluder()
    tally = {}
    untally = tally_shapes(ks, ("sort_lookup",), tally, arg=1)

    # ---- the reference: the port's LocalStore on the card, same ops ----
    t0 = time.perf_counter()
    local = make_store("local", **LJ_STORE, m_cap=2 ** 23)

    def feed():             # flushes of 256 batches: the same batches
        F = 256 * B
        for lo in range(0, len(si), F):
            r = local.apply(OpBatch.edges(ids[si[lo:lo + F]],
                                          ids[di[lo:lo + F]], w[lo:lo + F]))
            if r.dropped:
                raise AssertionError(f"reference: {r.dropped} dropped")
    uncounted(feed)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    snaps = uncounted(lambda: store.read(ReadOp("snapshot")))
    m_shard = snaps.m.tolist()
    if max(m_shard) + DELTA_EDGES >= store.m_cap:
        raise AssertionError(f"a shard's snapshot reaches m_cap {m_shard}")
    del snaps
    osrc, odst, ow = oracle(LJ_VERTICES, si, di, w)
    present = np.unique(np.concatenate([si, di]))
    rng = np.random.default_rng(args.seed + 2)
    hub = int(np.argmax(np.bincount(osrc, minlength=LJ_VERTICES)))
    khop_src = rng.choice(present, 16, replace=False)
    bc_src = rng.choice(present, 8, replace=False)
    cand = rng.integers(0, 2 ** 32, 64, dtype=np.uint64)
    ghost = int(cand[~np.isin(cand, ids)][0])       # never in the stream
    say("sharded_analytics_store", card=card, ops=len(si),
        live_edges=len(osrc), vertices=len(present),
        live_edges_per_shard=m_shard, m_cap=store.m_cap,
        query_batch=store.query_batch, reference_ingest_s=t_ref,
        hub_degree=int(np.bincount(osrc)[hub]))

    # ---- scratch: every sharded program once through the store, at an
    # epoch (the advances below start from these results) ----
    e0 = store.capture()
    ops_list = [("bfs", "bfs", dict(source=int(ids[hub]))),
                ("sssp", "sssp", dict(source=int(ids[hub]),
                                      max_iters=SSSP_ITERS)),
                ("pagerank", "pagerank", dict(iters=20)),
                ("pagerank_tol", "pagerank", dict(iters=20,
                                                  tol=PR_ADVANCE_TOL)),
                ("wcc", "wcc", {}),
                ("bc", "bc", dict(sources=ids[bc_src], max_depth=16))]
    ops_list += [(f"khop{k}", "khop", dict(sources=ids[khop_src], k=k))
                 for k in (1, 2, 3)]
    ops_list += [("degree_map", "degree_map", {}),
                 ("num_edges", "num_edges", {}),
                 ("bfs_absent", "bfs", dict(source=ghost))]
    res, rows, local_pr = {}, [], {}
    for key, name, params in ops_list:
        op = AnalyticsOp(name, params)
        s0, f0 = ep.SYNCS["host_syncs"], kops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[key] = store.analytics_result(op, e0)
        torch.cuda.synchronize()
        store_ms = (time.perf_counter() - t0) * 1e3
        f1, s1 = kops.launch_counts(), ep.SYNCS["host_syncs"]
        t0 = time.perf_counter()
        uncounted(lambda: sharded_program(store, name, params))
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t0) * 1e3
        row = dict(op=key, device_ms=dev_ms, store_ms=store_ms,
                   host_ms=store_ms - dev_ms, iters=res[key].iters,
                   host_fetches=s1 - s0,
                   frontier_launches=f1["frontier_expand"] -
                   f0["frontier_expand"],
                   sort_lookup_launches=f1["sort_lookup"] -
                   f0["sort_lookup"])
        rows.append(row)
        if name == "wcc":       # held to the host oracle below
            continue
        t0 = time.perf_counter()
        want = uncounted(lambda: local.analytics_result(op))
        torch.cuda.synchronize()
        row["local_store_ms"] = (time.perf_counter() - t0) * 1e3
        row["local_iters"] = want.iters
        a, b = res[key].value, want.value
        if name in ("pagerank", "bc"):
            row.update(float_errs(a, b))
            if row["jax_suite_err"] > 1e-5:
                raise AssertionError(f"sharded {key} differs from the "
                                     f"LocalStore's: {row}")
            if name == "pagerank":      # both held to float64 below
                local_pr[key] = b
        else:
            row.update(max_abs_err=0.0)
            same = np.array_equal(a, b) if isinstance(a, np.ndarray) \
                else a == b
            if not same:
                raise AssertionError(f"sharded {key} differs from the "
                                     "LocalStore's")
    if set(res["bfs_absent"].value.values()) != {-1}:
        raise AssertionError("a bfs from an absent source reached a vertex")
    say("sharded_analytics", card=card, ops=rows, vs="LocalStore: equal; "
        "pagerank and bc |a - b| / max(1, |b|) <= 1e-5 at every vertex (the "
        "JAX suite's cross-backend rule; max_rel_err = |a - b| / max(|b|, "
        "1e-7) and the vertices outside 1e-7 + 1e-5 |b| are reported); "
        "wcc: the host oracle (on a directed graph the two backends' WCC "
        "differ)")
    del local
    torch.cuda.empty_cache()
    checks = sharded_oracle_checks(LJ_VERTICES, ids, present, osrc, odst,
                                   ow, hub, khop_src, res, local_pr)
    say("sharded_analytics_oracle", card=card, oracle="agrees", **checks)

    # ---- the largest BFS level, as the frontier kernel saw it (e0) ----
    depth = res["bfs"].raw
    _, _, mine = ge._row_meta(e0.state, n)
    mine = mine.cpu().numpy()
    lv = int(np.argmax(np.bincount(depth[mine & (depth >= 0)])))
    on = (depth == lv) & mine
    s_ = int(np.argmax(on.sum(1)))
    snap_s = ge.shard_view(uncounted(lambda: store.read(ReadOp("snapshot"),
                                                        at=e0)), s_)
    n_cap = depth.shape[1]
    level = (s_, alg._frontier_view(snap_s, alg.csr_edges(snap_s)),
             pack_bits(torch.from_numpy(on[s_]).to(store.device),
                       (n_cap + 31) // 32), lv, int(on[s_].sum()))
    del snap_s

    # ---- advances over an insert-only delta (lighter than every base
    # weight: no weight increase), each held to a scratch run ----
    inc_ops = [("bfs", "bfs", dict(source=int(ids[hub]))),
               ("sssp", "sssp", dict(source=int(ids[hub]),
                                     max_iters=SSSP_ITERS)),
               ("wcc", "wcc", {}),
               ("pagerank_tol", "pagerank", dict(iters=20,
                                                 tol=PR_ADVANCE_TOL)),
               ("degree_map", "degree_map", {}),
               ("num_edges", "num_edges", {})]
    _, dsi, ddi = powerlaw_stream(rng, LJ_VERTICES, DELTA_EDGES, ids)
    dw = rng.uniform(0.1, 0.5, DELTA_EDGES).astype(np.float32)
    if store.apply(OpBatch.edges(ids[dsi], ids[ddi], dw)).dropped:
        raise AssertionError("the delta dropped ops")
    e1 = store.capture()
    t0 = time.perf_counter()
    deltas, reason = store._delta(e0, e1)
    extract_ms = (time.perf_counter() - t0) * 1e3
    if deltas is None:
        raise AssertionError(f"sharded delta refused: {reason}")
    si1, di1 = np.concatenate([si, dsi]), np.concatenate([di, ddi])
    osrc1, odst1, _ow1 = oracle(LJ_VERTICES, si1, di1,
                                np.concatenate([w, dw]))
    present1 = np.unique(np.concatenate([si1, di1]))
    adv = []
    for key, name, params in inc_ops:
        op = AnalyticsOp(name, params)
        s0 = ep.SYNCS["host_syncs"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ri = store.analytics_advance(op, res[key], e1)
        torch.cuda.synchronize()
        adv_ms = (time.perf_counter() - t0) * 1e3
        fetches = ep.SYNCS["host_syncs"] - s0
        t0 = time.perf_counter()
        rs = uncounted(lambda: store.analytics_result(op, e1))
        torch.cuda.synchronize()
        scr_ms = (time.perf_counter() - t0) * 1e3
        if ri.mode != "incremental":
            raise AssertionError(f"sharded {key} advance fell back: "
                                 f"{ri.reason}")
        row = dict(op=key, mode=ri.mode, advance_ms=adv_ms,
                   scratch_ms=scr_ms, advance_iters=ri.iters,
                   scratch_iters=rs.iters, host_fetches=fetches)
        if name == "pagerank":
            # a warm power iteration stopped by max|dpr| < tol: held to
            # float64 iterations from the same seed (0 for a vertex new in
            # the window) and from uniform, as many as each run took
            vids = ids[present1]
            x0 = np.zeros(LJ_VERTICES)
            prev = res[key].value
            x0[present1] = [prev.get(int(v), 0.0) for v in vids.tolist()]
            xa, _ = host_pagerank(LJ_VERTICES, present1, osrc1, odst1,
                                  ri.iters, x0=x0)
            xs, _ = host_pagerank(LJ_VERTICES, present1, osrc1, odst1,
                                  rs.iters)
            got_a, got_s = by_vertex(ri.value, vids), by_vertex(rs.value,
                                                                 vids)
            row.update(l1_to_float64=float(np.abs(got_a - xa[present1])
                                           .sum()),
                       scratch_l1_to_float64=float(np.abs(
                           got_s - xs[present1]).sum()),
                       l1_from_scratch=float(np.abs(got_a - got_s).sum()))
            if max(row["l1_to_float64"], row["scratch_l1_to_float64"]) > \
                    1e-4:
                raise AssertionError(f"sharded pagerank advance L1 {row}")
        elif ri.value != rs.value:
            raise AssertionError(f"sharded {key} advance differs from "
                                 "scratch")
        adv.append(row)
    say("sharded_analytics_advance", card=card, delta_edges=DELTA_EDGES,
        delta_changed=sum(d.n_changed for d in deltas), extract_ms=extract_ms,
        ops=adv)
    untally()
    torch.cuda.synchronize()
    launches = {k: v - excluded[k] for k, v in kops.launch_counts().items()}
    for k in ("frontier_expand", "sort_lookup"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "sharded analytics")
    peak = torch.cuda.max_memory_allocated()
    # the kernels at this phase's new shapes: sort_lookup at every key
    # count the sharded phase did not call, the frontier kernel at the
    # largest BFS level
    new = {k: v for k, v in tally.items() if k not in sh["tally"]}
    errs = sharded_kernel_checks(store, store.state, new, launches, torch,
                                 level=level, must=("frontier_expand",
                                                    "sort_lookup"),
                                 line="sharded_analytics_kernel_shapes")
    profile = uncounted(lambda: sharded_analytics_profile(store, torch))
    say("sharded_analytics_path", card=card, launches=launches,
        uncounted_launches=excluded, sort_lookup_keys={
            str(k[1]): v for k, v in sorted(tally.items())},
        peak_memory_bytes=peak,
        seconds=round(time.perf_counter() - t_phase, 3), **profile)
    del e0, e1, res, deltas
    return launches, errs


# the sharded durability and service phases: the durable directory, the
# ops through the durable store before the delta checkpoint, the ops left
# in the WAL, the 4 batches both stores take after recovery, and the
# service's steps (analytics every 4th)
SHARDED_DURABLE_OPS = 1 << 17
SHARDED_WAL_ONLY_OPS = 1 << 15
RESUME_BATCHES = 4
SHARDED_SERVICE_STEPS = 8
# the script's time limit: the sharded service takes fewer steps (a
# multiple of 4, at least 4; ``reduced`` is printed) where the time spent
# so far projects past it less a margin: in H100 runs of this script the
# phases after the service took 0.47-0.51 of the time before it, and a
# service step about 4 s beside 30 s of set-up and checks
TIME_LIMIT_S = 1200
TIME_MARGIN_S = 80


def phase_sharded_durability(args, torch, sh):
    """The sharded phase's final store (4 shards, 5.4 GB of state) in a
    ``DurableStore`` (group commit 32, the JAX defaults; the directory
    under ``build/``, removed at the end; the phase fails first if the
    disk there holds under 3 x the state): a full checkpoint, 2^17 mixed
    ops, a checkpoint that must be a delta, 2^15 ops left in the WAL;
    recovery into a fresh sharded store of the same spec, launch counters
    zeroed just before (the replay must launch ``append``,
    ``compact_rows`` and ``sort_lookup``; no rebuild may go dense); every
    leaf (the pool's entries on owned blocks), the sync watermark, reads
    of 4096 IDs, ``num_edges`` and ``num_vertices`` equal the live
    store's; then both take 4 more batches and stay leaf-equal. Returns
    the recovered durable store (its directory kept for the service
    phase), the directory's root and the replay's launches by kernel."""
    import pathlib
    import shutil
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.core import edgepool as ep
    from repro_torch.kernels import ops as kops
    from repro_torch.storage import DurableStore, recover
    from repro_torch.storage.checkpoint import flatten_named
    from repro_torch.storage.crash_smoke import assert_states_equal
    store, ids, si = sh["store"], sh["ids"], sh["si"]
    root = pathlib.Path(ROOT) / "build" / "sharded_durability"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    state_bytes = nbytes(store.state)
    free = shutil.disk_usage(root).free
    if free < 3 * state_bytes:
        raise AssertionError(
            f"sharded durability: {free} bytes free under {root}, under 3 "
            f"x the state ({state_bytes} bytes)")
    B = store.batch
    ddir = root / "store"
    dur = DurableStore(store, ddir, group_commit=GROUP_COMMIT)
    ckpts = []

    def checkpoint(after_ops):
        parts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        man = dur.checkpoint(timings=parts)
        ckpts.append(dict(
            after_ops=after_ops, kind=man["kind"], why_full=man["why_full"],
            bytes=man["bytes"], ms=(time.perf_counter() - t0) * 1e3,
            **{f"{k}_ms": v for k, v in parts.items()},
            touched_blocks=(man["delta"] or {}).get("n_blocks"),
            pool_blocks=int(store.state.pool.owner.numel())))
        return man

    rng = np.random.default_rng(args.seed + 17)
    extra = 16 * B
    n = SHARDED_DURABLE_OPS + extra + SHARDED_WAL_ONLY_OPS + \
        RESUME_BATCHES * B
    _, dsi, ddi = powerlaw_stream(rng, LJ_VERTICES, n, ids)
    dw = rng.uniform(0.5, 2.0, n).astype(np.float32)
    dw[rng.random(n) < 0.25] = 0.0
    tot = dict(ops=0, s=0.0, wal_ms=0.0, records=0, bytes=0, syncs=0)

    def run(lo, hi):
        wal = dur.wal
        r0, b0, y0 = wal.records_written, wal.bytes_written, wal.syncs
        torch.cuda.synchronize()
        t0, wal0 = time.perf_counter(), dur.wal_stats["wal_ms"]
        for a in range(lo, hi, B):
            b = min(a + B, hi)
            res = dur.apply(OpBatch.edges(ids[dsi[a:b]], ids[ddi[a:b]],
                                          dw[a:b]))
            if res.dropped:
                raise AssertionError(f"sharded durability: {res.dropped} "
                                     "ops dropped")
        torch.cuda.synchronize()
        tot["s"] += time.perf_counter() - t0
        tot["wal_ms"] += dur.wal_stats["wal_ms"] - wal0
        tot["ops"] += hi - lo
        tot["records"] += wal.records_written - r0
        tot["bytes"] += wal.bytes_written - b0
        tot["syncs"] += wal.syncs - y0
        return hi

    checkpoint(0)
    pos = run(0, SHARDED_DURABLE_OPS)
    man = checkpoint(pos)
    if man["kind"] != "delta":
        say("sharded_durability_full_again", why_full=man["why_full"])
        pos = run(pos, pos + extra)
        man = checkpoint(pos)
    if not any(c["kind"] == "delta" for c in ckpts):
        raise AssertionError(f"sharded durability: no delta: {ckpts}")
    wal_only = dur.wal.records_written
    pos = run(pos, pos + SHARDED_WAL_ONLY_OPS)
    wal_only = dur.wal.records_written - wal_only
    dur.sync()
    dur.close()
    say("sharded_durability", card=card_line(), free_bytes=free,
        state_bytes=state_bytes, n_shards=store.n_shards,
        group_commit=GROUP_COMMIT, durable_ops=tot["ops"],
        durable_updates_per_s=tot["ops"] / tot["s"], apply_s=tot["s"],
        wal_ms=tot["wal_ms"],
        wal_share_of_apply=tot["wal_ms"] / (tot["s"] * 1e3),
        wal_records=tot["records"], wal_bytes=tot["bytes"],
        wal_syncs_group_commit=tot["syncs"], checkpoints=ckpts,
        delta_over_full_bytes=[c["bytes"] / ckpts[0]["bytes"]
                               for c in ckpts if c["kind"] == "delta"])

    # ---- recovery into a fresh sharded store on the card ----
    parts = {}
    torch.cuda.empty_cache()
    kops.reset_launch_counts()
    s0 = dict(ep.SYNCS)
    t0 = time.perf_counter()
    rec, report = recover(ddir, lambda: make_store("sharded",
                                                   **SHARDED_STORE),
                          timings=parts, group_commit=GROUP_COMMIT)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = kops.launch_counts()
    syncs = {k: ep.SYNCS[k] - s0[k] for k in s0}
    if syncs["defrag_dense"]:
        raise AssertionError("sharded durability: a replayed rebuild went "
                             "dense")
    for k in ("append", "compact_rows", "sort_lookup") + (
            ("defrag_rows",) if syncs["defrag_stream"] else ()):
        if launches[k] <= 0:
            raise AssertionError(f"sharded durability: the replay did not "
                                 f"launch {k}")
    if report["replayed"] != wal_only or report["gap_at"] is not None \
            or str(report["wal_tail"]) != "ok" \
            or report["checkpoint_kind"] != ckpts[-1]["kind"]:
        raise AssertionError(f"sharded durability: recovery report "
                             f"{report}")
    dead = assert_states_equal(store.state, rec.state, "sharded recovered")
    if not np.array_equal(store._synced_rows, rec._synced_rows):
        raise AssertionError("sharded durability: sync watermark differs")
    present = np.unique(si)
    q = ids[np.sort(rng.choice(present, min(4096, len(present)),
                               replace=False))]
    t_reads = time.perf_counter()
    for kind in ("lookup", "degree"):
        if not np.array_equal(store.read(ReadOp(kind, ids=q)),
                              rec.read(ReadOp(kind, ids=q))):
            raise AssertionError(f"sharded durability: recovered {kind} "
                                 "differs")
    for (ia, wa), (ib, wb) in zip(store.read(ReadOp("neighbors", ids=q)),
                                  rec.read(ReadOp("neighbors", ids=q))):
        if not (np.array_equal(ia, ib) and np.array_equal(wa, wb)):
            raise AssertionError("sharded durability: recovered neighbors "
                                 "differ")
    counts = {}
    for kind in ("num_edges", "num_vertices"):
        a, b = store.read(ReadOp(kind)), rec.read(ReadOp(kind))
        if a != b:
            raise AssertionError(f"sharded durability: {kind} {b} != {a}")
        counts[kind] = a
    t_reads = time.perf_counter() - t_reads
    # a deterministic resume: both take the same batches, stay equal
    for a in range(pos, pos + RESUME_BATCHES * B, B):
        batch = OpBatch.edges(ids[dsi[a:a + B]], ids[ddi[a:a + B]],
                              dw[a:a + B])
        if store.apply(batch).dropped or rec.apply(batch).dropped:
            raise AssertionError("sharded durability: resume dropped ops")
    dead_resumed = assert_states_equal(store.state, rec.state,
                                       "sharded resumed")
    say("sharded_recovery", card=card_line(), seconds=rec_s,
        report={k: str(v) if k == "wal_tail" else v
                for k, v in report.items()},
        read_ms=parts.get("read", 0.0), crc_ms=parts.get("crc", 0.0),
        h2d_ms=parts.get("h2d", 0.0), replay_ms=parts["replay"],
        replayed_ops=parts["replayed_ops"],
        replayed_ops_per_s=parts["replayed_ops"] / parts["replay"] * 1e3,
        replay_launches=launches,
        replay_rebuilds_stream=syncs["defrag_stream"],
        replay_rebuilds_dense=syncs["defrag_dense"],
        state_leaves=len(flatten_named(store.state)),
        unowned_blocks_differing=dead, reads_checked=len(q),
        reads_s=t_reads, synced_rows=rec._synced_rows.tolist(), **counts,
        resumed_batches=RESUME_BATCHES,
        unowned_blocks_differing_resumed=dead_resumed,
        equal="every leaf (the pool's entries on owned blocks), the sync "
              "watermark, reads; after the resume too")
    return rec, root, launches


def service_steps(elapsed_s: float) -> int:
    """The sharded service's steps that keep the projected script time
    inside ``TIME_LIMIT_S`` less ``TIME_MARGIN_S`` (see above)."""
    room = TIME_LIMIT_S - TIME_MARGIN_S - 1.5 * elapsed_s - 30
    return int(max(4, min(SHARDED_SERVICE_STEPS, room // 4 // 4 * 4)))


def phase_sharded_service(args, torch, sh, rec, root, elapsed_s=0.0):
    """A ``GraphQueryService`` with durable-ack over the recovered durable
    sharded store: 8 write micro-batches of 4096 ops (``service_steps``
    of ``elapsed_s``, the script's time so far), a 4096-ID degree query
    every step, bfs from the hub, wcc and PageRank (tol 1e-4)
    every 4th step (one cold analytics run fits a step's read budget, so
    each waits its turn). At the last sealed epoch every answer equals a
    scratch ``analytics_result`` (PageRank: |a - b| / max(1, |b|) <=
    1e-5); a read submitted with a write answers from the previous epoch;
    ``durable_syncs`` counts the steps that wrote. Returns the launches by
    kernel of the service's steps."""
    import shutil
    from repro_torch.api import ReadOp
    from repro_torch.kernels import ops as kops
    from repro_torch.serve import GraphQueryService
    from repro_torch.serve.graph_service import Query
    from repro_torch.storage import read_wal
    card = card_line()
    ids, si = sh["ids"], sh["si"]
    B = rec.batch
    rng = np.random.default_rng(args.seed + 19)
    hub = int(ids[np.argmax(np.bincount(si, minlength=LJ_VERTICES))])
    present = np.unique(si)
    qids = ids[rng.choice(present, min(4096, len(present)), replace=False)]
    steps = service_steps(elapsed_s)
    _, vsi, vdi = powerlaw_stream(rng, LJ_VERTICES, steps * B, ids)
    # inserts and updates (a tombstone refuses the monotone advances)
    vw = rng.uniform(0.5, 2.0, steps * B).astype(np.float32)
    queries = (("bfs", dict(source=hub)), ("wcc", {}),
               ("pagerank", dict(tol=PR_ADVANCE_TOL)))
    svc = GraphQueryService(rec, query_batch=2 * 4096)
    if not svc.durable_ack:
        raise AssertionError("sharded service: durable-ack is off")
    reasons = {}
    advance = rec.inner.analytics_advance

    def tally(op, prev, at):        # why each service answer took its path
        r = advance(op, prev, at)
        k = f"{op.name}:{r.mode}:{r.reason}"
        reasons[k] = reasons.get(k, 0) + 1
        return r
    rec.inner.analytics_advance = tally
    uncounted, excluded = launch_excluder()
    kops.reset_launch_counts()
    lat, pinned = [], 0
    t_start = time.perf_counter()
    for step_ in range(steps):
        sl = slice(step_ * B, (step_ + 1) * B)
        if not svc.submit_update(ids[vsi[sl]], ids[vdi[sl]], vw[sl]):
            raise AssertionError("sharded service refused a write")
        before = svc._sealed
        td = svc.submit_query("degree", ids=qids)
        if step_ % 4 == 3:
            for name, params in queries:
                svc.submit_query(name, **params)
        t0 = time.perf_counter()
        svc.step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if step_ < 2:       # answered in the step of its write: old epoch
            want = uncounted(lambda: rec.read(ReadOp("degree", ids=qids),
                                              at=before))
            if not np.array_equal(svc.results[td], want):
                raise AssertionError("sharded service: a read saw the "
                                     "write of its own step")
            pinned += 1
    wall = time.perf_counter() - t_start
    while svc._reads:                   # deferred reads: no more writes
        svc.step()
    if svc.pending_writes:
        raise AssertionError("sharded service left writes queued")
    sealed = svc._sealed
    tickets = [(svc.submit_query(name, **params), name, params)
               for name, params in queries]
    td = svc.submit_query("degree", ids=qids)
    svc.run()
    stats = svc.stats
    torch.cuda.synchronize()
    launches = {k: v - excluded[k] for k, v in kops.launch_counts().items()}
    checks = {}
    for t, name, params in tickets:
        op = svc._build_op(Query(ticket=-1, kind=name, params=params))
        want = uncounted(lambda: rec.analytics_result(op, sealed)).value
        got = svc.results[t]
        if name == "pagerank":
            vids = np.fromiter(want.keys(), np.uint64, len(want))
            a, b = by_vertex(got, vids), by_vertex(want, vids)
            rel = float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
            checks[name] = dict(max_rel=rel, l1=float(np.abs(a - b).sum()),
                                vertices=len(vids))
            if set(got) != set(want) or rel > 1e-5:
                raise AssertionError(f"sharded service pagerank {rel}")
        else:
            checks[name] = dict(vertices=len(want))
            if got != want:
                raise AssertionError(f"sharded service {name} differs from "
                                     "scratch at its last sealed epoch")
    if not np.array_equal(svc.results[td], uncounted(lambda: rec.read(
            ReadOp("degree", ids=qids), at=sealed))):
        raise AssertionError("sharded service degrees differ at the sealed "
                             "epoch")
    if stats["durable_syncs"] != steps:
        raise AssertionError(f"sharded service: {stats['durable_syncs']} "
                             f"durable syncs for {steps} writing steps")
    scan = read_wal(rec.wal.path)
    if str(scan.tail) != "ok" or len(scan.records) != steps + \
            RESUME_BATCHES:
        raise AssertionError(f"sharded service: the WAL scans back "
                             f"{len(scan.records)} records, tail "
                             f"{scan.tail}")
    if not stats["analytics_incremental"]:
        raise AssertionError("sharded service: no answer advanced")
    for k in ("append", "compact_rows", "sort_lookup", "frontier_expand"):
        if launches[k] <= 0:
            raise AssertionError(f"sharded service: kernel {k} was not "
                                 "launched")
    if steps < SHARDED_SERVICE_STEPS:
        say("reduced", sharded_service_steps=steps)
    say("sharded_service", card=card, steps=steps, write_ops=steps * B,
        ops_per_s=steps * B / wall, wall_s=wall,
        step_p50_ms=float(np.percentile(lat, 50)),
        step_p99_ms=float(np.percentile(lat, 99)),
        analytics_incremental=stats["analytics_incremental"],
        analytics_scratch=stats["analytics_scratch"],
        durable_syncs=stats["durable_syncs"],
        epochs_sealed=stats["epochs_sealed"],
        retained_epochs=stats["retained_epochs"],
        wal_records_scanned=len(scan.records), pinned_reads_checked=pinned,
        paths=reasons,
        launches=launches, uncounted_launches=excluded, checks=checks,
        answers="equal scratch at the last sealed epoch")
    rec.close()
    shutil.rmtree(root, ignore_errors=True)
    return launches


LAUNCH_MODES = {
    "persist": [], "serve": [], "ingest": [],
    "analytics": ["--incremental", "--algs", "bfs,pagerank,wcc,sssp,bc"],
}


def launch_mode_path(mode: str) -> str:
    tag = "__incremental" if mode == "analytics" else ""
    return os.path.join(ROOT, "benchmarks", "results", "dryrun",
                        f"torch-radixgraph-{mode}__4shards{tag}.json")


def launch_mode_checks(recs) -> list:
    """The ingest and analytics records against the route buffers'
    shapes: the ingest exchange one (n_dst, batch a shard, 6) buffer of
    words, a BFS level's (n_dst, n_cap, 3), each word 4 bytes (JAX's
    uint32 words); every run's argument bytes the state's bytes
    (``state_bytes``) / 4."""
    fails = []
    ing = recs["ingest"]
    want = 4 * ing["batch_per_shard"] * 6      # (n_dst, cap, 6) words
    if ing["collective_elements"]["all-to-all"] != want or \
            ing["collective_counts"]["all-to-all"] != 1:
        fails.append(f"ingest all-to-all {ing['collective_elements']} "
                     f"x {ing['collective_counts']}, want {want} x 1")
    for name, r in (("ingest", ing),
                    ("bfs", recs["analytics"]["algs"]["bfs"])):
        if r["collective_bytes"]["all-to-all"] != \
                4 * r["collective_elements"]["all-to-all"]:
            fails.append(f"{name} all-to-all {r['collective_bytes']} B, "
                         f"want 4 a word")
    n_cap = recs["analytics"]["n_cap"]
    bfs = recs["analytics"]["algs"]["bfs"]
    levels = bfs["collective_counts"]["all-to-all"]
    if not levels or bfs["collective_elements"]["all-to-all"] != \
            levels * 4 * n_cap * 3:
        fails.append(f"bfs all-to-all {bfs['collective_elements']} over "
                     f"{levels} levels, want {4 * n_cap * 3} a level")
    runs = [ing] + list(recs["analytics"]["algs"].values())
    for name, r in zip(["ingest"] + list(recs["analytics"]["algs"]), runs):
        if r["memory"]["argument_size_in_bytes"] != r["state_bytes"] // 4:
            fails.append(f"{name}: argument bytes "
                         f"{r['memory']['argument_size_in_bytes']} != "
                         f"state {r['state_bytes']} / 4")
        if not r["collective_counts"]["all-to-all"]:
            fails.append(f"{name}: no exchange")
    if ing["ops_dropped"]:
        fails.append(f"ingest dropped {ing['ops_dropped']} ops")
    return fails


def phase_launch_modes(torch):
    """``python -m repro_torch.launch.dryrun_graph --mode persist``,
    ``serve``, ``ingest`` and ``analytics --incremental`` (every
    algorithm) at 4 shards (their other sizes the defaults), four
    subprocesses on the card side by side (each mostly its own start-up
    and host work): exit code 0, ``recovery_bit_exact`` true, the serve
    and ingest records' ``ops_dropped`` 0, ``launch_mode_checks``; the
    records printed. Returns the ingest and analytics runs' kernel
    launches, summed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs, recs = {}, {}
    for mode in LAUNCH_MODES:
        if os.path.exists(launch_mode_path(mode)):
            os.remove(launch_mode_path(mode))
    t0 = time.perf_counter()
    try:
        for mode, extra in LAUNCH_MODES.items():
            procs[mode] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun_graph",
                 "--mode", mode, "--shards", "4", "--device",
                 LJ_STORE["device"]] + extra, env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(
                    f"dryrun_graph --mode {mode} failed (rc "
                    f"{proc.returncode}):\n{out[-2000:]}\n{err[-4000:]}")
            with open(launch_mode_path(mode)) as f:
                recs[mode] = json.load(f)
            recs[mode]["subprocess_s"] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if recs["persist"]["recovery_bit_exact"] is not True:
        raise AssertionError("persist: recovery not bit-exact")
    if recs["serve"]["ops_dropped"] != 0:
        raise AssertionError("serve: ops dropped")
    for rec in recs.values():
        if rec["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"launch mode ran on {rec['device']}")
    fails = launch_mode_checks(recs)
    launches = dict(recs["ingest"]["launch_counts"])
    for r in recs["analytics"]["algs"].values():
        for k, v in r["launch_counts"].items():
            launches[k] = launches.get(k, 0) + v
    say("launch_modes", card=card_line(), launches=launches,
        failed=fails or None, **recs)
    if fails:
        raise AssertionError(f"launch_modes: {fails}")
    return launches


ART_PREFIX = 1 << 14        # art_insert against its plain loop
ART_PLAIN_ON_CARD = 256     # the plain loop on the card: a few keys only
STATE_CHECK_KEYS = 1 << 16  # card vs CPU runs of both indices


ART_TIMING_REPS = 10        # profiled art_insert calls, each on a fresh tree


def art_states_equal(a, b, where) -> float:
    """Raise unless two ``ArtState``s are equal tensor for tensor (each of
    ``b``'s moved to ``a``'s device in turn, so a 7.5 GB tree needs one
    tensor's room more); returns the largest difference (0.0)."""
    import torch
    for k, (x, y) in enumerate(zip(leaves(a), leaves(b))):
        y = y.to(x.device)
        if x.shape != y.shape:
            raise AssertionError(f"{where}: tensor {k}: shape "
                                 f"{tuple(x.shape)} != {tuple(y.shape)}")
        if not torch.equal(x, y):
            err = float((x.long() - y.long()).abs().max())
            raise AssertionError(f"{where}: tensor {k} differs (max abs "
                                 f"err {err})")
    return 0.0


def art_touched_bytes(st) -> int:
    """The bytes of an ``ArtState`` a walk that built it from a fresh tree
    touched: per layer its ``scount`` sparse rows (keys, children, dense
    row) and ``dcount`` dense rows, each read once and written once, and
    the counters."""
    sc, dc = int(st.scount.sum()), int(st.dcount.sum())
    rows = sc * (2 * 16 * 4 + 4) + dc * 256 * 4
    return 2 * (rows + nbytes((st.scount, st.dcount, st.overflow)))


def art_tree_checks(st, ids, key_bits):
    """The tree of ``TorchART.insert(ids)`` against a host count of its
    prefixes: a layer's nodes are the distinct prefixes of that many bytes
    (the root at layer 0), its dense rows the nodes with more than 16
    distinct children; no overflow where these fit the capacities. Every
    row past a layer's counts must still hold -1 (no write went astray).
    Returns the host counts."""
    L = len(st.skeys)
    nodes, dense = [], []
    for i in range(L):
        kids = np.unique(ids >> np.uint64(key_bits - 8 * (i + 1)))
        _, fan = np.unique(kids >> np.uint64(8), return_counts=True)
        nodes.append(len(fan))
        dense.append(int((fan > 16).sum()))
        if nodes[i] > st.skeys[i].shape[0] or \
                dense[i] > st.dchild[i].shape[0]:
            raise AssertionError(f"art: layer {i} needs {nodes[i]} nodes "
                                 f"and {dense[i]} dense rows: past the "
                                 "tree's capacity")
    got = (st.scount.tolist(), st.dcount.tolist(), int(st.overflow))
    if got != (nodes, dense, 0):
        raise AssertionError(f"art: (nodes, dense rows, overflow) {got}, "
                             f"the host count {(nodes, dense, 0)}")
    for i in range(L):
        s, d = nodes[i], dense[i]
        for name, rest in (("skeys", st.skeys[i][s:]),
                           ("schild", st.schild[i][s:]),
                           ("dense_of", st.dense_of[i][s:]),
                           ("dchild", st.dchild[i][d:])):
            if rest.numel() and bool((rest != -1).any()):
                raise AssertionError(f"art: {name}[{i}] was written past "
                                     "its layer's count")
    return dict(nodes=nodes, dense_rows=dense)


def phase_baselines(args, torch, floor_per_load_ms):
    """The paper's vertex-index baselines on the card at LiveJournal's
    vertex count (IDs from 2^32 with ``--seed``): ``HashIndex`` and
    ``TorchART`` take every ID (offsets 0 .. n-1), then look up the n IDs
    and n absent ones, held to a host map (absent: -1); launch counters
    zeroed just before; the ART's counts against a host count of its
    prefixes (``art_tree_checks``). ``art_insert`` against its plain
    per-key loop (CPU) on a prefix of 2^14 IDs in trees of the same
    capacities, and on the card on 256; both indices
    on the card against their CPU runs at 2^16 IDs with repeats (the
    scatter winner rule); then ``benchmarks/torch_table5_sort_vs_art.py``
    at scale 1 and the port's SORT at n. Returns the ``kernels`` line
    entry of ``art_insert``."""
    sys.path.insert(0, ROOT)
    from benchmarks import torch_table5_sort_vs_art as t5
    from repro_torch.baselines import HashIndex, TorchART
    from repro_torch.kernels import art as kart, ops as kops
    card = card_line()
    dev = torch.device(LJ_STORE["device"])
    n = LJ_VERTICES
    rng = np.random.default_rng(args.seed + 23)
    ids = rng.choice(2 ** 32, n, replace=False).astype(np.uint64)
    cand = rng.integers(0, 2 ** 32, 2 * n, dtype=np.uint64)
    absent = cand[~np.isin(cand, ids)][:n]
    offs = np.arange(n, dtype=np.int32)
    layers, cap_s, cap_d = 4, n + 2, max(64, int(n * 0.25))
    art_bytes = layers * (cap_s * (16 * 4 * 2 + 4) + cap_d * 256 * 4) + 36
    cap = 1 << (2 * n - 1).bit_length()
    say("baselines_sizes", card=card, n=n, art_state_bytes=art_bytes,
        art_sparse_rows=cap_s, art_dense_rows=cap_d,
        hash_table_slots=cap, hash_state_bytes=cap * (8 + 8 + 4) + 8)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()

    def timed(fn):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    rows = {}
    for name, make in (("hash", lambda: HashIndex(n_max=n, device=dev)),
                       ("art", lambda: TorchART(n_max=n, device=dev))):
        index = make()
        if name == "art":       # the kernel alone, then the whole call
            radix, prep_ms = timed(lambda: index._radix(ids))
            off_t = torch.from_numpy(offs).to(dev)
            _, kernel_ms = timed(lambda: kart.art_insert(index.state, radix,
                                                         off_t))
            ins_ms = prep_ms + kernel_ms
            del radix, off_t
        else:
            _, ins_ms = timed(lambda: index.insert(ids, offs))
        got, q_ms = timed(lambda: index.lookup(np.concatenate([ids,
                                                               absent])))
        if not np.array_equal(got[:n], offs):
            bad = int((got[:n] != offs).sum())
            raise AssertionError(f"{name}: {bad} offsets differ from the "
                                 "host map")
        if not (got[n:] == -1).all():
            raise AssertionError(f"{name}: an absent ID was found")
        rows[name] = dict(insert_ms=ins_ms, insert_ops_per_s=n / ins_ms *
                          1e3, lookup_ms=q_ms, lookup_ops_per_s=2 * n /
                          q_ms * 1e3, memory_bytes=index.memory_bytes())
        if name == "art":
            counts = art_tree_checks(index.state, ids, index.key_bits)
            path_bytes = art_touched_bytes(index.state) + \
                4 * n * (index.layers + 1)
            rows[name].update(
                kernel_ms=kernel_ms, key_prep_ms=prep_ms,
                state_bytes=nbytes(index.state),
                overflow=int(index.state.overflow),
                touched_bytes=path_bytes,
                host_count="nodes, dense rows and overflow equal; rows past "
                           "them untouched", **counts)
        else:
            rows[name].update(overflow=int(index.state.overflow),
                              used=int(index.state.used))
        del index
        torch.cuda.empty_cache()
    launches = kops.launch_counts()
    if launches["art_insert"] <= 0:
        raise AssertionError("art_insert was not launched")
    peak = torch.cuda.max_memory_allocated()

    # the port's SORT at the same n: one batch insert, the same lookups
    from repro_torch.core import sort as sort_mod
    from repro_torch.core.keys import pack_keys
    from repro_torch.core.sort import SortSpec
    from repro_torch.core.sort_optimizer import optimize_sort
    spec = SortSpec.from_config(optimize_sort(n, 32, 5), n + 8)
    keys = pack_keys(ids, 32, dev)
    qkeys = pack_keys(np.concatenate([ids, absent]), 32, dev)
    st = sort_mod.make_sort(spec, dev)
    st, s_ins = timed(lambda: sort_mod.insert_mappings(
        spec, st, keys, torch.arange(n, dtype=torch.int32, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev)))
    got, s_q = timed(lambda: sort_mod.lookup(spec, st, qkeys))
    got = got.cpu().numpy()
    if not (np.array_equal(got[:n], offs) and (got[n:] == -1).all()):
        raise AssertionError("SORT at n disagrees with the host map")
    rows["sort"] = dict(insert_ms=s_ins, insert_ops_per_s=n / s_ins * 1e3,
                        lookup_ms=s_q, lookup_ops_per_s=2 * n / s_q * 1e3,
                        memory_bytes=int(sort_mod.materialized_slots(
                            spec, st)) * 4)
    del st, keys, qkeys
    say("baselines", card=card, n=n, absent=len(absent), oracle="agrees",
        launches=launches, peak_memory_bytes=peak, **rows)

    # ---- art_insert against its plain loop, on the same inputs, in
    # trees of the main path's capacities ----
    pre = ids[:ART_PREFIX]
    card_art = TorchART(n_max=n, device=dev)
    radix = card_art._radix(pre)
    off_t = torch.arange(ART_PREFIX, dtype=torch.int32, device=dev)
    _, k_ms = timed(lambda: kart.art_insert(card_art.state, radix, off_t))
    host_art = TorchART(n_max=n, device="cpu")
    t0 = time.perf_counter()
    kart.art_insert_plain(host_art.state, radix.cpu(), off_t.cpu())
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = art_states_equal(card_art.state, host_art.state, "art_insert")
    moved = art_touched_bytes(card_art.state) + radix.numel() * 4 + \
        off_t.numel() * 4
    del card_art, host_art
    torch.cuda.empty_cache()
    few = TorchART(n_max=ART_PREFIX + 8, device=dev)
    few_k = TorchART(n_max=ART_PREFIX + 8, device=dev)
    _, plain_card_ms = timed(lambda: kart.art_insert_plain(
        few.state, radix[:ART_PLAIN_ON_CARD], off_t[:ART_PLAIN_ON_CARD]))
    kart.art_insert(few_k.state, radix[:ART_PLAIN_ON_CARD],
                    off_t[:ART_PLAIN_ON_CARD])
    art_states_equal(few.state, few_k.state, "art_insert (plain on card)")
    del few, few_k
    # times: each call on a fresh tree (its time does not depend on the
    # rows it does not touch, so a small one): CUDA events around one call
    # (median of 6), and the kernel's own time from profiler events

    def fresh_call():
        return kart.art_insert(TorchART(n_max=ART_PREFIX + 8,
                                        device=dev).state, radix, off_t)
    ms = float(np.median([timed(fresh_call)[1] for _ in range(6)]))
    prof = device_ms(fresh_call, lambda: kops.launch_counts()["art_insert"],
                     reps=ART_TIMING_REPS)
    # the bound: the bytes the walk touched (keys, offsets, and the rows
    # it created or read, once read and once written) over the memory
    # rate; the chain estimate: one dependent load a layer a key at the
    # sort_lookup floor per load
    bound = moved / HBM_BYTES_PER_S * 1e3
    chain = ART_PREFIX * layers * floor_per_load_ms
    path_ms = rows["art"]["kernel_ms"]
    art_line = dict(
        name="art_insert", route="cuda", tpu_kernel=False,
        source="src/repro_torch/kernels/csrc/art.cu",
        replaces="src/repro/baselines/art.py:136 (_art_insert, a lax.scan; "
                 "no TPU kernel)",
        launches=launches["art_insert"], match=True, max_abs_err=err,
        ms=ms, kernel_ms=ms, device_ms=prof["device_ms"],
        profiler_events_kept=prof["profiler_events_kept"],
        torch_kernels_ms=prof["torch_kernels_ms"], first_call_ms=k_ms,
        plain_ms=plain_ms, plain_device="cpu",
        plain_on_card_ms_per_key=plain_card_ms / ART_PLAIN_ON_CARD,
        bound_ms=bound, bound_by="bytes", bytes=moved,
        chain_ms=chain,
        chain_is="keys x 4 layers x the sort_lookup latency floor per "
                 "dependent load (upper layers hit in cache: not a floor)",
        library_ms=None, shape=[ART_PREFIX, layers],
        compared_in_tree_n_max=n, timed_in_tree_n_max=ART_PREFIX + 8,
        ms_per_key=ms / ART_PREFIX,
        device_ms_per_key=prof["device_ms"] / ART_PREFIX, path_keys=n,
        path_ms=path_ms, path_ms_per_key=path_ms / n,
        path_bound_ms=rows["art"]["touched_bytes"] / HBM_BYTES_PER_S * 1e3,
        path_chain_ms=n * layers * floor_per_load_ms,
        ms_is="ms: CUDA events around one launch on a fresh tree (median "
              "of 6); device_ms: the kernel's profiler events, "
              f"{ART_TIMING_REPS} calls on fresh trees; plain_ms: the "
              "plain per-key loop on the CPU, same inputs, in a tree of "
              "the main path's capacities")
    say("art_insert_kernel", card=card, **art_line)

    # ---- card against CPU at 2^16 IDs: the winner rule on CUDA ----
    sub = ids[:STATE_CHECK_KEYS]
    rep = np.concatenate([sub, rng.choice(sub[:1024], 8192)])
    perm = rng.permutation(len(rep))
    rep, roff = rep[perm], np.arange(len(rep), dtype=np.int32)[perm]
    pair = [HashIndex(n_max=STATE_CHECK_KEYS, device=d)
            for d in (dev, "cpu")]
    for h in pair:
        h.insert(rep, roff)
    for f in ("khi", "klo", "val", "used", "overflow"):
        if not torch.equal(getattr(pair[0].state, f).cpu(),
                           getattr(pair[1].state, f)):
            raise AssertionError(f"HashIndex on the card: {f} differs")
    arts = [TorchART(n_max=STATE_CHECK_KEYS + 8, device=d)
            for d in (dev, "cpu")]
    for a in arts:
        a.insert(sub, np.arange(len(sub), dtype=np.int32))
    art_states_equal(arts[0].state, arts[1].state, "TorchART card vs CPU")
    del pair, arts
    say("baselines_state_checks", card=card, keys=STATE_CHECK_KEYS,
        hash_batch=len(rep), repeated=8192, equal="every state tensor")

    # ---- paper Table 5 on the port, at scale 1 ----
    t0 = time.perf_counter()
    table = t5.run(scale=1.0, device=dev, seed=args.seed)
    say("table5", card=card, header=list(table[0]),
        rows=[list(r) for r in table[1:]], lj_n=n,
        lj_rows={k: rows[k] for k in ("sort", "art", "hash")},
        seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return art_line


def phase_analytics(args, torch):
    """The analytics path at the LiveJournal-sized state: scratch runs of
    every registered analytics, incremental advances, and the query
    service. Returns the largest BFS level's frontier-kernel inputs and
    the launch counts of the path's own calls: the direct device timings
    and the scratch runs made only to check an answer run through
    ``uncounted``, and their launches are taken out."""
    from repro_torch.analytics import algorithms as alg
    from repro_torch.api import (AnalyticsOp, OpBatch, ReadOp,
                                 analytics_spec, make_store)
    from repro_torch.core.status import Reason
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.frontier import pack_bits
    from repro_torch.serve import GraphQueryService

    uncounted, excluded = launch_excluder()

    E = args.analytics_edges
    B = 4096                # RadixGraph's default batch
    # the CSR pad must hold every directed edge the phase writes (ingest,
    # delta, service): a snapshot past m_cap drops edges, and the deltas
    # of later epochs would then look like deletes
    m_cap = next_pow2(2 * (E + DELTA_EDGES + SERVICE_STEPS * B))
    rng = np.random.default_rng(args.seed + 1)
    ids, si, di = powerlaw_stream(rng, LJ_VERTICES, E)
    w = rng.uniform(0.5, 2.0, E).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    syncs0 = dict(alg.HOST_SYNCS)
    card = card_line()

    t0 = time.perf_counter()
    store = make_store("local", device="cuda", n_max=LJ_N_MAX,
                       expected_n=LJ_VERTICES, key_bits=32,
                       pool_blocks=LJ_POOL_BLOCKS, block_size=16,
                       undirected=True, m_cap=m_cap)
    g = store.graph
    assert g.batch == B
    for lo in range(0, E, B):
        res = store.apply(OpBatch.edges(ids[si[lo:lo + B]],
                                        ids[di[lo:lo + B]], w[lo:lo + B]))
        if res.dropped:
            raise AssertionError(f"analytics ingest: {res.dropped} dropped")
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    snap = uncounted(lambda: store.read(ReadOp("snapshot")))
    m = int(snap.m)
    if not m < m_cap:
        raise AssertionError(f"snapshot truncated: m {m}, m_cap {m_cap}")

    # ---- host oracle inputs: both directions in op order, last writer
    # wins per directed pair ----
    s2 = np.empty(2 * E, np.int64)
    d2 = np.empty(2 * E, np.int64)
    s2[0::2], s2[1::2] = si, di
    d2[0::2], d2[1::2] = di, si
    osrc, odst, ow = oracle(LJ_VERTICES, s2, d2, np.repeat(w, 2))
    if len(osrc) != m:
        raise AssertionError(f"live edges: store {m}, oracle {len(osrc)}")
    present = np.unique(np.concatenate([si, di]))
    rows = g.lookup(ids[present]).astype(np.int64)
    if (rows < 0).any():
        raise AssertionError("a vertex of the stream is missing")
    hub = int(np.argmax(np.bincount(osrc, minlength=LJ_VERTICES)))
    src_id = int(ids[hub])
    khop_src = rng.choice(present, 64, replace=False)
    bc_src = rng.choice(present, 4, replace=False)
    say("analytics_store", card=card, edges=E, live_edges=m, m_cap=m_cap,
        vertices=int(len(present)), ingest_s=t_ingest,
        ingest_updates_per_s=2 * E / t_ingest, hub_degree=int(
            np.bincount(osrc)[hub]))

    # ---- scratch: every registry entry once through the store (the
    # path); then the same function on the snapshot, timed on the device
    # alone (uncounted); the difference is host time ----
    ops_list = [("bfs", "bfs", dict(source=src_id)),
                ("sssp", "sssp", dict(source=src_id, max_iters=SSSP_ITERS)),
                ("pagerank", "pagerank", dict(iters=20)),
                ("pagerank_tol", "pagerank", dict(iters=20, tol=PR_TOL)),
                ("wcc", "wcc", {}),
                ("khop", "khop", dict(sources=ids[khop_src], k=2)),
                ("bc", "bc", dict(sources=ids[bc_src])),
                ("triangle_count", "triangle_count", {}),
                ("degree_map", "degree_map", {}),
                ("num_edges", "num_edges", {})]
    results, timing, device_out = {}, [], {}
    for key, name, params in ops_list:
        spec = analytics_spec(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[key] = store.analytics_result(AnalyticsOp(name, params))
        torch.cuda.synchronize()
        store_ms = (time.perf_counter() - t0) * 1e3
        p = dict(params)
        dyn, _, _ = uncounted(lambda: store._resolve_dyn(spec, g.state, p))
        dargs = [a[0] if isinstance(a, tuple) else a for a in dyn]
        s0 = dict(alg.HOST_SYNCS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        device_out[key] = uncounted(lambda: spec.single(snap, *dargs, **p))
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t0) * 1e3
        timing.append(dict(op=key, device_ms=dev_ms, store_ms=store_ms,
                           host_ms=store_ms - dev_ms,
                           iters=results[key].iters,
                           host_syncs=sum(alg.HOST_SYNCS[k] - s0[k]
                                          for k in s0)))
    bfs_depth = device_out["bfs"]
    levels = int(bfs_depth.max())
    bfs_syncs = timing[0]["host_syncs"]
    say("analytics_scratch", card=card, ops=timing,
        bfs_levels=levels, bfs_host_syncs=bfs_syncs,
        bfs_host_syncs_per_level=bfs_syncs / (levels + 1),
        triangles=results["triangle_count"].value,
        num_edges=results["num_edges"].value)

    say("pagerank_float32", card=card, tol=PR_TOL,
        **pagerank_float32_probe(snap, torch))

    checks = host_oracle_checks(LJ_VERTICES, ids, present, rows, osrc, odst,
                                ow, hub, khop_src, results, bfs_iters=32)
    say("analytics_oracle", card=card, oracle="agrees", **checks)

    # ---- the largest BFS level, as the frontier kernel saw it ----
    lv = int(np.argmax(np.bincount(bfs_depth[bfs_depth >= 0].cpu()
                                   .numpy())))
    n = snap.indptr.shape[0] - 1
    W = (n + 31) // 32
    view = alg._frontier_view(snap, alg.csr_edges(snap))
    level = view + (pack_bits(bfs_depth == lv, W),
                    pack_bits((bfs_depth >= 0) & (bfs_depth <= lv), W),
                    lv, int((bfs_depth == lv).sum()))
    del device_out, bfs_depth

    # ---- incremental advances over an insert-only delta; each is held
    # to a scratch run at E1 (uncounted) ----
    inc_ops = [("bfs", "bfs", dict(source=src_id)),
               ("sssp", "sssp", dict(source=src_id, max_iters=SSSP_ITERS)),
               ("wcc", "wcc", {}),
               ("pagerank", "pagerank", dict(tol=PR_ADVANCE_TOL)),
               ("pagerank_tol", "pagerank", dict(tol=PR_TOL))]
    e0 = store.capture()
    warm = {key: store.analytics_result(AnalyticsOp(name, params), e0)
            for key, name, params in inc_ops}
    _, dsi, ddi = powerlaw_stream(rng, LJ_VERTICES, DELTA_EDGES, ids)
    # lighter than every base weight: an update never raises a weight
    dw = rng.uniform(0.1, 0.5, DELTA_EDGES).astype(np.float32)
    store.apply(OpBatch.edges(ids[dsi], ids[ddi], dw))
    e1 = store.capture()
    t0 = time.perf_counter()
    delta, reason = store._delta(e0, e1)
    delta_ms = (time.perf_counter() - t0) * 1e3
    if delta is None:
        raise AssertionError(f"delta refused: {reason}")
    adv = []
    for key, name, params in inc_ops:
        op = AnalyticsOp(name, params)
        t0 = time.perf_counter()
        ri = store.analytics_advance(op, warm[key], e1)
        torch.cuda.synchronize()
        adv_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rs = uncounted(lambda: store.analytics_result(op, e1))
        torch.cuda.synchronize()
        scr_ms = (time.perf_counter() - t0) * 1e3
        row = dict(op=key, tol=params.get("tol"), mode=ri.mode,
                   reason=str(ri.reason), advance_ms=adv_ms,
                   scratch_ms=scr_ms, advance_iters=ri.iters,
                   scratch_iters=rs.iters)
        if key == "pagerank_tol" and ri.mode == "scratch":
            # the push ran out of its budget: the reference answers with
            # a scratch run, reason advance-refused
            if ri.reason != Reason.ADVANCE_REFUSED:
                raise AssertionError(f"{key} fell back: {ri.reason}")
        elif ri.mode != "incremental":
            raise AssertionError(f"{key} advance fell back: {ri.reason}")
        elif name == "pagerank":
            row.update(check_pagerank_advance(store._csr(e1), ri, rs,
                                              params["tol"]))
        elif not np.array_equal(ri.raw, rs.raw):
            raise AssertionError(f"{key} advance differs from scratch")
        if name == "pagerank":
            # the push starts from the warm ranks; its target is an L1
            # residual of (1 - d) tol / 2
            row.update(warm_residual_l1=pagerank_residual_l1(
                store._csr(e0), warm[key].raw), push_target_l1=(
                1 - DAMPING) * params["tol"] / 2)
        adv.append(row)
    say("analytics_advance", card=card, delta_edges=DELTA_EDGES,
        delta_changed=delta.n_changed, touched_rows=int(
            delta.touched_rows.size), extract_ms=delta_ms,
        push_budget_edges=32 * (store._csr(e1).m + 1024), ops=adv)
    del warm, e0, e1

    # ---- the query service: writes stream in, reads on sealed epochs ----
    # a step's read budget holds one 4096-ID degree read and one cold
    # analytics run; a second analytics run waits for the next step
    svc = GraphQueryService(store, incremental=True, query_batch=2 * 4096)
    reasons = {}
    advance = store.analytics_advance

    def tally(op, prev, at):        # why each service answer took its path
        r = advance(op, prev, at)
        k = f"{op.name}:{r.mode}:{r.reason}"
        reasons[k] = reasons.get(k, 0) + 1
        return r
    store.analytics_advance = tally
    _, vsi, vdi = powerlaw_stream(rng, LJ_VERTICES, SERVICE_STEPS * B, ids)
    vw = rng.uniform(0.5, 2.0, SERVICE_STEPS * B).astype(np.float32)
    qids = ids[rng.choice(present, 4096, replace=False)]
    lat = []
    t_start = time.perf_counter()
    for step_ in range(SERVICE_STEPS):
        sl = slice(step_ * B, (step_ + 1) * B)
        if not svc.submit_update(ids[vsi[sl]], ids[vdi[sl]], vw[sl]):
            raise AssertionError("service refused a write (backpressure)")
        svc.submit_query("degree", ids=qids)
        if step_ % 8 == 7:
            svc.submit_query("bfs", source=src_id)
            svc.submit_query("wcc")
        t0 = time.perf_counter()
        svc.step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    if svc.pending_writes:
        raise AssertionError("service left writes queued")
    sealed = svc._sealed
    tb = svc.submit_query("bfs", source=src_id)
    tw = svc.submit_query("wcc")
    td = svc.submit_query("degree", ids=qids)
    svc.run()               # no writes left: every read sees ``sealed``
    stats = svc.stats
    for t, name, params in ((tb, "bfs", dict(source=src_id, max_iters=32)),
                            (tw, "wcc", {})):
        want = uncounted(lambda: store.analytics_result(
            AnalyticsOp(name, params), sealed))
        if svc.results[t] != want.value:
            raise AssertionError(f"service {name} differs from scratch at "
                                 "its last sealed epoch")
    if not np.array_equal(svc.results[td], uncounted(lambda: store.read(
            ReadOp("degree", ids=qids), at=sealed))):
        raise AssertionError("service degrees differ at the sealed epoch")
    m_end = int(uncounted(lambda: store.read(ReadOp("snapshot"),
                                             at=sealed)).m)
    if not m_end < m_cap:
        raise AssertionError(f"snapshot truncated: m {m_end}, m_cap {m_cap}")
    if not stats["analytics_incremental"]:
        raise AssertionError(f"no service answer advanced: {reasons}")
    torch.cuda.synchronize()
    launches = {k: v - excluded[k] for k, v in kops.launch_counts().items()}
    for k in ANALYTICS_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "analytics path")
    say("analytics_service", card=card, steps=SERVICE_STEPS,
        write_ops=SERVICE_STEPS * B, ops_per_s=SERVICE_STEPS * B / wall,
        step_p50_ms=float(np.percentile(lat, 50)),
        step_p99_ms=float(np.percentile(lat, 99)),
        analytics_incremental=stats["analytics_incremental"],
        analytics_scratch=stats["analytics_scratch"],
        epochs_sealed=stats["epochs_sealed"],
        retained_epochs=stats["retained_epochs"], defrags=stats["defrags"],
        live_edges=m_end, paths=reasons,
        answers="equal scratch at the last sealed epoch")
    say("analytics_path", card=card, launches=launches,
        uncounted_launches=excluded,
        host_syncs={k: alg.HOST_SYNCS[k] - syncs0[k] for k in syncs0},
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    return level, launches


def phase_frontier_kernel(level, launches, torch, parent):
    """The frontier kernel against its plain version on the largest BFS
    level of the analytics phase, at its (m_cap, 1) CSR view."""
    from repro_torch.kernels import frontier as kf
    owner, dst, valid, fb, vb, lv, size = level
    NB, BS = dst.shape
    W = fb.shape[0]
    args_ = (owner, dst, valid, fb, vb)
    nbytes = NB * 4 + NB * BS * 5 + 3 * W * 4
    row = kernel_entry(torch, "frontier_expand", [NB, BS, W],
                       wrappers(parent, "frontier", "frontier_expand",
                                *args_),
                       lambda: kf.frontier_expand_plain(*args_),
                       lambda: ([kf.frontier_expand(*args_)],
                                [kf.frontier_expand_plain(*args_)]),
                       nbytes, NB * BS)
    say("frontier_kernel", card=card_line(), bfs_level=lv,
        frontier_vertices=size, launches=launches["frontier_expand"],
        **row)
    return kernel_line("frontier_expand", row, launches["frontier_expand"])


def phase_parity(torch):
    """The same small stream through every kernel and through every plain
    version: identical state, leaf for leaf."""
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(5)
    ids, si, di = powerlaw_stream(rng, 3000, 60_000)
    w = rng.uniform(0.5, 2.0, len(si)).astype(np.float32)
    w[rng.random(len(si)) < 0.25] = 0.0
    si[20_000:24_000] = np.arange(4000) % 40   # 40 medium hubs at once
    base = dict(n_max=8192, expected_n=3000, key_bits=32, pool_blocks=16384,
                block_size=16, batch=1024, dmax=512, k_max=32, k_big=4,
                probe_width=64, device="cuda")
    from repro_torch.analytics import bfs, khop
    states, counts, reads, walks = [], [], [], []
    for impl in ({}, dict(append_impl="plain", compact_impl="ref",
                          lookup_impl="ref")):
        kops.reset_launch_counts()
        s = make_store("local", **base, **impl)
        for lo in range(0, len(si), 10_000):
            s.apply(OpBatch.edges(ids[si[lo:lo + 10_000]],
                                  ids[di[lo:lo + 10_000]],
                                  w[lo:lo + 10_000]))
        s.graph.defrag()
        s.apply(OpBatch.edges(ids[si[:3000]], ids[di[:3000]], w[:3000]))
        torch.cuda.synchronize()
        snap = s.read(ReadOp("snapshot"))
        srcs = torch.from_numpy(s.graph.lookup(ids[:16])).to(s.graph.device)
        walk = "ref" if impl else "auto"
        walks.append((bfs(snap, int(srcs[0]), impl=walk),
                      khop(snap, srcs, k=2, impl=walk)))
        torch.cuda.synchronize()
        states.append(s.graph.state)
        counts.append(kops.launch_counts())
        reads.append(s.read(ReadOp("neighbors", ids=ids[:500])))
    la, lb = leaves(states[0]), leaves(states[1])
    if len(la) != len(lb):
        raise AssertionError("state structures differ")
    for a, b in zip(la, lb):
        if not torch.equal(a, b):
            raise AssertionError("kernel path and plain path states differ")
    for (ia, wa), (ib, wb) in zip(*reads):
        if not (np.array_equal(ia, ib) and np.array_equal(wa, wb)):
            raise AssertionError("kernel path and plain path reads differ")
    for a, b in zip(*walks):
        if not torch.equal(a, b):
            raise AssertionError("bfs / khop through the frontier kernel "
                                 "and its plain version differ")
    if min(counts[0][k] for k in TPU_KERNELS) <= 0 or \
            max(counts[1].values()) != 0:
        raise AssertionError(f"launch counts {counts}")
    sharded_parity(torch)
    say("parity", identical=True, leaves=len(la),
        bfs_reached=int((walks[0][0] >= 0).sum()),
        khop_counts=walks[0][1].tolist(),
        defrags=int(states[0].pool.defrags), kernel_launches=counts[0],
        plain_launches=counts[1])


# the LM serving phase (``repro_torch.serve``): internlm2-1.8b at its
# published width (the repo's own serving example, examples/serve_lm.py,
# serves it), random weights from the seed. The bf16 run: 8 slots of 1024
# tokens, prompts of 16-512 tokens, 32 new tokens each, RadixKV blocks of
# 16 tokens; the pool holds (slots + 1) 2x extents of the longest request,
# enough that no admission ever overflows (a live extent is at most 2x its
# tokens: 8 of them, and one new extent) and small enough that 32 requests
# recycle finished ones at a defrag. The float32 gate: the same CONFIG and
# seed in float32 (TF32 off), 8 requests of 16 new tokens on 4 slots,
# held to the train-mode forward teacher-forced; a prefill and 8 decode
# steps on a batch of 4 held to it at the JAX suite's tolerance, at the
# init's weight scale (``gate_fan_in`` False: float32 holds this 24-layer
# model's answer there). ``requests`` is ``--lm-requests``'s default. The
# time guard (``family_requests``): the set-up, gate and profile
# (``fixed_s``; 7.5-11 s in H100 runs) and each bf16 request's prefill,
# decode share and teacher-forced check (``per_request_s``; 0.3-0.4 s on
# an H100 whose main path ran 133,000-190,000 updates/s, 0.6 s on one that
# ran 116,000); ``floor``, the fewest requests that fill the slots.
LM_SERVE = dict(arch="internlm2-1.8b", slots=8, smax=1024, prompt=(16, 512),
                new=32, block_tokens=16, requests=32, floor=8,
                gate_requests=8, gate_new=16, gate_slots=4, gate_batch=4,
                gate_steps=8, gate_fan_in=False, fixed_s=15.0,
                per_request_s=0.6)
LM_TIE_GAP = 4e-3          # a served f32 token must be the oracle's argmax
LM_GATE_TOL = dict(rtol=2e-2, atol=2e-3)   # where its top-2 gap exceeds it
LM_PROFILE_STEPS = 8
LM_DEFRAG_REQUESTS = 32    # from this many bf16 requests a defrag must run


def free_card(torch):
    """Collect the reference cycles an ``lm_engine`` makes (its wrapped
    methods close over it, so a deleted engine keeps its params alive
    until a full collection) and return the freed blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def lm_leaves(params):
    """The tensors of a (nested) LM param dict."""
    return [t for _, t in lm_named_leaves(params)]


def lm_kv_blocks(cfg) -> int:
    longest = cfg["prompt"][1] + cfg["new"]
    return (cfg["slots"] + 1) * 2 * -(-longest // cfg["block_tokens"])


def lm_prompts(rng, n, vocab, spec=LM_SERVE):
    lo, hi = spec["prompt"]
    return [rng.integers(0, vocab, int(s)).astype(np.int32)
            for s in rng.integers(lo, hi + 1, n)]


def lm_teacher(torch, cfg, params, prompt, out):
    """The train-mode forward over ``prompt`` + ``out`` teacher-forced: per
    served token, the oracle's argmax, its top-2 gap, and whether the
    served token is that argmax."""
    from repro_torch.models import lm
    dev = params["embed"].device
    toks = torch.as_tensor(np.concatenate([prompt, out[:-1]]),
                           dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        h, _, _ = lm.forward(cfg, params, toks, lm.make_positions(cfg, toks),
                             "train")
        logits = lm._unembed(cfg, params, h[:, len(prompt) - 1:])[0]
        top = torch.topk(logits, 2, dim=-1).values
        gap = top[:, 0] - top[:, 1]
        agree = torch.argmax(logits, dim=-1) == torch.as_tensor(
            out, device=dev)
    return agree.cpu().numpy(), gap.cpu().numpy()


def lm_agreement(torch, cfg, params, prompts, results, starts=None):
    """Served tokens against the teacher-forced oracle: the tokens, those
    equal to its argmax, its near ties (top-2 gap <= ``LM_TIE_GAP``) and
    the served tokens that differ where the gap is wider. With ``starts``
    (prompt index -> the slot's cache rows when its prefill began) the
    oracle starts from those rows (``lm_teacher_from``)."""
    agree, gap = zip(*(
        lm_teacher(torch, cfg, params, prompts[i], results[i])
        if starts is None else
        lm_teacher_from(torch, cfg, params, prompts[i], results[i],
                        starts[i]) for i in sorted(results)))
    agree, gap = np.concatenate(agree), np.concatenate(gap)
    tie = gap <= LM_TIE_GAP
    return dict(tokens=int(len(agree)), equal_argmax=int(agree.sum()),
                near_ties=int(tie.sum()),
                decisive_mismatches=int((~agree & ~tie).sum()),
                least_gap_of_a_mismatch=float(gap[~agree].min())
                if (~agree).any() else None)


def lm_engine(torch, model, params, slots, blocks, spec=LM_SERVE):
    """A ``ServeEngine`` whose prefills and decode steps are timed
    (synchronised), whose RadixKV utilisation is kept after each step, and
    whose logits are checked finite on the device."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, params, slots=slots, smax=spec["smax"],
                      kv_blocks=blocks, block_tokens=spec["block_tokens"])
    eng.prefill_ms, eng.step_ms, eng.kv_util = [], [], []
    eng.nonfinite = torch.zeros((), dtype=torch.int64, device=eng.device)

    def timed(fn, into):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            eng.kv_util.append(eng.kv.utilization)
            return out
        return call

    def finite(fn):
        def call(p, batch, cache):
            logits, cache = fn(p, batch, cache)
            eng.nonfinite += (~torch.isfinite(logits)).sum()
            return logits, cache
        return call
    eng._prefill_into_slot = timed(eng._prefill_into_slot, eng.prefill_ms)
    eng.step = timed(eng.step, eng.step_ms)
    eng._prefill = finite(eng._prefill)
    eng._decode = finite(eng._decode)
    return eng


def lm_decode_profile(torch, eng, prompts, cfg, pbytes, spec=LM_SERVE):
    """``LM_PROFILE_STEPS`` decode steps with every slot busy, under
    ``torch.profiler`` (device activity only: host op events would cost
    seconds to collect): launches a step (the runtime's launch calls, and
    the kernel events kept), the device's busy share, and the step's
    bandwidth bound (every weight but the embedding table read once, the
    slots' embedding rows, and each slot's valid K/V) beside the bytes the
    plain attention reads (each slot's whole cache). For a recurrent
    family (``ssm``, ``hybrid``) the bound also counts its state read and
    written once a step (``lm_recurrent_bytes``), and K/V rows are those of
    its attention layers, at most its window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.slots]:
        eng.submit(p, max_new=LM_PROFILE_STEPS + 4)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    attn_layers, kv_len = lm_attention_layers(cfg, spec["smax"])
    kv_row = attn_layers * cfg.kv_heads * cfg.hd * 2 * cfg.cdt.itemsize
    # step j reads pos + j + 1 entries of each slot: the mean over steps
    valid = sum(min(r.pos + (LM_PROFILE_STEPS + 1) / 2, kv_len)
                for r in eng.active.values())
    state_bytes = lm_recurrent_bytes(eng)
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_events = time.perf_counter()
    launch_calls = kernels = busy_us = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            kernels += not e.name.startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in e.name:
            launch_calls += 1
    embed = eng.params["embed"]
    weight_bytes = pbytes - embed.numel() * embed.element_size() + \
        eng.slots * embed.shape[1] * embed.element_size()
    kv_bytes = valid * kv_row
    bound_ms = (weight_bytes + kv_bytes + 2 * state_bytes) / \
        HBM_BYTES_PER_S * 1e3
    step_ms = wall * 1e3 / LM_PROFILE_STEPS
    return dict(steps=LM_PROFILE_STEPS, step_ms=step_ms,
                launch_calls_per_step=launch_calls / LM_PROFILE_STEPS,
                kernel_events_per_step=kernels / LM_PROFILE_STEPS,
                device_busy_share=busy_us / (wall * 1e6),
                weight_bytes=weight_bytes, kv_valid_bytes=kv_bytes,
                recurrent_state_bytes_read_and_written=2 * state_bytes,
                kv_bytes_read_by_plain_attention=eng.slots * kv_len * kv_row,
                bound_ms=bound_ms, bound_by="bytes",
                bound_share=bound_ms / step_ms,
                trace_s=t_events - t_trace,
                events_s=time.perf_counter() - t_events)


def lm_batch_gate(torch, model, params, prompts, spec=LM_SERVE):
    """``model.prefill`` and ``gate_steps`` greedy ``model.decode`` steps on
    a batch of ``gate_batch`` prompts (each cut to the shortest), against
    the train-mode forward over the same tokens: the largest error beside
    ``LM_GATE_TOL``."""
    from repro_torch.models import lm
    cfg, dev = model.cfg, params["embed"].device
    B, n = spec["gate_batch"], spec["gate_steps"]
    S = min(len(p) for p in prompts[:B])
    toks = torch.as_tensor(np.stack([p[:S] for p in prompts[:B]]),
                           dtype=torch.int32, device=dev)
    cache = model.init_cache(B, S + n, device=dev)
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    served, fed = [logits], []
    for j in range(n):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        fed.append(nxt)
        logits, cache = model.decode(params, {"token": nxt, "pos": torch.full(
            (B,), S + j, dtype=torch.int32, device=dev)}, cache)
        served.append(logits)
    allt = torch.cat([toks, torch.stack(fed, 1)], 1)
    with torch.inference_mode():
        h, _, _ = lm.forward(cfg, params, allt, lm.make_positions(cfg, allt),
                             "train")
        ref = lm._unembed(cfg, params, h[:, S - 1:]).cpu().numpy()
    got = torch.stack(served, 1).cpu().numpy()
    err = np.abs(got - ref)
    ok = err <= LM_GATE_TOL["atol"] + LM_GATE_TOL["rtol"] * np.abs(ref)
    return dict(batch=B, prompt_tokens=S, decode_steps=n,
                max_abs_err=float(err.max()),
                max_rel_err=float((err / np.maximum(np.abs(ref), 1e-30))
                                  [~ok].max()) if (~ok).any() else 0.0,
                outside_tol=int((~ok).sum()), **LM_GATE_TOL)


# the LM families' phases (after ``lm_serve``): each model at its published
# width, random weights from the seed, bf16 served through ``ServeEngine``
# (encdec through ``model.prefill`` / ``model.decode``: the engine, as the
# JAX one, serves no encoder-decoder). Each spec's ``fixed_s`` (set-up,
# gate, profile) and ``per_request_s`` project the phase's seconds for the
# time guards (``family_requests``), about 1.4x the phases alone on an
# H100 (26.5, 39.7, 16.0 and 10.0 s at these request counts); ``floor``
# is the fewest requests that still serve the family (one a slot). The
# recurrent families' float32 gates run at 1/sqrt(fan-in) weights
# (``gate_fan_in``, ``lm_fan_in_scale``).
LM_SSM = dict(arch="mamba2-1.3b", slots=8, smax=1024, prompt=(16, 512),
              new=32, block_tokens=16, requests=16, floor=8,
              gate_requests=8, gate_new=16, gate_slots=4, gate_batch=4,
              gate_steps=8, gate_fan_in=True, fixed_s=25.0,
              per_request_s=0.75)
LM_HYBRID = dict(arch="recurrentgemma-9b", slots=8, smax=4096,
                 prompt=(16, 3072), new=32, block_tokens=16, requests=16,
                 floor=8, gate_requests=4, gate_new=16, gate_slots=4,
                 gate_batch=4, gate_steps=8, gate_fan_in=True, fixed_s=30.0,
                 per_request_s=1.5)
# kimi-k2 at its published width, its 61 layers cut to 1: 19,378,623,488
# params (38.76 GB in bf16); two layers and the embeddings would be 72.8 GB
LM_MOE = dict(arch="kimi-k2-1t-a32b", layers=1, slots=8, smax=1024,
              prompt=(16, 512), new=32, block_tokens=16, requests=16,
              floor=8, fixed_s=15.0, per_request_s=0.5)
# whisper-small: 1,500 stub frame embeddings a request (the encoder length
# of a 30-second window), decoder prompts of 4-64 tokens, 64 decode steps
LM_ENCDEC = dict(arch="whisper-small", frames=1500, prompt=(4, 64), new=64,
                 smax=128, requests=8, floor=2, gate_requests=4,
                 fixed_s=10.0, per_request_s=1.0)
# internlm2-1.8b at its published width, bf16 params and grads, float32
# AdamW moments, remat on; seq 4,096 (the repo's ``train_4k`` length), a
# global batch of 4 as 2 accumulated micro-batches of 2 (16,384 tokens a
# step). ``requests`` / ``floor`` are timed steps here; ``fixed_s`` covers
# the launcher's steps, the warm and profiled steps, the gates and the
# SMOKE loops; ``per_request_s`` a timed step: about 1.4x an H100's
# (6.2-6.9 s a step; the phase's other parts 45-53 s).
LM_TRAIN = dict(arch="internlm2-1.8b", seq=4096, batch=4, accum=2,
                launch_steps=2, requests=4, floor=3, gate_layers=2,
                gate_batch=2, gate_seq=1024, graph_steps=3, fixed_s=75.0,
                per_request_s=9.0, device="cuda")
# the LM dry-run cells (``LM_DRYRUNS``), six processes side by side after
# the last timed phase: ``fixed_s`` their projected seconds (the phase
# took 86.5-112.1 s on the card's hosts, the longest trace 61.9-66.9 s)
LM_DRYRUN = dict(arch="dryrun", requests=0, floor=0, fixed_s=115.0,
                 per_request_s=0.0)
LM_PHASES = (LM_SERVE, LM_SSM, LM_HYBRID, LM_MOE, LM_ENCDEC, LM_TRAIN,
             LM_DRYRUN)
MOE_GATE_TOL = dict(rtol=2e-2, atol=2e-3)   # atol on the output's scale
# the served (bf16) MoE layer against the float32 loop: the repo's bf16
# tolerance (``BF16_TOL`` of tests/test_torch_models.py). Its roundings
# (bf16 expert products, gates and an 8-way bf16 combine, as the JAX
# package's) put a few outputs past MOE_GATE_TOL (``served_outside_tol``:
# 35 of 3,504 x 7,168 in a first prefill on an H100), while the layer in
# float32 holds MOE_GATE_TOL
MOE_BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def family_floor_s(specs) -> float:
    """The projected seconds of ``specs``' phases at their floors."""
    return sum(s["fixed_s"] + s["floor"] * s["per_request_s"] for s in specs)


def family_requests(spec, elapsed_s: float) -> int:
    """The phase's requests (at most ``spec["requests"]``) that keep the
    projected script time inside ``TIME_LIMIT_S`` less ``TIME_MARGIN_S``
    with the later ``LM_PHASES`` at their floors: a multiple of its floor,
    at least the floor."""
    archs = [s["arch"] for s in LM_PHASES]
    later = LM_PHASES[archs.index(spec["arch"]) + 1:]
    room = TIME_LIMIT_S - TIME_MARGIN_S - elapsed_s - spec["fixed_s"] - \
        family_floor_s(later)
    f = spec["floor"]
    n = int(min(spec["requests"], max(f, room / spec["per_request_s"] //
                                      f * f)))
    if n < spec["requests"]:
        say("reduced", arch=spec["arch"], requests=n,
            asked=spec["requests"], elapsed_s=elapsed_s)
    return n


def lm_attention_layers(cfg, smax):
    """(attention layers holding K/V, the entries a slot can hold)."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        unit = len(cfg.pattern)
        att = (cfg.layers // unit) * sum(1 for t in cfg.pattern
                                         if t == "attn")
        return att, min(smax, cfg.window or smax)
    return cfg.layers, smax if cfg.window is None else min(smax, cfg.window)


def lm_recurrent_bytes(eng) -> int:
    """The bytes of every slot's recurrent state (SSM states, RG-LRU
    states, conv tails): what a decode step reads, and writes again."""
    from repro_torch.models.api import cache_leaves
    if eng.cfg.family not in ("ssm", "hybrid"):
        return 0
    leaves = cache_leaves(eng.cache)
    if eng.cfg.family == "hybrid":          # less the attention K/V
        g, tail = eng.cache
        leaves = cache_leaves(g[0]) + cache_leaves(tail)
    return sum(t.numel() * t.element_size() for t in leaves)


def lm_named_leaves(params, prefix=""):
    """(dotted name, tensor) for every leaf of a (nested) LM param dict."""
    out = []
    for k, v in params.items():
        out += lm_named_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) \
            else [(f"{prefix}{k}", v)]
    return out


def lm_check_params(torch, cfg, params, where):
    """Every leaf in ``cfg.pdt`` but the JAX init's float32 ones, and the
    count ``param_counts`` gives. Returns (count, bytes)."""
    from repro_torch.models import lm
    from repro_torch.models.api import param_counts
    named = lm_named_leaves(params)
    bad = [n for n, t in named if t.dtype != (
        torch.float32 if n.split(".")[-1] in lm.FLOAT32_LEAVES
        else cfg.pdt)]
    count = sum(t.numel() for _, t in named)
    if bad or count != param_counts(cfg)[0]:
        raise AssertionError(f"{where}: params differ from param_counts, "
                             f"or leaves not in their dtype: {bad[:4]}")
    return count, sum(t.numel() * t.element_size() for _, t in named)


def lm_fan_in_scale(params):
    """Every default-scale matrix of a dense, ssm, hybrid or encdec LM
    tree (one matrix a layer; the MoE experts' leaves, a stack of matrices
    a layer, are left: no gate here scales a moe tree) from the init's 1 /
    sqrt(rows drawn at once) (L for stacked layers, groups x per unit for
    the hybrid's) to 1 / sqrt(fan-in), its ``shape[-2]``: a trained
    model's scale, as ``tests/_lm_cases.py`` gives the CPU parity tests.
    At the init's own scale attention scores run to thousands and a deep
    model is chaotic: float32 cannot hold its answer (whisper-small's
    float32 encoder is 10% of its scale off a float64 one; ``encdec_f64``
    prints it), so a float32 gate would compare two chaotic paths. In
    place; conv weights, norms, the embedding and ``lm_head`` (already at
    1 / sqrt(d)) are left."""
    for tree_name, lead in (("layers", 1), ("enc_layers", 1),
                            ("dec_layers", 1), ("tail", 1), ("groups", 2)):
        stack = [params[tree_name]] if tree_name in params else []
        while stack:
            for k, v in stack.pop().items():
                if isinstance(v, dict):
                    stack.append(v)
                elif k != "conv_w" and v.dim() == lead + 2:
                    drawn = math.prod(v.shape[:lead])
                    v.mul_(math.sqrt(drawn / v.shape[-2]))


def lm_snapshot_starts(torch, eng, prompts):
    """Make ``eng`` keep, for each prompt it admits, a copy of its slot's
    cache rows as the prefill finds them (the JAX engine's prefill reads
    a recurrent family's conv tails there: a reused slot starts from what
    its last request left). Keyed by prompt index (``ServeEngine.submit``
    keeps an int32 prompt array as given)."""
    from repro_torch.models.api import cache_map
    index = {id(p): i for i, p in enumerate(prompts)}
    starts = {}
    inner = eng._prefill_into_slot

    def snap(req):
        starts[index[id(req.prompt)]] = cache_map(
            torch.clone, eng._rows(eng.cache, req.slot))
        return inner(req)
    eng._prefill_into_slot = snap
    return starts


def lm_teacher_from(torch, cfg, params, prompt, out, start):
    """``lm_teacher`` from the state a request's prefill started in: the
    prompt and the served tokens teacher-forced through one prefill-mode
    forward on a copy of ``start`` (the slot's rows then). From a zero
    state this is the train-mode forward's answer."""
    from repro_torch.models import lm
    from repro_torch.models.api import cache_map
    dev = params["embed"].device
    toks = torch.as_tensor(np.concatenate([prompt, out[:-1]]),
                           dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        h, _, _ = lm.forward(cfg, params, toks, lm.make_positions(cfg, toks),
                             "prefill", cache=cache_map(torch.clone, start))
        logits = lm._unembed(cfg, params, h[:, len(prompt) - 1:])[0]
        top = torch.topk(logits, 2, dim=-1).values
        gap = top[:, 0] - top[:, 1]
        agree = torch.argmax(logits, dim=-1) == torch.as_tensor(
            out, device=dev)
    return agree.cpu().numpy(), gap.cpu().numpy()


def lm_served_checks(eng, cfg, n, new, results, graph_launches):
    """The checks every LM phase fails on: a request that did not finish
    with its tokens, a token outside the vocabulary, a non-finite logit,
    a RadixKV overflow, a graph kernel launched."""
    toks = np.array([t for i in sorted(results) for t in results[i]])
    fails = []
    if sorted(results) != list(range(n)) or any(
            len(v) != new for v in results.values()):
        fails.append("a request did not finish with its tokens")
    if len(toks) and (toks.min() < 0 or toks.max() >= cfg.vocab):
        fails.append("a token outside the vocabulary")
    if int(eng.nonfinite):
        fails.append(f"{int(eng.nonfinite)} non-finite logits")
    if eng.kv.overflow:
        fails.append(f"RadixKV overflowed {eng.kv.overflow} times")
    if any(graph_launches.values()):
        fails.append(f"graph kernels launched: {graph_launches}")
    return toks, fails


def lm_timing(eng):
    pct = (lambda xs, q: float(np.percentile(xs, q)) if xs else None)
    # the first prefill (every slot's row: no request was active) and the
    # first step (cuBLAS's set-up) apart from the rest
    return dict(first_prefill_ms=eng.prefill_ms[0],
                first_step_ms=eng.step_ms[0],
                prefill_ms_p50=pct(eng.prefill_ms[1:], 50),
                prefill_ms_p99=pct(eng.prefill_ms[1:], 99),
                decode_steps=len(eng.step_ms),
                decode_step_ms_p50=pct(eng.step_ms[1:], 50),
                decode_step_ms_p99=pct(eng.step_ms[1:], 99))


def lm_served_run(args, torch, spec, cfg, elapsed_s, tag):
    """The bf16 run of a served family (``spec``): init from the seed,
    ``family_requests`` requests through an ``lm_engine`` with launch
    counters zeroed just before and read just after. Returns what the
    phase prints and checks."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.api import build_model
    n = family_requests(spec, elapsed_s)
    prompts = lm_prompts(np.random.default_rng(args.seed), n, cfg.vocab,
                         spec)
    blocks = lm_kv_blocks(spec)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    count, pbytes = lm_check_params(torch, cfg, params, tag)
    eng = lm_engine(torch, model, params, spec["slots"], blocks, spec)
    starts = lm_snapshot_starts(torch, eng, prompts) \
        if cfg.family in ("ssm", "hybrid") else None
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run(prompts, max_new=spec["new"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graph_launches = kops.launch_counts()
    toks, fails = lm_served_checks(eng, cfg, n, spec["new"], results,
                                   graph_launches)
    line = dict(card=card_line(), arch=cfg.arch, family=cfg.family,
                dtype=cfg.param_dtype, layers=cfg.layers,
                d_model=cfg.d_model, params=count, param_bytes=pbytes,
                init_s=init_s, requests=n, slots=spec["slots"],
                smax=spec["smax"], new_tokens=spec["new"],
                prompt_tokens=int(sum(len(p) for p in prompts)),
                served_tokens=int(len(toks)), seconds=wall,
                tokens_per_s=len(toks) / wall, **lm_timing(eng),
                radix_kv=dict(defrags=eng.kv.defrags,
                              overflow=eng.kv.overflow,
                              utilization_max=max(eng.kv_util),
                              utilization_mean=float(np.mean(eng.kv_util)),
                              kv_blocks=blocks),
                graph_kernel_launches=graph_launches,
                peak_memory_bytes=torch.cuda.max_memory_allocated())
    return dict(model=model, params=params, eng=eng, prompts=prompts,
                results=results, starts=starts, pbytes=pbytes, line=line,
                fails=fails)


def lm_float32_gate(args, torch, spec, cfg, prompts, tag):
    """The float32 gate at full width (TF32 off; with ``gate_fan_in`` the
    weights at a trained model's scale, ``lm_fan_in_scale``, else at the
    init's): ``gate_requests`` prompts of the bf16 run served on
    ``gate_slots`` slots, every served token equal to the teacher-forced
    argmax wherever its top-2 gap exceeds ``LM_TIE_GAP`` (for a recurrent
    family the teacher starts from each request's admission state, and the
    tokens that differ from the zero-state forward are printed beside),
    then ``lm_batch_gate``. Fails on any check."""
    from repro_torch.models.api import build_model
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    marks = [time.perf_counter()]
    try:
        cfg32 = cfg.scaled(param_dtype="float32", compute_dtype="float32")
        model = build_model(cfg32)
        params = model.init(torch.Generator("cuda").manual_seed(args.seed))
        if spec["gate_fan_in"]:
            lm_fan_in_scale(params)
        gp = prompts[:spec["gate_requests"]]
        eng = lm_engine(torch, model, params, spec["gate_slots"],
                        lm_kv_blocks(spec), spec)
        starts = lm_snapshot_starts(torch, eng, gp) \
            if cfg.family in ("ssm", "hybrid") else None
        marks.append(time.perf_counter())
        res = eng.run(gp, max_new=spec["gate_new"])
        marks.append(time.perf_counter())
        served = lm_agreement(torch, cfg32, params, gp, res, starts)
        zero = None if starts is None else \
            lm_agreement(torch, cfg32, params, gp, res)
        marks.append(time.perf_counter())
        batch = lm_batch_gate(torch, model, params, gp, spec)
        marks.append(time.perf_counter())
        peak32 = torch.cuda.max_memory_allocated()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    fails = []
    if sorted(res) != list(range(len(gp))) or int(eng.nonfinite):
        fails.append("a gate request did not finish, or non-finite logits")
    if served["decisive_mismatches"]:
        fails.append(f"{served['decisive_mismatches']} served tokens differ "
                     f"from the oracle where its top-2 gap > {LM_TIE_GAP}")
    if batch["outside_tol"]:
        fails.append(f"prefill/decode logits outside {LM_GATE_TOL}")
    say(f"{tag}_gate", card=card_line(), dtype="float32", tf32=False,
        weights="1/sqrt(fan-in)" if spec["gate_fan_in"] else "init",
        requests=len(gp), slots=spec["gate_slots"],
        new_tokens=spec["gate_new"],
        param_bytes=sum(t.numel() * 4 for t in lm_leaves(params)),
        served=served, tie_gap=LM_TIE_GAP,
        served_against_zero_state_forward=zero, batch=batch,
        decode_step_ms_p50=float(np.percentile(eng.step_ms, 50)),
        prefill_ms_p50=float(np.percentile(eng.prefill_ms, 50)),
        peak_memory_bytes=peak32,
        seconds_by_part=dict(zip(("init", "run", "teacher", "batch"),
                                 np.diff(marks).tolist())),
        failed=fails or None)
    if fails:
        raise AssertionError(f"{tag}_gate: {fails}")
    del eng, params, model
    free_card(torch)


def phase_lm_served(args, torch, spec, tag, elapsed_s=0.0):
    """``lm_serve`` (internlm2-1.8b), ``lm_ssm`` (mamba2-1.3b) or
    ``lm_hybrid`` (recurrentgemma-9b) at its published width: the bf16
    served run (``lm_served_run``; the served tokens against the
    teacher-forced argmax, from each request's admission state for a
    recurrent family, printed), 8 profiled decode steps (launches, busy
    share, the bytes bound: weights, the recurrent state read and written,
    the attention's valid K/V), then the float32 gate after the bf16 model
    is freed. Also fails without a RadixKV defrag from
    ``LM_DEFRAG_REQUESTS`` requests, and, for a model with a window
    (``lm_hybrid``'s 2,048), unless a prompt passed it (the ring prefill
    at full width)."""
    from repro_torch.configs import get_arch
    t_phase = time.perf_counter()
    cfg = get_arch(spec["arch"]).CONFIG
    run = lm_served_run(args, torch, spec, cfg, elapsed_s, tag)
    eng, fails, line = run["eng"], run["fails"], run["line"]
    if eng.kv.defrags < 1 and line["requests"] >= LM_DEFRAG_REQUESTS:
        fails.append(f"RadixKV {line['radix_kv']}: want a defrag")
    if cfg.window is not None:
        past = sum(len(p) > cfg.window for p in run["prompts"])
        line["prompts_past_window"] = past
        if not past:
            fails.append(f"no prompt passed the window of {cfg.window}")
    t0 = time.perf_counter()
    agree = lm_agreement(torch, cfg, run["params"], run["prompts"],
                         run["results"], run["starts"])
    teacher_s = time.perf_counter() - t0
    state = lm_recurrent_bytes(eng)
    t0 = time.perf_counter()
    profile = lm_decode_profile(torch, eng, run["prompts"], cfg,
                                run["pbytes"], spec)
    say(tag, **line, teacher_forced=agree,
        decode_state_bytes_per_slot=state / spec["slots"],
        decode_profile=profile,
        seconds_by_part=dict(run=line["seconds"], teacher=teacher_s,
                             profile=time.perf_counter() - t0),
        failed=fails or None)
    if fails:
        raise AssertionError(f"{tag}: {fails}")
    prompts = run["prompts"]
    del eng, run
    free_card(torch)
    lm_float32_gate(args, torch, spec, cfg, prompts, tag)
    say(f"{tag}_done", phase_seconds=time.perf_counter() - t_phase)


def moe_reference(torch, x, p, cfg):
    """The MoE layer in float32, expert by expert, on the card, from the
    bf16 weights of layer 0 (``p``) and a routing of its own on the host
    (numpy: the k largest router logits, a tie to the lower expert; each
    expert's pairs ranked in token order, those past the capacity
    dropped). Returns (y float32 (T, d), the routing: the chosen experts
    (T, k), then in ``moe_route``'s expert order token, rank, kept,
    slot)."""
    from repro_torch.models import layers as L
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = L.moe_capacity(T, k, E, cfg.capacity_factor)
    logits = x.float() @ p["router"].float()
    lg = logits.cpu().numpy()
    gidx = np.argsort(-lg, axis=1, kind="stable")[:, :k]
    gval = np.take_along_axis(lg, gidx, 1)
    gates = np.exp(gval - gval.max(1, keepdims=True))
    gates /= gates.sum(1, keepdims=True)
    flat_e, flat_t = gidx.reshape(-1), np.repeat(np.arange(T), k)
    order = np.argsort(flat_e, kind="stable")
    se, st = flat_e[order], flat_t[order]
    rank = np.zeros_like(se)
    seen = np.zeros(E, np.int64)
    for j, e in enumerate(se):
        rank[j] = seen[e]
        seen[e] += 1
    keep = rank < C
    slot = np.where(keep, se * C + rank, E * C)
    g = gates.reshape(-1)[order]
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    xf = x.float()
    for e in np.unique(se[keep]):
        sel = keep & (se == e)
        tok = torch.as_tensor(st[sel], device=x.device)
        xe = xf[tok]
        h = L.silu(xe @ p["we1"][e].float()) * (xe @ p["we3"][e].float())
        ye = (h @ p["we2"][e].float()) * torch.as_tensor(
            g[sel], dtype=torch.float32, device=x.device)[:, None]
        y.index_add_(0, tok, ye)
    return y, dict(gidx=gidx, token=st, rank=rank, keep=keep, slot=slot)


def moe_gate(torch, x, p, cfg, what):
    """``layers.moe_ffn`` at full width on the served MoE input ``x``
    (T, d) and layer 0's bf16 weights, against ``moe_reference`` (TF32
    off): expert choice, ranks and kept slots equal; the layer computed in
    float32 (its weights cast per einsum, one 22.5 GB temporary at a time)
    within ``MOE_GATE_TOL`` of the reference's scale; and the layer as
    served (bf16 products and combine, the JAX package's roundings) within
    ``MOE_BF16_TOL``, its count outside ``MOE_GATE_TOL`` printed."""
    from repro_torch.models import layers as L
    T = x.shape[0]
    C = L.moe_capacity(T, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            r = L.moe_route(x.float() @ p["router"].float(), cfg.top_k, C)
            ref, rr = moe_reference(torch, x, p, cfg)
            want = ref.cpu().numpy()
            del ref
            outs = {}
            for name, dt in (("float32", torch.float32), ("served", cfg.cdt)):
                y, _ = L.moe_ffn(x[None], p["router"], p["we1"], p["we3"],
                                 p["we2"], top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 dtype=dt)
                outs[name] = y[0].float().cpu().numpy()
                del y
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    same = {k: np.array_equal(r[a].cpu().numpy(), rr[k]) for k, a in (
        ("gidx", "gidx"), ("token", "stt"), ("rank", "rank"),
        ("keep", "keep"), ("slot", "slot"))}
    scale = max(1e-30, float(np.abs(want).max()))

    def outside(got, tol):
        err = np.abs(got - want)
        ok = err <= tol["atol"] * scale + tol["rtol"] * np.abs(want)
        return float(err.max()), int((~ok).sum())
    e32, o32 = outside(outs["float32"], MOE_GATE_TOL)
    e16, o16 = outside(outs["served"], MOE_BF16_TOL)
    return dict(what=what, tokens=T, capacity=C,
                dropped_pairs=int((~rr["keep"]).sum()), routing_equal=same,
                scale=scale, float32_max_abs_err=e32, float32_outside_tol=o32,
                tol=MOE_GATE_TOL, served_dtype=str(cfg.cdt),
                served_max_abs_err=e16, served_outside_bf16_tol=o16,
                bf16_tol=MOE_BF16_TOL,
                served_outside_tol=outside(outs["served"], MOE_GATE_TOL)[1])


A2A_SHARDS = 8     # the stacked expert mesh of ``lm_moe``'s a2a gate


def moe_a2a_gate(torch, x, p, cfg, what, dense):
    """``models.moe_a2a.moe_ffn_a2a`` on the served MoE input ``x`` (B,
    S, d), B = ``A2A_SHARDS``, and layer 0's bf16 weights on a stacked
    expert mesh (``make_local_mesh(data=A2A_SHARDS)``, tokens on the same
    axis: each shard routes its own batch row). Held to: each token's
    experts equal to the dense dispatch's, each shard's kept pairs to a
    host count of the per-shard capacity, the layer (float32; as served)
    to ``moe_reference`` run shard by shard (its capacity is the
    shard's), the aux loss to the mean of the shards' losses. ``dense``:
    the dense dispatch's gate of the same input (its dropped pairs)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.moe_a2a import a2a_plan, moe_ffn_a2a
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    mesh = make_local_mesh(x.device, data=A2A_SHARDS)
    kw = dict(top_k=k, capacity_factor=cfg.capacity_factor, mesh=mesh,
              token_axes=("data",), expert_axes=("data",), tp_axis=None)
    plan = a2a_plan(B, S, E, p["we1"].shape[-1], **kw)
    if plan is None:
        raise AssertionError(f"moe_a2a falls back at batch {B}")
    C = plan["C_l"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            refs, routes, auxes = [], [], []
            for s in range(B):
                xs = x[s].reshape(-1, d)
                ref, rr = moe_reference(torch, xs, p, cfg)
                refs.append(ref.cpu().numpy())
                routes.append(rr)
                lg = xs.float() @ p["router"].float()
                auxes.append(float(L._load_balance_loss(
                    lg, torch.as_tensor(rr["gidx"], device=x.device), E)))
                del ref
            want = np.concatenate(refs)
            dense_r = L.moe_route(x.reshape(-1, d).float() @
                                  p["router"].float(), k, 1)
            outs = {}
            for name, dt in (("float32", torch.float32), ("served", cfg.cdt)):
                y, aux, r = moe_ffn_a2a(x, p["router"], p["we1"], p["we3"],
                                        p["we2"], dtype=dt,
                                        return_routing=True, **kw)
                outs[name] = y.reshape(-1, d).float().cpu().numpy()
                outs[name + "_aux"] = float(aux)
                gidx = r["gidx"].reshape(-1, k).cpu().numpy()
                kept = r["keep"].sum(-1).cpu().numpy()
                del y, r
                torch.cuda.empty_cache()
            ms = cuda_ms(lambda: moe_ffn_a2a(
                x, p["router"], p["we1"], p["we3"], p["we2"], dtype=cfg.cdt,
                **kw), reps=3, warm=1)
            dense_ms = cuda_ms(lambda: L.moe_ffn(
                x, p["router"], p["we1"], p["we3"], p["we2"], top_k=k,
                capacity_factor=cfg.capacity_factor, dtype=cfg.cdt),
                reps=3, warm=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    host_kept = [int(rr["keep"].sum()) for rr in routes]
    scale = max(1e-30, float(np.abs(want).max()))

    def outside(got, tol):
        err = np.abs(got - want)
        ok = err <= tol["atol"] * scale + tol["rtol"] * np.abs(want)
        return float(err.max()), int((~ok).sum())
    e32, o32 = outside(outs["float32"], MOE_GATE_TOL)
    e16, o16 = outside(outs["served"], MOE_BF16_TOL)
    aux_want = float(np.mean(auxes))
    return dict(
        what=what, shards=A2A_SHARDS, tokens=B * S, shard_capacity=C,
        dense_capacity=dense["capacity"],
        experts_equal_dense=bool(np.array_equal(
            gidx, dense_r["gidx"].cpu().numpy())),
        kept_equal_host=bool(kept.tolist() == host_kept),
        kept_pairs=int(sum(host_kept)),
        dropped_pairs=int(B * S * k - sum(host_kept)),
        dense_dropped_pairs=dense["dropped_pairs"],
        scale=scale, float32_max_abs_err=e32, float32_outside_tol=o32,
        served_max_abs_err=e16, served_outside_bf16_tol=o16,
        aux=outs["float32_aux"], aux_served=outs["served_aux"],
        aux_shard_mean=aux_want,
        aux_rel_err=abs(outs["float32_aux"] - aux_want) / abs(aux_want),
        a2a_ms=ms, dense_ms=dense_ms)


def moe_a2a_serve(torch, eng, prompts, cfg, elapsed_s):
    """``A2A_SHARDS`` more requests through the served engine under
    ``set_rules(MOE_SERVE_RULES, mesh)``: ``lm.moe_apply`` takes the
    all-to-all dispatch on the stacked expert mesh. Fewer (a multiple of
    the slots) or none, ``reduced`` printed, where the time so far
    projects past the script's limit. Returns the summary (None where
    cut)."""
    from repro_torch.dist.sharding import MOE_SERVE_RULES, set_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe_a2a
    later = LM_PHASES[[s["arch"] for s in LM_PHASES].index(
        LM_MOE["arch"]) + 1:]
    room = TIME_LIMIT_S - TIME_MARGIN_S - elapsed_s - family_floor_s(later)
    n = A2A_SHARDS if room > A2A_SHARDS * LM_MOE["per_request_s"] + 30 \
        else 0
    if n < A2A_SHARDS:
        say("reduced", arch=cfg.arch, of="lm_moe_a2a_serve", requests=n,
            asked=A2A_SHARDS, elapsed_s=elapsed_s)
    if not n:
        return None
    calls = []
    real = moe_a2a.moe_ffn_a2a

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    while eng.active:            # the profile's requests, dense as served
        eng.step()
    moe_a2a.moe_ffn_a2a = counted
    nf0 = int(eng.nonfinite)
    try:
        mesh = make_local_mesh(eng.device, data=A2A_SHARDS)
        with set_rules(MOE_SERVE_RULES, mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eng.run(prompts[:n], max_new=LM_MOE["new"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        moe_a2a.moe_ffn_a2a = real
    toks = [t for r in results.values() for t in r]
    return dict(requests=n, served_tokens=len(toks), seconds=wall,
                tokens_per_s=len(toks) / wall, a2a_calls=len(calls),
                a2a_prefill_calls=sum(1 for c in calls if c[1] > 1),
                tokens_in_vocab=bool(all(0 <= t < cfg.vocab for t in toks)),
                all_finished=len(results) == n and all(
                    len(r) == LM_MOE["new"] for r in results.values()),
                nonfinite_logits=int(eng.nonfinite) - nf0)


def moe_stats(torch, calls, cfg):
    """Per recorded MoE call (its input ``x`` (B, S, d) as served):
    dropped (token, expert) pairs, expert load (max / mean hits), the
    balance loss and the distinct experts chosen (each keeps its first
    pair: C >= 1), from ``moe_route`` on the same router logits."""
    from repro_torch.models import layers as L
    out = dict(prefill=[], decode=[])
    with torch.inference_mode():
        for x, router in calls:
            T = x.shape[0] * x.shape[1]
            C = L.moe_capacity(T, cfg.top_k, cfg.n_experts,
                               cfg.capacity_factor)
            logits = x.reshape(T, -1).float() @ router.float()
            r = L.moe_route(logits, cfg.top_k, C)
            hits = torch.bincount(r["gidx"].reshape(-1),
                                  minlength=cfg.n_experts).float()
            aux = L._load_balance_loss(logits, r["gidx"], cfg.n_experts)
            out["decode" if x.shape[1] == 1 else "prefill"].append((
                int((~r["keep"]).sum()), float(hits.max() / hits.mean()),
                float(aux), T, int((hits > 0).sum())))
    summary = {}
    for kind, rows in out.items():
        if not rows:
            continue
        d, load, aux, T, used = (np.array(v) for v in zip(*rows))
        summary[kind] = dict(calls=len(rows), tokens_mean=float(T.mean()),
                             dropped_pairs_mean=float(d.mean()),
                             dropped_pairs_max=int(d.max()),
                             dropped_share=float(d.sum() /
                                                 (T.sum() * cfg.top_k)),
                             expert_load_max_over_mean=float(load.mean()),
                             aux_loss_mean=float(aux.mean()),
                             experts_chosen_mean=float(used.mean()))
    return summary


def phase_lm_moe(args, torch, elapsed_s=0.0):
    """``lm_moe``: kimi-k2 at its published width, 1 layer of 61 (printed
    under ``reduced``), bf16, served through ``ServeEngine`` (its prefill
    at batch = slots: the batch's rows share the experts' capacity). Every
    MoE call's input is kept (``layers.moe_ffn`` wrapped for the run and
    the profile) and read after it: dropped pairs per prefill and per
    decode step, expert load, the aux loss. 8 profiled decode steps, their
    bound from the experts their tokens chose (``moe_stats``: the weights
    a sparse dispatch must read), the dense dispatch's (every expert read,
    as ``moe_ffn``'s einsums do) beside it. The gate: the first prefill's
    and one decode step's MoE inputs through ``moe_ffn`` against
    ``moe_reference`` (``moe_gate``). No teacher-forced check: a served
    MoE token depends on the batch around it (the capacity), in the JAX
    package too."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    t_phase = time.perf_counter()
    cfg = get_arch(LM_MOE["arch"]).CONFIG.scaled(layers=LM_MOE["layers"])
    say("reduced", arch=cfg.arch, layers=cfg.layers,
        published_layers=get_arch(LM_MOE["arch"]).CONFIG.layers)
    calls = []
    served_moe = L.moe_ffn

    def recorded(x, router_w, *a, **kw):
        calls.append((x.detach(), router_w))
        return served_moe(x, router_w, *a, **kw)
    L.moe_ffn = recorded
    try:
        run = lm_served_run(args, torch, LM_MOE, cfg, elapsed_s, "lm_moe")
        eng, fails, line = run["eng"], run["fails"], run["line"]
        t0 = time.perf_counter()
        stats = moe_stats(torch, calls, cfg)
        stats_s = time.perf_counter() - t0
        first_prefill = next(x for x, _ in calls if x.shape[1] > 1)
        a_decode = next(x for x, _ in calls if x.shape[1] == 1)
        calls.clear()
        t0 = time.perf_counter()
        profile = lm_decode_profile(torch, eng, run["prompts"], cfg,
                                    run["pbytes"], LM_MOE)
        profile_s = time.perf_counter() - t0
    finally:
        L.moe_ffn = served_moe
    t0 = time.perf_counter()
    a2a_serve = moe_a2a_serve(torch, eng, run["prompts"], cfg, elapsed_s +
                              time.perf_counter() - t_phase)
    a2a_serve_s = time.perf_counter() - t0
    if a2a_serve is not None and not (
            a2a_serve["all_finished"] and a2a_serve["tokens_in_vocab"] and
            not a2a_serve["nonfinite_logits"] and
            a2a_serve["a2a_prefill_calls"] and
            a2a_serve["a2a_calls"] > a2a_serve["a2a_prefill_calls"]):
        fails.append(f"serving under MOE_SERVE_RULES: {a2a_serve}")
    layers = run["params"]["layers"]
    experts = sum(layers[k].numel() * layers[k].element_size()
                  for k in ("we1", "we2", "we3"))
    # the profiled steps are the last decode calls (their warm-up steps
    # admit and prefill first)
    chosen = moe_stats(torch, [c for c in calls if c[0].shape[1] == 1]
                       [-LM_PROFILE_STEPS * cfg.layers:], cfg)["decode"]
    calls.clear()
    used = chosen["experts_chosen_mean"]
    sparse = profile["weight_bytes"] - experts * (1 - used / cfg.n_experts)
    profile.update(
        dense_dispatch_weight_bytes=profile["weight_bytes"],
        dense_dispatch_bound_ms=profile["bound_ms"],
        dense_dispatch_bound_share=profile["bound_share"],
        experts_chosen_per_step=used, weight_bytes=sparse,
        bound_ms=(sparse + profile["kv_valid_bytes"]) / HBM_BYTES_PER_S * 1e3)
    profile["bound_share"] = profile["bound_ms"] / profile["step_ms"]
    # the gate needs layer 0's router and experts only: the embeddings
    # (4.7 GB), attention and engine go, so that its float32 layer's
    # 22.5 GB weight casts fit beside them
    p0 = {k: layers[k][0] for k in ("router", "we1", "we2", "we3")}
    del eng, run, layers
    free_card(torch)
    t0 = time.perf_counter()
    gates = [moe_gate(torch, first_prefill.reshape(-1, cfg.d_model), p0, cfg,
                      "first prefill"),
             moe_gate(torch, a_decode.reshape(-1, cfg.d_model), p0, cfg,
                      "a decode step")]
    gate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a2a_gates = [moe_a2a_gate(torch, x, p0, cfg, g["what"], g)
                 for x, g in ((first_prefill, gates[0]),
                              (a_decode, gates[1]))]
    a2a_gate_s = time.perf_counter() - t0
    for g in a2a_gates:
        if not (g["experts_equal_dense"] and g["kept_equal_host"]) or \
                g["float32_outside_tol"] or g["served_outside_bf16_tol"] \
                or g["aux_rel_err"] > 1e-5:
            fails.append(f"the a2a MoE layer ({g['what']}): experts equal "
                         f"{g['experts_equal_dense']}, kept equal "
                         f"{g['kept_equal_host']}, "
                         f"{g['float32_outside_tol']} float32 and "
                         f"{g['served_outside_bf16_tol']} served outputs "
                         f"outside, aux rel err {g['aux_rel_err']}")
    for g in gates:
        if not all(g["routing_equal"].values()) or \
                g["float32_outside_tol"] or g["served_outside_bf16_tol"]:
            fails.append(f"MoE layer against its float32 loop ({g['what']})"
                         f": routing {g['routing_equal']}, "
                         f"{g['float32_outside_tol']} float32 and "
                         f"{g['served_outside_bf16_tol']} served outputs "
                         "outside their tolerances")
    say("lm_moe", **line, moe=stats, expert_bytes=experts,
        experts_read_ms_at_hbm_rate=experts / HBM_BYTES_PER_S * 1e3,
        gate=gates, a2a_gate=a2a_gates, a2a_serve=a2a_serve,
        decode_profile=profile,
        seconds_by_part=dict(run=line["seconds"], stats=stats_s,
                             profile=profile_s, a2a_serve=a2a_serve_s,
                             gate=gate_s, a2a_gate=a2a_gate_s),
        failed=fails or None, phase_seconds=time.perf_counter() - t_phase)
    if fails:
        raise AssertionError(f"lm_moe: {fails}")
    del p0, first_prefill, a_decode
    free_card(torch)


def encdec_serve(torch, model, params, frames, prompts, new, smax,
                 times=None):
    """Whisper requests as one batch: each request's ``model.prefill`` on
    its frames and prompt (batch 1, into its row of a batch cache: a view,
    ``cache_batch_dims``), the encoder's states of all of them
    (``lm.encode``, once), then ``new - 1`` greedy ``model.decode`` steps
    at batch ``len(prompts)`` with ``enc_out``, each row at its own
    position. Returns (tokens (R, new), logits (R, new, V), enc_out)."""
    from repro_torch.models import lm
    from repro_torch.models.api import cache_batch_dims, cache_map
    dev = params["embed"].device
    R = len(prompts)
    sync = torch.cuda.synchronize
    cache = model.init_cache(R, smax, device=dev)
    dims = cache_batch_dims(model.cfg)
    first = []
    for i, prompt in enumerate(prompts):
        sync()
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt[None], dtype=torch.int32, device=dev)
        rows = cache_map(lambda c, d: c.narrow(d, i, 1), cache, dims)
        logits, _ = model.prefill(params, {"tokens": toks,
                                           "frames": frames[i:i + 1]}, rows)
        first.append(logits[0])
        sync()
        if times is not None:
            times["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc = lm.encode(model.cfg, params, frames)
    sync()
    if times is not None:
        times["encode_ms"].append((time.perf_counter() - t0) * 1e3)
    logits = torch.stack(first)
    pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=dev)
    out = [logits]
    for j in range(new - 1):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        t0 = time.perf_counter()
        logits, cache = model.decode(params, {"token": nxt, "pos": pos + j,
                                              "enc_out": enc}, cache)
        sync()
        if times is not None:
            times["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
    logits = torch.stack(out, 1)
    return torch.argmax(logits, dim=-1).cpu().numpy(), logits, enc


def phase_lm_encdec(args, torch, elapsed_s=0.0):
    """``lm_encdec``: whisper-small at its published width in bf16,
    ``family_requests`` requests of 1,500 stub frame embeddings (random
    from the seed) with decoder prompts of 4-64 tokens, served as one
    batch (``encdec_serve``: a ``model.prefill`` a request, which encodes
    its frames, then 63 ``model.decode`` steps with ``enc_out``; 64 tokens
    each). Fails on a token outside the vocabulary, a non-finite logit or
    a graph kernel launch. Then, at the init's scale, the encoder in
    float32 against float64 (printed: how far float32 holds this random
    model). The float32 gate (TF32 off, weights at 1 / sqrt(fan-in):
    ``lm_fan_in_scale``): ``gate_requests`` of them served the same way,
    every logit within ``LM_GATE_TOL`` of the train-mode forward over the
    same tokens on the same ``enc_out``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.models.api import build_model
    t_phase = time.perf_counter()
    spec = LM_ENCDEC
    cfg = get_arch(spec["arch"]).CONFIG
    n = family_requests(spec, elapsed_s)
    rng = np.random.default_rng(args.seed)
    lo, hi = spec["prompt"]
    prompts = [rng.integers(0, cfg.vocab, int(s)).astype(np.int32)
               for s in rng.integers(lo, hi + 1, n)]
    gen = torch.Generator("cuda").manual_seed(args.seed)
    frames = torch.randn((n, spec["frames"], cfg.d_model), generator=gen,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(args.seed))
    count, pbytes = lm_check_params(torch, cfg, params, "lm_encdec")
    times = dict(prefill_ms=[], encode_ms=[], step_ms=[])
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    toks, logits, _ = encdec_serve(torch, model, params, frames.to(cfg.cdt),
                                   prompts, spec["new"], spec["smax"], times)
    wall = time.perf_counter() - t0
    graph_launches = kops.launch_counts()
    fails = []
    if toks.shape != (n, spec["new"]) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        fails.append("a request without its tokens, or one outside the "
                     "vocabulary")
    nonfinite = int((~torch.isfinite(logits)).sum())
    if nonfinite:
        fails.append(f"{nonfinite} non-finite logits")
    if any(graph_launches.values()):
        fails.append(f"graph kernels launched: {graph_launches}")
    pct = (lambda xs, q: float(np.percentile(xs, q)))
    say("lm_encdec", card=card_line(), arch=cfg.arch, dtype=cfg.param_dtype,
        enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
        d_model=cfg.d_model, params=count, param_bytes=pbytes, requests=n,
        frames=spec["frames"], new_tokens=spec["new"],
        prompt_tokens=int(sum(len(p) for p in prompts)),
        served_tokens=int(toks.size), seconds=wall,
        tokens_per_s=toks.size / wall,
        prefill_ms_p50=pct(times["prefill_ms"], 50),
        prefill_ms_p99=pct(times["prefill_ms"], 99),
        encode_ms=times["encode_ms"][0], decode_batch=n,
        decode_step_ms_p50=pct(times["step_ms"], 50),
        decode_step_ms_p99=pct(times["step_ms"], 99),
        graph_kernel_launches=graph_launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        failed=fails or None)
    if fails:
        raise AssertionError(f"lm_encdec: {fails}")
    del logits, params, model
    free_card(torch)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg32 = cfg.scaled(param_dtype="float32", compute_dtype="float32")
        model = build_model(cfg32)
        params = model.init(torch.Generator("cuda").manual_seed(args.seed))
        with torch.inference_mode():      # the init's scale: f32 vs f64
            cfg64 = cfg.scaled(param_dtype="float64",
                               compute_dtype="float64")
            p64 = {k: ({m: t.double() for m, t in v.items()}
                       if isinstance(v, dict) else v.double())
                   for k, v in params.items()}
            e32 = lm.encode(cfg32, params, frames[:1])
            e64 = lm.encode(cfg64, p64, frames[:1].double())
            f64 = dict(max_abs_diff=float((e32.double() - e64).abs().max()),
                       scale=float(e64.abs().max()))
            del p64, e32, e64
        say("encdec_f64", card=card_line(), weights="init scale",
            encoder_float32_against_float64=f64)
        lm_fan_in_scale(params)
        g = min(n, spec["gate_requests"])
        toks, logits, enc = encdec_serve(torch, model, params, frames[:g],
                                         prompts[:g], spec["new"],
                                         spec["smax"])
        worst = dict(max_abs_err=0.0, outside_tol=0, logits=0)
        for i in range(g):
            allt = torch.as_tensor(np.concatenate([prompts[i],
                                                   toks[i, :-1]]),
                                   dtype=torch.int32, device="cuda")[None]
            with torch.inference_mode():
                h, _, _ = lm.forward(cfg32, params, allt,
                                     lm.make_positions(cfg32, allt), "train",
                                     enc_out=enc[i:i + 1])
                ref = lm._unembed(cfg32, params,
                                  h[:, len(prompts[i]) - 1:])[0]
            got, want = logits[i].cpu().numpy(), ref.cpu().numpy()
            err = np.abs(got - want)
            ok = err <= LM_GATE_TOL["atol"] + LM_GATE_TOL["rtol"] * \
                np.abs(want)
            worst = dict(max_abs_err=max(worst["max_abs_err"],
                                         float(err.max())),
                         outside_tol=worst["outside_tol"] + int((~ok).sum()),
                         logits=worst["logits"] + ok.size)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    fails = ["decode logits outside the tolerance of the forward"] \
        if worst["outside_tol"] else []
    say("lm_encdec_gate", card=card_line(), dtype="float32", tf32=False,
        weights="1/sqrt(fan-in)", requests=g, **worst, **LM_GATE_TOL,
        failed=fails or None, phase_seconds=time.perf_counter() - t_phase)
    if fails:
        raise AssertionError(f"lm_encdec_gate: {fails}")
    del params, model, frames, logits, enc
    free_card(torch)

# --------------------------------------------------------------------------
# LM training (after lm_encdec)
# --------------------------------------------------------------------------

H100_BF16_DENSE_FLOPS = 989e12   # NVIDIA data sheet, SXM, dense
TRAIN_LOSS_REL_TOL = 1e-5        # float32 step's loss against float64
TRAIN_GRAD_REL_TOL = 1e-4        # each leaf's |g32 - g64| / |g64|
# the SMOKE loop gates: tests/test_train_checkpoint.py's arguments
TRAIN_DECREASE_ARGS = ["--arch", "internlm2-1.8b", "--smoke", "--steps",
                       "120", "--batch", "16", "--seq", "64", "--lr", "1e-3"]
TRAIN_RESUME_ARGS = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "4",
                     "--seq", "32", "--schedule-total", "30"]


def train_plan(spec, elapsed_s: float):
    """(timed steps, global batch) that keep the projected script time
    inside ``TIME_LIMIT_S`` less ``TIME_MARGIN_S``: timed steps are cut
    first (to ``floor``), then the batch is halved (one micro-batch row
    of each of the ``accum``); ``reduced`` printed for either cut."""
    room = TIME_LIMIT_S - TIME_MARGIN_S - elapsed_s - spec["fixed_s"] - \
        LM_DRYRUN["fixed_s"]
    per = spec["per_request_s"]
    steps = int(min(spec["requests"], max(spec["floor"], room // per)))
    batch = spec["batch"]
    if room < spec["floor"] * per:
        batch //= 2
    if steps < spec["requests"] or batch < spec["batch"]:
        say("reduced", arch=spec["arch"], of="lm_train", timed_steps=steps,
            asked_steps=spec["requests"], batch=batch,
            asked_batch=spec["batch"], elapsed_s=elapsed_s)
    return steps, batch


def train_batch(torch, stream, accum, device):
    """The stream's next batch as (accum, micro-batch, ...) tensors on the
    card, as ``launch.train`` reshapes and places it."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.reshape((accum, -1) + v.shape[1:]))).to(device)
        for k, v in next(stream).items()}


def lm_train_profile(torch, step_fn, state, batch):
    """One train step under ``torch.profiler`` (device activity only):
    kernel events, the runtime's launch calls, the device's busy share.
    The profiler's raw events are read (``kineto_results``): building its
    event tree for a step's ~175,000 kernels took 28.8 s on an H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_events = time.perf_counter()
    launch_calls = kernels = busy_ns = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ns += e.duration_ns()
            kernels += not e.name().startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in e.name():
            launch_calls += 1
    return state, dict(step_ms=wall * 1e3, launch_calls=launch_calls,
                       kernel_events=kernels,
                       device_busy_share=busy_ns / (wall * 1e9),
                       loss=float(m["loss"]), trace_s=t_events - t_trace,
                       events_s=time.perf_counter() - t_events)


def lm_train_timed(args, torch, spec, elapsed_s):
    """The full-width run: ``launch.train.main`` for ``launch_steps``
    steps, then, on a fresh state from the seed, one warm step and the
    timed steps through the same ``make_train_step`` (CUDA events around
    each), one profiled step. Fails on a non-finite loss or gradient
    norm."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as ltrain
    from repro_torch.models.api import build_model
    from repro_torch.train import (adamw, cosine_schedule, init_train_state,
                                   make_train_step)
    cfg = get_arch(spec["arch"]).CONFIG
    steps, batch = train_plan(spec, elapsed_s)
    accum, seq, dev = spec["accum"], spec["seq"], spec["device"]
    marks = [time.perf_counter()]
    torch.cuda.reset_peak_memory_stats()
    launch_losses = ltrain.main([
        "--arch", cfg.arch, "--steps", str(spec["launch_steps"]),
        "--batch", str(batch), "--seq", str(seq), "--accum", str(accum),
        "--device", dev])
    launch_peak = torch.cuda.max_memory_allocated()
    free_card(torch)
    marks.append(time.perf_counter())

    model = build_model(cfg)
    opt = adamw(cosine_schedule(3e-4, 20, 21))    # the launcher's
    state = init_train_state(model, opt, torch.Generator(dev).manual_seed(
        args.seed))
    count, pbytes = lm_check_params(torch, cfg, state.params, "lm_train")
    step_fn = make_train_step(model, opt, accum=accum)
    stream = TokenStream(cfg.vocab, batch, seq, seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, train_batch(torch, stream, accum, dev))
    warm_loss = float(m["loss"])
    warm_ms = (time.perf_counter() - t0) * 1e3
    marks.append(time.perf_counter())
    times, losses, gnorms = [], [], []
    for _ in range(steps):
        b = train_batch(torch, stream, accum, dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, m = step_fn(state, b)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    marks.append(time.perf_counter())
    state, prof = lm_train_profile(torch, step_fn, state,
                                   train_batch(torch, stream, accum, dev))
    marks.append(time.perf_counter())
    tokens = batch * seq
    bound_ms = 6 * count * tokens / H100_BF16_DENSE_FLOPS * 1e3
    p50 = float(np.percentile(times, 50))
    fails = []
    if not np.all(np.isfinite(launch_losses + losses + gnorms +
                              [warm_loss, prof["loss"]])):
        fails.append("a non-finite loss or gradient norm")
    say("lm_train", card=card_line(), arch=cfg.arch, dtype=cfg.param_dtype,
        layers=cfg.layers, d_model=cfg.d_model, vocab=cfg.vocab,
        params=count, remat=cfg.remat, optimizer="adamw",
        seq=seq, global_batch=batch, accum=accum,
        micro_batch=batch // accum, tokens_per_step=tokens,
        launch_train=dict(steps=spec["launch_steps"], losses=launch_losses,
                          peak_memory_bytes=launch_peak),
        warm_step_ms=warm_ms, warm_loss=warm_loss, timed_steps=steps,
        step_ms=times, step_ms_p50=p50, step_ms_max=max(times),
        tokens_per_s=tokens / (p50 / 1e3), losses=losses,
        grad_norms=gnorms, peak_memory_bytes=peak,
        state_bytes=dict(params=pbytes, grads=pbytes,
                         adamw_m_v=2 * 4 * count,
                         float32_accumulator=4 * count if accum > 1 else 0),
        profile=prof, flops_bound=dict(
            flops=6 * count * tokens, rule="6 x params x tokens",
            peak_flops=H100_BF16_DENSE_FLOPS, bound_ms=bound_ms,
            bound_by="operations"),
        mfu=bound_ms / p50,
        seconds_by_part=dict(zip(("launch_train", "warm", "timed",
                                  "profile"), np.diff(marks).tolist())),
        failed=fails or None)
    if fails:
        raise AssertionError(f"lm_train: {fails}")
    from repro_torch.tree import leaves as tree_leaves

    def tree_bytes(t):
        return sum(x.numel() * x.element_size() for x in tree_leaves(t))
    opt_state = state.opt_state
    measured = dict(params=tree_bytes(state.params),
                    m_v=tree_bytes(opt_state["m"]) +
                    tree_bytes(opt_state["v"]),
                    count=tree_bytes(opt_state["count"]))
    del state, step_fn, model, opt, opt_state
    free_card(torch)
    return measured


def lm_train_gate(args, torch, spec):
    """The float32 gate: internlm2-1.8b at full width cut to
    ``gate_layers`` layers (``reduced``), weights at 1/sqrt(fan-in), one
    ``make_train_step`` step in float64 and one in float32 (TF32 off) on
    the same batch and params; the gradients taken at the
    ``grad_transform`` hook (before the clip). Fails if the loss's
    relative error passes ``TRAIN_LOSS_REL_TOL`` or any leaf's
    |g32 - g64| / |g64| passes ``TRAIN_GRAD_REL_TOL``. The bf16 step's
    loss on the same params is printed beside (no gate)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models.api import build_model
    from repro_torch.train import adamw, cosine_schedule, make_train_step
    from repro_torch.train.step import TrainState
    from repro_torch.tree import flatten_with_path, tree_map
    full = get_arch(spec["arch"]).CONFIG
    L, dev = spec["gate_layers"], spec["device"]
    say("reduced", of="lm_train_gate", arch=full.arch, layers=L,
        published_layers=full.layers)
    cfg = full.scaled(layers=L)
    b = next(TokenStream(cfg.vocab, spec["gate_batch"], spec["gate_seq"],
                         seed=args.seed))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        cfg32 = cfg.scaled(param_dtype="float32", compute_dtype="float32")
        params32 = build_model(cfg32).init(
            torch.Generator(dev).manual_seed(args.seed))
        lm_fan_in_scale(params32)
        g64 = {}

        def run(dtype, params, keep):
            c = cfg.scaled(param_dtype=dtype, compute_dtype=dtype)
            model = build_model(c)
            opt = adamw(cosine_schedule(3e-4, 20, 21))
            state = TrainState(params, opt.init(params), torch.zeros(
                (), dtype=torch.int32, device=dev))
            fn = make_train_step(model, opt, grad_transform=keep)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            t0 = time.perf_counter()
            _, m = fn(state, batch)
            loss = float(m["loss"])
            out[dtype] = dict(loss=loss, grad_norm=float(m["grad_norm"]),
                              seconds=time.perf_counter() - t0)

        def keep64(g):
            g64.update((("/".join(p), x.clone()) for p, x in
                        flatten_with_path(g)))
            return g

        def cmp32(g):
            errs = {}
            for p, x in flatten_with_path(g):
                ref = g64["/".join(p)]
                errs["/".join(p)] = float(torch.linalg.vector_norm(
                    x.double() - ref) / torch.linalg.vector_norm(ref))
            out["leaf_rel_errs"] = errs
            return g

        run("float64", tree_map(lambda t: t.double(), params32), keep64)
        run("float32", tree_map(lambda t: t.clone(), params32), cmp32)
        del g64
        run("bfloat16", tree_map(lambda t: t.to(torch.bfloat16), params32),
            None)
        del params32
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    l32, l64 = out["float32"]["loss"], out["float64"]["loss"]
    loss_rel = abs(l32 - l64) / abs(l64)
    errs = out["leaf_rel_errs"]
    worst = max(errs, key=errs.get)
    fails = []
    if not loss_rel <= TRAIN_LOSS_REL_TOL:
        fails.append(f"loss rel err {loss_rel} > {TRAIN_LOSS_REL_TOL}")
    if not errs[worst] <= TRAIN_GRAD_REL_TOL:
        fails.append(f"grad leaf {worst}: rel err {errs[worst]} > "
                     f"{TRAIN_GRAD_REL_TOL}")
    say("lm_train_gate", card=card_line(), arch=cfg.arch, layers=L,
        d_model=cfg.d_model, vocab=cfg.vocab, weights="1/sqrt(fan-in)",
        tf32=False, batch=spec["gate_batch"], seq=spec["gate_seq"],
        loss_float64=l64, loss_float32=l32,
        loss_bfloat16_printed_only=out["bfloat16"]["loss"],
        loss_rel_err=loss_rel, loss_tol=TRAIN_LOSS_REL_TOL,
        grad_leaf_rel_err_max=errs[worst], worst_leaf=worst,
        grad_leaf_rel_errs=errs, grad_tol=TRAIN_GRAD_REL_TOL,
        grad_norm_float64=out["float64"]["grad_norm"],
        grad_norm_float32=out["float32"]["grad_norm"],
        seconds={k: out[k]["seconds"]
                 for k in ("float64", "float32", "bfloat16")},
        failed=fails or None)
    if fails:
        raise AssertionError(f"lm_train_gate: {fails}")
    free_card(torch)


def lm_train_loops(torch, spec):
    """The SMOKE loop gates through ``launch.train.main`` on the card:
    the loss decreases over 120 steps (the mean of the last 10 below the
    mean of the first 10 less 0.05), and a run checkpointed at 20 and
    resumed to 30 equals an uninterrupted 30-step run (the last 5 losses
    within rtol 2e-4 / atol 1e-5). The checkpoints go under ``build/``
    and are removed; the launcher's SIGTERM hook is taken off after."""
    import shutil
    import signal
    from repro_torch.launch import train as ltrain
    cuda = ["--device", spec["device"]]
    t0 = time.perf_counter()
    dec = ltrain.main(TRAIN_DECREASE_ARGS + cuda)
    first, last = float(np.mean(dec[:10])), float(np.mean(dec[-10:]))
    t1 = time.perf_counter()
    d = os.path.join(ROOT, "build", "lm_train_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    hook = signal.getsignal(signal.SIGTERM)
    try:
        a = ltrain.main(TRAIN_RESUME_ARGS + cuda + [
            "--steps", "20", "--ckpt-dir", d, "--ckpt-every", "10"])
        b = ltrain.main(TRAIN_RESUME_ARGS + cuda + [
            "--steps", "30", "--ckpt-dir", d, "--ckpt-every", "10"])
    finally:
        signal.signal(signal.SIGTERM, hook)
        shutil.rmtree(d, ignore_errors=True)
    c = ltrain.main(TRAIN_RESUME_ARGS + cuda + ["--steps", "30"])
    t2 = time.perf_counter()
    diff = np.abs(np.asarray(b[-5:]) - np.asarray(c[-5:]))
    resume_ok = len(a) == 20 and len(b) == 10 and bool(np.all(
        diff <= 1e-5 + 2e-4 * np.abs(np.asarray(c[-5:]))))
    fails = []
    if not last < first - 0.05:
        fails.append(f"loss did not decrease: {first} -> {last}")
    if not resume_ok:
        fails.append(f"resumed losses {b[-5:]} differ from {c[-5:]}")
    say("lm_train_loops", card=card_line(), arch="internlm2-1.8b SMOKE",
        decrease=dict(steps=len(dec), mean_first_10=first,
                      mean_last_10=last, seconds=t1 - t0,
                      step_ms_mean=(t1 - t0) * 1e3 / len(dec)),
        resume=dict(resumed=b[-5:], uninterrupted=c[-5:],
                    max_abs_diff=float(diff.max()), rtol=2e-4, atol=1e-5,
                    seconds=t2 - t1),
        failed=fails or None)
    if fails:
        raise AssertionError(f"lm_train_loops: {fails}")


def phase_lm_train(args, torch, elapsed_s=0.0):
    """``lm_train``: the full-width run (``lm_train_timed``), the float32
    gate (``lm_train_gate``), the SMOKE loop gates (``lm_train_loops``),
    all on synthetic tokens with the graph kernels' launch counters
    zeroed before and required at 0 after; then a few SMOKE steps on
    ``--data graph``, whose ingest must launch ``append`` and
    ``sort_lookup``. Returns the graph-fed run's launches by kernel and
    the full-width state's bytes as measured on the card (params, AdamW
    m + v, the count)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ltrain
    t_phase = time.perf_counter()
    kops.reset_launch_counts()
    measured = lm_train_timed(args, torch, LM_TRAIN, elapsed_s)
    lm_train_gate(args, torch, LM_TRAIN)
    lm_train_loops(torch, LM_TRAIN)
    synthetic = kops.launch_counts()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = ltrain.main(["--arch", "internlm2-1.8b", "--smoke", "--steps",
                          str(LM_TRAIN["graph_steps"]), "--batch", "2",
                          "--seq", "64", "--data", "graph",
                          "--device", LM_TRAIN["device"]])
    graph_s = time.perf_counter() - t0
    launches = kops.launch_counts()
    fails = []
    if any(synthetic.values()):
        fails.append(f"graph kernels launched on synthetic data: {synthetic}")
    if not (launches["append"] and launches["sort_lookup"]):
        fails.append(f"the graph-fed run launched {launches}")
    if not np.all(np.isfinite(losses)):
        fails.append("a non-finite loss on graph walks")
    say("lm_train_graph", card=card_line(), steps=len(losses), losses=losses,
        synthetic_parts_launches=synthetic, graph_fed_launches=launches,
        seconds=graph_s, phase_seconds=time.perf_counter() - t_phase,
        failed=fails or None)
    if fails:
        raise AssertionError(f"lm_train_graph: {fails}")
    free_card(torch)
    return launches, measured


# the LM dry-run cells: each a subprocess of ``repro_torch.launch.dryrun``;
# one cell a module written per rank (``dist.local_ops``): the MoE dense
# dispatch (kimi-k2 training), the SSD chunk scan (mamba2 training) and the
# hybrid prefill (recurrentgemma: RG-LRU scan, ring cache roll). A trace
# unrolls every layer and attention block: kimi's 61 layers are cut to one
# 1,024-token attention block, the hybrid prefill to 4,096 positions (past
# its 2,048 window: the ring cache is still written by a roll); each cut
# printed under ``reduced``
LM_DRYRUNS = {
    "train_single": ["--arch", "internlm2-1.8b", "--shape", "train_4k",
                     "--mesh", "single"],
    "decode_multi": ["--arch", "kimi-k2-1t-a32b", "--shape", "decode_32k",
                     "--mesh", "multi"],
    "train_one_card": ["--arch", LM_TRAIN["arch"], "--shape", "train_4k",
                       "--mesh", "local", "--seq", str(LM_TRAIN["seq"]),
                       "--batch", str(LM_TRAIN["batch"])],
    "moe_train_single": ["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k",
                         "--mesh", "single", "--seq", "1024"],
    "ssm_train_single": ["--arch", "mamba2-1.3b", "--shape", "train_4k",
                         "--mesh", "single"],
    "hybrid_prefill_single": ["--arch", "recurrentgemma-9b", "--shape",
                              "prefill_32k", "--mesh", "single", "--seq",
                              "4096"],
}


def lm_dryrun_path(argv) -> str:
    a = dict(zip(argv[::2], argv[1::2]))
    return os.path.join(ROOT, "benchmarks", "results", "dryrun",
                        f"torch-{a['--arch']}__{a['--shape']}__"
                        f"{a['--mesh']}.json")


def start_lm_dryruns() -> dict:
    """Start every ``LM_DRYRUNS`` cell as a subprocess, one intra-op
    thread each (fake tensors: nothing is computed), its output in
    ``build/dryrun_logs``. They start after the last timed phase, so no
    timed figure shares the host's cores with them. Returns name ->
    (process, start time, log path)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    logs = os.path.join(ROOT, "build", "dryrun_logs")
    os.makedirs(logs, exist_ok=True)
    from repro_torch.configs import SHAPES
    procs = {}
    for name, argv in LM_DRYRUNS.items():
        a = dict(zip(argv[::2], argv[1::2]))
        _, seq, batch = SHAPES[a["--shape"]]
        if int(a.get("--seq", seq)) < seq or int(a.get("--batch",
                                                       batch)) < batch:
            say("reduced", of="lm_dryrun", cell=name, arch=a["--arch"],
                shape=a["--shape"], seq=int(a.get("--seq", seq)),
                shape_seq=seq, batch=int(a.get("--batch", batch)),
                shape_batch=batch)
        if os.path.exists(lm_dryrun_path(argv)):
            os.remove(lm_dryrun_path(argv))
        log = os.path.join(logs, name + ".txt")
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun"] + argv,
                env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT),
                time.perf_counter(), log)
    return procs


def stop_lm_dryruns(procs: dict):
    for proc, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_lm_dryrun(procs: dict, measured: dict, elapsed_s: float):
    """``lm_dryrun``: wait for each cell (at most until the script's time
    limit less its margin; a cell still running then is stopped and
    printed under ``reduced``), read its record: ``status`` ok; kimi's
    ``all-to-all`` bytes above 0; the 1 x 1 cell's argument bytes of the
    params and of the optimizer state equal ``measured`` (``lm_train``'s
    state on the card)."""
    t0 = time.perf_counter()
    recs, fails, cut = {}, [], []
    for name, (proc, started, log) in procs.items():
        room = TIME_LIMIT_S - TIME_MARGIN_S - elapsed_s - \
            (time.perf_counter() - t0)
        try:
            proc.wait(timeout=max(1.0, room))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            cut.append(name)
            continue
        path = lm_dryrun_path(LM_DRYRUNS[name])
        if not os.path.exists(path):
            with open(log) as f:
                fails.append(f"{name}: no record (rc {proc.returncode}): "
                             f"{f.read()[-1500:]}")
            continue
        with open(path) as f:
            rec = json.load(f)
        rec["subprocess_s"] = time.perf_counter() - started
        recs[name] = rec
        if rec["status"] != "ok":
            fails.append(f"{name}: {rec.get('error')} at "
                         f"{rec.get('failed_op')}")
    if cut:
        say("reduced", of="lm_dryrun", stopped=cut,
            elapsed_s=elapsed_s + time.perf_counter() - t0)
    kimi = recs.get("decode_multi")
    if kimi and kimi["status"] == "ok" and \
            not kimi["collective_bytes"]["all-to-all"] > 0:
        fails.append("kimi-k2 decode: no all-to-all bytes")
    one = recs.get("train_one_card")
    if one and one["status"] == "ok":
        got = one["argument_bytes"]
        if got["params"] != measured["params"] or \
                got["opt_state"] != measured["m_v"] + measured["count"]:
            fails.append(f"1 x 1 argument bytes {got} against the card's "
                         f"state {measured}")
    say("lm_dryrun", measured_state_bytes=measured, failed=fails or None,
        **{k: {f: r.get(f) for f in (
            "arch", "shape", "mesh", "chips", "status", "trace_s",
            "subprocess_s", "params_total", "params_active", "flops",
            "bytes_accessed", "memory", "argument_bytes",
            "collective_bytes", "collective_counts", "failed_op")}
           for k, r in recs.items()})
    if fails:
        raise AssertionError(f"lm_dryrun: {fails}")


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ingest-ops", type=int, default=1 << 22)
    ap.add_argument("--mixed-ops", type=int, default=1 << 20)
    ap.add_argument("--analytics-edges", type=int, default=1 << 21,
                    help="undirected edges ingested before the analytics")
    ap.add_argument("--sharded-ops", type=int, default=SHARDED_OPS,
                    help="ops of the main path's stream the sharded phase "
                         "applies (a prefix; the whole stream is "
                         "5,242,880)")
    ap.add_argument("--lm-requests", type=int, default=LM_SERVE["requests"],
                    help="requests of the LM serving phase's bf16 run")
    ap.add_argument("--parent", default=None,
                    help="checkout of an earlier commit whose kernel "
                         "wrappers are timed beside this one's")
    args = ap.parse_args(argv)

    print(card_line(), flush=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import repro_torch  # noqa: F401  (fails outside a checkout)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    if args.ingest_ops < (1 << 22) or args.mixed_ops < (1 << 20) or \
            args.analytics_edges < (1 << 21) or \
            args.sharded_ops < (1 << 22) + (1 << 20) or \
            args.lm_requests < LM_SERVE["requests"]:
        say("reduced", ingest_ops=args.ingest_ops, mixed_ops=args.mixed_ops,
            analytics_edges=args.analytics_edges,
            sharded_ops=args.sharded_ops,
            sharded_stream_ops=(1 << 22) + (1 << 20),
            lm_requests=args.lm_requests)

    t0 = time.perf_counter()
    chase_lib = phase_build()
    run_phases(args, torch, t_start, t0, chase_lib)


def run_phases(args, torch, t_start, t0, chase_lib):
    """Every phase after the build, in order, and the last lines."""
    parent = load_parent(args.parent) if args.parent else None
    stream = lj_stream(args)
    store, ids, sample, launches, tally = phase_main(args, torch, stream)
    final_tally = phase_rebuild_check(store, torch)
    kernels = phase_kernels(store, ids, sample, launches, tally, final_tally,
                            chase_lib, torch, parent)
    phase_profile(store, ids, torch)
    replay = phase_durability(args, store, ids, sample, torch)
    del store
    torch.cuda.empty_cache()
    sharded, sharded_err, sh = phase_sharded(args, torch, stream)
    sa_launches, sa_err = phase_sharded_analytics(args, torch, sh)
    torch.cuda.empty_cache()        # the analytics' reference is freed
    rec, rec_root, sd_replay = phase_sharded_durability(args, torch, sh)
    sv_launches = phase_sharded_service(args, torch, sh, rec, rec_root,
                                        time.perf_counter() - t_start)
    del sh, rec
    torch.cuda.empty_cache()
    lm_launches = phase_launch_modes(torch)
    sl = next(k for k in kernels if k["name"] == "sort_lookup")
    art_line = phase_baselines(
        args, torch, sl["latency_floor_ms"] / sl["latency_floor_layers"])
    level, alaunches = phase_analytics(args, torch)
    torch.cuda.empty_cache()
    kernels.append(phase_frontier_kernel(level, alaunches, torch, parent))
    del level
    for line in kernels:    # launches of the replay and the sharded phases
        line["replay_launches"] = replay[line["name"]]
        line["sharded_launches"] = sharded[line["name"]]
        line["sharded_max_abs_err"] = sharded_err.get(line["name"])
        line["sharded_analytics_launches"] = sa_launches[line["name"]]
        line["sharded_analytics_max_abs_err"] = sa_err.get(line["name"])
        line["sharded_replay_launches"] = sd_replay[line["name"]]
        line["sharded_service_launches"] = sv_launches[line["name"]]
        line["launch_modes_launches"] = lm_launches.get(line["name"], 0)
    art_line["launch_modes_launches"] = lm_launches.get("art_insert", 0)
    kernels.append(art_line)
    phase_parity(torch)
    phase_lm_served(args, torch, dict(LM_SERVE, requests=args.lm_requests),
                    "lm_serve", time.perf_counter() - t_start)
    phase_lm_served(args, torch, LM_SSM, "lm_ssm",
                    time.perf_counter() - t_start)
    phase_lm_served(args, torch, LM_HYBRID, "lm_hybrid",
                    time.perf_counter() - t_start)
    phase_lm_moe(args, torch, time.perf_counter() - t_start)
    phase_lm_encdec(args, torch, time.perf_counter() - t_start)
    train, measured = phase_lm_train(args, torch,
                                     time.perf_counter() - t_start)
    for line in kernels:    # launches of the graph-fed training run
        line["train_launches"] = train[line["name"]]
    dryruns = start_lm_dryruns()
    try:
        phase_lm_dryrun(dryruns, measured, time.perf_counter() - t_start)
    finally:
        stop_lm_dryruns(dryruns)
    say("done", seconds=round(time.perf_counter() - t0, 3))
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
