"""The port's LM serving (``repro_torch.serve``: ``RadixKVManager``,
``ServeEngine``; ``repro_torch.launch.serve``) against the JAX package's
(``repro.serve``, ``repro.launch.serve``) on the CPU.

* RadixKV: the same op sequences on both managers (the strategy of
  ``tests/test_serve.py``, plus explicit defrags and fixed cases): equal
  sequences, counters and relocation plans after every op;
* the engine: SMOKE internlm2 and qwen2.5 in float32 on both packages,
  with a pool small enough to force defrags, admission overflows, slot
  reuse and an idle slot whose ``cache_len`` runs past ``smax`` (its
  decode writes are dropped): equal results and RadixKV statistics, and
  before every step the active slots' cache rows within 1e-5 (and, the
  port leaving every row as the JAX engine's prefill does, the cache
  lengths of every slot equal);
* the engine against the port's own greedy full forward (dense and vlm);
* ``examples/serve_lm.py`` run as it is, and its sequence on the port
  with the example's params: equal answers;
* ``python -m repro_torch.launch.serve --smoke --device cpu``, and the
  default device raising without a card.
"""
import dataclasses
import os
import runpy
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serve import RadixKVManager as JKV
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.serve import RadixKVManager as TKV
from repro_torch.serve import ServeEngine as TEngine

from _lm_cases import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are small: one intra-op thread keeps torch's pool
    from spinning against the JAX side and the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# RadixKV
# ---------------------------------------------------------------------------

def kv_state(kv):
    return dict(seqs={k: dataclasses.asdict(v) for k, v in kv.seqs.items()},
                next_block=kv.next_block, garbage_blocks=kv.garbage_blocks,
                defrags=kv.defrags, overflow=kv.overflow,
                next_sid=kv._next_sid, live_blocks=kv.live_blocks,
                utilization=kv.utilization)


def drive_both(ops, total_blocks=64, block_tokens=4):
    """``ops`` on a JAX-package and a port manager, compared after each:
    every return value (sids, append results, relocation plans) and the
    whole state."""
    managers = (JKV(total_blocks=total_blocks, block_tokens=block_tokens),
                TKV(total_blocks=total_blocks, block_tokens=block_tokens))
    live = []
    for op, arg in ops:
        if op in ("append", "finish") and not live:
            continue
        outs = []
        for kv in managers:
            if op == "admit":
                outs.append(kv.admit(arg))
            elif op == "append":
                outs.append(kv.append_token(live[arg % len(live)]))
            elif op == "finish":
                outs.append(kv.finish(live[arg % len(live)]))
            else:
                outs.append(kv.defrag())
        assert outs[0] == outs[1], (op, arg, outs)
        if op == "admit" and outs[0] is not None:
            live.append(outs[0])
        elif op == "finish":
            live.remove(live[arg % len(live)])
        assert kv_state(managers[0]) == kv_state(managers[1]), (op, arg)
    return managers[1]


kv_ops = st.lists(st.tuples(st.sampled_from(["admit", "append", "append",
                                             "finish", "defrag"]),
                            st.integers(1, 64)), min_size=1, max_size=200)


@settings(max_examples=30, deadline=None)
@given(kv_ops)
def test_radix_kv_matches_jax(ops):
    drive_both(ops)


def test_radix_kv_fixed_cases():
    # tests/test_serve.py::test_radix_kv_defrag_reclaims on both
    kv = drive_both([("admit", 8)] * 4 + [("finish", 0)] * 3 +
                    [("admit", 40)], total_blocks=32)
    assert kv.defrags >= 1 and kv.overflow == 0
    # re-extent at 2x through the append path, a defrag inside an append,
    # an overflow that rolls the token back, and explicit plans
    ops = [("admit", 5), ("admit", 3)] + [("append", 0)] * 12 + \
        [("finish", 1), ("admit", 9)] + [("append", 1)] * 40 + \
        [("defrag", 0), ("finish", 0), ("defrag", 0), ("admit", 70)]
    kv = drive_both(ops, total_blocks=24)
    assert kv.defrags >= 2 and kv.overflow >= 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def watch_rows(eng, log, rows):
    """Before each step, log the active slots' cache rows up to their
    positions: ``{slot: (k, v, cache_len)}`` as numpy."""
    step = eng.step

    def logged():
        snap = {}
        for r in eng.active.values():
            k, v, clen = (np.asarray(rows(c, r.slot)) for c in eng.cache)
            snap[r.slot] = (k[:, :r.pos], v[:, :r.pos], clen)
        log.append(snap)
        return step()
    eng.step = logged


def jax_row(c, slot):
    return np.asarray(c)[:, slot]


def port_row(c, slot):
    return c[:, slot].clone().numpy()    # the port's cache changes in place


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2.5-3b"])
def test_engine_matches_jax(arch):
    jcfg, tcfg = jconfigs.get_arch(arch).SMOKE, tconfigs.get_arch(arch).SMOKE
    jp, tp = jax_params(jcfg)
    rng = np.random.default_rng(0)
    # three prompt lengths: the JAX engine compiles prefill once per length
    prompts = [rng.integers(0, tcfg.vocab, n).astype(np.int32)
               for n in (6, 9, 4, 6, 9, 4, 6, 9)]
    kw = dict(slots=3, smax=32, kv_blocks=16, block_tokens=4)
    je = JEngine(japi.build_model(jcfg), jp, **kw)
    te = TEngine(tapi.build_model(tcfg), tp, **kw)
    jlog, tlog = [], []
    watch_rows(je, jlog, jax_row)
    watch_rows(te, tlog, port_row)
    jres = je.run(prompts, max_new=16)
    tres = te.run(prompts, max_new=16)
    assert tres == jres and len(tres) == len(prompts)
    assert kv_state(te.kv) == kv_state(je.kv)
    # the run made defrags, refused admissions and reused slots, and an
    # idle slot decoded past smax (its writes dropped)
    assert te.kv.defrags >= 2 and te.kv.overflow >= 1
    assert len(prompts) > kw["slots"]
    assert int(te.cache[2].max()) > kw["smax"]
    np.testing.assert_array_equal(te.cache[2].numpy(), np.asarray(je.cache[2]))
    assert len(tlog) == len(jlog)
    for step, (a, b) in enumerate(zip(tlog, jlog)):
        assert a.keys() == b.keys(), step
        for slot in a:
            for x, y in zip(a[slot], b[slot]):
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5 * max(
                    1.0, float(np.abs(y).max(initial=0))),
                    err_msg=f"step {step} slot {slot}")


def greedy_forward(cfg, params, prompt, steps):
    """Oracle: repeated full forward + argmax."""
    toks = torch.as_tensor(prompt, dtype=torch.int32)[None]
    out = []
    for _ in range(steps):
        h, _, _ = tlm.forward(cfg, params, toks,
                              tlm.make_positions(cfg, toks), "train")
        nxt = int(torch.argmax(tlm._unembed(cfg, params, h)[0, -1]))
        out.append(nxt)
        toks = torch.cat([toks, torch.full((1, 1), nxt, dtype=torch.int32)],
                         1)
    return out


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-vl-2b"])
def test_engine_matches_greedy_forward(arch, rng):
    cfg = tconfigs.get_arch(arch).SMOKE
    m = tapi.build_model(cfg)
    params = m.init(0, device="cpu")
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (7, 5, 11)]
    eng = TEngine(m, params, slots=2, smax=64)
    results = eng.run(prompts, max_new=6)
    for i, p in enumerate(prompts):
        assert results[i] == greedy_forward(cfg, params, p, 6), i


def test_serve_example_matches_jax():
    """``examples/serve_lm.py`` as it is, then its sequence on the port
    with the example's own params carried across."""
    ex = runpy.run_path(os.path.join(ROOT, "examples", "serve_lm.py"))
    cfg = tconfigs.get_arch("internlm2-1.8b").SMOKE
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ex["params"]),
                                  "cpu")
    eng = TEngine(tapi.build_model(cfg), params, slots=4, smax=96,
                  kv_blocks=256, block_tokens=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 20, 12)]
    results = eng.run(prompts, max_new=10)
    assert all(np.array_equal(a, b) for a, b in zip(prompts, ex["prompts"]))
    assert results == ex["results"] and len(results) == len(prompts)
    assert kv_state(eng.kv) == kv_state(ex["eng"].kv)


def test_launch_serve_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_NO_JAX_SHIM="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "internlm2-1.8b", "--smoke", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] 16/16 requests, 192 tokens" in out.stdout


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tconfigs.get_arch("internlm2-1.8b").SMOKE
    m = tapi.build_model(cfg)
    for call in (lambda: tlaunch.main(["--arch", "internlm2-1.8b",
                                       "--smoke"]),
                 lambda: m.init(0),
                 lambda: m.init_cache(2, 16),
                 lambda: lm_params_from_numpy({"x": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
