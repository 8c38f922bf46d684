"""The port's engine (``repro_torch.serve.ServeEngine``) serving the moe,
ssm and hybrid families against the JAX package's engine
(``repro.serve.ServeEngine``) on the CPU, and ``repro_torch.launch.serve``
for an ssm arch.

* kimi-k2, mamba2 and recurrentgemma SMOKE in float32 on 3 slots (a slot
  count unlike every other cache dim: the JAX engine finds the batch dim
  by size), with a RadixKV pool small enough to force defrags, admission
  overflows and slot reuse, and recurrentgemma prompts past its window of
  16 (the ring cache): equal results and RadixKV statistics, and before
  every step every leaf of the two caches within 1e-5 (the port's engine
  leaves each row as the JAX engine's batch-``slots`` prefill does);
* the prefill reads the conv tails in the cache it is given (the JAX
  engine's prefill is given the whole cache, so a reused slot starts from
  what its last request left), in both packages (ROADMAP Queue 3);
* the engine refuses an encdec model, as the JAX engine cannot serve one;
* ``python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device
  cpu``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.models import api as tapi
from repro_torch.serve import ServeEngine as TEngine

from _lm_cases import jax_params
from test_torch_serve_lm import SRC, kv_state


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are small: one intra-op thread keeps torch's pool
    from spinning against the JAX side and the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def watch_cache(eng, log, leaves):
    """Before each step, log every leaf of the engine's cache as numpy."""
    step = eng.step

    def logged():
        log.append([np.array(x, np.float32) for x in leaves(eng.cache)])
        return step()
    eng.step = logged


def port_leaves(cache):
    return [x.clone().float() for x in tapi.cache_leaves(cache)]


@pytest.mark.parametrize("arch,lengths", [
    ("kimi-k2-1t-a32b", (6, 9)),
    ("mamba2-1.3b", (6, 9)),
    ("recurrentgemma-9b", (7, 19)),      # 19 > the window of 16: the ring
])
def test_engine_matches_jax(arch, lengths):
    jcfg, tcfg = jconfigs.get_arch(arch).SMOKE, tconfigs.get_arch(arch).SMOKE
    jp, tp = jax_params(jcfg)
    rng = np.random.default_rng(0)
    # two prompt lengths: the JAX engine compiles prefill once per length
    prompts = [rng.integers(0, tcfg.vocab, n).astype(np.int32)
               for n in lengths * 4]
    kw = dict(slots=3, smax=32, kv_blocks=14, block_tokens=4)
    je = JEngine(japi.build_model(jcfg), jp, **kw)
    te = TEngine(tapi.build_model(tcfg), tp, **kw)
    jlog, tlog = [], []
    watch_cache(je, jlog, jax.tree.leaves)
    watch_cache(te, tlog, port_leaves)
    jres = je.run(prompts, max_new=8)
    tres = te.run(prompts, max_new=8)
    assert tres == jres and len(tres) == len(prompts)
    assert kv_state(te.kv) == kv_state(je.kv)
    # the run made defrags, refused admissions and reused slots
    assert te.kv.defrags >= 1 and te.kv.overflow >= 1
    assert len(tlog) == len(jlog)
    for step, (a, b) in enumerate(zip(tlog, jlog)):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5 * max(
                1.0, float(np.abs(y).max(initial=0))),
                err_msg=f"step {step} leaf {i}")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_prefill_reads_the_cache_conv_tail(arch):
    """The JAX prefill starts each conv from the cache's tail (its engine
    passes the whole cache, so a reused slot's prefill reads what its last
    request left): the same non-zero tails in both packages give the same
    logits, and other logits than zero tails do."""
    jcfg, tcfg = jconfigs.get_arch(arch).SMOKE, tconfigs.get_arch(arch).SMOKE
    jp, tp = jax_params(jcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab, (1, 10)).astype(np.int32)
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jc, tc = jm.init_cache(1, 32), tm.init_cache(1, 32, device="cpu")
    jzero, _ = jm.prefill(jp, {"tokens": jax.numpy.asarray(toks)}, jc)
    tails = [rng.normal(size=x.shape).astype(np.float32)
             for x in tapi.cache_leaves(tc)]
    is_conv = [x.ndim >= 4 and x.dtype == torch.float32 and x.shape[-2] ==
               tcfg.conv_width - 1 for x in tapi.cache_leaves(tc)]
    jl = [jax.numpy.asarray(t) if c else x for t, c, x in
          zip(tails, is_conv, jax.tree.leaves(jc))]
    jc = jax.tree.unflatten(jax.tree.structure(jc), jl)
    for t, c, x in zip(tails, is_conv, tapi.cache_leaves(tc)):
        if c:
            x.copy_(torch.from_numpy(t))
    assert any(is_conv)
    jtail, _ = jm.prefill(jp, {"tokens": jax.numpy.asarray(toks)}, jc)
    ttail, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(ttail.numpy(), np.asarray(jtail), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jtail).max()))
    assert np.abs(np.asarray(jtail) - np.asarray(jzero)).max() > \
        1e-3 * float(np.abs(jzero).max())


def test_engine_refuses_encdec():
    cfg = tconfigs.get_arch("whisper-small").SMOKE
    m = tapi.build_model(cfg)
    with pytest.raises(ValueError, match="encdec"):
        TEngine(m, m.init(0, device="cpu"), slots=2, smax=16)


def test_engine_serves_moe_like_its_batched_prefill():
    """kimi-k2 SMOKE with one request active: the second request's prefill
    runs at batch = slots (expert capacity is shared by the batch's rows),
    so its first token is the argmax of that batch's row, and the first
    request's cache rows are untouched."""
    cfg = tconfigs.get_arch("kimi-k2-1t-a32b").SMOKE
    m = tapi.build_model(cfg)
    params = m.init(0, device="cpu")
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, cfg.vocab, 12).astype(np.int32)
            for _ in range(2))
    eng = TEngine(m, params, slots=3, smax=32)
    eng.submit(a, max_new=4)
    before = [x.clone() for x in tapi.cache_leaves(eng.cache)]
    rid = eng.submit(b, max_new=4)
    req = eng.active[rid]
    toks = np.zeros((3, len(b)), np.int32)
    toks[req.slot] = b
    logits, _ = m.prefill(params, {"tokens": torch.from_numpy(toks)},
                          m.init_cache(3, 32, device="cpu"))
    assert req.out == [int(torch.argmax(logits[req.slot]))]
    other = next(r.slot for r in eng.active.values() if r is not req)
    for x, y in zip(tapi.cache_leaves(eng.cache), before):
        assert torch.equal(x[:, other], y[:, other])


def test_launch_serve_ssm_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_NO_JAX_SHIM="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-1.3b", "--smoke", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[serve] 16/16 requests, 192 tokens" in out.stdout
