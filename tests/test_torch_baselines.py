"""The port's vertex-index baselines (``repro_torch.baselines``) against
the JAX package's (``repro.baselines``): the same IDs and offsets, made
with numpy, through ``JaxART`` / ``TorchART`` and both ``HashIndex``es on
the CPU (where ``TorchART`` inserts through the plain per-key loop of the
``art_insert`` wrapper). Every state tensor, counter and lookup is
compared bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.baselines import HashIndex as JHash
from repro.baselines import JaxART
from repro_torch.baselines import HashIndex, TorchART
from repro_torch.kernels import ops as tops

ART_PARTS = ("skeys", "schild", "dense_of", "dchild")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: one intra-op thread keeps its
    pool from spinning against the JAX reference and the other workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(rng, bits, n):
    return rng.choice(2 ** bits, n, replace=False).astype(np.uint64)


def _queries(rng, ids, bits):
    """Every inserted ID, then as many drawn from the universe (absent
    ones among them)."""
    return np.concatenate([ids, rng.choice(2 ** bits, len(ids)).astype(
        np.uint64)])


def assert_art_equal(jax_art, port_art):
    for name in ART_PARTS:
        for i, (a, b) in enumerate(zip(getattr(jax_art.state, name),
                                       getattr(port_art.state, name))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{name}[{i}]")
    for name in ("scount", "dcount", "overflow"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jax_art.state, name)),
            getattr(port_art.state, name).numpy(), err_msg=name)


def assert_hash_equal(jax_hash, port_hash):
    for name in ("khi", "klo", "val", "used", "overflow"):
        a = np.asarray(getattr(jax_hash.state, name)).astype(np.int64)
        b = getattr(port_hash.state, name).numpy().astype(np.int64)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _both_art(n_max, bits, **kw):
    return (JaxART(n_max=n_max, key_bits=bits, **kw),
            TorchART(n_max=n_max, key_bits=bits, device="cpu", **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bits", [24, 32])
def test_art_matches_jax(seed, bits):
    """Two insert batches (the second also re-inserts IDs of the first,
    which keep their offsets), then lookups of present and absent IDs."""
    rng = np.random.default_rng(seed)
    n = 1500
    ids = _ids(rng, bits, n)
    ja, ta = _both_art(n + 8, bits)
    for lo, hi in ((0, 900), (600, n)):
        off = np.arange(lo, hi, dtype=np.int32) + 7 * seed
        ja.insert(ids[lo:hi], off)
        ta.insert(ids[lo:hi], off)
        assert_art_equal(ja, ta)
    q = _queries(rng, ids, bits)
    got = ta.lookup(q)
    np.testing.assert_array_equal(got, ja.lookup(q))
    np.testing.assert_array_equal(got[:n], np.arange(n) + 7 * seed)
    assert ta.memory_bytes() == ja.memory_bytes()
    assert int(ta.scount_total()) == int(ja.scount_total())


def test_art_metamorphoses_sparse_nodes_to_dense():
    """Keys under 40 16-bit prefixes: the root (~40 first bytes) and the
    40 nodes of layer 2 (~75 keys each) outgrow 16 slots, so each
    metamorphoses and migrates its 16 entries to a dense row."""
    rng = np.random.default_rng(5)
    prefixes = rng.choice(2 ** 16, 40, replace=False).astype(np.uint64)
    ids = np.unique((prefixes[rng.integers(0, 40, 3000)] << np.uint64(16)) |
                    rng.integers(0, 2 ** 16, 3000).astype(np.uint64))
    ja, ta = _both_art(len(ids) + 8, 32)
    off = np.arange(len(ids), dtype=np.int32)
    ja.insert(ids, off)
    ta.insert(ids, off)
    assert_art_equal(ja, ta)
    dcount = ta.state.dcount.tolist()
    assert dcount[0] == 1 and dcount[2] == 40
    q = _queries(rng, ids, 32)
    np.testing.assert_array_equal(ta.lookup(q), ja.lookup(q))


@pytest.mark.parametrize("case", ["dense_rows", "sparse_nodes"])
def test_art_overflow_counts_match_jax(case):
    """``cap_d`` (64 dense rows: ``dense_frac`` tiny) or ``cap_s`` (more
    keys than ``n_max``) runs out: the same writes are dropped and the
    same overflows counted."""
    rng = np.random.default_rng(9)
    bits = 24
    if case == "dense_rows":
        ids = _ids(rng, bits, 6000)
        ja, ta = _both_art(6008, bits, dense_frac=0.001)
    else:
        ids = _ids(rng, bits, 2000)
        ja, ta = _both_art(400, bits)
    off = np.arange(len(ids), dtype=np.int32)
    ja.insert(ids, off)
    ta.insert(ids, off)
    assert_art_equal(ja, ta)
    assert int(ta.state.overflow) > 0
    if case == "dense_rows":
        assert ta.state.dcount.tolist()[1] == ta.state.dchild[1].shape[0]
    q = _queries(rng, ids, bits)
    np.testing.assert_array_equal(ta.lookup(q), ja.lookup(q))


def test_art_insert_runs_the_plain_loop_on_the_cpu():
    ta = TorchART(n_max=64, key_bits=32, device="cpu")
    before = tops.launch_counts()
    ta.insert(np.arange(40, dtype=np.uint64) * 7919, np.arange(40))
    assert tops.launch_counts() == before        # no kernel on the CPU
    np.testing.assert_array_equal(
        ta.lookup(np.arange(40, dtype=np.uint64) * 7919), np.arange(40))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bits", [24, 32])
def test_hash_matches_jax(seed, bits):
    """A batch with repeated keys (the last offset of a key wins) over a
    table at load 0.6, so that probes collide and several keys claim one
    empty slot in one round; then an update batch."""
    rng = np.random.default_rng(seed)
    n = 1200
    ids = _ids(rng, bits, n)
    jh = JHash(n_max=n, key_bits=bits)
    th = HashIndex(n_max=n, key_bits=bits, device="cpu")
    rep = np.concatenate([ids, rng.choice(ids[:100], 300)])
    perm = rng.permutation(len(rep))
    batches = [(rep[perm], np.arange(len(rep), dtype=np.int32)[perm]),
               (ids[::3], -np.arange(len(ids[::3]), dtype=np.int32) - 5)]
    for b_ids, b_off in batches:
        jh.insert(b_ids, b_off)
        th.insert(b_ids, b_off)
        assert_hash_equal(jh, th)
    q = _queries(rng, ids, bits)
    got = th.lookup(q)
    np.testing.assert_array_equal(got, jh.lookup(q))
    assert (got[:n] != -1).all()
    assert th.memory_bytes() == jh.memory_bytes()


def test_hash_probe_rounds_run_out_as_in_jax():
    """Four probe rounds on a table at load 0.9: some keys are never
    placed (``overflow``), and ``used`` counts placements and updates."""
    rng = np.random.default_rng(4)
    bits = 32
    ids = _ids(rng, bits, 1850)
    jh = JHash(n_max=1024, key_bits=bits, rounds=4)
    th = HashIndex(n_max=1024, key_bits=bits, rounds=4, device="cpu")
    for lo, hi in ((0, 1200), (1000, 1850)):
        off = np.arange(lo, hi, dtype=np.int32)
        jh.insert(ids[lo:hi], off)
        th.insert(ids[lo:hi], off)
        assert_hash_equal(jh, th)
    assert int(th.state.overflow) > 0
    np.testing.assert_array_equal(th.lookup(ids), jh.lookup(ids))


def test_indices_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="is_available"):
        TorchART(n_max=16)
    with pytest.raises(RuntimeError, match="is_available"):
        HashIndex(n_max=16)


@pytest.mark.parametrize("n", [1000, 10 ** 5])
def test_sort_baseline_configs_match_jax_and_sort_dominates(n):
    """The uniform-tree and vEB-tree SORT baselines of the port's
    optimizer equal the JAX package's, and the optimized SORT needs no
    more space than either (``tests/test_sort_optimizer.py``'s baseline
    case, on the port)."""
    from repro.core import sort_optimizer as jso
    from repro_torch.core import sort_optimizer as tso
    pairs = [(tso.optimize_sort(n, 32, 5), jso.optimize_sort(n, 32, 5)),
             (tso.uniform_config(n, 32, 5), jso.uniform_config(n, 32, 5)),
             (tso.veb_config(n, 32), jso.veb_config(n, 32))]
    for t, j in pairs:
        assert tuple(t.fanout_bits) == tuple(j.fanout_bits)
        assert t.expected_space == pytest.approx(j.expected_space, rel=1e-12)
    s = pairs[0][0].expected_space
    assert s <= pairs[1][0].expected_space + 1e-6
    assert s <= pairs[2][0].expected_space + 1e-6
