import numpy as np
import pytest
import torch

from bench import reference as ref


def brute(si, di, w):
    live = {}
    for s, d, x in zip(si.tolist(), di.tolist(), w.tolist()):
        if x == 0:
            live.pop((s, d), None)
        else:
            live[(s, d)] = x
    return live


def stream(seed, n=40, ops=600, deletes=0.3):
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 32, n, replace=False).astype(np.uint64)
    si = rng.integers(0, n, ops).astype(np.int32)
    di = rng.integers(0, n, ops).astype(np.int32)
    w = rng.uniform(0.5, 2.0, ops).astype(np.float32)
    w[rng.random(ops) < deletes] = 0.0
    return ids, si, di, w


@pytest.mark.parametrize("seed", range(8))
def test_frozen_oracle_equals_a_dict_replay(seed):
    ids, si, di, w = stream(seed)
    s, d, lw = ref.oracle(len(ids), si, di, w)
    got = dict(zip(zip(s.tolist(), d.tolist()), lw.tolist()))
    assert got == brute(si, di, w)


def by_key(a: ref.Answers) -> dict:
    keys = a.pair_keys.numpy().view(np.uint64).tolist()
    return dict(zip(keys, a.weights.tolist()))


@pytest.mark.parametrize("seed", range(8))
def test_expected_equals_a_dict_replay(seed):
    ids, si, di, w = stream(seed, n=300, ops=2000)
    a = ref.expected(ids, si, di, w)
    live = brute(si, di, w)
    assert a.num_edges == len(live) == a.pair_keys.numel()
    assert a.num_vertices == len(set(si.tolist()) | set(di.tolist()))
    assert by_key(a) == {(int(ids[s]) << 32) | int(ids[d]): x
                         for (s, d), x in live.items()}
    s, d, lw = ref.oracle(len(ids), si, di, w)
    assert sorted(by_key(a).values()) == sorted(lw.tolist())


def test_compare_counts_each_kind_of_difference():
    ids, si, di, w = stream(1, n=300, ops=2000, deletes=0.0)
    want = ref.expected(ids, si, di, w)
    assert set(ref.compare(want, want).values()) == {0}
    found = want.found.clone()
    found[:3] = False
    wts = want.weights.clone()
    wts[5] = 1.25 if wts[5] != 1.25 else 1.5
    # two pairs dropped, one duplicated
    keys = torch.cat([want.pair_keys[2:], want.pair_keys[10:11]])
    wts = torch.cat([wts[2:], wts[10:11]])
    bad = ref.Answers(found, want.num_vertices + 1, want.num_edges - 2,
                      keys, wts)
    assert ref.compare(bad, want) == {
        "ids_unresolved": 3, "vertices_off": 1, "edges_off": 2,
        "pairs_missing": 2, "pairs_extra": 1, "weights_off": 1}


def test_keys_of_high_ids_compare_as_bit_patterns():
    ids = np.array([2 ** 32 - 1, 2 ** 31, 5, 2 ** 31 - 1], np.uint64)
    si = np.array([0, 1, 2, 3, 0], np.int32)
    di = np.array([1, 0, 3, 2, 3], np.int32)
    w = np.ones(5, np.float32)
    a = ref.expected(ids, si, di, w)
    assert set(by_key(a)) == {(int(ids[s]) << 32) | int(ids[d])
                              for s, d in zip(si, di)}
    shuffled = ref.Answers(a.found, a.num_vertices, a.num_edges,
                           a.pair_keys.flip(0), a.weights.flip(0))
    assert set(ref.compare(shuffled, a).values()) == {0}


def test_the_control_precision_fails_the_weights():
    ids, si, di, w = stream(3, n=300, ops=2000, deletes=0.0)
    want = ref.expected(ids, si, di, w)
    c = ref.compare(ref.expected(ids, si, di, w, "bfloat16"), want)
    assert c["weights_off"] > 0.9 * want.num_edges
    assert c["pairs_missing"] == c["pairs_extra"] == 0
