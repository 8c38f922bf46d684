import numpy as np
import pytest

from bench import streams


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 11, 3 * 2 ** 40 + 5, -7])
def test_id_mix_is_a_bijection(seed):
    n = 1 << 21
    ids = streams.vertex_ids(n, seed)
    assert ids.dtype == np.uint64 and int(ids.max()) < 2 ** 32
    assert len(np.unique(ids)) == n
    # indices far apart in the 32-bit domain stay distinct too
    idx = np.random.default_rng(0).choice(2 ** 32, 1 << 20,
                                          replace=False).astype(np.uint64)
    assert len(np.unique(streams.id_mix(idx, seed))) == len(idx)


def test_id_mix_depends_on_the_seed():
    a, b = streams.vertex_ids(1000, 1), streams.vertex_ids(1000, 2)
    assert (a != b).mean() > 0.99


CONFIGS = {
    "powerlaw": {"vertices": 50_000, "edges": 1 << 16,
                 "endpoints": {"law": "powerlaw", "exponent": 0.8}},
    "uniform": {"vertices": 50_000, "edges": 1 << 16,
                "endpoints": {"law": "uniform"}},
}
TRAFFIC = {"generator": "load", "weight_range": [0.5, 2.0]}


@pytest.mark.parametrize("law", sorted(CONFIGS))
def test_generators_are_deterministic_per_seed(law):
    cfg = CONFIGS[law]
    mixes = [streams.make_mix(cfg, TRAFFIC, s)
             for s in (2 ** 31 + 3, 2 ** 31 + 3, 2 ** 31 + 4)]
    assert all(m.preload is None and m.remake for m in mixes)
    a, b, c = (m.ops for m in mixes)
    for f in ("ids", "src_idx", "dst_idx", "weight", "src", "dst"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert not np.array_equal(a.src_idx, c.src_idx)
    assert len(a) == cfg["edges"]
    assert a.src_idx.min() >= 0 and a.src_idx.max() < cfg["vertices"]
    assert (a.weight >= 0.5).all() and (a.weight < 2.0).all()
    assert np.array_equal(a.src, a.ids[a.src_idx])


def test_powerlaw_follows_its_rank_law():
    x = streams.endpoints(streams.generator(5), {"law": "powerlaw",
                                                 "exponent": 0.8}, 1000,
                          1 << 21)
    f = np.bincount(x, minlength=1000).astype(float)
    # p(rank r) ~ r^-0.8: rank 1 over rank 2 and rank 10 over rank 100
    assert f[0] / f[1] == pytest.approx(2 ** 0.8, rel=0.03)
    assert f[9] / f[99] == pytest.approx(10 ** 0.8, rel=0.1)


def test_uniform_covers_the_vertices_evenly():
    x = streams.endpoints(streams.generator(6), {"law": "uniform"}, 100,
                          1 << 20)
    f = np.bincount(x, minlength=100)
    assert f.min() > 0.95 * f.mean() and f.max() < 1.05 * f.mean()


def test_only_generators_and_laws_that_exist_run():
    with pytest.raises(ValueError):
        streams.make_mix(CONFIGS["uniform"],
                            dict(TRAFFIC, generator="churn"), 1)
    with pytest.raises(ValueError):
        streams.make_mix(dict(CONFIGS["uniform"],
                                 endpoints={"law": "kronecker"}), TRAFFIC, 1)
