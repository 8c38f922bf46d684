"""The port's training loop parts against the JAX package's on the CPU:
the data streams (``repro_torch.data``), the checkpoints
(``repro_torch.checkpoint``), the partition planner
(``repro_torch.dist.sharding``) and the meshes (``repro_torch.launch.mesh``).

* ``TokenStream`` batches bit-identical, also after ``restore``;
  ``GraphWalkStream`` walks bit-identical over the launcher's graph,
  built in each package from the same edges; the prefetcher.
* Checkpoints: atomic saves and keep-last-k GC, async saves,
  ``latest_step``, the SIGTERM hook (in a subprocess); float32 train
  states written by either package restored by the other, leaf for leaf
  equal, with the same manifest; a bfloat16 tree written by the JAX
  package restored by the port equal to the saved tree, where the JAX
  package's own restore raises (ROADMAP Queue 3).
* ``spec_for`` against JAX's on the cases of ``tests/test_dist.py``, and
  ``param_partition_specs`` over every SMOKE arch's params on the
  production mesh's shape.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.data import GraphWalkStream as JGraphWalk
from repro.data import TokenStream as JTokens
from repro.dist import sharding as jsh
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.convert import (lm_params_from_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import GraphWalkStream, Prefetcher, TokenStream, \
    shard_batch
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import lm as tlm
from repro_torch.tree import flatten_with_path

from _lm_cases import numpy_params

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def test_token_stream_bit_identical_and_resumes():
    j, t = JTokens(92544, 4, 33, seed=3), TokenStream(92544, 4, 33, seed=3)
    for _ in range(4):
        assert_batches_equal(next(t), next(j))
    assert t.state() == j.state() and t.state_for(2) == j.state_for(2)
    r = TokenStream(92544, 4, 33, seed=0)
    r.restore({"step": 2, "seed": 3})
    j2 = JTokens(92544, 4, 33, seed=3)
    j2.restore({"step": 2, "seed": 3})
    for _ in range(2):
        assert_batches_equal(next(r), next(j2))


def test_graph_walk_stream_bit_identical():
    """The launcher's graph (``launch.train.graph_corpus``: 2,048 IDs,
    16,384 undirected edges) built in each package from the same draws:
    equal CSR views, equal walks, equal after a restore."""
    from repro.core.radixgraph import RadixGraph
    from repro_torch.launch.train import graph_corpus
    jg = RadixGraph(n_max=4096, expected_n=2048, batch=1024,
                    pool_blocks=8192, undirected=True)
    rng = np.random.default_rng(0)
    ids = rng.choice(2**31, 2048, replace=False).astype(np.uint64)
    jg.add_edges(rng.choice(ids, 16384), rng.choice(ids, 16384))
    js = JGraphWalk(jg, 128, 4, 32, seed=5)
    ts = GraphWalkStream(graph_corpus("cpu"), 128, 4, 32, seed=5)
    np.testing.assert_array_equal(ts.indptr, js.indptr)
    np.testing.assert_array_equal(ts.dst, js.dst)
    np.testing.assert_array_equal(ts.active, js.active)
    for _ in range(3):
        assert_batches_equal(next(ts), next(js))
    ts.restore({"step": 1, "seed": 5})
    js.restore({"step": 1, "seed": 5})
    assert_batches_equal(next(ts), next(js))


def test_prefetcher_and_shard_batch():
    """The prefetcher yields the stream's batches in order (numpy, made
    on its thread); ``shard_batch`` places them on the mesh's device."""
    mesh = make_local_mesh(device="cpu")
    it = Prefetcher(TokenStream(100, 2, 8, seed=1), depth=2)
    ref = TokenStream(100, 2, 8, seed=1)
    for _ in range(3):
        b = next(it)
        assert isinstance(b["tokens"], np.ndarray)
        assert_batches_equal(b, next(ref))
        tb = shard_batch(b, mesh)
        assert tb["tokens"].device == mesh.device
        assert tb["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(tb["labels"].numpy(), b["labels"])
    it.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def small_tree():
    return {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}


def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = small_tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, tree, s, {"x": s}, keep=2)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_") and
                   not p.name.endswith(".tmp"))
    assert steps == [4, 5]
    (tmp_path / "step_9.tmp").mkdir()         # a torn save is not a step
    assert latest_step(tmp_path) == 5
    got, step, meta = restore_checkpoint(tmp_path, tree)
    assert step == 5 and meta["x"] == 5
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(10.0))
    got, step, _ = restore_checkpoint(tmp_path, tree, step=4)
    assert step == 4
    assert latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "absent", tree)


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = {"w": torch.ones((8, 4)) * 3}
    ck.save_async(tree, 7, {"stream": {"step": 1, "seed": 0}})
    tree["w"].add_(1)                 # after the call: not in the file
    ck.wait()
    assert latest_step(tmp_path) == 7
    got, step, meta = restore_checkpoint(tmp_path, tree)
    assert step == 7 and meta == {"stream": {"step": 1, "seed": 0}}
    np.testing.assert_array_equal(got["w"].numpy(), np.full((8, 4), 3.0))


def test_checkpoint_sigterm_hook(tmp_path):
    """A SIGTERM saves the state synchronously (metadata ``preempted``)
    and the process exits 0."""
    code = textwrap.dedent(f"""
        import os, signal, torch
        from repro_torch.checkpoint import Checkpointer
        ck = Checkpointer({str(tmp_path)!r})
        state = {{"w": torch.full((4,), 2.0)}}
        ck.install_sigterm_hook(lambda: (state, 11))
        os.kill(os.getpid(), signal.SIGTERM)
        raise SystemExit("the hook did not run")
    """)
    env = dict(os.environ, REPRO_NO_JAX_SHIM="1", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got, step, meta = restore_checkpoint(tmp_path, {"w": torch.zeros(4)})
    assert step == 11 and meta == {"preempted": True}
    np.testing.assert_array_equal(got["w"].numpy(), np.full(4, 2.0))


def jax_train_state(arch="internlm2-1.8b", seed=4):
    """A float32 JAX ``TrainState`` with non-zero moments and count."""
    cfg = tconfigs.get_arch(arch).SMOKE
    jp, _ = numpy_params(cfg, seed=seed)
    opt = jopt.adamw(lambda c: 1e-3)
    st = opt.init(jp)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32), jp)
    _, st = jax.jit(opt.update)(g, st, jp)
    return jstep.TrainState(params=jp, opt_state=st,
                            step=jnp.asarray(3, jnp.int32))


def assert_states_equal(port_state, jax_state):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jax_state))[0]
    tflat = flatten_with_path(train_state_to_numpy(port_state))
    assert [p for p, _ in tflat] == [
        tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in p)
        for p, _ in jflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def test_checkpoints_cross_packages(tmp_path):
    """A float32 train state: the port restores the JAX package's files
    and the JAX package the port's, leaf for leaf equal; both write the
    same keys, shapes and dtypes (the same manifest)."""
    js = jax_train_state()
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    meta = {"stream": {"step": 3, "seed": 0}}
    j_save(tmp_path / "jax", js, 3, meta)
    save_checkpoint(tmp_path / "port", ts, 3, meta)
    jm = (tmp_path / "jax" / "step_3" / "manifest.json").read_text()
    tm = (tmp_path / "port" / "step_3" / "manifest.json").read_text()
    assert json.loads(tm) == json.loads(jm)
    assert list(json.loads(tm)["leaves"])[-2:] == ["opt_state/v/lm_head",
                                                  "step"]
    # zeroed targets: everything must come from the files
    tgt = train_state_from_numpy(jax.tree.map(
        lambda a: np.zeros_like(np.asarray(a)), js), "cpu")
    got, step, m = restore_checkpoint(tmp_path / "jax", tgt)
    assert step == 3 and m == meta
    assert_states_equal(got, js)
    jtgt = jax.tree.map(jnp.zeros_like, js)
    jgot, step, m = j_restore(tmp_path / "port", jtgt)
    assert step == 3 and m == meta
    assert_states_equal(ts, jgot)


def test_bfloat16_checkpoint_of_the_jax_package(tmp_path):
    """The JAX package writes bfloat16 leaves as ``V2`` (numpy has no
    bfloat16), and its own restore cannot cast them back (the reference
    fault in ROADMAP Queue 3). The port reads them through the manifest's
    dtype, equal to the saved tree; a port-written bf16 file restores
    equal in the port."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(6, 5)).astype(ml_dtypes.bfloat16)
    tree = {"w": jnp.asarray(w), "b": jnp.arange(4, dtype=jnp.float32),
            "n": jnp.asarray(7, jnp.int32)}
    j_save(tmp_path, tree, 1)
    man = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_1" / "arrays.npz") as data:
        assert data["w"].dtype.kind == "V"
    with pytest.raises(ValueError):
        j_restore(tmp_path, tree)
    tgt = lm_params_from_numpy(jax.tree.map(
        lambda a: np.zeros_like(np.asarray(a)), tree), "cpu")
    got, _, _ = restore_checkpoint(tmp_path, tgt)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  w.view(np.int16))
    np.testing.assert_array_equal(got["b"].numpy(), np.arange(4.0))
    assert int(got["n"]) == 7
    save_checkpoint(tmp_path / "port", got, 2)
    again, _, _ = restore_checkpoint(tmp_path / "port", tgt)
    assert torch.equal(again["w"], got["w"])
    with np.load(tmp_path / "port" / "step_2" / "arrays.npz") as data:
        np.testing.assert_array_equal(data["w"].view(np.uint16),
                                      w.view(np.uint16))


# ---------------------------------------------------------------------------
# partition planner, meshes
# ---------------------------------------------------------------------------

class FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("shape,axes,rules", [
    ((28, 1536, 12 * 128), ("layers", "fsdp", "tp"), "TRAIN_RULES"),
    ((12,), ("heads",), "TRAIN_RULES"),
    ((256, 256), ("tp", "tp_in"), "TRAIN_RULES"),
    ((256, 4096), ("batch", None), "TRAIN_RULES"),
    ((1, 524288), ("batch", None), "SERVE_RULES"),
    ((384, 7168, 2048), ("experts", "fsdp", "tp"), "MOE_SERVE_RULES"),
    ((384, 7168, 2048), ("experts", "fsdp", "tp"), "TRAIN_RULES"),
])
def test_spec_for_matches_jax(shape, axes, rules):
    mesh = FakeMesh()
    want = jsh.spec_for(shape, axes, getattr(jsh, rules), mesh)
    got = tsh.spec_for(shape, axes, getattr(tsh, rules), mesh)
    assert got == tuple(want)


def test_rule_tables_match_jax():
    for name in ("TRAIN_RULES", "SERVE_RULES", "MOE_SERVE_RULES"):
        assert dict(getattr(tsh, name)) == dict(getattr(jsh, name))
    assert tsh.VARIANTS == jsh.VARIANTS


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_partition_specs_match_jax(arch):
    jshapes, jlogical = japi.shapes_and_logical(jconfigs.get_arch(arch).CONFIG)
    tshapes, tlogical = tlm.init_params(tconfigs.get_arch(arch).CONFIG,
                                        device="meta")
    mesh = FakeMesh()
    want = jsh.param_partition_specs(jshapes, jlogical, jsh.TRAIN_RULES, mesh)
    got = tsh.param_partition_specs(tshapes, tlogical, tsh.TRAIN_RULES, mesh)
    wflat = {"/".join(str(k.key) for k in p): tuple(s) for p, s in
             jax.tree_util.tree_flatten_with_path(
                 want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    gflat = {}              # spec tuples are leaves here, not containers
    stack = [((), got)]
    while stack:
        path, node = stack.pop()
        for k, v in node.items():
            if isinstance(v, dict):
                stack.append((path + (k,), v))
            else:
                gflat["/".join(path + (k,))] = v
    assert gflat == wflat


def test_meshes_and_constrain():
    mesh = make_local_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    assert tsh.spec_for((8, 64), ("batch", "tp"), tsh.TRAIN_RULES, mesh) == \
        ("data", "model")
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True)
    x = torch.ones(2, 3)
    assert tsh.constrain(x, "batch", None) is x
    with tsh.set_rules(tsh.TRAIN_RULES, mesh):
        assert tsh.constrain(x, "batch", "act_seq") is x
        assert tlm.constrain is tsh.constrain
    assert not tsh._ACTIVE
