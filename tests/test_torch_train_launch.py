"""The port's training entry point (``python -m repro_torch.launch.train``)
on the CPU: the cases of ``tests/test_train_checkpoint.py`` (the loss
decreases over 120 steps; a run checkpointed at 20 and resumed to 30
equals an uninterrupted 30-step run within rtol 2e-4 / atol 1e-5), plus
``--production-mesh`` exiting with a message, ``--data graph`` training
on walks over the launcher's ``RadixGraph``, no run on a missing card,
and the end-to-end parity of the slice: the JAX launcher trains
internlm2-1.8b SMOKE for 10 steps with a checkpoint directory, then the
port's launcher resumes that directory to step 15 and the JAX launcher a
copy of it; their 5 losses agree within rtol 2e-4.
"""
import shutil
import signal

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as ttrain

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def keep_sigterm_handler():
    """A launcher run with ``--ckpt-dir`` installs its preemption hook in
    this process; put the previous handler back after each test."""
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


def test_loss_decreases():
    losses = ttrain.main(["--arch", "internlm2-1.8b", "--smoke",
                          "--steps", "120", "--batch", "16",
                          "--seq", "64", "--lr", "1e-3"] + CPU)
    assert len(losses) == 120 and np.all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.05


def test_checkpoint_exact_resume(tmp_path):
    d = str(tmp_path / "ck")
    common = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "4",
              "--seq", "32", "--schedule-total", "30"] + CPU
    a = ttrain.main(common + ["--steps", "20", "--ckpt-dir", d,
                              "--ckpt-every", "10"])
    b = ttrain.main(common + ["--steps", "30", "--ckpt-dir", d,
                              "--ckpt-every", "10"])
    c = ttrain.main(common + ["--steps", "30"])
    assert len(a) == 20 and len(b) == 10 and len(c) == 30
    np.testing.assert_allclose(a, c[:20], rtol=2e-4, atol=1e-5)
    # resumed steps 20..29 equal the uninterrupted run's steps 20..29
    np.testing.assert_allclose(b[-5:], c[-5:], rtol=2e-4, atol=1e-5)
    assert ttrain.main(common + ["--steps", "30", "--ckpt-dir", d]) == []


def test_production_mesh_exits_with_a_message():
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--arch", "internlm2-1.8b", "--smoke",
                     "--production-mesh"] + CPU)
    assert "one card" in str(e.value.code)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "1"])


def test_graph_data_trains_through_the_graph_kernels(monkeypatch):
    """``--data graph``: the corpus is random walks over the launcher's
    ``RadixGraph``, whose ingest calls the append and SORT-descent kernel
    wrappers (their plain versions on the CPU, counted here); every loss
    finite."""
    calls = {"append_edges": 0, "sort_lookup": 0}
    for name in calls:
        inner = getattr(kops, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)
        monkeypatch.setattr(kops, name, counted)
    losses = ttrain.main(["--arch", "internlm2-1.8b", "--smoke",
                          "--steps", "3", "--batch", "2", "--seq", "32",
                          "--data", "graph"] + CPU)
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert calls["append_edges"] > 0 and calls["sort_lookup"] > 0, calls


def test_port_resumes_a_jax_run(tmp_path):
    """The slice end to end: a JAX-written checkpoint directory (float32
    params, AdamW moments, the stream's state) resumed by both launchers
    for 5 steps."""
    d = tmp_path / "jax"
    common = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "4",
              "--seq", "32", "--schedule-total", "15"]
    first = jtrain.main(common + ["--steps", "10", "--ckpt-dir", str(d),
                                  "--ckpt-every", "5"])
    assert len(first) == 10
    shutil.copytree(d, tmp_path / "copy")
    port = ttrain.main(common + ["--steps", "15", "--ckpt-dir", str(d)]
                       + CPU)
    ref = jtrain.main(common + ["--steps", "15", "--ckpt-dir",
                                str(tmp_path / "copy")])
    assert len(port) == len(ref) == 5
    np.testing.assert_allclose(port, ref, rtol=2e-4)
