"""LM params for the CPU parity tests of the port's models and engine
(``tests/test_torch_models.py``, ``tests/test_torch_serve_lm.py``,
``tests/test_torch_lm_families.py``, ``tests/test_torch_serve_families.py``):
the JAX package's init, carried into the port with
``convert.lm_params_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import api as japi
from repro_torch.convert import lm_params_from_numpy

# leaves the JAX init draws at a scale of their own (not 1 / sqrt(leading))
OWN_SCALE = ("conv_w",)


def _rescale(tree, lead_dims):
    """Each default-scale matrix leaf of ``tree`` (a dict of stacked
    leaves with ``lead_dims`` stacking dims before the matrix) from the
    init's 1 / sqrt(rows drawn at once) to 1 / sqrt(fan-in), the fan-in
    being ``shape[-2]``. The JAX init draws a hybrid group's leaves over
    (groups x per unit) rows at once, every other stacked leaf over its
    first dim (the experts' too)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _rescale(v, lead_dims)
        elif v.ndim == lead_dims + 2 and k not in OWN_SCALE:
            drawn = int(np.prod(v.shape[:lead_dims]))
            tree[k] = (v * np.sqrt(drawn / v.shape[-2])).astype(v.dtype)
        elif k.startswith("we") and v.ndim == 4:
            tree[k] = (v * np.sqrt(v.shape[0] / v.shape[-2])).astype(v.dtype)


def jax_params(jcfg, seed=1, rescale=True):
    """(JAX params, the same params in the port on the CPU) from
    ``jax.random.PRNGKey(seed)``. With ``rescale`` each layer matrix goes
    from the init's 1 / sqrt(L) to 1 / sqrt(fan-in) (a trained model's
    scale). At the init's own scale attention scores reach ~100 and the
    softmax is near one-hot, so float32 rounding of a score (7.6e-6 at
    100) moves the logits by 2e-6 to 2e-5 of their scale in either
    package against the other; at this scale by under 1e-6."""
    jp = jax.tree.map(np.asarray, japi.build_model(jcfg).init(
        jax.random.PRNGKey(seed)))
    if rescale:
        for name in ("layers", "enc_layers", "dec_layers", "tail"):
            if name in jp:
                _rescale(jp[name], 1)
        if "groups" in jp:
            _rescale(jp["groups"], 2)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_numpy(jp, "cpu")


def numpy_params(tcfg, seed=1):
    """(JAX params, port params on the CPU): the same tree drawn with
    numpy from ``seed``, in the shapes and dtypes of the port's init
    (the JAX init's, checked in ``tests/test_torch_models.py``), without
    the JAX init's seconds of eager draws. Matrices at 1 / sqrt(fan-in)
    (``shape[-2]``), the embedding at 0.02, conv weights at 0.5; norm gains
    1 + N(0, 0.1^2); the SSM's A_log, D and dt_bias and the RG-LRU's lam
    drawn about their init values, so the recurrences are exercised with
    varied decays."""
    from repro_torch.models import lm as tlm
    rng = np.random.default_rng(seed)
    shapes, _ = tlm.init_params(tcfg, device="meta")

    def draw(name, t):
        shp = tuple(t.shape)
        if name.endswith(("ln", "ln1", "ln2", "gnorm")):
            a = 1 + 0.1 * rng.normal(size=shp)
        elif name == "A_log":
            a = np.log(rng.uniform(1, 16, shp))
        elif name == "dt_bias":
            a = rng.uniform(-4, -1, shp)
        elif name == "D":
            a = rng.normal(size=shp)
        elif name == "lam":
            a = rng.uniform(-1, 2, shp)
        elif name == "embed":
            a = 0.02 * rng.normal(size=shp)
        elif name == "conv_w":
            a = 0.5 * rng.normal(size=shp)
        else:
            a = rng.normal(size=shp) / np.sqrt(shp[-2])
        return a.astype(jnp.dtype(str(t.dtype).split(".")[1]))

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else draw(k, v)
                for k, v in d.items()}
    jp = tree(shapes)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_numpy(jp, "cpu")

