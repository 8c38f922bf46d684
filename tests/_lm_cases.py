"""LM params for the CPU parity tests of the port's models and engine
(``tests/test_torch_models.py``, ``tests/test_torch_serve_lm.py``): the
JAX package's init, carried into the port with
``convert.lm_params_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import api as japi
from repro_torch.convert import lm_params_from_numpy


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
        for k, v in jp["layers"].items():
            if v.ndim == 3:
                jp["layers"][k] = (v * np.sqrt(v.shape[0] / v.shape[1])
                                   ).astype(v.dtype)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_numpy(jp, "cpu")
