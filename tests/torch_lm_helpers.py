"""Shared helpers of the LM-family parity tests (``tests/test_torch_lm_*.py``,
``test_torch_moe.py``, ``test_torch_mla.py``): the six architectures of
ROADMAP A11.1-A11.5, the reference's smoke parameters with their biases and
norm scales moved off their 0 / 1 inits (gemma's zero-initialised
``1 + scale`` norms are exactly 1 at init, qwen's QKV biases exactly 0, so
a mixed-up leaf would not show), carried into the port through
``bridge.lm_params_from_numpy``, and the comparisons."""
import functools

import jax
import numpy as np
import torch

import repro.configs as jconfigs
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch import configs as tconfigs

ARCHS = ("qwen1.5-4b", "command-r-plus-104b", "gemma2-9b", "mixtral-8x22b",
         "deepseek-v2-236b", "jamba-1.5-large-398b")
# fp32 logits, port against reference (two frameworks' fp32 matmul and
# transcendental orders), and decode against forward (tests/test_archs.py)
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if torch.is_tensor(got) else got),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


def flat(tree, prefix=""):
    """``(path, leaf)`` of a nest of dicts and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def perturbed(tree, rng):
    """Biases and norm scales moved off their 0 / 1 inits."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturbed(v, rng)
        elif k in ("bq", "bk", "bv") or k.endswith(("_scale", "_bias")):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def smoke(arch: str, seed: int = 0):
    """(reference cfg, port cfg, reference params as numpy, port params)."""
    cfg = jconfigs.get_smoke_config(arch)
    params = perturbed(jax.tree_util.tree_map(
        np.asarray, JT.init_params(cfg, jax.random.PRNGKey(seed))),
        np.random.default_rng(seed + 7))
    return (cfg, tconfigs.get_smoke_config(arch), params,
            bridge.lm_params_from_numpy(params, "cpu"))
