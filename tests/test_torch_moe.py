"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the CPU, on the same numpy inputs.

* ``router_probs``: gates, expert ids and the Switch aux loss.
* ``moe_dense`` and ``moe_capacity`` at mixtral's and deepseek-v2's smoke
  widths (deepseek with its shared expert), the capacity path at a large
  capacity (nothing dropped), with T·k >= 1024 (capacity rounded up to a
  multiple of 128), and at a small capacity factor that drops tokens.
* dense against capacity at capacity factor 4 (nothing dropped), at the
  reference's 2e-4 (``tests/test_archs.py``).
* a bf16 MoE tree through ``bridge.lm_params_from_numpy``: the router stays
  fp32.

Router weights are drawn at std 1 / sqrt(d) here (the init's 0.02 leaves
the softmax nearly uniform), so the top-k margins are wide and no expert
choice sits on a tie. Tolerance: rtol = atol = 1e-4 on fp32 outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as JM
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TM
from torch_lm_helpers import close, t


def _setup(arch, seed, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
    p = jax.tree_util.tree_map(np.asarray, JM.moe_init(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    p["router"] = (rng.standard_normal(p["router"].shape)
                   / np.sqrt(jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, bridge.lm_params_from_numpy(p, "cpu"), rng


def _margin(probs, k):
    """The smallest gap between the k-th and (k+1)-th router probability."""
    s = np.sort(probs, -1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_router_probs_match_reference(arch):
    jcfg, tcfg, p, tp, rng = _setup(arch, 1)
    x = rng.standard_normal((300, jcfg.d_model), dtype=np.float32)
    wg, wi, waux = JM.router_probs(jcfg, p, x)
    gg, gi, gaux = TM.router_probs(tcfg, tp, t(x))
    probs = jax.nn.softmax(x @ p["router"], axis=-1)
    assert _margin(np.asarray(probs), jcfg.moe_top_k) > 1e-5
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    close(gg, wg)
    close(gaux, waux)
    np.testing.assert_allclose(gg.sum(-1).numpy(), 1.0, rtol=1e-6)


# (arch, tokens (B, S), capacity factor): capacity, T·k >= 1024, drops
CASES = [
    ("mixtral-8x22b", (2, 24), 4.0),
    ("mixtral-8x22b", (4, 160), 1.25),
    ("mixtral-8x22b", (2, 40), 0.25),
    ("deepseek-v2-236b", (2, 24), 4.0),
    ("deepseek-v2-236b", (2, 48), 0.5),
]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_moe_dense_and_capacity_match_reference(case):
    arch, (Bn, Sn), cf = case
    jcfg, tcfg, p, tp, rng = _setup(arch, Bn * Sn, capacity_factor=cf)
    x = rng.standard_normal((Bn, Sn, jcfg.d_model), dtype=np.float32)
    T, k, E = Bn * Sn, jcfg.moe_top_k, jcfg.n_experts
    C = max(8, int(cf * T * k / E))
    if T * k >= 1024:  # the (4, 160) case: 400 slots rounded up to 512
        C = -(-C // 128) * 128
    assert TM.capacity(tcfg, T) == C
    for name in ("moe_dense", "moe_capacity"):
        want, waux = getattr(JM, name)(jcfg, p, x)
        got, gaux = getattr(TM, name)(tcfg, tp, t(x))
        close(got, want)
        close(gaux, waux)
    # drops: some (token, slot) ranks reach the capacity in the small case
    _, idx, _ = TM.router_probs(tcfg, tp, t(x).reshape(T, -1))
    most = int(torch.bincount(idx.reshape(-1), minlength=E).max())
    assert (most > C) == (cf < 1.0), (most, C)


def test_dense_and_capacity_agree_at_high_capacity():
    """With every routed token within capacity, scatter routing is the
    dense sum: the reference's own check, at its 2e-4."""
    _, tcfg, _, tp, rng = _setup("mixtral-8x22b", 9, capacity_factor=4.0)
    x = t(rng.standard_normal((2, 16, tcfg.d_model), dtype=np.float32))
    dense, daux = TM.moe_dense(tcfg, tp, x)
    cap, caux = TM.moe_capacity(tcfg, tp, x)
    torch.testing.assert_close(cap, dense, rtol=2e-4, atol=2e-4)
    assert float(daux) == float(caux)
    routed = dataclasses.replace(tcfg, router_mode="capacity")
    torch.testing.assert_close(TM.moe_apply(routed, tp, x)[0], cap,
                               rtol=0, atol=0)


def test_bridge_keeps_the_router_fp32_in_a_bf16_tree():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("deepseek-v2-236b"),
                               param_dtype="bfloat16")
    p = jax.tree_util.tree_map(np.asarray, JM.moe_init(
        jcfg, jax.random.PRNGKey(2), jnp.bfloat16))
    got = bridge.lm_params_from_numpy(p, "cpu")
    assert got["router"].dtype == torch.float32
    np.testing.assert_array_equal(got["router"].numpy(), p["router"])
    for name in ("wg", "wu", "wd"):
        assert got[name].dtype == torch.bfloat16
        assert tuple(got[name].shape) == p[name].shape
    assert got["shared"]["w_gate"].dtype == torch.bfloat16
