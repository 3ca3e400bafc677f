"""The trainer's mesh paths (ROADMAP A11.9) on the CPU:
``python -m repro_torch.launch.train --devices 4`` on 4 gloo ranks.

* Synced: danube's smoke config on the (2, 2) debug mesh, parameters and
  adamw state placed by ``param_pspecs``, batches by ``batch_pspec``. Its
  losses and trained parameters equal the one-device CLI's on the same
  batches: rtol 1e-5 on losses; parameters within 2e-6 but for at most 1e-4
  of the elements, none off by more than 2 lr a step (adamw's step is ~lr
  times the sign of a moment, and fp32 gradients summed over ranks in
  another order can flip the sign of a near-zero one).
* Hierarchical (``--hierarchical H``, the (2, 1, 2) pod mesh): pod 0's
  parameters equal the stacked one-device ``make_pod_local_train_step`` +
  ``make_cross_pod_sync`` on the same batch shares (atol 2e-6), and at H = 1
  they are within the reference test's 5e-3 of the synced one-device step
  (``tests/test_distributed.py``).
"""
import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import batches, synthetic_tokens
from repro_torch.launch import steps, train
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_map

ARCH = "h2o-danube-1.8b"
B, SEQ = 4, 32


def _argv(steps_, *extra):
    return ["--arch", ARCH, "--steps", str(steps_), "--batch", str(B),
            "--seq", str(SEQ), "--log-every", "1", "--device", "cpu", *extra]


def _close_trees(got, want, atol, frac=0.0, bound=None):
    """Leaves within ``atol``, but for at most ``frac`` of the elements,
    which stay within ``bound``."""
    flat_g = dict(_flat(got))
    flat_w = dict(_flat(want))
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        d = (flat_g[k].float() - w.float()).abs()
        assert float((d > atol).float().mean()) <= frac, (k, float(d.max()))
        assert bound is None or float(d.max()) <= bound, k


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif torch.is_tensor(tree):
        yield prefix, tree


def test_synced_mesh_cli_matches_one_device(capfd):
    one = train.main(_argv(3))
    got = train.main(_argv(3, "--devices", "4"))
    out = capfd.readouterr().out
    assert out.count("arch=h2o-danube-1.8b-smoke") == 2  # rank 0 prints
    assert "devices=4" in out
    assert got["mesh"] == {"data": 2, "model": 2} and got["devices"] == 4
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    _close_trees(got["params"], one["params"], atol=2e-6, frac=1e-4,
                 bound=2 * 3 * 3e-4)
    _close_trees(got["opt_state"]["m"], one["opt_state"]["m"], atol=2e-6)
    assert int(got["opt_state"]["step"]) == 3
    assert len(got["rank_peak_mb"]) == 4 and got["rank_peak_mb"][0] is None
    assert all(h == {} for h in got["rank_host_bytes"])  # CPU: no staging


def _stacked_reference(steps_, hier, n_pods=2):
    """The reference's hierarchical loop on one device: stacked pod
    replicas, ``make_pod_local_train_step`` on each pod's batch share,
    ``make_cross_pod_sync`` every ``hier`` steps; pod 0's parameters."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=3e-4)
    params = model.init(torch.Generator().manual_seed(train.SEED))
    stack = lambda t: tree_map(  # noqa: E731
        lambda x: torch.stack([x] * n_pods) if torch.is_tensor(x) else x, t)
    ps, os_ = stack(params), stack(opt.init(params))
    inner = steps.make_pod_local_train_step(model, opt, n_pods)
    sync = steps.make_cross_pod_sync(n_pods)
    it = batches(synthetic_tokens(cfg.vocab_size, 2_000_000, seed=0), B, SEQ,
                 seed=1)
    losses = []
    for step in range(steps_):
        toks = torch.from_numpy(next(it)["tokens"]).to(torch.int64)
        ps, os_, loss = inner(ps, os_, {"tokens": toks.reshape(
            n_pods, B // n_pods, SEQ)})
        if (step + 1) % hier == 0:
            ps = sync(ps)
        losses.append(float(loss.mean()))
    return tree_map(lambda x: x[0], ps), losses


def test_hierarchical_mesh_cli_matches_stacked_steps():
    """H = 2 over 3 steps: a synced step and an unsynced one."""
    got = train.main(_argv(3, "--devices", "4", "--hierarchical", "2"))
    assert got["mesh"] == {"pod": 2, "data": 1, "model": 2}
    want, losses = _stacked_reference(3, 2)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close_trees(got["params"], want, atol=2e-6)


def test_stacked_steps_at_h1_match_the_synced_step():
    """The law the mesh path is held to above, at H = 1 (the reference
    test's bound): 2 pod-local steps, each followed by the cross-pod mean,
    against 2 synced one-device steps on the whole batches."""
    pod0, _ = _stacked_reference(2, 1)
    synced = train.main(_argv(2))["params"]
    diff = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        sorted(_flat(pod0)), sorted(_flat(synced))))
    assert 0 < diff < 5e-3, diff
