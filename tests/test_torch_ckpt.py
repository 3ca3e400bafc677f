"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on the CPU: a checkpoint written by
either loads in the other to the same tree (dicts, lists, tuples, ``None``
leaves, ints, fp32 and bf16 leaves), with the reference's file names, JSON
structure index, ``keep`` garbage collection and ``latest_step``.

The bf16 law: the reference writes a bf16 leaf as its raw 2-byte records
(``<V2``) and loads it back as ``|V2``, losing the dtype (ROADMAP C2). The
port writes a bf16 tensor's bits as ``V2`` (no ``ml_dtypes``) and loads
what the reference loads; ``bridge`` turns ``|V2`` leaves back into bf16
tensors. Comparisons are exact.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro_torch import bridge
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves

X = (np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5) / 7


def _ref_tree():
    return {"params": {"w": jnp.asarray(X), "h": jnp.asarray(X, jnp.bfloat16),
                       "stack": [jnp.ones(2), jnp.zeros(3)]},
            "pair": (jnp.int32(7), jnp.arange(3)),
            "step": 12, "nothing": None}


def _port_tree():
    return {"params": {"w": torch.tensor(X),
                       "h": torch.tensor(X).to(torch.bfloat16),
                       "stack": [torch.ones(2), torch.zeros(3)]},
            "pair": (torch.tensor(7, dtype=torch.int32),
                     torch.arange(3, dtype=torch.int32)),
            "step": 12, "nothing": None}


def _assert_same_tree(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_load_to_the_same_tree_on_both_sides(tmp_path, writer):
    d = str(tmp_path / "ckpt")
    if writer == "port":
        path = save_checkpoint(d, 12, _port_tree())
    else:
        path = j_save(d, 12, _ref_tree())
    assert path == os.path.join(d, "ckpt_000000012.npz")
    mine, s1 = load_checkpoint(d)
    theirs, s2 = j_load(d)
    assert s1 == s2 == 12
    _assert_same_tree(mine, theirs)
    assert mine["nothing"] is None
    assert isinstance(mine["params"]["stack"], list)
    assert isinstance(mine["pair"], tuple)
    assert mine["params"]["h"].dtype == np.dtype("V2")  # the dtype is lost
    np.testing.assert_array_equal(mine["params"]["w"], X)
    # the bf16 bits survive, and bridge restores the dtype
    h = bridge.lm_params_from_numpy({"h": mine["params"]["h"]}, "cpu")["h"]
    assert h.dtype == torch.bfloat16
    assert torch.equal(h, torch.tensor(X).to(torch.bfloat16))


def test_both_sides_write_the_same_structure_index(tmp_path):
    save_checkpoint(str(tmp_path / "p"), 3, _port_tree())
    j_save(str(tmp_path / "r"), 3, _ref_tree())
    metas = [json.loads((tmp_path / s / "ckpt_000000003.json").read_text())
             for s in ("p", "r")]
    assert metas[0] == metas[1]
    files = [np.load(tmp_path / s / "ckpt_000000003.npz").files
             for s in ("p", "r")]
    assert sorted(files[0]) == sorted(files[1])
    assert "nothing@none" in files[0]


def test_latest_step_and_gc_match_reference(tmp_path):
    for side, (save, latest) in {"p": (save_checkpoint, latest_step),
                                 "r": (j_save, j_latest)}.items():
        d = str(tmp_path / side)
        assert latest(d) is None
        for s in range(6):
            save(d, s, {"x": np.zeros(1, np.float32)}, keep=2)
        steps = sorted(int(f[5:14]) for f in os.listdir(d)
                       if f.endswith(".npz"))
        assert steps == [4, 5]
        assert latest(d) == 5
        assert not [f for f in os.listdir(d) if ".tmp" in f]
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_checkpoint(str(tmp_path / "empty"))
    tree, step = load_checkpoint(str(tmp_path / "r"), 4)
    assert step == 4 and tree["x"].shape == (1,)


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16", "adafactor"])
def test_optimizer_state_round_trips_through_a_reference_load(tmp_path,
                                                              name):
    """An LM training state saved by the port loads in the reference and
    comes back through ``bridge`` to the same tensors (bf16 moments from
    their ``|V2`` bits, the int32 step)."""
    gen = torch.Generator().manual_seed(0)
    params = {"blocks": {"w": torch.randn((2, 4, 6), generator=gen)
                         .to(torch.bfloat16)},
              "norm": torch.randn((6,), generator=gen)}
    opt = make_optimizer(name)
    state = opt.init(params)
    params, state = opt.update(params, params, state)
    d = str(tmp_path / name)
    save_checkpoint(d, 1, {"params": params, "opt_state": state})
    loaded, _ = j_load(d)
    back = bridge.opt_state_from_numpy(loaded["opt_state"], "cpu")
    p = bridge.lm_params_from_numpy(loaded["params"], "cpu")
    for got, want in zip(tree_leaves([back, p]), tree_leaves([state, params])):
        assert got.dtype == want.dtype and torch.equal(got, want)
