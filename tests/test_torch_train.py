"""The port's token pipeline and trainer CLI (``repro_torch.data.tokens``,
``repro_torch.launch.train``), on the CPU at smoke configs.

``synthetic_tokens`` and ``batches`` are host numpy ``RandomState`` laws:
the port's arrays equal the reference's bit for bit. ``train.main`` runs
the reference's loop (its data, its optimizer at a constant lr, a
checkpoint every 50 steps) on ``--device cpu``; its losses equal a loop of
``make_train_step`` over the same init and batches exactly (one process,
one arithmetic). The multi-device paths raise, naming ROADMAP A11.9.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.data import tokens as JTOK
from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import tokens as TTOK
from repro_torch.launch import steps, train
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer


@pytest.mark.parametrize("vocab,n,seed", [(512, 20_000, 0), (32_000, 50_000, 3),
                                          (7, 1000, 1)])
def test_token_pipeline_matches_reference_bit_for_bit(vocab, n, seed):
    want = JTOK.synthetic_tokens(vocab, n, seed=seed)
    got = TTOK.synthetic_tokens(vocab, n, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for a, b in itertools.islice(zip(TTOK.batches(got, 3, 17, seed=seed + 1),
                                     JTOK.batches(want, 3, 17, seed=seed + 1)),
                                 5):
        assert list(a) == list(b) == ["tokens"]
        assert a["tokens"].shape == (3, 17)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def _argv(arch, steps_=3, *extra):
    return ["--arch", arch, "--steps", str(steps_), "--batch", "2", "--seq",
            "32", "--log-every", "1", "--device", "cpu", *extra]


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mixtral-8x22b",
                                  "qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_train_main_equals_a_loop_of_train_steps(arch, capsys):
    """The CLI's loop, for a dense model (adamw), an MoE (adafactor) and
    the two stubs (the vision stub's embeds, positions and labels; the
    audio stub's frames), against ``make_train_step`` from the same seeded
    init over the same batches."""
    res = train.main(_argv(arch))
    out = capsys.readouterr().out
    cfg = get_smoke_config(arch)
    assert f"arch={cfg.name} params=" in out and "devices=1" in out
    assert out.count("\nstep ") == 3 and "final loss:" in out
    assert res["cfg"] == cfg and len(res["step_ms"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0] + 0.5

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(train.SEED))
    opt = make_optimizer(cfg.optimizer, lr=3e-4)
    state = opt.init(params)
    step = steps.make_train_step(model, opt)
    it = TTOK.batches(TTOK.synthetic_tokens(cfg.vocab_size, 2_000_000, 0),
                      2, 32, seed=1)
    gen = torch.Generator().manual_seed(train.SEED + 1)
    losses = []
    for _ in range(3):
        toks = torch.from_numpy(next(it)["tokens"]).long()
        params, state, loss = step(params, state,
                                   train.train_batch(cfg, toks, gen))
        losses.append(float(loss))
    assert losses == res["losses"]


def test_train_batch_follows_the_stub_specs():
    toks = torch.arange(2 * 40).reshape(2, 40)
    gen = torch.Generator().manual_seed(0)
    audio = get_smoke_config("seamless-m4t-large-v2")
    b = train.train_batch(audio, toks, gen)
    assert b["frames"].shape == (2, 10, audio.d_model)
    assert b["frames"].dtype == torch.float32 and b["tokens"] is toks
    assert train.train_batch(audio, toks[:, :8], gen)["frames"].shape[1] == 8
    vision = get_smoke_config("qwen2-vl-7b")
    b = train.train_batch(vision, toks, gen)
    assert sorted(b) == ["embeds", "labels", "positions"]
    assert b["positions"].shape == (2, 40, 3)
    assert b["labels"][:, -1].tolist() == [-1, -1]
    assert torch.equal(b["labels"][:, :-1], toks[:, 1:])
    assert train.train_batch(get_smoke_config("mamba2-2.7b"), toks,
                             gen) == {"tokens": toks}


def test_train_main_checkpoints_every_50_steps(tmp_path, capsys):
    d = str(tmp_path / "ck")
    res = train.main(["--arch", "h2o-danube-1.8b", "--steps", "51", "--batch",
                      "1", "--seq", "8", "--log-every", "25", "--layers", "1",
                      "--ckpt-dir", d, "--device", "cpu"])
    assert capsys.readouterr().out.count("\nstep ") == 3  # steps 0, 25, 50
    assert latest_step(d) == 50
    tree, step = load_checkpoint(d)
    assert step == 50 and int(tree["step"]) == 50
    assert sorted(tree) == ["params", "step"]
    assert tree["params"]["embed"].shape == tuple(
        res["params"]["embed"].shape)


def test_train_main_refuses_the_mesh_paths(monkeypatch):
    """The mesh paths (ROADMAP A11.9) refuse, before any rank starts, a
    mesh that does not take the ranks: four visible cards with ``--full``
    ask for the (16, 16) production mesh, with ``--hierarchical`` the (2,
    16, 16) one, and 6 ranks have no (2, 6 // 4, 2) pod mesh. On one device
    ``--hierarchical`` is ignored, as in the reference."""
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 6"):
        train.main(_argv("h2o-danube-1.8b", 1, "--devices", "6",
                         "--hierarchical", "1"))
    monkeypatch.setattr(train, "default_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train.main(_argv("h2o-danube-1.8b", 1, "--full"))
    with pytest.raises(ValueError, match="needs 512 ranks"):
        train.main(_argv("h2o-danube-1.8b", 1, "--full", "--hierarchical",
                         "2"))
    monkeypatch.undo()
    res = train.main(_argv("h2o-danube-1.8b", 2, "--hierarchical", "2",
                           "--devices", "1"))
    assert len(res["losses"]) == 2
