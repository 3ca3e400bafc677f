"""The check against a broken timed path: the rest of a run is driven as
the benchmark drives it (on the CPU at the small size, past the look for a
card), with the program broken underneath, and ``correct`` comes out false.
Each fault a cell can have: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced. (No cell
spans chips, so no exchange between chips can be left out.) The sound run,
and the fp8 control in the program's place, are beside them."""
import pytest
import torch

from portbench import harness, program
from portbench.tests import small

SEED = 2**31 + 77
program.import_port()  # the tests patch the port's modules


def _run(name, control=False):
    cell, s = small.cell(name)
    return harness.run(cell, SEED, 0.3, False, "cpu", 0.0, sizes=s,
                       control=control)


def _half_batch(monkeypatch):
    """The trunk run on the first half of the batch rows, its outputs (the
    logits and a prefill's cache) repeated for the second half."""
    from repro_torch.models import transformer
    forward = transformer.forward

    def half(cfg, params, batch, **kw):
        h = batch["tokens"].shape[0] // 2
        out = forward(cfg, params, {"tokens": batch["tokens"][:h]}, **kw)
        logits = torch.cat([out[0]] * 2)
        if len(out) == 2:
            return logits, out[1]
        cache = {"blocks": tuple(torch.cat([t] * 2, dim=1)
                                 for t in out[2]["blocks"])}
        return logits, out[1], cache

    monkeypatch.setattr(transformer, "forward", half)


@pytest.fixture
def serve():
    from repro_torch.launch import serve
    return serve


@pytest.mark.parametrize("name", ["danube-prefill-7680", "mamba2-score-2048",
                                  "danube-prefill-1024"])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["check"]


@pytest.mark.parametrize("name", ["danube-prefill-7680", "mamba2-score-2048",
                                  "danube-prefill-1024"])
def test_control_is_not_correct(name):
    r = _run(name, control=True)
    assert not r["correct"], r["check"]


def test_prefill_state_unchanged(serve, monkeypatch):
    # the placed cache left as init_cache made it
    monkeypatch.setattr(serve, "_place", lambda slots, entry, axis: None)
    r = _run("danube-prefill-7680")
    assert not r["correct"] and r["check"]["kv"]["value"] > 0.9


def test_scan_state_unchanged(monkeypatch):
    # the SSD scan's state never leaves zero: the scan adds nothing
    from repro_torch.kernels import ssd_scan
    monkeypatch.setattr(ssd_scan, "ssd_scan_plain",
                        lambda x, dt, A, Bm, Cm, chunk: torch.zeros_like(
                            x, dtype=torch.float32))
    r = _run("mamba2-score-2048")
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name", ["danube-prefill-7680", "mamba2-score-2048",
                                  "danube-prefill-1024"])
def test_half_batch(monkeypatch, name):
    _half_batch(monkeypatch)
    r = _run(name)
    assert not r["correct"], r["check"]


def test_token_altered(serve, monkeypatch):
    generate = serve.generate

    def altered(*args, **kw):
        res = generate(*args, **kw)
        res["tokens"] = (res["tokens"] + 1) % 512
        return res

    monkeypatch.setattr(serve, "generate", altered)
    r = _run("danube-prefill-7680")
    assert not r["correct"] and r["check"]["token_gap"]["value"] > 0.1


def test_score_answer_altered(monkeypatch):
    from repro_torch.models import transformer
    forward = transformer.forward

    def altered(cfg, params, batch, **kw):
        logits, aux = forward(cfg, params, batch, **kw)
        logits[:, 5] = logits[:, 6]  # one position's answer replaced
        return logits, aux

    monkeypatch.setattr(transformer, "forward", altered)
    r = _run("mamba2-score-2048")
    assert not r["correct"], r["check"]


def test_no_decode_cache_fails_by_name(serve, monkeypatch):
    # a generate that makes no decode cache through init_cache: the run
    # stops at its first request with the error named, and prints nothing
    def no_cache(model, params, prompts, gen, **kw):
        logits, _ = model.forward(params, {"tokens": prompts},
                                  last_only=True)
        return {"tokens": logits[:, -1:, :512].argmax(-1),
                "logits": logits[:, -1:]}

    monkeypatch.setattr(serve, "generate", no_cache)
    with pytest.raises(RuntimeError, match="no decode cache") as err:
        _run("danube-prefill-7680")
    assert type(err.value).__name__ == "CacheNotSeen"
