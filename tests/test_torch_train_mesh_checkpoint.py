"""Training checkpoints across meshes, and ``cli.train``'s mesh, in the port.

A step saved on {"data": 2, "model": 4} restores onto {"data": 1,
"model": 2}, onto the same mesh and onto one card, and a one-card step onto
a mesh: the restored weights and AdamW state are the saved ones bit for
bit, and the next step equals the one taken without a stop (loss to 1e-5
relative, weights to 1e-5 but the attention key biases, held to Adam's
bound, as tests/test_torch_train.py holds them). ``cli.train`` builds JAX's
mesh over 1, 2, 4 and 8 devices (``cli/train.py:115-118`` there), logs it,
trains to the one-device run's losses (1e-5 relative) and exports the
gathered parameters. Meshes
are grids of repeated ``cpu`` devices; the WordPiece trainer is stubbed, as
in tests/test_torch_train_cli.py.
"""

import logging

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer as JTok
from rag_faiss_embedding_tpu_torch.cli import train as tcli
from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
from rag_faiss_embedding_tpu_torch.models.convert import deterministic_params, to_flax_params
from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok
from rag_faiss_embedding_tpu_torch.parallel import train as ttrain
from rag_faiss_embedding_tpu_torch.parallel.checkpoint import TrainCheckpointer

from .test_torch_train import (LR, TSMALL, assert_metrics_close, assert_params_close,
                               fake_batch)
from .test_torch_train_cli import TINY, corpus

CPU = torch.device("cpu")


def cpu_mesh(shape):
    return make_mesh(shape, devices=[CPU] * int(np.prod(list(shape.values()))))


def template(target):
    """(run_step, a fresh state) on a mesh shape, or one card for None."""
    mesh = cpu_mesh(target) if target is not None else None
    return ttrain.make_train_step(TSMALL, mesh, learning_rate=LR, device=CPU)


def assert_same_state(a, b):
    """Two states' gathered weights and AdamW state equal bit for bit."""
    pa, pb = a.params.state_dict(), b.params.state_dict()
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k].cpu(), pb[k].cpu()), k
    oa, ob = a.opt_state.state_dict(), b.opt_state.state_dict()
    assert oa["param_groups"] == ob["param_groups"] and oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k].cpu(), ob["state"][i][k].cpu()), (i, k)


def saved_and_on(tmp_path, source, start):
    """Two steps on ``source`` saved, then a third from memory: (the
    checkpoint, the saved state's copy in a fresh template, the third
    step's metrics and state)."""
    run, state = ttrain.make_train_step(
        TSMALL, cpu_mesh(source) if source else None, learning_rate=LR, params=start,
        device=CPU)
    for s in (0, 1):
        state, _ = run(state, fake_batch(seed=20 + s))
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    assert ckpt.save(state) == 2
    _, copy = template(source)
    copy = ckpt.restore(copy)
    state, m = run(state, fake_batch(seed=22))
    return ckpt, copy, m, state


@pytest.mark.parametrize("target", [{"data": 1, "model": 2}, None, {"data": 2, "model": 4}],
                         ids=["1x2", "one-card", "2x4"])
def test_step_saved_on_2x4_restores_and_continues(tmp_path, target):
    start = deterministic_params(TSMALL, seed=11)
    ckpt, saved, m_on, on = saved_and_on(tmp_path, {"data": 2, "model": 4}, start)
    run, fresh = template(target)
    restored = ckpt.restore(fresh)
    assert restored.step == 2
    assert isinstance(restored.params, ttrain.MeshEncoder if target else torch.nn.Module)
    assert_same_state(restored, saved)
    restored, m = run(restored, fake_batch(seed=22))
    assert restored.step == on.step == 3
    assert_metrics_close([(float(m["loss"]), float(m["accuracy"]))],
                         [(float(m_on["loss"]), float(m_on["accuracy"]))])
    assert_params_close(restored, to_flax_params(on.params.state_dict(), TSMALL), start, 3)


def test_one_card_step_restores_onto_a_mesh(tmp_path):
    start = deterministic_params(TSMALL, seed=12)
    ckpt, saved, m_on, on = saved_and_on(tmp_path, None, start)
    run, fresh = template({"data": 2, "model": 4})
    restored = ckpt.restore(fresh)
    assert_same_state(restored, saved)
    # every slice lies on its mesh position's device, its moments beside it
    enc = restored.params
    for p in enc.parameters():
        assert restored.opt_state.state[p]["exp_avg"].device == p.device
    restored, m = run(restored, fake_batch(seed=22))
    assert_metrics_close([(float(m["loss"]), float(m["accuracy"]))],
                         [(float(m_on["loss"]), float(m_on["accuracy"]))])
    assert_params_close(restored, to_flax_params(on.params.state_dict(), TSMALL), start, 3)


def test_restored_state_is_not_shared_with_the_loaded_dict():
    """A restore copies: stepping the restored state leaves the dict it was
    loaded from (and every other slice's step count) as it was."""
    run, state = template({"data": 1, "model": 2})
    state, _ = run(state, fake_batch())
    opt_sd, params_sd = state.opt_state.state_dict(), state.params.state_dict()
    before = {i: {k: v.clone() for k, v in per.items()} for i, per in opt_sd["state"].items()}
    weights = {k: v.clone() for k, v in params_sd.items()}
    _, other = template({"data": 1, "model": 2})
    other.params.load_state_dict(params_sd)
    other.opt_state.load_state_dict(opt_sd)
    other, _ = run(other, fake_batch(seed=1))
    for i, per in opt_sd["state"].items():
        for k in per:
            assert torch.equal(per[k], before[i][k]), (i, k)
    for k in weights:
        assert torch.equal(params_sd[k], weights[k]), k
    steps = {float(s["step"]) for s in other.opt_state.state.values()}
    assert steps == {2.0}


@pytest.fixture
def stub_vocab(monkeypatch):
    vocab = dict(JTok.train([d["content"] for d in corpus()], vocab_size=512).vocab)
    monkeypatch.setattr(TTok, "train", classmethod(lambda c, texts, **kw: c(dict(vocab))))


def recorded_train(monkeypatch, device):
    """``cli.train.train`` (TINY, 2 steps, batch 8) on ``device``: (the
    exported params, the meshes it asked for, its losses, its last state,
    its log messages)."""
    rec = {"meshes": [], "loss": [], "state": None}
    make = ttrain.make_train_step

    def recording(cfg, mesh=None, **kw):
        rec["meshes"].append(mesh)
        run, state = make(cfg, mesh, **kw)

        def run_recorded(state, batch):
            state, m = run(state, batch)
            rec["loss"].append(float(m["loss"]))
            rec["state"] = state
            return state, m

        return run_recorded, state

    monkeypatch.setattr(ttrain, "make_train_step", recording)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("rag_faiss_embedding_tpu_torch.cli.train")
    logger.addHandler(handler)
    try:
        params, _ = tcli.train(corpus(), cfg=TINY, steps=2, batch_size=8, max_len=32,
                               learning_rate=1e-3, device=device)
    finally:
        logger.removeHandler(handler)
        monkeypatch.setattr(ttrain, "make_train_step", make)
    return params, rec, [r.getMessage() for r in records]


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(flat_tree(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.fixture
def one_device_losses(stub_vocab, monkeypatch):
    return recorded_train(monkeypatch, CPU)[1]["loss"]


@pytest.mark.parametrize("n,shape", [(1, {"data": 1, "model": 1}), (2, {"data": 2, "model": 1}),
                                     (4, {"data": 2, "model": 2}), (8, {"data": 2, "model": 4})])
def test_cli_train_builds_jax_mesh(n, shape, stub_vocab, one_device_losses, monkeypatch):
    params, rec, messages = recorded_train(monkeypatch, [CPU] * n)
    assert [m.shape for m in rec["meshes"]] == [shape]
    assert f"mesh: {shape}" in messages
    assert isinstance(rec["state"].params, ttrain.MeshEncoder if n > 1 else torch.nn.Module)
    np.testing.assert_allclose(rec["loss"], one_device_losses, rtol=1e-5, atol=0)
    # the export is the gathered tree
    mine = flat_tree(params)
    gathered = flat_tree(to_flax_params(rec["state"].params.state_dict(), TINY))
    assert mine.keys() == gathered.keys()
    for k in mine:
        assert isinstance(mine[k], np.ndarray)
        np.testing.assert_array_equal(mine[k], gathered[k], err_msg=k)


def test_cli_train_without_a_card_raises_where_none_is_visible(stub_vocab):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default mesh is every card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.train(corpus(), cfg=TINY, steps=1, batch_size=8, max_len=32)
