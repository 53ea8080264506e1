"""Data- and tensor-parallel training on the card: a {"data": 2, "model": 2}
mesh over four positions of one card, and over several cards with one
position on each (2 cards: {"data": 1, "model": 2}; 4 or more: 2 x 2).
Each slice lies on its position's card with its AdamW moments, and one step
from the same parameters and batch is held to the one-card step on the
first card: the loss within 1e-4 relative, each gradient (read back from
AdamW's first moment) within 1e-4 of its tensor's largest entry or of 1e-2
x the model's largest, every weight within lr / 100 but where a gradient is
below 1e-6 (the attention key biases' whole gradient is rounding): there
within 1.01 x lr of its start, Adam's bound. A checkpoint saved from the
mesh restores on one card bit for bit.

Every test here needs an NVIDIA GPU and skips without one (the several-card
test below two cards); none imports JAX, so on the card they run with
``python -m pytest tests/test_torch_train_card.py -m cuda --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
from rag_faiss_embedding_tpu_torch.models.convert import deterministic_params, load_flax_params
from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig
from rag_faiss_embedding_tpu_torch.parallel import train as T
from rag_faiss_embedding_tpu_torch.parallel.checkpoint import TrainCheckpointer

CFG = MiniLMConfig(vocab_size=2048, num_layers=2)  # full width: 384, 12 heads, FFN 1,536
LR, GRAD_FLOOR = 2e-5, 1e-6
B, L = 16, 64


def batch(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "d"):
        ids = rng.integers(5, CFG.vocab_size, size=(B, L))
        mask = np.arange(L)[None] < rng.integers(8, L + 1, size=(B, 1))
        out[f"{side}_ids"] = torch.from_numpy(ids * mask)
        out[f"{side}_mask"] = torch.from_numpy(mask.astype(np.int64))
    return out


@pytest.fixture(params=["one-card", "several-cards"])
def mesh(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = torch.cuda.device_count()
    if request.param == "one-card":
        return make_mesh({"data": 2, "model": 2}, devices=[torch.device("cuda", 0)] * 4)
    if n < 2:
        pytest.skip("needs two or more cards")
    shape = {"data": 2, "model": 2} if n >= 4 else {"data": 1, "model": 2}
    return make_mesh(shape, devices=[torch.device("cuda", i) for i in range(min(n, 4))])


def host_state(state):
    """(weights, first moments) in the one-card layout, copied to the host."""
    w = {k: v.detach().to("cpu", copy=True) for k, v in state.params.state_dict().items()}
    opt = state.opt_state.state_dict()["state"]
    return w, {k: opt[i]["exp_avg"].to("cpu", copy=True) for i, k in enumerate(w)}


@pytest.mark.cuda
def test_mesh_step_on_the_card_equals_the_one_card_step(mesh, tmp_path):
    params = deterministic_params(CFG, seed=1)
    start = load_flax_params(params)
    run, state = T.make_train_step(CFG, mesh, learning_rate=LR, params=params)
    enc = state.params
    assert isinstance(enc, T.MeshEncoder)
    model = mesh.shape["model"]
    for name in ("embeddings.word_embeddings.weight", "layers.1.attention.value.weight",
                 "layers.0.ffn_output.weight"):
        slices = enc.slices(name)
        assert len(slices) == model
        for m, p in enumerate(slices):
            assert p.device == enc.grid[0, m] and p.is_cuda
    run1, one = T.make_train_step(CFG, learning_rate=LR, params=params,
                                  device=torch.device("cuda", 0))
    b = batch()
    state, m_mesh = run(state, b)
    one, m_one = run1(one, b)
    for p in enc.parameters():
        assert state.opt_state.state[p]["exp_avg"].device == p.device
    l_mesh, l_one = float(m_mesh["loss"]), float(m_one["loss"])
    assert abs(l_mesh - l_one) <= 1e-4 * abs(l_one)
    (w_mesh, g_mesh), (w_one, g_one) = host_state(state), host_state(one)
    g_model = max(float(g.abs().max()) for g in g_one.values()) / 0.1
    for name in w_one:
        ga, gb = g_one[name] / 0.1, g_mesh[name] / 0.1
        scale = max(float(ga.abs().max()), 1e-2 * g_model)
        assert float((ga - gb).abs().max()) <= 1e-4 * scale, name
        noise = torch.minimum(ga.abs(), gb.abs()) < GRAD_FLOOR
        if (~noise).any():
            assert float((w_mesh[name] - w_one[name]).abs()[~noise].max()) <= LR / 100, name
        for w in (w_mesh[name], w_one[name]):
            if noise.any():
                assert float((w - start[name]).abs()[noise].max()) <= 1.01 * LR, name
    ckpt = TrainCheckpointer(tmp_path)
    ckpt.save(state)
    _, fresh = T.make_train_step(CFG, learning_rate=LR, device=torch.device("cuda", 0))
    restored = host_state(ckpt.restore(fresh))
    for a, c in zip(host_state(state), restored):
        assert all(torch.equal(a[k], c[k]) for k in a)
