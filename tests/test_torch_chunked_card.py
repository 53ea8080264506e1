"""The out-of-memory IVF build and the trainer on the card.

A chunked-built IVF-PQ index and a chunked-built bf16 index on the card are
held to the same builds on the CPU (training pinned to the CPU build's
centroids and codebooks): the same slots, the same ids and window, codes
equal but at near-tie codewords, searches that agree, and the kernel routes
(K4's decode, K2's union scan) launched and equal to the plain ones on the
card. One training step on the card is held to the same step on the CPU.

Every test here needs an NVIDIA GPU and skips without one; none imports JAX,
so on the card they run with
``python -m pytest tests/test_torch_chunked_card.py -m cuda --noconftest -q``.
Tolerance, card vs CPU: distances to rtol 1e-4 / atol 1e-4 x (max ||q||^2 +
max ||x||^2) (float32 sums in different orders), ids equal but where the
distances agree; a training step's loss to rtol 1e-5, each gradient (read
from AdamW's first moment) to 1e-4 of its tensor's largest entry (at least
1e-2 of the model's largest: a tensor whose exact gradient is zero holds
the rounding of terms that cancel), every
weight to lr / 100 but where a gradient is below GRAD_FLOOR on either
device: Adam's first step is lr x g / (|g| + eps), so there rounding in g
(the attention key biases' whole gradient, whose exact value is zero)
moves the weight by up to lr; those are held to 1.01 x lr of their start.
"""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.index import IVFFlatIndex
from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig
from rag_faiss_embedding_tpu_torch.ops import pq_decode as PD
from rag_faiss_embedding_tpu_torch.ops import union_scan as U
from rag_faiss_embedding_tpu_torch.parallel import make_train_step

RTOL = 1e-4
D = 128
GRAD_FLOOR = 1e-6  # 100 x AdamW's eps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _data(seed=0, n_modes=64, per=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_modes, D)).astype(np.float32)
    pts = (centers[rng.integers(0, n_modes, n_modes * per)]
           + 0.4 * rng.standard_normal((n_modes * per, D))).astype(np.float32)
    q = (pts[::37] + 0.2 * rng.standard_normal((len(pts[::37]), D))).astype(np.float32)
    return pts, q


def _agree(card, cpu, q, rows):
    cv, ci = (t.cpu().numpy() for t in card)
    pv, pi = (t.cpu().numpy() for t in cpu)
    atol = RTOL * float((q.astype(np.float64) ** 2).sum(1).max()
                        + (rows.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(cv, pv, rtol=RTOL, atol=atol)
    diff = ci != pi
    assert np.allclose(cv[diff], pv[diff], rtol=RTOL, atol=atol)


def _pair(cuda, **kw):
    """The same chunked build on the CPU and, pinned to its training, on
    the card."""
    pts, q = _data()
    src = lambda s, z: pts[s:s + z]
    cpu = IVFFlatIndex(D, nlist=32, nprobe=8, train_iters=5, device="cpu", **kw)
    cpu.build_chunked(src, n=len(pts), chunk_size=1000)
    card = IVFFlatIndex(D, nlist=32, nprobe=8, device=cuda, **kw)
    card.centroids, card.is_trained = cpu.centroids.to(cuda), True
    if cpu.pq_codebooks is not None:
        card.pq_codebooks = cpu.pq_codebooks.to(cuda)
    card.build_chunked(src, n=len(pts), chunk_size=1000)
    assert card._window == cpu._window and card._n_spill == cpu._n_spill
    assert torch.equal(card._sorted_ids.cpu(), cpu._sorted_ids)
    return cpu, card, pts, q


@pytest.mark.cuda
@pytest.mark.parametrize("rerank", [False, True])
def test_chunked_ivfpq_on_card_matches_cpu(cuda, rerank):
    cpu, card, pts, q = _pair(cuda, pq_m=16, rerank=rerank, refine_dtype="bfloat16")
    differ = (card._sorted_vecs.cpu() != cpu._sorted_vecs).sum().item()
    assert differ <= 1e-3 * cpu._sorted_vecs.numel()  # near-tie codewords only
    PD.decode.launches = 0
    out = card.search(q, 10)
    assert PD.decode.launches > 0
    card.backend = "xla"
    plain = card.search(q, 10)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    _agree(out, cpu.search(q, 10), q, pts)


@pytest.mark.cuda
def test_chunked_bf16_on_card_matches_cpu(cuda):
    cpu, card, pts, q = _pair(cuda, dtype="bfloat16")
    assert torch.equal(card._sorted_vecs.cpu(), cpu._sorted_vecs)
    U.union_scan.launches = 0
    out = card.search(q, 10)
    assert U.union_scan.launches > 0
    _agree(out, cpu.search(q, 10), q, pts)
    card.backend = "xla"
    _agree(card.search(q, 10), cpu.search(q, 10), q, pts)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    cfg = MiniLMConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                       intermediate_size=64, max_position_embeddings=32)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, size=(4, 8, 16)).astype(np.int32)
    batch = {"q_ids": ids[0], "q_mask": np.ones_like(ids[0]),
             "d_ids": ids[1], "d_mask": (ids[2] > 20).astype(np.int32)}
    lr = 1e-3
    out = []
    for dev in ("cpu", cuda):
        run, state = make_train_step(cfg, learning_rate=lr, device=dev)
        start = {k: p.detach().cpu().clone() for k, p in state.params.named_parameters()}
        state, m = run(state, batch)
        opt = state.opt_state.state
        out.append((float(m["loss"]),
                    {k: p.detach().cpu() for k, p in state.params.named_parameters()},
                    {k: (opt[p]["exp_avg"] / 0.1).cpu()  # 0.1 x g after one step
                     for k, p in state.params.named_parameters()}))
    (l_cpu, w_cpu, g_cpu), (l_card, w_card, g_card) = out
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    g_model = max(g.abs().max().item() for g in g_cpu.values())
    for name, w in w_cpu.items():
        scale = max(g_cpu[name].abs().max().item(), 1e-2 * g_model)
        assert (g_card[name] - g_cpu[name]).abs().max().item() <= 1e-4 * scale, name
        noise = torch.minimum(g_card[name].abs(), g_cpu[name].abs()) < GRAD_FLOOR
        if not noise.all():
            assert (w_card[name] - w).abs()[~noise].max().item() <= lr / 100, name
        for mine in (w, w_card[name]):
            if noise.any():
                assert (mine - start[name]).abs()[noise].max().item() <= 1.01 * lr, name
