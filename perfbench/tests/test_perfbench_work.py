"""The yardstick's counts against sums by hand, and the shares they give."""

import time

import pytest
import torch

from perfbench import data, readers, work
from perfbench.reference.minilm import MiniLM

MODEL = {"vocab_size": 30522, "hidden_size": 384, "num_hidden_layers": 6,
         "num_attention_heads": 12, "intermediate_size": 1536, "max_position_embeddings": 512,
         "type_vocab_size": 2, "layer_norm_eps": 1e-12}


def test_flat_work_by_hand():
    w = work.flat_work(q=2, n=1000, d=384, k=10)
    assert w["flops"] == 2 * 2 * 1000 * 384
    assert w["bytes"] == 1000 * 384 * 4 + 1000 * 4 + 2 * 384 * 4 + 2 * 10 * 8
    t, by = work.bound(w["bytes"], w["flops"], "float32")
    assert by == "bytes" and t == pytest.approx(w["bytes"] / 3.35e12)


def test_ivf_work_by_hand():
    w = work.ivf_work(q=4, d=384, k=10, probed_rows=4 * 8 * 128, union_rows=20 * 128)
    assert w["flops"] == 2 * 4 * 8 * 128 * 384
    assert w["bytes"] == 20 * 128 * (384 * 2 + 8) + 4 * 384 * 2 + 4 * 10 * 8


def test_encoder_flops_by_hand():
    # per token and layer: q, k, v, o (4 x 384 x 384) and the FFN (2 x 384 x 1536)
    # multiply-adds, and attention's two products over the sequence
    dense = 2 * (4 * 384 * 384 + 2 * 384 * 1536)
    assert dense == 2 * 1769472
    assert work.encoder_flops([10, 3], MODEL) == 6 * (10 * (dense + 4 * 10 * 384)
                                                       + 3 * (dense + 4 * 3 * 384))


def test_mfu_of_a_plain_run_stays_under_the_peak():
    """The reference forward's own token counts, over the time it took on
    this host: the share of the card's peak is above 0 and below 100."""
    w = data.minilm_weights(MODEL, 1, "cpu")
    m = MiniLM(w, MODEL)
    seqs = [[2] + list(range(5, 5 + n)) + [3] for n in (20, 60, 120)]
    t = time.monotonic()
    m.embed_many(seqs)
    window = time.monotonic() - t
    ctx = {"encoder_lengths": [len(s) for s in seqs], "model": MODEL, "search_work": [],
           "config": {"encoder": {"dtype": "float32"}}, "device": {"busy_s": [window]},
           "window_s": window}
    assert 0 < readers.mfu(ctx) < 100


def test_mfu_counts_every_card_s_peak():
    """Four shards' scans on four cards: the same work over the same window
    reads a quarter of what it reads on one card."""
    w = work.flat_work(1, 2_621_440, 384, 10)
    one = {"encoder_lengths": [], "model": MODEL, "search_work": [[("k1", w)] * 4] * 1000,
           "config": {"encoder": {"dtype": "float32"}}, "device": {"busy_s": [1.0]},
           "window_s": 4.0}
    four = dict(one, device={"busy_s": [1.0] * 4})
    assert readers.mfu(four) == pytest.approx(readers.mfu(one) / 4, rel=1e-12)
    assert 0 < readers.mfu(four) < 100


def test_kernel_share_is_bound_over_device_time():
    w = work.flat_work(1, 1 << 20, 384, 10)
    least = work.work_bound(w)
    ns = int(least * 2e9)  # the kernel took twice its bound
    ctx = {"search_work": [[("k1", w)]],
           "device": {"events": [("void scan_partial<float>", 0, 0, ns // 2),
                                 ("merge_partials", 0, ns // 2, ns), ("other", 0, 0, 10**9)]}}
    assert readers.kernel_share(ctx, "k1") == pytest.approx(50.0, rel=1e-6)
    assert readers.kernel_share({"search_work": [], "device": ctx["device"]}, "k1") is None


def test_weights_are_the_seed_s():
    a = data.minilm_weights(MODEL, 5, "cpu")
    b = data.minilm_weights(MODEL, 5, "cpu")
    c = data.minilm_weights(MODEL, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["0.q.w"], c["0.q.w"])
    assert a["0.ff1.w"].shape == (1536, 384)
    assert abs(a["0.ff2.w"].std().item() - 1536 ** -0.5) < 1e-3
