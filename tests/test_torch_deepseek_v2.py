"""The port's DeepSeek-V2 generator (``models/deepseek_v2.py``) against the
plain float32 reference (``perfbench/reference/deepseek_v2.py``) on the CPU, at a
small size with DeepSeek-V2-Lite's mechanisms: one dense and two MoE
layers, 8 routed experts of which 2 a token, 2 shared, latent rank 32,
rope 16, YaRN as published; and its place behind ``Config``,
``QueryEngine.generate_response`` and ``POST /search``.

Tolerances: float32 against float32 differs only in the order of sums
(the absorbed decode, the grouped experts, the fused norm), so 1e-5 of a
logit vector's norm; bf16 against float32 is the configuration's own
rounding (bf16 activations into every product through three layers),
measured at 0.5-1% here, held to 3%.
"""

import asyncio
import http.client
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import deepseek_v2 as R
from rag_faiss_embedding_tpu_torch.core import Config
from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig
from rag_faiss_embedding_tpu_torch.models import deepseek_v2 as D
from rag_faiss_embedding_tpu_torch.models.convert import deterministic_params
from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_faiss_embedding_tpu_torch.rag import QueryEngine
from rag_faiss_embedding_tpu_torch.serve.api import build_generator, make_app
from rag_faiss_embedding_tpu_torch.index import VectorStore
from rag_faiss_embedding_tpu_torch.store.database import Database

REPO = Path(__file__).resolve().parents[1]
LITE = json.loads((REPO / "perfbench/configs/deepseek-v2-lite.rag-flat-bf16.json").read_text())
HF = {**{k: LITE[k] for k in ("rope_theta", "rope_scaling", "rms_norm_eps", "norm_topk_prob",
                               "routed_scaling_factor", "max_position_embeddings",
                               "first_k_dense_replace", "moe_layer_freq", "q_lora_rank")},
      "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
      "moe_intermediate_size": 32, "num_hidden_layers": 3, "num_attention_heads": 4,
      "n_routed_experts": 8, "n_shared_experts": 2, "num_experts_per_tok": 2,
      "kv_lora_rank": 32, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32}
WORDS = ["vector", "search", "tensor", "cores", "shard", "merge", "query", "index",
         "latent", "expert", "cache", "token", "encoder", "answer", "card", "host"]


def _model(dtype="float32", seed=3):
    m = D.DeepseekV2(D.DeepseekV2Config.from_hf({**HF, "torch_dtype": dtype}), "cpu")
    m.load_state_dict(R.random_weights(HF, seed, "cpu"))
    return m


def _ids(n, seed=0):
    return torch.randint(0, HF["vocab_size"], (n,), generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()


def _generate(m, ids, steps):
    """Prefill, then ``steps`` greedy decode steps: (tokens, logits)."""
    m.reserve(len(ids) + steps)
    logits = [m.prefill(ids)]
    tokens = [int(logits[-1].argmax())]
    for pos in range(len(ids), len(ids) + steps):
        logits.append(m.decode(torch.tensor(tokens[-1]), pos))
        tokens.append(int(logits[-1].argmax()))
    return tokens, torch.stack(logits)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_prefill_logits_match_the_reference(dtype, tol):
    m = _model(dtype)
    ids = _ids(37)
    got = m.prefill(ids)
    want = R.DeepseekV2Reference(m.state_dict(), HF).logits(ids.tolist())[0]
    assert got.shape == (HF["vocab_size"],) and got.dtype == torch.float32
    assert _rel(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_decode_through_the_latent_cache_matches_the_full_forward(dtype, tol):
    m = _model(dtype)
    ids = _ids(29, seed=1)
    m.prefill(_ids(40, seed=2))  # a former, longer call leaves rows behind
    tokens, got = _generate(m, ids, 6)
    want = R.DeepseekV2Reference(m.state_dict(), HF).logits(ids.tolist() + tokens[:-1], last=7)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("n", [1, 9])
def test_moe_layer_matches_a_per_token_loop(n):
    """Grouped by expert (a prefill's rows, or a decode step's one) against
    each token's top-2 experts and the shared ones, one token at a time."""
    m = _model()
    x = torch.randn(n, HF["hidden_size"], generator=torch.Generator().manual_seed(4))
    sd, p = m.state_dict(), "model.layers.1.mlp."
    got = m._moe(1, x, count=n > 1)
    # a prefill's (token, choice) pairs are counted by expert, a decode step's not
    assert sum(m.expert_tokens) == (n * HF["num_experts_per_tok"] if n > 1 else 0)

    def mlp(v, prefix):
        g, u = v @ sd[prefix + "gate_proj.weight"].t(), v @ sd[prefix + "up_proj.weight"].t()
        return (torch.nn.functional.silu(g) * u) @ sd[prefix + "down_proj.weight"].t()

    want = []
    for t in range(n):
        scores = torch.softmax(x[t] @ sd[p + "gate.weight"].t(), -1)
        w, e = torch.topk(scores, HF["num_experts_per_tok"])
        y = mlp(x[t], p + "shared_experts.")
        for wj, ej in zip(w, e):
            y = y + wj * mlp(x[t], f"{p}experts.{int(ej)}.")
        want.append(y)
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-5, atol=1e-6)


def test_prefill_counts_the_tokens_each_expert_got():
    m = _model()
    m.reserve(24)
    m.prefill(_ids(23))
    counts = m.expert_tokens
    assert len(counts) == HF["n_routed_experts"]
    assert sum(counts) == 23 * HF["num_experts_per_tok"] * 2  # two MoE layers
    m.decode(torch.tensor(5), 23)
    assert m.expert_tokens == counts  # a decode step does not count


def test_yarn_factors_and_softmax_scale():
    cfg = D.DeepseekV2Config()  # DeepSeek-V2-Lite's
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert D.yarn_mscale(40, 0.707) == pytest.approx(m, rel=1e-12)
    inv = D.yarn_inv_freq(cfg)
    assert inv[0] == 1.0  # the fastest pair keeps the base's frequency
    assert inv[-1].item() == pytest.approx(10000 ** (-62 / 64) / 40, rel=1e-6)  # interpolated
    assert torch.all(inv[1:] < inv[:-1])
    f = D.rope_factors(cfg, 5000, "cpu")
    cos, sin = R.yarn_cos_sin(LITE, 5000, "cpu")
    torch.testing.assert_close(f.real, cos[:, :32], rtol=0, atol=2e-6)
    torch.testing.assert_close(f.imag, sin[:, :32], rtol=0, atol=2e-6)
    # interleaved pairs rotated as modeling_deepseek rotates its halves
    x = torch.randn(5000, 64, generator=torch.Generator().manual_seed(5))
    half = R.apply_rotary(x, cos, sin)
    inter = D.apply_rope(x, f)
    torch.testing.assert_close(inter[:, 0::2], half[:, :32], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inter[:, 1::2], half[:, 32:], rtol=1e-5, atol=1e-5)


def test_cache_holds_576_values_a_token_a_layer():
    lite = D.DeepseekV2Config()
    assert lite.cache_width == 576
    assert lite.num_hidden_layers * lite.cache_width * 2 == 31104  # bytes a token, bf16
    heads = lite.num_attention_heads * (lite.qk_head_dim + lite.v_head_dim)
    assert heads / lite.cache_width == pytest.approx(8.9, abs=0.05)  # keys + values instead
    m = _model()
    ids = _ids(21)
    m.prefill(ids)
    assert m.cache.shape[0::2] == (3, 32 + 16)
    # a latent row is the normalised c_kv: each layer's rows over its scale have RMS 1
    scales = torch.stack([layer.kv_norm for layer in m.layers])[:, None]
    rms = (m.cache[:, :21, :32] / scales).pow(2).mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones_like(rms), rtol=1e-4, atol=1e-4)


def test_state_dict_round_trips_under_the_checkpoint_names():
    m = _model("bfloat16")
    sd = m.state_dict()
    assert set(sd) == set(R.weight_shapes(HF))
    assert "model.layers.2.mlp.experts.7.gate_proj.weight" in sd
    again = D.DeepseekV2(m.cfg, "cpu")
    again.load_state_dict(sd)
    ids = _ids(11)
    assert torch.equal(again.prefill(ids), m.prefill(ids))
    with pytest.raises(KeyError):
        again.load_state_dict({k: v for k, v in sd.items() if "experts.3." not in k})


# ------------------------------------------------ behind Config and the server
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _model_folder(folder, hf):
    """A generator folder: the model's config.json and its vocab.txt (the
    test embedder's words)."""
    folder.mkdir(exist_ok=True)
    (folder / "config.json").write_text(json.dumps(hf))
    (folder / "vocab.txt").write_text("\n".join(SPECIALS + WORDS) + "\n")
    return folder


def _embedder():
    vocab = {t: i for i, t in enumerate(SPECIALS + WORDS)}
    small = MiniLMConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                         intermediate_size=32, max_position_embeddings=128)
    return EmbeddingPipeline(model_name="offline-test", cfg=small,
                             params=deterministic_params(small, seed=1),
                             tokenizer=WordPieceTokenizer(vocab), max_seq_length=128,
                             device="cpu")


def _native_engine(tmp_path, answer=5):
    folder = _model_folder(tmp_path / "generator", {**HF, "torch_dtype": "float32"})
    cfg = Config(base_dir=tmp_path, generator_backend="native", generator_model=str(folder),
                 generation_max_length=answer, context_token_budget=48,
                 serve_watchdog_interval_s=0)
    emb = _embedder()
    db = Database(tmp_path / "docs.db")
    rng = np.random.default_rng(0)
    docs = [{"url": f"https://t.example/{i}", "title": f"t{i}",
             "content": " ".join(rng.choice(WORDS, size=30))} for i in range(6)]
    ids = db.insert_documents(docs)
    store = VectorStore(16, index_path=tmp_path / "idx", device="cpu")
    store.add_vectors(emb.generate_embeddings([d["content"] for d in docs]), ids)
    gen = build_generator(cfg, emb)
    gen.load_state_dict(R.random_weights(HF, 0, "cpu"))
    engine = QueryEngine(db, store, emb, generator=gen,
                         context_token_budget=cfg.context_token_budget)
    return engine, cfg


def test_config_names_the_native_backend_for_the_engine_and_the_server(tmp_path):
    engine, cfg = _native_engine(tmp_path)
    gen = engine.generator
    assert gen.backend == "native" and gen.native.model.cfg.dtype == "float32"
    assert gen.native.model.cfg.kv_lora_rank == 32
    docs = engine.search("latent cache expert", top_k=3)
    answer = engine.generate_response("latent cache expert", docs)
    assert len(gen.native.last_ids) == 5 and answer == gen.native.tokenizer.decode(
        gen.native.last_ids)
    assert answer == engine.generate_response("latent cache expert", docs)  # greedy
    assert AnswerGenerator.from_config(Config(base_dir=tmp_path)).native is None

    def post(port, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", "/search", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    async def main():
        app = make_app(engine, cfg)
        port = await asyncio.wait_for(app.start("127.0.0.1", 0), 60)
        try:
            return await asyncio.to_thread(post, port, {"text": "latent cache expert",
                                                        "top_k": 3, "generate": True})
        finally:
            await asyncio.wait_for(app.stop(), 60)

    status, body = asyncio.run(main())
    assert status == 200 and body["generated_response"] == answer


def test_native_generator_without_weights_raises(tmp_path):
    """No checkpoint given: the server's call fails loudly, and does not
    answer from weights nobody loaded. No vocab.txt: no generator."""
    (tmp_path / "config.json").write_text(json.dumps(HF))
    cfg = Config(base_dir=tmp_path, generator_backend="native", generator_model=str(tmp_path),
                 generation_max_length=3)
    with pytest.raises(ValueError, match="vocab.txt"):
        build_generator(cfg, _embedder())
    _model_folder(tmp_path, HF)
    gen = build_generator(cfg, _embedder())
    assert gen.native.model.cfg.dtype == "bfloat16"  # no torch_dtype: the published one
    with pytest.raises(RuntimeError, match="no weights"):
        gen.native.generate_ids([5, 6, 7])


def test_native_generation_loads_no_jax(tmp_path):
    script = (
        "import sys, pathlib\n"
        "sys.modules['transformers'] = None\nsys.modules['tokenizers'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from tests import test_torch_deepseek_v2 as t\n"
        "engine, _ = t._native_engine(pathlib.Path(sys.argv[1]), answer=3)\n"
        "print(engine.generate_response('cache', engine.search('cache', top_k=2)))\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'rag_faiss_embedding_tpu'})\n"
        "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
