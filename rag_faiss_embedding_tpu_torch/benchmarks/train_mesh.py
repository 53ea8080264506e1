"""Time the contrastive training step on one card and over meshes.

MiniLM-L6 at full width with the vocabulary ``chip_smoke.py``'s ``train``
phase trains on its documents, batch 32 x 128 tokens from
``cli.train.batch_iterator`` (that phase's shape), lr 2e-5, from one
parameter tree. Setups: one card; {"data": 2, "model": 2} over four
positions of card 0 (chip_smoke's mesh); with four or more cards, one
position per card on {"data": 2, "model": 2}, {"data": 4, "model": 1} and
{"data": 1, "model": 4}. Each setup takes three untimed steps, then
``--steps`` timed steps in two turns (the setups in order, then in
reverse). A step is timed by the host clock from its call to the end of a
synchronisation of every card: a mesh over several cards runs on several
streams, so one card's CUDA events do not bound it. Prints one JSON object:
the median and every step's ms per setup, each setup's loss after the
untimed steps, and the card's name and power limit as ``nvidia-smi`` gives
them.

Run from the repository root, with one or more CUDA cards visible:

    python3 rag_faiss_embedding_tpu_torch/benchmarks/train_mesh.py [--steps 10]
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10, help="timed steps per setup")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_mesh: no CUDA device; this runs on a GPU")
    import chip_smoke as C
    from rag_faiss_embedding_tpu_torch.cli import train as cli_train
    from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
    from rag_faiss_embedding_tpu_torch.models.convert import deterministic_params
    from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig
    from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer
    from rag_faiss_embedding_tpu_torch.parallel import train as T

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    docs = C.corpus_documents(C.N_DOCS, C.SEED)
    pairs = cli_train.make_pairs(docs, np.random.default_rng(C.SEED))
    tok = WordPieceTokenizer.train([p[0] for p in pairs] + [p[1] for p in pairs],
                                   vocab_size=C.TRAIN_VOCAB)
    cfg = MiniLMConfig(vocab_size=tok.vocab_size)
    batches = list(itertools.islice(
        cli_train.batch_iterator(pairs, tok, C.TRAIN_BATCH, C.TRAIN_LEN, C.SEED), 4))
    params = deterministic_params(cfg)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    setups = {"one_card": {"device": cards[0]},
              "2x2_on_card_0": {"mesh": make_mesh({"data": 2, "model": 2},
                                                  devices=[cards[0]] * 4)}}
    if len(cards) >= 4:
        for shape in ({"data": 2, "model": 2}, {"data": 4, "model": 1},
                      {"data": 1, "model": 4}):
            label = f"{shape['data']}x{shape['model']}_card_per_position"
            setups[label] = {"mesh": make_mesh(shape, devices=cards[:4])}
    states, out = {}, {"nvidia_smi": smi, "cards": len(cards), "vocab": cfg.vocab_size,
                       "batch": C.TRAIN_BATCH, "max_len": C.TRAIN_LEN, "loss_after_3": {}}
    for label, where in setups.items():
        run, state = T.make_train_step(cfg, learning_rate=C.TRAIN_LR, params=params, **where)
        for b in batches[:3]:
            state, m = run(state, b)
        out["loss_after_3"][label] = float(m["loss"])
        states[label] = [run, state]
    sync()
    ms = {label: [] for label in setups}
    half = args.steps // 2
    for label in list(setups) + list(setups)[::-1]:
        run, state = states[label]
        for i in range(half):
            t0 = time.perf_counter()
            state, _ = run(state, batches[i % len(batches)])
            sync()
            ms[label].append((time.perf_counter() - t0) * 1e3)
        states[label][1] = state
    out["ms_per_step_median"] = {k: statistics.median(v) for k, v in ms.items()}
    out["ms_per_step"] = ms
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
