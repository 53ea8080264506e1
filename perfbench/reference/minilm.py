"""Plain MiniLM / BERT encoder forward (the reference's, written fresh).

The published BERT post-LayerNorm encoder (``BertModel`` as
all-MiniLM-L6-v2's ``config.json`` sets it: absolute positions, token type
0, exact erf GELU, LayerNorm eps 1e-12), float32, one sequence at a time at
its own length, so no padding and no mask enter it. Pooling: the [CLS]
row of the last layer (the system's ``pooling="cls"``).

``precision="tf32"`` runs every product with TF32 inputs: the control. On a
card it turns on TF32 for the call; on the CPU, which has no TF32 unit, it
rounds each product's inputs to TF32's 10-bit mantissa, as the card's
tensor cores do.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000 - 1 + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def precision_of(precision: str, device):
    """Products in float32 ("float32", TF32 off) or TF32 ("tf32")."""
    cuda = torch.backends.cuda.matmul
    saved = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
    cuda.allow_tf32 = torch.backends.cudnn.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def matmul(a, b, precision: str):
    """``a @ b`` in ``precision``; on the CPU TF32 is emulated."""
    if precision == "tf32" and a.device.type == "cpu":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


class MiniLM:
    def __init__(self, weights: dict, cfg: dict, precision: str = "float32"):
        self.w, self.cfg, self.precision = weights, cfg, precision
        self.heads = cfg["num_attention_heads"]
        self.eps = cfg["layer_norm_eps"]

    def _lin(self, x, name):
        return matmul(x, self.w[name + ".w"].t(), self.precision) + self.w[name + ".b"]

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".w"], self.w[name + ".b"], self.eps)

    @torch.no_grad()
    def embed(self, ids: list) -> torch.Tensor:
        """The pooled (hidden,) embedding of one token sequence."""
        w = self.w
        dev = w["word"].device
        with precision_of(self.precision, dev):
            t = torch.as_tensor(ids, device=dev)
            x = w["word"][t] + w["position"][: len(ids)] + w["token_type"][0]
            x = self._ln(x, "emb_ln")
            n, h = x.shape
            hd = h // self.heads
            for i in range(self.cfg["num_hidden_layers"]):
                q, k, v = (self._lin(x, f"{i}.{m}").view(n, self.heads, hd).transpose(0, 1)
                           for m in ("q", "k", "v"))
                att = torch.softmax(matmul(q, k.transpose(1, 2), self.precision)
                                    / math.sqrt(hd), dim=-1)
                ctx = matmul(att, v, self.precision).transpose(0, 1).reshape(n, h)
                x = self._ln(x + self._lin(ctx, f"{i}.o"), f"{i}.ln1")
                ff = F.gelu(self._lin(x, f"{i}.ff1"), approximate="none")
                x = self._ln(x + self._lin(ff, f"{i}.ff2"), f"{i}.ln2")
            return x[0].float()

    def embed_many(self, seqs: list) -> torch.Tensor:
        return torch.stack([self.embed(s) for s in seqs])
