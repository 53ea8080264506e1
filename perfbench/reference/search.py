"""Plain exact nearest-neighbour arithmetic (the reference's, written fresh).

Exact L2 top-k over rows handed in blocks: a float32 pass (TF32 off) keeps
``k + margin`` candidates per query and block, and the candidates are then
scored again in float64 from the rows themselves, so the answer is the
float64 top-k wherever the float32 pass kept it (its error is far below
the gap between the k-th and the (k + margin)-th neighbour).

The controls, in the program's place: ``precision="tf32"`` (products with
TF32 inputs, the step below float32) and ``storage="fp8"`` (rows stored as
float8 e4m3 with a scale per row, the step below bfloat16 storage). Their
distances are computed from what they store, as a program storing so would
report them.
"""

from __future__ import annotations

import torch

from .minilm import matmul, precision_of

MARGIN = 22


def quantize_fp8(rows: torch.Tensor) -> torch.Tensor:
    """Rows as float8 e4m3 with a scale per row (the row's largest
    magnitude at e4m3's largest, 448), widened back."""
    scale = rows.abs().amax(1, keepdim=True).clamp_min(1e-30) / 448.0
    return (rows / scale).to(torch.float8_e4m3fn).float() * scale


class Exact:
    """Top-k accumulated over blocks of rows; ``add(rows, first_id)`` per
    block, ``result()`` at the end: (values, ids) as float64 / int64."""

    def __init__(self, q: torch.Tensor, k: int, precision: str = "float32",
                 storage: str = "float32"):
        self.q = q.float()
        self.k, self.precision, self.storage = k, precision, storage
        self.vals = self.ids = None
        self.exact = precision == "float32" and storage == "float32"

    def add(self, rows: torch.Tensor, first_id: int, max_queries: int = 1024) -> None:
        rows = rows.float()
        if self.storage == "fp8":
            rows = quantize_fp8(rows)
        keep = min(self.k + (MARGIN if self.exact else 0), len(rows))
        vals, ids = [], []
        with precision_of(self.precision, rows.device):
            r_sq = (rows * rows).sum(1)
            for a in range(0, len(self.q), max_queries):
                q = self.q[a:a + max_queries].to(rows.device)
                d = (q * q).sum(1, keepdim=True) + r_sq[None] - 2 * matmul(
                    q, rows.t(), self.precision)
                v, i = torch.topk(d, keep, dim=1, largest=False)
                if self.exact:  # the candidates again, in float64
                    diff = q.double()[:, None, :] - rows[i].double()
                    v = (diff * diff).sum(-1)
                vals.append(v.double().cpu())
                ids.append(i.cpu() + first_id)
        self._merge(torch.cat(vals), torch.cat(ids))

    def _merge(self, v, i) -> None:
        if self.vals is not None:
            v, i = torch.cat([self.vals, v], 1), torch.cat([self.ids, i], 1)
        order = torch.sort(v, dim=1, stable=True).indices[:, : self.k + MARGIN]
        self.vals, self.ids = v.gather(1, order), i.gather(1, order)

    def result(self):
        return self.vals[:, : self.k], self.ids[:, : self.k]


def distances(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Float64 squared L2 distance of query ``j`` to row ``j`` (pairs)."""
    diff = q.double() - rows.double()
    return (diff * diff).sum(-1)
