"""Training-state checkpoints and resume.

Counterpart of ``rag_faiss_embedding_tpu/parallel/checkpoint.py`` (orbax
there), with ``torch.save``: one directory per step under ``directory``,
written under a temporary name and renamed into place (a reader never sees
a half-written step, as with orbax), the newest ``max_to_keep`` kept.

A step is saved in the one-card layout whatever it was trained on: a
``MeshEncoder`` and its ``MeshAdamW`` gather their slices in ``state_dict``.
So a step saved on any mesh, or on one card, restores onto any mesh or one
card: ``restore`` loads it into the template's modules, which put each slice
on the template's devices, as JAX's restore puts each leaf back under the
template's sharding.

The two packages' checkpoints do not cross: the port cannot read orbax's
files (no orbax on the card), nor JAX this package's. What crosses is the
encoder's parameters, the ``encoder_params.npz`` of ``models.convert.
export_params``; a JAX run's optimizer state carries over through
``parallel.train.state_from_flax``.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch

from ..core.logging import get_logger
from .train import TrainState

logger = get_logger(__name__)

_FILE = "state.pt"


class TrainCheckpointer:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _FILE).exists())

    def save(self, state: TrainState, step: Optional[int] = None) -> int:
        step = int(state.step) if step is None else int(step)
        tmp = self.directory / f"{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({"params": state.params.state_dict(),
                    "opt_state": state.opt_state.state_dict(),
                    "step": int(state.step)}, tmp / _FILE)
        final = self.directory / str(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))
        logger.info("saved train checkpoint step=%d to %s", step, self.directory)
        return step

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a step into the template's encoder and optimizer (in place,
        on their devices: a mesh template splits it onto its slices) and
        return the restored state."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        # loaded to the host: load_state_dict moves the weights and moments
        # to their parameters' device and keeps AdamW's step counts there
        payload = torch.load(self.directory / str(step) / _FILE, map_location="cpu",
                             weights_only=True)
        template.params.load_state_dict(payload["params"])
        template.opt_state.load_state_dict(payload["opt_state"])
        logger.info("restored train checkpoint step=%d", step)
        return TrainState(template.params, template.opt_state, int(payload["step"]))

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
