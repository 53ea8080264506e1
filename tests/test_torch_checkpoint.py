"""Training checkpoints in the port (parallel/checkpoint.py): the JAX
package's round trip (tests/test_checkpoint.py) in one process, the kept
steps, and a resume that equals, bit for bit, training on without a stop."""

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu_torch.parallel import make_train_step
from rag_faiss_embedding_tpu_torch.parallel.checkpoint import TrainCheckpointer

from .test_torch_train import TSMALL, fake_batch

LR = 1e-3


def _state_tensors(state):
    """Every weight and optimizer tensor of a state, by name."""
    out = {f"param/{k}": v for k, v in state.params.state_dict().items()}
    for i, per in state.opt_state.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in per.items()})
    return out


def test_train_checkpoint_roundtrip(tmp_path):
    run_step, state = make_train_step(TSMALL, learning_rate=LR, device="cpu")
    batch = fake_batch()
    state, _ = run_step(state, batch)
    state, _ = run_step(state, batch)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    step = ckpt.save(state)
    assert step == 2 and ckpt.latest_step() == 2
    _, fresh = make_train_step(TSMALL, learning_rate=LR, device="cpu")
    restored = ckpt.restore(fresh)
    assert restored.step == 2
    np.testing.assert_array_equal(
        state.params.layers[0].intermediate.weight.detach().numpy(),
        restored.params.layers[0].intermediate.weight.detach().numpy())
    restored, m2 = run_step(restored, batch)
    assert np.isfinite(float(m2["loss"])) and restored.step == 3
    ckpt.close()


def test_latest_step_and_max_to_keep(tmp_path):
    ckpt = TrainCheckpointer(tmp_path, max_to_keep=3)
    assert ckpt.latest_step() is None
    _, state = make_train_step(TSMALL, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    for step in (1, 2, 3, 4, 5):
        assert ckpt.save(state, step=step) == step
    assert ckpt.latest_step() == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4", "5"]  # no temporaries
    assert ckpt.restore(state, step=3).step == 0  # the state's own step, saved as 0
    ckpt.save(state, step=4)  # a step saved again replaces it
    assert ckpt.latest_step() == 5 and len(list(tmp_path.iterdir())) == 3


def test_resume_equals_training_on_bit_for_bit(tmp_path):
    batches = [fake_batch(seed=s) for s in range(4)]
    run_step, state = make_train_step(TSMALL, learning_rate=LR, device="cpu")
    for b in batches[:2]:
        state, _ = run_step(state, b)
    ckpt = TrainCheckpointer(tmp_path)
    ckpt.save(state)
    on = []
    for b in batches[2:]:
        state, m = run_step(state, b)
        on.append(float(m["loss"]))
    _, fresh = make_train_step(TSMALL, learning_rate=LR, device="cpu")
    resumed = ckpt.restore(fresh)
    again = []
    for b in batches[2:]:
        resumed, m = run_step(resumed, b)
        again.append(float(m["loss"]))
    assert again == on and resumed.step == state.step == 4
    a, b = _state_tensors(state), _state_tensors(resumed)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
