"""Data- and tensor-parallel training in the port (parallel/train.py over a
mesh) vs the JAX package's and the port's one-card step.

The port's meshes are grids of repeated ``cpu`` devices, JAX's are over
conftest's 8 virtual devices; the config is SMALL (tests/test_parallel.py's),
the inputs come from seeded numpy generators.

- ``param_sharding_rules`` and ``shard_params``: on {"data": 2, "model": 4}
  and the mixed {"data": 1, "model": 8} with vocab 130 (4 heads and 130 rows
  do not split over 8, the FFN does), every leaf's spec equals JAX's
  ``NamedSharding.spec`` and every part JAX's shard at the same position.
- Three steps on {"data": 2, "model": 4} equal JAX's three 2 x 4 steps (one
  JAX run, a module fixture) and the port's one-card steps: loss and
  accuracy within 1e-5 relative, every parameter within 1e-5 but the
  attention key biases, held to Adam's bound (``assert_params_close``).
  Other meshes (data only, model only, the mixed one, no "model" axis, an
  extra axis, another data axis name) against the one-card steps.
- The negatives span the global batch; a batch the data axis does not
  divide, and a mesh without the data axis, raise.
- The mesh forward equals ``MiniLMEncoder``'s (both poolings, padded
  masks, token types), to 1e-5 in float32 and two ulps in bf16.
"""

import jax
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.core.mesh import make_mesh as jmake_mesh
from rag_faiss_embedding_tpu.parallel import train as jtrain
from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh
from rag_faiss_embedding_tpu_torch.models.convert import (deterministic_params,
                                                          load_flax_params, to_flax_params)
from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig as TCfg
from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMEncoder as TEnc
from rag_faiss_embedding_tpu_torch.parallel import train as ttrain

from .test_torch_train import (JSMALL, LR, SMALL_KW, TSMALL, assert_metrics_close,
                               assert_params_close, fake_batch, flat, jax_steps)

CPU = torch.device("cpu")
STEPS = 3
T130 = TCfg(**{**SMALL_KW, "vocab_size": 130})


def cpu_mesh(shape: dict):
    return make_mesh(shape, devices=[CPU] * int(np.prod(list(shape.values()))))


def batches():
    return [fake_batch(seed=10 + s) for s in range(STEPS)]


def steps(run, state, bs):
    out = []
    for b in bs:
        state, m = run(state, b)
        out.append((float(m["loss"]), float(m["accuracy"])))
    return state, out


def one_card_run(cfg, params, bs):
    run, state = ttrain.make_train_step(cfg, learning_rate=LR, params=params, device=CPU)
    return steps(run, state, bs)


@pytest.fixture(scope="module")
def start():
    return deterministic_params(TSMALL, seed=5)


@pytest.fixture(scope="module")
def jax_2x4(start):
    """JAX's three data- and tensor-parallel steps on a 2 x 4 mesh: the one
    JAX run of the module."""
    run, state = jtrain.make_train_step(JSMALL, jmake_mesh({"data": 2, "model": 4}),
                                        learning_rate=LR, params=start)
    metrics = []
    for b in batches():
        state, m = jax_steps(state, run, b, 1)
        metrics += m
    return jax.device_get(state.params), metrics


@pytest.fixture(scope="module")
def one_card(start):
    state, metrics = one_card_run(TSMALL, start, batches())
    return to_flax_params(state.params.state_dict(), TSMALL), metrics


def params_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def flat_leaves(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        out.update(flat_leaves(v, p) if isinstance(v, dict) else {p: v})
    return out


# (a) the layout --------------------------------------------------------------

def test_param_sharding_rules_equal_jax_on_every_leaf(start):
    paths = list(flat(start)) + ["a/word_embeddings/b", "attention/output/bias",
                                 "attention_norm/bias", "ffn_output/bias"]
    for path in paths:
        assert ttrain.param_sharding_rules(path) == jtrain.param_sharding_rules(path), path


@pytest.mark.parametrize("shape,cfg", [({"data": 2, "model": 4}, TSMALL),
                                       ({"data": 1, "model": 8}, T130)],
                         ids=["2x4", "1x8-vocab130"])
def test_shard_params_specs_and_parts_equal_jax(shape, cfg):
    params = deterministic_params(cfg, seed=2)
    jmesh, mesh = jmake_mesh(shape), cpu_mesh(shape)
    jflat = flat_leaves(jtrain.shard_params(params, jmesh))
    tflat = flat_leaves(ttrain.shard_params(params, mesh))
    assert tflat.keys() == jflat.keys()
    for path, leaf in tflat.items():
        jleaf = jflat[path]
        assert leaf.spec == tuple(jleaf.sharding.spec), path
        assert leaf.shape == jleaf.shape and leaf.parts.shape == jmesh.devices.shape
        for pos in np.ndindex(jmesh.devices.shape):
            shard = next(s for s in jleaf.addressable_shards if s.device == jmesh.devices[pos])
            part = leaf.parts[pos]
            assert part.device == mesh.devices[pos]
            np.testing.assert_array_equal(part.numpy(), np.asarray(shard.data), err_msg=path)
    if shape == {"data": 1, "model": 8}:  # the mixed case
        assert tflat["layer_0/attention/query/kernel"].spec == (None, None, None)
        assert tflat["embeddings/word_embeddings/embedding"].spec == (None, None)
        assert tflat["layer_0/intermediate/kernel"].spec == (None, "model")
        assert tflat["layer_0/ffn_output/kernel"].spec == ("model", None)
    else:
        assert tflat["layer_0/attention/output/kernel"].spec == ("model", None, None)
        assert tflat["layer_0/ffn_output/bias"].spec == ()


def test_shard_params_without_model_axis_copies_every_leaf():
    params = deterministic_params(TSMALL, seed=2)
    mesh = cpu_mesh({"data": 4})
    for path, leaf in flat_leaves(ttrain.shard_params(params, mesh)).items():
        assert leaf.spec == ()
        for part in leaf.parts.flat:
            np.testing.assert_array_equal(part.numpy(), params_leaf(params, path))


# (b) the steps ---------------------------------------------------------------

def test_three_2x4_steps_equal_jax_2x4_and_one_card(start, jax_2x4, one_card):
    run, state = ttrain.make_train_step(TSMALL, cpu_mesh({"data": 2, "model": 4}),
                                        learning_rate=LR, params=start)
    assert isinstance(state.params, ttrain.MeshEncoder)
    assert isinstance(state.opt_state, ttrain.MeshAdamW)
    state, metrics = steps(run, state, batches())
    jparams, jmetrics = jax_2x4
    assert state.step == STEPS
    assert_metrics_close(metrics, jmetrics)
    assert_metrics_close(metrics, one_card[1])
    assert_params_close(state, jparams, start, STEPS)
    assert_params_close(state, one_card[0], start, STEPS)


@pytest.mark.parametrize("shape,cfg,axis", [
    ({"data": 8, "model": 1}, TSMALL, "data"),
    ({"data": 1, "model": 4}, TSMALL, "data"),
    ({"data": 1, "model": 8}, T130, "data"),
    ({"data": 2, "model": 2}, TSMALL, "data"),
    ({"data": 4}, TSMALL, "data"),
    ({"data": 2, "db": 2, "model": 2}, TSMALL, "data"),
    ({"batch": 2, "model": 2}, TSMALL, "batch"),
], ids=["8x1", "1x4", "1x8-vocab130", "2x2", "data4", "extra-axis", "batch-axis"])
def test_mesh_steps_equal_one_card_steps(shape, cfg, axis):
    start = deterministic_params(cfg, seed=6)
    run, state = ttrain.make_train_step(cfg, cpu_mesh(shape), learning_rate=LR,
                                        data_axis=axis, params=start)
    state, metrics = steps(run, state, batches())
    one, one_metrics = one_card_run(cfg, start, batches())
    assert_metrics_close(metrics, one_metrics)
    assert_params_close(state, to_flax_params(one.params.state_dict(), cfg), start, STEPS)
    # the optimizer's moments, gathered, equal the one-card AdamW's
    mine, theirs = state.opt_state.state_dict(), one.opt_state.state_dict()
    assert mine["state"].keys() == theirs["state"].keys()
    assert mine["param_groups"] == theirs["param_groups"]
    for i, per in theirs["state"].items():
        assert float(mine["state"][i]["step"]) == float(per["step"]) == STEPS
        np.testing.assert_allclose(mine["state"][i]["exp_avg"], per["exp_avg"], rtol=0,
                                   atol=1e-6)


def test_slices_follow_the_layout():
    """On 2 x 4 each head, FFN and vocabulary group is four slices on the
    model positions of data row 0; LayerNorms and output biases are whole."""
    mesh = make_mesh({"data": 2, "model": 4}, devices=[torch.device("cpu", 0)] * 8)
    _, state = ttrain.make_train_step(TSMALL, mesh, params=deterministic_params(TSMALL))
    enc = state.params
    h, heads = TSMALL.hidden_size, TSMALL.num_heads
    want = {"embeddings.word_embeddings.weight": (4, (32, h)),
            "layers.0.attention.key.weight": (4, (h // 4, h)),
            "layers.0.attention.key.bias": (4, (h // 4,)),
            "layers.0.attention.output.weight": (4, (h, h // 4)),
            "layers.0.attention.output.bias": (1, (h,)),
            "layers.1.intermediate.weight": (4, (16, h)),
            "layers.1.ffn_output.weight": (4, (h, 16)),
            "layers.1.ffn_output.bias": (1, (h,)),
            "layers.1.ffn_norm.weight": (1, (h,))}
    for name, (n, shape) in want.items():
        slices = enc.slices(name)
        assert len(slices) == n and all(tuple(s.shape) == shape for s in slices), name
    assert heads == 4 and len(list(enc.parameters())) == sum(
        len(enc.slices(n)) for n in enc.names)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_mesh_forward_equals_one_card_forward(pooling, dtype):
    """float32 to 1e-5; bf16 (each partial product rounded to bf16 before
    the sum) to two bf16 ulps (2 x 2^-7) of the output's largest entry."""
    cfg = TCfg(**SMALL_KW, dtype=dtype)
    params = deterministic_params(cfg, seed=7)
    one = TEnc(cfg)
    one.load_state_dict(load_flax_params(params))
    enc = ttrain.MeshEncoder(cfg, load_flax_params(params), cpu_mesh({"data": 2, "model": 4}))
    b = {k: torch.from_numpy(v) for k, v in fake_batch(seed=3).items()}
    types = (torch.arange(16)[None] >= 8).int().expand(8, 16)
    for args in ((b["q_ids"], b["q_mask"]), (b["d_ids"], b["d_mask"], types)):
        want = one(*args, pooling=pooling).detach().numpy()
        atol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(enc(*args, pooling=pooling).detach().numpy(), want,
                                   rtol=0, atol=atol)
    with pytest.raises(ValueError, match="pooling"):
        enc(b["q_ids"], b["q_mask"], pooling="max")


# (c) global negatives, (d) refusals ------------------------------------------

def test_negatives_span_the_global_batch():
    start = deterministic_params(TSMALL, seed=8)
    b = fake_batch(seed=4)
    run, state = ttrain.make_train_step(TSMALL, cpu_mesh({"data": 2}), learning_rate=LR,
                                        params=start)
    _, m = run(state, b)
    one = TEnc(TSMALL)
    one.load_state_dict(load_flax_params(start))
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        q, d = (one(t[f"{s}_ids"], t[f"{s}_mask"], pooling="mean") for s in ("q", "d"))
        whole = float(ttrain.info_nce_loss(q, d)[0])
        per_shard = np.mean([float(ttrain.info_nce_loss(q[i:i + 4], d[i:i + 4])[0])
                             for i in (0, 4)])
    np.testing.assert_allclose(float(m["loss"]), whole, rtol=1e-6)
    assert abs(whole - per_shard) > 0.1  # the shard-local loss is another number


def test_a_batch_the_data_axis_does_not_divide_raises():
    run, state = ttrain.make_train_step(TSMALL, cpu_mesh({"data": 2, "model": 2}),
                                        learning_rate=LR)
    with pytest.raises(ValueError, match="does not split over data=2"):
        run(state, fake_batch(n=7))
    run, state = ttrain.make_train_step(TSMALL, cpu_mesh({"data": 4}), learning_rate=LR)
    with pytest.raises(ValueError, match="does not split over data=4"):
        run(state, fake_batch(n=6))


def test_a_mesh_without_the_data_axis_raises():
    for shape, axis in (({"model": 4}, "data"), ({"data": 2, "model": 2}, "batch"),
                        ({"data": 1}, "batch")):
        with pytest.raises(ValueError, match="no '.*' axis"):
            ttrain.make_train_step(TSMALL, cpu_mesh(shape), data_axis=axis)
