"""Contrastive training in the port (parallel/train.py) vs the JAX package.

From one parameter tree and one fixed batch, both packages' ``make_train_step``
take three steps at lr 1e-3 (SMALL, the config of tests/test_parallel.py, on
a one-device mesh in JAX): loss and accuracy per step within 1e-5 relative,
every parameter within 1e-5 absolute at the end, but the attention key
biases, whose exact gradient is zero (see ``assert_params_close``). A JAX run's state (params,
optax's Adam moments and count, the step) carried into the port continues
the same way. ``info_nce_loss`` is held to JAX's on the same embeddings
(rtol 1e-6), ``init_params`` gives JAX's tree, and a mesh of more than one
device trains over it.
"""

import jax
import numpy as np
import optax
import torch

from rag_faiss_embedding_tpu.core.mesh import make_mesh
from rag_faiss_embedding_tpu.models.minilm import MiniLMConfig as JCfg
from rag_faiss_embedding_tpu.models.minilm import MiniLMEncoder as JEnc
from rag_faiss_embedding_tpu.parallel import train as jtrain
from rag_faiss_embedding_tpu_torch.core.mesh import make_mesh as tmake_mesh
from rag_faiss_embedding_tpu_torch.models.convert import deterministic_params, to_flax_params
from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig as TCfg
from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMEncoder as TEnc
from rag_faiss_embedding_tpu_torch.parallel import train as ttrain

SMALL_KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position_embeddings=32, dropout_rate=0.0)
JSMALL, TSMALL = JCfg(**SMALL_KW), TCfg(**SMALL_KW)
LR = 1e-3
RTOL_METRIC, ATOL_PARAM = 1e-5, 1e-5


def fake_batch(seed=0, n=8, seq=16):
    """Token batch with padded tails of several lengths, queries and
    documents distinct."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "d"):
        ids = rng.integers(5, 100, size=(n, seq)).astype(np.int32)
        mask = (np.arange(seq)[None, :] < rng.integers(4, seq + 1, size=(n, 1))).astype(np.int32)
        out[f"{side}_ids"], out[f"{side}_mask"] = ids * mask, mask
    return out


def one_device_mesh():
    return make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])


def flat(tree, prefix=""):
    """{slash path: numpy leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def assert_params_close(tstate, jparams, start, steps):
    """Every parameter within ATOL_PARAM of JAX's, but the attention key
    biases: their exact gradient is zero (a softmax does not see a shift
    common to a query's logits, test_key_bias_gradient_is_zero), so in both
    packages what Adam normalises into a step of up to lr is float32
    rounding noise, with no sign in common. Those are held to the bound
    Adam puts on any move, 1.01 x lr a step, in both packages."""
    t = flat(to_flax_params(tstate.params.state_dict(), TSMALL))
    j = flat(jax.device_get(jparams))
    s0 = flat(start)
    assert t.keys() == j.keys()
    for name in t:
        if name.endswith("attention/key/bias"):
            for mine in (t[name], j[name]):
                assert np.abs(mine - s0[name]).max() <= 1.01 * LR * steps, name
            continue
        np.testing.assert_allclose(t[name], j[name], rtol=0, atol=ATOL_PARAM, err_msg=name)


def jax_steps(state, run_step, batch, n):
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n):
        state, m = run_step(state, jb)
        out.append((float(m["loss"]), float(m["accuracy"])))
    return state, out


def port_steps(state, run_step, batch, n):
    out = []
    for _ in range(n):
        state, m = run_step(state, batch)
        out.append((float(m["loss"]), float(m["accuracy"])))
    return state, out


def assert_metrics_close(t, j):
    np.testing.assert_allclose(np.array(t), np.array(j), rtol=RTOL_METRIC, atol=0)


def test_info_nce_loss_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    d = q + 0.5 * rng.standard_normal((16, 32)).astype(np.float32)
    d[3] = d[2]  # a tie in row 2's logits: both take the first index
    q[5] = 0.0   # a zero row: the 1e-9 floor, not F.normalize's 1e-12
    tl, ta = ttrain.info_nce_loss(torch.from_numpy(q), torch.from_numpy(d))
    jl, ja = jtrain.info_nce_loss(jax.numpy.asarray(q), jax.numpy.asarray(d))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(ta) == float(ja)
    for t in (0.05, 1.0):
        tl, _ = ttrain.info_nce_loss(torch.from_numpy(q), torch.from_numpy(d), temperature=t)
        jl, _ = jtrain.info_nce_loss(jax.numpy.asarray(q), jax.numpy.asarray(d),
                                     temperature=t)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_three_steps_match_jax_from_one_parameter_tree():
    params = deterministic_params(TSMALL, seed=3)
    batch = fake_batch()
    j_run, j_state = jtrain.make_train_step(JSMALL, one_device_mesh(), learning_rate=LR,
                                            params=params)
    t_run, t_state = ttrain.make_train_step(TSMALL, learning_rate=LR, params=params,
                                            device="cpu")
    j_state, jm = jax_steps(j_state, j_run, batch, 3)
    t_state, tm = port_steps(t_state, t_run, batch, 3)
    assert t_state.step == int(j_state.step) == 3
    assert_metrics_close(tm, jm)
    assert tm[-1][0] < tm[0][0]  # it learns the fixed batch
    assert_params_close(t_state, j_state.params, params, 3)


def test_jax_state_carried_into_the_port_continues_the_same():
    params = deterministic_params(TSMALL, seed=4)
    batch, batch2 = fake_batch(seed=1), fake_batch(seed=2)
    j_run, j_state = jtrain.make_train_step(JSMALL, one_device_mesh(), learning_rate=LR,
                                            params=params)
    j_state, _ = jax_steps(j_state, j_run, batch, 2)
    adam = next(s for s in jax.tree.leaves(
        j_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    carried = ttrain.state_from_flax(TSMALL, jax.device_get(j_state.params),
                                     jax.device_get(adam), jax.device_get(j_state.step),
                                     learning_rate=LR, device="cpu")
    assert carried.step == 2
    assert_params_close(carried, j_state.params, params, 2)
    t_run, _ = ttrain.make_train_step(TSMALL, learning_rate=LR, params=params, device="cpu")
    j_state, jm = jax_steps(j_state, j_run, batch2, 2)
    carried, tm = port_steps(carried, t_run, batch2, 2)
    assert carried.step == 4
    assert_metrics_close(tm, jm)
    assert_params_close(carried, j_state.params, params, 4)


def test_key_bias_gradient_is_zero():
    """The key biases' float32 gradient is rounding noise, ~1e-7 of the
    query biases' (float32's epsilon): the reason assert_params_close holds
    the key biases to Adam's bound instead of to JAX's values."""
    model = TEnc(TSMALL)
    b = {k: torch.from_numpy(v) for k, v in fake_batch().items()}
    loss, _ = ttrain.info_nce_loss(model(b["q_ids"], b["q_mask"], pooling="mean"),
                                   model(b["d_ids"], b["d_mask"], pooling="mean"))
    loss.backward()
    for layer in model.layers:
        g_key = layer.attention.key.bias.grad.abs().max().item()
        g_query = layer.attention.query.bias.grad.abs().max().item()
        assert g_query > 1e-3 and g_key < 1e-6 * g_query


def test_init_params_tree_equals_jax():
    jtree = flat(jax.device_get(JEnc(JSMALL).init_params(jax.random.PRNGKey(0))))
    ttree = flat(TEnc(TSMALL).init_params(0))
    assert ttree.keys() == jtree.keys()
    for name in ttree:
        assert ttree[name].shape == jtree[name].shape, name
        assert ttree[name].dtype == np.float32
    gen_tree = flat(TEnc(TSMALL).init_params(torch.Generator().manual_seed(0)))
    for name in ttree:
        np.testing.assert_array_equal(gen_tree[name], ttree[name])


def test_mesh_of_more_than_one_device_names_the_multi_gpu_slice():
    """A mesh of two positions trains over them (the multi-GPU slice,
    tests/test_torch_train_mesh.py): the same step as one card; a mesh of
    one device keeps the one-card state."""
    params = deterministic_params(TSMALL, seed=9)
    mesh = tmake_mesh({"data": 2, "model": 1}, devices=[torch.device("cpu")] * 2)
    run2, state2 = ttrain.make_train_step(TSMALL, mesh, learning_rate=LR, params=params)
    run1, state1 = ttrain.make_train_step(TSMALL, learning_rate=LR, params=params, device="cpu")
    assert isinstance(state2.params, ttrain.MeshEncoder)
    state2, m2 = port_steps(state2, run2, fake_batch(), 2)
    state1, m1 = port_steps(state1, run1, fake_batch(), 2)
    assert_metrics_close(m2, m1)
    assert_params_close(state2, to_flax_params(state1.params.state_dict(), TSMALL), params, 2)
    run, state = ttrain.make_train_step(TSMALL, one_device_mesh(), device="cpu")
    assert state.step == 0 and isinstance(state.opt_state, torch.optim.AdamW)
    group = state.opt_state.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8
    assert group["betas"] == (0.9, 0.999) and group["lr"] == 2e-5
