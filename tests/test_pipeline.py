"""Pipeline parallelism (GPipe wavefront over the virtual mesh) vs the standard
forward: logits parity, jit, grads, and microbatch-count invariance."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from slime_jax.config import LLMConfig
from slime_jax.models import llama
from slime_jax.parallel.pipeline import pipeline_forward, stack_layers


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("pp",))


@pytest.fixture(scope="module")
def setup():
    cfg = LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                    num_layers=8, num_heads=4, num_kv_heads=2, head_dim=8,
                    rope_theta=10000.0, max_position_embeddings=128)
    params = llama.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (8, 16)).astype(np.int32)
    embeds = llama.embed(params, jnp.asarray(ids))
    ref, _ = llama.forward(params, embeds, cfg)
    return cfg, params, embeds, ref


@pytest.mark.parametrize("n_stages,n_micro", [
    pytest.param(4, 8, marks=pytest.mark.slow),   # heavy: compile-bound
    pytest.param(8, 8, marks=pytest.mark.slow), (2, 4)])
def test_pipeline_matches_forward(setup, n_stages, n_micro):
    cfg, params, embeds, ref = setup
    mesh = _mesh(n_stages)
    out = pipeline_forward(params, embeds, cfg, mesh=mesh, n_micro=n_micro)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-4, rtol=1e-4)


def test_pipeline_under_jit(setup):
    cfg, params, embeds, ref = setup
    mesh = _mesh(4)
    stacked = stack_layers(params)
    f = jax.jit(lambda p, s, e: pipeline_forward(p, e, cfg, mesh=mesh,
                                                 n_micro=8, stacked=s))
    out = f(params, stacked, embeds)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-4, rtol=1e-4)


@pytest.mark.slow
def test_pipeline_grad_matches(setup):
    """Backward through the wavefront scan + ppermute equals the standard
    forward's gradients."""
    cfg, params, embeds, _ = setup
    mesh = _mesh(4)

    def pp_loss(p, e):
        return jnp.mean(pipeline_forward(p, e, cfg, mesh=mesh,
                                         n_micro=4) ** 2)

    def ref_loss(p, e):
        return jnp.mean(llama.forward(p, e, cfg)[0] ** 2)

    g_pp = jax.grad(pp_loss, argnums=1)(params, embeds)
    g_ref = jax.grad(ref_loss, argnums=1)(params, embeds)
    np.testing.assert_allclose(np.asarray(g_pp), np.asarray(g_ref),
                               atol=2e-5, rtol=1e-3)
    # layer-weight grads too (first and last layer hit different stages)
    gp = jax.grad(pp_loss)(params, embeds)
    gr = jax.grad(ref_loss)(params, embeds)
    for i in (0, cfg.num_layers - 1):
        a = gp["layers"][i]["q_proj"]["weight"]
        b = gr["layers"][i]["q_proj"]["weight"]
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, rtol=1e-3)


def test_bad_shapes_raise(setup):
    cfg, params, embeds, _ = setup
    mesh = _mesh(4)
    with pytest.raises(AssertionError):
        pipeline_forward(params, embeds, cfg, mesh=mesh, n_micro=3)  # 8 % 3
    cfg_bad = LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_layers=6, num_heads=4, num_kv_heads=2, head_dim=8)
    with pytest.raises(AssertionError):
        params6 = llama.init(jax.random.PRNGKey(0), cfg_bad)
        pipeline_forward(params6, embeds, cfg_bad, mesh=mesh)  # 6 % 4


@pytest.mark.slow
def test_pp_train_step_loss_decreases(setup):
    """Pipeline-parallel training: 6 steps of overfit on one batch drop the loss;
    first-step loss matches the non-pipelined loss_fn value."""
    import optax
    from slime_jax.constants import IGNORE_INDEX
    from slime_jax.parallel.pipeline import (init_pp_train_state,
                                             make_pp_train_step, unstack_layers)

    cfg, params, _, _ = setup
    mesh = _mesh(4)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 64, (8, 16)).astype(np.int32)
    batch = {"input_ids": jnp.asarray(ids),
             "labels": jnp.asarray(ids)}

    tx = optax.adamw(3e-3)
    state = init_pp_train_state(params, tx, mesh=mesh)
    step = make_pp_train_step(cfg, tx, mesh=mesh, n_micro=8)

    # reference loss: plain forward CE on the same batch
    emb = llama.embed(params, batch["input_ids"])
    logits, _ = llama.forward(params, emb, cfg)
    lp = jax.nn.log_softmax(logits.astype(jnp.float32)[:, :-1], -1)
    ref = float(-jnp.mean(jnp.take_along_axis(
        lp, batch["labels"][:, 1:, None], axis=-1)))

    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], ref, rtol=1e-4)
    assert losses[-1] < losses[0] - 0.1, losses

    # round-trip the stacked layers back to checkpoint layout
    layers = unstack_layers(state["stacked"], cfg.num_layers)
    assert len(layers) == cfg.num_layers
    assert layers[0]["q_proj"]["weight"].shape == \
        params["layers"][0]["q_proj"]["weight"].shape
