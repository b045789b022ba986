"""Multi-device sharding tests on the virtual 8-CPU mesh: DP/FSDP/TP training step
runs, losses match the single-device result, staged freezing masks hold."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.models import slime
from slime_jax.parallel import mesh as mesh_lib
from slime_jax.train.optim import TrainConfig, label_tree
from slime_jax.train.step import init_train_state, make_train_step


def _batch(cfg, B=8, S=12, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    pix = rng.standard_normal((B, MC, 3, t, t)).astype(np.float32)
    cmask = np.zeros((B, MC), bool)
    cmask[:, :3] = True
    return {"input_ids": jnp.asarray(ids),
            "attention_mask": jnp.ones((B, S), bool),
            "pixel_values": jnp.asarray(pix),
            "crop_mask": jnp.asarray(cmask),
            "labels": jnp.asarray(labels)}


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("mesh_shape", [(8, 1, 1), (1, 8, 1), (2, 2, 2), (1, 4, 2)])
@pytest.mark.slow
def test_sharded_train_step_runs(tiny_setup, mesh_shape):
    cfg, params = tiny_setup
    tc = TrainConfig(total_steps=10, learning_rate=1e-4)
    mesh = mesh_lib.make_mesh(*mesh_shape)
    with mesh:
        state, tx = init_train_state(params, tc, mesh=mesh)
        step = make_train_step(cfg, tc, tx, compute_dtype=jnp.float32)
        batch = mesh_lib.shard_batch(mesh, _batch(cfg))
        state, m = step(state, batch, jax.random.PRNGKey(1))
        assert np.isfinite(float(m["loss"]))
        state, m2 = step(state, batch, jax.random.PRNGKey(2))
        assert float(m2["loss"]) < float(m["loss"]) + 1.0  # sane progression


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_sharded_loss_matches_single_device(tiny_setup):
    cfg, params = tiny_setup
    batch = _batch(cfg)
    l_single, _ = slime.loss_fn(params, cfg, batch, training=False)

    mesh = mesh_lib.make_mesh(1, 4, 2)
    with mesh:
        p_sh = mesh_lib.shard_params(mesh, params)
        b_sh = mesh_lib.shard_batch(mesh, batch)
        l_sh, _ = jax.jit(lambda p, b: slime.loss_fn(p, cfg, b, training=False))(p_sh, b_sh)
    np.testing.assert_allclose(float(l_sh), float(l_single), rtol=2e-5)


@pytest.mark.slow
def test_frozen_params_do_not_move(tiny_setup):
    cfg, params = tiny_setup
    tc = TrainConfig(total_steps=10, learning_rate=1e-2,
                     tune_mm_mlp_adapter=True, mm_projector_lr=1e-3)
    state, tx = init_train_state(params, tc)
    step = make_train_step(cfg, tc, tx, compute_dtype=jnp.float32)
    before_llm = np.asarray(params["llm"]["embed_tokens"]).copy()
    before_vit = np.asarray(params["vision"]["class_embedding"]).copy()
    before_proj = np.asarray(
        jax.tree_util.tree_leaves(params["projector"]["projection"])[0]).copy()
    # two steps: warmup LR is 0 at optax count 0
    state, _ = step(state, _batch(cfg), jax.random.PRNGKey(3))
    state, _ = step(state, _batch(cfg), jax.random.PRNGKey(4))
    after = state["params"]
    np.testing.assert_array_equal(np.asarray(after["llm"]["embed_tokens"]), before_llm)
    np.testing.assert_array_equal(np.asarray(after["vision"]["class_embedding"]), before_vit)
    # projector must have moved
    assert not np.array_equal(
        np.asarray(jax.tree_util.tree_leaves(after["projector"]["projection"])[0]),
        before_proj)


def test_learnable_gated_pinning(tiny_setup):
    cfg, params = tiny_setup
    labels0 = label_tree(params, TrainConfig(tune_mm_mlp_adapter=True,
                                             mm_learnable_gated=0))
    assert all(v == "frozen" for v in jax.tree_util.tree_leaves(labels0["projector"]["attn"]))
    assert all(v != "frozen" for v in jax.tree_util.tree_leaves(labels0["projector"]["projection"]))
    labels1 = label_tree(params, TrainConfig(tune_mm_mlp_adapter=True,
                                             mm_learnable_gated=1))
    assert all(v == "frozen" for v in jax.tree_util.tree_leaves(labels1["projector"]["projection"]))
    assert all(v != "frozen" for v in jax.tree_util.tree_leaves(labels1["projector"]["attn"]))


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_remat_matches_no_remat(tiny_setup):
    """jax.checkpoint path produces identical loss/grads (up to fp tolerance)."""
    cfg, params = tiny_setup
    batch = _batch(cfg, B=2)

    def loss(p, remat):
        return slime.loss_fn(p, cfg, batch, training=False, remat=remat)[0]

    l0, g0 = jax.value_and_grad(lambda p: loss(p, False))(params)
    l1, g1 = jax.value_and_grad(lambda p: loss(p, True))(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    a = jax.tree_util.tree_leaves(g0)
    b = jax.tree_util.tree_leaves(g1)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-5)


@pytest.mark.slow
def test_mixtral_sparse_moe_sharded_step():
    """The sparse ragged_dot MoE path compiles and trains under the GSPMD mesh
    (experts FSDP/TP-sharded per parallel/mesh._RULES); loss stays finite and the
    sharded loss matches the single-device value."""
    from dataclasses import replace
    cfg = SliMEConfig.tiny()
    cfg = replace(cfg, llm=replace(cfg.llm, num_experts=4, num_experts_per_tok=2))
    params = slime.init(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg, B=4, S=16)  # B*S=64 >= 32 -> sparse dispatch in the graph

    single, _ = slime.loss_fn(params, cfg, batch, training=False)

    mesh = mesh_lib.make_mesh(n_data=2, n_fsdp=2, n_model=2)
    with mesh:
        p = mesh_lib.shard_params(mesh, params)
        tc = TrainConfig(total_steps=10, learning_rate=1e-3)
        state, tx = init_train_state(p, tc)
        step = make_train_step(cfg, tc, tx)
        b = mesh_lib.shard_batch(mesh, batch)
        state, m = step(state, b, jax.random.PRNGKey(1))
        loss = float(m["loss"])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(single), rtol=1e-4)


def test_llama70b_sharding_rules_cover_all_leaves():
    """The production sharding rules produce valid, divisible PartitionSpecs for
    every leaf of the 70B flagship config — checked via abstract shapes only
    (no weight materialization)."""
    from slime_jax.config import SliMEConfig

    from dataclasses import replace
    from slime_jax.config import LLMConfig
    cfg = replace(SliMEConfig.slime_8b(), llm=LLMConfig.llama3_70b())
    abstract = jax.eval_shape(
        lambda k: slime.init(k, cfg), jax.random.PRNGKey(0))
    mesh = mesh_lib.make_mesh(1, 4, 2)  # fsdp=4, tp=2 on the virtual 8
    shardings = mesh_lib.param_shardings(mesh, abstract)

    def check(path, leaf, sh):
        spec = sh.spec
        assert len(spec) <= leaf.ndim, (path, spec, leaf.shape)
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            size = mesh.shape[ax] if isinstance(ax, str) else int(
                np.prod([mesh.shape[a] for a in ax]))
            assert leaf.shape[dim] % size == 0, (path, leaf.shape, spec)

    jax.tree_util.tree_map_with_path(
        lambda p, l, s: check(jax.tree_util.keystr(p), l, s),
        abstract, shardings)
    # spot-check: big matrices actually shard (not everything replicated)
    flat = jax.tree_util.tree_leaves_with_path(shardings)
    sharded = [s for _, s in flat if any(ax is not None for ax in s.spec)]
    assert len(sharded) > 100
