"""8-bit AdamW (train/opt8.py): quantization bounds, step fidelity vs fp32
Adam, convergence through the real train step, state-size accounting."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402
import optax  # noqa: E402

from slime_jax.train.opt8 import (_dequantize, _quantize, adamw8bit,
                                  scale_by_adam8bit, state_bytes)


def test_quant_roundtrip_bounds():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((1000,)).astype(np.float32) *
                    np.exp(rng.uniform(-6, 2, 1000)).astype(np.float32))
    q, s = _quantize(x)
    back = _dequantize(q, s, x.shape)
    err = np.abs(np.asarray(back - x))
    # linear absmax: error bounded by scale/2 per block
    scales = np.repeat(np.asarray(s)[:, 0], 256)[:1000]
    assert (err <= scales * 0.5 + 1e-9).all()


def test_sqrt_domain_wins_for_v():
    """Adam's v spans orders of magnitude; sqrt-domain storage cuts the
    relative error on sqrt(v) (what the update consumes) vs linear."""
    rng = np.random.default_rng(1)
    v = jnp.asarray((rng.standard_normal(4096) ** 2 *
                     np.exp(rng.uniform(-12, 0, 4096))).astype(np.float32))
    q_lin, s_lin = _quantize(v)
    v_lin = np.maximum(np.asarray(_dequantize(q_lin, s_lin, v.shape)), 0)
    q_sq, s_sq = _quantize(jnp.sqrt(v))
    v_sq = np.asarray(_dequantize(q_sq, s_sq, v.shape)) ** 2
    tgt = np.sqrt(np.asarray(v)) + 1e-12
    e_lin = np.abs(np.sqrt(v_lin) - tgt) / (tgt + 1e-8)
    e_sq = np.abs(np.sqrt(v_sq) - tgt) / (tgt + 1e-8)
    assert np.median(e_sq) < 0.5 * np.median(e_lin)


def test_single_step_matches_fp_adam():
    rng = np.random.default_rng(2)
    params = {"w": jnp.asarray(rng.standard_normal((64, 64)).astype(np.float32)),
              "b": jnp.asarray(rng.standard_normal((64,)).astype(np.float32))}
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              * 0.1), params)
    tx8 = scale_by_adam8bit()
    txf = optax.scale_by_adam()
    u8, _ = tx8.update(grads, tx8.init(params))
    uf, _ = txf.update(grads, txf.init(params))
    for a, b in zip(jax.tree_util.tree_leaves(u8),
                    jax.tree_util.tree_leaves(uf)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 0.03


def test_convergence_matches_fp_adam():
    """Overfit a tiny regression with both optimizers under jit: final losses
    comparable (the int8 moments must not break optimization)."""
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((128, 16)).astype(np.float32))
    yt = jnp.asarray(rng.standard_normal((128, 1)).astype(np.float32))

    def loss_fn(p):
        h = jnp.tanh(X @ p["w1"])
        return jnp.mean((h @ p["w2"] - yt) ** 2)

    def run(tx):
        p = {"w1": jnp.asarray(rng.standard_normal((16, 32)).astype(np.float32) * 0.3),
             "w2": jnp.asarray(rng.standard_normal((32, 1)).astype(np.float32) * 0.3)}
        # same init for both runs
        p = jax.tree_util.tree_map(lambda x: x, P0)
        st = tx.init(p)

        @jax.jit
        def step(p, st):
            l, g = jax.value_and_grad(loss_fn)(p)
            u, st = tx.update(g, st, p)
            return optax.apply_updates(p, u), st, l

        for _ in range(150):
            p, st, l = step(p, st)
        return float(l)

    rng0 = np.random.default_rng(42)
    P0 = {"w1": jnp.asarray(rng0.standard_normal((16, 32)).astype(np.float32) * 0.3),
          "w2": jnp.asarray(rng0.standard_normal((32, 1)).astype(np.float32) * 0.3)}
    l8 = run(adamw8bit(1e-2))
    lf = run(optax.adamw(1e-2))
    assert l8 < 1.3 * lf + 1e-3, (l8, lf)
    assert l8 < 0.1 * float(loss_fn(P0))        # actually optimized


def test_state_is_int8_and_small():
    params = {"w": jnp.zeros((1000, 100), jnp.float32)}
    tx = scale_by_adam8bit()
    st = tx.init(params)
    assert st.m_q["w"].dtype == jnp.int8 and st.v_q["w"].dtype == jnp.int8
    b = state_bytes(params)
    assert 3.5 < b["ratio"] < 4.0     # ~3.9x vs fp32 Adam


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_trainer_integration_adamw8bit():
    """TrainConfig(optim=adamw8bit) trains the real tiny model: loss drops."""
    from slime_jax.config import SliMEConfig
    from slime_jax.constants import IGNORE_INDEX
    from slime_jax.models import slime
    from slime_jax.train.optim import TrainConfig, make_optimizer
    from slime_jax.train.step import make_train_step

    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    tc = TrainConfig(learning_rate=5e-3, total_steps=12, warmup_ratio=0.0,
                     lr_schedule="constant", optim="adamw8bit")
    tx, _ = make_optimizer(params, tc)
    step = make_train_step(cfg, tc, tx)
    rng = np.random.default_rng(4)
    S = 24
    MC = 1 + cfg.max_local_crops
    t = cfg.vision.image_size
    ids = rng.integers(5, cfg.llm.vocab_size, (2, S)).astype(np.int32)
    batch = {"input_ids": ids, "labels": ids.copy(),
             "attention_mask": np.ones((2, S), bool),
             "pixel_values": np.zeros((2, MC, 3, t, t), np.float32),
             "crop_mask": np.zeros((2, MC), bool)}
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    losses = []
    for i in range(12):
        state, m = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses


def test_70b_fit_with_8bit_adam_needs_fewer_chips():
    """opt_bytes=2 (the 8-bit Adam state, ~2.06 B/param) halves the 70B
    full-finetune mesh: with bf16-master training, (fsdp=4, tp=4, pp=4) =
    64 devices of 16 GiB fit (12.5 GB each) where fp32-Adam does not (17.0 GB) —
    the optimizer state is the binding term. The conservative fp32-master
    fp32-Adam table stays at 128 chips (test_memory_plan.py)."""
    from slime_jax.config import LLMConfig
    from slime_jax.parallel import memory_plan as mp

    p = mp.plan(LLMConfig.llama3_70b(), n_fsdp=4, n_model=4, n_pp=4,
                batch=32, seq=2048, opt_bytes=2, master_fp32=False)
    assert p.fits(16 * 2 ** 30), p.per_category_gb
    p32 = mp.plan(LLMConfig.llama3_70b(), n_fsdp=4, n_model=4, n_pp=4,
                  batch=32, seq=2048, opt_bytes=4, master_fp32=False)
    assert not p32.fits(16 * 2 ** 30), p32.per_category_gb
