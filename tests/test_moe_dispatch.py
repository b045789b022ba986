"""Sparse (ragged_dot grouped) MoE dispatch vs the dense-masked oracle — exactness
of the dropless path, and the _moe threshold switch inside the Mixtral decoder."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import LLMConfig
from slime_jax.models import llama
from slime_jax.ops.moe_dispatch import moe_ffn_sparse


def _dense_oracle(x, w1, w2, w3, topi, topw):
    T, H = x.shape
    E = w1.shape[0]
    out = np.zeros((T, H), np.float32)
    for t in range(T):
        for s in range(topi.shape[1]):
            e = int(topi[t, s])
            h1 = x[t] @ w1[e].T
            h3 = x[t] @ w3[e].T
            silu = h1 / (1 + np.exp(-h1))
            out[t] += float(topw[t, s]) * ((silu * h3) @ w2[e].T)
    return out


@pytest.mark.parametrize("T,E,K", [(40, 8, 2), (64, 4, 1), (33, 3, 3)])
def test_sparse_matches_oracle(rng, T, E, K):
    H, I = 16, 24
    x = rng.standard_normal((T, H)).astype(np.float32)
    w1 = rng.standard_normal((E, I, H)).astype(np.float32) * 0.2
    w2 = rng.standard_normal((E, H, I)).astype(np.float32) * 0.2
    w3 = rng.standard_normal((E, I, H)).astype(np.float32) * 0.2
    topi = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)
    topw = rng.random((T, K)).astype(np.float32)

    out = jax.jit(moe_ffn_sparse)(*map(jnp.asarray, (x, w1, w2, w3, topi, topw)))
    np.testing.assert_allclose(np.asarray(out),
                               _dense_oracle(x, w1, w2, w3, topi, topw),
                               atol=2e-4, rtol=1e-4)


def test_empty_expert(rng):
    """Experts that receive zero tokens must not perturb the result."""
    T, E, K, H, I = 48, 6, 2, 8, 12
    x = rng.standard_normal((T, H)).astype(np.float32)
    w1 = rng.standard_normal((E, I, H)).astype(np.float32) * 0.2
    w2 = rng.standard_normal((E, H, I)).astype(np.float32) * 0.2
    w3 = rng.standard_normal((E, I, H)).astype(np.float32) * 0.2
    topi = rng.integers(0, 2, (T, K)).astype(np.int32)  # only experts 0/1 used
    topw = rng.random((T, K)).astype(np.float32)
    out = moe_ffn_sparse(*map(jnp.asarray, (x, w1, w2, w3, topi, topw)))
    np.testing.assert_allclose(np.asarray(out),
                               _dense_oracle(x, w1, w2, w3, topi, topw),
                               atol=2e-4, rtol=1e-4)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_moe_layer_sparse_equals_dense(rng):
    """llama._moe takes the sparse path at B*S>=32 and the dense path below; both
    must agree on the same weights and inputs."""
    cfg = LLMConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                    num_layers=1, num_heads=2, num_kv_heads=2, head_dim=8,
                    num_experts=4, num_experts_per_tok=2)
    params = llama.init(jax.random.PRNGKey(0), cfg)
    lp = params["layers"][0]
    x = jnp.asarray(rng.standard_normal((2, 32, 16)).astype(np.float32))
    sparse = llama._moe(lp, x, cfg)[0]                    # 64 tokens -> sparse
    dense = jnp.concatenate([llama._moe(lp, x[:, i:i+8], cfg)[0]
                             for i in range(0, 32, 8)], axis=1)  # 16 toks -> dense
    np.testing.assert_allclose(np.asarray(sparse), np.asarray(dense),
                               atol=2e-5, rtol=1e-4)


def test_mixtral_forward_and_grad(rng):
    """End-to-end Mixtral-config forward + grad through the sparse path."""
    cfg = LLMConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                    num_layers=2, num_heads=2, num_kv_heads=2, head_dim=8,
                    num_experts=4, num_experts_per_tok=2)
    params = llama.init(jax.random.PRNGKey(1), cfg)
    ids = jnp.asarray(rng.integers(0, 64, (2, 40)).astype(np.int32))

    def loss(p):
        h = llama.embed(p, ids)
        out, _ = llama.forward(p, h, cfg)
        return jnp.mean(out.astype(jnp.float32) ** 2)

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    assert np.isfinite(float(val))
    gnorm = jax.tree_util.tree_reduce(
        lambda a, g: a + float(jnp.sum(jnp.abs(g))), grads, 0.0)
    assert np.isfinite(gnorm) and gnorm > 0


def _hf_aux_oracle(logits, top_k):
    """numpy transcription of HF transformers load_balancing_loss_func semantics."""
    T, E = logits.reshape(-1, logits.shape[-1]).shape
    lg = logits.reshape(T, E).astype(np.float64)
    probs = np.exp(lg - lg.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    sel = np.argsort(-lg, axis=-1)[:, :top_k]                 # [T, K]
    onehot = np.zeros((T, top_k, E))
    for t in range(T):
        for j in range(top_k):
            onehot[t, j, sel[t, j]] = 1.0
    tokens_per_expert = onehot.mean(0)                        # [K, E]
    router_prob = probs.mean(0)                               # [E]
    return float((tokens_per_expert * router_prob[None]).sum() * E)


def test_router_aux_matches_hf_formula(rng):
    E, K = 8, 2
    logits = rng.standard_normal((2, 20, E)).astype(np.float32)
    lg = jnp.asarray(logits)
    _, topi = jax.lax.top_k(lg, K)
    aux = llama._router_aux(lg, topi, E)
    np.testing.assert_allclose(float(aux), _hf_aux_oracle(logits, K), rtol=1e-5)
    # perfectly balanced routing gives ~top_k (the HF-normalized optimum)
    bal = jnp.asarray(np.tile(np.eye(E, dtype=np.float32), (1, 16, 1))[:, :E])
    _, ti = jax.lax.top_k(bal * 10, K)
    assert abs(float(llama._router_aux(bal * 10, ti, E))) < 2 * K + 1


@pytest.mark.slow
def test_aux_loss_in_training(rng):
    """loss_fn adds coef*aux for MoE configs; the aux matches between scan and
    unrolled layer paths; dense configs are unaffected."""
    from dataclasses import replace
    from slime_jax.config import SliMEConfig
    from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from slime_jax.models import slime

    cfg0 = SliMEConfig.tiny()
    cfg = replace(cfg0, llm=replace(cfg0.llm, num_experts=4,
                                    num_experts_per_tok=2,
                                    router_aux_loss_coef=0.02))
    params = slime.init(jax.random.PRNGKey(0), cfg)
    B, S = 2, 24
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    batch = {"input_ids": jnp.asarray(ids),
             "attention_mask": jnp.ones((B, S), bool),
             "pixel_values": jnp.asarray(
                 rng.standard_normal((B, MC, 3, t, t)).astype(np.float32)),
             "crop_mask": jnp.asarray(np.ones((B, MC), bool)),
             "labels": jnp.asarray(
                 np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids))}
    loss, m = slime.loss_fn(params, cfg, batch, training=False)
    assert "router_aux_loss" in m and float(m["router_aux_loss"]) > 0
    loss_s, m_s = slime.loss_fn(params, cfg, batch, training=False,
                                scan_layers=True)
    np.testing.assert_allclose(float(loss), float(loss_s), rtol=1e-5)
    np.testing.assert_allclose(float(m["router_aux_loss"]),
                               float(m_s["router_aux_loss"]), rtol=1e-5)
    # coef=0 -> plain CE, no aux key
    cfg_off = replace(cfg, llm=replace(cfg.llm, router_aux_loss_coef=0.0))
    loss_off, m_off = slime.loss_fn(params, cfg_off, batch, training=False)
    assert "router_aux_loss" not in m_off
    assert float(loss_off) < float(loss)  # aux term strictly added
    # gradients flow through the aux term (gate gets a balancing signal)
    g = jax.grad(lambda p: slime.loss_fn(p, cfg, batch, training=False)[0])(params)
    gate_g = g["llm"]["layers"][0]["gate"]["weight"]
    assert float(jnp.sum(jnp.abs(gate_g))) > 0
