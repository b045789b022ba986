"""Parity: JAX decoder vs HF LlamaForCausalLM (small random config, fp32 CPU),
plus KV-cache decode consistency."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax
import jax.numpy as jnp

from slime_jax import checkpoint as ckpt
from slime_jax.config import LLMConfig
from slime_jax.models import llama


@pytest.fixture(scope="module")
def small():
    cfg = LLMConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                    rope_theta=10000.0, max_position_embeddings=256)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-5,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).float().eval()
    sd = {k: ckpt._np(v) for k, v in hf.state_dict().items()}
    params = ckpt.to_jax(ckpt.convert_llama(sd, cfg))
    return cfg, hf, params


def test_forward_logits_parity(small):
    cfg, hf, params = small
    ids = torch.randint(0, 128, (2, 24))
    with torch.no_grad():
        ref = hf(ids).logits.numpy()
    embeds = llama.embed(params, jnp.asarray(ids.numpy()))
    logits, _ = llama.forward(params, embeds, cfg)
    np.testing.assert_allclose(np.asarray(logits), ref, atol=2e-4, rtol=1e-3)


def test_forward_with_positions(small):
    cfg, hf, params = small
    ids = torch.randint(0, 128, (1, 10))
    pos = torch.arange(5, 15)[None]
    with torch.no_grad():
        ref = hf(ids, position_ids=pos).logits.numpy()
    embeds = llama.embed(params, jnp.asarray(ids.numpy()))
    logits, _ = llama.forward(params, embeds, cfg, positions=jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(np.asarray(logits), ref, atol=2e-4, rtol=1e-3)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_decode_matches_prefill(small):
    """Greedy decode via KV cache must match argmax over a full re-forward."""
    cfg, _, params = small
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 8))
    S, steps, max_len = 8, 6, 32

    embeds = llama.embed(params, jnp.asarray(ids))
    logits, kvs = llama.forward(params, embeds, cfg, return_kv=True)
    cache = llama.init_kv_cache(cfg, 2, max_len)
    cache = llama.prefill_into_cache(cache, kvs, jnp.full((2,), S))

    cur = np.argmax(np.asarray(logits)[:, -1], axis=-1)
    seq = np.concatenate([ids, cur[:, None]], axis=1)
    for _ in range(steps):
        step_logits, cache = llama.decode_step(params, cache, jnp.asarray(cur), cfg)
        # oracle: full forward over the sequence so far
        full_logits, _ = llama.forward(params, llama.embed(params, jnp.asarray(seq)), cfg)
        np.testing.assert_allclose(np.asarray(step_logits), np.asarray(full_logits)[:, -1],
                                   atol=2e-4, rtol=1e-3)
        cur = np.argmax(np.asarray(step_logits), axis=-1)
        seq = np.concatenate([seq, cur[:, None]], axis=1)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_mixtral_moe_forward(small):
    """Mixtral-style MoE layer parity vs HF MixtralForCausalLM."""
    cfg = LLMConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                    rope_theta=10000.0, max_position_embeddings=256,
                    num_experts=4, num_experts_per_tok=2)
    hf_cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0,
        num_local_experts=4, num_experts_per_tok=2,
        attn_implementation="eager")
    torch.manual_seed(1)
    hf = transformers.MixtralForCausalLM(hf_cfg).float().eval()
    sd = {k: ckpt._np(v) for k, v in hf.state_dict().items()}
    params = ckpt.to_jax(ckpt.convert_llama(sd, cfg))
    ids = torch.randint(0, 128, (2, 12))
    with torch.no_grad():
        ref = hf(ids).logits.numpy()
    logits, _ = llama.forward(params, llama.embed(params, jnp.asarray(ids.numpy())), cfg)
    np.testing.assert_allclose(np.asarray(logits), ref, atol=5e-4, rtol=1e-3)

    # B*S = 40 >= 32: the sparse ragged_dot dispatch path, same HF oracle
    ids = torch.randint(0, 128, (2, 20))
    with torch.no_grad():
        ref = hf(ids).logits.numpy()
    logits, _ = llama.forward(params, llama.embed(params, jnp.asarray(ids.numpy())), cfg)
    np.testing.assert_allclose(np.asarray(logits), ref, atol=5e-4, rtol=1e-3)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_chunked_prefill_matches_full(small):
    """Prefill in 3 chunks == one full forward (logits of the last chunk match)."""
    cfg, _, params = small
    rng = np.random.default_rng(3)
    S, C = 12, 4
    ids = rng.integers(0, 128, (2, S)).astype(np.int32)
    embeds = llama.embed(params, jnp.asarray(ids))
    full_logits, _ = llama.forward(params, embeds, cfg)

    cache = llama.init_kv_cache(cfg, 2, 32)
    chunk_logits = []
    for s in range(0, S, C):
        lg, cache = llama.prefill_chunk(params, cache,
                                        embeds[:, s:s + C].astype(jnp.float32), cfg)
        chunk_logits.append(np.asarray(lg))
    got = np.concatenate(chunk_logits, axis=1)
    np.testing.assert_allclose(got, np.asarray(full_logits), atol=3e-4, rtol=1e-3)
    assert (np.asarray(cache["length"]) == S).all()

    # decode continues seamlessly from the chunked cache
    nxt = np.argmax(got[:, -1], -1).astype(np.int32)
    step_logits, cache = llama.decode_step(params, cache, jnp.asarray(nxt), cfg)
    seq = np.concatenate([ids, nxt[:, None]], axis=1)
    oracle, _ = llama.forward(params, llama.embed(params, jnp.asarray(seq)), cfg)
    np.testing.assert_allclose(np.asarray(step_logits), np.asarray(oracle)[:, -1],
                               atol=3e-4, rtol=1e-3)


def test_scan_layers_matches_unrolled(small):
    cfg, _, params = small
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (2, 10)).astype(np.int32)
    embeds = llama.embed(params, jnp.asarray(ids))
    l0, kv0 = llama.forward(params, embeds, cfg, return_kv=True)
    l1, kv1 = llama.forward(params, embeds, cfg, return_kv=True, scan_layers=True)
    np.testing.assert_allclose(np.asarray(l0), np.asarray(l1), atol=1e-5)
    for (a, b), (c, d) in zip(kv0, kv1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), atol=1e-5)
        np.testing.assert_allclose(np.asarray(b), np.asarray(d), atol=1e-5)
