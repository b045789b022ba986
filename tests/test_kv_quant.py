"""int8 KV cache: quantization error bounds, decode/prefill-chunk parity with
the float cache, generate() end-to-end, and the engine option.

The quantized cache stores K/V int8 with per-(position, head) absmax scales;
attention applies the scales on the SCORES (they commute through q·k_t and
p_t·v_t), so the int8 tensors feed the dots directly. Expected error is the
int8 rounding of K/V (~0.4% rms per element)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import LLMConfig, SliMEConfig
from slime_jax.models import llama, slime
from slime_jax.generate import generate
from slime_jax.serve.batch_engine import BatchDecodeEngine, Request


@pytest.fixture(scope="module")
def tiny_llm():
    cfg = LLMConfig.tiny()
    params = llama.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def test_quantize_kv_roundtrip():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 7, 2, 32)).astype(np.float32))
    q, scale = llama.quantize_kv(x)
    back = q.astype(jnp.float32) * scale[..., None]
    rel = float(jnp.max(jnp.abs(back - x)) / jnp.max(jnp.abs(x)))
    assert q.dtype == jnp.int8 and rel < 0.01, rel


def _prefilled_caches(cfg, params, B=2, S=9, T=64):
    rng = np.random.default_rng(1)
    ids = jnp.asarray(rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32))
    emb = llama.embed(params, ids).astype(jnp.float32)
    logits, kvs = llama.forward(params, emb, cfg, return_kv=True)
    lengths = jnp.full((B,), S)
    cf = llama.prefill_into_cache(llama.init_kv_cache(cfg, B, T), kvs, lengths)
    cq = llama.prefill_into_cache(
        llama.init_kv_cache(cfg, B, T, quantized=True), kvs, lengths)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    return cf, cq, tok


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_decode_step_quant_close(tiny_llm):
    cfg, params = tiny_llm
    cf, cq, tok = _prefilled_caches(cfg, params)
    lf, cf2 = llama.decode_step(params, cf, tok, cfg)
    lq, cq2 = llama.decode_step(params, cq, tok, cfg)
    assert cq2["k"].dtype == jnp.int8
    scale = float(jnp.max(jnp.abs(lf)))
    err = float(jnp.max(jnp.abs(lf - lq))) / scale
    assert err < 0.05, err
    assert jnp.array_equal(jnp.argmax(lf, -1), jnp.argmax(lq, -1))
    # window composes with quantization
    lw, _ = llama.decode_step(params, cq, tok, cfg, window=32)
    assert jnp.array_equal(lq, lw)  # same content within 32 positions


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_prefill_chunk_quant_close(tiny_llm):
    cfg, params = tiny_llm
    cf, cq, _ = _prefilled_caches(cfg, params)
    rng = np.random.default_rng(2)
    chunk = jnp.asarray(rng.standard_normal(
        (2, 5, cfg.hidden_size)).astype(np.float32)) * 0.3
    lf, cf2 = llama.prefill_chunk(params, cf, chunk, cfg)
    lq, cq2 = llama.prefill_chunk(params, cq, chunk, cfg)
    assert cq2["k"].dtype == jnp.int8 and "k_scale" in cq2
    assert int(cq2["length"][0]) == int(cf2["length"][0])
    scale = float(jnp.max(jnp.abs(lf)))
    err = float(jnp.max(jnp.abs(lf - lq))) / scale
    assert err < 0.05, err


def test_generate_kv_quant(tiny_llm):
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 8)).astype(np.int32)
    mask = np.ones((1, 8), bool)
    ref = np.asarray(generate(params, cfg, ids, mask, max_new_tokens=6,
                              eos_id=-1))
    got = np.asarray(generate(params, cfg, ids, mask, max_new_tokens=6,
                              eos_id=-1, kv_quant=True))
    # int8 KV error can flip late greedy picks on a random tiny model; the
    # first steps must agree
    assert got.shape == ref.shape
    assert (got[0, :3] == ref[0, :3]).all(), (got, ref)


def test_engine_kv_quant():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=64,
                            kv_quant=True)
    assert eng.cache["k"].dtype == jnp.int8 and "k_scale" in eng.cache
    rng = np.random.default_rng(4)
    ids = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)
    req = Request(input_ids=ids, max_new_tokens=4)
    eng.submit(req)
    for _ in range(20):
        if eng.tick() == 0 and eng.pending.empty():
            break
    toks = []
    for chunk in req.stream():
        toks.extend(chunk)
    assert len(toks) >= 1
    ref = np.asarray(generate(params, cfg, ids[None], np.ones((1, 6), bool),
                              max_new_tokens=4, eos_id=-1))[0].tolist()
    assert toks[0] == ref[0]
