"""The cached decode paths (decode_step, prefill_chunk) and the MLP/projection
matmuls against full-sequence forward() and float64 numpy references.

These are the XLA scan paths serving runs on every device, pinned across the
weight formats serving uses (fp32, int8, q4g; "_all" also quantizes q/k/v/o),
batch rows with different lengths, the int8 KV cache and window bucketing.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import LLMConfig
from slime_jax.models import llama
from slime_jax.ops.quantization import (dequantize_weight, quantize_weight,
                                        quantize_weight_q4g)

H, I = 256, 512


def _cfg(num_kv_heads=2):
    return LLMConfig(
        vocab_size=128, hidden_size=H, intermediate_size=I,
        num_layers=2, num_heads=4, num_kv_heads=num_kv_heads, head_dim=64,
        max_position_embeddings=64, rms_norm_eps=1e-5)


def _pack(w, fmt):
    if fmt == "int8":
        return quantize_weight(w, 8)
    if fmt == "q4g":
        return quantize_weight_q4g(w, group=128)
    return w


def _params(cfg, fmt: str, stacked: bool = True):
    """fmt: fp32 | int8 | q4g (MLP only) | int8_all | q4g_all (MLP + attn)."""
    params = llama.init(jax.random.PRNGKey(0), cfg)
    base, attn_too = (fmt[:-4], True) if fmt.endswith("_all") else (fmt, False)
    keys = ("gate_proj", "up_proj", "down_proj") + (
        ("q_proj", "k_proj", "v_proj", "o_proj") if attn_too else ())
    for lp in params["layers"]:
        for k in keys:
            lp[k]["weight"] = _pack(lp[k]["weight"], base)
    if stacked:
        params["layers"] = llama.stack_layers(params["layers"])
    return params


def _deq64(p):
    w = p["weight"]
    return np.asarray(dequantize_weight(w) if isinstance(w, dict) else w,
                      np.float64)


def _mlp_oracle(lp, x):
    x = np.asarray(x, np.float64)
    g = x @ _deq64(lp["gate_proj"]).T
    u = x @ _deq64(lp["up_proj"]).T
    return (g / (1 + np.exp(-g)) * u) @ _deq64(lp["down_proj"]).T


def _mlp_layer(rng, fmt):
    def w(o, i):
        return _pack(jnp.asarray(rng.standard_normal((o, i)).astype(np.float32)
                                 * 0.05), fmt)
    return {"gate_proj": {"weight": w(I, H)}, "up_proj": {"weight": w(I, H)},
            "down_proj": {"weight": w(H, I)}}


# ----------------------------------------------------------------------------
# MLP and projection matmuls
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("batch", [1, 4])
def test_mlp_matches_reference(rng, fmt, batch):
    lp = _mlp_layer(rng, fmt)
    x = jnp.asarray(rng.standard_normal((batch, H)).astype(np.float32))
    out = llama._mlp(lp, x)
    np.testing.assert_allclose(np.asarray(out), _mlp_oracle(lp, x),
                               atol=2e-4, rtol=2e-4)


def test_mlp_bf16_compute(rng):
    """bf16 activations (the serving compute dtype) stay within bf16 tolerance."""
    lp = _mlp_layer(rng, "int8")
    x = jnp.asarray(rng.standard_normal((2, H)).astype(np.float32))
    out = llama._mlp(lp, x.astype(jnp.bfloat16))
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(out, np.float32), _mlp_oracle(lp, x),
                               atol=0.08, rtol=0.08)


def test_stacked_q4g_slice_matches_per_layer(rng):
    """Slicing layer li out of a stacked q4g tree dequantizes to exactly that
    layer's weight (what the decode scan feeds linear())."""
    ws = [jnp.asarray(rng.standard_normal((I, H)).astype(np.float32) * 0.05)
          for _ in range(2)]
    stacked = quantize_weight_q4g(jnp.stack(ws), group=128)
    for li, w in enumerate(ws):
        sl = jax.tree_util.tree_map(lambda a: a[li], stacked)
        np.testing.assert_array_equal(
            np.asarray(dequantize_weight(sl)),
            np.asarray(dequantize_weight(quantize_weight_q4g(w, group=128))))


def test_stacked_layer_indexing(rng):
    """The scan over stacked layers picks each layer's own weights: stacked
    and list storage decode identically, and the layers differ."""
    cfg = LLMConfig(vocab_size=128, hidden_size=H, intermediate_size=I,
                    num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
                    max_position_embeddings=64)
    a = _params(cfg, "int8", stacked=True)
    b = _params(cfg, "int8", stacked=False)
    assert not np.allclose(np.asarray(b["layers"][0]["gate_proj"]["weight"]["q"]),
                           np.asarray(b["layers"][1]["gate_proj"]["weight"]["q"]))
    tok = jnp.asarray([5], jnp.int32)
    la, _ = llama.decode_step(a, llama.init_kv_cache(cfg, 1, 16), tok, cfg)
    lb, _ = llama.decode_step(b, llama.init_kv_cache(cfg, 1, 16), tok, cfg)
    np.testing.assert_allclose(np.asarray(la), np.asarray(lb),
                               atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------------
# decode_step / prefill_chunk vs forward()
# ----------------------------------------------------------------------------

def _embed(params, ids):
    return llama.embed(params, jnp.asarray(ids)).astype(jnp.float32)


def _forward_last(params, cfg, ids):
    """Logits of the last position of each row's own full forward."""
    out = []
    for row in ids:
        logits, _ = llama.forward(params, _embed(params, np.asarray(row)[None]),
                                  cfg)
        out.append(np.asarray(logits[0, -1]))
    return np.stack(out)


def _prefilled_cache(params, cfg, prompts, cache_len=32, **kw):
    """Cache holding each row's prompt (rows padded right to one length)."""
    S = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    _, kvs = llama.forward(params, _embed(params, ids), cfg, return_kv=True)
    cache = llama.init_kv_cache(cfg, len(prompts), cache_len, **kw)
    lengths = jnp.asarray([len(p) for p in prompts], jnp.int32)
    return llama.prefill_into_cache(cache, kvs, lengths)


def _prompts(rng, batch):
    return [list(rng.integers(3, 128, 3 + 2 * i)) for i in range(batch)]


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("batch", [1, 4])
def test_decode_step_matches_forward(rng, fmt, batch):
    cfg = _cfg()
    params = _params(cfg, fmt)
    prompts = _prompts(rng, batch)
    cache = _prefilled_cache(params, cfg, prompts)
    tok = rng.integers(3, 128, batch).astype(np.int32)
    logits, cache = llama.decode_step(params, cache, jnp.asarray(tok), cfg)
    ref = _forward_last(params, cfg, [p + [t] for p, t in zip(prompts, tok)])
    np.testing.assert_allclose(np.asarray(logits), ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(cache["length"]),
                                  [len(p) + 1 for p in prompts])


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
def test_prefill_chunk_matches_forward(rng, fmt):
    cfg = _cfg()
    params = _params(cfg, fmt)
    prompts = _prompts(rng, 2)
    cache = _prefilled_cache(params, cfg, prompts)
    chunk = rng.integers(3, 128, (2, 3)).astype(np.int32)
    logits, cache = llama.prefill_chunk(params, cache,
                                        _embed(params, chunk), cfg)
    ref = _forward_last(params, cfg,
                        [p + list(c) for p, c in zip(prompts, chunk)])
    np.testing.assert_allclose(np.asarray(logits[:, -1]), ref,
                               atol=2e-4, rtol=2e-4)


def test_decode_mqa_matches_forward(rng):
    """One kv head shared by all query heads (the group fold at its widest)."""
    cfg = _cfg(num_kv_heads=1)
    params = _params(cfg, "int8")
    prompts = _prompts(rng, 2)
    cache = _prefilled_cache(params, cfg, prompts)
    tok = np.asarray([7, 9], np.int32)
    logits, _ = llama.decode_step(params, cache, jnp.asarray(tok), cfg)
    ref = _forward_last(params, cfg, [p + [t] for p, t in zip(prompts, tok)])
    np.testing.assert_allclose(np.asarray(logits), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("fmt", ["int8", "q4g", "q4g_all"])
def test_greedy_decode_matches_forward(rng, fmt):
    """Three greedy decode steps == recomputing the whole sequence each step."""
    cfg = _cfg()
    params = _params(cfg, fmt)
    prompts = _prompts(rng, 2)
    cache = _prefilled_cache(params, cfg, prompts)
    seqs = [list(p) for p in prompts]
    tok = np.asarray([5, 9], np.int32)
    for _ in range(3):
        for s, t in zip(seqs, tok):
            s.append(int(t))
        logits, cache = llama.decode_step(params, cache, jnp.asarray(tok), cfg)
        np.testing.assert_allclose(np.asarray(logits),
                                   _forward_last(params, cfg, seqs),
                                   atol=2e-4, rtol=2e-4)
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)


def test_decode_int8_kv_and_window(rng):
    """int8 KV cache with a window bucket: within the int8 quantization error
    of the float cache, and the window changes nothing."""
    cfg = _cfg()
    params = _params(cfg, "int8")
    prompts = _prompts(rng, 2)
    cache_f = _prefilled_cache(params, cfg, prompts)
    cache_q = _prefilled_cache(params, cfg, prompts, quantized=True)
    cache_w = dict(cache_q)
    tok = jnp.asarray([3, 4], jnp.int32)
    for _ in range(3):
        lf, cache_f = llama.decode_step(params, cache_f, tok, cfg)
        lq, cache_q = llama.decode_step(params, cache_q, tok, cfg)
        lw, cache_w = llama.decode_step(params, cache_w, tok, cfg, window=16)
        np.testing.assert_allclose(np.asarray(lw), np.asarray(lq),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(lq), np.asarray(lf),
                                   atol=2e-2, rtol=2e-2)
        tok = jnp.argmax(lf, -1).astype(jnp.int32)
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_allclose(np.asarray(cache_w[key], np.float32),
                                   np.asarray(cache_q[key], np.float32),
                                   atol=1.0 if key in ("k", "v") else 1e-6)


def test_decode_window_equals_full_cache(rng):
    cfg = _cfg()
    params = _params(cfg, "q4g")
    prompts = _prompts(rng, 2)
    cache_a = _prefilled_cache(params, cfg, prompts)
    cache_b = dict(cache_a)
    tok = jnp.asarray([11, 12], jnp.int32)
    la, cache_a = llama.decode_step(params, cache_a, tok, cfg)
    lb, cache_b = llama.decode_step(params, cache_b, tok, cfg, window=8)
    np.testing.assert_allclose(np.asarray(lb), np.asarray(la),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(cache_b["k"]),
                                   np.asarray(cache_a["k"]), atol=1e-6)


@pytest.mark.parametrize("fmt", ["int8_all", "q4g"])
@pytest.mark.parametrize("quant_kv", [False, True])
def test_prefill_chunk_matches_decode_steps(rng, fmt, quant_kv):
    """A C-token chunk at per-row offsets == C single-token decode steps
    (the speculative-verify regime), float and int8 KV."""
    cfg = _cfg()
    params = _params(cfg, fmt)
    prompts = _prompts(rng, 2)
    cache_a = _prefilled_cache(params, cfg, prompts, quantized=quant_kv)
    cache_b = dict(cache_a)
    chunk = rng.integers(3, 128, (2, 3)).astype(np.int32)
    la, cache_a = llama.prefill_chunk(params, cache_a, _embed(params, chunk),
                                      cfg, window=16)
    for c in range(3):
        lb, cache_b = llama.decode_step(params, cache_b,
                                        jnp.asarray(chunk[:, c]), cfg,
                                        window=16)
        np.testing.assert_allclose(np.asarray(la[:, c]), np.asarray(lb),
                                   atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(cache_a["length"]),
                                  np.asarray(cache_b["length"]))
    for key in ("k", "v"):
        a = np.asarray(cache_a[key], np.float32)
        b = np.asarray(cache_b[key], np.float32)
        # quantized caches may differ by one int8 level where the two paths'
        # fp32 sums round across a quantization boundary
        np.testing.assert_allclose(a, b, atol=1.0 if quant_kv else 2e-4)


def test_q4g_all_stacked_matches_list(rng):
    """q4g on every projection decodes the same from stacked and list storage."""
    cfg = _cfg()
    a = _params(cfg, "q4g_all", stacked=True)
    b = _params(cfg, "q4g_all", stacked=False)
    tok = jnp.asarray([7], jnp.int32)
    la, _ = llama.decode_step(a, llama.init_kv_cache(cfg, 1, 16), tok, cfg)
    lb, _ = llama.decode_step(b, llama.init_kv_cache(cfg, 1, 16), tok, cfg)
    np.testing.assert_allclose(np.asarray(la), np.asarray(lb),
                               atol=1e-5, rtol=1e-5)
