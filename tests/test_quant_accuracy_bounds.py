"""Accuracy bounds for quantized serving at TRUE 8B shapes (VERDICT r2 #3).

CI-sized guard behind the on-chip measurement (scripts/bench_quant_accuracy.py,
results in docs/Serving.md): one transformer layer at exact Llama-3-8B width
(H=4096, I=14336) plus the exact lm_head (128256 x 4096), synthetic weights.
If a future kernel/packing change degrades int8 (or improves int4) fidelity,
these bounds move and the test fails.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import LLMConfig
from slime_jax.models import llama
from slime_jax.ops.quantization import quantize_weight

H, I, V = 4096, 14336, 128256


def _w(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.02)


@pytest.fixture(scope="module")
def layer_setup():
    base = LLMConfig.llama3_8b()
    cfg = LLMConfig(**{**base.__dict__, "num_layers": 1})
    rng = np.random.default_rng(0)
    layer = {
        "input_layernorm": {"weight": jnp.ones((H,))},
        "q_proj": {"weight": _w(rng, cfg.num_heads * cfg.head_dim, H)},
        "k_proj": {"weight": _w(rng, cfg.num_kv_heads * cfg.head_dim, H)},
        "v_proj": {"weight": _w(rng, cfg.num_kv_heads * cfg.head_dim, H)},
        "o_proj": {"weight": _w(rng, cfg.num_heads * cfg.head_dim, H)},
        "post_attention_layernorm": {"weight": jnp.ones((H,))},
        "gate_proj": {"weight": _w(rng, I, H)},
        "up_proj": {"weight": _w(rng, I, H)},
        "down_proj": {"weight": _w(rng, H, I)},
    }
    x = jnp.asarray(rng.standard_normal((1, 8, H)).astype(np.float32))
    cos, sin = llama.rope_table(cfg, 8)
    ref, _, _ = llama._layer_prefill(layer, x, cos, sin, cfg, False)
    return cfg, layer, x, cos, sin, ref


def _quant_layer(layer, bits):
    return {k: ({"weight": quantize_weight(v["weight"], bits)}
                if v["weight"].ndim == 2 and "proj" in k else v)
            for k, v in layer.items()}


@pytest.mark.slow
def test_int8_layer_error_at_8b_width(layer_setup):
    cfg, layer, x, cos, sin, ref = layer_setup
    out, _, _ = llama._layer_prefill(_quant_layer(layer, 8), x, cos, sin,
                                     cfg, False)
    rel = float(jnp.mean(jnp.abs(out - ref)) / (jnp.std(ref) + 1e-9))
    # measured ~0.006 at r3; int8 per-row absmax stays comfortably tight
    assert rel < 0.02, rel


@pytest.mark.slow
def test_int4_layer_error_at_8b_width(layer_setup):
    """int4 per-row absmax is an order of magnitude looser — the documented
    reason docs/Serving.md positions int4 as a capacity/draft option. Bounds
    hold it in a band: a change that silently made it WORSE (>0.6) or a fix
    that made it better (<0.05, meaning the doc guidance is stale) both
    fail."""
    cfg, layer, x, cos, sin, ref = layer_setup
    out, _, _ = llama._layer_prefill(_quant_layer(layer, 4), x, cos, sin,
                                     cfg, False)
    rel = float(jnp.mean(jnp.abs(out - ref)) / (jnp.std(ref) + 1e-9))
    assert 0.05 < rel < 0.6, rel


@pytest.mark.slow
def test_int8_lm_head_at_8b_vocab(layer_setup):
    """int8 lm_head at the exact 128256x4096 shape: logit KL and top-1
    agreement bounds behind the --quantize-lm-head opt-in."""
    rng = np.random.default_rng(1)
    w = _w(rng, V, H)
    x = jnp.asarray(rng.standard_normal((32, H)).astype(np.float32))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True) * np.sqrt(H)  # rms ~1
    ref = x @ w.T
    qw = quantize_weight(w, 8)
    from slime_jax.ops.quantization import dequantize_weight
    got = x @ dequantize_weight(qw).T

    lref = jax.nn.log_softmax(ref, -1)
    lgot = jax.nn.log_softmax(got, -1)
    kl = float(jnp.mean(jnp.sum(jnp.exp(lref) * (lref - lgot), -1)))
    agree = float(jnp.mean((jnp.argmax(ref, -1) == jnp.argmax(got, -1))))
    rel = float(jnp.mean(jnp.abs(ref - got)) / (jnp.std(ref) + 1e-9))
    assert kl < 5e-3, kl
    assert rel < 0.02, rel
    # random near-flat logits are the worst case for argmax stability; the
    # sharp (trained-like) regime measured on-chip agrees far higher
    assert agree > 0.5, agree


@pytest.mark.slow
def test_int4_g128_layer_error_at_8b_width(layer_setup):
    """Group-128 absmax int4 (the fused q4g path) must improve on per-row
    int4 — the quality claim behind --int4-scheme group. On gaussian weights
    the per-layer gain is the absmax statistic sqrt(2 ln 4096)/sqrt(2 ln 128)
    ~= 1.31x (measured 0.220 vs 0.298 = 1.35x); the band pins that ratio —
    materially better than per-row, still int4-class (not silently int8)."""
    from slime_jax.ops.quantization import quantize_weight_q4g

    cfg, layer, x, cos, sin, ref = layer_setup
    ql = {k: ({"weight": quantize_weight_q4g(v["weight"], group=128)}
              if v["weight"].ndim == 2 and "proj" in k else v)
          for k, v in layer.items()}
    out, _, _ = llama._layer_prefill(ql, x, cos, sin, cfg, False)
    rel = float(jnp.mean(jnp.abs(out - ref)) / (jnp.std(ref) + 1e-9))
    out4, _, _ = llama._layer_prefill(_quant_layer(layer, 4), x, cos, sin,
                                      cfg, False)
    rel4 = float(jnp.mean(jnp.abs(out4 - ref)) / (jnp.std(ref) + 1e-9))
    assert rel < 0.85 * rel4, (rel, rel4)
    assert rel > 0.02, rel  # still int4 — must not silently match int8
