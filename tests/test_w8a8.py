"""W8A8 matmul vs a numpy integer reference, plus the quantized ViT tower's
accuracy bound vs the fp32 tower.

The reference runs the CLIP tower in fp16 (llava/model/multimodal_encoder/
clip_encoder.py:46-58); W8A8 is an opt-in that trades a bounded feature error
(~2% relative) for half the vision weight memory.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.ops.quantization import quantize_weight
from slime_jax.ops.w8a8_matmul import w8a8_linear, w8a8_matmul


def _int_oracle(x, qw, bias=None):
    """Same per-token round-to-nearest quant, exact int64 products in numpy."""
    xf = np.asarray(x, np.float32)
    am = np.max(np.abs(xf), axis=-1, keepdims=True)
    xs = np.where(am > 0, am * np.float32(1.0 / 127.0), np.float32(1.0))
    xq = np.round(xf / xs).astype(np.int64)
    acc = xq @ np.asarray(qw["q"], np.int64).T
    y = acc.astype(np.float64) * xs * np.asarray(qw["scale"])[:, 0][None, :]
    return y if bias is None else y + np.asarray(bias, np.float64)[None, :]


@pytest.mark.parametrize("M,K,OUT", [(256, 128, 128), (300, 256, 192)])
def test_matmul_matches_int_oracle(rng, M, K, OUT):
    """The quant + int32 accumulate are exact; only the f32 epilogue rounds."""
    w = jnp.asarray(rng.standard_normal((OUT, K)).astype(np.float32)) * 0.05
    qw = quantize_weight(w, 8)
    x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((OUT,)).astype(np.float32))
    out = w8a8_matmul(x, qw, b)
    np.testing.assert_allclose(np.asarray(out), _int_oracle(x, qw, b),
                               atol=1e-5, rtol=1e-4)


def test_matmul_bf16_output_dtype(rng):
    x = jnp.asarray(rng.standard_normal((128, 128)), jnp.bfloat16)
    qw = quantize_weight(
        jnp.asarray(rng.standard_normal((128, 128)).astype(np.float32)) * 0.05, 8)
    out = w8a8_matmul(x, qw)
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               _int_oracle(np.asarray(x, np.float32), qw),
                               atol=1e-2, rtol=1e-2)


def test_w8a8_accuracy_vs_fp(rng):
    """Against the fp matmul, W8A8 (weight + per-token activation quant) stays
    within ~2% relative error on gaussian data at a real layer shape
    (measured 1.1% — absmax/127 quant noise on both operands)."""
    K, OUT = 1024, 1024
    w = jnp.asarray(rng.standard_normal((OUT, K)).astype(np.float32)) * 0.02
    x = jnp.asarray(rng.standard_normal((64, K)).astype(np.float32))
    qw = quantize_weight(w, 8)
    ref = x @ w.T
    out = w8a8_matmul(x, qw).astype(jnp.float32)
    rel = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
    assert rel < 0.02, rel


def test_w8a8_linear_leading_dims(rng):
    x = jnp.asarray(rng.standard_normal((2, 3, 128)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((64, 128)).astype(np.float32)) * 0.05
    p = {"weight": quantize_weight(w, 8),
         "bias": jnp.asarray(rng.standard_normal((64,)).astype(np.float32))}
    out = w8a8_linear(p, x)
    assert out.shape == (2, 3, 64)
    ref = _int_oracle(np.asarray(x).reshape(-1, 128), p["weight"], p["bias"])
    np.testing.assert_allclose(np.asarray(out).reshape(-1, 64), ref,
                               atol=1e-5, rtol=1e-4)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_quantized_vit_feature_error_bounded(rng):
    """quantize_tower + the W8A8 path stays within 4% relative feature error
    of the fp32 tower on a small ViT — the CI guard for the vision quant
    accuracy budget (docs/Serving.md; measured 1.9% at CLIP-L scale)."""
    from slime_jax.config import VisionConfig
    from slime_jax.models import vit

    cfg = VisionConfig(image_size=56, patch_size=14, hidden_size=128,
                       intermediate_size=256, num_layers=3, num_heads=4,
                       select_layer=-2)
    params = vit.init(jax.random.PRNGKey(0), cfg)
    qparams = vit.quantize_tower(params, cfg)
    # only the layers that run are quantized; the skipped tail layer is not
    assert isinstance(qparams["layers"][0]["fc1"]["weight"], dict)
    assert "qkv" in qparams["layers"][0]
    assert "q_proj" in qparams["layers"][-1]

    pix = jnp.asarray(rng.standard_normal((2, 3, 56, 56)).astype(np.float32))
    ref = vit.apply(params, pix, cfg)
    got = vit.apply(qparams, pix, cfg)
    assert got.shape == ref.shape
    rel = float(jnp.linalg.norm(got.astype(jnp.float32) - ref)
                / jnp.linalg.norm(ref))
    assert rel < 0.04, rel
