"""layers.linear over quantized weights vs a float64 numpy dequant matmul.

Every quantized format (int8, q4, q4g, NF4) runs as dequantize_weight + one
einsum; these pin that path at the shapes the old fused kernels covered.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from slime_jax.models import layers as L
from slime_jax.ops.quantization import (dequantize_weight, quantize_weight,
                                        quantize_weight_q4g)


def _oracle(x, qw, bias=None):
    w = np.asarray(dequantize_weight(qw), np.float64)
    y = np.asarray(x, np.float64) @ np.swapaxes(w, -1, -2)
    return y if bias is None else y + np.asarray(bias, np.float64)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(256, 128), (384, 256)])
def test_linear_matches_dequant(rng, bits, shape):
    OUT, IN = shape
    w = jnp.asarray(rng.standard_normal((OUT, IN)).astype(np.float32)) * 0.05
    qw = quantize_weight(w, bits)
    x = jnp.asarray(rng.standard_normal((2, IN)).astype(np.float32))
    out = L.linear({"weight": qw}, x)
    np.testing.assert_allclose(np.asarray(out), _oracle(x, qw),
                               atol=1e-4, rtol=1e-4)


def test_linear_uneven_out_dim(rng):
    w = jnp.asarray(rng.standard_normal((320, 128)).astype(np.float32)) * 0.05
    qw = quantize_weight(w, 4)
    x = jnp.asarray(rng.standard_normal((1, 128)).astype(np.float32))
    out = L.linear({"weight": qw}, x)
    np.testing.assert_allclose(np.asarray(out), _oracle(x, qw),
                               atol=1e-4, rtol=1e-4)


def test_linear_many_rows(rng):
    """Prefill-sized activations (rows not a power of two)."""
    w = rng.standard_normal((96, 64)).astype(np.float32)
    x = rng.standard_normal((300, 64)).astype(np.float32)
    for bits in (8, 4):
        qw = quantize_weight(jnp.asarray(w), bits=bits)
        y = L.linear({"weight": qw}, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), _oracle(x, qw),
                                   atol=2e-3, rtol=2e-3)


def test_q4g_numerics_equal_grouped_q4(rng):
    w = jnp.asarray(rng.standard_normal((64, 512)).astype(np.float32)) * 0.05
    a = dequantize_weight(quantize_weight(w, 4, group=128))
    b = dequantize_weight(quantize_weight_q4g(w, group=128))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_q4g_prestacked_layer_dim(rng):
    """Packing/scales act on the LAST dim of [L, out, in] trees (the stacked
    layout the decode scan consumes)."""
    w = jnp.asarray(rng.standard_normal((2, 32, 256)).astype(np.float32)) * 0.05
    qw = quantize_weight_q4g(w, group=128)
    assert qw["q4g"].shape == (2, 32, 128)
    assert qw["scale"].shape == (2, 32, 2)
    a = dequantize_weight(quantize_weight(w, 4, group=128))
    np.testing.assert_array_equal(np.asarray(dequantize_weight(qw)),
                                  np.asarray(a))


@pytest.mark.parametrize("shape", [(256, 512), (384, 1024), (320, 768)])
def test_linear_q4g_matches_dequant(rng, shape):
    OUT, IN = shape
    w = jnp.asarray(rng.standard_normal((OUT, IN)).astype(np.float32)) * 0.05
    qw = quantize_weight_q4g(w, group=128)
    x = jnp.asarray(rng.standard_normal((3, IN)).astype(np.float32))
    out = L.linear({"weight": qw}, x)
    np.testing.assert_allclose(np.asarray(out), _oracle(x, qw),
                               atol=1e-4, rtol=1e-4)


def test_linear_q4g_leading_dims_and_bias(rng):
    w = jnp.asarray(rng.standard_normal((64, 256)).astype(np.float32)) * 0.05
    p = {"weight": quantize_weight_q4g(w, group=128),
         "bias": jnp.asarray(rng.standard_normal((64,)).astype(np.float32))}
    x = jnp.asarray(rng.standard_normal((2, 5, 256)).astype(np.float32))
    out = L.linear(p, x)
    np.testing.assert_allclose(np.asarray(out),
                               _oracle(x, p["weight"], p["bias"]),
                               atol=1e-4, rtol=1e-4)


def test_quantize_params_group_scheme(rng):
    from slime_jax.ops.quantization import quantize_params

    tree = {"big": jnp.asarray(rng.standard_normal((512, 512)).astype(np.float32)),
            "small": jnp.asarray(rng.standard_normal((8, 8)).astype(np.float32))}
    qt = quantize_params(tree, bits=4, min_size=1024, scheme="group")
    assert "q4g" in qt["big"] and qt["big"]["scale"].shape == (512, 4)
    assert not isinstance(qt["small"], dict) or "q4g" not in qt["small"]
