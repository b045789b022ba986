"""W8A8 linear for the quantized vision tower: per-token int8 activations
times per-row int8 weights, accumulated in int32.

Replaces the fp16 CLIP tower matmuls of the reference
(llava/model/multimodal_encoder/clip_encoder.py:46-58) when the vision tower is
quantized (--quantize-vision, halves vision weight memory; accuracy budget in
docs/Serving.md). The chain is plain XLA, which can hand the int8 x int8 ->
int32 product to cuBLASLt:

    x [M, K]  --absmax/round-->  xq int8, xs f32 [M, 1]   (per token)
    xq . wq[OUT, K]^T            int8 dot, int32 accumulate
    y = i32 * xs * ws + bias     f32 epilogue -> x.dtype

Activation scales are per *token* (row of x), weight scales per output
channel, so the epilogue is a rank-1 scaling.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def w8a8_matmul(x, qw: dict, bias=None) -> jnp.ndarray:
    """x [M, K] @ dequant(qw).T with int8 activations -> [M, OUT] in x.dtype.

    qw: {"q": int8 [OUT, K], "scale": f32 [OUT, 1]} (per-row scales only —
    activation quant is per token, so the epilogue needs rank-1 scaling)."""
    q, scale = qw["q"], qw["scale"]
    if scale.shape[-1] != 1:
        raise ValueError("w8a8_matmul requires per-row weight scales")
    xf = x.astype(jnp.float32)
    am = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    xs = jnp.where(am > 0, am * (1.0 / 127.0), 1.0)
    xq = jnp.round(xf / xs).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, q, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * xs * scale[:, 0][None, :].astype(jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)[None, :]
    return y.astype(x.dtype)


def w8a8_linear(p: dict, x) -> jnp.ndarray:
    """Linear layer over a quant-dict param ({"weight": {"q", "scale"},
    "bias"?}) with int8 activations; handles leading batch dims."""
    lead = x.shape[:-1]
    y = w8a8_matmul(x.reshape(-1, x.shape[-1]), p["weight"], p.get("bias"))
    return y.reshape(*lead, -1)
