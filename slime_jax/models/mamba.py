"""Minimal Mamba (S6) block — parity for the reference's dormant Mamba projector.

The reference carries a full Mamba implementation in
llava/model/multimodal_projector/mamba.py (584 LoC) that no builder references
(SURVEY.md §2.11: "keep as optional parity item"). JAX rebuild: the
sequential selective scan becomes a ``jax.lax.associative_scan`` over the affine
recurrence h_t = a_t * h_{t-1} + b_t (log-depth, parallel), and the
depthwise conv is a small explicit unroll.
"""
from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp

from . import layers as L


def init(rng, *, d_model: int, d_state: int = 16, d_conv: int = 4,
         expand: int = 2) -> Dict:
    d_inner = expand * d_model
    dt_rank = math.ceil(d_model / 16)
    k = jax.random.split(rng, 6)
    p = {
        "in_proj": L.linear_init(k[0], d_model, 2 * d_inner, bias=False),
        "conv_w": jax.random.normal(k[1], (d_inner, d_conv), jnp.float32)
                  * (1.0 / math.sqrt(d_conv)),
        "conv_b": jnp.zeros((d_inner,), jnp.float32),
        "x_proj": L.linear_init(k[2], d_inner, dt_rank + 2 * d_state, bias=False),
        "dt_proj": L.linear_init(k[3], dt_rank, d_inner),
        "A_log": jnp.log(jnp.broadcast_to(
            jnp.arange(1, d_state + 1, dtype=jnp.float32), (d_inner, d_state))),
        "D": jnp.ones((d_inner,), jnp.float32),
        "out_proj": L.linear_init(k[4], d_inner, d_model, bias=False),
        "norm": L.rms_norm_init(d_model),
    }
    return p


def _depthwise_conv(x, w, b, d_conv: int):
    """Causal depthwise conv1d: x [B, S, C], w [C, K] -> [B, S, C].
    y_t = sum_k w[:, k] * x_{t - (K-1) + k}, zero-padded on the left."""
    y = sum(jnp.pad(x, ((0, 0), (d_conv - 1 - k, 0), (0, 0)))[:, :x.shape[1]]
            * w[None, None, :, k] for k in range(d_conv))
    return y + b


def selective_scan(u, delta, A, B, C, D):
    """u [B,S,C]; delta [B,S,C]; A [C,N]; B,C_mat [B,S,N]; D [C] -> y [B,S,C].

    Recurrence per (channel c, state n): h = exp(delta*A) h + delta*B*u, computed
    in parallel with an associative scan over (multiplier, addend) pairs.
    """
    dA = jnp.exp(jnp.einsum("bsc,cn->bscn", delta, A))             # [B,S,C,N]
    dBu = jnp.einsum("bsc,bsn,bsc->bscn", delta, B, u)             # [B,S,C,N]

    def combine(x, y):
        a1, b1 = x
        a2, b2 = y
        return a1 * a2, a2 * b1 + b2

    _, h = jax.lax.associative_scan(combine, (dA, dBu), axis=1)
    y = jnp.einsum("bscn,bsn->bsc", h, C)
    return y + u * D[None, None]


def apply(p: Dict, x: jnp.ndarray, *, d_state: int = 16, d_conv: int = 4) -> jnp.ndarray:
    """Mamba block with pre-norm residual: x [B, S, d_model] -> same shape."""
    res = x
    x = L.rms_norm(p["norm"], x)
    xz = L.linear(p["in_proj"], x)
    xin, z = jnp.split(xz, 2, axis=-1)
    xin = _depthwise_conv(xin, p["conv_w"], p["conv_b"], d_conv)
    xin = jax.nn.silu(xin)

    dt_rank = p["dt_proj"]["weight"].shape[1]
    proj = L.linear(p["x_proj"], xin)
    dt, Bm, Cm = jnp.split(proj, [dt_rank, dt_rank + d_state], axis=-1)
    delta = jax.nn.softplus(L.linear(p["dt_proj"], dt))
    A = -jnp.exp(p["A_log"])
    y = selective_scan(xin, delta, A, Bm, Cm, p["D"])
    y = y * jax.nn.silu(z)
    return res + L.linear(p["out_proj"], y)
