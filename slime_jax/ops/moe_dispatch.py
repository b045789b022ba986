"""Dropless sparse MoE dispatch via sort + jax.lax.ragged_dot.

The naive static-shape MoE (models/llama.py:_moe dense path) runs every expert on
every token and masks — exact but E/k times the FLOPs (4x for Mixtral's top-2-of-8).
The classic GShard capacity dispatch recovers the FLOPs but drops tokens on expert
overflow, changing results vs the reference (HF Mixtral never drops at inference;
reference model family: /root/reference/llava/model/language_model/llava_mixtral.py).

This module is exact AND sparse: sort token->expert assignments by expert id, then
grouped-matmul the contiguous per-expert runs with jax.lax.ragged_dot (XLA's
grouped matmul; group_sizes is a dynamic-valued but static-shape [E]
vector, so everything stays jit-friendly with static shapes). FLOPs: k*T tokens of
FFN + one sort, vs E*T dense.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def moe_ffn_sparse(x, w1, w2, w3, topi, topw):
    """Exact top-k MoE SwiGLU FFN with grouped matmuls.

    x     [T, H]    flattened tokens
    w1,w3 [E, I, H] expert up/gate projections, w2 [E, H, I] down
    topi  [T, K]    int expert ids per token, topw [T, K] combine weights
    returns [T, H]
    """
    T, H = x.shape
    E, I, _ = w1.shape
    K = topi.shape[1]
    TK = T * K

    flat_e = topi.reshape(TK)
    # stable sort so equal-expert tokens keep order (deterministic accumulation)
    order = jnp.argsort(flat_e, stable=True)                       # [TK]
    tok_of = order // K                                            # source token
    xs = x[tok_of]                                                 # [TK, H]
    group_sizes = jnp.bincount(flat_e, length=E).astype(jnp.int32)

    # ragged_dot wants rhs [G, K, N]: contract H -> I then I -> H
    h1 = jax.lax.ragged_dot(xs, jnp.swapaxes(w1, 1, 2), group_sizes)
    h3 = jax.lax.ragged_dot(xs, jnp.swapaxes(w3, 1, 2), group_sizes)
    y = jax.lax.ragged_dot((jax.nn.silu(h1.astype(jnp.float32)).astype(x.dtype)
                            * h3),
                           jnp.swapaxes(w2, 1, 2), group_sizes)    # [TK, H]

    w = topw.reshape(TK)[order].astype(y.dtype)
    out = jnp.zeros((T, H), y.dtype).at[tok_of].add(y * w[:, None])
    return out
