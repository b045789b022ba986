"""Blockwise 8-bit AdamW: optimizer-state quantization (bitsandbytes' role).

Adam moments are 8 bytes/param in fp32 — at 8B params that is 64 GB, more
than the weights and gradients combined, and the dominant term in the 70B
fit table (parallel/memory_plan.py). This transform stores BOTH moments as
int8 with per-256-block scales (~2.06 bytes/param, a 3.9x cut), the
bitsandbytes 8-bit-Adam recipe (the reference ecosystem's bnb optimizers;
the reference itself runs fp32 Adam under DeepSpeed) re-designed for
XLA: quantize/dequantize are pure elementwise-and-reshape ops that fuse
into the update, so the moments never exist in fp32 in HBM between steps —
only inside the fused update kernel.

Quantization: per-block absmax linear for m (signed); v is quantized in the
SQRT domain (store q ~ sqrt(v) linearly, square on dequant) — sqrt halves
the dynamic range in log terms and sqrt(v) is what the update consumes, so
the error lands where it is cheapest. Measured on Adam-shaped data the
sqrt-domain v error is ~10x smaller than linear-domain at the same width
(tests/test_opt8.py pins both bounds).

Use: TrainConfig(optim="adamw8bit") / train_slime.py --optim adamw8bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

BLOCK = 256


def _quantize(x, *, block: int = BLOCK):
    """fp32 array -> (int8 [nb, block], scale fp32 [nb, 1], n, shape)."""
    n = x.size
    flat = x.reshape(-1).astype(jnp.float32)
    pad = (-n) % block
    if pad:
        flat = jnp.pad(flat, (0, pad))
    blk = flat.reshape(-1, block)
    scale = jnp.max(jnp.abs(blk), axis=1, keepdims=True) / 127.0
    scale = jnp.where(scale > 0, scale, 1.0)
    q = jnp.clip(jnp.round(blk / scale), -127, 127).astype(jnp.int8)
    return q, scale


def _dequantize(q, scale, shape):
    n = 1
    for d in shape:
        n *= d
    return (q.astype(jnp.float32) * scale).reshape(-1)[:n].reshape(shape)


class Adam8State(NamedTuple):
    count: jnp.ndarray
    m_q: optax.Params       # tree of int8 blocks
    m_s: optax.Params       # tree of fp32 scales
    v_q: optax.Params       # sqrt-domain int8 blocks
    v_s: optax.Params


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8,
                      block: int = BLOCK) -> optax.GradientTransformation:
    """optax.scale_by_adam with int8 blockwise moment storage."""

    def init(params):
        def zq(p):
            nb = -(-p.size // block)
            return jnp.zeros((nb, block), jnp.int8)

        def zs(p):
            nb = -(-p.size // block)
            return jnp.zeros((nb, 1), jnp.float32)

        return Adam8State(
            count=jnp.zeros((), jnp.int32),
            m_q=jax.tree_util.tree_map(zq, params),
            m_s=jax.tree_util.tree_map(zs, params),
            v_q=jax.tree_util.tree_map(zq, params),
            v_s=jax.tree_util.tree_map(zs, params))

    def update(grads, state, params=None):
        count = state.count + 1
        bc1 = 1.0 - b1 ** count.astype(jnp.float32)
        bc2 = 1.0 - b2 ** count.astype(jnp.float32)

        def leaf(g, mq, ms, vq, vs):
            g32 = g.astype(jnp.float32)
            m = b1 * _dequantize(mq, ms, g.shape) + (1.0 - b1) * g32
            v_sqrt = _dequantize(vq, vs, g.shape)
            v = b2 * (v_sqrt * v_sqrt) + (1.0 - b2) * (g32 * g32)
            upd = (m / bc1) / (jnp.sqrt(v / bc2) + eps)
            mq2, ms2 = _quantize(m, block=block)
            vq2, vs2 = _quantize(jnp.sqrt(v), block=block)
            return upd.astype(g.dtype), mq2, ms2, vq2, vs2

        flat_g, treedef = jax.tree_util.tree_flatten(grads)
        flat_mq = treedef.flatten_up_to(state.m_q)
        flat_ms = treedef.flatten_up_to(state.m_s)
        flat_vq = treedef.flatten_up_to(state.v_q)
        flat_vs = treedef.flatten_up_to(state.v_s)
        outs = [leaf(*args) for args in
                zip(flat_g, flat_mq, flat_ms, flat_vq, flat_vs)]
        unflat = lambda i: jax.tree_util.tree_unflatten(
            treedef, [o[i] for o in outs])
        return unflat(0), Adam8State(count, unflat(1), unflat(2),
                                     unflat(3), unflat(4))

    return optax.GradientTransformation(init, update)


def adamw8bit(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0,
              mask: Optional[optax.Params] = None,
              block: int = BLOCK) -> optax.GradientTransformation:
    """Drop-in optax.adamw with ~2.06-byte/param optimizer state."""
    steps = [scale_by_adam8bit(b1=b1, b2=b2, eps=eps, block=block)]
    if weight_decay:
        steps.append(optax.add_decayed_weights(weight_decay, mask=mask))
    steps.append(optax.scale_by_learning_rate(learning_rate))
    return optax.chain(*steps)


def state_bytes(params) -> dict:
    """Analytic state-size comparison for a param tree (docs/plan use)."""
    n = sum(p.size for p in jax.tree_util.tree_leaves(params))
    nb = sum(-(-p.size // BLOCK) for p in jax.tree_util.tree_leaves(params))
    return {"params": n,
            "fp32_adam_bytes": 8 * n,
            "int8_adam_bytes": 2 * n + 8 * nb,
            "ratio": (8 * n) / (2 * n + 8 * nb)}
