"""Ring attention: exact causal attention over sequence-sharded inputs.

A capability the reference lacks entirely (SURVEY.md §5: "No ring attention,
blockwise attention, Ulysses, or context parallelism exists"; long visual context is
handled by token compression). This goes beyond the reference: with the
sequence sharded over a mesh axis, each device holds one KV block and rotates it
around the ring (jax.lax.ppermute, NCCL on GPUs) while accumulating its queries' partial
attention with online-softmax merging — exact results, S/n memory per device, and
overlap-friendly communication.

Implemented with shard_map + XLA collectives (the compiler schedules ppermute
against compute); this is the only context-parallel attention path.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

NEG_INF = -1e30


def _block_attend(q, k, v, scale, *, q_start, k_start, causal):
    """Partial attention of q [B,KVH,G,Sq,D] against one kv block [B,KVH,Sk,D]
    (GQA-native: the G query heads of a group share their kv head — the kv block
    is never materialized per-query-head, so the ring moves KVH-sized blocks).

    Returns (m, l [B,KVH,G,Sq,1], acc [B,KVH,G,Sq,D]) — unnormalized softmax
    statistics for later merging."""
    s = jnp.einsum("bhgqd,bhkd->bhgqk", q, k,
                   preferred_element_type=jnp.float32) * scale
    if causal:
        qi = q_start + jnp.arange(q.shape[3])[:, None]
        kj = k_start + jnp.arange(k.shape[2])[None, :]
        s = jnp.where((qi >= kj)[None, None, None], s, NEG_INF)
    m = jnp.max(s, axis=-1, keepdims=True)
    m = jnp.maximum(m, NEG_INF)  # all-masked rows stay finite
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    acc = jnp.einsum("bhgqk,bhkd->bhgqd", p.astype(v.dtype), v,
                     preferred_element_type=jnp.float32)
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    m = jnp.maximum(m1, m2)
    c1 = jnp.exp(m1 - m)
    c2 = jnp.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1 + a2 * c2


def ring_attention(q, k, v, *, mesh: Mesh, axis: str = "sp",
                   causal: bool = True, scale: Optional[float] = None):
    """q [B, H, S, D], k/v [B, KVH, S, D] (KVH divides H; pass KVH == H for MHA),
    all sharded on S over mesh axis ``axis``; returns attention output with q's
    sharding. Exact (matches full attention). GQA-native: only KVH-head kv
    blocks rotate around the ring — group-size-times less traffic than
    repeating kv to H heads."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = mesh.shape[axis]
    B, H, S, D = q.shape
    KVH = k.shape[1]
    assert H % KVH == 0, (H, KVH)
    G = H // KVH

    def local_fn(q_blk, k_blk, v_blk):
        # q_blk [B, H, S/n, D] on this device; kv [B, KVH, S/n, D]
        idx = jax.lax.axis_index(axis)
        s_blk = q_blk.shape[2]
        q_start = idx * s_blk

        qf = q_blk.reshape(B, KVH, G, s_blk, D).astype(jnp.float32)
        m = jnp.full((B, KVH, G, s_blk, 1), NEG_INF, jnp.float32)
        l = jnp.zeros_like(m)
        acc = jnp.zeros(qf.shape, jnp.float32)

        def body(step, carry):
            m, l, acc, k_cur, v_cur = carry
            # kv block originally owned by device (idx - step) mod n
            src = (idx - step) % n
            k_start = src * s_blk
            bm, bl, bacc = _block_attend(qf, k_cur.astype(jnp.float32),
                                         v_cur, scale,
                                         q_start=q_start, k_start=k_start,
                                         causal=causal)
            m, l, acc = _merge(m, l, acc, bm, bl, bacc.astype(jnp.float32))
            # rotate kv to the next device (receive from the previous)
            perm = [(i, (i + 1) % n) for i in range(n)]
            k_nxt = jax.lax.ppermute(k_cur, axis, perm)
            v_nxt = jax.lax.ppermute(v_cur, axis, perm)
            return m, l, acc, k_nxt, v_nxt

        m, l, acc, _, _ = jax.lax.fori_loop(
            0, n, body, (m, l, acc, k_blk, v_blk))
        l_safe = jnp.where(l == 0.0, 1.0, l)
        return (acc / l_safe).astype(q_blk.dtype).reshape(B, H, s_blk, D)

    spec = P(None, None, axis, None)
    try:
        from jax import shard_map  # jax >= 0.6 public API (no check_rep kwarg)
        return shard_map(local_fn, mesh=mesh, in_specs=(spec, spec, spec),
                         out_specs=spec)(q, k, v)
    except (ImportError, TypeError):  # pragma: no cover
        from jax.experimental.shard_map import shard_map as esm
        return esm(local_fn, mesh=mesh, in_specs=(spec, spec, spec),
                   out_specs=spec, check_rep=False)(q, k, v)
