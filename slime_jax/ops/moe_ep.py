"""Expert-parallel MoE dispatch: GShard-style capacity routing over a mesh axis.

The reference has no explicit expert parallelism (SURVEY.md §2 "Parallelism
strategies": Mixtral MoE just lives inside ZeRO-3 via set_z3_leaf_modules,
train.py:992-993) — every rank holds/gathers all experts. This module shards the
experts over a mesh axis so each device stores and computes only E/n of them,
exchanging tokens with two all_to_alls: the standard expert-parallel layout.

Static shapes come from a per-expert token capacity C = ceil(T*k/E * factor):
one-hot dispatch indices are computed with cumsum positions, tokens over capacity
are dropped (their combine weight is zero — standard GShard training behavior;
use ops/moe_dispatch.moe_ffn_sparse for the exact dropless single-shard path).
With a generous capacity_factor there are no drops and results match the dense
oracle exactly (tested on the virtual 8-device mesh).

Layout inside shard_map (per device, n = mesh axis size, El = E/n local experts):
  tokens  [Tl, H] (data-sharded)  -> dispatch [E, C, H] (local tokens in all
  experts' slots) -> all_to_all   -> [El, n*C, H] (local experts, all devices'
  tokens) -> grouped FFN -> all_to_all back -> combine with routing weights.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _dispatch_indices(topi, topw, E, C):
    """Position of each (token, slot) pick inside its expert's capacity buffer.

    topi/topw [T, K]. Returns (pos [T, K] int32 position-in-expert (>=C means
    dropped), keep [T, K] bool)."""
    T, K = topi.shape
    flat = topi.reshape(-1)                                   # [T*K] slot-major rows
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)         # [T*K, E]
    # rank of each pick within its expert, in (token, slot) priority order
    pos_flat = jnp.cumsum(onehot, axis=0) - onehot            # [T*K, E]
    pos = jnp.take_along_axis(pos_flat, flat[:, None], axis=1)[:, 0]
    pos = pos.reshape(T, K)
    keep = pos < C
    return pos, keep


def moe_ffn_ep(x, w1, w2, w3, topi, topw, *, mesh: Mesh, axis: str = "model",
               capacity_factor: float = 2.0):
    """Expert-parallel top-k MoE SwiGLU FFN.

    x [T, H] tokens sharded over ``axis`` (each device holds T/n rows);
    w1/w3 [E, I, H], w2 [E, H, I] sharded on the expert dim over ``axis``.
    Returns [T, H] with x's sharding. Over-capacity picks are dropped (weight 0).
    """
    n = mesh.shape[axis]
    E = w1.shape[0]
    assert E % n == 0, (E, n)
    K = topi.shape[1]

    def local_fn(x_blk, w1_blk, w2_blk, w3_blk, topi_blk, topw_blk):
        Tl, H = x_blk.shape
        El = w1_blk.shape[0]
        C = max(8, int(math.ceil(Tl * K / E * capacity_factor)))

        pos, keep = _dispatch_indices(topi_blk, topw_blk, E, C)
        # scatter local tokens into every expert's capacity buffer
        buf = jnp.zeros((E, C, H), x_blk.dtype)
        e_idx = topi_blk.reshape(-1)
        p_idx = jnp.where(keep.reshape(-1), pos.reshape(-1), C)  # C -> dropped
        buf = buf.at[e_idx, p_idx].set(x_blk.repeat(K, axis=0), mode="drop")

        # exchange: device j's piece i (= j's tokens for i's experts) goes to
        # device i. [n, El, C, H] --a2a(split 0, concat 1)--> [El, n, C, H]:
        # my experts x every source device's capacity slots.
        buf = jax.lax.all_to_all(buf.reshape(n, El, C, H), axis,
                                 split_axis=0, concat_axis=1)
        buf = buf.reshape(El, n * C, H)

        h1 = jnp.einsum("ech,eih->eci", buf, w1_blk,
                        preferred_element_type=jnp.float32)
        h3 = jnp.einsum("ech,eih->eci", buf, w3_blk,
                        preferred_element_type=jnp.float32)
        y = jnp.einsum("eci,ehi->ech",
                       (jax.nn.silu(h1) * h3).astype(buf.dtype), w2_blk,
                       preferred_element_type=jnp.float32).astype(buf.dtype)

        # route back: [El, n, C, H] --a2a(split 1, concat 0)--> [n, El, C, H] =
        # my tokens' results from every expert group; group-major == global
        # expert id order, so it reshapes straight to [E, C, H].
        y = jax.lax.all_to_all(y.reshape(El, n, C, H), axis,
                               split_axis=1, concat_axis=0).reshape(E, C, H)

        got = y.at[e_idx, p_idx].get(mode="fill", fill_value=0)  # [Tl*K, H]
        w = jnp.where(keep.reshape(-1), topw_blk.reshape(-1), 0.0)
        out = jnp.sum((got * w[:, None].astype(got.dtype)).reshape(Tl, K, H),
                      axis=1)
        return out

    try:
        from jax import shard_map
        sm = lambda f, i, o: shard_map(f, mesh=mesh, in_specs=i, out_specs=o)
    except (ImportError, TypeError):  # pragma: no cover
        from jax.experimental.shard_map import shard_map as esm
        sm = lambda f, i, o: esm(f, mesh=mesh, in_specs=i, out_specs=o,
                                 check_rep=False)

    tok = P(axis, None)
    exp = P(axis, None, None)
    return sm(local_fn, (tok, exp, exp, exp, tok, tok), tok)(
        x, w1, w2, w3, topi, topw)
