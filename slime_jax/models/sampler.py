"""Text-guided local-token compression and selection ("sampler").

JAX rebuild of llava/model/multimodal_resampler/builder.py:94-302:

- ``compress``: the local compression layer (``post_qformer``) — a Resampler that
  squeezes each crop's 576 ViT tokens to ``mm_resampler_dim`` (144) queries.
- ``select``: text-guided top-p token selection. The reference scores every
  compressed local token against the text, sorts, and *gathers* the top-p prefix
  (builder.py:258-281) — a dynamic-shape op. This version computes the same
  selection as a fixed-shape **keep mask** (rank < k, where k reproduces the
  reference's cumulative-top-p count); downstream splicing compacts masked tokens
  with a cumsum scatter, so XLA sees only static shapes.

Selector variants: ``cosine`` (parameter-free cosine similarity vs text embeds,
builder.py:177-201) and ``qformer`` (cross-attention router, builder.py:94-170).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import SliMEConfig
from . import layers as L
from . import resampler


def init(rng, cfg: SliMEConfig) -> Dict:
    k1, k2 = jax.random.split(rng)
    grid = int(math.isqrt(cfg.mm_resampler_dim))
    params: Dict = {
        "post_qformer": resampler.init(
            k1, grid_size=grid, embed_dim=cfg.mm_hidden_size,
            num_heads=cfg.mm_num_heads, kv_dim=cfg.mm_hidden_size,
            llm_hidden_size=cfg.hidden_size),
    }
    if cfg.mm_resampler_type == "qformer":
        E = cfg.hidden_size
        ks = jax.random.split(k2, 4)
        params["selector"] = {
            "query": jax.random.truncated_normal(ks[0], -2, 2, (1, E), jnp.float32) * 0.02,
            "self_attn": L.mha_init(ks[1], E),
            "cross_attn": L.mha_init(ks[2], E),
            "ln_q": L.layer_norm_init(E),
            "ln_kv": L.layer_norm_init(E),
            "ln_post": L.layer_norm_init(E),
            "prob_proj": {
                "fc1": L.linear_init(ks[3], E, E // 4),
                "fc2": L.linear_init(jax.random.fold_in(ks[3], 1), E // 4, 1),
            },
        }
    return params


def compress(params, crop_feats, *, cfg: SliMEConfig) -> jnp.ndarray:
    """[N, 576, mm_hidden] ViT features -> [N, mm_resampler_dim, mm_hidden]."""
    return resampler.apply(params["post_qformer"], crop_feats,
                           num_heads=cfg.mm_num_heads)


def _cosine_scores(local_f, text_emb, text_mask) -> jnp.ndarray:
    """Summed cosine similarity of each local token against valid text tokens
    (TextGuidedRouterCosine, builder.py:189-201). [M,D],[L,D],[L] -> [M]."""
    eps = 1e-8
    a = local_f.astype(jnp.float32)
    b = text_emb.astype(jnp.float32)
    an = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), eps)
    bn = b / jnp.maximum(jnp.linalg.norm(b, axis=-1, keepdims=True), eps)
    sim = jnp.einsum("md,ld->ml", an, bn)
    sim = jnp.where(text_mask[None, :].astype(bool), sim, 0.0)
    return jnp.sum(sim, axis=-1)


def _qformer_scores(p, local_f, text_emb, text_mask, *, num_heads: int,
                    temp: float) -> jnp.ndarray:
    """Cross-attention router scores (TextGuidedRouterAttention.forward)."""
    x = L.layer_norm(p["ln_q"], local_f[None], eps=1e-6)
    t = L.layer_norm(p["ln_kv"], text_emb[None], eps=1e-6)
    pad = ~text_mask[None].astype(bool)
    out = L.mha(p["cross_attn"], x, t, t, num_heads, key_padding_mask=pad)
    out = L.layer_norm(p["ln_post"], out, eps=1e-6)
    h = jax.nn.relu(L.linear(p["prob_proj"]["fc1"], out))
    logits = L.linear(p["prob_proj"]["fc2"], h)[0, :, 0]
    return jax.nn.softmax(logits.astype(jnp.float32) / temp, axis=-1)


def select(params, local_f, text_emb, text_mask, token_valid, *, cfg: SliMEConfig,
           training: bool = False, rng: Optional[jax.Array] = None
           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-p token selection as a static keep mask.

    local_f [M, llm_hidden]; text_emb [L, llm_hidden]; text_mask [L];
    token_valid [M] (False for tokens from padded crops).
    Returns (keep [M] bool, probs [M] float32).

    Reproduces builder.py:248-281: score -> (train: +0.1*N(0,1) noise) ->
    temp-softmax -> sort desc -> k = #(cumsum<=topp)+1 -> keep that prefix,
    original order. k is additionally clamped to the number of valid tokens
    (the reference never sees invalid tokens because it gathers them out earlier).
    """
    M = local_f.shape[0]
    if cfg.mm_resampler_type == "cosine":
        scores = _cosine_scores(local_f, text_emb, text_mask)
    else:
        scores = _qformer_scores(params["selector"], local_f, text_emb, text_mask,
                                 num_heads=cfg.llm_num_heads_128,
                                 temp=cfg.mm_resampler_temp)
    if training and rng is not None:
        scores = scores + jax.random.normal(rng, scores.shape) * 0.1

    valid = token_valid.astype(bool)
    scores = jnp.where(valid, scores, -jnp.inf)
    probs = jax.nn.softmax(scores.astype(jnp.float32) / cfg.mm_resampler_temp, axis=-1)

    order = jnp.argsort(-probs)                      # descending, stable
    cum = jnp.cumsum(probs[order])
    count = jnp.sum(cum <= cfg.mm_resampler_topp)
    n_valid = jnp.sum(valid)
    k = jnp.minimum(count + 1, n_valid)
    rank = jnp.argsort(order)                        # rank of each original index
    keep = (rank < k) & valid
    return keep, probs
