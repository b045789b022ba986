"""Vision projector family: linear / mlpNx_gelu / qformer / gated (MoE).

JAX rebuild of llava/model/multimodal_projector/builder.py:38-253. The ``gated``
type is SliME's 2-expert MoE: an MLP "projection" expert and a Resampler attention
adapter expert, mixed by a noisy-top-k gate over per-token vision features. With both
experts in the top-k (k == num_experts == 2), the gate reduces to a softmax mixture —
we exploit that to keep the forward dense (no sparse dispatch).

``mm_learnable_gated >= 0`` pins a single expert (staged pretraining, reference
train.py:1123-1127); the other expert's branch is skipped entirely under jit.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import SliMEConfig
from . import layers as L
from . import resampler


def gelu(x):
    # torch nn.GELU default == exact erf formulation
    return jax.nn.gelu(x, approximate=False)


def _mlp_init(rng, in_dim: int, out_dim: int, depth: int = 2) -> Dict:
    keys = jax.random.split(rng, depth)
    layers = [L.linear_init(keys[0], in_dim, out_dim)]
    for i in range(1, depth):
        layers.append(L.linear_init(keys[i], out_dim, out_dim))
    return {"layers": layers}


def _mlp_apply(p, x):
    x = L.linear(p["layers"][0], x)
    for lp in p["layers"][1:]:
        x = L.linear(lp, gelu(x))
    return x


def init(rng, cfg: SliMEConfig) -> Dict:
    ptype = cfg.mm_projector_type
    k1, k2, k3 = jax.random.split(rng, 3)
    if ptype == "linear":
        return {"proj": L.linear_init(k1, cfg.mm_hidden_size, cfg.hidden_size)}
    if ptype == "identity":
        return {}
    m = re.match(r"^mlp(\d+)x_gelu$", ptype)
    if m:
        return {"mlp": _mlp_init(k1, cfg.mm_hidden_size, cfg.hidden_size, int(m.group(1)))}
    if ptype == "qformer":
        return {"resampler": resampler.init(
                    k1, grid_size=24, embed_dim=cfg.mm_hidden_size,
                    num_heads=cfg.mm_num_heads, kv_dim=cfg.mm_hidden_size,
                    llm_hidden_size=cfg.hidden_size)}
    if ptype == "qformer_text":
        # text-conditioned resampler (ResamplerWithText, builder.py:227-237)
        return {"resampler": resampler.init(
                    k1, grid_size=24, embed_dim=cfg.mm_hidden_size,
                    num_heads=cfg.mm_num_heads, llm_hidden_size=cfg.hidden_size,
                    with_text=True)}
    if ptype == "gated":
        return {
            # expert 0: 2-layer MLP projection (builder.py:53-57)
            "projection": _mlp_init(k1, cfg.mm_hidden_size, cfg.hidden_size, 2),
            # expert 1: attention adapter (Resampler at grid 24, builder.py:43-50)
            "attn": resampler.init(
                k2, grid_size=24, embed_dim=cfg.mm_hidden_size,
                num_heads=cfg.mm_num_heads, kv_dim=cfg.mm_hidden_size,
                llm_hidden_size=cfg.hidden_size, use_post_proj=False),
            "w_gate": jnp.zeros((cfg.mm_hidden_size, 2), jnp.float32),
            "w_noise": jnp.zeros((cfg.mm_hidden_size, 2), jnp.float32),
        }
    raise ValueError(f"Unknown projector type: {ptype}")


def gate_weights(params, x, *, training: bool = False,
                 rng: Optional[jax.Array] = None, noise_epsilon: float = 1e-2):
    """Per-token expert mixture weights [..., 2].

    Inference: softmax(x @ w_gate). Training adds Gaussian noise with stddev
    softplus(x @ w_gate) + eps before the softmax (the reference derives the noise
    stddev from w_gate, not w_noise — builder.py:150; semantics preserved).
    With k == num_experts == 2 the top-k renormalization is the identity up to the
    reference's +1e-6 denominator, which we reproduce.
    """
    logits = jnp.einsum("...d,de->...e", x.astype(jnp.float32),
                        params["w_gate"].astype(jnp.float32))
    if training and rng is not None:
        stddev = jax.nn.softplus(logits) + noise_epsilon
        logits = logits + jax.random.normal(rng, logits.shape) * stddev
    g = jax.nn.softmax(logits, axis=-1)
    g = g / (jnp.sum(g, axis=-1, keepdims=True) + 1e-6)
    return g.astype(x.dtype)


def load_balance_loss(gates) -> jnp.ndarray:
    """cv_squared of the per-expert soft load (builder.py:119-134); exposed as an
    optional auxiliary metric (the reference computes but does not optimize it)."""
    load = jnp.sum(gates.reshape(-1, gates.shape[-1]) > 0, axis=0).astype(jnp.float32)
    eps = 1e-10
    return jnp.var(load) / (jnp.mean(load) ** 2 + eps)


def apply(params, x, *, cfg: SliMEConfig, training: bool = False,
          rng: Optional[jax.Array] = None, text_embedding=None,
          text_mask=None) -> jnp.ndarray:
    """x [N, L, mm_hidden] -> [N, L_out, llm_hidden].

    For the gated type with L != 576 the reference falls back to the plain MLP
    expert (builder.py:180-181); callers pass 576-token global views through the
    full MoE.
    """
    t = cfg.mm_projector_type
    if t == "identity":
        return x
    if t == "linear":
        return L.linear(params["proj"], x)
    if t.startswith("mlp"):
        return _mlp_apply(params["mlp"], x)
    if t == "qformer":
        return resampler.apply(params["resampler"], x,
                               num_heads=cfg.mm_num_heads)
    if t == "qformer_text":
        assert text_embedding is not None and text_mask is not None
        return resampler.apply_with_text(params["resampler"], x, text_embedding,
                                         text_mask, num_heads=cfg.mm_num_heads)
    assert t == "gated"
    if x.shape[1] != 576:
        return _mlp_apply(params["projection"], x)

    learnable = cfg.mm_learnable_gated
    if learnable == 0:
        return _mlp_apply(params["projection"], x)
    att = resampler.apply(params["attn"], x, num_heads=cfg.mm_num_heads)
    expert1 = _mlp_apply(params["projection"], att)
    if learnable == 1:
        return expert1
    expert0 = _mlp_apply(params["projection"], x)
    g = gate_weights(params, x, training=training, rng=rng)  # [N, L, 2]
    return expert0 * g[..., 0:1] + expert1 * g[..., 1:2]
