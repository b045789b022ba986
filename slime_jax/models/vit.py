"""CLIP ViT vision tower (CLIP-L/336) in pure JAX.

Replaces the reference's HF ``CLIPVisionModel`` wrapper
(llava/model/multimodal_encoder/clip_encoder.py:8-89). The patch-embed conv is
expressed as a reshape + one big matmul; attention is bidirectional attention over
the 577-token sequence (ops/attention.py), batched over [B*(1+crops)] views at once.

Feature selection matches the reference: tap hidden state ``select_layer`` (-2 ==
penultimate, i.e. run 23 of 24 layers) and drop the CLS token ("patch" mode).
"""
from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp

from ..config import VisionConfig
from . import layers as L


def quick_gelu(x):
    return x * jax.nn.sigmoid(1.702 * x)


def init(rng, cfg: VisionConfig) -> Dict:
    keys = jax.random.split(rng, cfg.num_layers + 3)
    n_pos = cfg.num_patches + 1
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    params = {
        "class_embedding": jax.random.normal(keys[0], (cfg.hidden_size,), jnp.float32) * 0.02,
        # torch conv layout [E, 3, ph, pw], flattened to a matmul at load time
        "patch_embedding": jax.random.normal(keys[1], (cfg.hidden_size, patch_dim),
                                             jnp.float32) * 0.02,
        "position_embedding": jax.random.normal(keys[2], (n_pos, cfg.hidden_size),
                                                jnp.float32) * 0.02,
        "pre_layernorm": L.layer_norm_init(cfg.hidden_size),
        # unused in forward (features are taken at a pre-final layer, matching
        # the reference's mm_vision_select_layer=-2) but kept so HF CLIP
        # checkpoints round-trip with their full key set
        "post_layernorm": L.layer_norm_init(cfg.hidden_size),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        k = jax.random.split(keys[3 + i], 6)
        params["layers"].append({
            "layer_norm1": L.layer_norm_init(cfg.hidden_size),
            "q_proj": L.linear_init(k[0], cfg.hidden_size, cfg.hidden_size),
            "k_proj": L.linear_init(k[1], cfg.hidden_size, cfg.hidden_size),
            "v_proj": L.linear_init(k[2], cfg.hidden_size, cfg.hidden_size),
            "out_proj": L.linear_init(k[3], cfg.hidden_size, cfg.hidden_size),
            "layer_norm2": L.layer_norm_init(cfg.hidden_size),
            "fc1": L.linear_init(k[4], cfg.hidden_size, cfg.intermediate_size),
            "fc2": L.linear_init(k[5], cfg.intermediate_size, cfg.hidden_size),
        })
    return params


def _linear(p, x):
    # W8A8 route (opt-in, --quantize-vision): vision weights quantized by
    # quantize_tower() carry per-row int8 quant dicts and run as an int8 x
    # int8 -> int32 matmul (ops/w8a8_matmul.py); halves vision weight memory.
    # Any other quant layout (int4/group scales) takes weight-only L.linear.
    w = p["weight"]
    if isinstance(w, dict) and "q" in w and w["scale"].shape[-1] == 1:
        from ..ops.w8a8_matmul import w8a8_linear
        return w8a8_linear(p, x)
    return L.linear(p, x)


def _attention(p, x, num_heads: int):
    from ..ops.attention import attention

    B, S, E = x.shape
    hd = E // num_heads
    if "qkv" in p:
        # quantize_tower packs q/k/v into one [3E, E] weight so a single
        # activation read+quant feeds all three projections
        qkv = _linear(p["qkv"], x)
        q, k, v = (t.reshape(B, S, num_heads, hd)
                   for t in jnp.split(qkv, 3, axis=-1))
    else:
        q = _linear(p["q_proj"], x).reshape(B, S, num_heads, hd)
        k = _linear(p["k_proj"], x).reshape(B, S, num_heads, hd)
        v = _linear(p["v_proj"], x).reshape(B, S, num_heads, hd)
    out = attention(q, k, v, causal=False, scale=1.0 / math.sqrt(hd))
    return _linear(p["out_proj"], out.reshape(B, S, E))


def _block(p, x, cfg: VisionConfig):
    h = L.layer_norm(p["layer_norm1"], x, eps=cfg.layer_norm_eps)
    x = x + _attention(p, h, cfg.num_heads)
    h = L.layer_norm(p["layer_norm2"], x, eps=cfg.layer_norm_eps)
    h = _linear(p["fc2"], quick_gelu(_linear(p["fc1"], h)))
    return x + h


def pack_qkv_tower(params, cfg: VisionConfig):
    """Pack each running layer's q/k/v projections into one [3E, E] "qkv"
    linear (fp analogue of quantize_tower's packing; `_attention` consumes
    either layout). One bigger matmul replaces three [E, E] matmuls and the
    activation tile is read once instead of three times. Inference-time
    transform: apply AFTER load; export/save only understands the separate
    layout (training keeps q/k/v separate so checkpoints round-trip)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    n_run = cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0 \
        else cfg.select_layer
    layers = []
    for i, lp in enumerate(params["layers"]):
        if i >= n_run or "qkv" in lp:
            layers.append(lp)
            continue
        nl = {k: v for k, v in lp.items()
              if k not in ("q_proj", "k_proj", "v_proj")}
        nl["qkv"] = {
            "weight": jnp.concatenate(
                [lp[k]["weight"] for k in ("q_proj", "k_proj", "v_proj")], axis=0),
            "bias": jnp.concatenate(
                [lp[k]["bias"] for k in ("q_proj", "k_proj", "v_proj")], axis=0),
        }
        layers.append(nl)
    out["layers"] = layers
    return out


def quantize_tower(params, cfg: VisionConfig):
    """Quantize the encoder's linear weights to per-row int8 for the W8A8
    encode path (only layers that run: up to ``select_layer``). q/k/v merge
    into one packed "qkv" weight. Embeddings, layer norms, biases, and the
    (unused) post_layernorm stay fp — they are <1% of encode FLOPs and the
    patch embed sees raw pixel statistics. Accuracy budget: docs/Serving.md
    (~2% relative feature error, bounded in tests/test_w8a8.py)."""
    from ..ops.quantization import quantize_weight

    out = {k: v for k, v in params.items() if k != "layers"}
    n_run = cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0 \
        else cfg.select_layer
    layers = []
    for i, lp in enumerate(params["layers"]):
        if i >= n_run:
            layers.append(lp)
            continue
        nl = {"layer_norm1": lp["layer_norm1"], "layer_norm2": lp["layer_norm2"]}
        nl["qkv"] = {
            "weight": quantize_weight(jnp.concatenate(
                [lp[k]["weight"].astype(jnp.float32)
                 for k in ("q_proj", "k_proj", "v_proj")], axis=0), 8),
            "bias": jnp.concatenate(
                [lp[k]["bias"].astype(jnp.float32)
                 for k in ("q_proj", "k_proj", "v_proj")], axis=0),
        }
        for k in ("out_proj", "fc1", "fc2"):
            nl[k] = {"weight": quantize_weight(lp[k]["weight"].astype(jnp.float32), 8),
                     "bias": lp[k]["bias"].astype(jnp.float32)}
        layers.append(nl)
    out["layers"] = layers
    return out


def embed_patches(params, pixel_values, cfg: VisionConfig):
    """[B, 3, H, W] -> [B, 1+P, E]: conv-as-matmul patch embed + CLS + positions."""
    B = pixel_values.shape[0]
    ps, n = cfg.patch_size, cfg.num_patches_per_side
    x = pixel_values.reshape(B, 3, n, ps, n, ps)
    x = x.transpose(0, 2, 4, 1, 3, 5).reshape(B, n * n, 3 * ps * ps)
    x = jnp.einsum("bpd,ed->bpe", x, params["patch_embedding"].astype(x.dtype),
                   preferred_element_type=jnp.float32).astype(x.dtype)
    cls = jnp.broadcast_to(params["class_embedding"].astype(x.dtype), (B, 1, cfg.hidden_size))
    x = jnp.concatenate([cls, x], axis=1)
    return x + params["position_embedding"].astype(x.dtype)


def apply(params, pixel_values, cfg: VisionConfig, *, remat: bool = False):
    """[B, 3, H, W] -> patch features [B, P, E] (CLS dropped, layer ``select_layer``).

    remat=True rematerializes each encoder block on the backward pass
    (jax.checkpoint): the training-time memory knob for the multimodal step —
    the backward stash drops from ~8 tensors/block to the block input alone,
    which is what lets the 70B composed plan budget the vision tower at
    O(layers * crops * 577 * E) instead of O(8x) that (parallel/memory_plan.py).
    Values are bit-identical either way."""
    x = embed_patches(params, pixel_values, cfg)
    x = L.layer_norm(params["pre_layernorm"], x, eps=cfg.layer_norm_eps)
    n_run = cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0 else cfg.select_layer
    block = jax.checkpoint(_block, static_argnums=(2,)) if remat else _block
    for i in range(n_run):
        x = block(params["layers"][i], x, cfg)
    if cfg.select_feature == "patch":
        x = x[:, 1:]
    return x
