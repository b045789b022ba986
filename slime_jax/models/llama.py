"""Decoder-only LLM (Llama / Vicuna / Mistral / Mixtral) in functional JAX.

Replaces the reference's HF-transformers runtime (SURVEY.md §2.13): RMSNorm, RoPE,
GQA attention (cuDNN flash attention on GPU, ops/attention.py), SwiGLU MLP, optional Mixtral-style
MoE, tied configs for Vicuna-7B/13B and Llama-3-8B/70B, plus a KV-cache decode path.

Design notes:
- One parameterized decoder instead of per-family subclasses
  (llava/model/language_model/llava_{llama,mistral,mixtral,mpt}.py).
- Prefill takes *embeddings* (multimodal fusion splices image features before the
  LLM — llava_arch.py:274-459); token embedding is a separate entry point.
- The layer stack is a Python loop over per-layer param dicts (XLA unrolls and
  pipelines it; a lax.scan variant can be swapped in for compile-time if needed).
- fp32 RoPE tables and fp32 logits (matching HF numerics within bf16 tolerance).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import LLMConfig
from . import layers as L
from ..ops.attention import attention


# ----------------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------------

def init(rng, cfg: LLMConfig) -> Dict:
    keys = jax.random.split(rng, cfg.num_layers + 3)
    H, HD = cfg.hidden_size, cfg.head_dim
    params: Dict = {
        "embed_tokens": jax.random.normal(keys[0], (cfg.vocab_size, H), jnp.float32) * 0.02,
        "norm": L.rms_norm_init(H),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        k = jax.random.split(keys[2 + i], 8)
        lp = {
            "input_layernorm": L.rms_norm_init(H),
            "q_proj": L.linear_init(k[0], H, cfg.num_heads * HD, bias=cfg.attention_bias),
            "k_proj": L.linear_init(k[1], H, cfg.num_kv_heads * HD, bias=cfg.attention_bias),
            "v_proj": L.linear_init(k[2], H, cfg.num_kv_heads * HD, bias=cfg.attention_bias),
            "o_proj": L.linear_init(k[3], cfg.num_heads * HD, H, bias=False),
            "post_attention_layernorm": L.rms_norm_init(H),
        }
        if cfg.num_experts > 0:
            lp["gate"] = L.linear_init(k[4], H, cfg.num_experts, bias=False)
            lp["experts"] = {
                "w1": jax.random.normal(k[5], (cfg.num_experts, cfg.intermediate_size, H),
                                        jnp.float32) * 0.02,
                "w2": jax.random.normal(k[6], (cfg.num_experts, H, cfg.intermediate_size),
                                        jnp.float32) * 0.02,
                "w3": jax.random.normal(k[7], (cfg.num_experts, cfg.intermediate_size, H),
                                        jnp.float32) * 0.02,
            }
        else:
            lp["gate_proj"] = L.linear_init(k[4], H, cfg.intermediate_size, bias=False)
            lp["up_proj"] = L.linear_init(k[5], H, cfg.intermediate_size, bias=False)
            lp["down_proj"] = L.linear_init(k[6], cfg.intermediate_size, H, bias=False)
        params["layers"].append(lp)
    params["lm_head"] = {"weight": jax.random.normal(keys[1], (cfg.vocab_size, H),
                                                     jnp.float32) * 0.02}
    return params


# ----------------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------------

def rope_table(cfg: LLMConfig, max_len: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(cos, sin) [max_len, head_dim] fp32, HF half-rotation layout."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd))
    t = jnp.arange(max_len, dtype=jnp.float32)
    freqs = jnp.outer(t, inv_freq)                 # [S, hd/2]
    emb = jnp.concatenate([freqs, freqs], axis=-1)  # [S, hd]
    return jnp.cos(emb), jnp.sin(emb)


def apply_rope(x, cos, sin):
    """x [B, S, H, hd]; cos/sin [B, S, hd] or [S, hd]."""
    if cos.ndim == 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, :, None, :].astype(jnp.float32)
    sin = sin[:, :, None, :].astype(jnp.float32)
    xf = x.astype(jnp.float32)
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    rot = jnp.concatenate([-x2, x1], axis=-1)
    return (xf * cos + rot * sin).astype(x.dtype)


# ----------------------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------------------

def _mlp(lp, x):
    g = L.linear(lp["gate_proj"], x)
    u = L.linear(lp["up_proj"], x)
    return L.linear(lp["down_proj"], jax.nn.silu(g) * u)


def _router_aux(logits, topi, num_experts):
    """Switch/Mixtral load-balancing loss, HF semantics (transformers
    load_balancing_loss_func): E * sum_{slot,e} f[slot,e] * P[e], where f is the
    fraction of tokens whose top-k slot picked expert e and P the mean router
    probability. Balanced routing gives ~top_k."""
    T = logits.shape[0] * logits.shape[1]
    probs = jax.nn.softmax(logits.reshape(T, -1), axis=-1)          # [T, E]
    onehot = jax.nn.one_hot(topi.reshape(T, -1), num_experts,
                            dtype=jnp.float32)                      # [T, K, E]
    tokens_per_expert = jnp.mean(onehot, axis=0)                    # [K, E]
    router_prob = jnp.mean(probs, axis=0)                           # [E]
    return jnp.sum(tokens_per_expert * router_prob[None, :]) * num_experts


def _moe(lp, x, cfg: LLMConfig):
    """Mixtral block-sparse MoE. Routing is top-k softmax over the gate; the expert
    FFNs run either densely (every expert on every token, masked — best for tiny
    token counts like single-step decode) or sparsely via sort + ragged_dot grouped
    matmuls (ops/moe_dispatch.py — exact, dropless, k/E of the dense FLOPs; the
    path taken for prefill and training). Returns (out, load-balancing aux loss)."""
    B, S, H = x.shape
    logits = L.linear(lp["gate"], x).astype(jnp.float32)       # [B,S,E]
    topw, topi = jax.lax.top_k(logits, cfg.num_experts_per_tok)
    topw = jax.nn.softmax(topw, axis=-1)
    aux = _router_aux(logits, topi, cfg.num_experts)
    if B * S >= 32:  # static shape — branch resolved at trace time
        from ..ops.moe_dispatch import moe_ffn_sparse
        out = moe_ffn_sparse(x.reshape(B * S, H), lp["experts"]["w1"],
                             lp["experts"]["w2"], lp["experts"]["w3"],
                             topi.reshape(B * S, -1),
                             topw.astype(x.dtype).reshape(B * S, -1))
        return out.reshape(B, S, H), aux
    w_full = jnp.zeros_like(logits).at[
        jnp.arange(B)[:, None, None], jnp.arange(S)[None, :, None], topi
    ].set(topw)                                                # [B,S,E]
    # dense expert compute: y_e = (silu(x@w1_e.T) * (x@w3_e.T)) @ w2_e.T
    h1 = jnp.einsum("bsh,eih->bsei", x, lp["experts"]["w1"],
                    preferred_element_type=jnp.float32).astype(x.dtype)
    h3 = jnp.einsum("bsh,eih->bsei", x, lp["experts"]["w3"],
                    preferred_element_type=jnp.float32).astype(x.dtype)
    y = jnp.einsum("bsei,ehi->bseh", jax.nn.silu(h1) * h3, lp["experts"]["w2"],
                   preferred_element_type=jnp.float32).astype(x.dtype)
    return jnp.einsum("bseh,bse->bsh", y, w_full.astype(x.dtype)), aux


def _attn_prefill(lp, x, cos, sin, cfg: LLMConfig,
                  ring: Optional[tuple] = None, segment_ids=None, mesh=None):
    B, S, H = x.shape
    hd = cfg.head_dim
    q = L.linear(lp["q_proj"], x).reshape(B, S, cfg.num_heads, hd)
    k = L.linear(lp["k_proj"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = L.linear(lp["v_proj"], x).reshape(B, S, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if ring is not None:
        # context parallelism: exact ring attention over the sequence-sharded mesh
        # axis (ops/ring_attention.py) — a beyond-reference long-context path
        from ..ops.ring_attention import ring_attention
        mesh, axis = ring
        # GQA-native ring: only num_kv_heads blocks rotate between devices
        out = ring_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                             v.transpose(0, 2, 1, 3), mesh=mesh, axis=axis,
                             causal=True).transpose(0, 2, 1, 3)
    else:
        out = attention(q, k, v, causal=True, segment_ids=segment_ids,
                        mesh=mesh)
    out = out.reshape(B, S, cfg.num_heads * hd)
    return L.linear(lp["o_proj"], out), (k, v)


def _layer_prefill(lp, x, cos, sin, cfg, ring=None, segment_ids=None,
                   mesh=None):
    h = L.rms_norm(lp["input_layernorm"], x, eps=cfg.rms_norm_eps)
    a, kv = _attn_prefill(lp, h, cos, sin, cfg, ring=ring,
                          segment_ids=segment_ids, mesh=mesh)
    x = x + a
    h = L.rms_norm(lp["post_attention_layernorm"], x, eps=cfg.rms_norm_eps)
    if cfg.num_experts > 0:
        h, aux = _moe(lp, h, cfg)
    else:
        h, aux = _mlp(lp, h), jnp.float32(0.0)
    return x + h, kv, aux


def embed(params, input_ids) -> jnp.ndarray:
    return params["embed_tokens"][input_ids]


def stack_layers(layers):
    """Stack a list-of-layer-dicts pytree into one dict pytree with a leading
    [num_layers] dim — the storage layout for scan-based forward/decode. Storing
    params pre-stacked (params["layers"] as a dict instead of a list) avoids an
    in-graph copy of the full weight set every call, which matters when the
    weights are most of device memory."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *layers)


def unstack_layers(layers, num_layers: int):
    """Inverse of stack_layers (views, no copy under jit)."""
    if not isinstance(layers, dict):
        return layers
    return [jax.tree_util.tree_map(lambda x: x[i], layers)
            for i in range(num_layers)]


def _lm_head(params, x):
    """Final vocab projection, fp32 logits; quant-aware. An int8 lm_head is
    ~0.5 GB less weight streaming per decode step at 128k-vocab scale, and
    XLA fuses the int8->bf16 convert + scale into the dot operand (verified:
    the int8-dequant matvec reads ~packed bytes, unlike int4's unpack chain
    which materializes)."""
    w = params["lm_head"]["weight"]
    if isinstance(w, dict):
        from ..ops.quantization import dequantize_weight
        w = dequantize_weight(w)
    return jnp.einsum("...h,vh->...v", x, w.astype(x.dtype),
                      preferred_element_type=jnp.float32)


def forward(params, embeds, cfg: LLMConfig, *, positions=None,
            return_kv: bool = False,
            compute_dtype=jnp.float32, remat: bool = False,
            scan_layers: bool = False, ring: Optional[tuple] = None,
            return_aux: bool = False, logit_positions=None,
            return_hidden: bool = False, segment_ids=None, mesh=None):
    """Full-sequence forward (training / prefill).

    mesh: the device mesh params and activations are sharded over (tensor-
    parallel serving, FSDP/TP training), which attention needs to run its
    library kernel per device (ops/attention.py).

    segment_ids [B, S] (sequence packing, data/packing.py): block-diagonal
    attention per packed example; pass per-segment restarting positions too.

    ring=(mesh, axis): run attention as exact ring attention with the sequence
    sharded over the given mesh axis (context parallelism; see
    ops/ring_attention.py).

    embeds [B, S, H] (already fused with image features); positions [B, S] or None
    (arange). Returns (logits fp32 [B, S, V], kv list or None); with
    return_aux=True a third element: the mean-over-layers router load-balancing
    loss (HF MixtralForCausalLM output_router_logits semantics; 0 for dense).
    remat=True rematerializes each block on the backward pass (jax.checkpoint) —
    the equivalent of the reference's gradient_checkpointing flag
    (train.py:1028-1034), trading ~1/3 more FLOPs for O(sqrt) activation memory.

    logit_positions [B] (int): compute logits only at these sequence positions
    -> [B, 1, V]. Prefill only needs the last valid position's logits; at 8B the
    full-sequence fp32 logit tensor is ~0.9 GB/1k tokens of pure waste.

    params["layers"] may be a list of per-layer dicts or a pre-stacked dict
    (see stack_layers); scan_layers=True uses the stacked form directly.
    """
    B, S, _ = embeds.shape
    x = embeds.astype(compute_dtype)
    cos, sin = rope_table(cfg, cfg.max_position_embeddings)
    if positions is None:
        cos_s, sin_s = cos[:S], sin[:S]
    else:
        cos_s, sin_s = cos[positions], sin[positions]

    if isinstance(params["layers"], dict):
        scan_layers = True  # pre-stacked storage implies the scan path
    if scan_layers:
        # lax.scan over a stacked layer pytree: XLA compiles ONE block instead of
        # unrolling num_layers copies — order-of-magnitude compile-time win for
        # deep models (32-layer unrolled compiles take minutes).
        layers = params["layers"]
        stacked = layers if isinstance(layers, dict) else stack_layers(layers)

        def body(carry, lp):
            h, kv, aux = _layer_prefill(lp, carry[0], cos_s, sin_s, cfg,
                                        ring=ring, segment_ids=segment_ids,
                                        mesh=mesh)
            return (h, carry[1] + aux), (kv if return_kv else None)

        if remat:
            body = jax.checkpoint(body)
        (x, aux_sum), kvs_stacked = jax.lax.scan(
            body, (x, jnp.float32(0.0)), stacked)
        kvs = None
        if return_kv:
            k_all, v_all = kvs_stacked  # [L, B, S, KVH, hd] each
            kvs = [(k_all[i], v_all[i]) for i in range(cfg.num_layers)]
        x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
        if logit_positions is not None:
            x = jnp.take_along_axis(x, logit_positions[:, None, None], axis=1)
        logits = x if return_hidden else _lm_head(params, x)
        out = (logits, (kvs if return_kv else None))
        return out + (aux_sum / cfg.num_layers,) if return_aux else out

    layer_fn = _layer_prefill
    if remat:
        layer_fn = jax.checkpoint(
            functools.partial(_layer_prefill, cfg=cfg,
                              segment_ids=segment_ids, mesh=mesh),
            static_argnums=())
    kvs = []
    aux_sum = jnp.float32(0.0)
    for lp in params["layers"]:
        if remat:
            x, kv, aux = layer_fn(lp, x, cos_s, sin_s)
        else:
            x, kv, aux = layer_fn(lp, x, cos_s, sin_s, cfg, ring,
                                  segment_ids, mesh)
        aux_sum = aux_sum + aux
        if return_kv:
            kvs.append(kv)
    x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
    if logit_positions is not None:
        x = jnp.take_along_axis(x, logit_positions[:, None, None], axis=1)
    logits = x if return_hidden else _lm_head(params, x)
    out = (logits, (kvs if return_kv else None))
    return out + (aux_sum / cfg.num_layers,) if return_aux else out


def forward_hidden(params, embeds, cfg: LLMConfig, *, positions=None,
                   compute_dtype=jnp.float32,
                   remat: bool = False, scan_layers: bool = False):
    """Like forward() but returns the final hidden states (no LM head) —
    shares forward()'s scan/remat machinery. Pair with ops.loss.chunked_ce_mean
    to train without ever materializing [B, S, V] logits."""
    return forward(params, embeds, cfg, positions=positions,
                   compute_dtype=compute_dtype,
                   remat=remat, scan_layers=scan_layers, return_hidden=True)[0]


# ----------------------------------------------------------------------------------
# KV-cache decode
# ----------------------------------------------------------------------------------

def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, dtype=jnp.float32,
                  quantized: bool = False):
    """Per-layer [B, max_len, KVH, hd] caches as a dict pytree.

    quantized=True stores K/V as int8 with per-(position, kv-head) absmax
    scales ([L, B, max_len, KVH] fp32) — HALF the cache memory and half the
    decode-step cache read traffic. Attention never dequantizes the cache
    tensors: the int8 operands feed the dots directly (the convert fuses into
    the matmul operand load) and the scales multiply the SCORES — per-(t, head)
    scaling commutes through q·k_t and p_t·v_t, so the small [.., T] score
    tensor absorbs both dequants."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if quantized:
        return {"k": jnp.zeros((cfg.num_layers,) + shape, jnp.int8),
                "v": jnp.zeros((cfg.num_layers,) + shape, jnp.int8),
                "k_scale": jnp.ones((cfg.num_layers,) + shape[:-1], jnp.float32),
                "v_scale": jnp.ones((cfg.num_layers,) + shape[:-1], jnp.float32),
                "length": jnp.zeros((batch,), jnp.int32)}
    return {"k": jnp.zeros((cfg.num_layers,) + shape, dtype),
            "v": jnp.zeros((cfg.num_layers,) + shape, dtype),
            "length": jnp.zeros((batch,), jnp.int32)}


def cache_quantized(cache) -> bool:
    return "k_scale" in cache


def quantize_kv(x):
    """x [..., KVH, hd] float -> (int8 [..., KVH, hd], scale [..., KVH]):
    per-head absmax over the head dim."""
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=-1)
    scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    q = jnp.clip(jnp.round(xf / scale[..., None]), -127, 127).astype(jnp.int8)
    return q, scale


def prefill_into_cache(cache, kvs, lengths):
    """Write prefill KV (list of (k [B,S,KVH,hd], v)) into the cache at offset 0."""
    k_new = jnp.stack([kv[0] for kv in kvs])  # [L, B, S, KVH, hd]
    v_new = jnp.stack([kv[1] for kv in kvs])
    S = k_new.shape[2]
    cache = dict(cache)
    if cache_quantized(cache):
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        cache["k"] = cache["k"].at[:, :, :S].set(kq)
        cache["v"] = cache["v"].at[:, :, :S].set(vq)
        cache["k_scale"] = cache["k_scale"].at[:, :, :S].set(ks)
        cache["v_scale"] = cache["v_scale"].at[:, :, :S].set(vs)
    else:
        cache["k"] = cache["k"].at[:, :, :S].set(k_new.astype(cache["k"].dtype))
        cache["v"] = cache["v"].at[:, :, :S].set(v_new.astype(cache["v"].dtype))
    cache["length"] = lengths.astype(jnp.int32)
    return cache


def prefill_chunk(params, cache, embeds, cfg: LLMConfig,
                  compute_dtype=jnp.float32, window: Optional[int] = None):
    """Incremental prefill: append a C-token chunk to the cache and return its
    logits. Enables chunked admission in the serving engine (long prompts don't
    stall decode ticks) and O(C * T) attention memory instead of O(S^2).

    embeds [B, C, H]; rows start at their current cache['length'] (may differ
    per row). Returns (logits fp32 [B, C, V], cache').
    """
    B, C, _ = embeds.shape
    hd = cfg.head_dim
    max_len = cache["k"].shape[2]
    W = max_len if window is None else min(window, max_len)
    pos0 = cache["length"]                                   # [B]
    positions = pos0[:, None] + jnp.arange(C)[None]          # [B, C]
    cos, sin = rope_table(cfg, cfg.max_position_embeddings)
    cos_s, sin_s = cos[positions], sin[positions]

    x = embeds.astype(compute_dtype)
    t_idx = jnp.arange(W)[None, None, None, :]
    quant = cache_quantized(cache)
    arrays = ((cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
              if quant else (cache["k"], cache["v"]))

    # scatter a chunk into each row's cache at its own offset
    def put(cache_li, new, row_pos):
        def one(c_row, n_row, p):
            idx = (p,) + (0,) * (n_row.ndim - 1)
            return jax.lax.dynamic_update_slice(c_row, n_row, idx)
        return jax.vmap(one)(cache_li, new.astype(cache_li.dtype), row_pos)

    def layer_chunk(lp, x, ca):
        """One chunk layer over its own cache slices -> (x', new slices)."""
        h = L.rms_norm(lp["input_layernorm"], x, eps=cfg.rms_norm_eps)
        q = L.linear(lp["q_proj"], h).reshape(B, C, cfg.num_heads, hd)
        k = L.linear(lp["k_proj"], h).reshape(B, C, cfg.num_kv_heads, hd)
        v = L.linear(lp["v_proj"], h).reshape(B, C, cfg.num_kv_heads, hd)
        q = apply_rope(q, cos_s, sin_s)
        k = apply_rope(k, cos_s, sin_s)

        if quant:
            k_ca, v_ca, ks_ca, vs_ca = ca
            kq, ks_new = quantize_kv(k)
            vq, vs_new = quantize_kv(v)
            k_li, v_li = put(k_ca, kq, pos0), put(v_ca, vq, pos0)
            ks_li, vs_li = put(ks_ca, ks_new, pos0), put(vs_ca, vs_new, pos0)
        else:
            k_ca, v_ca = ca
            k_li, v_li = put(k_ca, k, pos0), put(v_ca, v, pos0)

        group = cfg.num_heads // cfg.num_kv_heads
        qg = q.reshape(B, C, cfg.num_kv_heads, group, hd)
        # attention reads only the window prefix (write above was full-width);
        # callers guarantee pos0 + C <= window for every row
        kk = jax.lax.slice_in_dim(k_li, 0, W, axis=1).astype(compute_dtype)
        vv = jax.lax.slice_in_dim(v_li, 0, W, axis=1).astype(compute_dtype)
        s = jnp.einsum("bckgd,btkd->bkgct", qg, kk,
                       preferred_element_type=jnp.float32) / math.sqrt(hd)
        if quant:   # per-(t, head) K scale lands on the scores (see decode_step)
            ks_w = jax.lax.slice_in_dim(ks_li, 0, W, axis=1)
            s = s * jnp.transpose(ks_w, (0, 2, 1))[:, :, None, None, :]
        # causal vs absolute position of each chunk query
        q_abs = positions[:, None, None, :, None]            # [B,1,1,C,1]
        ok = t_idx[:, :, :, None, :] <= q_abs                # -> [B,1,1,C,T]
        s = jnp.where(ok, s, -1e30)
        p = jax.nn.softmax(s, axis=-1)
        if quant:
            vs_w = jax.lax.slice_in_dim(vs_li, 0, W, axis=1)
            p = p * jnp.transpose(vs_w, (0, 2, 1))[:, :, None, None, :]
        o = jnp.einsum("bkgct,btkd->bckgd", p.astype(compute_dtype), vv,
                       preferred_element_type=jnp.float32).astype(compute_dtype)
        o = o.reshape(B, C, cfg.num_heads * hd)
        x = x + L.linear(lp["o_proj"], o)
        h = L.rms_norm(lp["post_attention_layernorm"], x, eps=cfg.rms_norm_eps)
        h = _moe(lp, h, cfg)[0] if cfg.num_experts > 0 else _mlp(lp, h)
        new = (k_li, v_li, ks_li, vs_li) if quant else (k_li, v_li)
        return x + h, new

    if isinstance(params["layers"], dict):
        # pre-stacked layers: scan ONE compiled layer body (weights and cache
        # slices stream layer by layer, same as decode_step — without this the
        # 32-deep unroll both compiles slowly and loses the cross-layer weight
        # prefetch pipeline; measured 48 ms -> ~t_plain for a 5-token chunk)
        def body(x, inp):
            x, new = layer_chunk(inp[0], x, inp[1:])
            return x, new

        x, new_arrays = jax.lax.scan(body, x, (params["layers"],) + arrays)
    else:
        outs = []
        for li, lp in enumerate(params["layers"]):
            x, new = layer_chunk(lp, x, tuple(a[li] for a in arrays))
            outs.append(new)
        new_arrays = tuple(jnp.stack([o[j] for o in outs])
                           for j in range(len(arrays)))

    x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
    logits = _lm_head(params, x)
    cache = {"k": new_arrays[0], "v": new_arrays[1], "length": pos0 + C}
    if quant:
        cache["k_scale"], cache["v_scale"] = new_arrays[2], new_arrays[3]
    return logits, cache


def decode_step(params, cache, token_ids, cfg: LLMConfig,
                compute_dtype=jnp.float32, window: Optional[int] = None):
    """One decode step: token_ids [B] -> (logits fp32 [B, V], cache').

    Attention is a masked XLA dot over the cache (bandwidth-bound; one query
    token, so streaming K/V from device memory dominates).

    ``window`` (static): attend only over cache[:, :, :window]. The KV write
    still lands in the full buffer, but the attention READ — the cache's whole
    HBM cost — shrinks to the window. Callers must guarantee every active
    row's length < window; the serving engine picks a bucket ≥ max active
    length per dispatch (a handful of compiled variants), cutting decode-tick
    cache traffic for short contexts in a long-cache pool.
    """
    B = token_ids.shape[0]
    hd = cfg.head_dim
    pos = cache["length"]                               # [B]
    x = params["embed_tokens"][token_ids][:, None].astype(compute_dtype)  # [B,1,H]
    cos, sin = rope_table(cfg, cfg.max_position_embeddings)
    cos_s, sin_s = cos[pos][:, None], sin[pos][:, None]  # [B,1,hd]

    max_len = cache["k"].shape[2]
    W = max_len if window is None else min(window, max_len)
    quant = cache_quantized(cache)
    # per-layer cache arrays as a tuple: (k, v) or (k, v, k_scale, v_scale)
    arrays = ((cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
              if quant else (cache["k"], cache["v"]))

    def layer_decode(lp, x, ca):
        """One decode layer over its own cache slices -> (x', new slices)."""
        h = L.rms_norm(lp["input_layernorm"], x, eps=cfg.rms_norm_eps)
        q = L.linear(lp["q_proj"], h).reshape(B, 1, cfg.num_heads, hd)
        k = L.linear(lp["k_proj"], h).reshape(B, 1, cfg.num_kv_heads, hd)
        v = L.linear(lp["v_proj"], h).reshape(B, 1, cfg.num_kv_heads, hd)
        q = apply_rope(q, cos_s, sin_s)
        k = apply_rope(k, cos_s, sin_s)

        # insert new kv at position `pos` per batch row
        bidx = jnp.arange(B)
        if quant:
            k_ca, v_ca, ks_ca, vs_ca = ca
            kq, ks_new = quantize_kv(k[:, 0])
            vq, vs_new = quantize_kv(v[:, 0])
            k_li = k_ca.at[bidx, pos].set(kq)
            v_li = v_ca.at[bidx, pos].set(vq)
            ks_li = ks_ca.at[bidx, pos].set(ks_new)
            vs_li = vs_ca.at[bidx, pos].set(vs_new)
        else:
            k_ca, v_ca = ca
            k_li = k_ca.at[bidx, pos].set(k[:, 0].astype(k_ca.dtype))
            v_li = v_ca.at[bidx, pos].set(v[:, 0].astype(v_ca.dtype))

        # GQA without repeating KV: fold the group into the query head dim so the
        # cache streams from HBM once (decode is bandwidth-bound).
        group = cfg.num_heads // cfg.num_kv_heads
        qg = q[:, 0].reshape(B, cfg.num_kv_heads, group, hd)        # [B,KVH,g,hd]
        kk = jax.lax.slice_in_dim(k_li, 0, W, axis=1).astype(compute_dtype)
        vv = jax.lax.slice_in_dim(v_li, 0, W, axis=1).astype(compute_dtype)
        s = jnp.einsum("bkgd,btkd->bkgt", qg, kk,
                       preferred_element_type=jnp.float32) / math.sqrt(hd)
        if quant:
            # int8 cache: the convert above fuses into the dot; the per-(t,
            # head) K scale commutes through q.k_t and lands on the SCORES
            ks_w = jax.lax.slice_in_dim(ks_li, 0, W, axis=1)       # [B,W,KVH]
            s = s * jnp.transpose(ks_w, (0, 2, 1))[:, :, None, :]
        t_idx = jnp.arange(W)[None, None, None, :]
        s = jnp.where(t_idx <= pos[:, None, None, None], s, -1e30)
        p = jax.nn.softmax(s, axis=-1)
        if quant:
            # V scale likewise commutes through p_t.v_t: scale p per (t, head)
            vs_w = jax.lax.slice_in_dim(vs_li, 0, W, axis=1)
            p = p * jnp.transpose(vs_w, (0, 2, 1))[:, :, None, :]
        o = jnp.einsum("bkgt,btkd->bkgd", p.astype(compute_dtype), vv,
                       preferred_element_type=jnp.float32).astype(compute_dtype)
        o = o.reshape(B, 1, cfg.num_heads * hd)
        x = x + L.linear(lp["o_proj"], o)
        h = L.rms_norm(lp["post_attention_layernorm"], x, eps=cfg.rms_norm_eps)
        h = _moe(lp, h, cfg)[0] if cfg.num_experts > 0 else _mlp(lp, h)
        new = (k_li, v_li, ks_li, vs_li) if quant else (k_li, v_li)
        return x + h, new

    if isinstance(params["layers"], dict):
        # pre-stacked layers (stack_layers layout): lax.scan compiles ONE layer
        # body and streams weights + cache slices — no per-layer unroll, no
        # in-graph restack of the cache.
        def body(x, inp):
            x, new = layer_decode(inp[0], x, inp[1:])
            return x, new

        x, new_arrays = jax.lax.scan(body, x, (params["layers"],) + arrays)
    else:
        outs = []
        for li, lp in enumerate(params["layers"]):
            x, new = layer_decode(lp, x, tuple(a[li] for a in arrays))
            outs.append(new)
        new_arrays = tuple(jnp.stack([o[j] for o in outs])
                           for j in range(len(arrays)))

    x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
    logits = _lm_head(params, x)[:, 0]
    cache = {"k": new_arrays[0], "v": new_arrays[1], "length": pos + 1}
    if quant:
        cache["k_scale"], cache["v_scale"] = new_arrays[2], new_arrays[3]
    return logits, cache
