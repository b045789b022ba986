"""Common functional layers.

Convention: every module is a pair of pure functions
    ``init(rng, ...) -> params``  (dict pytree of jnp arrays)
    ``apply(params, x, ...) -> y``
Params use torch-compatible naming/layout (e.g. Linear weight is [out, in]; attention
uses a packed [3E, E] in-projection) so HF/torch checkpoints map 1:1 in the loader.

Compute policy: matmuls request float32 accumulation (``preferred_element_type``) so
bf16 activations reach the tensor cores with fp32 accumulators.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def linear_init(rng, in_dim: int, out_dim: int, *, bias: bool = True, std: float = 0.02):
    wkey, _ = jax.random.split(rng)
    p = {"weight": jax.random.truncated_normal(wkey, -2, 2, (out_dim, in_dim),
                                               jnp.float32) * std}
    if bias:
        p["bias"] = jnp.zeros((out_dim,), jnp.float32)
    return p


def linear(p, x):
    """x [..., in] @ W.T [in, out] (+ b). Torch layout: weight [out, in].

    Quant-aware: a quantized weight (ops/quantization.py: int8, q4, q4g, NF4)
    is dequantized and fed to one einsum; whether XLA fuses the dequant into
    the matmul or materialises the weight is a property of the compiled graph.

    LoRA-aware: a ``p["lora"] = {"A": [r, in], "B": [out, r]}`` entry
    (train.lora.attach; alpha/r pre-folded into B) adds ``(x @ A.T) @ B.T`` —
    the factored form, so the base weight is never materialized at full
    precision. This is
    what makes QLoRA work: the quantized base streams through its normal
    dequant path while gradients flow only through the
    two small adapter matmuls (reference: PEFT on a bitsandbytes base,
    llava/train/train.py:1036-1052)."""
    w = p["weight"]
    if isinstance(w, dict):
        from ..ops.quantization import dequantize_weight
        w = dequantize_weight(w)
    y = jnp.einsum("...i,oi->...o", x, w.astype(x.dtype),
                   preferred_element_type=jnp.float32).astype(x.dtype)
    if "bias" in p:
        y = y + p["bias"].astype(x.dtype)
    if "lora" in p:
        la = p["lora"]   # {"A": [r, in], "B": [out, r]} — alpha/r pre-folded into B
        xa = jnp.einsum("...i,ri->...r", x, la["A"].astype(x.dtype),
                        preferred_element_type=jnp.float32).astype(x.dtype)
        y = y + jnp.einsum("...r,or->...o", xa, la["B"].astype(x.dtype),
                           preferred_element_type=jnp.float32).astype(x.dtype)
    if "lora_b" in p:
        # multi-LoRA serving (serve/batch_engine.register_adapter): PER-ROW
        # adapters, already gathered to the batch — A [B, r, in], B [B, out,
        # r]; x leads with the same B. Row b gets its own rank-r delta, so
        # one batched step serves many fine-tunes of one base
        la = p["lora_b"]
        xa = jnp.einsum("b...i,bri->b...r", x, la["A"].astype(x.dtype),
                        preferred_element_type=jnp.float32).astype(x.dtype)
        y = y + jnp.einsum("b...r,bor->b...o", xa, la["B"].astype(x.dtype),
                           preferred_element_type=jnp.float32).astype(x.dtype)
    return y


def layer_norm_init(dim: int):
    return {"weight": jnp.ones((dim,), jnp.float32),
            "bias": jnp.zeros((dim,), jnp.float32)}


def layer_norm(p, x, *, eps: float = 1e-6):
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mu), axis=-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * p["weight"] + p["bias"]).astype(x.dtype)


def rms_norm_init(dim: int):
    return {"weight": jnp.ones((dim,), jnp.float32)}


def rms_norm(p, x, *, eps: float = 1e-5):
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    y = xf * jax.lax.rsqrt(var + eps)
    return (y * p["weight"]).astype(x.dtype)


# ----------------------------------------------------------------------------------
# torch-style MultiheadAttention (packed qkv in-projection) — used by the resampler
# and router modules whose checkpoints store nn.MultiheadAttention state dicts.
# ----------------------------------------------------------------------------------

def mha_init(rng, embed_dim: int, *, std: float = 0.02):
    k1, k2 = jax.random.split(rng)
    return {
        "in_proj_weight": jax.random.truncated_normal(k1, -2, 2, (3 * embed_dim, embed_dim),
                                                      jnp.float32) * std,
        "in_proj_bias": jnp.zeros((3 * embed_dim,), jnp.float32),
        "out_proj": linear_init(k2, embed_dim, embed_dim, std=std),
    }


def mha(p, q, k, v, num_heads: int, *, key_padding_mask=None):
    """Batch-first MHA: q [B,Lq,E], k/v [B,Lk,E]; key_padding_mask [B,Lk] True=masked.

    Matches torch.nn.MultiheadAttention numerics (softmax over keys, 1/sqrt(hd) scale).
    """
    E = q.shape[-1]
    hd = E // num_heads
    wq, wk, wv = jnp.split(p["in_proj_weight"], 3, axis=0)
    bq, bk, bv = jnp.split(p["in_proj_bias"], 3, axis=0)
    dt = q.dtype

    def proj(x, w, b):
        return (jnp.einsum("ble,oe->blo", x, w, preferred_element_type=jnp.float32)
                + b).astype(dt)

    qh = proj(q, wq, bq).reshape(*q.shape[:2], num_heads, hd)
    kh = proj(k, wk, bk).reshape(*k.shape[:2], num_heads, hd)
    vh = proj(v, wv, bv).reshape(*v.shape[:2], num_heads, hd)

    scores = jnp.einsum("bqhd,bkhd->bhqk", qh, kh,
                        preferred_element_type=jnp.float32) / math.sqrt(hd)
    if key_padding_mask is not None:
        scores = jnp.where(key_padding_mask[:, None, None, :], -jnp.inf, scores)
    attn = jax.nn.softmax(scores, axis=-1).astype(dt)
    out = jnp.einsum("bhqk,bkhd->bqhd", attn, vh,
                     preferred_element_type=jnp.float32).astype(dt)
    out = out.reshape(*q.shape[:2], E)
    return linear(p["out_proj"], out)


# ----------------------------------------------------------------------------------
# 2-D sincos position embeddings + bicubic grid interpolation (pure JAX/numpy).
# ----------------------------------------------------------------------------------

def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size**2, embed_dim] 2-D sincos table; h-coords fill the first half of the
    channel dim (matching the reference's meshgrid order, sampler.py:39-67)."""
    assert embed_dim % 2 == 0
    coords = np.arange(grid_size, dtype=np.float64)
    gw, gh = np.meshgrid(coords, coords)  # w varies fastest
    emb_h = sincos_1d(embed_dim // 2, gh)
    emb_w = sincos_1d(embed_dim // 2, gw)
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def _cubic_kernel(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys); a=-0.75 matches torch F.interpolate."""
    d = np.abs(d)
    w = np.where(d <= 1, (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1,
                 np.where(d < 2, a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a, 0.0))
    return w


def bicubic_weight_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """[dst, src] interpolation matrix for 1-D bicubic resize, align_corners=False.

    Precomputed on host; a 2-D resize becomes two small matmuls (Wy @ img @ Wx.T),
    which is both exact vs torch and matmul-friendly.
    """
    W = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = math.floor(x)
        t = x - x0
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), src - 1)
            W[i, idx] += _cubic_kernel(np.asarray(t - k), a)
    return W.astype(np.float32)


def pil_resize_matrix(src: int, dst: int, a: float = -0.5) -> np.ndarray:
    """[dst, src] dense weights reproducing PIL's bicubic resize (support scaled by
    the downscale ratio = antialiasing, normalized taps). Lets a 2-D image resize
    run as two matmuls instead of gather ops."""
    W = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    for i in range(dst):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src)
        d = (np.arange(xmin, xmax) - center + 0.5) / fscale
        w = _cubic_kernel(d, a)
        s = w.sum()
        if s != 0:
            W[i, xmin:xmax] = w / s
    return W.astype(np.float32)


def interp_pos_embed(pos: jnp.ndarray, tgt: Tuple[int, int]) -> jnp.ndarray:
    """Bicubic-resample a [S*S, C] position table to a [th*tw, C] grid with
    torch-compatible weights (reference get_abs_pos, sampler.py:27-36)."""
    s = int(math.isqrt(pos.shape[0]))
    th, tw = tgt
    if (th, tw) == (s, s):
        return pos
    grid = pos.reshape(s, s, -1).astype(jnp.float32)
    wy = jnp.asarray(bicubic_weight_matrix(s, th))
    wx = jnp.asarray(bicubic_weight_matrix(s, tw))
    out = jnp.einsum("ys,sxc->yxc", wy, grid, preferred_element_type=jnp.float32)
    out = jnp.einsum("xs,ysc->yxc", wx, out, preferred_element_type=jnp.float32)
    return out.reshape(th * tw, -1).astype(pos.dtype)
