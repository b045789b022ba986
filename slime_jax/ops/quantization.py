"""Weight-only quantization: int8 / int4 with per-channel scales.

Replaces bitsandbytes' 4/8-bit quantized load (SURVEY.md §2.12; reference wires it
at llava/train/train.py:956-972 and model/builder.py:32-41). Weights are
stored as int8 (or int4 packed in int8 pairs) with fp32 per-output-channel
scales; models/layers.linear dequantizes them and feeds one einsum, so the
stored weight bytes drop 2-4x while the matmul sees bf16 operands.

int4 comes in three schemes, chosen by measurement (scripts/
bench_quant_accuracy.py at true 8B width, r3):
  - "q4" per-row absmax: simplest packing but ~15%
    per-weight error on gaussian weights — a capacity/draft option only;
  - "q4" group-G absmax: marginally better on gaussian (absmax ~ sqrt(log n));
  - "nf4" group-64 codebook (the bitsandbytes NF4 table, QLoRA §3): the
    information-theoretic fix — quantile codebook for normal weights, ~2x
    lower RMS than uniform int4 — and the reference's own load_4bit path
    (model/builder.py:32-41 -> bnb NF4 blocksize 64), so load_bits=4
    defaults to it.
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

# bitsandbytes' NF4 data type: 16 quantiles of N(0,1) scaled to [-1, 1]
# (QLoRA, Dettmers et al. 2023, Appendix E / bnb functional.py)
NF4_CODEBOOK = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)
_NF4_MIDPOINTS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2


def quantize_weight(w: jnp.ndarray, bits: int = 8,
                    group: Optional[int] = None) -> Dict:
    """w [..., out, in] fp -> {"q"| "q4": int8 [..., out, in(/2 for int4)],
    "scale": [..., out, n_groups]}. Works on pre-stacked [L, out, in] layer
    trees too (packing/scales always along the LAST dim).

    group=None: one absmax scale per output row (n_groups == 1). group=G:
    one scale per G input columns — the r3 accuracy measurement
    (docs/Serving.md) shows per-row absmax int4 destroys logits (~89%
    relative error at 8B width) while group-128 int4 lands within ~2x of
    int8; this is the same reason bitsandbytes' NF4 uses blocksize 64.

    The bit-width lives in the KEY ("q" = int8, "q4" = packed int4), not a leaf, so
    quantized trees pass through jit without tracing a static attribute."""
    assert bits in (4, 8)
    wf = jnp.asarray(w, jnp.float32)
    qmax = 127.0 if bits == 8 else 7.0
    if group is not None:
        IN = wf.shape[-1]
        assert IN % group == 0, (IN, group)
        g = wf.reshape(*wf.shape[:-1], IN // group, group)
        absmax = jnp.max(jnp.abs(g), axis=-1)                # [..., out, n_g]
        scale = jnp.where(absmax > 0, absmax / qmax, 1.0)
        q = jnp.clip(jnp.round(g / scale[..., None]), -qmax, qmax)
        q = q.reshape(wf.shape).astype(jnp.int8)
    else:
        absmax = jnp.max(jnp.abs(wf), axis=-1, keepdims=True)
        scale = jnp.where(absmax > 0, absmax / qmax, 1.0)
        q = jnp.clip(jnp.round(wf / scale), -qmax, qmax).astype(jnp.int8)
    if bits == 4:
        # pack two nibbles per int8: even columns in low nibble
        lo = q[..., 0::2] & 0xF
        hi = (q[..., 1::2] & 0xF) << 4
        q = (lo | hi).astype(jnp.int8)
        return {"q4": q, "scale": scale.astype(jnp.float32)}
    return {"q": q, "scale": scale.astype(jnp.float32)}


def quantize_weight_q4g(w: jnp.ndarray, group: int = 128) -> Dict:
    """Group-wise absmax int4 in the "q4g" packing: {"q4g": int8
    [..., out, in/2], "scale": [..., out, in/group]}.

    Packing: packed block b (a ``group``-wide lane chunk) holds group 2b in
    its LOW nibbles and group 2b+1 in its HIGH nibbles — so with group=128
    every per-group slice (packed block, x chunk) is a contiguous 128-wide
    slice, and x needs no column permutation at all
    (unlike "q4"'s even/odd pairing). Numerics are identical to
    quantize_weight(bits=4, group=group) — only the byte layout differs —
    so the accuracy measurements for group-G absmax int4
    (docs/Serving.md) carry over unchanged."""
    wf = jnp.asarray(w, jnp.float32)
    IN = wf.shape[-1]
    assert IN % (2 * group) == 0, (IN, group)
    g = wf.reshape(*wf.shape[:-1], IN // group, group)
    absmax = jnp.max(jnp.abs(g), axis=-1)                    # [..., out, n_g]
    scale = jnp.where(absmax > 0, absmax / 7.0, 1.0)
    q = jnp.clip(jnp.round(g / scale[..., None]), -7, 7).astype(jnp.int8)
    pairs = q.reshape(*wf.shape[:-1], IN // (2 * group), 2, group)
    lo = pairs[..., 0, :] & 0xF
    hi = (pairs[..., 1, :] & 0xF) << 4
    packed = (lo | hi).astype(jnp.int8).reshape(*wf.shape[:-1], IN // 2)
    return {"q4g": packed, "scale": scale.astype(jnp.float32)}


def quantize_weight_nf4(w: jnp.ndarray, group: int = 64) -> Dict:
    """w [..., out, in] -> {"nf4": packed idx int8 [..., out, in/2],
    "scale": [..., out, in/group]}. Per-group absmax scaling + the NF4
    codebook (nearest quantile), exactly bnb's Linear4bit storage layout in
    spirit; packing matches the q4 convention (even columns low nibble)."""
    wf = jnp.asarray(w, jnp.float32)
    IN = wf.shape[-1]
    assert IN % group == 0, (IN, group)
    g = wf.reshape(*wf.shape[:-1], IN // group, group)
    absmax = jnp.max(jnp.abs(g), axis=-1)
    scale = jnp.where(absmax > 0, absmax, 1.0)
    norm = (g / scale[..., None]).reshape(wf.shape)          # in [-1, 1]
    idx = jnp.searchsorted(jnp.asarray(_NF4_MIDPOINTS), norm).astype(jnp.int8)
    lo = idx[..., 0::2] & 0xF
    hi = (idx[..., 1::2] & 0xF) << 4
    return {"nf4": (lo | hi).astype(jnp.int8),
            "scale": scale.astype(jnp.float32)}


def is_quantized(leaf) -> bool:
    return (isinstance(leaf, dict) and "scale" in leaf
            and ("q" in leaf or "q4" in leaf or "q4g" in leaf or "nf4" in leaf))


def dequantize_weight(qw: Dict) -> jnp.ndarray:
    if "q4g" in qw:
        p = qw["q4g"]
        scale = qw["scale"]
        IN = p.shape[-1] * 2
        n_g = scale.shape[-1]
        group = IN // n_g
        blocks = p.reshape(*p.shape[:-1], n_g // 2, group)
        lo = (blocks & 0xF).astype(jnp.int8)
        lo = jnp.where(lo >= 8, lo - 16, lo)
        hi = ((blocks >> 4) & 0xF).astype(jnp.int8)
        hi = jnp.where(hi >= 8, hi - 16, hi)
        q = jnp.stack([lo, hi], axis=-2)         # [..., out, n_g/2, 2, group]
        q = q.reshape(*scale.shape, group)       # [..., out, n_g, group]
        return (q.astype(jnp.float32) * scale[..., None]).reshape(
            *p.shape[:-1], IN)
    if "nf4" in qw:
        p = qw["nf4"]
        lo = (p & 0xF).astype(jnp.int32)
        hi = ((p >> 4) & 0xF).astype(jnp.int32)
        idx = jnp.stack([lo, hi], axis=-1).reshape(*p.shape[:-1], -1)
        vals = jnp.take(jnp.asarray(NF4_CODEBOOK), idx)
        scale = qw["scale"]
        IN = vals.shape[-1]
        group = IN // scale.shape[-1]
        vals = vals.reshape(*vals.shape[:-1], scale.shape[-1], group)
        return (vals * scale[..., None]).reshape(*scale.shape[:-1], IN)
    if "q4" in qw:
        q = qw["q4"]
        lo = (q & 0xF).astype(jnp.int8)
        lo = jnp.where(lo >= 8, lo - 16, lo)
        hi = ((q >> 4) & 0xF).astype(jnp.int8)
        hi = jnp.where(hi >= 8, hi - 16, hi)
        out = jnp.stack([lo, hi], axis=-1).reshape(*q.shape[:-1], -1)
    else:
        out = qw["q"]
    scale = qw["scale"]
    if scale.shape[-1] > 1:  # group-wise: expand each group scale over IN/n_g
        IN = out.shape[-1]
        group = IN // scale.shape[-1]
        out = out.reshape(*out.shape[:-1], scale.shape[-1], group)
        return (out.astype(jnp.float32) * scale[..., None]).reshape(
            *scale.shape[:-1], IN)
    return out.astype(jnp.float32) * scale


def quantized_linear(qw: Dict, x: jnp.ndarray, bias: Optional[jnp.ndarray] = None,
                     compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """x [..., in] @ dequant(W).T — dequant fused into the matmul epilogue."""
    w = dequantize_weight(qw).astype(compute_dtype)
    y = jnp.einsum("...i,oi->...o", x.astype(compute_dtype), w,
                   preferred_element_type=jnp.float32).astype(x.dtype)
    if bias is not None:
        y = y + bias.astype(x.dtype)
    return y


def quantize_params(params, bits: int = 8, *, min_size: int = 1 << 16,
                    scheme: str = "default"):
    """Quantize every 2-D weight leaf larger than min_size elements; other leaves
    pass through. Returns a tree where such leaves become quant dicts.

    scheme: "default" = per-row absmax for int8, NF4 group-64 for int4 (the
    bitsandbytes-parity, accuracy-safe choice — see module docstring);
    "absmax" forces uniform int4 per-row (documented quality cost); "group"
    = group-128 absmax int4 in the "q4g" packing (group accuracy)."""
    use_nf4 = bits == 4 and scheme == "default"
    use_q4g = bits == 4 and scheme == "group"

    def conv(leaf):
        if (hasattr(leaf, "ndim") and leaf.ndim == 2
                and leaf.size >= min_size
                and jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating)):
            if use_nf4 and leaf.shape[-1] % 64 == 0:
                return quantize_weight_nf4(jnp.asarray(leaf), group=64)
            if use_q4g and leaf.shape[-1] % 256 == 0:
                return quantize_weight_q4g(jnp.asarray(leaf), group=128)
            return quantize_weight(jnp.asarray(leaf), bits)
        return leaf

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return conv(node)

    return walk(params)


def dequantize_params(params):
    """Inverse of quantize_params (for running the standard fp forward)."""

    def walk(node):
        if isinstance(node, dict):
            if is_quantized(node):
                return dequantize_weight(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def quantization_error(w, bits: int = 8) -> float:
    qw = quantize_weight(jnp.asarray(w), bits)
    return float(jnp.mean(jnp.abs(dequantize_weight(qw) - jnp.asarray(w, jnp.float32))))
