"""Chunked next-token cross entropy: never materialize [B, S, V] logits.

At 70B scale (V=128256) full-sequence fp32 logits are the difference between a
training step fitting a 16 GB device and not (parallel/memory_plan.py's head
term). The reference never has to solve this — it fits 70B only via LoRA +
ZeRO-3 (reference README.md:72) where the head term is dwarfed by activations.
Here the loss runs the lm_head projection chunk-by-chunk over the sequence
inside a jax.lax.scan whose body is jax.checkpoint'ed: forward keeps only the
scalar accumulators per chunk, backward rematerializes one chunk's logits at a
time. Peak live logits: one [B, chunk, V] fp32 block (plus its softmax
temporary) instead of [B, S, V].

XLA sees a static-trip-count scan of large matmuls — each chunk's
[B*chunk, H] x [H, V] projection is large enough to tile well, and the lse /
gather epilogue fuses into it.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..constants import IGNORE_INDEX

# One value shared by the executable step (parallel/pipeline.py) and the HBM
# accounting (parallel/memory_plan.py) so the plan models the code as written.
DEFAULT_LOSS_CHUNK = 256


def _head_logits(x, head):
    """Vocab projection for the loss path, fp32 logits.

    ``head`` is either a raw [V, H] weight array or an lm_head param dict
    ({"weight": array-or-quant-dict, optional "lora": {"A","B"}}) so the
    chunked loss composes with a quantized (QLoRA) base and/or LoRA adapters
    exactly like models.layers.linear does on the decode path. Dequant/adapter
    work happens per chunk inside the checkpointed scan body — per-chunk int8
    reads instead of a full live bf16 copy of a 128k-vocab head."""
    w = head["weight"] if isinstance(head, dict) else head
    if isinstance(w, dict):
        from .quantization import dequantize_weight
        w = dequantize_weight(w)
    logits = jnp.einsum("bsh,vh->bsv", x, w.astype(x.dtype),
                        preferred_element_type=jnp.float32)
    if isinstance(head, dict) and "lora" in head:
        a, b = head["lora"]["A"], head["lora"]["B"]
        logits = logits + jnp.einsum(
            "bsr,vr->bsv", jnp.einsum("bsh,rh->bsr", x, a.astype(x.dtype)),
            b.astype(x.dtype), preferred_element_type=jnp.float32)
    return logits


def _dense_nll(x, w, targets, valid):
    logits = _head_logits(x, w)
    safe = jnp.where(valid, targets, 0)
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, safe[..., None], axis=-1)[..., 0]
    nll = lse - gold
    return (jnp.sum(jnp.where(valid, nll, 0.0)),
            jnp.sum(valid).astype(jnp.int32))


def chunked_cross_entropy(x: jnp.ndarray, lm_head_weight: jnp.ndarray,
                          labels: jnp.ndarray, *,
                          chunk: Optional[int] = DEFAULT_LOSS_CHUNK,
                          ignore_index: int = IGNORE_INDEX,
                          shift: bool = True
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(sum_nll fp32 scalar, n_valid int32) for next-token prediction.

    x [B, S, H]: FINAL hidden states (already rms-normed); lm_head_weight
    [V, H]; labels [B, S]. With shift=True (HF semantics) position i predicts
    labels[:, i+1] and the last position is ignored — callers pass unshifted
    labels and never slice, so S stays chunk-divisible. chunk=None or
    chunk >= S falls back to one dense projection.
    """
    B, S, H = x.shape
    if shift:
        targets = jnp.concatenate(
            [labels[:, 1:], jnp.full((B, 1), ignore_index, labels.dtype)], axis=1)
    else:
        targets = labels
    valid = targets != ignore_index

    if chunk is None or chunk >= S:
        return _dense_nll(x, lm_head_weight, targets, valid)

    pad = (-S) % chunk
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
        targets = jnp.pad(targets, ((0, 0), (0, pad)),
                          constant_values=ignore_index)
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
    n = x.shape[1] // chunk
    xs = x.reshape(B, n, chunk, H).swapaxes(0, 1)          # [n, B, C, H]
    ts = targets.reshape(B, n, chunk).swapaxes(0, 1)
    vs = valid.reshape(B, n, chunk).swapaxes(0, 1)

    def body(carry, inp):
        xc, tc, vc = inp
        s, c = carry
        ds, dc = _dense_nll(xc, lm_head_weight, tc, vc)
        return (s + ds, c + dc), None

    (total, count), _ = jax.lax.scan(
        jax.checkpoint(body), (jnp.float32(0.0), jnp.int32(0)), (xs, ts, vs))
    return total, count


def _dense_seq_logp(x, head, targets, valid, weights=None):
    logits = _head_logits(x, head)
    safe = jnp.where(valid, targets, 0)
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, safe[..., None], axis=-1)[..., 0]
    logp = gold - lse
    if weights is None:
        w = valid.astype(jnp.float32)
    else:
        w = jnp.where(valid, weights, 0.0).astype(jnp.float32)
    return jnp.sum(logp * w, axis=-1), jnp.sum(w, axis=-1)


def chunked_sequence_logp(x: jnp.ndarray, lm_head_weight, labels: jnp.ndarray,
                          *, chunk: Optional[int] = DEFAULT_LOSS_CHUNK,
                          ignore_index: int = IGNORE_INDEX, shift: bool = True,
                          weights: Optional[jnp.ndarray] = None
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-sequence sum of log p(target): ([B] fp32, [B] fp32 weight mass).

    The DPO primitive (train/dpo.py): same chunked scan as
    chunked_cross_entropy — the vocab projection never materializes
    [B, S, V] — but accumulating per-ROW log-probabilities instead of a
    batch scalar. ``weights`` [B, S] (aligned with ``labels``, shifted
    identically) scales each target token's log-prob — the reference's
    dpo_token_weighted / dpo_token_weight fields (train.py:152-159;
    RLHF-V-style up-weighting of the tokens that differ between the
    chosen and rejected answers). Unweighted, the returned mass is the
    valid-target count, so logp/mass is the average-per-token variant
    (dpo_use_average)."""
    B, S, H = x.shape
    if shift:
        targets = jnp.concatenate(
            [labels[:, 1:], jnp.full((B, 1), ignore_index, labels.dtype)], axis=1)
        if weights is not None:
            weights = jnp.concatenate(
                [weights[:, 1:], jnp.zeros((B, 1), weights.dtype)], axis=1)
    else:
        targets = labels
    valid = targets != ignore_index

    if chunk is None or chunk >= S:
        return _dense_seq_logp(x, lm_head_weight, targets, valid, weights)

    pad = (-S) % chunk
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
        targets = jnp.pad(targets, ((0, 0), (0, pad)),
                          constant_values=ignore_index)
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
        if weights is not None:
            weights = jnp.pad(weights, ((0, 0), (0, pad)))
    n = x.shape[1] // chunk
    xs = x.reshape(B, n, chunk, H).swapaxes(0, 1)          # [n, B, C, H]
    ts = targets.reshape(B, n, chunk).swapaxes(0, 1)
    vs = valid.reshape(B, n, chunk).swapaxes(0, 1)
    ws = (weights.reshape(B, n, chunk).swapaxes(0, 1)
          if weights is not None else jnp.zeros((n,)))

    def body(carry, inp):
        xc, tc, vc, wc = inp
        s, c = carry
        ds, dc = _dense_seq_logp(xc, lm_head_weight, tc, vc,
                                 wc if weights is not None else None)
        return (s + ds, c + dc), None

    (logp, mass), _ = jax.lax.scan(
        jax.checkpoint(body),
        (jnp.zeros((B,), jnp.float32), jnp.zeros((B,), jnp.float32)),
        (xs, ts, vs, ws))
    return logp, mass


def chunked_ce_mean(x, lm_head_weight, labels, *,
                    chunk: Optional[int] = DEFAULT_LOSS_CHUNK,
                    ignore_index: int = IGNORE_INDEX, shift: bool = True):
    """Mean-over-valid-tokens variant (the training objective)."""
    total, count = chunked_cross_entropy(
        x, lm_head_weight, labels, chunk=chunk, ignore_index=ignore_index,
        shift=shift)
    return total / jnp.maximum(count, 1)
