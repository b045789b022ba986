"""Full-sequence attention for the LLM prefill/training path and the ViT.

Replaces the reference's flash-attn CUDA kernels (SURVEY.md §2.9; the reference
monkey-patches LlamaAttention to call flash_attn_varlen_qkvpacked_func,
llava/train/llama_flash_attn_monkey_patch.py:16-93) and HF eager CLIP attention.

One entry point, ``attention``, takes the [B, S, H, D] layout both callers
produce and picks its implementation in one place, ``choose_implementation``:

- "cudnn": cuDNN's fused flash attention, reached through the library call
  ``jax.nn.dot_product_attention(implementation="cudnn")``. GQA is native (kv
  heads are never repeated) and the [B, H, S, S] scores never reach device
  memory. Causal masking skips the masked tiles; a segment mask (packed SFT)
  travels as a [B, 1, S, S] additive bias. Taken on a GPU for bf16/fp16
  operands at head dims cuDNN accepts. Its backward refuses an odd sequence
  length (the ViT's 577), so odd lengths run padded by one position that a
  sequence-length mask hides. Under a device mesh the call runs per device
  in a shard_map (batch over data x fsdp, heads over model), so each device
  runs the kernel on its own query heads and the kv heads they read, with no
  partitioning rule of the library call in between.
- "xla": ``jax.nn.dot_product_attention(implementation="xla")``, which
  materialises the scores. Taken for float32 (the CPU tests) and wherever
  cuDNN does not apply.

Right-padded batches need no extra masking under causal attention: pad keys sit
after every valid query, and pad queries are loss-masked (the static-shape
fusion design in models/slime.py).

``reference_attention`` is the plain float32 oracle the tests and the chip
smoke compare both routes against; it shares no code with them.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

NEG_INF = -1e30
CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)


def choose_implementation(q, k, *, segment_ids=None) -> str:
    """-> "cudnn" or "xla" for q [B, S, H, D], k [B, S, KVH, D]."""
    S, D = q.shape[1], q.shape[3]
    if (jax.devices()[0].platform != "gpu" or q.dtype not in CUDNN_DTYPES
            or D % 8 or D > 256):
        return "xla"
    if segment_ids is not None and S % 2:
        # the odd-length padding below has no segment id to give the pad
        return "xla"
    return "cudnn"


def attention(q, k, v, *, causal: bool, scale: Optional[float] = None,
              segment_ids=None, mesh=None):
    """q [B, S, H, D]; k, v [B, S, KVH, D] (KVH divides H) -> [B, S, H, D].

    segment_ids [B, S] (sequence packing, data/packing.py): attention is
    block-diagonal per segment — position i attends j only when their ids
    match (plus causality). With causal masking the diagonal always survives,
    so padding rows (id 0) never produce an all-masked softmax.

    mesh: the parallel/mesh.py mesh the caller's arrays are sharded over,
    if any."""
    impl = choose_implementation(q, k, segment_ids=segment_ids)
    if impl == "cudnn" and mesh is not None and mesh.size > 1:
        return _per_device(q, k, v, causal=causal, scale=scale,
                           segment_ids=segment_ids, mesh=mesh, impl=impl)
    return _attend(q, k, v, causal=causal, scale=scale,
                   segment_ids=segment_ids, impl=impl)


def _attend(q, k, v, *, causal, scale, segment_ids, impl):
    if impl == "cudnn" and q.shape[1] % 2:
        return _even_length(q, k, v, causal=causal, scale=scale, impl=impl)
    mask = None
    if segment_ids is not None:
        mask = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
    return jax.nn.dot_product_attention(q, k, v, mask=mask, scale=scale,
                                        is_causal=causal, implementation=impl)


def _per_device(q, k, v, *, causal, scale, segment_ids, mesh, impl):
    """_attend on each device's own batch rows and heads. Heads shard in
    contiguous blocks, so a device's query heads map onto its own kv heads
    with the same GQA grouping as the whole array."""
    from jax.sharding import PartitionSpec as P

    size = lambda axes: math.prod(mesh.shape[a] for a in axes)
    batch = tuple(a for a in ("data", "fsdp") if a in mesh.shape)
    if q.shape[0] % size(batch):
        batch = ()
    heads = "model" if ("model" in mesh.shape
                        and k.shape[2] % mesh.shape["model"] == 0) else None
    spec = P(batch or None, None, heads, None)
    args = (q, k, v)
    in_specs = (spec, spec, spec)
    if segment_ids is not None:
        args += (segment_ids,)
        in_specs += (P(batch or None, None),)

    def local(q, k, v, *seg):
        return _attend(q, k, v, causal=causal, scale=scale,
                       segment_ids=seg[0] if seg else None, impl=impl)

    return jax.shard_map(local, mesh=mesh, in_specs=in_specs,
                         out_specs=spec, check_vma=False)(*args)


def _even_length(q, k, v, *, causal, scale, impl):
    """Attention over S + 1 positions whose last one is masked out by the
    sequence lengths, sliced back to S: the same result at an even length."""
    B, S = q.shape[:2]
    pad = lambda x: jnp.pad(x, ((0, 0), (0, 1), (0, 0), (0, 0)))
    lengths = jnp.full((B,), S, jnp.int32)
    out = jax.nn.dot_product_attention(
        pad(q), pad(k), pad(v), scale=scale, is_causal=causal,
        query_seq_lengths=lengths, key_value_seq_lengths=lengths,
        implementation=impl)
    return out[:, :S]


def reference_attention(q, k, v, *, causal=True, scale=None,
                        segment_ids=None):
    """Plain float32 attention, q [B, H, S, D]; k, v [B, KVH, S, D] — the
    numerics oracle (GQA by repeating kv heads)."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q, k, v = (t.astype(jnp.float32) for t in (q, k, v))
    if KVH != H:
        k = jnp.repeat(k, H // KVH, axis=1)
        v = jnp.repeat(v, H // KVH, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        mask = jnp.tril(jnp.ones((S, S), bool))
        s = jnp.where(mask[None, None], s, NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        s = jnp.where(same[:, None], s, NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v)
