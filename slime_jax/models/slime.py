"""SliME multimodal fusion model: ViT -> gated projector / local compression ->
text-guided selection -> static-shape token splice -> LLM.

Rebuilds the reference fusion core (llava/model/llava_arch.py:212-459) without its
per-sample Python loops:

- ``encode_images``: the global view runs the full gated-MoE projector; local crops
  run the compression layer (post_qformer 576->144) then the projector's MLP expert;
  text-guided top-p keeps a subset of local tokens (llava_arch.py:212-269). All of it
  batched over [B * MAX_CROPS] with crop masks — no ragged lists.
- ``splice``: the reference splits each sample at IMAGE_TOKEN_INDEX (-200), embeds
  text, concatenates image features, pads to batch max (llava_arch.py:274-459). Here
  the expanded sequence [text-before | image-block | text-after] is built by a
  vectorized gather, invalid slots (unselected local tokens, the sentinel, padding)
  are dropped by a cumsum-compaction scatter, and the result is truncated to the
  static ``tokenizer_model_max_length``. One XLA program, any batch.

Token budget: T_img = 576 (global) + 1 (separator) + max_local_crops * 144 (local).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import SliMEConfig
from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from ..parallel.mesh import constrain_batch_act
from . import llama, projector, sampler, vit


class FusedBatch(NamedTuple):
    embeds: jnp.ndarray      # [B, L, H]
    attn_mask: jnp.ndarray   # [B, L] bool (right-aligned contiguous)
    positions: jnp.ndarray   # [B, L] int32
    labels: jnp.ndarray      # [B, L] int32 (IGNORE_INDEX on image/pad slots)
    lengths: jnp.ndarray     # [B] int32 valid lengths


def init(rng, cfg: SliMEConfig) -> Dict:
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    params = {
        "vision": vit.init(k1, cfg.vision),
        "projector": projector.init(k2, cfg),
        "llm": llama.init(k4, cfg.llm),
    }
    if cfg.has_sampler:
        params["sampler"] = sampler.init(k3, cfg)
    if "unpad" in cfg.mm_patch_merge_type:
        # learned row separator (reference image_newline, llava_arch.py:41-44)
        params["image_newline"] = (jax.random.normal(
            jax.random.fold_in(rng, 5), (cfg.hidden_size,), jnp.float32)
            / (cfg.hidden_size ** 0.5))
    return params


def image_token_budget(cfg: SliMEConfig) -> int:
    n_global = cfg.vision.num_patches
    if not cfg.has_sampler:
        # no compression layer: every crop contributes its full patch grid
        # (reference else-branch, llava_arch.py:257-260)
        return (1 + cfg.max_local_crops) * n_global
    return n_global + 1 + cfg.max_local_crops * cfg.mm_resampler_dim


def _text_embeds_for_selector(params, input_ids, attention_mask):
    """Embeddings/mask of the text with the image sentinel masked out.

    The reference physically removes the sentinel and re-pads
    (get_pure_text_embedding, llava_arch.py:162-210); both selector variants are
    permutation-invariant over masked keys, so masking is equivalent.
    """
    is_img = input_ids == IMAGE_TOKEN_INDEX
    safe_ids = jnp.where(is_img, 0, input_ids)
    emb = llama.embed(params["llm"], safe_ids)
    mask = attention_mask.astype(bool) & ~is_img
    return emb, mask


def encode_images(params, cfg: SliMEConfig, pixel_values, crop_mask,
                  input_ids, attention_mask, *, training: bool = False,
                  rng: Optional[jax.Array] = None, local_token_perm=None,
                  unpad_order=None, remat: bool = False,
                  compute_dtype=jnp.float32, mesh=None,
                  batch_axes=("data", "fsdp")) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (img_embeds [B, T_img, H], img_valid [B, T_img]).

    pixel_values [B, MC, 3, t, t]; crop_mask [B, MC] (slot 0 = global view).

    ``mesh``: when training sharded, fusion-region activations are pinned to
    the canonical batch-over-DP sharding (parallel.mesh.constrain_batch_act) so
    GSPMD never mixes weight-propagated hidden-dim shardings into the
    splice/selection gathers (the "involuntary full rematerialization" class
    of fallback reshardings).
    """
    B, MC = pixel_values.shape[:2]
    n_local_crops = MC - 1
    P = cfg.vision.num_patches
    dim = cfg.mm_resampler_dim

    if pixel_values.dtype == jnp.uint8:
        # uint8 transport: the host ships raw [0,255] crops at 1/4 the float32
        # bytes (process_anyres_image_host(normalize=False)) and CLIP
        # normalization runs here, in fp32 before the compute-dtype cast —
        # the same arithmetic the host path applies, so results are identical
        from ..constants import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
        mean = jnp.asarray(CLIP_IMAGE_MEAN, jnp.float32).reshape(3, 1, 1)
        std = jnp.asarray(CLIP_IMAGE_STD, jnp.float32).reshape(3, 1, 1)
        pixel_values = (pixel_values.astype(jnp.float32) / 255.0 - mean) / std

    feats = vit.apply(params["vision"],
                      pixel_values.reshape(B * MC, *pixel_values.shape[2:])
                      .astype(compute_dtype),
                      cfg.vision, remat=remat)        # [B*MC, P, mm]
    feats = feats.reshape(B, MC, P, -1)
    feats = constrain_batch_act(feats, mesh, batch_axes)

    if not cfg.has_sampler:
        # identity resampler: no compression/selection — all crops' patch tokens
        # flow through the projector and flat-merge (llava_arch.py:257-260)
        proj = projector.apply(params["projector"],
                               feats.reshape(B * MC, P, -1), cfg=cfg,
                               training=training, rng=rng)
        if "unpad" in cfg.mm_patch_merge_type and unpad_order is not None:
            # LLaVA-NeXT merge (llava_arch.py:314-331): base view first, then the
            # host-ordered unpadded spatial tokens with learned newline separators
            unpad_src, unpad_valid = unpad_order
            base = proj.reshape(B, MC, P, -1)[:, 0]              # [B, P, H]
            local = proj.reshape(B, MC, P, -1)[:, 1:].reshape(B, (MC - 1) * P, -1)
            newline = jnp.broadcast_to(
                params["image_newline"].astype(local.dtype),
                (B, 1, local.shape[-1]))
            pool = jnp.concatenate([local, newline], axis=1)     # [B, nloc+1, H]
            # src == -1 marks newline slots -> map to the pool's last row
            idx = jnp.where(unpad_src < 0, pool.shape[1] - 1, unpad_src)
            gathered = jnp.take_along_axis(
                pool, jnp.clip(idx, 0, pool.shape[1] - 1)[..., None], axis=1)
            img_embeds = jnp.concatenate(
                [base.astype(compute_dtype), gathered.astype(compute_dtype)], axis=1)
            img_valid = jnp.concatenate(
                [jnp.repeat(crop_mask[:, :1].astype(bool), P, axis=1),
                 unpad_valid.astype(bool)], axis=1)
            return img_embeds, img_valid
        img_embeds = proj.reshape(B, MC * P, -1).astype(compute_dtype)
        img_valid = jnp.repeat(crop_mask.astype(bool), P, axis=1)
        return img_embeds, img_valid

    # Global path: full gated projector (llava_arch.py:224)
    global_f = projector.apply(params["projector"], feats[:, 0], cfg=cfg,
                               training=training, rng=rng)          # [B, P, H]
    global_f = constrain_batch_act(global_f, mesh, batch_axes)

    # Local path: compression 576->dim, then projector (MLP expert)
    local = feats[:, 1:].reshape(B * n_local_crops, P, -1)
    local_c = sampler.compress(params["sampler"], local, cfg=cfg)   # [B*nc, dim, mm]
    local_p = projector.apply(params["projector"], local_c, cfg=cfg,
                              training=training, rng=rng)           # [B*nc, dim, H]
    # pin at [B*nc, dim, H] BEFORE the reshape: the projector's closing matmul
    # emits hidden-sharded output (weight out-dim rides fsdp), and every
    # backward-pass residual consumer of local_p must see the batch-sharded
    # form or the partitioner re-crosses the boundary per consumer
    local_p = constrain_batch_act(local_p, mesh, batch_axes)
    local_p = local_p.reshape(B, n_local_crops * dim, -1)
    local_p = constrain_batch_act(local_p, mesh, batch_axes)
    token_valid = jnp.repeat(crop_mask[:, 1:].astype(bool), dim, axis=1)  # [B, nc*dim]

    # 'spatial' patch merge: reorder per-crop-major tokens into row-major spatial
    # order with a host-computed permutation (llava_arch.py:235-244); the grid is
    # per-sample, so the permutation arrives as data, keeping shapes static.
    if local_token_perm is not None:
        local_p = jnp.take_along_axis(local_p, local_token_perm[..., None], axis=1)
        token_valid = jnp.take_along_axis(token_valid, local_token_perm, axis=1)

    # Text-guided top-p selection per sample (llava_arch.py:248)
    text_emb, text_mask = _text_embeds_for_selector(params, input_ids, attention_mask)
    text_emb = constrain_batch_act(text_emb, mesh, batch_axes)
    sel_rngs = (jax.random.split(rng, B) if (training and rng is not None)
                else jnp.zeros((B, 2), jnp.uint32))

    def _sel(lf, te, tm, tv, r):
        keep, _ = sampler.select(params["sampler"], lf, te, tm, tv, cfg=cfg,
                                 training=training,
                                 rng=r if training and rng is not None else None)
        return keep

    keep = jax.vmap(_sel)(local_p, text_emb, text_mask, token_valid, sel_rngs)

    sep = llama.embed(params["llm"], jnp.full((B, 1), cfg.seperator, jnp.int32))
    sep = constrain_batch_act(sep, mesh, batch_axes)
    img_embeds = jnp.concatenate(
        [global_f.astype(compute_dtype), sep.astype(compute_dtype),
         local_p.astype(compute_dtype)], axis=1)      # [B, T_img, H]
    img_embeds = constrain_batch_act(img_embeds, mesh, batch_axes)

    ones = jnp.ones((B, 1), bool)
    if cfg.use_global_only:
        img_valid = jnp.concatenate(
            [jnp.ones((B, P), bool), jnp.zeros((B, 1), bool),
             jnp.zeros_like(keep)], axis=1)
    elif cfg.use_local_only:
        img_valid = jnp.concatenate(
            [jnp.zeros((B, P), bool), jnp.zeros((B, 1), bool), keep], axis=1)
    else:
        img_valid = jnp.concatenate([jnp.ones((B, P), bool), ones, keep], axis=1)
    return img_embeds, img_valid


def _splice_one(text_emb, text_valid, text_labels, img_emb, img_valid, img_pos,
                *, max_len: int):
    """Single-sample splice + compaction (vmapped over batch).

    text_emb [S, H]; img_emb [T, H]; img_pos scalar (index of sentinel, or S).
    Output length max_len; right-padded.
    """
    S, H = text_emb.shape
    T = img_emb.shape[0]
    E = S + T

    e = jnp.arange(E)
    in_img = (e >= img_pos) & (e < img_pos + T)
    after = e >= img_pos + T
    # gather source index into concat([text, img]) of length S+T
    src = jnp.where(in_img, S + (e - img_pos),
                    jnp.where(after, e - T, e))
    src = jnp.clip(src, 0, E - 1)

    full_emb = jnp.concatenate([text_emb, img_emb], axis=0)        # [E, H]
    full_valid = jnp.concatenate([text_valid, img_valid], axis=0)
    full_labels = jnp.concatenate(
        [text_labels, jnp.full((T,), IGNORE_INDEX, text_labels.dtype)], axis=0)

    emb_ext = full_emb[src]
    valid_ext = full_valid[src]
    lab_ext = full_labels[src]

    # compact: valid slots move to prefix positions, preserving order
    tgt = jnp.cumsum(valid_ext) - 1
    tgt = jnp.where(valid_ext, tgt, max_len)  # dropped (also catches overflow > max_len)
    tgt = jnp.where(tgt >= max_len, max_len, tgt)

    out_emb = jnp.zeros((max_len + 1, H), emb_ext.dtype).at[tgt].set(emb_ext)[:max_len]
    out_lab = jnp.full((max_len + 1,), IGNORE_INDEX, lab_ext.dtype).at[tgt].set(lab_ext)[:max_len]
    length = jnp.minimum(jnp.sum(valid_ext), max_len)
    mask = jnp.arange(max_len) < length
    out_lab = jnp.where(mask, out_lab, IGNORE_INDEX)
    positions = jnp.arange(max_len, dtype=jnp.int32)
    return out_emb, mask, positions, out_lab, length.astype(jnp.int32)


def prepare_multimodal(params, cfg: SliMEConfig, input_ids, attention_mask,
                       pixel_values, crop_mask, labels=None, *,
                       training: bool = False, rng: Optional[jax.Array] = None,
                       max_len: Optional[int] = None, remat: bool = False,
                       compute_dtype=jnp.float32,
                       return_img_valid: bool = False, mesh=None,
                       batch_axes=("data", "fsdp")) -> FusedBatch:
    """Full fusion: encode images + splice into the token stream.

    input_ids [B, S] with IMAGE_TOKEN_INDEX sentinels; labels [B, S] or None.
    Only the FIRST sentinel per sample expands into image features (SliME's data
    format has one image per sample); later sentinels are dropped from the stream.

    ``return_img_valid=True`` additionally returns the [B, T_img] bool
    pre-compaction image-slot validity (the text-guided selection outcome) —
    the serving engine reconstructs the fused layout from it to key the
    multimodal prefix cache (serve/prefix_cache.py identity streams).
    """
    B, S = input_ids.shape
    if max_len is None:
        max_len = cfg.tokenizer_model_max_length

    img_embeds, img_valid = encode_images(
        params, cfg, pixel_values, crop_mask, input_ids, attention_mask,
        training=training, rng=rng, remat=remat, compute_dtype=compute_dtype,
        mesh=mesh, batch_axes=batch_axes)

    is_img = input_ids == IMAGE_TOKEN_INDEX
    safe_ids = jnp.where(is_img, 0, input_ids)
    text_emb = llama.embed(params["llm"], safe_ids).astype(compute_dtype)
    text_emb = constrain_batch_act(text_emb, mesh, batch_axes)
    text_valid = attention_mask.astype(bool) & ~is_img
    if labels is None:
        labels = jnp.full_like(input_ids, IGNORE_INDEX)
    text_labels = jnp.where(is_img, IGNORE_INDEX, labels)

    has_img = jnp.any(is_img, axis=1)
    first_img = jnp.argmax(is_img, axis=1)
    img_pos = jnp.where(has_img, first_img, S)
    # samples without an image keep a zero image block that compacts away
    img_valid = img_valid & has_img[:, None]

    out = jax.vmap(functools.partial(_splice_one, max_len=max_len))(
        text_emb, text_valid, text_labels, img_embeds, img_valid, img_pos)
    out = (constrain_batch_act(out[0], mesh, batch_axes),) + tuple(out[1:])
    if return_img_valid:
        return FusedBatch(*out), img_valid
    return FusedBatch(*out)




def _splice_multi(text_emb, text_valid, text_labels, img_emb, img_valid,
                  sent_pos, *, max_len: int):
    """Multi-image splice (vmapped over batch): up to N image blocks.

    text_emb [S, H]; img_emb [N, T, H]; img_valid [N, T]; sent_pos [N] (ascending
    sentinel positions; missing images padded with S and masked by img_valid).
    Block k of length T inserts at expanded offset f(k) = sent_pos[k] + k*T; the
    sentinel itself is dropped via text_valid (caller masks it).
    """
    S, H = text_emb.shape
    N, T = img_emb.shape[:2]
    E = S + N * T

    e = jnp.arange(E)
    f = sent_pos + jnp.arange(N) * T                     # block starts [N]
    in_block = (e[None] >= f[:, None]) & (e[None] < (f[:, None] + T))   # [N, E]
    blocks_before = jnp.sum(e[None] >= (f[:, None] + T), axis=0)        # [E]
    which = jnp.argmax(in_block, axis=0)                 # block index (valid when any)
    any_block = jnp.any(in_block, axis=0)

    img_flat = img_emb.reshape(N * T, H)
    img_src = which * T + (e - f[which])                 # index into img_flat
    txt_src = jnp.clip(e - blocks_before * T, 0, S - 1)

    emb_ext = jnp.where(any_block[:, None], img_flat[jnp.clip(img_src, 0, N * T - 1)],
                        text_emb[txt_src])
    valid_ext = jnp.where(any_block,
                          img_valid.reshape(-1)[jnp.clip(img_src, 0, N * T - 1)],
                          text_valid[txt_src])
    lab_ext = jnp.where(any_block, IGNORE_INDEX, text_labels[txt_src])

    tgt = jnp.cumsum(valid_ext) - 1
    tgt = jnp.where(valid_ext, jnp.minimum(tgt, max_len), max_len)
    out_emb = jnp.zeros((max_len + 1, H), emb_ext.dtype).at[tgt].set(emb_ext)[:max_len]
    out_lab = jnp.full((max_len + 1,), IGNORE_INDEX,
                       lab_ext.dtype).at[tgt].set(lab_ext)[:max_len]
    length = jnp.minimum(jnp.sum(valid_ext), max_len)
    mask = jnp.arange(max_len) < length
    out_lab = jnp.where(mask, out_lab, IGNORE_INDEX)
    positions = jnp.arange(max_len, dtype=jnp.int32)
    return out_emb, mask, positions, out_lab, length.astype(jnp.int32)


def sentinel_positions(input_ids, n_max: int):
    """[B, S] -> ascending positions of the first n_max sentinels (pad = S)."""
    B, S = input_ids.shape
    is_img = input_ids == IMAGE_TOKEN_INDEX
    # stable ascending: indices of sentinels first (by position), pads after
    pos = jnp.where(is_img, jnp.arange(S)[None], S)
    return jnp.sort(pos, axis=1)[:, :n_max]


def prepare_multimodal_multi(params, cfg: SliMEConfig, input_ids, attention_mask,
                             pixel_values, crop_mask, labels=None, *,
                             training: bool = False,
                             rng: Optional[jax.Array] = None,
                             max_len: Optional[int] = None, remat: bool = False,
                             compute_dtype=jnp.float32, mesh=None,
                             batch_axes=("data", "fsdp")) -> FusedBatch:
    """Multi-image fusion: pixel_values [B, N, MC, 3, t, t]; crop_mask [B, N, MC].
    Each of the first N '<image>' sentinels expands into its image's feature block.
    """
    B, N = pixel_values.shape[:2]
    S = input_ids.shape[1]
    if max_len is None:
        max_len = cfg.tokenizer_model_max_length

    pv = pixel_values.reshape(B * N, *pixel_values.shape[2:])
    cm = crop_mask.reshape(B * N, -1)
    ids_rep = jnp.repeat(input_ids, N, axis=0)
    attn_rep = jnp.repeat(attention_mask, N, axis=0)
    img_embeds, img_valid = encode_images(
        params, cfg, pv, cm, ids_rep, attn_rep, training=training, rng=rng,
        remat=remat, compute_dtype=compute_dtype, mesh=mesh,
        batch_axes=batch_axes)
    T = img_embeds.shape[1]
    img_embeds = img_embeds.reshape(B, N, T, -1)
    img_valid = img_valid.reshape(B, N, T)
    # images beyond the sample's sentinel count contribute nothing
    sent = sentinel_positions(input_ids, N)               # [B, N]
    has_img = sent < S
    img_valid = img_valid & has_img[:, :, None]
    # an image with no valid crops (all-padding slot) also contributes nothing
    img_valid = img_valid & jnp.any(crop_mask, axis=2)[:, :, None]

    is_img = input_ids == IMAGE_TOKEN_INDEX
    safe_ids = jnp.where(is_img, 0, input_ids)
    text_emb = llama.embed(params["llm"], safe_ids).astype(compute_dtype)
    text_emb = constrain_batch_act(text_emb, mesh, batch_axes)
    text_valid = attention_mask.astype(bool) & ~is_img
    if labels is None:
        labels = jnp.full_like(input_ids, IGNORE_INDEX)
    text_labels = jnp.where(is_img, IGNORE_INDEX, labels)

    out = jax.vmap(functools.partial(_splice_multi, max_len=max_len))(
        text_emb, text_valid, text_labels, img_embeds, img_valid, sent)
    out = (constrain_batch_act(out[0], mesh, batch_axes),) + tuple(out[1:])
    return FusedBatch(*out)


def forward(params, cfg: SliMEConfig, input_ids, attention_mask, pixel_values,
            crop_mask, labels=None, *, training: bool = False,
            rng: Optional[jax.Array] = None, compute_dtype=jnp.float32,
            remat: bool = False,
            scan_layers: bool = False, return_aux: bool = False,
            return_hidden: bool = False, mesh=None,
            batch_axes=("data", "fsdp")):
    """End-to-end forward. Returns (logits [B, L, V] fp32, FusedBatch); with
    return_aux=True also the router load-balancing aux loss (MoE configs).
    return_hidden=True skips the LM head and returns final hidden states
    instead of logits (pair with ops.loss.chunked_cross_entropy)."""
    fused = prepare_multimodal(params, cfg, input_ids, attention_mask,
                               pixel_values, crop_mask, labels,
                               training=training, rng=rng, remat=remat,
                               compute_dtype=compute_dtype, mesh=mesh,
                               batch_axes=batch_axes)
    out = llama.forward(params["llm"], fused.embeds, cfg.llm,
                        positions=fused.positions, compute_dtype=compute_dtype,
                        remat=remat,
                        scan_layers=scan_layers, return_aux=return_aux,
                        return_hidden=return_hidden, mesh=mesh)
    if return_aux:
        return out[0], fused, out[2]
    return out[0], fused


def loss_fn(params, cfg: SliMEConfig, batch, *, training: bool = True,
            rng: Optional[jax.Array] = None, compute_dtype=jnp.float32,
            remat: bool = False,
            scan_layers: bool = False, loss_chunk: Optional[int] = "auto",
            mesh=None, batch_axes=("data", "fsdp")):
    """Next-token cross entropy with IGNORE_INDEX masking (HF shift semantics).
    For MoE configs with cfg.llm.router_aux_loss_coef > 0 the router
    load-balancing loss is added (HF MixtralForCausalLM output_router_logits
    semantics).

    The vocab projection + NLL run CHUNKED over the sequence
    (ops.loss.chunked_cross_entropy): the LLM returns final hidden states and
    the loss never materializes [B, S, V] logits — at Llama-3 widths
    (V=128256, S=2048) that removes ~1 GB of fp32 activations per sample per
    device, the dominant term the reference pays for with ZeRO-3
    (llava/model/language_model/llava_llama.py:41-157 routes through HF's
    dense CE). loss_chunk="auto" picks chunking only when it pays
    (V >= 16384 and S > chunk); pass an int to force a chunk size or None to
    force one dense projection. Both paths are mathematically identical
    (lse - gold == -log_softmax gather); chunking only reorders the
    over-sequence summation."""
    from ..ops.loss import DEFAULT_LOSS_CHUNK, chunked_cross_entropy
    want_aux = cfg.llm.num_experts > 0 and cfg.llm.router_aux_loss_coef > 0
    if loss_chunk == "auto":
        loss_chunk = DEFAULT_LOSS_CHUNK if cfg.llm.vocab_size >= 16384 else None
    head = params["llm"]["lm_head"]
    if batch.get("segment_ids") is not None:
        # packed text-only batch (data/packing.py): block-diagonal attention
        # per segment, per-segment RoPE positions, and a shift mask that
        # never predicts across a segment boundary. Token-count-weighted
        # NLL is EXACT vs the padded batches it replaces.
        seg = batch["segment_ids"]
        embeds = llama.embed(
            params["llm"], batch["input_ids"]).astype(compute_dtype)
        out = llama.forward(params["llm"], embeds, cfg.llm,
                            positions=batch["positions"],
                            segment_ids=seg, compute_dtype=compute_dtype,
                            remat=remat,
                            scan_layers=scan_layers, return_aux=want_aux,
                            return_hidden=True, mesh=mesh)
        hidden = out[0]
        # Fold the segment-boundary rule into the labels: a token is a valid
        # target only if it continues its predecessor's segment (never the
        # first token of a segment, never padding). chunked CE's shift=True
        # then reproduces the reference shift mask exactly.
        continues = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
        prev_ok = jnp.concatenate(
            [jnp.zeros_like(continues[:, :1]), continues], axis=1)
        masked_labels = jnp.where(prev_ok, batch["labels"], IGNORE_INDEX)
        total, count = chunked_cross_entropy(hidden, head, masked_labels,
                                             chunk=loss_chunk)
        count = jnp.maximum(count, 1)
        loss = total / count
        metrics = {"n_target_tokens": count,
                   "packing_efficiency": jnp.mean(seg > 0)}
        if want_aux:
            metrics["router_aux_loss"] = out[2]
            loss = loss + cfg.llm.router_aux_loss_coef * out[2]
        return loss, metrics
    out = forward(params, cfg, batch["input_ids"], batch["attention_mask"],
                  batch["pixel_values"], batch["crop_mask"],
                  batch.get("labels"), training=training, rng=rng,
                  compute_dtype=compute_dtype,
                  remat=remat, scan_layers=scan_layers, return_aux=want_aux,
                  return_hidden=True, mesh=mesh, batch_axes=batch_axes)
    hidden, fused = out[0], out[1]
    total, count = chunked_cross_entropy(hidden, head, fused.labels,
                                         chunk=loss_chunk)
    count = jnp.maximum(count, 1)
    loss = total / count
    metrics = {"n_target_tokens": count}
    if want_aux:
        metrics["router_aux_loss"] = out[2]
        loss = loss + cfg.llm.router_aux_loss_coef * out[2]
    return loss, metrics
