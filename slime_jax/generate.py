"""Autoregressive generation: multimodal prefill + jitted KV-cache decode.

Replaces HF ``GenerationMixin`` as used by the reference
(llava/model/language_model/llava_llama.py:106-144, serve/eval greedy loops):

- Prefill runs the fusion forward once and fills the KV cache
  (prepare_inputs_labels_for_multimodal happens only here; later steps skip it —
  reference short-circuit at llava_arch.py:279-280).
- Decode is a ``lax.while_loop`` entirely on device: one token per step, greedy or
  temperature/top-p sampling, early-exit when every row has hit EOS. Generated ids
  land in a fixed [B, max_new_tokens] buffer; stop-*string* trimming happens on host
  afterwards (StopStringMatcher), which preserves KeywordsStoppingCriteria semantics
  without a per-token device->host sync.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import SliMEConfig
from .models import llama, slime


def sample_token(rng, logits, *, temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0):
    """logits [B, V] fp32 -> token [B]. temperature<=0 means greedy;
    top_k>0 restricts sampling to the k highest logits (HF semantics,
    applied before top_p)."""
    if temperature <= 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    logits = logits / temperature
    if top_k > 0 and top_k < logits.shape[-1]:
        kth = jnp.sort(logits, axis=-1)[:, -top_k][:, None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # keep tokens whose cumulative prob (exclusive) < top_p
        cutoff_idx = jnp.sum(cum - probs < top_p, axis=-1) - 1
        cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx[:, None], axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return jax.random.categorical(rng, logits, axis=-1).astype(jnp.int32)


def sample_token_dynamic(rng, logits, temperature, top_p, top_k=None,
                         min_p=None):
    """Traced-per-row variant of :func:`sample_token` for the batched serving
    engine, where every slot carries its own sampling knobs: logits [B, V]
    fp32, ``temperature``/``top_p``/``top_k``/``min_p`` are [B] runtime
    arrays (no recompile per knob change). Rows with temperature <= 0 are
    greedy; top_p >= 1, top_k <= 0, min_p <= 0 mean "off" per row. Filter
    order matches HF's warper chain (temperature, top_k, top_p, min_p); the
    nucleus rule is sample_token's (the token whose EXCLUSIVE cumulative
    prob crosses top_p is kept). top_k rides the same [B, V] sort top_p
    already pays for; min_p needs only a row max. ``top_k``/``min_p`` =
    None compiles the corresponding filter out entirely."""
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    scaled = logits / jnp.maximum(temperature, 1e-6)[:, None]
    sorted_logits = jnp.sort(scaled, axis=-1)[:, ::-1]
    filt = scaled
    if top_k is not None:
        V = logits.shape[-1]
        kth_idx = jnp.clip(top_k.astype(jnp.int32), 1, V) - 1
        kth = jnp.take_along_axis(sorted_logits, kth_idx[:, None], axis=-1)
        filt = jnp.where((top_k[:, None] > 0) & (scaled < kth), -jnp.inf,
                         filt)
        # HF chains top_p AFTER top_k: the nucleus is computed over the
        # top-k-filtered distribution (sorted positions >= k drop out)
        keepk = ((top_k[:, None] <= 0)
                 | (jnp.arange(V)[None] < jnp.maximum(top_k, 0)[:, None]))
        sorted_logits = jnp.where(keepk, sorted_logits, -jnp.inf)
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    cutoff_idx = jnp.sum(cum - probs < top_p[:, None], axis=-1) - 1
    cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx[:, None], axis=-1)
    filt = jnp.where((top_p[:, None] < 1.0) & (scaled < cutoff), -jnp.inf,
                     filt)
    if min_p is not None:
        # HF MinPLogitsWarper: drop tokens with prob < min_p * max_prob,
        # evaluated where it sits in the chain (after top_k/top_p masking)
        row_probs = jax.nn.softmax(filt, axis=-1)
        pmax = jnp.max(row_probs, axis=-1, keepdims=True)
        filt = jnp.where((min_p[:, None] > 0.0)
                         & (row_probs < min_p[:, None] * pmax), -jnp.inf,
                         filt)
    sampled = jax.random.categorical(rng, filt, axis=-1).astype(jnp.int32)
    return jnp.where(temperature > 0, sampled, greedy)


@functools.partial(jax.jit, static_argnames=("cfg", "max_new_tokens", "temperature",
                                             "top_p", "compute_dtype"))
def _decode_loop(params_llm, cache, first_token, rng, eos_id, *, cfg,
                 max_new_tokens: int, temperature: float, top_p: float,
                 compute_dtype):
    B = first_token.shape[0]
    tokens = jnp.zeros((B, max_new_tokens), jnp.int32)
    tokens = tokens.at[:, 0].set(first_token)
    done = first_token == eos_id

    def cond(state):
        i, _, _, done, _ = state
        return (i < max_new_tokens) & ~jnp.all(done)

    def body(state):
        i, cache, tokens, done, rng = state
        cur = tokens[:, jnp.maximum(i - 1, 0)]
        logits, cache = llama.decode_step(params_llm, cache, cur, cfg.llm,
                                          compute_dtype=compute_dtype)
        rng, sub = jax.random.split(rng)
        nxt = sample_token(sub, logits, temperature=temperature, top_p=top_p)
        nxt = jnp.where(done, eos_id, nxt)
        tokens = tokens.at[:, i].set(nxt)
        done = done | (nxt == eos_id)
        return i + 1, cache, tokens, done, rng

    _, cache, tokens, done, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(1), cache, tokens, done, rng))
    return tokens, cache


def generate(params, cfg: SliMEConfig, input_ids, attention_mask,
             pixel_values=None, crop_mask=None, *,
             max_new_tokens: int = 128, temperature: float = 0.0,
             top_p: float = 1.0, rng: Optional[jax.Array] = None,
             eos_id: Optional[int] = None, compute_dtype=jnp.float32, cache_len: Optional[int] = None,
             mesh=None, kv_quant: bool = False):
    """Multimodal generate. Returns generated token ids [B, <=max_new_tokens] (numpy),
    cut at EOS per row by the caller via ``trim_at_eos``.

    ``mesh``: a parallel.mesh device mesh enables tensor-parallel inference —
    params shard by the Megatron rules (pre-sharded params are used as-is),
    the KV cache shards its kv-head dim on the ``model`` axis, and GSPMD
    partitions prefill + the decode loop (one psum per o_proj/down_proj). This is how a 70B serves across chips — a capability the reference
    lacks entirely (its serving is one whole model per GPU worker).

    ``kv_quant``: int8 KV cache (llama.init_kv_cache) — half the cache memory
    and read traffic, ~1% attention-output error.
    """
    if rng is None:
        rng = jax.random.PRNGKey(0)
    if eos_id is None:
        eos_id = cfg.eos_token_id
    if mesh is not None:
        from .parallel import mesh as mesh_lib
        if not mesh_lib.on_mesh(params, mesh):
            params = mesh_lib.shard_params(mesh, params)
    B, S = input_ids.shape

    if pixel_values is not None:
        prep = (slime.prepare_multimodal_multi if pixel_values.ndim == 6
                else slime.prepare_multimodal)
        fused = prep(params, cfg, input_ids, attention_mask, pixel_values,
                     crop_mask, training=False, compute_dtype=compute_dtype)
        embeds, positions, lengths = fused.embeds, fused.positions, fused.lengths
    else:
        embeds = llama.embed(params["llm"], jnp.where(input_ids < 0, 0, input_ids)
                             ).astype(compute_dtype)
        lengths = jnp.sum(attention_mask.astype(jnp.int32), axis=1)
        positions = None

    # logits only at the last valid position (logit_positions): full-sequence
    # fp32 logits at 8B are ~0.9 GB per 1k tokens of pure prefill waste
    idx = jnp.maximum(lengths - 1, 0)
    logits, kvs = llama.forward(params["llm"], embeds, cfg.llm,
                                positions=positions,
                                return_kv=True, compute_dtype=compute_dtype,
                                logit_positions=idx, mesh=mesh)
    L = embeds.shape[1]
    if cache_len is None:
        cache_len = L + max_new_tokens
    cache = llama.init_kv_cache(cfg.llm, B, cache_len, dtype=compute_dtype,
                                quantized=kv_quant)
    if mesh is not None:
        from .parallel import mesh as mesh_lib
        cache = mesh_lib.shard_kv_cache(mesh, cache)
    cache = llama.prefill_into_cache(cache, kvs, lengths)

    last_logits = logits[:, 0]
    rng, sub = jax.random.split(rng)
    first = sample_token(sub, last_logits, temperature=temperature, top_p=top_p)

    tokens, _ = _decode_loop(params["llm"], cache, first, rng,
                             jnp.asarray(eos_id, jnp.int32), cfg=cfg,
                             max_new_tokens=max_new_tokens,
                             temperature=temperature, top_p=top_p,
                             compute_dtype=compute_dtype)
    return tokens


def generate_stream(params, cfg: SliMEConfig, tokenizer, input_ids, attention_mask,
                    pixel_values=None, crop_mask=None, *,
                    max_new_tokens: int = 256, temperature: float = 0.0,
                    top_p: float = 1.0, rng: Optional[jax.Array] = None,
                    stop_strings=(), chunk: int = 16,
                    compute_dtype=jnp.float32, mesh=None,
                    kv_quant: bool = False):
    """Streaming generation for serving: decode in jitted chunks, yield the text so
    far after each chunk (TextIteratorStreamer semantics without per-token host
    syncs). Single-sample (B == 1). Stops on EOS or any stop string.
    ``mesh`` enables tensor-parallel decoding (see generate()).
    """
    from .data.tokenization import StopStringMatcher

    if rng is None:
        rng = jax.random.PRNGKey(0)
    if mesh is not None:
        from .parallel import mesh as mesh_lib
        if not mesh_lib.on_mesh(params, mesh):
            params = mesh_lib.shard_params(mesh, params)
    eos_id = cfg.eos_token_id
    matcher = StopStringMatcher(stop_strings, tokenizer) if stop_strings else None

    if pixel_values is not None:
        prep = (slime.prepare_multimodal_multi if pixel_values.ndim == 6
                else slime.prepare_multimodal)
        fused = prep(params, cfg, input_ids, attention_mask, pixel_values,
                     crop_mask, training=False, compute_dtype=compute_dtype)
        embeds, positions, lengths = fused.embeds, fused.positions, fused.lengths
    else:
        embeds = llama.embed(params["llm"], jnp.where(input_ids < 0, 0, input_ids)
                             ).astype(compute_dtype)
        lengths = jnp.sum(attention_mask.astype(jnp.int32), axis=1)
        positions = None

    idx = jnp.maximum(lengths - 1, 0)
    logits, kvs = llama.forward(params["llm"], embeds, cfg.llm,
                                positions=positions, return_kv=True,
                                compute_dtype=compute_dtype,
                                logit_positions=idx, mesh=mesh)
    cache = llama.init_kv_cache(cfg.llm, embeds.shape[0],
                                embeds.shape[1] + max_new_tokens + 1,
                                dtype=compute_dtype, quantized=kv_quant)
    if mesh is not None:
        from .parallel import mesh as mesh_lib
        cache = mesh_lib.shard_kv_cache(mesh, cache)
    cache = llama.prefill_into_cache(cache, kvs, lengths)
    last_logits = logits[:, 0]
    rng, sub = jax.random.split(rng)
    cur = sample_token(sub, last_logits, temperature=temperature, top_p=top_p)

    # _decode_loop emits its first_token at index 0 and feeds it to the model as it
    # samples the rest; the chunk's last token is sampled but not yet consumed, so
    # it seeds the next chunk (and is skipped on re-emission).
    generated = []
    done = False
    first_chunk = True
    while len(generated) < max_new_tokens and not done:
        n = min(chunk, max_new_tokens - len(generated)) + (0 if first_chunk else 1)
        toks, cache = _decode_loop(params["llm"], cache, cur, rng,
                                   jnp.asarray(eos_id, jnp.int32), cfg=cfg,
                                   max_new_tokens=n, temperature=temperature,
                                   top_p=top_p, compute_dtype=compute_dtype)
        rng, _ = jax.random.split(rng)
        row = np.asarray(toks)[0].tolist()
        if not first_chunk:
            row = row[1:]
        first_chunk = False
        for t in row:
            if t == eos_id:
                done = True
                break
            generated.append(int(t))
            if len(generated) >= max_new_tokens:
                break
        if not generated:
            break
        cur = jnp.asarray([generated[-1]], jnp.int32)
        text = tokenizer.decode(generated, skip_special_tokens=True)
        if matcher is not None and matcher(generated):
            text = matcher.trim(text)
            done = True
        yield text
        if done:
            break



def trim_at_eos(tokens, eos_id: int):
    """[B, T] numpy -> list of python lists cut before the first EOS."""
    import numpy as np
    out = []
    for row in np.asarray(tokens):
        ids = []
        for t in row.tolist():
            if t == eos_id:
                break
            ids.append(int(t))
        out.append(ids)
    return out


def beam_search(params, cfg: SliMEConfig, input_ids, attention_mask,
                pixel_values=None, crop_mask=None, *, num_beams: int = 3,
                max_new_tokens: int = 32, eos_id: Optional[int] = None,
                length_penalty: float = 1.0, compute_dtype=jnp.float32):
    """Deterministic beam search (HF num_beams semantics; the reference's eval
    drivers expose --num_beams on every model_vqa_* script, default 1).

    Static shapes: beams live as a batch dimension [B*K]; each step takes
    top-K of the joint log-probs and reorders the KV cache rows by beam index
    (an O(K*T) gather — fine for eval-scale K). Finished beams freeze their
    score (length-penalized) and stop accumulating. Returns token ids
    [B, max_new_tokens] of the best finished (or best running) beam per row.
    """
    if eos_id is None:
        eos_id = cfg.eos_token_id
    B, S = input_ids.shape
    K = num_beams
    NEG = -1e30

    if pixel_values is not None:
        prep = (slime.prepare_multimodal_multi if pixel_values.ndim == 6
                else slime.prepare_multimodal)
        fused = prep(params, cfg, input_ids, attention_mask, pixel_values,
                     crop_mask, training=False, compute_dtype=compute_dtype)
        embeds, positions, lengths = fused.embeds, fused.positions, fused.lengths
    else:
        embeds = llama.embed(params["llm"], jnp.where(input_ids < 0, 0, input_ids)
                             ).astype(compute_dtype)
        lengths = jnp.sum(attention_mask.astype(jnp.int32), axis=1)
        positions = None

    idx = jnp.maximum(lengths - 1, 0)
    logits, kvs = llama.forward(params["llm"], embeds, cfg.llm,
                                positions=positions,
                                return_kv=True, compute_dtype=compute_dtype,
                                logit_positions=idx)
    L = embeds.shape[1]
    cache = llama.init_kv_cache(cfg.llm, B, L + max_new_tokens,
                                dtype=compute_dtype)
    cache = llama.prefill_into_cache(cache, kvs, lengths)
    # replicate cache rows to B*K beams (beam-major per row: [b0k0, b0k1, ...])
    cache = {k: (jnp.repeat(v, K, axis=1) if v.ndim >= 2 else
                 jnp.repeat(v, K, axis=0)) for k, v in cache.items()}

    last = logits[:, 0]
    lp0 = jax.nn.log_softmax(last.astype(jnp.float32), axis=-1)     # [B, V]
    V = lp0.shape[-1]
    # seed: top-K distinct first tokens per row
    s0, t0 = jax.lax.top_k(lp0, K)                                   # [B, K]

    def step_fn(carry, _):
        cache, toks, scores, done, out, t = carry
        # toks [B*K] last tokens; scores [B, K]; done [B, K]
        logits, cache = llama.decode_step(params["llm"], cache, toks, cfg.llm,
                                          compute_dtype=compute_dtype)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1).reshape(B, K, V)
        # finished beams: only an EOS continuation at score 0 keeps them intact
        frozen = jnp.full((B, K, V), NEG).at[:, :, eos_id].set(0.0)
        lp = jnp.where(done[..., None], frozen, lp)
        joint = scores[..., None] + lp                               # [B, K, V]
        flat = joint.reshape(B, K * V)
        scores, best = jax.lax.top_k(flat, K)                        # [B, K]
        src_beam = best // V                                         # [B, K]
        tok = (best % V).astype(jnp.int32)                           # [B, K]
        # reorder beam state by source beam
        gather = (jnp.arange(B)[:, None] * K + src_beam).reshape(-1)  # [B*K]
        cache = {k: (v[:, gather] if k in ("k", "v") else v[gather])
                 for k, v in cache.items()}
        done = jnp.take_along_axis(done, src_beam, axis=1) | (tok == eos_id)
        out = out[gather]
        out = out.at[:, t].set(tok.reshape(-1))
        return (cache, tok.reshape(-1), scores, done, out, t + 1), None

    out0 = jnp.zeros((B * K, max_new_tokens), jnp.int32)
    out0 = out0.at[:, 0].set(t0.reshape(-1))
    done0 = t0 == eos_id
    carry = (cache, t0.reshape(-1).astype(jnp.int32), s0, done0, out0,
             jnp.asarray(1))
    (cache, _, scores, done, out, _), _ = jax.lax.scan(
        step_fn, carry, None, length=max_new_tokens - 1)

    # pick best beam per row with HF length penalty on finished beams
    gen_len = jnp.argmax(out.reshape(B, K, -1) == eos_id, axis=-1) + 1
    gen_len = jnp.where(done, gen_len, max_new_tokens).astype(jnp.float32)
    final = scores / (gen_len ** length_penalty)
    pick = jnp.argmax(final, axis=1)                                 # [B]
    out = out.reshape(B, K, -1)[jnp.arange(B), pick]
    return np.asarray(out)
