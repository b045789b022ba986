"""Speculative decoding: draft-model lookahead verified by the target model.

Beyond-reference serving acceleration (the reference serves strictly
autoregressively; llava/serve/model_worker.py). Greedy speculative decoding is
EXACT: the emitted sequence equals the target model's own greedy decode — the
draft only changes how many target forward passes it takes to produce it.

Static-shape design: the draft always proposes K tokens (lax.fori_loop of
decode_step); the target verifies all K in ONE chunked forward
(llama.prefill_chunk — K query positions against its cache). Acceptance is the
longest matching prefix; rollback is free because every cache in this codebase
masks by its ``length`` pointer — resetting length un-writes rejected positions
(they get overwritten on the next chunk).

Per emitted token, target cost drops from 1 full forward to ~1/(accepted+1)
chunked forwards; weight streaming (the bs=1 decode bottleneck) amortizes the
same way.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import SliMEConfig
from ..models import llama


@partial(jax.jit, static_argnames=("cfg_llm", "cache_len", "compute_dtype"))
def _prefill_jit(llm_params, input_ids, cfg_llm, cache_len, compute_dtype):
    """Jitted prompt prefill -> (first greedy token, primed cache). Eager
    dispatch here costs thousands of per-op dispatches at 8B scale; one
    compiled program costs one."""
    S = input_ids.shape[1]
    embeds = llama.embed(llm_params, input_ids).astype(compute_dtype)
    # logits only at the last position: full-sequence fp32 logits at 128k
    # vocab are ~0.9 GB per 1k prompt tokens of pure waste (see generate.py)
    logits, kvs = llama.forward(llm_params, embeds, cfg_llm,
                                return_kv=True, compute_dtype=compute_dtype,
                                logit_positions=jnp.full((1,), S - 1))
    cache = llama.init_kv_cache(cfg_llm, 1, cache_len, dtype=compute_dtype)
    cache = llama.prefill_into_cache(cache, kvs, jnp.full((1,), S))
    return jnp.argmax(logits[0, 0]).astype(jnp.int32), cache


def speculative_generate(params_target, cfg_target: SliMEConfig,
                         params_draft, cfg_draft: SliMEConfig,
                         input_ids, *, K: int = 4, max_new_tokens: int = 64,
                         eos_id: Optional[int] = None,
                         compute_dtype=jnp.float32):
    """Greedy speculative decode (bs=1). input_ids [1, S] (text prompt; both
    models must share the tokenizer/vocab). Returns np tokens [1, <=max_new],
    trimmed at EOS, plus the acceptance rate (draft tokens kept / proposed)."""
    if eos_id is None:
        eos_id = cfg_target.eos_token_id
    tl, dl = cfg_target.llm, cfg_draft.llm
    B, S = input_ids.shape
    assert B == 1, "speculative decode is a bs=1 latency optimization"
    cache_len = S + max_new_tokens + K + 2  # verify chunks span K+1 positions

    t_first, t_cache = _prefill_jit(params_target["llm"], input_ids, tl,
                                    cache_len, compute_dtype)
    _, d_cache = _prefill_jit(params_draft["llm"], input_ids, dl,
                              cache_len, compute_dtype)

    @jax.jit
    def draft_k(params, cache, tok):
        """Greedy-draft K tokens; cache advances K positions."""
        def body(i, carry):
            cache, tok, out = carry
            logits, cache = llama.decode_step(params["llm"], cache, tok, dl,
                                              compute_dtype=compute_dtype)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            return cache, nxt, out.at[i].set(nxt[0])
        cache, _, out = jax.lax.fori_loop(
            0, K, body, (cache, tok, jnp.zeros((K,), jnp.int32)))
        return cache, out

    @jax.jit
    def verify(params, cache, cur_tok, draft_toks):
        """One target chunk over [cur_tok, *draft_toks] (K+1 positions) -> the
        target's greedy continuation at each. Position K (after the full draft)
        is the BONUS token: a fully-accepted round emits K+1 tokens, the
        standard payoff that makes a K-token draft worth its cost."""
        toks = jnp.concatenate([cur_tok[None], draft_toks])[None]      # [1, K+1]
        embeds = llama.embed(params["llm"], toks).astype(compute_dtype)
        logits, cache = llama.prefill_chunk(params["llm"], cache, embeds, tl,
                                            compute_dtype=compute_dtype)
        return cache, jnp.argmax(logits[0], -1).astype(jnp.int32)      # [K+1]

    @jax.jit
    def draft_ingest(params, cache, tok):
        """Advance the draft cache by one token (KV only; logits discarded)."""
        _, cache = llama.decode_step(params["llm"], cache, tok, dl,
                                     compute_dtype=compute_dtype)
        return cache

    @jax.jit
    def set_len(cache, n):
        cache = dict(cache)
        cache["length"] = jnp.full((1,), n, jnp.int32)
        return cache

    out: list = []
    cur = t_first                       # target's first token is always exact
    out.append(int(cur))
    n_accept = n_prop = 0
    t_len = d_len = S
    # draft cache must also ingest cur before proposing — feed via decode_step
    while len(out) < max_new_tokens and out[-1] != eos_id:
        d_cache = set_len(d_cache, d_len)
        d_cache, proposals = draft_k(params_draft, d_cache, cur[None])
        t_cache = set_len(t_cache, t_len)
        t_cache, targets = verify(params_target, t_cache, cur, proposals)

        n_prop += K
        match = np.asarray(proposals) == np.asarray(targets)[:K]
        acc = int(np.argmin(match)) if not match.all() else K
        n_accept += acc
        # accepted draft tokens are exactly the target's greedy tokens; every
        # round emits one extra target token — the correction at the first
        # mismatch, or the bonus after a fully-accepted draft
        emitted = np.asarray(targets)[: acc + 1]
        emitted = emitted[: max_new_tokens - len(out)]          # budget cut
        if eos_id in emitted:                                    # eos cut
            emitted = emitted[: int(np.argmax(emitted == eos_id)) + 1]
        out.extend(int(t) for t in emitted)
        # caches hold KV for cur + emitted[:-1] (all verified-correct);
        # resetting length next round rolls back the rejected tail for free
        produced = len(emitted)
        if produced == K + 1:
            # full acceptance: the draft cache lacks the last draft token's KV
            # (draft_k fed only cur + K-1 drafts); ingest it so the next round
            # drafts from a complete, correctly-positioned cache
            d_cache = draft_ingest(params_draft, d_cache, proposals[K - 1][None])
        t_len += produced
        d_len += produced
        cur = jnp.asarray(out[-1], jnp.int32)
        if out[-1] == eos_id:
            break

    toks = np.asarray(out, np.int32)[None]
    rate = n_accept / max(n_prop, 1)
    return toks, rate


# ---------------------------------------------------------------------------
# Fully on-device speculative decode. The host-driven loop above pays a
# host<->device round trip per verify round; this variant runs
# draft/verify/accept/rollback inside ONE lax.while_loop, so the host syncs
# exactly once for the whole generation.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("tl", "dl", "K", "max_new", "eos_id",
                                   "compute_dtype"),
         donate_argnames=("t_cache", "d_cache"))
def _spec_loop_device(tp, dp, t_cache, d_cache, first_tok, *, tl, dl, K,
                      max_new, eos_id, compute_dtype):
    """(out_buf [max_new+K+1], n_out, n_accept, n_prop). Caches are donated —
    rollback is the usual length-pointer reset, all in-graph.

    Cache-position invariant per round (same as the host loop): entering a
    round, each cache holds KV for every emitted token except the last one
    (`cur`), whose KV the round itself writes at the current length."""
    BUF = max_new + K + 1

    def draft_k(d_cache, tok):
        def body(i, carry):
            cache, tok, out = carry
            logits, cache = llama.decode_step(dp, cache, tok, dl,
                                              compute_dtype=compute_dtype)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            return cache, nxt, out.at[i].set(nxt[0])
        return jax.lax.fori_loop(
            0, K, body, (d_cache, tok, jnp.zeros((K,), jnp.int32)))

    def cond(carry):
        _, _, _, _, n_out, _, _, done = carry
        return ~done

    def body(carry):
        t_cache, d_cache, cur, out, n_out, n_acc, n_prop, done = carry
        d_cache, _, proposals = draft_k(d_cache, cur[None])
        toks = jnp.concatenate([cur[None], proposals])[None]        # [1, K+1]
        embeds = llama.embed(tp, toks).astype(compute_dtype)
        logits, t_cache = llama.prefill_chunk(tp, t_cache, embeds, tl,
                                              compute_dtype=compute_dtype)
        targets = jnp.argmax(logits[0], -1).astype(jnp.int32)       # [K+1]

        match = proposals == targets[:K]
        acc = jnp.where(match.all(), K, jnp.argmin(match))
        e = jnp.minimum(acc + 1, max_new - n_out)                   # budget cut
        idx = jnp.arange(K + 1)
        eos_hit = (targets == eos_id) & (idx < e)
        e = jnp.where(eos_hit.any(), jnp.argmax(eos_hit) + 1, e)    # eos cut

        # write the whole K+1 window at n_out; slots >= e are garbage but the
        # next round's window starts at n_out + e and overwrites them
        out = jax.lax.dynamic_update_slice(out, targets, (n_out,))
        n_out = n_out + e
        cur = targets[jnp.maximum(e - 1, 0)]
        done = eos_hit.any() | (n_out >= max_new)

        # complete the draft cache for the full-acceptance case: draft_k wrote
        # KV for cur + proposals[:K-1]; one more step writes proposals[K-1].
        # Harmless otherwise — the slot sits beyond the rolled-back length and
        # is overwritten when that position is legitimately reached.
        _, d_cache = llama.decode_step(dp, d_cache, proposals[K - 1][None], dl,
                                       compute_dtype=compute_dtype)

        # rollback: both caches' lengths point at the verified prefix only
        base_t = dict(t_cache)
        base_t["length"] = t_cache["length"] - (K + 1) + e
        base_d = dict(d_cache)
        base_d["length"] = base_t["length"]
        # count the full acc (pre budget/eos cut), matching the host loop's
        # acceptance-rate semantics
        return (base_t, base_d, cur, out, n_out,
                n_acc + acc, n_prop + K, done)

    out0 = jnp.zeros((BUF,), jnp.int32).at[0].set(first_tok)
    carry = (t_cache, d_cache, first_tok,
             out0, jnp.asarray(1, jnp.int32),
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(first_tok == eos_id))
    _, _, _, out, n_out, n_acc, n_prop, _ = jax.lax.while_loop(cond, body, carry)
    return out, n_out, n_acc, n_prop


def speculative_generate_device(params_target, cfg_target: SliMEConfig,
                                params_draft, cfg_draft: SliMEConfig,
                                input_ids, *, K: int = 4,
                                max_new_tokens: int = 64,
                                eos_id: Optional[int] = None,
                                compute_dtype=jnp.float32):
    """speculative_generate with the whole decode loop on-device: one host
    sync per generation instead of one per verify round. Same output contract
    (np tokens [1, <=max_new], acceptance rate)."""
    if eos_id is None:
        eos_id = cfg_target.eos_token_id
    tl, dl = cfg_target.llm, cfg_draft.llm
    B, S = input_ids.shape
    assert B == 1, "speculative decode is a bs=1 latency optimization"
    cache_len = S + max_new_tokens + K + 2

    t_first, t_cache = _prefill_jit(params_target["llm"], input_ids, tl,
                                    cache_len, compute_dtype)
    _, d_cache = _prefill_jit(params_draft["llm"], input_ids, dl,
                              cache_len, compute_dtype)
    out, n_out, n_acc, n_prop = _spec_loop_device(
        params_target["llm"], params_draft["llm"], t_cache, d_cache, t_first,
        tl=tl, dl=dl, K=K, max_new=max_new_tokens, eos_id=eos_id,
        compute_dtype=compute_dtype)
    n = int(n_out)
    toks = np.asarray(out)[:n][None]
    rate = int(n_acc) / max(int(n_prop), 1)
    return toks, rate


# ----------------------------------------------------------------------------------
# Rejection-sampled speculation (Leviathan et al. / Chen & Jozefowicz scheme)
# ----------------------------------------------------------------------------------

def warp_probs(logits, temperature, top_p):
    """Per-row warped sampling distribution: logits [B, ..., V] -> probs with
    temperature scaling and nucleus truncation+renormalization, matching
    generate.sample_token_dynamic's exclusive-cum rule. temperature <= 0
    rows collapse to one-hot argmax (the greedy limit), so one formula
    serves mixed greedy/sampled batches."""
    V = logits.shape[-1]
    t = jnp.maximum(temperature, 1e-6)
    while t.ndim < logits.ndim:
        t = t[..., None]
    scaled = logits / t
    sorted_l = jnp.sort(scaled, axis=-1)[..., ::-1]
    sp = jax.nn.softmax(sorted_l, axis=-1)
    cum = jnp.cumsum(sp, axis=-1)
    tp = top_p
    while tp.ndim < logits.ndim:
        tp = tp[..., None]
    cutoff_idx = jnp.sum(cum - sp < tp, axis=-1, keepdims=True) - 1
    cutoff = jnp.take_along_axis(sorted_l, cutoff_idx, axis=-1)
    filt = jnp.where((tp < 1.0) & (scaled < cutoff), -jnp.inf, scaled)
    probs = jax.nn.softmax(filt, axis=-1)
    greedy = jax.nn.one_hot(jnp.argmax(logits, axis=-1), V,
                            dtype=probs.dtype)
    tcond = temperature
    while tcond.ndim < probs.ndim - 1:
        tcond = tcond[..., None]
    return jnp.where(tcond[..., None] > 0, probs, greedy)


def rejection_round(rng, props, q_rows, p_rows):
    """One speculative round's accept/resample, distribution-exact.

    props [B, K] draft proposals sampled from q_rows [B, K, V] (warped draft
    probs); p_rows [B, K+1, V] warped target probs at the same positions.
    Token i accepts with prob min(1, p_i(x_i)/q_i(x_i)); at the first
    rejection the token resamples from norm(max(p_i - q_i, 0)); if all K
    accept, a bonus token samples from p_K. Returns (tokens [B, K+1], acc
    [B]) in the greedy-spec packing: tokens[b, :acc[b]] are accepted
    proposals, tokens[b, acc[b]] the resampled/bonus token — the emitted
    sequence is tokens[b, :acc[b]+1].

    The composite law equals sampling each position directly from p
    (Leviathan et al. 2023, Thm 1); tests/test_spec_sampling.py checks it
    by Monte Carlo. Greedy rows (one-hot p and q) reduce EXACTLY to the
    longest-matching-prefix rule of the greedy path.
    """
    B, K, V = q_rows.shape
    r_acc, r_res = jax.random.split(rng)
    q_x = jnp.take_along_axis(
        q_rows, props[..., None], axis=-1)[..., 0]          # [B, K]
    p_x = jnp.take_along_axis(
        p_rows[:, :K], props[..., None], axis=-1)[..., 0]   # [B, K]
    u = jax.random.uniform(r_acc, (B, K))
    accept = u * q_x < p_x            # u < p/q without dividing by zero
    acc = jnp.where(accept.all(axis=1), K, jnp.argmin(accept, axis=1))

    # residual distribution at the rejection position (bonus: plain p_K)
    p_at = jnp.take_along_axis(p_rows, acc[:, None, None],
                               axis=1)[:, 0]                # [B, V]
    q_pad = jnp.concatenate([q_rows, jnp.zeros((B, 1, V), q_rows.dtype)],
                            axis=1)
    q_at = jnp.take_along_axis(q_pad, acc[:, None, None], axis=1)[:, 0]
    resid = jnp.maximum(p_at - jnp.where(acc[:, None] < K, q_at, 0.0), 0.0)
    Z = jnp.sum(resid, axis=-1, keepdims=True)
    # degenerate residual (p==q exactly, or greedy rows): fall back to p
    resid = jnp.where(Z > 0, resid / jnp.where(Z > 0, Z, 1.0), p_at)
    fix = jax.random.categorical(r_res, jnp.log(resid + 1e-30),
                                 axis=-1).astype(jnp.int32)
    pos = jnp.arange(K + 1)[None]
    tokens = jnp.concatenate([props, jnp.zeros((B, 1), props.dtype)], axis=1)
    tokens = jnp.where(pos == acc[:, None], fix[:, None], tokens)
    return tokens, acc.astype(jnp.int32)
