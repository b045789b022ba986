#!/usr/bin/env python
"""Speculative decoding acceptance + throughput on a distilled draft/target pair.

VERDICT r01 #9: the exactness mechanics of serve/speculative.py are tested, but
acceptance rates mean nothing between two unrelated random models. This bench
manufactures a CORRELATED pair the honest way: train a target LM and a 4x-smaller
draft LM on the same synthetic 2nd-order Markov language (a few hundred optax
steps, minutes on one device), then measure

  - acceptance rate of K-token drafts against the target's greedy decode
  - end-to-end tok/s: speculative vs plain jitted decode on the same target

Prints one JSON line per measurement. Results recorded in STATUS.md.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_language(rng, vocab, order=2):
    """Markov language tables: each context (last `order` tokens) has one
    'preferred' successor (high probability) and a handful of alternatives.

    order=1 (vocab mappings) is learnable by BOTH models -> acceptance ~1.0
    measures the mechanics. order=2 with a small vocab (vocab^2 mappings) is
    the capacity-gap regime speculative decoding actually lives in: the target
    learns the rule, the 4x-smaller draft only partially -> intermediate
    acceptance, like a distilled draft on natural text."""
    shape = (vocab,) * order
    pref = rng.integers(0, vocab, shape)
    alts = rng.integers(0, vocab, shape + (4,))
    return pref, alts


def make_corpus(rng, lang, vocab, n_seqs, seq_len, *, determinism=0.85):
    """Sample trajectories from the language. Train corpus and eval prompts
    MUST share `lang` — two models only agree where the data taught them the
    same rule; off-distribution prompts measure memorization noise instead."""
    pref, alts = lang
    order = pref.ndim
    seqs = np.empty((n_seqs, seq_len), np.int32)
    for i in range(n_seqs):
        ctx = tuple(rng.integers(0, vocab, order))
        for t in range(seq_len):
            if rng.random() < determinism:
                c = pref[ctx]
            else:
                c = alts[ctx][rng.integers(0, 4)]
            seqs[i, t] = c
            ctx = ctx[1:] + (c,)
    return seqs


def train_lm(cfg_llm, seqs, *, steps, batch, lr=3e-3, seed=0, label=""):
    import jax
    import jax.numpy as jnp
    import optax

    from slime_jax.models import llama

    params = llama.init(jax.random.PRNGKey(seed), cfg_llm)
    tx = optax.adamw(lr, weight_decay=0.01)
    opt = tx.init(params)

    def loss_fn(p, ids):
        emb = llama.embed(p, ids)
        logits, _ = llama.forward(p, emb, cfg_llm)
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        tgt = ids[:, 1:]
        nll = -jnp.take_along_axis(lp, tgt[..., None], -1)[..., 0]
        return jnp.mean(nll)

    @jax.jit
    def step(p, opt, ids):
        l, g = jax.value_and_grad(loss_fn)(p, ids)
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt, l

    rng = np.random.default_rng(seed + 1)
    ids_all = jnp.asarray(seqs)
    for i in range(steps):
        idx = rng.integers(0, seqs.shape[0], batch)
        params, opt, l = step(params, opt, ids_all[idx])
        if (i + 1) % 100 == 0:
            print(f"  [{label}] step {i + 1}/{steps} loss {float(l):.3f}",
                  file=sys.stderr, flush=True)
    return params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--order", type=int, default=2, choices=(1, 2))
    ap.add_argument("--vocab", type=int, default=64)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from slime_jax.config import LLMConfig, SliMEConfig
    from slime_jax.models import llama
    from slime_jax.serve.speculative import speculative_generate

    V, S = args.vocab, 128
    t_cfg = LLMConfig(vocab_size=V, hidden_size=512, intermediate_size=1408,
                      num_layers=6, num_heads=8, num_kv_heads=4, head_dim=64,
                      max_position_embeddings=512)
    d_cfg = LLMConfig(vocab_size=V, hidden_size=256, intermediate_size=704,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_position_embeddings=512)

    rng = np.random.default_rng(0)
    print("building corpus...", file=sys.stderr, flush=True)
    lang = make_language(rng, V, order=args.order)
    # enough sequences that neither model can memorize its way past the rule
    corpus = make_corpus(rng, lang, V, 4096, S)

    print("training target...", file=sys.stderr, flush=True)
    target = train_lm(t_cfg, corpus, steps=args.steps, batch=32, seed=0,
                      label="target")
    print("training draft...", file=sys.stderr, flush=True)
    draft = train_lm(d_cfg, corpus, steps=args.steps, batch=32, seed=7,
                     label="draft")

    # SliMEConfig wrappers (speculative_generate takes full configs; eos unused
    # here — -1 never fires, so runs always hit max_new)
    t_full = SliMEConfig(llm=t_cfg, eos_token_id=-1)
    d_full = SliMEConfig(llm=d_cfg, eos_token_id=-1)
    tp = {"llm": target}
    dp = {"llm": draft}

    # held-out prompts from the SAME language (fresh trajectories, same tables)
    prompts = make_corpus(np.random.default_rng(99), lang, V, args.prompts, 16)

    # --- plain jitted decode baseline on the target ---
    def plain_decode(params, ids, n):
        emb = llama.embed(params, ids)
        logits, kvs = llama.forward(params, emb, t_cfg, return_kv=True)
        cache = llama.init_kv_cache(t_cfg, 1, ids.shape[1] + n + 1)
        cache = llama.prefill_into_cache(cache, kvs,
                                         jnp.full((1,), ids.shape[1]))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)

        def body(i, carry):
            cache, tok, out = carry
            lg, cache = llama.decode_step(params, cache, tok, t_cfg)
            nxt = jnp.argmax(lg, -1).astype(jnp.int32)
            return cache, nxt, out.at[i].set(tok[0])

        _, _, out = jax.lax.fori_loop(0, n, body,
                                      (cache, tok, jnp.zeros((n,), jnp.int32)))
        return out

    jplain = jax.jit(plain_decode, static_argnums=(2,))

    rates, sp_times, pl_times, prefix_agree = [], [], [], []
    for i in range(args.prompts):
        ids = jnp.asarray(prompts[i:i + 1])
        if i == 0:  # compile
            speculative_generate(tp, t_full, dp, d_full, ids, K=args.k,
                                 max_new_tokens=args.max_new)
            int(jplain(target, ids, args.max_new)[0])
        t0 = time.perf_counter()
        toks, rate = speculative_generate(tp, t_full, dp, d_full, ids,
                                          K=args.k,
                                          max_new_tokens=args.max_new)
        sp_times.append(time.perf_counter() - t0)
        rates.append(rate)
        t0 = time.perf_counter()
        out = jplain(target, ids, args.max_new)
        int(out[0])
        pl_times.append(time.perf_counter() - t0)
        # greedy-agreement diagnostic: speculative is exact w.r.t. the target's
        # verify-path logits (test_speculative.py proves that on CPU fp32), but
        # on an accelerator the default matmul precision may run fp32 in bf16 or
        # TF32, so the 5-query verify chunk and the 1-query decode step can argmax
        # differently on near-ties — report the agreement prefix, don't assert
        want = np.asarray(out)
        got = np.asarray(toks)[0]
        n = min(len(got), len(want))
        agree = int(np.argmin(got[:n] == want[:n])) if not (
            got[:n] == want[:n]).all() else n
        prefix_agree.append(agree / n)

    acc = float(np.mean(rates))
    sp_tps = args.max_new / float(np.mean(sp_times))
    pl_tps = args.max_new / float(np.mean(pl_times))
    print(json.dumps({
        "metric": "speculative_acceptance_rate",
        "value": round(acc, 3),
        "unit": (f"accepted/proposed (K={args.k}, distilled 2L/256H draft vs 6L/512H "
                 f"target, order-{args.order} V={args.vocab} Markov, "
                 f"{args.steps} steps)"),
        "vs_baseline": None}))
    print(json.dumps({
        "metric": "speculative_vs_plain_tok_per_sec",
        "value": round(sp_tps, 1),
        "unit": (f"tok/s speculative (plain jitted decode: {pl_tps:.1f} tok/s; "
                 "tiny-model scale — dispatch-bound, weight-streaming gains "
                 "grow with target size)"),
        "vs_baseline": round(sp_tps / pl_tps, 3)}))
    print(json.dumps({
        "metric": "speculative_greedy_prefix_agreement",
        "value": round(float(np.mean(prefix_agree)), 3),
        "unit": ("fraction of tokens matching the decode_step greedy path "
                 "before first divergence (sub-1.0 = default-precision "
                 "argmax ties, not a correctness gap; CPU fp32 exactness is "
                 "asserted in tests/test_speculative.py)"),
        "vs_baseline": None}))


if __name__ == "__main__":
    main()
