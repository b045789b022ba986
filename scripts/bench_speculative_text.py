#!/usr/bin/env python
"""Speculative decoding on NATURAL-LANGUAGE data (VERDICT r2 #4).

The r2 acceptance numbers came from a synthetic Markov language; this bench
uses real English harvested from the machine itself (no network): license
texts, package READMEs/markdown, and the docstrings of the installed
transformers/jax/numpy packages — several MB of human-written prose. A real
BPE tokenizer (tokenizers lib, vocab 2048) is trained on it; then a target LM
and a ~20x-smaller draft LM are trained on the same corpus, and speculative
decoding is measured on held-out prompts:

  - acceptance rate (draft tokens kept / proposed) at K=4
  - end-to-end tok/s: speculative_generate_device vs the plain jitted decode
    of the same target

READ THE SPEEDUP RIGHT: on this deliberately small target (28M params — the
largest trainable in bench time) plain decode is compute-cheap (~2600 tok/s),
so the verify chunk costs more than it saves and speculative LOSES end-to-end
(~0.4x). That is the correct outcome at this scale: speculative decoding pays
where decode is WEIGHT-STREAMING-bound. The transferable number is the
ACCEPTANCE on natural text; combined with the measured 8B round time
(scripts/bench_speculative_8b.py: 21 ms = 4 draft steps + verify + ingest),
acceptance a with K=4 implies (1 + 4a) tokens / 21 ms at 8B — e.g. the
measured a=0.75 -> ~190 tok/s vs 80 plain int8, ~2.4x.

--mid (VERDICT r4 #8) scales the pair to ~310M target / ~28M draft and
decodes in bf16: at 620 MB of target weights per step, bs=1 decode IS
weight-streaming-bound, so the device-loop spec-vs-plain ratio is the
honest mid-scale speedup (and the engine A/B gives the deployable number,
host dispatch included).

Prints one JSON line per measurement; recorded in STATUS.md.
"""
import argparse
import glob
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def harvest_corpus(max_bytes: int = 8_000_000) -> str:
    """English text available offline: licenses, package markdown, and
    package docstrings (transformers alone carries megabytes of prose)."""
    import ast

    chunks = []
    total = 0

    def add(text):
        nonlocal total
        if text and len(text) > 200:
            chunks.append(text)
            total += len(text)

    for pat in ("/usr/share/common-licenses/*",
                "/opt/venv/lib/python3.12/site-packages/**/*.md",
                "/opt/skills/guides/*.md"):
        for f in sorted(glob.glob(pat, recursive=True)):
            try:
                add(open(f, errors="ignore").read())
            except OSError:
                pass
            if total > max_bytes:
                return "\n\n".join(chunks)

    for pkg in ("transformers", "jax", "numpy", "optax", "flax"):
        root = f"/opt/venv/lib/python3.12/site-packages/{pkg}"
        for f in sorted(glob.glob(root + "/**/*.py", recursive=True)):
            try:
                tree = ast.parse(open(f, errors="ignore").read())
            except (OSError, SyntaxError):
                continue
            for node in ast.walk(tree):
                if isinstance(node, (ast.Module, ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    add(ast.get_docstring(node) or "")
            if total > max_bytes:
                return "\n\n".join(chunks)
    return "\n\n".join(chunks)


def train_tokenizer(text: str, vocab: int):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    trainer = trainers.BpeTrainer(
        vocab_size=vocab, min_frequency=2,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=["<unk>"])
    lines = text.splitlines()
    tok.train_from_iterator(lines, trainer)
    return tok


def train_lm(cfg_llm, ids_flat, *, steps, batch, seq, lr, seed, label):
    import jax
    import jax.numpy as jnp
    import optax

    from slime_jax.models import llama

    params = llama.init(jax.random.PRNGKey(seed), cfg_llm)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, lr, min(100, steps // 10), steps))
    opt = tx.init(params)
    rng = np.random.default_rng(seed)
    n = ids_flat.shape[0] - seq - 1

    def loss_fn(p, ids):
        emb = llama.embed(p, ids[:, :-1])
        logits, _ = llama.forward(p, emb, cfg_llm)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(lp, ids[:, 1:, None], -1)[..., 0]
        return jnp.mean(nll)

    @jax.jit
    def step(p, opt, ids):
        l, g = jax.value_and_grad(loss_fn)(p, ids)
        up, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, up), opt, l

    t0 = time.time()
    for it in range(steps):
        starts = rng.integers(0, n, (batch,))
        ids = np.stack([ids_flat[s:s + seq + 1] for s in starts])
        params, opt, l = step(params, opt, jnp.asarray(ids))
        if it % 200 == 0 or it == steps - 1:
            print(f"  {label} step {it}: loss {float(l):.3f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return params


def main():
    import jax
    import jax.numpy as jnp

    from slime_jax.config import LLMConfig, SliMEConfig
    from slime_jax.models import llama
    from slime_jax.serve.speculative import speculative_generate_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--engine", action="store_true",
                    help="also measure the distilled pair END-TO-END through "
                         "BatchDecodeEngine (spec-on vs spec-off)")
    ap.add_argument("--mid", action="store_true",
                    help="mid-scale pair (VERDICT r4 #8): ~310M target / "
                         "~28M draft, the smallest regime where bs=1 decode "
                         "is genuinely weight-streaming-bound "
                         "(~620 MB bf16 target weights/step) rather than "
                         "dispatch/overhead-bound like the 28M toy")
    args = ap.parse_args()

    print("harvesting corpus...", file=sys.stderr, flush=True)
    text = harvest_corpus()
    print(f"  {len(text) / 1e6:.1f} MB", file=sys.stderr, flush=True)
    tok = train_tokenizer(text, args.vocab)
    ids_flat = np.asarray(tok.encode(text).ids, np.int32)
    print(f"  {ids_flat.size / 1e6:.1f}M tokens", file=sys.stderr, flush=True)
    n_test = 20_000
    train_ids, test_ids = ids_flat[:-n_test], ids_flat[-n_test:]

    if args.mid:
        # ~310M target (24L/1024H) — 620 MB bf16, so one decode step must
        # stream ~0.6 GB: weight-bound. Draft = the toy
        # run's TARGET config (28M), keeping the ~11x size ratio of a
        # production pair (8B/0.6B).
        tcfg = LLMConfig(vocab_size=args.vocab, hidden_size=1024,
                         intermediate_size=2816, num_layers=24, num_heads=16,
                         num_kv_heads=8, head_dim=64,
                         max_position_embeddings=1024)
        dcfg = LLMConfig(vocab_size=args.vocab, hidden_size=512,
                         intermediate_size=1408, num_layers=8, num_heads=8,
                         num_kv_heads=4, head_dim=64,
                         max_position_embeddings=1024)
    else:
        tcfg = LLMConfig(vocab_size=args.vocab, hidden_size=512,
                         intermediate_size=1408, num_layers=8, num_heads=8,
                         num_kv_heads=4, head_dim=64,
                         max_position_embeddings=1024)
        dcfg = LLMConfig(vocab_size=args.vocab, hidden_size=160,
                         intermediate_size=448, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=40,
                         max_position_embeddings=1024)

    def cached_train(cfg_llm, *, steps, lr, seed, label):
        cache = f"/tmp/spectext_{label}_{steps}.npy"
        if os.path.exists(cache):
            print(f"  {label}: from cache", file=sys.stderr, flush=True)
            tree = np.load(cache, allow_pickle=True).item()
            return jax.tree_util.tree_map(jnp.asarray, tree)
        p = train_lm(cfg_llm, train_ids, steps=steps, batch=32, seq=256,
                     lr=lr, seed=seed, label=label)
        np.save(cache, jax.tree_util.tree_map(np.asarray, p),
                allow_pickle=True)
        return p

    tag = "mid_" if args.mid else ""
    tparams = cached_train(tcfg, steps=args.steps,
                           lr=4e-4 if args.mid else 6e-4, seed=0,
                           label=f"{tag}target")
    dparams = cached_train(dcfg, steps=args.steps,
                           lr=6e-4 if args.mid else 1e-3, seed=1,
                           label=f"{tag}draft")
    n_t = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(tparams))
    n_d = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(dparams))
    pair_desc = (f"{tcfg.num_layers}L/{tcfg.hidden_size}H target "
                 f"({n_t / 1e6:.0f}M) vs {dcfg.num_layers}L/"
                 f"{dcfg.hidden_size}H draft ({n_d / 1e6:.0f}M)")
    print(f"  pair: {pair_desc}", file=sys.stderr, flush=True)

    # stack the layer lists: decode graphs then lax.scan over layers instead
    # of unrolling them — at 24L/1024H the unrolled speculative while-loop
    # HLO is very large to compile
    def stacked(p):
        q = dict(p)
        q["layers"] = llama.stack_layers(p["layers"])
        return q

    tparams, dparams = stacked(tparams), stacked(dparams)

    import dataclasses
    t_wrap = dataclasses.replace(SliMEConfig.tiny(), llm=tcfg)
    d_wrap = dataclasses.replace(SliMEConfig.tiny(), llm=dcfg)

    rng = np.random.default_rng(9)
    K, NEW = args.k, args.max_new

    # decode in the deployment dtype: bf16 at mid scale (the weight stream
    # IS the regime under test — fp32 would double it), fp32 for the toy
    # (training dtype; matches the r3 recorded numbers)
    cdt = jnp.bfloat16 if args.mid else jnp.float32
    if args.mid:
        cast = lambda t: jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16)
            if x.dtype == jnp.float32 else x, t)
        tparams, dparams = cast(tparams), cast(dparams)

    # plain jitted decode of the same target (the baseline speculative must
    # beat), compiled ONCE for all prompts
    from slime_jax.serve.speculative import _prefill_jit

    def _body(carry, _):
        params, cache, tok = carry
        lg, cache = llama.decode_step(params, cache, tok[None], tcfg,
                                      compute_dtype=cdt)
        nxt = jnp.argmax(lg[0], -1).astype(jnp.int32)
        return (params, cache, nxt), nxt

    # params travel as a jit ARGUMENT: closed over, they bake into the jaxpr
    # as constants — 568 MB of bf16 weights in the HLO proto at mid scale,
    # over the remote-compile request limit (HTTP 413)
    @jax.jit
    def plain_loop(params, cache, tok0):
        (_, _, _), out = jax.lax.scan(_body, (params, cache, tok0), None,
                                      length=NEW)
        return out

    def plain_decode(prompt):
        tok0, cache = _prefill_jit(tparams, prompt, tcfg,
                                   prompt.shape[1] + NEW + 2, cdt)
        return plain_loop(tparams, cache, tok0)

    # warm both paths (compiles excluded from every prompt's timing)
    warm = jnp.asarray(test_ids[:64][None], jnp.int32)
    speculative_generate_device({"llm": tparams}, t_wrap, {"llm": dparams},
                                d_wrap, warm, K=K, max_new_tokens=NEW,
                                eos_id=-1, compute_dtype=cdt)
    int(plain_decode(warm)[-1])

    rates, spec_ts, plain_ts, exact_n = [], [], [], 0
    for pi in range(args.prompts):
        s = int(rng.integers(0, n_test - 200))
        prompt = jnp.asarray(test_ids[s:s + 64][None], jnp.int32)

        t0 = time.perf_counter()
        toks, rate = speculative_generate_device(
            {"llm": tparams}, t_wrap, {"llm": dparams}, d_wrap, prompt,
            K=K, max_new_tokens=NEW, eos_id=-1, compute_dtype=cdt)
        spec_dt = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = plain_decode(prompt)
        int(out[-1])
        plain_dt = time.perf_counter() - t0

        # "exact" here compares against a DIFFERENT kernel shape's greedy
        # (single-token decode vs K+1 verify chunks): fp reassociation can
        # flip genuine near-ties on natural text, so this is a match RATE,
        # not an invariant — the kernel-level exactness invariant is pinned
        # in tests/test_speculative.py where both sides share shapes.
        exact = np.array_equal(toks[0][1:],
                               np.asarray(out)[:toks.shape[1] - 1])
        exact_n += int(exact)
        rates.append(rate)
        spec_ts.append(toks.shape[1] / spec_dt)
        plain_ts.append(NEW / plain_dt)
        print(f"  prompt {pi}: acceptance {rate:.3f} exact={exact} "
              f"spec {spec_ts[-1]:.0f} tok/s vs plain {plain_ts[-1]:.0f}",
              file=sys.stderr, flush=True)

    assert float(np.mean(rates)) > 0.3, "draft never learned the language"
    print(json.dumps({
        "metric": "speculative_acceptance_natural_text"
                  + ("_mid" if args.mid else ""),
        "value": round(float(np.mean(rates)), 4),
        "unit": (f"accepted/proposed, K={K}, English corpus "
                 f"({len(text) / 1e6:.1f} MB, vocab {args.vocab}), "
                 f"{pair_desc}, held-out prompts"),
        "spec_tok_s_median": round(float(np.median(spec_ts)), 1),
        "plain_tok_s_median": round(float(np.median(plain_ts)), 1),
        "speedup": round(float(np.median(spec_ts) / np.median(plain_ts)), 3),
        "greedy_match_rate": round(exact_n / max(args.prompts, 1), 3),
    }))

    if args.engine:
        # ONE measured end-to-end ENGINE run with a real distilled pair
        # (VERDICT r3 #6: measure, don't multiply). Note the regime change:
        # the straight decode loop beats speculation at this compute-cheap
        # toy scale (above), but the ENGINE is dispatch-bound here (one host
        # sync per tick), so folding spec_rounds draft/verify rounds into one
        # dispatch can win end-to-end — measured, not derived from round
        # times.
        from slime_jax.serve.batch_engine import BatchDecodeEngine, Request

        def run_prompts(eng, n=4):
            toks = 0
            t0 = None
            for pi in range(n):
                s = int(rng.integers(0, n_test - 200))
                req = eng.submit(Request(
                    input_ids=test_ids[s:s + 64].tolist(),
                    max_new_tokens=NEW))
                for _ in range(64):          # admission + first token
                    eng.tick()
                    if req.out_queue.qsize() > 0:
                        break
                if t0 is None:
                    t0 = time.perf_counter()
                guard = 0
                while any(sl is not None for sl in eng.slots):
                    eng.tick()
                    guard += 1
                    if guard > 40 * NEW:
                        break
                out = []
                while not req.out_queue.empty():
                    item = req.out_queue.get()
                    if item is not None:
                        out.extend(item if isinstance(item, list) else [item])
                toks += len(out)
            return toks, time.perf_counter() - t0

        eng_plain = BatchDecodeEngine({"llm": tparams}, t_wrap, max_slots=2,
                                      cache_len=512, prefix_cache_mb=0,
                                      compute_dtype=cdt)
        run_prompts(eng_plain, n=1)          # warm/compile
        n_p, dt_p = run_prompts(eng_plain)
        eng_spec = BatchDecodeEngine({"llm": tparams}, t_wrap, max_slots=2,
                                     cache_len=512, prefix_cache_mb=0,
                                     compute_dtype=cdt,
                                     draft_params={"llm": dparams},
                                     draft_cfg=d_wrap, spec_k=K)
        run_prompts(eng_spec, n=1)
        n_s, dt_s = run_prompts(eng_spec)
        print(json.dumps({
            "metric": "speculative_engine_e2e"
                      + ("_mid" if args.mid else "_toy"),
            "value": round(n_s / dt_s, 1),
            "unit": (f"tok/s through BatchDecodeEngine, distilled pair "
                     f"({pair_desc}, acceptance "
                     f"{float(np.mean(rates)):.3f}); plain engine "
                     f"{n_p / dt_p:.1f} tok/s — the engine folds spec "
                     f"rounds into one dispatch, plain pays one host "
                     f"sync per token; device-loop numbers above isolate the "
                     f"weight-streaming regime from dispatch"),
            "plain_engine_tok_s": round(n_p / dt_p, 1),
            "spec_over_plain": round((n_s / dt_s) / (n_p / dt_p), 3),
        }))


if __name__ == "__main__":
    main()
