#!/usr/bin/env python
"""Speculative decoding THROUGH THE SERVING ENGINE at 8B scale, one device.

The r2 verdict ("speculative is not reachable from the continuous-batching
engine") was closed by the draft hook; this bench quantifies the remaining
lever — the multi-round fold (`spec_rounds`): with one draft/verify round per
dispatch, every round pays a host sync; folding R rounds into one
`lax.while_loop` dispatch amortizes that sync across R rounds.

What it measures (random-init draft => acceptance ~0, the WORST case, which
isolates per-round + per-dispatch cost exactly — round time does not depend
on acceptance):

  - plain engine tok/s (the multi_step=8 fast path) — the thing speculative
    must beat at real acceptance
  - spec engine tok/s with spec_rounds=1 vs spec_rounds=8
  - from those: per-round time and per-dispatch overhead, and the implied
    tok/s at the acceptance 0.747 measured on natural text
    (scripts/bench_speculative_text.py: e = 1 + K*a tokens/round)
  - BATCHED multi-slot speculation (SPEC_ENGINE_BS>1, default 4): all slots
    draft through one shared draft cache and verify as ONE [B, K+1] fused
    chunk — aggregate worst-case tok/s vs the plain engine at the same bs
    (the batched round costs ~the bs=1 round: both are weight-streaming
    bound, so the per-slot speculative win should survive batching until
    the verify chunk leaves the fused small-chunk regime)

Prints one JSON line per measurement.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

K = 4
MAX_NEW = 96
SMALL = bool(int(os.environ.get("SPEC_ENGINE_SMALL", "0")))  # CPU smoke mode
if SMALL:
    # the JAX_PLATFORMS env var is ignored on this image; force CPU in-process
    import jax
    jax.config.update("jax_platforms", "cpu")
ACC_TEXT = 0.747   # measured natural-text acceptance (bench_speculative_text)


def build_models(rng):
    import jax.numpy as jnp
    from slime_jax.config import LLMConfig

    if SMALL:
        t_cfg = LLMConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_layers=2, num_heads=2, num_kv_heads=2,
                          head_dim=32, max_position_embeddings=1024)
        d_cfg = t_cfg
    else:
        t_cfg = LLMConfig.llama3_8b()
        d_cfg = LLMConfig(vocab_size=t_cfg.vocab_size, hidden_size=2048,
                          intermediate_size=5504, num_layers=2, num_heads=16,
                          num_kv_heads=8, head_dim=128, rope_theta=500000.0,
                          max_position_embeddings=4096)

    def _q8(shape):
        qq = rng.integers(-127, 128, shape, dtype=np.int8)
        scale = np.full(shape[:-1] + (1,), 0.02 / 127.0, np.float32)
        return {"weight": {"q": jnp.asarray(qq), "scale": jnp.asarray(scale)}}

    def _bf16(shape):
        return {"weight": jnp.asarray(
            rng.integers(-127, 128, shape, dtype=np.int8), jnp.bfloat16)
            * (0.02 / 127.0)}

    def _model(cfg, w, label=""):
        # PRE-STACKED [L, ...] layer dict (llama.stack_layers layout) — the
        # scan paths consume it directly; a list would unroll the graph
        H, HD, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
        L = cfg.num_layers
        shapes = {
            "q_proj": (cfg.num_heads * HD, H),
            "k_proj": (cfg.num_kv_heads * HD, H),
            "v_proj": (cfg.num_kv_heads * HD, H),
            "o_proj": (H, cfg.num_heads * HD),
            "gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I),
        }
        layers = {
            "input_layernorm": {"weight": jnp.ones((L, H), jnp.float32)},
            "post_attention_layernorm": {"weight": jnp.ones((L, H), jnp.float32)},
        }
        for name, (o, i) in shapes.items():
            layers[name] = w((L, o, i))
            print(f"  [{label}] {name} [{L},{o},{i}]", file=sys.stderr,
                  flush=True)
        emb = jnp.asarray((rng.standard_normal(
            (cfg.vocab_size, cfg.hidden_size)) * 0.02).astype(np.float32),
            jnp.bfloat16)
        return {
            "layers": layers,
            "embed_tokens": emb,
            "norm": {"weight": jnp.ones((cfg.hidden_size,), jnp.float32)},
            "lm_head": {"weight": emb},
        }

    target = _model(t_cfg, _q8, label="target-int8")
    print("building 0.6B bf16 draft...", file=sys.stderr, flush=True)
    draft = _model(d_cfg, _bf16, label="draft")
    return target, t_cfg, draft, d_cfg


def run_engine(eng, ids, max_new):
    """Submit one request, tick until done; return (n_tokens, seconds)
    timed from first tick (prefill+admission excluded via a warm first
    request)."""
    from slime_jax.serve.batch_engine import Request

    req = eng.submit(Request(input_ids=ids, max_new_tokens=max_new))
    # admission (chunked prefill) until the request starts decoding — the
    # admission cost is identical across engine configs and excluded
    for _ in range(64):
        eng.tick()
        if req.out_queue.qsize() > 0:
            break
    first = []
    while not req.out_queue.empty():
        item = req.out_queue.get()
        if item is not None:
            first.extend(item if isinstance(item, list) else [item])
    t0 = time.perf_counter()
    ticks = 0
    while any(s is not None for s in eng.slots):
        eng.tick()
        ticks += 1
        if ticks > 4 * max_new:
            break
    dt = time.perf_counter() - t0
    out = list(first)
    while not req.out_queue.empty():
        item = req.out_queue.get()
        if item is None:
            break
        out.extend(item if isinstance(item, list) else [item])
    return len(out) - len(first), dt, max(ticks, 1)


def run_engine_multi(eng, ids_list, max_new):
    """Submit all requests, tick until the batch admits and every slot is
    decoding, then time to completion; returns (total_decode_tokens, secs,
    ticks)."""
    from slime_jax.serve.batch_engine import Request

    reqs = [eng.submit(Request(input_ids=ids, max_new_tokens=max_new))
            for ids in ids_list]
    for _ in range(64 * len(reqs)):        # admissions excluded from timing
        eng.tick()
        if all(r.out_queue.qsize() > 0 for r in reqs):
            break
    first = 0
    for r in reqs:
        while not r.out_queue.empty():
            item = r.out_queue.get()
            if item is not None:
                first += len(item) if isinstance(item, list) else 1
    t0 = time.perf_counter()
    ticks = 0
    while any(s is not None for s in eng.slots):
        eng.tick()
        ticks += 1
        if ticks > 4 * max_new * len(reqs):
            break
    dt = time.perf_counter() - t0
    total = first
    for r in reqs:
        while not r.out_queue.empty():
            item = r.out_queue.get()
            if item is None:
                break
            total += len(item) if isinstance(item, list) else 1
    return total - first, dt, max(ticks, 1)


def main():
    import jax.numpy as jnp

    from slime_jax.config import SliMEConfig
    from slime_jax.serve.batch_engine import BatchDecodeEngine

    rng = np.random.default_rng(0)
    print("building int8 8B target...", file=sys.stderr, flush=True)
    target, t_cfg, draft, d_cfg = build_models(rng)
    tf = SliMEConfig(llm=t_cfg, eos_token_id=-1)
    df = SliMEConfig(llm=d_cfg, eos_token_id=-1)
    tp, dp = {"llm": target}, {"llm": draft}

    ids = rng.integers(5, 32000, (128,)).astype(np.int32)
    results = {}

    def bench(label, **kw):
        eng = BatchDecodeEngine(tp, tf, max_slots=1, cache_len=512,
                                compute_dtype=jnp.bfloat16, **kw)
        n, dt, ticks = run_engine(eng, ids, 16)      # warm/compile
        n, dt, ticks = run_engine(eng, ids, MAX_NEW)
        tps = n / dt
        results[label] = (tps, dt / ticks)
        print(f"{label}: {n} tok in {dt:.2f}s = {tps:.1f} tok/s "
              f"({ticks} dispatches, {dt / ticks * 1e3:.1f} ms each)",
              file=sys.stderr, flush=True)
        return tps

    plain_tps = bench("plain")
    r1_tps = bench("spec_r1", draft_params=dp, draft_cfg=df,
                   spec_k=K, spec_rounds=1)
    r8_tps = bench("spec_r8", draft_params=dp, draft_cfg=df,
                   spec_k=K, spec_rounds=8)

    # Worst case (acc~0): each round emits 1 token. spec_r1 dispatch =
    # round + sync; spec_r8 dispatch = 8*round + sync. Solve for both.
    d1 = results["spec_r1"][1]
    d8 = results["spec_r8"][1]
    round_s = (d8 - d1) / 7.0
    sync_s = d1 - round_s
    e_text = 1 + K * ACC_TEXT
    implied_r1 = e_text / (round_s + sync_s)
    implied_r8 = 8 * e_text / (8 * round_s + sync_s)

    print(json.dumps({
        "metric": "spec_engine_8b_worst_tok_per_sec",
        "value": round(r8_tps, 1),
        "unit": (f"engine speculative, random draft (acc~0), spec_rounds=8; "
                 f"spec_rounds=1 {r1_tps:.1f}; plain engine {plain_tps:.1f}; "
                 f"derived round {round_s * 1e3:.1f} ms, "
                 f"per-dispatch sync {sync_s * 1e3:.1f} ms"),
        "vs_baseline": round(r8_tps / r1_tps, 2)}))
    print(json.dumps({
        "metric": "spec_engine_8b_implied_text_tok_per_sec",
        "value": round(implied_r8, 1),
        "unit": (f"implied at measured natural-text acceptance {ACC_TEXT} "
                 f"(e={e_text:.2f} tok/round): rounds=8 {implied_r8:.1f} vs "
                 f"rounds=1 {implied_r1:.1f} vs plain {plain_tps:.1f} tok/s"),
        "vs_baseline": round(implied_r8 / plain_tps, 2)}))

    # batched multi-slot speculation: all slots draft/verify in ONE dispatch
    BS = int(os.environ.get("SPEC_ENGINE_BS", "4"))
    if BS > 1:
        ids_list = [rng.integers(5, 32000, (128,)).astype(np.int32)
                    for _ in range(BS)]

        def bench_multi(label, **kw):
            eng = BatchDecodeEngine(tp, tf, max_slots=BS, cache_len=512,
                                    compute_dtype=jnp.bfloat16, **kw)
            run_engine_multi(eng, ids_list, 16)       # warm/compile
            n, dt, ticks = run_engine_multi(eng, ids_list, MAX_NEW)
            tps = n / dt
            results[label] = (tps, dt / ticks)
            print(f"{label}: {n} tok in {dt:.2f}s = {tps:.1f} tok/s agg "
                  f"({ticks} dispatches, {dt / ticks * 1e3:.1f} ms each)",
                  file=sys.stderr, flush=True)
            return tps

        plain_bs = bench_multi(f"plain_bs{BS}")
        spec_bs = bench_multi(f"spec_r8_bs{BS}", draft_params=dp,
                              draft_cfg=df, spec_k=K, spec_rounds=8)
        # batched round time from the spec dispatch cadence; each alive slot
        # emits e tokens per round at acceptance a
        db = results[f"spec_r8_bs{BS}"][1]
        round_b = (db - sync_s) / 8.0
        implied_bs = BS * 8 * e_text / (8 * round_b + sync_s)
        print(json.dumps({
            "metric": f"spec_engine_8b_bs{BS}_worst_tok_per_sec",
            "value": round(spec_bs, 1),
            "unit": (f"aggregate, batched spec (random draft, acc~0) at "
                     f"bs={BS}; plain bs={BS} {plain_bs:.1f} tok/s; batched "
                     f"round {round_b * 1e3:.1f} ms; implied at text "
                     f"acceptance {ACC_TEXT}: {implied_bs:.1f} tok/s agg"),
            "vs_baseline": round(implied_bs / plain_bs, 2)}))


if __name__ == "__main__":
    main()
