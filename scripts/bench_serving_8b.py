"""Serving-engine load test at true 8B int8 on one device.

Drives BatchDecodeEngine (serve/batch_engine.py) the way a worker does —
host tick loop, continuous admissions — with a text-only open-loop workload,
and reports aggregate decode tok/s + TTFT percentiles from the engine's own
metrics. Two scenarios:

  throughput: N requests with distinct prompts, all queued at once
  prefix:     same, but every prompt shares a long system prefix -> the
              automatic prefix cache (serve/prefix_cache.py) should collapse
              admission prefill to the suffix after the first request
  load:       open-loop Poisson arrivals at each rate in SLIME_SRV_RATES
              (req/s), mixed prompt lengths (128/512/1024 at 25/50/25%);
              reports TTFT p50/p95, aggregate generated tok/s, mean/peak
              slot occupancy and admission-queue depth per rate

Env: SLIME_SRV_REQUESTS (16), SLIME_SRV_PROMPT (512 = suffix tokens),
SLIME_SRV_PREFIX (1024 = shared prefix tokens, prefix scenario),
SLIME_SRV_NEW (64 tokens per request), SLIME_SRV_SLOTS (8),
SLIME_SRV_RATES ("0.5,1,2,4" req/s, load scenario),
SLIME_SRV_ONLY (comma list of throughput,prefix,load). One JSON line each.
CPU smoke: SLIME_SRV_TINY=1 JAX_PLATFORMS=cpu.

Method per the repo benchmarking notes: pre-stacked int8 weights built
directly as int8 on host; timings are host wall-clock around the tick loop
(the engine's own dispatch overhead is part of what's being measured).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _params(cfg, rng):
    import jax.numpy as jnp
    H, HD, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    L = cfg.num_layers

    def q8(shape):
        return {"weight": {
            "q": jnp.asarray(rng.integers(-127, 128, shape, dtype=np.int8)),
            "scale": jnp.full(shape[:-1] + (1,), 0.02 / 127.0, np.float32)}}

    shapes = {"q_proj": (cfg.num_heads * HD, H),
              "k_proj": (cfg.num_kv_heads * HD, H),
              "v_proj": (cfg.num_kv_heads * HD, H),
              "o_proj": (H, cfg.num_heads * HD),
              "gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I)}
    layers = {"input_layernorm": {"weight": jnp.ones((L, H), jnp.float32)},
              "post_attention_layernorm":
                  {"weight": jnp.ones((L, H), jnp.float32)}}
    for name, (o, i) in shapes.items():
        layers[name] = q8((L, o, i))
        print(f"  {name}", file=sys.stderr, flush=True)
    emb = jnp.asarray((rng.standard_normal((cfg.vocab_size, H)) * 0.02
                       ).astype(np.float32), jnp.bfloat16)
    return {"layers": layers, "embed_tokens": emb,
            "norm": {"weight": jnp.ones((H,), jnp.float32)},
            "lm_head": {"weight": emb}}


def _drain_all(reqs):
    toks = 0
    for r in reqs:
        while True:
            got = r.out_queue.get(timeout=600)
            if got is None:
                break
            toks += len(got)
    return toks


def run_scenario(eng, Request, rng, *, n_req, prompt_len, new_tokens,
                 prefix_ids=None, vocab):
    reqs = []
    for _ in range(n_req):
        sfx = rng.integers(5, vocab, (prompt_len,)).astype(np.int32)
        ids = (np.concatenate([prefix_ids, sfx]) if prefix_ids is not None
               else sfx)
        reqs.append(Request(input_ids=ids, max_new_tokens=new_tokens))
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    # host tick loop, same as BatchDecodeEngine.run_forever without sleeps
    while True:
        n = eng.tick()
        if n == 0 and eng.pending.empty() and eng._admission is None:
            break
    toks = _drain_all(reqs)
    dt = time.monotonic() - t0
    return toks, dt


def run_load(eng, Request, rng, *, rate, n_req, new_tokens, vocab):
    """Open-loop arrivals at `rate` req/s; mixed prompt lengths.

    Returns (generated_tokens, wall_s, ttft_list, occupancy_samples,
    queue_depth_samples). Occupancy/queue are sampled once per tick —
    tick cadence IS the engine's scheduling quantum, so the sample
    stream is the load the scheduler actually saw.
    """
    lens = rng.choice([128, 512, 1024], size=n_req, p=[0.25, 0.5, 0.25])
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_req))
    reqs = [Request(input_ids=rng.integers(5, vocab, (int(L),)).astype(np.int32),
                    max_new_tokens=new_tokens) for L in lens]
    n_metrics0 = len(eng._metrics)
    occ, qd = [], []
    t0 = time.monotonic()
    i = 0
    while True:
        now = time.monotonic() - t0
        while i < n_req and arrivals[i] <= now:
            eng.submit(reqs[i])
            i += 1
        n = eng.tick()
        occ.append(sum(s is not None for s in eng.slots))
        qd.append(eng.pending.qsize())
        if n == 0 and eng.pending.empty() and eng._admission is None:
            if i >= n_req:
                break
            # idle until the next arrival
            time.sleep(max(0.0, arrivals[i] - (time.monotonic() - t0)))
    toks = _drain_all(reqs)
    dt = time.monotonic() - t0
    ttft = [m[0] for m in list(eng._metrics)[n_metrics0:]]
    return toks, dt, ttft, occ, qd


def main():
    import jax

    from slime_jax.config import SliMEConfig
    from slime_jax.serve.batch_engine import BatchDecodeEngine, Request
    from slime_jax.utils import enable_compilation_cache

    enable_compilation_cache()

    n_req = int(os.environ.get("SLIME_SRV_REQUESTS", "16"))
    prompt_len = int(os.environ.get("SLIME_SRV_PROMPT", "512"))
    prefix_len = int(os.environ.get("SLIME_SRV_PREFIX", "1024"))
    new_tokens = int(os.environ.get("SLIME_SRV_NEW", "64"))
    slots = int(os.environ.get("SLIME_SRV_SLOTS", "8"))
    only = [s for s in os.environ.get("SLIME_SRV_ONLY", "").split(",") if s]

    rng = np.random.default_rng(0)
    if os.environ.get("SLIME_SRV_TINY") == "1":     # CPU smoke of the harness
        from slime_jax.models import slime as slime_mod
        cfg = SliMEConfig.tiny()
        params = slime_mod.init(jax.random.PRNGKey(0), cfg)
    else:
        cfg = SliMEConfig.slime_8b()
        print("uploading int8 8B weights...", file=sys.stderr, flush=True)
        params = {"llm": _params(cfg.llm, rng), "vision": None,
                  "projector": None, "sampler": None}
    vocab = cfg.llm.vocab_size

    if not only or "throughput" in only:
        eng = BatchDecodeEngine(params, cfg, max_slots=slots,
                                cache_len=2048, compute_dtype=jax.numpy.bfloat16)
        # warm one tiny request (compiles prefill/step variants)
        wt, wd = run_scenario(eng, Request, rng, n_req=2,
                              prompt_len=prompt_len, new_tokens=8, vocab=vocab)
        print(f"warm: {wt} tok {wd:.1f}s", file=sys.stderr, flush=True)
        n0 = len(eng._metrics)          # exclude warm (compile) TTFTs
        toks, dt = run_scenario(eng, Request, rng, n_req=n_req,
                                prompt_len=prompt_len, new_tokens=new_tokens,
                                vocab=vocab)
        ttft = np.sort([m[0] for m in list(eng._metrics)[n0:]])
        pct = lambda p: float(ttft[min(len(ttft) - 1, int(p * (len(ttft) - 1)))])
        print(json.dumps({
            "metric": "serving_engine_8b_int8_tok_per_sec",
            "value": round(toks / dt, 1), "unit":
            f"aggregate generated tok/s ({n_req} reqs x {prompt_len} prompt "
            f"+ {new_tokens} new, {slots} slots)",
            "ttft_p50_s": round(pct(0.50), 3), "ttft_p95_s": round(pct(0.95), 3),
            "wall_s": round(dt, 2)}), flush=True)
        eng.stop()
        del eng

    if not only or "load" in only:
        rates = [float(r) for r in
                 os.environ.get("SLIME_SRV_RATES", "0.5,1,2,4").split(",")]
        eng = BatchDecodeEngine(params, cfg, max_slots=slots,
                                cache_len=2048, compute_dtype=jax.numpy.bfloat16)
        # warm: compile prefill chunks + decode buckets for all three lengths
        wt, wd, *_ = run_load(eng, Request, rng, rate=100.0, n_req=6,
                              new_tokens=8, vocab=vocab)
        print(f"load warm: {wt} tok {wd:.1f}s", file=sys.stderr, flush=True)
        for rate in rates:
            toks, dt, ttft, occ, qd = run_load(
                eng, Request, rng, rate=rate, n_req=n_req,
                new_tokens=new_tokens, vocab=vocab)
            ttft = np.sort(np.asarray(ttft)) if ttft else np.zeros(1)
            pct = lambda p: float(ttft[min(len(ttft) - 1,
                                           int(p * (len(ttft) - 1)))])
            print(json.dumps({
                "metric": "serving_engine_8b_load",
                "rate_req_s": rate,
                "value": round(toks / dt, 1),
                "unit": f"aggregate generated tok/s ({n_req} Poisson arrivals,"
                        f" mixed 128/512/1024 prompts + {new_tokens} new,"
                        f" {slots} slots)",
                "ttft_p50_s": round(pct(0.50), 3),
                "ttft_p95_s": round(pct(0.95), 3),
                "occupancy_mean": round(float(np.mean(occ)), 2),
                "occupancy_peak": int(np.max(occ)),
                "queue_depth_mean": round(float(np.mean(qd)), 2),
                "queue_depth_peak": int(np.max(qd)),
                "wall_s": round(dt, 2)}), flush=True)
        eng.stop()
        del eng

    if not only or "prefix" in only:
        pre = rng.integers(5, vocab, (prefix_len,)).astype(np.int32)
        sfx_len = max(prompt_len // 4, 64)

        # ONE engine for both passes (per-instance jits would reload every
        # 8B graph inside the measured wall time); the prefix cache is a
        # plain attribute the admission path checks per request.
        from slime_jax.serve.prefix_cache import PrefixCache

        eng = BatchDecodeEngine(params, cfg, max_slots=slots,
                                cache_len=2048,
                                compute_dtype=jax.numpy.bfloat16,
                                prefix_cache_mb=2048)
        pc_block = eng.prefix_cache.block

        def prefix_pass(pc_mb):
            eng.prefix_cache = (PrefixCache(block=pc_block,
                                            budget_bytes=pc_mb << 20)
                                if pc_mb else None)
            toks, dt = run_scenario(eng, Request, rng, n_req=n_req,
                                    prompt_len=sfx_len,
                                    new_tokens=new_tokens,
                                    prefix_ids=pre, vocab=vocab)
            return dt, eng.metrics_summary(), eng.prefix_cache_stats()

        # warm compiles: one full prefix-shaped pass of each configuration
        prefix_pass(2048)
        prefix_pass(0)
        cold, _, _ = prefix_pass(0)          # cache disabled: full prefills
        warm, m, st = prefix_pass(2048)      # req 1 populates, 2..N hit
        eng.stop()
        print(json.dumps({
            "metric": "serving_engine_8b_prefix_cache_speedup",
            "value": round(cold / warm, 2),
            "unit": f"no-cache/cache wall ratio ({prefix_len}-token shared "
                    f"prefix + {sfx_len} suffix x {n_req} reqs)",
            "nocache_s": round(cold, 2), "cache_s": round(warm, 2),
            "ttft_p50_s": m.get("ttft_p50_s"),
            "cache": {k: st[k] for k in
                      ("hits", "misses", "matched_tokens", "bytes")},
        }), flush=True)


if __name__ == "__main__":
    main()
