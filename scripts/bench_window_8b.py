"""Measure the decode window-bucketing win at 8B on one device.

The serving engine's slot cache is [L, slots, cache_len, KVH, hd]; before
window bucketing every decode tick streamed the whole cache_len of K/V per
slot (at 8 slots x 2048 x 8B bf16 that's ~2 GB/step on top of the ~8 GB int8
weight stream). This bench runs the SAME batched decode step at several
static windows and reports ms/step — the delta is KV-cache read traffic.

Env: SLIME_WIN_SLOTS (8), SLIME_WIN_CACHE (2048), SLIME_WIN_STEPS (32).
Prints one JSON line per window.
"""
import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from slime_jax.config import LLMConfig
    from slime_jax.models import llama

    slots = int(os.environ.get("SLIME_WIN_SLOTS", "8"))
    cache_len = int(os.environ.get("SLIME_WIN_CACHE", "2048"))
    steps = int(os.environ.get("SLIME_WIN_STEPS", "32"))
    cfg = LLMConfig.llama3_8b()
    rng = np.random.default_rng(0)
    H, HD, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size

    def q(out_d, in_d):
        qq = rng.integers(-127, 128, (out_d, in_d), dtype=np.int16).astype(np.int8)
        scale = np.full((out_d, 1), 0.02 / 127, np.float32)
        return {"q": jnp.asarray(qq), "scale": jnp.asarray(scale)}

    shapes = {"q_proj": (cfg.num_heads * HD, H),
              "k_proj": (cfg.num_kv_heads * HD, H),
              "v_proj": (cfg.num_kv_heads * HD, H),
              "o_proj": (H, cfg.num_heads * HD),
              "gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I)}
    print("building int8 8B (stacked)...", file=sys.stderr, flush=True)
    L_ = cfg.num_layers
    stacked = {"input_layernorm": {"weight": jnp.ones((L_, H), jnp.float32)},
               "post_attention_layernorm": {"weight": jnp.ones((L_, H),
                                                               jnp.float32)}}
    for name, (o, i) in shapes.items():
        parts = [q(o, i) for _ in range(L_)]
        stacked[name] = {"weight": jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *parts)}
    params = {
        "embed_tokens": jnp.asarray(rng.standard_normal(
            (cfg.vocab_size, H)).astype(np.float32) * 0.02).astype(jnp.bfloat16),
        "norm": {"weight": jnp.ones((H,), jnp.float32)},
        "layers": stacked,
        "lm_head": {"weight": jnp.asarray(rng.standard_normal(
            (cfg.vocab_size, H)).astype(np.float32) * 0.02).astype(jnp.bfloat16)},
    }

    cache = llama.init_kv_cache(cfg, slots, cache_len, dtype=jnp.bfloat16)
    # slots mid-generation at ~192 tokens: the regime where a 256 window
    # covers everyone but the full pool used to stream anyway
    cache = dict(cache)
    cache["k"] = jnp.asarray(rng.standard_normal(cache["k"].shape) * 0.1,
                             jnp.bfloat16)
    cache["v"] = jnp.asarray(rng.standard_normal(cache["v"].shape) * 0.1,
                             jnp.bfloat16)
    cache["length"] = jnp.full((slots,), 192, jnp.int32)
    tok = jnp.asarray(rng.integers(5, cfg.vocab_size, (slots,), np.int32))

    results = {}
    for window in sorted({min(w, cache_len)
                          for w in (256, 512, 1024, cache_len)}):
        def decode_n(params, cache, tok, *, window=window):
            def body(i, carry):
                cache, tok = carry
                logits, cache = llama.decode_step(
                    params, cache, tok, cfg, compute_dtype=jnp.bfloat16,
                    window=window)
                return cache, jnp.argmax(logits, -1).astype(jnp.int32)
            return jax.lax.fori_loop(0, steps, body, (cache, tok))

        jd = jax.jit(decode_n)
        print(f"compiling window={window}...", file=sys.stderr, flush=True)
        c2, t2 = jd(params, cache, tok)
        int(t2[0])
        t0 = time.perf_counter()
        c2, t2 = jd(params, cache, tok)
        int(t2[0])
        dt = (time.perf_counter() - t0) / steps
        results[window] = dt * 1000
        print(json.dumps({
            "metric": f"slime8b_int8_bs{slots}_decode_win{window}_ms",
            "value": round(dt * 1000, 2),
            "unit": f"ms/step ({slots} slots, cache {cache_len}, "
                    f"{slots / dt:.0f} tok/s aggregate)",
            "vs_baseline": None,
        }), flush=True)
    full = results[cache_len]
    small = results[min(results)]
    print(json.dumps({
        "metric": "slime8b_window_speedup",
        "value": round(full / small, 3),
        "unit": f"x (window {min(results)} vs full {cache_len}, "
                f"{slots} slots)",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    main()
