"""Batched 8B int8 decode throughput on one device.

bs=1 decode streams 8 GB of weights per token — the batch dimension amortizes
that stream across rows, which is exactly what the continuous-batching engine
(serve/batch_engine.py) exploits in production. This measures aggregate decode
tok/s for bs in {1, 4, 8, 16} with per-row KV caches at a 512-token context,
pre-stacked int8 layers, the decode loop inside one jit (the batch engine's
execution shape). Prints one JSON line per batch size.
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp

    from slime_jax.utils import device_description
    from slime_jax.config import LLMConfig
    from slime_jax.models import llama

    cfg = LLMConfig.llama3_8b()
    rng = np.random.default_rng(0)
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
              "post_attention_layernorm": {"weight": jnp.ones((L, H), jnp.float32)}}
    for name, (o, i) in shapes.items():
        layers[name] = q8((L, o, i))
        print(f"  {name}", file=sys.stderr, flush=True)
    emb = jnp.asarray((rng.standard_normal((cfg.vocab_size, H)) * 0.02
                       ).astype(np.float32), jnp.bfloat16)
    params = {"layers": layers, "embed_tokens": emb,
              "norm": {"weight": jnp.ones((H,), jnp.float32)},
              "lm_head": {"weight": emb}}

    dt = jnp.bfloat16
    CTX, N = 512, 32
    for B in (1, 4, 8, 16):
        cache = llama.init_kv_cache(cfg, B, CTX + N + 1, dtype=dt)
        cache = dict(cache)
        cache["length"] = jnp.full((B,), CTX, jnp.int32)
        tok = jnp.zeros((B,), jnp.int32)

        def decode_n(params, cache, tok):
            def body(i, c):
                cache, tok = c
                lg, cache = llama.decode_step(params, cache, tok, cfg,
                                              compute_dtype=dt)
                return cache, jnp.argmax(lg, -1).astype(jnp.int32)
            return jax.lax.fori_loop(0, N, body, (cache, tok))[1]

        jd = jax.jit(decode_n)
        int(jd(params, cache, tok)[0])  # compile
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = jd(params, cache, tok)
        int(out[0])
        per_tok = (time.perf_counter() - t0) / reps / N
        print(json.dumps({
            "metric": f"slime8b_int8_decode_tok_per_sec_bs{B}",
            "value": round(B / per_tok, 1),
            "unit": (f"aggregate tok/s (bs={B}, 512-token context, int8 "
                     f"weight-only; {per_tok * 1e3:.2f} ms/step)"),
            "device": device_description()}), flush=True)


if __name__ == "__main__":
    main()
