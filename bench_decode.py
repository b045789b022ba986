"""Secondary benchmark (not the driver metric): prefill TTFT and decode tok/s.

A down-scaled Llama-architecture model (the per-layer math is identical to 8B;
scale the weight-streaming cost by the parameter ratio to project 8B numbers).
Prints one JSON line.
"""
import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from slime_jax.utils import device_description
    from slime_jax.config import LLMConfig, SliMEConfig, VisionConfig
    from slime_jax.models import llama

    llm = LLMConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                    num_layers=16, num_heads=16, num_kv_heads=8, head_dim=128,
                    max_position_embeddings=4096)
    params = llama.init(jax.random.PRNGKey(0), llm)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)

    B, S, NEW, CACHE = 1, 1024, 128, 1280
    ids = jnp.asarray(np.random.default_rng(0).integers(5, 32000, (B, S), np.int32))

    def prefill(params, ids):
        embeds = llama.embed(params, ids).astype(jnp.bfloat16)
        logits, kvs = llama.forward(params, embeds, llm, return_kv=True,
                                    compute_dtype=jnp.bfloat16, scan_layers=True)
        cache = llama.init_kv_cache(llm, B, CACHE, dtype=jnp.bfloat16)
        cache = llama.prefill_into_cache(cache, kvs, jnp.full((B,), S))
        return jnp.argmax(logits[:, -1], -1).astype(jnp.int32), cache

    def step(params, cache, tok):
        logits, cache = llama.decode_step(params, cache, tok, llm,
                                          compute_dtype=jnp.bfloat16)
        return jnp.argmax(logits, -1).astype(jnp.int32), cache

    jp = jax.jit(prefill)
    js = jax.jit(step, donate_argnums=(1,))

    print("compiling...", file=sys.stderr, flush=True)
    tok, cache = jp(params, ids)
    int(tok[0])          # host transfer = fence
    tok, cache = js(params, cache, tok)
    int(tok[0])

    # TTFT (prefill + first token)
    t0 = time.perf_counter()
    tok, cache = jp(params, ids)
    int(tok[0])
    ttft_ms = (time.perf_counter() - t0) * 1000

    # decode loop inside jit, as generate() and the batch engine run it
    def decode_n(params, cache, tok):
        def body(i, carry):
            cache, tok = carry
            logits, cache = llama.decode_step(params, cache, tok, llm,
                                              compute_dtype=jnp.bfloat16)
            return cache, jnp.argmax(logits, -1).astype(jnp.int32)
        return jax.lax.fori_loop(0, NEW, body, (cache, tok))

    jd = jax.jit(decode_n, donate_argnums=(1,))
    cache, tok = jd(params, cache, tok)
    int(tok[0])
    t0 = time.perf_counter()
    cache, tok = jd(params, cache, tok)
    int(tok[0])
    dt = time.perf_counter() - t0

    print(json.dumps({
        "metric": "decode_tok_per_sec_1b6_proxy",
        "value": round(NEW / dt, 2),
        "unit": f"tok/s (bs=1, 1024-token prefill TTFT={ttft_ms:.0f}ms, 16L/2048H bf16 proxy)",
        "device": device_description(),
    }))


if __name__ == "__main__":
    main()
