"""SliME-8B-shape decode on one device with int8 (or int4) weight-only weights.

The int8 load (ops/quantization.py, the bitsandbytes-equivalent) halves the
decoder's weight bytes, which bounds bs=1 decode. Measures bs=1
prefill TTFT and decode tok/s with quant-aware matmuls. Prints one JSON line.
"""
import json
import sys
import time

import numpy as np


def main():
    import os

    import jax
    import jax.numpy as jnp

    from slime_jax.utils import device_description
    from slime_jax.config import LLMConfig
    from slime_jax.models import llama

    bits = int(os.environ.get("SLIME_8B_BITS", "8"))
    # int4 only: "absmax" = per-row "q4"; "group" = group-128 "q4g" (the
    # quality-bearing int4 packing, ops/quantization.quantize_weight_q4g);
    # "nf4" = NF4 group-64 codebook (the accuracy default, XLA dequant path)
    scheme = os.environ.get("SLIME_INT4_SCHEME", "absmax")
    cfg = LLMConfig.llama3_8b()
    rng = np.random.default_rng(0)

    def q(out_d, in_d):
        # quantize on HOST (numpy) so only int8/int4 bytes are uploaded
        w = rng.standard_normal((out_d, in_d)).astype(np.float32) * 0.02
        qmax = 127.0 if bits == 8 else 7.0
        if bits == 4 and scheme == "nf4":
            from slime_jax.ops.quantization import NF4_CODEBOOK
            G = 64
            g = w.reshape(out_d, in_d // G, G)
            absmax = np.abs(g).max(axis=-1)
            scale = np.where(absmax > 0, absmax, 1.0).astype(np.float32)
            norm = (g / scale[..., None]).reshape(out_d, in_d)
            mids = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2
            idx = np.searchsorted(mids, norm).astype(np.int8)
            packed = ((idx[:, 0::2] & 0xF) | ((idx[:, 1::2] & 0xF) << 4))
            return {"nf4": jnp.asarray(packed.astype(np.int8)),
                    "scale": jnp.asarray(scale)}
        if bits == 4 and scheme == "group":
            G = 128
            g = w.reshape(out_d, in_d // G, G)
            absmax = np.abs(g).max(axis=-1)
            scale = np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)
            qq = np.clip(np.round(g / scale[..., None]), -qmax, qmax)
            pairs = qq.astype(np.int8).reshape(out_d, in_d // (2 * G), 2, G)
            packed = ((pairs[:, :, 0] & 0xF) | ((pairs[:, :, 1] & 0xF) << 4))
            packed = packed.astype(np.int8).reshape(out_d, in_d // 2)
            return {"q4g": jnp.asarray(packed), "scale": jnp.asarray(scale)}
        absmax = np.abs(w).max(axis=-1, keepdims=True)
        scale = np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)
        qq = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8)
        if bits == 4:
            packed = ((qq[:, 0::2] & 0xF) | ((qq[:, 1::2] & 0xF) << 4)).astype(np.int8)
            return {"q4": jnp.asarray(packed), "scale": jnp.asarray(scale)}
        return {"q": jnp.asarray(qq), "scale": jnp.asarray(scale)}

    H, HD, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    print("building int8 8B params...", file=sys.stderr, flush=True)
    layers = []
    for i in range(cfg.num_layers):
        layers.append({
            "input_layernorm": {"weight": jnp.ones((H,), jnp.float32)},
            "q_proj": {"weight": q(cfg.num_heads * HD, H)},
            "k_proj": {"weight": q(cfg.num_kv_heads * HD, H)},
            "v_proj": {"weight": q(cfg.num_kv_heads * HD, H)},
            "o_proj": {"weight": q(cfg.num_heads * HD, H)},
            "post_attention_layernorm": {"weight": jnp.ones((H,), jnp.float32)},
            "gate_proj": {"weight": q(I, H)},
            "up_proj": {"weight": q(I, H)},
            "down_proj": {"weight": q(H, I)},
        })
        print(f"  layer {i + 1}/{cfg.num_layers}", file=sys.stderr, flush=True)
    params = {
        "embed_tokens": jnp.asarray(
            rng.standard_normal((cfg.vocab_size, H)).astype(np.float32) * 0.02
        ).astype(jnp.bfloat16),
        "norm": {"weight": jnp.ones((H,), jnp.float32)},
        "layers": layers,
        "lm_head": {"weight": jnp.asarray(
            rng.standard_normal((cfg.vocab_size, H)).astype(np.float32) * 0.02
        ).astype(jnp.bfloat16)},
    }

    S = int(os.environ.get("SLIME_8B_PREFILL", "512"))
    B, NEW, CACHE = 1, 64, S + 128
    ids = jnp.asarray(rng.integers(5, cfg.vocab_size, (B, S), np.int32))

    def prefill(params, ids):
        embeds = llama.embed(params, ids).astype(jnp.bfloat16)
        logits, kvs = llama.forward(params, embeds, cfg, return_kv=True,
                                    compute_dtype=jnp.bfloat16, scan_layers=True)
        cache = llama.init_kv_cache(cfg, B, CACHE, dtype=jnp.bfloat16)
        cache = llama.prefill_into_cache(cache, kvs, jnp.full((B,), S))
        return jnp.argmax(logits[:, -1], -1).astype(jnp.int32), cache

    def step(params, cache, tok):
        logits, cache = llama.decode_step(params, cache, tok, cfg,
                                          compute_dtype=jnp.bfloat16)
        return jnp.argmax(logits, -1).astype(jnp.int32), cache

    jp = jax.jit(prefill)
    js = jax.jit(step, donate_argnums=(1,))

    print("compiling...", file=sys.stderr, flush=True)
    tok, cache = jp(params, ids)
    int(tok[0])
    tok, cache = js(params, cache, tok)
    int(tok[0])

    t0 = time.perf_counter()
    tok, cache = jp(params, ids)
    int(tok[0])
    ttft_ms = (time.perf_counter() - t0) * 1000

    # decode loop INSIDE jit, as generate() and the batch engine run it
    def decode_n(params, cache, tok):
        def body(i, carry):
            cache, tok = carry
            logits, cache = llama.decode_step(params, cache, tok, cfg,
                                              compute_dtype=jnp.bfloat16)
            return cache, jnp.argmax(logits, -1).astype(jnp.int32)
        return jax.lax.fori_loop(0, NEW, body, (cache, tok))

    jd = jax.jit(decode_n, donate_argnums=(1,))
    cache, tok = jd(params, cache, tok)  # compile
    int(tok[0])
    t0 = time.perf_counter()
    cache, tok = jd(params, cache, tok)
    int(tok[0])
    dt = time.perf_counter() - t0

    tag = f"int{bits}" if bits == 8 or scheme == "absmax" else f"int4_{scheme}"
    print(json.dumps({
        "metric": f"slime8b_{tag}_decode_tok_per_sec",
        "value": round(NEW / dt, 2),
        "unit": f"tok/s (Llama-3-8B arch, int{bits} weights, bs=1, "
                f"{S}-token prefill TTFT={ttft_ms:.0f}ms)",
        "device": device_description(),
    }))


if __name__ == "__main__":
    main()
