#!/usr/bin/env python
"""Speculative decoding at serving scale: 8B int8 target on one device.

Acceptance RATES come from the distilled-pair bench (bench_speculative.py) —
they are a property of the draft/target pair, not of the hardware. This bench
measures the other half of VERDICT r01 #9, the serving-scale TIME components,
then reports measured end-to-end tok/s plus the implied curve:

  - t_plain:  per-token jitted decode_step on the int8 8B target
  - t_draft:  per-token decode_step on a 2-layer/2048H bf16 draft (~0.6B,
              the TinyLlama-class draft an 8B deployment would use)
  - t_verify: one K+1-position prefill_chunk on the target (the verify op)
  - end-to-end speculative_generate with the (random-init) draft — the
    measured WORST case (acceptance ~0), isolating real per-round overhead
  - implied tok/s at e emitted tokens/round: e / (K*t_draft + t_verify + ovh)

Prints one JSON line per measurement.
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def _time(f, n=16):
    f()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        out = f()
    return (time.perf_counter() - t0) / n, out


def main():
    import jax
    import jax.numpy as jnp

    from slime_jax.config import LLMConfig, SliMEConfig
    from slime_jax.models import llama
    
    K = 4
    t_cfg = LLMConfig.llama3_8b()
    d_cfg = LLMConfig(vocab_size=t_cfg.vocab_size, hidden_size=2048,
                      intermediate_size=5504, num_layers=2, num_heads=16,
                      num_kv_heads=8, head_dim=128, rope_theta=500000.0,
                      max_position_embeddings=4096)

    rng = np.random.default_rng(0)
    print("building int8 8B target...", file=sys.stderr, flush=True)

    def _q8(shape):
        # timing-only weights: synthesize the int8 payload directly (identical
        # bytes/FLOPs to a real quantized load, no 8B fp32 tree, no randn cost)
        qq = rng.integers(-127, 128, shape, dtype=np.int8)
        scale = np.full(shape[:-1] + (1,), 0.02 / 127.0, np.float32)
        return {"weight": {"q": jnp.asarray(qq), "scale": jnp.asarray(scale)}}

    def _bf16(shape):
        return {"weight": jnp.asarray(
            rng.integers(-127, 128, shape, dtype=np.int8), jnp.bfloat16)
            * (0.02 / 127.0)}

    def _model(cfg, w, label=""):
        # PRE-STACKED layer storage ([L, ...] dict, llama.stack_layers layout):
        # the scan-based forward/decode consume it directly — a 32-deep list
        # would unroll into a giant graph and an in-graph 8 GB restack
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

    S, N = 128, 32
    ids = jnp.asarray(rng.integers(5, 32000, (1, S)).astype(np.int32))
    dt = jnp.bfloat16

    from slime_jax.serve.speculative import _prefill_jit

    def _prefill(params, cfg):
        return _prefill_jit(params, ids, cfg, S + 256, dt)

    # per-token plain decode (N steps in one jit, cost/N)
    @jax.jit
    def decode_n_target(params, cache, tok):
        def body(i, c):
            cache, tok = c
            lg, cache = llama.decode_step(params, cache, tok, t_cfg,
                                          compute_dtype=dt)
            return cache, jnp.argmax(lg, -1).astype(jnp.int32)
        return jax.lax.fori_loop(0, N, body, (cache, tok[None]))[1]

    @jax.jit
    def decode_n_draft(params, cache, tok):
        def body(i, c):
            cache, tok = c
            lg, cache = llama.decode_step(params, cache, tok, d_cfg,
                                          compute_dtype=dt)
            return cache, jnp.argmax(lg, -1).astype(jnp.int32)
        return jax.lax.fori_loop(0, N, body, (cache, tok[None]))[1]

    @jax.jit
    def verify_chunk(params, cache, toks):
        emb = llama.embed(params, toks).astype(dt)
        logits, cache = llama.prefill_chunk(params, cache, emb, t_cfg,
                                            compute_dtype=dt)
        return jnp.argmax(logits[0], -1).astype(jnp.int32)

    print("timing...", file=sys.stderr, flush=True)
    tok_t, cache_t = _prefill(target, t_cfg)
    tok_d, cache_d = _prefill(draft, d_cfg)
    # sync by pulling a scalar
    t_plain, _ = _time(lambda: int(decode_n_target(target, cache_t, tok_t)[0]),
                       n=4)
    t_plain /= N
    t_draft, _ = _time(lambda: int(decode_n_draft(draft, cache_d, tok_d)[0]),
                       n=4)
    t_draft /= N
    chunk = jnp.zeros((1, K + 1), jnp.int32)
    t_verify, _ = _time(lambda: int(verify_chunk(target, cache_t, chunk)[0]),
                        n=8)

    # measured end-to-end worst case (random draft, acceptance ~0), with the
    # ON-DEVICE loop (speculative_generate_device: one host sync per call)
    from slime_jax.serve.speculative import speculative_generate_device
    tf = SliMEConfig(llm=t_cfg, eos_token_id=-1)
    df = SliMEConfig(llm=d_cfg, eos_token_id=-1)
    max_new = 32
    speculative_generate_device({"llm": target}, tf, {"llm": draft}, df,
                                ids, K=K, max_new_tokens=max_new,
                                compute_dtype=dt)  # compile
    t0 = time.perf_counter()
    toks, rate = speculative_generate_device(
        {"llm": target}, tf, {"llm": draft}, df, ids, K=K,
        max_new_tokens=max_new, compute_dtype=dt)
    t_e2e = time.perf_counter() - t0
    worst_tps = toks.shape[1] / t_e2e
    # acc~0 -> one emitted token per round after the prefill token, so the
    # measured run directly gives the per-round time of the on-device loop
    # (draft K + verify + ingest; round time doesn't depend on acceptance).
    # The STANDALONE t_verify above runs outside the loop without buffer
    # donation and over-reads by the cache copy — trust the in-loop number.
    n_rounds = max(toks.shape[1] - 1, 1)
    round_ms = t_e2e / n_rounds * 1e3

    plain_tps = 1.0 / t_plain
    curve = {f"e={e}": round(e / (round_ms / 1e3), 1)
             for e in range(1, K + 2)}
    print(json.dumps({
        "metric": "speculative_8b_components_ms",
        "value": round(round_ms, 2),
        "unit": (f"in-loop round time (draft K={K} + verify + ingest); "
                 f"t_plain={t_plain * 1e3:.2f} t_draft={t_draft * 1e3:.2f} "
                 f"standalone t_verify={t_verify * 1e3:.2f} (copy-inflated) "
                 f"(int8 8B target, bf16 0.6B draft, "
                 f"{jax.devices()[0].device_kind})"),
        "vs_baseline": None}))
    print(json.dumps({
        "metric": "speculative_8b_tok_per_sec",
        "value": round(worst_tps, 1),
        "unit": (f"measured WORST case (random draft, acc={rate:.2f}); plain "
                 f"{plain_tps:.1f} tok/s; implied at e emitted/round "
                 f"(= e/round_time): {curve} — with the 0.99-acceptance "
                 f"distilled-pair regime (bench_speculative.py) e~=K+1"),
        "vs_baseline": round(worst_tps / plain_tps, 3)}))


if __name__ == "__main__":
    main()
