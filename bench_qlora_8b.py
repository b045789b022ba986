"""QLoRA fine-tuning of the full Llama-3-8B architecture on one device.

The reference's kbit-base + PEFT path (llava/train/train.py:956-972 +
1036-1052) needs an A100-80G for 8B LoRA SFT (reference README.md:199). Here
the frozen base is NF4 (the same data type bitsandbytes loads) or int8, the
adapters are fp32 rank-r factors applied in factored form (train/lora.attach ->
models/layers.linear), the layer stack runs as ONE lax.scan block
(compile-time + scheduler-friendly), each block is rematerialized on backward
(jax.checkpoint = the reference's gradient_checkpointing), and the loss is
chunked CE (ops/loss.py — never materializes [B, S, V] logits). Optimizer
state exists only for the adapters.

Measures wall-clock per train step at bs x 2048 tokens and derives MFU from
the matmul FLOP count (frozen base => backward computes dx but no dW for base
weights; remat adds one forward recompute).

Env: SLIME_QLORA_BITS (4 = NF4 default, 8 = int8), SLIME_QLORA_R (64),
SLIME_QLORA_BS (1), SLIME_QLORA_SEQ (2048), SLIME_QLORA_STEPS (3).
Prints one JSON line.
"""
import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    import optax

    from slime_jax.utils import bf16_peak_flops, device_description
    from slime_jax.config import LLMConfig
    from slime_jax.models import llama
    from slime_jax.ops.loss import chunked_ce_mean
    from slime_jax.train import lora as lora_lib

    bits = int(os.environ.get("SLIME_QLORA_BITS", "4"))
    r = int(os.environ.get("SLIME_QLORA_R", "64"))
    B = int(os.environ.get("SLIME_QLORA_BS", "1"))
    S = int(os.environ.get("SLIME_QLORA_SEQ", "2048"))
    steps = int(os.environ.get("SLIME_QLORA_STEPS", "3"))
    alpha = 2 * r
    cfg = LLMConfig.llama3_8b()
    rng = np.random.default_rng(0)
    H, HD, I, V = (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size,
                   cfg.vocab_size)

    def q(out_d, in_d):
        # random PACKED bytes + plausible scales — statistically equivalent to
        # quantizing gaussian weights for a throughput/memory bench (the
        # kernels' work is data-independent), and ~100x faster to build than
        # true NF4 packing of 6.5B host floats (which took ~25 min/run)
        if bits == 4:     # NF4 group-64 layout, the bitsandbytes-parity type
            packed = rng.integers(0, 256, (out_d, in_d // 2),
                                  dtype=np.uint16).astype(np.int8)
            scale = (rng.random((out_d, in_d // 64)).astype(np.float32)
                     * 0.03 + 0.01)
            return {"nf4": packed, "scale": scale}
        qq = rng.integers(-127, 128, (out_d, in_d),
                          dtype=np.int16).astype(np.int8)
        scale = np.full((out_d, 1), 0.02 / 127, np.float32)
        return {"q": qq, "scale": scale}

    shapes = {"q_proj": (cfg.num_heads * HD, H),
              "k_proj": (cfg.num_kv_heads * HD, H),
              "v_proj": (cfg.num_kv_heads * HD, H),
              "o_proj": (H, cfg.num_heads * HD),
              "gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I)}

    print(f"building {'nf4' if bits == 4 else 'int8'} 8B base "
          f"(stacked)...", file=sys.stderr, flush=True)
    # build STACKED [L, ...] quant trees one weight-kind at a time (host RAM
    # stays ~1 fp32 matrix; device gets packed bytes once per kind)
    L_ = cfg.num_layers
    stacked = {"input_layernorm": {"weight": jnp.ones((L_, H), jnp.float32)},
               "post_attention_layernorm": {"weight": jnp.ones((L_, H),
                                                               jnp.float32)}}
    for name, (o, i) in shapes.items():
        parts = [q(o, i) for _ in range(L_)]
        stacked[name] = {"weight": {
            k: jnp.asarray(np.stack([p[k] for p in parts]))
            for k in parts[0]}}
        print(f"  {name} stacked", file=sys.stderr, flush=True)
    base = {
        "embed_tokens": jnp.asarray(
            rng.standard_normal((V, H)).astype(np.float32) * 0.02
        ).astype(jnp.bfloat16),
        "norm": {"weight": jnp.ones((H,), jnp.float32)},
        "layers": stacked,
        "lm_head": {"weight": jnp.asarray(
            rng.standard_normal((V, H)).astype(np.float32) * 0.02
        ).astype(jnp.bfloat16)},
    }

    # stacked adapters: leading [L] axis rides the same lax.scan as the base
    adapters = {}
    for name, (o, i) in shapes.items():
        adapters[f"layers/{name}"] = {
            "A": jnp.asarray(
                rng.standard_normal((L_, r, i)).astype(np.float32) / r),
            "B": jnp.zeros((L_, o, r), jnp.float32)}

    ids = jnp.asarray(rng.integers(5, V, (B, S)).astype(np.int32))

    def loss(adp, base, ids):
        p = lora_lib.attach(base, {"rank": r, "alpha": alpha,
                                   "adapters": adp})
        emb = llama.embed(p, ids).astype(jnp.bfloat16)
        hid = llama.forward_hidden(p, emb, cfg, compute_dtype=jnp.bfloat16,
                                   scan_layers=True, remat=True)
        return chunked_ce_mean(hid, p["lm_head"]["weight"], ids, chunk=256)

    tx = optax.adamw(1e-4)
    opt = tx.init(adapters)

    def train_step(adp, opt, base, ids):
        l, g = jax.value_and_grad(loss)(adp, base, ids)
        up, opt = tx.update(g, opt, adp)
        return optax.apply_updates(adp, up), opt, l

    jstep = jax.jit(train_step, donate_argnums=(0, 1))
    print("compiling train step...", file=sys.stderr, flush=True)
    adapters, opt, l = jstep(adapters, opt, base, ids)
    l0 = float(l)   # sync
    print(f"step 0 loss {l0:.4f}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    for _ in range(steps):
        adapters, opt, l = jstep(adapters, opt, base, ids)
    lN = float(l)   # sync once at the end; steps chain on device
    dt = (time.perf_counter() - t0) / steps
    assert np.isfinite(lN), lN

    # matmul FLOPs per step: fwd 2*K + bwd dx 2*K + remat re-fwd 2*K, where
    # K = B*S*sum(in*out) over base linears; lm_head (frozen, chunked loss
    # backward recomputes its fwd: ~3x) and attention (4*B*S^2*H_attn fwd,
    # x2.5 with bwd+remat) added separately; adapter terms are negligible.
    k_lin = B * S * sum(o * i for o, i in shapes.values()) * cfg.num_layers
    k_head = B * S * V * H
    k_attn = B * S * S * (cfg.num_heads * HD) * 2  # qk + av
    flops = 6 * k_lin + 6 * k_head + 5 * k_attn
    mfu = flops / dt / bf16_peak_flops(jax.devices()[0].device_kind)
    print(json.dumps({
        "metric": f"qlora8b_{'nf4' if bits == 4 else 'int8'}_step_ms",
        "value": round(dt * 1000, 1),
        "unit": (f"ms/step (Llama-3-8B arch QLoRA r={r}, bs={B}x{S} tok, "
                 f"{B * S / dt:.0f} tok/s, "
                 f"~{mfu:.0%} MFU, loss {l0:.3f}->{lN:.3f})"),
        "device": device_description(),
    }))


if __name__ == "__main__":
    main()
