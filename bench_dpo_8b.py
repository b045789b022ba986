"""QLoRA-DPO at the full Llama-3-8B architecture on one device.

The training-cost profile of train/dpo.py at true scale: DPO needs TWO model
evaluations per step (policy with gradients, frozen reference without), and
in LoRA/QLoRA mode the frozen NF4 base IS the reference — so the step is
[policy fwd + dx-only backward + remat re-forward] + [ref fwd], all over a
stacked [2B, S] pair batch, with BOTH evaluations' vocab projections running
through the chunked sequence-logp scan (never [2B, S, V] logits).

Expected cost vs the QLoRA SFT step (bench_qlora_8b.py) at the same token
count: SFT pays ~6 matmul-FLOP units (fwd 2 + dx 2 + remat 2), DPO pays ~8
(those + ref fwd 2) -> ~1.33x. This bench measures the real number.

Env: SLIME_DPO_BITS (4 = NF4 default, 8 = int8), SLIME_DPO_R (64),
SLIME_DPO_PAIRS (1 = B pairs -> 2B rows), SLIME_DPO_SEQ (2048),
SLIME_DPO_STEPS (3). Prints one JSON line.
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
    from slime_jax.ops.loss import chunked_sequence_logp
    from slime_jax.train import lora as lora_lib
    from slime_jax.train.dpo import dpo_losses

    bits = int(os.environ.get("SLIME_DPO_BITS", "4"))
    r = int(os.environ.get("SLIME_DPO_R", "64"))
    B = int(os.environ.get("SLIME_DPO_PAIRS", "1"))
    S = int(os.environ.get("SLIME_DPO_SEQ", "2048"))
    steps = int(os.environ.get("SLIME_DPO_STEPS", "3"))
    beta = 0.1
    alpha = 2 * r
    cfg = LLMConfig.llama3_8b()
    rng = np.random.default_rng(0)
    H, HD, I, V = (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size,
                   cfg.vocab_size)

    def q(out_d, in_d):
        # random packed bytes + plausible scales (see bench_qlora_8b.py:
        # statistically equivalent for a throughput bench, ~100x faster to
        # build than true NF4 packing of 6.5B host floats)
        if bits == 4:
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

    print(f"building {'nf4' if bits == 4 else 'int8'} 8B base (stacked)...",
          file=sys.stderr, flush=True)
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

    adapters = {}
    for name, (o, i) in shapes.items():
        adapters[f"layers/{name}"] = {
            "A": jnp.asarray(
                rng.standard_normal((L_, r, i)).astype(np.float32) / r),
            "B": jnp.zeros((L_, o, r), jnp.float32)}

    # pair batch: shared prompt (first half), answers differ (second half)
    ids = rng.integers(5, V, (2 * B, S)).astype(np.int32)
    ids[B:, :S // 2] = ids[:B, :S // 2]
    labels = np.full_like(ids, -100)
    labels[:, S // 2:] = ids[:, S // 2:]
    ids = jnp.asarray(ids)
    labels = jnp.asarray(labels)

    def seq_logps(p, ids, labels):
        emb = llama.embed(p, ids).astype(jnp.bfloat16)
        hid = llama.forward_hidden(p, emb, cfg, compute_dtype=jnp.bfloat16,
                                   scan_layers=True, remat=True)
        return chunked_sequence_logp(hid, p["lm_head"]["weight"], labels,
                                     chunk=256)

    def loss(adp, base, ids, labels, ref_logp):
        p = lora_lib.attach(base, {"rank": r, "alpha": alpha,
                                   "adapters": adp})
        logp, _ = seq_logps(p, ids, labels)
        losses, cw, rw = dpo_losses(logp[:B], logp[B:], ref_logp[:B],
                                    ref_logp[B:], beta=beta,
                                    loss_type="sigmoid")
        return jnp.mean(losses), cw - rw

    tx = optax.adamw(1e-4)
    opt = tx.init(adapters)

    def train_step(adp, opt, base, ids, labels):
        ref_logp, _ = seq_logps(base, ids, labels)   # frozen base = reference
        (l, margin), g = jax.value_and_grad(loss, has_aux=True)(
            adp, base, ids, labels, ref_logp)
        up, opt = tx.update(g, opt, adp)
        return optax.apply_updates(adp, up), opt, l, margin

    jstep = jax.jit(train_step, donate_argnums=(0, 1))
    print("compiling DPO step...", file=sys.stderr, flush=True)
    adapters, opt, l, _ = jstep(adapters, opt, base, ids, labels)
    l0 = float(l)
    print(f"step 0 loss {l0:.4f} (log 2 = {np.log(2):.4f})",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    for _ in range(steps):
        adapters, opt, l, margin = jstep(adapters, opt, base, ids, labels)
    lN = float(l)
    dt = (time.perf_counter() - t0) / steps
    assert np.isfinite(lN), lN

    # matmul FLOPs: policy fwd 2K + dx 2K + remat 2K, ref fwd 2K over the
    # same rows; head: policy 6x (chunked-loss backward recomputes) + ref 2x;
    # attention: policy 5x (fwd 2 + bwd/remat 3) + ref 2x.
    rows = 2 * B
    k_lin = rows * S * sum(o * i for o, i in shapes.values()) * cfg.num_layers
    k_head = rows * S * V * H
    k_attn = rows * S * S * (cfg.num_heads * HD) * 2
    flops = 8 * k_lin + 8 * k_head + 7 * k_attn
    mfu = flops / dt / bf16_peak_flops(jax.devices()[0].device_kind)
    print(json.dumps({
        "metric": f"dpo8b_{'nf4' if bits == 4 else 'int8'}_step_ms",
        "value": round(dt * 1000, 1),
        "unit": (f"ms/step (Llama-3-8B arch QLoRA-DPO r={r}, {B} pair(s) x "
                 f"{S} tok; {rows * S / dt:.0f} pair-tok/s, "
                 f"~{mfu:.0%} MFU, loss {l0:.3f}->{lN:.3f}, "
                 f"margin {float(jnp.mean(margin)):+.4f})"),
        "device": device_description(),
    }))


if __name__ == "__main__":
    main()
