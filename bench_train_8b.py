"""Training throughput on one device — the number the reference never
publishes (its training setup is 8x A100-80G, reference README.md:199, with
zero recorded step times).

Two modes (SLIME_TRAIN_MODE):

  full (default) — full-parameter bf16 AdamW training of a Llama-architecture
    model with vocab-true widths (H=2048, L=10, I=5632, V=128256 — ~1.0 B
    params, ~12 GB of param+grad+moment state). Layer stack as one lax.scan
    block, full-layer remat (the reference's gradient_checkpointing), chunked
    CE (ops/loss.py — never materializes [B, S, V] logits). Reports ms/step,
    tokens/s, and MFU against the device's bf16 peak (utils.BF16_PEAK_FLOPS).

  pipeline — the INPUT-PIPELINE measurement (VERDICT r3 #3): A/B the same
    multimodal train step (CLIP-L vision tower + gated projector + sampler +
    H=2048 LLM, all trained bf16) over (A) pre-transferred device-resident
    batches vs (B) the background Prefetcher doing the REAL host work per
    batch (PNG decode + anyres slicing + CLIP normalization + collation +
    host->device transfer — SURVEY §3.1's CPU hot path). The headline is
    host_overhead_frac = (B - A) / B — the fraction of piped wall time the
    input pipeline fails to hide. (Consumer-blocked time is NOT the metric:
    with async dispatch the consumer can sit on an empty queue while the
    device is still busy, so queue-wait overestimates device idleness.)

Env knobs: SLIME_TRAIN_BS (full: 4, pipeline: 2), SLIME_TRAIN_SEQ (2048 /
pipeline: 512), SLIME_TRAIN_STEPS (10 / pipeline: 20), SLIME_TRAIN_LAYERS
(full: 10, pipeline: 4). Prints one JSON line.
"""
import json
import os
import sys
import time

import numpy as np



def bench_full():
    import jax
    import jax.numpy as jnp
    import optax

    from slime_jax.utils import bf16_peak_flops, device_description
    from slime_jax.config import LLMConfig
    from slime_jax.models import llama
    from slime_jax.ops.loss import chunked_ce_mean

    B = int(os.environ.get("SLIME_TRAIN_BS", "4"))
    S = int(os.environ.get("SLIME_TRAIN_SEQ", "2048"))
    steps = int(os.environ.get("SLIME_TRAIN_STEPS", "10"))
    L_ = int(os.environ.get("SLIME_TRAIN_LAYERS", "10"))
    cfg = LLMConfig(vocab_size=128256, hidden_size=2048, intermediate_size=5632,
                    num_layers=L_, num_heads=16, num_kv_heads=8, head_dim=128,
                    max_position_embeddings=max(S, 2048))
    rng = np.random.default_rng(0)
    H, HD, I, V = (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size,
                   cfg.vocab_size)
    shapes = {"q_proj": (cfg.num_heads * HD, H),
              "k_proj": (cfg.num_kv_heads * HD, H),
              "v_proj": (cfg.num_kv_heads * HD, H),
              "o_proj": (H, cfg.num_heads * HD),
              "gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I)}

    print(f"building {L_}-layer H={H} V={V} bf16 model...", file=sys.stderr,
          flush=True)

    def w(*shape, scale=0.02):
        return jnp.asarray(
            rng.standard_normal(shape).astype(np.float32) * scale
        ).astype(jnp.bfloat16)

    stacked = {"input_layernorm": {"weight": jnp.ones((L_, H), jnp.bfloat16)},
               "post_attention_layernorm": {"weight": jnp.ones((L_, H),
                                                               jnp.bfloat16)}}
    for name, (o, i) in shapes.items():
        stacked[name] = {"weight": w(L_, o, i)}
    params = {"embed_tokens": w(V, H), "norm": {"weight": jnp.ones((H,), jnp.bfloat16)},
              "layers": stacked, "lm_head": {"weight": w(V, H)}}
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    print(f"  {n_params/1e9:.2f} B params", file=sys.stderr, flush=True)

    ids = jnp.asarray(rng.integers(5, V, (B, S)).astype(np.int32))
    tx = optax.adamw(1e-4, weight_decay=0.0)
    opt = tx.init(params)

    def loss(p, ids):
        emb = llama.embed(p, ids).astype(jnp.bfloat16)
        hid = llama.forward_hidden(p, emb, cfg, compute_dtype=jnp.bfloat16,
                                   scan_layers=True, remat=True)
        return chunked_ce_mean(hid, p["lm_head"], ids, chunk=256)

    def train_step(p, opt, ids):
        l, g = jax.value_and_grad(loss)(p, ids)
        up, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, up), opt, l

    jstep = jax.jit(train_step, donate_argnums=(0, 1))
    print("compiling train step...", file=sys.stderr, flush=True)
    params, opt, l = jstep(params, opt, ids)
    l0 = float(l)
    print(f"step 0 loss {l0:.4f}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, l = jstep(params, opt, ids)
    lN = float(l)  # one sync; steps chain on device
    dt = (time.perf_counter() - t0) / steps
    assert np.isfinite(lN), lN

    # matmul FLOPs/step: layer linears fwd 2K + bwd dx 2K + bwd dW 2K +
    # remat re-fwd 2K = 8K; lm_head (trained, chunked-loss backward
    # rematerializes its fwd): 8*k_head; attention qk+av fwd 4*B*S^2*H_attn,
    # x2.5 for bwd + remat re-fwd.
    k_lin = B * S * sum(o * i for o, i in shapes.values()) * L_
    k_head = B * S * V * H
    k_attn = B * S * S * (cfg.num_heads * HD) * 2
    flops = 8 * k_lin + 8 * k_head + 5 * k_attn
    mfu = flops / dt / bf16_peak_flops(jax.devices()[0].device_kind)
    toks = B * S / dt
    print(json.dumps({
        "metric": "train_full_bf16_tokens_per_sec",
        "value": toks,
        "unit": (f"tok/s (full-param bf16 AdamW, {n_params/1e9:.2f}B "
                 f"params V=128256, bs={B}x{S}, {dt*1000:.1f} ms/step, "
                 f"{mfu:.1%} MFU; loss {l0:.3f}->{lN:.3f})"),
        "device": device_description(),
    }))


def bench_pipeline():
    import io

    from PIL import Image

    import jax
    import jax.numpy as jnp

    from slime_jax.utils import device_description
    from slime_jax.config import LLMConfig, SliMEConfig
    from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from slime_jax.data.image_ops import process_anyres_image_host
    from slime_jax.models import slime
    from slime_jax.train.optim import TrainConfig
    from slime_jax.train.trainer import RunConfig, Trainer

    B = int(os.environ.get("SLIME_TRAIN_BS", "2"))
    S = int(os.environ.get("SLIME_TRAIN_SEQ", "512"))
    steps = int(os.environ.get("SLIME_TRAIN_STEPS", "20"))
    L_ = int(os.environ.get("SLIME_TRAIN_LAYERS", "4"))
    llm = LLMConfig(vocab_size=128256, hidden_size=2048, intermediate_size=5632,
                    num_layers=L_, num_heads=16, num_kv_heads=8, head_dim=128,
                    max_position_embeddings=4096)
    base = SliMEConfig()  # real CLIP-L vision tower + gated projector
    cfg = type(base)(**{**base.__dict__, "llm": llm})
    rng = np.random.default_rng(0)
    print(f"init multimodal model (CLIP-L + {L_}-layer H=2048 LLM)...",
          file=sys.stderr, flush=True)
    params = slime.init(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, params)

    # one synthetic photo, PNG-encoded once; every batch re-decodes it — the
    # real per-sample host cost (SURVEY §3.1)
    img = Image.fromarray(
        (rng.random((768, 1024, 3)) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    png = buf.getvalue()

    MC = 1 + cfg.max_local_crops
    # SLIME_TRAIN_U8=1: uint8 pixel transport (normalize on device) — 1/4 the
    # host->device pixel bytes
    u8 = os.environ.get("SLIME_TRAIN_U8", "0") == "1"

    def make_batch():
        pix = np.zeros((B, MC, 3, cfg.vision.image_size, cfg.vision.image_size),
                       np.uint8 if u8 else np.float32)
        cmask = np.zeros((B, MC), bool)
        for b in range(B):
            im = Image.open(io.BytesIO(png)).convert("RGB")  # decode
            crops, mask, _ = process_anyres_image_host(
                im, max_crops=MC, use_native=True, normalize=not u8)
            pix[b] = crops
            cmask[b] = mask
        ids = rng.integers(5, llm.vocab_size, (B, S)).astype(np.int32)
        ids[:, 2] = IMAGE_TOKEN_INDEX
        labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
        return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
                "pixel_values": pix, "crop_mask": cmask, "labels": labels}

    th0 = time.perf_counter()
    make_batch()
    host_ms = (time.perf_counter() - th0) * 1000

    tc = TrainConfig(total_steps=2 * steps + 2, learning_rate=1e-4)
    rc = RunConfig(output_dir=os.environ.get("SLIME_TRAIN_OUT", "/tmp/slime_bench_train"),
                   save_steps=0, log_steps=10 ** 9, max_steps=2 * steps + 2,
                   prefetch_depth=2)
    tr = Trainer(params, cfg, tc, rc, remat=True)
    print("compiling + warmup step...", file=sys.stderr, flush=True)
    tr.train([make_batch()])  # compile outside the timed window

    # --- A: device-resident batches, zero host work in the loop ---
    dev_batches = [{k: jnp.asarray(v) for k, v in make_batch().items()}
                   for _ in range(min(steps, 4))]
    jax.block_until_ready(dev_batches)
    t0 = time.perf_counter()
    for i in range(steps):
        tr.rng, sub = jax.random.split(tr.rng)
        tr.state, m = tr.step_fn(tr.state, dev_batches[i % len(dev_batches)], sub)
    jax.block_until_ready(m["loss"])
    dt_dev = (time.perf_counter() - t0) / steps

    # --- B: the real input pipeline, fresh host preprocessing every batch ---
    from slime_jax.data.dataset import Prefetcher
    pf = Prefetcher((make_batch() for _ in range(steps)), depth=2,
                    map_fn=lambda b: {k: jnp.asarray(v) for k, v in b.items()})
    t0 = time.perf_counter()
    n = 0
    for batch in pf:
        tr.rng, sub = jax.random.split(tr.rng)
        tr.state, m = tr.step_fn(tr.state, batch, sub)
        n += 1
    lN = float(m["loss"])  # sync
    wall = time.perf_counter() - t0
    dt_piped = wall / n
    overhead = max(0.0, dt_piped - dt_dev) / dt_piped
    assert np.isfinite(lN), lN
    print(json.dumps({
        "metric": "train_mm_pipeline_host_overhead_frac",
        "value": round(overhead, 4),
        "unit": (f"fraction of piped wall time the input pipeline fails to "
                 f"hide (multimodal SFT step: PNG decode + anyres + CLIP-L "
                 f"encode + fusion + {L_}-layer H=2048 LLM; bs={B}: "
                 f"device-resident {dt_dev*1000:.0f} ms/step vs piped "
                 f"{dt_piped*1000:.0f} ms/step; host preprocess "
                 f"{host_ms:.0f} ms/batch 1 thread; queue-wait "
                 f"{pf.stall_s/wall:.2f} of wall; loss final {lN:.3f})"),
        "device": device_description(),
    }))


if __name__ == "__main__":
    mode = os.environ.get("SLIME_TRAIN_MODE", "full")
    if mode == "pipeline":
        bench_pipeline()
    else:
        bench_full()
