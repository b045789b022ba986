"""End-to-end SliME-8B VQA queries/min on one device.

One full multimodal query through the production code path
(`slime.prepare_multimodal` + `llama.forward` + the in-jit decode loop, the
same functions `generate()` and the batch engine call):

  672x672 image -> device anyres slice (1 global + padded local crops) ->
  CLIP-L/336 encode -> gated projector + 576->144 compression + text-guided
  selection -> splice into a 64-token prompt -> Llama-3-8B prefill (int8
  weight-only) -> 64 greedy tokens.

Weights are random (slime_jax.random_weights); timing does not depend on them.
Every timing ends in block_until_ready; compilation happens before the timed
window. SLIME_BENCH_BS>1 runs the batched operating point.

Prints ONE JSON line: {"metric", "value", "unit", "device", "card"}.
"""
import json
import os
import sys
import time

import numpy as np


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import nvidia_smi
    from slime_jax.config import SliMEConfig
    from slime_jax.constants import IMAGE_TOKEN_INDEX
    from slime_jax.data.image_ops import make_device_anyres_fn
    from slime_jax.models import llama, slime
    from slime_jax.random_weights import random_slime
    from slime_jax.utils import device_description, enable_compilation_cache

    enable_compilation_cache()
    dev = device_description()
    if dev["platform"] != "gpu":
        _log(f"bench.py measures a GPU; JAX found {dev['platform']!r}")
        return 1
    cfg = SliMEConfig.slime_8b()
    rng = np.random.default_rng(0)

    _log("building params (vision bf16 + llm int8)...")
    params = random_slime(cfg, 0, llm_fmt="int8")

    B = int(os.environ.get("SLIME_BENCH_BS", "1"))
    S_TEXT, NEW = 64, 64
    H = W = 672
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S_TEXT)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids = jnp.asarray(ids)
    attn = jnp.ones((B, S_TEXT), bool)
    img = jnp.asarray(rng.integers(0, 255, (H, W, 3), np.uint8))

    pre = make_device_anyres_fn((H, W))
    preproc = jax.jit(lambda im: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), pre(im)))

    def prefill(params, ids, attn, px, cmask):
        fused = slime.prepare_multimodal(params, cfg, ids, attn, px, cmask,
                                         training=False,
                                         compute_dtype=jnp.bfloat16)
        idx = jnp.maximum(fused.lengths - 1, 0)
        logits, kvs = llama.forward(params["llm"], fused.embeds, cfg.llm,
                                    positions=fused.positions, return_kv=True,
                                    compute_dtype=jnp.bfloat16, scan_layers=True,
                                    logit_positions=idx)
        L = fused.embeds.shape[1]
        cache = llama.init_kv_cache(cfg.llm, B, L + NEW, dtype=jnp.bfloat16)
        cache = llama.prefill_into_cache(cache, kvs, fused.lengths)
        return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), cache

    def decode_n(params, cache, tok):
        def body(i, carry):
            cache, tok = carry
            logits, cache = llama.decode_step(params["llm"], cache, tok, cfg.llm,
                                              compute_dtype=jnp.bfloat16)
            return cache, jnp.argmax(logits, -1).astype(jnp.int32)
        return jax.lax.fori_loop(0, NEW, body, (cache, tok))

    jp = jax.jit(prefill)
    jd = jax.jit(decode_n, donate_argnums=(1,))

    _log("compiling (vision+fusion+prefill, then decode loop)...")
    px, cmask = preproc(img)
    tok, cache = jp(params, ids, attn, px, cmask)
    cache, tok = jax.block_until_ready(jd(params, cache, tok))

    queries = int(os.environ.get("SLIME_BENCH_QUERIES", "5"))
    ttft_ms = dec_ms = 0.0
    t_all = time.perf_counter()
    for _ in range(queries):
        t0 = time.perf_counter()
        px, cmask = preproc(img)
        tok, cache = jax.block_until_ready(jp(params, ids, attn, px, cmask))
        t1 = time.perf_counter()
        cache, tok = jax.block_until_ready(jd(params, cache, tok))
        t2 = time.perf_counter()
        ttft_ms += (t1 - t0) * 1e3
        dec_ms += (t2 - t1) * 1e3
    total_s = time.perf_counter() - t_all
    ttft_ms /= queries
    dec_ms /= queries
    qpm = queries * B / total_s * 60.0

    _log(f"per query: TTFT {ttft_ms:.1f} ms (anyres+encode+fusion+prefill), "
         f"decode {dec_ms:.1f} ms ({NEW / (dec_ms / 1e3):.1f} tok/s)")
    print(json.dumps({
        "metric": "slime8b_e2e_vqa_queries_per_min",
        "value": qpm,
        "unit": (f"queries/min (bs={B}; 672x672 anyres + CLIP-L encode + "
                 f"compress/select + 8B int8 prefill [TTFT {ttft_ms:.1f} ms] "
                 f"+ {NEW} greedy tokens [{NEW / (dec_ms / 1e3):.1f} "
                 f"tok/s/row])"),
        "device": dev,
        "card": nvidia_smi(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
