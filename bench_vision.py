"""Anyres crops/sec through the full SliME vision path on one device.

Measures the vision hot path of one multimodal query: device-side anyres preprocessing
(resize + pad + tile + normalize of 672x672 images) fused with CLIP-L/336 encoding
of [global + crops], the gated projector, and the 576->144 local compression —
everything between raw image bytes and LLM-ready tokens, in bf16.
Images are processed in batches of 8 (the eval-server working regime), 64 crop
encodes per device call.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.
"""
import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from slime_jax.utils import device_description
    from slime_jax.config import SliMEConfig
    from slime_jax.data.image_ops import make_device_anyres_fn
    from slime_jax.models import projector as proj_mod
    from slime_jax.models import sampler as samp_mod
    from slime_jax.models import vit

    cfg = SliMEConfig.slime_8b()
    rng = jax.random.PRNGKey(0)
    vparams = vit.init(rng, cfg.vision)
    pparams = proj_mod.init(jax.random.fold_in(rng, 1), cfg)
    sparams = samp_mod.init(jax.random.fold_in(rng, 2), cfg)
    to_bf16 = lambda t: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, t)
    vparams, pparams, sparams = map(to_bf16, (vparams, pparams, sparams))

    H = W = 672                     # BASELINE config #1 geometry (1 global + 4 local)
    import os
    IMGS_PER_CALL = int(os.environ.get("SLIME_BENCH_IMGS", "8"))
    pre = make_device_anyres_fn((H, W))
    MC = 1 + cfg.max_local_crops

    def encode(vp, pp, sp, imgs_u8):
        # imgs_u8 [N, H, W, 3] -> anyres stacks -> [N*MC, 3, 336, 336]
        crops, masks = jax.vmap(lambda im: pre(im))(imgs_u8)
        flat = crops.reshape(-1, 3, cfg.vision.image_size, cfg.vision.image_size)
        feats = vit.apply(vp, flat.astype(jnp.bfloat16), cfg.vision)
        feats = feats.reshape(imgs_u8.shape[0], MC, *feats.shape[1:])
        g = proj_mod.apply(pp, feats[:, 0], cfg=cfg)      # gated MoE, global views
        lc = samp_mod.compress(
            sp, feats[:, 1:].reshape(-1, *feats.shape[2:]), cfg=cfg)
        lp = proj_mod.apply(pp, lc, cfg=cfg)
        return g.sum() + lp.sum(), masks.sum()

    # params as jit ARGUMENTS (closure constants would stall compilation)
    enc = jax.jit(encode)
    imgs = jnp.asarray(np.random.default_rng(0).integers(
        0, 255, (IMGS_PER_CALL, H, W, 3), np.uint8))

    print("compiling...", file=sys.stderr, flush=True)
    jax.block_until_ready(enc(vparams, pparams, sparams, imgs))

    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        out = enc(vparams, pparams, sparams, imgs)
    jax.block_until_ready(enc(vparams, pparams, sparams, imgs))
    dt = time.perf_counter() - t0

    crops_per_sec = iters * IMGS_PER_CALL * MC / dt
    print(json.dumps({
        "metric": "anyres_crops_per_sec",
        "value": crops_per_sec,
        "unit": ("crops/s (672x672 anyres slice + CLIP-L/336 encode + gated "
                 "projector + 576->144 compression, bf16, 8-image batches)"),
        "device": device_description(),
    }))


if __name__ == "__main__":
    main()
