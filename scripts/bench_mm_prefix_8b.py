"""Multimodal prefix cache: follow-up-turn TTFT at true 8B int8 on one device.

The multi-turn image-chat pattern (reference gradio flow,
llava/serve/gradio_web_server.py:154-310: every turn re-sends the whole
transcript plus the same image): turn N+1's admission used to re-encode and
re-prefill the entire fused sequence. With fused identity streams
(serve/prefix_cache.py) the engine seeds the cached KV — pre-image text,
global image span, and every local span the text-guided selection kept
stable — and prefills only the new text.

Drives BatchDecodeEngine through three turns of a growing transcript with one
image, measuring per-turn TTFT (submit -> first token), prefix-cache A/B:

  turn1: <pre_text> <image> <question>                 (cold)
  turn2: turn1 + <answer + new question>               (should hit)
  turn3: turn2 + <answer + new question>               (should hit)

Env: SLIME_MMP_TEXT (64 = turn-1 text tokens), SLIME_MMP_EXTRA (48 = tokens
added per turn), SLIME_MMP_NEW (8 = generated tokens per turn),
SLIME_MMP_CACHE (4096), SLIME_MMP_TINY=1 for the CPU smoke shape
(JAX_PLATFORMS=cpu). Prints one JSON line per scenario.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    tiny = os.environ.get("SLIME_MMP_TINY") == "1"
    import jax
    import jax.numpy as jnp

    from slime_jax.config import SliMEConfig
    from slime_jax.constants import IMAGE_TOKEN_INDEX
    from slime_jax.models import llama, projector as proj_mod, sampler as samp_mod
    from slime_jax.models import slime, vit
    from slime_jax.random_weights import random_llm
    from slime_jax.serve.batch_engine import BatchDecodeEngine, Request

    rng = np.random.default_rng(0)
    jrng = jax.random.PRNGKey(0)
    if tiny:
        cfg = SliMEConfig.tiny()
        params = slime.init(jrng, cfg)
        text0, extra, new = 24, 12, 4
        cache_len = 256
    else:
        cfg = SliMEConfig.slime_8b()
        to_bf16 = lambda t: jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, t)
        print("building params (vision bf16 + llm int8)...", file=sys.stderr,
              flush=True)
        params = {
            "vision": to_bf16(vit.init(jrng, cfg.vision)),
            "projector": to_bf16(proj_mod.init(jax.random.fold_in(jrng, 1), cfg)),
            "sampler": to_bf16(samp_mod.init(jax.random.fold_in(jrng, 2), cfg)),
            "llm": random_llm(cfg.llm, jax.random.PRNGKey(0), "int8"),
        }
        text0 = int(os.environ.get("SLIME_MMP_TEXT", "64"))
        extra = int(os.environ.get("SLIME_MMP_EXTRA", "48"))
        new = int(os.environ.get("SLIME_MMP_NEW", "8"))
        cache_len = int(os.environ.get("SLIME_MMP_CACHE", "4096"))

    t = cfg.vision.image_size
    mc = 1 + cfg.max_local_crops
    px = rng.standard_normal((mc, 3, t, t)).astype(np.float32)
    cmask = np.ones((mc,), bool)
    ids1 = rng.integers(5, cfg.llm.vocab_size, (text0,)).astype(np.int32)
    ids1[2] = IMAGE_TOKEN_INDEX
    ids2 = np.concatenate([ids1, rng.integers(
        5, cfg.llm.vocab_size, (extra,)).astype(np.int32)])
    ids3 = np.concatenate([ids2, rng.integers(
        5, cfg.llm.vocab_size, (extra,)).astype(np.int32)])
    turns = [ids1, ids2, ids3]

    # ONE engine for everything: the engine's jitted graphs are per-instance,
    # so a fresh engine per configuration would re-trace (and reload from the
    # persistent compile cache — seconds per 8B graph) inside every measured
    # TTFT. The prefix cache is a plain attribute the admission path checks
    # per request; toggling it on the same engine gives a pure-admission A/B.
    from slime_jax.serve.prefix_cache import PrefixCache

    pc_mb = 64 if tiny else 1024
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=cache_len,
                            prefix_cache_mb=pc_mb)
    pc_block = eng.prefix_cache.block

    def run(with_cache):
        eng.prefix_cache = (PrefixCache(block=pc_block,
                                        budget_bytes=pc_mb << 20)
                            if with_cache else None)
        ttfts, outs = [], []
        for ids in turns:
            req = Request(input_ids=ids, pixel_values=px, crop_mask=cmask,
                          max_new_tokens=new)
            t0 = time.perf_counter()
            eng.submit(req)
            first = None
            out = []
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline:
                eng.tick()
                try:
                    while True:
                        got = req.out_queue.get_nowait()
                        if got is None:
                            raise StopIteration
                        if first is None and got:
                            first = time.perf_counter() - t0
                        out.extend(got)
                except StopIteration:
                    break
                except Exception:
                    pass
            ttfts.append(first)
            outs.append(out)
        stats = eng.prefix_cache.stats() if eng.prefix_cache else {}
        return ttfts, outs, stats

    from slime_jax.utils import enable_compilation_cache
    enable_compilation_cache()

    # warm pass on the SAME engine: compile every turn shape for both
    # configurations (cache-on covers the seed + suffix-prefill graphs,
    # cache-off the full-prefill graphs); each measured run then starts from
    # a FRESH PrefixCache so its turn-1 is a true cold turn.
    print("warm run (compiles)...", file=sys.stderr, flush=True)
    run(True)
    run(False)
    print("cached run...", file=sys.stderr, flush=True)
    ttft_c, outs_c, stats = run(True)
    print("cache-off run...", file=sys.stderr, flush=True)
    ttft_0, outs_0, _ = run(False)
    assert outs_c == outs_0, "prefix cache changed tokens — exactness violated"
    result = {
        "metric": "mm_prefix_turn2_ttft",
        "value": round(ttft_c[1] * 1e3, 1),
        "unit": "ms follow-up-turn TTFT with mm prefix cache (vs nocache list)",
        "ttft_ms_cached": [round(x * 1e3, 1) for x in ttft_c],
        "ttft_ms_nocache": [round(x * 1e3, 1) for x in ttft_0],
        "turn2_speedup": round(ttft_0[1] / ttft_c[1], 2),
        "turn3_speedup": round(ttft_0[2] / ttft_c[2], 2),
        "matched_tokens": stats.get("matched_tokens"),
        "hits": stats.get("hits"),
        "exact": True,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
