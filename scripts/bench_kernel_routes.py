#!/usr/bin/env python
"""Time the attention routes and the decode step on the card, at SliME-8B widths.

The measurements that decide which implementation each path takes
(ops/attention.choose_implementation) and the decode baseline:

- attention alone: cuDNN vs XLA for the LLM's fused prefill (B=1, S=1649),
  training (B=4, S=2048, forward+backward), packed SFT (segments) and the
  ViT (8 crops x 577, D=64);
- end to end: the time to first token of one 672x672 multimodal query (int8
  decoder, bf16 vision) and the stage-2 train step (batch 2 x 2048, per-layer
  remat), each with
  the LLM and the ViT attention routes forced in turn;
- the XLA decode step of the 8B decoder in bf16, int8 and q4g weights at
  batch 1 and 8, with the bytes it must read and their share of 3.35 TB/s.

Every line is JSON with the device description and the card's name and power
limit. Timings end in block_until_ready, compile excluded (one warm-up call),
median of REPS calls. Needs a GPU:

    python scripts/bench_kernel_routes.py [--out chiprun_out/routes.jsonl]
"""
import argparse
import functools
import gc
import json
import os
import statistics
import sys
import time
from unittest import mock


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (shared inputs: requests, train batch)

REPS = 10
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def timed(f, *args, reps=REPS):
    """(median ms, all ms) of f(*args) after one warm-up call."""
    import jax
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def forced(llm=None, vit=None):
    """Patch the route choice: head dim 128 is the LLM, 64 the ViT."""
    from slime_jax.ops import attention as A
    orig = A.choose_implementation

    def choose(q, k, *, segment_ids=None):
        want = {128: llm, 64: vit}.get(q.shape[-1])
        return want or orig(q, k, segment_ids=segment_ids)
    return mock.patch.object(A, "choose_implementation", choose)


class Out:
    def __init__(self, path, base):
        self.path, self.base = path, base
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            open(path, "w").close()

    def __call__(self, **rec):
        line = json.dumps({**rec, **self.base})
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def bench_attention(out):
    """ops.attention.attention with its route forced each way, as the model
    calls it (the ViT's odd length takes the padded cuDNN path)."""
    import jax
    import jax.numpy as jnp

    from slime_jax.ops import attention as A

    cases = [("llm fused prefill", 1, 1649, 32, 8, 128, True, False, False),
             ("llm train", 4, 2048, 32, 8, 128, True, False, True),
             ("llm packed SFT", 4, 2048, 32, 8, 128, True, True, True),
             ("vit", 8, 577, 16, 16, 64, False, False, False),
             ("vit train", 8, 577, 16, 16, 64, False, False, True)]
    for name, B, S, H, KVH, D, causal, seg, grad in cases:
        ks = jax.random.split(jax.random.PRNGKey(0), 4)
        q = jax.random.normal(ks[0], (B, S, H, D), jnp.bfloat16)
        k = jax.random.normal(ks[1], (B, S, KVH, D), jnp.bfloat16)
        v = jax.random.normal(ks[2], (B, S, KVH, D), jnp.bfloat16)
        g = jax.random.normal(ks[3], q.shape, jnp.bfloat16)
        sid = (jnp.repeat(jnp.arange(4), S // 4)[None].repeat(B, 0)
               if seg else None)
        res = {}
        for impl in ("xla", "cudnn", "cudnn", "xla"):
            def f(q, k, v):
                return A.attention(q, k, v, causal=causal, segment_ids=sid)
            with forced(impl, impl):
                if grad:
                    fn = jax.jit(lambda q, k, v, g, f=f:
                                 jax.vjp(f, q, k, v)[1](g))
                else:
                    fn = jax.jit(lambda q, k, v, g, f=f: f(q, k, v))
                ms, _ = timed(fn, q, k, v, g)
            res.setdefault(impl, []).append(ms)
        out(kind="attention", case=name, shape=[B, S, H, KVH, D],
            causal=causal, segments=seg, backward=grad,
            ms={k: sorted(v) for k, v in res.items()})


def bench_ttft(out, cfg):
    import jax
    import jax.numpy as jnp

    from slime_jax.models import llama, slime
    from slime_jax.random_weights import random_slime

    params = random_slime(cfg, 0, llm_fmt="int8")
    mm, _ = chip_smoke._requests(cfg, 0, n_mm=1, text_lens=())
    r = mm[0]
    ids = jnp.asarray(r.input_ids[None])
    px = jnp.asarray(r.pixel_values[None])
    cm = jnp.asarray(r.crop_mask[None])

    def make_query():
        # a fresh function per route, so no trace is shared between routes
        def query(params, ids, px, cm):
            fused = slime.prepare_multimodal(
                params, cfg, ids, jnp.ones(ids.shape, bool), px, cm,
                training=False, compute_dtype=jnp.bfloat16)
            idx = jnp.maximum(fused.lengths - 1, 0)
            logits, kvs = llama.forward(params["llm"], fused.embeds, cfg.llm,
                                        positions=fused.positions,
                                        return_kv=True,
                                        compute_dtype=jnp.bfloat16,
                                        logit_positions=idx)
            return jnp.argmax(logits[:, 0], -1), kvs
        return query

    for llm_impl, vit_impl in (("cudnn", "cudnn"), ("xla", "cudnn"),
                               ("cudnn", "xla"), ("cudnn", "cudnn")):
        with forced(llm_impl, vit_impl):
            fn = jax.jit(make_query())
            ms, ts = timed(fn, params, ids, px, cm, reps=5)
        out(kind="ttft_query", llm_attention=llm_impl,
            vit_attention=vit_impl, decoder="int8", ms=ms,
            all_ms=[round(t, 3) for t in ts])
        del fn
        gc.collect()
    del params
    gc.collect()


def bench_train_step(out, cfg):
    import jax
    import jax.numpy as jnp

    from slime_jax.random_weights import random_slime
    from slime_jax.train.optim import TrainConfig
    from slime_jax.train.step import init_train_state, make_train_step

    tc = TrainConfig(tune_mm_mlp_adapter=True, learning_rate=1e-3,
                     total_steps=100, warmup_ratio=0.0)
    batch = chip_smoke.train_batch(cfg, 0)
    for llm_impl in ("cudnn", "xla", "cudnn"):
        params = random_slime(cfg, 0, adapter_dtype=jnp.float32)
        state, tx = init_train_state(params, tc)
        del params
        with forced(llm_impl, None):
            step = make_train_step(cfg, tc, tx, compute_dtype=jnp.bfloat16,
                                   remat=True, scan_layers=True)
            rng = jax.random.PRNGKey(0)
            try:
                state, m = step(state, batch, rng)     # compile + warm
                jax.block_until_ready(m["loss"])
                ts = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    state, m = step(state, batch, rng)
                    jax.block_until_ready(m["loss"])
                    ts.append((time.perf_counter() - t0) * 1e3)
                out(kind="train_step_stage2", llm_attention=llm_impl,
                    batch=[2, 2048], ms=statistics.median(ts),
                    all_ms=[round(t, 3) for t in ts],
                    peak_gib=chip_smoke.peak_gb())
            except jax.errors.JaxRuntimeError as e:
                # an attention route that cannot fit is a result, not a crash
                out(kind="train_step_stage2", llm_attention=llm_impl,
                    batch=[2, 2048], ms=None, error=str(e)[:300])
        del state, step
        gc.collect()


def _tree_bytes(tree):
    import jax
    return sum(x.nbytes for x in jax.tree_util.tree_leaves(tree))


def bench_decode(out, cfg):
    import jax
    import jax.numpy as jnp

    from slime_jax.models import llama
    from slime_jax.ops.quantization import quantize_weight_q4g
    from slime_jax.random_weights import random_llm

    L, T, NEW = cfg.llm, 2048, 64
    ctx = 1216          # fused length of one 672x672 query

    for fmt in ("bf16", "int8", "q4g"):
        if fmt == "q4g":
            params = random_llm(L, jax.random.PRNGKey(0), "bf16")
            params["layers"] = {
                k: ({"weight": jax.jit(functools.partial(
                    quantize_weight_q4g, group=128))(v["weight"])}
                    if k.endswith("proj") else v)
                for k, v in params["layers"].items()}
            gc.collect()
        else:
            params = random_llm(L, jax.random.PRNGKey(0), fmt)
        weight_bytes = (_tree_bytes(params["layers"])
                        + _tree_bytes(params["lm_head"]))
        for B in ((1, 8) if fmt != "q4g" else (1,)):
            cache = llama.init_kv_cache(L, B, T, dtype=jnp.bfloat16)
            cache["length"] = jnp.full((B,), ctx, jnp.int32)
            kv_bytes = 2 * L.num_layers * B * T * L.num_kv_heads * L.head_dim * 2

            def decode_n(params, cache, tok):
                def body(i, carry):
                    cache, tok = carry
                    logits, cache = llama.decode_step(
                        params, cache, tok, L, compute_dtype=jnp.bfloat16)
                    return cache, jnp.argmax(logits, -1).astype(jnp.int32)
                return jax.lax.fori_loop(0, NEW, body, (cache, tok))

            fn = jax.jit(decode_n)
            tok = jnp.zeros((B,), jnp.int32)
            ms, ts = timed(fn, params, cache, tok, reps=5)
            per = ms / NEW
            out(kind="decode_step", weights=fmt, batch=B, cache_len=T,
                context=ctx, ms_per_step=per,
                all_ms_per_step=[round(t / NEW, 4) for t in ts],
                bytes_per_step=weight_bytes + kv_bytes,
                share_of_3_35_TBps=(weight_bytes + kv_bytes) / (per / 1e3)
                / HBM_BYTES_PER_S)
            del fn, cache
        del params
        gc.collect()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write JSON lines here")
    ap.add_argument("--only", default="attention,ttft,train,decode")
    args = ap.parse_args()

    import jax

    from slime_jax.config import SliMEConfig
    from slime_jax.utils import device_description, enable_compilation_cache

    enable_compilation_cache()
    dev = device_description()
    if dev["platform"] != "gpu":
        print(f"needs a GPU, found {dev['platform']}", file=sys.stderr)
        return 1
    out = Out(args.out, {"device": dev, "card": chip_smoke.nvidia_smi(),
                         "jax": jax.__version__})
    cfg = SliMEConfig.slime_8b()
    parts = args.only.split(",")
    if "attention" in parts:
        bench_attention(out)
    if "ttft" in parts:
        bench_ttft(out, cfg)
    if "train" in parts:
        bench_train_step(out, cfg)
    if "decode" in parts:
        bench_decode(out, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
