"""Accuracy budget for quantized serving at REAL 8B shapes (VERDICT r2 #3).

The int8 serving headline (bench.py) needs a quality story: this measures
teacher-forced logit fidelity of the int8 / int8+lm_head / int4 stacks vs the
bf16 reference on a 16-layer model at TRUE Llama-3-8B width (H=4096, I=14336,
32q/8kv heads, V=128256; per-layer error is width-determined — 16 layers
double-counts nothing and accumulates depth error honestly).

Synthetic N(0, 0.02) weights make near-flat softmaxes, which understate
deployment KL, so metrics are also taken with the lm_head scaled 4x
(logit std ~5, trained-model-like sharpness — the regime where top-1
agreement can actually break).

Metrics per config, over S teacher-forced positions:
  - mean/max KL(bf16 || quant) in nats
  - top-1 agreement rate (greedy-decode fidelity)
  - mean |logit delta| relative to per-position logit std

Prints one JSON line per config. Run on the GPU; ~10 GB device-memory peak.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

LAYERS = int(os.environ.get("SLIME_QACC_LAYERS", "16"))
S = int(os.environ.get("SLIME_QACC_SEQ", "384"))


def main():
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from slime_jax.config import LLMConfig
    from slime_jax.models import llama
    from slime_jax.ops.quantization import (quantize_weight,
                                            quantize_weight_nf4,
                                            quantize_weight_q4g)

    base = LLMConfig.llama3_8b()
    cfg = LLMConfig(**{**base.__dict__, "num_layers": LAYERS})
    H, HD, I, V = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size
    rng = np.random.default_rng(0)

    def w(*shape):
        return (rng.standard_normal(shape).astype(np.float32) * 0.02).astype(
            ml_dtypes.bfloat16)

    print(f"building bf16 {LAYERS}L 8B-width params (pre-stacked)...",
          file=sys.stderr, flush=True)
    L = LAYERS
    cache = f"/tmp/qacc_weights_{L}L.npz"
    if os.path.exists(cache):
        z = np.load(cache)
        stacked = {k: {"weight": z[k].view(ml_dtypes.bfloat16)}
                   for k in z.files}
        print("  (from cache)", file=sys.stderr, flush=True)
    else:
        stacked = {
            "input_layernorm": {"weight": np.ones((L, H), ml_dtypes.bfloat16)},
            "q_proj": {"weight": w(L, cfg.num_heads * HD, H)},
            "k_proj": {"weight": w(L, cfg.num_kv_heads * HD, H)},
            "v_proj": {"weight": w(L, cfg.num_kv_heads * HD, H)},
            "o_proj": {"weight": w(L, cfg.num_heads * HD, H)},
            "post_attention_layernorm": {"weight": np.ones((L, H),
                                                           ml_dtypes.bfloat16)},
            "gate_proj": {"weight": w(L, I, H)},
            "up_proj": {"weight": w(L, I, H)},
            "down_proj": {"weight": w(L, H, I)},
        }
        np.savez(cache, **{k: v["weight"].view(np.uint16)
                           for k, v in stacked.items()})
    params = {
        "embed_tokens": jnp.asarray(w(V, H)),
        "norm": {"weight": jnp.ones((H,), jnp.bfloat16)},
        "layers": jax.tree_util.tree_map(jnp.asarray, stacked),
        "lm_head": {"weight": jnp.asarray(w(V, H))},
    }
    ids = jnp.asarray(rng.integers(5, V, (1, S), np.int32))

    def logits_fn(params):
        # llama.forward: scan path (pre-stacked layers), quant-aware _lm_head
        embeds = llama.embed(params, ids).astype(jnp.bfloat16)
        lg, _ = llama.forward(params, embeds, cfg, compute_dtype=jnp.bfloat16)
        return lg.astype(jnp.float32)

    jl = jax.jit(logits_fn)

    @jax.jit
    def _metric(ref, got, hs):
        # sharpness hs emulates a trained head's logit scale (error scales too)
        ref = ref * hs
        got = got * hs
        lref = jax.nn.log_softmax(ref, -1)
        lgot = jax.nn.log_softmax(got, -1)
        p = jnp.exp(lref)
        kl = jnp.sum(p * (lref - lgot), -1)              # [1, S]
        agree = jnp.mean((jnp.argmax(ref, -1) == jnp.argmax(got, -1))
                         .astype(jnp.float32))
        rel = jnp.mean(jnp.abs(ref - got)) / (jnp.std(ref) + 1e-9)
        return jnp.mean(kl), jnp.max(kl), agree, rel

    def metrics(ref, got, hs):
        mk, xk, ag, rel = _metric(ref, got, jnp.float32(hs))
        return {"kl_mean_nats": round(float(mk), 6),
                "kl_max_nats": round(float(xk), 6),
                "top1_agreement": round(float(ag), 4),
                "rel_logit_err": round(float(rel), 5)}

    print("uploading + reference forward...", file=sys.stderr, flush=True)
    t0 = time.time()
    ref = jl(params)
    float(jnp.sum(ref))
    print(f"  ref done in {time.time() - t0:.0f}s", file=sys.stderr, flush=True)

    def quant_tree(layers, bits):
        # per-LEAF jitted quantize: quantizing the whole stacked tree in one
        # jit doubles it in fp32 on-chip (RESOURCE_EXHAUSTED at 16L); one leaf
        # at a time peaks at base bf16 + one fp32 leaf
        out = {}
        for k, v in layers.items():
            w = v["weight"]
            if w.ndim == 3 and "proj" in k:
                qw = jax.jit(lambda x, b=bits: quantize_weight(
                    x.astype(jnp.float32), b))(w)
                jax.block_until_ready(qw["scale"])
                out[k] = {"weight": qw}
            else:
                out[k] = v
        return out

    def run(name, qp):
        got = jl(qp)
        float(jnp.sum(got))
        out = {f"sharp{hs}x": metrics(ref, got, hs) for hs in (1, 4)}
        del got
        print(json.dumps({"config": name, "layers": LAYERS, "positions": S,
                          **out}), flush=True)

    only = os.environ.get("SLIME_QACC_ONLY", "").split(",")
    want = lambda n: not only[0] or n in only

    if want("int8") or want("int8+lm_head"):
        q8 = dict(params)
        q8["layers"] = quant_tree(params["layers"], 8)
        if want("int8"):
            run("int8", q8)
        if want("int8+lm_head"):
            q8h = dict(q8)
            q8h["lm_head"] = {"weight": jax.jit(lambda x: quantize_weight(
                x.astype(jnp.float32), 8))(params["lm_head"]["weight"])}
            run("int8+lm_head", q8h)
            del q8h
        del q8
    if want("int4-absmax"):
        q4 = dict(params)
        q4["layers"] = quant_tree(params["layers"], 4)
        run("int4-absmax", q4)
        del q4
    if want("int4-g128"):
        # group-128 absmax in the q4g packing (dequantized by linear())
        qg = dict(params)
        out = {}
        for k, v in params["layers"].items():
            wt = v["weight"]
            if wt.ndim == 3 and "proj" in k:
                qw = jax.jit(lambda x: quantize_weight_q4g(
                    x.astype(jnp.float32), group=128))(wt)
                jax.block_until_ready(qw["scale"])
                out[k] = {"weight": qw}
            else:
                out[k] = v
        qg["layers"] = out
        run("int4-g128", qg)
        del qg
    if not want("nf4-g64"):
        return

    def nf4_tree(layers):
        # NF4's searchsorted/normalize temporaries are ~3x the fp32 leaf, so
        # quantize per LAYER SLICE (bounds peak temp to one [out,in] matrix)
        qj = jax.jit(lambda x: quantize_weight_nf4(x.astype(jnp.float32),
                                                   group=64))
        out = {}
        for k, v in layers.items():
            w = v["weight"]
            if w.ndim == 3 and "proj" in k:
                slices = [qj(w[i]) for i in range(w.shape[0])]
                qw = {kk: jnp.stack([s[kk] for s in slices])
                      for kk in slices[0]}
                jax.block_until_ready(qw["scale"])
                out[k] = {"weight": qw}
            else:
                out[k] = v
        return out

    qn = dict(params)
    qn["layers"] = nf4_tree(params["layers"])
    run("nf4-g64", qn)


if __name__ == "__main__":
    main()
