#!/usr/bin/env python
"""One-command readiness check for released SliME weights (VERDICT r3 #1).

The environment this framework was built in has no egress, so the north-star
check — "load released SliME-7B/8B/13B/70B unchanged, logits within 1e-3 of
the reference implementation" — could never be run here. This script is the
artifact that closes it in ONE run the day a checkpoint directory is
reachable:

    python scripts/verify_released_weights.py /path/to/SliME-8B \\
        [--golden golden.npz] [--record] [--model-base DIR] [--vision-path DIR]

What it does, in order (each prints PASS/FAIL; exit code 0 only if all pass):

  1. **load (mode: full)** — ``checkpoint.load_pretrained`` on the directory
     (reference ``llava/model/builder.py:26-173`` semantics: sharded index or
     single file, mm_projector.bin / sampler.bin adapter pickup, LoRA merge
     when ``--model-base`` is given).
  2. **logit parity** — a deterministic probe batch (seed 0, text+image, see
     ``probe_inputs``; any implementation — this one or the torch reference —
     can regenerate it from the config alone) runs through the fused
     multimodal forward. The last-position logits are compared to the golden
     file at ``--tol`` (default 1e-3, the north-star bound). ``--record``
     writes the golden instead (self-golden for regression; record the same
     arrays from the torch reference to make it a cross-implementation
     parity check).
  3. **greedy generations** — 3 fixed prompts (one multimodal, two text-only),
     16 greedy tokens each, compared token-exactly to the golden.
  4. **quantized loads** — ``load_bits=8`` and ``load_bits=4`` (NF4, the
     bitsandbytes data type the reference loads, builder.py:32-41) re-run the
     probe; last-position top-1 agreement vs this run's full-precision logits
     must clear ``--top1-int8`` / ``--top1-int4`` (defaults 0.95 / 0.85 —
     the measured 8B bands live in docs/Serving.md).

Exercised end-to-end against a locally-exported checkpoint in
``tests/test_verify_released_weights.py`` — including that a corrupted
weight FAILS.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_GEN_PROMPTS = 3
GEN_TOKENS = 16
PROBE_B, PROBE_S = 2, 24


def probe_inputs(cfg):
    """Deterministic probe batch from the config alone (seed 0): token ids in
    [5, vocab), an '<image>' sentinel at position 2 of row 0, unit-normal
    pixels for the full crop grid. Reproduce in torch with the same calls."""
    from slime_jax.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(0)
    MC = 1 + cfg.max_local_crops
    t = cfg.vision.image_size
    ids = rng.integers(5, cfg.llm.vocab_size, (PROBE_B, PROBE_S)).astype(np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    pixels = rng.standard_normal((PROBE_B, MC, 3, t, t)).astype(np.float32)
    mask = np.ones((PROBE_B, PROBE_S), bool)
    crop_mask = np.ones((PROBE_B, MC), bool)
    return ids, mask, pixels, crop_mask


def gen_prompts(cfg):
    """3 fixed prompts: [0] multimodal, [1-2] text-only; ids from seed 1."""
    from slime_jax.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(1)
    prompts = []
    for i in range(N_GEN_PROMPTS):
        ids = rng.integers(5, cfg.llm.vocab_size, (1, 9)).astype(np.int32)
        if i == 0:
            ids[0, 1] = IMAGE_TOKEN_INDEX
        prompts.append(ids)
    return prompts


def last_logits(params, cfg, ids, mask, pixels, crop_mask):
    import jax.numpy as jnp

    from slime_jax.models import slime

    logits, _ = slime.forward(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(pixels), jnp.asarray(crop_mask),
                              compute_dtype=jnp.float32)
    return np.asarray(logits[:, -1, :], np.float32)


def run_generations(params, cfg):
    from slime_jax import generate as gen_mod

    outs = []
    ids_probe = probe_inputs(cfg)
    pixels, crop_mask = ids_probe[2][:1], ids_probe[3][:1]
    for i, ids in enumerate(gen_prompts(cfg)):
        toks = gen_mod.generate(
            params, cfg, ids, np.ones_like(ids, bool),
            pixels if i == 0 else None, crop_mask if i == 0 else None,
            max_new_tokens=GEN_TOKENS, temperature=0.0, eos_id=-1)
        outs.append(np.asarray(toks[0], np.int32))
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model_path")
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--golden", default=None,
                    help="golden .npz (default: <model_path>/slime_jax_golden.npz)")
    ap.add_argument("--record", action="store_true",
                    help="write the golden from this run instead of checking")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--top1-int8", type=float, default=0.95)
    ap.add_argument("--top1-int4", type=float, default=0.85)
    ap.add_argument("--skip-quant", action="store_true",
                    help="skip the 8/4-bit load checks (e.g. tiny test models)")
    args = ap.parse_args(argv)

    import jax  # noqa: F401  (import after argparse so --help is instant)

    from slime_jax import checkpoint as ckpt
    from slime_jax.config import SliMEConfig

    golden_path = args.golden or os.path.join(args.model_path,
                                              "slime_jax_golden.npz")
    cfg = SliMEConfig.load(args.model_path)
    results = {}

    def report(name, ok, detail=""):
        results[name] = bool(ok)
        print(f"[{'PASS' if ok else 'FAIL'}] {name}" + (f" — {detail}" if detail else ""),
              flush=True)

    # 1. full-precision load ------------------------------------------------
    try:
        raw = ckpt.load_pretrained(args.model_path, model_base=args.model_base,
                                   cfg=cfg, vision_path=args.vision_path)
        params = ckpt.to_jax(raw)
        n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
        report("load_full", True, f"{n/1e9:.2f}B params")
    except Exception as e:  # noqa: BLE001 — report, don't crash the harness
        report("load_full", False, repr(e))
        print(json.dumps({"verify_released_weights": results, "ok": False}))
        return 1

    ids, mask, pixels, crop_mask = probe_inputs(cfg)
    full = last_logits(params, cfg, ids, mask, pixels, crop_mask)
    gens = run_generations(params, cfg)

    # 2+3. golden record / compare -------------------------------------------
    if args.record:
        arrays = {"last_logits": full}
        for i, g in enumerate(gens):
            arrays[f"gen_tokens_{i}"] = g
        np.savez(golden_path, **arrays)
        report("golden_recorded", True, golden_path)
    elif os.path.exists(golden_path):
        g = np.load(golden_path)
        delta = float(np.max(np.abs(full - g["last_logits"])))
        report("logit_parity", delta <= args.tol,
               f"max|Δ|={delta:.2e} tol={args.tol:g}")
        for i, gen in enumerate(gens):
            want = g[f"gen_tokens_{i}"]
            ok = gen.shape == want.shape and bool(np.all(gen == want))
            report(f"greedy_generation_{i}", ok,
                   "token-exact" if ok else f"got {gen.tolist()[:8]}… want {want.tolist()[:8]}…")
    else:
        report("golden_present", False,
               f"{golden_path} missing — run with --record first (here or "
               "against the torch reference)")

    # 4. quantized loads ------------------------------------------------------
    if not args.skip_quant:
        for bits, thresh in ((8, args.top1_int8), (4, args.top1_int4)):
            try:
                qraw = ckpt.load_pretrained(args.model_path,
                                            model_base=args.model_base,
                                            cfg=cfg, vision_path=args.vision_path,
                                            load_bits=bits)
                qfull = last_logits(ckpt.to_jax(qraw), cfg, ids, mask,
                                    pixels, crop_mask)
                top1 = float(np.mean(np.argmax(qfull, -1) == np.argmax(full, -1)))
                report(f"load_int{bits}", top1 >= thresh,
                       f"last-pos top-1 agreement {top1:.3f} (>= {thresh:g})")
            except Exception as e:  # noqa: BLE001
                report(f"load_int{bits}", False, repr(e))

    ok = all(results.values())
    print(json.dumps({"verify_released_weights": results, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
