#!/usr/bin/env python
"""Chip smoke: SliME-8B serving and training on an NVIDIA GPU, checked.

    python chip_smoke.py                 # one card: kernels, serve, train
    python chip_smoke.py --four-cards    # four cards: TP serving, FSDP training

SliME-8B (SliMEConfig.slime_8b: CLIP-L/336, gated projector, 576->144
compression with top-p crop selection, Llama-3-8B decoder) at full width with
random weights from --seed; no checkpoint or tokenizer is needed. Phases:

1. kernels — every attention route and the int8 linear at the model's real
   widths against the float32 reference (highest matmul precision, so no TF32),
   each difference printed beside its limit; then the repository's tests
   marked ``gpu``.
2. serve — the continuous-batching engine (serve/batch_engine.py) with a bf16
   and then an int8 weight-only decoder: four 672x672 image requests and two
   text requests, 32 greedy tokens each. Every request must complete, and
   each request's first token and top-8 logprobs must match a separate
   generate()-style prefill of the same inputs, whose logits must not be flat.
3. train — three stage-2 steps (decoder and vision tower frozen, projector and
   sampler trained, constant learning rate) of the step scripts/train_slime.py
   builds with --remat, batch 2 x 2048 fused tokens, one image per row; the
   loss must be finite and fall at every step.

With --four-cards only the cross-card paths run: the engine on a (1,1,4)
tensor-parallel mesh and the same engine on one card, on a text request,
each against the reference prefill and against each other, and one stage-3
train step (4 decoder layers) on (1,2,2) and (1,4,1) meshes against one card.

Any failed check raises; nothing is caught. The last stdout line is a JSON
object {"ok": true, "device": {...}} and is printed only when every phase
passed. Without a GPU the script exits non-zero before any phase.
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# bf16 operands on N(0, 1) inputs: output and gradient limits. Gradients are
# compared as |err| / max(1, |ref|): a bf16 value above 1 carries an absolute
# rounding step of up to |ref| * 2^-8, so large entries are held relatively
OUT_MAX_ABS, OUT_MEAN_ABS, GRAD_MAX_ABS = 2e-2, 2e-3, 5e-2
# a first token may differ from the reference argmax only where the reference
# itself ranks the two within this many nats (a bf16 near-tie)
TIE_NATS = 0.05
# top-8 first-token logprobs: engine vs reference prefill
LOGPROB_MAX_ABS = 0.25
# the reference's best logprob must stand this far above its median: flat
# logits (a zero or lost hidden state) would pass every comparison above
MIN_LOGIT_SPREAD = 1.0
# the test files that hold the repository's gpu-marked tests
GPU_TEST_FILES = ("tests/test_attention.py",)


def log(msg):
    print(msg, flush=True)


def check(name, value, limit, *, at_least=False):
    """Print a measured value beside its limit (an upper one, or a lower one
    with ``at_least``); raise when it misses. NaN always misses."""
    ok = bool(value >= limit if at_least else value <= limit)
    bound = "floor" if at_least else "limit"
    log(f"  {name}: {value:.3e} ({bound} {limit:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {value} misses {bound} {limit}")


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def peak_gb():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2 ** 30


# ---------------------------------------------------------------------------
# 1. kernels
# ---------------------------------------------------------------------------

def _err(out, ref):
    import jax.numpy as jnp
    d = jnp.abs(jnp.asarray(out, jnp.float32) - jnp.asarray(ref, jnp.float32))
    return float(jnp.max(d)), float(jnp.mean(d))


def _scaled_err(out, ref):
    """max |out - ref| / max(1, |ref|), and the raw max-abs for the record."""
    import jax.numpy as jnp
    ref = jnp.asarray(ref, jnp.float32)
    d = jnp.abs(jnp.asarray(out, jnp.float32) - ref)
    return float(jnp.max(d / jnp.maximum(1.0, jnp.abs(ref)))), float(jnp.max(d))


def _attention_case(name, B, S, H, KVH, D, *, causal, seg=False, grad=False,
                    seed=0):
    import jax
    import jax.numpy as jnp

    from slime_jax.ops import attention as A

    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    q = jax.random.normal(ks[0], (B, S, H, D), jnp.bfloat16)
    k = jax.random.normal(ks[1], (B, S, KVH, D), jnp.bfloat16)
    v = jax.random.normal(ks[2], (B, S, KVH, D), jnp.bfloat16)
    segment_ids = None
    if seg:
        # packed rows: four segments of random lengths, zero padding tail
        rng = np.random.default_rng(seed)
        sid = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(64, S - 64), 4, replace=False))
            for i, (a, e) in enumerate(zip([0] + list(cuts[:-1]), cuts)):
                sid[b, a:e] = i + 1
        segment_ids = jnp.asarray(sid)
    impl = A.choose_implementation(q, k, segment_ids=segment_ids)
    log(f"{name}: B={B} S={S} H={H}/{KVH} D={D} causal={causal} "
        f"segments={seg} -> {impl}")

    def f(q, k, v):
        return A.attention(q, k, v, causal=causal, segment_ids=segment_ids)

    def ref(q, k, v):
        t = lambda x: jnp.swapaxes(x.astype(jnp.float32), 1, 2)
        return jnp.swapaxes(A.reference_attention(
            t(q), t(k), t(v), causal=causal, segment_ids=segment_ids), 1, 2)

    # rows of the padding segment (id 0) are loss-masked in training; their
    # output is compared all the same
    out = jax.jit(f)(q, k, v)
    with jax.default_matmul_precision("highest"):
        r = jax.jit(ref)(q, k, v)
    mx, mean = _err(out, r)
    check(f"{name} out max-abs", mx, OUT_MAX_ABS)
    check(f"{name} out mean-abs", mean, OUT_MEAN_ABS)
    del r
    if grad:
        g = jax.random.normal(ks[3], out.shape, jnp.bfloat16)
        d = jax.jit(lambda q, k, v: jax.vjp(f, q, k, v)[1](g))(q, k, v)
        with jax.default_matmul_precision("highest"):
            dr = jax.jit(lambda q, k, v: jax.vjp(ref, q, k, v)[1](
                g.astype(jnp.float32)))(q, k, v)
        for nm, a, b in zip(("dq", "dk", "dv"), d, dr):
            scaled, raw = _scaled_err(a, b)
            log(f"  {name} {nm} raw max-abs {raw:.3e}")
            check(f"{name} {nm} max |err|/max(1,|ref|)", scaled, GRAD_MAX_ABS)
    return impl


def _int8_linear_case(K, N, rows, seed=0):
    import jax
    import jax.numpy as jnp

    from slime_jax.models import layers as L
    from slime_jax.ops.quantization import dequantize_weight, quantize_weight

    kx, kw = jax.random.split(jax.random.PRNGKey(seed))
    # weight std 1/sqrt(K): outputs are O(1) like the N(0,1) attention cases
    w = jax.random.normal(kw, (N, K), jnp.float32) / K ** 0.5
    p = {"weight": quantize_weight(w, 8)}
    x = jax.random.normal(kx, (rows, K), jnp.bfloat16)
    out = jax.jit(L.linear)(p, x)
    with jax.default_matmul_precision("highest"):
        r = jax.jit(lambda x: x.astype(jnp.float32)
                    @ dequantize_weight(p["weight"]).T)(x)
    mx, mean = _err(out, r)
    name = f"int8 linear {K}->{N} rows={rows}"
    log(name)
    check(f"{name} max-abs", mx, OUT_MAX_ABS)
    check(f"{name} mean-abs", mean, OUT_MEAN_ABS)


def phase_kernels():
    log("== phase 1: kernels (bf16 vs float32 reference, highest precision)")
    # LLM prefill/training attention: Llama-3-8B heads
    _attention_case("llm fused-prefill causal+padded", 1, 1649, 32, 8, 128,
                    causal=True)
    _attention_case("llm train causal", 4, 2048, 32, 8, 128, causal=True,
                    grad=True, seed=1)
    _attention_case("llm packed-SFT segments", 4, 2048, 32, 8, 128,
                    causal=True, seg=True, grad=True, seed=2)
    # ViT: 8 crops (1 global + 7 local) of CLIP-L/336
    _attention_case("vit bidirectional", 8, 577, 16, 16, 64, causal=False,
                    grad=True, seed=3)
    for K, N in ((4096, 14336), (14336, 4096)):
        for rows in (1, 8):
            _int8_linear_case(K, N, rows)

    import pytest
    log("repository tests marked gpu:")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly"]
                     + [os.path.join(REPO, f) for f in GPU_TEST_FILES])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc={rc})")


# ---------------------------------------------------------------------------
# 2. serve
# ---------------------------------------------------------------------------

PROMPT_LEN, NEW_TOKENS = 64, 32


def cache_len(cfg):
    return min(2048, cfg.llm.max_position_embeddings)


def img_hw(cfg):
    """A 2x2 grid of crop tiles: 672x672 at CLIP-L/336."""
    return (2 * cfg.vision.image_size,) * 2


@functools.lru_cache(maxsize=None)
def anyres_fn(cfg):
    import jax

    from slime_jax.data.image_ops import make_device_anyres_fn
    return jax.jit(make_device_anyres_fn(
        img_hw(cfg), tile=cfg.vision.image_size,
        max_crops=1 + cfg.max_local_crops))


def _requests(cfg, seed, n_mm=4, text_lens=(100, 300)):
    """(image requests, text requests) as engine Requests, from the seed."""
    import jax.numpy as jnp

    from slime_jax.constants import IMAGE_TOKEN_INDEX
    from slime_jax.serve.batch_engine import Request

    rng = np.random.default_rng(seed)
    pre = anyres_fn(cfg)
    mm = []
    for _ in range(n_mm):
        img = jnp.asarray(rng.integers(0, 256, img_hw(cfg) + (3,), np.uint8))
        px, cm = pre(img)
        ids = rng.integers(5, cfg.llm.vocab_size, PROMPT_LEN).astype(np.int32)
        ids[2] = IMAGE_TOKEN_INDEX
        mm.append(Request(input_ids=ids, pixel_values=np.asarray(px),
                          crop_mask=np.asarray(cm),
                          max_new_tokens=NEW_TOKENS, logprobs=8))
    text = [Request(input_ids=rng.integers(5, cfg.llm.vocab_size, n)
                    .astype(np.int32), max_new_tokens=NEW_TOKENS, logprobs=8)
            for n in text_lens]
    return mm, text


def _run_engine(engine, reqs, timeout_s=600):
    """Drive ticks until every request's stream closes; -> per request
    (tokens, ttft_s), plus the wall time of the whole run."""
    import queue as _q

    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    toks = {id(r): [] for r in reqs}
    first = {}
    done = set()
    while len(done) < len(reqs):
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"engine did not finish {len(reqs)} "
                                 f"requests in {timeout_s} s")
        engine.tick()
        for r in reqs:
            while id(r) not in done:
                try:
                    item = r.out_queue.get_nowait()
                except _q.Empty:
                    break
                if item is None:
                    done.add(id(r))
                else:
                    first.setdefault(id(r), time.perf_counter() - t0)
                    toks[id(r)].extend(item)
    wall = time.perf_counter() - t0
    return [(toks[id(r)], first.get(id(r))) for r in reqs], wall


@functools.lru_cache(maxsize=None)
def _reference_prefill(cfg, multimodal):
    """generate()'s prefill, unpadded and outside the engine -> log-softmax
    [V] at the last valid position (the distribution its first token is
    sampled from)."""
    import jax
    import jax.numpy as jnp

    from slime_jax.models import llama, slime

    @jax.jit
    def prefill(params, ids, *image):
        if multimodal:
            fused = slime.prepare_multimodal(
                params, cfg, ids, jnp.ones(ids.shape, bool), *image,
                training=False, compute_dtype=jnp.bfloat16)
            embeds, positions = fused.embeds, fused.positions
            idx = jnp.maximum(fused.lengths - 1, 0)
        else:
            embeds = llama.embed(params["llm"], ids).astype(jnp.bfloat16)
            positions, idx = None, jnp.full((1,), ids.shape[1] - 1)
        logits, _ = llama.forward(params["llm"], embeds, cfg.llm,
                                  positions=positions,
                                  compute_dtype=jnp.bfloat16,
                                  logit_positions=idx)
        return jax.nn.log_softmax(logits[0, 0])

    return prefill


def _reference_first_logprobs(params, cfg, req):
    import jax.numpy as jnp
    image = () if req.pixel_values is None else (
        jnp.asarray(req.pixel_values[None]), jnp.asarray(req.crop_mask[None]))
    return np.asarray(_reference_prefill(cfg, bool(image))(
        params, jnp.asarray(req.input_ids[None]), *image), np.float64)


def _check_first_token(name, req, tok, ref_lp):
    """The reference is not flat, the engine's first token is its argmax (or
    a bf16 near-tie with it), and its top-8 logprobs match the reference's."""
    best = int(np.argmax(ref_lp))
    check(f"{name} reference best-minus-median logprob",
          float(ref_lp[best] - np.median(ref_lp)), MIN_LOGIT_SPREAD,
          at_least=True)
    gap = float(ref_lp[best] - ref_lp[tok])
    log(f"  {name}: first token {tok}, reference argmax {best}, "
        f"reference gap {gap:.4f} nats")
    check(f"{name} first-token reference gap", gap, TIE_NATS)
    top = req.logprob_entries[0]["top"]
    check(f"{name} top-8 logprob max-abs",
          float(np.max([abs(lp - ref_lp[t]) for t, lp in top])),
          LOGPROB_MAX_ABS)


def _serve_one(cfg, params, label, mm, text, card):
    import jax.numpy as jnp

    from slime_jax.serve.batch_engine import BatchDecodeEngine

    engine = BatchDecodeEngine(params, cfg, max_slots=8, cache_len=cache_len(cfg),
                               compute_dtype=jnp.bfloat16)
    # warm-up (compiles prefill chunks, the fused embed path and decode)
    w_mm, w_text = _requests(cfg, seed=99, n_mm=1, text_lens=(100, 300))
    _, warm = _run_engine(engine, w_mm + w_text)
    log(f"  [{label}] warm-up incl. compile: {warm:.1f} s")
    reqs = mm + text
    results, wall = _run_engine(engine, reqs)
    for i, ((toks, ttft), r) in enumerate(zip(results, reqs)):
        if ttft is None or not toks:
            raise AssertionError(f"[{label}] request {i} produced no tokens")
        if len(toks) != NEW_TOKENS and cfg.eos_token_id not in toks:
            raise AssertionError(f"[{label}] request {i} stopped at "
                                 f"{len(toks)} of {NEW_TOKENS} tokens")
    n_tok = sum(len(t) for t, _ in results)
    ttfts = [t for _, t in results[:len(mm)]]
    log(f"  [{label}] {len(reqs)} requests complete, {n_tok} tokens in "
        f"{wall:.2f} s = {n_tok / wall:.1f} tok/s; image-request TTFT "
        f"{min(ttfts):.3f}-{max(ttfts):.3f} s (submitted together; "
        f"record only, on {card})")
    for i, (r, (toks, _)) in enumerate(zip(reqs, results)):
        kind = "image" if r.pixel_values is not None else "text"
        _check_first_token(f"[{label}] {kind} request {i}", r, toks[0],
                           _reference_first_logprobs(params, cfg, r))
    return results


def phase_serve(cfg, seed, card):
    import gc

    from slime_jax.random_weights import random_slime

    log("== phase 2: serve (BatchDecodeEngine, max_slots=8, cache_len=2048)")
    for fmt in ("bf16", "int8"):
        params = random_slime(cfg, seed, llm_fmt=fmt)
        mm, text = _requests(cfg, seed)
        _serve_one(cfg, params, f"decoder {fmt}", mm, text, card)
        del params
        gc.collect()


# ---------------------------------------------------------------------------
# 3. train
# ---------------------------------------------------------------------------

def train_batch(cfg, seed, B=2):
    """B rows of one 672x672 image + text that fills the 2048-token fused
    sequence; labels on the text."""
    import jax.numpy as jnp

    from slime_jax.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    pre = anyres_fn(cfg)
    # global view (576 tokens) + separator + up to 4 selected local crops of
    # 144: the text (its sentinel replaced) fills the rest of the budget
    S = (cfg.tokenizer_model_max_length - cfg.vision.num_patches - 1
         - 4 * cfg.mm_resampler_dim + 1)
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 8] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, -100, ids)
    labels[:, :8] = -100
    pxs, cms = zip(*(pre(jnp.asarray(rng.integers(0, 256, img_hw(cfg) + (3,),
                                                  np.uint8)))
                     for _ in range(B)))
    return {"input_ids": jnp.asarray(ids),
            "attention_mask": jnp.ones((B, S), bool),
            "labels": jnp.asarray(labels),
            "pixel_values": jnp.stack(pxs).astype(jnp.bfloat16),
            "crop_mask": jnp.stack(cms)}


def phase_train(cfg, seed, card):
    import jax
    import jax.numpy as jnp

    from slime_jax.random_weights import random_slime
    from slime_jax.train.optim import TrainConfig
    from slime_jax.train.step import init_train_state, make_train_step

    log("== phase 3: train (stage 2: projector + sampler, bf16 compute)")
    # constant: a warmup would start at lr 0 and leave step 0 without effect
    tc = TrainConfig(tune_mm_mlp_adapter=True, learning_rate=1e-3,
                     total_steps=3, lr_schedule="constant")
    params = random_slime(cfg, seed, adapter_dtype=jnp.float32)
    state, tx = init_train_state(params, tc)
    del params
    # per-layer remat (train_slime.py --remat): without it the backward
    # stash of 32 layers at 2 x 2048 does not fit beside the 16 GB decoder
    step = make_train_step(cfg, tc, tx, compute_dtype=jnp.bfloat16,
                           remat=True, scan_layers=True)
    batch = train_batch(cfg, seed)
    rng = jax.random.PRNGKey(seed)
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        state, m = step(state, batch, rng)
        loss = float(jax.block_until_ready(m["loss"]))
        dt = time.perf_counter() - t0
        losses.append(loss)
        log(f"  step {i}: loss {loss:.5f} grad_norm {float(m['grad_norm']):.4e}"
            f" target tokens {int(m['n_target_tokens'])} "
            f"{dt:.3f} s{' (incl. compile)' if i == 0 else ''}")
    log(f"  peak device memory {peak_gb():.2f} GiB (on {card})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    for i in (1, 2):
        check(f"loss[{i}] - loss[{i - 1}] (must fall)",
              losses[i] - losses[i - 1], -1e-6)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_cards(cfg, seed, devices):
    """TP serving and FSDP training across ``devices`` vs one device."""
    import dataclasses
    import gc

    import jax
    import jax.numpy as jnp

    from slime_jax.parallel import mesh as mesh_lib
    from slime_jax.random_weights import random_slime
    from slime_jax.serve.batch_engine import BatchDecodeEngine
    from slime_jax.train.optim import TrainConfig
    from slime_jax.train.step import init_train_state, make_train_step

    n = len(devices)
    log(f"== tensor-parallel serving on a (1,1,{n}) mesh vs one device")
    params = random_slime(cfg, seed)
    # a 100-token prompt takes the whole-prompt prefill (llama.forward), whose
    # cuDNN attention runs per device under the mesh; image requests would
    # add the vision compile under TP to a four-card bill
    outs = {}
    for label, mesh in (("1 device", None), (f"tp={n}", mesh_lib.make_mesh(
            1, 1, n, devices=devices))):
        _, reqs = _requests(cfg, seed, n_mm=0, text_lens=(100,))
        engine = BatchDecodeEngine(params, cfg, max_slots=8, cache_len=cache_len(cfg),
                                   compute_dtype=jnp.bfloat16, mesh=mesh)
        res, wall = _run_engine(engine, reqs)
        log(f"  [{label}] {len(reqs)} requests complete in {wall:.1f} s "
            f"(incl. compile)")
        outs[label] = (res, reqs)
        del engine
        gc.collect()
    (r1, q1), (rt, qt) = outs["1 device"], outs[f"tp={n}"]
    for i in range(len(q1)):
        ref_lp = _reference_first_logprobs(params, cfg, q1[i])
        for label, res, q in (("1 device", r1, q1), (f"tp={n}", rt, qt)):
            _check_first_token(f"[{label}] request {i}", q[i], res[i][0][0],
                               ref_lp)
        a = dict(q1[i].logprob_entries[0]["top"])
        b = dict(qt[i].logprob_entries[0]["top"])
        shared = set(a) & set(b)
        check(f"request {i} top-8 ids shared, tp vs 1 device (missing of 8)",
              8 - len(shared), 1)
        check(f"request {i} first-token logprob max-abs, tp vs 1 device",
              float(np.max([abs(a[t] - b[t]) for t in shared])),
              LOGPROB_MAX_ABS)
    del params
    gc.collect()

    log("== FSDP/TP training step (stage 3, 4 decoder layers) vs one device")
    cfg4 = dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, num_layers=4))
    tc = TrainConfig(learning_rate=1e-5, total_steps=1, warmup_ratio=0.0)
    batch = train_batch(cfg4, seed, B=4)
    rng = jax.random.PRNGKey(seed)
    results = {}
    for label, shape in (("1 device", None), ("(1,2,2)", (1, 2, 2)),
                         ("(1,4,1)", (1, 4, 1))):
        params = random_slime(cfg4, seed, adapter_dtype=jnp.float32)
        params["llm"] = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
            params["llm"])
        mesh = None
        b = batch
        if shape is not None:
            mesh = mesh_lib.make_mesh(*shape, devices=devices)
            b = mesh_lib.shard_batch(mesh, batch)
        state, tx = init_train_state(params, tc, mesh=mesh)
        del params
        step = make_train_step(cfg4, tc, tx, compute_dtype=jnp.bfloat16,
                               remat=True, scan_layers=True, mesh=mesh)
        t0 = time.perf_counter()
        state, m = step(state, b, rng)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        log(f"  [{label}] loss {loss:.6f} grad_norm {gn:.6e} "
            f"({time.perf_counter() - t0:.1f} s incl. compile)")
        results[label] = (loss, gn)
        del state, step
        gc.collect()
    l1, g1 = results["1 device"]
    for label in ("(1,2,2)", "(1,4,1)"):
        l, g = results[label]
        check(f"{label} loss rel diff", abs(l - l1) / abs(l1), 1e-3)
        check(f"{label} grad_norm rel diff", abs(g - g1) / abs(g1), 2e-2)


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from slime_jax.config import SliMEConfig
    from slime_jax.utils import device_description, enable_compilation_cache

    cache = enable_compilation_cache()
    dev = device_description()
    card = nvidia_smi()
    log(f"platform={dev['platform']} device_kind={dev['kind']} "
        f"count={dev['count']} card=[{card}] jax={jax.__version__} "
        f"compile_cache={cache}")
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev['platform']!r})",
              file=sys.stderr)
        return 1
    cfg = SliMEConfig.slime_8b()
    t0 = time.perf_counter()
    if args.four_cards:
        if dev["count"] < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{dev['count']}", file=sys.stderr)
            return 1
        devices = jax.devices()[:4]
        phase_four_cards(cfg, args.seed, devices)
        dev["count"] = len(devices)
    else:
        phase_kernels()
        phase_serve(cfg, args.seed, card)
        phase_train(cfg, args.seed, card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
