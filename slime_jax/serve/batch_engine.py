"""Continuous-batching decode engine (the reference's SGLang-worker role,
SURVEY.md §2.15: a batched decode server with continuous batching).

Design: a fixed number of decode *slots* share one sharded KV cache
[layers, slots, cache_len, KVH, hd]. Each request is prefilled individually
(multimodal fusion included), its KV written into a free slot, and every engine
tick advances ALL active slots with one jitted batched decode step — new requests
join between ticks without recompiling (static shapes throughout). Finished slots
(EOS / budget / stop string) retire immediately and free capacity.

Compared to the per-request HTTP worker, this amortizes the decode step's weight
streaming over all concurrent requests — the dominant cost of LLM serving on
bandwidth-bound hardware.
"""
from __future__ import annotations

import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import SliMEConfig
from ..constants import IMAGE_TOKEN_INDEX
from ..models import llama, slime


@dataclass
class Request:
    input_ids: np.ndarray                  # [S]
    pixel_values: Optional[np.ndarray] = None   # [MC, 3, t, t]
    crop_mask: Optional[np.ndarray] = None
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0                     # nucleus sampling (ignored when greedy)
    top_k: int = 0                         # 0 = off (HF semantics, before top_p)
    min_p: float = 0.0                     # 0 = off (HF MinPLogitsWarper)
    repetition_penalty: float = 1.0        # HF/vLLM: over prompt + generated
    presence_penalty: float = 0.0          # OpenAI: over generated tokens
    frequency_penalty: float = 0.0         # OpenAI: over generated tokens
    prefix_id: Optional[str] = None        # shared prefix from register_prefix()
    grammar_id: Optional[int] = None       # constraint from register_grammar()
    adapter_id: Optional[int] = None       # LoRA from register_adapter(); 0=base
    logprobs: int = 0                      # top-N alternatives per token (<=8)
    cancelled: bool = False                # set by engine.cancel() at retire time
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    # outputs
    out_queue: "queue.Queue" = field(default_factory=queue.Queue)
    # when logprobs > 0: one {"logprob", "top": [(id, lp), ...]} per emitted
    # token, appended BEFORE its token lands in out_queue (safe to read in
    # lockstep with stream())
    logprob_entries: List[dict] = field(default_factory=list)

    def stream(self):
        """Yield generated token-id lists until completion."""
        while True:
            item = self.out_queue.get()
            if item is None:
                return
            yield item


class _Slot:
    __slots__ = ("req", "generated", "budget", "draft", "t_first")

    def __init__(self, req: Request):
        self.req = req
        self.generated: List[int] = []
        self.budget = req.max_new_tokens
        self.draft = None      # lazy {"len": draft book position} when speculating
        self.t_first = time.monotonic()   # first token just sampled (TTFT end)



def _insert(cache, k, v, slot, length, token):
    # k/v [L, S, KVH, hd] float; quantized on the way in when the
    # pool is int8 (admission prefill always computes float KV)
    import jax

    cache = dict(cache)
    if llama.cache_quantized(cache):
        kq, ks = llama.quantize_kv(k)
        vq, vs = llama.quantize_kv(v)
        cache["k"] = jax.lax.dynamic_update_slice(
            cache["k"], kq[:, None], (0, slot, 0, 0, 0))
        cache["v"] = jax.lax.dynamic_update_slice(
            cache["v"], vq[:, None], (0, slot, 0, 0, 0))
        cache["k_scale"] = jax.lax.dynamic_update_slice(
            cache["k_scale"], ks[:, None], (0, slot, 0, 0))
        cache["v_scale"] = jax.lax.dynamic_update_slice(
            cache["v_scale"], vs[:, None], (0, slot, 0, 0))
    else:
        cache["k"] = jax.lax.dynamic_update_slice(
            cache["k"], k[:, None].astype(cache["k"].dtype),
            (0, slot, 0, 0, 0))
        cache["v"] = jax.lax.dynamic_update_slice(
            cache["v"], v[:, None].astype(cache["v"].dtype),
            (0, slot, 0, 0, 0))
    cache["length"] = cache["length"].at[slot].set(length)
    return cache


def _seed_block(cache1, kblk, vblk, off):
    # write one cached prefix block into the batch-1 admission cache
    # at dynamic offset ``off``; block size is static, so ONE
    # compiled variant serves every hit depth
    import jax

    cache1 = dict(cache1)
    cache1["k"] = jax.lax.dynamic_update_slice(
        cache1["k"], kblk[:, None].astype(cache1["k"].dtype),
        (0, 0, off, 0, 0))
    cache1["v"] = jax.lax.dynamic_update_slice(
        cache1["v"], vblk[:, None].astype(cache1["v"].dtype),
        (0, 0, off, 0, 0))
    return cache1


def _seed_run(cache1, kblks, vblks, off):
    # write a CONTIGUOUS run of cached prefix blocks in one compiled call:
    # seeding block-by-block costs one dispatch per 64 tokens (a 1.5k-token
    # hit would pay ~24 host dispatches). The blocks concat along the seq axis inside the jit and land with one
    # dynamic_update_slice; compile variants are bounded by calling this
    # only at power-of-two run lengths (see the admission loop).
    import jax
    import jax.numpy as jnp

    cache1 = dict(cache1)
    kcat = jnp.concatenate([b[:, None] for b in kblks], axis=2)
    vcat = jnp.concatenate([b[:, None] for b in vblks], axis=2)
    cache1["k"] = jax.lax.dynamic_update_slice(
        cache1["k"], kcat.astype(cache1["k"].dtype), (0, 0, off, 0, 0))
    cache1["v"] = jax.lax.dynamic_update_slice(
        cache1["v"], vcat.astype(cache1["v"].dtype), (0, 0, off, 0, 0))
    return cache1


def _slice_block(arr, off, *, blk):
    # [L, S, KVH, hd] -> one [L, blk, KVH, hd] block copy (the source
    # is the donated admission cache; the copy outlives it)
    import jax

    return jax.lax.dynamic_slice_in_dim(arr, off, blk, axis=1)


_HELPER_JITS: dict = {}


def _lazy_jit(name, fn, **jit_kw):
    """Module-level jit shared across engine instances, created on first call
    (jax stays a lazy import for this module)."""
    def call(*args, **kwargs):
        if name not in _HELPER_JITS:
            import jax
            _HELPER_JITS[name] = jax.jit(fn, **jit_kw)
        return _HELPER_JITS[name](*args, **kwargs)
    return call


_insert_jit_raw = _lazy_jit("insert", _insert, donate_argnums=(0,))
_seed_block_jit_raw = _lazy_jit("seed_block", _seed_block, donate_argnums=(0,))
_slice_block_jit_raw = _lazy_jit("slice_block", _slice_block,
                                 static_argnames=("blk",))


def _i32(x):
    import jax.numpy as jnp
    return jnp.asarray(x, jnp.int32)


# Scalar args (slot / length / offset) MUST reach the jits as device scalars:
# a Python int is a jit compile-time CONSTANT, so every distinct slot index,
# prompt length, and block offset re-traced and re-compiled the cache-donating
# graph — at 8B that was a minutes-long compile inside a live request the
# first time each of the 8 slots was used (measured: serving TTFT p95 1160 s
# on the first on-chip load test).
def _insert_jit(cache, k, v, slot, length, token):
    return _insert_jit_raw(cache, k, v, _i32(slot), _i32(length), token)


def _seed_block_jit(cache1, kblk, vblk, off):
    return _seed_block_jit_raw(cache1, kblk, vblk, _i32(off))


def _seed_run_jit(cache1, kblks, vblks, off):
    # one lazy jit per run length (pow2 only -> <= log2(max_blocks) variants)
    n = len(kblks)
    fn = _lazy_jit(f"seed_run{n}", _seed_run, donate_argnums=(0,))
    return fn(cache1, tuple(kblks), tuple(vblks), _i32(off))


def _slice_block_jit(arr, off, *, blk):
    return _slice_block_jit_raw(arr, _i32(off), blk=blk)

class BatchDecodeEngine:
    def __init__(self, params, cfg: SliMEConfig, *, max_slots: int = 8,
                 cache_len: int = 2048, compute_dtype=None, seed: int = 0,
                 draft_params=None, draft_cfg: Optional[SliMEConfig] = None,
                 spec_k: int = 4, spec_rounds: int = 8, mesh=None,
                 kv_quant: bool = False, prefix_cache_mb: int = 512,
                 prefix_block: int = 64):
        """``mesh``: tensor-parallel serving — params shard by the Megatron
        rules (parallel/mesh.py), the slot KV cache shards kv heads on the
        ``model`` axis, and every jitted step runs SPMD across the mesh. One
        engine then serves a model larger than a single device (70B-class),
        which the reference cannot do at all (one whole model per worker).

        ``kv_quant``: int8 KV cache with per-(position, head) scales — half
        the cache memory (longer contexts / more slots per device) and half the
        decode-tick cache read traffic; scales fold into the attention scores
        (llama.init_kv_cache docstring). ~1% attention-output error, bounds
        pinned in tests/test_kv_quant.py.

        ``prefix_cache_mb``: byte budget for the AUTOMATIC prefix KV cache
        (serve/prefix_cache.py — the sglang RadixAttention role): prompts
        sharing a prefix with any earlier prompt skip recomputing it in
        ``prefix_block``-token granularity. Multimodal prompts participate
        through fused identity streams (token ids + image content hashes per
        feature slot), so a multi-turn image chat re-prefills only the new
        turn's text — the vision encode still runs (the new text can change
        the crop selection; a selection change simply misses past the image
        span). Exact by construction (a digest match means the reused KV is
        byte-identical to what a fresh prefill would write); 0 disables."""
        import jax
        import jax.numpy as jnp

        self.jax = jax
        self.jnp = jnp
        self.mesh = mesh
        if mesh is not None:
            from ..parallel import mesh as mesh_lib
            if not mesh_lib.on_mesh(params, mesh):
                params = mesh_lib.shard_params(mesh, params)
            if draft_params is not None and not mesh_lib.on_mesh(draft_params,
                                                                 mesh):
                draft_params = mesh_lib.shard_params(mesh, draft_params)
        self.params = params
        self.cfg = cfg
        # speculative draft (serve/speculative.py semantics, wired into the
        # engine): used in the all-greedy idle regime — every active slot
        # drafts/verifies batched in one dispatch; exactness holds for ANY
        # draft — it only changes how many target passes the tokens take.
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        # draft/verify rounds folded into one device dispatch (each host sync
        # idles the device; bounded so pending admissions wait at most
        # ~spec_rounds x round-time)
        self.spec_rounds = max(1, spec_rounds)
        self.compute_dtype = compute_dtype or jnp.float32
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.rng = jax.random.PRNGKey(seed)
        self._np_rng = np.random.default_rng(seed)  # first-token host sampling

        self.kv_quant = kv_quant
        self.cache = llama.init_kv_cache(cfg.llm, max_slots, cache_len,
                                         dtype=self.compute_dtype,
                                         quantized=kv_quant)
        if mesh is not None:
            from ..parallel import mesh as mesh_lib
            self.cache = mesh_lib.shard_kv_cache(mesh, self.cache)
        self.cur_tokens = jnp.zeros((max_slots,), jnp.int32)
        # constrained decoding (serve/grammar.py): registered token-DFAs are
        # packed into ONE combined table pair (state 0 = pass-through), the
        # per-slot automaton state lives on device, and the decode step masks
        # logits + advances states in-graph — zero per-step host work
        self.grammars = []             # list of TokenDFA
        self._g_offsets: List[int] = []
        self._vocab_size = cfg.llm.vocab_size
        self._rebuild_grammar_tables()
        self.gram_state = jnp.zeros((max_slots,), jnp.int32)
        # repetition/presence/frequency penalty state: per-slot prompt
        # presence (set at admission) and generated-token counts (advanced
        # in-graph). Rows of slots without penalties are never read (their
        # knobs are identity), so they can go stale for free
        self.prompt_mask = jnp.zeros((max_slots, self._vocab_size), bool)
        self.gen_counts = jnp.zeros((max_slots, self._vocab_size), jnp.int32)
        # multi-LoRA serving (register_adapter): stacked [N, L, r, ...]
        # adapter registry per projection, per-slot adapter ids, and a
        # params view with batch-gathered "lora_b" entries rebuilt only when
        # the slot->adapter map changes
        self.lora_stacks = None
        self._lora_rank = None
        self._n_adapters = 1                  # id 0 = base model
        self._slot_adapter = np.zeros((max_slots,), np.int64)
        self._params_lora = None
        self._params_single = {}              # adapter_id -> prefill view
        self._use_lora = False
        # host mirror of cache["length"] per slot — picks the decode window
        # bucket without a device pull (refreshed from every packed result)
        self._host_len = np.zeros((max_slots,), np.int64)
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self.prefixes = {}             # prefix_id -> {"k","v","length"} shared KV
        self._prepare_mm = None   # lazy jit of the mm embed path
        # automatic radix-style prefix cache (serve/prefix_cache.py)
        self.prefix_cache = None
        if prefix_cache_mb > 0:
            from .prefix_cache import PrefixCache
            self.prefix_cache = PrefixCache(
                block=prefix_block, budget_bytes=prefix_cache_mb << 20)
        self.prefill_chunk_len = 256   # admission granularity (bounds tick latency)
        self.multi_step = 8            # decode steps per dispatch when queue is idle
        # overlapped decode: in the steady idle regime the engine keeps ONE
        # dispatch in flight and processes dispatch N-1's packed result while
        # N runs on device — the host pull + bookkeeping stops serializing
        # between device steps. (packed_handle, k, active_ids, slot_snapshot, n_lp) or None.
        self._inflight = None
        self._admission = None         # in-flight chunked admission state
        # cancellation: ids accumulate from any thread, applied at tick start
        # (the one point where slot state is not mid-dispatch)
        self._cancel_ids: set = set()
        self._cancel_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from collections import deque
        self._metrics = deque(maxlen=512)   # (ttft_s, n_tokens, decode_s)
        self._t_start = time.monotonic()

        # jitted single prefill (per request) and batched decode step
        def _prefill(params, embeds, positions):
            logits, kvs = llama.forward(params["llm"], embeds, cfg.llm,
                                        positions=positions, return_kv=True,
                                        compute_dtype=self.compute_dtype,
                                        mesh=mesh)
            k = jnp.stack([kv[0] for kv in kvs])[:, 0]  # [L, S, KVH, hd]
            v = jnp.stack([kv[1] for kv in kvs])[:, 0]
            return logits[0], k, v

        self._prefill = jax.jit(_prefill)

        def _prefill_chunk(params, cache1, chunk_embeds):
            logits, cache1 = llama.prefill_chunk(params["llm"], cache1, chunk_embeds,
                                                 cfg.llm,
                                                 compute_dtype=self.compute_dtype)
            return logits, cache1

        self._prefill_chunk = jax.jit(_prefill_chunk, donate_argnums=(1,))

        # cache-manipulation helpers are instance-free: module-level jits so
        # every engine in the process (A/B benches build several) shares the
        # compiled executables instead of re-tracing per instance
        self._insert = _insert_jit
        self._seed_block = _seed_block_jit
        self._slice_block = _slice_block_jit

        B_slots = max_slots

        from ..generate import sample_token_dynamic

        def _sample(rng, logits, meta, use_filters):
            # meta rows: [temps, active, top_p, top_k, min_p, rep, pres, freq]
            temperature = meta[:B_slots]
            if use_filters:
                return sample_token_dynamic(
                    rng, logits, temperature, meta[2 * B_slots:3 * B_slots],
                    top_k=meta[3 * B_slots:4 * B_slots],
                    min_p=meta[4 * B_slots:5 * B_slots])
            greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            t = jnp.maximum(temperature, 1e-6)[:, None]
            sampled = jax.random.categorical(rng, logits / t,
                                             axis=-1).astype(jnp.int32)
            return jnp.where(temperature > 0, sampled, greedy)

        def _penalize(logits, meta, pmask, gcnt):
            # repetition penalty (vLLM/HF semantics: prompt + generated),
            # then OpenAI presence/frequency penalties (generated only).
            # Identity knobs (rep=1, pres=0, freq=0) make a row a no-op, so
            # stale count rows of penalty-free slots never matter
            rep = meta[5 * B_slots:6 * B_slots][:, None]
            pres = meta[6 * B_slots:7 * B_slots][:, None]
            freq = meta[7 * B_slots:8 * B_slots][:, None]
            present = pmask | (gcnt > 0)
            adj = jnp.where(logits > 0, logits / rep, logits * rep)
            logits = jnp.where(present, adj, logits)
            gen = gcnt.astype(logits.dtype)
            return logits - pres * (gcnt > 0) - freq * gen

        def _logprob_extra(logits, nxt, n_lp):
            # top-N alternatives + the sampled token's logprob, computed on
            # the distribution the sampler saw (post grammar/penalties, pre
            # temperature — vLLM's processed-logits convention). Floats ride
            # the single int32 packed pull via bitcast
            lp = jax.nn.log_softmax(logits, axis=-1)
            top_v, top_i = jax.lax.top_k(lp, n_lp)
            samp = jnp.take_along_axis(lp, nxt[:, None], axis=-1)[:, 0]
            bc = lambda a: jax.lax.bitcast_convert_type(
                a.astype(jnp.float32), jnp.int32)
            return [top_i.reshape(-1).astype(jnp.int32),
                    bc(top_v).reshape(-1), bc(samp)]

        def _step(params, cache, tokens, rng, meta, gstate, g_allowed, g_nxt,
                  pmask, gcnt, window, use_filters, use_penalties,
                  use_lora=False, n_logprobs=0):
            # meta f32 [8B]: [temperature(B), active(B), top_p(B), top_k(B),
            # min_p(B), rep(B), pres(B), freq(B)] — host-side per-tick
            # scalars bundled into ONE upload (one host->device transfer
            # per tick instead of eight).
            # window (static): attention reads only cache[:, :, :window] —
            # the tick picks a bucket >= max active length, so short contexts
            # in a long-cache pool don't stream the whole pool every step.
            # use_filters (static): top_p/top_k/min_p cost a [B, V] sort per
            # step; the host compiles them in only when an active slot asks.
            # use_penalties (static): rep/pres/freq need the [B, V] count
            # state; compiled in only when an active slot asks.
            # gstate/g_allowed/g_nxt: constrained-decoding automaton — two
            # [B]-row gathers per step (register_grammar docstring)
            active = meta[B_slots:2 * B_slots] > 0.5
            old_len = cache["length"]
            logits, cache = llama.decode_step(
                params["llm"], cache, tokens, cfg.llm,
                compute_dtype=self.compute_dtype, window=window)
            # inactive slots must not advance (their slot may be re-admitted later)
            cache["length"] = jnp.where(active, cache["length"], old_len)
            logits = jnp.where(g_allowed[gstate], logits, -jnp.inf)
            if use_penalties:
                logits = _penalize(logits, meta, pmask, gcnt)
            nxt = _sample(rng, logits, meta, use_filters)
            gstate = jnp.where(active, g_nxt[gstate, nxt], gstate)
            if use_penalties:
                gcnt = gcnt.at[jnp.arange(B_slots), nxt].add(
                    active.astype(jnp.int32))
            # everything the host reads, in ONE array: one device->host
            # pull per tick
            extra = _logprob_extra(logits, nxt, n_logprobs) if n_logprobs \
                else []
            packed = jnp.concatenate([nxt, cache["length"]] + extra)
            return nxt, packed, cache, gstate, gcnt

        self._step = jax.jit(_step, donate_argnums=(1, 5, 9),
                             static_argnums=(10, 11, 12, 13, 14))

        def _step_k(params, cache, tokens, rng, meta, gstate, g_allowed,
                    g_nxt, pmask, gcnt, window, use_filters, use_penalties,
                    use_lora=False, n_logprobs=0):
            # K decode steps in one dispatch (amortizes dispatch and host-sync
            # overhead when no admissions are pending). Emits [B, K] tokens; rows that hit
            # EOS mid-window keep sampling — the host discards post-EOS tokens
            # (the grammar automaton parks at state 0 after EOS, so the junk
            # tail can't walk it out of bounds; penalty counts of retired
            # slots are reset at their next admission).
            # meta f32 [8B+1]: _step's rows + trailing k_steps
            active = meta[B_slots:2 * B_slots] > 0.5
            k_steps = meta[8 * B_slots].astype(jnp.int32)
            old_len = cache["length"]

            def body(i, carry):
                cache, tok, out, rng, gs, cnt, lps = carry
                logits, cache = llama.decode_step(
                    params["llm"], cache, tok, cfg.llm,
                    compute_dtype=self.compute_dtype, window=window)
                rng, sub = jax.random.split(rng)
                logits = jnp.where(g_allowed[gs], logits, -jnp.inf)
                if use_penalties:
                    logits = _penalize(logits, meta, pmask, cnt)
                nxt = _sample(sub, logits, meta, use_filters)
                gs = jnp.where(active, g_nxt[gs, nxt], gs)
                if use_penalties:
                    cnt = cnt.at[jnp.arange(B_slots), nxt].add(
                        active.astype(jnp.int32))
                if n_logprobs:
                    ex = _logprob_extra(logits, nxt, n_logprobs)
                    lps = (lps[0].at[:, i].set(
                               ex[0].reshape(B_slots, n_logprobs)),
                           lps[1].at[:, i].set(
                               ex[1].reshape(B_slots, n_logprobs)),
                           lps[2].at[:, i].set(ex[2]))
                out = out.at[:, i].set(nxt)
                return cache, nxt, out, rng, gs, cnt, lps

            K = self.multi_step
            out0 = jnp.zeros((tokens.shape[0], K), jnp.int32)
            lps0 = (jnp.zeros((B_slots, K, n_logprobs), jnp.int32),
                    jnp.zeros((B_slots, K, n_logprobs), jnp.int32),
                    jnp.zeros((B_slots, K), jnp.int32))
            cache, tok, out, _, gstate, gcnt, lps = jax.lax.fori_loop(
                0, k_steps, body, (cache, tokens, out0, rng, gstate, gcnt,
                                   lps0))
            cache["length"] = jnp.where(active, cache["length"],
                                        old_len)
            extra = [lps[0].reshape(-1), lps[1].reshape(-1),
                     lps[2].reshape(-1)] if n_logprobs else []
            packed = jnp.concatenate([out.reshape(-1), cache["length"]]
                                     + extra)
            return packed, tok, cache, gstate, gcnt

        self._step_k = jax.jit(_step_k, donate_argnums=(1, 5, 9),
                               static_argnums=(10, 11, 12, 13, 14))

        if draft_params is not None:
            assert draft_cfg is not None
            dl = draft_cfg.llm
            # one batched draft KV cache mirroring the target's slot layout —
            # every active slot drafts/verifies in the SAME dispatch (the
            # draft model is small, so bs=max_slots draft steps cost ~the
            # bs=1 step; the verify chunk stays inside the fused
            # prefill_chunk regime B*(K+1) <= 64 at the default 8x5)
            self.d_cache = llama.init_kv_cache(dl, max_slots, cache_len,
                                               dtype=self.compute_dtype)
            if mesh is not None:
                from ..parallel import mesh as mesh_lib
                self.d_cache = mesh_lib.shard_kv_cache(mesh, self.d_cache)

            def _draft_prefill(dparams, ids):
                # ids are bucket-padded; padded positions are causal-masked
                # by construction and never read back (the draft cache length
                # is set to the true length by _d_insert)
                S = ids.shape[1]
                embeds = llama.embed(dparams["llm"], ids).astype(self.compute_dtype)
                _, kvs = llama.forward(
                    dparams["llm"], embeds, dl, return_kv=True,
                    compute_dtype=self.compute_dtype,
                    logit_positions=jnp.full((1,), S - 1), mesh=mesh)
                k = jnp.stack([kv[0] for kv in kvs])[:, 0]   # [L, S, KVH, hd]
                v = jnp.stack([kv[1] for kv in kvs])[:, 0]
                return k, v

            self._draft_prefill = jax.jit(_draft_prefill)

            def _d_insert(d_cache, k, v, slot, length):
                d_cache = dict(d_cache)
                d_cache["k"] = jax.lax.dynamic_update_slice(
                    d_cache["k"], k[:, None].astype(d_cache["k"].dtype),
                    (0, slot, 0, 0, 0))
                d_cache["v"] = jax.lax.dynamic_update_slice(
                    d_cache["v"], v[:, None].astype(d_cache["v"].dtype),
                    (0, slot, 0, 0, 0))
                d_cache["length"] = d_cache["length"].at[slot].set(length)
                return d_cache

            self._d_insert = jax.jit(_d_insert, donate_argnums=(0,))

            K = spec_k
            R = self.spec_rounds
            eos_id = cfg.eos_token_id
            B = max_slots
            cap = self.cache_len - K - 2

            def _one_round(params, dparams, cache, d_cache, cur, d_len_c,
                           alive, window, rng=None, temps=None, tps=None,
                           use_sampling=False):
                """One batched draft-K/verify/rollback round over ALL slots
                (dead/non-spec rows compute but their lengths/tokens are
                pinned). Returns (cache, d_cache, cur', d_len', targets
                [B, K+1], acc [B]): per slot, targets[b, :acc[b]+1] are
                exactly the target's greedy tokens — or, with use_sampling,
                the accepted proposals + rejection-resampled/bonus token of
                the distribution-exact Leviathan scheme
                (serve/speculative.rejection_round)."""
                from .speculative import rejection_round, warp_probs
                d_cache = dict(d_cache)
                d_cache["length"] = d_len_c
                V = self._vocab_size

                def dbody(i, carry):
                    dc, tok, props, qrows, drng = carry
                    lg, dc = llama.decode_step(dparams["llm"], dc, tok, dl,
                                               compute_dtype=self.compute_dtype,
                                               window=window)
                    if use_sampling:
                        drng, sub = jax.random.split(drng)
                        q = warp_probs(lg, temps, tps)          # [B, V]
                        nxt = jax.random.categorical(
                            sub, jnp.log(q + 1e-30),
                            axis=-1).astype(jnp.int32)
                        qrows = qrows.at[:, i].set(q)
                    else:
                        nxt = jnp.argmax(lg, -1).astype(jnp.int32)
                    return dc, nxt, props.at[:, i].set(nxt), qrows, drng

                qrows0 = (jnp.zeros((B, K, V), jnp.float32) if use_sampling
                          else jnp.zeros((B, K, 1), jnp.float32))
                drng0 = rng if rng is not None else jax.random.PRNGKey(0)
                d_cache, _, props, qrows, drng_out = jax.lax.fori_loop(
                    0, K, dbody, (d_cache, cur,
                                  jnp.zeros((B, K), jnp.int32), qrows0,
                                  drng0))

                # verify: every slot's [cur, props...] as ONE (K+1)-wide
                # chunk — B*(K+1) <= 64 keeps the fused prefill_chunk path
                old_len = cache["length"]
                toks = jnp.concatenate([cur[:, None], props], axis=1)
                embeds = llama.embed(params["llm"], toks).astype(
                    self.compute_dtype)
                logits, cache = llama.prefill_chunk(
                    params["llm"], cache, embeds, cfg.llm,
                    compute_dtype=self.compute_dtype, window=window)
                if use_sampling:
                    p_rows = warp_probs(logits, temps, tps)     # [B,K+1,V]
                    targets, acc = rejection_round(drng_out, props, qrows,
                                                   p_rows)
                else:
                    targets = jnp.argmax(logits, -1).astype(jnp.int32)
                    match = props == targets[:, :K]
                    acc = jnp.where(match.all(axis=1), K,
                                    jnp.argmin(match, axis=1))
                n_emit = jnp.where(alive, acc + 1, 0)

                # rollback: verified prefix per slot; dead rows untouched
                cache = dict(cache)
                cache["length"] = old_len + n_emit
                # draft ingests props[:, K-1] so a fully-accepted round
                # leaves a complete draft cache; next round's d_len rolls it
                # back to the verified book position
                _, d_cache = llama.decode_step(dparams["llm"], d_cache,
                                               props[:, K - 1], dl,
                                               compute_dtype=self.compute_dtype,
                                               window=window)
                d_cache = dict(d_cache)
                new_cur = jnp.where(alive, targets[jnp.arange(B), acc], cur)
                return cache, d_cache, new_cur, d_len_c + n_emit, targets, acc

            def _spec_rounds(params, dparams, cache, d_cache, cur_tokens,
                             meta, window, rng=None, sknobs=None,
                             use_sampling=False):
                """Up to R batched draft/verify rounds in ONE dispatch (one
                host sync per R rounds instead of one per round). Every spec
                slot drafts and
                verifies in the SAME device step; a slot stops (goes dead)
                on EOS, budget exhaustion, or nearing cache capacity, and
                the loop runs while any slot is alive. A dead slot's later
                rounds are masked in-graph (lengths/cur pinned) and recorded
                as acc = -1 so the host skips them.

                ``meta`` int32 [3B] = [d_len(B), budget(B), spec_mask(B)] —
                the host-side scalars of the dispatch in ONE upload.
                Returns (packed, cur_tokens, cache, d_cache) where packed
                int32 [B + R*B + R*B*(K+1)] = [lengths(B), accs(R,B),
                toks(R,B,K+1)] — one array so the host syncs with ONE
                pull; for each slot b and round r with accs[r,b] >= 0,
                toks[r, b, :accs[r,b]+1] are exactly the target's greedy
                tokens. cur_tokens advances per slot to its last alive
                round's bonus token (on eos/budget cuts the slot retires
                host-side, so the stale advance is moot)."""
                d_len0 = meta[:B]
                budget = meta[B:2 * B]
                spec = meta[2 * B:3 * B] > 0
                temps = sknobs[:B] if use_sampling else None
                tps = sknobs[B:2 * B] if use_sampling else None
                rng0 = rng if rng is not None else jax.random.PRNGKey(0)

                def cond(carry):
                    r, alive = carry[0], carry[6]
                    return (r < R) & alive.any()

                def body(carry):
                    (r, cache, d_cache, cur, d_len_c, emitted, alive,
                     toks_o, accs_o) = carry
                    rrng = jax.random.fold_in(rng0, r)
                    cache, d_cache, cur, d_len_c, targets, acc = _one_round(
                        params, dparams, cache, d_cache, cur, d_len_c,
                        alive, window, rng=rrng, temps=temps, tps=tps,
                        use_sampling=use_sampling)
                    accs_o = jax.lax.dynamic_update_slice(
                        accs_o, jnp.where(alive, acc, -1)[None], (r, 0))
                    toks_o = jax.lax.dynamic_update_slice(
                        toks_o, targets[None], (r, 0, 0))
                    pos = jnp.arange(K + 1)[None]
                    has_eos = jnp.any((pos <= acc[:, None])
                                      & (targets == eos_id), axis=1)
                    emitted = emitted + jnp.where(alive, acc + 1, 0)
                    alive = (alive & ~has_eos & (emitted < budget)
                             & (cache["length"] < cap))
                    return (r + 1, cache, d_cache, cur, d_len_c, emitted,
                            alive, toks_o, accs_o)

                init = (jnp.int32(0), cache, d_cache, cur_tokens, d_len0,
                        jnp.zeros((B,), jnp.int32), spec,
                        jnp.zeros((R, B, K + 1), jnp.int32),
                        jnp.full((R, B), -1, jnp.int32))
                (_, cache, d_cache, cur_tokens, _dl, _em, _al, toks_o,
                 accs_o) = jax.lax.while_loop(cond, body, init)
                packed = jnp.concatenate([
                    cache["length"], accs_o.reshape(-1), toks_o.reshape(-1)])
                return packed, cur_tokens, cache, d_cache

            self._spec_rounds = jax.jit(_spec_rounds,
                                        donate_argnums=(2, 3, 4),
                                        static_argnums=(6, 9))

    # ------------------------------------------------------------------
    def register_grammar(self, token_dfa) -> int:
        """Register a compiled grammar (serve/grammar.TokenDFA over THIS
        model's vocab) for constrained decoding; requests reference it via
        ``grammar_id``. Registration rebuilds the combined device tables
        (one recompile of the decode step per distinct table shape — a
        registration-time cost, never a per-step one)."""
        assert token_dfa.allowed.shape[1] == self._vocab_size, \
            (token_dfa.allowed.shape, self._vocab_size)
        self.grammars.append(token_dfa)
        self._rebuild_grammar_tables()
        return len(self.grammars) - 1

    def _rebuild_grammar_tables(self) -> None:
        V = self._vocab_size
        eos = self.cfg.eos_token_id
        rows_a = [np.ones((1, V), bool)]       # state 0: pass-through
        rows_n = [np.zeros((1, V), np.int32)]
        self._g_offsets = []
        off = 1
        for td in self.grammars:
            a = td.allowed.copy()
            # a state allowing nothing would wedge its slot (grammar/vocab
            # mismatch): force EOS there so the slot terminates
            stuck = ~a.any(axis=1)
            if stuck.any() and 0 <= eos < V:
                a[stuck, eos] = True
            x = (td.nxt + off).astype(np.int32)
            if 0 <= eos < V:
                x[:, eos] = 0            # EOS retires the slot; state resets
            self._g_offsets.append(off)
            rows_a.append(a)
            rows_n.append(x)
            off += a.shape[0]
        self._g_allowed_h = np.concatenate(rows_a)
        self._g_nxt_h = np.concatenate(rows_n)
        self._g_allowed = self.jnp.asarray(self._g_allowed_h)
        self._g_nxt = self.jnp.asarray(self._g_nxt_h)

    def register_adapter(self, lora_state: dict) -> int:
        """Register a LoRA adapter for per-request serving -> adapter_id.

        ``lora_state`` is the train/lora.py layout ({"rank", "alpha",
        "adapters": {path: {"A" [L, r, in], "B" [L, out, r]}}}) over THIS
        engine's stacked llm layers (vision/projector adapters are ignored —
        serving adapters target the LLM projections). One base model then
        serves many fine-tunes concurrently: the decode step applies each
        slot's adapter as two batched rank-r matmuls (layers.linear
        "lora_b"), gathered from the registry only when the slot->adapter
        map changes — never per step. Requests select with ``adapter_id``
        (0 = base). Adapters of different ranks zero-pad to the largest."""
        jnp = self.jnp
        scale = lora_state["alpha"] / lora_state["rank"]
        new = {}
        for path, ab in lora_state["adapters"].items():
            parts = path.split("/")
            if "layers" not in parts:
                continue                       # non-LLM target
            proj = parts[-1]
            A = np.asarray(ab["A"], np.float32)
            B = np.asarray(ab["B"], np.float32) * scale
            assert A.ndim == 3 and B.ndim == 3, \
                "register_adapter needs STACKED [L, ...] adapters"
            new[proj] = {"A": A, "B": B}
        assert new, "no llm-layer adapters in lora_state"
        r_new = max(v["A"].shape[1] for v in new.values())
        rank = max(self._lora_rank or 0, r_new)
        # rebuild the [N, L, ...] stacks host-side (registration-time cost):
        # pad old entries to the new max rank, append the new adapter (zeros
        # for projections it doesn't target)
        old_n = self._n_adapters
        stacks = {}
        projs = set(new)
        if self.lora_stacks is not None:
            projs |= set(self.lora_stacks)
        for proj in projs:
            olds = []
            if self.lora_stacks is not None and proj in self.lora_stacks:
                oa = np.asarray(self.lora_stacks[proj]["A"])
                ob = np.asarray(self.lora_stacks[proj]["B"])
            else:
                # projection newly targeted: zeros for every prior adapter
                ex = new[proj]
                L_, _, in_d = ex["A"].shape
                _, out_d, _ = ex["B"].shape
                oa = np.zeros((old_n, L_, 0, in_d), np.float32)
                ob = np.zeros((old_n, L_, out_d, 0), np.float32)
            if oa.shape[2] < rank:             # pad old ranks
                oa = np.pad(oa, ((0, 0), (0, 0), (0, rank - oa.shape[2]),
                                 (0, 0)))
                ob = np.pad(ob, ((0, 0), (0, 0), (0, 0),
                                 (0, rank - ob.shape[3])))
            if proj in new:
                na, nb = new[proj]["A"], new[proj]["B"]
            else:
                na = np.zeros(oa.shape[1:], np.float32)
                nb = np.zeros(ob.shape[1:], np.float32)
            if na.shape[1] < rank:
                na = np.pad(na, ((0, 0), (0, rank - na.shape[1]), (0, 0)))
                nb = np.pad(nb, ((0, 0), (0, 0), (0, rank - nb.shape[2])))
            stacks[proj] = {
                "A": self.jnp.asarray(np.concatenate([oa, na[None]])),
                "B": self.jnp.asarray(np.concatenate([ob, nb[None]]))}
        self.lora_stacks = stacks
        self._lora_rank = rank
        self._n_adapters = old_n + 1
        self._params_single.clear()
        self._refresh_lora_view(force=True)
        return self._n_adapters - 1

    def _refresh_lora_view(self, force: bool = False) -> None:
        """Rebuild the decode params view with per-slot gathered lora_b
        entries. Called when the slot->adapter map changes."""
        jnp = self.jnp
        if self.lora_stacks is None:
            return
        self._use_lora = bool(self._slot_adapter.any())
        if not self._use_lora and not force:
            return
        idx = jnp.asarray(self._slot_adapter.astype(np.int32))
        gathered = {proj: {
            "A": jnp.transpose(ab["A"][idx], (1, 0, 2, 3)),      # [L,B,r,in]
            "B": jnp.transpose(ab["B"][idx], (1, 0, 2, 3))}      # [L,B,out,r]
            for proj, ab in self.lora_stacks.items()}
        base = self.params["llm"]["layers"]
        if isinstance(base, dict):            # stacked: scan slices the L dim
            layers = dict(base)
            for proj, ab in gathered.items():
                entry = dict(layers[proj])
                entry["lora_b"] = ab
                layers[proj] = entry
        else:                                 # per-layer list
            layers = []
            for li, lp in enumerate(base):
                lp = dict(lp)
                for proj, ab in gathered.items():
                    entry = dict(lp[proj])
                    entry["lora_b"] = {"A": ab["A"][li], "B": ab["B"][li]}
                    lp[proj] = entry
                layers.append(lp)
        llm = dict(self.params["llm"])
        llm["layers"] = layers
        self._params_lora = dict(self.params)
        self._params_lora["llm"] = llm

    def _prefill_params(self, req: Request):
        """Params view for this request's admission prefill: the base tree,
        or one with the request's adapter attached as single "lora" entries
        (sliced from the registry; cached per adapter_id)."""
        aid = req.adapter_id or 0
        if not aid:
            return self.params
        if aid not in self._params_single:
            base = self.params["llm"]["layers"]
            if isinstance(base, dict):
                layers = dict(base)
                for proj, ab in self.lora_stacks.items():
                    entry = dict(layers[proj])
                    entry["lora"] = {"A": ab["A"][aid], "B": ab["B"][aid]}
                    layers[proj] = entry
            else:
                layers = []
                for li, lp in enumerate(base):
                    lp = dict(lp)
                    for proj, ab in self.lora_stacks.items():
                        entry = dict(lp[proj])
                        entry["lora"] = {"A": ab["A"][aid, li],
                                         "B": ab["B"][aid, li]}
                        lp[proj] = entry
                    layers.append(lp)
            llm = dict(self.params["llm"])
            llm["layers"] = layers
            view = dict(self.params)
            view["llm"] = llm
            self._params_single[aid] = view
        return self._params_single[aid]

    def register_prefix(self, input_ids, pixel_values=None, crop_mask=None,
                        prefix_id: Optional[str] = None) -> str:
        """Prefill a shared prefix (e.g. system prompt, optionally with an image)
        ONCE; later requests with ``prefix_id`` set skip recomputing it — their
        admission seeds the slot cache with this KV and prefills only the suffix.
        The sglang-style radix/prefix cache role (SURVEY.md §2.15), with
        static shapes: shared KV is copied into each slot's contiguous cache region
        (compute is shared; per-slot KV memory is not)."""
        req = Request(input_ids=np.asarray(input_ids),
                      pixel_values=None if pixel_values is None
                      else np.asarray(pixel_values),
                      crop_mask=None if crop_mask is None
                      else np.asarray(crop_mask))
        embeds, length, _ = self._embed_request(req)
        _, k, v = self._prefill(self.params, embeds, None)
        pid = prefix_id or uuid.uuid4().hex[:8]
        self.prefixes[pid] = {"k": k[:, :length], "v": v[:, :length],
                              "length": length,
                              "ids": np.asarray(input_ids),
                              "text_only": pixel_values is None}
        return pid

    def submit(self, req: Request) -> Request:
        req._t_submit = time.monotonic()
        self.pending.put(req)
        return req

    def cancel(self, request_id: str) -> None:
        """Abort a request (client disconnect / stop-string cut): callable
        from any thread. Takes effect at the next tick boundary — the request
        is dropped from the pending queue, its in-flight admission is
        abandoned, or its decode slot retires, freeing capacity immediately
        instead of decoding an unread stream to budget exhaustion (the
        vLLM/SGLang abort role; the reference's HF generate loop has no
        equivalent — a dead client holds its GPU until max_new_tokens)."""
        with self._cancel_lock:
            self._cancel_ids.add(request_id)

    def _apply_cancellations(self) -> None:
        if not self._cancel_ids:
            return
        with self._cancel_lock:
            ids, self._cancel_ids = self._cancel_ids, set()
        # pending queue: rebuild without the cancelled requests
        kept = []
        while True:
            try:
                r = self.pending.get_nowait()
            except queue.Empty:
                break
            if r.request_id in ids:
                r.cancelled = True
                r.out_queue.put(None)
            else:
                kept.append(r)
        for r in kept:
            self.pending.put(r)
        # in-flight chunked admission
        a = self._admission
        if a is not None and a["req"].request_id in ids:
            a["req"].cancelled = True
            a["req"].out_queue.put(None)
            self._admission = None
        # active decode slots
        for i, s in enumerate(self.slots):
            if s is not None and s.req.request_id in ids:
                s.req.cancelled = True
                self._retire(i)
        # unknown ids are requests that already finished (their stream is
        # closed) — nothing to do

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _embed_request(self, req: Request):
        """-> (embeds [1, S, H], length, ident). Multimodal fusion runs here.

        Multimodal suffixes of a text-only shared prefix fuse with the FULL text
        (prefix ids + suffix ids) and then drop the prefix positions: the
        text-guided local-token sampler (models/sampler.py) conditions on the
        prompt text, so fusing the suffix alone would select different image
        tokens than the reference's full-prompt fusion.

        ``ident`` is the fused identity stream (uint64, prefix_cache.py
        semantics) for plain multimodal requests — None for text-only (their
        key is ``input_ids`` itself) and for explicit-prefix combos (not
        auto-cacheable)."""
        jnp = self.jnp
        ids = np.asarray(req.input_ids)[None]
        if req.pixel_values is not None:
            base = 0
            pre = self.prefixes.get(req.prefix_id) if req.prefix_id else None
            if pre is not None and pre["text_only"]:
                base = pre["length"]
                ids = np.concatenate([pre["ids"][None], ids], axis=1)
            # pad ids to a pow2 bucket and run the WHOLE vision+fusion
            # pipeline as one jit: called eagerly, prepare_multimodal issues
            # hundreds of per-op dispatches per admission.
            # Padded positions carry attention_mask=False, which the fusion
            # already excludes (it is built for padded batches), so the
            # fused length and content are unchanged.
            Cb = 1 << max(4, (ids.shape[1] - 1).bit_length())
            ids_p = np.zeros((1, Cb), np.int32)
            ids_p[:, :ids.shape[1]] = ids
            attn = np.zeros((1, Cb), bool)
            attn[:, :ids.shape[1]] = True
            max_len = base + self.cache_len - req.max_new_tokens - 1
            if self._prepare_mm is None:
                import functools
                import jax

                def _prep(params, ids_d, attn_d, px, cm, *, max_len):
                    fused, iv = slime.prepare_multimodal(
                        params, self.cfg, ids_d, attn_d, px, cm,
                        training=False, compute_dtype=self.compute_dtype,
                        max_len=max_len, return_img_valid=True)
                    packed = jnp.concatenate(
                        [fused.lengths.astype(jnp.int32),
                         iv[0].astype(jnp.int32)])
                    return fused.embeds, packed

                self._prepare_mm = jax.jit(_prep, static_argnames=("max_len",))
            embeds_d, packed_d = self._prepare_mm(
                self.params, jnp.asarray(ids_p), jnp.asarray(attn),
                jnp.asarray(req.pixel_values[None]),
                jnp.asarray(req.crop_mask[None]), max_len=max_len)
            packed = np.asarray(packed_d)
            length = int(packed[0])
            ident = None
            if req.prefix_id is None:
                ident = self._fused_identity(
                    ids[0], packed[1:].astype(bool), req)[:length]
            return embeds_d[:, base:], length - base, ident
        attn = np.ones_like(ids, bool)
        embeds = llama.embed(self.params["llm"],
                             jnp.asarray(ids)).astype(self.compute_dtype)
        return embeds, ids.shape[1], None

    @staticmethod
    def _fused_identity(ids: np.ndarray, img_valid: np.ndarray,
                        req: Request) -> np.ndarray:
        """Host reconstruction of the fused sequence's identity stream.

        Mirrors slime._splice_one's layout exactly: extended order is
        text[:img_pos] ++ image slots ++ text[img_pos:], the sentinel token
        and unselected image slots drop out, order is preserved. Identities:
        token id for text positions, image_slot_identities(content digest)
        for image-feature slots — so the stream's chain digests address the
        very content a fresh prefill of those positions would produce."""
        from .prefix_cache import image_content_digest, image_slot_identities
        is_img = ids == IMAGE_TOKEN_INDEX
        img_pos = int(np.argmax(is_img)) if is_img.any() else len(ids)
        text_ident = np.where(is_img, 0, ids).astype(np.uint64)
        text_valid = ~is_img
        img_ident = image_slot_identities(
            image_content_digest(np.asarray(req.pixel_values),
                                 np.asarray(req.crop_mask)),
            img_valid.shape[0])
        ext_ident = np.concatenate([text_ident[:img_pos], img_ident,
                                    text_ident[img_pos:]])
        ext_valid = np.concatenate([text_valid[:img_pos], img_valid,
                                    text_valid[img_pos:]])
        return ext_ident[ext_valid]

    def _admission_step(self) -> bool:
        """Advance the in-flight chunked admission by one chunk; True when one is
        in flight (caller skips pulling new work beyond decode)."""
        jnp = self.jnp
        if self._admission is None:
            if self.pending.empty() or self._free_slot() is None:
                return False
            req = self.pending.get()
            if req.prefix_id is not None and req.prefix_id not in self.prefixes:
                # fail this request, not the engine thread
                req.out_queue.put(None)
                return False
            if req.grammar_id is not None and not (
                    0 <= req.grammar_id < len(self.grammars)):
                req.out_queue.put(None)
                return False
            if req.adapter_id and (not 0 < req.adapter_id < self._n_adapters
                                   or req.prefix_id is not None):
                # unknown adapter, or shared-prefix KV (computed with the
                # BASE weights) combined with an adapter that would change it
                req.out_queue.put(None)
                return False
            embeds, length, ident = self._embed_request(req)
            cache_key = (ident if req.pixel_values is not None
                         else np.asarray(req.input_ids))
            C = self.prefill_chunk_len
            base = 0
            auto_hit = []
            if (req.prefix_id is None and cache_key is not None
                    and not req.adapter_id    # adapters change prefix KV
                    and self.prefix_cache is not None):
                base, auto_hit = self.prefix_cache.match(cache_key)
            if req.prefix_id is not None:
                pre = self.prefixes[req.prefix_id]
                base = pre["length"]
                cache1 = llama.init_kv_cache(self.cfg.llm, 1, self.cache_len,
                                             dtype=self.compute_dtype)
                cache1 = self._insert(cache1, pre["k"], pre["v"], 0, base, 0)
            elif auto_hit:
                # automatic prefix-cache hit: seed the matched blocks, then
                # chunk-prefill only the suffix (embeds are plain token
                # embeddings — slicing them at the match point is exact)
                blk = self.prefix_cache.block
                cache1 = llama.init_kv_cache(self.cfg.llm, 1, self.cache_len,
                                             dtype=self.compute_dtype)
                # seed in greedy power-of-two runs (matched blocks are one
                # contiguous chain from position 0): one dispatch per run
                # instead of one per 64-token block
                i = 0
                while i < len(auto_hit):
                    n = 1 << ((len(auto_hit) - i).bit_length() - 1)
                    run = auto_hit[i:i + n]
                    if n == 1:
                        cache1 = self._seed_block(cache1, run[0]["value"]["k"],
                                                  run[0]["value"]["v"], i * blk)
                    else:
                        cache1 = _seed_run_jit(
                            cache1, [e["value"]["k"] for e in run],
                            [e["value"]["v"] for e in run], i * blk)
                    i += n
                cache1["length"] = jnp.full((1,), base, jnp.int32)
                embeds = embeds[:, base:]
                length -= base
            elif length <= C:
                self._admit_whole(req, embeds, length, cache_key)
                return False
            else:
                cache1 = llama.init_kv_cache(self.cfg.llm, 1, self.cache_len,
                                             dtype=self.compute_dtype)
            # "length"/"off" are suffix-relative; "base" is the shared-prefix KV
            # already seeded into cache1 (suffix chunks attend to it via pos0).
            self._admission = {"req": req, "embeds": embeds, "length": length,
                               "base": base, "off": 0, "cache1": cache1,
                               "last_logits": None, "cache_key": cache_key}
        a = self._admission
        C = self.prefill_chunk_len
        off = a["off"]
        end = min(off + C, a["length"])
        # pad the chunk to a power-of-two bucket (few compile variants, no
        # full-C padding for short suffixes), capped by C and cache headroom
        # (padded garbage must not wrap dynamic_update_slice at the cache end)
        want = end - off
        Cc = min(max(8, 1 << (want - 1).bit_length()), C,
                 self.cache_len - a["base"] - off)
        end = off + min(want, Cc)  # headroom cap can shorten the chunk
        chunk = a["embeds"][:, off:off + Cc]   # may overrun into padding; fine
        chunk = jnp.pad(chunk, ((0, 0), (0, Cc - chunk.shape[1]), (0, 0))) \
            if chunk.shape[1] < Cc else chunk
        logits, a["cache1"] = self._prefill_chunk(
            self._prefill_params(a["req"]), a["cache1"], chunk)
        a["last_logits"] = logits
        a["last_off"] = off
        a["off"] = end
        # padded tail advanced length too far; pin it to the true position
        a["cache1"]["length"] = jnp.full((1,), a["base"] + end, jnp.int32)
        if end >= a["length"]:
            self._finish_admission()
        return self._admission is not None

    def _finish_admission(self) -> None:
        a, self._admission = self._admission, None
        slot_idx = self._free_slot()
        if slot_idx is None:   # raced out of slots; requeue at the front
            self.pending.put(a["req"])
            return
        # position of the last real token inside the final (variable-size) chunk
        last_in_chunk = a["length"] - 1 - a["last_off"]
        first, gs = self._first_token(
            a["req"], np.asarray(a["last_logits"][0, last_in_chunk]))
        k = a["cache1"]["k"][:, 0]
        v = a["cache1"]["v"][:, 0]
        self._cache_prompt_blocks(a["req"], k, v, a["base"] + a["length"],
                                  a["cache_key"])
        self.cache = self._insert(self.cache, k, v, slot_idx,
                                  a["base"] + a["length"],
                                  self.jnp.asarray(first))
        self._host_len[slot_idx] = a["base"] + a["length"]
        self.cur_tokens = self.cur_tokens.at[slot_idx].set(first)
        self.gram_state = self.gram_state.at[slot_idx].set(gs)
        self._seed_penalty_rows(a["req"], slot_idx, first)
        self._assign_adapter(slot_idx, a["req"])
        slot = _Slot(a["req"])
        slot.generated.append(first)
        slot.budget -= 1
        self.slots[slot_idx] = slot
        a["req"].out_queue.put([first])
        if slot.budget <= 0:
            self._retire(slot_idx)

    def _admit_whole(self, req: Request, embeds, length: int,
                     cache_key=None) -> None:
        slot_idx = self._free_slot()
        if slot_idx is None:
            self.pending.put(req)
            return
        # pad to a power-of-two bucket: raw lengths would compile a fresh
        # prefill + insert graph per distinct prompt length (same bucketing
        # as the chunked path above). Padded positions are causal-masked by
        # construction (they only attend backward) and land in cache slots
        # beyond ``length``, which decode never reads.
        import jax.numpy as jnp
        Cb = min(max(8, 1 << (length - 1).bit_length()), self.cache_len)
        if embeds.shape[1] < Cb:
            embeds = jnp.pad(embeds,
                             ((0, 0), (0, Cb - embeds.shape[1]), (0, 0)))
        logits, k, v = self._prefill(self._prefill_params(req), embeds, None)
        # slice on DEVICE, then pull: np.asarray(logits) would transfer the
        # whole [bucket, V] prefill logits (~263 MB at V=128k) to read one
        # row
        first, gs = self._first_token(req, np.asarray(logits[length - 1]))
        self._cache_prompt_blocks(req, k, v, length, cache_key)
        self.cache = self._insert(self.cache, k, v, slot_idx, length,
                                  self.jnp.asarray(first))
        self._host_len[slot_idx] = length
        self.cur_tokens = self.cur_tokens.at[slot_idx].set(first)
        self.gram_state = self.gram_state.at[slot_idx].set(gs)
        self._seed_penalty_rows(req, slot_idx, first)
        self._assign_adapter(slot_idx, req)
        slot = _Slot(req)
        slot.generated.append(first)
        slot.budget -= 1          # the prefill-sampled token counts toward the budget
        self.slots[slot_idx] = slot
        req.out_queue.put([first])
        if slot.budget <= 0:
            self._retire(slot_idx)

    def _cache_prompt_blocks(self, req: Request, k_full, v_full,
                             length: int, cache_key=None) -> None:
        """Feed the just-prefilled prompt's full blocks to the automatic
        prefix cache. ``cache_key`` is the identity stream the blocks hash
        under: plain input_ids for text-only prompts, the fused identity
        stream (_fused_identity) for multimodal ones — block positions start
        at 0 and align with the key either way. Explicit-prefix and adapted
        requests never cache (their KV isn't a pure function of the key).
        k/v_full: [L, S, KVH, hd] float admission KV covering [0, length)."""
        pc = self.prefix_cache
        if (pc is None or cache_key is None
                or req.prefix_id is not None or req.adapter_id):
            return
        blk = pc.block
        for b, digest, parent in pc.missing_blocks(cache_key, length):
            kb = self._slice_block(k_full, b * blk, blk=blk)
            vb = self._slice_block(v_full, b * blk, blk=blk)
            pc.put(digest, parent, {"k": kb, "v": vb}, kb.nbytes + vb.nbytes)

    def prefix_cache_stats(self) -> Optional[dict]:
        return None if self.prefix_cache is None else self.prefix_cache.stats()

    def metrics_summary(self) -> dict:
        """Serving metrics over the last 512 completed requests: TTFT
        percentiles (submit -> first token, queue time included) and decode
        throughput. Host-clock based — coarse but attributable."""
        m = list(self._metrics)
        if not m:
            return {"completed": 0}
        ttft = np.sort(np.asarray([x[0] for x in m]))
        toks = sum(x[1] for x in m)
        dec_t = sum(x[2] for x in m)
        q = lambda p: float(ttft[min(len(ttft) - 1,
                                     int(p * (len(ttft) - 1)))])
        return {"completed": len(m), "tokens": int(toks),
                "ttft_p50_s": round(q(0.5), 4),
                "ttft_p95_s": round(q(0.95), 4),
                "decode_tok_s_per_req": round(toks / dec_t, 2),
                "uptime_s": round(time.monotonic() - self._t_start, 1)}

    def _seed_penalty_rows(self, req: Request, slot_idx: int,
                           first: int) -> None:
        """Reset this slot's penalty state at admission: prompt presence row
        + generated counts seeded with the admission-sampled token. Skipped
        for penalty-free requests (their knob rows are identity no-ops, so
        stale state is never read)."""
        if not self._request_has_penalties(req):
            return
        jnp = self.jnp
        self.prompt_mask = self.prompt_mask.at[slot_idx].set(
            jnp.asarray(self._prompt_presence(req)))
        self.gen_counts = (self.gen_counts.at[slot_idx].set(0)
                           .at[slot_idx, first].add(1))

    def _request_has_penalties(self, req: Request) -> bool:
        return (req.repetition_penalty != 1.0 or req.presence_penalty != 0.0
                or req.frequency_penalty != 0.0)

    def _prompt_presence(self, req: Request) -> np.ndarray:
        """[V] bool presence of prompt tokens (image sentinels dropped)."""
        present = np.zeros((self._vocab_size,), bool)
        ids = np.asarray(req.input_ids)
        present[ids[(ids >= 0) & (ids < self._vocab_size)]] = True
        return present

    def _first_token(self, req: Request, logits_row: np.ndarray) -> Tuple[int, int]:
        """Sample the prefill's next token on the host (admission logits are
        already host-side), applying the same chain as the decode step:
        grammar mask, penalties (prompt-only at this point — nothing
        generated yet), temperature, top_k, top_p, min_p. Decode-step tokens
        are sampled in-graph; only this first token is host-sampled.
        -> (token, grammar state)."""
        g_off = None
        if req.grammar_id is not None:
            g_off = self._g_offsets[req.grammar_id]
            logits_row = np.where(self._g_allowed_h[g_off], logits_row,
                                  -np.inf)
        if req.repetition_penalty != 1.0:
            present = self._prompt_presence(req)
            rep = req.repetition_penalty
            adj = np.where(logits_row > 0, logits_row / rep, logits_row * rep)
            logits_row = np.where(present, adj, logits_row)
        # presence/frequency penalties count GENERATED tokens only — zero
        # at the first token

        def _state(tok: int) -> int:
            if req.logprobs:
                # admission-token logprobs, same convention as the decode
                # step (post grammar/penalties, pre temperature)
                r64 = logits_row.astype(np.float64)
                lp = r64 - np.log(np.sum(np.exp(r64 - r64.max()))) \
                    - r64.max()
                n = min(req.logprobs, 8)
                top = np.argsort(lp)[::-1][:n]
                req.logprob_entries.append({
                    "logprob": float(lp[tok]),
                    "top": [(int(t), float(lp[t])) for t in top]})
            return 0 if g_off is None else int(self._g_nxt_h[g_off, tok])

        if req.temperature <= 0.0:
            tok = int(np.argmax(logits_row))
            return tok, _state(tok)
        x = logits_row.astype(np.float64) / max(req.temperature, 1e-6)
        if req.top_k > 0:
            order = np.argsort(x)[::-1]
            kth = x[order[min(req.top_k, x.size) - 1]]
            x = np.where(x < kth, -np.inf, x)
        if req.top_p < 1.0:
            order = np.argsort(x)[::-1]
            xs = x[order]
            p = np.exp(xs - xs[0])
            p /= p.sum()
            keep = (np.cumsum(p) - p) < req.top_p   # exclusive-cum rule
            x = np.where(x < xs[keep][-1], -np.inf, x)
        if req.min_p > 0.0:
            p = np.exp(x - np.nanmax(x[np.isfinite(x)]))
            p /= p.sum()
            x = np.where(p < req.min_p * p.max(), -np.inf, x)
        p = np.exp(x - x.max())
        p /= p.sum()
        tok = int(self._np_rng.choice(x.size, p=p))
        return tok, _state(tok)

    def _assign_adapter(self, slot_idx: int, req: Request) -> None:
        aid = req.adapter_id or 0
        if self._slot_adapter[slot_idx] != aid:
            self._slot_adapter[slot_idx] = aid
            self._refresh_lora_view()

    def _retire(self, idx: int) -> None:
        slot = self.slots[idx]
        if slot is not None:
            now = time.monotonic()
            t_sub = getattr(slot.req, "_t_submit", slot.t_first)
            self._metrics.append(
                (slot.t_first - t_sub,               # TTFT (queue + prefill)
                 len(slot.generated),
                 max(now - slot.t_first, 1e-9)))     # decode wall time
            slot.req.out_queue.put(None)
        self.slots[idx] = None
        if self._slot_adapter[idx]:
            self._slot_adapter[idx] = 0
            self._refresh_lora_view()

    def tick(self) -> int:
        """Advance admissions (one chunk) and run one decode step for all active
        slots. Returns the number of active slots after the step."""
        # drain the overlapped dispatch before anything that mutates slot or
        # queue state (cancellations, admissions): emits stay in order and
        # admissions see settled budgets/slots
        if self._inflight is not None and (
                self._cancel_ids or not self.pending.empty()
                or self._admission is not None):
            self._flush_inflight()
        self._apply_cancellations()
        # one admission chunk per tick bounds added decode latency
        in_flight = self._admission_step()
        while not in_flight and not self.pending.empty() \
                and self._free_slot() is not None:
            in_flight = self._admission_step()
            if self._admission is not None:
                break

        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self._flush_inflight()   # tokens for retired slots are discarded
            return 1 if (in_flight or self._admission is not None) else 0

        # finished-by-first-token check (EOS as the very first sample)
        eos = self.cfg.eos_token_id
        for i in list(active):
            s = self.slots[i]
            if s.generated and s.generated[-1] == eos:
                s.generated.pop()
                self._retire(i)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0

        self.rng, sub = self.jax.random.split(self.rng)
        B = self.max_slots
        knobs = np.zeros((8, B), np.float32)
        knobs[2] = 1.0                       # top_p default
        knobs[5] = 1.0                       # repetition_penalty default
        for i in active:
            r = self.slots[i].req
            knobs[0, i] = r.temperature
            knobs[1, i] = 1.0
            knobs[2, i] = r.top_p
            knobs[3, i] = r.top_k
            knobs[4, i] = r.min_p
            knobs[5, i] = r.repetition_penalty
            knobs[6, i] = r.presence_penalty
            knobs[7, i] = r.frequency_penalty
        # filters cost a [B, V] sort per step and penalties read the [B, V]
        # count state — compile each in only when an active slot asks
        use_filters = bool(any(knobs[0, i] > 0.0
                               and (knobs[2, i] < 1.0 or knobs[3, i] > 0
                                    or knobs[4, i] > 0.0) for i in active))
        use_penalties = bool(any(knobs[5, i] != 1.0 or knobs[6, i] != 0.0
                                 or knobs[7, i] != 0.0 for i in active))
        n_lp = min(8, max((self.slots[i].req.logprobs for i in active),
                          default=0))

        idle = (self._admission is None and self.pending.empty())
        if (self.draft_params is not None and idle and not use_penalties
                and not self._use_lora and n_lp == 0
                and all((self.slots[i].req.temperature == 0.0
                         or (self.slots[i].req.top_k == 0
                             and self.slots[i].req.min_p == 0.0))
                        and self.slots[i].req.grammar_id is None
                        and self.slots[i].budget > 1
                        and int(self._host_len[i]) + self.spec_k + 2
                        <= self.cache_len
                        for i in active)):
            self._flush_inflight()   # spec emits must not reorder with ours
            if self._spec_tick(active):
                return sum(s is not None for s in self.slots)
        # tokens already dispatched but not yet pulled (overlapped mode)
        k_prev = self._inflight[1] if self._inflight is not None else 0
        min_budget = min(self.slots[i].budget for i in active)
        k = min(self.multi_step, max(min_budget - k_prev, 1)) if idle else 1
        # host-side per-tick scalars bundled into ONE upload (see _step)
        meta = np.concatenate([knobs.reshape(-1),
                               np.asarray([k], np.float32)])
        # window bucket: smallest multiple of 256 that covers every active
        # slot through this dispatch — the decode attention reads only that
        # prefix of the cache pool (llama.decode_step window), so short
        # contexts don't stream cache_len KV every step. A handful of
        # buckets => a handful of compiled step variants. _host_len can be
        # k_prev tokens stale when a dispatch is still in flight.
        need = int(max(self._host_len[i] for i in active)) + k_prev + k + 1
        window = min(self.cache_len, -(-need // 256) * 256)
        step_params = self._params_lora if self._use_lora else self.params
        if k > 1:
            packed, last, self.cache, self.gram_state, self.gen_counts = \
                self._step_k(
                    step_params, self.cache, self.cur_tokens, sub, meta,
                    self.gram_state, self._g_allowed, self._g_nxt,
                    self.prompt_mask, self.gen_counts, window,
                    use_filters, use_penalties, self._use_lora, n_lp)
            self.cur_tokens = last
        else:
            nxt, packed, self.cache, self.gram_state, self.gen_counts = \
                self._step(
                    step_params, self.cache, self.cur_tokens, sub,
                    meta[:8 * B], self.gram_state, self._g_allowed,
                    self._g_nxt, self.prompt_mask, self.gen_counts, window,
                    use_filters, use_penalties, self._use_lora, n_lp)
            self.cur_tokens = nxt

        # overlapped decode: in the steady idle regime keep THIS dispatch in
        # flight and process the previous one — the host pull + token
        # bookkeeping runs while the device executes the new steps. Flushed
        # before anything that mutates slot state (tick start / retirement).
        snapshot = [self.slots[i] for i in active]
        overlap = (idle and k > 1 and min_budget - k_prev > k
                   and need + self.multi_step < self.cache_len)
        prev, self._inflight = self._inflight, None
        if overlap:
            self._inflight = (packed, k, active, snapshot, n_lp)
            if prev is None:
                return sum(s is not None for s in self.slots)
            retired = self._emit_packed(*prev)
            if retired:
                # slot set changed under the in-flight dispatch; drain it so
                # admissions see settled state next tick
                self._flush_inflight()
        else:
            if prev is not None:
                self._emit_packed(*prev)
            self._emit_packed(packed, k, active, snapshot, n_lp)
        return sum(s is not None for s in self.slots)

    def _flush_inflight(self) -> None:
        """Pull + process the overlapped dispatch, if any."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._emit_packed(*prev)

    def _emit_packed(self, packed, k: int, active: List[int], snapshot,
                     n_lp: int) -> bool:
        """Pull one dispatch's packed result and credit tokens to its slots.
        Returns True if any slot retired. Slots that were retired (cancel) or
        reassigned since dispatch are skipped by identity."""
        B = self.max_slots
        eos = self.cfg.eos_token_id
        packed = np.asarray(packed)          # ONE host pull for the dispatch
        lp_ids = lp_vals = lp_samp = None
        if k > 1:
            K = self.multi_step
            out_np = packed[:B * K].reshape(B, K)[:, :k]
            lengths = packed[B * K:B * K + B]
            if n_lp:
                o = B * K + B
                lp_ids = packed[o:o + B * K * n_lp].reshape(B, K, n_lp)
                o += B * K * n_lp
                lp_vals = packed[o:o + B * K * n_lp].view(
                    np.float32).reshape(B, K, n_lp)
                o += B * K * n_lp
                lp_samp = packed[o:o + B * K].view(np.float32).reshape(B, K)
        else:
            out_np = packed[:B][:, None]
            lengths = packed[B:2 * B]
            if n_lp:
                o = 2 * B
                lp_ids = packed[o:o + B * n_lp].reshape(B, 1, n_lp)
                o += B * n_lp
                lp_vals = packed[o:o + B * n_lp].view(
                    np.float32).reshape(B, 1, n_lp)
                lp_samp = packed[o + B * n_lp:].view(np.float32).reshape(B, 1)

        retired = False
        for i, snap in zip(active, snapshot):
            s = self.slots[i]
            if s is not snap:   # retired/reassigned since dispatch — discard
                continue
            self._host_len[i] = lengths[i]
            emit = []
            for t in out_np[i].tolist():
                if t == eos:
                    s.budget = 0
                    break
                emit.append(int(t))
                s.budget -= 1
                if s.budget <= 0:
                    break
            if emit:
                if s.req.logprobs and lp_ids is not None:
                    n = s.req.logprobs
                    for j in range(len(emit)):
                        s.req.logprob_entries.append({
                            "logprob": float(lp_samp[i, j]),
                            "top": list(zip(lp_ids[i, j, :n].tolist(),
                                            lp_vals[i, j, :n].tolist()))})
                s.generated.extend(emit)
                s.req.out_queue.put(emit)
                if s.draft is not None:
                    # plain tokens bypassed the draft cache; reseed before
                    # the next spec tick (stale drafts only cost acceptance,
                    # but a fresh prefill of the small draft is cheaper than
                    # the lost lookahead)
                    s.draft = None
            if s.budget <= 0 or int(lengths[i]) >= self.cache_len - 1:
                self._retire(i)
                retired = True
        return retired

    def _spec_tick(self, active: List[int]) -> bool:
        """Up to ``spec_rounds`` batched speculative draft/verify rounds for
        ALL active slots (greedy idle regime), folded into ONE device
        dispatch: every slot drafts K tokens through the shared batched draft
        cache and they verify together as one [B, K+1] prefill chunk (the
        fused small-chunk regime, B*(K+1) <= 64 at the default 8x5). Returns
        True when handled; False falls back to the plain step (e.g. a draft
        seeding failed for lack of cache room).

        The draft is TEXT-ONLY: for multimodal requests its context replaces
        the image sentinel with pad — that costs acceptance, never exactness
        (rejected drafts are corrected by the verify chunk)."""
        import numpy as np
        jnp = self.jnp
        eos = self.cfg.eos_token_id
        R, K, B = self.spec_rounds, self.spec_k, self.max_slots

        for i in active:                     # seed missing/invalidated drafts
            s = self.slots[i]
            if s.draft is None:
                ids = np.asarray(s.req.input_ids).copy()
                ids[ids < 0] = 0             # image sentinel -> pad
                ctx = np.concatenate([ids,
                                      np.asarray(s.generated[:-1], np.int32)])
                if ctx.size == 0 or \
                        ctx.size + s.budget + K + 2 >= self.cache_len:
                    return False             # no room for lookahead
                # pad to a pow2 bucket + device-scalar slot/length: a raw
                # ctx length or Python int would retrace the draft prefill /
                # cache-donating insert per request (see _insert_jit note)
                Cb = min(1 << max(3, (int(ctx.size) - 1).bit_length()),
                         int(self.d_cache["k"].shape[2]))
                ids_p = np.zeros((1, Cb), np.int32)
                ids_p[0, :ctx.size] = ctx
                k, v = self._draft_prefill(self.draft_params,
                                           jnp.asarray(ids_p, jnp.int32))
                self.d_cache = self._d_insert(
                    self.d_cache, k, v, jnp.asarray(i, jnp.int32),
                    jnp.asarray(int(ctx.size), jnp.int32))
                s.draft = {"len": int(ctx.size)}

        d_lens = np.zeros((B,), np.int32)
        budgets = np.zeros((B,), np.int32)
        mask = np.zeros((B,), np.int32)
        for i in active:
            s = self.slots[i]
            d_lens[i] = s.draft["len"]
            budgets[i] = s.budget
            mask[i] = 1
        meta = np.concatenate([d_lens, budgets, mask]).astype(np.int32)
        # sampled slots run the distribution-exact rejection scheme; greedy
        # slots in the same dispatch reduce to prefix matching (one-hot
        # warped rows). The sampling variant only compiles when asked.
        sknobs = np.zeros((2 * B,), np.float32)
        sknobs[B:] = 1.0
        use_sampling = False
        for i in active:
            sknobs[i] = self.slots[i].req.temperature
            sknobs[B + i] = self.slots[i].req.top_p
            use_sampling |= self.slots[i].req.temperature > 0.0
        self.rng, srng = self.jax.random.split(self.rng)
        # window bucket covering every target slot AND draft through all R rounds
        need = (max(max(int(self._host_len[i]), int(d_lens[i]))
                    for i in active) + R * (K + 1) + 2)
        window = min(self.cache_len, -(-need // 256) * 256)
        packed, self.cur_tokens, self.cache, self.d_cache = \
            self._spec_rounds(self.params, self.draft_params, self.cache,
                              self.d_cache, self.cur_tokens, meta, window,
                              srng, self.jnp.asarray(sknobs), use_sampling)
        packed = np.asarray(packed)          # ONE host pull for the dispatch
        lengths = packed[:B]
        accs = packed[B:B + R * B].reshape(R, B)
        toks = packed[B + R * B:].reshape(R, B, K + 1)
        for i in active:
            s = self.slots[i]
            self._host_len[i] = int(lengths[i])
            emit = []
            cut = False                  # eos/budget landed mid-round
            for r in range(R):
                acc = int(accs[r, i])
                if acc < 0:              # slot was dead for this round
                    break
                e_r = 0
                for t in toks[r, i, : acc + 1].tolist():
                    if t == eos:
                        s.budget = 0
                        break
                    emit.append(int(t))
                    s.budget -= 1
                    e_r += 1
                    if s.budget <= 0:
                        break
                s.draft["len"] += e_r
                if e_r < acc + 1:
                    cut = True
                if cut or s.budget <= 0:
                    break
            if cut:
                # budget/eos cut a round short: the slot retires now, so the
                # in-graph cache/draft advance past the cut is moot
                s.budget = 0
            if emit:
                s.generated.extend(emit)
                s.req.out_queue.put(emit)
                # cur_tokens[i] already advanced in-graph; on a cut the slot
                # retires below, so a stale in-graph value is moot
            if s.budget <= 0 or int(lengths[i]) >= self.cache_len - K - 2:
                self._retire(i)
        return True

    # ------------------------------------------------------------------
    def run_forever(self, idle_sleep: float = 0.005) -> None:
        import time
        while not self._stop.is_set():
            try:
                n = self.tick()
            except Exception:  # noqa: BLE001 — fail in-flight work, keep serving
                import traceback
                traceback.print_exc()
                if self._admission is not None:
                    self._admission["req"].out_queue.put(None)
                    self._admission = None
                n = 0
            if n == 0 and self.pending.empty():
                time.sleep(idle_sleep)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
