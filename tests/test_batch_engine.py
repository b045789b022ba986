"""Continuous-batching engine: outputs match single-request greedy generation;
slots retire and get reused; multimodal requests mix with text requests."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.constants import IMAGE_TOKEN_INDEX
from slime_jax.generate import generate
from slime_jax.models import slime
from slime_jax.serve.batch_engine import BatchDecodeEngine, Request


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    eng = BatchDecodeEngine(params, cfg, max_slots=4, cache_len=128)
    return cfg, params, eng


def _drain(req):
    toks = []
    for chunk in req.stream():
        toks.extend(chunk)
    return toks


def test_batched_matches_single(setup):
    cfg, params, eng = setup
    rng = np.random.default_rng(0)
    reqs = []
    refs = []
    for i in range(3):
        S = 5 + i * 2
        ids = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
        reqs.append(Request(input_ids=ids, max_new_tokens=6))
        ref = generate(params, cfg, jnp.asarray(ids[None]),
                       jnp.ones((1, S), bool), max_new_tokens=6, eos_id=-1)
        refs.append(np.asarray(ref)[0].tolist())
    for r in reqs:
        eng.submit(r)
    # drive ticks synchronously
    for _ in range(30):
        if eng.tick() == 0 and eng.pending.empty():
            break
    for r, ref in zip(reqs, refs):
        got = _drain(r)
        # engine stops at eos; compare the prefix it generated
        assert got == ref[:len(got)] and len(got) >= 1
        # greedy: must match exactly unless eos hit
        if cfg.eos_token_id not in ref[:6]:
            assert got == ref


def test_top_p_tiny_equals_greedy(setup):
    """top_p -> 0 collapses the nucleus to the single highest-prob token
    (sample_token's exclusive-cum rule always keeps the cutoff token), so
    temperature sampling with a tiny top_p must emit exactly the greedy
    sequence — first token (host-sampled at admission) included."""
    cfg, params, _ = setup
    rng = np.random.default_rng(9)
    ids = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)

    def run(**kw):
        eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128,
                                seed=5)
        req = eng.submit(Request(input_ids=ids, max_new_tokens=7, **kw))
        for _ in range(40):
            if eng.tick() == 0 and eng.pending.empty():
                break
        return _drain(req)

    greedy = run()
    nucleus = run(temperature=0.8, top_p=1e-9)
    assert nucleus == greedy and len(greedy) >= 1


def test_top_p_sampling_stays_in_nucleus(setup):
    """With a moderate top_p every emitted token must lie inside the nucleus
    of ITS step's distribution — checked against teacher-forced reference
    logits for the emitted prefix."""
    cfg, params, _ = setup
    from slime_jax.models import llama

    rng = np.random.default_rng(10)
    ids = rng.integers(5, cfg.llm.vocab_size, (5,)).astype(np.int32)
    top_p = 0.8
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128, seed=3)
    req = eng.submit(Request(input_ids=ids, max_new_tokens=6,
                             temperature=1.0, top_p=top_p))
    for _ in range(40):
        if eng.tick() == 0 and eng.pending.empty():
            break
    got = _drain(req)
    assert len(got) >= 2

    # teacher-forced logits over [prompt + generated]
    full = np.concatenate([ids, np.asarray(got, np.int32)])
    embeds = llama.embed(params["llm"], jnp.asarray(full[None]))
    logits = np.asarray(llama.forward(params["llm"], embeds, cfg.llm)[0])[0]
    for j, tok in enumerate(got):
        row = logits[len(ids) - 1 + j].astype(np.float64)
        order = np.argsort(row)[::-1]
        p = np.exp(row[order] - row[order][0])
        p /= p.sum()
        keep = (np.cumsum(p) - p) < top_p
        nucleus = set(order[keep].tolist())
        assert tok in nucleus, (j, tok)


def test_metrics_summary(setup):
    """Completed requests feed TTFT/throughput metrics on the status path."""
    cfg, params, _ = setup
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96)
    assert eng.metrics_summary() == {"completed": 0}
    rng = np.random.default_rng(21)
    for _ in range(2):
        req = Request(input_ids=rng.integers(
            5, cfg.llm.vocab_size, (6,)).astype(np.int32), max_new_tokens=4)
        eng.submit(req)
        for _ in range(30):
            if eng.tick() == 0 and eng.pending.empty():
                break
        _drain(req)
    m = eng.metrics_summary()
    assert m["completed"] == 2 and m["tokens"] >= 2
    assert m["ttft_p50_s"] >= 0 and m["decode_tok_s_per_req"] > 0


def test_slot_reuse(setup):
    cfg, params, eng = setup
    rng = np.random.default_rng(1)
    # 6 requests through 4 slots
    reqs = [Request(input_ids=rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32),
                    max_new_tokens=3) for _ in range(6)]
    for r in reqs:
        eng.submit(r)
    for _ in range(60):
        if eng.tick() == 0 and eng.pending.empty():
            break
    for r in reqs:
        assert len(_drain(r)) >= 1


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_multimodal_request(setup):
    cfg, params, eng = setup
    rng = np.random.default_rng(2)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (8,)).astype(np.int32)
    ids[2] = IMAGE_TOKEN_INDEX
    pix = rng.standard_normal((MC, 3, t, t)).astype(np.float32)
    cmask = np.ones((MC,), bool)
    req = Request(input_ids=ids, pixel_values=pix, crop_mask=cmask,
                  max_new_tokens=4)
    eng.submit(req)
    for _ in range(20):
        if eng.tick() == 0 and eng.pending.empty():
            break
    assert len(_drain(req)) >= 1


def test_batched_worker_http(setup):
    """BatchedWorker speaks the worker protocol over real HTTP."""
    import threading
    import requests as rq

    from slime_jax.serve.batched_worker import BatchedWorker, build_server
    from slime_jax.serve.protocol import iter_stream_response
    from .toy_tokenizer import ToyTokenizer

    cfg, params, _ = setup
    tok = ToyTokenizer()
    tok("hello world this is a longer seed sentence for vocab")
    worker = BatchedWorker(controller_addr=None, worker_addr="x",
                           model_name="slime-tiny-batched", params=params,
                           cfg=cfg, tokenizer=tok, max_slots=2, cache_len=96,
                           register=False)
    srv = build_server(worker, "localhost", 0)
    port = srv.port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        rs = []
        for i in range(3):
            rs.append(rq.post(f"http://localhost:{port}/worker_generate_stream",
                              json={"prompt": f"hello world this is {i}",
                                    "max_new_tokens": 4}, stream=True, timeout=120))
        for r in rs:
            chunks = list(iter_stream_response(r))
            assert chunks and chunks[-1]["error_code"] == 0
    finally:
        worker.engine.stop()
        srv.shutdown()


def test_chunked_admission_matches_single(setup):
    """A long prompt admitted in chunks decodes identically to generate()."""
    cfg, params, _ = setup
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96)
    eng.prefill_chunk_len = 8
    rng = np.random.default_rng(7)
    S = 21  # not a multiple of the chunk (exercises the padded tail)
    ids = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
    ref = generate(params, cfg, jnp.asarray(ids[None]), jnp.ones((1, S), bool),
                   max_new_tokens=5, eos_id=-1)
    ref = np.asarray(ref)[0].tolist()

    req = Request(input_ids=ids, max_new_tokens=5)
    eng.submit(req)
    for _ in range(40):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    got = _drain(req)
    assert got == ref[:len(got)] and len(got) >= 1
    if cfg.eos_token_id not in ref:
        assert got == ref


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_prefix_sharing_matches_full_prompt(setup):
    """register_prefix + suffix-only admission produces exactly the tokens of
    submitting the concatenated prompt (greedy), for suffixes shorter and longer
    than the chunk length."""
    cfg, params, eng = setup
    rng = np.random.default_rng(7)
    prefix = rng.integers(5, cfg.llm.vocab_size, (9,)).astype(np.int32)
    pid = eng.register_prefix(prefix)
    eng.prefill_chunk_len = 8  # force multi-chunk suffix admission

    for S in (4, 20):  # below and above the chunk length
        suffix = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
        full = np.concatenate([prefix, suffix])
        ref = generate(params, cfg, jnp.asarray(full[None]),
                       jnp.ones((1, len(full)), bool), max_new_tokens=6,
                       eos_id=-1)
        ref = np.asarray(ref)[0].tolist()

        req = Request(input_ids=suffix, max_new_tokens=6, prefix_id=pid)
        eng.submit(req)
        for _ in range(40):
            if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
                break
        got = _drain(req)
        assert got == ref[:len(got)] and len(got) >= 1
        if cfg.eos_token_id not in ref[:6]:
            assert got == ref, (S, got, ref)
    eng.prefill_chunk_len = 256


def test_prefix_and_plain_requests_interleave(setup):
    """A prefix request and a plain request admitted together both match their
    single-request references."""
    cfg, params, eng = setup
    rng = np.random.default_rng(8)
    prefix = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)
    pid = eng.register_prefix(prefix)
    sfx = rng.integers(5, cfg.llm.vocab_size, (5,)).astype(np.int32)
    plain = rng.integers(5, cfg.llm.vocab_size, (7,)).astype(np.int32)

    ref_p = np.asarray(generate(
        params, cfg, jnp.asarray(np.concatenate([prefix, sfx])[None]),
        jnp.ones((1, 11), bool), max_new_tokens=5, eos_id=-1))[0].tolist()
    ref_q = np.asarray(generate(
        params, cfg, jnp.asarray(plain[None]), jnp.ones((1, 7), bool),
        max_new_tokens=5, eos_id=-1))[0].tolist()

    r1 = Request(input_ids=sfx, max_new_tokens=5, prefix_id=pid)
    r2 = Request(input_ids=plain, max_new_tokens=5)
    eng.submit(r1); eng.submit(r2)
    for _ in range(40):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    g1, g2 = _drain(r1), _drain(r2)
    assert g1 == ref_p[:len(g1)] and g2 == ref_q[:len(g2)]


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_prefix_with_multimodal_suffix(setup):
    """Shared text prefix + image-bearing suffix matches submitting the full
    multimodal prompt (greedy token identity)."""
    cfg, params, eng = setup
    rng = np.random.default_rng(9)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    prefix = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)
    pid = eng.register_prefix(prefix)

    sfx = rng.integers(5, cfg.llm.vocab_size, (8,)).astype(np.int32)
    sfx[2] = IMAGE_TOKEN_INDEX
    pix = rng.standard_normal((MC, 3, t, t)).astype(np.float32)
    cmask = np.ones((MC,), bool)

    full_ids = np.concatenate([prefix, sfx])
    ref = np.asarray(generate(
        params, cfg, jnp.asarray(full_ids[None]),
        jnp.ones((1, len(full_ids)), bool), jnp.asarray(pix[None]),
        jnp.asarray(cmask[None]), max_new_tokens=4, eos_id=-1))[0].tolist()

    req = Request(input_ids=sfx, pixel_values=pix, crop_mask=cmask,
                  max_new_tokens=4, prefix_id=pid)
    eng.submit(req)
    for _ in range(40):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    got = _drain(req)
    assert got == ref[:len(got)] and len(got) >= 1
    if cfg.eos_token_id not in ref[:4]:
        assert got == ref, (got, ref)


@pytest.mark.slow
def test_prefix_http_route(setup):
    """/worker_register_prefix + prefix_id generation over live HTTP matches the
    full-prompt request; unknown prefix_id returns a clean error chunk."""
    import threading
    import requests as rq

    from slime_jax.serve.batched_worker import BatchedWorker, build_server
    from slime_jax.serve.protocol import iter_stream_response
    from .toy_tokenizer import ToyTokenizer

    cfg, params, _ = setup
    tok = ToyTokenizer()
    tok("you are a helpful assistant . hello world what is the answer")
    worker = BatchedWorker(controller_addr=None, worker_addr="x",
                           model_name="t", params=params, cfg=cfg,
                           tokenizer=tok, max_slots=2, cache_len=96,
                           register=False)
    srv = build_server(worker, "localhost", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://localhost:{srv.port}"
    try:
        PRE, SUF = "you are a helpful assistant .", " hello world what is the answer"
        full = list(iter_stream_response(rq.post(
            base + "/worker_generate_stream",
            json={"prompt": PRE + SUF, "max_new_tokens": 5},
            stream=True, timeout=300)))[-1]
        reg = rq.post(base + "/worker_register_prefix",
                      json={"prompt": PRE}, timeout=300).json()
        assert reg["length"] > 0
        pref = list(iter_stream_response(rq.post(
            base + "/worker_generate_stream",
            json={"prompt": SUF, "prefix_id": reg["prefix_id"],
                  "max_new_tokens": 5}, stream=True, timeout=300)))[-1]
        assert pref["error_code"] == 0 and pref["text"] == full["text"]
        err = list(iter_stream_response(rq.post(
            base + "/worker_generate_stream",
            json={"prompt": SUF, "prefix_id": "nope", "max_new_tokens": 2},
            stream=True, timeout=300)))[-1]
        assert err["error_code"] != 0 and "prefix_id" in err["text"]
    finally:
        worker.engine.stop()
        srv.shutdown()


# ---------------------------------------------------------------------------
# Speculative draft hook (VERDICT r2 #4): in the bs=1 greedy idle regime the
# engine runs draft-K/verify rounds instead of plain multi-steps. Exactness is
# the contract: for ANY draft — even an unrelated random model — the emitted
# tokens equal the engine's own greedy output; the draft only changes how many
# target dispatches they take.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spec_setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    dcfg = SliMEConfig.tiny()          # same vocab; unrelated weights
    dparams = slime.init(jax.random.PRNGKey(7), dcfg)
    return cfg, params, dcfg, dparams


def _run_engine(eng, ids, n):
    req = eng.submit(Request(input_ids=ids, max_new_tokens=n))
    for _ in range(80):
        if eng.tick() == 0 and eng.pending.empty():
            break
    return _drain(req)


@pytest.mark.parametrize("seed", [0, 3])
def test_spec_engine_exact_vs_plain(spec_setup, seed):
    cfg, params, dcfg, dparams = spec_setup
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.llm.vocab_size, (7,)).astype(np.int32)

    plain = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    spec = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128,
                             draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    got_plain = _run_engine(plain, ids, 10)
    got_spec = _run_engine(spec, ids, 10)
    assert got_spec == got_plain
    assert len(got_spec) >= 1


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_spec_engine_multimodal_draft_is_text_only(spec_setup):
    """Multimodal request through the speculating engine: the text-only draft
    sees pad in place of the image sentinel; output still exactly matches the
    plain engine's greedy tokens."""
    cfg, params, dcfg, dparams = spec_setup
    rng = np.random.default_rng(2)
    S = 6
    ids = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
    ids[1] = IMAGE_TOKEN_INDEX
    MC = 1 + cfg.max_local_crops
    t = cfg.vision.image_size
    pix = rng.standard_normal((MC, 3, t, t)).astype(np.float32)
    cmask = np.ones((MC,), bool)

    def run(engine):
        req = engine.submit(Request(input_ids=ids, pixel_values=pix,
                                    crop_mask=cmask, max_new_tokens=8))
        for _ in range(80):
            if engine.tick() == 0 and engine.pending.empty():
                break
        return _drain(req)

    plain = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    spec = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128,
                             draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    assert run(spec) == run(plain)


def test_spec_engine_batched_multi_slot(spec_setup):
    """Two concurrent greedy requests: batched speculation drafts/verifies
    BOTH slots in one dispatch; results still match the plain engine
    exactly (per-slot acceptance/rollback is independent)."""
    cfg, params, dcfg, dparams = spec_setup
    rng = np.random.default_rng(4)
    ids1 = rng.integers(5, cfg.llm.vocab_size, (5,)).astype(np.int32)
    ids2 = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)

    def run(engine):
        r1 = engine.submit(Request(input_ids=ids1, max_new_tokens=6))
        r2 = engine.submit(Request(input_ids=ids2, max_new_tokens=6))
        for _ in range(80):
            if engine.tick() == 0 and engine.pending.empty():
                break
        return _drain(r1), _drain(r2)

    plain = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    spec = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128,
                             draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    assert run(spec) == run(plain)


def test_spec_engine_staggered_admission(spec_setup):
    """A slot speculates alone, a second request joins mid-stream (plain
    steps interleave and invalidate the first slot's draft), then batched
    speculation resumes over both; outputs stay exactly the plain engine's.
    Budgets differ so one slot retires rounds before the other."""
    cfg, params, dcfg, dparams = spec_setup
    rng = np.random.default_rng(11)
    ids1 = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)
    ids2 = rng.integers(5, cfg.llm.vocab_size, (4,)).astype(np.int32)

    def run(engine):
        r1 = engine.submit(Request(input_ids=ids1, max_new_tokens=14))
        engine.tick()          # admit + first spec/plain progress
        engine.tick()
        r2 = engine.submit(Request(input_ids=ids2, max_new_tokens=5))
        for _ in range(100):
            if engine.tick() == 0 and engine.pending.empty():
                break
        return _drain(r1), _drain(r2)

    plain = BatchDecodeEngine(params, cfg, max_slots=3, cache_len=128)
    spec = BatchDecodeEngine(params, cfg, max_slots=3, cache_len=128,
                             draft_params=dparams, draft_cfg=dcfg,
                             spec_k=3, spec_rounds=4)
    assert run(spec) == run(plain)


def test_batched_worker_with_draft_http(spec_setup):
    """--draft-model-path plumbing: a BatchedWorker with a draft serves over
    HTTP and its greedy output matches the draftless worker's."""
    import threading
    import requests as rq

    from slime_jax.serve.batched_worker import BatchedWorker, build_server
    from slime_jax.serve.protocol import iter_stream_response
    from .toy_tokenizer import ToyTokenizer

    cfg, params, dcfg, dparams = spec_setup

    def run(draft):
        tok = ToyTokenizer()
        tok("hello world this is a longer seed sentence for vocab")
        worker = BatchedWorker(
            controller_addr=None, worker_addr="x", model_name="m",
            params=params, cfg=cfg, tokenizer=tok, max_slots=2, cache_len=96,
            register=False,
            draft_params=dparams if draft else None,
            draft_cfg=dcfg if draft else None, spec_k=3)
        srv = build_server(worker, "localhost", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            r = rq.post(f"http://localhost:{srv.port}/worker_generate_stream",
                        json={"prompt": "hello world this is",
                              "max_new_tokens": 6, "temperature": 0.0},
                        stream=True, timeout=300)
            chunks = list(iter_stream_response(r))
            assert chunks and chunks[-1]["error_code"] == 0
            return chunks[-1]["text"]
        finally:
            worker.engine.stop()
            srv.shutdown()

    assert run(draft=True) == run(draft=False)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_window_bucketing_exact():
    """Decode windows smaller than the cache pool (tick picks a 256-bucket
    covering max active length) must not change tokens: short prompts in a
    1024-cache engine read only cache[:, :256] per step."""
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    eng = BatchDecodeEngine(params, cfg, max_slots=4, cache_len=1024)
    rng = np.random.default_rng(7)
    reqs, refs = [], []
    for i in range(3):
        S = 6 + i
        ids = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
        reqs.append(Request(input_ids=ids, max_new_tokens=5))
        ref = generate(params, cfg, jnp.asarray(ids[None]),
                       jnp.ones((1, S), bool), max_new_tokens=5, eos_id=-1)
        refs.append(np.asarray(ref)[0].tolist())
    for r in reqs:
        eng.submit(r)
    for _ in range(40):
        if eng.tick() == 0 and eng.pending.empty():
            break
    # the bucket chosen for these lengths must be well under the pool size
    assert int(max(eng._host_len)) < 256 <= eng.cache_len
    for r, ref in zip(reqs, refs):
        got = _drain(r)
        assert got == ref[:len(got)] and len(got) >= 1


def test_spec_engine_windowed_exact(spec_setup):
    """Speculative rounds with a window bucket strictly smaller than the
    cache pool (cache_len=1024, short prompt -> 256 bucket) stay exact."""
    cfg, params, dcfg, dparams = spec_setup
    rng = np.random.default_rng(11)
    ids = rng.integers(5, cfg.llm.vocab_size, (7,)).astype(np.int32)
    plain = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=1024)
    spec = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=1024,
                             draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    got_plain = _run_engine(plain, ids, 10)
    got_spec = _run_engine(spec, ids, 10)
    assert got_spec == got_plain and len(got_spec) >= 1
    assert int(max(spec._host_len)) + spec.spec_rounds * 4 + 2 < 1024


def test_cancel_active_slot_frees_capacity(setup):
    """engine.cancel on a decoding request retires its slot at the next tick
    (the vLLM/SGLang abort role) — the stream ends and capacity frees."""
    cfg, params, eng = setup
    rng = np.random.default_rng(11)
    long_req = Request(input_ids=rng.integers(
        5, cfg.llm.vocab_size, (6,)).astype(np.int32), max_new_tokens=64)
    eng.submit(long_req)
    for _ in range(3):                       # admit + decode a few tokens
        eng.tick()
    assert any(s is not None and s.req is long_req for s in eng.slots)
    eng.cancel(long_req.request_id)
    eng.tick()
    assert not any(s is not None and s.req is long_req for s in eng.slots)
    assert long_req.cancelled
    got = _drain(long_req)                   # stream terminated (None sentinel)
    assert len(got) < 64
    # the engine still serves: a fresh request completes normally
    nxt = Request(input_ids=rng.integers(
        5, cfg.llm.vocab_size, (5,)).astype(np.int32), max_new_tokens=3)
    eng.submit(nxt)
    for _ in range(30):
        if eng.tick() == 0 and eng.pending.empty():
            break
    assert len(_drain(nxt)) >= 1 and not nxt.cancelled


def test_cancel_pending_request_never_admits(setup):
    cfg, params, eng = setup
    rng = np.random.default_rng(12)
    # fill every slot with long requests, then queue one more
    fill = [Request(input_ids=rng.integers(
        5, cfg.llm.vocab_size, (6,)).astype(np.int32), max_new_tokens=32)
        for _ in range(eng.max_slots)]
    queued = Request(input_ids=rng.integers(
        5, cfg.llm.vocab_size, (6,)).astype(np.int32), max_new_tokens=32)
    for r in fill:
        eng.submit(r)
    eng.submit(queued)
    for _ in range(6):
        eng.tick()
    eng.cancel(queued.request_id)
    for r in fill:                           # drain the rest
        eng.cancel(r.request_id)
    for _ in range(10):
        if eng.tick() == 0 and eng.pending.empty():
            break
    assert queued.cancelled and _drain(queued) == []


def test_worker_generator_close_cancels_engine_request(setup):
    """Closing the worker's stream generator mid-flight (what the HTTP layer
    does on client disconnect, serve/protocol.py) cancels the engine request."""
    import time

    from slime_jax.serve.batched_worker import BatchedWorker
    from .toy_tokenizer import ToyTokenizer

    cfg, params, _ = setup
    tok = ToyTokenizer()
    tok("hello world this is a longer seed sentence for vocab")
    worker = BatchedWorker(controller_addr=None, worker_addr="x",
                           model_name="slime-tiny-cancel", params=params,
                           cfg=cfg, tokenizer=tok, max_slots=2, cache_len=96,
                           register=False)
    eng = worker.engine
    try:
        gen = worker.generate_stream({"prompt": "hello world this is long",
                                      "max_new_tokens": 64})
        first = next(gen)                    # at least one chunk streamed
        assert first.get("error_code") == 0, first
        gen.close()                          # client disconnected
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if all(s is None for s in eng.slots) and eng.pending.empty():
                break
            time.sleep(0.02)
        assert all(s is None for s in eng.slots), "cancel must free the slot"
    finally:
        eng.stop()


def test_controller_proxy_disconnect_cancels_worker_request(setup):
    """Client disconnect at the CONTROLLER propagates: the proxy closes its
    upstream connection, the worker's HTTP layer closes the stream generator,
    and the engine request cancels (controller.py worker_api_generate_stream
    finally-close; the reference proxy at controller.py:193-215 has no
    cancellation anywhere downstream)."""
    import json
    import socket
    import threading
    import time

    from slime_jax.serve.batched_worker import BatchedWorker, build_server
    from slime_jax.serve.controller import Controller
    from slime_jax.serve.controller import build_server as build_controller
    from .toy_tokenizer import ToyTokenizer

    cfg, params, _ = setup
    tok = ToyTokenizer()
    tok("hello world this is a longer seed sentence for vocab")
    ctrl = Controller("shortest_queue")
    csrv = build_controller(ctrl, "localhost", 0)
    threading.Thread(target=csrv.serve_forever, daemon=True).start()
    worker = BatchedWorker(controller_addr=f"http://localhost:{csrv.port}",
                           worker_addr="pending", model_name="slime-tiny-prx",
                           params=params, cfg=cfg, tokenizer=tok, max_slots=2,
                           cache_len=96, register=False)
    wsrv = build_server(worker, "localhost", 0)
    worker.worker_addr = f"http://localhost:{wsrv.port}"
    threading.Thread(target=wsrv.serve_forever, daemon=True).start()
    worker.register_to_controller()
    try:
        body = json.dumps({"model": "slime-tiny-prx",
                           "prompt": "hello world this is long",
                           "max_new_tokens": 64}).encode()
        s = socket.create_connection(("localhost", csrv.port))
        s.sendall(b"POST /worker_generate_stream HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: " + str(len(body)).encode()
                  + b"\r\n\r\n" + body)
        data = b""
        while b"\x00" not in data:           # first proxied chunk arrived
            data += s.recv(4096)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
        s.close()                            # RST mid-stream
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if all(sl is None for sl in worker.engine.slots) \
                    and worker.engine.pending.empty():
                break
            time.sleep(0.05)
        assert all(sl is None for sl in worker.engine.slots), \
            "disconnect at the controller must cancel the worker request"
    finally:
        worker.engine.stop()
        wsrv.shutdown()
        csrv.shutdown()

def test_overlapped_decode_exact():
    """The idle-regime overlapped tick (one dispatch kept in flight, previous
    dispatch's tokens emitted while the next runs) must not change tokens or
    drop/duplicate emits across flush points. Budget 40 >> multi_step=8 so
    several dispatches overlap, the tail hits the non-overlap branch
    (budget - k_prev <= k), and retirement flushes in-flight state. A second
    request arriving mid-stream exercises the flush-before-admission path."""
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    S = 7
    ids1 = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
    ids2 = rng.integers(5, cfg.llm.vocab_size, (S + 2,)).astype(np.int32)
    ref1 = np.asarray(generate(params, cfg, jnp.asarray(ids1[None]),
                               jnp.ones((1, S), bool), max_new_tokens=40,
                               eos_id=-1))[0].tolist()
    ref2 = np.asarray(generate(params, cfg, jnp.asarray(ids2[None]),
                               jnp.ones((1, S + 2), bool), max_new_tokens=24,
                               eos_id=-1))[0].tolist()

    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=256)
    r1 = eng.submit(Request(input_ids=ids1, max_new_tokens=40))
    # let r1 enter the overlapped idle regime before r2 shows up
    for _ in range(4):
        eng.tick()
    assert eng._inflight is not None, "overlap did not engage"
    r2 = eng.submit(Request(input_ids=ids2, max_new_tokens=24))
    for _ in range(120):
        if eng.tick() == 0 and eng.pending.empty():
            break
    assert eng._inflight is None
    got1, got2 = _drain(r1), _drain(r2)
    assert got1 == ref1 and len(got1) == 40
    assert got2 == ref2 and len(got2) == 24


def test_no_per_slot_or_per_length_retrace():
    """Slot index / length / block offset reach the shared cache-helper jits
    as device scalars, and whole-admission prefill pads to pow2 buckets — a
    Python int scalar or raw length is a compile-time constant, which
    re-compiled the cache-donating insert graph per slot and per prompt
    length (measured on chip: serving TTFT p95 of 1160 s while slots 2-7
    each compiled mid-request)."""
    import jax
    import numpy as np

    from slime_jax.config import SliMEConfig
    from slime_jax.models import slime
    from slime_jax.serve import batch_engine as be
    from slime_jax.serve.batch_engine import BatchDecodeEngine, Request

    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    eng = BatchDecodeEngine(params, cfg, max_slots=4, cache_len=128,
                            prefix_cache_mb=0)

    def drain(reqs):
        for r in reqs:
            while True:
                eng.tick()
                if r.out_queue.get() is None:
                    break

    def submit(length):
        r = Request(input_ids=np.arange(5, 5 + length, dtype=np.int32),
                    max_new_tokens=2)
        eng.submit(r)
        return r

    drain([submit(12)])               # compile the 16-bucket insert once
    before = be._HELPER_JITS["insert"]._cache_size()
    # same bucket, submitted CONCURRENTLY so they occupy four different slots
    drain([submit(length) for length in (12, 11, 10, 9)])
    after = be._HELPER_JITS["insert"]._cache_size()
    assert after == before, (before, after)
