"""Logprobs through the engine and the OpenAI surface.

Correctness anchor: at greedy, each emitted token's logprob must equal the
teacher-forced log_softmax of the model at that position, and it must be
the max entry of its own top list."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from slime_jax.config import SliMEConfig
from slime_jax.models import llama, slime
from slime_jax.serve.batch_engine import BatchDecodeEngine, Request


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def _run(eng, req):
    eng.submit(req)
    for _ in range(60):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    out = []
    while True:
        got = req.out_queue.get(timeout=10)
        if got is None:
            return out
        out.extend(got)


def test_greedy_logprobs_match_teacher_forced(setup):
    cfg, params = setup
    rng = np.random.default_rng(0)
    S = 8
    ids = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96)
    req = Request(input_ids=ids, max_new_tokens=5, logprobs=3)
    got = _run(eng, req)
    assert len(req.logprob_entries) == len(got) >= 2

    full = np.concatenate([ids, np.asarray(got, np.int32)])
    embeds = llama.embed(params["llm"], jnp.asarray(full[None]))
    logits = np.asarray(llama.forward(params["llm"], embeds,
                                      cfg.llm)[0])[0].astype(np.float64)
    for j, (tok, e) in enumerate(zip(got, req.logprob_entries)):
        row = logits[S - 1 + j]
        lp = row - (np.log(np.sum(np.exp(row - row.max()))) + row.max())
        assert abs(e["logprob"] - lp[tok]) < 5e-3, (j, e["logprob"], lp[tok])
        # greedy: sampled token is the top-1 entry
        top_ids = [t for t, _ in e["top"]]
        assert top_ids[0] == tok
        assert len(e["top"]) == 3
        # top list values are descending and consistent with the row
        vals = [v for _, v in e["top"]]
        assert vals == sorted(vals, reverse=True)
        assert abs(vals[0] - lp[top_ids[0]]) < 5e-3


def test_multi_step_window_logprobs_count(setup):
    """k>1 idle dispatches carry per-token logprobs for the whole window."""
    cfg, params = setup
    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96)
    req = Request(input_ids=ids, max_new_tokens=12, logprobs=2)
    got = _run(eng, req)
    assert len(req.logprob_entries) == len(got) == 12


def test_logprobs_openai_surface(setup):
    import threading

    import requests as rq

    from slime_jax.serve.batched_worker import BatchedWorker, build_server
    from .toy_tokenizer import ToyTokenizer

    cfg, params = setup
    tok = ToyTokenizer()
    tok("hello world this is a longer seed sentence for vocab")
    worker = BatchedWorker(controller_addr=None, worker_addr="x",
                           model_name="t", params=params, cfg=cfg,
                           tokenizer=tok, max_slots=2, cache_len=96,
                           register=False)
    srv = build_server(worker, "localhost", 0, conv_mode="llava_v1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = {"messages": [{"role": "user", "content": "hello world"}],
                "max_tokens": 4, "temperature": 0,
                "logprobs": True, "top_logprobs": 2}
        got = rq.post(f"http://localhost:{srv.port}/v1/chat/completions",
                      json=body, timeout=120).json()
        lp = got["choices"][0]["logprobs"]
        assert lp is not None and len(lp["content"]) >= 1
        e = lp["content"][0]
        assert isinstance(e["token"], str) and e["logprob"] <= 0.0
        assert len(e["top_logprobs"]) == 2
        assert e["top_logprobs"][0]["logprob"] >= e["top_logprobs"][1]["logprob"]
    finally:
        worker.engine.stop()
        srv.shutdown()
