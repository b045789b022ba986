"""OpenAI-compatible /v1 endpoints on the batched worker (serve/openai_api.py).

Wire-format checks run against a live threaded server: chat completions
(JSON + SSE streaming), text completions, /v1/models, response_format
constrained output, usage accounting, message rendering through the
model's conversation template."""
import json

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from slime_jax.config import SliMEConfig
from slime_jax.conversation import conv_templates
from slime_jax.models import slime
from slime_jax.serve.openai_api import render_messages


@pytest.fixture(scope="module")
def server():
    import threading

    from slime_jax.serve.batched_worker import BatchedWorker, build_server
    from .toy_tokenizer import ToyTokenizer

    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    tok = ToyTokenizer()
    tok("hello world this is a longer seed sentence for vocab yes no")
    worker = BatchedWorker(controller_addr=None, worker_addr="x",
                           model_name="slime-tiny", params=params, cfg=cfg,
                           tokenizer=tok, max_slots=2, cache_len=128,
                           register=False)
    srv = build_server(worker, "localhost", 0, conv_mode="llava_v1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://localhost:{srv.port}", worker
    worker.engine.stop()
    srv.shutdown()


# ----------------------------------------------------------- render (pure)
def test_render_messages_template_and_images():
    conv = conv_templates["llava_v1"]
    msgs = [
        {"role": "system", "content": "Be terse."},
        {"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url",
             "image_url": {"url": "data:image/png;base64,QUJD"}},
        ]},
        {"role": "assistant", "content": "a cat"},
        {"role": "user", "content": "sure?"},
    ]
    prompt, images = render_messages(msgs, conv)
    assert prompt.startswith("Be terse.")
    assert "<image>\nwhat is this?" in prompt
    assert "USER" in prompt and "ASSISTANT" in prompt
    assert prompt.rstrip().endswith("ASSISTANT:")   # generation prompt open
    assert images == ["QUJD"]


def test_render_rejects_unknown_role():
    with pytest.raises(ValueError):
        render_messages([{"role": "tool", "content": "x"}],
                        conv_templates["llava_v1"])


# ------------------------------------------------------------ live server
def test_models_endpoint(server):
    import requests as rq
    url, _ = server
    got = rq.post(f"{url}/v1/models", json={}, timeout=30).json()
    assert got["object"] == "list"
    assert got["data"][0]["id"] == "slime-tiny"


def test_chat_completion_json(server):
    import requests as rq
    url, _ = server
    body = {"model": "slime-tiny",
            "messages": [{"role": "user",
                          "content": "hello world this is"}],
            "max_tokens": 6, "temperature": 0}
    got = rq.post(f"{url}/v1/chat/completions", json=body, timeout=120).json()
    assert got["object"] == "chat.completion"
    ch = got["choices"][0]
    assert ch["message"]["role"] == "assistant"
    assert isinstance(ch["message"]["content"], str)
    assert ch["finish_reason"] in ("stop", "length")
    u = got["usage"]
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert u["completion_tokens"] >= 1


def test_chat_completion_stream_sse(server):
    import requests as rq
    url, _ = server
    body = {"messages": [{"role": "user", "content": "hello world"}],
            "max_tokens": 5, "temperature": 0, "stream": True}
    r = rq.post(f"{url}/v1/chat/completions", json=body, stream=True,
                timeout=120)
    assert r.headers["Content-Type"].startswith("text/event-stream")
    frames, done = [], False
    for line in r.iter_lines():
        if not line:
            continue
        assert line.startswith(b"data: ")
        payload = line[len(b"data: "):]
        if payload == b"[DONE]":
            done = True
            break
        frames.append(json.loads(payload))
    assert done
    assert frames[0]["choices"][0]["delta"].get("role") == "assistant"
    text = "".join(f["choices"][0]["delta"].get("content", "")
                   for f in frames)
    assert len(text) > 0
    assert frames[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    # streamed text == non-streamed text at greedy
    body2 = dict(body)
    body2.pop("stream")
    got = rq.post(f"{url}/v1/chat/completions", json=body2,
                  timeout=120).json()
    assert got["choices"][0]["message"]["content"] == text


def test_text_completions(server):
    import requests as rq
    url, _ = server
    got = rq.post(f"{url}/v1/completions",
                  json={"prompt": "hello world this", "max_tokens": 4,
                        "temperature": 0}, timeout=120).json()
    assert got["object"] == "text_completion"
    assert isinstance(got["choices"][0]["text"], str)


def test_response_format_json_object(server):
    """response_format json_object wires into the constrained decoder; the
    toy vocab lacks JSON punctuation tokens, so the grammar's liveness
    pruning leaves no live path -> the output must be EMPTY (forced stop),
    never malformed JSON-ish text."""
    import requests as rq
    url, worker = server
    body = {"messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 20, "temperature": 0,
            "response_format": {"type": "json_object"}}
    got = rq.post(f"{url}/v1/chat/completions", json=body, timeout=120).json()
    assert got["choices"][0]["message"]["content"].strip() in ("", "{}", "{ }")
    assert len(worker.engine.grammars) >= 1   # grammar actually registered


def test_chat_n_choices_greedy_identical(server):
    """n>1 returns n indexed choices; at greedy all equal the n=1 result
    (each choice is its own engine request — batched decode + prefix-cache
    prefill reuse), and usage sums completion tokens across choices."""
    import requests as rq
    url, _ = server
    base = {"model": "slime-tiny",
            "messages": [{"role": "user", "content": "hello world this is"}],
            "max_tokens": 5, "temperature": 0}
    one = rq.post(f"{url}/v1/chat/completions", json=base, timeout=120).json()
    got = rq.post(f"{url}/v1/chat/completions", json={**base, "n": 3},
                  timeout=180).json()
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    ref = one["choices"][0]["message"]["content"]
    for c in got["choices"]:
        assert c["message"]["content"] == ref
        assert c["finish_reason"] in ("stop", "length")
    assert got["usage"]["completion_tokens"] \
        == 3 * one["usage"]["completion_tokens"]


def test_chat_n_choices_stream_interleaved(server):
    """Streaming n>1: chunks carry their choice index; per-index text equals
    the non-streamed choice text at greedy."""
    import requests as rq
    url, _ = server
    body = {"messages": [{"role": "user", "content": "hello world"}],
            "max_tokens": 4, "temperature": 0, "n": 2, "stream": True}
    r = rq.post(f"{url}/v1/chat/completions", json=body, stream=True,
                timeout=180)
    texts = {0: "", 1: ""}
    finish = {}
    for line in r.iter_lines():
        if not line or not line.startswith(b"data: "):
            continue
        payload = line[len(b"data: "):]
        if payload == b"[DONE]":
            break
        f = json.loads(payload)["choices"][0]
        texts[f["index"]] += (f["delta"].get("content") or "")
        if f["finish_reason"]:
            finish[f["index"]] = f["finish_reason"]
    assert set(finish) == {0, 1}
    body2 = {k: v for k, v in body.items() if k != "stream"}
    got = rq.post(f"{url}/v1/chat/completions", json=body2,
                  timeout=180).json()
    for c in got["choices"]:
        assert texts[c["index"]] == c["message"]["content"]


def test_completions_n_choices(server):
    import requests as rq
    url, _ = server
    got = rq.post(f"{url}/v1/completions",
                  json={"prompt": "hello world this", "max_tokens": 4,
                        "temperature": 0, "n": 2}, timeout=180).json()
    assert [c["index"] for c in got["choices"]] == [0, 1]
    assert got["choices"][0]["text"] == got["choices"][1]["text"]
