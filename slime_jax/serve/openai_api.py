"""OpenAI-compatible API on top of the batched serving engine.

``/v1/chat/completions``, ``/v1/completions``, ``/v1/models`` — any OpenAI
SDK or curl script drives the SliME stack unchanged. The adapter renders
chat ``messages`` through the model's own conversation template
(conversation.py — the same byte-exact templates training used, reference
llava/conversation.py), maps OpenAI sampling fields onto the engine's
per-slot knobs, and translates ``response_format`` into the constrained-
decoding grammar tables (serve/grammar.py):

    {"type": "json_object"}                  -> generic flat-object regex
    {"type": "json_schema", "json_schema":
        {"schema": {...}}}                   -> schema-exact regex

Image content parts (``{"type": "image_url", "image_url": {"url":
"data:image/...;base64,..."}}``) become anyres-processed crops, same as the
reference's base64 wire format. Streaming uses real SSE (``data:`` frames +
``[DONE]``), the OpenAI wire format, via JsonHTTPServer.sse_route.

This is additive beyond the reference (which exposes only its own worker
protocol); it rides the worker's generate_stream path so every engine
feature — continuous batching, automatic prefix cache, speculative rounds,
quantized weights — applies to OpenAI traffic too.
"""
from __future__ import annotations

import time
import uuid
from typing import Iterable, List, Tuple

from ..constants import DEFAULT_IMAGE_TOKEN


def render_messages(messages: List[dict], conv) -> Tuple[str, List[str]]:
    """OpenAI ``messages`` -> (prompt string, base64 image payloads).

    ``conv`` is a fresh Conversation copy; a leading system message replaces
    its system prompt. Image parts inject the reference's ``<image>`` token
    ahead of the text of their message (llava/serve/gradio_web_server.py
    convention)."""
    conv = conv.copy()
    images: List[str] = []
    role_map = {"user": conv.roles[0], "assistant": conv.roles[1]}
    msgs = list(messages)
    if msgs and msgs[0].get("role") == "system":
        content = msgs.pop(0).get("content") or ""
        if not isinstance(content, str):   # content-part form
            content = " ".join(p.get("text", "") for p in content
                               if p.get("type") == "text")
        conv.system = content
    for m in msgs:
        role = role_map.get(m.get("role"))
        if role is None:
            raise ValueError(f"unsupported role {m.get('role')!r}")
        content = m.get("content")
        if isinstance(content, str):
            text = content
        else:
            parts, n_img = [], 0
            for part in content or []:
                if part.get("type") == "text":
                    parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    if not url.startswith("data:"):
                        raise ValueError(
                            "only data: image URLs are supported offline")
                    images.append(url.split(",", 1)[1])
                    n_img += 1
                else:
                    raise ValueError(f"unsupported part {part.get('type')!r}")
            text = "\n".join([DEFAULT_IMAGE_TOKEN] * n_img
                             + ["".join(parts)])
        conv.append_message(role, text)
    conv.append_message(conv.roles[1], None)   # generation prompt
    return conv.get_prompt(), images


def _worker_payload(body: dict, prompt: str, images: List[str]) -> dict:
    """OpenAI request fields -> worker generate_stream payload."""
    p = {"prompt": prompt, "images": images,
         "max_new_tokens": int(body.get("max_tokens")
                               or body.get("max_completion_tokens") or 256),
         # OpenAI defaults sample at temperature 1; explicit 0 is greedy
         "temperature": float(body.get("temperature", 1.0)),
         "top_p": float(body.get("top_p", 1.0)),
         "presence_penalty": float(body.get("presence_penalty", 0.0)),
         "frequency_penalty": float(body.get("frequency_penalty", 0.0))}
    # common extensions (vLLM/SGLang accept these too)
    for k in ("top_k", "min_p", "repetition_penalty", "prefix_id", "adapter"):
        if k in body:
            p[k] = body[k]
    if body.get("logprobs"):
        p["logprobs"] = max(1, int(body.get("top_logprobs") or 1))
    stop = body.get("stop")
    if isinstance(stop, list):
        stop = stop[0] if stop else None   # engine matcher takes one string
    if stop:
        p["stop"] = stop
    rf = body.get("response_format") or {}
    if rf.get("type") == "json_object":
        from .grammar import json_object_regex
        p["regex"] = json_object_regex()
    elif rf.get("type") == "json_schema":
        p["json_schema"] = (rf.get("json_schema") or {}).get("schema") \
            or rf.get("schema") or {}
    elif body.get("regex"):
        p["regex"] = body["regex"]
    elif body.get("choices_constraint"):
        p["choices"] = body["choices_constraint"]
    return p


def attach_openai_routes(srv, worker, conv_mode: str = None) -> None:
    """Register /v1/* on a JsonHTTPServer serving ``worker``."""
    from ..conversation import conv_mode_from_model_name, conv_templates
    mode = conv_mode or conv_mode_from_model_name(worker.model_name)
    template = conv_templates[mode]
    model_id = worker.model_name

    def models(_body: dict) -> dict:
        return {"object": "list",
                "data": [{"id": model_id, "object": "model",
                          "owned_by": "slime_jax"}]}

    def _drive(body: dict, prompt: str, images: List[str]):
        """-> iterator of (delta_text, full_text, n_tokens, chunk)."""
        payload = _worker_payload(body, prompt, images)
        prev = ""
        for chunk in worker.generate_stream(payload):
            if chunk.get("error_code"):
                raise RuntimeError(chunk.get("text", "generation error"))
            text = chunk["text"]
            yield text[len(prev):], text, int(chunk.get("n_tokens", 0)), chunk
            prev = text

    def _n_choices(body: dict) -> int:
        return max(1, min(int(body.get("n") or 1), 8))

    def _drive_many(body: dict, prompt: str, images: List[str], n: int):
        """n engine requests concurrently -> (choice_idx, delta, text,
        n_tokens, chunk) events. Each choice is its own engine request, so
        the continuous-batching engine decodes all n in one batched step and
        choices 2..n prefill through the automatic prefix cache (their prompt
        IS the cached prefix). A consumer that stops early (client
        disconnect) sets the stop flag; each thread then falls out of its
        worker stream, whose cancellation path frees the engine slot."""
        import queue as queue_mod
        import threading

        out: "queue_mod.Queue" = queue_mod.Queue()
        stop = threading.Event()

        def run(i: int) -> None:
            try:
                for delta, text, ntok, chunk in _drive(body, prompt, images):
                    out.put(("tok", i, delta, text, ntok, chunk))
                    if stop.is_set():
                        break          # exits the worker generator -> cancel
            except BaseException as e:  # noqa: BLE001 — reraised on the consumer
                out.put(("err", i, e, None, None, None))
            finally:
                out.put(("end", i, None, None, None, None))

        for i in range(n):
            threading.Thread(target=run, args=(i,), daemon=True).start()
        live = n
        try:
            while live:
                kind, i, a, b, c, d = out.get()
                if kind == "end":
                    live -= 1
                elif kind == "err":
                    raise a
                else:
                    yield i, a, b, c, d
        finally:
            stop.set()

    def _openai_logprobs(chunk: dict):
        """Worker logprob entries -> the OpenAI chat logprobs block."""
        if not chunk.get("logprobs"):
            return None
        dec = lambda t: worker.tokenizer.decode([t])
        return {"content": [
            {"token": dec(e["token_id"]), "logprob": e["logprob"],
             "top_logprobs": [{"token": dec(t), "logprob": v}
                              for t, v in e["top"]]}
            for e in chunk["logprobs"]]}

    def _finish(body: dict, n_tokens: int) -> str:
        limit = int(body.get("max_tokens")
                    or body.get("max_completion_tokens") or 256)
        return "length" if n_tokens >= limit else "stop"

    def _count(prompt: str) -> int:
        out = worker.tokenizer(prompt)
        ids = out["input_ids"] if isinstance(out, dict) else out.input_ids
        return len(ids)

    def chat(body: dict) -> dict:
        prompt, images = render_messages(body.get("messages") or [], template)
        nc = _n_choices(body)
        texts, toks, lasts = [""] * nc, [0] * nc, [{}] * nc
        if nc == 1:
            for _delta, texts[0], toks[0], lasts[0] in _drive(body, prompt,
                                                              images):
                pass
        else:
            for i, _d, text, ntok, chunk in _drive_many(body, prompt, images,
                                                        nc):
                texts[i], toks[i], lasts[i] = text, ntok, chunk
        n_prompt = _count(prompt)
        return {
            "id": "chatcmpl-" + uuid.uuid4().hex[:16],
            "object": "chat.completion",
            "created": int(time.time()),
            "model": model_id,
            "choices": [{"index": i,
                         "message": {"role": "assistant", "content": texts[i]},
                         "logprobs": _openai_logprobs(lasts[i]),
                         "finish_reason": _finish(body, toks[i])}
                        for i in range(nc)],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": sum(toks),
                      "total_tokens": n_prompt + sum(toks)},
        }

    def chat_stream(body: dict) -> Iterable[dict]:
        prompt, images = render_messages(body.get("messages") or [], template)
        cid = "chatcmpl-" + uuid.uuid4().hex[:16]
        created = int(time.time())

        def frame(delta: dict, finish=None, idx: int = 0) -> dict:
            return {"id": cid, "object": "chat.completion.chunk",
                    "created": created, "model": model_id,
                    "choices": [{"index": idx, "delta": delta,
                                 "finish_reason": finish}]}

        nc = _n_choices(body)
        for i in range(nc):
            yield frame({"role": "assistant", "content": ""}, idx=i)
        toks = [0] * nc
        if nc == 1:
            for delta, _text, toks[0], _c in _drive(body, prompt, images):
                if delta:
                    yield frame({"content": delta})
        else:
            # choice chunks interleave; each carries its choice index
            # (the OpenAI wire format for n > 1)
            for i, delta, _text, ntok, _c in _drive_many(body, prompt,
                                                         images, nc):
                toks[i] = ntok
                if delta:
                    yield frame({"content": delta}, idx=i)
        for i in range(nc):
            yield frame({}, finish=_finish(body, toks[i]), idx=i)

    def completions(body: dict) -> dict:
        prompt = body.get("prompt") or ""
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        nc = _n_choices(body)
        texts, toks = [""] * nc, [0] * nc
        if nc == 1:
            for _d, texts[0], toks[0], _c in _drive(body, prompt, []):
                pass
        else:
            for i, _d, text, ntok, _c in _drive_many(body, prompt, [], nc):
                texts[i], toks[i] = text, ntok
        n_prompt = _count(prompt)
        return {
            "id": "cmpl-" + uuid.uuid4().hex[:16],
            "object": "text_completion",
            "created": int(time.time()),
            "model": model_id,
            "choices": [{"index": i, "text": texts[i],
                         "finish_reason": _finish(body, toks[i])}
                        for i in range(nc)],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": sum(toks),
                      "total_tokens": n_prompt + sum(toks)},
        }

    def completions_stream(body: dict) -> Iterable[dict]:
        prompt = body.get("prompt") or ""
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        cid = "cmpl-" + uuid.uuid4().hex[:16]
        created = int(time.time())

        def frame(text: str, finish=None, idx: int = 0) -> dict:
            return {"id": cid, "object": "text_completion",
                    "created": created, "model": model_id,
                    "choices": [{"index": idx, "text": text,
                                 "finish_reason": finish}]}

        nc = _n_choices(body)
        toks = [0] * nc
        if nc == 1:
            for delta, _text, toks[0], _c in _drive(body, prompt, []):
                if delta:
                    yield frame(delta)
        else:
            for i, delta, _text, ntok, _c in _drive_many(body, prompt, [],
                                                         nc):
                toks[i] = ntok
                if delta:
                    yield frame(delta, idx=i)
        for i in range(nc):
            yield frame("", finish=_finish(body, toks[i]), idx=i)

    # a path registered both ways streams iff the body posts stream=true
    # (JsonHTTPServer dispatch rule)
    srv.route("/v1/models", models)
    srv.route("/v1/chat/completions", chat)
    srv.sse_route("/v1/chat/completions", chat_stream)
    srv.route("/v1/completions", completions)
    srv.sse_route("/v1/completions", completions_stream)
