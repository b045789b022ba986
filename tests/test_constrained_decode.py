"""Constrained decoding through the serving engine (grammar masks in-graph).

The structured-generation role of the reference's SGLang backend: outputs
must match a registered regex/JSON-schema exactly, greedy or sampled,
single or batched, without per-step host work."""
import re

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from slime_jax.config import SliMEConfig
from slime_jax.models import slime
from slime_jax.serve.batch_engine import BatchDecodeEngine, Request
from slime_jax.serve.grammar import (choices_regex, compile_token_dfa,
                                     json_schema_regex)


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def _vocab(cfg):
    """Synthetic byte-string vocab: id i -> printable token. Keeps ids
    decodable so emitted sequences can be re-rendered and regex-checked."""
    V = cfg.llm.vocab_size
    alphabet = [b"a", b"b", b"c", b"d", b"0", b"1", b"2", b".", b",",
                b" ", b"yes", b"no", b'"', b"{", b"}", b":", b"n", b"-"]
    vocab = [b"<pad>"] * V
    for i in range(V):
        vocab[i] = alphabet[i % len(alphabet)]
    vocab[cfg.eos_token_id] = b"</s>"
    return vocab


def _run(eng, req):
    eng.submit(req)
    for _ in range(120):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    out = []
    while True:
        got = req.out_queue.get(timeout=10)
        if got is None:
            return out
        out.extend(got)


def _render(vocab, toks):
    return b"".join(vocab[t] for t in toks)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_output_matches_regex(setup, temperature):
    cfg, params = setup
    vocab = _vocab(cfg)
    pat = r"(yes|no)(,[ ]?(yes|no)){2}"
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    gid = eng.register_grammar(compile_token_dfa(pat, vocab,
                                                 eos_id=cfg.eos_token_id))
    rng = np.random.default_rng(0)
    for trial in range(3):
        ids = rng.integers(5, cfg.llm.vocab_size, (10,)).astype(np.int32)
        got = _run(eng, Request(input_ids=ids, max_new_tokens=24,
                                temperature=temperature, grammar_id=gid))
        text = _render(vocab, got).decode("latin1")
        # either the grammar completed (full match before budget) or the
        # budget ran out while still on a live DFA path (valid prefix)
        if re.fullmatch(pat, text) is None:
            assert len(got) == 24, text
            dfa = compile_regex(pat)
            s = 0
            for b in text.encode():
                s = int(dfa.trans[s, b])
                assert s >= 0, text       # never left the language


def test_multi_step_dispatch_respects_grammar(setup):
    """k>1 decode windows (idle engine) thread the automaton through the
    fori_loop; the whole output must still match."""
    cfg, params = setup
    vocab = _vocab(cfg)
    pat = r"[ab]{8}"
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    gid = eng.register_grammar(compile_token_dfa(pat, vocab,
                                                 eos_id=cfg.eos_token_id))
    ids = np.arange(5, 15).astype(np.int32)
    got = _run(eng, Request(input_ids=ids, max_new_tokens=12,
                            temperature=0.7, grammar_id=gid))
    text = _render(vocab, got).decode()
    assert re.fullmatch(r"[ab]{8}", text), text   # DFA forces exactly 8 + EOS


def test_mixed_constrained_and_free_slots(setup):
    """A constrained slot and an unconstrained slot decode in the same
    batched step; the free slot's output is exactly the no-grammar output."""
    cfg, params = setup
    vocab = _vocab(cfg)
    rng = np.random.default_rng(3)
    ids_free = rng.integers(5, cfg.llm.vocab_size, (9,)).astype(np.int32)
    ids_con = rng.integers(5, cfg.llm.vocab_size, (9,)).astype(np.int32)

    ref_eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    ref = _run(ref_eng, Request(input_ids=ids_free, max_new_tokens=6))

    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    gid = eng.register_grammar(compile_token_dfa(
        r"[cd]{4}", vocab, eos_id=cfg.eos_token_id))
    r_free = Request(input_ids=ids_free, max_new_tokens=6)
    r_con = Request(input_ids=ids_con, max_new_tokens=10, grammar_id=gid)
    eng.submit(r_free)
    eng.submit(r_con)
    for _ in range(80):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    free_out, con_out = [], []
    for req, out in ((r_free, free_out), (r_con, con_out)):
        while True:
            got = req.out_queue.get(timeout=10)
            if got is None:
                break
            out.extend(got)
    assert free_out == ref
    assert re.fullmatch(r"[cd]{4}", _render(vocab, con_out).decode())


def test_choices_and_json_schema_roundtrip(setup):
    """choices(...) forces one of the options; json_schema output parses."""
    cfg, params = setup
    vocab = _vocab(cfg)
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    gid = eng.register_grammar(compile_token_dfa(
        choices_regex(["yes", "no"]), vocab, eos_id=cfg.eos_token_id))
    ids = np.arange(5, 12).astype(np.int32)
    got = _run(eng, Request(input_ids=ids, max_new_tokens=8, grammar_id=gid))
    assert _render(vocab, got) in (b"yes", b"no")

    import json
    schema = {"type": "object", "properties": {
        "a": {"enum": ["yes", "no"]}, "n": {"type": "integer"}}}
    gid2 = eng.register_grammar(compile_token_dfa(
        json_schema_regex(schema), vocab, eos_id=cfg.eos_token_id))
    got = _run(eng, Request(input_ids=ids, max_new_tokens=40,
                            grammar_id=gid2))
    obj = json.loads(_render(vocab, got).decode())
    assert obj["a"] in ("yes", "no") and isinstance(obj["n"], int)


def test_invalid_grammar_id_fails_request_not_engine(setup):
    cfg, params = setup
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    req = Request(input_ids=np.arange(5, 12).astype(np.int32),
                  max_new_tokens=4, grammar_id=7)
    eng.submit(req)
    for _ in range(10):
        eng.tick()
    assert req.out_queue.get(timeout=10) is None
    # engine still serves later requests
    ok = _run(eng, Request(input_ids=np.arange(5, 12).astype(np.int32),
                           max_new_tokens=3))
    assert len(ok) >= 1
