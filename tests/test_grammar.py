"""Grammar compiler (serve/grammar.py): regex -> byte DFA -> token tables.

The DFA is fuzzed for language equivalence against Python's ``re`` on
random byte strings — the regex engine and the constraint tables both stand
or fall on this."""
import json
import re

import numpy as np
import pytest

from slime_jax.serve.grammar import (ByteDFA, choices_regex, compile_regex,
                                     compile_token_dfa, json_schema_regex)

PATTERNS = [
    r"abc",
    r"a*b+c?",
    r"(ab|cd)*ef",
    r"[a-c]{2,4}",
    r"[^x]y",
    r"\d+\.\d{2}",
    r"(foo|ba[rz]) (qux)?",
    r"yes|no|maybe",
    r"a{3}",
    r"x{2,}",
    r"[\w]+@[a-z]+\.(com|org)",
]


@pytest.mark.parametrize("pat", PATTERNS)
def test_dfa_equals_re_fullmatch(pat):
    dfa = compile_regex(pat)
    rx = re.compile(pat)
    rng = np.random.default_rng(hash(pat) % 2**32)
    alphabet = b"abcdefxyz.@ 0123456789_"
    checked = 0
    for _ in range(4000):
        n = int(rng.integers(0, 10))
        s = bytes(rng.choice(list(alphabet), n).tolist())
        want = rx.fullmatch(s.decode("latin1")) is not None
        assert dfa.matches(s) == want, (pat, s)
        checked += 1
    # and on strings built FROM the language (positive coverage)
    for probe in ("abc", "aabbc", "abef", "cdef", "yes", "no", "aaa",
                  "12.50", "foo ", "bar qux", "a@b.com"):
        want = rx.fullmatch(probe) is not None
        assert dfa.matches(probe.encode()) == want, (pat, probe)


def test_utf8_literal_is_byte_sequence():
    dfa = compile_regex("é+")
    assert dfa.matches("é".encode()) and dfa.matches("éé".encode())
    assert not dfa.matches("é".encode()[:1])      # half a codepoint


def test_token_tables_basic():
    # vocab of explicit byte strings; eos at id 0
    vocab = [b"</s>", b"a", b"b", b"ab", b"ba", b"c", b""]
    tdfa = compile_token_dfa(r"(ab)+c", vocab, eos_id=0)
    s0 = 0
    # from the start: only tokens that begin a valid prefix
    assert tdfa.allowed[s0].tolist() == [False, True, False, True, False,
                                         False, False]
    # walking a then b then c reaches accept, where ONLY eos (and a -> next
    # repetition) are allowed
    s = tdfa.nxt[s0, 1]              # 'a'
    assert tdfa.allowed[s, 2]        # 'b' allowed
    s = tdfa.nxt[s, 2]
    assert tdfa.allowed[s, 5]        # 'c'
    s_acc = tdfa.nxt[s, 5]
    assert tdfa.accept[s_acc] and tdfa.allowed[s_acc, 0]
    # multi-byte token 'ab' crosses two DFA steps in one emission
    s = tdfa.nxt[s0, 3]
    assert tdfa.allowed[s, 5]        # then 'c'
    # zero-length vocab entries are never allowed
    assert not tdfa.allowed[:, 6].any()


def test_token_tables_emit_only_matching_strings():
    """Greedy walk over random allowed tokens always yields fullmatch."""
    rng = np.random.default_rng(0)
    vocab = [b"</s>"] + [bytes([c]) for c in b"abcdef0123456789."] + \
        [b"ab", b"12", b"3.", b"cd"]
    pat = r"[a-f]+[0-9]{2}\.[0-9]"
    tdfa = compile_token_dfa(pat, vocab, eos_id=0)
    rx = re.compile(pat)
    for trial in range(200):
        s, out = 0, b""
        for _ in range(30):
            ok = np.flatnonzero(tdfa.allowed[s])
            assert ok.size > 0, (s, out)     # never stuck
            t = int(rng.choice(ok))
            if t == 0:
                assert tdfa.accept[s]
                break
            out += vocab[t]
            s = int(tdfa.nxt[s, t])
        else:
            continue                          # hit step cap; skip the check
        assert rx.fullmatch(out.decode("latin1")), out


def test_choices_regex():
    pat = choices_regex(["yes", "no", "N/A (see docs)"])
    dfa = compile_regex(pat)
    assert dfa.matches(b"yes") and dfa.matches(b"N/A (see docs)")
    assert not dfa.matches(b"yess") and not dfa.matches(b"")


def test_json_schema_regex_accepts_serialized_instances():
    schema = {"type": "object", "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "score": {"type": "number"},
        "active": {"type": "boolean"},
        "tag": {"enum": ["a", "b"]},
        "nums": {"type": "array", "items": {"type": "integer"},
                 "maxItems": 3},
    }}
    pat = json_schema_regex(schema)
    dfa = compile_regex(pat)
    good = {"name": "bo\\b", "age": 41, "score": 2.5, "active": True,
            "tag": "b", "nums": [1, 2]}
    s = json.dumps(good, separators=(",", ":"))
    assert dfa.matches(s.encode()), s
    # json.dumps with spaces after ':' and ',' also matches (_WS)
    s2 = json.dumps(good, separators=(", ", ": "))
    assert dfa.matches(s2.encode()), s2
    # violations
    assert not dfa.matches(b'{"name":"x"}')                    # missing keys
    bad = dict(good)
    bad["age"] = "x"
    assert not dfa.matches(json.dumps(bad,
                                      separators=(",", ":")).encode())
    bad = dict(good)
    bad["nums"] = [1, 2, 3, 4]                                 # > maxItems
    assert not dfa.matches(json.dumps(bad,
                                      separators=(",", ":")).encode())


def test_empty_and_anchored_semantics():
    dfa = compile_regex(r"a?")
    assert dfa.matches(b"") and dfa.matches(b"a") and not dfa.matches(b"aa")
    # implicit anchoring: 'bc' inside a longer string does not match
    dfa = compile_regex(r"bc")
    assert not dfa.matches(b"abc") and not dfa.matches(b"bcd")
