"""Constrained decoding: regex/JSON-schema grammars as token-level DFAs.

The reference serves through SGLang, whose second hallmark (after the radix
cache) is structured generation — constraining decode steps so the output
matches a regex or JSON schema. SGLang interleaves Python automaton walks
with sampling, a host round trip per step; this design compiles the WHOLE
constraint to two dense device tables and keeps the automaton walk in-graph,
so multi-step decode dispatches need no host sync:

    allowed  bool  [n_states, V]   token t may be emitted from state s
    nxt      int32 [n_states, V]   state after emitting t from s
    accept   bool  [n_states]      EOS may be emitted from s

The pipeline is classic: a small regex engine (parse -> Thompson NFA ->
subset-construction DFA over BYTES), then each vocabulary token's byte
string is walked from every DFA state once at compile time. Decode-side the
engine just gathers a mask row and a next-state row per step — two [V]
lookups fused into the sampling graph (serve/batch_engine.py).

State 0 of every table bundle is reserved as the pass-through state
(everything allowed, self-loop, accepting): slots without a grammar walk it
for free, so one batched decode step serves constrained and unconstrained
slots together.

Supported regex subset: literals, ``.``, ``[...]``/``[^...]`` classes with
ranges, escapes ``\\d \\w \\s \\D \\W \\S`` and literal escapes, grouping
``(...)``, alternation ``|``, and quantifiers ``* + ? {m} {m,} {m,n}``.
Anchoring is implicit (the whole output must match, ``re.fullmatch``
semantics). ``json_schema_regex`` renders a flat JSON-schema object (the
structured-output subset that is regular: typed scalar fields, enums,
bounded arrays) to such a regex.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# regex -> NFA (Thompson construction over byte alphabet)
# ---------------------------------------------------------------------------

_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(list(range(ord("a"), ord("z") + 1))
                  + list(range(ord("A"), ord("Z") + 1))
                  + list(_DIGITS) + [ord("_")])
_SPACE = frozenset(map(ord, " \t\n\r\f\v"))
_ANY = frozenset(range(256))           # '.' matches any byte incl. newline
_ESCAPES = {"d": _DIGITS, "w": _WORD, "s": _SPACE,
            "D": _ANY - _DIGITS, "W": _ANY - _WORD, "S": _ANY - _SPACE}


class _NFA:
    """Fragment with one start state and one accept state. Transitions:
    eps[s] = set of states; edges[s] = list of (byteset, target)."""

    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[frozenset, int]]] = []

    def new_state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1


def _parse_class(pat: str, i: int) -> Tuple[frozenset, int]:
    """Parse a [...] class starting after the '['. Returns (byteset, next i)."""
    neg = False
    if i < len(pat) and pat[i] == "^":
        neg, i = True, i + 1
    out: Set[int] = set()
    first = True
    while i < len(pat) and (pat[i] != "]" or first):
        first = False
        if pat[i] == "\\" and i + 1 < len(pat):
            c = pat[i + 1]
            if c in _ESCAPES:
                out |= _ESCAPES[c]
                i += 2
                continue
            lo = ord({"n": "\n", "t": "\t", "r": "\r"}.get(c, c))
            i += 2
        else:
            lo = ord(pat[i])
            i += 1
        if i + 1 < len(pat) and pat[i] == "-" and pat[i + 1] != "]":
            hi = ord(pat[i + 1]) if pat[i + 1] != "\\" else ord(pat[i + 2])
            i += 2 if pat[i + 1] != "\\" else 3
            out |= set(range(lo, hi + 1))
        else:
            out.add(lo)
    if i >= len(pat):
        raise ValueError("unterminated character class")
    byteset = frozenset(out)
    return (frozenset(_ANY - byteset) if neg else byteset), i + 1


def _parse(pat: str):
    """Recursive-descent regex parser -> AST of
    ('lit', byteset) | ('cat', [..]) | ('alt', [..]) | ('rep', node, m, n)."""
    pos = [0]

    def peek():
        return pat[pos[0]] if pos[0] < len(pat) else None

    def eat():
        c = pat[pos[0]]
        pos[0] += 1
        return c

    def atom():
        c = eat()
        if c == "(":
            node = alternation()
            if peek() != ")":
                raise ValueError("unbalanced parenthesis")
            eat()
            return node
        if c == "[":
            bs, nxt = _parse_class(pat, pos[0])
            pos[0] = nxt
            return ("lit", bs)
        if c == ".":
            return ("lit", _ANY)
        if c == "\\":
            e = eat()
            if e in _ESCAPES:
                return ("lit", _ESCAPES[e])
            lit = {"n": "\n", "t": "\t", "r": "\r"}.get(e, e)
            return ("lit", frozenset(lit.encode()))
        if c in ")|*+?{":
            raise ValueError(f"unexpected {c!r} at {pos[0] - 1}")
        bs = c.encode()
        if len(bs) == 1:
            return ("lit", frozenset(bs))
        # UTF-8 multibyte literal: a SEQUENCE of its bytes
        return ("cat", [("lit", frozenset([b])) for b in bs])

    def quantified():
        node = atom()
        while True:
            c = peek()
            if c == "*":
                eat()
                node = ("rep", node, 0, None)
            elif c == "+":
                eat()
                node = ("rep", node, 1, None)
            elif c == "?":
                eat()
                node = ("rep", node, 0, 1)
            elif c == "{":
                eat()
                j = pat.index("}", pos[0])
                body = pat[pos[0]:j]
                pos[0] = j + 1
                if "," in body:
                    lo_s, hi_s = body.split(",", 1)
                    node = ("rep", node, int(lo_s),
                            int(hi_s) if hi_s else None)
                else:
                    node = ("rep", node, int(body), int(body))
            else:
                return node

    def concat():
        parts = []
        while peek() not in (None, "|", ")"):
            parts.append(quantified())
        if not parts:
            return ("cat", [])
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def alternation():
        parts = [concat()]
        while peek() == "|":
            eat()
            parts.append(concat())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    node = alternation()
    if pos[0] != len(pat):
        raise ValueError(f"trailing input at {pos[0]}")
    return node


def _build_nfa(node, nfa: _NFA) -> Tuple[int, int]:
    """AST -> (start, accept) states in ``nfa``."""
    kind = node[0]
    if kind == "lit":
        s, a = nfa.new_state(), nfa.new_state()
        if node[1]:
            nfa.edges[s].append((node[1], a))
        else:                       # empty byteset matches nothing
            pass
        return s, a
    if kind == "cat":
        if not node[1]:
            s = nfa.new_state()
            return s, s
        cur_s, cur_a = _build_nfa(node[1][0], nfa)
        for part in node[1][1:]:
            ns, na = _build_nfa(part, nfa)
            nfa.eps[cur_a].add(ns)
            cur_a = na
        return cur_s, cur_a
    if kind == "alt":
        s, a = nfa.new_state(), nfa.new_state()
        for part in node[1]:
            ps, pa = _build_nfa(part, nfa)
            nfa.eps[s].add(ps)
            nfa.eps[pa].add(a)
        return s, a
    if kind == "rep":
        _, inner, lo, hi = node
        s = nfa.new_state()
        cur = s
        for _ in range(lo):                       # mandatory copies
            ps, pa = _build_nfa(inner, nfa)
            nfa.eps[cur].add(ps)
            cur = pa
        if hi is None:                            # unbounded tail: one loop
            ps, pa = _build_nfa(inner, nfa)
            nfa.eps[cur].add(ps)
            nfa.eps[pa].add(cur)
            return s, cur
        a = nfa.new_state()
        nfa.eps[cur].add(a)
        for _ in range(hi - lo):                  # optional copies
            ps, pa = _build_nfa(inner, nfa)
            nfa.eps[cur].add(ps)
            cur = pa
            nfa.eps[cur].add(a)
        return s, a
    raise AssertionError(kind)


# ---------------------------------------------------------------------------
# NFA -> byte DFA (subset construction)
# ---------------------------------------------------------------------------

class ByteDFA:
    """trans int32 [n_states, 256] (-1 = dead), accept bool [n_states],
    start state 0."""

    def __init__(self, trans: np.ndarray, accept: np.ndarray):
        self.trans = trans
        self.accept = accept

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def matches(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = int(self.trans[s, b])
            if s < 0:
                return False
        return bool(self.accept[s])


def compile_regex(pattern: str) -> ByteDFA:
    nfa = _NFA()
    start, acc = _build_nfa(_parse(pattern), nfa)

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            for t in nfa.eps[stack.pop()]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    ids: Dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = np.full((256,), -1, np.int32)
        # group outgoing byte edges
        by_byte: Dict[int, Set[int]] = {}
        for s in cur:
            for byteset, tgt in nfa.edges[s]:
                for b in byteset:
                    by_byte.setdefault(b, set()).add(tgt)
        for b, tgts in by_byte.items():
            nxt = closure(frozenset(tgts))
            if nxt not in ids:
                ids[nxt] = len(order)
                order.append(nxt)
            row[b] = ids[nxt]
        rows.append(row)
        i += 1
    trans = np.stack(rows)
    accept = np.array([acc in st for st in order], bool)
    return ByteDFA(trans, accept)


# ---------------------------------------------------------------------------
# byte DFA -> token tables
# ---------------------------------------------------------------------------

class TokenDFA:
    """Per-token transition tables over a fixed vocabulary.

    allowed bool [n_states, V]; nxt int32 [n_states, V] (junk where not
    allowed); accept bool [n_states]. State 0 is the grammar's start."""

    def __init__(self, allowed: np.ndarray, nxt: np.ndarray,
                 accept: np.ndarray):
        self.allowed = allowed
        self.nxt = nxt
        self.accept = accept


def compile_token_dfa(pattern: str, vocab: Sequence[bytes],
                      eos_id: Optional[int] = None) -> TokenDFA:
    """Walk every token's bytes from every byte-DFA state once.

    A token is allowed from state s iff its whole byte string survives
    (never hits the dead state). ``eos_id`` (when inside the vocab range) is
    allowed exactly in accepting states — EOS *ends* the output, so the
    grammar must have matched. Vectorized over the vocab: one [V] state
    vector advanced byte-position by byte-position (tokens are short)."""
    dfa = compile_regex(pattern)
    S, V = dfa.n_states, len(vocab)
    maxlen = max((len(t) for t in vocab), default=1)
    # pad token bytes into [V, maxlen] with sentinel 256 = "ended"
    toks = np.full((V, maxlen), 256, np.int16)
    for i, t in enumerate(vocab):
        if t:
            toks[i, :len(t)] = np.frombuffer(t, np.uint8)
    # trans with an extra dead row so -1 indexes stay -1, and a pad column
    trans_pad = np.concatenate([dfa.trans, np.full((S, 1), 0, np.int32)], 1)
    allowed = np.zeros((S, V), bool)
    nxt = np.zeros((S, V), np.int32)
    for s in range(S):
        state = np.full((V,), s, np.int32)
        for j in range(maxlen):
            b = toks[:, j]
            live = (state >= 0) & (b < 256)
            idx = np.where(b == 256, 256, b).astype(np.int64)
            state = np.where(live, trans_pad[np.maximum(state, 0), idx],
                             state)
        ok = state >= 0
        # zero-length tokens (decode artifacts) are never allowed: emitting
        # one would loop forever without advancing the automaton
        ok &= toks[:, 0] != 256
        allowed[s] = ok
        nxt[s] = np.where(ok, state, 0)
    # token-level liveness pruning: byte-DFA liveness is not enough — a
    # token may walk into a state from which NO available token sequence
    # reaches accept (e.g. the vocab has "no" but no bare "o": emitting "n"
    # would wedge generation mid-word). Fixpoint: a state is productive iff
    # accepting or some allowed token leads to a productive state; prune
    # transitions into unproductive states.
    live = dfa.accept.copy()
    while True:
        new_live = live | (allowed & live[nxt]).any(axis=1)
        if (new_live == live).all():
            break
        live = new_live
    allowed &= live[nxt]
    if eos_id is not None and 0 <= eos_id < V:
        allowed[:, eos_id] = dfa.accept
        nxt[:, eos_id] = 0
    return TokenDFA(allowed, nxt, dfa.accept.copy())


def choices_regex(options: Sequence[str]) -> str:
    """A regex matching exactly one of ``options`` (escaped literals)."""
    def esc(s: str) -> str:
        return "".join("\\" + c if c in r"\.[](){}|*+?^-" else c for c in s)
    return "|".join(f"({esc(o)})" for o in options)


# ---------------------------------------------------------------------------
# flat JSON schema -> regex (the regular subset of structured output)
# ---------------------------------------------------------------------------

_WS = r"[ ]?"
_STRING = r'"([^"\\]|\\["\\nrt])*"'
_INT = r"-?(0|[1-9][0-9]{0,15})"
_NUMBER = _INT + r"(\.[0-9]{1,8})?([eE][+-]?[0-9]{1,3})?"
_BOOL = r"(true|false)"


def _field_regex(spec: dict) -> str:
    t = spec.get("type")
    if "enum" in spec:
        vals = []
        for v in spec["enum"]:
            if isinstance(v, str):
                vals.append('"' + "".join(
                    "\\" + c if c in r"\.[](){}|*+?^-" else c
                    for c in v) + '"')
            else:
                vals.append(str(v).lower() if isinstance(v, bool) else str(v))
        return "(" + "|".join(vals) + ")"
    if t == "string":
        return _STRING
    if t == "integer":
        return _INT
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return _BOOL
    if t == "null":
        return "null"
    if t == "array":
        item = _field_regex(spec.get("items", {"type": "string"}))
        lo = int(spec.get("minItems", 0))
        hi = int(spec.get("maxItems", 8))
        if lo == 0:
            inner = f"({item}(,{_WS}{item}){{0,{max(hi - 1, 0)}}})?"
        else:
            inner = f"{item}(,{_WS}{item}){{{lo - 1},{hi - 1}}}"
        return r"\[" + _WS + inner + _WS + r"\]"
    raise ValueError(f"unsupported schema type: {t!r}")


def json_object_regex(max_pairs: int = 16) -> str:
    """OpenAI ``response_format: json_object``: ANY flat JSON object —
    arbitrary string keys, scalar values (string/number/bool/null), up to
    ``max_pairs`` pairs. Nesting is not regular, so this is the honest
    regular approximation (schemas go through json_schema_regex)."""
    value = f"({_STRING}|{_NUMBER}|{_BOOL}|null)"
    pair = f"{_STRING}:{_WS}{value}"
    inner = f"({pair}(,{_WS}{pair}){{0,{max_pairs - 1}}})?"
    return r"\{" + _WS + inner + _WS + r"\}"


def json_schema_regex(schema: dict) -> str:
    """Flat object schema -> anchored regex for the serialized JSON.

    Keys render in ``properties`` order, all required (the deterministic
    subset — optional-field permutations explode the DFA). Nested objects
    are not supported (JSON nesting is not regular); arrays of scalars are,
    with a maxItems bound (default 8)."""
    if schema.get("type") != "object":
        return _field_regex(schema)
    parts = []
    for name, spec in schema.get("properties", {}).items():
        key = "".join("\\" + c if c in r"\.[](){}|*+?^-" else c for c in name)
        parts.append(f'"{key}":{_WS}{_field_regex(spec)}')
    body = ("," + _WS).join(parts)
    return r"\{" + _WS + body + _WS + r"\}"


def vocab_bytes_from_tokenizer(tokenizer, vocab_size: int) -> List[bytes]:
    """Best-effort token-id -> byte-string table via single-token decodes.

    Byte-fallback and special tokens may decode lossily (they become
    unmatchable — safe: the mask just never picks them)."""
    out = []
    for i in range(vocab_size):
        try:
            out.append(tokenizer.decode([i]).encode("utf-8"))
        except Exception:
            out.append(b"")
    return out
