"""Rejection-sampled speculation core (serve/speculative.rejection_round).

The contract is DISTRIBUTION exactness: the composite (draft proposes from
q, target accept/resample against p) must produce tokens distributed
exactly as direct sampling from p, regardless of how bad q is. Checked by
Monte Carlo total-variation distance, plus the greedy-limit reduction to
longest-matching-prefix."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from slime_jax.serve.speculative import rejection_round, warp_probs


def _tv(counts, p):
    emp = counts / counts.sum()
    return 0.5 * np.abs(emp - p).sum()


@pytest.mark.parametrize("qshape", ["close", "far", "uniform"])
def test_first_token_distribution_exact(qshape):
    """Marginal of the FIRST emitted token == p_0, for good and bad drafts."""
    V, K, N = 16, 3, 60_000
    rng = np.random.default_rng(hash(qshape) % 2**32)
    logits_p = rng.standard_normal((V,)).astype(np.float32) * 1.5
    p = np.exp(logits_p - logits_p.max())
    p /= p.sum()
    if qshape == "close":
        q = p * np.exp(rng.standard_normal(V) * 0.2)
    elif qshape == "far":
        q = np.exp(rng.standard_normal(V).astype(np.float32))
    else:
        q = np.ones(V)
    q = (q / q.sum()).astype(np.float32)

    B = 500
    rounds = N // B
    key = jax.random.PRNGKey(0)
    counts = np.zeros(V)
    p_rows = jnp.broadcast_to(jnp.asarray(p), (B, K + 1, V))
    q_rows = jnp.broadcast_to(jnp.asarray(q), (B, K, V))

    @jax.jit
    def one(key):
        kp, kr = jax.random.split(key)
        props = jax.random.categorical(
            kp, jnp.log(q_rows + 1e-30), axis=-1).astype(jnp.int32)
        toks, acc = rejection_round(kr, props, q_rows, p_rows)
        return toks[:, 0]       # first emitted token (always emitted)

    for i in range(rounds):
        key, sub = jax.random.split(key)
        first = np.asarray(one(sub))
        np.add.at(counts, first, 1)
    tv = _tv(counts, p)
    assert tv < 0.02, (qshape, tv)


def test_acceptance_rate_scales_with_draft_quality():
    """A draft equal to p accepts ~always; a disjoint draft ~never."""
    V, K, B = 16, 4, 2048
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(V)).astype(np.float32)
    p_rows = jnp.broadcast_to(jnp.asarray(p), (B, K + 1, V))
    key = jax.random.PRNGKey(1)

    def run(q):
        q_rows = jnp.broadcast_to(jnp.asarray(q), (B, K, V))
        kp, kr = jax.random.split(key)
        props = jax.random.categorical(
            kp, jnp.log(q_rows + 1e-30), axis=-1).astype(jnp.int32)
        _, acc = rejection_round(kr, props, q_rows, p_rows)
        return float(np.mean(np.asarray(acc)))

    assert run(p) > K * 0.95
    bad = np.zeros(V, np.float32)
    bad[np.argsort(p)[:4]] = 0.25       # mass on p's least-likely tokens
    assert run(bad) < 1.5


def test_greedy_rows_reduce_to_prefix_matching():
    """One-hot p and q (the greedy limit): acc = longest matching prefix and
    the correction token is the target argmax — the greedy spec rule."""
    V, K, B = 8, 3, 4
    props = jnp.asarray([[1, 2, 3], [1, 9 % V, 3], [4, 4, 4], [0, 0, 0]],
                        jnp.int32)
    tgt = np.array([[1, 2, 3, 5], [1, 2, 3, 5], [4, 4, 0, 6], [7, 1, 2, 3]])
    q_rows = np.zeros((B, K, V), np.float32)
    p_rows = np.zeros((B, K + 1, V), np.float32)
    for b in range(B):
        for i in range(K):
            q_rows[b, i, int(props[b, i])] = 1.0
        for i in range(K + 1):
            p_rows[b, i, tgt[b, i]] = 1.0
    toks, acc = rejection_round(jax.random.PRNGKey(0), props,
                                jnp.asarray(q_rows), jnp.asarray(p_rows))
    toks, acc = np.asarray(toks), np.asarray(acc)
    assert acc.tolist() == [3, 1, 2, 0]
    for b in range(B):
        a = acc[b]
        assert toks[b, :a].tolist() == list(map(int, props[b, :a]))
        assert toks[b, a] == tgt[b, a]


def test_warp_probs_matches_sampler_semantics():
    rng = np.random.default_rng(2)
    logits = jnp.asarray(rng.standard_normal((3, 12)).astype(np.float32) * 2)
    temps = jnp.asarray([0.0, 1.0, 0.7])
    tps = jnp.asarray([1.0, 0.6, 1.0])
    probs = np.asarray(warp_probs(logits, temps, tps))
    # greedy row: one-hot argmax
    assert probs[0].argmax() == np.asarray(logits)[0].argmax()
    assert abs(probs[0].max() - 1.0) < 1e-6
    # nucleus row: support = exclusive-cum rule at 0.6
    x = np.asarray(logits)[1]
    order = np.argsort(x)[::-1]
    sp = np.exp(np.sort(x)[::-1] - x.max())
    sp /= sp.sum()
    keep_n = int(np.sum(np.cumsum(sp) - sp < 0.6))
    support = set(order[:keep_n].tolist())
    assert set(np.flatnonzero(probs[1] > 0).tolist()) == support
    # temperature row: full support, sums to 1
    assert abs(probs[2].sum() - 1.0) < 1e-5 and (probs[2] > 0).all()


# --------------------------------------------------------------- engine level
from slime_jax.config import SliMEConfig
from slime_jax.models import llama, slime
from slime_jax.serve.batch_engine import BatchDecodeEngine, Request


@pytest.fixture(scope="module")
def spec_setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    dcfg = SliMEConfig.tiny()
    dparams = slime.init(jax.random.PRNGKey(7), dcfg)
    return cfg, params, dcfg, dparams


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


def test_sampled_spec_tokens_stay_in_nucleus(spec_setup):
    """Sampled requests run speculative rounds (not the plain path), and
    every emitted token lies in the teacher-forced nucleus of the TARGET's
    warped distribution at its step — the distribution-exactness smoke at
    engine level."""
    cfg, params, dcfg, dparams = spec_setup
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)
    top_p = 0.8
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128,
                            draft_params=dparams, draft_cfg=dcfg, spec_k=3,
                            seed=5)
    spy = []
    orig = eng._spec_rounds
    eng._spec_rounds = lambda *a, **k: (spy.append(1), orig(*a, **k))[1]
    req = Request(input_ids=ids, max_new_tokens=8, temperature=1.0,
                  top_p=top_p)
    got = _run(eng, req)
    assert spy, "sampled request should take the speculative path"
    assert len(got) >= 2

    full = np.concatenate([ids, np.asarray(got, np.int32)])
    embeds = llama.embed(params["llm"], jnp.asarray(full[None]))
    logits = np.asarray(llama.forward(params["llm"], embeds,
                                      cfg.llm)[0])[0].astype(np.float64)
    for j, tok in enumerate(got):
        row = logits[len(ids) - 1 + j]
        order = np.argsort(row)[::-1]
        p = np.exp(row[order] - row[order][0])
        p /= p.sum()
        keep = (np.cumsum(p) - p) < top_p
        assert tok in set(order[keep].tolist()), (j, tok)


def test_mixed_greedy_and_sampled_spec_batch(spec_setup):
    """A greedy slot batched WITH a sampled slot through the sampling spec
    variant still emits exactly the plain engine's greedy tokens (one-hot
    rows reduce to prefix matching)."""
    cfg, params, dcfg, dparams = spec_setup
    rng = np.random.default_rng(1)
    ids_g = rng.integers(5, cfg.llm.vocab_size, (7,)).astype(np.int32)
    ids_s = rng.integers(5, cfg.llm.vocab_size, (7,)).astype(np.int32)

    plain = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128)
    ref = _run(plain, Request(input_ids=ids_g, max_new_tokens=8))

    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128,
                            draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    rg = Request(input_ids=ids_g, max_new_tokens=8)
    rs = Request(input_ids=ids_s, max_new_tokens=8, temperature=0.9)
    eng.submit(rg)
    eng.submit(rs)
    for _ in range(120):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    out_g = []
    while True:
        got = rg.out_queue.get(timeout=10)
        if got is None:
            break
        out_g.extend(got)
    assert out_g == ref
    out_s = []
    while True:
        got = rs.out_queue.get(timeout=10)
        if got is None:
            break
        out_s.extend(got)
    assert len(out_s) >= 1
