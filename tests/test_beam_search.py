"""Beam search vs a brute-force python oracle over the same model, plus the
beam=1 == greedy-generate identity."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.generate import beam_search, generate
from slime_jax.models import llama, slime


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def _oracle_beams(params, cfg, prompt, K, steps):
    """Exhaustive beam search by re-running the full forward on every candidate
    sequence (no cache) — slow but unambiguous."""
    def logprobs(seq):
        emb = llama.embed(params["llm"], jnp.asarray(np.asarray(seq)[None]))
        lg, _ = llama.forward(params["llm"], emb, cfg.llm)
        return np.asarray(jax.nn.log_softmax(lg.astype(jnp.float32)[0, -1]))

    beams = [(list(prompt), 0.0)]
    for _ in range(steps):
        cand = []
        for seq, sc in beams:
            lp = logprobs(seq)
            top = np.argsort(-lp)[: K + 1]
            for t in top:
                cand.append((seq + [int(t)], sc + float(lp[t])))
        cand.sort(key=lambda x: -x[1])
        beams = cand[:K]
    return beams


def test_beam_matches_oracle(setup):
    cfg, params = setup
    rng = np.random.default_rng(0)
    prompt = rng.integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32).tolist()
    K, steps = 3, 4
    got = beam_search(params, cfg, jnp.asarray(np.asarray(prompt)[None]),
                      jnp.ones((1, 6), bool), num_beams=K,
                      max_new_tokens=steps, eos_id=-1)[0].tolist()
    oracle = _oracle_beams(params, cfg, prompt, K, steps)
    assert got == oracle[0][0][len(prompt):], (got, oracle[0])


def test_beam1_equals_greedy(setup):
    cfg, params = setup
    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.llm.vocab_size, (2, 7)).astype(np.int32)
    ref = np.asarray(generate(params, cfg, jnp.asarray(ids),
                              jnp.ones((2, 7), bool), max_new_tokens=5,
                              eos_id=-1))
    got = beam_search(params, cfg, jnp.asarray(ids), jnp.ones((2, 7), bool),
                      num_beams=1, max_new_tokens=5, eos_id=-1)
    np.testing.assert_array_equal(got, ref)


def test_beam_score_at_least_greedy(setup):
    """The chosen beam's joint log-prob must be >= the greedy sequence's."""
    cfg, params = setup
    rng = np.random.default_rng(2)
    prompt = rng.integers(5, cfg.llm.vocab_size, (5,)).astype(np.int32).tolist()
    steps = 4

    def seq_logprob(toks):
        seq = prompt + list(map(int, toks))
        emb = llama.embed(params["llm"], jnp.asarray(np.asarray(seq)[None]))
        lg, _ = llama.forward(params["llm"], emb, cfg.llm)
        lp = np.asarray(jax.nn.log_softmax(lg.astype(jnp.float32)[0]))
        s = 0.0
        for i, t in enumerate(toks):
            s += lp[len(prompt) - 1 + i, int(t)]
        return s

    greedy = np.asarray(generate(params, cfg,
                                 jnp.asarray(np.asarray(prompt)[None]),
                                 jnp.ones((1, 5), bool), max_new_tokens=steps,
                                 eos_id=-1))[0]
    beam = beam_search(params, cfg, jnp.asarray(np.asarray(prompt)[None]),
                       jnp.ones((1, 5), bool), num_beams=4,
                       max_new_tokens=steps, eos_id=-1)[0]
    assert seq_logprob(beam) >= seq_logprob(greedy) - 1e-4
