"""Greedy speculative decoding exactness: output must equal the TARGET model's
own greedy decode regardless of the draft model's quality."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.generate import generate, trim_at_eos
from slime_jax.models import slime
from slime_jax.serve.speculative import speculative_generate


@pytest.fixture(scope="module")
def models():
    cfg = SliMEConfig.tiny()
    target = slime.init(jax.random.PRNGKey(0), cfg)
    draft_good = target                       # identical model: accepts ~100%
    draft_bad = slime.init(jax.random.PRNGKey(42), cfg)  # unrelated model
    return cfg, target, draft_good, draft_bad


def _ref(cfg, params, ids, n):
    toks = generate(params, cfg, jnp.asarray(ids), jnp.ones_like(
        jnp.asarray(ids), bool), max_new_tokens=n, eos_id=cfg.eos_token_id)
    return trim_at_eos(np.asarray(toks), cfg.eos_token_id)[0]


@pytest.mark.parametrize("K", [2, 4])
def test_exactness_with_perfect_draft(models, K):
    cfg, target, draft, _ = models
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 7)).astype(np.int32)
    ref = _ref(cfg, target, ids, 12)
    got, rate = speculative_generate(target, cfg, draft, cfg, jnp.asarray(ids),
                                     K=K, max_new_tokens=12)
    got = trim_at_eos(got, cfg.eos_token_id)[0]
    assert got == ref, (got, ref)
    assert rate > 0.9  # identical draft: near-total acceptance


def test_exactness_with_bad_draft(models):
    """Even a random unrelated draft must yield the target's exact greedy
    output (only slower) — the core speculative-decoding invariant."""
    cfg, target, _, draft_bad = models
    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 6)).astype(np.int32)
    ref = _ref(cfg, target, ids, 10)
    got, rate = speculative_generate(target, cfg, draft_bad, cfg,
                                     jnp.asarray(ids), K=3, max_new_tokens=10)
    got = trim_at_eos(got, cfg.eos_token_id)[0]
    assert got == ref, (got, ref, rate)


def test_budget_respected(models):
    cfg, target, draft, _ = models
    rng = np.random.default_rng(2)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 5)).astype(np.int32)
    got, _ = speculative_generate(target, cfg, draft, cfg, jnp.asarray(ids),
                                  K=4, max_new_tokens=7)
    assert got.shape[1] <= 7


def test_full_acceptance_emits_bonus(models):
    """A perfect draft must yield K+1 tokens per verify round (K accepted +
    the bonus from the position after the full draft), so acceptance rate is
    1.0 and the whole 12-token budget takes ceil(12/(K+1)) rounds."""
    cfg, target, draft, _ = models
    rng = np.random.default_rng(3)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 7)).astype(np.int32)
    ref = _ref(cfg, target, ids, 12)
    got, rate = speculative_generate(target, cfg, draft, cfg, jnp.asarray(ids),
                                     K=3, max_new_tokens=12)
    got_t = trim_at_eos(got, cfg.eos_token_id)[0]
    assert got_t == ref
    if len(got_t) == 12:  # no early EOS: every round fully accepted
        assert rate == 1.0


def test_device_loop_matches_host_loop(models):
    """The on-device lax.while_loop variant must emit exactly what the
    host-driven loop (and thus the target's own greedy decode) emits."""
    from slime_jax.serve.speculative import speculative_generate_device
    cfg, target, _, draft_bad = models
    rng = np.random.default_rng(4)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 6)).astype(np.int32)
    ref = _ref(cfg, target, ids, 10)
    for K in (2, 3):
        got, rate = speculative_generate_device(
            target, cfg, draft_bad, cfg, jnp.asarray(ids), K=K,
            max_new_tokens=10)
        got_t = trim_at_eos(got, cfg.eos_token_id)[0]
        assert got_t == ref, (K, got_t, ref)


def test_device_loop_full_acceptance(models):
    from slime_jax.serve.speculative import speculative_generate_device
    cfg, target, draft, _ = models
    rng = np.random.default_rng(5)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 7)).astype(np.int32)
    ref = _ref(cfg, target, ids, 12)
    got, rate = speculative_generate_device(target, cfg, draft, cfg,
                                            jnp.asarray(ids), K=3,
                                            max_new_tokens=12)
    got_t = trim_at_eos(got, cfg.eos_token_id)[0]
    assert got_t == ref
    if len(got_t) == 12:
        assert rate == 1.0
    assert got.shape[1] <= 12
