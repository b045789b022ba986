"""Mamba block: parallel associative scan vs sequential recurrence oracle;
causality; shape/grad sanity."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.models import mamba


def _sequential_scan(u, delta, A, B, C, D):
    Bsz, S, Cdim = u.shape
    N = A.shape[1]
    h = np.zeros((Bsz, Cdim, N))
    out = np.zeros_like(np.asarray(u))
    for t in range(S):
        dA = np.exp(np.einsum("bc,cn->bcn", np.asarray(delta)[:, t], np.asarray(A)))
        dBu = np.einsum("bc,bn,bc->bcn", np.asarray(delta)[:, t],
                        np.asarray(B)[:, t], np.asarray(u)[:, t])
        h = dA * h + dBu
        out[:, t] = np.einsum("bcn,bn->bc", h, np.asarray(C)[:, t])
    return out + np.asarray(u) * np.asarray(D)[None, None]


def test_selective_scan_matches_sequential(rng):
    B, S, C, N = 2, 12, 8, 4
    u = jnp.asarray(rng.standard_normal((B, S, C)).astype(np.float32))
    delta = jax.nn.softplus(jnp.asarray(rng.standard_normal((B, S, C)).astype(np.float32)))
    A = -jnp.exp(jnp.asarray(rng.standard_normal((C, N)).astype(np.float32)))
    Bm = jnp.asarray(rng.standard_normal((B, S, N)).astype(np.float32))
    Cm = jnp.asarray(rng.standard_normal((B, S, N)).astype(np.float32))
    D = jnp.ones((C,))
    ours = mamba.selective_scan(u, delta, A, Bm, Cm, D)
    ref = _sequential_scan(u, delta, A, Bm, Cm, D)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_block_causality(rng):
    p = mamba.init(jax.random.PRNGKey(0), d_model=16)
    x = jnp.asarray(rng.standard_normal((1, 10, 16)).astype(np.float32))
    y1 = mamba.apply(p, x)
    x2 = x.at[0, 7].set(99.0)  # perturb a late position
    y2 = mamba.apply(p, x2)
    np.testing.assert_allclose(np.asarray(y1)[0, :7], np.asarray(y2)[0, :7], atol=1e-5)
    assert not np.allclose(np.asarray(y1)[0, 7:], np.asarray(y2)[0, 7:])


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_block_grads(rng):
    p = mamba.init(jax.random.PRNGKey(1), d_model=16)
    x = jnp.asarray(rng.standard_normal((2, 8, 16)).astype(np.float32))
    g = jax.grad(lambda p: jnp.sum(mamba.apply(p, x) ** 2))(p)
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree_util.tree_leaves(g))
