"""Chunked cross entropy (ops/loss.py): exactness vs the dense log_softmax
loss, gradient parity through the rematerialized scan, pad/shift semantics —
the loss the pp/composed train steps actually run (VERDICT r2 #2)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.constants import IGNORE_INDEX
from slime_jax.ops.loss import (DEFAULT_LOSS_CHUNK, chunked_ce_mean,
                                chunked_cross_entropy)


def _dense_ref(x, w, labels):
    """The pre-r3 pp-step loss: full [B,S,V] fp32 log_softmax + HF shift."""
    logits = jnp.einsum("bsh,vh->bsv", x, w.astype(x.dtype),
                        preferred_element_type=jnp.float32)
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = jnp.where(valid, shift_labels, 0)
    logp = jax.nn.log_softmax(shift_logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
    return jnp.sum(jnp.where(valid, nll, 0.0)) / jnp.maximum(jnp.sum(valid), 1)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    B, S, H, V = 2, 24, 16, 40
    x = jnp.asarray(r.standard_normal((B, S, H)).astype(np.float32))
    w = jnp.asarray(r.standard_normal((V, H)).astype(np.float32) * 0.2)
    labels = r.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :5] = IGNORE_INDEX  # prompt masking
    labels[1, -3:] = IGNORE_INDEX
    return x, w, jnp.asarray(labels)


@pytest.mark.parametrize("chunk", [4, 8, 24, 7, None])
def test_chunked_matches_dense(data, chunk):
    """Any chunk size (dividing, non-dividing -> padded, whole-seq, dense
    fallback) gives the dense loss to fp32 tolerance."""
    x, w, labels = data
    ref = float(_dense_ref(x, w, labels))
    got = float(chunked_ce_mean(x, w, labels, chunk=chunk))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_chunked_grads_match_dense(data):
    """Gradients through the checkpointed scan equal the dense loss's grads
    for both the hidden states and the lm_head weight (the accumulated one)."""
    x, w, labels = data
    gx_ref, gw_ref = jax.grad(lambda x, w: _dense_ref(x, w, labels),
                              argnums=(0, 1))(x, w)
    gx, gw = jax.grad(lambda x, w: chunked_ce_mean(x, w, labels, chunk=8),
                      argnums=(0, 1))(x, w)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_ref),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gw), np.asarray(gw_ref),
                               atol=1e-6, rtol=1e-5)


def test_no_shift_variant(data):
    x, w, labels = data
    total, count = chunked_cross_entropy(x, w, labels, chunk=8, shift=False)
    # every non-ignored label counts, no position dropped
    assert int(count) == int(jnp.sum(labels != IGNORE_INDEX))
    assert np.isfinite(float(total))


def test_all_ignored_is_finite(data):
    x, w, _ = data
    labels = jnp.full(x.shape[:2], IGNORE_INDEX, jnp.int32)
    loss = float(chunked_ce_mean(x, w, labels, chunk=8))
    assert loss == 0.0


def test_full_logits_never_materialized(data):
    """The jaxpr of the chunked loss must not contain a [B, S, V] fp32
    intermediate — the whole point of the chunking (70B head term)."""
    x, w, labels = data
    B, S, _ = x.shape
    V = w.shape[0]
    jaxpr = jax.make_jaxpr(
        lambda x, w: chunked_ce_mean(x, w, labels, chunk=8))(x, w)
    assert f"{B},{S},{V}" not in str(jaxpr).replace(" ", "")


def test_grad_memory_is_chunked(data):
    """Backward too: no full [B,S,V] buffer in the grad jaxpr (jax.checkpoint
    remat means one chunk's logits are recomputed at a time)."""
    x, w, labels = data
    B, S, _ = x.shape
    V = w.shape[0]
    jaxpr = jax.make_jaxpr(
        jax.grad(lambda x, w: chunked_ce_mean(x, w, labels, chunk=8),
                 argnums=(0, 1)))(x, w)
    assert f"{B},{S},{V}" not in str(jaxpr).replace(" ", "")


def test_default_chunk_shared_with_memory_plan():
    """plan() and make_pp_train_step must model the same loss (ADVICE r2
    medium): both default to ops.loss.DEFAULT_LOSS_CHUNK."""
    import inspect

    from slime_jax.parallel import memory_plan as mp

    sig = inspect.signature(mp.plan)
    assert sig.parameters["loss_chunk"].default == "default"
    # and "default" resolves to the shared constant: chunk=DEFAULT_LOSS_CHUNK
    # equals passing it explicitly
    from slime_jax.config import LLMConfig
    cfg = LLMConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                    num_layers=4, num_heads=4, num_kv_heads=2, head_dim=8)
    a = mp.plan(cfg, batch=8, seq=2048)
    b = mp.plan(cfg, batch=8, seq=2048, loss_chunk=DEFAULT_LOSS_CHUNK)
    assert a.logits == b.logits
    c = mp.plan(cfg, batch=8, seq=2048, loss_chunk=None)  # dense modeling
    assert c.logits == a.logits * 2048 // DEFAULT_LOSS_CHUNK
