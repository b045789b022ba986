"""Ring attention (sequence parallelism over the virtual 8-device mesh, and
over 4 devices as on a four-card host) vs the full-attention oracle."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slime_jax.ops.attention import reference_attention
from slime_jax.ops.ring_attention import ring_attention


def _mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("sp",))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_ring_matches_full(rng, causal):
    B, H, S, D = 2, 4, 128, 32
    q = jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32))
    ref = reference_attention(q, k, v, causal=causal)

    mesh = _mesh()
    sh = NamedSharding(mesh, P(None, None, "sp", None))
    qs, ks, vs = (jax.device_put(x, sh) for x in (q, k, v))
    out = ring_attention(qs, ks, vs, mesh=mesh, causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_ring_under_jit(rng):
    B, H, S, D = 1, 2, 64, 16
    mesh = _mesh()
    sh = NamedSharding(mesh, P(None, None, "sp", None))
    q = jax.device_put(jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32)), sh)
    k = jax.device_put(jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32)), sh)
    v = jax.device_put(jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32)), sh)
    f = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh=mesh, causal=True))
    out = f(q, k, v)
    ref = reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5, rtol=1e-4)
    # output keeps the sequence sharding
    assert out.sharding.spec == P(None, None, "sp", None)


@pytest.mark.slow
def test_llama_forward_with_ring(rng):
    """A full decoder forward with ring attention (sequence sharded over 8 devices)
    matches the standard forward."""
    from slime_jax.config import LLMConfig
    from slime_jax.models import llama

    cfg = LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                    rope_theta=10000.0, max_position_embeddings=256)
    params = llama.init(jax.random.PRNGKey(0), cfg)
    ids = rng.integers(0, 64, (2, 64)).astype(np.int32)
    embeds = llama.embed(params, jnp.asarray(ids))
    ref, _ = llama.forward(params, embeds, cfg)

    mesh = _mesh()
    with mesh:
        out, _ = llama.forward(params, embeds, cfg, ring=(mesh, "sp"))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=5e-4, rtol=1e-3)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_ring_gqa_native(rng):
    """GQA kv (KVH < H) rides the ring without repeating to full heads; matches
    the repeated-kv full-attention oracle."""
    B, H, KVH, S, D = 2, 8, 2, 64, 16
    q = jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((B, KVH, S, D)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((B, KVH, S, D)).astype(np.float32))
    kk = jnp.repeat(k, H // KVH, axis=1)
    vv = jnp.repeat(v, H // KVH, axis=1)
    ref = reference_attention(q, kk, vv, causal=True)

    mesh = _mesh()
    sh = NamedSharding(mesh, P(None, None, "sp", None))
    out = ring_attention(jax.device_put(q, sh), jax.device_put(k, sh),
                         jax.device_put(v, sh), mesh=mesh, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_4_devices_matches_full(rng, causal):
    """Four devices (the four-card mesh), GQA kv, under jit."""
    mesh = _mesh(4)
    B, H, KVH, S, D = 1, 4, 2, 32, 16
    q = jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((B, KVH, S, D)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((B, KVH, S, D)).astype(np.float32))
    ref = reference_attention(q, k, v, causal=causal)
    out = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh=mesh,
                                                 causal=causal))(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=1e-4)


def test_ring_4_devices_mha(rng):
    """KVH == H (MHA) degenerate grouping on four devices."""
    mesh = _mesh(4)
    B, H, S, D = 1, 2, 16, 8
    q, k, v = (jnp.asarray(rng.standard_normal((B, H, S, D)).astype(np.float32))
               for _ in range(3))
    out = ring_attention(q, k, v, mesh=mesh, causal=True)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(reference_attention(q, k, v,
                                                              causal=True)),
                               atol=2e-5, rtol=1e-4)
