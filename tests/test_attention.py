"""ops/attention.py: the attention entry point vs the float32 oracle.

On the CPU the entry point takes its XLA route; the cuDNN route runs only on a
GPU, in the tests marked ``gpu`` (run on the card by chip_smoke.py). Shapes
follow both callers: the LLM's causal GQA prefill with packed segments, and
the ViT's bidirectional attention at CLIP-L's S=577, D=64.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.ops import attention as A


def _rand(rng, *shape, dtype=jnp.float32, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                       dtype)


def _oracle(q, k, v, **kw):
    """[B, S, H, D] in and out, through the [B, H, S, D] reference."""
    t = lambda x: jnp.swapaxes(jnp.asarray(x, jnp.float32), 1, 2)
    return jnp.swapaxes(A.reference_attention(t(q), t(k), t(v), **kw), 1, 2)


def _segs(rng, B, S, n_max=4):
    """Random packed segment layout: contiguous runs 1..n, zero tail."""
    out = np.zeros((B, S), np.int32)
    for b in range(B):
        off, sid = 0, 1
        while off < S - 8 and sid <= n_max:
            n = int(rng.integers(8, max(9, S // n_max)))
            out[b, off:off + n] = sid
            off += n
            sid += 1
    return jnp.asarray(out)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")


# ----------------------------------------------------------------------------
# LLM shapes: causal, GQA, packed segments
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 256])
def test_forward_matches_reference(rng, causal, S):
    q, k, v = (_rand(rng, 2, S, 4, 64) for _ in range(3))
    out = A.attention(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(_oracle(
        q, k, v, causal=causal)), atol=2e-5, rtol=1e-4)


def test_forward_gqa(rng):
    q = _rand(rng, 2, 128, 8, 64)
    k, v = (_rand(rng, 2, 128, 2, 64) for _ in range(2))
    out = A.attention(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(_oracle(
        q, k, v, causal=True)), atol=2e-5, rtol=1e-4)


def test_forward_uneven_length(rng):
    q, k, v = (_rand(rng, 1, 96, 2, 64) for _ in range(3))
    out = A.attention(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(_oracle(
        q, k, v, causal=True)), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_reference(rng, causal):
    q = _rand(rng, 1, 128, 4, 64)
    k, v = (_rand(rng, 1, 128, 2, 64) for _ in range(2))
    loss = lambda f: (lambda q, k, v: jnp.sum(f(q, k, v) ** 2))
    g_ref = jax.grad(loss(lambda *a: _oracle(*a, causal=causal)),
                     argnums=(0, 1, 2))(q, k, v)
    g = jax.grad(loss(lambda *a: A.attention(*a, causal=causal)),
                 argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(g, g_ref, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4,
                                   rtol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_segmented_forward_matches_reference(rng, causal):
    """Sequence-packing mask: block-diagonal per segment."""
    q, k, v = (_rand(rng, 2, 256, 4, 64) for _ in range(3))
    seg = _segs(rng, 2, 256)
    out = A.attention(q, k, v, causal=causal, segment_ids=seg)
    ref = _oracle(q, k, v, causal=causal, segment_ids=seg)
    # only real-token rows count: pad queries are loss-masked downstream
    m = np.asarray(seg > 0)[:, :, None, None]
    np.testing.assert_allclose(np.asarray(out) * m, np.asarray(ref) * m,
                               atol=2e-5, rtol=1e-4)


def test_segmented_later_segment_sees_no_earlier_keys(rng):
    """A segment that starts mid-sequence attends only to itself: every key
    before it is masked for its queries."""
    q, k, v = (_rand(rng, 1, 256, 2, 64) for _ in range(3))
    seg = np.zeros((1, 256), np.int32)
    seg[0, :128] = 1
    seg[0, 128:] = 2
    seg = jnp.asarray(seg)
    out = A.attention(q, k, v, causal=True, segment_ids=seg)
    np.testing.assert_allclose(np.asarray(out), np.asarray(_oracle(
        q, k, v, causal=True, segment_ids=seg)), atol=2e-5, rtol=1e-4)
    alone = A.attention(q[:, 128:], k[:, 128:], v[:, 128:], causal=True)
    np.testing.assert_allclose(np.asarray(out[:, 128:]), np.asarray(alone),
                               atol=2e-5, rtol=1e-4)


# ----------------------------------------------------------------------------
# ViT shapes: bidirectional, S up to 1024
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("S", [577, 128, 260, 1024])
def test_vit_matches_oracle(rng, S):
    q, k, v = (_rand(rng, 2, S, 4, 64, scale=0.3) for _ in range(3))
    out = A.attention(q, k, v, causal=False)
    np.testing.assert_allclose(np.asarray(out), np.asarray(_oracle(
        q, k, v, causal=False)), atol=2e-5, rtol=1e-4)


def test_vit_bf16_close(rng):
    q, k, v = (_rand(rng, 2, 577, 16, 64, dtype=jnp.bfloat16, scale=0.3)
               for _ in range(3))
    out = A.attention(q, k, v, causal=False)
    assert out.dtype == jnp.bfloat16
    err = float(jnp.max(jnp.abs(out.astype(jnp.float32)
                                - _oracle(q, k, v, causal=False))))
    assert err < 2e-2, err


def test_vit_odd_head_counts(rng):
    for H in (2, 3):
        q, k, v = (_rand(rng, 1, 130, H, 32, scale=0.3) for _ in range(3))
        out = A.attention(q, k, v, causal=False, scale=1.0 / math.sqrt(32))
        np.testing.assert_allclose(np.asarray(out), np.asarray(_oracle(
            q, k, v, causal=False)), atol=2e-5, rtol=1e-4)


def test_vit_grad_matches_oracle(rng):
    q, k, v = (_rand(rng, 1, 130, 2, 32, scale=0.3) for _ in range(3))
    loss = lambda f: (lambda q, k, v: jnp.sum(f(q, k, v) ** 2))
    g_ref = jax.grad(loss(lambda *a: _oracle(*a, causal=False)),
                     argnums=(0, 1, 2))(q, k, v)
    g = jax.grad(loss(lambda *a: A.attention(*a, causal=False)),
                 argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4, rtol=1e-3)


def test_vit_apply_runs(rng):
    from slime_jax.config import VisionConfig
    from slime_jax.models import vit

    cfg = VisionConfig(image_size=56, patch_size=14, hidden_size=64,
                       intermediate_size=128, num_layers=2, num_heads=4)
    params = vit.init(jax.random.PRNGKey(0), cfg)
    pix = jnp.asarray(rng.standard_normal((2, 3, 56, 56)).astype(np.float32))
    out = vit.apply(params, pix, cfg)
    assert np.isfinite(np.asarray(out)).all()
    assert out.shape == (2, (56 // 14) ** 2, 64)


@pytest.mark.parametrize("causal", [False, True])
def test_even_length_padding_is_exact(rng, causal):
    """The odd-length path (cuDNN's backward needs an even length) pads one
    position and hides it by sequence lengths: same values and gradients."""
    q = _rand(rng, 2, 577, 4, 64, scale=0.3)
    k, v = (_rand(rng, 2, 577, 2, 64, scale=0.3) for _ in range(2))
    f = lambda q, k, v: A._even_length(q, k, v, causal=causal, scale=None,
                                       impl="xla")
    np.testing.assert_allclose(np.asarray(f(q, k, v)), np.asarray(_oracle(
        q, k, v, causal=causal)), atol=2e-5, rtol=1e-4)
    loss = lambda g: (lambda q, k, v: jnp.sum(g(q, k, v) ** 2))
    g_pad = jax.grad(loss(f), argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss(lambda *a: _oracle(*a, causal=causal)),
                     argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_pad, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4), (1, 4, 1)])
def test_per_device_under_mesh_is_exact(rng, shape):
    """Under a mesh the library call runs per device (batch over data x
    fsdp, heads over model); GQA grouping and segments survive the split."""
    from slime_jax.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(*shape, devices=jax.devices()[:4])
    q = _rand(rng, 4, 128, 8, 32)
    k, v = (_rand(rng, 4, 128, 4, 32) for _ in range(2))
    seg = _segs(rng, 4, 128)
    f = lambda q, k, v: A._per_device(q, k, v, causal=True, scale=None,
                                      segment_ids=seg, mesh=mesh, impl="xla")
    out = jax.jit(f)(q, k, v)
    ref = _oracle(q, k, v, causal=True, segment_ids=seg)
    m = np.asarray(seg > 0)[:, :, None, None]
    np.testing.assert_allclose(np.asarray(out) * m, np.asarray(ref) * m,
                               atol=2e-5, rtol=1e-4)
    g = jax.grad(lambda q: jnp.sum((f(q, k, v) * m) ** 2))(q)
    g_ref = jax.grad(lambda q: jnp.sum(
        (_oracle(q, k, v, causal=True, segment_ids=seg) * m) ** 2))(q)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               atol=5e-4, rtol=1e-3)


# ----------------------------------------------------------------------------
# Route choice
# ----------------------------------------------------------------------------

class _FakeDevice:
    platform = "gpu"


def test_route_on_cpu_is_xla():
    x = jnp.zeros((1, 64, 4, 64), jnp.bfloat16)
    assert A.choose_implementation(x, x) == "xla"


def test_route_by_dtype_and_shape(monkeypatch):
    """On a GPU: cuDNN for bf16/fp16 at head dims it takes, XLA otherwise."""
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice()])
    mk = lambda S, D, dt: jax.ShapeDtypeStruct((1, S, 4, D), dt)
    assert A.choose_implementation(mk(2048, 128, jnp.bfloat16),
                                   mk(2048, 128, jnp.bfloat16)) == "cudnn"
    assert A.choose_implementation(mk(577, 64, jnp.float16),
                                   mk(577, 64, jnp.float16)) == "cudnn"
    assert A.choose_implementation(mk(2048, 64, jnp.float32),
                                   mk(2048, 64, jnp.float32)) == "xla"
    assert A.choose_implementation(mk(2048, 12, jnp.bfloat16),
                                   mk(2048, 12, jnp.bfloat16)) == "xla"
    assert A.choose_implementation(mk(128, 128, jnp.bfloat16),
                                   mk(128, 128, jnp.bfloat16)) == "cudnn"
    seg = jnp.zeros((1, 577), jnp.int32)
    assert A.choose_implementation(mk(577, 64, jnp.bfloat16),
                                   mk(577, 64, jnp.bfloat16),
                                   segment_ids=seg) == "xla"


# ----------------------------------------------------------------------------
# The cuDNN route on the card
# ----------------------------------------------------------------------------

def _close_bf16(out, ref, max_abs=2e-2, mean_abs=2e-3):
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert err.max() <= max_abs and err.mean() <= mean_abs, (err.max(),
                                                             err.mean())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_cudnn_matches_reference(rng, gpu, causal):
    q = _rand(rng, 2, 512, 8, 128, dtype=jnp.bfloat16)
    k, v = (_rand(rng, 2, 512, 2, 128, dtype=jnp.bfloat16) for _ in range(2))
    assert A.choose_implementation(q, k) == "cudnn"
    out = jax.jit(lambda *a: A.attention(*a, causal=causal))(q, k, v)
    with jax.default_matmul_precision("highest"):
        ref = _oracle(q, k, v, causal=causal)
    _close_bf16(out, ref)


@pytest.mark.gpu
def test_gpu_cudnn_segments_and_grad(rng, gpu):
    q = _rand(rng, 1, 512, 8, 128, dtype=jnp.bfloat16)
    k, v = (_rand(rng, 1, 512, 2, 128, dtype=jnp.bfloat16) for _ in range(2))
    seg = _segs(rng, 1, 512)
    m = jnp.asarray(seg > 0)[:, :, None, None]
    f = lambda q, k, v: jnp.sum(
        (A.attention(q, k, v, causal=True, segment_ids=seg) * m)
        .astype(jnp.float32) ** 2)
    g = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.grad(lambda q, k, v: jnp.sum(
            (_oracle(q, k, v, causal=True, segment_ids=seg) * m) ** 2),
            argnums=(0, 1, 2))(*(x.astype(jnp.float32) for x in (q, k, v)))
    for a, b in zip(g, g_ref):
        scale = float(jnp.max(jnp.abs(b)))
        err = float(jnp.max(jnp.abs(a.astype(jnp.float32) - b)))
        assert err <= 5e-2 * max(scale, 1.0), (err, scale)


@pytest.mark.gpu
def test_gpu_cudnn_odd_length_grad(rng, gpu):
    """The ViT's odd S=577 through cuDNN, forward and backward (padded)."""
    q, k, v = (_rand(rng, 2, 577, 16, 64, dtype=jnp.bfloat16)
               for _ in range(3))
    assert A.choose_implementation(q, k) == "cudnn"
    f = lambda q, k, v: jnp.sum(
        A.attention(q, k, v, causal=False).astype(jnp.float32) ** 2)
    g = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.grad(lambda q, k, v: jnp.sum(
            _oracle(q, k, v, causal=False) ** 2),
            argnums=(0, 1, 2))(*(x.astype(jnp.float32) for x in (q, k, v)))
    for a, b in zip(g, g_ref):
        scale = float(jnp.max(jnp.abs(b)))
        err = float(jnp.max(jnp.abs(a.astype(jnp.float32) - b)))
        assert err <= 5e-2 * max(scale, 1.0), (err, scale)
