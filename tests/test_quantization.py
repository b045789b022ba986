"""Weight-only quantization: round-trip error bounds, int4 packing, quantized
matmul accuracy, whole-tree quantize/dequantize."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.ops import quantization as q


def test_int8_roundtrip_error(rng):
    w = jnp.asarray(rng.standard_normal((256, 128)).astype(np.float32)) * 0.02
    err = q.quantization_error(w, bits=8)
    assert err < 2e-4


def test_int4_roundtrip_error(rng):
    w = jnp.asarray(rng.standard_normal((256, 128)).astype(np.float32)) * 0.02
    err = q.quantization_error(w, bits=4)
    assert err < 5e-3


def test_int4_packing_shapes(rng):
    w = jnp.asarray(rng.standard_normal((64, 128)).astype(np.float32))
    qw = q.quantize_weight(w, bits=4)
    assert qw["q4"].shape == (64, 64)
    deq = q.dequantize_weight(qw)
    assert deq.shape == (64, 128)
    # column order preserved
    corr = np.corrcoef(np.asarray(deq).ravel(), np.asarray(w).ravel())[0, 1]
    assert corr > 0.98


def test_quantized_linear_close(rng):
    w = jnp.asarray(rng.standard_normal((128, 64)).astype(np.float32)) * 0.05
    x = jnp.asarray(rng.standard_normal((4, 64)).astype(np.float32))
    ref = x @ w.T
    out8 = q.quantized_linear(q.quantize_weight(w, 8), x, compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out8), np.asarray(ref), atol=2e-2)
    out4 = q.quantized_linear(q.quantize_weight(w, 4), x, compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out4), np.asarray(ref), atol=0.3)


def test_tree_quantization(rng):
    from slime_jax.config import SliMEConfig
    from slime_jax.models import slime

    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    qp = q.quantize_params(params, bits=8, min_size=1024)
    assert q.is_quantized(qp["llm"]["layers"][0]["q_proj"]["weight"])
    deq = q.dequantize_params(qp)
    a = np.asarray(deq["llm"]["layers"][0]["q_proj"]["weight"])
    b = np.asarray(params["llm"]["layers"][0]["q_proj"]["weight"])
    assert np.abs(a - b).mean() < 1e-3


def test_group_int4_roundtrip(rng):
    """Group absmax int4: correct storage/round-trip; on gaussian weights the
    error gain over per-row is small (absmax ~ sqrt(log n)) — which is WHY
    the int4 accuracy default is NF4, not group absmax."""
    w = jnp.asarray(rng.standard_normal((64, 512)).astype(np.float32) * 0.02)
    err_row = q.quantization_error(w, bits=4)
    qw_g = q.quantize_weight(w, 4, group=128)
    assert qw_g["scale"].shape == (64, 4)
    assert qw_g["q4"].shape == (64, 256)
    err_g = float(jnp.mean(jnp.abs(q.dequantize_weight(qw_g)
                                   - w.astype(jnp.float32))))
    assert err_g < err_row, (err_g, err_row)
    # column order preserved through pack/unpack with group scales
    corr = np.corrcoef(np.asarray(q.dequantize_weight(qw_g)).ravel(),
                       np.asarray(w).ravel())[0, 1]
    assert corr > 0.99


def test_nf4_roundtrip_beats_uniform_int4(rng):
    """NF4 (group-64 codebook) vs uniform per-row int4 on gaussian weights:
    the QLoRA design point — materially lower round-trip error."""
    w = jnp.asarray(rng.standard_normal((64, 512)).astype(np.float32) * 0.02)
    err_uniform = q.quantization_error(w, bits=4)
    qw = q.quantize_weight_nf4(w, group=64)
    assert qw["nf4"].shape == (64, 256) and qw["scale"].shape == (64, 8)
    assert q.is_quantized(qw)
    err_nf4 = float(jnp.mean(jnp.abs(q.dequantize_weight(qw)
                                     - w.astype(jnp.float32))))
    assert err_nf4 < err_uniform * 0.7, (err_nf4, err_uniform)
    corr = np.corrcoef(np.asarray(q.dequantize_weight(qw)).ravel(),
                       np.asarray(w).ravel())[0, 1]
    assert corr > 0.994


def test_nf4_linear_and_forward(rng):
    from slime_jax.models import layers as L
    w = jnp.asarray(rng.standard_normal((32, 256)).astype(np.float32) * 0.05)
    x = jnp.asarray(rng.standard_normal((4, 256)).astype(np.float32))
    ref = x @ w.T
    qw = q.quantize_weight_nf4(w, group=64)
    out = q.quantized_linear(qw, x, compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=0.35)
    # the generic linear() dispatch handles nf4 dicts (XLA dequant path)
    out2 = L.linear({"weight": qw}, x)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(out), atol=1e-4)


def test_group_int8_and_linear(rng):
    w = jnp.asarray(rng.standard_normal((32, 256)).astype(np.float32) * 0.05)
    x = jnp.asarray(rng.standard_normal((4, 256)).astype(np.float32))
    ref = x @ w.T
    for bits, atol in ((8, 0.05), (4, 0.6)):
        qw = q.quantize_weight(w, bits, group=64)
        out = q.quantized_linear(qw, x, compute_dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol)


def test_quantize_params_int4_defaults_to_nf4(rng):
    tree = {"proj": {"weight": jnp.asarray(
        rng.standard_normal((256, 512)).astype(np.float32))}}
    qp = q.quantize_params(tree, bits=4, min_size=1)
    assert "nf4" in qp["proj"]["weight"]                      # bnb parity
    assert qp["proj"]["weight"]["scale"].shape == (256, 8)    # group=64
    qp8 = q.quantize_params(tree, bits=8, min_size=1)
    assert qp8["proj"]["weight"]["scale"].shape == (256, 1)   # per-row
    qp_row = q.quantize_params(tree, bits=4, min_size=1, scheme="absmax")
    assert "q4" in qp_row["proj"]["weight"]
    assert qp_row["proj"]["weight"]["scale"].shape == (256, 1)


def test_stacked_3d_quantize_roundtrip(rng):
    """Pre-stacked [L, out, in] layer trees quantize along the LAST dim (the
    int4 nibble packing sliced axis 1 before r3 — wrong dim on 3D leaves)."""
    w = jnp.asarray(rng.standard_normal((3, 16, 32)).astype(np.float32) * 0.02)
    for bits, key, packed_in in ((8, "q", 32), (4, "q4", 16)):
        qw = q.quantize_weight(w, bits)
        assert qw[key].shape == (3, 16, packed_in)
        assert qw["scale"].shape == (3, 16, 1)
        deq = q.dequantize_weight(qw)
        assert deq.shape == (3, 16, 32)
        # per-layer slice == quantizing that layer alone (scan-path contract)
        one = q.dequantize_weight(q.quantize_weight(w[1], bits))
        np.testing.assert_allclose(np.asarray(deq[1]), np.asarray(one),
                                   atol=1e-7)


def test_to_jax_preserves_quant_scales(rng):
    """to_jax(dtype=bf16) must not cast fp32 'scale' leaves inside quantized
    dicts — that would add ~0.2-0.4% dequant error to every int8/int4 weight
    (ADVICE r2)."""
    from slime_jax import checkpoint as ckpt

    w = rng.standard_normal((64, 32)).astype(np.float32) * 0.02
    tree = {"llm": {"proj": {"weight": q.quantize_weight(jnp.asarray(w), 8)},
                    "norm": {"weight": np.ones((32,), np.float32)}}}
    out = ckpt.to_jax(tree, dtype=jnp.bfloat16)
    qleaf = out["llm"]["proj"]["weight"]
    assert q.is_quantized(qleaf)
    assert qleaf["scale"].dtype == jnp.float32  # untouched
    assert qleaf["q"].dtype == jnp.int8
    assert out["llm"]["norm"]["weight"].dtype == jnp.bfloat16  # plain leaves cast


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_quantized_lm_head_matches_fp():
    """The logits path is quant-aware (llama._lm_head): an int8 lm_head must
    produce near-identical logits and the same greedy decode on a tiny model."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slime_jax.config import LLMConfig
    from slime_jax.models import llama
    from slime_jax.ops.quantization import quantize_params

    cfg = LLMConfig.tiny()
    params = llama.init(jax.random.PRNGKey(0), cfg)
    qp = dict(params)
    qp["lm_head"] = quantize_params(params["lm_head"], bits=8, min_size=1)
    assert isinstance(qp["lm_head"]["weight"], dict)

    ids = np.random.default_rng(0).integers(5, cfg.vocab_size, (1, 8)).astype(np.int32)
    emb = llama.embed(params, jnp.asarray(ids))
    lg_fp, _ = llama.forward(params, emb, cfg)
    lg_q, _ = llama.forward(qp, emb, cfg)
    # int8 per-row absmax quantization: small relative logit error
    err = float(jnp.max(jnp.abs(lg_fp - lg_q)) / (jnp.max(jnp.abs(lg_fp)) + 1e-9))
    assert err < 0.02, err

    # decode path too
    cache = llama.init_kv_cache(cfg, 1, 16)
    cache = dict(cache); cache["length"] = jnp.full((1,), 8, jnp.int32)
    kvs_cache = llama.prefill_into_cache(
        llama.init_kv_cache(cfg, 1, 16),
        llama.forward(params, emb, cfg, return_kv=True)[1], jnp.full((1,), 8))
    l1, _ = llama.decode_step(params, kvs_cache, jnp.asarray([3]), cfg)
    l2, _ = llama.decode_step(qp, kvs_cache, jnp.asarray([3]), cfg)
    assert int(jnp.argmax(l1)) == int(jnp.argmax(l2))
