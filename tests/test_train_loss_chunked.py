"""The MAINLINE train step never materializes [B, S, V] logits (VERDICT r3 #1).

slime.loss_fn (both branches) now routes through hidden states +
ops.loss.chunked_cross_entropy — these tests pin (a) numerical parity with the
dense oracle on small shapes, (b) absence of the full-logits buffer from the
grad jaxpr at real vocab width, (c) the compiled step's temp-memory dropping by
the logits term, and (d) the head projection composing with quantized bases and
LoRA adapters (the QLoRA loss path)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from slime_jax.config import LLMConfig, SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.models import slime


def _mm_batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    return {"input_ids": jnp.asarray(ids),
            "attention_mask": jnp.ones((B, S), bool),
            "pixel_values": jnp.asarray(
                rng.standard_normal((B, MC, 3, t, t)).astype(np.float32)),
            "crop_mask": jnp.ones((B, MC), bool),
            "labels": jnp.asarray(labels)}


def _packed_batch(V, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    seg[0, :7] = 1
    seg[0, 7:13] = 2        # [13:] padding
    if B > 1:
        seg[1:, :] = 1
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        for s in sorted(set(seg[b]) - {0}):
            idx = np.where(seg[b] == s)[0]
            pos[b, idx] = np.arange(len(idx))
    labels = np.where(seg > 0, ids, IGNORE_INDEX)
    return {"input_ids": jnp.asarray(ids), "segment_ids": jnp.asarray(seg),
            "positions": jnp.asarray(pos), "labels": jnp.asarray(labels),
            "attention_mask": None, "pixel_values": None, "crop_mask": None}


@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_multimodal_loss_chunked_matches_dense(tiny):
    """Chunked (forced) == dense (forced) on the multimodal branch — value and
    grads. 'auto' at tiny vocab resolves to the dense path and must agree."""
    cfg, params = tiny
    batch = _mm_batch(cfg)

    def loss(p, chunk):
        return slime.loss_fn(p, cfg, batch, training=False,
                             loss_chunk=chunk)[0]

    dense, gd = jax.value_and_grad(loss)(params, None)
    chunked, gc = jax.value_and_grad(loss)(params, 4)
    auto = loss(params, "auto")
    np.testing.assert_allclose(float(chunked), float(dense), rtol=1e-6)
    np.testing.assert_allclose(float(auto), float(dense), rtol=1e-6)
    flat_d, _ = ravel_pytree(gd)
    flat_c, _ = ravel_pytree(gc)
    np.testing.assert_allclose(np.asarray(flat_c), np.asarray(flat_d),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_packed_loss_chunked_matches_reference_shift_mask(tiny):
    """Packed branch: the label-folded segment-boundary rule reproduces the
    pre-r4 explicit mask — first token of every segment and padding are never
    targets; chunked == dense."""
    cfg, params = tiny
    V = cfg.llm.vocab_size
    batch = _packed_batch(V)

    def loss(chunk):
        return slime.loss_fn(params, cfg, batch, training=False,
                             loss_chunk=chunk)

    dense, md = loss(None)
    chunked, mc = loss(4)
    np.testing.assert_allclose(float(chunked), float(dense), rtol=1e-6)
    # target count: seg0 contributes 6+5, seg1 row contributes 15 (first token
    # of each segment excluded; 3 padding positions excluded)
    assert int(md["n_target_tokens"]) == 6 + 5 + 15
    assert int(mc["n_target_tokens"]) == int(md["n_target_tokens"])

    # oracle: dense full-logit log_softmax with the explicit reference mask
    from slime_jax.models import llama
    emb = llama.embed(params["llm"], batch["input_ids"])
    logits = llama.forward(params["llm"], emb, cfg.llm,
                           positions=batch["positions"],
                           segment_ids=batch["segment_ids"])[0]
    seg = np.asarray(batch["segment_ids"])
    shift_labels = np.asarray(batch["labels"])[:, 1:]
    valid = ((shift_labels != IGNORE_INDEX)
             & (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0))
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    safe = np.where(valid, shift_labels, 0)
    nll = -np.take_along_axis(np.asarray(logp), safe[..., None], axis=-1)[..., 0]
    oracle = nll[valid].sum() / max(valid.sum(), 1)
    np.testing.assert_allclose(float(dense), float(oracle), rtol=1e-5)


def test_sft_width_step_has_no_full_logits_buffer():
    """At Llama-3 vocab width (V=128256) the grad jaxpr of the packed-branch
    loss contains no [B, S, V] buffer — forward or backward."""
    llm = LLMConfig(vocab_size=128256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                    max_position_embeddings=512)
    cfg = SliMEConfig.tiny()
    cfg = type(cfg)(**{**cfg.__dict__, "llm": llm})
    params = slime.init(jax.random.PRNGKey(0), cfg)
    B, S = 1, 512
    batch = _packed_batch(llm.vocab_size, B=B, S=S)

    jaxpr = str(jax.make_jaxpr(
        jax.grad(lambda p: slime.loss_fn(p, cfg, batch, training=False)[0])
    )(params)).replace(" ", "")
    assert f"{B},{S},{llm.vocab_size}" not in jaxpr
    # sanity: the dense formulation DOES contain it (the test can see it)
    jaxpr_dense = str(jax.make_jaxpr(
        lambda p: slime.loss_fn(p, cfg, batch, training=False,
                                loss_chunk=None)[0])(params)).replace(" ", "")
    assert f"{B},{S},{llm.vocab_size}" in jaxpr_dense


@pytest.mark.slow
def test_sft_width_step_memory_drops_by_logits_term():
    """Compiled temp memory of the real train step at SFT vocab width: the
    chunked step's temp footprint must sit below the dense step's by at least
    half the [B,S,V] fp32 logits term (VERDICT r3 next #1 'done' criterion)."""
    import optax

    from slime_jax.train.optim import TrainConfig
    from slime_jax.train.step import make_train_step

    llm = LLMConfig(vocab_size=128256, hidden_size=64, intermediate_size=128,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                    max_position_embeddings=1024)
    cfg = SliMEConfig.tiny()
    cfg = type(cfg)(**{**cfg.__dict__, "llm": llm})
    params = slime.init(jax.random.PRNGKey(0), cfg)
    B, S = 1, 1024
    batch = _packed_batch(llm.vocab_size, B=B, S=S)
    tc = TrainConfig(total_steps=10, learning_rate=1e-4)
    tx = optax.sgd(1e-4)  # moment-free: isolates activation temps
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    rng = jax.random.PRNGKey(0)

    def temps(loss_chunk):
        step = make_train_step(cfg, tc, tx, compute_dtype=jnp.float32,
                               loss_chunk=loss_chunk)
        c = step.lower(state, batch, rng).compile()
        return c.memory_analysis().temp_size_in_bytes

    logits_bytes = B * S * llm.vocab_size * 4
    t_chunked, t_dense = temps("auto"), temps(None)
    assert t_dense - t_chunked >= logits_bytes // 2, (t_dense, t_chunked)


def test_head_logits_quant_and_lora():
    """ops.loss._head_logits composes with a quantized head weight and a LoRA
    adapter exactly like the decode path's layers.linear."""
    from slime_jax.ops.loss import _head_logits, chunked_ce_mean
    from slime_jax.ops.quantization import dequantize_weight, quantize_weight

    r = np.random.default_rng(3)
    B, S, H, V, rank = 1, 8, 16, 32, 4
    x = jnp.asarray(r.standard_normal((B, S, H)).astype(np.float32))
    w = jnp.asarray(r.standard_normal((V, H)).astype(np.float32) * 0.2)
    qw = quantize_weight(np.asarray(w), bits=8)
    A = jnp.asarray(r.standard_normal((rank, H)).astype(np.float32) * 0.1)
    Bm = jnp.asarray(r.standard_normal((V, rank)).astype(np.float32) * 0.1)

    head = {"weight": qw, "lora": {"A": A, "B": Bm}}
    got = np.asarray(_head_logits(x, head))
    want = np.asarray(
        jnp.einsum("bsh,vh->bsv", x, dequantize_weight(qw))
        + jnp.einsum("bsh,vh->bsv", x, Bm @ A))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    # and the chunked loss accepts the dict head end-to-end
    labels = jnp.asarray(r.integers(0, V, (B, S)).astype(np.int32))
    loss_c = float(chunked_ce_mean(x, head, labels, chunk=4))
    loss_d = float(chunked_ce_mean(x, head, labels, chunk=None))
    np.testing.assert_allclose(loss_c, loss_d, rtol=1e-6)
