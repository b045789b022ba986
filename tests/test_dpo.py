"""DPO training (train/dpo.py + data/dpo.py): the reference's vestigial
`--task DPO` surface (reference llava/train/train.py:133-166 +
scripts/llama-lora/eval/log_p_inference.sh), implemented.

Pins: chunked per-sequence logp vs a dense oracle; the three loss types vs a
NumPy oracle; loss == log 2 when policy == reference (full AND LoRA at
adapter init); a tiny run separates the pair (reward margin grows, accuracy
hits 1); token-diff weighting; preference-record normalization + collation.
"""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from slime_jax.config import SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.data.dpo import (PreferenceDataset, collate_dpo, dpo_loader,
                                normalize_record, target_token_weights)
from slime_jax.models import slime
from slime_jax.ops.loss import chunked_sequence_logp
from slime_jax.train import dpo
from slime_jax.train.optim import TrainConfig, make_optimizer
from slime_jax.train.step import init_lora_train_state, init_train_state


# ---------------------------------------------------------------- primitives

def test_chunked_sequence_logp_matches_dense(rng):
    B, S, H, V = 3, 20, 16, 37
    x = jnp.asarray(rng.standard_normal((B, S, H)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((V, H)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, V, (B, S)), jnp.int32)
    labels = labels.at[:, :5].set(IGNORE_INDEX)
    labels = labels.at[2, :].set(IGNORE_INDEX)   # a fully-masked row

    logits = np.asarray(x) @ np.asarray(w).T
    logp_all = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)
                                      ).sum(-1, keepdims=True)) - \
        logits.max(-1, keepdims=True)
    want = np.zeros((B,))
    cnt = np.zeros((B,))
    for b in range(B):
        for i in range(S - 1):
            t = int(labels[b, i + 1])
            if t != IGNORE_INDEX:
                want[b] += logp_all[b, i, t]
                cnt[b] += 1
    for chunk in (None, 4, 7):
        got, mass = chunked_sequence_logp(x, w, labels, chunk=chunk)
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(mass), cnt)


def test_chunked_sequence_logp_weights(rng):
    B, S, H, V = 2, 12, 8, 19
    x = jnp.asarray(rng.standard_normal((B, S, H)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((V, H)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, V, (B, S)), jnp.int32)
    weights = jnp.asarray(rng.random((B, S)) + 0.5, jnp.float32)
    # weights == 1 is exactly the unweighted path
    got1, m1 = chunked_sequence_logp(x, w, labels, chunk=4,
                                     weights=jnp.ones((B, S)))
    got0, m0 = chunked_sequence_logp(x, w, labels, chunk=4)
    np.testing.assert_allclose(np.asarray(got1), np.asarray(got0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m0))
    # weighted == dense-weighted oracle
    gotw, mw = chunked_sequence_logp(x, w, labels, chunk=4, weights=weights)
    dense, md = chunked_sequence_logp(x, w, labels, chunk=None,
                                      weights=weights)
    np.testing.assert_allclose(np.asarray(gotw), np.asarray(dense),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(mw), np.asarray(md), rtol=1e-6)


def test_dpo_loss_types_oracle(rng):
    B, beta = 5, 0.3
    pc, pr, rc, rr = (jnp.asarray(rng.standard_normal(B), jnp.float32)
                      for _ in range(4))
    h = np.asarray(pc - pr) - np.asarray(rc - rr)

    l, cw, rw = dpo.dpo_losses(pc, pr, rc, rr, beta=beta, loss_type="sigmoid")
    np.testing.assert_allclose(np.asarray(l),
                               np.log1p(np.exp(-beta * h)), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(cw),
                               beta * np.asarray(pc - rc), rtol=1e-5)

    l, _, _ = dpo.dpo_losses(pc, pr, rc, rr, beta=beta, loss_type="ipo")
    np.testing.assert_allclose(np.asarray(l), (h - 1 / (2 * beta)) ** 2,
                               rtol=1e-5)

    l, _, _ = dpo.dpo_losses(pc, pr, rc, rr, beta=beta, loss_type="kto_pair")
    assert l.shape == (2 * B,)
    ckl = max(float(np.mean(np.asarray(pc - rc))), 0.0)
    rkl = max(float(np.mean(np.asarray(pr - rr))), 0.0)
    sig = lambda z: 1 / (1 + np.exp(-z))  # noqa: E731
    np.testing.assert_allclose(
        np.asarray(l[:B]), 1 - sig(beta * (np.asarray(pc - rc) - rkl)),
        rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(l[B:]), 1 - sig(beta * (ckl - np.asarray(pr - rr))),
        rtol=1e-5)

    with pytest.raises(ValueError):
        dpo.DPOConfig(loss_type="nope")


def test_target_token_weights_diff():
    chosen = [1, 2, 3, 4, 5]
    rejected = [1, 2, 9, 9, 4, 5]
    wc, wr = target_token_weights(chosen, rejected, 1.5)
    np.testing.assert_allclose(wc, [1, 1, 1.5, 1, 1])
    np.testing.assert_allclose(wr, [1, 1, 1.5, 1.5, 1, 1])
    # identical answers -> all ones
    wc, wr = target_token_weights([7, 8], [7, 8], 2.0)
    np.testing.assert_allclose(wc, [1, 1])
    np.testing.assert_allclose(wr, [1, 1])


# ------------------------------------------------------------------- the step

@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def _pair_batch(cfg, B=2, S=16, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (2 * B, S)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    # shared prompt per pair; answers (last 6 tokens) differ
    ids[B:, :-6] = ids[:B, :-6]
    labels = np.full_like(ids, IGNORE_INDEX)
    labels[:, -6:] = ids[:, -6:]
    batch = {"input_ids": ids, "labels": labels,
             "attention_mask": np.ones((2 * B, S), bool),
             "pixel_values": rng.standard_normal(
                 (B, MC, 3, t, t)).astype(np.float32),
             "crop_mask": np.ones((B, MC), bool)}
    if weights:
        batch["target_weights"] = np.ones((2 * B, 6), np.float32)
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_dpo_initial_loss_is_log2(tiny):
    """policy == reference at init -> h == 0 -> sigmoid loss == log 2."""
    cfg, params = tiny
    tc = TrainConfig(learning_rate=1e-3, total_steps=10)
    state, tx = init_train_state(params, tc)
    step = dpo.make_dpo_train_step(cfg, tc, tx, dpo.DPOConfig(),
                                   compute_dtype=jnp.float32)
    ref = dpo.shard_ref_params(params)
    batch = _pair_batch(cfg)
    _, m = step(state, ref, batch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["loss"]), np.log(2.0), rtol=1e-4)
    np.testing.assert_allclose(float(m["reward_margin"]), 0.0, atol=1e-5)


@pytest.mark.slow  # heavy: 15 compiled steps of the full multimodal DPO step
def test_dpo_training_separates_pair(tiny):
    cfg, params = tiny
    tc = TrainConfig(learning_rate=5e-3, total_steps=30, lr_schedule="constant",
                     warmup_ratio=0.0)
    state, tx = init_train_state(params, tc)
    step = dpo.make_dpo_train_step(cfg, tc, tx, dpo.DPOConfig(beta=0.1),
                                   compute_dtype=jnp.float32)
    ref = dpo.shard_ref_params(params)
    batch = _pair_batch(cfg)
    losses, margins = [], []
    for i in range(15):
        state, m = step(state, ref, batch, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
        margins.append(float(m["reward_margin"]))
    assert losses[-1] < np.log(2.0) * 0.8
    assert margins[-1] > margins[0]
    assert float(m["reward_accuracy"]) == 1.0
    assert float(m["chosen_reward"]) > float(m["rejected_reward"])


@pytest.mark.slow  # heavy: compiles the step once per loss type
@pytest.mark.parametrize("loss_type", ["ipo", "kto_pair"])
def test_dpo_variant_losses_decrease(tiny, loss_type):
    cfg, params = tiny
    tc = TrainConfig(learning_rate=5e-3, total_steps=20,
                     lr_schedule="constant", warmup_ratio=0.0)
    state, tx = init_train_state(params, tc)
    step = dpo.make_dpo_train_step(
        cfg, tc, tx, dpo.DPOConfig(beta=0.2, loss_type=loss_type),
        compute_dtype=jnp.float32)
    ref = dpo.shard_ref_params(params)
    batch = _pair_batch(cfg, seed=3)
    first = last = None
    for i in range(10):
        state, m = step(state, ref, batch, jax.random.PRNGKey(i))
        first = first if first is not None else float(m["loss"])
        last = float(m["loss"])
    assert last < first


def test_dpo_use_average_and_sft_mix(tiny):
    cfg, params = tiny
    tc = TrainConfig(learning_rate=1e-3, total_steps=10)
    state, tx = init_train_state(params, tc)
    dc = dpo.DPOConfig(use_average=True, sft_weight=0.5)
    step = dpo.make_dpo_train_step(cfg, tc, tx, dc, compute_dtype=jnp.float32)
    ref = dpo.shard_ref_params(params)
    batch = _pair_batch(cfg)
    _, m = step(state, ref, batch, jax.random.PRNGKey(0))
    # loss = log2 + 0.5 * (chosen per-token NLL); NLL ~ log V at random init
    assert float(m["loss"]) > np.log(2.0)
    assert np.isfinite(float(m["loss"]))


def test_lora_dpo_base_is_reference(tiny):
    """LoRA-DPO at adapter init (B=0): policy == base == reference -> log 2;
    a few steps then move only the adapters/extras and separate the pair."""
    from slime_jax.train import lora as lora_lib
    cfg, params = tiny
    tc = TrainConfig(learning_rate=5e-3, total_steps=30,
                     lr_schedule="constant", warmup_ratio=0.0)
    lora_state = lora_lib.init_lora(jax.random.PRNGKey(1), params, r=4,
                                    alpha=8)
    base, state, tx = init_lora_train_state(params, lora_state, tc)
    step = dpo.make_lora_dpo_train_step(cfg, tc, tx, dpo.DPOConfig(), rank=4,
                                        alpha=8, compute_dtype=jnp.float32)
    batch = _pair_batch(cfg, seed=5)
    base_before = jax.tree_util.tree_map(np.asarray, base)
    state, m = step(state, base, batch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["loss"]), np.log(2.0), rtol=1e-4)
    for i in range(12):
        state, m = step(state, base, batch, jax.random.PRNGKey(i + 1))
    assert float(m["loss"]) < np.log(2.0)
    assert float(m["reward_margin"]) > 0
    # the frozen base never moved
    for a, b in zip(jax.tree_util.tree_leaves(base_before),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(np.asarray, base))):
        np.testing.assert_array_equal(a, b)


def test_dpo_token_weighted_step(tiny):
    cfg, params = tiny
    tc = TrainConfig(learning_rate=1e-3, total_steps=10)
    state, tx = init_train_state(params, tc)
    dc = dpo.DPOConfig(token_weighted=True, token_weight=1.1)
    step = dpo.make_dpo_train_step(cfg, tc, tx, dc, compute_dtype=jnp.float32)
    ref = dpo.shard_ref_params(params)
    # all-ones weights must reproduce the unweighted loss exactly
    batch = _pair_batch(cfg, weights=True)
    _, m = step(state, ref, batch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["loss"]), np.log(2.0), rtol=1e-4)


# ------------------------------------------------------------------ data side

def test_normalize_record_shapes():
    r = {"conversations": [{"from": "human", "value": "q"},
                           {"from": "gpt", "value": "orig"}],
         "chosen": "good", "rejected": {"value": "bad"}}
    prompt, c, j = normalize_record(r)
    assert prompt == [{"from": "human", "value": "q"}]
    assert (c, j) == ("good", "bad")
    r2 = {"question": "q2", "output_1": {"value": "a"},
          "output_2": {"value": "b"}, "preference": 2}
    prompt, c, j = normalize_record(r2)
    assert prompt == [{"from": "human", "value": "q2"}]
    assert (c, j) == ("b", "a")
    with pytest.raises(ValueError):
        normalize_record({"conversations": []})


def test_preference_dataset_and_loader(tmp_path):
    from tests.toy_tokenizer import ToyTokenizer
    tok = ToyTokenizer()
    recs = [{"id": i,
             "conversations": [{"from": "human", "value": f"question {i}"}],
             "chosen": f"good answer {i}", "rejected": f"bad answer {i}"}
            for i in range(4)]
    p = tmp_path / "pref.json"
    p.write_text(json.dumps(recs))
    ds = PreferenceDataset([str(p)], tok, is_multimodal=False,
                           conv_version="v1", token_weighted=True)
    assert len(ds) == 4
    it = ds[0]
    assert (it["labels_chosen"] != IGNORE_INDEX).sum() > 0
    assert (it["labels_rejected"] != IGNORE_INDEX).sum() > 0
    # prompt spans mask identically on both sides
    nc = np.argmax(it["labels_chosen"] != IGNORE_INDEX)
    nr = np.argmax(it["labels_rejected"] != IGNORE_INDEX)
    assert nc == nr
    assert "target_weights_chosen" in it

    batches = list(dpo_loader(ds, batch_size=2, seq_len=32,
                              pad_token_id=0, shuffle=False))
    assert len(batches) == 2
    b = batches[0]
    assert b["input_ids"].shape == (4, 32)
    assert b["pixel_values"].shape[0] == 2
    assert b["target_weights"].shape[0] == 4
    # chosen rows [0, B) and rejected rows [B, 2B) share their prompt prefix
    n = min((b["labels"][0] != IGNORE_INDEX).argmax(),
            (b["labels"][2] != IGNORE_INDEX).argmax())
    np.testing.assert_array_equal(b["input_ids"][0, :n],
                                  b["input_ids"][2, :n])


@pytest.mark.slow  # heavy: 8-device-mesh compile of the DPO step
def test_dpo_sharded_mesh(tiny):
    """Full-parameter DPO under a (data=2, fsdp=4) mesh: policy state, frozen
    reference tree, and the stacked pair batch all shard; initial loss is
    log 2 and two steps keep separating the pair."""
    from slime_jax.parallel import mesh as mesh_lib

    cfg, params = tiny
    mesh = mesh_lib.make_mesh(2, 4, 1)
    tc = TrainConfig(learning_rate=5e-3, total_steps=10,
                     lr_schedule="constant", warmup_ratio=0.0)
    state, tx = init_train_state(params, tc, mesh=mesh)
    ref = dpo.shard_ref_params(params, mesh=mesh)
    step = dpo.make_dpo_train_step(cfg, tc, tx, dpo.DPOConfig(),
                                   compute_dtype=jnp.float32)
    # 2B rows must divide data*fsdp=8 -> B=4 pairs
    batch = mesh_lib.shard_batch(mesh, jax.tree_util.tree_map(
        np.asarray, _pair_batch(cfg, B=4)))
    state, m = step(state, ref, batch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["loss"]), np.log(2.0), rtol=1e-4)
    for i in range(4):
        state, m = step(state, ref, batch, jax.random.PRNGKey(i + 1))
    assert float(m["loss"]) < np.log(2.0)
    assert float(m["reward_margin"]) > 0
