"""Multi-image fusion: N sentinel blocks splice in order; oracle comparison;
single-image consistency with the N=1 path."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.models import slime


@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def _mk(cfg, B=2, S=18, N=2, sent_at=((3, 9), (5, 12)), seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    for b in range(B):
        for p in sent_at[b]:
            if p >= 0:
                ids[b, p] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    pix = rng.standard_normal((B, N, MC, 3, t, t)).astype(np.float32)
    cmask = np.zeros((B, N, MC), bool)
    cmask[:, :, :3] = True
    return {"input_ids": jnp.asarray(ids), "attention_mask": jnp.ones((B, S), bool),
            "pixel_values": jnp.asarray(pix), "crop_mask": jnp.asarray(cmask),
            "labels": jnp.asarray(labels)}


def _oracle(cfg, params, batch, img_embeds, img_valid, max_len):
    """Python splice: each sentinel (in order) expands into its image block."""
    ids = np.asarray(batch["input_ids"])
    labels = np.asarray(batch["labels"])
    emb_table = np.asarray(params["llm"]["embed_tokens"])
    B = ids.shape[0]
    out_e, out_l, out_len = [], [], []
    for b in range(B):
        img_k = 0
        e_list, l_list = [], []
        for s in range(ids.shape[1]):
            if ids[b, s] == IMAGE_TOKEN_INDEX:
                if img_k < img_embeds.shape[1]:
                    for t in range(img_embeds.shape[2]):
                        if img_valid[b, img_k, t]:
                            e_list.append(np.asarray(img_embeds)[b, img_k, t])
                            l_list.append(IGNORE_INDEX)
                    img_k += 1
            else:
                e_list.append(emb_table[ids[b, s]])
                l_list.append(labels[b, s])
        arr = np.stack(e_list)[:max_len]
        lab = np.asarray(l_list)[:max_len]
        out_len.append(len(arr))
        pad = max_len - len(arr)
        out_e.append(np.pad(arr, ((0, pad), (0, 0))))
        out_l.append(np.pad(lab, (0, pad), constant_values=IGNORE_INDEX))
    return np.stack(out_e), np.stack(out_l), np.asarray(out_len)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_two_images_match_oracle(tiny):
    cfg, params = tiny
    batch = _mk(cfg)
    B, N = batch["pixel_values"].shape[:2]
    pv = batch["pixel_values"].reshape(B * N, *batch["pixel_values"].shape[2:])
    cm = batch["crop_mask"].reshape(B * N, -1)
    ids_rep = jnp.repeat(batch["input_ids"], N, axis=0)
    attn_rep = jnp.repeat(batch["attention_mask"], N, axis=0)
    emb, valid = slime.encode_images(params, cfg, pv, cm, ids_rep, attn_rep)
    emb = np.asarray(emb).reshape(B, N, emb.shape[1], -1)
    valid = np.asarray(valid).reshape(B, N, -1)

    fused = slime.prepare_multimodal_multi(
        params, cfg, batch["input_ids"], batch["attention_mask"],
        batch["pixel_values"], batch["crop_mask"], batch["labels"], max_len=256)
    ref_e, ref_l, ref_len = _oracle(cfg, params, batch, emb, valid, 256)
    np.testing.assert_array_equal(np.asarray(fused.lengths), ref_len)
    np.testing.assert_allclose(np.asarray(fused.embeds), ref_e, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(fused.labels), ref_l)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_single_image_matches_n1_path(tiny):
    cfg, params = tiny
    batch = _mk(cfg, B=1, N=1, sent_at=((4,),))
    f_multi = slime.prepare_multimodal_multi(
        params, cfg, batch["input_ids"], batch["attention_mask"],
        batch["pixel_values"], batch["crop_mask"], batch["labels"], max_len=200)
    f_single = slime.prepare_multimodal(
        params, cfg, batch["input_ids"], batch["attention_mask"],
        batch["pixel_values"][:, 0], batch["crop_mask"][:, 0],
        batch["labels"], max_len=200)
    np.testing.assert_array_equal(np.asarray(f_multi.lengths),
                                  np.asarray(f_single.lengths))
    np.testing.assert_allclose(np.asarray(f_multi.embeds),
                               np.asarray(f_single.embeds), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(f_multi.labels),
                                  np.asarray(f_single.labels))


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_more_images_than_sentinels(tiny):
    """Extra provided images (no matching sentinel) contribute nothing."""
    cfg, params = tiny
    batch = _mk(cfg, B=1, N=2, sent_at=((4, -1),))  # only one sentinel
    fused = slime.prepare_multimodal_multi(
        params, cfg, batch["input_ids"], batch["attention_mask"],
        batch["pixel_values"], batch["crop_mask"], batch["labels"], max_len=256)
    batch1 = dict(batch)
    fused1 = slime.prepare_multimodal_multi(
        params, cfg, batch["input_ids"], batch["attention_mask"],
        batch["pixel_values"][:, :1], batch["crop_mask"][:, :1],
        batch["labels"], max_len=256)
    np.testing.assert_array_equal(np.asarray(fused.lengths),
                                  np.asarray(fused1.lengths))
    np.testing.assert_allclose(np.asarray(fused.embeds),
                               np.asarray(fused1.embeds), atol=1e-5)
