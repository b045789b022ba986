"""Trainer orchestration tests: loss decreases on an overfit batch; staged
pipeline (stage1 -> stage2 -> stage3 -> SFT) runs with the right params moving;
checkpoint round-trips through the reference key names."""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax import checkpoint as ckpt
from slime_jax.config import SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.models import slime
from slime_jax.train.optim import TrainConfig
from slime_jax.train.trainer import RunConfig, Trainer, run_stage


def _batches(cfg, n, B=4, S=12, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    pix = rng.standard_normal((B, MC, 3, t, t)).astype(np.float32)
    cmask = np.ones((B, MC), bool)
    batch = {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
             "pixel_values": pix, "crop_mask": cmask, "labels": labels}
    return [dict(batch) for _ in range(n)]


@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


@pytest.mark.slow
def test_overfit_single_batch(tiny, tmp_path):
    cfg, params = tiny
    tc = TrainConfig(total_steps=30, learning_rate=5e-3, warmup_ratio=0.1,
                     tune_mm_mlp_adapter=False)
    rc = RunConfig(output_dir=str(tmp_path), save_steps=0, log_steps=5,
                   max_steps=25)
    tr = Trainer(params, cfg, tc, rc, compute_dtype=jnp.float32)
    batches = _batches(cfg, 25)
    first = None
    # capture loss trajectory via metrics file
    tr.train(batches)
    recs = [json.loads(l) for l in open(tr.metrics_file)]
    assert recs[-1]["loss"] < recs[0]["loss"] * 0.8, recs


@pytest.mark.slow
def test_staged_pipeline(tiny, tmp_path):
    cfg, params = tiny
    stages = [
        # stage 1: global-only, MLP expert (llama3_8b_pt.sh:7-47)
        (SliMEConfig(**{**cfg.__dict__, "use_global_only": True,
                        "mm_learnable_gated": 0}),
         TrainConfig(total_steps=3, learning_rate=1e-3, mm_projector_lr=1e-3,
                     tune_mm_mlp_adapter=True, mm_learnable_gated=0)),
        # stage 2: attention-adapter expert
        (SliMEConfig(**{**cfg.__dict__, "use_global_only": True,
                        "mm_learnable_gated": 1}),
         TrainConfig(total_steps=3, learning_rate=1e-3, mm_projector_lr=1e-3,
                     tune_mm_mlp_adapter=True, mm_learnable_gated=1)),
        # stage 3: local compression layer
        (SliMEConfig(**{**cfg.__dict__, "use_local_only": True}),
         TrainConfig(total_steps=3, learning_rate=1e-3, mm_projector_lr=1e-3,
                     tune_mm_mlp_adapter=True)),
        # SFT: everything trains
        (cfg, TrainConfig(total_steps=3, learning_rate=1e-4)),
    ]
    p = params
    for i, (scfg, tc) in enumerate(stages):
        rc = RunConfig(output_dir=str(tmp_path / f"s{i}"), save_steps=0,
                       log_steps=100, max_steps=3)
        p, metrics = run_stage(p, scfg, tc, rc, _batches(scfg, 3))
        assert np.isfinite(metrics["loss"])
    # after SFT the llm moved
    assert not np.array_equal(np.asarray(p["llm"]["embed_tokens"]),
                              np.asarray(params["llm"]["embed_tokens"]))


def test_checkpoint_roundtrip(tiny, tmp_path):
    cfg, params = tiny
    path = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(path, params, cfg)
    assert os.path.exists(os.path.join(path, "config.json"))

    cfg2 = SliMEConfig.load(path)
    assert cfg2.mm_projector_type == cfg.mm_projector_type
    assert cfg2.llm.hidden_size == cfg.llm.hidden_size

    sd = ckpt.load_sharded_state_dict(path)
    assert "model.mm_projector.w_gate" in sd
    assert "model.sampler.post_qformer.query" in sd
    p2 = ckpt.load_pretrained(path, cfg=cfg2)
    np.testing.assert_allclose(
        np.asarray(p2["llm"]["embed_tokens"]),
        np.asarray(params["llm"]["embed_tokens"]), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(p2["projector"]["w_gate"]),
        np.asarray(params["projector"]["w_gate"]), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(p2["vision"]["class_embedding"]),
        np.asarray(params["vision"]["class_embedding"]), atol=1e-6)


def test_adapter_only_checkpoint(tiny, tmp_path):
    import torch
    cfg, params = tiny
    path = str(tmp_path / "adapters")
    ckpt.save_checkpoint(path, params, cfg, adapters_only=True)
    assert os.path.exists(os.path.join(path, "mm_projector.bin"))
    assert os.path.exists(os.path.join(path, "sampler.bin"))
    sd = torch.load(os.path.join(path, "mm_projector.bin"), weights_only=True)
    assert "model.mm_projector.projection.0.weight" in sd


@pytest.mark.slow
def test_resume_from_state_checkpoint(tiny, tmp_path):
    """Interrupt-and-resume: optimizer state and step counter round-trip."""
    cfg, params = tiny
    tc = TrainConfig(total_steps=8, learning_rate=1e-3)
    rc = RunConfig(output_dir=str(tmp_path / "run"), save_steps=2, log_steps=100,
                   max_steps=4)
    tr = Trainer(params, cfg, tc, rc, compute_dtype=jnp.float32)
    tr.train(_batches(cfg, 4))
    assert int(tr.state["step"]) == 4

    # new trainer in the same output dir picks up state-4
    tr2 = Trainer(params, cfg, tc,
                  RunConfig(output_dir=str(tmp_path / "run"), save_steps=0,
                            log_steps=100, max_steps=6),
                  compute_dtype=jnp.float32)
    assert int(tr2.state["step"]) == 4
    np.testing.assert_allclose(
        np.asarray(tr2.state["params"]["llm"]["embed_tokens"]),
        np.asarray(tr.state["params"]["llm"]["embed_tokens"]), atol=1e-6)
    tr2.train(_batches(cfg, 2))
    assert int(tr2.state["step"]) == 6


@pytest.mark.slow
def test_async_save_roundtrip(tmp_path):
    """async_save=True persists a restorable train state (wait_for_saves joins)."""
    import jax
    from slime_jax.train import state_ckpt

    state = {"step": jax.numpy.asarray(3),
             "params": {"w": jax.numpy.ones((4, 4))}}
    p = str(tmp_path / "state-3")
    state_ckpt.save_train_state(p, state, extra={"step": 3}, async_save=True)
    state_ckpt.wait_for_saves()
    back = state_ckpt.restore_train_state(p, target=state)
    assert int(back["step"]) == 3
    assert float(back["params"]["w"].sum()) == 16.0
    assert state_ckpt.load_meta(p) == {"step": 3}
