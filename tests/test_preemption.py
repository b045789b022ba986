"""Preemption-safe training: SIGTERM mid-run -> durable state save -> resume.

The reference's only training fault tolerance is HF Trainer periodic-checkpoint
resume (SURVEY.md §5); a preempted spot VM loses everything since the last
save_steps boundary. slime_jax.train.preemption latches SIGTERM and the trainer
writes a final state-<step> checkpoint at the next step boundary.
"""
import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.models import slime
from slime_jax.train import state_ckpt
from slime_jax.train.optim import TrainConfig
from slime_jax.train.preemption import PreemptionGuard
from slime_jax.train.trainer import RunConfig, Trainer


def _batch(cfg, B=2, S=10, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    return {"input_ids": ids,
            "attention_mask": np.ones((B, S), bool),
            "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((B, MC), bool),
            "labels": labels}


def test_guard_latches_and_restores_handler():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard() as g:
            assert not g.triggered
            os.kill(os.getpid(), signal.SIGTERM)
            # the handler only sets a flag; no exception, no I/O
            assert g.triggered
        # previous handler restored on exit
        assert signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_sigterm_saves_state_and_resumes(tmp_path):
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    tc = TrainConfig(total_steps=50, learning_rate=1e-3)
    out = str(tmp_path / "run")
    # prefetch_depth=0: with the background input pipeline the producer runs
    # ahead of consumption, so a generator-side SIGTERM lands at a
    # nondeterministic consumed-step count; the synchronous path keeps this
    # test's step arithmetic exact (the save/resume contract is identical).
    rc = RunConfig(output_dir=out, save_steps=0, log_steps=100, max_steps=50,
                   prefetch_depth=0)
    tr = Trainer(params, cfg, tc, rc, compute_dtype=jnp.float32)

    kill_at = 3

    def batches():
        b = _batch(cfg)
        for i in range(50):
            if i == kill_at:  # "platform reclaims the VM" mid-run
                os.kill(os.getpid(), signal.SIGTERM)
            yield dict(b)

    tr.train(batches())  # returns instead of dying
    step = int(tr.state["step"])
    assert step == kill_at, "trainer should stop at the next step boundary"

    ck = state_ckpt.latest_checkpoint(out)
    assert ck is not None and ck.endswith(f"state-{step}")
    assert state_ckpt.load_meta(ck).get("preempted") is True

    # next boot: auto-discovery resumes bit-exactly from the preemption save
    tr2 = Trainer(params, cfg, tc,
                  RunConfig(output_dir=out, save_steps=0, log_steps=100,
                            max_steps=50),
                  compute_dtype=jnp.float32)
    assert int(tr2.state["step"]) == step
    got = jax.tree_util.tree_leaves(tr2.state["params"])
    want = jax.tree_util.tree_leaves(tr.state["params"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # and training continues from there
    tr2.train(iter([_batch(cfg)]))
    assert int(tr2.state["step"]) == step + 1
