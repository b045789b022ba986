"""LoRA / QLoRA training: factored forward parity, adapter-only train steps
(bf16 and quantized base), and the reference-layout LoRA checkpoint round trip
(adapter_model.bin + adapter_config.json + non_lora_trainables.bin,
reference train.py:1185-1196 / builder.py:52-91)."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax import checkpoint as ckpt
from slime_jax.config import SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.models import slime
from slime_jax.ops.quantization import quantize_params
from slime_jax.train import lora
from slime_jax.train.optim import TrainConfig
from slime_jax.train.step import init_lora_train_state, make_lora_train_step


@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)
    return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
            "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((B, MC), bool), "labels": labels}


def _nonzero_lora(params, r=4, alpha=8):
    """init_lora zeros B (standard LoRA init) — randomize it so the adapter
    actually changes the forward and parity tests are non-trivial."""
    state = lora.init_lora(jax.random.PRNGKey(1), params, r=r, alpha=alpha)
    k = jax.random.PRNGKey(2)
    for i, (p, ab) in enumerate(sorted(state["adapters"].items())):
        ab["B"] = jax.random.normal(jax.random.fold_in(k, i),
                                    ab["B"].shape, jnp.float32) * 0.05
    return state


def test_attach_matches_materialized(tiny):
    """Factored application (linear's 'lora' entry) == W + sB@A materialized."""
    cfg, params = tiny
    state = _nonzero_lora(params)
    batch = _batch(cfg)

    def logits(p):
        out = slime.forward(p, cfg, batch["input_ids"], batch["attention_mask"],
                            batch["pixel_values"], batch["crop_mask"],
                            training=False)
        return np.asarray(out[0], np.float32)

    fact = logits(lora.attach(params, state))
    mat = logits(lora.apply_to_params(params, state))
    base = logits(params)
    assert np.abs(fact - mat).max() < 1e-3, np.abs(fact - mat).max()
    assert np.abs(fact - base).max() > 1e-3  # the adapter is actually live


def _run_steps(cfg, params, lora_state, n=4, lr=5e-3):
    tc = TrainConfig(total_steps=n, learning_rate=lr, warmup_ratio=0.0,
                     lr_schedule="constant")
    base, state, tx = init_lora_train_state(params, lora_state, tc)
    step = make_lora_train_step(cfg, tc, tx, rank=lora_state["rank"],
                                alpha=lora_state["alpha"],
                                compute_dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    losses = []
    for i in range(n):
        state, m = step(state, base, batch, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return base, state, losses


def test_lora_step_trains_adapters_only(tiny):
    cfg, params = tiny
    lora_state = lora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8)
    base, state, losses = _run_steps(cfg, params, lora_state)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    # adapters moved (B leaves start at zero, must be nonzero after training)
    bs = [np.abs(np.asarray(ab["B"])).max()
          for ab in state["params"]["adapters"].values()]
    assert max(bs) > 0
    # the frozen base is untouched bitwise
    w0 = np.asarray(params["llm"]["layers"][0]["q_proj"]["weight"])
    w1 = np.asarray(base["llm"]["layers"][0]["q_proj"]["weight"])
    np.testing.assert_array_equal(w0, w1)
    # extras (projector) trained — some leaf must have moved
    moved = max(
        float(np.abs(np.asarray(a) - np.asarray(b)).max())
        for a, b in zip(jax.tree_util.tree_leaves(params["projector"]),
                        jax.tree_util.tree_leaves(
                            state["params"]["extras"]["projector"])))
    assert moved > 0


@pytest.mark.parametrize(
    "bits", [8, pytest.param(4, marks=pytest.mark.slow)])  # heavy: compile-bound
def test_qlora_quantized_base(tiny, bits):
    """QLoRA: int8/int4 frozen base + fp adapters; gradients flow, loss drops."""
    cfg, params = tiny
    qparams = dict(params)
    qparams["llm"] = dict(params["llm"])
    qparams["llm"]["layers"] = quantize_params(params["llm"]["layers"], bits,
                                               min_size=0)
    lora_state = lora.init_lora(jax.random.PRNGKey(1), qparams, r=4, alpha=8)
    assert lora_state["adapters"], "no targets found on the quantized base"
    base, state, losses = _run_steps(cfg, qparams, lora_state, n=4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.slow
def test_qlora_sharded_mesh(tiny):
    """QLoRA under a (fsdp=4, tp=2) mesh: quantized base leaves shard by the
    base weight's rule, adapters by the A/B rules, and the step runs."""
    from slime_jax.parallel import mesh as mesh_lib

    cfg, params = tiny
    qparams = dict(params)
    qparams["llm"] = dict(params["llm"])
    qparams["llm"]["layers"] = quantize_params(params["llm"]["layers"], 8,
                                               min_size=0)
    lora_state = lora.init_lora(jax.random.PRNGKey(1), qparams, r=4, alpha=8)
    mesh = mesh_lib.make_mesh(1, 4, 2)
    tc = TrainConfig(total_steps=2, learning_rate=5e-3, warmup_ratio=0.0,
                     lr_schedule="constant")
    base, state, tx = init_lora_train_state(qparams, lora_state, tc, mesh=mesh)
    # quantized leaves inherit the BASE weight's rule: q_proj q [128,128] gets
    # P("model","fsdp") like the fp weight would; its scale keeps the out axis
    from jax.sharding import PartitionSpec as P
    qw = base["llm"]["layers"][0]["q_proj"]["weight"]
    assert qw["q"].sharding.spec == P("model", "fsdp"), qw["q"].sharding
    assert qw["scale"].sharding.spec in (P("model"), P("model", None)), \
        qw["scale"].sharding
    # adapters shard their full-width dim on fsdp
    a_leaf = state["params"]["adapters"]["llm/layers/0/q_proj"]["A"]
    assert a_leaf.sharding.spec == P(None, "fsdp"), a_leaf.sharding
    step = make_lora_train_step(cfg, tc, tx, rank=4, alpha=8,
                                compute_dtype=jnp.float32)
    batch = mesh_lib.shard_batch(mesh, _batch(cfg, B=4))
    losses = []
    for i in range(2):
        state, m = step(state, base, batch, jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses


def test_lora_checkpoint_roundtrip(tiny, tmp_path):
    """save_lora_checkpoint -> load_pretrained(model_base=...) == lora.merge."""
    cfg, params = tiny
    state = _nonzero_lora(params)
    base_dir = os.path.join(tmp_path, "base")
    lora_dir = os.path.join(tmp_path, "slime-lora")
    ckpt.save_checkpoint(base_dir, params, cfg)
    ckpt.save_lora_checkpoint(
        lora_dir, {"projector": params["projector"],
                   "sampler": params.get("sampler")},
        state, cfg)
    for f in ("adapter_config.json", "adapter_model.bin",
              "non_lora_trainables.bin", "config.json"):
        assert os.path.exists(os.path.join(lora_dir, f)), f
    loaded = ckpt.to_jax(ckpt.load_pretrained(lora_dir, model_base=base_dir,
                                              cfg=cfg))
    merged = lora.merge(params, state)
    for path in list(state["adapters"])[:3]:
        got = np.asarray(lora._get(loaded, path)["weight"], np.float32)
        want = np.asarray(lora._get(merged, path)["weight"], np.float32)
        np.testing.assert_allclose(got, want, atol=2e-3, err_msg=path)


def test_trainer_lora_resume(tiny, tmp_path):
    """Orbax train-state save/resume round-trips the LoRA trainable tree:
    a restarted Trainer picks up adapters + extras + Adam moments."""
    from slime_jax.train.trainer import RunConfig, Trainer

    cfg, params = tiny
    lora_state = lora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8)
    tc = TrainConfig(total_steps=4, learning_rate=5e-3, warmup_ratio=0.0,
                     lr_schedule="constant")
    rc = RunConfig(output_dir=str(tmp_path), save_steps=2, log_steps=1,
                   max_steps=2)
    tr = Trainer(params, cfg, tc, rc, compute_dtype=jnp.float32,
                 lora=lora_state)
    tr.train([_batch(cfg) for _ in range(2)])
    a_before = np.asarray(
        tr.state["params"]["adapters"]["llm/layers/0/q_proj"]["B"])
    # fresh trainer in the same dir resumes from state-2
    tr2 = Trainer(params, cfg, tc, rc, compute_dtype=jnp.float32,
                  lora=lora_state)
    assert int(tr2.state["step"]) == 2
    a_after = np.asarray(
        tr2.state["params"]["adapters"]["llm/layers/0/q_proj"]["B"])
    np.testing.assert_array_equal(a_before, a_after)


def test_trainer_lora_mode(tiny, tmp_path):
    """Trainer(lora=...) end-to-end: trains, saves the LoRA layout, and
    params_host returns the merged view."""
    from slime_jax.train.trainer import RunConfig, Trainer

    cfg, params = tiny
    lora_state = lora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8)
    tc = TrainConfig(total_steps=6, learning_rate=5e-3, warmup_ratio=0.0,
                     lr_schedule="constant")
    rc = RunConfig(output_dir=str(tmp_path), save_steps=0, log_steps=2,
                   max_steps=6)
    tr = Trainer(params, cfg, tc, rc, compute_dtype=jnp.float32,
                 lora=lora_state)
    import json
    batches = [_batch(cfg) for _ in range(6)]
    tr.train(batches)
    recs = [json.loads(l) for l in open(tr.metrics_file)]
    assert recs[-1]["loss"] < recs[0]["loss"], recs
    out = os.path.join(tmp_path, "save")
    tr.save(out)
    assert os.path.exists(os.path.join(out, "adapter_model.bin"))
    merged = tr.params_host()
    assert "llm" in merged and "projector" in merged
