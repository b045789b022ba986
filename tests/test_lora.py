"""LoRA tests: functional application == explicit merge; zero-init B is identity;
PEFT round-trip; gradient flow through adapters only."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_jax.models import slime
from slime_jax.train import lora


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    state = lora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8)
    return cfg, params, state


def test_targets_found(setup):
    cfg, params, state = setup
    paths = list(state["adapters"])
    assert any("q_proj" in p for p in paths)
    assert any("down_proj" in p for p in paths)
    assert all(p.startswith("llm/") for p in paths)


def test_zero_init_is_identity(setup):
    cfg, params, state = setup
    merged = lora.apply_to_params(params, state)
    w0 = np.asarray(params["llm"]["layers"][0]["q_proj"]["weight"])
    w1 = np.asarray(merged["llm"]["layers"][0]["q_proj"]["weight"])
    np.testing.assert_array_equal(w0, w1)  # B starts at zero


def test_functional_equals_merge(setup):
    cfg, params, state = setup
    # randomize B so adapters do something
    state2 = {"rank": state["rank"], "alpha": state["alpha"], "adapters": {}}
    for i, (p, ab) in enumerate(state["adapters"].items()):
        state2["adapters"][p] = {
            "A": ab["A"],
            "B": jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(2), i),
                                   ab["B"].shape) * 0.01,
        }
    fn = lora.apply_to_params(params, state2)
    mg = lora.merge(params, state2)
    for p in state2["adapters"]:
        a = np.asarray(lora._get(fn, p)["weight"])
        b = np.asarray(lora._get(mg, p)["weight"])
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_peft_roundtrip(setup):
    cfg, params, state = setup
    sd = lora.export_peft(state)
    assert any(k.endswith("lora_A.weight") for k in sd)
    back = lora.import_peft(sd, r=state["rank"], alpha=state["alpha"])
    assert set(back["adapters"]) == set(state["adapters"])
    for p in state["adapters"]:
        np.testing.assert_array_equal(np.asarray(back["adapters"][p]["A"]),
                                      np.asarray(state["adapters"][p]["A"]))


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_gradients_flow_through_adapters(setup):
    cfg, params, state = setup
    rng = np.random.default_rng(0)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (2, 10)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    batch = {
        "input_ids": jnp.asarray(ids),
        "attention_mask": jnp.ones((2, 10), bool),
        "pixel_values": jnp.asarray(rng.standard_normal((2, MC, 3, t, t)).astype(np.float32)),
        "crop_mask": jnp.asarray(np.ones((2, MC), bool)),
        "labels": jnp.asarray(np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)),
    }

    def loss(adapters):
        p = lora.apply_to_params(params, {"rank": state["rank"],
                                          "alpha": state["alpha"],
                                          "adapters": adapters})
        return slime.loss_fn(p, cfg, batch, training=False)[0]

    g = jax.grad(loss)(state["adapters"])
    ga = np.asarray(list(g.values())[0]["A"])
    assert np.isfinite(ga).all()
    gsum = sum(float(jnp.sum(jnp.abs(x))) for x in jax.tree_util.tree_leaves(g))
    assert gsum > 0
