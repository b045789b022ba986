"""Checkpoint load modes: base + adapter-only artifacts, model_base overlay,
quantized load, LM-only (no vision) load."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax import checkpoint as ckpt
from slime_jax.config import SliMEConfig
from slime_jax.models import slime


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    base = str(tmp_path_factory.mktemp("base"))
    ckpt.save_checkpoint(base, params, cfg)
    return cfg, params, base


def test_adapter_over_base(saved, tmp_path):
    """Reference mode 2 (model/builder.py:93-115): base LLM + mm_projector.bin +
    sampler.bin staged artifacts."""
    cfg, params, base = saved
    # different adapter weights saved separately
    params2 = slime.init(jax.random.PRNGKey(9), cfg)
    adir = str(tmp_path / "adapters")
    ckpt.save_checkpoint(adir, params2, cfg, adapters_only=True)
    cfg.save(adir)

    loaded = ckpt.load_pretrained(adir, model_base=base, cfg=cfg)
    # projector comes from the adapter file, llm from the base
    np.testing.assert_allclose(
        np.asarray(loaded["projector"]["w_gate"]),
        np.asarray(params2["projector"]["w_gate"]), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(loaded["llm"]["embed_tokens"]),
        np.asarray(params["llm"]["embed_tokens"]), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(loaded["sampler"]["post_qformer"]["query"]),
        np.asarray(params2["sampler"]["post_qformer"]["query"]), atol=1e-6)


def test_quantized_load(saved):
    cfg, params, base = saved
    loaded = ckpt.load_pretrained(base, cfg=cfg, load_bits=8)
    # embeddings stay fp; layer matmul weights are quant dicts
    assert not isinstance(loaded["llm"]["embed_tokens"], dict)
    qw = loaded["llm"]["layers"][0]["q_proj"]["weight"]
    from slime_jax.ops.quantization import is_quantized
    assert is_quantized(qw)

    # the quantized tree runs through the standard forward (quant-aware linear)
    from slime_jax.models import llama
    rng = np.random.default_rng(1)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 6)).astype(np.int32)
    lt = ckpt.to_jax({"llm": loaded["llm"]})["llm"]
    lq, _ = llama.forward(lt, llama.embed(lt, jnp.asarray(ids)), cfg.llm)
    lf, _ = llama.forward(params["llm"],
                          llama.embed(params["llm"], jnp.asarray(ids)), cfg.llm)
    # int8 error bound
    assert np.abs(np.asarray(lq) - np.asarray(lf)).mean() < 0.05


def test_forward_from_loaded_matches(saved):
    cfg, params, base = saved
    loaded = ckpt.to_jax(ckpt.load_pretrained(base, cfg=cfg))
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 8)).astype(np.int32)
    from slime_jax.models import llama
    l1, _ = llama.forward(params["llm"], llama.embed(params["llm"], jnp.asarray(ids)),
                          cfg.llm)
    l2, _ = llama.forward(loaded["llm"], llama.embed(loaded["llm"], jnp.asarray(ids)),
                          cfg.llm)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=1e-5)


def test_lora_load_merges(saved, tmp_path):
    """Reference mode 3 (model/builder.py:52-91): base + adapter_model LoRA
    factors (+ non_lora_trainables.bin with PEFT-wrapped key prefixes) must be
    merged at load — NOT silently dropped."""
    import json

    from slime_jax.train import lora

    cfg, params, base = saved
    r, alpha = 4, 8
    rng = jax.random.PRNGKey(3)
    state = lora.init_lora(rng, params, r=r, alpha=alpha)
    # non-trivial B so the merge visibly changes weights
    state["adapters"] = {
        p: {"A": ab["A"],
            "B": jax.random.normal(jax.random.fold_in(rng, i),
                                   ab["B"].shape) * 0.1}
        for i, (p, ab) in enumerate(state["adapters"].items())}

    ldir = tmp_path / "lora_ckpt"
    ldir.mkdir()
    peft_sd = lora.export_peft(state)
    import torch
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in peft_sd.items()},
               ldir / "adapter_model.bin")
    with open(ldir / "adapter_config.json", "w") as f:
        json.dump({"r": r, "lora_alpha": alpha}, f)
    # non_lora_trainables: projector/sampler with PEFT wrapper prefixes
    params2 = slime.init(jax.random.PRNGKey(9), cfg)
    proj_sd = ckpt.export_projector(params2["projector"], cfg,
                                    prefix="base_model.model.model.mm_projector.")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in proj_sd.items()},
               ldir / "non_lora_trainables.bin")
    cfg.save(str(ldir))

    loaded = ckpt.load_pretrained(str(ldir), model_base=base, cfg=cfg)

    # every adapter target must equal base + (alpha/r) B @ A
    scale = alpha / r
    for path, ab in state["adapters"].items():
        node_b, node_l = params, loaded
        for part in path.split("/"):
            node_b = (node_b[int(part)] if isinstance(node_b, list) else node_b[part])
            node_l = (node_l[int(part)] if isinstance(node_l, list) else node_l[part])
        want = np.asarray(node_b["weight"], np.float32) + scale * (
            np.asarray(ab["B"], np.float32) @ np.asarray(ab["A"], np.float32))
        np.testing.assert_allclose(np.asarray(node_l["weight"]), want,
                                   atol=1e-5, err_msg=path)
    # non_lora_trainables prefixes normalized -> projector from the LoRA ckpt
    np.testing.assert_allclose(np.asarray(loaded["projector"]["w_gate"]),
                               np.asarray(params2["projector"]["w_gate"]),
                               atol=1e-6)

    # without model_base, a LoRA checkpoint must refuse to load silently wrong
    with pytest.raises(ValueError, match="model_base"):
        ckpt.load_pretrained(str(ldir), cfg=cfg)


def test_quantize_lm_head_opt_in(saved):
    """--quantize-lm-head: lm_head becomes a quant dict (opt-in; the default
    matches bitsandbytes' llm_int8_skip_modules=[lm_head])."""
    cfg, params, base = saved
    from slime_jax.ops.quantization import is_quantized
    default = ckpt.load_pretrained(base, cfg=cfg, load_bits=8)
    assert not is_quantized(default["llm"]["lm_head"]["weight"])
    opted = ckpt.load_pretrained(base, cfg=cfg, load_bits=8,
                                 quantize_lm_head=True)
    assert is_quantized(opted["llm"]["lm_head"]["weight"])
