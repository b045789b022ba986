"""SliME-8B checkpoint key-set parity + bitwise round-trip.

The expected key list is constructed INDEPENDENTLY here, straight from the
reference module definitions, so a naming bug in the exporter cannot cancel
out against the same bug in the test:
  - Llama-3-8B keys: HF LlamaForCausalLM layout (no attention/mlp biases)
  - gated projector: llava/model/multimodal_projector/builder.py:38-70
    (GatedBlock: attn Resampler without kv_proj/proj + projection Sequential +
    w_gate/w_noise + persistent mean/std buffers)
  - cosine sampler: llava/model/multimodal_resampler/builder.py:221-246
    (TextGuidedSampler: paramless cosine selector + post_qformer Resampler;
    use_post_proj defaults to False in sampler.py:108 and is never overridden,
    so there is NO proj — outputs stay at mm_hidden and go through
    mm_projector, llava_arch.py:226-227 — and kv_dim == embed_dim means no
    kv_proj either)
  - vision tower: HF CLIPVisionModel under model.vision_tower.vision_tower.
    (incl. the pre_layrnorm typo and post_layernorm)

Save paths matched: llava/train/llava_trainer.py:248-276 (mm_projector.bin /
sampler.bin) and train.py:1185-1196. Layer counts are the real SliME-8B ones
(32 LLM / 24 ViT); widths are shrunk so the suite stays fast — key NAMES only
depend on depth, never width.
"""
import dataclasses
import os

import numpy as np
import pytest

import jax

from slime_jax import checkpoint as ckpt
from slime_jax.config import LLMConfig, SliMEConfig, VisionConfig
from slime_jax.models import slime

N_LLM_LAYERS = 32   # Llama-3-8B
N_VIT_LAYERS = 24   # CLIP-L/336


def _resampler_keys(prefix, *, post_proj):
    ks = {f"{prefix}pos_embed", f"{prefix}query",
          f"{prefix}attn.in_proj_weight", f"{prefix}attn.in_proj_bias",
          f"{prefix}attn.out_proj.weight", f"{prefix}attn.out_proj.bias"}
    for ln in ("ln_q", "ln_kv", "ln_post"):
        ks |= {f"{prefix}{ln}.weight", f"{prefix}{ln}.bias"}
    if post_proj:
        ks |= {f"{prefix}proj.weight", f"{prefix}proj.bias"}
    return ks


def expected_llm_keys():
    ks = {"lm_head.weight", "model.embed_tokens.weight", "model.norm.weight"}
    for i in range(N_LLM_LAYERS):
        b = f"model.layers.{i}"
        ks |= {f"{b}.input_layernorm.weight",
               f"{b}.post_attention_layernorm.weight"}
        ks |= {f"{b}.self_attn.{p}_proj.weight" for p in "qkvo"}
        ks |= {f"{b}.mlp.{p}_proj.weight" for p in ("gate", "up", "down")}
    return ks


def expected_projector_keys():
    mp = "model.mm_projector."
    ks = _resampler_keys(mp + "attn.", post_proj=False)
    ks |= {mp + "projection.0.weight", mp + "projection.0.bias",
           mp + "projection.2.weight", mp + "projection.2.bias",
           mp + "w_gate", mp + "w_noise", mp + "mean", mp + "std"}
    return ks


def expected_sampler_keys():
    return _resampler_keys("model.sampler.post_qformer.", post_proj=False)


def expected_vision_keys():
    vp = "model.vision_tower.vision_tower.vision_model."
    ks = {vp + "embeddings.class_embedding",
          vp + "embeddings.patch_embedding.weight",
          vp + "embeddings.position_embedding.weight",
          vp + "pre_layrnorm.weight", vp + "pre_layrnorm.bias",
          vp + "post_layernorm.weight", vp + "post_layernorm.bias"}
    for i in range(N_VIT_LAYERS):
        b = f"{vp}encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            ks |= {f"{b}.{ln}.weight", f"{b}.{ln}.bias"}
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            ks |= {f"{b}.self_attn.{p}.weight", f"{b}.self_attn.{p}.bias"}
        for p in ("fc1", "fc2"):
            ks |= {f"{b}.mlp.{p}.weight", f"{b}.mlp.{p}.bias"}
    return ks


@pytest.fixture(scope="module")
def model_8b_depth():
    tiny = SliMEConfig.tiny()
    cfg = dataclasses.replace(
        tiny,
        llm=dataclasses.replace(LLMConfig.tiny(), num_layers=N_LLM_LAYERS),
        vision=dataclasses.replace(tiny.vision, num_layers=N_VIT_LAYERS))
    assert cfg.mm_projector_type == "gated"
    assert cfg.mm_resampler_type == "cosine"
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def test_export_key_set_is_exactly_slime_8b(model_8b_depth):
    cfg, params = model_8b_depth
    got = set(ckpt.export_state_dict(params, cfg))
    want = (expected_llm_keys() | expected_projector_keys()
            | expected_sampler_keys() | expected_vision_keys())
    missing = sorted(want - got)
    extra = sorted(got - want)
    assert not missing and not extra, (
        f"key-set drift vs the reference SliME-8B checkpoint:\n"
        f"  missing ({len(missing)}): {missing[:10]}\n"
        f"  extra   ({len(extra)}): {extra[:10]}")


def test_adapter_files_carry_exact_key_sets(model_8b_depth, tmp_path):
    """The staged-pretrain artifacts must be loadable by the reference's strict
    key matching (builder.py:93-115 consumes them verbatim)."""
    import torch
    cfg, params = model_8b_depth
    adir = str(tmp_path / "adapters")
    ckpt.save_checkpoint(adir, params, cfg, adapters_only=True)
    mm = torch.load(os.path.join(adir, "mm_projector.bin"), weights_only=True)
    assert set(mm) == expected_projector_keys()
    samp = torch.load(os.path.join(adir, "sampler.bin"), weights_only=True)
    assert set(samp) == expected_sampler_keys()


def test_bitwise_roundtrip_through_save_and_all_key_groups(model_8b_depth,
                                                           tmp_path):
    """save -> load_pretrained -> export must reproduce every tensor bitwise;
    any mis-mapped key (swapped layer, transposed weight, dropped bias) breaks
    this for some array."""
    cfg, params = model_8b_depth
    d = str(tmp_path / "full")
    ckpt.save_checkpoint(d, params, cfg)
    sd_before = ckpt.export_state_dict(params, cfg)

    loaded = ckpt.load_pretrained(d, cfg=cfg)
    sd_after = ckpt.export_state_dict(loaded, cfg)

    assert set(sd_before) == set(sd_after)
    bad = [k for k in sd_before
           if not np.array_equal(np.asarray(sd_before[k], np.float32),
                                 np.asarray(sd_after[k], np.float32))]
    assert not bad, f"{len(bad)} tensors changed in round-trip: {bad[:8]}"
