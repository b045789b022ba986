"""Parity: JAX CLIP ViT vs HF CLIPVisionModel (random small config, fp32 CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from slime_jax import checkpoint as ckpt
from slime_jax.config import VisionConfig
from slime_jax.models import vit


@pytest.fixture(scope="module")
def small():
    cfg = VisionConfig(image_size=56, patch_size=14, hidden_size=64,
                       intermediate_size=128, num_layers=4, num_heads=4,
                       select_layer=-2)
    hf_cfg = transformers.CLIPVisionConfig(
        image_size=56, patch_size=14, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(hf_cfg).float().eval()
    sd = {k: ckpt._np(v) for k, v in hf.state_dict().items()}
    params = ckpt.to_jax(ckpt.convert_clip_vision(sd, cfg, prefix="vision_model."))
    return cfg, hf, params


def test_vit_penultimate_patch_features(small):
    cfg, hf, params = small
    x = torch.randn(3, 3, 56, 56)
    with torch.no_grad():
        out = hf(x, output_hidden_states=True)
        ref = out.hidden_states[cfg.select_layer][:, 1:].numpy()
    ours = vit.apply(params, jnp.asarray(x.numpy()), cfg)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=3e-4, rtol=1e-3)


def test_vit_select_layer_minus_one(small):
    cfg, hf, params = small
    cfg1 = VisionConfig(**{**cfg.__dict__, "select_layer": -1})
    x = torch.randn(2, 3, 56, 56)
    with torch.no_grad():
        ref = hf(x, output_hidden_states=True).hidden_states[-1][:, 1:].numpy()
    ours = vit.apply(params, jnp.asarray(x.numpy()), cfg1)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=3e-4, rtol=1e-3)


def test_pack_qkv_tower_exact(small):
    """fp QKV packing (one [3E,E] dot) is numerically identical to the
    separate q/k/v projections — the inference-time encode transform."""
    cfg, _, params = small
    packed = vit.pack_qkv_tower(params, cfg)
    n_run = cfg.num_layers + cfg.select_layer + 1
    for i, lp in enumerate(packed["layers"]):
        if i < n_run:
            assert "qkv" in lp and "q_proj" not in lp
        else:
            assert "q_proj" in lp
    x = jnp.asarray(np.random.default_rng(0)
                    .standard_normal((2, 3, 56, 56)).astype(np.float32))
    a = vit.apply(params, x, cfg)
    b = vit.apply(packed, x, cfg)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
