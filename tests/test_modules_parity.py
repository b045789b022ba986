"""Golden-tensor parity: JAX modules vs reference torch modules (CPU, fp32).

Weights are copied from randomly-initialized torch reference modules into our
pytrees via the checkpoint converter, then outputs are compared.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from slime_jax import checkpoint as ckpt
from slime_jax.config import SliMEConfig, VisionConfig
from slime_jax.models import projector as proj_mod
from slime_jax.models import resampler as res_mod
from slime_jax.models import sampler as samp_mod

from .ref_loader import load_ref_model_modules

ref_sampler, ref_projector, ref_resampler_builder = load_ref_model_modules()

MM_HIDDEN = 256   # stand-in for 1024 (keeps tests fast); heads = dim/128
LLM_HIDDEN = 384


def _cfg(**kw):
    base = dict(
        mm_projector_type="gated", mm_resampler_type="cosine",
        mm_resampler_dim=16, mm_resampler_topp=0.9, mm_resampler_temp=1.0,
        mm_learnable_gated=-1,
    )
    base.update(kw)
    vision = VisionConfig(hidden_size=MM_HIDDEN)
    from slime_jax.config import LLMConfig
    llm = LLMConfig(hidden_size=LLM_HIDDEN)
    return SliMEConfig(llm=llm, vision=vision, **base)


def _ref_cfg_ns(cfg: SliMEConfig):
    return types.SimpleNamespace(
        mm_hidden_size=cfg.mm_hidden_size, hidden_size=cfg.hidden_size,
        mm_learnable_gated=cfg.mm_learnable_gated,
        mm_resampler_dim=cfg.mm_resampler_dim, mm_resampler_topp=cfg.mm_resampler_topp,
        mm_resampler_temp=cfg.mm_resampler_temp, pad_token_id=0,
        mm_projector_type=cfg.mm_projector_type)


def _sd(module):
    return {k: ckpt._np(v) for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def torch_seed():
    torch.manual_seed(0)
    return 0


def test_resampler_parity(torch_seed):
    torch.manual_seed(1)
    grid = 4
    ref = ref_sampler.Resampler(grid_size=grid, embed_dim=MM_HIDDEN,
                                num_heads=MM_HIDDEN // 128, kv_dim=MM_HIDDEN,
                                llm_hidden_size=LLM_HIDDEN).float().eval()
    x = torch.randn(3, 64, MM_HIDDEN)  # 64 tokens -> src grid 8x8 != 4x4 queries
    with torch.no_grad():
        ref_out = ref(x).numpy()

    params = ckpt.to_jax(ckpt.convert_resampler(_sd(ref)))
    ours = res_mod.apply(params, jnp.asarray(x.numpy()), num_heads=MM_HIDDEN // 128)
    np.testing.assert_allclose(np.asarray(ours), ref_out, atol=2e-4, rtol=1e-3)


def test_gated_projector_parity_all_modes(torch_seed):
    for learnable in (-1, 0, 1):
        torch.manual_seed(2)
        cfg = _cfg(mm_learnable_gated=learnable)
        ref = ref_projector.GatedBlock(_ref_cfg_ns(cfg)).float().eval()
        x = torch.randn(2, 576, MM_HIDDEN)
        with torch.no_grad():
            ref_out = ref(x).float().numpy()
        params = ckpt.to_jax(ckpt.convert_projector(_sd(ref), cfg))
        ours = proj_mod.apply(params, jnp.asarray(x.numpy()), cfg=cfg)
        np.testing.assert_allclose(np.asarray(ours), ref_out, atol=5e-4, rtol=1e-3,
                                   err_msg=f"learnable={learnable}")


def test_gated_projector_non576_fallback(torch_seed):
    torch.manual_seed(3)
    cfg = _cfg()
    ref = ref_projector.GatedBlock(_ref_cfg_ns(cfg)).float().eval()
    x = torch.randn(2, 16, MM_HIDDEN)  # != 576 -> plain MLP path
    with torch.no_grad():
        ref_out = ref(x).float().numpy()
    params = ckpt.to_jax(ckpt.convert_projector(_sd(ref), cfg))
    ours = proj_mod.apply(params, jnp.asarray(x.numpy()), cfg=cfg)
    np.testing.assert_allclose(np.asarray(ours), ref_out, atol=5e-4, rtol=1e-3)


def test_mlp_projector_parity(torch_seed):
    torch.manual_seed(4)
    cfg = _cfg(mm_projector_type="mlp2x_gelu")
    ref_cfg = _ref_cfg_ns(cfg)
    ref = ref_projector.build_vision_projector(ref_cfg).float().eval()
    x = torch.randn(2, 10, MM_HIDDEN)
    with torch.no_grad():
        ref_out = ref(x).numpy()
    params = ckpt.to_jax(ckpt.convert_projector(_sd(ref), cfg))
    ours = proj_mod.apply(params, jnp.asarray(x.numpy()), cfg=cfg)
    np.testing.assert_allclose(np.asarray(ours), ref_out, atol=2e-4, rtol=1e-3)


def test_post_qformer_compress_parity(torch_seed):
    torch.manual_seed(5)
    cfg = _cfg()
    ref = ref_resampler_builder.TextGuidedSampler("cosine", _ref_cfg_ns(cfg)).float().eval()
    crops = torch.randn(4, 64, MM_HIDDEN)
    with torch.no_grad():
        ref_out = ref.post_qformer(crops).numpy()
    params = ckpt.to_jax(ckpt.convert_sampler(_sd(ref), cfg))
    ours = samp_mod.compress(params, jnp.asarray(crops.numpy()), cfg=cfg)
    np.testing.assert_allclose(np.asarray(ours), ref_out, atol=2e-4, rtol=1e-3)


def test_topp_selection_parity(torch_seed):
    """Our static keep-mask must select the same token set the reference gathers."""
    torch.manual_seed(6)
    cfg = _cfg(mm_resampler_topp=0.7)
    ref = ref_resampler_builder.TextGuidedSampler("cosine", _ref_cfg_ns(cfg)).float().eval()
    M, L = 48, 12
    local = torch.randn(M, LLM_HIDDEN)
    text = torch.randn(L, LLM_HIDDEN)
    mask = torch.ones(L, dtype=torch.bool)
    mask[8:] = False
    with torch.no_grad():
        ref_sel = ref(local, text_embedding=text, attn_mask=mask).numpy()

    params = ckpt.to_jax(ckpt.convert_sampler(_sd(ref), cfg))
    keep, _ = samp_mod.select(
        params, jnp.asarray(local.numpy()), jnp.asarray(text.numpy()),
        jnp.asarray(mask.numpy()), jnp.ones(M, bool), cfg=cfg)
    ours_sel = np.asarray(jnp.asarray(local.numpy())[np.asarray(keep)])
    np.testing.assert_allclose(ours_sel, ref_sel, atol=1e-5)


def test_topp_selection_with_invalid_tokens(torch_seed):
    """Invalid (padded-crop) tokens must never be selected and not perturb k."""
    torch.manual_seed(7)
    cfg = _cfg(mm_resampler_topp=0.8)
    ref = ref_resampler_builder.TextGuidedSampler("cosine", _ref_cfg_ns(cfg)).float().eval()
    M_real, M_pad = 32, 16
    local_real = torch.randn(M_real, LLM_HIDDEN)
    text = torch.randn(10, LLM_HIDDEN)
    tmask = torch.ones(10, dtype=torch.bool)
    with torch.no_grad():
        ref_sel = ref(local_real, text_embedding=text, attn_mask=tmask).numpy()

    params = ckpt.to_jax(ckpt.convert_sampler(_sd(ref), cfg))
    local_padded = np.concatenate([local_real.numpy(),
                                   np.zeros((M_pad, LLM_HIDDEN), np.float32)])
    valid = np.concatenate([np.ones(M_real, bool), np.zeros(M_pad, bool)])
    keep, _ = samp_mod.select(
        params, jnp.asarray(local_padded), jnp.asarray(text.numpy()),
        jnp.asarray(tmask.numpy()), jnp.asarray(valid), cfg=cfg)
    keep = np.asarray(keep)
    assert not keep[M_real:].any()
    np.testing.assert_allclose(local_padded[keep], ref_sel, atol=1e-5)
