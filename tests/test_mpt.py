"""MPT decoder parity vs HF MptForCausalLM (small random config, fp32 CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from slime_jax.models import mpt


def test_mpt_logits_parity():
    cfg = mpt.MPTConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                        max_seq_len=128)
    hf_cfg = transformers.MptConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, max_seq_len=128,
        expansion_ratio=4, attn_config=transformers.models.mpt.configuration_mpt
        .MptAttentionConfig(attn_impl="torch", alibi=True))
    torch.manual_seed(0)
    hf = transformers.MptForCausalLM(hf_cfg).float().eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    params = mpt.convert_hf(sd, cfg)

    ids = torch.randint(0, 256, (2, 20))
    with torch.no_grad():
        ref = hf(ids).logits.numpy()
    ours = mpt.forward(params, jnp.asarray(ids.numpy()), cfg)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=3e-4, rtol=1e-3)


def test_alibi_slopes_shape():
    s = mpt.alibi_slopes(12)  # non-power-of-two head count
    assert s.shape == (12,)
    assert float(s[0]) > float(s[1]) > 0
