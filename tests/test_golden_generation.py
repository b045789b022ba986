"""Fixed-seed end-to-end generation golden (SURVEY §4: the regression net the
reference never had). Any change to preprocessing, fusion, splicing, the decoder,
or decode sampling that alters numerics shows up here first.

The golden was recorded on CPU fp32 with PRNGKey(0)-initialized tiny params and
rng(42) inputs. If an INTENTIONAL numerics change invalidates it, re-record with
the snippet in this file's git history and note why in the commit message.
"""
import numpy as np

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.constants import IMAGE_TOKEN_INDEX
from slime_jax.generate import generate
from slime_jax.models import slime

GOLDEN_TOKENS = [12, 413, 249, 275, 327, 70, 186, 54]


def test_multimodal_greedy_golden():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(42)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 10)).astype(np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    pix = rng.standard_normal((1, MC, 3, t, t)).astype(np.float32)
    cmask = np.ones((1, MC), bool)
    toks = generate(params, cfg, jnp.asarray(ids), jnp.ones((1, 10), bool),
                    jnp.asarray(pix), jnp.asarray(cmask),
                    max_new_tokens=8, eos_id=-1)
    assert np.asarray(toks)[0].tolist() == GOLDEN_TOKENS
