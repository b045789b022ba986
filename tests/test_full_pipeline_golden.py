"""FULL-pipeline golden: real HF fast tokenizer + conversation template +
anyres on a real image file + checkpoint save/load + fusion + greedy decode,
pinned token-exact (VERDICT r2 #5 — the closest honest substitute for
released-weights parity while the env is offline; guards the seams BETWEEN
components that module goldens miss). Mirrors the reference's single-shot
driver, llava/eval/run_llava.py:50-128.

Fixtures: tests/fixtures/tiny_hf_tokenizer (a REAL PreTrainedTokenizerFast,
BPE + llama3-style specials) and tests/fixtures/golden_image.png. Regenerate
with tests/make_golden_fixtures.py after INTENTIONAL changes and re-record
GOLDEN below, noting why in the commit message.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# Recorded 2026-08-17 on CPU fp32 (tests/make_golden_fixtures.py). The prompt
# renders through the llama3 template; -200 is IMAGE_TOKEN_INDEX spliced by
# tokenizer_image_token; the 300x200 fixture image slices to a 3x2 anyres grid
# capped at 7 crops.
GOLDEN = {
    "prompt_ids": [3, 358, 4, 205, 205, -200, 205, 318, 273, 303, 409, 279,
                   406, 309, 37, 5, 3, 285, 89, 387, 90, 4, 205, 205],
    "tokens": [317, 462, 196, 332, 366, 7, 482, 37],
    "text": "USER ā hi ĠDe ! ?",
    "crops_meta": {"n_crops": 7, "grid": [3, 2], "crops_sum": 57173.1},
}


def run_pipeline(tok_dir, img_path, tmp_ckpt_dir=None):
    """The run_llava.py pipeline on the tiny model: returns
    (prompt_ids, generated tokens, decoded text, crops_meta)."""
    from PIL import Image
    from transformers import AutoTokenizer

    from slime_jax import checkpoint as ckpt
    from slime_jax.config import SliMEConfig
    from slime_jax.constants import DEFAULT_IMAGE_TOKEN
    from slime_jax.conversation import conv_templates
    from slime_jax.data.image_ops import process_anyres_image_host
    from slime_jax.data.tokenization import tokenizer_image_token
    from slime_jax.generate import generate
    from slime_jax.models import slime

    tokenizer = AutoTokenizer.from_pretrained(tok_dir)
    assert tokenizer.is_fast  # a real HF tokenizer, not a toy

    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    if tmp_ckpt_dir is not None:
        # exercise the disk seam too: save -> load_pretrained
        ckpt.save_checkpoint(tmp_ckpt_dir, params, cfg)
        params = ckpt.load_pretrained(tmp_ckpt_dir, cfg=cfg)
    params = ckpt.to_jax(params)

    qs = DEFAULT_IMAGE_TOKEN + "\nWhat is shown in this image?"
    conv = conv_templates["llama3"].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    img = Image.open(img_path).convert("RGB")
    crops, mask, grid = process_anyres_image_host(
        img, tile=cfg.vision.image_size, max_crops=1 + cfg.max_local_crops)
    ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")

    toks = generate(params, cfg, jnp.asarray(ids[None]),
                    jnp.ones((1, len(ids)), bool),
                    jnp.asarray(crops[None]), jnp.asarray(mask[None]),
                    max_new_tokens=8, temperature=0.0, eos_id=-1,
                    compute_dtype=jnp.float32)
    out = np.asarray(toks)[0]
    text = tokenizer.decode(out, skip_special_tokens=True)
    crops_meta = {"n_crops": int(mask.sum()), "grid": list(grid),
                  "crops_sum": round(float(np.abs(crops).sum()), 1)}
    return ids.tolist(), out.tolist(), text, crops_meta


@pytest.fixture(scope="module")
def fixture_paths():
    tok_dir = os.path.join(FIX, "tiny_hf_tokenizer")
    img = os.path.join(FIX, "golden_image.png")
    if not (os.path.isdir(tok_dir) and os.path.exists(img)):
        pytest.skip("golden fixtures missing — run tests/make_golden_fixtures.py")
    return tok_dir, img


def test_full_pipeline_golden(fixture_paths, tmp_path):
    tok_dir, img = fixture_paths
    ids, toks, text, meta = run_pipeline(tok_dir, img,
                                         tmp_ckpt_dir=str(tmp_path / "m"))
    assert GOLDEN is not None, "record GOLDEN via tests/make_golden_fixtures.py"
    assert ids == GOLDEN["prompt_ids"], "tokenization/template drift"
    assert meta == GOLDEN["crops_meta"], "anyres preprocessing drift"
    assert toks == GOLDEN["tokens"], "model numerics drift"
    assert text == GOLDEN["text"]


def test_pipeline_stable_without_disk_roundtrip(fixture_paths):
    """The same pipeline without the checkpoint round-trip emits identical
    tokens — isolates save/load from numerics if the golden ever breaks."""
    tok_dir, img = fixture_paths
    _, toks, _, _ = run_pipeline(tok_dir, img, tmp_ckpt_dir=None)
    assert toks == GOLDEN["tokens"]
