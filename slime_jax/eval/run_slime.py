"""Single-shot image+prompt inference (reference llava/eval/run_llava.py:50-128).

Usage:
  python -m slime_jax.eval.run_slime --model-path ... --image-file img.jpg \
      --query "What is this?"
"""
from __future__ import annotations

import argparse

import numpy as np


def eval_model(args):
    import jax.numpy as jnp
    from PIL import Image
    from transformers import AutoTokenizer

    from .. import checkpoint as ckpt
    from ..config import SliMEConfig
    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_mode_from_model_name, conv_templates
    from ..data.image_ops import process_anyres_image_host
    from ..data.tokenization import get_model_name_from_path, tokenizer_image_token
    from ..generate import generate, trim_at_eos

    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.to_jax(ckpt.load_pretrained(args.model_path,
                                              model_base=args.model_base, cfg=cfg),
                         dtype=jnp.bfloat16)
    tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)

    qs = args.query
    if DEFAULT_IMAGE_TOKEN not in qs:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    conv_mode = args.conv_mode or conv_mode_from_model_name(
        get_model_name_from_path(args.model_path))
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    img = Image.open(args.image_file).convert("RGB")
    crops, mask, _ = process_anyres_image_host(
        img, tile=cfg.vision.image_size, max_crops=1 + cfg.max_local_crops)
    ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")

    toks = generate(params, cfg, jnp.asarray(ids[None]),
                    jnp.ones((1, len(ids)), bool),
                    jnp.asarray(crops[None]), jnp.asarray(mask[None]),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature, top_p=args.top_p,
                    compute_dtype=jnp.bfloat16)
    out = trim_at_eos(np.asarray(toks), cfg.eos_token_id)[0]
    text = tokenizer.decode(out, skip_special_tokens=True).strip()
    print(text)
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--image-file", required=True)
    ap.add_argument("--query", required=True)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    eval_model(ap.parse_args())


if __name__ == "__main__":
    main()
