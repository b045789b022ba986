"""Interactive CLI chat (llava/serve/cli.py:27-127 rebuild): load checkpoint, infer
the conversation mode from the model name, stream tokens to stdout."""
from __future__ import annotations

import argparse

import numpy as np


def main():
    from ..utils import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from .. import checkpoint as ckpt
    from ..config import SliMEConfig
    from ..conversation import conv_mode_from_model_name, conv_templates
    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..data.image_ops import process_anyres_image_host
    from ..data.tokenization import get_model_name_from_path, tokenizer_image_token
    from ..generate import generate_stream

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--quantize-lm-head", action="store_true",
                    help="also int8-quantize the vocab projection (beyond the "
                         "reference's bitsandbytes default; ~12%% less weight "
                         "streaming per decode step at 128k vocab)")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--quantize-vision", action="store_true",
                    help="W8A8 vision tower: int8 weights + per-token int8 "
                         "activations (halves vision weight memory; ~2%% "
                         "feature error; ops/w8a8_matmul.py, docs/Serving.md)")
    ap.add_argument("--int4-scheme", default="default",
                    choices=["default", "absmax", "group"],
                    help="int4 data type: default = NF4 group-64 (accuracy-"
                         "safe, the reference's bnb type); absmax = per-row "
                         "uniform (fastest decode, quality budget in "
                         "docs/Serving.md); group = group-128 absmax via "
                         "the fused q4g kernel (group accuracy at fused-"
                         "kernel speed)")
    ap.add_argument("--draft-model-path", default=None,
                    help="small same-tokenizer model for greedy speculative "
                         "decoding (exact; text-only prompts)")
    ap.add_argument("--image-file", default=None)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--kv-cache-int8", action="store_true",
                    help="int8 KV cache (half cache memory/read traffic, "
                         "~1%% attention error)")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="shard the model over N chips (Megatron rules) — "
                         "serve 70B-class models across a mesh; 1 = single "
                         "device")
    ap.add_argument("--debug", action="store_true")
    args = ap.parse_args()

    from transformers import AutoTokenizer
    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.to_jax(ckpt.load_pretrained(args.model_path,
                                              model_base=args.model_base, cfg=cfg,
                                              load_bits=8 if args.load_8bit else (4 if args.load_4bit else None),
        quantize_lm_head=args.quantize_lm_head, int4_scheme=args.int4_scheme,
        quantize_vision=args.quantize_vision),
                         dtype=jnp.bfloat16)
    tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)
    mesh = None
    if args.tensor_parallel > 1:
        import jax
        from ..parallel import mesh as mesh_lib
        mesh = mesh_lib.make_mesh(1, 1, args.tensor_parallel,
                                  devices=jax.devices()[:args.tensor_parallel])
        params = mesh_lib.shard_params(mesh, params)
    draft = None
    if args.draft_model_path:
        dcfg = SliMEConfig.load(args.draft_model_path)
        dparams = ckpt.to_jax(ckpt.load_pretrained(args.draft_model_path, cfg=dcfg),
                              dtype=jnp.bfloat16)
        draft = (dparams, dcfg)

    model_name = get_model_name_from_path(args.model_path)
    conv_mode = args.conv_mode or conv_mode_from_model_name(model_name)
    conv = conv_templates[conv_mode].copy()

    pix = cmask = None
    image_pending = args.image_file is not None
    if image_pending:
        img = Image.open(args.image_file).convert("RGB")
        crops, mask, _ = process_anyres_image_host(
            img, tile=cfg.vision.image_size, max_crops=1 + cfg.max_local_crops)
        pix = jnp.asarray(crops[None])
        cmask = jnp.asarray(mask[None])

    while True:
        try:
            inp = input(f"{conv.roles[0]}: ")
        except EOFError:
            break
        if not inp:
            break
        if image_pending:
            inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
            image_pending = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")
        input_ids = jnp.asarray(ids[None])
        attn = jnp.ones((1, len(ids)), bool)

        print(f"{conv.roles[1]}: ", end="", flush=True)
        out_text = ""
        stop = conv.sep2 if conv.sep2 else conv.sep
        if draft is not None and pix is None:
            # on-device loop: one host sync per reply instead of per round
            from .speculative import speculative_generate_device
            from ..generate import trim_at_eos
            toks, rate = speculative_generate_device(
                params, cfg, draft[0], draft[1], input_ids,
                max_new_tokens=args.max_new_tokens, compute_dtype=jnp.bfloat16)
            out_text = tokenizer.decode(trim_at_eos(toks, cfg.eos_token_id)[0],
                                        skip_special_tokens=True)
            if stop and out_text.endswith(stop):
                out_text = out_text[: -len(stop)].rstrip()
            print(out_text + f"   [spec-accept {rate:.0%}]")
        else:
            for text in generate_stream(params, cfg, tokenizer, input_ids, attn,
                                        pix, cmask,
                                        max_new_tokens=args.max_new_tokens,
                                        temperature=args.temperature,
                                        stop_strings=[stop] if stop else [],
                                        compute_dtype=jnp.bfloat16, mesh=mesh,
                                        kv_quant=args.kv_cache_int8):
                print(text[len(out_text):], end="", flush=True)
                out_text = text
            print()
        conv.messages[-1][1] = out_text
        if args.debug:
            print({"prompt": prompt, "outputs": out_text})


if __name__ == "__main__":
    main()
