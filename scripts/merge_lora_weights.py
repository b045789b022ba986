#!/usr/bin/env python
"""Merge LoRA adapters into base weights and save a standalone checkpoint
(reference scripts/merge_lora_weights.py:1-22 + model/builder.py:52-91)."""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True, help="LoRA checkpoint dir")
    ap.add_argument("--model-base", required=True)
    ap.add_argument("--save-model-path", required=True)
    args = ap.parse_args()

    from slime_jax import checkpoint as ckpt
    from slime_jax.config import SliMEConfig

    cfg = SliMEConfig.load(args.model_path)
    # load_pretrained detects adapter_model.* / inline lora_* keys and merges
    # W <- W + (alpha/r) B @ A against model_base (checkpoint.load_pretrained)
    merged = ckpt.to_jax(ckpt.load_pretrained(args.model_path,
                                              model_base=args.model_base, cfg=cfg))
    ckpt.save_checkpoint(args.save_model_path, merged, cfg)
    print(f"merged checkpoint -> {args.save_model_path}")


if __name__ == "__main__":
    main()
