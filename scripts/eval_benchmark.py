#!/usr/bin/env python
"""Generic eval CLI: chunk-sharded answer generation + scoring.

Replaces the per-benchmark bash fan-out (scripts/llama/eval/*.sh) — chunking flags
match the reference (--num-chunks/--chunk-idx), so multiple hosts/devices can split a
benchmark and `--merge` concatenates + scores.
"""
import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--image-folder", required=True)
    ap.add_argument("--answers-file", required=True)
    ap.add_argument("--conv-mode", default="llama3")
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=None,
                    help="default: 0.0 (greedy) for VQA benchmarks, 0.7 for "
                         "text-qa (reference model_qa.py); explicit values "
                         "win, including 0")
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--single-pred-prompt", action="store_true")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="text prompt cap; 0 = model tokenizer_model_max_length "
                         "(long-prefill benchmarks like MME-RealWorld run "
                         "untruncated)")
    ap.add_argument("--benchmark", default="generic",
                    choices=["generic", "chartqa", "mmhal", "amber", "text-qa"],
                    help="driver/output format (generic = answers jsonl; the "
                         "others emit the reference per-benchmark formats)")
    ap.add_argument("--scorer", default=None,
                    choices=[None, "textvqa", "pope", "scienceqa"])
    ap.add_argument("--annotation-file", default=None)
    ap.add_argument("--merge", action="store_true",
                    help="merge chunk files matching answers-file pattern and score")
    args = ap.parse_args()

    if args.benchmark in ("chartqa", "mmhal", "amber"):
        # These drivers replicate the reference protocols, which are greedy
        # bs>1; sampling/beam flags would be silently ignored — refuse them.
        ignored = []
        if args.temperature not in (None, 0.0):
            ignored.append(f"--temperature={args.temperature}")
        if args.num_beams != 1:
            ignored.append(f"--num-beams={args.num_beams}")
        if args.single_pred_prompt:
            ignored.append("--single-pred-prompt")
        if ignored:
            ap.error(f"{', '.join(ignored)} not supported by the "
                     f"'{args.benchmark}' driver (it runs the reference "
                     "greedy protocol); drop the flag(s) or use "
                     "--benchmark generic")

    from slime_jax.eval import harness, scorers

    if args.merge:
        files = sorted(glob.glob(args.answers_file.replace("{chunk}", "*")))
        merged = args.answers_file.replace("{chunk}", "merged")
        harness.merge_chunks(files, merged)
        print(f"merged {len(files)} chunks -> {merged}")
        if args.scorer == "textvqa":
            print(scorers.score_textvqa(merged, args.annotation_file))
        return

    import jax.numpy as jnp
    from transformers import AutoTokenizer

    from slime_jax import checkpoint as ckpt
    from slime_jax.config import SliMEConfig

    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.to_jax(ckpt.load_pretrained(
        args.model_path, model_base=args.model_base, cfg=cfg), dtype=jnp.bfloat16)
    tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)

    questions = harness.load_questions(args.question_file)
    chunk = harness.get_chunk(questions, args.num_chunks, args.chunk_idx)
    out = args.answers_file.replace("{chunk}", str(args.chunk_idx))
    if args.benchmark != "generic":
        from slime_jax.eval import benchmarks
        if args.benchmark == "chartqa":
            print(benchmarks.run_chartqa(
                params, cfg, tokenizer, chunk, image_folder=args.image_folder,
                answers_file=out, conv_mode=args.conv_mode,
                batch_size=args.batch_size, seq_len=args.seq_len,
                max_new_tokens=args.max_new_tokens))
        elif args.benchmark == "mmhal":
            benchmarks.run_mmhal(params, cfg, tokenizer, chunk,
                                 answers_file=out, conv_mode=args.conv_mode,
                                 image_folder=args.image_folder,
                                 batch_size=args.batch_size,
                                 seq_len=args.seq_len,
                                 max_new_tokens=args.max_new_tokens)
        elif args.benchmark == "amber":
            benchmarks.run_amber(params, cfg, tokenizer, chunk,
                                 image_folder=args.image_folder,
                                 answers_file=out, conv_mode=args.conv_mode,
                                 batch_size=args.batch_size,
                                 seq_len=args.seq_len,
                                 max_new_tokens=args.max_new_tokens)
        else:  # text-qa
            harness.run_text_qa(params, cfg, tokenizer, chunk,
                                answers_file=out, conv_mode=args.conv_mode,
                                batch_size=args.batch_size,
                                seq_len=args.seq_len,
                                temperature=(0.7 if args.temperature is None
                                             else args.temperature),
                                max_new_tokens=args.max_new_tokens)
        print(f"answers -> {out}")
        return
    harness.run_eval(params, cfg, tokenizer, chunk,
                     image_folder=args.image_folder, answers_file=out,
                     conv_mode=args.conv_mode, batch_size=args.batch_size,
                     max_new_tokens=args.max_new_tokens,
                     temperature=args.temperature or 0.0,
                     num_beams=args.num_beams, seq_len=args.seq_len,
                     single_pred_prompt=args.single_pred_prompt)
    print(f"answers -> {out}")


if __name__ == "__main__":
    main()
