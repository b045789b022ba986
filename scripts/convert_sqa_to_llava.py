#!/usr/bin/env python
"""Convert ScienceQA releases into LLaVA/SliME training-format JSON.

Reference scripts/convert_sqa_to_llava.py (record semantics: strip the
'Question: '/'Answer: ' prefixes, append '\n<image>' for image problems) on
top of the full CoT prompt permutation engine (slime_jax/eval/sqa_prompt.py,
byte-parity-tested against convert_sqa_to_llava_base_prompt.py). Supports
every reference format (QCM-A ... QCLEM-ELA, QCM-LEPA for the jsonl variant).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from slime_jax.eval import sqa_prompt


def convert_to_llava(base_dir, split, prompt_format, output=None):
    with open(os.path.join(base_dir, "pid_splits.json")) as f:
        pids = json.load(f)[split]
    with open(os.path.join(base_dir, "problems.json")) as f:
        problems = json.load(f)

    pairs = sqa_prompt.build_prompt_chatbot(problems, pids, prompt_format,
                                            use_caption=False, is_test=False)
    out = []
    for pid, (inp, ans) in pairs.items():
        if inp.startswith("Question: "):
            inp = inp.replace("Question: ", "")
        if ans.startswith("Answer: "):
            ans = ans.replace("Answer: ", "")
        rec = {"id": pid,
               "conversations": [{"from": "human", "value": inp},
                                 {"from": "gpt", "value": ans}]}
        img = problems[pid].get("image")
        if img:
            rec["image"] = os.path.join(pid, img)
            rec["conversations"][0]["value"] = f"{inp}\n<image>"
        out.append(rec)

    dst = output or os.path.join(base_dir, f"llava_{split}_{prompt_format}.json")
    with open(dst, "w") as f:
        json.dump(out, f, indent=2)
    print(f"{len(out)} records -> {dst}")
    return dst


def convert_to_jsonl(base_dir, split, prompt_format="QCM-LEPA", output=None):
    """The base-prompt jsonl variant (reference convert_to_jsonl): one
    {"text": input+output} line per problem, LEPA CoT output format."""
    with open(os.path.join(base_dir, "pid_splits.json")) as f:
        pids = json.load(f)[split]
    with open(os.path.join(base_dir, "problems.json")) as f:
        problems = json.load(f)
    pairs = sqa_prompt.build_prompt_chatbot(problems, pids, prompt_format,
                                            use_caption=False, is_test=False)
    dst = output or os.path.join(base_dir, f"scienceqa_{split}_{prompt_format}.jsonl")
    with open(dst, "w") as f:
        for pid, (inp, ans) in pairs.items():
            f.write(json.dumps({"id": pid, "instruction": inp,
                                "output": ans}) + "\n")
    print(f"{len(pairs)} records -> {dst}")
    return dst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-dir", required=True,
                    help="dir containing problems.json and pid_splits.json")
    ap.add_argument("--split", default="train")
    ap.add_argument("--output", default=None)
    ap.add_argument("--prompt-format", default="QCM-LEA",
                    help="input-output format, e.g. QCM-A, QCM-LEA, QCM-LEPA "
                         "(any combination from eval/sqa_prompt.py)")
    ap.add_argument("--jsonl", action="store_true",
                    help="emit the base-prompt jsonl variant instead")
    args = ap.parse_args()
    if args.jsonl:
        convert_to_jsonl(args.base_dir, args.split, args.prompt_format,
                         args.output)
    else:
        convert_to_llava(args.base_dir, args.split, args.prompt_format,
                         args.output)


if __name__ == "__main__":
    main()
