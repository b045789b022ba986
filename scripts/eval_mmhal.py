#!/usr/bin/env python
"""MMHal-Bench judging CLI (reference eval_gpt_mmhal.py + summarize_gpt_mmhal.py).

Two modes:
  judge:     --response responses.json [--evaluation reviews.json] --api-key ...
             grades every response with an OpenAI-compatible judge and prints the
             average score / hallucination rate / per-type breakdown
  summarize: --evaluation reviews.json
             re-summarizes previously saved reviews without calling the judge
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from slime_jax.eval import mmhal  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["judge", "summarize"])
    ap.add_argument("--response", help="run_mmhal output json (records with "
                                       "model_answer)")
    ap.add_argument("--evaluation", help="reviews json to write (judge) or "
                                         "read (summarize)")
    ap.add_argument("--api-key", default=os.environ.get("OPENAI_API_KEY"))
    ap.add_argument("--base-url", default=None)
    ap.add_argument("--gpt-model", default="gpt-4-0314")
    args = ap.parse_args()

    if args.mode == "summarize":
        reviews = json.load(open(args.evaluation))
        print(json.dumps(mmhal.summarize(reviews), indent=2))
        return

    from slime_jax.eval.gpt_review import make_openai_judge
    kw = {"api_key": args.api_key}
    if args.base_url:
        kw["base_url"] = args.base_url
    judge = make_openai_judge(model=args.gpt_model, **kw)
    records = json.load(open(args.response))
    reviews = mmhal.judge_responses(records, judge, sleep=1.0)
    if args.evaluation:
        mmhal.write_reviews(reviews, args.evaluation)
    print(json.dumps(mmhal.summarize(reviews), indent=2))


if __name__ == "__main__":
    main()
