"""Time the 3-stage pretrain pipeline end-to-end at reduced scale, on chip.

Reproduces scripts/llama3_8b_pretrain.sh's staging (the reference's primary
workflow, scripts/llama/llama3_8b_pt.sh:1-133) with a ~170M SliME config and
synthetic data, measuring what the per-piece tests never did:

  - wall-clock per stage (subprocess, includes load + compile + train)
  - steady-state in-loop throughput (from metrics.jsonl timestamps)
  - stage-transition overhead = wall - in-loop (checkpoint load, adapter
    load via --pretrain-mm-mlp-adapter, freeze switch, XLA compile)
  - one mid-stage SIGTERM during stage 2 + auto-resume (PreemptionGuard's
    grace save -> latest_checkpoint() discovery), verifying the restart
    reaches the full step budget

Env: SLIME_P3_STEPS (50 per stage), SLIME_P3_BS (8), SLIME_P3_SEQ (512),
SLIME_P3_SIGTERM (1 = do the preemption leg). Prints one JSON line per stage
plus a summary line.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def make_small_ckpt(path: str) -> None:
    """~170M SliME: 8-layer/1024-wide LLM + 8-layer/512-wide ViT.

    Init + save pinned to the host CPU backend: the params exist only to be
    written to disk, so a device round trip would be pure overhead.
    """
    import jax

    from slime_jax import checkpoint as ckpt
    from slime_jax.config import LLMConfig, SliMEConfig, VisionConfig
    from slime_jax.models import slime
    from tests.hf_fixtures import make_hf_tokenizer_dir

    cfg = SliMEConfig(
        llm=LLMConfig(vocab_size=32000, hidden_size=1024,
                      intermediate_size=2816, num_layers=8, num_heads=8,
                      num_kv_heads=4, head_dim=128,
                      max_position_embeddings=2048),
        vision=VisionConfig(image_size=224, patch_size=14, hidden_size=512,
                            intermediate_size=2048, num_layers=8, num_heads=8),
        mm_resampler_dim=64,
        tokenizer_model_max_length=1024,
        seperator=7, bos_token_id=1, eos_token_id=2,
    )
    with jax.default_device(jax.devices("cpu")[0]):
        params = slime.init(jax.random.PRNGKey(0), cfg)
        n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
        print(f"model: {n / 1e6:.1f}M params", file=sys.stderr, flush=True)
        ckpt.save_checkpoint(path, params, cfg)
    make_hf_tokenizer_dir(path)


def make_data(root: str, n: int = 512) -> tuple:
    from PIL import Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(8):
        w, h = int(rng.integers(224, 900)), int(rng.integers(224, 700))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"im{i}.jpg"))
        names.append(f"im{i}.jpg")
    recs = [{"id": str(i), "image": names[i % len(names)],
             "conversations": [
                 {"from": "human", "value": "<image>\nwhat is in the picture ?"},
                 {"from": "gpt", "value": "a cat . " * (2 + i % 6)}]}
            for i in range(n)]
    dj = os.path.join(root, "data.json")
    with open(dj, "w") as f:
        json.dump(recs, f)
    return dj, img_dir


def stage_cmd(ckpt_dir, dj, img_dir, out, *, steps, bs, seq, extra):
    return [sys.executable, os.path.join(REPO, "scripts/train_slime.py"),
            "--model-path", ckpt_dir, "--data-path", dj,
            "--image-folder", img_dir, "--output-dir", out,
            "--version", "plain", "--per-device-batch-size", str(bs),
            "--model-max-length", str(seq), "--max-steps", str(steps),
            "--save-steps", "0", "--logging-steps", str(min(5, max(1, steps // 2))),
            "--learning-rate", "1e-3", "--mm-projector-lr", "1e-3",
            "--tune-mm-mlp-adapter"] + extra


def run_stage(cmd, name):
    t0 = time.monotonic()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ,
                                PYTHONPATH=REPO + os.pathsep
                                + os.environ.get("PYTHONPATH", "")))
    wall = time.monotonic() - t0
    if r.returncode != 0:
        print(r.stdout[-3000:], file=sys.stderr)
        print(r.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"{name} failed rc={r.returncode}")
    return wall, r.stdout


def loop_stats(out_dir, steps, bs, seq):
    """Steady-state tok/s from metrics.jsonl (drop the first, compile-tainted
    row); in-loop seconds estimated from steady tok/s over the full budget."""
    rows = [json.loads(l) for l in open(os.path.join(out_dir, "metrics.jsonl"))]
    tps = [r["tokens_per_sec"] for r in rows[1:]] or \
          [rows[-1]["tokens_per_sec"]]
    steady = float(np.median(tps))
    in_loop = steps * bs * seq / steady
    return steady, in_loop, rows[-1]["step"], rows[-1]["loss"]


def main():
    import tempfile

    steps = int(os.environ.get("SLIME_P3_STEPS", "50"))
    bs = int(os.environ.get("SLIME_P3_BS", "8"))
    seq = int(os.environ.get("SLIME_P3_SEQ", "512"))
    do_sig = os.environ.get("SLIME_P3_SIGTERM", "1") == "1"

    root = tempfile.mkdtemp(prefix="slime_p3_")
    ckpt_dir = os.path.join(root, "ckpt")
    make_small_ckpt(ckpt_dir)
    dj, img_dir = make_data(root)
    out = os.path.join(root, "out")

    stages = [
        ("stage1", ["--use-global-only", "--mm-learnable-gated", "0"]),
        ("stage2", ["--use-global-only", "--mm-learnable-gated", "1",
                    "--pretrain-mm-mlp-adapter",
                    os.path.join(out, "stage1", "mm_projector.bin")]),
        ("stage3", ["--use-local-only", "--pretrain-mm-mlp-adapter",
                    os.path.join(out, "stage2", "mm_projector.bin")]),
    ]
    summary = {}
    for name, extra in stages:
        od = os.path.join(out, name)
        cmd = stage_cmd(ckpt_dir, dj, img_dir, od, steps=steps, bs=bs,
                        seq=seq, extra=extra)
        wall, _ = run_stage(cmd, name)
        steady, in_loop, last_step, loss = loop_stats(od, steps, bs, seq)
        rec = {"metric": f"pipeline3_{name}", "value": round(steady, 0),
               "unit": "steady tok/s", "wall_s": round(wall, 1),
               "in_loop_s": round(in_loop, 1),
               "transition_overhead_s": round(wall - in_loop, 1),
               "steps": last_step, "final_loss": round(loss, 3)}
        print(json.dumps(rec), flush=True)
        summary[name] = rec
        assert os.path.exists(os.path.join(od, "mm_projector.bin")), od

    if do_sig:
        # preemption leg: SIGTERM mid-run, then auto-resume to the budget
        od = os.path.join(out, "stage2_preempt")
        cmd = stage_cmd(ckpt_dir, dj, img_dir, od, steps=steps, bs=bs,
                        seq=seq, extra=stages[1][1])
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        p = subprocess.Popen(cmd, cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        mfile = os.path.join(od, "metrics.jsonl")
        while True:  # wait until some steps are in
            time.sleep(2)
            if os.path.exists(mfile) and sum(1 for _ in open(mfile)) >= 2:
                break
            if p.poll() is not None:
                raise SystemExit("preempt leg exited early")
        t_sig = time.monotonic()
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=600)
        t_save = time.monotonic() - t_sig
        wall, _ = run_stage(cmd, "stage2_resume")  # discovers state-<step>
        rows = [json.loads(l) for l in open(mfile)]
        assert rows[-1]["step"] == steps, rows[-1]
        print(json.dumps({
            "metric": "pipeline3_preempt_resume",
            "value": round(t_save, 1), "unit": "s SIGTERM->durable state save",
            "resume_wall_s": round(wall, 1),
            "resumed_to_step": rows[-1]["step"]}), flush=True)

    total = sum(r["wall_s"] for r in summary.values())
    print(json.dumps({"metric": "pipeline3_total", "value": round(total, 1),
                      "unit": f"s for 3 stages x {steps} steps "
                              f"(bs={bs}, seq={seq})"}), flush=True)


if __name__ == "__main__":
    main()
