"""Benchmark drivers/converters + GPT-review plumbing tests (no model, no network)."""
import json

import pytest

from slime_jax.eval import benchmarks as bm
from slime_jax.eval import gpt_review as gr


def test_mmbench_prompt_and_rotation():
    p = bm.mmbench_prompt("What color?", ["red", "blue"], hint="A photo.",
                          conv_mode="v1")
    assert "A. red" in p and "B. blue" in p and "A photo." in p
    assert "option's letter" in p


def test_get_options():
    row = {"A": "x", "B": "y", "C": "", "D": ""}
    assert bm.get_options(row) == ["x", "y"]


def test_converters(tmp_path):
    ans = tmp_path / "a.jsonl"
    with open(ans, "w") as f:
        f.write(json.dumps({"question_id": 1, "text": "Blue "}) + "\n")
        f.write(json.dumps({"question_id": 2, "text": "cat"}) + "\n")

    gqa = bm.convert_gqa(str(ans), str(tmp_path / "gqa.json"))
    assert json.load(open(gqa))[0] == {"questionId": "1", "prediction": "blue"}

    v2 = bm.convert_vqav2(str(ans), str(tmp_path / "v2.json"))
    assert json.load(open(v2))[0] == {"question_id": 1, "answer": "Blue"}

    mv = bm.convert_mmvet(str(ans), str(tmp_path / "mv.json"))
    assert json.load(open(mv))["v1_1"] == "Blue"

    sd = bm.convert_seed(str(ans), str(tmp_path / "seed.json"))
    assert json.load(open(sd))[1]["prediction"] == "cat"


def test_xlsx_roundtrip(tmp_path):
    from slime_jax.eval.xlsx import read_xlsx, write_xlsx
    p = write_xlsx(str(tmp_path / "t.xlsx"), ["index", "question", "prediction"],
                   [[1, "what <is> & this?", "A"],
                    [2, "trailing space ", None],
                    [3, "num", 4.5]])
    rows = read_xlsx(p)
    assert rows[0] == ["index", "question", "prediction"]
    assert rows[1] == ["1", "what <is> & this?", "A"]
    assert rows[2][1] == "trailing space " and rows[2][2] is None
    assert rows[3][2] == "4.5"
    # it must be a real zip with the OOXML parts a reader looks for, and every
    # part must be well-formed XML (openpyxl is absent in this env; ElementTree
    # is the strictest available parser)
    import xml.etree.ElementTree as ET
    import zipfile
    z = zipfile.ZipFile(p)
    names = z.namelist()
    for part in ("[Content_Types].xml", "_rels/.rels", "xl/workbook.xml",
                 "xl/_rels/workbook.xml.rels", "xl/styles.xml",
                 "xl/worksheets/sheet1.xml"):
        assert part in names
        ET.fromstring(z.read(part))
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    sheet = ET.fromstring(z.read("xl/worksheets/sheet1.xml"))
    assert len(sheet.find(f"{ns}sheetData").findall(f"{ns}row")) == 4


def test_mmbench_to_submission_xlsx(tmp_path):
    tsv = tmp_path / "mmbench.tsv"
    cols = ["index", "question", "hint", "A", "B", "C", "D", "answer",
            "category", "l2-category", "image", "source", "comment"]
    with open(tsv, "w") as f:
        f.write("\t".join(cols) + "\n")
        f.write("\t".join(["7", "color?", "h", "red", "blue", "", "", "A",
                           "c", "l2", "img64", "s", "cm"]) + "\n")
        f.write("\t".join(["9", "shape?", "h", "round", "flat", "", "", "B",
                           "c", "l2", "img64", "s", "cm"]) + "\n")
    ans = tmp_path / "a.jsonl"
    with open(ans, "w") as f:
        f.write(json.dumps({"question_id": 7, "text": "The answer is A.",
                            "round_id": 0}) + "\n")
        f.write(json.dumps({"question_id": 7, "text": "rotated",
                            "round_id": 1}) + "\n")  # non-zero rounds ignored
    out = bm.mmbench_to_submission(str(ans), str(tsv), str(tmp_path / "sub.xlsx"))
    from slime_jax.eval.xlsx import read_xlsx
    rows = read_xlsx(out)
    # reference drops hint/category/source/image/comment/l2-category and
    # inserts 'prediction' at position 6 (convert_mmbench_for_submission.py:21-22)
    assert rows[0] == ["index", "question", "A", "B", "C", "D", "prediction",
                       "answer"]
    assert rows[1][0] == "7" and rows[1][6] == "The answer is A."
    assert rows[2][0] == "9" and rows[2][6] is None  # unanswered stays empty


def test_scienceqa_prompt():
    p = bm.scienceqa_prompt({"question": "Which is heavier?",
                             "choices": ["rock", "feather"], "hint": "think",
                             "image": "x.png"}, conv_mode="v1")
    assert "(A) rock" in p and "(B) feather" in p and "<image>" in p


def test_gpt_review_parse_and_summary():
    assert gr.parse_score("7 9\nGood answers.") == [7.0, 9.0]
    assert gr.parse_score("garbled") == [-1.0, -1.0]

    reviews = [
        {"tuple": [8.0, 6.0], "category": "conv"},
        {"tuple": [5.0, 10.0], "category": "conv"},
        {"tuple": [-1.0, -1.0], "category": "conv"},
    ]
    s = gr.summarize_reviews(reviews)
    assert s["conv"]["n"] == 2
    assert s["conv"]["score1"] == 6.5 and s["conv"]["score2"] == 8.0


def test_gpt_review_with_fake_judge():
    qs = [{"question_id": 1, "text": "desc?"}]
    a1 = [{"text": "a cat"}]
    a2 = [{"text": "a detailed cat"}]
    reviews = gr.review_answers(qs, a1, a2,
                                judge_fn=lambda sys, usr: "6 8\nSecond better.",
                                rule_prompt="Rate both 1-10.")
    assert reviews[0]["tuple"] == [6.0, 8.0]


def test_webpage_renderer(tmp_path):
    from slime_jax.eval import webpage
    qs = [{"question_id": 1, "text": "what <is> this?"}]
    a1 = [{"text": "a cat"}]
    a2 = [{"text": "a <b>dog</b>"}]
    reviews = [{"tuple": [7.0, 9.0]}]
    p = webpage.write_review_page(str(tmp_path / "r.html"), qs, a1, a2, reviews,
                                  title="t & t")
    s = open(p).read()
    assert "7 / 9" in s and "&lt;b&gt;dog&lt;/b&gt;" in s and "t &amp; t" in s


def _fake_run_eval(questions, question_key):
    """Monkeypatch stand-in for harness.run_eval: echoes 'ans:<question>'."""
    def fake(params, cfg, tokenizer, qs, *, answers_file, **kw):
        assert kw.get("question_key", "text") == question_key
        with open(answers_file, "w") as f:
            for i, q in enumerate(qs):
                f.write(json.dumps({"question_id": q.get("id", i),
                                    "text": f"ans:{q[question_key]}",
                                    "model_id": "slime-jax"}) + "\n")
        return answers_file
    return fake


def test_run_chartqa_format(tmp_path, monkeypatch):
    from slime_jax.eval import harness
    qs = [{"image": "a.png", "question": "total?", "answer": "10"},
          {"image": "b.png", "question": "max?", "answer": ["x", "y"]}]
    monkeypatch.setattr(harness, "run_eval", _fake_run_eval(qs, "question"))
    out = tmp_path / "chartqa.json"
    m = bm.run_chartqa(None, None, None, qs, image_folder="",
                       answers_file=str(out), conv_mode="v1")
    entries = json.load(open(out))
    assert entries == [{"answer": "ans:total?", "annotation": "10"},
                       {"answer": "ans:max?", "annotation": ["x", "y"]}]
    assert m["n"] == 2 and m["relaxed_accuracy"] == 0.0


def test_run_amber_format(tmp_path, monkeypatch):
    from slime_jax.eval import harness
    qs = [{"id": 7, "image": "a.png", "query": "describe this"}]
    monkeypatch.setattr(harness, "run_eval", _fake_run_eval(qs, "query"))
    out = tmp_path / "amber.jsonl"
    bm.run_amber(None, None, None, qs, image_folder="",
                 answers_file=str(out), conv_mode="v1")
    rows = [json.loads(l) for l in open(out)]
    # AMBER expects the capitalized response (model_vqa_amber.py:128)
    assert rows[0] == {"id": 7, "prompt": "describe this",
                       "response": "Ans:describe this",
                       "model_id": "slime-jax", "metadata": {}}


def test_run_mmhal_format(tmp_path, monkeypatch):
    from slime_jax.eval import harness
    recs = [{"question": "how many cats?", "image_path": "/x/a.png",
             "image_content": ["Cat"], "gt_answer": "two"}]

    def fake(params, cfg, tokenizer, qs, *, answers_file, **kw):
        assert kw["image_key"] == "image_path"
        with open(answers_file, "w") as f:
            f.write(json.dumps({"question_id": 0, "text": "one cat"}) + "\n")
        return answers_file

    monkeypatch.setattr(harness, "run_eval", fake)
    out = tmp_path / "mmhal.json"
    bm.run_mmhal(None, None, None, recs, answers_file=str(out), conv_mode="v1")
    rec = json.load(open(out))[0]
    assert rec["model_answer"] == "one cat"
    assert rec["gt_answer"] == "two"  # original fields preserved for the judge


def test_generate_openai_answers_schema():
    rows = gr.generate_openai_answers(
        [{"question_id": 5, "text": "why?"}], judge_fn=lambda s, u: "because")
    assert rows[0]["question_id"] == 5 and rows[0]["text"] == "because"
    err = gr.generate_openai_answers(
        [{"question_id": 6, "text": "x"}], max_retries=1,
        judge_fn=lambda s, u: (_ for _ in ()).throw(RuntimeError()))
    assert err[0]["text"] == "#ERROR#"
