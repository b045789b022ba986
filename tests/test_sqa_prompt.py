"""SQA CoT prompt permutations: byte-parity against the reference's exec'd
convert_sqa_to_llava_base_prompt.py across every input x output format and
all three emitters (plain / chatbot / gpt4)."""
import importlib.util
import itertools
import sys
import types

import pytest

from slime_jax.eval import sqa_prompt as sp

_REF_PATH = "/root/reference/scripts/convert_sqa_to_llava_base_prompt.py"


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_sqa_base", _REF_PATH)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


PROBLEMS = {
    "p1": {"question": "Which is heavier?", "hint": "Think about mass.",
           "caption": "a rock and a feather",
           "choices": ["rock", "feather"], "answer": 0,
           "lecture": "Mass measures matter.\nHeavier means more mass.",
           "solution": "A rock has more mass.\nSo it is heavier."},
    "p2": {"question": "What color is the sky?", "hint": "",
           "caption": "", "choices": ["blue", "green", "red"], "answer": 0,
           "lecture": "", "solution": "The sky scatters blue light."},
}


class _Args:
    use_caption = True
    options = ["A", "B", "C", "D", "E"]

    def __init__(self, fmt):
        self.prompt_format = fmt


ALL_FORMATS = [f"{i}-{o}" for i, o in itertools.product(
    sp.INPUT_FORMATS, ("A", "AL", "AE", "ALE", "AEL", "LA", "EA", "LEA", "ELA"))]


@pytest.mark.parametrize("fmt", ALL_FORMATS[::7] + ["QCM-A", "CQM-LEA",
                                                    "QCM-EA", "QCMLE-ELA"])
def test_build_prompt_parity(ref, fmt):
    args = _Args(fmt)
    want = ref.build_prompt(PROBLEMS, ["p1"], "p2", args)
    got = sp.build_prompt(PROBLEMS, ["p1"], "p2", fmt, use_caption=True)
    assert got == want, fmt


@pytest.mark.parametrize("fmt", ["QCM-A", "QCM-LEA", "QCLM-ALE"])
@pytest.mark.parametrize("is_test", [False, True])
def test_build_prompt_chatbot_parity(ref, fmt, is_test):
    want = ref.build_prompt_chatbot(PROBLEMS, list(PROBLEMS), fmt,
                                    use_caption=False, is_test=is_test)
    got = sp.build_prompt_chatbot(PROBLEMS, list(PROBLEMS), fmt,
                                  use_caption=False, is_test=is_test)
    assert got == want, fmt


@pytest.mark.parametrize("fmt", ["QCM-A", "QCEM-LEA"])
def test_build_prompt_gpt4_parity(ref, fmt):
    args = _Args(fmt)
    want = ref.build_prompt_gpt4(PROBLEMS, ["p1"], "p2", args)
    got = sp.build_prompt_gpt4(PROBLEMS, ["p1"], "p2", fmt, use_caption=True)
    assert got == want, fmt


def test_lepa_format():
    """LEPA (the base-prompt training format) has no chatbot twin in the
    reference's plain emitter; pin its shape directly."""
    inp, out = sp.one_example("QCM-LEPA", PROBLEMS["p1"], style="chatbot")
    assert out.startswith("LECTURE: ") and "###" in out
    assert out.endswith("ANSWER: A.")
    _, out2 = sp.one_example("QCM-LEPA", PROBLEMS["p2"], style="chatbot")
    assert "LECTURE" not in out2  # empty lecture is skipped
    assert out2.startswith("SOLUTION: ")
