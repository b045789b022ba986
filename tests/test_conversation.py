"""Parity tests: conversation templates render byte-identical prompts."""
import pytest

from slime_jax import conversation as conv

from .ref_loader import load_ref_conversation

ref = load_ref_conversation()

CASES = [
    ("v1", [("USER", "Hello <image>"), ("ASSISTANT", "Hi there!"), ("USER", "what?"),
            ("ASSISTANT", None)]),
    ("llama3", [("user", "describe <image>"), ("assistant", "A cat."), ("user", "more"),
                ("assistant", None)]),
    ("plain", [("", "<image>")]),
    ("mpt", [("<|im_start|>user\n", "hi"), ("<|im_start|>assistant\n", None)]),
    ("llama_2", [("USER", "hi there"), ("ASSISTANT", "hello!"), ("USER", "ok"),
                 ("ASSISTANT", None)]),
    ("mistral_instruct", [("USER", "hi"), ("ASSISTANT", None)]),
]


@pytest.mark.parametrize("name,messages", CASES)
def test_prompt_matches_reference(name, messages):
    ours = conv.conv_templates[name].copy()
    theirs = ref.conv_templates[name].copy()
    theirs.messages = list(theirs.messages)
    for role, msg in messages:
        ours.append_message(role, msg)
        theirs.append_message(role, msg)
    assert ours.get_prompt() == theirs.get_prompt()


def test_registry_covers_reference_keys():
    assert set(ref.conv_templates.keys()) <= set(conv.conv_templates.keys())


def test_mmtag_prompts_match():
    for name in ("v0_mmtag", "v1_mmtag"):
        ours = conv.conv_templates[name].copy()
        theirs = ref.conv_templates[name].copy()
        theirs.messages = list(theirs.messages)
        ours.append_message(ours.roles[0], "<Image><image></Image> hi")
        theirs.append_message(theirs.roles[0], "<Image><image></Image> hi")
        ours.append_message(ours.roles[1], None)
        theirs.append_message(theirs.roles[1], None)
        assert ours.get_prompt() == theirs.get_prompt()
