"""Offline HF-loadable fixtures: a WordLevel tokenizer dir + a tiny SliME checkpoint
dir, so CLI entrypoints (train/eval/serve) run end-to-end without network access."""
import json
import os

VOCAB_SEED = ("what is in the picture a cat dog red blue green yes no ? . the "
              "USER: ASSISTANT: A chat between curious user and an artificial "
              "intelligence assistant gives helpful detailed polite answers to "
              "user's questions describe this image color")


def make_hf_tokenizer_dir(path: str) -> str:
    """Write tokenizer.json + config loadable by AutoTokenizer (no network)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from tokenizers.processors import TemplateProcessing

    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    for w in VOCAB_SEED.split():
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = TemplateProcessing(single="<s> $A",
                                            special_tokens=[("<s>", 1)])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "pad_token": "<pad>", "unk_token": "<unk>",
                   "model_max_length": 2048}, f)
    return path


def make_tiny_checkpoint_dir(path: str, seed: int = 0) -> str:
    """Tiny SliME checkpoint + tokenizer files in one dir (full CLI surface)."""
    import jax

    from slime_jax import checkpoint as ckpt
    from slime_jax.config import SliMEConfig
    from slime_jax.models import slime

    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(seed), cfg)
    ckpt.save_checkpoint(path, params, cfg)
    make_hf_tokenizer_dir(path)
    return path
