"""Data pipeline tests: preprocessors mask exactly the instruction spans; dataset +
collator produce fixed-shape batches; tokenizer_image_token splices sentinels."""
import json

import numpy as np
import pytest

from slime_jax.constants import (DEFAULT_IMAGE_TOKEN, IGNORE_INDEX,
                                 IMAGE_TOKEN_INDEX, MAX_CROPS)
from slime_jax.data import preprocess as pp
from slime_jax.data.dataset import (LengthGroupedSampler, SupervisedDataset,
                                    collate, data_loader)
from slime_jax.data.tokenization import tokenizer_image_token

from .toy_tokenizer import ToyTokenizer


def _src(*turns):
    out = []
    for i, t in enumerate(turns):
        out.append({"from": "human" if i % 2 == 0 else "gpt", "value": t})
    return [out]


def test_tokenizer_image_token_splices_sentinel():
    tok = ToyTokenizer()
    ids = tokenizer_image_token(f"hello {DEFAULT_IMAGE_TOKEN} world", tok)
    assert IMAGE_TOKEN_INDEX in ids
    assert ids[0] == tok.bos_token_id
    assert ids.count(IMAGE_TOKEN_INDEX) == 1


def test_tokenizer_image_token_multi():
    tok = ToyTokenizer()
    ids = tokenizer_image_token("<image> a <image> b", tok)
    assert ids.count(IMAGE_TOKEN_INDEX) == 2


def test_preprocess_plain_masks_image_prefix():
    tok = ToyTokenizer()
    d = pp.preprocess_plain([[
        {"from": "human", "value": "<image>"},
        {"from": "gpt", "value": "a red bus parked"},
    ]], tok)
    ids, lab = d["input_ids"][0], d["labels"][0]
    n_instr = len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tok))
    assert (lab[:n_instr] == IGNORE_INDEX).all()
    assert (lab[n_instr:] != IGNORE_INDEX).all()
    np.testing.assert_array_equal(ids[n_instr:], lab[n_instr:])


def test_preprocess_v1_masks_instructions_only():
    tok = ToyTokenizer(legacy=True)  # vicuna-style sentencepiece counting
    d = pp.preprocess_v1(_src("<image>\nwhat is this ?", "a cat .",
                              "are you sure ?", "yes , a cat ."),
                         tok, has_image=True)
    ids, lab = d["input_ids"][0], d["labels"][0]
    # every supervised token must also exist in input_ids at the same slot
    sup = lab != IGNORE_INDEX
    assert sup.sum() > 0
    np.testing.assert_array_equal(ids[sup], lab[sup])
    # answer words supervised, question words not
    cat_id = tok.vocab["cat"]
    what_id = tok.vocab["what"]
    assert cat_id in lab[sup]
    assert what_id in ids and what_id not in lab[sup]
    # no tokenization-mismatch wipeout
    assert sup.any()


def test_preprocess_llama3_masks_instructions_only():
    tok = ToyTokenizer(add_bos=True)  # bos offsets the non-legacy round correction
    d = pp.preprocess_llama3(_src("<image>\ndescribe", "a dog on grass",
                                  "more detail", "a brown dog ."),
                             tok, has_image=True)
    ids, lab = d["input_ids"][0], d["labels"][0]
    sup = lab != IGNORE_INDEX
    assert sup.sum() > 0
    np.testing.assert_array_equal(ids[sup], lab[sup])
    assert tok.vocab["dog"] in lab[sup]
    assert tok.vocab["describe"] not in lab[sup]


def test_preprocess_mpt_masks_instructions_only():
    # chatml-style tokenizer: no bos, legacy counting (+1 keeps <|im_end|> in rounds)
    tok = ToyTokenizer(add_bos=False, legacy=True)
    d = pp.preprocess_mpt(_src("hi there", "hello friend"), tok, has_image=False)
    ids, lab = d["input_ids"][0], d["labels"][0]
    sup = lab != IGNORE_INDEX
    assert sup.sum() > 0
    np.testing.assert_array_equal(ids[sup], lab[sup])
    assert tok.vocab["hello"] in lab[sup]


def test_dataset_and_collator(tmp_path):
    from PIL import Image
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Image.new("RGB", (700, 500), (10, 200, 30)).save(img_dir / "a.jpg")
    data = [
        {"id": "0", "image": "a.jpg",
         "conversations": [{"from": "human", "value": "<image>\nwhat ?"},
                           {"from": "gpt", "value": "green ."}]},
        {"id": "1",
         "conversations": [{"from": "human", "value": "just text ?"},
                           {"from": "gpt", "value": "yes ."}]},
    ]
    jf = tmp_path / "d.json"
    jf.write_text(json.dumps(data))

    tok = ToyTokenizer()
    ds = SupervisedDataset([str(jf)], tok, image_folder=str(img_dir),
                           conv_version="v1")
    assert len(ds) == 2
    it0 = ds[0]
    assert it0["pixel_values"].shape == (MAX_CROPS, 3, 336, 336)
    assert it0["crop_mask"][0] and it0["crop_mask"].sum() >= 2
    assert IMAGE_TOKEN_INDEX in it0["input_ids"].tolist()
    it1 = ds[1]
    assert not it1["crop_mask"].any()

    batches = list(data_loader(ds, batch_size=2, seq_len=64,
                               pad_token_id=tok.pad_token_id, shuffle=False,
                               drop_last=False))
    b = batches[0]
    assert b["input_ids"].shape == (2, 64)
    assert b["pixel_values"].shape == (2, MAX_CROPS, 3, 336, 336)
    assert b["attention_mask"][0].sum() == len(it0["input_ids"])
    # modality lengths: positive for image sample, negative for text-only
    ml = ds.modality_lengths
    assert ml[0] > 0 and ml[1] < 0


def test_length_grouped_sampler_separates_modalities():
    lengths = [10, -5, 20, -8, 15, -3]
    s = LengthGroupedSampler(lengths, batch_size=2, group_by_modality=True)
    idx = s.indices()
    assert sorted(idx) == list(range(6))
    # multimodal (positive) indices appear as a contiguous block before/after text
    signs = [0 if lengths[i] > 0 else 1 for i in idx]
    assert signs == sorted(signs) or signs == sorted(signs, reverse=True)


def test_prefetch_order_and_errors():
    from slime_jax.data.dataset import prefetch

    assert list(prefetch(iter(range(20)), depth=3)) == list(range(20))

    def boom():
        yield 1
        raise ValueError("producer failed")

    it = prefetch(boom(), depth=2)
    assert next(it) == 1
    import pytest as _pytest
    with _pytest.raises(ValueError, match="producer failed"):
        next(it)

    assert list(prefetch(iter([]), depth=1)) == []


def test_prefetcher_map_fn_and_stall_accounting():
    """Prefetcher runs map_fn in the producer thread, preserves order, and
    accounts consumer stall time (the host-stall metric the trainer logs)."""
    import time

    from slime_jax.data.dataset import Prefetcher

    pf = Prefetcher(iter(range(10)), depth=2, map_fn=lambda x: x * 2)
    assert list(pf) == [x * 2 for x in range(10)]
    assert pf.batches == 10

    def slow_producer():
        for i in range(3):
            time.sleep(0.05)
            yield i

    pf = Prefetcher(slow_producer(), depth=2)
    assert list(pf) == [0, 1, 2]
    assert pf.stall_s > 0.02  # consumer had to wait on the slow producer


def test_trainer_prefetch_matches_synchronous(tmp_path):
    """Same data + seed with and without the background input pipeline give
    the identical final state (prefetch only reorders host work)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slime_jax.config import SliMEConfig
    from slime_jax.models import slime
    from slime_jax.train.optim import TrainConfig
    from slime_jax.train.trainer import RunConfig, Trainer
    from slime_jax.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX

    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    B, S = 2, 12
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    batch = {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
             "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
             "crop_mask": np.ones((B, MC), bool),
             "labels": np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)}
    tc = TrainConfig(total_steps=4, learning_rate=1e-3)

    def run(depth):
        tr = Trainer(params, cfg, tc,
                     RunConfig(output_dir=str(tmp_path / f"d{depth}"),
                               save_steps=0, log_steps=100, max_steps=4,
                               prefetch_depth=depth),
                     compute_dtype=jnp.float32)
        tr.train(dict(batch) for _ in range(4))
        return tr.state

    s_sync, s_pf = run(0), run(2)
    assert int(s_sync["step"]) == int(s_pf["step"]) == 4
    for a, b in zip(jax.tree_util.tree_leaves(s_sync["params"]),
                    jax.tree_util.tree_leaves(s_pf["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
