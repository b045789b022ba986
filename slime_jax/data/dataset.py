"""Supervised dataset + fixed-shape collator.

Rebuilds LazySupervisedDataset / DataCollatorForSupervisedDataset
(llava/train/train.py:763-928) without torch:

- JSON conversation lists (LLaVA format: [{"image": ..., "conversations": [...]}]),
  lazily materialized per item; multi-dataset mixing with sqrt-size sampling
  probabilities (train.py:793-796).
- ``lengths`` / ``modality_lengths`` for length-grouped batching (train.py:802-817).
- The collator pads token rows to a fixed ``seq_len`` and crops to the fixed
  ``MAX_CROPS`` budget with a crop mask — the reference already pads crops to a
  fixed count "for balanced offload in zero3" (train.py:903-926); here it also makes
  every batch a single compiled XLA program.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Sequence

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX, MAX_CROPS
from . import preprocess as pp
from .image_ops import process_anyres_image_host, process_pad_image_host


class SupervisedDataset:
    """Lazy conversation dataset over one or more LLaVA-format JSON files."""

    def __init__(self, data_paths: Sequence[str], tokenizer, *,
                 image_folder: str = "", image_aspect_ratio: str = "anyres",
                 conv_version: str = "v1", max_crops: int = MAX_CROPS,
                 is_multimodal: bool = True, seed: int = 3407,
                 tile: int = 336, use_native_preprocess: bool = True,
                 pixel_dtype: str = "float32"):
        # pixel_dtype="uint8": ship raw [0,255] crops and CLIP-normalize on
        # device (slime.encode_images) — 1/4 the host->device pixel bytes
        if isinstance(data_paths, str):
            data_paths = [data_paths]
        self.tokenizer = tokenizer
        self.image_folder = image_folder
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.max_crops = max_crops
        self.is_multimodal = is_multimodal
        self.tile = tile
        self.use_native_preprocess = use_native_preprocess and tile == 336
        assert pixel_dtype in ("float32", "uint8"), pixel_dtype
        # uint8 transport only exists for the anyres path; pad mode keeps fp32
        if image_aspect_ratio not in ("anyres", "any_res"):
            pixel_dtype = "float32"
        self.pixel_dtype = pixel_dtype

        datasets = []
        for p in data_paths:
            with open(p) as f:
                datasets.append(json.load(f))
        if len(datasets) > 1:
            # sqrt-size mixing (train.py:793-796): sample each source with
            # probability proportional to sqrt(len)
            sizes = np.asarray([len(d) for d in datasets], dtype=np.float64)
            probs = np.sqrt(sizes) / np.sqrt(sizes).sum()
            rng = random.Random(seed)
            total = int(sizes.sum())
            self.records = []
            for _ in range(total):
                src = rng.choices(range(len(datasets)), weights=probs)[0]
                self.records.append(rng.choice(datasets[src]))
        else:
            self.records = datasets[0]

    def __len__(self) -> int:
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        out = []
        for r in self.records:
            img_tokens = 128 if "image" in r else 0
            out.append(sum(len(c["value"].split()) for c in r["conversations"])
                       + img_tokens)
        return out

    @property
    def modality_lengths(self) -> List[int]:
        """Positive for multimodal samples, negative for text-only (train.py:809-817)."""
        out = []
        for r in self.records:
            n = sum(len(c["value"].split()) for c in r["conversations"])
            out.append(n if "image" in r else -n)
        return out

    def __getitem__(self, i: int) -> Dict:
        r = self.records[i]
        has_image = "image" in r and self.is_multimodal
        sources = pp.preprocess_multimodal(
            [json.loads(json.dumps(r["conversations"]))]) if has_image else \
            [json.loads(json.dumps(r["conversations"]))]
        d = pp.preprocess(sources, self.tokenizer, has_image=has_image,
                          version=self.conv_version)
        item: Dict = {"input_ids": d["input_ids"][0], "labels": d["labels"][0]}

        pv, mask = image_crops_for_record(
            r if has_image else None, image_folder=self.image_folder,
            image_aspect_ratio=self.image_aspect_ratio, tile=self.tile,
            max_crops=self.max_crops,
            use_native=self.use_native_preprocess,
            pixel_dtype=self.pixel_dtype)
        item["pixel_values"] = pv
        item["crop_mask"] = mask
        return item


def image_crops_for_record(record, *, image_folder: str,
                           image_aspect_ratio: str, tile: int, max_crops: int,
                           use_native: bool, pixel_dtype: str):
    """(pixel_values [max_crops, 3, t, t], crop_mask [max_crops]) for one
    record; ``record=None`` (text-only) yields zero slots so batch shapes
    stay uniform. Shared by the SFT dataset and the DPO preference dataset."""
    if record is None:
        return (np.zeros((max_crops, 3, tile, tile), getattr(np, pixel_dtype)),
                np.zeros((max_crops,), bool))
    from PIL import Image
    img = Image.open(os.path.join(image_folder, record["image"])).convert("RGB")
    if image_aspect_ratio in ("anyres", "any_res"):
        crops, mask, _ = process_anyres_image_host(
            img, tile=tile, max_crops=max_crops, use_native=use_native,
            normalize=pixel_dtype == "float32")
        return crops, mask
    one = process_pad_image_host(img, tile=tile)
    crops = np.zeros((max_crops,) + one.shape, np.float32)
    crops[0] = one
    mask = np.zeros((max_crops,), bool)
    mask[0] = True
    return crops, mask


def collate(items: Sequence[Dict], *, pad_token_id: int, seq_len: int) -> Dict[str, np.ndarray]:
    """Fixed-shape batch: ids/labels right-padded (truncated) to ``seq_len``,
    crops stacked at the fixed MAX_CROPS budget."""
    B = len(items)
    ids = np.full((B, seq_len), pad_token_id, np.int32)
    labels = np.full((B, seq_len), IGNORE_INDEX, np.int32)
    mask = np.zeros((B, seq_len), bool)
    for b, it in enumerate(items):
        n = min(len(it["input_ids"]), seq_len)
        ids[b, :n] = it["input_ids"][:n]
        labels[b, :n] = it["labels"][:n]
        mask[b, :n] = True
    return {
        "input_ids": ids,
        "labels": labels,
        "attention_mask": mask,
        "pixel_values": np.stack([it["pixel_values"] for it in items]),
        "crop_mask": np.stack([it["crop_mask"] for it in items]),
    }


class LengthGroupedSampler:
    """Megabatch length grouping with modality split (LLaVATrainer's
    get_modality_length_grouped_indices semantics): shuffle, bucket multimodal and
    text-only samples separately, sort each megabatch by length."""

    def __init__(self, lengths: Sequence[int], batch_size: int, *,
                 world_size: int = 1, seed: int = 0,
                 group_by_modality: bool = True):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.world_size = world_size
        self.seed = seed
        self.group_by_modality = group_by_modality

    def indices(self, epoch: int = 0) -> List[int]:
        rng = random.Random(self.seed + epoch)
        mega = self.batch_size * self.world_size * 50
        if self.group_by_modality and any(l < 0 for l in self.lengths) \
                and any(l > 0 for l in self.lengths):
            mm = [i for i, l in enumerate(self.lengths) if l > 0]
            txt = [i for i, l in enumerate(self.lengths) if l <= 0]
            rng.shuffle(mm)
            rng.shuffle(txt)
            out = []
            for pool in (mm, txt):
                for s in range(0, len(pool), mega):
                    chunk = sorted(pool[s:s + mega],
                                   key=lambda i: abs(self.lengths[i]), reverse=True)
                    out.extend(chunk)
            return out
        idx = list(range(len(self.lengths)))
        rng.shuffle(idx)
        out = []
        for s in range(0, len(idx), mega):
            out.extend(sorted(idx[s:s + mega],
                              key=lambda i: abs(self.lengths[i]), reverse=True))
        return out


def data_loader(dataset: SupervisedDataset, *, batch_size: int, seq_len: int,
                pad_token_id: int, shuffle: bool = True, seed: int = 0,
                group_by_modality_length: bool = False, drop_last: bool = True,
                num_workers: int = 0):
    """Simple epoch iterator yielding collated numpy batches.

    num_workers > 0 uses a thread pool to overlap image decode/preprocess with
    device compute (PIL releases the GIL during decode/resize).
    """
    if group_by_modality_length:
        order = LengthGroupedSampler(dataset.modality_lengths, batch_size,
                                     seed=seed).indices()
    else:
        order = list(range(len(dataset)))
        if shuffle:
            random.Random(seed).shuffle(order)

    def get(i):
        return dataset[i]

    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(num_workers)
        for s in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            chunk = order[s:s + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            items = list(ex.map(get, chunk))
            yield collate(items, pad_token_id=pad_token_id, seq_len=seq_len)
    else:
        for s in range(0, len(order), batch_size):
            chunk = order[s:s + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            yield collate([get(i) for i in chunk],
                          pad_token_id=pad_token_id, seq_len=seq_len)


class Prefetcher:
    """Bounded-queue background input pipeline with stall accounting.

    Runs ``iterator`` in a daemon thread, keeping up to ``depth`` batches ready
    — the input-pipeline half of the reference's DataLoader(num_workers=4,
    pin_memory) (llava/train/train.py HF TrainingArguments +
    scripts/llama/llama3_8b_sft.sh:40), done the JAX way: host preprocessing
    (image decode / anyres slicing / tokenization / collation — PIL and the
    C++ preprocessor both release the GIL) AND the host->device transfer
    (``map_fn``, e.g. mesh shard_batch) run in the producer thread, so a ready
    device-resident batch always awaits the consumer while the previous step
    executes.

    ``stall_s`` accumulates the time the CONSUMER spent blocked on an empty
    queue — divide by the loop's wall time for the host-stall fraction the
    trainer logs (docs/Training.md). Producer exceptions re-raise at the
    consuming side; the daemon thread never blocks interpreter shutdown."""

    _END = object()

    def __init__(self, iterator, depth: int = 2, map_fn=None):
        import queue as _queue
        import threading as _threading

        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(depth, 1))
        self.stall_s = 0.0
        self.batches = 0

        def producer():
            try:
                for item in iterator:
                    self._q.put(map_fn(item) if map_fn is not None else item)
                self._q.put(Prefetcher._END)
            except BaseException as e:  # noqa: BLE001 — surface on the consumer
                self._q.put(e)

        self._t = _threading.Thread(target=producer, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        import time as _time

        if self._q.empty():
            t0 = _time.perf_counter()
            item = self._q.get()
            self.stall_s += _time.perf_counter() - t0
        else:
            item = self._q.get()
        if item is Prefetcher._END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        self.batches += 1
        return item


def prefetch(iterator, depth: int = 2):
    """Generator view of Prefetcher (kept for callers that don't need stall
    stats)."""
    yield from Prefetcher(iterator, depth=depth)
