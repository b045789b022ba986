"""End-to-end anyres preprocessing parity vs the reference implementation
(process_anyres_image with a locally-constructed CLIPImageProcessor)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from slime_jax.constants import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from slime_jax.data.image_ops import process_anyres_image_host

from .ref_loader import load_ref_modules

ref_pi, ref_mm = load_ref_modules()


@pytest.fixture(scope="module")
def processor():
    return transformers.CLIPImageProcessor(
        do_resize=True, size={"shortest_edge": 336},
        do_center_crop=True, crop_size={"height": 336, "width": 336},
        do_rescale=True, do_normalize=True,
        image_mean=list(CLIP_IMAGE_MEAN), image_std=list(CLIP_IMAGE_STD))


@pytest.mark.parametrize("w,h", [(700, 500), (672, 672), (1280, 720)])
@pytest.mark.parametrize("use_native", [False, True])
def test_anyres_stack_matches_reference(processor, w, h, use_native, rng):
    from PIL import Image

    if use_native:
        from slime_jax.data import native
        if not native.available():
            pytest.skip("native lib not built")

    arr = rng.integers(0, 255, (h, w, 3), np.uint8)
    img = Image.fromarray(arr)

    ref_stack = ref_mm.process_anyres_image(img, processor, "[[336,672]]").numpy()
    ours, mask, _ = process_anyres_image_host(img, use_native=use_native)
    n = ref_stack.shape[0]
    assert int(mask.sum()) == n
    diff = np.abs(ours[:n] - ref_stack)
    # identical pipeline; small deltas from PIL uint8 rounding between stages
    assert float(diff.mean()) < 0.03, (use_native, float(diff.mean()))
    assert float(np.median(diff)) < 0.02
