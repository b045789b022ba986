"""Parity tests: anyres slicer math vs the reference implementation."""
import numpy as np
import pytest

from slime_jax.constants import MAX_CROPS
from slime_jax.data import anyres

from .ref_loader import load_ref_modules

ref_pi, ref_mm = load_ref_modules()

SIZES = [
    (336, 336), (672, 672), (1024, 768), (768, 1024), (1920, 1080), (1080, 1920),
    (500, 500), (337, 336), (2048, 2048), (4032, 3024), (100, 100), (336, 1344),
    (1344, 336), (641, 481), (800, 600), (1234, 567), (567, 1234), (3000, 1000),
    (1000, 3000), (353, 353), (710, 710),
]


@pytest.mark.parametrize("w,h", SIZES)
def test_compute_slice_grid_matches_reference(w, h):
    assert anyres.compute_slice_grid(w, h) == ref_pi.cal_num_of_slices(w, h)


@pytest.mark.parametrize("w,h", SIZES)
def test_select_best_resolution_uhd_matches_reference(w, h):
    ours = anyres.select_best_resolution_uhd((w, h), (336, 336))
    theirs = ref_mm.select_best_resolution_uhd((w, h), (336, 336))
    assert ours == theirs


@pytest.mark.parametrize("w,h", SIZES)
def test_adapt_size_matches_reference(w, h):
    assert anyres.adapt_size(h, w) == ref_pi.adapt_size(h, w)


@pytest.mark.parametrize("w,h", SIZES)
def test_get_patch_nums_matches_reference(w, h):
    assert anyres.get_patch_nums(w, h) == ref_pi.get_patch_nums(w, h)


def test_select_best_resolution_pinpoints():
    pins = [(336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008)]
    for w, h in SIZES:
        assert (anyres.select_best_resolution((w, h), pins)
                == ref_mm.select_best_resolution((w, h), pins))


@pytest.mark.parametrize("w,h", SIZES)
def test_crop_budget_never_exceeded(w, h):
    cols, rows = anyres.get_anyres_image_grid_shape((w, h))
    assert 1 + cols * rows <= MAX_CROPS


def test_resize_and_pad_geometry():
    # geometry must match the reference resize_and_pad_image paste placement
    from PIL import Image
    for (w, h) in [(1000, 700), (250, 900), (336, 336)]:
        target = anyres.select_best_resolution_uhd((w, h))
        (nw, nh), (px, py) = anyres.resize_and_pad_geometry((w, h), target)
        img = Image.new("RGB", (w, h), (255, 0, 0))
        ref_out = ref_mm.resize_and_pad_image(img, target)
        arr = np.asarray(ref_out)
        # red area of the reference output equals our computed geometry
        red = (arr[:, :, 0] > 200)
        ys, xs = np.nonzero(red)
        assert xs.min() == px and ys.min() == py
        assert xs.max() == px + nw - 1 and ys.max() == py + nh - 1


def test_slice_boxes_cover_image():
    for (w, h) in [(1000, 700), (700, 1000), (672, 672)]:
        boxes = anyres.slice_boxes(w, h)
        cols, rows = anyres.compute_slice_grid(w, h)
        assert len(boxes) == cols * rows
        assert boxes[-1][2] == w and boxes[-1][3] == h
