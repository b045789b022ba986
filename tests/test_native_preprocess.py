"""Native C++ preprocessing: builds, matches the PIL host path within tolerance,
and beats it on throughput."""
import time

import numpy as np
import pytest

from slime_jax.data import native
from slime_jax.data.anyres import select_best_resolution_uhd
from slime_jax.data.image_ops import process_anyres_image_host

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library failed to build")


def _rand_img(rng, h, w):
    return rng.integers(0, 255, (h, w, 3), np.uint8)


@pytest.mark.parametrize("h,w", [(500, 700), (1080, 1920), (336, 336), (900, 400)])
def test_grid_matches_python(h, w, rng):
    img = _rand_img(rng, h, w)
    _, mask, (cols, rows) = native.anyres_preprocess_native(img)
    bw, bh = select_best_resolution_uhd((w, h))
    assert (cols, rows) == (bw // 336, bh // 336)
    assert mask.sum() == 1 + cols * rows


@pytest.mark.parametrize("h,w", [(500, 700), (672, 672)])
def test_crops_close_to_pil_path(h, w, rng):
    from PIL import Image

    img = _rand_img(rng, h, w)
    crops_n, mask_n, _ = native.anyres_preprocess_native(img)
    pil = Image.fromarray(img)
    crops_p, mask_p, _ = process_anyres_image_host(pil)
    np.testing.assert_array_equal(mask_n, mask_p)
    # resampling kernels differ (PIL antialias bicubic vs torch-style bicubic):
    # images agree closely in normalized space
    n_valid = int(mask_n.sum())
    diff = np.abs(crops_n[:n_valid] - crops_p[:n_valid])
    assert float(diff.mean()) < 0.08, float(diff.mean())
    assert np.corrcoef(crops_n[:n_valid].ravel(),
                       crops_p[:n_valid].ravel())[0, 1] > 0.995


def test_square_preprocess(rng):
    img = _rand_img(rng, 448, 448)
    out = native.square_preprocess_native(img)
    assert out.shape == (3, 336, 336)
    assert np.isfinite(out).all()


def test_native_faster_than_pil(rng):
    from PIL import Image

    img = _rand_img(rng, 1080, 1920)
    pil = Image.fromarray(img)
    # warm
    native.anyres_preprocess_native(img)
    process_anyres_image_host(pil)

    t0 = time.perf_counter()
    for _ in range(5):
        native.anyres_preprocess_native(img)
    t_native = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(5):
        process_anyres_image_host(pil)
    t_pil = time.perf_counter() - t0
    # informational but enforce it's not drastically slower
    assert t_native < t_pil * 1.5, (t_native, t_pil)


def test_u8_output_matches_f32_native(rng):
    """uint8 transport (normalize=False): native u8 crops, CLIP-normalized,
    match the native f32 crops to one uint8 quantum."""
    from slime_jax.data.image_ops import clip_normalize

    img = _rand_img(rng, 500, 700)
    f32, m1, g1 = native.anyres_preprocess_native(img)
    u8, m2, g2 = native.anyres_preprocess_native(img, normalize=False)
    assert u8.dtype == np.uint8 and g1 == g2 and (m1 == m2).all()
    d = clip_normalize(u8) * m1[:, None, None, None] - f32
    # one quantum = (0.5/255)/min(std) ~= 0.0075
    assert np.abs(d).max() < 0.5 / 255 / 0.26 + 1e-5


def test_u8_output_matches_f32_pil(rng):
    """PIL fallback path: the crops already pass through uint8 after resize,
    so normalize(u8 crops) is EXACTLY the f32 path on valid crops."""
    from PIL import Image

    from slime_jax.data.image_ops import clip_normalize, process_anyres_image_host

    img = Image.fromarray(_rand_img(rng, 500, 700))
    f32, m1, _ = process_anyres_image_host(img, use_native=False)
    u8, m2, _ = process_anyres_image_host(img, use_native=False,
                                          normalize=False)
    assert u8.dtype == np.uint8 and (m1 == m2).all()
    np.testing.assert_array_equal(clip_normalize(u8) * m1[:, None, None, None],
                                  f32)
