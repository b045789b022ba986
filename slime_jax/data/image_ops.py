"""Image preprocessing: anyres slicing + CLIP normalization.

Two implementations of the same pipeline:

1. **Host path** (PIL + numpy): mirrors the reference semantics
   (``process_anyres_image`` llava/mm_utils.py:177-210, ``process_images``
   llava/mm_utils.py:231-259) for data loading and serving.
2. **Device path** (pure JAX): a fused resize+pad+divide+normalize program that runs
   the whole anyres pipeline on the device (bench_vision.py, serving). Shapes are
   static per (grid) configuration so XLA compiles one program per grid.

Outputs are always padded to a fixed crop count ``MAX_CROPS`` with a boolean
``crop_mask`` — the static-shape replacement for the reference's ragged lists (the
reference itself pads to a fixed count for ZeRO-3: llava/train/train.py:903-926).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..constants import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, IMAGE_HEIGHT,
                         IMAGE_WIDTH, MAX_CROPS)
from . import anyres

try:  # PIL is available in the baked image (torchvision dep); gate anyway.
    from PIL import Image
    HAS_PIL = True
except ImportError:  # pragma: no cover
    HAS_PIL = False

_MEAN = np.asarray(CLIP_IMAGE_MEAN, dtype=np.float32).reshape(3, 1, 1)
_STD = np.asarray(CLIP_IMAGE_STD, dtype=np.float32).reshape(3, 1, 1)


def clip_normalize(chw: np.ndarray) -> np.ndarray:
    """uint8/float [3,H,W] in [0,255] -> CLIP-normalized float32."""
    x = chw.astype(np.float32) / 255.0
    return (x - _MEAN) / _STD


def _pil_to_chw(img) -> np.ndarray:
    return np.asarray(img.convert("RGB"), dtype=np.uint8).transpose(2, 0, 1)


def expand2square_np(chw: np.ndarray, fill: Tuple[int, int, int]) -> np.ndarray:
    """Pad an image to a square canvas, centered (reference llava/mm_utils.py:217-228)."""
    c, h, w = chw.shape
    if h == w:
        return chw
    side = max(h, w)
    out = np.empty((c, side, side), dtype=chw.dtype)
    out[:] = np.asarray(fill, dtype=chw.dtype).reshape(3, 1, 1)
    y0 = (side - h) // 2
    x0 = (side - w) // 2
    out[:, y0:y0 + h, x0:x0 + w] = chw
    return out


def _resize_pil(img, size: Tuple[int, int], resample=None):
    if resample is None:
        resample = Image.BICUBIC
    return img.resize(size, resample)


def process_anyres_image_host(img, *, tile: int = IMAGE_WIDTH,
                              max_crops: int = MAX_CROPS, use_native: bool = False,
                              normalize: bool = True
                              ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """PIL image -> (crops [max_crops,3,336,336], crop_mask [max_crops] bool,
    grid (cols, rows)).

    crops[0] is the global 336x336 view; crops[1:1+cols*rows] are the local tiles of the
    resize-and-padded image, row-major; the rest are zero-padded with mask False.
    use_native routes through the C++ library (native/slime_preprocess.cpp) when built.

    normalize=True emits CLIP-normalized float32 crops (the reference layout).
    normalize=False emits raw uint8 crops — the PIL path already passes
    through uint8 after resize, so this is exactly the same data at 1/4 the
    host->device bytes; CLIP normalization happens on device
    (slime.encode_images accepts uint8 pixel_values).
    """
    if use_native:
        from . import native
        if native.available():
            arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
            return native.anyres_preprocess_native(arr, tile=tile,
                                                   max_crops=max_crops,
                                                   normalize=normalize)
    img = img.convert("RGB")
    best = anyres.select_best_resolution_uhd(img.size, (tile, tile))
    (nw, nh), (px, py) = anyres.resize_and_pad_geometry(img.size, best)
    resized = _resize_pil(img, (nw, nh))
    canvas = Image.new("RGB", best, (0, 0, 0))
    canvas.paste(resized, (px, py))

    cols, rows = best[0] // tile, best[1] // tile
    n_local = cols * rows
    assert 1 + n_local <= max_crops, f"grid {cols}x{rows} exceeds crop budget {max_crops}"

    post = clip_normalize if normalize else (lambda x: x)
    out = np.zeros((max_crops, 3, tile, tile),
                   dtype=np.float32 if normalize else np.uint8)
    mask = np.zeros((max_crops,), dtype=bool)

    # Global view: plain square resize (reference uses processor shortest_edge resize)
    out[0] = post(_pil_to_chw(_resize_pil(img, (tile, tile))))
    mask[0] = True

    canvas_np = _pil_to_chw(canvas)
    k = 1
    for j in range(rows):
        for i in range(cols):
            out[k] = post(canvas_np[:, j * tile:(j + 1) * tile, i * tile:(i + 1) * tile])
            mask[k] = True
            k += 1
    return out, mask, (cols, rows)


def process_pad_image_host(img, *, tile: int = IMAGE_WIDTH) -> np.ndarray:
    """'pad' mode: expand to square with CLIP-mean fill, resize to 336, normalize.
    (reference llava/mm_utils.py:234-238)"""
    fill = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
    chw = expand2square_np(_pil_to_chw(img), fill)
    sq = Image.fromarray(chw.transpose(1, 2, 0))
    return clip_normalize(_pil_to_chw(_resize_pil(sq, (tile, tile))))


def process_naive_image_host(img, *, tile: int = IMAGE_WIDTH, stride: int = 308,
                             resize_width: int = 1024,
                             max_crops: int = MAX_CROPS
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """'pad_then_devide' mode (reference process_image_naive,
    llava/process_image.py:204-214): expand to square, resize to a fixed width,
    slide a tile-sized window with the given stride; global square view first."""
    fill = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
    sq = Image.fromarray(expand2square_np(_pil_to_chw(img), fill).transpose(1, 2, 0))
    out = np.zeros((max_crops, 3, tile, tile), dtype=np.float32)
    mask = np.zeros((max_crops,), dtype=bool)
    out[0] = clip_normalize(_pil_to_chw(_resize_pil(sq, (tile, tile))))
    mask[0] = True
    scale = resize_width / sq.size[0]
    resized = _resize_pil(sq, (resize_width, int(sq.size[1] * scale)))
    arr = _pil_to_chw(resized)
    k = 1
    for y in range(0, arr.shape[1] - tile + 1, stride):
        for x in range(0, arr.shape[2] - tile + 1, stride):
            if k >= max_crops:
                break
            out[k] = clip_normalize(arr[:, y:y + tile, x:x + tile])
            mask[k] = True
            k += 1
    return out, mask


def spatial_local_perm(cols: int, rows: int, grid: int,
                       max_local_tokens: int) -> np.ndarray:
    """Token permutation turning per-crop-major local tokens into row-major spatial
    order (reference 'spatial' merge, llava_arch.py:235-244: view
    [rows, cols, g, g, H] -> permute -> flatten). Identity on padded tail."""
    n = cols * rows * grid * grid
    idx = np.arange(n).reshape(rows, cols, grid, grid)
    idx = idx.transpose(0, 2, 1, 3).reshape(-1)
    out = np.arange(max_local_tokens, dtype=np.int32)
    out[:n] = idx
    return out


def process_images_host(images: List, mode: str = "anyres", *,
                        max_crops: int = MAX_CROPS):
    """Dispatcher over preprocessing modes (reference ``process_images``).

    Returns (pixel_values, crop_masks, image_sizes):
      - anyres: [B, max_crops, 3, 336, 336], [B, max_crops], [(w,h)]*B
      - pad/square: [B, 3, 336, 336], None, [(w,h)]*B
    """
    sizes = [im.size for im in images]
    if mode == "pad_then_devide":
        crops, masks = [], []
        for im in images:
            c, m = process_naive_image_host(im, max_crops=max_crops)
            crops.append(c)
            masks.append(m)
        return np.stack(crops), np.stack(masks), sizes
    if mode in ("anyres", "any_res"):
        crops, masks = [], []
        for im in images:
            c, m, _ = process_anyres_image_host(im, max_crops=max_crops)
            crops.append(c)
            masks.append(m)
        return np.stack(crops), np.stack(masks), sizes
    elif mode == "pad":
        return np.stack([process_pad_image_host(im) for im in images]), None, sizes
    else:  # square / default
        out = []
        for im in images:
            out.append(clip_normalize(_pil_to_chw(_resize_pil(im.convert("RGB"),
                                                              (IMAGE_WIDTH, IMAGE_HEIGHT)))))
        return np.stack(out), None, sizes


# ----------------------------------------------------------------------------------
# Device path: fused JAX anyres preprocessing (resize + pad + divide + normalize).
# ----------------------------------------------------------------------------------

def make_device_anyres_fn(src_hw: Tuple[int, int], *, tile: int = IMAGE_WIDTH,
                          max_crops: int = MAX_CROPS):
    """Build a jitted fn: uint8 image [H,W,3] -> (crops [max_crops,3,336,336] f32, mask).

    The crop grid is a static function of ``src_hw``, so the whole pipeline — global
    resize, fit-resize, pad, tiling, normalization — compiles to one XLA program with
    no host round-trips. Resize uses jax.image bicubic (documented tolerance vs PIL;
    SURVEY.md §7 hard part (a)).
    """
    import jax
    import jax.numpy as jnp

    from ..models.layers import pil_resize_matrix

    h, w = src_hw
    best = anyres.select_best_resolution_uhd((w, h), (tile, tile))
    (nw, nh), (px, py) = anyres.resize_and_pad_geometry((w, h), best)
    cols, rows = best[0] // tile, best[1] // tile
    n_local = cols * rows

    mean = jnp.asarray(CLIP_IMAGE_MEAN, dtype=jnp.float32).reshape(3, 1, 1)
    std = jnp.asarray(CLIP_IMAGE_STD, dtype=jnp.float32).reshape(3, 1, 1)

    # Resize expressed as two PIL-exact weight matmuls (no gathers)
    gy = jnp.asarray(pil_resize_matrix(h, tile))
    gx = jnp.asarray(pil_resize_matrix(w, tile))
    fy = jnp.asarray(pil_resize_matrix(h, nh))
    fx = jnp.asarray(pil_resize_matrix(w, nw))

    def _resize(x, wy, wx):
        # x [H,W,3]; out [h', w', 3]
        t = jnp.einsum("oh,hwc->owc", wy, x, preferred_element_type=jnp.float32)
        return jnp.einsum("pw,owc->opc", wx, t, preferred_element_type=jnp.float32)

    def fn(img_hwc: "jax.Array") -> Tuple["jax.Array", "jax.Array"]:
        x = img_hwc.astype(jnp.float32) / 255.0  # [H,W,3]
        # Global view
        g = _resize(x, gy, gx)
        # Fit-resize + center pad into the best-resolution canvas
        r = _resize(x, fy, fx)
        canvas = jnp.zeros((best[1], best[0], 3), dtype=jnp.float32)
        canvas = jax.lax.dynamic_update_slice(canvas, r, (py, px, 0))
        # Tile into (rows*cols) local crops: [rows, tile, cols, tile, 3]
        tiles = canvas.reshape(rows, tile, cols, tile, 3).transpose(0, 2, 1, 3, 4)
        tiles = tiles.reshape(n_local, tile, tile, 3)
        stack = jnp.concatenate([g[None], tiles], axis=0)      # [1+n_local, t, t, 3]
        stack = stack.transpose(0, 3, 1, 2)                     # CHW
        stack = (jnp.clip(stack, 0.0, 1.0) - mean) / std
        pad = max_crops - (1 + n_local)
        stack = jnp.pad(stack, ((0, pad), (0, 0), (0, 0), (0, 0)))
        mask = jnp.arange(max_crops) < (1 + n_local)
        return stack, mask

    return jax.jit(fn)


def unpad_token_order(cols: int, rows: int, grid: int,
                      original_size: Tuple[int, int], budget: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-computed token order for the LLaVA-NeXT 'unpad' patch merge
    (reference llava_arch.py:314-331): arrange per-crop tokens spatially, drop the
    rows/columns that came from aspect-ratio padding, and append a newline token at
    the end of every kept row.

    Returns (src [budget] int32, valid [budget] bool): src indexes crop-major
    local tokens; newline slots carry -1 (the consumer maps them to its learned
    newline embedding). Padded slots have valid=False.
    """
    n_loc = cols * rows * grid * grid
    gw, gh = cols * grid, rows * grid           # spatial token grid (w, h)
    ow, oh = original_size

    # which spatial rows/cols survive unpadding (centered fit, llava_arch.py:122-150)
    if ow / oh > gw / gh:
        # padding was vertical: keep the middle rows
        new_h = int(oh * (gw / ow))
        pad = (gh - new_h) // 2
        keep_rows = range(pad, gh - pad)
        keep_cols = range(gw)
    else:
        new_w = int(ow * (gh / oh))
        pad = (gw - new_w) // 2
        keep_rows = range(gh)
        keep_cols = range(pad, gw - pad)

    # crop-major token index of spatial position (r, c)
    def tok(r, c):
        cr, cc = r // grid, c // grid
        ir, ic = r % grid, c % grid
        return ((cr * cols + cc) * grid + ir) * grid + ic

    src = np.full((budget,), -1, np.int32)
    valid = np.zeros((budget,), bool)
    k = 0
    for r in keep_rows:
        for c in keep_cols:
            if k >= budget:
                break
            src[k] = tok(r, c)
            valid[k] = True
            k += 1
        if k < budget:
            src[k] = -1             # newline sentinel
            valid[k] = True
            k += 1
    return src, valid
