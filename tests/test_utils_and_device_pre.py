"""Utils (metrics logger, step timer, profiler) + fused device anyres preprocessing
vs the host path."""
import json
import os

import numpy as np
import pytest

from slime_jax import utils
from slime_jax.data import anyres
from slime_jax.data.image_ops import make_device_anyres_fn, process_anyres_image_host


def test_metrics_logger(tmp_path):
    ml = utils.MetricsLogger(str(tmp_path / "m.jsonl"))
    ml.log({"loss": 1.5}, step=1)
    ml.log({"loss": 1.2}, step=2)
    recs = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert recs[1] == {"loss": 1.2, "step": 2}


def test_step_timer():
    st = utils.StepTimer()
    for _ in range(3):
        with st:
            pass
    s = st.summary()
    assert s["n"] == 3 and s["mean_s"] >= 0


def test_profile_trace(tmp_path):
    import jax.numpy as jnp
    with utils.profile_trace(str(tmp_path / "trace")):
        _ = jnp.zeros((8, 8)).sum()
    # trace directory created with content
    assert os.path.isdir(tmp_path / "trace")


def test_rank0_print(capsys):
    utils.rank0_print("hello")
    assert "hello" in capsys.readouterr().out


def test_device_anyres_matches_host(rng):
    import jax

    h, w = 500, 700
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    fn = make_device_anyres_fn((h, w))
    crops_d, mask_d = fn(img)
    crops_d = np.asarray(crops_d)
    mask_d = np.asarray(mask_d)

    from PIL import Image
    crops_h, mask_h, grid = process_anyres_image_host(Image.fromarray(img))
    np.testing.assert_array_equal(mask_d, mask_h)
    n = int(mask_h.sum())
    # device resize now uses the same PIL-style weights as the host path;
    # remaining delta is uint8 rounding in PIL's pipeline
    assert np.abs(crops_d[:n] - crops_h[:n]).mean() < 0.02


def test_device_anyres_grid_selection():
    # grid geometry must follow the same UHD rule as the host math
    fn = make_device_anyres_fn((336, 1344))
    img = np.zeros((336, 1344, 3), np.uint8)
    _, mask = fn(img)
    bw, bh = anyres.select_best_resolution_uhd((1344, 336))
    assert int(np.asarray(mask).sum()) == 1 + (bw // 336) * (bh // 336)
