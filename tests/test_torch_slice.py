"""The whole slice: the 9-frame TEST_CFG run of tests/test_slam.py through
the PyTorch port on the CPU, from the same initial map (decoders and grids
carried across) as a JAX run of the same config.

The two packages draw different random streams (pixels, selections), so
this compares results, not bits: both ATEs < 0.25 m and within 0.05 m of
each other, the port's rendered depth at frame 0 within 0.15 m (median),
and the port's selected keyframe windows at the events {0, 4, 8}; the
run records of `stats()` (one per tracked frame, the JAX engine's keys,
finite losses, best <= first)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nice_slam_tpu.config import load_config as jax_load_config  # noqa: E402
from nice_slam_tpu.engine import SlamEngine as JaxSlamEngine  # noqa: E402
from test_slam import TEST_CFG  # noqa: E402

from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.convert import params_from_jax  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    out = tmp_path_factory.mktemp("slice")
    eng_j = JaxSlamEngine(jax_load_config(overrides=TEST_CFG),
                          output=str(out / "jax"))
    eng_t = SlamEngine(load_config(overrides=TEST_CFG),
                       output=str(out / "torch"), device="cpu")
    np.testing.assert_allclose(eng_t.bound.numpy(),
                               np.asarray(eng_j.map_state.bound))
    eng_t.map_state.params = params_from_jax(
        jax.tree.map(np.asarray, eng_j.map_state.params), device="cpu")
    eng_t.map_state.grids = params_from_jax(
        {k: np.asarray(v) for k, v in eng_j.map_state.grids.items()},
        device="cpu")
    eng_j.run()
    eng_t.run()
    return eng_j, eng_t


def test_trajectory_complete_and_finite(engines):
    _, eng = engines
    assert eng.frames_done == eng.n_img == 9
    assert np.isfinite(eng.est_c2w).all()
    assert eng.kf_frame_ids == [0, 4, 8]


def test_ate_close_to_jax(engines):
    eng_j, eng_t = engines
    ate_j = eng_j.ate()["rmse"]
    ate_t = eng_t.ate()["rmse"]
    assert ate_j < 0.25 and ate_t < 0.25, (ate_j, ate_t)
    assert abs(ate_t - ate_j) < 0.05, (ate_j, ate_t)


def test_rendered_depth_at_frame0(engines):
    from nice_slam_torch.render import render_image

    _, eng = engines
    _, _, depth, pose = eng.dataset[0]
    s = eng.specs
    dimg, _, _ = render_image(eng.map_state.params, s.model,
                              eng.map_state.grids, eng.bound,
                              torch.tensor(pose), s.camera, s.render,
                              "color", torch.tensor(depth))
    err = np.abs(dimg.numpy() - depth)
    assert float(np.median(err[depth > 0])) < 0.15


def test_selected_keyframe_windows(engines):
    _, eng = engines
    sel = {i: v.numpy() for i, v in eng.selected_keyframes.items()}
    assert set(sel) == {0, 4, 8}, sorted(sel)
    for idx, row in sel.items():
        assert idx in row.tolist(), (idx, row)
        valid = row[row >= 0]
        assert (valid <= idx).all(), (idx, row)
        for f in valid:
            assert f == idx or f in eng.kf_frame_ids, (idx, row)


def test_stats_records_match_jax(engines):
    eng_j, eng_t = engines
    rec_j, rec_t = eng_j.stats(), eng_t.stats()
    assert [r["idx"] for r in rec_t] == [r["idx"] for r in rec_j] \
        == list(range(1, 9))
    assert [list(r) for r in rec_t] == [list(r) for r in rec_j]
    for r in rec_t:
        v = [r["first_loss"], r["last_loss"], r["best_loss"]]
        assert all(isinstance(x, float) and np.isfinite(x) for x in v), r
        assert r["best_loss"] <= r["first_loss"], r
    # a second read returns the same records
    assert eng_t.stats() == rec_t
