"""Checkpoints: the port's save/resume round trip, and the file format
shared with the JAX package.  A checkpoint the JAX engine writes resumes
in the port and one the port writes resumes in the JAX engine, NICE and
iMAP*, with every array equal (exact) and the same npz keys, dtypes and
shapes.  The JAX side only constructs engines and fills their state (no
tracking or mapping runs)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nice_slam_tpu import keyframes as jkf  # noqa: E402
from nice_slam_tpu.config import load_config as jax_load_config  # noqa: E402
from nice_slam_tpu.engine import SlamEngine as JaxSlamEngine  # noqa: E402
from test_slam import TEST_CFG  # noqa: E402

from nice_slam_torch import keyframes  # noqa: E402
from nice_slam_torch.config import load_config  # noqa: E402
from nice_slam_torch.engine import SlamEngine  # noqa: E402
from nice_slam_torch.utils.checkpoint import (  # noqa: E402
    _flatten,
    latest_checkpoint,
    store_arrays,
)

CFG = {**TEST_CFG, "synthetic": {"n_frames": 6}}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _port(nice, out, **ov):
    return SlamEngine(load_config(nice=nice, overrides={**CFG, **ov}),
                      output=str(out), device="cpu")


def _jax(nice, out, **ov):
    return JaxSlamEngine(jax_load_config(nice=nice, overrides={**CFG, **ov}),
                         output=str(out))


def _state(eng):
    """Seeded state for an engine of either package: a trajectory, two
    keyframes, their ids, ragged selected-keyframe rows, frames_done."""
    rng = np.random.RandomState(5)
    n = eng.n_img
    est = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    est[:, :3, 3] = rng.randn(n, 3).astype(np.float32)
    gt = est + rng.randn(n, 4, 4).astype(np.float32) * 1e-3
    frames = [eng.dataset[i] for i in (0, 4)]
    sel = {0: np.array([0, -2, 0], np.int64),
           4: np.array([0, 4, -2, -2, 4], np.int64)}
    if isinstance(eng, SlamEngine):
        eng.est_c2w_dev = torch.from_numpy(est)
        for (_, c, d, _), f in zip(frames, (0, 4)):
            keyframes.add_keyframe(eng.store, torch.from_numpy(c),
                                   torch.from_numpy(d),
                                   torch.from_numpy(est[f]),
                                   torch.from_numpy(gt[f]), f)
        eng.selected_keyframes = {k: torch.from_numpy(v)
                                  for k, v in sel.items()}
    else:
        eng.est_c2w = est
        for (_, c, d, _), f in zip(frames, (0, 4)):
            eng.store = jkf.add_keyframe(eng.store, jnp.asarray(c),
                                         jnp.asarray(d), jnp.asarray(est[f]),
                                         jnp.asarray(gt[f]), f)
        eng.selected_keyframes = dict(sel)
    eng.gt_c2w = gt
    eng.kf_frame_ids = [0, 4]
    eng.frames_done = 5
    return eng


def _arrays(eng):
    """Every array of an engine's state as numpy, flattened like the npz
    (the store as the JAX package's dtypes)."""
    out = {"est_c2w": eng.est_c2w, "gt_c2w": np.asarray(eng.gt_c2w),
           "kf_frame_ids": np.asarray(eng.kf_frame_ids, np.int64),
           "frames_done": np.asarray(eng.frames_done)}
    _flatten(eng.map_state.params, "params", out)
    _flatten(eng.map_state.grids, "grids", out)
    _flatten(store_arrays(eng.store) if isinstance(eng, SlamEngine)
             else eng.store._asdict(), "store", out)
    # selected-keyframe rows as saved: padded with -2 to the widest
    sel = {str(k): np.asarray(torch.as_tensor(np.asarray(v)))
           for k, v in eng.selected_keyframes.items()}
    w = max([len(r) for r in sel.values()], default=0)
    for k, r in sel.items():
        out[f"sel/{k}"] = np.pad(r, (0, w - len(r)), constant_values=-2)
    return out


def _assert_same_state(a, b):
    sa, sb = _arrays(a), _arrays(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_port_roundtrip(tmp_path):
    """tests/test_slam.py:102-119 on the port, after a real 5-frame run:
    frames_done, trajectory, grids, keyframe ids, the selected-keyframe
    record and every other array come back exactly."""
    eng = _port(True, tmp_path / "a",
                synthetic={"n_frames": 5},
                mapping={**CFG["mapping"], "iters_first": 30, "iters": 8})
    eng.run()
    # the final event wrote its checkpoint
    assert latest_checkpoint(str(tmp_path / "a" / "ckpts")).endswith(
        "00004.npz")
    p = str(tmp_path / "ck.npz")
    eng.save(p)
    eng2 = _port(True, tmp_path / "b", synthetic={"n_frames": 5})
    eng2.resume(p)
    assert eng2.frames_done == eng.frames_done == 5
    np.testing.assert_allclose(eng2.est_c2w, eng.est_c2w)
    np.testing.assert_allclose(eng2.map_state.grids["middle"].numpy(),
                               eng.map_state.grids["middle"].numpy())
    assert eng2.kf_frame_ids == eng.kf_frame_ids
    assert set(eng2.selected_keyframes) == set(eng.selected_keyframes)
    for i, row in eng.selected_keyframes.items():
        np.testing.assert_array_equal(eng2.selected_keyframes[i].numpy(),
                                      row.numpy())
    _assert_same_state(eng, eng2)
    # a resumed engine with nothing left to do returns at once
    assert eng2.run().frames_done == 5


@pytest.mark.parametrize("nice", [True, False], ids=["nice", "imap"])
def test_jax_checkpoint_resumes_in_port(tmp_path, nice):
    """A JAX-saved checkpoint resumes in the port with every array equal.
    The NICE run is occupancy-guided, so its file holds grids/occ_proxy,
    which an occupancy-guided port engine loads with the other grids; an
    engine without the proxy refuses the file."""
    ov = {"rendering": {**TEST_CFG["rendering"], "occupancy_guided": True}
          } if nice else {}
    j = _state(_jax(nice, tmp_path / "j", **ov))
    if nice:
        # a proxy away from its all-ones init
        j.map_state.grids = {**j.map_state.grids, "occ_proxy": jnp.asarray(
            np.random.RandomState(3).rand(
                *j.map_state.grids["occ_proxy"].shape), jnp.float32)}
    p = str(tmp_path / "j.npz")
    j.save(p)
    assert ("grids/occ_proxy" in _npz(p)) == nice
    t = _port(nice, tmp_path / "t", **ov).resume(p)
    _assert_same_state(j, t)
    if nice:
        with pytest.raises(ValueError, match="occ_proxy"):
            _port(nice, tmp_path / "u").resume(p)


@pytest.mark.parametrize("nice", [True, False], ids=["nice", "imap"])
def test_port_checkpoint_resumes_in_jax(tmp_path, nice):
    t = _state(_port(nice, tmp_path / "t"))
    p = str(tmp_path / "t.npz")
    t.save(p)
    j = _jax(nice, tmp_path / "j").resume(p)
    _assert_same_state(t, j)


@pytest.mark.parametrize("nice", [True, False], ids=["nice", "imap"])
def test_same_keys_dtypes_shapes(tmp_path, nice):
    """Both packages write the same npz keys with the same dtypes and
    shapes (keyframes/frame_idx int32, keyframes/count 0-d int32, ragged
    selkf_frames padded with -2)."""
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    _state(_jax(nice, tmp_path / "j")).save(pj)
    _state(_port(nice, tmp_path / "t")).save(pt)
    zj, zt = _npz(pj), _npz(pt)
    assert sorted(zj) == sorted(zt)
    assert not nice or any(k.startswith("grids/") for k in zt)
    assert nice or not any(k.startswith("grids/") for k in zt)
    for k in zj:
        assert (zj[k].dtype, zj[k].shape) == (zt[k].dtype, zt[k].shape), k
    assert zt["keyframes/frame_idx"].dtype == np.int32
    assert zt["keyframes/count"].shape == ()
    assert int(zt["keyframes/count"]) == 2
    np.testing.assert_array_equal(zt["extra/selkf_frames"],
                                  [[0, -2, 0, -2, -2], [0, 4, -2, -2, 4]])
    for k in ("keyframes/colors", "keyframes/frame_idx", "est_c2w",
              "extra/kf_frame_ids", "extra/selkf_frames", "idx"):
        np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)


def test_run_torch_resume_and_imap(tmp_path):
    """run_torch.py on the CPU: a 3-frame run writes ckpts/00002.npz
    (ckpt_freq 2), --resume <output> continues from it to the 4th frame,
    the last, and writes its final mesh (meshing is on by default; a
    16^3 volume here), and --imap runs iMAP* mode, with --profile writing
    its torch.profiler trace."""
    import json
    import os
    import subprocess
    import sys

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "out")
    cfg = str(tmp_path / "tiny.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({
            "inherit_from": os.path.join(repo, "configs", "Synthetic",
                                         "synthetic.yaml"),
            "synthetic": {"n_frames": 4},
            "cam": {"H": 24, "W": 32, "fx": 24.0, "fy": 24.0, "cx": 15.5,
                    "cy": 11.5, "crop_edge": 0},
            "tracking": {"iters": 2, "pixels": 40, "ignore_edge_W": 2,
                         "ignore_edge_H": 2},
            "mapping": {"iters_first": 6, "iters": 3, "pixels": 60,
                        "ckpt_freq": 2},
            "rendering": {"N_samples": 8, "N_surface": 4},
            "meshing": {"resolution": 16},
            "data": {"output": out}}, f)

    def run(*args):
        r = subprocess.run([sys.executable, "run_torch.py", cfg, "--device",
                            "cpu", *args], cwd=repo, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        return json.loads(r.stdout[r.stdout.index("{\n"):])

    assert run("--frames", "3")["frames"] == 3
    ck = os.path.join(out, "ckpts", "00002.npz")
    with np.load(ck) as z:
        assert int(z["idx"]) == 3
    # an output directory resumes from its latest checkpoint
    assert run("--resume", out)["frames"] == 4
    assert os.path.exists(os.path.join(out, "ckpts", "00003.npz"))
    assert os.path.exists(os.path.join(out, "mesh", "final_mesh.ply"))
    trace = str(tmp_path / "trace")
    assert run("--imap", "--frames", "2", "--profile", trace)["frames"] == 2
    with open(os.path.join(trace, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
