"""The port's host tools: transient-failure retry (nice_slam_torch/utils/
retry.py) with its use in run_torch.py, and the scene-yaml writer
(nice_slam_torch/tools/prep_own_data.py), held against the JAX
package's tools/prep_own_data.py.

- retry: the cases of tests/test_retry.py against the port's module
  (attempts, cleanup between attempts, give-up, non-transient at once,
  stats), with the port's markers: torch.distributed's rendezvous and
  transport errors are transient; the sticky CUDA errors, the CUDA
  allocator's out-of-memory error and the deterministic classes are not,
  whatever their message says.  run_torch.py resumes a retry from the
  newest checkpoint.
- prep_own_data: an intrinsic.json and a mesh written by the port's
  plyio give the JAX tool's yaml, byte for byte; the depth-frame bound of
  the port, which reads depth/*.png with its own codec (cv2 poisoned),
  equals the JAX tool's with a stub cv2 that returns the same arrays; a
  depth file that is not a PNG raises an error naming it.
- quality_study: with run_torch.py's subprocess replaced by a stub,
  finished (config, seed) pairs of study.json are skipped, failed seeds
  are recorded and left out of the summary, and the command line is
  run.py's with the port's runner and device.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nice_slam_torch.tools import prep_own_data  # noqa: E402
from nice_slam_torch.utils import retry  # noqa: E402
from nice_slam_torch.utils.plyio import write_ply  # noqa: E402
from nice_slam_torch.utils.retry import is_transient, retry_transient  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# retry

@pytest.mark.parametrize("exc", [
    torch.distributed.DistStoreError("timed out waiting for key rank/1"),
    torch.distributed.DistNetworkError("client socket has timed out"),
    RuntimeError("[../gloo/transport/tcp/pair.cc:534] Connection reset by "
                 "peer"),
    RuntimeError("Broken pipe"),
    RuntimeError("The client socket has failed to connect to "
                 "127.0.0.1:29500"),
    ConnectionError("Connection refused"),
], ids=["store", "network", "reset", "pipe", "connect", "refused"])
def test_distributed_failures_are_transient(exc):
    assert is_transient(exc)


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "CUDA error: misaligned address",
])
def test_sticky_cuda_errors_are_not_transient(msg):
    # even when the message also carries a transport marker
    assert not is_transient(RuntimeError(msg))
    assert not is_transient(RuntimeError(msg + " (Connection reset)"))


def test_program_errors_are_not_transient():
    assert not is_transient(ValueError("bad shape"))
    assert not is_transient(TypeError("Broken pipe, but typed"))
    assert not is_transient(RuntimeError("NaN encountered in loss"))
    assert not is_transient(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Connection reset"))

    class ShapeBug(ValueError):
        pass

    assert not is_transient(ShapeBug("Connection reset by peer"))


def test_retry_stats_recorded():
    calls = {"n": 0}
    stats = {}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise torch.distributed.DistNetworkError("socket closed")
        return "ok"

    assert retry_transient(flaky, attempts=3, sleep_s=0.0,
                           stats=stats) == "ok"
    assert stats["attempts"] == 2
    assert len(stats["transient_errors"]) == 1
    assert "socket closed" in stats["transient_errors"][0]


def test_retry_recovers_and_cleans_up_between_attempts():
    calls, cleaned = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("Connection reset by peer")
        return 42

    assert retry_transient(flaky, attempts=3, sleep_s=0.0,
                           cleanup=lambda: cleaned.append(calls["n"])) == 42
    assert calls["n"] == 3 and cleaned == [1, 2]


def test_retry_propagates_non_transient_immediately():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(RuntimeError):
        retry_transient(broken, attempts=3, sleep_s=0.0)
    assert calls["n"] == 1


def test_retry_gives_up_after_max_attempts():
    calls = {"n": 0}

    def always_down():
        calls["n"] += 1
        raise torch.distributed.DistStoreError("store unreachable")

    with pytest.raises(torch.distributed.DistStoreError):
        retry_transient(always_down, attempts=3, sleep_s=0.0)
    assert calls["n"] == 3


def test_run_torch_retry_resumes_from_newest_checkpoint(tmp_path,
                                                        monkeypatch, capsys):
    """A transient failure after frame 4's checkpoint: run_torch.py builds
    a new engine, resumes it from ckpts/00004.npz and finishes the run."""
    import yaml

    from nice_slam_torch.engine import SlamEngine

    out = tmp_path / "out"
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({
        "inherit_from": os.path.join(REPO, "configs", "Synthetic",
                                     "synthetic.yaml"),
        "dataset": "synthetic", "synthetic": {"n_frames": 7},
        "cam": {"H": 12, "W": 16, "fx": 12.0, "fy": 12.0, "cx": 7.5,
                "cy": 5.5, "crop_edge": 0},
        "mapping": {"every_frame": 2, "iters_first": 4, "iters": 2,
                    "pixels": 16, "ckpt_freq": 2, "color_refine": False},
        "tracking": {"iters": 2, "pixels": 16, "ignore_edge_W": 2,
                     "ignore_edge_H": 2},
        "rendering": {"N_samples": 4, "N_surface": 2},
        "data": {"output": str(out)}}))
    run = SlamEngine.run
    starts = []

    def flaky_run(self, n_frames=None, progress=False, start=None):
        starts.append(self.frames_done)
        if len(starts) == 1:
            run(self, n_frames=5)
            raise torch.distributed.DistNetworkError(
                "Connection reset by peer")
        return run(self, n_frames=n_frames)

    monkeypatch.setattr(SlamEngine, "run", flaky_run)
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    spec = importlib.util.spec_from_file_location(
        "run_torch_under_test", os.path.join(REPO, "run_torch.py"))
    rt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rt)
    rt.main([str(cfg), "--device", "cpu", "--no-mesh"])
    text = capsys.readouterr()
    assert starts == [0, 5]
    assert f"resumed from {out / 'ckpts' / '00004.npz'} at frame 5" \
        in text.out
    assert "[retry] transient failure in slam run (attempt 1/3)" in text.err
    summary = json.loads(text.out[text.out.index("{\n"):])
    assert summary["frames"] == 7 and summary["attempts"] == 2
    assert np.isfinite(summary["ate_rmse_m"])
    assert sorted(os.listdir(out / "ckpts")) == ["00002.npz", "00004.npz",
                                                 "00006.npz"]


# ---------------------------------------------------------------------------
# prep_own_data

def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_prep_own_data", os.path.join(REPO, "tools", "prep_own_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(tmp_path):
    folder = tmp_path / "capture"
    (folder / "depth").mkdir(parents=True)
    K = np.array([[60.0, 0.0, 39.5], [0.0, 61.0, 29.5], [0.0, 0.0, 1.0]])
    (folder / "intrinsic.json").write_text(json.dumps({
        "width": 80, "height": 60,
        "intrinsic_matrix": K.T.reshape(-1).tolist()}))
    return folder


def test_mesh_bound_yaml_equals_jax(tmp_path, monkeypatch):
    folder = _capture(tmp_path)
    rng = np.random.RandomState(0)
    write_ply(str(tmp_path / "mesh.ply"),
              rng.uniform(-2, 3, (50, 3)).astype(np.float32),
              rng.randint(0, 50, (30, 3)))
    mine, theirs = tmp_path / "port.yaml", tmp_path / "jax.yaml"
    prep_own_data.main([str(folder), "--mesh", str(tmp_path / "mesh.ply"),
                        "--depth_scale", "5000", "--output", str(mine)])
    monkeypatch.setattr(sys, "argv", [
        "prep_own_data.py", str(folder), "--mesh", str(tmp_path / "mesh.ply"),
        "--depth_scale", "5000", "--output", str(theirs)])
    _jax_tool().main()
    assert mine.read_text() == theirs.read_text()
    import yaml

    cfg = yaml.safe_load(mine.read_text())
    assert cfg["cam"]["fx"] == 60.0 and cfg["cam"]["cy"] == 29.5
    assert cfg["mapping"]["bound"] == cfg["mapping"]["marching_cubes_bound"]


def test_depth_bound_equals_jax_with_a_stub_cv2(tmp_path, monkeypatch):
    from nice_slam_torch.utils.imageio import write_png

    folder = _capture(tmp_path)
    rng = np.random.RandomState(1)
    depths = {}
    for k in range(5):
        path = folder / "depth" / f"{k:05d}.png"
        d = rng.randint(0, 6000, (60, 80)).astype(np.uint16)
        d[::7, ::5] = 0               # holes
        write_png(str(path), d)
        depths[str(path)] = d
    K = np.array([[60.0, 0.0, 39.5], [0.0, 61.0, 29.5], [0.0, 0.0, 1.0]])
    # the port reads the PNGs itself: no cv2
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = prep_own_data.bound_from_depths(str(folder), K, 1000.0)
    cv2 = types.ModuleType("cv2")
    cv2.IMREAD_UNCHANGED = -1
    cv2.imread = lambda p, flag: depths[str(p)].copy()
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    want = _jax_tool().bound_from_depths(str(folder), K, 1000.0)
    assert got == want
    # the farthest sampled depth, 1 m beyond, bounds -z
    far = max(float(d[::8, ::8].max()) for d in depths.values()) / 1000.0
    assert got[2][0] == pytest.approx(-far - 1.0, abs=1e-5)


def test_depth_bound_without_cv2_raises(tmp_path, monkeypatch):
    """Without cv2 the port still reads depth/*.png; a file there that is
    not a PNG raises an error naming it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    (tmp_path / "depth").mkdir()
    bad = tmp_path / "depth" / "00000.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(ValueError, match="00000.png"):
        prep_own_data.bound_from_depths(str(tmp_path), np.eye(3), 1000.0)


# ---------------------------------------------------------------------------
# quality_study

def test_quality_study_skips_finished_seeds(tmp_path, monkeypatch, capsys):
    from nice_slam_torch.tools import quality_study

    (tmp_path / "study.json").write_text(json.dumps(
        {"baseline": {"0": {"rmse": 0.05, "mean": 0.04, "max": 0.09}}}))
    calls = []

    def stub(yaml_path, seed, out_dir, frames, timeout, device):
        calls.append((yaml_path, seed, out_dir, frames, device))
        if seed == 2:
            return None
        return {"rmse": 0.01 * (seed + 1), "mean": 0.01, "max": 0.02}

    monkeypatch.setattr(quality_study, "run_seed", stub)
    summary = quality_study.main(["--seeds", "4", "--frames", "9",
                                  "--workdir", str(tmp_path),
                                  "--device", "cpu"])
    assert [c[1] for c in calls] == [1, 2, 3]
    assert calls[0] == (None, 1, str(tmp_path / "baseline_s1"), 9, "cpu")
    study = json.loads((tmp_path / "study.json").read_text())
    assert study["baseline"]["0"]["rmse"] == 0.05
    assert study["baseline"]["2"] is None
    assert summary == {"config": "baseline", "frames": 9, "seeds": 3,
                       "rmse_per_seed": [0.05, 0.02, 0.04], "worst": 0.05,
                       "mean": 0.0367}
    out = capsys.readouterr().out
    assert "baseline seed 2: FAIL" in out
    assert json.loads(out.strip().splitlines()[-1]) == summary
    # a second call finds every seed done and runs nothing
    calls.clear()
    assert quality_study.main(["--seeds", "4", "--frames", "9",
                               "--workdir", str(tmp_path)]) == summary
    assert calls == []


def test_quality_study_runs_run_torch(tmp_path, monkeypatch):
    """run_seed starts run_torch.py with run.py's study flags and reads the
    run's ate.json; a failed run gives None."""
    from nice_slam_torch.tools import quality_study

    seen = []

    def fake_run(cmd, cwd, timeout, stdout, stderr):
        seen.append(cmd)
        out = cmd[cmd.index("--output") + 1]
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "ate.json"), "w") as f:
            json.dump({"rmse": 0.03, "mean": 0.02, "max": 0.05}, f)
        return types.SimpleNamespace(returncode=len(seen) - 1)

    monkeypatch.setattr(quality_study.subprocess, "run", fake_run)
    out = str(tmp_path / "s0")
    got = quality_study.run_seed("ab.yaml", 3, out, 120, 60, "cuda")
    assert got == {"rmse": 0.03, "mean": 0.02, "max": 0.05}
    assert seen[0][1:] == [os.path.join(REPO, "run_torch.py"), "ab.yaml",
                           "--synthetic", "120", "--seed", "3",
                           "--no-mesh", "--output", out, "--device", "cuda"]
    assert quality_study.run_seed(None, 0, out, 120, 60) is None
