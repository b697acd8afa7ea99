"""The benchmark's frozen scene, orbit and ray caster agree with the
port's synthetic generator (nice_slam_torch/utils/synthetic.py), and the
stream it makes is closed, seeded and clear of the camera."""

import numpy as np
import pytest
import torch

from benchmark import registry
from benchmark.traffic import stream as st
from nice_slam_torch.utils import synthetic

SCENES = {"replica_room0": None, "scannet_scene0000": None}


def _both(name):
    d = registry.config(name)["scene"]
    mine = st.scene_from_dict(d)
    theirs = synthetic.SyntheticScene(
        room_lo=mine.room_lo, room_hi=mine.room_hi,
        spheres=[synthetic.Sphere(c, r, a) for c, r, a in mine.spheres],
        boxes=[synthetic.Box(lo, hi, a) for lo, hi, a in mine.boxes],
        wall_albedo=mine.wall_albedo, light_dir=mine.light_dir)
    return mine, theirs


@pytest.mark.parametrize("name", sorted(SCENES))
def test_orbit_equals_orbit_trajectory(name):
    mine, theirs = _both(name)
    a = st.orbit_poses(mine, 40, 0.02 * 40)
    b = synthetic.orbit_trajectory(theirs, 40)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_agrees_with_render_frame(name):
    """Colour within 1e-6 and depth within 1e-5 m (float32 outputs of two
    float64 casters) on every pixel of a 36 x 52 frame."""
    mine, theirs = _both(name)
    poses = synthetic.orbit_trajectory(theirs, 12)
    cam = dict(H=36, W=52, fx=30.0, fy=30.0, cx=25.5, cy=17.5)
    for k in (0, 11):
        c_ref, d_ref = synthetic.render_frame(theirs, poses[k], **cam)
        col, z = st.render_views(
            mine, torch.as_tensor(poses[k:k + 1], dtype=torch.float64),
            **cam)
        np.testing.assert_allclose(col[0].numpy().astype(np.float32), c_ref,
                                   atol=1e-6)
        np.testing.assert_allclose(z[0].numpy().astype(np.float32), d_ref,
                                   atol=1e-5)


def test_stream_is_closed_and_seeded():
    conf = registry.config("replica_room0")
    traffic = dict(registry.traffic("orbit_fixed"), views=21, phase="seed")
    cam = dict(H=12, W=16, fx=8.0, fy=8.0, cx=7.5, cy=5.5,
               png_depth_scale=6553.5)
    a = st.make_stream(traffic, conf["scene"], cam, 2**33 + 5, "cpu")
    b = st.make_stream(traffic, conf["scene"], cam, 2**33 + 5, "cpu")
    c = st.make_stream(traffic, conf["scene"], cam, 7, "cpu")
    np.testing.assert_array_equal(a.colors, b.colors)
    np.testing.assert_array_equal(a.depths, b.depths)
    assert not np.array_equal(a.colors, c.colors)
    # one geometry for every seed: the same depths, in another order
    assert sorted(map(bytes, a.depths)) == sorted(map(bytes, c.depths))
    # frame k and frame k + views are the same view
    for x, y in zip(a.frame(3), a.frame(3 + 21)):
        np.testing.assert_array_equal(x, y)
    # the orbit closes: the step from the last view to the first is a
    # step like the others
    p = a.poses[:, :3, 3]
    steps = np.linalg.norm(np.diff(np.concatenate([p, p[:1]]), axis=0),
                           axis=1)
    assert steps.max() < 1.5 * steps.min()
    # the depth is whole steps of the png scale, the colour 8 bits
    q = a.depths * 6553.5
    np.testing.assert_allclose(q, np.round(q), atol=2e-3)
    assert a.colors.dtype == np.uint8


@pytest.mark.parametrize("name", sorted(SCENES))
def test_objects_clear_of_the_orbit(name):
    conf = registry.config(name)
    traffic = registry.traffic("orbit_fixed")
    tmpl = st.scene_from_dict(conf["scene"])
    eyes = st.orbit_poses(tmpl, traffic["views"], 2 * np.pi,
                          period=traffic["views"])[:, :3, 3]
    for seed in (0, 1, 2**31 + 11):
        sc = st.place_objects(tmpl, eyes.astype(np.float64),
                              np.random.default_rng(seed),
                              np.random.default_rng(seed + 1),
                              traffic["object_clearance_m"],
                              traffic["albedo_jitter"])
        gap = traffic["object_clearance_m"]
        for c, r, _ in sc.spheres:
            assert np.linalg.norm(eyes - c, axis=1).min() > r + gap
        for lo, hi, _ in sc.boxes:
            assert st._dist_to_box(eyes, lo, hi).min() > gap


def test_fixed_phase_gives_every_seed_the_same_views():
    conf = registry.config("scannet_scene0000")
    traffic = dict(registry.traffic("orbit_fixed"), views=9)
    cam = dict(H=10, W=12, fx=6.0, fy=6.0, cx=5.5, cy=4.5,
               png_depth_scale=1000.0)
    a = st.make_stream(traffic, conf["scene"], cam, 11, "cpu")
    b = st.make_stream(traffic, conf["scene"], cam, 2**32 + 11, "cpu")
    np.testing.assert_array_equal(a.depths, b.depths)
    np.testing.assert_array_equal(a.poses, b.poses)
    assert not np.array_equal(a.colors, b.colors)
