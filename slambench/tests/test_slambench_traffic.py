"""The traffic generator: the same log from the same seed, another from
another, and the torch ray march equal to the program's NumPy march."""

import numpy as np

from traffic import corridor

SMALL = {"laps": 0.04, "laser": {"angle_min": -2.356194490192345, "angle_max": 2.356194490192345,
                                 "range_min": 0.05, "range_max": 10.0, "num_beams": 91,
                                 "range_threshold_scale": 0.95, "scan_time": 0.025}}


def small_log(seed):
    return corridor.make_log({**corridor.load_mix("corridor_lap"), **SMALL}, seed, "cpu")


def test_same_seed_same_log_and_a_large_seed():
    a, b = small_log(2 ** 31 + 17), small_log(2 ** 31 + 17)
    for k in ("ranges", "odom", "times", "gt"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    c = small_log(5)
    assert not np.array_equal(a.ranges, c.ranges) and not np.array_equal(a.odom, c.odom)
    assert np.array_equal(a.gt, c.gt) and np.array_equal(a.times, c.times)


def test_march_equals_the_numpy_march():
    from roborts_slam_tpu_torch.io.pgm import GroundTruthMap
    from roborts_slam_tpu_torch.io.simulate import raycast
    from roborts_slam_tpu_torch.models.scan import LaserModel

    occ, res, origin = corridor.corridor_world()
    rng = np.random.default_rng(0)
    occ = occ[:120, :160].copy()
    occ[rng.integers(0, 120, 60), rng.integers(0, 160, 60)] = True
    gt = GroundTruthMap(occupancy=occ, free=~occ, resolution=res, origin=origin)
    laser = LaserModel(angle_min=-2.3, angle_max=2.3, range_min=0.05, range_max=4.0,
                       num_beams=301)
    poses = np.array([[1.0, 1.2, 0.3], [3.3, 2.05, -2.0], [6.0, 0.5, 1.57], [0.4, 4.0, 3.0]])
    got = corridor.march(occ, res, origin, poses, laser.angles, laser.range_max, "cpu",
                         chunk=3).numpy().astype(np.float32)
    want = np.stack([raycast(gt, p, laser) for p in poses])
    got = np.clip(got, 0.0, laser.range_max)          # as make_log clips after the noise
    assert np.array_equal(got, want)


def test_world_and_path_as_the_parity_harness():
    from roborts_slam_tpu_torch.bench import parity

    occ, res, origin = corridor.corridor_world()
    g = parity.corridor_loop_map()
    assert np.array_equal(occ, g.occupancy) and np.array_equal(origin, g.origin)
    assert np.array_equal(corridor.corridor_path(1.15), parity.corridor_loop_path(1.15))
    traj = corridor.path_to_trajectory(corridor.corridor_path(1.15), 1.0, 10.0)
    assert len(traj) == 762
    assert len(corridor.path_to_trajectory(corridor.corridor_path(3.15), 1.0, 10.0)) == 2087
    assert np.array_equal(corridor.Laser(**corridor.load_mix("corridor_lap")["laser"]).to_array(),
                          parity.loop_laser().to_array())
