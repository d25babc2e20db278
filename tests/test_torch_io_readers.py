"""Port vs JAX package: the log readers and writers. The LZ4 codec
(``io/lz4.py``), rosbag v2.0 files (``io/rosbag.py``) and the native RSLG
log (``io/native_log.py``) in each direction: written by one package, read
by the other, arrays exact; the engine's ``run_stream`` over an RSLG log
against the JAX engine's, within the engine bar."""

import os

import numpy as np
import pytest
import torch

import roborts_slam_tpu as J
import roborts_slam_tpu.io.lz4 as jlz4
import roborts_slam_tpu.io.native_log as jnative
import roborts_slam_tpu.io.rosbag as jbag
import roborts_slam_tpu.io.scan_log as jlog
import roborts_slam_tpu.models.scan as jscan
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.io.lz4 as tlz4
import roborts_slam_tpu_torch.io.native_log as tnative
import roborts_slam_tpu_torch.io.rosbag as tbag
import roborts_slam_tpu_torch.io.scan_log as tlog
import roborts_slam_tpu_torch.models.scan as tscan
from roborts_slam_tpu_torch.ops.cuda import build
from tests.test_rosbag import _write_bag

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_YAML = os.path.join(REPO, "configs", "simulation.yaml")
PKG = {"jax": dict(lz4=jlz4, bag=jbag, log=jlog, scan=jscan, native=jnative),
       "port": dict(lz4=tlz4, bag=tbag, log=tlog, scan=tscan, native=tnative)}
DIRECTIONS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _log(pkg: str, n=12, beams=64, seed=0, gt=True):
    """A made-up log of ``n`` scans in package ``pkg``'s classes: ranges
    beyond the lidar's reach included, odometry angles across ±pi."""
    rng = np.random.default_rng(seed)
    m = PKG[pkg]
    laser = m["scan"].LaserModel(angle_min=-1.5, angle_max=1.5, range_min=0.05,
                                 range_max=8.0, num_beams=beams, scan_time=0.025)
    odom = np.stack([rng.normal(0, 2, n), rng.normal(0, 2, n),
                     np.linspace(-3.1, 3.1, n)], -1)
    return m["log"].ScanLog(ranges=rng.uniform(0.0, 9.0, (n, beams)).astype(np.float32),
                            odom=odom, times=100.0 + 0.1 * np.arange(n) + 1e-4 * rng.random(n),
                            laser=laser, gt_poses=odom + 0.01 if gt else None)


# ---- lz4 ----

def test_lz4_block_vectors():
    """Known-answer blocks (test_rosbag.py): a match copy, an overlapping
    (run-length) copy, literal tails; both packages decode them alike."""
    blocks = [
        (bytes([0x44]) + b"abcd" + (4).to_bytes(2, "little") + bytes([0x50]) + b"XYZWV",
         b"abcd" + b"abcdabcd" + b"XYZWV"),
        (bytes([0x16]) + b"a" + (1).to_bytes(2, "little") + bytes([0x50]) + b"tail.",
         b"a" * 11 + b"tail."),
    ]
    for blk, want in blocks:
        assert tlz4.decompress_block(blk) == jlz4.decompress_block(blk) == want


_rng = np.random.default_rng(0)
LZ4_DATA = {"empty": b"", "short": b"short", "pairs": b"ab" * 40000,
            "random": _rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
            "text": b"laser scan segment " * 5000}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("name", sorted(LZ4_DATA))
def test_lz4_frames_cross_package(name, writer, reader):
    """Frames compressed by one package decompress in the other; both
    compress to the same bytes."""
    data = LZ4_DATA[name]
    frame = PKG[writer]["lz4"].compress_frame(data)
    assert PKG[reader]["lz4"].decompress_frame(frame) == data
    assert tlz4.compress_frame(data) == jlz4.compress_frame(data)


# ---- rosbag ----

@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
@pytest.mark.parametrize("chunk_msgs", [3, 1000], ids=["chunked", "one_chunk"])
def test_bag_cross_package(tmp_path, writer, reader, compression, chunk_msgs):
    """``write_bag`` of one package, ``bag_to_scan_log`` of the other: the
    same ranges exactly, times to the nanosecond, odometry within 1e-9; the
    two readers give equal arrays."""
    log = _log(writer)
    path = str(tmp_path / "log.bag")
    PKG[writer]["bag"].write_bag(path, log, compression=compression, chunk_msgs=chunk_msgs)
    got = PKG[reader]["bag"].bag_to_scan_log(path)
    assert isinstance(got, PKG[reader]["log"].ScanLog) and len(got) == len(log)
    np.testing.assert_array_equal(got.ranges, log.ranges)
    np.testing.assert_allclose(got.times, log.times, atol=1e-9, rtol=0)
    np.testing.assert_allclose(got.odom[:, :2], log.odom[:, :2], atol=1e-9, rtol=0)
    dth = got.odom[:, 2] - log.odom[:, 2]
    assert np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max() < 1e-9
    assert got.laser.num_beams == log.laser.num_beams
    other = PKG["jax" if reader == "port" else "port"]["bag"].bag_to_scan_log(path)
    for a, b in ((got.ranges, other.ranges), (got.odom, other.odom), (got.times, other.times)):
        np.testing.assert_array_equal(a, b)
    assert got.laser.to_array().tolist() == other.laser.to_array().tolist()


@pytest.mark.parametrize("chunked,compression", [
    (False, "none"), (True, "none"), (True, "bz2"), (True, "lz4")])
def test_record_style_bags_read_alike(tmp_path, chunked, compression):
    """Bags laid out as ROS records them (test_rosbag.py's writer: records
    outside chunks, more odometry than scans, interpolation between odometry
    samples): both packages read the same messages and the same log."""
    path = str(tmp_path / "rec.bag")
    _write_bag(path, chunked, compression)
    jm, tm = list(jbag.read_bag_messages(path)), list(tbag.read_bag_messages(path))
    assert tm == jm and len(tm) == 12
    a, b = jbag.bag_to_scan_log(path), tbag.bag_to_scan_log(path)
    for x, y in ((a.ranges, b.ranges), (a.odom, b.odom), (a.times, b.times)):
        np.testing.assert_array_equal(x, y)


# ---- the native RSLG log ----

def test_native_library_is_built_in_the_port_build_directory():
    assert tnative.native_available()
    so = tnative._library_path()
    assert so.exists() and so.parent == build.BUILD_DIR
    assert so.parent.name == "_build" and so.parent.parent.name == "roborts_slam_tpu_torch"


def test_native_stream_raises_without_a_compiler(tmp_path, monkeypatch):
    """No ``g++`` and no library yet: the stream raises (as the JAX stream
    does); writing a log needs no native code."""
    path = str(tmp_path / "log.rslg")
    tnative.write_rslg(_log("port"), path)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_library_path", lambda: tmp_path / "libscanlog_missing.so")
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    assert not tnative.native_available()
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        tnative.NativeScanStream(path, max_points=96)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.decode_scan(path, 0, 96)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("gt", [True, False], ids=["with_truth", "no_truth"])
def test_rslg_cross_package(tmp_path, writer, reader, gt):
    """``write_rslg`` of one package (both write the same bytes), read by
    the other's ``NativeScanStream``: every scan, in order, with the content
    the JAX stream gives and ``decode_scan`` gives."""
    log = _log(writer, n=23, gt=gt)
    path = str(tmp_path / "log.rslg")
    PKG[writer]["native"].write_rslg(log, path)
    twin = str(tmp_path / "twin.rslg")
    PKG["jax" if writer == "port" else "port"]["native"].write_rslg(log, twin)
    with open(path, "rb") as f, open(twin, "rb") as g:
        assert f.read() == g.read()
    MP = 96
    streams = {name: PKG[name]["native"].NativeScanStream(path, max_points=MP, ring_slots=4)
               for name in ("jax", "port")}
    try:
        got = list(streams[reader])
        want = list(streams["jax" if reader == "port" else "port"])
        assert streams[reader].n_scans == 23
        assert streams[reader].laser.num_beams == 64
    finally:
        for s in streams.values():
            s.close()
    assert [g[0] for g in got] == list(range(23))
    for (i, pts, msk, nv, t, odom), (j, pts2, msk2, nv2, t2, odom2) in zip(got, want):
        assert i == j and nv == nv2 and t == t2 == log.times[i]
        np.testing.assert_array_equal(pts[:nv], pts2[:nv])
        np.testing.assert_array_equal(msk, msk2)
        assert msk[:nv].all() and not msk[nv:].any()
        np.testing.assert_array_equal(odom, log.odom[i])
        d = PKG[reader]["native"].decode_scan(path, i, MP)
        np.testing.assert_array_equal(d[0][:nv], pts[:nv])
        assert d[2] == nv and d[3] == t


def test_run_stream_matches_jax(tmp_path):
    """30 scans of the icra log as an RSLG file through each package's
    ``run_stream``: the same kept stamps, trajectories within the engine bar
    of test_torch_engine.py."""
    d = np.load(os.path.join(REPO, "tests", "data", "golden_icra.npz"))
    n = 30
    laser = tscan.LaserModel.from_array(d["laser"])
    path = str(tmp_path / "icra.rslg")
    tnative.write_rslg(tlog.ScanLog(d["ranges"][:n], d["odom"][:n], d["times"][:n], laser),
                       path)
    over = dict(fine_map_resolution=0.02, world_size=24.0)
    with _closing(jnative.NativeScanStream(path, 270)) as js:
        je = J.SlamEngine(J.load_config(SIM_YAML, **over), js.laser,
                          synchronous_backend=True, fused_backend=False)
        a = je.run_stream(js)
    with tnative.NativeScanStream(path, 270) as ts:
        te = T.SlamEngine(T.load_config(SIM_YAML, **over), ts.laser, device="cpu",
                          synchronous_backend=False)
        b = te.run_stream(ts)
    assert te.diag.scans_in == n and len(b) >= 25 and a.shape == b.shape
    # the port records odometry on this path too, so the pose stream moves
    # between kept scans: at the last kept stamp it is the last pose (1e-6)
    np.testing.assert_allclose(te.pose_at(b[-1, 0]), b[-1, 1:], atol=1e-6)
    assert len(te._odom_history) == n
    assert np.abs(te.pose_at(b[0, 0])[:2] - b[-1, 1:3]).max() > 0.1
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    dd = np.abs(a - b)
    dd[:, 3] = np.abs(np.arctan2(np.sin(dd[:, 3]), np.cos(dd[:, 3])))
    outliers = (dd[:, 1:3].max(1) > 2e-3) | (dd[:, 3] > 2e-3)
    assert outliers.sum() <= 3 and dd[:, 1:3].max() <= 0.01, dd.max(0)


class _closing:
    """Closes the JAX package's stream, which is no context manager."""

    def __init__(self, stream):
        self.stream = stream

    def __enter__(self):
        return self.stream

    def __exit__(self, *exc):
        self.stream.close()
