"""The port's command line (``python -m roborts_slam_tpu_torch``): ``run``
over a small simulated log under the default configuration and under a
narrowed ``configs/real_robot.yaml``, held against the JAX engine on the same
log; what is not ported raises; nothing of the port imports JAX."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import roborts_slam_tpu as J
import roborts_slam_tpu_torch as T
import roborts_slam_tpu_torch.io.scenes as tscenes
from roborts_slam_tpu.io.scan_log import ScanLog as JScanLog
from roborts_slam_tpu.models.scan import LaserModel as JLaser
from roborts_slam_tpu_torch.__main__ import main
from roborts_slam_tpu_torch.bench import parity
from roborts_slam_tpu_torch.io.pgm import GroundTruthMap
from roborts_slam_tpu_torch.io.scan_log import ScanLog
from roborts_slam_tpu_torch.io.simulate import simulate_log
from roborts_slam_tpu_torch.models.scan import LaserModel
from tests import _torch_lockstep as L

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_YAML = os.path.join(REPO, "configs", "real_robot.yaml")
# the first 14 scans: on the 16th the optimizer's cost (19.06) passes within
# 5 % of the ``optimize_failed_cost`` bar (20), where the last bits decide
# which of the two poses the match takes, centimetres apart in both packages
N_SCANS = 14


SEED = 3                       # the log's odometry- and range-noise seed
# free runs over logs simulated from other seeds (the first is SEED's);
# the tests take FREE_VARIANTS
VARIANTS = (SEED, 11, 12, 13, 14, 15, 16, 17)
FREE_VARIANTS = VARIANTS[:3]


def room_log(seed: int = SEED) -> ScanLog:
    """The first scans of a simulated loop round a block in an 8 m x 6 m
    room (5 m lidar, 540 beams, 25 ms sweeps: dense enough for the
    unblurred 0.025 m fine map of the real-robot profile)."""
    res = 0.05
    H, W = int(6 / res), int(8 / res)
    occ = np.zeros((H, W), bool)
    occ[0, :] = occ[-1, :] = True
    occ[:, 0] = occ[:, -1] = True
    occ[int(2.5 / res):int(3.5 / res), int(3.2 / res):int(4.8 / res)] = True
    occ[int(1.0 / res):int(1.3 / res), int(1.5 / res):int(1.8 / res)] = True
    occ[int(4.6 / res):int(4.9 / res), int(6.0 / res):int(6.3 / res)] = True
    gt = GroundTruthMap(occupancy=occ, free=~occ, resolution=res,
                        origin=np.array([-4.0, -3.0]))
    laser = LaserModel(angle_min=-2.2, angle_max=2.2, range_min=0.1,
                       range_max=5.0, num_beams=540, scan_time=0.025)
    log = simulate_log(gt, laser, speed=0.6, scan_rate=5.0, n_waypoints=4,
                       seed=seed, range_noise=0.005)
    return ScanLog(log.ranges[:N_SCANS], log.odom[:N_SCANS], log.times[:N_SCANS],
                   laser, log.gt_poses[:N_SCANS])


@pytest.fixture(scope="module")
def log_path(tmp_path_factory):
    """``room_log()`` saved as ``.npz``."""
    path = str(tmp_path_factory.mktemp("cli") / "room.npz")
    room_log().save(path)
    return path


def real_robot_yaml(path: str) -> str:
    """``configs/real_robot.yaml`` narrowed to the room (640 points, a 6 m
    match-map window), written to ``path``."""
    with open(REAL_YAML) as f:
        raw = yaml.safe_load(f)
    raw.update(max_points=640, match_map_window=6.0)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


class _Recorded:
    """Keeps the engines ``run`` makes (``.made``) while in use."""

    def __enter__(self):
        import roborts_slam_tpu_torch.engine as tengine

        self.made, self._mod, self._cls = [], tengine, tengine.SlamEngine
        made = self.made

        class Recorded(self._cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        tengine.SlamEngine = Recorded
        return self

    def __exit__(self, *exc):
        self._mod.SlamEngine = self._cls


def free_run(seed: int, profile: str, tmp: str) -> tuple:
    """``run`` on the room log simulated from ``seed`` under ``profile``
    ("default": no ``--config``; "real_robot": the narrowed YAML), and the
    JAX engine on the same log. (JAX's record, the port's, what ``run``
    printed, the trajectory file it wrote)."""
    import contextlib
    import io

    path = os.path.join(tmp, f"room{seed}.npz")
    room_log(seed).save(path)
    out = os.path.join(tmp, f"traj{seed}_{profile}.txt")
    if profile == "default":
        argv, cfg = ["--max-points", "640"], J.SlamConfig(max_points=640)
    else:
        cfg_path = real_robot_yaml(os.path.join(tmp, "real_small.yaml"))
        argv, cfg = ["--config", cfg_path], J.load_config(cfg_path)
    said = io.StringIO()
    with _Recorded() as rec, contextlib.redirect_stdout(said):
        assert main(["run", path, "--device", "cpu", "--world-size", "14",
                     *argv, "--out-trajectory", out]) == 0
    eng, _ = _jax_run(cfg, path, 14.0)
    log = ScanLog.load(path)
    return (parity.run_record(eng, log.times, log.gt_poses),
            parity.run_record(rec.made[-1], log.times, log.gt_poses),
            said.getvalue(), np.loadtxt(out))


def _traj_diff(a, b):
    d = np.abs(a - b)
    d[:, 3] = np.abs(np.arctan2(np.sin(d[:, 3]), np.cos(d[:, 3])))
    return d


def _jax_run(cfg, path, world_size):
    log = JScanLog.load(path)
    eng = J.SlamEngine(cfg, log.laser, world_size=world_size,
                       synchronous_backend=True, fused_backend=False)
    return eng, eng.run_log(log)


FORMS = ["lockstep"] + [f"free-{v}" for v in FREE_VARIANTS]


def _check_run(said: str, trec: dict, traj: np.ndarray, ate: bool):
    """What ``run`` printed and wrote: the port engine's own kept count,
    the ATE on a log with truth, the trajectory of the kept scans."""
    assert f"kept {len(trec['kept_ids'])}/{N_SCANS} scans" in said
    assert traj.shape == (len(trec["kept_ids"]), 4) and len(traj) >= N_SCANS - 3
    np.testing.assert_allclose(traj[:, 1:], trec["poses"], atol=1e-6)   # six decimals
    if ate:
        assert "ATE RMSE:" in said and float(said.split("ATE RMSE:")[1].split()[0]) < 0.1


def _cli_case(form, profile, tmp_path):
    """``free-<seed>``: ``run`` on the room log simulated from that seed
    against the JAX engine free, at the bars of a whole run (closures and
    solves equal, kept within one scan, ATE within max(1.25 x JAX's, JAX's
    + 5 mm); the count of poses beyond 2e-3 m printed). ``lockstep``: the
    same configuration on ``room_log()``, the engine ``run`` makes carried
    into the JAX engine's state before each scan, at the per-step bars
    (pose 1e-5 m / 1e-5 rad, score, covariance, decisions, map cells), at
    most 3 tie flips."""
    tmp = str(tmp_path)
    if form != "lockstep":
        jrec, trec, said, traj = free_run(int(form.split("-")[1]), profile, tmp)
        _check_run(said, trec, traj, ate=True)
        L.assert_free(jrec, trec, f"cli {profile} {form}")
        return
    if profile == "default":
        cfg = J.SlamConfig(max_points=640)
    else:
        cfg = J.load_config(real_robot_yaml(os.path.join(tmp, "real_small.yaml")))
        assert cfg.use_odom_correct and cfg.match_map_window == 6.0
        assert T.SlamConfig(**dataclasses.asdict(cfg)) == T.load_config(
            os.path.join(tmp, "real_small.yaml"))
    log = room_log()
    je = J.SlamEngine(cfg, JLaser.from_array(log.laser.to_array()), world_size=14.0,
                      synchronous_backend=True, fused_backend=False)
    L.assert_lockstep(L.lockstep(je, L.scans(log.ranges, log.odom, log.times),
                                 name=f"cli {profile}"))


@pytest.mark.parametrize("form", FORMS)
def test_run_default_config_matches_jax_engine(tmp_path, form):
    """No ``--config``: ``SlamConfig()`` — the optimize matcher first, the
    coarse tier where it fails, no match-map window. ``run``'s engine
    (blocking, fused) against the JAX engine (blocking, unfused) on the
    room log; the forms as ``_cli_case`` says."""
    _cli_case(form, "default", tmp_path)


@pytest.mark.parametrize("form", FORMS)
def test_run_real_robot_profile_matches_jax_engine(tmp_path, form):
    """``configs/real_robot.yaml`` narrowed to the room (640 points, a 6 m
    match-map window): de-distortion on ingest, the move gate and the
    window-sized match maps; the forms as ``_cli_case`` says."""
    _cli_case(form, "real_robot", tmp_path)


def test_run_defaults_to_the_card(log_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", log_path, "--world-size", "14", "--max-points", "640"])


SMALL = ["--device", "cpu", "--world-size", "14", "--max-points", "640"]


@pytest.fixture(scope="module")
def npz_run(log_path, tmp_path_factory):
    """``run`` over the ``.npz`` log as it was before the options below
    were ported: the trajectory each option's run is held against."""
    out = str(tmp_path_factory.mktemp("plain") / "traj.txt")
    assert main(["run", log_path, *SMALL, "--out-trajectory", out]) == 0
    return np.loadtxt(out)


@pytest.mark.parametrize("argv", [
    ["run", "x.bag"], ["run", "x.rslg"], ["run", "LOG", "--async"],
    ["run", "LOG", "--out-map", "m"], ["run", "LOG", "--render", "r.png"],
    ["run", "LOG", "--checkpoint", "c.npz"], ["bench", "--device", "cpu"],
    ["simulate", "icra", "out.rslg"],
])
def test_unported_options_raise(log_path, npz_run, tmp_path, capsys, monkeypatch, argv):
    """The options that raised while their modules were not ported now run
    on the small log on the CPU: ``.bag`` and ``.rslg`` input (the same log
    written by ``write_bag`` / ``write_rslg``), ``--async``, ``--out-map``,
    ``--render`` (skipped without matplotlib) and ``--checkpoint``. Each
    keeps the plain run's kept stamps and its trajectory within the engine
    bar (2e-3 m / 2e-3 rad). ``bench --device cpu`` runs the headline at
    K = (1, 2), one rep, and prints one JSON line with the JAX bench's keys;
    without ``--device cpu`` it wants the card. ``simulate`` to ``.rslg``
    needs the scene maps and raises without them."""
    if argv[0] == "bench":
        from roborts_slam_tpu_torch.bench import headline

        monkeypatch.setattr(headline, "K_POINTS", (1, 2))
        monkeypatch.setattr(headline, "REPS", 1)
        assert main(argv) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        rec = json.loads(lines[0])
        assert {"metric", "value", "unit", "vs_baseline", "rep_times_s", "rep_spread",
                "match_us", "hbm_frac_of_peak", "achieved_gbps", "gops_per_s"} <= set(rec)
        assert rec["metric"] == "correlative_scan_match_throughput"
        assert rec["device"] == "cpu" and rec["k_points"] == [1, 2] and rec["value"] > 0
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv[:1])
        return
    if argv[0] == "simulate":
        if os.path.exists(tscenes.SCENES["icra"].map_yaml):
            pytest.skip("the reference's scene maps are present")
        out = str(tmp_path / argv[2])
        with pytest.raises(FileNotFoundError):
            main([*argv[:2], out])
        assert not os.path.exists(out)
        return
    if "--render" in argv:
        pytest.importorskip("matplotlib")
    log = ScanLog.load(log_path)
    if argv[1] == "x.bag":
        from roborts_slam_tpu_torch.io.rosbag import write_bag

        write_bag(str(tmp_path / "x.bag"), log)
    elif argv[1] == "x.rslg":
        from roborts_slam_tpu_torch.io.native_log import write_rslg

        write_rslg(log, str(tmp_path / "x.rslg"))
    argv = [log_path if a == "LOG" else str(tmp_path / a) if a in (
        "x.bag", "x.rslg", "m", "r.png", "c.npz") else a for a in argv]
    traj_path = str(tmp_path / "traj.txt")
    assert main([*argv, *SMALL, "--out-trajectory", traj_path]) == 0
    assert f"/{N_SCANS} scans" in capsys.readouterr().out
    traj = np.loadtxt(traj_path)
    assert traj.shape == npz_run.shape
    np.testing.assert_allclose(traj[:, 0], npz_run[:, 0], atol=1e-6)
    d = _traj_diff(traj, npz_run)
    assert d[:, 1:3].max() <= 2e-3 and d[:, 3].max() <= 2e-3, d.max(0)
    if "--out-map" in argv:
        with open(tmp_path / "m.pgm", "rb") as f:
            head = f.read(2)
        assert head == b"P5" and "resolution: 0.05" in (tmp_path / "m.yaml").read_text()
    if "--render" in argv:
        assert (tmp_path / "r.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    if "--checkpoint" in argv:
        from roborts_slam_tpu_torch.io.checkpoint import load_checkpoint

        back = load_checkpoint(str(tmp_path / "c.npz"), device="cpu")
        assert len(back.store) == len(traj)
        np.testing.assert_allclose(back.trajectory_array(), traj, atol=1e-6)


def test_simulate_needs_the_scene_maps(tmp_path):
    out = str(tmp_path / "icra.npz")
    if os.path.exists(tscenes.SCENES["icra"].map_yaml):
        pytest.skip("the reference's scene maps are present")
    with pytest.raises(FileNotFoundError):
        main(["simulate", "icra", out])
    assert not os.path.exists(out)
    with pytest.raises(SystemExit):
        main(["simulate", "nowhere", out])


def test_module_entry_point_prints_usage():
    out = subprocess.run([sys.executable, "-m", "roborts_slam_tpu_torch", "run", "-h"],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0
    for flag in ("--config", "--world-size", "--max-points", "--out-trajectory",
                 "--device", "--async", "--out-map", "--render", "--checkpoint"):
        assert flag in out.stdout


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_file_of_the_port_imports_jax():
    """Every source file of the port, and ``chip_smoke.py``, read as a
    compiler would: no import of ``jax``, ``jaxlib`` or the JAX package, at
    top level or inside a function (the fresh-interpreter check of
    tests/test_torch_engine.py sees only what importing the modules runs)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(REPO, "roborts_slam_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    wanted = {"__main__.py", "gauss_newton.py", "branch_and_bound.py", "dedistort.py",
              "scan_log.py", "pgm.py", "simulate.py", "scenes.py", "evaluation.py"}
    assert wanted <= {os.path.basename(f) for f in files}
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "roborts_slam_tpu"}
        assert not bad, (path, bad)
