"""Command-line interface: ``python -m roborts_slam_tpu_torch <cmd>``.

Subcommands:
  run       offline SLAM over a scan log (.npz)
  simulate  generate a scan log from a ground-truth map
  bench     not ported yet

``run`` works on the card unless ``--device cpu`` is given (the plain
PyTorch versions of the kernels then run on the CPU). Options of the JAX
package's CLI whose modules are not ported yet are accepted by the parser
and raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import sys


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})")


def _cmd_run(args) -> int:
    import numpy as np

    from .config import SlamConfig, load_config
    from .engine import SlamEngine
    from .io.scan_log import ScanLog

    if args.log.endswith(".bag"):
        _not_ported(".bag input (io/rosbag.py)", "io readers")
    if args.log.endswith(".rslg"):
        _not_ported(".rslg input (io/native_log.py)", "io readers")
    if args.async_backend:
        _not_ported("--async", "async back-end worker")
    if args.out_map:
        _not_ported("--out-map (utils/viz.py)", "tooling")
    if args.render:
        _not_ported("--render (utils/viz.py)", "tooling")
    if args.checkpoint:
        _not_ported("--checkpoint (io/checkpoint.py)", "io/checkpoint.py")

    log = ScanLog.load(args.log)
    cfg = load_config(args.config) if args.config else SlamConfig()
    if args.max_points is not None:
        cfg = cfg.replace(max_points=args.max_points)
    engine = SlamEngine(cfg, log.laser, world_size=args.world_size,
                        device=args.device)
    traj = engine.run_log(log, progress=True)
    print(f"kept {engine.diag.scans_processed}/{engine.diag.scans_in} scans, "
          f"{engine.diag.loop_closures} loop closures")
    if log.gt_poses is not None:
        from .utils.evaluation import ate_rmse, match_by_time

        est, gt = match_by_time(traj, log.gt_poses, log.times)
        print(f"ATE RMSE: {ate_rmse(est, gt):.3f} m")
    if args.out_trajectory:
        np.savetxt(args.out_trajectory, traj,
                   header="t x y theta", fmt="%.6f")
    return 0


def _cmd_simulate(args) -> int:
    from .io.scenes import SCENES, load_scene_map
    from .io.simulate import simulate_log

    if args.out.endswith(".rslg"):
        _not_ported(".rslg output (io/native_log.py)", "io readers")
    scene = SCENES[args.scene]
    log = simulate_log(load_scene_map(scene), scene.laser,
                       odom_error=scene.odom_error, seed=args.seed,
                       range_noise=args.range_noise)
    log.save(args.out)
    print(f"{len(log)} scans -> {args.out}")
    return 0


def _cmd_bench(args) -> int:
    _not_ported("bench", "tooling")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="roborts-slam-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="offline SLAM over a scan log")
    r.add_argument("log", help=".npz scan log")
    r.add_argument("--config", default=None, help="reference-format YAML")
    r.add_argument("--world-size", type=float, default=None)
    r.add_argument("--max-points", type=int, default=None,
                   help="padded beam count per scan (default: the config's)")
    r.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (required "
                        "unless 'cpu' is given)")
    r.add_argument("--async", dest="async_backend", action="store_true")
    r.add_argument("--scan-topic", default=None)
    r.add_argument("--odom-topic", default=None)
    r.add_argument("--out-trajectory", default=None)
    r.add_argument("--out-map", default=None)
    r.add_argument("--render", default=None)
    r.add_argument("--checkpoint", default=None)
    r.set_defaults(fn=_cmd_run)

    s = sub.add_parser("simulate", help="simulate a benchmark scene")
    s.add_argument("scene", choices=["icra", "rm", "willow"])
    s.add_argument("out", help="output .npz path")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--range-noise", type=float, default=0.005)
    s.set_defaults(fn=_cmd_simulate)

    b = sub.add_parser("bench", help="headline throughput benchmark")
    b.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
