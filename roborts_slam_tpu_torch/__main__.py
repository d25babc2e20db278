"""Command-line interface: ``python -m roborts_slam_tpu_torch <cmd>``.

Subcommands:
  run       offline SLAM over a scan log (.npz, .rslg or .bag)
  simulate  generate a scan log (.npz or .rslg) from a ground-truth map
  bench     not ported yet

``run`` works on the card unless ``--device cpu`` is given (the plain
PyTorch versions of the kernels then run on the CPU). ``.rslg`` logs are
read through the native decode worker (``io/native_log.py``, built with
``g++`` at first use), ``.bag`` files through ``io/rosbag.py``. ``--async``
runs the back end on its worker thread. ``bench`` raises
``NotImplementedError`` naming where ROADMAP.md queues it.
"""

from __future__ import annotations

import argparse
import sys




def _cmd_run(args) -> int:
    import numpy as np

    from .config import SlamConfig, load_config
    from .engine import SlamEngine
    from .io.scan_log import ScanLog

    cfg = load_config(args.config) if args.config else SlamConfig()
    if args.max_points is not None:
        cfg = cfg.replace(max_points=args.max_points)
    sync = not args.async_backend
    if args.log.endswith(".rslg"):
        from .io.native_log import NativeScanStream

        log = None
        with NativeScanStream(args.log, max_points=cfg.max_points) as stream:
            engine = SlamEngine(cfg, stream.laser, world_size=args.world_size,
                                synchronous_backend=sync, device=args.device)
            traj = engine.run_stream(stream, progress=True)
    else:
        if args.log.endswith(".bag"):
            from .io.rosbag import bag_to_scan_log

            log = bag_to_scan_log(args.log, scan_topic=args.scan_topic,
                                  odom_topic=args.odom_topic)
        else:
            log = ScanLog.load(args.log)
        engine = SlamEngine(cfg, log.laser, world_size=args.world_size,
                            synchronous_backend=sync, device=args.device)
        traj = engine.run_log(log, progress=True)
    print(f"kept {engine.diag.scans_processed}/{engine.diag.scans_in} scans, "
          f"{engine.diag.loop_closures} loop closures")
    if log is not None and log.gt_poses is not None:
        from .utils.evaluation import ate_rmse, match_by_time

        est, gt = match_by_time(traj, log.gt_poses, log.times)
        print(f"ATE RMSE: {ate_rmse(est, gt):.3f} m")
    if args.out_trajectory:
        np.savetxt(args.out_trajectory, traj,
                   header="t x y theta", fmt="%.6f")
    if args.out_map:
        from .utils.viz import save_map

        save_map(engine, args.out_map)
    if args.render:
        from .utils.viz import render_run

        render_run(engine, args.render,
                   gt_poses=log.gt_poses if log is not None else None)
    if args.checkpoint:
        from .io.checkpoint import save_checkpoint

        save_checkpoint(engine, args.checkpoint)
    return 0


def _cmd_simulate(args) -> int:
    from .io.scenes import SCENES, load_scene_map
    from .io.simulate import simulate_log

    scene = SCENES[args.scene]
    log = simulate_log(load_scene_map(scene), scene.laser,
                       odom_error=scene.odom_error, seed=args.seed,
                       range_noise=args.range_noise)
    if args.out.endswith(".rslg"):
        from .io.native_log import write_rslg

        write_rslg(log, args.out)
    else:
        log.save(args.out)
    print(f"{len(log)} scans -> {args.out}")
    return 0


def _cmd_bench(args) -> int:
    raise NotImplementedError(
        "bench is not ported yet (ROADMAP.md: the benchmark comes with the PR "
        "that writes BENCHMARK.json)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="roborts-slam-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="offline SLAM over a scan log")
    r.add_argument("log", help=".npz or .rslg scan log, or .bag rosbag")
    r.add_argument("--config", default=None, help="reference-format YAML")
    r.add_argument("--world-size", type=float, default=None)
    r.add_argument("--max-points", type=int, default=None,
                   help="padded beam count per scan (default: the config's)")
    r.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (required "
                        "unless 'cpu' is given)")
    r.add_argument("--async", dest="async_backend", action="store_true",
                   help="run the back end on its worker thread")
    r.add_argument("--scan-topic", default=None)
    r.add_argument("--odom-topic", default=None)
    r.add_argument("--out-trajectory", default=None)
    r.add_argument("--out-map", default=None,
                   help="write the map as a PGM + YAML pair at this stem")
    r.add_argument("--render", default=None,
                   help="draw map, trajectory and graph to this PNG (matplotlib)")
    r.add_argument("--checkpoint", default=None,
                   help="save the engine's state to this .npz at the end")
    r.set_defaults(fn=_cmd_run)

    s = sub.add_parser("simulate", help="simulate a benchmark scene")
    s.add_argument("scene", choices=["icra", "rm", "willow"])
    s.add_argument("out", help="output .npz or .rslg path")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--range-noise", type=float, default=0.005)
    s.set_defaults(fn=_cmd_simulate)

    b = sub.add_parser("bench", help="headline throughput benchmark")
    b.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
