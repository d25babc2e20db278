#!/usr/bin/env python3
"""The correction rebuild on the card: eager at store buckets, this tree
against a parent's in turns, and the rebuild kernel (K7) alone.

    python3 scripts/torch_rebuild_kernel.py [--buckets 512,1024,2048]
                                            [--root PARENT] [--reps 10]

The store's rows of each bucket are made once here
(``bench/rebuild_check.corridor_rows``: corridor scans round the
benchmark's loop, 1152 point slots, the first 71 % valid as the laps cell's
1450 of 2048, padding rows holding other scans) and saved for every run.
A run is a process that imports one tree's package (``--worker``): an
engine of the real-robot profile (1024² pub, 256² coarse, 640² fine maps),
then per bucket the rebuild of its three maps (``engine._rebuild_all_maps``)
launched eagerly, as the engine's correction runs it: the first call (ms to
a synchronise: kernels built, the allocator's blocks made), then
``--reps`` calls each timed by CUDA events (device ms) and by the host
clock to a synchronise (host ms), medians and ranges, and a hash of the
four planes it wrote (pub hits and passes, coarse, fine). With ``--root``
the parent's tree runs too (parent, change, change, parent): the hashes
must agree. This tree's runs add K7 alone per bucket (``kernel``: device µs
a call, a CUDA graph of 10 calls; its bound, two 4 MB planes written and
the rows read once, over 3.35 TB/s) and, at the smallest bucket, the plain
loop on the card (``plain_ms``, one call). One JSON line a run and bucket,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
VALID_SHARE = 1450 / 2048


def card_said() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def save_rows(buckets, path: str, seed: int = 19):
    """The store's rows of every bucket, made with this tree's package."""
    import numpy as np

    from roborts_slam_tpu_torch.bench.rebuild_check import corridor_rows

    arrays = {}
    for b in buckets:
        pts, msk, poses, valid = corridor_rows(b, int(round(VALID_SHARE * b)), seed + b)
        arrays.update({f"pts_{b}": pts, f"msk_{b}": msk, f"poses_{b}": poses,
                       f"valid_{b}": valid})
    np.savez(path, **arrays)


def _engine(tree: str, dev):
    from roborts_slam_tpu_torch import SlamEngine, load_config
    from roborts_slam_tpu_torch.models.scan import LaserModel

    import numpy as np

    laser = LaserModel.from_array(np.load(Path(tree) / "tests" / "data" /
                                          "golden_willow.npz")["laser"])
    cfg = load_config(str(Path(tree) / "configs" / "real_robot.yaml"))
    return SlamEngine(cfg, laser, synchronous_backend=True, device=dev)


def _sync_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def _kernel_alone(fs, cfg, off, pts, msk, poses, valid, reps: int) -> dict:
    """K7 alone on the bucket's rows (pub offset ``off``): device µs a
    call, its bound."""
    import torch

    from roborts_slam_tpu_torch.ops import raster
    from roborts_slam_tpu_torch.ops.cuda import rebuild

    spec = fs.pub_spec
    start, end, beams = (t.contiguous() for t in raster._scan_cells(
        spec.inv_res, off, pts, msk, poses))
    first = tuple(t.contiguous() for t in raster._scan_cells(
        spec.inv_res, off, pts[0], msk[0], poses[0]))
    hits = torch.empty((spec.height, spec.width), device=pts.device)
    passes = torch.empty_like(hits)
    factors = (cfg.map_update_free_factor, cfg.map_update_occu_factor)
    extra = int(cfg.map_min_passthrough)
    bare = rebuild.prepared_rebuild_launch(start, end, beams, valid, hits, passes, *factors,
                                           extra, first)
    bare()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        for _ in range(10):
            bare()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(1e3 * ev[0].elapsed_time(ev[1]) / 10)
    geo = rebuild.geometry(*beams.shape, spec.height, spec.width, extra)
    B, P = beams.shape
    nbytes = 2 * 4 * spec.height * spec.width + B * (8 + 1) + B * P * (8 + 1) + P * 9 + 8
    times.sort()
    said = {"device_us": times[len(times) // 2], "device_us_range": [times[0], times[-1]],
            "bound_us": 1e6 * nbytes / 3.35e12, "bytes": nbytes,
            "chunks": geo.chunks, "words": geo.words,
            "scratch_mb": 4 * geo.scratch_words / 2 ** 20}
    said["roofline_pct"] = 100 * said["bound_us"] / said["device_us"]
    return said


def measure(tree: str, rows_path: str, buckets, reps: int, tag: str, plain: bool = True):
    """One run of ``tree``'s package (on ``sys.path``): a line per bucket."""
    import numpy as np
    import torch

    import roborts_slam_tpu_torch
    from roborts_slam_tpu_torch.engine import _rebuild_all_maps
    from roborts_slam_tpu_torch.ops.cuda import build

    build.build_all()
    dev = torch.device("cuda", 0)
    eng = _engine(tree, dev)
    fs, st, cfg = eng.fspec, eng.state, eng.config
    d = np.load(rows_path)
    has_k7 = (Path(roborts_slam_tpu_torch.__file__).parent / "ops" / "cuda" /
              "rebuild.py").exists()
    out = []
    for b in buckets:
        pts, msk, poses, valid = (torch.as_tensor(d[f"{k}_{b}"], device=dev)
                                  for k in ("pts", "msk", "poses", "valid"))
        n = int(valid.sum())

        def rebuild():
            _rebuild_all_maps(fs.pub_spec, fs.coarse_spec, fs.fine_spec, st.pub, st.coarse,
                              st.fine, pts, msk, poses, valid, cfg.map_update_free_factor,
                              cfg.map_update_occu_factor, int(cfg.map_min_passthrough),
                              bool(cfg.coarse_map_use_blur), bool(cfg.fine_map_use_blur))

        first_ms = _sync_ms(rebuild)
        device_ms, host_ms = [], []
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev[0].record()
            rebuild()
            ev[1].record()
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t))
            device_ms.append(ev[0].elapsed_time(ev[1]))
        device_ms.sort()
        host_ms.sort()
        digest = hashlib.sha256()
        for t in (st.pub.hits, st.pub.passes, st.coarse.probs, st.fine.probs):
            digest.update(t.cpu().numpy().tobytes())
        line = {"tree": tag, "bucket": b, "valid": n, "pub": list(st.pub.hits.shape),
                "first_call_ms": first_ms, "device_ms": device_ms[len(device_ms) // 2],
                "device_ms_range": [device_ms[0], device_ms[-1]],
                "host_ms": host_ms[len(host_ms) // 2],
                "host_ms_range": [host_ms[0], host_ms[-1]],
                "planes_sha256": digest.hexdigest()[:16],
                "pub_hits_sum": float(st.pub.hits.sum())}
        if has_k7:
            line["kernel"] = _kernel_alone(fs, cfg, st.pub.offset, pts, msk, poses, valid,
                                           reps)
            if plain and b == min(buckets):
                from roborts_slam_tpu_torch.ops import raster

                pub = fs.pub_spec
                off = st.pub.offset
                start, end, beams = raster._scan_cells(pub.inv_res, off, pts, msk, poses)
                first = raster._scan_cells(pub.inv_res, off, pts[0], msk[0], poses[0])
                planes = (torch.empty_like(st.pub.hits), torch.empty_like(st.pub.hits))
                line["plain_ms"] = _sync_ms(lambda: raster.rebuild_counts_plain(
                    start, end, beams, valid, *planes, cfg.map_update_free_factor,
                    cfg.map_update_occu_factor, int(cfg.map_min_passthrough), first))
                line["plain_bit_equal"] = bool(torch.equal(planes[0], st.pub.hits)
                                               and torch.equal(planes[1], st.pub.passes))
        out.append(line)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--buckets", default="512,1024,2048")
    ap.add_argument("--root", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rows", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="change", help=argparse.SUPPRESS)
    args = ap.parse_args()
    buckets = [int(x) for x in args.buckets.split(",") if x]
    if args.worker is not None:
        sys.path.insert(0, str(Path(args.worker).resolve()))
        for line in measure(args.worker, args.rows, buckets, args.reps, args.tag):
            print(json.dumps(line), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_rebuild_kernel: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    card = card_said()
    trees = [("change", str(HERE))]
    if args.root is not None:
        parent = str(Path(args.root).resolve())
        trees = [("parent", parent), ("change", str(HERE)), ("change", str(HERE)),
                 ("parent", parent)]
    ok, hashes = True, {}
    with tempfile.TemporaryDirectory() as tmp:
        rows = str(Path(tmp) / "rows.npz")
        save_rows(buckets, rows)
        for tag, tree in trees:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                   "--worker", tree, "--rows", rows, "--buckets", args.buckets,
                                   "--reps", str(args.reps), "--tag", tag],
                                  capture_output=True, text=True, timeout=900)
            for ln in proc.stdout.strip().splitlines():
                rec = json.loads(ln)
                rec["device"] = card
                hashes.setdefault(rec["bucket"], set()).add(rec["planes_sha256"])
                print(json.dumps(rec), flush=True)
            if proc.returncode != 0:
                ok = False
                print(json.dumps({"tree": tag, "device": card, "error": proc.stderr[-3000:]}),
                      flush=True)
    same = {b: len(h) == 1 for b, h in hashes.items()}
    print(json.dumps({"planes_equal_across_runs": same, "device": card}), flush=True)
    return 0 if ok and all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
