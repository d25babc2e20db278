#!/usr/bin/env python3
"""The pose-graph solve on the card: the graph-replayed solve beside the
eager masked one and the dense one, on synthetic loop graphs.

    python3 scripts/torch_spa_on_device.py [--root DIR] [--nodes 512,1024] [--tag NAME]

Per graph (``parallel.multihost.make_synthetic_loop_graph``, seed 0: an
odometry ring with a quarter as many loop edges, its poses noisy) one JSON
line: the seconds of each solve (host clock to the end of a
``torch.cuda.synchronize``) and of the host's part alone (until the call
returns), LM iterations, CUDA graph captures and replays a solve, implicit
synchronisations inside ``lm_solve`` (``set_sync_debug_mode("error")``
raises on the first), the graph-replayed solve against the eager masked one
under deterministic sums (bit for bit expected) and in the default mode
(atomic sums), the solve run on a worker thread while this thread keeps
launching and reading (the engine's asynchronous back end), and the card's
name and power limit. ``--root``: the checkout whose
``roborts_slam_tpu_torch`` runs (default: this one); a tree whose
``lm_solve`` has no ``replay`` argument (the loop that reads on the host)
gets its solve and the dense one timed only, so that two trees are compared
in one call on one card, in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--nodes", default="512,1024")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from roborts_slam_tpu_torch.backend import spa
    from roborts_slam_tpu_torch.parallel.multihost import make_synthetic_loop_graph

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    masked = "replay" in inspect.signature(spa.lm_solve).parameters
    calls = {"capture_begin": 0, "replay": 0}

    def counting(name):
        orig = getattr(torch.cuda.CUDAGraph, name)

        def inner(self, *a, **kw):
            calls[name] += 1
            return orig(self, *a, **kw)
        return inner

    for name in calls:
        setattr(torch.cuda.CUDAGraph, name, counting(name))

    def timed(fn):
        torch.cuda.synchronize()
        before = dict(calls)
        t = time.perf_counter()
        out = fn()
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return out, {"seconds": time.perf_counter() - t, "host_seconds": host,
                     **{k: calls[k] - before[k] for k in calls}}

    @contextlib.contextmanager
    def deterministic():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*deterministic.*")
                yield
        finally:
            torch.use_deterministic_algorithms(False)

    def compared(a, b):
        (pa, ca, ia), (pb, cb, ib) = a, b
        return {"max_pose_diff": float((pa - pb).abs().max()),
                "cost_rel_diff": abs(float(ca) - float(cb)) / max(abs(float(cb)), 1e-30),
                "iters": [int(ia), int(ib)],
                "bit_equal": torch.equal(pa, pb) and torch.equal(ca, cb)}

    ok = True
    for n in (int(v) for v in args.nodes.split(",")):
        g = make_synthetic_loop_graph(n, device=dev)
        line = {"tag": args.tag, "device": card, "torch": torch.__version__,
                "cuda": torch.version.cuda, "nodes": n,
                "edges": int(g.edge_ij.shape[0]), "masked": masked}
        spa.solve_pose_graph(g)                      # first use of each op
        spa.solve_pose_graph_dense(g)
        (p, c, it), line["solve"] = timed(lambda: spa.solve_pose_graph(g))
        line["solve"]["iters"], line["solve"]["cost"] = int(it), float(c)
        syncs = spa.host_syncs
        _, line["dense"] = timed(lambda: spa.solve_pose_graph_dense(g))
        line["dense"]["host_syncs"] = spa.host_syncs - syncs
        if masked:
            eager, line["eager_masked"] = timed(lambda: spa.lm_solve(g, replay=False))
            line["default_mode_replayed_vs_eager"] = compared((p, c, it), eager)
            torch.cuda.set_sync_debug_mode("error")
            try:
                spa.lm_solve(g)
                torch.cuda.synchronize()
                line["implicit_syncs_in_lm_solve"] = 0
            except RuntimeError as err:
                line["implicit_syncs_in_lm_solve"] = f"raised: {err}"[:300]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            with deterministic():
                rep, line["deterministic_replayed"] = timed(lambda: spa.solve_pose_graph(g))
                eag = spa.lm_solve(g, replay=False)
                line["deterministic_replayed_vs_eager"] = compared(rep, eag)
                # the same solve on a worker thread while this thread launches,
                # allocates and reads on the card
                box, stop = {}, threading.Event()

                def worker():
                    try:
                        box["out"] = spa.solve_pose_graph(g)
                        torch.cuda.synchronize()
                    except Exception as err:  # noqa: BLE001 — reported below
                        box["error"] = repr(err)[:300]
                    finally:
                        stop.set()

                th = threading.Thread(target=worker)
                reads = 0
                th.start()
                while not stop.is_set():
                    # no random draw: PyTorch refuses one on the card from
                    # another thread while a graph is being captured
                    a = torch.full((256, 256), 1.0 + reads % 7, device=dev)
                    float((a @ a).sum())
                    reads += 1
                th.join(timeout=120)
                line["threaded"] = {"front_reads": reads, **(
                    {"error": box["error"]} if "error" in box
                    else compared(box["out"], rep))}
            good = (line["implicit_syncs_in_lm_solve"] == 0
                    and line["deterministic_replayed_vs_eager"]["bit_equal"]
                    and line["threaded"].get("bit_equal", False))
            line["ok"] = good
            ok = ok and good
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
