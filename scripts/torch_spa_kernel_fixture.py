#!/usr/bin/env python3
"""Write ``tests/data/spa_kernel_jax.npz``: the JAX package's
``solve_pose_graph`` of the padded loop graphs that the SPA kernel's tests
on the card hold the port's solve against (those tests import no JAX).

    JAX_PLATFORMS=cpu python3 scripts/torch_spa_kernel_fixture.py

For each ``(node bucket, edge bucket, seed)`` of
``tests/_torch_spa_graphs.FIXTURE_GRAPHS``: the graph's six arrays
(``loop_graph``) and JAX's poses, cost and LM iterations, under keys
``g<k>_<name>``. Run on the CPU (about a minute); rewrite only after a
deliberate change of the JAX package's solve or of the graphs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from roborts_slam_tpu.backend import spa as jspa
    from _torch_spa_graphs import FIELDS, FIXTURE, FIXTURE_GRAPHS, loop_graph

    out = {}
    for k, (bn, pe, seed) in enumerate(FIXTURE_GRAPHS):
        g = loop_graph(bn, pe, seed)
        poses, cost, iters = jspa.solve_pose_graph(
            jspa.PoseGraphData(**{f: jnp.asarray(g[f]) for f in FIELDS}))
        for f in FIELDS:
            out[f"g{k}_{f}"] = g[f]
        out[f"g{k}_jax_poses"] = np.asarray(poses, np.float32)
        out[f"g{k}_jax_cost"] = np.float32(cost)
        out[f"g{k}_jax_iters"] = np.int32(iters)
        print(f"{bn}x{pe} seed {seed}: cost {float(cost):.6g}, {int(iters)} LM iterations",
              flush=True)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
