#!/usr/bin/env python3
"""Write ``tests/data/gn_kernel_jax.npz``: the JAX package's
``optimize_scan_match`` on the scenes that the Gauss-Newton kernel's tests
on the card hold the port against (those tests import no JAX).

    JAX_PLATFORMS=cpu python3 scripts/torch_gn_kernel_fixture.py

For each scene of ``bench/gn_check.jax_cases`` (the front end's 512² map,
a 16-map chain batch of 256² maps, and the empty, off-map, flat and
clamped edge cases), under keys ``<name>_<field>``: the inputs (``probs``,
``points``, ``mask``, ``offset``, ``pose``, the five parameters as
``params``) and JAX's ``jax_pose``, ``jax_cost`` and ``jax_passes``, one
map at a time (a chain batch is JAX's ``vmap`` of the same function). The
passes are the calls of ``_cost_h_b`` that JAX's ``while_loop`` made,
counted by a host callback in a second run whose pose and cost must equal
the first's bit for bit. Run on the CPU (about a minute); rewrite only
after a deliberate change of the JAX package's optimizer or of the scenes.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "gn_kernel_jax.npz"
sys.path[:0] = [str(ROOT)]


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import roborts_slam_tpu.models.grid_map as jgm
    import roborts_slam_tpu.ops.gauss_newton as jgn
    from roborts_slam_tpu_torch.bench import gn_check

    def solve(spec, params, probs, offset, pts, msk, pose, counted: bool):
        calls = []
        cost_h_b = jgn._cost_h_b
        if counted:
            def tapped(*a):
                out = cost_h_b(*a)
                jax.debug.callback(lambda: calls.append(1))
                return out
            jgn._cost_h_b = tapped
        try:
            fn = jax.jit(lambda p, o, x, m, q: jgn.optimize_scan_match(spec, params, p, o, x, m, q))
            res = fn(jnp.asarray(probs), jnp.asarray(offset), jnp.asarray(pts),
                     jnp.asarray(msk), jnp.asarray(pose))
            out = np.asarray(res.pose, np.float32), np.float32(res.cost)
        finally:
            jgn._cost_h_b = cost_h_b
        return out, len(calls)

    out = {}
    for name, (side, probs, pts, msk, offset, world, params) in gn_check.jax_cases().items():
        tspec = gn_check.cell_specs()[side]
        spec = jgm.ProbMapSpec(**{f.name: getattr(tspec, f.name)
                                  for f in dataclasses.fields(tspec)})
        jparams = jgn.OptimizeParams(**dataclasses.asdict(params))
        maps = probs.numpy()[None] if probs.dim() == 2 else probs.numpy()
        poses, costs, passes = [], [], []
        for i in range(world.shape[0]):
            args = (maps[i], offset.numpy(), pts.numpy(), msk.numpy(), world[i].numpy())
            (pose, cost), _ = solve(spec, jparams, *args, counted=False)
            (pose2, cost2), n = solve(spec, jparams, *args, counted=True)
            assert np.array_equal(pose, pose2) and cost == cost2, (name, i)
            poses.append(pose)
            costs.append(cost)
            passes.append(n)
        out.update({f"{name}_probs": probs.numpy(), f"{name}_points": pts.numpy(),
                    f"{name}_mask": msk.numpy(), f"{name}_offset": offset.numpy(),
                    f"{name}_pose": world.numpy(),
                    f"{name}_params": np.array(dataclasses.astuple(params), np.float64),
                    f"{name}_jax_pose": np.stack(poses),
                    f"{name}_jax_cost": np.array(costs, np.float32),
                    f"{name}_jax_passes": np.array(passes, np.int32)})
        print(f"{name}: {len(poses)} maps, passes {passes}, costs {np.round(costs, 4).tolist()}",
              flush=True)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
