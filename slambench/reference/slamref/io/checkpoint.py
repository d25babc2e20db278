"""An engine restored from a program's state, in the key layout of the
program's checkpoint (``.npz``), the state the check copies from the program
(``lib/check.program_state``): the scan store, the pose graph, the front-end
maps and scalars, the gating memory and the odometry history; maps are
restored as they were (no rebuild). The float64 host mirrors of the three
map offsets are restored where given, else from the device offsets.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..backend.pose_graph import GraphEdge
from ..config import SlamConfig
from ..models.scan import LaserModel


def restore_checkpoint(z: dict, device=None):
    """A ``SlamEngine`` on ``device`` in the state of the arrays ``z``."""
    from ..engine import SlamEngine
    from ..frontend.processor import FrontendState
    from ..models.grid_map import CountMap, ProbMap

    cfg = SlamConfig(**json.loads(bytes(z["config_json"]).decode()))
    laser = LaserModel.from_array(z["laser_params"])
    engine = SlamEngine(cfg, laser, world_size=float(z["world_size"]), device=device)
    dev = engine.device

    # scan store
    st = engine.store
    for i in range(z["store_n_valid"].shape[0]):
        st.add(z["store_points"][i], z["store_masks"][i],
               int(z["store_n_valid"][i]), z["store_poses"][i],
               z["store_odoms"][i], float(z["store_times"][i]))
    st.running_ids = [int(i) for i in z["store_running_ids"]]

    # pose graph (vertices + edges verbatim; no re-matching)
    g = engine.backend.graph
    for _ in range(int(z["graph_num_vertices"])):
        g.add_vertex()
    for k in range(z["edge_st"].shape[0]):
        s, t = int(z["edge_st"][k, 0]), int(z["edge_st"][k, 1])
        g.edges.append(GraphEdge(s, t, z["edge_rel"][k].astype(np.float64),
                                 z["edge_info"][k].astype(np.float64)))
        g._edge_set.add((min(s, t), max(s, t)))
        g.adjacency[s].add(t)
        g.adjacency[t].add(s)
    engine.backend.num_loop_closures = int(z["backend_counters"][0])
    engine.backend.num_links = int(z["backend_counters"][1])

    # front-end state; the pub map may have grown past the world_size
    # allocation: re-shape the spec to the saved arrays first
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    lko = z["last_kept_odom"]
    lpt = float(z["last_process_time"])
    origin = float(z.get("dev_time_origin", np.nan))
    if not np.isfinite(origin):
        origin = lpt if np.isfinite(lpt) else None
    ph, pw = z["pub_hits"].shape
    ps = engine.fspec.pub_spec
    if (ph, pw) != (ps.height, ps.width):
        engine._grow_pub_to(pw, ph, 0, 0)
    engine.state = FrontendState(
        pub=CountMap(torch.as_tensor(z["pub_hits"], **f32),
                     torch.as_tensor(z["pub_passes"], **f32),
                     torch.as_tensor(z["pub_offset"], **f32)),
        coarse=ProbMap(torch.as_tensor(z["coarse_probs"], **f32),
                       torch.as_tensor(z["coarse_offset"], **f32)),
        fine=ProbMap(torch.as_tensor(z["fine_probs"], **f32),
                     torch.as_tensor(z["fine_offset"], **f32)),
        pose=torch.as_tensor(z["state_pose"], **f32),
        last_map_update_pose=torch.as_tensor(
            z["state_last_map_update_pose"], **f32),
        map_penalize_times=torch.as_tensor(z["state_map_penalize_times"], **i32),
        scan_index=torch.as_tensor(z["state_scan_index"], **i32),
        # nan = no kept scan yet (the step's first-scan branch ignores it)
        last_kept_odom=torch.as_tensor(np.where(np.isnan(lko), 0.0, lko), **f32),
        # the device move gate's clock, so that a resume goes on pipelined
        last_step_time=torch.full(
            (), lpt - origin if np.isfinite(lpt) else -3.4e38, **f32),
    )
    engine._publish_pub_arrays()
    # the host mirrors the per-scan geometry checks read
    engine._host_pose = np.asarray(z["state_pose"], np.float64)
    for name in ("pub", "coarse", "fine"):
        off = z.get(f"host_{name}_offset", z[f"{name}_offset"])
        setattr(engine, f"_host_{name}_off", np.asarray(off, np.float64))

    # engine memory
    for row in z["trajectory"]:
        engine.trajectory.append((float(row[0]), row[1:4].astype(np.float64)))
    engine._last_kept_odom = (None if np.isnan(lko).any()
                              else lko.astype(np.float64))
    engine._odom_history = [
        (float(z["odom_history_t"][i]), z["odom_history_p"][i].astype(np.float64))
        for i in range(z["odom_history_t"].shape[0])]
    engine._last_process_time = None if np.isnan(lpt) else lpt
    engine._prev_process_time = engine._last_process_time
    engine._dev_time_origin = origin
    d = z["diag"]
    engine.diag.scans_in = int(d[0])
    engine.diag.scans_processed = int(d[1])
    engine.diag.scans_dropped_gate = int(d[2])
    engine.diag.scans_dropped_move = int(d[3])
    engine.diag.loop_closures = int(d[4])
    return engine
