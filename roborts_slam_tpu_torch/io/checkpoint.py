"""Engine checkpoint / resume.

Own copy of the JAX package's ``io/checkpoint.py`` for the port's engine,
with the same ``.npz`` key layout wherever both engines have the state, so
that a checkpoint written by the JAX package loads here and a run carries on
in the port. The reference keeps all state in RAM with no save/restore
(sensor_data_manager.h:576-579). A checkpoint holds the scan store, the pose
graph, the front-end maps and scalars, the engine's gating memory, its
odometry history and its diagnostics; maps are restored as they were (no
rebuild), so a resumed run continues as the run that was saved would have.

Departures from the JAX copy: no ``dev_time_origin`` is written (the port
keeps no device clock; the key is ignored on load); the engine's float64
host mirrors of the three map offsets are written too (``host_*_offset``;
the device holds them in float32, and a resumed run that recentered or grew
from the float32 values would place its maps a rounding step away from the
run that was saved); and the map→odom transform is recomputed on load from
the last stored pose and its odometry, so that ``pose_at`` serves the saved
run's transform at once. A checkpoint without the mirrors (the JAX
package's) restores them from the device offsets.

Format: a single ``.npz`` with the config as JSON inside it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..backend.pose_graph import GraphEdge
from ..config import SlamConfig
from ..models.scan import LaserModel


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(engine, path: str) -> None:
    """Serialize a SlamEngine (the asynchronous back end is flushed first)."""
    engine.finish()
    with engine._state_lock:
        st = engine.store
        n = len(st)
        state = engine.state
        edges = engine.backend.graph.edges
        hist = engine._odom_history
        diag = engine.diag
        data = dict(
            config_json=np.frombuffer(
                json.dumps(dataclasses.asdict(engine.config)).encode(), np.uint8),
            laser_params=engine.laser.to_array(),
            odom_history_t=np.array([h[0] for h in hist]),
            odom_history_p=(np.stack([h[1] for h in hist]) if hist
                            else np.zeros((0, 3))),
            world_size=np.float64(engine.world_size),
            # scan store
            store_points=(np.stack(st._points) if n
                          else np.zeros((0, st.max_points, 2), np.float32)),
            store_masks=(np.stack(st._masks) if n
                         else np.zeros((0, st.max_points), bool)),
            store_n_valid=np.asarray(st._n_valid, np.int64),
            store_poses=st.poses_array() if n else np.zeros((0, 3)),
            store_odoms=np.asarray(st.odoms) if n else np.zeros((0, 3)),
            store_times=np.asarray(st.times),
            store_running_ids=np.asarray(st.running_ids, np.int64),
            # pose graph
            graph_num_vertices=np.int64(engine.backend.graph.num_vertices),
            edge_st=np.array([[e.source, e.target] for e in edges],
                             np.int64).reshape(-1, 2),
            edge_rel=(np.stack([e.rel_pose for e in edges]) if edges
                      else np.zeros((0, 3))),
            edge_info=(np.stack([e.information for e in edges]) if edges
                       else np.zeros((0, 3, 3))),
            backend_counters=np.array([engine.backend.num_loop_closures,
                                       engine.backend.num_links], np.int64),
            # front-end state
            pub_hits=_host(state.pub.hits),
            pub_passes=_host(state.pub.passes),
            pub_offset=_host(state.pub.offset),
            coarse_probs=_host(state.coarse.probs),
            coarse_offset=_host(state.coarse.offset),
            fine_probs=_host(state.fine.probs),
            fine_offset=_host(state.fine.offset),
            state_pose=_host(state.pose),
            state_last_map_update_pose=_host(state.last_map_update_pose),
            state_map_penalize_times=_host(state.map_penalize_times),
            state_scan_index=_host(state.scan_index),
            host_pub_offset=engine._host_pub_off,
            host_coarse_offset=engine._host_coarse_off,
            host_fine_offset=engine._host_fine_off,
            # engine gating memory + outputs
            trajectory=(engine.trajectory_array() if engine.trajectory
                        else np.zeros((0, 4))),
            last_kept_odom=(engine._last_kept_odom
                            if engine._last_kept_odom is not None
                            else np.full(3, np.nan)),
            last_process_time=np.float64(
                engine._last_process_time
                if engine._last_process_time is not None else np.nan),
            diag=np.array([diag.scans_in, diag.scans_processed,
                           diag.scans_dropped_gate, diag.scans_dropped_move,
                           diag.loop_closures], np.int64),
        )
    np.savez_compressed(path, **data)


def load_checkpoint(path: str, synchronous_backend: bool = True, device=None):
    """Rebuild a SlamEngine from a checkpoint written by this package or by
    the JAX package; returns the engine, on ``device`` (None: the card)."""
    from ..engine import SlamEngine
    from ..frontend.processor import FrontendState
    from ..models.grid_map import CountMap, ProbMap

    with np.load(path) as f:
        z = {k: f[k] for k in f.files}
    cfg = SlamConfig(**json.loads(bytes(z["config_json"]).decode()))
    laser = LaserModel.from_array(z["laser_params"])
    engine = SlamEngine(cfg, laser, world_size=float(z["world_size"]),
                        synchronous_backend=synchronous_backend, device=device)
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
    with engine._state_lock:
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
        lpt = float(z["last_process_time"])
        engine._last_process_time = None if np.isnan(lpt) else lpt
        if len(st):
            engine._update_map_to_odom(np.asarray(st.poses[-1], np.float64),
                                       np.asarray(st.odoms[-1], np.float64))
    d = z["diag"]
    engine.diag.scans_in = int(d[0])
    engine.diag.scans_processed = int(d[1])
    engine.diag.scans_dropped_gate = int(d[2])
    engine.diag.scans_dropped_move = int(d[3])
    engine.diag.loop_closures = int(d[4])
    return engine
