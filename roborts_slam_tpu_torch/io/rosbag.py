"""Self-contained rosbag v2.0 reader → ScanLog converter.

Own copy of the JAX package's ``io/rosbag.py`` over the port's
``models/scan.py`` and ``io/scan_log.py``; a bag written by either package
reads in the other. The reference replays real-sensor data with ``rosbag
play`` + sim time (launch/roborts_slam_realworld_hokuyo_bag.launch,
scripts/real_world_slam.sh); the engine is ROS-free, so this module parses
the bag container format directly (no ROS dependencies): record framing,
connection records, chunked storage (none/bz2/lz4), and the fixed wire
layouts of ``sensor_msgs/LaserScan`` and ``nav_msgs/Odometry``. Scans are
paired with the nearest odometry sample by header time into a ScanLog.

Format reference: the rosbag 2.0 container spec (public). Only the subset
needed for LaserScan/Odometry replay is implemented.
"""

from __future__ import annotations

import bz2
import struct

import numpy as np

from ..models.scan import LaserModel
from .scan_log import ScanLog

OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _read_header(blob: bytes) -> dict:
    """Parse a record header: sequence of len-prefixed 'name=value' fields."""
    fields = {}
    off = 0
    while off < len(blob):
        (flen,) = struct.unpack_from("<I", blob, off)
        off += 4
        field = blob[off:off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1:]
    return fields


def _records(blob: bytes):
    """Yield (header_fields, data) records from a byte stream."""
    off = 0
    n = len(blob)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        hdr = _read_header(blob[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        data = blob[off:off + dlen]
        off += dlen
        yield hdr, data


def _ros_time(raw: bytes, off: int):
    secs, nsecs = struct.unpack_from("<II", raw, off)
    return secs + 1e-9 * nsecs, off + 8


def _ros_string(raw: bytes, off: int):
    (n,) = struct.unpack_from("<I", raw, off)
    off += 4
    return raw[off:off + n].decode(errors="replace"), off + n


def _parse_laserscan(raw: bytes):
    """sensor_msgs/LaserScan wire layout: Header (seq u32, stamp, frame_id),
    angle_min/max/increment, time_increment, scan_time, range_min/max f32,
    ranges f32[], intensities f32[]."""
    off = 4                                   # seq
    t, off = _ros_time(raw, off)
    _, off = _ros_string(raw, off)            # frame_id
    (angle_min, angle_max, angle_inc, time_inc, scan_time, range_min,
     range_max) = struct.unpack_from("<7f", raw, off)
    off += 28
    (n,) = struct.unpack_from("<I", raw, off)
    off += 4
    ranges = np.frombuffer(raw, "<f4", n, off).copy()
    return {
        "time": t, "angle_min": angle_min, "angle_max": angle_max,
        "angle_increment": angle_inc, "scan_time": scan_time,
        "range_min": range_min, "range_max": range_max, "ranges": ranges,
    }


def _parse_odometry(raw: bytes):
    """nav_msgs/Odometry: Header, child_frame_id, PoseWithCovariance
    (pose: point xyz f64, quat xyzw f64; cov f64[36]), Twist..."""
    off = 4
    t, off = _ros_time(raw, off)
    _, off = _ros_string(raw, off)            # frame_id
    _, off = _ros_string(raw, off)            # child_frame_id
    x, y, _z, qx, qy, qz, qw = struct.unpack_from("<7d", raw, off)
    yaw = np.arctan2(2.0 * (qw * qz + qx * qy),
                     1.0 - 2.0 * (qy * qy + qz * qz))
    return {"time": t, "pose": np.array([x, y, yaw])}


def read_bag_messages(path: str):
    """Yield (topic, msg_type, raw_bytes) for every message in the bag."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise IOError(f"not a rosbag v2.0 file: {path} ({magic[:20]!r})")
        blob = f.read()

    connections: dict[int, tuple[str, str]] = {}
    for hdr, data in _records(blob):
        op = hdr.get("op", b"\x00")[0]
        if op == OP_CONNECTION:
            conn = int.from_bytes(hdr["conn"], "little")
            topic = hdr["topic"].decode()
            sub = _read_header(data)
            mtype = sub.get("type", b"").decode()
            connections[conn] = (topic, mtype)
        elif op == OP_CHUNK:
            compression = hdr.get("compression", b"none").decode()
            if compression == "bz2":
                payload = bz2.decompress(data)
            elif compression == "lz4":
                from .lz4 import decompress_frame

                payload = decompress_frame(data)
            else:
                payload = data
            for chdr, cdata in _records(payload):
                cop = chdr.get("op", b"\x00")[0]
                if cop == OP_CONNECTION:
                    conn = int.from_bytes(chdr["conn"], "little")
                    topic = chdr["topic"].decode()
                    sub = _read_header(cdata)
                    connections[conn] = (topic, sub.get("type", b"").decode())
                elif cop == OP_MSG_DATA:
                    conn = int.from_bytes(chdr["conn"], "little")
                    topic, mtype = connections.get(conn, ("?", "?"))
                    yield topic, mtype, cdata
        elif op == OP_MSG_DATA:                # unchunked bags
            conn = int.from_bytes(hdr["conn"], "little")
            topic, mtype = connections.get(conn, ("?", "?"))
            yield topic, mtype, data


def _header_blob(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        f = k.encode() + b"=" + v
        out += struct.pack("<I", len(f)) + f
    return out


def _record(fields: dict, data: bytes) -> bytes:
    hdr = _header_blob(fields)
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(data)) + data)


def _time_bytes(t: float) -> bytes:
    secs = int(t)
    return struct.pack("<II", secs, int(round((t - secs) * 1e9)))


def _ser_laserscan(seq: int, t: float, frame: str, laser: LaserModel,
                   ranges: np.ndarray) -> bytes:
    inc = ((laser.angle_max - laser.angle_min) / (laser.num_beams - 1)
           if laser.num_beams > 1 else 0.0)
    f = frame.encode()
    n = len(ranges)
    return (struct.pack("<I", seq) + _time_bytes(t)
            + struct.pack("<I", len(f)) + f
            + struct.pack("<7f", laser.angle_min, laser.angle_max, inc,
                          (laser.scan_time / max(n, 1)), laser.scan_time,
                          laser.range_min, laser.range_max)
            + struct.pack("<I", n) + np.asarray(ranges, "<f4").tobytes()
            + struct.pack("<I", 0))                       # no intensities


def _ser_odometry(seq: int, t: float, frame: str, child: str,
                  pose: np.ndarray) -> bytes:
    f, c = frame.encode(), child.encode()
    qz, qw = np.sin(pose[2] / 2.0), np.cos(pose[2] / 2.0)
    cov = np.zeros(36, "<f8").tobytes()
    return (struct.pack("<I", seq) + _time_bytes(t)
            + struct.pack("<I", len(f)) + f
            + struct.pack("<I", len(c)) + c
            + struct.pack("<7d", pose[0], pose[1], 0.0, 0.0, 0.0, qz, qw)
            + cov
            + struct.pack("<6d", 0, 0, 0, 0, 0, 0) + cov)  # twist + cov


_SCAN_CONN_HDR = {
    "topic": None,                  # filled per call
    "type": b"sensor_msgs/LaserScan",
    # MD5 of the released message definition (fixed public constant)
    "md5sum": b"90c7ef2dc6895d81024acba2ac42f369",
    "message_definition": b"",
}
_ODOM_CONN_HDR = {
    "topic": None,
    "type": b"nav_msgs/Odometry",
    "md5sum": b"cd5e73d190d741a2f92e81eda573aca7",
    "message_definition": b"",
}


def write_bag(path: str, log: ScanLog, scan_topic: str = "/scan",
              odom_topic: str = "/odom", frame: str = "laser",
              compression: str = "bz2", chunk_msgs: int = 128) -> None:
    """Write a ScanLog as a rosbag v2.0 file — the same container subset
    the reader parses (record framing, connection records, chunked storage
    with none/bz2 compression, LaserScan + Odometry wire layouts), so the
    real-sensor replay path (launch/roborts_slam_realworld_hokuyo_bag.launch)
    can be exercised end-to-end without ROS: simulate → write_bag →
    bag_to_scan_log → engine."""
    if compression not in ("none", "bz2", "lz4"):
        raise ValueError(f"unsupported bag compression {compression!r}; "
                         "one of none/bz2/lz4")
    chunks: list[bytes] = []
    msgs: list[bytes] = []
    conn_scan = _record(dict(op=b"\x07", conn=(0).to_bytes(4, "little"),
                             topic=scan_topic.encode()),
                        _header_blob({**_SCAN_CONN_HDR,
                                      "topic": scan_topic.encode()}))
    conn_odom = _record(dict(op=b"\x07", conn=(1).to_bytes(4, "little"),
                             topic=odom_topic.encode()),
                        _header_blob({**_ODOM_CONN_HDR,
                                      "topic": odom_topic.encode()}))

    def flush():
        if not msgs:
            return
        payload = conn_scan + conn_odom + b"".join(msgs)
        comp = compression
        if comp == "bz2":
            data = bz2.compress(payload)
        elif comp == "lz4":
            from .lz4 import compress_frame

            data = compress_frame(payload)
        else:
            data = payload
        chunks.append(_record(
            dict(op=b"\x05", compression=comp.encode(),
                 size=struct.pack("<I", len(payload))), data))
        msgs.clear()

    for i in range(len(log)):
        t = float(log.times[i])
        msgs.append(_record(
            dict(op=b"\x02", conn=(1).to_bytes(4, "little"),
                 time=_time_bytes(t)),
            _ser_odometry(i, t, "odom", "base_link", log.odom[i])))
        msgs.append(_record(
            dict(op=b"\x02", conn=(0).to_bytes(4, "little"),
                 time=_time_bytes(t)),
            _ser_laserscan(i, t, frame, log.laser, log.ranges[i])))
        if len(msgs) >= 2 * chunk_msgs:
            flush()
    flush()

    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        # bag header record, padded to 4096 bytes with an 'x' field per the
        # container spec; index/chunk-info records are not needed by the
        # reader subset and are omitted
        hdr = dict(op=b"\x03", index_pos=(0).to_bytes(8, "little"),
                   conn_count=(2).to_bytes(4, "little"),
                   chunk_count=len(chunks).to_bytes(4, "little"))
        blob = _header_blob(hdr)
        pad = max(0, 4096 - len(blob) - 8)
        rec = (struct.pack("<I", len(blob)) + blob
               + struct.pack("<I", pad) + b" " * pad)
        f.write(rec)
        for ch in chunks:
            f.write(ch)


def bag_to_scan_log(path: str, scan_topic: str | None = None,
                    odom_topic: str | None = None,
                    range_threshold_scale: float = 0.95) -> ScanLog:
    """Convert a bag to a ScanLog: LaserScans + nearest-in-time odometry."""
    scans = []
    odoms = []
    for topic, mtype, raw in read_bag_messages(path):
        if mtype == "sensor_msgs/LaserScan" and (scan_topic is None
                                                 or topic == scan_topic):
            scans.append(_parse_laserscan(raw))
        elif mtype == "nav_msgs/Odometry" and (odom_topic is None
                                               or topic == odom_topic):
            odoms.append(_parse_odometry(raw))
    if not scans:
        raise ValueError(f"no LaserScan messages found in {path}")

    first = scans[0]
    beams = len(first["ranges"])
    laser = LaserModel(
        angle_min=float(first["angle_min"]),
        angle_max=float(first["angle_min"]
                        + first["angle_increment"] * (beams - 1)),
        range_min=float(first["range_min"]),
        range_max=float(first["range_max"]), num_beams=beams,
        range_threshold_scale=range_threshold_scale,
        scan_time=float(first["scan_time"]),   # enables sweep de-distortion
    )
    times = np.array([s["time"] for s in scans])

    def fixed_width(r):
        """Short scans (lidar dropouts) pad with an invalid range — never
        np.resize, which cycles real returns into phantom bearings."""
        if len(r) == beams:
            return r
        out = np.full(beams, laser.range_max + 1.0, r.dtype)
        out[: min(len(r), beams)] = r[:beams]
        return out

    ranges = np.stack([fixed_width(s["ranges"]) for s in scans]).astype(np.float32)

    if odoms:
        ot = np.array([o["time"] for o in odoms])
        op = np.stack([o["pose"] for o in odoms])
        # interpolate odometry at scan times (angle via unwrap)
        ox = np.interp(times, ot, op[:, 0])
        oy = np.interp(times, ot, op[:, 1])
        oth = np.interp(times, ot, np.unwrap(op[:, 2]))
        odom = np.stack([ox, oy, oth], -1)
    else:
        odom = np.zeros((len(scans), 3))
    return ScanLog(ranges=ranges, odom=odom, times=times, laser=laser)
