"""The staged input vector of a per-scan step: the port's counterpart of
the JAX package's jitted step takes the scan, ``n_valid``, odometry, the
fused chain ids and the store slot as traced inputs; the program's replayed
step takes them as ONE float32 vector on the device (``stage`` writes a
scan's inputs into a host vector, ``unstage`` is the step's first
operation), and so does the reference's eager step, so that both round the
same inputs alike.
"""

from __future__ import annotations

import torch

# the staged vector: [points (2P) | mask (P) | odom (3) | n_valid | time
# since the engine's first stamp | store slot or cursor | seed | ids (B·K)]
_HEAD = 4


def staged_size(P: int, ids_shape) -> int:
    """Length of the staged vector of a scan of ``P`` points with a chain
    id matrix of ``ids_shape`` (None: no chains)."""
    n_ids = 0 if ids_shape is None else ids_shape[0] * ids_shape[1]
    return 3 * P + 3 + _HEAD + n_ids


def stage(host, np_points, np_mask, n_valid: int, odom, time: float,
          slot: int = 0, seed: bool = False, ids=None):
    """Write one scan's inputs into the float32 NumPy view ``host`` of the
    staged vector. Every integer is below 2^24, so float32 holds it
    exactly; odometry and time are rounded to float32 here, as the step
    would round them."""
    P = np_points.shape[0]
    host[:2 * P] = np_points.reshape(-1)
    host[2 * P:3 * P] = np_mask
    host[3 * P:3 * P + 3] = odom
    host[3 * P + 3:3 * P + 3 + _HEAD] = (n_valid, time, slot, float(seed))
    if ids is not None:
        host[3 * P + 3 + _HEAD:] = ids.reshape(-1)


def unstage(staged, P: int, ids_shape) -> dict:
    """The scan's inputs as device tensors, views or conversions of the
    staged vector: ``points`` (P, 2) f32, ``mask`` (P,) bool, ``odom`` (3,)
    f32, ``n_valid`` () int32, ``time`` () f32, ``slot`` (1,) int64,
    ``seed`` () bool, ``ids`` (B, K) int64 or None."""
    o = 3 * P + 3
    return {
        "points": staged[:2 * P].view(P, 2), "mask": staged[2 * P:3 * P] > 0.5,
        "odom": staged[3 * P:o], "n_valid": staged[o].to(torch.int32),
        "time": staged[o + 1], "slot": staged[o + 2:o + 3].to(torch.int64),
        "seed": staged[o + 3] > 0.5,
        "ids": (None if ids_shape is None
                else staged[o + _HEAD:].view(*ids_shape).to(torch.int64))}

