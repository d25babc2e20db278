"""What the two correlation kernels' design rests on, checked on the CPU.

The CUDA kernels run only on the card; their launch geometry, the second
kernel's box indexing and the order of their sums are stated in Python
(``launch_geometry``, ``box_layout``, ``correlation_scores_sliced``) and held
here against the plain version's index arithmetic and sums. Inputs come from
a numpy seed."""

import numpy as np
import pytest
import torch

import roborts_slam_tpu_torch.ops.correlative as tcr
import roborts_slam_tpu_torch.ops.cuda.correlation as tcuda

torch.set_num_threads(1)

TIERS = [(101, 200, 9), (21, 200, 11), (21, 400, 3)]          # (A, S, N)
# the 21 shapes the smoke run on the card compares, as (B, A, S, N, H, W):
# five maps x three tiers at B=1, the two chain maps x three tiers at B=4
CARD_SHAPES = [(1, *t, side, side) for side in (3072, 2432, 640, 1024, 4096)
               for t in TIERS] + [(4, *t, side, side) for side in (2432, 1024)
                                  for t in TIERS]
EXTRA_SHAPES = [(1, 5, 40, 1, 64, 64),        # N = 1
                (1, 5, 1, 3, 64, 64),         # S = 1
                (1, 5, 397, 11, 64, 64),      # S prime
                (1, 5, 37, 33, 64, 64),       # N*N above one block's threads
                (2, 7, 5000, 40, 64, 64),     # slices longer than the minimum
                (1, 1, 8, 2, 1, 1)]           # a map of one cell


@pytest.mark.parametrize("shape", CARD_SHAPES + EXTRA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_launch_geometry(shape):
    B, A, S, N, H, W = shape
    g = tcuda.launch_geometry(A, S, N, H, W)
    # both kernels: a block the card can hold
    assert 1 <= g.threads <= tcuda.BLOCK_THREADS <= 1024
    assert g.threads == g.group_size * g.slices
    assert 1 <= g.v2_threads <= tcuda.V2_BLOCK_THREADS <= 1024
    assert g.v2_threads == g.v2_team * g.v2_teams
    assert g.shared_bytes <= tcuda.MAX_SHARED_BYTES
    assert g.v2_shared_bytes <= tcuda.MAX_SHARED_BYTES
    # the slices cover range(S) exactly once and in order
    bounds = g.slice_bounds(S)
    assert len(bounds) == g.slices <= tcuda.MAX_SLICES
    covered = [s for s0, s1 in bounds for s in range(s0, s1)]
    assert covered == list(range(S))
    assert all(0 < s1 - s0 <= g.slice_len for s0, s1 in bounds)
    # the candidate groups cover range(N*N) exactly once, none empty
    C = N * N
    assert (g.groups - 1) * g.group_size < C <= g.groups * g.group_size
    # shared memory as the kernels lay it out
    assert g.shared_bytes == 4 * (2 * S + g.slices * g.group_size) + S
    # second kernel: the row groups cover the window's rows exactly once,
    # a team is a power of two of lanes inside one warp, and holds the
    # group's candidates in its slots (or walks them in chunks)
    assert (g.v2_groups - 1) * g.v2_rows < N <= g.v2_groups * g.v2_rows
    assert g.v2_team in (1, 2, 4, 8, 16, 32)
    assert g.v2_slots in tcuda.V2_SLOTS
    chunk = g.v2_slots * g.v2_team
    # whole warps, and no more of them than the slices need
    assert g.v2_threads % 32 == 0
    assert g.v2_teams - 32 // g.v2_team < g.slices
    assert g.v2_shared_bytes == (4 * (2 * S + g.slices * chunk) + S
                                 + 4 * tcuda.V2_SUB * g.v2_teams * chunk)
    # the shipped tiers get a team per slice, a group's candidates fit one
    # pass and at most 45 % of the lanes' slots stay without a candidate
    if shape in CARD_SHAPES:
        assert g.v2_teams >= g.slices
        assert 0.55 * chunk <= g.v2_rows * N <= chunk
        assert 42 <= A * g.groups and 42 <= A * g.v2_groups


def test_launch_geometry_is_shared_by_both_kernels():
    """One slice length for both kernels at a shape: their sums agree bit for
    bit only because they are taken in one order."""
    for _, A, S, N, H, W in CARD_SHAPES:
        g = tcuda.launch_geometry(A, S, N, H, W)
        assert (g.slice_len, g.slices) == (8, -(-S // 8))


@pytest.mark.parametrize("bad", [(0, 10, 3, 8, 8), (5, 0, 3, 8, 8), (5, 10, 0, 8, 8),
                                 (5, 10, 3, 0, 8), (5, 60000, 3, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_launch_geometry_refuses(bad):
    with pytest.raises(ValueError):
        tcuda.launch_geometry(*bad)


def _window(seed, step, center, B=2, A=3, S=24, N=11, H=96, W=80):
    """rx/ry (B,A,S) within 12 cells of the sensor, xs/ys (B,N) ascending
    with ``step`` cells between candidates round ``center`` (+ a seeded
    fraction of a cell), as ``candidate_grid`` forms them."""
    rng = np.random.default_rng(seed)
    rx = torch.as_tensor(rng.uniform(-12, 12, (B, A, S)).astype(np.float32))
    ry = torch.as_tensor(rng.uniform(-12, 12, (B, A, S)).astype(np.float32))
    c = torch.as_tensor(np.asarray(center, np.float32)
                        + rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32))
    steps = torch.arange(N, dtype=torch.float32) * np.float32(step)
    half = np.float32(step * (N - 1) * 0.5)
    return rx, ry, c[:, 0:1] - half + steps, c[:, 1:2] - half + steps, H, W


PLACES = {"inside": (40.0, 48.0), "low_edges": (3.0, 2.0), "high_edges": (78.0, 93.0),
          "low_x_high_y": (1.0, 95.0), "outside": (400.0, -300.0)}


def _plain_cells(rx, ry, xs, ys, H, W):
    """The plain version's index arithmetic (ops/correlative.py): gx, gy,
    which candidates are in the map, and their flat cells."""
    gx = torch.floor(rx[:, :, :, None] + xs[:, None, None, :] + 0.5).to(torch.int64)
    gy = torch.floor(ry[:, :, :, None] + ys[:, None, None, :] + 0.5).to(torch.int64)
    ok = (((gx >= 0) & (gx < W))[..., :, None] & ((gy >= 0) & (gy < H))[..., None, :])
    return gx, gy, ok, torch.where(ok, gy[..., None, :] * W + gx[..., :, None], 0)


def _cells_via_box(box, W):
    w = box["width"][..., None, None]
    return ((box["y_lo"][..., None, None] + box["pos"] // w) * W
            + box["x_lo"][..., None, None] + box["pos"] % w)


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("step", [10.0, 4.0, 2.0, 1.0, 0.8, 0.4])
def test_box_indexing_gives_the_plain_cells(step, place):
    """The cell a candidate takes from the box is the cell the plain version
    reads, and it lies outside the map exactly where the plain version says
    so — whether the box is copied or, being too large, is not."""
    rx, ry, xs, ys, H, W = _window(int(step * 10) + len(place), step, PLACES[place])
    N = xs.shape[1]
    g = tcuda.launch_geometry(21, 200, N, H, W)
    assert (g.v2_groups, g.v2_rows, g.v2_slots) == (N, 1, 1) and g.v2_team >= N
    for rows in (1, 4, N):                 # the fine tier's groups, and larger ones
        for ky0 in range(0, N, rows):
            _check_box(rx, ry, xs, ys, H, W, step, place, ky0, min(rows, N - ky0))


def _check_box(rx, ry, xs, ys_all, H, W, step, place, ky0, rows):
    N = xs.shape[1]
    ys = ys_all[:, ky0:ky0 + rows]
    box = tcuda.box_layout(rx, ry, xs, ys, H, W, rows * N)
    gx, gy, ok, flat = _plain_cells(rx, ry, xs, ys, H, W)

    assert torch.equal(box["inside"], ok)
    # xs, ys ascend: every candidate in the map is in the box
    assert torch.equal(box["in_box"], ok)
    assert torch.equal(torch.where(ok, _cells_via_box(box, W), 0), flat)
    # every entry lies in the box, and the box in the map
    cells = box["width"] * box["height"]
    assert bool((box["pos"] >= 0).all())
    assert bool((box["pos"] < cells[..., None, None].clamp(min=1)).all())
    assert bool((box["x_lo"] >= 0).all()) and bool((box["x_lo"] + box["width"] <= W).all())
    assert bool((box["y_lo"] >= 0).all()) and bool((box["y_lo"] + box["height"] <= H).all())
    # the box is gx(0)..gx(N-1) by gy(0)..gy(R-1), clipped to the map, and
    # empty exactly where no candidate is in the map
    some = cells > 0
    assert torch.equal(some, ok.any(-1).any(-1))
    assert torch.equal(box["x_lo"][some], gx[..., 0].clamp(min=0)[some])
    assert torch.equal((box["x_lo"] + box["width"] - 1)[some],
                       gx[..., -1].clamp(max=W - 1)[some])
    assert torch.equal(box["y_lo"][some], gy[..., 0].clamp(min=0)[some])
    assert torch.equal((box["y_lo"] + box["height"] - 1)[some],
                       gy[..., -1].clamp(max=H - 1)[some])
    # what the case is for
    if place == "outside":
        assert not bool(ok.any()) and not bool(some.any()) and bool(box["boxed"].all())
    elif place == "inside":
        assert bool(ok.all()) == (step <= 4.0)      # the 10-cell window leaves the map
        # copied whole where it has no more cells than the group has
        # candidates: always at steps up to one cell, never at two or more
        # (a single row of the window at two cells: 21 cells for 11 reads)
        assert bool(box["boxed"].all()) == (step <= 1.0)
        if step <= 4.0:                            # else the map's edge clips some boxes small
            assert bool(box["boxed"].any()) == (step <= 1.0)
    else:
        # the window straddles the map's edge (a single row of it may lie
        # wholly outside)
        assert not bool(ok.all()) and (bool(ok.any()) or rows < N)
    if step < 1.0 and place == "inside":
        # several candidates on one cell: fewer distinct cells than candidates
        assert int(cells.max()) < rows * N


def test_box_indexing_with_unordered_offsets():
    """xs, ys in any order: a candidate whose cell the box does not hold is
    marked so (the kernel reads it where it lies); one that the box holds
    still finds its own cell there."""
    rx, ry, xs, ys, H, W = _window(77, 0.8, (40.0, 48.0))
    perm = torch.as_tensor(np.random.default_rng(3).permutation(xs.shape[1]))
    xs, ys = xs[:, perm].contiguous(), ys[:, perm].contiguous()
    box = tcuda.box_layout(rx, ry, xs, ys, H, W, xs.shape[1] ** 2)
    _, _, ok, flat = _plain_cells(rx, ry, xs, ys, H, W)
    assert torch.equal(box["inside"], ok) and bool(ok.all())
    assert bool((box["in_box"] & ~ok).sum() == 0)
    assert 0 < int(box["in_box"].sum()) < int(ok.sum())
    held = box["in_box"]
    assert torch.equal(_cells_via_box(box, W)[held], flat[held])


@pytest.mark.parametrize("step,S", [(10.0, 200), (2.0, 200), (1.0, 400), (0.8, 37),
                                    (0.4, 1), (4.0, 397)])
def test_sliced_sums_stay_near_the_plain_sums(step, S):
    """P partial sums added in slice order against one ``torch.sum``: within
    2e-6 on scores in [0, 1]."""
    rng = np.random.default_rng(int(step * 10) + S)
    rx, ry, xs, ys, H, W = _window(S, step, (40.0, 48.0), S=S, N=5)
    probs = torch.as_tensor(rng.random((2, H, W), dtype=np.float32))
    n_valid = max(1, (S * 3) // 5)
    svalid = (torch.arange(S) < n_valid)[None].expand(2, S).contiguous()
    divisor = torch.full((2,), float(n_valid))
    args = (probs, rx, ry, svalid, xs, ys, 0.37, divisor)
    want = tcr.correlation_scores_plain(*args)
    g = tcuda.launch_geometry(3, S, 5, H, W)
    got = tcr.correlation_scores_sliced(*args, g.slice_len)
    assert float(want.max()) <= 1.0 and float(want.min()) >= 0.0
    assert float((got - want).abs().max()) <= 2e-6
    # the CPU wrappers take the plain version, whichever kernel is named
    assert torch.equal(tcuda.correlation_scores(*args), want)
    assert torch.equal(tcuda.correlation_scores_v2(*args), want)


def test_divisor_tensor_is_kept_per_batch_value_and_device():
    a = tcr._divisor_tensor(3, 200.0, torch.device("cpu"))
    assert a is tcr._divisor_tensor(3, 200.0, torch.device("cpu"))
    assert a.tolist() == [200.0] * 3 and a.dtype == torch.float32
    assert tcr._divisor_tensor(1, 200.0, torch.device("cpu")).shape == (1,)
    assert tcr._divisor_tensor(3, 57.0, torch.device("cpu")).tolist() == [57.0] * 3
