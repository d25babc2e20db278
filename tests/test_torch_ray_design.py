"""What the carve and ray-check kernels' designs rest on, checked on the CPU.

The CUDA kernels run only on the card; their index arithmetic is stated in
plain PyTorch beside the wrappers (``dda_stepped``, ``needs_wide``,
``mark_image_beams``, ``tile_plan``, ``tile_steps``, ``mark_image_tiled``,
``check_geometry``, ``bad_rays_stepped``) and held here, exactly, against the plain versions'
64-bit floor division (``_ray_cells_hw``, ``mark_image_plain``,
``bad_rays_plain``). Inputs come from a numpy seed."""

import numpy as np
import pytest
import torch

import roborts_slam_tpu_torch.ops.cuda.raycarve as rc
from roborts_slam_tpu_torch.ops.raster import _ray_cells_hw, mark_image_plain
from roborts_slam_tpu_torch.ops.raycast import bad_rays_plain

torch.set_num_threads(1)

i64 = lambda v: torch.as_tensor(v, dtype=torch.int64)
i32 = lambda v: torch.as_tensor(v, dtype=torch.int32)


def floor_cells(d, n, t):
    """floor((2·d·t + n) / 2n) by 64-bit floor division."""
    return torch.div(2 * d * t + n, 2 * n, rounding_mode="floor")


# (d, n) of one axis; n = max(|dx|, |dy|, 1) >= |d|
AXES = {
    "zero_length": (0, 1), "length_1_up": (1, 1), "length_1_down": (-1, 1),
    "d_0_long": (0, 205), "d_eq_n": (205, 205), "d_eq_minus_n": (-205, 205),
    "shallow_down": (-3, 205), "steep_down": (-204, 205), "odd": (77, 131),
    "largest_of_4096_map": (4095, 4095), "largest_of_4096_map_down": (-4094, 4095),
    "narrow_limit": (32766, 32767), "narrow_limit_down": (-32767, 32767),
}


@pytest.mark.parametrize("stride", [1, 16, 32])
@pytest.mark.parametrize("name", list(AXES))
def test_dda_stepped_equals_floor_division(name, stride):
    d, n = AXES[name]
    lanes = torch.arange(stride, dtype=torch.int64)          # every lane's first step
    count = -(-(n + 1) // stride)
    got = rc.dda_stepped(i64(d).expand(stride), i64(n).expand(stride), lanes,
                         stride, count, bits=32)
    t = lanes[:, None] + stride * torch.arange(count)[None, :]
    assert torch.equal(got, floor_cells(d, n, t))
    # a walk that starts inside the ray, as a tile's clipped range does
    t0 = i64([n // 3, n // 2, n])
    got = rc.dda_stepped(i64(d).expand(3), i64(n).expand(3), t0, 1, 4, bits=32)
    assert torch.equal(got, floor_cells(d, n, t0[:, None] + torch.arange(4)[None, :]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dda_stepped_random_rays(seed):
    rng = np.random.default_rng(seed)
    n = i64(rng.integers(1, 5000, 300))
    d = i64(rng.integers(-1, 2, 300)) * i64(rng.integers(0, 5001, 300)) % (n + 1)
    d = torch.where(i64(rng.integers(0, 2, 300)) == 1, d, -d)
    got = rc.dda_stepped(d, n, torch.zeros_like(n), 32, 160, bits=32)
    t = 32 * torch.arange(160)[None, :]
    assert torch.equal(got, floor_cells(d[:, None], n[:, None], t))


def test_range_test_sends_long_rays_to_64_bits():
    start = i32([5, 7])
    end = i32([[5 + 32767, 7], [5, 7 - 32767], [5 + 32768, 7], [5 - 40000, 30],
               [2 ** 30, 7], [6, 8]])
    assert rc.needs_wide(start, end).tolist() == [False, False, True, True, True, False]
    assert rc.needs_wide(i32([-2 ** 30, 0]), i32([[0, 0]])).tolist() == [True]
    # one step past the limit the 32-bit arithmetic would wrap; 64 bits hold it
    n = rc.NARROW_MAX_N + 1
    with pytest.raises(OverflowError):
        rc.dda_stepped(i64([n]), i64([n]), i64([n]), 1, 1, bits=32)
    assert rc.dda_stepped(i64([n]), i64([n]), i64([n]), 1, 1, bits=64).tolist() == [[n]]
    with pytest.raises(OverflowError):
        rc.tile_steps(i32([0, 0]), i32([[n, n]]), n - 8, n - 8, n, n, bits=32)


MAPS = [(640, 640), (1024, 1024), (896, 896), (480, 1000), (70, 101)]


@pytest.mark.parametrize("hw", MAPS, ids=lambda s: "x".join(map(str, s)))
def test_tile_plan_covers_every_cell_once(hw):
    H, W = hw
    th, tw, threads, tiles_y, tiles_x = rc.tile_plan(H, W)
    assert tw % 4 == 0 and threads % 32 == 0 and threads <= 1024
    assert 2 * th * tw <= 48 * 1024            # static shared memory of a block
    seen = torch.zeros((H, W), dtype=torch.int32)
    for i in range(tiles_y):
        for j in range(tiles_x):
            assert i * th < H and j * tw < W                  # no empty tile
            seen[i * th:(i + 1) * th, j * tw:(j + 1) * tw] += 1
    assert bool((seen == 1).all())


def scan(seed, P, sensor, reach, H, W):
    """A scan of P beams from ``sensor``, endpoints within ``reach`` cells."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, P)
    r = rng.uniform(0, reach, P)
    end = np.stack([sensor[0] + r * np.cos(ang), sensor[1] + r * np.sin(ang)], -1)
    return i32(sensor), i32(np.floor(end + 0.5)), torch.as_tensor(rng.random(P) < 0.9)


CLIPS = {   # sensor, reach, tile (x0, y0, x1, y1)
    "sensor_tile": ((50, 40), 90, (32, 32, 63, 63)),
    "neighbour_tile": ((50, 40), 90, (64, 32, 95, 63)),
    "far_tile": ((50, 40), 90, (0, 96, 31, 127)),
    "sensor_outside_map": ((-20, -35), 150, (0, 0, 31, 31)),
    "edge_tile_cut_by_map": ((90, 60), 80, (96, 64, 100, 69)),
    "long_rays": ((300, 20), 3000, (600, 0, 727, 63)),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_tile_steps_are_exactly_the_rays_steps_in_the_tile(name):
    sensor, reach, (x0, y0, x1, y1) = CLIPS[name]
    start, end, _ = scan(3, 400, sensor, reach, 0, 0)
    t_lo, t_hi = rc.tile_steps(start, end, x0, y0, x1, y1, bits=32)
    d = end.to(torch.int64) - start.to(torch.int64)[None, :]
    n = d.abs().amax(-1).clamp(min=1)
    T = int(n.max()) + 1
    t = torch.arange(T)[None, :]
    cx = start[0] + floor_cells(d[:, 0:1], n[:, None], t)
    cy = start[1] + floor_cells(d[:, 1:2], n[:, None], t)
    inside = (cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1) & (t < n[:, None])
    claimed = (t >= t_lo[:, None]) & (t <= t_hi[:, None])
    assert torch.equal(inside, claimed)
    if name != "far_tile":
        assert bool(inside.any())


def edge_scans():
    """name -> (start, end, beam_mask, H, W)"""
    cases = {}
    s, e, m = scan(4, 300, (47, 61), 70, 96, 128)
    cases["random_96x128"] = (s, e, m, 96, 128)
    cases["non_multiple_70x101"] = (*scan(5, 300, (33, 20), 90, 70, 101), 70, 101)
    cases["length_0_and_1"] = (i32([10, 12]), i32([[10, 12], [11, 12], [10, 11], [9, 13]]),
                               torch.ones(4, dtype=torch.bool), 40, 48)
    cases["every_beam_masked"] = (s, e, torch.zeros_like(m), 96, 128)
    cases["no_beam"] = (s, e[:0], m[:0], 96, 128)
    cases["sensor_outside_rays_cross"] = (*scan(6, 300, (-25, -10), 160, 96, 128), 96, 128)
    cases["rays_leave_high_side"] = (*scan(7, 300, (120, 90), 80, 96, 128), 96, 128)
    # a ray longer than the check's unrolled reach, on a 4096-cell-wide map
    cases["n_above_256_on_4096"] = (
        i32([5, 17]), i32([[4090, 30], [300, 0], [4095, 17], [700, 39]]),
        torch.ones(4, dtype=torch.bool), 40, 4096)
    # rays the kernels walk in 64 bits
    cases["needs_64_bits"] = (i32([-40000, 5]), i32([[60, 30], [100, -20], [-39990, 8]]),
                              torch.ones(3, dtype=torch.bool), 40, 128)
    return cases


EDGE_SCANS = edge_scans()


def carve(design, start, end, mask, H, W):
    if design == "tile_major":
        return rc.mark_image_tiled(start, end, mask, H, W)
    return rc.mark_image_beams(start, end, mask, H, W, team=16 if design.endswith("look") else 32)


@pytest.mark.parametrize("design", ["beam_major", "tile_major", "beam_major_look"])
@pytest.mark.parametrize("name", list(EDGE_SCANS))
def test_carve_designs_equal_plain(name, design):
    assert design in rc.MARK_DESIGNS
    start, end, mask, H, W = EDGE_SCANS[name]
    got = carve(design, start, end, mask, H, W)
    want = mark_image_plain(start, end, mask, H, W)
    assert got.dtype == torch.int32 and int((got != want).sum()) == 0
    if name in ("every_beam_masked", "no_beam"):
        assert int(got.sum()) == 0
    if name == "needs_64_bits":
        assert rc.needs_wide(start, end).tolist() == [True, True, False]
        assert int((got == 1).sum()) > 0


def test_ray_cells_of_the_plain_version_are_the_stepped_cells():
    start, end, mask, H, W = EDGE_SCANS["random_96x128"]
    flat, _ = _ray_cells_hw(80, H, W, start, end, mask)
    d = end.to(torch.int64) - start.to(torch.int64)[None, :]
    n = d.abs().amax(-1).clamp(min=1)
    zero = torch.zeros_like(n)
    cx = start[0] + rc.dda_stepped(d[:, 0], n, zero, 1, 80, bits=32)
    cy = start[1] + rc.dda_stepped(d[:, 1], n, zero, 1, 80, bits=32)
    inb = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    on = (torch.arange(80)[None, :] <= n[:, None]) & mask[:, None] & inb
    assert torch.equal(flat, torch.where(on, cy * W + cx, -1))


@pytest.mark.parametrize("S", [100, 200, 7])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_check_geometry(B, S):
    g = rc.check_geometry(B, S)
    assert g.grid == (g.groups, B) and g.threads == 32 * rc.CHECK_WARPS
    rays = [s for group in range(g.groups) for s in g.rays_of(group, S)]
    assert rays == list(range(S))                 # every ray in exactly one block
    assert all(len(g.rays_of(group, S)) >= 1 for group in range(g.groups))
    assert g.tickets == B
    # whatever the order of arrival, exactly one block finds the others' arrivals
    # in what its atomic returns, and it holds the sum of every block's count
    counts = np.random.default_rng(B * 1000 + S).integers(0, rc.CHECK_WARPS + 1, g.groups)
    word, stored = 0, []
    for group in np.random.default_rng(S).permutation(g.groups):
        seen, word = word, word + g.pack(int(counts[group]))
        if g.last(seen):
            stored.append((seen + int(counts[group])) & 0xFFFFFFFF)
    assert stored == [int(counts.sum())]


def test_check_geometry_refuses():
    assert rc.check_geometry(1, 0).groups == 1    # an empty pose still stores its 0
    with pytest.raises(ValueError):
        rc.check_geometry(rc.MAX_GRID_Y + 1, 100)


def check_case(seed, B, S, H, W, sensor, reach, thr_d2=2):
    rng = np.random.default_rng(seed)
    passes = torch.as_tensor(rng.integers(0, 6, (H, W)).astype(np.float32))
    hits = torch.as_tensor((rng.random((H, W)) * rng.integers(0, 2, (H, W)))
                           .astype(np.float32)) * passes
    start = i32(np.asarray(sensor)[None, :] + rng.integers(-3, 4, (B, 2)))
    ang = rng.uniform(0, 2 * np.pi, (B, S))
    r = rng.uniform(0, reach, (B, S))
    end = i32(np.floor(np.stack([sensor[0] + r * np.cos(ang),
                                 sensor[1] + r * np.sin(ang)], -1) + 0.5))
    ok = torch.as_tensor(rng.random((B, S)) < 0.8)
    return start, end, ok, hits, passes, 2.0, 0.4, thr_d2


CHECKS = {
    "b1_s100": (10, 1, 100, 96, 128, (50, 40), 60),
    "b4_s100": (11, 4, 100, 96, 128, (50, 40), 60),
    "b8_s200": (12, 8, 200, 96, 128, (50, 40), 60),
    "non_square_non_multiple": (13, 2, 100, 70, 101, (33, 20), 90),
    "sensor_outside_rays_cross": (14, 2, 100, 96, 128, (-25, -10), 160),
    "rays_leave_high_side": (15, 2, 100, 96, 128, (120, 90), 80),
    "n_above_256_on_4096": (16, 2, 40, 40, 4096, (5, 17), 4000),
    "threshold_0": (17, 2, 100, 96, 128, (50, 40), 60, 0),
    "threshold_large": (18, 2, 100, 96, 128, (50, 40), 60, 400),
    "s_7": (19, 3, 7, 96, 128, (50, 40), 60),
}


@pytest.mark.parametrize("name", list(CHECKS))
def test_bad_rays_stepped_equals_plain(name):
    args = check_case(*CHECKS[name])
    got = rc.bad_rays_stepped(*args)
    want = bad_rays_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if name.startswith("b"):
        assert int(want.sum()) > 0


def test_bad_rays_stepped_edge_rays():
    start, end, ok, hits, passes, *rest = check_case(20, 2, 8, 40, 128, (20, 12), 30)
    # zero length, length 1, a ray walked in 64 bits, every ray of pose 1 off
    end[0, 0] = start[0]
    end[0, 1] = start[0] + i32([1, 0])
    start[1] = i32([-40000, 5])
    assert bool(rc.needs_wide(start, end)[1].all())
    for okay in (ok, torch.ones_like(ok), torch.zeros_like(ok)):
        args = (start, end, okay, hits, passes, *rest)
        assert torch.equal(rc.bad_rays_stepped(*args), bad_rays_plain(*args))
    assert rc.bad_rays_stepped(start, end, torch.zeros_like(ok), hits, passes,
                               *rest).tolist() == [0, 0]


def mark_args():
    return scan(8, 64, (20, 20), 30, 48, 48)


def test_mark_plan_is_looked_up_and_refuses():
    start, end, mask = mark_args()
    plan = rc._mark_plan(start, end, mask, 48, 48, rc.MARK_DESIGN)
    n = len(rc._mark_plans)
    assert rc._mark_plan(start.clone(), end.clone(), mask.clone(), 48, 48,
                         rc.MARK_DESIGN) is plan and len(rc._mark_plans) == n
    assert list(plan.geometry) == [64, 48, 48, rc.MARK_DESIGN]
    assert rc._mark_plan(start, end, mask, 48, 64, rc.MARK_DESIGN) is not plan
    with pytest.raises(TypeError):
        rc._mark_plan(start, end.to(torch.int64), mask, 48, 48, rc.MARK_DESIGN)
    with pytest.raises(TypeError):
        rc._mark_plan(start, end, mask.to(torch.uint8), 48, 48, rc.MARK_DESIGN)
    with pytest.raises(ValueError):
        rc._mark_plan(start, end, mask[:-1], 48, 48, rc.MARK_DESIGN)
    with pytest.raises(ValueError):
        rc._mark_plan(start, end, mask, 48, 48, 99)
    # a validated combination is still refused when a tensor is not contiguous
    wide = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        rc._mark_plan(start, wide[:, :2], mask, 48, 48, rc.MARK_DESIGN)


def test_check_plan_is_looked_up_and_refuses():
    args = check_case(21, 2, 100, 48, 64, (20, 20), 30)
    start, end, ok, hits, passes, *rest = args
    plan = rc._check_plan(*args)
    assert rc._check_plan(start.clone(), end.clone(), ok, hits, passes, *rest) is plan
    p = plan.params
    assert (p.B, p.S, p.H, p.W, p.groups, p.ticket, p.thr_d2) == (2, 100, 48, 64, 25, 1, 2)
    assert plan.tickets.numel() >= 2 and plan.tickets.dtype == torch.int64
    assert int(plan.tickets.abs().sum()) == 0
    assert rc._check_plan(*args, ticket=False).params.ticket == 0
    assert rc._check_plan(start, end, ok, hits, passes, 2.0, 0.4, 5) is not plan
    with pytest.raises(TypeError):
        rc._check_plan(start, end, ok, hits.double(), passes, *rest)
    with pytest.raises(ValueError):
        rc._check_plan(start, end[:, :-1], ok, hits, passes, *rest)
    with pytest.raises(ValueError):
        rc._check_plan(start, end, ok, hits, passes[:-1], *rest)
    with pytest.raises(ValueError, match="contiguous"):
        rc._check_plan(start, end, ok, hits.t().contiguous().t(), passes, *rest)


def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    start, end, mask = mark_args()
    before = (rc.mark_launches, rc.check_launches)
    assert torch.equal(rc.ray_mark_image(start, end, mask, 48, 48),
                       mark_image_plain(start, end, mask, 48, 48))
    args = check_case(22, 2, 100, 48, 64, (20, 20), 30)
    assert torch.equal(rc.bad_ray_count(*args), bad_rays_plain(*args))
    assert (rc.mark_launches, rc.check_launches) == before     # no launch is counted
