"""The correction rebuild's count kernel (K7, ``ops/cuda/rebuild.py``) on
the CPU: its wrapper's checks, the count tables, the geometry of its chunks,
words and bits, its algorithm stated in plain PyTorch
(``rebuild_counts_stepped``) against the per-slot loop, and the port's
rebuild (the loop, on CPU tensors) against the JAX package's
``_rebuild_all_maps`` at padded buckets. The kernel itself runs on the card
only: ``tests/test_torch_rebuild_card.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.engine as jeng
import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu_torch.engine as teng
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.ops.raster as tr
from roborts_slam_tpu_torch.ops.cuda import launch, rebuild


def _scans(seed, slots, valid, beams=48, reach=3.0, size=96, res=0.05):
    """``slots`` scans of ``beams`` beams (up to ``reach`` m) at poses over
    a ``size``² map of ``res`` m, the first ``valid`` of them real and the
    rest padding rows holding other scans (as a store's mirror may): slot 1
    sits off the map, every scan sends a fan of beams into one cell."""
    rng = np.random.default_rng(seed)
    side = size * res
    ang = rng.uniform(-2.4, 2.4, (slots, beams))
    r = rng.uniform(0.1, reach, (slots, beams))
    r[:, :6] = 1.0                                        # six beams, one cell
    ang[:, :6] = 0.3 + 1e-3 * np.arange(6)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = rng.random((slots, beams)) > 0.15
    poses = np.concatenate([rng.uniform(-0.4 * side, 0.4 * side, (slots, 2)),
                            rng.uniform(-3, 3, (slots, 1))], 1).astype(np.float32)
    if slots > 1:
        poses[1, :2] = [-0.7 * side, 0.2]                # the sensor off the map
    slot_valid = np.arange(slots) < valid
    return pts, mask, poses, slot_valid


def _cells(pts, mask, poses, size=96, res=0.05):
    """Sensor cells, end cells and beam masks as ``rebuild_count_map``
    computes them, and scan 0's."""
    off = torch.full((2,), size * res / 2)
    p, m, q = (torch.as_tensor(x) for x in (pts, mask, poses))
    batch = tr._scan_cells(1.0 / res, off, p, m, q)
    first = tr._scan_cells(1.0 / res, off, p[0], m[0], q[0])
    return [t.contiguous() for t in batch], tuple(t.contiguous() for t in first)


def _planes(size=96):
    return torch.full((size, size), 7.0), torch.full((size, size), 7.0)


BAD = [
    ("start_dtype", lambda a: a.update(start=a["start"].long()), TypeError),
    ("end_shape", lambda a: a.update(end=a["end"][:, :-1]), ValueError),
    ("mask_dtype", lambda a: a.update(beam_mask=a["beam_mask"].int()), TypeError),
    ("valid_shape", lambda a: a.update(slot_valid=a["slot_valid"][:-1]), ValueError),
    ("hits_dtype", lambda a: a.update(hits=a["hits"].double()), TypeError),
    ("passes_shape", lambda a: a.update(passes=a["passes"][:, :-1]), ValueError),
    ("end_not_contiguous",
     lambda a: a.update(end=a["end"].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
    ("hits_not_contiguous", lambda a: a.update(hits=a["hits"].t()), ValueError),
    ("extra_without_first", lambda a: a.update(first=None), ValueError),
    ("first_end_shape", lambda a: a.update(first=(a["first"][0], a["first"][1][:-1],
                                                  a["first"][2])), ValueError),
    ("negative_extra", lambda a: a.update(extra=-1), ValueError),
    ("end_rank", lambda a: a.update(end=a["end"][0]), ValueError),
]


@pytest.mark.parametrize("name,spoil,error", BAD, ids=[b[0] for b in BAD])
def test_wrapper_refuses_malformed_arguments(name, spoil, error):
    pts, mask, poses, valid = _scans(0, 4, 3)
    (start, end, beams), first = _cells(pts, mask, poses)
    hits, passes = _planes()
    args = dict(start=start, end=end, beam_mask=beams, slot_valid=torch.as_tensor(valid),
                hits=hits, passes=passes, free_factor=0.3, occu_factor=0.7, extra=3,
                first=first)
    spoil(args)
    with pytest.raises(error):
        rebuild.rebuild_counts(**args)


@pytest.mark.parametrize("factor", [0.3, 0.7, 0.0, 0.125, 0.9])
def test_count_table_is_sequential_float32(factor):
    table = rebuild.count_table(1.0 + factor, 8196).numpy()
    step = np.float32(1.0 + factor)
    want = np.zeros(8196, np.float32)
    acc = np.float32(0.0)
    for k in range(1, 8196):
        acc = np.float32(acc + step)
        want[k] = acc
    np.testing.assert_array_equal(table, want)
    if factor in (0.3, 0.7):
        # the rule bites: k * c differs from k sequential adds somewhere
        assert not np.array_equal(table, np.arange(8196, dtype=np.float32) * step)


GEOMETRIES = [(0, 8, 16, 16, 0), (1, 8, 16, 16, 3), (64, 1152, 1024, 1024, 3),
              (512, 1152, 1024, 1024, 3), (1450, 1152, 1024, 1024, 3),
              (2048, 1152, 1024, 1024, 3), (2048, 1152, 896, 896, 3),
              (8192, 1152, 1024, 1024, 3), (4096, 1152, 4096, 4096, 0), (100, 4, 3, 5, 0)]


@pytest.mark.parametrize("shape", GEOMETRIES, ids=["x".join(map(str, g)) for g in GEOMETRIES])
def test_geometry_places_every_slot_once_within_the_scratch(shape):
    B, P, H, W, extra = shape
    g = rebuild.geometry(*shape)
    assert g.slots == B + (extra > 0) and g.table == B + extra + 1
    seen = set()
    for v in range(g.slots):
        k, j, b = g.place(v)
        assert 0 <= k < g.chunks and 0 <= j < g.words and 0 <= b < 32
        assert v // g.chunks < g.per_chunk <= 32 * g.words < 65536
        seen.add((k, j, b))
    assert len(seen) == g.slots
    cells = H * W
    assert 8 * g.words * cells <= max(rebuild.SCRATCH_BYTES, 8 * cells)
    assert g.scratch_words == (2 * g.words * cells + (2 * cells if g.chunks > 1 else 0)
                               + 2 * g.table)
    if (B, H) == (2048, 1024):
        assert (g.chunks, g.words) == (9, 8)      # 256 slots a chunk at most


# slots, valid ones, extra, SCRATCH_BYTES (8192: one word a cell on a 32² map)
STEPPED = [(5, 3, 0, None), (7, 7, 3, None), (3, 1, 1, None), (40, 33, 3, 8192),
           (40, 40, 2, 8192), (64, 20, 3, 8192), (99, 70, 3, 16384)]


@pytest.mark.parametrize("slots,valid,extra,budget", STEPPED)
def test_stepped_kernel_equals_the_loop(slots, valid, extra, budget, monkeypatch):
    """The kernel's chunks, words and bits in plain PyTorch (several chunks
    where the scratch budget is cut; the extra slot in any chunk) against
    the per-slot loop, bit for bit."""
    if budget is not None:
        monkeypatch.setattr(rebuild, "SCRATCH_BYTES", budget)
    pts, mask, poses, valid_ = _scans(slots, slots, valid, size=32)
    (start, end, beams), first = _cells(pts, mask, poses, size=32)
    g = rebuild.geometry(slots, beams.shape[1], 32, 32, extra)
    assert budget is None or g.chunks > 1
    sv = torch.as_tensor(valid_)
    want = _planes(32)
    tr.rebuild_counts_plain(start, end, beams, sv, *want, 0.3, 0.7, extra, first)
    got = _planes(32)
    rebuild.rebuild_counts_stepped(start, end, beams, sv, *got, 0.3, 0.7, extra, first)
    assert float(want[1].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bucket,valid", [(64, 40), (128, 100), (256, 200)])
def test_rebuild_equals_jax_at_padded_buckets(bucket, valid):
    """The port's rebuild of every map (``engine._rebuild_all_maps``; the
    pub counts through the rebuild kernel's wrapper, the loop on the CPU)
    against the JAX package's, at a bucket padded with other scans' rows,
    scan 0 re-applied three times: every plane bit for bit."""
    size, res = 96, 0.05
    kw = dict(resolution=res, height=size, width=size, max_ray_cells=80, carve_window=0)
    pkw = dict(resolution=0.1, height=48, width=48, deviation=0.1, blur_offset=0.72)
    jpub, tpub = jgm.CountMapSpec(**kw), tgm.CountMapSpec(**kw)
    jprob, tprob = jgm.ProbMapSpec(**pkw), tgm.ProbMapSpec(**pkw)
    pts, mask, poses, sv = _scans(bucket, bucket, valid)
    off = np.full(2, size * res / 2, np.float32)
    poff = np.full(2, 2.4, np.float32)
    jp, jc, jf = jeng._rebuild_all_maps(
        jpub, jprob, jprob, jnp.asarray(off), jnp.asarray(poff), jnp.asarray(poff),
        *(jnp.asarray(x) for x in (pts, mask, poses, sv)), 0.3, 0.7,
        first_scan_extra=3, coarse_blur=True, fine_blur=False)
    pub = tgm.make_count_map(tpub, off, "cpu")
    coarse, fine = (tgm.make_prob_map(tprob, poff, "cpu") for _ in range(2))
    teng._rebuild_all_maps(tpub, tprob, tprob, pub, coarse, fine,
                           *(torch.as_tensor(x) for x in (pts, mask, poses, sv)), 0.3, 0.7,
                           3, True, False)
    assert float(pub.hits.sum()) > 0
    np.testing.assert_array_equal(pub.hits.numpy(), np.asarray(jp.hits))
    np.testing.assert_array_equal(pub.passes.numpy(), np.asarray(jp.passes))
    np.testing.assert_array_equal(coarse.probs.numpy(), np.asarray(jc.probs))
    np.testing.assert_array_equal(fine.probs.numpy(), np.asarray(jf.probs))


def test_padding_and_masked_slots_change_no_bit():
    """A padding slot marks nothing: the rebuild of the valid rows alone
    equals the padded one, whatever the padding rows hold."""
    pts, mask, poses, sv = _scans(9, 24, 10, size=48)
    (start, end, beams), first = _cells(pts, mask, poses, size=48)
    padded = _planes(48)
    tr.rebuild_counts_plain(start, end, beams, torch.as_tensor(sv), *padded, 0.3, 0.7, 3,
                            first)
    exact = _planes(48)
    tr.rebuild_counts_plain(start[:10].contiguous(), end[:10].contiguous(),
                            beams[:10].contiguous(), torch.ones(10, dtype=torch.bool),
                            *exact, 0.3, 0.7, 3, first)
    for a, b in zip(padded, exact):
        assert torch.equal(a, b)


def test_launches_counted_by_shape_and_recorded_in_a_capture(monkeypatch):
    """A call counts one launch at (B, P, H, W); inside a capture the count
    is recorded for the graph's replays instead."""
    monkeypatch.setattr(rebuild, "rebuild_launches", 0)
    monkeypatch.setattr(rebuild, "rebuild_shapes", rebuild.collections.Counter())
    launch.counted(rebuild._count, (2048, 1152, 1024, 1024))
    assert rebuild.rebuild_launches == 1
    assert dict(rebuild.rebuild_shapes) == {(2048, 1152, 1024, 1024): 1}
    recorded = []
    with launch.capturing(recorded, {}):
        launch.counted(rebuild._count, (512, 1152, 1024, 1024))
    assert rebuild.rebuild_launches == 1 and len(recorded) == 1
    for counter, args in recorded * 2:                  # two replays
        counter(*args)
    assert dict(rebuild.rebuild_shapes) == {(2048, 1152, 1024, 1024): 1,
                                            (512, 1152, 1024, 1024): 2}


def test_faulty_readings_differ_from_the_loop():
    """The card's faulty readings, here through the plain version: counting
    a cell once a beam, or a count times its increment, differs from the
    loop in some cell (``bench/rebuild_check.py``); the scene's edge cases
    (a sensor off the map, 64-bit rays) run through the chunked algorithm
    bit for bit."""
    from roborts_slam_tpu_torch.bench import rebuild_check as rc

    spec = rc.pub_spec(128, 0.2)
    args, first = rc.cells(spec, rc.corridor_rows(8, 6, 3, P=64, beams=60), "cpu")
    bad = rc.faulty_readings(args, first, 128, 128)
    assert bad["no_dedup"] > 0 and bad["count_times_c"] > 0, bad
    args, first = rc.edge_cells(args, first, 128, 128)
    want = rc.planes(128, 128, "cpu")
    tr.rebuild_counts_plain(*args, *want, *rc.FACTORS, rc.EXTRA, first)
    got = rc.planes(128, 128, "cpu")
    rebuild.rebuild_counts_stepped(*args, *got, *rc.FACTORS, rc.EXTRA, first)
    assert float(want[1].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
