"""The correction rebuild's count kernel (K7, ``ops/cuda/rebuild.py``) on the
card, against its plain version (``ops/raster.py::rebuild_counts_plain``, the
loop of one carve a slot) on the card, every plane bit for bit
(``bench/rebuild_check.py``). Every test needs a CUDA device and ``nvcc``
and skips without them. On the card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rebuild_card.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX.)"""

import pytest
import torch

from roborts_slam_tpu_torch.bench import rebuild_check as rc
from roborts_slam_tpu_torch.ops.cuda import build, rebuild

pytestmark = pytest.mark.card

# pub side, bucket, valid slots, extra re-applications of scan 0
CASES = [(1024, 64, 40, 3), (1024, 512, 400, 3), (1024, 1024, 1024, 3),
         (1024, 2048, 1450, 3), (896, 64, 64, 0), (896, 1024, 700, 3),
         (896, 2048, 2048, 3)]


@pytest.fixture
def card():
    """The card, or a skip where there is none or no ``nvcc``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    try:
        build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernel")
    return torch.device("cuda", 0)


def _scene(side, bucket, valid, seed, dev, edges=False):
    spec = rc.pub_spec(side)
    args, first = rc.cells(spec, rc.corridor_rows(bucket, valid, seed), dev)
    if edges:
        args, first = rc.edge_cells(args, first, side, side)
    return args, first


@pytest.mark.parametrize("side,bucket,valid,extra", CASES)
def test_kernel_equals_the_loop(card, side, bucket, valid, extra):
    """Corridor scans with padding rows at the profiles' pub maps: every
    cell of both planes bit for bit, and a second call repeats the first."""
    args, first = _scene(side, bucket, valid, bucket + side, card)
    r = rc.compare(args, first, side, side, extra)
    print(r)
    assert rc.held(r), r


@pytest.mark.parametrize("side,bucket", [(1024, 64), (896, 512), (1024, 2048)])
def test_kernel_equals_the_loop_at_the_edges(card, side, bucket):
    """A sensor off the map, rays leaving it on every side, a fan of beams
    into one cell and rays long enough for the 64-bit walk, scan 0's extra
    slot among them."""
    args, first = _scene(side, bucket, bucket // 2, 7 * bucket, card, edges=True)
    launches = rebuild.rebuild_launches
    r = rc.compare(args, first, side, side)
    print(r)
    assert rc.held(r), r
    assert rebuild.rebuild_launches == launches + 2
    assert rebuild.rebuild_shapes[(bucket, 1152, side, side)] >= 2


def test_a_faulty_kernel_differs(card):
    """The comparison bites: a kernel without the per-scan rule, and one
    that multiplies a count by its increment, differ from the loop."""
    args, first = _scene(1024, 64, 48, 11, card)
    bad = rc.faulty_readings(args, first, 1024, 1024)
    print(bad)
    assert bad["no_dedup"] > 0 and bad["count_times_c"] > 0, bad


def test_kernel_replays_in_a_graph(card):
    """The call captures into a CUDA graph (no host read, no allocation
    outside the graph's pool) and a replay writes what an eager call
    writes, after the inputs change under it."""
    args, first = _scene(1024, 512, 300, 5, card)
    hits, passes = rc.planes(1024, 1024, card)
    rebuild.rebuild_counts(*args, hits, passes, *rc.FACTORS, rc.EXTRA, first)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        rebuild.rebuild_counts(*args, hits, passes, *rc.FACTORS, rc.EXTRA, first)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    args[3][300:400] = True                      # more valid slots, as a store grows
    hits.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    want = rc.planes(1024, 1024, card)
    rebuild.rebuild_counts(*args, *want, *rc.FACTORS, rc.EXTRA, first)
    assert torch.equal(hits, want[0]) and torch.equal(passes, want[1])


def test_ptxas_reports_no_spills(card):
    lines = [ln for ln in rebuild.ptxas_report() if "rebuild" in ln or "spill" in ln]
    print("\n".join(lines))
    assert any("rebuild_mark_kernel" in ln for ln in lines), lines
    spills = [ln for ln in lines
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    assert not spills, spills
