"""Port vs JAX package: the second correlation kernel's path.

The JAX package's ``score_candidates_pallas_v2`` runs in interpret mode (as
``tests/test_pallas_correlation.py::test_v2_pair_kernel_matches_xla`` runs
it); the port's counterpart on CPU tensors is the plain version, which the
second CUDA kernel is held against on the card. Also: ``kernel_version()``
parsing and that ``ROBORTS_CORR_KERNEL=2`` changes nothing on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roborts_slam_tpu.models.grid_map as jgm
import roborts_slam_tpu.ops.correlative as jcr
import roborts_slam_tpu_torch.models.grid_map as tgm
import roborts_slam_tpu_torch.ops.correlative as tcr
import roborts_slam_tpu_torch.ops.cuda.correlation as tcuda
from roborts_slam_tpu.ops.pallas.correlation import (
    kernel_version as jax_kernel_version, score_candidates_pallas_v2,
)

torch.set_num_threads(1)

SPEC = dict(resolution=0.01, height=512, width=512, deviation=0.03,
            blur_offset=0.5)
TIERS = {
    "coarse": (0.6, 0.05, 0.523, 0.0349, 0.3, 20, True, 0),
    "fine": (0.2, 0.02, 0.175, 0.0349, 0.3, 20, True, 1),
    "super_fine": (0.02, 0.01, 0.0349, 0.00349, 0.3, 20, True, 2),
}


@pytest.fixture(scope="module")
def scene():
    """The inputs of test_v2_pair_kernel_matches_xla, with map values that a
    bf16 copy holds exactly (multiples of 1/128), so that the bf16 map of the
    Pallas path adds no quantization of its own."""
    rng = np.random.default_rng(5)
    probs = (rng.integers(0, 129, (512, 512)) / 128.0).astype(np.float32)
    pts = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    mask = np.ones(64, bool)
    mask[50:] = False                  # exercise invalid-slot padding
    center = np.array([256.0, 256.0, 0.1], np.float32)
    return probs, pts, mask, 50, center


@pytest.mark.parametrize("tier", list(TIERS))
def test_v2_interpret_path_matches_port(scene, tier):
    probs, pts, mask, n, center = scene
    want, wa, wx, wy = score_candidates_pallas_v2(
        jgm.ProbMapSpec(**SPEC), jcr.CorrelativeParams(*TIERS[tier]),
        jnp.asarray(probs), jnp.zeros(2), jnp.asarray(pts), jnp.asarray(mask),
        jnp.int32(n), jnp.asarray(center), interpret=True)
    got, ga, gx, gy = tcr.score_candidates(
        tgm.ProbMapSpec(**SPEC), tcr.CorrelativeParams(*TIERS[tier]),
        torch.as_tensor(probs), torch.zeros(2), torch.as_tensor(pts),
        torch.as_tensor(mask), n, torch.as_tensor(center),
        scores_fn=tcuda.correlation_scores_v2)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-4)
    d = np.abs(got.numpy() - np.asarray(want))
    # the bar of the first kernel's interpret-mode test: within the bf16
    # envelope 4.6e-4, except that the Pallas path forms cells as
    # base + step·k, which rounds differently at cell edges: at most 2 % of
    # the entries may differ by up to one sample's weight, 1/20
    assert d.max() <= 1.0 / 20 + 4.6e-4, d.max()
    assert (d > 4.6e-4).mean() <= 0.02, (d > 4.6e-4).mean()


@pytest.mark.parametrize("value,want", [(None, 1), ("1", 1), ("2", 2), ("junk", 1),
                                        ("", 1), ("3", 3)])
def test_kernel_version_parsing(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("ROBORTS_CORR_KERNEL", raising=False)
    else:
        monkeypatch.setenv("ROBORTS_CORR_KERNEL", value)
    assert tcuda.kernel_version() == jax_kernel_version() == want
    picked = tcuda.scores_fn()
    assert picked is (tcuda.correlation_scores_v2 if want == 2
                      else tcuda.correlation_scores)


@pytest.mark.parametrize("tier", list(TIERS))
def test_version_2_on_cpu_takes_the_plain_version(monkeypatch, scene, tier):
    """On CPU tensors both wrappers take the one plain version: the match
    under ROBORTS_CORR_KERNEL=2 equals the match under 1 bit for bit, and no
    launch is counted."""
    probs, pts, mask, n, center = scene
    spec = tgm.ProbMapSpec(**SPEC)
    params = tcr.CorrelativeParams(*TIERS[tier])
    pose = torch.tensor([2.57, 2.55, 0.12])
    args = (spec, params, torch.as_tensor(probs), torch.zeros(2),
            torch.as_tensor(pts), torch.as_tensor(mask), n, pose, torch.eye(3))
    before = (tcuda.launches, tcuda.launches_v2)
    monkeypatch.setenv("ROBORTS_CORR_KERNEL", "1")
    one = tcr.correlative_scan_match(*args)
    monkeypatch.setenv("ROBORTS_CORR_KERNEL", "2")
    two = tcr.correlative_scan_match(*args)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert (tcuda.launches, tcuda.launches_v2) == before


def test_v2_wrapper_checks_its_arguments(scene):
    probs, *_ = scene
    with pytest.raises(ValueError):
        tcuda.correlation_scores_v2(torch.as_tensor(probs), torch.zeros(1, 2, 3),
                                    torch.zeros(1, 2, 3), torch.ones(1, 3, dtype=torch.bool),
                                    torch.zeros(1, 4), torch.zeros(1, 4), 0.3,
                                    torch.ones(1))
    # on CPU tensors nothing but the ranks is checked, as in the first wrapper
    got = tcuda.correlation_scores_v2(
        torch.as_tensor(probs)[None], torch.zeros(1, 2, 3),
        torch.zeros(1, 2, 3), torch.ones(1, 3, dtype=torch.bool),
        torch.zeros(1, 4), torch.zeros(1, 4), 0.3, torch.ones(1))
    assert got.shape == (1, 2, 4, 4)
