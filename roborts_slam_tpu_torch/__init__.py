"""roborts_slam_tpu_torch — the PyTorch/CUDA port of the 2D LiDAR SLAM engine.

Same sub-packages and module names as the JAX package beside it, so a reader
finds each counterpart: ``engine.py`` (the per-scan loop, its asynchronous,
fused and pipelined modes), ``frontend/`` (matchers, the front-end step),
``backend/`` (pose graph, chain matches, the SPA solve), ``models/`` (scans,
map specs and planes), ``ops/`` (correlative, raster, ray-cast,
Gauss-Newton and branch-and-bound ops, and the CUDA kernels under
``ops/cuda/``), ``io/`` (logs, bags, checkpoints, maps, the simulator),
``parallel/`` (meshes, the edge-sharded SPA and the sharded matchers on
``torch.distributed``), ``utils/`` and ``convert.py`` (state from the JAX
package). The port imports ``torch`` and ``numpy`` only; it shares no module
with the JAX package. The four kernels (two versions of correlation scoring,
ray carving, ray checking) are CUDA C++ for ``sm_90a``, built at first use;
on CPU tensors their plain PyTorch versions run instead. ``python -m
roborts_slam_tpu_torch run log.npz`` is the command line.
"""

from .config import SlamConfig, load_config


def __getattr__(name):
    if name == "SlamEngine":
        from .engine import SlamEngine

        return SlamEngine
    if name == "ScanLog":
        from .io.scan_log import ScanLog

        return ScanLog
    if name == "LaserModel":
        from .models.scan import LaserModel

        return LaserModel
    raise AttributeError(name)


__version__ = "0.1.0"
__all__ = ["SlamConfig", "load_config", "SlamEngine", "ScanLog", "LaserModel"]
