"""roborts_slam_tpu_torch — the PyTorch/CUDA port of the 2D LiDAR SLAM engine.

Same sub-packages and module names as the JAX package beside it, so a reader
finds each counterpart (``engine.py``, ``frontend/processor.py``,
``ops/correlative.py``, ...). The port imports ``torch`` and ``numpy`` only;
it shares no module with the JAX package. The three hot kernels (correlation
scoring, ray carving, ray checking) are CUDA C++ for ``sm_90a`` under
``ops/cuda/``, built at first use; on CPU tensors their plain PyTorch
versions run instead.
"""

from .config import SlamConfig, load_config


def __getattr__(name):
    if name == "SlamEngine":
        from .engine import SlamEngine

        return SlamEngine
    if name == "LaserModel":
        from .models.scan import LaserModel

        return LaserModel
    raise AttributeError(name)


__version__ = "0.1.0"
__all__ = ["SlamConfig", "load_config", "SlamEngine", "LaserModel"]
