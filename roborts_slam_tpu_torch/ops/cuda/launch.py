"""What every kernel wrapper does on the host around a launch.

A launch goes to PyTorch's current stream of the tensors' device. The
stream's pointer comes without building a ``Stream`` object where this torch
can give it so, and the device guard is taken only when the tensors' device
is not the current one.
"""

from __future__ import annotations

import torch


def _stream_pointer(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# the current stream's pointer of device ``index``
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _stream_pointer)


def call(fn, index: int, *args) -> int:
    """``fn(*args, stream)`` on the current stream of device ``index``;
    returns the C function's CUDA error code."""
    if torch.cuda.current_device() == index:
        return fn(*args, raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, raw_stream(index))

