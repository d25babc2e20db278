"""What every kernel wrapper does on the host around a launch.

A launch goes to PyTorch's current stream of the tensors' device. The
stream's pointer comes without building a ``Stream`` object where this torch
can give it so, and the device guard is taken only when the tensors' device
is not the current one. The wrappers count their launches under
``count_lock``: the engine launches kernels from two threads (the front end
and the asynchronous back-end worker), and a bare ``+= 1`` can lose a count.

A wrapper called while a step is captured into a CUDA graph launches
nothing then: its count goes through ``counted``, which records it in the
capture's list (``capturing``) for the graph to add on every replay, and
the ray check takes the capture's own scratch words (``capture_scratch``).
"""

from __future__ import annotations

import contextlib
import threading

import torch

count_lock = threading.Lock()
TICKET_WORDS = 64                 # the ray check's scratch words a capture owns
_capture = threading.local()      # the capture under way on this thread, if any


@contextlib.contextmanager
def capturing(launches: list, scratch: dict):
    """While entered, this thread's wrapper calls are being captured:
    ``counted`` appends ``(counter, args)`` to ``launches`` instead of
    counting, and ``capture_scratch`` returns ``scratch`` (buffers the
    capture owns, made before it began)."""
    _capture.state = (launches, scratch)
    try:
        yield
    finally:
        _capture.state = None


def capture_scratch() -> dict | None:
    """The scratch buffers of the capture under way on this thread, or
    None outside a capture."""
    state = getattr(_capture, "state", None)
    return None if state is None else state[1]


def capturing_now(device) -> bool:
    """Whether this thread's current stream on ``device`` is being
    captured (a lazily made constant must not be made then: it would live
    in the graph's memory)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def counted(counter, *args):
    """``counter(*args)``: count one launch; inside a capture, record it
    for the graph's replays instead."""
    state = getattr(_capture, "state", None)
    if state is None:
        counter(*args)
    else:
        state[0].append((counter, args))


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

