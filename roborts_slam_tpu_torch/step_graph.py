"""Per-scan programs replayed from CUDA graphs: the port's counterpart of the
JAX package's jitted steps.

The JAX engine compiles each per-scan step into one executable
(``jax.jit(_step_summary, static_argnames=("spec",), donate_argnums=...)``,
``fused_frontend_chain_step``, ``fused_cursor_step``): only the specs are
static; the scan, ``n_valid``, odometry, the fused chain ids and the store
slot are traced inputs; the state and the store are donated. Here a step is
a ``StepGraph``: a program ``fn(staged) -> packed`` over ONE static input
vector on the device (``stage`` writes a scan's inputs into a host vector,
the caller copies it in; ``unstage`` is the program's first operation),
writing the front-end state and the store rows in place and returning the
packed summary vector, which the caller reads once. On the card the program
is captured into a CUDA graph at its second call and replayed from then on;
a host value baked into a capture would be wrong at the next scan, so
nothing of a scan enters the program but through the staged vector.

The caller keys its programs by what JAX holds static (the step's kind, the
chain bucket, the specs) and by every tensor the program reads or writes in
place (``signature``): a buffer replaced or resized makes a new program and
a new capture, never a replay against stale memory.
"""

from __future__ import annotations

import contextlib
import gc
import threading

import torch

from .ops.cuda import launch

# held across every capture of this process (a step's here, the solve's in
# backend/spa.py) and while a graph is destroyed: destroying a graph is a CUDA
# call that a capture under way on this thread may not see
capture_lock = threading.RLock()


@contextlib.contextmanager
def capture_guard():
    """While entered: no other capture and no graph destruction (the lock),
    and no cyclic garbage collection, which could destroy a dead engine's
    graphs on this thread in the middle of a capture and invalidate it."""
    with capture_lock:
        enabled = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if enabled:
                gc.enable()

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


def signature(tensors) -> tuple:
    """What a captured program holds of the tensors it reads or writes in
    place: address and shape of each."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in tensors)


class StepGraph:
    """One per-scan program ``fn(staged) -> packed`` over the static input
    vector ``staged`` (made here, on ``device``).

    Calling it runs the program on what the caller copied into ``staged``
    and returns its output vector. On the card with ``capture`` set, the
    first call runs ``fn`` eagerly (the warm-up a capture needs: kernels
    built, launch plans and every cached constant made); the second
    captures it into a CUDA graph on a side stream (thread-local: the
    asynchronous back-end worker launches from its own thread meanwhile)
    and replays it on the caller's stream; every later call replays it.
    The output of a replay is the graph's static buffer, overwritten by the
    next replay. Each graph has its own memory pool, freed with it (a pool
    shared by programs that are made anew would be freed under the next
    capture). The kernel wrappers' launch counts recorded at the capture
    (``launch.capturing``) are added on every replay; the ray check's
    scratch words are the graph's own, made and zeroed before the capture.
    A capture that fails raises; nothing falls back to eager launches.
    Elsewhere (the CPU, or ``capture`` off) every call runs ``fn`` eagerly.
    ``last`` says what the latest call did: "eager", "capture" (then
    replayed) or "replay"."""

    def __init__(self, fn, size: int, device, capture: bool = True):
        self.fn = fn
        self.staged = torch.zeros((size,), dtype=torch.float32, device=device)
        self.capture = capture and self.staged.is_cuda
        self.graph = None
        self.out = None
        self.launches: list = []          # (counter, args) of the captured launches
        self.scratch: dict = {}
        self.calls = self.replays = self.captures = 0
        self.last = None

    def __call__(self) -> torch.Tensor:
        self.calls += 1
        if not self.capture or self.calls == 1:
            self.last = "eager"
            return self.fn(self.staged)
        self.last = "replay"
        if self.graph is None:
            self._capture()
            self.last = "capture"
        self.graph.replay()
        for counter, args in self.launches:
            counter(*args)
        self.replays += 1
        return self.out

    def release(self):
        """Destroy the graph (and free its memory) outside any capture."""
        with capture_lock:
            self.graph = self.out = None
            self.launches = []

    def _capture(self):
        dev = self.staged.device
        self.scratch = {"tickets": torch.zeros((launch.TICKET_WORDS,), dtype=torch.int64,
                                               device=dev)}
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        if side == main:
            side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # cuBLAS keeps a workspace per (handle, stream), made at the first
            # product on the stream: made inside the capture it would come
            # from the graph's pool, freed with the graph, and a later capture
            # on the same pooled stream (the solve's) would use freed memory
            torch.ones((1, 1, 1), device=dev) @ torch.ones((1, 1, 1), device=dev)
        graph = torch.cuda.CUDAGraph()
        launches: list = []
        with capture_guard(), torch.cuda.stream(side), \
                launch.capturing(launches, self.scratch):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self.fn(self.staged)
            finally:
                graph.capture_end()
        main.wait_stream(side)
        self.graph, self.out, self.launches = graph, out, launches
        self.captures += 1
