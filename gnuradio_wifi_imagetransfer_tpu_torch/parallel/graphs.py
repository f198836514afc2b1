"""CUDA graphs of the local executors' device steps.

The JAX package runs each device step as one program, compiled once per
static shape: the local ``step`` (parallel/executor.py:259, whose offset
is a traced scalar), the adaptive stage A, and each stage-B bucket
(``_stage_b_fn*`` under ``functools.lru_cache(maxsize=64)``, the bucket
padded to a power of two). Their counterpart here is a CUDA graph.
``GraphCache`` keeps one graph a key, at most 64 of them,
the least recently used out.

A key's first call runs the function eagerly on a side stream. This
warm-up builds the kernels (nvcc) and cuFFT's plans, and its result is the
call's. Then the function is captured once, on that stream, into a graph
with its own memory pool. Each later call copies its inputs into the
graph's static input buffers and replays the graph. Inside the graph the
outputs are copied into one buffer; a replay returns views of one clone
of it, so it never overwrites what an earlier call returned.

A kernel wrapper counts a launch through ``ops.build.count_launch``. In a
capture that logs the call instead, and each replay counts the logged
calls and hands their inputs to an active ``utils.tracing.recording``
(``tracing.replayed``). So a call counts each kernel once, as the eager
function does, and ``ops/holds.py`` holds every replayed kernel call.

Captures run one at a time (a lock), in ``thread_local`` mode, so that
other threads may allocate, launch and wait for their own streams
meanwhile. While a capture runs, no thread may synchronise the whole
device (``torch.cuda.synchronize``: CUDA refuses it, and the capture
fails) or draw from the default CUDA generator (the capture holds it; a
``torch.Generator`` of one's own is free). A capture or a replay that
fails raises: nothing
falls back to the eager path. Graphs take CUDA tensors only; the
executors run CPU tensors eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing

_ALIGN = 16                     # byte alignment of each output in the packed buffer
_capture_lock = threading.Lock()
_streams: dict[int, torch.cuda.Stream] = {}      # side stream a device, under the lock


def _leaves(out):
    """(tensors, rebuild): an output's tensors (a tensor or a dataclass of
    tensors) and the function that makes the same kind of output from
    tensors in their places."""
    if isinstance(out, torch.Tensor):
        return [out], lambda ts: ts[0]
    names = [f.name for f in dataclasses.fields(out)]
    return ([getattr(out, n) for n in names],
            lambda ts: dataclasses.replace(out, **dict(zip(names, ts))))


class _Graph:
    """One function captured on its static inputs: the graph, the packed
    output buffer and its layout, and the kernel calls the capture
    logged. ``first`` is the warm-up's result, the first call's."""

    def __init__(self, fn, inputs):
        dev = inputs[0].device
        current = torch.cuda.current_stream(dev)
        with _capture_lock:
            side = _streams.get(dev.index)
            if side is None:
                side = _streams[dev.index] = torch.cuda.Stream(dev)
            self.static = [x.clone(memory_format=torch.contiguous_format) for x in inputs]
            side.wait_stream(current)
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                self.first = fn(*self.static)
            current.wait_stream(side)
            for t in _leaves(self.first)[0]:
                t.record_stream(current)
            t1 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            self.log: list = []
            with build.capture_log(self.log), torch.cuda.graph(
                    self.graph, stream=side, capture_error_mode="thread_local"):
                leaves, self._rebuild = _leaves(fn(*self.static))
                self._layout, off = [], 0
                for t in leaves:
                    self._layout.append((off, t.numel() * t.element_size(), t.dtype, t.shape))
                    off += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
                self.buf = torch.empty(off, dtype=torch.uint8, device=dev)
                for t, view in zip(leaves, self._views(self.buf)):
                    view.copy_(t)
            self.warm_ms = (t1 - t0) * 1e3
            self.capture_ms = (time.perf_counter() - t1) * 1e3

    def _views(self, buf: torch.Tensor) -> list[torch.Tensor]:
        return [buf[off: off + n].view(dtype).view(shape) for off, n, dtype, shape in self._layout]

    def replay(self, inputs):
        for s, x in zip(self.static, inputs, strict=True):
            if s.shape != x.shape or s.dtype != x.dtype:
                raise ValueError(f"graph input {tuple(x.shape)} {x.dtype} differs from its "
                                 f"capture's {tuple(s.shape)} {s.dtype}")
            s.copy_(x, non_blocking=True)
        self.graph.replay()
        out = self._rebuild(self._views(self.buf.clone()))
        for wrapper, args in self.log:
            tracing.replayed(wrapper, args)
        return out


class GraphCache:
    """At most ``MAX_GRAPHS`` CUDA graphs by key, the least recently used out.
    ``cache(key, fn, inputs)`` is ``fn(*inputs)``: eager with a capture at
    a key's first call, a replay at each later one. The key holds
    everything the graph fixes besides the inputs' shapes and dtypes,
    which are checked at each replay. ``captured`` counts captures and
    ``stats`` keeps (warm-up ms, capture ms, kernel calls) by key (host
    clock)."""

    MAX_GRAPHS = 64                 # the JAX package's lru_cache(maxsize=64)

    def __init__(self):
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self.captured = 0
        self.stats: dict = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, key, fn, inputs):
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            return g.replay(inputs)
        g = _Graph(fn, inputs)
        self.captured += 1
        self.stats[key] = (g.warm_ms, g.capture_ms, len(g.log))
        self._graphs[key] = g
        if len(self._graphs) > self.MAX_GRAPHS:
            # the evicted graph's last replay may still run on this stream
            torch.cuda.current_stream(g.buf.device).synchronize()
            self._graphs.popitem(last=False)
        out, g.first = g.first, None
        return out
