"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` on the detect
path.

The JAX detector runs each of its two device stages as one compiled
executable per shape, one dispatch per call: the dense refine + decode of a
chunk (``ccrs_tpu/detect/decode.py:287``) and the wave step
(``ccrs_tpu/detect/track.py:243``).  Its shape discipline (the quad ladder
and sticky ``_mq``, the sticky wave row buckets, the accelerator chunk plan)
keeps the number of shapes small, so one executable serves a whole run.
Eager torch dispatches the same work as a few thousand kernel launches
from the host.  On the card the port records those launches once per shape
into a ``torch.cuda.CUDAGraph`` and replays it with one host call.

``get(fn, args, inputs, bound=(), slot=0)`` returns the graph of
``fn(*args, *bound, *inputs)``:

- ``args`` are static (hashable: the tag family, ``do_refine``, the first
  tag id) and baked into the graph;
- ``inputs`` are tensors whose shape and dtype key the graph; the graph
  reads them from static buffers (``Graph.inputs``) that the caller fills
  before each ``replay`` (``copy_``, or ``index_select(..., out=)``);
- ``bound`` are tensors the graph reads in place: they must be another
  graph's static buffers (the assist decode reads the primary decode's
  sharpened frames and KLT maps), so their identity enters the key;
- ``slot`` picks one of several instances of the same shape, each with its
  own buffers, for callers that keep one instance's outputs alive while
  they replay the next (the cold detector's two chunks in flight);
- ``ensure`` is ``get`` from (shape, dtype) specs, capturing on zeros.

The key also holds the function, the device and the sampling branch
(``sample.py``'s, which the graph bakes in).  A graph's outputs are static
buffers too: ``replay`` returns the same tensors every time, and the
caller copies out what it keeps before the instance is replayed again.

A capture runs the function once eagerly on a side stream first: the
per-device constants (``decode._dense_constants``, ``sample._band``,
``sample._grid``) are made on the first call from host memory, and such an
upload cannot be captured.  It captures in ``"thread_local"`` mode, so the
speculation and warm-up threads may use the card meanwhile; PyTorch allows
one capture at a time in a process, so one lock serializes captures (and
keeps two threads from capturing the same key).  A capture or replay that
fails raises; nothing falls back to eager.

A tensor on the CPU never reaches a capture: ``get`` then returns an
eager stand-in with the same interface (its ``replay`` calls the function
on its buffers), which is how the CPU tests drive the graphed code paths.
``active`` says whether a device takes graphs: the card, outside an
``eager()`` block.  ``eager()`` is a scoped switch for tests and
``chip_smoke.py`` only.

Memory: a graph keeps its capture's memory (the function's peak, KLT maps
included) until ``reset``.  Graphs that are never in use at once may share
one pool (``pool=``): then a pool holds its largest capture's intermediates
once, beside every member's outputs.  ``counts`` reports captures,
replays, capture seconds and the pools' size.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from . import sample

#: True inside an ``eager()`` block: the card runs every call eagerly
_eager = False
_lock = threading.Lock()
#: key -> Graph
_cache: dict = {}
#: data_ptr of every static buffer (inputs and outputs): what ``bound`` may hold
_buffers: set = set()
#: (device, pool group) -> (graph pool handle, capture stream)
_pools: dict = {}
_counts = {"captures": 0, "replays": 0, "capture_s": 0.0}


@contextlib.contextmanager
def eager(on: bool = True):
    """Run every detect-path call inside the block eagerly on the card
    (``on=True``), or with graphs (``on=False``).  Process-wide; restored
    on exit, so blocks nest."""
    global _eager
    before = _eager
    _eager = bool(on)
    try:
        yield
    finally:
        _eager = before


def active(where) -> bool:
    """Whether calls on ``where`` (a tensor, a frame-shard set or a
    device) run as graphs: on the card, outside an ``eager()`` block."""
    dev = torch.device(getattr(where, "device", where))
    return dev.type == "cuda" and not _eager


class Graph:
    """One instance: static input buffers, the captured graph (None for
    the eager stand-in) and its static outputs."""

    __slots__ = ("fn", "args", "bound", "inputs", "graph", "outputs", "pool_bytes")

    def __init__(self, fn, args, bound, inputs):
        self.fn, self.args, self.bound, self.inputs = fn, args, tuple(bound), inputs
        self.graph, self.outputs, self.pool_bytes = None, None, 0

    def replay(self):
        """Run the graph on what its input buffers hold now; returns its
        outputs (the same buffers every time for a captured graph)."""
        if self.graph is None:
            return self.fn(*self.args, *self.bound, *self.inputs)
        self.graph.replay()
        _counts["replays"] += 1
        return self.outputs


def _tensors(tree):
    """The tensors of a dict / tuple / list of tensors (None skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _key(fn, args, device, specs, bound, slot):
    """The cache key: function, static args, device, the sampling branch
    on that device, (shape, dtype) of every input, bound tensors by
    identity, instance slot."""
    probe = torch.empty(0, device=device)  # "cuda" keys as "cuda:0" does
    return (
        fn, args, probe.device, slot, sample._use_mm(None, probe), specs,
        tuple(None if b is None else (b.data_ptr(), tuple(b.shape), b.dtype) for b in bound),
    )


def _specs(inputs) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in inputs)


def get(fn, args: tuple, inputs, bound=(), slot: int = 0, pool=None) -> Graph:
    """The graph of ``fn(*args, *bound, *inputs)`` for the shapes and
    dtypes of ``inputs`` (captured now if missing; ``inputs`` are the
    example values of its warm-up run).  Its input buffers hold no
    particular values: fill them before ``replay``.

    ``pool``: graphs captured with the same (hashable) ``pool`` on a device
    share one memory pool, so a replay of any of them may overwrite the
    outputs of the others: the caller reads or copies a graph's outputs
    before it replays another graph of its pool (the cold detector's
    decodes of one slot, or the waves).  None: a pool of its own.

    On the CPU or inside ``eager()``, an eager stand-in with fresh buffers."""
    inputs = tuple(inputs)
    x = inputs[0]
    if x.device.type != "cuda" or _eager:
        return Graph(fn, args, bound, tuple(torch.empty_like(t) for t in inputs))
    key = _key(fn, args, x.device, _specs(inputs), bound, slot)
    g = _cache.get(key)
    if g is None:
        with _lock:
            g = _cache.get(key)
            if g is None:
                g = _capture(fn, args, inputs, bound, pool)
                _cache[key] = g
    return g


def ensure(fn, args: tuple, device, specs, bound=(), slot: int = 0, pool=None) -> Graph:
    """``get`` for inputs of these ((shape, dtype), ...) ``specs`` on the
    card, with zeros as the warm-up's example when it captures."""
    device = torch.device(device)
    g = _cache.get(_key(fn, args, device, tuple(specs), bound, slot))
    if g is not None:
        return g
    zeros = [torch.zeros(shape, dtype=dtype, device=device) for shape, dtype in specs]
    return get(fn, args, zeros, bound, slot, pool)


def run(fn, args: tuple, inputs, bound=(), slot: int = 0, pool=None):
    """``get``, copy ``inputs`` into the graph's buffers, ``replay``."""
    g = get(fn, args, inputs, bound, slot, pool)
    for buf, t in zip(g.inputs, inputs):
        buf.copy_(t)
    return g.replay()


def _capture(fn, args, inputs, bound, pool) -> Graph:
    for b in bound:
        if b is not None and b.data_ptr() not in _buffers:
            raise ValueError("a bound tensor must be a static buffer of another graph")
    t0 = time.perf_counter()
    dev = inputs[0].device
    with torch.cuda.device(dev):
        if pool is None:
            handle, side = None, torch.cuda.Stream(dev)
        else:  # one stream per shared pool, so its captures reuse its free blocks
            if (dev, pool) not in _pools:
                _pools[dev, pool] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev))
            handle, side = _pools[dev, pool]
        g = Graph(fn, args, bound, tuple(t.clone() for t in inputs))
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*args, *g.bound, *g.inputs)  # warm-up: per-device constants, outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, pool=handle, stream=side,
                              capture_error_mode="thread_local"):
            g.outputs = fn(*args, *g.bound, *g.inputs)
        g.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    _buffers.update(t.data_ptr() for t in g.inputs)
    _buffers.update(t.data_ptr() for t in _tensors(g.outputs))
    _counts["captures"] += 1
    _counts["capture_s"] += time.perf_counter() - t0
    return g


def counts() -> dict:
    """Captures, replays and capture seconds since the last
    ``reset_counts``; the graphs held and the MiB their captures added to
    the card's reserved memory (their pools)."""
    with _lock:
        graphs = list(_cache.values())
    return dict(_counts, graphs=len(graphs),
                pool_mib=sum(g.pool_bytes for g in graphs) / 2**20)


def reset_counts() -> None:
    """Set the capture and replay counts to 0."""
    _counts.update(captures=0, replays=0, capture_s=0.0)


def reset() -> None:
    """Drop every graph and its memory pool once the card has run what
    was queued (their buffers must no longer be in use)."""
    with _lock:
        for dev in {k[2] for k in _cache}:
            torch.cuda.synchronize(dev)
        _cache.clear()
        _buffers.clear()
        _pools.clear()
