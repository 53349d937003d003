"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each of its device stages as one compiled executable
per shape, one dispatch per call: on the detect path the dense refine +
decode of a chunk and the wave step, in calibration the LM's damping loop
(``lax.while_loop``), the init attempt, the pose init and the whole
single-camera calibration.  Eager torch dispatches the same work as
hundreds or thousands of kernel launches from the host.  On the card the
port records those launches once per shape into a ``torch.cuda.CUDAGraph``
and replays it with one host call.  This module is the shared core; the
detect path adds its key in ``detect/graphs.py``, the solvers theirs in
``solve/lm.py``.

``get(fn, args, inputs, bound=(), slot=0, pool=None, tag=None)`` returns
the graph of ``fn(*args, *bound, *inputs)``:

- ``args`` are static (hashable: a tag family, a projection function, LM
  options) and baked into the graph;
- ``inputs`` are tensors whose shape and dtype key the graph; the graph
  reads them from static buffers (``Graph.inputs``) that the caller fills
  before each ``replay`` (``copy_``, or ``index_select(..., out=)``), and
  may update them in place (the wave carry, the LM state);
- ``bound`` are tensors the graph reads or writes in place: they must be
  another graph's static buffers (the assist decode reads the primary
  decode's sharpened frames; the LM's start writes its loop's state), so
  their identity enters the key; a graph with ``bound`` may take no
  ``inputs`` of its own (the frame-sharded LM's phases all work on one
  holder graph's buffers per device);
- ``slot`` picks one of several instances of the same shape, each with its
  own buffers: for callers that keep one instance's outputs alive while
  they replay the next, and for threads that solve at once (``lease``);
- ``tag``: whatever else the function bakes in that the key must hold
  (the detect path's sampling branch);
- ``ensure`` is ``get`` from (shape, dtype) specs, capturing on zeros.

A graph's outputs are static buffers too: ``replay`` returns the same
tensors every time, and the caller copies out what it keeps before the
instance is replayed again.

A capture runs the function once eagerly first: per-device
constants made from host memory on a first call, library handles and the
first ``torch.func`` Jacobian's lazy imports all happen there, outside the
capture (an upload cannot be captured), and outside the lock below, so
that a first solve's seconds of set-up on the speculation thread hold up
no capture of the detecting thread.  It captures in ``"thread_local"``
mode, so other threads may use the card meanwhile; PyTorch allows one
capture at a time in a process, so one lock serializes every capture of
the process, the detect path's and the solvers' (and keeps two threads
from entering two graphs for one key).  A capture or replay that fails
raises; nothing falls back to eager.

CUDA refuses a device-wide synchronize while any stream of the device
captures, so library code synchronizes its own stream or an event, and a
device-wide synchronize that may run beside a capture goes through
``synchronize``, which waits for the capture to end.

A tensor on the CPU never reaches a capture: ``get`` then returns an eager
stand-in with the same interface (its ``replay`` calls the function on its
buffers), which is how the CPU tests drive the graphed code paths.
``active`` says whether a device takes graphs: the card, outside an
``eager()`` block and outside this thread's ``no_capture()`` block.
``eager()`` is a process-wide switch for tests and ``chip_smoke.py`` only;
``no_capture()`` is the warm-up thread's (``calib/prewarm.py``), so that
its solves run eagerly while the detecting thread keeps its graphs.

Several cards: a graph covers one device (PyTorch puts only the capturing
device's allocator into capture mode), so work over a mesh is one graph
per device and phase, and the copies between devices are issued by the
host between replays (``solve/lm.py``'s per-shard route).  Each device
has its own capture streams and pools (``_pools`` is keyed by device),
one ``lease`` slot serves one solve's graphs on every card, ``keep``
bounds the graphs per device, and ``synchronize`` takes a list of
devices.

Memory: a graph keeps its capture's memory (the function's peak) until
``reset``, or until ``keep`` drops it.  Graphs that are never in use at
once may share one pool (``pool=``): then a pool holds its largest
capture's intermediates once, beside every member's outputs.  The detect
path's shapes are bounded by its quad ladder and row buckets; the solvers'
frame counts are not (every dataset brings its own), so the solvers note
each solve's graphs with ``keep``, which holds those of the
``SHAPES_KEPT`` shapes a group used last per slot and device and drops
the rest.  ``counts`` reports captures, replays, capture seconds and the
held graphs' pools.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

#: True inside an ``eager()`` block: the card runs every call eagerly
_eager = False
#: ``off``: this thread is inside a ``no_capture()`` block
_local = threading.local()
_lock = threading.Lock()
#: key -> Graph
_cache: dict = {}
#: data_ptr of every static buffer (inputs and outputs): what ``bound`` may hold
_buffers: set = set()
#: (device, pool group) -> (graph pool handle, capture stream)
_pools: dict = {}
_counts = {"captures": 0, "replays": 0, "capture_s": 0.0}
#: (group, slot, device) -> {ids: graphs of one shape}, least recently used first
_recent: dict = {}
#: shapes whose graphs ``keep`` holds per group, slot and device
SHAPES_KEPT = 8
#: lease name -> slots held by some thread
_leases: dict = {}
_lease_lock = threading.Lock()


@contextlib.contextmanager
def eager(on: bool = True):
    """Run every graphed call inside the block eagerly on the card
    (``on=True``), or with graphs (``on=False``).  Process-wide; restored
    on exit, so blocks nest."""
    global _eager
    before = _eager
    _eager = bool(on)
    try:
        yield
    finally:
        _eager = before


@contextlib.contextmanager
def no_capture():
    """Inside the block, this thread runs every graphed call eagerly and
    captures nothing; other threads keep their graphs.  Restored on exit."""
    before = getattr(_local, "off", False)
    _local.off = True
    try:
        yield
    finally:
        _local.off = before


def _off() -> bool:
    return _eager or getattr(_local, "off", False)


def active(where) -> bool:
    """Whether calls on ``where`` (a tensor or a device) run as graphs: on
    the card, outside an ``eager()`` block and this thread's
    ``no_capture()`` block."""
    dev = torch.device(getattr(where, "device", where))
    return dev.type == "cuda" and not _off()


@contextlib.contextmanager
def lease(name):
    """A slot number for the graphs of ``name`` that no other thread holds
    until the block ends: 0 unless another thread is inside a block of the
    same name.  Two threads that solve at once thus never replay one
    instance (its buffers are shared); a slot is captured only when such
    an overlap first happens."""
    with _lease_lock:
        held = _leases.setdefault(name, set())
        slot = next(i for i in itertools.count() if i not in held)
        held.add(slot)
    try:
        yield slot
    finally:
        with _lease_lock:
            held.discard(slot)


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)`` once no capture runs: CUDA fails a
    device-wide synchronize while any stream of the device captures.
    ``device``: one device, None (the current one), or a list of devices
    (a mesh's cards), each synchronized in turn."""
    devices = device if isinstance(device, (list, tuple)) else [device]
    with _lock:
        for d in devices:
            torch.cuda.synchronize(d)


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


def _key(fn, args, device, specs, bound, slot, tag=None):
    """The cache key: function, static args, device, (shape, dtype) of
    every input, bound tensors by identity, instance slot, tag."""
    probe = torch.empty(0, device=device)  # "cuda" keys as "cuda:0" does
    return (
        fn, args, probe.device, slot, tag, specs,
        tuple(None if b is None else (b.data_ptr(), tuple(b.shape), b.dtype) for b in bound),
    )


def _specs(inputs) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in inputs)


def get(fn, args: tuple, inputs, bound=(), slot=0, pool=None, tag=None, warm=None) -> Graph:
    """The graph of ``fn(*args, *bound, *inputs)`` for the shapes and
    dtypes of ``inputs`` (captured now if missing; ``inputs`` are the
    example values of its warm-up run).  Its input buffers hold no
    particular values: fill them before ``replay``.

    ``pool``: graphs captured with the same (hashable) ``pool`` on a device
    share one memory pool, so a replay of any of them may overwrite the
    outputs of the others: the caller reads or copies a graph's outputs
    before it replays another graph of its pool.  None: a pool of its own.

    ``warm``: the static args of the warm-up run, when a cheaper call than
    the graph's own sets up what it needs (the LM's chunk warms up on one
    iteration); None: ``args``.

    ``inputs`` may be empty when ``bound`` is not: the graph then lies on
    the device of ``bound[0]``.

    On the CPU, inside ``eager()`` or inside this thread's
    ``no_capture()``, an eager stand-in with fresh buffers."""
    inputs = tuple(inputs)
    dev = (inputs or bound)[0].device
    if dev.type != "cuda" or _off():
        return Graph(fn, args, bound, tuple(torch.empty_like(t) for t in inputs))
    key = _key(fn, args, dev, _specs(inputs), bound, slot, tag)
    g = _cache.get(key)
    if g is None:
        g = _capture(fn, args, inputs, bound, pool, key, warm)
    return g


def ensure(fn, args: tuple, device, specs, bound=(), slot=0, pool=None, tag=None) -> Graph:
    """``get`` for inputs of these ((shape, dtype), ...) ``specs`` on the
    card, with zeros as the warm-up's example when it captures."""
    device = torch.device(device)
    g = _cache.get(_key(fn, args, device, tuple(specs), bound, slot, tag))
    if g is not None:
        return g
    zeros = [torch.zeros(shape, dtype=dtype, device=device) for shape, dtype in specs]
    return get(fn, args, zeros, bound, slot, pool, tag)


def run(fn, args: tuple, inputs, bound=(), slot=0, pool=None, tag=None):
    """``get``, copy ``inputs`` into the graph's buffers, ``replay``."""
    g = get(fn, args, inputs, bound, slot, pool, tag)
    for buf, t in zip(g.inputs, inputs):
        buf.copy_(t)
    return g.replay()


def _copied(tree):
    """``tree`` (a tensor, or a tuple / list of them and None) with every
    tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copied(v) for v in tree)
    return tree


def call(fn, args: tuple, inputs):
    """``fn(*args, *inputs)``: where ``inputs[0]`` takes graphs, one
    replay of its graph for these shapes (leased per function, so that
    threads never share an instance), with its outputs copied out; else
    an eager call.  For a function of tensors that returns a tensor or a
    tuple of tensors."""
    inputs = tuple(inputs)
    if not active(inputs[0]):
        return fn(*args, *inputs)
    with lease(fn) as slot:
        g = get(fn, args, inputs, slot=slot)
        for buf, t in zip(g.inputs, inputs):
            buf.copy_(t)
        out = _copied(g.replay())
        keep(fn, slot, (g,))
        return out


def keep(group, slot, gs) -> None:
    """Note ``gs``, the graphs of one shape (an LM's start and chunk, one
    ``call``, a frame-sharded LM's phases on one device), as the ones
    ``group``'s ``slot`` used last on their device, and drop from the cache
    the graphs of the least recently used shape beyond ``SHAPES_KEPT``,
    but for those a newer shape holds too.  The caller holds
    ``lease(group)``'s ``slot``, so no other thread replays what is
    dropped.  A dropped graph's pool returns to the card once nothing
    holds the graph: at the allocator's next ``empty_cache``, or when an
    allocation runs short.  Eager stand-ins are not held."""
    gs = tuple(g for g in gs if g.graph is not None)
    if not gs:
        return
    with _lock:
        dev = (gs[0].inputs or gs[0].bound)[0].device
        recent = _recent.setdefault((group, slot, dev),
                                    collections.OrderedDict())
        ids = tuple(id(g) for g in gs)
        recent[ids] = gs
        recent.move_to_end(ids)
        while len(recent) > SHAPES_KEPT:
            # a graph that a newer shape uses too stays (the frame-sharded
            # LM's first-device phases serve every shape of one size)
            old = recent.popitem(last=False)[1]
            live = {id(g) for kept in recent.values() for g in kept}
            old = [g for g in old if id(g) not in live]
            for k in [k for k, v in _cache.items() if any(v is g for g in old)]:
                del _cache[k]
            _buffers.difference_update(
                t.data_ptr() for g in old for t in (*g.inputs, *_tensors(g.outputs)))
            del old  # the last reference: the graphs go under the lock, beside no capture


def _capture(fn, args, inputs, bound, pool, key=None, warm=None) -> Graph:
    """Warm ``fn`` up eagerly (with the static args ``warm``, if given),
    then capture it under the process's capture lock; with ``key``, enter
    the graph into the cache (or return the one another thread entered
    meanwhile).  The warm-up takes no lock: a first call may take seconds
    (the first forward-mode Jacobian's imports), and another thread's
    captures must not wait for it."""
    for b in bound:
        if b is not None and b.data_ptr() not in _buffers:
            raise ValueError("a bound tensor must be a static buffer of another graph")
    t0 = time.perf_counter()
    dev = (inputs or bound)[0].device
    g = Graph(fn, args, bound, tuple(t.clone() for t in inputs))
    # what ``fn`` calls runs inside this capture, never as a graph of its own
    with torch.cuda.device(dev), no_capture():
        # on this thread's stream, as eager work: ``torch.cuda.Stream()``
        # hands out a pool of streams shared by every thread, so a stream
        # taken here could be the one another thread is capturing on
        fn(*(args if warm is None else warm), *g.bound, *g.inputs)  # outside the capture
        with _lock:
            if key is not None and key in _cache:
                return _cache[key]
            if pool is None:
                handle, side = None, torch.cuda.Stream(dev)
            else:  # one stream per shared pool, so its captures reuse its free blocks
                if (dev, pool) not in _pools:
                    _pools[dev, pool] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev))
                handle, side = _pools[dev, pool]
            side.wait_stream(torch.cuda.current_stream(dev))
            # device-wide: no other thread captures (this thread holds the lock)
            torch.cuda.synchronize(dev)
            reserved = torch.cuda.memory_reserved(dev)
            # capture_begin / capture_end, not ``torch.cuda.graph``, whose
            # entry also collects Python's garbage and empties the cache:
            # tenths of a second in a large process, at every first shape
            g.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                g.graph.capture_begin(pool=handle, capture_error_mode="thread_local")
                try:
                    g.outputs = fn(*args, *g.bound, *g.inputs)
                finally:
                    g.graph.capture_end()
            g.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            _buffers.update(t.data_ptr() for t in g.inputs)
            _buffers.update(t.data_ptr() for t in _tensors(g.outputs))
            _counts["captures"] += 1
            _counts["capture_s"] += time.perf_counter() - t0
            if key is not None:
                _cache[key] = g
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
        _recent.clear()
        _buffers.clear()
        _pools.clear()
