"""Captured CUDA graphs on the detect path: the counterpart of the JAX
detector's ``jax.jit`` executables.

The JAX detector runs each of its two device stages as one compiled
executable per shape, one dispatch per call: the dense refine + decode of a
chunk (``ccrs_tpu/detect/decode.py:287``) and the wave step
(``ccrs_tpu/detect/track.py:243``).  Its shape discipline (the quad ladder
and sticky ``_mq``, the sticky wave row buckets, the accelerator chunk plan)
keeps the number of shapes small, so one executable serves a whole run.
On the card the port captures each once per shape and replays it with one
host call, through the shared graph core (``ccrs_tpu_torch/graphs.py``:
``Graph``, the capture lock, pools, ``counts``, ``reset``, ``eager``).

What this module adds is the detect path's key: the graphs bake in the
sampling branch of ``sample.py`` on their device, so ``get``, ``ensure``
and ``run`` put it into the key (``_key``).  The per-device constants of
the detect path (``decode._dense_constants``, ``sample._band``,
``sample._grid``) are made on the capture's warm-up run, outside the
capture.
"""

from __future__ import annotations

import torch

from .. import graphs as core
from ..graphs import (  # noqa: F401 (the detect path's and its tests' names)
    Graph,
    _capture,
    _specs,
    active,
    counts,
    eager,
    reset,
    reset_counts,
)
from . import sample


def __getattr__(name):
    # the switch lives in the core; ``graphs._eager`` reads its value now
    if name == "_eager":
        return core._eager
    raise AttributeError(name)


def _branch(device) -> bool:
    """The sampling branch that a graph on ``device`` bakes in."""
    return sample._use_mm(None, torch.empty(0, device=device))


def _key(fn, args, device, specs, bound, slot):
    """The cache key: function, static args, device, the sampling branch
    on that device, (shape, dtype) of every input, bound tensors by
    identity, instance slot."""
    return core._key(fn, args, device, specs, bound, slot, _branch(device))


def get(fn, args: tuple, inputs, bound=(), slot: int = 0, pool=None) -> Graph:
    """``graphs.get`` keyed by the sampling branch of the inputs' device."""
    inputs = tuple(inputs)
    return core.get(fn, args, inputs, bound, slot, pool, _branch(inputs[0].device))


def ensure(fn, args: tuple, device, specs, bound=(), slot: int = 0, pool=None) -> Graph:
    """``graphs.ensure`` keyed by the sampling branch of ``device``."""
    return core.ensure(fn, args, device, specs, bound, slot, pool, _branch(device))


def run(fn, args: tuple, inputs, bound=(), slot: int = 0, pool=None):
    """``get``, copy ``inputs`` into the graph's buffers, ``replay``."""
    g = get(fn, args, inputs, bound, slot, pool)
    for buf, t in zip(g.inputs, inputs):
        buf.copy_(t)
    return g.replay()
