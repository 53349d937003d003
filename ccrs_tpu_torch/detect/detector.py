"""TagDetector: the public detection API.

Port of ``ccrs_tpu/detect/detector.py``.  The cold pipeline runs a frame
batch in chunks, in the JAX package's three phases, so that the host and
the card work at the same time:

  phase 0: per chunk, queue the frame gather and the threshold front-end
    (the CUDA kernel on a CUDA tensor), and start the packed bitmap's copy
    to pinned host memory right behind it;
  phase 1 (per chunk): wait for the bitmap's copy, hand the packed bits to
    the native quad stage (``quads.extract_quad_stage``: one C++ call,
    OpenMP over frames, that extracts both erosion levels of each frame and
    merges them), queue the refine + unsharp + decode and start the copy of
    its outputs: the card decodes chunk k while the host extracts the quads
    of chunk k+1;
  phase 2 (per chunk, one chunk behind phase 1): read the decode outputs,
    build per-frame results, queue the board-assisted recovery decode of
    the tags the first pass missed and start its copies;
  phase 3: read and merge the recovery results.

Phase 2 of chunk k runs right after phase 1 of chunk k+1 (the JAX package
runs all of phase 1 first): the decode's KLT maps, 28 bytes a pixel, are
then alive for two chunks at most, whatever the batch size.

Each step runs under a stage timer (``utils/profiling.py``):
``detect/threshold``, ``detect/quadproc``, ``detect/dispatch``,
``detect/decode`` and ``detect/assist``; the quad stage counts its frames
(``detect/quad-frames``) and those that ran the second erosion level
(``detect/quad-level2``).  Uploads go through pinned
memory without blocking; a read waits on the event recorded after its own
copy, never on the whole stream.

On the card the refine + decode and the assist decode run as replayed CUDA
graphs (``graphs.py``), the counterpart of the JAX package's one compiled
executable per shape, keyed by the JAX shape discipline: the decode's quad
count goes up the JAX ladder (``_quad_rung``, the sticky ``_mq``), and the
chunks follow the JAX accelerator plan (``chunk``-sized pieces plus
``cold_chunk``-sized tail pieces), so two frame counts serve every sweep.
A tail piece's threshold and quad extraction run on its real frames only;
its decode runs on the piece's full size, the last frame repeated as the
JAX package pads it, and the padding results are dropped.  Two instances
of each decode graph are used in turn (chunk k and k+1), so chunk k's
assist still reads its own maps when chunk k+1's decode has run.  Eager
(the CPU, or the card inside ``graphs.eager()``) keeps natural chunks
(``chunk`` frames, the last one short) and decodes each chunk's own quad
count; the JAX plan, its last piece clipped, runs there only under
``CCRS_FORCE_CHUNK_PLAN``.  Padding changes no result bit: frames and quads
never interact.

With a board, ``detect_batch`` takes the wave-tracking video fast path by
default (detect/tracked.py; ``track=False`` or ``CCRS_TRACK=0`` turns it
off), whose anchors and audits run the cold pipeline on chosen frames.  ``detect`` on a single
image wraps the batch path.

Frame sharding (``shard=``, parallel/mesh.py): the batch is split into
contiguous shards over the mesh, and the cold pipeline runs each shard's
chunks on that shard's device (threshold kernel, refine+decode and assist
included).  Sharding changes placement only, never values.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..parallel.mesh import FrameShards, mesh_for, shard_frames
from ..utils.profiling import count, stage
from . import graphs
from .assist import _BUCKET, assist_candidates, assist_merge
from .decode import refine_decode_fused_dense
from .families import TagFamily, get_family
from .quads import MAX_QUADS, extract_quad_stage
from .threshold import threshold_front

#: decode outputs the results are built from, and those the assist merge reads
_DECODE_KEYS = ("tag_id", "hamming", "valid", "corners")
_ASSIST_KEYS = ("tag_id", "hamming", "corners")


class _Fetch:
    """A device-to-host copy started now and read later (the counterpart of
    the JAX package's ``_async_fetch``).  For a CUDA tensor: a pinned host
    tensor, ``copy_(src, non_blocking=True)`` on the source device's
    current stream and an event recorded after it; ``get`` waits on that
    event only, not on the work queued after it.  For a CPU tensor the
    plain copy."""

    __slots__ = ("host", "event")

    def __init__(self, src: torch.Tensor):
        if src.device.type != "cuda":
            self.host, self.event = src.cpu(), None
            return
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        self.host.copy_(src, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(src.device))

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _fetch_all(out: dict, keys) -> dict:
    """Start the host copies of ``out[k]`` for each of ``keys``."""
    return {k: _Fetch(out[k]) for k in keys}


def _read_all(fetches: dict) -> dict:
    """Wait for the copies of ``_fetch_all`` and return the numpy arrays."""
    return {k: f.get() for k, f in fetches.items()}


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array without draining the stream: for a CUDA device
    through a pinned copy with ``non_blocking=True`` (PyTorch's pinned-memory
    cache records an event on the copy and reuses the block only after it
    completes, so the source may go out of scope at once).  For the CPU
    the array's own memory."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _quad_rung(need: int) -> int:
    """Smallest rung of the JAX package's ~1.5x, 8-aligned quad-bucket
    ladder (8, 16, 24, 40, 64, 96, 144, 216, ...) that fits ``need`` quads."""
    m = 8
    while m < need:
        m = -(-m * 3 // 2 // 8) * 8
    return m


def _decode_graph(family, do_refine, images, quads, qvalid):
    """The primary refine + decode, in the argument order ``graphs.get``
    captures."""
    return refine_decode_fused_dense(family, images, quads, qvalid, do_refine=do_refine)


def _assist_graph(family, do_refine, sharp, maps, quads, qvalid):
    """The assist decode, reading a primary decode's sharpened frames and
    maps in place (the frames themselves are not read again)."""
    return refine_decode_fused_dense(family, sharp, quads, qvalid, do_refine=do_refine,
                                     sharp=sharp, maps=maps)


def _chunk_plan(B: int, chunk: int, small: int, cpu: bool,
                forced: int | None = None) -> list:
    """Chunk sizes covering a B-frame batch (``ccrs_tpu``'s plan, the same
    values).  ``cpu`` (the natural plan, which the port runs eagerly):
    ``forced`` or ``chunk`` frames each, the last one short.  Otherwise the
    JAX accelerator plan (the port's with graphs, or eagerly under
    ``CCRS_FORCE_CHUNK_PLAN``): ``forced`` repeated, or ``chunk``-sized
    pieces plus ``small``-sized tail pieces; the sum may pass B
    (``_chunk_spans`` clips the last piece)."""
    if B <= 0:
        return []
    if cpu:
        sizes = []
        base = forced if forced is not None else chunk
        rem = B
        while rem > 0:
            sizes.append(min(base, rem))
            rem -= sizes[-1]
        return sizes
    if forced is not None:
        return [forced] * ((B + forced - 1) // forced)
    small = min(small, chunk)
    sizes = [chunk] * (B // chunk)
    rem = B - chunk * len(sizes)
    sizes += [small] * ((rem + small - 1) // small)
    return sizes


def _chunk_spans(B: int, chunk: int, small: int, cpu: bool,
                 forced: int | None = None) -> list:
    """(first frame, frames) of each chunk of ``_chunk_plan``'s cover, the
    last one clipped to the frames that remain: no padding frame."""
    spans, lo = [], 0
    for size in _chunk_plan(B, chunk, small, cpu, forced):
        spans.append((lo, min(size, B - lo)))
        lo += spans[-1][1]
    return spans


def _anchor_starts(B: int, K: int, p0: int) -> List[int]:
    """Anchor-triple start frames for a B-frame batch at cadence K,
    beginning at p0 (0 unless a streaming carry aligns to the global
    grid); an anchor is forced at the tail so every frame sits in a
    segment."""
    starts: List[int] = []
    p = p0
    while p <= B - 3:
        starts.append(p)
        p += K
    if not starts or starts[-1] != B - 3:
        if starts and B - 3 - starts[-1] < 3:
            starts.pop()
        starts.append(B - 3)
    return starts


def _to_gray_f32(img: np.ndarray) -> np.ndarray:
    """Any common image format -> float32 grayscale on a 0..255 scale."""
    img = np.asarray(img)
    if img.ndim == 3:
        if img.shape[2] == 4:
            img = img[..., :3]
        # ITU-R BT.601 luma
        img = img @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
    if img.dtype == np.uint16:
        img = img.astype(np.float32) / 257.0
    else:
        img = img.astype(np.float32)
        if img.size and img.max() <= 1.5:  # 0..1 floats
            img = img * 255.0
    return img


class TagDetector:
    """AprilGrid tag detector.

    Args:
      family: family name ("t36h11", "t16h5", ...) or a TagFamily.
      refine: run subpixel corner refinement (default True).
      track: wave tracking when a board is given; None (default) reads
        ``CCRS_TRACK`` (on unless "0").
      device: where ``detect``/``detect_batch`` put host images (default
        the current CUDA device; pass "cpu" for the CPU); a ``dev_images``
        tensor runs on its own device.

    Pipeline knobs (environment, read here, as in the JAX package): the
    chunk size ``chunk`` (``CCRS_DETECT_CHUNK``, 64 frames), the tail
    piece size of the JAX accelerator plan ``cold_chunk``
    (``CCRS_TRACK_COLD_CHUNK``, 8 frames), and ``pyramid_min_side``
    (``CCRS_PYRAMID_MIN_SIDE``, 768 px): frames at least this wide or tall
    run the candidate stages on a half-resolution pyramid level.  A
    non-empty ``CCRS_FORCE_CHUNK_PLAN``, read per call, runs the JAX
    accelerator plan (``cold_chunk`` tail pieces) on any device; unset,
    chunks take their natural size.  Tracking knobs: the anchor cadence ``cold_every``
    (``CCRS_TRACK_COLD_EVERY``, 40 frames) and the sparse-board threshold
    ``sparse_frac`` (``CCRS_TRACK_SPARSE_FRAC``, 0.30) below which a
    segment is cold-detected instead of tracked.
    ``shard``: split each batch over the device mesh (parallel/mesh.py):
    None (default) shards when the mesh (``make_mesh()``) holds more than
    one CUDA device, ``CCRS_SHARD_DETECT=1``/``0`` forces it on or off; a
    batch whose size is not a multiple of the mesh size, or that lies on
    another device type than the mesh, is not sharded.
    ``on_provisional``: optional hook called once per tracked batch with
    the provisional per-frame results, right before the audit rounds
    (calib/pipeline.SpeculativeCalib).  ``stats``: counters of the last
    tracked batch (frames, cold_frames, cold_groups, trigger_frames, waves,
    resweeps; ``provisional_error`` when the hook raised).
    """

    def __init__(
        self,
        family="t36h11",
        refine: bool = True,
        max_quads: int = MAX_QUADS,
        track: bool | None = None,
        device="cuda",
        shard: bool | None = None,
    ):
        self.family: TagFamily = (
            family if isinstance(family, TagFamily) else get_family(family)
        )
        self.refine = refine
        self.max_quads = max_quads
        self.device = torch.device(device)
        if track is None:
            track = os.environ.get("CCRS_TRACK", "1") != "0"
        self.track = bool(track)
        self.chunk = int(os.environ.get("CCRS_DETECT_CHUNK", "64"))
        self.pyramid_min_side = int(os.environ.get("CCRS_PYRAMID_MIN_SIDE", "768"))
        self.cold_chunk = int(os.environ.get("CCRS_TRACK_COLD_CHUNK", "8"))
        self.cold_every = int(os.environ.get("CCRS_TRACK_COLD_EVERY", "40"))
        self.sparse_frac = float(os.environ.get("CCRS_TRACK_SPARSE_FRAC", "0.30"))
        if shard is None:
            env = os.environ.get("CCRS_SHARD_DETECT")
            shard = env == "1" if env is not None else None
        self.shard = shard
        self.on_provisional = None
        self.stats: dict = {}
        self.debug = None
        self._tstate = None
        #: threshold kernel launches of the last ``prewarm`` call, counted
        #: at the launch site on the thread that ran it
        self.prewarm_launches = 0
        # the JAX package's sticky shape buckets, kept on every device;
        # only graphs run at them (eager runs each call's own sizes)
        #: decode quad bucket, a rung of ``_quad_rung``'s ladder (grow-only)
        self._mq = 8
        #: wave rows of the main sweep and of the repair resweeps (grow-only)
        self._wave_rows = 0
        self._wave_rows_small = 8
        #: (device, (H, W), dtype) -> the chunk sizes decoded there with graphs
        self._graph_sizes: dict = {}

    def _shard_frames(self, frames):
        """Split a (B, ...) tensor over the mesh when sharding is on (see
        ``shard``), B divides the mesh and the mesh has the batch's device
        type; otherwise return it as it is."""
        mesh = mesh_for(frames.device)
        use = frames.device.type == "cuda" if self.shard is None else self.shard
        if not use or len(mesh) <= 1 or frames.shape[0] % len(mesh) != 0:
            return frames
        return shard_frames(frames, mesh)

    def reset_tracking(self) -> None:
        """Drop the frame-to-frame tracking carry (call between cameras /
        unrelated sequences; a stale carry only costs cold fallbacks, not
        correctness)."""
        self._tstate = None

    def begin_tracked(self, board, n_frames: int | None = None):
        """Open a streaming tracked-detection session
        (tracked.TrackedSession): ``feed`` chunks as they arrive,
        ``finalize`` once for the whole sequence, so the audit rounds run
        once per sequence and the provisional hook sees every frame.
        ``n_frames`` sizes the preallocated sequence buffer.  Returns None
        when tracking is unavailable (no board, tracking off, refine off);
        callers then detect chunk by chunk with ``detect_batch``."""
        if board is None or not (self.track and self.refine):
            return None
        from .tracked import TrackedSession

        return TrackedSession(self, board, n_frames=n_frames)

    def prewarm(self, height: int, width: int, board=None,
                n_frames: int | None = None) -> None:
        """Pay the detect path's one-time costs on dummy frames of the real
        size, so that the first real chunk does not: the build or load of
        the three native libraries (the CUDA kernels, the quad extractor,
        the PNG unfilter), the CUDA context, and the first launch of every
        device operation the pipeline uses.  Meant for a background thread
        while the host decodes images; safe to skip.

        Seeds the sticky shape buckets as the JAX package's warm-up does:
        with a board ``_mq`` to the rung of ``board.n_tags + 4`` quads, with
        tracking ``_wave_rows`` to the row bucket that ``n_frames`` implies,
        so the first detection captures its graphs at those shapes.  Then,
        on ``self.device``, through the cold pipeline's own copies: one
        upload, one ``threshold_front`` launch at the scale this frame size
        takes, the bitmap copy and the native quad extraction, one eager
        ``refine_decode_fused_dense`` of two dummy frames and the copy of its
        outputs, with a board the assist decode that reuses its sharpened
        frames and maps, and with tracking one ``wave_advance``.

        It captures no CUDA graph, unlike the JAX package's warm-up, which
        compiles its executables ahead: a capture on this thread would make
        a device-wide ``torch.cuda.synchronize()`` on any other thread fail
        for as long as it lasts (CUDA forbids synchronizing a device while
        one of its streams captures), and callers render or upload frames
        and synchronize beside the warm-up (``bench_torch.py`` does).  The
        detecting thread captures each graph at its first use.

        Leaves ``stats``, ``debug``, ``on_provisional`` and the tracking
        carry as they were and draws from no random generator.  The
        threshold kernel's launch counts (``threshold_front_cuda.launches``
        and the library's) do go up, by ``prewarm_launches``: what the
        wrapper counted for this thread during the call (0 on the CPU,
        where the plain version runs).
        """
        from ..ops.threshold_cuda import thread_launches
        from ..pngio import _load as load_png_library

        dev = self.device
        launched = thread_launches()
        load_png_library()
        tracked = board is not None and self.track and self.refine
        if board is not None:
            self._mq = max(self._mq, _quad_rung(board.n_tags + 4))
        if tracked:
            R = 8
            if n_frames is not None and n_frames >= 4:
                starts = _anchor_starts(n_frames, max(self.cold_every, 4), 0)
                R = -(-2 * max(len(starts) - 1, 1) // 8) * 8
            self._wave_rows = max(R, self._wave_rows)
        scale = 2 if max(height, width) >= self.pyramid_min_side else 1
        # a light frame with dark squares: blobs for the quad extractor
        B, side = 2, max(8, min(height, width) // 8)
        frame = np.full((height, width), 200, np.uint8)
        ys = np.arange(side // 2, height - side, 2 * side)
        xs = np.arange(side // 2, width - side, 2 * side)
        for y in ys:
            for x in xs:
                frame[y : y + side, x : x + side] = 30
        part = _to_device(np.stack([frame] * B), dev)
        packed = _Fetch(threshold_front(part, scale)).get()
        self._extract_quads(packed, board, scale, height // scale, width // scale)
        self._prewarm_calls(part, xs, ys, side, board, tracked)
        if dev.type == "cuda":
            # this thread's stream, not the device: a device-wide
            # synchronize fails while another thread captures a graph
            torch.cuda.current_stream(dev).synchronize()
        self.prewarm_launches = thread_launches() - launched

    def _prewarm_calls(self, part, xs, ys, side, board, tracked) -> None:
        """``prewarm``'s eager device calls on the two dummy frames."""
        from .track import carry_to_device, init_wave_carry, wave_advance

        dev, B = part.device, part.shape[0]
        # the squares themselves as the quad buffer: every slot valid
        tl = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)
        n_quads = len(tl) if board is None else min(len(tl), board.n_tags + 4)
        offs = np.array([[0, 0], [side, 0], [side, side], [0, side]], np.float32)
        quads = np.broadcast_to(tl[:n_quads, None] + offs, (B, n_quads, 4, 2)).copy()
        out = refine_decode_fused_dense(
            self.family, part, _to_device(quads, dev),
            _to_device(np.ones((B, n_quads), bool), dev), do_refine=self.refine,
        )
        self._collect_results(_read_all(_fetch_all(out, _DECODE_KEYS)), B)
        if board is None:
            return
        n_assist = min(n_quads, board.n_tags)
        aout = refine_decode_fused_dense(
            self.family, part, _to_device(quads[:, :n_assist], dev),
            _to_device(np.ones((B, n_assist), bool), dev),
            do_refine=self.refine, sharp=out["sharp"], maps=out["maps"],
        )
        _read_all(_fetch_all(aout, _ASSIST_KEYS))
        if tracked:
            n = board.n_tags
            c = np.zeros((B, n, 4, 2), np.float32)
            c[:, : min(n, n_quads)] = quads[:, : min(n, n_quads)]
            v = np.zeros((B, n), bool)
            v[:, : min(n, n_quads)] = True
            carry = carry_to_device(init_wave_carry(c, v, c.copy(), v.copy()), dev)
            board_xy = torch.as_tensor(
                board.p3d.reshape(n, 4, 3)[:, :, :2].astype(np.float32), device=dev
            )
            _, outs = wave_advance(
                self.family, part, board_xy, board.config.first_id, carry,
                torch.ones(B, dtype=torch.bool, device=dev),
            )
            outs[1].cpu()

    # ----------------------------------------------------- shared helpers
    def _extract_quads(self, packed, board, scale, height, width):
        """The quad stage of a chunk: the (C, sHp, sWp/8) packed bitmaps of
        frames of (height, width) at ``scale`` through
        ``quads.extract_quad_stage``.  Returns (quads (C, max_quads, 4, 2)
        full-res px, counts, frames that ran the second erosion level)."""
        return extract_quad_stage(packed, height, width, scale,
                                  None if board is None else board.n_tags, self.max_quads)

    def _dispatch_decode(self, dev_chunk, quads, counts, slot: int = 0, board=None):
        """Upload the (n, K) quad buffer (``_to_device``), queue the dense
        refine+decode of the (C, H, W) chunk on its device and start the
        host copies of its outputs.  Returns (decode dict, ``_fetch_all``
        handles).

        The quad count grows the sticky ``_mq`` up the JAX ladder on every
        device.  With graphs the decode runs at ``_mq`` quads (capped by K)
        as instance ``slot`` of its graph, the C - n padding frames' rows
        empty (``_decode_graphs`` holds what it replays); eagerly at the
        chunk's largest count.  Padded quad slots are invalid (``qvalid``
        False)."""
        C = dev_chunk.shape[0]
        n_real = np.minimum(counts, quads.shape[1])
        need = int(n_real.max()) if n_real.size else 1
        self._mq = max(self._mq, _quad_rung(need))
        graphed = graphs.active(dev_chunk)
        Mq = min(self._mq, quads.shape[1]) if graphed else max(need, 1)
        if C > len(n_real):  # padding frames of the JAX plan: no quad
            n_real = np.concatenate([n_real, np.zeros(C - len(n_real), n_real.dtype)])
            quads = np.concatenate([quads, np.zeros((C - len(quads),) + quads.shape[1:],
                                                    quads.dtype)])
        dev = dev_chunk.device
        qq = _to_device(quads[:, :Mq].astype(np.float32), dev)
        qv = _to_device(np.arange(Mq)[None, :] < n_real[:, None], dev)
        if graphed:
            shape = (dev, tuple(dev_chunk.shape[1:]), dev_chunk.dtype)
            sizes = self._graph_sizes.setdefault(shape, set())
            sizes.add(C)
            for size in sorted(sizes) if dev.type == "cuda" else ():  # not the stand-ins
                self._decode_graphs(dev, ((size,) + shape[1], shape[2]), Mq, board)
            out = graphs.run(_decode_graph, (self.family, self.refine), (dev_chunk, qq, qv),
                             slot=slot, pool=("decode", slot))
        else:
            out = refine_decode_fused_dense(
                self.family, dev_chunk, qq, qv, do_refine=self.refine
            )
        return out, _fetch_all(out, _DECODE_KEYS)

    def _decode_graphs(self, dev, frame_spec, Mq: int, board) -> None:
        """Hold (capture if missing, ``graphs.ensure``) both instances of the
        decode graph for ``frame_spec`` ((C, H, W), dtype) frames and ``Mq``
        quads and, with a board, each one's assist decode at both rungs of
        the assist ladder.  ``_dispatch_decode`` holds them for every chunk
        size decoded so far at this frame shape, so a second run over the
        same frames, whose ``_mq`` starts where the first run's ended,
        captures nothing.  Instance s and its assists share the memory pool
        ("decode", s): chunk k's outputs are read before chunk k+2 replays
        any graph of its pool."""
        (C, _, _), _ = frame_spec
        args = (self.family, self.refine)
        f32, b8 = torch.float32, torch.bool
        for slot in (0, 1):
            pool = ("decode", slot)
            g = graphs.ensure(_decode_graph, args, dev,
                              (frame_spec, ((C, Mq, 4, 2), f32), ((C, Mq), b8)),
                              slot=slot, pool=pool)
            if board is None:
                continue
            for Ma in dict.fromkeys((min(_BUCKET, board.n_tags), board.n_tags)):
                graphs.ensure(_assist_graph, args, dev, (((C, Ma, 4, 2), f32), ((C, Ma), b8)),
                              bound=(g.outputs["sharp"], g.outputs["maps"]), slot=slot,
                              pool=pool)

    def _collect_results(self, host, nb) -> List[Dict[int, np.ndarray]]:
        """Build per-frame {tag_id: corners} from the host copies of the
        dense decode outputs (``_DECODE_KEYS``), keeping the lowest-hamming
        quad per (frame, tag) by a lexsort group-by."""
        C, Mq = host["valid"].shape
        tag_id = host["tag_id"].reshape(-1)
        hamming = host["hamming"].reshape(-1)
        valid = host["valid"].reshape(-1)
        corners = host["corners"].reshape(C * Mq, 4, 2)
        qf = np.repeat(np.arange(C, dtype=np.int32), Mq)

        results: List[Dict[int, np.ndarray]] = [dict() for _ in range(nb)]
        idx = np.flatnonzero(valid)
        if idx.size:
            fr = qf[idx]
            tid = tag_id[idx]
            ham = hamming[idx]
            order = np.lexsort((ham, tid, fr))
            fr, tid, qi = fr[order], tid[order], idx[order]
            first = np.ones(order.size, bool)
            first[1:] = (fr[1:] != fr[:-1]) | (tid[1:] != tid[:-1])
            for b, t, q in zip(fr[first], tid[first], qi[first]):
                if b < nb:
                    results[b][int(t)] = corners[q].copy()
        return results

    # ------------------------------------------------------------- batched
    def detect_batch(
        self, images, board=None, dev_images=None
    ) -> List[Dict[int, np.ndarray]]:
        """Detect tags in a batch of images.

        Args:
          images: (B, H, W) or (B, H, W, C) uint8/float array-like, put on
            ``self.device``.
          board: optional Board — enables the board-assisted recovery pass.
          dev_images: optional (B, H, W) uint8/float32 tensor already on
            its device (e.g. from ``testdata.render_frames_device``).

        Returns:
          list of {tag_id: (4, 2) float32 corners} per image, corner order
          TL, TR, BR, BL in the tag's canonical orientation (board corner
          ids tag*4 + {0,1,2,3}).
        """
        if dev_images is not None:
            dev_all = dev_images
        elif images is None:
            raise ValueError("need images or dev_images")
        else:
            raw = np.asarray(images)
            if not (raw.ndim == 3 and raw.dtype == np.uint8):
                raw = np.stack([_to_gray_f32(im) for im in raw])
            dev_all = torch.tensor(raw, device=self.device)
        dev_all = self._shard_frames(dev_all)
        if board is not None and self.track and self.refine and dev_all.shape[0] > 0:
            from .tracked import detect_batch_tracked

            return detect_batch_tracked(self, dev_all, board)
        return self._detect_batch_cold(dev_all, board)

    def _plan(self, B: int, chunk: int | None = None, device=None) -> list:
        """(first frame, frames, decoded frames) of each chunk
        ``_detect_batch_cold`` runs for B frames on ``device`` (default
        ``self.device``).  With
        graphs: the JAX accelerator plan (``chunk`` repeated if given, else
        ``self.chunk``-sized pieces and ``self.cold_chunk``-sized tail
        pieces), the last piece clipped to the frames that remain and its
        decode at the piece's full size.  Eagerly: ``chunk`` or
        ``self.chunk`` frames each, the last one short, or under
        ``CCRS_FORCE_CHUNK_PLAN`` the JAX plan clipped; each chunk decodes
        its own frames."""
        graphed = graphs.active(self.device if device is None else device)
        natural = not graphed and not os.environ.get("CCRS_FORCE_CHUNK_PLAN")
        sizes = _chunk_plan(B, self.chunk, self.cold_chunk, natural, chunk)
        spans = _chunk_spans(B, self.chunk, self.cold_chunk, natural, chunk)
        return [(lo, n, C if graphed else n) for (lo, n), C in zip(spans, sizes)]

    def _spans(self, B: int, chunk: int | None = None) -> list:
        """(first frame, frames) of each chunk of ``_plan``."""
        return [(lo, n) for lo, n, _ in self._plan(B, chunk)]

    def _detect_batch_cold(
        self, dev_all, board, chunk: int | None = None, idx=None
    ) -> List[Dict[int, np.ndarray]]:
        """The full detection pipeline over a (B, H, W) tensor: threshold ->
        bitmap copy -> native quad extraction -> refine+decode ->
        board-assist recovery, pipelined across the chunks of ``_plan``
        in the three phases of the module docstring.  A padding frame of
        the JAX plan (graphs) is decoded but neither thresholded nor
        reported.

        ``idx``: optional frame indices into ``dev_all`` to detect (the
        tracked path's anchors and audits); each chunk gathers its frames
        with ``index_select`` and results come back in ``idx`` order.

        A sharded batch (``parallel.mesh.FrameShards``) runs shard by shard:
        each shard's frames go through this pipeline on their own device."""
        if isinstance(dev_all, FrameShards):
            return dev_all.map_shards(
                lambda part, local: self._detect_batch_cold(part, board, chunk, idx=local),
                idx,
            )
        B, H, W = dev_all.shape
        if idx is not None:
            B = len(idx)
        if B == 0:
            return []
        dev = dev_all.device
        spans = self._plan(B, chunk, dev)
        # Large-image path: the pixel-proportional candidate stages run at
        # half resolution when the image is >= pyramid_min_side a side;
        # refinement and decode always sample the full-resolution frames
        scale = 2 if max(H, W) >= self.pyramid_min_side else 1
        sH, sW = H // scale, W // scale

        # Phase 0: queue every chunk's gather and threshold, each bitmap's
        # host copy right behind its own threshold.  A gathered chunk's
        # rows: its frames, then its last frame repeated up to C
        frames = np.arange(B) if idx is None else np.asarray(idx, np.int64)
        rows = [np.concatenate([frames[lo : lo + n], np.repeat(frames[lo + n - 1], C - n)])
                for lo, n, C in spans]
        if idx is not None or any(n < C for _, n, C in spans):
            sel = _to_device(np.concatenate(rows), dev)
        parts, bitmaps, off = [], [], 0
        for (lo, n, C), r in zip(spans, rows):
            if idx is None and n == C:
                part = dev_all[lo : lo + n].contiguous()
            else:
                part = dev_all.index_select(0, sel[off : off + C])
            off += C
            parts.append(part)
            bitmaps.append(_Fetch(threshold_front(part[:n], scale)))

        pending = [None] * len(spans)
        results: List[List[Dict[int, np.ndarray]]] = []
        assist_pending = []

        def phase1(ci):
            """Host quad extraction, then queue the refine+decode."""
            with stage("detect/threshold"):
                packed = bitmaps[ci].get()  # (n, sHp, sWp/8)
                bitmaps[ci] = None
            with stage("detect/quadproc"):
                quads, counts, level2 = self._extract_quads(packed, board, scale, sH, sW)
                count("detect/quad-frames", len(counts))
                count("detect/quad-level2", level2)
            with stage("detect/dispatch"):
                # two graph instances in turn: chunk ci's assist (phase 2,
                # queued after chunk ci+1's decode) reads its own maps
                pending[ci] = self._dispatch_decode(parts[ci], quads, counts, ci % 2, board)

        def phase2(ci):
            """Read the decode outputs, queue the assist decode; the chunk's
            frames, sharpened frames and maps go once it is queued."""
            out, fetches = pending[ci]
            pending[ci] = None
            _, n, C = spans[ci]
            with stage("detect/decode"):
                chunk_results = self._collect_results(_read_all(fetches), n)
            results.append(chunk_results)
            if board is not None:
                with stage("detect/assist"):
                    # padding frames have no detections, hence no candidates
                    aq, av, aexp = assist_candidates(board, chunk_results + [{}] * (C - n), W, H)
                    if aq is not None:
                        # reuse the primary pass's sharpened frames and maps
                        # (the returned dict holds them too: keep only the
                        # copies of its outputs)
                        aq, av = _to_device(aq, dev), _to_device(av, dev)
                        if graphs.active(dev):
                            aout = graphs.run(_assist_graph, (self.family, self.refine),
                                              (aq, av), bound=(out["sharp"], out["maps"]),
                                              slot=ci % 2, pool=("decode", ci % 2))
                        else:
                            aout = refine_decode_fused_dense(
                                self.family, parts[ci], aq, av, do_refine=self.refine,
                                sharp=out["sharp"], maps=out["maps"],
                            )
                        assist_pending.append((ci, aexp, _fetch_all(aout, _ASSIST_KEYS)))
            parts[ci] = None

        # Phases 1 and 2, phase 2 one chunk behind: the card decodes chunk
        # k+1 while the host reads and assists chunk k, and at most two
        # chunks' maps are alive
        for ci in range(len(spans)):
            phase1(ci)
            if ci:
                phase2(ci - 1)
        phase2(len(spans) - 1)

        # Phase 3: read and merge the assist results
        if assist_pending:
            with stage("detect/assist"):
                for ci, aexp, fetches in assist_pending:
                    assist_merge(self.family, aexp, _read_all(fetches), results[ci])
        return [r for chunk_results in results for r in chunk_results]

    # -------------------------------------------------------------- single
    def detect(self, image) -> Dict[int, np.ndarray]:
        """Single-image detection (reference-compatible convenience)."""
        return self.detect_batch(np.asarray(image)[None])[0]
