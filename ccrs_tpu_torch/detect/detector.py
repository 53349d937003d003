"""TagDetector: the public detection API.

Port of ``ccrs_tpu/detect/detector.py``.  The cold pipeline runs a frame
batch chunk by chunk:

  device: threshold front-end (the CUDA kernel on a CUDA tensor)
      ->  host: bitmap download, native C++ quad extraction
      ->  device: refine + unsharp + decode, then the board-assisted
          recovery decode of the tags the first pass missed.

Chunks take their natural size (the JAX package's CPU chunk plan); the
decode buffer is sized to the chunk's largest quad count.  With a board,
``detect_batch`` takes the wave-tracking video fast path by default
(detect/tracked.py; ``track=False`` or ``CCRS_TRACK=0`` turns it off),
whose anchors and audits run the cold pipeline on chosen frames.
``detect`` on a single image wraps the batch path.

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
from .assist import assist_candidates, assist_merge
from .decode import refine_decode_fused_dense
from .families import TagFamily, get_family
from .quads import MAX_QUADS, extract_quads_batch
from .threshold import TILE, threshold_front

#: frames per pipeline chunk
CHUNK = 64
#: images at least this wide or tall run candidate extraction on a
#: half-resolution pyramid level (tags there are big enough to lose nothing)
PYRAMID_MIN_SIDE = 768


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


def _dilate_white_host(binary: np.ndarray) -> np.ndarray:
    """3x3 white dilation (= one more black erosion) of a (B, H, W) {0,1}
    uint8 batch on the host — reduce_window(OR, 3x3, SAME) with False
    padding, computed from the already-downloaded level-1 bitmap."""
    out = binary.copy()
    out[:, 1:, :] |= binary[:, :-1, :]
    out[:, :-1, :] |= binary[:, 1:, :]
    col = out.copy()
    out[:, :, 1:] |= col[:, :, :-1]
    out[:, :, :-1] |= col[:, :, 1:]
    return out


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


def _expand_quads(quads, px):
    """Push each corner of (B, K, 4, 2) quads away from its quad center
    by ``px`` (erosion-bias pre-compensation of the scale-2 path)."""
    cen = quads.mean(axis=2, keepdims=True)
    d = quads - cen
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    return quads + d / np.maximum(n, 1e-6) * px


def _dedup_levels(q1, c1, q2, c2, max_quads):
    """Merge the two erosion levels' quads, dropping level-2 quads whose
    center falls within 0.7x an existing level-1 quad's mean radius
    (duplicates of the same tag blob), vectorized over the batch."""
    half = q1.shape[1]
    k = np.arange(half)[None, :]
    m1 = k < c1[:, None]  # (C, half) level-1 validity
    m2 = k < c2[:, None]
    cen1 = q1.mean(axis=2)  # (C, half, 2)
    rad1 = np.linalg.norm(q1 - cen1[:, :, None, :], axis=-1).mean(axis=2)
    cen2 = q2.mean(axis=2)
    d = np.linalg.norm(cen1[:, None, :, :] - cen2[:, :, None, :], axis=-1)
    dup = (d < 0.7 * rad1[:, None, :]) & m1[:, None, :]
    keep2 = m2 & ~dup.any(axis=2)
    # level-1 rows first, then surviving level-2 rows: a stable argsort on
    # ~valid compacts each frame's winners to the front
    quads_all = np.concatenate([q1, q2], axis=1)  # (C, 2*half, 4, 2)
    valid_all = np.concatenate([m1, keep2], axis=1)
    order = np.argsort(~valid_all, axis=1, kind="stable")
    quads_sorted = np.take_along_axis(quads_all, order[:, :, None, None], axis=1)
    counts = np.minimum(valid_all.sum(axis=1), max_quads).astype(np.int32)
    quads = np.zeros((q1.shape[0], max_quads, 4, 2), np.float32)
    m = min(max_quads, 2 * half)
    quads[:, :m] = quads_sorted[:, :m]
    return quads, counts


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

    Tracking knobs (environment, as in the JAX package): the anchor
    cadence ``cold_every`` (``CCRS_TRACK_COLD_EVERY``, 40 frames) and the
    sparse-board threshold ``sparse_frac`` (``CCRS_TRACK_SPARSE_FRAC``,
    0.30) below which a segment is cold-detected instead of tracked.
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
        device operation the pipeline uses (each loads its kernel once per
        process).  Meant for a background thread while the host decodes
        images; safe to skip.

        Runs, on ``self.device``: one pinned upload, one ``threshold_front``
        launch at the scale this frame size takes, the bitmap download and
        the native quad extraction, one ``refine_decode_fused_dense`` and
        its result download, with a board the assist decode that reuses
        the first pass's sharpened frames and maps, and with tracking one
        ``wave_advance``.  The dummy batch is two frames of a fixed
        pattern: eager torch builds no graph per shape, so the cost does
        not depend on the batch size and ``n_frames`` (kept for the JAX
        signature) sizes nothing.

        Leaves ``stats``, ``debug``, ``on_provisional`` and the tracking
        carry as they were and draws from no random generator.  The
        threshold kernel's launch counts (``threshold_front_cuda.launches``
        and the library's) do go up, by ``prewarm_launches``: what the
        wrapper counted for this thread during the call (0 on the CPU,
        where the plain version runs).
        """
        from ..ops.threshold_cuda import thread_launches
        from ..pngio import _load as load_png_library
        from .track import carry_to_device, init_wave_carry, wave_advance

        del n_frames
        dev = self.device
        launched = thread_launches()
        load_png_library()
        scale = 2 if max(height, width) >= PYRAMID_MIN_SIDE else 1
        # a light frame with dark squares: blobs for the quad extractor
        B, side = 2, max(8, min(height, width) // 8)
        frame = np.full((height, width), 200, np.uint8)
        ys = np.arange(side // 2, height - side, 2 * side)
        xs = np.arange(side // 2, width - side, 2 * side)
        for y in ys:
            for x in xs:
                frame[y : y + side, x : x + side] = 30
        host = torch.from_numpy(np.stack([frame] * B))
        if dev.type == "cuda":
            part = host.pin_memory().to(dev, non_blocking=True)
        else:
            part = host.to(dev)
        sH, sW = height // scale, width // scale
        wmul = TILE * 8 // np.gcd(TILE, 8)
        packed = threshold_front(part, scale).cpu().numpy()
        b1 = np.unpackbits(packed, axis=-1, count=sW + ((-sW) % wmul))[:, :sH, :sW]
        self._extract_quads(b1, board, scale)
        # the squares themselves as the quad buffer: every slot valid
        tl = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)
        n_quads = len(tl) if board is None else min(len(tl), board.n_tags + 4)
        offs = np.array([[0, 0], [side, 0], [side, side], [0, side]], np.float32)
        quads = np.broadcast_to(tl[:n_quads, None] + offs, (B, n_quads, 4, 2)).copy()
        counts = np.full(B, n_quads, np.int32)
        out = self._dispatch_decode(part, quads, counts)
        self._collect_results(out, B)
        if board is not None:
            n_assist = min(n_quads, board.n_tags)
            aout = refine_decode_fused_dense(
                self.family, part,
                torch.as_tensor(quads[:, :n_assist], device=dev),
                torch.ones((B, n_assist), dtype=torch.bool, device=dev),
                do_refine=self.refine, sharp=out["sharp"], maps=out["maps"],
            )
            aout["valid"].cpu()
            if self.track and self.refine:
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
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.prewarm_launches = thread_launches() - launched

    # ----------------------------------------------------- shared helpers
    def _extract_quads(self, b1, board, scale):
        """Native quad extraction over a (C, sH, sW) binary batch: both
        erosion levels, the level-2 need heuristic, scale compensation and
        dedup.  Returns (quads (C, max_quads, 4, 2) full-res px, counts)."""
        half = self.max_quads // 2
        q1, c1 = extract_quads_batch(b1, max_quads=half)
        # Level 2 splits tags that the first erosion left bridged into
        # crosses, a large-tag phenomenon.  A frame skips it only when
        # level 1 already yielded >= n_tags candidates AND every candidate
        # is small-tag sized (clutter inflates the count alone).
        q2 = np.zeros_like(q1)
        c2 = np.zeros_like(c1)
        if board is None:
            need = np.arange(b1.shape[0])
        else:
            big_area = (100.0 / scale) ** 2  # ~100 px tag side
            need_l = []
            for b in range(b1.shape[0]):
                n1 = int(c1[b])
                if n1 < board.n_tags:
                    need_l.append(b)
                    continue
                x = q1[b, :n1, :, 0]
                y = q1[b, :n1, :, 1]
                a2 = np.einsum(
                    "qn,qn->q", x, np.roll(y, -1, 1)
                ) - np.einsum("qn,qn->q", np.roll(x, -1, 1), y)
                if 0.5 * np.abs(a2).max() >= big_area:
                    need_l.append(b)
            need = np.asarray(need_l, np.int64)
        if need.size:
            q2n, c2n = extract_quads_batch(
                _dilate_white_host(b1[need]), max_quads=half
            )
            q2[need] = q2n
            c2[need] = c2n
        if scale == 2:
            # erosion + pooling bias corners ~4.5 px inward at pyramid
            # resolution (~2 px more for level 2): pre-expand along the
            # outward diagonal so the subpixel refinement starts inside
            # its capture radius
            q1 = _expand_quads(q1, 1.5)
            q2 = _expand_quads(q2, 2.75)
        quads, counts = _dedup_levels(q1, c1, q2, c2, self.max_quads)
        if scale == 2:
            # pyramid pixel (r, c) covers full-res [2r, 2r+1] x [2c, 2c+1];
            # its center sits at 2x + 0.5
            quads = quads * 2.0 + 0.5
        return quads, counts

    def _dispatch_decode(self, dev_chunk, quads, counts):
        """Truncate the (C, K) quad buffer to the chunk's largest count and
        run the dense refine+decode on the chunk's device."""
        n_real = np.minimum(counts, quads.shape[1])
        Mq = max(int(n_real.max()) if n_real.size else 1, 1)
        dev = dev_chunk.device
        qq = torch.as_tensor(
            np.ascontiguousarray(quads[:, :Mq], np.float32), device=dev
        )
        qv = torch.as_tensor(np.arange(Mq)[None, :] < n_real[:, None], device=dev)
        return refine_decode_fused_dense(
            self.family, dev_chunk, qq, qv, do_refine=self.refine
        )

    def _collect_results(self, out, nb) -> List[Dict[int, np.ndarray]]:
        """Build per-frame {tag_id: corners} from dense decode outputs,
        keeping the lowest-hamming quad per (frame, tag) by a lexsort
        group-by."""
        tag_id = out["tag_id"].cpu().numpy().reshape(-1)
        hamming = out["hamming"].cpu().numpy().reshape(-1)
        valid = out["valid"].cpu().numpy().reshape(-1)
        C, Mq = out["valid"].shape
        corners = out["corners"].cpu().numpy().reshape(C * Mq, 4, 2)
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

    def _detect_batch_cold(self, dev_all, board, idx=None) -> List[Dict[int, np.ndarray]]:
        """The full detection pipeline over a (B, H, W) tensor, chunk by
        chunk: threshold -> bitmap download -> native quad extraction ->
        refine+decode -> board-assist recovery.

        ``idx``: optional frame indices into ``dev_all`` to detect (the
        tracked path's anchors and audits); each chunk gathers its frames
        with ``index_select`` and results come back in ``idx`` order.

        A sharded batch (``parallel.mesh.FrameShards``) runs shard by shard:
        each shard's frames go through this pipeline on their own device."""
        if isinstance(dev_all, FrameShards):
            return dev_all.map_shards(
                lambda part, local: self._detect_batch_cold(part, board, idx=local), idx
            )
        B, H, W = dev_all.shape
        if idx is not None:
            sel = torch.as_tensor(np.asarray(idx, np.int64), device=dev_all.device)
            B = int(sel.shape[0])
        # Large-image path: the pixel-proportional candidate stages run at
        # half resolution when the image is >= pyramid_min_side a side;
        # refinement and decode always sample the full-resolution frames
        scale = 2 if max(H, W) >= PYRAMID_MIN_SIDE else 1
        sH, sW = H // scale, W // scale
        wmul = TILE * 8 // np.gcd(TILE, 8)
        pw = sW + ((-sW) % wmul)  # packed width after white padding

        results: List[Dict[int, np.ndarray]] = []
        for lo in range(0, B, CHUNK):
            if idx is None:
                part = dev_all[lo : lo + CHUNK].contiguous()
            else:
                part = dev_all.index_select(0, sel[lo : lo + CHUNK])
            packed = threshold_front(part, scale).cpu().numpy()
            b1 = np.unpackbits(packed, axis=-1, count=pw)[:, :sH, :sW]
            quads, counts = self._extract_quads(b1, board, scale)
            out = self._dispatch_decode(part, quads, counts)
            chunk_results = self._collect_results(out, part.shape[0])
            if board is not None:
                aq, av, aexp = assist_candidates(board, chunk_results, W, H)
                if aq is not None:
                    dev = part.device
                    # reuse the primary pass's sharpened frames and maps
                    aout = refine_decode_fused_dense(
                        self.family, part, torch.as_tensor(aq, device=dev),
                        torch.as_tensor(av, device=dev), do_refine=self.refine,
                        sharp=out["sharp"], maps=out["maps"],
                    )
                    assist_merge(self.family, aexp, aout, chunk_results)
            results.extend(chunk_results)
        return results

    # -------------------------------------------------------------- single
    def detect(self, image) -> Dict[int, np.ndarray]:
        """Single-image detection (reference-compatible convenience)."""
        return self.detect_batch(np.asarray(image)[None])[0]
