"""Dataset loaders: EuRoC and general folder layouts.

Port of ``ccrs_tpu/dataloader.py`` (``load_euroc`` / ``load_others``,
``src/data_loader.rs:95-214``): images decode on host worker threads and
upload to the detector's device in chunks of ``DETECT_BATCH`` frames.
With tracking on (the detector's default) every chunk is fed to one
``TrackedSession`` per camera, which runs the whole-sequence tracked
detection once at ``finalize``; with tracking off each chunk is detected
by ``TagDetector.detect_batch`` while the next images decode.  Frame order,
timestamp conventions (filename ns for EuRoC, idx * 1e8 for general),
start/step subsampling, the MIN_CORNERS filter and the detection cache
(key and ``.npz`` format) match the JAX package, so a cache written by
either package loads in the other.

``.png`` files decode through :mod:`ccrs_tpu_torch.pngio` on every machine
(every layout of the format: 1- to 16-bit gray, colour, palette, Adam7);
``.jpg`` files through ``cv2``, ``imageio`` or ``PIL``, whichever imports.
Every decoded file becomes one gray plane of the file's own sample type
on the host, as the JAX package's ``cv2.imread`` + ``cvtColor`` makes it:
8-bit gray, colour and palette files load as uint8 (colour through
``_gray_like_cv2``, the integer luma of ``cv2.COLOR_BGR2GRAY``, alpha
dropped) and take the threshold kernel's uint8 path; 16-bit gray and
colour files load as uint16 and upload as float32 on the 0..255 scale.
Chunks upload to a CUDA detector from pinned memory without blocking the
host.  Eager torch needs no fixed chunk shape, so a short tail chunk keeps
its natural size.  ``spec_factory`` registers a per-camera provisional
hook on the detector (the CLI's speculative calibration).
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import hashlib
import logging
import os
import threading
import time
from typing import List

import numpy as np
import torch

from .board import Board
from .calib.frames import MIN_CORNERS, FrameBatch
from .detect import TagDetector
from .detect.detector import _to_gray_f32
from .pngio import read_png
from .utils.profiling import stage

log = logging.getLogger(__name__)

#: frames per upload/detect chunk; ``CCRS_DETECT_BATCH`` overrides the JAX
#: package's default of 192, read at import as there
DETECT_BATCH = int(os.environ.get("CCRS_DETECT_BATCH", "192"))
_EXTS = (".png", ".jpg")


def _gray_like_cv2(img: np.ndarray) -> np.ndarray:
    """One gray plane of ``img``'s own dtype from a decoded uint8 or uint16
    file, equal to ``cv2.cvtColor(..., COLOR_BGR2GRAY)`` of what
    ``cv2.imread(IMREAD_UNCHANGED)`` returns for it: (H, W) as is; gray +
    alpha is its gray; RGB and RGBA (channels in RGB order, alpha dropped)
    are ``(9798 R + 19235 G + 3735 B + 16384) >> 15``, cv2's 15-bit
    fixed-point BT.601 luma for both sample widths."""
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:
        return np.ascontiguousarray(img[..., 0])
    r, g, b = (img[..., c].astype(np.uint32) for c in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).astype(img.dtype)


def _imread_jpg(path: str) -> np.ndarray:
    """A ``.jpg`` as one uint8 gray plane, through whichever of cv2,
    imageio and PIL imports; each gives the same gray for a colour file
    when it decodes the same RGB."""
    try:
        import cv2
    except ImportError:
        pass
    else:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"{path}: cv2 could not decode the file")
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img
    try:
        import imageio.v3 as iio
    except ImportError:
        pass
    else:
        return _gray_like_cv2(iio.imread(path))
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"{path}: reading .jpg needs cv2 (opencv-python), imageio or PIL "
            "(pillow), and none of them is installed; .png files need none"
        ) from None
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB"):  # CMYK, YCbCr: as cv2 decodes them
            im = im.convert("RGB")
        return _gray_like_cv2(np.asarray(im))


def _imread(path: str) -> np.ndarray:
    if path.endswith(".png"):
        return _gray_like_cv2(read_png(path))
    return _imread_jpg(path)


def _list_images(pattern: str, start_idx: int, step: int) -> List[str]:
    paths = sorted(p for p in glob.glob(pattern, recursive=True) if p.endswith(_EXTS))
    return paths[start_idx::step]


def _path_timestamp(path: str) -> int:
    """Filename (sans extension) as nanoseconds; 0 if unparsable
    (``src/data_loader.rs:20-29``)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        return int(stem)
    except ValueError:
        return 0


def _upload(chunk: List[np.ndarray], device: torch.device) -> torch.Tensor:
    """Stack a chunk of ``_imread`` gray planes into a (B, H, W) tensor on
    ``device``: uint8 as is, uint16 as float32 on the 0..255 scale
    (``_to_gray_f32``: sample / 257)."""
    raw = np.stack(chunk)
    if not (raw.ndim == 3 and raw.dtype == np.uint8):
        raw = np.stack([_to_gray_f32(im) for im in raw])
    host = torch.from_numpy(raw)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _detect_sequence(
    paths: List[str],
    times_ns: List[int],
    detector: TagDetector,
    board: Board,
    recorder=None,
    cam_idx: int = 0,
    prewarm_cb=None,
    spec_factory=None,
) -> FrameBatch:
    """Decode + detect a whole sequence, overlapping host decoding with
    uploads and detection; returns a timestamp-sorted FrameBatch.

    ``prewarm_cb(width, height, n_frames)``, when given, runs ONCE on a
    daemon thread as soon as the first image reveals the frame size: the
    CLI uses it to pay the process's one-time costs (library loads, the
    first launches, the first ``torch.func`` solve) while images decode.

    ``spec_factory(cam_idx, times_ns_sorted, width, height)``, when given,
    is called once, when the first image reveals the frame size, and
    returns an ``on_provisional`` hook (or None) for the detector; the
    hook is removed when the camera's detection ends.
    """
    if not paths:
        return FrameBatch(
            np.zeros(0, np.int64), np.zeros((0, board.n_corners, 2)),
            np.zeros((0, board.n_corners), bool), 0, 0,
        )
    order = np.argsort(np.asarray(times_ns, dtype=np.int64), kind="stable")
    paths = [paths[i] for i in order]
    times_ns = [times_ns[i] for i in order]
    # each camera is an independent video: don't track across the boundary
    detector.reset_tracking()
    session = detector.begin_tracked(board, n_frames=len(paths))
    # Rerun logging keeps every frame's pixels until detection ends: only
    # when the recorder records
    if recorder is not None and not getattr(recorder, "active", True):
        recorder = None

    detections: list = []
    rec_imgs: list = []
    width = height = None
    pending: list = []  # uploaded chunks waiting for detection

    def detect_one():
        dev = pending.pop(0)
        if session is not None:
            session.feed(dev)
            return
        with stage(f"cam{cam_idx}/detect"):
            detections.extend(detector.detect_batch(None, board=board, dev_images=dev))

    try:
        with cf.ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as pool:
            futures = [pool.submit(_imread, p) for p in paths]
            chunk: list = []
            for i, fut in enumerate(futures):
                with stage(f"cam{cam_idx}/decode+upload"):
                    img = fut.result()
                    if width is None:
                        height, width = img.shape[:2]
                        if spec_factory is not None:
                            detector.on_provisional = spec_factory(
                                cam_idx, list(times_ns), width, height
                            )
                        if prewarm_cb is not None:
                            threading.Thread(
                                target=prewarm_cb, args=(width, height, len(paths)),
                                name="ccrs-prewarm", daemon=True,
                            ).start()
                    chunk.append(img)
                    if recorder is not None:
                        rec_imgs.append(img)
                    last = i == len(futures) - 1
                    if len(chunk) >= DETECT_BATCH or last:
                        # enqueue this chunk's upload, then hand the previous
                        # one on while the next images decode
                        pending.append(_upload(chunk, detector.device))
                        chunk = []
                while len(pending) > 1 or (last and pending):
                    detect_one()
        if session is not None:
            with stage(f"cam{cam_idx}/detect"):
                detections = session.finalize()
    finally:
        if spec_factory is not None:
            detector.on_provisional = None
    if recorder is not None:
        for t_ns, img, det in zip(times_ns, rec_imgs, detections):
            recorder.log_camera_image(cam_idx, t_ns, img, det)
    return FrameBatch.from_detections(
        detections, times_ns, board, width, height, MIN_CORNERS
    )


def _cache_path(cache_dir, cam_idx, paths, detector, board):
    """Detection-cache key: file list+mtimes+detector family+board shape
    (the JAX package's key, so either package's cache loads in the other)."""
    h = hashlib.sha1()
    for p in paths:
        try:
            h.update(f"{p}:{os.path.getmtime(p)};".encode())
        except OSError:
            h.update(f"{p}:?;".encode())
    h.update(f"{detector.family.name}:{board.n_corners}:{board.first_corner_id}".encode())
    return os.path.join(cache_dir, f"cam{cam_idx}_{h.hexdigest()[:16]}.npz")


def _detect_or_load(paths, times, detector, board, recorder, cam_idx, cache_dir,
                    prewarm_cb=None, spec_factory=None):
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cpath = _cache_path(cache_dir, cam_idx, paths, detector, board)
        if os.path.exists(cpath):
            log.info("cam%d: loading cached detections from %s", cam_idx, cpath)
            return FrameBatch.load(cpath)
    batch = _detect_sequence(
        paths, times, detector, board, recorder, cam_idx, prewarm_cb, spec_factory
    )
    if cache_dir:
        batch.save(cpath)
    return batch


def load_euroc(
    root: str,
    detector: TagDetector,
    board: Board,
    start_idx: int = 0,
    step: int = 1,
    cam_num: int = 1,
    recorder=None,
    cache_dir: str = None,
    prewarm_cb=None,
    spec_factory=None,
) -> List[FrameBatch]:
    """EuRoC layout: {root}/mav0/cam{i}/data/* (``src/data_loader.rs:95``).
    ``prewarm_cb``: see ``_detect_sequence``; started for camera 0 only."""
    out = []
    for cam_idx in range(cam_num):
        t0 = time.perf_counter()
        paths = _list_images(
            os.path.join(root, "mav0", f"cam{cam_idx}", "data", "*"), start_idx, step
        )
        times = [_path_timestamp(p) for p in paths]
        batch = _detect_or_load(
            paths, times, detector, board, recorder, cam_idx, cache_dir,
            prewarm_cb if cam_idx == 0 else None, spec_factory,
        )
        log.info(
            "cam%d: %d images, %d usable frames, %.3fs",
            cam_idx, len(paths), int(batch.frame_ok().sum()), time.perf_counter() - t0,
        )
        out.append(batch)
    return out


def load_general(
    root: str,
    detector: TagDetector,
    board: Board,
    start_idx: int = 0,
    step: int = 1,
    cam_num: int = 1,
    recorder=None,
    cache_dir: str = None,
    prewarm_cb=None,
    spec_factory=None,
) -> List[FrameBatch]:
    """General layout: {root}/**/cam{i}/**/* with synthetic timestamps
    idx * 1e8 ns (``src/data_loader.rs:160-214``).  ``prewarm_cb``: see
    ``_detect_sequence``; started for camera 0 only."""
    out = []
    for cam_idx in range(cam_num):
        paths = _list_images(
            os.path.join(root, "**", f"cam{cam_idx}", "**", "*"), start_idx, step
        )
        times = [i * 100_000_000 for i in range(len(paths))]
        out.append(
            _detect_or_load(
                paths, times, detector, board, recorder, cam_idx, cache_dir,
                prewarm_cb if cam_idx == 0 else None, spec_factory,
            )
        )
    return out
