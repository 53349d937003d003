"""The system under test: ccrs_tpu_torch's calibration of one recording.

A job is what ``python -m ccrs_tpu_torch`` does after its loader, minus
artifacts: per camera a streaming ``TrackedSession`` fed from pinned host
memory in the loader's chunks with a ``SpeculativeCalib`` on its
provisional detections ("video"), or the detections of a cache ("cached");
then per camera ``calibrate_camera_with_retries`` (warm-started by the
speculation where there is one), and for a rig ``init_camera_extrinsic``
and ``calib_all_camera_with_extrinsics``.  Cameras are detected first and
calibrated after, in the CLI's order.  This is the only module of the
benchmark that imports the program.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ccrs_tpu_torch import graphs
from ccrs_tpu_torch.board import Board, BoardConfig
from ccrs_tpu_torch.calib.frames import FrameBatch
from ccrs_tpu_torch.calib.multi import calib_all_camera_with_extrinsics, init_camera_extrinsic
from ccrs_tpu_torch.calib.pipeline import SpeculativeCalib, calibrate_camera_with_retries
from ccrs_tpu_torch.calib.prewarm import prewarm_calibration
from ccrs_tpu_torch.cli import camera_generators
from ccrs_tpu_torch.detect import TagDetector
from ccrs_tpu_torch.models import zeros_like_model
from ccrs_tpu_torch.types import CalibParams

#: the seed of the calibration's random draws in every job: the CLI's
#: default ``--seed``, so that every job of a recording does the same work
SEED = 0


class Jobs:
    def __init__(self, config: dict, traffic: dict, device):
        b = config["board"]
        self.board = Board(BoardConfig(b["tag_size_meter"], b["tag_spacing"], b["tag_rows"],
                                       b["tag_cols"], b.get("first_id", 0)))
        self.cams = config["cameras"]
        self.model = config["target_model"]
        self.F = int(config["frames_per_recording"])
        self.times = [10_000_000_000 + f * 50_000_000 for f in range(self.F)]  # 20 Hz
        self.video = traffic["mode"] == "video"
        self.chunk = int(traffic.get("chunk", 0))
        self.device = torch.device(device)
        self.detector = TagDetector(b["family"], device=self.device) if self.video else None
        self.recordings = []
        self.spans: dict = {}

    def prewarm_calls(self) -> list:
        """The one-time costs, as zero-argument calls for threads beside the render."""
        W, H = self.cams[0]["width"], self.cams[0]["height"]
        calls = [lambda: prewarm_calibration(
            self.board, self.F, self.model, CalibParams(), W, H,
            speculative=self.video, n_frames_spec=self.F, device=self.device)]
        if self.video:
            # the CLI's warm-up frame count: the session's padded sequence
            n = -(-self.F // self.chunk) * self.chunk if self.F > self.chunk else self.F
            calls.append(lambda: self.detector.prewarm(H, W, self.board, n_frames=n))
        return calls

    def use(self, recordings: list) -> None:
        """Hand over the inputs; cached detections become the loader's FrameBatch."""
        self.recordings = recordings
        if not self.video:
            for rec in recordings:
                rec.batches = [
                    FrameBatch(np.asarray(self.times, np.int64), rec.p2d[c], rec.mask[c],
                               cam["width"], cam["height"]) for c, cam in enumerate(self.cams)]

    def _span(self, name: str, t0: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def _detect(self, rec, c: int, gen):
        cam = self.cams[c]
        det = self.detector
        det.reset_tracking()
        spec = SpeculativeCalib(self.board, self.times, zeros_like_model(self.model),
                                CalibParams(), gen, cam["width"], cam["height"])
        det.on_provisional = spec.on_provisional
        t0 = time.perf_counter()
        try:
            session = det.begin_tracked(self.board, n_frames=self.F)
            for chunk in rec.chunks[c]:
                session.feed(chunk.to(self.device, non_blocking=True))
            dets = session.finalize()
        finally:
            det.on_provisional = None
        self._span("detect", t0)
        batch = FrameBatch.from_detections(dets, self.times, self.board, cam["width"],
                                           cam["height"])
        return dets, batch, spec

    def run(self, k: int) -> dict:
        """Job k: recording k mod R.  Returns what the reference judges."""
        rec = self.recordings[k % len(self.recordings)]
        C = len(self.cams)
        self.spans = {}
        gens = camera_generators(SEED, C, self.device)
        dets, batches, specs = [None] * C, [None] * C, [None] * C
        for c in range(C):
            if self.video:
                dets[c], batches[c], specs[c] = self._detect(rec, c, gens[c])
            else:
                batches[c] = rec.batches[c]
        models, rtvecs = [], []
        for c in range(C):
            t0 = time.perf_counter()
            model, rt = calibrate_camera_with_retries(
                self.board, batches[c], zeros_like_model(self.model), CalibParams(), gens[c],
                seed=SEED + c,
                warm_provider=specs[c].take if specs[c] is not None else None,
                device=self.device)
            self._span("calibrate", t0)
            models.append(model)
            rtvecs.append(rt)
        joint = None
        if C > 1:
            t0 = time.perf_counter()
            t_i_0 = init_camera_extrinsic(rtvecs, device=self.device)
            out = calib_all_camera_with_extrinsics(
                self.board, models, t_i_0, rtvecs, batches, xy_same_focal=False,
                disabled_distortions=0, cam0_fixed_focal=False, device=self.device)
            self._span("joint_ba", t0)
            if out is not None:
                intr, t_out, board_rt = out
                joint = {"theta": np.stack([m.params for m in intr]),
                         "ext": np.stack([_pose(t) for t in t_out]),
                         "poses": {f: _pose(r) for f, r in board_rt.items()}}
        if self.device.type == "cuda":
            graphs.synchronize(self.device)
        return {"recording": k % len(self.recordings), "dets": dets,
                "theta": np.stack([m.params for m in models]),
                "poses": [{f: _pose(r) for f, r in rt.items()} for rt in rtvecs],
                "joint": joint, "spans": dict(self.spans)}


def _pose(rt) -> np.ndarray:
    return np.concatenate([rt.rvec, rt.tvec])
