"""Detection judged against the geometry the frames were rendered from.

A rendered tag's corners lie exactly at the projection of the board's
corners through the camera (``gen.render``).  A detected tag is wrong when
its id is not on the board or most of its corners lie more than
``WRONG_PX`` from where that id's corners were drawn (a misread id lands
a tag pitch away); the corners of the others, a stray one included, give
the corner errors.  A tag counts as shown when its four
corners project at least ``MARGIN_PX`` inside the frame and each of its
sides is at least ``MIN_SIDE_PX`` long: the detector's recall is stated
for such tags (far and edge-on tags of under 24 px a side it may miss).
"""

from __future__ import annotations

import numpy as np
import torch

from gen import camera
from gen.board import Board

WRONG_PX = 8.0
MARGIN_PX = 4.0
MIN_SIDE_PX = 24.0


def true_corners(params, width: int, height: int, board: Board, poses, dtype=torch.float64):
    """(F, n_tags, 4, 2) corner positions and (F, n_tags) shown mask, in ``dtype``."""
    p = torch.as_tensor(np.asarray(params, np.float64)).to(dtype)
    T = torch.as_tensor(np.asarray(poses, np.float64)).to(dtype)
    pts = camera.transform(T[:, :3], T[:, 3:], torch.as_tensor(board.p3d()).to(dtype))
    pr, valid = camera.project(p, pts)
    pr = pr.double().numpy().reshape(len(poses), board.n_tags, 4, 2)
    ok = (valid.numpy().reshape(len(poses), board.n_tags, 4)
          & (pr[..., 0] >= MARGIN_PX) & (pr[..., 0] <= width - 1 - MARGIN_PX)
          & (pr[..., 1] >= MARGIN_PX) & (pr[..., 1] <= height - 1 - MARGIN_PX))
    sides = np.linalg.norm(pr - np.roll(pr, 1, axis=-2), axis=-1)
    return pr, ok.all(-1) & (sides >= MIN_SIDE_PX).all(-1)


def judge(detections, truth, shown, board: Board) -> dict:
    """``detections``: per frame {tag_id: (4, 2) corners}.  Returns counts:
    ``wrong`` tags, ``found`` of ``shown`` tags, ``errors``, the corner
    errors (px) of the tags that are right, and ``bias``, the length of
    their mean error vector (px)."""
    wrong = found = 0
    errors, offsets = [], []
    for f, det in enumerate(detections):
        for tag, corners in det.items():
            i = int(tag) - board.first_id
            if not 0 <= i < board.n_tags:
                wrong += 1
                continue
            off = np.asarray(corners, np.float64) - truth[f, i]
            err = np.linalg.norm(off, axis=-1)
            if np.median(err) > WRONG_PX:
                wrong += 1
                continue
            errors.append(err)
            offsets.append(off)
            found += bool(shown[f, i])
    bias = float(np.linalg.norm(np.concatenate(offsets).mean(0))) if offsets else 0.0
    return {"wrong": wrong, "found": found, "shown": int(shown.sum()),
            "errors": np.concatenate(errors) if errors else np.zeros(0), "bias": bias}
