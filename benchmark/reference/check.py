"""What decides ``correct``: the window's answers against the reference.

Detection (video): every tag of every frame of every job against the
rendering's geometry (``detection.py``): ``wrong_tags``, the largest
``missed_share`` of the tags shown in a job's recording, the largest
``corner_bias_px`` (the length of a job's mean corner error vector, per
camera) and the 99th percentile of the corner errors over all jobs,
``corner_err_p99_px``.  Calibration: per camera the intrinsics of
``calibrate_camera_with_retries`` against the reference bundle adjustment
of the same observations (``intr_gap``, the largest relative difference
of a parameter) and its focal lengths against the camera's (``focal_err``,
relative).  For a rig, the joint solve: its reprojection RMS against the
reference's optimum (``rms_gap_px``), its extrinsic against the rig the
frames were made with (``ext_err``, the largest component, rad or m) and
its focal lengths against the camera's (``joint_focal_err``, relative):
the joint solver stops by rules that leave its parameters up to 1e-5
(relative) off the optimum along flat directions, so its parameters are
held to what the calibration states, not to the reference's digits.

The observations are the program's detections turned into corner arrays
by this module (a frame counts with at least ``min_corners`` corners) or
the cached detections the cell drew.  Each distinct set of observations
gets its own reference, so jobs that detected the same corners share it.
Where a recording gave more than ``MAX_SETS`` distinct sets, a sample of
``MAX_SETS`` of them drawn from the run's seed is solved, and the
calibrations of the jobs with those sets are the ones judged.

The control is the reference in float32 put in the program's place
(``control_outputs``): it must come out as not correct.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from gen.board import board_from_config
from gen.poses import rig_of
from reference import ba, detection

#: distinct observation sets solved per recording, at most (a seed-drawn sample)
MAX_SETS = 8


def observations(dets, board, min_corners: int):
    """Per-frame {tag: (4, 2)} -> (p2d (F, N, 2), mask (F, N))."""
    F, N = len(dets), board.n_corners
    p2d = np.zeros((F, N, 2))
    mask = np.zeros((F, N), bool)
    for f, det in enumerate(dets):
        for tag, corners in det.items():
            i = int(tag) - board.first_id
            if 0 <= i < board.n_tags:
                p2d[f, 4 * i:4 * i + 4] = np.asarray(corners, np.float64)
                mask[f, 4 * i:4 * i + 4] = True
        if mask[f].sum() < min_corners:
            mask[f] = False
    return p2d, mask


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def _obs_of(out, rec, board, min_corners, C):
    if rec.p2d is not None:
        return rec.p2d, rec.mask
    pairs = [observations(out["dets"][c], board, min_corners) for c in range(C)]
    return np.stack([p for p, _ in pairs]), np.stack([m for _, m in pairs])


def _key(p2d, mask) -> str:
    return hashlib.sha1(np.ascontiguousarray(p2d).tobytes() + mask.tobytes()).hexdigest()


def references(config, recordings, outputs, device, dtype=torch.float64, seed=0) -> dict:
    """{observation key: (single solutions per camera, joint solution or None,
    p2d, mask)} for the observation sets chosen as set out above."""
    board = board_from_config(config)
    p3d = board.p3d()
    params = np.array([c["params"] for c in config["cameras"]])
    C = len(params)
    ext = rig_of(config)
    sets: dict = {}  # recording -> {key: (p2d, mask)}, in order of first appearance
    for out in outputs:
        p2d, mask = _obs_of(out, recordings[out["recording"]], board, config["min_corners"], C)
        sets.setdefault(out["recording"], {}).setdefault(_key(p2d, mask), (p2d, mask))
    rng = np.random.default_rng(abs(int(seed)))
    refs = {}
    for r, found in sorted(sets.items()):
        keys = list(found)
        if len(keys) > MAX_SETS:
            keys = [keys[i] for i in sorted(rng.choice(len(keys), MAX_SETS, replace=False))]
        poses = recordings[r].poses
        for key in keys:
            p2d, mask = found[key]
            single = [ba.solve(params[c:c + 1], np.zeros((1, 6)), poses[c], p3d,
                               p2d[c:c + 1], mask[c:c + 1], dtype=dtype, device=device)
                      for c in range(C)]
            joint = None
            if C > 1:
                joint = ba.solve(params, ext, poses[0], p3d, p2d, mask, dtype=dtype,
                                 device=device)
            refs[key] = (single, joint, p2d, mask)
    return refs


def judge(config, recordings, outputs, refs, device) -> dict:
    """{number: value} over the window's outputs (see the module docstring)."""
    board = board_from_config(config)
    cams = config["cameras"]
    C = len(cams)
    nums = {}
    if outputs and outputs[0]["dets"][0] is not None:
        wrong = missed = bias = 0.0
        errors = []
        truths = {}
        for out in outputs:
            r = out["recording"]
            for c, cam in enumerate(cams):
                if (r, c) not in truths:
                    truths[r, c] = detection.true_corners(cam["params"], cam["width"],
                                                          cam["height"], board,
                                                          recordings[r].poses[c])
                j = detection.judge(out["dets"][c], *truths[r, c], board)
                wrong += j["wrong"]
                missed = max(missed, 1.0 - j["found"] / max(j["shown"], 1))
                bias = max(bias, j["bias"])
                errors.append(j["errors"])
        errors = np.concatenate(errors)
        nums.update(wrong_tags=wrong, missed_share=missed, corner_bias_px=bias,
                    corner_err_p99_px=float(np.percentile(errors, 99)) if len(errors) else np.inf)
    gaps = {"intr_gap": 0.0, "focal_err": 0.0}
    if C > 1:
        gaps.update(rms_gap_px=0.0, ext_err=0.0, joint_focal_err=0.0)
    truth = np.array([c["params"] for c in cams])
    rig = rig_of(config)
    p3d = board.p3d()
    judged = 0
    for out in outputs:
        key = out.get("obs_key")
        if key is None:
            key = _key(*_obs_of(out, recordings[out["recording"]], board,
                                config["min_corners"], C))
        if key not in refs:  # a set outside the drawn sample
            continue
        judged += 1
        single, joint, p2d, mask = refs[key]
        for c in range(C):
            gaps["intr_gap"] = max(gaps["intr_gap"], _rel(out["theta"][c], single[c].theta[0]))
            gaps["focal_err"] = max(gaps["focal_err"], _rel(out["theta"][c][:2], truth[c, :2]))
        if C > 1:
            j = out["joint"]
            if j is None:
                gaps.update(rms_gap_px=np.inf, ext_err=np.inf, joint_focal_err=np.inf)
                continue
            poses = np.zeros_like(joint.poses)
            for f, p in j["poses"].items():
                poses[f] = p
            rms = ba.rms(j["theta"], j["ext"], poses, p3d, p2d, mask, device=device)
            gaps["rms_gap_px"] = max(gaps["rms_gap_px"], abs(rms - joint.rms))
            gaps["ext_err"] = max(gaps["ext_err"], float(np.max(np.abs(j["ext"][1:] - rig[1:]))))
            focal = np.abs(j["theta"][:, :2] - truth[:, :2]) / truth[:, :2]
            gaps["joint_focal_err"] = max(gaps["joint_focal_err"], float(focal.max()))
    if outputs and not judged:  # no calibration was judged: nothing shows it correct
        gaps = {k: np.inf for k in gaps}
    nums.update(gaps)
    return nums


def control_outputs(config, recordings, outputs, device, seed=0) -> list:
    """The outputs of the control: the reference in float32 in the program's
    place, on the same inputs (per output, its detections re-drawn from the
    geometry in float32 and its calibrations solved in float32)."""
    board = board_from_config(config)
    cams = config["cameras"]
    refs32 = references(config, recordings, outputs, device, dtype=torch.float32, seed=seed)
    ctrl = []
    for out in outputs:
        rec = recordings[out["recording"]]
        p2d, mask = _obs_of(out, rec, board, config["min_corners"], len(cams))
        single, joint, _, _ = refs32.get(_key(p2d, mask), next(iter(refs32.values())))
        dets = [None] * len(cams)
        if out["dets"][0] is not None:
            dets = []
            for c, cam in enumerate(cams):
                truth, shown = detection.true_corners(cam["params"], cam["width"], cam["height"],
                                                      board, rec.poses[c], dtype=torch.float32)
                dets.append([{board.first_id + i: truth[f, i] for i in np.flatnonzero(shown[f])}
                             for f in range(len(shown))])
        j = None
        if joint is not None:
            j = {"theta": joint.theta, "ext": joint.ext,
                 "poses": {f: joint.poses[f] for f in range(len(joint.poses))}}
        ctrl.append({"recording": out["recording"], "dets": dets, "obs_key": _key(p2d, mask),
                     "theta": np.concatenate([s.theta for s in single]), "joint": j})
    return ctrl


def verdict(nums: dict, compared: dict) -> tuple:
    """(correct, [(name, value, limit)]) for the numbers the configuration compares."""
    rows = [(n, float(nums[n]), float(compared[n]["limit"])) for n in compared if n in nums]
    return all(v <= lim for _, v, lim in rows), rows
