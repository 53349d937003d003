"""A cell's inputs, made by the benchmark's own generators.

The traffic file fixes each recording's board trajectory
(``trajectory_seeds``) and their order, so that every run does the same
work and captures the same graphs; ``--seed`` draws the sensor noise.

``mode`` "video": each recording is rendered on the card, one stream of
frames per camera of the configuration (camera c sees the board through
the rig), and copied to pinned host memory in the chunks a loader
uploads.  ``mode`` "cached": each recording is a set of detections as a
detection cache holds them (``gen.observations``); nothing is rendered.
The ground truth (intrinsics, rig, board poses) stays with the inputs for
the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gen import observations, poses, render
from gen.board import board_from_config, t36h11


@dataclasses.dataclass
class Recording:
    poses: list  # per camera (F, 6) board poses
    chunks: list | None = None  # per camera: pinned (B, H, W) uint8 chunks
    p2d: np.ndarray | None = None  # (C, F, N, 2), "cached"
    mask: np.ndarray | None = None  # (C, F, N)


def make(config: dict, traffic: dict, seed: int, device) -> list:
    """One ``Recording`` per trajectory seed; the same seed gives the same inputs."""
    board = board_from_config(config)
    p3d = board.p3d()
    cams = config["cameras"]
    C, F = len(cams), int(config["frames_per_recording"])
    ext = poses.rig_of(config)
    out = []
    seeds = traffic["trajectory_seeds"]
    children = np.random.SeedSequence(seed).spawn(len(seeds))
    for pose_seed, child in zip(seeds, children):
        noise_seed = int(child.generate_state(1)[0])
        if traffic["mode"] == "cached":
            base, p2d, mask = observations.observe(
                np.array([c["params"] for c in cams]), cams[0]["width"], cams[0]["height"], p3d,
                ext, F, pose_seed, noise_seed, traffic["rot_sigma"], traffic["distance_m"],
                traffic["noise_px"], traffic["visible_share"], config["min_corners"])
            cam_poses = [base] + [poses.rig_poses(ext[c], base) for c in range(1, C)]
            out.append(Recording(cam_poses, p2d=p2d, mask=mask))
            continue
        if traffic["mode"] != "video":
            raise ValueError(f"unknown traffic mode {traffic['mode']!r}")
        base = poses.trajectory(F, p3d, pose_seed, traffic["span_scale"])
        cam_poses = [base] + [poses.rig_poses(ext[c], base) for c in range(1, C)]
        chunks = []
        for c, cam in enumerate(cams):
            gen = torch.Generator(device=device).manual_seed(noise_seed + c)
            frames = render.render(cam["params"], cam["width"], cam["height"], board, t36h11(),
                                   cam_poses[c], gen, traffic["noise"])
            host = frames.cpu()
            if torch.device(device).type == "cuda":
                host = host.pin_memory()
            B = int(traffic["chunk"])
            chunks.append([host[i:i + B] for i in range(0, F, B)])
        out.append(Recording(cam_poses, chunks=chunks))
    return out


def frames_per_job(config: dict, traffic: dict) -> int:
    """Frames a job detects: every camera's recording in "video", none in "cached"."""
    if traffic["mode"] != "video":
        return 0
    return len(config["cameras"]) * int(config["frames_per_recording"])
