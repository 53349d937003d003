#!/usr/bin/env python
"""Joint bundle adjustment of the synthetic 8-camera rig, 1000 frames per
camera, in the PyTorch/CUDA port (``ccrs_tpu_torch``): the counterpart of
``bench_multicam.py``.

One joint BA over 8 cameras' intrinsics, 7 extrinsics and 1000 shared
board poses (~1.8M reprojection residuals, Schur-eliminated to a 96-dim
system).  The observations are ``testdata.rig_problem``'s, whose numpy
draws are ``bench_multicam.py``'s in the same order.  The solver is the
JAX program's route: ``ba_solve_multi_mixed`` (float32 descent, float64
polish) on one device, ``multi_ba_sharded_mixed`` frame-sharded over the
list when there are more.  One warm-up solve, then one timed solve.

Gates (the run fails on any): max focal error / 190 px < 3e-3, max
extrinsic error < 3e-3, and 0.07 < RMS < 0.13 px (0.1 px of injected
noise per axis).  Nothing falls back to the CPU.

Usage: ``python3 bench_multicam_torch.py [--platform cuda|cpu]`` (default
``cuda``: every visible card; without one it exits non-zero unless the CPU
is asked for).  The last line of stdout is one JSON object with
``bench_multicam.py``'s keys plus ``device`` (the card's name and power
limit, or ``"cpu"``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bench_torch import device_label
from ccrs_tpu_torch.models.projections import project_eucm
from ccrs_tpu_torch.parallel.mesh import multi_ba_sharded_mixed
from ccrs_tpu_torch.solve.lm import ba_solve_multi_mixed
from ccrs_tpu_torch.testdata import rig_errors, rig_problem


def run(C=8, F=1000, vis_frac=0.75, devices=None) -> dict:
    """``devices``: the mesh, a list of devices (entries may repeat);
    None means every visible card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("bench_multicam_torch: no device to run on")
    first = devices[0]

    def sync():
        for d in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    print("generating observations...", file=sys.stderr)
    problem = rig_problem(C, F, vis_frac, seed=0, device=first)
    args = problem["args"]
    if len(devices) > 1:
        # several devices: frame-shard the joint solve over the mesh
        print(f"sharding over {len(devices)} devices", file=sys.stderr)

        def solve():
            return multi_ba_sharded_mixed(project_eucm, *args, mesh=devices)

    else:

        def solve():
            # two-stage mixed precision: float32 descent, float64 polish
            return ba_solve_multi_mixed(project_eucm, *args)

    print("warmup...", file=sys.stderr)
    solve()
    sync()
    t0 = time.perf_counter()
    res = solve()
    sync()
    dt = time.perf_counter() - t0

    err = rig_errors(problem, res)
    focal_err, ext_err, rms = err["focal_rel_err"], err["ext_err"], err["rms_px"]
    print(
        f"iters={int(res.n_iters)} cost={float(res.cost):.4f} "
        f"focal_rel_err={focal_err:.2e} ext_err={ext_err:.2e} "
        f"rms={rms:.4f} px (noise floor 0.1)",
        file=sys.stderr,
    )
    # convergence gate: the recovered rig must sit at the injected-noise
    # floor, so the wall-clock cannot be bought with a loose solve
    if not focal_err < 3e-3:
        raise RuntimeError(f"focal error {focal_err:.3e}")
    if not ext_err < 3e-3:
        raise RuntimeError(f"extrinsic error {ext_err:.3e}")
    if not 0.07 < rms < 0.13:
        raise RuntimeError(f"rms {rms:.4f} px off the 0.1 px noise floor")
    return {
        "metric": f"joint {C}-camera BA wall-clock ({F} frames/cam, {err['residuals']} residuals)",
        "value": round(dt, 2),
        "unit": "seconds",
        "iters": int(res.n_iters),
        "max_focal_rel_err": float(focal_err),
        "max_extrinsic_err": float(ext_err),
        "rms_px": round(rms, 4),
        "rms_gate": "0.07 < rms < 0.13 (0.1 px injected noise)",
        "device": device_label(first),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--platform", default="cuda", choices=["cuda", "cpu"],
        help="where the solve runs (default cuda: every visible card; without "
        "a card the run exits non-zero unless cpu is asked for)",
    )
    args = ap.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_multicam_torch: --platform cuda but no CUDA device is available")
    print(json.dumps(run(devices=None if args.platform == "cuda" else ["cpu"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
