#!/usr/bin/env python3
"""What the first solve of a process costs on the card, piece by piece.

The port's first ``torch.func`` solve in a process takes seconds where a
warm one takes a fraction of one.  This probe starts fresh Python processes
and times, in each, a fixed order of first calls with a
``torch.cuda.synchronize()`` after every one:

- ``split``: import torch; create the CUDA context; import the package;
  the first float64 matmul (cuBLAS handle); the first batched
  ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve`` (cuSOLVER /
  MAGMA); the first einsum; the first ``jacfwd`` of a scalar function; the
  first ``vmap(jacfwd)`` of the EUCM reprojection at 534 frames, then the
  second; the first ``ba_solve`` at 534 frames x 144 corners, then the
  second; the same in float32; ``try_init_camera`` and ``calib_camera``
  twice each.
- ``tiny_first``: straight to a 2-frame ``ba_solve``, then the 534-frame
  one twice: does a tiny problem pay the whole first-call cost, so that a
  warm-up may use one?
- ``big_first``: straight to the 534-frame ``ba_solve``, twice: the cost a
  process pays without any warm-up.

Prints one line per step and, last, one JSON line with every step of every
order and the card's name and power limit.  Usage, on a machine with a
CUDA card: ``python3 tools/first_call_probe.py`` (about a minute).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDERS = ("split", "tiny_first", "big_first")
FRAMES = 534


def child(order: str) -> None:
    steps = []
    t_prev = [time.perf_counter()]

    def step(name, fn=None):
        out = fn() if fn is not None else None
        if "torch" in sys.modules and sys.modules["torch"].cuda.is_initialized():
            sys.modules["torch"].cuda.synchronize()
        now = time.perf_counter()
        steps.append((name, now - t_prev[0]))
        print(f"[{order}] {name}: {now - t_prev[0]:.3f} s", flush=True)
        t_prev[0] = time.perf_counter()
        return out

    import torch

    step("import torch")
    if not torch.cuda.is_available():
        raise SystemExit("first_call_probe: no CUDA device")
    step("cuda context", lambda: torch.zeros(1, device="cuda"))
    sys.path.insert(0, ROOT)
    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.calib.initialize import try_init_camera
    from ccrs_tpu_torch.calib.single import calib_camera
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.solve import se3
    from ccrs_tpu_torch.solve.lm import ba_solve
    from ccrs_tpu_torch.testdata import rig_problem

    step("import ccrs_tpu_torch")
    F64 = torch.float64

    def single_args(n_frames, dtype=F64):
        pb = rig_problem(1, n_frames, seed=3, device="cuda")
        th, _, po, p3d, p2d, w, lo, hi, free, _, fv = pb["args"]
        args = (th[0], po, p3d, p2d[0], w[0], lo[0], hi[0], free[0], fv)
        return pb, tuple(a.to(dtype) for a in args)

    if order == "split":
        a = torch.randn(256, 256, dtype=F64, device="cuda")
        step("first float64 elementwise + randn")
        step("first float64 matmul", lambda: a @ a)
        spd = (a @ a.T + 256 * torch.eye(256, dtype=F64, device="cuda"))[:6, :6].expand(534, 6, 6).contiguous()
        L = step("first batched cholesky_ex", lambda: torch.linalg.cholesky_ex(spd)[0])
        step("first cholesky_solve", lambda: torch.cholesky_solve(spd[..., :3].contiguous(), L))
        step("first einsum", lambda: torch.einsum("fij,fjk->ik", spd, spd))
        from torch.func import jacfwd, vmap

        step("import torch.func")
        step("first jacfwd (sin)", lambda: jacfwd(torch.sin)(a[0, :6]))
        pb, args = single_args(FRAMES)
        step("make the 534-frame problem (se3, project_eucm)")
        th, po, p3d, p2d = args[:4]

        def resid(theta, pose, p2d_f):
            return project_eucm(theta, se3.transform(pose[:3], pose[3:], p3d))[0] - p2d_f

        jac = vmap(jacfwd(resid, argnums=(0, 1)), in_dims=(None, 0, 0))
        step("first vmap(jacfwd) of the reprojection", lambda: jac(th, po, p2d))
        step("second vmap(jacfwd) of the reprojection", lambda: jac(th, po, p2d))
        step("first ba_solve float64 534", lambda: ba_solve(project_eucm, *args))
        step("second ba_solve float64 534", lambda: ba_solve(project_eucm, *args))
        a32 = tuple(x.to(torch.float32) for x in args)
        step("first ba_solve float32 534", lambda: ba_solve(project_eucm, *a32, rtol=1e-6))
        step("second ba_solve float32 534", lambda: ba_solve(project_eucm, *a32, rtol=1e-6))
        board = create_default_6x6_board()
        batch = FrameBatch(
            (1 + torch.arange(FRAMES)).numpy().astype("int64"),
            pb["args"][4][0].cpu().numpy(), pb["args"][5][0].cpu().numpy() > 0, 512, 512,
        )
        gen = torch.Generator(device="cuda").manual_seed(0)
        step("first try_init_camera", lambda: try_init_camera(board, batch, 0, FRAMES // 2, gen))
        step("second try_init_camera", lambda: try_init_camera(board, batch, 0, FRAMES // 2, gen))
        cam = GenericModel("eucm", pb["gt_params"][0] * 1.01, 512, 512)
        step("first calib_camera", lambda: calib_camera(board, batch, cam, False, 0, False))
        step("second calib_camera", lambda: calib_camera(board, batch, cam, False, 0, False))
    else:
        if order == "tiny_first":
            _, tiny = single_args(2)
            step("make the 2-frame problem")
            step("first ba_solve float64 2 frames", lambda: ba_solve(project_eucm, *tiny))
            step("second ba_solve float64 2 frames", lambda: ba_solve(project_eucm, *tiny))
        _, args = single_args(FRAMES)
        step("make the 534-frame problem")
        step("ba_solve float64 534, first here", lambda: ba_solve(project_eucm, *args))
        step("ba_solve float64 534, second here", lambda: ba_solve(project_eucm, *args))
    print("PROBE " + json.dumps({"order": order, "steps": steps}), flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    results = []
    for order in ORDERS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", order],
            capture_output=True, text=True,
        )
        wall = time.perf_counter() - t0
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"first_call_probe: order {order} failed ({proc.returncode})")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PROBE ")][-1]
        rec = json.loads(line[len("PROBE "):])
        rec["process_wall_s"] = wall
        results.append(rec)
        print(f"[{order}] process wall {wall:.3f} s")
    print(json.dumps({"card": card, "orders": results}))


if __name__ == "__main__":
    main()
