#!/usr/bin/env python3
"""The CLI's wall time in fresh processes under four warm-up variants.

With ``CCRS_PREWARM=1``, ``python -m ccrs_tpu_torch`` starts a warm-up
thread at the first decoded image (``cli.Prewarm``).  Whether that pays depends on what it overlaps
with: this probe renders ``chip_smoke.py``'s stereo dataset (2 cameras x
640 PNGs of 752x480) on the card and runs the CLI on it in a new process
per run, twice per variant, in turns (a, b, c, d, d, c, b, a):

- ``on``: the CLI's own warm-up (``CCRS_PREWARM=1``): ``TagDetector.prewarm``
  and ``prewarm_calibration`` on a thread beside decoding and detection;
- ``off``: ``CCRS_PREWARM=0``, the default: the first real solve pays the
  one-time costs;
- ``jacobian``: the warm-up thread runs only one 2-frame ``ba_solve`` (the
  first forward-mode Jacobian, the largest single one-time cost);
- ``serial``: the CLI's own warm-up, but the loader waits for it before it
  goes on: nothing overlaps, so its stage timers show what the warm-up's
  work costs alone.

The last two replace ``cli.Prewarm.__call__`` / the loader's thread start
inside the child only; the package has no switch for them.  Every run must
write the same ``cam0.json`` bytes.  Prints one line per run (wall seconds
from process start to exit, the "detecting feature took" and "prewarm took"
times, the largest stage timers), the walls per variant, and last one JSON
line with every run's stage timers and the card's name and power limit.

Usage, on a machine with a CUDA card and nvcc: ``python3
tools/fresh_cli_probe.py`` (about 8 minutes).
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("on", "off", "jacobian", "serial")
ORDER = MODES + MODES[::-1]
N_FRAMES = 640
#: EuRoC cam0 (the reference example's UCM) written as EUCM with beta = 1
EUROC_CAM0 = [471.019, 470.243, 367.122, 246.741, 0.67485, 1.0]


def child(mode: str, argv) -> None:
    """Run ``cli.main(argv)`` in this (fresh) process under ``mode``."""
    sys.path.insert(0, ROOT)
    from ccrs_tpu_torch import cli, dataloader

    if mode == "jacobian":
        def only_the_jacobian(self, width, height, n_frames):
            import threading

            from ccrs_tpu_torch.models.projections import project_fn
            from ccrs_tpu_torch.solve.lm import ba_solve
            from ccrs_tpu_torch.testdata import rig_problem
            from ccrs_tpu_torch.utils.profiling import stage

            self._thread = threading.current_thread()
            t0 = time.perf_counter()
            with stage("prewarm/jacobian"):
                args = rig_problem(1, 2, seed=3, device=self._args[3])["args"]
                th, _, po, p3d, p2d, w, lo, hi, free, _, fv = args
                ba_solve(project_fn("eucm"), th[0], po, p3d, p2d[0], w[0], lo[0], hi[0],
                         free[0], fv, max_iters=2)
            self.seconds = time.perf_counter() - t0

        cli.Prewarm.__call__ = only_the_jacobian
    elif mode == "serial":
        real = dataloader.threading.Thread

        class JoinedAtStart(real):
            def start(self):
                super().start()
                if self.name == "ccrs-prewarm":
                    self.join()

        dataloader.threading.Thread = JoinedAtStart
    cli.main(argv)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3:])
        return
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fresh_cli_probe: no CUDA device")
    from ccrs_tpu_torch import pngio
    from ccrs_tpu_torch.detect import quads
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.ops import threshold_cuda
    from ccrs_tpu_torch.testdata import default_rig_extrinsics, write_euroc_dataset

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    for build in (threshold_cuda.build, quads.build, pngio.build):
        build()  # the children find the libraries built
    runs, first = [], None
    with tempfile.TemporaryDirectory(prefix="ccrs_fresh_probe_") as tmp:
        ds = os.path.join(tmp, "dataset")
        write_euroc_dataset(
            ds, GenericModel("eucm", EUROC_CAM0, 752, 480), n_frames=N_FRAMES, cam_num=2,
            extrinsics=default_rig_extrinsics(2), seed=11, noise=1.5, span_scale=1.5,
            device="cuda",
        )
        for i, mode in enumerate(ORDER):
            out = os.path.join(tmp, f"out{i}")
            env = dict(os.environ, CCRS_PREWARM="0" if mode == "off" else "1", CCRS_TIMING="1")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", mode, ds, "--model",
                 "eucm", "--cam-num", "2", "--platform", "cuda", "--no-rerun", "--seed", "1",
                 "-o", out],
                capture_output=True, text=True, env=env, cwd=tmp, timeout=900,
            )
            wall = time.perf_counter() - t0
            text = proc.stdout + proc.stderr
            if proc.returncode != 0 or "prewarm error" in text or "speculation error" in text:
                raise SystemExit(f"fresh_cli_probe: {mode} failed ({proc.returncode}): "
                                 f"{text[-3000:]}")
            with open(os.path.join(out, "cam0.json"), "rb") as f:
                blob = f.read()
            first = first or blob
            if blob != first:
                raise SystemExit(f"fresh_cli_probe: {mode} wrote another cam0.json")
            detect = float(re.search(r"detecting feature took ([0-9.]+)", proc.stdout).group(1))
            warm = re.search(r"prewarm took ([0-9.]+)", proc.stdout)
            stages = {m.group(1): float(m.group(2)) for m in
                      re.finditer(r"^  (\S+)\s+([0-9.]+)s  x\d+$", proc.stdout, re.M)}
            top = sorted(stages, key=lambda k: -stages[k])[:8]
            print(f"[{mode}] wall {wall:.3f} s, detecting feature took {detect:.3f} s, prewarm "
                  f"{'took ' + warm.group(1) + ' s' if warm else 'off'}; "
                  + ", ".join(f"{k} {stages[k]:.3f}" for k in top), flush=True)
            runs.append(dict(mode=mode, wall_s=wall, detect_s=detect,
                             prewarm_s=float(warm.group(1)) if warm else None, stages=stages))
    for mode in MODES:
        walls = [r["wall_s"] for r in runs if r["mode"] == mode]
        print(f"[{mode}] process wall: {', '.join(f'{t:.3f}' for t in walls)} s ({card})")
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
