#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 ... \
        [--fault-seeds 3] [--device cuda]

In one process: the cell's set-up once (the program's warm-up and one
untimed job per recording, as a run's set-up), then per seed the cell's
inputs, one job per recording through the timed path (``harness/jobs.py``), the
program's numbers against the float64 reference, and the numbers of the
control, the reference computed in float32 and put in the program's
place (``reference/check.py``).  On the first ``--fault-seeds`` seeds the
jobs run again with each detector fault of ``FAULTS`` planted where the
detections are produced (before the calibration reads them).  One JSON
line per seed on standard output: ``program``, ``control`` and ``faults``
numbers and the verdict of each under the configuration's limits.  The
benchmark's runs never run the control or the faults.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

#: the detector's corners shifted by this many pixels (along the diagonal)
BIAS_PX = 0.3
#: the share of detected tags dropped
DROP_SHARE = 0.05
FAULTS = ("corner_bias", "tags_dropped")


def plant(fault: str, dets: list, rng) -> list:
    """Per-frame {tag: corners} with ``fault`` planted."""
    if fault == "corner_bias":
        d = BIAS_PX / 2 ** 0.5
        return [{t: [(x + d, y + d) for x, y in np.asarray(c, np.float64)]
                 for t, c in det.items()} for det in dets]
    if fault == "tags_dropped":
        return [{t: c for t, c in det.items() if rng.random() >= DROP_SHARE} for det in dets]
    raise ValueError(f"unknown fault {fault!r}")


def faulty_detect(detect, fault: str, seed: int):
    """``Jobs._detect`` with ``fault`` planted in what the detector produces."""
    from ccrs_tpu_torch.calib.frames import FrameBatch

    rng = np.random.default_rng(abs(int(seed)))

    def _detect(self, rec, c, gen):
        dets, _, spec = detect(self, rec, c, gen)
        dets = plant(fault, dets, rng)
        cam = self.cams[c]
        return dets, FrameBatch.from_detections(dets, self.times, self.board, cam["width"],
                                                cam["height"]), spec
    return _detect


def readings(cell, seeds, device, fault_seeds: int = 0):
    """Yield one dict per seed (see the module docstring)."""
    import types

    from harness import inputs
    from harness.jobs import Jobs
    from reference import check

    compared = cell.config["compared"]

    jobs = Jobs(cell.config, cell.traffic, device)
    for call in jobs.prewarm_calls():
        call()
    for i, seed in enumerate(seeds):
        recordings = inputs.make(cell.config, cell.traffic, seed, device)
        jobs.use(recordings)
        if i == 0:  # the untimed job per recording that a run's set-up makes
            for k in range(len(recordings)):
                jobs.run(k)
        outputs = [jobs.run(k) for k in range(len(recordings))]
        t0 = time.perf_counter()
        refs = check.references(cell.config, recordings, outputs, device, seed=seed)
        prog = check.judge(cell.config, recordings, outputs, refs, device)
        ref_s = time.perf_counter() - t0
        ctrl = check.judge(cell.config, recordings,
                           check.control_outputs(cell.config, recordings, outputs, device,
                                                 seed=seed),
                           refs, device)
        row = {"seed": seed, "program": prog, "control": ctrl, "reference_s": ref_s,
               "program_correct": check.verdict(prog, compared)[0],
               "control_correct": check.verdict(ctrl, compared)[0], "faults": {}}
        if i < fault_seeds and jobs.video:
            for fault in FAULTS:
                jobs._detect = types.MethodType(faulty_detect(Jobs._detect, fault, seed), jobs)
                try:
                    bad = [jobs.run(k) for k in range(len(recordings))]
                finally:
                    del jobs._detect
                nums = check.judge(cell.config, recordings, bad,
                                   check.references(cell.config, recordings, bad, device,
                                                    seed=seed), device)
                row["faults"][fault] = {"numbers": nums,
                                        "correct": check.verdict(nums, compared)[0]}
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from harness.cells import find_cell

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for row in readings(find_cell(args.workload), args.seeds, torch.device(args.device),
                        args.fault_seeds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
