"""Two formulations of the run-wise reduction of ``ccrs_tpu_torch.detect.ccl``,
timed on the card.

One pass of the device quad extraction gives every dark pixel the maximum
(or minimum) over its contiguous run of dark pixels along an axis.  The
module computes it as a running maximum over (run number, value) words
plus a gather from each run's last pixel (``_Runs``).  The other way to
write it in torch is one ``scatter_reduce`` into a per-run table and a
gather back (``ScatterRuns`` below).  Both give the same bits; this script
checks that and times ``label_components`` and ``extract_quads_device``
with each, in turns (scan, scatter, scatter, scan), on 64 rendered 512 x
512 frames thresholded by the port, with CUDA events.

Usage, on a machine with a CUDA card: ``python3 -m ccrs_tpu_torch.ccl_passes``
(about a minute).  Prints the card's name and power limit, then one line
per formulation and turn.
"""

import subprocess
import sys

import torch

from .board import create_default_6x6_board
from .detect import ccl, get_family
from .detect.threshold import adaptive_threshold
from .models import GenericModel
from .testdata import render_frames_device, smooth_sequence_poses

N_FRAMES = 64
MAX_QUADS = 128
REPS = 3


class ScatterRuns(ccl._Runs):
    """``_Runs`` with each pass as a ``scatter_reduce`` into a per-run
    table: every pixel of a run updates one address atomically."""

    def __init__(self, black):
        super().__init__(black)
        # dense run numbers 0 (white), 1, 2, ... from the shifted ones
        self.flat = {a: (self.ids[a] >> 32).reshape(-1) for a in self.ids}
        self.n = {a: int(self.flat[a].max()) + 1 for a in self.ids}

    def reduce(self, vals, axis, combine_max):
        B, C, H, W = vals.shape
        info = torch.iinfo(torch.int32)
        flat = vals.permute(1, 0, 2, 3).reshape(C, -1)
        ids = self.flat[axis].expand(C, -1)
        table = torch.full((C, self.n[axis]), info.min if combine_max else info.max,
                           dtype=torch.int32, device=vals.device)
        table.scatter_reduce_(1, ids, flat, "amax" if combine_max else "amin")
        out = table.gather(1, ids).reshape(C, B, H, W).permute(1, 0, 2, 3)
        return torch.where(self.black, out, vals)


def time_ms(fn):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main():
    if not torch.cuda.is_available():
        print("ccl_passes: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    board = create_default_6x6_board()
    model = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)
    frames = render_frames_device(
        model, board, get_family("t36h11"), smooth_sequence_poses(N_FRAMES, board, seed=11),
        noise=1.5, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    binary = adaptive_threshold(frames)
    scan = ccl._Runs
    results = {}
    for name, runs in (("scan", scan), ("scatter", ScatterRuns), ("scatter", ScatterRuns),
                       ("scan", scan)):
        ccl._Runs = runs
        try:
            labels = ccl.label_components(binary)
            quads, valid = ccl.extract_quads_device(binary, max_quads=MAX_QUADS)
            ms_l = time_ms(lambda: ccl.label_components(binary))
            ms_q = time_ms(lambda: ccl.extract_quads_device(binary, max_quads=MAX_QUADS))
        finally:
            ccl._Runs = scan
        first = results.setdefault("first", (labels, quads, valid))
        same = all(torch.equal(a, b) for a, b in zip(first, (labels, quads, valid)))
        print(f"{name:8s} {N_FRAMES}x512x512: label_components {ms_l:.3f} ms, "
              f"extract_quads_device {ms_q:.3f} ms (CUDA events, {REPS} calls); "
              f"equal to the first turn's result: {same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
