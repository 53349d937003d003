"""cold_frame_pct: frames the tracked detector swept cold
(detect/cold-frames) over the valid frames it tracked (detect/frames), in
%, over the window."""

from metrics._program import counter_pct


def read(run):
    return counter_pct("detect/cold-frames", "detect/frames")
