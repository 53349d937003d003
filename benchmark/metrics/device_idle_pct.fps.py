"""device_idle_pct.fps: share of the traced window with nothing running on
the card (torch.profiler), in the cells that report fps."""

from metrics._common import idle_pct


def read(run):
    return idle_pct(run)
