"""calib_s: the window over the jobs it completed (host clock): the
seconds a user waits for one calibration."""


def read(run):
    return run.window_s / len(run.jobs)
