"""fps: frames of all timed jobs over the window, from the first job's start
to the last job's end (host clock); None where a job detects no frames."""


def read(run):
    if not run.frames_per_job:
        return None
    return len(run.jobs) * run.frames_per_job / run.window_s
