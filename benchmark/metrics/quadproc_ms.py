"""quadproc_ms: the program's detect/quadproc stage total (host C++ quad
extraction), mean per job."""


def read(run):
    vals = [j["stages"].get("detect/quadproc", 0.0) for j in run.per_job]
    return 1000.0 * sum(vals) / len(vals) if vals and any(vals) else None
