"""lm_iters: the program's LM iterations (lm.loop_counts), mean per job."""


def read(run):
    vals = [j["lm_iters"] for j in run.per_job]
    return sum(vals) / len(vals) if vals else None
