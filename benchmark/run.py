#!/usr/bin/env python3
"""Benchmark of ccrs_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed (frames rendered on the card
and kept in pinned host memory, or cached detections), pays the program's
one-time costs on two threads beside the render, and runs one untimed job
per recording.  The window then runs whole jobs for ``--seconds``
(``harness/window.py``); with ``--trace 1`` the first jobs run under
torch.profiler and the per-layer metrics are reported instead of the
end-to-end ones.  After the window the program's state is freed and every
job's answers are judged against the reference (``reference/check.py``).
The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# every build and kernel cache of the run inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "ccrs_tpu")
PEAK_BW = 3.35e12  # bytes/s, one NVIDIA H100 SXM (data sheet)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return "card: " + out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi unreadable ({e})"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.cells import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if args.trace:
        os.environ["CCRS_TIMING_SPANS"] = "1"  # read when the program is imported
        log(card_label())
    run = measure(cell, args, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: nothing it runs may import JAX or the JAX package")
        return 3
    for name, value, limit in run["limits"]:
        log(f"{name} {value!r} limit {limit!r}")
    print(json.dumps(run["line"]))
    return 0


def measure(cell, args, device) -> dict:
    import threading
    import types

    import torch

    from harness import inputs
    from harness.cells import read_metrics
    from harness.jobs import Jobs
    from harness.trace import Profiler
    from harness.window import run_window, window_seconds
    from reference import check

    cfg, traffic = cell.config, cell.traffic
    jobs = Jobs(cfg, traffic, device)
    errors = []

    def guarded(call):
        try:
            call()
        except BaseException as e:  # re-raised on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(c,), name="bench-prewarm")
               for c in jobs.prewarm_calls()]
    for t in threads:
        t.start()
    try:
        recordings = inputs.make(cfg, traffic, args.seed, device)
        _sync(device)
        log(f"inputs made at {time.perf_counter() - T_PROCESS:.3f} s")
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    log(f"warm-up threads joined at {time.perf_counter() - T_PROCESS:.3f} s")
    jobs.use(recordings)
    for k in range(len(recordings)):  # one untimed job per recording
        jobs.run(k)
        log(f"untimed job {k} ended at {time.perf_counter() - T_PROCESS:.3f} s")
    from ccrs_tpu_torch import graphs
    from ccrs_tpu_torch.solve import lm
    from ccrs_tpu_torch.utils import profiling

    setup_s = time.perf_counter() - T_PROCESS
    log(f"set-up {setup_s:.3f} s")
    prof = Profiler(int(traffic.get("trace_jobs", 1)) if args.trace else 0)
    per_job = []

    def job(k):
        before = _probe(lm, profiling) if args.trace else None
        out = jobs.run(k)
        if args.trace:
            per_job.append(_delta(before, _probe(lm, profiling)))
        return out

    if args.trace:
        profiling.enable()
        profiling.reset()
    captures0 = graphs.counts()["captures"]
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    done = run_window(job, args.seconds, around=prof.around)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    captures = graphs.counts()["captures"] - captures0
    wsec = window_seconds(done)
    log(f"window {wsec:.3f} s, {len(done)} jobs, peak {peak} B, captures {captures}")
    log("job seconds: " + " ".join(f"{j.end - j.start:.3f}" for j in done))
    trace = None
    if args.trace:
        prof.finish()
        trace = prof.digest(profiling.spans(), threading.main_thread().name)
    failed = [j for j in done if j.error is not None]
    for j in failed:
        log(f"job {j.index} failed: {j.error}")
    outputs = [j.output for j in done if j.error is None]

    # free the program's state before the reference runs
    del jobs, job
    graphs.reset()
    if cuda:
        torch.cuda.empty_cache()
    refs = check.references(cfg, recordings, outputs, device, seed=args.seed)
    log(f"reference: {len(refs)} observation sets solved")
    nums = check.judge(cfg, recordings, outputs, refs, device)
    ok, rows = check.verdict(nums, cfg["compared"])

    state = types.SimpleNamespace(
        cell=cell, jobs=done, window_s=wsec, setup_s=setup_s,
        frames_per_job=inputs.frames_per_job(cfg, traffic), graph_captures=captures,
        per_job=per_job[prof.n_jobs:] or per_job, trace=trace, peak_bw=PEAK_BW,
        spans=[o["spans"] for o in outputs[prof.n_jobs:] or outputs])
    metrics = read_metrics(cell.per_layer if args.trace else cell.end_to_end, state,
                           cell.bench_dir)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok and not failed), "attempted": len(done), "failed": len(failed),
            "metrics": metrics, "device": dev}
    if trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = {"device_ops": [[n[:120], s] for n, s in trace["device_ops"]],
                             "idle_gaps": [[n, s] for n, s in trace["idle_gaps"]]}
    # a number that could not be computed (a joint solve that diverged) is null
    line["limits"] = {n: {"value": v if math.isfinite(v) else None, "limit": lim}
                      for n, v, lim in rows}
    return {"line": line, "limits": rows}


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _probe(lm, profiling) -> dict:
    return {"stages": profiling.totals(), "lm_iters": lm.loop_counts()["iters"]}


def _delta(a: dict, b: dict) -> dict:
    stages = {k: v - a["stages"].get(k, 0.0) for k, v in b["stages"].items()}
    return {"stages": stages, "lm_iters": b["lm_iters"] - a["lm_iters"]}


if __name__ == "__main__":
    sys.exit(main())
