"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The run makes its inputs from ``--seed``, sets up and warms the
program (``glia_tpu_torch``) on every shape the cell's traffic uses,
measures for ``--seconds`` seconds in a closed loop, checks what the timed
calls produced against the plain reference (``benchmark/reference``), and
prints one JSON line as the last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``benchmark/layer_metrics``), read
from the program's counters and spans over the window and from a
``torch.profiler`` trace of a fixed stretch at the window's start.  The
last lines of standard error give each compared number beside its limit.

The run exits non-zero and prints no result without enough CUDA cards, or
when a module of JAX or of the JAX package (``glia_tpu``, its top-level
name compared whole) is loaded once the window has closed.

Everything a cell needs is found by name: ``workloads/<cell>.json``,
``configs/<config>.json``, ``drivers/<driver>.py``,
``end_to_end/<metric>.py``, ``layer_metrics/<metric>.py``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "glia_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fixed_cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout, so only
    a checkout's first run builds.  The program's own kernels build into
    ``.build/glia_tpu_torch`` by themselves; these keep any library cache
    off the user's directories."""
    build = os.path.join(ROOT, ".build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"


def few_threads():
    """One host thread for the math libraries of the timed loop (the
    run's load is one process with few threads, so that other work on a
    shared host moves it less); set before numpy and torch load."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules():
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a per-layer metric reads: the cell, the window's calls (with
    the program's counters each), the trace summary of
    the traced stretch (None when the profiler saw no device operation),
    and the state of the cell's traffic (its ``drivers/`` module)."""

    def __init__(self, cell, window, trace, state):
        self.cell, self.window, self.trace, self.state = (cell, window,
                                                          trace, state)


def run_cell(workload, seed, seconds, trace, device, registry=None):
    """One run of ``workload`` on ``device``; returns the result dict.
    ``registry``: where the cell's files are found (the benchmark's own
    by default)."""
    import torch

    from benchmark.core.registry import Registry
    from benchmark.core.trace import Tracer
    from benchmark.core.window import run_window

    reg = registry or Registry()
    cell = reg.cell(workload)
    driver = reg.module("drivers", cell["driver"])
    card = device.type == "cuda"
    state = driver.setup(cell, seed, device, log)
    if card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s")

    tracer = None
    if trace:
        from glia_tpu_torch.ops import cuda as kcuda

        tracer = Tracer(kcuda.launches)
    window = run_window(state.step, seconds, tracer,
                        float(cell.get("trace_seconds", seconds)))
    log(f"window: {len(window.calls)} calls in {window.seconds:.3f} s; "
        f"call p5 / p50 / p95 {window.percentile(5) * 1e3:.3f} / "
        f"{window.percentile(50) * 1e3:.3f} / "
        f"{window.percentile(95) * 1e3:.3f} ms")
    peak = int(torch.cuda.max_memory_allocated(device)) if card else 0
    state.free()
    checked, failed, numbers = state.check(log)
    correct = (checked > 0 and failed == 0
               and all(v <= lim for _, v, lim in numbers))

    metrics = {}
    summary = tracer.summary if tracer is not None else None
    if not trace:
        for name in cell["end_to_end"]:
            mod = reg.module("end_to_end", name)
            metrics[name] = {"value": mod.value(window), "unit": mod.UNIT}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        ctx = Context(cell, window, summary, state)
        for name, mod in reg.layer_metrics(workload):
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    dev_info = {"platform": "gpu" if card else device.type,
                "kind": (torch.cuda.get_device_name(device) if card
                         else device.type),
                "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(window.calls),
           "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace:
        if summary is not None:
            dev_info["busy_s"] = summary.busy_s
            dev_info["window_s"] = summary.window_s
            out["breakdown"] = summary.breakdown()
        else:
            log("the profiler saw no device operation in the traced "
                "stretch")
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in numbers}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_cache_dirs()
    few_threads()
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)

    from benchmark.core.registry import Registry

    chips = int(Registry().cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count = {torch.cuda.device_count()}")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, args.trace,
                   torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process after the window: {', '.join(bad)}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
