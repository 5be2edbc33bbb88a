"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It needs a CUDA card (and as many as the
cell asks for); without one it exits 2 and prints no result.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration and a traffic
mix; ``perfbench/bench/spec.py`` says where each piece lives.  The run
draws the weights and the traffic from ``--seed``, warms up the cell's
shapes (``setup_s``: from this file's first line to the first timed
operation), measures for ``--seconds``, then compares what the timed path
produced with the plain reference (``perfbench/reference/``).  With
``--trace 1`` a traced segment follows the window and the result holds
the cell's per-layer metrics instead of its end-to-end ones.

The last lines of standard error are the numbers compared, each beside
its limit; the last line of standard output is the result, as JSON.  The
run fails (exit code 3), and prints no result, if ``jax``, ``jaxlib``,
``flax`` or the JAX package (``repro``) is loaded once the window has
closed and the per-layer readers have run.  Standard error also gives
``at_s``: the seconds since the process started at which each phase of
set-up (imports, the CUDA context, the weights, the scheduler and store,
the warm-up), the window, the traced segment and the comparison ended.

Every cache the run writes is inside the checkout: the kernels' nvcc
builds in ``build/repro_torch/`` (the port's own), Triton's, the CUDA
driver's and PyTorch's under ``build/``.  The host's math libraries get
one thread (``OMP_NUM_THREADS`` and its kin), so that the run loads the
host from one process with few threads.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, set before torch
    loads; USE_FLAX=0 keeps a library that could load JAX from doing so;
    one thread for the host's math libraries, so that the run's own
    threads take no core from the thread that dispatches the steps."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "torchinductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden(modules=None):
    """The forbidden packages among ``modules`` (default: those loaded),
    compared by whole top-level names."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device: str = "cuda",
         control: bool = False, t0: float = T0, results=None):
    """One run; returns the process's exit code.  ``device="cpu"`` skips
    the look for a card (the tests drive the rest of a run that way);
    ``control`` also computes the control's numbers and its verdict;
    ``results``, a list, gets the printed result appended."""
    args = parse(argv)
    cache_env(root)
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from perfbench.bench import check, decode, prefill, spec
    from perfbench.bench.model import sync
    from perfbench.bench.trace import top

    at_s = {"imports": time.perf_counter() - t0}
    cell = spec.load_cell(args.workload, root)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                  f"{found}", file=sys.stderr)
            return 2
    dev = torch.device(device)
    torch.zeros(1, device=dev)                    # the CUDA context
    sync(dev)
    at_s["device"] = time.perf_counter() - t0
    driver = {"prefill": prefill, "decode": decode}[cell.kind]
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                     t0, control=control)
    at_s.update(out.at_s)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(root, m["name"])(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    limits = cell.check["limits"]
    checks = out.checks(limits)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": check.correct(checks), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev_info}
    if args.trace and out.segment is not None:
        dev_info["busy_s"] = out.segment.busy_s
        dev_info["window_s"] = out.segment.window_s
        result["breakdown"] = {"device_ops": top(out.segment.device_ops),
                               "idle_gaps": top(out.segment.idle_gaps)}
    if control:
        # the control in the program's place, held to the same limits
        result["control"] = out.control
        result["control_correct"] = check.correct(
            out.checks(limits, control=True))
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}

    # last, once the readers have run: what the process loaded
    found = loaded_forbidden()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 3
    print(json.dumps({"readings": out.readings(limits),
                      "at_s": dict(at_s, end=time.perf_counter() - t0)}),
          file=sys.stderr)
    if control:
        for name, value, limit in out.checks(limits, control=True):
            print(f"control {name} {value!r} limit {limit!r}",
                  file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    if results is not None:
        results.append(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
