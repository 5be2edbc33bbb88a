"""The control of a cell's comparison, on the chip:

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--trace 1]

runs the cell once a seed in one process, as ``run.py`` does, and also
computes each compared number with the reference's float8 twin (the
nearest precision below the bf16 the configurations state) in the
program's place, at the same prompts and served tokens.  Each seed's
result line carries the control's numbers under ``control`` and the
harness's verdict on them, held to the cell's limits, under
``control_correct``; standard error has them beside the limits (lines
``control <name> <value> limit <limit>``).  The limits in
``checks/<cell>.json`` lie between the program's readings and these.

Exit code 0 where on every seed the program came out correct and the
control did not; 1 where a control came out correct or a program did
not; a run's own code where it failed.  The benchmark's own runs never
run it.
"""
import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", nargs="+", required=True)
    ap.add_argument("--trace", default="0", choices=("0", "1"))
    args = ap.parse_args(argv)
    worst = 0
    for seed in args.seeds:
        results = []
        rc = run.main(["--workload", args.workload, "--seed", seed,
                       "--seconds", args.seconds, "--trace", args.trace],
                      control=True, t0=time.perf_counter(), results=results)
        if rc == 0 and (results[0]["control_correct"]
                        or not results[0]["correct"]):
            print(f"seed {seed}: the program came out "
                  f"{results[0]['correct']}, the control "
                  f"{results[0]['control_correct']}", file=sys.stderr)
            rc = 1
        worst = max(worst, rc)
        gc.collect()                 # the seed's weights, before the next
        sys.modules["torch"].cuda.empty_cache()
    return worst


if __name__ == "__main__":
    sys.exit(main())
