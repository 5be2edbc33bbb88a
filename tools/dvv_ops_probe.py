"""Build the dvv_ops CUDA kernels and time them alone on one card.

    python tools/dvv_ops_probe.py [--baseline FILE.cu] [--shapes N,K,R ...]
                                  [--reps 50] [--seed 0]

Prints the card (nvidia-smi: name, power limit, SM clock, power draw,
temperature) before and after, the nvcc seconds and ptxas's registers,
spills and shared memory of each library, then one JSON line per sweep
(dvv_sync_mask, dvv_read_sweep) and shape of chip_smoke.py's KERNEL_SHAPES
(or of --shapes), on clock sets drawn as chip_smoke.py draws them from
--seed: the path the wrapper takes, exact equality with the plain version,
the bound (bytes or operations, as chip_smoke.py counts them), and for the
package's build the CUDA-event milliseconds per call back to back ("ms", the
wrapper's host cost included), the profiler's device milliseconds per call
("device_ms") and the store's front end's host milliseconds per call (numpy
in, numpy out: "front_end_ms"), and where the wrapper's host time goes
("wrapper_host_us": microseconds per call by the host's clock of the whole
wrapper, its argument checks, its output allocation, the stream lookup, and
the C entry point alone on prepared arguments).

--baseline builds a second library from another dvv_ops.cu (the parent
commit's, saved under build/, which is gitignored and copied to the card)
and times it in turns with the package's on the same inputs: baseline,
kernel, kernel, baseline, for "ms" and "device_ms" (``baseline_call``: a
build with ``dvv_sweep_launch`` takes the path the package's wrapper
would; a build of the first design's source runs its own entry points).
The baseline's front end is the first design's: the arrays padded to
their bucket, four copies to the card from pageable memory, the kernel,
and the mask (and ceilings) brought back (``legacy_front``).  A quick
check of a kernel change; chip_smoke.py is the full run.
"""
import argparse
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.core import batched as TB  # noqa: E402
from repro_torch.kernels import build as _build  # noqa: E402
from repro_torch.kernels.dvv_ops import dvv_ops as C, ops, ref  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_baseline(source) -> Path:
    """Compile ``source`` alone into its own library under build/."""
    csrc = _build.BUILD_ROOT / "dvv_ops_baseline_src"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    shutil.copyfile(source, csrc / "dvv_ops.cu")
    return _build.build("dvv_ops_baseline", csrc)


def baseline_call(name, lib, dev):
    """The sweep ``name`` on ``dev`` through ``lib``, another build; the
    path it took."""
    vvs = dev[0]
    N, K, R = vvs.shape
    mask = torch.empty((N, K), dtype=torch.bool, device=vvs.device)
    ceil = None if name == "dvv_sync_mask" else torch.empty(
        (N, R), dtype=torch.int64, device=vvs.device)
    ptrs = [t.data_ptr() for t in dev] + [mask.data_ptr()]
    cptr = None if ceil is None else ceil.data_ptr()
    stream = C.stream_of(vvs.device)
    if hasattr(lib, "dvv_sweep_launch"):
        path = C.tiled_path(N, K, R)
        err = lib.dvv_sweep_launch(*ptrs, cptr, N, K, R,
                                   int(path == "tiled"), stream)
    elif ceil is None:
        path, err = "general", lib.dvv_sync_mask_launch(*ptrs, N, K, R,
                                                         stream)
    else:   # the first design's wrapper chose the keys a block owns
        kpb = max(1, min(256 // max(K, R, 1), 48 * 1024 // K))
        path, err = "general", lib.dvv_read_sweep_launch(
            *ptrs, cptr, N, K, R, kpb, stream)
    C._raise_on(err, name)
    return (mask if ceil is None else (mask, ceil)), path


def legacy_front(name, lib, host):
    """The first design's front end on ``lib``: pad to the bucket, copy
    each array to the card, sweep, bring the result back, cut it."""
    N, K, R = host[0].shape
    padded = TB.pad_sync_args(*host, TB.bucket_shape(N, K, R))
    got, _ = baseline_call(name, lib,
                           [torch.from_numpy(a).to("cuda") for a in padded])
    if name == "dvv_sync_mask":
        return got.cpu().numpy()[:N, :K]
    return got[0].cpu().numpy()[:N, :K], got[1].cpu().numpy()[:N, :R]


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of ``fn`` (which only enqueues work),
    after one warm-up; the card is waited for after the loop."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t
    torch.cuda.synchronize()
    return spent / reps * 1e6


def wrapper_breakdown(name, dev, reps: int) -> dict:
    """Host microseconds of the package's wrapper and of its parts."""
    N, K, R = dev[0].shape
    lib = C._load()
    full = C.sync_mask if name == "dvv_sync_mask" else C.read_sweep
    if name == "dvv_sync_mask":
        def alloc():
            return torch.empty((N, K), dtype=torch.bool, device="cuda")
        outs = (alloc(), None)
    else:
        def alloc():
            return (torch.empty((N, K), dtype=torch.bool, device="cuda"),
                    torch.empty((N, R), dtype=torch.int64, device="cuda"))
        outs = alloc()
    ptrs = [t.data_ptr() for t in dev] + [
        outs[0].data_ptr(), outs[1].data_ptr() if outs[1] is not None
        else None]
    stream = C.stream_of(dev[0].device)
    return {"wrapper": host_us(lambda: full(*dev), reps),
            "checks": host_us(lambda: C._sweep_args(*dev), reps),
            "alloc": host_us(alloc, reps),
            "stream": host_us(lambda: C.stream_of(dev[0].device), reps),
            "c_entry": host_us(lambda: lib.dvv_sweep_launch(
                *ptrs, N, K, R, 1, stream), reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--shapes", nargs="+",
                    type=lambda a: tuple(int(n) for n in a.split(",")))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dvv_ops_probe: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    builds = {"dvv_ops": C.build}
    if args.baseline:
        builds["dvv_ops_baseline"] = partial(build_baseline, args.baseline)
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        paths = dict(zip(builds, pool.map(lambda b: b(), builds.values())))
    for name in builds:
        info = _build.build_info[name]
        print(name, "nvcc seconds", info["seconds"], flush=True)
        print("\n".join(CS.ptxas_lines(str(info["log"]))), flush=True)
    baseline = C.load(paths["dvv_ops_baseline"]) if args.baseline else None
    order = ["baseline", "kernel", "kernel", "baseline"] if args.baseline \
        else ["kernel", "kernel"]

    for N, K, R in args.shapes or CS.KERNEL_SHAPES:
        rng = np.random.default_rng([args.seed, N, K, R])
        host = CS.clock_sets(rng, N, K, R)
        dev = [torch.from_numpy(a).cuda() for a in host]
        want_mask, want_ceil = ref.read_sweep_ref(*dev)
        nv = dev[3].sum(dim=1, dtype=torch.int64)
        sweep_ops = 2 * int((nv * (nv - 1)).sum()) * R * CS.OPS_PER_COLUMN
        sweep_in = N * K * (4 * R + 9)
        reps = max(2, args.reps // 10) if N >= 1 << 20 else args.reps
        for name, wrapper, nbytes, nops, front in (
                ("dvv_sync_mask", C.sync_mask, sweep_in + N * K, sweep_ops,
                 ops.BucketedSweep("cuda")),
                ("dvv_read_sweep", C.read_sweep, sweep_in + N * K + N * R * 8,
                 sweep_ops + N * K * R, ops.BucketedReadSweep("cuda"))):
            row = {"name": name, "shape": [N, K, R]}
            calls = {"kernel": partial(wrapper, *dev)}
            C.reset_launches()
            outs = {"kernel": (calls["kernel"](), [
                p for p, n in C.path_launches.items() if n][0])}
            if baseline is not None:
                calls["baseline"] = partial(baseline_call, name, baseline,
                                            dev)
                outs["baseline"] = calls["baseline"]()
            for lib_name, (got, path) in outs.items():
                got = got if isinstance(got, tuple) else (got,)
                row[f"{lib_name}_path"] = path
                row[f"{lib_name}_equal"] = bool(
                    torch.equal(got[0], want_mask) and
                    (len(got) == 1 or torch.equal(got[1], want_ceil)))
            for lib_name in order:
                row.setdefault(f"{lib_name}_ms", []).append(
                    CS.cuda_ms(calls[lib_name], reps))
                row.setdefault(f"{lib_name}_device_ms", []).append(
                    CS.kernel_device_ms(calls[lib_name], reps,
                                        name)["device_ms"])
            row["front_end_ms"] = CS.front_ms(front, host, reps)
            if C.tiled_path(N, K, R) == "tiled":
                row["wrapper_host_us"] = wrapper_breakdown(name, dev, reps)
            if args.baseline:
                legacy = partial(legacy_front, name, baseline, host)
                row["baseline_front_end_ms"] = CS.front_ms(
                    lambda: legacy(), (), reps)
            row["bound_ms"], row["bound_by"] = CS.bound(nbytes, nops)
            print(json.dumps(row), flush=True)
        del dev, want_mask, want_ceil
        torch.cuda.empty_cache()
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
