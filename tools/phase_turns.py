"""Time ``chip_smoke.py``'s serving phase of one model from two checkouts in
turns (A B B A) on one card, each turn in a process of its own, so that a
host that slows for a while shows in both.

    python tools/phase_turns.py OTHER_ROOT [--arch qwen3-moe-30b-a3b]

A is ``OTHER_ROOT`` (for example the parent commit unpacked with ``git
archive`` into a directory ``.gitignore`` lists), B this checkout.  Each
turn imports ``chip_smoke`` and ``repro_torch`` from its checkout (whose
kernels build there at first use), makes the model's parameters from the
seed and runs ``chip_smoke.model_phase``: a prefill, warm-up and timed,
then the phase's requests served through the ``BatchScheduler``.  It
prints the card's name and power limit, then one JSON line per turn: the
checkout, the timed prefill's seconds and the seconds a decode step.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = r"""
import json, sys
from dataclasses import replace
import torch
import chip_smoke as CS
from repro_torch.configs import get_config
from repro_torch.models import init_params
arch, seed = sys.argv[1], int(sys.argv[2])
cfg, kw = get_config(arch), {}
if arch == CS.MOE_ARCH:
    cfg = replace(cfg, param_dtype=CS.MOE_PARAM_DTYPE)
    kw = dict(phase="moe_model", tokens=CS.MOE_PREFILL)
elif arch != CS.ARCH:
    raise SystemExit(f"{arch}: only {CS.ARCH} and {CS.MOE_ARCH}")
gen = torch.Generator(device="cuda").manual_seed(seed)
out = CS.model_phase(cfg, init_params(gen, cfg), seed, **kw)
print(json.dumps({"prefill_s": out["prefill_s"]["timed"],
                  "s_per_decode_step": out["serve"]["s_per_decode_step"],
                  "decode_steps": out["serve"]["decode_steps"]}))
"""


def turn(root: Path, arch: str, seed: int, timeout: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", TURN, arch, str(seed)],
                          capture_output=True, text=True, env=env, cwd=root,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the A checkout's root")
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds for each turn")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for label, root in (("A", args.other.resolve()), ("B", ROOT),
                        ("B", ROOT), ("A", args.other.resolve())):
        got = turn(root, args.arch, args.seed, args.timeout)
        print(json.dumps({"turn": label, "root": str(root),
                          "arch": args.arch, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
