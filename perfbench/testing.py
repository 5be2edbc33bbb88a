"""Support for the benchmark's CPU tests: a copy of the benchmark beside a
toy configuration, toy traffic mixes, their check files and a toy
per-layer metric, all added as files and entries (none of the copied
files is edited), and a way to run one of its cells on the CPU in a fresh
process, with a fault planted in the timed path if asked.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TOY_MODEL = dict(
    name="toy", family="dense", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
    pattern=[["attn", "mlp"]], attn_softcap=30.0, act="swiglu",
    tie_embeddings=True, rope_theta=10000.0, param_dtype="bfloat16",
    compute_dtype="bfloat16", remat=False)
#: grok1-6l's kind of model at a test's size: 8 experts top-2 with the
#: capacity rule, GeGLU, the embedding scaled by sqrt(d_model) and drawn
#: so that the scaled input has rms 0.02
TOY_MOE_MODEL = dict(
    TOY_MODEL, name="toy_moe", family="moe", pattern=[["attn", "moe"]],
    moe_experts=8, moe_topk=2, moe_d_ff=256, capacity_factor=1.25,
    embed_scale=True, act="geglu")
TOY_MOE_EMBED_STD = 0.02 / 128 ** 0.5
#: The toy decode cache holds 16,384 positions: on the CPU the decode
#: step's attention reads the whole cache, so a step's cost grows with
#: ``max_len``, and a 5 s window on one core reaches some 300 positions
#: (at 1,024, a run whose session writes were left out filled the cache
#: within the window)
TOY_MIXES = {
    "toy_prefill": {"kind": "prefill", "prompt": {
        "dist": "lognormal", "median": 64, "sigma": 0.5, "min": 16,
        "max": 160}, "strata": 4},
    "toy_decode": {"kind": "decode", "slots": 4, "max_len": 16384,
                   "output": {"dist": "uniform", "min": 2, "max": 9},
                   "strata": 8, "sessions": 50, "zipf": 0.9,
                   "store": {"nodes": 5, "n_val": 3, "r": 2, "w": 2,
                             "via": "n0"},
                   "trace_steps": 3, "record_every": 2},
}
#: Limits for the toy cells, from their CPU readings on five or six
#: seeds.  Dense: the bf16 program reads 0.008-0.011 (median logit error),
#: 0-0.0027 (prefill gaps) and 0.0008-0.0041 (served tokens' gaps); the
#: float8 control 0.113-0.158, 0.078-0.099 and 0.055-0.100; the planted
#: faults 1.39-1.45 (gaps) and every record missing.  MoE (grok's numbers):
#: the program reads 0.011-0.062 (worst prompt's median row error),
#: 0-0.0009 (mean prefill gap), 0.016-0.035 (mean decode row error) and
#: 0.0001-0.0003 (mean served gap); the control 0.17-0.42, 0.0026-0.0062,
#: 0.18-0.29 and 0.0015-0.0037.
TOY_CHECKS = {
    "toy.toy_prefill": {"sample": 2, "positions": 32, "limits": {
        "logit_err_median": 0.04, "top1_gap_max": 0.025}},
    "toy.toy_decode": {"sample": 4, "limits": {
        "session_records_missing": 0, "token_gap_max": 0.03,
        "logit_err_median": 0.04}},
    "toy_moe.toy_prefill": {"sample": 2, "positions": 32, "limits": {
        "logit_err_worst_median": 0.1, "top1_gap_mean": 0.0018}},
    "toy_moe.toy_decode": {"sample": 4, "limits": {
        "session_records_missing": 0, "logit_err_mean": 0.08,
        "token_gap_mean": 0.0007}},
}
TOY_METRIC = '''"""toy_tokens: the tokens the window's prompts held."""


def read(run):
    return float(run["tokens"]) if run.get("kind") == "prefill" else None
'''


def toy_root(dest: Path) -> Path:
    """A copy of the benchmark under ``dest`` with the toy cells added."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    os.symlink(REPO / "src", dest / "src")
    bench = dest / "perfbench"
    (bench / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "reference": "decoder", "model": TOY_MODEL,
         "init": {"embed_std": 0.02}}))
    (bench / "configs" / "toy_moe.json").write_text(json.dumps(
        {"name": "toy_moe", "reference": "decoder", "model": TOY_MOE_MODEL,
         "init": {"embed_std": TOY_MOE_EMBED_STD}}))
    for name, mix in TOY_MIXES.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, check in TOY_CHECKS.items():
        (bench / "checks" / f"{name}.json").write_text(json.dumps(check))
    (bench / "metrics" / "toy_tokens.py").write_text(TOY_METRIC)
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    cells = {}
    for config in ("toy", "toy_moe"):
        spec["configs"].append({"name": config, "source": "toy",
                                "file": f"perfbench/configs/{config}.json",
                                "reduced": [], "why": "a CPU toy"})
        for mix in TOY_MIXES:
            cells.setdefault(mix, []).append(f"{config}.{mix}")
            spec["workloads"].append({"name": f"{config}.{mix}",
                                      "config": config, "traffic": mix,
                                      "chips": 1, "why": "a CPU toy"})
    kinds = {"prefill_tokens_per_s": "toy_prefill",
             "decode_tokens_per_s": "toy_decode",
             "tpot_p95_ms": "toy_decode",
             "session_persist_ms": "toy_decode"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in kinds:
            m["workloads"].extend(cells[kinds[m["name"]]])
    spec["per_layer"].append({
        "name": "toy_tokens", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "prefill step",
        "moves": "prefill_tokens_per_s",
        "workloads": ["toy.toy_prefill"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


FAULTS = {
    # served tokens altered where the scheduler produces them: the
    # window's first step (after six warm-up steps) has its logits
    # negated, so each slot's first token is its worst
    "token": """
from repro_torch.launch import serve
make = serve.make_decode_step
def faulty(cfg):
    step, calls = make(cfg), [0]
    def run(params, cache, toks, pos):
        logits, cache = step(params, cache, toks, pos)
        calls[0] += 1
        if calls[0] == 7:
            logits.neg_()
        return logits, cache
    return run
serve.make_decode_step = faulty
""",
    # the decode step returns its state unchanged: the keys and values it
    # writes into the cache are undone after every step
    "state": """
from repro_torch.launch import serve
make = serve.make_decode_step
def faulty(cfg):
    step = make(cfg)
    def run(params, cache, toks, pos):
        saved = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in cache.items()}
        logits, cache = step(params, cache, toks, pos)
        for k, v in cache.items():
            for n, t in v.items():
                t.copy_(saved[k][n])
        return logits, cache
    return run
serve.make_decode_step = faulty
""",
    # half of the batch left out: the second half of the slots is served
    # the first half's logits
    "half": """
from repro_torch.launch import serve
make = serve.make_decode_step
def faulty(cfg):
    step = make(cfg)
    def run(params, cache, toks, pos):
        logits, cache = step(params, cache, toks, pos)
        n = logits.shape[0]
        logits[n - n // 2:] = logits[:n // 2].clone()
        return logits, cache
    return run
serve.make_decode_step = faulty
""",
    # one slot's state left unchanged: slot 1's keys and values are
    # undone after every step, the other slots' kept
    "slot": """
from repro_torch.launch import serve
make = serve.make_decode_step
def faulty(cfg):
    step = make(cfg)
    def run(params, cache, toks, pos):
        saved = {k: {n: t[:, 1].clone() for n, t in v.items()}
                 for k, v in cache.items()}
        logits, cache = step(params, cache, toks, pos)
        for k, v in cache.items():
            for n, t in v.items():
                t[:, 1].copy_(saved[k][n])
        return logits, cache
    return run
serve.make_decode_step = faulty
""",
    # half of a prompt left out: the positions past its middle get the
    # logits of the positions before it (as a kernel that fails past
    # some length would)
    "half_positions": """
from repro_torch.launch import steps
make = steps.make_prefill_step
def faulty(cfg):
    step = make(cfg)
    def run(params, batch):
        logits = step(params, batch)
        S = logits.shape[1]
        logits[:, S - S // 2:] = logits[:, :S // 2].clone()
        return logits
    return run
steps.make_prefill_step = faulty
""",
    # a prefill's answer altered where it is produced: the last
    # position's logits negated
    "answer": """
from repro_torch.launch import steps
make = steps.make_prefill_step
def faulty(cfg):
    step = make(cfg)
    def run(params, batch):
        logits = step(params, batch)
        logits[:, -1] = -logits[:, -1]
        return logits
    return run
steps.make_prefill_step = faulty
""",
    # session writes lost: the window's finished requests (the warm-up's
    # have negative ids) write nothing
    "session": """
from repro_torch.launch import serve
persist = serve.BatchScheduler._persist
def faulty(self, req):
    if req.rid < 0:
        persist(self, req)
serve.BatchScheduler._persist = faulty
""",
}

RUNNER = """
import sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
exec(sys.argv[2])
from perfbench import run
sys.exit(run.main(sys.argv[4:], root=root, device="cpu",
                  control=sys.argv[3] == "1"))
"""


def run_cell(root: Path, workload: str, *, seed: int = 2 ** 31 + 11,
             seconds: float = 0.0, trace: int = 0, fault: str = "",
             control: bool = False):
    """Run one cell of ``root`` on the CPU in a fresh process; returns
    (exit code, the result's JSON or None, standard error)."""
    # one thread: a toy decode window is wall-clock long, and runs side
    # by side must each get their steps into it
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, str(root), FAULTS.get(fault, ""),
         "1" if control else "0", "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines \
        else None
    return proc.returncode, result, proc.stderr
