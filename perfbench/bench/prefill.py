"""The prefill driver: a closed loop of single-prompt prefills [1, S]
through the port's ``make_prefill_step`` (``lm.forward``: the embedding,
attention through the flash kernel, the MLP or the MoE, the head), one
after another, each ended by reading its first token.

Set-up draws the weights and runs one prefill at every length of the
mix's strata (the only shapes the window uses).  The window runs prompts
until ``seconds`` have passed and closes when the prompt then running
completes, so that it holds whole prompts, and at least the first block:
``prefill_tokens_per_s`` is the prompts' tokens over the window's
seconds.

Checked: a sample drawn from the seed of the first stratum block's
prompts, the longest among them, keeps the program's logits at a sample
of positions (the last always); once the window has closed and the
peak memory is read, the reference computes the same positions.  The
row errors are summed up over all the positions and prompt by prompt
(the worst prompt's median and mean).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import peaks, traffic
from .check import Outcome, gaps, rel_errs, summary, worst_group
from .model import draw_weights, program_config, sync
from .spec import reference
from .trace import trace

SAMPLE_STREAM, POSITION_STREAM = 11, 12


def sample_prompts(lengths, n: int, seed: int):
    """The longest prompt of the first block and ``n - 1`` others of it
    drawn from the seed."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    pick = traffic.rng(seed, SAMPLE_STREAM).choice(
        rest, size=min(n - 1, len(rest)), replace=False)
    return sorted([longest, *map(int, pick)])


def sample_positions(S: int, n: int, seed: int, index: int) -> torch.Tensor:
    pick = traffic.rng(seed, POSITION_STREAM, index).choice(
        S - 1, size=min(n - 1, S - 1), replace=False)
    return torch.tensor(sorted([*pick.tolist(), S - 1]), dtype=torch.long)


def trace_targets(cfg):
    from repro_torch.models import lm, moe
    targets = {"attention": (lm, "attention"), "head": (lm, "_head")}
    if any(s.ffn == "moe" for s in cfg.pattern):
        targets.update({"moe_ffn": (lm, "moe_ffn"),
                        "moe.route": (moe, "route"),
                        "moe.assign": (moe, "assign"),
                        "moe.experts": (moe, "experts")})
    if any(s.ffn == "mlp" for s in cfg.pattern):
        targets["mlp"] = (lm, "_mlp")
    if any(s.mixer == "mamba" for s in cfg.pattern):
        # ``ssm.ssm_forward`` as ``lm`` looks it up at each call
        targets["mamba"] = (lm, "ssm_forward")
    return targets


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        control: bool = False) -> Outcome:
    from repro_torch.launch.steps import make_prefill_step

    out = Outcome()
    out.at_s["port_imports"] = time.perf_counter() - t0
    model, mix = cell.config["model"], cell.mix
    cfg = program_config(cell.config)
    params = draw_weights(cfg, cell.config, seed, device)
    sync(device)
    out.at_s["weights"] = time.perf_counter() - t0
    step = make_prefill_step(cfg)
    V = model["vocab_size"]
    order = traffic.prompts(mix, seed)
    plan = [next(order) for _ in range(mix["strata"])]

    def prompt(i: int) -> torch.Tensor:
        while len(plan) <= i:
            plan.append(next(order))
        return torch.from_numpy(traffic.prompt_tokens(
            seed, i, plan[i], V)).to(device)[None]

    for S in sorted(set(plan), reverse=True):          # warm-up
        step(params, {"tokens": torch.zeros((1, S), dtype=torch.int32,
                                            device=device)})
    sync(device)
    out.e2e["setup_s"] = out.at_s["warm_up"] = time.perf_counter() - t0

    check = cell.check
    sample = sample_prompts(plan[:mix["strata"]], check["sample"], seed)
    kept = {}
    i = tokens = flops = 0
    start = time.perf_counter()
    while True:
        toks = prompt(i)
        logits = step(params, {"tokens": toks})
        int(torch.argmax(logits[0, -1]))          # the first token: syncs
        if i in sample:
            pos = sample_positions(plan[i], check["positions"], seed, i)
            kept[i] = (toks[0], pos, logits[0, pos.to(device)].clone())
        del logits
        tokens += plan[i]
        flops += peaks.prefill_flops(model, plan[i])
        i += 1
        now = time.perf_counter()
        if now - start >= seconds and i >= mix["strata"]:
            break
    window_s = now - start
    out.at_s["window"] = time.perf_counter() - t0
    out.attempted = i
    out.e2e["prefill_tokens_per_s"] = tokens / window_s
    out.layer.update(kind="prefill", device_type=device.type, model=model,
                     window_s=window_s, tokens=tokens, flops=flops)

    if traced:
        # the next whole block of strata: every run traces the same sizes
        n = mix["strata"]
        first = -(-i // n) * n
        inputs = [prompt(j) for j in range(first, first + n)]

        def segment():
            for toks in inputs:
                logits = step(params, {"tokens": toks})
                int(torch.argmax(logits[0, -1]))
                del logits

        out.segment = trace(segment, trace_targets(cfg), device)
        out.layer.update(segment=out.segment,
                         segment_lengths=plan[first:first + n])
    out.at_s["trace"] = time.perf_counter() - t0
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    Ref = reference(cell)
    seqs = [kept[j][0] for j in sample]
    keep = [kept[j][1].to(device) for j in sample]
    want = torch.cat(Ref(model, params).logits(
        seqs, keep, per_token_groups=False))
    got = torch.cat([kept[j][2] for j in sample])
    prompt_of = torch.cat([torch.full((len(k),), j) for j, k in
                           zip(sample, keep)])
    compare(out.numbers, got, want, prompt_of)
    out.numbers["positions_compared"] = float(got.shape[0])
    out.at_s["reference"] = time.perf_counter() - t0
    if control:
        low = torch.cat(Ref(model, params, "fp8").logits(
            seqs, keep, per_token_groups=False))
        compare(out.control, low, want, prompt_of)
    return out


def compare(numbers, got, want, prompt_of):
    """The logits' row errors over all the positions and by prompt, and
    how far each position's top token lies below the reference's best."""
    err = rel_errs(got, want)
    numbers.update(summary("logit_err", err))
    numbers.update(worst_group("logit_err", err, prompt_of))
    numbers.update(summary("top1_gap", gaps(want, got.argmax(-1))))
