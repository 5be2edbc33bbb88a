"""The plain reference against the port on the CPU, at smoke widths of
each benchmark configuration (its pattern, activation, softcap, embedding
scale, rope theta and GQA ratio kept): prefill logits, the capacity rule
where it drops, and decode through the cache against the full forward."""
import json
from pathlib import Path

import pytest
import torch

from perfbench.bench.model import draw_weights, program_config
from perfbench.reference.decoder import Reference
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_cache
from repro_torch.models.moe import MoESpec, capacity

CONFIGS = sorted((Path(__file__).parent / "configs").glob("*.json"))
TOL = 2e-5          # float32 on both sides; logits are O(1)


def smoke(path, **over):
    """(the configuration file at smoke widths, the port's config)"""
    config = json.loads(path.read_text())
    model = dict(config["model"])
    group = model["n_heads"] // model["n_kv_heads"]
    model.update(d_model=64, n_heads=2 * group, n_kv_heads=2, head_dim=16,
                 d_ff=96, vocab_size=320, n_layers=2 * len(model["pattern"]),
                 param_dtype="float32", compute_dtype="float32")
    if model.get("moe_experts"):
        model["moe_d_ff"] = 80
    model.update(over)
    config = dict(config, model=model)
    return config, program_config(config)


def tokens(S, V, seed=5):
    return torch.randint(0, V, (S,), generator=torch.Generator()
                         .manual_seed(seed))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_prefill_logits_equal_the_port(path):
    config, cfg = smoke(path)
    model = config["model"]
    W = draw_weights(cfg, config, 2 ** 31 + 3, torch.device("cpu"))
    S = 97
    toks = tokens(S, model["vocab_size"])
    got = make_prefill_step(cfg)(W, {"tokens": toks[None].int()})[0]
    want = Reference(model, W).logits([toks], [torch.arange(S)],
                                      per_token_groups=False)[0]
    assert (got - want).abs().max().item() < TOL


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_decode_through_the_cache_equals_the_full_forward(path):
    config, cfg = smoke(path)
    model = config["model"]
    W = draw_weights(cfg, config, 7, torch.device("cpu"))
    S = 40
    toks = tokens(S, model["vocab_size"], seed=9)
    cache = init_cache(cfg, 1, S + 3, device="cpu")
    step = make_decode_step(cfg)
    got = []
    for p in range(S):
        logits, cache = step(W, cache, toks[p:p + 1].int(), p)
        got.append(logits[0])
    want = Reference(model, W).logits([toks], [torch.arange(S)],
                                      per_token_groups=True)[0]
    assert (torch.stack(got) - want).abs().max().item() < TOL


def test_capacity_rule_drops_as_the_port_does():
    path = next(p for p in CONFIGS
                if json.loads(p.read_text())["model"].get("moe_experts"))
    config, cfg = smoke(path, capacity_factor=0.5)
    model = config["model"]
    ref = Reference(model, draw_weights(cfg, config, 1, torch.device("cpu")))
    S = 128
    spec = MoESpec(n_experts=model["moe_experts"], top_k=model["moe_topk"],
                   d_ff=model["moe_d_ff"], capacity_factor=0.5)
    assert ref.capacity(S) == capacity(S, spec)
    h = torch.randn(S, model["d_model"], generator=torch.Generator()
                    .manual_seed(3))
    layer = {k: v[0] for k, v in
             ref.w["blocks"]["layer0"]["moe"].items()}
    _, _, kept = ref.routes(layer, h, per_token=False)
    assert 0 < int((~kept).sum()) < kept.numel()
    toks = tokens(S, model["vocab_size"], seed=4)
    got = make_prefill_step(cfg)(ref.w, {"tokens": toks[None].int()})[0]
    want = ref.logits([toks], [torch.arange(S)], per_token_groups=False)[0]
    assert (got - want).abs().max().item() < TOL


def test_control_rounds_to_float8():
    config, cfg = smoke(CONFIGS[0])
    model = config["model"]
    W = draw_weights(cfg, config, 2, torch.device("cpu"))
    toks = tokens(33, model["vocab_size"])
    keep = [torch.arange(33)]
    exact = Reference(model, W).logits([toks], keep,
                                       per_token_groups=False)[0]
    low = Reference(model, W, "fp8").logits([toks], keep,
                                            per_token_groups=False)[0]
    err = ((low - exact).norm(dim=-1) / exact.norm(dim=-1)).median()
    assert 0.02 < err.item() < 0.5
