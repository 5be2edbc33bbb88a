"""The benchmark's model layer on the CPU: a draw rule for every leaf the
port builds (each configuration of ``repro_torch.configs``, published and
smoke sizes), Mamba-2's published initialisation, rules a configuration
file brings in ``init.leaves``; operation counts for every mixer and FFN
kind, windows as the port's mask keeps them; and, for the benchmark's own
configurations, the weights and counts they had before hybrids were
taken (golden values)."""
import dataclasses
import hashlib
import json
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from perfbench.bench import peaks, prefill, traffic
from perfbench.bench.model import draw_weights, program_config, rule
from perfbench.bench.spec import reader
from repro_torch.configs import REGISTRY
from repro_torch.models import lm, ssm
from repro_torch.models.attention import AttnSpec, _mask_bias
from repro_torch.models.lm import attn_spec, param_specs

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "perfbench"
SEED = 2 ** 31 + 33
SIZES = [(name, size) for name in sorted(REGISTRY)
         for size in ("published", "smoke")]


def leaves(node, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, node


def model_of(cfg):
    """A ``ModelConfig`` as a configuration file's ``model``."""
    model = dataclasses.asdict(cfg)
    model["pattern"] = [[s["mixer"], s["ffn"]] for s in model["pattern"]]
    return model


def port_config(name, size):
    cfg = REGISTRY[name]
    return cfg.smoke() if size == "smoke" else cfg


def harness_config(cfg, **init):
    return {"model": model_of(cfg), "init": dict({"embed_std": 0.02}, **init)}


def tree_hash(tree) -> str:
    h = hashlib.sha256()
    for path, t in leaves(tree):
        h.update(f"{path} {t.dtype} {tuple(t.shape)};".encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def reduced(name):
    """A benchmark configuration at small widths: the same leaves, names
    and dtypes (bf16), two layers."""
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    model = dict(config["model"])
    group = model["n_heads"] // model["n_kv_heads"]
    model.update(d_model=64, n_heads=2 * group, n_kv_heads=2, head_dim=16,
                 d_ff=96, vocab_size=320, n_layers=2)
    if model.get("moe_experts"):
        model["moe_d_ff"] = 80
    config = dict(config, model=model)
    return config, program_config(config)


# -- draw rules -------------------------------------------------------------

@pytest.mark.parametrize("name,size", SIZES)
def test_every_leaf_the_port_builds_has_a_rule(name, size):
    cfg = port_config(name, size)
    config = harness_config(cfg)
    kinds = Counter(rule(path, t.shape, config["model"], config["init"])[0]
                    for path, t in leaves(param_specs(cfg)))
    assert kinds["normal"] > 0 and kinds["const"] > 0
    assert (kinds["A_log"] > 0) == cfg.has_ssm


@pytest.mark.parametrize("init,A,dt", [
    ({}, (1.0, 16.0), (0.001, 0.1)),
    ({"A_range": [2.0, 4.0], "dt_min": 0.01, "dt_max": 0.02},
     (2.0, 4.0), (0.01, 0.02))])
def test_a_hybrid_draws_mamba2s_published_initialisation(init, A, dt):
    cfg = dataclasses.replace(REGISTRY["jamba-1.5-large-398b"].smoke(),
                              param_dtype="bfloat16")
    config = harness_config(cfg, **init)
    W = draw_weights(program_config(config), config, SEED,
                     torch.device("cpu"))
    specs = dict(leaves(param_specs(cfg)))
    got = dict(leaves(W))
    assert {p: (t.shape, t.dtype) for p, t in got.items()} == \
        {p: (t.shape, t.dtype) for p, t in specs.items()}
    mamba = [W["blocks"][k]["mamba"] for k in W["blocks"]
             if "mamba" in W["blocks"][k]]
    assert len(mamba) == 7
    for m in mamba:
        assert m["A_log"].dtype == m["dt_bias"].dtype == torch.float32
        a = -torch.exp(m["A_log"])
        assert a.min() >= -A[1] * (1 + 1e-6)
        assert a.max() <= -A[0] * (1 - 1e-6)
        step = F.softplus(m["dt_bias"])
        assert step.min() >= dt[0] * (1 - 1e-5)
        assert step.max() <= dt[1] * (1 + 1e-5)
        assert torch.equal(m["D"], torch.ones_like(m["D"]))
        for k in ("conv_bias_x", "conv_bias_B", "conv_bias_C"):
            assert not m[k].any()
        assert m["norm"].eq(1).all()
        # one draw a leaf: A and dt spread over their whole ranges
        assert a.unique().numel() == a.numel() > 1
    conv = mamba[0]["conv_x"].float()
    assert abs(conv.std().item() - cfg.ssm_conv_width ** -0.5) < 0.1


def test_a_hybrid_drawn_by_the_harness_runs_a_prefill():
    from repro_torch.launch.steps import make_prefill_step
    cfg = REGISTRY["jamba-1.5-large-398b"].smoke()
    config = harness_config(cfg)
    W = draw_weights(program_config(config), config, SEED,
                     torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab_size, (1, 48),
                         generator=torch.Generator().manual_seed(1))
    logits = make_prefill_step(cfg)(W, {"tokens": toks.int()})
    assert logits.shape == (1, 48, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert peaks.prefill_flops(config["model"], 48) > 0


def test_rules_in_init_leaves_are_applied(monkeypatch):
    cfg = REGISTRY["granite-8b"].smoke()
    extra = {"sink": torch.empty((2, 4), device="meta"),
             "gate_bias": torch.empty((2, 256, 128), device="meta"),
             "w_extra": torch.empty((2, 400, 64), device="meta"),
             "final_norm": torch.empty((64,), device="meta")}
    specs = param_specs(cfg)
    monkeypatch.setattr(lm, "param_specs", lambda c: dict(specs, **extra))
    config = harness_config(cfg, leaves={
        "sink": {"const": 0.5}, "gate_bias": {"std": 0.1},
        "w_extra": {"std": "fan_in"}, "final_norm": {"const": 2.0}})
    W = draw_weights(cfg, config, SEED, torch.device("cpu"))
    assert W["sink"].eq(0.5).all()
    assert abs(W["gate_bias"].std().item() / 0.1 - 1) < 0.02
    assert abs(W["w_extra"].std().item() * 400 ** 0.5 - 1) < 0.02
    assert W["final_norm"].eq(2.0).all()     # a rule given wins
    assert W["blocks"]["layer0"]["pre_norm"].eq(1).all()


def test_a_leaf_with_no_rule_raises_naming_it(monkeypatch):
    cfg = REGISTRY["granite-8b"].smoke()
    specs = param_specs(cfg)
    specs["blocks"]["layer0"]["attn"]["sinks"] = torch.empty(
        (cfg.n_groups, cfg.n_heads), device="meta")
    monkeypatch.setattr(lm, "param_specs", lambda c: specs)
    with pytest.raises(KeyError, match=r"blocks\.layer0\.attn\.sinks.*"
                                       r"'sinks'.*init\.leaves"):
        draw_weights(cfg, harness_config(cfg), SEED, torch.device("cpu"))


# -- the benchmark's configurations as they were (golden values) ------------

#: The reduced models' weights, seed 2**31 + 33, drawn by the harness as it
#: stood before the rules for hybrids were added.
GOLDEN_TREES = {
    "grok1-6l":
        "7b0c1075f8b717cf477f95224d376b38b93571cbd6fa7057b04e9e6708ce692d",
    "granite8b-128k":
        "6b99e3aca2b56a20409509802dc24112e1f6d237ec65791d9f818184666aae58",
}
#: ``prefill_flops`` at the strata of the prefill mixes, and a hash of its
#: values at every length 512..32,768, from the yardstick as it stood
#: before every mixer kind was counted.
GOLDEN_FLOPS = {
    "grok1-6l": ({
        512: 8807170179072, 714: 12292507680768, 913: 15731966164992,
        1100: 18969341952000, 1289: 22246581485568, 1484: 25633381122048,
        1694: 29286974373888, 1923: 33278542774272, 2181: 37784857264128,
        2476: 42949453774848, 2825: 49076004864000, 3255: 56649174220800,
        3811: 66481877188608, 4594: 80406310207488, 5878: 103435922522112,
        8192: 145553287544832, 8933: 159207211057152,
        10624: 190669371998208, 12634: 228615199899648,
        15024: 274510189559808, 17867: 330200986386432,
        21247: 397961713876992, 25268: 480767025119232,
        30048: 582304232374272},
        "df977115f67c9cdd131d97b88a0bb7c66d5a6aa6a3d46fbad56c3b6336ae5f09"),
    "granite8b-128k": ({
        512: 8323797614592, 714: 11650330460160, 913: 14950993035264,
        1100: 18073908019200, 1289: 21251180789760, 1484: 24551402373120,
        1694: 28130569420800, 1923: 32063213666304, 2181: 36530932875264,
        2476: 41687481974784, 2825: 47854224998400, 3255: 55551004508160,
        3811: 65664794886144, 4594: 80216973312000, 5878: 104863020417024,
        8192: 151735020552192, 8933: 167412202143744,
        10624: 204401163632640, 12634: 250561789624320,
        15024: 308550594723840, 17867: 381918112776192,
        21247: 475346755387392, 25268: 595270080528384,
        30048: 750236602466304},
        "85d8f64e88a1ab26c616bd7248369f5133332b8b2a9abc5b5f2bce080bcd9938"),
}
#: ``flash_roofline.prefill`` over one launch a stratum length and 1 s of
#: ``flash_fwd``, from the reader as it stood.
GOLDEN_FLASH = {"grok1-6l": 22.888465403787357,
                "granite8b-128k": 91.55510379596417}


def model_file(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "model"]


def strata():
    out = set()
    for mix in ("prefill", "prefill_long"):
        m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        out.update(traffic.quantile_lengths(m["prompt"], m["strata"]))
    return sorted(out)


@pytest.mark.parametrize("name", sorted(GOLDEN_TREES))
def test_the_benchmark_models_draw_the_weights_they_drew(name):
    config, cfg = reduced(name)
    W = draw_weights(cfg, config, SEED, torch.device("cpu"))
    assert tree_hash(W) == GOLDEN_TREES[name]


@pytest.mark.parametrize("name", sorted(GOLDEN_FLOPS))
def test_the_benchmark_models_count_the_operations_they_counted(name):
    model = model_file(name)
    at_strata, every = GOLDEN_FLOPS[name]
    assert strata() == sorted(at_strata)
    assert {S: peaks.prefill_flops(model, S) for S in at_strata} == \
        at_strata
    assert hashlib.sha256(",".join(
        str(peaks.prefill_flops(model, S)) for S in range(512, 32769)
    ).encode()).hexdigest() == every


class _Segment:
    def kernel_s(self, part):
        return 1.0


@pytest.mark.parametrize("name", sorted(GOLDEN_FLASH))
def test_the_flash_roofline_reads_what_it_read(name):
    read = reader(REPO, "flash_roofline.prefill")
    got = read({"kind": "prefill", "segment": _Segment(),
                "model": model_file(name), "segment_lengths": strata()})
    assert got == GOLDEN_FLASH[name]


# -- operation counts for every kind ----------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 3, 8, 40])
def test_window_pairs_equal_a_count_of_the_ports_mask(causal, window):
    for S in (1, 2, 7, 8, 9, 33):
        spec = AttnSpec(n_heads=1, n_kv_heads=1, head_dim=8,
                        sliding_window=window, causal=causal)
        pos = torch.arange(S)
        kept = int((_mask_bias(pos, pos, spec) == 0).sum())
        assert peaks.live_pairs(S, window, causal) == kept, S


@pytest.mark.parametrize("name,size", SIZES)
def test_attention_windows_are_the_ports(name, size):
    cfg = port_config(name, size)
    variants = [cfg]
    if not cfg.sliding_window and cfg.has_attention:
        # a window on every attention layer of a model without one: the
        # port windows ``attn`` only where the pattern has no mamba layer
        variants.append(dataclasses.replace(cfg, sliding_window=5))
    for c in variants:
        want = [attn_spec(c, s).sliding_window
                for _ in range(c.n_groups) for s in c.pattern
                if s.mixer.startswith("attn")]
        model = model_of(c)
        assert peaks.attention_windows(model) == want
        assert peaks.prefill_flops(model, 64) > 0
        assert all(x > 0 for x in peaks.flash_launch(model, 64, 5))


def test_a_windowed_layer_counts_its_window():
    model = model_of(REGISTRY["gemma2-9b"])
    W, S = model["sliding_window"], 8192
    assert W == 4096
    per_pair = 4 * model["n_heads"] * model["head_dim"]
    layers = model["n_layers"] // 2
    attn = layers * per_pair * (S * (S + 1) // 2) + layers * per_pair * (
        W * (W + 1) // 2 + (S - W) * W)
    assert peaks.prefill_flops(model, S) == \
        S * peaks.linear_flops_per_token(model) + attn


def test_a_bidirectional_model_counts_every_pair():
    model = model_of(REGISTRY["hubert-xlarge"])
    assert peaks.attention_flops(model, 100) == \
        4 * model["n_heads"] * model["head_dim"] * 100 * 100


def test_the_mamba_count_is_a_hand_count():
    cfg = REGISTRY["mamba2-780m"]
    model = model_of(cfg)
    # d 1,536; d_inner 3,072; N 128; 48 heads; filter 4
    projections = 2 * 1536 * (2 * 3072 + 2 * 128 + 48) + 2 * 3072 * 1536
    assert projections == 29245440
    conv, scan = 2 * 4 * (3072 + 2 * 128), 4 * 3072 * 128
    assert (conv, scan) == (26624, 1572864)
    assert peaks.mamba_flops_per_token(model) == 30844928
    assert peaks.linear_flops_per_token(model) == \
        48 * 30844928 + 2 * 1536 * 50280 == 1635016704
    assert peaks.prefill_flops(model, 4096) == 4096 * 1635016704
    # the projections are the port's matrices, two operations an element
    m = param_specs(cfg)["blocks"]["layer0"]["mamba"]
    assert projections == 2 * sum(
        m[k][0].numel() for k in ("in_z", "in_x", "in_B", "in_C", "in_dt",
                                  "out_proj"))


def test_a_moe_counts_its_expert_width_and_a_shared_expert():
    model = model_of(REGISTRY["qwen3-moe-30b-a3b"])
    d = model["d_model"]
    base = peaks.linear_flops_per_token(model)
    moe = dict(model, moe_d_ff=0)
    assert base - peaks.linear_flops_per_token(moe) == \
        model["n_layers"] * model["moe_topk"] * 6 * d * (
            model["moe_d_ff"] - model["d_ff"])
    shared = dict(model, moe_shared_d_ff=1536)
    assert peaks.linear_flops_per_token(shared) - base == \
        model["n_layers"] * 6 * d * 1536


def test_a_hybrid_prefill_traces_the_mamba_mixer():
    plain = prefill.trace_targets(program_config(
        {"model": model_file("grok1-6l")}))
    assert sorted(plain) == ["attention", "head", "moe.assign",
                             "moe.experts", "moe.route", "moe_ffn"]
    hybrid = prefill.trace_targets(REGISTRY["jamba-1.5-large-398b"])
    module, name = hybrid["mamba"]
    assert getattr(module, name) is ssm.ssm_forward
