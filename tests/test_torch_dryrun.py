"""The port's multi-device dry run against the JAX package's: the roofline
model, the partition rules, the activation-sharding context and the counted
cells.  Every run on a mesh (the port's fake process group, the JAX
package's forced host devices) goes in a subprocess with its own timeout,
so neither leaks into this test process."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import repro.launch.roofline as RR
import repro_torch.launch.roofline as TR
from repro.configs import REGISTRY as REF_REGISTRY, SHAPES as REF_SHAPES
from repro.launch.sharding import Sharder as RefSharder
from repro.launch import steps as ref_steps
from repro_torch.configs import REGISTRY, SHAPES, get_config
from repro_torch.launch import partition, steps
from repro_torch.launch.sharding import Sharder
from repro_torch.models import sharding_ctx
from repro_torch.models.lm import param_specs
from repro_torch.optim import AdamWConfig

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def run_json(*codes: str, timeout: int = 240) -> list:
    """Run each of ``codes`` in a fresh interpreter from the repo's root,
    all at once; each one's last stdout line is JSON."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for code in codes]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return outs


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

SYNTHETIC_HLO = textwrap.dedent("""
  %ag = bf16[16,1024]{1,0} all-gather(%x), replica_groups={}
  %ar.1 = f32[256]{0} all-reduce(%y), to_apply=%sum
  %fusion = f32[8,8]{1,0} fusion(%z), kind=kLoop
  %rs = (f32[32]{0}, f32[32]{0}) reduce-scatter(%a, %b)
  %a2a = s32[4,8]{1,0} all-to-all(%c)
  %cp = bf16[2,2]{1,0} collective-permute(%d)
""")


def test_collective_parsers_equal_the_reference():
    assert TR.collective_bytes_by_kind(SYNTHETIC_HLO) == \
        RR.collective_bytes_by_kind(SYNTHETIC_HLO)
    detailed = TR.collective_bytes_detailed(SYNTHETIC_HLO)
    assert detailed == RR.collective_bytes_detailed(SYNTHETIC_HLO)
    assert TR.correct_promoted_f32(detailed) == \
        RR.correct_promoted_f32(detailed)
    assert set(detailed) == set(KINDS)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_model_flops_equal_the_reference(arch):
    for name, shape in SHAPES.items():
        assert TR.model_flops(get_config(arch), shape) == \
            RR.model_flops(REF_REGISTRY[arch], REF_SHAPES[name])


def test_model_flops_moe_counts_active_only():
    cfg, shape = get_config("qwen3-moe-30b-a3b"), SHAPES["train_4k"]
    dense = 6 * cfg.param_count() * shape.global_batch * shape.seq_len
    assert TR.model_flops(cfg, shape) < 0.2 * dense


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e15, 1e12, 1e10), (1e12, 1e12, 1e12), (3e13, 2e9, 5e11)])
def test_roofline_report_is_the_reference_on_h100_constants(flops, nbytes,
                                                            coll):
    kw = dict(n_chips=256, flops_per_device=flops, bytes_per_device=nbytes,
              collective_bytes_per_device=coll)
    got = TR.roofline_report(cfg=get_config("gemma-2b"),
                             shape=SHAPES["train_4k"], **kw)
    want = RR.roofline_report(cfg=REF_REGISTRY["gemma-2b"],
                              shape=REF_SHAPES["train_4k"], **kw)
    assert set(got) == set(want)
    for term, ratio in (("compute_s", RR.PEAK_FLOPS / TR.PEAK_FLOPS),
                        ("memory_s", RR.HBM_BW / TR.HBM_BW),
                        ("collective_s", RR.LINK_BW / TR.LINK_BW)):
        assert got[term] == pytest.approx(want[term] * ratio, rel=1e-12)
    for key in ("model_flops", "hlo_flops_global", "useful_flops_ratio",
                "chips"):
        assert got[key] == want[key]
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert TR.cost_analysis_dict({"flops": flops, "bytes": nbytes}) == \
        {"flops": flops, "bytes accessed": nbytes}


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in leaves}


def _specs(tree):
    return {k: tuple(v) for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["train", "decode_tp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_partition_specs_equal_the_reference(arch, mesh, mode):
    """Parameters, optimizer state, batch, decode cache and logits: entry
    for entry the reference Sharder's PartitionSpecs (which read only the
    mesh's axis sizes, so an AbstractMesh stands in for 256 devices)."""
    shape, axes = MESHES[mesh]
    ref = RefSharder(AbstractMesh(shape, axes), REF_REGISTRY[arch], mode=mode)
    port = Sharder(dict(zip(axes, shape)), get_config(arch), mode=mode)
    assert _specs(_flat(port.param_pspecs())) == \
        _specs(_ref_flat(ref.param_pspecs()))
    for master in (False, True):
        assert _specs(_flat(port.opt_pspecs(with_master=master))) == \
            _specs(_ref_flat(ref.opt_pspecs(with_master=master)))
    for name, sh in SHAPES.items():
        cfg, ref_cfg = get_config(arch), REF_REGISTRY[arch]
        b = steps.batch_specs(cfg, sh)
        assert _specs(_flat(port.batch_pspecs(b))) == _specs(_ref_flat(
            ref.batch_pspecs(ref_steps.batch_specs(ref_cfg,
                                                   REF_SHAPES[name]))))
        if sh.kind == "decode" and cfg.is_decoder:
            d = steps.decode_input_specs(cfg, sh)
            rd = ref_steps.decode_input_specs(ref_cfg, REF_SHAPES[name])
            assert _specs(_flat(port.cache_pspecs(d["cache"]))) == \
                _specs(_ref_flat(ref.cache_pspecs(rd["cache"])))
            assert port.batch_pspecs({"t": d["tokens"]})["t"] == \
                tuple(ref.batch_pspecs({"t": rd["tokens"]})["t"])
    assert port.logits_pspec() == tuple(ref.logits_pspec())


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_equal_the_reference_shapes(arch):
    """``param_specs`` is a meta tree with the reference's names, shapes
    and dtypes, and draws from no random stream."""
    state = torch.random.get_rng_state()
    got = _flat(param_specs(get_config(arch)))
    assert torch.equal(state, torch.random.get_rng_state())
    from repro.models.lm import param_specs as ref_param_specs
    want = _ref_flat(ref_param_specs(REF_REGISTRY[arch]))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[1] == str(want[k].dtype), k


def test_input_specs_are_meta_stand_ins():
    cfg = get_config("qwen2-vl-7b")
    b = steps.input_specs(cfg, SHAPES["train_4k"])["batch"]
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in b.items()} == {
        "embeddings": ((256, 4096, cfg.d_model), torch.bfloat16, "meta"),
        "labels": ((256, 4096), torch.int32, "meta"),
        "positions": ((3, 256, 4096), torch.int32, "meta")}
    d = steps.input_specs(get_config("mamba2-780m"), SHAPES["long_500k"])
    assert d["pos"] == SHAPES["long_500k"].seq_len - 1
    assert d["cache"]["layer0"]["ssd"].device.type == "meta"
    p, o = steps.param_state_specs(get_config("gemma-2b"),
                                   AdamWConfig(master_weights=True))
    assert _flat(o["master"]).keys() == _flat(p).keys()
    assert all(t.dtype == torch.float32 for t in _flat(o["m"]).values())


# ---------------------------------------------------------------------------
# activation-sharding context
# ---------------------------------------------------------------------------

def test_helpers_are_identities_off_a_mesh():
    """With no context installed constrain returns its input itself; the
    dry run's local-shard stand-ins are torch's ops bitwise on tensors that
    are not DTensors, and closing the context puts every original back."""
    import importlib

    attention_mod, moe, ssm = (importlib.import_module(
        f"repro_torch.models.{name}") for name in ("attention", "moe", "ssm"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=g)
    w = torch.randn(8, 3, generator=g)
    table = torch.randn(11, 8, generator=g)
    ids = torch.randint(0, 11, (2, 5), generator=g)
    assert sharding_ctx.constrain(x, "batch", "model", None) is x
    assert partition.local_call(lambda a: a, (x,), ("bsd",), "bsd") is x
    names = [(torch, "einsum"), (torch.nn.functional, "embedding"),
             (torch, "gather"), (torch, "logsumexp"),
             (attention_mod, "gqa_flash_attention"),
             (attention_mod, "_group_q"), (ssm, "ssd_scan"), (moe, "assign")]
    before = [getattr(m, n) for m, n in names]
    want = (torch.einsum("bsd,df->bsf", x, w),
            torch.nn.functional.embedding(ids, table),
            torch.gather(x, -1, (ids % 8)[..., None]),
            torch.logsumexp(x, -1))
    with partition.partitioned():
        assert all(getattr(m, n) is not f for (m, n), f in zip(names, before))
        got = (torch.einsum("bsd,df->bsf", x, w),
               torch.nn.functional.embedding(ids, table),
               torch.gather(x, -1, (ids % 8)[..., None]),
               torch.logsumexp(x, -1))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(getattr(m, n) is f for (m, n), f in zip(names, before))


#: logical tuples of the model's call sites, on shapes that divide and that
#: do not divide the 2x4 mesh
CALL_SITES = [
    (("batch", "model", None), (8, 64, 32)),     # lm forward/groups, seq
    (("batch", None, None), (8, 64, 32)),        # groups without seq_shard
    (("batch", None, None), (3, 1, 32)),         # decode, batch indivisible
    (("batch", None, "model"), (8, 64, 40)),     # logits
    (("batch", None, "model"), (8, 64, 30)),     # logits, vocab indivisible
    (("batch", None, "tp"), (8, 1, 64)),         # mlp / mamba decode_tp
    (("batch", None, "tp"), (8, 1, 36)),         # tp indivisible
    (("batch", None, "model", "tpd"), (8, 1, 8, 16)),   # decode ctx
    (("batch", None, "model", "tpd"), (8, 1, 6, 3)),
]

PORT_CTX = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding_ctx import activation_sharding, constrain
SITES = json.loads(%r)
out = {}
for shape_m, axes in (((2, 4), ("data", "model")),
                      ((2, 2, 2), ("pod", "data", "model"))):
    mesh = make_mesh(shape_m, axes)
    batch_axes = axes[:-1]
    for mode in ("train", "decode_tp"):
        got = []
        with activation_sharding(mesh, batch_axes,
                                 replicate_batch=mode == "decode_tp"):
            for logical, shape in SITES:
                local = torch.empty(shape, device="meta")
                x = DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
                y = constrain(x, *logical)
                got.append([str(p) for p in y.placements])
        out["%%s/%%s" %% ("x".join(map(str, shape_m)), mode)] = got
print(json.dumps(out))
"""

REF_CTX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from jax.sharding import AxisType
import repro.models.sharding_ctx as ctx
SITES = json.loads(%r)
seen = []
jax.lax.with_sharding_constraint = lambda x, s: seen.append(s.spec) or x
out = {}
for shape_m, axes in (((2, 4), ("data", "model")),
                      ((2, 2, 2), ("pod", "data", "model"))):
    mesh = jax.make_mesh(shape_m, axes, axis_types=(AxisType.Auto,) * len(axes))
    for mode in ("train", "decode_tp"):
        got = []
        with ctx.activation_sharding(mesh, axes[:-1],
                                     replicate_batch=mode == "decode_tp"):
            for logical, shape in SITES:
                seen.clear()
                ctx.constrain(jax.ShapeDtypeStruct(tuple(shape), "float32"),
                              *logical)
                got.append([list(e) if isinstance(e, tuple) else e
                            for e in seen[0]] if seen else None)
        out["%%s/%%s" %% ("x".join(map(str, shape_m)), mode)] = got
print(json.dumps(out))
"""


def test_constrain_places_as_the_reference_on_a_mesh():
    """On fake 2x4 and 2x2x2 meshes, in train and decode_tp modes, the
    placements ``constrain`` gives each call site's logical axes are the
    reference's specs as placements (a call it leaves alone keeps the
    input's)."""
    from repro_torch.models.sharding_ctx import placements

    class Mesh:
        def __init__(self, axes):
            self.mesh_dim_names = axes

    sites = json.dumps(CALL_SITES)
    got, want = run_json(PORT_CTX % sites, REF_CTX % sites, timeout=120)
    assert set(got) == set(want) == {"2x4/train", "2x4/decode_tp",
                                     "2x2x2/train", "2x2x2/decode_tp"}
    for key, specs in want.items():
        axes = ("data", "model") if key.startswith("2x4") \
            else ("pod", "data", "model")
        for (logical, shape), spec, placed in zip(CALL_SITES, specs,
                                                  got[key]):
            if spec is None:      # left alone: the input's placements
                spec = [None] * len(shape)
            expect = [str(p) for p in placements(
                [tuple(e) if isinstance(e, list) else e for e in spec],
                Mesh(axes))]
            assert placed == expect, (key, logical, shape, spec)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

PORT_CELL = r"""
import json
from dataclasses import replace
from repro_torch.configs import get_config, SHAPES
from repro_torch.launch.dryrun import extrapolated_costs, lower_cell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import model_flops
mesh = make_mesh((2, 4), ("data", "model"))
cfg = replace(get_config("granite-8b").smoke(), remat=True)
shape = replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
counter, memory, _ = lower_cell(cfg, shape, mesh)
costs = extrapolated_costs(cfg, shape, mesh, counter=counter)
deep = replace(cfg, n_layers=2 * cfg.n_layers)
costs2 = extrapolated_costs(deep, shape, mesh)
print(json.dumps({**costs, **memory, "model_flops": model_flops(cfg, shape),
                  "ratio_flops": costs2["flops"] / costs["flops"],
                  "ratio_bytes": costs2["bytes"] / costs["bytes"]}))
"""

REF_CELL = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from dataclasses import replace
from jax.sharding import AxisType
from repro.configs import get_config, SHAPES
from repro.launch.dryrun import extrapolated_costs, lower_cell
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = replace(get_config("granite-8b").smoke(), remat=True)
shape = replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
_, compiled, _ = lower_cell(cfg, shape, mesh)
mem = compiled.memory_analysis()
costs = extrapolated_costs(cfg, shape, mesh)
print(json.dumps({**costs, "argument_bytes": mem.argument_size_in_bytes,
                  "temp_bytes": mem.temp_size_in_bytes}))
"""


def test_dry_run_counts_the_granite_smoke_cell_as_the_reference():
    """granite-8b smoke (remat) at train_4k cut to [4, 64] on 2x4: the
    port's per-device count against the JAX package's compiled cell on an
    Auto-axis mesh of 8 forced host devices."""
    port, ref = run_json(PORT_CELL, REF_CELL)
    print("port", json.dumps(port))
    print("reference", json.dumps(ref))
    assert port["flops"] >= port["model_flops"] / 8
    assert 0.5 <= port["flops"] / ref["flops"] <= 1.5
    assert 1.5 < port["ratio_flops"] < 2.5
    assert 1.5 < port["ratio_bytes"] < 2.5
    # one device's shards of the parameters, AdamW state and batch,
    # byte for byte the reference's arguments
    assert port["argument_bytes"] == ref["argument_bytes"]
    assert port["temp_bytes"] > 0 and port["bytes"] > 0
    assert set(port["collectives"]) <= set(KINDS)
    assert sum(port["collectives"].values()) > 0


HYBRID_CELLS = r"""
import json
from dataclasses import replace
from repro_torch.configs import get_config, SHAPES
from repro_torch.launch.dryrun import analyze, lower_cell
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
cfg = get_config("jamba-1.5-large-398b").smoke()
out = {}
for name, mode in (("prefill_32k", "train"), ("decode_32k", "decode_tp")):
    shape = replace(SHAPES[name], seq_len=64, global_batch=4)
    counter, memory, secs = lower_cell(cfg, shape, mesh, mode=mode)
    out[name] = analyze(cfg, shape, "single", memory, secs, counter.totals(),
                        n_chips=8)
print(json.dumps(out))
"""


def test_dry_run_prices_hybrid_prefill_and_decode_tp_cells():
    """jamba-1.5-large-398b's smoke config (attention, the SSD scan and
    MoE): a prefill cell and a decode_tp decode cell run to the end with
    every term above 0."""
    got, = run_json(HYBRID_CELLS)
    for name, cell in got.items():
        rl = cell["roofline"]
        assert rl["compute_s"] > 0 and rl["memory_s"] > 0 \
            and rl["collective_s"] > 0, (name, rl)
        assert set(cell["collectives"]) <= set(KINDS)
        assert cell["memory"]["argument_bytes"] > 0
        assert cell["memory"]["temp_bytes"] > 0


ONE_CHIP = r"""
import json
from dataclasses import replace
from repro_torch.configs import get_config, SHAPES
from repro_torch.launch.dryrun import price_cell
cfg = get_config("gemma-2b").smoke()
print(json.dumps(price_cell(cfg, replace(SHAPES["train_4k"], seq_len=64,
                                         global_batch=1))))
"""


def test_price_cell_prices_one_chip():
    """``price_cell`` (chip_smoke's one-chip estimates): a 1x1 mesh, so no
    collective, and the whole of the parameters and AdamW state are one
    device's arguments."""
    cell, = run_json(ONE_CHIP)
    assert cell["mesh"] == "1x1" and cell["roofline"]["chips"] == 1
    assert cell["collectives"] == {} and cell["roofline"]["collective_s"] == 0
    assert cell["roofline"]["compute_s"] > 0 and cell["roofline"]["bound"] \
        == "memory"
    assert cell["memory"]["argument_bytes"] > 0


def test_cli_list_equals_the_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    outs = [subprocess.run([sys.executable, "-m", f"{pkg}.launch.dryrun",
                            "--list"], capture_output=True, text=True,
                           timeout=120, env=env, cwd=ROOT, check=True).stdout
            for pkg in ("repro", "repro_torch")]
    assert outs[0] == outs[1]
    assert "gemma-2b" in outs[1]


def test_cli_cell_renders_in_the_roofline_table(tmp_path):
    """``--json`` writes the reference's keys, which
    benchmarks/roofline_table.py renders unchanged."""
    path = tmp_path / "out.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "gemma-2b", "--shape", "train_4k", "--mesh",
                    "single", "--json", str(path)], capture_output=True,
                   text=True, timeout=240, env=env, cwd=ROOT, check=True)
    cells = json.loads(path.read_text())
    assert len(cells) == 1 and cells[0]["roofline"]["chips"] == 256
    assert set(cells[0]) >= {"arch", "shape", "mesh", "compile_seconds",
                             "memory", "cost", "collectives", "roofline"}
    assert set(cells[0]["memory"]) == {"argument_bytes", "output_bytes",
                                       "temp_bytes", "peak_bytes"}
    table = subprocess.run([sys.executable, "benchmarks/roofline_table.py",
                            str(path)], capture_output=True, text=True,
                           timeout=60, cwd=ROOT, check=True).stdout
    assert "| gemma-2b | train_4k |" in table
    assert "worst-train-roofline: gemma-2b" in table


def test_kernel_front_ends_price_meta_tensors_through_plain_versions():
    from repro_torch.kernels.flash_attention import gqa_flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    q = torch.empty(1, 64, 4, 16, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, 64, 2, 16, device="meta", dtype=torch.bfloat16)
    out = gqa_flash_attention(q, kv, kv)
    assert out.device.type == "meta" and out.shape == q.shape
    xh = torch.empty(1, 64, 4, 8, device="meta")
    y, h = ssd_scan(xh, torch.empty(1, 64, 4, device="meta"),
                    torch.empty(4, device="meta"),
                    torch.empty(1, 64, 16, device="meta"),
                    torch.empty(1, 64, 16, device="meta"),
                    torch.empty(4, device="meta"), chunk=32)
    assert y.shape == xh.shape and h.shape == (1, 4, 8, 16)
    assert np.all([t.device.type == "meta" for t in (y, h)])
