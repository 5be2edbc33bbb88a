"""The readers of the program's own spans (``bench/spans.py`` and the
metrics that read it): a toy MoE decode cell under ``--trace 1`` on the
CPU reads the host-clock metric and leaves the device ones out; the
reduction of a profiled segment, on a hand-built event list; a program
without the tracing module gives nothing to read; and no program span
shares a name with a range of the benchmark's own traced segment."""
import json
import re
from pathlib import Path

import pytest

from perfbench import testing
from perfbench.bench import spans

REPO = Path(__file__).resolve().parents[1]
HOST = ["decode_dispatch_ms_per_step"]
DEVICE = ["decode_syncs_per_step", "decode_launches_per_step",
          "decode_attention_ms_per_step", "decode_moe_ms_per_step",
          "attention_glue_us_per_tok.prefill", "moe_idle_us_per_tok.prefill"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy benchmark with the spans' metrics listing the toy MoE
    cells."""
    root = testing.toy_root(tmp_path_factory.mktemp("bench"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in HOST + DEVICE:
            kind = "decode" if m["name"].startswith("decode") else "prefill"
            m["workloads"].append(f"toy_moe.toy_{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_a_traced_toy_decode_reads_the_host_metric_and_no_device_one(toy):
    rc, result, err = testing.run_cell(toy, "toy_moe.toy_decode",
                                       seconds=3.0, trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    assert metrics["decode_dispatch_ms_per_step"]["value"] > 0
    assert metrics["decode_dispatch_ms_per_step"]["unit"] == "ms"
    assert not set(DEVICE) & set(metrics)
    line = next(json.loads(s)["program_spans"] for s in err.splitlines()
                if s.startswith('{"program_spans"'))
    # settle and segment (B): every session write queued its two copies,
    # and nothing delivered them
    counters = line["B"]["counters"]
    assert line["B"]["spans"]["serve.step"]["count"] == line["steps"] == 3
    writes = line["B"]["store"]["plane_writes"]
    assert writes > 0
    assert counters["store.replication_queued"] == 2 * writes
    assert counters.get("store.replication_delivered", 0) == 0
    assert 0 < counters["moe.pairs_kept"] <= counters["moe.pairs_routed"]


def test_a_program_without_tracing_gives_nothing_to_read(monkeypatch):
    import importlib.util
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "repro_torch.runtime.tracing"
                        else find(name, *a))
    run = {"kind": "decode"}
    for name in HOST + DEVICE:
        from perfbench.bench.spec import reader
        assert reader(REPO, name)(run) is None
    assert run["program_spans"] == {}


def test_the_reduction_of_a_hand_built_segment():
    # two steps; the host's clock in µs.  Step 1 holds a layer whose
    # attention launches two kernels and whose MoE launches one, then a
    # sync; step 2 one kernel and a copy out of a synchronised read.
    marks = [("serve.step", 0, 100), ("serve.step.dispatch", 1, 60),
             ("lm.layer", 2, 50), ("lm.decode_attention", 3, 20),
             ("lm.moe", 25, 45), ("lm.moe.assign", 30, 40),
             ("serve.step.sync", 61, 99),
             ("serve.step", 200, 300), ("serve.step.dispatch", 201, 250),
             ("serve.step.sync", 251, 299)]
    calls = [("cudaLaunchKernel", 5, 6, 1), ("cudaLaunchKernel", 10, 11, 2),
             ("cudaMemsetAsync", 32, 33, 3),
             ("cudaStreamSynchronize", 62, 98, 0),
             ("cudaLaunchKernel", 210, 211, 4),
             ("cudaMemcpyAsync", 252, 253, 5),
             ("cudaStreamSynchronize", 254, 298, 0),
             ("cudaGetDevice", 300, 301, 0)]
    ops = [("gemm", 20, 40, 1), ("softmax", 40, 45, 2),
           ("Memset (Device)", 70, 80, 3), ("gemm", 220, 260, 4),
           ("Memcpy DtoH", 262, 265, 5)]
    out = spans.reduce(marks, calls, ops)
    assert out["spans"]["serve.step"] == 2
    assert out["launches"] == {"serve.step": 5, "serve.step.dispatch": 4,
                               "lm.layer": 3, "lm.decode_attention": 2,
                               "lm.moe": 1, "lm.moe.assign": 1,
                               "serve.step.sync": 1}
    assert out["syncs"] == {"serve.step": 2, "serve.step.sync": 2}
    assert out["unlinked_ops"] == 0
    assert out["device_s"]["lm.decode_attention"] == {"gemm": 20e-6,
                                                      "softmax": 5e-6}
    assert out["device_s"]["lm.moe.assign"] == {"Memset (Device)": 10e-6}
    assert sum(out["device_s"]["serve.step"].values()) == pytest.approx(
        78e-6)
    assert out["busy_s"] == pytest.approx(78e-6)
    # gaps: 45-70 before the memset queued at 32, in the assignment; 80-220
    # before the gemm launched at 210, in the gap, whose middle (150) lies
    # between the steps; 260-262 before the copy queued at 252, in the sync
    assert out["idle_s"] == pytest.approx({
        "lm.moe.assign": 25e-6, spans.OUTSIDE: 140e-6,
        "serve.step.sync": 2e-6})
    # an operation whose launch the trace lost counts under no span
    lost = spans.reduce(marks, calls[1:], ops)
    assert lost["unlinked_ops"] == 1
    assert lost["device_s"]["lm.decode_attention"] == {"softmax": 5e-6}


def test_no_program_span_is_named_as_a_benchmark_range():
    from repro_torch.models.config import LayerSpec, ModelConfig
    from perfbench.bench import prefill
    program = set()
    for path in (REPO / "src/repro_torch").rglob("*.py"):
        program |= set(re.findall(r'\bspan\(\s*"([\w.]+)"', path.read_text()))
    assert {"serve.step", "serve.step.dispatch", "serve.step.sync",
            "serve.persist", "serve.admit", "lm.decode_attention", "lm.moe",
            "lm.moe.assign", "lm.layer", "store.put"} <= program
    cfg = ModelConfig(name="both", family="moe", n_layers=2, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8,
                      pattern=(LayerSpec("attn", "moe"),
                               LayerSpec("attn", "mlp")))
    labels = set(prefill.trace_targets(cfg))
    labels |= set(re.findall(r'"([\w.]+)": \(sched,', (
        REPO / "perfbench/bench/decode.py").read_text()))
    assert {"moe_ffn", "mlp", "decode_step", "session_persist"} <= labels
    assert not program & labels
