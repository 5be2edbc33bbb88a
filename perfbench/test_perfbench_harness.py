"""The benchmark is data: a toy configuration, two toy mixes, their check
files and a toy per-layer metric, added as files and entries to a copy,
are found by name and run as cells on the CPU with no harness file
edited; and ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import re
from pathlib import Path

import pytest

from perfbench import testing
from perfbench.bench import spec

REPO = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
WIDTHS = re.compile(r"(^d_|_dim$|_rank$|^head|hidden|intermediate|latent|"
                    r"state|proj|expan|topk|^d_ff|^moe_d_ff)")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return testing.toy_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,trace", [("toy.toy_prefill", 0),
                                        ("toy.toy_prefill", 1),
                                        ("toy.toy_decode", 0),
                                        ("toy.toy_decode", 1)])
def test_a_cell_added_as_files_runs(toy, cell, trace):
    seconds = 0.0 if "prefill" in cell else 5.0
    rc, result, err = testing.run_cell(toy, cell, seconds=seconds,
                                       trace=trace)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    want = spec.load_cell(cell, toy)
    names = [m["name"] for m in (want.per_layer if trace
                                 else want.end_to_end)]
    if trace:
        # device readers read nothing on the CPU and are left out
        assert set(result["metrics"]) <= set(names)
        if "prefill" in cell:
            assert result["metrics"]["toy_tokens"]["value"] > 0
    else:
        assert sorted(result["metrics"]) == sorted(names)
        assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["attempted"] > 0 and result["failed"] == 0


def test_the_same_seed_draws_the_same_traffic(toy):
    from perfbench.bench import traffic
    mix = json.loads((toy / "perfbench/traffic/toy_decode.json")
                     .read_text())
    a = [next(traffic.decode_requests(mix, 2 ** 31 + 5, 512))
         for _ in range(1)]
    b = [next(traffic.decode_requests(mix, 2 ** 31 + 5, 512))
         for _ in range(1)]
    assert a == b
    one = traffic.prompts(testing.TOY_MIXES["toy_prefill"], 1)
    two = traffic.prompts(testing.TOY_MIXES["toy_prefill"], 2)
    first = sorted(next(one) for _ in range(4))
    assert first == sorted(next(two) for _ in range(4))


def test_a_run_without_a_card_prints_no_result(toy):
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, str(toy / "perfbench/run.py"), "--workload",
         "grok1-6l.prefill", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=toy)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_json_keeps_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and (REPO / c["file"]).is_file()
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    metrics = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    assert len(metrics) == len(b["end_to_end"]) + len(b["per_layer"])
    assert "setup_s" in metrics and metrics["setup_s"]["bound"] <= 0.25
    for m in metrics.values():
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert (REPO / "perfbench/metrics" / f"{m['name']}.py").is_file()
    seen = set()
    for w in b["workloads"]:
        assert NAME.fullmatch(w["name"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "perfbench/checks" / f"{w['name']}.json").is_file()
        assert (REPO / "perfbench/traffic" / f"{w['traffic']}.json").is_file()
        cell = spec.load_cell(w["name"], REPO)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    assert len(json.dumps(b)) <= 64 * 1024
