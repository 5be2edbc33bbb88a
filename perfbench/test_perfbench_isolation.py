"""What the benchmark's command loads: no JAX and no module of the JAX
package (``repro``) anywhere, and nothing of the port in the plain
reference.  Names are compared by their whole top-level part: the port,
``repro_torch``, begins with the JAX package's name."""
import json
import os
import subprocess
import sys
from pathlib import Path

from perfbench import testing

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, json, sys
sys.path[:0] = [{src!r}, {root!r}]
for name in {modules!r}:
    importlib.import_module(name)
if {readers}:
    from perfbench.bench import spec
    for m in json.load(open({bench!r}))["per_layer"]:
        spec.reader(spec.ROOT, m["name"])
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

COMMAND = ["perfbench.run", "perfbench.bench.check", "perfbench.bench.decode",
           "perfbench.bench.model", "perfbench.bench.peaks",
           "perfbench.bench.prefill", "perfbench.bench.spec",
           "perfbench.bench.trace", "perfbench.bench.traffic",
           "perfbench.reference.decoder",
           # what the drivers import of the port
           "repro_torch.launch.steps", "repro_torch.launch.serve",
           "repro_torch.models.lm", "repro_torch.models.moe",
           "repro_torch.store", "repro_torch.core"]


def top_level(modules, readers=False):
    code = PROBE.format(src=str(REPO / "src"), root=str(REPO),
                        modules=modules, readers=readers,
                        bench=str(REPO / "BENCHMARK.json"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_command_loads_no_jax_and_no_jax_package():
    names = top_level(COMMAND, readers=True)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    names = top_level(["perfbench.reference.decoder"])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_run_refuses_a_jax_module_by_its_top_level_name():
    from perfbench import run
    assert run.loaded_forbidden(["torch", "repro_torch.models.lm",
                                 "perfbench.run"]) == []
    assert run.loaded_forbidden(["jax.numpy", "repro.store", "flax",
                                 "repro_torchish"]) == ["flax", "jax",
                                                        "repro"]


JAX_READER = '''"""toy_loads_jax: a reader that loads a module named jax."""
import sys
from pathlib import Path


def read(run):
    sys.path.insert(0, str(Path(__file__).parent / "stub"))
    import jax  # noqa: F401
    return 1.0
'''


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    root = testing.toy_root(tmp_path)
    metrics = root / "perfbench" / "metrics"
    (metrics / "stub").mkdir()
    (metrics / "stub" / "jax.py").write_text("")
    (metrics / "toy_loads_jax.py").write_text(JAX_READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "toy_loads_jax", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "prefill step",
        "moves": "prefill_tokens_per_s", "workloads": ["toy.toy_prefill"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = subprocess.run(
        [sys.executable, "-c", testing.RUNNER, str(root), "", "0",
         "--workload", "toy.toy_prefill", "--seed", "5", "--seconds", "0",
         "--trace", "1"], capture_output=True, text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=""), timeout=600)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""
    assert "loaded jax" in proc.stderr
