"""The port's completeness as a check: every public top-level name and
every public method of ``src/repro/**.py`` (read with ``ast``, never
imported) exists in the port module at the same path under
``src/repro_torch/`` (imported); the launchers ``launch/serve.py``,
``launch/train.py`` and ``launch/dryrun.py`` take every flag of the JAX
package's; and every ``examples/*.py`` has an ``examples_torch/`` twin
that takes its flags.  ``MAPPED`` lists the names the port carries under
another name or not at all, each with its reason."""
import ast
import importlib
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

#: (JAX package module, name) -> (the port's counterpart as "module:name",
#: or None, and the reason).
MAPPED = {
    ("kernels.dvv_ops.dvv_ops", "dvv_sync_mask_pallas"): (
        "kernels.dvv_ops.dvv_ops:sync_mask",
        "the Pallas kernel's entry point; the port's launches the CUDA "
        "kernel"),
    ("kernels.dvv_ops.dvv_ops", "dvv_leq_pallas"): (
        "kernels.dvv_ops.dvv_ops:leq",
        "the Pallas kernel's entry point; the port's launches the CUDA "
        "kernel"),
    ("kernels.dvv_ops.dvv_ops", "NO_DOT"): (
        "core.batched:NO_DOT",
        "the packed clocks' empty dot, which the port keeps in one place"),
    ("kernels.dvv_ops.dvv_ops", "LANES"): (
        None, "the TPU's 128 lanes, the Pallas blocks' width; the CUDA "
              "kernels tile by warps (csrc/dvv_ops.cu)"),
    ("kernels.dvv_ops.dvv_ops", "DEFAULT_BLOCK"): (
        None, "the Pallas grid's block of keys; the CUDA kernels choose "
              "their own tiles (dvv_ops.tiled_path)"),
    ("kernels.flash_attention.flash_attention", "flash_attention"): (
        "kernels.flash_attention.flash_attention:attend",
        "the Pallas kernel's entry point; the port's launches the CUDA "
        "kernel"),
    ("kernels.flash_attention.flash_attention", "NEG_INF"): (
        "kernels.flash_attention.ref:NEG_INF",
        "the masked score; the CUDA kernels hold it as kNegInf"),
    ("kernels.ssd_scan.ssd_scan", "ssd_scan_pallas"): (
        "kernels.ssd_scan.ssd_scan:scan",
        "the Pallas kernel's entry point; the port's launches the CUDA "
        "kernels"),
    ("launch.sharding", "Sharder.param_shardings"): (
        "launch.sharding:to_placements",
        "JAX NamedShardings of the parameters; DTensor placements in the "
        "port (nothing in the JAX package calls param_shardings)"),
}

LAUNCHERS = ("launch/serve.py", "launch/train.py", "launch/dryrun.py")
#: flags a port's script takes beyond the JAX package's
PORT_ONLY_FLAGS = {"--device", "--trace"}


def ref_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def module_name(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def public_surface(path: Path):
    """Public top-level names of a module's source, and each public class's
    public methods as "Class.method"."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            found = [node.name]
        elif isinstance(node, ast.Assign):
            found = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            found = [node.target.id]
        else:
            continue
        for name in found:
            if name.startswith("_"):
                continue
            names.append(name)
            if isinstance(node, ast.ClassDef):
                names += [f"{name}.{b.name}" for b in node.body
                          if isinstance(b, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not b.name.startswith("_")]
    return names


def resolve(module: str, dotted: str):
    obj = importlib.import_module(
        "repro_torch" + (f".{module}" if module else ""))
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def flags(path: Path):
    """The option strings of every ``add_argument`` call in a source."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("-")}
    return out


@pytest.mark.parametrize("rel", ref_modules())
def test_port_module_has_every_public_name(rel):
    module = module_name(rel)
    missing = []
    for name in public_surface(REF / rel):
        if (module, name) in MAPPED:
            target = MAPPED[(module, name)][0]
            if target is not None:
                resolve(*target.split(":"))
            continue
        try:
            resolve(module, name)
        except AttributeError:
            missing.append(name)
    assert not missing, f"repro_torch.{module} lacks {missing}"


def test_every_mapped_name_is_still_in_the_jax_package():
    """An entry of MAPPED whose name left the JAX package goes too."""
    for (module, name), (_, reason) in MAPPED.items():
        path = REF / (module.replace(".", "/") + ".py")
        assert name in public_surface(path), (module, name)
        assert reason


@pytest.mark.parametrize("rel", LAUNCHERS)
def test_launcher_takes_every_flag_of_the_jax_package(rel):
    ours = flags(ROOT / "src" / "repro_torch" / rel)
    assert flags(REF / rel) <= ours
    assert ours - flags(REF / rel) <= PORT_ONLY_FLAGS


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "examples").glob("*.py")))
def test_every_example_has_a_port_that_takes_its_flags(name):
    ours = ROOT / "examples_torch" / name
    assert ours.exists(), f"examples_torch/{name} is missing"
    theirs = flags(ROOT / "examples" / name)
    assert theirs <= flags(ours)
    assert "--device" in flags(ours)
