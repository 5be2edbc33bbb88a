"""The port's store examples (``examples_torch/``) against the JAX
package's (``examples/``): each script run as a subprocess on the CPU
(``JAX_PLATFORMS=cpu`` for the reference, ``--device cpu`` for the port,
both with ``PYTHONHASHSEED=0``: ``shopping_cart.py`` prints Python sets)
prints the same lines.  The one exception is ``durable_restart.py``'s
write-ahead log byte counts (``WAL_LINES``): WAL bodies pickle each
package's own ``PackedPayload``, so those lines are held only for their
presence and their words.  The model examples are in
``test_torch_examples_models.py``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
STORE_EXAMPLES = ("kvstore_demo", "shopping_cart", "sharded_cluster",
                  "gossip_churn", "geo_replication", "durable_restart")
#: durable_restart.py's lines that count WAL bytes, by their start
WAL_LINES = ("  b's log: ", "  b crashed: crash at byte ", "  replayed ")
#: a 16-digit hex fingerprint, not the digits after a float's point
_HEX = re.compile(r"(?<![.\d])\b[0-9a-f]{16}\b")
_NUM = re.compile(r"-?\d+(?:[.,]\d+)*(?:e[+-]?\d+)?")


def run_example(package_dir: str, name: str, *args: str,
                timeout: float = 300.0) -> list:
    """The stdout lines of ``<package_dir>/<name>.py`` run from the repo
    root, the port's with ``--device cpu`` (two threads each: the suite
    runs files side by side)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="0",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    extra = ("--device", "cpu") if package_dir == "examples_torch" else ()
    out = subprocess.run(
        [sys.executable, str(ROOT / package_dir / f"{name}.py"), *args,
         *extra], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.splitlines()


def masked(line: str) -> str:
    """A line with its numbers and 16-digit hex fingerprints masked."""
    return _NUM.sub("#", _HEX.sub("<hex>", line))


@pytest.mark.parametrize("name", STORE_EXAMPLES)
def test_store_example_prints_the_reference_lines(name):
    want = run_example("examples", name)
    got = run_example("examples_torch", name)
    assert len(got) == len(want)
    wal = 0
    for g, w in zip(got, want):
        if name == "durable_restart" and w.startswith(WAL_LINES):
            assert masked(g) == masked(w)
            wal += 1
        else:
            assert g == w
    assert wal == (len(WAL_LINES) if name == "durable_restart" else 0)
