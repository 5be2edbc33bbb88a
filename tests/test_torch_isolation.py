"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor any module of the JAX package, and initialises no CUDA;
a cluster left on its default device needs a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import torch
print(json.dumps({
    "modules": names,
    "leaked": sorted(m for m in sys.modules
                     if m in ("jax", "repro") or m.startswith(("jax.",
                                                              "repro."))),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.store.cluster" in got["modules"]
    assert "repro_torch.kernels.dvv_ops.dvv_ops" in got["modules"]
    assert got["leaked"] == []
    assert got["cuda_initialized"] is False


def test_default_device_cluster_needs_a_card():
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.store import KVCluster

    if torch.cuda.is_available():
        assert KVCluster(("a", "b"), DVV_MECHANISM).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            KVCluster(("a", "b"), DVV_MECHANISM)
    assert KVCluster(("a", "b"), DVV_MECHANISM,
                     device="cpu").device.type == "cpu"


def test_cpu_cluster_never_launches_a_kernel():
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.kernels.dvv_ops import launches, reset_launches
    from repro_torch.store import KVClient, KVCluster

    reset_launches()
    c = KVCluster(("a", "b", "c"), DVV_MECHANISM, replication=2,
                  device="cpu")
    cl = KVClient(c, "t", via="a")
    cl.put_many({f"k{i}": (i, None) for i in range(8)})
    c.deliver_replication()
    c.delta_antientropy_round()
    assert cl.get_many([f"k{i}" for i in range(8)])["k3"].values == (3,)
    assert set(launches.values()) == {0}
