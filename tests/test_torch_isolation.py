"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor any module of the JAX package, initialises no CUDA
and starts no process group;
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
import torch.distributed as dist
print(json.dumps({
    "modules": names,
    "leaked": sorted(m for m in sys.modules
                     if m in ("jax", "repro") or m.startswith(("jax.",
                                                              "repro."))),
    "cuda_initialized": torch.cuda.is_initialized(),
    "process_group": dist.is_available() and dist.is_initialized(),
}))
"""


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.store.cluster" in got["modules"]
    for name in ("repro_torch.kernels.dvv_ops.dvv_ops",
                 "repro_torch.kernels.flash_attention.flash_attention",
                 "repro_torch.kernels.ssd_scan.ssd_scan",
                 "repro_torch.models.lm", "repro_torch.models.ssm",
                 "repro_torch.models.moe",
                 "repro_torch.launch.serve", "repro_torch.store.serving",
                 "repro_torch.store.gossip", "repro_torch.store.geo",
                 "repro_torch.store.failure", "repro_torch.store.services",
                 "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                 "repro_torch.ckpt.manager", "repro_torch.ckpt.shards",
                 "repro_torch.runtime.train_loop",
                 "repro_torch.runtime.simcluster",
                 "repro_torch.launch.train", "repro_torch.launch.steps",
                 "repro_torch.cluster.elastic",
                 "repro_torch.cluster.failure_detector",
                 "repro_torch.cluster.membership",
                 "repro_torch.cluster.stealer",
                 "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
                 "repro_torch.launch.partition",
                 "repro_torch.launch.roofline", "repro_torch.launch.sharding",
                 "repro_torch.models.sharding_ctx"):
        assert name in got["modules"]
    assert got["leaked"] == []
    assert got["cuda_initialized"] is False
    assert got["process_group"] is False


_WORKLOAD_PROBE = """
import json, sys
from repro_torch.launch import serve
rc = serve.main(["--store-workload", "--device", "cpu", "--sessions", "500",
                 "--keys", "40", "--store-steps", "30",
                 "--gossip-period", "5"])
import torch
print(json.dumps({
    "rc": rc,
    "leaked": sorted(m for m in sys.modules
                     if m in ("jax", "repro") or m.startswith(("jax.",
                                                              "repro."))),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


_TRAIN_PROBE = """
import json, sys, tempfile
from repro_torch.launch import train
rc = train.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--seq-len", "16", "--global-batch", "2",
                 "--ckpt-every", "1", "--ckpt-dir", tempfile.mkdtemp()])
import torch
print(json.dumps({
    "rc": rc,
    "leaked": sorted(m for m in sys.modules
                     if m in ("jax", "repro") or m.startswith(("jax.",
                                                              "repro."))),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_training_runs_without_jax_or_repro():
    """``launch.train --device cpu`` (the token pipeline's threefry, AdamW,
    the Trainer and its checkpoints in the store) with neither jax nor the
    JAX package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], env=env,
                         capture_output=True, text=True, check=True)
    assert "step      2" in out.stdout
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "leaked": [], "cuda_initialized": False}


def test_store_workload_runs_without_jax_or_repro():
    """``serve --store-workload --device cpu`` drives the port's serving
    plane, gossip and store with neither jax nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _WORKLOAD_PROBE], env=env,
                         capture_output=True, text=True, check=True)
    assert '"mode": "coalesced"' in out.stdout
    assert '"mode": "direct"' in out.stdout
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "leaked": [], "cuda_initialized": False}


_SCRIPT_PROBE = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("script", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
print(json.dumps({
    "leaked": sorted(m for m in sys.modules
                     if m in ("jax", "repro") or m.startswith(("jax.",
                                                              "repro."))),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/flash_attention_probe.py",
                                    "tools/flash_bwd_gate_probe.py",
                                    "tools/ssd_scan_probe.py"])
def test_chip_scripts_import_no_jax_and_no_repro(script):
    """The scripts that run on the card, loaded as modules (their main()
    not run), pull in neither jax nor the JAX package."""
    path = SRC.parent / script
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE, str(path)],
                         env=env, capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"leaked": [], "cuda_initialized": False}


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


def test_default_device_model_needs_a_card():
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache

    cfg = get_config("gemma2-9b").smoke()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_cache(cfg, 1, 8)
    assert init_cache(cfg, 1, 8, device="cpu")["layer0"]["k"].device.type \
        == "cpu"


def test_cpu_prefill_never_launches_a_kernel():
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = get_config("gemma2-9b").smoke()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flash_attention.reset_launches()
    logits = make_prefill_step(cfg)(
        params, {"tokens": torch.zeros((1, 32), dtype=torch.int32)})
    assert logits.shape == (1, 32, cfg.vocab_size)
    assert flash_attention.launches == {"flash_attention": 0}


def test_cpu_mamba_prefill_never_launches_a_kernel():
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = get_config("mamba2-780m").smoke()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flash_attention.reset_launches()
    ssd_scan.reset_launches()
    logits = make_prefill_step(cfg)(
        params, {"tokens": torch.zeros((1, 32), dtype=torch.int32)})
    assert logits.shape == (1, 32, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert ssd_scan.launches == {"ssd_scan": 0}
    assert flash_attention.launches == {"flash_attention": 0}


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
