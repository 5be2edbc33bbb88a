"""The hand-written dvv_ops CUDA kernels against their plain torch versions,
on the card.  Imports neither jax nor the JAX package, so it runs on a
machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m torch tests/test_torch_cuda.py

Every test needs a CUDA device (the kernels have no CPU mode) and skips
without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DVV_MECHANISM
from repro_torch.core import batched as TB
from repro_torch.kernels.dvv_ops import ops, ref
from repro_torch.store import KVClient, KVCluster

pytestmark = pytest.mark.torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dvv_ops kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _grouped(N, K, R, seed=0):
    rng = np.random.default_rng(seed)
    vvs = rng.integers(0, 6, (N, K, R)).astype(np.int32)
    dids = rng.integers(-1, R, (N, K)).astype(np.int32) if R else \
        np.full((N, K), -1, np.int32)
    dns = np.zeros((N, K), np.int32)
    if R:
        dns = np.where(dids >= 0, np.take_along_axis(
            vvs, np.clip(dids, 0, None)[..., None], axis=-1)[..., 0]
            + rng.integers(1, 4, (N, K)), 0).astype(np.int32)
    valid = rng.random((N, K)) < 0.8
    return vvs, dids, dns, valid


def _t(arrays, device):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("shape", [(1, 1, 1), (19, 4, 3), (4096, 4, 8),
                                   (1000, 9, 0), (300, 40, 5), (7, 300, 2)])
def test_kernels_equal_plain_versions(cuda, shape):
    on_card = _t(_grouped(*shape, seed=sum(shape)), cuda)
    ops.reset_launches()
    mask = ops.dvv_sync_mask(*on_card)
    smask, ceil = ops.dvv_read_sweep(*on_card)
    torch.cuda.synchronize()
    want_mask, want_ceil = ref.read_sweep_ref(*on_card)
    assert torch.equal(mask, want_mask) and torch.equal(smask, want_mask)
    assert torch.equal(ceil, want_ceil)
    vvs, dids, dns, _ = on_card
    pairs = (vvs[:, 0].contiguous(), dids[:, 0].contiguous(),
             dns[:, 0].contiguous(), vvs[:, -1].contiguous(),
             dids[:, -1].contiguous(), dns[:, -1].contiguous())
    assert torch.equal(ops.dvv_leq(*pairs), ref.leq_ref(*pairs))
    assert ops.launches == {"dvv_sync_mask": 1, "dvv_read_sweep": 1,
                            "dvv_leq": 1}


def test_padded_buckets_equal_numpy_twin(cuda):
    args = _grouped(13, 3, 5, seed=4)
    want = TB.sync_mask_np(*args)
    np.testing.assert_array_equal(ops.dvv_sync_mask_bucketed(cuda)(*args),
                                  want)
    mask, ceil = ops.dvv_read_sweep_bucketed(cuda)(*args)
    np.testing.assert_array_equal(mask, want)
    for n in range(13):
        s = np.flatnonzero(want[n])
        np.testing.assert_array_equal(ceil[n], TB.grouped_ceiling_np(
            args[0][n][s], args[1][n][s], args[2][n][s],
            np.zeros(len(s), np.int64), 1)[0])


def test_wrapper_rejects_bad_inputs(cuda):
    vvs, dids, dns, valid = _t(_grouped(8, 2, 3), cuda)
    with pytest.raises(TypeError):
        ops.dvv_sync_mask(vvs.long(), dids, dns, valid)
    with pytest.raises(ValueError):
        ops.dvv_sync_mask(vvs.transpose(0, 1), dids, dns, valid)
    with pytest.raises(ValueError):
        ops.dvv_sync_mask(vvs, dids.cpu(), dns, valid)


def test_cluster_on_the_card_launches_the_kernels(cuda):
    ops.reset_launches()
    c = KVCluster(("a", "b", "c"), DVV_MECHANISM, replication=2,
                  read_quorum=2, shards=2)
    cl = KVClient(c, "t", via="a")
    keys = [f"k{i}" for i in range(64)]
    cl.put_many({k: (k, None) for k in keys})
    c.deliver_replication()
    c.delta_antientropy_round()
    got = cl.get_many(keys)
    assert all(got[k].values == (k,) for k in keys)
    assert ops.launches["dvv_sync_mask"] > 0
    assert ops.launches["dvv_read_sweep"] > 0
