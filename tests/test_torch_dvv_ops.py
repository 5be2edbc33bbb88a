"""The port's ``kernels.dvv_ops`` against the JAX package's Pallas kernels.

On the CPU the port's public functions run their plain torch versions; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does.  Outputs are bool and int, so they must be exactly equal.  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DVV
from repro.core import batched as RB
from repro.kernels import dvv_ops as ref_ops
from repro_torch.core import batched as TB
from repro_torch.kernels import dvv_ops as ops
from repro_torch.kernels.dvv_ops import ref

pytestmark = pytest.mark.torch


def _rand_clock(rng, universe):
    comps = []
    for r in universe:
        if rng.random() < 0.6:
            m = rng.randint(0, 6)
            if m > 0:
                comps.append([r, m, 0])
    if comps and rng.random() < 0.7:
        i = rng.randrange(len(comps))
        comps[i][2] = comps[i][1] + rng.randint(1, 3)
    return DVV(tuple(tuple(c) for c in comps if c[1] > 0 or c[2] > 0))


def _t(arrays, device="cpu"):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _pairs(n_replicas, n, seed):
    rng = random.Random(seed)
    universe = [f"r{i}" for i in range(n_replicas)]
    xs = [_rand_clock(rng, universe) for _ in range(n)]
    ys = [_rand_clock(rng, universe) for _ in range(n)]
    return (RB.encode_batch(xs, universe) + RB.encode_batch(ys, universe),
            xs, ys)


def _clock_sets(n_replicas, n_keys, max_versions, seed):
    """Per-key clock sets with invalid padding, as tests/test_kernels.py
    builds them."""
    rng = random.Random(seed)
    universe = [f"r{i}" for i in range(n_replicas)]
    vvs = np.zeros((n_keys, max_versions, n_replicas), np.int32)
    dids = np.full((n_keys, max_versions), RB.NO_DOT, np.int32)
    dns = np.zeros((n_keys, max_versions), np.int32)
    valid = np.zeros((n_keys, max_versions), bool)
    for i in range(n_keys):
        for j in range(rng.randint(0, max_versions)):
            vvs[i, j], dids[i, j], dns[i, j] = RB.encode(
                _rand_clock(rng, universe), universe)
            valid[i, j] = True
    return vvs, dids, dns, valid


def _grouped(N, K, R, seed=0):
    rng = np.random.default_rng(seed)
    vvs = rng.integers(0, 6, (N, K, R)).astype(np.int32)
    dids = rng.integers(-1, R, (N, K)).astype(np.int32)
    dns = np.where(
        dids >= 0,
        np.take_along_axis(vvs, np.clip(dids, 0, None)[..., None],
                           axis=-1)[..., 0] + rng.integers(1, 4, (N, K)),
        0).astype(np.int32)
    valid = rng.random((N, K)) < 0.8
    return vvs, dids, dns, valid


@pytest.mark.parametrize("n_replicas", [1, 3, 5, 9])
@pytest.mark.parametrize("n", [1, 17, 300])
def test_dvv_leq_matches_pallas(n_replicas, n):
    args, xs, ys = _pairs(n_replicas, n, n_replicas * 1000 + n)
    got = ops.dvv_leq(*_t(args)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_ops.dvv_leq(*_j(args))))
    np.testing.assert_array_equal(got, [x.leq(y) for x, y in zip(xs, ys)])


def test_dvv_leq_empty_universe():
    args, _, _ = _pairs(0, 5, 1)
    got = ops.dvv_leq(*_t(args)).numpy()
    assert got.shape == (5,) and got.all()
    np.testing.assert_array_equal(got, RB.leq_np(*args))


def test_dvv_concurrent_dominates_obsolete_match_pallas():
    args, xs, ys = _pairs(3, 200, 0)
    for name in ("dvv_concurrent", "dvv_dominates", "antientropy_obsolete"):
        np.testing.assert_array_equal(
            getattr(ops, name)(*_t(args)).numpy(),
            np.asarray(getattr(ref_ops, name)(*_j(args))), err_msg=name)
    np.testing.assert_array_equal(
        ops.dvv_dominates(*_t(args)).numpy(),
        [x.dominates(y) for x, y in zip(xs, ys)])


@pytest.mark.parametrize("n_replicas", [0, 1, 3, 9])
@pytest.mark.parametrize("n_keys,max_versions", [(1, 1), (19, 4), (40, 6)])
def test_dvv_sync_mask_matches_pallas(n_replicas, n_keys, max_versions):
    args = _clock_sets(n_replicas, n_keys, max_versions,
                       n_replicas * 7919 + n_keys + max_versions)
    got = ops.dvv_sync_mask(*_t(args)).numpy()
    np.testing.assert_array_equal(got, RB.sync_mask_np(*args))
    if n_replicas:          # the Pallas kernel pads R to 128 lanes; R=0 is
        np.testing.assert_array_equal(   # the numpy twin's alone
            got, np.asarray(ref_ops.dvv_sync_mask(*_j(args))))


@pytest.mark.parametrize("shape", [(9, 4, 5), (33, 3, 8), (4, 1, 2)])
def test_dvv_read_sweep_matches_pallas(shape):
    args = _grouped(*shape, seed=sum(shape))
    mask, ceil = ops.dvv_read_sweep(*_t(args))
    assert ceil.dtype == torch.int64
    want_mask, want_ceil = ref_ops.dvv_read_sweep(*args)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(ceil.numpy(), np.asarray(want_ceil))
    vvs, dids, dns, _ = args
    for n in range(shape[0]):
        s = np.flatnonzero(want_mask[n])
        np.testing.assert_array_equal(ceil[n].numpy(), RB.grouped_ceiling_np(
            vvs[n][s], dids[n][s], dns[n][s], np.zeros(len(s), np.int64),
            1)[0])


def test_pad_rows_are_inert():
    """Zero-filled invalid pad rows/columns change nothing about the real
    region: survival and ceilings, through the port's plain versions."""
    args = _grouped(13, 3, 5, seed=4)
    want_mask, want_ceil = ref.read_sweep_ref(*_t(args))
    for shape in [(16, 4, 8), (32, 8, 16), (128, 8, 128)]:
        mask, ceil = ops.dvv_read_sweep(*_t(TB.pad_sync_args(*args, shape)))
        assert torch.equal(mask[:13, :3], want_mask), shape
        assert torch.equal(ceil[:13, :5], want_ceil), shape
        assert not mask[13:].any() and not mask[:, 3:].any()
        assert not ceil[13:].any() and not ceil[:, 5:].any()


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 3, 4), (23, 4, 5),
                                   (40, 3, 9)])
def test_bucketed_front_ends_match_reference(shape):
    args = _grouped(*shape, seed=sum(shape))
    np.testing.assert_array_equal(
        ops.dvv_sync_mask_bucketed("cpu")(*args),
        ref_ops.dvv_sync_mask_bucketed(*args))
    mask, ceil = ops.dvv_read_sweep_bucketed("cpu")(*args)
    want_mask, want_ceil = ref_ops.dvv_read_sweep_bucketed(*args)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(ceil, want_ceil)
    assert ceil.dtype == want_ceil.dtype == np.int64


def test_bucketed_front_ends_are_shared_per_device_and_count():
    sweep = ops.BucketedReadSweep("cpu")
    sweep(*_grouped(5, 2, 3))            # -> bucket (8, 2, 8): miss
    sweep(*_grouped(7, 2, 5))            # same bucket: hit
    assert sweep.cache_info()["misses"] == 1
    assert sweep.cache_info()["hits"] == 1
    assert ops.dvv_sync_mask_bucketed("cpu") is \
        ops.dvv_sync_mask_bucketed("cpu")
    assert ops.dvv_read_sweep_bucketed("cpu") is not \
        ops.dvv_sync_mask_bucketed("cpu")


def test_cpu_tensors_never_count_as_launches():
    ops.reset_launches()
    ops.dvv_sync_mask(*_t(_grouped(4, 2, 3)))
    ops.dvv_read_sweep(*_t(_grouped(4, 2, 3)))
    assert ops.launches == {"dvv_sync_mask": 0, "dvv_read_sweep": 0,
                            "dvv_leq": 0}
