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
from repro_torch.kernels.dvv_ops.ops import staging_layout

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


#: Shapes inside the store's buckets ([32..8192, 2..4, 8]: PERF.md §5's
#: store line), none on a bucket's edge, and the card tests' odd ones.
STORE_SHAPES = [(29, 2, 5), (61, 2, 3), (100, 3, 5), (1000, 4, 5),
                (2000, 2, 5), (4000, 3, 5), (8000, 2, 5), (1, 300, 0),
                (7, 300, 2), (1000, 9, 0)]


def _store_args(N, K, R, seed=0):
    """``_grouped``, also at R = 0 (no columns, so no dots)."""
    if R:
        return _grouped(N, K, R, seed)
    rng = np.random.default_rng(seed)
    return (np.zeros((N, K, 0), np.int32), np.full((N, K), -1, np.int32),
            np.zeros((N, K), np.int32), rng.random((N, K)) < 0.8)


def _padded_twin(args):
    """The numpy twin on the arrays padded to their bucket, cut back: the
    JAX package's front ends' result."""
    N, K, R = args[0].shape
    vvs, dids, dns, valid = TB.pad_sync_args(*args, TB.bucket_shape(N, K, R))
    mask = TB.sync_mask_np(vvs, dids, dns, valid)
    keys, slots = np.nonzero(mask)
    ceil = TB.grouped_ceiling_np(vvs[keys, slots], dids[keys, slots],
                                 dns[keys, slots], keys, len(vvs))
    return mask[:N, :K], ceil[:N, :R]


@pytest.mark.parametrize("shape", STORE_SHAPES)
def test_unpadded_front_ends_equal_padded_numpy_twin(shape):
    args = _store_args(*shape, seed=sum(shape))
    want_mask, want_ceil = _padded_twin(args)
    np.testing.assert_array_equal(ops.BucketedSweep("cpu")(*args), want_mask)
    mask, ceil = ops.BucketedReadSweep("cpu")(*args)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(ceil, want_ceil)
    assert mask.dtype == bool and ceil.dtype == np.int64


def test_staging_layout_is_aligned_and_ordered():
    for N, K, R in STORE_SHAPES + [(3, 1, 1)]:
        for ceil in (False, True):
            offs, in_bytes, out_off, out_bytes = staging_layout(N, K, R,
                                                                ceil)
            live = offs if ceil else offs[:5]
            assert all(o % 16 == 0 for o in live)
            assert offs[1] >= N * K * R * 4 and offs[4] >= offs[3] + N * K
            assert in_bytes == offs[3] + N * K and out_off == offs[4]
            assert out_bytes == (offs[5] - offs[4] + N * R * 8 if ceil
                                 else N * K)
            assert (offs[5] < 0) == (not ceil)


def test_staging_buffer_is_reused_as_shapes_grow_and_shrink():
    """The card's staging buffer, sized for each sweep in turn (on the
    CPU the front end itself stages nothing)."""
    front = ops.BucketedReadSweep("cpu")
    seen = []
    for shape in [(8000, 2, 5), (29, 2, 5), (1000, 4, 5), (8000, 2, 5),
                  (20000, 4, 8), (61, 2, 3), (20000, 4, 8)]:
        args = _store_args(*shape, seed=shape[0])
        mask, ceil = front(*args)
        want_mask, want_ceil = _padded_twin(args)
        np.testing.assert_array_equal(mask, want_mask)
        np.testing.assert_array_equal(ceil, want_ceil)
        _, _, out_off, out_bytes = staging_layout(*shape, True)
        host = front._staging(out_off + out_bytes)
        assert host.nbytes >= out_off + out_bytes
        seen.append(front._host.data_ptr())
    # one buffer until a sweep outgrows it, then the grown one for good
    assert len(set(seen[:4])) == 1 and len(set(seen[4:])) == 1
    assert seen[4] != seen[0]
    assert front.h2d_copies == front.d2h_copies == 0     # no card here


def test_front_ends_count_buckets_as_the_jax_package():
    import importlib
    jax_ops = importlib.import_module("repro.kernels.dvv_ops.ops")
    shapes = [(5, 2, 3), (7, 2, 5), (8, 2, 8), (100, 2, 5), (29, 3, 5),
              (31, 4, 8), (3, 1, 1), (5, 2, 3)]
    port = (ops.BucketedSweep("cpu"), ops.BucketedReadSweep("cpu"))
    jax_fronts = (RB.BucketedSyncMask(ref_ops.dvv_sync_mask, jit=False),
                  jax_ops.BucketedReadSweep())
    for shape in shapes:
        args = _store_args(*shape, seed=len(shape))
        for f in port + jax_fronts:
            f(*args)
    for mine, theirs in zip(port, jax_fronts):
        assert mine.cache_info() == theirs.cache_info()
        mine.reset_stats()
        assert mine.cache_info()["hits"] == mine.cache_info()["misses"] == 0
        assert mine.cache_info()["buckets"]


@pytest.mark.parametrize("n_replicas", [0, 1, 3, 9])
@pytest.mark.parametrize("n", [1, 17, 300])
def test_plain_oracles_equal_the_jax_packages(n_replicas, n):
    """ref.dominates_ref, concurrent_ref and leq_ref against the JAX
    package's kernels/dvv_ops/ref.py on the same packed clocks: exact."""
    from repro.kernels.dvv_ops import ref as jax_ref

    args, xs, ys = _pairs(n_replicas, n, 31 * n_replicas + n)
    for name in ("dominates_ref", "concurrent_ref", "leq_ref"):
        got = getattr(ref, name)(*_t(args))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jax_ref, name)(*_j(args))),
            err_msg=name)
    np.testing.assert_array_equal(ref.dominates_ref(*_t(args)).numpy(),
                                  [x.dominates(y) for x, y in zip(xs, ys)])
    np.testing.assert_array_equal(
        ref.concurrent_ref(*_t(args)).numpy(),
        [not x.leq(y) and not y.leq(x) for x, y in zip(xs, ys)])


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 3, 4), (23, 4, 5),
                                   (9, 2, 8), (64, 5, 13), (0, 3, 4)])
def test_sync_mask_bucketed_equals_the_jax_packages(shape):
    """core.batched.sync_mask_bucketed (the shared CPU instance, called on
    numpy arrays) against the JAX package's module-level instance, as
    tests/test_delta_sync.py holds that one."""
    args = _grouped(*shape, seed=sum(shape))
    got = TB.sync_mask_bucketed("cpu")(*args)
    assert got.dtype == bool and got.shape == shape[:2]
    np.testing.assert_array_equal(got, RB.sync_mask_bucketed(*args))
    np.testing.assert_array_equal(got, RB.sync_mask_np(*args))


def test_sync_mask_bucketed_counts_buckets_as_the_jax_package():
    """One instance per device, created without touching the device; a
    fresh instance of each package over the same run of shapes counts the
    same hits and misses and keeps the same buckets."""
    front = TB.sync_mask_bucketed("cpu")
    assert front is TB.sync_mask_bucketed(torch.device("cpu"))
    assert front.device == torch.device("cpu")
    assert TB.sync_mask_bucketed("meta") is not front
    mine, theirs = TB.BucketedSyncMask(device="cpu"), RB.BucketedSyncMask()
    for n, (N, K, R) in enumerate([(5, 2, 3), (7, 2, 5), (9, 2, 3),
                                   (3, 3, 9), (5, 2, 3), (40, 4, 4)]):
        args = _grouped(N, K, R, seed=n)
        np.testing.assert_array_equal(mine(*args), theirs(*args))
        assert mine.cache_info() == theirs.cache_info()
    mine.reset_stats()
    theirs.reset_stats()
    assert mine.cache_info() == theirs.cache_info()
