"""Local-shard stand-ins for what DTensor cannot partition, installed only
while the dry run (``launch/dryrun.py``) counts a cell.

The models call torch's own ops and the kernels' front ends, and know of a
mesh only through ``models/sharding_ctx.constrain``.  Where XLA's SPMD
partitioner would partition one of these calls and DTensor's rules cannot
(its view rules refuse to split a sharded dim that an einsum's
decomposition flattens; its gather replicates the logits, and the gather's
gradient allocates them whole on every rank; the kernels' plain versions
reshape freely; the MoE's capacity assignment is an ``index_put`` it has no
rule for), ``partitioned()`` puts a version that computes on the local
shards in its place:

  * torch's ops, on ``DTensor``s: ``torch.einsum`` keeps one index
    sharded on each mesh dim (see ``local_call``); ``F.embedding`` looks
    ids up in this rank's rows of a vocab-sharded table (ids outside them
    read zeros) and ``torch.gather`` along the last dim picks in this
    rank's columns, each a partial sum over the vocab's shards, as
    Megatron's vocab-parallel embedding and XLA's partitioned gather
    compute them; ``torch.logsumexp`` over a sharded last dim becomes
    max-shifted sums that DTensor reduces as partial results;
  * four Python functions the models call by name (the attention and SSD
    front ends, ``moe.assign``, decode's grouping of the query heads):
    ``local_call``s of the originals on whole batch rows and heads
    (attention also on query rows, with index masks; ``assign`` on whole
    groups).

Off the context every call is torch's or the model's own: no path on the
card opens it.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_call(fn: Callable, args: Sequence, subs: Sequence[Optional[str]],
               out_subs, allowed: Optional[str] = None,
               shard_index: bool = False):
    """``fn(*args)`` on the local shards of ``DTensor``s.

    ``subs[i]`` names the dims of ``args[i]`` by letters (None for an
    argument that is not a tensor), ``out_subs`` those of the output (a
    string, or a tuple of strings for a tuple of outputs).  Each mesh dim
    keeps at most one letter sharded, of those in ``allowed`` (all when
    None): the one whose arguments are largest among those already sharded
    on it, provided every argument's dim of that letter divides.  Each
    argument is redistributed so that the letter is sharded on that mesh
    dim wherever it names a dim and replicated elsewhere.  An output's
    dim of a kept letter is sharded; a kept letter the output lacks makes
    it a partial sum (``fn`` must be linear in it, as a contraction is).
    With ``shard_index``, ``fn`` also gets ``shard_index={letter: (index,
    count)}``: which of the ``count`` shards of each kept letter this rank
    holds.  With no ``DTensor`` argument it is ``fn(*args)``."""
    if not any(_is_dtensor(a) for a in args):
        return fn(*args, shard_index={}) if shard_index else fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(a for a in args if _is_dtensor(a)).device_mesh
    sizes = list(mesh.shape)
    tensors = [(a, sub) for a, sub in zip(args, subs)
               if isinstance(a, torch.Tensor)]

    def fits(letter: str, ways: int) -> bool:
        return all(a.shape[i] % ways == 0 for a, sub in tensors
                   for i, c in enumerate(sub) if c == letter)

    plan: list = []
    for m in range(mesh.ndim):
        weight: dict = {}
        for a, sub in tensors:
            if _is_dtensor(a) and a.placements[m].is_shard():
                c = sub[a.placements[m].dim]
                weight[c] = weight.get(c, 0) + a.to_local().numel()
        chosen = None
        for c in sorted(weight, key=lambda c: -weight[c]):
            ways = sizes[m] * math.prod(
                sizes[j] for j, cj in enumerate(plan) if cj == c)
            if (allowed is None or c in allowed) and fits(c, ways):
                chosen = c
                break
        plan.append(chosen)

    def placed(sub: str, partial):
        return [Shard(sub.index(c)) if c is not None and c in sub else
                (partial() if c is not None else Replicate())
                for c in plan]

    locals_ = []
    for a, sub in zip(args, subs):
        if not isinstance(a, torch.Tensor):
            locals_.append(a)
            continue
        if not _is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = tuple(placed(sub, Replicate))
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        # the gradient of an argument that lacks a kept letter sums over
        # that letter's shards: a partial sum
        locals_.append(a.to_local(grad_placements=placed(sub, Partial)))
    if shard_index:
        coord = mesh.get_coordinate()
        index: dict = {}
        for m, c in enumerate(plan):
            if c is not None:
                i, n = index.get(c, (0, 1))
                index[c] = (i * sizes[m] + coord[m], n * sizes[m])
        out = fn(*locals_, shard_index=index)
    else:
        out = fn(*locals_)

    def wrap(t, sub):
        shape = list(t.shape)
        for m, c in enumerate(plan):
            if c is not None and c in sub:
                shape[sub.index(c)] *= sizes[m]
        stride, n = [], 1
        for d in reversed(shape):
            stride.append(n)
            n *= d
        return DTensor.from_local(t, mesh, placed(sub, Partial),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(reversed(stride)))

    if isinstance(out_subs, str):
        return wrap(out, out_subs)
    return tuple(wrap(t, sub) for t, sub in zip(out, out_subs))


# ---------------------------------------------------------------------------
# torch's ops on DTensors
# ---------------------------------------------------------------------------

def _einsum(equation: str, *operands):
    ins, out = equation.replace(" ", "").split("->")
    return local_call(lambda *xs: torch.einsum(equation, *xs), operands,
                      ins.split(","), out)


def _embedding(ids, table, padding_idx=None, max_norm=None, norm_type=2.0,
               scale_grad_by_freq=False, sparse=False):
    if padding_idx is not None or max_norm is not None:
        raise NotImplementedError("the dry run's embedding takes no "
                                  "padding_idx or max_norm")

    def lookup(ids, table, shard_index):
        index, _ = shard_index.get("v", (0, 1))
        rows = table.shape[0]
        local = ids - index * rows
        inside = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(inside, local, 0), table)
        return out * inside[..., None].to(out.dtype)

    lead = "bcefg"[:ids.ndim]
    return local_call(lookup, (ids, table), (lead, "vd"), lead + "d",
                      shard_index=True)


def _gather(x, dim, index, *, sparse_grad=False):
    if dim % x.ndim != x.ndim - 1 or sparse_grad:
        return NotImplemented

    def take(x, index, shard_index):
        first, _ = shard_index.get("v", (0, 1))
        cols = x.shape[-1]
        local = index.long() - first * cols
        inside = (local >= 0) & (local < cols)
        got = torch.gather(x, -1, torch.where(inside, local, 0))
        return got * inside.to(got.dtype)

    lead = "bcefg"[:x.ndim - 1]
    return local_call(take, (x, index), (lead + "v", lead + "k"), lead + "k",
                      allowed=lead + "v", shard_index=True)


def _logsumexp(x, dim, keepdim=False):
    if (dim % x.ndim != x.ndim - 1 or keepdim
            or not any(p.is_shard(x.ndim - 1) for p in x.placements)):
        return NotImplemented
    m = x.detach().amax(dim=-1, keepdim=True)
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def _on_dtensors(version):
    """A maker of ``original``'s stand-in: ``version`` where an argument is
    a ``DTensor`` and it covers the call (it returns NotImplemented where
    it does not), else ``original``."""
    def make(original):
        @functools.wraps(original)
        def call(*args, **kwargs):
            if any(_is_dtensor(t) for t in tree_leaves((args, kwargs))):
                out = version(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            return original(*args, **kwargs)
        return call
    return make


# ---------------------------------------------------------------------------
# Python functions the models call by name
# ---------------------------------------------------------------------------

def _attention(original):
    def gqa_flash_attention(q, k, v, *, positions=None, **kw):
        def attend(q, k, v, pos, shard_index):
            # index masks count query rows from 0: right for the rank that
            # holds the first rows, which is the rank the dry run prices
            if shard_index.get("q", (0, 1))[0] != 0:
                raise NotImplementedError(
                    "attention on split query rows masks by index from 0; "
                    "only the rank holding the first rows is priced")
            return original(q, k, v, positions=pos, **kw)

        return local_call(attend, (q, k, v, positions),
                          ("bqhd", "bshd", "bshd", "s"), "bqhd",
                          allowed="bhq" if positions is None else "bh",
                          shard_index=True)
    return gqa_flash_attention


def _ssd_scan(original):
    def ssd_scan(xh, dt, A, Bc, Cc, D, *, chunk: int = 128):
        return local_call(lambda *a: original(*a, chunk=chunk),
                          (xh, dt, A, Bc, Cc, D),
                          ("bshp", "bsh", "h", "bsn", "bsn", "h"),
                          ("bshp", "bhpn"), allowed="bh")
    return ssd_scan


def _group_q(original):
    def group_q(q, n_kv: int):
        # the grouped reshape of the heads, which DTensor cannot split
        # unless the KV heads divide the shards: the heads whole
        return local_call(lambda q: original(q, n_kv), (q,), ("bshd",),
                          "bskgd", allowed="bsd")
    return group_q


def _assign(original):
    def assign(expert_idx, gate_vals, n_experts, C, dtype):
        return local_call(
            lambda idx, gates: original(idx, gates, n_experts, C, dtype),
            (expert_idx, gate_vals), ("gsk", "gsk"), ("gsec", "gsec", ""),
            allowed="g")
    return assign


@contextlib.contextmanager
def partitioned():
    """While open, the functions named above compute on the local shards
    of ``DTensor``s.  Each is replaced on its module for the duration (the
    models look them up at each call, the backward's recompute included;
    a ``TorchFunctionMode`` would be popped inside ``torch.autograd.grad``
    and miss the recompute), so only one cell may run at a time in a
    process."""
    def model(name):       # ``models`` exports a function ``attention``
        return importlib.import_module(f"..models.{name}", __package__)

    swaps = [(torch, "einsum", _on_dtensors(_einsum)),
             (F, "embedding", _on_dtensors(_embedding)),
             (torch, "gather", _on_dtensors(_gather)),
             (torch, "logsumexp", _on_dtensors(_logsumexp)),
             (model("attention"), "gqa_flash_attention", _attention),
             (model("attention"), "_group_q", _group_q),
             (model("ssm"), "ssd_scan", _ssd_scan),
             (model("moe"), "assign", _assign)]
    saved = [(module, name, getattr(module, name))
             for module, name, _ in swaps]
    try:
        for module, name, make in swaps:
            setattr(module, name, make(getattr(module, name)))
        yield
    finally:
        for module, name, original in saved:
            setattr(module, name, original)
