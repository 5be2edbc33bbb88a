"""Multi-device dry run: price every (arch × shape × mesh) cell on no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --json out.json

Each cell builds the mesh as a CPU ``DeviceMesh`` over a fake process group
(``launch/mesh.py``: this process is rank 0 of 256 or 512), lays the
parameters, optimizer state, batch and cache out as ``DTensor``s over
meta-device shards with the ``Sharder``'s placements, and runs the port's
own step on them (``make_train_step``: the forward, ``torch.autograd.grad``
and AdamW; ``make_prefill_step``; ``make_decode_step``) under the
activation-sharding context.  Nothing is allocated and nothing runs on a
card: the attention and SSD-scan front ends send meta tensors to their
plain versions, as the JAX package's dry run prices its jnp path.

``DeviceCounter`` counts *one device's* work, on the local shards DTensor
hands to each aten op (a counter around DTensor would see the global,
logical op and overstate compute by about the chip count):

  * flops: ``torch.utils.flop_counter``'s formulas (the matrix products
    and attention) applied to the shapes rank 0 computes on;
  * bytes: each local op's tensor inputs plus outputs, counting the
    distinct elements of each (a broadcast view counts once).  This is an
    eager, unfused count: every op reads and writes memory.  XLA counts
    after fusion, so the port's memory term is an upper bound of the same
    program fused;
  * collectives: the bytes of each ``c10d_functional`` collective's result
    on this device, by kind in the JAX package's names.  On a CPU mesh
    DTensor runs a shard-to-shard move (an all-to-all on the card) as an
    all-gather and a chunk; the counter books that all-gather, found by
    its caller ``shard_dim_alltoall``, as "all-to-all" with the bytes of
    the chunk this device keeps, which is what the all-to-all returns;
  * memory: the bytes of every new local storage while it lives; its peak
    during the step is ``temp_bytes``.

The port's group loop is Python, so the counter sees every group:
``extrapolated_costs`` counts the full depth directly, and keeps the JAX
package's name and keys (the JAX package needs a two-point fit because
``cost_analysis`` counts a scan body once).

Operators without a DTensor sharding rule are not replicated silently: a
cell that reaches one raises.  DTensor runs the elementwise ops, the
reductions, the softmax, the optimizer and the constraints as they are.
Where its rules cannot partition what XLA's partitioner would, the cell
runs under ``partition.partitioned()``, which computes those calls on the
local shards (the models keep torch's ops and know only ``constrain``);
each adds only the collectives listed:

  * every einsum: one index kept sharded per mesh dim; an operand sharded
    on another index is gathered (all-gather) or moved (all-to-all), and a
    contraction over a sharded index leaves a partial sum that the next
    constraint reduces (all-reduce or reduce-scatter);
  * the attention front end (``gqa_flash_attention``'s plain version) and
    the SSD scan (``ssd_scan``'s), on whole batch rows and heads (and query
    rows, for attention with index masks): k and v, or the sequence of the
    scan, are gathered (all-gather);
  * the MoE's capacity assignment (``moe.assign``), on whole groups: a
    group's sequence sharded for sequence parallelism is gathered
    (all-gather of the [G, S, K] choices and gates); its kept count is a
    partial sum (all-reduce where read);
  * the token embedding and the loss's label pick and log-normaliser
    (``F.embedding``, ``torch.gather`` and ``torch.logsumexp`` over the
    vocab): vocab-parallel, a partial sum over the vocab's shards
    (all-reduce of [B, S, d] or [B, S]);
  * decode's query heads before they are grouped (``attention._group_q``,
    a reshape DTensor cannot split): all-gather of [B, 1, H, Dh].
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import CELLS, REGISTRY, SHAPES, cell_skip_reason, cells, get_config
from ..optim import AdamWConfig
from .mesh import data_axes, make_mesh, make_production_mesh
from .partition import partitioned
from .roofline import cost_analysis_dict, roofline_report
from .sharding import Sharder, to_placements
from .steps import (
    batch_specs, decode_input_specs, make_decode_step, make_prefill_step,
    make_train_step, param_state_specs,
)

BIG_ARCH_THRESHOLD = 100e9   # params; above this use bf16 optimizer moments

#: c10d_functional collectives by the JAX package's names for them
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: c10d_functional ops that move no data
_COLLECTIVE_BOOKKEEPING = ("wait_tensor", "_wrap_tensor_autograd")
#: ops that make a tensor without writing it
_NO_WRITE = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided")


def opt_config_for(cfg) -> AdamWConfig:
    moment = "bfloat16" if cfg.param_count() > BIG_ARCH_THRESHOLD else "float32"
    return AdamWConfig(moment_dtype=moment,
                       master_weights=(cfg.param_dtype == "bfloat16"))


def _footprint(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` reads or writes (a broadcast
    dimension, stride 0, counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves as leaves

    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _in_shard_dim_alltoall() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


class DeviceCounter(TorchDispatchMode):
    """Counts one device's flops, bytes, collectives and live memory on the
    local shards (see the module's docstring).  Ops on ``DTensor``s are
    left to DTensor, which calls them again on the local shards; ops on
    fake tensors are DTensor's own shape propagation and are not
    counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()

    def hold(self, tensors) -> None:
        """Mark the storages of ``tensors`` (the step's arguments) as
        existing before the step: they are not temporaries."""
        for t in tensors:
            self._seen.add(t.untyped_storage())

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            nbytes = st.nbytes()
            self.live += nbytes
            weakref.finalize(st, self._free, nbytes)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                     # DTensor's shape propagation
        name = func._schema.name
        ns, _, op = name.partition("::")
        if ns in ("_c10d_functional", "c10d_functional"):
            if op in _COLLECTIVE_BOOKKEEPING:
                return out
            if op not in COLLECTIVE_KINDS:
                raise NotImplementedError(f"uncounted collective {name}")
            kind, nbytes = COLLECTIVE_KINDS[op], sum(
                _footprint(t) for t in outs)
            if kind == "all-gather" and _in_shard_dim_alltoall():
                # the CPU mesh's stand-in for an all-to-all, whose result
                # on this device is as large as its input
                kind, nbytes = "all-to-all", _footprint(ins[0])
            self.collectives[kind] = self.collectives.get(kind, 0) + nbytes
            self._track(outs)
            return out
        aliases = [r.alias_info for r in func._schema.returns]
        if aliases and all(a is not None and not a.is_write
                           for a in aliases):
            return out                     # a view: no data moves
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if op.split(".")[0] not in _NO_WRITE:
            self.bytes += sum(_footprint(t) for t in ins + outs)
        self._track(outs)
        return out

    def totals(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives)}


def _local_shape(shape, spec, sizes) -> Tuple[int, ...]:
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = 1
        for a in axes:
            n *= sizes[a]
        assert dim % n == 0, (shape, spec)
        out.append(dim // n)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each meta tensor of ``tree`` as a ``DTensor`` on ``mesh`` whose local
    shard (meta, no storage) is the one ``specs`` gives rank 0."""
    from torch.distributed.tensor import DTensor

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def one(t, spec):
        local = torch.empty(_local_shape(t.shape, spec, sizes),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    return one(tree, specs)


def _local(tree) -> list:
    """The tensors of ``tree``, each ``DTensor`` as its local shard."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _local(tree))


def lower_cell(cfg, shape, mesh, *, sharder: Optional[Sharder] = None,
               mode: str = "train"):
    """Run the cell's step once on ``mesh`` under a ``DeviceCounter``.
    Returns (counter, memory dict, wallclock seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.sharding_ctx import activation_sharding

    sharder = sharder or Sharder(mesh, cfg, mode=mode)
    t0 = time.time()
    with activation_sharding(mesh, data_axes(mesh),
                             replicate_batch=(mode == "decode_tp")), \
            implicit_replication(), partitioned():
        counter, memory = _lower_cell_inner(cfg, shape, mesh, sharder)
    return counter, memory, time.time() - t0


def _lower_cell_inner(cfg, shape, mesh, sharder):
    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        p_specs, o_specs = param_state_specs(cfg, opt_cfg)
        params = distribute(p_specs, sharder.param_pspecs(), mesh)
        opt_state = distribute(o_specs, sharder.opt_pspecs(
            with_master=opt_cfg.master_weights), mesh)
        b = batch_specs(cfg, shape)
        batch = distribute(b, sharder.batch_pspecs(b), mesh)
        args = (params, opt_state, batch)
        step = make_train_step(cfg, opt_cfg)
    elif shape.kind == "prefill":
        p_specs, _ = param_state_specs(cfg, AdamWConfig())
        params = distribute(p_specs, sharder.param_pspecs(), mesh)
        b = batch_specs(cfg, shape)
        args = (params, distribute(b, sharder.batch_pspecs(b), mesh))
        step = make_prefill_step(cfg)
    else:  # decode
        p_specs, _ = param_state_specs(cfg, AdamWConfig())
        params = distribute(p_specs, sharder.param_pspecs(), mesh)
        d = decode_input_specs(cfg, shape)
        cache = distribute(d["cache"], sharder.cache_pspecs(d["cache"]),
                           mesh)
        if sharder.mode == "decode_tp":
            # weight-stationary decode: tokens replicated (KB-scale)
            t_spec = (None,) * d["tokens"].dim()
        else:
            t_spec = sharder.batch_pspecs({"t": d["tokens"]})["t"]
        tokens = distribute(d["tokens"], t_spec, mesh)
        args = (params, cache, tokens, d["pos"])
        step = make_decode_step(cfg)
    argument_bytes = _local_bytes(args)
    counter = DeviceCounter()
    counter.hold(_local(args))
    with counter:
        out = step(*args)
    memory = {"argument_bytes": argument_bytes,
              "output_bytes": _local_bytes(out),
              "temp_bytes": counter.peak,
              "peak_bytes": counter.peak + argument_bytes}
    return counter, memory


def extrapolated_costs(cfg, shape, mesh, mode: str = "train",
                       counter: Optional[DeviceCounter] = None
                       ) -> Dict[str, Any]:
    """Per-device flops, bytes and collectives of the cell at full depth.

    The port's group loop is Python, so one counted run sees every group
    and nothing is extrapolated: ``counter`` is that run when the caller
    has it (``run_cell``), else the cell is run here."""
    if counter is None:
        counter, _, _ = lower_cell(cfg, shape, mesh, mode=mode)
    return counter.totals()


def analyze(cfg, shape, mesh_name, memory: Dict[str, int], seconds,
            costs: Dict[str, Any], n_chips: Optional[int] = None
            ) -> Dict[str, Any]:
    """The JAX package's result keys.  The collectives are priced as
    counted: the port's carry their true dtype, so ``correct_promoted_f32``
    (which undoes XLA:CPU's bf16-to-f32 promotion) does not apply.
    ``n_chips`` defaults to the production mesh's (512 for "multi", else
    256)."""
    if n_chips is None:
        n_chips = 512 if mesh_name == "multi" else 256
    report = roofline_report(
        cfg=cfg, shape=shape, n_chips=n_chips,
        flops_per_device=costs["flops"],
        bytes_per_device=costs["bytes"],
        collective_bytes_per_device=sum(costs["collectives"].values()),
    )
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "compile_seconds": round(seconds, 1),
        "memory": dict(memory),
        "cost": cost_analysis_dict(costs),
        "collectives": costs["collectives"],
        "roofline": report,
    }


def price_cell(cfg, shape) -> Dict[str, Any]:
    """``analyze``'s result for ``cfg`` × ``shape`` training on one chip (a
    1×1 mesh): one card's estimate of the step, to read beside its
    measured time."""
    mesh = make_mesh((1, 1), ("data", "model"))
    counter, memory, secs = lower_cell(cfg, shape, mesh)
    return analyze(cfg, shape, "1x1", memory, secs, counter.totals(),
                   n_chips=1)


VARIANTS = ("baseline", "bf16w", "bf16w_cap1", "bf16w_nodp",
            "bf16w_remat", "bf16w_cap1_remat")


def apply_variant(cfg, variant: str):
    """Named optimization variants for the §Perf hillclimb."""
    from dataclasses import replace
    if variant == "baseline":
        return cfg
    if variant == "bf16w":
        # Iter-1: bf16 parameter storage (fp32 master in optimizer):
        # halves FSDP weight gathers + gradient reductions.
        return replace(cfg, param_dtype="bfloat16")
    if variant == "bf16w_cap1":
        # Iter-2 (MoE): capacity factor 1.25 -> 1.0 shrinks the dispatch/
        # combine one-hot tensors and expert buffers by 20%.
        return replace(cfg, param_dtype="bfloat16", capacity_factor=1.0)
    if variant == "bf16w_nodp":
        # Iter-2 (decode): weight-stationary 2-D tensor parallelism for
        # serving — weights never gathered per step.
        return replace(cfg, param_dtype="bfloat16")
    if variant == "bf16w_remat":
        # Iter-2/3 (trains): save matmul outputs in the remat stash — the
        # backward skips recomputing dots AND re-gathering their weights.
        return replace(cfg, param_dtype="bfloat16", remat_policy="dots")
    if variant == "bf16w_cap1_remat":
        return replace(cfg, param_dtype="bfloat16", capacity_factor=1.0,
                       remat_policy="dots")
    raise ValueError(variant)


def run_cell(arch: str, shape_name: str, mesh_name: str,
             verbose: bool = True, variant: str = "baseline") -> Dict[str, Any]:
    cfg = apply_variant(get_config(arch), variant)
    shape = SHAPES[shape_name]
    reason = cell_skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": reason}
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    mode = ("decode_tp" if variant == "bf16w_nodp"
            and shape.kind == "decode" else "train")
    counter, memory, secs = lower_cell(cfg, shape, mesh, mode=mode)
    costs = extrapolated_costs(cfg, shape, mesh, mode=mode, counter=counter)
    result = analyze(cfg, shape, mesh_name, memory, secs, costs)
    result["variant"] = variant
    if verbose:
        rl = result["roofline"]
        print(f"[OK] {arch} × {shape_name} × {mesh_name}-pod "
              f"({secs:.1f}s counted run)")
        print(f"     per-device bytes: args={_gb(memory['argument_bytes'])} "
              f"temp={_gb(memory['temp_bytes'])}")
        print(f"     roofline: compute={rl['compute_s']:.2e}s "
              f"memory={rl['memory_s']:.2e}s "
              f"collective={rl['collective_s']:.2e}s "
              f"-> bound={rl['bound']}")
    return result


def _gb(b: Optional[int]) -> str:
    return "?" if b is None else f"{b / 2**30:.2f}GiB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--json", default=None, help="write results JSON here")
    args = ap.parse_args(argv)

    if args.list:
        for cfg, shape, reason in cells(include_skipped=True):
            status = f"SKIP ({reason})" if reason else "run"
            print(f"{cfg.name:26s} {shape.name:12s} {status}")
        return 0

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    targets = []
    if args.all:
        targets = [(cfg.name, sh.name) for cfg, sh, _ in CELLS]
    else:
        archs = [args.arch] if args.arch else sorted(REGISTRY)
        shapes = [args.shape] if args.shape else list(SHAPES)
        targets = [(a, s) for a in archs for s in shapes]

    results, failures = [], 0
    for (arch, shape_name) in targets:
        cfg = get_config(arch)
        if cell_skip_reason(cfg, SHAPES[shape_name]):
            continue
        for mesh_name in meshes:
            try:
                results.append(run_cell(arch, shape_name, mesh_name,
                                        variant=args.variant))
            except Exception as e:   # a failing cell is a bug in the system
                failures += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": mesh_name, "error": repr(e)})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json} ({len(results)} cells, {failures} failures)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
