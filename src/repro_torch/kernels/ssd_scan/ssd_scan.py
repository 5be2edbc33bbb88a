"""Build and launch the hand-written CUDA kernels of ``csrc/``.

They replace the Pallas TPU kernel ``ssd_scan_pallas`` of the JAX package's
``kernels/ssd_scan/ssd_scan.py`` (with its wrapper's transpose of x and
broadcast of B and C over heads).  Two paths, chosen by ``wgmma_path``
from dtype, shape and layout alone:

- ``"wgmma"`` (``csrc/ssd_passes.cu``): bf16 at P 64, N 128, a chunk that
  is a multiple of 64 up to 256, views TMA can map (mamba2-780m's
  prefill).  Mamba-2's chunk-parallel form in three passes on Hopper's
  ``wgmma``: chunk states, the state across chunk boundaries, chunk outputs.
  The wrapper allocates their scratch (``scratch_shapes``).
- ``"simple"`` (``csrc/ssd_scan.cu``): every other call, fp32 among them;
  one block walks a (batch, head)'s chunks in order.

``scan(..., stats=True)`` also returns the fp32 state before each chunk,
the backward's statistics (either path; ``stats=False`` writes nothing
more and computes the same bits).  ``scan_bwd`` is the gradient, which the
JAX package takes by autodiff of its jnp ``ssd_chunked``, on two paths
chosen by ``bwd_path`` as the forward's are:

- ``"wgmma"`` (``csrc/ssd_scan_bwd_wgmma.cu``): bf16 at P 64, N 128, a
  chunk that is a multiple of 64 up to 256, x, B, C and dy as TMA maps
  them (mamba2-780m's training); six kernels on Hopper's ``wgmma``, the
  products the heads share taken once.
- ``"simple"`` (``csrc/ssd_scan_bwd.cu``): every other call, fp32 among
  them; four kernels on fp32 FMAs.

The source notes at the top of the ``.cu`` files say what bounds each on an
H100 and what its design does about that.

Build: at first use, ``kernels/build.py`` compiles ``csrc/*.cu`` for
``sm_90a`` into ``build/repro_torch/ssd_scan-<hash>/`` and the library is
loaded with ``ctypes``.  There is no fallback: without ``nvcc`` the build
raises.

Launch: ``scan`` checks device, dtype, shape and layout, allocates ``y``,
``h_final`` and the scratch with ``torch.empty``, launches on PyTorch's
current stream without synchronising, raises if a C entry point reports a
CUDA error, and, where it launches, adds one to ``launches["ssd_scan"]``
(one per call, whatever the number of CUDA kernels) and to
``path_launches[path]``; ``scan_bwd`` the same, to
``bwd_launches["ssd_scan_bwd"]`` and ``bwd_path_launches[path]``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .. import build as _build

CSRC = Path(__file__).resolve().parent / "csrc"
DTYPES = {torch.bfloat16: 1, torch.float32: 0}
MAX_P, MAX_N, TILE, MAX_CHUNK = 64, 128, 64, 1024
#: What the wgmma passes tile: head dim, state, chunk multiple and limit.
WGMMA_P, WGMMA_N, WGMMA_TILE, WGMMA_MAX_CHUNK = 64, 128, 64, 256

#: Launches of the kernel since the last ``reset_launches``: one per scan.
launches: Dict[str, int] = {"ssd_scan": 0}
#: The same calls by path (``wgmma_path``).
path_launches: Dict[str, int] = {"wgmma": 0, "simple": 0}
#: Launches of the backward since the last ``reset_launches``: one per call.
bwd_launches: Dict[str, int] = {"ssd_scan_bwd": 0}
#: The same calls by path (``bwd_path``).
bwd_path_launches: Dict[str, int] = {"wgmma": 0, "simple": 0}
#: The device buffers of ``ssd_scan_bwd_launch``, in its order: inputs,
#: outputs, scratch (``bwd_scratch_shapes``).
BWD_BUFFERS = ("xh", "dt", "A", "Bc", "Cc", "D", "dy", "h_before",
               "dh_final", "dxh", "ddt", "dA", "dBc", "dCc", "dD",
               "dstates", "chunk_sum", "dB_heads", "dC_heads", "dA_part",
               "dD_part")
#: The device buffers of ``ssd_scan_bwd_wgmma_launch``, in its order:
#: inputs, outputs, scratch (``bwd_scratch_shapes(..., path="wgmma")``).
BWD_WGMMA_BUFFERS = BWD_BUFFERS[:15] + (
    "dstates", "chunk_sum", "ds_bf", "h_bf", "hds", "acs", "dts", "tail",
    "inter", "cb", "dcb", "dA_part", "dD_part")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    launches["ssd_scan"] = 0
    bwd_launches["ssd_scan_bwd"] = 0
    for counts in (path_launches, bwd_path_launches):
        for k in counts:
            counts[k] = 0


def build() -> Path:
    """Compile ``csrc/*.cu`` (once per source hash) and return the library."""
    return _build.build("ssd_scan", CSRC)


def load(path) -> ctypes.CDLL:
    """Load a library built from ``csrc/`` (or from an earlier
    ``ssd_scan.cu`` alone, which has only ``ssd_scan_launch``) and declare
    its C entry points."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, i, i, i, p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    if hasattr(lib, "ssd_chunk_state_launch"):
        lib.ssd_chunk_state_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, p, i, p]
        lib.ssd_state_pass_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.ssd_chunk_out_launch.argtypes = [
            p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, i, i, p]
        for fn in (lib.ssd_chunk_state_launch, lib.ssd_state_pass_launch,
                   lib.ssd_chunk_out_launch):
            fn.restype = ctypes.c_int
    if hasattr(lib, "ssd_scan_bwd_launch"):       # with the backward
        lib.ssd_scan_stats_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p, i, i, i, p]
        lib.ssd_state_pass_stats_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, i, p]
        lib.ssd_scan_bwd_launch.argtypes = [
            p, i, i, i, i, i, i, p, i, i, i, p]
        for fn in (lib.ssd_scan_stats_launch, lib.ssd_state_pass_stats_launch,
                   lib.ssd_scan_bwd_launch):
            fn.restype = ctypes.c_int
    if hasattr(lib, "ssd_scan_bwd_wgmma_launch"):
        lib.ssd_scan_bwd_wgmma_launch.argtypes = [
            p, i, i, i, i, i, i, p, i, i, p]
        lib.ssd_scan_bwd_wgmma_launch.restype = ctypes.c_int
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check_chunk(S: int, chunk: int) -> None:
    """``S % chunk != 0`` raises ``ValueError`` on both devices (the JAX
    package asserts)."""
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA's rules for a bf16 view: a 16-byte aligned start, the last axis
    contiguous, and every other axis longer than 1 with a positive stride
    that is a multiple of 16 bytes."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and
            all(n == 1 or (s > 0 and s % vec == 0)
                for s, n in zip(t.stride()[:-1], t.shape[:-1])))


def wgmma_path(xh: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
               chunk: int) -> str:
    """``"wgmma"`` where the Hopper passes of ``csrc/ssd_passes.cu`` tile
    the call (bf16; P 64; N 128; a chunk that is a multiple of 64 up to 256;
    x, B and C as TMA maps them; a sequence that is not empty), else
    ``"simple"`` (``csrc/ssd_scan.cu``).  Pure Python on the arguments'
    dtype, shapes and strides."""
    S, P, N = xh.shape[1], xh.shape[-1], Bc.shape[-1]
    if (xh.dtype == torch.bfloat16 and S > 0 and P == WGMMA_P
            and N == WGMMA_N and chunk % WGMMA_TILE == 0
            and chunk <= WGMMA_MAX_CHUNK
            and all(_tma_ok(t) for t in (xh, Bc, Cc))):
        return "wgmma"
    return "simple"


def bwd_path(xh: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
             dy: torch.Tensor, chunk: int) -> str:
    """``"wgmma"`` where the Hopper backward of ``csrc/ssd_scan_bwd_wgmma.cu``
    tiles the call (the forward's rule, ``wgmma_path``, with dy as TMA maps
    it too), else ``"simple"`` (``csrc/ssd_scan_bwd.cu``).  Pure Python on
    the arguments' dtype, shapes and strides."""
    if wgmma_path(xh, Bc, Cc, chunk) == "wgmma" and _tma_ok(dy):
        return "wgmma"
    return "simple"


def scratch_shapes(B: int, S: int, H: int, P: int, N: int, chunk: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The wgmma path's scratch, allocated by the wrapper: the fp32 chunk
    states (pass 1), each chunk's total log decay (pass 1), and the bf16
    state before each chunk (pass 2, the operand of pass 3)."""
    nc = S // chunk
    return {"states": ((B, nc, H, P, N), torch.float32),
            "chunk_sum": ((B, H, nc), torch.float32),
            "h_before": ((B, nc, H, P, N), torch.bfloat16)}


def _check(xh, dt, A, Bc, Cc, D, chunk) -> Tuple[int, int, int, int, int]:
    if xh.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {xh.device}")
    if xh.dim() != 4:
        raise ValueError(f"xh must be [B, S, H, P], got {tuple(xh.shape)}")
    if xh.dtype not in DTYPES:
        raise TypeError(f"ssd_scan takes {list(DTYPES)}, got {xh.dtype}")
    B, S, H, P = xh.shape
    want = {"dt": (dt, (B, S, H), xh.dtype), "A": (A, (H,), None),
            "D": (D, (H,), None)}
    if Bc.dim() != 3:
        raise ValueError(f"Bc must be [B, S, N], got {tuple(Bc.shape)}")
    N = Bc.shape[2]
    want.update(Bc=(Bc, (B, S, N), xh.dtype), Cc=(Cc, (B, S, N), xh.dtype))
    for name, (t, shape, dtype) in want.items():
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{xh.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype not in DTYPES or (dtype is not None and t.dtype != dtype):
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{dtype or list(DTYPES)}")
    for name, t in (("xh", xh), ("Bc", Bc), ("Cc", Cc)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
    check_chunk(S, chunk)
    if not (0 < P <= MAX_P and P % 4 == 0 and 0 < N <= MAX_N
            and N % 4 == 0):
        raise ValueError(f"ssd_scan takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"both multiples of 4; got P {P}, N {N}")
    if chunk % 4 or chunk > MAX_CHUNK or (chunk > TILE and chunk % TILE):
        raise ValueError(f"ssd_scan takes a chunk that is a multiple of 4, "
                         f"at most {TILE} or a multiple of {TILE} up to "
                         f"{MAX_CHUNK}; got {chunk}")
    return B, S, H, P, N


def _strides(xh, dt, Bc, Cc, y):
    return (ctypes.c_int64 * 13)(*xh.stride()[:3], *dt.stride(),
                                 *Bc.stride()[:2], *Cc.stride()[:2],
                                 *y.stride()[:3])


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _passes(lib, xh, dt, A, Bc, Cc, D, chunk, dims, events,
            h_before32=None):
    B, S, H, P, N = dims
    out = {name: torch.empty(shape, dtype=dtype, device=xh.device)
           for name, (shape, dtype) in
           scratch_shapes(B, S, H, P, N, chunk).items()}
    out["y"] = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
    out["h_final"] = torch.empty((B, H, P, N), dtype=torch.float32,
                                 device=xh.device)
    held = _strides(xh, dt, Bc, Cc, out["y"])     # alive until the launches
    strides = ctypes.cast(held, ctypes.c_void_p)
    a16, d16 = DTYPES[A.dtype], DTYPES[D.dtype]
    stream = torch.cuda.current_stream(xh.device).cuda_stream

    def mark():
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    mark()
    _raise_on(lib.ssd_chunk_state_launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        out["states"].data_ptr(), out["chunk_sum"].data_ptr(),
        B, S, H, P, N, chunk, strides, a16, stream), "ssd_chunk_state")
    mark()
    if h_before32 is not None:       # the backward's statistics too
        _raise_on(lib.ssd_state_pass_stats_launch(
            out["states"].data_ptr(), out["chunk_sum"].data_ptr(),
            out["h_before"].data_ptr(), h_before32.data_ptr(),
            out["h_final"].data_ptr(), B, S // chunk, H, P, N, stream),
            "ssd_state_pass")
    else:
        _raise_on(lib.ssd_state_pass_launch(
            out["states"].data_ptr(), out["chunk_sum"].data_ptr(),
            out["h_before"].data_ptr(), out["h_final"].data_ptr(),
            B, S // chunk, H, P, N, stream), "ssd_state_pass")
    mark()
    _raise_on(lib.ssd_chunk_out_launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), D.data_ptr(), out["h_before"].data_ptr(),
        out["y"].data_ptr(), B, S, H, P, N, chunk, strides, a16, d16,
        stream), "ssd_chunk_out")
    mark()
    return out


def passes(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor, *,
           chunk: int, lib: Optional[ctypes.CDLL] = None,
           events: Optional[List[torch.cuda.Event]] = None
           ) -> Dict[str, torch.Tensor]:
    """The wgmma path with every intermediate: ``states``, ``chunk_sum``
    (pass 1), ``h_before``, ``h_final`` (pass 2) and ``y`` (pass 3), for
    holding each pass against its plain version (``ref.py``).  Raises
    ``ValueError`` where ``wgmma_path`` is not ``"wgmma"``.  ``events``,
    where given, receives a recorded CUDA event before each pass and one
    after the last; counts no launch."""
    dims = _check(xh, dt, A, Bc, Cc, D, chunk)
    if wgmma_path(xh, Bc, Cc, chunk) != "wgmma":
        raise ValueError("the wgmma passes do not tile this call")
    with torch.cuda.device(xh.device):
        return _passes(lib or _load(), xh, dt, A.contiguous(), Bc, Cc,
                       D.contiguous(), chunk, dims, events)


def scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor, *,
         chunk: int, lib: Optional[ctypes.CDLL] = None,
         path: Optional[str] = None, stats: bool = False
         ) -> Tuple[torch.Tensor, ...]:
    """The SSD scan on the card.  xh [B,S,H,P]; dt [B,S,H]; Bc, Cc [B,S,N]
    (xh, dt, Bc and Cc in one dtype, bf16 or fp32, any strides with the last
    axis of xh, Bc and Cc contiguous); A, D [H] in bf16 or fp32.  Returns
    y [B,S,H,P] in xh's dtype and h_final [B,H,P,N] in fp32; with
    ``stats`` also h_before [B,nc,H,P,N] in fp32, the state before each
    chunk, which ``scan_bwd`` reads.  ``path`` (default ``wgmma_path``'s
    choice) and ``lib`` (another build, from ``load``) are for comparing
    designs: ``path="simple"`` runs ``csrc/ssd_scan.cu``'s kernel at any
    shape."""
    B, S, H, P, N = _check(xh, dt, A, Bc, Cc, D, chunk)
    tiled = wgmma_path(xh, Bc, Cc, chunk)
    path = path or tiled
    if path not in path_launches:
        raise ValueError(f"unknown ssd_scan path {path!r}")
    if path == "wgmma" and tiled != "wgmma":
        raise ValueError("the wgmma passes do not tile this call")
    h_before = torch.empty((B, S // chunk, H, P, N), dtype=torch.float32,
                           device=xh.device) if stats else None
    if B * H == 0:
        y = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
        h_final = torch.empty((B, H, P, N), dtype=torch.float32,
                              device=xh.device)
        return (y, h_final, h_before) if stats else (y, h_final)
    A, D = A.contiguous(), D.contiguous()
    lib = lib or _load()
    with torch.cuda.device(xh.device):
        if path == "wgmma":
            out = _passes(lib, xh, dt, A, Bc, Cc, D, chunk,
                          (B, S, H, P, N), None, h_before)
            y, h_final = out["y"], out["h_final"]
        else:
            y = torch.empty((B, S, H, P), dtype=xh.dtype, device=xh.device)
            h_final = torch.empty((B, H, P, N), dtype=torch.float32,
                                  device=xh.device)
            held = _strides(xh, dt, Bc, Cc, y)
            args = (xh.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(), y.data_ptr(),
                    h_final.data_ptr())
            rest = (B, S, H, P, N, chunk, ctypes.cast(held, ctypes.c_void_p),
                    DTYPES[xh.dtype], DTYPES[A.dtype], DTYPES[D.dtype],
                    torch.cuda.current_stream(xh.device).cuda_stream)
            if stats:
                _raise_on(lib.ssd_scan_stats_launch(
                    *args, h_before.data_ptr(), *rest), "ssd_scan")
            else:
                _raise_on(lib.ssd_scan_launch(*args, *rest), "ssd_scan")
    launches["ssd_scan"] += 1
    path_launches[path] += 1
    return (y, h_final, h_before) if stats else (y, h_final)


def bwd_scratch_shapes(B: int, S: int, H: int, P: int, N: int, chunk: int,
                       path: str = "simple"
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The backward's scratch, allocated by the wrapper.  ``"simple"``
    (fp32): dh_y and then dS of each chunk (passes a, b), each chunk's
    total log decay, the per-head parts of dB and dC, and the per-chunk
    parts of dA and dD (pass c, summed by pass d).  ``"wgmma"``: dh_y
    (fp32), the chunk totals, dS and h_before in bf16 (operands), the
    warps' parts of <h, dS>, each (b, chunk, head)'s acs, dt, tail and
    inter rows, C B^T (fp32) and the head-summed dCB (two bf16 terms, hi
    and lo) of each 64-row tile pair at or below the diagonal, and the
    parts of dA and dD; no per-head [B, S, H, N] buffer."""
    nc, f = S // chunk, torch.float32
    if path == "wgmma":
        nt = chunk // WGMMA_TILE
        pairs = (B, nc, nt * (nt + 1) // 2, WGMMA_TILE, WGMMA_TILE)
        halves = pairs[:3] + (2,) + pairs[3:]         # dCB's hi and lo
        return {"dstates": ((B, nc, H, P, N), f),
                "chunk_sum": ((B, H, nc), f),
                "ds_bf": ((B, nc, H, P, N), torch.bfloat16),
                "h_bf": ((B, nc, H, P, N), torch.bfloat16),
                "hds": ((B, nc, H, P * N // 128), f),
                "acs": ((B, nc, H, chunk), f), "dts": ((B, nc, H, chunk), f),
                "tail": ((B, nc, H, chunk), f),
                "inter": ((B, nc, H, chunk), f),
                "cb": (pairs, f), "dcb": (halves, torch.bfloat16),
                "dA_part": ((B, H, nc), f), "dD_part": ((B, H, nc), f)}
    if path != "simple":
        raise ValueError(f"unknown ssd_scan_bwd path {path!r}")
    return {"dstates": ((B, nc, H, P, N), f), "chunk_sum": ((B, H, nc), f),
            "dB_heads": ((B, S, H, N), f), "dC_heads": ((B, S, H, N), f),
            "dA_part": ((B, H, nc), f), "dD_part": ((B, H, nc), f)}


@functools.lru_cache(maxsize=64)
def _scratch_layout(B: int, S: int, H: int, P: int, N: int, chunk: int,
                    path: str):
    """Where each scratch buffer of ``bwd_scratch_shapes`` starts in one
    allocation (offsets in bytes, 256-byte aligned), and its size."""
    layout, total = {}, 0
    for name, (shape, dtype) in bwd_scratch_shapes(B, S, H, P, N, chunk,
                                                   path).items():
        layout[name] = (total, shape, dtype)
        total += -(-math.prod(shape) * dtype.itemsize // 256) * 256
    return layout, total


def _check_bwd(dims, xh, dy, dh_final, h_before, chunk) -> None:
    B, S, H, P, N = dims
    want = {"dy": (dy, (B, S, H, P), xh.dtype),
            "h_before": (h_before, (B, S // chunk, H, P, N), torch.float32)}
    if dh_final is not None:
        want["dh_final"] = (dh_final, (B, H, P, N), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{xh.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if dy.stride(-1) != 1 and P > 1:
        raise ValueError("dy must have a contiguous last dimension")
    for name in ("h_before", "dh_final"):
        if name in want and not want[name][0].is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def scan_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
             dy: torch.Tensor, dh_final: Optional[torch.Tensor],
             h_before: torch.Tensor, *, chunk: int,
             lib: Optional[ctypes.CDLL] = None, keep: bool = False,
             path: Optional[str] = None):
    """The gradient of ``scan`` on the card: given the forward's inputs (as
    ``scan`` takes them), dy [B,S,H,P] (xh's dtype, last axis contiguous),
    dh_final [B,H,P,N] (fp32 contiguous, or None for zero) and the
    forward's statistics h_before (``scan(..., stats=True)``), returns
    (dxh, ddt, dA, dBc, dCc, dD), each contiguous in its input's dtype.
    ``keep`` returns a dict of every buffer of the launch instead (the
    path's buffer list, ``BWD_BUFFERS`` or ``BWD_WGMMA_BUFFERS``: the
    scratch of each pass too, to hold against ``ref.py``'s passes).
    ``path`` (default ``bwd_path``'s choice) and ``lib`` (another build)
    are for comparing designs: ``path="simple"`` runs
    ``csrc/ssd_scan_bwd.cu``'s kernels at any shape."""
    dims = _check(xh, dt, A, Bc, Cc, D, chunk)
    B, S, H, P, N = dims
    _check_bwd(dims, xh, dy, dh_final, h_before, chunk)
    tiled = bwd_path(xh, Bc, Cc, dy, chunk)
    path = path or tiled
    if path not in bwd_path_launches:
        raise ValueError(f"unknown ssd_scan_bwd path {path!r}")
    if path == "wgmma" and tiled != "wgmma":
        raise ValueError("the wgmma backward does not tile this call")
    lib = lib or _load()
    dev = xh.device

    def like(t, shape=None):
        return torch.empty(shape or t.shape, dtype=t.dtype, device=dev)

    out = {"dxh": like(xh, (B, S, H, P)), "ddt": like(dt, (B, S, H)),
           "dA": like(A), "dBc": like(Bc, (B, S, N)),
           "dCc": like(Cc, (B, S, N)), "dD": like(D)}
    if B * H and S:
        A, D = A.contiguous(), D.contiguous()
        layout, total = _scratch_layout(B, S, H, P, N, chunk, path)
        scratch = torch.empty(total, dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        ptr = {name: t.data_ptr() for name, t in dict(
            xh=xh, dt=dt, A=A, Bc=Bc, Cc=Cc, D=D, dy=dy, h_before=h_before,
            **out).items()}
        ptr.update({name: base + at for name, (at, _, _) in layout.items()},
                   dh_final=None if dh_final is None else dh_final.data_ptr())
        names = BWD_WGMMA_BUFFERS if path == "wgmma" else BWD_BUFFERS
        ptrs = (ctypes.c_void_p * len(names))(*(ptr[n] for n in names))
        held = _strides(xh, dt, Bc, Cc, dy)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            if path == "wgmma":
                err = lib.ssd_scan_bwd_wgmma_launch(
                    ctypes.cast(ptrs, ctypes.c_void_p), B, S, H, P, N, chunk,
                    ctypes.cast(held, ctypes.c_void_p), DTYPES[A.dtype],
                    DTYPES[D.dtype], stream)
            else:
                err = lib.ssd_scan_bwd_launch(
                    ctypes.cast(ptrs, ctypes.c_void_p), B, S, H, P, N, chunk,
                    ctypes.cast(held, ctypes.c_void_p), DTYPES[xh.dtype],
                    DTYPES[A.dtype], DTYPES[D.dtype], stream)
            _raise_on(err, "ssd_scan_bwd")
        bwd_launches["ssd_scan_bwd"] += 1
        bwd_path_launches[path] += 1
        if keep:
            out.update({name: scratch[at:at + math.prod(shape)
                                      * dtype.itemsize].view(dtype)
                        .view(shape)
                        for name, (at, shape, dtype) in layout.items()})
    else:
        for name in ("dxh", "ddt", "dA", "dBc", "dCc", "dD"):
            out[name].zero_()
    if keep:
        return out
    return tuple(out[n] for n in ("dxh", "ddt", "dA", "dBc", "dCc", "dD"))
