"""Opaque causal-context tokens — the client-facing causality currency.

The paper's client workflow (§4.1, §5.4) is GET → (values, *opaque*
context) → PUT(context).  §5.4's key observation is that the context a
client carries between those two steps can be *compacted to the ceiling*
of the returned clock set — a single version vector ⌈S⌉ — without losing
any causality information for the subsequent update: ``update`` only ever
reads per-replica ceilings of the context, and GET contexts are downsets,
so the ceiling VV denotes exactly the union of the siblings' histories.

``CausalContext`` is that compaction reified as a wire token:

* ``entries`` — the compacted ceiling, a sorted ``(replica_id, n)`` tuple.
  O(R) in the replica universe, *independent of the sibling count* — five
  concurrent siblings over two replicas still cost two entries.
* ``residue`` — clocks of mechanisms with no VV ceiling (causal-history
  oracles, LWW stamps, plain VVs of the §3 baselines).  DVV clocks are
  always folded into ``entries``; the residue exists so the token stays a
  faithful context for every mechanism the store can run, not just DVV.

Tokens encode to ``bytes`` (``to_bytes``/``from_bytes``) so real clients
can carry them across processes; the DVV encoding is a fixed-layout binary
record (O(R)), while residues fall back to pickle (the token is a server
artifact, mirroring how Riak vclocks travel base64'd through clients that
must not interpret them).  Because tokens pass *through* clients, decoding
is defensive: any malformed token fails with a clean ``ValueError`` and
residue blobs are unpickled through a restricted loader that only admits
this package's clock classes and plain containers — never callables.

The token is deliberately *iterable as a clock set* — legacy code (and the
formal-condition property tests) that treats a context as a set of clocks
keeps working: iterating a DVV token yields the single ceiling clock,
whose history equals the union of the original siblings' histories.
"""
from __future__ import annotations

import io
import pickle
import struct
import warnings
from dataclasses import dataclass
from typing import Any, FrozenSet, Iterable, Iterator, Tuple

from ..core.dvv import DVV

_MAGIC = b"DCX1"                    # wire-format tag + version

#: Exactly the globals a residue blob may reference: the clock classes of
#: the pluggable mechanisms plus plain containers.  Never callables like
#: eval/exec/getattr, and never whole modules — pickle protocol ≥ 4
#: resolves *dotted* names through ``find_class``, so a prefix allowance
#: (e.g. all of ``repro.*``) would let ``repro.anything:os.system``
#: through via the module's own imports.  Exact (module, name) pairs
#: only, dots rejected.
_SAFE_RESIDUE_GLOBALS = frozenset({
    ("builtins", "frozenset"), ("builtins", "set"), ("builtins", "tuple"),
    ("builtins", "list"), ("builtins", "dict"), ("builtins", "int"),
    ("builtins", "float"), ("builtins", "complex"), ("builtins", "str"),
    ("builtins", "bytes"), ("builtins", "bool"), ("builtins", "NoneType"),
    ("repro_torch.core.dvv", "DVV"),
    ("repro_torch.core.version_vector", "VV"),
    ("repro_torch.core.lww", "WallClock"),
    ("repro_torch.core.lww", "LamportClock"),
    ("repro_torch.core.causal_history", "CausalHistory"),
})


class _ResidueUnpickler(pickle.Unpickler):
    """Unpickler for token residues restricted to the exact clock classes
    and plain containers above.  Tokens are server artifacts, but they
    travel through clients — a crafted ``__reduce__`` gadget in the blob
    must be rejected, not executed."""

    def find_class(self, module: str, name: str):
        if "." not in name and (module, name) in _SAFE_RESIDUE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"token residue may not reference {module}.{name}")


@dataclass(frozen=True)
class CausalContext:
    """An opaque, wire-serializable causal context (paper §5.4)."""

    entries: Tuple[Tuple[str, int], ...] = ()   # compacted ceiling ⌈S⌉
    residue: Tuple[Any, ...] = ()               # non-DVV clocks, verbatim
    # HLC watermark of the read this token came from (geo tier, DESIGN.md
    # §12): the max encoded wall among returned versions.  Coordinators
    # fold it into their hybrid clock before minting, so a write causally
    # after a read always carries a larger wall than everything the read
    # saw.  0.0 (the non-geo default) encodes to the exact pre-geo byte
    # layout.
    hlc: float = 0.0

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_clocks(clocks: Iterable[Any]) -> "CausalContext":
        """Compact a clock set: DVV components fold into the ceiling VV
        (max of range top and dot — exact for §5.4 downset contexts);
        anything else rides along as residue."""
        ceiling = {}
        residue = []
        for c in clocks:
            if isinstance(c, DVV):
                for (r, m, n) in c.components:
                    ceiling[r] = max(ceiling.get(r, 0), m, n)
            else:
                residue.append(c)
        return CausalContext(
            entries=tuple(sorted(ceiling.items())),
            residue=tuple(sorted(residue, key=repr)))

    @classmethod
    def coerce(cls, context: Any) -> "CausalContext":
        """Normalize anything a caller may pass as a context.

        Accepts a token, its ``bytes`` encoding, ``None``, or — via the
        deprecation shim — a legacy set/frozenset of clock objects."""
        if context is None:
            return EMPTY_CONTEXT
        if isinstance(context, cls):
            return context
        if isinstance(context, (bytes, bytearray, memoryview)):
            return cls.from_bytes(bytes(context))
        if isinstance(context, (frozenset, set, tuple, list)):
            if context:   # the empty set doubles as "new session"; no nag
                warnings.warn(
                    "passing raw clock sets as PUT contexts is deprecated; "
                    "pass the GetResult.context token (or its to_bytes())",
                    DeprecationWarning, stacklevel=3)
            return cls.from_clocks(context)
        raise TypeError(f"cannot interpret {type(context).__name__} "
                        f"as a causal context")

    # -- views -------------------------------------------------------------

    @property
    def is_empty(self) -> bool:
        return not self.entries and not self.residue

    def __bool__(self) -> bool:
        return not self.is_empty

    def to_clock_set(self) -> FrozenSet[Any]:
        """The object-clock view ``mechanism.update`` consumes: one ceiling
        DVV (when any DVV state was compacted) plus the residue."""
        out = set(self.residue)
        if self.entries:
            out.add(DVV(tuple((r, n, 0) for r, n in self.entries)))
        return frozenset(out)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.to_clock_set())

    def __len__(self) -> int:
        return len(self.to_clock_set())

    def ceiling_items(self) -> Tuple[Tuple[str, int], ...]:
        """Per-replica ceilings, with residue clocks folded in when they
        expose ``ids()/ceil()`` (DVV/VV-shaped).  This is what the packed
        store consumes — no clock object is ever constructed from it."""
        merged = dict(self.entries)
        for c in self.residue:
            if not hasattr(c, "ids") or not hasattr(c, "ceil"):
                raise TypeError(
                    f"clock {type(c).__name__} has no VV ceiling; this "
                    f"context cannot drive an array-native update")
            for r in c.ids():
                merged[r] = max(merged.get(r, 0), c.ceil(r))
        return tuple(sorted(merged.items()))

    # -- wire codec --------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Encode for the wire.  O(R) for DVV contexts: a fixed header,
        then one length-prefixed id + uint64 per replica entry.  The header
        byte is a flag bitfield — bit 0: residue pickle appended, bit 1:
        an 8-byte HLC watermark follows the entries.  A zero watermark is
        simply not encoded, so pre-geo tokens are byte-identical.  Residues
        (non-DVV mechanisms only) append a pickle blob last."""
        flags = (1 if self.residue else 0) | (2 if self.hlc else 0)
        parts = [_MAGIC, struct.pack("<BH", flags, len(self.entries))]
        for r, n in self.entries:
            rid = r.encode()
            parts.append(struct.pack("<H", len(rid)))
            parts.append(rid)
            parts.append(struct.pack("<Q", n))
        if self.hlc:
            parts.append(struct.pack("<d", self.hlc))
        if self.residue:
            parts.append(pickle.dumps(self.residue))
        return b"".join(parts)

    @staticmethod
    def from_bytes(data: bytes) -> "CausalContext":
        """Decode a wire token.  Malformed input — empty, truncated at any
        field boundary, bad magic, trailing garbage, undecodable ids — is
        rejected with ``ValueError`` before any entry escapes: a client
        handing us a corrupt token gets a clean error, never a context
        holding half its causal history."""
        if len(data) < 4 or data[:4] != _MAGIC:
            raise ValueError("not a CausalContext token (bad magic)")
        if len(data) < 7:
            raise ValueError("truncated CausalContext token (header)")
        flags, count = struct.unpack_from("<BH", data, 4)
        if flags & ~3:
            raise ValueError("corrupt CausalContext token (flags)")
        has_residue, has_hlc = flags & 1, flags & 2
        off = 7
        entries = []
        for i in range(count):
            if off + 2 > len(data):
                raise ValueError(
                    f"truncated CausalContext token (entry {i} length)")
            (rlen,) = struct.unpack_from("<H", data, off)
            off += 2
            if off + rlen + 8 > len(data):
                raise ValueError(
                    f"truncated CausalContext token (entry {i} body)")
            try:
                rid = data[off: off + rlen].decode()
            except UnicodeDecodeError as e:
                raise ValueError(
                    f"corrupt CausalContext token (entry {i} id)") from e
            off += rlen
            (n,) = struct.unpack_from("<Q", data, off)
            off += 8
            entries.append((rid, n))
        hlc = 0.0
        if has_hlc:
            if off + 8 > len(data):
                raise ValueError(
                    "truncated CausalContext token (hlc watermark)")
            (hlc,) = struct.unpack_from("<d", data, off)
            off += 8
            if not (hlc > 0.0):     # also rejects NaN, -0.0 and negatives
                raise ValueError(
                    "corrupt CausalContext token (hlc watermark)")
        residue: Tuple[Any, ...] = ()
        if has_residue:
            stream = io.BytesIO(data[off:])
            try:
                residue = _ResidueUnpickler(stream).load()
            except Exception as e:
                raise ValueError(
                    "corrupt CausalContext token (residue)") from e
            if stream.read(1):       # pickle STOPs early on trailing bytes
                raise ValueError(
                    "corrupt CausalContext token (trailing bytes)")
            if not isinstance(residue, tuple):
                raise ValueError(
                    "corrupt CausalContext token (residue shape)")
        elif off != len(data):
            raise ValueError("corrupt CausalContext token (trailing bytes)")
        return CausalContext(entries=tuple(entries), residue=residue,
                             hlc=hlc)

    def __repr__(self) -> str:
        ent = ",".join(f"{r}:{n}" for r, n in self.entries)
        res = f"+{len(self.residue)}res" if self.residue else ""
        mark = f"@{self.hlc:g}" if self.hlc else ""
        return f"<ctx {ent or '∅'}{res}{mark}>"


#: The canonical "new session" context (no causal dependencies).
EMPTY_CONTEXT = CausalContext()
