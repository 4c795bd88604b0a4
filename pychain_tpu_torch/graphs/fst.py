"""Finite-state transducer container and I/O (numpy).

The port's own copy of ``pychain_tpu/graphs/fst.py``: the port imports
nothing of the JAX package, so the host-side graph code lives here too.
FSTs are plain numpy arrays, with the on-disk formats implemented
directly:

* OpenFST binary ``VectorFst<StdArc>`` read/write,
* OpenFST binary ``ConstFst<StdArc>`` read (aligned and unaligned), and
  files with embedded symbol tables (tables are skipped; labels stay
  numeric),
* the AT&T text format (``fstcompile``-style),
* Kaldi ``.ark`` archives of FSTs (``read_ark``/``write_ark``).

Weights are tropical-semiring ``float32`` (i.e. negated log-probs), as in
OpenFST's ``StdArc``.  A non-final state has final weight ``+inf``.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

# OpenFST binary header constants (see OpenFST's fst/fst.h FstHeader).
_FST_MAGIC = 2125659606
_FST_TYPE = b"vector"
_ARC_TYPE = b"standard"
_VECTOR_FST_FILE_VERSION = 2
# FstHeader flag bits indicating embedded symbol tables.
_HAS_ISYMBOLS = 0x1
_HAS_OSYMBOLS = 0x2
_SYMBOL_TABLE_MAGIC = 2125658996  # openfst symbol-table.cc
_CONST_FILE_VERSION = 2           # const-fst.h kFileVersion (unaligned)
_CONST_ALIGNED_VERSION = 1        # kAlignedFileVersion (16-byte aligned)
_CONST_ALIGN = 16                 # MappedFile::kArchAlignment

NO_STATE_ID = -1
INFINITY = float("inf")


def _remaining_bytes(f) -> int:
    """Bytes from the current position to EOF (position preserved) —
    the bound every corrupted-count guard checks before allocating
    (the same bound the JAX package's native reader applies, so the
    two accept and reject the same files)."""
    pos = f.tell()
    f.seek(0, 2)
    rem = f.tell() - pos
    f.seek(pos)
    return rem


def _skip_symbol_table(f) -> None:
    """Skip one serialized OpenFST SymbolTable (symbol-table.cc): magic,
    name string, available_key i64, size i64, then (string, i64 key)
    per symbol.  Labels in this package stay numeric, matching
    fst_to_tensor's pdf_id = ilabel - 1 semantics."""
    magic = struct.unpack("<i", f.read(4))[0]
    if magic != _SYMBOL_TABLE_MAGIC:
        raise ValueError(f"bad symbol table magic {magic}")
    name_len = struct.unpack("<i", f.read(4))[0]
    f.read(name_len)
    f.read(8)  # available_key
    size = struct.unpack("<q", f.read(8))[0]
    for _ in range(size):
        slen = struct.unpack("<i", f.read(4))[0]
        f.read(slen + 8)


@dataclass
class FST:
    """A weighted FST over the tropical semiring (StdArc equivalent).

    Arcs are stored in struct-of-arrays form, concatenated over states in
    state order; ``arc_offsets`` has ``num_states + 1`` entries delimiting
    each state's out-arcs (CSR layout).
    """

    start: int = NO_STATE_ID
    # (S,) float32 final weights; +inf for non-final states.
    final: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    # (S+1,) int64 CSR offsets into the arc arrays.
    arc_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    # (K,) arc fields.
    ilabels: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    olabels: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    weights: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    nextstates: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    # ------------------------------------------------------------------
    # Introspection (mirrors simplefst.StdVectorFst, fstext.cc:174-184)
    # ------------------------------------------------------------------
    @property
    def num_states(self) -> int:
        return int(self.final.shape[0])

    @property
    def num_arcs(self) -> int:
        return int(self.ilabels.shape[0])

    def start_state(self) -> int:
        return self.start

    def state_arcs(self, s: int):
        """Return (ilabels, olabels, weights, nextstates) slices for state s."""
        lo, hi = int(self.arc_offsets[s]), int(self.arc_offsets[s + 1])
        return (
            self.ilabels[lo:hi],
            self.olabels[lo:hi],
            self.weights[lo:hi],
            self.nextstates[lo:hi],
        )

    def validate(self) -> None:
        s = self.num_states
        if s == 0:
            if self.start != NO_STATE_ID:
                raise ValueError("empty FST must have no start state")
            return
        if not (0 <= self.start < s):
            raise ValueError(f"start state {self.start} out of range [0, {s})")
        if self.arc_offsets.shape[0] != s + 1:
            raise ValueError("arc_offsets must have num_states + 1 entries")
        if self.num_arcs and (
            self.nextstates.min() < 0 or self.nextstates.max() >= s
        ):
            raise ValueError("arc nextstate out of range")
        if self.num_arcs and self.ilabels.min() < 0:
            raise ValueError("negative arc ilabel")
        if int(self.arc_offsets[-1]) > self.num_arcs:
            raise ValueError("arc_offsets exceed the arc arrays")

    # ------------------------------------------------------------------
    # Builders
    # ------------------------------------------------------------------
    @staticmethod
    def from_arcs(num_states, start, arcs, finals) -> "FST":
        """Build from a list of (src, dst, ilabel, olabel, weight) tuples and
        a {state: final_weight} mapping."""
        final = np.full(num_states, INFINITY, np.float32)
        for st, w in finals.items():
            final[st] = w
        arcs = sorted(arcs, key=lambda a: a[0])  # stable by source state
        src = np.array([a[0] for a in arcs], np.int64)
        counts = np.bincount(src, minlength=num_states) if len(arcs) else np.zeros(
            num_states, np.int64
        )
        offsets = np.zeros(num_states + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        fst = FST(
            start=start,
            final=final,
            arc_offsets=offsets,
            ilabels=np.array([a[2] for a in arcs], np.int32),
            olabels=np.array([a[3] for a in arcs], np.int32),
            weights=np.array([a[4] for a in arcs], np.float32),
            nextstates=np.array([a[1] for a in arcs], np.int32),
        )
        fst.validate()
        return fst

    @staticmethod
    def linear(pdf_ids, weights=None, final_weight=0.0) -> "FST":
        """A linear chain FST emitting ``ilabel = pdf_id + 1`` per frame.

        Handy for numerator supervision in tests: state t --(pdf_ids[t])--> t+1.
        """
        n = len(pdf_ids)
        if weights is None:
            weights = [0.0] * n
        arcs = [
            (t, t + 1, int(pdf_ids[t]) + 1, int(pdf_ids[t]) + 1, float(weights[t]))
            for t in range(n)
        ]
        return FST.from_arcs(n + 1, 0, arcs, {n: final_weight})

    # ------------------------------------------------------------------
    # OpenFST binary format
    # ------------------------------------------------------------------
    @staticmethod
    def read(filename: str) -> "FST":
        """Read an OpenFST binary VectorFst<StdArc> file (StdVectorFst.read)."""
        with open(filename, "rb") as f:
            return FST.read_stream(f)

    @staticmethod
    def read_ark(filename: str, offset: int) -> "FST":
        """Read an FST from a Kaldi ark at a byte offset (fstext.cc:7-17).

        The offset points at the FST header, i.e. just past the
        ``key<space>\\0B`` marker, matching the reference's semantics.
        """
        with open(filename, "rb") as f:
            f.seek(offset)
            return FST.read_stream(f)

    @staticmethod
    def read_stream(f) -> "FST":
        def read_i32():
            return struct.unpack("<i", f.read(4))[0]

        def read_i64():
            return struct.unpack("<q", f.read(8))[0]

        magic = read_i32()
        if magic != _FST_MAGIC:
            raise ValueError(f"bad FST magic number {magic}")
        fsttype = f.read(read_i32())
        arctype = f.read(read_i32())
        if fsttype not in (b"vector", b"const"):
            raise ValueError(f"unsupported FST type {fsttype!r}")
        if arctype != _ARC_TYPE:
            raise ValueError(f"unsupported arc type {arctype!r}")
        version = read_i32()
        flags = read_i32()
        _properties = struct.unpack("<Q", f.read(8))[0]
        start = read_i64()
        num_states = read_i64()
        num_arcs = read_i64()
        # Embedded symbol tables sit between the header and the states
        # (FstImpl::ReadHeader); the reference reads them transparently
        # through OpenFST — we skip them (labels stay numeric).
        if flags & _HAS_ISYMBOLS:
            _skip_symbol_table(f)
        if flags & _HAS_OSYMBOLS:
            _skip_symbol_table(f)
        # corrupted-count guards: counts beyond the remaining payload
        # reject BEFORE any allocation
        rem = _remaining_bytes(f)
        if (start < -1 or num_states < 0 or num_arcs < 0
                or num_arcs > rem // 16):
            raise ValueError("corrupt FST header counts")
        if fsttype == b"const":
            return FST._read_const_body(f, version, start, num_states,
                                        num_arcs)
        if version < 2:
            raise ValueError(f"unsupported VectorFst version {version}")
        if num_states > rem // 12:
            raise ValueError("corrupt FST header counts")

        if num_states <= 0:
            return FST()

        # Bulk-read the per-state records.  Record layout per state:
        #   float32 final; int64 narcs; narcs * (i32 il, i32 ol, f32 w, i32 ns)
        final = np.empty(num_states, np.float32)
        offsets = np.zeros(num_states + 1, np.int64)
        chunks = []
        arc_dt = np.dtype(
            [("il", "<i4"), ("ol", "<i4"), ("w", "<f4"), ("ns", "<i4")]
        )
        for s in range(num_states):
            hdr = f.read(12)
            final[s] = np.frombuffer(hdr, "<f4", count=1, offset=0)[0]
            narcs = struct.unpack("<q", hdr[4:12])[0]
            if narcs < 0 or narcs > rem // 16:
                raise ValueError("corrupt FST state arc count")
            offsets[s + 1] = offsets[s] + narcs
            if narcs:
                chunks.append(np.frombuffer(f.read(16 * narcs), arc_dt,
                                            count=narcs))
        if chunks:
            arcs = np.concatenate(chunks)
        else:
            arcs = np.zeros(0, arc_dt)
        fst = FST(
            start=int(start),
            final=final,
            arc_offsets=offsets,
            ilabels=arcs["il"].astype(np.int32),
            olabels=arcs["ol"].astype(np.int32),
            weights=arcs["w"].astype(np.float32),
            nextstates=arcs["ns"].astype(np.int32),
        )
        fst.validate()
        return fst

    @staticmethod
    def _read_const_body(f, version, start, num_states, num_arcs) -> "FST":
        """ConstFst<StdArc, uint32> payload (openfst const-fst.h): a
        flat array of {f32 final, u32 pos, u32 narcs, u32 niepsilons,
        u32 noepsilons} state records followed by a flat array of
        {i32 il, i32 ol, f32 w, i32 ns} arcs.  The aligned variant
        (version 1) pads each array to a 16-byte file offset."""
        if version not in (_CONST_FILE_VERSION, _CONST_ALIGNED_VERSION):
            raise ValueError(f"unsupported ConstFst version {version}")

        def align():
            if version == _CONST_ALIGNED_VERSION:
                pad = (-f.tell()) % _CONST_ALIGN
                if pad:
                    f.read(pad)

        if num_states <= 0:
            return FST()
        rem = _remaining_bytes(f)
        if num_states > rem // 20:
            raise ValueError("corrupt ConstFst header counts")
        state_dt = np.dtype([("final", "<f4"), ("pos", "<u4"),
                             ("narcs", "<u4"), ("nieps", "<u4"),
                             ("noeps", "<u4")])
        arc_dt = np.dtype([("il", "<i4"), ("ol", "<i4"), ("w", "<f4"),
                           ("ns", "<i4")])
        align()
        states = np.frombuffer(
            f.read(state_dt.itemsize * num_states), state_dt,
            count=num_states)
        align()
        arcs = np.frombuffer(f.read(arc_dt.itemsize * num_arcs), arc_dt,
                             count=num_arcs)
        narcs = states["narcs"].astype(np.int64)
        offsets = np.zeros(num_states + 1, np.int64)
        np.cumsum(narcs, out=offsets[1:])
        # ConstFst stores pos explicitly; our CSR assumes contiguity —
        # true for anything fstconvert produces (arcs in state order)
        if not np.array_equal(states["pos"].astype(np.int64),
                              offsets[:-1]):
            raise ValueError("ConstFst arcs not in state order")
        fst = FST(
            start=int(start),
            final=states["final"].astype(np.float32),
            arc_offsets=offsets,
            ilabels=arcs["il"].astype(np.int32),
            olabels=arcs["ol"].astype(np.int32),
            weights=arcs["w"].astype(np.float32),
            nextstates=arcs["ns"].astype(np.int32),
        )
        fst.validate()
        return fst

    def write(self, filename: str) -> bool:
        """Write OpenFST binary VectorFst<StdArc> (StdVectorFst.write)."""
        with open(filename, "wb") as f:
            self.write_stream(f)
        return True

    def write_stream(self, f) -> None:
        def w_i32(v):
            f.write(struct.pack("<i", v))

        def w_i64(v):
            f.write(struct.pack("<q", v))

        w_i32(_FST_MAGIC)
        w_i32(len(_FST_TYPE))
        f.write(_FST_TYPE)
        w_i32(len(_ARC_TYPE))
        f.write(_ARC_TYPE)
        w_i32(_VECTOR_FST_FILE_VERSION)
        w_i32(0)  # flags: no symbol tables
        f.write(struct.pack("<Q", 0))  # properties (none asserted)
        # n_states: simplefst.StdVectorFst makes num_states a method
        num_states = n_states(self)
        w_i64(self.start)
        w_i64(num_states)
        w_i64(self.num_arcs)
        arc_dt = np.dtype(
            [("il", "<i4"), ("ol", "<i4"), ("w", "<f4"), ("ns", "<i4")]
        )
        for s in range(num_states):
            lo, hi = int(self.arc_offsets[s]), int(self.arc_offsets[s + 1])
            f.write(struct.pack("<f", float(self.final[s])))
            f.write(struct.pack("<q", hi - lo))
            if hi > lo:
                rec = np.empty(hi - lo, arc_dt)
                rec["il"] = self.ilabels[lo:hi]
                rec["ol"] = self.olabels[lo:hi]
                rec["w"] = self.weights[lo:hi]
                rec["ns"] = self.nextstates[lo:hi]
                f.write(rec.tobytes())

    # ------------------------------------------------------------------
    # AT&T text format
    # ------------------------------------------------------------------
    @staticmethod
    def from_text(text: str) -> "FST":
        """Parse fstcompile-style text: arc lines ``src dst il ol [w]`` and
        final lines ``state [w]``.  The first mentioned state is the start."""
        arcs = []
        finals = {}
        start = None
        max_state = -1
        for line in text.splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) in (1, 2):
                st = int(parts[0])
                w = float(parts[1]) if len(parts) == 2 else 0.0
                finals[st] = w
                max_state = max(max_state, st)
                if start is None:
                    start = st
            elif len(parts) in (4, 5):
                src, dst = int(parts[0]), int(parts[1])
                il, ol = int(parts[2]), int(parts[3])
                w = float(parts[4]) if len(parts) == 5 else 0.0
                arcs.append((src, dst, il, ol, w))
                max_state = max(max_state, src, dst)
                if start is None:
                    start = src
            else:
                raise ValueError(f"bad FST text line: {line!r}")
        if start is None:
            return FST()
        return FST.from_arcs(max_state + 1, start, arcs, finals)

    def to_text(self) -> str:
        lines = []
        order = [self.start] + [s for s in range(self.num_states) if s != self.start]
        for s in order:
            il, ol, w, ns = self.state_arcs(s)
            for k in range(len(il)):
                lines.append(f"{s} {int(ns[k])} {int(il[k])} {int(ol[k])} {float(w[k])!r}")
        for s in order:
            if np.isfinite(self.final[s]):
                lines.append(f"{s} {float(self.final[s])!r}")
        return "\n".join(lines) + "\n"


def n_states(fst) -> int:
    """Number of states, accepting both the property-style :class:`FST`
    and the method-style reference API (``StdVectorFst.num_states()``)."""
    v = fst.num_states
    return int(v() if callable(v) else v)


def n_arcs(fst) -> int:
    v = fst.num_arcs
    return int(v() if callable(v) else v)


# ----------------------------------------------------------------------
# Kaldi ark archives of FSTs
# ----------------------------------------------------------------------
def write_ark(filename: str, items) -> dict:
    """Write ``{key: FST}`` pairs to a Kaldi binary ark.

    Returns ``{key: offset}`` where the offset points at the FST header,
    suitable for ``FST.read_ark`` / the reference's ``read_ark``
    (fstext.cc:7-17 seeks straight to the header).
    """
    offsets = {}
    with open(filename, "wb") as f:
        for key, fst in items.items() if isinstance(items, dict) else items:
            f.write(key.encode() + b" ")
            f.write(b"\x00B")  # Kaldi binary-mode marker
            offsets[key] = f.tell()
            fst.write_stream(f)
    return offsets


def read_ark_sequential(filename: str):
    """Yield (key, FST) pairs from a Kaldi binary ark of FSTs."""
    with open(filename, "rb") as f:
        while True:
            key = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key += c
            marker = f.read(2)
            if marker != b"\x00B":
                raise ValueError("only Kaldi binary-mode arks are supported")
            yield key.decode(), FST.read_stream(f)
