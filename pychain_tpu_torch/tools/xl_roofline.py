"""XL-engine roofline probe on the card: does a tensor-core formulation of
the per-frame recurrence beat the CUDA-core one?

The port of ``tools/xl_roofline.py``.  That tool isolates the XL semiring
engine's per-frame recurrence (``ops/semiring_xl.py``) with no emissions
and nothing but the carry in the loop.  For each batch row b, random arc
lists ``src``, ``dst`` (B, K) over S states and weights ``w`` (K) shared
by the rows; the carry starts at 1/S and each of T frames computes

    asel[k] = nc[src[k]];  a[s] = sum_{k: dst[k] = s} asel[k] * w[k]
    nc = a * (1 / max(sum a, 1e-30))

Out comes the last carry (B, S) float32.  Three forms, three hand-written
CUDA kernels (``csrc/xl_roofline.cu``):

* ``vpu``: the CUDA cores (``xl_vpu``, for the tool's ``make_vpu``, T1):
  a row's states dealt out to 32 W threads in runs of whole states, their
  arcs in registers (:func:`vpu_plan`), one barrier a frame, the carry's
  sum taken by a warp of its own and applied a frame late (the same last
  carry, another rounding; see :func:`xl_vpu` for the range of w);
* ``mxu_f32``: the tensor cores, both contractions products with the {0,1}
  masks over only the fragments whose mask tile holds a nonzero (the arcs
  sorted by src and by dst, each tile's k-slabs listed:
  :func:`mxu_operands`), the masks as A tiles and each f32 operand split
  into three bf16 terms, B's columns 0-2: parity grade (``xl_mxu`` split
  3, for ``make_mxu`` at HIGHEST precision, T2);
* ``mxu_bf16``: the same products in one pass, the operand rounded to
  bf16 before each product, f32 accumulation: the TPU's DEFAULT precision
  (``xl_mxu`` split 1, for ``make_mxu`` on bf16 masks, T2).

A runner given CPU tensors computes its plain PyTorch version (an eager
frame loop over ``index_select`` and ``index_add_``; the f32 forms share
one, the bf16 form rounds as its kernel does); given CUDA tensors it
launches its kernel or raises.  Each launch adds one to
``LAUNCHES[name]``.  The plain versions do no matmul (only gathers,
scatter-adds and sums), so TF32 cannot enter them.

All three kernels and the plain versions take the normaliser sum a in
float64 and round it once to float32, where the tool takes it in float32:
a float32 sum's value depends on its order, and one ulp of it moves the
bf16 form's carry by about 1e-2 over 512 frames.  With the order taken
out, the bf16 kernel lands on its plain version bit for bit at the
tool's default batch (at B=128 on an H100 a few rows' sums round apart
inside the mma, 1.1e-7 relative: PERF.md), within its 5e-3 bar.

Usage::

    python -m pychain_tpu_torch.tools.xl_roofline [--s 1000] [--k 3200]
        [--t 512] [--b 8] [--iters 20] [--device cuda]

It prints each form's carry relative difference against ``vpu`` and its
times on stderr, and the tool's JSON line last on stdout:
``{"config": {"S", "K", "T", "B"}, "device": {...}, "results": {form:
{"compile_s", "ms_per_call", "us_per_frame"}}}``.  On the card
``compile_s`` is the kernel build plus the first call, and the times are
the kernel's on the arrays its runner makes of the arcs, made once
(:func:`kernel_call`: the arcs stay the same from call to call, as a
graph's do), in CUDA events, the best of 3 runs of ``iters`` calls after
a warm-up call; the making of those arrays is printed on stderr.  With
``--device cpu`` the plain versions run, timed on the host clock.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fact_kernels import MAX_SMEM, _check, _ptr, _require, _stream
from ..utils.device import resolve_device

TINY = 1e-30
FORMS = ("vpu", "mxu_f32", "mxu_bf16")
LAUNCHES = {"xl_vpu": 0, "xl_mxu_f32": 0, "xl_mxu_bf16": 0}
SPLIT = {"xl_mxu_f32": 3, "xl_mxu_bf16": 1}   # bf16 terms an f32 operand
MXU_PAD = 16        # the mma instruction's depth: S_pad, K_pad multiples


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def inputs(S: int, K: int, B: int, device=None):
    """The tool's inputs (tools/xl_roofline.py:157-160): the same draws of
    ``np.random.RandomState(0)`` in the same order, on ``device``
    (``None``: the card, raising without one)."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    src = rng.randint(0, S, (B, K)).astype(np.int32)
    dst = rng.randint(0, S, (B, K)).astype(np.int32)
    w = rng.rand(K).astype(np.float32) + 0.1
    return tuple(torch.from_numpy(a).to(device) for a in (src, dst, w))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (round to nearest even), back in float32."""
    return x.to(torch.bfloat16).float()


def recurrence_plain(src, dst, w, S: int, T: int, bf16: bool = False):
    """The plain version: an eager frame loop.  With ``bf16`` the carry and
    contrib are rounded to bfloat16 before each product, as ``xl_mxu``
    split 1 does.  The sums stay float32 but for sum a, which the kernels
    too take in float64 and round once: in float32 its value depends on
    the order of the sum, and one ulp of it grows into a 1.5e-2 drift of
    the bf16 carry in 512 frames (csrc/xl_roofline.cu)."""
    B, K = src.shape
    rows = torch.arange(B, device=src.device).unsqueeze(1) * S
    flat_src = (src.long() + rows).reshape(-1)
    flat_dst = (dst.long() + rows).reshape(-1)
    wb = w.float().expand(B, K).reshape(-1)
    nc = torch.full((B, S), 1.0 / S, dtype=torch.float32, device=src.device)
    for _ in range(T):
        carry = _bf16(nc) if bf16 else nc
        contrib = carry.reshape(-1).index_select(0, flat_src) * wb
        if bf16:
            contrib = _bf16(contrib)
        a = torch.zeros(B * S, dtype=torch.float32, device=src.device)
        a = a.index_add_(0, flat_dst, contrib).view(B, S)
        raw = a.double().sum(1, keepdim=True).float()
        nc = a * (1.0 / raw.clamp(min=TINY))
    return nc


# the growth g of a frame that xl_vpu's late scale keeps exact: the sum of
# the vector it stores runs through 1, g and g^2, which must stay a normal
# float32 (csrc/xl_roofline.cu)
VPU_GROWTH = (1e-19, 1e19)


def growth_bounds(src, w, S: int):
    """(least, largest) out-weight sum of a source state over the rows, as
    float64 0-dim tensors (no host read).  For w >= 0 a frame's growth g,
    sum a over sum nc = sum_s nc[s] out[s], is a mean of the out-weight
    sums of the states that hold the carry: at most the largest, and at
    least the least while the carry sits on sources (a carry drained into
    states without out-arcs grows less).  (inf, 0) without arcs."""
    B, K = src.shape
    if B * K == 0:
        inf = torch.tensor(float("inf"), dtype=torch.float64,
                           device=src.device)
        return inf, torch.zeros_like(inf)
    idx = src.long()
    out = torch.zeros(B, S, dtype=torch.float64, device=src.device)
    out.scatter_add_(1, idx, w.double().expand(B, K))
    is_src = torch.zeros(B, S, dtype=torch.bool, device=src.device)
    is_src.scatter_(1, idx, True)
    return out.masked_fill(~is_src, float("inf")).amin(), out.amax()


def _check_inputs(src, dst, w, S: int, T: int, growth: bool = False):
    """Shapes, types, device and id ranges, and with ``growth`` what
    :func:`xl_vpu` takes besides (w >= 0 and the :func:`growth_bounds` of
    the arcs within ``VPU_GROWTH``), in one host sync on the card (an id
    out of range would read outside the kernels' shared memory)."""
    _require(src.dim() == 2 and dst.shape == src.shape
             and src.dtype == dst.dtype == torch.int32,
             "src and dst must be (B, K) int32 tensors of one shape")
    B, K = src.shape
    _require(w.shape == (K,) and w.dtype == torch.float32,
             f"w must be a ({K},) float32 tensor")
    _require(src.device == dst.device == w.device,
             "src, dst and w must lie on one device")
    _require(S >= 1 and T >= 0, f"need S >= 1 and T >= 0, got S={S} T={T}")
    ids_ok = ((src >= 0) & (src < S) & (dst >= 0) & (dst < S)).all()
    if not growth:
        _require(bool(ids_ok), f"src and dst must lie in [0, S={S})")
        return
    lo, hi = growth_bounds(src.clamp(0, S - 1), w, S)
    w_min = w.amin().double() if K else torch.zeros_like(lo)
    ids_ok, lo, hi, w_min = torch.stack(
        [ids_ok.double(), lo, hi, w_min]).tolist()
    _require(ids_ok, f"src and dst must lie in [0, S={S})")
    g_lo, g_hi = VPU_GROWTH
    _require(w_min >= 0.0 and g_lo <= lo and hi <= g_hi,
             f"xl_vpu applies each frame's scale a frame late, so its carry "
             f"is the plain version's only while a frame's growth g (sum a "
             f"over sum nc) stays within [{g_lo:g}, {g_hi:g}]: these arcs' "
             f"source out-weight sums bound g to [{lo:g}, {hi:g}] (least w "
             f"{w_min:g}; w must be >= 0); the mxu forms and the plain "
             f"version take them")


# ----------------------------------------------------------------------
# xl_vpu (T1): the CUDA cores
# ----------------------------------------------------------------------

VPU_SLOTS = 24          # register slots a thread (the source's XL_VPU_SLOTS)
VPU_ARCS = 16           # a plan's arcs a thread (at most, about)


class VpuPlan(NamedTuple):
    """The arrays ``xl_vpu`` reads.  The arcs in destination order (a stable
    sort by dst), each source with bit 31 set on a state's last in-arc; a
    state without in-arcs has one arc from the zero slot S with weight 0.
    Thread i owns states tbeg[i] .. tbeg[i + 1] - 1 and their arcs toff[i]
    .. toff[i + 1] - 1.  With ``slots`` ``VPU_SLOTS``, ``src`` and ``w`` are
    (B, slots, threads): slot r of thread i, the slots past a thread's arcs
    padded with source S (the zero slot) and weight 0, so that they add
    nothing; with ``slots`` 0 (a run past the slots), (B, kc) in arc order
    in shared memory.  ``threads`` counts the compute threads; the block
    has a warp more, which sums the carry."""
    src: torch.Tensor
    w: torch.Tensor
    tbeg: torch.Tensor
    toff: torch.Tensor
    slots: int
    threads: int
    kc: int


def vpu_smem_bytes(S: int, kc: int, threads: int, slots: int) -> int:
    """Dynamic shared memory of ``xl_vpu`` (must equal xl_vpu_smem_bytes
    in the source): the compute threads' partials and the carry, both
    double-buffered (the carry with its zero slot), two scales, and with
    no register slots the arcs."""
    return 16 * threads + 16 + 8 * (S + 1) + (8 * kc if slots == 0 else 0)


def vpu_warps(K: int) -> int:
    """The compute warps a row: the least power of two that gives a thread
    at most ``VPU_ARCS`` of the K arcs, 1 to 16 (8 at the tool's default
    size, the fastest count there: PERF.md)."""
    warps = 1
    while warps < 16 and K > 32 * warps * VPU_ARCS:
        warps *= 2
    return warps


@functools.lru_cache(maxsize=64)
def _iota(n: int, device) -> torch.Tensor:
    """0 .. n - 1 (int64) on ``device``, made once: the plans index with it
    on every call."""
    return torch.arange(n, device=device)


def vpu_plan(src, dst, w, S: int) -> VpuPlan:
    """Deal a row's arcs out to :func:`vpu_warps` x 32 threads in
    contiguous runs of whole states, about the same number of arcs each,
    held in ``VPU_SLOTS`` register slots where every run fits (one host
    read: the longest run), else in shared memory.  The arcs are K + S a
    row, those past the row's count on no state."""
    B, K = src.shape
    dev = src.device
    src64, dst64 = src.long(), dst.long()
    deg = torch.zeros(B, S, dtype=torch.int64, device=dev).scatter_add_(
        1, dst64, _iota(2, dev)[1:].expand(B, K))
    empty = deg == 0
    n_arcs = K + empty.sum(1)                            # (B,)
    states = _iota(S, dev).expand(B, S)
    # an arc for each state without in-arcs, from the zero slot S with
    # weight 0; the others' go past state S
    key = torch.cat([dst64, states.masked_fill(~empty, S)], 1)
    key, order = torch.sort(key, dim=1, stable=True)
    kc = K + S
    dummy = order >= K
    arc = order.clamp(max=max(K - 1, 0))
    src_c = src64.gather(1, arc).masked_fill(dummy, S)
    w_c = w.float()[arc].masked_fill(dummy, 0.0)
    ptr = torch.searchsorted(key, _iota(S + 1, dev).expand(B, S + 1)
                             .contiguous())
    # bit 31 on each state's last in-arc
    packed = src_c.scatter_add(1, ptr[:, 1:] - 1, torch.full_like(
        ptr[:, 1:], -2 ** 31))
    nt = 32 * vpu_warps(K)
    tbeg = torch.searchsorted(ptr, (_iota(nt + 1, dev) * n_arcs[:, None])
                              // nt)
    toff = ptr.gather(1, tbeg)
    count = toff[:, 1:] - toff[:, :-1]
    slots = VPU_SLOTS if B == 0 or int(count.max()) <= VPU_SLOTS else 0
    if slots:
        r = _iota(slots, dev)
        idx = (toff[:, :nt, None] + r).clamp(max=kc - 1).view(B, -1)
        pad = (r >= count[:, :, None]).view(B, -1)
        src_a = packed.gather(1, idx).masked_fill(pad, S)
        w_a = w_c.gather(1, idx).masked_fill(pad, 0.0)
        src_a = src_a.view(B, nt, slots).transpose(1, 2)
        w_a = w_a.view(B, nt, slots).transpose(1, 2)
    else:
        src_a, w_a = packed, w_c
    return VpuPlan(src_a.to(torch.int32).contiguous(), w_a.contiguous(),
                   tbeg.to(torch.int32).contiguous(),
                   toff.to(torch.int32).contiguous(), slots, nt, kc)


def xl_vpu(src, dst, w, S: int, T: int):
    """The carry after T frames, (B, S) float32.  On CUDA this launches
    ``xl_vpu`` on :func:`vpu_plan`'s plan; on the CPU it computes the plain
    version.  The kernel applies each frame's scale a frame late, so the
    sum of what it stores runs through 1, g and g^2 for a frame's growth g
    (sum a over sum nc): its carry is the plain version's while 1e-19 <= g
    <= 1e19 (the tool's weights, 0.1 to 1.1, give g about 2).  On either
    device it raises ValueError where a weight is negative or the
    :func:`growth_bounds` of the arcs leave that range (``VPU_GROWTH``)."""
    _check_inputs(src, dst, w, S, T, growth=True)
    if not src.is_cuda:
        return recurrence_plain(src, dst, w, S, T)
    return vpu_kernel(vpu_plan(src, dst, w, S), S, T)


def vpu_kernel(plan: VpuPlan, S: int, T: int):
    """Launch ``xl_vpu`` on :func:`vpu_plan`'s arrays of checked inputs."""
    B = plan.tbeg.shape[0]
    smem = vpu_smem_bytes(S, plan.kc, plan.threads, plan.slots)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"xl_vpu keeps a row's carry (and without register slots its "
            f"arcs) in one block's shared memory: S={S}, {plan.kc} arcs, "
            f"{plan.threads} threads, {plan.slots} slots need {smem} bytes, "
            f"over the {MAX_SMEM} a Hopper block has (16 threads + 8 (S + "
            f"1) + 16 + 8 arcs without slots <= {MAX_SMEM})")
    out = torch.empty(B, S, dtype=torch.float32, device=plan.src.device)
    rc = _lib("xl_vpu")(_ptr(plan.src), _ptr(plan.w), _ptr(plan.tbeg),
                        _ptr(plan.toff), B, S, plan.kc, plan.threads,
                        plan.slots, T, _init(S), _ptr(out), _stream())
    _check(rc, "xl_vpu")
    LAUNCHES["xl_vpu"] += 1
    return out


# ----------------------------------------------------------------------
# xl_mxu (T2): the tensor cores, split 3 (f32 parity) or 1 (bf16)
# ----------------------------------------------------------------------

# an issued fragment's share of the dense form's operations, a bf16 term:
# 16 arcs or states by a slab of 16
MXU_FRAGMENT_OPS = 2 * 16 * 16


def _pad(n: int) -> int:
    return -(-n // MXU_PAD) * MXU_PAD


class MxuOperands(NamedTuple):
    """The arrays ``xl_mxu`` reads, each (B, ...) int32 or float32: the arcs
    in src order (a stable sort by src: ``src_s``, ``w_s``, and ``perm``,
    each one's position in dst order) and in dst order (``dst_d``), padded
    to K_pad with source and destination -1 (in no mask) and weight 0; and
    the tile lists (B, n, 2): for each tile, the first 16-wide k-slab its
    mask touches and how many (``tiles1``: 16 arcs in src order against
    slabs of states; ``tiles2``: 16 states against slabs of arcs in dst
    order).  The fragments outside the lists are all zero.  A tile of
    padding lists none, from the slab past the last arc's (so the first
    slabs and the ends stay ascending)."""
    src_s: torch.Tensor
    w_s: torch.Tensor
    perm: torch.Tensor
    dst_d: torch.Tensor
    tiles1: torch.Tensor
    tiles2: torch.Tensor


def mxu_smem_bytes(s_pad: int, k_pad: int, split: int) -> int:
    """Dynamic shared memory of ``xl_mxu`` (must equal xl_mxu_smem_bytes
    in the source): the warp partials, the tile lists, a, the sorted arcs
    (four arrays), asel and the carry's and contrib's bf16 terms."""
    return (8 * 32 + k_pad // 2 + s_pad // 2 + 4 * s_pad + 20 * k_pad
            + 2 * split * (s_pad + k_pad))


def mxu_operands(src, dst, w, S: int) -> MxuOperands:
    """Sort and pad a batch's arcs and list each tile's nonzero k-slabs,
    with tensor operations on the arcs' device (no host sync)."""
    B, K = src.shape
    dev = src.device
    k_pad, s_pad = _pad(K), _pad(S)
    pad = (0, k_pad - K)
    by_src = torch.sort(src, dim=1, stable=True)
    by_dst = torch.sort(dst, dim=1, stable=True)
    src_s = torch.nn.functional.pad(by_src.values, pad, value=-1)
    dst_d = torch.nn.functional.pad(by_dst.values, pad, value=-1)
    w_s = torch.nn.functional.pad(w.float()[by_src.indices], pad)
    # each arc's dst-order position, read in src order (padding: in place)
    at_dst = torch.empty(B, K, dtype=torch.int64, device=dev).scatter_(
        1, by_dst.indices, _iota(K, dev).expand(B, K))
    perm = torch.cat([at_dst.gather(1, by_src.indices),
                      _iota(k_pad, dev)[K:].expand(B, k_pad - K)], 1)
    # first product: arc tiles 16 n .. 16 n + 15 (their real arcs)
    # against the slabs of their sources, first to last (sorted:
    # contiguous); a tile of padding from the slab past the last arc's
    first = _iota(k_pad, dev)[::16]
    padding = first >= K
    last_arc = max(K - 1, 0)
    lo = src_s[:, first.clamp(max=last_arc)] // 16
    hi = src_s[:, (first + 15).clamp(max=last_arc)] // 16
    if K:
        lo = torch.where(padding, src_s[:, last_arc:K] // 16 + 1, lo)
    tiles1 = torch.stack([lo, (hi - lo + 1).masked_fill(padding, 0)], -1)
    # second product: state tiles 16 m .. 16 m + 15 against the slabs of
    # their in-arcs, dst-order positions [start, stop)
    pos = torch.searchsorted(by_dst.values.contiguous(),
                             _iota(s_pad + 1, dev)[::16].to(torch.int32)
                             .expand(B, -1).contiguous())
    start, stop = pos[:, :-1], pos[:, 1:]
    none = stop <= start
    tiles2 = torch.stack([(start // 16).masked_fill(none, 0),
                          ((stop - 1) // 16 - start // 16 + 1)
                          .masked_fill(none, 0)], -1)
    return MxuOperands(src_s, w_s, perm.to(torch.int32), dst_d,
                       tiles1.to(torch.int32).contiguous(),
                       tiles2.to(torch.int32).contiguous())


def issued_fragments(ops: MxuOperands):
    """The mma fragments ``xl_mxu`` issues a frame, over all rows: those
    the tile lists hold (the mask tiles with a nonzero), (first product,
    second product); one host read."""
    return int(ops.tiles1[..., 1].sum()), int(ops.tiles2[..., 1].sum())


def issued_ops(ops: MxuOperands) -> int:
    """The issued fragments' share of the dense form's operations a frame
    and bf16 term, over all rows (``tc_dense_ops``' units: the dense form
    issues 4 S_pad K_pad a row)."""
    return sum(issued_fragments(ops)) * MXU_FRAGMENT_OPS


def _xl_mxu(name, src, dst, w, S: int, T: int):
    _check_inputs(src, dst, w, S, T)
    if not src.is_cuda:
        return recurrence_plain(src, dst, w, S, T, bf16=SPLIT[name] == 1)
    return mxu_kernel(name, mxu_operands(src, dst, w, S), S, T)


def mxu_kernel(name, ops: MxuOperands, S: int, T: int):
    """Launch ``xl_mxu`` (``name``: xl_mxu_f32 or xl_mxu_bf16) on
    :func:`mxu_operands`' arrays of checked inputs."""
    B, k_pad = ops.src_s.shape
    split, s_pad = SPLIT[name], _pad(S)
    smem = mxu_smem_bytes(s_pad, k_pad, split)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"{name} keeps a row's arcs, tile lists, carry and contrib in "
            f"one block's shared memory: S_pad={s_pad}, K_pad={k_pad} need "
            f"{smem} bytes, over the {MAX_SMEM} a Hopper block has ((20.5 "
            f"+ 2 split) K_pad + (4.5 + 2 split) S_pad + 256 <= "
            f"{MAX_SMEM})")
    out = torch.empty(B, S, dtype=torch.float32, device=ops.src_s.device)
    rc = _lib("xl_mxu")(*(_ptr(a) for a in ops), B, S, s_pad, k_pad, T,
                        _init(S), split, _ptr(out), _stream())
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def xl_mxu_f32(src, dst, w, S: int, T: int):
    """The carry after T frames on the tensor cores, parity grade (three
    bf16 terms an operand).  On the CPU: the plain f32 version."""
    return _xl_mxu("xl_mxu_f32", src, dst, w, S, T)


def xl_mxu_bf16(src, dst, w, S: int, T: int):
    """The carry after T frames on the tensor cores, the operand rounded to
    bf16 before each product.  On the CPU: the plain bf16 version."""
    return _xl_mxu("xl_mxu_bf16", src, dst, w, S, T)


RUNNERS = {"vpu": xl_vpu, "mxu_f32": xl_mxu_f32, "mxu_bf16": xl_mxu_bf16}
KERNELS = {"vpu": "xl_vpu", "mxu_f32": "xl_mxu_f32",
           "mxu_bf16": "xl_mxu_bf16"}


def plain(form: str, src, dst, w, S: int, T: int):
    """The plain version of ``form`` on any device."""
    return recurrence_plain(src, dst, w, S, T, bf16=form == "mxu_bf16")


def kernel_call(form: str, src, dst, w, S: int, T: int):
    """``form``'s kernel as a function of no arguments, on the arrays its
    runner makes of the arcs (a plan or operands), made once here: what
    the tool times on the card, where the runner adds a host read or two
    and a few dozen small operations to every call."""
    _check_inputs(src, dst, w, S, T, growth=form == "vpu")
    if form == "vpu":
        return functools.partial(vpu_kernel, vpu_plan(src, dst, w, S), S, T)
    return functools.partial(mxu_kernel, KERNELS[form],
                             mxu_operands(src, dst, w, S), S, T)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _init(S: int):
    """The first carry 1/S as float32, as the plain version's."""
    return _F(float(np.float32(1.0 / S)))


def _lib(fn_name: str):
    from ..csrc import build
    fn = getattr(build.load("xl_roofline"), f"{fn_name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 4 + [_I] * 6 + [_F, _P, _P]
                       if fn_name == "xl_vpu" else
                       [_P] * 6 + [_I] * 5 + [_F, _I, _P, _P])
        fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------------------
# The tool
# ----------------------------------------------------------------------

def rel_diff(y, ref) -> float:
    """The tool's carry relative difference: max |y - ref| / max(|ref|,
    1e-9)."""
    y, ref = y.double(), ref.double()
    return float(((y - ref).abs() / ref.abs().clamp(min=1e-9)).max())


def _best_ms(fn, iters: int, cuda: bool) -> float:
    """Best of 3 runs of iters calls, ms a call."""
    best = float("inf")
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = min(best, ms)
    return best


def probe(S=1000, K=3200, T=512, B=8, iters=20, device=None) -> dict:
    """Run the three forms on the tool's inputs; returns the JSON line's
    dict.  ``device=None`` means the card, and raises without one."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu (plain versions)"
    src, dst, w = inputs(S, K, B, dev)
    out = {"config": {"S": S, "K": K, "T": T, "B": B},
           "device": {"platform": "gpu" if cuda else "cpu", "kind": kind},
           "results": {}}
    ref = None
    for form, run in RUNNERS.items():
        t0 = time.perf_counter()
        if cuda:
            from ..csrc import build
            build.load("xl_roofline")
        y = run(src, dst, w, S, T)
        if cuda:
            torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        if ref is None:
            ref = y
        else:
            print(f"# [{form}] carry rel diff vs vpu after {T} frames: "
                  f"{rel_diff(y, ref):.2e}", file=sys.stderr)
        call = functools.partial(run, src, dst, w, S, T)
        if cuda:                     # the kernel on arrays made once
            t0 = time.perf_counter()
            call = kernel_call(form, src, dst, w, S, T)
            torch.cuda.synchronize()
            plan_ms = 1e3 * (time.perf_counter() - t0)
            print(f"# [{form}] the runner's plan {plan_ms:.3f} ms (host "
                  f"clock, once)", file=sys.stderr)
        call()                                       # warm-up
        ms = _best_ms(call, iters, cuda)
        us = ms * 1e3 / (B * T)
        print(f"# [{form}] compile {compile_s:.1f}s  {ms:.3f} ms/call  "
              f"{us:.4f} us/frame/seq", file=sys.stderr)
        out["results"][form] = {"compile_s": compile_s, "ms_per_call": ms,
                                "us_per_frame": us}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--s", type=int, default=1000)
    ap.add_argument("--k", type=int, default=3200)
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    out = probe(args.s, args.k, args.t, args.b, args.iters, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
