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

* ``vpu``: the CUDA cores (``xl_vpu``, for the tool's ``make_vpu``, T1);
* ``mxu_f32``: the tensor cores, both contractions dense products with the
  {0,1} masks, each f32 operand split into three bf16 terms: parity grade
  (``xl_mxu`` split 3, for ``make_mxu`` at HIGHEST precision, T2);
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
out, the bf16 kernel lands on its plain version bit for bit, so its 5e-3
bar is in effect a check of bit identity.

Usage::

    python -m pychain_tpu_torch.tools.xl_roofline [--s 1000] [--k 3200]
        [--t 512] [--b 8] [--iters 20] [--device cuda]

It prints each form's carry relative difference against ``vpu`` and its
times on stderr, and the tool's JSON line last on stdout:
``{"config": {"S", "K", "T", "B"}, "device": {...}, "results": {form:
{"compile_s", "ms_per_call", "us_per_frame"}}}``.  On the card
``compile_s`` is the kernel build plus the first call, and the times are
CUDA events, the best of 3 runs of ``iters`` calls after a warm-up call.
With ``--device cpu`` the plain versions run, timed on the host clock.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

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


def _check_inputs(src, dst, w, S: int, T: int):
    """Shapes, types, device and id ranges (one host sync on the card: an
    id out of range would read outside the kernels' shared memory)."""
    _require(src.dim() == 2 and dst.shape == src.shape
             and src.dtype == dst.dtype == torch.int32,
             "src and dst must be (B, K) int32 tensors of one shape")
    B, K = src.shape
    _require(w.shape == (K,) and w.dtype == torch.float32,
             f"w must be a ({K},) float32 tensor")
    _require(src.device == dst.device == w.device,
             "src, dst and w must lie on one device")
    _require(S >= 1 and T >= 0, f"need S >= 1 and T >= 0, got S={S} T={T}")
    _require(bool(((src >= 0) & (src < S) & (dst >= 0) & (dst < S)).all()),
             f"src and dst must lie in [0, S={S})")


# ----------------------------------------------------------------------
# xl_vpu (T1): the CUDA cores
# ----------------------------------------------------------------------

def vpu_smem_bytes(S: int, K: int) -> int:
    """Dynamic shared memory of ``xl_vpu`` (must equal
    xl_vpu_smem_bytes in the source): the CSR offsets, the in-arcs'
    sources and weights, a double-buffered, the warp partials."""
    return 2 * 32 * 8 + 4 * (S + 1) + 8 * K + 8 * S


def vpu_csr(src, dst, w, S: int):
    """The arcs as ``xl_vpu`` reads them: per row, the in-arcs of each
    destination, a stable sort by dst (ascending arc id within a state).
    Returns ptr (B, S+1) int32 and in_src, in_w (B, K)."""
    order = torch.sort(dst, dim=1, stable=True)
    ptr = torch.searchsorted(
        order.values.contiguous(),
        torch.arange(S + 1, dtype=torch.int32, device=dst.device)
        .expand(dst.shape[0], S + 1).contiguous())
    return (ptr.to(torch.int32).contiguous(),
            src.gather(1, order.indices).contiguous(),
            w[order.indices].contiguous())


def xl_vpu(src, dst, w, S: int, T: int):
    """The carry after T frames, (B, S) float32.  On CUDA this launches
    ``xl_vpu``; on the CPU it computes the plain version."""
    _check_inputs(src, dst, w, S, T)
    if not src.is_cuda:
        return recurrence_plain(src, dst, w, S, T)
    return vpu_kernel(*vpu_csr(src, dst, w, S), S, T)


def vpu_kernel(ptr, in_src, in_w, S: int, T: int):
    """Launch ``xl_vpu`` on :func:`vpu_csr`'s arrays of checked inputs."""
    B, K = in_src.shape
    if vpu_smem_bytes(S, K) > MAX_SMEM:
        raise NotImplementedError(
            f"xl_vpu keeps a row's carry and arcs in one block's shared "
            f"memory: S={S}, K={K} need {vpu_smem_bytes(S, K)} bytes, over "
            f"the {MAX_SMEM} a Hopper block has (12 S + 8 K + 516 <= "
            f"{MAX_SMEM})")
    out = torch.empty(B, S, dtype=torch.float32, device=in_src.device)
    rc = _lib("xl_vpu")(_ptr(ptr), _ptr(in_src), _ptr(in_w), B, S, K, T,
                        _init(S), _ptr(out), _stream())
    _check(rc, "xl_vpu")
    LAUNCHES["xl_vpu"] += 1
    return out


# ----------------------------------------------------------------------
# xl_mxu (T2): the tensor cores, split 3 (f32 parity) or 1 (bf16)
# ----------------------------------------------------------------------

def _pad(n: int) -> int:
    return -(-n // MXU_PAD) * MXU_PAD


def mxu_smem_bytes(s_pad: int, k_pad: int, split: int) -> int:
    """Dynamic shared memory of ``xl_mxu`` (must equal xl_mxu_smem_bytes
    in the source): src, dst, w, a, the warp partials, and the bf16 terms
    of the carry and of contrib."""
    return 4 * (3 * k_pad + s_pad) + 32 * 8 + 2 * split * (s_pad + k_pad)


def mxu_operands(src, dst, w):
    """The arrays ``xl_mxu`` reads: src and dst padded with -1 (an id no
    state has, so a padded arc is in no mask) and w with 0 to K_pad, a
    multiple of 16."""
    B, K = src.shape
    k_pad = _pad(K)
    src_p = torch.full((B, k_pad), -1, dtype=torch.int32, device=src.device)
    dst_p = torch.full_like(src_p, -1)
    w_p = torch.zeros(k_pad, dtype=torch.float32, device=src.device)
    src_p[:, :K] = src
    dst_p[:, :K] = dst
    w_p[:K] = w
    return src_p, dst_p, w_p


def _xl_mxu(name, src, dst, w, S: int, T: int):
    _check_inputs(src, dst, w, S, T)
    if not src.is_cuda:
        return recurrence_plain(src, dst, w, S, T, bf16=SPLIT[name] == 1)
    return mxu_kernel(name, *mxu_operands(src, dst, w), S, T)


def mxu_kernel(name, src_p, dst_p, w_p, S: int, T: int):
    """Launch ``xl_mxu`` (``name``: xl_mxu_f32 or xl_mxu_bf16) on
    :func:`mxu_operands`' arrays of checked inputs."""
    B, k_pad = src_p.shape
    split, s_pad = SPLIT[name], _pad(S)
    if mxu_smem_bytes(s_pad, k_pad, split) > MAX_SMEM:
        raise NotImplementedError(
            f"{name} keeps a row's arcs, carry and contrib in one block's "
            f"shared memory: S_pad={s_pad}, K_pad={k_pad} need "
            f"{mxu_smem_bytes(s_pad, k_pad, split)} bytes, over the "
            f"{MAX_SMEM} a Hopper block has ((12 + 2 split) K_pad + (4 + "
            f"2 split) S_pad + 256 <= {MAX_SMEM})")
    out = torch.empty(B, S, dtype=torch.float32, device=src_p.device)
    rc = _lib("xl_mxu")(_ptr(src_p), _ptr(dst_p), _ptr(w_p), B, S, s_pad,
                        k_pad, T, _init(S), split, _ptr(out), _stream())
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
        fn.argtypes = ([_P] * 3 + [_I] * 4 + [_F, _P, _P]
                       if fn_name == "xl_vpu" else
                       [_P] * 3 + [_I] * 5 + [_F, _I, _P, _P])
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
        run(src, dst, w, S, T)                       # warm-up
        ms = _best_ms(lambda: run(src, dst, w, S, T), iters, cuda)
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
