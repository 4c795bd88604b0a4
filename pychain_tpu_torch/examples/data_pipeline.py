#!/usr/bin/env python3
"""Real-corpus data workflow, end to end on synthetic stand-ins.

The port of ``examples/data_pipeline.py``: the Kaldi-style pipeline a
reference user runs (features in ark/scp, numerator supervision FSTs in
an ark, length bucketing, the chain loss) through the port's public API,
with the same random streams, so that it writes the same files and gives
the same batches and losses as the JAX example.

    python -m pychain_tpu_torch.examples.data_pipeline [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given, and raises on
a machine with no card.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss, FST
from pychain_tpu_torch.data import (BucketSpec, LengthBucketer,
                                    load_scp_entry, pad_to_bucket, read_scp,
                                    scan_feats_ark, write_feats_ark,
                                    write_scp)
from pychain_tpu_torch.graphs import write_ark
from pychain_tpu_torch.utils.device import resolve_device
from pychain_tpu_torch.utils.testgraphs import denominator_fst


def main(argv=None) -> list:
    """Run the pipeline; returns one (t_pad, batch indices, loss) a
    bucket, in the order printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)
    work = tempfile.mkdtemp()
    den_fst, P = denominator_fst(num_phones=12, states_per_phone=2, seed=0)
    feat_dim = 20

    # 1. "extract" features and supervision, store Kaldi-style
    utts = {}
    fsts = {}
    for i in range(12):
        t_len = int(rng.randint(20, 50))
        key = f"utt{i:03d}"
        utts[key] = rng.randn(t_len, feat_dim).astype(np.float32)
        fsts[key] = FST.linear(rng.randint(0, P, size=t_len))
    feats_ark = os.path.join(work, "feats.ark")
    feats_scp = os.path.join(work, "feats.scp")
    # compressed payloads, as real corpora ship (copy-feats --compress)
    offsets = write_feats_ark(feats_ark, utts, compress=True)
    write_scp(feats_scp, feats_ark, offsets)
    fst_offsets = write_ark(os.path.join(work, "num.ark"), fsts)
    print(f"wrote {len(utts)} compressed utterances under {work}")

    # scp-free discovery path: scan the ark for (key, offset) pairs
    # (the native host library)
    assert dict(scan_feats_ark(feats_ark)) == offsets

    # 2. load back through scp random access + FST ark offsets
    entries = read_scp(feats_scp)
    feats = [load_scp_entry(path, off) for _, path, off in entries]
    keys = [k for k, _, _ in entries]
    num_graphs = {k: ChainGraph(
        FST.read_ark(os.path.join(work, "num.ark"), fst_offsets[k]),
        log_domain=True) for k in keys}

    # 3. bucketed batches -> chain loss
    loss_mod = ChainLoss(ChainGraph(den_fst), device=dev)
    lengths_all = [f.shape[0] for f in feats]
    bucketer = LengthBucketer(BucketSpec.linear(step=10, max_t=50),
                              shuffle=False)
    max_t = max(lengths_all)
    out = []
    for idx in bucketer.batches(lengths_all, batch_size=4):
        t_pad = bucketer.padded_shape(lengths_all, idx)
        x, lens = pad_to_bucket(feats, idx, t_pad)
        nums = [num_graphs[keys[int(i)]] for i in idx]
        nb = ChainGraphBatch(nums, max_num_transitions=max_t,
                             max_num_states=max_t + 1, device=dev)
        # stand-in acoustic model: random projection to pdf space
        W = rng.randn(feat_dim, P).astype(np.float32) * 0.1
        y = torch.from_numpy(x).to(dev) @ torch.from_numpy(W).to(dev)
        loss = float(loss_mod(y, torch.from_numpy(lens), nb))
        print(f"bucket T={t_pad}: batch={len(idx)} loss={loss:.4f}")
        out.append((t_pad, [int(i) for i in idx], loss))
    print("pipeline OK")
    return out


if __name__ == "__main__":
    main()
