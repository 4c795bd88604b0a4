#!/usr/bin/env python3
"""End-to-end LF-MMI training example: TDNN acoustic model + chain loss.

The port of ``examples/train_tdnn.py``.  Synthetic utterances are drawn
with the same random stream as the JAX example's (so the loss is
learnable, and the two see the same data), bucketed by length, and
trained with ``torch.optim.Adam`` and ``utils/checkpoint``.  The
denominator runs on its kernel tier (B1/B2 on the card), the linear
numerators on the generic gather engine (``loss.graph_arrays``), as the
JAX example runs them.  As in the JAX example the model runs in
inference mode (flax's ``train=False``) and Adam trains the BatchNorm
running statistics with the weights (the JAX example differentiates the
whole variables tree).

    python -m pychain_tpu_torch.examples.train_tdnn --steps 50 \\
        --batch-size 16 [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given, and raises on
a machine with no card.  ``--dp`` trains data-parallel, one process per
device (``torchrun``'s group, or one process per local card): each rank
takes its rows of every batch, its term over the whole batch's frames,
and the gradients are summed over the ranks, so the steps are those of
one process on the whole batch.  Only rank 0 prints and saves.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pychain_tpu_torch import (ChainGraph, ChainGraphBatch,
                               chain_function_with_aux, check_result,
                               set_verbose_level)
from pychain_tpu_torch.data import BucketSpec, LengthBucketer, pad_to_bucket
from pychain_tpu_torch.examples.train_corpus import trainables
from pychain_tpu_torch.loss import chain_loss, dispatch_arrays, graph_arrays
from pychain_tpu_torch.models import TDNN, TDNNConfig
from pychain_tpu_torch.parallel import all_ranks, global_value, sum_gradients
from pychain_tpu_torch.utils.checkpoint import (latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
from pychain_tpu_torch.utils.device import resolve_device
from pychain_tpu_torch.utils.testgraphs import denominator_fst, linear_fst


def synth_utterance(rng, P, t_len, feat_dim):
    """A random pdf path and noisy features correlated with the pdf
    identity: a learnable task (the JAX example's stream)."""
    pdfs = rng.randint(0, P, size=t_len)
    feats = rng.randn(t_len, feat_dim).astype(np.float32) * 0.5
    for t, p in enumerate(pdfs):
        feats[t, p % feat_dim] += 2.0
    return feats, pdfs


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-phones", type=int, default=24)
    ap.add_argument("--feat-dim", type=int, default=40)
    ap.add_argument("--utts", type=int, default=64)
    ap.add_argument("--min-t", type=int, default=40)
    ap.add_argument("--max-t", type=int, default=80)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel, one process per device (torchrun's "
                         "group, or one per local card)")
    ap.add_argument("--verbose", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def model_config(P) -> TDNNConfig:
    return TDNNConfig(num_pdfs=P, hidden_dim=128, kernel_sizes=(3, 3, 3),
                      dilations=(1, 1, 2), strides=(1, 1, 1), dropout=0.0)


def make_data(args):
    """(den_graph, P, [(feats, num_graph)]) from seed 0, as the JAX
    example draws them."""
    rng = np.random.RandomState(0)
    den_fst, P = denominator_fst(num_phones=args.num_phones,
                                 states_per_phone=2, seed=0)
    den_graph = ChainGraph(den_fst, log_domain=False)
    data = []
    for _ in range(args.utts):
        t_len = rng.randint(args.min_t, args.max_t + 1)
        feats, pdfs = synth_utterance(rng, P, t_len, args.feat_dim)
        data.append((feats, ChainGraph(linear_fst(pdfs), log_domain=True)))
    return den_graph, P, data


def main(argv=None, model=None) -> dict:
    """Run the example; ``model`` replaces the seeded TDNN (a caller's
    weights, e.g. ``convert.model_from_flax``).  Returns ``losses`` (one
    a step), ``steps``, ``ok`` (the diagnostics') and ``model``; with
    ``--dp`` rank 0's, and ``dp`` the number of ranks."""
    args = parse_args(argv)
    set_verbose_level(args.verbose)
    dev = resolve_device(args.device)
    if not args.dp:
        return _run(args, dev, model)
    from pychain_tpu_torch.parallel.multihost import dp_main
    return dp_main(main, argv, dev, args.batch_size,
                   lambda d, dp: _run(args, d, model, dp=dp))


def _run(args, dev, model=None, dp=None) -> dict:
    """The example on ``dev``; ``dp`` = (rank, world) under --dp."""
    rank, world = dp or (0, 1)

    # 1-2. graphs, synthetic corpus and per-utterance numerator graphs
    den_graph, P, data = make_data(args)
    print(f"denominator: S={den_graph.num_states} "
          f"K={den_graph.num_transitions} P={P}")

    # 3. model + optimiser
    if model is None:
        model = TDNN(model_config(P), args.feat_dim, device=dev)
    model.eval()
    trainables_ = trainables(model)
    opt = torch.optim.Adam(trainables_, lr=args.lr)
    step0 = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        step0, state = restore_checkpoint(
            args.ckpt, {"model": model.state_dict(),
                        "opt": opt.state_dict()})
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        print(f"resumed from step {step0}")

    den_batches = {}
    lengths_all = [d[0].shape[0] for d in data]
    bucketer = LengthBucketer(BucketSpec.linear(step=20, max_t=args.max_t),
                              shuffle=True)

    step, epoch, losses, oks = step0, 0, [], []
    t_start = time.time()
    while step < args.steps:
        epoch += 1
        for idx in bucketer.batches(lengths_all, args.batch_size,
                                    epoch=epoch):
            if step >= args.steps:
                break
            if len(idx) < args.batch_size:
                continue  # keep shapes static
            t_pad = bucketer.padded_shape(lengths_all, idx)
            # under --dp: the whole batch's frames, this rank's rows
            frames = sum(lengths_all[int(i)] for i in idx)
            nb = len(idx) // world
            idx = idx[rank * nb:(rank + 1) * nb]
            feats, lens = pad_to_bucket([d[0] for d in data], idx, t_pad)
            num_batch = ChainGraphBatch(
                [data[int(i)][1] for i in idx],
                max_num_transitions=args.max_t,
                max_num_states=args.max_t + 1, device=dev)
            if len(idx) not in den_batches:
                den_batches[len(idx)] = ChainGraphBatch(den_graph, len(idx),
                                                        device=dev)
            den_g = dispatch_arrays(den_batches[len(idx)])
            num_g = graph_arrays(num_batch)
            x = torch.from_numpy(feats).to(dev)
            opt.zero_grad(set_to_none=True)
            if dp:
                loss = global_value(chain_loss(
                    model(x, train=False), lens, num_g, den_g,
                    avg=False) / frames)
                loss.backward()
                sum_gradients(trainables_)
            else:
                loss = chain_loss(model(x, train=False), lens, num_g, den_g)
                loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            step += 1
            if step % 10 == 0 or step == step0 + 1:
                # invariant check on the current batch (diagnostics path)
                with torch.no_grad():
                    out = model(x, train=False)
                _, aux = chain_function_with_aux(out, lens, den_g)
                step_ok = check_result(aux, lens).all_ok
                if dp:   # every rank's rows
                    step_ok = all_ranks(step_ok)
                oks.append(step_ok)
                print(f"step {step}: loss={losses[-1]:.4f} "
                      f"ok={step_ok} "
                      f"({(step - step0) / (time.time() - t_start):.2f} "
                      f"steps/s)")
            if args.ckpt and step % 50 == 0:
                save_state(args.ckpt, step, model, opt, rank, dp)

    if args.ckpt:
        save_state(args.ckpt, step, model, opt, rank, dp)
    print(f"done: {step - step0} steps in {time.time() - t_start:.1f}s; "
          f"final loss {losses[-1]:.4f}" if losses else
          f"done: no step run (resumed at step {step0})")
    return {"losses": losses, "steps": step - step0, "ok": all(oks),
            "model": model, "dp": world if dp else None}


def save_state(path, step, model, opt, rank, dp):
    """Rank 0 writes (every rank holds the same state); the others wait
    for the file."""
    if rank == 0:
        save_checkpoint(path, step, {"model": model.state_dict(),
                                     "opt": opt.state_dict()})
    if dp:
        torch.distributed.barrier()


if __name__ == "__main__":
    main()
