#!/usr/bin/env python3
"""WSJ-style corpus recipe: Kaldi data dir -> LF-MMI training, in PyTorch.

The port of ``examples/train_corpus.py``, flag for flag and line for
line of output.  Everything flows through on-disk Kaldi artifacts,
exactly as a real corpus ships them:

    data/
      feats.scp    "utt001 /abs/path/feats.ark:42" per line
      feats.ark    CompressedMatrix (or plain float) features
      num.ark      per-utterance numerator supervision FSTs
      num.scp      "utt001 /abs/path/num.ark:17" per line
      den.fst      denominator graph (OpenFST binary VectorFst)

Run against a real directory:

    python -m pychain_tpu_torch.examples.train_corpus \\
        --data-dir /path/to/data --model blstm --steps 500 \\
        --ckpt /path/to/ckpt

or without one: the script synthesises a stand-in corpus with the same
file layout first (under ``$TMPDIR/pychain_tpu_torch_corpus``), so the
recipe is runnable end to end anywhere.  It runs on the CUDA card unless
``--device cpu`` is given, and raises on a machine with no card.

Pipeline: scp random access (the native host library) -> length
bucketing -> host assembly and pinned host->device copies in a producer
thread -> TDNN/TDNN-F/BLSTM -> ChainLoss (the closed form for aligned
numerators, the semiring kernels for flat-start and constrained ones,
B1/B2 or B3/B4 for the denominator, their bfloat16 forms with
``--tile-dtype bfloat16``) -> clip-then-Adam that skips non-finite
updates (``utils/optim.py``) -> ``torch.save`` checkpoints.  With
``--realign-at`` the flat-start numerators are replaced by
tolerance-constrained ones from Viterbi alignments (the viterbi kernel),
and ``--eval-per`` decodes the corpus (``decode.PhoneDecoder``) and
scores its phone error rate.

As in the JAX recipe, the model runs in inference mode in every step
(flax's ``train=False``): BatchNorm normalises with its running
statistics, and those statistics are trained by Adam with the weights,
since the JAX recipe differentiates its whole variables tree.

``--dp`` trains data-parallel, one process per device: under
``torchrun`` in the group its ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` describe, else one process per local
card (one rank alone on a host with one card).  Each rank takes its
rows of every bucketed batch, its term is taken over the whole batch's
frames and the gradients are summed over the ranks
(``parallel/data_parallel.py``), so the steps are those of one process
on the whole batch, as the JAX recipe's ``--dp`` step over its global
batch.  Only rank 0 prints and writes checkpoints.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pychain_tpu_torch import (ChainGraph, ChainGraphBatch, FST,
                               chain_function_with_aux, check_result)
from pychain_tpu_torch.data import (BucketSpec, LengthBucketer,
                                    load_scp_entry, pad_to_bucket, prefetch,
                                    read_scp, write_feats_ark, write_scp)
from pychain_tpu_torch.data.prefetch import to_device
from pychain_tpu_torch.graphs import (ChainTopology,
                                      alignment_to_pdf_sequence,
                                      estimate_phone_lm,
                                      make_constrained_numerator,
                                      make_denominator_fst,
                                      make_numerator_fst, write_ark)
from pychain_tpu_torch.loss import chain_loss, chain_loss_xent, \
    dispatch_arrays, resolved_engine
from pychain_tpu_torch.models import BLSTM, BLSTMConfig, TDNN, TDNNConfig
from pychain_tpu_torch.utils.checkpoint import (latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
from pychain_tpu_torch.utils.device import host_to, resolve_device
from pychain_tpu_torch.utils.optim import ClipAdam
from pychain_tpu_torch.utils.testgraphs import denominator_fst


def default_corpus_dir() -> str:
    """The synthetic corpus's directory: the port's own, so that it and
    the JAX recipe (which writes its corpus under /tmp) never overwrite
    each other's files when they run at once."""
    return os.path.join(tempfile.gettempdir(), "pychain_tpu_torch_corpus")


# ----------------------------------------------------------------------
# Synthetic stand-in corpus with the exact on-disk layout of a real one
# ----------------------------------------------------------------------

def make_synthetic_corpus(data_dir, utts=96, feat_dim=40, num_phones=24,
                          min_t=40, max_t=90, seed=0, graphs="random",
                          num_style="aligned", signal=2.0):
    """``graphs="random"`` reproduces Kaldi-built artifacts with the
    synthetic generators; ``graphs="built"`` runs the FULL native
    pipeline instead — sample phone transcripts, estimate a bigram
    phone LM, compose the denominator (graphs/builder.py), and derive
    each numerator from its transcript (``num_style="aligned"`` →
    linear pdf sequence on the closed form, ``"flat"`` → flat-start
    graph with self-loops on the semiring kernels).  The same random
    stream as the JAX recipe's: the same files, byte for byte."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)

    feats = {}
    fsts = {}
    if graphs == "built":
        topo = ChainTopology(num_phones=num_phones)
        markov = rng.dirichlet(np.ones(num_phones) * 0.3, size=num_phones)
        transcripts = []
        plans = []
        for i in range(utts):
            t_len = int(rng.randint(min_t, max_t + 1))
            n_ph = max(1, t_len // 6)
            phones = [int(rng.randint(num_phones))]
            for _ in range(n_ph - 1):
                phones.append(int(rng.choice(num_phones,
                                             p=markov[phones[-1]])))
            durs = np.ones(n_ph, np.int64)
            extra = rng.multinomial(t_len - n_ph, np.ones(n_ph) / n_ph)
            durs += extra
            transcripts.append(phones)
            plans.append((phones, durs.tolist()))
        lm = estimate_phone_lm(transcripts, num_phones=num_phones, order=2)
        den_fst = make_denominator_fst(lm, topo)
        P = topo.num_pdfs
        with open(os.path.join(data_dir, "text"), "w") as f:
            for i, t in enumerate(transcripts):
                f.write(f"utt{i:04d} {' '.join(map(str, t))}\n")
        for i, (phones, durs) in enumerate(plans):
            key = f"utt{i:04d}"
            seq = alignment_to_pdf_sequence(phones, durs, topo)
            t_len = len(seq)
            f = rng.randn(t_len, feat_dim).astype(np.float32) * 0.5
            f[np.arange(t_len), np.asarray(seq) % feat_dim] += signal
            feats[key] = f
            if num_style == "aligned":
                fsts[key] = FST.linear(seq)
            elif num_style == "constrained":
                fsts[key] = make_constrained_numerator(phones, durs, topo,
                                                       tolerance=3)
            else:
                fsts[key] = make_numerator_fst(phones, topo)
    else:
        den_fst, P = denominator_fst(num_phones=num_phones,
                                     states_per_phone=2, seed=seed)
        for i in range(utts):
            t_len = int(rng.randint(min_t, max_t + 1))
            key = f"utt{i:04d}"
            pdfs = rng.randint(0, P, size=t_len)
            f = rng.randn(t_len, feat_dim).astype(np.float32) * 0.5
            f[np.arange(t_len), pdfs % feat_dim] += signal  # learnable signal
            feats[key] = f
            fsts[key] = FST.linear(pdfs)
    den_fst.write(os.path.join(data_dir, "den.fst"))

    feats_ark = os.path.join(data_dir, "feats.ark")
    offsets = write_feats_ark(feats_ark, feats, compress=True)
    write_scp(os.path.join(data_dir, "feats.scp"), feats_ark, offsets)
    num_ark = os.path.join(data_dir, "num.ark")
    num_offsets = write_ark(num_ark, fsts)
    write_scp(os.path.join(data_dir, "num.scp"), num_ark, num_offsets)
    print(f"synthesised corpus: {utts} utterances, P={P} -> {data_dir}")
    return data_dir


# ----------------------------------------------------------------------
# Corpus loading (the real-recipe path)
# ----------------------------------------------------------------------

def load_corpus(data_dir):
    """Kaldi-style data dir -> (keys, feats, num ChainGraphs, den
    ChainGraph).

    Two layouts are accepted:

    * **Precompiled graphs** (what Kaldi's chain pipeline writes, and
      what the reference consumes): ``feats.scp`` + ``num.scp``/
      ``num.ark`` + ``den.fst``.
    * **Transcripts only**: ``feats.scp`` + ``text`` (integer phone
      ids, or words with a ``lexicon.txt`` beside it).  The phone LM,
      denominator, and flat-start numerators are then built natively
      (graphs/builder.py) — no Kaldi anywhere.
    """
    feat_entries = read_scp(os.path.join(data_dir, "feats.scp"))
    num_scp = os.path.join(data_dir, "num.scp")
    den_path = os.path.join(data_dir, "den.fst")

    if os.path.exists(num_scp):
        num_entries = {k: (p, o) for k, p, o in read_scp(num_scp)}
        keys, feats, nums = [], [], []
        for key, path, off in feat_entries:
            if key not in num_entries:
                continue  # no supervision for this utterance
            keys.append(key)
            feats.append(load_scp_entry(path, off))
            npath, noff = num_entries[key]
            nums.append(ChainGraph(FST.read_ark(npath, noff),
                                   log_domain=True))
        den = ChainGraph(FST.read(den_path), log_domain=False)
        return keys, feats, nums, den

    # transcripts-only layout: build everything natively
    from pychain_tpu_torch.graphs import read_lexicon, read_transcripts
    text_path = os.path.join(data_dir, "text")
    if not os.path.exists(text_path):
        raise FileNotFoundError(
            f"{data_dir}: need either num.scp (precompiled graphs) or "
            "text (transcripts for native graph building)")
    lex_path = os.path.join(data_dir, "lexicon.txt")
    lexicon = read_lexicon(lex_path) if os.path.exists(lex_path) else None
    transcripts = read_transcripts(text_path, lexicon)
    keys, feats, phone_seqs = [], [], []
    for key, path, off in feat_entries:
        if key not in transcripts or not transcripts[key]:
            continue
        keys.append(key)
        feats.append(load_scp_entry(path, off))
        phone_seqs.append(transcripts[key])
    if not keys:
        raise ValueError(
            f"{data_dir}: no utterance key appears in BOTH feats.scp "
            f"({len(feat_entries)} entries) and {text_path} "
            f"({len(transcripts)} entries) with a non-empty transcript "
            "— check for a key-format mismatch")
    num_phones = 1 + max(max(t) for t in phone_seqs)
    topo = ChainTopology(num_phones=num_phones)
    lm = estimate_phone_lm(phone_seqs, num_phones=num_phones, order=2)
    if os.path.exists(den_path):
        den = ChainGraph(FST.read(den_path), log_domain=False)
    else:
        den = ChainGraph(make_denominator_fst(lm, topo), log_domain=False)
    nums = [ChainGraph(make_numerator_fst(t, topo), log_domain=True)
            for t in phone_seqs]
    print(f"built graphs natively from {text_path}: {len(keys)} utts, "
          f"{num_phones} phones"
          + (" (lexicon expanded)" if lexicon else ""))
    return keys, feats, nums, den


def model_config(name, num_pdfs):
    """The recipe's widths (the JAX recipe's build_model)."""
    if name == "tdnn":
        return TDNNConfig(num_pdfs=num_pdfs, hidden_dim=256,
                          kernel_sizes=(3, 3, 3, 3),
                          dilations=(1, 1, 3, 3), strides=(1, 1, 1, 1),
                          dropout=0.0)
    if name == "tdnnf":
        from pychain_tpu_torch.models import TDNNFConfig
        return TDNNFConfig(num_pdfs=num_pdfs, hidden_dim=256,
                           bottleneck_dim=64, num_layers=4,
                           dilations=(1, 1, 3, 3), dropout=0.0)
    return BLSTMConfig(num_pdfs=num_pdfs, hidden_dim=256, num_layers=2)


def build_model(name, num_pdfs, feat_dim, device=None):
    """The model of ``name`` at the recipe's widths, initialised from
    seed 0 on the CPU and moved to ``device`` (``None``: the card)."""
    from pychain_tpu_torch.models import TDNNF
    cfg = model_config(name, num_pdfs)
    cls = {"tdnn": TDNN, "tdnnf": TDNNF}.get(name, BLSTM)
    return cls(cfg, feat_dim, device=device)


def trainables(model) -> list:
    """What the recipe trains: the parameters and the BatchNorm running
    statistics, set to take gradients.  The JAX recipe differentiates
    flax's whole variables tree (``params`` and ``batch_stats``) while
    the model runs with ``train=False``, so Adam moves the statistics as
    it moves the weights."""
    stats = [b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    for b in stats:
        b.requires_grad_(True)
    return list(model.parameters()) + stats


def apply_model(model, x, lens, takes_lengths):
    """The model in inference mode (the JAX recipe's ``train=False``):
    BatchNorm normalises with its running statistics, no dropout."""
    if takes_lengths:
        return model(x, train=False, lengths=lens)
    return model(x, train=False)


def train_step(model, opt, x, lens, num_g, den_g, leaky=1e-5,
               xent_regularize=0.0, l2_regularize=0.0,
               takes_lengths=False, dp=None):
    """One step: the model, ``chain_loss`` (or ``chain_loss_xent(out,
    out, ...)``, the single-head variant of Kaldi's regularisers), the
    backward pass and ``opt.step()``.  ``lens`` are the host lengths
    (numpy), so nothing here waits for the card.  ``dp`` is (group,
    frames) under data parallelism: this rank's rows' term over the
    whole batch's frames, its value summed over the ranks
    (``global_value``) and the gradients too (``sum_gradients``).
    Returns the loss, detached, on the device."""
    model.eval()
    out = apply_model(model, x, lens, takes_lengths)
    avg = dp is None
    if xent_regularize > 0.0 or l2_regularize > 0.0:
        loss, _ = chain_loss_xent(out, out, lens, num_g, den_g,
                                  leaky_coefficient=leaky,
                                  xent_regularize=xent_regularize,
                                  l2_regularize=l2_regularize, avg=avg)
    else:
        loss = chain_loss(out, lens, num_g, den_g, leaky_coefficient=leaky,
                          avg=avg)
    if dp is not None:
        from pychain_tpu_torch.parallel import global_value
        loss = global_value(loss / dp[1], dp[0])
    opt.zero_grad()
    loss.backward()
    if dp is not None:
        from pychain_tpu_torch.parallel import sum_gradients
        # ClipAdam's tensors, or a torch optimizer's parameters
        sum_gradients(getattr(opt, "tensors", None) or [
            p for g in opt.param_groups for p in g["params"]], dp[0])
    opt.step()
    return loss.detach()


def flat_graph_phones(g):
    """Recover the phone sequence from a flat-start numerator graph
    (state i+1 <=> phone position i; entry arcs carry the forward pdf
    2*phone of the non-shared chain topology).  Raises on any other
    numerator shape — realignment from a linear/random graph would
    silently build constrained supervision from garbage."""
    tr = np.asarray(g.forward_transitions)
    n = g.num_states - 1
    # a flat-start graph has exactly n forward arcs and a self-loop on
    # every phone state
    loops = tr[tr[:, 0] == tr[:, 1]]
    fwd = tr[tr[:, 0] + 1 == tr[:, 1]]
    if (g.num_transitions != 2 * n or loops.shape[0] != n
            or fwd.shape[0] != n or (fwd[:, 2] % 2 != 0).any()):
        raise ValueError(
            "--realign-at requires flat-start numerators "
            "(--num-style flat); this corpus has a different "
            "supervision shape")
    phones_arr = np.zeros(n, np.int64)
    phones_arr[fwd[:, 1] - 1] = fwd[:, 2] // 2
    return [int(p) for p in phones_arr]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", type=str, default="")
    ap.add_argument("--model", choices=("tdnn", "tdnnf", "blstm"),
                    default="tdnn")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--bucket-step", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-clip", type=float, default=5.0,
                    help="global-norm gradient clip (0 disables)")
    ap.add_argument("--leaky", type=float, default=1e-5)
    ap.add_argument("--xent-regularize", type=float, default=0.0)
    ap.add_argument("--l2-regularize", type=float, default=0.0)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--diag-every", type=int, default=10,
                    help="run the ok-flag diagnostic forward every N "
                         "steps (0 disables; diagnostics are extra "
                         "compute outside the steady-state path)")
    ap.add_argument("--warmup-steps", type=int, default=3,
                    help="steps excluded from the steady-state "
                         "throughput report (kernel builds, graph "
                         "layouts, allocator warm-up)")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel, one process per device: under "
                         "torchrun in its group, else one process per "
                         "local card; the batch's rows spread over the "
                         "ranks")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the model, the loss and the decoder run "
                         "(the JAX recipe's JAX_PLATFORMS); 'cpu' runs "
                         "the plain PyTorch versions of the kernels")
    ap.add_argument("--signal", type=float, default=2.0,
                    help="synthetic-corpus emission signal strength: "
                         "the feature-column spike over N(0,0.5) "
                         "noise; lower = more confusable task (the "
                         "PER quality gate uses 1.2 so the gate can "
                         "actually fail)")
    ap.add_argument("--eval-per-untrained", action="store_true",
                    help="with --eval-per: also decode with the "
                         "UNTRAINED (freshly initialized) model first "
                         "and print its PER — proves the gate is "
                         "falsifiable (an untrained model must score "
                         "far above it)")
    ap.add_argument("--eval-per", action="store_true",
                    help="after training, Viterbi-decode the corpus "
                         "(decode.PhoneDecoder over a bigram phone LM "
                         "estimated from the data dir's 'text' file) "
                         "and report the phone error rate — the "
                         "end-to-end quality gate")
    ap.add_argument("--device-corpus", action="store_true",
                    help="stage the WHOLE corpus on the device once "
                         "(features + linear numerator arrays); per step "
                         "only a (B,) index vector crosses the host link")
    ap.add_argument("--tile-dtype", type=str, default="",
                    help="bfloat16 for the fast denominator mode")
    ap.add_argument("--synthetic-graphs", choices=("random", "built"),
                    default="random",
                    help="'built' runs the native transcript->LM->"
                         "denominator pipeline (graphs/builder.py) "
                         "instead of the random generators")
    ap.add_argument("--corpus-utts", type=int, default=96,
                    help="synthetic corpus size (ignored with "
                         "--data-dir)")
    ap.add_argument("--corpus-phones", type=int, default=24)
    ap.add_argument("--corpus-min-t", type=int, default=40)
    ap.add_argument("--corpus-max-t", type=int, default=90)
    ap.add_argument("--num-style",
                    choices=("aligned", "constrained", "flat"),
                    default="aligned",
                    help="numerator style for --synthetic-graphs=built: "
                         "exact alignment (closed form), tolerance "
                         "windows or flat-start (semiring kernels)")
    ap.add_argument("--realign-at", type=int, default=0,
                    help="with flat-start numerators: at this step, "
                         "viterbi-align every utterance with the "
                         "current model and continue training on "
                         "tolerance-constrained supervision (the "
                         "native two-stage e2e recipe)")
    ap.add_argument("--tolerance", type=int, default=3,
                    help="boundary tolerance for --realign-at graphs")
    ap.add_argument("--chunk-frames", type=int, default=0,
                    help="with --realign-at: split aligned utterances "
                         "into fixed-width chunks (one static batch "
                         "shape, O(chunk) memory)")
    return ap.parse_args(argv)


def main(argv=None, on_event=None) -> dict:
    """Run the recipe; returns what it printed as numbers: ``loss``,
    ``steps``, ``resumed_from``, ``utts_per_s`` / ``frames_per_s``
    (steady state, or None), ``pipeline`` (ms: ``assemble`` and
    ``transfer`` a batch, ``starvation`` a step), ``skipped``, ``per`` /
    ``untrained_per`` (with --eval-per), ``ok`` (every diagnostic's),
    ``staged_mb``, ``num_pad`` (the numerator batches' (max arcs, max
    states), then after --realign-at the new ones), ``den_engine``
    (the denominator's tier, ``loss.resolved_engine``) and ``losses``
    (each step's).  ``on_event(name)``,
    when given, is called with "realign" just before the realignment and
    "realigned" just after it (a caller counts the kernels' launches of
    each stage).  With ``--dp`` it is rank 0's, ``dp`` the number of
    ranks."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if not args.dp:
        return _run(args, dev, on_event)
    from pychain_tpu_torch.parallel.multihost import dp_main
    return dp_main(main, argv, dev, args.batch_size,
                   lambda d, dp: _run(args, d, on_event, dp=dp))


def _run(args, dev, on_event=None, dp=None) -> dict:
    """The recipe on ``dev``; ``dp`` = (rank, world) under --dp."""
    rank, world = dp or (0, 1)
    group = torch.distributed.group.WORLD if dp else None
    data_dir = args.data_dir
    if not data_dir:
        data_dir = default_corpus_dir()
        if rank == 0:
            make_synthetic_corpus(data_dir, utts=args.corpus_utts,
                                  num_phones=args.corpus_phones,
                                  min_t=args.corpus_min_t,
                                  max_t=args.corpus_max_t,
                                  graphs=args.synthetic_graphs,
                                  num_style=args.num_style,
                                  signal=args.signal)
        if dp:
            torch.distributed.barrier()

    keys, feats, nums, den_graph = load_corpus(data_dir)
    feat_dim = feats[0].shape[1]
    P = 1 + max(int(g.forward_transitions[:, 2].max()) for g in nums)
    P = max(P, 1 + int(den_graph.forward_transitions[:, 2].max()))
    print(f"corpus: {len(keys)} utts, feat_dim={feat_dim}, "
          f"den S={den_graph.num_states} K={den_graph.num_transitions} "
          f"P={P}")

    model = build_model(args.model, P, feat_dim, dev)
    # the BLSTM's reversed direction needs the true lengths or it
    # consumes pad frames first (models/lstm.py); the TDNN is purely
    # convolutional and takes none
    takes_lengths = args.model == "blstm"
    lengths_all = [f.shape[0] for f in feats]
    max_t = max(lengths_all)
    max_states = max(g.num_states for g in nums) + 1
    max_arcs = max(g.num_transitions for g in nums) + 1

    # kept for --eval-per-untrained
    init_state = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    # clip-then-adam, the Kaldi-recipe shape: chain gradients spike on
    # hard minibatches early in training.  A step whose gradients are
    # non-finite is SKIPPED (weights and optimizer state preserved): the
    # reference's "abandon this minibatch" advice
    # (chain-computation.cc:374)
    opt = ClipAdam(trainables(model), lr=args.lr, clip=args.grad_clip,
                   max_consecutive_errors=25)
    step0 = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        step0, state = restore_checkpoint(
            args.ckpt, {"model": model.state_dict(),
                        "opt": opt.state_dict()})
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        print(f"resumed from step {step0}")

    def step_fn(x, lens, num_g, den_g, frames):
        return train_step(model, opt, x, lens, num_g, den_g,
                          leaky=args.leaky,
                          xent_regularize=args.xent_regularize,
                          l2_regularize=args.l2_regularize,
                          takes_lengths=takes_lengths,
                          dp=(group, frames) if dp else None)

    bucketer = LengthBucketer(
        BucketSpec.linear(step=args.bucket_step, max_t=max_t),
        shuffle=True)
    tile_dtype = args.tile_dtype or None
    # the shared denominator batch: built once, here, for the one batch
    # shape the loop takes (partial batches are skipped); under --dp a
    # rank's rows of it
    local_b = args.batch_size // world
    den_g = dispatch_arrays(ChainGraphBatch(
        den_graph, local_b, tile_dtype=tile_dtype, device=dev))
    # which tier the loss takes for it (the JAX package's names): "xla",
    # the plain version, for a graph with residual arcs, which no
    # kernel takes
    den_tier = resolved_engine(den_g)
    print(f"denominator engine: {den_tier} (S_pad={den_g.s_pad}, "
          f"{args.tile_dtype or 'float32'} tiles)")

    # pipeline decomposition (reported with the steady-state line):
    # "assemble" = pure host work (pad, graph batch) in the producer
    # thread; "transfer" = the pinned host->device copies, waited for on
    # the producer's own stream; "wait" = consumer starvation, i.e. time
    # the training loop blocked on the prefetch queue.  Host keeps the
    # card busy iff wait ~ 0.
    pipe = {"assemble": 0.0, "transfer": 0.0, "wait": 0.0, "produced": 0}
    mover = to_device(dev)

    def transfer(item):
        t0 = time.time()
        out = mover(item)
        pipe["transfer"] += time.time() - t0
        return out

    # --device-corpus: corpora that fit are staged ONCE (features,
    # numerator arrays); per step only a (B,) index vector crosses
    # host->device and the batch is gathered on the device
    staged = None
    staged_mb = None
    if args.device_corpus:
        if args.realign_at:
            raise ValueError("--device-corpus does not combine with "
                             "--realign-at")
        from pychain_tpu_torch.ops.linear import LinearArrays
        x_all, _ = pad_to_bucket(feats, list(range(len(keys))), max_t)
        all_nums = dispatch_arrays(ChainGraphBatch(
            nums, max_num_transitions=max_arcs, max_num_states=max_states,
            device=dev))
        if not isinstance(all_nums, LinearArrays):
            raise ValueError(
                "--device-corpus requires linear numerator supervision "
                "(aligned style); got "
                f"{type(all_nums).__name__}")
        staged = {"x": host_to(torch.from_numpy(x_all), dev),
                  "nums": all_nums}
        nbytes = x_all.nbytes + sum(
            t.numel() * t.element_size() for t in vars(all_nums).values())
        staged_mb = nbytes / 1e6
        print(f"device corpus: {len(keys)} utts staged on {dev} "
              f"({staged_mb:.0f} MB)")

    def assemble_batches(epoch):
        """Host-side batch assembly (padding, graph batching): runs in
        the prefetcher's thread so it overlaps the previous step's
        device compute; the transfer copies each item to the device
        there too."""
        for idx in bucketer.batches(lengths_all, args.batch_size,
                                    epoch=epoch):
            if len(idx) < args.batch_size:
                continue  # static shapes
            t0 = time.time()
            # every rank buckets the whole batch (its frames, its padded
            # length) and keeps its rows of it
            frames = int(sum(lengths_all[int(i)] for i in idx))
            t_pad = bucketer.padded_shape(lengths_all, idx)
            idx = idx[rank * local_b:(rank + 1) * local_b]
            lens = np.asarray([lengths_all[int(i)] for i in idx], np.int32)
            if staged is not None:
                # the x slot carries the index vector; the step gathers
                # the staged arrays on the device
                item = (torch.from_numpy(np.asarray(idx, np.int64)), None,
                        lens, frames)
            else:
                x, _ = pad_to_bucket(feats, idx, t_pad)
                num_g = dispatch_arrays(ChainGraphBatch(
                    [nums[int(i)] for i in idx],
                    max_num_transitions=max_arcs, max_num_states=max_states,
                    device="cpu"))
                item = (torch.from_numpy(x), num_g, lens, frames)
            pipe["assemble"] += time.time() - t0
            pipe["produced"] += 1
            yield item

    def timed_consume(batches):
        """Yield from the prefetcher, accounting consumer starvation."""
        it = iter(batches)
        while True:
            t0 = time.time()
            try:
                item = next(it)
            except StopIteration:
                return
            pipe["wait"] += time.time() - t0
            yield item

    def realign():
        """Viterbi-align every utterance with the current model and
        swap the flat-start numerators for tolerance-constrained ones
        (graphs/builder.py) — stage 2 of the native e2e recipe.  With
        --chunk-frames the aligned utterances are additionally split
        into fixed-width chunks (Kaldi get-egs practice): ONE static
        batch shape, O(chunk) memory."""
        nonlocal max_arcs, max_states, max_t
        from pychain_tpu_torch import viterbi_align
        from pychain_tpu_torch.data import chunk_alignment, \
            chunk_supervision
        from pychain_tpu_torch.graphs import durations_from_alignment
        topo = ChainTopology(num_phones=P // 2)
        alignments = {}
        for c in range(0, len(keys), args.batch_size):
            idx = list(range(c, min(c + args.batch_size, len(keys))))
            t_pad = bucketer.padded_shape(lengths_all, idx)
            x, lens = pad_to_bucket(feats, idx, t_pad)
            nb = ChainGraphBatch(
                [nums[i] for i in idx],
                max_num_transitions=max_arcs, max_num_states=max_states,
                device=dev)
            with torch.no_grad():
                out = apply_model(model, host_to(torch.from_numpy(x), dev),
                                  lens, takes_lengths)
            res = viterbi_align(out, lens, nb)
            # one device-to-host copy a batch
            ok, states = (t.cpu().numpy() for t in (res.ok, res.states))
            for j, i in enumerate(idx):
                if not bool(ok[j]):
                    print(f"  {keys[i]}: no alignment, keeping "
                          "flat-start graph")
                    continue
                durs = durations_from_alignment(states[j], int(lens[j]))
                phones = flat_graph_phones(nums[i])
                alignments[i] = (phones, durs)
                nums[i] = ChainGraph(
                    make_constrained_numerator(phones, durs, topo,
                                               tolerance=args.tolerance),
                    log_domain=True)
        if args.chunk_frames > 0:
            new_keys, new_feats, new_nums = [], [], []
            for i, key in enumerate(keys):
                if i not in alignments:
                    continue  # unaligned utterances are dropped here
                phones, durs = alignments[i]
                plans = chunk_alignment(
                    phones, durs, args.chunk_frames,
                    min_tail=max(1, args.chunk_frames // 2))
                for cidx, plan in enumerate(plans):
                    new_keys.append(f"{key}#c{cidx}")
                    new_feats.append(
                        feats[i][plan.start_frame:
                                 plan.start_frame + plan.num_frames])
                    new_nums.append(ChainGraph(
                        chunk_supervision(plan, topo,
                                          tolerance=args.tolerance),
                        log_domain=True))
            keys[:] = new_keys
            feats[:] = new_feats
            nums[:] = new_nums
            lengths_all[:] = [f.shape[0] for f in feats]
            max_t = max(lengths_all)
            print(f"chunked into {len(keys)} pieces of <= "
                  f"{args.chunk_frames} frames")
        max_states = max(g.num_states for g in nums) + 1
        max_arcs = max(g.num_transitions for g in nums) + 1

    def save_state(step):
        """Rank 0 writes (every rank holds the same state); the others
        wait for the file."""
        if rank == 0:
            save_checkpoint(args.ckpt, step, {"model": model.state_dict(),
                                              "opt": opt.state_dict()})
        if dp:
            torch.distributed.barrier()

    num_pad = [(max_arcs, max_states)]
    step, epoch = step0, 0
    t_start = time.time()
    loss = torch.tensor(float("nan"))
    step_losses = []          # device scalars, read once at the end
    realigned = False
    all_ok = True
    # steady-state accounting: everything after the warmup steps with
    # the prefetcher running — the number that shows host assembly
    # keeping up with (or starving) the device step
    utts_done = frames_done = 0
    steady_t0 = steady_utts0 = steady_frames0 = None
    while step < args.steps:
        epoch += 1
        want_realign = False
        with prefetch(assemble_batches(epoch), depth=2,
                      transfer=transfer) as batches:
            for x_j, num_g, lens, frames in timed_consume(batches):
                if step >= args.steps:
                    break
                if (args.realign_at and not realigned
                        and step >= args.realign_at):
                    # stop consuming; realign AFTER the producer thread
                    # is closed — it reads nums/max_arcs concurrently
                    want_realign = True
                    break
                if staged is not None:
                    idx = x_j
                    x_j = staged["x"].index_select(0, idx)
                    num_g = staged["nums"].take(idx)
                loss = step_fn(x_j, lens, num_g, den_g, frames)
                step_losses.append(loss)
                step += 1
                utts_done += x_j.shape[0] * world
                frames_done += frames
                if (steady_t0 is None
                        and step >= step0 + args.warmup_steps):
                    _ = loss.item()  # sync: exclude the warm-up's work
                    steady_t0 = time.time()
                    steady_utts0, steady_frames0 = utts_done, frames_done
                if args.model == "tdnnf" and step % 4 == 0:
                    # Kaldi applies the semi-orthogonal constraint every
                    # few optimizer steps (floating case)
                    from pychain_tpu_torch.models import (
                        constrain_semi_orthogonal)
                    constrain_semi_orthogonal(model)
                if args.diag_every and (step % args.diag_every == 0
                                        or step == step0 + 1):
                    with torch.no_grad():
                        out = apply_model(model, x_j, lens, takes_lengths)
                        _, aux = chain_function_with_aux(out, lens, den_g)
                    step_ok = check_result(aux, lens).all_ok
                    if dp:   # every rank's rows
                        from pychain_tpu_torch.parallel import all_ranks
                        step_ok = all_ranks(step_ok)
                    all_ok = all_ok and step_ok
                    print(f"step {step}: loss={loss.item():.4f} "
                          f"ok={step_ok} "
                          f"({(step - step0) / (time.time() - t_start):.2f}"
                          f" steps/s)")
                if args.ckpt and step % 100 == 0:
                    save_state(step)
        if want_realign:
            print(f"realigning {len(keys)} utterances at step {step} "
                  f"(tolerance {args.tolerance})")
            if on_event is not None:
                on_event("realign")
            realign()
            num_pad.append((max_arcs, max_states))
            if on_event is not None:
                on_event("realigned")
            realigned = True
    if args.ckpt:
        save_state(step)
    final = loss.item()  # sync the last queued step before timing
    result = {"loss": final, "steps": step - step0, "resumed_from": step0,
              "utts_per_s": None, "frames_per_s": None, "pipeline": None,
              "ok": all_ok, "staged_mb": staged_mb, "num_pad": num_pad,
              "den_engine": den_tier, "dp": world if dp else None,
              "losses": [float(v) for v in step_losses]}
    if steady_t0 is not None and utts_done > steady_utts0:
        dt = time.time() - steady_t0
        n = max(1, pipe["produced"])
        steps_n = max(1, step - step0)
        result["pipeline"] = {"assemble": pipe["assemble"] / n * 1e3,
                              "transfer": pipe["transfer"] / n * 1e3,
                              "starvation": pipe["wait"] / steps_n * 1e3}
        result["utts_per_s"] = (utts_done - steady_utts0) / dt
        result["frames_per_s"] = (frames_done - steady_frames0) / dt
        print(f"pipeline: host assembly {pipe['assemble'] / n * 1e3:.1f} "
              f"ms/batch, transfer {pipe['transfer'] / n * 1e3:.1f} "
              f"ms/batch, consumer starvation "
              f"{pipe['wait'] / steps_n * 1e3:.1f} ms/step over the whole "
              f"run")
        print(f"steady-state: {result['utts_per_s']:.1f} "
              f"utts/s, {result['frames_per_s']:.0f} "
              f"frames/s over {step - step0 - args.warmup_steps} steps "
              f"(prefetch depth 2, host assembly overlapped)")
    skipped = int(opt.total_notfinite.item())
    result["skipped"] = skipped
    if skipped:
        print(f"skipped {skipped} non-finite update(s) "
              "(params preserved — the reference's 'abandon this "
              "minibatch' semantics)")
    print(f"done: {step - step0} steps in {time.time() - t_start:.1f}s; "
          f"final loss {final:.4f}")

    if args.eval_per and rank == 0:
        # end-to-end quality gate: a finite loss can hide numerics that
        # wreck the posterior, so decode the trained model and score it
        # against the reference transcripts
        text_path = os.path.join(data_dir, "text")
        if not os.path.exists(text_path):
            raise ValueError(
                "--eval-per needs a 'text' transcript file in the data "
                "dir (synthetic corpora write one with "
                "--synthetic-graphs=built)")
        from pychain_tpu_torch.decode import PhoneDecoder, phone_error_rate
        refs = {}
        with open(text_path) as f:
            for line in f:
                parts = line.split()
                refs[parts[0]] = [int(p) for p in parts[1:]]
        # reload the corpus: chunking/realignment may have replaced the
        # in-memory feats with sub-utterances
        e_keys, e_feats, _, _ = load_corpus(data_dir)
        order = [i for i, k in enumerate(e_keys) if k in refs]
        n_ph = P // 2                      # non-shared topology
        lm = estimate_phone_lm([refs[e_keys[i]] for i in order],
                               num_phones=n_ph, order=2)
        dec = PhoneDecoder(lm, ChainTopology(num_phones=n_ph))
        bs = args.batch_size

        def _decode_per(m):
            hyps = []
            for i0 in range(0, len(order), bs):
                chunk = order[i0:i0 + bs]
                padded = chunk + [chunk[-1]] * (bs - len(chunk))
                t_pad = max(e_feats[i].shape[0] for i in padded)
                x, lens = pad_to_bucket(e_feats, padded, t_pad)
                with torch.no_grad():
                    out = apply_model(m, host_to(torch.from_numpy(x), dev),
                                      lens, takes_lengths)
                res = dec(out, lens)
                hyps.extend(res.phones[:len(chunk)])
            return phone_error_rate(
                [refs[e_keys[i]] for i in order], hyps)

        if args.eval_per_untrained:
            # falsifiability proof for the gate: the untrained model
            # must score far ABOVE any sane threshold on this task
            untrained = build_model(args.model, P, feat_dim, dev)
            untrained.load_state_dict(init_state)
            per0 = _decode_per(untrained)
            result["untrained_per"] = per0
            print(f"untrained PER {per0:.4f} over {len(order)} utts")
        per = _decode_per(model)
        result["per"] = per
        print(f"eval PER {per:.4f} over {len(order)} utts")
    if not np.isfinite(final):
        print("WARNING: final loss is not finite — training diverged. "
              "Lower --lr (e.g. 3e-4), keep --grad-clip enabled, or "
              "run with --diag-every 1 to find the failing step.",
              file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
