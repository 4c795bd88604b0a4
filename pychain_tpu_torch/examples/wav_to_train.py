#!/usr/bin/env python3
"""Fully standalone pipeline: wav files -> LF-MMI training, in PyTorch.

The port of ``examples/wav_to_train.py``.  No Kaldi, no precomputed
anything, every stage native to the package:

    wav (data.read_wav)
      -> log-mel fbank (data.fbank_batch, on the device)
      -> phone LM + denominator + numerators from the transcripts
         (graphs.builder)
      -> TDNN acoustic model (models)
      -> chain loss with xent regularization (chain_loss_xent)
      -> Viterbi phone decoding before and after (decode.PhoneDecoder)

The synthetic "speech" makes each phone a tone at its own frequency, so
the fbank features are learnable; it is drawn with the JAX example's
random stream, into the port's own directory (default
``$TMPDIR/pychain_tpu_torch_wav``, never the JAX example's).  The
phone-LM denominator has residual arcs, which no kernel takes: it runs
on the plain factorized engine on every device (``loss.den_engine``:
"xla"), the flat-start numerators on the semiring kernels.

    python -m pychain_tpu_torch.examples.wav_to_train --steps 20 \\
        [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given, and raises on
a machine with no card.  As in the JAX example, the model runs in
inference mode and Adam trains the BatchNorm running statistics with
the weights, and the run fails unless the loss falls.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from pychain_tpu_torch import ChainGraph, ChainGraphBatch, chain_loss_xent
from pychain_tpu_torch.data import (FbankConfig, fbank_batch, num_frames,
                                    read_wav, write_wav)
from pychain_tpu_torch.decode import PhoneDecoder, phone_error_rate
from pychain_tpu_torch.examples.train_corpus import trainables
from pychain_tpu_torch.graphs import (ChainTopology, estimate_phone_lm,
                                      make_denominator_fst,
                                      make_numerator_fst)
from pychain_tpu_torch.loss import dispatch_arrays, resolved_engine
from pychain_tpu_torch.models import TDNN, TDNNConfig
from pychain_tpu_torch.utils.device import resolve_device

SR = 16000


def default_data_dir() -> str:
    """The port's own directory, so that it and the JAX example (which
    writes under /tmp/pychain_tpu_wav) never share files."""
    return os.path.join(tempfile.gettempdir(), "pychain_tpu_torch_wav")


def synth_corpus(data_dir, utts=16, num_phones=8, seed=0):
    """Tone-per-phone synthetic speech with transcripts."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    # distinct tones, all safely below Nyquist (SR/2 = 8 kHz)
    freqs = np.linspace(300.0, 7000.0, num_phones)
    markov = rng.dirichlet(np.ones(num_phones) * 0.4, size=num_phones)
    transcripts = []
    for i in range(utts):
        n_ph = rng.randint(4, 8)
        phones = [int(rng.randint(num_phones))]
        for _ in range(n_ph - 1):
            phones.append(int(rng.choice(num_phones, p=markov[phones[-1]])))
        wav = []
        for p in phones:
            dur = rng.randint(int(0.08 * SR), int(0.2 * SR))
            t = np.arange(dur) / SR
            tone = 0.3 * np.sin(2 * np.pi * freqs[p] * t)
            wav.append(tone + 0.02 * rng.randn(dur))
        wav = np.concatenate(wav).clip(-1, 1).astype(np.float32)
        write_wav(os.path.join(data_dir, f"utt{i:03d}.wav"), wav, SR)
        transcripts.append(phones)
    with open(os.path.join(data_dir, "text"), "w") as f:
        for i, t in enumerate(transcripts):
            f.write(f"utt{i:03d} {' '.join(map(str, t))}\n")
    return transcripts


def model_config(num_pdfs) -> TDNNConfig:
    return TDNNConfig(num_pdfs=num_pdfs, hidden_dim=128,
                      kernel_sizes=(3, 3, 3), dilations=(1, 1, 2),
                      strides=(1, 1, 1), dropout=0.0)


def main(argv=None, model=None) -> dict:
    """Run the example; ``model`` replaces the seeded TDNN (a caller's
    weights).  Returns ``losses`` / ``mmi`` / ``xent`` (one a step),
    ``per`` (untrained, trained), ``den_engine`` and ``model``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=default_data_dir())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--num-phones", type=int, default=8)
    ap.add_argument("--utts", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    dev = resolve_device(args.device)

    transcripts = synth_corpus(args.data_dir, utts=args.utts,
                               num_phones=args.num_phones)
    B = len(transcripts)

    # ---- wav -> features (batched, on the device) ----
    cfg = FbankConfig(sample_rate=SR, num_bins=40)
    wavs = [read_wav(os.path.join(args.data_dir, f"utt{i:03d}.wav"))[0]
            for i in range(B)]
    n_max = max(len(w) for w in wavs)
    padded = np.zeros((B, n_max), np.float32)
    for i, w in enumerate(wavs):
        padded[i, :len(w)] = w
    feats = fbank_batch(padded, cfg, device=dev)              # (B, T, 40)
    lengths = np.array([num_frames(len(w), cfg) for w in wavs], np.int32)
    T = feats.shape[1]
    print(f"features: {B} utts, T<= {T}, dim {feats.shape[2]}")

    # ---- transcripts -> graphs (all native) ----
    topo = ChainTopology(num_phones=args.num_phones)
    lm = estimate_phone_lm(transcripts, num_phones=args.num_phones,
                           order=2)
    den = ChainGraph(make_denominator_fst(lm, topo), log_domain=False)
    nums = [ChainGraph(make_numerator_fst(t, topo), log_domain=True)
            for t in transcripts]
    num_batch = ChainGraphBatch(
        nums, max_num_transitions=max(g.num_transitions for g in nums),
        max_num_states=max(g.num_states for g in nums), device=dev)
    den_batch = ChainGraphBatch(den, B, device=dev)
    den_engine = resolved_engine(dispatch_arrays(den_batch))
    print(f"graphs: den S={den.num_states} K={den.num_transitions}, "
          f"P={topo.num_pdfs}; denominator engine: {den_engine}"
          + (" (the plain factorized engine: the phone-LM graph has "
             "residual arcs, which no kernel takes)"
             if den_engine == "xla" else ""))

    # ---- model + training ----
    if model is None:
        model = TDNN(model_config(topo.num_pdfs), feats.shape[2],
                     device=dev)
    model.eval()
    opt = torch.optim.Adam(trainables(model), lr=args.lr)

    decoder = PhoneDecoder(lm, topo)

    def eval_per():
        with torch.no_grad():
            out = model(feats, train=False)
        res = decoder(out, lengths)
        return phone_error_rate(transcripts, res.phones)

    per0 = eval_per()
    t0 = time.time()
    losses, mmis, xents = [], [], []
    for s in range(1, args.steps + 1):
        opt.zero_grad(set_to_none=True)
        out = model(feats, train=False)
        loss, (mmi, xent) = chain_loss_xent(
            out, out, lengths, num_batch, den_batch, xent_regularize=0.1,
            l2_regularize=5e-4)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        mmis.append(float(mmi.detach()))
        xents.append(float(xent.detach()))
        if s % 5 == 0 or s == 1:
            print(f"step {s}: loss={losses[-1]:.4f} mmi={mmis[-1]:.4f} "
                  f"xent={xents[-1]:.4f}")
    per1 = eval_per()
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"phone error rate {per0:.2%} -> {per1:.2%} "
          "(native Viterbi decode)")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not reduce the loss")
    return {"losses": losses, "mmi": mmis, "xent": xents,
            "per": (per0, per1), "den_engine": den_engine, "model": model}


if __name__ == "__main__":
    main()
