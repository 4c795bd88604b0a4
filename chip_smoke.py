#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pychain_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero.
Every loss kernel is held to its plain version with objf relative and
gamma and traces absolute errors of at most 1e-4, and gamma and the
alpha' stream also entry by entry: |d| <= 1e-3 |ref| + 1e-7; B1/B2 and
B3/B4 in the fast mode (bfloat16 tiles) bit for bit.

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the eight sources of csrc/*.cu with nvcc (sm_90a), all at
   once, one nvcc each, and the native host library
   (csrc/pychain_native.cc, g++), and check that each kernel's shared
   memory size in Python equals its source's (the cluster pair's in both
   precisions, with the same resident clusters for its float32 and
   bfloat16 forms at main path 4's S_pad); then run
   tests/test_torch_card.py (the kernels against their plain versions,
   in pytest) in a fresh interpreter without tests/conftest.py, which
   imports JAX: every test must pass and none skip;
3. the denominator kernels (fact_fwd, fact_bwd) against their plain
   PyTorch version on the card: small graphs in the three x_src modes
   with unequal lengths and debug True/False, then the headline graph
   (bench.py's: denominator_fst(1500, 2, bigram_fanout=30), S=3000,
   K=49.5k, P=3000) at B=128, T=500: the gather wavefronts a frame of
   each operator in ascending and in B1/B2's bank order (at most 1.6 a
   slot-warp for W1 and W1^T), fact_bwd's ring depth (two stages here),
   gamma bit-identical on a rerun, with the kernels' and the plain
   version's times, and the cluster kernels' (phase 11) at their plans
   and at C=2, G=1; then B1/B2 in the fast mode (bfloat16 tiles,
   fact_fwd_bf16 / fact_bwd_bf16) against the plain fast version, which
   they must equal bit for bit: small graphs in the three x_src modes and
   one without self-loops (no diagonal stratum) with unequal lengths,
   debug True/False and the ring forced to 2, 1 and 0 stages, gamma
   bit-identical on a rerun; then the headline graph (and the s8k class
   in phase 11): both streams too, the fast pair against the float32
   pair on the same px within the JAX package's bfloat16 budget (the
   objf's relative difference printed), both precisions' times and
   bounds and the ring depths; at B=128 the fast pair's plan is its
   group form (fact_kernels.group_size: G=2 columns a cluster of C=2
   CTAs, the operators in shared memory), whose shared memory in Python
   must equal its sources', timed beside one block a column, with a
   "#" line of the operator bytes a sweep reads (host arithmetic, not
   measured, and kept out of the kernels line);
4. the semiring kernels (semiring_fwd, semiring_bwd) against their plain
   version: small cyclic (random_fst), sausage (sausage_fst) and
   flat-start (make_numerator_fst) batches with unequal lengths and one
   infeasible sequence, the backward run twice for bit-identical gamma;
   then one batch of each size class the JAX package splits over three
   TPU kernel pairs, with each kernel's layout (semiring_kernels.plan:
   threads, ring stages, resident lists, gamma rows), the kernels' and
   the plain version's times:
   "semiring" (B5/B6) the flat-start batch of main path 2, "xl" (B7/B8)
   bench.py --xl (B=128, T=500, random_fst(1000, 3000, 5)), "xlstream"
   (B9/B10) tools/xl_stream_indomain.py (B=32, T=150,
   random_fst(3500, 512, 3));
5. main path 1: ChainLoss(den) with B=128 linear numerators over
   random pdf sequences of length T=500 and a (128, 500, 3000) float32
   leaf x, three SGD steps; the loss must be finite and fall, the
   gradient finite, and each step must launch each denominator kernel
   exactly once; one step timed with CUDA events after the warm-up step;
   then main path 1 in the fast mode (bench.py --full's configuration,
   ChainLoss(den, precision="fast")): its loss against the float32
   loss on the same x (JAX's bfloat16 budget, the relative difference
   printed), three SGD steps each launching fact_fwd_bf16 and
   fact_bwd_bf16 once and the float32 pair not at all, a profiled step;
5b. main path 5, training: bench.py --train's step (bench.py:154-234)
   through the port's public pieces, model(x, train=True) ->
   ChainLoss(den, precision="fast") -> backward -> Adam(1e-3), with
   PyTorch's TF32 defaults (printed): TDNN-512x5 (kernels 3, dilations
   1,1,3,3,3) over 40 seeded features at B=128, T=500 with linear
   numerators on the headline graph and main path 1 fast's denominator
   batch, train-mode BatchNorm; three steps, each with a finite loss and
   gradients, BatchNorm running statistics that moved and one launch of
   fact_fwd_bf16 and of fact_bwd_bf16 and of no other loss kernel, the
   third loss below the first; the timed step's ms and utts/s with the
   card, the peak device memory; the same step in float32
   (precision="parity", fact_fwd / fact_bwd once) on the same weights and
   features within the JAX bfloat16 budget of the fast loss; one
   chain_loss_xent(out, out, ...) step (xent 0.1, l2 0.01); the
   checkpoint round trip (save after step 3, restore into a fresh model
   and Adam on the card: every tensor equal, step 4's loss within 1e-6
   relative, whether its gradients were bit-identical printed); TDNN-F
   (512/128 x 6) three steps with constrain_semi_orthogonal after each
   (the deviation must not grow); BLSTM (512 x 3, bidirectional) three
   steps at lengths 250..500 passed to the model and the loss; then, not
   counted, a profiled step split into the model's forward and backward,
   B1/B2 fast, the glue and Adam, and the card's TDNN against the port's
   CPU plain path at B=4 with TF32 off (float32 loss within 1e-4
   relative, every parameter gradient within 1e-3 of its norm, the
   BatchNorm statistics within 1e-5);
6. main path 2, the same with flat-start numerators
   (make_numerator_fst, lm=None; N_b phones drawn from 100..150, T=500,
   padded to K=300, S=151): each step must launch each of the four
   kernels exactly once; then one profiled step;
7. the Viterbi kernel (viterbi) against its plain version, bit for bit
   (objf, pdfs, states, ok): small cyclic batches at unequal lengths
   with a linear graph at a length it cannot accept and a length 0,
   under x of which about a fifth lies beyond the [-30, 30] clamp, a
   shared broadcast batch, and a tie-heavy batch of +-8 oracle
   emissions;
8. main path 3, realignment (examples/train_corpus.py:552-586):
   viterbi_align over main path 2's batch and x, durations and
   tolerance-3 constrained numerators (make_constrained_numerator) from
   each best path, then three ChainLoss SGD steps on them: the loss
   must fall, the alignment launch viterbi once and each step each of
   the four loss kernels once; then the semiring kernels at this
   constrained batch ("xl" by the JAX package's rule) as in phase 4;
9. three size classes of the Viterbi kernel, each bit-identical to the
   plain version, with its layout (viterbi_kernels.plan: threads, L
   lanes a state, the x ring's stages, resident lists, the
   backpointers' width and place), both times and the bound: "realign"
   (main path 2's batch and x), "b11" (bench.py --viterbi: B=128,
   T=500, random_fst(512, 512, 4)), "decode" (the graph of phase 10);
10. decoding: PhoneDecoder over a bigram phone LM of 2,000 seeded
   transcripts of 20-60 phones over 48 phones (ChainTopology(48): S=49,
   K=2,400, P=96), once on random x and once on +-8 oracle emissions, at
   B=128, T=500, lengths 250..500: one launch per call, and the oracle
   decode must give the planned phones (PER 0) and durations;
11. the cluster kernels (stream_fwd, stream_bwd: B3/B4) against their
   plain version on small graphs in the three x_src modes (and one where
   some ranks own no rows) at every plan
   (C CTAs a cluster in 1, 2, 4, 8, G columns a CTA in 1, 2, 4), B=5
   columns of unequal lengths and debug True/False, each gamma
   bit-identical on a rerun and across G, in both precisions (the fast
   forms stream_fwd_bf16 / stream_bwd_bf16 bit for bit against the plain
   fast version with cluster=C); then the "s8k" class
   (bench.py --s8k: denominator_fst(4000, 2, bigram_fanout=30), B=64,
   T=300, which the JAX package streams in float32) forced to
   engine="stream": the plans (C, G, CTAs, active clusters, waves,
   shared memory), against the plain version and against B1/B2 on the
   same inputs, with both pairs' times and the cluster pair's at every
   plan that fits; the fast cluster pair there at its plan (C=2, G=1) bit
   for bit against the plain fast version at C=2 (debug True and False,
   both streams, gamma on a rerun), against the float32 pair within the
   JAX package's bfloat16 budget, both pairs' times and bounds; B1/B2
   themselves against the plain version there (one ring stage) and on
   an identity graph past one stage
   (denominator_fst(6000, 2, bigram_fanout=4), S_pad 12,032, no ring:
   the rows read from device memory) at B=6, T=40, gamma bit-identical
   on a rerun;
12. main path 4: ChainLoss over the 12k-state Kaldi-topology denominator
   (denominator_fst(6000, 2, num_pdfs=3000, bigram_fanout=30,
   forward_pdf_mode="separate"): S=12,000, K=198,000, P=6,000, past one
   block's shared memory) with B=128 linear numerators of length T=500
   over random pdfs in [0, 6000): the tier and plans the dispatch picks,
   the pair against the plain version at full B with debug True and
   False, with both times (and the pair's at every plan), three SGD
   steps (loss finite and falling, gradient finite, one launch of each
   cluster kernel a step and none of B1/B2), a timed and a profiled step;
   then main path 4 in the fast mode, ChainLoss(den, precision="fast"):
   the same tier, the fast cluster pair at full B on its plan (the packed
   layout: 4-byte slots, the gathered vector packed bfloat16) against
   the plain fast version at its plan's C bit for bit (debug True and
   False: objf, gamma, traces; the alpha' and W1 alpha' streams and s_t;
   gamma on a rerun), and at every plan that fits in either layout (each
   at its own C), against the float32 pair on the same px within the JAX
   package's bfloat16 budget, both pairs' times, the fast pair's in the
   float layout at (C, G) = (2, 2) in the same call (the design before
   the packed layout), the plain fast sweeps' and the bounds; three SGD
   steps on a fresh x (loss finite and falling, one launch of
   stream_fwd_bf16 and of stream_bwd_bf16 a step and of no other
   denominator kernel), the peak device memory and a profiled step;
12b. main path 6, the corpus recipe (examples/train_corpus.py through
   the port's pychain_tpu_torch/examples/train_corpus.py, its main in
   this process on the card, PyTorch's TF32 defaults; every kernel count
   set to 0 before each run and read after): (a) the PER gates at
   tests/test_recipe_smoke.py's arguments and thresholds (untrained >=
   0.5, trained <= 0.15 and <= untrained / 3) in float32 and with
   bfloat16 tiles, the decoder's viterbi launches; (b) flat start
   (--num-style flat), realignment at step 20 and 40-frame chunks: each
   semiring kernel's launches before and after the realignment (20 and
   10 steps) and viterbi's at it (12 batches), the loss finite and every
   diagnostic ok; (c) --device-corpus: the corpus staged, two
   ChainGraphBatch built in the run (before the loop), B1/B2 once a step
   and a diagnostic; (d) the recipe at bench.py's width (random graphs
   over 1,500 phones, P=3,000, 512 utterances of 400-500 frames, B=128,
   bfloat16 tiles, 12 steps): fact_fwd_bf16 and fact_bwd_bf16 once a
   step, the steady-state utts/s and frames/s beside main path 5's rate,
   the pipeline line (host assembly, transfer, starvation) and the peak
   device memory, with the card; (e) six steps with --ckpt under
   .chip_smoke_ckpt/, then a resume to twelve.  (a) checks that the
   built phone-LM denominator runs the plain version (engine "xla": its
   residual arcs take no kernel).  Each run's first inputs of each
   kernel wrapper in each stage are captured (Capture; (d)'s in a
   one-step rerun at its arguments, so that the timed run is left
   undisturbed); after the runs,
   TF32 off, each kernel is held against its plain version on them
   (B1/B2 or its fast form in (c), (d), (e): compare and the alpha'
   stream, the fast form bit for bit; the semiring pair in (b)'s flat and
   constrained stages: sr_class; viterbi at (a)'s decoder and (b)'s
   realignment: bit for bit) and timed there;
12c. main path 7, long utterances: bench.py --long --big's
   configuration unchanged (bench.py:66-83, 453-463: the headline graph,
   B=64, T=3,700, all lengths T, bfloat16 tiles), its step the value and
   gradient of the denominator objective through chain_function: under
   "auto" (the card's budget: "full"; what it chose printed), then with
   fact_kernels.stream_budget stubbed to one stream's bytes ("lean":
   fact_fwd_snap_bf16, fact_bwd_lean_bf16) and to 1 byte ("ckpt" at the
   default C=64: fact_fwd_snap_bf16 once, fact_fwd_init_bf16 and
   fact_bwd_chunk_bf16 once a chunk), and forced (stream_mode="ckpt",
   ckpt_chunk=96, which does not divide T); first a plan line: each
   form's cluster size C (fact_kernels.cluster_size: at B=64 on 132 SMs
   2 for the forward forms and fact_bwd_lean, 1 for fact_bwd and
   fact_bwd_chunk, whose cluster form is no faster), and the full pair's
   plan, the group form at G = 1 ((1, 2): one column a cluster of 2
   CTAs; one_column_checks: each form's shared memory in Python and the
   source, the clusters the card holds at once, fact_fwd_bf16's streams,
   s_t and alpha'(T_b) bit for bit against the C=2 cluster form, one
   block a column and a rerun, fact_bwd_bf16 bit for bit against one
   block a column and on a rerun, 2 B CTAs of each on 2 B distinct SMs);
   each mode's launches
   (every count 0 before its run, read after), step ms (CUDA events,
   best of 3 after a warm-up), peak device memory, objf and its largest
   difference from full; every kernel bit for bit against its plain
   version (the full pair, the lean stream and backward, the snapshot
   rows, one chunk's replay streams, the ckpt results at both chunks;
   the full mode and the ckpt mode with every form at C=1, 2 and 4, the
   full pair at C=2 with a ring of 0 and 1; the lean pair also at C=1
   and C=4 and at the plan's C with a ring of 0 and 1), each cluster of
   a C=2 launch of each form on 2 distinct SMs (%smid), every form at
   C=1 against C=2 (fact_fwd_init and fact_bwd_chunk over all of a
   call's chunks) and each mode's call with every form at C=1 against
   its plan in one call (in turns, with peak memory), each form's time
   alone at its plan with its bytes bound and its plain version's time;
   the same in float32 at T=1,000 (cut so the plain version's time stays
   small) within the parity bars, the lean and ckpt results, and each
   mode at C=1 and at C=2, bit-identical to the full kernels' (gated);
   bench.py --long (B=32, T=2,500) under "auto": its plan line, mode,
   step ms, peak memory, the full pair bit for bit against the plain fast
   version, the full pair's group form at G = 1 as at B=64,
   fact_fwd_bf16 and fact_bwd_bf16 at C=1, 2, 4 and their plans, and the
   full call at C=1 and at its plan in turns;
12d. main path 8, a shared log-domain graph: bench.py --xlstream's
   denominator (bench.py:246-372: the headline graph as
   ChainGraph(..., log_domain=True), B=32, T=150), which auto serves in
   normalized-linear form (FactorizedArrays with log_semantics, tier
   "pallas", fact_fwd at the plan's C=2): the denominator's value and
   gradient through chain_function (launches counted: one of each B1/B2
   kernel; ms best of 3 after a warm-up, utts/s), B1/B2 at leaky 0
   against the plain version (objf rel and gamma max-abs <= 1e-4; the
   alpha' stream), the same with bfloat16 tiles (fact_fwd_bf16 /
   fact_bwd_bf16 bit for bit; their plan printed and, on 132 SMs,
   checked: the group form at (1, 2) for both, timed beside the forms it
   replaced, fact_fwd_bf16's cluster form at C=2 and fact_bwd_bf16's one
   block a column), the gather A/B (impl="gather" on the same
   batch: its ms, objf and gradient within 1e-4 of factorized-log, gamma
   bit-identical on a rerun), a dead column (the graph behind a chain
   of 8 states, a column of 8 frames: objf -inf, gamma 0, ok False, the
   other 31 columns bit for bit as a batch without it, in both
   precisions), an out-of-band copy (every arc -120 nats: log_shifts set,
   objf = the unshifted objf - 120 T within 1e-4), and the cluster tier
   (main path 4's graph in the log domain at B=8, T=100: auto -> B3/B4,
   against the plain version at leaky 0, its plans and step);
12e. the gather engine beside the kernels: bench.py --xl's batch
   (B=128, T=500, random_fst(1000, 3000, 5)) through impl="gather"
   against the semiring kernels, main path 1's denominator (B=128,
   T=500) against B1/B2 (objf rel and gamma max-abs <= 1e-4, both ms, no
   kernel launched under gather), a list of 8 per-sequence prob-domain
   graphs (tools/prob_list_gather.py's: S=2000, K=13,000, T=300, P=2000)
   through impl="gather": finite, ok, equal on the card and on the CPU
   within 1e-4, its ms; viterbi_align given the GraphArrays of main
   path 3's batch equals it given the batch (after phase 8);
12f. the examples: python -m pychain_tpu_torch.tools.build_graphs on a
   data dir holding wav_to_train.synth_corpus's text (den.fst and
   num.scp read back), then examples.data_pipeline, examples.train_tdnn
   (12 steps) and examples.wav_to_train (20 steps) in process with the
   device at its default, the card: each one's launches (counts reset
   before, read after) and losses, finite, wav_to_train's falling;
12g. main path 9, the other list engines and data parallelism (each
   multi-rank phase's ranks are subprocesses started as torchrun starts
   them, under a 300 s limit, every exit code checked): (a)
   python -m pychain_tpu_torch.tools.sharded_check --precision both:
   ShardedChainLoss at main path 1's width (the headline
   denominator, B=128, linear numerators; its depth cut to T=150)
   in float32 and with bfloat16 tiles,
   on a group of one rank over NCCL (value and gradient bit for bit
   ChainLoss's) and on 2 gloo ranks sharing the card (64 rows each: loss
   within 1e-6 relative, each rank's gradient rows within 1e-4, whether
   bit-identical printed), each rank's step beside ChainLoss's on the
   same batch, and train-mode BatchNorm on a rank's rows against the whole
   batch's statistics (1e-5); (c) the 2 ranks' save_sharded /
   restore_sharded round trip (each rank's rows, the whole array into a
   plain tensor); (b) the
   recipe with --dp at main path 6 (d)'s width on one rank (in this
   process, NCCL: (d)'s 12 steps and 2 warm-up steps, the losses against
   (d)'s within 1e-5, utts/s over the same 10 steps beside (d)'s), the
   recipe at a small width and train_tdnn on 2 gloo
   ranks (three steps, TF32 off, losses within 1e-5 of one process on
   the whole batch); (d) dense_list at phase 12e's prob-domain list:
   auto's choice on the card, against the gather engine (objf 1e-5,
   gamma 1e-4), gamma bit-identical on a rerun, bfloat16 blocks within
   the bfloat16 budget, both times; (e, run after phase 8)
   impl="leveled" (the JAX package's banded engine, auto in the port)
   at main path 3's constrained batch: the semiring kernels once each,
   auto's bits, bit-identical on a rerun, its time; the launches of
   B1/B2 in both forms and of the semiring pair on the path must be
   nonzero;
12h. main path 10, the model axis (each multi-rank run's ranks
   subprocesses sharing the card over gloo, under a 300 s limit (600 s
   for the dryrun's), every exit code checked): (a)
   tools/dryrun_multichip at n = 2 and 4 ((1 x 2) and (2 x 2) meshes,
   __graft_entry__'s _setup sizes, TF32 off): JAX's two lines, each
   rank's loss within 1e-5 relative of one process's entry() on the
   card, the state after the SGD step within 1e-5 of its norm of one
   process's step, each placed kernel's local shard half of it, the
   replicated tensors bit-identical across the mp ranks, B1/B2
   (float32) launched on every rank; (b) bench.py --train's TDNN-512x5
   cut to its first two layers (P10_LAYERS), with mp_axis="mp" on a
   (1 x 2) mesh of 2 ranks (B=128, T=500, P=3000,
   ChainLoss(den, precision="fast") over the headline denominator and
   linear numerators, train-mode BatchNorm, Adam 1e-3, TF32 off, cuDNN
   deterministic): each step's loss within 1e-5 of one process's on the
   rank's weights, three steps' losses from the same seeds within 1e-5
   of one process's in float32 (precision="parity") and within
   P10_FAST_LOSS_TOL in the fast mode, every parameter's first-step
   gradient (the same weights) within P10_GRAD_TOL of its norm of one
   process's in float32 and P10_FAST_GRAD_TOL in the fast mode, the
   parameters after the first and the third step printed, the local
   shards half, the plain tensors bit-identical across the ranks, fact_fwd_bf16 / fact_bwd_bf16
   (fact_fwd / fact_bwd in float32) once a step on each rank; a rank's
   step beside one process's and main path 5's, the bytes the mp
   collectives move in a step; (c) the placed
   model's save_sharded / restore_sharded round trip (each rank's shards,
   the whole arrays into a model without a mesh); the launches of B1/B2
   in both forms on the path must be nonzero;
13. the XL roofline probe (pychain_tpu_torch/tools/xl_roofline.py: T1
   as xl_vpu on the CUDA cores, T2 as xl_mxu on the tensor cores in its
   f32 and bf16 forms): each form against its plain version on small
   shapes (K not a multiple of 16, S not a multiple of 8, a state no arc
   enters, a state of 40 in-arcs; each twice, bit-identical) and at the
   tool's default size (S=1000, K=3200, T=512, B=8), relative error with
   the tool's 1e-9 floor at most 1e-5 (f32 forms) and 5e-3 (bf16), each
   form's drift against vpu, whether xl_mxu_bf16 equals its plain
   version bit for bit, and the tensor-core operations xl_mxu's tile
   lists issue against the dense form's printed; each kernel's time at
   B=8 and 128; then the probe's own path, the tool's main() at the
   default size with 5 iterations, with the launch counts read;
14. one JSON line {"kernels": [...]} with each kernel's launches on the
   path that runs it (the xl_* rows: the probe's), its error against the
   plain version, its time, the plain version's time and the least time
   the card could take (bound_ms); the semiring and Viterbi kernels get
   one row per size class (the semiring kernels also one for main path
   3's batch; both pairs' rows with their layouts; main paths 2 and 3
   launch the semiring pair three times each), the cluster kernels one
   for main path 4 and one for s8k,
   each with its plan, B1/B2's fast forms one each (the headline's
   time at its plan, "plan": [G, C] for the group form, beside one
   block a column's in the same call ("one_block_ms"), s8k's time and
   the float32 pair's; their launches main
   paths 1 fast and 5's, fact_fwd / fact_bwd's main paths 1 and 5's),
   and the
   cluster kernels'
   fast forms one for main path 4 fast (its launches) and one for s8k,
   each with its plan and layout, the float layout's time
   ("float_layout_ms") and the float32 form's in the same run; main
   path 6 has rows of its own, one for each kernel in each stage that
   launched it ("batch" or "size_class" "main path 6 (x)"), with that
   stage's launches and the error, times and bound at its inputs; main
   path 7 one for each form of B1/B2 in each stream mode, in both
   precisions ("batch" "main path 7 ...", "stream_mode", "ckpt_chunk"),
   with its launches in that mode's run (fact_fwd_init and
   fact_bwd_chunk timed over all of a call's chunks, "ms_covers"), its
   plan's cluster size and its times at C=1 and C=2 ("cluster",
   "c1_ms", "ab_ms"; the full pair's "cluster" the group form's [G, C],
   "ms" its time there, "c1_ms" one block a column's, fact_fwd_bf16's
   "cluster_form_ms" the C=2 cluster form's, its "ab_ms")); bench.py
   --long's
   fact_fwd_bf16 and fact_bwd_bf16 one each (its plan's time, and at
   C=1, 2 and 4; fact_fwd_bf16's "cluster_form_ms" = "c2_ms"); main
   path 8 one for
   each B1/B2 kernel in both precisions and one for each of B3/B4 at its
   cluster-tier check ("leaky": 0, their launches in main path 8's
   counted steps); the rows of B1/B2 (both forms) and of the semiring
   pair at main path 3's batch also count main path 9's launches, and
   B1/B2's those of main path 10;
15. the card's name and power limit, then the last line
   {"ok": true, "device": {...}}.

Without a CUDA device it exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

# Hopper H100 SXM peaks at a 700 W power limit (NVIDIA data sheet):
# float32 and float64 outside the tensor cores, and device memory
# bandwidth.  The semiring kernels' arithmetic is float64.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_BYTES = 3.35e12
PEAK_BF16_TC_FLOPS = 989e12   # dense, tensor cores
TOL = 1e-4   # objf relative, gamma and traces absolute (docs/PARITY.md:21)
# and, entry by entry, gamma and the alpha' stream: |d| <= RTOL |ref| + ATOL.
# An entry of gamma or alpha' is about 1/P or 1/S_pad (1.7e-4 at P=6,000),
# the size of TOL itself; both are sums of positive terms, so float32
# rounding keeps each entry's relative error small.
RTOL, ATOL = 1e-3, 1e-7
# In the fast mode (bfloat16 tiles) the kernels must equal their plain
# version bit for bit: it takes every sum in their order.  (Summed in other
# orders, the bfloat16 roundings make the two drift apart by 1e-2 in gamma
# over a headline sequence.)  Against float32 the fast mode is held to the
# JAX package's own bfloat16 budget (tests/test_pallas_bf16.py:45-61):
# per-sequence objf 2e-2 relative, gamma 3e-2 relative with 5e-3
# absolute, alpha*beta and sum(gamma) within 2e-2 of 1 on active frames.
BF16_BUDGET = {"objf_rel": 2e-2, "gamma_rtol": 3e-2, "gamma_atol": 5e-3,
               "trace": 2e-2}


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else \
        f"nvidia-smi rc={out.returncode}"


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over reps calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PATH_SECONDS = {}   # each main path's (and phase's) seconds in this run


def note_seconds(name, t0):
    """Print and keep the seconds since t0 (a phase's start)."""
    PATH_SECONDS[name] = time.perf_counter() - t0
    print(f"# {name}: {PATH_SECONDS[name]:.1f} s", flush=True)


@contextlib.contextmanager
def timed_path(name):
    """Print and keep the seconds of the work inside (a main path)."""
    t0 = time.perf_counter()
    yield
    note_seconds(name, t0)


def rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def absmax(a, b):
    return float((a.double() - b.double()).abs().max())


def excess(got, ref):
    """Entry-wise |got - ref| / (ATOL + RTOL |ref|): at most 1 passes."""
    return ((got - ref).abs() / (ATOL + RTOL * ref.abs()))


def plain_for(fa, cluster=None):
    """The plain version of the denominator kernels for this graph: the
    fast one for bfloat16 tiles, in the cluster pair's order at
    ``cluster`` CTAs a cluster when given (else B1/B2's)."""
    from pychain_tpu_torch.ops import factorized as pf
    if pf.is_fast(fa):
        return functools.partial(pf.forward_backward_prob_fast,
                                 cluster=cluster)
    return pf.forward_backward_prob_fact


def compare(fa, px, lens, leaky_c, debug, label, run=None, cluster=None,
            ref=None):
    """Kernel path (``run``, default B1/B2's) vs plain path on the same
    inputs (in the fast mode the plain version in the cluster pair's
    order at ``cluster``, which ``run`` must then launch at; ``ref``: its
    result, computed once by the caller for several runs).  Returns the
    observed errors."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import is_fast
    run = run or fk.forward_backward_prob_kernel
    got = run(px, lens, fa, leaky_c, debug=debug)
    if ref is None:
        ref = plain_for(fa, cluster)(px, lens, fa, leaky_c)
    torch.cuda.synchronize()
    if not debug:
        ref = fk._frame0_traces(ref)
    errs = {"objf_rel": rel(got.objf, ref.objf),
            "gamma_abs": absmax(got.gamma, ref.gamma),
            "alpha_beta_abs": absmax(got.alpha_beta, ref.alpha_beta),
            "gamma_sum_abs": absmax(got.gamma_sum, ref.gamma_sum)}
    gamma_excess = float(excess(got.gamma, ref.gamma).max())
    same = ""
    if is_fast(fa):
        diff = {k: int((getattr(got, k) != getattr(ref, k)).sum())
                for k in ("objf", "gamma", "alpha_beta", "gamma_sum")}
        same = f"; entries not bit-identical {diff}"
        check(sum(diff.values()) == 0, f"{label} debug={debug}: the fast "
              f"kernels differ from their plain version in {diff} entries")
        check(torch.equal(got.gamma.bfloat16().float(), got.gamma),
              f"{label}: fast-mode gamma holds no bfloat16 values")
    print(f"# {label} debug={debug}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items())
        + f" gamma_excess={gamma_excess:.3e}{same}", flush=True)
    for k, v in errs.items():
        check(v <= TOL, f"{label} debug={debug}: {k}={v:.3e} > {TOL}")
    check(gamma_excess <= 1.0, f"{label} debug={debug}: a gamma entry "
          f"differs by {gamma_excess:.3e} x ({RTOL} |ref| + {ATOL})")
    check(bool(got.ok.all()), f"{label}: ok flags {got.ok.tolist()}")
    return {**errs, "gamma_excess": gamma_excess}


def alpha_err(fa, px, lens, leaky_c, label, fwd=None, cluster=None):
    """Forward kernel alone (``fwd``, default fact_fwd): its alpha' stream
    (absolute and entry by entry) and sums (relative) against the plain
    forward sweep on frames before each column's end; in the fast mode
    its alpha' and W1 alpha' streams and sums bit for bit (the plain sweep
    in the cluster pair's order at ``cluster`` when given).  Returns the
    larger of the absolute and relative errors, and the largest entry's
    excess (:func:`excess`)."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import (forward_prob_fact,
                                                  forward_prob_fast,
                                                  is_fast, px_time_major)
    ad_ys, w1ad_ys, _, _, s_ys, _, _, _ = (fwd or fk.fact_fwd)(
        px, lens.int(), fa, leaky_c)
    fast = is_fast(fa)
    with torch.no_grad():
        if fast:
            alpha_dash, w1_alpha, ref_s, _, _ = forward_prob_fast(
                px_time_major(px, fa), lens.long(), fa, leaky_c,
                cluster=cluster)
        else:
            alpha_dash, alpha_sums, _, _ = forward_prob_fact(
                px_time_major(px, fa), lens.long(), fa, leaky_c)
            ref_s = alpha_sums[1:].t()
    B, T, _ = ad_ys.shape
    live = torch.arange(T, device=px.device)[None, :] < lens[:, None]
    ref_ad = alpha_dash[1:].permute(2, 0, 1)               # (B, T, S_pad)
    ad_f = ad_ys.float()
    err_ad = float(torch.where(live, (ad_f - ref_ad).abs().amax(dim=2),
                               0.0).max())
    err_s = float(torch.where(live, (s_ys - ref_s).abs() / ref_s.abs(),
                              0.0).max())
    ad_excess = float(torch.where(live, excess(ad_f, ref_ad).amax(dim=2),
                                  0.0).max())
    same = ""
    if fast:
        ref_w1 = w1_alpha.permute(2, 0, 1)
        diff = {name: int(((got != ref) & live[:, :, None]).sum())
                for name, got, ref in (("alpha'", ad_f, ref_ad),
                                       ("W1 alpha'", w1ad_ys.float(),
                                        ref_w1))}
        diff["s_t"] = int(((s_ys != ref_s) & live).sum())
        same = f"; entries not bit-identical {diff}"
        check(sum(diff.values()) == 0, f"{label}: the fast forward kernel "
              f"differs from its plain version in {diff} entries")
    print(f"# {label} alpha' stream: abs err {err_ad:.3e}, excess "
          f"{ad_excess:.3e}; s_t rel err {err_s:.3e}{same}", flush=True)
    check(max(err_ad, err_s) <= TOL, f"{label}: alpha' stream err "
          f"{err_ad:.3e}, s_t rel err {err_s:.3e} > {TOL}")
    check(ad_excess <= 1.0, f"{label}: an alpha' entry differs by "
          f"{ad_excess:.3e} x ({RTOL} |ref| + {ATOL})")
    return max(err_ad, err_s), ad_excess


def worst(errs):
    """Key by key, the largest of several compare() results."""
    errs = list(errs)
    return {k: max(e[k] for e in errs) for k in errs[0]}


MODES = (("source", "identity"), ("cross", "matrix"), ("separate", "stream"))


def pair_times(fa, px, lens, leaky_c, fwd, bwd, reps, plain=True,
               cluster=None):
    """CUDA-event milliseconds of a denominator kernel pair alone (fwd,
    bwd: the signatures of fact_fwd / fact_bwd) and, with ``plain``, of
    the plain version of each sweep (the fast one for bfloat16 tiles, in
    the cluster pair's order at ``cluster`` when given), on the same
    inputs."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import (backward_prob_fact,
                                                  backward_prob_fast,
                                                  forward_prob_fact,
                                                  forward_prob_fast, is_fast,
                                                  px_time_major)
    P = px.shape[2]
    lens32 = lens.int()
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fwd(px, lens32, fa,
                                                          leaky_c)
    objf, tot = fk._objf(s_ys, ad_last, lens32, fa, s0)

    def run_bwd():
        return bwd(lens32, fa, leaky_c, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                   s0, tot.contiguous(), P, debug=False)

    run_bwd()
    fwd_ms = cuda_ms(lambda: fwd(px, lens32, fa, leaky_c), reps)
    bwd_ms = cuda_ms(run_bwd, reps)
    del ad_ys, w1ad, xdst, xsrc
    if not plain:
        return fwd_ms, bwd_ms
    px_tm = px_time_major(px, fa)
    lens64 = lens.long()
    with torch.no_grad():
        if is_fast(fa):
            ad, w1a, sums, _, tot = forward_prob_fast(
                px_tm, lens64, fa, leaky_c, cluster=cluster)
            plain_fwd = lambda: forward_prob_fast(px_tm, lens64, fa, leaky_c,
                                                  cluster=cluster)
            plain_bwd = lambda: backward_prob_fast(
                px_tm, lens64, fa, leaky_c, ad, w1a, sums, tot,
                cluster=cluster)
        else:
            ad, sums, _, tot = forward_prob_fact(px_tm, lens64, fa, leaky_c)
            plain_fwd = lambda: forward_prob_fact(px_tm, lens64, fa, leaky_c)
            plain_bwd = lambda: backward_prob_fact(px_tm, lens64, fa, leaky_c,
                                                   ad, sums, tot)
        plain_fwd_ms = cuda_ms(plain_fwd, 2)
        plain_bwd_ms = cuda_ms(plain_bwd, 2)
    return fwd_ms, bwd_ms, plain_fwd_ms, plain_bwd_ms


def cluster_pair(C, G):
    """The cluster kernels with C and G forced."""
    from pychain_tpu_torch.ops import stream_kernels as stk
    return (functools.partial(stk.stream_fwd, cluster=C, columns=G),
            functools.partial(stk.stream_bwd, cluster=C, columns=G))


def stream_plans(fa, B, label):
    """Each cluster kernel's plan for this graph at B columns on this
    card, printed with cudaOccupancyMaxActiveClusters (of the kernel of
    the graph's precision); returns {kernel: plan dict}."""
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.ops.factorized import is_fast
    plans = stk.plan(fa, B, torch.cuda.get_device_properties(0),
                     active=stk.card_active(fa))
    out = {}
    for name, p in plans.items():
        out[name] = {**dataclasses.asdict(p),
                     "active_clusters": stk.active_clusters(fa, p)}
        print(f"# {label} plan {name}{'_bf16' if is_fast(fa) else ''}: "
              f"C={p.cluster} G={p.columns} layout={p.layout} "
              f"threads={p.threads} CTAs={p.ctas} (per SM {p.ctas_per_sm}) "
              f"active clusters={out[name]['active_clusters']} "
              f"waves={p.waves} smem={p.smem} cost={p.cost}", flush=True)
    return out


def plan_times(fa, px, lens, leaky_c, label, reps=3):
    """Each kernel at every plan that fits (C, G), on the same inputs, and
    the CUDA-event ms of the rule's plan and its runner-up (the rule's
    first two); printed, cheapest by the plan's rule first.  In the fast
    mode each plan is also held to the plain fast version at its C, bit
    for bit: the forward's alpha' and W1 alpha' streams and s_t, the
    backward's gamma and traces (debug=True, on the streams of the
    forward kernel at that C)."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.ops.factorized import (backward_prob_fast,
                                                  forward_prob_fast,
                                                  gamma_batch_major, is_fast)
    props = torch.cuda.get_device_properties(0)
    B, T, P = px.shape
    lens32 = lens.int()
    fast = is_fast(fa)
    cands = {name: stk.candidates(fa, name, B, props,
                                  active=stk.card_active(fa))
             for name in stk.KERNELS}
    key = lambda p: f"{p.kernel}{'_bf16' if fast else ''} C={p.cluster} " \
        f"G={p.columns} {p.layout}"
    timed = {key(p) for c in cands.values() for p in c[:2]}
    out, diffs = {}, {}
    live = torch.arange(T, device=px.device)[None, :] < lens[:, None]
    # the float32 pair: every backward plan on the streams of the forward
    # at its plan; the fast pair: one C at a time, against its plain order
    for C in sorted({p.cluster for c in cands.values() for p in c}) \
            if fast else [None]:
        fwds = [p for p in cands["stream_fwd"] if C in (None, p.cluster)]
        bwds = [p for p in cands["stream_bwd"] if C in (None, p.cluster)]
        if fast:
            with torch.no_grad():
                ref_ad, ref_w1, ref_s, _, ref_tot = forward_prob_fast(
                    px.permute(1, 2, 0), lens.long(), fa, leaky_c,
                    cluster=C)
        for p in fwds:
            fn = functools.partial(stk.stream_fwd, px, lens32, fa, leaky_c,
                                   cluster=p.cluster, columns=p.columns,
                                   layout=p.layout)
            got = fn()
            if fast:
                n = int(((got[0].float() != ref_ad[1:].permute(2, 0, 1))
                         & live[:, :, None]).sum())
                n += int(((got[1].float() != ref_w1.permute(2, 0, 1))
                          & live[:, :, None]).sum())
                n += int(((got[4] != ref_s) & live).sum())
                diffs[key(p)] = n
            del got
            if key(p) in timed:
                out[key(p)] = cuda_ms(fn, reps)
        ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = stk.stream_fwd(
            px, lens32, fa, leaky_c, cluster=C)
        _, tot = fk._objf(s_ys, ad_last, lens32, fa, s0)
        tot = tot.contiguous()
        if fast:
            with torch.no_grad():
                g_tm, ref_ab, ref_gs = backward_prob_fast(
                    px.permute(1, 2, 0), lens.long(), fa, leaky_c, ref_ad,
                    ref_w1, ref_s, ref_tot, cluster=C)
                ref_gamma = gamma_batch_major(g_tm, P)
            del g_tm, ref_ad, ref_w1
        for p in bwds:
            fn = functools.partial(
                stk.stream_bwd, lens32, fa, leaky_c, ad_ys, w1ad, xdst, xsrc,
                s_ys, ad0, s0, tot, P, cluster=p.cluster, columns=p.columns,
                layout=p.layout)
            if fast:
                gamma, ab, gs = fn(debug=True)
                diffs[key(p)] = int((gamma != ref_gamma).sum()) + int(
                    (ab != ref_ab).sum()) + int((gs != ref_gs).sum())
                del gamma
            fn(debug=False)
            if key(p) in timed:
                out[key(p)] = cuda_ms(lambda: fn(debug=False), reps)
        del ad_ys, w1ad, xdst, xsrc
        if fast:
            del ref_gamma
    print(f"# {label} times at the rule's plan and its runner-up (ms, the "
          "rule's order; every plan ran): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    if fast:
        print(f"# {label} entries not bit-identical to the plain fast "
              f"version at each plan's C: {diffs}", flush=True)
        check(sum(diffs.values()) == 0, f"{label}: a plan's kernel differs "
              f"from the plain fast version: {diffs}")
    for name in stk.KERNELS:
        mine = {k: v for k, v in out.items()
                if k.split(" ")[0].removesuffix("_bf16") == name}
        pick = key(cands[name][0])
        fastest = min(mine, key=mine.get)
        print(f"# {label} {name}: the rule's plan {pick.split(' ', 1)[1]} "
              f"{mine[pick]:.3f} ms, the fastest timed "
              f"{fastest.split(' ', 1)[1]} {mine[fastest]:.3f} ms",
              flush=True)
    return out


def fact_bytes_ops(fa, kg, lens, T, P):
    """What a denominator sweep pair must move and compute for this run
    (L live frames): the forward reads px at the pdfs the graph reads and
    the graph once, and writes the streams, s_t and alpha'(T_b); the
    backward reads the streams, s_t, the graph and its pdf lists, and
    writes gamma and the two traces.  The streams count at their type's
    size: 2 bytes an entry in the fast mode (bfloat16 tiles), whose graph
    is the off-diagonal entries at 6 bytes (column id, bfloat16 value)
    and two float32 diagonals; px and gamma are float32 in both.
    Returns (fwd_bytes, fwd_ops, bwd_bytes, bwd_ops)."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, L = lens.shape[0], int(lens.sum())
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    entry = fk.stream_dtype(fa).itemsize
    s_pad, nnz = fa.s_pad, kg.nnz
    if kg.diag is None:
        graph_bytes = nnz * 8
    else:
        n_diag = sum(int((d != 0).sum()) for d in kg.diag)
        graph_bytes = (nnz - n_diag) * 6 + 2 * s_pad * 4
    graph_bytes += (s_pad + 1) * 8 + 4 * s_pad * 4
    pdfs = set(kg.f_dst.tolist())
    if kg.g_src is not None:
        pdfs |= set(kg.g_src.tolist())
    fwd_bytes = (L * len(pdfs) * 4 + graph_bytes
                 + n_streams * L * s_pad * entry + B * T * 4 + B * s_pad * 4)
    fwd_ops = 2 * nnz * L + 7 * s_pad * L
    bwd_bytes = (n_streams * L * s_pad * entry + B * T * 4 + graph_bytes
                 + (fa.p_pad + 1 + s_pad) * 4 + B * T * P * 4 + 2 * B * T * 4)
    bwd_ops = 2 * nnz * L + 15 * s_pad * L
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def resident_layout(fa, kg, label):
    """B1/B2's operators for this graph (fact_kernels.bank_order): each
    one's shared-memory gather wavefronts a frame in the ascending order
    (the cluster kernels') and in B1/B2's bank order (in the fast mode
    both of the off-diagonal entries), and each kernel's ring depth
    (fact_fwd has none).  Returns ({op: (slot-warps, ascending, bank
    order)}, fact_bwd's ring depth)."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    ascending = kg.off or (kg.w1, kg.w2, kg.w1t, kg.w2t)
    out = {}
    for name, op, asc_op in zip(("w1", "w2", "w1t", "w2t"), kg.resident,
                                ascending):
        asc = fk.gather_wavefronts(asc_op)
        banked = fk.gather_wavefronts(op)
        check(len(asc) == len(banked), f"{label} {name}: slot counts differ")
        out[name] = (len(asc), int(asc.sum()), int(banked.sum()))
    stages = fk.ring_stages(fa)
    print(f"# {label}: gather wavefronts a frame, ascending -> bank order "
          "(slot-warps; a slot-warp each): " + ", ".join(
              f"{k} {a} -> {b} ({n}; {a / max(n, 1):.3f} -> "
              f"{b / max(n, 1):.3f})" for k, (n, a, b) in out.items())
          + f"; ring depth: fact_fwd none, fact_bwd {stages} stage(s), "
          f"smem {fk.smem_bytes(fa)}", flush=True)
    return out, stages


def resident_rerun(fa, px, lens, leaky_c, label):
    """B1/B2 twice on the same inputs: gamma bit-identical."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    g1 = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c).gamma
    g2 = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c).gamma
    torch.cuda.synchronize()
    check(torch.equal(g1, g2), f"{label}: two runs of B1/B2 give "
          "different gamma")
    print(f"# {label}: B1/B2 gamma bit-identical over two runs", flush=True)


def ringless_class(dev, leaky_c):
    """B1/B2 on an identity graph past one ring stage (S_pad 12,032:
    fact_bwd reads its stream rows from device memory, ring depth 0)
    against the plain version, at B=6, T=40 with lengths T, T-2, 3, 1, 17,
    T-1; bigram fanout 4 keeps the host's bank-order search short."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    t0 = time.perf_counter()
    fst, P = denominator_fst(num_phones=6000, states_per_phone=2, seed=0,
                             bigram_fanout=4)
    fa = ChainGraphBatch(ChainGraph(fst), 6, device=dev)._fact
    kg = fk.graph_for(fa)
    print(f"# ringless graph: S_pad={fa.s_pad} xsrc_mode={fa.xsrc_mode} "
          f"nnz={kg.nnz}; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _, stages = resident_layout(fa, kg, "ringless graph")
    check(stages == 0 and fk.fits_on_chip(fa),
          f"ringless graph: ring depth {stages}, fits {fk.fits_on_chip(fa)}")
    T = 40
    g = torch.Generator(device=dev).manual_seed(13)
    px = torch.exp(torch.randn(6, T, P, generator=g, device=dev))
    lens = torch.tensor([T, T - 2, 3, 1, 17, T - 1], device=dev)
    errs = worst(compare(fa, px, lens, leaky_c, debug, "ringless B1/B2")
                 for debug in (False, True))
    resident_rerun(fa, px, lens, leaky_c, "ringless graph")
    return errs


# ----------------------------------------------------------------------
# B1/B2 in the fast mode (bfloat16 tiles)
# ----------------------------------------------------------------------

def loopless_fst(num_states, num_pdfs, seed):
    """A prob-domain graph without self-loops (so W1 and W2 have no
    diagonal stratum): a ring of states, arcs s -> s + 1, s + 2, s + 5
    (mod num_states), each with its destination's pdf."""
    from pychain_tpu_torch.graphs.fst import FST
    rng = np.random.RandomState(seed)
    arcs = [(s, d, d % num_pdfs + 1, d % num_pdfs + 1,
             float(rng.uniform(0.3, 1.5)))
            for s in range(num_states)
            for d in ((s + k) % num_states for k in (1, 2, 5))]
    return FST.from_arcs(num_states, 0, arcs, {
        s: float(rng.uniform(0.5, 2.0)) for s in range(0, num_states, 7)})


def fast_small(dev, leaky_c):
    """fact_fwd_bf16 / fact_bwd_bf16 against the plain fast version on
    small graphs: the three x_src modes (a diagonal stratum in W1) and a
    graph without self-loops (none), lengths 16, 11, 7 and 1, debug True
    and False, the ring forced to each depth that fits and to none, gamma
    bit-identical on a rerun; the fast pair's launches alone."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    graphs = [(f"fast small {mode}",) + denominator_fst(
        num_phones=12, states_per_phone=2, seed=3, forward_pdf_mode=mode)
        for mode, _ in MODES]
    graphs.append(("fast small no-diagonal", loopless_fst(90, 40, 0), 40))
    errs = []
    for label, fst, P in graphs:
        fa = ChainGraphBatch(ChainGraph(fst), 4, tile_dtype="bfloat16",
                             device=dev)._fact
        kg = fk.graph_for(fa)
        n_diag = [int((d != 0).sum()) for d in kg.diag]
        check(fk.ring_stages(fa) == 2, f"{label}: ring depth "
              f"{fk.ring_stages(fa)}")
        g = torch.Generator(device=dev).manual_seed(1)
        px = torch.exp(torch.randn(4, 16, P, generator=g, device=dev))
        lens = torch.tensor([16, 11, 7, 1], device=dev)
        for stages in (2, 1, 0):
            run = functools.partial(fk.forward_backward_prob_kernel,
                                    stages=stages)
            for debug in (True, False):
                fk.reset_launch_counts()
                errs.append(compare(
                    fa, px, lens, leaky_c, debug, f"{label} S_pad="
                    f"{fa.s_pad} {fa.xsrc_mode} diagonal entries {n_diag} "
                    f"ring {stages}", run))
                check(fk.launched() == {"fact_fwd_bf16": 1,
                                        "fact_bwd_bf16": 1},
                      f"{label}: launches {fk.launched()}")
            g1 = run(px, lens, fa, leaky_c).gamma
            g2 = run(px, lens, fa, leaky_c).gamma
            torch.cuda.synchronize()
            check(torch.equal(g1, g2), f"{label} ring {stages}: two runs "
                  "give different gamma")
        alpha_err(fa, px, lens, leaky_c, label)
    print("# fast small: gamma bit-identical over two runs at every ring "
          "depth", flush=True)
    return worst(errs)


def vs_float32(label, got, ref):
    """The fast mode's results ``got`` against float32's ``ref`` on the
    same px: within the JAX package's bfloat16 budget (the objf's
    relative difference printed, ungated beyond the budget).  Returns the
    differences."""
    vs = {"objf_rel": rel(got.objf, ref.objf),
          "objf_sum_rel": rel(got.objf.sum(), ref.objf.sum()),
          "gamma_abs": absmax(got.gamma, ref.gamma),
          "trace_dev": max(float((got.alpha_beta - 1).abs().max()),
                           float((got.gamma_sum - 1).abs().max()))}
    gamma_ok = bool(((got.gamma - ref.gamma).abs() <= BF16_BUDGET[
        "gamma_atol"] + BF16_BUDGET["gamma_rtol"] * ref.gamma.abs()).all())
    print(f"# {label}: fast vs float32 kernels on the same px: "
          + " ".join(f"{k}={v:.3e}" for k, v in vs.items())
          + f"; gamma within the JAX bfloat16 budget: {gamma_ok} (the "
          "design note's ~2e-7 agreement of the loss is printed, not "
          "gated)", flush=True)
    check(vs["objf_rel"] <= BF16_BUDGET["objf_rel"] and gamma_ok
          and vs["trace_dev"] <= BF16_BUDGET["trace"],
          f"{label}: fast vs float32 outside the JAX bfloat16 budget {vs}")
    return vs


def operator_bytes(kg, lens, plan):
    """Host arithmetic, not a measurement: the operator bytes a fast sweep
    pair reads at this run's lengths, by kernel.  One block a column reads
    every slot's column id and value (8 bytes) from L2 at every frame of
    every column; the group form reads each CTA's slots (4 bytes, packed)
    from device memory once a launch and from shared memory at every
    frame of its cluster (a cluster's CTAs hold each slot once).  Returns
    {name: (one block's L2 bytes, the plan's device-memory bytes, the
    plan's shared-memory bytes)}."""
    lens = lens.cpu().long()
    out = {}
    for name, ops in (("fact_fwd_bf16", kg.resident[:2]),
                      ("fact_bwd_bf16", kg.resident[2:])):
        slots = sum(int(op[0][-1]) * 32 for op in ops)
        before = slots * 8 * int(lens.sum())
        if isinstance(plan[name], tuple):
            G, _ = plan[name]
            groups = [lens[q:q + G] for q in range(0, len(lens), G)]
            out[name] = (before, len(groups) * slots * 4,
                         sum(slots * 4 * int(g.max()) for g in groups))
        else:
            out[name] = (before, before, 0)
    return out


def check_group_smem(fa, label):
    """The group form's shared memory in Python equals its sources' at
    every (G, C) built for each form (fact_kernels.FORM_GROUPS), for this
    graph's slot counts.  Returns {"form G C": bytes}."""
    import ctypes
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    words = fk.graph_for(fa).group_words
    got, want = {}, {}
    for form in fk.GROUP_FORMS:
        fn = getattr(build.load(form), f"{form}_group_smem_bytes")
        fn.restype = ctypes.c_size_t
        for G, C in fk.FORM_GROUPS[form]:
            got[f"{form} {G} {C}"] = fk.group_smem_bytes(fa, G, C)[form]
            want[f"{form} {G} {C}"] = fn(fa.s_pad, int(
                fa.xsrc_mode == "identity"), G, C, words[(form, C)])
    check(got == want, f"{label}: group smem Python {got} != sources {want}")
    print(f"# {label} fast: group form shared memory (Python = sources) "
          f"{got}", flush=True)
    return got


def one_column_checks(label, fa, px, lens32, leaky_c):
    """fact_fwd_bf16's and fact_bwd_bf16's plans at this batch
    (fact_kernels._form_plan; on an H100 at B <= 66 the group form at G =
    1: one column a cluster of 2 CTAs), each one's shared memory in Python
    against the source's and the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters) against B; fact_fwd at its plan
    against the C = 2 cluster form and one block a column bit for bit
    (the streams on each column's frames, s_t, alpha'(T_b)) and again on a
    rerun; on its streams fact_bwd's plan against one block a column bit
    for bit (gamma and both traces) and on a rerun; each plan's CTAs on
    distinct SMs (%smid).  Returns {form: figures}."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, T, P = px.shape
    props = torch.cuda.get_device_properties(px.device)
    smem_all = check_group_smem(fa, label)
    plan, out = {}, {}
    for form in fk.GROUP_FORMS:
        group = plan[form] = fk._form_plan(form, B, props, fa, None)
        if props.multi_processor_count == 132:
            check(group == (1, 2), f"{label}: {form}'s plan {group} on 132 "
                  "SMs, want (1, 2)")
        n = -(-B // group[0]) * group[1]
        out[form] = {"plan": list(group), "n": n,
                     "smem": smem_all[f"{form} {group[0]} {group[1]}"],
                     "active": fk.group_active_clusters(fa, form, group),
                     "smid": torch.full((n,), -1, dtype=torch.int32,
                                        device=px.device)}
    live = (torch.arange(T, device=px.device)[None, :]
            < lens32.long()[:, None])[:, :, None]

    def fwd_diff(a, b):
        d = {n: int(((x != y) & live).sum()) for n, x, y in
             zip(("alpha'", "W1 alpha'", "x_dst", "x_src"), a[:4], b[:4])
             if x is not None}
        d["s_t"] = int((a[4] != b[4]).sum())
        d["alpha'(T_b)"] = int((a[5] != b[5]).sum())
        return d

    st = fk.fact_fwd(px, lens32, fa, leaky_c, cluster=plan["fact_fwd"],
                     smid=out["fact_fwd"]["smid"])
    fdiff = {}
    for key, cl in (("rerun", plan["fact_fwd"]), ("C=2", 2),
                    ("one block", 1)):
        ref = fk.fact_fwd(px, lens32, fa, leaky_c, cluster=cl)
        fdiff[key] = fwd_diff(st, ref)
        del ref
    tot = fk._objf(st[4], st[5], lens32, fa, st[7])[1].contiguous()

    def bwd(cluster, smid=None):
        return fk.fact_bwd(lens32, fa, leaky_c, *st[:5], st[6], st[7], tot,
                           P, cluster=cluster, smid=smid)

    got = bwd(plan["fact_bwd"], out["fact_bwd"]["smid"])
    again, one = bwd(plan["fact_bwd"]), bwd(1)
    torch.cuda.synchronize()
    bdiff = {k: int((a != b).sum()) for k, a, b in
             zip(("gamma", "alpha_beta", "gamma_sum"), got, one)}
    bdiff["gamma on a rerun"] = int((again[0] != got[0]).sum())
    del st, got, again, one, live
    for form, o in out.items():
        smid = o.pop("smid")
        o["sms"] = len(set(smid.tolist()))
        o["all_recorded"] = bool((smid >= 0).all())
        print(f"# {label}: {form}_bf16's plan {tuple(o['plan'])} ({o['n']} "
              f"CTAs, {o['smem']} B of shared memory a CTA, Python = "
              f"source; {o['active']} clusters at once for "
              f"{-(-B // o['plan'][0])}); {o['sms']} distinct SMs for "
              f"{o['n']} CTAs", flush=True)
    print(f"# {label}: fact_fwd_bf16 at {plan['fact_fwd']}, entries that "
          f"differ {fdiff}; fact_bwd_bf16 at {plan['fact_bwd']} against one "
          f"block a column, entries that differ {bdiff}; {card_line()}",
          flush=True)
    check(all(v == 0 for d in fdiff.values() for v in d.values())
          and sum(bdiff.values()) == 0
          and all(o["all_recorded"] and o["sms"] == o["n"]
                  and o["active"] >= -(-B // o["plan"][0])
                  for o in out.values()),
          f"{label}: the group form at {plan}: fact_fwd {fdiff}, fact_bwd "
          f"{bdiff}, {out}")
    return out


def fast_class(label, den, P, B, T, dev, leaky_c, seed, f32_fa=None,
               fast_fa=None):
    """B1/B2 in the fast mode on ``den`` at B columns of T frames: against
    the plain fast version (debug True and False, both streams entry by
    entry, gamma bit-identical on a rerun), against the float32 kernels
    on the same px (the JAX package's bfloat16 budget; the objf's
    relative difference printed, ungated), both precisions' times, the
    fast pair's plain sweeps' times, bounds and ring depths.  Returns the
    row fields of each fast kernel."""
    from pychain_tpu_torch import ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    t0 = time.perf_counter()
    fa = fast_fa or ChainGraphBatch(den, B, tile_dtype="bfloat16",
                                    device=dev)._fact
    f32 = f32_fa or ChainGraphBatch(den, B, device=dev)._fact
    kg = fk.graph_for(fa)
    print(f"# {label} fast: S_pad={fa.s_pad} xsrc_mode={fa.xsrc_mode} "
          f"nnz={kg.nnz}, diagonal entries "
          f"{[int((d != 0).sum()) for d in kg.diag]} apart; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _, stages = resident_layout(fa, kg, f"{label} fast")
    gx = torch.Generator(device=dev).manual_seed(seed)
    px = torch.exp(torch.randn(B, T, P, generator=gx, device=dev))
    lens = torch.full((B,), T, device=dev)
    errs = worst(compare(fa, px, lens, leaky_c, debug, f"{label} fast")
                 for debug in (False, True))
    a_err, a_excess = alpha_err(fa, px, lens, leaky_c, f"{label} fast")
    resident_rerun(fa, px, lens, leaky_c, f"{label} fast")

    got = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c)
    ref = fk.forward_backward_prob_kernel(px, lens, f32, leaky_c)
    torch.cuda.synchronize()
    vs = vs_float32(label, got, ref)
    del got, ref

    # the plan (the group form past B = 66) and, beside it, one block a
    # column on the same inputs
    check_group_smem(fa, label)
    names = ("fact_fwd_bf16", "fact_bwd_bf16")
    plan = {name: fk._plan(name[:8], B, dev, fa, None) for name in names}
    grouped = [name for name in names if isinstance(plan[name], tuple)]
    if label == "headline":
        check(len(grouped) == 2, f"headline fast: the plan {plan} is not "
              "the group form for both kernels")
    fast_t = pair_times(fa, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd, 5)
    one_t = fast_t[:2]
    if grouped:
        one_t = pair_times(fa, px, lens, leaky_c,
                           functools.partial(fk.fact_fwd, cluster=1),
                           functools.partial(fk.fact_bwd, cluster=1), 5,
                           plain=False)
    f32_t = pair_times(f32, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd, 5,
                       plain=False)
    moved = operator_bytes(kg, lens, plan)
    print(f"# {label} fast plan: {plan}; operator bytes a sweep reads "
          "(host arithmetic, not measured): " + "; ".join(
              f"{n} one block a column {a / 1e9:.3f} GB from L2, the plan "
              f"{b / 1e9:.4f} GB from device memory and {c / 1e9:.3f} GB "
              "from shared memory" for n, (a, b, c) in moved.items()),
          flush=True)
    fb, fo, bb, bo = fact_bytes_ops(fa, kg, lens, T, P)
    f32_bytes = fact_bytes_ops(f32, fk.graph_for(f32), lens, T, P)
    bounds = [bound(fb, fo), bound(bb, bo), bound(*f32_bytes[:2]),
              bound(*f32_bytes[2:])]
    print(f"# {label} times (ms): fast fact_fwd_bf16 {fast_t[0]:.3f} "
          f"[one block a column {one_t[0]:.3f}] (bound {bounds[0][0]:.4f}), "
          f"fact_bwd_bf16 {fast_t[1]:.3f} [{one_t[1]:.3f}] "
          f"(bound {bounds[1][0]:.4f}, ring {stages}); float32 fact_fwd "
          f"{f32_t[0]:.3f} (bound {bounds[2][0]:.4f}), fact_bwd "
          f"{f32_t[1]:.3f} (bound {bounds[3][0]:.4f}, ring "
          f"{fk.ring_stages(f32)}); plain fast fwd {fast_t[2]:.1f}, plain "
          f"fast bwd {fast_t[3]:.1f}", flush=True)
    del px
    rows = {}
    for i, name in enumerate(("fact_fwd_bf16", "fact_bwd_bf16")):
        err = (max(a_err, errs["objf_rel"]) if i == 0 else
               max(errs["gamma_abs"], errs["alpha_beta_abs"],
                   errs["gamma_sum_abs"]))
        rows[name] = {"ms": fast_t[i], "plain_ms": fast_t[2 + i],
                      "one_block_ms": one_t[i],
                      "plan": list(plan[name]) if isinstance(
                          plan[name], tuple) else plan[name],
                      "float32_ms": f32_t[i], "bound": bounds[i],
                      "bytes": (fb, bb)[i], "ops": (fo, bo)[i],
                      "max_abs_err": err,
                      "entry_excess": a_excess if i == 0
                      else errs["gamma_excess"],
                      "ring_stages": stages if i else 0,
                      "vs_float32": vs}
    return rows


def main_path_1_fast(den, B, T, P, dev, counters):
    """Main path 1 in the fast mode (bench.py --full's configuration:
    ChainLoss(den, precision="fast")) with B linear numerators: the loss
    against the float32 ChainLoss on the same x (within the JAX
    package's bfloat16 budget, the relative difference printed), then
    three SGD steps, each launching the fast pair once and the float32
    pair not at all, and a profiled step.  Returns the fast ChainLoss too
    (its denominator batch built), for main path 5."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss
    from pychain_tpu_torch.utils.testgraphs import linear_fst
    rng = np.random.RandomState(14)
    nums = [ChainGraph(linear_fst(rng.randint(0, P, size=T)),
                       log_domain=True) for _ in range(B)]
    num_batch = ChainGraphBatch(nums, max_num_transitions=T,
                                max_num_states=T + 1, device=dev)
    fast_loss = ChainLoss(den, precision="fast")
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(15), device=dev).requires_grad_(True)
    x_lengths = torch.full((B,), T, dtype=torch.int32)
    with torch.no_grad():
        v_fast = float(fast_loss(x, x_lengths, num_batch))
        v_f32 = float(ChainLoss(den)(x, x_lengths, num_batch))
    loss_rel = abs(v_fast - v_f32) / abs(v_f32)
    print(f"# main path 1 fast: loss {v_fast!r} against float32 {v_f32!r}: "
          f"relative difference {loss_rel:.3e} (JAX bfloat16 budget "
          f"{BF16_BUDGET['objf_rel']})", flush=True)
    check(loss_rel <= BF16_BUDGET["objf_rel"], f"main path 1 fast: loss "
          f"{v_fast} vs float32 {v_f32}")
    want = {k: 0 for c in counters for k in c}
    want.update(fact_fwd_bf16=1, fact_bwd_bf16=1)
    _, step_ms, launches = train_steps(
        fast_loss, x, x_lengths, num_batch, counters, want,
        "main path 1 fast (precision=\"fast\", linear numerators)")
    profiled_step(fast_loss, x, x_lengths, num_batch,
                  "main path 1 fast (bfloat16 tiles)")
    return step_ms, launches, loss_rel, fast_loss


def check_smem():
    """Each kernel's shared memory in Python equals its source's."""
    import ctypes
    import types
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    lib_of = lambda name: ("fact_ckpt" if name == "fact_ckpt_pair" else
                           name[:8] if name.startswith("fact") else name)
    c_size = lambda name, *args: getattr(
        build.load(lib_of(name)), f"{name}_smem_bytes")(*args)
    for name in ("fact_fwd", "fact_bwd", "fact_ckpt_pair", "stream_fwd",
                 "stream_bwd"):
        getattr(build.load(lib_of(name)), f"{name}_smem_bytes").restype = \
            ctypes.c_size_t
    build.load("fact_fwd").fact_fwd_cluster_smem_bytes.restype = \
        ctypes.c_size_t
    build.load("fact_bwd").fact_bwd_cluster_smem_bytes.restype = \
        ctypes.c_size_t
    for s_pad, mode in ((3072, "identity"), (12032, "stream"),
                        (384, "matrix"), (24320, "identity")):
        fa = types.SimpleNamespace(s_pad=s_pad, xsrc_mode=mode)
        identity = int(mode == "identity")
        got, want = {}, {}
        for fast in (0, 1):
            # the fast mode: a graph with bfloat16 tiles
            fa.w1 = types.SimpleNamespace(
                operand_dtype=torch.bfloat16 if fast else torch.float32)
            for lean in (0, 1):
                got.update({f"fact_bwd fast={fast} lean={lean} stages={k}":
                            fk.smem_bytes(fa, k, bool(lean))["fact_bwd"]
                            for k in (0, 1, 2)})
                want.update({
                    f"fact_bwd fast={fast} lean={lean} stages={k}": c_size(
                        "fact_bwd", s_pad, identity, k, fast, lean)
                    for k in (0, 1, 2)})
            got[f"fact_fwd fast={fast}"] = fk.smem_bytes(fa)["fact_fwd"]
            want[f"fact_fwd fast={fast}"] = c_size("fact_fwd", s_pad,
                                                   identity, fast)
            # the ckpt mode's pair kernel: the larger of its roles'
            for k in (0, 1, 2):
                got[f"fact_ckpt_pair fast={fast} stages={k}"] = \
                    fk.pair_smem_bytes(fa, k)
                want[f"fact_ckpt_pair fast={fast} stages={k}"] = c_size(
                    "fact_ckpt_pair", s_pad, identity, k, fast)
            # every form on a cluster (C > 1: one formula for every C;
            # fact_bwd_lean's ring with px rows where they fit, P % 4 == 0)
            for k in (0, 1, 2):
                for P in (3000, 3001, 6000):
                    cl = fk.cluster_smem_bytes(fa, 2, k, P)
                    key = f"cluster fast={fast} stages={k} P={P}"
                    for form in fk.FWD_FORMS:
                        got[f"{form} {key}"] = cl[form]
                        want[f"{form} {key}"] = c_size(
                            "fact_fwd_cluster", s_pad, identity)
                    for form in fk.BWD_FORMS:
                        got[f"{form} {key}"] = cl[form]
                        want[f"{form} {key}"] = c_size(
                            "fact_bwd_cluster", s_pad, identity, k, fast, P,
                            int(form == "fact_bwd_lean"))
        # the cluster pair: the float layout's shared memory in both
        # precisions (the sources' one formula), and the same resident
        # clusters for the float32 and the bfloat16 kernel; the fast
        # forms' packed layout at G = 2 and 4
        for fast in (0, 1):
            fa.w1 = types.SimpleNamespace(
                operand_dtype=torch.bfloat16 if fast else torch.float32)
            for C in stk.CLUSTERS:
                rows = stk.rows_per_cta(s_pad, C)
                for G in stk.COLUMNS:
                    for lay in stk.layouts(fa):
                        if lay == "packed" and G == 1:
                            continue
                        key = f"fast={fast} C={C} G={G} {lay}"
                        got.update({f"{k} {key}": v for k, v in
                                    stk.smem_bytes(fa, C, G, lay).items()})
                        packed = int(lay == "packed")
                        want[f"stream_fwd {key}"] = c_size(
                            "stream_fwd", s_pad, rows, C, G, packed)
                        want[f"stream_bwd {key}"] = c_size(
                            "stream_bwd", s_pad, rows, identity, G, packed)
        check(got == want, f"smem_bytes S_pad={s_pad} {mode}: Python {got} "
              f"!= sources {want}")
        if s_pad == 12032:
            active, packed = {}, {}
            for name in stk.KERNELS:
                fn = getattr(build.load(name), f"{name}_active_clusters")
                fn.restype = ctypes.c_int
                for C in stk.CLUSTERS:
                    rows = stk.rows_per_cta(s_pad, C)
                    for G in stk.COLUMNS:
                        if not stk.fits(fa, name, C, G):
                            continue
                        args = (s_pad, rows, C, G) if name == "stream_fwd" \
                            else (s_pad, rows, identity, C, G)
                        active[f"{name} C={C} G={G}"] = (fn(*args, 0, 0),
                                                         fn(*args, 1, 0))
                        if stk.fits(fa, name, C, G, layout="packed"):
                            packed[f"{name} C={C} G={G}"] = fn(*args, 1, 1)
            check(all(a == b for a, b in active.values()),
                  f"active clusters float32 != bfloat16 at S_pad {s_pad}: "
                  f"{active}")
            check(packed and all(n >= 1 for n in packed.values()),
                  f"packed layout's active clusters at S_pad {s_pad}: "
                  f"{packed}")
            print(f"# active clusters at S_pad {s_pad} ({mode}), float32 "
                  f"and bfloat16 kernels alike: {active}; the packed "
                  f"layout's: {packed}", flush=True)
    from pychain_tpu_torch.tools import xl_roofline as xr
    xl = build.load("xl_roofline")
    for fn in (xl.xl_vpu_smem_bytes, xl.xl_mxu_smem_bytes):
        fn.restype = ctypes.c_size_t
    for S, K in ((1000, 3200), (37, 45), (4000, 20000)):
        for slots in (0, xr.VPU_SLOTS):
            for threads in (32, 256, 512):
                py = xr.vpu_smem_bytes(S, K, threads, slots)
                c = xl.xl_vpu_smem_bytes(S, K, threads, slots)
                check(py == c, f"xl_vpu smem S={S} arcs={K} threads={threads} "
                      f"slots={slots}: Python {py} != source {c}")
        for split in (1, 3):
            py = xr.mxu_smem_bytes(S, K, split)
            c = xl.xl_mxu_smem_bytes(S, K, split)
            check(py == c, f"xl_mxu smem S_pad={S} K_pad={K} split={split}: "
                  f"Python {py} != source {c}")
    from pychain_tpu_torch.ops import semiring_kernels as sk
    for name in ("semiring_fwd", "semiring_bwd"):
        getattr(build.load(name), f"{name}_smem_bytes").restype = \
            ctypes.c_size_t
    up = lambda n, m: -(-n // m) * m
    for S, K, P, E in ((151, 300, 3000, 300), (1391, 2280, 3000, 600),
                       (37, 45, 13, 7), (3500, 7091, 512, 512)):
        for res, st in sk.FWD_LADDER:
            py = sk.fwd_smem_bytes(S, K, st, res)
            c = c_size("semiring_fwd", S, K, up(K, 4), st, int(res))
            check(py == c, f"semiring_fwd smem S={S} K={K} stages={st} "
                  f"resident={res}: Python {py} != source {c}")
        for res, st, pipe, grows in sk.BWD_LADDER:
            py = sk.bwd_smem_bytes(S, K, P, E, st, res, pipe, grows)
            c = c_size("semiring_bwd", S, K, up(K, 4), up(S, 2), up(P, 4),
                       E, st, int(res), int(pipe), int(grows))
            check(py == c, f"semiring_bwd smem S={S} K={K} P={P} E={E} "
                  f"{(res, st, pipe, grows)}: Python {py} != source {c}")
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    build.load("viterbi").viterbi_smem_bytes.restype = ctypes.c_size_t
    for S, K, P, T in ((151, 300, 3000, 500), (49, 2400, 96, 500),
                       (512, 1400, 512, 500), (3, 304, 8, 9),
                       (29056, 60, 12, 40)):
        for res, st, bps in vk.CHOICES:
            for width in (1, 2, 4):
                py = vk.smem_bytes(S, K, T, P, st, res, bps, width)
                c = c_size("viterbi", S, K, T, P, st, int(res), int(bps),
                           width)
                check(py == c, f"viterbi smem S={S} K={K} T={T} P={P} "
                      f"{(res, st, bps, width)}: Python {py} != source {c}")
    print("# shared memory: Python sizes equal the sources' "
          "(fact_fwd, fact_bwd and fact_bwd_lean with a ring of 0, 1, 2 "
          "stages, every form's cluster form, in both precisions, stream_* at "
          "C = 1, 2, 4, 8 and G = 1, 2, 4 in both precisions, xl_vpu, "
          "xl_mxu, semiring_* and "
          "viterbi at every layout their plans can choose)", flush=True)


CARD_TEST_SHARDS = 4   # pytest processes at once on the card


def card_tests(shards=CARD_TEST_SHARDS):
    """tests/test_torch_card.py on this card, in fresh interpreters
    without tests/conftest.py (which imports JAX), its classes spread over
    ``shards`` pytest processes run at once (each test class whole in one,
    each process its own --basetemp): every test must pass and none skip.
    The tests hold bits, not times, and nothing else runs on the card
    meanwhile."""
    import tempfile
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    pytest = [sys.executable, "-m", "pytest", "--noconftest", "-p",
              "no:cacheprovider", "-q", "-rs"]
    listed = subprocess.run(pytest + ["--collect-only",
                                      "tests/test_torch_card.py"],
                            cwd=root, capture_output=True, text=True,
                            timeout=300)
    ids = [line for line in listed.stdout.splitlines()
           if line.startswith("tests/test_torch_card.py::")]
    check(listed.returncode == 0 and ids, f"card tests: collection failed "
          f"(rc={listed.returncode})\n{listed.stdout[-3000:]}"
          f"\n{listed.stderr[-2000:]}")
    classes = {}
    for node in ids:
        classes.setdefault("::".join(node.split("::")[:2]), []).append(node)
    lots = [[] for _ in range(shards)]
    for tests in sorted(classes.values(), key=len, reverse=True):
        min(lots, key=len).extend(tests)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_card_tests_")
    procs = []
    try:
        for k, lot in enumerate(lots):
            if lot:
                procs.append(subprocess.Popen(
                    pytest + ["--durations=4", f"--basetemp={tmp}/{k}",
                              *lot], cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    total, slow = 0, []
    for p, (out, err) in zip(procs, outs):
        lines = out.strip().splitlines()
        summary = lines[-1] if lines else ""
        passed = re.search(r"(\d+) passed", summary)
        check(p.returncode == 0 and passed is not None and not re.search(
                  r"skipped|failed|error|xfail|xpass|deselected", summary),
              f"card tests (pytest rc={p.returncode}): {summary}\n"
              f"{out[-6000:]}\n{err[-2000:]}")
        total += int(passed.group(1))
        slow += [" ".join(line.split()) for line in lines
                 if re.match(r"\s*[0-9.]+s (call|setup|teardown) ", line)]
    check(total == len(ids), f"card tests: {total} passed of {len(ids)}")
    print(f"# card tests (tests/test_torch_card.py, --noconftest): {total} "
          f"passed, none skipped, in {time.perf_counter() - t0:.1f} s on "
          f"{len(procs)} pytest processes at once ({[len(x) for x in lots]} "
          f"tests); the slowest: {'; '.join(slow)}", flush=True)


def stream_small(dev, leaky_c):
    """The cluster pair against the plain version on small graphs
    (S_pad = 384: with C = 8 some CTAs own one slice, others two; and
    S_pad = 128, where ranks 4-7 of 8 own none) at every (C, G), C in 1,
    2, 4, 8 and G in 1, 2, 4, with B = 5 columns of unequal lengths (no
    G > 1 divides B); gamma bit-identical on a rerun and across G at
    each C.  Both precisions: in the fast mode (bfloat16 tiles,
    stream_fwd_bf16 / stream_bwd_bf16) bit-identical to the plain fast
    version at each C."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    errs = []
    cases = [(m, p, td) for td in (None, "bfloat16") for m, p in
             zip(MODES + MODES[-1:], (150, 150, 150, 10))]
    for (mode, want), phones, tile_dtype in cases:
        fst, P = denominator_fst(num_phones=phones, states_per_phone=2,
                                 seed=3, forward_pdf_mode=mode)
        fa = ChainGraphBatch(ChainGraph(fst), 5, tile_dtype=tile_dtype,
                             device=dev)._fact
        check(fa.xsrc_mode == want,
              f"{mode}: xsrc_mode {fa.xsrc_mode} != {want}")
        if tile_dtype:
            mode = f"{mode} fast"
        g = torch.Generator(device=dev).manual_seed(1)
        px = torch.exp(torch.randn(5, 16, P, generator=g, device=dev))
        lens = torch.tensor([16, 11, 7, 1, 13], device=dev)
        for C in stk.CLUSTERS:
            first = None
            for G in stk.COLUMNS:
                run = functools.partial(stk.forward_backward_prob_stream,
                                        cluster=C, columns=G)
                for debug in (True, False):
                    errs.append(compare(
                        fa, px, lens, leaky_c, debug, f"stream small {mode} "
                        f"S_pad={fa.s_pad} C={C} G={G}", run, cluster=C))
                g1 = run(px, lens, fa, leaky_c).gamma
                g2 = run(px, lens, fa, leaky_c).gamma
                torch.cuda.synchronize()
                check(torch.equal(g1, g2), f"stream small {mode} C={C} "
                      f"G={G}: two runs give different gamma")
                first = g1 if first is None else first
                check(torch.equal(g1, first), f"stream small {mode} C={C}: "
                      f"gamma at G={G} differs from G=1")
    print("# stream small: gamma bit-identical over two runs and across G "
          "at every mode and cluster size, in both precisions (the fast "
          "pair bit-identical to the plain fast version at each C)",
          flush=True)
    return errs


def s8k_class(dev, leaky_c):
    """bench.py --s8k's graph at B=64, T=300 (the JAX package streams it
    in float32) forced to engine="stream": against the plain version and
    against B1/B2 on the same inputs, with both pairs' times and the
    cluster pair's at every plan."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    B, T = 64, 300
    t0 = time.perf_counter()
    den_fst, P = denominator_fst(num_phones=4000, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    den = ChainGraph(den_fst)
    fa = dataclasses.replace(ChainGraphBatch(den, B, device=dev)._fact,
                             engine="stream")
    kg = fk.graph_for(fa)
    print(f"# s8k graph: S={den.num_states} K={den.num_transitions} P={P} "
          f"s_pad={fa.s_pad} xsrc_mode={fa.xsrc_mode} nnz={kg.nnz}; "
          f"engine={fa.engine}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _, stages = resident_layout(fa, kg, "s8k")
    check(stages == 1, f"s8k: fact_bwd ring {stages} != 1")
    plans = stream_plans(fa, B, "s8k")
    gx = torch.Generator(device=dev).manual_seed(12)
    px = torch.exp(torch.randn(B, T, P, generator=gx, device=dev))
    lens = torch.full((B,), T, device=dev)
    errs = worst(compare(fa, px, lens, leaky_c, debug, "s8k stream",
                         stk.forward_backward_prob_stream)
                 for debug in (False, True))
    a_err = alpha_err(fa, px, lens, leaky_c, "s8k", stk.stream_fwd)
    # B1/B2 themselves (one ring stage here) against the plain version
    errs_b12 = worst(compare(fa, px, lens, leaky_c, debug, "s8k B1/B2")
                     for debug in (False, True))
    alpha_err(fa, px, lens, leaky_c, "s8k B1")
    got = stk.forward_backward_prob_stream(px, lens, fa, leaky_c)
    res = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c)
    vs_b12 = {"objf_rel": rel(got.objf, res.objf),
              "gamma_abs": absmax(got.gamma, res.gamma)}
    del got, res
    print(f"# s8k: stream pair vs B1/B2 on the same inputs: {vs_b12}",
          flush=True)
    for k, v in vs_b12.items():
        check(v <= TOL, f"s8k: stream vs B1/B2 {k}={v:.3e}")
    times = pair_times(fa, px, lens, leaky_c, stk.stream_fwd, stk.stream_bwd,
                       5)
    fact_ms = pair_times(fa, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd,
                         5, plain=False)
    plan_times(fa, px, lens, leaky_c, "s8k")
    print(f"# s8k times: stream_fwd {times[0]:.3f} ms, stream_bwd "
          f"{times[1]:.3f} ms (plans above); fact_fwd {fact_ms[0]:.3f} ms, "
          f"fact_bwd {fact_ms[1]:.3f} ms; plain fwd {times[2]:.1f} ms, "
          f"plain bwd {times[3]:.1f} ms", flush=True)
    bytes_ops = fact_bytes_ops(fa, kg, lens, T, P)
    # the cluster pair in the fast mode at its plan (C=2, G=1) on the same
    # px, then B1/B2 in the fast mode (bench.py --s8k's bfloat16 tiles)
    fast_fa = ChainGraphBatch(den, B, tile_dtype="bfloat16",
                              device=dev)._fact
    stream_fast = fast_cluster_class("s8k", fast_fa, fa, px, lens, leaky_c,
                                     columns=1)
    del px
    fast_rows = fast_class("s8k", den, P, B, T, dev, leaky_c, 12,
                           f32_fa=fa, fast_fa=fast_fa)
    return (errs, a_err, times, bytes_ops, plans, errs_b12, fact_ms,
            fast_rows, stream_fast)


def fast_cluster_class(label, fa, f32, px, lens, leaky_c, columns=None,
                       every_plan=False):
    """The cluster pair in the fast mode (stream_fwd_bf16, stream_bwd_bf16)
    on ``fa`` (bfloat16 tiles) at its plan's C (and ``columns``, else the
    plan's G there): against the plain fast version at that C, bit for bit
    (debug False and True: objf, gamma and the traces; the alpha' and
    W1 alpha' streams and s_t), gamma bit-identical on a rerun; against
    the float32 cluster pair on ``f32`` and the same px (the JAX
    package's bfloat16 budget); both pairs' times at their plans, the
    plain fast sweeps' (in that C's order) and the bounds; the fast pair
    in the float layout at its plan before the packed layout (C = 2, G =
    ``columns`` or 2) in the same call; with ``every_plan``, every plan
    that fits, each held to the plain version too.  Returns the row
    fields of each fast kernel."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    B, T, P = px.shape
    plans = stream_plans(fa, B, f"{label} fast")
    C = plans["stream_fwd"]["cluster"]
    run = functools.partial(stk.forward_backward_prob_stream, cluster=C,
                            columns=columns)
    errs = worst(compare(fa, px, lens, leaky_c, debug,
                         f"{label} fast cluster pair C={C} "
                         f"G={columns or 'plan'}",
                         run, cluster=C)
                 for debug in (False, True))
    a_err, a_excess = alpha_err(
        fa, px, lens, leaky_c, f"{label} fast stream_fwd_bf16",
        functools.partial(stk.stream_fwd, cluster=C, columns=columns),
        cluster=C)
    got = run(px, lens, fa, leaky_c)
    again = run(px, lens, fa, leaky_c)
    torch.cuda.synchronize()
    check(torch.equal(got.gamma, again.gamma), f"{label} fast: two runs of "
          "the cluster pair give different gamma")
    del again
    ref = stk.forward_backward_prob_stream(px, lens, f32, leaky_c)
    vs = vs_float32(f"{label} cluster pair", got, ref)
    del got, ref
    fast_t = pair_times(fa, px, lens, leaky_c, stk.stream_fwd,
                        stk.stream_bwd, 5, cluster=C)
    f32_t = pair_times(f32, px, lens, leaky_c, stk.stream_fwd,
                       stk.stream_bwd, 5, plain=False)
    before = {"cluster": 2, "columns": columns or 2, "layout": "float"}
    float_t = pair_times(fa, px, lens, leaky_c,
                         functools.partial(stk.stream_fwd, **before),
                         functools.partial(stk.stream_bwd, **before), 5,
                         plain=False)
    if every_plan:
        plan_times(fa, px, lens, leaky_c, f"{label} fast")
    fb, fo, bb, bo = fact_bytes_ops(fa, fk.graph_for(fa), lens, T, P)
    bounds = [bound(fb, fo), bound(bb, bo)]
    lay = f"C={C} G={plans['stream_fwd']['columns']} " \
        f"{plans['stream_fwd']['layout']}"
    print(f"# {label} fast times (ms) at the plan ({lay}), the float layout "
          f"at C=2 G={before['columns']} in brackets: stream_fwd_bf16 "
          f"{fast_t[0]:.3f} [{float_t[0]:.3f}] (bound {bounds[0][0]:.4f}), "
          f"stream_bwd_bf16 {fast_t[1]:.3f} [{float_t[1]:.3f}] (bound "
          f"{bounds[1][0]:.4f}); float32 stream_fwd {f32_t[0]:.3f}, "
          f"stream_bwd {f32_t[1]:.3f}; plain fast fwd {fast_t[2]:.1f}, "
          f"plain fast bwd {fast_t[3]:.1f} (C={C})", flush=True)
    rows = {}
    for i, name in enumerate(("stream_fwd_bf16", "stream_bwd_bf16")):
        plan = plans[name[:10]]
        err = (max(a_err, errs["objf_rel"]) if i == 0 else
               max(errs["gamma_abs"], errs["alpha_beta_abs"],
                   errs["gamma_sum_abs"]))
        rows[name] = {"ms": fast_t[i], "plain_ms": fast_t[2 + i],
                      "float32_ms": f32_t[i], "float_layout_ms": float_t[i],
                      "layout": plan["layout"], "bound": bounds[i],
                      "bytes": (fb, bb)[i], "ops": (fo, bo)[i],
                      "max_abs_err": err,
                      "entry_excess": a_excess if i == 0
                      else errs["gamma_excess"],
                      "cluster": plan["cluster"], "columns": plan["columns"],
                      "active_clusters": plan["active_clusters"],
                      "vs_float32": vs}
    return rows


def main_path_4(dev, leaky_c, counters):
    """Main path 4: ChainLoss over the 12k-state Kaldi-topology
    denominator at B=128, T=500 with linear numerators."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss
    from pychain_tpu_torch import loss as pt_loss
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import (denominator_fst,
                                                    linear_fst)
    B, T = 128, 500
    t0 = time.perf_counter()
    den_fst, P = denominator_fst(num_phones=6000, states_per_phone=2,
                                 num_pdfs=3000, seed=0, bigram_fanout=30,
                                 forward_pdf_mode="separate")
    den = ChainGraph(den_fst)
    loss_mod = ChainLoss(den)
    fa = pt_loss.dispatch_arrays(loss_mod.den_batch(B))
    engine = pt_loss.den_engine(fa)
    check(engine == "stream", f"main path 4: tier {engine!r}")
    kg = fk.graph_for(fa)
    print(f"# main path 4 graph: S={den.num_states} K={den.num_transitions} "
          f"P={P} s_pad={fa.s_pad} p_pad={fa.p_pad} xsrc_mode="
          f"{fa.xsrc_mode} nnz(W1+W2)={kg.nnz}; tier engine={engine!r} "
          f"(B1/B2 would need {fk.smem_bytes(fa)} of {fk.MAX_SMEM} bytes); "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    plans = stream_plans(fa, B, "main path 4")
    gx = torch.Generator(device=dev).manual_seed(10)
    px = torch.exp(torch.randn(B, T, P, generator=gx, device=dev))
    lens = torch.full((B,), T, device=dev)
    # debug=True: the alpha*beta and sum-gamma traces at every frame
    errs = worst(compare(fa, px, lens, leaky_c, debug, "main path 4",
                         stk.forward_backward_prob_stream)
                 for debug in (False, True))
    a_err = alpha_err(fa, px, lens, leaky_c, "main path 4", stk.stream_fwd)
    times = pair_times(fa, px, lens, leaky_c, stk.stream_fwd, stk.stream_bwd,
                       5)
    plan_times(fa, px, lens, leaky_c, "main path 4")
    print(f"# main path 4 times: stream_fwd {times[0]:.3f} ms, stream_bwd "
          f"{times[1]:.3f} ms (plans above); plain fwd {times[2]:.1f} ms, "
          f"plain bwd {times[3]:.1f} ms", flush=True)
    # the fast mode (bfloat16 tiles): ChainLoss(den, precision="fast")
    # takes the same tier, on the cluster pair's bfloat16 forms
    fast_loss = ChainLoss(den, precision="fast")
    fa_fast = pt_loss.dispatch_arrays(fast_loss.den_batch(B))
    check(pt_loss.den_engine(fa_fast) == "stream", "main path 4 fast: tier "
          f"{pt_loss.den_engine(fa_fast)!r}")
    fast_rows = fast_cluster_class("main path 4", fa_fast, fa, px, lens,
                                   leaky_c, every_plan=True)
    check(all(r["layout"] == "packed" for r in fast_rows.values()),
          "main path 4 fast: the plan is not the packed layout: "
          f"{ {k: r['layout'] for k, r in fast_rows.items()} }")
    del px
    torch.cuda.empty_cache()

    rng = np.random.RandomState(4)
    nums = [ChainGraph(linear_fst(rng.randint(0, P, size=T)),
                       log_domain=True) for _ in range(B)]
    num_batch = ChainGraphBatch(nums, max_num_transitions=T,
                                max_num_states=T + 1, device=dev)
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(11), device=dev).requires_grad_(True)
    x_lengths = torch.full((B,), T, dtype=torch.int32)
    want = {k: 0 for c in counters for k in c}
    want.update(stream_fwd=1, stream_bwd=1)
    torch.cuda.reset_peak_memory_stats()
    _, step_ms, launches = train_steps(
        loss_mod, x, x_lengths, num_batch, counters, want,
        "main path 4 (12k-state Kaldi-topology denominator)")
    print(f"# main path 4: peak device memory over the steps "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profiled_step(loss_mod, x, x_lengths, num_batch,
                  "main path 4 (cluster tier)")
    del x
    torch.cuda.empty_cache()
    # main path 4 in the fast mode: three steps on a fresh x, each
    # launching each fast cluster kernel once and no other denominator
    # kernel
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(11), device=dev).requires_grad_(True)
    want = {k: 0 for c in counters for k in c}
    want.update(stream_fwd_bf16=1, stream_bwd_bf16=1)
    torch.cuda.reset_peak_memory_stats()
    _, fast_step_ms, fast_launches = train_steps(
        fast_loss, x, x_lengths, num_batch, counters, want,
        "main path 4 fast (precision=\"fast\", cluster tier)")
    print(f"# main path 4 fast: peak device memory over the steps "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profiled_step(fast_loss, x, x_lengths, num_batch,
                  "main path 4 fast (cluster tier, bfloat16 tiles)")
    del x
    torch.cuda.empty_cache()
    return (errs, a_err, times, fact_bytes_ops(fa, kg, lens, T, P), plans,
            step_ms, launches, fast_rows, fast_step_ms, fast_launches)


# ----------------------------------------------------------------------
# Main path 7: long utterances (bench.py --long --big's denominator step)
# ----------------------------------------------------------------------

LONG_BIG = (64, 3700)   # bench.py --long --big (bench.py:66-83)
LONG = (32, 2500)       # bench.py --long
LONG_F32_T = 1000       # float32 at a cut T: the plain version's time
ODD_CHUNK = 96          # a ckpt chunk that divides neither 3,700 nor 1,000
PAIR_NAME = {True: "fact_ckpt_pair_bf16", False: "fact_ckpt_pair"}


@contextlib.contextmanager
def card_budget(nbytes):
    """fact_kernels.stream_budget stubbed to ``nbytes`` (None: the card's):
    "auto" then takes the cheapest mode whose streams fit it."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    real = fk.stream_budget
    if nbytes is not None:
        fk.stream_budget = lambda device: nbytes
    try:
        yield
    finally:
        fk.stream_budget = real


def event_ms(fn):
    """fn() and its milliseconds on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def den_step(x, lens, batch, budget=None):
    """One value and gradient of the denominator objective through the
    user's entry point, chain_function (bench.py:453-463: value_and_grad
    of chain_function on the denominator batch), under "auto" with the
    card's stream budget stubbed to ``budget`` when given."""
    from pychain_tpu_torch.loss import chain_function
    with card_budget(budget):
        objf = chain_function(x, lens, batch)
        objf.backward()
    x.grad = None
    return float(objf.detach())


def step_stats(fn, reps=3):
    """fn (one step) after a warm-up: (best ms, all ms, peak device
    memory, the peak over the memory held before the steps)."""
    fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = [event_ms(fn)[1] for _ in range(reps)]
    peak = torch.cuda.max_memory_allocated()
    return min(times), times, peak, peak - held


def mode_bytes_ops(fa, kg, lens, T, P, C):
    """What each kernel form must move and compute for one call in its
    stream mode (fact_bytes_ops's terms: px at the pdfs the graph reads,
    the graph, the streams at their type's size, s_t, alpha'(T_b), gamma,
    the traces), per form: fact_fwd / fact_bwd (full), fact_fwd_snap at 1
    (lean) and at C (ckpt), fact_bwd_lean (the alpha' stream and px in
    place of the three streams, and W1's rows once more), and, summed over
    the call's chunks, fact_fwd_init (the snapshots in, the streams out,
    the graph once a chunk) and fact_bwd_chunk (the streams, the graph
    and lists once a chunk, the beta' carry out and in), and the two
    together for the paired scan (fact_ckpt_pair).  Returns {form:
    (bytes, ops)}."""
    B, L = lens.shape[0], int(lens.sum())
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    entry = 2 if kg.diag else 4
    s_pad, nnz = fa.s_pad, kg.nnz
    val_bytes = 8 if kg.diag is None else 6
    nnz_w1 = int((kg.resident[0][2] != 0).sum())
    graph = nnz * val_bytes + (2 * s_pad * 4 if kg.diag else 0) \
        + (s_pad + 1) * 8 + 4 * s_pad * 4
    pdfs = set(kg.f_dst.tolist())
    if kg.g_src is not None:
        pdfs |= set(kg.g_src.tolist())
    px_read = L * len(pdfs) * 4
    stream = L * s_pad * entry
    sums, last = B * T * 4, B * s_pad * 4
    lists = (fa.p_pad + 1 + s_pad) * 4
    gamma = B * T * P * 4 + 2 * B * T * 4
    n_chunks = -(-T // C)
    snaps = sum(int(n) // C for n in lens.tolist()) * s_pad * entry
    fwd_ops = 2 * nnz * L + 7 * s_pad * L
    bwd_ops = 2 * nnz * L + 15 * s_pad * L
    out = {
        "fact_fwd": (px_read + graph + n_streams * stream + sums + last,
                     fwd_ops),
        "fact_bwd": (n_streams * stream + sums + graph + lists + gamma,
                     bwd_ops),
        "fact_fwd_snap lean": (px_read + graph + stream + sums + last,
                               fwd_ops),
        "fact_bwd_lean": (stream + px_read + sums + graph
                          + nnz_w1 * val_bytes + lists + gamma,
                          bwd_ops + 2 * nnz_w1 * L),
        "fact_fwd_snap ckpt": (px_read + graph + snaps + sums + last,
                               fwd_ops),
        "fact_fwd_init": (px_read + n_chunks * graph + snaps
                          + n_streams * stream, fwd_ops),
        "fact_bwd_chunk": (n_streams * stream + snaps + sums
                           + n_chunks * (graph + lists) + gamma
                           + 2 * (n_chunks - 1) * B * (s_pad + 1) * 4,
                           bwd_ops),
    }
    # the paired scan: both forms' work
    out["fact_ckpt_pair"] = tuple(a + b for a, b in zip(
        out["fact_fwd_init"], out["fact_bwd_chunk"]))
    return out


def ckpt_chunks(fa, px, lens32, leaky_c, C):
    """One ckpt call's chunks on the fast sweep's snapshots, each chunk's
    streams in buffers of their own: a namespace of chunks [(t0, alpha'(t0),
    s_{t0}, streams)], s_ys, ad0, s0, tot, the outputs and the carry."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, T, P = px.shape
    snaps, s_ys, ad_last, ad0, s0 = fk.fact_fwd_snap(px, lens32, fa, leaky_c,
                                                     C)
    tot = fk._objf(s_ys, ad_last, lens32, fa, s0)[1].contiguous()
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    entry = ad0.to(fk.stream_dtype(fa)).expand(B, fa.s_pad)
    chunks = []
    for k in range(snaps.shape[1]):
        t0, n = k * C, min(C, T - k * C)
        chunks.append((t0, entry if k == 0 else snaps[:, k - 1],
                       s0.expand(B) if k == 0 else s_ys[:, t0 - 1],
                       [torch.empty((B, n, fa.s_pad),
                                    dtype=fk.stream_dtype(fa),
                                    device=px.device)
                        for _ in range(n_streams)]
                       + [None] * (4 - n_streams)))
    return types.SimpleNamespace(
        chunks=chunks, s_ys=s_ys, ad0=ad0, s0=s0, tot=tot,
        outs=fk._outputs(B, T, P, px.device),
        carry=(torch.empty((B, fa.s_pad), device=px.device),
               torch.empty(B, device=px.device)))


def chunk_runs(fa, px, lens32, leaky_c, C):
    """The ckpt mode's 58 (T / C) replays and chunk backwards of one call
    (:func:`ckpt_chunks`): (replays(cluster), backwards(cluster), paired()),
    the first two running all of a call's chunks at ``cluster`` CTAs a
    column (None: the plan's), the third the paired scan
    (fact_ckpt_pair on fact_kernels.pair_schedule) over the same
    buffers."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    ck = ckpt_chunks(fa, px, lens32, leaky_c, C)

    def replays(cluster=None):
        for t0, ad_init, s_init, streams in ck.chunks:
            fk.fact_fwd_init(px, lens32, fa, leaky_c, t0, ad_init, s_init,
                             streams, cluster)

    def backwards(cluster=None):
        for t0, ad_init, _, streams in reversed(ck.chunks):
            fk.fact_bwd_chunk(lens32, fa, leaky_c, streams, ck.s_ys, ck.ad0,
                              ck.s0, ck.tot, t0, ad_init, ck.outs, ck.carry,
                              debug=False, cluster=cluster)

    def paired():
        for kb, kf in fk.pair_schedule(len(ck.chunks)):
            back = None if kb is None else ck.chunks[kb]
            fk.fact_ckpt_pair(
                px, lens32, fa, leaky_c,
                None if kf is None else ck.chunks[kf],
                None if back is None else (back[0], back[1], back[3]),
                ck.s_ys, ck.ad0, ck.s0, ck.tot, ck.outs, ck.carry,
                debug=False)

    return replays, backwards, paired


def mode_kernel_times(fa, px, lens32, leaky_c, C, reps=3):
    """Each kernel form alone on the card at this call's inputs and its
    plan's cluster size (CUDA events, the mean of ``reps`` calls):
    fact_fwd and fact_bwd (full), fact_fwd_snap at 1 and fact_bwd_lean
    (lean), fact_fwd_snap at C and, over all the call's chunks,
    fact_fwd_init and fact_bwd_chunk (ckpt, unpaired) and the paired scan
    (fact_ckpt_pair: its T / C + 1 launches), each chunk's streams in
    buffers of their own.  Returns {form: ms}."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    fwd_ms, bwd_ms = pair_times(fa, px, lens32, leaky_c, fk.fact_fwd,
                                fk.fact_bwd, reps, plain=False)
    out = {"fact_fwd": fwd_ms, "fact_bwd": bwd_ms}
    ad1, s_ys, ad_last, ad0, s0 = fk.fact_fwd_snap(px, lens32, fa, leaky_c)
    _, tot = fk._objf(s_ys, ad_last, lens32, fa, s0)
    tot = tot.contiguous()
    out["fact_fwd_snap lean"] = cuda_ms(
        lambda: fk.fact_fwd_snap(px, lens32, fa, leaky_c), reps)
    out["fact_bwd_lean"] = cuda_ms(
        lambda: fk.fact_bwd_lean(lens32, fa, leaky_c, ad1, px, s_ys, ad0, s0,
                                 tot, debug=False), reps)
    del ad1
    out["fact_fwd_snap ckpt"] = cuda_ms(
        lambda: fk.fact_fwd_snap(px, lens32, fa, leaky_c, C), reps)
    replays, backwards, paired = chunk_runs(fa, px, lens32, leaky_c, C)
    out["fact_fwd_init"] = cuda_ms(replays, reps)
    out["fact_bwd_chunk"] = cuda_ms(backwards, reps)
    paired()
    out["fact_ckpt_pair"] = cuda_ms(paired, reps)
    return out


def pair_checks(label, fa, px, lens32, leaky_c, C, res):
    """The ckpt mode's paired scan against the unpaired one (both through
    fact_kernels._ckpt, the choice forced; ``res``: the paired result of
    forward_backward_prob_kernel), bit for bit, and one pair launch's
    blocks on 2 B distinct SMs (smid), chunk k's backward beside chunk
    k - 1's replay in the middle of the call."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, T, P = px.shape
    objf, outs = fk._ckpt(px, lens32, fa, leaky_c, True, None, C,
                          paired=False)
    diff = bit_diff(res, {"objf": objf, "gamma": outs[0],
                          "alpha_beta": outs[1], "gamma_sum": outs[2]})
    del outs
    ck = ckpt_chunks(fa, px, lens32, leaky_c, C)
    k = len(ck.chunks) // 2
    t0, ad_init, _, streams = ck.chunks[k]
    fk.fact_fwd_init(px, lens32, fa, leaky_c, *ck.chunks[k], cluster=1)
    smid = torch.full((2 * B,), -1, dtype=torch.int32, device=px.device)
    fk.fact_ckpt_pair(px, lens32, fa, leaky_c, ck.chunks[k - 1],
                      (t0, ad_init, streams), ck.s_ys, ck.ad0, ck.s0, ck.tot,
                      ck.outs, ck.carry, smid=smid)
    torch.cuda.synchronize()
    sms = len(set(smid.tolist()))
    del ck
    print(f"# {label}: ckpt paired against unpaired, entries that differ "
          f"{diff}; one pair launch (chunk {k}'s backward beside chunk "
          f"{k - 1}'s replay) on {sms} distinct SMs for {2 * B} blocks",
          flush=True)
    check(sum(diff.values()) == 0 and bool((smid >= 0).all())
          and sms == 2 * B, f"{label}: paired ckpt {diff}, {sms} SMs")
    return sms


def plain_ckpt_pieces(px, lens64, fa, leaky_c, C, graph, alpha_dash, s_ys,
                      tot, probe=None):
    """The plain fast version of the ckpt mode's chunk scan
    (factorized.forward_backward_prob_ckpt's fast branch) on the first
    sweep's snapshots (alpha_dash[k C]), its replays and its chunk
    backwards timed apart.  ``probe``: a chunk whose replay streams are
    returned.  Returns (gamma (B, T, P), alpha_beta, gamma_sum, replay
    ms, backward ms, the probe chunk's (alpha' rows, W1 alpha' rows))."""
    from pychain_tpu_torch.ops import factorized as pf
    B, T, P = px.shape
    px_tm = px.permute(1, 2, 0)
    _, s0 = pf.initial_alpha(fa, leaky_c)
    carry = (torch.zeros((fa.s_pad, B), device=px.device),
             torch.zeros(B, device=px.device))
    n_chunks = -(-T // C)
    gammas, abs_, gss = [None] * n_chunks, [None] * n_chunks, \
        [None] * n_chunks
    fwd_ms = bwd_ms = 0.0
    probed = None
    for k in range(n_chunks - 1, -1, -1):
        t0, n = k * C, min(C, T - k * C)
        entry = pf._bf(alpha_dash[t0])
        s_init = s0.expand(B) if k == 0 else s_ys[:, t0 - 1]

        def replay():
            ad_c, w1_c = [entry], []
            for _, _, own, w1a, _, _ in pf._fast_frames(
                    px_tm, lens64, fa, leaky_c, graph, pf.block_sum, t0, n,
                    entry, s_init):
                ad_c.append(pf._bf(own))
                w1_c.append(pf._bf(w1a))
            return ad_c, w1_c

        (ad_c, w1_c), ms = event_ms(replay)
        fwd_ms += ms
        if k == probe:
            probed = (torch.stack(ad_c[1:]), torch.stack(w1_c))
        out, ms = event_ms(lambda: pf._fast_back(
            px_tm, lens64, fa, leaky_c, ad_c, w1_c, s_ys, tot, graph, None,
            t0, n, *carry))
        bwd_ms += ms
        gammas[k], abs_[k], gss[k] = (torch.stack(v, dim=i) for v, i in
                                      zip(out[:3], (0, 1, 1)))
        carry = out[3:]
    gamma = pf.gamma_batch_major(torch.cat(gammas, dim=0), P)
    return (gamma, torch.cat(abs_, dim=1), torch.cat(gss, dim=1), fwd_ms,
            bwd_ms, probed)


def bit_diff(got, ref, names=("objf", "gamma", "alpha_beta", "gamma_sum")):
    """Entries of each result field that differ (``got`` a FwdBwdResult;
    ``ref`` a FwdBwdResult or a dict of tensors)."""
    field = lambda r, k: r[k] if isinstance(r, dict) else getattr(r, k)
    return {k: int((field(got, k) != field(ref, k)).sum()) for k in names}


@contextlib.contextmanager
def ckpt_unpaired():
    """The ckpt mode's chunk scan unpaired (fact_fwd_init, then
    fact_bwd_chunk, at their plans), as before the pair kernel:
    fact_kernels.ckpt_paired stubbed to False."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    real = fk.ckpt_paired
    fk.ckpt_paired = lambda *args, **kw: False
    try:
        yield
    finally:
        fk.ckpt_paired = real


def mode_steps(label, x, lens, batch, leaky_c, counters):
    """Each stream mode's step on x (B, T, P), a leaf: through the user's
    entry point, chain_function, under "auto" with the card's budget
    ("full"), then with a budget of one stream ("lean") and of one byte
    ("ckpt" at the default C, its chunk scan paired where the plan takes
    the pair: B <= 66 on an H100), the same with the scan unpaired
    (:func:`ckpt_unpaired`: "ckpt unpaired"); then the ckpt mode forced at
    a chunk that does not divide T (stream_mode=, ckpt_chunk=, as
    forward_backward_prob_pallas's callers ask: clamp, exp and the
    kernels, as chain_function runs them, without autograd).  Every count
    0 before each mode's first step, read after it, and checked (the
    pair's roles too).  The paired ckpt step's peak over what was held
    exceeds the unpaired one's by at most one chunk's streams (its
    second set).  Returns {mode: objf, launches, roles, best ms (of 3
    after a warm-up), all ms, peak memory, the peak over what was held
    before}."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    fa = batch._fact
    B, T, _ = x.shape
    C = fk.ckpt_chunk_length(T)
    row = T * fa.s_pad * B * fk.stream_dtype(fa).itemsize
    lens_dev = lens.to(x.device)
    sfx = "_bf16" if fk.stream_dtype(fa) == torch.bfloat16 else ""
    odd = f"ckpt C={ODD_CHUNK}"
    paired = fk.ckpt_paired(B, torch.cuda.get_device_properties(x.device),
                            fa)

    def odd_step():
        with torch.no_grad():
            r = fk.forward_backward_prob_kernel(
                torch.exp(torch.clamp(x, -30.0, 30.0)), lens_dev, fa, leaky_c,
                debug=False, stream_mode="ckpt", ckpt_chunk=ODD_CHUNK)
        return float(r.objf.sum())

    steps = {"full": (None, "the card's"), "lean": (row, "one stream's"),
             "ckpt": (1, "one byte's"), "ckpt unpaired": (1, "one byte's")}
    stats = {}
    for mode in ("full", "lean", "ckpt", "ckpt unpaired", odd):
        if mode == odd:
            fn, how = odd_step, (f"stream_mode=\"ckpt\", ckpt_chunk="
                                 f"{ODD_CHUNK}, no autograd")
        else:
            stub, name = steps[mode]
            fn = functools.partial(den_step, x, lens, batch, stub)
            how = f"chain_function, auto under {name} budget"
        scope = ckpt_unpaired() if mode == "ckpt unpaired" else \
            contextlib.nullcontext()
        with scope:
            reset_counts(counters)
            fk.reset_launch_counts()
            objf = fn()
            launched, roles = fk.launched(), fk.roles_launched()
            best, times, peak, over = step_stats(fn)
        stats[mode] = {"objf": objf, "launches": launched, "roles": roles,
                       "ms": best, "all_ms": times, "peak": peak,
                       "over_held": over}
        print(f"# {label} {mode} ({how}): objf {objf!r}; launches "
              f"{launched}, the pair's roles {roles}; step ms {best:.3f} "
              f"(best of {[round(t, 3) for t in times]}, CUDA events); peak "
              f"device memory {peak / 1e9:.3f} GB, {over / 1e9:.3f} GB over "
              "what was held before the step", flush=True)
        n = -(-T // (ODD_CHUNK if mode == odd else C))
        pair = paired and mode != "ckpt unpaired"
        want = ({"fact_fwd": 1, "fact_bwd": 1} if mode == "full" else
                {"fact_fwd_snap": 1, "fact_bwd_lean": 1} if mode == "lean"
                else {"fact_fwd_snap": 1, "fact_ckpt_pair": n + 1} if pair
                else {"fact_fwd_snap": 1, "fact_fwd_init": n,
                      "fact_bwd_chunk": n})
        want = {k + sfx: v for k, v in want.items()}
        want_roles = ({f"fact_fwd_init{sfx}": n, f"fact_bwd_chunk{sfx}": n}
                      if pair and mode.startswith("ckpt") else {})
        check(launched == want and roles == want_roles,
              f"{label} {mode}: launches {launched}, roles {roles}, want "
              f"{want}, {want_roles}")
    # the second set of chunk streams: at most one chunk's more
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    chunk_bytes = n_streams * B * C * fa.s_pad * fk.stream_dtype(fa).itemsize
    more = stats["ckpt"]["over_held"] - stats["ckpt unpaired"]["over_held"]
    print(f"# {label}: ckpt paired {stats['ckpt']['ms']:.3f} ms against "
          f"unpaired {stats['ckpt unpaired']['ms']:.3f} ms a step; its peak "
          f"over what was held {more} bytes more (one chunk's streams: "
          f"{chunk_bytes})", flush=True)
    check(more <= chunk_bytes, f"{label}: the paired ckpt step holds {more} "
          f"bytes more than the unpaired, past one chunk's {chunk_bytes}")
    return stats


def cluster_plan(fa, B, P, dev, label):
    """Each form's cluster size for B columns on this card
    (fact_kernels.cluster_size), printed on a plan line with each
    form's shared memory a CTA and its ring.  Returns {form: C}."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    props = torch.cuda.get_device_properties(dev)
    forms = fk.FWD_FORMS + fk.BWD_FORMS
    plan = {f: fk.cluster_size(B, props, fa, f) for f in forms}
    smem = {f: fk.cluster_smem_bytes(fa, C, P=P)[f] for f, C in plan.items()}
    rings = {"fact_bwd": fk.ring_stages(fa, cluster=plan["fact_bwd"]),
             "fact_bwd_lean": fk.ring_stages(fa, lean=True)}
    px_ring = plan["fact_bwd_lean"] > 1 and fk.lean_px_ring(
        fa, rings["fact_bwd_lean"], P)
    print(f"# {label} plan: C CTAs a column (of 1024 threads) by form "
          f"{plan}: {B * max(plan.values())} CTAs on "
          f"{props.multi_processor_count} SMs; shared memory a CTA {smem} "
          f"B; rings {rings} stages, fact_bwd_lean's px rows in its ring "
          f"{px_ring} "
          f"(rule: the largest C of each form's {fk.PLAN_CLUSTERS} with "
          f"B C <= SMs whose CTA fits {props.shared_memory_per_block_optin}"
          " B)", flush=True)
    return plan


def smid_check(label, C, B, calls):
    """Run each of ``calls`` ({form: fn(smid)}: a launch at C CTAs a
    column recording each CTA's SM) and check that no cluster has two
    CTAs on one SM; prints the distinct SMs of each launch."""
    dev = torch.device("cuda")
    seen = {}
    for name, fn in calls.items():
        smid = torch.full((B * C,), -1, dtype=torch.int32, device=dev)
        fn(smid)
        rows = smid.view(B, C).cpu()
        seen[name] = (len(set(rows.flatten().tolist())),
                      sum(len(set(r.tolist())) == C for r in rows))
        check(bool((rows >= 0).all()) and seen[name][1] == B,
              f"{label}: {name} at C={C}: a cluster with two CTAs on one SM "
              f"({seen[name][1]} of {B} clusters on distinct SMs)")
    print(f"# {label}: %smid at C={C}: " + ", ".join(
        f"{k} {v[0]} distinct SMs for {B * C} CTAs, {v[1]} of {B} clusters "
        "on C distinct SMs" for k, v in seen.items()), flush=True)
    return seen


def smid_calls(fa, px, lens32, leaky_c, C, ckpt_chunk):
    """{form: fn(smid)}: one launch of each form at C CTAs a column (each
    backward form on its forward's streams at C), a ckpt chunk in the
    middle of the call for fact_fwd_init and fact_bwd_chunk."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, T, P = px.shape
    st = fk.fact_fwd(px, lens32, fa, leaky_c, cluster=C)
    tot = fk._objf(st[4], st[5], lens32, fa, st[7])[1].contiguous()
    ad1 = fk.fact_fwd_snap(px, lens32, fa, leaky_c, cluster=C)[0]
    t0 = (T // ckpt_chunk // 2) * ckpt_chunk
    chunk = [None if t is None else t[:, t0:t0 + ckpt_chunk].contiguous()
             for t in st[:4]]
    outs = fk._outputs(B, T, P, px.device)
    carry = (torch.zeros((B, fa.s_pad), device=px.device),
             torch.zeros(B, device=px.device))
    return {
        "fact_fwd": lambda smid: fk.fact_fwd(px, lens32, fa, leaky_c,
                                             cluster=C, smid=smid),
        "fact_bwd": lambda smid: fk.fact_bwd(
            lens32, fa, leaky_c, *st[:5], st[6], st[7], tot, P,
            cluster=C, smid=smid),
        "fact_fwd_snap": lambda smid: fk.fact_fwd_snap(
            px, lens32, fa, leaky_c, cluster=C, smid=smid),
        "fact_bwd_lean": lambda smid: fk.fact_bwd_lean(
            lens32, fa, leaky_c, ad1, px, st[4], st[6], st[7], tot,
            cluster=C, smid=smid),
        "fact_fwd_init": lambda smid: fk.fact_fwd_init(
            px, lens32, fa, leaky_c, t0, st[0][:, t0 - 1],
            st[4][:, t0 - 1].contiguous(), chunk, cluster=C, smid=smid),
        "fact_bwd_chunk": lambda smid: fk.fact_bwd_chunk(
            lens32, fa, leaky_c, chunk, st[4], st[6], st[7], tot, t0,
            st[0][:, t0 - 1], outs, carry, cluster=C, smid=smid)}


def sizes_ab(fns, sizes, reps=3):
    """Each of ``fns`` ({name: fn(size)}) at each size of ``sizes`` in one
    call, in turns (sizes, then reversed; CUDA events, the mean of reps
    calls, the best of its two turns), with the peak device memory of one
    call over what was held.  Returns {name: {size: (ms, peak over
    held)}}."""
    out = {}
    for name, fn in fns.items():
        got = {c: [] for c in sizes}
        for c in (*sizes, *reversed(sizes)):
            fn(c)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: fn(c), reps)
            got[c].append((ms, torch.cuda.max_memory_allocated() - held))
        out[name] = {c: min(v) for c, v in got.items()}
    return out


def cluster_ab(fa, px, lens32, leaky_c, C, ckpt_chunk, reps=3):
    """Every form at C = 1 and at C CTAs a column in one call, in turns
    (1, C, C, 1): fact_fwd and fact_bwd (full), the 58 (T / chunk)
    fact_fwd_init and fact_bwd_chunk launches of one ckpt call,
    fact_fwd_snap's lean sweep and snapshot sweep and fact_bwd_lean;
    and the denominator call of each mode (forward_backward_prob_kernel,
    no autograd) with every form at C = 1 and at its plan's size (keyed
    C); each the mean of reps calls, the best of its two turns, with the
    peak device memory of one call over what was held.  Returns {name:
    {1 or C: (ms, peak over held)}}."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, T, P = px.shape
    st = fk.fact_fwd(px, lens32, fa, leaky_c, cluster=1)
    tot = fk._objf(st[4], st[5], lens32, fa, st[7])[1].contiguous()
    ad1 = fk.fact_fwd_snap(px, lens32, fa, leaky_c, cluster=1)[0]
    replays, backwards, _ = chunk_runs(fa, px, lens32, leaky_c,
                                       ckpt_chunk)
    plan = lambda c: None if c == C else 1
    call = lambda mode: lambda c: fk.forward_backward_prob_kernel(
        px, lens32, fa, leaky_c, debug=False, stream_mode=mode,
        cluster=plan(c))
    calls = {
        "fact_fwd": lambda c: fk.fact_fwd(px, lens32, fa, leaky_c,
                                          cluster=c),
        "fact_bwd": lambda c: fk.fact_bwd(
            lens32, fa, leaky_c, *st[:5], st[6], st[7], tot, P,
            debug=False, cluster=c),
        "fact_fwd_init": replays,
        "fact_bwd_chunk": backwards,
        "fact_fwd_snap lean": lambda c: fk.fact_fwd_snap(
            px, lens32, fa, leaky_c, cluster=c),
        "fact_fwd_snap ckpt": lambda c: fk.fact_fwd_snap(
            px, lens32, fa, leaky_c, ckpt_chunk, cluster=c),
        "fact_bwd_lean": lambda c: fk.fact_bwd_lean(
            lens32, fa, leaky_c, ad1, px, st[4], st[6], st[7], tot,
            debug=False, cluster=c),
        "full call": call("full"), "lean call": call("lean"),
        "ckpt call": call("ckpt")}
    return sizes_ab(calls, (1, C), reps)


def long_fast(den, P, dev, leaky_c, counters):
    """Main path 7 at bench.py --long --big's width in the fast mode: see
    main_path_7.  Returns (per-mode stats, kernel rows' fields)."""
    from pychain_tpu_torch import ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import factorized as pf
    B, T = LONG_BIG
    t0 = time.perf_counter()
    batch = ChainGraphBatch(den, B, tile_dtype="bfloat16", device=dev)
    fa = batch._fact
    kg = fk.graph_for(fa)
    C = fk.ckpt_chunk_length(T)
    row = T * fa.s_pad * B * 2
    budget = fk.stream_budget(dev)
    auto = fk.resolve_stream_mode(T, B, fa, budget=budget, on_card=True)
    label = f"main path 7 (bench.py --long --big: B={B}, T={T}, bfloat16)"
    print(f"# {label}: S_pad={fa.s_pad} xsrc_mode={fa.xsrc_mode}, built in "
          f"{time.perf_counter() - t0:.1f} s; streams a call: full 3 x {row} "
          f"B, lean {row} B, ckpt {-(-T // C)} snapshots "
          f"({-(-T // C) * B * fa.s_pad * 2} B) and one chunk's 3 streams "
          f"({3 * C * fa.s_pad * B * 2} B) at C={C}; "
          f"the card's budget {budget} B: auto -> {auto} (the JAX package's "
          f"4 GiB -> {fk.resolve_stream_mode(T, B, fa)})", flush=True)
    check(auto == "full", f"{label}: auto chose {auto} under {budget} B")
    plan = cluster_plan(fa, B, P, dev, label)
    C7 = 2   # the cluster size the plan takes at B=64 on 132 SMs
    # fact_bwd's plan: the group form at G = 1 (one column a cluster of 2)
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        want_plan = {f: 1 if f in ("fact_bwd", "fact_bwd_chunk") else C7
                     for f in plan}
        check(plan == want_plan, f"{label}: the plan chose {plan} on 132 "
              f"SMs, want {want_plan}")
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(70), device=dev).requires_grad_(True)
    lens = torch.full((B,), T, dtype=torch.int32)
    lens32, lens64 = lens.to(dev), lens.to(dev).long()
    stats = mode_steps(label, x, lens, batch, leaky_c, counters)
    # every mode forced, for the comparisons
    px = torch.exp(torch.clamp(x.detach(), -30.0, 30.0))
    del x
    res = {}
    for key, mode, chunk in (("full", "full", None), ("lean", "lean", None),
                             ("ckpt", "ckpt", None),
                             (f"ckpt C={ODD_CHUNK}", "ckpt", ODD_CHUNK)):
        res[key] = fk.forward_backward_prob_kernel(
            px, lens32, fa, leaky_c, stream_mode=mode, ckpt_chunk=chunk)
        r = res[key]
        check(tuple(r.gamma.shape) == (B, T, P) and bool(r.ok.all())
              and bool(torch.isfinite(r.objf).all()),
              f"{label} {key}: shape {tuple(r.gamma.shape)}, ok "
              f"{int(r.ok.sum())}/{B}")
        if key != "full":
            stats[key]["vs_full"] = {
                "objf_rel": rel(r.objf, res["full"].objf),
                "gamma_abs": absmax(r.gamma, res["full"].gamma)}
    for key in ("lean", "ckpt", f"ckpt C={ODD_CHUNK}"):
        print(f"# {label} {key} against full: {stats[key]['vs_full']}",
              flush=True)
    # each kernel against its plain version, bit for bit
    graph = pf._fast_graph(fa)
    px_tm = px.permute(1, 2, 0)
    (alpha_dash, w1_alpha, s_plain, objf_p, tot_p), fwd_plain_ms = event_ms(
        lambda: pf.forward_prob_fast(px_tm, lens64, fa, leaky_c, graph))
    full_p, full_bwd_ms = event_ms(lambda: pf.backward_prob_fast(
        px_tm, lens64, fa, leaky_c, alpha_dash, w1_alpha, s_plain, tot_p,
        graph))
    del w1_alpha
    want_full = {"objf": objf_p,
                 "gamma": pf.gamma_batch_major(full_p[0], P),
                 "alpha_beta": full_p[1], "gamma_sum": full_p[2]}
    del full_p
    diffs = {"full": bit_diff(res["full"], want_full)}
    # the full pair at every C and ring depth at full width
    for cl, stages in ((1, None), (C7, None), (4, None), (C7, 0), (C7, 1)):
        r = fk.forward_backward_prob_kernel(
            px, lens32, fa, leaky_c, stream_mode="full", cluster=cl,
            stages=stages)
        diffs[f"full C={cl} stages={stages}"] = bit_diff(r, want_full)
        del r
    del want_full
    one_col = one_column_checks(label, fa, px, lens32, leaky_c)
    ad1, s1 = fk.fact_fwd_snap(px, lens32, fa, leaky_c)[:2]
    diffs["fact_fwd_snap lean"] = {
        "alpha'": int((ad1.float() != alpha_dash[1:].permute(2, 0, 1))
                      .sum()),
        "s_t": int((s1 != s_plain).sum())}
    del ad1
    lean_p, lean_bwd_ms = event_ms(lambda: pf.backward_prob_fast(
        px_tm, lens64, fa, leaky_c, alpha_dash, None, s_plain, tot_p, graph))
    want_lean = {"objf": objf_p, "gamma": pf.gamma_batch_major(lean_p[0], P),
                 "alpha_beta": lean_p[1], "gamma_sum": lean_p[2]}
    del lean_p
    diffs["lean"] = bit_diff(res["lean"], want_lean)
    # the lean pair at every C and ring depth at full width (the plan's C
    # at its own depth is res["lean"])
    for cl, stages in ((1, None), (4, None), (C7, 0), (C7, 1)):
        r = fk.forward_backward_prob_kernel(
            px, lens32, fa, leaky_c, stream_mode="lean", cluster=cl,
            stages=stages)
        diffs[f"lean C={cl} stages={stages}"] = bit_diff(r, want_lean)
        del r
    del want_lean
    smid_check(label, C7, B, smid_calls(fa, px, lens32, leaky_c, C7, C))
    snaps, s64 = fk.fact_fwd_snap(px, lens32, fa, leaky_c, C)[:2]
    (snaps_p, _, s64_p, _, _), snap_plain_ms = event_ms(
        lambda: pf.forward_prob_fast(px_tm, lens64, fa, leaky_c, graph,
                                     snap=C))
    n_chunks = -(-T // C)
    diffs["fact_fwd_snap ckpt"] = {
        "snapshots": int((snaps[:, :n_chunks - 1].float()
                          != snaps_p[1:].permute(2, 0, 1)).sum()),
        "s_t": int((s64 != s_plain).sum()) + int((s64_p != s_plain).sum()),
        "plain snapshots": int((snaps_p[1:] != alpha_dash[C::C][
            :n_chunks - 1]).sum())}
    del snaps_p
    probe = n_chunks // 2
    g, ab, gs, init_plain_ms, chunk_plain_ms, (ad_pr, w1_pr) = \
        plain_ckpt_pieces(px, lens64, fa, leaky_c, C, graph, alpha_dash,
                          s_plain, tot_p, probe=probe)
    want_ckpt = {"objf": objf_p, "gamma": g, "alpha_beta": ab,
                 "gamma_sum": gs}
    diffs["ckpt"] = bit_diff(res["ckpt"], want_ckpt)
    # the chunk that divides neither T: its plain scan from the same
    # sweep's snapshots (factorized.forward_backward_prob_ckpt's)
    odd = plain_ckpt_pieces(px, lens64, fa, leaky_c, ODD_CHUNK, graph,
                            alpha_dash, s_plain, tot_p)[:3]
    diffs[f"ckpt C={ODD_CHUNK}"] = bit_diff(res[f"ckpt C={ODD_CHUNK}"], dict(
        zip(("objf", "gamma", "alpha_beta", "gamma_sum"), (objf_p, *odd))))
    del odd
    # the ckpt mode with every form at each C
    for cl in (1, C7, 4):
        r = fk.forward_backward_prob_kernel(
            px, lens32, fa, leaky_c, stream_mode="ckpt", cluster=cl)
        diffs[f"ckpt C={cl}"] = bit_diff(r, want_ckpt)
        del r
    del g, ab, gs, alpha_dash, want_ckpt
    t0p, n = probe * C, min(C, T - probe * C)
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    streams = [torch.empty((B, n, fa.s_pad), dtype=torch.bfloat16,
                           device=dev) for _ in range(n_streams)]
    streams += [None] * (4 - n_streams)
    fk.fact_fwd_init(px, lens32, fa, leaky_c, t0p, snaps[:, probe - 1],
                     s_plain[:, t0p - 1].contiguous(), streams)
    diffs["fact_fwd_init"] = {
        f"chunk {probe} alpha'": int((streams[0].float()
                                      != ad_pr.permute(2, 0, 1)).sum()),
        f"chunk {probe} W1 alpha'": int((streams[1].float()
                                         != w1_pr.permute(2, 0, 1)).sum())}
    del streams, ad_pr, w1_pr, snaps
    print(f"# {label}: entries not bit-identical to the plain fast version "
          f"{diffs}", flush=True)
    check(all(v == 0 for d in diffs.values() for v in d.values()),
          f"{label}: a kernel differs from its plain version: {diffs}")
    pair_sms = pair_checks(label, fa, px, lens32, leaky_c, C, res["ckpt"])
    del res
    times = mode_kernel_times(fa, px, lens32, leaky_c, C)
    costs = mode_bytes_ops(fa, kg, lens32, T, P, C)
    plain = {"fact_fwd": fwd_plain_ms, "fact_bwd": full_bwd_ms,
             "fact_fwd_snap lean": fwd_plain_ms,
             "fact_bwd_lean": lean_bwd_ms,
             "fact_fwd_snap ckpt": snap_plain_ms,
             "fact_fwd_init": init_plain_ms,
             "fact_bwd_chunk": chunk_plain_ms,
             "fact_ckpt_pair": init_plain_ms + chunk_plain_ms}
    print(f"# {label} kernel ms (each alone, at its plan: fact_fwd "
          f"{tuple(one_col['fact_fwd']['plan'])}, fact_bwd "
          f"{tuple(one_col['fact_bwd']['plan'])}; init and chunk over the "
          "call's "
          f"{n_chunks} chunks, unpaired, and the paired scan's "
          f"{n_chunks + 1} launches): " + ", ".join(
              f"{k} {v:.3f} (bound {bound(*costs[k])[0]:.4f}, plain "
              f"{plain[k]:.1f})" for k, v in times.items()), flush=True)
    ab_c = cluster_ab(fa, px, lens32, leaky_c, C7, C, reps=1)
    print(f"# {label}: each form at C=1 and at C={C7}, each mode's call with "
          "every form at C=1 and at its plan's C, in one call, in turns "
          "(1, C, C, 1; CUDA events, one timed call a turn, the best; "
          "peak device "
          "memory of a call over what was held): " + ", ".join(
              f"{k} {v[1][0]:.3f} ms ({v[1][1] / 1e9:.3f} GB) -> "
              f"{v[C7][0]:.3f} ms ({v[C7][1] / 1e9:.3f} GB)"
              for k, v in ab_c.items()), flush=True)
    del px
    torch.cuda.empty_cache()
    rows = {k: {"ms": times[k], "plain_ms": plain[k],
                "bytes": costs[k][0], "ops": costs[k][1],
                "err": 0.0, "C": C, "n_chunks": n_chunks}
            for k in times}
    for k in rows:
        if k == "fact_ckpt_pair":
            rows[k].update({"cluster": 1, "pair_sms": pair_sms})
            continue
        rows[k].update({"cluster": plan[k.split()[0]],
                        "ab_ms": ab_c[k][C7][0], "c1_ms": ab_c[k][1][0],
                        "ab_cluster": C7,
                        "ab_peak_over_held": ab_c[k][C7][1],
                        "c1_peak_over_held": ab_c[k][1][1]})
    # the full pair runs its group form at G = 1: the plan's (G, C), its
    # time at it ("ms") beside one block a column's ("c1_ms") and, for
    # fact_fwd, the cluster form's at C7 ("cluster_form_ms", "ab_ms"), and
    # its SMs
    for k in ("fact_fwd", "fact_bwd"):
        o = one_col[k]
        rows[k].update({"cluster": o["plan"], "active_clusters": o["active"],
                        "smem": o["smem"], "plan_sms": o["sms"]})
    rows["fact_fwd"]["cluster_form_ms"] = ab_c["fact_fwd"][C7][0]
    print(f"# {label}: fact_fwd_bf16 at its plan "
          f"{tuple(one_col['fact_fwd']['plan'])} {times['fact_fwd']:.3f} ms "
          f"[the cluster form at C={C7} {ab_c['fact_fwd'][C7][0]:.3f}, one "
          f"block a column {ab_c['fact_fwd'][1][0]:.3f}]; fact_bwd_bf16 at "
          f"its plan {tuple(one_col['fact_bwd']['plan'])} "
          f"{times['fact_bwd']:.3f} ms [one block a column "
          f"{ab_c['fact_bwd'][1][0]:.3f}] in one call; {card_line()}",
          flush=True)
    for k in ("full call", "lean call", "ckpt call"):
        stats[k.split()[0]]["call_ab"] = {"c1_ms": ab_c[k][1][0],
                                          "plan_ms": ab_c[k][C7][0]}
    return stats, rows


def long_f32(den, P, dev, leaky_c, counters):
    """Main path 7's float32 part: the same graph at B=64 and a cut
    T=LONG_F32_T (the plain version's time), each mode's step
    (mode_steps), then each mode forced (stream_mode=) and held to the
    plain version within the parity bars (in float32 the three modes'
    plain versions are one function), the lean and ckpt results also
    compared with the full kernels' bit for bit (printed).  Returns
    (per-mode stats, kernel rows' fields)."""
    from pychain_tpu_torch import ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, T = LONG_BIG[0], LONG_F32_T
    batch = ChainGraphBatch(den, B, device=dev)
    fa = batch._fact
    kg = fk.graph_for(fa)
    C = fk.ckpt_chunk_length(T)
    label = f"main path 7 float32 (B={B}, T={T} cut from 3,700)"
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(71), device=dev).requires_grad_(True)
    steps = mode_steps(label, x, torch.full((B,), T, dtype=torch.int32),
                       batch, leaky_c, counters)
    px = torch.exp(torch.clamp(x.detach(), -30.0, 30.0))
    del x
    lens = torch.full((B,), T, device=dev)
    launches, errs, results = {}, {}, {}
    # in float32 every mode's plain version is one function: run it once
    ref = plain_for(fa, None)(px, lens, fa, leaky_c)
    for key, mode, chunk in (("full", "full", None), ("lean", "lean", None),
                             ("ckpt", "ckpt", None),
                             (f"ckpt C={ODD_CHUNK}", "ckpt", ODD_CHUNK)):
        reset_counts(counters)
        results[key] = fk.forward_backward_prob_kernel(
            px, lens, fa, leaky_c, stream_mode=mode, ckpt_chunk=chunk)
        torch.cuda.synchronize()
        launches[key] = fk.launched()
        errs[key] = compare(fa, px, lens, leaky_c, True, f"{label} {key}",
                            functools.partial(fk.forward_backward_prob_kernel,
                                              stream_mode=mode,
                                              ckpt_chunk=chunk), ref=ref)
    del ref
    # every form at the plan's C (B=64 on an H100: 2, fact_bwd and
    # fact_bwd_chunk 1), at C = 1 and at C = 2
    for mode in ("full", "lean", "ckpt"):
        for cl in (1, 2):
            results[f"{mode} C={cl}"] = fk.forward_backward_prob_kernel(
                px, lens, fa, leaky_c, stream_mode=mode, cluster=cl)
    # the ckpt mode's scan unpaired at its plan (the paired one: "ckpt")
    objf, outs = fk._ckpt(px, lens.int(), fa, leaky_c, True, None, C,
                          paired=False)
    results["ckpt unpaired"] = fk._package_result(objf, *outs)
    same = {k: bit_diff(results[k], results["full"])
            for k in results if k != "full"}
    print(f"# {label}: launches {launches}; entries that differ from the "
          f"full kernels' {same}", flush=True)
    check(all(v == 0 for d in same.values() for v in d.values()),
          f"{label}: float32 lean, ckpt or a cluster size not bit-identical "
          f"to full: {same}")
    check(launches["lean"] == {"fact_fwd_snap": 1, "fact_bwd_lean": 1}
          and launches["ckpt"] == {"fact_fwd_snap": 1,
                                   "fact_ckpt_pair": -(-T // C) + 1},
          f"{label}: launches {launches}")
    del results
    times = mode_kernel_times(fa, px, lens.int(), leaky_c, C)
    plain = pair_times(fa, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd, 1)
    costs = mode_bytes_ops(fa, kg, lens, T, P, C)
    fwd_err = max(errs[k]["objf_rel"] for k in errs)
    bwd_err = max(max(e["gamma_abs"], e["alpha_beta_abs"],
                      e["gamma_sum_abs"]) for e in errs.values())
    # each form ran at its plan's cluster size (fact_kernels.cluster_size)
    props = torch.cuda.get_device_properties(dev)
    rows = {}
    for k, ms in times.items():
        fwd = k.startswith("fact_fwd")
        pair = k == "fact_ckpt_pair"
        rows[k] = {"ms": ms, "plain_ms": (plain[2] + plain[3] if pair else
                                          plain[2 if fwd else 3]),
                   "bytes": costs[k][0], "ops": costs[k][1],
                   "err": max(fwd_err, bwd_err) if pair
                   else fwd_err if fwd else bwd_err, "C": C,
                   "n_chunks": -(-T // C)}
        rows[k]["cluster"] = 1 if pair else fk.cluster_size(
            B, props, fa, k.split()[0])
    print(f"# {label} kernel ms: " + ", ".join(
        f"{k} {v['ms']:.3f} (bound {bound(v['bytes'], v['ops'])[0]:.4f})"
        for k, v in rows.items()) + f"; plain fwd {plain[2]:.1f}, plain "
        f"bwd {plain[3]:.1f} (the plain version of every mode in float32)",
        flush=True)
    del px
    torch.cuda.empty_cache()
    return steps, rows


def long_auto(den, P, dev, leaky_c, counters):
    """bench.py --long (B=32, T=2,500, bfloat16 tiles) under "auto"
    through chain_function: the plan, the mode auto takes, the step's ms
    and peak memory, and the full pair bit for bit against the plain
    fast version (each sweep's plain time); fact_bwd_bf16's group form at
    G = 1 (one_column_checks); fact_fwd_bf16 and fact_bwd_bf16 at C = 1,
    2, 4 and their plans, and the full call at C = 1 and at the plan in
    turns.  Returns (stats, the pair's kernel rows' fields)."""
    from pychain_tpu_torch import ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import factorized as pf
    B, T = LONG
    batch = ChainGraphBatch(den, B, tile_dtype="bfloat16", device=dev)
    fa = batch._fact
    label = f"main path 7 (bench.py --long: B={B}, T={T}, bfloat16)"
    cluster_plan(fa, B, P, dev, label)
    auto = fk.resolve_stream_mode(T, B, fa, budget=fk.stream_budget(dev),
                                  on_card=True)
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(72), device=dev).requires_grad_(True)
    lens = torch.full((B,), T, dtype=torch.int32)
    reset_counts(counters)
    objf = den_step(x, lens, batch)
    launched = fk.launched()
    best, times, peak, over = step_stats(lambda: den_step(x, lens, batch))
    px = torch.exp(torch.clamp(x.detach(), -30.0, 30.0))
    del x
    lens32, lens64 = lens.to(dev), lens.to(dev).long()
    got = fk.forward_backward_prob_kernel(px, lens32, fa, leaky_c)
    graph = pf._fast_graph(fa)
    px_tm = px.permute(1, 2, 0)
    (alpha_dash, w1_alpha, s_plain, objf_p, tot_p), fwd_plain_ms = event_ms(
        lambda: pf.forward_prob_fast(px_tm, lens64, fa, leaky_c, graph))
    full_p, bwd_plain_ms = event_ms(lambda: pf.backward_prob_fast(
        px_tm, lens64, fa, leaky_c, alpha_dash, w1_alpha, s_plain, tot_p,
        graph))
    del alpha_dash, w1_alpha
    diff = bit_diff(got, {"objf": objf_p,
                          "gamma": pf.gamma_batch_major(full_p[0], P),
                          "alpha_beta": full_p[1], "gamma_sum": full_p[2]})
    ok_all = bool(got.ok.all())
    del full_p, got
    print(f"# {label}: auto -> {auto}; objf {objf!r}; launches {launched}; "
          f"step ms {best:.3f} (best of {[round(t, 3) for t in times]}); "
          f"peak device memory {peak / 1e9:.3f} GB, {over / 1e9:.3f} GB over "
          f"what was held; entries not bit-identical to the plain fast "
          f"version {diff}", flush=True)
    check(auto == "full" and launched == {"fact_fwd_bf16": 1,
                                          "fact_bwd_bf16": 1}
          and sum(diff.values()) == 0 and ok_all,
          f"{label}: auto {auto}, launches {launched}, diff {diff}")
    one_col = one_column_checks(label, fa, px, lens32, leaky_c)
    # each form's plan: the group form at G = 1
    plan = fk._mode_cluster("full", px, fa, None)
    st = fk.fact_fwd(px, lens32, fa, leaky_c, cluster=1)
    tot = fk._objf(st[4], st[5], lens32, fa, st[7])[1].contiguous()
    ab = {k: {c: v[0] for c, v in r.items()} for k, r in sizes_ab({
        "fact_fwd": lambda c: fk.fact_fwd(px, lens32, fa, leaky_c,
                                          cluster=c)},
        (1, 2, 4, plan["fact_fwd"])).items()}
    ab.update({k: {c: v[0] for c, v in r.items()} for k, r in sizes_ab({
        "fact_bwd": lambda c: fk.fact_bwd(
            lens32, fa, leaky_c, *st[:5], st[6], st[7], tot, P,
            debug=False, cluster=c)}, (1, 2, 4, plan["fact_bwd"])).items()})
    del st
    # 0: every form at its plan's size
    call = {c: v[0] for c, v in sizes_ab({
        "full call": lambda c: fk.forward_backward_prob_kernel(
            px, lens32, fa, leaky_c, debug=False, stream_mode="full",
            cluster=None if c == 0 else 1)}, (1, 0))["full call"].items()}
    print(f"# {label}: fact_fwd_bf16 at C = 1, 2, 4 and its plan "
          f"{plan['fact_fwd']}, fact_bwd_bf16 at C = 1, 2, 4 and its plan "
          f"{plan['fact_bwd']} in turns (ms): {ab}; the "
          f"full call with every form at C=1 {call[1]:.3f} ms, at the plan "
          f"{call[0]:.3f} ms; {card_line()}", flush=True)
    kg = fk.graph_for(fa)
    costs = mode_bytes_ops(fa, kg, lens32, T, P, fk.ckpt_chunk_length(T))
    plain = {"fact_fwd": fwd_plain_ms, "fact_bwd": bwd_plain_ms}
    rows = {k: {"ms": ab[k][plan[k]], "plain_ms": plain[k],
                "bytes": costs[k][0], "ops": costs[k][1], "err": 0.0,
                "cluster": (list(plan[k]) if isinstance(plan[k], tuple)
                            else plan[k]),
                "c1_ms": ab[k][1], "c2_ms": ab[k][2],
                "c4_ms": ab[k][4], "launches": launched[f"{k}_bf16"]}
            for k in ("fact_fwd", "fact_bwd")}
    for k in ("fact_fwd", "fact_bwd"):
        o = one_col[k]
        rows[k].update({"active_clusters": o["active"], "smem": o["smem"],
                        "plan_sms": o["sms"]})
    # the cluster form the plan replaced, in the same turns
    rows["fact_fwd"]["cluster_form_ms"] = ab["fact_fwd"][2]
    del px
    torch.cuda.empty_cache()
    return {"auto": auto, "objf": objf, "ms": best, "peak": peak,
            "over_held": over, "launches": launched,
            "call_c1_ms": call[1], "call_plan_ms": call[0]}, rows


def main_path_7(den, P, dev, leaky_c, counters):
    """Main path 7, long utterances: bench.py --long --big's
    configuration unchanged (the headline graph, B=64, T=3,700, all
    lengths T, bfloat16 tiles), its step the value and gradient of the
    denominator objective (bench.py:453-463)."""
    with timed_path("main path 7, B=64 T=3700 bfloat16"):
        stats, fast_rows = long_fast(den, P, dev, leaky_c, counters)
    with timed_path("main path 7, float32 at T=1000"):
        f32_stats, f32_rows = long_f32(den, P, dev, leaky_c, counters)
    with timed_path("main path 7, bench.py --long"):
        auto, long_rows = long_auto(den, P, dev, leaky_c, counters)
    return {"stats": stats, "fast_rows": fast_rows, "f32_stats": f32_stats,
            "f32_rows": f32_rows, "long": auto, "long_rows": long_rows}


# ----------------------------------------------------------------------
# Main path 5: training (bench.py --train's step)
# ----------------------------------------------------------------------

FEAT_DIM = 40      # bench.py:168
CKPT_DIR = ".chip_smoke_ckpt"   # under the checkout, gitignored, removed


@contextlib.contextmanager
def tf32(matmul, cudnn):
    """TF32 for float32 matmuls and cuDNN convolutions set as given, and
    restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def counts(counters):
    return {k: v for c in counters for k, v in c.items()}


def bn_stats(model):
    return [b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def model_step(model, opt, loss_fn, counters, after=None):
    """One training step (zero_grad, ``loss_fn(model)``: the train-mode
    forward and the loss, backward, Adam, then ``after(model)``), timed
    with CUDA events.  Returns (loss, ms, launches, gradients finite,
    BN running statistics moved: None without BatchNorm)."""
    before, stats = counts(counters), bn_stats(model)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    finite = torch.stack([torch.isfinite(p.grad).all() for p in
                          model.parameters() if p.requires_grad]).all()
    opt.step()
    if after is not None:
        after(model)
    end.record()
    torch.cuda.synchronize()
    moved = (all(not torch.equal(a, b) for a, b in zip(stats,
                                                       bn_stats(model)))
             if stats else None)
    return (float(loss.detach()), start.elapsed_time(end),
            {k: v - before[k] for k, v in counts(counters).items()},
            bool(finite), moved)


def model_steps(label, model, opt, loss_fn, counters, want, n=3,
                after=None):
    """``n`` training steps, each with a finite loss and gradients, BN
    running statistics that moved (where the model has BatchNorm) and
    exactly the launches ``want``; the last loss below the first.
    Returns (losses, step ms, launches summed over the steps)."""
    losses, step_ms, total = [], [], dict.fromkeys(want, 0)
    for step in range(n):
        loss, ms, launched, finite, moved = model_step(model, opt, loss_fn,
                                                       counters, after)
        losses.append(loss)
        step_ms.append(ms)
        check(np.isfinite(loss) and finite, f"{label} step {step}: loss "
              f"{loss}, gradients finite: {finite}")
        check(moved is not False, f"{label} step {step}: the BatchNorm "
              "running statistics did not move")
        check(launched == want, f"{label} step {step} launches {launched}"
              f", want {want}")
        for k, v in launched.items():
            total[k] += v
    print(f"# {label}: losses {losses}; step ms {step_ms} (the first step "
          f"warms up); launches per step {want}", flush=True)
    if n > 1:
        check(losses[-1] < losses[0], f"{label}: loss did not fall: "
              f"{losses}")
    return losses, step_ms, total


def profiled_train_step(model, opt, loss_mod, feats, lengths, nums, label,
                        **kw):
    """Where one training step's device time goes: each part of the step
    runs in its own profiler range, closed by a synchronize, and each
    kernel counts for the part it ran in (B1/B2 by name)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    parts = ("model forward", "loss forward", "loss backward",
             "model backward", "adam")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.zero_grad(set_to_none=True)
        with record_function(parts[0]):
            out = model(feats, True, **kw)
            torch.cuda.synchronize()
        with record_function(parts[1]):
            loss = loss_mod(out, lengths, nums)
            torch.cuda.synchronize()
        with record_function(parts[2]):
            (g,) = torch.autograd.grad(loss, out)
            torch.cuda.synchronize()
        with record_function(parts[3]):
            out.backward(g)
            torch.cuda.synchronize()
        with record_function(parts[4]):
            opt.step()
            torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in events if e.name in parts
              and e.device_type.name == "CPU"}
    split = dict.fromkeys(("model", "B1/B2 fast", "glue", "adam",
                           "outside the parts"), 0.0)
    model_kernels = {}
    for e in events:
        if e.device_type.name != "CUDA" or e.name in parts:
            continue
        part = next((p for p, (a, b) in ranges.items()
                     if a <= e.time_range.start <= b), None)
        key = ("B1/B2 fast" if "fact_" in e.name else
               "model" if part in (parts[0], parts[3]) else
               "glue" if part in (parts[1], parts[2]) else
               "adam" if part == parts[4] else "outside the parts")
        ms = e.time_range.elapsed_us() / 1e3
        split[key] += ms
        if key == "model":
            name = f"{part[6:]}: {e.name[:70]}"
            model_kernels[name] = model_kernels.get(name, 0.0) + ms
    busy = sum(split.values())
    print(f"# profiled step, {label}: device busy {busy:.3f} ms: " +
          ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) +
          "; the model's largest kernels (ms):", flush=True)
    for name, ms in sorted(model_kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"#   {ms:9.3f}  {name}")
    return busy, split


def linear_batch(P, lengths, seed, dev):
    """Linear numerators over random pdfs, one of each length."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.utils.testgraphs import linear_fst
    rng = np.random.RandomState(seed)
    T = int(max(lengths))
    return ChainGraphBatch(
        [ChainGraph(linear_fst(rng.randint(0, P, size=int(n))),
                    log_domain=True) for n in lengths],
        max_num_transitions=T, max_num_states=T + 1, device=dev)


def model_vs_cpu(den, cfg, state, feats, P):
    """The card's TDNN train-mode forward and backward against the
    port's CPU plain path at B=4 on the same weights and features, with
    TF32 off: the float32 loss within 1e-4 relative, every parameter
    gradient within 1e-3 of its norm, the updated BatchNorm statistics
    within 1e-5."""
    from pychain_tpu_torch import ChainLoss
    from pychain_tpu_torch.models import TDNN
    B4, T = 4, feats.shape[1]
    lengths = torch.full((B4,), T, dtype=torch.int32)
    got = []
    with tf32(False, False):
        for dev in (feats.device, torch.device("cpu")):
            model = TDNN(cfg, FEAT_DIM, device=dev)
            model.load_state_dict(state)
            loss = ChainLoss(den, device=dev)(
                model(feats[:B4].to(dev), True), lengths,
                linear_batch(P, [T] * B4, 17, dev))
            loss.backward()
            got.append((float(loss.detach()),
                        {n: p.grad.cpu() for n, p in
                         model.named_parameters()},
                        {n: b.cpu() for n, b in model.named_buffers()}))
    (lc, gc, bc), (lp, gp, bp) = got
    loss_rel = abs(lc - lp) / abs(lp)
    grad_rel, worst_grad = max(
        (float((gc[n] - gp[n]).norm() / gp[n].norm()), n) for n in gp)
    bn_abs = max(float((bc[n] - bp[n]).abs().max()) for n in bp)
    print(f"# main path 5, the card against the CPU (TDNN-512x5, B=4, "
          f"T={T}, float32 loss, TF32 off): loss {lc!r} / {lp!r}, relative "
          f"{loss_rel:.3e} (at most 1e-4); worst gradient "
          f"|d| / |g| {grad_rel:.3e} ({worst_grad}; at most 1e-3); "
          f"BatchNorm statistics "
          f"{bn_abs:.3e} (1e-5)", flush=True)
    check(loss_rel <= 1e-4 and grad_rel <= 1e-3 and bn_abs <= 1e-5,
          "main path 5: the card's model disagrees with the CPU's")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "bn_abs": bn_abs}


def checkpoint_round_trip(model, opt, cfg, loss_fn, counters, want):
    """Save the model and Adam after step 3, restore them into a fresh
    model and a fresh Adam on the card: every tensor equal; then one
    more step of each: the losses within 1e-6 relative.  Returns
    whether the two steps' gradients and updated weights were bit for
    bit equal (cuDNN's weight-gradient algorithms need not be
    deterministic)."""
    import shutil
    from pychain_tpu_torch.models import TDNN
    from pychain_tpu_torch.utils.checkpoint import (latest_step,
                                                    restore_checkpoint,
                                                    save_checkpoint)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CKPT_DIR)
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save_checkpoint(path, 3, {"model": model.state_dict(),
                                  "opt": opt.state_dict()})
        save_s = time.perf_counter() - t0
        fresh = TDNN(cfg, FEAT_DIM, generator=torch.Generator()
                     .manual_seed(99))
        fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
        t0 = time.perf_counter()
        step, state = restore_checkpoint(
            path, {"model": fresh.state_dict(),
                   "opt": fresh_opt.state_dict()})
        fresh.load_state_dict(state["model"])
        fresh_opt.load_state_dict(state["opt"])
        load_s = time.perf_counter() - t0
        check(step == 3 == latest_step(path), f"checkpoint step {step}")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    check(all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values())),
        "checkpoint: the restored model differs from the saved one")
    saved, restored = opt.state_dict(), fresh_opt.state_dict()
    check(saved["state"].keys() == restored["state"].keys() and all(
        torch.equal(v.cpu(), restored["state"][i][k].cpu())
        for i, s in saved["state"].items() for k, v in s.items()),
        "checkpoint: the restored Adam state differs from the saved one")
    check(saved["param_groups"] == restored["param_groups"],
          "checkpoint: the restored Adam settings differ")
    check(all(a.device == b.device for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values())),
        "checkpoint: the restored model is not on the card")
    grads, after = [], []
    losses = []
    for m, o in ((model, opt), (fresh, fresh_opt)):
        loss, _, launched, finite, _ = model_step(m, o, loss_fn, counters)
        check(finite and launched == want, f"checkpoint step: launches "
              f"{launched}, gradients finite: {finite}")
        losses.append(loss)
        grads.append([p.grad.clone() for p in m.parameters()])
        after.append([p.detach().clone() for p in m.parameters()])
    rel_d = abs(losses[0] - losses[1]) / abs(losses[0])
    grads_equal = all(torch.equal(a, b) for a, b in zip(*grads))
    weights_equal = all(torch.equal(a, b) for a, b in zip(*after))
    print(f"# main path 5 checkpoint: saved in {save_s:.3f} s, restored "
          f"in {load_s:.3f} s, every tensor equal; step 4 loss "
          f"{losses[0]!r} / restored {losses[1]!r} (relative {rel_d:.3e}, "
          f"at most 1e-6); step 4 gradients bit-identical: {grads_equal}, "
          f"weights after it: {weights_equal}", flush=True)
    check(rel_d <= 1e-6, "checkpoint: the restored step's loss differs")
    return {"loss_rel": rel_d, "grads_equal": grads_equal,
            "weights_equal": weights_equal}


def main_path_5(den, fast_loss, f32_loss, B, T, P, dev, counters,
                tf32_defaults):
    """Main path 5, training: bench.py --train's step (TDNN-512x5,
    FEAT_DIM 40, B=128, T=500, linear numerators, ChainLoss(den,
    precision="fast"), train-mode BatchNorm, Adam at 1e-3) through the
    port's public pieces, with PyTorch's TF32 defaults; then the same
    step in float32, TDNN-F and BLSTM steps, a chain_loss_xent step and
    the checkpoint round trip.  Returns the path's launches (set to 0
    just before, read just after), the TDNN step's ms and the rest of
    what the summary prints."""
    from pychain_tpu_torch import chain_loss_xent
    from pychain_tpu_torch.models import (BLSTM, BLSTMConfig, TDNN,
                                          TDNNConfig, TDNNF, TDNNFConfig,
                                          constrain_semi_orthogonal,
                                          semi_orthogonal_deviation)
    out = {}
    cfg = TDNNConfig(num_pdfs=P, hidden_dim=512, kernel_sizes=(3,) * 5,
                     dilations=(1, 1, 3, 3, 3), strides=(1,) * 5,
                     dropout=0.0)
    feats = torch.randn(B, T, FEAT_DIM, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    lengths = torch.full((B,), T, dtype=torch.int32)
    nums = linear_batch(P, [T] * B, 18, dev)
    fast_want = {k: 0 for c in counters for k in c}
    fast_want.update(fact_fwd_bf16=1, fact_bwd_bf16=1)
    f32_want = {k: 0 for c in counters for k in c}
    f32_want.update(fact_fwd=1, fact_bwd=1)

    def fast_step(m):
        return fast_loss(m(feats, True), lengths, nums)

    with tf32(*tf32_defaults):
        model = TDNN(cfg, FEAT_DIM,
                     generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        mm, cd = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        print(f"# main path 5 (bench.py --train: TDNN-512x5, "
              f"{sum(p.numel() for p in model.parameters())} parameters, "
              f"B={B}, T={T}, P={P}, fast denominator, Adam 1e-3); TF32 "
              f"(PyTorch's defaults, left as they are): matmul {mm}, cuDNN "
              f"{cd}, so the convolutions run in "
              f"{'TF32' if cd else 'float32'} and the classifier in "
              f"{'TF32' if mm else 'float32'}", flush=True)
        for c in counters:
            for k in c:
                c[k] = 0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, step_ms, launched = model_steps(
            "main path 5 (TDNN-512x5, fast denominator)", model, opt,
            fast_step, counters, fast_want)
        peak = torch.cuda.max_memory_allocated()
        out.update(step_ms=step_ms[-1], losses=losses,
                   utts_s=B / (step_ms[-1] / 1e3),
                   peak_gb=peak / 1e9, peak_over_gb=(peak - base) / 1e9)
        print(f"# main path 5: step {step_ms[-1]:.3f} ms (timed after the "
              f"warm-up step), {out['utts_s']:.1f} utts/s; peak device "
              f"memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB "
              f"over the {base / 1e9:.2f} GB held before the path); "
              f"{card_line()}", flush=True)
        # the same step in float32, on the initial weights
        model32 = TDNN(cfg, FEAT_DIM)
        model32.load_state_dict(initial)
        opt32 = torch.optim.Adam(model32.parameters(), lr=1e-3)
        loss32, ms32, got32, finite32, moved32 = model_step(
            model32, opt32, lambda m: f32_loss(m(feats, True), lengths, nums),
            counters)
        rel32 = abs(loss32 - losses[0]) / abs(loss32)
        print(f"# main path 5 in float32 (precision=\"parity\"): loss "
              f"{loss32!r} against the fast step's {losses[0]!r}, relative "
              f"{rel32:.3e} (JAX bfloat16 budget {BF16_BUDGET['objf_rel']}); "
              f"step {ms32:.3f} ms", flush=True)
        check(finite32 and moved32 and got32 == f32_want and
              rel32 <= BF16_BUDGET["objf_rel"],
              f"main path 5 float32 step: launches {got32}, finite "
              f"{finite32}, relative {rel32}")
        for k, v in got32.items():
            launched[k] += v
        out.update(f32_step_ms=ms32, f32_rel=rel32)
        del model32, opt32

        # chain_loss_xent, the same tensor feeding both heads
        def xent_step(m):
            o = m(feats, True)
            return chain_loss_xent(o, o, lengths, nums,
                                   fast_loss.den_batch(B),
                                   xent_regularize=0.1, l2_regularize=0.01)[0]
        xent_model = TDNN(cfg, FEAT_DIM)
        xl, _, xs = model_steps(
            "main path 5 chain_loss_xent (xent 0.1, l2 0.01)", xent_model,
            torch.optim.Adam(xent_model.parameters(), lr=1e-3), xent_step,
            counters, fast_want, n=1)
        del xent_model
        out["ckpt"] = checkpoint_round_trip(model, opt, cfg, fast_step,
                                            counters, fast_want)
        for d in (xs, fast_want, fast_want):
            for k, v in d.items():
                launched[k] += v

        # TDNN-F at its default width, the constraint after each step
        fcfg = TDNNFConfig(num_pdfs=P)
        tdnnf = TDNNF(fcfg, FEAT_DIM)
        dev0 = semi_orthogonal_deviation(tdnnf)
        fl, fms, fs = model_steps(
            "main path 5 TDNN-F (512/128 x 6, constrain_semi_orthogonal "
            "after each step)", tdnnf,
            torch.optim.Adam(tdnnf.parameters(), lr=1e-3), fast_step,
            counters, fast_want, after=constrain_semi_orthogonal)
        dev1 = semi_orthogonal_deviation(tdnnf)
        print(f"# main path 5 TDNN-F: semi-orthogonal deviation {dev0:.6f} "
              f"before, {dev1:.6f} after", flush=True)
        check(dev1 <= dev0, "TDNN-F: the semi-orthogonal deviation grew")
        del tdnnf
        # the BLSTM at its default width, unequal lengths
        rng = np.random.RandomState(19)
        blens = rng.randint(T // 2, T + 1, size=B)
        blens[0] = T
        bnums = linear_batch(P, blens, 20, dev)
        blens_t = torch.as_tensor(blens, dtype=torch.int32)
        blstm = BLSTM(BLSTMConfig(num_pdfs=P, dropout=0.0), FEAT_DIM)
        bl, bms, bs = model_steps(
            f"main path 5 BLSTM (512 x 3 bidirectional, lengths "
            f"{blens.min()}..{blens.max()})", blstm,
            torch.optim.Adam(blstm.parameters(), lr=1e-3),
            lambda m: fast_loss(m(feats, True, lengths=blens_t), blens_t,
                                bnums), counters, fast_want)
        read = counts(counters)
        for d in (fs, bs):
            for k, v in d.items():
                launched[k] += v
        check(read == launched, f"main path 5: counted {read}, the steps "
              f"{launched}")
        out.update(tdnnf_ms=fms[-1], blstm_ms=bms[-1], xent_loss=xl[0],
                   deviation=(dev0, dev1), launches=read)
        del blstm
        # not counted: the profiled split and the comparison with the CPU
        out["busy"], out["split"] = profiled_train_step(
            model, opt, fast_loss, feats, lengths, nums,
            "main path 5 (TDNN-512x5, fast denominator, Adam)")
        torch.cuda.synchronize()
    out["vs_cpu"] = model_vs_cpu(den, cfg, initial, feats, P)
    del model, opt, feats, nums
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# The semiring kernels
# ----------------------------------------------------------------------

# (class, TPU kernels the class runs in the JAX package: fwd, bwd)
SR_CLASSES = {
    "semiring": ("pychain_tpu/ops/pallas_semiring.py:132",
                 "pychain_tpu/ops/pallas_semiring.py:231"),
    "xl": ("pychain_tpu/ops/semiring_xl.py:273",
           "pychain_tpu/ops/semiring_xl.py:369"),
    "xlstream": ("pychain_tpu/ops/semiring_xl.py:462",
                 "pychain_tpu/ops/semiring_xl.py:557"),
}


def size_class(batch_size, max_k, max_s):
    """Which TPU kernel pair the JAX package gives a list batch on a TPU:
    "semiring" (B5/B6) within the dense one-hot budget (semiring.py:43)
    and the Pallas one-hot VMEM rule (pallas_semiring.py:69-79), "xl"
    (B7/B8) within the resident mask budget (semiring_xl.py:67,97-102),
    else "xlstream" (B9/B10).  The port runs every class on the same two
    kernels; this only names the class."""
    s8 = (max_s + 7) // 8 * 8
    if (batch_size * max_k * max_s <= 1 << 26
            and 2 * max_k * s8 * 128 * 4 <= 48 * 1024 * 1024):
        return "semiring"
    if 2 * s8 * ((max_k + 127) // 128 * 128) * 2 <= 60 * 1024 * 1024:
        return "xl"
    return "xlstream"


def list_batch(fsts, dev, pad=None):
    """A log-domain list batch of ``fsts``, padded to ``pad`` = (K, S) or
    to the largest graph, and the host milliseconds its constructor took
    (the arc-id arrays and lists, rebuilt every minibatch in training)."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    graphs = [ChainGraph(f, log_domain=True) for f in fsts]
    K, S = pad or (max(g.num_transitions for g in graphs),
                   max(g.num_states for g in graphs))
    t0 = time.perf_counter()
    batch = ChainGraphBatch(graphs, max_num_transitions=K,
                            max_num_states=S, device=dev)
    return batch, (time.perf_counter() - t0) * 1e3


def sr_compare(g, x, lens, label, want_ok=None):
    """Semiring kernels vs plain version on the same inputs; errors."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import forward_backward_semiring
    got = sk.forward_backward_semiring_kernel(x, lens, g)
    ref = forward_backward_semiring(x, lens, g)
    torch.cuda.synchronize()
    live = torch.isfinite(ref.objf)
    check(torch.equal(live, torch.isfinite(got.objf)),
          f"{label}: finite objf {got.objf.tolist()} vs {ref.objf.tolist()}")
    check(torch.equal(got.ok, ref.ok), f"{label}: ok {got.ok.tolist()} "
          f"vs plain {ref.ok.tolist()}")
    if want_ok is not None:
        check(got.ok.tolist() == want_ok, f"{label}: ok {got.ok.tolist()}, "
              f"want {want_ok}")
    errs = {"objf_rel": rel(got.objf[live], ref.objf[live]),
            "gamma_abs": absmax(got.gamma, ref.gamma),
            "alpha_beta_abs": absmax(got.alpha_beta, ref.alpha_beta),
            "gamma_sum_abs": absmax(got.gamma_sum, ref.gamma_sum)}
    print(f"# {label}: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()),
          flush=True)
    for k, v in errs.items():
        check(v <= TOL, f"{label}: {k}={v:.3e} > {TOL}")
    dead = ~live
    check(bool((got.gamma[dead] == 0).all()), f"{label}: nonzero gamma of "
          "an infeasible sequence")
    return errs


def sr_sweeps(g, x, lens):
    """The glue and both kernels once: what the timing phases rerun."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import objective, prepare
    lens32 = lens.int()
    warc, c, n0, lz0 = prepare(x, g, row_align=sk.WARC_ALIGN)
    n_ys, raw, n_last = sk.semiring_fwd(warc, n0, lens32, g)
    rows = objective(raw, n_last, c, lz0, lens32, g)[1:]
    return lens32, warc, n0, (n_ys, raw, n_last), rows


def sr_alpha_err(g, x, lens):
    """Forward kernel alone: its alpha stream and raw sums against the
    plain forward sweep on frames before each sequence's end."""
    from pychain_tpu_torch.ops.semiring import forward_plain
    _, warc, n0, (n_ys, raw, _), _ = sr_sweeps(g, x, lens)
    ref_n, ref_raw = forward_plain(warc, n0, g)
    live = torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]
    err_n = float(((n_ys - ref_n).abs().amax(dim=2) * live).nan_to_num(
        nan=0.0).max())
    err_raw = float(((raw - ref_raw).abs() / ref_raw.abs().clamp(min=1e-30)
                     * live).max())
    return max(err_n, err_raw)


def bit_identical_gamma(g, x, lens, label):
    from pychain_tpu_torch.ops import semiring_kernels as sk
    lens32, warc, n0, (n_ys, _, _), rows = sr_sweeps(g, x, lens)
    P = x.shape[2]
    g1, ab1 = sk.semiring_bwd(warc, n_ys, n0, lens32, *rows, g, P)
    g2, ab2 = sk.semiring_bwd(warc, n_ys, n0, lens32, *rows, g, P)
    torch.cuda.synchronize()
    check(torch.equal(g1, g2) and torch.equal(ab1, ab2),
          f"{label}: two backward runs differ")
    print(f"# {label}: gamma bit-identical over two backward runs")


def sr_class(name, g, x, lens, reps, label=None, feasible=True):
    """One size class (or, ``label``, one main path's batch of that
    class) of semiring arrays ``g``: errors, kernel and plain times,
    bytes and ops, the layouts.  ``feasible``: every sequence must be
    (else the kernel's ok flags need only equal the plain version's)."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import backward_plain, forward_plain
    B, T, P = x.shape
    label = label or f"class {name}"
    check(size_class(B, g.k_pad, g.num_states) == name,
          f"{label}: B={B} K={g.k_pad} S={g.num_states} is "
          f"{size_class(B, g.k_pad, g.num_states)!r} in the JAX package, "
          f"not {name!r}")
    layouts = sk.layouts(g, P)
    print(f"# {label}: layouts {layouts}", flush=True)
    errs = sr_compare(g, x, lens, label,
                      want_ok=[True] * B if feasible else None)
    a_err = sr_alpha_err(g, x, lens)
    print(f"# {label}: alpha stream / raw sums err {a_err:.3e}")
    check(a_err <= TOL, f"{label}: alpha stream err {a_err:.3e}")
    lens32, warc, n0, (n_ys, raw, n_last), rows = sr_sweeps(g, x, lens)
    fwd_ms = cuda_ms(lambda: sk.semiring_fwd(warc, n0, lens32, g), reps)
    bwd_ms = cuda_ms(lambda: sk.semiring_bwd(warc, n_ys, n0, lens32, *rows,
                                             g, P), reps)
    with torch.no_grad():
        pn, _ = forward_plain(warc, n0, g)
        plain_fwd_ms = cuda_ms(lambda: forward_plain(warc, n0, g), 1)
        plain_bwd_ms = cuda_ms(lambda: backward_plain(
            warc, pn, n0, lens32, *rows, g, P), 1)
    del pn, n_ys, warc
    # what this run's data needs: frames t < T_b, each graph's own arcs
    # and states (those its arcs touch), 4 bytes a value: a float32 log
    # alpha stream keeps the range the backward needs (it takes alpha's
    # log), so the kernels' float64 stream is their design's choice, not
    # the function's need.  gamma and the trace are written whole.
    lens_l = lens.long()
    real = g.src < g.num_states
    n_arcs = real.sum(dim=1)
    n_states = torch.where(real, torch.maximum(g.src, g.dst),
                           torch.full_like(g.src, -1)).amax(dim=1) + 1
    L = int(lens_l.sum())
    arc_frames = int((lens_l * n_arcs).sum())
    state_frames = int((lens_l * n_states).sum())
    sum_k, sum_s = int(n_arcs.sum()), int(n_states.sum())
    # warc read, alpha stream and raw sums written, n0 read and alpha(T_b)
    # written, src and dst ids read
    fwd_bytes = (4 * arc_frames + 4 * state_frames + 4 * L + 8 * sum_s
                 + 8 * sum_k)
    fwd_ops = 2 * arc_frames + 3 * state_frames
    # warc and the alpha stream read, gamma and the trace written, c_row
    # and cms read for live frames, n0, rf and mf read, src, dst and pdf
    # ids read
    bwd_bytes = (4 * arc_frames + 4 * state_frames + 4 * B * T * P
                 + 4 * B * T + 8 * L + 8 * sum_s + 4 * B + 12 * sum_k)
    bwd_ops = 5 * arc_frames + 4 * state_frames
    print(f"# {label}: B={B} T={T} K_pad={g.k_pad} "
          f"S_pad={g.num_states} P={P} arcs {int(n_arcs.min())}.."
          f"{int(n_arcs.max())} states {int(n_states.min())}.."
          f"{int(n_states.max())}; semiring_fwd "
          f"{fwd_ms:.3f} ms, semiring_bwd {bwd_ms:.3f} ms; plain fwd "
          f"{plain_fwd_ms:.1f} ms, plain bwd {plain_bwd_ms:.1f} ms",
          flush=True)
    return {"class": name, "layouts": layouts,
            "fwd": (fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops,
                    max(errs["objf_rel"], a_err)),
            "bwd": (bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops,
                    max(errs["gamma_abs"], errs["alpha_beta_abs"],
                        errs["gamma_sum_abs"]))}


def flat_start_phones(B, num_phones, n_lo, n_hi, seed):
    """B transcripts of N_b phones drawn uniformly from n_lo..n_hi, phone
    ids from 0..num_phones-1."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, num_phones, size=n)
            for n in rng.randint(n_lo, n_hi + 1, size=B)]


def flat_start_fsts(B, num_phones, n_lo, n_hi, seed):
    """The flat-start numerators (make_numerator_fst, lm=None) of
    :func:`flat_start_phones`."""
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  make_numerator_fst)
    topo = ChainTopology(num_phones=num_phones)
    return [make_numerator_fst(p, topo) for p in
            flat_start_phones(B, num_phones, n_lo, n_hi, seed)]


def want_launches(counters, **ones):
    """Every count of ``counters`` 0 but those given."""
    want = {k: 0 for c in counters for k in c}
    want.update(ones)
    return want


def train_steps(loss_mod, x, x_lengths, nums, counters, want, label,
                reset=True):
    """Three SGD steps with every launch count set to 0 just before
    (unless the caller did so before more work of its path) and read just
    after; returns (losses, step_ms, launches)."""
    lr = 0.1 * float(x_lengths.sum())
    losses, step_ms, per_step = [], [], []
    for c in counters if reset else ():
        for k in c:
            c[k] = 0
    for step in range(3):
        before = {k: v for c in counters for k, v in c.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = loss_mod(x, x_lengths, nums)
        loss.backward()
        with torch.no_grad():
            grad_ok = torch.isfinite(x.grad).all()
            x -= lr * x.grad
        x.grad = None
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss.detach()))
        per_step.append({k: v - before[k] for c in counters
                         for k, v in c.items()})
        check(bool(grad_ok), f"{label} step {step}: non-finite gradient")
    launches = {k: v for c in counters for k, v in c.items()}
    print(f"# {label}: losses {losses}; step ms {step_ms} (the first "
          f"step may build batches); launches per step {per_step}",
          flush=True)
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    check(losses[0] > losses[1] > losses[2],
          f"{label}: loss did not fall: {losses}")
    for step, n in enumerate(per_step):
        check(n == want, f"{label} step {step} launches {n}, want {want}")
    return losses, step_ms, launches


def profiled_step(loss_mod, x, x_lengths, nums, label):
    """Where one step's device time goes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss = loss_mod(x, x_lengths, nums)
        loss.backward()
        x.grad = None
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    busy_us = sum(e.device_time_total for e in events)
    print(f"# profiled step, {label}: device busy {busy_us / 1e3:.3f} ms "
          f"over {len(events)} kernel names; top kernels (ms, calls):")
    for e in events[:14]:
        print(f"#   {e.device_time_total / 1e3:9.3f} {e.count:4d}  "
              f"{e.key[:90]}")


# ----------------------------------------------------------------------
# The Viterbi kernel
# ----------------------------------------------------------------------

def vit_compare(g, x, lens, label, want_ok=None):
    """Viterbi kernel vs plain version on the same x (each clamps it as
    it reads it): objf, pdfs, states and ok must be bit-identical (the
    kernel adds float32 in the plain version's order and compares).  Returns the number of
    mismatching entries (0) and the largest objf difference (0.0)."""
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    from pychain_tpu_torch.ops.viterbi import viterbi_plain
    got = vk.viterbi_kernel(x, lens, g)
    ref = viterbi_plain(x, lens, g)
    torch.cuda.synchronize()
    bad = {k: int((getattr(got, k) != getattr(ref, k)).sum())
           for k in ref._fields}
    live = torch.isfinite(ref.objf)
    err = float((got.objf[live] - ref.objf[live]).abs().max()) \
        if bool(live.any()) else 0.0
    print(f"# {label}: mismatches {bad}, objf max abs diff {err:.3e}, ok "
          f"{int(got.ok.sum())}/{len(got.ok)}", flush=True)
    check(sum(bad.values()) == 0, f"{label}: kernel differs from the plain "
          f"version: {bad}")
    if want_ok is not None:
        check(got.ok.tolist() == want_ok, f"{label}: ok {got.ok.tolist()}, "
              f"want {want_ok}")
    check(bool((got.pdfs[~got.ok] == -1).all()), f"{label}: a path on an "
          "infeasible sequence")
    return sum(bad.values()), err


def vit_small(dev):
    """The kernel against its plain version on small batches."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  alignment_to_pdf_sequence,
                                                  make_numerator_fst)
    from pychain_tpu_torch.graphs.fst import FST
    from pychain_tpu_torch.utils.testgraphs import linear_fst, random_fst
    gen = torch.Generator(device=dev).manual_seed(6)
    # cyclic graphs at unequal lengths, a linear graph that accepts only
    # length 3 at length 5, and a length 0
    mixed, _ = list_batch([random_fst(num_states=6 + b, num_pdfs=10,
                                      max_arcs_per_state=4, seed=b)
                           for b in range(3)]
                          + [linear_fst([1, 2, 3]),
                             random_fst(num_states=5, num_pdfs=10, seed=9)],
                          dev)
    # about a fifth of x lies beyond the clamp
    x = 24.0 * torch.randn(5, 16, 10, generator=gen, device=dev)
    out = [vit_compare(mixed.semiring(), x, torch.tensor([16, 11, 7, 5, 0]),
                       "viterbi small cyclic",
                       [True, True, True, False, False])]
    topo = ChainTopology(num_phones=5)
    shared = ChainGraphBatch(ChainGraph(make_numerator_fst([0, 3, 1, 4],
                                                           topo),
                                        log_domain=True), 4, device=dev)
    x = torch.randn(4, 16, 10, generator=gen, device=dev)
    out.append(vit_compare(shared.semiring(), x, torch.tensor([16, 11, 7, 4]),
                           "viterbi small shared", [True] * 4))
    # ties: weightless flat-start arcs under +-8 oracle emissions with
    # extra +8 frames, and an ergodic weightless graph, every state final,
    # under flat emissions
    rng = np.random.RandomState(6)
    plans = [([1, 3, 0, 2], [3, 4, 2, 5]), ([2, 2, 4], [1, 6, 3]),
             ([4, 0], [7, 2])]
    fsts = [make_numerator_fst(ph, topo) for ph, _ in plans]
    fsts.append(FST.from_arcs(
        4, 0, [(s, d, p + 1, p + 1, 0.0) for s, d, p in
               ((0, 1, 0), (0, 2, 1), (1, 3, 2), (2, 3, 3), (3, 0, 4),
                (1, 1, 5), (2, 2, 5), (3, 3, 6), (0, 3, 7))],
        {s: 0.0 for s in range(4)}))
    xo = np.full((4, 16, 10), -8.0, np.float32)
    lens = []
    for b, (ph, du) in enumerate(plans):
        seq = alignment_to_pdf_sequence(ph, du, topo)
        xo[b, np.arange(len(seq)), seq] = 8.0
        for t in np.nonzero(rng.rand(16) < 0.5)[0]:
            xo[b, t, [f(p) for p in ph
                      for f in (topo.fwd_pdf, topo.self_pdf)]] = 8.0
        lens.append(len(seq))
    xo[3] = 8.0
    ties, _ = list_batch(fsts, dev)
    out.append(vit_compare(ties.semiring(), torch.from_numpy(xo).to(dev),
                           torch.tensor(lens + [16]), "viterbi small ties",
                           [True] * 4))
    return out


def vit_bytes_ops(g, lens, B, T):
    """What the function must move and compute for this run's data: x at
    each graph's pdfs for live frames; each distinct graph's arrays once
    (src, pdf, logp; initial, final, in-arc offsets); lengths, objf,
    pdfs and states; and one backpointer per state of each graph and
    live frame, but only for a sequence whose backpointers and
    double-buffered scores do not fit one block's shared memory (the
    others stay on chip).  A backpointer need only name the winner's
    place in its state's in-arc list: ceil(log2(max in-degree)) bits, in
    whole bytes, at least one.  Operations: two adds and a compare per
    arc and live frame."""
    from pychain_tpu_torch.ops.fact_kernels import MAX_SMEM
    real = g.dst < g.num_states
    n_arcs = real.sum(dim=1)
    n_states = torch.where(real, torch.maximum(g.src, g.dst),
                           torch.full_like(g.src, -1)).amax(dim=1) + 1
    n_pdfs = torch.tensor([len(set(g.pdf[r][real[r]].tolist()))
                           for r in range(g.rows)], device=g.device)
    max_in = int((g.in_ptr[:, 1:] - g.in_ptr[:, :-1]).max())
    bp_bytes = max(1, -(-math.ceil(math.log2(max(max_in, 1))) // 8))
    per_b = (lambda v: v.expand(B)) if g.rows == 1 else (lambda v: v)
    L = lens.to(g.device).long()
    bp_seq = bp_bytes * L * per_b(n_states)
    off_chip = bp_seq + 8 * per_b(n_states) > MAX_SMEM
    nbytes = (4 * int((L * per_b(n_pdfs)).sum())
              + int(bp_seq[off_chip].sum())
              + 12 * int(n_arcs.sum()) + 12 * int(n_states.sum())
              + 8 * B + 8 * B * T)
    ops = 3 * int((L * per_b(n_arcs)).sum())
    return nbytes, ops, (int(n_arcs.min()), int(n_arcs.max()),
                         int(n_states.min()), int(n_states.max()), max_in,
                         bp_bytes, int(off_chip.sum()))


def vit_class(name, g, x, lens, reps):
    """One size class: bit-identical check, kernel and plain times,
    bytes and operations."""
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    from pychain_tpu_torch.ops.viterbi import viterbi_plain
    B, T, P = x.shape
    bad, err = vit_compare(g, x, lens, f"viterbi class {name}")
    lens32 = lens.int().to(x.device)
    lay = vk.plan_for(g, P, T)
    ms = cuda_ms(lambda: vk.viterbi_sweep(x, lens32, g), reps)
    plain_ms = cuda_ms(lambda: viterbi_plain(x, lens32, g), 1)
    nbytes, ops, (k0, k1, s0, s1, max_in, bp_bytes, n_off) = vit_bytes_ops(
        g, lens, B, T)
    print(f"# viterbi class {name}: B={B} T={T} P={P} rows={g.rows} "
          f"K_pad={g.k_pad} S_pad={g.num_states} arcs {k0}..{k1} states "
          f"{s0}..{s1} max in-degree {max_in} (backpointers of {bp_bytes} B, "
          f"in the bound for the {n_off} sequences whose backpointers do "
          f"not fit on chip) lengths {int(lens.min())}..{int(lens.max())}; "
          f"layout: {lay.threads} threads, L={lay.lanes} lanes a state, "
          f"x ring {lay.stages} stages, lists "
          f"{'resident' if lay.resident else 'in device memory'}, "
          f"{lay.bp_width}-byte positions in "
          f"{'shared' if lay.bp_smem else 'device'} memory, "
          f"{vk.layout_smem(lay, g.num_states, g.k_pad, T, P)} B shared; "
          f"viterbi {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    return ms, plain_ms, nbytes, ops, err, bad, lay


def constrained_fsts(res, x_lengths, flat_phones, num_phones):
    """Tolerance-3 constrained numerators (make_constrained_numerator)
    from the best paths ``res`` of viterbi_align, and the phone
    durations read from them."""
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  durations_from_alignment,
                                                  make_constrained_numerator)
    ok = res.ok.cpu().numpy()
    states = res.states.cpu().numpy()
    lens = torch.as_tensor(x_lengths).cpu().numpy()
    check(bool(ok.all()), f"realign: {int((~ok).sum())} sequences have no "
          "alignment")
    topo = ChainTopology(num_phones=num_phones)
    fsts, durs_all = [], []
    for b, phones in enumerate(flat_phones):
        durs = durations_from_alignment(states[b], int(lens[b]))
        check(len(durs) == len(phones) and sum(durs) == lens[b],
              f"realign: sequence {b} durations {durs}")
        durs_all.append(durs)
        fsts.append(make_constrained_numerator(phones, durs, topo,
                                               tolerance=3))
    return fsts, durs_all


def realign(loss_mod, x, x_lengths, flat_batch, flat_phones, num_phones,
            counters, vit_counter):
    """Main path 3 (examples/train_corpus.py:552-586): align main path
    2's batch with its x, build tolerance-3 constrained numerators from
    the best paths, then three ChainLoss SGD steps on them.  Every count
    is set to 0 before the alignment and read after the last step."""
    from pychain_tpu_torch import viterbi_align
    for c in (*counters, vit_counter):
        for k in c:
            c[k] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = viterbi_align(x.detach(), x_lengths, flat_batch)
    end.record()
    torch.cuda.synchronize()
    align_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    fsts, durs_all = constrained_fsts(res, x_lengths, flat_phones,
                                      num_phones)
    batch, batch_ms = list_batch(fsts, x.device)
    host_ms = (time.perf_counter() - t0) * 1e3
    g = batch.semiring()
    print(f"# main path 3 (realignment): viterbi_align {align_ms:.3f} ms "
          f"(CUDA events); durations + constrained numerators + "
          f"ChainGraphBatch {host_ms:.1f} ms on the host (of it the "
          f"batch {batch_ms:.1f} ms); K_pad={g.k_pad} S_pad="
          f"{g.num_states}; phone durations "
          f"{min(min(d) for d in durs_all)}..{max(max(d) for d in durs_all)}"
          " frames", flush=True)
    losses, step_ms, launches = train_steps(
        loss_mod, x, x_lengths, batch, counters,
        want_launches(counters, fact_fwd=1, fact_bwd=1, semiring_fwd=1,
                      semiring_bwd=1),
        "main path 3 (constrained numerators)",
        reset=False)
    launches = {**launches, **vit_counter}
    print(f"# main path 3 launches: {launches}", flush=True)
    check(vit_counter["viterbi"] == 1, f"realign: viterbi launched "
          f"{vit_counter['viterbi']} times, want 1")
    # after the path's counts are read: a second call on the same batch,
    # whose kernel lists are built by then
    again_ms = cuda_ms(lambda: viterbi_align(x.detach(), x_lengths,
                                             flat_batch), 1)
    print(f"# main path 3: viterbi_align again on the same batch "
          f"{again_ms:.3f} ms (CUDA events)", flush=True)
    profiled_step(loss_mod, x, x_lengths, batch, "constrained numerators")
    return step_ms, launches, align_ms, host_ms, batch


def decoding(dev, B, T, vit_counter):
    """The decoding path: PhoneDecoder over a bigram phone LM at B=128,
    T=500, once on random x and once on oracle emissions.  Returns the
    decoder's batch arrays, the random x and lengths (the "decode"
    class) and the launches."""
    from pychain_tpu_torch import viterbi_align
    from pychain_tpu_torch.decode import PhoneDecoder, phone_error_rate
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  alignment_to_pdf_sequence,
                                                  estimate_phone_lm)
    n_ph = 48
    rng = np.random.RandomState(7)
    t0 = time.perf_counter()
    texts = [[int(p) for p in rng.randint(0, n_ph, size=rng.randint(20, 61))]
             for _ in range(2000)]
    topo = ChainTopology(num_phones=n_ph)
    dec = PhoneDecoder(estimate_phone_lm(texts, num_phones=n_ph, order=2),
                       topo)
    build_s = time.perf_counter() - t0
    lens = torch.from_numpy(rng.randint(T // 2, T + 1, size=B))
    x_rand = torch.randn(B, T, topo.num_pdfs, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev)
    refs, durs = texts[:B], []
    xo = np.full((B, T, topo.num_pdfs), -8.0, np.float32)
    for b, ph in enumerate(refs):
        n, L = len(ph), int(lens[b])
        du = 1 + rng.multinomial(L - n, [1.0 / n] * n)
        durs.append([int(d) for d in du])
        seq = alignment_to_pdf_sequence(ph, du, topo)
        xo[b, np.arange(L), seq] = 8.0
    x_or = torch.from_numpy(xo).to(dev)
    for k in vit_counter:
        vit_counter[k] = 0
    times = []
    for xx in (x_rand, x_or):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dec(xx, lens)
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(np.isfinite(res.scores).all()), "decode: non-finite "
              "scores")
    launches = dict(vit_counter)
    batch = dec._batches[(B, x_rand.device)]
    align_ms = cuda_ms(lambda: viterbi_align(x_rand, lens, batch), 1)
    per = phone_error_rate(refs, res.phones)
    print(f"# decoding: graph S={dec.graph.num_states} "
          f"K={dec.graph.num_transitions} P={topo.num_pdfs} built in "
          f"{build_s:.2f} s; B={B} T={T} lengths {int(lens.min())}.."
          f"{int(lens.max())}; call (viterbi_align + host pdf->phone "
          f"reading) random x {times[0]:.1f} ms, oracle x {times[1]:.1f} "
          f"ms; viterbi_align alone {align_ms:.3f} ms (CUDA events); "
          f"oracle PER {per}; launches {launches}", flush=True)
    check(per == 0.0, f"decode: oracle PER {per}")
    check(res.durations == durs, "decode: oracle durations differ")
    check(launches == {"viterbi": 2}, f"decode: launches {launches}, want "
          "one per call")
    return batch.semiring(), x_rand, lens, launches


# ----------------------------------------------------------------------
# The XL roofline probe (T1/T2)
# ----------------------------------------------------------------------

XL_TOL = {"vpu": 1e-5, "mxu_f32": 1e-5, "mxu_bf16": 5e-3}
XL_REPLACES = {"vpu": ("tools/xl_roofline.py:72", "make_vpu kernel :50"),
               "mxu_f32": ("tools/xl_roofline.py:126",
                           "make_mxu kernel :94, f32 masks, HIGHEST"),
               "mxu_bf16": ("tools/xl_roofline.py:126",
                            "make_mxu kernel :94, bf16 masks, DEFAULT")}


def xl_probe(dev):
    """The probe's kernels against their plain versions, small shapes and
    the tool's default size (and B=128); then the tool's own path with the
    launches counted.  Returns {form: row fields}."""
    from pychain_tpu_torch.tools import xl_roofline as xr
    for S, K, T, B in ((64, 192, 16, 2), (100, 250, 12, 3), (37, 45, 5, 2),
                       (50, 170, 9, 2), (1000, 3200, 8, 2)):
        rng = np.random.RandomState(S)
        src = rng.randint(0, S, (B, K)).astype(np.int32)
        dst = rng.randint(0, S, (B, K)).astype(np.int32)
        if S == 50:
            dst[0, :40] = 5                      # 40 in-arcs: no slots hold it
        dst[dst == 0] = 1                        # state 0: no in-arc
        w = rng.rand(K).astype(np.float32) + 0.1
        args = [torch.from_numpy(a).to(dev) for a in (src, dst, w)]
        errs = {}
        for form, run in xr.RUNNERS.items():
            xr.reset_launch_counts()
            got = run(*args, S, T)
            check(xr.LAUNCHES[xr.KERNELS[form]] == 1
                  and sum(xr.LAUNCHES.values()) == 1,
                  f"xl {form} S={S}: launches {xr.LAUNCHES}, want one of "
                  f"{xr.KERNELS[form]}")
            errs[form] = xr.rel_diff(got, xr.plain(form, *args, S, T))
            check(errs[form] <= XL_TOL[form] and bool((got[:, 0] == 0).all())
                  and got.shape == (B, S),
                  f"xl {form} S={S} K={K} T={T} B={B}: rel err "
                  f"{errs[form]:.3e} (limit {XL_TOL[form]:.0e}), carry of "
                  f"the state without in-arcs {got[:, 0].tolist()}")
            check(torch.equal(run(*args, S, T), got),
                  f"xl {form} S={S} K={K}: a rerun differs")
        plan = xr.vpu_plan(*args, S)
        print(f"# xl small S={S} K={K} T={T} B={B}: rel err "
              + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
              + "; each bit-identical on a rerun; xl_vpu at "
              f"{plan.threads // 32} warps, {plan.slots} slots", flush=True)

    S, K, T, B = 1000, 3200, 512, 8              # tools/xl_roofline.py:149-152
    src, dst, w = xr.inputs(S, K, B, dev)
    rows, kernel_out = {}, {}
    s_pad, k_pad = -(-S // 16) * 16, -(-K // 16) * 16
    for form, run in xr.RUNNERS.items():
        got = run(src, dst, w, S, T)
        ref = xr.plain(form, src, dst, w, S, T)
        torch.cuda.synchronize()
        err, abs_err = xr.rel_diff(got, ref), absmax(got, ref)
        check(bool(torch.isfinite(got).all()) and err <= XL_TOL[form],
              f"xl {form} at S={S} K={K} T={T} B={B}: rel err {err:.3e} "
              f"(limit {XL_TOL[form]:.0e})")
        kernel_out[form] = got
        plain_ms = cuda_ms(lambda: xr.plain(form, src, dst, w, S, T), 1)
        # the kernel alone, on its prepared arrays (the runner's call adds
        # the input checks' host sync and the sorts)
        split = xr.SPLIT.get(xr.KERNELS[form], 0)
        if form == "vpu":
            prep = xr.vpu_plan(src, dst, w, S)
            kernel_ms = cuda_ms(lambda: xr.vpu_kernel(prep, S, T), 10)
            layout = {"warps": prep.threads // 32, "slots": prep.slots}
            issued = None
        else:
            prep = xr.mxu_operands(src, dst, w, S)
            kernel_ms = cuda_ms(
                lambda: xr.mxu_kernel(xr.KERNELS[form], prep, S, T), 10)
            first, second = xr.issued_fragments(prep)
            layout = {"fragments_a_frame": [first / B, second / B]}
            # the tensor-core operations the lists issue, in tc_dense_ops'
            # units (each fragment's share of the dense form, a bf16 term)
            issued = xr.issued_ops(prep) * split * T
        drift = xr.rel_diff(got, kernel_out["vpu"])
        rows[form] = {"rel_err": err, "max_abs_err": abs_err,
                      "ms": kernel_ms, "plain_ms": plain_ms,
                      "drift_vs_vpu": drift, "layout": layout,
                      "bit_equal_plain": bool(torch.equal(got, ref)),
                      # the function's own work: K gathers and 2K flops a
                      # frame and row; ids, weights in and the carry out
                      "bytes": B * K * 8 + K * 4 + B * S * 4,
                      "ops": 2 * K * B * T,
                      # what the dense tensor-core form does
                      "tc_dense_ops": 4 * s_pad * k_pad * B * T * split,
                      "tc_issued_ops": issued}
        print(f"# xl {form} at S={S} K={K} T={T} B={B}: rel err {err:.3e}, "
              f"max abs {abs_err:.3e} against the plain version; kernel "
              f"{kernel_ms:.3f} ms ({kernel_ms * 1e3 / T:.4f} us a frame of "
              f"a row), plain {plain_ms:.1f} ms; carry drift against vpu "
              f"{drift:.3e}; layout {layout}", flush=True)
        if split:
            dense = rows[form]["tc_dense_ops"]
            print(f"# xl {form}: dense tensor-core form {dense:.4e} ops, "
                  f"{dense / PEAK_BF16_TC_FLOPS * 1e3:.4f} ms at "
                  f"{PEAK_BF16_TC_FLOPS / 1e12:.0f} TFLOP/s; the lists issue "
                  f"{issued:.4e} ({issued / dense:.4f} of it), "
                  f"{issued / PEAK_BF16_TC_FLOPS * 1e3:.6f} ms (a count over "
                  f"a peak, not a timing)", flush=True)
    print(f"# xl_mxu_bf16 at S={S} K={K} T={T} B={B} equals its plain "
          f"version bit for bit: {rows['mxu_bf16']['bit_equal_plain']}",
          flush=True)

    # each kernel at B=128 rows (semiring_fwd's xl class)
    src128, dst128, w128 = xr.inputs(S, K, 128, dev)
    ref128 = xr.plain("vpu", src128, dst128, w128, S, T)
    prep = xr.vpu_plan(src128, dst128, w128, S)
    got128 = xr.vpu_kernel(prep, S, T)
    check(xr.rel_diff(got128, ref128) <= XL_TOL["vpu"],
          f"xl_vpu at B=128: rel err {xr.rel_diff(got128, ref128):.3e}")
    ms128 = cuda_ms(lambda: xr.vpu_kernel(prep, S, T), 10)
    rows["vpu"]["b128_ms"] = ms128
    print(f"# xl_vpu at B=128 (S={S} K={K} T={T}, default plan "
          f"{prep.threads // 32} warps): {ms128:.4f} ms, "
          f"{ms128 * 1e3 / (128 * T):.5f} us/frame/seq", flush=True)
    ops128 = xr.mxu_operands(src128, dst128, w128, S)
    for form in ("mxu_f32", "mxu_bf16"):
        name = xr.KERNELS[form]
        got128 = xr.mxu_kernel(name, ops128, S, T)
        ref128 = xr.plain(form, src128, dst128, w128, S, T)
        err128 = xr.rel_diff(got128, ref128)
        check(bool(torch.isfinite(got128).all()) and err128 <= XL_TOL[form],
              f"xl {form} at B=128: rel err {err128:.3e}")
        ms = cuda_ms(lambda: xr.mxu_kernel(name, ops128, S, T), 10)
        rows[form]["b128_ms"] = ms
        print(f"# xl {form} at B=128: {ms:.4f} ms, {ms * 1e3 / (128 * T):.5f} "
              f"us/frame/seq, rel err {err128:.3e}, bit for bit "
              f"{bool(torch.equal(got128, ref128))}", flush=True)
    del src128, dst128, w128, prep, ops128

    # the probe's path: the tool's main(), launches counted
    xr.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = xr.main(["--iters", "5"])
    launches = dict(xr.LAUNCHES)
    print(f"# xl_roofline: {buf.getvalue().strip()}")
    print(f"# xl_roofline launches: {launches}", flush=True)
    for form in xr.FORMS:
        check(launches[xr.KERNELS[form]] >= 1,
              f"the probe ran {form} without launching "
              f"{xr.KERNELS[form]}")
        res = out["results"][form]
        rows[form].update(launches=launches[xr.KERNELS[form]],
                          call_ms=res["ms_per_call"],
                          us_per_frame=res["us_per_frame"],
                          compile_s=res["compile_s"])
    return rows


def reset_counts(counters):
    for c in counters:
        for k in c:
            c[k] = 0


class Capture:
    """While main path 6 runs: the inputs of the first call of each kernel
    wrapper in each stage of each run, copied to the host (px, x and the
    lengths; the graph arrays kept as they are), so that each kernel is
    held against its plain version at the shapes and on the data the path
    gave it.  It wraps the wrappers where the port calls them (the loss's
    denominator and semiring dispatch, viterbi_align) and restores them
    on exit; the checks run after, on the wrappers themselves."""

    def __init__(self):
        self.stage, self.run, self.calls = None, 0, {}

    def begin(self, stage):
        self.stage, self.run = stage, self.run + 1

    def keep(self, family, inputs):
        key = (self.stage, family, self.run)
        if key not in self.calls:
            self.calls[key] = inputs()

    def inputs(self):
        """{(stage, family): [inputs of each run's first call]}"""
        out = {}
        for (stage, family, _), v in sorted(self.calls.items(),
                                            key=lambda kv: kv[0][2]):
            out.setdefault((stage, family), []).append(v)
        return out

    def __enter__(self):
        from pychain_tpu_torch import loss
        from pychain_tpu_torch.ops import fact_kernels as fk
        from pychain_tpu_torch.ops import viterbi_kernels as vk
        den = fk.forward_backward_prob_kernel
        sr = loss.forward_backward_semiring_kernel
        vit = vk.viterbi_kernel
        host = lambda t: t.detach().to("cpu", copy=True)

        def den_hook(px, lengths, fa, leaky_coefficient=1e-5, **kw):
            self.keep("den", lambda: (host(px), host(lengths), fa,
                                      leaky_coefficient))
            return den(px, lengths, fa, leaky_coefficient, **kw)

        def sr_hook(x, lengths, g):
            self.keep("semiring", lambda: (host(x), host(lengths), g))
            return sr(x, lengths, g)

        def vit_hook(x, lengths, g):
            self.keep("viterbi", lambda: (host(x), host(lengths), g))
            return vit(x, lengths, g)
        self._saved = ((fk, "forward_backward_prob_kernel", den),
                       (loss, "forward_backward_semiring_kernel", sr),
                       (vk, "viterbi_kernel", vit))
        fk.forward_backward_prob_kernel = den_hook
        loss.forward_backward_semiring_kernel = sr_hook
        vk.viterbi_kernel = vit_hook
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def recipe_run(label, argv, counters, tf32_defaults, capture=None,
               stage=None, on_event=None):
    """The port's corpus recipe (its ``main``, in this process, on the
    card, under PyTorch's TF32 defaults: a user's run) with every kernel
    count set to 0 just before and read just after, and with ``capture``
    each kernel's first inputs of the run captured under ``stage``.
    Returns (result, launches, seconds)."""
    from pychain_tpu_torch.examples import train_corpus as tc
    print(f"# main path 6 {label}: python -m "
          f"pychain_tpu_torch.examples.train_corpus {' '.join(argv)}",
          flush=True)
    if capture is not None:
        capture.begin(stage)
    with capture or contextlib.nullcontext(), tf32(*tf32_defaults):
        reset_counts(counters)
        t0 = time.perf_counter()
        res = tc.main(argv, on_event=on_event)
        secs = time.perf_counter() - t0
        launched = counts(counters)
    print(f"# main path 6 {label}: {secs:.1f} s, denominator engine "
          f"{res['den_engine']!r}, launches "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    return res, launched, secs


def p6_den(label, caps, dev):
    """B1/B2 (float32, or the fast pair for bfloat16 tiles) against the
    plain version on each run's captured inputs of one stage of main path
    6 (debug True and False; the alpha' stream), timed on the first run's
    with the plain sweeps, and the bytes and operations of that run's
    data.  Returns the row fields of each of the two kernels."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import is_fast
    errs, a_errs = [], []
    for i, (px, lens, fa, leaky_c) in enumerate(caps):
        px, lens = px.to(dev), lens.to(dev)
        name = f"main path 6 {label}, run {i + 1}"
        errs += [compare(fa, px, lens, leaky_c, debug, name)
                 for debug in (False, True)]
        a_errs.append(alpha_err(fa, px, lens, leaky_c, name))
    px, lens, fa, leaky_c = caps[0]
    px, lens = px.to(dev), lens.to(dev)
    B, T, P = px.shape
    t = pair_times(fa, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd, 3)
    # each kernel's plan and, where it is the fast pair's group form, one
    # block a column on the same inputs
    plan = {form: fk._plan(form, B, dev, fa, None)
            for form in ("fact_fwd", "fact_bwd")}
    one = t[:2]
    if any(isinstance(p, tuple) for p in plan.values()):
        one = pair_times(fa, px, lens, leaky_c,
                         functools.partial(fk.fact_fwd, cluster=1),
                         functools.partial(fk.fact_bwd, cluster=1), 3,
                         plain=False)
    kg = fk.graph_for(fa)
    fb, fo, bb, bo = fact_bytes_ops(fa, kg, lens, T, P)
    e = worst(errs)
    suffix = "_bf16" if is_fast(fa) else ""
    print(f"# main path 6 {label}: B={B} T={T} P={P} S_pad={fa.s_pad} "
          f"lengths {int(lens.min())}..{int(lens.max())}; fact_fwd{suffix} "
          f"{t[0]:.3f} ms, fact_bwd{suffix} {t[1]:.3f} ms; plain fwd "
          f"{t[2]:.1f} ms, plain bwd {t[3]:.1f} ms; plan {plan}, one block "
          f"a column {one[0]:.3f} / {one[1]:.3f} ms", flush=True)
    shape = {"B": B, "T": T, "P": P, "s_pad": fa.s_pad,
             "lengths": [int(lens.min()), int(lens.max())]}
    plans = {k: list(v) if isinstance(v, tuple) else v
             for k, v in plan.items()}
    return {f"fact_fwd{suffix}": {
                "plan": plans["fact_fwd"], "one_block_ms": one[0],
                "ms": t[0], "plain_ms": t[2], "bytes": fb, "ops": fo,
                "max_abs_err": max(max(a for a, _ in a_errs),
                                   e["objf_rel"]),
                "entry_excess": max(x for _, x in a_errs), "shape": shape},
            f"fact_bwd{suffix}": {
                "plan": plans["fact_bwd"], "one_block_ms": one[1],
                "ms": t[1], "plain_ms": t[3], "bytes": bb, "ops": bo,
                "max_abs_err": max(e["gamma_abs"], e["alpha_beta_abs"],
                                   e["gamma_sum_abs"]),
                "entry_excess": e["gamma_excess"], "shape": shape}}


def p6_semiring(label, caps, dev):
    """The semiring pair against its plain version on the first run's
    captured inputs of one stage of main path 6 (sr_class: both sweeps,
    the alpha stream, times, bytes and operations), by the size class the
    JAX package's rule gives that batch."""
    x, lens, g = caps[0]
    x, lens = x.to(dev), lens.to(dev)
    cls = size_class(x.shape[0], g.k_pad, g.num_states)
    return sr_class(cls, g, x, lens, 5, label=f"main path 6 {label}",
                    feasible=False)


def p6_viterbi(label, caps, dev):
    """The Viterbi kernel against its plain version, bit for bit, on each
    run's captured inputs of one stage of main path 6; timed (vit_class)
    on the first run's."""
    for i, (x, lens, g) in enumerate(caps[1:]):
        vit_compare(g, x.to(dev), lens, f"main path 6 {label}, run {i + 2}")
    x, lens, g = caps[0]
    return vit_class(f"main path 6 {label}", g, x.to(dev), lens, 5)


# main path 6 (d): the recipe at bench.py's width
P6_WIDTH = ["--synthetic-graphs", "random", "--corpus-phones", "1500",
            "--corpus-utts", "512", "--corpus-min-t", "400",
            "--corpus-max-t", "500", "--batch-size", "128", "--tile-dtype",
            "bfloat16", "--model", "tdnn", "--diag-every", "0"]


def main_path_6(counters, p5_utts_per_s, tf32_defaults):
    """Main path 6, the corpus recipe (examples/train_corpus.py) through
    the port's own (pychain_tpu_torch/examples/train_corpus.py) on the
    card: (a) the PER gates in float32 and with bfloat16 tiles, (b) flat
    start, realignment and chunking, (c) --device-corpus, (d) the recipe
    at bench.py's width, (e) a checkpoint round trip.  Then every kernel
    the path launched is held against its plain version on the inputs
    it had in each stage, and timed there.  Returns the launches by
    stage and kernel, the checks' row fields by stage and family, and
    the figures."""
    from pychain_tpu_torch import ChainGraphBatch
    dev = torch.device("cuda")
    per_args = ["--synthetic-graphs", "built", "--num-style", "aligned",
                "--corpus-utts", "32", "--corpus-phones", "24",
                "--signal", "1.2", "--steps", "60", "--batch-size", "8",
                "--warmup-steps", "2", "--diag-every", "0", "--eval-per",
                "--eval-per-untrained"]
    cap = Capture()
    stages = {}      # stage -> {kernel: launches}
    out = {}

    def add(stage, launched):
        row = stages.setdefault(stage, {})
        for k, v in launched.items():
            if v:
                row[k] = row.get(k, 0) + v

    def run(label, argv, stage, on_event=None, capture=True):
        return recipe_run(label, argv, counters, tf32_defaults,
                          cap if capture else None, stage, on_event)

    # (a) the PER gates (tests/test_recipe_smoke.py:68-119's arguments
    # and thresholds).  The built phone-LM denominator keeps residual
    # arcs, which no kernel takes: it runs the plain version (ROADMAP
    # A.6), in float32 and with bfloat16 tiles alike
    for tiles, extra in (("float32", []), ("bfloat16",
                                           ["--tile-dtype", "bfloat16"])):
        res, launched, secs = run(f"(a) PER gate, {tiles} tiles",
                                  per_args + extra, "(a)")
        untrained, trained = res["untrained_per"], res["per"]
        print(f"# main path 6 (a) {tiles}: untrained PER {untrained!r}, "
              f"trained PER {trained!r} (gates: untrained >= 0.5, trained "
              f"<= 0.15 and <= untrained / 3); final loss {res['loss']!r}; "
              f"denominator engine {res['den_engine']!r} (no denominator "
              f"kernel)", flush=True)
        check(untrained >= 0.5 and trained <= 0.15
              and trained <= untrained / 3,
              f"main path 6 (a) {tiles}: PER gate failed: untrained "
              f"{untrained}, trained {trained}")
        check(res["den_engine"] == "xla" and not any(
            launched[k] for k in ("fact_fwd", "fact_bwd", "fact_fwd_bf16",
                                  "fact_bwd_bf16")),
              f"main path 6 (a) {tiles}: denominator engine "
              f"{res['den_engine']!r}, launches {launched}")
        check(launched["viterbi"] > 0, f"main path 6 (a) {tiles}: the "
              "decoder launched no viterbi kernel")
        add("(a)", launched)
        out[f"per_{tiles}"] = (untrained, trained)

    # (b) flat start, then realignment into tolerance-constrained,
    # chunked numerators: each semiring kernel's launches before and after
    # the realignment, and viterbi's at it
    marks = {}

    def mark(event):
        marks[event] = counts(counters)
        cap.stage = {"realign": "(b) realign",
                     "realigned": "(b) constrained"}[event]
    res, launched, secs = run(
        "(b) flat start + realignment",
        ["--synthetic-graphs", "built", "--num-style", "flat",
         "--realign-at", "20", "--chunk-frames", "40", "--steps", "30",
         "--warmup-steps", "2", "--diag-every", "5"], "(b) flat", mark)
    check("realign" in marks and "realigned" in marks,
          "main path 6 (b): no realignment")
    before, at = marks["realign"], {k: marks["realigned"][k] -
                                    marks["realign"][k] for k in launched}
    after = {k: launched[k] - marks["realigned"][k] for k in launched}
    print(f"# main path 6 (b): flat-start batches (K, S = "
          f"{res['num_pad'][0]}) semiring_fwd {before['semiring_fwd']}, "
          f"semiring_bwd {before['semiring_bwd']}; realignment viterbi "
          f"{at['viterbi']}; constrained chunk batches (K, S = "
          f"{res['num_pad'][1]}) semiring_fwd {after['semiring_fwd']}, "
          f"semiring_bwd {after['semiring_bwd']}; final loss "
          f"{res['loss']!r}, every diagnostic ok: {res['ok']}", flush=True)
    check(np.isfinite(res["loss"]) and res["ok"],
          f"main path 6 (b): loss {res['loss']}, diagnostics ok {res['ok']}")
    check(before["semiring_fwd"] == before["semiring_bwd"] == 20
          and after["semiring_fwd"] == after["semiring_bwd"] == 10
          and at["viterbi"] == 12,
          f"main path 6 (b): launches before {before}, at {at}, after "
          f"{after}")
    add("(b) flat", before)
    add("(b) realign", at)
    add("(b) constrained", after)

    # (c) --device-corpus: the corpus staged once, no ChainGraphBatch
    # built inside the loop
    built = []
    init = ChainGraphBatch.__init__

    def counting(self, *a, **kw):
        built.append(1)
        init(self, *a, **kw)
    ChainGraphBatch.__init__ = counting
    try:
        res, launched, secs = run(
            "(c) --device-corpus", ["--device-corpus", "--steps", "20",
                                    "--warmup-steps", "2", "--diag-every",
                                    "10"], "(c)")
    finally:
        ChainGraphBatch.__init__ = init
    print(f"# main path 6 (c): {res['staged_mb']:.1f} MB staged; "
          f"ChainGraphBatch built {len(built)} times in the run (the "
          f"corpus's numerators and the denominator, before the loop); "
          f"steady state {res['utts_per_s']!r} utts/s", flush=True)
    check(len(built) == 2 and res["staged_mb"] and np.isfinite(res["loss"])
          and res["ok"], f"main path 6 (c): {len(built)} batches built, "
          f"result {res}")
    check(res["den_engine"] == "pallas"
          and launched["fact_fwd"] == launched["fact_bwd"] == 20 + 3,
          f"main path 6 (c): engine {res['den_engine']!r}, launches "
          f"{launched} (20 steps, diagnostics at steps 1, 10 and 20)")
    add("(c)", launched)

    # (d) the recipe at bench.py's width: four full batches of 128 an
    # epoch, the fast denominator pair once a step.  Its kernels' inputs
    # are captured in a one-step rerun at the same arguments (the same
    # corpus, weights and first batch), so that copying 0.77 GB of px to
    # the host does not disturb the timed run or its peak memory
    width = P6_WIDTH
    torch.cuda.reset_peak_memory_stats()
    res, launched, secs = run(
        "(d) bench width", width + ["--steps", "12", "--warmup-steps", "2"],
        "(d)", capture=False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pipe = res["pipeline"]
    print(f"# main path 6 (d) on {card_line()}: steady state "
          f"{res['utts_per_s']!r} utts/s, {res['frames_per_s']!r} frames/s "
          f"over 10 steps (main path 5's TDNN-512x5 step in the same run: "
          f"{p5_utts_per_s!r} utts/s); pipeline: host assembly "
          f"{pipe['assemble']!r} ms/batch, transfer {pipe['transfer']!r} "
          f"ms/batch, consumer starvation {pipe['starvation']!r} ms/step; "
          f"peak device memory {peak:.3f} GiB; final loss {res['loss']!r}",
          flush=True)
    check(res["den_engine"] == "pallas"
          and launched["fact_fwd_bf16"] == launched["fact_bwd_bf16"] == 12
          and launched["fact_fwd"] == launched["fact_bwd"] == 0
          and np.isfinite(res["loss"]),
          f"main path 6 (d): engine {res['den_engine']!r}, launches "
          f"{launched}, loss {res['loss']}")
    add("(d)", launched)
    run("(d) inputs, one step", width + ["--steps", "1", "--warmup-steps",
                                         "1"], "(d)")
    out["bench"] = {"utts_per_s": res["utts_per_s"],
                    "frames_per_s": res["frames_per_s"], "pipeline": pipe,
                    "peak_gib": peak, "seconds": secs,
                    "losses": res["losses"]}

    # (e) a checkpoint round trip: six steps, then a resume to twelve
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".chip_smoke_ckpt", "recipe")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        args = ["--steps", "6", "--ckpt", ckpt, "--warmup-steps", "1",
                "--diag-every", "0"]
        first, launched, _ = run("(e) checkpoint, steps 0-6", args, "(e)")
        add("(e)", launched)
        args[1] = "12"
        second, launched, _ = run("(e) resume, steps 6-12", args, "(e)")
        add("(e)", launched)
        with open(os.path.join(ckpt, "LATEST")) as f:
            latest = int(f.read())
    finally:
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    print(f"# main path 6 (e): resumed from step {second['resumed_from']}, "
          f"{second['steps']} steps, LATEST {latest}; losses "
          f"{first['loss']!r} -> {second['loss']!r}", flush=True)
    check(second["resumed_from"] == 6 and second["steps"] == 6
          and latest == 12 and np.isfinite(second["loss"]),
          f"main path 6 (e): {second}, LATEST {latest}")
    print(f"# main path 6 launches by stage: {stages}", flush=True)

    # every kernel the path launched, against its plain version on the
    # inputs it had in each stage (TF32 off, as for every kernel check)
    families = {"den": ("fact_fwd", "fact_bwd", "fact_fwd_bf16",
                        "fact_bwd_bf16"),
                "semiring": ("semiring_fwd", "semiring_bwd"),
                "viterbi": ("viterbi",)}
    checks = {"den": p6_den, "semiring": p6_semiring, "viterbi": p6_viterbi}
    inputs = cap.inputs()
    for stage, launched in stages.items():
        for family, names in families.items():
            ran = any(launched.get(k) for k in names)
            check(ran == ((stage, family) in inputs),
                  f"main path 6 {stage}: {family} launched {ran}, inputs "
                  f"captured {(stage, family) in inputs}")
    cap.calls.clear()
    out["checks"] = {}
    for key in list(inputs):
        stage, family = key
        out["checks"][key] = checks[family](stage, inputs.pop(key), dev)
        torch.cuda.empty_cache()
    out["stages"] = stages
    return out


# ----------------------------------------------------------------------
# Main path 8: a shared log-domain graph (bench.py --xlstream)
# ----------------------------------------------------------------------

XLSTREAM = (32, 150)    # bench.py --xlstream: B=32 utterances, T=150
SHIFT = -120.0          # the out-of-band copy's arc shift, in nats
DEAD_CHAIN = 8          # the infeasible check's entry chain: no path < 9


def counted(counters, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, {kernel: launches})."""
    reset_counts(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for c in counters for k, v in c.items() if v}


def value_and_grad(x, lens, batch, impl="auto"):
    """The denominator objective's value and gradient through the user's
    entry point (bench.py --xlstream: value_and_grad of chain_function):
    (objf, gradient)."""
    from pychain_tpu_torch.loss import chain_function
    objf = chain_function(x, lens, batch, impl=impl)
    objf.backward()
    grad, x.grad = x.grad, None
    return float(objf.detach()), grad


def log_step(label, x, lens, batch, counters, want):
    """Main path 8's step on ``batch``: once with the counts reset before
    and read after (they must be ``want``: one launch of each kernel of
    its tier and none of any other), then best of 3 after a warm-up:
    (objf, launches, ms, utts/s)."""
    (objf, grad), launches = counted(
        counters, lambda: value_and_grad(x, lens, batch))
    check(np.isfinite(objf) and bool(torch.isfinite(grad).all()),
          f"{label}: objf {objf!r} or its gradient is not finite")
    check(launches == want, f"{label}: launches {launches}, want {want}")
    ms, all_ms, peak, _ = step_stats(lambda: value_and_grad(x, lens, batch))
    ups = x.shape[0] / (ms / 1e3)
    print(f"# {label}: objf {objf!r}, launches {launches}; step (value and "
          f"gradient) {ms:.3f} ms best of {all_ms}, {ups:.1f} utts/s, peak "
          f"{peak / 1e9:.3f} GB", flush=True)
    return objf, launches, ms, ups


def log_kernel_rows(label, fa, px, lens, launches, fwd, bwd, run, names,
                    cluster=None):
    """The kernel pair of main path 8's tier at leaky 0 against its plain
    version (compare: debug False and True; the forward's alpha' stream;
    in the fast mode bit for bit), each kernel's time alone, its plain
    sweep's and its bound: {name: row fields}."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    B, T, P = px.shape
    errs = worst(compare(fa, px, lens, 0.0, debug, label, run,
                         cluster=cluster) for debug in (False, True))
    a_err, a_excess = alpha_err(fa, px, lens, 0.0, label, fwd,
                                cluster=cluster)
    times = pair_times(fa, px, lens, 0.0, fwd, bwd, 5, cluster=cluster)
    fb, fo, bb, bo = fact_bytes_ops(fa, fk.graph_for(fa), lens, T, P)
    rows = {}
    for i, name in enumerate(names):
        err = (max(a_err, errs["objf_rel"]) if i == 0 else
               max(errs["gamma_abs"], errs["alpha_beta_abs"],
                   errs["gamma_sum_abs"]))
        rows[name] = {"ms": times[i], "plain_ms": times[2 + i],
                      "bound": bound((fb, bb)[i], (fo, bo)[i]),
                      "bytes": (fb, bb)[i], "ops": (fo, bo)[i],
                      "max_abs_err": err,
                      "entry_excess": a_excess if i == 0
                      else errs["gamma_excess"],
                      "launches": launches.get(name, 0)}
    print(f"# {label} at leaky 0: " + "; ".join(
        f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.1f} ms, bound "
        f"{r['bound'][0]:.4f} ms by {r['bound'][1]}, err "
        f"{r['max_abs_err']:.3e})" for k, r in rows.items()), flush=True)
    return rows


def shifted_graph(fst, shift):
    """The log-domain ChainGraph of ``fst`` with every arc weight moved by
    ``shift`` nats (out of float32's exp-safe band for -120)."""
    from pychain_tpu_torch import ChainGraph
    g = ChainGraph(fst, log_domain=True)
    g.forward_transition_probs = g.forward_transition_probs + \
        np.float32(shift)
    g.backward_transition_probs = g.backward_transition_probs + \
        np.float32(shift)
    return g


def infeasible_check(den_fst, P, dev, counters, tile_dtype=None):
    """A column no path can take through the kernel tier: the headline
    graph entered through a chain of DEAD_CHAIN states at B=32, T=150,
    column 3 of length DEAD_CHAIN; its objf -inf, gamma 0, ok False, and
    every other column bit for bit as in the same batch with column 3
    alive (length T): no NaN crosses columns.  (A batch one column
    narrower gives the same gamma but not always the same objf bits:
    the objective's sum over frames is a PyTorch row reduction, whose
    order may follow the batch's width.)"""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.loss import chain_function_with_aux
    from pychain_tpu_torch.utils.testgraphs import entry_chain_fst
    B, T = XLSTREAM
    graph = ChainGraph(entry_chain_fst(den_fst, DEAD_CHAIN), log_domain=True)
    batch = ChainGraphBatch(graph, B, tile_dtype=tile_dtype, device=dev)
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(83), device=dev)
    alive = torch.full((B,), T)
    lens = alive.clone()
    lens[3] = DEAD_CHAIN
    live = [b for b in range(B) if b != 3]
    res, launches = counted(counters, lambda: chain_function_with_aux(
        x, lens, batch)[1])
    ref = chain_function_with_aux(x, alive, batch)[1]
    torch.cuda.synchronize()
    label = f"main path 8 infeasible column ({tile_dtype or 'float32'})"
    check(res.objf[3].item() == float("-inf") and not bool(res.ok[3])
          and float(res.gamma[3].abs().sum()) == 0.0,
          f"{label}: dead column objf {res.objf[3].item()!r}, ok "
          f"{bool(res.ok[3])}, gamma sum {float(res.gamma[3].abs().sum())}")
    same = {n: torch.equal(getattr(res, n)[live], getattr(ref, n)[live])
            for n in ("objf", "gamma", "alpha_beta", "gamma_sum", "ok")}
    check(all(same.values()), f"{label}: live columns differ from the batch "
          f"with column 3 alive: {same}")
    check(bool(res.ok[live].all()), f"{label}: live ok {res.ok.tolist()}")
    print(f"# {label}: column 3 (length {DEAD_CHAIN} < {DEAD_CHAIN + 1}) "
          f"objf -inf, gamma 0, ok False; the other {B - 1} bit for bit as "
          f"with column 3 alive; launches {launches}", flush=True)
    return launches


def main_path_8(den_fst, P, dev, counters):
    """Main path 8: bench.py --xlstream's denominator, the headline graph
    as a shared log-domain graph (log_semantics: leaky 0) at B=32,
    T=150, on B1/B2 in both precisions, with the gather engine beside it
    and the guards.  Returns the rows' fields and the step figures."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.loss import (chain_function_with_aux,
                                        dispatch_arrays, resolved_engine)
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.ops.factorized import FactorizedArrays
    B, T = XLSTREAM
    t0 = time.perf_counter()
    graph = ChainGraph(den_fst, log_domain=True)
    batch = ChainGraphBatch(graph, B, device=dev)
    fa = dispatch_arrays(batch)
    props = torch.cuda.get_device_properties(0)
    plan = {f: fk.cluster_size(B, props, fa, f) for f in
            ("fact_fwd", "fact_bwd")}
    print(f"# main path 8 graph: S={graph.num_states} "
          f"K={graph.num_transitions} P={P} s_pad={fa.s_pad}; dispatch "
          f"{type(fa).__name__} log_semantics={fa.log_semantics} "
          f"log_shifts={fa.log_shifts} tier {resolved_engine(fa)!r}, plan "
          f"{plan}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    check(isinstance(fa, FactorizedArrays) and fa.log_semantics
          and fa.log_shifts is None and fa.s_pad == 3072,
          "main path 8: auto must give the factorized-log form")
    check(resolved_engine(fa) == "pallas", "main path 8: tier "
          f"{resolved_engine(fa)!r}")
    check(plan["fact_fwd"] == 2, f"main path 8: fact_fwd on {plan} CTAs")
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(80), device=dev).requires_grad_(True)
    lens = torch.full((B,), T, dtype=torch.int32)
    lens_dev = torch.full((B,), T, device=dev)
    want = {"fact_fwd": 1, "fact_bwd": 1}
    objf, launches, ms, ups = log_step(
        "main path 8 (shared log-domain graph)", x, lens, batch, counters,
        want)
    px = torch.exp(torch.clamp(x.detach(), -30.0, 30.0))
    rows = log_kernel_rows("main path 8", fa, px, lens_dev, launches,
                           fk.fact_fwd, fk.fact_bwd, None,
                           ("fact_fwd", "fact_bwd"))

    # the fast mode: B1/B2's bfloat16 forms, bit for bit
    fast = ChainGraphBatch(graph, B, tile_dtype="bfloat16", device=dev)
    fa_fast = dispatch_arrays(fast)
    check(fa_fast.log_semantics and resolved_engine(fa_fast) == "pallas",
          "main path 8 fast: tier")
    fast_plan = {f: fk._form_plan(f, B, props, fa_fast, None)
                 for f in ("fact_fwd", "fact_bwd")}
    print(f"# main path 8 fast plan {fast_plan} (the fast pair's group "
          "form at G = 1 within the cluster forms' reach)", flush=True)
    if props.multi_processor_count == 132:
        check(fast_plan == {"fact_fwd": (1, 2), "fact_bwd": (1, 2)},
              f"main path 8 fast: plan {fast_plan}")
    f_objf, f_launches, f_ms, f_ups = log_step(
        "main path 8 fast (shared log-domain graph, bfloat16 tiles)", x,
        lens, fast, counters, {"fact_fwd_bf16": 1, "fact_bwd_bf16": 1})
    check(abs(f_objf - objf) <= BF16_BUDGET["objf_rel"] * abs(objf),
          f"main path 8 fast: objf {f_objf} vs float32 {objf}")
    rows.update(log_kernel_rows("main path 8 fast", fa_fast, px, lens_dev,
                                f_launches, fk.fact_fwd, fk.fact_bwd, None,
                                ("fact_fwd_bf16", "fact_bwd_bf16")))
    for f, name in (("fact_fwd", "fact_fwd_bf16"),
                    ("fact_bwd", "fact_bwd_bf16")):
        p = fast_plan[f]
        rows[name]["cluster"] = list(p) if isinstance(p, tuple) else p
    if isinstance(fast_plan["fact_bwd"], tuple):
        # the forms the group form replaced on the same inputs, beside it:
        # fact_fwd's cluster form at C = 2, fact_bwd's one block a column
        one = pair_times(fa_fast, px, lens_dev, 0.0,
                         functools.partial(fk.fact_fwd, cluster=2),
                         functools.partial(fk.fact_bwd, cluster=1), 5,
                         plain=False)
        rows["fact_fwd_bf16"]["cluster_form_ms"] = one[0]
        rows["fact_bwd_bf16"]["one_block_ms"] = one[1]
        print(f"# main path 8 fast: fact_fwd_bf16 at {fast_plan['fact_fwd']}"
              f" {rows['fact_fwd_bf16']['ms']:.3f} ms [the cluster form at "
              f"C=2 {one[0]:.3f}]; fact_bwd_bf16 at {fast_plan['fact_bwd']}"
              f" {rows['fact_bwd_bf16']['ms']:.3f} ms [one block a column "
              f"{one[1]:.3f}]; {card_line()}", flush=True)
    del fast, fa_fast

    # the gather A/B (bench.py:341-355): impl="gather" on the same batch
    (g_objf, g_grad), g_ms = event_ms(
        lambda: value_and_grad(x, lens, batch, "gather"))
    _, g_ms2 = event_ms(lambda: value_and_grad(x, lens, batch, "gather"))
    g_rel = abs(g_objf - objf) / abs(objf)
    _, k_grad = value_and_grad(x, lens, batch)
    g_abs = absmax(g_grad, k_grad)
    ga = chain_function_with_aux(x.detach(), lens, batch, impl="gather")[1]
    gb = chain_function_with_aux(x.detach(), lens, batch, impl="gather")[1]
    kf = chain_function_with_aux(x.detach(), lens, batch)[1]
    torch.cuda.synchronize()
    g_seq = rel(ga.objf, kf.objf)
    print(f"# main path 8 gather A/B: impl='gather' {min(g_ms, g_ms2):.1f} "
          f"ms ({B / (min(g_ms, g_ms2) / 1e3):.1f} utts/s) against "
          f"factorized-log {ms:.3f} ms ({ms and min(g_ms, g_ms2) / ms:.1f}x); "
          f"objf rel diff {g_rel:.3e} (per sequence {g_seq:.3e}), gradient "
          f"max-abs {g_abs:.3e}; gamma "
          f"bit-identical on a rerun: {torch.equal(ga.gamma, gb.gamma)}",
          flush=True)
    check(max(g_rel, g_seq) <= TOL and g_abs <= TOL, f"main path 8 gather "
          f"A/B: objf rel {g_rel:.3e} / {g_seq:.3e}, gradient {g_abs:.3e}")
    check(torch.equal(ga.gamma, gb.gamma) and torch.equal(ga.objf, gb.objf),
          "main path 8: the gather engine is not deterministic")
    del ga, gb, kf, g_grad, k_grad

    # the guards: a dead column, an out-of-band copy, the cluster tier
    infeasible_check(den_fst, P, dev, counters)
    infeasible_check(den_fst, P, dev, counters, "bfloat16")
    moved = ChainGraphBatch(shifted_graph(den_fst, SHIFT), B, device=dev)
    fm = dispatch_arrays(moved)
    check(fm.log_shifts is not None and resolved_engine(fm) == "pallas",
          f"main path 8 out of band: log_shifts {fm.log_shifts}")
    o_objf = chain_function_with_aux(x.detach(), lens, moved)[1].objf
    base = chain_function_with_aux(x.detach(), lens, batch)[1].objf
    want_o = base.double() + SHIFT * T
    o_rel = float(((o_objf.double() - want_o).abs() / want_o.abs()).max())
    print(f"# main path 8 out of band (every arc {SHIFT} nats): log_shifts "
          f"{fm.log_shifts.tolist()}; objf rel diff to the unshifted "
          f"{SHIFT} * L: {o_rel:.3e}", flush=True)
    check(o_rel <= TOL, f"main path 8 out of band: rel {o_rel:.3e}")
    del moved, fm, x, px
    torch.cuda.empty_cache()

    # the cluster tier: main path 4's graph in the log domain, B=8, T=100
    Bc, Tc = 8, 100
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    fst4, P4 = denominator_fst(num_phones=6000, states_per_phone=2,
                               num_pdfs=3000, seed=0, bigram_fanout=30,
                               forward_pdf_mode="separate")
    c_batch = ChainGraphBatch(ChainGraph(fst4, log_domain=True), Bc,
                              device=dev)
    fc = dispatch_arrays(c_batch)
    check(fc.log_semantics and resolved_engine(fc) == "stream",
          f"main path 8 cluster tier: {resolved_engine(fc)!r}")
    plans = stream_plans(fc, Bc, "main path 8 cluster tier")
    xc = torch.randn(Bc, Tc, P4, generator=torch.Generator(device=dev)
                     .manual_seed(84), device=dev).requires_grad_(True)
    lens_c = torch.full((Bc,), Tc, dtype=torch.int32)
    c_objf, c_launches, c_ms, _ = log_step(
        "main path 8 cluster tier (12k-state graph, log domain, B=8, "
        "T=100)", xc, lens_c, c_batch, counters,
        {"stream_fwd": 1, "stream_bwd": 1})
    pxc = torch.exp(torch.clamp(xc.detach(), -30.0, 30.0))
    c_rows = log_kernel_rows("main path 8 cluster tier", fc, pxc,
                             torch.full((Bc,), Tc, device=dev), c_launches,
                             stk.stream_fwd, stk.stream_bwd,
                             stk.forward_backward_prob_stream,
                             ("stream_fwd", "stream_bwd"))
    for name, r in c_rows.items():
        r.update(cluster=plans[name]["cluster"],
                 columns=plans[name]["columns"])
    del c_batch, fc, xc, pxc
    torch.cuda.empty_cache()
    return {"rows": rows, "cluster_rows": c_rows, "ms": ms, "ups": ups,
            "fast_ms": f_ms, "fast_ups": f_ups, "gather_ms": min(g_ms,
                                                                 g_ms2),
            "gather_rel": max(g_rel, g_seq), "cluster_ms": c_ms,
            "plan": plan}


def gather_beside_kernels(dev, head_den, P, counters):
    """The generic gather engine beside the kernels: bench.py --xl's
    batch against the semiring kernels, main path 1's denominator
    against B1/B2 (objf rel and gamma max-abs <= 1e-4, both times), and
    a list of per-sequence prob-domain graphs (tools/prob_list_gather.py's
    size: B=8, S=2000, K=13,000, T=300) through impl="gather", on the
    card and on the CPU (1e-4).  Returns the figures printed, and the
    prob-domain list's card batch, x, lengths and gather result under
    "prob list batch" (main path 9 (d) runs dense_list on them)."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.loss import chain_function_with_aux
    from pychain_tpu_torch.utils.testgraphs import (denominator_fst,
                                                    random_fst)
    out = {}
    B, T = 128, 500
    for label, batch, Px in (
            ("xl (B=128 T=500 random_fst(1000, 3000, 5))",
             list_batch([random_fst(num_states=1000, num_pdfs=3000,
                                    max_arcs_per_state=5, seed=s)
                         for s in range(B)], dev)[0], 3000),
            ("main path 1's denominator (B=128 T=500)",
             ChainGraphBatch(head_den, B, device=dev), P)):
        x = torch.randn(B, T, Px, generator=torch.Generator(device=dev)
                        .manual_seed(85), device=dev)
        lens = torch.full((B,), T, dtype=torch.int32)
        # a first call of each builds what the batch keeps (the kernels'
        # graph and lists, the gather engine's arrays and plans)
        for impl in ("auto", "gather"):
            chain_function_with_aux(x, lens, batch, impl=impl)
        k, k_ms = event_ms(lambda: chain_function_with_aux(x, lens,
                                                           batch)[1])
        (g, launches), g_ms = event_ms(lambda: counted(
            counters, lambda: chain_function_with_aux(x, lens, batch,
                                                      impl="gather")[1]))
        objf_rel = rel(g.objf, k.objf)
        gamma_abs = absmax(g.gamma, k.gamma)
        print(f"# gather beside the kernels, {label}: kernels {k_ms:.1f} "
              f"ms, impl='gather' {g_ms:.1f} ms ({g_ms / k_ms:.1f}x), "
              f"launches of any kernel under gather {launches}; objf rel "
              f"{objf_rel:.3e}, gamma max-abs {gamma_abs:.3e}", flush=True)
        check(not launches, f"{label}: impl='gather' launched {launches}")
        check(objf_rel <= TOL and gamma_abs <= TOL, f"{label}: gather vs "
              f"kernels objf rel {objf_rel:.3e}, gamma {gamma_abs:.3e}")
        check(bool(g.ok.all()), f"{label}: gather ok {g.ok.tolist()}")
        out[label] = (k_ms, g_ms)
        del x, k, g, batch
        torch.cuda.empty_cache()
    # per-sequence prob-domain graphs: only the gather engine takes them
    Bp, Tp = 8, 300
    graphs = [ChainGraph(denominator_fst(num_phones=1000,
                                         states_per_phone=2, seed=s,
                                         bigram_fanout=10)[0])
              for s in range(Bp)]
    rng = np.random.RandomState(0)
    Pp = 2000
    x = torch.from_numpy(rng.randn(Bp, Tp, Pp).astype(np.float32) * 0.2)
    lens = torch.from_numpy(np.clip(rng.randint(Tp // 2, Tp + 1, size=Bp),
                                    1, Tp))
    res = []
    K = max(g.num_transitions for g in graphs)
    S = max(g.num_states for g in graphs)
    for d in (dev, torch.device("cpu")):
        batch = ChainGraphBatch(graphs, max_num_transitions=K,
                                max_num_states=S, device=d)
        batch.graph_arrays()           # the arrays and plans, built once
        if d.type == "cuda":
            chain_function_with_aux(x.to(d), lens, batch,
                                    impl="gather")           # warm-up
            (r, launches), p_ms = event_ms(lambda: counted(
                counters, lambda: chain_function_with_aux(
                    x.to(d), lens, batch, impl="gather")[1]))
            card_batch = batch
        else:
            t0 = time.perf_counter()
            r = chain_function_with_aux(x, lens, batch, impl="gather")[1]
            cpu_ms = (time.perf_counter() - t0) * 1e3
        res.append(r)
    got, ref = res
    objf_rel = rel(got.objf.cpu(), ref.objf)
    gamma_abs = absmax(got.gamma.cpu(), ref.gamma)
    print(f"# prob-domain list (B={Bp} S={graphs[0].num_states} "
          f"K<={max(g.num_transitions for g in graphs)} T={Tp} P={Pp}) "
          f"through impl='gather': card {p_ms:.1f} ms, host "
          f"{cpu_ms:.1f} ms, launches {launches}; card against CPU objf "
          f"rel {objf_rel:.3e}, gamma max-abs {gamma_abs:.3e}", flush=True)
    check(bool(torch.isfinite(got.objf).all()) and bool(got.ok.all()),
          f"prob-domain list: objf {got.objf.tolist()}, ok "
          f"{got.ok.tolist()}")
    check(objf_rel <= TOL and gamma_abs <= TOL and not launches,
          f"prob-domain list: card vs CPU {objf_rel:.3e}, {gamma_abs:.3e}")
    out["prob list"] = (p_ms, cpu_ms)
    out["prob list batch"] = (card_batch, x.to(dev), lens, got, graphs)
    return out


def viterbi_of_graph_arrays(flat_batch, x, lens, vit_counter):
    """viterbi_align given the GraphArrays of main path 3's batch equals
    viterbi_align given the batch, bit for bit, on the viterbi kernel."""
    from pychain_tpu_torch.loss import graph_arrays
    from pychain_tpu_torch.ops.viterbi import viterbi_align
    ga = graph_arrays(flat_batch)
    (a, n), _ = event_ms(lambda: counted((vit_counter,), lambda:
                                         viterbi_align(x, lens, ga)))
    b = viterbi_align(x, lens, flat_batch)
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)
    print(f"# viterbi_align of main path 3's batch as GraphArrays: launches "
          f"{n}, equal to the batch's alignment: {same}", flush=True)
    check(same and n == {"viterbi": 1}, "viterbi_align(GraphArrays) differs "
          "from viterbi_align(batch)")


# ----------------------------------------------------------------------
# The examples: the graph-building CLI and the three small examples
# ----------------------------------------------------------------------

def examples_phase(counters):
    """python -m pychain_tpu_torch.tools.build_graphs on a synthetic data
    dir (the text wav_to_train.synth_corpus writes; den.fst and num.scp
    read back through the port's readers), then data_pipeline,
    train_tdnn and wav_to_train in process with --device at its default
    (the card), each's launches counted; each must print finite losses,
    and wav_to_train's must fall (it checks, as the JAX example does)."""
    import tempfile
    from pychain_tpu_torch.data import read_scp
    from pychain_tpu_torch.examples import (data_pipeline, train_tdnn,
                                            wav_to_train)
    from pychain_tpu_torch.graphs import FST
    from pychain_tpu_torch.tools import build_graphs
    work = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    out = {}
    try:
        wav_to_train.synth_corpus(work, utts=16, num_phones=8)
        _, n = counted(counters, lambda: build_graphs.main(
            ["--data-dir", work]))
        den = FST.read(os.path.join(work, "den.fst"))
        nums = [FST.read_ark(p, o)
                for _, p, o in read_scp(os.path.join(work, "num.scp"))]
        check(den.num_states > 0 and len(nums) == 16 and not n,
              f"build_graphs: den {den.num_states} states, {len(nums)} "
              f"numerators, launches {n}")
        print(f"# build_graphs: den.fst {den.num_states} states "
              f"{den.num_arcs} arcs, {len(nums)} numerators read back",
              flush=True)
        for name, fn in (
                ("data_pipeline", lambda: data_pipeline.main([])),
                ("train_tdnn", lambda: train_tdnn.main(
                    ["--steps", "12", "--verbose", "0"])),
                ("wav_to_train", lambda: wav_to_train.main(
                    ["--data-dir", os.path.join(work, "wav")]))):
            t0 = time.perf_counter()
            res, launches = counted(counters, fn)
            losses = ([r[2] for r in res] if name == "data_pipeline"
                      else res["losses"])
            secs = time.perf_counter() - t0
            print(f"# example {name} on the card: losses {losses}; "
                  f"launches {launches}; {secs:.1f} s", flush=True)
            check(len(losses) > 0 and all(np.isfinite(losses)),
                  f"{name}: losses {losses}")
            check(launches, f"{name}: launched no kernel on the card")
            out[name] = {"losses": losses, "launches": launches,
                         "s": secs}
        check(out["wav_to_train"]["losses"][-1]
              < out["wav_to_train"]["losses"][0], "wav_to_train: the loss "
              "did not fall")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# Main path 9: the other list engines and data parallelism
# ----------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT = 300     # seconds a multi-rank phase's ranks may take
# a rank of an example under a launcher: its result's losses and every
# kernel wrapper's launches, as one JSON line
EXAMPLE_RANK = (
    "import json, sys\n"
    "from pychain_tpu_torch.examples import {mod} as m\n"
    "from pychain_tpu_torch.ops import fact_kernels, semiring_kernels, "
    "stream_kernels, viterbi_kernels\n"
    "r = m.main(sys.argv[1:])\n"
    "n = {{}}\n"
    "for k in (fact_kernels, semiring_kernels, stream_kernels, "
    "viterbi_kernels):\n"
    "    n.update({{a: b for a, b in k.LAUNCHES.items() if b}})\n"
    "print(json.dumps({{'example': {{'losses': r['losses'], 'dp': r['dp'], "
    "'launches': n}}}}), flush=True)\n")


def run_ranks(label, argv, n, path="main path 9", **env_extra):
    """``python argv`` in n processes, each started as torchrun starts a
    rank (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; and ``env_extra``), under one time limit.  A rank that fails or hangs
    fails the phase (every process is killed first).  Returns each
    rank's JSON lines, parsed."""
    import socket
    import tempfile
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       TMPDIR=tempfile.gettempdir(),
                       PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""), **env_extra)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=REPO, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        deadline = time.perf_counter() + RANK_TIMEOUT
        logs = []
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.perf_counter())))
            except subprocess.TimeoutExpired:
                fail(f"{path} {label}: rank {r} of {n} ran past "
                     f"{RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{path} {label}: rank {r} of {n} "
              f"exited {p.returncode}:\n{se[-3000:]}")
        out.append([json.loads(line) for line in so.splitlines()
                    if line.startswith("{")])
    return out


def add_launches(total, launched):
    for k, v in launched.items():
        if v:
            total[k] = total.get(k, 0) + v


def p9_sharded():
    """(a) ShardedChainLoss at main path 1's width (the headline
    denominator, B=128 linear numerators, T=150), float32 and fast, on
    a group of one rank (NCCL; equal to ChainLoss bit for bit) and on 2
    gloo ranks sharing the card (64 rows each: loss within 1e-6
    relative, each rank's gradient rows within 1e-4), and (c) the 2
    ranks' sharded checkpoint round trip.  Returns the figures and the
    kernel launches of the sharded steps."""
    ckpt = os.path.join(REPO, ".chip_smoke_ckpt", "sharded")
    shutil.rmtree(ckpt, ignore_errors=True)
    out, launches = {}, {}
    try:
        for n in (1, 2):
            t0 = time.perf_counter()
            ranks = run_ranks(
                f"(a) {n} rank(s)",
                ["-m", "pychain_tpu_torch.tools.sharded_check",
                 "--precision", "both"]
                + (["--ckpt", ckpt] if n > 1 else []),
                n)
            secs = time.perf_counter() - t0
            for lines in ranks:
                for line in lines:
                    r = line["sharded_check"]
                    key = (n, r["precision"])
                    out.setdefault(key, []).append(r)
                    add_launches(launches, r["launches"])
            print(f"# main path 9 (a) on {n} rank(s): {secs:.1f} s of "
                  "command", flush=True)
    finally:
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    for (n, prec), rs in sorted(out.items()):
        for r in rs:
            print(f"# main path 9 (a) {prec}, rank {r['rank']} of {n} "
                  f"({r['backend']}, {r['rows']} rows): loss {r['loss']!r} "
                  f"(ChainLoss {r['plain_loss']!r}, rel {r['loss_rel']:.3e}, "
                  f"bit-identical {r['loss_bitwise']}); gradient rows "
                  f"max-abs {r['grad_abs']:.3e}, bit-identical "
                  f"{r['grad_bitwise']}; BatchNorm over the ranks "
                  f"{r.get('batchnorm')}; step {r['ms']:.3f} ms sharded, "
                  f"{r['plain_ms']:.3f} ms ChainLoss on B=128, T={r['T']} "
                  f"in the same process; launches "
                  f"{r['launches']} over {r['steps']} steps", flush=True)
            pair = (("fact_fwd", "fact_bwd") if prec == "parity"
                    else ("fact_fwd_bf16", "fact_bwd_bf16"))
            check(all(r["launches"].get(k) == r["steps"] for k in pair)
                  and r["finite"], f"main path 9 (a) {prec} rank "
                  f"{r['rank']}/{n}: launches {r['launches']}")
            bn = r.get("batchnorm")     # with the first precision's line
            check(prec != "parity" or (bn["out_abs"] <= 1e-5
                                       and bn["stats_abs"] <= 1e-6),
                  f"main path 9 (a) BatchNorm over {n} rank(s): {bn}")
            if n == 1:
                check(r["backend"] == "nccl" and r["loss_bitwise"]
                      and r["grad_bitwise"], f"main path 9 (a) {prec}, one "
                      f"rank: {r}")
            else:
                check(r["backend"] == "gloo" and r["loss_rel"] <= 1e-6
                      and r["grad_abs"] <= TOL, f"main path 9 (a) {prec}, "
                      f"{n} ranks: {r}")
                c = r.get("ckpt")    # with the first precision's line
                check(prec != "parity" or (
                    c and c["step"] == 7 and c["rows_equal"]
                    and c["whole_equal"] and c["scalar"] == 7.0),
                    f"main path 9 (c) rank {r['rank']}: {c}")
        check(len({r["loss"] for r in rs}) == 1,
              f"main path 9 (a) {prec}: the ranks' losses differ")
    print("# main path 9 (c): save_sharded / restore_sharded on 2 ranks: "
          "each rank's rows back bit for bit, the whole array into a "
          "plain tensor, the scalar", flush=True)
    return out, launches


def example_ranks(label, mod, argv, n):
    """``mod``'s main on n ranks under a launcher, TF32 off
    (NVIDIA_TF32_OVERRIDE=0: cuDNN picks its algorithms by batch size, and
    TF32 rounding would hide the comparison): each rank's losses and
    launches."""
    return [lines[-1]["example"] for lines in run_ranks(
        label, ["-c", EXAMPLE_RANK.format(mod=mod), *argv], n,
        NVIDIA_TF32_OVERRIDE="0")]


def p9_recipe(counters, tf32_defaults, p6_bench):
    """(b) --dp: the recipe at main path 6 (d)'s width on a group of one
    rank (in this process, NCCL, PyTorch's TF32 defaults as in (d); (d)'s
    12 steps with its 2 warm-up steps, so that both steady-state windows
    are the same 10 steps; the 12 losses against (d)'s, 1e-5), then at a
    small width
    (B=8, 16 utterances) and train_tdnn (B=8, 64 utterances), each on 2
    gloo ranks sharing the card against one process on the whole batch
    (3 steps, 1e-5, TF32 off in both)."""
    from pychain_tpu_torch.examples import train_corpus as tc
    from pychain_tpu_torch.examples import train_tdnn as tt
    out, launches = {}, {}
    argv = P6_WIDTH + ["--steps", "12", "--warmup-steps", "2", "--dp"]
    print("# main path 9 (b): python -m pychain_tpu_torch.examples."
          f"train_corpus {' '.join(argv)}", flush=True)
    try:
        with tf32(*tf32_defaults):
            t0 = time.perf_counter()
            res, launched = counted(counters, lambda: tc.main(argv))
            secs = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    add_launches(launches, launched)
    rel_d = max(abs(a - b) / max(1.0, abs(b)) for a, b in
                zip(res["losses"], p6_bench["losses"]))
    print(f"# main path 9 (b) the recipe at main path 6 (d)'s width, --dp "
          f"on {res['dp']} rank (nccl), 12 steps, 10 in the steady state "
          f"as in (d): {res['utts_per_s']!r} utts/s (main path 6 (d) "
          f"{p6_bench['utts_per_s']!r}); losses {res['losses']} against "
          f"(d)'s {p6_bench['losses']}, rel {rel_d:.3e}; {secs:.1f} s "
          f"((d) {p6_bench['seconds']:.1f} s)", flush=True)
    check(res["dp"] == 1 and len(res["losses"]) == 12 and rel_d <= 1e-5
          and launched.get("fact_fwd_bf16") == launched.get("fact_bwd_bf16")
          == 12, f"main path 9 (b) width: {res['losses']}, launches "
          f"{launched}")
    out["width"] = {"utts_per_s": res["utts_per_s"], "rel": rel_d,
                    "launches": launched}
    small = ["--steps", "3", "--batch-size", "8", "--corpus-utts", "16",
             "--warmup-steps", "1", "--diag-every", "2"]
    for name, mod, argv, fn in (("recipe", "train_corpus", small, tc.main),
                                ("train_tdnn", "train_tdnn",
                                 ["--steps", "3", "--verbose", "0"],
                                 tt.main)):
        t0 = time.perf_counter()
        ranks = example_ranks(f"(b) {name}", mod, argv + ["--dp"], 2)
        secs = time.perf_counter() - t0
        with tf32(False, False):
            one = fn(argv)["losses"]
        rel = max(abs(a - b) / max(1.0, abs(b))
                  for a, b in zip(ranks[0]["losses"], one))
        for r in ranks:
            add_launches(launches, r["launches"])
        print(f"# main path 9 (b) {name} --dp on 2 gloo ranks sharing the "
              f"card: losses {ranks[0]['losses']}, one process "
              f"{one}, rel {rel:.3e}; launches by rank "
              f"{[r['launches'] for r in ranks]}; {secs:.1f} s", flush=True)
        check(all(r["dp"] == 2 and r["losses"] == ranks[0]["losses"]
                  and r["launches"] for r in ranks) and len(one) == 3
              and rel <= 1e-5, f"main path 9 (b) {name}: {ranks}, {one}")
        out[name] = {"rel": rel, "s": secs}
    return out, launches


def p9_dense_list(batch, x, lens, gather_res, gather_ms, graphs):
    """(d) dense_list at the prob-domain list of the gather A/B (B=8,
    S=2000, K=13,000, T=300, P=2000): auto's choice on the card, against
    the gather engine (objf 1e-5 relative, gamma 1e-4), gamma
    bit-identical on a rerun, and with bfloat16 blocks (within the
    bfloat16 budget of float32)."""
    from pychain_tpu_torch import ChainGraphBatch
    from pychain_tpu_torch.loss import chain_function_with_aux, \
        dispatch_arrays
    from pychain_tpu_torch.ops.dense_list import DenseListArrays
    t0 = time.perf_counter()
    arrs = dispatch_arrays(batch, "auto")
    build_s = time.perf_counter() - t0
    check(isinstance(arrs, DenseListArrays), f"main path 9 (d): auto chose "
          f"{type(arrs).__name__} on the card")
    chain_function_with_aux(x, lens, batch)                # warm-up
    got, ms = event_ms(lambda: chain_function_with_aux(x, lens, batch)[1])
    again = chain_function_with_aux(x, lens, batch)[1]
    objf_rel = rel(got.objf, gather_res.objf)
    gamma_abs = absmax(got.gamma, gather_res.gamma)
    same = (torch.equal(got.gamma, again.gamma)
            and torch.equal(got.objf, again.objf))
    fast = ChainGraphBatch(graphs, max_num_transitions=batch.num_transitions,
                           max_num_states=batch.num_states,
                           tile_dtype="bfloat16", device=batch.device)
    chain_function_with_aux(x, lens, fast)
    f, f_ms = event_ms(lambda: chain_function_with_aux(x, lens, fast)[1])
    f_rel = rel(f.objf, got.objf)
    print(f"# main path 9 (d) dense_list (auto on the card: "
          f"{type(arrs).__name__}, S_pad {arrs.s_pad}, residual arcs "
          f"{arrs.res_src.shape[1]}, x_same {arrs.x_same}, built in "
          f"{build_s:.2f} s): {ms:.1f} ms against the gather engine's "
          f"{gather_ms:.1f} ms ({gather_ms / ms:.1f}x); objf rel "
          f"{objf_rel:.3e}, gamma max-abs {gamma_abs:.3e}, gamma "
          f"bit-identical on a rerun {same}; bfloat16 blocks {f_ms:.1f} ms, "
          f"objf rel to float32 {f_rel:.3e}", flush=True)
    check(objf_rel <= 1e-5 and gamma_abs <= TOL and same
          and bool(got.ok.all()) and f_rel <= BF16_BUDGET["objf_rel"],
          f"main path 9 (d): objf rel {objf_rel:.3e}, gamma "
          f"{gamma_abs:.3e}, rerun {same}, ok {got.ok.tolist()}, bf16 "
          f"{f_rel:.3e}")
    return {"ms": ms, "gather_ms": gather_ms, "bf16_ms": f_ms,
            "objf_rel": objf_rel, "gamma_abs": gamma_abs, "build_s": build_s}


def p9_leveled(batch, x, lens, counters):
    """(e) impl="leveled" (the JAX package's banded engine, "auto" in the
    port) at main path 3's constrained batch (tolerance 3, B=128,
    T=500): auto's arrays, one launch of each semiring kernel (counts
    reset before, read after), auto's bits, bit-identical on a rerun;
    its time."""
    from pychain_tpu_torch.loss import chain_function_with_aux, \
        dispatch_arrays
    from pychain_tpu_torch.ops.semiring import SemiringArrays
    auto = dispatch_arrays(batch, "auto")
    check(isinstance(auto, SemiringArrays)
          and dispatch_arrays(batch, "leveled") is auto,
          f"main path 9 (e): auto chose {type(auto).__name__}, leveled "
          f"{type(dispatch_arrays(batch, 'leveled')).__name__}")
    k = chain_function_with_aux(x, lens, batch)[1]     # auto; the warm-up
    (got, launched), ms = event_ms(lambda: counted(
        counters, lambda: chain_function_with_aux(x, lens, batch,
                                                  impl="leveled")[1]))
    again = chain_function_with_aux(x, lens, batch, impl="leveled")[1]
    as_auto = torch.equal(got.gamma, k.gamma) and torch.equal(got.objf,
                                                              k.objf)
    same = (torch.equal(got.gamma, again.gamma)
            and torch.equal(got.objf, again.objf))
    print(f"# main path 9 (e) impl=\"leveled\" at main path 3's batch "
          f"(B={x.shape[0]}, T={x.shape[1]}): {type(auto).__name__}, "
          f"launches {launched}, {ms:.3f} ms; auto's bits {as_auto}, "
          f"bit-identical on a rerun {same}", flush=True)
    check(as_auto and same and bool(got.ok.all())
          and launched == {"semiring_fwd": 1, "semiring_bwd": 1},
          f"main path 9 (e): auto's bits {as_auto}, rerun {same}, "
          f"launches {launched}")
    return {"ms": ms, "launches": launched}


# ----------------------------------------------------------------------
# Main path 10: the model axis (the TDNN's kernels over "mp")
# ----------------------------------------------------------------------

# main path 10 (b): the mp ranks sum partial products in another order
# than one process (the classifier's two halves of its input features,
# each conv input's gradient's two halves of the output channels), so
# their x and gradients differ from one process's in the last bits.  A
# loss on the same weights stays within 1e-5, and so do the three losses
# of a float32 run from the same seed.  In the fast mode B1/B2 round
# exp(x) to bfloat16 tiles, where a last-bit difference of x can move an
# entry by 2^-8: on an H100 (700 W) every parameter's first-step
# gradient stood 2.2e-4 to 3.2e-4 of its norm from one process's on the
# same weights, held to P10_FAST_GRAD_TOL, and the fast run's third loss
# 1.758e-05 (of max(1, |loss|)) from one process's, held to
# P10_FAST_LOSS_TOL.  A misplaced collective rule gives an mp-times or a
# partial gradient, half its norm or more apart, which both gradient
# limits catch.  The parameters after the steps are printed, not held:
# Adam's update ignores a gradient's scale, so they cannot show a wrong
# rule.  The SGD step of (a) and the CPU tests hold parameters to 1e-5.
P10_LOSS_TOL = 1e-5
P10_FAST_LOSS_TOL = 5e-5
P10_GRAD_TOL = 1e-5
P10_FAST_GRAD_TOL = 1e-3
P10_STEPS = 3
# (b)'s TDNN layers: bench.py --train's TDNN-512x5 cut to its first two
# (the width and the placement rule kept; gloo's bytes and time a step
# fall with the layers)
P10_LAYERS = 2


@contextlib.contextmanager
def env_set(**kv):
    """Environment variables set as given for the duration (subprocesses
    started meanwhile inherit them), and restored after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rel_norm(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def mp_pairs_identical(ranks):
    """Whether the plain (replicated) tensors of the mp ranks of each dp
    index hold the same bits."""
    by_dp = {}
    for r in ranks:
        by_dp.setdefault(r["dp_index"], []).append(r["plain"])
    return all(all(torch.equal(a[k], b[k]) for k in a)
               for a, *rest in by_dp.values() for b in rest)


def halves_ok(ranks):
    """Every placed kernel's local shard is 1/n_mp of it along its dim."""
    ok = True
    for r in ranks:
        for k in r["placed"]:
            whole_shape = tuple(r["state"][k].shape)
            loc = r["local_shapes"][k]
            diff = [i for i, (a, b) in enumerate(zip(whole_shape, loc))
                    if a != b]
            ok &= (len(diff) == 1
                   and loc[diff[0]] * r["n_mp"] == whole_shape[diff[0]])
    return ok


def p10_dryrun():
    """(a) tools/dryrun_multichip at n = 2 and 4 ((1 x 2) and (2 x 2) gloo
    ranks sharing the card, TF32 off), each rank's loss against one
    process's entry() on the card (1e-5 relative) and its state after the
    SGD step against one process's step (1e-5 of each tensor's norm);
    the local shards half of each kernel, the replicated tensors
    bit-identical across the mp ranks, B1/B2 (float32) launched on every
    rank.  Returns the figures and the ranks' launches."""
    from pychain_tpu_torch.tools import dryrun_multichip as dm
    with tf32(False, False):
        fn, args = dm.entry("cuda")
        entry_loss = float(fn(*args).detach())
        ref = dm.reference_step("cuda")
    out, launches = {}, {}
    for n in (2, 4):
        t0 = time.perf_counter()
        with env_set(NVIDIA_TF32_OVERRIDE="0"):
            ranks = dm.dryrun_multichip(n, timeout=RANK_TIMEOUT)
        secs = time.perf_counter() - t0
        for r in ranks:
            add_launches(launches, r["launches"])
        loss_rel = max(abs(r["loss"] - entry_loss) / abs(entry_loss)
                       for r in ranks)
        param_rel = max(rel_norm(r["state"][k], v) for r in ranks
                        for k, v in ref["state"].items())
        same, halves = mp_pairs_identical(ranks), halves_ok(ranks)
        mesh = f"{ranks[0]['n_dp']}x{ranks[0]['n_mp']}"
        print(f"# main path 10 (a) dryrun_multichip({n}) on {n} gloo ranks "
              f"sharing the card ({mesh}): losses "
              f"{[r['loss'] for r in ranks]} against one process's entry() "
              f"{entry_loss!r}, rel {loss_rel:.3e}; parameters after the "
              f"SGD step within {param_rel:.3e} of one process's (of their "
              f"norm); placed {ranks[0]['placed']}, halves {halves}, "
              f"replicated bit-identical across mp {same}; launches by rank "
              f"{[r['launches'] for r in ranks]}; {secs:.1f} s", flush=True)
        check(loss_rel <= 1e-5 and param_rel <= 1e-5 and same and halves
              and len(ranks[0]["placed"]) == 3
              and all(r["backend"] == "gloo" and r["launches"].get(
                  "fact_fwd") and r["launches"].get("fact_bwd")
                      for r in ranks),
              f"main path 10 (a) n={n}: loss rel {loss_rel:.3e}, params "
              f"{param_rel:.3e}, bit-identical {same}, halves {halves}, "
              f"{[(r['backend'], r['launches']) for r in ranks]}")
        out[n] = {"loss_rel": loss_rel, "param_rel": param_rel, "s": secs}
    return out, launches


def p10_problem(dev):
    """Main path 10 (b)'s problem, main path 5's: the headline denominator,
    40 seeded features at B=128, T=500, linear numerators (seed 18), and
    bench.py --train's TDNN-512x5 cut to P10_LAYERS layers (dropout 0)
    with mp_axis="mp"."""
    from pychain_tpu_torch import ChainGraph
    from pychain_tpu_torch.models import TDNNConfig
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    B, T = 128, 500
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    cfg = TDNNConfig(num_pdfs=P, hidden_dim=512,
                     kernel_sizes=(3,) * P10_LAYERS,
                     dilations=(1, 1, 3, 3, 3)[:P10_LAYERS],
                     strides=(1,) * P10_LAYERS, dropout=0.0, mp_axis="mp")
    feats = torch.randn(B, T, FEAT_DIM, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    return (ChainGraph(den_fst), cfg, feats,
            torch.full((B,), T, dtype=torch.int32),
            linear_batch(P, [T] * B, 18, dev))


def p10_train(model, den, feats, lengths, nums, mesh=None, precision="fast",
              keep=None):
    """P10_STEPS steps of main path 5's kind: the train-mode model,
    ChainLoss(den, precision=precision), backward, the gradients summed
    over the mesh's dp dim (of size 1 here: a check of the rule), Adam at
    1e-3 over model.parameters(); ``keep(model)`` before each step.
    Returns (losses, step ms by CUDA events, host ms, launches, the mp
    collectives' bytes in the last step, every parameter's first-step
    gradient gathered whole on the CPU)."""
    from pychain_tpu_torch import ChainLoss
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.parallel import model_parallel as mpl
    from pychain_tpu_torch.parallel import sum_gradients
    loss_fn = ChainLoss(den, precision=precision, device=feats.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses, ms, host_ms, grads = [], [], [], None
    fk.reset_launch_counts()
    for _ in range(P10_STEPS):
        if keep is not None:
            keep(model)
        mpl.reset_comm_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(feats, train=True), lengths, nums)
        loss.backward()
        if mesh is not None:
            sum_gradients(model.parameters(), mesh)
        opt.step()
        b.record()
        b.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ms.append(a.elapsed_time(b))
        losses.append(float(loss.detach()))
        if grads is None:
            grads = {k: mpl.whole(p.grad).cpu()
                     for k, p in model.named_parameters()}
    return (losses, ms, host_ms, {k: v for k, v in fk.launched().items()
                                  if v}, dict(mpl.COMM_BYTES), grads)


def p10_width_rank(ckpt, out_dir):
    """A rank of main path 10 (b) and (c), started by run_ranks, TF32 off
    and cuDNN deterministic: the TDNN-512 placed over a (1 x world)
    mesh's "mp" dim, P10_STEPS steps in the fast mode (its weights kept,
    gathered whole, before each step), the same from the same seed in
    float32, then the sharded checkpoint round trip of the fast run's
    model (into a placed model of another seed, and whole into a model
    without a mesh).  Writes the whole states and the plain tensors to
    out_dir/p10_rank<r>.pt and prints one JSON line."""
    from pychain_tpu_torch.models import TDNN
    from pychain_tpu_torch.parallel import (make_mesh, restore_sharded,
                                            save_sharded)
    from pychain_tpu_torch.parallel.model_parallel import (local, mp_shard,
                                                           whole)
    from pychain_tpu_torch.parallel.multihost import join_job
    from pychain_tpu_torch.utils.dist import set_stats_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rank, world, dev = join_job("cuda")
    # the mp ranks hold the same rows: statistics over this process's, as
    # in one process (join_job registers the whole group for --dp)
    set_stats_group(None)
    mesh = make_mesh(1, world, device=dev)
    den, cfg, feats, lengths, nums = p10_problem(dev)

    def placed_model(seed=0):
        return TDNN(cfg, FEAT_DIM, generator=torch.Generator().manual_seed(
            seed), mesh=mesh)

    def whole_state(m):
        return {k: whole(v).detach().cpu() for k, v in m.state_dict().items()}

    kept = []
    model = placed_model()
    losses, ms, host_ms, launched, comm, grads = p10_train(
        model, den, feats, lengths, nums, mesh,
        keep=lambda m: kept.append(whole_state(m)))
    state = model.state_dict()
    res = {"rank": rank, "world": world, "dp_index": 0, "n_mp": world,
           "backend": torch.distributed.get_backend(), "losses": losses,
           "ms": ms, "host_ms": host_ms, "launches": launched,
           "comm_bytes": comm,
           "placed": sorted(k for k, v in model.named_parameters()
                            if mp_shard(v) is not None),
           "local_shapes": {k: tuple(local(v).shape)
                            for k, v in state.items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    f32, f32_kept = placed_model(), []
    res["f32_losses"], _, _, f32_launched, _, f32_grads = p10_train(
        f32, den, feats, lengths, nums, mesh, precision="parity",
        keep=lambda m: f32_kept.append(whole_state(m)))
    res["f32_launches"] = f32_launched
    saved = {"state": whole_state(model), "kept": kept,
             "f32_state": whole_state(f32), "f32_step1": f32_kept[1],
             "grads1": grads, "f32_grads1": f32_grads,
             "plain": {k: local(v).detach().cpu() for k, v in state.items()
                       if mp_shard(v) is None}}
    del f32
    torch.save(saved, os.path.join(out_dir, f"p10_rank{rank}.pt"))
    save_sharded(ckpt, P10_STEPS, state)
    step, back = restore_sharded(ckpt, placed_model(5).state_dict())
    plain_cfg = dataclasses.replace(cfg, mp_axis=None)
    _, full = restore_sharded(ckpt, TDNN(plain_cfg, FEAT_DIM).state_dict())
    res["ckpt"] = {
        "step": step,
        "placed_back": all(torch.equal(local(back[k]), local(v))
                           and type(back[k]) is type(v)
                           for k, v in state.items()),
        "whole_back": all(torch.equal(full[k].cpu(), saved["state"][k])
                          for k in saved["state"])}
    torch.distributed.barrier()
    print(json.dumps({"p10": res}), flush=True)
    torch.distributed.destroy_process_group()


def p10_width(p5_step_ms):
    """(b) TDNN-512 (P10_LAYERS layers) with mp_axis="mp" at bench.py
    --train's width on 2 gloo ranks sharing the card ((1 x 2) mesh),
    against one process on
    the same seeds (TF32 off and cuDNN deterministic in both): each fast
    step's loss within P10_LOSS_TOL of one process's loss on the rank's
    own weights before that step; three steps from the same seed in
    float32, losses within P10_LOSS_TOL of one process's, and in the fast
    mode within P10_FAST_LOSS_TOL; every parameter's first-step gradient
    within P10_GRAD_TOL (float32) or P10_FAST_GRAD_TOL of its norm of one
    process's, the parameters after the first and the third step printed
    (the comment above P10_LOSS_TOL says why); each placed
    kernel's local shard half of it, the plain tensors bit-identical
    across the mp ranks, fact_fwd_bf16 / fact_bwd_bf16 once a fast step
    and fact_fwd / fact_bwd once a float32 step on each rank; a rank's
    step beside one process's and main path 5's, the bytes the mp
    collectives move in a step; (c) the ranks' sharded checkpoint round
    trip.  Returns the figures and the ranks' launches."""
    import tempfile
    from pychain_tpu_torch import ChainLoss
    from pychain_tpu_torch.models import TDNN
    ckpt = os.path.join(REPO, CKPT_DIR, "mp")
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            t0 = time.perf_counter()
            ranks = [lines[-1]["p10"] for lines in run_ranks(
                "(b)", ["-c", "import sys, chip_smoke as c; "
                        "c.p10_width_rank(sys.argv[1], sys.argv[2])",
                        ckpt, tmp], 2, path="main path 10",
                NVIDIA_TF32_OVERRIDE="0")]
            secs = time.perf_counter() - t0
        finally:
            shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
        for r in ranks:
            r.update(torch.load(os.path.join(tmp, f"p10_rank{r['rank']}.pt"),
                                weights_only=False))
            add_launches(launches, r["launches"])
            add_launches(launches, r["f32_launches"])
    dev = torch.device("cuda")
    den, cfg, feats, lengths, nums = p10_problem(dev)
    plain_cfg = dataclasses.replace(cfg, mp_axis=None)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tf32(False, False):
            # the mp forward at each step's weights
            probe = TDNN(plain_cfg, FEAT_DIM)
            fast = ChainLoss(den, precision="fast", device=dev)
            same_w = []
            for r in ranks:
                for k, w in enumerate(r["kept"]):
                    probe.load_state_dict(w)
                    with torch.no_grad():
                        v = float(fast(probe(feats, train=True), lengths,
                                       nums))
                    same_w.append(abs(r["losses"][k] - v) / max(1.0, abs(v)))
            del probe, fast
            runs = {}
            for prec in ("fast", "parity"):
                one = TDNN(cfg, FEAT_DIM,
                           generator=torch.Generator().manual_seed(0))
                kept = []
                out = p10_train(one, den, feats, lengths, nums,
                                precision=prec, keep=lambda m: kept.append(
                                    {k: v.detach().cpu() for k, v in
                                     m.state_dict().items()}))
                runs[prec] = (out, kept[1], {k: v.detach().cpu() for k, v
                                             in one.state_dict().items()})
                del one
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def worst(key, ref):
        params = {k: max(rel_norm(r[key][k], v) for r in ranks)
                  for k, v in ref.items()}
        k = max(params, key=params.get)
        return params[k], k

    def apart(prefix, prec):
        (losses, ms, _, _, _, grads), ref1, ref = runs[prec]
        loss = max(abs(a - b) / max(1.0, abs(b)) for r in ranks
                   for a, b in zip(r[prefix + "losses"], losses))
        every = all(set(r[prefix + "grads1"]) == set(grads) for r in ranks)
        return (loss, worst(prefix + "grads1", grads), every,
                worst(prefix + "step1", ref1), worst(prefix + "state", ref),
                losses, ms)

    for r in ranks:
        r["step1"] = r["kept"][1]
    loss_f, grad_f, every_f, step1_f, par_f, one_f, one_ms = apart("",
                                                                   "fast")
    loss_32, grad_32, every_32, step1_32, par_32, one_32, _ = apart(
        "f32_", "parity")
    same, halves = mp_pairs_identical(ranks), halves_ok(ranks)
    r0 = ranks[0]
    comm = sum(r0["comm_bytes"].values())
    print(f"# main path 10 (b) TDNN-512x{P10_LAYERS}, mp_axis=\"mp\", "
          f"(1x2) mesh of 2 "
          f"gloo ranks sharing the card, B=128 T=500 P=3000, train-mode "
          f"BatchNorm, Adam 1e-3, TF32 off, cuDNN deterministic: each "
          f"step's loss against one process's on the rank's weights before "
          f"it within {max(same_w):.3e}; fast (ChainLoss(precision="
          f"\"fast\")) losses {r0['losses']} against one process's "
          f"{one_f} from the same seed, apart {loss_f:.3e}, first-step "
          f"gradients within {grad_f[0]:.3e} of their norm ({grad_f[1]}), "
          f"parameters after step 1 {step1_f[0]:.3e} ({step1_f[1]}), "
          f"after {P10_STEPS} steps {par_f[0]:.3e} ({par_f[1]}); float32 "
          f"losses {r0['f32_losses']} against {one_32}, apart "
          f"{loss_32:.3e}, first-step gradients within {grad_32[0]:.3e} "
          f"({grad_32[1]}), parameters after step 1 {step1_32[0]:.3e} "
          f"({step1_32[1]}), after {P10_STEPS} {par_32[0]:.3e} "
          f"({par_32[1]}); placed "
          f"{r0['placed']}, halves {halves}; plain tensors bit-identical "
          f"across mp {same}; launches by rank "
          f"{[(r['launches'], r['f32_launches']) for r in ranks]}; "
          f"{secs:.1f} s", flush=True)
    print(f"# main path 10 (b) a rank's fast step {r0['ms'][-1]:.3f} ms (CUDA "
          f"events; host {r0['host_ms'][-1]:.3f} ms; steps {r0['ms']}), one "
          f"process with TF32 off {one_ms[-1]:.3f} ms, main path 5's "
          f"one-process step (TF32 defaults) {p5_step_ms:.3f} ms; the mp "
          f"collectives move {comm} bytes a step on a rank "
          f"({r0['comm_bytes']}); peak {r0['peak_gb']:.2f} GB a rank; "
          f"{card_line()}", flush=True)
    check(max(same_w) <= P10_LOSS_TOL and loss_32 <= P10_LOSS_TOL
          and loss_f <= P10_FAST_LOSS_TOL and every_f and every_32
          and grad_32[0] <= P10_GRAD_TOL and grad_f[0] <= P10_FAST_GRAD_TOL
          and same and halves and len(r0["placed"]) == P10_LAYERS + 1
          and all(r["backend"] == "gloo" and r["launches"] == {
              "fact_fwd_bf16": P10_STEPS, "fact_bwd_bf16": P10_STEPS}
                  and r["f32_launches"] == {"fact_fwd": P10_STEPS,
                                            "fact_bwd": P10_STEPS}
                  for r in ranks),
          f"main path 10 (b): same weights {max(same_w):.3e}, float32 loss "
          f"{loss_32:.3e} gradients {grad_32} (all {every_32}), fast loss "
          f"{loss_f:.3e} gradients {grad_f} (all {every_f}), bit-identical "
          f"{same}, halves {halves}, "
          f"{[(r['backend'], r['launches'], r['f32_launches']) for r in ranks]}")
    for r in ranks:
        c = r["ckpt"]
        check(c == {"step": P10_STEPS, "placed_back": True,
                    "whole_back": True}, f"main path 10 (c) rank "
              f"{r['rank']}: {c}")
    print("# main path 10 (c): save_sharded / restore_sharded of the "
          f"placed TDNN-512x{P10_LAYERS} on 2 ranks: each rank's shards "
          "back bit for bit into a placed model of another seed, the whole "
          "arrays into a model without a mesh", flush=True)
    return {"same_w": max(same_w), "loss_rel": loss_f,
            "grad_rel": grad_f[0], "f32_grad_rel": grad_32[0],
            "param_rel": par_f[0], "step1_rel": step1_f[0],
            "f32_loss_rel": loss_32, "f32_param_rel": par_32[0],
            "f32_step1_rel": step1_32[0],
            "rank_ms": r0["ms"][-1], "rank_host_ms": r0["host_ms"][-1],
            "one_ms": one_ms[-1], "comm_bytes": comm, "s": secs}, launches


def main_path_10(p5_step_ms):
    """Main path 10: (a) the dryrun, (b) the full-width step and (c) its
    checkpoint.  Returns the figures and the kernel launches of the
    ranks' steps (counted in the ranks: 0 before each rank's step)."""
    t0 = time.perf_counter()
    a, launches = p10_dryrun()
    b, b_launches = p10_width(p5_step_ms)
    add_launches(launches, b_launches)
    print(f"# main path 10 launches (the ranks' steps): {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k in ("fact_fwd", "fact_bwd", "fact_fwd_bf16", "fact_bwd_bf16"):
        check(launches.get(k), f"main path 10 launched no {k}")
    return {"a": a, "b": b}, launches


def bound(nbytes, ops, peak_flops=PEAK_F32_FLOPS):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import (denominator_fst,
                                                    linear_fst)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # PyTorch's defaults, under which main path 5 trains; the kernel
    # checks run without TF32
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)

    # -- phase 2: build (all sources at once) ----------------------------
    t0 = time.perf_counter()
    secs = build.build()
    print(f"# build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"#   {name}: {line.strip()}")
    from pychain_tpu_torch.csrc import native
    t0 = time.perf_counter()
    lib = native.build()
    print(f"# native host library (g++ {' '.join(native.FLAGS)}): "
          f"{lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    check_smem()
    with timed_path("card tests"):
        card_tests()
    leaky_c = 1e-5
    t_phase = time.perf_counter()

    # -- phase 3: kernels vs plain, small graphs -------------------------
    errs_small = []
    for mode, want in MODES:
        fst, P = denominator_fst(num_phones=12, states_per_phone=2, seed=3,
                                 forward_pdf_mode=mode)
        batch = ChainGraphBatch(ChainGraph(fst), 4, device=dev)
        check(batch._fact.xsrc_mode == want,
              f"{mode}: xsrc_mode {batch._fact.xsrc_mode} != {want}")
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(4, 16, P, generator=g, device=dev)
        lens = torch.tensor([16, 11, 7, 1], device=dev)
        for debug in (True, False):
            errs_small.append(compare(batch._fact, torch.exp(x), lens,
                                      leaky_c, debug, f"small {mode}"))

    # -- phase 3: headline graph -----------------------------------------
    B, T = 128, 500
    t0 = time.perf_counter()
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    den = ChainGraph(den_fst)
    den_batch = ChainGraphBatch(den, B, device=dev)
    fa = den_batch._fact
    kg = fk.graph_for(fa)
    print(f"# headline graph: S={den.num_states} K={den.num_transitions} "
          f"P={P} s_pad={fa.s_pad} p_pad={fa.p_pad} "
          f"xsrc_mode={fa.xsrc_mode} nnz(W1+W2)={kg.nnz} "
          f"smem={fk.smem_bytes(fa)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    head_wf, head_stages = resident_layout(fa, kg, "headline graph")
    for name in ("w1", "w1t"):
        n, _, banked = head_wf[name]
        check(banked <= 1.6 * n, f"headline {name}: {banked / n:.3f} gather "
              "wavefronts a slot-warp in bank order (at most 1.6)")
    check(head_stages == 2, f"headline: fact_bwd ring {head_stages} != 2")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, T, P, generator=g, device=dev)
    px = torch.exp(x)
    lens = torch.full((B,), T, device=dev)
    head = compare(fa, px, lens, leaky_c, False, "headline")
    head_ad, _ = alpha_err(fa, px, lens, leaky_c, "headline")
    resident_rerun(fa, px, lens, leaky_c, "headline")

    # times: each kernel alone, and the plain version of each sweep; the
    # cluster kernels at their plans, at C=2, G=1 and at every plan, for
    # comparison
    fwd_ms, bwd_ms, plain_fwd_ms, plain_bwd_ms = pair_times(
        fa, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd, 5)
    head_plans = stream_plans(fa, B, "headline graph")
    head_st = pair_times(fa, px, lens, leaky_c, stk.stream_fwd,
                         stk.stream_bwd, 5, plain=False)
    head_c2 = pair_times(fa, px, lens, leaky_c, *cluster_pair(2, 1), 5,
                         plain=False)
    plan_times(fa, px, lens, leaky_c, "headline graph")
    print(f"# headline graph on the cluster kernels: stream_fwd "
          f"{head_st[0]:.3f} ms, stream_bwd {head_st[1]:.3f} ms at their "
          f"plans (C={head_plans['stream_fwd']['cluster']} "
          f"G={head_plans['stream_fwd']['columns']} / "
          f"C={head_plans['stream_bwd']['cluster']} "
          f"G={head_plans['stream_bwd']['columns']}); at C=2 G=1 "
          f"{head_c2[0]:.3f} / {head_c2[1]:.3f} ms; fact_fwd {fwd_ms:.3f} "
          f"ms, fact_bwd {bwd_ms:.3f} ms", flush=True)
    print(f"# headline times: fact_fwd {fwd_ms:.3f} ms, fact_bwd "
          f"{bwd_ms:.3f} ms; plain fwd {plain_fwd_ms:.1f} ms, plain bwd "
          f"{plain_bwd_ms:.1f} ms", flush=True)

    # -- phase 3b: B1/B2 in the fast mode (bfloat16 tiles) ---------------
    errs_fast_small = fast_small(dev, leaky_c)
    head_fast = fast_class("headline", den, P, B, T, dev, leaky_c, 0,
                           f32_fa=fa)

    # -- phase 4: semiring kernels vs plain, small batches ---------------
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.utils.testgraphs import random_fst, sausage_fst
    errs_sr_small = []
    small = torch.Generator(device=dev).manual_seed(3)
    lens4 = torch.tensor([16, 11, 7, 1], device=dev)
    cyclic, _ = list_batch([random_fst(num_states=6 + b, num_pdfs=10,
                                       seed=b) for b in range(4)], dev)
    x10 = torch.randn(4, 16, 10, generator=small, device=dev)
    errs_sr_small.append(sr_compare(cyclic.semiring(), x10, lens4,
                                    "small cyclic", [True] * 4))
    rng = np.random.RandomState(3)
    saus_lens = [12, 9, 5, 2]
    sausage, _ = list_batch(
        [sausage_fst([list(rng.randint(0, 10, size=rng.randint(1, 4)))
                      for _ in range(n)], seed=b)
         for b, n in enumerate(saus_lens)], dev)
    x12 = torch.randn(4, 12, 10, generator=small, device=dev)
    errs_sr_small.append(sr_compare(
        sausage.semiring(), x12, torch.tensor(saus_lens, device=dev),
        "small sausage", [True] * 4))
    # 12 phones cannot fit in 10 frames: the last sequence is infeasible
    flat = [flat_start_fsts(1, 20, n, n, seed=n)[0] for n in (5, 8, 3, 12)]
    flat_small, _ = list_batch(flat, dev)
    x40 = torch.randn(4, 20, 40, generator=small, device=dev)
    flat_lens = torch.tensor([20, 15, 9, 10], device=dev)
    errs_sr_small.append(sr_compare(flat_small.semiring(), x40, flat_lens,
                                    "small flat-start",
                                    [True, True, True, False]))
    for label, batch, x_, l_ in (("small cyclic", cyclic, x10, lens4),
                                 ("small flat-start", flat_small, x40,
                                  flat_lens)):
        bit_identical_gamma(batch.semiring(), x_, l_, label)

    # -- phase 4: the three size classes ---------------------------------
    # "semiring": the flat-start batch of main path 2 (within the JAX
    # dense budget and the Pallas one-hot rule: B5/B6 on a TPU)
    t0 = time.perf_counter()
    flat_fsts = flat_start_fsts(B, 1500, 100, 150, seed=0)
    fsts_s = time.perf_counter() - t0
    flat_batch, flat_host_ms = list_batch(flat_fsts, dev, pad=(300, 151))
    print(f"# flat-start batch: B={B} phones "
          f"{min(f.num_states for f in flat_fsts) - 1}.."
          f"{max(f.num_states for f in flat_fsts) - 1}, K_pad=300, "
          f"S_pad=151; FSTs built in {fsts_s:.2f} s; ChainGraphBatch "
          f"(arc-id lists) {flat_host_ms:.1f} ms on the host",
          flush=True)
    gx = torch.Generator(device=dev).manual_seed(4)
    classes = {}
    x_flat = torch.randn(B, T, P, generator=gx, device=dev)
    classes["semiring"] = sr_class("semiring", flat_batch.semiring(),
                                   x_flat, lens, 5)
    del x_flat
    # "xl": bench.py --xl (beyond the dense budget, masks resident: B7/B8)
    t0 = time.perf_counter()
    xl_batch, xl_host_ms = list_batch(
        [random_fst(num_states=1000, num_pdfs=3000, max_arcs_per_state=5,
                    seed=s) for s in range(B)], dev)
    print(f"# xl batch built in {time.perf_counter() - t0:.1f} s; "
          f"ChainGraphBatch (arc-id lists) {xl_host_ms:.1f} ms on the "
          "host", flush=True)
    x_xl = torch.randn(B, T, 3000, generator=gx, device=dev)
    classes["xl"] = sr_class("xl", xl_batch.semiring(), x_xl, lens, 3)
    del x_xl, xl_batch
    # "xlstream": tools/xl_stream_indomain.py (beyond the resident budget:
    # masks re-expanded per arc chunk, B9/B10)
    Bs, Ts = 32, 150
    t0 = time.perf_counter()
    xs_batch, xs_host_ms = list_batch(
        [random_fst(num_states=3500, num_pdfs=512, max_arcs_per_state=3,
                    seed=s) for s in range(Bs)], dev)
    print(f"# xlstream batch built in {time.perf_counter() - t0:.1f} s; "
          f"ChainGraphBatch (arc-id lists) {xs_host_ms:.1f} ms on the "
          "host", flush=True)
    x_xs = torch.randn(Bs, Ts, 512, generator=gx, device=dev)
    classes["xlstream"] = sr_class("xlstream", xs_batch.semiring(), x_xs,
                                   torch.full((Bs,), Ts, device=dev), 3)
    del x_xs, xs_batch

    # -- phase 5: main path 1, linear numerators -------------------------
    rng = np.random.RandomState(0)
    nums = [ChainGraph(linear_fst(rng.randint(0, P, size=T)),
                       log_domain=True) for _ in range(B)]
    num_batch = ChainGraphBatch(nums, max_num_transitions=T,
                                max_num_states=T + 1, device=dev)
    loss_mod = ChainLoss(den)
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(2), device=dev).requires_grad_(True)
    x_lengths = torch.full((B,), T, dtype=torch.int32)
    note_seconds("kernel checks before main path 1", t_phase)
    with timed_path("main path 1"):
        _, step_ms, launches = train_steps(
            loss_mod, x, x_lengths, num_batch, (fk.LAUNCHES, sk.LAUNCHES),
            want_launches((fk.LAUNCHES, sk.LAUNCHES), fact_fwd=1,
                          fact_bwd=1), "main path 1 (linear numerators)")
        profiled_step(loss_mod, x, x_lengths, num_batch, "linear numerators")

    # -- phase 5b: main path 1 in the fast mode --------------------------
    with timed_path("main path 1 fast"):
        fast_step_ms, fast_launches, fast_loss_rel, fast_loss = \
            main_path_1_fast(den, B, T, P, dev, (fk.LAUNCHES, sk.LAUNCHES))

    # -- phase 5c: main path 5, training (bench.py --train) --------------
    with timed_path("main path 5"):
        p5 = main_path_5(den, fast_loss, loss_mod, B, T, P, dev,
                         (fk.LAUNCHES, sk.LAUNCHES, stk.LAUNCHES),
                         tf32_defaults)
    del fast_loss

    # -- phase 6: main path 2, flat-start numerators ---------------------
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev).requires_grad_(True)
    with timed_path("main path 2"):
        _, flat_step_ms, flat_launches = train_steps(
            loss_mod, x, x_lengths, flat_batch, (fk.LAUNCHES, sk.LAUNCHES),
            want_launches((fk.LAUNCHES, sk.LAUNCHES), fact_fwd=1,
                          fact_bwd=1, semiring_fwd=1, semiring_bwd=1),
            "main path 2 (flat-start numerators)")
        profiled_step(loss_mod, x, x_lengths, flat_batch,
                      "flat-start numerators")

    # -- phase 7: the Viterbi kernel vs plain, small batches --------------
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    vit_small_out = vit_small(dev)

    # -- phase 8: main path 3, realignment -------------------------------
    x_flat = x.detach().clone()      # main path 2's x, for the class below
    with timed_path("main path 3"):
        re_step_ms, re_launches, align_ms, _, re_batch = realign(
            loss_mod, x, x_lengths, flat_batch,
            flat_start_phones(B, 1500, 100, 150, seed=0), 1500,
            (fk.LAUNCHES, sk.LAUNCHES), vk.LAUNCHES)
    del x
    # the semiring pair at main path 3's constrained batch (the "xl" class
    # by the JAX package's rule), under the x it was aligned on
    classes["path3"] = sr_class("xl", re_batch.semiring(), x_flat, lens,
                                5, label="main path 3's batch")
    # main path 9 (e): the banded engine on the same batch and x
    p9_lev = p9_leveled(re_batch, x_flat, lens,
                        (fk.LAUNCHES, sk.LAUNCHES, stk.LAUNCHES, vk.LAUNCHES))
    del re_batch
    # the alignment of main path 3 given the batch's GraphArrays
    viterbi_of_graph_arrays(flat_batch, x_flat, lens, vk.LAUNCHES)

    t_phase = time.perf_counter()
    # -- phase 9: the Viterbi size classes -------------------------------
    vit_classes = {"realign": vit_class("realign", flat_batch.semiring(),
                                        x_flat, lens, 5)}
    del x_flat
    t0 = time.perf_counter()
    b11_batch, _ = list_batch(
        [random_fst(num_states=512, num_pdfs=512, max_arcs_per_state=4,
                    seed=s) for s in range(B)], dev)
    print(f"# b11 batch built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    x_b11 = torch.randn(B, T, 512, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    vit_classes["b11"] = vit_class("b11", b11_batch.semiring(), x_b11, lens,
                                   5)
    del x_b11, b11_batch

    # -- phase 10: decoding ----------------------------------------------
    dec_g, x_dec, dec_lens, dec_launches = decoding(dev, B, T, vk.LAUNCHES)
    vit_classes["decode"] = vit_class("decode", dec_g, x_dec, dec_lens, 5)
    del x_dec, dec_g
    fwd_bytes, fwd_ops, bwd_bytes, bwd_ops = fact_bytes_ops(fa, kg, lens, T,
                                                            P)
    del den_batch, fa, kg, px, x_lengths, flat_batch, num_batch, loss_mod
    torch.cuda.empty_cache()

    note_seconds("the Viterbi classes and decoding", t_phase)
    t_phase = time.perf_counter()
    # -- phase 11: the cluster kernels, small graphs and the s8k class ---
    errs_stream_small = stream_small(dev, leaky_c)
    s8k = s8k_class(dev, leaky_c)
    stream_classes = {"s8k": s8k[:5]}
    s8k_b12_errs, s8k_fact_ms, s8k_fast, s8k_stream_fast = s8k[5:]
    errs_ringless = ringless_class(dev, leaky_c)
    torch.cuda.empty_cache()

    note_seconds("the cluster kernels' checks (small, s8k, ringless)",
                 t_phase)
    # -- phase 12: main path 4, the 12k-state Kaldi-topology denominator -
    with timed_path("main path 4"):
        m4 = main_path_4(dev, leaky_c,
                         (fk.LAUNCHES, sk.LAUNCHES, stk.LAUNCHES))
    stream_classes["main4"] = m4[:5]
    m4_step_ms, m4_launches, m4_fast, m4_fast_step_ms, m4_fast_launches = \
        m4[5:]
    torch.cuda.empty_cache()

    # -- phase 12b: main path 6, the corpus recipe -----------------------
    # the recipe runs under PyTorch's defaults (a user's run), the checks
    # of its kernels without TF32
    with timed_path("main path 6"):
        p6 = main_path_6((fk.LAUNCHES, sk.LAUNCHES, stk.LAUNCHES,
                          vk.LAUNCHES), B / (p5["step_ms"] / 1e3),
                         tf32_defaults)
    torch.cuda.empty_cache()

    # -- phase 12c: main path 7, long utterances (bench.py --long --big) --
    with timed_path("main path 7"):
        p7 = main_path_7(den, P, dev, leaky_c, (fk.LAUNCHES, sk.LAUNCHES,
                                                stk.LAUNCHES, vk.LAUNCHES))
    torch.cuda.empty_cache()

    # -- phase 12d: main path 8, a shared log-domain graph ---------------
    all_counters = (fk.LAUNCHES, sk.LAUNCHES, stk.LAUNCHES, vk.LAUNCHES)
    t8 = time.perf_counter()
    p8 = main_path_8(den_fst, P, dev, all_counters)
    torch.cuda.empty_cache()
    # -- phase 12e: the gather engine beside the kernels -----------------
    gather_ab = gather_beside_kernels(dev, den, P, all_counters)
    torch.cuda.empty_cache()
    # -- phase 12f: the examples and the graph-building CLI ---------------
    examples = examples_phase(all_counters)
    torch.cuda.empty_cache()
    note_seconds("main path 8, the gather A/Bs, the examples", t8)

    # -- phase 12g: main path 9, data parallelism and dense_list ----------
    t9 = time.perf_counter()
    p9_sh, p9_launches = p9_sharded()
    p9_rec, rec_launches = p9_recipe(all_counters, tf32_defaults,
                                     p6["bench"])
    add_launches(p9_launches, rec_launches)
    add_launches(p9_launches, p9_lev["launches"])
    pb, px_, pl, pres, pgraphs = gather_ab.pop("prob list batch")
    p9_dense = p9_dense_list(pb, px_, pl, pres, gather_ab["prob list"][0],
                             pgraphs)
    del pb, px_, pres
    torch.cuda.empty_cache()
    print(f"# main path 9 launches (the sharded steps, the --dp runs, the "
          f"semiring kernels of (e)): {p9_launches}", flush=True)
    note_seconds("main path 9", t9)
    for k in ("fact_fwd", "fact_bwd", "fact_fwd_bf16", "fact_bwd_bf16",
              "semiring_fwd", "semiring_bwd"):
        check(p9_launches.get(k), f"main path 9 launched no {k}")

    # -- phase 12h: main path 10, the model axis ---------------------------
    with timed_path("main path 10"):
        p10, p10_launches = main_path_10(p5["step_ms"])
    torch.cuda.empty_cache()

    # -- phase 13: the XL roofline probe ----------------------------------
    from pychain_tpu_torch.tools import xl_roofline as xr
    with timed_path("the XL probe"):
        xl_rows = xl_probe(dev)

    # -- phase 13: the kernels line --------------------------------------
    rows = []
    for name, ms, plain_ms, nbytes, ops, err, fn in (
            ("fact_fwd", fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops,
             max(head_ad, head["objf_rel"]), "_fwd_kernel_factory", ),
            ("fact_bwd", bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops,
             max(head["gamma_abs"], head["alpha_beta_abs"],
                 head["gamma_sum_abs"]), "_bwd_kernel_factory")):
        bms, by = bound(nbytes, ops)
        line = {"fact_fwd": 457, "fact_bwd": 768}[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"pychain_tpu_torch/csrc/{name}.cu",
            "replaces": f"pychain_tpu/ops/pallas_fact.py:{line}",
            "replaces_fn": f"pychain_tpu/ops/pallas_fact.py::{fn}",
            # main path 1's three steps, main path 5's float32 step, main
            # path 9's sharded steps and main path 10's dryrun ranks (main
            # path 6's launches: its own rows)
            "launches": (launches[name] + p5["launches"][name]
                         + p9_launches.get(name, 0)
                         + p10_launches.get(name, 0)),
            "launches_by_path": {"main path 1": launches[name],
                                 "main path 5": p5["launches"][name],
                                 "main path 9": p9_launches.get(name, 0),
                                 "main path 10": p10_launches.get(name, 0)},
            "max_abs_err": err, "max_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "ring_stages": head_stages if name == "fact_bwd" else 0,
            "s8k_ms": s8k_fact_ms[0 if name == "fact_fwd" else 1],
            "library_ms": None})
    # the fast pair: its time at the headline (and s8k), launches on main
    # path 1 in the fast mode and on main path 5
    for name, line, fn in (("fact_fwd_bf16", 457, "_fwd_kernel_factory"),
                           ("fact_bwd_bf16", 768, "_bwd_kernel_factory")):
        r, r8 = head_fast[name], s8k_fast[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"pychain_tpu_torch/csrc/{name[:8]}.cu",
            "replaces": f"pychain_tpu/ops/pallas_fact.py:{line}",
            "replaces_fn": f"pychain_tpu/ops/pallas_fact.py::{fn}, "
                           "bfloat16 tiles (fast mode)",
            "launches": (fast_launches[name] + p5["launches"][name]
                         + p9_launches.get(name, 0)
                         + p10_launches.get(name, 0)),
            "launches_by_path": {"main path 1 fast": fast_launches[name],
                                 "main path 5": p5["launches"][name],
                                 "main path 9": p9_launches.get(name, 0),
                                 "main path 10": p10_launches.get(name, 0)},
            "max_abs_err": r["max_abs_err"],
            "max_err": r["max_abs_err"], "entry_excess": r["entry_excess"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "bytes": r["bytes"], "ops": r["ops"],
            # the plan's form (the group form's [G, C] past B = 66) and,
            # in brackets, one block a column in the same call
            "plan": r["plan"], "one_block_ms": r["one_block_ms"],
            "float32_ms": r["float32_ms"], "ring_stages": r["ring_stages"],
            "s8k_ms": r8["ms"], "s8k_plan": r8["plan"],
            "s8k_bound_ms": r8["bound"][0],
            "s8k_plain_ms": r8["plain_ms"], "s8k_float32_ms": r8["float32_ms"],
            "s8k_ring_stages": r8["ring_stages"],
            "vs_float32_objf_rel": r["vs_float32"]["objf_rel"],
            "library_ms": None})
    # B1/B2 (either form) on main path 6's stages, at their own inputs
    for (stage, family), res in p6["checks"].items():
        if family != "den":
            continue
        for name, r in res.items():
            line, fn = ((457, "_fwd_kernel_factory") if "fwd" in name
                        else (768, "_bwd_kernel_factory"))
            bms, by = bound(r["bytes"], r["ops"])
            rows.append({
                "name": name, "route": "cuda",
                "batch": f"main path 6 {stage}",
                "source": f"pychain_tpu_torch/csrc/{name[:8]}.cu",
                "replaces": f"pychain_tpu/ops/pallas_fact.py:{line}",
                "replaces_fn": f"pychain_tpu/ops/pallas_fact.py::{fn}"
                               + (", bfloat16 tiles (fast mode)"
                                  if name.endswith("_bf16") else ""),
                "launches": p6["stages"][stage][name],
                "launches_by_path": {"main path 6": p6["stages"][stage][name]},
                "on_main_path": True, "shape": r["shape"],
                "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
                "entry_excess": r["entry_excess"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
                "bytes": r["bytes"], "ops": r["ops"], "plan": r["plan"],
                "one_block_ms": r["one_block_ms"], "library_ms": None})
    # B1/B2's forms on main path 7 (bench.py --long --big): each with its
    # launches in its mode's run; fact_fwd_init and fact_bwd_chunk timed
    # over all of a call's chunks
    # launches in its mode's run (the paired ckpt scan: the pair's
    # launches, and its roles' in the init and chunk rows); fact_fwd_init
    # and fact_bwd_chunk carry the paired scan's time for a call, the
    # pair's work as their bound, and their own time and bound unpaired
    modes = {"fact_fwd": "full", "fact_bwd": "full",
             "fact_fwd_snap lean": "lean", "fact_bwd_lean": "lean",
             "fact_fwd_snap ckpt": "ckpt", "fact_fwd_init": "ckpt",
             "fact_bwd_chunk": "ckpt", "fact_ckpt_pair": "ckpt"}
    for fast, p7_rows in ((True, p7["fast_rows"]), (False, p7["f32_rows"])):
        stats = p7["stats" if fast else "f32_stats"]
        pair = p7_rows["fact_ckpt_pair"]
        for key, r in p7_rows.items():
            form = key.split()[0]
            name = form + ("_bf16" if fast else "")
            mode = modes[key]
            launched = (stats[mode]["launches"].get(name, 0)
                        + stats[mode]["roles"].get(name, 0))
            role = form in ("fact_fwd_init", "fact_bwd_chunk")
            per_call = role or form == "fact_ckpt_pair"
            line, fn = ((457, "_fwd_kernel_factory") if "fwd" in form
                        else (768, "_bwd_kernel_factory"))
            work = pair if role else r
            bms, by = bound(work["bytes"], work["ops"])
            src = "fact_ckpt" if form == "fact_ckpt_pair" else form[:8]
            rows.append({
                "name": name, "route": "cuda",
                "batch": ("main path 7 (bench.py --long --big: B=64, "
                          "T=3700)" if fast else "main path 7 float32 (B=64,"
                          f" T={LONG_F32_T})"),
                "stream_mode": mode,
                "ckpt_chunk": r["C"] if mode == "ckpt" else None,
                "source": f"pychain_tpu_torch/csrc/{src}.cu",
                **({"kernel": "pychain_tpu_torch/csrc/fact_ckpt.cu "
                              f"(fact_ckpt_pair{'_bf16' if fast else ''})"}
                   if role else {}),
                "replaces": f"pychain_tpu/ops/pallas_fact.py:{line}",
                "replaces_fn": (
                    "pychain_tpu/ops/pallas_fact.py::_fwd_kernel_factory "
                    "(ext_init, :457) and _bwd_kernel_factory (ext_init, "
                    "chunked, :768), as _forward_backward_ckpt (:936) "
                    "launches them" if form == "fact_ckpt_pair" else
                    f"pychain_tpu/ops/pallas_fact.py::{fn}, {mode} stream "
                    "mode") + (", bfloat16 tiles (fast mode)" if fast
                               else ""),
                "launches": launched,
                "launches_by_path": {"main path 7": launched},
                **({"pair_launches": stats["ckpt"]["launches"].get(
                    PAIR_NAME[fast], 0)} if role else {}),
                "on_main_path": True,
                "ms_covers": (
                    f"one call: the paired scan's {r['n_chunks'] + 1} "
                    "launches, both roles" if per_call else "one launch"),
                "max_abs_err": r["err"], "max_err": r["err"],
                "ms": pair["ms"] if role else r["ms"],
                "plain_ms": work["plain_ms"], "bound_ms": bms,
                "bound_by": by, "bytes": work["bytes"], "ops": work["ops"],
                # the form alone, unpaired, over a call's chunks
                **({"unpaired_ms": r["ms"], "unpaired_plain_ms":
                    r["plain_ms"], "form_bound_ms": bound(
                        r["bytes"], r["ops"])[0]} if role else {}),
                # CTAs a column at the plan, and (fast mode) the one-call
                # A/B of C = 1 against C = ab_cluster
                **{k: r[k] for k in ("cluster", "ab_cluster", "ab_ms",
                                     "c1_ms", "ab_peak_over_held",
                                     "c1_peak_over_held", "pair_sms",
                                     "active_clusters", "smem", "plan_sms",
                                     "cluster_form_ms")
                   if k in r},
                "library_ms": None})
    # bench.py --long (B=32): the full pair at its plan, each form's time
    # at C = 1, 2 and 4 in turns
    for form, r in p7["long_rows"].items():
        line, fn = ((457, "_fwd_kernel_factory") if "fwd" in form
                    else (768, "_bwd_kernel_factory"))
        bms, by = bound(r["bytes"], r["ops"])
        rows.append({
            "name": f"{form}_bf16", "route": "cuda",
            "batch": f"main path 7 (bench.py --long: B={LONG[0]}, "
                     f"T={LONG[1]})",
            "stream_mode": "full",
            "source": f"pychain_tpu_torch/csrc/{form}.cu",
            "replaces": f"pychain_tpu/ops/pallas_fact.py:{line}",
            "replaces_fn": f"pychain_tpu/ops/pallas_fact.py::{fn}, full "
                           "stream mode, bfloat16 tiles (fast mode)",
            "launches": r["launches"],
            "launches_by_path": {"main path 7": r["launches"]},
            "on_main_path": True, "ms_covers": "one launch",
            "max_abs_err": r["err"], "max_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "bytes": r["bytes"], "ops": r["ops"], "cluster": r["cluster"],
            "c1_ms": r["c1_ms"], "c2_ms": r["c2_ms"], "c4_ms": r["c4_ms"],
            **{k: r[k] for k in ("active_clusters", "smem", "plan_sms",
                                 "cluster_form_ms")
               if k in r},
            "library_ms": None})
    # main path 8 (bench.py --xlstream): B1/B2 in both precisions at
    # leaky 0 on the shared log-domain graph, B3/B4 on its cluster-tier
    # check (main path 4's graph in the log domain)
    for key, batch_label in (
            ("rows", "main path 8 (shared log-domain graph: B=32, T=150)"),
            ("cluster_rows", "main path 8 cluster tier (main path 4's "
                             "graph in the log domain: B=8, T=100)")):
        for name, r in p8[key].items():
            form = name.split("_bf16")[0]
            if form.startswith("stream"):
                line, fn, mod = ((463, "_fwd_kernel_factory", "pallas_stream")
                                 if "fwd" in form else
                                 (668, "_bwd_kernel_factory",
                                  "pallas_stream"))
            else:
                line, fn, mod = ((457, "_fwd_kernel_factory", "pallas_fact")
                                 if "fwd" in form else
                                 (768, "_bwd_kernel_factory", "pallas_fact"))
            rows.append({
                "name": name, "route": "cuda", "batch": batch_label,
                "leaky": 0,
                "source": f"pychain_tpu_torch/csrc/{form}.cu",
                "replaces": f"pychain_tpu/ops/{mod}.py:{line}",
                "replaces_fn": f"pychain_tpu/ops/{mod}.py::{fn}, "
                               "log_semantics (leaky 0)"
                               + (", bfloat16 tiles (fast mode)"
                                  if name.endswith("_bf16") else ""),
                "launches": r["launches"],
                "launches_by_path": {"main path 8": r["launches"]},
                "on_main_path": True,
                **{k: r[k] for k in ("cluster", "columns", "one_block_ms",
                                     "cluster_form_ms")
                   if k in r},
                "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
                "entry_excess": r["entry_excess"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "bytes": r["bytes"],
                "ops": r["ops"], "library_ms": None})
    # main path 2 runs the "semiring" class (the flat-start batch), main
    # path 3 its constrained batch ("xl" by the JAX package's rule); the
    # other rows are kernel checks at bench.py's and the tool's sizes
    sr_launches = {"semiring": flat_launches, "path3": re_launches}
    sr_paths = {"semiring": "main path 2", "path3": "main path 3"}
    # main path 6's flat-start and constrained batches (B=8) at their own
    # inputs, by the class the JAX package's rule gives each
    for (stage, family), res in p6["checks"].items():
        if family == "semiring":
            key = f"main path 6 {stage}"
            classes[key] = res
            sr_launches[key] = p6["stages"][stage]
            sr_paths[key] = "main path 6"
    for batch_name, res in classes.items():
        cls = res["class"]
        for i, side in enumerate(("fwd", "bwd")):
            ms, plain_ms, nbytes, ops, err = res[side]
            name = f"semiring_{side}"
            lay = res["layouts"][name]
            bms, by = bound(nbytes, ops, PEAK_F64_FLOPS)
            by_path = ({sr_paths[batch_name]: sr_launches[batch_name][name]}
                       if batch_name in sr_launches else {})
            if batch_name == "path3":
                # main path 9 (e) runs auto on main path 3's batch
                by_path["main path 9"] = p9_lev["launches"].get(name, 0)
            rows.append({
                "name": name, "route": "cuda", "size_class": cls,
                "batch": {"path3": "main path 3"}.get(batch_name,
                                                      batch_name),
                "source": f"pychain_tpu_torch/csrc/{name}.cu",
                "replaces": SR_CLASSES[cls][i],
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "on_main_path": batch_name in sr_launches,
                "threads": lay.threads, "stages": lay.stages,
                "resident": lay.resident,
                **({"pipe": lay.pipe, "grows": lay.grows}
                   if side == "bwd" else {}),
                "max_abs_err": err, "max_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "bytes": nbytes, "ops": ops, "library_ms": None})
    for cls, (errs, (a_err, a_excess), times, (fb, fo, bb, bo), plans) in \
            stream_classes.items():
        for i, name in enumerate(("stream_fwd", "stream_bwd")):
            nbytes, ops = ((fb, fo), (bb, bo))[i]
            err = (max(a_err, errs["objf_rel"]) if i == 0 else
                   max(errs["gamma_abs"], errs["alpha_beta_abs"],
                       errs["gamma_sum_abs"]))
            # alpha' (fwd) or gamma (bwd), entry by entry
            entry_excess = a_excess if i == 0 else errs["gamma_excess"]
            bms, by = bound(nbytes, ops)
            line, fn = ((463, "_fwd_kernel_factory"),
                        (668, "_bwd_kernel_factory"))[i]
            rows.append({
                "name": name, "route": "cuda", "size_class": cls,
                "cluster": plans[name]["cluster"],
                "columns": plans[name]["columns"],
                "active_clusters": plans[name]["active_clusters"],
                "source": f"pychain_tpu_torch/csrc/{name}.cu",
                "replaces": f"pychain_tpu/ops/pallas_stream.py:{line}",
                "replaces_fn": f"pychain_tpu/ops/pallas_stream.py::{fn}",
                # main path 4 runs the "main4" class
                "launches": m4_launches[name] if cls == "main4" else 0,
                "on_main_path": cls == "main4",
                "max_abs_err": err, "max_err": err,
                "entry_excess": entry_excess, "ms": times[i],
                "plain_ms": times[2 + i], "bound_ms": bms, "bound_by": by,
                "bytes": nbytes, "ops": ops, "library_ms": None})
    # the fast cluster pair: its launches on main path 4 fast, s8k a kernel
    # check at its plan
    for cls, fast_rows in (("main4", m4_fast), ("s8k", s8k_stream_fast)):
        for name, line, fn in (("stream_fwd_bf16", 463, "_fwd_kernel_factory"),
                               ("stream_bwd_bf16", 668,
                                "_bwd_kernel_factory")):
            r = fast_rows[name]
            rows.append({
                "name": name, "route": "cuda", "size_class": cls,
                "cluster": r["cluster"], "columns": r["columns"],
                "active_clusters": r["active_clusters"],
                "source": f"pychain_tpu_torch/csrc/{name[:10]}.cu",
                "replaces": f"pychain_tpu/ops/pallas_stream.py:{line}",
                "replaces_fn": f"pychain_tpu/ops/pallas_stream.py::{fn}, "
                               "bfloat16 tiles (fast mode)",
                "launches": m4_fast_launches[name] if cls == "main4" else 0,
                "on_main_path": cls == "main4",
                "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
                "entry_excess": r["entry_excess"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "bytes": r["bytes"],
                "ops": r["ops"], "float32_ms": r["float32_ms"],
                "layout": r["layout"],
                "float_layout_ms": r["float_layout_ms"],
                "vs_float32_objf_rel": r["vs_float32"]["objf_rel"],
                "library_ms": None})
    vit_paths = {"realign": {"main path 3": re_launches["viterbi"]},
                 "decode": {"decoding": dec_launches["viterbi"]}, "b11": {}}
    # main path 6's decoder (a) and realignment (b) at their own inputs
    for (stage, family), res in p6["checks"].items():
        if family == "viterbi":
            cls = f"main path 6 {stage}"
            vit_classes[cls] = res
            vit_paths[cls] = {"main path 6": p6["stages"][stage]["viterbi"]}
    for cls, (ms, plain_ms, nbytes, ops, err, bad, lay) in \
            vit_classes.items():
        bms, by = bound(nbytes, ops)
        rows.append({
            "name": "viterbi", "route": "cuda", "size_class": cls,
            "source": "pychain_tpu_torch/csrc/viterbi.cu",
            "replaces": "pychain_tpu/ops/viterbi.py:175",
            "replaces_fn": "pychain_tpu/ops/viterbi.py::_vit_kernel",
            # main path 3 runs the "realign" class, decoding "decode",
            # main path 6 its own
            "launches": sum(vit_paths[cls].values()),
            "launches_by_path": vit_paths[cls],
            "on_main_path": cls != "b11",
            "layout": dataclasses.asdict(lay),
            "max_abs_err": err, "max_err": err, "mismatches": bad,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "ops": ops, "library_ms": None})
    for form, r in xl_rows.items():
        bms, by = bound(r["bytes"], r["ops"])
        rows.append({
            "name": xr.KERNELS[form], "route": "cuda",
            "source": "pychain_tpu_torch/csrc/xl_roofline.cu",
            "replaces": XL_REPLACES[form][0],
            "replaces_fn": XL_REPLACES[form][1],
            # the probe's path (its own main()); no main path runs it
            "launches": r["launches"], "on_main_path": False,
            "max_abs_err": r["max_abs_err"], "max_err": r["rel_err"],
            "rel_err": r["rel_err"], "drift_vs_vpu": r["drift_vs_vpu"],
            "ms": r["ms"], "call_ms": r["call_ms"],
            "b128_ms": r.get("b128_ms"),
            "layout": r["layout"], "bit_equal_plain": r["bit_equal_plain"],
            "us_per_frame": r["us_per_frame"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "bytes": r["bytes"], "ops": r["ops"],
            "tc_dense_ops": r["tc_dense_ops"] or None,
            "tc_issued_ops": r["tc_issued_ops"],
            "library_ms": None})
    print(f"# small-graph worst errors (denominator): {worst(errs_small)}")
    print(f"# small-graph worst errors (denominator, fast mode): "
          f"{errs_fast_small}")
    print(f"# small-batch worst errors (semiring): {worst(errs_sr_small)}")
    print(f"# small-graph worst errors (cluster kernels): "
          f"{worst(errs_stream_small)}")
    print(f"# B1/B2 worst errors at ring depth 1 (s8k): {s8k_b12_errs}; "
          f"at depth 0 (S_pad 12,032): {errs_ringless}")
    print(f"# small-batch Viterbi mismatches: "
          f"{sum(b for b, _ in vit_small_out)}")
    print(f"# step ms (timed step, after warm-up): linear numerators "
          f"{step_ms[-1]:.3f}, flat-start numerators {flat_step_ms[-1]:.3f}"
          f", constrained numerators {re_step_ms[-1]:.3f}, main path 4 "
          f"{m4_step_ms[-1]:.3f}, main path 1 fast {fast_step_ms[-1]:.3f} "
          f"(loss {fast_loss_rel:.3e} from float32's), main path 4 fast "
          f"{m4_fast_step_ms[-1]:.3f}, main path 5 (TDNN-512x5 training, "
          f"fast) {p5['step_ms']:.3f} (float32 {p5['f32_step_ms']:.3f}; "
          f"TDNN-F {p5['tdnnf_ms']:.3f}, BLSTM {p5['blstm_ms']:.3f}); "
          f"realignment viterbi_align {align_ms:.3f}; main path 6 (the "
          f"recipe at bench.py's width, bfloat16 tiles) "
          f"{p6['bench']['utts_per_s']:.1f} utts/s")
    st = p7["stats"]
    print("# main path 7 (bench.py --long --big, B=64 T=3700 bfloat16; step "
          "= denominator value and gradient): " + "; ".join(
              f"{k} {v['ms']:.3f} ms, peak {v['peak'] / 1e9:.3f} GB "
              f"({v['over_held'] / 1e9:.3f} GB over what was held), objf "
              f"{v['objf']!r}" for k, v in st.items())
          + "; float32 at T=1000: " + "; ".join(
              f"{k} {v['ms']:.3f} ms, {v['over_held'] / 1e9:.3f} GB over "
              "what was held" for k, v in p7["f32_stats"].items())
          + "; each call (no autograd) with every form at C=1 -> at its "
          "plan: " + ", ".join(
              f"{k} {v['call_ab']['c1_ms']:.3f} -> "
              f"{v['call_ab']['plan_ms']:.3f} ms"
              for k, v in st.items() if "call_ab" in v)
          + f"; bench.py --long (B=32 T=2500) auto -> {p7['long']['auto']} "
          f"{p7['long']['ms']:.3f} ms, peak {p7['long']['peak'] / 1e9:.3f} "
          f"GB, its call at C=1 {p7['long']['call_c1_ms']:.3f} -> at its "
          f"plan {p7['long']['call_plan_ms']:.3f} ms")
    print(f"# main path 8 (shared log-domain graph, B=32 T=150, leaky 0; "
          f"step = value and gradient): float32 {p8['ms']:.3f} ms "
          f"({p8['ups']:.1f} utts/s), bfloat16 tiles {p8['fast_ms']:.3f} "
          f"ms ({p8['fast_ups']:.1f} utts/s), impl='gather' "
          f"{p8['gather_ms']:.1f} ms (objf rel {p8['gather_rel']:.2e}); "
          f"cluster tier (12k graph, B=8 T=100) {p8['cluster_ms']:.3f} ms; "
          "gather beside the kernels (kernels ms, gather ms): "
          + "; ".join(f"{k} {a:.1f} / {b:.1f}" for k, (a, b) in
                      gather_ab.items() if k != "prob list")
          + f"; prob-domain list card {gather_ab['prob list'][0]:.1f} ms, "
          f"host {gather_ab['prob list'][1]:.1f} ms; examples: "
          + ", ".join(f"{k} {v['losses'][0]:.4f} -> {v['losses'][-1]:.4f}"
                      f" ({v['s']:.1f} s)" for k, v in examples.items()))
    print(f"# main path 9 (step = value and gradient; ShardedChainLoss at "
          "main path 1's width, T=150): " + "; ".join(
              f"{prec} on {n} rank(s) {rs[0]['ms']:.3f} ms (ChainLoss "
              f"{rs[0]['plain_ms']:.3f}), loss rel {rs[0]['loss_rel']:.2e}, "
              f"gradient bit-identical {all(r['grad_bitwise'] for r in rs)}"
              for (n, prec), rs in sorted(p9_sh.items()))
          + f"; recipe --dp at (d)'s width {p9_rec['width']['utts_per_s']!r} "
          f"utts/s (rel {p9_rec['width']['rel']:.2e}); dense_list "
          f"{p9_dense['ms']:.1f} ms (bfloat16 {p9_dense['bf16_ms']:.1f}) "
          f"against gather {p9_dense['gather_ms']:.1f} ms; "
          f"impl=\"leveled\" (auto: the semiring kernels) "
          f"{p9_lev['ms']:.3f} ms")
    a, b = p10["a"], p10["b"]
    print(f"# main path 10 (the model axis; gloo ranks sharing the card): "
          f"dryrun_multichip(2) / (4) loss rel {a[2]['loss_rel']:.2e} / "
          f"{a[4]['loss_rel']:.2e}, parameters {a[2]['param_rel']:.2e} / "
          f"{a[4]['param_rel']:.2e}; TDNN-512x{P10_LAYERS} on a (1x2) "
          f"mesh: a rank's "
          f"step {b['rank_ms']:.3f} ms against one process's "
          f"{b['one_ms']:.3f} ms (TF32 off), {b['comm_bytes']} bytes of mp "
          f"collectives a step; losses on the same weights "
          f"{b['same_w']:.2e} apart, from the same seed {b['loss_rel']:.2e} "
          f"(float32 {b['f32_loss_rel']:.2e}), first-step gradients "
          f"{b['grad_rel']:.2e} (float32 {b['f32_grad_rel']:.2e}), "
          f"parameters after step 1 "
          f"{b['step1_rel']:.2e} (float32 {b['f32_step1_rel']:.2e}), after "
          f"step 3 {b['param_rel']:.2e} (float32 {b['f32_param_rel']:.2e})")
    print(f"# seconds by main path: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PATH_SECONDS.items())
        + f"; {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
