#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--plain-curve | --only-tp | --only-train-tp |
                           --only-interp]

``--plain-curve`` adds phase H's diagnostics of ROADMAP's fault F2 and
check C2 (about 100 to 160 s of plain training steps, and the plain
versions' gradient against a plain scan whose y is summed in float64,
which the default run leaves out to stay inside its time limit).

Phases (any failure exits non-zero before the result line):

1. the card's name and power limit (``nvidia-smi``), the build of
   every kernel from the sources in ``src/repro_torch/csrc`` (nvcc,
   ``sm_90a``), and the CIM library's SASS (``cuobjdump``): int8
   tensor-core products (IGMMA) and no IDP4A;
2. the main path: vgg11-cifar10 at full width, random float weights
   from a numpy seed, quantized for serving and served through the
   streaming simulator (``serve_stream``, 8 frames, ``batch_window=4``)
   on the card — once with nominal ADCs, once with a device-variation
   model attached.  The card's engine handles (int8 weights,
   multipliers, ADC tables) must equal the CPU simulator's.  Each flavor
   first records the kernel calls of one batch (one per fire chunk of
   each conv layer, one per FC layer on the layer's whole operands:
   10); each counted run resets the kernel launch counts and the
   wrapper's weight-copy count just before and reads them just after:
   the flavor's variant launches once per recorded call per batch, the
   other never, and no weight is copied.  The same runs on the CPU
   (plain kernel versions, calibration copied from the card's engine)
   must give equal logits, counters, traffic and timeline, and
   ``measured_ii == analytic_ii``;
M. the main path's other four CNNs at full width, one after another:
   resnet18-cifar10, vgg16-imagenet, vgg19-imagenet and
   resnet50-imagenet (``dup_cap=128``), random float weights and frames
   from the numpy seed, quantized for serving and served on the card
   (8 frames, ``batch_window=4``) with nominal ADCs, and vgg16 once more
   with ``VARIATION_PRESETS["all"]``.  The same gates as phase 2 (the
   handles; the calls of one batch, one per FC layer; the counted
   run's launches; no weight copy), finite logits of the right shape,
   measured II == analytic II == the reference bench's (16, 784, 784,
   98), one batch equal to the CPU run (logits by value, counters,
   traffic, timeline), every recorded call equal to the plain version
   by value.  Build seconds, placed tiles, calls per batch, wall
   ms/frame, device busy share, the host seconds of the numerics and
   the accounting passes, the kernel's device time per batch and per
   FC call beside its bound (and vgg16's first FC layer as the grid's
   per-tile calls), the phase's seconds;
J. ``trace_jit`` and the CNN simulator's other flavors, on the weights,
   frames and simulators of phases 2 and M.  Each of the five CNNs is
   served again through ``build_stream_sim(..., trace_jit=True)`` (the
   conv blocks as captured CUDA-graph replays, the calibrated engine of
   the non-jit simulator): logits equal by value to the non-jit counted
   run, measured II == analytic II, counters, traffic and timeline
   identical; the first run captures every executor once and replays
   it per batch, a second run only replays, each counted (graphs,
   replays, the wrapper's launches, the replayed launches) and the
   replayed CIM launches seen under ``torch.profiler``; no weight copy.
   vgg11 also under ``VARIATION_PRESETS["all"]`` (equal to phase 2's
   variation run) and after ``set_variation(None)`` (equal to nominal).
   Wall ms/frame of jit and non-jit serving in turns, the numerics
   pass's host clock of each, device busy share, launches per replay,
   capture seconds.  The exact engine's ``trace_jit`` (float32, TF32
   off) on vgg11 at batch 64 within 1e-5 of the float64 run; the
   per-cell stream oracle (``run_stream(batched=False)``) on vgg11 and
   resnet18 equal to the batched stream (logits by value, per-frame
   counters and traffic, start / finish, FIFO depth, II); the CIM mode
   of ``cnn_forward`` on vgg11 (4 frames) and vgg16 (2 frames) through
   the kernel's 2-D layout, one launch a layer, equal by value to the
   CPU run;
3. each CIM variant against its plain PyTorch version on the card,
   equal by value, both output modes: at the main path's own calls, on
   random int8 inputs at those shapes for n_c in {32, 96, 256} with
   ragged rows, columns and depth, and over an edge grid at n_c = 256
   (R 1, 4, 16, 37, 4096; N 10, 64, 77, 512, 1000; kc 9, 29, 256; T 1,
   3, 7, 18, 40, and FC-layout slices with a ragged last step), each
   shape with its weight K-major and N-major; and below 8 bits (6-bit
   weights and activations with 6- and 4-bit ADCs, the robust DSE's
   precisions) at the main path's shapes and ragged ones;
4. the CIM kernel's device time under ``torch.profiler`` for each
   main-path call and per batch, both variants, beside its
   host-inclusive CUDA-event time, the plain version's device time, the
   bound and the share of it;
R. robustness: ``sweep_presets`` over all four variation presets, 4
   trials each, on vgg11 at full width with phase 2's params and
   frames.  Each trial (counts read just before and just after it)
   launches only the preset's variant (``cim_codes`` for noise and
   stuck, ``cim_codes_var`` for adc and all), as many times as a
   phase-2 batch; no weight copy over the sweep; the CIM library built
   and loaded once; the zero-magnitude run equal to the nominal one;
   the "all" preset's first trials rerun on the CPU (calibration
   copied) give equal agreements and logits equal by value.  Seconds
   per trial, split into ``set_variation`` and the run;
D. DSE: ``run_dse`` on vgg11 and resnet18-cifar10 (budget 8) validated
   on the CIM engine on the card, both winners equal to the snake
   baseline, winners, candidates and scores equal to a CPU search's;
   ``run_robust_dse`` on vgg11 (budget 8, 2 trials, batch 4): the
   zero-variation run equal to nominal, a front with a point below 8
   bits.  Wall seconds of each;
C. the cycle-level interpreter (``backend="interp"``): vgg11 (phase 2's
   weights and frames, 4 frames) on the CIM engine, nominal and under
   ``VARIATION_PRESETS["all"]``, and resnet18-cifar10 nominal, each
   held to the same simulator on ``backend="trace"`` on the card:
   logits equal by value, counters, traffic and per-link traffic
   identical; the counted run launches the flavor's variant once per
   MAC-firing slot of the decoded tables (``mac_slots``) plus once per
   FC layer, the other variant never, copies no weight, and passes
   under ``torch.cuda.set_sync_debug_mode("error")``; one recorded call
   of each distinct per-tile shape, each variant, equal by value to the
   plain version.  vgg11 on the exact engine with integer weights and
   frames: interp equals trace bitwise; and on the interpreter under
   each placement of ``dse/placements.py::strategies``: logits equal to
   the snake placement's, MACs equal, GROUP hops logged.  Seconds per
   run, launches per batch, host ms per cycle, and the device's busy
   share over vgg11's nominal run (device activity only: the host
   trace of 40,000 launches takes longer to parse than to run).
   ``--only-interp`` runs the builds and phase C alone (no
   result line; exit code 2 when every check held);
T. telemetry and chiplets: vgg11 served over 4 floret chiplets with a
   ``LinkRecorder`` and a ``MetricsRegistry`` attached: the nominal
   variant's launches as in phase 2, logits equal to the 1-chiplet run
   by value, measured II == analytic II, each frame's traffic equal to
   the analytic routed byte-hops and the heatmap equal to both per
   class with the NoI level, the registry's served-frame counter equal
   to the frames served, a Chrome trace of the serve (host spans and
   the stage timeline) valid after a round trip through
   ``build/chip_smoke/``.  ms/frame over 4 chiplets and 1, in turns,
   and with a recorder attached;
5. LM serving: gemma3-1b at full width (26 layers, vocab 262144) with
   random weights from ``torch.Generator(device="cuda").manual_seed(0)``,
   batch 4, a 2048-token prompt (four windows of 512, so the local
   layers slide) and ``LM_GEN`` = 8 greedy tokens through
   ``build_serve_program`` and ``greedy_generate`` — once with bfloat16 weights and KV cache,
   once with int8 CIM weights and an int8 KV cache.  Each counted run
   resets both attention kernels' launch counts just before and reads
   them just after: one launch of the bfloat16 (tensor-core) kernel per
   layer, 26, and none of the float32 one.  Prefill ms, decode ms/token
   and tokens/s (LM_REPS timed ``greedy_generate`` runs); the
   same prefill with the kernel's plain version swapped in must give
   logits within TOL_FULL_LOGITS;
6. the same full-width prefill of both flavors in float32 on the card
   (TF32 off), with the kernel and with its plain version swapped in:
   26 launches of the float32 (CUDA-core) kernel and none of the
   bfloat16 one, and every first token equal; the float32 prefill's ms
   (LM_REPS runs);
7. the same two flavors cut only in depth (6 layers: 5 local + 1
   global; batch 1, prompt 640, 4 tokens), in float32 on the card
   (TF32 off) and on the CPU (the kernel's plain version): logits within
   TOL_SMALL, tokens equal;
8. both attention kernels against their plain version on the card, within
   TOL_ATTN: at the 26 calls of one main-path prefill (bfloat16, and the
   same calls in float32), and where the tiling has edges: head dim 16,
   64, 128 and 256; S 37, 777 and 2049 (not multiples of the 64-key tile
   or the 128-row block); windows 1, 63, 65, 100, 513 and S; GQA groups
   1, 2, 4 and 8; soft cap off and 50.0; and granite's 24 / 8 heads at
   head dim 64, jamba's 32 / 8 at 128, seamless-m4t's 16 / 16 at 64 and
   internvl2's 16 / 8 at 128 (windows 65 and S); and the
   float32 kernel at its own edges: every head dim, S 63, 64, 65 and 129,
   windows 3, 4, 5, 7, 8, 9, 63, 64, 65 and S (its 4-key P V groups,
   8-row warps and 64-key tiles), groups 1 and 4, soft cap off
   and 50.0; each call launches its dtype's kernel once and the other
   never.  After phase F, the same for deepseek-v3's MLA head dims (q / k
   192 against v 128): its prefill's 4 calls in both dtypes; S 37, 777
   and 2049, windows 1, 63, 65, 100, 513 and S, groups 1 and 4, soft cap
   off and 50.0, in both dtypes; the float32 kernel at its own edges;
9. their times at the main path's calls: one local and one global launch
   and the whole prefill's 26 launches, as device time under
   ``torch.profiler`` (the wrapper's host time is not the kernel's),
   beside the plain version, ``scaled_dot_product_attention`` with the
   band mask, the same with ``is_causal=True`` on the global launches
   (exactly their function), and the bound; the rate on unmasked and on
   computed work (``tile_schedule`` at each kernel's tiles) and the share
   of the bound.
F. the MoE, Mamba and MLA LM families: granite-moe-3b-a800m and
   falcon-mamba-7b at full width, jamba-v0.1-52b at full width over one
   8-layer cycle, deepseek-v3-671b at full width over its first 4
   layers (3 dense, 1 MoE; no MTP, which serving never reads), random
   weights from a card generator seeded with SEED, each served as in
   phase 5 (batch 4, prompt 2048, 8 greedy tokens, bfloat16 and the
   int8 CIM flavor).  Each counted generation resets every kernel count
   just before and reads them just after: granite 32 launches of the
   bfloat16 attention kernel, falcon-mamba 64 of the selective scan,
   jamba 1 and 7, deepseek 4 of the attention kernel at its (192, 128)
   head dims, and nothing else; tokens in range, logits finite, two
   prefills bit-equal (the MoE combine is deterministic); the prefill
   with both kernels' plain versions swapped in within
   TOL_FAMILY_LOGITS.  The MoE capacity and the (token, k) pairs dropped
   in one prefill and one decode step; the flavor's peak device memory;
   prefill ms, decode ms/token, tokens/s; on the bfloat16 flavor every
   kernel call of one prefill held against its plain version, device
   time by kernel and the busy share of a prefill.  Then granite cut to 4 layers, falcon-mamba to 2, deepseek to
   its first 2 (dense), and jamba's reduced config, in float32 on the
   card and on the CPU as in phase 7; the
   scan kernel against its plain version (rtol = atol = TOL_SCAN) over
   S 1, 17, 37, 48, 2049, d_inner 256, 200, 130 and 5, d_state 4 and
   16, with and without an initial state; its device time per
   falcon-mamba prefill beside its bound and its plain version's; the
   phase's seconds;
E. the encoder-decoder and the vision-language model at full width and
   depth: seamless-m4t-large-v2 (24 + 24 layers) with LM_PROMPT random
   speech frames a row and internvl2-2b (24 layers) with its 256 patch
   embeddings, both drawn in bfloat16 (the params' dtype), served as in
   phase F in both flavors.  Each counted generation: 24 launches of the
   bfloat16 attention kernel (the decoder's causal self-attention;
   seamless's encoder and cross-attention are plain bidirectional
   blocks, no kernel) and nothing else; tokens in range, logits finite,
   two prefills bit-equal, the plain-kernel prefill within
   TOL_FAMILY_LOGITS, every bf16 kernel call of one prefill held against
   its plain version; prefill ms, decode ms/token, tokens/s, busy share,
   peak memory, device time by kernel.  One decoder launch of each timed
   as in phase 9 (device time, bound, plain, SDPA ``is_causal``);
   then seamless cut to 2 + 2 layers and internvl2 to 4 in
   float32 on the card and on the CPU as in phase 7; the phase's
   seconds.

G. the training path: gemma3-1b at full width and depth (26 layers),
   random bfloat16 weights from a card generator seeded with SEED in the
   reference's stacked layout, AdamW with float32 moments (lr 3e-3,
   warmup 2), ``remat="full"``, batch 4 x 2048, 8 steps on one fixed
   ``synthetic_batch`` (the reference's test_train_steps_decrease_loss),
   through ``build_train_program``'s ``step_fn`` under the ``StepGuard``.
   One step's gradients with the kernels, each of its 26 backward calls
   held against the plain version, then with the plain versions swapped
   in (loss and every gradient leaf within TOL_TRAIN_PLAIN_*).  Each
   counted step resets the launch counts just before and reads them
   just after: 26 + 24 recomputed launches of the bfloat16 forward
   kernel and 26 of the backward one; the loss falls by TRAIN_LOSS_DROP;
   the first step repeated from the same state is bit-equal; a
   checkpoint saved at step 4 and restored gives steps 5 to 8 bit-equal
   to the uninterrupted run.  Step ms, tokens/s, peak device memory
   (the backward's row is timed in phase I); the backward
   kernel against its plain version over an edge grid (head dims 16 to
   256, S 37, 777, 2049, windows 1, 65, 513, S, groups 1, 4, 8, soft
   cap off and 50.0, both dtypes: both routes at every built head dim;
   MLA's (192, 128) pair at group 1);
   then 12 layers in float32 (batch 1 x 640, TF32 off) on the card and
   on the CPU: loss, every gradient leaf and one AdamW step's params
   within TOL_TRAIN_F32_*, and the float32 route at gemma3-1b's
   full-width call shapes (batch 4 x 2048, windows 512 and 2048), each
   call held against the plain version.  After the builds, the backward
   library's SASS:
   its tensor-core kernels hold HGMMA and UTMALDG, its CUDA-core kernels
   LDS.128, and none a global atomic.
H. the MoE, Mamba and hybrid families trained: granite-moe-3b-a800m at
   full width and depth (32 layers, 3.30 G parameters) and
   falcon-mamba-7b at full width cut to ``H_LAYERS`` layers, random
   bfloat16 weights from a card generator seeded with SEED, AdamW as
   phase G (falcon-mamba at ``H_LR``), ``remat="full"``, batch 4 x 2048,
   8 steps on phase G's fixed batch, each step donating its params and
   optimizer state (one copy of the state on the card), under the
   ``StepGuard``. One step's gradients with the kernels, every
   scan-backward call held against ``selective_scan_bwd_plain`` (each
   gradient within TOL_SCAN_BWD of its largest |value|) and every
   attention-backward call against its plain version; the same gradients
   again, bit-equal; then with the plain versions of both kernels
   swapped in (TOL_TRAIN_PLAIN_*; for falcon-mamba with
   ``--plain-curve`` also the plain versions against a plain scan whose
   y is summed in float64, the gate's noise floor). Each counted step
   resets every count just before
   and reads them just after: the launches ``step_launches`` predicts
   for attention and Mamba layers (granite 64 + 32 of the attention
   kernels; falcon-mamba 2 forward scans and one backward a layer); the
   loss falls by TRAIN_LOSS_DROP; the first step repeated from a new
   init of the same seed gives the same loss and the same params and
   moments (every leaf's ``fingerprint``: a difference in any one
   element changes it). Step ms, tokens/s, peak device memory; the
   scan backward's device time per
   call and per step (its two kernels) beside its bound and its plain
   version (no library call computes the scan), with each kernel's
   registers a thread, the walk's resident blocks an SM and its waves at
   the call; with ``--plain-curve``, for falcon-mamba, the counted steps
   again from a new init of the same seed with every plain version
   swapped in (ROADMAP's fault F2: both loss curves side by side, and
   whether they part by more than the first step's kernel-vs-plain loss
   difference; no gate). Then the
   float32 cuts (granite at 4 layers of full width, falcon-mamba at 2,
   jamba at its reduced config; batch 1 x 640, TF32 off) on the card
   and on the CPU: the MoE slot tables equal, then phase G's float32
   gates;
   the scan backward against its plain version over an edge grid (S 1,
   3, 4, 5, 9, 15, 16, 17, 2049, d_inner 256, 130, 5, d_state 4 and 16,
   with and without h0 and dh_last). After the builds, the scan backward
   library's SASS holds no global atomic, and each walk kernel's
   MUFU.EX2 count is its two forward walks' (no expf in the walk back).
I. MLA with multi-token prediction, the encoder-decoder and the vit_stub
   frontend trained: deepseek-v3-671b at full width cut to its first 3
   layers (all dense) with its MTP block (``I_LAYERS``),
   seamless-m4t-large-v2 (24 + 24 layers, frames drawn in bfloat16) and
   internvl2-2b (24 layers, 256 patch embeddings in bfloat16) at full
   width and depth; random bfloat16 weights from a card generator seeded
   with SEED, AdamW as phase G, ``remat="full"``, batch 4 x 2048, each
   step donating its params and optimizer state, under the
   ``StepGuard``.  One step's gradients with the kernels, every
   attention-backward call held against the plain version within TOL_BWD
   (deepseek's (192, 128) calls head slice by head slice:
   ``bwd_plain_sliced``), the same gradients again, bit-equal; then
   ``I_STEPS`` counted steps, each resetting the counts just before and
   reading them just after: the launches ``step_launches`` predicts
   (deepseek: the 3 layers, again in their recompute, and the MTP layer
   once, 7 forward and 4 backward launches; each encoder-decoder
   decoder layer twice and once), finite losses, the first step repeated
   from a new init of the same seed with the same fingerprint.  Step ms,
   tokens/s and peak device memory.  The backward kernel at deepseek's
   call (q, k (4, 2048, 128, 192), v (4, 2048, 128, 128), full causal):
   device time by kernel and by events beside its bound, the plain
   version and SDPA's autograd by events with each backend forced.  Then
   float32 cuts on the card and on the CPU with phase G's gates: an MLA
   + MTP cut (``mla_small``: MLA's head dims, so the CUDA-core (192,
   128) instantiation runs, and an MoE MTP layer), seamless 2 + 2 and
   internvl2 2 layers at full width (batch 1 x 640, TF32 off).
P. Serving at tp > 1 through the port's mesh (``launch/mesh.py``): one
   spawn of ``P_WORLD`` = 4 ranks, all on cuda:0 (the script needs one
   card, and NCCL refuses two ranks on one device), whose collectives
   take gloo's explicit host copies (``core/dataflow.py``).  Each rank
   draws the global weights from the phase's seeded card generator and
   keeps its shard of each layer as it is drawn, so the tp = 1 and
   tp > 1 runs compute with the same weights.  bfloat16 at full width,
   batch 4, prompt 2048, ``P_GEN`` = 4 greedy tokens (``P_BF16_STEPS``):
   gemma3-1b
   on mesh (2, 2) (the group trick: 2 heads on 1 kv head a rank), ring
   and all-reduce, bf16 and int8 weights + KV; qwen2-0.5b on (1, 4) (14
   heads: replicated attention, the sequence-sharded cache), bf16 and
   int8; granite-moe-3b-a800m (20 experts a rank), falcon-mamba-7b cut to
   ``P_MAMBA_LAYERS`` (the scan at 4096 channels a rank) and
   deepseek-v3-671b's first 4 layers (64 heads and 128 experts a rank;
   its ranks draw one after the other) on (1, 2).  Gates, per rank: one
   prefill's launches those of tp = 1 and the kernels' call shapes the
   rank's (``P_LAUNCHES``), every collective through the host, two
   prefills bit-equal, the padded vocabulary columns at -1e30, the
   model ranks of a data row returning the same logits; prefill logits
   within 0.1 max / 0.03 mean of the tp = 1 run on the card (gemma3,
   qwen2, falcon-mamba) or, where per-rank MoE capacity drops other
   pairs than tp = 1 does (granite, deepseek), of the same tp > 1 run
   with the plain kernels, within ``TOL_FAMILY_LOGITS``; ring and
   all-reduce within the same bounds of each other.  Then float32 cuts
   of every family at tp 2 (``P_F32_CUTS``, on falcon-mamba's mesh while
   granite's ranks serve granite), each on the card and again on the CPU with the
   card's shards: tokens equal, logits within TOL_SMALL, each rank's
   MoE slot tables equal, and (bf16 flavor, no capacity difference)
   tokens and logits equal to the tp = 1 card run.  Logged, labelled
   as ranks sharing one card with collectives crossing the host: prefill
   ms and decode ms/token per reduction at tp > 1 and gemma3's at
   tp = 1, bytes each rank sends per prefill, the device busy share of
   a rank's prefill.  ``--only-tp`` runs the builds and phase P alone
   (no result line, exit code 2).
Q. Training at tp > 1: phase P's 4 ranks on cuda:0 over gloo host copies
   run phase Q's program after phase P's (one spawn, so each process
   starts and reaches the card once; spawned alone, as for
   ``--only-train-tp``, a gloo timeout of ``Q_TIMEOUT_S``, so a deadlock
   fails fast).  gemma3-1b at full width and depth, bf16, on mesh (2, 2)
   with the ring: phase G's recipe (AdamW, lr 3e-3, warmup 2, ``remat=
   "full"``), ZeRO-1 states over both axes, phase G's fixed batch of 4 x
   2048 (2 rows a data rank) and seed, each rank holding its shard of
   the same global draws.  Gates, per rank: the first step's every
   forward and backward attention call within ``TOL_ATTN`` /
   ``TOL_BWD`` of its plain version; its loss and each reduced gradient
   leaf (the ranks' slices, L2 summed over them) within
   ``TOL_TRAIN_PLAIN_LOSS`` / ``TOL_TRAIN_PLAIN_GRAD`` of phase G's
   first tp = 1 step (phase G keeps its gradients on the host for this);
   ZeRO-3 from the same init: the loss and the reduced gradients
   bit-equal to the baseline's, params and moments within 1e-6 of each
   leaf's max, each ZeRO-3 leaf half a rank; the all-reduce baseline's
   loss and gradients within the same gates of the ring's; then
   ``Q_STEPS`` counted ring steps from a new init of the seed: the first
   bit-equal to the checked step (fingerprints), each step's launches
   ``step_launches``' at the rank's shapes, the first two losses within
   ``TOL_TRAIN_PLAIN_LOSS`` of phase G's.  Float32 cuts: every family's
   reduced config at tp 2 on (1, 2), and gemma3's with ZeRO-3, dp_only
   and int8 gradient compression on (2, 2), one step on the card ranks
   and on CPU ranks from the card's shards, and at tp = 1 on the card:
   loss and gradients within ``TOL_TRAIN_F32_*``, params within 2 lr and
   within lr / 1000 where the gradient is above ``Q_HELD`` of its leaf's
   max, each step's float32 launches.  Logged (ranks share one card over
   host copies; no time claimed): step ms a rank, bytes each rank sends
   a step and a gradient's ring against all-reduce, the busy share, peak
   memory a rank.  ``--only-train-tp`` runs the builds, phase G's first
   step, phase Q and F2's curves (no result line, exit code 2).
F2. After phase H: falcon-mamba's reduced config in float32 for 8 steps
   of phase H's recipe on the card (kernels) and on the CPU (plain
   versions), each step's loss logged against ``TOL_F2`` (ROADMAP's
   fault F2; it gates nothing).
X. After phase Q: the dry run (``launch/dryrun_lib.py``: one rank's
   program on fake tensors over a fake process group, counted by
   ``analysis/op_stats.py::OpStats``) against the card's counts.  Its
   four dry cells run in one process of their own, started before phase
   P, after phase G's timed steps (host work; nothing of theirs runs on
   the card).  (a) phase 5's gemma3-1b bf16 prefill (batch 4, prompt
   2048, tp = 1) once more, untimed, under ``OpStats`` on the card:
   flops (all, and by the dtype whose peak they run at), HBM bytes and
   each kernel's calls equal the dry run's, the calls the ``LAUNCHES``
   delta, the dry run's memory within ``TOL_X_PREFILL_MEM`` of the
   card's ``max_memory_allocated`` over the prefill; the roofline's
   bound (``analysis/roofline.py::H100_SXM``) logged beside phase 5's
   prefill ms.  (b) phase G's step: the dry run's kernel calls phase G's
   launches a step, its memory within ``TOL_X_TRAIN_MEM`` of phase G's
   peak.  (c) phases P's and Q's ring cells on (2, 2) (gemma3's bf16
   ring prefill, its ring step): the dry run's wire bytes of rank 0
   equal to the byte to what that rank counted.

The line before the last is the ``kernels`` JSON (a CIM variant's
``launches`` summed over the counted runs of phases 2, M and C, its
times phase 4's, per vgg11 batch; the bfloat16 attention kernel's
launches those of phases 5, F, E, G, H, I, P and Q (P's counted
prefills and Q's counted steps summed over their ranks), its times
phase 9's; the float32 kernel's phase 6's and Q's float32 cuts'; the scan's launches those
of phases F, H and P, its times per falcon-mamba prefill; the attention backward's launches those of the counted steps
of phases G, H, I and Q (and Q's float32 cuts), its times a call at deepseek's (192, 128)
training call (phase I; gemma3's per step are in phase G's log); the
scan
backward's launches those of phase H's counted steps, its times per
falcon-mamba training step); the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# the port, beside this script: its H100 peaks and the kernels' work
# formulas, one source with the dry run's counts
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:
    from repro_torch.analysis.roofline import H100_SXM
    from repro_torch.kernels.cim_matmul import work
    from repro_torch.kernels.local_attention import (attn_work, bwd_bytes,
                                                     bwd_work)
    from repro_torch.kernels.selective_scan import scan_bwd_work, scan_work
except ImportError as e:
    sys.exit(f"chip_smoke: the port is not beside this script: {e}")

SEED = 0
FRAMES = 8
BATCH_WINDOW = 4
WALL_REPS = 7
#: phase 3's edge grid for the CIM kernel (``edge_cases``)
EDGE_NC = 256
EDGE_R = (1, 4, 16, 37, 4096)
EDGE_N = (10, 64, 77, 512, 1000)
EDGE_T = (1, 3, 7, 18, 40)
EDGE_T_FC = (1, 3, 7)
#: phase M: the main path's other four CNNs at full width, each with the
#: dup_cap and the analytic II of the reference's bench (``BENCH_core.json``
#: ``stream_*`` rows; ``benchmarks/run.py`` serves resnet50 at 128)
MODELS = {"resnet18-cifar10": (64, 16), "vgg16-imagenet": (64, 784),
          "vgg19-imagenet": (64, 784), "resnet50-imagenet": (128, 98)}
#: the phase-M model also served with VARIATION_PRESETS["all"]
MODEL_VARIATION = "vgg16-imagenet"
#: phase M's timed serving runs per model, and profiled passes over the
#: recorded calls of one batch
MODEL_WALL_REPS = 3
MODEL_TIME_REPS = 5
#: phase R: Monte-Carlo trials per preset on the card, and how many of
#: the "all" preset's are rerun on the CPU
ROBUST_TRIALS = 4
ROBUST_CPU_TRIALS = 2
#: phase D: DSE budget per model, and the robust DSE's trials and batch
DSE_BUDGET = 8
DSE_TRIALS, DSE_BATCH = 2, 4
#: phase C: the interpreter's models, the frames a run moves through the
#: chain, and the phase's time budget (logged against, not a gate)
C_MODELS = ("vgg11-cifar10", "resnet18-cifar10")
C_FRAMES = 4
C_BUDGET_S = 30.0
#: phase T: the chiplet fabric
CHIPLETS, NOI_TOPOLOGY = 4, "floret"
#: phase J: the exact engine's trace_jit at the reference bench row's
#: batch (``benchmarks/run.py``: ``network_sim_vgg11_b64_trace_jit``),
#: held to the float64 run within the reference's own tolerance for its
#: float32 flavor (``tests/test_trace.py``, rtol = atol)
JIT_EXACT_BATCH = 64
TOL_JIT_EXACT = 1e-5
#: phase J: the models the per-cell stream oracle runs on, and the CIM
#: mode's models with their frames (the kernel's grid holds 65,535 row
#: tiles of 32: vgg16's first conv at 4 frames is 200,704 rows)
PERCELL_MODELS = ("vgg11-cifar10", "resnet18-cifar10")
CIM_MODE_FRAMES = {"vgg11-cifar10": 4, "vgg16-imagenet": 2}
#: phase 3's precisions below 8 bits, (w_bits, a_bits, adc_bits): the
#: robust DSE's 6-bit operands with 6- and 4-bit ADCs
LOW_PRECISION = ((6, 6, 6), (6, 6, 4))
#: the H100's peaks (int8 and bf16 tensor-core rates, float32 outside
#: the tensor cores, HBM3 bandwidth): the port's
#: (``analysis/roofline.py::H100_SXM``)
PEAK_INT8_OPS = H100_SXM.peak("int8")
PEAK_BF16_OPS = H100_SXM.peak("bfloat16")
PEAK_F32_OPS = H100_SXM.peak("float32")
PEAK_BYTES = H100_SXM.hbm_bw
KERNEL_SOURCE = "src/repro_torch/csrc/cim_matmul.cu"
REPLACES = {"cim_codes": "src/repro/kernels/cim_matmul.py:36",
            "cim_codes_var": "src/repro/kernels/cim_matmul.py:65"}
ATTN_SOURCE = "src/repro_torch/csrc/local_attention.cu"
ATTN_REPLACES = "src/repro/kernels/local_attention.py:26"
#: the attention kernel of each dtype (``LAUNCHES`` keys)
ATTN_KERNEL = {torch.bfloat16: "local_attention",
               torch.float32: "local_attention_f32"}

LM_ARCH = "gemma3-1b"
#: LM_GEN greedy tokens a served generation: their range is checked and
#: their decode steps timed (8, not 32, since phase Q joined: the
#: script's time limit; the median decode step takes 7 intervals)
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 8
#: timed generations per flavor: one since phase I joined (the script's
#: time limit; the medians of 3 cost about 77 s on a slow host)
LM_REPS = 1
#: (name, kv_dtype, cim_weights): bfloat16 weights and cache, and the
#: Domino flavor of examples/serve_lm.py (int8 CIM weights, int8 cache)
LM_FLAVORS = (("bf16", "bfloat16", False), ("cim_int8", "int8", True))
#: the reduced-depth check: full width, 5 local + 1 global layers
SMALL_LAYERS, SMALL_PROMPT, SMALL_GEN = 6, 640, 4
#: prefill logits of the kernel run vs the plain-attention run, both in
#: bfloat16 (logits' spread about +-4 here): the two round p and each
#: layer's output at other points, and 26 layers of random weights
#: carry the difference on.  The max |diff| bound was stated before the
#: first run (0.1; that run measured 0.082 max, 0.0126 mean); the mean
#: bound catches a systematic error that the max would let through.
#: With random weights the logits are flat (top-2 margins down to 0.0035
#: in bfloat16), so the first tokens are held equal in float32 (phase 6)
TOL_FULL_LOGITS = 0.1
TOL_FULL_LOGITS_MEAN = 0.03
#: card float32 vs CPU float32, rtol = atol: the sums run in other
#: orders (1e-3); with the int8 cache a value on a rounding edge may
#: flip a code on one side (5e-3 for the decode logits)
TOL_SMALL = {"bfloat16": 1e-3, "int8": 5e-3}
#: kernel vs plain version, rtol = atol: float32 as the reference holds
#: its kernel to its oracle; bfloat16 one ulp (2^-8) and then some
TOL_ATTN = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
#: phase 8's GQA shapes of the phase-F and phase-E models, (query heads,
#: kv heads, head dim): granite's group of 3, jamba's group of 4,
#: seamless-m4t's decoder (group 1 at 64) and internvl2 (group 2 at 128)
ATTN_FAMILY_SHAPES = ((24, 8, 64), (32, 8, 128), (16, 16, 64),
                      (16, 8, 128))
#: phase 8's grid at the float32 kernel's own edges: S on each side of
#: its 64-row blocks and 64-key tiles, windows on each side of its 4-key
#: P V groups, 8-row warps and 64-key tiles
EDGE_F32_S = (63, 64, 65, 129)
EDGE_F32_WINDOWS = (3, 4, 5, 7, 8, 9, 63, 64, 65)

#: phase F: the MoE, Mamba and MLA families at the published widths,
#: batch LM_BATCH, an LM_PROMPT-token prompt and LM_GEN greedy tokens in
#: both flavors; jamba cut in depth to one 8-layer cycle (7 mamba
#: layers, the attention layer at 4, MoE on the odd layers: 13.3 G
#: parameters, 27 GB in bfloat16; the 32-layer model's 104 GB do not fit
#: one card); deepseek-v3 cut to its first 4 layers (3 dense of d_ff
#: 18432, then 1 MoE of 256 experts top-8 and a shared one: 15.1 G
#: parameters, 30.2 GB in bfloat16; the 61 layers' 671 G do not fit one
#: card) and its MTP block left out (``family_config``: serving never
#: reads it)
FAMILY_LAYERS = {"granite-moe-3b-a800m": None, "falcon-mamba-7b": None,
                 "jamba-v0.1-52b": 8, "deepseek-v3-671b": 4}
#: launches of each kernel in one generation (the prefill; decode
#: launches none)
FAMILY_LAUNCHES = {
    arch: {"local_attention": attn, "local_attention_f32": 0,
           "local_attention_bwd": 0, "selective_scan": scan,
           "selective_scan_bwd": 0}
    for arch, attn, scan in (("seamless-m4t-large-v2", 24, 0),
                             ("internvl2-2b", 24, 0),
                             ("granite-moe-3b-a800m", 32, 0),
                             ("falcon-mamba-7b", 0, 64),
                             ("jamba-v0.1-52b", 1, 7),
                             ("deepseek-v3-671b", 4, 0))}
#: phase F's card-against-CPU check in float32: the published widths cut
#: to 4 layers (falcon-mamba to 2, paying for phase P's time: its CPU
#: run took the longest), deepseek's to its first 2 (both dense: 3.0 G parameters,
#: 12 GB in float32, with all 128 heads through the float32 kernel at
#: (192, 128)), jamba at its reduced config (None: a full-width MoE cycle
#: in float32 is too large for the host)
FAMILY_SMALL_LAYERS = {"granite-moe-3b-a800m": 4, "falcon-mamba-7b": 2,
                       "jamba-v0.1-52b": None, "deepseek-v3-671b": 2}
#: prefill logits of the kernels' run vs the plain versions' run, both in
#: bfloat16, (max |diff|, mean |diff|), stated before the first run on
#: the card.  Logits spread about +-4.  falcon-mamba: the two scans agree
#: to float32 rounding, but y is rounded to bfloat16, so an element on a
#: rounding edge flips an ulp and 64 layers carry it on (gemma3's 26
#: attention layers measured 0.082 max, 0.0126 mean).  granite: the
#: attention kernel rounds as gemma3's does, and in 32 layers of top-8
#: of 40 experts a router near-tie flips an expert of weight ~0.07.
#: jamba: a flipped top-2 expert carries weight ~0.5.  The mean bound
#: catches a systematic error (a wrong kernel moves every logit).
#: deepseek-v3 (stated before its first run on the card): the attention
#: kernel rounds as gemma3's does, over 4 layers, not 26; its one MoE
#: layer is the last, so only the last token's routing reaches the
#: logits, and a near-tie in its top-8 of 256 can flip an expert of
#: renormalized weight about 1/8, which moves the logits by a few
#: hundredths of their spread: granite's bounds.
#: seamless-m4t and internvl2 (phase E; stated before their first run on
#: the card): only the 24 causal self-attention layers go through the
#: kernel (seamless's encoder and cross-attention are the same plain
#: blocks in both runs), which rounds as gemma3's does (26 layers
#: measured 0.082 max, 0.0126 mean); the bounds leave gemma3's margin
#: for the other logit spread of a tied (seamless, embeddings scaled by
#: 0.02) and an untied head (internvl2): falcon-mamba's bounds.
TOL_FAMILY_LOGITS = {"seamless-m4t-large-v2": (0.25, 0.05),
                     "internvl2-2b": (0.25, 0.05),
                     "granite-moe-3b-a800m": (0.5, 0.05),
                     "falcon-mamba-7b": (0.25, 0.05),
                     "jamba-v0.1-52b": (2.0, 0.1),
                     "deepseek-v3-671b": (0.5, 0.05)}
#: phase E: the encoder-decoder and the vision-language model at the
#: published widths and depths, served as in phase F: seamless-m4t-large-
#: v2 (24 + 24 layers, 1.77 G parameters, 3.5 GB in bfloat16) with
#: LM_PROMPT random speech frames (1024 wide) a row, as the reference's
#: serving CLI draws them, and internvl2-2b (24 layers, 1.89 G, 3.8 GB)
#: with its 256 patch embeddings; the extras in the params' dtype (with
#: bfloat16 params the reference's decoder refuses float32 frames, and
#: float32 patch embeddings would run internvl2's stream in float32)
E_ARCHS = ("seamless-m4t-large-v2", "internvl2-2b")
#: phase E's card-against-CPU check in float32: seamless 2 + 2 layers,
#: internvl2 4 (SMALL_PROMPT holds its 256 patch tokens)
E_SMALL_LAYERS = {"seamless-m4t-large-v2": 2, "internvl2-2b": 4}
#: phase F's MLA model: its prefill's attention calls, at the kernel's
#: (192, 128) head dims, are held against the plain version over phase
#: 8's grid and timed as in phase 9
MLA_ARCH = "deepseek-v3-671b"
#: phase F's kernels as the profiler names them (bfloat16 attention,
#: scan)
FAMILY_KERNEL_NAMES = ("tc::attn_kernel", "scan_kernel")
#: the model whose prefill times the scan kernel, and the kernel's row
SCAN_ARCH = "falcon-mamba-7b"
SCAN_SOURCE = "src/repro_torch/csrc/selective_scan.cu"
#: no TPU kernel: the reference's associative scan, which it replaces
SCAN_REPLACES = "src/repro/models/ssm.py:107"
#: scan kernel vs plain version, rtol = atol: both round each multiply
#: and add of the state apart; y's sum over d_state runs in another
#: order, with fused multiply-adds
TOL_SCAN = 1e-5
#: phase F's edge grid for the scan: S below, at and past the 16-step
#: runs and the 3-run ring (1, 17, 37, 48, 2049), d_inner a multiple of
#: the 64-channel blocks (256), not one (200, 130), and not a multiple
#: of 4 (5: 4-byte copies in place of 16-byte ones)
EDGE_SCAN_S = (1, 17, 37, 48, 2049)
EDGE_SCAN_D = (256, 200, 130, 5)
EDGE_SCAN_N = (4, 16)


#: the script's start, for the elapsed seconds at the end of each log line
T_START = time.perf_counter()


def log(*a) -> None:
    print(*a, f"[{time.perf_counter() - T_START:.0f} s]", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


#: failed checks of the LM phases, reported together at the end so one
#: run shows every phase
FAILURES = []


def check(ok: bool, msg: str) -> None:
    if not ok:
        log(f"CHECK FAILED: {msg}")
        FAILURES.append(msg)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal by value (``-0.0 == 0.0``; the reference itself disagrees
    on the sign of zero)."""
    return a.shape == b.shape and torch.equal(a + 0.0, b + 0.0)


def counters_equal(ra, rb) -> bool:
    import dataclasses

    return (all(dataclasses.asdict(x) == dataclasses.asdict(y)
                for x, y in zip(ra.frame_counters, rb.frame_counters))
            and all(dict(x.byte_hops) == dict(y.byte_hops)
                    and dict(x.packets) == dict(y.packets)
                    for x, y in zip(ra.frame_traffic, rb.frame_traffic))
            and np.array_equal(ra.start, rb.start)
            and np.array_equal(ra.finish, rb.finish))


def cnn_params(cnn, rng):
    """Random float weights of every layer, scaled by fan-in."""
    from repro_torch.configs.cnn import ConvLayer

    params = {}
    for layer in cnn.layers:
        shape = ((layer.k, layer.k, layer.c, layer.m)
                 if isinstance(layer, ConvLayer) else
                 (layer.c_in, layer.c_out))
        params[layer.name] = (rng.standard_normal(shape)
                              / np.sqrt(np.prod(shape[:-1])))
    return params


def serving_walls(sim, frames, reps: int = WALL_REPS):
    """Wall time per frame of ``reps`` serving runs: host clock around
    whole ``serve_stream`` runs that end in a synchronize."""
    from repro_torch.runtime.serve_loop import serve_stream

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        serve_stream(sim, frames, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / len(frames))
    return walls


def check_cim_sass(lib) -> None:
    """The CIM library's dots run on the int8 tensor cores: its SASS
    holds IGMMA (or IMMA) and no IDP4A."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        log("[build] cuobjdump not found: SASS not checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sass.count(op) for op in ("IGMMA", "IMMA", "IDP4A")}
    log(f"[build] {lib.name} SASS: {counts}")
    if counts["IGMMA"] + counts["IMMA"] == 0 or counts["IDP4A"]:
        fail(f"the CIM kernel's SASS {counts}: want int8 tensor-core "
             "products and no IDP4A")


def check_bwd_sass(lib) -> None:
    """The backward's tensor-core route (its kernels are in namespace
    tcb) runs its products on wgmma (HGMMA) and loads its tiles by TMA
    (UTMALDG); its CUDA-core route (cc_stats, cc_dkdv, cc_dq) reads its
    tiles 16 bytes at a time (LDS.128) in every kernel; and no kernel of
    either holds a global atomic (RED, ATOM, ATOMG): every gradient is
    summed in one block or cluster in a fixed order.  (ATOMS, on a
    shared-memory counter, picks which tensor-core warpgroup refills a
    ring stage.)"""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        log("[build] cuobjdump not found: SASS not checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    every = sass.split("Function : ")[1:]
    funcs = [f for f in every if "3tcb" in f.split("\n", 1)[0]]
    ops = ("HGMMA", "UTMALDG", "RED.", "ATOM.", "ATOMG", "ATOMS")
    counts = {op: sum(f.count(op) for f in funcs) for op in ops}
    log(f"[build] {lib.name} SASS of the {len(funcs)} tensor-core backward "
        f"kernels: {counts}")
    mla = [f for f in funcs if "ILi192ELi128E" in f.split("\n", 1)[0]]
    if len(funcs) != 12 or len(mla) != 3 or not counts["HGMMA"] or \
            not counts["UTMALDG"] or \
            not all("HGMMA" in f and "UTMALDG" in f for f in mla) or \
            counts["RED."] + counts["ATOM."] + counts["ATOMG"]:
        fail(f"the backward's tensor-core kernels' SASS {counts} in "
             f"{len(funcs)} kernels ({len(mla)} at (192, 128)): want 12 "
             f"kernels (3 at each of 4 pairs), wgmma and TMA in each of "
             f"MLA's, no global atomics")
    # the CUDA-core kernels: float32 at 5 head-dim pairs and bfloat16 at
    # (16, 16)
    cc = [f for f in every if any(name in f.split("\n", 1)[0]
                                  for name in BWD_KERNELS[3:])]
    ops = ("LDS.128", "RED.", "ATOM.", "ATOMG")
    counts = {op: sum(f.count(op) for f in cc) for op in ops}
    wide = sum(1 for f in cc if "LDS.128" in f)
    log(f"[build] {lib.name} SASS of the {len(cc)} CUDA-core backward "
        f"kernels: {counts}, LDS.128 in {wide}")
    if len(cc) != 18 or wide != len(cc) or \
            counts["RED."] + counts["ATOM."] + counts["ATOMG"]:
        fail(f"the backward's CUDA-core kernels' SASS {counts} in {len(cc)} "
             f"kernels, LDS.128 in {wide}: want 18 kernels, each with "
             f"LDS.128, no global atomics")


def cnn_inputs(name: str = "vgg11-cifar10"):
    """(config, float params, frames) of a CNN at full width, from one
    numpy generator seeded with SEED: vgg11's for phase 2 and the later
    vgg11 phases, the other four models' for phase M."""
    from repro_torch.configs.cnn import CNN_BENCHMARKS

    cnn = CNN_BENCHMARKS[name]()
    rng = np.random.default_rng(SEED)
    params = cnn_params(cnn, rng)
    frames = rng.random((FRAMES, cnn.input_hw, cnn.input_hw, 3))
    return cnn, params, frames


def check_handles(sim, cpu, what: str) -> None:
    """The card simulator's engine handles hold the CPU one's values:
    int8 weights, dequantization multipliers and ADC tables (each side
    quantized its own float weights; calibration copied)."""
    for li, h in sim._handles.items():
        g = cpu._handles[li]
        for field in ("w8_stack", "w8", "deq", "adc"):
            a, b = getattr(h, field, None), getattr(g, field, None)
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a.cpu(), b)):
                fail(f"{what}: {sim.cnn.layers[li].name}'s {field} on the "
                     "card differs from the CPU's")


def check_calls(sim, calls, what: str):
    """The recorded calls of one batch: one kernel call per fire chunk of
    every conv layer or width strip (``TraceExecutor`` bounds each call's
    working set), then exactly one per FC layer on the layer's whole
    (B, c_in) x (c_in, c_out) operands.  Returns (conv calls, FC
    layers)."""
    from repro_torch.configs.cnn import FCLayer

    conv = conv_calls(sim)
    want = [((BATCH_WINDOW, l.c_in), (l.c_in, l.c_out))
            for l in sim.cnn.layers if isinstance(l, FCLayer)]
    if len(calls) != conv + len(want):
        fail(f"{what}: {len(calls)} kernel calls per batch, want {conv} "
             f"conv + {len(want)} FC")
    shapes = [(tuple(x.shape), tuple(w.shape)) for x, w, _, _ in calls[conv:]]
    if shapes != want:
        fail(f"{what}: FC calls {shapes}, want one per layer {want}")
    return conv, len(want)


def reset_counts(km):
    for k in km.LAUNCHES:
        km.LAUNCHES[k] = 0
    km.WEIGHT_COPIES = 0
    torch.cuda.synchronize()


def main_path(km):
    """Phase 2: serve vgg11-cifar10 on the card, nominal then with
    device variation; hold each against the CPU run."""
    from repro_torch.convert import copy_calibration, params_from_reference
    from repro_torch.core.engine import CIMEngine
    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.runtime.serve_loop import (
        build_stream_sim,
        quantize_cnn_params_for_serving,
        serve_stream,
    )

    cnn, params, frames = cnn_inputs()
    t0 = time.perf_counter()
    sims = {}
    for dev in ("cuda", "cpu"):
        qp = quantize_cnn_params_for_serving(params_from_reference(params, dev))
        eng = None
        if dev == "cpu":
            eng = copy_calibration(sims["cuda"].pe_engine,
                                   CIMEngine(device="cpu"))
        sims[dev] = build_stream_sim(cnn, qp, engine=eng, device=dev)
    check_handles(sims["cuda"], sims["cpu"], cnn.name)
    log(f"[e2e] {cnn.name}: {sims['cuda'].plan.total_tiles} placed tiles, "
        f"built in {time.perf_counter() - t0:.1f} s (calibrated on the card)")
    # warm the card (first launches, allocator) outside the counted runs
    serve_stream(sims["cuda"], frames[:BATCH_WINDOW], batch_window=BATCH_WINDOW)
    torch.cuda.synchronize()

    launches, wall, calls, reps = {}, {}, {}, {}
    for flavor, var in (("nominal", None), ("variation", VARIATION_PRESETS["all"])):
        if var is not None:
            for sim in sims.values():
                sim.set_variation(var)
            check_handles(sims["cuda"], sims["cpu"], f"{cnn.name} {flavor}")
        name = "cim_codes" if var is None else "cim_codes_var"
        calls[name] = record_calls(km, sims["cuda"], frames)
        check_calls(sims["cuda"], calls[name], f"{cnn.name} {flavor}")
        want = {k: 0 for k in km.LAUNCHES}
        want[name] = FRAMES // BATCH_WINDOW * len(calls[name])
        reset_counts(km)
        rep = reps[flavor] = serve_stream(sims["cuda"], frames,
                                          batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        launches[flavor] = dict(km.LAUNCHES)
        if launches[flavor] != want:
            fail(f"{flavor}: launches {launches[flavor]} in one serving run, "
                 f"want {want} ({len(calls[name])} calls per "
                 f"{BATCH_WINDOW}-frame batch)")
        if km.WEIGHT_COPIES != 0:
            fail(f"{flavor}: the serving run made {km.WEIGHT_COPIES} K-major "
                 "weight copies, want 0")
        walls = serving_walls(sims["cuda"], frames)
        wall[flavor] = float(np.median(walls))
        rep_cpu = serve_stream(sims["cpu"], frames, batch_window=BATCH_WINDOW)
        lg = rep.logits
        if tuple(lg.shape) != (FRAMES, 10) or not torch.isfinite(lg).all():
            fail(f"{flavor}: logits {tuple(lg.shape)} not finite / wrong shape")
        if not same(lg.cpu(), rep_cpu.logits):
            diff = (lg.cpu() - rep_cpu.logits).abs().max().item()
            fail(f"{flavor}: card logits differ from the CPU run ({diff})")
        if rep.measured_ii != rep.analytic_ii or \
                rep_cpu.measured_ii != rep.measured_ii:
            fail(f"{flavor}: measured II {rep.measured_ii} vs analytic "
                 f"{rep.analytic_ii} (cpu {rep_cpu.measured_ii})")
        res = {dev: sims[dev].run_stream(frames, arrivals=rep.arrivals,
                                         chunk=BATCH_WINDOW)
               for dev in sims}
        if not counters_equal(res["cuda"], res["cpu"]):
            fail(f"{flavor}: counters / traffic / timeline differ from CPU")
        if not same(res["cuda"].logits.cpu(), lg.cpu()):
            fail(f"{flavor}: run_stream logits differ from serve_stream")
        log(f"[e2e] {flavor}: logits == CPU run by value, measured II "
            f"{rep.measured_ii} == analytic II {rep.analytic_ii}, counters "
            f"and timeline equal; launches {launches[flavor]}; wall "
            f"ms/frame over {WALL_REPS} runs of {FRAMES} frames "
            f"(batch_window={BATCH_WINDOW}): median {wall[flavor] * 1e3:.4f}, "
            f"all {[round(v * 1e3, 4) for v in walls]}")
    if launches["nominal"]["cim_codes"] == 0:
        fail("the nominal serving run never launched cim_codes")
    if launches["variation"]["cim_codes_var"] == 0:
        fail("the variation serving run never launched cim_codes_var")
    return sims["cuda"], frames, launches, wall, calls, reps


#: the CIM kernel's device-side name (both variants are instantiations)
CIM_KERNEL_NAME = "cim_codes_kernel"


def profile_device(run, what: str, keys=(CIM_KERNEL_NAME,), host=True):
    """Device busy share of ``run()`` and the kernels that take the
    device time (``torch.profiler``).  Returns (the share, {key: (device
    launches, device us) of the kernels whose name holds key}; the CIM
    kernel's by default, graph replays included), or (None, None) when
    the profiler saw no device time.  ``host=False`` records the device
    activity alone (a run of tens of thousands of host ops otherwise
    takes longer to parse than to run)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host else [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the host ops that
        # launched them carry the same time again
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {what}: the profiler saw no device time: not "
            "measured")
        return None, None
    log(f"[profile] {what}: wall {wall_us:.1f} us under the profiler, "
        f"device busy {busy:.1f} us ({100 * busy / wall_us:.2f}%)")
    for dev_us, count, name in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {dev_us:10.1f} us  x{count:<4d} {name[:90]}")
    found = {key: (sum(c for _, c, name in rows if key in name),
                   sum(us for us, _, name in rows if key in name))
             for key in keys}
    for key, (count, dev_us) in found.items():
        log(f"[profile]   {key}: {count} launches, {dev_us:.1f} us")
    return busy / wall_us, found


def device_share(sim, frames):
    """Device busy share of one nominal serving run of all frames."""
    from repro_torch.runtime.serve_loop import serve_stream

    return profile_device(
        lambda: serve_stream(sim, frames, batch_window=BATCH_WINDOW),
        f"one serving run of {len(frames)} frames")[0]


def record_calls(km, sim, frames):
    """The kernel calls of one main-path batch with the sim's current
    flavor (recorded outside the counted runs)."""
    from repro_torch.runtime.serve_loop import serve_stream

    calls = []
    real = km.cim_codes

    def recorder(x, w, spec, adc=None, emit_codes=True):
        calls.append((x, w, spec, adc))
        return real(x, w, spec, adc=adc, emit_codes=emit_codes)

    km.cim_codes = recorder
    try:
        serve_stream(sim, frames[:BATCH_WINDOW], batch_window=BATCH_WINDOW)
    finally:
        km.cim_codes = real
    torch.cuda.synchronize()
    return calls


def geometry(x, w, n_c):
    """(T, R, kc, N) of a call in either layout."""
    if x.dim() == 3:
        return tuple(x.shape) + (w.shape[2],)
    return (-(-x.shape[1] // n_c), x.shape[0], n_c, w.shape[1])


def edge_cases(n_c, dev, seed):
    """Phase 3's edge grid at one n_c: (label, x, weights, T), where
    ``weights`` are equal by value in the layouts the kernel meets.

    3-D: R in EDGE_R, N in EDGE_N, kc in {9, 29, n_c}, T in EDGE_T (no
    cluster or split size divides every T), the weight K-major (the
    engine's layout: a view of a (T, N, kc) tensor) and N-major (copied
    K-major by the wrapper).  2-D (FC tiles): K = (T - 1) n_c + kc (a
    ragged last step), T in EDGE_T_FC; x a column slice of a wider
    tensor at a 16-byte aligned offset and at an odd one, the weight a
    slice of a K-major (N, K) store and of an N-major (K, N) one."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    for r in EDGE_R:
        for n in EDGE_N:
            for kc in (9, 29, n_c):
                for t in EDGE_T:
                    x = i8(t, r, kc)
                    w_nk = i8(t, n, kc)
                    yield ((t, r, kc, n), x,
                           (w_nk.transpose(1, 2),
                            w_nk.transpose(1, 2).contiguous()), t)
                for t in EDGE_T_FC:
                    k = (t - 1) * n_c + kc
                    xs = i8(r, k + 35)
                    store = i8(n + 5, k + 21)  # K-major (N, K) store
                    w_k = store[3:3 + n, 5:5 + k].T
                    for off in (16, 3):
                        yield ((t, r, kc, n, f"fc x+{off}"),
                               xs[:, off:off + k],
                               (w_k, w_k.contiguous()), t)


def check_kernels(km, calls):
    """Phase 3: kernel == plain version by value on the card: at the
    main path's calls, on random inputs at those shapes and ragged ones
    for n_c in {32, 96, 256}, and over the edge grid (``edge_cases``),
    both variants and both output modes."""
    from repro_torch.core.cim import CIMSpec

    worst = {"cim_codes": 0.0, "cim_codes_var": 0.0}
    n_checks = 0

    def check(name, x, ws, spec, adc, emit, what=""):
        """Each weight layout in ``ws`` through the kernel against the
        plain version of the first."""
        nonlocal n_checks
        b = km.cim_codes_plain(x, ws[0], spec, adc=adc, emit_codes=emit)
        for w in ws:
            a = km.cim_codes(x, w, spec, adc=adc, emit_codes=emit)
            torch.cuda.synchronize()
            err = (a - b).abs().max().item() if a.numel() else 0.0
            worst[name] = max(worst[name], err)
            n_checks += 1
            if not same(a, b):
                fail(f"{name} != plain at {geometry(x, w, spec.n_c)} "
                     f"{what} n_c={spec.n_c} emit_codes={emit} w strides "
                     f"{w.stride()}: max |diff| {err}")

    for name, lst in calls.items():
        for x, w, spec, adc in lst:
            for emit in (True, False):
                check(name, x, (w,), spec, adc, emit, "main path")
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")

    def i8(*shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape).astype(np.int8)).to(dev)

    def table(t, spec):
        inv = np.float32(spec.adc_inv_step) * (
            1 + 0.02 * rng.standard_normal(t))
        off = 0.5 * rng.standard_normal(t)
        return torch.from_numpy(
            np.stack([inv, off], 1).astype(np.float32)).to(dev)

    shapes = sorted({geometry(x, w, spec.n_c) + (x.dim(),)
                     for lst in calls.values() for x, w, spec, _ in lst})
    for n_c in (32, 96, 256):
        spec = CIMSpec(n_c=n_c)
        cases = []
        for t, r, kc, n, dim in shapes:
            kc = min(kc, n_c)
            cases.append((i8(t, r, kc), i8(t, kc, n)) if dim == 3 else
                         (i8(r, t * kc), i8(t * kc, n)))
        # ragged rows, columns and depth (last step short in 2-D)
        cases.append((i8(5, 37, n_c - 3), i8(5, n_c - 3, 77)))
        cases.append((i8(13, 3 * n_c + 11), i8(3 * n_c + 11, 130)))
        for x, w in cases:
            t = geometry(x, w, n_c)[0]
            for emit in (True, False):
                check("cim_codes", x, (w,), spec, None, emit)
                check("cim_codes_var", x, (w,), spec, table(t, spec), emit)
    n_main = n_checks
    # below 8 bits: operands on the narrower grid, codes of a narrower
    # ADC (the kernel reads q_max, the steps and the table at run time)
    for w_bits, a_bits, adc_bits in LOW_PRECISION:
        spec = CIMSpec(n_c=256, w_bits=w_bits, a_bits=a_bits,
                       adc_bits=adc_bits)

        def low(*shape):
            return torch.from_numpy(rng.integers(
                -spec.w_max - 1, spec.w_max + 1, shape).astype(np.int8)).to(dev)

        cases = [(low(t, r, kc), low(t, n, kc).transpose(1, 2)) if dim == 3
                 else (low(r, t * kc), low(n, t * kc).T)
                 for t, r, kc, n, dim in shapes]
        cases.append((low(7, 37, 29), low(7, 77, 29).transpose(1, 2)))
        cases.append((low(13, 3 * 256 + 11), low(130, 3 * 256 + 11).T))
        for x, w in cases:
            t = geometry(x, w, 256)[0]
            for emit in (True, False):
                what = f"w{w_bits}a{a_bits} adc{adc_bits}"
                check("cim_codes", x, (w,), spec, None, emit, what)
                check("cim_codes_var", x, (w,), spec, table(t, spec), emit,
                      what)
    n_low = n_checks - n_main
    n_main = n_checks
    t0 = time.perf_counter()
    spec = CIMSpec(n_c=EDGE_NC)
    copies = km.WEIGHT_COPIES
    n_cases = 0
    for what, x, ws, t in edge_cases(EDGE_NC, dev, SEED + 3):
        n_cases += 1
        for emit in (True, False):
            check("cim_codes", x, ws, spec, None, emit, what)
            check("cim_codes_var", x, ws, spec, table(t, spec), emit, what)
    # one copy for each N-major weight: 2 variants x 2 output modes
    if km.WEIGHT_COPIES - copies != 4 * n_cases:
        fail(f"{km.WEIGHT_COPIES - copies} weight copies over the edge "
             f"grid, want {4 * n_cases}")
    log(f"[kernels] {n_checks} comparisons equal by value ({n_main} at the "
        f"main path's calls and n_c in {{32, 96, 256}}, {n_low} of them "
        f"below 8 bits (w, a, adc bits {LOW_PRECISION}); "
        f"{n_checks - n_main} over the edge grid of {n_cases} shapes at "
        f"n_c={EDGE_NC}: R {EDGE_R}, N {EDGE_N}, kc {{9, 29, {EDGE_NC}}}, "
        f"T {EDGE_T} (FC layout T {EDGE_T_FC}), K- and N-major weights, "
        f"{time.perf_counter() - t0:.1f} s); max |diff| {worst}")
    return worst


def calls_bound(calls):
    """(bound ms, what bounds it) of a list of recorded calls: the larger
    of their int8 operations at PEAK_INT8_OPS and their bytes at
    PEAK_BYTES."""
    ops = sum(work(x, w, adc)[0] for x, w, _, adc in calls)
    nbytes = sum(work(x, w, adc)[1] for x, w, _, adc in calls)
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_kernels(km, calls, card, reps: int = 50):
    """Phase 4: each main-path call's device time under
    ``torch.profiler`` (and the CUDA-event time of back-to-back calls,
    which includes the wrapper's host time), per call and per batch,
    beside the plain version's device time, the bound and the share of
    it."""
    def kernel(x, w, spec, adc):
        km.cim_codes(x, w, spec, adc=adc)

    def plain(x, w, spec, adc):
        km.cim_codes_plain(x, w, spec, adc=adc)

    rows = {}
    for name, lst in calls.items():
        for i, (x, w, spec, adc) in enumerate(lst):
            args = [(x, w, spec, adc)]
            ms = device_ms(kernel, args, reps)
            b_ms, _ = calls_bound(args)
            t, r, _, n = geometry(x, w, spec.n_c)
            plan = km.launch_plan(t, r, n)
            blocks = -(-n // km.COLS) * -(-r // plan.rows) * plan.slices
            log(f"[time] {name} call {i + 1} (T, R, kc, N)="
                f"{geometry(x, w, spec.n_c)}, {blocks} blocks "
                f"({plan.rows} rows x 64 columns, {plan.slices} slices): "
                f"device {ms * 1e3:.3f} us, host-inclusive "
                f"{event_ms(kernel, args, reps) * 1e3:.3f} us, plain "
                f"{device_ms(plain, args, 10) * 1e3:.3f} us, bound "
                f"{b_ms * 1e3:.4f} us ({100 * b_ms / ms:.2f}% of it) on "
                f"{card}")
        b_ms, by = calls_bound(lst)
        rows[name] = dict(
            ms=device_ms(kernel, lst, reps),
            host_inclusive_ms=event_ms(kernel, lst, reps),
            plain_ms=device_ms(plain, lst, 10), bound_ms=b_ms, bound_by=by,
            calls=len(lst))
        rows[name]["share_of_bound"] = b_ms / rows[name]["ms"]
        log(f"[time] {name}: {len(lst)} calls per {BATCH_WINDOW}-frame "
            f"batch: {rows[name]} on {card}")
    return rows


def host_split(sim, frames):
    """(numerics s, accounting s) of one ``run_stream`` of ``frames``
    (host clock): the batched numerics pass, ending in a synchronize,
    and the per-frame analytic accounting pass."""
    from repro_torch.core.simulator import SimCounters
    from repro_torch.core.transport import TrafficCounters

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim._stream_numerics(sim._input(frames), BATCH_WINDOW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(len(frames)):
        sim._account_frame(SimCounters(), TrafficCounters())
    return t1 - t0, time.perf_counter() - t1


def hold_calls(km, calls, what: str) -> float:
    """Each recorded call through the kernel and through its plain
    version on the card, both output modes: equal by value.  Returns
    the largest |diff| (0.0 when all are equal)."""
    worst = 0.0
    for i, (x, w, spec, adc) in enumerate(calls):
        for emit in (True, False):
            a = km.cim_codes(x, w, spec, adc=adc, emit_codes=emit)
            b = km.cim_codes_plain(x, w, spec, adc=adc, emit_codes=emit)
            torch.cuda.synchronize()
            err = (a - b).abs().max().item() if a.numel() else 0.0
            worst = max(worst, err)
            if not same(a, b):
                fail(f"{what}: call {i + 1} {geometry(x, w, spec.n_c)} != "
                     f"plain (emit_codes={emit}): max |diff| {err}")
    return worst


def model_phase(km, name: str, card):
    """Phase M for one model: serve it at full width on the card (8
    frames, ``batch_window=4``), nominal and, for MODEL_VARIATION, with
    every variation source.  Gates: the calls of one batch (conv chunks,
    one per FC layer), the counted run's launches and weight copies,
    finite logits of the right shape, measured II == analytic II == the
    reference bench's, one batch equal to the CPU run (logits by value,
    counters, traffic, timeline), every recorded call equal to the plain
    version.  Returns the counted runs' launches by flavor, and the
    largest |diff| against the plain version by variant."""
    import gc

    from repro_torch.convert import copy_calibration, params_from_reference
    from repro_torch.core.engine import CIMEngine
    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.runtime.serve_loop import (
        build_stream_sim,
        quantize_cnn_params_for_serving,
        serve_stream,
    )

    t_phase = time.perf_counter()
    dup_cap, want_ii = MODELS[name]
    cnn, params, frames = cnn_inputs(name)
    t0 = time.perf_counter()
    qparams = quantize_cnn_params_for_serving(params_from_reference(params,
                                                                    "cuda"))
    sim = build_stream_sim(cnn, qparams, device="cuda", dup_cap=dup_cap)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = build_stream_sim(
        cnn, quantize_cnn_params_for_serving(params_from_reference(params,
                                                                   "cpu")),
        device="cpu", dup_cap=dup_cap,
        engine=copy_calibration(sim.pe_engine, CIMEngine(device="cpu")))
    cpu_build_s = time.perf_counter() - t0
    del params
    # warm the card (first launches, allocator) outside the counted runs
    serve_stream(sim, frames[:BATCH_WINDOW], batch_window=BATCH_WINDOW)
    torch.cuda.synchronize()
    classes = cnn.layers[-1].c_out
    flavors = [("nominal", None)]
    if name == MODEL_VARIATION:
        flavors.append(("variation", VARIATION_PRESETS["all"]))
    launches, worst, jit_row = {}, {}, None
    for flavor, var in flavors:
        what = f"{name} {flavor}"
        if var is not None:
            for each in (sim, cpu):
                each.set_variation(var)
        check_handles(sim, cpu, what)
        kname = "cim_codes" if var is None else "cim_codes_var"
        calls = record_calls(km, sim, frames)
        conv, fc = check_calls(sim, calls, what)
        want = {k: 0 for k in km.LAUNCHES}
        want[kname] = FRAMES // BATCH_WINDOW * len(calls)
        reset_counts(km)
        rep = serve_stream(sim, frames, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        launches[flavor] = dict(km.LAUNCHES)
        if launches[flavor] != want or km.WEIGHT_COPIES:
            fail(f"{what}: launches {launches[flavor]} with "
                 f"{km.WEIGHT_COPIES} weight copies in one serving run, "
                 f"want {want} and none")
        lg = rep.logits
        if tuple(lg.shape) != (FRAMES, classes) or \
                not torch.isfinite(lg).all():
            fail(f"{what}: logits {tuple(lg.shape)} not finite / wrong shape")
        if not rep.measured_ii == rep.analytic_ii == want_ii:
            fail(f"{what}: measured II {rep.measured_ii}, analytic "
                 f"{rep.analytic_ii}, the reference's {want_ii}")
        walls = serving_walls(sim, frames, MODEL_WALL_REPS)
        share = split = None
        if var is None:
            share = device_share(sim, frames)
            split = host_split(sim, frames)
        # one batch on the CPU (plain kernel versions), the same arrivals
        t0 = time.perf_counter()
        res = {dev: each.run_stream(frames[:BATCH_WINDOW],
                                    arrivals=rep.arrivals[:BATCH_WINDOW],
                                    chunk=BATCH_WINDOW)
               for dev, each in (("cuda", sim), ("cpu", cpu))}
        cpu_s = time.perf_counter() - t0
        if not (same(res["cuda"].logits.cpu(), res["cpu"].logits)
                and same(lg[:BATCH_WINDOW].cpu(), res["cpu"].logits)):
            diff = (lg[:BATCH_WINDOW].cpu() - res["cpu"].logits).abs().max()
            fail(f"{what}: card logits differ from the CPU run ({diff})")
        if not counters_equal(res["cuda"], res["cpu"]) or \
                res["cuda"].measured_ii != res["cpu"].measured_ii:
            fail(f"{what}: counters / traffic / timeline differ from CPU")
        worst[kname] = hold_calls(km, calls, what)

        def kernel(x, w, spec, adc):
            km.cim_codes(x, w, spec, adc=adc)

        ms = device_ms(kernel, calls, MODEL_TIME_REPS)
        b_ms, by = calls_bound(calls)
        fc_rows, fc_ms = [], []
        for x, w, spec, adc in calls[conv:]:
            f_ms = device_ms(kernel, [(x, w, spec, adc)], 20)
            fc_ms.append(f_ms)
            f_b, f_by = calls_bound([(x, w, spec, adc)])
            fc_rows.append(f"{geometry(x, w, spec.n_c)} {f_ms * 1e3:.3f} us "
                           f"(bound {f_b * 1e3:.4f} us, {f_by})")
        log(f"[models] {what}: {sim.plan.total_tiles} placed tiles, built "
            f"in {build_s:.1f} s on the card ({cpu_build_s:.1f} s on the "
            f"CPU); {len(calls)} calls per {BATCH_WINDOW}-frame batch ({conv} "
            f"conv, {fc} FC), launches {launches[flavor]}, WEIGHT_COPIES 0; "
            f"logits {tuple(lg.shape)} finite, == the CPU run by value over "
            f"{BATCH_WINDOW} frames ({cpu_s:.1f} s), counters, traffic and "
            f"timeline equal; measured II {rep.measured_ii} == analytic II "
            f"{rep.analytic_ii}; {2 * len(calls)} calls == plain by value")
        log(f"[models] {what}: wall ms/frame over {MODEL_WALL_REPS} runs of "
            f"{FRAMES} frames: median {np.median(walls) * 1e3:.4f}, all "
            f"{[round(v * 1e3, 4) for v in walls]}; device busy "
            + ("not profiled" if share is None else f"{100 * share:.2f}%")
            + ("" if split is None else
               f"; of a run, the numerics pass {split[0] * 1e3:.1f} ms and "
               f"the accounting pass {split[1] * 1e3:.1f} ms")
            + f"; {kname} device time per batch {ms:.4f} ms against a bound "
            f"of {b_ms:.5f} ms ({by}, {100 * b_ms / ms:.2f}% of it); FC "
            f"calls: {'; '.join(fc_rows)} on {card}")
        if name == MODEL_VARIATION and var is None:
            # the first FC layer as the grid's per-tile calls (how FC
            # layers ran before they took one call each), for comparison
            x, w, spec, _ = calls[conv]
            tiles = [(x[:, k0:k0 + sim.n_c], w[k0:k0 + sim.n_c,
                                               n0:n0 + sim.n_m], spec, None)
                     for n0 in range(0, w.shape[1], sim.n_m)
                     for k0 in range(0, w.shape[0], sim.n_c)]
            t0 = time.perf_counter()
            for args in tiles:
                kernel(*args)
            torch.cuda.synchronize()
            tiles_s = time.perf_counter() - t0
            log(f"[models] {name} {geometry(x, w, spec.n_c)} as {len(tiles)} "
                f"per-tile calls: device {device_ms(kernel, tiles, 1):.4f} "
                f"ms, host clock {tiles_s * 1e3:.1f} ms; as one call: device "
                f"{fc_ms[0]:.4f} ms on {card}")
        if var is None:
            # phase J on this model's simulator, params and frames
            jit_row = jit_model(km, name, sim, qparams, frames, rep, card,
                                dup_cap)
            if name in PERCELL_MODELS:
                percell(sim, frames, rep.arrivals, name, card)
        del calls, res, rep, lg
    del sim, cpu, qparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[models] {name}: phase {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return launches, worst, jit_row


def reset_graph_counts():
    from repro_torch.core import trace

    for d in (trace.GRAPHS, trace.REPLAYED):
        for k in d:
            d[k] = 0


def conv_calls(sim) -> int:
    """Kernel calls of one ``BATCH_WINDOW`` batch through the conv blocks
    (one per fire chunk of every executor)."""
    return sum(len(ex._quant_chunks(ex.plan.fires, BATCH_WINDOW))
               for ex in sim._executors.values())


def check_jit_counts(km, jit, kname, first: bool, what: str):
    """The counts of one jit serving run of FRAMES frames: the first
    batch of a run on new graphs captures every executor once, every
    batch replays every executor once; the replays run the captured
    conv launches (``REPLAYED``), the wrapper launches the FC layers per
    batch and, in a capturing run, the warm-up's conv calls once; the
    other variant never; no weight copy."""
    from repro_torch.configs.cnn import FCLayer
    from repro_torch.core import trace

    batches = FRAMES // BATCH_WINDOW
    n_ex, conv = len(jit._executors), conv_calls(jit)
    fc = sum(isinstance(l, FCLayer) for l in jit.cnn.layers)
    want_graphs = {"captures": n_ex if first else 0,
                   "replays": batches * n_ex}
    want_launch = {k: 0 for k in km.LAUNCHES}
    want_launch[kname] = batches * fc + (conv if first else 0)
    want_replay = {k: 0 for k in trace.REPLAYED}
    want_replay[kname] = batches * conv
    got = (dict(trace.GRAPHS), dict(km.LAUNCHES), dict(trace.REPLAYED))
    if got != (want_graphs, want_launch, want_replay) or km.WEIGHT_COPIES:
        fail(f"{what}: graphs / wrapper launches / replayed launches {got} "
             f"with {km.WEIGHT_COPIES} weight copies, want "
             f"{(want_graphs, want_launch, want_replay)} and none")
    per_replay = [sum(g.launches.values()) for ex in jit._executors.values()
                  for g in ex._graphs.values()]
    if sum(per_replay) != conv:
        fail(f"{what}: the graphs hold {sum(per_replay)} launches, want "
             f"{conv} (one per fire chunk)")
    return n_ex, conv, fc, per_replay


def capture_seconds(prof) -> float:
    """Host seconds of the ``graph_capture`` spans a Profiler recorded."""
    open_at, total = {}, 0.0
    for ev in prof.events:
        if not ev["name"].startswith("graph_capture:"):
            continue
        if ev["ph"] == "B":
            open_at[ev["name"]] = ev["ts"]
        elif ev["ph"] == "E":
            total += ev["ts"] - open_at.pop(ev["name"])
    return total / 1e6


def jit_model(km, name, sim, qparams, frames, rep, card, dup_cap=64,
              variation_logits=None):
    """Phase J for one model: the same quantized params served with
    ``trace_jit=True`` (``build_stream_sim``, the calibrated engine of
    ``sim``, FRAMES frames, ``batch_window``), against ``rep``, the
    non-jit counted run of phase 2 / M.  Gates: logits equal by value,
    II, counters, traffic and timeline identical; the first run captures
    and replays, a second only replays, counted (``check_jit_counts``)
    and the CIM kernel launches confirmed under ``torch.profiler``; no
    weight copy.  Logs wall ms/frame of jit and non-jit serving in turns,
    the numerics pass's host clock of each, the device busy share, the
    launches per replay and the capture's seconds.  With
    ``variation_logits``, also serves with VARIATION_PRESETS["all"]
    (equal to those logits) and again after ``set_variation(None)``
    (equal to the nominal run)."""
    import gc

    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.runtime.serve_loop import build_stream_sim, serve_stream
    from repro_torch.telemetry.spans import Profiler

    t0 = time.perf_counter()
    jit = build_stream_sim(sim.cnn, qparams, engine=sim.pe_engine,
                           device="cuda", dup_cap=dup_cap, trace_jit=True)
    build_s = time.perf_counter() - t0
    what = f"{name} trace_jit"
    reset_counts(km)
    reset_graph_counts()
    t0 = time.perf_counter()
    with Profiler() as prof:
        first = serve_stream(jit, frames, batch_window=BATCH_WINDOW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n_ex, conv, fc, per_replay = check_jit_counts(km, jit, "cim_codes",
                                                  True, f"{what} (first)")
    cap_s = capture_seconds(prof)
    if not same(first.logits.cpu(), rep.logits.cpu()):
        diff = (first.logits.cpu() - rep.logits.cpu()).abs().max().item()
        fail(f"{what}: logits differ from the non-jit run ({diff})")
    if not first.measured_ii == first.analytic_ii == rep.measured_ii:
        fail(f"{what}: measured II {first.measured_ii}, analytic "
             f"{first.analytic_ii}, non-jit {rep.measured_ii}")
    res = {each: s.run_stream(frames, arrivals=rep.arrivals,
                              chunk=BATCH_WINDOW)
           for each, s in (("jit", jit), ("plain", sim))}
    if not counters_equal(res["jit"], res["plain"]) or not same(
            res["jit"].logits.cpu(), rep.logits.cpu()):
        fail(f"{what}: run_stream counters / traffic / timeline / logits "
             "differ from the non-jit run")
    # a run on captured graphs, counted and profiled: every conv launch
    # a replayed one, each seen by the profiler.  A session that records
    # no device activity, or misses a replay's records (seen once on the
    # card: one vgg16 graph's 6 gathers and 6 CIM launches absent from
    # the records of a run whose replays were all issued), is run again,
    # as in ``device_ms``; each run's counts and logits are checked
    want_seen = FRAMES // BATCH_WINDOW * (conv + fc)
    seen = None
    for attempt in range(3):
        reset_counts(km)
        reset_graph_counts()
        out = {}
        share, found = profile_device(
            lambda: out.setdefault("rep", serve_stream(
                jit, frames, batch_window=BATCH_WINDOW)),
            f"{what}: one serving run of {FRAMES} frames on captured graphs")
        check_jit_counts(km, jit, "cim_codes", False, f"{what} (replay)")
        if not same(out["rep"].logits.cpu(), rep.logits.cpu()):
            fail(f"{what}: the profiled replayed run's logits differ from "
                 "the non-jit run")
        seen = None if found is None else found[CIM_KERNEL_NAME][0]
        if seen == want_seen:
            break
        log(f"[profile] {what}: session {attempt + 1} saw {seen} CIM "
            f"kernel launches of {want_seen}")
    if seen != want_seen:
        fail(f"{what}: the profiler saw {seen} CIM kernel launches in a "
             f"replayed run, want {want_seen} (replayed conv + FC)")
    walls = {"plain": [], "jit": []}
    for turn in ("plain", "jit", "jit", "plain"):
        walls[turn] += serving_walls(jit if turn == "jit" else sim, frames,
                                     MODEL_WALL_REPS)
    split = {turn: host_split(s, frames) for turn, s in
             (("plain", sim), ("jit", jit), ("jit2", jit), ("plain2", sim))}
    log(f"[jit] {what}: built in {build_s:.1f} s; first serving run "
        f"{first_s:.2f} s, of which capture {cap_s:.2f} s ({n_ex} graphs, "
        f"warm-up included); logits == non-jit by value, measured II "
        f"{first.measured_ii} == analytic II, counters, traffic and timeline "
        f"equal; {n_ex} replays and {conv} replayed launches per "
        f"{BATCH_WINDOW}-frame batch (per graph {per_replay}), {fc} FC "
        f"launches; profiler saw {seen} CIM launches in a replayed run; "
        f"WEIGHT_COPIES 0; device busy "
        + ("not measured" if share is None else f"{100 * share:.2f}%")
        + f" on {card}")
    log(f"[jit] {what}: wall ms/frame in turns (plain, jit, jit, plain; "
        f"{MODEL_WALL_REPS} runs of {FRAMES} frames each): jit median "
        f"{np.median(walls['jit']) * 1e3:.4f} all "
        f"{[round(v * 1e3, 4) for v in walls['jit']]}; non-jit median "
        f"{np.median(walls['plain']) * 1e3:.4f} all "
        f"{[round(v * 1e3, 4) for v in walls['plain']]}; numerics pass "
        f"host ms jit {split['jit'][0] * 1e3:.1f} / "
        f"{split['jit2'][0] * 1e3:.1f}, non-jit "
        f"{split['plain'][0] * 1e3:.1f} / {split['plain2'][0] * 1e3:.1f}; "
        f"accounting pass {split['jit'][1] * 1e3:.1f} ms on {card}")
    if variation_logits is not None:
        jit.set_variation(VARIATION_PRESETS["all"])
        reset_counts(km)
        reset_graph_counts()
        var = serve_stream(jit, frames, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        check_jit_counts(km, jit, "cim_codes_var", True,
                         f"{what} variation")
        if not same(var.logits.cpu(), variation_logits.cpu()):
            fail(f"{what}: variation logits differ from the non-jit run")
        jit.set_variation(None)
        again = serve_stream(jit, frames, batch_window=BATCH_WINDOW)
        if not same(again.logits.cpu(), rep.logits.cpu()):
            fail(f"{what}: after set_variation(None) the logits differ from "
                 "the nominal run")
        log(f"[jit] {what}: VARIATION_PRESETS['all'] == non-jit variation "
            f"run by value ({n_ex} graphs captured again, cim_codes_var "
            f"replayed); set_variation(None) == nominal by value")
    del jit, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_jit": float(np.median(walls["jit"])),
            "wall_plain": float(np.median(walls["plain"])),
            "numerics_jit": split["jit"][0],
            "numerics_plain": split["plain"][0], "capture_s": cap_s,
            "graphs": n_ex, "replayed_per_batch": conv, "busy": share}


def percell(sim, frames, arrivals, name, card):
    """Phase J: the per-cell stream oracle (``run_stream(batched=False)``,
    one stage of one frame a call) against the batched stream on the
    card: logits by value, per-frame counters and traffic, start /
    finish, residual FIFO depth, measured II, batch sizes."""
    t0 = time.perf_counter()
    cell = sim.run_stream(frames, arrivals=arrivals, batched=False)
    torch.cuda.synchronize()
    cell_s = time.perf_counter() - t0
    batched = sim.run_stream(frames, arrivals=arrivals, chunk=BATCH_WINDOW)
    if not (same(cell.logits.cpu(), batched.logits.cpu())
            and counters_equal(cell, batched)
            and all(dict(a.hops) == dict(b.hops) for a, b in
                    zip(cell.frame_traffic, batched.frame_traffic))
            and cell.residual_fifo_depth == batched.residual_fifo_depth
            and cell.measured_ii == batched.measured_ii
            and cell.batch_sizes == (1,) * len(frames)):
        fail(f"{name}: the per-cell oracle differs from the batched stream")
    log(f"[percell] {name}: run_stream(batched=False) over {len(frames)} "
        f"frames ({len(frames) * len(sim._stages)} cells, {cell_s:.2f} s) == "
        f"batched by value (logits, per-frame counters and traffic, "
        f"start/finish, FIFO depth {cell.residual_fifo_depth}, measured II "
        f"{cell.measured_ii}) on {card}")


def exact_jit(card):
    """Phase J: the exact engine's trace_jit (float32 flavor, TF32 off) on
    vgg11 at full width and JIT_EXACT_BATCH frames against the float64
    run of the same frames on the card: within TOL_JIT_EXACT; counters
    and traffic identical."""
    from repro_torch.convert import params_from_reference
    from repro_torch.core.network import NetworkSimulator

    cnn, params, _ = cnn_inputs()
    x = np.random.default_rng(SEED + 2).random(
        (JIT_EXACT_BATCH, cnn.input_hw, cnn.input_hw, 3))
    p = params_from_reference(params, "cuda")
    out, secs = {}, {}
    for flavor, jit in (("float64", False), ("float32", True)):
        sim = NetworkSimulator(cnn, p, trace_jit=jit, device="cuda")
        sim.run(x[:2])  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[flavor] = sim.run(x)
        torch.cuda.synchronize()
        secs[flavor] = time.perf_counter() - t0
    if torch.backends.cuda.matmul.allow_tf32:
        fail("exact trace_jit ran with TF32 on")
    a, b = out["float64"].logits, out["float32"].logits
    err = (a - b).abs().max().item()
    if not torch.allclose(b, a, rtol=TOL_JIT_EXACT, atol=TOL_JIT_EXACT) or \
            dataclasses.asdict(out["float64"].counters) != \
            dataclasses.asdict(out["float32"].counters) or \
            dict(out["float64"].traffic.byte_hops) != \
            dict(out["float32"].traffic.byte_hops):
        fail(f"exact trace_jit: max |diff| {err} against the float64 run "
             f"(tolerance {TOL_JIT_EXACT}), or counters / traffic differ")
    log(f"[jit] vgg11-cifar10 exact trace_jit at batch {JIT_EXACT_BATCH}: "
        f"max |diff| {err:.3e} against float64 (<= {TOL_JIT_EXACT}), counters "
        f"and traffic equal; run {secs['float32'] * 1e3:.1f} ms (float64 "
        f"{secs['float64'] * 1e3:.1f} ms) on {card}")


def cim_mode(km, name, card):
    """Phase J: ``cnn_forward(cim=DEFAULT_SPEC)`` at full width through the
    kernel's 2-D layout (one launch per conv and FC layer, no weight
    copy) against the port's CPU run of the same weights and frames:
    equal by value, finite, of the right shape."""
    from repro_torch.configs.cnn import ConvLayer
    from repro_torch.core.cim import DEFAULT_SPEC
    from repro_torch.models.cnn import cnn_forward

    n = CIM_MODE_FRAMES[name]
    cnn, params, frames = cnn_inputs(name)
    for l in cnn.layers:
        if isinstance(l, ConvLayer):
            rows = n * l.conv_out_h * l.conv_out_w
            if -(-rows // km.ROW_TILES[-1]) > km._GRID_Y:
                fail(f"{name}: {l.name}'s {rows} rows at {n} frames exceed "
                     "the kernel's grid")
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        p = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
             for k, v in params.items()}
        x = torch.from_numpy(frames[:n].astype(np.float32)).to(dev)
        if dev == "cuda":
            reset_counts(km)
        t0 = time.perf_counter()
        with torch.no_grad():
            out[dev] = cnn_forward(p, x, cnn, cim=DEFAULT_SPEC)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches, copies = dict(km.LAUNCHES), km.WEIGHT_COPIES
        secs[dev] = time.perf_counter() - t0
        del p, x
    want = {"cim_codes": len(cnn.layers), "cim_codes_var": 0}
    if launches != want or copies:
        fail(f"{name} CIM mode: launches {launches} with {copies} weight "
             f"copies, want {want} and none")
    lg = out["cuda"]
    if tuple(lg.shape) != (n, cnn.layers[-1].c_out) or \
            not torch.isfinite(lg).all():
        fail(f"{name} CIM mode: logits {tuple(lg.shape)} not finite / wrong "
             "shape")
    if not same(lg.cpu(), out["cpu"]):
        diff = (lg.cpu() - out["cpu"]).abs().max().item()
        fail(f"{name} CIM mode: card logits differ from the CPU run ({diff})")
    log(f"[cim-mode] {name}: cnn_forward(cim=DEFAULT_SPEC) on {n} frames == "
        f"the CPU run by value; {launches['cim_codes']} launches (one per "
        f"layer), WEIGHT_COPIES 0; {secs['cuda']:.2f} s on the card, "
        f"{secs['cpu']:.2f} s on the CPU; {card}")
    torch.cuda.empty_cache()


def trial_probe(km):
    """A profiler for phase R that records, for each Monte-Carlo trial
    (``mc_trial`` span), the CIM kernel launches (counts read just
    before the trial and just after it), its seconds and those of its
    engine swap (``engine_swap``: the host draws and the upload)."""
    import contextlib

    from repro_torch.telemetry.spans import Profiler

    class TrialProbe(Profiler):
        def __init__(self):
            super().__init__()
            self.trials = []      # (launches, trial s, swap s)
            self.swap_s = 0.0

        @contextlib.contextmanager
        def span(self, name, cat="host", **args):
            before = dict(km.LAUNCHES)
            t0 = time.perf_counter()
            with super().span(name, cat, **args):
                yield
            dt = time.perf_counter() - t0
            if name == "engine_swap":
                self.swap_s = dt
            elif name.startswith("mc_trial"):
                self.trials.append((
                    {k: km.LAUNCHES[k] - before[k] for k in before}, dt,
                    self.swap_s))

    return TrialProbe()


def robustness_phase(km, calls_per_batch, card):
    """Phase R: vgg11 at full width, phase 2's params and frames, through
    ``sweep_presets`` over all four variation presets on the card.  Each
    trial launches only the preset's variant, as many times as a phase-2
    batch; no weight copy; one build of the CIM library; the "all"
    preset's first trials rerun on the CPU (calibration copied) give
    equal agreements and logits."""
    from repro_torch.convert import copy_calibration, params_from_reference
    from repro_torch.core.engine import CIMEngine
    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.runtime.robustness import (
        build_robust_sim,
        monte_carlo_sweep,
        sweep_presets,
    )

    t_phase = time.perf_counter()
    cnn, params, frames = cnn_inputs()
    t0 = time.perf_counter()
    sim = build_robust_sim(cnn, params_from_reference(params, "cuda"), frames,
                           device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    probe = trial_probe(km)
    reset_counts(km)
    t0 = time.perf_counter()
    with probe:
        reports = sweep_presets(cnn, params, frames, trials=ROBUST_TRIALS,
                                seed0=SEED, sim=sim)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    if km.WEIGHT_COPIES != 0:
        fail(f"robustness: {km.WEIGHT_COPIES} K-major weight copies over "
             "the sweep, want 0")
    if km._launcher.cache_info().misses != 1:
        fail(f"robustness: the CIM library was loaded "
             f"{km._launcher.cache_info().misses} times, want once")
    libs = sorted(km._build.BUILD_DIR.glob("libcim_matmul_*.so"))
    if len(libs) != 1:
        fail(f"robustness: CIM libraries built {[p.name for p in libs]}, "
             "want one")
    names = list(VARIATION_PRESETS)
    if len(probe.trials) != len(names) * ROBUST_TRIALS:
        fail(f"robustness: {len(probe.trials)} trials seen, want "
             f"{len(names) * ROBUST_TRIALS}")
    for i, (launched, trial_s, swap_s) in enumerate(probe.trials):
        preset = names[i // ROBUST_TRIALS]
        variant = ("cim_codes_var" if VARIATION_PRESETS[preset].has_adc
                   else "cim_codes")
        want = {k: 0 for k in km.LAUNCHES}
        want[variant] = calls_per_batch
        if launched != want:
            fail(f"robustness: {preset} trial {i % ROBUST_TRIALS} launched "
                 f"{launched}, want {want}")
    if reports[names[0]].zero_var_bitwise is not True:
        fail("robustness: the zero-magnitude variation run differs from "
             "the nominal run")
    for name, rep in reports.items():
        sel = probe.trials[names.index(name) * ROBUST_TRIALS:
                           (names.index(name) + 1) * ROBUST_TRIALS]
        log(f"[robust] {name}: {rep.row()}; per trial "
            f"{[round(a, 6) for a in rep.per_trial]}; seconds per trial "
            f"{[round(t, 4) for _, t, _ in sel]} (set_variation "
            f"{[round(w, 4) for _, _, w in sel]}, run "
            f"{[round(t - w, 4) for _, t, w in sel]}) on {card}")

    # the "all" preset's first trials on the CPU, calibration copied
    t0 = time.perf_counter()
    cpu = build_robust_sim(
        cnn, params_from_reference(params, "cpu"), frames, device="cpu",
        engine=copy_calibration(sim.pe_engine, CIMEngine(device="cpu")))
    var = VARIATION_PRESETS["all"]
    ref = reports["all"]
    n = ROBUST_CPU_TRIALS
    got = monte_carlo_sweep(cnn, params, frames, var, n, seed0=SEED, sim=cpu)
    if got.per_trial != ref.per_trial[:n]:
        fail(f"robustness: CPU per-trial agreement {got.per_trial} vs the "
             f"card's {ref.per_trial[:n]}")
    for t in range(n):
        for each in (sim, cpu):
            each.set_variation(var.reseed(SEED + t))
        a, b = sim.run(frames).logits.cpu(), cpu.run(frames).logits
        if not same(a, b):
            fail(f"robustness: trial {t} logits on the card differ from the "
                 f"CPU run by {(a - b).abs().max().item()}")
    for each in (sim, cpu):
        each.set_variation(None)
    trial_s = [t for _, t, _ in probe.trials]
    swap_s = [w for _, _, w in probe.trials]
    log(f"[robust] {len(trial_s)} trials of {FRAMES} frames: median "
        f"{np.median(trial_s):.4f} s a trial (set_variation "
        f"{np.median(swap_s):.4f} s, run "
        f"{np.median(np.subtract(trial_s, swap_s)):.4f} s); sweep "
        f"{sweep_s:.2f} s, simulator built in {build_s:.2f} s; the first {n} "
        f"'all' trials equal the CPU run (agreements and logits, "
        f"{time.perf_counter() - t0:.1f} s); WEIGHT_COPIES 0, one CIM "
        f"library; phase {time.perf_counter() - t_phase:.1f} s on {card}")


def dse_phase(km, card):
    """Phase D: the mapping DSE validated on the CIM engine on the card
    (vgg11 and resnet18), its winners and scores equal to a CPU run's;
    the robust DSE on vgg11 with accuracy points below 8 bits."""
    from repro_torch.dse.report import run_dse, run_robust_dse

    models = ["vgg11-cifar10", "resnet18-cifar10"]
    reset_counts(km)
    t0 = time.perf_counter()
    reps = run_dse(models, budget=DSE_BUDGET, engine="cim", device="cuda")
    torch.cuda.synchronize()
    dse_s = time.perf_counter() - t0
    launched = dict(km.LAUNCHES)
    if launched["cim_codes"] == 0 or km.WEIGHT_COPIES:
        fail(f"dse: validation launched {launched} with {km.WEIGHT_COPIES} "
             "weight copies; want cim_codes launches and no copy")
    cpu = run_dse(models, budget=DSE_BUDGET, engine="cim", validate="none",
                  device="cpu")
    for rep, rc in zip(reps, cpu):
        if rep.validated is not True:
            fail(f"dse: {rep.model}'s winner {rep.winner.config.describe()} "
                 "is not equal to the snake baseline on the card")
        row, row_cpu = dict(rep.row()), dict(rc.row())
        row.pop("validated_bitwise"), row_cpu.pop("validated_bitwise")
        if (row != row_cpu or rep.pareto_rows() != rc.pareto_rows()
                or [c.score.as_dict() for c in rep.result.candidates]
                != [c.score.as_dict() for c in rc.result.candidates]):
            fail(f"dse: {rep.model}: winner / scores differ from the CPU run")
        log(f"[dse] {rep.model}: winner {rep.winner.config.describe()}, "
            f"validated on the card (CIM engine), {rep.result.evaluations} "
            f"evaluations; row {rep.row()}")
    log(f"[dse] run_dse({models}, budget={DSE_BUDGET}, engine='cim') "
        f"{dse_s:.2f} s on the card, launches {launched}; winners, "
        f"candidates and scores equal to the CPU run's on {card}")

    reset_counts(km)
    t0 = time.perf_counter()
    robust = run_robust_dse(["vgg11-cifar10"], budget=DSE_BUDGET,
                            trials=DSE_TRIALS, batch=DSE_BATCH, device="cuda")
    torch.cuda.synchronize()
    robust_s = time.perf_counter() - t0
    rep = robust[0]
    low = [c for c in rep.front
           if c.config.precision or tuple(c.config.base_bits) != (8, 8, 8)]
    if rep.zero_var_bitwise is not True:
        fail("robust dse: the zero-variation run differs from nominal")
    if not rep.front or not low:
        fail(f"robust dse: front {[c.config.describe() for c in rep.front]} "
             "holds no point below 8 bits")
    if km.WEIGHT_COPIES:
        fail(f"robust dse: {km.WEIGHT_COPIES} weight copies, want 0")
    for r in rep.pareto_rows():
        log(f"[dse] robust front: {r}")
    log(f"[dse] run_robust_dse(vgg11, budget={DSE_BUDGET}, "
        f"trials={DSE_TRIALS}, batch={DSE_BATCH}) {robust_s:.2f} s on the "
        f"card: {rep.result.evaluations} evaluations, {len(rep.front)} on "
        f"the front ({len(low)} below 8 bits), zero_var_bitwise True, "
        f"launches {dict(km.LAUNCHES)} on {card}")


def c_slots(sim) -> int:
    """Kernel calls one interpreter run of ``sim`` makes on a quantized
    engine, from the schedules alone: the decoded tables' MAC-firing
    slots of every conv block and width strip, one per FC layer."""
    from repro_torch.configs.cnn import FCLayer
    from repro_torch.core.simulator import mac_slots

    scheds = [s for s in sim.schedules if s is not None]
    scheds += [st.sched for strips in sim._strips.values() for st in strips]
    return (sum(mac_slots(s) for s in scheds)
            + sum(isinstance(l, FCLayer) for l in sim.cnn.layers))


def c_same_run(a, b, links_a, links_b) -> bool:
    """Counters, per-class traffic and per-link traffic identical."""
    return (dataclasses.asdict(a.counters) == dataclasses.asdict(b.counters)
            and all(dict(getattr(a.traffic, f)) == dict(getattr(b.traffic, f))
                    for f in ("byte_hops", "packets", "hops"))
            and links_a == links_b)


def c_counted(km, sim, x, what: str):
    """One interpreter run of ``x`` on the card, counted: launches and
    weight copies reset just before and read just after, under
    ``set_sync_debug_mode("error")`` (a host sync raises), one call of
    each distinct (geometry, variant) recorded.  Returns (result, link
    traffic, launches, seconds, recorded calls)."""
    real = km.cim_codes
    seen = {}

    def recorder(x, w, spec, adc=None, emit_codes=True):
        key = (geometry(x, w, spec.n_c), adc is None)
        if key not in seen:
            seen[key] = (x, w, spec, adc)
        return real(x, w, spec, adc=adc, emit_codes=emit_codes)

    reset_counts(km)
    km.cim_codes = recorder
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        res = sim.run(x)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    except RuntimeError as e:
        fail(f"{what}: the interpreter's run failed under "
             f"set_sync_debug_mode('error'): {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
        km.cim_codes = real
    return (res, dict(sim.placement.noc.link_traffic), dict(km.LAUNCHES),
            run_s, list(seen.values()))


def interp_phase(km, card):
    """Phase C: the per-cycle interpreter on the card at vgg11's and
    resnet18's full width, held to the trace backend.  Returns the
    counted runs' launches and the largest |diff| of the recorded calls
    against the plain version, by variant."""
    from repro_torch.configs.cnn import ConvLayer
    from repro_torch.convert import params_from_reference
    from repro_torch.core.network import NetworkSimulator
    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.dse.placements import strategies
    from repro_torch.runtime.serve_loop import quantize_cnn_params_for_serving

    t_phase = time.perf_counter()
    launched = dict.fromkeys(km.LAUNCHES, 0)
    worst = dict.fromkeys(km.LAUNCHES, 0.0)
    for name in C_MODELS:
        cnn, params, frames = cnn_inputs(name)
        x = torch.from_numpy(frames[:C_FRAMES]).cuda()
        t0 = time.perf_counter()
        qp = quantize_cnn_params_for_serving(params_from_reference(params,
                                                                   "cuda"))
        trace = NetworkSimulator(cnn, qp, engine="cim", device="cuda")
        interp = NetworkSimulator(cnn, qp, backend="interp",
                                  engine=trace.pe_engine, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        slots = c_slots(interp)
        flavors = [("nominal", None)]
        if name == C_MODELS[0]:
            flavors.append(("variation", VARIATION_PRESETS["all"]))
        for flavor, var in flavors:
            what = f"[C] {name} {flavor}"
            if var is not None:
                for sim in (trace, interp):
                    sim.set_variation(var)
            kname = "cim_codes" if var is None else "cim_codes_var"
            t0 = time.perf_counter()
            want = trace.run(x)
            torch.cuda.synchronize()
            trace_s = time.perf_counter() - t0
            want_links = dict(trace.placement.noc.link_traffic)
            res, links, counts, run_s, calls = c_counted(km, interp, x, what)
            expect = dict.fromkeys(km.LAUNCHES, 0)
            expect[kname] = slots
            if counts != expect or km.WEIGHT_COPIES:
                fail(f"{what}: launches {counts} with {km.WEIGHT_COPIES} "
                     f"weight copies, want {expect} (the tables' MAC-firing "
                     "slots plus one a FC layer) and none")
            for k, v in counts.items():
                launched[k] += v
            lg = res.logits
            if tuple(lg.shape) != (C_FRAMES, cnn.layers[-1].c_out) or \
                    not torch.isfinite(lg).all():
                fail(f"{what}: logits {tuple(lg.shape)} not finite / wrong "
                     "shape")
            if not same(lg, want.logits):
                fail(f"{what}: interp logits differ from trace's by "
                     f"{(lg - want.logits).abs().max().item()}")
            if not c_same_run(res, want, links, want_links):
                fail(f"{what}: counters / traffic / link traffic differ "
                     "from trace's")
            worst[kname] = max(worst[kname], hold_calls(km, calls, what))
            share = None
            if var is None and name == C_MODELS[0]:
                t0 = time.perf_counter()
                share = profile_device(lambda: interp.run(x),
                                       f"{name} one interpreter run",
                                       host=False)[0]
                log(f"{what}: the profiled run took "
                    f"{time.perf_counter() - t0:.1f} s with the parse")
            log(f"{what}: {C_FRAMES} frames, logits == trace by value, "
                f"counters, traffic and link traffic identical, no host "
                f"sync in run; {counts[kname]} {kname} launches a batch "
                f"(== {slots} slots), WEIGHT_COPIES 0; {len(calls)} per-tile "
                f"shapes == plain; interp {run_s:.3f} s a run "
                f"({res.counters.cycles} cycles, "
                f"{run_s / res.counters.cycles * 1e3:.4f} host ms a cycle), "
                f"trace {trace_s:.4f} s; device busy "
                + ("not measured" if share is None else f"{100 * share:.2f}%")
                + f"; built in {build_s:.1f} s on {card}")
        del trace, interp, qp
    # vgg11 on the exact engine, integer weights and frames: every float64
    # sum exact, so interp and trace agree bit for bit
    name = C_MODELS[0]
    cnn = cnn_inputs(name)[0]
    rng = np.random.default_rng(SEED)
    params = {}
    for layer in cnn.layers:
        shape = ((layer.k, layer.k, layer.c, layer.m)
                 if isinstance(layer, ConvLayer) else
                 (layer.c_in, layer.c_out))
        params[layer.name] = torch.from_numpy(
            rng.integers(-1, 2, shape).astype(np.float64)).cuda()
    x = torch.from_numpy(rng.integers(0, 2, (C_FRAMES, cnn.input_hw,
                                             cnn.input_hw, 3))
                         .astype(np.float64)).cuda()
    trace = NetworkSimulator(cnn, params, device="cuda")
    interp = NetworkSimulator(cnn, params, backend="interp", device="cuda")
    want = trace.run(x)
    t0 = time.perf_counter()
    base = interp.run(x)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    if not torch.equal(base.logits, want.logits):
        fail(f"[C] {name} exact: interp logits differ from trace's by "
             f"{(base.logits - want.logits).abs().max().item()}")
    top = base.logits.abs().max().item()
    if top >= 2 ** 53:
        fail(f"[C] {name} exact: |logits| reach {top}, past float64's "
             "exact integers")
    log(f"[C] {name} exact engine, integer data: interp == trace bitwise "
        f"(max |logit| {top:.0f}); interp {exact_s:.3f} s a run on {card}")
    # the interpreter under every DSE placement: routed packets keep their
    # rendezvous slots, so logits equal the snake placement's
    hops = {}
    for pname, strat in strategies(cnn).items():
        sim = NetworkSimulator(cnn, params, backend="interp", device="cuda",
                               placement=strat.place(interp.plan))
        res = sim.run(x)
        if not torch.equal(res.logits, base.logits) or \
                res.counters.macs != base.counters.macs:
            fail(f"[C] {name} placement {pname}: logits or MACs differ "
                 "from the snake placement's")
        hops[pname] = (res.counters.group_hops,
                       res.traffic.byte_hops["group"])
    log(f"[C] {name} on the interpreter under {len(hops)} placements: "
        f"logits bitwise == snake's, MACs equal; GROUP (hops, byte-hops) "
        f"{hops} on {card}")
    phase_s = time.perf_counter() - t_phase
    log(f"[C] phase C: {phase_s:.1f} s (budget {C_BUDGET_S:.0f} s"
        + ("" if phase_s <= C_BUDGET_S else ", over it")
        + f"); launches {launched}; max |diff| to plain {worst} on {card}")
    return launched, worst


def telemetry_phase(km, calls_per_batch, wall_flat, card):
    """Phase T: vgg11 at full width served over 4 floret chiplets with a
    link recorder and a metrics registry attached: logits equal to the
    1-chiplet run's, measured II == analytic II, per-class conservation
    with the NoI level, the served-frame counter, a valid Chrome trace."""
    from repro_torch.convert import copy_calibration, params_from_reference
    from repro_torch.core.energy import routed_byte_hops_per_class
    from repro_torch.core.engine import CIMEngine
    from repro_torch.core.transport import NOI, TrafficCounters
    from repro_torch.runtime.serve_loop import (
        build_stream_sim,
        quantize_cnn_params_for_serving,
        serve_stream,
    )
    from repro_torch.telemetry import (
        LinkRecorder,
        MetricsRegistry,
        Profiler,
        check_conservation,
        chrome_trace,
        load_chrome_trace,
        stream_timeline_events,
        validate_chrome_trace,
        write_chrome_trace,
    )

    t_phase = time.perf_counter()
    cnn, params, frames = cnn_inputs()
    qp = quantize_cnn_params_for_serving(params_from_reference(params, "cuda"))
    flat = build_stream_sim(cnn, qp, device="cuda")
    rec, reg = None, MetricsRegistry()
    with Profiler() as prof:
        fab = build_stream_sim(
            cnn, qp, chiplets=CHIPLETS, noi=NOI_TOPOLOGY, device="cuda",
            engine=copy_calibration(flat.pe_engine, CIMEngine(device="cuda")))
        serve_stream(fab, frames[:BATCH_WINDOW], batch_window=BATCH_WINDOW)
        rec = LinkRecorder(fab.placement.noc)
        fab.recorder = rec
        reset_counts(km)
        t0 = time.perf_counter()
        rep = serve_stream(fab, frames, metrics=reg, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        recorded_s = time.perf_counter() - t0
        fab.recorder = None
    launched = dict(km.LAUNCHES)
    want = {k: 0 for k in km.LAUNCHES}
    want["cim_codes"] = FRAMES // BATCH_WINDOW * calls_per_batch
    if launched != want or km.WEIGHT_COPIES:
        fail(f"chiplets: launches {launched} ({km.WEIGHT_COPIES} weight "
             f"copies) in one serving run, want {want} and none")
    flat_rep = serve_stream(flat, frames, batch_window=BATCH_WINDOW)
    if not same(rep.logits, flat_rep.logits):
        fail("chiplets: logits over the fabric differ from the 1-chiplet run")
    if rep.measured_ii != rep.analytic_ii or \
            rep.analytic_ii != flat_rep.analytic_ii:
        fail(f"chiplets: measured II {rep.measured_ii}, analytic "
             f"{rep.analytic_ii} (flat {flat_rep.analytic_ii})")
    res = fab.run_stream(frames, arrivals=rep.arrivals, chunk=BATCH_WINDOW)
    analytic = routed_byte_hops_per_class(cnn, fab.plan, fab.placement)
    total = TrafficCounters()
    for ft in res.frame_traffic:
        if {k: v for k, v in ft.byte_hops.items() if v} != \
                {k: v for k, v in analytic.items() if v}:
            fail("chiplets: a frame's traffic differs from the analytic "
                 "routed byte-hops")
        for k in ft.byte_hops:
            total.byte_hops[k] += ft.byte_hops[k]
    problems = check_conservation(
        rec.heatmap(), total, {k: v * FRAMES for k, v in analytic.items()},
        flows=rec.flows.values())
    if problems or not analytic.get(NOI):
        fail(f"chiplets: conservation {problems}, NoI byte-hops "
             f"{analytic.get(NOI)}")
    served = reg.snapshot()["metrics"]["serve_frames_total"]["series"][0]
    if served["value"] != FRAMES or rep.completed != FRAMES:
        fail(f"chiplets: the registry counted {served['value']} frames, "
             f"served {rep.completed}")
    names = [cnn.layers[st.li].name for st in fab._stages]
    events = prof.events + stream_timeline_events(res, names)
    errors = validate_chrome_trace(chrome_trace(events))
    path = Path(__file__).resolve().parent / "build" / "chip_smoke"
    path.mkdir(parents=True, exist_ok=True)
    path = write_chrome_trace(str(path / "chiplet_serve_trace.json"), events)
    errors += validate_chrome_trace(load_chrome_trace(path))
    if errors:
        fail(f"chiplets: the Chrome trace is invalid: {errors[:5]}")
    # ms/frame in turns (1 chiplet, 4, 4, 1), then with a fresh recorder
    # attached to each run: what the telemetry costs when it is on
    walls = {"flat": [], "fabric": []}
    for name, each in (("flat", flat), ("fabric", fab), ("fabric", fab),
                       ("flat", flat)):
        walls[name] += serving_walls(each, frames)
    recorded = []
    for _ in range(WALL_REPS):
        fab.recorder = LinkRecorder(fab.placement.noc)
        t0 = time.perf_counter()
        serve_stream(fab, frames, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        recorded.append((time.perf_counter() - t0) / FRAMES)
    fab.recorder = None
    hm = rec.heatmap()
    log(f"[chiplets] vgg11 over {CHIPLETS} {NOI_TOPOLOGY} chiplets "
        f"({fab.placement.noc.rows}x{fab.placement.noc.cols} fabric): logits "
        f"== the 1-chiplet run by value, measured II {rep.measured_ii} == "
        f"analytic II {rep.analytic_ii}, heatmap == counters == analytic x "
        f"{FRAMES} frames per class {hm.class_totals()}, "
        f"serve_frames_total {served['value']}, launches {launched}; "
        f"Chrome trace of {len(events)} events valid ({path})")
    for name, label in (("fabric", f"{CHIPLETS} {NOI_TOPOLOGY} chiplets"),
                        ("flat", "1 chiplet")):
        log(f"[chiplets] wall ms/frame, {label}, no recorder, "
            f"{len(walls[name])} runs of {FRAMES} frames in turns "
            f"(batch_window={BATCH_WINDOW}): median "
            f"{np.median(walls[name]) * 1e3:.4f}, all "
            f"{[round(v * 1e3, 4) for v in walls[name]]}")
    log(f"[chiplets] wall ms/frame, {CHIPLETS} chiplets with a recorder "
        f"attached: median {np.median(recorded) * 1e3:.4f}, all "
        f"{[round(v * 1e3, 4) for v in recorded]} (the checked serve "
        f"{recorded_s / FRAMES * 1e3:.4f}); phase 2's 1-chiplet median "
        f"{wall_flat * 1e3:.4f}; phase {time.perf_counter() - t_phase:.1f} s "
        f"on {card}")


def lm_program(cfg, batch, prompt, gen, kv_dtype, cim, device, dtype):
    """(serve program, serving params, prompt batch): random weights and
    prompt from a generator on ``device`` seeded with SEED, so the two
    flavors serve the same weights (the int8 one quantizes them).  An
    encoder-decoder's prompt also carries ``prompt`` random frames a
    row, a ``vit_stub`` model's its patch embeddings, drawn after the
    tokens in ``dtype``, the params' dtype."""
    from repro_torch.runtime.serve_loop import build_serve_program

    prog = build_serve_program(cfg, batch=batch, s_max=prompt + gen + 1,
                               kv_dtype=kv_dtype, cim_weights=cim,
                               device=device)
    gen_ = torch.Generator(device=prog.device).manual_seed(SEED)
    params = prog.serving_params(prog.init_params(gen_, dtype))
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen_,
                           device=prog.device)
    out = {"tokens": tokens}
    fe = cfg.frontend
    if cfg.is_encdec or (fe is not None and fe.kind == "vit_stub"):
        key, n = (("frames", prompt) if cfg.is_encdec
                  else ("patch_embeds", fe.num_tokens))
        out[key] = torch.randn((batch, n, fe.embed_dim), generator=gen_,
                               device=prog.device).to(dtype)
    return prog, params, out


def warm_batch(batch, n: int = 128):
    """A short prompt of ``batch`` for warming the card: the first ``n``
    tokens (and frames) after the patch embeddings, which it keeps."""
    n += batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    return {k: (v if k == "patch_embeds" else v[:, :n])
            for k, v in batch.items()}


def depth(cfg) -> str:
    """``cfg``'s layers, an encoder-decoder's as encoder + decoder."""
    if cfg.is_encdec:
        return f"{cfg.encoder_layers} + {cfg.num_layers}"
    return f"{cfg.num_layers}"


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def timed_generate(prog, params, batch):
    """LM_REPS timed ``greedy_generate`` runs of LM_GEN tokens through
    the entry point: the prefill ends where its logits reach
    ``on_logits`` (after a synchronize).  Returns (prefill s, decode s
    per token, the last run's prefill logits, its tokens)."""
    from repro_torch.runtime.serve_loop import greedy_generate

    pre, dec, seen = [], [], {}

    def prefill_done(i, step_logits):
        if i == 0:
            torch.cuda.synchronize()
            seen["t"], seen["logits"] = time.perf_counter(), step_logits

    for _ in range(LM_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = greedy_generate(prog, params, batch, LM_GEN,
                                 on_logits=prefill_done)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pre.append(seen["t"] - t0)
        dec.append((t2 - seen["t"]) / (LM_GEN - 1))
    return pre, dec, seen["logits"], tokens


def lm_serving(la):
    """Phase 5: gemma3-1b at full width on the card, both flavors; the
    kernel's launch count per prefill; times; the plain-attention run.
    Returns (per-flavor results, the attention calls of one prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve_loop import greedy_generate

    cfg = get_config(LM_ARCH)
    results, calls = {}, []
    for name, kv_dtype, cim in LM_FLAVORS:
        t0 = time.perf_counter()
        prog, params, batch = lm_program(cfg, LM_BATCH, LM_PROMPT, LM_GEN,
                                         kv_dtype, cim, "cuda",
                                         torch.bfloat16)
        # warm the card (cuBLAS handles, allocator, the kernel library)
        greedy_generate(prog, params, warm_batch(batch), 2)
        torch.cuda.synchronize()
        log(f"[lm] {cfg.name} {name}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}; set up in "
            f"{time.perf_counter() - t0:.1f} s")

        # the counted generation is the timed one (LM_REPS 1); a second
        # prefill holds it to determinism
        for key in la.LAUNCHES:
            la.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        pre, dec, logits, tokens = timed_generate(prog, params, batch)
        torch.cuda.synchronize()
        counts = dict(la.LAUNCHES)
        launches = counts["local_attention"]
        check(counts == {"local_attention": cfg.num_layers,
                         "local_attention_f32": 0,
                         "local_attention_bwd": 0},
              f"{name}: attention launches in one prefill {counts}, want "
              f"{cfg.num_layers} of the bfloat16 kernel and none of the "
              f"float32 one")
        check(tuple(tokens.shape) == (LM_BATCH, LM_GEN)
              and int(tokens.min()) >= 0
              and int(tokens.max()) < cfg.vocab_size,
              f"{name}: generated {tuple(tokens.shape)} out of range")
        check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{name}: prefill logits {tuple(logits.shape)} not finite")
        again = prog.prefill_fn(params, batch)[0]
        check(torch.equal(torch.argmax(again, -1).int(), tokens[:, 0]),
              f"{name}: prefill is not deterministic")

        # the same prefill with the kernel's plain version swapped in
        real = la.grouped_local_attention
        la.grouped_local_attention = la.grouped_local_attention_plain
        try:
            ref_logits, _ = prog.prefill_fn(params, batch)
        finally:
            la.grouped_local_attention = real
        torch.cuda.synchronize()
        diff = (logits - ref_logits).abs()
        # bfloat16 holds the logits; the first tokens are held in float32
        # (phase 6), where the two runs can order near-ties
        first, ref_first = torch.argmax(logits, -1), torch.argmax(ref_logits,
                                                                  -1)
        log(f"[lm] {name}: kernel vs plain-attention prefill logits: max "
            f"|diff| {diff.max().item():.6f} (tolerance {TOL_FULL_LOGITS}), "
            f"mean {diff.mean().item():.6f} (tolerance "
            f"{TOL_FULL_LOGITS_MEAN}); first tokens {first.tolist()} vs "
            f"{ref_first.tolist()} (not checked in bfloat16)")
        check(diff.max().item() <= TOL_FULL_LOGITS
              and diff.mean().item() <= TOL_FULL_LOGITS_MEAN,
              f"{name}: prefill logits differ from the plain-attention run")

        if name == "bf16":
            def recorder(q, k, v, *, window, softcap=None):
                calls.append((q, k, v, window, softcap))
                return real(q, k, v, window=window, softcap=softcap)

            la.grouped_local_attention = recorder
            try:
                prog.prefill_fn(params, batch)
            finally:
                la.grouped_local_attention = real
            profile_device(lambda: prog.prefill_fn(params, batch),
                           f"one {name} prefill", keys=("tc::attn_kernel",))
        results[name] = dict(
            launches=launches, prefill_ms=[v * 1e3 for v in pre],
            decode_ms=[v * 1e3 for v in dec],
            tok_s=LM_BATCH / float(np.median(dec)),
            max_logit_diff=diff.max().item())
        log(f"[lm] {name}: launches {launches}; prefill ms "
            f"{[round(v, 3) for v in results[name]['prefill_ms']]} (median "
            f"{np.median(results[name]['prefill_ms']):.3f}); decode "
            f"ms/token {[round(v, 4) for v in results[name]['decode_ms']]} "
            f"(median {np.median(results[name]['decode_ms']):.4f}, "
            f"{results[name]['tok_s']:.1f} tokens/s at batch {LM_BATCH}); "
            f"sample {tokens[0, :8].tolist()}")
        del prog, params, batch, logits, ref_logits, again
        torch.cuda.empty_cache()
    return results, calls


def lm_full_f32_first_tokens(la):
    """Phase 6: the full-width prefill of both flavors in float32 on the
    card, with the kernel and with its plain version swapped in: every
    first token must be equal.  Returns the float32 kernel's launches in
    the first flavor's prefill."""
    from repro_torch.configs import get_config

    # full float32 products (the default, set here explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    for name, kv_dtype, cim in LM_FLAVORS:
        t0 = time.perf_counter()
        prog, params, batch = lm_program(cfg, LM_BATCH, LM_PROMPT, LM_GEN,
                                         kv_dtype, cim, "cuda",
                                         torch.float32)
        for key in la.LAUNCHES:
            la.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        logits, _ = prog.prefill_fn(params, batch)
        torch.cuda.synchronize()
        counts = dict(la.LAUNCHES)
        launches = counts["local_attention_f32"]
        if name == LM_FLAVORS[0][0]:
            f32_launches = launches
        walls = []  # the float32 prefill's wall time, as in phase 5
        for _ in range(LM_REPS):
            t1 = time.perf_counter()
            prog.prefill_fn(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        real = la.grouped_local_attention
        la.grouped_local_attention = la.grouped_local_attention_plain
        try:
            ref_logits, _ = prog.prefill_fn(params, batch)
        finally:
            la.grouped_local_attention = real
        torch.cuda.synchronize()
        first, ref_first = torch.argmax(logits, -1), torch.argmax(ref_logits,
                                                                  -1)
        top2 = torch.topk(ref_logits, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        log(f"[lm-f32] {name}: full width, float32 (TF32 off): kernel vs "
            f"plain-attention prefill logits max |diff| "
            f"{(logits - ref_logits).abs().max().item():.3e}; first tokens "
            f"{first.tolist()} vs {ref_first.tolist()}; plain run's top-2 "
            f"margins {[f'{m:.3e}' for m in margin.tolist()]}; "
            f"launches {counts}; prefill ms "
            f"{[round(v, 3) for v in walls]} (median "
            f"{np.median(walls):.3f}); {time.perf_counter() - t0:.1f} s")
        check(counts == {"local_attention": 0,
                         "local_attention_f32": cfg.num_layers,
                         "local_attention_bwd": 0},
              f"{name} float32: attention launches in one prefill {counts}, "
              f"want {cfg.num_layers} of the float32 kernel and none of "
              f"the bfloat16 one")
        check(torch.equal(first, ref_first),
              f"{name} float32: first tokens {first.tolist()} with the "
              f"kernel, {ref_first.tolist()} with plain attention")
        del prog, params, batch, logits, ref_logits
        torch.cuda.empty_cache()
    return f32_launches


def lm_reduced_vs_cpu(cfg, label: str = "lm-small"):
    """Phase 7 (and phase F's card-against-CPU check): both flavors of
    ``cfg`` in float32 on the card and on the CPU, batch 1, a
    SMALL_PROMPT-token prompt, SMALL_GEN tokens."""
    from repro_torch.runtime.serve_loop import (build_serve_program,
                                                greedy_generate)

    def logged(prog, params, batch):
        seen = []
        tokens = greedy_generate(prog, params, batch, SMALL_GEN,
                                 on_logits=lambda i, lg: seen.append(lg))
        return tokens, seen

    # full float32 products on the card, as on the CPU (the default, set
    # here explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, kv_dtype, cim in LM_FLAVORS:
        t0 = time.perf_counter()
        prog, params, batch = lm_program(cfg, 1, SMALL_PROMPT, SMALL_GEN,
                                         kv_dtype, cim, "cuda", torch.float32)
        tok_card, seen_card = logged(prog, params, batch)
        torch.cuda.synchronize()
        cpu_prog = build_serve_program(cfg, batch=1, s_max=prog.s_max,
                                       kv_dtype=kv_dtype, cim_weights=cim,
                                       device="cpu")
        tok_cpu, seen_cpu = logged(cpu_prog, to_device(params, "cpu"),
                                   to_device(batch, "cpu"))
        errs = []
        for i, (a, b) in enumerate(zip(seen_card, seen_cpu)):
            tol = TOL_SMALL["bfloat16" if i == 0 else kv_dtype]
            a = a.cpu()
            errs.append((a - b).abs().max().item())
            check(torch.allclose(a, b, rtol=tol, atol=tol),
                  f"{cfg.name} {name} reduced: step {i} logits differ from "
                  f"the CPU run by {errs[-1]} (tolerance {tol})")
        check(torch.equal(tok_card.cpu(), tok_cpu),
              f"{cfg.name} {name} reduced: tokens {tok_card.tolist()} on "
              f"the card, {tok_cpu.tolist()} on the CPU")
        log(f"[{label}] {cfg.name} {name}: {depth(cfg)} layers, "
            f"d_model {cfg.d_model}, prompt {SMALL_PROMPT}, {SMALL_GEN} "
            f"tokens, float32 (TF32 off): tokens equal "
            f"{tok_cpu[0].tolist()}; max |logit diff| per step "
            f"{[f'{e:.2e}' for e in errs]} (prefill tolerance "
            f"{TOL_SMALL['bfloat16']}, decode {TOL_SMALL[kv_dtype]}); "
            f"{time.perf_counter() - t0:.1f} s")
        del prog, params
        torch.cuda.empty_cache()


def attn_close(a, b, dtype) -> bool:
    tol = TOL_ATTN[dtype]
    return torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)


def attn_case(la, q, k, v, window, cap, what, worst) -> None:
    """One attention call against its plain version: within TOL_ATTN,
    and one launch of q's dtype's kernel and none of the other."""
    name = ATTN_KERNEL[q.dtype]
    before = dict(la.LAUNCHES)
    a = la.grouped_local_attention(q, k, v, window=window, softcap=cap)
    launched = {key: la.LAUNCHES[key] - before[key] for key in before}
    b = la.grouped_local_attention_plain(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    err = (a.float() - b.float()).abs().max().item()
    worst[name] = max(worst[name], err)
    check(launched == {key: int(key == name) for key in before},
          f"{what}: launches {launched}, want one of {name}")
    check(attn_close(a, b, q.dtype),
          f"{name} != plain at {what}: max |diff| {err}")


def check_attention(la, calls):
    """Phase 8: both attention kernels against their plain version on the
    card.  Returns each kernel's largest |diff|."""
    names = list(ATTN_KERNEL.values())
    worst_main = dict.fromkeys(names, 0.0)
    n_checks = 0
    for q, k, v, window, cap in calls:
        for dtype in (torch.bfloat16, torch.float32):
            attn_case(la, q.to(dtype), k.to(dtype), v.to(dtype), window, cap,
                      f"main-path call {tuple(q.shape)} window {window} "
                      f"{dtype}", worst_main)
            n_checks += 1
    rng = np.random.default_rng(SEED + 2)
    worst = dict.fromkeys(names, 0.0)
    for d in (16, 64, 128, 256):
        for s in (37, 777, 2049):
            for group in (1, 2, 4, 8):
                base = [torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)).cuda() for shape in
                    ((1, s, 2 * group, d), (1, s, 2, d), (1, s, 2, d))]
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = (t.to(dtype) for t in base)
                    for window in (1, 63, 65, 100, 513, s):
                        for cap in (None, 50.0):
                            attn_case(la, q, k, v, window, cap,
                                      f"d {d} S {s} group {group} window "
                                      f"{window} softcap {cap} {dtype}",
                                      worst)
                            n_checks += 1
    for h, kvh, d in ATTN_FAMILY_SHAPES:
        for s in (37, 777, 2049):
            base = [torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda() for shape in
                ((1, s, h, d), (1, s, kvh, d), (1, s, kvh, d))]
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dtype) for t in base)
                for window in (65, s):
                    attn_case(la, q, k, v, window, None,
                              f"d {d} S {s} heads {h} / {kvh} window "
                              f"{window} {dtype}", worst)
                    n_checks += 1
    for d in la.HEAD_DIMS:  # the float32 kernel's own tile edges
        for s in EDGE_F32_S:
            for group in (1, 4):
                q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)).cuda() for shape in
                    ((1, s, 2 * group, d), (1, s, 2, d), (1, s, 2, d))]
                for window in EDGE_F32_WINDOWS + (s,):
                    for cap in (None, 50.0):
                        attn_case(la, q, k, v, window, cap,
                                  f"d {d} S {s} group {group} window "
                                  f"{window} softcap {cap} float32", worst)
                        n_checks += 1
    log(f"[attention] {n_checks} comparisons (tolerance "
        f"{ {str(k): v for k, v in TOL_ATTN.items()} }); max |diff| at the "
        f"main-path calls {worst_main}; at the edge cases {worst}")
    return {name: max(worst_main[name], worst[name]) for name in names}


def device_ms(fn, arglist, n, kernel=None, split=False):
    """Device time (ms) of one pass of ``fn`` over ``arglist``: the sum of
    the device kernels' own times under ``torch.profiler``, so the host's
    launch time and the idle gaps between launches do not count.  With
    ``split`` (and ``kernel`` a tuple), a dict of each kernel's ms.

    ``kernel``: a substring of the name of the one kernel each call
    launches (or a tuple of them, one per kernel a call launches once
    each).  Only those kernels' records count, each as their mean times
    the calls of a pass: the profiler does not record every launch of a
    long run of them (seen on the card: about half of 20 back-to-back
    float32 attention launches), and a sum over the records it kept,
    divided by the launches made, would come out short."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    for args in arglist:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    # a profiling session now and then records no device activity at all
    # (seen once on the card, in phase 4): profile again, then fail
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                for args in arglist:
                    fn(*args)
            torch.cuda.synchronize()
        total, count = {}, {}
        for ev in prof.key_averages():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                continue
            hit = None if names is None else next(
                (k for k in names if k in ev.key), False)
            if hit is False:
                continue
            total[hit] = total.get(hit, 0.0) + getattr(
                ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0))
            count[hit] = count.get(hit, 0) + ev.count
        if names is None and total.get(None, 0.0) > 0:
            return total[None] / n / 1e3
        if names is not None and all(total.get(k, 0.0) > 0 for k in names):
            each = {}
            for k in names:
                if count[k] != n * len(arglist):
                    log(f"[profile] {count[k]} of {n * len(arglist)} "
                        f"launches of {k} recorded; their mean counts")
                each[k] = total[k] / count[k] * len(arglist) / 1e3
            return each if split else sum(each.values())
        log(f"[profile] session {attempt + 1} saw no device time")
    # a RuntimeError, so that a yardstick's caller can record "not
    # measured"; uncaught, it fails the run as fail() does
    raise RuntimeError("the profiler saw no device time")


def event_ms(fn, arglist, n):
    """Host-inclusive time (ms) of one pass: CUDA events around n
    back-to-back passes."""
    for args in arglist:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(n):
        for args in arglist:
            fn(*args)
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / n


def time_attention(la, calls, card, reps: int = 10):
    """Phase 9: each attention kernel's times on the main path's calls
    (the bfloat16 prefill's, and the same in float32).  Returns the
    prefill row of each kernel."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False

    def kernel(q, k, v, window, cap):
        la.grouped_local_attention(q, k, v, window=window, softcap=cap)

    def plain(q, k, v, window, cap):
        la.grouped_local_attention_plain(q, k, v, window=window,
                                         softcap=cap)

    def library(q, k, v, mask, cap):
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def library_causal(q, k, v, mask, cap):
        # a global layer's function exactly; SDPA may take its flash path
        if mask is None:
            F.scaled_dot_product_attention(q, k, v, is_causal=True)
        else:
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    local = next(i for i, c in enumerate(calls) if c[3] < c[0].shape[1])
    glob = next(i for i, c in enumerate(calls) if c[3] >= c[0].shape[1])
    # SDPA has no soft cap, which gemma3 does not use
    has_lib = all(cap is None for *_, cap in calls)
    out = {}
    for dtype, peak in ((torch.bfloat16, PEAK_BF16_OPS),
                        (torch.float32, PEAK_F32_OPS)):
        name = ATTN_KERNEL[dtype]
        args = [(q.to(dtype), k.to(dtype), v.to(dtype), window, cap)
                for q, k, v, window, cap in calls]
        # the yardsticks' (B, H, S, D) copies and band masks, made outside
        # the timing
        masks, lib_args, causal_args = {}, [], []
        for q, k, v, window, cap in args:
            s, h = q.shape[1], q.shape[2]
            if window not in masks:
                pos = torch.arange(s, device=q.device)
                masks[window] = (pos[None, :] <= pos[:, None]) & (
                    pos[None, :] > pos[:, None] - window)
            qkv = (q.transpose(1, 2).contiguous(),
                   k.expand(-1, -1, h, -1).transpose(1, 2).contiguous(),
                   v.expand(-1, -1, h, -1).transpose(1, 2).contiguous())
            lib_args.append(qkv + (masks[window], cap))
            causal_args.append(qkv + (None if window >= s else masks[window],
                                      cap))
        for label, idx, n in (("one local launch", [local], 20),
                              ("one global launch", [glob], 20),
                              ("one prefill (26 launches)",
                               list(range(len(args))), reps)):
            sel = [args[i] for i in idx]
            ops = sum(attn_work(*c[:4])[0] for c in sel)
            nbytes = sum(attn_work(*c[:4])[1] for c in sel)
            tiles = {} if dtype == torch.bfloat16 else la.F32_TILES
            computed = sum(
                c[0].shape[0] * c[0].shape[2]
                * la.tile_schedule(c[0].shape[1], c[3], **tiles).operations(
                    c[0].shape[3], c[2].shape[3]) for c in sel)
            t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
            row = dict(ms=device_ms(kernel, sel, n, kernel="attn_kernel"),
                       host_inclusive_ms=event_ms(kernel, sel, n),
                       plain_ms=device_ms(plain, sel, n),
                       library_ms=(device_ms(library,
                                             [lib_args[i] for i in idx], n)
                                   if has_lib else None),
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       calls=len(sel))
            if has_lib and label != "one local launch":
                # is_causal on the global launches, the band mask elsewhere
                row["library_causal_ms"] = device_ms(
                    library_causal, [causal_args[i] for i in idx], n)
            row["tflops_unmasked"] = ops / row["ms"] / 1e9
            row["tflops_computed"] = computed / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            q = sel[0][0]
            log(f"[time] {name} {label}, q {tuple(q.shape)} {q.dtype}, "
                f"window {sel[0][3] if len(sel) == 1 else 'per layer'}: "
                f"{row} on {card}")
            out[name] = row
        del args, lib_args, causal_args
        torch.cuda.empty_cache()
    return out


def family_config(arch: str, layers=None):
    """Phase F's (or E's) config of ``arch``: the published widths, cut in
    depth to ``layers`` (``FAMILY_LAYERS[arch]`` by default; None or
    absent: uncut), with no multi-token-prediction block (serving never
    reads it)."""
    from repro_torch.configs import get_config

    layers = FAMILY_LAYERS.get(arch) if layers is None else layers
    cfg = dataclasses.replace(get_config(arch), mtp_depth=0)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def n_params(tree) -> int:
    """Elements of every tensor in a params tree."""
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def all_launches(la, ss):
    return {**la.LAUNCHES, **ss.LAUNCHES}


def reset_lm_counts(la, ss):
    for counts in (la.LAUNCHES, ss.LAUNCHES):
        for key in counts:
            counts[key] = 0


class Swapped:
    """Module attributes replaced for the duration of a ``with`` block:
    ``Swapped((module, name, fn), ...)``."""

    def __init__(self, *swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n, _ in self.swaps]
        for m, n, fn in self.swaps:
            setattr(m, n, fn)

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.swaps, self.saved):
            setattr(m, n, fn)


def plain_kernels(la, ss):
    """Both kernels' plain versions swapped in for the wrappers."""
    return Swapped((la, "grouped_local_attention",
                    la.grouped_local_attention_plain),
                   (ss, "selective_scan", ss.selective_scan_plain))


def checked_kernels(la, ss, worst, first):
    """Wrappers that launch each kernel and hold its result against the
    plain version on the same inputs (TOL_ATTN, TOL_SCAN); the largest
    |diff| per kernel goes into ``worst``, the first call's operands of
    each into ``first["attn"]`` / ``first["scan"]``, every attention
    call's into ``first["attn_calls"]``."""
    attn, scan = la.grouped_local_attention, ss.selective_scan

    def attn_checked(q, k, v, *, window, softcap=None):
        out = attn(q, k, v, window=window, softcap=softcap)
        first.setdefault("attn", (q, k, v, window))
        first.setdefault("attn_calls", []).append((q, k, v, window, softcap))
        ref = la.grouped_local_attention_plain(q, k, v, window=window,
                                               softcap=softcap)
        name = ATTN_KERNEL[q.dtype]
        err = (out.float() - ref.float()).abs().max().item()
        worst[name] = max(worst.get(name, 0.0), err)
        check(attn_close(out, ref, q.dtype),
              f"{name} != plain at main-path call {tuple(q.shape)} window "
              f"{window}: max |diff| {err}")
        return out

    def scan_checked(*ops):
        y, h = scan(*ops)
        y_ref, h_ref = ss.selective_scan_plain(*ops)
        err = max((y - y_ref).abs().max().item(),
                  (h - h_ref).abs().max().item())
        worst["selective_scan"] = max(worst.get("selective_scan", 0.0), err)
        check(torch.allclose(y, y_ref, rtol=TOL_SCAN, atol=TOL_SCAN)
              and torch.allclose(h, h_ref, rtol=TOL_SCAN, atol=TOL_SCAN),
              f"selective_scan != plain at main-path call "
              f"{tuple(ops[0].shape)}: max |diff| {err}")
        first.setdefault("scan", ops)
        return y, h

    return Swapped((la, "grouped_local_attention", attn_checked),
                   (ss, "selective_scan", scan_checked))


def moe_drops(prog, params, batch):
    """(capacity, dropped pairs, pairs) summed over the MoE layers of one
    prefill and of one decode step."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.moe_forward
    seen = []

    def recorder(p, x, cfg, plan):
        dropped, cap = moe_mod.dropped_pairs(p, x, cfg, plan)
        seen.append((cap, dropped, x.shape[0] * x.shape[1] * cfg.moe.top_k))
        return real(p, x, cfg, plan)

    with Swapped((moe_mod, "moe_forward", recorder)):
        logits, caches = prog.prefill_fn(params, batch)
        pre = list(seen)
        seen.clear()
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        prog.decode_fn(params, token, caches, batch["tokens"].shape[1])
    torch.cuda.synchronize()
    return ({c for c, _, _ in pre}, sum(d for _, d, _ in pre),
            sum(n for _, _, n in pre)), \
        ({c for c, _, _ in seen}, sum(d for _, d, _ in seen),
         sum(n for _, _, n in seen))


def family_serving(la, ss, arch: str, card, label: str = "F"):
    """Phase F (or E), one model: served at full width in both flavors.
    Returns per-flavor results, the kernels' launches of the counted
    runs, each kernel's largest |diff| from its plain version and the
    first kernel calls of a bf16 prefill."""
    from repro_torch.runtime.serve_loop import greedy_generate

    cfg = family_config(arch)
    want = FAMILY_LAUNCHES[arch]
    max_tol, mean_tol = TOL_FAMILY_LOGITS[arch]
    results, launches, worst, first = {}, {}, {}, {}
    for name, kv_dtype, cim in LM_FLAVORS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        prog, params, batch = lm_program(cfg, LM_BATCH, LM_PROMPT, LM_GEN,
                                         kv_dtype, cim, "cuda",
                                         torch.bfloat16)
        # warm the card (cuBLAS handles, allocator, the kernel libraries)
        greedy_generate(prog, params, warm_batch(batch), 2)
        torch.cuda.synchronize()
        log(f"[{label}] {arch} {name}: {depth(cfg)} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params(params)} "
            f"served tensor elements; set up in "
            f"{time.perf_counter() - t0:.1f} s")

        # the counted generation is the timed one (LM_REPS 1); a second
        # prefill is held bit-equal to it
        reset_lm_counts(la, ss)
        torch.cuda.synchronize()
        pre, dec, logits, tokens = timed_generate(prog, params, batch)
        torch.cuda.synchronize()
        counts = all_launches(la, ss)
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v
        check(counts == want,
              f"{arch} {name}: launches in one generation {counts}, want "
              f"{want} (one prefill; decode launches none)")
        check(tuple(tokens.shape) == (LM_BATCH, LM_GEN)
              and int(tokens.min()) >= 0
              and int(tokens.max()) < cfg.vocab_size,
              f"{arch} {name}: generated {tuple(tokens.shape)} out of range")
        check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{arch} {name}: prefill logits {tuple(logits.shape)} not "
              f"finite")
        again = prog.prefill_fn(params, batch)[0]
        check(torch.equal(logits, again),
              f"{arch} {name}: two prefills gave other logits (max |diff| "
              f"{(logits - again).abs().max().item()})")

        with plain_kernels(la, ss):
            ref_logits, _ = prog.prefill_fn(params, batch)
        torch.cuda.synchronize()
        diff = (logits - ref_logits).abs()
        log(f"[{label}] {arch} {name}: kernels vs plain versions, prefill "
            f"logits max |diff| {diff.max().item():.6f} (tolerance "
            f"{max_tol}), mean {diff.mean().item():.6f} (tolerance "
            f"{mean_tol}); first "
            f"tokens {torch.argmax(logits, -1).tolist()} vs "
            f"{torch.argmax(ref_logits, -1).tolist()} (not checked in "
            f"bfloat16)")
        check(diff.max().item() <= max_tol and diff.mean().item() <= mean_tol,
              f"{arch} {name}: prefill logits differ from the plain run")
        if cfg.moe is not None:
            (cap_p, drop_p, n_p), (cap_d, drop_d, n_d) = moe_drops(
                prog, params, batch)
            log(f"[{label}] {arch} {name}: MoE capacity {sorted(cap_p)} per "
                f"expert in a prefill, {sorted(cap_d)} in a decode step; "
                f"(token, k) pairs dropped: {drop_p} of {n_p} in one "
                f"prefill, {drop_d} of {n_d} in one decode step")
        if name == "bf16":
            with checked_kernels(la, ss, worst, first):
                prog.prefill_fn(params, batch)
            torch.cuda.synchronize()
            share, found = profile_device(
                lambda: prog.prefill_fn(params, batch),
                f"{arch}: one {name} prefill", keys=FAMILY_KERNEL_NAMES)
            results["profile"] = dict(busy=share, kernels=found)
        results[name] = dict(
            prefill_ms=[v * 1e3 for v in pre],
            decode_ms=[v * 1e3 for v in dec],
            tok_s=LM_BATCH / float(np.median(dec)),
            max_logit_diff=diff.max().item(),
            mean_logit_diff=diff.mean().item())
        log(f"[{label}] {arch} {name}: launches {counts}; prefill ms "
            f"{[round(v, 3) for v in results[name]['prefill_ms']]} (median "
            f"{np.median(results[name]['prefill_ms']):.3f}); decode "
            f"ms/token {[round(v, 4) for v in results[name]['decode_ms']]} "
            f"(median {np.median(results[name]['decode_ms']):.4f}, "
            f"{results[name]['tok_s']:.1f} tokens/s at batch {LM_BATCH}); "
            f"sample {tokens[0, :8].tolist()}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"{time.perf_counter() - t0:.1f} s on {card}")
        del prog, params, batch, logits, ref_logits, again
        torch.cuda.empty_cache()
    return results, launches, worst, first


def check_scan(ss):
    """Phase F: the scan kernel against its plain version over an edge
    grid; one launch a call.  Returns the largest |diff|."""
    rng = np.random.default_rng(SEED + 3)
    worst, n_checks = 0.0, 0
    for n in EDGE_SCAN_N:
        for s in EDGE_SCAN_S:
            for dl in EDGE_SCAN_D:
                dt = np.log1p(np.exp(rng.standard_normal((2, s, dl)) - 2.0))
                a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (dl, 1))
                base = [dt, rng.standard_normal((2, s, dl)),
                        rng.standard_normal((2, s, n)),
                        rng.standard_normal((2, s, n)), a,
                        rng.standard_normal(dl)]
                ops = [torch.from_numpy(v.astype(np.float32)).cuda()
                       for v in base]
                h0 = torch.from_numpy(rng.standard_normal(
                    (2, dl, n)).astype(np.float32)).cuda()
                for init in (None, h0):
                    before = ss.LAUNCHES["selective_scan"]
                    y, h = ss.selective_scan(*ops, init)
                    launched = ss.LAUNCHES["selective_scan"] - before
                    y_ref, h_ref = ss.selective_scan_plain(*ops, init)
                    torch.cuda.synchronize()
                    err = max((y - y_ref).abs().max().item(),
                              (h - h_ref).abs().max().item())
                    worst = max(worst, err)
                    what = (f"S {s} d_inner {dl} d_state {n} h0 "
                            f"{init is not None}")
                    check(launched == 1,
                          f"selective_scan at {what}: {launched} launches")
                    check(torch.allclose(y, y_ref, rtol=TOL_SCAN,
                                         atol=TOL_SCAN)
                          and torch.allclose(h, h_ref, rtol=TOL_SCAN,
                                             atol=TOL_SCAN),
                          f"selective_scan != plain at {what}: max |diff| "
                          f"{err}")
                    n_checks += 1
    log(f"[scan] {n_checks} edge comparisons (rtol = atol = {TOL_SCAN}): "
        f"max |diff| {worst:.3e}")
    return worst


def check_mla_attention(la, calls):
    """Phase 8 at deepseek-v3's MLA head dims (q / k 192, v 128): both
    kernels against their plain version at its prefill's calls and over
    the edge grid.  Returns each kernel's largest |diff|."""
    names = list(ATTN_KERNEL.values())
    worst_main, worst = (dict.fromkeys(names, 0.0) for _ in range(2))
    n_checks = 0
    for q, k, v, window, cap in calls:
        for dtype in (torch.bfloat16, torch.float32):
            attn_case(la, q.to(dtype), k.to(dtype), v.to(dtype), window, cap,
                      f"MLA main-path call {tuple(q.shape)} v "
                      f"{tuple(v.shape)} window {window} {dtype}",
                      worst_main)
            n_checks += 1
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 4)

    def operands(s, group):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda() for shape in
            ((1, s, 2 * group, 192), (1, s, 2, 192), (1, s, 2, 128))]

    for s in (37, 777, 2049):
        for group in (1, 4):
            base = operands(s, group)
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dtype) for t in base)
                for window in (1, 63, 65, 100, 513, s):
                    for cap in (None, 50.0):
                        attn_case(la, q, k, v, window, cap,
                                  f"MLA S {s} group {group} window {window} "
                                  f"softcap {cap} {dtype}", worst)
                        n_checks += 1
    for s in EDGE_F32_S:  # the float32 kernel's own tile edges
        for group in (1, 4):
            q, k, v = operands(s, group)
            for window in EDGE_F32_WINDOWS + (s,):
                for cap in (None, 50.0):
                    attn_case(la, q, k, v, window, cap,
                              f"MLA S {s} group {group} window {window} "
                              f"softcap {cap} float32", worst)
                    n_checks += 1
    log(f"[attention] MLA head dims (q/k 192, v 128): {n_checks} "
        f"comparisons (tolerance "
        f"{ {str(k): v for k, v in TOL_ATTN.items()} }); max |diff| at the "
        f"main-path calls {worst_main}; at the edge cases {worst}")
    return {name: max(worst_main[name], worst[name]) for name in names}


def time_full_causal(la, call, what: str, card, reps: int = 20):
    """Phase 9 at one full-causal prefill call of a phase-F or phase-E
    model (deepseek-v3's q (4, 2048, 128, 192) against v (4, 2048, 128,
    128); seamless-m4t's decoder and internvl2's layers): each kernel's
    device time, beside the plain version, SDPA with ``is_causal=True``
    (exactly its function; k and v repeated over their query groups) and
    the bound.  Returns the rows by kernel."""
    import torch.nn.functional as F

    def kernel(q, k, v, window, cap):
        la.grouped_local_attention(q, k, v, window=window, softcap=cap)

    def plain(q, k, v, window, cap):
        la.grouped_local_attention_plain(q, k, v, window=window,
                                         softcap=cap)

    def library_causal(q, k, v):
        F.scaled_dot_product_attention(q, k, v, is_causal=True)

    out = {}
    for dtype, peak in ((torch.bfloat16, PEAK_BF16_OPS),
                        (torch.float32, PEAK_F32_OPS)):
        name = ATTN_KERNEL[dtype]
        q, k, v, window, cap = call
        args = (q.to(dtype), k.to(dtype), v.to(dtype), window, cap)
        ops, nbytes = attn_work(*args[:4])
        t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
        s = q.shape[1]
        computed = q.shape[0] * q.shape[2] * la.tile_schedule(
            s, window, **({} if dtype == torch.bfloat16 else la.F32_TILES)
        ).operations(q.shape[3], v.shape[3])
        row = dict(ms=device_ms(kernel, [args], reps, kernel="attn_kernel"),
                   host_inclusive_ms=event_ms(kernel, [args], reps),
                   plain_ms=device_ms(plain, [args], 3),
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        if window >= s and cap is None:
            # SDPA's device time, and CUDA events around back-to-back
            # calls: the profiler may not record every launch of a run,
            # and SDPA's kernels are not known by name beforehand
            group = q.shape[2] // k.shape[2]
            qkv = tuple(t.repeat_interleave(r, dim=2).transpose(1, 2)
                        .contiguous()
                        for t, r in zip(args[:3], (1, group, group)))
            try:
                row["library_causal_ms"] = device_ms(library_causal, [qkv],
                                                     reps)
                row["library_causal_event_ms"] = event_ms(library_causal,
                                                          [qkv], reps)
                profile_device(lambda: library_causal(*qkv),
                               f"SDPA is_causal, {dtype}", keys=())
            except RuntimeError as e:  # a yardstick; the kernel is timed
                log(f"[time] SDPA is_causal at {what}: {e}")
                row["library_causal_ms"] = None
            del qkv
        row["tflops_unmasked"] = ops / row["ms"] / 1e9
        row["tflops_computed"] = computed / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(f"[time] {name} one {what} prefill launch, q {tuple(q.shape)} v "
            f"{tuple(v.shape)} {dtype}, window {window}: {row} "
            f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB) on {card}")
        out[name] = row
        del args
        torch.cuda.empty_cache()
    return out


def families_phase(la, ss, card):
    """Phase F: granite-moe-3b-a800m, falcon-mamba-7b, jamba-v0.1-52b
    (one 8-layer cycle) and deepseek-v3-671b (its first 4 layers) served
    at full width, both flavors; the card against the CPU in float32; the
    scan kernel against its plain version and its times; phases 8 and 9
    at deepseek's MLA head dims.  Returns the scan's ``kernels`` row, the
    bfloat16 attention kernel's launches in the counted runs and each
    kernel's largest |diff| from its plain version."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    launches, worst, scan_call = {}, {}, None
    for arch in FAMILY_LAYERS:
        res, counted, worst_a, first = family_serving(la, ss, arch, card)
        for key, v in counted.items():
            launches[key] = launches.get(key, 0) + v
        for key, v in worst_a.items():
            worst[key] = max(worst.get(key, 0.0), v)
        if arch == SCAN_ARCH:
            scan_call, scan_profile = first["scan"], res["profile"]
        if arch == MLA_ARCH:
            mla_calls = first["attn_calls"]
        if "attn" in first:
            n = FAMILY_LAUNCHES[arch]["local_attention"]
            ops, nbytes = attn_work(*first["attn"])
            found = res["profile"]["kernels"] or {}
            dev = found.get("tc::attn_kernel", (None, None))
            bound = n * max(ops / PEAK_BF16_OPS, nbytes / PEAK_BYTES)
            log(f"[F] {arch}: bfloat16 attention, q "
                f"{tuple(first['attn'][0].shape)}: {dev[0]} launches, "
                f"{dev[1]} us of device time in one prefill; bound "
                f"{bound * 1e3:.4f} ms for its {n} launches on {card}")
        log(f"[F] {arch}: prefill ms / decode ms per token / tokens per s "
            "(medians): " + "; ".join(
                f"{k} {np.median(v['prefill_ms']):.3f} / "
                f"{np.median(v['decode_ms']):.4f} / {v['tok_s']:.1f}"
                for k, v in res.items() if k != "profile")
            + f"; busy {res['profile']['busy']} in a bf16 prefill on {card}")
    log(f"[F] main-path calls vs plain versions: max |diff| {worst}")

    t0 = time.perf_counter()
    for arch in FAMILY_LAYERS:
        cfg = (get_config(arch).reduced() if FAMILY_SMALL_LAYERS[arch] is None
               else family_config(arch, FAMILY_SMALL_LAYERS[arch]))
        lm_reduced_vs_cpu(cfg, "F-small")
    log(f"[F] card against CPU: {time.perf_counter() - t0:.1f} s")
    worst_edge = check_scan(ss)
    # phases 8 and 9 at the MLA head dims, on deepseek's prefill calls
    for key, v in check_mla_attention(la, mla_calls).items():
        worst[key] = max(worst.get(key, 0.0), v)
    del mla_calls

    # the scan's times: the first call of one falcon-mamba bf16 prefill,
    # repeated as often as a prefill launches it (every call has that
    # shape), as device time
    per_prefill = FAMILY_LAUNCHES[SCAN_ARCH]["selective_scan"]
    ops, nbytes = scan_work(*scan_call)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    ms = device_ms(lambda *a: ss.selective_scan(*a), [scan_call] * per_prefill,
                   1, kernel="scan_kernel")
    # the plain version's per prefill: one call's (every call has this
    # shape) times the calls; its thousands of small launches a call make
    # a profiled prefill of them cost a minute of host time.  The row
    # says so: ``calls`` calls are timed for ``ms``, ``plain_calls`` for
    # ``plain_ms``, which is scaled to ``calls``
    plain_calls = 1
    plain_ms = per_prefill / plain_calls * device_ms(
        lambda *a: ss.selective_scan_plain(*a), [scan_call] * plain_calls, 1)
    bound_ms = max(t_ops, t_bytes) * 1e3 * per_prefill
    row = {"name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
           "replaces": SCAN_REPLACES,
           "launches": launches["selective_scan"],
           "max_abs_err": max(worst.get("selective_scan", 0.0), worst_edge),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None, "calls": per_prefill,
           "plain_calls": plain_calls}
    log(f"[time] selective_scan per {SCAN_ARCH} prefill ({per_prefill} "
        f"calls, dt {tuple(scan_call[0].shape)}, d_state "
        f"{scan_call[4].shape[1]}): {ms:.4f} ms device time (profiled "
        f"in the prefill, launches and us: {scan_profile['kernels']}), "
        f"bound {bound_ms:.4f} "
        f"ms ({row['bound_by']}; {ops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e9:.3f} GB a call), {100 * bound_ms / ms:.1f}% of it; "
        f"plain {plain_ms:.4f} ms ({plain_calls} call timed, times "
        f"{per_prefill}) on {card}")
    log(f"[F] phase F: {time.perf_counter() - t_phase:.1f} s on {card}")
    return row, launches["local_attention"], worst


def encdec_vlm_phase(la, ss, card):
    """Phase E: seamless-m4t-large-v2 and internvl2-2b at full width and
    depth in both flavors, served as phase F serves its models; one
    decoder launch of each timed as in phase 9; seamless's plain
    bidirectional attention beside its prefill; the card against the CPU
    in float32, cut in depth.  Returns the bfloat16 attention kernel's
    launches in the counted runs and each kernel's largest |diff| from
    its plain version."""
    t_phase = time.perf_counter()
    launches, worst = 0, {}
    for arch in E_ARCHS:
        res, counted, worst_a, first = family_serving(la, ss, arch, card, "E")
        launches += counted["local_attention"]
        for key, v in worst_a.items():
            worst[key] = max(worst.get(key, 0.0), v)
        n = FAMILY_LAUNCHES[arch]["local_attention"]
        ops, nbytes = attn_work(*first["attn"])
        found = res["profile"]["kernels"] or {}
        dev = found.get("tc::attn_kernel", (None, None))
        bound = n * max(ops / PEAK_BF16_OPS, nbytes / PEAK_BYTES)
        log(f"[E] {arch}: bfloat16 attention, q "
            f"{tuple(first['attn'][0].shape)}: {dev[0]} launches, {dev[1]} us "
            f"of device time in one prefill; bound {bound * 1e3:.4f} ms for "
            f"its {n} launches on {card}")
        log(f"[E] {arch}: prefill ms / decode ms per token / tokens per s "
            "(medians): " + "; ".join(
                f"{k} {np.median(v['prefill_ms']):.3f} / "
                f"{np.median(v['decode_ms']):.4f} / {v['tok_s']:.1f}"
                for k, v in res.items() if k != "profile")
            + f"; busy {res['profile']['busy']} in a bf16 prefill on {card}")
        call = first["attn_calls"][0]
        del first
        time_full_causal(la, call, arch, card)
        del call
        torch.cuda.empty_cache()
    log(f"[E] main-path calls vs plain versions: max |diff| {worst}")
    t0 = time.perf_counter()
    for arch, n in E_SMALL_LAYERS.items():
        cfg = family_config(arch, n)
        if cfg.is_encdec:
            cfg = dataclasses.replace(cfg, encoder_layers=n)
        lm_reduced_vs_cpu(cfg, "E-small")
    log(f"[E] card against CPU: {time.perf_counter() - t0:.1f} s")
    log(f"[E] phase E: {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, worst


# ---------------------------------------------------------------------------
# Phase G: gemma3-1b trained at full width and depth
# ---------------------------------------------------------------------------

BWD_SOURCE = "src/repro_torch/csrc/local_attention_bwd.cu"
#: no TPU kernel computes the gradient: the reference gets it by autodiff
#: of its plain attention, ``flash_attention`` at this line
BWD_REPLACES = "src/repro/models/common.py:232"
#: the backward's kernels, as the profiler names them: the tensor-core
#: route's three (bf16 at D 64 to 256) beside the CUDA-core route's
#: (float32, bf16 at D 16); a call launches one route's three
#: (``la.BWD_KERNELS[la.bwd_route(dtype, d)]``)
BWD_KERNELS = ("tc_stats", "tc_dkdv", "tc_dq",
               "cc_stats", "cc_dkdv", "cc_dq")
TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_STEP = 4, 2048, 8, 4
#: the reference's test_train_steps_decrease_loss: AdamW with float32
#: moments, lr 3e-3, warmup 2, one fixed batch (seed 1, step 0)
TRAIN_CFG = dict(optimizer="adamw", lr=3e-3, warmup_steps=2,
                 total_steps=50)
TRAIN_DATA_SEED = 1
TRAIN_LOSS_DROP = 0.3
#: the float32 check against the CPU: the published widths cut to 12
#: layers (two 6-layer cycles: one segment of count 2, checkpointed),
#: batch 1, 640 tokens, TF32 off
TRAIN_SMALL_LAYERS, TRAIN_SMALL_SEQ = 12, 640
#: gemma3-1b's full-width backward calls in float32: q, dO (batch, S,
#: heads, D), k, v on its one kv head, a local window and a global one
BWD_F32_FULL = dict(batch=4, seq=2048, heads=4, kv_heads=1, d=256,
                    windows=(512, 2048))
#: card against CPU in float32: the loss relative; each gradient leaf's
#: max |diff| against its max |value| (the sums run in other orders
#: through 12 layers of K = 1152 and 6912); after one AdamW step a
#: gradient within that noise of zero has the sign of the noise, and
#: step 1 moves each param by lr times about +-1, so the params are held
#: within 2 lr of the CPU's everywhere and within lr / 1000 on all but a
#: share TOL_TRAIN_F32_SHARE of each leaf
TOL_TRAIN_F32_LOSS = 1e-5
TOL_TRAIN_F32_GRAD = 1e-3
TOL_TRAIN_F32_SHARE = 1e-2
#: kernels against the plain versions for one bfloat16 step (both round
#: p, the attention outputs and every gradient to bfloat16 at other
#: points, and 26 layers carry the difference on): the loss (about 12.5)
#: absolute, each gradient leaf's relative L2 difference
TOL_TRAIN_PLAIN_LOSS = 1e-2
TOL_TRAIN_PLAIN_GRAD = 5e-2
#: the backward kernel against its plain version: each of dq, dk, dv
#: within TOL_BWD times the largest |value| of the three plain gradients
#: (float32: other summation orders; bfloat16: both round p for dV and
#: the outputs to bfloat16, and a p near a rounding edge rounds apart)
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the backward kernel's edge grid: S ragged against its routes' 32- and
#: 64-row tiles, windows, GQA groups over 2 kv heads, soft cap, in both
#: dtypes
BWD_GRID_S = (37, 777, 2049)
BWD_GRID_WINDOWS = (1, 65, 513, None)  # None: S
BWD_GRID_GROUPS = (1, 4, 8)


def train_program(cfg, device):
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.runtime.train_loop import build_train_program

    return build_train_program(cfg, ParallelConfig(remat="full"),
                               TrainConfig(**TRAIN_CFG), device)


def train_batch(cfg, batch, seq, device):
    """The reference test's fixed batch: ``synthetic_batch`` seed
    TRAIN_DATA_SEED, step 0, as tensors on ``device``; an
    encoder-decoder's frames and a ``vit_stub`` model's patch embeddings
    (drawn after the tokens, in float32) cast to the params' dtype, as
    phase E draws them (the same numpy draws on the card and on the
    CPU)."""
    from repro_torch.data.pipeline import DataSpec, synthetic_batch
    from repro_torch.data.pipeline import to_device as batch_to

    fe = cfg.frontend
    kw = {} if fe is None else dict(frontend_kind=fe.kind,
                                    frontend_dim=fe.embed_dim,
                                    frontend_tokens=fe.num_tokens)
    out = batch_to(synthetic_batch(
        DataSpec(cfg.vocab_size, seq, batch, TRAIN_DATA_SEED,
                 encdec=cfg.is_encdec, **kw), 0), device)
    dtype = getattr(torch, cfg.dtype)
    return {k: v.to(dtype) if k in ("frames", "patch_embeds") else v
            for k, v in out.items()}


def step_launches(cfg, kind: str = "attn"):
    """(forward, backward) launches of the ``kind`` layers' kernel
    ("attn": the attention; "mamba": the selective scan) one training
    step makes, as the code predicts: each such layer once, again in the
    recompute of each cycle of a segment whose count exceeds 1, and one
    backward call each; the multi-token-prediction layer (of the last
    layer's kind, never recomputed) once and one backward call; an
    encoder-decoder's decoder self-attention once a layer and again in
    its recompute (every layer is checkpointed; the encoder and the
    cross-attention run no kernel)."""
    from repro_torch.models.transformer import build_segments, layer_spec

    if cfg.is_encdec:
        n = cfg.num_layers if kind == "attn" else 0
        return 2 * n, n
    fwd = bwd = 0
    for seg in build_segments(cfg):
        n = seg.count * sum(spec.kind == kind for spec in seg.cycle)
        bwd += n
        fwd += n * (2 if seg.count > 1 else 1)
    if cfg.mtp_depth > 0 and layer_spec(cfg, cfg.num_layers - 1).kind \
            == kind:
        fwd, bwd = fwd + 1, bwd + 1
    return fwd, bwd


def trees_equal(a, b) -> bool:
    from repro_torch.tree import leaves_with_paths

    la_, lb = leaves_with_paths(a), leaves_with_paths(b)
    return ([p for p, _ in la_] == [p for p, _ in lb]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(la_, lb)))


def bwd_close(got, want, dtype):
    """(within TOL_BWD, max |diff|, the scale)."""
    scale = max(w.float().abs().max().item() for w in want)
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return err <= TOL_BWD[dtype] * scale, err, scale


def bwd_case(la, q, k, v, do, window, cap, what, worst):
    """One backward call against its plain version, on the forward's
    output; one launch, none of the forward kernels."""
    o = la.grouped_local_attention_plain(q, k, v, window=window, softcap=cap)
    before = dict(la.LAUNCHES)
    got = la.local_attention_bwd(q, k, v, o, do, window=window, softcap=cap)
    launched = {key: la.LAUNCHES[key] - before[key] for key in before}
    want = la.local_attention_bwd_plain(q, k, v, o, do, window=window,
                                        softcap=cap)
    torch.cuda.synchronize()
    ok, err, scale = bwd_close(got, want, q.dtype)
    key = (q.dtype, la.bwd_route(q.dtype, q.shape[3], v.shape[3]))
    worst[key] = max(worst.get(key, 0.0), err)
    check(launched == {key: int(key == "local_attention_bwd")
                       for key in before},
          f"{what}: launches {launched}, want one of local_attention_bwd")
    check(ok, f"local_attention_bwd != plain at {what}: max |diff| {err}, "
              f"scale {scale}")


def check_bwd_grid(la):
    """The backward kernel against its plain version over the edge grid:
    every built head-dim pair in both dtypes, so the tensor-core route
    (bf16 at (64, 64) to (256, 256) and MLA's (192, 128)) and the
    CUDA-core route (float32, bf16 at (16, 16)); MLA's pair at group 1,
    its model's.  Returns the largest |diff| per (dtype, route)."""
    worst = {}
    rng = np.random.default_rng(SEED + 22)
    cases = 0
    for d, dv in la.BWD_HEAD_DIM_PAIRS:
        for s in BWD_GRID_S:
            for group in (BWD_GRID_GROUPS if d == dv else (1,)):
                base = [torch.from_numpy(rng.standard_normal(
                    shape).astype(np.float32)).cuda()
                    for shape in ((1, s, 2 * group, d), (1, s, 2, d),
                                  (1, s, 2, dv), (1, s, 2 * group, dv))]
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, do = (t.to(dtype) for t in base)
                    for window in BWD_GRID_WINDOWS:
                        for cap in (None, 50.0):
                            w = s if window is None else window
                            bwd_case(la, q, k, v, do, w, cap,
                                     f"(q/k {d}, v {dv}), S {s}, group "
                                     f"{group}, window {w}, cap {cap}, "
                                     f"{dtype}", worst)
                            cases += 1
                del base, q, k, v, do
    torch.cuda.empty_cache()
    return worst, cases


def grad_diffs(got, want):
    """Per leaf (path, max |diff|, max |want|, relative L2 difference),
    in float32."""
    from repro_torch.tree import leaves_with_paths

    out = []
    for (path, a), (_, b) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        a, b = a.float(), b.float().to(a.device)
        diff = a - b
        out.append((path, diff.abs().max().item(), b.abs().max().item(),
                    (torch.linalg.vector_norm(diff)
                     / torch.clamp_min(torch.linalg.vector_norm(b),
                                       1e-30)).item()))
    return out


#: SDPA's backends, each forced in turn at a full-causal backward call
#: to name the one the default dispatch takes
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "CUDNN_ATTENTION", "MATH")


def sdpa_bwd(q, k, v, do, window, reps, force=False):
    """Autograd through SDPA at a backward call's operands (a yardstick;
    the port never calls it), timed by CUDA events over ``reps``
    back-to-back backward passes of one forward (the band mask on a
    local call, ``is_causal`` on a full-causal one): (ms a call of the
    default dispatch, the backward node SDPA recorded, {backend: ms, or
    why it refused} when ``force``).  The profiler missed SDPA's kernels
    at full-causal calls (its readings fell under the kernel's bound),
    so the events time it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s, h = q.shape[1], q.shape[2]
    qs, ks, vs = (t.detach().repeat_interleave(h // t.shape[2], dim=2)
                  .transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    kw = {"is_causal": True}
    if window < s:
        pos = torch.arange(s, device=q.device)
        kw = {"attn_mask": (pos[None, :] <= pos[:, None])
              & (pos[None, :] > pos[:, None] - window)}

    def one():
        out = F.scaled_dot_product_attention(qs, ks, vs, **kw)
        node = type(out.grad_fn).__name__
        ms = event_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), dos, retain_graph=True), [()], reps)
        del out
        return ms, node

    default, node = one()
    forced = {}
    for name in SDPA_BACKENDS if force else ():
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                ms, fnode = one()
            forced[name] = f"{ms:.4f} ms ({fnode})"
        except (RuntimeError, torch.OutOfMemoryError) as e:
            forced[name] = "refused: " + str(e).splitlines()[0][:80]
        torch.cuda.empty_cache()
    del qs, ks, vs, dos
    return default, node, forced


def train_f32_vs_cpu(la, cfg, card):
    """The float32 run cut in depth on the card and on the CPU: loss,
    every gradient leaf and one AdamW step's params."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim.optimizer import apply_updates
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.tree import leaves_with_paths, tree_map

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg, num_layers=TRAIN_SMALL_LAYERS,
                              dtype="float32")
    tcfg = TrainConfig(**TRAIN_CFG)
    prog = train_program(cfg, "cuda")
    params, state = prog.init_fn(SEED)
    batch = train_batch(cfg, 1, TRAIN_SMALL_SEQ, "cuda")
    fwd_want, bwd_want = step_launches(cfg)
    for key in la.LAUNCHES:
        la.LAUNCHES[key] = 0
    loss, grads = value_and_grad(prog.loss_fn, params, batch)
    new_params, _, metrics = apply_updates(params, grads, state, tcfg)
    torch.cuda.synchronize()
    counts = dict(la.LAUNCHES)
    check(counts == {"local_attention": 0, "local_attention_f32": fwd_want,
                     "local_attention_bwd": bwd_want},
          f"{TRAIN_ARCH} float32 {TRAIN_SMALL_LAYERS} layers: launches "
          f"{counts}, want {fwd_want} of the float32 kernel and "
          f"{bwd_want} backward")
    card_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    cpu = train_program(cfg, "cpu")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_state = tree_map(lambda t: t.cpu(), state)
    loss_c, grads_c = value_and_grad(cpu.loss_fn, cpu_params,
                                     train_batch(cfg, 1, TRAIN_SMALL_SEQ,
                                                 "cpu"))
    new_c, _, metrics_c = apply_updates(cpu_params, grads_c, cpu_state, tcfg)
    cpu_s = time.perf_counter() - t1
    loss_err = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    check(loss_err <= TOL_TRAIN_F32_LOSS,
          f"float32 loss {loss.item()} on the card, {loss_c.item()} on the "
          f"CPU (relative {loss_err})")
    worst_grad = 0.0
    for path, err, ref, _ in grad_diffs(grads, grads_c):
        worst_grad = max(worst_grad, err / max(ref, 1e-30))
        check(err <= TOL_TRAIN_F32_GRAD * ref,
              f"float32 gradient {path}: max |diff| {err} against max "
              f"|value| {ref}")
    lr1 = metrics_c["lr"].item()
    worst_p, worst_share = 0.0, 0.0
    for (path, a), (_, b) in zip(leaves_with_paths(new_params),
                                 leaves_with_paths(new_c)):
        diff = (a.cpu() - b).abs()
        share = (diff > lr1 / 1000).float().mean().item()
        worst_p, worst_share = max(worst_p, diff.max().item()), max(
            worst_share, share)
        check(diff.max().item() <= 2 * lr1 * (1 + 1e-3)
              and share <= TOL_TRAIN_F32_SHARE,
              f"float32 AdamW step {path}: max |diff| {diff.max().item()} "
              f"(lr {lr1}), {share:.2e} of the leaf beyond lr / 1000")
    log(f"[G] {TRAIN_ARCH} float32, {TRAIN_SMALL_LAYERS} layers at full "
        f"width, batch 1, {TRAIN_SMALL_SEQ} tokens (TF32 off): loss "
        f"{loss.item():.7f} on the card, {loss_c.item():.7f} on the CPU "
        f"(relative {loss_err:.2e}); gradients within {worst_grad:.2e} of "
        f"each leaf's max |value| (tolerance {TOL_TRAIN_F32_GRAD}); one "
        f"AdamW step's params within {worst_p:.3e} (lr {lr1:.3e}), at most "
        f"{worst_share:.2e} of a leaf beyond lr / 1000; launches {counts}; "
        f"card {card_s:.1f} s, CPU {cpu_s:.1f} s")
    del prog, params, state, grads, new_params, cpu_params, grads_c, new_c
    torch.cuda.empty_cache()



def bwd_f32_full_width(la, card):
    """The float32 backward route at gemma3-1b's full-width call shapes
    (operands drawn from SEED on the card): each call within TOL_BWD of
    the plain version."""
    c = BWD_F32_FULL
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)

    def normal(heads):
        return torch.randn((c["batch"], c["seq"], heads, c["d"]),
                           generator=gen, device="cuda")

    q, do, k, v = (normal(n) for n in (c["heads"], c["heads"],
                                         c["kv_heads"], c["kv_heads"]))
    for window in c["windows"]:
        with torch.no_grad():
            o = la.grouped_local_attention(q, k, v, window=window)
        got = la.local_attention_bwd(q, k, v, o, do, window=window)
        want = la.local_attention_bwd_plain(q, k, v, o, do, window=window)
        ok, err, scale = bwd_close(got, want, torch.float32)
        check(ok, f"float32 local_attention_bwd != plain at q "
                  f"{tuple(q.shape)}, window {window}: max |diff| {err}, "
                  f"scale {scale}")
        log(f"[G] float32 local_attention_bwd at q {tuple(q.shape)}, window "
            f"{window}: within {err:.3e} of the plain version (scale "
            f"{scale:.3e}, tolerance {TOL_BWD[torch.float32]})")
        del got, want
    del q, k, v, o, do
    torch.cuda.empty_cache()


def training_phase(la, card):
    """Phase G.  Returns (the backward kernel's JSON row, the forward
    kernel's counted launches)."""
    import shutil

    from repro_torch.analysis.op_stats import storage_bytes
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.runtime.fault import StepGuard, StragglerMonitor
    from repro_torch.runtime.train_loop import value_and_grad

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    prog = train_program(cfg, "cuda")
    params, state = prog.init_fn(SEED)
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    fwd_want, bwd_want = step_launches(cfg)
    want = {"local_attention": fwd_want, "local_attention_f32": 0,
            "local_attention_bwd": bwd_want}
    log(f"[G] {TRAIN_ARCH}: {depth(cfg)} layers at full width, "
        f"{n_params(params)} parameters (bfloat16, stacked per segment), "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}; set up in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # one step's gradients with the kernels (every backward call recorded
    # and held against the plain version), then with the plain versions
    t0 = time.perf_counter()
    calls = []
    kernel_bwd = la.local_attention_bwd

    def recording_bwd(q, k, v, o, do, *, window, softcap=None):
        calls.append((q, k, v, o, do, window, softcap))
        return kernel_bwd(q, k, v, o, do, window=window, softcap=softcap)

    with Swapped((la, "local_attention_bwd", recording_bwd)):
        loss_k, grads_k = value_and_grad(prog.loss_fn, params, batch)
    torch.cuda.synchronize()
    check(len(calls) == bwd_want,
          f"{len(calls)} backward calls in one step, want {bwd_want}")
    worst = 0.0
    for i, (q, k, v, o, do, window, cap) in enumerate(calls):
        got = kernel_bwd(q, k, v, o, do, window=window, softcap=cap)
        ref = la.local_attention_bwd_plain(q, k, v, o, do, window=window,
                                           softcap=cap)
        ok, err, scale = bwd_close(got, ref, q.dtype)
        worst = max(worst, err)
        check(ok, f"local_attention_bwd != plain at main-path call {i}, q "
                  f"{tuple(q.shape)} window {window}: max |diff| {err}, "
                  f"scale {scale}")
    del calls, got, ref
    q_save_grads(grads_k)  # phase Q's yardstick
    with Swapped((la, "grouped_local_attention",
                  la.grouped_local_attention_plain)):
        loss_p, grads_p = value_and_grad(prog.loss_fn, params, batch)
    diffs = grad_diffs(grads_k, grads_p)
    del grads_k, grads_p
    loss_err = abs(loss_k.item() - loss_p.item())
    worst_rel = max(d[3] for d in diffs)
    worst_path = max(diffs, key=lambda d: d[3])[0]
    check(loss_err <= TOL_TRAIN_PLAIN_LOSS,
          f"bf16 loss {loss_k.item()} with the kernels, {loss_p.item()} "
          f"with the plain versions")
    for path, err, refmax, rel in diffs:
        check(rel <= TOL_TRAIN_PLAIN_GRAD,
              f"bf16 gradient {path} with the kernels vs the plain "
              f"versions: relative L2 {rel}, max |diff| {err} (max |value| "
              f"{refmax})")
    log(f"[G] bf16 step, kernels vs plain versions swapped in: loss "
        f"{loss_k.item():.6f} / {loss_p.item():.6f} (|diff| {loss_err:.2e},"
        f" tolerance {TOL_TRAIN_PLAIN_LOSS}); gradients' relative L2 "
        f"difference at most {worst_rel:.3e} ({worst_path}; tolerance "
        f"{TOL_TRAIN_PLAIN_GRAD}), max |diff| / max |value| at most "
        f"{max(d[1] / max(d[2], 1e-30) for d in diffs):.3e}; the "
        f"{bwd_want} backward calls within {worst:.3e} of the plain "
        f"version; {time.perf_counter() - t0:.1f} s")

    # the counted run: 8 steps on the fixed batch, a checkpoint at step 4
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" \
        / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), keep=1)

    def lost(step):
        fail(f"phase G: a training step failed and was retried at {step}")

    guard, monitor = StepGuard(recover=lost, max_retries=0), \
        StragglerMonitor()
    losses, step_ms, fwd_launches, bwd_launches = [], [], 0, 0
    first = (params, state)
    save_s = None
    for step in range(TRAIN_STEPS):
        if step == 1:  # the first step warms the card and is not timed
            torch.cuda.reset_peak_memory_stats()
            # phase X: what else the process holds, beside the step's
            # params, state and batch
            other = torch.cuda.memory_allocated() - storage_bytes(
                (params, state, batch))
        for key in la.LAUNCHES:
            la.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = guard.run(prog.step_fn, step, params, state,
                                           batch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(la.LAUNCHES)
        check(counts == want, f"step {step + 1}: launches {counts}, want "
                              f"{want}")
        fwd_launches += counts["local_attention"]
        bwd_launches += counts["local_attention_bwd"]
        losses.append(metrics["loss"].item())
        monitor.observe(step, step_ms[-1] / 1e3)
        if step == 0:  # the same step again from the same state
            again = prog.step_fn(*first, batch)
            check(trees_equal(again[0], params) and trees_equal(
                again[1], state) and again[2]["loss"].item() == losses[0],
                  "two steps from the same state differ")
            del again, first
        if step + 1 == TRAIN_CKPT_STEP:
            t0 = time.perf_counter()
            mgr.save(step + 1, {"params": params, "opt_state": state})
            save_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    mgr.wait()
    write_s = time.perf_counter() - t0
    check(losses[-1] < losses[0] - TRAIN_LOSS_DROP,
          f"loss fell from {losses[0]} to {losses[-1]} over {TRAIN_STEPS} "
          f"steps, want a fall of {TRAIN_LOSS_DROP}")
    med = float(np.median(step_ms[1:]))
    log(f"[G] {TRAIN_STEPS} AdamW steps: losses "
        f"{[round(x, 4) for x in losses]}; step ms {[round(x, 1) for x in step_ms]}"
        f" (median of steps 2 to {TRAIN_STEPS}: {med:.1f} ms, "
        f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s); peak device "
        f"memory {peak / 1e9:.2f} GB; launches a step {want}; straggler "
        f"flags {monitor.flagged_steps}; two steps from one state "
        f"bit-equal; on {card}")

    # resume from the step-4 checkpoint: steps 5 to 8 again, bit-equal
    t0 = time.perf_counter()
    restored, at = mgr.restore({"params": params, "opt_state": state})
    restore_s = time.perf_counter() - t0
    rp, rs = restored["params"], restored["opt_state"]
    del restored
    resumed = []
    for step in range(at, TRAIN_STEPS):
        rp, rs, metrics = prog.step_fn(rp, rs, batch)
        resumed.append(metrics["loss"].item())
    check(at == TRAIN_CKPT_STEP and resumed == losses[TRAIN_CKPT_STEP:]
          and trees_equal(rp, params) and trees_equal(rs, state),
          f"resumed from step {at}: losses {resumed}, uninterrupted "
          f"{losses[TRAIN_CKPT_STEP:]}; params and state equal "
          f"{trees_equal(rp, params)} / {trees_equal(rs, state)}")
    disk = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[G] checkpoint at step {TRAIN_CKPT_STEP}: {disk / 1e9:.2f} GB on "
        f"disk, host snapshot {save_s:.1f} s, write {write_s:.1f} s more, "
        f"restore {restore_s:.1f} s; steps {at + 1} to {TRAIN_STEPS} after "
        f"the restore bit-equal to the uninterrupted run")
    del rp, rs

    del params, state, metrics, batch, prog
    torch.cuda.empty_cache()
    grid_worst, cases = check_bwd_grid(la)
    log(f"[G] local_attention_bwd vs plain over {cases} edge cases: max "
        f"|diff| " + ", ".join(f"{str(dt).split('.')[-1]} on {route} "
                               f"{err:.3e}" for (dt, route), err
                               in sorted(grid_worst.items(), key=str)))
    train_f32_vs_cpu(la, cfg, card)
    bwd_f32_full_width(la, card)
    log(f"[G] phase G: {time.perf_counter() - t_phase:.1f} s on {card}")
    g_ref = {"loss": loss_k.item(), "losses": losses,
             "peak_program": peak - other, "launches": want}
    # the row's times are phase I's, at deepseek's (192, 128) call
    return {"name": "local_attention_bwd", "route": "cuda",
            "source": BWD_SOURCE, "replaces": BWD_REPLACES,
            "launches": bwd_launches,
            "max_abs_err": max(worst, *grid_worst.values())}, \
        fwd_launches, g_ref


# ---------------------------------------------------------------------------
# Phase H: the MoE, Mamba and hybrid families trained
# ---------------------------------------------------------------------------

SCAN_BWD_SOURCE = "src/repro_torch/csrc/selective_scan_bwd.cu"
#: no TPU kernel computes the scan's gradient: the reference takes it by
#: autodiff of its associative scan, at this line
SCAN_BWD_REPLACES = "src/repro/models/ssm.py:107"
#: the scan backward's kernels as the profiler names them: the walk and
#: the cross-block sums, both launched by one call
SCAN_BWD_KERNELS = ("scan_bwd_kernel", "scan_bwd_sums")
#: phase H's bfloat16 runs at the published widths: granite-moe-3b-a800m
#: at its full 32 layers (3.30 G parameters: 40 GB of params, gradients
#: and AdamW moments at 12 bytes a parameter), falcon-mamba-7b cut in
#: depth (None: uncut).  Its 64 layers are 7.27 G parameters, 87 GB of
#: training state.  40 layers (4.85 G, 58 GB) are the deepest cut whose
#: step stays under about 70 GB; 32 layers (3.9 G, 47 GB) run here.  The
#: bf16 step's gradients are not determined much below the plain-version
#: gate's 5e-2 at either depth: two plain versions that differ only in
#: y's last float32 bits disagree by about 5e-2 (``h_train`` logs that
#: floor beside the gate).  At 40 layers both that floor and the kernels'
#: distance from the plain versions exceeded 5e-2 in a probe; at 32 the
#: kernels stay under it.  The per-call checks and the float32 cut
#: against the CPU are what hold the kernels to the plain versions
#: there.  Both steps donate their params and optimizer state, so one
#: copy of the state lives on the card.
H_LAYERS = {"granite-moe-3b-a800m": None, "falcon-mamba-7b": 32}
#: phase H's learning rate where it is not TRAIN_CFG's: falcon-mamba's
#: random 40-layer stack diverged at 3e-3 in a probe and fell at 1e-3
#: and 5e-4, most steadily at 5e-4
H_LR = {"falcon-mamba-7b": 5e-4}
#: the float32 cuts held against the CPU: 4 layers at the published
#: widths (batch 1 x TRAIN_SMALL_SEQ; falcon-mamba 2, paying for phase
#: P's time: at 4 its CPU step took 39.5 s), jamba at its reduced config (one
#: 8-layer cycle at d_model 64: a full-width cycle is 13.3 G parameters,
#: 160 GB of training state; any cut that keeps its attention layer at 4
#: keeps two 2.8 G-parameter MoE layers)
H_SMALL_LAYERS = {"granite-moe-3b-a800m": 4, "falcon-mamba-7b": 2,
                  "jamba-v0.1-52b": None}
#: the scan backward against its plain version at each call of a step:
#: each of the seven gradients (ddt, dx, dB, dC, dA, dD, dh0) within
#: TOL_SCAN_BWD times its largest |plain value|.  Stated before the
#: first run on the card: both recompute the states with the forward's
#: bits (the same roundings, -fmad=false); the adjoint, a recurrence whose
#: decay is below 1, and the sums (16 states; dB and dC over 8192
#: channels, the kernel's in blocks of 64; dA and dD over 8192 (b, t)
#: terms) run in other orders, the kernel's with fused multiply-adds, so
#: each result differs by a few float32 roundings of terms no larger than
#: the scale (6e-8 each), far inside 1e-5.
TOL_SCAN_BWD = 1e-5


def h_counts(cfg, dtype):
    """The launches of every kernel one training step of ``cfg`` makes in
    ``dtype``, as ``step_launches`` predicts them."""
    afwd, abwd = step_launches(cfg, "attn")
    sfwd, sbwd = step_launches(cfg, "mamba")
    bf16 = dtype == torch.bfloat16
    return {"local_attention": afwd if bf16 else 0,
            "local_attention_f32": 0 if bf16 else afwd,
            "local_attention_bwd": abwd, "selective_scan": sfwd,
            "selective_scan_bwd": sbwd}


def scan_bwd_err(got, want):
    """The largest of the seven gradients' max |diff| / max |plain|."""
    return max((g - w).abs().max().item()
               / max(w.abs().max().item(), 1e-30)
               for g, w in zip(got, want))


class Checked:
    """Wrappers of the backward kernels that hold each call against its
    plain version on the same inputs (scan: TOL_SCAN_BWD; attention:
    TOL_BWD, against ``attn_plain``, ``local_attention_bwd_plain`` by
    default), keep the largest errors (attention: relative and absolute)
    and the first call's operands."""

    def __init__(self, la, ss, attn_plain=None):
        self.la, self.ss = la, ss
        self.scan_worst = self.attn_worst = self.scan_abs = 0.0
        self.attn_abs = 0.0
        self.scan_calls = self.attn_calls = 0
        self.scan_first = self.attn_first = None
        kernel_scan = ss.selective_scan_bwd
        kernel_attn = la.local_attention_bwd
        attn_plain = attn_plain or la.local_attention_bwd_plain

        def scan(dt, x, b, c, a, d, dy, dh_last=None, h0=None):
            got = kernel_scan(dt, x, b, c, a, d, dy, dh_last, h0)
            want = ss.selective_scan_bwd_plain(dt, x, b, c, a, d, dy,
                                               dh_last, h0)
            err = scan_bwd_err(got, want)
            self.scan_worst = max(self.scan_worst, err)
            self.scan_abs = max(self.scan_abs, max(
                (g - w).abs().max().item() for g, w in zip(got, want)))
            self.scan_calls += 1
            check(err <= TOL_SCAN_BWD,
                  f"selective_scan_bwd != plain at main-path call "
                  f"{self.scan_calls}, dt {tuple(dt.shape)}: {err} of the "
                  f"largest |value|")
            if self.scan_first is None:
                self.scan_first = (dt, x, b, c, a, d, dy, dh_last, h0)
            return got

        def attn(q, k, v, o, do, *, window, softcap=None):
            got = kernel_attn(q, k, v, o, do, window=window, softcap=softcap)
            want = attn_plain(q, k, v, o, do, window=window,
                              softcap=softcap)
            ok, err, scale = bwd_close(got, want, q.dtype)
            del want
            self.attn_worst = max(self.attn_worst, err / scale)
            self.attn_abs = max(self.attn_abs, err)
            self.attn_calls += 1
            if self.attn_first is None:
                self.attn_first = (q, k, v, o, do, window, softcap)
            check(ok, f"local_attention_bwd != plain at main-path call "
                      f"{self.attn_calls}, q {tuple(q.shape)} window "
                      f"{window}: max |diff| {err}, scale {scale}")
            return got

        self.swaps = Swapped((ss, "selective_scan_bwd", scan),
                             (la, "local_attention_bwd", attn))

    def __enter__(self):
        self.swaps.__enter__()
        return self

    def __exit__(self, *exc):
        self.swaps.__exit__(*exc)


def plain_scan_f64_y(ss):
    """The scan's plain version with y summed over the states in float64
    and rounded once: an equally valid plain version, whose gradients
    against ``selective_scan_plain``'s measure how far the bf16 step
    carries a last-bit difference in y (the gate's noise floor)."""
    def scan(dt, x, b, c, a, d, h0=None):
        bsz, s, dl = dt.shape
        h = (torch.zeros((bsz, dl, a.shape[1]), dtype=torch.float32,
                         device=dt.device) if h0 is None else h0.clone())
        y = torch.empty_like(x)
        for t0 in range(0, s, ss.PLAIN_CHUNK):
            t1 = min(s, t0 + ss.PLAIN_CHUNK)
            dtc = dt[:, t0:t1, :, None]
            decay = torch.exp(dtc * a)
            drive = (dtc * b[:, t0:t1, None, :]) * x[:, t0:t1, :, None]
            hs = torch.empty_like(decay)
            for t in range(t1 - t0):
                torch.mul(decay[:, t], h, out=hs[:, t])
                hs[:, t] += drive[:, t]
                h = hs[:, t]
            y[:, t0:t1] = ((hs.double() * c[:, t0:t1, None, :].double())
                           .sum(-1) + (d * x[:, t0:t1]).double()).float()
        return y, h.clone()

    return scan


def plain_training(la, ss):
    """Every kernel's plain version swapped in for a training step: the
    attention's (autograd differentiates it) and the scan's forward and
    backward."""
    return Swapped((la, "grouped_local_attention",
                    la.grouped_local_attention_plain),
                   (ss, "_scan", ss.selective_scan_plain),
                   (ss, "selective_scan_bwd", ss.selective_scan_bwd_plain))


def route_recorder(tables):
    """The MoE router, recording each call's slot table into ``tables``."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.route

    def route(p, xt, cfg, plan):
        out = real(p, xt, cfg, plan)
        tables.append(out[1].cpu())
        return out

    return Swapped((moe_mod, "route", route))


def h_f32_vs_cpu(la, ss, cfg, what, card, tag="H"):
    """A float32 training step cut in depth (or reduced) on the card and
    on the CPU: the launches, the MoE slot tables (a routing flip shows
    as a flip), the loss, every gradient leaf and one AdamW step's
    params, with phase G's float32 tolerances."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim.optimizer import apply_updates
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.tree import leaves_with_paths, tree_map

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg, dtype="float32")
    tcfg = TrainConfig(**TRAIN_CFG)
    prog = train_program(cfg, "cuda")
    params, state = prog.init_fn(SEED)
    want = h_counts(cfg, torch.float32)
    tables = []
    reset_lm_counts(la, ss)
    with route_recorder(tables):
        loss, grads = value_and_grad(prog.loss_fn, params,
                                     train_batch(cfg, 1, TRAIN_SMALL_SEQ,
                                                 "cuda"))
    new_params, _, _ = apply_updates(params, grads, state, tcfg)
    torch.cuda.synchronize()
    counts = all_launches(la, ss)
    check(counts == want, f"[{tag}] {what} float32: launches {counts}, want "
                          f"{want}")
    card_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    cpu = train_program(cfg, "cpu")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_state = tree_map(lambda t: t.cpu(), state)
    cpu_tables = []
    with route_recorder(cpu_tables):
        loss_c, grads_c = value_and_grad(
            cpu.loss_fn, cpu_params,
            train_batch(cfg, 1, TRAIN_SMALL_SEQ, "cpu"))
    new_c, _, metrics_c = apply_updates(cpu_params, grads_c, cpu_state, tcfg)
    cpu_s = time.perf_counter() - t1
    flips = sum(int((a != b).sum()) for a, b in zip(tables, cpu_tables))
    check(len(tables) == len(cpu_tables) and flips == 0,
          f"[{tag}] {what} float32: {flips} (token, k) slots routed otherwise "
          f"on the card than on the CPU over {len(tables)} router calls")
    loss_err = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    check(loss_err <= TOL_TRAIN_F32_LOSS,
          f"[{tag}] {what} float32 loss {loss.item()} on the card, "
          f"{loss_c.item()} on the CPU (relative {loss_err})")
    worst_grad = 0.0
    for path, err, ref, _ in grad_diffs(grads, grads_c):
        worst_grad = max(worst_grad, err / max(ref, 1e-30))
        check(err <= TOL_TRAIN_F32_GRAD * ref,
              f"[{tag}] {what} float32 gradient {path}: max |diff| {err} "
              f"against max |value| {ref}")
    lr1 = metrics_c["lr"].item()
    worst_p, worst_share = 0.0, 0.0
    for (path, a), (_, b) in zip(leaves_with_paths(new_params),
                                 leaves_with_paths(new_c)):
        diff = (a.cpu() - b).abs()
        share = (diff > lr1 / 1000).float().mean().item()
        worst_p = max(worst_p, diff.max().item())
        worst_share = max(worst_share, share)
        check(diff.max().item() <= 2 * lr1 * (1 + 1e-3)
              and share <= TOL_TRAIN_F32_SHARE,
              f"[{tag}] {what} float32 AdamW step {path}: max |diff| "
              f"{diff.max().item()} (lr {lr1}), {share:.2e} of the leaf "
              f"beyond lr / 1000")
    log(f"[{tag}] {what} float32 ({depth(cfg)} layers, d_model {cfg.d_model}, "
        f"batch 1 x {TRAIN_SMALL_SEQ}, TF32 off): loss {loss.item():.7f} on "
        f"the card, {loss_c.item():.7f} on the CPU (relative "
        f"{loss_err:.2e}); gradients within {worst_grad:.2e} of each leaf's "
        f"max |value| (tolerance {TOL_TRAIN_F32_GRAD}); one AdamW step's "
        f"params within {worst_p:.3e} (lr {lr1:.3e}), at most "
        f"{worst_share:.2e} of a leaf beyond lr / 1000; {len(tables)} router "
        f"calls with equal slot tables; launches {counts}; card "
        f"{card_s:.1f} s, CPU {cpu_s:.1f} s on {card}")
    del prog, params, state, grads, new_params, cpu_params, grads_c, new_c
    torch.cuda.empty_cache()


def fingerprint(tree):
    """Per leaf of a tree of tensors, the sum of its raw bits (as
    integers) weighted by odd 64-bit numbers drawn from each element's
    index, modulo 2^64: a difference in any one element always changes
    it (an odd weight times a nonzero difference below 2^32 is nonzero
    modulo 2^64), several differences collide with probability about
    2^-64.  Read in slices of 2^26 elements."""
    from repro_torch.tree import leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for leaf in leaves(tree):
        bits = leaf.detach().reshape(-1).view(ints[leaf.element_size()])
        total = torch.zeros((), dtype=torch.int64, device=leaf.device)
        for i in range(0, bits.numel(), 1 << 26):
            part = bits[i:i + (1 << 26)].to(torch.int64)
            idx = torch.arange(i, i + part.numel(), dtype=torch.int64,
                               device=leaf.device)
            weight = (idx * -7046029254386353131 + 1442695040888963407) | 1
            total += torch.sum(part * weight)
        out.append(int(total))
    return out


def h_train(la, ss, arch, card):
    """Phase H, one model trained in bfloat16 at full width (granite at
    full depth).  Returns its counted launches by kernel, the scan
    backward's row numbers (or None without Mamba layers) and the
    largest errors of the backward kernels against their plain
    versions."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.optim.optimizer import init_opt_state
    from repro_torch.runtime.fault import StepGuard, StragglerMonitor
    from repro_torch.runtime.train_loop import (
        build_train_program,
        value_and_grad,
    )

    t_model = time.perf_counter()
    cfg = get_config(arch)
    if H_LAYERS[arch] is not None:
        cfg = dataclasses.replace(cfg, num_layers=H_LAYERS[arch])
    tcfg = TrainConfig(**{**TRAIN_CFG, "lr": H_LR.get(arch,
                                                     TRAIN_CFG["lr"])})
    prog = build_train_program(cfg, ParallelConfig(remat="full"), tcfg,
                               "cuda", donate=True)
    params, state = prog.init_fn(SEED)
    del state  # the gradient checks run without the moments
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    want = h_counts(cfg, torch.bfloat16)
    log(f"[H] {arch}: {depth(cfg)} layers at full width (d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}), {n_params(params)} "
        f"parameters (bfloat16, stacked per segment), batch {TRAIN_BATCH} "
        f"x {TRAIN_SEQ}, AdamW at lr {tcfg.lr}, remat full, donated steps; "
        f"launches a step "
        f"{want}; set up in {time.perf_counter() - t_model:.1f} s")

    # one step's gradients with the kernels, every backward call held
    # against its plain version; again, bit-equal; then with the plain
    # versions swapped in
    t0 = time.perf_counter()
    with Checked(la, ss) as chk:
        loss_k, grads_k = value_and_grad(prog.loss_fn, params, batch)
    torch.cuda.synchronize()
    check(chk.scan_calls == want["selective_scan_bwd"]
          and chk.attn_calls == want["local_attention_bwd"],
          f"[H] {arch}: {chk.scan_calls} scan and {chk.attn_calls} "
          f"attention backward calls in one step, want {want}")
    loss_a, grads_a = value_and_grad(prog.loss_fn, params, batch)
    check(loss_a.item() == loss_k.item() and trees_equal(grads_a, grads_k),
          f"[H] {arch}: two gradients of one step differ")
    del grads_a
    with plain_training(la, ss):
        loss_p, grads_p = value_and_grad(prog.loss_fn, params, batch)
    diffs = grad_diffs(grads_k, grads_p)
    del grads_k
    floor = ""
    if cfg.num_mamba_layers and "--plain-curve" in sys.argv[1:]:
        with plain_training(la, ss), Swapped((ss, "_scan",
                                              plain_scan_f64_y(ss))):
            _, grads_f = value_and_grad(prog.loss_fn, params, batch)
        floor = (f"; the plain versions against the plain scan with y "
                 f"summed in float64 (the noise floor): relative L2 at most "
                 f"{max(d[3] for d in grad_diffs(grads_f, grads_p)):.3e}")
        del grads_f
    del grads_p
    loss_err = abs(loss_k.item() - loss_p.item())
    worst_rel = max(d[3] for d in diffs)
    worst_path = max(diffs, key=lambda d: d[3])[0]
    check(loss_err <= TOL_TRAIN_PLAIN_LOSS,
          f"[H] {arch} bf16 loss {loss_k.item()} with the kernels, "
          f"{loss_p.item()} with the plain versions")
    for path, err, refmax, rel in diffs:
        check(rel <= TOL_TRAIN_PLAIN_GRAD,
              f"[H] {arch} bf16 gradient {path} with the kernels vs the "
              f"plain versions: relative L2 {rel}, max |diff| {err} (max "
              f"|value| {refmax})")
    log(f"[H] {arch} bf16 step, kernels vs plain versions swapped in: loss "
        f"{loss_k.item():.6f} / {loss_p.item():.6f} (|diff| {loss_err:.2e}, "
        f"tolerance {TOL_TRAIN_PLAIN_LOSS}); gradients' relative L2 "
        f"difference at most {worst_rel:.3e} ({worst_path}; tolerance "
        f"{TOL_TRAIN_PLAIN_GRAD}){floor}; the {chk.scan_calls} scan "
        f"backward calls "
        f"within {chk.scan_worst:.3e} of the largest |plain value| "
        f"(tolerance {TOL_SCAN_BWD}), the {chk.attn_calls} attention "
        f"backward calls within {chk.attn_worst:.3e} of the scale "
        f"(tolerance {TOL_BWD[torch.bfloat16]}); two gradients of the step "
        f"bit-equal; {time.perf_counter() - t0:.1f} s")
    scan_call = chk.scan_first
    worst = {"selective_scan_bwd": chk.scan_abs}
    del chk

    # the counted run: 8 donated steps on the fixed batch; the state after
    # the first kept on the host for the repeat
    state = init_opt_state(params, tcfg)
    guard, monitor = StepGuard(
        recover=lambda step: fail(f"phase H: a step failed and was retried "
                                  f"at {step}"), max_retries=0), \
        StragglerMonitor()
    losses, step_ms, launches = [], [], dict.fromkeys(want, 0)
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_lm_counts(la, ss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = guard.run(prog.step_fn, step, params, state,
                                           batch)
        losses.append(metrics["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = all_launches(la, ss)
        check(counts == want, f"[H] {arch} step {step + 1}: launches "
                              f"{counts}, want {want}")
        for key, v in counts.items():
            launches[key] += v
        monitor.observe(step, step_ms[-1] / 1e3)
        if step == 0:
            t1 = time.perf_counter()
            first = fingerprint((params, state.m, state.v))
            print_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    check(losses[-1] < losses[0] - TRAIN_LOSS_DROP
          and all(np.isfinite(losses)),
          f"[H] {arch}: loss fell from {losses[0]} to {losses[-1]} over "
          f"{TRAIN_STEPS} steps, want a fall of {TRAIN_LOSS_DROP}")
    med = float(np.median(step_ms[1:]))
    log(f"[H] {arch} {TRAIN_STEPS} AdamW steps: losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]} (median of steps 2 to "
        f"{TRAIN_STEPS}: {med:.1f} ms, "
        f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s); peak device "
        f"memory {peak / 1e9:.2f} GB; straggler "
        f"flags {monitor.flagged_steps}; on {card}")

    # the first step again from the same initial state: bit-equal
    del params, state, metrics
    torch.cuda.empty_cache()
    params, state = prog.init_fn(SEED)
    again = prog.step_fn(params, state, batch)
    same = fingerprint((again[0], again[1].m, again[1].v)) == first
    check(again[2]["loss"].item() == losses[0] and same,
          f"[H] {arch}: the first step repeated from the same state differs "
          f"(loss {again[2]['loss'].item()} / {losses[0]}, fingerprints "
          f"equal {same})")
    log(f"[H] {arch}: the first step repeated from a new init of the same "
        f"seed: the same loss, and the same fingerprint of every leaf of "
        f"its params and moments ({len(first)} leaves, {print_s:.2f} s a "
        f"fingerprint)")
    del params, state, again, first
    torch.cuda.empty_cache()
    if cfg.num_mamba_layers and "--plain-curve" in sys.argv[1:]:
        plain_curve(la, ss, prog, batch, arch, losses, loss_err, card)
    del batch, prog
    torch.cuda.empty_cache()

    row = None
    if scan_call is not None:
        per_step = want["selective_scan_bwd"]
        dt, x, b, c, a, d, dy, dh_last, h0 = scan_call
        ops, nbytes = scan_bwd_work(dt, b, h0)
        t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
        each = device_ms(lambda: ss.selective_scan_bwd(*scan_call), [()], 5,
                         kernel=SCAN_BWD_KERNELS, split=True)
        ms = sum(each.values())
        plain = device_ms(lambda: ss.selective_scan_bwd_plain(*scan_call),
                          [()], 1)
        bound = max(t_ops, t_bytes) * 1e3
        row = dict(ms=per_step * ms, plain_ms=per_step * plain,
                   bound_ms=per_step * bound,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   per_call=ms, calls=per_step)
        log(f"[time] selective_scan_bwd at {arch}'s call (dt "
            f"{tuple(dt.shape)}, d_state {b.shape[2]}): {ms:.4f} ms a call ("
            + ", ".join(f"{k} {v:.4f}" for k, v in each.items())
            + f"), {per_step * ms:.4f} ms for the {per_step} calls of a "
            f"step; bound {bound:.4f} ms a call ({row['bound_by']}; "
            f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e9:.3f} GB), "
            f"{100 * bound / ms:.1f}% of it; plain {plain:.4f} ms a call; "
            f"no library call computes the scan; "
            + scan_bwd_geometry(ss, dt.shape, b.shape[2]) + f"; on {card}")
        del scan_call, dt, x, b, c, a, d, dy
        torch.cuda.empty_cache()
    log(f"[H] {arch}: {time.perf_counter() - t_model:.1f} s on {card}")
    return launches, row, worst


def scan_bwd_geometry(ss, shape, n) -> str:
    """The scan backward's launch at a call of ``shape`` (B, S, d_inner)
    as the card reports it: registers a thread of each kernel (spills),
    resident blocks an SM of the walk, its blocks and waves; beside the
    design's register budget and blocks an SM (``bwd_geometry``)."""
    occ = ss.bwd_occupancy(n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = ss.bwd_geometry(shape[0], shape[2], n, sms=sms)
    waves = geo["blocks"] / (occ["per_sm"] * sms)
    return (f"walk {occ['regs']} registers a thread (the design's budget "
            f"{geo['regs']}; {occ['spill_bytes']} bytes of spills), "
            f"{occ['threads']} threads and {occ['smem']} bytes of shared "
            f"memory a block, {occ['per_sm']} blocks an SM (the design's "
            f"{geo['per_sm']}), {geo['blocks']} blocks on {sms} SMs: "
            f"{waves:.4f} waves; sums {occ['sums_regs']} registers a "
            f"thread, {occ['sums_threads']} threads a block")


def plain_curve(la, ss, prog, batch, arch, losses, first_diff, card):
    """ROADMAP's fault F2 (``--plain-curve``): the counted steps again
    from a new init of the same seed with every kernel's plain version
    swapped in.  Logs both loss curves side by side and whether they part
    by more than the first step's kernel-vs-plain loss difference; gates
    nothing."""
    t0 = time.perf_counter()
    params, state = prog.init_fn(SEED)
    plain = []
    with plain_training(la, ss):
        for step in range(TRAIN_STEPS):
            params, state, metrics = prog.step_fn(params, state, batch)
            plain.append(metrics["loss"].item())
    del params, state, metrics
    torch.cuda.empty_cache()
    part = max(abs(k - p) for k, p in zip(losses, plain))
    log(f"[H] {arch} F2, {TRAIN_STEPS} steps from the same init, losses "
        f"with the kernels / with the plain versions: "
        + "; ".join(f"{k:.4f} / {p:.4f}" for k, p in zip(losses, plain))
        + f"; they part by at most {part:.4e} against the first step's "
        f"kernel-vs-plain loss difference {first_diff:.4e}: "
        + ("they part" if part > first_diff else "they agree")
        + f"; plain steps {time.perf_counter() - t0:.1f} s on {card}")


#: the scan backward's edge grid: S below, at and past its 4-step runs,
#: two runs, and the plain version's 128-step chunks, d_inner a multiple
#: of the 64-channel blocks, not one, and not a multiple of 4 (4-byte
#: copies), with and without h0 and dh_last
EDGE_SCAN_BWD_S = (1, 3, 4, 5, 9, 15, 16, 17, 2049)
EDGE_SCAN_BWD_D = (256, 130, 5)


def check_scan_bwd_grid(ss):
    """The scan backward against its plain version over the edge grid;
    one launch a call.  Returns the largest |diff|."""
    rng = np.random.default_rng(SEED + 25)
    worst, n_checks = 0.0, 0
    for n in EDGE_SCAN_N:
        for s in EDGE_SCAN_BWD_S:
            for dl in EDGE_SCAN_BWD_D:
                dt = np.log1p(np.exp(rng.standard_normal((2, s, dl)) - 2.0))
                a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (dl, 1))
                base = [dt, rng.standard_normal((2, s, dl)),
                        rng.standard_normal((2, s, n)),
                        rng.standard_normal((2, s, n)), a,
                        rng.standard_normal(dl),
                        rng.standard_normal((2, s, dl)),
                        rng.standard_normal((2, dl, n)),
                        rng.standard_normal((2, dl, n))]
                ops = [torch.from_numpy(v.astype(np.float32)).cuda()
                       for v in base]
                for extra in ((None, None), (ops[7], ops[8])):
                    before = ss.LAUNCHES["selective_scan_bwd"]
                    got = ss.selective_scan_bwd(*ops[:7], *extra)
                    launched = ss.LAUNCHES["selective_scan_bwd"] - before
                    want = ss.selective_scan_bwd_plain(*ops[:7], *extra)
                    torch.cuda.synchronize()
                    err = scan_bwd_err(got, want)
                    worst = max(worst, max((g - w).abs().max().item()
                                           for g, w in zip(got, want)))
                    what = (f"S {s} d_inner {dl} d_state {n} h0 and dh_last "
                            f"{extra[0] is not None}")
                    check(launched == 1, f"selective_scan_bwd at {what}: "
                                         f"{launched} launches")
                    check(err <= TOL_SCAN_BWD,
                          f"selective_scan_bwd != plain at {what}: {err} of "
                          f"the largest |value|")
                    n_checks += 1
    log(f"[scan] backward: {n_checks} edge comparisons (each gradient "
        f"within {TOL_SCAN_BWD} of its largest |value|): max |diff| "
        f"{worst:.3e}")
    return worst


def check_scan_bwd_sass(ss, lib) -> None:
    """The scan backward's kernels hold no global atomic (RED, ATOM,
    ATOMG): dB, dC, dA and dD are summed across blocks in a fixed order.
    Each walk kernel's MUFU.EX2 (one a precise expf) are its two forward
    walks' (the stored states, the recompute: ``BWD_RUN_STEPS`` steps of
    a lane's pairs each), none in the walk back, which reads the
    recompute's decays."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        log("[build] cuobjdump not found: SASS not checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = sass.split("Function : ")[1:]
    ops = ("RED.", "ATOM.", "ATOMG")
    counts = {op: sum(f.count(op) for f in funcs) for op in ops}
    want_ex2 = 2 * ss.BWD_RUN_STEPS * ss.BWD_LANE_CHANNELS \
        * ss.BWD_LANE_STATES
    ex2 = {re.search(r"scan_bwd_kernelILi(\d+)", f.splitlines()[0]).group(1):
           f.count("MUFU.EX2") for f in funcs
           if "scan_bwd_kernel" in f.splitlines()[0]}
    log(f"[build] {lib.name} SASS of the {len(funcs)} scan backward "
        f"kernels: {counts}; MUFU.EX2 of the walk by d_state {ex2}, the "
        f"design's {want_ex2} (two forward walks of a run, none in the walk "
        f"back)")
    if len(funcs) != 3 or sum(counts.values()):
        fail(f"the scan backward's SASS {counts} in {len(funcs)} kernels: "
             f"want 3 kernels (the walk at d_state 4 and 16, the sums), no "
             f"global atomics")
    if any(v > want_ex2 for v in ex2.values()):
        fail(f"the scan backward's walk runs {ex2} MUFU.EX2, more than its "
             f"two forward walks' {want_ex2}: an expf in the walk back")


#: fault F2: falcon-mamba's reduced config in float32 for
#: F2_STEPS steps of phase H's recipe (AdamW, lr 5e-4, warmup 2, one fixed
#: batch), on the card with the kernels and on the CPU with the plain
#: versions; TOL_F2 (stated before the first run) on each step's loss,
#: relative.  Logged: it settles a fault, and gates nothing of phase H
F2_STEPS, F2_BATCH, F2_SEQ = 8, 4, 512
TOL_F2 = 1e-4


def f2_curve(card):
    """F2's float32 curves: each step's loss on the card (kernels) and on
    the CPU (plain versions) from the card's init, and the verdict."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.runtime.train_loop import build_train_program
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SCAN_ARCH).reduced(),
                              dtype="float32")
    tcfg = TrainConfig(**{**TRAIN_CFG, "lr": H_LR[SCAN_ARCH]})
    curves, start = {}, None
    for dev in ("cuda", "cpu"):
        prog = build_train_program(cfg, ParallelConfig(remat="full"), tcfg,
                                   dev)
        if start is None:
            start = prog.init_fn(SEED)
        params, state = tree_map(lambda t: t.to(dev), start)
        batch = train_batch(cfg, F2_BATCH, F2_SEQ, dev)
        curves[dev] = []
        for _ in range(F2_STEPS):
            params, state, metrics = prog.step_fn(params, state, batch)
            curves[dev].append(metrics["loss"].item())
    rel = [abs(a - b) / abs(b) for a, b in zip(curves["cuda"],
                                                curves["cpu"])]
    verdict = ("agree: F2 is the bf16 recipe's sensitivity"
               if max(rel) <= TOL_F2 else
               "part: F2 is a parity fault of the kernels")
    log(f"[F2] {SCAN_ARCH} reduced, float32, {F2_STEPS} steps of phase H's "
        f"recipe (lr {tcfg.lr}), batch {F2_BATCH} x {F2_SEQ}: losses on the "
        f"card (kernels) {curves['cuda']}, on the CPU (plain) "
        f"{curves['cpu']}; relative differences "
        f"{[float(f'{x:.3e}') for x in rel]} (tolerance {TOL_F2}): the "
        f"curves {verdict}; {time.perf_counter() - t0:.1f} s on {card}")
    return curves, rel


def families_training_phase(la, ss, card):
    """Phase H: granite-moe-3b-a800m and falcon-mamba-7b trained at full
    width (granite at full depth), then the float32 cuts of both and
    jamba's reduced config against the CPU.  Returns the scan backward's
    JSON row, and the counted launches of the forward kernels."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    launches, worst, row = {}, {}, None
    for arch in H_LAYERS:
        counted, r, w = h_train(la, ss, arch, card)
        for key, v in counted.items():
            launches[key] = launches.get(key, 0) + v
        for key, v in w.items():
            worst[key] = max(worst.get(key, 0.0), v)
        row = row or r
    for arch, layers in H_SMALL_LAYERS.items():
        cfg = get_config(arch)
        cfg = cfg.reduced() if layers is None else dataclasses.replace(
            cfg, num_layers=layers)
        h_f32_vs_cpu(la, ss, cfg, arch, card)
    worst_edge = check_scan_bwd_grid(ss)
    log(f"[H] phase H: {time.perf_counter() - t_phase:.1f} s on {card}; "
        f"counted launches {launches}")
    return {"name": "selective_scan_bwd", "route": "cuda",
            "source": SCAN_BWD_SOURCE, "replaces": SCAN_BWD_REPLACES,
            "launches": launches["selective_scan_bwd"],
            "max_abs_err": max(worst["selective_scan_bwd"], worst_edge),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None}, launches


# ---------------------------------------------------------------------------
# Phase I: MLA with multi-token prediction, the encoder-decoder and the
# vit_stub frontend trained
# ---------------------------------------------------------------------------

#: phase I's bfloat16 runs at the published widths.  deepseek-v3-671b is
#: cut to its first 3 layers, all dense (``first_dense`` = 3), with its
#: multi-token-prediction block, whose layer is of the last layer's kind
#: (dense here): 4.29 G parameters by a count from the config (embedding
#: and head 1.85 G, a dense MLA layer 0.58 G, ``proj`` 0.10 G), about 63
#: GB of training state at granite's measured 14.7 bytes a parameter.  A
#: 4-layer cut would make the MTP layer a 256-expert MoE layer of about
#: 11.5 G parameters, more than one card trains; MTP over an MoE layer is
#: held in float32 against the CPU below (and at the reduced config in
#: the CPU tests).  seamless-m4t-large-v2 (24 + 24 layers) and
#: internvl2-2b (24) run uncut.  None: uncut.
I_LAYERS = {"deepseek-v3-671b": 3, "seamless-m4t-large-v2": None,
            "internvl2-2b": None}
#: the counted donated steps of each (AdamW as phase G, the first one
#: repeated from a new init of the same seed)
I_STEPS = 3
#: heads a slice of the plain backward takes at a wide call: at
#: deepseek's 128 heads one float32 score tensor of the whole call is
#: 4 x 128 x 2048^2 x 4 B = 8.6 GB, and the heads of a group-1 call are
#: independent, so the plain version runs 8 at a time (the same function)
BWD_PLAIN_HEADS = 8
#: phase I's float32 cuts held against the CPU (batch 1 x TRAIN_SMALL_SEQ,
#: TF32 off): seamless 2 + 2 layers and internvl2 2 at the published
#: widths (internvl2 at 4 layers took 19.2 s on the CPU; 2 pay for phase
#: P's time), and an MLA + MTP cut (``mla_small``)
I_SMALL_LAYERS = {"seamless-m4t-large-v2": 2, "internvl2-2b": 2}


def mla_small():
    """deepseek-v3-671b cut for the float32 check against the CPU: MLA's
    head dims kept (q and k 128 + 64 rope dims, v 128, so the CUDA-core
    route's (192, 128) instantiation runs), 2 layers (layer 0 dense,
    layer 1 MoE with the shared expert, so the MTP layer is an MoE layer
    whose aux loss the loss drops), 8 heads, d_model 1024, d_ff 2048,
    q_lora 384 (kv_lora 512 kept), 8 routed experts top-2 of 512, vocab
    8192: the CPU side's step takes seconds."""
    from repro_torch.configs import get_config

    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(
        cfg, num_layers=2, d_model=1024, d_ff=2048, vocab_size=8192,
        attention=dataclasses.replace(cfg.attention, num_heads=8,
                                      num_kv_heads=8, q_lora_rank=384),
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                d_ff_expert=512, first_dense=1))


def bwd_plain_sliced(la, q, k, v, o, do, *, window, softcap=None):
    """``local_attention_bwd_plain`` over slices of the kv heads (each with
    its group of query heads, ``BWD_PLAIN_HEADS`` query heads a slice):
    the same function, the heads being independent, in a fraction of the
    memory at a wide call."""
    kvh, g = k.shape[2], q.shape[2] // k.shape[2]
    step = max(1, BWD_PLAIN_HEADS // g)
    if kvh <= step:
        return la.local_attention_bwd_plain(q, k, v, o, do, window=window,
                                            softcap=softcap)
    parts = []
    for i in range(0, kvh, step):
        qs, ks = slice(i * g, (i + step) * g), slice(i, i + step)
        parts.append(la.local_attention_bwd_plain(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], o[:, :, qs], do[:, :, qs],
            window=window, softcap=softcap))
    return tuple(torch.cat(p, dim=2) for p in zip(*parts))


def i_train(la, ss, arch, card):
    """Phase I, one model trained in bfloat16 at full width (cut in depth
    by ``I_LAYERS``).  Returns its counted launches by kernel, the
    largest |diff| of the attention backward from its plain version, and
    the first backward call's operands at MLA's (192, 128) pair (None
    for the others)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.optim.optimizer import init_opt_state
    from repro_torch.runtime.fault import StepGuard, StragglerMonitor
    from repro_torch.runtime.train_loop import (
        build_train_program,
        value_and_grad,
    )

    t_model = time.perf_counter()
    cfg = get_config(arch)
    if I_LAYERS[arch] is not None:
        cfg = dataclasses.replace(cfg, num_layers=I_LAYERS[arch])
    tcfg = TrainConfig(**TRAIN_CFG)
    prog = build_train_program(cfg, ParallelConfig(remat="full"), tcfg,
                               "cuda", donate=True)
    params, state = prog.init_fn(SEED)
    del state  # the gradient checks run without the moments
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    want = h_counts(cfg, torch.bfloat16)
    extras = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
              for k, v in batch.items() if k in ("frames", "patch_embeds")}
    log(f"[I] {arch}: {depth(cfg)} layers at full width (d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}"
        + (", with its MTP block" if cfg.mtp_depth else "")
        + f"), {n_params(params)} parameters (bfloat16, stacked as the "
        f"reference's), batch {TRAIN_BATCH} x {TRAIN_SEQ}"
        + (f", {extras}" if extras else "")
        + f", AdamW at lr {tcfg.lr}, remat full, donated steps; launches a "
        f"step {want}; set up in {time.perf_counter() - t_model:.1f} s")

    # one step's gradients with the kernels, every backward call held
    # against the plain version; again, bit-equal
    t0 = time.perf_counter()
    plain = functools.partial(bwd_plain_sliced, la)
    with Checked(la, ss, attn_plain=plain) as chk:
        loss_k, grads_k = value_and_grad(prog.loss_fn, params, batch)
    torch.cuda.synchronize()
    check(chk.attn_calls == want["local_attention_bwd"],
          f"[I] {arch}: {chk.attn_calls} attention backward calls in one "
          f"step, want {want['local_attention_bwd']}")
    loss_a, grads_a = value_and_grad(prog.loss_fn, params, batch)
    check(loss_a.item() == loss_k.item() and trees_equal(grads_a, grads_k),
          f"[I] {arch}: two gradients of one step differ")
    del grads_a, grads_k
    first = chk.attn_first
    call = first if first[0].shape[3] != first[2].shape[3] else None
    worst = chk.attn_abs
    log(f"[I] {arch} bf16 step: loss {loss_k.item():.6f}; the "
        f"{chk.attn_calls} attention backward calls (q "
        f"{tuple(first[0].shape)}, v {tuple(first[2].shape)}) within "
        f"{chk.attn_worst:.3e} of the scale of the plain version (tolerance "
        f"{TOL_BWD[torch.bfloat16]}, max |diff| {worst:.3e}); two gradients "
        f"of the step bit-equal; {time.perf_counter() - t0:.1f} s")
    del chk, first

    # the counted run: donated steps on the fixed batch
    state = init_opt_state(params, tcfg)
    guard, monitor = StepGuard(
        recover=lambda step: fail(f"phase I: a step failed and was retried "
                                  f"at {step}"), max_retries=0), \
        StragglerMonitor()
    losses, step_ms, launches = [], [], dict.fromkeys(want, 0)
    for step in range(I_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_lm_counts(la, ss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = guard.run(prog.step_fn, step, params, state,
                                           batch)
        losses.append(metrics["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = all_launches(la, ss)
        check(counts == want, f"[I] {arch} step {step + 1}: launches "
                              f"{counts}, want {want}")
        for key, v in counts.items():
            launches[key] += v
        monitor.observe(step, step_ms[-1] / 1e3)
        if step == 0:
            printed = fingerprint((params, state.m, state.v))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"[I] {arch}: losses {losses}")
    med = float(np.median(step_ms[1:]))
    log(f"[I] {arch} {I_STEPS} AdamW steps: losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]} (median of steps 2 to {I_STEPS}: "
        f"{med:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s); "
        f"peak device memory {peak / 1e9:.2f} GB; straggler flags "
        f"{monitor.flagged_steps}; on {card}")

    # the first step again from a new init of the same seed: bit-equal
    del params, state, metrics
    torch.cuda.empty_cache()
    params, state = prog.init_fn(SEED)
    again = prog.step_fn(params, state, batch)
    same = fingerprint((again[0], again[1].m, again[1].v)) == printed
    check(again[2]["loss"].item() == losses[0] and same,
          f"[I] {arch}: the first step repeated from the same state differs "
          f"(loss {again[2]['loss'].item()} / {losses[0]}, fingerprints "
          f"equal {same})")
    del params, state, again, batch, prog
    torch.cuda.empty_cache()
    log(f"[I] {arch}: the first step repeated from a new init of the same "
        f"seed: the same loss and fingerprint of every leaf of its params "
        f"and moments; {time.perf_counter() - t_model:.1f} s on {card}")
    return launches, worst, call


def time_mla_bwd(la, call, card, reps: int = 5):
    """The backward kernel at deepseek's training call (q, k (4, 2048, 128,
    192), v (4, 2048, 128, 128), full causal, group 1): device time by
    kernel (the profiler) and a call by CUDA events, beside the plain
    version (head slice by head slice), autograd through SDPA by events
    with every backend forced in turn, and the bound.  Returns the JSON
    row's numbers."""
    q, k, v, o, do, window, cap = call
    names = la.BWD_KERNELS[la.bwd_route(q.dtype, q.shape[3], v.shape[3])]

    def run():
        return la.local_attention_bwd(q, k, v, o, do, window=window,
                                      softcap=cap)

    each = device_ms(run, [()], reps, kernel=names, split=True)
    kern = sum(each.values())
    events = event_ms(run, [()], reps)
    plain = device_ms(lambda: bwd_plain_sliced(
        la, q, k, v, o, do, window=window, softcap=cap), [()], 1)
    lib, node, forced = sdpa_bwd(q, k, v, do, window, reps, force=True)
    ops, nbytes = bwd_work(q, window, v.shape[3]), bwd_bytes(q, k, v)
    t_ops, t_bytes = ops / PEAK_BF16_OPS, nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    log(f"[I] local_attention_bwd (tensor cores) at deepseek's call, q "
        f"{tuple(q.shape)}, v {tuple(v.shape)}, window {window} (full "
        f"causal): {kern:.4f} ms a call by the profiler ("
        + ", ".join(f"{name} {ms:.4f}" for name, ms in each.items())
        + f"), {events:.4f} ms by events; {ops / kern / 1e9:.1f} TFLOP/s on "
        f"unmasked work, {100 * bound / kern:.2f}% of the {bound:.4f} ms "
        f"bound ({'operations' if t_ops >= t_bytes else 'bytes'}; "
        f"{ops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB); plain "
        f"{plain:.4f} ms; SDPA autograd (is_causal, events) {lib:.4f} ms by "
        f"{node}; forced: {forced}; on {card}")
    return {"ms": kern, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib}


def mla_encdec_training_phase(la, ss, card):
    """Phase I: deepseek-v3-671b (3 layers and its MTP block),
    seamless-m4t-large-v2 and internvl2-2b trained at full width; the
    backward kernel timed at deepseek's call; the float32 cuts against
    the CPU.  Returns the backward's JSON row numbers at deepseek's call,
    the counted launches and the backward's largest |diff|."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    launches, worst, call = {}, 0.0, None
    for arch in I_LAYERS:
        counted, w, c = i_train(la, ss, arch, card)
        for key, v in counted.items():
            launches[key] = launches.get(key, 0) + v
        worst = max(worst, w)
        if c is not None:
            call = c
    check(call is not None, "[I] no backward call at MLA's (192, 128) pair")
    row = time_mla_bwd(la, call, card)
    del call
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    h_f32_vs_cpu(la, ss, mla_small(), "deepseek-v3-671b (MLA + MTP cut)",
                 card, tag="I")
    for arch, n in I_SMALL_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=n)
        if cfg.is_encdec:
            cfg = dataclasses.replace(cfg, encoder_layers=n)
        h_f32_vs_cpu(la, ss, cfg, arch, card, tag="I")
    log(f"[I] float32 cuts against the CPU: {time.perf_counter() - t0:.1f} "
        f"s")
    log(f"[I] phase I: {time.perf_counter() - t_phase:.1f} s on {card}; "
        f"counted launches {launches}")
    return row, launches, worst


# ---------------------------------------------------------------------------
# Phase P: serving at tp > 1, the ranks sharing cuda:0
# ---------------------------------------------------------------------------

#: phase P's ranks: one spawn, all on cuda:0; NCCL refuses two ranks on
#: one device, so the collectives take gloo's explicit host copies
P_WORLD = 4
#: the label of every phase P time: they measure the host's copies and
#: the shared card, not an interconnect, and claim nothing
P_SHARED = "ranks share one card; collectives cross the host"
#: the device of phase P's card runs (its float32 cuts' second run is on
#: the CPU)
P_DEVICE = "cuda"
#: falcon-mamba's depth in phase P (of 64 layers): the scan at 4096
#: channels a rank
P_MAMBA_LAYERS = 8
#: greedy tokens of phase P's generations: a decode step at tp > 1
#: waits on a host round trip per collective, 0.2 to 0.9 s a token on the
#: shared card (4, not 8, since phase Q joined: the script's time limit)
P_GEN = 4
#: phase P's bfloat16 jobs, in steps; a step's jobs run side by side on
#: disjoint ranks.  (arch, layers or None, mesh (data, model), ranks,
#: flavors (name, kv dtype, int8 weights, reduction, whether it
#: generates P_GEN tokens or only prefills), the plain-kernel swap as
#: the logits' yardstick, the busy share profiled).  The first flavor's
#: prefill also runs twice (bit-equal) and under the plain kernels
P_BF16_STEPS = (
    (("gemma3-1b", None, (2, 2), (0, 1, 2, 3),
      (("bf16-ring", "bfloat16", False, "ring", True),
       ("bf16-allreduce", "bfloat16", False, "allreduce", True),
       ("int8-ring", "int8", True, "ring", False),
       ("int8-allreduce", "int8", True, "allreduce", False)), False, True),),
    (("qwen2-0.5b", None, (1, 4), (0, 1, 2, 3),
      (("bf16-allreduce", "bfloat16", False, "allreduce", True),
       ("bf16-ring", "bfloat16", False, "ring", False),
       ("int8-ring", "int8", True, "ring", False)), False, False),),
    (("granite-moe-3b-a800m", None, (1, 2), (0, 1),
      (("bf16-ring", "bfloat16", False, "ring", False),
       ("bf16-allreduce", "bfloat16", False, "allreduce", False)), True,
      False),
     ("falcon-mamba-7b", P_MAMBA_LAYERS, (1, 2), (2, 3),
      (("bf16-ring", "bfloat16", False, "ring", True),
       ("bf16-allreduce", "bfloat16", False, "allreduce", False)), False,
      False)),
    (("deepseek-v3-671b", 4, (1, 2), (0, 1),
      (("bf16-ring", "bfloat16", False, "ring", True),
       ("bf16-allreduce", "bfloat16", False, "allreduce", False)), True,
      False),),
)
#: per rank, per prefill: each kernel's launches (those of tp = 1) and
#: the attention call's (q heads, kv heads) or the scan's channels at
#: tp > 1: gemma3 4 heads on 1 kv head -> 2 on 1 (the group trick);
#: qwen2's 14 heads do not divide 4 -> replicated, 14 on 2
P_LAUNCHES = {"gemma3-1b": ("local_attention", 26, (2, 1)),
              "qwen2-0.5b": ("local_attention", 24, (14, 2)),
              "granite-moe-3b-a800m": ("local_attention", 32, (12, 4)),
              "falcon-mamba-7b": ("selective_scan", P_MAMBA_LAYERS, 4096),
              "deepseek-v3-671b": ("local_attention", 4, (64, 64))}
#: the float32 card-against-CPU cuts, phase 7's and phases F and E's:
#: (arch, layers or None for the reduced config, flavors, the bfloat16
#: job whose mesh runs it, after that job).  At tp = 2 they run on
#: falcon-mamba's (1, 2) mesh, while granite's ranks serve granite;
#: qwen2 runs again at tp = 4 on its own (1, 4) mesh, where its 14 heads
#: do not shard and its decode reads the sequence-sharded cache, in
#: both cache dtypes
P_F32_CUTS = ((("gemma3-1b", SMALL_LAYERS, ("bf16", "cim_int8"),
                "falcon-mamba-7b"),
               ("qwen2-0.5b", 4, ("bf16",), "falcon-mamba-7b"))
              + tuple((arch, layers, ("bf16",), "falcon-mamba-7b")
                      for arch, layers in {**FAMILY_SMALL_LAYERS,
                                           **E_SMALL_LAYERS}.items())
              + (("qwen2-0.5b", 4, ("bf16", "cim_int8"), "qwen2-0.5b"),))
#: the float32 cuts whose per-rank MoE capacity drops other pairs than
#: tp = 1 does: held against the CPU's tp = 2 run only
P_F32_NOT_TP1 = ("granite-moe-3b-a800m",)


def p_config(arch: str, layers, dtype=None):
    """Phase P's config: ``family_config``'s cut (seamless: ``layers``
    encoder and decoder layers), or the reduced config for None with a
    float32 dtype asked for (jamba's cut)."""
    from repro_torch.configs import get_config

    if layers is None and dtype == torch.float32:
        return get_config(arch).reduced()
    cfg = family_config(arch, layers)
    if cfg.is_encdec and layers is not None:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    return cfg


def p_program(cfg, batch, prompt, gen, kv_dtype, cim, device, dtype, mesh,
              reduction, serial: bool = False):
    """``lm_program`` on a mesh: the same seeded draws (the global
    weights, each layer cut to this rank's shard as it is drawn, then
    the prompt), this rank's rows of the batch.  ``serial``: the ranks
    of the model axis draw one after another (deepseek's global MoE
    layer is 37 GB while drawn)."""
    import torch.distributed as dist

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.runtime.serve_loop import build_serve_program

    prog = build_serve_program(cfg, batch=batch, s_max=prompt + gen + 1,
                               kv_dtype=kv_dtype, cim_weights=cim,
                               device=device, mesh=mesh,
                               pcfg=ParallelConfig(reduction=reduction))
    gen_ = torch.Generator(device=prog.device).manual_seed(SEED)
    params = None
    for turn in range(mesh.model.size if serial else 1):
        if not serial or turn == mesh.model.index:
            params = prog.serving_params(prog.init_params(gen_, dtype))
            if prog.device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        if serial:
            dist.barrier(group=mesh.model.group)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                   generator=gen_, device=prog.device)}
    fe = cfg.frontend
    if cfg.is_encdec or (fe is not None and fe.kind == "vit_stub"):
        key, n = (("frames", prompt) if cfg.is_encdec
                  else ("patch_embeds", fe.num_tokens))
        out[key] = torch.randn((batch, n, fe.embed_dim), generator=gen_,
                               device=prog.device).to(dtype)
    return prog, params, prog.shard_batch(out)


def p_busy(run) -> float:
    """Device busy share of ``run()`` in this rank (``torch.profiler``),
    or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(getattr(ev, "self_device_time_total", 0.0)
               for ev in prof.key_averages()
               if str(getattr(ev, "device_type", "")).endswith("CUDA"))
    return busy / wall_us if busy > 0 else None


def p_bf16_job(job, mesh):
    """One bfloat16 model on this rank's mesh.  Per flavor, one counted
    prefill (launches, the kernels' call shapes, the bytes sent; the
    timed generation's own where the flavor generates P_GEN tokens).
    The first flavor's prefill runs again (bit-equal) with each kernel
    call held against its plain version, and where asked with the plain
    kernels and under the profiler.  Returns CPU results."""
    import repro_torch.kernels.local_attention as la
    import repro_torch.kernels.selective_scan as ss
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import dataflow
    from repro_torch.runtime.serve_loop import (build_serve_program,
                                                greedy_generate)

    arch, layers, _, _, flavors, plain, busy = job
    cfg = family_config(arch, layers)
    out, params_by_cim = {}, {}
    for i, (name, kv_dtype, cim, reduction, gen) in enumerate(flavors):
        t0 = time.perf_counter()
        if cim in params_by_cim:  # the other reduction: the same params
            params, batch = params_by_cim[cim]
            prog = build_serve_program(
                cfg, batch=LM_BATCH, s_max=LM_PROMPT + P_GEN + 1,
                kv_dtype=kv_dtype, cim_weights=cim, device=P_DEVICE,
                mesh=mesh, pcfg=ParallelConfig(reduction=reduction))
        else:
            params_by_cim.clear()
            prog, params, batch = p_program(
                cfg, LM_BATCH, LM_PROMPT, P_GEN, kv_dtype, cim, P_DEVICE,
                torch.bfloat16, mesh, reduction,
                serial=arch == "deepseek-v3-671b")
            params_by_cim[cim] = (params, batch)
        if i == 0:  # the card, the libraries and the host buffers
            greedy_generate(prog, params, warm_batch(batch), 2)
        torch.cuda.synchronize()
        res = {"setup_s": time.perf_counter() - t0}
        calls = []
        attn, scan = la.grouped_local_attention, ss.selective_scan

        def attn_rec(q, k, v, *, window, softcap=None):
            calls.append(("attn", tuple(q.shape), tuple(k.shape)))
            return attn(q, k, v, window=window, softcap=softcap)

        def scan_rec(*ops):
            calls.append(("scan", tuple(ops[0].shape)))
            return scan(*ops)

        def prefill_done(step, logits):
            if step == 0:
                torch.cuda.synchronize()
                res.update(t_prefill=time.perf_counter(), logits=logits,
                           launches=all_launches(la, ss),
                           traffic=dict(dataflow.TRAFFIC))

        reset_lm_counts(la, ss)
        dataflow.reset_traffic()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with Swapped((la, "grouped_local_attention", attn_rec),
                     (ss, "selective_scan", scan_rec)):
            if gen:
                tokens = greedy_generate(prog, params, batch, P_GEN,
                                         on_logits=prefill_done)
                torch.cuda.synchronize()
                res["decode_ms"] = ((time.perf_counter() - res["t_prefill"])
                                    / (P_GEN - 1) * 1e3)
                res["tokens_ok"] = bool(
                    tuple(tokens.shape) == (batch["tokens"].shape[0], P_GEN)
                    and int(tokens.min()) >= 0
                    and int(tokens.max()) < cfg.vocab_size)
            else:
                prefill_done(0, prog.prefill_fn(params, batch)[0])
        res["prefill_ms"] = (res.pop("t_prefill") - t1) * 1e3
        logits = res.pop("logits")
        res.update(calls=calls, logits=logits.float().cpu(),
                   finite=bool(torch.isfinite(logits[:, :cfg.vocab_size])
                               .all()),
                   pad_masked=bool((logits[:, cfg.vocab_size:] == -1e30)
                                   .all()))
        if i == 0:
            # the second prefill holds every kernel call against its
            # plain version on the same inputs (``checked_kernels``); it
            # returns the kernels' own outputs, so it stays bit-equal
            worst, seen = {}, {}
            with checked_kernels(la, ss, worst, seen):
                again = prog.prefill_fn(params, batch)[0]
            res.update(equal=torch.equal(again, logits), worst=worst)
            del seen, again
            if plain:
                with plain_kernels(la, ss):
                    res["plain_logits"] = prog.prefill_fn(
                        params, batch)[0].float().cpu()
            if busy:
                # every rank of the mesh runs the prefill (its
                # collectives); the mesh's first rank profiles it
                run = functools.partial(prog.prefill_fn, params, batch)
                if mesh.coords == (0, 0):
                    res["busy"] = p_busy(run)
                else:
                    run()
            torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        del prog, logits
    del params_by_cim
    torch.cuda.empty_cache()
    return out


def p_f32_job(arch, layers, flavors, mesh):
    """One float32 cut on this rank's mesh, on the card and then
    on the CPU (the card's shard copied across): per flavor the tokens,
    each step's logits and the MoE slot tables of each call."""
    from repro_torch.runtime.serve_loop import (build_serve_program,
                                                greedy_generate)

    cfg = p_config(arch, layers, torch.float32)
    out = {}
    for name in flavors:
        _, kv_dtype, cim = next(f for f in LM_FLAVORS if f[0] == name)
        t0 = time.perf_counter()
        prog, params, batch = p_program(cfg, 1, SMALL_PROMPT, SMALL_GEN,
                                        kv_dtype, cim, P_DEVICE,
                                        torch.float32, mesh, "ring")
        runs = {}
        for where in ("card", "cpu"):
            if where == "cpu":
                prog = build_serve_program(
                    cfg, batch=1, s_max=prog.s_max, kv_dtype=kv_dtype,
                    cim_weights=cim, device="cpu", mesh=mesh)
                params, batch = to_device(params, "cpu"), to_device(batch,
                                                                   "cpu")
            seen, tables = [], []
            with route_recorder(tables):
                tokens = greedy_generate(
                    prog, params, batch, SMALL_GEN,
                    on_logits=lambda i, lg: seen.append(lg.float().cpu()))
            runs[where] = dict(tokens=tokens.cpu(), logits=seen,
                               tables=tables)
        runs["seconds"] = time.perf_counter() - t0
        out[name] = runs
        del prog, params, batch
        torch.cuda.empty_cache()
    return out


def p_rank(rank: int, world: int):
    """Phase P's rank program: the bfloat16 steps, then the float32 cuts.
    Every rank builds every mesh (``new_group`` is collective) and runs
    the jobs it belongs to; a barrier closes each step."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(2)  # four ranks share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"bf16": {}, "f32": {}}
    with torch.no_grad():
        for step in P_BF16_STEPS:
            meshes = [make_mesh(*job[2], backend="gloo", host_copies=True,
                                ranks=job[3]) for job in step]
            for job, mesh in zip(step, meshes):
                if mesh is None:
                    continue
                t0 = time.perf_counter()
                out["bf16"][job[0]] = dict(
                    coords=mesh.coords, flavors=p_bf16_job(job, mesh),
                    seconds=time.perf_counter() - t0)
                for arch, layers, flavors, after in P_F32_CUTS:
                    if after == job[0]:
                        out["f32"][(arch, mesh.model.size)] = dict(
                            coords=mesh.coords,
                            runs=p_f32_job(arch, layers, flavors, mesh))
            dist.barrier()
    # this rank's failed checks (``checked_kernels``'), gated by the
    # parent
    out["failures"] = list(FAILURES)
    return out


def pq_rank(rank: int, world: int, parts, ref):
    """Phases P and Q's ranks in one spawn, so that each process starts
    and reaches the card once: phase P's program, then phase Q's (with
    phase G's reference ``ref``), as ``parts`` names them.  Each part's
    result carries its own failed checks and its seconds."""
    import gc

    out = {}
    for part, fn, args in (("P", p_rank, ()), ("Q", q_rank, (ref,))):
        if part not in parts:
            continue
        FAILURES.clear()
        t0 = time.perf_counter()
        out[part] = fn(rank, world, *args)
        out[part]["part_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()  # phase P's cached blocks, before Q's
    return out


def pq_spawn(parts, ref=None):
    """One spawn of ``P_WORLD`` ranks on cuda:0 over gloo host copies
    running ``parts`` of phases P and Q; returns (each rank's result by
    part, the spawn's seconds).  The gloo timeout is phase P's when it
    runs (its ranks wait at barriers while others serve), else
    ``Q_TIMEOUT_S``."""
    import repro_torch.launch.mesh as mesh_mod

    tmp = Path(__file__).resolve().parent / "build" / "chip_smoke" / "spawn"
    t0 = time.perf_counter()
    results = mesh_mod.spawn(pq_rank, P_WORLD, tuple(parts), ref,
                             tmp_dir=str(tmp), backend="gloo",
                             timeout_s=900 if "P" in parts else Q_TIMEOUT_S)
    return results, time.perf_counter() - t0


def p_tp1_references(card):
    """The tp = 1 runs on the card phase P holds its tp > 1 runs against,
    from the same seeded draws: the bfloat16 prefill logits of gemma3,
    qwen2 and falcon-mamba (per int8 flag), gemma3's timed bf16
    generation, and the float32 cuts' tokens and logits where tp > 1
    routes the same pairs (``P_F32_NOT_TP1``).  Every tp draws the same
    global weights: a padded vocabulary's embedding and head are drawn
    at the real vocabulary and padded with zeros."""
    from repro_torch.runtime.serve_loop import greedy_generate

    bf16, timing, f32 = {}, None, {}
    for arch, layers in (("gemma3-1b", None), ("qwen2-0.5b", None),
                         ("falcon-mamba-7b", P_MAMBA_LAYERS)):
        cfg = family_config(arch, layers)
        cims = (False, True) if arch != "falcon-mamba-7b" else (False,)
        for cim in cims:
            kv = "int8" if cim else "bfloat16"
            prog, params, batch = lm_program(cfg, LM_BATCH, LM_PROMPT, LM_GEN,
                                             kv, cim, P_DEVICE,
                                             torch.bfloat16)
            if arch == "gemma3-1b" and not cim:
                greedy_generate(prog, params, warm_batch(batch), 2)
                pre, dec, logits, _ = timed_generate(prog, params, batch)
                timing = (pre[0] * 1e3, dec[0] * 1e3)
            else:
                logits = prog.prefill_fn(params, batch)[0]
            bf16[(arch, cim)] = logits.float().cpu()
            del prog, params, batch, logits
            torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, layers, flavors, _ in P_F32_CUTS:
        if arch in P_F32_NOT_TP1:
            continue
        cfg = p_config(arch, layers, torch.float32)
        for name in flavors:
            if (arch, name) in f32:
                continue
            _, kv, cim = next(f for f in LM_FLAVORS if f[0] == name)
            prog, params, batch = lm_program(cfg, 1, SMALL_PROMPT, SMALL_GEN,
                                             kv, cim, P_DEVICE, torch.float32)
            seen = []
            tokens = greedy_generate(
                prog, params, batch, SMALL_GEN,
                on_logits=lambda i, lg: seen.append(lg.float().cpu()))
            f32[(arch, name)] = (tokens.cpu(), seen)
            del prog, params, batch
            torch.cuda.empty_cache()
    return bf16, timing, f32


def p_rows(results, arch, name, key="logits"):
    """The global (B, V) of one flavor: rows by data coordinate, from the
    model index 0 ranks; the other model ranks must hold the same."""
    parts = {r["bf16"][arch]["coords"]: r["bf16"][arch]["flavors"][name]
             for r in results if arch in r["bf16"]}
    n_data = 1 + max(d for d, _ in parts)
    n_model = 1 + max(m for _, m in parts)
    rows = []
    for d in range(n_data):
        first = parts[(d, 0)][key]
        for m in range(1, n_model):
            check(torch.equal(parts[(d, m)][key], first),
                  f"[P] {arch} {name}: model rank {m} of data row {d} "
                  f"returned other {key} than rank 0")
        rows.append(first)
    return torch.cat(rows), parts


def p_close(a, b, max_tol, mean_tol):
    diff = (a - b).abs()
    return (diff.max().item() <= max_tol and diff.mean().item() <= mean_tol,
            diff.max().item(), diff.mean().item())


def tp_phase(la, ss, card, q_ref=None):
    """Phase P: every LM family served at tp > 1 on the card through the
    port's mesh, 4 ranks sharing cuda:0 over gloo host copies.  Returns
    the kernels' launches in its counted prefills, summed over ranks,
    each kernel's largest |diff| from its plain version in the ranks'
    checked prefills, rank (0, 0)'s ring bytes, and, given phase G's
    reference ``q_ref``, phase Q's rank results: the same spawn runs
    phase Q's ranks after phase P's (else None)."""
    import gc

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[P] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} "
        "GB of device memory as the ranks start")
    ref_bf16, timing, ref_f32 = p_tp1_references(card)
    t_ref = time.perf_counter() - t_phase
    parts = ("P",) if q_ref is None else ("P", "Q")
    both, t_spawn = pq_spawn(parts, q_ref)
    results = [r["P"] for r in both]
    t_ranks = max(r["part_s"] for r in results)
    for rank, res in enumerate(results):
        check(not res["failures"], f"[P] rank {rank}: failed checks "
              f"{res['failures']}")
    launches, worst = {}, {}
    for step in P_BF16_STEPS:
        for arch, layers, mesh_shape, _, flavors, plain, _ in step:
            p_check_bf16(results, arch, layers, mesh_shape, flavors, plain,
                         ref_bf16, launches, worst, card)
    log(f"[P] gemma3-1b bf16 at tp = 1 (one process): prefill "
        f"{timing[0]:.1f} ms, decode {timing[1]:.2f} ms/token on {card}, "
        "beside phase P's tp > 1 times")
    for arch, layers, flavors, after in P_F32_CUTS:
        tp = next(job[2][1] for step in P_BF16_STEPS for job in step
                  if job[0] == after)
        p_check_f32(results, arch, layers, flavors, tp, ref_f32)
    log(f"[P] phase P: tp = 1 references {t_ref:.1f} s, ranks "
        f"{t_ranks:.1f} s (the spawn of phases {' and '.join(parts)}: "
        f"{t_spawn:.1f} s), total {t_ref + t_spawn:.1f} s with phase Q's "
        f"ranks ({P_SHARED}) on {card}")
    ring_bytes = {r["bf16"][X_P_ARCH]["coords"]: r["bf16"][X_P_ARCH][
        "flavors"][X_P_FLAVOR]["traffic"]["bytes_sent"]
        for r in results if X_P_ARCH in r["bf16"]}
    return (launches, worst, ring_bytes,
            None if q_ref is None else [r["Q"] for r in both])


def p_check_bf16(results, arch, layers, mesh_shape, flavors, plain,
                 ref_bf16, launches, worst, card):
    """Phase P's gates on one bfloat16 model, and its log lines; each
    kernel's largest |diff| from its plain version goes into
    ``worst``."""
    v = family_config(arch, layers).vocab_size
    kname, want_n, want_shape = P_LAUNCHES[arch]
    tol = ((TOL_FULL_LOGITS, TOL_FULL_LOGITS_MEAN) if not plain
           else TOL_FAMILY_LOGITS[arch])
    logits = {}
    for i, (name, kv, cim, reduction, gen) in enumerate(flavors):
        rows, parts = p_rows(results, arch, name)
        logits[name] = rows
        per = list(parts.values())
        for coords, res in parts.items():
            counts = res["launches"]
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            other = {k: n for k, n in counts.items() if k != kname and n}
            check(counts.get(kname) == want_n and not other,
                  f"[P] {arch} {name} rank {coords}: launches in one "
                  f"prefill {counts}, want {want_n} of {kname} (tp = 1's) "
                  "and nothing else")
            if kname == "selective_scan":
                shapes = {c[1] for c in res["calls"]}
                want = {(LM_BATCH, LM_PROMPT, want_shape)}
            else:
                shapes = {(c[1][0], c[1][1], c[1][2], c[2][2])
                          for c in res["calls"]}
                want = {(LM_BATCH // mesh_shape[0], LM_PROMPT) + want_shape}
            check(shapes == want and len(res["calls"]) == want_n,
                  f"[P] {arch} {name} rank {coords}: kernel calls "
                  f"{sorted(shapes)}, want {sorted(want)}")
            check(res.get("equal", True), f"[P] {arch} {name} rank "
                  f"{coords}: two prefills gave other logits")
            if i == 0:
                check(set(res["worst"]) == {kname},
                      f"[P] {arch} {name} rank {coords}: the checked "
                      f"prefill held {sorted(res['worst'])} against the "
                      f"plain versions, want {kname}")
                for k, err in res["worst"].items():
                    worst[k] = max(worst.get(k, 0.0), err)
            check(res.get("tokens_ok", True), f"[P] {arch} {name} rank "
                  f"{coords}: generated tokens out of range")
            check(res["finite"] and res["pad_masked"],
                  f"[P] {arch} {name} rank {coords}: logits not finite, "
                  "or padded vocabulary columns not -1e30")
            traffic = res["traffic"]
            check(traffic["host_copies"] == traffic["collectives"] > 0,
                  f"[P] {arch} {name} rank {coords}: {traffic} (every "
                  "collective through the host)")
        first = per[0]
        busy = ""
        if "busy" in first:
            busy = "; device busy " + (
                "not measured" if first["busy"] is None
                else f"{100 * first['busy']:.2f}% of a rank's prefill")
        held = ""
        if "worst" in first:
            err = max(p["worst"].get(kname, 0.0) for p in per)
            held = f"; checked prefill max |diff| from plain {err:.6f}"
        log(f"[P] {arch} {name} on mesh {mesh_shape}: per rank "
            f"{first['launches'].get(kname)} {kname} launches a prefill at "
            f"{first['calls'][0][1:]}; bytes sent per rank in one prefill "
            f"{[p['traffic']['bytes_sent'] for p in per]} in "
            f"{first['traffic']['collectives']} collectives; prefill ms "
            f"{[round(p['prefill_ms'], 1) for p in per]}"
            + (f", decode ms/token {[round(p['decode_ms'], 2) for p in per]}"
               if gen else "")
            + f"{busy}{held}; set up {first['setup_s']:.1f} s, "
            f"{first['seconds']:.1f} s in all ({P_SHARED}) on {card}")
        if plain and i == 0:
            plain_rows = p_rows(results, arch, name, "plain_logits")[0]
            ok, mx, mn = p_close(rows[:, :v], plain_rows[:, :v], *tol)
            log(f"[P] {arch} {name}: kernels vs plain versions at tp > 1, "
                f"prefill logits max |diff| {mx:.6f}, mean {mn:.6f} "
                f"(tolerances {tol})")
            check(ok, f"[P] {arch} {name}: prefill logits differ from the "
                  "plain versions' run")
        if not plain:
            ok, mx, mn = p_close(rows[:, :v], ref_bf16[(arch, cim)], *tol)
            log(f"[P] {arch} {name}: tp > 1 vs tp = 1 prefill logits max "
                f"|diff| {mx:.6f}, mean {mn:.6f} (tolerances {tol})")
            check(ok, f"[P] {arch} {name}: prefill logits differ from "
                  "tp = 1's")
    for name, kv, cim, reduction, gen in flavors:
        if reduction != "allreduce":
            continue
        ring = name.replace("allreduce", "ring")
        ok, mx, mn = p_close(logits[name][:, :v], logits[ring][:, :v], *tol)
        log(f"[P] {arch}: {name} vs {ring} prefill logits max |diff| "
            f"{mx:.6f}, mean {mn:.6f} (tolerances {tol})")
        check(ok, f"[P] {arch}: {name} differs from {ring}")


def p_check_f32(results, arch, layers, flavors, tp, ref_f32):
    """Phase P's gates on one float32 cut at ``tp``, and its log line."""
    cfg = p_config(arch, layers, torch.float32)
    v = cfg.vocab_size
    parts = {r["f32"][(arch, tp)]["coords"]: r["f32"][(arch, tp)]["runs"]
             for r in results if (arch, tp) in r["f32"]}
    for name in flavors:
        kv = next(f for f in LM_FLAVORS if f[0] == name)[1]
        card_run = parts[(0, 0)][name]["card"]
        cpu_run = parts[(0, 0)][name]["cpu"]
        errs = []
        for i, (a, b) in enumerate(zip(card_run["logits"],
                                       cpu_run["logits"])):
            tol = TOL_SMALL["bfloat16" if i == 0 else kv]
            errs.append((a - b).abs().max().item())
            check(torch.allclose(a, b, rtol=tol, atol=tol),
                  f"[P] {arch} {name} float32 cut: step {i} logits differ "
                  f"from the CPU's tp = {tp} run by {errs[-1]}")
        check(torch.equal(card_run["tokens"], cpu_run["tokens"]),
              f"[P] {arch} {name} float32 cut: tokens on the card "
              f"{card_run['tokens'].tolist()}, on the CPU "
              f"{cpu_run['tokens'].tolist()}")
        for coords, runs in parts.items():
            t_card, t_cpu = runs[name]["card"]["tables"], \
                runs[name]["cpu"]["tables"]
            check(len(t_card) == len(t_cpu)
                  and all(torch.equal(a, b) for a, b in zip(t_card, t_cpu)),
                  f"[P] {arch} {name} float32 cut rank {coords}: MoE slot "
                  "tables differ from the CPU's")
        msg = ""
        # int8 weights quantize the same global leaves as tp = 1
        if (arch, name) in ref_f32:
            tokens1, logits1 = ref_f32[(arch, name)]
            errs1 = []
            for i, (a, b) in enumerate(zip(card_run["logits"], logits1)):
                tol = TOL_SMALL["bfloat16" if i == 0 else kv]
                errs1.append((a[:, :v] - b[:, :v]).abs().max().item())
                check(torch.allclose(a[:, :v], b[:, :v], rtol=tol, atol=tol),
                      f"[P] {arch} {name} float32 cut: step {i} logits "
                      f"differ from tp = 1's by {errs1[-1]}")
            check(torch.equal(card_run["tokens"], tokens1),
                  f"[P] {arch} {name} float32 cut: tokens "
                  f"{card_run['tokens'].tolist()} at tp = {tp}, "
                  f"{tokens1.tolist()} at tp = 1")
            msg = (f"; against tp = 1 on the card max |logit diff| per step "
                   f"{[f'{e:.2e}' for e in errs1]}")
        n_tables = len(parts[(0, 0)][name]["card"]["tables"])
        log(f"[P] {arch} {name} float32 cut at tp = {tp}: tokens "
            f"{card_run['tokens'][0].tolist()} equal on the card and the "
            f"CPU; max |logit diff| per step {[f'{e:.2e}' for e in errs]}"
            f"{msg}; {n_tables} MoE slot tables a rank equal the CPU's; "
            f"{parts[(0, 0)][name]['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# Phase Q: training at tp > 1, the ranks sharing cuda:0
# ---------------------------------------------------------------------------

#: gemma3-1b's mesh: 2 rows of the batch and 2 of its 4 heads a rank
Q_MESH = (2, 2)
#: counted ring steps from a new init (the first repeats the checked one)
Q_STEPS = 3
#: the kernels phase Q's profiled step lists, by device time
Q_TOP = 10
#: gloo's timeout in a spawn of phase Q's ranks alone: a deadlocked
#: collective fails the phase in 5 minutes, not the spawn's default 10
Q_TIMEOUT_S = 300
#: where phase G keeps its first step's gradients for phase Q (bf16, the
#: training layout; each rank reads its slices through a memory map)
Q_REF_GRADS = Path(__file__).resolve().parent / "build" / "chip_smoke" \
    / "g_first_grads.pt"
#: float32 cuts: every family's reduced config at tp 2 on (1, 2) (two
#: meshes side by side), then gemma3's with each of these on (2, 2); a
#: batch of 4 x 64 (the reduced configs' MoE capacity drops no pair);
#: the MoE aux loss off (it is per rank, so it differs from tp = 1's)
Q_F32_BATCH, Q_F32_SEQ = 4, 64
Q_F32_2X2 = (("zero3", dict(zero3=True, zero3_min_size=1)),
             ("dp_only", dict(dp_only=True)),
             ("grad_compression", dict(grad_compression=True)))
#: an AdamW first step moves a param by lr g / (|g| + 1e-8): where |g| is
#: near the float32 sums' noise (or near 1e-8) the move follows the noise,
#: up to 2 lr apart; above this share of its leaf's max |g| the moves
#: agree within lr / 1000
Q_HELD = 1e-2
Q_F32_ARCHS = ("gemma3-1b", "qwen2-0.5b", "granite-moe-3b-a800m",
               "falcon-mamba-7b", "jamba-v0.1-52b", "deepseek-v3-671b",
               "seamless-m4t-large-v2", "internvl2-2b")


def q_program(cfg, mesh, device, reduction="ring", **pkw):
    """Phase G's recipe (AdamW, lr 3e-3, warmup 2, ``remat="full"``) on
    a mesh, ZeRO-1 states over both axes."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.runtime.train_loop import build_train_program

    return build_train_program(
        cfg, ParallelConfig(reduction=reduction, remat="full", **pkw),
        TrainConfig(**TRAIN_CFG), device, mesh=mesh)


def q_reference(cfg):
    """Phase G's first step at tp = 1 on the card, for ``--only-train-tp``
    (phase G keeps it when it runs): the first step's loss and gradients
    (these written to ``Q_REF_GRADS``) and the losses of two steps."""
    from repro_torch.runtime.train_loop import value_and_grad

    prog = train_program(cfg, "cuda")
    params, state = prog.init_fn(SEED)
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    loss, grads = value_and_grad(prog.loss_fn, params, batch)
    q_save_grads(grads)
    del grads
    losses = []
    for _ in range(2):
        params, state, metrics = prog.step_fn(params, state, batch)
        losses.append(metrics["loss"].item())
    del params, state, prog
    torch.cuda.empty_cache()
    return {"loss": loss.item(), "losses": losses}


def q_save_grads(grads) -> None:
    from repro_torch.tree import tree_map

    Q_REF_GRADS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(tree_map(lambda g: g.detach().cpu(), grads), Q_REF_GRADS)


def q_leaf_sums(prog, grads, ref_tree, what, sliced=False):
    """Per leaf of a rank's reduced gradient slices against the same
    slices of ``ref_tree`` (global leaves, any device; or, ``sliced``,
    this rank's slices of the same layouts): (sum of squared
    differences, sum of squared reference values, max |diff|, max
    |ref|), the sums over the slices this rank counts (one replica of
    each), so the parent adds the ranks' into the global L2 norms."""
    from repro_torch.runtime import partition
    from repro_torch.tree import leaves, leaves_with_paths

    coords = prog.mesh.coords_dict()
    out = {}
    for (path, g), ref, lay in zip(leaves_with_paths(grads),
                                   leaves(ref_tree), leaves(prog.layouts)):
        at = partition.slice_starts(lay.zspec, lay.shape, coords)
        r = (ref if sliced else ref[at]).to(g.device).float()
        diff = g.float() - r
        own = partition.owns(lay.zspec, coords)
        out[path] = (torch.sum(diff * diff).item() if own else 0.0,
                     torch.sum(r * r).item() if own else 0.0,
                     diff.abs().max().item(), r.abs().max().item())
    return {"what": what, "leaves": out}


def q_common_equal(mesh, a_tree, a_specs, b_tree, b_specs, base_specs,
                   rel: float = None):
    """Leaf by leaf, ``a`` and ``b`` (slices under their specs) gathered
    to each leaf's ``base`` spec on every rank and compared: bit-equal,
    or within ``rel`` of the leaf's largest |value| on this rank.
    Returns (the leaves that differ, the largest difference over the
    leaf's max)."""
    from repro_torch.runtime import partition
    from repro_torch.tree import leaves, leaves_with_paths

    bad, worst = [], 0.0
    for (path, a), sa, b, sb, base in zip(
            leaves_with_paths(a_tree), leaves(a_specs), leaves(b_tree),
            leaves(b_specs), leaves(base_specs)):
        ga = partition.gather_leaf(a, sa, mesh, base)
        gb = partition.gather_leaf(b, sb, mesh, base)
        if rel is None:
            if not torch.equal(ga, gb):
                bad.append(path)
            continue
        scale = gb.float().abs().max().item()
        err = (ga.float() - gb.float()).abs().max().item() if ga.numel() \
            else 0.0
        worst = max(worst, err / max(scale, 1e-30))
        if err > rel * scale:
            bad.append(path)
        del ga, gb
    return bad, worst


def q_busy(run):
    """Device busy share of ``run()`` in this rank: ``torch.profiler``
    tracing the card only (tracing the host's operators too makes a
    training step last two and a half times as long), or None where it
    saw no device time; and where the device time went: the ``Q_TOP``
    kernels that took most of it, (name, launches, ms), and the ms of
    every kernel with ``gemm`` in its name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(ev.key, ev.count, getattr(ev, "self_device_time_total", 0.0))
               for ev in prof.key_averages()
               if str(getattr(ev, "device_type", "")).endswith("CUDA")]
    busy = sum(us for _, _, us in kernels)
    top = [(name[:120], n, us / 1e3) for name, n, us in
           sorted(kernels, key=lambda k: -k[2])[:Q_TOP]]
    gemm_ms = sum(us for name, _, us in kernels if "gemm" in name.lower()) / 1e3
    return (busy / wall_us if busy > 0 else None), top, gemm_ms


def q_bf16(la, mesh, ref):
    """gemma3-1b at full width and depth, bf16, on this rank of the (2,
    2) mesh: the checked first step, ZeRO-3 and the all-reduce baseline
    from the same init, then the counted ring steps from a new init."""
    from repro_torch.configs import get_config
    from repro_torch.core import dataflow
    from repro_torch.runtime import partition
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = get_config(TRAIN_ARCH)
    gbatch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    out = {"worst": {}}
    t0 = time.perf_counter()
    prog = q_program(cfg, mesh, "cuda")
    batch = prog.shard_batch(gbatch)
    del gbatch
    params, state = prog.init_fn(SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0

    # the first step: every forward call against its plain version as it
    # runs, every backward call recorded and held against plain after
    attn, kernel_bwd = la.grouped_local_attention, la.local_attention_bwd
    bwd_calls, fwd_worst = [], [0.0]

    def attn_checked(q, k, v, *, window, softcap=None):
        y = attn(q, k, v, window=window, softcap=softcap)
        with torch.no_grad():
            want = la.grouped_local_attention_plain(q, k, v, window=window,
                                                    softcap=softcap)
            err = (y.float() - want.float()).abs().max().item()
        fwd_worst[0] = max(fwd_worst[0], err)
        check(attn_close(y.detach(), want, q.dtype),
              f"[Q] rank {mesh.coords}: local_attention != plain at q "
              f"{tuple(q.shape)} window {window}: max |diff| {err}")
        return y

    def bwd_recorded(q, k, v, o, do, *, window, softcap=None):
        bwd_calls.append((q, k, v, o, do, window, softcap))
        return kernel_bwd(q, k, v, o, do, window=window, softcap=softcap)

    dataflow.reset_traffic()
    t0 = time.perf_counter()
    with Swapped((la, "grouped_local_attention", attn_checked),
                 (la, "local_attention_bwd", bwd_recorded)):
        loss, grads = prog.grad_fn(params, batch)
    torch.cuda.synchronize()
    out["checked_grad_s"] = time.perf_counter() - t0
    out["ring_grad_bytes"] = dataflow.TRAFFIC["bytes_sent"]
    worst_bwd = 0.0
    for q, k, v, o, do, window, cap in bwd_calls:
        got = kernel_bwd(q, k, v, o, do, window=window, softcap=cap)
        want = la.local_attention_bwd_plain(q, k, v, o, do, window=window,
                                            softcap=cap)
        ok, err, scale = bwd_close(got, want, q.dtype)
        worst_bwd = max(worst_bwd, err)
        check(ok, f"[Q] rank {mesh.coords}: local_attention_bwd != plain at "
                  f"q {tuple(q.shape)} window {window}: max |diff| {err}, "
                  f"scale {scale}")
        del got, want
    out["bwd_calls"] = len(bwd_calls)
    out["bwd_shape"] = tuple(bwd_calls[0][0].shape) if bwd_calls else None
    out["worst"] = {"local_attention": fwd_worst[0],
                    "local_attention_bwd": worst_bwd}
    del bwd_calls
    out["loss"] = loss.item()
    out["vs_g"] = q_leaf_sums(prog, grads, torch.load(
        Q_REF_GRADS, mmap=True), "phase G's first step")
    p1, s1, m1 = prog.update_fn(params, state, loss, grads)
    out["first_fp"] = (fingerprint(p1), fingerprint(s1))

    # ZeRO-3 from the same init: the loss and the reduced gradients
    # bit-equal, params and moments within 1e-6 of each leaf's max
    z3 = q_program(cfg, mesh, "cuda", zero3=True)
    zp = tree_map(lambda p, base, lay: partition.narrow_to(
        p, base, lay.pspec, mesh.coords_dict()), params, prog.param_specs,
        z3.layouts)  # init_fn's draws, cut as its init_fn cuts them
    zs = z3.init_state(zp)
    zloss, zgrads = z3.grad_fn(zp, batch)
    base_specs = prog.param_specs
    out["zero3_loss_equal"] = torch.equal(zloss, loss)
    out["zero3_grads_bad"], _ = q_common_equal(
        mesh, zgrads, tree_map(lambda l: l.zspec, z3.layouts), grads,
        tree_map(lambda l: l.zspec, prog.layouts), base_specs)
    zp1, zs1, _ = z3.update_fn(zp, zs, zloss, zgrads)
    del zgrads
    bad_p, worst_p = q_common_equal(mesh, zp1, z3.param_specs, p1,
                                    base_specs, base_specs, rel=1e-6)
    moments_bad, worst_m = [], 0.0
    for name in ("m", "v"):
        b, w = q_common_equal(mesh, getattr(zs1, name),
                              getattr(z3.opt_specs, name), getattr(s1, name),
                              getattr(prog.opt_specs, name), base_specs,
                              rel=1e-6)
        moments_bad += b
        worst_m = max(worst_m, w)
    out["zero3_params_bad"], out["zero3_moments_bad"] = bad_p, moments_bad
    out["zero3_worst"] = (worst_p, worst_m)
    z_local, b_local = dict(leaves_with_paths(zp)), \
        dict(leaves_with_paths(params))
    halves = [z_local[path].shape[dim] * mesh.data.size
              == b_local[path].shape[dim]
              for path, (dim, _) in z3.zero3.items()]
    out["zero3_leaves"] = len(z3.zero3)
    out["zero3_halves"] = all(halves) and bool(halves)
    del z3, zp, zs, zp1, zs1, z_local, b_local
    torch.cuda.empty_cache()

    # the all-reduce baseline from the same init
    ar = q_program(cfg, mesh, "cuda", reduction="allreduce")
    dataflow.reset_traffic()
    aloss, agrads = ar.grad_fn(params, batch)  # its specs are the ring's
    out["allreduce_grad_bytes"] = dataflow.TRAFFIC["bytes_sent"]
    out["allreduce_loss"] = aloss.item()
    out["allreduce_loss_equal"] = torch.equal(aloss, loss)
    out["vs_ring"] = q_leaf_sums(ar, agrads, grads, "the ring's",
                                 sliced=True)
    del ar, agrads, grads, p1, s1, params, state
    torch.cuda.empty_cache()

    # the counted ring steps from a new init of the same seed; the last
    # runs under the profiler (its busy share; its time not counted)
    params, state = prog.init_fn(SEED)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(Q_STEPS):
        for key in la.LAUNCHES:
            la.LAUNCHES[key] = 0
        dataflow.reset_traffic()
        result = []

        def run():
            result.append(prog.step_fn(params, state, batch))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profiled = q_busy(run) if i == Q_STEPS - 1 else run()
        torch.cuda.synchronize()
        params, state, metrics = result[0]
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "profiled": i == Q_STEPS - 1,
                      "loss": metrics["loss"].item(),
                      "launches": dict(la.LAUNCHES),
                      "bytes": dataflow.TRAFFIC["bytes_sent"],
                      "host_copies": dataflow.TRAFFIC["host_copies"]})
        if i == 0:
            out["repeat_equal"] = (
                (fingerprint(params), fingerprint(state))
                == out["first_fp"]
                and metrics["loss"].item() == steps[0]["loss"])
    out["busy"], out["top"], out["gemm_ms"] = profiled
    out["steps"] = steps
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, state, prog, batch, result
    torch.cuda.empty_cache()
    return out


def q_f32_job(la, arch, mesh, extra=None):
    """One float32 cut on this rank's mesh: the reduced config's first
    step (loss, gradients reduced and all-gathered, the params after it)
    on the card, on the CPU from the card's shards, and at tp = 1 on the
    card from the gathered global params (on the mesh's first rank).
    Returns each gate's largest figure and the card step's launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import optimizer as opt
    from repro_torch.runtime import partition
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(q_f32_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, aux_loss_coef=0.0))
    extra = extra or {}
    runs, start = {}, None
    for dev in ("cuda", "cpu"):
        prog = q_program(cfg, mesh, dev, **extra)
        if start is None:
            start = prog.init_fn(SEED)
            for key in la.LAUNCHES:
                la.LAUNCHES[key] = 0
        params, state = tree_map(lambda t: t.to(dev), start)
        loss, grads = prog.grad_fn(params, prog.shard_batch(
            train_batch(cfg, Q_F32_BATCH, Q_F32_SEQ, dev)))
        new_p, _, metrics = prog.update_fn(params, state, loss, grads)
        runs[dev] = (loss.item(),
                     tree_map(lambda g, lay: partition.gather_leaf(
                         g, lay.zspec, mesh).cpu(), grads, prog.layouts),
                     tree_map(lambda t, s: partition.gather_leaf(
                         t, s, mesh).cpu(), new_p, prog.param_specs),
                     metrics["lr"].item())
        if dev == "cuda":
            launches = dict(la.LAUNCHES)
            glob = tree_map(lambda t, s: partition.gather_leaf(t, s, mesh),
                            start[0], prog.param_specs)
    out = {"cpu": q_f32_diffs(runs["cuda"], runs["cpu"]),
           "launches": launches}
    if mesh.rank_index == 0:
        tcfg = TrainConfig(**TRAIN_CFG)
        one = train_program(cfg, "cuda")
        loss, grads = value_and_grad(one.loss_fn, glob, train_batch(
            cfg, Q_F32_BATCH, Q_F32_SEQ, "cuda"))
        compress = bool(extra.get("grad_compression"))
        state = opt.init_opt_state(glob, tcfg, compress)
        applied = grads
        if compress:
            qs, scales, err = opt.compress_gradients(grads, state.err)
            applied = opt.decompress_gradients(qs, scales)
            state = state._replace(err=err)
        new_p, _, metrics = opt.apply_updates(glob, applied, state, tcfg)
        out["tp1"] = q_f32_diffs(runs["cuda"], (
            loss.item(), tree_map(lambda t: t.cpu(), grads),
            tree_map(lambda t: t.cpu(), new_p), metrics["lr"].item()))
    del runs, start, glob
    return out


def q_f32_diffs(a, b):
    """(loss relative difference, the largest gradient leaf's max |diff|
    over its max |value|, the largest param |diff|, the largest param
    |diff| where the reference gradient is above ``Q_HELD`` of its leaf's
    max, lr) of two float32 first steps.  An AdamW first step moves a param
    by lr g / |g|: where g is at the sums' noise its sign is the noise's
    (a difference up to 2 lr), elsewhere the moves agree."""
    from repro_torch.tree import leaves

    loss_a, grads_a, params_a, _ = a
    loss_b, grads_b, params_b, lr = b
    grad = 0.0
    for x, y in zip(leaves(grads_a), leaves(grads_b)):
        if y.numel():
            scale = y.float().abs().max().item()
            grad = max(grad, (x.float() - y.float()).abs().max().item()
                       / max(scale, 1e-30))
    worst_p, worst_held = 0.0, 0.0
    for x, y, g in zip(leaves(params_a), leaves(params_b), leaves(grads_b)):
        if y.numel() and y.is_floating_point():
            diff = (x.float() - y.float()).abs()
            worst_p = max(worst_p, diff.max().item())
            held = g.float().abs() > Q_HELD * g.float().abs().max()
            if held.any():
                worst_held = max(worst_held, diff[held].max().item())
    return (abs(loss_a - loss_b) / abs(loss_b), grad, worst_p, worst_held,
            lr)


def q_rank(rank: int, world: int, ref):
    """Phase Q's rank program: gemma3-1b in bf16 on (2, 2), then the
    float32 cuts.  Every rank builds every mesh (``new_group`` is
    collective) and runs the jobs it belongs to."""
    import repro_torch.kernels.local_attention as la
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(2)  # four ranks share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*Q_MESH, backend="gloo", host_copies=True)
    t0 = time.perf_counter()
    out = {"coords": mesh.coords, "bf16": q_bf16(la, mesh, ref)}
    out["bf16_s"] = time.perf_counter() - t0
    if mesh.rank_index == 0:  # a trace of the run, should a later part fail
        b = out["bf16"]
        log(f"[Q] rank (0, 0): bf16 part {out['bf16_s']:.1f} s; first-step "
            f"loss {b['loss']}, counted steps "
            f"{[(round(s['ms'], 1), s['loss']) for s in b['steps']]}, ZeRO-3 "
            f"loss / gradients bit-equal {b['zero3_loss_equal']} / "
            f"{not b['zero3_grads_bad']}, failed checks {FAILURES}")
    t0 = time.perf_counter()
    pairs = [make_mesh(1, 2, backend="gloo", host_copies=True, ranks=r)
             for r in ((0, 1), (2, 3))]
    mine = next(m for m in pairs if m is not None)
    half = pairs.index(mine)
    out["f32"] = {}
    for arch in Q_F32_ARCHS[half::2]:
        out["f32"][arch] = q_f32_job(la, arch, mine)
        if mine.rank_index == 0:
            log(f"[Q] float32 {arch} on ranks {mine.both.ranks}: "
                f"{out['f32'][arch]}")
    import torch.distributed as dist

    dist.barrier()
    for name, extra in Q_F32_2X2:
        out["f32"][name] = q_f32_job(la, TRAIN_ARCH, mesh, extra)
    out["f32_s"] = time.perf_counter() - t0
    out["failures"] = list(FAILURES)
    return out


def q_rel_l2(results, key):
    """Per leaf, the relative L2 difference of one of ``q_leaf_sums``'
    comparisons, its ranks' sums added; and its largest max |diff| over
    max |ref|."""
    per = {}
    for res in results:
        for path, (d2, r2, dmax, rmax) in res["bf16"][key]["leaves"].items():
            a = per.setdefault(path, [0.0, 0.0, 0.0, 0.0])
            a[0] += d2
            a[1] += r2
            a[2] = max(a[2], dmax)
            a[3] = max(a[3], rmax)
    return {path: (float(np.sqrt(d2 / max(r2, 1e-30))), dmax / max(rmax, 1e-30))
            for path, (d2, r2, dmax, rmax) in per.items()}


def train_tp_phase(la, card, g_ref, results=None):
    """Phase Q: gemma3-1b trained at tp 2 on a (2, 2) mesh of 4 ranks
    sharing cuda:0 over gloo host copies, and the float32 cuts.
    ``results``: the ranks' results from phase P's spawn, else a spawn
    of phase Q's ranks alone.  Returns the kernels' launches in its
    counted steps and float32 cuts, summed over ranks, and each
    kernel's largest |diff| from its plain version."""
    import gc

    t_phase = time.perf_counter()
    from repro_torch.configs import get_config

    fwd_want, bwd_want = step_launches(get_config(TRAIN_ARCH))
    want = {"local_attention": fwd_want, "local_attention_f32": 0,
            "local_attention_bwd": bwd_want}
    if results is None:
        gc.collect()
        torch.cuda.empty_cache()
        results = [r["Q"] for r in pq_spawn(("Q",), g_ref)[0]]
    Q_REF_GRADS.unlink(missing_ok=True)
    for res in results:
        check(not res["failures"], f"[Q] rank {res['coords']}: failed "
              f"checks {res['failures']}")
    bf = [r["bf16"] for r in results]
    worst = {"local_attention": max(b["worst"]["local_attention"]
                                    for b in bf),
             "local_attention_bwd": max(b["worst"]["local_attention_bwd"]
                                        for b in bf)}
    for r, b in zip(results, bf):
        check(b["bwd_calls"] == bwd_want,
              f"[Q] rank {r['coords']}: {b['bwd_calls']} backward calls in "
              f"the first step, want {bwd_want}")
        check(b["loss"] == bf[0]["loss"],
              f"[Q] rank {r['coords']}: loss {b['loss']}, rank (0, 0) "
              f"{bf[0]['loss']}")
        check(b["repeat_equal"], f"[Q] rank {r['coords']}: the first step "
              "repeated from a new init of the seed differs")
        check(b["zero3_loss_equal"] and not b["zero3_grads_bad"],
              f"[Q] rank {r['coords']}: ZeRO-3's loss or reduced gradients "
              f"differ from the baseline's: {b['zero3_grads_bad']}")
        check(not b["zero3_params_bad"] and not b["zero3_moments_bad"],
              f"[Q] rank {r['coords']}: ZeRO-3's params {b['zero3_params_bad']}"
              f" or moments {b['zero3_moments_bad']} beyond 1e-6 of a leaf's "
              "max")
        check(b["zero3_leaves"] > 0 and b["zero3_halves"],
              f"[Q] rank {r['coords']}: {b['zero3_leaves']} ZeRO-3 leaves, "
              f"each half a rank: {b['zero3_halves']}")
        for i, step in enumerate(b["steps"]):
            check(step["launches"] == want,
                  f"[Q] rank {r['coords']} step {i + 1}: launches "
                  f"{step['launches']}, want {want}")
    loss = bf[0]["loss"]
    check(abs(loss - g_ref["loss"]) <= TOL_TRAIN_PLAIN_LOSS,
          f"[Q] first-step loss {loss} at tp 2, {g_ref['loss']} at tp = 1 "
          "(phase G)")
    vs_g = q_rel_l2(results, "vs_g")
    worst_g = max(vs_g.items(), key=lambda kv: kv[1][0])
    for path, (rel, _) in vs_g.items():
        check(rel <= TOL_TRAIN_PLAIN_GRAD,
              f"[Q] gradient {path} at tp 2 against phase G's at tp = 1: "
              f"relative L2 {rel}")
    a_loss = bf[0]["allreduce_loss"]
    check(abs(a_loss - loss) <= TOL_TRAIN_PLAIN_LOSS,
          f"[Q] all-reduce loss {a_loss}, ring {loss}")
    vs_ring = q_rel_l2(results, "vs_ring")
    worst_r = max(vs_ring.items(), key=lambda kv: kv[1][0])
    for path, (rel, _) in vs_ring.items():
        check(rel <= TOL_TRAIN_PLAIN_GRAD,
              f"[Q] all-reduce gradient {path} against the ring's: "
              f"relative L2 {rel}")
    losses = [s["loss"] for s in bf[0]["steps"]]
    for i in range(2):
        check(abs(losses[i] - g_ref["losses"][i]) <= TOL_TRAIN_PLAIN_LOSS,
              f"[Q] counted step {i + 1}: loss {losses[i]}, phase G's "
              f"{g_ref['losses'][i]}")
    launches = {}
    for b in bf:
        for step in b["steps"]:
            for key, n in step["launches"].items():
                launches[key] = launches.get(key, 0) + n
    log(f"[Q] {TRAIN_ARCH} bf16 at full width and depth on mesh {Q_MESH} "
        f"(ring, ZeRO-1 over both axes, remat full, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, 2 rows and 2 heads a rank): first-step loss {loss:.6f}"
        f" against phase G's {g_ref['loss']:.6f} (|diff| "
        f"{abs(loss - g_ref['loss']):.2e}, tolerance {TOL_TRAIN_PLAIN_LOSS});"
        f" gradients' relative L2 against phase G's at most "
        f"{worst_g[1][0]:.3e} ({worst_g[0]}; tolerance "
        f"{TOL_TRAIN_PLAIN_GRAD}); forward calls within "
        f"{worst['local_attention']:.3e} of plain, the {bwd_want} backward "
        f"calls a rank (q {bf[0]['bwd_shape']}) within "
        f"{worst['local_attention_bwd']:.3e}; repeat bit-equal on every "
        "rank")
    log(f"[Q] ZeRO-3 ({bf[0]['zero3_leaves']} leaves, each half a rank): "
        "loss and reduced gradients bit-equal to the baseline's, params "
        f"within {max(b['zero3_worst'][0] for b in bf):.2e} and moments "
        f"{max(b['zero3_worst'][1] for b in bf):.2e} of each leaf's max; "
        f"all-reduce: loss {a_loss:.6f} (|diff| {abs(a_loss - loss):.2e}),"
        f" gradients within {worst_r[1][0]:.3e} relative L2 of the ring's "
        f"({worst_r[0]})")
    for r, b in zip(results, bf):
        ms = [round(s["ms"], 1) for s in b["steps"]]
        log(f"[Q] rank {r['coords']}: init {b['init_s']:.1f} s, checked "
            f"first gradient {b['checked_grad_s']:.1f} s; counted steps ms "
            f"{ms} (the last under the profiler), losses "
            f"{[round(s['loss'], 4) for s in b['steps']]}; bytes sent a "
            f"step {[s['bytes'] for s in b['steps']]}, host round trips "
            f"{b['steps'][0]['host_copies']}; a gradient's bytes ring "
            f"{b['ring_grad_bytes']} / all-reduce {b['allreduce_grad_bytes']}"
            f" ({b['ring_grad_bytes'] / b['allreduce_grad_bytes']:.3f}x); "
            "busy " + ("not measured" if b["busy"] is None
                       else f"{100 * b['busy']:.2f}%")
            + f"; peak {b['peak_gb']:.2f} GB; bf16 part {r['bf16_s']:.1f} s "
            f"({P_SHARED}) on {card}")
        log(f"[Q] rank {r['coords']}: the profiled step's kernels with gemm "
            f"in their names {b['gemm_ms']:.3f} ms device time; its top "
            f"{Q_TOP} kernels (name, launches, ms): "
            + "; ".join(f"{n} x{c} {ms:.3f}" for n, c, ms in b["top"]))
    log(f"[Q] counted losses {[round(x, 4) for x in losses]} beside phase "
        f"G's {[round(x, 4) for x in g_ref['losses'][:Q_STEPS]]}")

    # the float32 cuts
    f32_worst = [0.0] * 4
    for r in results:
        for name, job in r["f32"].items():
            for against in ("cpu", "tp1"):
                if against not in job:
                    continue
                lr_, grad, worst_p, held, lr = job[against]
                for i, v in enumerate((lr_, grad, worst_p, held)):
                    f32_worst[i] = max(f32_worst[i], v)
                check(lr_ <= TOL_TRAIN_F32_LOSS and grad <= TOL_TRAIN_F32_GRAD
                      and worst_p <= 2 * lr * (1 + 1e-3)
                      and held <= lr / 1000,
                      f"[Q] float32 {name} on rank {r['coords']} against "
                      f"{against}: loss {lr_:.2e}, gradients {grad:.2e}, "
                      f"params {worst_p:.2e} (lr {lr}), {held:.2e} where "
                      f"the gradient is above {Q_HELD} of its leaf's max")
            fw, bw = step_launches(q_f32_config(
                name if name in Q_F32_ARCHS else TRAIN_ARCH))
            got = job["launches"]
            check(got.get("local_attention_f32", 0) == fw
                  and got.get("local_attention_bwd", 0) == bw
                  and got.get("local_attention", 0) == 0,
                  f"[Q] float32 {name} on rank {r['coords']}: launches "
                  f"{got}, want {fw} forward and {bw} backward (float32)")
            for key, n in got.items():
                launches[key] = launches.get(key, 0) + n
    log(f"[Q] float32 cuts ({len(Q_F32_ARCHS)} families at tp 2 on (1, 2), "
        f"gemma3 with {[n for n, _ in Q_F32_2X2]} on (2, 2); batch "
        f"{Q_F32_BATCH} x {Q_F32_SEQ}, TF32 off), against the CPU's ranks "
        f"and tp = 1: loss within {f32_worst[0]:.2e}, gradients "
        f"{f32_worst[1]:.2e} of a leaf's max, params {f32_worst[2]:.2e} "
        f"(within 2 lr), {f32_worst[3]:.2e} where the gradient is above "
        f"{Q_HELD} of its leaf's max (within lr / 1000); "
        f"{max(r['f32_s'] for r in results):.1f} s")
    log(f"[Q] phase Q: ranks {max(r['part_s'] for r in results):.1f} s, "
        f"{time.perf_counter() - t_phase:.1f} s in this process on {card}; "
        f"launches {launches}")
    step_bytes = {r["coords"]: b["steps"][0]["bytes"]
                  for r, b in zip(results, bf)}
    return launches, worst, step_bytes


def q_f32_config(name):
    """A float32 cut's config: the family's reduced config, gemma3's for
    the (2, 2) cuts; deepseek's ``mla_small`` (its reduced config's MLA
    head dims, 24 and 16, are not among the kernel's pairs) at the
    reduced configs' capacity factor of 4, so that no pair drops and
    tp = 2 routes what tp = 1 routes."""
    from repro_torch.configs import get_config

    if name == MLA_ARCH:
        cfg = mla_small()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    return get_config(name if name in Q_F32_ARCHS else TRAIN_ARCH).reduced()


# ---------------------------------------------------------------------------
# Phase X: the dry run against the card's own counts
# ---------------------------------------------------------------------------

#: phase P's job whose per-rank bytes phase X holds its dry run to
X_P_ARCH, X_P_FLAVOR = "gemma3-1b", "bf16-ring"
#: phase X's memory gates, stated before its first run: the dry run's
#: args + temp peak (``OpStats``: the resident trees and the peak of the
#: storages the program makes) within these shares of the card's
#: ``max_memory_allocated`` over the same program (the caching
#: allocator rounds each block up to 512 bytes; phase G's steps also
#: hold the step's metrics and the checkpoint's host snapshot)
TOL_X_PREFILL_MEM = 0.05
TOL_X_TRAIN_MEM = 0.10


def x_cells():
    """Phase X's dry cells, (label, kwargs of ``dry_cell``): phase 5's
    gemma3-1b bf16 prefill at tp = 1; phase G's step (functional, as
    phase G steps); phases P and Q's ring cells on (2, 2), rank 0."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig, \
        TrainConfig

    prefill = ShapeConfig("x_prefill", LM_PROMPT, LM_BATCH, "prefill")
    train = ShapeConfig("x_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(**TRAIN_CFG)
    return (
        ("a", dict(arch=LM_ARCH, shape=prefill, mesh_shape=(1, 1),
                   pcfg=ParallelConfig(), s_max=LM_PROMPT + LM_GEN + 1)),
        ("b", dict(arch=TRAIN_ARCH, shape=train, mesh_shape=(1, 1),
                   pcfg=ParallelConfig(remat="full"), tcfg=tcfg,
                   donate=False)),
        ("c_serve", dict(arch=X_P_ARCH, shape=prefill, mesh_shape=(2, 2),
                         pcfg=ParallelConfig(reduction="ring"),
                         s_max=LM_PROMPT + P_GEN + 1)),
        ("c_train", dict(arch=TRAIN_ARCH, shape=train, mesh_shape=Q_MESH,
                         pcfg=ParallelConfig(reduction="ring",
                                             remat="full"),
                         tcfg=tcfg, donate=False)),
    )


def x_dry_runs():
    """Phase X's dry runs, in a process of their own (fake tensors on
    "cuda", a fake process group; nothing runs on the card): label ->
    (the roofline row, seconds)."""
    from repro_torch.launch.dryrun_lib import analyze_cell, dry_cell

    torch.set_num_threads(1)
    out = {}
    for label, kw in x_cells():
        run = dry_cell(**kw, device="cuda")
        out[label] = (analyze_cell(run, kw["arch"], kw["shape"].name,
                                   str(kw["mesh_shape"])), run.seconds)
    return out


def x_child(conn):
    """Phase X's dry-run process: its rows, or its traceback, to the
    parent."""
    try:
        conn.send(("ok", x_dry_runs()))
    except BaseException:
        import traceback

        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def x_start():
    """Start phase X's dry runs beside phases P and Q, after phase G's
    timed steps: they are host work, in one process (a daemon: it ends
    with this one) that exits when they are done."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=x_child, args=(child,), daemon=True)
    proc.start()
    child.close()
    return proc, parent, time.perf_counter()


def dryrun_phase(la, dry, card, lm, g_ref, p_bytes, q_bytes):
    """Phase X: the dry runs (``launch/dryrun_lib.py``, started by
    ``x_start``) held against the card's counts.  (a) phase 5's prefill
    once more, untimed, under ``OpStats`` on the card: flops (all, and
    by dtype), HBM bytes and per-kernel calls equal the dry run's, the
    calls the LAUNCHES
    delta, the dry run's memory within TOL_X_PREFILL_MEM of the card's
    peak; the roofline's bound beside phase 5's prefill.  (b) phase G's
    step: the dry run's kernel calls phase G's launches a step, its
    memory within TOL_X_TRAIN_MEM of phase G's peak.  (c) the wire bytes
    of rank 0 of phases P's and Q's ring cells equal to the byte."""
    import gc

    from repro_torch.analysis.op_stats import OpStats, storage_bytes
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    proc, conn, t_start = dry
    status, rows = conn.recv()
    proc.join()
    if status != "ok":
        fail(f"[X] the dry runs failed:\n{rows}")
    log(f"[X] dry runs (one process, fake tensors, a fake process group; "
        f"started before phase P): "
        + ", ".join(f"{k} {s:.1f} s" for k, (_, s) in rows.items())
        + f"; waited {time.perf_counter() - t_phase:.1f} s for them")
    for label, (row, _) in rows.items():
        mem = row["memory"]
        log(f"[X] dry {label}: {row['arch']} {row['shape']} on "
            f"{row['mesh']}: flops {row['hlo_flops_per_dev']:.6e}, HBM "
            f"bytes {row['bytes_per_dev']:.6e}, wire bytes "
            f"{row['wire_bytes_per_dev']:.0f} {row['op_counts']}, flops by "
            f"dtype {row['flops_by_dtype']}, kernels "
            f"{row['kernels']}; memory args {mem['args_GB']:.3f} + temp "
            f"{mem['temp_GB']:.3f} = {mem['total_GB']:.3f} GB; bound "
            f"{max(row['t_compute_s'], row['t_memory_s'], row['t_collective_s']) * 1e3:.4f}"
            f" ms ({row['bottleneck']})")

    # (a) phase 5's prefill, counted on the card
    row = rows["a"][0]
    cfg = get_config(LM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    prog, params, batch = lm_program(cfg, LM_BATCH, LM_PROMPT, LM_GEN,
                                     "bfloat16", False, "cuda",
                                     torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what else the process holds, beside the prefill's params and batch
    base = torch.cuda.memory_allocated() - storage_bytes((params, batch))
    before = dict(la.LAUNCHES)
    with OpStats(resident=(params, batch)) as st:
        prog.prefill_fn(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    delta = {k: la.LAUNCHES[k] - before[k] for k in before
             if la.LAUNCHES[k] != before[k]}
    dry_calls = {k: v["calls"] for k, v in row["kernels"].items()}
    card_by_dtype = {k: float(v) for k, v in st.flops_by_dtype.items()}
    check(float(st.flops) == row["hlo_flops_per_dev"]
          and card_by_dtype == row["flops_by_dtype"]
          and float(st.hbm_bytes) == row["bytes_per_dev"],
          f"[X] (a) flops (by dtype) / HBM bytes: card {st.flops} "
          f"({card_by_dtype}) / {st.hbm_bytes}, dry run "
          f"{row['hlo_flops_per_dev']} ({row['flops_by_dtype']}) / "
          f"{row['bytes_per_dev']}")
    check(st.calls() == dry_calls == delta and delta,
          f"[X] (a) kernel calls: card {st.calls()}, dry run {dry_calls}, "
          f"LAUNCHES delta {delta}")
    total = row["memory"]["total_GB"] * 1e9
    check(abs(total - peak) <= TOL_X_PREFILL_MEM * peak,
          f"[X] (a) memory: dry run {total / 1e9:.3f} GB, card "
          f"{peak / 1e9:.3f} GB (tolerance {TOL_X_PREFILL_MEM})")
    del prog, params, batch
    torch.cuda.empty_cache()
    bound = max(row["t_compute_s"], row["t_memory_s"],
                row["t_collective_s"]) * 1e3
    measured = float(np.median(lm["bf16"]["prefill_ms"]))
    log(f"[X] (a) {LM_ARCH} bf16 prefill {LM_BATCH} x {LM_PROMPT}: card "
        f"flops {st.flops} ({card_by_dtype}), HBM bytes {st.hbm_bytes}, "
        f"kernel calls "
        f"{st.calls()} = LAUNCHES delta, all equal to the dry run's; peak "
        f"{peak / 1e9:.3f} GB against the dry run's {total / 1e9:.3f} "
        f"({(total - peak) / peak:+.2%}); roofline bound {bound:.4f} ms "
        f"({row['bottleneck']}: compute {row['t_compute_s'] * 1e3:.4f}, "
        f"memory {row['t_memory_s'] * 1e3:.4f} ms) against phase 5's "
        f"prefill {measured:.3f} ms: {bound / measured:.2%} of it, on "
        f"{card}")

    # (b) phase G's step
    row = rows["b"][0]
    want = {k: v for k, v in g_ref["launches"].items() if v}
    dry_calls = {k: v["calls"] for k, v in row["kernels"].items()}
    check(dry_calls == want, f"[X] (b) dry run's kernel calls {dry_calls}, "
                             f"phase G's launches a step {want}")
    total, peak = row["memory"]["total_GB"] * 1e9, g_ref["peak_program"]
    check(abs(total - peak) <= TOL_X_TRAIN_MEM * peak,
          f"[X] (b) memory: dry run {total / 1e9:.3f} GB, phase G's peak "
          f"{peak / 1e9:.3f} GB (tolerance {TOL_X_TRAIN_MEM})")
    log(f"[X] (b) {TRAIN_ARCH} step {TRAIN_BATCH} x {TRAIN_SEQ}: dry run's "
        f"kernel calls {dry_calls} = phase G's launches a step; memory "
        f"{total / 1e9:.3f} GB against phase G's peak {peak / 1e9:.3f} GB "
        f"({(total - peak) / peak:+.2%}); roofline bound "
        f"{max(row['t_compute_s'], row['t_memory_s']) * 1e3:.4f} ms "
        f"({row['bottleneck']})")

    # (c) the ring cells' wire bytes, rank 0
    for label, counted, what in (("c_serve", p_bytes, "phase P's prefill"),
                                 ("c_train", q_bytes, "phase Q's step")):
        wire = rows[label][0]["wire_bytes_per_dev"]
        check(wire == counted[(0, 0)],
              f"[X] ({label}) wire bytes: dry run {wire}, {what} "
              f"{counted[(0, 0)]} at rank (0, 0)")
        log(f"[X] ({label}) wire bytes of rank (0, 0): dry run {wire:.0f},"
            f" {what} {counted[(0, 0)]}; every rank's {counted}")
    log(f"[X] phase X: {time.perf_counter() - t_phase:.1f} s on {card} "
        f"(the dry runs' process {time.perf_counter() - t_start:.1f} s "
        "since its start, beside phases P and Q)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.kernels.cim_matmul as km
    import repro_torch.kernels.local_attention as la
    import repro_torch.kernels.selective_scan as ss
    from repro_torch.configs import get_config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        builds = [pool.submit(fn) for fn in (km.build, la.build, la.build_bwd,
                                             ss.build, ss.build_bwd)]
        for fut in builds:
            lib, build_log = fut.result()
            log(f"[build] {lib.name} after {time.perf_counter() - t0:.1f} s")
            for line in build_log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {line.strip()}")
    check_cim_sass(km.build()[0])
    check_bwd_sass(la.build_bwd()[0])
    check_scan_bwd_sass(ss, ss.build_bwd()[0])
    if "--only-tp" in sys.argv[1:]:
        # phase P alone, for work on the tp > 1 path: no result line
        tp_phase(la, ss, card)
        if FAILURES:
            fail(f"{len(FAILURES)} checks failed: {FAILURES}")
        log("[P] --only-tp: phase P passed; the other phases did not run")
        return 2
    if "--only-train-tp" in sys.argv[1:]:
        # phase Q alone (phase G's first step as its yardstick) and F2's
        # float32 curves: no result line
        train_tp_phase(la, card, q_reference(get_config(TRAIN_ARCH)))
        f2_curve(card)
        if FAILURES:
            fail(f"{len(FAILURES)} checks failed: {FAILURES}")
        log("[Q] --only-train-tp: phase Q passed; the other phases did not "
            "run")
        return 2
    if "--only-interp" in sys.argv[1:]:
        # phase C alone, for work on the interpreter: no result line
        interp_phase(km, card)
        log("[C] --only-interp: phase C passed; the other phases did not run")
        return 2

    sim, frames, launches, wall, calls, reps = main_path(km)
    # nominal again, after the variation run: separates the flavor from
    # the order of the runs in the wall-time comparison
    sim.set_variation(None)
    walls = serving_walls(sim, frames)
    wall["nominal_again"] = float(np.median(walls))
    log(f"[e2e] nominal again: wall ms/frame median "
        f"{wall['nominal_again'] * 1e3:.4f}, all "
        f"{[round(v * 1e3, 4) for v in walls]}")
    device_share(sim, frames)
    # phase J on vgg11: phase 2's simulator, params and frames
    from repro_torch.convert import params_from_reference
    from repro_torch.runtime.serve_loop import quantize_cnn_params_for_serving

    t_jit = time.perf_counter()
    qparams = quantize_cnn_params_for_serving(
        params_from_reference(cnn_inputs()[1], "cuda"))
    jit_rows = {"vgg11-cifar10": jit_model(
        km, "vgg11-cifar10", sim, qparams, frames, reps["nominal"], card,
        variation_logits=reps["variation"].logits)}
    del qparams
    percell(sim, frames, reps["nominal"].arrivals, "vgg11-cifar10", card)
    exact_jit(card)
    cim_mode(km, "vgg11-cifar10", card)
    jit_s = time.perf_counter() - t_jit
    # phase M: launches of every counted main-path run, summed by kernel
    main_launches = {name: launches["nominal" if name == "cim_codes"
                                    else "variation"][name]
                     for name in km.LAUNCHES}
    worst_models = dict.fromkeys(km.LAUNCHES, 0.0)
    t_models = time.perf_counter()
    for name in MODELS:
        counted, worst_m, jit_rows[name] = model_phase(km, name, card)
        for each in counted.values():
            for k, v in each.items():
                main_launches[k] += v
        for k, v in worst_m.items():
            worst_models[k] = max(worst_models[k], v)
    log(f"[models] {len(MODELS)} models served at full width in "
        f"{time.perf_counter() - t_models:.1f} s (phase J's parts included); "
        f"main-path launches (phases 2 and M) {main_launches} on {card}")
    t0 = time.perf_counter()
    cim_mode(km, "vgg16-imagenet", card)
    jit_s += time.perf_counter() - t0
    for name, row in jit_rows.items():
        log(f"[jit] {name}: wall ms/frame jit {row['wall_jit'] * 1e3:.4f} "
            f"against non-jit {row['wall_plain'] * 1e3:.4f}; numerics pass "
            f"{row['numerics_jit'] * 1e3:.1f} against "
            f"{row['numerics_plain'] * 1e3:.1f} ms; {row['graphs']} graphs, "
            f"{row['replayed_per_batch']} replayed launches a batch, capture "
            f"{row['capture_s']:.2f} s; busy "
            + ("not measured" if row["busy"] is None
               else f"{100 * row['busy']:.2f}%") + f" on {card}")
    log(f"[jit] phase J outside phase M: {jit_s:.1f} s on {card}")
    worst = check_kernels(km, calls)
    rows = time_kernels(km, calls, card)
    robustness_phase(km, len(calls["cim_codes"]), card)
    dse_phase(km, card)
    c_launches, c_worst = interp_phase(km, card)
    for k, v in c_launches.items():
        main_launches[k] += v
    telemetry_phase(km, len(calls["cim_codes"]), wall["nominal"], card)
    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": main_launches[name],
            "max_abs_err": max(worst[name], worst_models[name],
                               c_worst[name]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    t_lm = time.perf_counter()
    lm, attn_calls = lm_serving(la)
    f32_launches = lm_full_f32_first_tokens(la)
    lm_reduced_vs_cpu(dataclasses.replace(get_config(LM_ARCH),
                                          num_layers=SMALL_LAYERS))
    worst_attn = check_attention(la, attn_calls)
    attn = time_attention(la, attn_calls, card)
    log(f"[lm] {LM_ARCH} serving phases took "
        f"{time.perf_counter() - t_lm:.1f} s; median prefill ms / decode "
        f"ms per token / tokens per s: "
        + "; ".join(f"{k} {np.median(v['prefill_ms']):.3f} / "
                    f"{np.median(v['decode_ms']):.4f} / {v['tok_s']:.1f}"
                    for k, v in lm.items()) + f" on {card}")
    scan_row, family_attn, worst_family = families_phase(la, ss, card)
    e_attn, worst_e = encdec_vlm_phase(la, ss, card)
    bwd_row, g_attn, g_ref = training_phase(la, card)
    scan_bwd_row, h_launches = families_training_phase(la, ss, card)
    f2_curve(card)
    mla_row, i_launches, i_worst = mla_encdec_training_phase(la, ss, card)
    dry = x_start()  # phase X's dry runs: host work beside P and Q
    # one spawn of ranks for phases P and Q
    p_launches, p_worst, p_bytes, q_ranks = tp_phase(la, ss, card, g_ref)
    q_launches, q_worst, q_bytes = train_tp_phase(la, card, g_ref, q_ranks)
    dryrun_phase(la, dry, card, lm, g_ref, p_bytes, q_bytes)
    # phases 5 and 6 (gemma3) and the counted runs of phases F, E, G, H,
    # I and P (P's summed over its ranks)
    launches_attn = {"local_attention": lm["bf16"]["launches"]
                     + family_attn + e_attn + g_attn
                     + h_launches["local_attention"]
                     + i_launches["local_attention"]
                     + p_launches.get("local_attention", 0)
                     + q_launches.get("local_attention", 0),
                     "local_attention_f32": f32_launches
                     + q_launches.get("local_attention_f32", 0)}
    scan_row["launches"] += (h_launches["selective_scan"]
                             + p_launches.get("selective_scan", 0))
    bwd_row["launches"] += (h_launches["local_attention_bwd"]
                            + i_launches["local_attention_bwd"]
                            + q_launches.get("local_attention_bwd", 0))
    # the backward's times: deepseek's (192, 128) call (phase I); gemma3's
    # step is logged in phase G
    bwd_row.update(mla_row)
    bwd_row["max_abs_err"] = max(bwd_row["max_abs_err"], i_worst,
                                 q_worst["local_attention_bwd"])
    for name in worst_attn:
        worst_attn[name] = max(worst_attn[name], worst_family.get(name, 0.0),
                               worst_e.get(name, 0.0),
                               p_worst.get(name, 0.0),
                               q_worst.get(name, 0.0))
    scan_row["max_abs_err"] = max(scan_row["max_abs_err"],
                                  p_worst.get("selective_scan", 0.0))
    for name, row in attn.items():
        kernels.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ATTN_REPLACES, "launches": launches_attn[name],
            "max_abs_err": worst_attn[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    kernels.append(scan_row)
    kernels.append(bwd_row)
    kernels.append(scan_bwd_row)
    for name, label in (("local_attention", "bfloat16"),
                        ("local_attention_f32", "float32")):
        row = attn[name]
        log(f"[attention] {label} kernel per prefill: {row['ms']:.4f} ms, "
            f"{row['tflops_unmasked']:.1f} TFLOP/s on unmasked work "
            f"({row['tflops_computed']:.1f} on computed work), "
            f"{100 * row['share_of_bound']:.1f}% of the "
            f"{row['bound_ms']:.4f} ms bound; SDPA with the band mask "
            f"{row['library_ms']:.4f} ms, with is_causal on the global "
            f"launches {row['library_causal_ms']:.4f} ms; plain "
            f"{row['plain_ms']:.4f} ms on {card}")
    if FAILURES:
        fail(f"{len(FAILURES)} LM checks failed: {FAILURES}")
    log(f"[e2e] wall per frame (ms, median of {WALL_REPS} runs): nominal "
        f"{wall['nominal'] * 1e3:.4f}, variation "
        f"{wall['variation'] * 1e3:.4f}, nominal again "
        f"{wall['nominal_again'] * 1e3:.4f} on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
