#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`avec_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # build, check, serve, train, time
    python3 chip_smoke.py --profile  # also trace one served forward and one
                                     # train step of each training path

Phases, in order; any failure raises and the exit code is non-zero:
 1. device and build: require CUDA, print the card's name and power limit,
    build the CUDA kernels from `avec_tpu_torch/csrc` (nvcc, sm_90a) and
    print each kernel's registers and spill bytes as ptxas reports them;
 2. each kernel against its plain PyTorch version at the serving shapes, in
    fp32 (max abs <= 1e-4) and bf16 (flash <= 2e-2, stem exact), the stem
    also on odd frames (45x43x64, 3x5x8); the bf16 flash forward's out and
    lse bit-identical over two calls and its out within a relative L1 error
    of 1e-4 (p enters P V as three bf16 parts), printed beside the same call
    with p rounded to bf16 (a control build);
 3. serving at full width: the reference-depth AV model (61.7M params,
    vocab 256, use_flash, stem "pallas", seeded random weights and BN
    statistics) answers 8 seeded requests of 2-6 s in rounds; the flash
    kernel must launch 7 times and the stem kernel once per forward; the
    same batch through the kernels' plain versions in fp32 must give logits
    within 2e-3 and identical greedy token ids;
 4. kernel timings (CUDA events) beside their bounds (the stem's as a
    multiple of it), the plain versions and a PyTorch library call where
    one computes the same function (for the flash forward SDPA on the same
    inputs and on their copies zero-padded to widths of a multiple of 8,
    each with its device time, the backend its kernel names show and its
    error against the plain version, the faster form with a finite output
    the yardstick), the flash forward's device time by kernel (prep, main);
 5. the training kernels against their plain versions at the training
    shapes: fused FFN forward and backward for (d, F) = (180, 720),
    (256, 1024), (360, 1440) at N = 16 x T rows, fp32 and bf16, dropout off
    and 0.1 with a fixed seed (the hash masks must agree exactly); flash
    backward at (T, D) = (151, 256) and (76, 360) with ragged lengths down to
    1 and one 0, the flash forward at those inputs too (max abs, fp32 1e-4,
    bf16 2e-2, with phase 2's bf16 checks). Every other error is the max abs
    difference over the largest entry
    of the plain result: fp32 1e-4 (y, dx, dq', dk', dv) and 3e-4 (FFN
    parameter gradients, atomic sums over thousands of rows); bf16 2e-2 and
    3e-2; the bf16 FFN forward and flash backward bit-identical over two
    calls; the bf16 flash backward's relative L1 error (sum |got - want| /
    sum |want|) within 1e-4 (p and dS enter its products as three bf16
    parts), printed beside the same call with p and dS rounded to bf16;
 6. training at full width: the same 61.7M-parameter model, use_flash, fused
    FFN (`fused_ffn=True`), stem "2d", bf16 compute on fp32 parameters, B=16 utterances of
    3-6 s in 6 s of padding (151 frames of 88x88, 32 labels), dropout 0.1 and
    SpecAugment on: 1 warm-up + 3 counted steps. Losses and gradient norm
    must be finite, every parameter must have a gradient, at least 99% of
    the leaves and every BN running statistic must move, and the launches
    per step must equal the counts derived from the module tree. Then, in
    fp32 with dropout and SpecAugment off, one forward + backward through
    the kernels against one through their plain versions: total loss and
    gradient norm within 1e-3, every gradient leaf within 2e-3 of its
    largest entry, every BN running statistic within 1e-5;
 7. train-step time, utterances/s and peak memory with the kernels and with
    their plain versions (interleaved), and each training kernel's time at
    the step's shapes beside its bound, plain version and library call (for
    K1 / K1b the port's own unfused feed-forward module, the `fused_ffn=False`
    route, forward and backward; for K4b SDPA's backward alone, its forward
    made outside the timed call, with the backend its kernel names show);
    K1's and K4b's device time by kernel (K1's three stages; K4b's prep, dq
    and dk/dV) and the host's time to issue a call, beside the time through
    the wrapper.
 8. the fused attention module's kernels (K2 forward, K2b backward) against
    the plain version at (B, T, d, H) = (16, 151, 256, 4) and (16, 76, 360,
    4), fp32 and bf16, lengths from T down to 1 and one 0, dropout 0 and 0.1
    (exactly the hash mask's entries dropped on both sides), with and without
    the residual: y, dx and every parameter gradient, max abs over the
    largest entry; fp32 1e-4 (y) and 5e-4 (gradients), bf16 2e-2 and 3e-2;
 9. the train-mode stem (`fused_stem_train`) on the card, B=16 x 151 frames,
    kernel route against plain route: pooled (fp32 1e-5, bf16 exact), mean,
    var, the gradients of the conv weight, BN scale and BN bias, and a
    conv-bias gradient of exactly zero; then the stem kernel's time at that
    shape (2416 frames) as a multiple of its bound;
10. training at full width through those kernels: fused attention, fused
    FFN (both switched on explicitly), stem "pallas", use_flash off: the
    launch counts per step must be 19 + 19 attention, 48 + 48 FFN, 1 stem
    and no flash; 1 warm-up + 3 counted steps with the checks of phase 6;
    then fp32 kernels against plain versions (loss 1e-5, gradient norm
    1e-3, every leaf 2e-3, BN statistics 1e-5);
11. step time, utterances/s and peak memory of that path and of phase 6's
    path, interleaved in this one call, and the attention kernels' times per
    launch and per step beside their bounds, the plain version and the
    port's own unfused attention module (PyTorch library calls); K2's and
    K2b's device time by stage kernel and the host's time to issue a call
    (K2 through its wrapper and through its C entry alone); the bf16 calls
    at the step's shapes must run K2's tensor-core stages (no mma.sync
    q/k/v or forward attention stage);
12. the fused convolution module's kernels (K3-stats, K3-fwd, K3b-1, K3b-2)
    against the plain stages at (B, T, d = E, k) = (16, 301, 180, 15),
    (16, 151, 256, 15) and (16, 76, 360, 15), fp32 and bf16, padding "same"
    and "causal", dropout 0 and 0.1 (exactly the hash mask's entries dropped
    on both sides): y, mean, var, dx and the ten parameter gradients, max abs
    over the largest entry; fp32 1e-4 (y, mean, var) and 5e-4 (gradients),
    bf16 2e-2 and 3e-2; the depthwise-bias gradient exactly zero; K3-stats's
    s1 and s2 bit-identical over two calls, fp32 and bf16; in bf16,
    K3-fwd's y, K3b-1's dW2, db2, r1, r2 and K3b-2's dx and five gradients
    bit-identical over two calls on the same inputs;
13. training at full width through all the training kernels: fused
    convolution module, fused attention, fused FFN (all three switched on
    explicitly), stem "pallas", use_flash off: the launch counts per step
    must be 21 of each conv kernel, 19 + 19 attention, 48 + 48 FFN, 1 stem
    and no flash; 1 warm-up + 3 counted steps with the checks of phase 6;
    then fp32 kernels against plain versions (loss 1e-5, gradient norm
    1e-3, every leaf 2e-3, BN statistics 1e-5);
14. K3 / K3b times per launch and per step beside their device times,
    bounds, the plain stages and the port's own unfused convolution module
    (PyTorch library calls), each pass's device time by kernel (K3-stats's
    five, K3-fwd's five, K3b-1's seven and K3b-2's nine stages; in bf16
    K3-stats must sum its partials in `conv_reduce_kernel`, K3-fwd must run
    its `wgmma` pw2 and no `conv_pw2_kernel`, K3b-1 no FMA product stage)
    and
    the host's time to issue each pass, and step time,
    utterances/s and peak memory of phase 13's path
    and phase 10's path (they differ by `fused_conv` alone), interleaved;
15. K3dp on two gloo ranks sharing the card (`avec_tpu_torch.parallel.dist
    .spawn`): each rank runs the four conv passes on its half of phase 12's
    (16, T, d) inputs with the statistics all-reduced between them, against
    the plain DP stages on the card (masks of the rank's seed identical at
    dropout 0.1) and, at dropout 0, y and dx concatenated, mean and var, and
    the parameter gradients summed over the ranks against one K3/K3b call on
    the whole batch: fp32 1e-4 (y, mean, var) and 5e-4 (gradients), bf16
    2e-2 and 3e-2; then, at the step's B=8 shapes, the port's unfused module
    under sync-BN and the all-reduce of the (2E,) statistics over gloo;
16. data-parallel training at full width: the same model, `data_parallel`,
    fused conv (K3dp), fused attention, fused FFN, stem "2d", bf16, the 16
    utterances of phase 6 split 8 + 8 over two gloo ranks on the card: 1
    warm-up + 3 counted steps with the checks of phase 6 on each rank, 21 of
    each K3dp pass, 19 + 19 attention and 48 + 48 FFN launches per step and
    rank, parameters bit-identical across the ranks after the steps; then an
    fp32 step with dropout and SpecAugment off against the single-process
    step on the same utterances (loss 1e-5, gradient norm 1e-3, every leaf
    2e-3, BN statistics 1e-5); step ms, global utterances/s and peak memory
    per rank, two ranks time-sliced on one card (not a data-parallel speed);
17. NCCL at world size 1: the data-parallel trainer against the plain one,
    fp32, dropout off, the same 16 utterances: through the kernels' plain
    versions with cuDNN deterministic, losses and every gradient leaf (over
    its largest entry) within 1e-6; through the kernels, losses within 1e-6
    and the gradients printed beside the plain trainer's own run-to-run
    floor (the kernels' atomic sums vary in their last bits);
then the K3dp passes' times per rank at the B=8 shapes beside their
bounds and plain stages;
18. the AV-Tone learning run (`avec_tpu_torch/configs/av_tone.py`, the
    config's depth v (2, 1), a (2, 2, 1), f 2 at the flagship's widths,
    vocab 32) through the training engine on the fused-conv route (fused
    FFN, attention and convolution modules, stem "pallas"), bf16 on fp32
    parameters, dropout and SpecAugment on: the WER of the 64 evaluation
    utterances through the config's decoder (beam 8, the 2-gram, GPT
    rescoring by phase 24's LM-Tone) at init; `fit` for 2 epochs of 400
    steps of 16
    utterances with an EMA (tau 0.99), a checkpoint (under `build/`, removed
    at the end) and an evaluation, plain and EMA, per epoch; the launches
    of the 800 steps equal to the counts per step from the module tree; the
    last checkpoint reloaded into a fresh setup gives bit-identical bf16
    logits; the audio-alone control (video zeroed; printed, not asserted);
    SWA over both epochs and its WER. Every WER after training (plain, EMA,
    SWA) must be below the WER at init, and after the last epoch at most 10
    (plain, SWA) and 20 (EMA). Printed: the WERs, the step's median
    ms (synchronized around each step) and utterances/s, peak GiB, the
    phase's wall time; details under `learning_run` in
    chiprun_out/chip_smoke.json.
19. the audio-only model (configs/LRS23/AO/EffConfCTC.py: vocab 256, patch
    attention, blocks (5, 6, 5), no InterCTC; seeded weights and BN
    statistics): served through `Server(mode="ao")` with `use_flash`, 8
    requests of 3.7-6 s in the 8 s bucket in ROUNDS batches, 11 flash
    launches per forward, fp32 kernels against plain versions (logits 2e-3,
    identical greedy ids); then trained on the fused-conv route (fused FFN,
    attention and convolution modules) at B=16 / 6 s: the launches per step
    from the module tree (32 + 32 FFN, 11 + 11 attention, 14 of each conv
    pass), 1 warm-up + 3 counted steps with the checks of phase 6 and the
    fp32 comparison of phase 13 (loss 1e-5, gradient norm 1e-3, every leaf
    2e-3, BN statistics 1e-5);
20. the causal audio-only model at the same widths and depth (`causal`,
    left context 64): trained likewise (32 + 32 FFN and 14 of each conv
    pass at pad_lo 14; its Transformer-XL attention takes no kernel), then
    in eval, fp32: audio changed after sample 12800 leaves output frames
    0-9 bit-identical and changes later frames by more than 1e-3;
21. the video-only model (configs/LRS23/VO/EffConfInterCTC.py: blocks
    (6, 6), InterCTC 3, 6, 9): served through `Server(mode="vo")` with stem
    "pallas" (1 stem launch per forward, fp32 kernels against plain
    versions as in phase 19); `test_augments=[hflip]` in eval: logits
    (8, 2, T, 256) whose first entry on axis 1 is the forward without
    augments (1e-4); trained on the fused-conv route with stem "pallas" at B=16 x
    151 frames (24 + 24 FFN, 12 + 12 attention, 11 of each conv pass, 1
    stem launch per step) with the checks of phase 19;
22. the LRW classifier (`configs/lrw.py`: vocab 500, B=32 clips of 29
    frames) trained likewise, its fp32 cross-entropy and accuracy through
    the kernels against the plain versions (1e-5, equal), an evaluation
    (loss, accuracy), its checkpoint's front end loaded into phase 21's VO
    model (`Trainer.load(select=...)`, every entry equal);
23. the AO-Tone-Causal learning run (`avec_tpu_torch/configs/
    ao_tone_causal.py` at the config's size: 6400 utterances, B=16, 2
    epochs of 400 steps, blocks (2, 2, 1), left context 64) on the
    fused-conv route: the greedy WER of the 64 evaluation utterances at
    init and after each epoch, the launches of the 800 steps equal to the
    counts per step from the module tree; the WER after the last epoch
    must be at most 20 and below half of the WER at init. Printed: the
    step's median ms (synchronized), utterances/s, peak GiB, the phase's
    wall time; details under `zoo` and `learning_run_causal` in the same
    file.
24. (run before phase 18) the LM-Tone learning run (`avec_tpu_torch/
    configs/lm_tone.py`: GPT-Tiny on the 512-line tone corpus, 1 epoch of
    32 steps at B=16, AdamW, fp32): its evaluation loss (below ln 34),
    accuracy and top-10 accuracy, and the checkpoint that phase 18's
    decoder rescores with (beam 8, a 2-gram over the training transcripts,
    GPT 0.3 / 0.3); phase 18 prints the greedy WER of the same logits
    beside each of its WERs and holds both decoders' WERs to the same
    checks (below init; the ceilings after the last epoch);
25. decoding at full width: the reference-depth AV model (use_flash, stem
    "pallas", vocab 256, seeded weights and BN statistics) served through
    `Server(decoder=CTCDeviceBeamSearchDecoder(...))` (beam 16, an order-6
    ARPA that `estimate_arpa` builds from 4000 seeded transcripts, alpha
    0.6, beta 1.0) for 8 requests in the 8 s bucket: 7 flash and 1 stem
    launch per served forward (`launches_decode`); on the same log-probs
    the device search against the native decoder (8 threads: equal best
    prefixes, equal prefixes where scores do not tie, scores within 1e-3),
    and utterance 0 with cutoff_top_n 32 in the Python, native and device
    searches likewise; GPT-Small at full width (88.2M params, seeded
    weights) rescoring the native beams, its fp32 forward on the card
    against the CPU's (1e-4 of the largest logit) and 3 AdamW steps on one
    8 x 128 batch (finite, falling losses). Printed: the forward,
    device-beam, native-beam, Python-search, rescoring and GPT step times
    and the GPT step's peak GiB beside the card's name and power limit;
    details under `lm_tone` and `decode` in the same file.
26. serving from files: the full-width AO model as `Server(mode="ao")`
    builds it, with use_flash, bf16, a tokenizer `train_bpe` learns from
    seeded text; 8 seeded utterances of 2-6 s written as wav and flac
    under build/. `transcribe_batch` over the wav paths, the flac paths and
    the same samples as arrays, and `stdin_loop` over the flac paths from an
    in-memory stream with max_batch 4 (the pipeline holds two batches): 11
    flash launches per forward (`launches_serve_files`), identical texts
    from wav, flac and arrays, the loop's texts those of `transcribe_batch`
    on the same batches, an {"file", "error"} row for a missing path.
    Printed: latency p50 / p95, mean RTF, the host ms of `submit_batch`
    beside `finish_batch`'s, and the host syncs of one submit
    (`torch.cuda.set_sync_debug_mode("warn")`). Then mp4 requests
    (`serve_mp4`): 8 seeded `_mouth.mp4` clips of 1-3 s from
    `data/lrs_fixture.py` with the .wav beside each, served by the
    full-width AV model (use_flash, stem "pallas": K4 7 and K5 1 per
    forward) and the full-width VO model (stem "pallas": K5 1), texts
    equal to those of the same decoded frames passed as arrays; a clip
    that does not decode raises. Details under `serve_files`;
27. streaming: (a) `StreamingTranscriber` on phase 26's model over a 6 s
    utterance in 200 ms pushes, unbounded: final token ids equal to the
    offline greedy ids of the same bucket; windowed (4 s) over one 20 s
    push: bounded buckets, monotone commits; 11 flash launches per forward
    (`launches_streaming`). (b) `CausalStreamingTranscriber` on the
    full-width causal AO model (left context 128, chunk 16) in fp32 and
    bf16 over 96 123 samples in ragged pushes: ceil((n // 160 + 1) / 16)
    steps, od^3(n // 160 + 1) frames, fp32 logits within 2e-4 of the
    offline causal forward (1e-3 if the card's reassociation needs it;
    the bound used is printed), fp32 tokens identical, every partial a
    prefix of the final text, no kernel launched. Printed: per-chunk
    latency p50 / p95, the bf16 max abs differences and greedy-id
    agreement (the offline bf16 forward reads fp32 samples, the fbank
    first, then the cast, as the transcriber does; beside it the offline
    bf16 forward of samples cast to bf16 first, as the JAX package's bf16
    forward casts them); details under `streaming`;
28. the experiment CLI (`avec_tpu_torch/main.py`) from a new directory
    under build/: `-m pass` for every port config (the flagship AV config
    in a subprocess of `python -m avec_tpu_torch.main`, the others
    in-process through `main.main(argv)`), their parameter counts;
    `lrs23_av` (synthetic fallback, B=16, 4 accumulated micro-batches)
    trained for 3 steps with AVEC_TPU_FUSED_FFN / _ATT / _CONV = 1 and
    AVEC_TPU_STEM = pallas: each kernel's launches over the steps equal to
    `kernel_launches_per_step` x 4 x 3 (`launches_cli`), finite losses, a
    checkpoint and a TensorBoard or JSON lines log; `--load_last`
    evaluation, swa and eval_time from that checkpoint, `save_logits` on
    one batch; `lrs23_ao` trained for 2 steps from a generated LRS2 + LRS3
    tree (with `_mouth.mp4` clips) and evaluated by its beam decoder (beam
    16, the tree's ARPA), its WER printed with no bound; `lrs23_vo` trained
    for 2 steps of 64 clips from the tree's mp4 clips, its WER printed with
    no bound; details under `cli`.
29. the rest of the library (`library_phase`): (a) the grouped-attention
    audio-only model at the LRS23 AO widths (`att_type="grouped"`: groups
    of 3 frames in stage 1, 1 in stages 2-3; vocab 256, blocks (5, 6, 5),
    InterCTC 3, 6, 10, 13; seeded weights and BN statistics) served
    through `Server(mode="ao")` (8 requests of 2-6 s in the 8 s bucket;
    its attention is plain products, so no launch; fp32 kernels against
    plain versions as phase 3: logits 2e-3, identical greedy ids; two
    requests' fp32 logits on the card against the CPU's, 2e-3, identical
    ids; the bf16 latency p50 / p95 and RTF) and trained on the fused
    routes at B=16 / 6 s with the InterCTC blocks 3, 6, 10, 13 (32 + 32
    FFN and 14 of each conv pass per step from the module tree, no K2 /
    K4; the checks of phase 19; the step's
    ms, utterances/s and peak GiB); 3 steps of it under `SGD(momentum=0.9,
    nesterov=True)` and `ExpDecayScheduler` (finite losses, every leaf
    moved but those of an exactly zero gradient); (b) `rnnt_loss` with its gradient at B=8,
    T=151, U=32, V=256, fp32, against the CPU (loss 1e-4 relative,
    gradient 1e-4 of its largest entry), its ms and device launches per
    call; the functional `ctc_loss` (the JAX recursion) at (16, 76, 256)
    against `F.ctc_loss` on the card, per sample, 1e-4 relative; (c)
    ResNet50 with stem and head, forward and backward at 8 x 224 x 224 x
    3, fp32, logits against the CPU's within 1e-3 of their largest entry;
    a 2-layer bidirectional LSTM at (16, 151, 256) against the CPU, 1e-4.
    Every time is printed beside the card's name and power limit; details
    under `library`.
30. distributed, the rest (`distributed_phase`, two gloo ranks sharing
    the card): (a) the LRS23 AO, causal AO, VO and LRW models at full
    width on the fused routes with stem "2d", data parallel, B=16 (LRW 32
    clips) split 8 + 8: 1 warm-up + 2 counted steps, launches per step and
    rank equal to `kernel_launches_per_step` (K1 / K1b, K2 / K2b, K3dp;
    `launches_dp_zoo`), parameters bit-identical across the ranks, an fp32
    step with dropout and SpecAugment off against the one-process step
    (loss 1e-5, gradient norm 1e-3, every leaf 2e-3, the video front end
    0.15, BN statistics 1e-5); (b) phase 16's 16 utterances with labels
    of 8-32 tokens, each rank's 8 collated apart (audio and labels cut to
    the rank's longest) and assembled by `host_local_batch_to_global`:
    the AO model's fp32 step against one process on the global batch, the
    same bounds;
    (c) GPT-Small (d 768, 12 blocks, 12 heads, vocab 1025) at
    model_parallel 2: FFN-in (1536, 768) a rank, the head replicated, 3
    AdamW steps at 8 x 128 tokens, fp32, dropout off: losses within 2e-5
    relative of one process, the gathered parameters within 1e-5 of the
    largest entry; step ms and peak GiB per rank beside the card's name
    and power limit; details under `distributed`.
31. remat and the library's variants (`remat_phase`): (a) the flagship AV
    model at reference depth, B=16 / 6 s, bf16, on the fused-conv route
    (K1 / K1b, K2 / K2b, K3 x 4, K5) and on the flash route (K1 / K1b, K4 /
    K4b), one trainer with `remat=True` and one without from the same
    weights and seeds, each alone on the card: the first forward +
    backward's losses bit-equal, every gradient leaf within 3e-2 of its
    largest entry (the video front end 0.15), BN statistics within 1e-5 of
    scale; 1 warm-up + 2 counted steps with the checks of phase 6,
    backward launches equal and forward launches higher by the plan's count
    (15 rematerialized blocks); peak GiB both ways (each trainer alone) and
    step ms in turns (plain, remat, remat, plain) beside the card's name and
    power limit. (b) a full-width (360) stack of a
    transposed stride-2 block, a `batch_norm=False` block and a ReLU block
    with the fused switches on: one bf16 training step launches K1 / K1b
    4, K2 / K2b 3 and no K3 (the JAX gates), finite; fp32 kernels against
    plain versions, output 1e-3, input gradient through the first two
    blocks 1e-3. Details under `remat`.
32. (run after phase 4) the four training BatchNorm kernels (bn_stats,
    bn_apply, bn_bwd_reduce, bn_bwd_dx) through their wrappers against
    their plain versions at one `av_train` micro-batch of 6432 frames in
    bf16: the ResNet trunk's stage 1 and stage 4 (channels-last) and the
    stem's (rows, 64): statistics, apply and bwd-dx bit-identical, the
    backward's sums within 1e-5 of the largest entry, the same bits over
    two calls; each kernel's time at stage 1 beside its byte bound and its
    plain version. Details under `batch_norm`. With the kernels every
    training path's launches per step include the BatchNorm kernels: each
    BatchNorm that trains on its batch's statistics without a process
    group and that no fused convolution module holds launches all four,
    a "pallas" stem the statistics and both backward kernels.
The line before the last is a JSON `kernels` line of twenty kernels (the
thirteen of phase 18 with their launches there as `launches_learning_run`, the
launches of phases 19-22 by phase as `launches_zoo`, those of phase 23 as
`launches_learning_run_causal`, K4's and K5's per served forward of phase
25 as `launches_decode`, K4's of phases 26 and 27 (a) as
`launches_serve_files` and `launches_streaming`, the thirteen of phase 28 as
`launches_cli`, the ten of phase 29's grouped model by path as
`launches_grouped`, those of phase 30 (a) by model as `launches_dp_zoo`,
those of phase 31 (a)'s remat runs by route as `launches_remat`);
the
last line is {"ok": true, "device": {...}}. Every time
there ("ms", "plain_ms", "library_ms") is one of direct calls between CUDA
events (`cuda_time_ms`), the host's cost of each call included; "device_ms"
is the same call's device time from torch.profiler (`device_time_ms`), the
time of every kernel it runs; K4's entry adds "library_device_ms" and
"library_backend" (SDPA's forward on the device and its backend), K4b's two
entries "library_device_ms", SDPA's backward on the device. Details go to
chiprun_out/chip_smoke.json.
"""

import copy
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from avec_tpu_torch.ops.batch_norm import KERNELS as BN_KERNELS
from avec_tpu_torch.ops.batch_norm import launches as bn_launches

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
ROUNDS = 3                         # served batches in the timed main path
# K4b bf16: bound on the relative L1 error of dq', dk', dV against the plain
# version (p and dS as three bf16 parts: about 2e-6 on the H100; rounded to
# bf16: about 2e-3)
L1_TOL = 1e-4
TRAIN_STEPS = 3                    # counted train steps after one warm-up
DEVICE_TRACE_TRIES = 5             # traces of one call before it fails
TRACE_MARGIN_S = 0.01              # idle time at either end of a trace


# B=16 lengths for the kernel checks at the training shapes: T, short ones, 0
# gradient leaves of the video stem and ResNet trunk (see check_agreement)
FRONT_END = "video_encoder.front_end."
RAGGED_TRAIN_LENGTHS = {
    151: [151, 140, 133, 120, 111, 99, 90, 88, 77, 64, 50, 33, 17, 2, 1, 0],
    76: [76, 70, 67, 60, 56, 50, 45, 44, 39, 32, 25, 17, 9, 2, 1, 0]}
ATT_LEAVES = ("x", "ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "pos_w",
              "pos_b", "wo", "bo")


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled symbol (its last
    length-prefixed name component), with its template arguments, still
    mangled, in brackets."""
    i = 3 if mangled.startswith("_ZN") else 0
    names = []
    while True:
        m = re.match(r"\d+", mangled[i:])
        if not m:
            break
        i += len(m.group())
        names.append(mangled[i:i + int(m.group())])
        i += int(m.group())
    name = names[-1] if names else mangled
    if mangled[i:i + 1] == "I":
        name += "<" + mangled[i + 1:].split("EE")[0] + ">"
    return name


def ptxas_summary(build_log) -> dict:
    """{source: {kernel: (registers, spill store bytes, spill load bytes)}}
    from nvcc's -Xptxas -v output."""
    out = {}
    for src, text in build_log.items():
        kern, stores, loads = None, 0, 0
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kern = kernel_name(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                stores, loads = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and kern is not None:
                out.setdefault(src, {})[kern] = (int(m.group(1)), stores, loads)
                kern, stores, loads = None, 0, 0
    return out


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int = 10):
    """Device time of one `fn()`: the kernels (and device memsets and copies)
    that it runs, traced by torch.profiler over `iters` calls after a
    warm-up call, in ms per call, as (total, {kernel name: ms}). Unlike
    `cuda_time_ms` it leaves out the host's cost of each call and the gaps
    between kernels. On the H100 the profiler at times loses records of a
    trace (a kernel seen 7 times in 10 calls, or no row at all), in runs of
    traces. A trace missing records is taken again, up to
    DEVICE_TRACE_TRIES times; if every one misses some, each kernel's time
    is its mean over the launches recorded times its launches per call
    (its count over `iters`, rounded), and a line says so. Fewer than half
    of a kernel's launches recorded fails the call."""
    best = []
    for _ in range(DEVICE_TRACE_TRIES):
        rows = traced_device_rows(fn, iters)[0]
        if rows and all(count % iters == 0 for _, count, _ in rows):
            break
        if sum(c for _, c, _ in rows) > sum(c for _, c, _ in best):
            best = rows
    else:
        rows = best
        if not rows or any(2 * count < iters for _, count, _ in rows):
            raise RuntimeError(f"torch.profiler lost records of "
                               f"{DEVICE_TRACE_TRIES} traces in a row: "
                               f"{rows}")
        log(f"  device trace of {iters} calls missed records "
            f"{DEVICE_TRACE_TRIES} times; launch means used: "
            + ", ".join(f"{short_kernel(k)} {c}x" for _, c, k in rows))
    per = {}
    for us, count, key in rows:
        name = short_kernel(key)
        launches = max(1, round(count / iters))
        per[name] = per.get(name, 0.0) + us / 1e3 / count * launches
    return sum(per.values()), per


def traced_device_rows(fn, iters: int = 1):
    """(rows, annotated us): (device us, count, name) of each kernel, device
    memset or copy that `iters` calls of `fn` run, traced by torch.profiler,
    and apart from them the device time of the user annotations' spans (the
    optimizer's `Optimizer.step#Adam.step`, which covers its kernels and the
    gaps between them: earlier versions of this script counted it in
    device-busy time, so Adam's kernels twice; not the profiler's own
    `ProfilerStep#` span). CPU-side
    operator rows are left out. One call of `fn` runs first in the
    profiler's warm-up step, traced and dropped, and the traced calls keep
    TRACE_MARGIN_S from either end of the trace's window: on the H100 the
    first kernels after the profiler started went unrecorded (all of ten
    K4b calls in one trace; the first K1 call in five in a row; with the
    warm-up step alone, the first kernel of a conv pass)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Profiler clears events ..."
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda pr: traces.append(
                         pr.key_averages())) as p:
            fn()
            torch.cuda.synchronize()
            p.step()
            time.sleep(TRACE_MARGIN_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            p.step()
    rows, annotated = [], 0.0
    for e in traces[0]:
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if getattr(e, "is_user_annotation", False):
            if not e.key.startswith("ProfilerStep"):
                annotated += us
        elif us > 0:
            rows.append((us, e.count, e.key))
    return rows, annotated


def host_ms(fn, iters: int = 20) -> float:
    """Host time to issue one `fn()`: `iters` calls timed on the host's
    clock with no synchronisation between them (few enough launches that
    the launch queue never fills and makes the host wait)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - start) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def short_kernel(name: str) -> str:
    """A profiler's demangled kernel signature cut to the kernel's own name
    and template arguments: `void avec::(anonymous namespace)::k<3>(...)`
    -> `k<3>`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            cut = i
            break
    name, depth, start = name[:cut], 0, 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if depth == 0 and name.startswith("::", i):
            start = i + 2
    return name[start:].strip()


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def make_requests(rng, n: int = 8, low: float = 2.0):
    """Seeded requests of `low`-6 s (the first is 6 s, so the batch falls in
    the 8 s bucket): tones that change every 0.12 s and 25 fps 88x88
    frames."""
    secs = [6.0] + list(rng.uniform(low, 6.0, n - 1))
    reqs = []
    for s in secs:
        samples, seg = int(16000 * s), 1920
        freq = np.repeat(rng.uniform(100, 4000, samples // seg + 1), seg)
        amp = np.repeat(rng.uniform(0.0, 0.5, samples // seg + 1), seg)
        audio = amp[:samples] * np.sin(2 * np.pi * np.cumsum(freq[:samples])
                                       / 16000)
        frames = samples // 640 + 1
        video = rng.rand(frames, 88, 88, 1) * rng.rand(frames, 1, 1, 1) * 2
        reqs.append({"audio": audio.astype(np.float32),
                     "video": video.astype(np.float32)})
    return reqs


def stage_lengths(audio_len: np.ndarray):
    """Audio frame lengths at the flash stages: fbank, stem stride, then the
    strided boundary blocks (T = 801 -> 401 -> 201 -> 101 in the 8 s
    bucket)."""
    fb = audio_len // 160 + 1
    s0 = (fb - 1) // 2 + 1
    s1 = (s0 - 1) // 2 + 1
    return s1, (s1 - 1) // 2 + 1


def flash_inputs(b, t, d_model, lengths, dtype, seed):
    from avec_tpu_torch.ops.flash_attention import rel_pos_augment

    h, d = 4, d_model // 4
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=gen) for _ in range(3))
    pos_kernel = torch.randn(d_model, d_model, generator=gen) / d_model ** 0.5
    pos_bias = torch.randn(d_model, generator=gen) * 0.1
    dev = torch.device("cuda")
    q, k, v = (a.to(dev, dtype) for a in (q, k, v))
    q_aug, k_aug = rel_pos_augment(q, k, pos_kernel.to(dev), pos_bias.to(dev),
                                   d_model, h)
    return (q_aug.contiguous(), k_aug.contiguous(), v.contiguous(),
            torch.as_tensor(lengths, dtype=torch.int32, device=dev),
            1.0 / math.sqrt(d))


def flash_cost(b, h, t, da, dv, lengths, es):
    """Bytes (q' read, the valid k'/v rows read, out and lse written) and
    operations (2 x T x len x (da + dv) per head) one launch needs."""
    valid = int(np.sum(lengths))
    nbytes = (b * h * t * da * es + valid * h * (da + dv) * es
              + b * h * t * dv * es + b * h * t * 4 + b * 4)
    ops = 2.0 * h * t * valid * (da + dv)
    return nbytes, ops


def bound(nbytes, ops, kind):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the "
              "card only", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from avec_tpu_torch.models.zoo import randomize_batch_stats
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                    flash_attention_reference)
    from avec_tpu_torch.ops.stem import bn_relu_pool, bn_relu_pool_reference
    from avec_tpu_torch.serve import Server, _batch_bucket, _bucket

    detail = {}
    dev = torch.device("cuda")

    # ---- 1. device and build
    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s")
    detail["ptxas"] = ptxas_summary(_cuda.build_log)
    for src, kernels_ in detail["ptxas"].items():
        for name, (regs, spill_st, spill_ld) in kernels_.items():
            log(f"  ptxas {src} {name}: {regs} registers, {spill_st} bytes "
                f"spill stores, {spill_ld} bytes spill loads")
    detail["build_s"] = build_s
    detail["build_log"] = dict(_cuda.build_log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. kernels against their plain versions (serving shapes)
    ragged = {201: [201, 160, 120, 101, 77, 40, 9, 1],
              101: [101, 80, 60, 51, 39, 20, 5, 1]}
    errs = {"flash_attention_fwd": {}, "bn_relu_pool": {}}
    for t, d_model in ((201, 256), (101, 360)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v, lens, scale = flash_inputs(8, t, d_model,
                                                ragged[t], dtype, seed=t)
            out, lse = flash_attention_fwd(q, k, v, lens, scale)
            torch.cuda.synchronize()
            want, want_lse = flash_attention_reference(q, k, v, lens, scale)
            err = max(max_abs(out, want), max_abs(lse, want_lse))
            key = f"T{t}_D{d_model}_{str(dtype)[6:]}"
            errs["flash_attention_fwd"][key] = err
            log(f"flash_attention_fwd {key}: max abs {err:.3e} (tol {tol})")
            if not err <= tol:
                raise AssertionError(f"flash kernel disagrees: {key} {err}")
            if dtype == torch.bfloat16:
                detail[f"flash_fwd_operands_T{t}"] = flash_fwd_bf16_checks(
                    key, q, k, v, lens, scale, out, lse, want)
    n_frames = 8 * (_bucket(96000) // 640 + 1)     # 8 x 201 video frames
    gen = torch.Generator().manual_seed(5)
    a5 = (torch.rand(64, generator=gen) + 0.5).to(dev)
    b5 = (torch.randn(64, generator=gen) * 0.2).to(dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.0)):
        y = torch.randn(n_frames, 44, 44, 64, generator=gen).to(dev, dtype)
        got = bn_relu_pool(y, a5, b5)
        torch.cuda.synchronize()
        err = max_abs(got, bn_relu_pool_reference(y, a5, b5))
        key = f"N{n_frames}_{str(dtype)[6:]}"
        errs["bn_relu_pool"][key] = err
        log(f"bn_relu_pool {key}: max abs {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"stem kernel disagrees: {key} {err}")
        del y, got
    # odd frames clip the window at the last row and column; C = 8 is one
    # 16-byte load of bf16 channels
    for n_odd, h, w, c in ((5, 45, 43, 64), (9, 3, 5, 8)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 0.0)):
            y = torch.randn(n_odd, h, w, c, generator=gen).to(dev, dtype)
            ao, bo = a5[:c].contiguous(), b5[:c].contiguous()
            err = max_abs(bn_relu_pool(y, ao, bo),
                          bn_relu_pool_reference(y, ao, bo))
            key = f"N{n_odd}_{h}x{w}x{c}_{str(dtype)[6:]}"
            errs["bn_relu_pool"][key] = err
            log(f"bn_relu_pool {key}: max abs {err:.3e} (tol {tol})")
            if not err <= tol:
                raise AssertionError(f"stem kernel disagrees: {key} {err}")
    detail["kernel_errors"] = errs

    # ---- 3. serving at full width
    srv = Server(device="cuda", precision="bfloat16", seed=0, vocab_size=256,
                 use_flash=True, stem_mode="pallas")
    with torch.no_grad():
        randomize_batch_stats(srv.model, torch.Generator().manual_seed(1))
    n_params = sum(p.numel() for p in srv.model.parameters())
    reqs = make_requests(np.random.RandomState(0))
    samples = [len(r["audio"]) for r in reqs]
    inputs = srv._inputs_for_batch(reqs, _bucket(max(samples)),
                                   _batch_bucket(len(reqs)))
    log(f"model: {n_params / 1e6:.2f}M params; batch of {len(reqs)} requests "
        f"({min(samples) / 16000:.2f}-{max(samples) / 16000:.2f} s) in the "
        f"{inputs[2].shape[1]}-sample bucket")
    srv.transcribe_batch(reqs)                       # warm-up (cuDNN plans)
    srv.latencies, srv.rtfs = [], []
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        results = srv.transcribe_batch(reqs)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    log(f"main path launches over {ROUNDS} forwards: {launches}")
    if launches.get("flash_attention_fwd", 0) != 7 * ROUNDS:
        raise AssertionError(f"flash launches {launches} != 7 per forward")
    if launches.get("bn_relu_pool", 0) != ROUNDS:
        raise AssertionError(f"stem launches {launches} != 1 per forward")
    summary = srv.stats_summary()
    serving = {"requests_per_s": len(reqs) * ROUNDS / wall,
               "latency_p50_s": summary["latency_p50_s"],
               "latency_p95_s": summary["latency_p95_s"],
               "rtf_mean": summary["rtf_mean"], "rounds": ROUNDS,
               "batch": len(reqs), "params_m": n_params / 1e6}

    logits, lengths = srv.forward(inputs)
    if not (tuple(logits.shape) == (8, 101, 256)
            and bool(torch.isfinite(logits.float()).all())):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    if [len(r["tokens"]) for r in results] == [0] * len(results):
        raise AssertionError("every request decoded to no token")

    def fwd_ms(kernels: bool, dtype) -> float:
        srv.model.set_kernels(kernels)
        return cuda_time_ms(lambda: srv.forward(inputs, dtype), iters=5,
                            warmup=1)

    order = [False, True, True, False]
    times = [fwd_ms(k, torch.bfloat16) for k in order]
    serving["forward_ms_kernels_bf16"] = (times[1] + times[2]) / 2
    serving["forward_ms_plain_bf16"] = (times[0] + times[3]) / 2

    srv.model.set_kernels(True)
    k_logits, k_len = srv.forward(inputs, torch.float32)
    srv.model.set_kernels(False)
    p_logits, p_len = srv.forward(inputs, torch.float32)
    srv.model.set_kernels(True)
    diff = max_abs(k_logits, p_logits)
    ids_k = srv.decoder(srv.decoder.device_fn((k_logits, k_len)))
    ids_p = srv.decoder(srv.decoder.device_fn((p_logits, p_len)))
    serving["fp32_kernel_vs_plain_logits_max_abs"] = diff
    serving["bf16_vs_fp32_plain_logits_max_abs"] = max_abs(logits, p_logits)
    log(f"fp32 kernels vs plain: logits max abs {diff:.3e} (tol 2e-3), "
        f"greedy ids equal: {ids_k == ids_p}")
    if not (diff <= 2e-3 and torch.equal(k_len, p_len) and ids_k == ids_p):
        raise AssertionError("kernel path disagrees with the plain path")
    log("serving " + json.dumps(serving))
    detail["serving"] = serving
    detail["tokens"] = [r["tokens"] for r in results]

    # ---- 4. kernel timings at the main path's shapes and data (bf16)
    alens = inputs[3]
    len1, len2 = stage_lengths(alens)
    flash = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "library_device_ms": 0.0, "bytes": 0, "ops": 0.0}
    flash_backends = set()
    for t, d_model, lens, count in ((201, 256, len1, 6), (101, 360, len2, 1)):
        q, k, v, lt, scale = flash_inputs(8, t, d_model, lens,
                                          torch.bfloat16, seed=7)
        keymask = (torch.arange(t, device=dev)[None, :]
                   < lt[:, None])[:, None, None, :]
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, lt, scale))
        dev_ms, stages = device_time_ms(lambda: flash_attention_fwd(
            q, k, v, lt, scale))
        h_ms = host_ms(lambda: flash_attention_fwd(q, k, v, lt, scale))
        want = flash_attention_reference(q, k, v, lt, scale)[0]
        plain = cuda_time_ms(lambda: flash_attention_reference(q, k, v, lt,
                                                               scale))
        # the library yardstick: SDPA on the same inputs, and on their
        # copies zero-padded to widths of a multiple of 8 (round8(d_a) =
        # 328 / 456, round8(d_v) = 64 / 96: the same function, which a
        # backend other than the math path may take); the faster of the
        # two forms whose output is finite, its error against the plain
        # version printed beside it
        pad8 = lambda a: F.pad(a, (0, -a.shape[-1] % 8)).contiguous()
        forms = {"sdpa": (q, k, v), "sdpa_padded": (pad8(q), pad8(k),
                                                    pad8(v))}
        libs = {}
        for form, (qf, kf, vf) in forms.items():
            def sdpa(qf=qf, kf=kf, vf=vf):
                return F.scaled_dot_product_attention(
                    qf, kf, vf, attn_mask=keymask, scale=scale)

            l_out = sdpa()[..., :v.shape[-1]]
            l_err = (max_abs(l_out, want)
                     if bool(torch.isfinite(l_out).all()) else math.inf)
            l_dev, l_kernels = device_time_ms(sdpa)
            libs[form] = {"ms": cuda_time_ms(sdpa), "device_ms": l_dev,
                          "backend": sdpa_backend(l_kernels),
                          "max_abs_vs_plain": l_err,
                          "kernels_ms": l_kernels}
        finite = [f for f in libs if math.isfinite(libs[f]["max_abs_vs_plain"])]
        best = min(finite or libs, key=lambda f: libs[f]["ms"])
        lib, lib_dev = libs[best]["ms"], libs[best]["device_ms"]
        flash_backends.add(f"{best}: {libs[best]['backend']}")
        nbytes, ops = flash_cost(8, 4, t, q.shape[-1], v.shape[-1], lens, 2)
        detail[f"flash_T{t}"] = {"ms": ms, "device_ms": dev_ms,
                                 "host_ms": h_ms, "kernels_ms": stages,
                                 "plain_ms": plain, "library_ms": lib,
                                 "library_device_ms": lib_dev,
                                 "library_form": best, "library": libs,
                                 "bytes": nbytes, "ops": ops,
                                 "lengths": [int(x) for x in lens],
                                 "bound_ms": bound(nbytes, ops, "bf16")[0]}
        log(f"flash T={t} D={d_model}: {ms:.4f} ms/launch (device "
            f"{dev_ms:.4f}; host issue {h_ms:.4f}), plain {plain:.4f}, "
            f"bound {bound(nbytes, ops, 'bf16')[0]:.5f}; "
            + "; ".join(f"{f} {r['ms']:.4f} (device {r['device_ms']:.4f}, "
                        f"backend: {r['backend']}, max abs vs plain "
                        f"{r['max_abs_vs_plain']:.2e})"
                        for f, r in libs.items())
            + f"; yardstick {best}")
        log(f"flash T={t} device time of each kernel in one launch "
            f"(torch.profiler): "
            + ", ".join(f"{nm} {v_ms:.4f} ms" for nm, v_ms in stages.items()))
        flash["ms"] += count * ms
        flash["device_ms"] += count * dev_ms
        flash["plain_ms"] += count * plain
        flash["library_ms"] += count * lib
        flash["library_device_ms"] += count * lib_dev
        flash["bytes"] += count * nbytes
        flash["ops"] += count * ops
    f_bound, f_by = bound(flash["bytes"], flash["ops"], "bf16")

    y = torch.randn(n_frames, 44, 44, 64, generator=gen).to(dev, torch.bfloat16)
    s_ms = cuda_time_ms(lambda: bn_relu_pool(y, a5, b5))
    s_dev = device_time_ms(lambda: bn_relu_pool(y, a5, b5))[0]
    s_plain = cuda_time_ms(lambda: bn_relu_pool_reference(y, a5, b5))
    s_bytes = y.numel() * 2 + (y.numel() // 4) * 2 + 2 * 64 * 4
    s_bound, s_by = bound(s_bytes, 3.0 * y.numel(), "bf16")
    detail["stem"] = {"ms": s_ms, "device_ms": s_dev, "plain_ms": s_plain,
                      "bytes": s_bytes, "bound_ms": s_bound}
    log(f"bn_relu_pool N={n_frames}: {s_ms:.4f} ms (device {s_dev:.4f}), "
        f"plain {s_plain:.4f}, bound {s_bound:.5f} ({s_by}): "
        f"{s_ms / s_bound:.2f}x the bound (device {s_dev / s_bound:.2f}x)")

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "avec_tpu_torch/csrc/flash_attention.cu",
         "replaces": "avec_tpu/ops/pallas_attention.py:134",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": max(errs["flash_attention_fwd"].values()),
         "ms": flash["ms"], "device_ms": flash["device_ms"],
         "plain_ms": flash["plain_ms"], "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": flash["library_ms"],
         "library_device_ms": flash["library_device_ms"],
         "library_backend": "; ".join(sorted(flash_backends))},
        {"name": "bn_relu_pool", "route": "cuda",
         "source": "avec_tpu_torch/csrc/stem.cu",
         "replaces": "avec_tpu/ops/pallas_stem.py:149",
         "launches": launches["bn_relu_pool"],
         "max_abs_err": max(errs["bn_relu_pool"].values()),
         "ms": s_ms, "device_ms": s_dev, "plain_ms": s_plain,
         "bound_ms": s_bound, "bound_by": s_by, "library_ms": None},
    ]
    if "--profile" in sys.argv[1:]:
        detail["profile"] = profile_forward(srv, inputs)
    del srv, inputs, logits, k_logits, p_logits, y
    torch.cuda.empty_cache()

    # ---- 32. the BatchNorm kernels against their plain versions at the
    # main path's shapes
    kernels += bn_phase(detail)

    # ---- 5-7. the training slice
    profile = "--profile" in sys.argv[1:]
    entries, trainer, batch = training_phases(detail, profile)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    *detail["train_flash_fwd_errors"].values())
    kernels += entries

    # ---- 8-11. the fused attention module and the train-mode stem
    entries, stem_train_launches, trainer_att = fused_phases(
        detail, profile, trainer, batch)
    kernels += entries
    kernels[1]["launches_train_path"] = stem_train_launches
    del trainer
    torch.cuda.empty_cache()

    # ---- 12-14. the fused convolution module
    entries, conv_shapes = conv_phases(detail, profile, trainer_att, batch)
    kernels += entries
    del trainer_att
    torch.cuda.empty_cache()

    # ---- 15-17. data-parallel training (K3dp, sync-BN, NCCL)
    kernels += dp_phases(detail, conv_shapes)

    # ---- 24. the LM-Tone learning run (before phase 18, whose decoder
    # rescores with its checkpoint)
    import shutil
    import tempfile

    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    lm_dir = tempfile.mkdtemp(prefix="lm_tone_", dir=os.path.join(root,
                                                                   "build"))
    try:
        lm_tone_phase(detail, lm_dir)
        # ---- 18. the AV-Tone learning run through the training engine
        run_launches = learning_phase(detail, root, profile, lm_dir)
    finally:
        shutil.rmtree(lm_dir, ignore_errors=True)
    for entry in kernels:
        if entry["name"] in run_launches:
            entry["launches_learning_run"] = run_launches[entry["name"]]

    # ---- 19-22. the audio-only, causal, video-only and LRW models
    zoo_launches = zoo_phases(detail, root)
    # ---- 23. the AO-Tone-Causal learning run
    causal_launches = causal_learning_phase(detail, root)
    for entry in kernels:
        by_path = {path: counts[entry["name"]]
                   for path, counts in zoo_launches.items()
                   if entry["name"] in counts}
        if by_path:
            entry["launches_zoo"] = by_path
        if entry["name"] in causal_launches:
            entry["launches_learning_run_causal"] = \
                causal_launches[entry["name"]]
    # ---- 25. decoding at full width
    decode_launches = decode_phase(detail, root)
    for entry in kernels:
        if entry["name"] in decode_launches:
            entry["launches_decode"] = decode_launches[entry["name"]]
    # ---- 26-27. serving from files, streaming
    work = tempfile.mkdtemp(prefix="serve_files_", dir=os.path.join(root,
                                                                    "build"))
    try:
        srv, tok_path, file_launches = serve_files_phase(detail, root, work)
        stream_launches = streaming_phase(detail, srv, tok_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del srv
    torch.cuda.empty_cache()
    for entry in kernels:
        if entry["name"] in file_launches:
            entry["launches_serve_files"] = file_launches[entry["name"]]
        if entry["name"] in stream_launches:
            entry["launches_streaming"] = stream_launches[entry["name"]]
    # ---- 28. the experiment CLI
    cli_launches = cli_phase(detail, root)
    for entry in kernels:
        if entry["name"] in cli_launches:
            entry["launches_cli"] = cli_launches[entry["name"]]
    # ---- 29. the rest of the library
    grouped = library_phase(detail, root)
    for entry in kernels:
        by_path = {path: counts[entry["name"]]
                   for path, counts in grouped.items()
                   if entry["name"] in counts}
        if by_path:
            entry["launches_grouped"] = by_path
    # ---- 30. distributed, the rest
    dp_zoo = distributed_phase(detail, root)
    for entry in kernels:
        by_model = {kind: counts[entry["name"]]
                    for kind, counts in dp_zoo.items()
                    if entry["name"] in counts}
        if by_model:
            entry["launches_dp_zoo"] = by_model
    # ---- 31. remat and the library's variants
    remat = remat_phase(detail)
    for entry in kernels:
        by_route = {route: counts[entry["name"]]
                    for route, counts in remat.items()
                    if entry["name"] in counts}
        if by_route:
            entry["launches_remat"] = by_route
    detail["kernels"] = kernels

    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, **detail}, f, indent=1, default=str)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def rel_err(got, want) -> float:
    """Max abs difference over the largest entry of `want`."""
    return max_abs(got, want) / max(float(want.float().abs().max()), 1e-30)


def rel_l1(got, want) -> float:
    """sum |got - want| over sum |want|: unlike the max error over the
    largest entry, not set by one bf16 step of a large entry, nor by entries
    that are sums cancelling to about 0 (dq' of k''s column of ones)."""
    w = want.float()
    return float(((got.float() - w).abs().sum() / w.abs().sum().clamp_min(
        1e-30)).item())


def ffn_inputs(n, d, f, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=gen).to(dev, dtype)
    g = torch.randn(n, d, generator=gen).to(dev, dtype)
    params = [1.0 + 0.1 * torch.randn(d, generator=gen),
              0.1 * torch.randn(d, generator=gen),
              torch.randn(f, d, generator=gen) / d ** 0.5,
              0.1 * torch.randn(f, generator=gen),
              torch.randn(d, f, generator=gen) / f ** 0.5,
              0.1 * torch.randn(d, generator=gen)]
    return x, g, [p.to(dev) for p in params]


def ffn_run(x, g, params, drop, use_kernel, seed=1234):
    """y and the gradients of x and the six parameters."""
    from avec_tpu_torch.ops.ffn import fused_ffn

    leaves = [t.detach().requires_grad_(True) for t in [x] + params]
    y = fused_ffn(leaves[0], *leaves[1:], seed, 1e-6, drop, True, use_kernel)
    y.backward(g)
    return y.detach(), [t.grad for t in leaves]


def ffn_cost(n, d, f, es):
    """(forward bytes, forward ops, backward bytes, backward ops): x read and
    y written once, fp32 parameters read once (and their gradients written
    once in the backward, beside x, g and dx); two products forward
    (4 N d F), five in the backward (u again, ds, dW2, dW1, dh: 10 N d F)."""
    pbytes = 4 * (2 * d * f + f + 3 * d)
    return (2 * n * d * es + pbytes, 4.0 * n * d * f,
            3 * n * d * es + 2 * pbytes, 10.0 * n * d * f)


def flash_bwd_cost(h, t, da, dv, lengths, es):
    """Bytes and operations of the dq kernel and of the dk/dv kernel: each
    reads the valid rows of q', k', v, dO and lse, delta once and writes its
    (B*H, T, .) gradients; each forms s and dO V^T on the valid square, dq
    then one more product over d_a, dk/dv one over d_a and one over d_v."""
    lens = np.asarray(lengths, dtype=np.float64)
    valid, sq, b = float(lens.sum()), float((lens ** 2).sum()), len(lens)
    read = h * valid * (2 * da + 2 * dv) * es + h * valid * 8 + b * 4
    dq = (read + b * h * t * da * es, 2.0 * h * sq * (2 * da + dv))
    dkv = (read + b * h * t * (da + dv) * es,
           2.0 * h * sq * (2 * da + 2 * dv))
    return dq, dkv


def make_train_batch(rng, batch: int = 16, samples: int = 96000,
                     label_len: int = 32):
    """B utterances padded to 6 s (151 frames of 88x88), true lengths of
    3-6 s with the first one full, 32 labels each."""
    alen = np.array([samples] + [int(v) for v in rng.uniform(
        samples // 2, samples, batch - 1)], np.int32)
    frames = samples // 640 + 1
    video = rng.rand(batch, frames, 88, 88, 1).astype(np.float32)
    audio = (rng.randn(batch, samples) * 0.1).astype(np.float32)
    for i, n in enumerate(alen):
        audio[i, n:] = 0.0
        video[i, n // 640 + 1:] = 0.0
    labels = rng.randint(1, 256, size=(batch, label_len)).astype(np.int32)
    return {"inputs": [video, alen // 640 + 1, audio, alen],
            "targets": (labels, np.full((batch,), label_len, np.int32))}


def reorder(batch):
    """The batch with its two halves of utterances swapped."""
    def swap(a):
        h = len(a) // 2
        return np.concatenate([a[h:], a[:h]])

    return {"inputs": [swap(a) for a in batch["inputs"]],
            "targets": tuple(swap(a) for a in batch["targets"])}


def kernel_call_shapes(trainer, batch):
    """One forward in training mode with hooks: how often each fused-FFN
    shape (N, d, F) and each flash shape (T, D, lengths) occurs in a step."""
    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.ops.attention import RelPos1dMultiHeadAttention

    ffn, flash, hooks = {}, {}, []

    def on_ffn(mod, args):
        x = args[0]
        key = (x.shape[0] * x.shape[1], x.shape[2],
               mod.layers["1"].weight.shape[0])
        ffn[key] = ffn.get(key, 0) + 1

    def on_att(mod, args, kwargs):
        x, mask = args[0], kwargs.get("mask")
        lens = tuple(int(v) for v in mask[:, 0, 0, :].sum(dim=-1).tolist())
        key = (x.shape[1], x.shape[2], lens)
        flash[key] = flash.get(key, 0) + 1

    for m in trainer.model.modules():
        if isinstance(m, FeedForwardModule):
            hooks.append(m.register_forward_pre_hook(on_ffn))
        elif isinstance(m, RelPos1dMultiHeadAttention) and m.use_flash:
            hooks.append(m.register_forward_pre_hook(on_att,
                                                     with_kwargs=True))
    inputs, _ = trainer._to_device(batch)
    with torch.no_grad():
        trainer.model.encoder(*inputs)
    for hk in hooks:
        hk.remove()
    return ffn, flash


def counted_train_steps(trainer, batch, per_step, verbose: bool = True,
                        n_values: int = 9, steps: int = TRAIN_STEPS):
    """One warm-up step, then `steps` steps with the launch counts set to
    0 just before and read just after: the counts must equal `per_step` per
    step, the `n_values` losses, learning rate and gradient norm (9 for the
    AV model's six outputs) must be finite, every parameter
    must have a gradient, and at least 99% of the leaves and every BN running
    statistic must move. Returns (per-step losses, launch counts). `verbose`
    off prints nothing (the second rank of a data-parallel run)."""
    from avec_tpu_torch.ops import _cuda

    say = log if verbose else (lambda *args: None)

    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers()
              if "running_" in n}
    trainer.train_step(batch)                        # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    history = []
    for _ in range(steps):
        losses, infos = trainer.train_step(batch)
        history.append({**{k: float(v) for k, v in losses.items()},
                        "lr": infos["lr"],
                        "grad_norm": float(infos["grad_norm"])})
    torch.cuda.synchronize()
    train_launches = dict(_cuda.launches)
    say(f"main path launches over {steps} train steps: {train_launches}")
    for row in history:
        say("  step " + json.dumps({k: round(v, 6) if k != "lr" else v
                                    for k, v in row.items()}))
    if train_launches != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(f"launches {train_launches} != {steps} x "
                             f"{per_step}")
    if len(history[-1]) != n_values or not all(
            math.isfinite(v) for row in history for v in row.values()):
        raise AssertionError(f"losses or gradient norm not finite: {history}")
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    changed = sum(not torch.equal(p, before[n])
                  for n, p in model.named_parameters())
    stuck = [n for n, b in model.named_buffers()
             if n in stats0 and torch.equal(b, stats0[n])]
    say(f"  parameters without gradient: {len(no_grad)}; leaves changed "
        f"{changed}/{len(before)}; BN statistics that did not move: "
        f"{len(stuck)}/{len(stats0)}")
    if no_grad or changed < 0.99 * len(before) or stuck:
        raise AssertionError(f"no_grad {no_grad[:5]} changed {changed} "
                             f"stuck {stuck[:5]}")
    return history, train_launches


def compare_fp32_step(model, batch, loss_tol, loss=None,
                      front_end: str = FRONT_END):
    """fp32, dropout and SpecAugment off: one forward + backward through the
    kernels against one through their plain versions (which must launch
    nothing), held by `check_agreement`; every BN running statistic the two
    passes leave (each from the same starting point) within 1e-5. `loss`
    defaults to CTC (zero_infinity), with the model's own loss weights."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    trainer32 = Trainer(model=model, device="cuda", precision="float32",
                        loss=loss or CTCLoss(zero_infinity=True))
    stats = {n: b for n, b in model.named_buffers() if "running_" in n}
    start = {n: b.clone() for n, b in stats.items()}
    model.set_regularization(False)
    model.set_kernels(True)
    loss_k, grads_k = trainer32.loss_and_grads(batch)
    stats_k = {n: b.clone() for n, b in stats.items()}
    with torch.no_grad():
        for n, b in stats.items():
            b.copy_(start[n])
    model.set_kernels(False)
    _cuda.reset_launches()
    loss_p, grads_p = trainer32.loss_and_grads(batch)
    if dict(_cuda.launches):
        raise AssertionError(f"plain path launched {dict(_cuda.launches)}")
    model.set_kernels(True)
    model.set_regularization(True)
    return check_agreement("fp32 kernels vs plain",
                           (float(loss_k["loss"]), grads_k, stats_k),
                           (float(loss_p["loss"]), grads_p, stats), loss_tol,
                           front_end=front_end)


def check_agreement(what, got, want, loss_tol, front_end_tol=2e-3,
                    front_end: str = FRONT_END, bn_scaled: bool = False):
    """Two fp32 steps, each (total loss, gradients by name, BN running
    statistics by name), `want` the reference: total loss within `loss_tol`
    and gradient norm within 1e-3, relative; every gradient leaf within 2e-3
    of its largest entry (leaves below 1e-6 of the largest gradient entry,
    the analytically zero key and positional biases, left out), the video
    front end's (stem and ResNet trunk: the leaves named under `front_end`,
    none in an audio-only model) within `front_end_tol`; every BN
    running statistic within 1e-5, absolute, or with `bn_scaled` within
    1e-5 of the larger of 1 and its buffer's largest entry (fp32 keeps
    about 7 digits: a variance of 36.6 is 4 ulps from 1.5e-5). Logs and
    returns the errors, raises if one is out of tolerance."""
    (lk, grads_k, stats_k), (lp, grads_p, stats_p) = got, want
    stats_err = max(max_abs(stats_k[n], b) / (
        max(1.0, float(b.abs().max())) if bn_scaled else 1.0)
        for n, b in stats_p.items())

    def gnorm(grads):
        return float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())))

    nk, npl = gnorm(grads_k), gnorm(grads_p)
    gmax = max(float(g.abs().max()) for g in grads_p.values())
    rows, noise = [], 0
    for name, gp in grads_p.items():
        leaf_max = float(gp.abs().max())
        if leaf_max <= 1e-6 * gmax:
            noise += 1          # analytically zero: key and positional biases
            continue
        rows.append((max_abs(grads_k[name], gp) / leaf_max, leaf_max, name))
    rows.sort(reverse=True)
    front = [r for r in rows if front_end in r[2]] or [(0.0, 0.0, "none")]
    rest = [r for r in rows if front_end not in r[2]]
    log(f"{what}: loss {lk:.6f} vs {lp:.6f} "
        f"(rel {abs(lk - lp) / abs(lp):.2e}, tol {loss_tol}); grad norm "
        f"{nk:.6f} vs {npl:.6f} (rel {abs(nk - npl) / npl:.2e}, tol 1e-3); "
        f"{len(rows)} leaves compared, {noise} below 1e-6 of the largest "
        "gradient left out")
    for err, leaf_max, name in rows[:5]:
        log(f"  leaf {name}: max abs diff / max abs {err:.2e} "
            f"(max abs {leaf_max:.3e})")
    log(f"  worst leaf outside the video front end: {rest[0][2]} "
        f"{rest[0][0]:.2e} (tol 2e-3); inside it: {front[0][2]} "
        f"{front[0][0]:.2e} (tol {front_end_tol})")
    out = {"fp32_loss_rel": abs(lk - lp) / abs(lp),
           "fp32_grad_norm_rel": abs(nk - npl) / npl,
           "fp32_worst_leaf_rel": rows[0][0], "fp32_worst_leaf": rows[0][2],
           "fp32_worst_leaf_outside_front_end_rel": rest[0][0],
           "fp32_worst_front_end_leaf_rel": front[0][0],
           "fp32_bn_stats_max_abs": stats_err,
           "fp32_bn_stats_scaled": bn_scaled}
    log(f"  BN running statistics: max abs {stats_err:.2e}"
        + (" of the larger of 1 and the buffer's largest entry"
           if bn_scaled else "") + f" over {len(stats_p)} buffers (tol 1e-5)")
    if not (abs(lk - lp) <= loss_tol * abs(lp)
            and abs(nk - npl) <= 1e-3 * npl and rest[0][0] <= 2e-3
            and front[0][0] <= front_end_tol and stats_err <= 1e-5):
        raise AssertionError(f"{what} disagree: {out}")
    return out


BN_FRAMES = 6432      # one av_train micro-batch: 32 utterances of ~201 frames


def bn_phase(detail) -> list:
    """Phase 32: the four training BatchNorm kernels (`ops/batch_norm.py`)
    through their wrappers against their plain versions (the `*_reference`
    entry points) at the main path's shapes, BN_FRAMES frames in bf16: the
    ResNet trunk's stage 1 (64 x 22 x 22) and stage 4 (512 x 3 x 3),
    channels-last, and the stem's (rows, 64) view of its conv output (44 x
    44 rows a frame). The statistics bit for bit (the plain version adds in
    the kernel's order), the backward's sums within 1e-5 of their row's
    largest entry (fp32 sums in another order); apply (plain, and with the
    residual add and the ReLU) and bwd-dx (plain, and gated by that output
    writing g') bit for bit given the same statistics and sums;
    stats, bwd-reduce and bwd-dx the same bits on a second call. Then each
    kernel at the stage-1 shape (direct calls and device time) beside its
    byte bound and its plain version. Returns the kernels' entries."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops import batch_norm as bn

    dev = torch.device("cuda")
    n = BN_FRAMES
    shapes = {"stage1": ((n, 64, 22, 22), torch.channels_last),
              "stage4": ((n, 512, 3, 3), torch.channels_last),
              "stem": ((n * 44 * 44, 64), torch.contiguous_format)}
    n0 = dict(_cuda.launches)
    errs = {name: {} for name in BN_KERNELS}
    rec, entries = {}, []
    for where, (shape, fmt) in shapes.items():
        gen = torch.Generator(device=dev).manual_seed(32)

        def act(scale=1.0, shift=0.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale
                    + shift).to(torch.bfloat16).contiguous(memory_format=fmt)

        x, g, res = act(2.0, 0.5), act(), act()
        c = shape[1]
        w = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        st = bn.stats(x, 1e-5)
        same = torch.equal(st, bn.stats(x, 1e-5))
        want = bn.stats_reference(x, 1e-5)
        errs[bn.KERNEL_STATS][where] = max(rel_err(st[i], want[i])
                                           for i in range(3))
        exact = {"stats": torch.equal(st, want)}
        for residual, relu in ((None, False), (res, True)):
            y = bn.apply(x, st, w, b, residual, relu)
            exact[f"apply_relu{int(relu)}"] = torch.equal(
                y, bn.apply_reference(x, st, w, b, residual, relu))
        errs[bn.KERNEL_APPLY][where] = max_abs(
            y, bn.apply_reference(x, st, w, b, res, True))
        e_red, e_dx = 0.0, 0.0
        for gate in (None, y):
            write = gate is not None
            red = bn.bwd_reduce(g, x, gate, st, w)
            same = same and torch.equal(red, bn.bwd_reduce(g, x, gate, st, w))
            want = bn.bwd_reduce_reference(g, x, gate, st, w)
            e_red = max(e_red, *(rel_err(red[i], want[i]) for i in range(5)))
            dx, gres = bn.bwd_dx(g, x, gate, st, red, write)
            same = same and torch.equal(
                dx, bn.bwd_dx(g, x, gate, st, red, write)[0])
            want_dx, want_g = bn.bwd_dx_reference(g, x, gate, st, red, write)
            exact[f"bwd_dx_gated{int(write)}"] = torch.equal(dx, want_dx)
            e_dx = max(e_dx, max_abs(dx, want_dx))
            if write:
                exact["g_prime"] = torch.equal(gres, want_g)
            del dx, gres, want_dx, want_g
        errs[bn.KERNEL_BWD_REDUCE][where] = e_red
        errs[bn.KERNEL_BWD_DX][where] = e_dx
        rec[where] = {"shape": list(shape), "exact": exact,
                      "same_bits_twice": same,
                      **{k: errs[k][where] for k in BN_KERNELS}}
        e_st = errs[bn.KERNEL_STATS][where]
        log(f"phase 32 BatchNorm kernels {where} {tuple(shape)} bf16 "
            f"against the plain versions: stats {e_st:.2e} (must be 0), "
            f"bwd_reduce {e_red:.2e} of the largest entry (tol 1e-5); "
            f"bit-identical {exact}; bit-identical over two calls: {same}")
        if not (e_red <= 1e-5
                and all(exact.values()) and same):
            raise AssertionError(f"phase 32 BatchNorm kernels {where}: "
                                 f"{rec[where]}")
        if where == "stage1":
            e = x.numel() * x.element_size()
            calls = {
                bn.KERNEL_STATS: (lambda: bn.stats(x, 1e-5),
                                  lambda: bn.stats_reference(x, 1e-5), e),
                bn.KERNEL_APPLY: (
                    lambda: bn.apply(x, st, w, b, res, True),
                    lambda: bn.apply_reference(x, st, w, b, res, True), 3 * e),
                bn.KERNEL_BWD_REDUCE: (
                    lambda: bn.bwd_reduce(g, x, y, st, w),
                    lambda: bn.bwd_reduce_reference(g, x, y, st, w), 3 * e),
                bn.KERNEL_BWD_DX: (
                    lambda: bn.bwd_dx(g, x, y, st, red, True),
                    lambda: bn.bwd_dx_reference(g, x, y, st, red, True),
                    5 * e)}
            for name, (fn, plain_fn, nbytes) in calls.items():
                ms = cuda_time_ms(fn)
                dev_ms = device_time_ms(fn)[0]
                plain = cuda_time_ms(plain_fn, iters=5)
                b_ms, b_by = bound(nbytes, 0.0, "bf16")
                log(f"{name} stage 1 ({n} frames): {ms:.4f} ms (device "
                    f"{dev_ms:.4f}), plain {plain:.4f}, bound {b_ms:.5f} "
                    f"({b_by}): {dev_ms / b_ms:.2f}x the bound on the device")
                entries.append({
                    "name": name, "route": "cuda",
                    "source": "avec_tpu_torch/csrc/batch_norm.cu",
                    "replaces": "none (XLA fuses BN in the JAX package)",
                    "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del x, g, res, y, st, red, want
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launched = {k: _cuda.launches[k] - n0.get(k, 0) for k in BN_KERNELS}
    for entry in entries:
        name = entry["name"]
        key = ("max_abs_err" if name in (bn.KERNEL_APPLY, bn.KERNEL_BWD_DX)
               else "max_rel_err")
        entry.update({"launches": launched[name],
                      key: max(errs[name].values())})
    detail["batch_norm"] = rec
    return entries


def training_phases(detail, profile: bool):
    """Phases 5-7; returns the four training kernels' entries."""
    import torch.nn.functional as F

    from avec_tpu_torch.models.conformer import FeedForwardModule
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.ffn import KERNEL_BWD, KERNEL_FWD, fused_ffn
    from avec_tpu_torch.ops.flash_attention import (
        BWD_ALL, BWD_DQ, KERNEL_DKV, KERNEL_DQ, ROUNDED_OPERANDS,
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_reference)
    from avec_tpu_torch.ops.layers import init_params
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    dev = torch.device("cuda")
    errs = {KERNEL_FWD: {}, KERNEL_BWD: {}, KERNEL_DQ: {}, KERNEL_DKV: {}}
    abs_errs = {k: 0.0 for k in errs}

    # ---- 5. training kernels against their plain versions
    names = ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2")
    for n, d, f in ((16 * 301, 180, 720), (16 * 151, 256, 1024),
                    (16 * 76, 360, 1440)):
        for dtype, tol, wtol in ((torch.float32, 1e-4, 3e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = ffn_inputs(n, d, f, dtype, seed=d)
            for drop in (0.0, 0.1):
                y, grads = ffn_run(x, g, params, drop, True)
                torch.cuda.synchronize()
                want_y, want = ffn_run(x, g, params, drop, False)
                key = f"N{n}_d{d}_F{f}_{str(dtype)[6:]}_drop{drop}"
                e_fwd = rel_err(y, want_y)
                e_bwd = {nm: rel_err(a, b)
                         for nm, a, b in zip(names, grads, want)}
                errs[KERNEL_FWD][key] = e_fwd
                errs[KERNEL_BWD][key] = e_bwd
                if dtype == torch.float32:
                    abs_errs[KERNEL_FWD] = max(abs_errs[KERNEL_FWD],
                                               max_abs(y, want_y))
                    abs_errs[KERNEL_BWD] = max(
                        abs_errs[KERNEL_BWD],
                        *(max_abs(a, b) for a, b in zip(grads, want)))
                if drop and not torch.equal(y == 0, want_y == 0):
                    raise AssertionError(f"dropout masks differ: {key}")
                worst_w = max(v for nm, v in e_bwd.items() if nm != "x")
                log(f"fused_ffn {key}: y {e_fwd:.2e} dx {e_bwd['x']:.2e} "
                    f"(tol {tol}) params {worst_w:.2e} (tol {wtol})")
                if not (e_fwd <= tol and e_bwd["x"] <= tol
                        and worst_w <= wtol):
                    raise AssertionError(f"FFN kernels disagree: {key} "
                                         f"{e_fwd} {e_bwd}")
            if dtype == torch.bfloat16:
                # K1 sums its hidden-range partials in a fixed order
                with torch.no_grad():
                    ys = [fused_ffn(x, *params, 1234, 1e-6, 0.1, True)
                          for _ in range(2)]
                same = torch.equal(*ys)
                log(f"fused_ffn N{n}_d{d}_F{f}_bfloat16_drop0.1: forward "
                    f"bit-identical over two calls: {same}")
                if not same:
                    raise AssertionError(f"bf16 K1 reruns differ: N{n} d{d}")
            del x, g, params
    bwd_lengths = RAGGED_TRAIN_LENGTHS
    fwd_errs = {}
    for t, d_model in ((151, 256), (76, 360)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v, lens, scale = flash_inputs(16, t, d_model,
                                                bwd_lengths[t], dtype, seed=t)
            gen = torch.Generator().manual_seed(t + 1)
            dout = torch.randn(v.shape, generator=gen).to(dev, dtype)
            out, lse = flash_attention_fwd(q, k, v, lens, scale)
            want_out, want_lse = flash_attention_reference(q, k, v, lens,
                                                           scale)
            key = f"T{t}_D{d_model}_{str(dtype)[6:]}"
            e_fwd = max(max_abs(out, want_out), max_abs(lse, want_lse))
            fwd_errs[key] = e_fwd
            log(f"flash_attention_fwd {key}, B=16: max abs {e_fwd:.3e} "
                f"(tol {tol})")
            if not e_fwd <= tol:
                raise AssertionError(f"flash kernel disagrees: {key} {e_fwd}")
            if dtype == torch.bfloat16:
                flash_fwd_bf16_checks(key, q, k, v, lens, scale, out, lse,
                                      want_out)
            delta = (dout.float() * out.float()).sum(-1).reshape(lse.shape)
            got = flash_attention_bwd(q, k, v, dout, lse, delta, lens, scale)
            torch.cuda.synchronize()
            want = flash_attention_bwd_reference(q, k, v, dout, lse, delta,
                                                 lens, scale)
            e = [rel_err(a, b) for a, b in zip(got, want)]
            errs[KERNEL_DQ][key] = e[0]
            errs[KERNEL_DKV][key] = max(e[1], e[2])
            if dtype == torch.float32:
                abs_errs[KERNEL_DQ] = max(abs_errs[KERNEL_DQ],
                                          max_abs(got[0], want[0]))
                abs_errs[KERNEL_DKV] = max(abs_errs[KERNEL_DKV],
                                           max_abs(got[1], want[1]),
                                           max_abs(got[2], want[2]))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            empty = max(float(a[-1].float().abs().max()) for a in got)
            log(f"flash_attention_bwd {key}: dq {e[0]:.2e} dk {e[1]:.2e} "
                f"dv {e[2]:.2e} (tol {tol}); finite {finite}, length-0 row "
                f"max {empty}")
            if not (max(e) <= tol and finite and empty == 0.0):
                raise AssertionError(f"flash backward disagrees: {key} {e}")
            if dtype == torch.bfloat16:
                # K4b sums each output tile's streamed tiles in a fixed order
                again = flash_attention_bwd(q, k, v, dout, lse, delta, lens,
                                            scale)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"flash_attention_bwd {key}: bit-identical over two "
                    f"calls: {same}")
                if not same:
                    raise AssertionError(f"bf16 K4b reruns differ: {key}")
                # what the three bf16 parts of p and dS buy: the same call
                # through a control build that rounds them to bf16
                launch, rounded = flash_bwd_launcher(
                    q, k, v, dout, lse, delta, lens, scale,
                    _cuda.control_library("flash_attention_bwd",
                                          ROUNDED_OPERANDS))
                launch(BWD_ALL)
                torch.cuda.synchronize()
                e_r = [rel_err(a, b) for a, b in zip(rounded, want)]
                l1 = [rel_l1(a, b) for a, b in zip(got, want)]
                l1_r = [rel_l1(a, b) for a, b in zip(rounded, want)]
                detail[f"flash_bwd_operands_T{t}"] = {
                    "three_parts": {"err": e, "rel_l1": l1},
                    "rounded": {"err": e_r, "rel_l1": l1_r}}
                log(f"flash_attention_bwd {key}: p and dS as three bf16 "
                    f"parts: max error {max(e):.2e}, relative L1 error "
                    f"{max(l1):.2e} (tol {L1_TOL}); rounded to bf16: "
                    f"{max(e_r):.2e}, {max(l1_r):.2e}")
                if max(l1) > L1_TOL:
                    raise AssertionError(f"K4b's fp32 operands lost "
                                         f"precision: {key} {l1}")
    detail["train_kernel_errors"] = errs
    detail["train_flash_fwd_errors"] = fwd_errs

    # ---- 6. training at full width
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, use_flash=True, stem_mode="2d",
                      fused_ffn=True, loss=CTCLoss(zero_infinity=True))
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    batch = make_train_batch(np.random.RandomState(0))
    per_step = model.kernel_launches_per_step()
    log(f"train: {n_params / 1e6:.2f}M params, B=16, audio "
        f"{min(batch['inputs'][3]) / 16000:.2f}-"
        f"{max(batch['inputs'][3]) / 16000:.2f} s; launches per step derived "
        f"from the module tree: {per_step}")
    history, train_launches = counted_train_steps(trainer, batch, per_step)
    fp32 = compare_fp32_step(model, batch, loss_tol=1e-3)
    train = {"params_m": n_params / 1e6, "batch": 16, "steps": history,
             "launches_per_step": per_step, **fp32}

    # ---- 7. timings
    def step_ms(kernels: bool):
        model.set_kernels(kernels)
        trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: trainer.train_step(batch), iters=3,
                          warmup=0)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    runs = [(k, *step_ms(k)) for k in (False, True, True, False)]
    model.set_kernels(True)
    for name, flag in (("kernels", True), ("plain", False)):
        ms = [r[1] for r in runs if r[0] is flag]
        train[f"step_ms_{name}_bf16"] = sum(ms) / len(ms)
        train[f"utterances_per_s_{name}"] = 16 / (sum(ms) / len(ms)) * 1e3
        train[f"peak_gib_{name}"] = max(r[2] for r in runs if r[0] is flag)
    log("train " + json.dumps({k: v for k, v in train.items()
                               if k != "steps"}))

    ffn_shapes, flash_shapes = kernel_call_shapes(trainer, batch)
    acc = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
               "ops": 0.0, "library_ms": 0.0, "library_device_ms": 0.0}
           for k in errs}
    for (n, d, f), count in sorted(ffn_shapes.items()):
        x, g, params = ffn_inputs(n, d, f, torch.bfloat16, seed=n)

        def fwd(use_kernel):
            with torch.no_grad():
                fused_ffn(x, *params, 77, 1e-6, 0.1, True, use_kernel)

        def both(use_kernel):
            ffn_run(x, g, params, 0.1, use_kernel, seed=77)

        got = ffn_run(x, g, params, 0.1, True, seed=77)[1]
        direct = time_ffn_bwd_kernel(x, g, params, 0.1, 77, check=True)
        if max(rel_err(a, b) for a, b in zip(direct, got)) > 3e-2:
            raise AssertionError("direct backward launch disagrees with the "
                                 "wrapper's")

        # the library yardstick: the port's own unfused module on the same
        # input (the `fused_ffn=False` route: LN, Linear, swish, dropout,
        # Linear, dropout through PyTorch's library calls)
        unfused = init_params(FeedForwardModule(d, f, 0.1, fused_ffn=False),
                              torch.Generator().manual_seed(3)).to(dev).train()

        def lib(backward: bool):
            if backward:
                xl = x[None].detach().requires_grad_(True)
                unfused(xl).backward(g[None])
            else:
                with torch.no_grad():
                    unfused(x[None])

        t_f, t_fp = cuda_time_ms(lambda: fwd(True)), cuda_time_ms(
            lambda: fwd(False))
        d_f, stages = device_time_ms(lambda: fwd(True))
        h_f = host_ms(lambda: fwd(True))
        t_b, d_b = time_ffn_bwd_kernel(x, g, params, 0.1, 77)
        t_bp = cuda_time_ms(lambda: both(False)) - t_fp
        t_fl = cuda_time_ms(lambda: lib(False))
        t_bl = cuda_time_ms(lambda: lib(True)) - t_fl
        fb, fo, bb, bo = ffn_cost(n, d, f, 2)
        log(f"fused_ffn N={n} d={d} F={f} x{count}: fwd {t_f:.4f} ms "
            f"(device {d_f:.4f}, plain {t_fp:.4f}, unfused module "
            f"{t_fl:.4f}, bound {bound(fb, fo, 'bf16')[0]:.5f}); bwd "
            f"{t_b:.4f} ms (device {d_b:.4f}, plain {t_bp:.4f}, unfused "
            f"module {t_bl:.4f}, bound {bound(bb, bo, 'bf16')[0]:.5f})")
        log(f"fused_ffn_fwd N={n} d={d} device time of each stage in one "
            f"launch (torch.profiler): "
            + ", ".join(f"{nm} {ms:.4f} ms" for nm, ms in stages.items())
            + f"; whole {d_f:.4f} ms on the device, {t_f:.4f} ms per call "
            f"through the wrapper, {h_f:.4f} ms of host time to issue it")
        detail[f"ffn_N{n}_d{d}"] = {"count": count, "fwd_ms": t_f,
                                    "fwd_device_ms": d_f,
                                    "fwd_host_ms": h_f,
                                    "fwd_kernels_ms": stages,
                                    "fwd_plain_ms": t_fp,
                                    "fwd_library_ms": t_fl, "bwd_ms": t_b,
                                    "bwd_device_ms": d_b,
                                    "bwd_plain_ms": t_bp,
                                    "bwd_library_ms": t_bl}
        for key, ms, dms, pms, lms, nb, no in (
                (KERNEL_FWD, t_f, d_f, t_fp, t_fl, fb, fo),
                (KERNEL_BWD, t_b, d_b, t_bp, t_bl, bb, bo)):
            acc[key]["ms"] += count * ms
            acc[key]["device_ms"] += count * dms
            acc[key]["plain_ms"] += count * pms
            acc[key]["library_ms"] += count * lms
            acc[key]["bytes"] += count * nb
            acc[key]["ops"] += count * no
        del x, g, params, unfused
    for (t, d_model, lens), count in sorted(flash_shapes.items()):
        q, k, v, lt, scale = flash_inputs(16, t, d_model, lens,
                                          torch.bfloat16, seed=9)
        dout = torch.randn_like(v)
        out, lse = flash_attention_fwd(q, k, v, lt, scale)
        delta = (dout.float() * out.float()).sum(-1).reshape(lse.shape)

        def wrapper():
            flash_attention_bwd(q, k, v, dout, lse, delta, lt, scale)

        launch = flash_bwd_launcher(q, k, v, dout, lse, delta, lt, scale)[0]
        t_call = cuda_time_ms(wrapper)
        t_plain = cuda_time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, dout, lse, delta, lt, scale))
        d_call, stages = device_time_ms(wrapper)
        h_call = host_ms(wrapper)
        # the yardstick of the earlier kernels: dq is the C entry computing
        # dq alone (the prep and dq), dk/dV the rest of one call through
        # the wrapper, so the pair sums to that call
        t_dq = cuda_time_ms(lambda: launch(BWD_DQ))
        t_dkv = t_call - t_dq
        t_entry = cuda_time_ms(lambda: launch(BWD_ALL))
        d_prep = sum(ms for nm, ms in stages.items() if "prep" in nm)
        d_dq = d_prep + sum(ms for nm, ms in stages.items()
                            if nm.startswith("flash_bwd_wgmma_kernel<false"))
        d_dkv = sum(ms for nm, ms in stages.items()
                    if nm.startswith("flash_bwd_wgmma_kernel<true"))

        # the library yardstick: SDPA's backward alone, its forward (and
        # graph) made outside the timed call
        keymask = (torch.arange(t, device=dev)[None, :]
                   < lt[:, None])[:, None, None, :]
        leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=keymask,
                                           scale=scale)

        def sdpa_bwd():
            torch.autograd.grad(o, leaves, dout, retain_graph=True)

        t_lib = cuda_time_ms(sdpa_bwd)
        d_lib, lib_kernels = device_time_ms(sdpa_bwd)
        backend = sdpa_backend(lib_kernels)
        del o, leaves
        (dq_b, dq_o), (dkv_b, dkv_o) = flash_bwd_cost(
            4, t, q.shape[-1], v.shape[-1], lens, 2)
        log(f"flash_attention_bwd T={t} D={d_model} x{count}: prep + dq "
            f"{t_dq:.4f} ms (the C entry; device {d_dq:.4f}), dkv "
            f"{t_dkv:.4f} ms (the wrapper's call less that; device "
            f"{d_dkv:.4f}), whole call through the wrapper {t_call:.4f} "
            f"(device {d_call:.4f}), through the C entry {t_entry:.4f}, "
            f"plain (both) "
            f"{t_plain:.4f}, sdpa backward alone {t_lib:.4f} (device "
            f"{d_lib:.4f}; backend: {backend}); bounds "
            f"{bound(dq_b, dq_o, 'bf16')[0]:.5f} / "
            f"{bound(dkv_b, dkv_o, 'bf16')[0]:.5f}")
        log(f"flash_attention_bwd T={t} device time of each kernel in one "
            f"call (torch.profiler): "
            + ", ".join(f"{nm} {ms:.4f} ms" for nm, ms in stages.items())
            + f"; whole {d_call:.4f} ms on the device, {t_call:.4f} ms per "
            f"call through the wrapper, {h_call:.4f} ms of host time to "
            f"issue it")
        log(f"sdpa backward T={t} kernels (torch.profiler): "
            + ", ".join(f"{nm[:60]} {ms:.4f} ms" for nm, ms in sorted(
                lib_kernels.items(), key=lambda kv: -kv[1])[:6]))
        detail[f"flash_bwd_T{t}"] = {"count": count, "dq_ms": t_dq,
                                     "dkv_ms": t_dkv, "call_ms": t_call,
                                     "entry_ms": t_entry,
                                     "dq_device_ms": d_dq,
                                     "dkv_device_ms": d_dkv,
                                     "call_device_ms": d_call,
                                     "call_host_ms": h_call,
                                     "kernels_ms": stages,
                                     "plain_ms": t_plain, "library_ms": t_lib,
                                     "library_device_ms": d_lib,
                                     "library_backend": backend,
                                     "library_kernels_ms": lib_kernels,
                                     "lengths": list(lens)}
        for key, ms, dms, nb, no in (
                (KERNEL_DQ, t_dq, d_dq, dq_b, dq_o),
                (KERNEL_DKV, t_dkv, d_dkv, dkv_b, dkv_o)):
            acc[key]["ms"] += count * ms
            acc[key]["device_ms"] += count * dms
            acc[key]["plain_ms"] += count * t_plain
            acc[key]["library_ms"] += count * t_lib
            acc[key]["library_device_ms"] += count * d_lib
            acc[key]["bytes"] += count * nb
            acc[key]["ops"] += count * no

    if profile:
        detail["profile_train"] = profile_train_step(trainer, batch)
    detail["training"] = train

    sources = {KERNEL_FWD: ("avec_tpu_torch/csrc/ffn.cu",
                            "avec_tpu/ops/pallas_ffn.py:253"),
               KERNEL_BWD: ("avec_tpu_torch/csrc/ffn.cu",
                            "avec_tpu/ops/pallas_ffn.py:279"),
               KERNEL_DQ: ("avec_tpu_torch/csrc/flash_attention_bwd.cu",
                           "avec_tpu/ops/pallas_attention.py:316"),
               KERNEL_DKV: ("avec_tpu_torch/csrc/flash_attention_bwd.cu",
                            "avec_tpu/ops/pallas_attention.py:339")}
    entries = []
    for key, (src, replaces) in sources.items():
        b_ms, b_by = bound(acc[key]["bytes"], acc[key]["ops"], "bf16")
        entries.append({
            "name": key, "route": "cuda", "source": src, "replaces": replaces,
            "launches": train_launches[key], "max_abs_err": abs_errs[key],
            "ms": acc[key]["ms"], "device_ms": acc[key]["device_ms"],
            "plain_ms": acc[key]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": acc[key]["library_ms"]})
        if key in (KERNEL_DQ, KERNEL_DKV):
            entries[-1]["library_device_ms"] = acc[key]["library_device_ms"]
    return entries, trainer, batch


def att_inputs(b, t, d, dtype, seed):
    """x, a cotangent and the attention module's twelve parameters in the
    port's layout (weights (out, in)), seeded."""
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    g = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    params = [1.0 + 0.1 * torch.randn(d, generator=gen),
              0.1 * torch.randn(d, generator=gen)]
    for _ in range(5):
        params += [torch.randn(d, d, generator=gen) / d ** 0.5,
                   0.1 * torch.randn(d, generator=gen)]
    return x, g, [p.to(dev) for p in params]


def att_run(x, g, params, heads, lens, drop, residual, use_kernel, seed=4321):
    """y and the gradients of x and the twelve parameters."""
    from avec_tpu_torch.ops.attention_module import fused_attention_module_3d

    leaves = [a.detach().requires_grad_(True) for a in [x] + params]
    y = fused_attention_module_3d(
        leaves[0], *leaves[1:], num_heads=heads, lengths=lens, seed=seed,
        drop_rate=drop, deterministic=False, residual=residual,
        use_kernel=use_kernel)
    y.backward(g)
    return y.detach(), [a.grad for a in leaves]


def att_cost(b, t, d, heads, es):
    """(forward bytes, forward ops, backward bytes, backward ops) of the
    attention module with n = b t rows: x read and y written once, the fp32
    parameters (2 d + 5 (d^2 + d)) and the (t, d) angle table read once, the
    lengths; in the backward x, g and dx, the parameters read and their
    gradients written. Forward products: q, k, v and the output projection
    (8 n d^2), the rel-pos projection of q (2 n d^2), q k^T and att v
    (4 b t^2 d), the rel-pos score term contracted over d for every head
    (2 heads b t^2 d). The backward recomputes all but the output projection
    and adds dWo and the merged heads' cotangent (4 n d^2), dO V^T, dv, ds k
    and dk (8 b t^2 d), ds against the angle table (2 heads b t^2 d), the
    rel-pos projection's two gradients (4 n d^2), dWq/dWk/dWv and dh
    (12 n d^2). Every sequence is computed at full T whatever its length: the
    mask is additive."""
    n, pbytes = b * t, 4 * (2 * d + 5 * (d * d + d))
    table = t * d * es + 4 * b
    sq = float(b) * t * t * d
    f_ops = 10.0 * n * d * d + sq * (4 + 2 * heads)
    b_ops = 28.0 * n * d * d + sq * (12 + 4 * heads)
    return (2 * n * d * es + pbytes + table, f_ops,
            3 * n * d * es + 2 * pbytes + table, b_ops)


def time_att_bwd_kernel(x, g, params, heads, lens, drop, seed):
    """Time, device time (whole and by stage kernel) and host time to issue
    one fused-attention backward call alone (all its stages), through the
    library's C entry point with the wrapper's own arguments and
    preallocated scratch and gradient buffers; this call is outside any
    count."""
    from avec_tpu_torch.ops import _cuda, attention_module as am
    from avec_tpu_torch.ops.ffn import _threshold

    b, t, d = x.shape
    _, bwd, size = am._lib()
    thr, inv_keep = _threshold(1.0 - drop)
    tab = am._interleaved_table(t, d, x.dtype, x.device)
    scratch = torch.empty(size(b, t, d, heads, 1,
                               int(x.dtype == torch.bfloat16)),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.zeros_like(p) for p in params]
    pp, gp = am._pointers(params), am._pointers(grads)
    args = (x.data_ptr(), g.data_ptr(), tab.data_ptr(), lens.data_ptr(), pp,
            dx.data_ptr(), gp, scratch.data_ptr(), b, t, d, heads, 1e-6,
            1.0 / math.sqrt(d // heads), 0, 1, seed, thr, inv_keep,
            int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))

    def launch():
        _cuda.check(bwd(*args), "fused_att_bwd")

    return (cuda_time_ms(launch), *device_time_ms(launch), host_ms(launch))


def att_fwd_launcher(x, params, heads, lens, drop, seed):
    """One fused-attention forward through the library's C entry point with
    the wrapper's arguments over preallocated scratch and output; outside
    any count."""
    from avec_tpu_torch.ops import _cuda, attention_module as am
    from avec_tpu_torch.ops.ffn import _threshold

    b, t, d = x.shape
    fwd, _, size = am._lib()
    thr, inv_keep = _threshold(1.0 - drop)
    bf = int(x.dtype == torch.bfloat16)
    tab = am._interleaved_table(t, d, x.dtype, x.device)
    scratch = torch.empty(size(b, t, d, heads, 0, bf), dtype=torch.float32,
                          device=x.device)
    y = torch.empty_like(x)
    args = (x.data_ptr(), tab.data_ptr(), lens.data_ptr(), am._pointers(params),
            y.data_ptr(), scratch.data_ptr(), b, t, d, heads, 1e-6,
            1.0 / math.sqrt(d // heads), 0, 1, seed, thr, inv_keep, bf,
            _cuda.stream_ptr(x))

    def launch():
        _cuda.check(fwd(*args), "fused_att_fwd (direct)")

    return launch


# stage kernels of the bf16 K2 forward at the step's shapes (tensor cores),
# and the mma.sync stages it must no longer run there
ATT_FWD_STAGES = ("prep16_kernel", "proj16_kernel<0>", "proj16_kernel<1>")
ATT_FWD_OLD = ("qkv16_kernel", "relpos16_kernel", "att16_kernel<false>",
               "out_proj16_kernel", "cast16_kernel", "ln_h16_kernel")


def attention_call_shapes(trainer, batch):
    """One forward in training mode with hooks: how often each fused
    attention shape (T, d, heads, lengths) occurs in a step."""
    from avec_tpu_torch.models.conformer import AttentionModule

    shapes, hooks = {}, []

    def on_att(mod, args, kwargs):
        x, lengths = args[0], kwargs.get("lengths")
        key = (x.shape[1], x.shape[2], mod.attention.num_heads,
               tuple(int(v) for v in lengths.tolist()))
        shapes[key] = shapes.get(key, 0) + 1

    for m in trainer.model.modules():
        if isinstance(m, AttentionModule) and m.fused_eligible():
            hooks.append(m.register_forward_pre_hook(on_att,
                                                     with_kwargs=True))
    inputs, _ = trainer._to_device(batch)
    with torch.no_grad():
        trainer.model.encoder(*inputs)
    for hk in hooks:
        hk.remove()
    return shapes


def fused_phases(detail, profile: bool, trainer2, batch):
    """Phases 8-11: the fused attention module (K2, K2b) and the train-mode
    stem against their plain versions, the train path that runs them at full
    width, and its times beside the flash path's (`trainer2`). Returns the
    two attention kernels' entries and the stem kernel's launch count on this
    path."""
    from avec_tpu_torch.models.conformer import AttentionModule
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.attention_module import (
        KERNEL_BWD, KERNEL_FWD, fused_attention_module_3d)
    from avec_tpu_torch.ops.ffn import dropout_mask
    from avec_tpu_torch.ops.layers import init_params
    from avec_tpu_torch.ops.stem import KERNEL as KERNEL_STEM
    from avec_tpu_torch.ops.stem import (bn_relu_pool, bn_relu_pool_reference,
                                         fused_stem_train)
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    dev = torch.device("cuda")
    errs = {KERNEL_FWD: {}, KERNEL_BWD: {}}
    abs_errs = {KERNEL_FWD: 0.0, KERNEL_BWD: 0.0}

    # ---- 8. K2 / K2b against the plain version at both shape families
    for t, d in ((151, 256), (76, 360)):
        lens = torch.tensor(RAGGED_TRAIN_LENGTHS[t], dtype=torch.int32,
                            device=dev)
        for dtype, tol, wtol in ((torch.float32, 1e-4, 5e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = att_inputs(16, t, d, dtype, seed=t)
            for drop, residual in ((0.0, False), (0.0, True), (0.1, False),
                                   (0.1, True)):
                y, grads = att_run(x, g, params, 4, lens, drop, residual,
                                   True)
                torch.cuda.synchronize()
                want_y, want = att_run(x, g, params, 4, lens, drop, residual,
                                       False)
                key = (f"T{t}_d{d}_{str(dtype)[6:]}_drop{drop}_"
                       f"res{int(residual)}")
                gmax = max(float(a.abs().max()) for a in want[1:])
                e_fwd = rel_err(y, want_y)
                e_bwd = {nm: rel_err(a, b)
                         for nm, a, b in zip(ATT_LEAVES, grads, want)
                         if float(b.float().abs().max()) > 1e-6 * gmax}
                errs[KERNEL_FWD][key] = e_fwd
                errs[KERNEL_BWD][key] = e_bwd
                if dtype == torch.float32:
                    abs_errs[KERNEL_FWD] = max(abs_errs[KERNEL_FWD],
                                               max_abs(y, want_y))
                    abs_errs[KERNEL_BWD] = max(
                        abs_errs[KERNEL_BWD],
                        *(max_abs(a, b) for a, b in zip(grads, want)))
                if drop:
                    # exactly the hash mask's entries are dropped, on both
                    # sides: there y is 0, or x with the residual
                    base = x if residual else torch.zeros_like(x)
                    dropped = dropout_mask(4321, 16 * t, d, 1, 1.0 - drop, dev,
                                           tile_rows=t).reshape(16, t, d) == 0
                    kept_equal = float(((y == base) & ~dropped).float().mean())
                    if not (bool((y[dropped] == base[dropped]).all())
                            and bool((want_y[dropped] == base[dropped]).all())
                            and kept_equal < 5e-3):
                        raise AssertionError(f"dropout masks differ: {key}")
                worst_w = max(v for nm, v in e_bwd.items() if nm != "x")
                log(f"fused_att {key}: y {e_fwd:.2e} (tol {tol}) dx "
                    f"{e_bwd['x']:.2e} params {worst_w:.2e} (tol {wtol}); "
                    + " ".join(f"{nm} {v:.1e}" for nm, v in e_bwd.items()
                               if nm != "x"))
                x_tol = wtol if dtype == torch.float32 else tol
                if not (e_fwd <= tol and e_bwd["x"] <= x_tol
                        and worst_w <= wtol):
                    raise AssertionError(f"attention kernels disagree: {key} "
                                         f"{e_fwd} {e_bwd}")
            del x, g, params
    detail["att_kernel_errors"] = errs

    # ---- 9. the train-mode stem on the card: kernel route vs plain route
    gen = torch.Generator().manual_seed(11)
    video = torch.rand(16, 151, 88, 88, 1, generator=gen).to(dev)
    cot = torch.randn(16 * 151, 22, 22, 64, generator=gen).to(dev)
    conv_w = (torch.randn(64, 1, 5, 7, 7, generator=gen) / 245 ** 0.5).to(dev)
    vecs = [(0.1 * torch.randn(64, generator=gen) + shift).to(dev)
            for shift in (0.0, 1.0, 0.0)]           # conv bias, BN scale, bias
    stem_errs = {}
    for dtype, tol, gtol in ((torch.float32, 1e-5, 1e-4),
                             (torch.bfloat16, 0.0, 1e-2)):
        res = []
        for use_kernel in (True, False):
            leaves = [a.detach().clone().requires_grad_(True)
                      for a in [conv_w] + vecs]
            n0 = _cuda.launches[KERNEL_STEM]
            pooled, mean, var = fused_stem_train(video.to(dtype), *leaves,
                                                 1e-5, use_kernel)
            pooled.backward(cot.to(dtype))
            torch.cuda.synchronize()
            if _cuda.launches[KERNEL_STEM] - n0 != int(use_kernel):
                raise AssertionError("stem route launched the wrong kernel "
                                     "count")
            res.append((pooled.detach(), mean, var,
                        [a.grad for a in leaves]))
            del pooled, leaves
        (pk, mk, vk, gk), (pp, mp, vp, gp) = res
        e = {"pooled": max_abs(pk, pp), "mean": max_abs(mk, mp),
             "var": max_abs(vk, vp), "conv_w": rel_err(gk[0], gp[0]),
             "bn_scale": rel_err(gk[2], gp[2]),
             "bn_bias": rel_err(gk[3], gp[3]),
             "conv_bias_grad_max": float(gk[1].abs().max())}
        stem_errs[str(dtype)[6:]] = e
        log(f"fused_stem_train {str(dtype)[6:]} kernel vs plain route: "
            + json.dumps(e) + f" (tol {tol} forward, {gtol} gradients)")
        if not (e["pooled"] <= tol and e["mean"] <= 1e-5 and e["var"] <= 1e-5
                and max(e["conv_w"], e["bn_scale"], e["bn_bias"]) <= gtol
                and e["conv_bias_grad_max"] == 0.0
                and float(gp[1].abs().max()) == 0.0):
            raise AssertionError(f"train-mode stem routes disagree: {e}")
        del res, pk, pp, gk, gp
    del video, cot
    # the stem kernel at the training shape: 16 x 151 frames, bf16
    y = torch.randn(16 * 151, 44, 44, 64, generator=gen).to(dev,
                                                            torch.bfloat16)
    a5, b5 = vecs[1].contiguous(), vecs[2].contiguous()
    s_ms = cuda_time_ms(lambda: bn_relu_pool(y, a5, b5))
    s_dev = device_time_ms(lambda: bn_relu_pool(y, a5, b5))[0]
    s_plain = cuda_time_ms(lambda: bn_relu_pool_reference(y, a5, b5))
    s_bytes = y.numel() * 2 + (y.numel() // 4) * 2 + 2 * 64 * 4
    s_bound, s_by = bound(s_bytes, 3.0 * y.numel(), "bf16")
    log(f"bn_relu_pool N={y.shape[0]} (training shape): {s_ms:.4f} ms "
        f"(device {s_dev:.4f}), plain {s_plain:.4f}, bound {s_bound:.5f} "
        f"({s_by}): {s_ms / s_bound:.2f}x the bound (device "
        f"{s_dev / s_bound:.2f}x)")
    detail["stem_train"] = {"ms": s_ms, "device_ms": s_dev,
                            "plain_ms": s_plain,
                            "bytes": s_bytes, "bound_ms": s_bound}
    del y
    torch.cuda.empty_cache()
    detail["stem_train_errors"] = stem_errs

    # ---- 10. the fused-attention train path at full width
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, use_flash=False, stem_mode="pallas",
                      fused_att=True, fused_ffn=True,
                      loss=CTCLoss(zero_infinity=True))
    model = trainer.model
    per_step = model.kernel_launches_per_step()
    log(f"train (fused attention, stem pallas, no flash): launches per step "
        f"derived from the module tree: {per_step}")
    # BatchNorm kernels: the trunk's 19, the audio stem's and the 24 conv
    # modules' BatchNorms, the stem's statistics and BN backward
    want_steps = {"fused_att_fwd": 19, "fused_att_bwd": 19,
                  "fused_ffn_fwd": 48, "fused_ffn_bwd": 48, "bn_relu_pool": 1,
                  **bn_launches(44, 1)}
    if per_step != want_steps:
        raise AssertionError(f"launches per step {per_step} != {want_steps}")
    history, launches = counted_train_steps(trainer, batch, per_step)
    fp32 = compare_fp32_step(model, batch, loss_tol=1e-5)
    train = {"steps": history, "launches_per_step": per_step, **fp32}

    # ---- 11. timings: this path beside the flash path, interleaved
    def step_ms(tr):
        tr.model.set_kernels(True)
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: tr.train_step(batch), iters=3, warmup=0)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    runs = [(name, *step_ms(tr)) for name, tr in (
        ("flash", trainer2), ("fused_att", trainer), ("fused_att", trainer),
        ("flash", trainer2))]
    for name in ("fused_att", "flash"):
        ms = [r[1] for r in runs if r[0] == name]
        train[f"step_ms_{name}_path_bf16"] = sum(ms) / len(ms)
        train[f"utterances_per_s_{name}_path"] = 16 / (sum(ms) / len(ms)) * 1e3
        train[f"peak_gib_{name}_path"] = max(r[2] for r in runs
                                             if r[0] == name)
    train["step_ms_runs_in_order"] = [[r[0], r[1]] for r in runs]
    log("train (fused attention path beside the flash path) "
        + json.dumps({k: v for k, v in train.items() if k != "steps"}))

    acc = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bytes": 0, "ops": 0.0} for k in errs}
    for (t, d, heads, lens), count in sorted(
            attention_call_shapes(trainer, batch).items()):
        x, g, params = att_inputs(16, t, d, torch.bfloat16, seed=t + 1)
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)

        def fwd(use_kernel):
            with torch.no_grad():
                fused_attention_module_3d(
                    x, *params, num_heads=heads, lengths=lt, seed=77,
                    drop_rate=0.1, deterministic=False, residual=False,
                    use_kernel=use_kernel)

        def both(use_kernel):
            att_run(x, g, params, heads, lt, 0.1, False, use_kernel, seed=77)

        # the library yardstick: the port's own unfused module on the same
        # input (LN, three Linear, factorized scores, softmax, Linear,
        # dropout through PyTorch's library calls)
        unfused = init_params(
            AttentionModule(d, {"class": "RelPos1dMultiHeadAttention",
                                "params": {"num_heads": heads}}, 0.1,
                            fused_att=False, residual=False),
            torch.Generator().manual_seed(3)).to(dev).train()
        mask = (torch.arange(t, device=dev)[None, :]
                < lt[:, None])[:, None, None, :]

        def lib(backward: bool):
            if backward:
                unfused(x.detach().requires_grad_(True), mask=mask).backward(g)
            else:
                with torch.no_grad():
                    unfused(x, mask=mask)

        t_f, t_fp = cuda_time_ms(lambda: fwd(True)), cuda_time_ms(
            lambda: fwd(False))
        d_f, k_f = device_time_ms(lambda: fwd(True))
        h_f = host_ms(lambda: fwd(True))
        h_fe = host_ms(att_fwd_launcher(x, params, heads, lt, 0.1, 77))
        t_b, d_b, k_b, h_b = time_att_bwd_kernel(x, g, params, heads, lt, 0.1,
                                                 77)
        ran_old = [k for k in k_f if k in ATT_FWD_OLD]
        if (ran_old or not all(k in k_f for k in ATT_FWD_STAGES)
                or not any(k.startswith("att_fwd16_kernel<") for k in k_f)):
            raise AssertionError(f"K2 at T={t} d={d} did not run its "
                                 f"tensor-core stages: {sorted(k_f)}")
        log(f"fused_att T={t} d={d}: device time of each stage in one call "
            "(torch.profiler): forward "
            + ", ".join(f"{nm} {ms:.4f} ms" for nm, ms in k_f.items())
            + "; backward " + ", ".join(f"{nm} {ms:.4f} ms"
                                        for nm, ms in k_b.items())
            + f"; host time to issue a call: forward {h_f:.4f} ms through "
            f"the wrapper, {h_fe:.4f} ms through the C entry alone; backward "
            f"{h_b:.4f} ms (the C entry)")
        t_bp = cuda_time_ms(lambda: both(False)) - t_fp
        t_fl = cuda_time_ms(lambda: lib(False))
        t_bl = cuda_time_ms(lambda: lib(True)) - t_fl
        fb, fo, bb, bo = att_cost(16, t, d, heads, 2)
        log(f"fused_att T={t} d={d} H={heads} x{count}: fwd {t_f:.4f} ms "
            f"(device {d_f:.4f}, plain {t_fp:.4f}, unfused module "
            f"{t_fl:.4f}, bound {bound(fb, fo, 'bf16')[0]:.5f}); bwd "
            f"{t_b:.4f} ms (device {d_b:.4f}, plain "
            f"{t_bp:.4f}, unfused module {t_bl:.4f}, bound "
            f"{bound(bb, bo, 'bf16')[0]:.5f}); bytes {fb} / {bb}, "
            f"operations {fo:.4g} / {bo:.4g}")
        detail[f"att_T{t}_d{d}"] = {
            "count": count, "fwd_ms": t_f, "fwd_device_ms": d_f,
            "fwd_plain_ms": t_fp, "fwd_library_ms": t_fl, "bwd_ms": t_b,
            "bwd_device_ms": d_b, "bwd_plain_ms": t_bp,
            "bwd_library_ms": t_bl, "fwd_bytes": fb, "fwd_ops": fo,
            "bwd_bytes": bb, "bwd_ops": bo, "lengths": list(lens),
            "fwd_kernels_ms": k_f, "bwd_kernels_ms": k_b, "fwd_host_ms": h_f,
            "bwd_host_ms": h_b, "fwd_entry_host_ms": h_fe}
        for key, ms, dms, pms, lms, nb, no in (
                (KERNEL_FWD, t_f, d_f, t_fp, t_fl, fb, fo),
                (KERNEL_BWD, t_b, d_b, t_bp, t_bl, bb, bo)):
            acc[key]["ms"] += count * ms
            acc[key]["device_ms"] += count * dms
            acc[key]["plain_ms"] += count * pms
            acc[key]["library_ms"] += count * lms
            acc[key]["bytes"] += count * nb
            acc[key]["ops"] += count * no
        del x, g, params, unfused

    if profile:
        detail["profile_train_fused_att"] = profile_train_step(trainer, batch)
    detail["training_fused_att"] = train

    replaces = {KERNEL_FWD: "avec_tpu/ops/pallas_attention_module.py:316",
                KERNEL_BWD: "avec_tpu/ops/pallas_attention_module.py:345"}
    entries = []
    for key in (KERNEL_FWD, KERNEL_BWD):
        b_ms, b_by = bound(acc[key]["bytes"], acc[key]["ops"], "bf16")
        entries.append({
            "name": key, "route": "cuda",
            "source": "avec_tpu_torch/csrc/attention_module.cu",
            "replaces": replaces[key], "launches": launches[key],
            "max_abs_err": abs_errs[key], "ms": acc[key]["ms"],
            "device_ms": acc[key]["device_ms"],
            "plain_ms": acc[key]["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": acc[key]["library_ms"]})
    return entries, launches[KERNEL_STEM], trainer


CONV_SHAPES = ((16, 301, 180, 15), (16, 151, 256, 15), (16, 76, 360, 15))


# what K3b-2 writes: dx and the gradients of LN, pw1 and the depthwise taps
BWD2_LEAVES = ("x", "ln_w", "ln_b", "pw1_w", "pw1_b", "dw_w")


def conv_inputs(b, t, d, k, dtype, seed):
    """x, a cotangent and the convolution module's ten parameters in the
    port's Conv layout (E = E' = d), seeded."""
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    x = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    g = torch.randn(b, t, d, generator=gen).to(dev, dtype)
    vec = lambda: 0.1 * torch.randn(d, generator=gen)
    u = lambda shape, fan: ((2 * torch.rand(shape, generator=gen) - 1)
                            / fan ** 0.5)
    params = [1.0 + vec(), vec(), u((2 * d, d, 1), d), u((2 * d,), d),
              u((d, 1, k), k), u((d,), k), 1.0 + vec(), vec(), u((d, d, 1), d),
              u((d,), d)]
    return x, g, [p.to(dev) for p in params]


def conv_run(x, g, params, padding, drop, use_kernel, seed=4321, dp=False):
    """(y, mean, var) and the gradients of x and the ten parameters; with
    `dp`, through the K3dp form on this rank's shard x (global statistics,
    partial parameter gradients)."""
    from avec_tpu_torch.ops import conv_module as cm

    fn = cm.fused_conv_module_3d_dp if dp else cm.fused_conv_module_3d
    leaves = [a.detach().requires_grad_(True) for a in [x] + params]
    y, mean, var = fn(
        leaves[0], *leaves[1:], seed=seed, padding=padding, drop_rate=drop,
        deterministic=False, use_kernel=use_kernel)
    y.backward(g)
    return [y.detach(), mean, var], [a.grad for a in leaves]


def conv_cost(b, t, d, e, eo, k, es):
    """Bytes and operations of each of the four passes, keyed by kernel name.
    Bytes: each input read once (x, g, the fp32 parameters a pass reads, the
    (E,) statistics) and each output written once. Operations: what the pass
    adds to the module's work; the recomputed forward is the kernels' own
    work, not the bound's. K3-stats: pw1, both halves (4 n d E), and the
    depthwise taps (2 n E k); K3-fwd: pw2 (2 n E E'); K3b-1: dW2 and
    ds = g W2 (4 n E E'); K3b-2: dW1 and dh, both halves (8 n d E), and the
    depthwise data and tap gradients (4 n E k)."""
    from avec_tpu_torch.ops.conv_module import KERNELS

    n = b * t
    pre = 4 * (2 * d + 2 * e * d + 2 * e + k * e + e)
    full = pre + 4 * (2 * e + eo * e + eo)
    cost = ((n * d * es + pre + 8 * e, 4.0 * n * d * e + 2.0 * n * e * k),
            (n * d * es + full + 8 * e + n * eo * es, 2.0 * n * e * eo),
            (n * (d + eo) * es + full + 8 * e + 4 * (eo * e + eo + 2 * e),
             4.0 * n * e * eo),
            (n * (2 * d + eo) * es + full + 16 * e
             + 4 * (2 * d + 2 * e * d + 2 * e + k * e),
             8.0 * n * d * e + 4.0 * n * e * k))
    return dict(zip(KERNELS, cost))


def time_conv_passes(x, g, params, drop, seed):
    """ms per launch of each of the four passes alone, through the library's
    C entry points with the wrapper's own arguments, preallocated outputs and
    scratch, and this input's batch statistics (the accumulators are not
    re-zeroed: timing only). Outside any count. Beside each pass's time
    (`cuda_time_ms`): under "<name>_device" and "<name>_kernels" its device
    time, whole and by kernel (`device_time_ms`), and under "<name>_host"
    the host's time to issue it (`host_ms`)."""
    from avec_tpu_torch.ops import _cuda, conv_module as cm

    k = params[4].shape[-1]
    call = cm._Launch(x, params, seed, cm.pad_lo_for("same", k), 1e-6, drop)
    b, t, d, e, eo, _ = call.dims
    n = b * t
    s1, s2 = call.stats()
    mean, _, rstd = cm.batch_stats(s1, s2, n, 1e-5)
    zeros = lambda *shape: torch.zeros(shape, device=x.device)
    keep = []                     # the buffers behind the pointers below

    def ptr(a):
        keep.append(a)
        return a.data_ptr()

    grads = [zeros(d), zeros(d), zeros(2 * e, d), zeros(2 * e), zeros(e, k)]
    args = (
        (ptr(x), call.ptrs, ptr(zeros(e)), ptr(zeros(e))),
        (ptr(x), call.ptrs, ptr(mean), ptr(rstd),
         ptr(torch.empty(b, t, eo, dtype=x.dtype, device=x.device))),
        (ptr(x), ptr(g), call.ptrs, ptr(mean), ptr(rstd), ptr(zeros(eo, e)),
         ptr(zeros(eo)), ptr(zeros(e)), ptr(zeros(e))),
        (ptr(x), ptr(g), call.ptrs, ptr(mean), ptr(rstd), ptr(zeros(e)),
         ptr(zeros(e)), ptr(torch.empty_like(x)), cm._pointers(grads)))
    times = {}
    for stage, name in enumerate(cm.KERNELS):
        fn, a = (call.fns[stage],
                 args[stage] + (ptr(call.scratch(stage)),) + call.tail[:-1])

        def launch():
            _cuda.check(fn(*a, _cuda.stream_ptr(x)), name)

        times[name] = cuda_time_ms(launch)
        times[name + "_device"], times[name + "_kernels"] = device_time_ms(
            launch)
        times[name + "_host"] = host_ms(launch)
    return times


def conv_call_shapes(trainer, batch):
    """One forward in training mode with hooks: how often each fused
    convolution shape (B, T, d, E, k) occurs in a step."""
    from avec_tpu_torch.models.conformer import ConvolutionModule

    shapes, hooks = {}, []

    def on_conv(mod, args):
        x = args[0]
        key = (x.shape[0], x.shape[1], x.shape[2],
               mod.layers["4"].weight.shape[0],
               mod.layers["3"].weight.shape[-1])
        shapes[key] = shapes.get(key, 0) + 1

    for m in trainer.model.modules():
        if isinstance(m, ConvolutionModule) and m.fused_eligible():
            hooks.append(m.register_forward_pre_hook(on_conv))
    inputs, _ = trainer._to_device(batch)
    with torch.no_grad():
        trainer.model.encoder(*inputs)
    for hk in hooks:
        hk.remove()
    return shapes


def conv_phases(detail, profile: bool, trainer_att, batch):
    """Phases 12-14: K3 / K3b against the plain stages, the train path that
    runs every training kernel at full width, and its times beside phase
    10's path (`trainer_att`). Returns the four conv kernels' entries and
    the step's fused convolution shapes {(B, T, d, E, k): count}."""
    from avec_tpu_torch.models.conformer import ConvolutionModule
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.ops.ffn import dropout_mask
    from avec_tpu_torch.ops.layers import init_params
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    dev = torch.device("cuda")
    names = ("x",) + cm.PARAM_NAMES
    errs, abs_errs = {}, {name: 0.0 for name in cm.KERNELS}
    # which outputs each pass produces (for the fp32 max abs of the kernels
    # line): stats the batch statistics, fwd y, bwd1 the pw2 and BN
    # gradients, bwd2 dx and the rest
    owner = {"mean": cm.KERNEL_STATS, "var": cm.KERNEL_STATS,
             "y": cm.KERNEL_FWD, "pw2_w": cm.KERNEL_BWD1,
             "pw2_b": cm.KERNEL_BWD1, "bn_w": cm.KERNEL_BWD1,
             "bn_b": cm.KERNEL_BWD1}

    # ---- 12. K3 / K3b against the plain stages at the three families
    for b, t, d, k in CONV_SHAPES:
        for dtype, tol, wtol in ((torch.float32, 1e-4, 5e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = conv_inputs(b, t, d, k, dtype, seed=d)
            for padding, drop in (("same", 0.0), ("same", 0.1),
                                  ("causal", 0.0), ("causal", 0.1)):
                outs, grads = conv_run(x, g, params, padding, drop, True)
                torch.cuda.synchronize()
                want_outs, want = conv_run(x, g, params, padding, drop, False)
                key = f"T{t}_d{d}_{str(dtype)[6:]}_{padding}_drop{drop}"
                e = {nm: rel_err(a, w) for nm, a, w in zip(
                    ("y", "mean", "var"), outs, want_outs)}
                e.update({nm: rel_err(a, w) for nm, a, w in zip(names, grads,
                                                                want)
                          if nm != "dw_b"})
                e["dw_b_grad_max"] = float(grads[names.index("dw_b")].abs()
                                           .max())
                errs[key] = e
                if dtype == torch.float32:
                    pairs = list(zip(("y", "mean", "var"), outs, want_outs))
                    pairs += list(zip(names, grads, want))
                    for nm, a, w in pairs:
                        kern = owner.get(nm, cm.KERNEL_BWD2)
                        abs_errs[kern] = max(abs_errs[kern], max_abs(a, w))
                if drop:
                    dropped = dropout_mask(4321, b * t, d, 1, 1.0 - drop, dev,
                                           tile_rows=t).reshape(b, t, d) == 0
                    for y in (outs[0], want_outs[0]):
                        kept_zero = float((y[~dropped] == 0).float().mean())
                        if not (bool((y[dropped] == 0).all())
                                and kept_zero < 5e-3):
                            raise AssertionError(
                                f"dropout masks differ: {key}")
                fwd_err = max(e["y"], e["mean"], e["var"])
                worst_w = max(v for nm, v in e.items()
                              if nm in cm.PARAM_NAMES)
                x_tol = wtol if dtype == torch.float32 else tol
                log(f"fused_conv {key}: y {e['y']:.2e} mean {e['mean']:.2e} "
                    f"var {e['var']:.2e} (tol {tol}) dx {e['x']:.2e} (tol "
                    f"{x_tol}) params {worst_w:.2e} (tol {wtol}); "
                    + " ".join(f"{nm} {v:.1e}" for nm, v in e.items()
                               if nm in cm.PARAM_NAMES)
                    + f"; dw_b grad max {e['dw_b_grad_max']}")
                if not (fwd_err <= tol and e["x"] <= x_tol
                        and worst_w <= wtol and e["dw_b_grad_max"] == 0.0
                        and float(want[names.index("dw_b")].abs().max())
                        == 0.0):
                    raise AssertionError(f"conv kernels disagree: {key} {e}")
            # K3-stats sums its per-block partials in a fixed order, in
            # both types: two calls give the same s1 and s2
            call = cm._Launch(x, params, 4321, cm.pad_lo_for("same", k),
                              1e-6, 0.1)
            sums = [call.stats() for _ in range(2)]
            same_s = all(torch.equal(u, v) for u, v in zip(*sums))
            log(f"fused_conv T{t}_d{d}_{str(dtype)[6:]}: K3-stats's s1, s2 "
                f"bit-identical over two calls: {same_s}")
            if not same_s:
                raise AssertionError(f"K3-stats reruns differ: T{t} {dtype}")
            if dtype == torch.bfloat16:
                # y has one owner per element and both backward passes sum
                # without atomics: from the same inputs, K3-fwd's y, then
                # K3b-1's four sums, then K3b-2's dx and its five gradients
                mean, _, rstd = cm.batch_stats(*sums[0], b * t, 1e-5)
                same0 = torch.equal(call.fwd(mean, rstd),
                                    call.fwd(mean, rstd))
                log(f"fused_conv T{t}_d{d}_bfloat16_same_drop0.1: K3-fwd's "
                    f"y bit-identical over two calls: {same0}")
                if not same0:
                    raise AssertionError(f"bf16 K3-fwd reruns differ: T{t}")
                reruns1 = [call.bwd1(g, mean, rstd) for _ in range(2)]
                same1 = all(torch.equal(u, v) for u, v in zip(*reruns1))
                _, _, r1, r2 = reruns1[0]
                reruns = [call.bwd2(g, mean, rstd, r1 / (b * t), r2 / (b * t))
                          for _ in range(2)]
                same = all(torch.equal(u, v) for u, v in zip(*reruns))
                log(f"fused_conv T{t}_d{d}_bfloat16_same_drop0.1: K3b-1's "
                    f"dW2, db2, r1, r2 bit-identical over two calls: {same1}; "
                    f"K3b-2's dx and the gradients of "
                    f"{', '.join(BWD2_LEAVES[1:])} bit-identical over two "
                    f"calls: {same}")
                if not (same1 and same):
                    raise AssertionError(f"bf16 K3b reruns differ: T{t}")
            del x, g, params
    detail["conv_kernel_errors"] = errs

    # ---- 13. the path through every training kernel at full width
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, use_flash=False, stem_mode="pallas",
                      fused_att=True, fused_conv=True, fused_ffn=True,
                      loss=CTCLoss(zero_infinity=True))
    model = trainer.model
    per_step = model.kernel_launches_per_step()
    log(f"train (fused conv, fused attention, stem pallas, no flash): "
        f"launches per step derived from the module tree: {per_step}")
    # BatchNorm kernels: the trunk's 19, the audio stem's and the 3 strided
    # conv modules' BatchNorms, the stem's statistics and BN backward
    want_steps = {"fused_att_fwd": 19, "fused_att_bwd": 19,
                  "fused_ffn_fwd": 48, "fused_ffn_bwd": 48, "bn_relu_pool": 1,
                  **{name: 21 for name in cm.KERNELS}, **bn_launches(23, 1)}
    if per_step != want_steps:
        raise AssertionError(f"launches per step {per_step} != {want_steps}")
    history, launches = counted_train_steps(trainer, batch, per_step)
    fp32 = compare_fp32_step(model, batch, loss_tol=1e-5)
    train = {"steps": history, "launches_per_step": per_step, **fp32}

    # ---- 14. times: the four passes, then this path beside phase 10's
    acc = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bytes": 0, "ops": 0.0}
           for name in cm.KERNELS}
    shapes = conv_call_shapes(trainer, batch)
    for (b, t, d, e, k), count in sorted(shapes.items()):
        x, g, params = conv_inputs(b, t, d, k, torch.bfloat16, seed=t + 2)
        pad_lo = cm.pad_lo_for("same", k)
        times = time_conv_passes(x, g, params, 0.1, 77)
        s1, s2 = cm.conv_stats_reference(x, params, pad_lo)
        mean, _, rstd = cm.batch_stats(s1, s2, b * t, 1e-5)
        _, _, r1, r2 = cm.conv_bwd1_reference(x, g, params, mean, rstd, 77,
                                              pad_lo, drop_rate=0.1)
        rn1, rn2 = r1 / (b * t), r2 / (b * t)
        plain = {
            cm.KERNEL_STATS: lambda: cm.conv_stats_reference(x, params,
                                                             pad_lo),
            cm.KERNEL_FWD: lambda: cm.conv_fwd_reference(
                x, params, mean, rstd, 77, pad_lo, drop_rate=0.1),
            cm.KERNEL_BWD1: lambda: cm.conv_bwd1_reference(
                x, g, params, mean, rstd, 77, pad_lo, drop_rate=0.1),
            cm.KERNEL_BWD2: lambda: cm.conv_bwd2_reference(
                x, g, params, mean, rstd, rn1, rn2, 77, pad_lo,
                drop_rate=0.1)}
        plain_ms = {name: cuda_time_ms(fn, iters=5) for name, fn in
                    plain.items()}
        # the library yardstick: the port's own unfused module on the same
        # input (LN, F.conv1d, GLU, depthwise F.conv1d, BatchNorm, swish,
        # F.conv1d, dropout through PyTorch's library calls)
        unfused = init_params(ConvolutionModule(d, e, 1, k, "same", 0.1,
                                                fused_conv=False),
                              torch.Generator().manual_seed(3)).to(dev).train()

        def lib(backward: bool):
            if backward:
                unfused(x.detach().requires_grad_(True)).backward(g)
            else:
                with torch.no_grad():
                    unfused(x)

        t_fl = cuda_time_ms(lambda: lib(False))
        t_bl = cuda_time_ms(lambda: lib(True)) - t_fl
        lib_ms = {cm.KERNEL_FWD: t_fl, cm.KERNEL_BWD2: t_bl}
        cost = conv_cost(b, t, d, e, e, k, 2)
        row = {"count": count}
        for name in cm.KERNELS:
            nb, no = cost[name]
            b_ms = bound(nb, no, "bf16")[0]
            row[name] = {"ms": times[name],
                         "device_ms": times[name + "_device"],
                         "host_ms": times[name + "_host"],
                         "kernels_ms": times[name + "_kernels"],
                         "plain_ms": plain_ms[name], "bound_ms": b_ms,
                         "bytes": nb, "ops": no}
            acc[name]["ms"] += count * times[name]
            acc[name]["device_ms"] += count * times[name + "_device"]
            acc[name]["plain_ms"] += count * plain_ms[name]
            acc[name]["library_ms"] += count * lib_ms.get(name, 0.0)
            acc[name]["bytes"] += count * nb
            acc[name]["ops"] += count * no
        row["unfused_fwd_ms"], row["unfused_bwd_ms"] = t_fl, t_bl
        detail[f"conv_T{t}_d{d}"] = row
        bwd1_kernels = times[cm.KERNEL_BWD1 + "_kernels"]
        fma = [nm for nm in bwd1_kernels
               if nm.split("<")[0] in ("conv_grad_w2_kernel",
                                       "conv_grad_bn_kernel")]
        if fma or not {"conv_grad_bn_wgmma_kernel<2>",
                       "wgmma_products_kernel<1, 1, 1>"} <= set(bwd1_kernels):
            raise AssertionError(f"bf16 K3b-1 at T={t} did not run its "
                                 f"tensor-core stages: {sorted(bwd1_kernels)}")
        if "conv_reduce_kernel" not in times[cm.KERNEL_STATS + "_kernels"]:
            raise AssertionError(f"K3-stats at T={t} did not sum its partials "
                                 f"in the reduce stage: "
                                 f"{sorted(times[cm.KERNEL_STATS + '_kernels'])}")
        fwd_kernels = times[cm.KERNEL_FWD + "_kernels"]
        if (any(nm.split("<")[0] == "conv_pw2_kernel" for nm in fwd_kernels)
                or "conv_pw2_wgmma_kernel" not in fwd_kernels):
            raise AssertionError(f"bf16 K3-fwd at T={t} did not run its "
                                 f"tensor-core pw2: {sorted(fwd_kernels)}")
        for name in cm.KERNELS:
            log(f"{name} T={t} d={d} device time of each stage in one "
                f"launch (torch.profiler): "
                + ", ".join(f"{nm} {ms:.4f} ms" for nm, ms in
                            times[name + "_kernels"].items())
                + f"; whole pass {times[name + '_device']:.4f} ms on "
                f"the device, {times[name]:.4f} ms per direct launch, "
                f"{times[name + '_host']:.4f} ms of host time to issue it")
        log(f"fused_conv T={t} d={d} k={k} x{count}: "
            + "; ".join(f"{name[11:]} {times[name]:.4f} ms (device "
                        f"{times[name + '_device']:.4f}, host issue "
                        f"{times[name + '_host']:.4f}, plain "
                        f"{plain_ms[name]:.4f}, bound "
                        f"{row[name]['bound_ms']:.5f}, bytes {cost[name][0]}, "
                        f"operations {cost[name][1]:.4g})"
                        for name in cm.KERNELS)
            + f"; unfused module fwd {t_fl:.4f} ms, bwd {t_bl:.4f} ms")
        del x, g, params, unfused

    def step_ms(tr):
        tr.model.set_kernels(True)
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: tr.train_step(batch), iters=3, warmup=0)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    runs = [(name, *step_ms(tr)) for name, tr in (
        ("fused_att", trainer_att), ("fused_conv", trainer),
        ("fused_conv", trainer), ("fused_att", trainer_att))]
    for name in ("fused_conv", "fused_att"):
        ms = [r[1] for r in runs if r[0] == name]
        train[f"step_ms_{name}_path_bf16"] = sum(ms) / len(ms)
        train[f"utterances_per_s_{name}_path"] = 16 / (sum(ms) / len(ms)) * 1e3
        train[f"peak_gib_{name}_path"] = max(r[2] for r in runs
                                             if r[0] == name)
    train["step_ms_runs_in_order"] = [[r[0], r[1]] for r in runs]
    log("train (fused conv path beside the fused attention path) "
        + json.dumps({k: v for k, v in train.items() if k != "steps"}))
    if profile:
        detail["profile_train_fused_conv"] = profile_train_step(trainer, batch)
    detail["training_fused_conv"] = train

    replaces = dict(zip(cm.KERNELS, (
        "avec_tpu/ops/pallas_conv_module.py:342",
        "avec_tpu/ops/pallas_conv_module.py:358",
        "avec_tpu/ops/pallas_conv_module.py:393",
        "avec_tpu/ops/pallas_conv_module.py:421")))
    entries = []
    for name in cm.KERNELS:
        b_ms, b_by = bound(acc[name]["bytes"], acc[name]["ops"], "bf16")
        log(f"{name} per step: {acc[name]['ms']:.4f} ms (device "
            f"{acc[name]['device_ms']:.4f}), bound {b_ms:.5f} ({b_by}), "
            f"plain {acc[name]['plain_ms']:.4f}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "avec_tpu_torch/csrc/conv_module.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": abs_errs[name], "ms": acc[name]["ms"],
            "device_ms": acc[name]["device_ms"],
            "plain_ms": acc[name]["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by,
            # the unfused module's forward stands beside the forward pair,
            # its backward beside the backward pair
            "library_ms": (acc[name]["library_ms"] if name in (
                cm.KERNEL_FWD, cm.KERNEL_BWD2) else None)})
    return entries, shapes


DP_RANKS = 2                       # gloo ranks sharing the one card
DP_ROUTE = dict(use_flash=False, stem_mode="2d", fused_att=True,
                fused_conv=True, fused_ffn=True)
DP_WANT_STEPS = {"fused_att_fwd": 19, "fused_att_bwd": 19,
                 "fused_ffn_fwd": 48, "fused_ffn_bwd": 48,
                 "fused_conv_dp_stats": 21, "fused_conv_dp_fwd": 21,
                 "fused_conv_dp_bwd1": 21, "fused_conv_dp_bwd2": 21}


def _dp_rank_setup():
    """(rank, world) of a spawned rank, with the fp32 products of the checks
    in full fp32."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dist.get_rank(), dist.get_world_size()


def k3dp_rank(device, lib_shapes):
    """Phase 15 on one of the gloo ranks sharing the card: each rank takes its
    half of phase 12's (16, T, d) inputs and runs K3dp (the four passes with
    the statistics all-reduced between them) against the plain DP stages on
    the card, with the masks of its own seed identical at dropout 0.1; keeps
    the dropout-0 results for the parent's single-process comparison. Then
    the library yardstick at the step's B=8 shapes: the port's unfused
    module with its BatchNorm synced over the ranks, and the all-reduce of
    one (2E,) vector over gloo; both ranks run them in step, rank 0's times
    are kept."""
    import torch.distributed as dist

    from avec_tpu_torch.models.conformer import ConvolutionModule
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.ops.ffn import dropout_mask, shard_seed
    from avec_tpu_torch.ops.layers import init_params

    rank, world = _dp_rank_setup()
    say = log if rank == 0 else (lambda *args: None)
    dev = torch.device("cuda")
    names = ("x",) + cm.PARAM_NAMES
    stats, fwd, bwd1, bwd2 = cm.KERNELS_DP
    owner = {"mean": stats, "var": stats, "y": fwd, "pw2_w": bwd1,
             "pw2_b": bwd1, "bn_w": bwd1, "bn_b": bwd1}
    errs, abs_errs, kept = {}, {n: 0.0 for n in cm.KERNELS_DP}, {}
    for b, t, d, k in CONV_SHAPES:
        for dtype, tol, wtol in ((torch.float32, 1e-4, 5e-4),
                                 (torch.bfloat16, 2e-2, 3e-2)):
            x, g, params = conv_inputs(b, t, d, k, dtype, seed=d)
            half = b // world
            x, g = (a[rank * half:(rank + 1) * half].contiguous()
                    for a in (x, g))
            for padding, drop in (("same", 0.0), ("same", 0.1),
                                  ("causal", 0.0), ("causal", 0.1)):
                outs, grads = conv_run(x, g, params, padding, drop, True,
                                       dp=True)
                torch.cuda.synchronize()
                want_outs, want = conv_run(x, g, params, padding, drop, False,
                                           dp=True)
                key = f"T{t}_d{d}_{str(dtype)[6:]}_{padding}_drop{drop}"
                e = {nm: rel_err(a, w) for nm, a, w in zip(
                    ("y", "mean", "var"), outs, want_outs)}
                e.update({nm: rel_err(a, w) for nm, a, w in zip(names, grads,
                                                                want)
                          if nm != "dw_b"})
                errs[key] = e
                if dtype == torch.float32:
                    pairs = list(zip(("y", "mean", "var"), outs, want_outs))
                    for nm, a, w in pairs + list(zip(names, grads, want)):
                        kern = owner.get(nm, bwd2)
                        abs_errs[kern] = max(abs_errs[kern], max_abs(a, w))
                if drop:
                    dropped = dropout_mask(
                        shard_seed(4321, rank), half * t, d, 1, 1.0 - drop,
                        dev, tile_rows=t).reshape(half, t, d) == 0
                    for y in (outs[0], want_outs[0]):
                        kept_zero = float((y[~dropped] == 0).float().mean())
                        if not (bool((y[dropped] == 0).all())
                                and kept_zero < 5e-3):
                            raise AssertionError(
                                f"rank {rank} dropout masks differ: {key}")
                worst_w = max(v for nm, v in e.items()
                              if nm in cm.PARAM_NAMES)
                x_tol = wtol if dtype == torch.float32 else tol
                say(f"K3dp rank {rank} vs plain DP stages {key}: y "
                    f"{e['y']:.2e} mean {e['mean']:.2e} var {e['var']:.2e} "
                    f"(tol {tol}) dx {e['x']:.2e} (tol {x_tol}) params "
                    f"{worst_w:.2e} (tol {wtol})")
                if not (max(e["y"], e["mean"], e["var"]) <= tol
                        and e["x"] <= x_tol and worst_w <= wtol
                        and not grads[names.index("dw_b")].abs().any()):
                    raise AssertionError(f"rank {rank}: K3dp disagrees with "
                                         f"the plain DP stages: {key} {e}")
                if drop == 0.0:
                    kept[(b, t, d, k, str(dtype)[6:], padding)] = (
                        [a.float().cpu() for a in outs],
                        [a.float().cpu() for a in grads])
            del x, g, params
    lib = {}
    for t, d, e, k, count in lib_shapes:
        x, g, _ = conv_inputs(8, t, d, k, torch.bfloat16, seed=t + 2)
        unfused = init_params(ConvolutionModule(d, e, 1, k, "same", 0.1,
                                                fused_conv=False),
                              torch.Generator().manual_seed(3)).to(dev).train()
        unfused.layers["4"].process_group = dist.group.WORLD

        def run(backward: bool):
            if backward:
                unfused(x.detach().requires_grad_(True)).backward(g)
            else:
                with torch.no_grad():
                    unfused(x)

        v = torch.zeros(2 * e, device=dev)
        t_f = cuda_time_ms(lambda: run(False))
        t_b = cuda_time_ms(lambda: run(True)) - t_f
        t_ar = cuda_time_ms(lambda: dist.all_reduce(v))
        lib[(t, d)] = {"count": count, "fwd_ms": t_f, "bwd_ms": t_b,
                       "all_reduce_ms": t_ar}
        del x, g, unfused
    return {"rank": rank, "errs": errs, "abs_errs": abs_errs, "kept": kept,
            "lib": lib}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in tensors:
        h.update(a.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train_rank(device):
    """Phase 16 on one of the gloo ranks sharing the card: the
    data-parallel trainer at full width on its 8 of the 16 utterances, 1
    warm-up + 3 counted steps, a digest of the parameters, the step time and
    the peak memory of this rank; then one fp32 step with dropout and
    SpecAugment off (rank 0 keeps the global gradients and BN statistics)."""
    import torch.distributed as dist

    from avec_tpu_torch.parallel.dist import shard_batch
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    rank, world = _dp_rank_setup()
    batch = shard_batch(make_train_batch(np.random.RandomState(0)))
    trainer = Trainer(device="cuda", precision="bfloat16", seed=0,
                      vocab_size=256, loss=CTCLoss(zero_infinity=True),
                      data_parallel=True, **DP_ROUTE)
    per_step = trainer.model.kernel_launches_per_step()
    if per_step != DP_WANT_STEPS:
        raise AssertionError(f"launches per step {per_step} != "
                             f"{DP_WANT_STEPS}")
    history, launches = counted_train_steps(trainer, batch, per_step,
                                            verbose=rank == 0)
    digest = _digest(trainer.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: trainer.train_step(batch), iters=3, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the step's one flat all-reduce of the gradients and losses, alone
    flat = torch.zeros(sum(p.numel() for p in trainer.model.parameters())
                       + 7, device=device)
    grad_ar_ms = cuda_time_ms(lambda: dist.all_reduce(flat), iters=3,
                              warmup=1)
    del trainer, flat
    torch.cuda.empty_cache()
    trainer = Trainer(device="cuda", precision="float32", seed=0,
                      vocab_size=256, loss=CTCLoss(zero_infinity=True),
                      data_parallel=True, **DP_ROUTE)
    trainer.model.set_regularization(False)
    losses, grads = trainer.loss_and_grads(batch)
    fp32 = {"loss": float(losses["loss"]), "grads_digest": _digest(
        grads.values())}
    if rank == 0:
        fp32["grads"] = {n: a.cpu() for n, a in grads.items()}
        fp32["stats"] = {n: b.detach().cpu() for n, b in
                         trainer.model.named_buffers() if "running_" in n}
    return {"rank": rank, "world": world, "history": history,
            "launches": launches, "params_digest": digest, "step_ms": ms,
            "grad_all_reduce_ms": grad_ar_ms, "peak_gib": peak, "fp32": fp32}


def _step_diffs(a, b):
    """Differences of two fp32 steps, each (losses, gradients by name): the
    largest relative loss difference, the worst leaf (max abs difference
    over the leaf's largest entry; leaves below 1e-6 of the largest gradient
    entry left out), the largest difference over the largest gradient entry,
    and the gradient norm's relative difference."""
    (la, ga), (lb, gb) = a, b
    gmax = max(float(g.abs().max()) for g in gb.values())
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum()
                                           for g in gs.values())))
    worst = max((max_abs(ga[n], g) / float(g.abs().max()), n)
                for n, g in gb.items() if float(g.abs().max()) > 1e-6 * gmax)
    return {"loss_rel": max(abs(la[k] - v) / abs(v) for k, v in lb.items()),
            "worst_leaf_rel": worst[0], "worst_leaf": worst[1],
            "grads_rel_to_largest": max(max_abs(ga[n], g)
                                        for n, g in gb.items()) / gmax,
            "grad_norm_rel": abs(norm(ga) - norm(gb)) / norm(gb),
            "keys_equal": set(la) == set(lb) and set(ga) == set(gb)}


def nccl_world1_rank(device):
    """Phase 17 on one NCCL rank: fp32, dropout and SpecAugment off, the
    same 16 utterances; the data-parallel trainer against the plain trainer
    and the plain trainer against itself (the run-to-run floor), first
    through the kernels' plain versions with cuDNN deterministic, then
    through the kernels (whose atomic sums vary from run to run)."""
    import torch.distributed as dist

    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    _dp_rank_setup()
    batch = make_train_batch(np.random.RandomState(0))
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    for route, kernels in (("plain_versions", False), ("kernels", True)):
        torch.backends.cudnn.deterministic = not kernels
        runs = []
        for dp in (True, False, False):
            trainer = Trainer(device="cuda", precision="float32", seed=0,
                              vocab_size=256, loss=CTCLoss(zero_infinity=True),
                              data_parallel=dp, **DP_ROUTE)
            trainer.model.set_regularization(False)
            trainer.model.set_kernels(kernels)
            losses, grads = trainer.loss_and_grads(batch)
            runs.append(({k: float(v) for k, v in losses.items()}, grads))
            del trainer
            torch.cuda.empty_cache()
        out[route] = {"dp_vs_plain": _step_diffs(runs[0], runs[1]),
                      "plain_vs_plain": _step_diffs(runs[2], runs[1])}
        del runs
    torch.backends.cudnn.deterministic = False
    return out


def dp_phases(detail, conv_shapes):
    """Phases 15-17: K3dp on two gloo ranks against the single-process
    K3/K3b call and the plain DP stages, the data-parallel train path at full
    width on two gloo ranks, and the NCCL path at world size 1. Returns the
    four K3dp entries of the kernels line."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.parallel.dist import spawn
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    _cuda.build()                  # the ranks load what the parent built
    names = ("x",) + cm.PARAM_NAMES
    lib_shapes = sorted((t, d, e, k, count)
                        for (_, t, d, e, k), count in conv_shapes.items())

    # ---- 15. K3dp on two ranks
    ranks = spawn(k3dp_rank, DP_RANKS, "gloo", "cuda:0", lib_shapes,
                  timeout=600)
    dp_errs = {}
    for key in ranks[0]["kept"]:
        b, t, d, k, dname, padding = key
        dtype = getattr(torch, dname)
        tol, wtol = (1e-4, 5e-4) if dname == "float32" else (2e-2, 3e-2)
        x, g, params = conv_inputs(b, t, d, k, dtype, seed=d)
        want_outs, want = conv_run(x, g, params, padding, 0.0, True)
        kept = [r["kept"][key] for r in ranks]
        outs = [torch.cat([o[0][0] for o in kept])] + kept[0][0][1:]
        grads = [torch.cat([o[1][0] for o in kept])]
        grads += [sum(o[1][i] for o in kept) for i in range(1, len(names))]
        e = {nm: rel_err(a, w.cpu()) for nm, a, w in zip(
            ("y", "mean", "var"), outs, want_outs)}
        e.update({nm: rel_err(a, w.cpu()) for nm, a, w in zip(names, grads,
                                                              want)
                  if nm != "dw_b"})
        label = f"T{t}_d{d}_{dname}_{padding}"
        dp_errs[label] = e
        x_tol = wtol if dname == "float32" else tol
        worst_w = max(v for nm, v in e.items() if nm in cm.PARAM_NAMES)
        log(f"K3dp on {DP_RANKS} ranks vs one K3/K3b call {label}: y "
            f"{e['y']:.2e} mean {e['mean']:.2e} var {e['var']:.2e} (tol "
            f"{tol}) dx {e['x']:.2e} (tol {x_tol}) params {worst_w:.2e} "
            f"(tol {wtol})")
        if not (max(e["y"], e["mean"], e["var"]) <= tol and e["x"] <= x_tol
                and worst_w <= wtol):
            raise AssertionError(f"K3dp disagrees with one K3/K3b call: "
                                 f"{label} {e}")
        del x, g, params, want_outs, want
    abs_errs = {n: max(r["abs_errs"][n] for r in ranks)
                for n in cm.KERNELS_DP}
    detail["k3dp_vs_one_call"] = dp_errs
    detail["k3dp_vs_plain_dp"] = {r["rank"]: r["errs"] for r in ranks}
    lib = ranks[0]["lib"]
    del ranks
    torch.cuda.empty_cache()

    # ---- 16. the data-parallel train path at full width, two ranks
    batch = make_train_batch(np.random.RandomState(0))
    ref = Trainer(device="cuda", precision="float32", seed=0, vocab_size=256,
                  loss=CTCLoss(zero_infinity=True), **DP_ROUTE)
    ref.model.set_regularization(False)
    losses, grads = ref.loss_and_grads(batch)
    want = (float(losses["loss"]), {n: a.cpu() for n, a in grads.items()},
            {n: b.detach().cpu() for n, b in ref.model.named_buffers()
             if "running_" in n})
    # the fp32 noise floor of this gradient: the same step, the same
    # parameters, the 16 utterances in another order (equal in exact
    # arithmetic; sums are taken in another order, as across ranks)
    _, grads = ref.loss_and_grads(reorder(batch))
    floor = max((max_abs(a.cpu(), want[1][n])
                 / max(float(want[1][n].abs().max()), 1e-30), n)
                for n, a in grads.items() if FRONT_END in n)
    floor_rest = max((max_abs(a.cpu(), want[1][n])
                      / max(float(want[1][n].abs().max()), 1e-30), n)
                     for n, a in grads.items() if FRONT_END not in n
                     and float(want[1][n].abs().max()) > 1e-6 * max(
                         float(w.abs().max()) for w in want[1].values()))
    log(f"fp32 one process, the same utterances reordered: worst video "
        f"front-end leaf {floor[1]} {floor[0]:.2e}, worst other leaf "
        f"{floor_rest[1]} {floor_rest[0]:.2e} (the trunk's fp32 noise floor)")
    detail["fp32_reorder_floor"] = {"front_end": floor, "other": floor_rest}
    del ref, losses, grads
    torch.cuda.empty_cache()
    ranks = spawn(dp_train_rank, DP_RANKS, "gloo", "cuda:0", timeout=900)
    digests = {r["params_digest"] for r in ranks}
    log(f"data-parallel train path, {DP_RANKS} gloo ranks on one card: "
        f"launches per rank over {TRAIN_STEPS} steps "
        + json.dumps([r["launches"] for r in ranks])
        + f"; parameters after the steps bit-identical across ranks: "
        f"{len(digests) == 1}")
    if len(digests) != 1:
        raise AssertionError("ranks hold different parameters")
    if len({r["fp32"]["grads_digest"] for r in ranks}) != 1 or len(
            {r["fp32"]["loss"] for r in ranks}) != 1:
        raise AssertionError("ranks hold different global gradients")
    fp32 = ranks[0]["fp32"]
    agree = check_agreement(
        f"fp32 data-parallel step ({DP_RANKS} ranks) vs one process",
        (fp32["loss"], fp32["grads"], fp32["stats"]), want, loss_tol=1e-5,
        front_end_tol=0.15)
    step_ms = max(r["step_ms"] for r in ranks)
    train = {"ranks": DP_RANKS, "backend": "gloo", "shared_card": True,
             "global_batch": 16, "steps": ranks[0]["history"],
             "launches_per_rank": [r["launches"] for r in ranks],
             "step_ms_per_rank": [r["step_ms"] for r in ranks],
             "grad_all_reduce_ms_per_rank": [r["grad_all_reduce_ms"]
                                             for r in ranks],
             "global_utterances_per_s": 16 / step_ms * 1e3,
             "peak_gib_per_rank": [r["peak_gib"] for r in ranks], **agree}
    log("train, data-parallel (two ranks time-sliced on one card over gloo; "
        "not a data-parallel speed) " + json.dumps(
            {k: v for k, v in train.items() if k != "steps"}))
    detail["training_dp"] = train
    launches = ranks[0]["launches"]
    del ranks, fp32, want
    torch.cuda.empty_cache()

    # ---- 17. NCCL at world size 1
    nccl, = spawn(nccl_world1_rank, 1, "nccl", "cuda:0", timeout=600)
    for route in ("plain_versions", "kernels"):
        log(f"NCCL world size 1, {route}, fp32, dropout off: data-parallel "
            f"vs plain trainer " + json.dumps(nccl[route]["dp_vs_plain"])
            + "; plain vs plain (run-to-run floor) "
            + json.dumps(nccl[route]["plain_vs_plain"]))
    det, ker = nccl["plain_versions"]["dp_vs_plain"], nccl["kernels"]
    if not (nccl["backend"] == "nccl" and det["keys_equal"]
            and det["loss_rel"] <= 1e-6 and det["worst_leaf_rel"] <= 1e-6
            and ker["dp_vs_plain"]["keys_equal"]
            and ker["dp_vs_plain"]["loss_rel"] <= 1e-6):
        raise AssertionError(f"NCCL data-parallel step disagrees: {nccl}")
    detail["nccl_world1"] = nccl

    # ---- K3dp times per rank at the B=8 shapes (this process, alone on
    # the card), bounds, plain stages, the library yardstick of phase 15
    acc = {n: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bytes": 0, "ops": 0.0}
           for n in cm.KERNELS_DP}
    for t, d, e, k, count in lib_shapes:
        x, g, params = conv_inputs(8, t, d, k, torch.bfloat16, seed=t + 2)
        pad_lo = cm.pad_lo_for("same", k)
        times = time_conv_passes(x, g, params, 0.1, 77)
        s1, s2 = cm.conv_stats_reference(x, params, pad_lo)
        mean, _, rstd = cm.batch_stats(s1, s2, 8 * t, 1e-5)
        _, _, r1, r2 = cm.conv_bwd1_reference(x, g, params, mean, rstd, 77,
                                              pad_lo, drop_rate=0.1)
        rn1, rn2 = r1 / (8 * t), r2 / (8 * t)
        plain = (lambda: cm.conv_stats_reference(x, params, pad_lo),
                 lambda: cm.conv_fwd_reference(x, params, mean, rstd, 77,
                                               pad_lo, drop_rate=0.1),
                 lambda: cm.conv_bwd1_reference(x, g, params, mean, rstd, 77,
                                                pad_lo, drop_rate=0.1),
                 lambda: cm.conv_bwd2_reference(x, g, params, mean, rstd,
                                                rn1, rn2, 77, pad_lo,
                                                drop_rate=0.1))
        cost = conv_cost(8, t, d, e, e, k, 2)
        row = lib[(t, d)]
        lib_ms = {cm.KERNELS_DP[1]: row["fwd_ms"],
                  cm.KERNELS_DP[3]: row["bwd_ms"]}
        for name, dp_name, fn in zip(cm.KERNELS, cm.KERNELS_DP, plain):
            nb, no = cost[name]
            acc[dp_name]["ms"] += count * times[name]
            acc[dp_name]["device_ms"] += count * times[name + "_device"]
            acc[dp_name]["plain_ms"] += count * cuda_time_ms(fn, iters=5)
            acc[dp_name]["library_ms"] += count * lib_ms.get(dp_name, 0.0)
            acc[dp_name]["bytes"] += count * nb
            acc[dp_name]["ops"] += count * no
        row.update({n: times[n] for n in cm.KERNELS})
        row.update({n + "_device": times[n + "_device"] for n in cm.KERNELS})
        log(f"K3dp per rank at B=8 T={t} d={d} x{count}: "
            + "; ".join(f"{n[11:]} {times[n]:.4f} ms (device "
                        f"{times[n + '_device']:.4f}, bound "
                        f"{bound(*cost[n], 'bf16')[0]:.5f})"
                        for n in cm.KERNELS)
            + f"; unfused module under sync-BN (two ranks time-sliced) fwd "
            f"{row['fwd_ms']:.4f} ms, bwd {row['bwd_ms']:.4f} ms; all-reduce "
            f"of the (2E,) statistics over gloo {row['all_reduce_ms']:.4f} ms")
        del x, g, params
    detail["k3dp_b8"] = {f"T{t}_d{d}": row for (t, d), row in lib.items()}
    replaces = dict(zip(cm.KERNELS_DP, (
        "avec_tpu/ops/pallas_conv_module.py:582",
        "avec_tpu/ops/pallas_conv_module.py:612",
        "avec_tpu/ops/pallas_conv_module.py:648",
        "avec_tpu/ops/pallas_conv_module.py:679")))
    entries = []
    for name in cm.KERNELS_DP:
        b_ms, b_by = bound(acc[name]["bytes"], acc[name]["ops"], "bf16")
        log(f"{name} per rank per step (B=8): {acc[name]['ms']:.4f} ms "
            f"(device {acc[name]['device_ms']:.4f}), bound {b_ms:.5f} "
            f"({b_by}), plain {acc[name]['plain_ms']:.4f}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "avec_tpu_torch/csrc/conv_module.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": abs_errs[name], "ms": acc[name]["ms"],
            "device_ms": acc[name]["device_ms"],
            "plain_ms": acc[name]["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": (acc[name]["library_ms"] if name in (
                cm.KERNELS_DP[1], cm.KERNELS_DP[3]) else None)})
    return entries


class _ZeroVideo:
    """The batches of a loader with the video zeroed (its lengths kept):
    the audio-alone control of the AV-Tone run."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for batch in self.loader:
            video, *rest = batch["inputs"]
            yield {"inputs": [np.zeros_like(video), *rest],
                   "targets": batch["targets"]}


# Phase 18's ceilings on the WER after the last epoch, of the config's
# decoder and of the greedy decoder on the same logits alike: the plain
# model and SWA, and the EMA (tau 0.99, whose average still holds the
# earlier steps). Three runs of the phase on the H100 read a greedy 0.00
# for all three (PERF.md, PR 12); the prediction made before them was
# under 20 after epoch 2. A route that learns a little (a WER of 30-80) fails here.
WER_CEILING = 10.0
EMA_WER_CEILING = 20.0


class GreedyBeside:
    """An evaluation decoder that decodes with `decoder` and keeps the
    greedy transcripts of the same logits and the targets. `evaluate`
    wraps a Trainer's evaluate so that each call appends (use_ema, the
    decoder's WER, the greedy WER) to `readings`; `by_key` lays them
    beside a dict of the decoder's WERs recorded in the same order."""

    def __init__(self, decoder, tokenizer_path):
        from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder

        self.decoder = decoder
        self.greedy = CTCGreedySearchDecoder(tokenizer_path=tokenizer_path)
        self.truths, self.preds, self.readings = [], [], []

    def device_fn(self, outputs):
        return self.decoder.device_fn(outputs)

    def __call__(self, outputs, from_logits: bool = True):
        if not from_logits:
            truths = self.decoder(outputs, from_logits=False)
            self.truths.extend(truths)
            return truths
        self.preds.extend(self.greedy(self.greedy.device_fn(outputs)))
        return self.decoder(outputs)

    def evaluate(self, evaluate):
        from avec_tpu_torch.train.metrics import WordErrorRate

        def evaluate_beside(*args, use_ema=False, **kwargs):
            out = evaluate(*args, use_ema=use_ema, **kwargs)
            greedy = float(WordErrorRate()(self.truths, self.preds))
            self.truths, self.preds = [], []
            self.readings.append((use_ema, out[1]["wer"], greedy))
            return out
        return evaluate_beside

    def by_key(self, wers: dict) -> dict:
        """The greedy WER under each key of `wers`; each reading must carry
        that key's WER and its EMA flag (keys ending in "_ema")."""
        if len(self.readings) != len(wers):
            raise AssertionError(f"{len(self.readings)} greedy readings for "
                                 f"{len(wers)} WERs {list(wers)}")
        out = {}
        for (key, w), (ema, beam, greedy) in zip(wers.items(),
                                                 self.readings):
            if ema != key.endswith("_ema") or beam != w:
                raise AssertionError(f"greedy reading (ema {ema}, WER "
                                     f"{beam}) does not belong to {key} {w}")
            out[key] = greedy
        return out


def learning_phase(detail, root, profile: bool, lm_dir: str) -> dict:
    """Phase 18: the AV-Tone learning run (`avec_tpu_torch/configs/
    av_tone.py`) on the fused-conv route through the training engine. The
    WER of the 64 evaluation utterances at init; `fit` for the
    config's 2 epochs of 400 steps (B = 16) with an EMA of tau 0.99, a
    checkpoint and an evaluation (plain and EMA) per epoch; the launches of
    the fit's steps against the module tree's count per step; the last
    checkpoint reloaded into a fresh setup (bf16 logits bit-identical); the
    audio-alone control (video zeroed, printed only); SWA over both epochs
    and its WER. Every evaluation decodes with the config's decoder (beam
    8, the 2-gram, GPT rescoring by phase 24's LM-Tone checkpoint in
    `lm_dir`), and the greedy WER of the same logits is kept beside each
    (`GreedyBeside`). For both decoders, every WER after training must be
    below the WER at init, and after the last epoch at most WER_CEILING
    (plain, SWA) and EMA_WER_CEILING (EMA). With `profile`, one more train step is traced (device time by category,
    idle share). Returns the kernel launches of the fit's 800 steps."""
    import shutil
    import tempfile

    from avec_tpu_torch.configs import av_tone
    from avec_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="av_tone_", dir=build_dir)
    route = dict(fused_ffn=True, fused_att=True, fused_conv=True,
                 stem_mode="pallas")
    try:
        setup = av_tone.build(ckpt_dir, device="cuda", route=route,
                              lm_callback_path=lm_dir)
        trainer = setup.trainer
        decoder = trainer.decoders["outputs"]
        if decoder.neural_rescorer is None or decoder.beam_size != 8:
            raise AssertionError("AV-Tone decoder without the LM-Tone "
                                 "rescorer")
        beside = GreedyBeside(decoder, setup.tokenizer_path)
        trainer.decoders = {"outputs": beside}
        trainer.evaluate = beside.evaluate(trainer.evaluate)
        per_step = setup.model.kernel_launches_per_step()
        want = {"fused_ffn_fwd", "fused_ffn_bwd", "fused_att_fwd",
                "fused_att_bwd", "fused_conv_stats", "fused_conv_fwd",
                "fused_conv_bwd1", "fused_conv_bwd2", "bn_relu_pool",
                *BN_KERNELS}
        if set(per_step) != want:
            raise AssertionError(f"AV-Tone route kernels {per_step}")
        n_params = sum(p.numel() for p in setup.model.parameters())
        log(f"AV-Tone: {n_params / 1e6:.2f}M params, {len(setup.train_set)} "
            f"training and {len(setup.eval_set)} evaluation utterances, "
            f"B={setup.train_loader.batch_size}, {setup.epochs} epochs of "
            f"{len(setup.train_loader)} steps; launches per step {per_step}")

        def wer(ds, use_ema=False):
            return trainer.evaluate(ds, recompute_metrics=True,
                                    use_ema=use_ema)[1]["wer"]

        wers = {"init": wer(setup.eval_loader)}
        log(f"AV-Tone beam WER at init: {wers['init']:.2f} (greedy "
            f"{beside.readings[0][2]:.2f})")
        trainer.set_ema(0.99)

        step_ms, train_launches = [], {}
        fit_step = trainer.train_step

        def timed_step(batch, accumulated_steps=1):
            torch.cuda.synchronize()
            before = dict(_cuda.launches)
            t0 = time.perf_counter()
            out = fit_step(batch, accumulated_steps)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in _cuda.launches.items():
                train_launches[k] = train_launches.get(k, 0) + v - \
                    before.get(k, 0)
            return out

        trainer.train_step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t_fit = time.perf_counter()
        history = trainer.fit(setup.train_loader, setup.epochs,
                              dataset_eval=setup.eval_loader,
                              callback_path=ckpt_dir,
                              recompute_metrics=setup.recompute_metrics,
                              step_log_period=200)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        launches = dict(_cuda.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer.train_step
        n_steps = len(step_ms)
        log(f"main path launches over the fit's {n_steps} train steps: "
            f"{train_launches}; over the fit (its evaluations included): "
            f"{launches}")
        if train_launches != {k: v * n_steps for k, v in per_step.items()}:
            raise AssertionError(f"launches {train_launches} != {n_steps} x "
                                 f"{per_step}")
        losses = [h["losses"] for h in history]
        if n_steps != setup.epochs * len(setup.train_loader) or not all(
                math.isfinite(v) for row in losses for v in row.values()):
            raise AssertionError(f"{n_steps} steps, epoch losses {losses}")
        for h in history:
            wers[f"epoch_{h['epoch']}"] = h["eval"][0][1]["wer"]
            wers[f"epoch_{h['epoch']}_ema"] = h["eval_ema"][0][1]["wer"]

        # the last checkpoint in a fresh setup: the same bf16 logits
        last = os.path.join(ckpt_dir, f"checkpoints_epoch_{setup.epochs}_"
                                      f"step_{trainer.step}.ckpt")
        fresh = av_tone.build(os.path.join(ckpt_dir, "fresh"),
                              device="cuda", route=route,
                              lm_callback_path=lm_dir)
        fresh.trainer.load(last)
        batch = next(iter(setup.eval_loader))
        logits = []
        for tr in (trainer, fresh.trainer):
            tr.model.eval()
            with torch.no_grad():
                inputs, _ = tr._to_device(batch)
                logits.append(tr.model(*inputs)["outputs"][0])
            tr.model.train()
        reload_equal = bool(torch.equal(*logits))
        log(f"checkpoint {os.path.basename(last)} reloaded into a fresh "
            f"setup: bf16 logits {tuple(logits[0].shape)} bit-identical: "
            f"{reload_equal}")
        if not reload_equal:
            raise AssertionError("reloaded checkpoint gives other logits")
        del fresh, logits

        wers["audio_alone"] = wer(_ZeroVideo(setup.eval_loader))
        t_swa = time.perf_counter()
        trainer.swa(setup.train_loader, ckpt_dir,
                    epochs_list=list(range(1, setup.epochs + 1)))
        swa_s = time.perf_counter() - t_swa
        wers["swa"] = wer(setup.eval_loader)
        greedy = beside.by_key(wers)
        wall_s = time.perf_counter() - t_phase
        warm = min(20, n_steps // 2)         # warm-up steps left out
        counted = sorted(step_ms[warm:])
        median = counted[len(counted) // 2]
        run = {"wer": wers, "greedy_wer": greedy, "epoch_losses": losses,
               "steps": n_steps, "batch": setup.train_loader.batch_size,
               "step_ms_median": median,
               "step_ms_p10_p90": [counted[len(counted) // 10],
                                   counted[9 * len(counted) // 10]],
               "utterances_per_s": setup.train_loader.batch_size * 1e3
               / median,
               "fit_s": fit_s, "epoch_s": [h["seconds"] for h in history],
               "swa_s": swa_s, "peak_gib": peak_gib, "wall_s": wall_s,
               "params_m": n_params / 1e6, "launches_per_step": per_step,
               "launches_train_steps": train_launches,
               "launches_fit": launches, "reload_bit_identical":
               reload_equal}
        log("AV-Tone WER (beam 8, 2-gram, GPT rescoring): " + ", ".join(
            f"{k} {v:.2f}" for k, v in wers.items())
            + " (audio_alone: the video zeroed, a control, not asserted)")
        log("AV-Tone greedy WER of the same logits: " + ", ".join(
            f"{k} {v:.2f}" for k, v in greedy.items()))
        log(f"AV-Tone train step: median {median:.3f} ms over steps "
            f"{warm + 1}-{n_steps} (p10 {run['step_ms_p10_p90'][0]:.3f}, p90 "
            f"{run['step_ms_p10_p90'][1]:.3f}; synchronized around each "
            f"step), {run['utterances_per_s']:.2f} utterances/s, peak "
            f"{peak_gib:.2f} GiB; fit {fit_s:.1f} s (evaluations and "
            "checkpoints included; its epochs' training loops "
            + ", ".join(f"{x:.1f}" for x in run["epoch_s"])
            + f" s), SWA {swa_s:.1f} s, phase wall {wall_s:.1f} s")
        if profile:     # one more step of the SWA model, traced
            run["profile"] = profile_train_step(trainer, batch)
        detail["learning_run"] = run
        trained = [k for k in wers if k not in ("init", "audio_alone")]
        final = f"epoch_{setup.epochs}"
        ceilings = {final: WER_CEILING, "swa": WER_CEILING,
                    final + "_ema": EMA_WER_CEILING}
        for what, w in (("beam", wers), ("greedy", greedy)):
            if not all(w[k] < w["init"] for k in trained):
                raise AssertionError(f"{what} WER did not fall below init: "
                                     f"{w}")
            over = {k: w[k] for k, c in ceilings.items() if w[k] > c}
            if over:
                raise AssertionError(f"{what} WER above its ceiling "
                                     f"{ceilings}: {over}")
        return train_launches
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def served_path(srv, reqs, want_launches, what):
    """A served path at full width: one warm-up batch, then ROUNDS batches
    of `reqs` with the launch counts set to 0 just before and read just
    after (they must equal `want_launches`); the bf16 logits finite; the
    same batch in fp32 through the kernels against their plain versions:
    logits within 2e-3 (phase 3's bound) and identical greedy ids.
    Returns the record of the path."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.serve import _batch_bucket, _bucket

    samples = [srv._request_samples(r) for r in reqs]
    inputs = srv._inputs_for_batch(reqs, _bucket(max(samples)),
                                   _batch_bucket(len(reqs)))
    srv.transcribe_batch(reqs)                       # warm-up (cuDNN plans)
    srv.latencies, srv.rtfs = [], []
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        results = srv.transcribe_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    log(f"{what}: main path launches over {ROUNDS} forwards: {launches}")
    if launches != {k: v * ROUNDS for k, v in want_launches.items()}:
        raise AssertionError(f"{what} launches {launches} != {ROUNDS} x "
                             f"{want_launches}")
    logits, lengths = srv.forward(inputs)
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{what}: bf16 logits not finite")
    srv.model.set_kernels(True)
    k_logits, k_len = srv.forward(inputs, torch.float32)
    srv.model.set_kernels(False)
    _cuda.reset_launches()
    p_logits, p_len = srv.forward(inputs, torch.float32)
    if dict(_cuda.launches):
        raise AssertionError(f"plain path launched {dict(_cuda.launches)}")
    srv.model.set_kernels(True)
    diff = max_abs(k_logits, p_logits)
    ids_k = srv.decoder(srv.decoder.device_fn((k_logits, k_len)))
    ids_p = srv.decoder(srv.decoder.device_fn((p_logits, p_len)))
    summary = srv.stats_summary()
    rec = {"launches": launches, "logits_shape": list(logits.shape),
           "fp32_kernel_vs_plain_logits_max_abs": diff,
           "greedy_ids_equal": ids_k == ids_p,
           "requests_per_s": len(reqs) * ROUNDS / wall,
           "latency_p50_s": summary["latency_p50_s"],
           "tokens": [r["tokens"] for r in results],
           "seconds": [n / 16000 for n in samples]}
    log(f"{what}: {len(reqs)} requests of {min(samples) / 16000:.2f}-"
        f"{max(samples) / 16000:.2f} s in the {_bucket(max(samples))}-sample "
        f"bucket; bf16 logits {tuple(logits.shape)}; fp32 kernels vs plain: "
        f"logits max abs {diff:.3e} (tol 2e-3), greedy ids equal: "
        f"{ids_k == ids_p}; {rec['requests_per_s']:.2f} requests/s")
    if not (diff <= 2e-3 and torch.equal(k_len, p_len) and ids_k == ids_p):
        raise AssertionError(f"{what}: kernel path disagrees with the plain "
                             "path")
    if all(len(t) == 0 for t in rec["tokens"]):
        raise AssertionError(f"{what}: every request decoded to no token")
    return rec


def trained_path(trainer, batch, want_per_step, what, n_values, loss=None,
                 front_end=FRONT_END):
    """A trained path at full width: the module tree's launches per step
    must equal `want_per_step`; `counted_train_steps` (1 warm-up + 3
    counted steps) and `compare_fp32_step` (fp32 kernels against plain
    versions: loss 1e-5, gradient norm 1e-3, every leaf 2e-3, BN statistics
    1e-5). Returns (record, launches of the counted steps)."""
    per_step = trainer.model.kernel_launches_per_step()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"{what}: {n_params / 1e6:.2f}M params; launches per step derived "
        f"from the module tree: {per_step}")
    if per_step != want_per_step:
        raise AssertionError(f"{what}: launches per step {per_step} != "
                             f"{want_per_step}")
    history, launches = counted_train_steps(trainer, batch, per_step,
                                            n_values=n_values)
    fp32 = compare_fp32_step(trainer.model, batch, loss_tol=1e-5, loss=loss,
                             front_end=front_end)
    return ({"params_m": n_params / 1e6, "steps": history,
             "launches_per_step": per_step, **fp32}, launches)


def zoo_phases(detail, root):
    """Phases 19-22: the audio-only (offline and causal), video-only and LRW
    models at full width, served and trained through the kernels they
    reach. Returns {phase: launch counts of its main path}."""
    import shutil
    import tempfile

    from avec_tpu_torch.configs import lrw
    from avec_tpu_torch.models import zoo
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.serve import Server, _batch_bucket, _bucket
    from avec_tpu_torch.train.losses import CTCLoss, SoftmaxCrossEntropy
    from avec_tpu_torch.train.metrics import CategoricalAccuracy
    from avec_tpu_torch.train.model import Trainer

    rec, runs = {}, {}
    ffn = lambda n: {"fused_ffn_fwd": n, "fused_ffn_bwd": n}
    att = lambda n: {"fused_att_fwd": n, "fused_att_bwd": n}
    conv = lambda n: {name: n for name in cm.KERNELS}
    route = dict(fused_ffn=True, fused_att=True, fused_conv=True)
    ao_cfg = dict(vocab_size=256, att_type="patch", interctc_blocks=(),
                  num_blocks=(5, 6, 5))          # configs/LRS23/AO
    vo_cfg = dict(vocab_size=256, interctc_blocks=(3, 6, 9),
                  num_blocks=(6, 6))             # configs/LRS23/VO
    av_batch = make_train_batch(np.random.RandomState(0))
    ao_batch = {"inputs": av_batch["inputs"][2:],
                "targets": av_batch["targets"]}
    vo_batch = {"inputs": av_batch["inputs"][:2],
                "targets": av_batch["targets"]}

    # ---- 19. the audio-only model: served with flash, trained fused
    t0 = time.perf_counter()
    srv = Server(mode="ao", device="cuda", precision="bfloat16", seed=0,
                 use_flash=True, **ao_cfg)
    with torch.no_grad():
        zoo.randomize_batch_stats(srv.model, torch.Generator().manual_seed(1))
    reqs = [{"audio": r["audio"]}
            for r in make_requests(np.random.RandomState(3), low=3.7)]
    rec["ao_serve"] = served_path(srv, reqs, {
        "flash_attention_fwd": 11}, "AO served (flash, 11 layers)")
    runs["ao_serve"] = rec["ao_serve"]["launches"]
    log(f"AO served: K4 (flash_attention_fwd) launches over {ROUNDS} "
        f"forwards: {runs['ao_serve']['flash_attention_fwd']}")
    del srv
    model = zoo.AudioEfficientConformerInterCTC(device="cuda", **ao_cfg,
                                                **route)
    trainer = Trainer(model=model, device="cuda", precision="bfloat16",
                      loss=CTCLoss(zero_infinity=True), loss_weights=1.0)
    # BatchNorm kernels: the audio stem's and the 2 strided conv modules'
    rec["ao_train"], runs["ao_train"] = trained_path(
        trainer, ao_batch, {**ffn(32), **att(11), **conv(14),
                            **bn_launches(3)},
        "AO train (fused FFN, attention, conv; B=16, 6 s)", 3)
    del trainer, model
    torch.cuda.empty_cache()
    rec["ao_s"] = time.perf_counter() - t0

    # ---- 20. the causal audio-only model: trained fused, then causality
    t0 = time.perf_counter()
    model = zoo.AudioEfficientConformerInterCTC(
        device="cuda", causal=True, left_context=64, **ao_cfg, **route)
    pads = {cm.pad_lo_for(m.padding, m.layers["3"].kernel_size[0])
            for m in model.modules()
            if hasattr(m, "fused_conv") and m.fused_eligible()}
    if pads != {14}:
        raise AssertionError(f"causal conv modules pad_lo {pads} != {{14}}")
    trainer = Trainer(model=model, device="cuda", precision="bfloat16",
                      loss=CTCLoss(zero_infinity=True), loss_weights=1.0)
    rec["causal_train"], runs["causal_train"] = trained_path(
        trainer, ao_batch, {**ffn(32), **conv(14), **bn_launches(3)},
        "causal AO train (left context 64; fused FFN and conv at pad_lo 14)",
        3)
    model.eval()
    rng = np.random.RandomState(0)
    n, cut = 25600, 12800
    a1 = (rng.randn(1, n) * 0.1).astype(np.float32)
    a2 = a1.copy()
    a2[0, cut:] += rng.randn(n - cut).astype(np.float32)
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        l1, l2 = (model(torch.from_numpy(a).cuda(), lens)["outputs"][0][0]
                  for a in (a1, a2))
    safe = (cut - 256) // 1280
    same = bool(torch.equal(l1[:safe + 1], l2[:safe + 1]))
    later = float((l1[safe + 2:] - l2[safe + 2:]).abs().max())
    rec["causality"] = {"frames_identical": safe + 1, "identical": same,
                        "later_max_abs": later}
    log(f"causal AO (eval, fp32): audio changed after sample {cut}: frames "
        f"0-{safe} bit-identical: {same}; later frames max abs "
        f"{later:.3e} (must exceed 1e-3)")
    if not (same and later > 1e-3):
        raise AssertionError(f"causality check failed: {rec['causality']}")
    del trainer, model
    torch.cuda.empty_cache()
    rec["causal_s"] = time.perf_counter() - t0

    # ---- 21. the video-only model: served (stem kernel), trained fused,
    # test-time augmentation
    t0 = time.perf_counter()
    srv = Server(mode="vo", device="cuda", precision="bfloat16", seed=0,
                 stem_mode="pallas", **vo_cfg)
    with torch.no_grad():
        zoo.randomize_batch_stats(srv.model, torch.Generator().manual_seed(2))
    reqs = [{"video": r["video"]}
            for r in make_requests(np.random.RandomState(4))]
    rec["vo_serve"] = served_path(srv, reqs, {"bn_relu_pool": 1},
                                  "VO served (stem pallas)")
    runs["vo_serve"] = rec["vo_serve"]["launches"]
    samples = [srv._request_samples(r) for r in reqs]
    inputs = srv._inputs_for_batch(reqs, _bucket(max(samples)),
                                   _batch_bucket(len(reqs)))
    base = srv.forward(inputs, torch.float32)[0]
    srv.model.test_augments = [zoo.hflip]
    tta, tta_len = srv.forward(inputs, torch.float32)
    srv.model.test_augments = []
    b, tv = base.shape[0], base.shape[1]
    tta_err = max_abs(tta[:, 0], base)
    rec["vo_tta"] = {"shape": list(tta.shape), "base_max_abs": tta_err}
    log(f"VO test_augments=[flip] (eval, fp32): logits {tuple(tta.shape)}, "
        f"lengths {tuple(tta_len.shape)}; axis-1 entry 0 against the "
        f"forward without augments: max abs {tta_err:.2e} (tol 1e-4)")
    if not (tuple(tta.shape) == (b, 2, tv, 256) and tta_err <= 1e-4
            and tuple(tta_len.shape) == (b, 2)
            and bool(torch.isfinite(tta).all())):
        raise AssertionError(f"VO test-time augmentation: {rec['vo_tta']}")
    del srv, base, tta
    model = zoo.VisualEfficientConformerInterCTC(
        device="cuda", stem_mode="pallas", **vo_cfg, **route)
    trainer = Trainer(model=model, device="cuda", precision="bfloat16",
                      loss=CTCLoss(zero_infinity=True))
    rec["vo_train"], runs["vo_train"] = trained_path(
        trainer, vo_batch, {**ffn(24), **att(12), **conv(11),
                            "bn_relu_pool": 1, **bn_launches(20, 1)},
        "VO train (stem pallas, fused FFN, attention, conv; B=16 x 151 "
        "frames)", 7, front_end="encoder.front_end.")
    vo_trainer = trainer
    rec["vo_s"] = time.perf_counter() - t0

    # ---- 22. the LRW classifier: trained fused, then its front end loaded
    # into the VO model
    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="lrw_", dir=os.path.join(root,
                                                                "build"))
    try:
        setup = lrw.build(ckpt_dir, device="cuda",
                          route={**route, "stem_mode": "pallas"})
        batch = next(iter(setup.train_loader))
        log(f"LRW: batch {batch['inputs'].shape} clips, labels "
            f"{batch['targets'].shape}")
        rec["lrw_train"], runs["lrw_train"] = trained_path(
            setup.trainer, batch, {**ffn(24), **att(12), **conv(11),
                                   "bn_relu_pool": 1, **bn_launches(20, 1)},
            "LRW train (stem pallas, fused FFN, attention, conv; B=32 x 29 "
            "frames)", 3, loss=SoftmaxCrossEntropy(),
            front_end="encoder.front_end.")
        model = setup.model
        model.set_regularization(False)
        video = torch.as_tensor(batch["inputs"]).cuda()
        labels = torch.as_tensor(batch["targets"]).cuda()
        accs, ces = [], []
        for kernels in (True, False):
            model.set_kernels(kernels)
            with torch.no_grad():
                logits = model(video)["output"]
            accs.append(float(CategoricalAccuracy()(labels, logits)))
            ces.append(float(SoftmaxCrossEntropy()(labels, logits)))
        model.set_kernels(True)
        model.set_regularization(True)
        eval_losses, eval_metrics = setup.trainer.evaluate(setup.eval_loader)
        rec["lrw_train"].update({"fp32_acc_kernels_plain": accs,
                                 "fp32_ce_kernels_plain": ces,
                                 "eval_loss": eval_losses["loss"],
                                 "eval_acc": eval_metrics["acc"]})
        log(f"LRW fp32 train-mode forward: CE {ces[0]:.6f} vs {ces[1]:.6f} "
            f"(kernels vs plain), accuracy {accs[0]:.2f} vs {accs[1]:.2f}; "
            f"evaluation (bf16, {len(setup.eval_set)} clips): loss "
            f"{eval_losses['loss']:.4f}, acc {eval_metrics['acc']:.2f}")
        if not (abs(ces[0] - ces[1]) <= 1e-5 * abs(ces[1])
                and accs[0] == accs[1]):
            raise AssertionError(f"LRW CE / accuracy disagree: {ces} {accs}")
        path = os.path.join(ckpt_dir, "lrw.ckpt")
        setup.trainer.save(path, save_optimizer=False)
        vo_trainer.load(path, select=lambda k: "front_end" in k)
        lrw_state, vo_state = model.state_dict(), vo_trainer.model.state_dict()
        front = [k for k in lrw_state if "front_end" in k]
        loaded = all(torch.equal(vo_state[k], lrw_state[k]) for k in front)
        rec["partial_load"] = {"entries": len(front), "equal": loaded}
        log(f"LRW front end loaded into the VO model: {len(front)} entries, "
            f"all equal: {loaded}")
        if not (front and loaded):
            raise AssertionError("partial load of the LRW front end failed")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del vo_trainer
    torch.cuda.empty_cache()
    rec["lrw_s"] = time.perf_counter() - t0
    detail["zoo"] = rec
    return runs


# The ceiling on AO-Tone-Causal's greedy WER after the last epoch (and it
# must be below half of the WER at init). The JAX config reports about 0.6
# for the same recipe without causality (configs/Synthetic/AO-Tone.py:36).
CAUSAL_WER_CEILING = 20.0


def causal_learning_phase(detail, root) -> dict:
    """Phase 23: the AO-Tone-Causal learning run (`avec_tpu_torch/configs/
    ao_tone_causal.py`, the config's own size: 6400 utterances, B = 16,
    2 epochs of 400 steps, Noam (300, 360, 1.5), blocks (2, 2, 1), left
    context 64) on the fused-conv route through the training engine. The
    greedy WER of the 64 evaluation utterances at init and after each
    epoch; the launches of the fit's steps against the module tree's count
    per step. The WER after the last epoch must be at most
    CAUSAL_WER_CEILING and below half of the WER at init. Returns the
    kernel launches of the fit's train steps."""
    import shutil
    import tempfile

    from avec_tpu_torch.configs import ao_tone_causal
    from avec_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="ao_tone_causal_",
                                dir=os.path.join(root, "build"))
    route = dict(fused_ffn=True, fused_att=True, fused_conv=True)
    try:
        setup = ao_tone_causal.build(ckpt_dir, device="cuda", route=route)
        trainer = setup.trainer
        per_step = setup.model.kernel_launches_per_step()
        want = {"fused_ffn_fwd", "fused_ffn_bwd", "fused_conv_stats",
                "fused_conv_fwd", "fused_conv_bwd1", "fused_conv_bwd2",
                *BN_KERNELS}
        if set(per_step) != want:
            raise AssertionError(f"AO-Tone-Causal route kernels {per_step}")
        n_params = sum(p.numel() for p in setup.model.parameters())
        log(f"AO-Tone-Causal: {n_params / 1e6:.2f}M params, "
            f"{len(setup.train_set)} training and {len(setup.eval_set)} "
            f"evaluation utterances, B={setup.train_loader.batch_size}, "
            f"{setup.epochs} epochs of {len(setup.train_loader)} steps; "
            f"launches per step {per_step}")

        def wer():
            return trainer.evaluate(setup.eval_loader,
                                    recompute_metrics=True)[1]["wer"]

        wers = {"init": wer()}
        log(f"AO-Tone-Causal greedy WER at init: {wers['init']:.2f}")
        step_ms, train_launches = [], {}
        fit_step = trainer.train_step

        def timed_step(batch, accumulated_steps=1):
            torch.cuda.synchronize()
            before = dict(_cuda.launches)
            t0 = time.perf_counter()
            out = fit_step(batch, accumulated_steps)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in _cuda.launches.items():
                train_launches[k] = train_launches.get(k, 0) + v - \
                    before.get(k, 0)
            return out

        trainer.train_step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t_fit = time.perf_counter()
        history = trainer.fit(setup.train_loader, setup.epochs,
                              dataset_eval=setup.eval_loader,
                              recompute_metrics=setup.recompute_metrics,
                              step_log_period=200, saving_period_epoch=None)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer.train_step
        n_steps = len(step_ms)
        log(f"AO-Tone-Causal: main path launches over the fit's {n_steps} "
            f"train steps: {train_launches}")
        if train_launches != {k: v * n_steps for k, v in per_step.items()}:
            raise AssertionError(f"launches {train_launches} != {n_steps} x "
                                 f"{per_step}")
        losses = [h["losses"] for h in history]
        if n_steps != setup.epochs * len(setup.train_loader) or not all(
                math.isfinite(v) for row in losses for v in row.values()):
            raise AssertionError(f"{n_steps} steps, epoch losses {losses}")
        for h in history:
            wers[f"epoch_{h['epoch']}"] = h["eval"][0][1]["wer"]
        wall_s = time.perf_counter() - t_phase
        warm = min(20, n_steps // 2)
        counted = sorted(step_ms[warm:])
        median = counted[len(counted) // 2]
        run = {"wer": wers, "epoch_losses": losses, "steps": n_steps,
               "batch": setup.train_loader.batch_size,
               "step_ms_median": median,
               "step_ms_p10_p90": [counted[len(counted) // 10],
                                   counted[9 * len(counted) // 10]],
               "utterances_per_s": setup.train_loader.batch_size * 1e3
               / median, "fit_s": fit_s,
               "epoch_s": [h["seconds"] for h in history],
               "peak_gib": peak_gib, "wall_s": wall_s,
               "params_m": n_params / 1e6, "launches_per_step": per_step,
               "launches_train_steps": train_launches}
        log("AO-Tone-Causal greedy WER: " + ", ".join(
            f"{k} {v:.2f}" for k, v in wers.items()))
        log(f"AO-Tone-Causal train step: median {median:.3f} ms over steps "
            f"{warm + 1}-{n_steps} (p10 {run['step_ms_p10_p90'][0]:.3f}, p90 "
            f"{run['step_ms_p10_p90'][1]:.3f}; synchronized around each "
            f"step), {run['utterances_per_s']:.2f} utterances/s, peak "
            f"{peak_gib:.2f} GiB; fit {fit_s:.1f} s (evaluations included; "
            "its epochs' training loops "
            + ", ".join(f"{x:.1f}" for x in run["epoch_s"])
            + f" s), phase wall {wall_s:.1f} s")
        detail["learning_run_causal"] = run
        final = wers[f"epoch_{setup.epochs}"]
        if not (final <= CAUSAL_WER_CEILING and final < wers["init"] / 2):
            raise AssertionError(f"AO-Tone-Causal WER after the last epoch "
                                 f"{final:.2f}: above {CAUSAL_WER_CEILING} or "
                                 f"not below half of init {wers['init']:.2f}")
        return train_launches
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def lm_tone_phase(detail, lm_dir: str) -> None:
    """Phase 24, run before phase 18: the LM-Tone learning run
    (`avec_tpu_torch/configs/lm_tone.py`: GPT-Tiny over the 512-line tone
    corpus, 1 epoch of 32 steps at B = 16, AdamW, fp32) through the
    training engine into `lm_dir`, with an evaluation (loss, accuracy,
    top-10 accuracy) and the epoch's checkpoint, which phase 18's decoder
    rescores with. The losses must be finite and the evaluation loss below
    the uniform ln(34)."""
    from avec_tpu_torch.configs import lm_tone

    t_phase = time.perf_counter()
    setup = lm_tone.build(lm_dir, device="cuda")
    init = setup.trainer.evaluate(setup.eval_loader)
    history = setup.trainer.fit(setup.train_loader, setup.epochs,
                                dataset_eval=setup.eval_loader,
                                callback_path=lm_dir, step_log_period=16)
    losses, metrics = history[-1]["eval"][0]
    ckpt = lm_tone.last_checkpoint(lm_dir)
    wall_s = time.perf_counter() - t_phase
    run = {"init": {"losses": init[0], "metrics": init[1]},
           "eval_losses": losses, "eval_metrics": metrics,
           "train_losses": history[-1]["losses"],
           "steps": history[-1]["steps"], "checkpoint": ckpt,
           "wall_s": wall_s}
    log(f"LM-Tone: {history[-1]['steps']} steps; eval loss "
        f"{losses['loss']:.4f} (init {init[0]['loss']:.4f}), accuracy "
        f"{metrics['acc']:.2f}, top-10 accuracy {metrics['topk10']:.2f} "
        f"(init {init[1]['acc']:.2f}, {init[1]['topk10']:.2f}); checkpoint "
        f"{os.path.basename(ckpt or '')}; phase wall {wall_s:.1f} s")
    detail["lm_tone"] = run
    if ckpt is None or not all(math.isfinite(v) for v in
                               {**losses, **history[-1]["losses"]}.values()):
        raise AssertionError(f"LM-Tone run: {run}")
    if not losses["loss"] < math.log(34):
        raise AssertionError(f"LM-Tone eval loss {losses['loss']} not below "
                             f"ln(34)")


DECODE_BEAM = 16                   # configs/LRS23/AV/EffConfInterCTC.py
DECODE_ORDER = 6
DECODE_CUTOFF = 32                 # the Python search's check
GPT_SMALL = dict(vocab_size=1025, padding_idx=0, max_pos_encoding=2048,
                 model="GPT-Small", pos_embedding="learned")


def _beams_agree(got, want, what, tol=1e-3):
    """The same best prefix, scores within `tol`, and the same prefix at
    every rank whose score ties no other beam's (by more than 1e-3)."""
    if got[0][0] != want[0][0]:
        raise AssertionError(f"{what}: best prefixes differ: {got[0]} vs "
                             f"{want[0]}")
    n = min(len(got), len(want))
    worst = 0.0
    for k in range(n):
        (pa, sa), (pb, sb) = got[k], want[k]
        if not (math.isfinite(sa) and math.isfinite(sb)):
            if sa != sb:
                raise AssertionError(f"{what}: rank {k}: {sa} vs {sb}")
            continue
        worst = max(worst, abs(sa - sb))
        others = [s for j, (_, s) in enumerate(want[:n]) if j != k]
        if all(abs(sb - o) > 1e-3 for o in others) and pa != pb:
            raise AssertionError(f"{what}: rank {k}: {pa} vs {pb}")
    if worst > tol:
        raise AssertionError(f"{what}: scores differ by {worst} > {tol}")
    return worst


def decode_phase(detail, root) -> dict:
    """Phase 25: decoding at full width. The reference-depth AV model
    (use_flash, stem "pallas", vocab 256, seeded weights and BN statistics)
    served through `Server(decoder=CTCDeviceBeamSearchDecoder(...))`: 8
    requests in the 8 s bucket, beam 16 with an order-6 ARPA that
    `estimate_arpa` builds from 4000 seeded transcripts over the vocab
    (offset 100), alpha 0.6, beta 1.0; the launches of ROUNDS served
    batches must be 7 flash and 1 stem per forward. On the same log-probs
    the device search is held against the native decoder (8 threads): the
    same best prefix per utterance, the same prefixes where scores do not
    tie, scores within 1e-3; utterance 0 again with cutoff_top_n 32 in the
    Python, native and device searches. The native decoder's beams are
    rescored by GPT-Small at full width (d 768, 12 blocks, 12 heads, vocab
    1025, learned positions to 2048, seeded N(0, 0.02) weights), whose fp32
    forward on the card is held against the CPU's (max abs over max abs
    <= 1e-4); 3 AdamW steps of GPT-Small (its compile defaults, dropout off)
    on one fixed batch of 8 x 128 tokens: finite, falling losses. Printed:
    forward, device-beam, native-beam, Python-search and rescoring times,
    the GPT step's ms and peak GiB. Returns the launches per forward."""
    import shutil
    import tempfile

    from avec_tpu_torch.data.synthetic import tone_tokenizer
    from avec_tpu_torch.decode.beam import (CTCBeamSearchDecoder,
                                            GPTRescorer,
                                            ctc_prefix_beam_search)
    from avec_tpu_torch.decode.device_beam import (CTCDeviceBeamSearchDecoder,
                                                   device_beam_search)
    from avec_tpu_torch.decode.native import NativeBeamDecoder
    from avec_tpu_torch.decode.ngram import ArpaLM, estimate_arpa
    from avec_tpu_torch.models.zoo import GPT, randomize_batch_stats
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.serve import Server, _batch_bucket, _bucket
    from avec_tpu_torch.train.model import Trainer

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="decode_", dir=os.path.join(root, "build"))
    rec = {}
    try:
        rng = np.random.RandomState(24)
        tok_path = os.path.join(work, "tokenizer.json")
        tone_tokenizer(256).save(tok_path)
        lm_tok_path = os.path.join(work, "lm_tokenizer.json")
        tone_tokenizer(1024).save(lm_tok_path)
        t0 = time.perf_counter()
        seqs = [[chr(100 + int(t)) for t in rng.randint(1, 256,
                                                        rng.randint(4, 41))]
                for _ in range(4000)]
        arpa = estimate_arpa(seqs, os.path.join(work, "6gram.arpa"),
                             order=DECODE_ORDER)
        lm = ArpaLM(arpa)
        dev_dec = CTCDeviceBeamSearchDecoder(
            tok_path, beam_size=DECODE_BEAM, ngram_path=arpa,
            ngram_alpha=0.6, ngram_beta=1.0, ngram_offset=100)
        rec["arpa"] = {"order": lm.order, "ngrams": len(lm.probs),
                       "build_s": time.perf_counter() - t0}
        log(f"decode: order-{lm.order} ARPA of {len(lm.probs)} n-grams from "
            f"{len(seqs)} seeded transcripts, with the device tables in "
            f"{rec['arpa']['build_s']:.1f} s")

        srv = Server(device="cuda", precision="bfloat16", seed=0,
                     vocab_size=256, use_flash=True, stem_mode="pallas",
                     decoder=dev_dec)
        with torch.no_grad():
            randomize_batch_stats(srv.model, torch.Generator().manual_seed(1))
        reqs = make_requests(np.random.RandomState(25), low=3.7)
        samples = [len(r["audio"]) for r in reqs]
        inputs = srv._inputs_for_batch(reqs, _bucket(max(samples)),
                                       _batch_bucket(len(reqs)))
        srv.transcribe_batch(reqs)                   # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            results = srv.transcribe_batch(reqs)
        torch.cuda.synchronize()
        served_s = (time.perf_counter() - t0) / ROUNDS
        launches = dict(_cuda.launches)
        per_forward = {k: v // ROUNDS for k, v in launches.items()}
        log(f"launches_decode: main path launches over {ROUNDS} served "
            f"batches {launches}: per served forward {per_forward}")
        if launches != {"flash_attention_fwd": 7 * ROUNDS,
                        "bn_relu_pool": ROUNDS}:
            raise AssertionError(f"decode path launches {launches}")
        if not all(isinstance(r["text"], str) for r in results) or all(
                not r["text"] for r in results):
            raise AssertionError(f"served texts {results}")

        with torch.no_grad():
            logits, lengths = srv.forward(inputs)
        logits, lengths = logits[:len(reqs)], lengths[:len(reqs)]
        logp_dev = dev_dec.log_probs(logits)
        logp, lens = logp_dev.cpu().numpy(), lengths.cpu().numpy()
        fwd_ms = cuda_time_ms(lambda: srv.forward(inputs), iters=5, warmup=1)

        def wall_ms(fn, n=3):
            times = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return sorted(times)[n // 2], out

        dev_ms, dev_beams = wall_ms(lambda: dev_dec.search(logp_dev,
                                                           lengths))
        native = NativeBeamDecoder(beam_size=DECODE_BEAM, alpha=0.6,
                                   beta=1.0, ngram_path=arpa,
                                   ngram_offset=100, num_threads=8)
        nat_ms, nat_beams = wall_ms(lambda: native.decode_batch(logp, lens))
        worst = max(_beams_agree(d, n_, f"utterance {i} device vs native")
                    for i, (d, n_) in enumerate(zip(dev_beams, nat_beams)))
        log(f"decode: logits {tuple(logits.shape)}, frames "
            f"{lens.tolist()}; device beam vs native beam (beam "
            f"{DECODE_BEAM}, order {DECODE_ORDER}): best prefixes equal for "
            f"all {len(lens)}, scores max abs diff {worst:.3e} (tol 1e-3)")

        py_t0 = time.perf_counter()
        py = ctc_prefix_beam_search(
            logp[0].astype(np.float64), int(lens[0]), DECODE_BEAM, lm=lm,
            alpha=0.6, beta=1.0, token_to_word=lambda i: chr(i + 100),
            cutoff_top_n=DECODE_CUTOFF)
        py_ms = (time.perf_counter() - py_t0) * 1e3
        nat_c = NativeBeamDecoder(beam_size=DECODE_BEAM, alpha=0.6, beta=1.0,
                                  ngram_path=arpa, ngram_offset=100,
                                  cutoff_top_n=DECODE_CUTOFF).decode(
            logp[0], int(lens[0]))
        dev_c = device_beam_search(logp_dev[:1], lengths[:1], DECODE_BEAM,
                                   tables=dev_dec.tables, alpha=0.6,
                                   beta=1.0, cutoff_top_n=DECODE_CUTOFF)[0]
        worst_c = max(_beams_agree(nat_c, py, "cutoff 32: native vs Python"),
                      _beams_agree(dev_c, py, "cutoff 32: device vs Python"))
        log(f"decode: utterance 0 with cutoff_top_n {DECODE_CUTOFF}: Python "
            f"search {py_ms:.1f} ms; native and device against it: best "
            f"prefixes equal, scores max abs diff {worst_c:.3e} (tol 1e-3)")

        # GPT-Small: rescoring, the fp32 forward against the CPU, 3 steps
        gpt = GPT(**GPT_SMALL, device="cuda",
                  generator=torch.Generator().manual_seed(0))
        gpt_params = sum(p.numel() for p in gpt.parameters())
        dec = CTCBeamSearchDecoder(
            tok_path, beam_size=DECODE_BEAM, ngram_path=arpa,
            ngram_alpha=0.6, ngram_beta=1.0, ngram_offset=100,
            neural_rescorer=GPTRescorer(gpt), neural_tokenizer_path=lm_tok_path,
            neural_alpha=0.6, neural_beta=1.0, neural_pad_token=0,
            neural_sos_token=1024, neural_eos_token=1024, num_processes=8)
        padded = [b + [((), -math.inf)] * (DECODE_BEAM - len(b))
                  for b in nat_beams]
        dec.neural_scores(padded)                    # warm-up
        resc_ms, (nscores, _) = wall_ms(lambda: dec.neural_scores(padded))
        best = dec.beam_search(logits, lens)
        if len(best) != len(reqs) or not np.isfinite(nscores).all():
            raise AssertionError("GPT rescoring failed")
        seqs = []
        for b in padded:
            for prefix, _ in b:
                text = dec.tokenizer.decode([list(prefix)])[0]
                seqs.append([1024] + dec.neural_tokenizer.encode(text)
                            + [1024])
        n_tok = sum(len(x) for x in seqs)
        log(f"decode: GPT-Small {gpt_params / 1e6:.2f}M params rescored "
            f"{len(seqs)} beams ({n_tok} tokens) in {resc_ms:.1f} ms; best "
            f"beams after rescoring: {[len(x) for x in best]} tokens")

        check = torch.zeros((8, 64), dtype=torch.long)
        for j, x in enumerate(seqs[:8 * DECODE_BEAM:DECODE_BEAM]):
            check[j, :min(len(x), 64)] = torch.tensor(x[:64])
        with torch.no_grad():
            gpu = gpt(check.cuda())["output"].float().cpu()
            cpu_model = GPT(**GPT_SMALL, device="cpu")
            cpu_model.load_state_dict(gpt.state_dict())
            cpu = cpu_model(check)["output"]
        gpt_rel = float((gpu - cpu).abs().max() / cpu.abs().max())
        log(f"decode: GPT-Small fp32 forward (8, 64) on the card vs the CPU: "
            f"max abs diff over max abs {gpt_rel:.3e} (tol 1e-4)")
        del cpu_model, cpu
        if not gpt_rel <= 1e-4:
            raise AssertionError(f"GPT-Small card vs CPU {gpt_rel}")

        trainer = Trainer(model=gpt, device="cuda", precision="float32",
                          seed=0)
        gpt.set_regularization(False)
        ids = torch.from_numpy(np.random.RandomState(26).randint(
            1, 1024, (8, 128)))
        batch = {"inputs": [ids], "targets": torch.roll(ids, -1, 1)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_losses, step_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, _ = trainer.train_step(batch)
            step_losses.append(float(losses["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"decode: GPT-Small AdamW steps on one 8 x 128 batch: losses "
            + ", ".join(f"{x:.6f}" for x in step_losses)
            + f"; step ms {', '.join(f'{x:.1f}' for x in step_ms)}; peak "
            f"{peak_gib:.2f} GiB")
        if not (all(math.isfinite(x) for x in step_losses)
                and step_losses[0] > step_losses[1] > step_losses[2]):
            raise AssertionError(f"GPT-Small losses {step_losses}")

        rec.update({
            "launches": launches, "per_forward": per_forward,
            "served_batch_ms": served_s * 1e3,
            "forward_ms": fwd_ms, "device_beam_ms": dev_ms,
            "native_beam_ms": nat_ms, "native_threads": 8,
            "python_search_ms_one_utterance_cutoff32": py_ms,
            "rescoring_ms": resc_ms, "rescored_beams": len(seqs),
            "rescored_tokens": n_tok, "device_vs_native_max_abs": worst,
            "cutoff32_max_abs": worst_c, "gpt_small_params_m":
            gpt_params / 1e6, "gpt_small_card_vs_cpu_rel": gpt_rel,
            "gpt_small_losses": step_losses, "gpt_small_step_ms": step_ms,
            "gpt_small_peak_gib": peak_gib,
            "texts": [r["text"] for r in results],
            "wall_s": time.perf_counter() - t_phase})
        log(f"decode ({gpu_line()}): served batch {served_s * 1e3:.1f} ms "
            f"(forward {fwd_ms:.2f} ms, device beam {dev_ms:.1f} ms), native "
            f"beam {nat_ms:.1f} ms on 8 threads, GPT-Small rescoring "
            f"{resc_ms:.1f} ms, GPT-Small step {sorted(step_ms)[1]:.1f} ms, "
            f"peak {peak_gib:.2f} GiB; phase wall {rec['wall_s']:.1f} s")
        detail["decode"] = rec
        return per_forward
    finally:
        shutil.rmtree(work, ignore_errors=True)



def _seeded_text(rng, n_lines: int = 600) -> list:
    """Seeded lines of random 3-8 letter words: the corpus of phase 26's
    tokenizer (train_bpe reaches its 256 pieces over it)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return [" ".join("".join(rng.choice(letters, rng.randint(3, 9)))
                     for _ in range(rng.randint(4, 12)))
            for _ in range(n_lines)]


def serve_files_phase(detail, root, work: str):
    """Phase 26: serving from files. The full-width AO model as
    `Server(mode="ao")` builds it (blocks (5, 6, 5), patch attention in
    stage 1, no InterCTC, vocab 256) with use_flash, bf16, seeded weights
    and BN statistics, and a tokenizer `train_bpe` learns (256 pieces) from
    seeded text; 8 seeded utterances of 2-6 s written as wav and as flac
    under `work`. Main path (counts set to 0 just before, read just after):
    `transcribe_batch` over the 8 wav paths, over the 8 flac paths and over
    the samples as arrays, then `stdin_loop` over the flac paths from an
    in-memory stream with max_batch 4 (two batches, the second submitted
    before the first is decoded); 11 flash launches per forward; then the
    mp4 requests of `serve_mp4`, counted apart. Required:
    identical texts from wav, flac and arrays, the loop's texts equal to
    `transcribe_batch` on the same two batches, an {"file", "error"} row for
    a missing path, texts not all empty. Then ROUNDS timed submit + finish
    pairs of the 8 wav paths: the host ms of `submit_batch` and of
    `finish_batch`, the latency p50 / p95 and mean RTF; one submit under
    `torch.cuda.set_sync_debug_mode("warn")` lists the host syncs it makes,
    and one traced submit (`trace_submit`) shows where its host time goes.
    Returns (the server, the tokenizer path, the main path's launches)."""
    import io

    from avec_tpu_torch.models.zoo import randomize_batch_stats
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.serve import Server, stdin_loop
    from avec_tpu_torch.utils import media
    from avec_tpu_torch.utils.tokenizer import Tokenizer, train_bpe

    t_phase = time.perf_counter()
    tok_path = os.path.join(work, "tokenizer.json")
    tok = Tokenizer(train_bpe(_seeded_text(np.random.RandomState(26)), 256))
    tok.save(tok_path)
    srv = Server(mode="ao", device="cuda", precision="bfloat16", seed=0,
                 use_flash=True, tokenizer=tok_path, vocab_size=256,
                 att_type="patch", num_blocks=(5, 6, 5))
    with torch.no_grad():
        randomize_batch_stats(srv.model, torch.Generator().manual_seed(1))
    wavs, flacs, arrays = [], [], []
    for i, r in enumerate(make_requests(np.random.RandomState(26))):
        wav, flac = (os.path.join(work, f"utt{i}.{ext}")
                     for ext in ("wav", "flac"))
        media.write_audio(wav, r["audio"])
        audio = media.read_audio(wav)[0]
        media.write_audio(flac, audio)
        wavs.append(wav)
        flacs.append(flac)
        arrays.append({"audio": audio})
    seconds = [len(a["audio"]) / 16000 for a in arrays]
    srv.transcribe_batch(wavs[:4])                   # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    _cuda.reset_launches()
    by_wav = srv.transcribe_batch(wavs)
    by_flac = srv.transcribe_batch(flacs)
    by_array = srv.transcribe_batch(arrays)
    out = io.StringIO()
    stdin_loop(srv, max_batch=4, window_ms=500.0, out=out,
               stream=io.StringIO("".join(p + "\n" for p in flacs)))
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    looped = [json.loads(line) for line in out.getvalue().splitlines()]
    texts = [r["text"] for r in by_wav]
    want_loop = srv.transcribe_batch(flacs[:4]) + srv.transcribe_batch(
        flacs[4:])
    missing = os.path.join(work, "missing.wav")
    mixed = srv.transcribe_batch([wavs[0], missing])
    log(f"AO served from files (flash, 11 layers): main path launches over 5 "
        f"forwards (wav, flac, arrays, stdin loop x 2): {launches}")
    flac_texts = [r["text"] for r in by_flac]
    log(f"  {len(wavs)} requests of {min(seconds):.2f}-{max(seconds):.2f} s; "
        f"texts wav == flac: {texts == flac_texts}, flac == arrays: "
        f"{flac_texts == [r['text'] for r in by_array]}, "
        f"stdin loop (batch sizes {[r['batch_size'] for r in looped]}) == "
        f"transcribe_batch: "
        f"{[r['text'] for r in looped] == [r['text'] for r in want_loop]}; "
        f"missing path -> {mixed[1]}")
    log(f"  text of utterance 0: {texts[0][:80]!r}")
    checks = {
        "launches": launches == {"flash_attention_fwd": 5 * 11},
        "wav_equals_flac": texts == [r["text"] for r in by_flac],
        "flac_equals_arrays": [r["text"] for r in by_flac]
        == [r["text"] for r in by_array],
        "loop_equals_batches": [r["text"] for r in looped]
        == [r["text"] for r in want_loop]
        and [r["file"] for r in looped] == flacs
        and [r["batch_size"] for r in looped] == [4] * 8,
        "error_row": set(mixed[1]) == {"file", "error"}
        and mixed[0]["text"] == srv.transcribe(wavs[0])["text"],
        "texts_not_empty": any(texts)}
    if not all(checks.values()):
        raise AssertionError(f"serving from files: {checks}")

    # host syncs of one submit
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pending = srv.submit_batch(wavs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    srv.finish_batch(pending)
    # the detector's warnings only, not its notice that it "does not yet
    # detect all synchronizing operations"
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    log(f"  host syncs in one submit_batch (set_sync_debug_mode 'warn'): "
        f"{len(syncs)} {sorted(set(syncs))}")
    trace = trace_submit(srv, wavs)

    srv.latencies, srv.rtfs = [], []
    sub_ms, fin_ms = [], []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = srv.submit_batch(wavs)
        t1 = time.perf_counter()
        srv.finish_batch(pending)
        t2 = time.perf_counter()
        sub_ms.append((t1 - t0) * 1e3)
        fin_ms.append((t2 - t1) * 1e3)
    stats = srv.stats_summary()
    mp4 = serve_mp4(work)
    rec = {"launches": launches, "checks": checks, "seconds": seconds,
           "mp4": mp4,
           "texts": texts, "host_syncs_in_submit": len(syncs),
           "host_sync_messages": sorted(set(syncs)), "submit_trace": trace,
           "submit_host_ms": sub_ms,
           "finish_host_ms": fin_ms, **stats,
           "wall_s": time.perf_counter() - t_phase}
    log(f"  ({gpu_line()}) 8 files of 2-6 s per batch, {ROUNDS} rounds: "
        f"latency p50 {stats['latency_p50_s'] * 1e3:.1f} ms, p95 "
        f"{stats['latency_p95_s'] * 1e3:.1f} ms, mean RTF "
        f"{stats['rtf_mean']:.4f}; host ms submit_batch "
        f"{', '.join(f'{x:.1f}' for x in sub_ms)} vs finish_batch "
        f"{', '.join(f'{x:.1f}' for x in fin_ms)}; phase wall "
        f"{rec['wall_s']:.1f} s")
    detail["serve_files"] = rec
    return srv, tok_path, launches


MP4_WANT = {"av": {"flash_attention_fwd": 7, "bn_relu_pool": 1},
            "vo": {"bn_relu_pool": 1}}      # launches per served forward


def serve_mp4(work: str) -> dict:
    """Phase 26's mp4 requests: 8 seeded `_mouth.mp4` clips of 1-3 s
    (`data/lrs_fixture.py` with video, 96 x 96 frames, OpenCV) with the .wav
    beside each (`demo.load_av_inputs` reads `<clip>.wav`), served by the
    full-width AV model (use_flash, stem "pallas") and the full-width VO
    model (LRS23 VO widths, stem "pallas"), bf16, seeded weights and BN
    statistics, the tree's tokenizer. For each: `transcribe_batch` over the
    clip paths (launch counts set to 0 just before, read just after: K4 7
    and K5 once per AV forward, K5 once per VO forward), then over the same
    decoded frames (and audio) as arrays: the texts must be equal. A clip
    that does not decode raises."""
    import glob
    import shutil

    from avec_tpu_torch.data.lrs_fixture import write_lrs_fixture
    from avec_tpu_torch.models.zoo import randomize_batch_stats
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.serve import Server

    t0 = time.perf_counter()
    root = os.path.join(work, "lrs")
    paths = write_lrs_fixture(root, seed=26, sizes={("LRS3", "test"): 8},
                              video=True)
    clips = sorted(glob.glob(os.path.join(root, "LRS3", "test", "*",
                                          "*_mouth.mp4")))
    for clip in clips:
        shutil.copy(clip[:-len("_mouth.mp4")] + ".wav", clip[:-4] + ".wav")
    rec = {"clips": len(clips), "write_s": time.perf_counter() - t0}
    card = gpu_line()
    for mode, cfg in (("av", dict(use_flash=True)),
                      ("vo", dict(interctc_blocks=(3, 6, 9),
                                  num_blocks=(6, 6)))):
        srv = Server(mode=mode, device="cuda", precision="bfloat16", seed=0,
                     stem_mode="pallas", tokenizer=paths["tokenizer"],
                     vocab_size=256, **cfg)
        with torch.no_grad():
            randomize_batch_stats(srv.model, torch.Generator().manual_seed(3))
        arrays = [srv.load_request(c) for c in clips]
        srv.transcribe_batch(clips[:2])              # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t1 = time.perf_counter()
        by_path = srv.transcribe_batch(clips)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        call_ms = (time.perf_counter() - t1) * 1e3
        by_array = srv.transcribe_batch(arrays)
        texts = [r["text"] for r in by_path]
        frames = [a["video"].shape[0] for a in arrays]
        equal = texts == [r["text"] for r in by_array]
        rec[mode] = {"launches": launches, "texts": texts,
                     "texts_equal_arrays": equal, "frames": frames,
                     "audio": "audio" in arrays[0], "call_ms": call_ms}
        log(f"{mode.upper()} served from {len(clips)} mp4 clips ({card}): "
            f"main path launches {launches} (one forward, want "
            f"{MP4_WANT[mode]}); frames {min(frames)}-{max(frames)}, audio "
            f"beside: {'audio' in arrays[0]}; texts from the clips == the "
            f"same decoded frames as arrays: {equal}; transcribe_batch "
            f"{call_ms:.1f} ms; text 0 {texts[0][:60]!r}")
        if not (equal and launches == MP4_WANT[mode]
                and all("audio" in a for a in arrays)):
            raise AssertionError(f"mp4 serving ({mode}): {rec[mode]}")
        del srv, arrays
        torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t0
    return rec


def trace_submit(srv, paths):
    """One `submit_batch(paths)` traced by torch.profiler (after a traced
    and dropped warm-up submit): the submit's host ms, the host ms of
    loading the files alone (timed apart), the CUDA runtime calls the
    submit made by name (count, host ms; a blocking wait shows as a
    `...Synchronize` call or a long `cudaMemcpy`), and its kernels: count,
    device-busy ms and when the last one ended, in ms after the submit
    returned (negative: the card had finished before the host did)."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    t0 = time.perf_counter()
    for p in paths:
        srv.load_request(p)
    load_ms = (time.perf_counter() - t0) * 1e3
    events = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Profiler clears events ..."
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda pr: events.extend(pr.events())
                     ) as prof:
            srv.finish_batch(srv.submit_batch(paths))
            torch.cuda.synchronize()
            prof.step()
            time.sleep(TRACE_MARGIN_S)
            with record_function("submit_batch"):
                pending = srv.submit_batch(paths)
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            prof.step()
    srv.finish_batch(pending)
    span = [e for e in events if e.name == "submit_batch"
            and e.device_type == DeviceType.CPU][0].time_range
    runtime, kernels = {}, []
    for e in events:                  # the submit's kernels may end later
        r = e.time_range
        if r.start < span.start:
            continue
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((r.start, r.end))
        elif e.name.startswith("cuda") and r.start <= span.end:
            n, us = runtime.get(e.name, (0, 0.0))
            runtime[e.name] = (n + 1, us + r.elapsed_us())
    busy, last = 0.0, span.start
    for start, end in sorted(kernels):       # the union of kernel intervals
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    rec = {"submit_ms": span.elapsed_us() / 1e3, "load_files_ms": load_ms,
           "runtime_calls": {k: {"count": n, "host_ms": us / 1e3}
                             for k, (n, us) in sorted(
                                 runtime.items(), key=lambda kv: -kv[1][1])},
           "kernels": len(kernels), "device_busy_ms": busy / 1e3,
           "last_kernel_end_after_return_ms": (last - span.end) / 1e3}
    waits = {k: v for k, v in rec["runtime_calls"].items()
             if "Synchronize" in k or k in ("cudaMemcpy", "cudaHostAlloc")}
    log(f"  traced submit_batch (torch.profiler): {rec['submit_ms']:.1f} ms "
        f"on the host (loading the {len(paths)} files alone "
        f"{load_ms:.1f} ms), "
        f"{rec['kernels']} device ops busy {rec['device_busy_ms']:.2f} ms, "
        f"the last ending {rec['last_kernel_end_after_return_ms']:.2f} ms "
        f"after the submit returned; runtime calls "
        + ", ".join(f"{k} {v['count']}x {v['host_ms']:.2f} ms"
                    for k, v in list(rec["runtime_calls"].items())[:6])
        + f"; waits among them: {waits or 'none'}")
    return rec


def streaming_phase(detail, srv, tok_path):
    """Phase 27: streaming. (a) `StreamingTranscriber` on phase 26's model
    over a 6 s utterance in 200 ms pushes, unbounded: the final token ids
    equal the offline greedy ids in the same bucket (bf16); then windowed
    (window_seconds 4) with one 20 s push: every bucket at most
    bucket(window + hop), commits monotone; 11 flash launches per forward.
    (b) `CausalStreamingTranscriber` on the full-width causal AO model
    (blocks (5, 6, 5), vocab 256, left_context 128, chunk 16, seeded
    weights and BN statistics) over a 6 s utterance (96 123 samples) in
    ragged pushes of 5 000, fp32 then bf16: the steps are
    ceil((n // 160 + 1) / 16), the output frames od^3(n // 160 + 1), the
    fp32 logits within 2e-4 of the offline causal forward (1e-3 if the
    card's reassociation needs it; the bound used is printed), the fp32
    tokens identical, every partial a prefix of the final text; no kernel
    launched. Printed: per-chunk latency p50 / p95, the bf16 max abs
    differences, the card's fp32 offline forward against the CPU's and the
    streamed against the offline log-mels (`fbank_stream_gap`). Returns
    (a)'s launches."""
    from avec_tpu_torch.decode.causal_streaming import (
        CausalStreamingTranscriber, _od)
    from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
    from avec_tpu_torch.decode.streaming import (StreamingTranscriber,
                                                 _collapse_host)
    from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                           randomize_batch_stats)
    from avec_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    rec = {}
    decoder = CTCGreedySearchDecoder(tok_path)
    audio = make_requests(np.random.RandomState(27))[0]["audio"]   # 6 s

    # ---- (a) the bidirectional transcriber
    _cuda.reset_launches()
    st = StreamingTranscriber(srv.model, decoder, precision="bfloat16")
    partials = [st.push(audio[s: s + 3200])["text"]
                for s in range(0, len(audio), 3200)]
    final = st.finish()
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    forwards = sum(st._fwd_cache.values())
    ids = st._committed + st._fresh
    bucket = st._bucket(len(audio))
    pad = np.zeros((1, bucket), np.float32)
    pad[0, :len(audio)] = audio
    logits, lengths = srv.forward([pad, np.array([len(audio)], np.int32)])
    toks, tok_len = decoder.device_fn((logits, lengths))
    offline = toks[0, :int(tok_len[0])].tolist()
    ok_a = bool(ids) and ids == offline and launches == {
        "flash_attention_fwd": 11 * forwards}
    log(f"streaming (bidirectional, unbounded, 200 ms pushes of 6 s): "
        f"{forwards} forwards, launches {launches}; final ids == offline "
        f"greedy ids of the {bucket}-sample bucket: {ids == offline} "
        f"({len(ids)} tokens); {len(partials)} partials; device "
        f"{final['device_seconds'] * 1e3:.1f} ms")
    long_audio = np.concatenate([make_requests(np.random.RandomState(
        270 + k))[0]["audio"] for k in range(4)])[:20 * 16000]
    win = StreamingTranscriber(srv.model, decoder, window_seconds=4.0,
                               precision="bfloat16")
    commits = []
    slide = win._slide_window

    def recording_slide(preds):
        out = slide(preds)
        commits.append(len(win._committed))
        return out

    win._slide_window = recording_slide
    win.push(long_audio)
    wfinal = win.finish()
    cap = win._bucket(win.window + win.hop)
    ok_w = (bool(win._fwd_cache) and all(b <= cap for b in win._fwd_cache)
            and commits == sorted(commits) and commits[-1] > 0)
    log(f"  windowed (4 s) over one 20 s push: buckets "
        f"{sorted(win._fwd_cache)} (cap {cap}), {len(commits)} window "
        f"slides, commits monotone: {commits == sorted(commits)} (last "
        f"{commits[-1]}), final text {len(wfinal['text'])} chars")
    rec["bidirectional"] = {
        "forwards": forwards, "launches": launches, "ids_equal": ids ==
        offline, "tokens": len(ids), "windowed_buckets": sorted(
            win._fwd_cache), "windowed_commits": commits}
    if not (ok_a and ok_w):
        raise AssertionError(f"bidirectional streaming: {rec}")

    # ---- (b) the causal transcriber at full width
    model = AudioEfficientConformerInterCTC(
        device="cuda", vocab_size=256, interctc_blocks=(),
        num_blocks=(5, 6, 5), causal=True, left_context=128,
        generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        randomize_batch_stats(model, torch.Generator().manual_seed(8))
    n = 96123
    utt = np.concatenate([audio, audio[:n - len(audio)]])
    with torch.no_grad():
        want, want_len = model(torch.from_numpy(utt[None]).cuda(),
                               torch.tensor([n], dtype=torch.int32,
                                            device="cuda"))["outputs"]
        # the offline bf16 forward as the transcriber runs it: the fbank
        # on fp32 samples, then the cast
        hook = model.encoder.preprocessing.register_forward_hook(
            lambda m, i, o: (o[0].to(torch.bfloat16), o[1]))
        want_bf, _ = model(torch.from_numpy(utt[None]).cuda(),
                           torch.tensor([n], dtype=torch.int32,
                                        device="cuda"))["outputs"]
        hook.remove()
        # and with the samples cast to bf16 first, as the JAX package's
        # bf16 forward casts them (avec_tpu/train/model.py:146-151)
        wave_bf, _ = model(torch.from_numpy(utt[None]).cuda().to(
            torch.bfloat16), torch.tensor([n], dtype=torch.int32,
                                          device="cuda"))["outputs"]
    want = want[0].float().cpu().numpy()
    want_bf = want_bf[0].float().cpu().numpy()
    wave_bf = wave_bf[0].float().cpu().numpy()
    offline_bf16_gap = float(np.abs(want_bf - want).max())
    offline_wave_bf16_gap = float(np.abs(wave_bf - want).max())
    # the card's own fp32 floor: the offline forward on the CPU (its fbank
    # product sums in another order; near-silent bins' log-mels move most)
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        want_cpu = cpu_model(torch.from_numpy(utt[None]), torch.tensor(
            [n], dtype=torch.int32))["outputs"][0][0].numpy()
    del cpu_model
    floor = float(np.abs(want - want_cpu).max())
    fbank_gap = fbank_stream_gap(model, decoder, utt)
    n_out = _od(_od(_od(n // 160 + 1)))
    steps = -(-(n // 160 + 1) // 16)
    runs = {}
    _cuda.reset_launches()
    for precision in ("float32", "bfloat16"):
        cst = CausalStreamingTranscriber(model, decoder, chunk_frames=16,
                                         precision=precision)
        cst.collect_logits = True
        parts = [cst.push(utt[s: s + 5000])["text"]
                 for s in range(0, n, 5000)]
        fin = cst.finish()
        got = np.concatenate(cst.logits_chunks)[:cst._o_total]
        lat = np.sort(np.asarray(cst.push_latencies)) * 1e3
        keep = [got] if precision == "float32" else []
        warm = 128 // 4     # output frames over the caches' warm-up
        runs[precision] = {
            "steps": len(cst.push_latencies), "frames": int(got.shape[0]),
            "max_abs_vs_offline_fp32": float(np.abs(got - want).max()),
            "max_abs_warmup_frames": float(np.abs(got - want)[:warm].max()),
            "max_abs_later_frames": float(np.abs(got - want)[warm:].max()),
            "offline_logits_max_abs": float(np.abs(want).max()),
            "max_abs_vs_offline_bf16": float(np.abs(got - want_bf).max()),
            "greedy_ids_agree": float((got.argmax(-1)
                                       == want.argmax(-1)).mean()),
            "tokens_equal": cst._tokens == _collapse_host(want.argmax(-1)),
            "prefixes": all(fin["text"].startswith(p) for p in parts),
            "chunk_ms_p50": float(lat[len(lat) // 2]),
            "chunk_ms_p95": float(lat[min(len(lat) - 1,
                                          int(len(lat) * 0.95))]),
            "text": fin["text"], "logits": keep}
    runs["bfloat16"].pop("logits")
    torch.cuda.synchronize()
    causal_launches = dict(_cuda.launches)
    f32, bf = runs["float32"], runs["bfloat16"]
    tol = 2e-4 if f32["max_abs_vs_offline_fp32"] <= 2e-4 else 1e-3
    f32["streamed_vs_offline_cpu"] = float(np.abs(
        np.concatenate(runs["float32"].pop("logits")) - want_cpu).max())
    log(f"streaming (causal, full width, left context 128, chunk 16, "
        f"{n} samples in pushes of 5000; {gpu_line()}): {f32['steps']} steps "
        f"(want {steps}), {f32['frames']} frames (want {n_out}); fp32 logits "
        f"vs offline causal max abs {f32['max_abs_vs_offline_fp32']:.3e} "
        f"(bound {tol}; frames 0-31, the caches' warm-up, "
        f"{f32['max_abs_warmup_frames']:.3e}, later "
        f"{f32['max_abs_later_frames']:.3e}; largest offline logit "
        f"{f32['offline_logits_max_abs']:.2f}; the card's offline forward "
        f"vs the CPU's {floor:.3e}, streamed vs the CPU's "
        f"{f32['streamed_vs_offline_cpu']:.3e}; streamed vs offline "
        f"log-mels {fbank_gap:.3e}), tokens equal: "
        f"{f32['tokens_equal']}, partials "
        f"prefixes: {f32['prefixes']}; per-chunk ms p50 "
        f"{f32['chunk_ms_p50']:.2f} p95 {f32['chunk_ms_p95']:.2f}")
    log(f"  bf16: logits vs offline fp32 max abs "
        f"{bf['max_abs_vs_offline_fp32']:.3e}, vs offline bf16 (fbank on "
        f"fp32 samples, then the cast) {bf['max_abs_vs_offline_bf16']:.3e}; "
        f"offline bf16 vs offline fp32 {offline_bf16_gap:.3e}, with the "
        f"samples cast to bf16 first (the JAX package's bf16 forward) "
        f"{offline_wave_bf16_gap:.3e}; greedy ids agree on "
        f"{bf['greedy_ids_agree'] * 100:.1f}% of frames, tokens equal: "
        f"{bf['tokens_equal']}; per-chunk ms p50 {bf['chunk_ms_p50']:.2f} "
        f"p95 {bf['chunk_ms_p95']:.2f}; kernel launches of both runs: "
        f"{causal_launches} (the causal step runs no hand-written kernel)")
    rec["causal"] = {**runs, "bound": tol, "launches": causal_launches,
                     "offline_bf16_vs_fp32": offline_bf16_gap,
                     "offline_waveform_bf16_vs_fp32": offline_wave_bf16_gap,
                     "offline_card_vs_cpu_fp32": floor,
                     "fbank_streamed_vs_offline": fbank_gap,
                     "samples": n, "want_steps": steps, "want_frames": n_out}
    rec["wall_s"] = time.perf_counter() - t_phase
    detail["streaming"] = rec
    ok_b = (all(r["steps"] == steps and r["frames"] == n_out
                and r["prefixes"] for r in runs.values())
            and f32["max_abs_vs_offline_fp32"] <= 1e-3 and f32["tokens_equal"]
            and causal_launches == {} and f32["text"] != "")
    if not ok_b:
        raise AssertionError(f"causal streaming: {rec['causal']}")
    del model
    torch.cuda.empty_cache()
    return launches


CLI_ROUTE = {"AVEC_TPU_FUSED_FFN": "1", "AVEC_TPU_FUSED_ATT": "1",
             "AVEC_TPU_FUSED_CONV": "1", "AVEC_TPU_STEM": "pallas"}
CLI_CONFIGS = ("lrs23_av", "lrs23_ao", "lrs23_vo", "lrs23_lm_gpt_small",
               "lrs23_lm_gpt_small_demo", "librispeech_gpt_small", "lrw")


class _FitProbe:
    """Records, around the CLI's in-process runs, each `Trainer.fit`'s
    history and the kernel launches at the first evaluation of a fit (the
    launches of its train steps alone); the class is restored on exit."""

    def __init__(self):
        from avec_tpu_torch.train.model import Trainer

        self.cls, self.histories, self.at_eval = Trainer, [], None

    def __enter__(self):
        from avec_tpu_torch.ops import _cuda

        fit, evaluate, probe = self.cls.fit, self.cls._evaluate, self
        self._saved = fit, evaluate

        def fit_(trainer, *a, **k):
            probe.at_eval = None
            history = fit(trainer, *a, **k)
            probe.histories.append(history)
            return history

        def evaluate_(trainer, *a, **k):
            if probe.at_eval is None:
                torch.cuda.synchronize()
                probe.at_eval = dict(_cuda.launches)
            return evaluate(trainer, *a, **k)

        self.cls.fit, self.cls._evaluate = fit_, evaluate_
        return self

    def __exit__(self, *exc):
        self.cls.fit, self.cls._evaluate = self._saved


def cli_phase(detail, root) -> dict:
    """Phase 28: the experiment CLI (`avec_tpu_torch/main.py`) on the
    card, from a new directory under build/ (no datasets/ there at first,
    so the configs take their synthetic fallback). (a) `-m pass` for every
    port config: the flagship AV config in a subprocess of `python -m
    avec_tpu_torch.main`, the others in-process through
    `avec_tpu_torch.main.main(argv)`; each one's parameter count. (b)
    `lrs23_av` (61.7M params, B=16, 4 accumulated micro-batches, bf16)
    trained in-process with AVEC_TPU_FUSED_FFN / _ATT / _CONV = 1 and
    AVEC_TPU_STEM = pallas for the call (restored after it), `--epochs 1
    --steps_per_epoch 3 --eval_steps 1 --step_log_period 1`: each kernel's
    launches over the 3 steps (counts set to 0 just before the call, read
    at the fit's first evaluation) must equal the model's
    `kernel_launches_per_step` x 4 x 3; the losses finite; a checkpoint and
    a TensorBoard or JSON lines log under the callback path. (c) From that
    checkpoint: `--load_last -m evaluation`, `-m swa --swa_epochs 1 1`,
    `--load_last -m eval_time`, then `save_logits` on one batch. (d) A
    seeded LRS2 + LRS3 tree (`data/lrs_fixture.py`: 136 training and 2 x
    16 test utterances of 1-3 s, flac and wav, its 256-piece tokenizer and
    order-6 ARPA) and `lrs23_ao` trained from it for 2 steps, evaluated by
    the config's own decoder (beam 16 with the ARPA, native search): the
    WER is printed, with no bound. The tree also holds a `_mouth.mp4` clip
    of each utterance: (e) `lrs23_vo` trained from them for 2 steps (64
    clips a step) and evaluated by its decoder, the WER printed with no
    bound; a clip that does not decode raises. Returns (b)'s launches."""
    import pickle
    import shutil
    import tempfile

    from avec_tpu_torch import main as cli
    from avec_tpu_torch.cli import functions
    from avec_tpu_torch.data.lrs_fixture import write_lrs_fixture
    from avec_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    rec = {}
    cfg = lambda name: os.path.join(root, "avec_tpu_torch", "configs",  # noqa
                                    name + ".py")
    work = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(root, "build"))
    here = os.getcwd()
    saved_env = {k: os.environ.get(k) for k in CLI_ROUTE}
    try:
        os.chdir(work)
        # ---- (a) pass mode
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "avec_tpu_torch.main", "-c",
             cfg("lrs23_av"), "-m", "pass"], cwd=work, capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=root))
        if res.returncode != 0 or "Mode: pass" not in res.stdout:
            raise AssertionError(f"pass mode of lrs23_av: {res.stderr[-2000:]}")
        counts = {"lrs23_av": int(res.stdout.split("Number Parameters: ")[1]
                                  .split()[0].replace(",", ""))}
        for name in CLI_CONFIGS[1:]:
            args = cli.main(["-c", cfg(name), "-m", "pass"])
            counts[name] = args.setup.trainer.num_params()
            del args
            torch.cuda.empty_cache()
        rec["pass_params"] = counts
        rec["pass_s"] = time.perf_counter() - t0
        log("CLI -m pass on the card: parameters " + ", ".join(
            f"{k} {v:,}" for k, v in counts.items())
            + f" ({rec['pass_s']:.1f} s)")
        if counts["lrs23_av"] != 61738836:
            raise AssertionError(f"lrs23_av has {counts['lrs23_av']} params")

        # ---- (b) the flagship AV config trained through the CLI
        os.environ.update(CLI_ROUTE)
        steps = 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _FitProbe() as probe:
            _cuda.reset_launches()
            args = cli.main(["-c", cfg("lrs23_av"), "-m", "training",
                             "--epochs", "1", "--steps_per_epoch", str(steps),
                             "--eval_steps", "1", "--step_log_period", "1"])
            torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        trainer = args.setup.trainer
        accum = args.setup.accumulated_steps
        per_step = trainer.model.kernel_launches_per_step()
        launches = probe.at_eval or {}
        want = {k: v * accum * steps for k, v in per_step.items()}
        history = probe.histories[-1]
        losses = history[0]["losses"]
        eval_losses = history[0]["eval"][0][0]
        cb = args.callback_path
        ckpt = os.path.join(cb, f"checkpoints_epoch_1_step_{steps}.ckpt")
        logs = sorted(os.listdir(os.path.join(cb, "logs")))
        rec["train"] = {
            "launches_per_micro_batch": per_step, "accumulated_steps": accum,
            "steps": steps, "launches": launches, "losses": losses,
            "eval_losses": eval_losses, "logs": logs,
            "epoch_s": history[0]["seconds"], "call_s": train_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "checkpoint_mib": os.path.getsize(ckpt) / 2 ** 20}
        log(f"CLI training lrs23_av ({gpu_line()}): {steps} steps of {accum} "
            f"micro-batches of {args.setup.training_dataset.batch_size}; "
            f"launches over the steps {launches} (want "
            f"kernel_launches_per_step x {accum} x {steps} = {want}); "
            f"epoch losses " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in losses.items())
            + f"; eval loss {eval_losses['loss']:.4f}; training loop "
            f"{history[0]['seconds']:.1f} s, call {train_s:.1f} s, peak "
            f"{rec['train']['peak_gib']:.2f} GiB; logs {logs}, checkpoint "
            f"{rec['train']['checkpoint_mib']:.0f} MiB")
        finite = all(math.isfinite(v) for v in list(losses.values())
                     + list(eval_losses.values()))
        if not (launches == want and set(want) == {
                "fused_ffn_fwd", "fused_ffn_bwd", "fused_att_fwd",
                "fused_att_bwd", "fused_conv_stats", "fused_conv_fwd",
                "fused_conv_bwd1", "fused_conv_bwd2", "bn_relu_pool",
                *BN_KERNELS}
                and finite and logs and os.path.isfile(ckpt)):
            raise AssertionError(f"CLI training: {rec['train']}")
        del trainer, args
        torch.cuda.empty_cache()

        # ---- (c) the other modes from that checkpoint
        t0 = time.perf_counter()
        base = ["-c", cfg("lrs23_av"), "--eval_steps", "1"]
        args = cli.main(base + ["-m", "evaluation", "--load_last"])
        if args.setup.trainer.step != steps:
            raise AssertionError("evaluation did not load the checkpoint")
        del args
        args = cli.main(base + ["-m", "swa", "--swa_epochs", "1", "1",
                                "--steps_per_epoch", "1"])
        swa = os.path.join(cb, "checkpoints_swa-equal-1-1.ckpt")
        del args
        args = cli.main(base + ["-m", "eval_time", "--load_last"])
        trainer = args.setup.trainer
        loader = functions.load_datasets(args)[1][0]
        one = [next(iter(loader))]
        trainer.save_logits(one, cb)
        with open(os.path.join(cb, "logits.pkl"), "rb") as f:
            logits = pickle.load(f)
        out = logits[0]["outputs"][0]
        rec["modes"] = {"swa_written": os.path.isfile(swa),
                        "logits_shape": list(out.shape),
                        "logits_finite": bool(np.isfinite(out).all()),
                        "outputs": sorted(logits[0]),
                        "s": time.perf_counter() - t0}
        log(f"CLI --load_last evaluation, swa ({os.path.basename(swa)}), "
            f"eval_time from the step-{steps} checkpoint; save_logits on one "
            f"batch: outputs {rec['modes']['outputs']}, logits "
            f"{tuple(out.shape)} finite {rec['modes']['logits_finite']} "
            f"({rec['modes']['s']:.1f} s)")
        if not (rec["modes"]["swa_written"] and rec["modes"]["logits_finite"]
                and len(rec["modes"]["outputs"]) == 6):
            raise AssertionError(f"CLI modes: {rec['modes']}")
        del trainer, args, loader
        shutil.rmtree(cb, ignore_errors=True)
        torch.cuda.empty_cache()

        # ---- (d) the AO config from a generated LRS tree
        t0 = time.perf_counter()
        paths = write_lrs_fixture("datasets", seed=0, video=True)
        fixture_s = time.perf_counter() - t0
        with _FitProbe() as probe:
            args = cli.main(["-c", cfg("lrs23_ao"), "-m", "training",
                             "--epochs", "1", "--steps_per_epoch", "2",
                             "--eval_steps", "1", "--step_log_period", "1"])
        setup = args.setup
        decoder = setup.decoder
        history = probe.histories[-1]
        wers = [m.get("wer") for _, m in history[0]["eval"]]
        rec["ao_files"] = {
            "train_set": [type(d).__name__ for d in
                          setup.training_dataset.datasets],
            "train_utterances": len(setup.training_dataset),
            "decoder": type(decoder).__name__,
            "beam_size": getattr(decoder, "beam_size", None),
            "ngram": getattr(decoder, "lm", None) is not None,
            "losses": history[0]["losses"], "wer": wers,
            "fixture_s": fixture_s, "s": time.perf_counter() - t0, **paths}
        log(f"CLI training lrs23_ao from a generated LRS2 + LRS3 tree "
            f"({rec['ao_files']['train_utterances']} training utterances, "
            f"written in {fixture_s:.1f} s): 2 steps, epoch loss "
            f"{history[0]['losses']['loss']:.4f}; evaluated by "
            f"{rec['ao_files']['decoder']} (beam "
            f"{rec['ao_files']['beam_size']}, ARPA "
            f"{rec['ao_files']['ngram']}): WER LRS2 test {wers[0]:.2f}, "
            f"LRS3 test {wers[1]:.2f} (no bound: two steps from seeded "
            f"weights); {rec['ao_files']['s']:.1f} s")
        ok = (rec["ao_files"]["train_set"] == ["LRS", "LRS"]
              and rec["ao_files"]["decoder"] == "CTCBeamSearchDecoder"
              and rec["ao_files"]["beam_size"] == 16
              and rec["ao_files"]["ngram"]
              and all(math.isfinite(v) for v in
                      history[0]["losses"].values())
              and all(w is not None and math.isfinite(w) for w in wers))
        del setup, decoder, args
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"CLI AO from files: {rec['ao_files']}")

        # ---- (e) the VO config from the same tree's mp4 clips
        t0 = time.perf_counter()
        with _FitProbe() as probe:
            args = cli.main(["-c", cfg("lrs23_vo"), "-m", "training",
                             "--epochs", "1", "--steps_per_epoch", "2",
                             "--eval_steps", "1", "--step_log_period", "1"])
        setup = args.setup
        history = probe.histories[-1]
        sets = setup.training_dataset.datasets
        wers = [m.get("wer") for _, m in history[0]["eval"]]
        rec["vo_mp4"] = {
            "train_set": [type(d).__name__ for d in sets],
            "load_video": [d.load_video for d in sets],
            "clips_per_step": setup.training_dataset.batch_size
            * setup.accumulated_steps,
            "losses": history[0]["losses"], "wer": wers,
            "s": time.perf_counter() - t0}
        log(f"CLI training lrs23_vo from the tree's _mouth.mp4 clips "
            f"({gpu_line()}): 2 steps of "
            f"{rec['vo_mp4']['clips_per_step']} clips, epoch loss "
            f"{history[0]['losses']['loss']:.4f}; WER LRS2 test "
            f"{wers[0]:.2f}, LRS3 test {wers[1]:.2f} (no bound); "
            f"{rec['vo_mp4']['s']:.1f} s")
        ok = (rec["vo_mp4"]["train_set"] == ["LRS", "LRS"]
              and all(rec["vo_mp4"]["load_video"])
              and all(math.isfinite(v) for v in
                      history[0]["losses"].values())
              and all(w is not None and math.isfinite(w) for w in wers))
        del setup, args
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"CLI VO from mp4: {rec['vo_mp4']}")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 28 (the CLI) wall {rec['wall_s']:.1f} s")
    detail["cli"] = rec
    return rec["train"]["launches"]


def library_phase(detail, root) -> dict:
    """Phase 29: the rest of the library on the card. (a) The grouped-
    attention audio-only model at the LRS23 AO widths
    (`AudioEfficientConformerInterCTC(att_type="grouped", vocab_size=256,
    num_blocks=(5, 6, 5))`, seeded weights and BN statistics): served
    through `Server(mode="ao")` (no InterCTC, the server's AO default; 8
    requests of 2-6 s in the 8 s bucket, ROUNDS batches; its grouped
    attention runs no
    kernel, so no launch; fp32 kernels against plain versions as phase 3:
    logits 2e-3, identical greedy ids; the fp32 logits of two requests on
    the card against the CPU's, 2e-3, identical ids; the bf16 latency
    p50 / p95 and RTF); trained on the fused routes (fused FFN, attention
    and convolution modules switched on; the grouped attention takes no
    fused kernel) at B=16 / 6 s with the InterCTC blocks 3, 6, 10, 13:
    32 + 32 FFN and 14 of each conv pass per step from the module tree,
    the checks of phase 19, then the step's
    ms, utterances/s and peak GiB. (b) `rnnt_loss` and its gradient at
    B=8, T=151, U=32, V=256, fp32, against the CPU (loss 1e-4 relative,
    gradient 1e-4 of its largest entry), its ms and device launches per
    call (forward + backward); the functional `ctc_loss` (the JAX
    recursion) on the train step's outputs' shape (16, 76, 256) against
    `F.ctc_loss` on the card, per sample, 1e-4 relative. (c) ResNet50 with
    stem and head at 8 x 224 x 224 x 3, fp32, eval with seeded BN
    statistics: forward and backward on the card, logits against the
    CPU's within 1e-3 of their largest entry; a 2-layer bidirectional LSTM
    at (16, 151, 256) against the CPU, 1e-4; 3 `Trainer` steps of the
    grouped model with `SGD(momentum=0.9, nesterov=True)` under
    `ExpDecayScheduler`: finite losses, every parameter leaf moved but
    those of an exactly zero gradient (the detached biases of the convs
    that feed a BatchNorm, under 5% of the leaves). With --profile, one
    traced train step of (a). Returns {path: launch counts of (a)}."""
    import torch.nn.functional as F

    from avec_tpu_torch.models import zoo
    from avec_tpu_torch.models.resnet import ResNet
    from avec_tpu_torch.ops import conv_module as cm
    from avec_tpu_torch.ops.ctc import ctc_loss as ctc_recursion
    from avec_tpu_torch.ops.layers import LSTM, init_params
    from avec_tpu_torch.ops.rnnt import rnnt_loss
    from avec_tpu_torch.serve import Server, _batch_bucket, _bucket
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer
    from avec_tpu_torch.train.optim import SGD
    from avec_tpu_torch.train.schedulers import ExpDecayScheduler

    t_phase = time.perf_counter()
    card = gpu_line()
    log(f"phase 29 (the rest of the library) on {card}")
    rec, runs = {}, {}
    cfg = dict(vocab_size=256, att_type="grouped", num_blocks=(5, 6, 5))

    # ---- (a) the grouped AO model, served
    srv = Server(mode="ao", device="cuda", precision="bfloat16", seed=0,
                 **cfg)
    with torch.no_grad():
        zoo.randomize_batch_stats(srv.model, torch.Generator().manual_seed(1))
    reqs = [{"audio": r["audio"]}
            for r in make_requests(np.random.RandomState(29))]
    rec["serve"] = served_path(srv, reqs, {}, "grouped AO served")
    runs["grouped_serve"] = rec["serve"]["launches"]
    summary = srv.stats_summary()
    rec["serve"].update({k: summary[k] for k in (
        "latency_p50_s", "latency_p95_s", "rtf_mean")})
    log(f"grouped AO served (bf16, {card}): latency p50 "
        f"{summary['latency_p50_s'] * 1e3:.2f} ms")
    log(f"grouped AO served (bf16, {card}): latency p95 "
        f"{summary['latency_p95_s'] * 1e3:.2f} ms")
    log(f"grouped AO served (bf16, {card}): RTF {summary['rtf_mean']:.5f}")
    pair = reqs[:2]
    inputs = srv._inputs_for_batch(pair, _bucket(max(
        srv._request_samples(r) for r in pair)), _batch_bucket(len(pair)))
    logits_gpu, len_gpu = srv.forward(inputs, torch.float32)
    cpu_model = zoo.AudioEfficientConformerInterCTC(
        device="cpu", interctc_blocks=(), **cfg)
    cpu_model.load_state_dict(srv.model.state_dict())
    with torch.no_grad():
        out = cpu_model(*(torch.as_tensor(a) for a in inputs))["outputs"]
    diff = max_abs(logits_gpu.cpu(), out[0])
    ids_gpu = srv.decoder(srv.decoder.device_fn((logits_gpu, len_gpu)))
    ids_cpu = srv.decoder(srv.decoder.device_fn(tuple(out)))
    rec["serve"]["card_vs_cpu_fp32_logits_max_abs"] = diff
    log(f"grouped AO fp32 logits of 2 requests, card vs CPU: max abs "
        f"{diff:.3e} (tol 2e-3), greedy ids equal: {ids_gpu == ids_cpu}")
    if not (diff <= 2e-3 and ids_gpu == ids_cpu):
        raise AssertionError("grouped AO: the card disagrees with the CPU")
    del srv, cpu_model
    torch.cuda.empty_cache()

    # ---- (a) the grouped AO model, trained on the fused routes
    batch = make_train_batch(np.random.RandomState(0))
    ao_batch = {"inputs": batch["inputs"][2:], "targets": batch["targets"]}
    model = zoo.AudioEfficientConformerInterCTC(
        device="cuda", fused_ffn=True, fused_att=True, fused_conv=True, **cfg)
    trainer = Trainer(model=model, device="cuda", precision="bfloat16",
                      loss=CTCLoss(zero_infinity=True), loss_weights=1.0)
    per_step = {"fused_ffn_fwd": 32, "fused_ffn_bwd": 32,
                **{name: 14 for name in cm.KERNELS}, **bn_launches(3)}
    rec["train"], runs["grouped_train"] = trained_path(
        trainer, ao_batch, per_step,
        "grouped AO train (fused FFN and conv; B=16, 6 s)", 8)
    trainer.train_step(ao_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: trainer.train_step(ao_batch), iters=5,
                      warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["train"].update({"step_ms": ms, "utterances_per_s": 16e3 / ms,
                         "peak_gib": peak})
    log(f"grouped AO train step (bf16, B=16, 6 s, {card}): {ms:.2f} ms")
    log(f"grouped AO train (bf16, {card}): {16e3 / ms:.2f} utterances/s")
    log(f"grouped AO train (bf16, {card}): peak {peak:.2f} GiB")
    if "--profile" in sys.argv[1:]:
        rec["profile"] = profile_train_step(trainer, ao_batch)

    # ---- (c) SGD with Nesterov momentum under the exponential decay
    sched = ExpDecayScheduler(warmup_steps=2, val_max=1e-3, alpha=0.1,
                              end_step=1000)
    sgd = Trainer(model=model, device="cuda", precision="bfloat16",
                  loss=CTCLoss(zero_infinity=True), loss_weights=1.0,
                  optimizer=SGD(lr=sched, momentum=0.9, nesterov=True))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    sgd_losses = []
    for _ in range(3):
        losses, infos = sgd.train_step(ao_batch)
        sgd_losses.append((float(losses["loss"]), infos["lr"]))
    # SGD without weight decay leaves a leaf whose gradient is exactly
    # zero (the detached biases of the convs that feed a BatchNorm) where
    # it was; every other leaf must move
    still = {n for n, p in model.named_parameters()
             if torch.equal(p, before[n])}
    zero = {n for n, p in model.named_parameters() if not p.grad.any()}
    rec["sgd"] = {"losses_lr": sgd_losses, "unmoved": sorted(still),
                  "zero_gradient": sorted(zero), "leaves": len(before)}
    log(f"grouped AO, SGD(momentum 0.9, Nesterov) under ExpDecay: (loss, "
        f"lr) {sgd_losses}; leaves moved {len(before) - len(still)}/"
        f"{len(before)}; the {len(still)} unmoved ones are those of an "
        f"exactly zero gradient: {still == zero}")
    if not (all(math.isfinite(v) for v, _ in sgd_losses) and still == zero
            and len(zero) < 0.05 * len(before)):
        raise AssertionError(f"SGD steps: {rec['sgd']}")
    del trainer, sgd, model, before
    torch.cuda.empty_cache()

    # ---- (b) the RNN-T loss and the CTC recursion
    gen = torch.Generator().manual_seed(29)
    b, t_len, u, v = 8, 151, 32, 256
    logits = torch.randn(b, t_len, u + 1, v, generator=gen)
    t_lens = torch.tensor([151, 140, 120, 101, 90, 77, 60, 45])
    labels = torch.randint(1, v, (b, u), generator=gen)
    u_lens = torch.tensor([32, 30, 27, 25, 20, 16, 9, 1])

    def rnnt_call(x):
        x = x.detach().requires_grad_(True)
        loss = rnnt_loss(x, t_lens.to(x.device), labels.to(x.device),
                         u_lens.to(x.device))
        loss.backward()
        return loss.detach(), x.grad

    dev_logits = logits.cuda()
    loss_g, grad_g = rnnt_call(dev_logits)
    loss_c, grad_c = rnnt_call(logits)
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_rel = max_abs(grad_g.cpu(), grad_c) / float(grad_c.abs().max())
    r_ms = cuda_time_ms(lambda: rnnt_call(dev_logits), iters=3, warmup=1)
    rows, _ = traced_device_rows(lambda: rnnt_call(dev_logits))
    r_launches = sum(c for _, c, _ in rows)
    r_dev = sum(us for us, _, _ in rows) / 1e3
    rec["rnnt"] = {"loss_rel": loss_rel, "grad_rel": grad_rel, "ms": r_ms,
                   "device_ms": r_dev, "launches_per_call": r_launches}
    log(f"rnnt_loss B={b} T={t_len} U={u} V={v} fp32, card vs CPU: loss "
        f"rel {loss_rel:.2e} (tol 1e-4), gradient {grad_rel:.2e} of its "
        f"largest entry (tol 1e-4)")
    log(f"rnnt_loss forward + backward ({card}): {r_ms:.2f} ms per call")
    log(f"rnnt_loss forward + backward ({card}): {r_launches} device "
        f"launches per call, {r_dev:.2f} ms of device time")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-4):
        raise AssertionError(f"rnnt_loss on the card: {rec['rnnt']}")
    del dev_logits, grad_g, grad_c

    c_logits = torch.randn(16, 76, 256, generator=gen).cuda()
    c_lens = torch.tensor([76, 70, 66, 61, 58, 55, 52, 50, 47, 46, 44, 43,
                           41, 40, 39, 38], device="cuda")
    c_labels = torch.randint(1, 256, (16, 32), generator=gen).cuda()
    c_ulens = torch.full((16,), 32, device="cuda")
    got = ctc_recursion(c_logits, c_lens, c_labels, c_ulens, reduction="none")
    want = F.ctc_loss(torch.log_softmax(c_logits, -1).transpose(0, 1),
                      c_labels.long(), c_lens.long(), c_ulens.long(),
                      reduction="none")
    c_rel = float(((got - want).abs() / want.abs()).max())
    c_ms = cuda_time_ms(lambda: ctc_recursion(c_logits, c_lens, c_labels,
                                              c_ulens), iters=3, warmup=1)
    rec["ctc"] = {"max_rel": c_rel, "ms": c_ms}
    log(f"ctc_loss (the JAX recursion) at (16, 76, 256), 32 labels, card: "
        f"per-sample NLL vs F.ctc_loss max rel {c_rel:.2e} (tol 1e-4)")
    log(f"ctc_loss (the JAX recursion) forward ({card}): {c_ms:.2f} ms")
    if not c_rel <= 1e-4:
        raise AssertionError(f"ctc_loss on the card: {rec['ctc']}")

    # ---- (c) ResNet50 with stem and head; the LSTM
    resnet = ResNet("ResNet50", dim_output=1000)
    init_params(resnet, torch.Generator().manual_seed(50))
    with torch.no_grad():
        zoo.randomize_batch_stats(resnet, torch.Generator().manual_seed(51))
    resnet.eval()
    img = torch.rand(8, 3, 224, 224, generator=gen)
    want = resnet(img)
    want.square().mean().backward()
    want = want.detach()
    g_cpu = torch.sqrt(sum(p.grad.double().square().sum()
                           for p in resnet.parameters()))
    resnet.zero_grad(set_to_none=True)
    resnet.cuda()
    got = resnet(img.cuda())
    got.square().mean().backward()
    g_gpu = torch.sqrt(sum(p.grad.double().square().sum()
                           for p in resnet.parameters()))
    rn_rel = max_abs(got.detach().cpu(), want) / float(want.abs().max())
    g_rel = abs(float(g_gpu) - float(g_cpu)) / float(g_cpu)
    rn_ms = cuda_time_ms(lambda: resnet(img.cuda()).square().mean()
                         .backward(), iters=3, warmup=1)
    rec["resnet50"] = {"logits_rel": rn_rel, "grad_norm_rel": g_rel,
                       "fwd_bwd_ms": rn_ms}
    log(f"ResNet50 (stem and head) 8 x 224 x 224 x 3 fp32, card vs CPU: "
        f"logits {rn_rel:.2e} of their largest entry (tol 1e-3); gradient "
        f"norm rel {g_rel:.2e}")
    log(f"ResNet50 forward + backward ({card}): {rn_ms:.2f} ms")
    if not rn_rel <= 1e-3:
        raise AssertionError(f"ResNet50 on the card: {rec['resnet50']}")
    del resnet

    lstm = LSTM(256, 256, num_layers=2, bidirectional=True)
    init_params(lstm, torch.Generator().manual_seed(52))
    seq = torch.randn(16, 151, 256, generator=gen)
    with torch.no_grad():
        want = lstm(seq)
        lstm.cuda()
        got = lstm(seq.cuda())
    l_err = max_abs(got.cpu(), want)
    l_ms = cuda_time_ms(lambda: lstm(seq.cuda()), iters=3, warmup=1)
    rec["lstm"] = {"max_abs": l_err, "ms": l_ms}
    log(f"LSTM 2 layers bidirectional at (16, 151, 256), card vs CPU: max "
        f"abs {l_err:.2e} (tol 1e-4)")
    log(f"LSTM forward ({card}): {l_ms:.2f} ms")
    if not l_err <= 1e-4:
        raise AssertionError(f"LSTM on the card: {rec['lstm']}")
    del lstm
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 29: {rec['seconds']:.1f} s")
    detail["library"] = rec
    return runs


# ---- 30. distributed, the rest
DIST_ZOO = {              # phase 30 (a): the full-width models, stem "2d"
    "ao": ("AudioEfficientConformerInterCTC",
           dict(vocab_size=256, att_type="patch", interctc_blocks=(),
                num_blocks=(5, 6, 5))),                   # configs/LRS23/AO
    "ao_causal": ("AudioEfficientConformerInterCTC",
                  dict(vocab_size=256, att_type="patch", interctc_blocks=(),
                       num_blocks=(5, 6, 5), causal=True, left_context=64)),
    "vo": ("VisualEfficientConformerInterCTC",
           dict(vocab_size=256, interctc_blocks=(3, 6, 9), num_blocks=(6, 6),
                stem_mode="2d")),                         # configs/LRS23/VO
    "lrw": ("VisualEfficientConformerCE",
            dict(vocab_size=500, num_blocks=(6, 6), stem_mode="2d")),
}
DIST_ROUTE = dict(fused_ffn=True, fused_att=True, fused_conv=True)
DIST_STEPS = 2                     # counted steps after one warm-up
GPT_TP = 2                         # phase 30 (c): the model axis
GPT_TP_STEPS = 3
GPT_TOKENS = (8, 128)
GPT_TP_LR = 1e-4                   # constant: a parameter moves ~1e-4 a step


def dist_zoo_batch(kind):
    """The global batch of a DIST_ZOO model: phase 16's 16 utterances (audio
    for the AO models, video for VO), 32 LRW clips of 29 frames."""
    if kind == "lrw":
        rng = np.random.RandomState(30)
        return {"inputs": rng.rand(32, 29, 88, 88, 1).astype(np.float32),
                "targets": rng.randint(0, 500, size=32).astype(np.int32)}
    av = make_train_batch(np.random.RandomState(0))
    inputs = av["inputs"][2:] if kind.startswith("ao") else av["inputs"][:2]
    return {"inputs": inputs, "targets": av["targets"]}


def dist_zoo_trainer(kind, precision, data_parallel):
    """A DIST_ZOO model (seeded weights) on the fused routes and its trainer:
    CTC (zero_infinity) for the CTC models, the LRW classifier's
    cross-entropy."""
    from avec_tpu_torch.models import zoo
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    name, cfg = DIST_ZOO[kind]
    model = getattr(zoo, name)(device="cuda", **cfg, **DIST_ROUTE)
    return Trainer(model=model, device="cuda", precision=precision,
                   loss=None if kind == "lrw" else CTCLoss(zero_infinity=True),
                   loss_weights=None if kind == "lrw" else 1.0,
                   data_parallel=data_parallel)


def ragged_parts(rng, per_rank: int = 8):
    """Phase 30 (b): phase 16's utterances (`make_train_batch`: 3-6 s, the
    first 6 s, zeros past each length), the second rank's cut to half
    their length, with labels of 17-32 tokens on the first rank and 8-16 on
    the second; each rank's 8 collated apart: audio cut to the rank's
    longest, labels padded with 0 to the rank's longest. Returns (the two
    ranks' parts, the one-process global batch, padded to the longest of
    all)."""
    av = make_train_batch(np.random.RandomState(0), batch=2 * per_rank)
    audio, alen = av["inputs"][2].copy(), av["inputs"][3].copy()
    alen[per_rank:] //= 2
    for i in range(per_rank, 2 * per_rank):
        audio[i, alen[i]:] = 0.0
    ulen = np.concatenate([rng.randint(17, 33, size=per_rank),
                           rng.randint(8, 17, size=per_rank)]).astype(np.int32)
    labels = np.zeros((len(alen), int(ulen.max())), np.int32)
    for i, u in enumerate(ulen):
        labels[i, :u] = rng.randint(1, 256, size=int(u))

    def collate(idx):
        return {"inputs": [audio[idx, :int(alen[idx].max())], alen[idx]],
                "targets": (labels[idx, :int(ulen[idx].max())], ulen[idx])}

    parts = [collate(np.arange(r * per_rank, (r + 1) * per_rank))
             for r in range(2)]
    return parts, {"inputs": [audio, alen], "targets": (labels, ulen)}


def _fp32_step(trainer, batch):
    """One fp32 forward + backward, dropout and SpecAugment off: (total
    loss, gradients by name, BN running statistics by name), on the CPU."""
    trainer.model.set_regularization(False)
    losses, grads = trainer.loss_and_grads(batch)
    return (float(losses["loss"]), {n: g.cpu() for n, g in grads.items()},
            {n: b.detach().cpu() for n, b in trainer.model.named_buffers()
             if "running_" in n})


def gpt_tp_batch():
    """8 seeded sequences of 128 GPT-Small tokens (ids 1-1024), the targets
    the next token with -1 at the end."""
    rng = np.random.RandomState(31)
    ids = rng.randint(1, GPT_SMALL["vocab_size"], size=GPT_TOKENS
                      ).astype(np.int64)
    targets = np.concatenate([ids[:, 1:], np.full((ids.shape[0], 1), -1)],
                             axis=1)
    return {"inputs": [ids], "targets": targets}


def gpt_tp_trainer(model_parallel):
    """GPT-Small at full width (seeded weights, dropout off), fp32, the
    cross-entropy with ignore_index -1 and the GPT's AdamW (betas (0.9,
    0.95), eps 1e-8, decay 0.1 on the Linear weights) at a constant lr of
    GPT_TP_LR, so that the steps move every parameter (the recipe's warmup
    would move them by about 1e-6); sharded by `gpt_tensor_parallel_rules()`
    over `model_parallel` ranks."""
    from avec_tpu_torch.models.zoo import GPT
    from avec_tpu_torch.parallel.dist import gpt_tensor_parallel_rules
    from avec_tpu_torch.train.losses import SoftmaxCrossEntropy
    from avec_tpu_torch.train.model import Trainer
    from avec_tpu_torch.train.optim import AdamW, gpt_decay_mask

    model = GPT(**GPT_SMALL, drop_rate=0.0, device="cuda",
                generator=torch.Generator().manual_seed(0))
    return Trainer(model=model, device="cuda", precision="float32",
                   loss=SoftmaxCrossEntropy(ignore_index=-1), metrics=None,
                   optimizer=AdamW(GPT_TP_LR, betas=(0.9, 0.95), eps=1e-8,
                                   weight_decay=0.1,
                                   decay_mask=gpt_decay_mask),
                   model_parallel=model_parallel,
                   param_sharding_rules=(gpt_tensor_parallel_rules()
                                         if model_parallel > 1 else None))


def distributed_rank(device, parts):
    """Phase 30 on one of the two gloo ranks sharing the card. (a) For each
    DIST_ZOO model: the data-parallel trainer (bf16) on this rank's half of
    the global batch, 1 warm-up + DIST_STEPS counted steps (launches per
    step from the module tree), a digest of the parameters, then one fp32
    step with dropout and SpecAugment off (rank 0 keeps the global
    gradients and BN statistics). (b) The AO model's fp32 data-parallel
    step on this rank's own collated part, assembled by
    `host_local_batch_to_global`. (c) GPT-Small sharded over the two ranks
    (model_parallel 2): shard shapes, GPT_TP_STEPS AdamW steps on the whole
    batch with their ms and the peak GiB; rank 0 gathers the parameters,
    then runs the one-process GPT on the same weights and batch and keeps,
    for each parameter, the largest difference, its largest entry and how
    far the one-process steps moved it."""
    import torch.distributed as dist

    from avec_tpu_torch.parallel import dist as pdist
    from avec_tpu_torch.parallel import tensor_parallel as tp

    rank, world = _dp_rank_setup()
    out = {"rank": rank, "zoo": {}}
    for kind in DIST_ZOO:
        t0 = time.perf_counter()
        batch = pdist.shard_batch(dist_zoo_batch(kind))
        trainer = dist_zoo_trainer(kind, "bfloat16", True)
        per_step = trainer.model.kernel_launches_per_step()
        history, launches = counted_train_steps(
            trainer, batch, per_step, verbose=rank == 0,
            n_values=7 if kind == "vo" else 3, steps=DIST_STEPS)
        digest = _digest(trainer.model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_time_ms(lambda: trainer.train_step(batch), iters=2,
                               warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer
        torch.cuda.empty_cache()
        fp32 = _fp32_step(dist_zoo_trainer(kind, "float32", True), batch)
        torch.cuda.empty_cache()
        out["zoo"][kind] = {
            "launches_per_step": per_step, "launches": launches,
            "history": history, "params_digest": digest,
            "step_ms": step_ms, "peak_gib": peak, "fp32_loss": fp32[0],
            "grads_digest": _digest(fp32[1].values()),
            "fp32": fp32 if rank == 0 else None,
            "s": time.perf_counter() - t0}

    # (b) ragged parts assembled into one global batch
    trainer = dist_zoo_trainer("ao", "float32", True)
    batch = pdist.host_local_batch_to_global(parts[rank], trainer.mesh)
    fp32 = _fp32_step(trainer, batch)
    out["ragged"] = {"own_shape": list(parts[rank]["inputs"][0].shape),
                     "own_label_shape": list(parts[rank]["targets"][0].shape),
                     "assembled_shape": list(batch["inputs"][0].shape),
                     "label_shape": list(batch["targets"][0].shape),
                     "fp32_loss": fp32[0], "fp32": fp32 if rank == 0 else None}
    del trainer
    torch.cuda.empty_cache()

    # (c) GPT-Small, tensor-parallel over the two ranks
    gbatch = gpt_tp_batch()
    trainer = gpt_tp_trainer(GPT_TP)
    params = dict(trainer.model.named_parameters())
    shards = {n: [list(p.shape), list(p.tp_shape)]
              for n, p in params.items() if tp.tp_dim(p) is not None}
    replicated = [n for n, p in params.items() if tp.tp_dim(p) is None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for _ in range(GPT_TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, infos = trainer.train_step(gbatch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(got["loss"]))
        norms.append(float(infos["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    whole = tp.gather_state({n: p.detach() for n, p in params.items()},
                            tp.sharded_names(trainer.model),
                            trainer.mesh.model)
    numel = sum(p.numel() for p in params.values())
    out["gpt"] = {"shards": shards, "replicated": replicated,
                  "numel_per_rank": numel, "losses": losses,
                  "grad_norms": norms, "step_ms": ms, "peak_gib": peak}
    del trainer
    torch.cuda.empty_cache()
    if rank == 0:
        def one_process(batch):
            ref = gpt_tp_trainer(1)
            ls, ns = [], []
            for _ in range(GPT_TP_STEPS):
                got, infos = ref.train_step(batch)
                ls.append(float(got["loss"]))
                ns.append(float(infos["grad_norm"]))
            return {n: p.detach() for n, p in ref.model.named_parameters()
                    }, ls, ns

        init = {n: p.detach().clone() for n, p in
                gpt_tp_trainer(1).model.named_parameters()}
        ref, ref_losses, ref_norms = one_process(gbatch)
        rows = {"inputs": [gbatch["inputs"][0][::-1].copy()],
                "targets": gbatch["targets"][::-1].copy()}
        floor, _, _ = one_process(rows)
        diffs = {}
        for n, w in ref.items():
            step = w - init[n]
            norm = float(step.norm())
            diffs[n] = {"max": float((whole[n] - w).abs().max()),
                        "largest": float(w.abs().max()),
                        "moved": float(step.abs().max()),
                        "rel": float((whole[n] - w).norm()) / norm,
                        "floor_max": float((floor[n] - w).abs().max()),
                        "floor_rel": float((floor[n] - w).norm()) / norm}
        out["gpt"].update({"ref_losses": ref_losses, "ref_grad_norms":
                           ref_norms, "param_diffs": diffs,
                           "ref_numel": sum(p.numel() for p in ref.values())})
        del ref, floor
    return out


def distributed_phase(detail, root) -> dict:
    """Phase 30: distributed, the rest. (a) The LRS23 AO, causal AO, VO and
    LRW models at full width on the fused routes with stem "2d", data
    parallel over two gloo ranks sharing the card (`dist.spawn`), B=16 (LRW
    32 clips) split 8 + 8: launches per step and rank equal to
    `kernel_launches_per_step` (K1 / K1b, K2 / K2b, K3dp), parameters
    bit-identical across the ranks after the steps, and an fp32 step with
    dropout and SpecAugment off against the one-process step on the same
    utterances (loss 1e-5, gradient norm 1e-3, every leaf 2e-3, the video
    front end 0.15, BN statistics 1e-5). (b) Phase 16's 16 utterances,
    the second rank's at half length and with shorter labels
    (`ragged_parts`), each rank's 8 collated apart (padded to different
    lengths and label widths), assembled by `host_local_batch_to_global`:
    the AO model's fp32 step against the one-process step on the global
    batch, the same tolerances but for the BN statistics, held within 1e-5
    of the larger of 1 and their buffer's largest entry (the stem's
    running variance is about 36.6, where 1e-5 absolute is 3 ulps); the
    one-process step on the same batch with its halves swapped is printed
    beside as the fp32 reorder floor (held to the same bounds). (c)
    GPT-Small (d 768, 12 blocks, 12 heads, vocab 1025) at model_parallel 2
    on the two ranks: FFN-in (1536, 768) a rank, the head replicated (1025
    is odd), 3 AdamW steps at lr GPT_TP_LR at 8 x 128 tokens, fp32, dropout
    off; against the one-process run on the same weights: the losses
    within 2e-5 relative, the gradient norms of every step within 1e-5
    relative, every parameter moved by the one-process steps by more than
    1e-5 of the parameters' largest entry, and each gathered parameter's
    difference from the one-process parameter within 1e-2 of the
    one-process update of that parameter, in norm (the attention key
    biases, whose gradient is analytically zero and whose Adam steps follow
    rounding noise, are held within 2 x 3 x lr of where they started
    instead). The largest entrywise difference is printed beside the fp32
    reorder floor (the one-process run on the batch's rows reversed): Adam
    steps an entry whose gradient is at the rounding noise by up to lr
    either way, so no entrywise bound below that holds at an lr the bound
    can see. Step ms and peak GiB per rank. Returns {model: launches of
    its counted steps} of (a)."""
    from avec_tpu_torch.parallel.dist import spawn

    t_phase = time.perf_counter()
    card = gpu_line()
    rec = {"card": card}
    parts, whole = ragged_parts(np.random.RandomState(32))
    # the one-process fp32 references, on the card before the ranks start
    want = {}
    for kind in DIST_ZOO:
        want[kind] = _fp32_step(dist_zoo_trainer(kind, "float32", False),
                                dist_zoo_batch(kind))
        torch.cuda.empty_cache()
    want_ragged = _fp32_step(dist_zoo_trainer("ao", "float32", False), whole)
    torch.cuda.empty_cache()
    ragged_floor = check_agreement(
        "phase 30 ragged: fp32 reorder floor (one process, the global batch's "
        "halves swapped)", _fp32_step(dist_zoo_trainer("ao", "float32", False),
                                      reorder(whole)), want_ragged,
        loss_tol=1e-5, front_end_tol=0.15, front_end="encoder.front_end.",
        bn_scaled=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(distributed_rank, 2, "gloo", "cuda:0", parts, timeout=900)
    rec["ranks_s"] = time.perf_counter() - t0

    launches = {}
    for kind in DIST_ZOO:
        got = [r["zoo"][kind] for r in ranks]
        per_step = got[0]["launches_per_step"]
        want_launch = {k: v * DIST_STEPS for k, v in per_step.items()}
        same = len({g["params_digest"] for g in got}) == 1
        agree_ranks = (len({g["grads_digest"] for g in got}) == 1
                       and len({g["fp32_loss"] for g in got}) == 1)
        front = "encoder.front_end."
        agree = check_agreement(
            f"phase 30 {kind}: fp32 data-parallel step (2 ranks) vs one "
            f"process", got[0]["fp32"], want[kind], loss_tol=1e-5,
            front_end_tol=0.15, front_end=front)
        log(f"phase 30 {kind} ({card}): launches per step and rank "
            f"{per_step}; over {DIST_STEPS} steps "
            + json.dumps([g["launches"] for g in got])
            + f"; parameters bit-identical across ranks: {same}; step ms "
            f"per rank {[round(g['step_ms'], 2) for g in got]}, peak GiB "
            f"{[round(g['peak_gib'], 2) for g in got]} (two ranks "
            f"time-sliced on one card over gloo); {got[0]['s']:.1f} s on "
            f"rank 0")
        if not (same and agree_ranks and all(
                g["launches"] == want_launch for g in got)
                and {"fused_ffn_fwd", "fused_ffn_bwd", "fused_conv_dp_stats",
                     "fused_conv_dp_fwd", "fused_conv_dp_bwd1",
                     "fused_conv_dp_bwd2"} <= set(per_step)):
            raise AssertionError(f"phase 30 {kind}: launches {per_step} "
                                 f"{[g['launches'] for g in got]}, params "
                                 f"same {same}, ranks agree {agree_ranks}")
        launches[kind] = got[0]["launches"]
        rec[kind] = {"launches_per_step": per_step,
                     "launches_per_rank": [g["launches"] for g in got],
                     "steps": got[0]["history"], "params_identical": same,
                     "step_ms_per_rank": [g["step_ms"] for g in got],
                     "peak_gib_per_rank": [g["peak_gib"] for g in got],
                     "s_rank0": got[0]["s"], **agree}

    # (b)
    rg = [r["ragged"] for r in ranks]
    log(f"phase 30 ragged: rank batches {[g['own_shape'] for g in rg]} "
        f"(labels {[g['own_label_shape'] for g in rg]}) assembled to "
        f"{[g['assembled_shape'] for g in rg]} (labels "
        f"{[g['label_shape'] for g in rg]}); one process "
        f"{list(whole['inputs'][0].shape)}")
    shapes_ok = (rg[0]["own_shape"] != rg[1]["own_shape"]
                 and rg[0]["own_label_shape"] != rg[1]["own_label_shape"]
                 and all(
        g["assembled_shape"] == [g["own_shape"][0],
                                 whole["inputs"][0].shape[1]]
        and g["label_shape"] == [g["own_shape"][0],
                                 whole["targets"][0].shape[1]]
        for g in rg) and rg[0]["fp32_loss"] == rg[1]["fp32_loss"])
    agree = check_agreement(
        "phase 30 ragged: fp32 data-parallel step on assembled batches vs "
        "one process on the global batch", rg[0]["fp32"], want_ragged,
        loss_tol=1e-5, front_end_tol=0.15, front_end="encoder.front_end.",
        bn_scaled=True)
    if not shapes_ok:
        raise AssertionError("phase 30 ragged shapes: " + json.dumps(
            [{k: v for k, v in g.items() if k != "fp32"} for g in rg]))
    rec["ragged"] = {"own_shapes": [g["own_shape"] for g in rg],
                     "own_label_shapes": [g["own_label_shape"] for g in rg],
                     "assembled_shape": rg[0]["assembled_shape"], **agree,
                     "reorder_floor": ragged_floor}

    # (c)
    g0, g1 = ranks[0]["gpt"], ranks[1]["gpt"]
    ffn_in = "transformer.blocks.0.ff_module.layers.1.weight"
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(g0["losses"], g0["ref_losses"]))
    norm_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(g0["grad_norms"], g0["ref_grad_norms"]))
    diffs = g0["param_diffs"]
    largest = max(v["largest"] for v in diffs.values())
    bound = 1e-5 * largest
    key_bias = {n: v for n, v in diffs.items()
                if n.endswith("key_layer.bias")}
    compared = {n: v for n, v in diffs.items() if n not in key_bias}

    def worst_of(key):
        return max((v[key], n) for n, v in compared.items())

    worst, worst_rel = worst_of("max"), worst_of("rel")
    floor, floor_rel = worst_of("floor_max"), worst_of("floor_rel")
    least_moved = min((v["moved"], n) for n, v in compared.items())
    key_moved = max(v["moved"] + v["max"] for v in key_bias.values())
    key_limit = 2 * GPT_TP_STEPS * GPT_TP_LR
    log(f"phase 30 GPT-Small tensor-parallel (model_parallel {GPT_TP}, "
        f"{card}): {ffn_in} shard {g0['shards'][ffn_in][0]} of "
        f"{g0['shards'][ffn_in][1]}; head replicated: "
        f"{'head.weight' in g0['replicated']}; {len(g0['shards'])} sharded "
        f"parameters; parameters a rank {g0['numel_per_rank'] / 1e6:.2f}M of "
        f"{g0['ref_numel'] / 1e6:.2f}M")
    log(f"  losses {g0['losses']} vs one process {g0['ref_losses']} (max "
        f"rel {loss_rel:.2e}, tol 2e-5); grad norms {g0['grad_norms']} vs "
        f"{g0['ref_grad_norms']} (max rel {norm_rel:.2e}, tol 1e-5)")
    log(f"  gathered parameters after {GPT_TP_STEPS} steps at lr "
        f"{GPT_TP_LR}: difference / one-process update, in norm, worst "
        f"{worst_rel[0]:.2e} ({worst_rel[1]}; tol 1e-2; reorder floor "
        f"{floor_rel[0]:.2e}, {floor_rel[1]}); largest entrywise difference "
        f"{worst[0]:.2e} ({worst[1]}), {worst[0] / largest:.2e} of the "
        f"largest entry {largest:.3f} (reorder floor {floor[0]:.2e}, "
        f"{floor[1]}); the least moved parameter moved {least_moved[0]:.2e} "
        f"({least_moved[1]}; must pass {bound:.2e}); {len(key_bias)} key "
        f"biases within {key_moved:.2e} of their start (tol {key_limit:.0e})")
    log(f"  step ms per rank {[round(x, 2) for x in g0['step_ms']]}, "
        f"{[round(x, 2) for x in g1['step_ms']]} (two ranks time-sliced on "
        f"one card over gloo); peak {g0['peak_gib']:.2f} / "
        f"{g1['peak_gib']:.2f} GiB ({card})")
    from avec_tpu_torch.models.transformer import GPT_CONFIGS

    d = GPT_CONFIGS[GPT_SMALL["model"]]["dim_model"]   # 768: FFN-in 1536
    gpt_ok = (g0["shards"][ffn_in] == [[4 * d // GPT_TP, d], [4 * d, d]]
              and "head.weight" in g0["replicated"]
              and "head.bias" in g0["replicated"]
              and g0["losses"] == g1["losses"] and loss_rel <= 2e-5
              and norm_rel <= 1e-5 and worst_rel[0] <= 1e-2
              and least_moved[0] > bound and key_moved <= key_limit)
    rec["gpt"] = {**{k: v for k, v in g0.items() if k != "param_diffs"},
                  "rank1_step_ms": g1["step_ms"],
                  "rank1_peak_gib": g1["peak_gib"], "loss_rel": loss_rel,
                  "grad_norm_rel": norm_rel, "worst_leaf": worst,
                  "worst_leaf_update_rel": worst_rel,
                  "reorder_floor_leaf": floor,
                  "reorder_floor_update_rel": floor_rel,
                  "largest_entry": largest, "least_moved": least_moved,
                  "key_bias_moved": key_moved}
    if not gpt_ok:
        raise AssertionError("phase 30 GPT tensor parallel: " + json.dumps(
            {k: rec["gpt"][k] for k in (
                "losses", "ref_losses", "grad_norms", "ref_grad_norms",
                "worst_leaf", "worst_leaf_update_rel", "reorder_floor_leaf",
                "reorder_floor_update_rel", "largest_entry", "least_moved",
                "key_bias_moved", "replicated")}))
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 30 (distributed) wall {rec['wall_s']:.1f} s ({card})")
    detail["distributed"] = rec
    return launches


# ---- 31. remat and the library's variants
REMAT_ROUTES = {          # phase 31 (a): the flagship AV model's two routes
    "fused_conv": dict(use_flash=False, stem_mode="pallas", fused_att=True,
                       fused_conv=True, fused_ffn=True),
    "flash": dict(use_flash=True, stem_mode="2d", fused_ffn=True)}
REMAT_STEPS = 2                    # counted steps after one warm-up
REMAT_GRAD_TOL = 3e-2              # phase 5's bf16 gradient bound
REMAT_FRONT_END_TOL = 0.15         # the video front end's (phase 30)


def remat_extra_forwards(model) -> dict:
    """{kernel: launches} that the recompute adds to a step: the fused
    forward kernels of the modules inside the blocks each stack
    rematerializes (`ConformerInterCTC.remat_blocks`, the JAX plan's runs of
    more than one block), and the BatchNorm statistics and apply kernels of
    each BatchNorm there that no fused convolution module holds."""
    from avec_tpu_torch.models.conformer import ConformerInterCTC
    from avec_tpu_torch.ops import attention_module, conv_module, ffn
    from avec_tpu_torch.ops import flash_attention
    from avec_tpu_torch.ops.batch_norm import KERNEL_APPLY, KERNEL_STATS
    from avec_tpu_torch.ops.layers import BatchNorm

    extra = {}

    def add(name, n):
        if n:
            extra[name] = extra.get(name, 0) + n

    for stack in model.modules():
        if not (isinstance(stack, ConformerInterCTC) and stack.remat):
            continue
        for i in sorted(stack.remat_blocks):
            block = stack.conformer_blocks[i]
            add(ffn.KERNEL_FWD, block.ff_module1.fused_eligible()
                + block.ff_module2.fused_eligible())
            att = block.self_att_module
            add(attention_module.KERNEL_FWD, att.fused_eligible())
            add(flash_attention.KERNEL, bool(
                getattr(att.attention, "use_flash", False)
                and not att.attention.causal))
            if block.conv_module.fused_eligible():
                add(conv_module.KERNEL_STATS, 1)
                add(conv_module.KERNEL_FWD, 1)
            n_bn = (sum(isinstance(m, BatchNorm) for m in block.modules())
                    - block.conv_module.fused_eligible())
            add(KERNEL_STATS, n_bn)
            add(KERNEL_APPLY, n_bn)
    return extra


def _remat_trainer(route, remat):
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    return Trainer(device="cuda", precision="bfloat16", seed=0,
                   vocab_size=256, remat=remat,
                   loss=CTCLoss(zero_infinity=True), **REMAT_ROUTES[route])


def _remat_run(route, remat, batch, keep: bool = False):
    """One trainer of the route (same weights and seeds either way), alone
    on the card: the first forward + backward (losses, gradients and BN
    statistics, moved to the host), then `counted_train_steps`, then the
    peak memory of one more step. `keep` returns the trainer too."""
    torch.cuda.empty_cache()
    trainer = _remat_trainer(route, remat)
    model = trainer.model
    losses, grads = trainer.loss_and_grads(batch)
    first = {"losses": {k: float(v) for k, v in losses.items()},
             "grads": {n: g.float().cpu() for n, g in grads.items()},
             "stats": {n: b.detach().cpu() for n, b in model.named_buffers()
                       if "running_" in n}}
    del grads
    per_step = model.kernel_launches_per_step()
    history, launches = counted_train_steps(trainer, batch, per_step,
                                            steps=REMAT_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"first": first, "history": history, "launches": launches,
           "per_step": per_step, "extra_per_step": remat_extra_forwards(model),
           "peak_gib": peak,
           "remat_blocks": sum(len(m.remat_blocks) for m in model.modules()
                               if getattr(m, "remat", False)
                               and hasattr(m, "remat_blocks"))}
    if keep:
        out["trainer"] = trainer
    del trainer, model
    torch.cuda.empty_cache()
    return out


def _remat_step_ms(route, remat_trainer, batch) -> dict:
    """Step ms of the route without and with remat in turns (plain, remat,
    remat, plain), 2 steps a turn: a plain trainer is built again beside
    the remat one."""
    plain_trainer = _remat_trainer(route, False)
    plain_trainer.train_step(batch)
    turns = []
    for name in ("plain", "remat", "remat", "plain"):
        tr = remat_trainer if name == "remat" else plain_trainer
        turns.append([name, cuda_time_ms(lambda: tr.train_step(batch),
                                         iters=2, warmup=0)])
    del plain_trainer
    torch.cuda.empty_cache()
    return {name: sum(ms for n, ms in turns if n == name) / 2
            for name in ("plain", "remat")} | {"turns": turns}


def _remat_agreement(route, got, want) -> dict:
    """The remat run against the plain one: the first forward's losses
    bit-equal, every gradient leaf within REMAT_GRAD_TOL of its largest
    entry (the video front end's within REMAT_FRONT_END_TOL; leaves below
    1e-6 of the largest gradient entry left out, as check_agreement does),
    every BN running statistic within 1e-5 of the larger of 1 and its
    buffer's largest entry, the backward launches equal and the forward
    launches higher by REMAT_STEPS x the plan's count."""
    g1, g0 = got["first"], want["first"]
    loss_diff = {k: abs(g1["losses"][k] - v) for k, v in g0["losses"].items()}
    gmax = max(float(g.abs().max()) for g in g0["grads"].values())
    same = sum(torch.equal(g1["grads"][n], g) for n, g in g0["grads"].items())
    worst, worst_front = (0.0, "none"), (0.0, "none")
    for name, g in g0["grads"].items():
        leaf_max = float(g.abs().max())
        if leaf_max <= 1e-6 * gmax:
            continue
        err = (max_abs(g1["grads"][name], g) / leaf_max, name)
        if FRONT_END in name:
            worst_front = max(worst_front, err)
        else:
            worst = max(worst, err)
    stats_err = max(max_abs(g1["stats"][n], b) / max(1.0, float(b.abs().max()))
                    for n, b in g0["stats"].items())
    extra = got["extra_per_step"]
    fwd_diff = {k: got["launches"].get(k, 0) - want["launches"].get(k, 0)
                for k in set(got["launches"]) | set(want["launches"])}
    want_diff = {k: REMAT_STEPS * extra.get(k, 0) for k in fwd_diff}
    out = {"remat_blocks": got["remat_blocks"],
           "first_loss_max_abs_diff": max(loss_diff.values()),
           "worst_leaf": worst, "worst_front_end_leaf": worst_front,
           "leaves_bit_identical": [same, len(g0["grads"])],
           "bn_stats_scaled_max_abs": stats_err,
           "launch_diff": fwd_diff, "launch_diff_plan": want_diff,
           "counted_loss_max_abs_diff": max(
               abs(a["loss"] - b["loss"])
               for a, b in zip(got["history"], want["history"]))}
    log(f"phase 31 {route}: {got['remat_blocks']} blocks rematerialized; "
        f"first step's losses max abs diff {out['first_loss_max_abs_diff']} "
        f"(must be 0); gradient leaves bit-identical {same}/"
        f"{len(g0['grads'])}; worst leaf {worst[1]} {worst[0]:.2e} (tol "
        f"{REMAT_GRAD_TOL}), video front end {worst_front[1]} "
        f"{worst_front[0]:.2e} (tol {REMAT_FRONT_END_TOL}); BN statistics "
        f"{stats_err:.2e} of scale (tol 1e-5); counted steps' losses max abs "
        f"diff {out['counted_loss_max_abs_diff']:.3e}")
    log(f"phase 31 {route}: launches over {REMAT_STEPS} steps, remat minus "
        f"plain {fwd_diff}; the plan's forwards x {REMAT_STEPS} {want_diff}")
    if not (out["first_loss_max_abs_diff"] == 0.0
            and worst[0] <= REMAT_GRAD_TOL
            and worst_front[0] <= REMAT_FRONT_END_TOL
            and stats_err <= 1e-5 and fwd_diff == want_diff
            and all(not k.endswith(("_bwd", "_bwd1", "_bwd2", "_bwd_dq",
                                    "_bwd_dkv")) for k in extra)
            and got["remat_blocks"] == 15):
        raise AssertionError(f"phase 31 {route}: remat disagrees: {out}")
    return out


def _variant_stack():
    """Phase 31 (b)'s stack at full width (360, 4 heads): a transposed
    stride-2 block, a `batch_norm=False` block and a ReLU block, the three
    fused switches on."""
    from avec_tpu_torch.models.conformer import ConformerBlock

    att = {"class": "RelPos1dMultiHeadAttention", "params": {"num_heads": 4}}
    kw = dict(fused_att=True, fused_conv=True, fused_ffn=True)
    return torch.nn.ModuleList([
        ConformerBlock(360, 360, 4, att, conv_stride=2, transposed=True, **kw),
        ConformerBlock(360, 360, 4, att, batch_norm=False, **kw),
        ConformerBlock(360, 360, 4, att, act_fun="ReLU", **kw)])


def _run_variant_stack(blocks, x, lengths):
    from avec_tpu_torch.ops.masks import make_mask

    t = x.shape[1]
    y = blocks[0](x, mask=make_mask(t, lengths))
    mask2 = make_mask(2 * t, 2 * lengths)
    for block in blocks[1:]:
        y = block(y, mask=mask2)
    return y


def variant_stack_check(rec) -> dict:
    """Phase 31 (b): one training step (forward, backward, SGD) of the
    variant stack in bf16 at B=16, T=38 -> 76: the fused kernels launch
    only where the JAX gates allow (K1 / K1b in the four Swish FFNs, K2 /
    K2b in the three attention modules, no K3: transposed, without BN and
    ReLU convolution modules all stay unfused, conformer.py:103-107,
    :248-252; the BatchNorm kernels for the BatchNorms of the first and
    last), the output and every gradient finite; then fp32, dropout
    off, kernels against plain versions: the stack's output within 1e-3 of
    its largest entry, and the input's gradient through the first two
    blocks (Swish) too. Through the ReLU block the input gradient is not
    held: where the fused kernels' rounding (about 4e-7) moves a ReLU gate
    across 0, the gradient jumps by about 1e-3 of its largest entry
    (`tools/torch_variant_stack_dx.py`)."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops.layers import init_params

    dev = torch.device("cuda")
    blocks = init_params(_variant_stack(), torch.Generator().manual_seed(31))
    blocks.to(dev).train()
    for m in blocks.modules():
        if hasattr(m, "seed_generator"):
            m.seed_generator = torch.Generator().manual_seed(1)
        if hasattr(m, "generator"):
            m.generator = torch.Generator(device=dev).manual_seed(2)
    # the first and last blocks' (unfused) convolution modules' BatchNorms
    want = {"fused_ffn_fwd": 4, "fused_ffn_bwd": 4, "fused_att_fwd": 3,
            "fused_att_bwd": 3, **bn_launches(2)}
    gate = {"ffn": sum(m.fused_eligible() for b in blocks
                       for m in (b.ff_module1, b.ff_module2)),
            "att": sum(b.self_att_module.fused_eligible() for b in blocks),
            "conv": sum(b.conv_module.fused_eligible() for b in blocks)}
    gen = torch.Generator().manual_seed(32)
    lengths = torch.tensor([38] + [int(v) for v in torch.randint(
        10, 38, (15,), generator=gen)], dtype=torch.int32, device=dev)
    x = torch.randn(16, 38, 360, generator=gen).to(dev)
    g = torch.randn(16, 76, 360, generator=gen).to(dev)
    opt = torch.optim.SGD(blocks.parameters(), lr=1e-3)
    _cuda.reset_launches()
    xb = x.to(torch.bfloat16).requires_grad_(True)
    y = _run_variant_stack(blocks, xb, lengths)
    (y.float() * g).sum().backward()
    opt.step()
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    finite = bool(torch.isfinite(y.float()).all()) and all(
        p.grad is None or bool(torch.isfinite(p.grad).all())
        for p in blocks.parameters())
    # fp32, dropout off: kernels against plain versions
    for m in blocks.modules():
        if hasattr(m, "regularize"):
            m.regularize = False
    outs = []
    for kernels in (True, False):
        for m in blocks.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = kernels
        x32 = x.clone().requires_grad_(True)
        (_run_variant_stack(blocks[:2], x32, lengths) * g).sum().backward()
        with torch.no_grad():
            outs.append((_run_variant_stack(blocks, x, lengths), x32.grad))
    blocks.zero_grad(set_to_none=True)
    err_y = max_abs(outs[0][0], outs[1][0]) / float(outs[1][0].abs().max())
    err_x = max_abs(outs[0][1], outs[1][1]) / float(outs[1][1].abs().max())
    out = {"launches": launches, "want": want, "gates": gate,
           "shape": list(y.shape), "finite": finite,
           "fp32_y_rel": err_y, "fp32_dx_rel": err_x}
    log(f"phase 31 variant stack (360, 4 heads; transposed stride 2, "
        f"batch_norm=False, ReLU; B=16 T 38 -> {y.shape[1]}): launches of "
        f"one bf16 step {launches} (want {want}), output and gradients "
        f"finite {finite}; fp32 kernels vs plain: y {err_y:.2e}, dx "
        f"through the first two blocks {err_x:.2e} (tol 1e-3)")
    if not (launches == want and gate == {"ffn": 4, "att": 3, "conv": 0}
            and finite and list(y.shape) == [16, 76, 360]
            and err_y <= 1e-3 and err_x <= 1e-3):
        raise AssertionError(f"phase 31 variant stack: {out}")
    return out


def remat_phase(detail) -> dict:
    """Phase 31: remat and the library's variants. (a) The flagship AV
    model at reference depth, B=16 / 6 s (phase 6's batch), bf16, on the
    fused-conv route (K1 / K1b, K2 / K2b, K3 x 4, K5) and on the flash route
    (K1 / K1b, K4 / K4b): one trainer with remat and one without from the
    same weights and seeds, each alone on the card: its first forward +
    backward, 1 warm-up + REMAT_STEPS counted steps (`counted_train_steps`:
    launches equal to `kernel_launches_per_step`, finite, everything moves),
    then the peak memory of one more step; held by `_remat_agreement`; then
    the step ms of both in turns (`_remat_step_ms`).
    (b) `variant_stack_check`. Returns {route: launches of the remat run's
    counted steps}."""
    t_phase = time.perf_counter()
    card = gpu_line()
    rec = {"card": card, "routes": {}}
    batch = make_train_batch(np.random.RandomState(0))
    launches = {}
    for route in REMAT_ROUTES:
        plain = _remat_run(route, False, batch)
        remat = _remat_run(route, True, batch, keep=True)
        agree = _remat_agreement(route, remat, plain)
        ms = _remat_step_ms(route, remat.pop("trainer"), batch)
        torch.cuda.empty_cache()
        row = {"step_ms_plain": ms["plain"], "step_ms_remat": ms["remat"],
               "step_ms_turns": ms["turns"],
               "peak_gib_plain": plain["peak_gib"],
               "peak_gib_remat": remat["peak_gib"],
               "launches_per_step_plain": plain["per_step"],
               "launches_per_step_remat": remat["per_step"], **agree}
        log(f"phase 31 {route} ({card}): train step B=16 bf16, plain / "
            f"remat in turns {[round(t[1], 2) for t in ms['turns']]}: plain "
            f"{ms['plain']:.2f} ms, peak {plain['peak_gib']:.3f} GiB; remat "
            f"{ms['remat']:.2f} ms, peak {remat['peak_gib']:.3f} GiB")
        rec["routes"][route] = row
        launches[route] = remat["launches"]
    rec["variant_stack"] = variant_stack_check(rec)
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 31 (remat and the variants) wall {rec['wall_s']:.1f} s "
        f"({card})")
    detail["remat"] = rec
    return launches


def fbank_stream_gap(model, decoder, utt) -> float:
    """Max abs of the streamed log-mels of `utt` (each 16-frame chunk's
    window through `AudioPreprocessing.stream_frames`, the end reflection
    included) against the offline log-mels of the whole utterance, on the
    model's device."""
    from avec_tpu_torch.decode.causal_streaming import (
        HOP, CausalStreamingTranscriber)

    pre, dev = model.encoder.preprocessing, next(model.parameters()).device
    st = CausalStreamingTranscriber(model, decoder, chunk_frames=16)
    st._buffer = utt
    total = len(utt) // HOP + 1
    with torch.no_grad():
        want = pre(torch.from_numpy(utt[None]).to(dev))[0]
        got = torch.cat([pre.stream_frames(torch.from_numpy(st._window(
            f0, end_reflect=True)).to(dev)[None], st.chunk)[0]
            for f0 in range(0, total, st.chunk)], dim=1)[:, :total]
    return float((got - want).abs().max())


def time_ffn_bwd_kernel(x, g, params, drop, seed, check: bool = False):
    """Time and device time of the fused-FFN backward kernel alone, through the library's C
    entry point with the wrapper's own arguments and preallocated gradient
    buffers (the wrapper's autograd bookkeeping and its six zero-fills are
    host work that a slow host would add to the time; this call is outside
    any count). With `check` it launches once into zeroed buffers and returns
    (dx, six parameter gradients) instead."""
    from avec_tpu_torch.ops import _cuda, ffn

    n, d = x.shape
    f = params[2].shape[0]
    thr, inv_keep = ffn._threshold(1.0 - drop)
    dx = torch.empty_like(x)
    grads = [torch.zeros_like(p) for p in params]
    scratch = ffn.bwd_scratch(x, f)
    args = (x.data_ptr(), g.data_ptr(), *(p.data_ptr() for p in params[:5]),
            dx.data_ptr(), *(t.data_ptr() for t in grads), scratch.data_ptr(),
            n, d, f, 1e-6, 1, seed, thr, inv_keep,
            int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))
    bwd = ffn._lib()[1]

    def launch():
        _cuda.check(bwd(*args), "fused_ffn_bwd")

    if check:
        launch()
        torch.cuda.synchronize()
        return [dx] + grads
    return cuda_time_ms(launch), device_time_ms(launch)[0]


def flash_fwd_bf16_checks(key, q, k, v, lens, scale, out, lse, want):
    """The bf16 K4 call that gave (out, lse), against the plain output `want`:
    a second call must give the same bits (one owner per output, no atomics),
    and out's relative L1 error (sum |got - want| / sum |want|) must stay
    within L1_TOL (p enters P V as three bf16 parts); beside it the same
    call through the control build that rounds p to bf16. Outside any
    count."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops import flash_attention as fa

    again = fa.flash_attention_fwd(q, k, v, lens, scale)
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    control = _cuda.control_library("flash_attention", fa.ROUNDED_P)
    b, h, t, da = q.shape
    out_r, lse_r = torch.empty_like(out), torch.empty_like(lse)
    scratch = fa.fwd_scratch(q, v)
    _cuda.check(fa._lib(control)[0](
        *(a.data_ptr() for a in (q, k, v, lens, out_r, lse_r, scratch)),
        b * h, h, t, da, v.shape[-1], float(scale), 1, _cuda.stream_ptr(q)),
        "flash_attention_fwd")
    torch.cuda.synchronize()
    l1, l1_r = rel_l1(out, want), rel_l1(out_r, want)
    log(f"flash_attention_fwd {key}: bit-identical over two calls: {same}; "
        f"p as three bf16 parts: relative L1 error {l1:.2e} (tol {L1_TOL}); "
        f"rounded to bf16: {l1_r:.2e}")
    if not same:
        raise AssertionError(f"bf16 K4 reruns differ: {key}")
    if l1 > L1_TOL:
        raise AssertionError(f"K4's fp32 p lost precision: {key} {l1}")
    return {"bit_identical": same, "rel_l1": l1, "rel_l1_rounded": l1_r}


def flash_bwd_launcher(q, k, v, dout, lse, delta, lengths, scale, lib=None):
    """K4b through the C entry of `lib` (the kernel library by default, or a
    control build) with the wrapper's own arguments, preallocated outputs
    and one scratch buffer (its launches are outside any count). Returns
    (launch, (dq, dk, dv)): `launch(which)` computes dq, dk/dV or both
    (flash_attention.BWD_*)."""
    from avec_tpu_torch.ops import _cuda
    from avec_tpu_torch.ops import flash_attention as fa

    b, h, t, da = q.shape
    outs = (torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v))
    scratch = fa.bwd_scratch(q, v)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            *(a.data_ptr() for a in outs), scratch.data_ptr(), b * h, h, t, da,
            v.shape[-1], float(scale), int(q.dtype == torch.bfloat16))
    stream = _cuda.stream_ptr(q)
    fn = fa._lib_bwd(lib)[0]

    def launch(which):
        _cuda.check(fn(*head, which, stream),
                    "flash_attention_bwd")

    return launch, outs


def sdpa_backend(kernels) -> str:
    """Which backend of F.scaled_dot_product_attention ran, from the names of
    the kernels its call ran."""
    low = " ".join(kernels).lower()
    for key, name in (("flash", "flash"), ("fmha", "memory-efficient"),
                      ("efficient", "memory-efficient"), ("cudnn", "cuDNN")):
        if key in low:
            return name
    return "math (cuBLAS products and elementwise kernels)"


def _category(name: str) -> str:
    low = name.lower()
    conv = ("conv_ln_stats_kernel", "conv_pw1_kernel",
            "conv_depthwise_kernel", "conv_pw2_kernel", "conv_grad_w2_kernel",
            "conv_grad_bn_kernel", "conv_depthwise_bwd_kernel",
            "conv_grad_w1_kernel", "conv_grad_h_kernel", "conv_ln_bwd_kernel",
            "conv_cast_kernel", "conv_prep_kernel", "conv_pw1_wgmma_kernel",
            "conv_grad_bn_wgmma_kernel", "conv_depthwise_bwd_bf16_kernel",
            "conv_ln_bwd_rows_kernel", "conv_reduce_kernel",
            # hopper.cuh's product launch: K3b-1 runs one job (operands
            # MN-major), K3b-2 two, K1b three
            "wgmma_products_kernel<1,", "wgmma_products_kernel<2,")
    # checked first: K2's "ln_stats_kernel" and "ln_bwd_kernel" end two of
    # these names
    if any(k in low for k in conv):
        return "fused convolution module kernels (K3 + K3b)"
    att = ("ln_stats_kernel", "qkv_kernel", "relpos_u_kernel", "scores_kernel",
           "att_v_kernel", "out_proj_kernel", "grad_out_kernel",
           "grad_wo_kernel", "datt_ds_kernel", "grad_kv_kernel",
           "grad_relpos_u_kernel", "grad_q_kernel", "grad_pos_kernel",
           "grad_w_qkv_kernel", "grad_h_kernel", "ln_bwd_kernel",
           "col_sums_kernel", "prep16_kernel", "proj16_kernel",
           "dacc16_kernel", "relpos16_kernel", "att16_kernel",
           "att_fwd16_kernel", "kv16_kernel", "weights16_kernel",
           "ln_bwd16_kernel", "reduce16_kernel")
    for cat, keys in (("fused attention module kernels (K2 + K2b)", att),
                      ("flash kernel (K4)",
                       ("flash_fwd_", "flash_prep_kernel<true")),
                      ("flash backward kernels (K4b)",
                       ("flash_bwd_", "flash_prep_kernel<false")),
                      ("fused FFN forward kernel (K1)", ("ffn_fwd_",)),
                      ("fused FFN backward kernel (K1b)",
                       ("ffn_bwd_", "wgmma_products_kernel<3,")),
                      ("stem kernel (K5)", ("bn_relu_pool_kernel",)),
                      ("CTC loss", ("ctc_loss",)),
                      ("optimizer (Adam, foreach)", ("multi_tensor",)),
                      ("host-to-device copy", ("memcpy htod",)),
                      ("device copy / cast", ("copy",)),
                      ("convolution", ("conv", "fprop", "implicit")),
                      ("matmul", ("gemm", "cublas", "cutlass", "xmma"))):
        if any(k in low for k in keys):
            return cat
    return "elementwise / reduction / other"


def profile_forward(srv, inputs):
    """Device time of one served bf16 forward, beside its CUDA-event time."""
    srv.model.set_kernels(True)
    return profile_call("forward", lambda: srv.forward(inputs))


def profile_train_step(trainer, batch):
    """Device time of one bf16 train step, beside its CUDA-event time."""
    trainer.model.set_kernels(True)
    return profile_call("train step", lambda: trainer.train_step(batch))


def profile_call(what: str, fn):
    """Device time of one call of `fn` (`traced_device_rows`), by category
    and by kernel name, beside the call's CUDA-event time."""
    fwd_ms = cuda_time_ms(fn, iters=3, warmup=1)
    (rows, annotated), cats = traced_device_rows(fn), {}
    for us, _, key in rows:
        cat = _category(key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    busy_old = busy + annotated / 1e3
    log(f"profile: {what} {fwd_ms:.3f} ms (CUDA events), device busy "
        f"{busy:.3f} ms in the traced {what}, idle share "
        f"{max(0.0, 1 - busy / fwd_ms):.3f}; with the user-annotation "
        f"spans (as earlier versions counted) {busy_old:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_old / fwd_ms):.3f}")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.4f} ms  {cat}")
    for us, count, key in rows[:12]:
        log(f"  {us / 1e3:9.4f} ms {count:5d}x {key[:100]}")
    return {"what": what, "ms": fwd_ms, "busy_ms": busy,
            "busy_ms_with_annotations": busy_old,
            "idle_share": max(0.0, 1 - busy / fwd_ms), "categories_ms": cats,
            "top": [{"ms": us / 1e3, "count": c, "name": k}
                    for us, c, k in rows[:40]]}


if __name__ == "__main__":
    sys.exit(main())
