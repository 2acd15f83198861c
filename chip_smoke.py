#!/usr/bin/env python3
"""Drive the repro_torch serving path on one GPU and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0] [--kernels-only [--sweep-tiles]]

Phases, each printed on its own line:

  1. the card (``nvidia-smi`` name and power limit) and the kernel build;
  2. each kernel against its plain version on the card at the main path's
     shapes, B = 256 and a ragged B = 200 (``check_call``): K2-K5
     (int4_matmul, merged_spike_fc, sparse_fc, nm_fc over the 2:4 FC)
     bit for bit (``torch.equal``), and K5 bit-equal to K4 over the same
     mask stored as CSC; K1 (rsnn_cell) and K10 (spike_cell), and their
     plain versions, within the u rule: the plain chain replayed in
     float64 with the magnitude A of its summands (``lif_bound``), |u -
     u64| <= gamma(n) A = (n + 3) 2^-24 A, n the longest sum feeding the
     element, a spike differing from the replay's only where |u64 - vth|
     is within that bound (``check_cell``; the largest |du| / (2^-24 A)
     of each is printed); K9 (spike_broadcast: the 2-D L1 feed-forward and
     the 3-D FC union) within ``TOL``; K8 (delta_step) with mask, held
     input and cached rows exact and recomputed rows within ``TOL``.
     K9/K10 run lossless and at ``TRUNC_CAPACITY`` events a row, and K9,
     K4, K5, K2 and K3 also at their tiles' edges (``check_tile_edges``:
     an all-zero and a full row, N = 200 and 203, K9 at capacity 1; K5
     over 1:4, 2:4 and 3:8 masks, bit-equal to its plain version and to
     K4 on the same mask (``check_nm_edges``); K2 at K = 40 and 128 and K3
     at TS = 1, 2 and 4, both again at B = 1, bit for bit; K9 also bit
     for bit against the ascending fmaf chain over its kept events,
     ``ascending_chain``), and K2/K3 within ``TOL`` on non-integer inputs
     and on integers outside [-128, 127] in one row, which take their
     fp32 path (``check_int4_edges``); K1 and K10 at B = 256, 200 and 1,
     H = 128, 256 and 100, TS = 1, 2 and 4, with the stride-0 and the
     dense stimulus, K10 lossless bit-equal to K1 and at
     ``TRUNC_CAPACITY`` within the rule above (``check_cell_edges``); K8
     at ``DELTA_THRESHOLD`` and at 0, first on a repeated frame so that
     every row takes the cached branch, and at B = 256, 200 and 1, H =
     128, 256 and 100 on frames whose rows are mixed, all held or all
     changed (``check_delta_edges``).  K6 and K7 (megastep, spike=False/True)
     in the three FC modes (``dense_int4``, ``csc``, ``nm``) over chunks of
     1 and
     ``MEGA_FRAMES`` frames (``check_megastep``): a slot may differ from
     the plain version only where the chain, replayed frame by frame in
     float64 (``megastep_replay``), comes within the u rule of a
     threshold; every other slot's spikes, counters and logits are
     bit-equal to the plain version's, its trains the replay's and its u,
     the kernel's and the plain version's, within the u rule of the
     replay's (``check_mega``); the input one-bits are bit-equal
     everywhere, and K7 is bit-equal to K6 on the same inputs.  Then the
     float engine's kernels with the float weights of ``float_params``:
     K6/K7 with float layer weights and the ``dense_float`` FC at
     ``BASELINE`` and ``PRUNED`` widths by the same rule, the logits within
     gamma(TS H) sum |s w| of the replay's, K7 bit-equal to K6; and K1,
     K8-K10 at H = 256 (``BASELINE``), a width no int4 path reaches.  K6
     float at ``PRUNED`` width again on the inputs drawn after K8's edge
     check, where the old rule ``1e-5 (1 + |u|)`` failed (``old_u_rule``
     prints how it fares).  K6/K7 again
     at the edges of their plans in all four FC modes
     (``check_megastep_edges``: B = 256, 200 and 1; H = 128, 256 and 100;
     TS = 1, 2 and 4; N = 1920 and 203; F = 1 and ``MEGA_FRAMES``).  The
     launch functions refuse the shapes, N:M geometries, plans and pairs
     of weight precision and FC mode they cannot take
     (``check_refusals``);
  3. three PRUNED int4 artifacts (40 -> 128 -> 128 -> 1920, TS = 2) made
     from ``--seed`` and packed and written by the port
     (``seeded_int4``: ``quantize_to_int``, ``nm_prune_mask``,
     ``pack_int4``, ``sparsify_columns``, ``pack_nm_groups``,
     ``save_artifact``) in the reference's schema-v2 format
     (``ARTIFACTS``): the FC pruned 40% at random into padded CSC,
     and its 2 largest |w| of every 4 rows kept, as N:M (``nm_group``)
     and as padded CSC; and a float ``BASELINE`` artifact (40 -> 256 ->
     256 -> 1920, 2,793,472 B of float32 weights, the paper's
     uncompressed model) as ``save_artifact(params=...)`` writes it
     (``write_float_artifact``);
  4. 512 seeded utterances of 40-100 frames served through
     ``StreamLoop(batch_slots=256, pipeline_depth=0, aot_warmup=False)``
     (the eager v1 loop, ``V1_EAGER``) in every
     configuration of ``SERVED``: ``pallas``, ``sparse``, ``spike`` with
     the CSC readout (K4) and without it (K9's union), ``delta`` at
     threshold 0 and at ``DELTA_THRESHOLD``, ``fused`` and ``fused_spike``
     (one K6 or K7 launch a frame) with and without the CSC readout; the
     float engine over the float artifact, once: ``pallas`` (K1),
     ``spike`` (K10, K9), ``delta`` at threshold 0 (K8, K10), ``fused``
     and ``fused_spike`` (K6/K7 in ``dense_float``); then ``sparse``,
     ``spike``, ``fused`` and ``fused_spike`` over the N:M artifact (K5,
     K6/K7's ``nm`` mode), once and unprofiled, and ``sparse`` and
     ``fused`` over the same 2:4 mask as CSC, whose logits must equal the
     N:M runs' bit for bit.  Every kernel's launch count must equal steps
     x its launches per step in that configuration (0 for a kernel it
     does not run); ``pallas`` and ``sparse`` logits must be bit-equal
     (the dense and CSC readouts hold the same int4 matrix and sum
     integers), and so must ``fused`` and ``fused_spike`` (K7 is
     bit-equal to K6), over all three artifacts served.  Each is compared
     with the port's ``ref`` backend over the same artifact on the card:
     argmax agreement and spike-flip rate are printed, and where the
     configuration computes ``ref``'s function (all but ``delta`` at a
     positive threshold) a teacher-forced run of frames is asserted: a
     slot's spikes may differ only where the ``ref`` engine's potential
     lies within ``U_RTOL``/``U_ATOL`` of the threshold (those slots are
     counted and printed), and the other slots' logits and potentials
     must agree within ``LOGIT_ATOL``.  For ``pallas`` and ``fused float``
     (``FIRST_FLIP``), whose free-running argmax differed from ``ref``'s,
     the teacher-forced run covers every frame of all 512 streams (in
     batches of ``SLOTS``, a slot masked once its stream has ended), and
     each stream whose argmax differs from ``ref``'s is named with its
     first flip in a free-running run (``first_flips``: the first frame
     with a differing spike, L0 before L1, the earliest time step, and
     ``ref``'s |u - vth| there), which must lie inside the u rule
     (``check_first_flips``).  Frames/s, the measured densities,
     ``delta_input_density`` and ``mmac_per_second()`` are printed.  The
     chunk axis: ``CompiledRSNN._chunk_step`` over ``MEGA_FRAMES`` frames
     of ``fused`` and ``fused_spike`` equals as many ``step`` calls bit
     for bit, in one launch against one a frame, over the ``csc`` and the
     float artifact.  ``core.rsnn.forward``, the float golden model,
     equals the ``ref`` engine on 8 streams (``check_forward``);
 4b. every configuration of ``SERVED`` over the ``csc`` and the float
     artifact served again through each loop of ``GRAPH_LOOPS``, its step
     captured as a CUDA graph at construction: v2 (``pipeline_depth=2``),
     v2 at chunks of ``MEGA_FRAMES`` frames (``ring_frames=256``), v1, and
     v1 at chunks of ``MEGA_FRAMES`` (``serve_graphs``).  Each request's
     logits must be bit-equal to phase 4's; each kernel's launches, which
     the loop credits at every graph replay, must be steps x (1 for the
     mega-step, else the chunk's frames) x its launches a frame; the
     engine's ``capture_count`` must rise by one at construction and not
     during the serve; no step may be in flight after ``run``.  Steps,
     dispatches and host syncs a frame and frames/s are printed.  Then
     ``pallas``, ``fused`` and ``fused float`` are served three times
     through the eager v1, the v2 and the chunked v2 loop in turns (each
     run, the median and the spread of frames/s), and ``pallas`` and
     ``fused`` once more through the chunked v2 loop under
     ``torch.profiler`` (busy share, device ms a step, copy counts);
 4f. sharded serving (``check_sharded``): ``pallas``, ``fused``, ``delta``
     at threshold 0 and ``fused float`` (``SHARDED``) through
     ``ShardedStreamLoop`` over ``[cuda:0]`` (one shard of 256 slots) and
     ``[cuda:0] * 4`` (four of 64), at v2 and at v2 in chunks of
     ``MEGA_FRAMES``, fed by ``AsyncFeaturizer.for_loop`` and
     ``submit_stream(quantized=True)``: each request's logits bit-equal
     to phase 4's; each kernel's launches steps x shards x (1 for the
     mega-step, else the chunk's frames) x its launches a frame;
     ``capture_count`` up by the shards at construction and not during
     the serve; no step in flight after ``run``; each shard's state and
     ring ``256 / shards`` slots on the card.  The CPU featurizer is held
     bit-equal to ``quantize_features`` on the card over every utterance,
     ``bench_stream_sharded`` runs on the card and the example runs with
     ``--sharded`` at 256 slots.  Frames/s (submission included),
     dispatches and host syncs a frame are printed;
  5. the device busy share of one more run of ``pallas``, ``sparse``,
     ``spike``, ``delta`` at ``DELTA_THRESHOLD``, ``fused`` and
     ``fused_spike``, and of ``pallas``, ``spike``, ``fused`` and
     ``fused_spike`` at float, under ``torch.profiler``, with the device operations that took
     most of it; each kernel's mean time per frame at B = 256 from CUDA
     events beside its plain version, a PyTorch library yardstick where
     one call computes the same function, and the H100 bound: the larger
     of bytes over 3.35 TB/s and operations over the peak rate of their
     type (float32 outside the tensor cores, 67 TFLOP/s, for K1 and
     K8-K10, whose dequantized weights no tensor-core type holds exactly;
     int8, 1,979 TOP/s, for K2-K5, whose operands are 8-bit integers,
     spikes and int4 weights; K6/K7 take their layer products at the
     float32 rate, their int4 FC's integer sums at the int8 rate and the
     float FC at the float32 rate).  A gathered or gated kernel counts
     what this run's data needs (``work``).  K6/K7 have a row each for
     the ``csc``, ``nm`` and ``dense_int4`` FC, as served, and one for
     ``dense_float`` at ``BASELINE``, each with the plan it ran (slots x
     CTAs a cluster x FC columns a sub-tile, the grid's CTAs, shared
     bytes a CTA, clusters the card holds at once); they are timed in
     every FC mode over chunks of 1 and ``MEGA_FRAMES`` frames,
     ``dense_float`` at both widths, and K1, K8-K10 again with float
     weights at H = 256.  Every
     configuration over the ``csc`` artifact is then served once more, in
     reverse order, for the spread of frames/s between runs.

Before phase 5, phase 4c (``check_packing``): the port packs an int4
model itself.  Seeded float ``PRUNED`` parameters packed on the card in
four recipes (``PACK_RECIPES``: the FC 40% by magnitude, 2:4, l0_wh 2:4
beside the FC's 40%, none), each bit-equal to the same packing on the CPU,
its size report equal (100,864 B for the 40% recipe) and its
``save_artifact`` / ``load_artifact`` round trip equal; then each
``PACK_SERVED`` configuration served through the v2 graph loop from the
engine that packed in process and from its reloaded artifact, logits
bit-equal.  Then ``examples/stream_asr_torch.py`` at 256 slots and 512
streams, in process and as a ``--save-artifact`` / ``--artifact`` pair
(``run_example``), its report printed.

Then phase 4d (``check_training``): the compression recipe trains on the
card, in plain PyTorch (no kernel of the port lies on the training path,
as none of the reference's does).  (a) ``check_one_step``: one training
step from the seeded ``BASELINE`` parameters on a batch of 32 utterances
of 8 frames, on the card and on the CPU: every LIF step's spikes equal
except where the CPU's |u - vth| lies within the u rule
(``train_u_bounds``; the count is printed), and then every gradient leaf
within ``GRAD_TOL`` of its largest element and ``make_train_step``'s
update with it.  (b) ``check_recipe``: ``run_pipeline`` at full width
(hidden 256 -> 128, FC 1920, 100 frames, batch 32, the temporal schedule
on, ``RECIPE_STEPS`` steps a stage), stopped after ``structured`` and
resumed with ``--artifact``'s export; the restored stages bit-equal and
their only records ``restored``; steps/s and each stage's metrics, then
the accelerator model at the QAT stage's measured sparsity.
``profile_train_step`` times a full-width step at TS 4 and 2 and
profiles one.  (c) The exported model served through the v2 graph loop
in ``fused`` (K6, FC ``csc``) and ``sparse`` (K1, K2, K4) from the
in-process engine and from the artifact, logits bit-equal, launches
steps x a step's.

Then phase 4e (``check_paper_claims``): the paper's end-to-end claims at
full width.  ``run_pipeline`` at ``tests/test_system.py``'s schedule (90
steps a stage, batch 16, 40-frame utterances, 1920 classes, the temporal
schedule on) and the paper's widths (hidden 256, then 128); the four
claims asserted with the reference's thresholds (every stage's error
below chance - 0.02; the QAT stage under 0.1 of the baseline's bytes and
its zero-skip MMAC/s below dense; QAT within 0.1 of the unstructured
stage's error; L0/L1 densities in (0.02, 0.7), the FC union at most the
summed FC density).  Each stage's error, bytes, MMAC/s, densities and
steps/s a TS are printed; the results payload with the TS sweep (1, 2, 4)
is written and ``repro_torch.benchmarks.paper_tables`` prints the nine
tables from it and ``bench_rsnn_forward`` on the card.  No kernel lies on
this path: every launch counter stays 0.

Then phase 6 (``check_lm_serving``): the token-LM serving path through
``registry.get_model`` -> ``init`` -> ``generate`` / ``ServeLoop``, plain
PyTorch (no kernel of the port lies on it: every launch counter stays
0).  (a) gemma2-2b at its published widths (``LM_GEMMA2``; its
2,614,341,888 parameters, the reference's count, asserted), drawn on the
card from a seeded generator: in float32, ``LM_BATCH`` ``MarkovLMStream``
prompts of ``LM_PROMPT`` tokens prefilled, ``pad_cache`` to ``LM_PROMPT +
LM_STEPS`` and ``LM_STEPS`` teacher-forced decode steps, each step's
logits within ``LM_TOL`` of the full forward (``lm_teacher_forced``); then in
bf16 (the float32 weights rounded) the same steps, logits finite and
their greedy agreement with float32 printed, four decode steps under
``torch.profiler`` (``profile_decode``: busy share, device operations a
step), ``generate`` twice with ids equal, and ``ServeLoop(batch_slots=LM_SLOTS)`` answering ``LM_REQUESTS``
requests of 64-512 prompt tokens and 16-32 new ones.  (b) One local and
one global gemma2 block (``layer_fwd``) at full width, float32, 2 x 128
tokens, the card against the CPU within ``BLOCK_TOL`` (``check_block``).
(c) deepseek-v3-671b at its published widths cut to two layers
(``LM_DEEPSEEK``: one dense MLA layer and one MoE layer of 256 experts,
top 8, one shared; 13,944,134,656 parameters, asserted), float32, the
ragged router: 4 x 256 prompt tokens, ``pad_cache`` to 264, 8
teacher-forced steps within ``LM_TOL`` of the full forward, and the
dense_dispatch router on the same cache at each step (capacity 4 for 4
tokens: nothing dropped) within ``LM_TOL`` of ragged.  (d) Each of the
seven decoder-LM archs at ``reduce_config``, float32, the same seeded
parameters on the CPU and on the card: prefill logits within
``LM_CPU_TOL``, greedy ids equal (``check_reduced``).  Prefill ms and
decode ms a token (CUDA events; the median of the steps), tokens/s of
``generate`` and ``ServeLoop``, each model's peak
``max_memory_allocated`` and the phase's seconds are printed beside the
card's name and power limit.  Rehearse it on the CPU by setting
``LM_GEMMA2`` and ``LM_DEEPSEEK`` to their ``reduce_config`` (bf16 and
two ragged layers respectively), ``GEMMA2_PARAMS``/``DEEPSEEK_PARAMS`` to
their counts and the sizes to a few tokens, and calling
``check_lm_serving(0, torch.device("cpu"), "")`` (~3 s).

Then phase 7 (``check_lm_families``): the other three token-LM families,
plain PyTorch (every launch counter stays 0), float32 with TF32 off,
weights drawn on the card from a seeded generator, each model's parameter
count asserted equal to the reference's ``jax.eval_shape``.  (a)
whisper-base at its published widths (``LM_WHISPER``, 87,488,512
parameters at ``max_dec_len`` 32768): 4 streams of 1,500 seeded N(0, 1)
frames and 4 x 64 prompt tokens prefilled, ``pad_cache`` to 80, 16
teacher-forced decode steps within ``LM_TOL`` of the full forward; then in
bf16 (the float32 weights rounded; the reference's float32 leaves stay
float32, ``cast_like_``) the encoder's ms and ``generate`` of 32 tokens
with the frames through ``extra_inputs``, twice, ids equal (``ServeLoop``
passes no frames, in the reference too, so it does not serve whisper).
(b) xlstm-350m (528,555,176 parameters): 4 x 512 prompt tokens (512 = 4
chunks of 128, so prefill takes the chunked form) prefilled in the chunked
and the sequential form, logits and final states within ``LM_TOL``
(``chunked_against_sequential``); 16 teacher-forced decode steps within
``LM_TOL`` of the full forward; ``spiking=True`` through both forms with
the sLSTM thresholds drawn from N(0, ``SPIKE_VTH_STD``^2) (at their init
of 1 no unit can fire), logits finite, each sLSTM layer's spike rate and
the spikes that differ between the forms printed, not asserted
(``spiking_forms``); then bf16 teacher-forced steps (ms), four decode steps
under ``torch.profiler``, ``generate`` twice with equal ids and
``ServeLoop`` over 4 slots answering 8 requests.  (c) zamba2-7b
(6,750,550,224 parameters, 27.0 GB in float32): 2 x 256 prompt tokens,
chunked against sequential prefill within ``LM_TOL``, ``pad_cache`` to 264
and 8 teacher-forced decode steps within ``LM_TOL``; then bf16 (13.5 GB,
each float32 leaf freed as it is cast): teacher-forced steps (ms), four
profiled decode steps, ``generate`` twice with equal ids, ``ServeLoop``
over 2 slots answering 4 requests.  (d) ``check_reduced`` over all ten
archs, whisper with seeded frames.  Prefill ms, decode ms a token (CUDA
events, the median), tokens/s, each model's peak
``max_memory_allocated`` and the phase's seconds are printed beside the
card's name and power limit.  Rehearse it on the CPU by setting
``LM_WHISPER``, ``LM_XLSTM`` and ``LM_ZAMBA2`` to their ``reduce_config``
in bf16 (the two recurrent ones at ``chunk=4``), ``WHISPER_MAX_DEC_LEN``
to 64, the three parameter counts to the reduced models' and the batch,
prompt, step and request sizes to a few tokens (prompts a multiple of 4),
``torch.cuda.synchronize`` a no-op, and calling
``check_lm_families(0, torch.device("cpu"), "")`` (~3 s).

Then phase 8 (``check_lm_training``): the token-LM train path
(``launch/steps.py`` ``make_train_step`` and ``loss_and_grads``,
``data/pipeline.py`` ``PrefetchIterator``, ``training/trainer.py``
``Trainer``), plain PyTorch (every launch counter stays 0), weights drawn
on the card from a seeded generator, each model's parameter count
asserted equal to the reference's ``jax.eval_shape``.  (b) gemma2-2b at
its published widths in float32 (TF32 off): ``layer_fwd`` of a local and
a global block, 2 x 128 tokens, forward and backward on the card and on
the CPU, every gradient within ``LM_GRAD_TOL`` of its leaf's largest
element (``check_train_block``); the whole model's loss and gradients
with ``remat="full"`` against ``"none"`` on the card, the loss within rel
1e-6 and the gradients within ``LM_GRAD_TOL`` (``check_remat``).  (a)
gemma2-2b at its published widths and config (bf16, remat ``"full"``,
AdamW), ``make_train_step(..., donate=True)`` fed by ``PrefetchIterator``,
``GEMMA2_TRAIN_STEPS`` steps of ``GEMMA2_TRAIN_BATCH`` x
``GEMMA2_TRAIN_SEQ`` ``MarkovLMStream``
tokens: loss and grad norm finite every step, the parameters moved; the
loss curve, ms a step (CUDA events; the median after the first), tokens/s
trained, and one more step under ``torch.profiler`` (busy share, device
operations).  (c) xlstm-350m with the spiking sLSTM (bf16, vth ~ N(0,
``SPIKE_VTH_STD``^2)), 4 x 512 tokens (the chunked mLSTM form): the
gradients finite and d loss / d vth nonzero in every sLSTM layer, then
``XLSTM_TRAIN_STEPS`` steps; each sLSTM layer's spike rate on a held-out
batch before and after.  (d) zamba2-7b at its published widths cut to
two shared-attention groups (``TRAIN_ZAMBA2``, 12 Mamba2 layers), bf16,
remat ``"full"``, 2 x 256 tokens (two chunks of 128): the first loss
finite; the gradients finite, or not finite only within the reach of a
Mamba2 layer whose chunk's masked ``exp`` overflowed, and NaN in each such
layer's a_log (``masked_spans`` records each chunk's largest masked
exponent: past ``F32_LOG_MAX`` the backward's inf x 0 is the NaN the
reference's ``jax.grad`` gives too, tests/test_torch_lm_remat.py;
``nan_out_of_reach``); then the same loss and gradients at float32 on
the card (the parameters upcast, the same batch,
``zamba2_float32_grads``): leaf by leaf, a stacked leaf layer by layer
(``layer_units``), the bf16 gradient finite exactly where the float32 one
is, and the finite elements within ``BF16_GRAD_RTOL`` relative L2 error
of it (``against_float32``; each unit's error printed, the worst first);
then ``ZAMBA2_TRAIN_STEPS`` steps, timed (once the gradients hold NaN the
steps spread it through the parameters, and the line says so).  (e)
whisper-base at its published widths (bf16) through ``Trainer``: seeded
N(0, 1) frames, checkpoints every ``WHISPER_CKPT_EVERY`` steps, a
preemption at call ``WHISPER_PREEMPT``
(``t.preempt.trigger()``), an auto-resume; the final loss within
``RESUME_RTOL`` of an uninterrupted run's, ``metrics.jsonl`` and the
checkpoints written, the heartbeat fresh at every step; SIGTERM's
handler given back after each run (``restore_sigterm``).  (f) Each of the
ten archs at ``reduce_config``, float32: ``loss_and_grads`` on the card
against the CPU from the same seeded parameters (the loss within rel
1e-5, each gradient within ``LM_GRAD_TOL``), then one ``make_train_step``
step: each updated parameter within ``UPDATE_TOL`` lr of the CPU's, or
2 lr more where the CPU's clipped gradient is under ``G_FLOOR``
(``check_reduced_training``).  (g) ``examples/serve_lm_torch.py``'s
``run`` on the card: fit, then ``ServeLoop``; the last fit loss below
the first.  Each model's seconds and peak ``max_memory_allocated`` are
printed beside the card's name and power limit.  Rehearse it on the CPU
by setting ``TRAIN_GEMMA2``, ``TRAIN_XLSTM`` (``spiking=True``),
``TRAIN_ZAMBA2`` and ``TRAIN_WHISPER`` to their ``reduce_config`` in
bf16 (remat ``"full"`` but xlstm's, the recurrent ones at ``chunk=4``),
``WHISPER_MAX_DEC_LEN`` to 64, ``GEMMA2_PARAMS``, ``XLSTM_PARAMS``,
``ZAMBA2_CUT_PARAMS`` and ``WHISPER_PARAMS`` to the reduced models'
counts (``init`` on the meta device), the batch, sequence and step sizes
to a few tokens (sequences a multiple of 4), ``torch.cuda.synchronize`` a
no-op, and calling ``check_lm_training(0, torch.device("cpu"), "",
tmp)`` (~8 s).

Then phase 9 (``check_examples``): the two examples and the LM
yardstick.  (a) ``examples/quickstart_torch.py``'s ``main`` with
``--device cuda`` (``check_quickstart``): 30 QAT steps (the first and the
last loss finite, the last below the first), the Fig. 12/13/17
accounting, then K1 and K3 on the trained weights, each launched exactly
once (every other counter 0), K1 held against its plain version on the
same card tensors (a spike may differ only where the chain, replayed in
float64, comes within ``TOL`` (1 + |u|) of the threshold; u within
it elsewhere) and K3 within ``TOL`` (1 + |y|).  (b)
``examples/compress_pipeline_torch.py``'s ``main`` at its default, yi-6b
reduced (``check_compress``): K2 launched exactly once and within
``TOL`` (1 + |y|) of the dequantized product; then its ``compress``
and ``drift`` on gemma2-2b at its published widths (``EXAMPLE_GEMMA2``,
bf16, 2,614,341,888 parameters asserted) drawn on the card, 40% pruned:
the leaves selected, bytes, pruned count, logit drift, seconds and peak
memory printed, no kernel launched.  (c) ``analysis/model_flops.py``
``param_counts`` of the ten archs (meta device), and 8a's gemma2-2b step
(``GEMMA2_TRAIN_BATCH`` x ``GEMMA2_TRAIN_SEQ``) as ``model_flops`` (6 N T)
over the
H100's 989 TFLOP/s dense bf16 beside 8a's median step
(``check_yardstick``), no kernel launched.  Rehearse it on the CPU in ~5
s by setting ``EXAMPLE_GEMMA2`` to gemma2-2b's ``reduce_config`` in
bf16 and ``GEMMA2_PARAMS`` to its count, ``torch.cuda.synchronize`` a
no-op, and calling ``check_examples(0, torch.device("cpu"), "", 0.5)``
(on the CPU the plain versions run, and every counter stays 0).

Then phase 10 (``check_distributed``): the distributed layer, plain
PyTorch, every launch counter 0.  (a) ``check_specs``: the ten archs at
full width on the meta device, on the 16 x 16 and 2 x 16 x 16
production meshes (``launch/mesh.py`` over meta devices): parameter
specs, ``state_specs`` for the arch's optimizer, ``train_4k`` batch and
``decode_32k`` cache specs; every sharded dimension divides
(``runtime/elastic.py`` ``shard_slices`` raises otherwise); each arch's
per-device bytes of parameters plus optimizer state, and of the cache,
printed against the card's 80 GB.  (b) ``check_placement``: gemma2-2b at
its published widths (bf16, 2,614,341,888 parameters) with its AdamW
state on the card, placed through ``reshard_state`` on
``make_elastic_mesh(devices=[dev])``, (1, 1): every leaf the same
tensor, ``memory_allocated`` unchanged; then ``launch/train.py``
``main`` (reduced, ``MAIN_STEPS`` steps) with losses and final state
bit-equal to a direct ``Trainer`` run of the same seed.  (c)
``check_codec``: ``compress_grads`` over one gemma2-2b gradient at phase
8a's batch: ``CODEC_LEAVES``' q and scale bit-equal to the codec on the
CPU, each residual exactly ``g - dq``, two identical steps shrink every
leaf's accumulated error, the per-leaf relative error range printed (not
held to the reference test's 0.02).  (d) ``check_psum``:
``compressed_psum`` over the embedding gradient on a one-rank NCCL group
started from a ``HashStore`` (no network), bit-equal to
``dequantize_leaf(*quantize_leaf(x))``; the group destroyed.  Seconds and
``max_memory_allocated`` printed.  Rehearse it on the CPU in ~8 s by
setting ``PLACE_GEMMA2`` to gemma2-2b's ``reduce_config`` in bf16 and
``GEMMA2_PARAMS`` to its count, ``GEMMA2_TRAIN_BATCH`` /
``GEMMA2_TRAIN_SEQ`` to 2 / 16, ``PSUM_BACKEND`` to ``"gloo"`` (with
``GLOO_SOCKET_IFNAME=lo``), one ``torch`` thread (the CPU's
multi-threaded ``index_put_`` backward of the embedding is not
reproducible), and calling ``check_distributed(0, torch.device("cpu"),
"", tmp)``.

Then phase 11 (``check_dry_run``): the dry run, plain PyTorch, every
launch counter 0.  (a) ``launch/dryrun.py`` for every arch and shape of
``LM_SHAPES`` at ``--mesh both`` and ``launch/rsnn_cells.py --both``, as
child processes on the CPU (``DryRunLanes``: no GPU, one ``torch``
thread; each child runs the module as ``python -m`` would, once for each
of its cells, and then exits non-zero if it imported JAX or the JAX
package), started before phase 1 and run beside phases 1-10 in three
lanes, each on a core of its own, this process on the others until the
join (xlstm-350m's ``prefill_32k`` and ``train_4k``, whose traces step
the sLSTM a token at a time, one lane each; the other 38 cells, then the
RSNN cells, then phase 12's timed rows on the CPU, in the third); joined
here (``check_dryrun``): every child
exits 0, every runnable cell's two records are ``ok``, every other cell
is ``cell_is_runnable``'s skip and wrote none, the twenty RSNN records
are ``ok``; each cell's trace seconds, per-device argument bytes against
the card's 80 GB and roofline row at the H100's rates printed, with each
child's and lane's seconds.  (b) ``check_prediction``: 8a's gemma2-2b
train step (``GEMMA2_TRAIN_BATCH`` x ``GEMMA2_TRAIN_SEQ``, AdamW,
donated) and the paper's RSNN serve step at 65,536 streams, each through
the dry run's ``input_specs`` on a (1, 1) mesh, first of meta devices
and then of the card (``predict_cell``): the op counter's FLOPs and
bytes on the card against the meta trace's (each op that differs named),
the predicted argument bytes against ``memory_allocated`` (each tensor
rounded to ``ALLOC_ROUND``, a large one up to ``ALLOC_SLACK`` more),
arguments + temp against ``max_memory_allocated`` over a step within
``PEAK_BAND``, and the median step (CUDA events, ``PREDICT_STEPS``
after the first) beside the roofline's larger term.  Rehearse it on the
CPU by setting ``PREDICT_LM`` to ``("whisper-base", "small")``,
``GEMMA2_TRAIN_BATCH`` / ``GEMMA2_TRAIN_SEQ`` to 2 / 16,
``rsnn_cells.SERVE_BATCH`` to 1,024, ``torch.cuda.synchronize`` a no-op,
and calling ``check_dry_run(DryRunLanes(out), torch.device("cpu"),
"")`` (the xlstm lane takes ~17 min on one core; 11b ~1 min).

Then phase 12 (``check_bench_rows``): ``repro_torch.benchmarks.run`` on
the card, ``run.main(name)`` an entry at a time (the nine analytic
tables, the eleven timed rows, ``roofline_summary``), every launch
counter set to 0 before each and each row printed.  (a) Each entry
launches exactly the kernels ``BENCH_LAUNCHES`` names (K3; K4; K4 and
K5; K1, K2, K4 and K6 for ``bench_megastep``; K8 and K10 for
``bench_delta``; K4, K6, K7, K9 and K10 for ``bench_spike_broadcast``;
none for the others); each timed row's deterministic fields
(``bench_fields``: sizes, counts, host syncs and dispatches a frame, the
input's densities, the bit-identities the rows raise on) equal those of
the same rows run on the CPU on the same CPU-drawn weights, by a child
of 11a's third lane (``BENCH_CPU``, after its dry-run cells, one
thread); ``roofline_summary`` over phase 11's records
(``roofline.RESULTS`` pointed there) counts every single-pod record as a
cell, all ``ok``.  (b) The three rows of the reduced 20 -> 64 -> 192
model again, their loops eager (``paper_tables.StreamLoop`` with
``aot_warmup=False``), with every launch of K1, K2, K4, K6/K7, K8, K9
and K10 held against its plain version on the same inputs by phase 2's
rules (``HeldLaunches``: ``check_call``, the u rule; ``megastep_replay``
and ``check_mega``): the first run of K1, K6/K7, K8 and K10 at H =
64.  Rehearse it on the CPU in ~15 s by replacing each kernel wrapper
(``rsnn_cell.rsnn_cell``, ..., ``megastep.megastep``) with its plain
version plus one on its counter, ``kernels/ops.py`` ``_plain`` with
``lambda op, t: False``, ``torch.cuda.synchronize`` with a no-op and
``dryrun_lanes`` with a lane of the ``BENCH_CPU`` child alone, writing
two single-pod records under ``out / "dryrun_torch"``, and calling
``check_bench_rows(DryRunLanes(out), torch.device("cpu"), "")`` after
the lanes' ``join``.

Then phase 13 (``check_loadgen``): ``repro_torch/benchmarks/loadgen.py``
on the card at ``PRUNED``'s width (``LOADGEN_CFG``: 40 -> 128 -> 128 ->
1920, TS 2, int4, the FC pruned 2:4), ``SLOTS`` slots, the closed and open
loops over ``Workload(0, 512 streams of 12-48 frames)``.  (a)
``loadgen.run_sweep`` over layouts {csc, nm} x backends {jnp, pallas,
fused, delta, spike} x pipeline depth {0, 2} x chunk {1, ``MEGA_FRAMES``}
x mesh {1}, 40 cells, ``LOADGEN_SAT_ITERS`` bisection steps and
``LOADGEN_REPS`` closed-loop repetitions; the document written to
``results/loadgen_torch/BENCH_1.json`` and validated by the port's
``trajectory``; each cell's frame latency p50/p95/p99, frames/s, service
and saturation streams/s, dispatches and host syncs a frame and MMAC/s
printed.  (b) Each cell launches exactly the kernels
``LOADGEN_LAUNCHES`` names for its backend and layout (K1, K2 and K4 or
K5 for ``pallas``; K6 for ``fused``; K8 and K10 for ``delta``; K9, K10
and K4 or K5 for ``spike``; none for ``jnp``): every counter set to 0
before ``run_cell`` and read after it, each graph replay crediting its
launches.  (c) Each (layout, backend) serves the closed-loop workload
once more through ``build_loop`` + ``run_workload`` in each (depth,
chunk) loop: each kernel's launches dispatches x (1 for the mega-step,
else the chunk's frames) x a frame's, the logits bit-equal across the
four loops and between csc and nm; each backend's largest |d logit| and
argmax agreement against ``jnp`` printed, not asserted.  Rehearse it on
the CPU in ~50 s by setting ``LOADGEN_CFG`` to the reference's smoke
config (20 -> 64 -> 192), ``SLOTS`` to 2, ``LOADGEN_STREAMS`` to (6, 4,
10), ``LOADGEN_SAT_ITERS`` and ``LOADGEN_REPS`` to 1, every entry of
``LOADGEN_LAUNCHES`` empty (the plain versions count no launches) and
``trajectory.RESULTS`` to a scratch directory, and calling
``check_loadgen(torch.device("cpu"), "")``.

Then phase 14 (``check_spmd``): the token-LM train step SPMD over a
``("data", "model")`` mesh of ranks (``launch/steps.py`` on DTensor
leaves), plain PyTorch, every launch counter 0.  (b) starts first, a CPU
child (``SpmdRanks``) of ``SPMD_RANKS`` gloo ranks (``SPMD_CHILD``: one
``sys.executable -c`` process a rank over a ``FileStore``, no GPU, one
``torch`` thread, pinned to the last cores while this process keeps the
others, each exiting non-zero if it imported JAX or the JAX package):
each arch of ``SPMD_CHILD_ARCHS`` at ``reduce_config`` placed on a
``SPMD_MESH`` mesh of ranks, ``SPMD_STEPS`` donated AdamW steps against
the one-device step, losses and grad norms within ``SPMD_LOSS_TOL``,
parameters within ``SPMD_PARAM_TOL`` x lr, every parameter and AdamW leaf
placed by its spec, rank 0's resident bytes its ``with_shardings`` blocks
and fewer than the whole tree's; for zamba2 (its ``groups`` leaves split
on their inner layer axis) one gathered layer alive at a time in a
``loss_and_grads`` with remat "full", more with none.  (a) On the card, a
one-rank
``SPMD_BACKEND`` (NCCL) group from a ``HashStore`` and its (1, 1) mesh of
ranks (``spmd_world``): 8a's gemma2-2b (published widths, bf16, remat
"full", AdamW) for ``SPMD_STEPS`` steps plain, then sharded
(``place_state`` on the mesh: DTensors even on one rank, where
``reshard_state`` keeps the plain leaves; ``make_train_step``), the
losses, grad
norms and every leaf bit-equal, every leaf placed by its spec; one more
step of each profiled (busy share); then at ``SPMD_TRAINER_LAYERS``
layers, plain and through the ``Trainer`` (its checkpoint gathered and
written by rank 0), bit-equal.  Seconds a step, seconds in all and
``max_memory_allocated`` of each run printed.  Rehearse it on the CPU in
~60 s: ``SPMD_GEMMA2`` set to gemma2-2b's ``reduce_config`` in bf16 with
remat "full", ``GEMMA2_TRAIN_BATCH`` / ``GEMMA2_TRAIN_SEQ`` to 2 / 16,
``SPMD_BACKEND`` to ``"gloo"`` (with ``GLOO_SOCKET_IFNAME=lo``), one
``torch`` thread, ``torch.cuda.synchronize`` a no-op, then
``check_spmd(0, torch.device("cpu"), "", tmp)``.

Then the kernel JSON line, and last ``{"ok": true, "device": {...}}``.
``--kernels-only`` stops after phase 2; with ``--sweep-tiles`` it first
times every tile plan of K6/K7 (``sweep_megastep``), K1, K10, K8, K5, K9,
K4, K2 and K3 at the main path's shapes (``sweep_tiles``), the
measurements their ``tile_plan`` rests on.
Phase 1 also prints ptxas's registers, stack and spills of each kernel
(``_build.ptxas_report``) when this process built the library, and phase
5 each kernel's time call by call (K1's L0 call, with its stride-0
stimulus, and its L1 call apart).
Any failure exits non-zero before that line.  The script imports neither
JAX nor the JAX package: the machine with the card has no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from typing import NamedTuple  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.archs import (DEEPSEEK_V3_671B,  # noqa: E402
                                       GEMMA2_2B, WHISPER_BASE, XLSTM_350M,
                                       ZAMBA2_7B)
from repro_torch.configs.rsnn_timit import BASELINE, PRUNED  # noqa: E402
from repro_torch.core.artifact import (load_artifact,  # noqa: E402
                                       params_from_arrays, save_artifact)
from repro_torch.core.compression import (CompressionConfig,  # noqa: E402
                                          PruneSpec, nm_prune_mask)
from repro_torch.core.compression.quantization import (  # noqa: E402
    pack_int4, quantize_to_int)
from repro_torch.core.layouts.csc import sparsify_columns  # noqa: E402
from repro_torch.core.layouts.nm import pack_nm_groups  # noqa: E402
from repro_torch.core.rsnn import RSNNConfig  # noqa: E402
from repro_torch.core.sparse import PackedRSNN, QuantTensor  # noqa: E402
from repro_torch.core.tree import (  # noqa: E402
    tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten)

U_RTOL = 1e-5  # teacher-forced engines against ref: near the threshold
U_ATOL = 1e-5
EPS32 = 2.0 ** -24  # float32 unit roundoff: the u rule's unit (``gamma``)
TOL = 1e-5  # K8 recomputed rows, K9: |d| <= TOL * (1 + |y|), float32 sums
# (phase 9: the rule and value of tests/test_torch_kernels.py's U_TOL,
# K1's u off the threshold, and its FP32_TOL, K2 and K3)
LOGIT_ATOL = 1e-4  # kernel backends vs ref backend, teacher-forced frames
STREAMS = 512  # utterances served per configuration
SLOTS = 256  # StreamLoop batch slots
TRUNC_CAPACITY = 16  # a truncating event list: rows hold ~38-65 events
DELTA_THRESHOLD = 2.0  # LSB of the 8-bit input
MEGA_FRAMES = 4  # the longer megastep chunk (frames a launch)
# phase 4's loop: the synchronous v1 contract, stepped eagerly
V1_EAGER = {"pipeline_depth": 0, "aot_warmup": False}
NM = (2, 4)  # the N:M artifacts' FC mask: the 2 largest |w| of every 4 rows
# the artifacts, name -> (prune, fc_layout) of write_artifact: the FC pruned
# 40% at random into padded CSC, and its 2:4 mask as N:M and as CSC
ARTIFACTS = {"csc": (0.4, "csc"), "nm": (NM, "nm_group"),
             "nm as csc": (NM, "csc")}
FC_MODES = ("dense_int4", "csc", "nm")  # megastep's FC modes at int4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Peak operation rate of each kernel's operand type (H100 SXM data sheet,
# dense): K1 and K8-K10 multiply float32 dequantized weights, which
# neither TF32 nor int8 holds exactly; K2-K4 multiply 8-bit integer inputs
# or spikes by int4 weights, exact on the int8 tensor cores; so does K5.
PEAK_OPS_PER_S = {"rsnn_cell": 67e12, "int4_matmul": 1979e12,
                  "merged_spike_fc": 1979e12, "sparse_fc": 1979e12,
                  "nm_fc": 1979e12, "delta_step": 67e12, "spike_broadcast": 67e12,
                  "spike_cell": 67e12, "megastep": 67e12,
                  "megastep_spike": 67e12, "megastep_nm": 67e12,
                  "megastep_spike_nm": 67e12, "megastep_float": 67e12,
                  "megastep_spike_float": 67e12,
                  "megastep_dense_int4": 67e12,
                  "megastep_spike_dense_int4": 67e12}
INT8_OPS_PER_S = 1979e12  # K6/K7's int4 FC: integer sums of int4 weights
# kernel -> (CUDA source in csrc/, the TPU kernel's pl.pallas_call)
SOURCES = {
    "rsnn_cell": ("rsnn_cell.cu", "src/repro/kernels/rsnn_cell.py:53"),
    "int4_matmul": ("int4_matmul.cu", "src/repro/kernels/int4_matmul.py:65"),
    "merged_spike_fc": ("merged_spike_fc.cu",
                        "src/repro/kernels/merged_spike_fc.py:43"),
    "sparse_fc": ("sparse_fc.cu", "src/repro/kernels/sparse_fc.py:69"),
    "nm_fc": ("nm_fc.cu", "src/repro/kernels/nm_fc.py:77"),
    "delta_step": ("delta_step.cu", "src/repro/kernels/delta_step.py:57"),
    "spike_broadcast": ("spike_broadcast.cu",
                        "src/repro/kernels/spike_broadcast.py:132"),
    "spike_cell": ("spike_cell.cu",
                   "src/repro/kernels/spike_broadcast.py:183"),
    "megastep": ("megastep.cu", "src/repro/kernels/megastep.py:250"),
    "megastep_spike": ("megastep.cu", "src/repro/kernels/megastep.py:250"),
    "megastep_nm": ("megastep.cu", "src/repro/kernels/megastep.py:250"),
    "megastep_spike_nm": ("megastep.cu",
                          "src/repro/kernels/megastep.py:250"),
    "megastep_float": ("megastep.cu", "src/repro/kernels/megastep.py:250"),
    "megastep_spike_float": ("megastep.cu",
                             "src/repro/kernels/megastep.py:250"),
    "megastep_dense_int4": ("megastep.cu",
                            "src/repro/kernels/megastep.py:250"),
    "megastep_spike_dense_int4": ("megastep.cu",
                                  "src/repro/kernels/megastep.py:250"),
}
# K6/K7's rows of the kernel line: served with sparse_fc, the FC in
# ``csc`` over the ``csc`` artifact and in ``nm`` over the ``nm`` one;
# without it, in ``dense_int4`` over the ``csc`` artifact; and with float
# weights and the ``dense_float`` FC over the float artifact
ROW_FC_MODE = {"megastep": "csc", "megastep_spike": "csc",
               "megastep_nm": "nm", "megastep_spike_nm": "nm",
               "megastep_dense_int4": "dense_int4",
               "megastep_spike_dense_int4": "dense_int4",
               "megastep_float": "dense_float",
               "megastep_spike_float": "dense_float"}
FLOAT_ROWS = ("megastep_float", "megastep_spike_float")
# megastep's nine outputs, and the slot axis of each
MEGA_OUTS = {"s0": 1, "u0": 0, "s1": 1, "u1": 0, "logits": 1,
             "spikes_l0": 2, "spikes_l1": 2, "union_l1": 1,
             "input_one_bits": 1}
LAYERS = ("l0_wx", "l0_wh", "l1_wx", "l1_wh", "fc_w")
# uniform half-width of the float weights before int4 quantization, per
# layer, chosen so that both layers fire at moderate rates on N(0, 1)
# features quantized to 8 bits
WEIGHT_RANGE = {"l0_wx": 0.02, "l0_wh": 0.15, "l1_wx": 0.3,
                "l1_wh": 0.15, "fc_w": 0.1}
# the same for the float artifact at BASELINE width (twice the recurrent
# fan-in, beta 0.9), and its LIF parameters at the reference's init_lif
# values: raw_beta = logit(0.9), raw_vth = softplus^-1(1.0)
FLOAT_WEIGHT_RANGE = {"l0_wx": 0.02, "l0_wh": 0.1, "l1_wx": 0.3,
                      "l1_wh": 0.1, "fc_w": 0.1}
BETA_INIT, VTH_INIT = 0.9, 1.0


# ------------------------------------------------------------- the artifact


def seeded_int4(seed: int, cfg: RSNNConfig = PRUNED,
                prune: float | tuple[int, int] = 0.4
                ) -> tuple[dict, np.random.Generator]:
    """The seeded int4 weights of ``write_artifact``: name -> (q, scale,
    keep), through the port's ``quantize_to_int`` (per channel) of uniform
    weights of half-width ``WEIGHT_RANGE``; ``fc_w`` pruned (``keep``, its
    q zeroed where dropped) at random by ``prune``, or to its ``(n, m)``
    largest |w| by ``nm_prune_mask``; keep is None elsewhere.  Returns
    them and the generator drawn past them."""
    rng = np.random.default_rng(seed)
    layers = {}
    for name, (k, cols) in cfg.layer_shapes.items():
        a = WEIGHT_RANGE[name]
        w = torch.from_numpy(rng.uniform(-a, a, (k, cols)).astype(np.float32))
        q, scale = quantize_to_int(w)
        keep = None
        if name == "fc_w":
            keep = (nm_prune_mask(w, *prune).bool()
                    if isinstance(prune, tuple)
                    else torch.from_numpy(rng.random((k, cols)) >= prune))
            q = torch.where(keep, q, 0).to(torch.int8)
        layers[name] = (q, scale, keep)
    return layers, rng


def write_artifact(path: Path, seed: int, features: list[np.ndarray],
                   cfg: RSNNConfig = PRUNED,
                   prune: float | tuple[int, int] = 0.4,
                   fc_layout: str = "csc") -> Path:
    """Write a seeded int4 artifact through the port's ``save_artifact``:
    the weights of ``seeded_int4`` nibble-packed (``pack_int4``), ``fc_w``
    also stored in ``fc_layout`` (``sparsify_columns`` or
    ``pack_nm_groups``), power-of-two LIF constants, and the max-abs 8-bit
    input scale of ``features``.  ``prune`` is a fraction pruned at
    random, or ``(n, m)``: an N:M spec in the manifest."""
    nm = isinstance(prune, tuple)
    if fc_layout not in ("csc", "nm_group") or (fc_layout == "nm_group"
                                                and not nm):
        raise ValueError(f"fc_layout {fc_layout!r} with prune {prune!r}")
    layers, rng = seeded_int4(seed, cfg, prune)
    q, scale, keep = layers["fc_w"]
    fc = (pack_nm_groups(q, scale, keep, *prune) if fc_layout == "nm_group"
          else sparsify_columns(q, scale, keep))
    h = cfg.hidden_dim
    lif = {}
    for i in (0, 1):
        lif[f"beta{i}"] = torch.from_numpy(rng.choice(
            np.float32([0.5, 0.75, 0.875]), h).astype(np.float32))
        lif[f"vth{i}"] = torch.full((h,), 1.0)
    packed = PackedRSNN(
        quant={n: QuantTensor(pack_int4(q), sc)
               for n, (q, sc, _) in layers.items()},
        sparse={"fc_w": fc}, lif=lif)
    ccfg = CompressionConfig(
        fc_prune_frac=0.0 if nm else prune, weight_bits=4,
        prune_specs=((("fc_w", PruneSpec(kind="nm", n=prune[0], m=prune[1],
                                         layout=fc_layout)),) if nm else ()))
    return save_artifact(path, cfg=cfg, packed=packed, ccfg=ccfg,
                         input_scale=input_scale(features), backend="pallas")


def input_scale(features: list[np.ndarray]) -> np.ndarray:
    """The max-abs 8-bit input scale of ``features``, as the reference's
    ``calibrate_input_scale`` computes it in float32."""
    amax = max(float(np.abs(f).max()) for f in features)
    return np.asarray(np.float32(max(amax, 1e-8)) / np.float32(127.0),
                      np.float32)


def float_params(seed: int, cfg: RSNNConfig = BASELINE
                 ) -> dict[str, np.ndarray]:
    """Seeded float parameters, keyed and ordered as the reference's
    ``_flatten_params`` keys a parameter tree (sorted names, then
    ``raw_beta``, ``raw_vth``): uniform weights of half-width
    ``FLOAT_WEIGHT_RANGE`` and the LIF parameters of ``init_lif``."""
    rng = np.random.default_rng(seed + 2)
    flat: dict[str, np.ndarray] = {}
    for name in sorted(cfg.layer_shapes):
        a = FLOAT_WEIGHT_RANGE[name]
        flat[f"params['{name}']"] = rng.uniform(
            -a, a, cfg.layer_shapes[name]).astype(np.float32)
    h = cfg.hidden_dim
    for i in (0, 1):
        flat[f"params['lif{i}'].raw_beta"] = np.full(
            (h,), math.log(BETA_INIT / (1.0 - BETA_INIT)), np.float32)
        flat[f"params['lif{i}'].raw_vth"] = np.full(
            (h,), math.log(math.expm1(VTH_INIT)), np.float32)
    return flat


def write_float_artifact(path: Path, seed: int, features: list[np.ndarray],
                         cfg: RSNNConfig = BASELINE) -> Path:
    """Write a seeded float artifact through the port's ``save_artifact``
    (``params=...``, ``input_scale=...``, ``backend="pallas"``):
    ``float_params`` and the max-abs 8-bit input scale of ``features``."""
    return save_artifact(path, cfg=cfg,
                         params=params_from_arrays(float_params(seed, cfg),
                                                   cfg),
                         input_scale=input_scale(features), backend="pallas")


def utterances(seed: int, count: int, cfg: RSNNConfig = PRUNED
               ) -> list[np.ndarray]:
    """``count`` seeded N(0, 1) feature sequences of 40-100 frames."""
    rng = np.random.default_rng(seed + 1)
    return [rng.standard_normal((int(t), cfg.input_dim)).astype(np.float32)
            for t in rng.integers(40, 101, size=count)]


# -------------------------------------------------------- kernel checks


def lif_trace(stim: torch.Tensor, rec: torch.Tensor, u0, h0, beta, vth):
    """Per-time-step membrane potentials of the plain LIF chain
    (``rsnn_cell_ref``'s order), in the inputs' dtype."""
    u, h, trace = u0, h0, []
    for t in range(stim.shape[0]):
        u = (stim[t] + rec[t]) + beta * u * (1.0 - h)
        h = (u >= vth).to(u.dtype)
        trace.append(u)
    return torch.stack(trace)


def gamma(n: int) -> float:
    """The rounding bound, relative to the summands' magnitude, of a float32
    sum of ``n`` terms in any order, with three operations to spare (the
    dequantized weight, the beta product, the last add): (n + 3) 2^-24.
    A correct float32 kernel cannot exceed it (to first order)."""
    return (n + 3) * EPS32


def lif_bound(stim, rec, mag, u0, h0, beta, vth, a0=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain chain replayed in float64 (``lif_trace`` on float64
    inputs) and, per time step, the magnitude ``A`` that bounds a float32
    chain's error: ``A_t = mag_t + beta (1 - h_{t-1}) (|u_{t-1}| +
    A_{t-1})``, where ``mag`` is the sum of the step's |products| and
    |stimulus| (``|x| @ |W_x| + |s| @ |W_h|``), and the carried term adds
    the bound of u_{t-1}'s own error.  ``a0`` is the initial potential's
    (None: an exact input, 0).  Returns (u, A), each (TS, B, H)."""
    trace = lif_trace(stim, rec, u0, h0, beta, vth)
    a = torch.zeros_like(u0) if a0 is None else a0
    u, h, bounds = u0, h0, []
    for t in range(trace.shape[0]):
        a = mag[t] + beta * (1.0 - h) * (u.abs() + a)
        bounds.append(a)
        u = trace[t]
        h = (u >= vth).to(u.dtype)
    return trace, torch.stack(bounds)


def note_ratio(errs: dict | None, row: str, du: torch.Tensor,
               a: torch.Tensor) -> None:
    """Keep in ``errs`` the largest |du| / (2^-24 A) of ``row`` (under
    ``"<row> |du|/(2^-24 A)"``): how far under (n + 3) it runs."""
    if errs is None or not du.numel():
        return
    ratio = torch.where(du == 0, 0.0, du / (EPS32 * a))
    key = f"{row} |du|/(2^-24 A)"
    errs[key] = max(errs.get(key, 0.0), float(ratio.max()))


def check_u(name: str, u32: torch.Tensor, u64: torch.Tensor,
            bound: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """|u32 - u64| <= bound (= gamma(n) A) on every element given;
    returns |du|."""
    du = (u32.double() - u64).abs()
    over = du > bound
    if bool(over.any()):
        i = int(torch.argmax(du - bound))
        raise AssertionError(
            f"{name}: {int(over.sum())} of {du.numel()} over the u rule, "
            f"the worst at u {float(u64.flatten()[i])!r}: |du| "
            f"{float(du.flatten()[i])!r}, allowed "
            f"{float(bound.flatten()[i])!r} (A "
            f"{float(a.flatten()[i])!r})")
    return du


def check_cell(name, got, want, stim, x, w, u0, h0, beta, vth,
               errs: dict | None = None) -> float:
    """K1/K10 and their plain version against the chain replayed in float64
    (``lif_bound``) over the rows ``x`` (TS x B, H) the recurrent product
    reads (K10's truncated to its capacity): a spike may differ from the
    replay's only where |u64 - vth| <= gamma(H + 2) A at some time step;
    elsewhere |u - u64| <= gamma(H + 2) A (the stimulus, the H products,
    the decayed potential).  Returns the largest |du| of the kernel
    against the plain version there."""
    ts, b, h = want[0].shape
    d = [t.double() for t in (stim, x, w, u0, h0, beta, vth)]
    stim64, x64, w64, u64_0, h64_0, beta64, vth64 = d
    rec = (x64 @ w64).reshape(ts, b, h)
    mag = stim64.abs() + (x64 @ w64.abs()).reshape(ts, b, h)
    trace, a = lif_bound(stim64, rec, mag, u64_0, h64_0, beta64, vth64)
    bound = gamma(h + 2) * a
    near = ((trace - vth64).abs() <= bound).any(dim=0)
    spikes = trace >= vth64
    ok = ~near
    for who, (s_, u_) in (("", got), (" plain", want)):
        flipped = (s_.bool() != spikes).any(dim=0)
        if bool((flipped & ~near).any()):
            raise AssertionError(f"{name}{who}: a spike differs from the "
                                 f"float64 replay away from the threshold")
        ok &= ~flipped
        du = check_u(f"{name}{who}", u_[ok], trace[-1][ok], bound[-1][ok],
                     a[-1][ok])
        note_ratio(errs, f"{name}{who}", du, a[-1][ok])
    diff = (got[1] - want[1]).abs()[ok]
    return float(diff.max()) if diff.numel() else 0.0


def check_close(name, got, want) -> float:
    """``|got - want| <= TOL * (1 + |want|)`` everywhere; returns the
    largest |difference|."""
    d = (got - want).abs()
    if bool((d > TOL * (1.0 + want.abs())).any()):
        raise AssertionError(f"{name}: |diff| up to {float(d.max())}")
    return float(d.max()) if d.numel() else 0.0


def check_delta(got, want, x, x_prev, pre_prev, w, thr) -> float:
    """K8: mask and x_hat exact, a row that propagated nothing bit-equal
    to ``pre_prev``, a recomputed row within ``TOL``."""
    (xh_k, pre_k, m_k), (xh_p, pre_p, m_p) = got, want
    if not (torch.equal(m_k, m_p) and torch.equal(xh_k, xh_p)):
        raise AssertionError("delta_step: mask or x_hat differ")
    held = ~m_p.bool().any(dim=1)
    if not torch.equal(pre_k[held], pre_prev[held]):
        raise AssertionError("delta_step: a cached row is not pre_prev")
    return check_close("delta_step", pre_k[~held], pre_p[~held])


def kernel_inputs(packs: dict, b: int, gen: torch.Generator, dev) -> dict:
    """Main-path operands for batch ``b``: int4 weights of the ``csc``
    artifact, the 2:4 FC of the N:M artifacts (``nm``, and ``csc_nm``: the
    same mask as padded CSC), 8-bit integer inputs, random 0/1 spikes and membrane
    state, and for K8 a previous frame whose rows repeat (every 4th), move
    by at most ``DELTA_THRESHOLD`` LSB (every 4th, one further) or
    change."""
    from repro_torch.core.sparse import dequantize

    cfg = PRUNED
    ts, h, d = cfg.num_ts, cfg.hidden_dim, cfg.input_dim
    packed = packs["csc"]

    def spikes(*shape):
        return (torch.rand(shape, generator=gen) < 0.3).float().to(dev)

    def q(name):
        return packed.quant[name].packed.to(dev), \
            packed.quant[name].scale.reshape(-1).to(dev)

    def w(name):
        return dequantize(packed.quant[name]).to(dev)

    x = torch.randint(-128, 128, (b, d), generator=gen).float()
    x_prev = torch.randint(-128, 128, (b, d), generator=gen).float()
    x_prev[0::4] = x[0::4]
    x_prev[1::4] = x[1::4] + torch.randint(
        -int(DELTA_THRESHOLD), int(DELTA_THRESHOLD) + 1,
        x[1::4].shape, generator=gen).float()
    ff0 = (torch.randn((b, h), generator=gen) * 0.8).to(dev)
    csc = packed.sparse["fc_w"]
    nm, csc_nm = (packs[k].sparse["fc_w"] for k in ("nm", "nm as csc"))
    return {
        "x": x.to(dev), "x_prev": x_prev.to(dev),
        "pre_prev": torch.randn((b, h), generator=gen).to(dev),
        "l0": q("l0_wx"), "l1": q("l1_wx"), "fc": q("fc_w"),
        "csc": (csc.indices.to(dev), csc.values.to(dev),
                csc.scale.reshape(-1).to(dev)),
        "nm": (nm.packed.to(dev), nm.scale.reshape(-1).to(dev)),
        "csc_nm": (csc_nm.indices.to(dev), csc_nm.values.to(dev),
                   csc_nm.scale.reshape(-1).to(dev)),
        "stim0": ff0.unsqueeze(0).expand(ts, b, h),
        "stim1": (torch.randn((ts, b, h), generator=gen) * 0.8).to(dev),
        "s0": spikes(ts, b, h), "s1": spikes(ts, b, h),
        "w0x": w("l0_wx"), "w1x": w("l1_wx"), "wfc": w("fc_w"),
        "w0h": w("l0_wh"), "w1h": w("l1_wh"),
        "u0": torch.randn((b, h), generator=gen).to(dev),
        "h0": spikes(b, h),
        "beta": packed.lif["beta0"].to(dev), "vth": packed.lif["vth0"].to(dev),
        # megastep: MEGA_FRAMES frames, the L1 carries, all LIF constants
        # and the packed layer weights
        "xf": torch.randint(-128, 128, (MEGA_FRAMES, b, d),
                            generator=gen).float().to(dev),
        "u1": torch.randn((b, h), generator=gen).to(dev),
        "h1": spikes(b, h),
        "lif": tuple(packed.lif[k].to(dev)
                     for k in ("beta0", "vth0", "beta1", "vth1")),
        "wq": tuple(t for n in ("l0_wx", "l0_wh", "l1_wx", "l1_wh")
                    for t in q(n)),
    }


def float_kernel_inputs(params: dict, b: int, gen: torch.Generator,
                        dev) -> dict:
    """The float engine's operands for batch ``b`` at the width of
    ``params`` (a ``float_params`` dict): its float32 weights and the LIF
    constants of its raw parameters, 8-bit integer inputs, random 0/1
    spikes and membrane state, and for K8 a previous frame as in
    ``kernel_inputs``.  Holds the keys that K1, K8-K10 (``float_calls``)
    and K6/K7 (``megastep_args`` in ``dense_float``) read."""
    from repro_torch.core.lif import LIFParams, inference_constants

    def w(name):
        return torch.from_numpy(params[f"params['{name}']"]).to(dev)

    d, h = w("l0_wx").shape
    ts = PRUNED.num_ts

    def spikes(*shape):
        return (torch.rand(shape, generator=gen) < 0.3).float().to(dev)

    lif = []
    for i in (0, 1):
        lp = LIFParams(*(torch.from_numpy(params[f"params['lif{i}'].{f}"])
                         .to(dev) for f in LIFParams._fields))
        lif += inference_constants(lp)
    x = torch.randint(-128, 128, (b, d), generator=gen).float()
    x_prev = torch.randint(-128, 128, (b, d), generator=gen).float()
    x_prev[0::4] = x[0::4]
    x_prev[1::4] = x[1::4] + torch.randint(
        -int(DELTA_THRESHOLD), int(DELTA_THRESHOLD) + 1,
        x[1::4].shape, generator=gen).float()
    ff0 = (torch.randn((b, h), generator=gen) * 0.8).to(dev)
    return {
        "x": x.to(dev), "x_prev": x_prev.to(dev),
        "pre_prev": torch.randn((b, h), generator=gen).to(dev),
        "stim0": ff0.unsqueeze(0).expand(ts, b, h),
        "stim1": (torch.randn((ts, b, h), generator=gen) * 0.8).to(dev),
        "s0": spikes(ts, b, h), "s1": spikes(ts, b, h),
        "w0x": w("l0_wx"), "w1x": w("l1_wx"), "wfc": w("fc_w"),
        "w0h": w("l0_wh"), "w1h": w("l1_wh"),
        "u0": torch.randn((b, h), generator=gen).to(dev),
        "h0": spikes(b, h), "beta": lif[0], "vth": lif[1],
        "xf": torch.randint(-128, 128, (MEGA_FRAMES, b, d),
                            generator=gen).float().to(dev),
        "u1": torch.randn((b, h), generator=gen).to(dev),
        "h1": spikes(b, h), "lif": tuple(lif),
        "wq": tuple(w(n) for n in ("l0_wx", "l0_wh", "l1_wx", "l1_wh")),
        "fc_float": (w("fc_w"),),
    }


def megastep_args(a: dict, frames: int, fc_mode: str) -> tuple:
    """megastep's operands from ``kernel_inputs`` (the FC as dense int4
    nibbles, padded CSC or 2:4 N:M) or ``float_kernel_inputs`` (float
    layer weights, the FC as ``dense_float``): the first ``frames``
    frames."""
    fc = a[{"dense_int4": "fc", "csc": "csc", "nm": "nm",
            "dense_float": "fc_float"}[fc_mode]]
    return (a["xf"][:frames], a["s0"], a["u0"], a["h0"], a["s1"], a["u1"],
            a["h1"], *a["lif"], a["wq"], fc)


def megastep_pair(fc_mode: str, spike: bool):
    """(kernel, plain version) of K6 (``spike=False``) or K7 in one FC
    mode (``dense_float`` with float weights, the others with int4).
    Imported late, as ``kernel_calls``."""
    from repro_torch.kernels import megastep, ref

    kw = {"fc_mode": fc_mode, "input_bits": PRUNED.input_bits,
          "spike": spike,
          "precision": "float" if fc_mode == "dense_float" else "int4"}
    if fc_mode == "nm":
        kw.update(nm_n=NM[0], nm_m=NM[1])
    return (functools.partial(megastep.megastep, **kw),
            functools.partial(ref.megastep_ref, **kw))


def mega_shape(args, fc_mode: str, spike: bool) -> tuple:
    """The shape ``megastep.resident_plan`` and ``plan_info`` take for a
    call on ``args``: (ts, b, d, h, precision, fc_mode, entries, nm_n,
    nm_m, spike)."""
    x, s0, *_, fc = args
    ts, b, h = s0.shape
    entries = fc[0].shape[0] if fc_mode in ("csc", "nm") else 0
    nm = NM if fc_mode == "nm" else (0, 0)
    return (ts, b, x.shape[2], h,
            "float" if fc_mode == "dense_float" else "int4", fc_mode,
            entries, *nm, spike)


def plan_text(plan, args, fc_mode: str, spike: bool) -> str:
    """A K6/K7 plan as phase 5 and the sweep print it: slots x CTAs a
    cluster x FC columns a sub-tile, the grid's CTAs, a CTA's shared
    bytes and the clusters the card holds at once.  Raises unless the
    launch's shared bytes are the ones ``tile_plans`` computed."""
    from repro_torch.kernels import megastep

    ts, b, d, h, prec, mode, entries, nm_n, nm_m, sp = mega_shape(
        args, fc_mode, spike)
    smem, clusters = megastep.plan_info(plan, ts, b, d, h, prec, mode,
                                        entries, nm_n, nm_m, sp)
    if smem != plan.shared_bytes:
        raise AssertionError(f"megastep plan {plan}: the launch takes "
                             f"{smem} B of shared memory a CTA")
    return (f"{plan.rows}x{plan.cluster}x{plan.cols} ({plan.ctas} CTAs, "
            f"{smem} B shared, {clusters} clusters resident)")


def mega_row(name: str, fc_mode: str) -> str:
    """The kernel line's row of K6/K7 (``name``) in ``fc_mode``."""
    return {"nm": f"{name}_nm", "dense_int4": f"{name}_dense_int4",
            "dense_float": f"{name}_float"}.get(fc_mode, name)


def kernel_calls(a: dict, capacity: int | None = None,
                 threshold: float = DELTA_THRESHOLD) -> dict:
    """Each kernel's calls of one frame on operands ``a``: name ->
    list of (kernel, plain, args).  K9/K10 run at event-list ``capacity``
    (``None``: lossless, as served), K8 at ``threshold``; K9's two calls
    are those of a ``spike`` frame without ``sparse_fc`` (L1 feedforward,
    FC union).  Over ``kernel_inputs`` every kernel, K6/K7 as served with
    int4 weights; over ``float_kernel_inputs`` the kernels the float
    engine runs: K1, K8-K10 and K6/K7 in ``dense_float``.  Imported late:
    the module needs the package on ``sys.path``."""
    from repro_torch.kernels import (delta_step, int4_matmul,
                                     merged_spike_fc, nm_fc, ref, rsnn_cell,
                                     sparse_fc, spike_broadcast)

    int4 = "l0" in a
    cell = (a["u0"], a["h0"], a["beta"], a["vth"])
    cap = {"capacity": capacity}
    sb = functools.partial(spike_broadcast.spike_broadcast, **cap)
    sb_ref = functools.partial(ref.spike_broadcast_ref, **cap)
    sc = functools.partial(spike_broadcast.spike_cell, **cap)
    sc_ref = functools.partial(ref.spike_cell_ref, **cap)
    s0_rows = a["s0"].reshape(-1, a["s0"].shape[-1])
    calls = {
        "rsnn_cell": [
            (rsnn_cell.rsnn_cell, ref.rsnn_cell_ref,
             (a["stim0"], a["s0"], a["w0h"], *cell)),
            (rsnn_cell.rsnn_cell, ref.rsnn_cell_ref,
             (a["stim1"], a["s1"], a["w1h"], *cell))]}
    if int4:
        calls.update({
            "int4_matmul": [
                (int4_matmul.int4_matmul, ref.int4_matmul_ref,
                 (a["x"], *a["l0"])),
                (int4_matmul.int4_matmul, ref.int4_matmul_ref,
                 (s0_rows, *a["l1"]))],
            "merged_spike_fc": [
                (merged_spike_fc.merged_spike_fc, ref.merged_spike_fc_ref,
                 (a["s1"], *a["fc"]))],
            "sparse_fc": [
                (sparse_fc.sparse_fc, ref.sparse_fc_ref,
                 (a["s1"], *a["csc"]))],
            "nm_fc": [
                (functools.partial(nm_fc.nm_fc, n=NM[0], m=NM[1]),
                 functools.partial(ref.nm_fc_ref, n=NM[0], m=NM[1]),
                 (a["s1"], *a["nm"]))]})
    calls.update({
        "delta_step": [
            (delta_step.delta_step, ref.delta_step_ref,
             (a["x"], a["x_prev"], a["pre_prev"], a["w0x"], threshold))],
        "spike_broadcast": [
            (sb, sb_ref, (s0_rows, a["w1x"])),
            (sb, sb_ref, (a["s1"], a["wfc"]))],
        "spike_cell": [
            (sc, sc_ref, (a["stim0"], a["s0"], a["w0h"], *cell)),
            (sc, sc_ref, (a["stim1"], a["s1"], a["w1h"], *cell))]})
    # a frame of fused / fused_spike as served (int4: with sparse_fc)
    calls.update({
        row: [(*megastep_pair(mode, row.startswith("megastep_spike")),
               megastep_args(a, 1, mode))]
        for row, mode in ROW_FC_MODE.items() if (row in FLOAT_ROWS) != int4})
    return calls


def check_call(name, got, want, args, capacity,
               errs: dict | None = None) -> float:
    """One kernel call against its plain version; returns its error.
    K1/K10 note their u rule's ratio in ``errs`` (``check_cell``)."""
    if name in ("rsnn_cell", "spike_cell"):
        stim, s, w, *cell = args
        ts, b, h = s.shape
        x = kept_events(s.reshape(ts * b, h),
                        capacity if name == "spike_cell" else None)
        return check_cell(name, got, want, stim, x, w, *cell, errs=errs)
    if name == "delta_step":
        return check_delta(got, want, *args)
    if name == "spike_broadcast":
        return check_close(name, got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to its plain version: "
                             f"max |diff| {float((got - want).abs().max())}")
    return 0.0


class Replay(NamedTuple):
    """K6/K7's plain chain over a chunk replayed in float64
    (``megastep_replay``): per slot whether a neuron comes within the u
    rule of its threshold (``near``); the last frame's trains ``s`` and
    potentials ``u`` of L0 and L1 with their bounds (gamma(n) A); and with
    float FC weights the logits of every frame and their bounds."""

    near: torch.Tensor  # (B,) bool
    s: tuple  # (TS, B, H) bool, L0 and L1
    u: tuple  # (B, H) float64
    a: tuple  # (B, H) magnitudes A
    bound: tuple  # (B, H) gamma(n) A
    logits: torch.Tensor | None  # (F, B, N) float64
    logit_a: torch.Tensor | None  # (F, B, N) sum |merged spikes x w|
    logit_bound: torch.Tensor | None


def megastep_replay(args) -> Replay:
    """The plain chain over ``args`` replayed frame by frame in float64
    (``lif_bound``, the potential's magnitude carried across frames), the
    int4 weights dequantized exactly (q x scale in float64).  L0 sums
    D + H + 1 terms (the feed-forward, the recurrent products, the decayed
    potential), L1 2H + 1; a float FC sums TS x H (a kernel may sum each
    time step's train apart)."""
    from repro_torch.kernels.ref import unpack_int4_ref

    x, s0, u0, h0, s1, u1, h1, beta0, vth0, beta1, vth1, wq, fc = args
    if len(wq) == 4:  # float weights
        w0x, w0h, w1x, w1h = (w.double() for w in wq)
    else:
        w0x, w0h, w1x, w1h = (unpack_int4_ref(q).double() * sc.double()
                              for q, sc in zip(wq[0::2], wq[1::2]))
    fc_w = fc[0].double() if len(fc) == 1 else None  # dense_float
    ts, b, h = s0.shape
    g0, g1 = gamma(x.shape[2] + h + 1), gamma(2 * h + 1)
    s0, s1, u0, h0, u1, h1, b0, v0, b1, v1 = (
        t.double() for t in (s0, s1, u0, h0, u1, h1, beta0, vth0, beta1,
                             vth1))
    a0 = a1 = None
    near = torch.zeros(b, dtype=torch.bool, device=x.device)
    logits, logit_a = [], []
    for xf in x.double():
        stim0 = (xf @ w0x).unsqueeze(0).expand(ts, b, h)
        mag0 = (xf.abs() @ w0x.abs()).unsqueeze(0) + s0 @ w0h.abs()
        tr0, at0 = lif_bound(stim0, s0 @ w0h, mag0, u0, h0, b0, v0, a0)
        s0 = (tr0 >= v0).double()
        rows0 = s0.reshape(ts * b, h)
        stim1 = (rows0 @ w1x).reshape(ts, b, h)
        mag1 = (rows0 @ w1x.abs()).reshape(ts, b, h) + s1 @ w1h.abs()
        tr1, at1 = lif_bound(stim1, s1 @ w1h, mag1, u1, h1, b1, v1, a1)
        s1 = (tr1 >= v1).double()
        for tr, at, vth, g in ((tr0, at0, v0, g0), (tr1, at1, v1, g1)):
            near |= ((tr - vth).abs() <= g * at).any(dim=0).any(dim=1)
        u0, h0, a0 = tr0[-1], s0[-1], at0[-1]
        u1, h1, a1 = tr1[-1], s1[-1], at1[-1]
        if fc_w is not None:
            merged = s1.sum(dim=0)
            logits.append(merged @ fc_w)
            logit_a.append(merged @ fc_w.abs())
    lg = la = lb = None
    if fc_w is not None:
        lg, la = torch.stack(logits), torch.stack(logit_a)
        lb = gamma(ts * h) * la
    return Replay(near=near, s=(s0.bool(), s1.bool()), u=(u0, u1),
                  a=(a0, a1), bound=(g0 * a0, g1 * a1), logits=lg,
                  logit_a=la, logit_bound=lb)


def check_mega(name, got, want, rep: Replay, float_fc: bool = False,
               errs: dict | None = None, row: str | None = None
               ) -> dict[str, float]:
    """K6/K7 against their plain version over a chunk, on the slots away
    from the threshold (``~rep.near``): spikes, counters and int4 logits
    bit-equal, the input one-bits bit-equal on every slot; the kernel's
    and the plain version's last trains equal the float64 replay's
    (``megastep_replay``), their u within gamma(n) A of its u and, with a
    float FC (``float_fc``), their logits within gamma(TS H) sum |s w| of
    its logits.  Notes each rule's ratio in ``errs`` under ``row``.
    Returns each output's largest |kernel - plain| there."""
    keep = ~rep.near
    row = row or name
    diffs = {}
    for (out, axis), g, w in zip(MEGA_OUTS.items(), got, want):
        if out == "input_one_bits":
            gk, wk = g, w
        else:
            gk, wk = (t.transpose(0, axis)[keep] for t in (g, w))
        d = (gk - wk).abs()
        diffs[out] = float(d.max()) if d.numel() else 0.0
        if out in ("u0", "u1"):
            i = int(out[1])
            for who, t in (("", gk), (" plain", wk)):
                du = check_u(f"{name}{who} {out}", t, rep.u[i][keep],
                             rep.bound[i][keep], rep.a[i][keep])
                note_ratio(errs, f"{row}{who} {out}", du, rep.a[i][keep])
            continue
        if out in ("s0", "s1"):
            want_s = rep.s[int(out[1])].transpose(0, 1)[keep]
            for who, t in (("", gk), (" plain", wk)):
                if not torch.equal(t.bool(), want_s):
                    raise AssertionError(f"{name}{who}: {out} differs from "
                                         f"the float64 replay away from "
                                         f"the threshold")
        if out == "logits" and float_fc:
            lg, la, lb = (t.transpose(0, 1)[keep] for t in (
                rep.logits, rep.logit_a, rep.logit_bound))
            for who, t in (("", gk), (" plain", wk)):
                du = check_u(f"{name}{who} logits", t, lg, lb, la)
                note_ratio(errs, f"{row}{who} logits", du, la)
        elif not torch.equal(gk, wk):
            raise AssertionError(f"{name}: {out} differs away from the "
                                 f"threshold by up to {diffs[out]}")
    return diffs


def check_megastep(a: dict, b: int, errs: dict,
                   fc_modes: tuple = FC_MODES, width: str = "") -> None:
    """Phase 2 for K6 and K7: the FC modes ``fc_modes`` (the three int4
    ones, or ``dense_float`` with float weights), chunks of 1 and
    ``MEGA_FRAMES`` frames, each against its plain version, and K7
    against K6 bit for bit."""
    for fc_mode in fc_modes:
        for frames in (1, MEGA_FRAMES):
            args = megastep_args(a, frames, fc_mode)
            rep = megastep_replay(args)
            outs = {}
            for spike in (False, True):
                name = "megastep_spike" if spike else "megastep"
                kern, plain = megastep_pair(fc_mode, spike)
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                row = mega_row(name, fc_mode)
                e = check_mega(f"{name}{width} B={b} fc_mode={fc_mode} "
                               f"F={frames}", got, want, rep,
                               fc_mode == "dense_float", errs, row)
                errs[row] = max(errs.get(row, 0.0), *e.values())
                differs = torch.zeros_like(rep.near)
                for (out, axis), g, w in zip(MEGA_OUTS.items(), got, want):
                    if out not in ("u0", "u1", "input_one_bits"):
                        differs |= (g != w).transpose(0, axis).reshape(
                            b, -1).any(dim=1)
                print(f"check {name}{width} B={b} fc_mode={fc_mode} "
                      f"F={frames}: "
                      f"ok, slots near the threshold {int(rep.near.sum())} "
                      f"(differing {int(differs.sum())}), max_abs_err "
                      f"{e!r}")
                outs[spike] = got
            if not all(torch.equal(p, q) for p, q in zip(outs[True],
                                                          outs[False])):
                raise AssertionError(f"megastep{width} B={b} fc_mode="
                                     f"{fc_mode} F={frames}: K7 differs "
                                     f"from K6")
            print(f"check megastep_spike == megastep{width} B={b} "
                  f"fc_mode={fc_mode} F={frames}: bit-equal")


EDGE_B = (256, 200, 1)  # megastep edges: slots (32-slot tiles, ragged)
EDGE_H = (128, 256, 100)  # hidden widths (100: not a multiple of a cluster)
EDGE_TS = (1, 2, 4)


def megastep_edge_args(params: dict, fc_mode: str, b: int, h: int, ts: int,
                       n: int, frames: int, rng: np.random.Generator,
                       dev) -> tuple:
    """megastep's operands at an edge shape: the float weights of
    ``params`` (``float_params`` at ``BASELINE``) cut to ``h`` hidden and
    ``n`` FC columns, as float32 (``dense_float``) or quantized to int4
    (the FC as dense nibbles, padded CSC of a random 75% prune, or N:M
    ``NM`` of its largest |w|); 8-bit integer frames, random 0/1 trains
    and last spikes whose first slot row is all zeros and second full
    (where b > 1), random potentials, beta in [0.5, 0.95] and vth in
    [0.5, 1.5]."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def spikes(*shape):
        s = (rng.random(shape) < 0.3).astype(np.float32)
        if b > 1:
            s[..., 0, :], s[..., 1, :] = 0.0, 1.0
        return s

    ws = [params[f"params['{name}']"] for name in LAYERS]
    d = ws[0].shape[0]
    ws = [ws[0][:, :h]] + [w[:h, :h] for w in ws[1:4]] + [ws[4][:h, :n]]
    x = rng.integers(-128, 128, (frames, b, d)).astype(np.float32)
    state = (t(x), t(spikes(ts, b, h)),
             t(rng.standard_normal((b, h), dtype=np.float32)),
             t(spikes(b, h)), t(spikes(ts, b, h)),
             t(rng.standard_normal((b, h), dtype=np.float32)),
             t(spikes(b, h)))
    lif = tuple(t(a) for _ in range(2) for a in (
        0.5 + 0.45 * rng.random(h, dtype=np.float32),
        0.5 + rng.random(h, dtype=np.float32)))
    if fc_mode == "dense_float":
        return (*state, *lif, tuple(t(w) for w in ws[:4]), (t(ws[4]),))
    wq = []
    for w in ws[:4]:
        q, sc = quantize_to_int(torch.from_numpy(np.ascontiguousarray(w)))
        wq += [pack_int4(q).to(dev), sc.reshape(-1).to(dev)]
    w_fc = torch.from_numpy(np.ascontiguousarray(ws[4]))
    q, scale = quantize_to_int(w_fc)
    sc = scale.reshape(-1).to(dev)
    if fc_mode == "dense_int4":
        fc = (pack_int4(q).to(dev), sc)
    elif fc_mode == "csc":
        keep = torch.from_numpy(rng.random(tuple(q.shape)) >= 0.75)
        c = sparsify_columns(torch.where(keep, q, 0).to(torch.int8), scale,
                             keep)
        fc = (c.indices.to(dev), c.values.to(dev), sc)
    else:
        keep = nm_prune_mask(w_fc, *NM).bool()
        fc = (pack_nm_groups(torch.where(keep, q, 0).to(torch.int8), scale,
                             keep, *NM).packed.to(dev), sc)
    return (*state, *lif, tuple(wq), fc)


def check_megastep_edges(params: dict, dev, seed: int, errs: dict,
                         sizes=(EDGE_B, EDGE_H, EDGE_TS)) -> None:
    """K6 and K7 at the edges of their plans (``megastep_edge_args``), in
    every FC mode at its precision: each (B, H, TS) of ``sizes`` (by
    default B = 256, 200 and 1; H = 128, 256 and 100; TS = 1, 2 and 4),
    N = 1920 and 203 and F = 1 and ``MEGA_FRAMES`` in turn, each held
    against its plain version by ``check_mega``'s rule and K7 against K6
    bit for bit."""
    rng = np.random.default_rng(seed + 11)
    for fc_mode in (*FC_MODES, "dense_float"):
        cases = list(itertools.product(*sizes))
        for i, (b, h, ts) in enumerate(cases):
            n = 203 if i % 2 else 1920
            frames = MEGA_FRAMES if i % 3 == 0 else 1
            args = megastep_edge_args(params, fc_mode, b, h, ts, n, frames,
                                      rng, dev)
            rep = megastep_replay(args)
            outs = []
            for spike in (False, True):
                name = "megastep_spike" if spike else "megastep"
                kern, plain = megastep_pair(fc_mode, spike)
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                row = mega_row(name, fc_mode)
                e = check_mega(f"{name} B={b} H={h} TS={ts} N={n} "
                               f"F={frames} fc_mode={fc_mode}", got, want,
                               rep, fc_mode == "dense_float", errs, row)
                errs[row] = max(errs.get(row, 0.0), *e.values())
                outs.append(got)
            if not all(torch.equal(p, q) for p, q in zip(*outs)):
                raise AssertionError(f"megastep B={b} H={h} TS={ts} N={n} "
                                     f"F={frames} fc_mode={fc_mode}: K7 "
                                     f"differs from K6")
        print(f"check megastep, megastep_spike edges fc_mode={fc_mode}: "
              f"{len(cases)} cases (B = {sizes[0]}, H = {sizes[1]}, TS = "
              f"{sizes[2]}; N = 1920, 203; F = 1, {MEGA_FRAMES}): ok, K7 "
              f"bit-equal to K6, max_abs_err "
              f"{errs[mega_row('megastep', fc_mode)]!r}, "
              f"{errs[mega_row('megastep_spike', fc_mode)]!r}")


def refused(fn, args: tuple, want: int, kernel: str, what: str) -> None:
    """``fn(*args)``, a launch function given no operands, must return the
    negative status ``want`` (it refuses before it reads an operand or
    launches), and ``_build.check`` must raise on it."""
    from repro_torch.kernels import _build

    status = fn(*args)
    if status != want:
        raise AssertionError(f"{kernel}_launch({what}) returned {status}, "
                             f"expected {want}")
    try:
        _build.check(status, kernel)
    except RuntimeError as err:
        text = str(err)
    else:
        raise AssertionError(f"status {status} did not raise")
    print(f"check {kernel} refuses {what}: {text}")


def check_refusals() -> None:
    """The mega-step's launch function refuses, with its negative status,
    TS over kMaxTs (-1), a CTA's shared memory over 227 KB (-2: a CSC FC
    of 4,096 entries a column, whose 16-column sub-tile alone takes 1 MB),
    a hidden width over kMaxMegaHidden, 256 (-4), an FC mode it does not
    serve or not at the weights' precision (-5: an unknown mode; float
    weights with an int4 layout's FC; int4 weights with dense_float; an
    unknown precision), an N:M geometry it cannot take (-6: n > m; entries
    not a multiple of n) and a plan it does not take (-7: 16 slots, a
    cluster of 4, 48 columns a sub-tile); K5 refuses n < 1 and m > 16
    (-6); K1 and K10 refuse TS over kMaxTs (-1), K10 a capacity below 1
    (-3); K1, K9, K4, K5, K2, K3, K10 and K8 refuse a tile plan they do not
    take (-7: K10 a partial group of rows, more than eight groups, 48
    neurons; K8 16 or 48 columns, under a warp, over 32 rows) and one whose
    tiles pass 227 KB of shared memory (-2)."""
    from repro_torch.kernels import (_build, delta_step, int4_matmul,
                                     megastep, merged_spike_fc, nm_fc,
                                     rsnn_cell, sparse_fc, spike_broadcast)

    fn = _build.function("megastep_launch", megastep._ARGS)
    d, fc, nnz = PRUNED.input_dim, PRUNED.fc_dim, 95
    i4, f32 = megastep.PRECISIONS["int4"], megastep.PRECISIONS["float"]
    modes = megastep.FC_MODES
    plan = (megastep.SLOTS, 16, 64)
    cases = [  # (status, precision, fc_mode, ts, h, spike, nm, entries, plan)
        (-1, i4, 1, 5, 128, 0, (0, 0), nnz, plan),
        (-2, i4, 1, 2, 128, 1, (0, 0), 4096, (megastep.SLOTS, 16, 16)),
        (-4, i4, 1, 2, 258, 0, (0, 0), nnz, plan),
        (-5, i4, 7, 2, 128, 0, (0, 0), nnz, plan),
        (-5, f32, modes["csc"], 2, 256, 0, (0, 0), nnz, plan),
        (-5, f32, modes["dense_int4"], 2, 256, 1, (0, 0), nnz, plan),
        (-5, i4, modes["dense_float"], 2, 128, 0, (0, 0), nnz, plan),
        (-5, 2, modes["dense_float"], 2, 256, 0, (0, 0), nnz, plan),
        (-6, i4, 2, 2, 128, 0, (3, 2), nnz, plan),
        (-6, i4, 2, 2, 128, 1, NM, nnz, plan),
        (-7, i4, 1, 2, 128, 0, (0, 0), nnz, (16, 16, 64)),
        (-7, i4, 1, 2, 128, 0, (0, 0), nnz, (megastep.SLOTS, 4, 64)),
        (-7, i4, 1, 2, 128, 0, (0, 0), nnz, (megastep.SLOTS, 16, 48))]
    for want, prec, mode, ts, h, spike, (nm_n, nm_m), entries, p in cases:
        refused(fn, (*[None] * 19, prec, mode, *[None] * 12, 1, ts, SLOTS,
                     d, h, fc, entries, nm_n, nm_m, PRUNED.input_bits, spike,
                     *p, None),
                want, "megastep", f"precision={prec}, fc_mode={mode}, "
                f"ts={ts}, h={h}, spike={spike}, nm={nm_n}:{nm_m}, "
                f"entries={entries}, plan={p}")
    fn = _build.function("nm_fc_launch", nm_fc._ARGS)
    for want, nm_n, nm_m, entries, rows, cols in (
            (-6, 0, 4, 64, 32, 64), (-6, 2, 17, 64, 32, 64),
            (-7, *NM, 64, 16, 64), (-7, *NM, 64, 32, 48),
            (-2, *NM, 8192, 64, 128)):
        refused(fn, (None, None, None, None, PRUNED.num_ts, SLOTS,
                     PRUNED.hidden_dim, entries, fc, nm_n, nm_m, rows, cols,
                     None), want, "nm_fc",
                f"nm={nm_n}:{nm_m}, entries={entries}, rows={rows}, "
                f"cols={cols}")
    h = PRUNED.hidden_dim
    fn = _build.function("rsnn_cell_launch", rsnn_cell._ARGS)
    for want, ts, hh, rows, cols in ((-1, 5, h, 8, 16), (-7, 2, h, 8, 8),
                                     (-7, 2, h, 2, 64), (-7, 2, h, 8, 48),
                                     (-2, 4, 8192, 32, 64)):
        refused(fn, (None, 0, 0, *[None] * 8, ts, SLOTS, hh, rows, cols,
                     None), want, "rsnn_cell",
                f"ts={ts}, h={hh}, rows={rows}, cols={cols}")
    fn = _build.function("spike_broadcast_launch", spike_broadcast._SB_ARGS)
    for want, k, rows, cols in ((-7, h, 8, 48), (-7, h, 6, 32),
                                (-2, 2048, 4, 32)):
        refused(fn, (None, None, None, 1, 2 * SLOTS, k, h, k, rows, cols,
                     None), want, "spike_broadcast",
                f"k={k}, rows={rows}, cols={cols}")
    fn = _build.function("sparse_fc_launch", sparse_fc._ARGS)
    for want, entries, rows, cols in ((-7, nnz, 16, 64), (-7, nnz, 32, 48),
                                      (-2, 4096, 32, 32)):
        refused(fn, (None, None, None, None, None, PRUNED.num_ts, SLOTS, h,
                     entries, fc, rows, cols, None), want, "sparse_fc",
                f"entries={entries}, rows={rows}, cols={cols}")
    fn = _build.function("int4_matmul_launch", int4_matmul._ARGS)
    for want, k, rows, cols in ((-7, h, 8, 16), (-7, h, 16, 24),
                                (-2, 8192, 64, 128)):
        refused(fn, (None, None, None, None, SLOTS, k, fc, rows, cols, None),
                want, "int4_matmul", f"k={k}, rows={rows}, cols={cols}")
    fn = _build.function("merged_spike_fc_launch", merged_spike_fc._ARGS)
    for want, ts, rows, cols in ((-7, PRUNED.num_ts, 48, 16),
                                 (-7, PRUNED.num_ts, 16, 256),
                                 (-2, 64, 64, 128)):
        refused(fn, (None, None, None, None, ts, SLOTS, h, fc, rows, cols,
                     None), want, "merged_spike_fc",
                f"ts={ts}, rows={rows}, cols={cols}")
    fn = _build.function("spike_cell_launch", spike_broadcast._CELL_ARGS)
    for want, ts, hh, cap, rows, cols in (
            (-1, 5, h, h, 4, 32), (-3, 2, h, 0, 4, 32),
            (-7, 2, h, h, 3, 32), (-7, 1, h, h, 2, 32),
            (-7, 2, h, h, 32, 32), (-7, 2, h, h, 4, 48),
            (-2, 2, 8192, 8192, 2, 32)):
        refused(fn, (None, 0, 0, *[None] * 8, ts, SLOTS, hh, cap, rows, cols,
                     None), want, "spike_cell",
                f"ts={ts}, h={hh}, capacity={cap}, rows={rows}, "
                f"cols={cols}")
    fn = _build.function("delta_step_launch", delta_step._ARGS)
    d = PRUNED.input_dim
    for want, dd, rows, cols in ((-7, d, 3, 32), (-7, d, 4, 48),
                                 (-7, d, 8, 16), (-7, d, 1, 32),
                                 (-7, d, 64, 64), (-2, 65536, 8, 32)):
        refused(fn, (None, None, None, None, 0.0, None, None, None, SLOTS,
                     dd, h, rows, cols, None), want, "delta_step",
                f"d={dd}, rows={rows}, cols={cols}")


def check_nm_against_csc(a: dict, b: int) -> None:
    """K5 over the 2:4 FC against K4 over the same mask stored as padded
    CSC: bit-equal."""
    from repro_torch.kernels import nm_fc, sparse_fc

    got = nm_fc.nm_fc(a["s1"], *a["nm"], n=NM[0], m=NM[1])
    want = sparse_fc.sparse_fc(a["s1"], *a["csc_nm"])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"nm_fc B={b}: differs from sparse_fc on the "
                             f"same 2:4 mask by up to "
                             f"{float((got - want).abs().max())}")
    print(f"check nm_fc == sparse_fc on the same 2:4 mask B={b}: bit-equal")


def edge_rows(x: torch.Tensor) -> torch.Tensor:
    """A copy of spike rows ``x`` ((R, K), or (TS, B, K) trains) whose
    first row is all zeros and whose second has every entry active."""
    x = x.clone()
    x[..., 0, :] = 0.0
    x[..., 1, :] = 1.0
    return x


def kept_events(x: torch.Tensor, capacity: int | None) -> torch.Tensor:
    """The rows K9 reads from ``x`` ((R, K), or (TS, B, K) trains merged
    over TS), each with only its first ``capacity`` nonzeros kept (``None``:
    all), as ``ref.spike_broadcast_ref`` truncates them."""
    m = x.sum(dim=0) if x.dim() == 3 else x
    if capacity is None:
        return m
    cnt = torch.cumsum((m != 0).to(torch.int32), dim=1)
    return torch.where(cnt <= capacity, m, torch.zeros((), device=m.device))


def ascending_chain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as one float32 chain a output in ascending k: ``acc = acc
    + x[:, k] * w[k]``, each product its own op and so rounded before the
    add.  For x in {0, 1, 2} every product is exact, so each step rounds
    once, as ``fmaf(x, w, acc)`` does, and a zero x adds an exact zero: the
    bits of an event-list kernel whose sums are fmaf chains in ascending
    index (K9, K10)."""
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k:k + 1] * w[k]
    return acc


def check_tile_edges(a: dict, b: int, errs: dict, width: str = "") -> None:
    """K9 and K4 at the edges of their tiles, against their plain versions
    on inputs whose first row is all zeros and second full (``edge_rows``):
    K9 on the L1 feed-forward and the FC union, and with the FC cut to
    N = 200 (not a multiple of a column tile) and 203 (nor of 4: the
    4-byte copies and stores), at capacity 1, ``TRUNC_CAPACITY`` and
    lossless; K4 (over the ``csc`` FC of ``a``, when it has one) at
    N = 1920, 200 and 203, bit for bit; with it K2/K3
    (``check_int4_edges``) and K5 (``check_nm_edges``)."""
    from repro_torch.kernels import ref, sparse_fc, spike_broadcast

    s0 = edge_rows(a["s0"].reshape(-1, a["s0"].shape[-1]))
    s1 = edge_rows(a["s1"])
    wfc = a["wfc"]
    cases = [(s0, a["w1x"]), (s1, wfc)] + [
        (x, wfc[:, :n].contiguous()) for n in (200, 203) for x in (s0, s1)]
    for cap in (1, TRUNC_CAPACITY, None):
        for x, w in cases:
            got = spike_broadcast.spike_broadcast(x, w, capacity=cap)
            want = ref.spike_broadcast_ref(x, w, cap)
            torch.cuda.synchronize()
            errs["spike_broadcast"] = max(errs["spike_broadcast"],
                                          check_close("spike_broadcast",
                                                      got, want))
            if not torch.equal(got, ascending_chain(kept_events(x, cap), w)):
                raise AssertionError(f"spike_broadcast{width} B={b} N="
                                     f"{w.shape[1]} capacity={cap}: not the "
                                     f"ascending fmaf chain over its events")
    print(f"check spike_broadcast{width} tile edges B={b} (zero and full "
          f"rows; N = {wfc.shape[1]}, 200, 203; capacity 1, "
          f"{TRUNC_CAPACITY}, lossless): ok, bit-equal to the ascending fmaf "
          f"chain over the kept events, max_abs_err against the plain "
          f"version {errs['spike_broadcast']!r}")
    if "csc" not in a:
        return
    check_int4_edges(a, b, errs)
    check_nm_edges(a["s1"], a["wfc"])
    idx, val, sc = a["csc"]
    for n in (idx.shape[1], 200, 203):
        args = (s1, idx[:, :n].contiguous(), val[:, :n].contiguous(),
                sc[:n].contiguous())
        got = sparse_fc.sparse_fc(*args)
        want = ref.sparse_fc_ref(*args)
        torch.cuda.synchronize()
        check_call("sparse_fc", got, want, args, None)
    print(f"check sparse_fc tile edges B={b} (zero and full rows; N = "
          f"{idx.shape[1]}, 200, 203): bit-equal")


def cell_edge_args(w: torch.Tensor, ts: int, b: int, h: int,
                   broadcast: bool, gen: torch.Generator) -> tuple:
    """K1's operands at ``ts`` x ``b`` x ``h`` with the recurrent weights
    ``w`` cut to (h, h): 0/1 trains whose first row is all zeros and whose
    second is full (``edge_rows``, where b > 1), a stimulus that is one
    (B, H) row broadcast over TS (stride 0, the L0 call) or dense (L1),
    random u0 and h0, beta in [0.5, 0.95] and vth in [0.5, 1.5]."""
    dev = w.device
    s = (torch.rand((ts, b, h), generator=gen) < 0.3).float()
    if b > 1:
        s = edge_rows(s)
    stim = torch.randn((1 if broadcast else ts, b, h), generator=gen) * 0.8
    return (stim.to(dev).expand(ts, b, h), s.to(dev),
            w[:h, :h].contiguous(), torch.randn((b, h), generator=gen).to(dev),
            (torch.rand((b, h), generator=gen) < 0.3).float().to(dev),
            (0.5 + 0.45 * torch.rand(h, generator=gen)).to(dev),
            (0.5 + torch.rand(h, generator=gen)).to(dev))


def check_cell_edges(w128: torch.Tensor, w256: torch.Tensor,
                     gen: torch.Generator, errs: dict) -> None:
    """K1 and K10 at the edges of their tiles: B = 256, 200 and 1; H = 128
    (the int4 engine's dequantized recurrent weights ``w128``), 256 (the
    float ``BASELINE`` ones, ``w256``) and a ragged 100 (``w128`` cut: not
    a multiple of 4, so the 4-byte copies); TS = 1, 2 and 4; with the
    stride-0 and the dense stimulus (``cell_edge_args``).  K1 within
    ``check_cell``'s rule; K10 lossless bit-equal to K1 on the same 0/1
    trains (both sum one fmaf chain in ascending index), and at
    ``TRUNC_CAPACITY`` within ``check_cell``'s rule against
    ``ref.spike_cell_ref``."""
    from repro_torch.kernels import ref, rsnn_cell, spike_broadcast

    shapes = 0
    for b in (256, 200, 1):
        for h, w in ((128, w128), (256, w256), (100, w128)):
            for ts in (1, 2, 4):
                for broadcast in (True, False):
                    args = cell_edge_args(w, ts, b, h, broadcast, gen)
                    got = rsnn_cell.rsnn_cell(*args)
                    want = ref.rsnn_cell_ref(*args)
                    events = spike_broadcast.spike_cell(*args)
                    cut = spike_broadcast.spike_cell(
                        *args, capacity=TRUNC_CAPACITY)
                    cut_want = ref.spike_cell_ref(*args, TRUNC_CAPACITY)
                    torch.cuda.synchronize()
                    errs["rsnn_cell"] = max(errs["rsnn_cell"], check_call(
                        "rsnn_cell", got, want, args, None, errs))
                    if not all(map(torch.equal, events, got)):
                        raise AssertionError(
                            f"spike_cell B={b} H={h} TS={ts} broadcast="
                            f"{broadcast}: lossless, not bit-equal to "
                            f"rsnn_cell")
                    errs["spike_cell"] = max(errs["spike_cell"], check_call(
                        "spike_cell", cut, cut_want, args, TRUNC_CAPACITY,
                        errs))
                    shapes += 1
    print(f"check rsnn_cell, spike_cell tile edges ({shapes} shapes: B = "
          f"256, 200, 1; H = 128, 256, 100; TS = 1, 2, 4; stride-0 and dense "
          f"stimulus; zero and full rows): ok; spike_cell lossless "
          f"bit-equal to rsnn_cell; max_abs_err rsnn_cell "
          f"{errs['rsnn_cell']!r}, spike_cell at capacity {TRUNC_CAPACITY} "
          f"{errs['spike_cell']!r}")


def delta_edge_frames(b: int, d: int, gen: torch.Generator) -> dict:
    """K8's inputs at the edges of its gate: name -> (x, x_prev), 8-bit
    integers.  ``mixed``: rows that repeat (every 4th), move by at most
    ``DELTA_THRESHOLD`` LSB (every 4th, one further) or change, as
    ``kernel_inputs``; ``held``: x_prev = x, every row takes the cached
    branch; ``changed``: every row moves by 3 LSB in one element (x_hat
    mixes x and x_prev), so every row is recomputed at threshold 0 and
    at 2."""
    x = torch.randint(-128, 128, (b, d), generator=gen).float()
    mixed = torch.randint(-128, 128, (b, d), generator=gen).float()
    mixed[0::4] = x[0::4]
    mixed[1::4] = x[1::4] + torch.randint(
        -int(DELTA_THRESHOLD), int(DELTA_THRESHOLD) + 1, x[1::4].shape,
        generator=gen).float()
    changed = x.clone()
    rows = torch.arange(b)
    changed[rows, rows % d] -= 3.0
    return {"mixed": (x, mixed), "held": (x, x.clone()),
            "changed": (x, changed)}


def check_delta_edges(w128: torch.Tensor, w256: torch.Tensor,
                      gen: torch.Generator, errs: dict) -> None:
    """K8 at the edges of its tiles and its gate, by ``check_delta``'s rule
    (mask, x_hat and held rows exact, recomputed rows within ``TOL``): B =
    256, 200 and 1; H = 128 (the int4 engine's dequantized L0 weights
    ``w128``), 256 (the float ``BASELINE`` ones, ``w256``) and a ragged
    100 (``w128`` cut); thresholds 0 and ``DELTA_THRESHOLD``; the
    ``delta_edge_frames``: mixed rows, every row held, every row
    changed."""
    from repro_torch.kernels import delta_step, ref

    dev = w128.device
    shapes = 0
    for b in (256, 200, 1):
        for h, w in ((128, w128), (256, w256), (100, w128)):
            w = w[:, :h].contiguous()
            pre_prev = torch.randn((b, h), generator=gen).to(dev)
            for name, (x, x_prev) in delta_edge_frames(
                    b, w.shape[0], gen).items():
                for thr in (0.0, DELTA_THRESHOLD):
                    args = (x.to(dev), x_prev.to(dev), pre_prev, w, thr)
                    got = delta_step.delta_step(*args)
                    want = ref.delta_step_ref(*args)
                    torch.cuda.synchronize()
                    rows_changed = int(want[2].bool().any(dim=1).sum())
                    if rows_changed != {"held": 0, "changed": b}.get(
                            name, rows_changed):
                        raise AssertionError(f"delta edge frame {name}: "
                                             f"{rows_changed} rows changed")
                    errs["delta_step"] = max(errs["delta_step"], check_call(
                        "delta_step", got, want, args, None))
                    shapes += 1
    print(f"check delta_step tile edges ({shapes} calls: B = 256, 200, 1; "
          f"H = 128, 256, 100; threshold 0 and {DELTA_THRESHOLD}; mixed, "
          f"every row held, every row changed): ok, max_abs_err "
          f"{errs['delta_step']!r}")


def nm_edge_fcs(w: np.ndarray, geometries=((1, 4), NM, (3, 8))) -> list:
    """The FC weights ``w`` (H, N) quantized to int4 and masked N:M for each
    (n, m) of ``geometries`` (the ``n`` largest |w| of every ``m`` rows),
    as (n, m, packed, scale, indices, values): the group-packed N:M and the
    same mask as padded CSC (the port's packers), as numpy arrays."""
    wt = torch.from_numpy(np.ascontiguousarray(w))
    q, scale = quantize_to_int(wt)
    out = []
    for n, m in geometries:
        keep = nm_prune_mask(wt, n, m).bool()
        qk = torch.where(keep, q, 0).to(torch.int8)
        csc = sparsify_columns(qk, scale, keep)
        out.append((n, m, pack_nm_groups(qk, scale, keep, n, m).packed
                    .numpy(), scale.numpy(), csc.indices.numpy(),
                    csc.values.numpy()))
    return out


def check_nm_edges(s: torch.Tensor, wfc: torch.Tensor) -> None:
    """K5 at the edges of its tiles, bit-equal to its plain version and to
    K4 over the same mask stored as padded CSC: trains ``s`` with an
    all-zero and a full row (``edge_rows``), the FC weights ``wfc`` masked
    1:4, 2:4 and 3:8 (``nm_edge_fcs``), the FC cut to N = 1920, 200 and
    203; 3:8 also over H = 126, whose last group of rows is a tail of 6."""
    from repro_torch.kernels import nm_fc, ref, sparse_fc

    dev = s.device
    w = wfc.cpu().numpy()
    s = edge_rows(s)
    cases = [(s, fc) for fc in nm_edge_fcs(w)]
    cases += [(s[..., :126].contiguous(), fc)
              for fc in nm_edge_fcs(w[:126], ((3, 8),))]
    for x, (n, m, packed, scale, idx, val) in cases:
        for cols in (packed.shape[1], 200, 203):
            p, sc, i, v = (torch.from_numpy(
                np.ascontiguousarray(t[:, :cols])).to(dev)
                for t in (packed, scale, idx, val))
            got = nm_fc.nm_fc(x, p, sc, n=n, m=m)
            want = ref.nm_fc_ref(x, p, sc, n=n, m=m)
            csc = sparse_fc.sparse_fc(x, i, v, sc)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, csc)):
                raise AssertionError(
                    f"nm_fc {n}:{m} H={x.shape[-1]} N={cols}: differs from "
                    f"its plain version by {float((got - want).abs().max())}"
                    f" and from sparse_fc on the same mask by "
                    f"{float((got - csc).abs().max())}")
    print(f"check nm_fc tile edges B={s.shape[1]} (zero and full rows; 1:4, "
          f"2:4, 3:8, 3:8 over H = 126; N = 1920, 200, 203): bit-equal to "
          f"its plain version and to sparse_fc on the same mask")


def int4_edge_calls(a: dict) -> list:
    """K2 and K3 at the edges of their tiles on the operands of
    ``kernel_inputs`` ``a``, as (kernel name, args): rows all zero and
    full (the L0 input's second and third rows at 127 and -128, the spike
    rows' second all ones: ``edge_rows``); K2 at K = 40 (L0) and 128 (L1;
    one train of the FC's input, ``merged_spike=False``'s shape), K3 at
    TS = 1, 2 and 4; the FC cut to N = 200 (not a multiple of a column
    tile nor of 16: the weights' byte copies) and 203 (odd: the scalar
    stores); then each call again at B = 1 on the full row."""
    cut = {n: tuple(t[..., :n].contiguous() for t in a["fc"])
           for n in (1920, 200, 203)}
    x = a["x"].clone()
    x[0], x[1], x[2] = 0.0, 127.0, -128.0
    s0 = edge_rows(a["s0"].reshape(-1, a["s0"].shape[-1]))
    s1 = edge_rows(a["s1"])
    trains = {1: s1[:1], 2: s1, 4: torch.cat([s1, edge_rows(a["s0"])])}
    calls = [("int4_matmul", (x, *a["l0"])), ("int4_matmul", (s0, *a["l1"]))]
    for n, (p, sc) in cut.items():
        calls += [("int4_matmul", (s1[0], p, sc)),
                  ("int4_matmul", (x, p[:PRUNED.input_dim // 2], sc))]
        calls += [("merged_spike_fc", (t, p, sc)) for t in trains.values()]
    one = [(name, (args[0][..., 1:2, :], *args[1:])) for name, args in calls]
    return calls + one


def int4_float_calls(a: dict) -> list:
    """K2 and K3 on inputs their int8 path cannot take exactly, so that
    the blocks vote for the fp32 path: non-integer L0 inputs and spikes
    (x 0.37, spikes x 0.5), and integers outside [-128, 127] in one row
    (the L0 input's fourth row at +-300, merged spikes x 100, up to 200)."""
    big = a["x"].clone()
    big[3] = 300.0 * (1.0 - 2.0 * (torch.arange(big.shape[1],
                                                 device=big.device) % 2))
    s0 = a["s0"].reshape(-1, a["s0"].shape[-1])
    return [("int4_matmul", (a["x"] * 0.37, *a["l0"])),
            ("int4_matmul", (big, *a["l0"])),
            ("int4_matmul", (s0 * 0.5, *a["l1"])),
            ("merged_spike_fc", (a["s1"] * 0.5, *a["fc"])),
            ("merged_spike_fc", (a["s1"] * 100.0, *a["fc"]))]


def check_int4_edges(a: dict, b: int, errs: dict) -> None:
    """K2 and K3 bit-equal to their plain versions at their tiles' edges
    (``int4_edge_calls``), and within ``TOL`` on the inputs that take the
    fp32 path (``int4_float_calls``)."""
    from repro_torch.kernels import int4_matmul, merged_spike_fc, ref

    fns = {"int4_matmul": (int4_matmul.int4_matmul, ref.int4_matmul_ref),
           "merged_spike_fc": (merged_spike_fc.merged_spike_fc,
                               ref.merged_spike_fc_ref)}
    for name, args in int4_edge_calls(a):
        kern, plain = fns[name]
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        check_call(name, got, want, args, None)
    print(f"check int4_matmul, merged_spike_fc tile edges B={b} and 1 "
          f"(zero and full rows; K = 40, 128; TS = 1, 2, 4; N = "
          f"{a['fc'][0].shape[1]}, 200, 203): bit-equal")
    for name, args in int4_float_calls(a):
        kern, plain = fns[name]
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        errs[name] = max(errs.get(name, 0.0), check_close(name, got, want))
    print(f"check int4_matmul, merged_spike_fc fp32 path B={b} (non-integer "
          f"inputs, +-300 in one row, merged spikes up to 200): ok, "
          f"max_abs_err {errs['int4_matmul']!r}, "
          f"{errs['merged_spike_fc']!r}")


def check_variants(a: dict, b: int, errs: dict, names=None,
                   width: str = "") -> None:
    """Each kernel of ``kernel_calls(a)`` (those in ``names``, but not
    K6/K7) against its plain version: lossless with K8 at
    ``DELTA_THRESHOLD``; K8 at threshold 0 on a repeated frame (every row
    cached); K8-K10 at ``TRUNC_CAPACITY`` events a row and threshold 0."""
    repeat = dict(a, x_prev=a["x"])
    variants = [
        (None, DELTA_THRESHOLD, kernel_calls(a)),
        (None, 0.0, {"delta_step": kernel_calls(
            repeat, threshold=0.0)["delta_step"]}),
        (TRUNC_CAPACITY, 0.0, {
            k: v for k, v in kernel_calls(a, TRUNC_CAPACITY, 0.0).items()
            if k in ("spike_broadcast", "spike_cell", "delta_step")})]
    for cap, thr, calls in variants:
        for name, items in calls.items():
            if name.startswith("megastep") or (names and name not in names):
                continue  # check_megastep sweeps its modes
            for kern, plain, args in items:
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                err = check_call(name, got, want, args, cap, errs)
                errs[name] = max(errs.get(name, 0.0), err)
            knob = {"delta_step": f" threshold={thr}",
                    "spike_broadcast": f" capacity={cap}",
                    "spike_cell": f" capacity={cap}"}.get(name, "")
            print(f"check {name}{width} B={b}{knob}: ok, max_abs_err "
                  f"{errs[name]!r}")


def check_kernels(packs: dict, floats: dict, dev,
                  seed: int) -> dict[str, float]:
    """Phase 2: every kernel against its plain version on the card, at
    B = 256 and 200; K9/K10 also at ``TRUNC_CAPACITY`` events a row, K8
    at threshold 0 (first on a repeated frame: every row cached) and
    ``DELTA_THRESHOLD``; K9, K4, K2 and K3 at their tiles' edges
    (``check_tile_edges``), K2 and K3 also on their fp32 path; K5 also
    against K4 on the same mask, at the served shape and at its tiles'
    edges; K1 and K10 at their tiles' edges, K10 lossless bit-equal to K1
    (``check_cell_edges``); K8 at its tiles' and its gate's edges
    (``check_delta_edges``).  Then the
    float engine's kernels with the float weights of ``floats`` (width
    name -> ``float_params``): K6/K7 in ``dense_float`` at each width, and
    K1, K8-K10 at ``BASELINE`` (H = 256), K9 at its tiles' edges too;
    K6/K7 in every FC mode at their plans' edges
    (``check_megastep_edges``)."""
    errs: dict[str, float] = {}
    gen = torch.Generator().manual_seed(seed)
    for b in (256, 200):
        a = kernel_inputs(packs, b, gen, dev)
        check_variants(a, b, errs)
        check_tile_edges(a, b, errs)
        check_nm_against_csc(a, b)
        check_megastep(a, b, errs)
    fa = float_kernel_inputs(floats["BASELINE"], 1, gen, dev)
    check_cell_edges(a["w0h"], fa["w0h"], gen, errs)
    w0x = a["w0x"]
    drawn = gen.get_state()
    for b in (256, 200):
        for width, params in floats.items():
            a = float_kernel_inputs(params, b, gen, dev)
            if width == "BASELINE":
                check_variants(a, b, errs, ("rsnn_cell", "delta_step",
                                            "spike_broadcast", "spike_cell"),
                               " BASELINE float")
                check_tile_edges(a, b, errs, " BASELINE float")
            check_megastep(a, b, errs, ("dense_float",), f" {width}")
    # PR 22's second chip call ran K8's edge check before the float checks:
    # on the inputs drawn after it, K6 float at PRUNED width missed the old
    # rule 1e-5 (1 + |u|) at one element
    gen.set_state(drawn)
    check_delta_edges(w0x, fa["w0x"], gen, errs)
    float_kernel_inputs(floats["BASELINE"], 256, gen, dev)
    a = float_kernel_inputs(floats["PRUNED"], 256, gen, dev)
    check_megastep(a, 256, errs, ("dense_float",),
                   " PRUNED (drawn after K8's edges)")
    old_u_rule(a)
    check_megastep_edges(floats["BASELINE"], dev, seed, errs)
    check_refusals()
    print("check u rule (|du| <= (n + 3) 2^-24 A; n + 3 = H + 5 for K1/K10, "
          "D + H + 4 and 2H + 4 for K6/K7's L0 and L1, TS H + 3 for the "
          "float FC): largest |du| / (2^-24 A): " + "; ".join(
              f"{k.split(' |du|')[0]} {v!r}" for k, v in sorted(errs.items())
              if k.endswith("|du|/(2^-24 A)")))
    return errs


def old_u_rule(a: dict) -> None:
    """Print how K6 float over ``MEGA_FRAMES`` frames of ``a`` fares under
    the u rule chip_smoke.py held K1, K10 and K6/K7 to before,
    ``|du| <= U_ATOL + U_RTOL |u|`` against the plain version, on the
    slots the float64 replay finds away from the threshold."""
    args = megastep_args(a, MEGA_FRAMES, "dense_float")
    keep = ~megastep_replay(args).near
    kern, plain = megastep_pair("dense_float", False)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    for out in ("u0", "u1"):
        i = list(MEGA_OUTS).index(out)
        g, w = got[i][keep], want[i][keep]
        du = (g - w).abs()
        lim = U_ATOL + U_RTOL * w.abs()
        j = int(torch.argmax(du - lim))
        print(f"check megastep PRUNED float F={MEGA_FRAMES} (drawn after "
              f"K8's edges) under the old rule 1e-5 (1 + |u|): {out} "
              f"{int((du > lim).sum())} of {du.numel()} over it, the "
              f"closest at u {float(w.flatten()[j])!r}: |du| "
              f"{float(du.flatten()[j])!r}, allowed "
              f"{float(lim.flatten()[j])!r}")


# ---------------------------------------------------------------- serving


def core(state):
    """The recurrent state inside a delta backend's state."""
    return getattr(state, "rsnn", state)


def make_loop(engine, **loop_kw):
    """A ``StreamLoop`` over ``SLOTS`` slots; by default phase 4's eager v1
    loop (``V1_EAGER``)."""
    from repro_torch.serving.stream import StreamLoop

    return StreamLoop(engine, batch_slots=SLOTS, **{**V1_EAGER, **loop_kw})


def serve(engine, utts, loop=None, **loop_kw):
    """One StreamLoop run (``loop``, or ``make_loop(engine, **loop_kw)``),
    its construction untimed; returns (loop, finished requests, seconds)."""
    if loop is None:
        loop = make_loop(engine, **loop_kw)
    for u in utts:
        loop.submit(u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = loop.run()
    torch.cuda.synchronize()
    return loop, done, time.perf_counter() - t0


def compare_free_running(eng, ref_eng, utts, frames: int):
    """Step both engines ``frames`` frames on the first utterances, each
    from its own state: the spike-flip rate between the two."""
    b = len(utts)
    x = torch.from_numpy(np.stack([u[:frames] for u in utts], 1))
    sa, sb = eng.init_state(b), ref_eng.init_state(b)
    flips = total = 0
    for t in range(frames):
        xq = eng.quantize_features(x[t])
        sa, _, _ = eng.step(sa, xq)
        sb, _, _ = ref_eng.step(sb, xq)
        for p, q in ((core(sa).h0, sb.h0), (core(sa).h1, sb.h1)):
            flips += int((p != q).sum())
            total += p.numel()
    return flips / total


def ref_traces(ref_eng, state, xq, ref_next) -> list[tuple]:
    """The ``ref`` engine's step from ``state`` on ``xq``, recomputed with
    its own plain operations: for L0 and L1, (membrane trace (TS, B, H),
    threshold (H,)).  Checks that the traces' spikes are those of
    ``ref_next``, the engine's next state."""
    ff, w, lif = ref_eng.ops.ff_matmul, ref_eng._w, ref_eng._lif
    ts, b, h = state.h0.shape[0], xq.shape[0], ref_eng.cfg.hidden_dim
    stim = ff(xq, "l0_wx").unsqueeze(0).expand(ts, b, h)
    out = []
    for i, (h_prev, lif_prev, s_next) in enumerate(
            ((state.h0, state.lif0, ref_next.h0),
             (state.h1, state.lif1, ref_next.h1))):
        beta, vth = lif[f"beta{i}"], lif[f"vth{i}"]
        trace = lif_trace(stim, torch.matmul(h_prev, w[f"l{i}_wh"]),
                          lif_prev.u, lif_prev.spike, beta, vth)
        spikes = (trace >= vth).float()
        if not torch.equal(spikes, s_next):
            raise AssertionError(f"ref_traces: the L{i} trace does not "
                                 f"reproduce the ref engine's spikes")
        out.append((trace, vth))
        stim = ff(spikes.reshape(ts * b, h), "l1_wx").reshape(ts, b, h)
    return out


def u_limit(vth: torch.Tensor) -> torch.Tensor:
    """The u rule's band around a threshold: ``U_ATOL + U_RTOL |vth|``."""
    return U_ATOL + U_RTOL * vth.abs()


def near_threshold(ref_eng, state, xq, ref_next) -> list[torch.Tensor]:
    """Per slot, for L0 and L1: whether the ``ref`` engine's step from
    ``state`` on ``xq`` brings some neuron within ``U_RTOL``/``U_ATOL`` of
    its threshold at some time step (``ref_traces``)."""
    return [((trace - vth).abs() <= u_limit(vth)).any(dim=0).any(dim=1)
            for trace, vth in ref_traces(ref_eng, state, xq, ref_next)]


def padded_frames(utts, frames: int | None) -> tuple[torch.Tensor, np.ndarray]:
    """The first ``frames`` frames of each utterance (every frame with
    ``None``) as a (T, B, D) batch, zero past a stream's end, and each
    stream's frame count in it."""
    lens = np.array([len(u) if frames is None else min(len(u), frames)
                     for u in utts])
    x = np.zeros((int(lens.max()), len(utts), utts[0].shape[1]), np.float32)
    for i, (u, n) in enumerate(zip(utts, lens)):
        x[:n, i] = u[:n]
    return torch.from_numpy(x), lens


def teacher_forced(eng, ref_eng, utts, frames: int | None
                   ) -> tuple[float, int]:
    """Each frame, both engines start from the ref engine's state (a delta
    engine keeps its own held input and cached pre-activation around it),
    over the first ``frames`` frames of each utterance, or all of them
    (``None``); a slot whose stream has ended is masked out.  A slot's
    spikes may differ only where the ref engine's potential is within
    tolerance of the threshold (in L0, or in L1 with equal L0 spikes);
    every other slot's logits and u must agree within tolerance.  Returns
    (largest logit difference, slot-frames let through near the
    threshold)."""
    b = len(utts)
    x, lens = padded_frames(utts, frames)
    state, own = ref_eng.init_state(b), eng.init_state(b)
    worst, let_through = 0.0, 0
    for t in range(x.shape[0]):
        xq = ref_eng.quantize_features(x[t])
        live = torch.from_numpy(t < lens).to(xq.device)
        own = own._replace(rsnn=state) if hasattr(own, "rsnn") else state
        own, la, _ = eng.step(own, xq)
        sa = core(own)
        sb, lb, _ = ref_eng.step(state, xq)
        near0, near1 = near_threshold(ref_eng, state, xq, sb)
        diff0 = (sa.h0 != sb.h0).any(dim=0).any(dim=1)
        diff1 = (sa.h1 != sb.h1).any(dim=0).any(dim=1)
        bad = ((diff0 & ~near0) | (diff1 & ~diff0 & ~near1)) & live
        if bool(bad.any()):
            raise AssertionError(
                f"teacher-forced frame {t}: spikes differ away from the "
                f"threshold in {int(bad.sum())} of {b} slots")
        same = ~(diff0 | diff1) & live
        let_through += int(((diff0 | diff1) & live).sum())
        if bool(same.any()):
            d = float((la - lb)[same].abs().max())
            du = max(float((p.u - q.u)[same].abs().max())
                     for p, q in ((sa.lif0, sb.lif0), (sa.lif1, sb.lif1)))
            if d > LOGIT_ATOL or du > LOGIT_ATOL:
                raise AssertionError(f"teacher-forced frame {t}: |dlogit| "
                                     f"{d}, |du| {du}")
            worst = max(worst, d)
        state = sb
    return worst, let_through


class FirstFlip(NamedTuple):
    """A stream's first spike that differs from ``ref``'s in a
    free-running run: its frame, layer and time step, the largest |u -
    vth| of ``ref``'s potential over the neurons that flipped there, and
    the u rule's band at that neuron."""

    frame: int
    layer: int
    ts: int
    margin: float
    limit: float


def first_flips(eng, ref_eng, utts) -> tuple[np.ndarray, list]:
    """Both engines free-running, each from its own state, over every frame
    of ``utts`` (one slot a stream, masked past its end).  Returns each
    stream's count of frames whose argmax differs from ``ref``'s and its
    first flip (``FirstFlip``, or None where every spike agreed).  At the
    first frame with a differing spike the two states' spikes are still
    equal, so ``ref``'s trace from its own state (``ref_traces``) is that
    step's; a flip in L0 is taken before one in L1 (L1 reads L0's
    spikes), and within a layer the earliest time step (a flip resets the
    potential of the next)."""
    b = len(utts)
    x, lens = padded_frames(utts, None)
    sa, sb = eng.init_state(b), ref_eng.init_state(b)
    disagree = np.zeros(b, np.int64)
    flips: list = [None] * b
    for t in range(x.shape[0]):
        xq = ref_eng.quantize_features(x[t])
        live = t < lens
        na, la, _ = eng.step(sa, xq)
        nb, lb, _ = ref_eng.step(sb, xq)
        disagree += live & (la.argmax(1) != lb.argmax(1)).cpu().numpy()
        pa = core(na)
        diffs = [(pa.h0 != nb.h0), (pa.h1 != nb.h1)]  # (TS, B, H) each
        new = live & np.array([f is None for f in flips]) & (
            (diffs[0] | diffs[1]).any(dim=0).any(dim=1).cpu().numpy())
        if new.any():
            traces = ref_traces(ref_eng, core(sb), xq, nb)
            for i in np.flatnonzero(new):
                layer = 0 if bool(diffs[0][:, i].any()) else 1
                d = diffs[layer][:, i]  # (TS, H)
                ts = int(d.any(dim=1).nonzero()[0, 0])
                trace, vth = traces[layer]
                n = d[ts].nonzero()[:, 0]
                gap = (trace[ts, i, n] - vth[n]).abs()
                j = int(gap.argmax())
                flips[i] = FirstFlip(t, layer, ts, float(gap[j]),
                                     float(u_limit(vth[n][j])))
        sa, sb = na, nb
    return disagree, flips


def check_first_flips(name: str, eng, ref_eng, utts, logits, ref_logits
                      ) -> None:
    """ROADMAP queue 3's argmax flips: ``teacher_forced`` over every frame
    of every utterance (in batches of ``SLOTS`` streams), then each stream
    whose served argmax differs from ``ref``'s in phase 4 named with its
    first flip in a free-running run (``first_flips``).  Every first flip
    must lie inside the u rule: a flip that does not is a port fault."""
    t0 = time.perf_counter()
    worst, near, flips, disagree = 0.0, 0, [], []
    for k in range(0, len(utts), SLOTS):
        w, n = teacher_forced(eng, ref_eng, utts[k:k + SLOTS], None)
        worst, near = max(worst, w), near + n
        d, f = first_flips(eng, ref_eng, utts[k:k + SLOTS])
        disagree.append(d)
        flips += f
    disagree = np.concatenate(disagree)
    frames = sum(map(len, utts))
    served = np.array([int((a.argmax(1) != b.argmax(1)).sum())
                       for a, b in zip(logits, ref_logits)])
    print(f"first flips {name}: teacher-forced over all {frames} frames of "
          f"{len(utts)} streams: max |dlogit| {worst!r}, slot-frames let "
          f"through near the threshold {near}; argmax differs from ref in "
          f"{int(served.sum())} served frames of {int((served > 0).sum())} "
          f"streams, free-running in {int(disagree.sum())} frames of "
          f"{int((disagree > 0).sum())} streams; streams with a spike flip "
          f"{sum(f is not None for f in flips)}")
    outside = []
    for i in np.flatnonzero((served > 0) | (disagree > 0)):
        f = flips[i]
        text = ("no spike flip" if f is None else
                f"first flip frame {f.frame} L{f.layer} ts {f.ts}: ref |u - "
                f"vth| {f.margin!r}, u rule {f.limit!r}")
        print(f"first flips {name} stream {i} ({len(utts[i])} frames, "
              f"argmax differs in {served[i]} served / {disagree[i]} "
              f"free-running frames): {text}")
        if f is None or f.margin > f.limit:
            outside.append(int(i))
    if outside:
        raise AssertionError(f"{name}: streams {outside} flip away from the "
                             f"threshold (or not at all) where the argmax "
                             f"differs from ref")
    print(f"first flips {name}: every first flip within the u rule; "
          f"{time.perf_counter() - t0!r} s")


def device_busy(engine, utts, name: str, **loop_kw) -> None:
    """One StreamLoop run (``make_loop``'s, built outside the window) under
    ``torch.profiler``; prints the share of its wall time in which the
    card ran a kernel or a copy, the device ms a step, the count of each
    kind of copy and fill, and the device operations that took most of
    it.  The profiler slows the host, so the share is a lower bound for
    the unprofiled loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loop = make_loop(engine, **loop_kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop, _, secs = serve(engine, utts, loop=loop)
    ops = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in ops)
    if busy_us <= 0:
        print("device busy share: not measured (the profiler recorded no "
              "device time)")
        return
    copies = {k: c for _, c, k in ops if k.startswith(("Memcpy", "Memset"))}
    top = "; ".join(f"{k[:48]} x{c} {t / 1e3:.3f} ms"
                    for t, c, k in sorted(ops, reverse=True)[:8])
    print(f"device busy share ({name}, profiled): "
          f"{busy_us / 1e6 / secs!r} of {secs!r} s over {loop.steps} "
          f"steps; device ms/step {busy_us / 1e3 / loop.steps!r}; copies "
          f"{copies}; top: {top}")


# Served configurations: name -> (EngineConfig fields, launches per step of
# each kernel, held against ref with teacher-forced frames, profiled,
# artifact).  Those over the ``csc`` artifact are served again in reverse
# order.
SERVED = {
    "pallas": ({"backend": "pallas"}, {"rsnn_cell": 2, "int4_matmul": 2,
                                       "merged_spike_fc": 1}, True, True,
               "csc"),
    "sparse": ({"backend": "sparse"}, {"rsnn_cell": 2, "int4_matmul": 2,
                                       "sparse_fc": 1}, True, True, "csc"),
    "spike": ({"backend": "spike", "sparse_fc": True},
              {"spike_cell": 2, "spike_broadcast": 1, "sparse_fc": 1},
              True, True, "csc"),
    "spike sparse_fc=False": ({"backend": "spike"},
                              {"spike_cell": 2, "spike_broadcast": 2},
                              True, False, "csc"),
    "delta threshold=0": ({"backend": "delta"},
                          {"spike_cell": 2, "delta_step": 1}, True, False,
                          "csc"),
    f"delta threshold={DELTA_THRESHOLD}": (
        {"backend": "delta", "delta_threshold": DELTA_THRESHOLD},
        {"spike_cell": 2, "delta_step": 1}, False, True, "csc"),
    "fused": ({"backend": "fused", "sparse_fc": True}, {"megastep": 1},
              True, True, "csc"),
    "fused sparse_fc=False": ({"backend": "fused"}, {"megastep": 1}, True,
                              False, "csc"),
    "fused_spike": ({"backend": "fused_spike", "sparse_fc": True},
                    {"megastep_spike": 1}, True, True, "csc"),
    "fused_spike sparse_fc=False": ({"backend": "fused_spike"},
                                    {"megastep_spike": 1}, True, False,
                                    "csc"),
    # the float BASELINE artifact (40 -> 256 -> 256 -> 1920): the float
    # engine, once, in this order
    "pallas float": ({"backend": "pallas"}, {"rsnn_cell": 2}, True, True,
                     "float"),
    "spike float": ({"backend": "spike"},
                    {"spike_cell": 2, "spike_broadcast": 2}, True, True,
                    "float"),
    "delta float threshold=0": ({"backend": "delta"},
                                {"spike_cell": 2, "delta_step": 1}, True,
                                False, "float"),
    "fused float": ({"backend": "fused"}, {"megastep": 1}, True, True,
                    "float"),
    "fused_spike float": ({"backend": "fused_spike"}, {"megastep_spike": 1},
                          True, True, "float"),
    # the 2:4 FC as N:M: served once, in this order, without the profiler
    "sparse nm": ({"backend": "sparse"}, {"rsnn_cell": 2, "int4_matmul": 2,
                                          "nm_fc": 1}, True, False, "nm"),
    "spike nm": ({"backend": "spike", "sparse_fc": True},
                 {"spike_cell": 2, "spike_broadcast": 1, "nm_fc": 1}, True,
                 False, "nm"),
    "fused nm": ({"backend": "fused", "sparse_fc": True}, {"megastep": 1},
                 True, False, "nm"),
    "fused_spike nm": ({"backend": "fused_spike", "sparse_fc": True},
                       {"megastep_spike": 1}, True, False, "nm"),
}
# the same 2:4 mask as padded CSC: served once, for bit-equal logits
# against the configuration over N:M that the key names
LAYOUT_PARITY = {
    "sparse nm": ({"backend": "sparse"}, {"rsnn_cell": 2, "int4_matmul": 2,
                                          "sparse_fc": 1}),
    "fused nm": ({"backend": "fused", "sparse_fc": True}, {"megastep": 1}),
}


# ROADMAP queue 3's configurations whose free-running argmax differs from
# ref's: every frame teacher-forced and each first flip named
FIRST_FLIP = ("pallas", "fused float")


def serve_counted(name: str, path, art, fields: dict, per_step: dict, utts,
                  launches: dict):
    """Serve ``utts`` once through an engine over ``path`` with ``fields``;
    each kernel's launches must be steps x ``per_step`` (0 for a kernel
    not named), and every request's logits finite and of its shape.
    Adds the launches to ``launches``; returns (engine, loop, logits,
    seconds, launches of this run)."""
    from repro_torch.core.layouts.nm import NMGroupPacked
    from repro_torch.serving.stream import CompiledRSNN, EngineConfig

    eng = CompiledRSNN.from_artifact(path, EngineConfig(
        **fields, precision=art.precision, input_scale=art.input_scale))
    nm_mode = eng.engine.wants_sparse_fc and isinstance(
        eng.packed.sparse["fc_w"], NMGroupPacked)
    row = ("_float" if art.precision == "float" else "_nm" if nm_mode
           else "" if eng.engine.wants_sparse_fc else "_dense_int4")
    set_counts(0)
    loop, done, secs = serve(eng, utts)
    counts = read_counts()
    for n, c in counts.items():
        if c != loop.steps * per_step.get(n, 0):
            raise AssertionError(
                f"{name}: {n} launched {c} times, expected "
                f"{loop.steps} steps x {per_step.get(n, 0)}")
        launches[f"{n}{row}" if n in ROW_FC_MODE else n] += c
    logits = [r.stacked_logits() for r in done]
    for r, lg in zip(done, logits):
        if lg.shape != (len(r.frames), eng.cfg.fc_dim) \
                or not np.isfinite(lg).all():
            raise AssertionError(f"{name}: request {r.sid} logits "
                                 f"{lg.shape} not finite")
    return eng, loop, logits, secs, counts


def serve_all(paths: dict, arts: dict, utts) -> tuple[dict, dict]:
    """Phase 4: every configuration of ``SERVED`` over the same streams,
    against the port's ``ref`` backend over the same artifact, then
    ``LAYOUT_PARITY``; returns (launches of each kernel over all runs,
    (engine, logits) by configuration)."""
    from repro_torch.serving.stream import CompiledRSNN

    refs = {}
    for key in dict.fromkeys(v[4] for v in SERVED.values()):
        ref = CompiledRSNN.from_artifact(paths[key], backend="ref")
        _, ref_done, ref_s = serve(ref, utts)
        refs[key] = ref, [r.stacked_logits() for r in ref_done]
        print(f"serve ref ({key} artifact): {ref_s!r} s = "
              f"{sum(map(len, utts)) / ref_s!r} frames/s")
    launches = dict.fromkeys([*read_counts(), *ROW_FC_MODE], 0)
    served = {}
    for name, (fields, per_step, forced, profiled, key) in SERVED.items():
        ref, ref_logits = refs[key]
        eng, loop, logits, secs, counts = serve_counted(
            name, paths[key], arts[key], fields, per_step, utts, launches)
        agree = float(np.mean(np.concatenate(
            [a.argmax(1) == b.argmax(1) for a, b in zip(logits, ref_logits)])))
        flips = compare_free_running(eng, ref, utts[:SLOTS], 40)
        forced_text = "not asserted (another function than ref)"
        if forced:
            tf, tf_near = teacher_forced(eng, ref, utts[:SLOTS], 16)
            forced_text = (f"max |dlogit| {tf!r}, slot-frames let through "
                           f"near the threshold {tf_near}")
        if name in FIRST_FLIP:
            check_first_flips(name, eng, ref, utts, logits, ref_logits)
        prof = loop.sparsity_profile()
        print(f"serve {name}: {len(utts)} streams, {loop.steps} steps, "
              f"{loop.frames_served} frames in {secs!r} s = "
              f"{loop.frames_served / secs!r} frames/s; launches "
              f"{ {n: c for n, c in counts.items() if c} }; argmax agreement "
              f"with ref {agree!r}; spike flip rate {flips!r}; "
              f"teacher-forced {forced_text}; L0/L1 density "
              f"{prof.l0_density}/{prof.l1_density}, FC union "
              f"{prof.fc_union_density!r}, delta_input_density "
              f"{prof.delta_input_density!r}; MMAC/s "
              f"{loop.mmac_per_second()!r}")
        served[name] = (eng, logits)
        if profiled:
            device_busy(eng, utts, name)
    for name, (fields, per_step) in LAYOUT_PARITY.items():
        _, _, logits, _, _ = serve_counted(
            f"{name} as csc", paths["nm as csc"], arts["nm as csc"], fields,
            per_step, utts, launches)
        if not all(np.array_equal(a, b)
                   for a, b in zip(logits, served[name][1])):
            raise AssertionError(f"{name}: logits over the 2:4 mask differ "
                                 f"between the csc and nm_group artifacts")
        print(f"serve {name}: logits bit-equal over the csc and the "
              f"nm_group artifact of the same 2:4 mask")
    for name in reversed(SERVED):  # order effects: serve again, reversed
        if SERVED[name][4] == "csc":
            loop, _, secs = serve(served[name][0], utts)
            print(f"serve again {name}: {loop.frames_served / secs!r} "
                  f"frames/s")
    return launches, served


# Phase 4b: the loops served against phase 4's eager v1 loop, each step a
# captured graph
GRAPH = {"aot_warmup": True}
GRAPH_LOOPS = {"v2": {"pipeline_depth": 2, **GRAPH},
               f"v2 C={MEGA_FRAMES}": {"pipeline_depth": 2,
                                       "chunk_frames": MEGA_FRAMES,
                                       "ring_frames": 256, **GRAPH},
               "v1 graph": {"pipeline_depth": 0, **GRAPH},
               f"v1 C={MEGA_FRAMES}": {"pipeline_depth": 0,
                                       "chunk_frames": MEGA_FRAMES, **GRAPH}}
SPREAD = ("pallas", "fused", "fused float")  # frames/s spread, 3 runs each
SPREAD_LOOPS = {"v1 eager": V1_EAGER, "v2": GRAPH_LOOPS["v2"],
                f"v2 C={MEGA_FRAMES}": GRAPH_LOOPS[f"v2 C={MEGA_FRAMES}"]}
PROFILED_V2 = ("pallas", "fused")


def serve_graphs(served: dict, utts) -> None:
    """Phase 4b: every configuration of ``SERVED`` over the ``csc`` and the
    float artifact through each loop of ``GRAPH_LOOPS``: each request's
    logits bit-equal to phase 4's eager v1 loop; each kernel's launches
    steps x (1 for the mega-step, else the chunk's frames) x its launches
    a frame, credited at each graph replay; one capture at construction
    and none during the serve; no step in flight after ``run``.  Then the
    frames/s of ``SPREAD`` in turns, and ``PROFILED_V2`` under the
    profiler at chunks of ``MEGA_FRAMES``."""
    frames = sum(map(len, utts))
    for name, (_, per_step, _, _, key) in SERVED.items():
        if key not in ("csc", "float"):
            continue
        eng, want = served[name]
        mega = any(k.startswith("megastep") for k in per_step)
        for loop_name, kw in GRAPH_LOOPS.items():
            before = eng.capture_count
            t0 = time.perf_counter()
            loop = make_loop(eng, **kw)
            built = time.perf_counter() - t0
            if eng.capture_count != before + 1:
                raise AssertionError(f"{name} {loop_name}: "
                                     f"{eng.capture_count - before} "
                                     f"captures at construction, not 1")
            set_counts(0)
            loop, done, secs = serve(eng, utts, loop=loop)
            counts = read_counts()
            per_replay = 1 if mega else loop.chunk_frames
            for n, c in counts.items():
                if c != loop.steps * per_replay * per_step.get(n, 0):
                    raise AssertionError(
                        f"{name} {loop_name}: {n} launched {c} times, "
                        f"expected {loop.steps} steps x {per_replay} x "
                        f"{per_step.get(n, 0)}")
            if eng.capture_count != before + 1 or loop.pending_steps:
                raise AssertionError(
                    f"{name} {loop_name}: captures "
                    f"{eng.capture_count - before}, steps in flight "
                    f"{loop.pending_steps} after the serve")
            if not all(np.array_equal(r.stacked_logits(), w)
                       for r, w in zip(done, want)):
                raise AssertionError(f"{name} {loop_name}: logits differ "
                                     f"from the eager v1 loop's")
            print(f"serve {name} {loop_name}: logits bit-equal to eager "
                  f"v1; {loop.steps} steps, {loop.dispatches / frames!r} "
                  f"dispatches and {loop.host_syncs / frames!r} host syncs "
                  f"a frame; {frames / secs!r} frames/s; built in "
                  f"{built!r} s; launches "
                  f"{ {n: c for n, c in counts.items() if c} }")
            # the requests hold their pinned logit blocks: let them go
            # before the next serve, as a server hands its results on
            del loop, done
    for name in SPREAD:
        eng = served[name][0]
        runs = {k: [] for k in SPREAD_LOOPS}
        for _ in range(3):
            for loop_name, kw in SPREAD_LOOPS.items():
                runs[loop_name].append(frames / serve(eng, utts, **kw)[2])
        for loop_name, fps in runs.items():
            print(f"frames/s {name} {loop_name}: runs {fps!r}; median "
                  f"{float(np.median(fps))!r}, spread "
                  f"{max(fps) - min(fps)!r}")
    for name in PROFILED_V2:
        device_busy(served[name][0], utts, f"{name} v2 C={MEGA_FRAMES}",
                    **GRAPH_LOOPS[f"v2 C={MEGA_FRAMES}"])
        host_profile(served[name][0], utts, f"{name} v2 C={MEGA_FRAMES}",
                     **GRAPH_LOOPS[f"v2 C={MEGA_FRAMES}"])


# Phase 4f: sharded serving, each shard's step a captured graph
SHARDED = ("pallas", "fused", "delta threshold=0", "fused float")
SHARD_LISTS = {"1 shard": 1, "4 shards": 4}  # entries of cuda:0
SHARDED_LOOPS = {"v2": {"pipeline_depth": 2},
                 f"v2 C={MEGA_FRAMES}": {"pipeline_depth": 2,
                                         "chunk_frames": MEGA_FRAMES}}
SHARD_MAX_FRAMES = 128  # the frame buffer's rows a slot (ring: 128 rows)


def check_sharded(served: dict, utts, dev, smi: str) -> None:
    """Phase 4f: ``SHARDED`` through ``ShardedStreamLoop`` over ``[dev]``
    and ``[dev] * 4`` (256 and 64 slots a shard), at v2 and v2 in chunks
    of ``MEGA_FRAMES``, fed by ``AsyncFeaturizer.for_loop`` +
    ``submit_stream(quantized=True)``: each request's logits bit-equal to
    phase 4's eager v1 loop; each kernel's launches steps x shards x (1
    for the mega-step, else the chunk's frames) x its launches a frame;
    ``capture_count`` up by the shards at construction and not during the
    serve; no step in flight after ``run``; each shard's state and ring
    ``SLOTS / shards`` slots on ``dev``.  The CPU featurizer equals
    ``quantize_features`` on the card over every utterance, for each
    artifact's scale.  Then ``bench_stream_sharded`` and the example's
    ``--sharded`` at ``SLOTS`` slots on the card.  Frames/s, dispatches
    and host syncs a frame are printed."""
    from repro_torch.benchmarks.paper_tables import bench_stream_sharded
    from repro_torch.data.featurize import AsyncFeaturizer, cpu_quantizer
    from repro_torch.distributed.sharding import stream_state_specs
    from repro_torch.serving.sharded import ShardedStreamLoop
    from repro_torch.serving.stream import _leaves

    t_phase = time.perf_counter()
    print(f"phase 4f on {smi}")
    frames = sum(map(len, utts))
    for name in ("pallas", "fused float"):  # the csc and the float scale
        eng = served[name][0]
        quant = cpu_quantizer(eng)
        for u in utts:
            if not np.array_equal(quant(u),
                                  eng.quantize_features(u).cpu().numpy()):
                raise AssertionError(f"{name}: the CPU featurizer differs "
                                     f"from quantize_features on the card")
        print(f"sharded {name}: the CPU featurizer bit-equal to "
              f"quantize_features on the card over {len(utts)} utterances")
    for name in SHARDED:
        eng, want = served[name]
        per_step = SERVED[name][1]
        mega = any(k.startswith("megastep") for k in per_step)
        for list_name, n in SHARD_LISTS.items():
            for loop_name, kw in SHARDED_LOOPS.items():
                label = f"{name} {list_name} {loop_name}"
                before = eng.capture_count
                loop = ShardedStreamLoop(eng, batch_slots=SLOTS,
                                         devices=[dev] * n,
                                         max_frames=SHARD_MAX_FRAMES, **kw)
                captured = eng.capture_count - before
                if captured != n:
                    raise AssertionError(f"{label}: {captured} captures, "
                                         f"not {n}")
                dims = _flat_ints(stream_state_specs(loop.shard_states[0]))
                for state, ring in zip(loop.shard_states, loop.shard_rings):
                    for leaf, dim in zip(_leaves(state), dims):
                        if leaf.shape[dim] != SLOTS // n or \
                                leaf.device != torch.device(dev):
                            raise AssertionError(f"{label}: a state leaf "
                                                 f"{tuple(leaf.shape)} on "
                                                 f"{leaf.device}")
                    if ring.shape[0] != SLOTS // n or \
                            ring.device != torch.device(dev):
                        raise AssertionError(f"{label}: ring "
                                             f"{tuple(ring.shape)}")
                feat = AsyncFeaturizer.for_loop(loop, utts)
                set_counts(0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.submit_stream(feat, quantized=True)
                done = loop.run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = read_counts()
                per_replay = 1 if mega else loop.chunk_frames
                for k, c in counts.items():
                    if c != loop.steps * n * per_replay * per_step.get(k, 0):
                        raise AssertionError(
                            f"{label}: {k} launched {c} times, expected "
                            f"{loop.steps} steps x {n} shards x "
                            f"{per_replay} x {per_step.get(k, 0)}")
                if eng.capture_count != before + n or loop.pending_steps:
                    raise AssertionError(
                        f"{label}: captures {eng.capture_count - before}, "
                        f"steps in flight {loop.pending_steps}")
                if len(done) != len(want) or not all(
                        np.array_equal(r.stacked_logits(), w)
                        for r, w in zip(done, want)):
                    raise AssertionError(f"{label}: logits differ from the "
                                         f"eager v1 loop's")
                print(f"sharded {label}: logits bit-equal to eager v1; "
                      f"{loop.steps} steps, {loop.dispatches / frames!r} "
                      f"dispatches and {loop.host_syncs / frames!r} host "
                      f"syncs a frame; {frames / secs!r} frames/s; launches "
                      f"{ {k: c for k, c in counts.items() if c} }")
                del loop, done, feat
    us, row = bench_stream_sharded(dev)
    print(f"bench_stream_sharded: {us!r} us a step, {row}")
    out = run_example_main(["--slots", str(SLOTS), "--streams", str(STREAMS),
                            "--device", torch.device(dev).type, "--sharded"])
    if "sharded over" not in out:
        raise AssertionError("example --sharded: no sharded loop")
    print(f"phase 4f: {time.perf_counter() - t_phase!r} s")


def _flat_ints(tree) -> list:
    """The leaves of a (nested) NamedTuple of slot dimensions."""
    if isinstance(tree, tuple):
        return [x for f in tree for x in _flat_ints(f)]
    return [tree]


def host_profile(engine, utts, name: str, **loop_kw) -> None:
    """One StreamLoop run under ``cProfile`` (the host's Python, the
    card's work unseen): its wall time and the functions that took most
    of it, by their own time."""
    import cProfile
    import pstats

    loop = make_loop(engine, **loop_kw)
    prof = cProfile.Profile()
    prof.enable()
    _, _, secs = serve(engine, utts, loop=loop)
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(((tt, nc, f"{Path(f).name}:{ln}({fn})")
                  for (f, ln, fn), (_, nc, tt, _, _) in stats.items()),
                 reverse=True)[:10]
    print(f"host profile ({name}): {secs!r} s over {loop.steps} steps; "
          f"own time: " + "; ".join(f"{where} x{nc} {tt * 1e3:.1f} ms"
                                    for tt, nc, where in top))


def check_chunk(path, art, utts, backend: str) -> None:
    """The chunk axis on the card: ``_chunk_step`` over ``MEGA_FRAMES``
    frames (after as many single steps from zero) equals as many ``step``
    calls bit for bit, state, logits and counters, in one launch of the
    backend's kernel against one a frame and none of any other.  An int4
    artifact is served with ``sparse_fc``."""
    from repro_torch.serving.stream import CompiledRSNN, EngineConfig

    eng = CompiledRSNN.from_artifact(path, EngineConfig(
        backend=backend, precision=art.precision,
        sparse_fc=art.precision == "int4", input_scale=art.input_scale))
    kernel = "megastep_spike" if backend == "fused_spike" else "megastep"
    x = torch.from_numpy(np.stack([u[:2 * MEGA_FRAMES]
                                   for u in utts[:SLOTS]], 1))
    xq = eng.quantize_features(x)
    state = eng.init_state(SLOTS)
    for t in range(MEGA_FRAMES):
        state, _, _ = eng.step(state, xq[t])
    chunk = xq[MEGA_FRAMES:]
    set_counts(0)
    st_c, lg_c, aux_c = eng._chunk_step(state, chunk)
    torch.cuda.synchronize()
    n_chunk = read_counts()
    set_counts(0)
    st_f, lg_f, aux_f = state, [], []
    for x_t in chunk:
        st_f, lg, aux = eng.step(st_f, x_t)
        lg_f.append(lg)
        aux_f.append(aux)
    torch.cuda.synchronize()
    n_steps = read_counts()
    for counts, want in ((n_chunk, 1), (n_steps, MEGA_FRAMES)):
        if counts != {k: want if k == kernel else 0 for k in counts}:
            raise AssertionError(f"chunk {backend}: launches {counts}, "
                                 f"expected {want} of {kernel} only")
    same = torch.equal(lg_c, torch.stack(lg_f)) and all(
        torch.equal(a, b) for a, b in zip(
            (st_c.h0, st_c.h1, st_c.lif0.u, st_c.lif0.spike, st_c.lif1.u,
             st_c.lif1.spike),
            (st_f.h0, st_f.h1, st_f.lif0.u, st_f.lif0.spike, st_f.lif1.u,
             st_f.lif1.spike))) and all(
        torch.equal(aux_c[k], torch.stack([a[k] for a in aux_f]))
        for k in aux_c)
    if not same:
        raise AssertionError(f"chunk {backend}: {MEGA_FRAMES}-frame chunk "
                             f"differs from {MEGA_FRAMES} steps")
    print(f"chunk {backend} {art.precision}: _chunk_step over "
          f"{MEGA_FRAMES} frames == "
          f"{MEGA_FRAMES} steps bit for bit; {kernel} launches "
          f"{n_chunk[kernel]} against {n_steps[kernel]}")


def check_forward(path, art, utts, streams: int = 8,
                  frames: int = 40) -> None:
    """The float golden model on the card: ``core.rsnn.forward`` over
    ``streams`` windows of ``frames`` frames, the first around the largest
    |feature| of ``utts`` (so that forward's own max-abs input scale is
    the artifact's), against the ``ref`` engine stepping the same frames
    from zero state: the same plain operations in the same order, so
    logits within ``LOGIT_ATOL`` and the last spike trains equal."""
    from repro_torch.core import rsnn
    from repro_torch.serving.stream import CompiledRSNN, _to

    eng = CompiledRSNN.from_artifact(path, backend="ref")
    k = int(np.argmax([np.abs(u).max() for u in utts]))
    top = int(np.abs(utts[k]).max(axis=1).argmax())
    t0 = min(max(top - frames // 2, 0), len(utts[k]) - frames)
    rest = [u[:frames] for i, u in enumerate(utts) if i != k]
    x = torch.from_numpy(np.stack([utts[k][t0:t0 + frames]]
                                  + rest[:streams - 1])).to(eng.device)
    logits, state, aux = rsnn.forward(_to(art.params, eng.device), x,
                                      art.cfg)
    xq = eng.quantize_features(x.transpose(0, 1))
    st, steps = eng.init_state(streams), []
    for x_t in xq:
        st, lg, _ = eng.step(st, x_t)
        steps.append(lg)
    d = float((logits - torch.stack(steps, dim=1)).abs().max())
    if d > LOGIT_ATOL or not (torch.equal(state.h0, st.h0)
                              and torch.equal(state.h1, st.h1)):
        raise AssertionError(f"rsnn.forward differs from the ref engine: "
                             f"|dlogit| {d}")
    print(f"forward: core.rsnn.forward == ref engine over {streams} "
          f"streams x {frames} frames, max |dlogit| {d!r}; rates "
          f"{ {n: v.tolist() for n, v in aux.items()} }")


# ------------------------------------------------------ in-process packing

# the in-process recipes at PRUNED width: the FC pruned 40% by magnitude
# (padded CSC), 2:4 (N:M), mixed-level (l0_wh 2:4 beside the FC's 40%) and
# no pruning (dense int4 only)
PACK_RECIPES = {
    "csc": CompressionConfig(fc_prune_frac=0.4, weight_bits=4),
    "nm": CompressionConfig(weight_bits=4, prune_specs=(
        ("fc_w", PruneSpec(kind="nm", n=2, m=4)),)),
    "mixed": CompressionConfig(fc_prune_frac=0.4, weight_bits=4, prune_specs=(
        ("l0_wh", PruneSpec(kind="nm", n=2, m=4)),)),
    "dense": CompressionConfig(weight_bits=4),
}
# served through the v2 graph loop from the in-process engine and from its
# reloaded artifact: recipe -> backend -> (sparse_fc, launches a step)
PACK_SERVED = {
    "csc": {"fused": (True, {"megastep": 1}),
            "sparse": (True, {"rsnn_cell": 2, "int4_matmul": 2,
                              "sparse_fc": 1}),
            "pallas": (False, {"rsnn_cell": 2, "int4_matmul": 2,
                               "merged_spike_fc": 1})},
    "nm": {"fused": (True, {"megastep": 1}),
           "sparse": (True, {"rsnn_cell": 2, "int4_matmul": 2,
                             "nm_fc": 1})},
}


def pack_timed(params: dict, ccfg) -> tuple[object, object, float]:
    """``init_compression`` then ``pack_model`` of ``params`` on their
    device: (packed, cstate, ms, host clock around a synchronised call)."""
    from repro_torch.core.compression import init_compression
    from repro_torch.core.sparse import pack_model

    sync = params["fc_w"].is_cuda
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    cstate = init_compression(params, ccfg)
    packed = pack_model(params, PRUNED, ccfg, cstate)
    if sync:
        torch.cuda.synchronize()
    return packed, cstate, (time.perf_counter() - t0) * 1e3


def assert_same_packed(what: str, got, want) -> None:
    """Every array of two packed models (as ``save_artifact`` flattens
    them) bit-equal, dtypes and layout tags included."""
    from repro_torch.core.artifact import _flatten_packed

    (a, tags_a), (b, tags_b) = _flatten_packed(got), _flatten_packed(want)
    if tags_a != tags_b or a.keys() != b.keys():
        raise AssertionError(f"{what}: layouts {tags_a} against {tags_b}")
    for key in b:
        if a[key].dtype != b[key].dtype or not np.array_equal(a[key],
                                                              b[key]):
            raise AssertionError(f"{what}: {key} differs")


def check_packing(seed: int, utts, tmp: Path, dev) -> None:
    """Phase 4c: the port packs an int4 model itself and serves it.  The
    seeded float ``PRUNED`` parameters (``float_params``) packed on the
    card (``dev``) in each ``PACK_RECIPES`` recipe, bit-equal to the same
    packing on the CPU, the size reports equal and
    ``broadcast_total_bytes`` equal to ``compressed_size_bytes``;
    ``save_artifact`` then ``load_artifact`` gives the same arrays; every
    ``PACK_SERVED`` configuration serves the 512 streams through the v2
    graph loop from ``CompiledRSNN(cfg, params,
    EngineConfig(precision="int4"), ccfg)`` (packed in process on the
    card) and from its reloaded artifact, logits bit-equal, each kernel
    launched steps x its launches a step."""
    from repro_torch.core.compression import compressed_size_bytes
    from repro_torch.core.sparse import packed_size_report
    from repro_torch.serving.stream import CompiledRSNN, EngineConfig

    params = params_from_arrays(float_params(seed, PRUNED), PRUNED)
    on_card = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                   type(v)(*(t.to(dev) for t in v)))
               for k, v in params.items()}
    scale = input_scale(utts)
    paths = {}
    for name, ccfg in PACK_RECIPES.items():
        packed, cstate, first_ms = pack_timed(on_card, ccfg)
        packed, cstate, ms = pack_timed(on_card, ccfg)
        if packed.quant["fc_w"].packed.device != on_card["fc_w"].device:
            raise AssertionError(f"pack {name}: packed off the card")
        cpu, _, cpu_ms = pack_timed(params, ccfg)
        assert_same_packed(f"pack {name}: the card against the CPU",
                           packed, cpu)
        report = packed_size_report(packed)
        if report != packed_size_report(cpu) or \
                report["broadcast_total_bytes"] != compressed_size_bytes(
                    on_card, ccfg, cstate):
            raise AssertionError(f"pack {name}: size reports differ")
        if name == "csc" and report["broadcast_total_bytes"] != 100_864.0:
            raise AssertionError(f"pack csc: "
                                 f"{report['broadcast_total_bytes']} B, "
                                 f"not 100,864")
        paths[name] = save_artifact(tmp / f"packed_{name}", cfg=PRUNED,
                                    packed=packed, ccfg=ccfg,
                                    input_scale=scale, backend="fused")
        back = load_artifact(paths[name]).packed
        assert_same_packed(f"pack {name}: save_artifact -> load", back,
                           cpu)
        tags = {n: v["layout"] for n, v in report.items()
                if isinstance(v, dict) and "layout" in v}
        print(f"pack {name}: on the card {ms!r} ms (first call "
              f"{first_ms!r} ms; the CPU {cpu_ms!r} ms), bit-equal to the "
              f"CPU's packing and to its saved artifact; layouts {tags}, "
              f"broadcast_total_bytes {report['broadcast_total_bytes']!r} B "
              f"(= compressed_size_bytes), total_bytes "
              f"{report['total_bytes']!r} B")
    for name, configs in PACK_SERVED.items():
        for backend, (sparse_fc, per_step) in configs.items():
            cfg_kw = {"backend": backend, "precision": "int4",
                      "sparse_fc": sparse_fc, "input_scale": scale}
            serve_in_process_and_reloaded(
                f"packed {name} {backend}", lambda: CompiledRSNN(
                    PRUNED, params, EngineConfig(**cfg_kw),
                    PACK_RECIPES[name], device=dev),
                lambda: CompiledRSNN.from_artifact(
                    paths[name], EngineConfig(**cfg_kw), device=dev),
                per_step, utts)


def serve_in_process_and_reloaded(label: str, in_process, reloaded,
                                  per_step: dict, utts) -> None:
    """The engines that ``in_process()`` and ``reloaded()`` make, each
    serving ``utts`` through the v2 graph loop: each kernel launched steps
    x its launches a step (``per_step``), and the two runs' logits finite
    and bit-equal."""
    frames = sum(map(len, utts))
    runs = {}
    for source, make in (("in-process", in_process), ("reloaded", reloaded)):
        eng = make()
        loop = make_loop(eng, **GRAPH_LOOPS["v2"])
        set_counts(0)
        loop, done, secs = serve(eng, utts, loop=loop)
        counts = read_counts()
        for n, c in counts.items():
            if c != loop.steps * per_step.get(n, 0):
                raise AssertionError(
                    f"{label} {source}: {n} launched {c} times, expected "
                    f"{loop.steps} steps x {per_step.get(n, 0)}")
        runs[source] = [r.stacked_logits() for r in done]
        print(f"serve {label} ({source}, v2 graph): {frames / secs!r} "
              f"frames/s; launches "
              f"{ {n: c for n, c in counts.items() if c} }; "
              f"fc_prune_frac {eng.fc_prune_frac!r}")
        del loop, done
    if not all(np.array_equal(a, b) and np.isfinite(a).all()
               for a, b in zip(runs["in-process"], runs["reloaded"])):
        raise AssertionError(f"{label}: the reloaded artifact's logits "
                             f"differ")
    print(f"serve {label}: {len(utts)} streams, in-process and reloaded "
          f"logits bit-equal")


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def run_example_main(argv: list[str]) -> str:
    """``examples/stream_asr_torch.py``'s ``main(argv)``; its output is
    printed and returned.  A nonzero exit raises."""
    example = load_example("stream_asr_torch")
    print(f"example: stream_asr_torch.py {' '.join(argv)}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = example.main(argv)
    print(out.getvalue(), end="")
    if code != 0:
        raise AssertionError(f"example {argv}: nonzero exit")
    return out.getvalue()


def run_example(tmp: Path, dev) -> None:
    """``examples/stream_asr_torch.py``'s ``main`` on the card at 256
    slots and 512 streams: in process (the default ``fused`` backend over
    the 40% CSC recipe), then as a ``--save-artifact`` / ``--artifact``
    pair, whose two runs must print the same predictions; its report
    lines are printed."""
    base = ["--slots", str(SLOTS), "--streams", str(STREAMS), "--device",
            torch.device(dev).type]
    art = str(tmp / "example_artifact")
    preds = []
    for extra in ([], ["--layout", "nm", "--save-artifact", art],
                  ["--artifact", art]):
        out = run_example_main(base + extra)
        preds.append([ln for ln in out.splitlines()
                      if "first predictions" in ln])
    if not preds[1] or preds[1] != preds[2]:
        raise AssertionError("example: the saved artifact serves other "
                             "predictions than the in-process model")

# ---------------------------------------------------- training (phase 4d)

TRAIN_BATCH = 32  # utterances a training step
ONE_STEP_FRAMES = 8  # frames an utterance in the card-against-CPU step
ONE_STEP_TS = 2  # time steps of that step (BASELINE's)
# the card-against-CPU step's gradients: max |g - g_cpu| <= GRAD_TOL max
# |g_cpu| over each leaf, where no spike differs.  The CPU rehearsal (this
# step in float32 against float64 on the CPU, seeds 0-2, spikes equal)
# measured at most 4.0e-4 of a leaf's largest element (lif0.raw_beta, whose
# terms cancel over the batch and frames; fc_w 2e-7); two float32 devices
# differ by at most twice one's error, and the bound leaves 5x to spare
GRAD_TOL = 4e-3
RECIPE_STEPS = 6  # steps a stage: TS 4 for 2 steps, then TS 2 (temporal)
# the exported model, served: backend -> launches a step (FC CSC, K6 or K4)
TRAINED_SERVED = {"fused": {"megastep": 1},
                  "sparse": {"rsnn_cell": 2, "int4_matmul": 2,
                             "sparse_fc": 1}}


@contextlib.contextmanager
def recorded_lif_steps(calls: list):
    """Every ``lif.lif_step`` call's (u, spike), detached, appended to
    ``calls`` in call order: frame by frame, L0's time steps, then L1's."""
    from repro_torch.core import lif as lif_lib

    step = lif_lib.lif_step

    def record(params, state, stimulus, slope=25.0, hw_rounded=False):
        new, h = step(params, state, stimulus, slope, hw_rounded)
        calls.append((new.u.detach(), h.detach()))
        return new, h

    lif_lib.lif_step = record
    try:
        yield
    finally:
        lif_lib.lif_step = step


def loss_and_grads(params: dict, batch: dict, cfg: RSNNConfig, num_ts: int
                   ) -> tuple[float, dict, list]:
    """``rsnn.loss_fn`` and its gradient in every parameter, as
    ``make_train_step`` takes them, with the LIF steps' (u, spike)."""
    from repro_torch.core import rsnn

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    calls: list = []
    with recorded_lif_steps(calls):
        loss, _ = rsnn.loss_fn(leaves, batch, cfg, num_ts=num_ts)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return (float(loss.detach()), tree_unflatten(params, iter(grads)),
            calls)


def train_u_bounds(params: dict, xq: torch.Tensor, calls: list, cfg,
                   num_ts: int) -> list[torch.Tensor]:
    """For each recorded LIF step (CPU tensors) the u rule's bound on two
    float32 devices' |du|: 2 gamma(n) A + 2^-23 vth, A the float64 chain
    of the summands' magnitude as ``lif_bound`` carries it (|x| @ |W0x| +
    |h0| @ |W0h| for L0, |s0| @ |W1x| + |h1| @ |W1h| for L1, plus beta
    (1 - h) (|u| + A) of the step before), n the longest sum (D + H for
    L0, 2 H for L1)."""
    from repro_torch.core import lif as lif_lib

    b, t_frames, d = xq.shape
    h = cfg.hidden_dim
    w = {n: params[n].double().abs() for n in cfg.layer_shapes}
    consts = [lif_lib.inference_constants(params[f"lif{i}"],
                                          cfg.hw_rounded_lif)
              for i in (0, 1)]
    n = (d + h, 2 * h)
    z = torch.zeros(b, h, dtype=torch.float64)
    a, u_prev, h_prev = [z, z], [z, z], [z, z]
    prev = [[z] * num_ts, [z] * num_ts]
    bounds, it = [], iter(calls)
    for t in range(t_frames):
        trains = [[], []]
        for layer in (0, 1):
            beta, vth = (c.double() for c in consts[layer])
            for k in range(num_ts):
                if layer == 0:
                    mag = xq[:, t].double().abs() @ w["l0_wx"] \
                        + prev[0][k] @ w["l0_wh"]
                else:
                    mag = trains[0][k] @ w["l1_wx"] + prev[1][k] @ w["l1_wh"]
                a[layer] = mag + beta * (1.0 - h_prev[layer]) * (
                    u_prev[layer].abs() + a[layer])
                bounds.append(2 * gamma(n[layer]) * a[layer]
                              + 2 * EPS32 * vth)
                u, s = next(it)
                u_prev[layer], h_prev[layer] = u.double(), s.double()
                trains[layer].append(s.double())
        prev = trains
    return bounds


def check_one_step(seed: int, dev) -> None:
    """Phase 4d (a): one training step on the card and on the CPU from the
    same seeded ``BASELINE`` parameters (``float_params``) and batch
    (``TRAIN_BATCH`` utterances of ``ONE_STEP_FRAMES`` frames).  Every LIF
    step's spikes must agree, except where the CPU's |u - vth| lies within
    the u rule (``train_u_bounds``); from the first step where one
    differs the later frames are not compared, and the count is printed.
    Where no spike differs, every gradient leaf must agree within
    ``GRAD_TOL`` of its largest element, and ``make_train_step``'s loss,
    gradient norm and updated parameters with it."""
    from repro_torch.core import lif as lif_lib
    from repro_torch.core import spike_ops
    from repro_torch.core.compression import (CompressionConfig,
                                              init_compression)
    from repro_torch.data.synthetic import SpeechDataConfig, TimitLikeStream
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.rsnn_pipeline import make_train_step

    cfg, ts = BASELINE, ONE_STEP_TS
    cpu = params_from_arrays(float_params(seed, BASELINE), BASELINE)
    card = tree_map(lambda v: v.to(dev), cpu)
    host = TimitLikeStream(SpeechDataConfig(frames=ONE_STEP_FRAMES)).batch(
        TRAIN_BATCH, step=0)
    batches = {d: {k: torch.from_numpy(v).to(d) for k, v in host.items()}
               for d in ("cpu", dev)}
    xq = spike_ops.quantize_input(batches["cpu"]["features"])[0]
    if not torch.equal(spike_ops.quantize_input(
            batches[dev]["features"])[0].cpu(), xq):
        raise AssertionError("train step: the card's quantized input "
                             "differs from the CPU's")
    t0 = time.perf_counter()
    loss_c, g_card, calls_card = loss_and_grads(card, batches[dev], cfg, ts)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    loss_h, g_cpu, calls_cpu = loss_and_grads(cpu, batches["cpu"], cfg, ts)
    bounds = train_u_bounds(cpu, xq, calls_cpu, cfg, ts)
    vth = [lif_lib.inference_constants(cpu[f"lif{i}"])[1] for i in (0, 1)]
    flips, first = 0, None
    for i, ((uc, hc), (uh, hh), bound) in enumerate(
            zip(calls_card, calls_cpu, bounds)):
        diff = hc.cpu() != hh
        if not bool(diff.any()):
            continue
        layer = (i // ts) % 2
        near = (uh.double() - vth[layer].double()).abs() <= bound
        if not bool(near[diff].all()):
            j = int(torch.nonzero(diff & ~near)[0, 0])
            raise AssertionError(
                f"train step: a spike differs away from the threshold at "
                f"LIF step {i} (frame {i // (2 * ts)}, L{layer}, ts "
                f"{i % ts}), slot {j}")
        flips, first = int(diff.sum()), i
        break
    rates = [float(torch.stack([h for _, h in calls_cpu[k::2 * ts]]).mean())
             for k in range(2 * ts)]
    print(f"train step (a): BASELINE, {TRAIN_BATCH} utterances x "
          f"{ONE_STEP_FRAMES} frames, TS {ts}: loss card {loss_c!r} CPU "
          f"{loss_h!r}; card forward+backward {card_s!r} s (first call); "
          f"spike rates per LIF step (L0 ts.., L1 ts..) {rates}")
    if first is not None:
        print(f"train step (a): {flips} spikes flipped near the threshold "
              f"(within the u rule) at LIF step {first} of {len(calls_cpu)} "
              f"(frame {first // (2 * ts)}); later frames and the gradients "
              f"not compared")
        return
    print(f"train step (a): all {len(calls_cpu)} LIF steps' spikes equal "
          f"({sum(h.numel() for _, h in calls_cpu)} spikes)")
    worst = {}
    for (k, gc), (_, gh) in zip(checkpoint_items(g_card),
                                checkpoint_items(g_cpu)):
        scale = float(gh.abs().max())
        ratio = float((gc.cpu() - gh).abs().max()) / max(scale, 1e-30)
        worst[k] = ratio
        if ratio > GRAD_TOL:
            raise AssertionError(f"train step: gradient {k} differs by "
                                 f"{ratio!r} of its largest element")
    print(f"train step (a): gradients, max |g - g_cpu| / max |g_cpu| "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (<= "
          f"{GRAD_TOL})")
    # the optimizer step itself on both: Adam's first update is about
    # +-lr where |g| >> eps, so the parameters agree except where g lies
    # so near 0 that the gradient tolerance lets its sign or |g| / (|g| +
    # eps) move (within 100 x GRAD_TOL of the leaf's largest element)
    ocfg = OptimizerConfig(name="adamw", lr=3.5e-3, warmup_steps=5,
                           decay_steps=RECIPE_STEPS, weight_decay=0.0)
    ccfg = CompressionConfig()
    out = {}
    for d, p in (("cpu", cpu), (dev, card)):
        step = make_train_step(cfg, ocfg, ccfg, init_compression(p, ccfg),
                               ts)
        out[d] = step({"params": p, "opt": opt_lib.init_opt_state(p, ocfg)},
                      batches[d])
    (new_h, m_h), (new_c, m_c) = out["cpu"], out[dev]
    lr = float(m_h["lr"])
    if abs(float(m_c["loss"]) - loss_c) > 1e-6 * abs(loss_c) or abs(
            float(m_c["grad_norm"]) - float(m_h["grad_norm"])) > \
            GRAD_TOL * float(m_h["grad_norm"]):
        raise AssertionError("train step: make_train_step's loss or "
                             "gradient norm differs")
    moved = 0
    for (k, pc), (_, ph), (_, gh) in zip(
            checkpoint_items(new_c["params"]), checkpoint_items(
                new_h["params"]), checkpoint_items(g_cpu)):
        d = (pc.cpu() - ph).abs()
        small = gh.abs() <= 100 * GRAD_TOL * float(gh.abs().max())
        if bool((d > 1e-6 * (1 + ph.abs()))[~small].any()) or \
                bool((d > 2 * lr + 1e-6)[small].any()):
            raise AssertionError(f"train step: updated {k} differs")
        moved += int((d > 1e-6 * (1 + ph.abs())).sum())
    print(f"train step (a): make_train_step on both, loss "
          f"{float(m_c['loss'])!r}, grad_norm {float(m_c['grad_norm'])!r} "
          f"(CPU {float(m_h['grad_norm'])!r}), lr {lr!r}; updated "
          f"parameters equal within 1e-6 (1 + |p|) but {moved} where |g| "
          f"is near 0")


def checkpoint_items(tree) -> list:
    """(key, leaf) pairs of a parameter tree, keyed as the checkpoints key
    them."""
    from repro_torch.checkpoint.checkpointer import _flatten

    return _flatten(tree)


def check_recipe(seed: int, tmp: Path, dev):
    """Phase 4d (b): ``run_pipeline`` on the card at full width (hidden 256
    -> 128, FC 1920, 100-frame utterances, batch ``TRAIN_BATCH``, the
    temporal schedule on, ``RECIPE_STEPS`` steps a stage), stopped after
    ``structured`` and resumed with ``--artifact``'s export: the restored
    stages bit-equal to what was saved, their only records ``restored``.
    Prints steps/s a stage and each stage's (loss, frame error rate,
    size_bytes, mmac_skip), then the accelerator model at the QAT stage's
    measured sparsity.  Returns (the resumed results, the artifact)."""
    from repro_torch.core import complexity
    from repro_torch.training.rsnn_pipeline import run_pipeline

    records: list = []

    def sink(record: dict) -> None:
        records.append((time.perf_counter(), record))

    work, art = tmp / "train", tmp / "trained_artifact"
    kw = {"steps": RECIPE_STEPS, "batch_size": TRAIN_BATCH, "seed": seed,
          "workdir": work, "device": dev, "metric_sink": sink,
          "log_every": 1}
    t0 = time.perf_counter()
    first = run_pipeline(stop_after="structured", **kw)
    t1 = time.perf_counter()
    split = len(records)
    results = run_pipeline(resume=True, artifact_path=art, **kw)
    t2 = time.perf_counter()
    if [r.name for r in first] != ["baseline", "structured"] or \
            [r.name for r in results] != ["baseline", "structured",
                                          "unstructured", "qat4"]:
        raise AssertionError("recipe: unexpected stages")
    for a, b in zip(first, results):
        events = [r["event"] for _, r in records[split:]
                  if r["stage"] == a.name]
        same = all(torch.equal(x, y) for (_, x), (_, y) in zip(
            checkpoint_items({"params": a.params, "masks": a.cstate.masks}),
            checkpoint_items({"params": b.params, "masks": b.cstate.masks})))
        if events != ["restored"] or not same or b.params["fc_w"].device \
                != a.params["fc_w"].device:
            raise AssertionError(f"recipe: stage {a.name} was not restored "
                                 f"bit-equal (events {events})")
    print(f"recipe (b): stop after structured {t1 - t0!r} s, resume with "
          f"export {t2 - t1!r} s; baseline and structured restored "
          f"bit-equal, their only records ['restored']")
    for r in results:
        train = [(t, rec) for t, rec in records
                 if rec["stage"] == r.name and rec["event"] == "train"]
        rate = ((len(train) - 1) / (train[-1][0] - train[0][0])
                if len(train) > 1 else float("nan"))
        print(f"recipe (b): {r.name}: {r.cfg.hidden_dim} hidden, "
              f"{rate!r} steps/s over steps 1-{len(train) - 1} (TS "
              f"{[rec['num_ts'] for _, rec in train]}); loss {r.loss!r}, "
              f"frame_error_rate {r.error_rate!r}, size_bytes "
              f"{r.size_bytes!r}, mmac_skip {r.mmac_skip!r}")
    final = results[-1]
    ts = final.cfg.num_ts
    cyc = complexity.cycles_per_frame(final.cfg, ts,
                                      sparsity=final.sparsity,
                                      merged_spike=True)
    f = complexity.realtime_frequency_hz(cyc)
    print(f"recipe (b): qat4's measured sparsity {final.sparsity}: "
          f"cycles_per_frame {cyc!r}, realtime_frequency_hz {f!r}, "
          f"power_w at that clock {complexity.power_w(f)!r}, tops_per_watt "
          f"at 500 MHz "
          f"{complexity.tops_per_watt(final.cfg, ts, sparsity=final.sparsity)!r}"
          f" and at that clock "
          f"{complexity.tops_per_watt(final.cfg, ts, freq_hz=f, cycles=cyc)!r}")
    return results, art


def profile_train_step(seed: int, dev) -> None:
    """Where a full-width training step's time goes: ``make_train_step``
    on the seeded ``BASELINE`` parameters and ``TRAIN_BATCH`` 100-frame
    utterances at TS 4 and 2 (the temporal schedule's), one step to warm
    up, two timed on the host clock, then one under ``torch.profiler``:
    its device busy share, the device operations it ran and the most
    costly of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compression import (CompressionConfig,
                                              init_compression)
    from repro_torch.data.synthetic import SpeechDataConfig, TimitLikeStream
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.rsnn_pipeline import make_train_step

    params = tree_map(lambda v: v.to(dev), params_from_arrays(
        float_params(seed, BASELINE), BASELINE))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TimitLikeStream(
        SpeechDataConfig()).batch(TRAIN_BATCH, step=0).items()}
    ocfg = OptimizerConfig(name="adamw", lr=3.5e-3, warmup_steps=5,
                           decay_steps=RECIPE_STEPS, weight_decay=0.0)
    ccfg = CompressionConfig()
    for ts in (4, 2):
        step = make_train_step(BASELINE, ocfg, ccfg,
                               init_compression(params, ccfg), ts)
        state = {"params": params,
                 "opt": opt_lib.init_opt_state(params, ocfg)}
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = step(state, batch)
        float(m["loss"])
        secs = (time.perf_counter() - t0) / 2
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            prof_secs = time.perf_counter() - t0
        ops = [(e.self_device_time_total, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy_us = sum(t for t, _, _ in ops)
        top = "; ".join(f"{k[:40]} x{c} {t / 1e3:.2f} ms"
                        for t, c, k in sorted(ops, reverse=True)[:5])
        print(f"train step profile: BASELINE, {TRAIN_BATCH} x 100 frames, "
              f"TS {ts}: {secs!r} s a step ({1 / secs!r} steps/s); "
              f"profiled {prof_secs!r} s, device busy "
              f"{busy_us / 1e6 / prof_secs!r} of it, "
              f"{sum(c for _, c, _ in ops)} device operations, top: {top}")


def check_training(seed: int, utts, tmp: Path, dev) -> None:
    """Phase 4d: the compression recipe trains on the card (plain PyTorch:
    no kernel of the port lies on the training path) and the model it
    exports is served through K6 (``fused``, FC ``csc``) and K1, K2, K4
    (``sparse``): (a) ``check_one_step``, (b) ``check_recipe``, (c) the
    exported artifact served through the v2 graph loop from
    ``CompiledRSNN(final.cfg, final.params, EngineConfig(precision="int4",
    input_scale=...), final.ccfg, final.cstate)`` and from the artifact,
    logits bit-equal and launches counted."""
    from repro_torch.serving.stream import CompiledRSNN, EngineConfig

    t0 = time.perf_counter()
    check_one_step(seed, dev)
    results, art = check_recipe(seed, tmp, dev)
    profile_train_step(seed, dev)
    final = results[-1]
    scale = load_artifact(art).input_scale
    for backend, per_step in TRAINED_SERVED.items():
        cfg_kw = {"backend": backend, "precision": "int4", "sparse_fc": True,
                  "input_scale": scale}
        serve_in_process_and_reloaded(
            f"trained {backend}", lambda: CompiledRSNN(
                final.cfg, final.params, EngineConfig(**cfg_kw), final.ccfg,
                final.cstate, device=dev),
            lambda: CompiledRSNN.from_artifact(art, EngineConfig(**cfg_kw),
                                               device=dev),
            per_step, utts)
    print(f"phase 4d: {time.perf_counter() - t0!r} s")

# ------------------------------------------------ paper claims (phase 4e)

# ``tests/test_system.py``'s schedule at the paper's widths (40 -> 256 ->
# 256 -> 1920, then hidden 128): steps a stage, batch, utterance frames
CLAIM_STEPS = 90
CLAIM_BATCH = 16
CLAIM_FRAMES = 40


def paper_claims(results) -> list[str]:
    """``tests/test_system.py``'s four pipeline claims, with its
    thresholds, on ``run_pipeline``'s results: the claims that fail."""
    failed = []
    names = [r.name for r in results]
    if names != ["baseline", "structured", "unstructured", "qat4"]:
        return [f"stages {names}"]
    chance = 1.0 - 1.0 / results[0].cfg.fc_dim
    failed += [f"{r.name} error {r.error_rate!r} >= chance - 0.02"
               for r in results if not r.error_rate < chance - 0.02]
    base, _, unstruct, qat = results
    if not qat.size_bytes < 0.1 * base.size_bytes:
        failed.append(f"qat4 {qat.size_bytes!r} B >= 0.1 x baseline's "
                      f"{base.size_bytes!r} B")
    if not qat.mmac_skip < qat.mmac_dense:
        failed.append(f"qat4 mmac_skip {qat.mmac_skip!r} >= mmac_dense "
                      f"{qat.mmac_dense!r}")
    if not qat.error_rate < unstruct.error_rate + 0.1:
        failed.append(f"qat4 error {qat.error_rate!r} >= unstructured's "
                      f"{unstruct.error_rate!r} + 0.1")
    sp = qat.sparsity
    failed += [f"qat4 density {d!r} outside (0.02, 0.7)"
               for d in (*sp.l0_density, *sp.l1_density)
               if not 0.02 < d < 0.7]
    if not sp.fc_union_density <= min(1.0, sum(sp.fc_density)):
        failed.append(f"qat4 FC union density {sp.fc_union_density!r} > "
                      f"the summed FC density {sum(sp.fc_density)!r}")
    return failed


def check_paper_claims(seed: int, tmp: Path, dev) -> None:
    """Phase 4e: the paper's end-to-end claims at full width on the card.
    ``run_pipeline`` at ``tests/test_system.py``'s schedule
    (``CLAIM_STEPS`` steps a stage, batch ``CLAIM_BATCH``,
    ``CLAIM_FRAMES`` frames, 1920 classes, the temporal schedule on) and
    the paper's widths (hidden 256, then 128); its four claims asserted
    with the reference's thresholds (``paper_claims``); the results
    payload with the TS sweep written (``write_results``) and the nine
    tables, ``bench_rsnn_forward`` and ``bench_stream_sharded`` (the
    reference's default backend) printed from it
    (``repro_torch.benchmarks.paper_tables``'s ``main``).  Training and
    the tables reach no kernel: every launch counter stays 0."""
    from repro_torch.benchmarks import paper_tables
    from repro_torch.data.synthetic import SpeechDataConfig, TimitLikeStream
    from repro_torch.training.rsnn_pipeline import run_pipeline, write_results

    records: list = []

    def sink(record: dict) -> None:
        records.append((time.perf_counter(), record))

    data_cfg = SpeechDataConfig(frames=CLAIM_FRAMES, num_classes=1920)
    set_counts(0)
    t0 = time.perf_counter()
    results = run_pipeline(steps=CLAIM_STEPS, batch_size=CLAIM_BATCH,
                           hidden_base=BASELINE.hidden_dim,
                           hidden_pruned=PRUNED.hidden_dim,
                           data_cfg=data_cfg, temporal=True, seed=seed,
                           device=dev, metric_sink=sink, log_every=1)
    t1 = time.perf_counter()
    for r in results:
        train = [(t, rec) for t, rec in records
                 if rec["stage"] == r.name and rec["event"] == "train"]
        rates = []
        for ts in sorted({rec["num_ts"] for _, rec in train}, reverse=True):
            times = [t for t, rec in train if rec["num_ts"] == ts]
            rates.append(f"TS {ts}: {len(times)} steps, "
                         f"{(len(times) - 1) / (times[-1] - times[0])!r} "
                         f"steps/s")
        sp = r.sparsity
        print(f"claims: {r.name}: hidden {r.cfg.hidden_dim}, error "
              f"{r.error_rate!r}, loss {r.loss!r}, size_bytes "
              f"{r.size_bytes!r}, mmac_dense {r.mmac_dense!r}, mmac_skip "
              f"{r.mmac_skip!r}, input bits {sp.input_bit_density!r}, L0 "
              f"{sp.l0_density!r}, L1 {sp.l1_density!r}, FC union "
              f"{sp.fc_union_density!r}; {'; '.join(rates)}")
    failed = paper_claims(results)
    if failed:
        raise AssertionError(f"paper claims fail: {failed}")
    print(f"claims: all four hold (every stage's error < chance - 0.02 = "
          f"{1 - 1 / 1920 - 0.02!r}; qat4 {results[-1].size_bytes!r} B < "
          f"0.1 x {results[0].size_bytes!r} B, mmac_skip < mmac_dense; qat4 "
          f"within 0.1 of unstructured; densities in (0.02, 0.7), FC union "
          f"<= summed FC); training {t1 - t0!r} s")
    path = tmp / "claims" / "results.json"
    payload = write_results(results, TimitLikeStream(data_cfg), path)
    sweep = payload[-1]["ts_sweep"]
    tables = {t.__name__: t(path) for t in paper_tables.ANALYTIC}
    if len(tables["fig14_error_ablation"][0]) != 4 or \
            tables["fig16_time_steps"][0] != sweep or \
            tables["fig18_sparsity"][1]["source"] != "measured":
        raise AssertionError("tables: the results file was not read")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = paper_tables.main(["--results", str(path), "--device",
                                  str(dev)])
    lines = out.getvalue().splitlines()
    if code != 0 or len(lines) != 3 + len(paper_tables.ANALYTIC) or \
            not lines[-2].startswith("bench_rsnn_forward,") or \
            not lines[-1].startswith("bench_stream_sharded,"):
        raise AssertionError(f"paper_tables: exit {code}, {len(lines)} lines")
    for line in lines:
        print(f"tables: {line}")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 4e launched kernels: {counts}")
    print(f"phase 4e: {time.perf_counter() - t0!r} s (training {t1 - t0!r} "
          f"s); no kernel launched")


# ------------------------------------------- token-LM serving (phase 6)

LM_TOL = 2e-3  # tests/test_arch_smoke.py: decode against the full forward
LM_CPU_TOL = 1e-4  # tests/test_torch_lm*.py: the port against the reference
BLOCK_TOL = 1e-4  # phase 6b: one block on the card against the CPU
# phase 6a: gemma2-2b at its published widths; LM_BATCH prompts of
# LM_PROMPT tokens and LM_STEPS decode steps; ServeLoop over LM_SLOTS slots
# answering LM_REQUESTS requests, prompt and new tokens drawn from the
# inclusive ranges
LM_GEMMA2 = GEMMA2_2B
GEMMA2_PARAMS = 2_614_341_888  # the reference's jax.eval_shape of its init
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 512, 32
LM_REQUESTS, LM_SLOTS = 8, 4
LM_REQUEST_PROMPT, LM_REQUEST_NEW = (64, 512), (16, 32)
BLOCK_BATCH, BLOCK_TOKENS = 2, 128  # phase 6b
# phase 6c: deepseek-v3-671b at its published widths, cut in depth to one
# dense MLA layer and one MoE layer, float32, the dropless router
LM_DEEPSEEK = dataclasses.replace(
    DEEPSEEK_V3_671B, num_layers=2, dense_layers=1, dtype=torch.float32,
    moe=dataclasses.replace(DEEPSEEK_V3_671B.moe, router_impl="ragged"))
DEEPSEEK_PARAMS = 13_944_134_656  # the reference's jax.eval_shape, cut
MLA_BATCH, MLA_PROMPT, MLA_STEPS = 4, 256, 8
REDUCED_PROMPT, REDUCED_NEW = 16, 8  # phases 6d and 7d, B = 2
DECODER_FAMILIES = ("dense", "moe", "vlm")  # phase 6d's archs
ALL_FAMILIES = (*DECODER_FAMILIES, "audio", "ssm", "hybrid")  # phase 7d


def timed(dev, fn, *args, **kw):
    """``fn``'s result and the ms of that one call: CUDA events on the card
    (the host's clock on the CPU, where phase 6 is rehearsed)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kw)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def lm_tokens(cfg, batch: int, length: int, seed: int, step: int,
              dev) -> torch.Tensor:
    """``MarkovLMStream`` tokens over ``cfg``'s vocabulary, on ``dev``."""
    from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream

    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                         seed=seed))
    return torch.as_tensor(stream.batch(batch, length, step)["tokens"],
                           device=dev)


def full_logits(api, params, toks: torch.Tensor, prompt: int,
                extra: dict | None = None) -> torch.Tensor:
    """The full forward's logits at the positions prefill and teacher-
    forced decode predict from: (B, toks' length - prompt + 1, V).
    ``extra``: the batch's other inputs (whisper's frames)."""
    logits, _ = api.forward(params, dict(extra or {}, tokens=toks))
    want = logits[:, prompt - 1:].clone()
    del logits
    return want


def lm_teacher_forced(api, params, toks: torch.Tensor, prompt: int, dev,
                      want: torch.Tensor | None = None, twin=None,
                      extra: dict | None = None):
    """Prefill ``toks[:, :prompt]`` (once to warm up, once timed),
    ``pad_cache`` to the length of ``toks``, and one decode step a further
    token, each timed.  Returns the prefill's logits and each step's,
    stacked (B, 1 + steps, V), the prefill ms and each step's ms.  With
    ``want`` (``full_logits``), each within ``LM_TOL``; with ``twin``, a
    second ``ModelAPI`` run on the same cache at each step, its logits
    within ``LM_TOL`` of ``api``'s.  ``extra``: the prefill batch's other
    inputs (whisper's frames; decode reads them from the cache)."""
    from repro_torch.serving.cache_utils import pad_cache

    s = toks.shape[1]
    pre = dict(extra or {}, tokens=toks[:, :prompt])
    api.forward(params, pre, mode="prefill")
    (plog, cache), prefill_ms = timed(dev, api.forward, params, pre,
                                      mode="prefill")
    cache = pad_cache(cache, prompt, s)
    logits, step_ms = [plog[:, 0]], []
    for t in range(prompt, s):
        tok = {"tokens": toks[:, t:t + 1]}
        if twin is not None:
            other, _ = twin.forward(params, tok, cache=cache)
        (dlog, cache), ms = timed(dev, api.forward, params, tok, cache=cache)
        if twin is not None:
            torch.testing.assert_close(other, dlog, rtol=LM_TOL, atol=LM_TOL)
        logits.append(dlog[:, 0])
        step_ms.append(ms)
    logits = torch.stack(logits, dim=1)
    if want is not None:
        torch.testing.assert_close(logits, want, rtol=LM_TOL, atol=LM_TOL)
    if not torch.isfinite(logits).all():
        raise AssertionError("teacher-forced logits are not finite")
    return logits, prefill_ms, step_ms


def profile_decode(api, params, toks: torch.Tensor, prompt: int, dev,
                   steps: int = 4) -> str:
    """Where a decode step's time goes: ``steps`` decode steps from the
    padded prefill cache of ``toks[:, :prompt]`` under ``torch.profiler``:
    the card's busy share of their wall time, device operations a step and
    the most costly of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.cache_utils import pad_cache

    if dev.type != "cuda":
        return "decode profile: not measured (no card)"
    _, cache = api.forward(params, {"tokens": toks[:, :prompt]},
                           mode="prefill")
    cache = pad_cache(cache, prompt, prompt + steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(prompt, prompt + steps):
            _, cache = api.forward(params, {"tokens": toks[:, t:t + 1]},
                                   cache=cache)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    ops = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in ops)
    top = "; ".join(f"{k[:40]} x{c} {t / 1e3:.3f} ms"
                    for t, c, k in sorted(ops, reverse=True)[:5])
    return (f"decode profile: {steps} steps in {secs!r} s (profiled), device "
            f"busy {busy_us / 1e6 / secs!r} of it, "
            f"{sum(c for _, c, _ in ops) / steps!r} device operations and "
            f"{busy_us / 1e3 / steps!r} device ms a step, top: {top}")


def describe(cfg) -> str:
    heads = (f"MLA {cfg.num_heads} heads, q/kv ranks {cfg.mla.q_lora_rank}/"
             f"{cfg.mla.kv_lora_rank}" if cfg.mla else
             f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
             f"{cfg.resolved_head_dim}")
    family = ""
    if cfg.encoder_layers:
        family = (f", encoder {cfg.encoder_layers} layers over "
                  f"{cfg.encoder_seq} frames")
    elif cfg.ssm is not None and cfg.ssm.kind == "xlstm":
        family = f", sLSTM layers {cfg.ssm.slstm_layers} (others mLSTM)"
    elif cfg.ssm is not None:
        family = (f", Mamba2 d_state {cfg.ssm.d_state} expand "
                  f"{cfg.ssm.expand} head_dim {cfg.ssm.head_dim}, shared "
                  f"attention every {cfg.attn_every} layers")
    if cfg.ssm is not None:
        family += f", scan {cfg.ssm.scan_impl} (chunk {cfg.ssm.chunk})"
    return (f"{cfg.name}: {cfg.num_layers} layers ({cfg.dense_layers} "
            f"dense), d_model {cfg.d_model}, {heads}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab}){family}, "
            f"{str(cfg.dtype).removeprefix('torch.')}")


def count_params(params, cfg, want: int) -> None:
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"lm: {describe(cfg)}: {n} parameters = "
          f"{n * params['embed']['tok'].element_size()} B")
    if n != want:
        raise AssertionError(f"{cfg.name}: {n} parameters, the reference "
                             f"has {want}")


def check_block(params, cfg, seed: int, dev) -> None:
    """Phase 6b: ``layer_fwd`` of the first two stacked layers (gemma2: a
    local one, then a global one) at full width in float32, on the card
    and on the CPU from the same weights and inputs, within ``BLOCK_TOL``."""
    from repro_torch.models.transformer import layer_fwd, layer_windows

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((BLOCK_BATCH, BLOCK_TOKENS, cfg.d_model), generator=gen)
    pos = torch.arange(BLOCK_TOKENS, dtype=torch.int32)[None].expand(
        BLOCK_BATCH, -1)
    for i, window in enumerate(layer_windows(cfg).tolist()[:2]):
        lp = tree_map(lambda t: t[i], params["layers"])  # noqa: B023
        got, _ = layer_fwd(x.to(dev), lp, cfg, pos.to(dev), window, None,
                           None)
        want, _ = layer_fwd(x, tree_map(lambda t: t.cpu(), lp), cfg, pos,
                            window, None, None)
        err = (got.cpu() - want).abs().max().item()
        torch.testing.assert_close(got.cpu(), want, rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL)
        print(f"lm block: {cfg.name} layer {cfg.dense_layers + i} (window "
              f"{window}), {BLOCK_BATCH} x {BLOCK_TOKENS} tokens, float32: "
              f"{dev} against cpu max |d| {err!r} (tolerance {BLOCK_TOL})")


def serve_requests(api, params, seed: int, slots: int, requests: int,
                   prompt_span: tuple, new_span: tuple) -> tuple[float, int]:
    """``ServeLoop(batch_slots=slots)`` answering ``requests`` seeded
    requests, prompt and new tokens drawn from the inclusive ranges
    ``prompt_span`` and ``new_span``: (seconds, tokens generated)."""
    from repro_torch.serving.engine import ServeLoop

    rng = np.random.default_rng(seed)
    loop = ServeLoop(api, params, batch_slots=slots)
    want = {}
    for i in range(requests):
        n = int(rng.integers(prompt_span[0], prompt_span[1] + 1))
        new = int(rng.integers(new_span[0], new_span[1] + 1))
        prompt = lm_tokens(api.cfg, 1, n, seed, 100 + i, "cpu")[0].numpy()
        want[loop.submit(prompt, new)] = new
    t0 = time.perf_counter()
    done = loop.run()
    seconds = time.perf_counter() - t0
    if sorted(r.rid for r in done) != sorted(want) or \
            any(not r.done or len(r.out) != want[r.rid] for r in done):
        raise AssertionError("ServeLoop: a request is missing or cut short")
    return seconds, sum(len(r.out) for r in done)


def gen_twice(api, params, prompts: torch.Tensor, n: int,
              extra: dict | None = None) -> tuple[float, float]:
    """``generate`` of ``n`` greedy tokens twice, ids equal: each run's
    seconds."""
    from repro_torch.serving.engine import generate

    runs, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(generate(api, params, prompts, n, extra_inputs=extra))
        secs.append(time.perf_counter() - t0)
    if not np.array_equal(*runs):
        raise AssertionError(f"{api.cfg.name} generate: greedy ids differ "
                             f"between two runs")
    return secs[0], secs[1]


def check_gemma2(seed: int, dev, smi: str) -> None:
    """Phases 6a and 6b: gemma2-2b at its published widths."""
    from repro_torch.models import registry

    cfg = dataclasses.replace(LM_GEMMA2, dtype=torch.float32)
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, GEMMA2_PARAMS)
    toks = lm_tokens(cfg, LM_BATCH, LM_PROMPT + LM_STEPS, seed, 0, dev)
    want = full_logits(api, params, toks, LM_PROMPT)
    _, prefill_ms, step_ms = lm_teacher_forced(api, params, toks, LM_PROMPT,
                                            dev, want)
    print(f"lm: {cfg.name} float32, {LM_BATCH} x {LM_PROMPT} prompt tokens, "
          f"pad_cache to {LM_PROMPT + LM_STEPS}, {LM_STEPS} teacher-forced "
          f"decode steps within {LM_TOL} of the full forward; prefill "
          f"{prefill_ms!r} ms, decode {statistics.median(step_ms)!r} ms a "
          f"token (median), on {smi}")
    check_block(params, cfg, seed, dev)

    params = tree_map(lambda t: t.to(LM_GEMMA2.dtype)
                    if t.is_floating_point() else t, params)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    api = registry.get_model(LM_GEMMA2.name, LM_GEMMA2)
    logits, prefill_ms, step_ms = lm_teacher_forced(api, params, toks,
                                                 LM_PROMPT, dev)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
    del want, logits
    print(f"lm: {LM_GEMMA2.name} bf16 (the float32 weights rounded), the "
          f"same {LM_STEPS} teacher-forced steps: logits finite, greedy "
          f"agreement with float32 {agree!r} over {LM_BATCH} x "
          f"{LM_STEPS + 1} positions; prefill {prefill_ms!r} ms, decode "
          f"{statistics.median(step_ms)!r} ms a token (median), on {smi}")
    print(f"lm: {LM_GEMMA2.name} bf16 "
          f"{profile_decode(api, params, toks, LM_PROMPT, dev)}, on {smi}")
    first, second = gen_twice(api, params, toks[:, :LM_PROMPT], LM_STEPS)
    print(f"lm: generate {LM_BATCH} x {LM_STEPS} tokens (bf16, greedy) "
          f"twice, ids equal; {first!r} s and {second!r} s "
          f"({LM_BATCH * LM_STEPS / second!r} tokens/s), on {smi}")
    seconds, tokens = serve_requests(api, params, seed, LM_SLOTS,
                                     LM_REQUESTS, LM_REQUEST_PROMPT,
                                     LM_REQUEST_NEW)
    print(f"lm: ServeLoop(batch_slots={LM_SLOTS}) {LM_REQUESTS} requests "
          f"(prompts {LM_REQUEST_PROMPT[0]}-{LM_REQUEST_PROMPT[1]} tokens, "
          f"max_new {LM_REQUEST_NEW[0]}-{LM_REQUEST_NEW[1]}), {tokens} "
          f"tokens in {seconds!r} s = {tokens / seconds!r} tokens/s, on "
          f"{smi}")


def check_deepseek(seed: int, dev, smi: str) -> None:
    """Phase 6c: deepseek-v3-671b at its published widths over two
    layers, float32."""
    from repro_torch.models import registry

    cfg = LM_DEEPSEEK
    print(f"lm: {cfg.name} cut in depth to num_layers={cfg.num_layers}, "
          f"dense_layers={cfg.dense_layers} (published "
          f"{DEEPSEEK_V3_671B.num_layers} and "
          f"{DEEPSEEK_V3_671B.dense_layers}); {cfg.moe.num_experts} experts, "
          f"top {cfg.moe.top_k}, {cfg.moe.num_shared_experts} shared")
    api = registry.get_model(cfg.name, cfg)
    dense = registry.get_model(cfg.name, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, router_impl="dense_dispatch")))
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, DEEPSEEK_PARAMS)
    toks = lm_tokens(cfg, MLA_BATCH, MLA_PROMPT + MLA_STEPS, seed, 1, dev)
    want = full_logits(api, params, toks, MLA_PROMPT)
    g = min(cfg.moe.group_size, MLA_BATCH)
    capacity = max(int(g * cfg.moe.top_k / cfg.moe.num_experts
                       * cfg.moe.capacity_factor), 4)
    if capacity < g:
        raise AssertionError(f"dense_dispatch at decode could drop: "
                             f"capacity {capacity} < {g} tokens")
    _, prefill_ms, step_ms = lm_teacher_forced(api, params, toks, MLA_PROMPT,
                                            dev, want, twin=dense)
    print(f"lm: {cfg.name} float32 ragged, {MLA_BATCH} x {MLA_PROMPT} prompt "
          f"tokens, pad_cache to {MLA_PROMPT + MLA_STEPS}, {MLA_STEPS} "
          f"teacher-forced decode steps within {LM_TOL} of the full forward; "
          f"dense_dispatch at each step (capacity {capacity} >= {g} tokens: "
          f"nothing dropped) within {LM_TOL} of ragged; prefill "
          f"{prefill_ms!r} ms, decode {statistics.median(step_ms)!r} ms a "
          f"token (median), on {smi}")


def check_reduced(seed: int, dev, families: tuple) -> None:
    """Phases 6d and 7d: each arch of ``families`` at ``reduce_config``,
    float32, the same seeded parameters (and whisper's seeded frames) on
    the CPU and on ``dev``: prefill logits within ``LM_CPU_TOL``, greedy
    ``generate`` ids equal."""
    from repro_torch.configs.archs import ALL_ARCHS
    from repro_torch.models import registry
    from repro_torch.serving.engine import generate

    for arch in registry.list_archs():
        if ALL_ARCHS[arch].family not in families:
            continue
        cfg = registry.reduce_config(ALL_ARCHS[arch])
        api = registry.get_model(arch, cfg)
        cpu = api.init(torch.Generator().manual_seed(seed), device="cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        toks = lm_tokens(cfg, 2, REDUCED_PROMPT, seed, 2, "cpu")
        extra = {}
        if cfg.frontend == "patch":
            extra["patch_embeds"] = torch.randn(
                (2, cfg.num_patch_tokens, cfg.d_model),
                generator=torch.Generator().manual_seed(seed))
        if cfg.encoder_layers:
            extra["frames"] = torch.randn(
                (2, cfg.encoder_seq, cfg.d_model),
                generator=torch.Generator().manual_seed(seed))
        want, _ = api.forward(cpu, dict(extra, tokens=toks), mode="prefill")
        got, _ = api.forward(card, {k: v.to(dev) for k, v in dict(
            extra, tokens=toks).items()}, mode="prefill")
        err = (got.cpu() - want).abs().max().item()
        torch.testing.assert_close(got.cpu(), want, rtol=LM_CPU_TOL,
                                   atol=LM_CPU_TOL)
        ids = [generate(api, p, toks, REDUCED_NEW, extra_inputs=extra)
               for p in (cpu, card)]
        if not np.array_equal(*ids):
            raise AssertionError(f"{arch}: greedy ids differ, {dev} against "
                                 f"cpu")
        print(f"lm reduced: {arch}: prefill logits {dev} against cpu max "
              f"|d| {err!r} (tolerance {LM_CPU_TOL}), {REDUCED_NEW} greedy "
              f"ids equal")


def check_lm_serving(seed: int, dev, smi: str) -> None:
    """Phase 6: the token-LM serving path on the card (``get_model`` ->
    ``init`` -> ``generate`` / ``ServeLoop``), plain PyTorch: no kernel of
    the port lies on it, and every launch counter stays 0.  (a) gemma2-2b
    at its published widths: float32 prefill, ``pad_cache`` and
    teacher-forced decode against the full forward; bf16 teacher-forced
    (greedy agreement with float32 printed), ``generate`` twice with equal
    ids, ``ServeLoop``.  (b) One gemma2 block, card against CPU.  (c)
    deepseek-v3-671b over two layers, float32, ragged teacher-forced decode
    against the full forward and dense_dispatch against ragged.  (d) Each
    decoder-LM arch at ``reduce_config``, card against CPU.  Prefill and
    decode ms, tokens/s and peak memory printed beside the card."""
    t0 = time.perf_counter()
    print(f"phase 6 on {smi}")
    set_counts(0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()  # the allocator's statistics need the context
    with torch.no_grad():
        for name, check in (("gemma2-2b", check_gemma2),
                            ("deepseek-v3-671b", check_deepseek)):
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            check(seed, dev, smi)
            peak = torch.cuda.max_memory_allocated(dev) if cuda else None
            print(f"lm: {name}: {time.perf_counter() - t1!r} s, peak memory "
                  f"{peak!r} B (max_memory_allocated), on {smi}")
        if cuda:
            torch.cuda.empty_cache()
        check_reduced(seed, dev, DECODER_FAMILIES)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 6 launched kernels: {counts}")
    print(f"phase 6: {time.perf_counter() - t0!r} s; no kernel launched")


# ------------------------- the remaining token-LM families (phase 7)

# phase 7a: whisper-base at its published widths; WHISPER_BATCH streams of
# encoder_seq seeded N(0, 1) frames and WHISPER_PROMPT prompt tokens,
# WHISPER_STEPS teacher-forced decode steps, WHISPER_NEW generated tokens
LM_WHISPER = WHISPER_BASE
WHISPER_PARAMS = 87_488_512  # the reference's jax.eval_shape, max_dec_len
WHISPER_MAX_DEC_LEN = 32768  # the registry's default, as the reference's
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS, WHISPER_NEW = 4, 64, 16, 32
# phase 7b: xlstm-350m; XLSTM_PROMPT a multiple of its chunk, so that
# prefill takes the chunked form
LM_XLSTM = XLSTM_350M
XLSTM_PARAMS = 528_555_176
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_STEPS, XLSTM_NEW = 4, 512, 16, 32
XLSTM_SLOTS, XLSTM_REQUESTS = 4, 8
XLSTM_REQUEST_PROMPT, XLSTM_REQUEST_NEW = (64, 512), (16, 32)
# the spiking sLSTM's threshold for phase 7b: at its init of 1 no unit can
# fire (|c / n| < 1, since n >= 1 and |tanh| < 1), so vth is drawn from
# N(0, SPIKE_VTH_STD^2), where units fire
SPIKE_VTH_STD = 0.3
# phase 7c: zamba2-7b at its published widths
LM_ZAMBA2 = ZAMBA2_7B
ZAMBA2_PARAMS = 6_750_550_224
ZAMBA2_BATCH, ZAMBA2_PROMPT, ZAMBA2_STEPS, ZAMBA2_NEW = 2, 256, 8, 16
ZAMBA2_SLOTS, ZAMBA2_REQUESTS = 2, 4
ZAMBA2_REQUEST_PROMPT, ZAMBA2_REQUEST_NEW = (32, 128), (8, 16)


def with_scan(cfg, scan_impl: str):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, scan_impl=scan_impl))


def cast_like_(tree, like):
    """Each floating leaf of ``tree`` (dicts and lists, replaced in place)
    cast to the dtype of ``like``'s leaf (the tree ``init`` gives on the
    meta device at the target dtype: the reference's float32 leaves stay
    float32), one leaf at a time, so that each old copy is freed as its
    cast is made."""
    keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
    for k in keys:
        if isinstance(tree[k], (dict, list)):
            cast_like_(tree[k], like[k])
        elif tree[k].is_floating_point():
            tree[k] = tree[k].to(like[k].dtype)
    return tree


def close_states(got, want, what: str) -> float:
    """Every leaf of two recurrent state trees within ``LM_TOL``; the
    largest |d| over them."""
    err = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=LM_TOL, atol=LM_TOL,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, (g.float() - w.float()).abs().max().item())
    return err


def chunked_against_sequential(api, params, toks: torch.Tensor, dev,
                               what: str) -> tuple[float, float, float]:
    """Prefill ``toks`` in the chunked form (warmed up, then timed) and in
    the sequential one: logits and final states within ``LM_TOL``.
    Returns (chunked ms, sequential ms, the largest |d|)."""
    from repro_torch.models import registry

    seq_api = registry.get_model(api.cfg.name, with_scan(api.cfg,
                                                         "sequential"))
    batch = {"tokens": toks}
    api.forward(params, batch, mode="prefill")
    (lc, sc), chunked_ms = timed(dev, api.forward, params, batch,
                                 mode="prefill")
    (ls, ss), seq_ms = timed(dev, seq_api.forward, params, batch,
                             mode="prefill")
    torch.testing.assert_close(lc, ls, rtol=LM_TOL, atol=LM_TOL)
    err = max((lc - ls).abs().max().item(),
              close_states(sc, ss, f"{what} prefill states"))
    return chunked_ms, seq_ms, err


def check_whisper(seed: int, dev, smi: str) -> None:
    """Phase 7a: whisper-base at its published widths."""
    from repro_torch.models import encdec, registry

    cfg = dataclasses.replace(LM_WHISPER, dtype=torch.float32)
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev, max_dec_len=WHISPER_MAX_DEC_LEN)
    count_params(params, cfg, WHISPER_PARAMS)
    frames = torch.randn((WHISPER_BATCH, cfg.encoder_seq, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 1), device=dev)
    extra = {"frames": frames}
    toks = lm_tokens(cfg, WHISPER_BATCH, WHISPER_PROMPT + WHISPER_STEPS,
                     seed, 3, dev)
    want = full_logits(api, params, toks, WHISPER_PROMPT, extra)
    _, prefill_ms, step_ms = lm_teacher_forced(
        api, params, toks, WHISPER_PROMPT, dev, want, extra=extra)
    del want
    enc_ms = timed(dev, encdec.encode, params, frames, cfg)[1]
    print(f"lm: {cfg.name} float32, {WHISPER_BATCH} streams of "
          f"{cfg.encoder_seq} frames and {WHISPER_PROMPT} prompt tokens, "
          f"pad_cache to {WHISPER_PROMPT + WHISPER_STEPS}, {WHISPER_STEPS} "
          f"teacher-forced decode steps within {LM_TOL} of the full "
          f"forward; encoder {enc_ms!r} ms, prefill (encoder included) "
          f"{prefill_ms!r} ms, decode {statistics.median(step_ms)!r} ms a "
          f"token (median), on {smi}")

    api = registry.get_model(LM_WHISPER.name, LM_WHISPER)
    cast_like_(params, api.init(torch.Generator(), device="meta",
                                max_dec_len=WHISPER_MAX_DEC_LEN))
    encdec.encode(params, frames, LM_WHISPER)
    enc_ms = timed(dev, encdec.encode, params, frames, LM_WHISPER)[1]
    first, second = gen_twice(api, params, toks[:, :WHISPER_PROMPT],
                              WHISPER_NEW, extra)
    print(f"lm: {LM_WHISPER.name} bf16 (the float32 weights rounded): "
          f"encoder {enc_ms!r} ms; generate {WHISPER_BATCH} x "
          f"{WHISPER_NEW} tokens (greedy, frames through extra_inputs) "
          f"twice, ids equal; {first!r} s and {second!r} s "
          f"({WHISPER_BATCH * WHISPER_NEW / second!r} tokens/s); ServeLoop "
          f"passes no frames, as the reference's, so it does not serve "
          f"whisper; on {smi}")


def spiking_forms(params, cfg, toks: torch.Tensor, seed: int, dev,
                  smi: str) -> None:
    """Phase 7b's spiking sLSTM at full width: the sLSTM thresholds drawn
    (``SPIKE_VTH_STD``), a prefill of ``toks`` in the chunked and the
    sequential form, each ``spike_fn`` call recorded: logits finite, each
    sLSTM layer's spike rate and the spikes that differ between the forms
    printed (the mLSTMs' forms differ by rounding, so a unit near its
    threshold may flip: counted, not asserted)."""
    from repro_torch.models import registry, ssm
    from repro_torch.models.layers import xlstm

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    layers = [dict(lp, block=dict(lp["block"], vth=torch.randn(
        lp["block"]["vth"].shape, generator=gen, device=dev)
        * SPIKE_VTH_STD)) if ssm.is_slstm(cfg, i) else lp
        for i, lp in enumerate(params["layers"])]
    spiking = dict(params, layers=layers)
    spikes = {}
    real = xlstm.spike_fn
    for impl in ("chunked", "sequential"):
        record = []

        def recorded(u, vth, slope=25.0, _record=record):
            s = real(u, vth, slope)
            _record.append(s.bool())
            return s

        api = registry.get_model(cfg.name, dataclasses.replace(
            with_scan(cfg, impl), spiking=True))
        xlstm.spike_fn = recorded
        try:
            logits, _ = api.forward(spiking, {"tokens": toks}, mode="prefill")
        finally:
            xlstm.spike_fn = real
        if not torch.isfinite(logits).all():
            raise AssertionError(f"spiking {impl}: logits are not finite")
        n = toks.shape[1]
        # one call a step, n a layer, the sLSTM layers in order
        spikes[impl] = [torch.stack(record[j * n:(j + 1) * n])
                        for j in range(len(record) // n)]
    rates = {impl: [s.float().mean().item() for s in per]
             for impl, per in spikes.items()}
    differ = [int((a != b).sum()) for a, b in zip(spikes["chunked"],
                                                  spikes["sequential"])]
    print(f"lm: {cfg.name} spiking=True (sLSTM layers "
          f"{cfg.ssm.slstm_layers}, vth ~ N(0, {SPIKE_VTH_STD}^2)), float32, "
          f"{toks.shape[0]} x {toks.shape[1]} tokens prefilled in both "
          f"forms, logits finite; spike rate a layer chunked "
          f"{rates['chunked']!r}, sequential {rates['sequential']!r}; "
          f"spikes that differ between the forms {differ!r} of "
          f"{spikes['chunked'][0].numel()!r} a layer, on {smi}")


def check_xlstm(seed: int, dev, smi: str) -> None:
    """Phase 7b: xlstm-350m at its published widths."""
    from repro_torch.models import registry

    cfg = dataclasses.replace(LM_XLSTM, dtype=torch.float32)
    if XLSTM_PROMPT % cfg.ssm.chunk or cfg.ssm.scan_impl != "chunked":
        raise AssertionError("phase 7b's prompt must take the chunked form")
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, XLSTM_PARAMS)
    toks = lm_tokens(cfg, XLSTM_BATCH, XLSTM_PROMPT + XLSTM_STEPS, seed, 4,
                     dev)
    chunked_ms, seq_ms, err = chunked_against_sequential(
        api, params, toks[:, :XLSTM_PROMPT], dev, cfg.name)
    want = full_logits(api, params, toks, XLSTM_PROMPT)
    _, prefill_ms, step_ms = lm_teacher_forced(api, params, toks,
                                               XLSTM_PROMPT, dev, want)
    del want
    print(f"lm: {cfg.name} float32, {XLSTM_BATCH} x {XLSTM_PROMPT} prompt "
          f"tokens: chunked prefill ({chunked_ms!r} ms) against sequential "
          f"({seq_ms!r} ms), logits and states max |d| {err!r} (tolerance "
          f"{LM_TOL}); {XLSTM_STEPS} teacher-forced decode steps within "
          f"{LM_TOL} of the full forward; prefill {prefill_ms!r} ms, decode "
          f"{statistics.median(step_ms)!r} ms a token (median), on {smi}")
    spiking_forms(params, cfg, toks[:, :XLSTM_PROMPT], seed, dev, smi)

    api = registry.get_model(LM_XLSTM.name, LM_XLSTM)
    cast_like_(params, api.init(torch.Generator(), device="meta"))
    _, prefill_ms, step_ms = lm_teacher_forced(api, params, toks,
                                               XLSTM_PROMPT, dev)
    print(f"lm: {LM_XLSTM.name} bf16 (the float32 weights rounded), the "
          f"same {XLSTM_STEPS} teacher-forced steps: logits finite; prefill "
          f"{prefill_ms!r} ms, decode {statistics.median(step_ms)!r} ms a "
          f"token (median), on {smi}")
    print(f"lm: {LM_XLSTM.name} bf16 "
          f"{profile_decode(api, params, toks, XLSTM_PROMPT, dev)}, on {smi}")
    first, second = gen_twice(api, params, toks[:, :XLSTM_PROMPT],
                              XLSTM_NEW)
    seconds, tokens = serve_requests(api, params, seed, XLSTM_SLOTS,
                                     XLSTM_REQUESTS, XLSTM_REQUEST_PROMPT,
                                     XLSTM_REQUEST_NEW)
    print(f"lm: {LM_XLSTM.name} bf16 generate {XLSTM_BATCH} x {XLSTM_NEW} "
          f"tokens (greedy) twice, ids equal; {first!r} s and {second!r} s "
          f"({XLSTM_BATCH * XLSTM_NEW / second!r} tokens/s); "
          f"ServeLoop(batch_slots={XLSTM_SLOTS}) {XLSTM_REQUESTS} requests "
          f"(prompts {XLSTM_REQUEST_PROMPT[0]}-{XLSTM_REQUEST_PROMPT[1]} "
          f"tokens, max_new {XLSTM_REQUEST_NEW[0]}-{XLSTM_REQUEST_NEW[1]}), "
          f"{tokens} tokens in {seconds!r} s = {tokens / seconds!r} "
          f"tokens/s, on {smi}")


def check_zamba2(seed: int, dev, smi: str) -> None:
    """Phase 7c: zamba2-7b at its published widths, float32 then bf16."""
    from repro_torch.models import registry

    cfg = dataclasses.replace(LM_ZAMBA2, dtype=torch.float32)
    if ZAMBA2_PROMPT % cfg.ssm.chunk or cfg.ssm.scan_impl != "chunked":
        raise AssertionError("phase 7c's prompt must take the chunked form")
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, ZAMBA2_PARAMS)
    toks = lm_tokens(cfg, ZAMBA2_BATCH, ZAMBA2_PROMPT + ZAMBA2_STEPS, seed,
                     5, dev)
    chunked_ms, seq_ms, err = chunked_against_sequential(
        api, params, toks[:, :ZAMBA2_PROMPT], dev, cfg.name)
    want = full_logits(api, params, toks, ZAMBA2_PROMPT)
    _, prefill_ms, step_ms = lm_teacher_forced(api, params, toks,
                                               ZAMBA2_PROMPT, dev, want)
    del want
    print(f"lm: {cfg.name} float32, {ZAMBA2_BATCH} x {ZAMBA2_PROMPT} prompt "
          f"tokens: chunked prefill ({chunked_ms!r} ms) against sequential "
          f"({seq_ms!r} ms), logits and states max |d| {err!r} (tolerance "
          f"{LM_TOL}); pad_cache to {ZAMBA2_PROMPT + ZAMBA2_STEPS}, "
          f"{ZAMBA2_STEPS} teacher-forced decode steps within {LM_TOL} of "
          f"the full forward; prefill {prefill_ms!r} ms, decode "
          f"{statistics.median(step_ms)!r} ms a token (median), on {smi}")

    api = registry.get_model(LM_ZAMBA2.name, LM_ZAMBA2)
    cast_like_(params, api.init(torch.Generator(), device="meta"))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _, prefill_ms, step_ms = lm_teacher_forced(api, params, toks,
                                               ZAMBA2_PROMPT, dev)
    print(f"lm: {LM_ZAMBA2.name} bf16 (the float32 weights rounded, each "
          f"float32 leaf freed as it is cast), the same {ZAMBA2_STEPS} "
          f"teacher-forced steps: logits finite; prefill {prefill_ms!r} ms, "
          f"decode {statistics.median(step_ms)!r} ms a token (median), on "
          f"{smi}")
    print(f"lm: {LM_ZAMBA2.name} bf16 "
          f"{profile_decode(api, params, toks, ZAMBA2_PROMPT, dev)}, on "
          f"{smi}")
    first, second = gen_twice(api, params, toks[:, :ZAMBA2_PROMPT],
                              ZAMBA2_NEW)
    seconds, tokens = serve_requests(api, params, seed, ZAMBA2_SLOTS,
                                     ZAMBA2_REQUESTS, ZAMBA2_REQUEST_PROMPT,
                                     ZAMBA2_REQUEST_NEW)
    print(f"lm: {LM_ZAMBA2.name} bf16 generate {ZAMBA2_BATCH} x "
          f"{ZAMBA2_NEW} tokens (greedy) twice, ids equal; {first!r} s and "
          f"{second!r} s ({ZAMBA2_BATCH * ZAMBA2_NEW / second!r} tokens/s); "
          f"ServeLoop(batch_slots={ZAMBA2_SLOTS}) {ZAMBA2_REQUESTS} requests "
          f"(prompts {ZAMBA2_REQUEST_PROMPT[0]}-{ZAMBA2_REQUEST_PROMPT[1]} "
          f"tokens, max_new {ZAMBA2_REQUEST_NEW[0]}-"
          f"{ZAMBA2_REQUEST_NEW[1]}), {tokens} tokens in {seconds!r} s = "
          f"{tokens / seconds!r} tokens/s, on {smi}")


def check_lm_families(seed: int, dev, smi: str) -> None:
    """Phase 7: the encoder-decoder, xLSTM and Mamba2-hybrid families on
    the card, plain PyTorch: no kernel of the port lies on them, and every
    launch counter stays 0.  (a) whisper-base, (b) xlstm-350m with the
    spiking sLSTM, (c) zamba2-7b, each at its published widths; (d) all
    ten archs at ``reduce_config``, card against CPU.  Prefill and decode
    ms, tokens/s and each model's peak memory printed beside the card."""
    t0 = time.perf_counter()
    print(f"phase 7 on {smi}")
    set_counts(0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()  # the allocator's statistics need the context
    with torch.no_grad():
        for name, check in (("whisper-base", check_whisper),
                            ("xlstm-350m", check_xlstm),
                            ("zamba2-7b", check_zamba2)):
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            check(seed, dev, smi)
            peak = torch.cuda.max_memory_allocated(dev) if cuda else None
            print(f"lm: {name}: {time.perf_counter() - t1!r} s, peak memory "
                  f"{peak!r} B (max_memory_allocated), on {smi}")
        if cuda:
            torch.cuda.empty_cache()
        check_reduced(seed, dev, ALL_FAMILIES)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 7 launched kernels: {counts}")
    print(f"phase 7: {time.perf_counter() - t0!r} s; no kernel launched")


# ------------------------------------------ token-LM training (phase 8)

# phase 8a: gemma2-2b at its published widths and dtype (bf16, remat
# "full", AdamW: its config's), GEMMA2_TRAIN_STEPS steps of
# GEMMA2_TRAIN_BATCH x GEMMA2_TRAIN_SEQ MarkovLMStream tokens, the first a
# warm-up (named apart from phase 4d's TRAIN_BATCH, the RSNN's batch)
TRAIN_GEMMA2 = GEMMA2_2B
GEMMA2_TRAIN_BATCH, GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_STEPS = 4, 512, 6
TRAIN_LR = 3e-3  # launch/train.py's default
# phase 8b: the block and the whole model, float32, card against CPU and
# remat "full" against "none" on the card: a gradient leaf within
# LM_GRAD_TOL of its largest |element| (the CPU tests hold the port to the
# reference at this bound; the largest seen there is 3.9e-6 of it)
LM_GRAD_TOL = 1e-4
REMAT_BATCH, REMAT_SEQ = 2, 128
# phase 8c: xlstm-350m with the spiking sLSTM, vth ~ N(0, SPIKE_VTH_STD^2)
TRAIN_XLSTM = dataclasses.replace(XLSTM_350M, spiking=True)
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 4, 512, 4
# phase 8d: zamba2-7b at its published widths cut in depth to two
# shared-attention groups (12 Mamba2 layers); 2 x 256 tokens = two chunks
TRAIN_ZAMBA2 = dataclasses.replace(ZAMBA2_7B, num_layers=12)
ZAMBA2_CUT_PARAMS = 1_370_558_400  # the reference's jax.eval_shape, cut
ZAMBA2_TRAIN_BATCH, ZAMBA2_TRAIN_SEQ, ZAMBA2_TRAIN_STEPS = 2, 256, 3
F32_LOG_MAX = math.log(torch.finfo(torch.float32).max)  # exp overflows past
# the bf16 gradients against a float32 run of the same cut, parameters and
# batch: each finite leaf (a stacked leaf layer by layer) within this
# relative L2 error.  bf16 keeps 8 significand bits, a rounding error of
# up to 2^-9 = 1.95e-3 a value.  A gradient element ends a chain of about
# 10^3 dependent roundings (some 30 rounded operations a layer, 12 layers,
# in the forward, the recomputed forward and the backward), whose errors
# add like a random walk: sqrt(10^3) 2^-9 = 6.2e-2.  1e-1 leaves a margin
# of 1.6 over that; a wrong gradient is off by its own size
BF16_GRAD_RTOL = 1e-1
# phase 8e: whisper-base at its published widths through the Trainer,
# preempted at call WHISPER_PREEMPT and resumed; checkpoints every
# WHISPER_CKPT_EVERY steps
TRAIN_WHISPER = WHISPER_BASE
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 2, 64, 6
WHISPER_CKPT_EVERY, WHISPER_PREEMPT = 3, 4
RESUME_RTOL = 1e-4  # tests/test_training.py: resumed against uninterrupted
# phase 8f: the ten reduced archs, one step card against CPU; an updated
# parameter within UPDATE_TOL x lr of the CPU's, or 2 lr + UPDATE_TOL lr
# where the CPU's clipped |gradient| is below G_FLOOR (= 1e3 eps: there
# the first Adam step's lr g / (|g| + eps) moves by up to its whole size
# under the gradient's rounding)
UPDATE_TOL, G_FLOOR, STEP_LR = 0.05, 1e-5, 1e-3
# phase 8g: examples/serve_lm_torch.py's flow
EXAMPLE_FIT_STEPS, EXAMPLE_REQUESTS = 40, 6


def lm_batch(cfg, batch: int, seq: int, seed: int, step: int) -> dict:
    """A numpy training batch: ``MarkovLMStream`` tokens, and for whisper
    seeded N(0, 1) frames, for a VLM seeded patch embeddings."""
    out = {"tokens": lm_tokens(cfg, batch, seq, seed, step, "cpu").numpy()}
    rng = np.random.default_rng((seed, step))
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    if cfg.frontend == "patch":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.num_patch_tokens, cfg.d_model), dtype=np.float32)
    return out


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path (``/layers/3/block/vth``), in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}/{i}")]
    return [] if tree is None else [prefix]


def on(dev, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def close_leaves(got: list, want: list, tol: float, what: str) -> float:
    """Each pair of leaves within ``tol`` of ``want``'s largest |element|;
    the largest such ratio."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{what}: leaf {i} is not finite")
        scale = max(w.abs().max().item(), 1e-30)
        ratio = (g - w).abs().max().item() / scale
        if ratio > tol:
            raise AssertionError(f"{what}: leaf {i} {tuple(w.shape)} off "
                                 f"by {ratio!r} of its largest (> {tol})")
        worst = max(worst, ratio)
    return worst


def train_steps(step, state, batches, dev):
    """``step`` over ``batches`` (an iterator of (index, batch)), each
    timed (``timed``): (state, losses, grad norms, ms a step)."""
    losses, norms, ms = [], [], []
    for _, batch in batches:
        (state, m), t = timed(dev, step, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(t)
    return state, losses, norms, ms


def profile_step(step, state, batch, dev) -> tuple[object, str]:
    """One step under ``torch.profiler``: the card's busy share of its wall
    time, its device operations and the most costly of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return step(state, batch)[0], "step profile: not measured (no card)"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        secs = time.perf_counter() - t0
    ops = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in ops)
    top = "; ".join(f"{k[:40]} x{c} {t / 1e3:.2f} ms"
                    for t, c, k in sorted(ops, reverse=True)[:5])
    return state, (f"step profile: {secs!r} s (profiled), device busy "
                   f"{busy_us / 1e6 / secs!r} of it, "
                   f"{sum(c for _, c, _ in ops)} device operations, "
                   f"{busy_us / 1e3!r} device ms, top: {top}")


def check_train_block(params, cfg, seed: int, dev) -> None:
    """Phase 8b: forward and backward of ``layer_fwd`` for the first two
    stacked layers (a local one, a global one) at full width, float32,
    2 x 128 tokens, on the card and on the CPU from the same weights, input
    and cotangent: d<out, cot>/d(x, weights) within ``LM_GRAD_TOL``."""
    from repro_torch.models.transformer import layer_fwd, layer_windows

    gen = torch.Generator().manual_seed(seed + 3)
    x = torch.randn((REMAT_BATCH, REMAT_SEQ, cfg.d_model), generator=gen)
    cot = torch.randn((REMAT_BATCH, REMAT_SEQ, cfg.d_model), generator=gen)
    pos = torch.arange(REMAT_SEQ, dtype=torch.int32)[None].expand(
        REMAT_BATCH, -1)

    def grads(lp, device):
        leaves = [t.detach().to(device).requires_grad_()
                  for t in tree_leaves(lp)]
        xs = x.detach().to(device).requires_grad_()
        with torch.enable_grad():
            out, _ = layer_fwd(xs, tree_unflatten(lp, iter(leaves)), cfg,
                               pos.to(device), window, None, None)
            return torch.autograd.grad((out * cot.to(device)).sum(),
                                       [xs, *leaves])

    for i, window in enumerate(layer_windows(cfg).tolist()[:2]):
        lp = tree_map(lambda t: t[i], params["layers"])  # noqa: B023
        worst = close_leaves(grads(lp, dev), grads(lp, "cpu"), LM_GRAD_TOL,
                             f"block {i} gradients")
        print(f"lm train block: {cfg.name} layer {i} (window {window}), "
              f"{REMAT_BATCH} x {REMAT_SEQ} tokens, float32: {dev} against "
              f"cpu, d<out, cot>/d(x, {len(tree_leaves(lp))} weights) "
              f"within {worst!r} of each leaf's largest (tolerance "
              f"{LM_GRAD_TOL})")


def check_remat(seed: int, dev, smi: str) -> None:
    """Phase 8b: gemma2-2b at full width in float32: the block against the
    CPU (``check_train_block``), then the whole model's loss and gradients
    with ``remat="full"`` against ``"none"`` on the card, each form run
    twice in turns (the first calls include the card's first-call set-up)
    and the second runs compared."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import registry

    cfg = dataclasses.replace(TRAIN_GEMMA2, dtype=torch.float32)
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, GEMMA2_PARAMS)
    check_train_block(params, cfg, seed, dev)
    batch = on(dev, lm_batch(cfg, REMAT_BATCH, REMAT_SEQ, seed, 0))
    got, ms = {}, {"none": [], "full": []}
    for remat in ("none", "full", "none", "full"):  # the first two warm up
        api = registry.get_model(cfg.name, dataclasses.replace(
            cfg, remat=remat))
        got.pop(remat, None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        (loss, grads), t = timed(dev, loss_and_grads, api, params, batch)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else None
        ms[remat].append(t)
        got[remat] = (float(loss), grads, peak)
        del grads
    if not math.isclose(got["none"][0], got["full"][0], rel_tol=1e-6):
        raise AssertionError(f"remat changed the loss: {got['none'][0]!r} "
                             f"against {got['full'][0]!r}")
    worst = close_leaves(got["full"][1], got["none"][1], LM_GRAD_TOL,
                         "remat full against none")
    print(f"lm train remat: {cfg.name} float32, {REMAT_BATCH} x {REMAT_SEQ} "
          f"tokens: loss {got['full'][0]!r} / {got['none'][0]!r} (full / "
          f"none, tolerance rel 1e-6), remat full against none "
          f"within {worst!r} of each leaf's largest (tolerance "
          f"{LM_GRAD_TOL}); loss and gradients (none / full) first calls "
          f"{ms['none'][0]!r} / {ms['full'][0]!r} ms, then {ms['none'][1]!r} "
          f"/ {ms['full'][1]!r} ms, peak {got['none'][2]!r} / "
          f"{got['full'][2]!r} B (each with the other's gradients held), on "
          f"{smi}")


def check_gemma2_training(seed: int, dev, smi: str) -> float:
    """Phase 8a: gemma2-2b trained at its published widths.  Returns the
    median seconds of a step after the first."""
    from repro_torch.data.pipeline import PrefetchIterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import OptimizerConfig

    cfg = TRAIN_GEMMA2
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, GEMMA2_PARAMS)
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR,
                           warmup_steps=max(GEMMA2_TRAIN_STEPS // 20, 2),
                           decay_steps=GEMMA2_TRAIN_STEPS)
    state = {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}
    before = [t.clone() for t in (params["final_norm"]["scale"],
                                  params["embed"]["tok"][:64])]
    step = make_train_step(api, ocfg, donate=True)
    data = PrefetchIterator(lambda i: lm_batch(cfg, GEMMA2_TRAIN_BATCH,
                                               GEMMA2_TRAIN_SEQ,
                                               seed, i), device=dev)
    try:
        state, losses, norms, ms = train_steps(
            step, state, itertools.islice(data, GEMMA2_TRAIN_STEPS), dev)
        _, batch = next(data)
    finally:
        data.close()
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{cfg.name}: loss or grad_norm not finite: "
                             f"{losses} {norms}")
    after = (state["params"]["final_norm"]["scale"],
             state["params"]["embed"]["tok"][:64])
    if any(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError(f"{cfg.name}: the parameters did not move")
    secs = statistics.median(ms[1:]) / 1e3
    print(f"lm train: {describe(cfg)}, remat {cfg.remat}, {ocfg.name} "
          f"(donated, in place), {GEMMA2_TRAIN_STEPS} steps of "
          f"{GEMMA2_TRAIN_BATCH} x {GEMMA2_TRAIN_SEQ} MarkovLMStream tokens "
          f"through PrefetchIterator: "
          f"loss {losses!r}, grad_norm {norms!r}, parameters moved; "
          f"{ms!r} ms a step, median after the first {secs!r} s = "
          f"{GEMMA2_TRAIN_BATCH * GEMMA2_TRAIN_SEQ / secs!r} tokens/s "
          f"trained, on {smi}")
    _, prof = profile_step(step, state, batch, dev)
    print(f"lm train: {cfg.name} bf16 {prof}, on {smi}")
    return secs


def spike_rates(api, params, toks: torch.Tensor) -> list[float]:
    """Each sLSTM layer's spike rate over a train-mode forward of
    ``toks`` (``spike_fn``'s calls recorded: one a step, a layer's in
    order)."""
    from repro_torch.models.layers import xlstm

    record = []
    real = xlstm.spike_fn

    def recorded(u, vth, slope=25.0):
        s = real(u, vth, slope)
        record.append(s.detach().float().mean())
        return s

    xlstm.spike_fn = recorded
    try:
        with torch.no_grad():
            api.forward(params, {"tokens": toks})
    finally:
        xlstm.spike_fn = real
    n = toks.shape[1]
    return [torch.stack(record[j * n:(j + 1) * n]).mean().item()
            for j in range(len(record) // n)]


def check_xlstm_training(seed: int, dev, smi: str) -> None:
    """Phase 8c: xlstm-350m with the spiking sLSTM, trained at its
    published widths (bf16, its config's dtype; remat "none", its
    config's)."""
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import OptimizerConfig

    cfg = TRAIN_XLSTM
    if XLSTM_TRAIN_SEQ % cfg.ssm.chunk or cfg.ssm.scan_impl != "chunked":
        raise AssertionError("phase 8c's batch must take the chunked form")
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, XLSTM_PARAMS)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    for i in cfg.ssm.slstm_layers:
        vth = params["layers"][i]["block"]["vth"]
        vth.copy_(torch.randn(vth.shape, generator=gen, device=dev)
                  * SPIKE_VTH_STD)
    batches = [on(dev, lm_batch(cfg, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ,
                                seed, i))
               for i in range(XLSTM_TRAIN_STEPS + 1)]
    held = batches.pop()["tokens"]
    rate0 = spike_rates(api, params, held)
    vth0 = [params["layers"][i]["block"]["vth"].clone()
            for i in cfg.ssm.slstm_layers]
    loss, grads = loss_and_grads(api, params, batches[0])
    bad = [i for i, g in enumerate(grads) if not torch.isfinite(g).all()]
    if bad or not math.isfinite(float(loss)):
        raise AssertionError(f"{cfg.name} spiking: gradients not finite at "
                             f"leaves {bad}")
    paths = leaf_paths(params)
    vth_grad = [grads[paths.index(f"/layers/{i}/block/vth")].abs().max()
                .item() for i in cfg.ssm.slstm_layers]
    if not all(g > 0 for g in vth_grad):
        raise AssertionError(f"{cfg.name}: no gradient reaches vth")
    del grads
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR, warmup_steps=2,
                           decay_steps=XLSTM_TRAIN_STEPS)
    state = {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}
    step = make_train_step(api, ocfg, donate=True)
    state, losses, norms, ms = train_steps(step, state,
                                           enumerate(batches), dev)
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{cfg.name}: loss or grad_norm not finite")
    rate1 = spike_rates(api, state["params"], held)
    moved = [(state["params"]["layers"][i]["block"]["vth"] - v).abs().max()
             .item() for i, v in zip(cfg.ssm.slstm_layers, vth0)]
    secs = statistics.median(ms[1:]) / 1e3
    print(f"lm train: {describe(cfg)}, spiking sLSTM (vth ~ N(0, "
          f"{SPIKE_VTH_STD}^2)), {ocfg.name}, {XLSTM_TRAIN_STEPS} steps of "
          f"{XLSTM_TRAIN_BATCH} x {XLSTM_TRAIN_SEQ} tokens: gradients "
          f"finite, max |d loss / d vth| a layer {vth_grad!r}; loss "
          f"{losses!r}, grad_norm {norms!r}; spike rate a layer (layers "
          f"{cfg.ssm.slstm_layers}) before "
          f"{rate0!r}, after {rate1!r}, max |d vth| {moved!r}; {ms!r} ms a "
          f"step, median after the first {secs!r} s = "
          f"{XLSTM_TRAIN_BATCH * XLSTM_TRAIN_SEQ / secs!r} tokens/s, on "
          f"{smi}")


def masked_spans(record: list):
    """Wrap ``mamba2._mamba2_chunked`` so that each call appends the
    largest exponent its masked entries reach, max over chunks and heads
    of cum_0 - cum_(L-1) (the log-decay summed over a chunk): past
    ``F32_LOG_MAX`` exp overflows to inf, and the backward's inf x 0 is
    NaN.  Returns the real function."""
    from repro_torch.models.layers import mamba2

    real = mamba2._mamba2_chunked

    def recorded(xs, bs, cs, dt, a, chunk):
        with torch.no_grad():
            b, seq, h = dt.shape
            cum = torch.cumsum((dt * a).reshape(b, seq // chunk, chunk, h),
                               dim=2)
            record.append((cum[:, :, 0] - cum[:, :, -1]).max().item())
        return real(xs, bs, cs, dt, a, chunk)

    mamba2._mamba2_chunked = recorded
    return real


def layer_units(params: dict, grads: list, cfg):
    """(path, layer, gradient) of every leaf of a hybrid: its stacked
    Mamba2 leaves one unit a layer (``groups`` element (i, j) is layer
    l = i attn_every + j, then ``tail``), ``layer`` None for the others."""
    first_tail = cfg.num_layers // cfg.attn_every * cfg.attn_every
    for path, grad in zip(leaf_paths(params), grads):
        top = path.strip("/").split("/")[0]
        if top not in ("groups", "tail"):
            yield path, None, grad
            continue
        first = 0 if top == "groups" else first_tail
        for k, layer in enumerate(grad.flatten(0, 1) if top == "groups"
                                  else grad):
            yield path, first + k, layer


def nan_out_of_reach(params: dict, grads: list, cfg,
                     overflowed: list[bool]) -> tuple[list[str], list[str]]:
    """Phase 8d's hold on a hybrid's non-finite gradients.  Mamba2 layer l
    whose masked exp overflowed has NaN in its own a_log gradient (the
    backward's inf x 0, tests/test_torch_lm_remat.py), and the NaN can
    reach its dt_bias and w_in, its norm, and everything upstream of its
    input: the layers before it, the shared block's applications before
    it, the embedding.  Past the last such layer, and in that layer's
    other leaves, every gradient is finite.  Returns the leaf elements
    (path and layer) that are not finite out of that reach, and the
    overflowed layers whose a_log gradient holds no NaN."""
    last = max((i for i, o in enumerate(overflowed) if o), default=-1)
    reach = {"embed": last >= 0, "shared_attn": last >= cfg.attn_every}
    stray, missing = [], []
    for path, i, grad in layer_units(params, grads, cfg):
        top, *rest = path.strip("/").split("/")
        finite = bool(torch.isfinite(grad).all())
        if i is None:
            if not finite and not reach.get(top, False):
                stray.append(path)
            continue
        own = rest[0] == "norm" or rest[-1] in ("a_log", "dt_bias", "w_in")
        if not finite and not (i < last or (i == last and own)):
            stray.append(f"{path} layer {i}")
        if overflowed[i] and rest[-1] == "a_log" and not grad.isnan().any():
            missing.append(f"{path} layer {i}")
    return stray, missing


def against_float32(params: dict, grads: list, grads32: list, cfg):
    """Phase 8d's hold of the bf16 gradients on a float32 run: unit by unit
    (``layer_units``) the elements finite in bf16 must be those finite in
    float32, and where any is, the relative L2 error of the finite ones is
    at most ``BF16_GRAD_RTOL``.  Returns (the units whose patterns differ,
    (unit, relative error) of every unit with a finite element, the
    largest error first)."""
    differ, errs = [], []
    for (path, i, g), (_, _, g32) in zip(layer_units(params, grads, cfg),
                                         layer_units(params, grads32, cfg),
                                         strict=True):
        name = path if i is None else f"{path} layer {i}"
        fin, fin32 = torch.isfinite(g), torch.isfinite(g32)
        if not torch.equal(fin, fin32):
            differ.append(f"{name}: {int((fin != fin32).sum())} of "
                          f"{fin.numel()} elements")
        both = fin & fin32
        if not both.any():
            continue
        want = g32[both].double()
        err = torch.linalg.vector_norm(g[both].double() - want).item()
        errs.append((name, err / max(torch.linalg.vector_norm(want).item(),
                                     1e-30)))
    return differ, sorted(errs, key=lambda e: -e[1])


def zamba2_float32_grads(api, params: dict, batch: dict):
    """The loss, gradients and largest masked exponents of each layer's
    chunks of ``api``'s model at float32: the parameters upcast, the same
    batch, TF32 off (``main``)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import registry
    from repro_torch.models.layers import mamba2

    cfg32 = dataclasses.replace(api.cfg, dtype=torch.float32)
    api32 = registry.get_model(cfg32.name, cfg32)
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   params)
    spans = []
    real = masked_spans(spans)
    try:
        loss, grads = loss_and_grads(api32, p32, batch)
    finally:
        mamba2._mamba2_chunked = real
    return loss, grads, spans[:cfg32.num_layers]


def check_zamba2_training(seed: int, dev, smi: str) -> None:
    """Phase 8d: zamba2-7b at its published widths over two groups (12
    Mamba2 layers, two shared-attention applications), bf16, remat
    "full", the chunked scan."""
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import registry
    from repro_torch.models.layers import mamba2
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import OptimizerConfig

    cfg = TRAIN_ZAMBA2
    if ZAMBA2_TRAIN_SEQ % cfg.ssm.chunk or cfg.ssm.scan_impl != "chunked":
        raise AssertionError("phase 8d's batch must take the chunked form")
    print(f"lm train: {cfg.name} cut in depth to num_layers="
          f"{cfg.num_layers} (published {ZAMBA2_7B.num_layers}), "
          f"{cfg.num_layers // cfg.attn_every} shared-attention groups")
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, ZAMBA2_CUT_PARAMS)
    batches = [on(dev, lm_batch(cfg, ZAMBA2_TRAIN_BATCH, ZAMBA2_TRAIN_SEQ,
                                seed, i)) for i in range(ZAMBA2_TRAIN_STEPS)]
    spans = []
    real = masked_spans(spans)
    try:
        loss, grads = loss_and_grads(api, params, batches[0])
    finally:
        mamba2._mamba2_chunked = real
    names = leaf_paths(params)
    nan = {n: int((~torch.isfinite(g)).sum()) for n, g in zip(names, grads)}
    nan = {n: c for n, c in nan.items() if c}
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{cfg.name}: the loss is not finite")
    if len(spans) < cfg.num_layers:
        raise AssertionError(f"{cfg.name}: {len(spans)} chunked scans for "
                             f"{cfg.num_layers} Mamba2 layers")
    # the forward's scans, layer by layer (remat's recomputation follows)
    layer_spans = spans[:cfg.num_layers]
    overflowed = [x > F32_LOG_MAX for x in layer_spans]
    stray, missing = nan_out_of_reach(params, grads, cfg, overflowed)
    if stray or missing:
        raise AssertionError(
            f"{cfg.name}: gradients not finite out of the masked exp's "
            f"reach {stray}, or finite in an overflowed layer's a_log "
            f"{missing} (layers overflowed {overflowed})")
    loss32, grads32, spans32 = zamba2_float32_grads(api, params, batches[0])
    differ, errs = against_float32(params, grads, grads32, cfg)
    del grads, grads32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if differ or not errs or errs[0][1] > BF16_GRAD_RTOL:
        raise AssertionError(
            f"{cfg.name}: bf16 gradients against float32: finite elements "
            f"differ in {differ}, or a finite unit off by more than "
            f"{BF16_GRAD_RTOL} (relative L2): {errs[:5]}")
    units = ", ".join(f"{n} {e!r}" for n, e in errs)
    compared = (f"the finite gradients held against a float32 run of the "
                f"same cut, parameters (upcast) and batch (loss "
                f"{float(loss32)!r}, largest masked exponents "
                f"{spans32!r}): finite where float32's are, unit by unit "
                f"(a stacked leaf a layer); {len(errs)} units with finite "
                f"elements, relative L2 error at most {errs[0][1]!r} "
                f"({errs[0][0]}; bound {BF16_GRAD_RTOL}): {units}")
    verdict = (f"gradients not finite at {len(nan)} of {len(names)} leaves "
               f"({sum(nan.values())} elements), all within the reach of "
               f"the overflowed layers' NaN (the reference's: "
               f"tests/test_torch_lm_remat.py "
               f"test_mamba2_strong_decay_gradient); {compared}" if nan
               else f"gradients finite; {compared}")
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR, warmup_steps=2,
                           decay_steps=ZAMBA2_TRAIN_STEPS)
    state = {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}
    step = make_train_step(api, ocfg, donate=True)
    state, losses, norms, ms = train_steps(step, state, enumerate(batches),
                                           dev)
    if not nan and not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{cfg.name}: loss or grad_norm not finite")
    secs = statistics.median(ms[1:]) / 1e3
    print(f"lm train: {describe(cfg)}, remat {cfg.remat}, {ocfg.name}, "
          f"{ZAMBA2_TRAIN_STEPS} steps of {ZAMBA2_TRAIN_BATCH} x "
          f"{ZAMBA2_TRAIN_SEQ} tokens: first loss {float(loss)!r}; largest "
          f"masked exponent of a chunk, layer by layer, {layer_spans!r} "
          f"(exp overflows past {F32_LOG_MAX!r}); {verdict}; loss "
          f"{losses!r}, grad_norm {norms!r}; {ms!r} ms a step"
          f"{' (the steps spread the NaN)' if nan else ''}, median after "
          f"the first {secs!r} s = "
          f"{ZAMBA2_TRAIN_BATCH * ZAMBA2_TRAIN_SEQ / secs!r} tokens/s, on "
          f"{smi}")


def restore_sigterm(trainer) -> None:
    """Give SIGTERM back the handler it had before ``trainer``'s
    ``PreemptionHandler`` took it."""
    import signal

    for sig, prev in trainer.preempt._prev.items():
        signal.signal(sig, prev)


def whisper_trainer(out: Path, seed: int, dev, ckpt_every: int):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = TRAIN_WHISPER
    api = registry.get_model(cfg.name, cfg)
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR, warmup_steps=2,
                           decay_steps=WHISPER_TRAIN_STEPS)

    def init_state():
        params = api.init(torch.Generator(device=dev).manual_seed(seed),
                          device=dev, max_dec_len=WHISPER_MAX_DEC_LEN)
        return {"params": params, "opt": opt_lib.init_opt_state(params,
                                                                ocfg)}

    tcfg = TrainerConfig(total_steps=WHISPER_TRAIN_STEPS, log_every=1,
                         ckpt_every=ckpt_every, out_dir=str(out))
    return Trainer(tcfg, make_train_step(api, ocfg, donate=True), init_state,
                   lambda i: lm_batch(cfg, WHISPER_TRAIN_BATCH,
                                      WHISPER_TRAIN_SEQ, seed, i),
                   device=dev)


def check_whisper_trainer(seed: int, dev, smi: str, tmp: Path) -> None:
    """Phase 8e: whisper-base at its published widths (bf16) through the
    port's ``Trainer``: preempted at call ``WHISPER_PREEMPT``
    (``t.preempt.trigger()``, as tests/test_training.py does), then
    auto-resumed; the final loss within ``RESUME_RTOL`` of an uninterrupted
    run's, ``metrics.jsonl`` and the checkpoints written, the heartbeat
    fresh at every step."""
    runs = {}
    for name, preempt in (("resumed", WHISPER_PREEMPT), ("whole", None)):
        out = tmp / f"whisper_{name}"
        t0 = time.perf_counter()
        t = whisper_trainer(out, seed, dev, WHISPER_CKPT_EVERY)
        if preempt is not None:
            count_params(t._init_state()["params"], TRAIN_WHISPER,
                         WHISPER_PARAMS)
            orig, calls = t.step_fn, {"n": 0}

            def wrapped(state, batch, _t=t, _orig=orig, _calls=calls):
                _calls["n"] += 1
                if _calls["n"] == preempt:
                    _t.preempt.trigger()
                return _orig(state, batch)

            t.step_fn = wrapped
            try:
                t.run()
            finally:
                restore_sigterm(t)
            stopped = t.ckpt.latest_step()
            if stopped != preempt:
                raise AssertionError(f"preempted run checkpointed step "
                                     f"{stopped}, not {preempt}")
            t = whisper_trainer(out, seed, dev, WHISPER_CKPT_EVERY)
        stale = []
        try:
            result = t.run(hooks=[lambda *_, _t=t: stale.append(
                _t.heartbeat.stale())])
        finally:
            restore_sigterm(t)
        if any(stale):
            raise AssertionError(f"{name}: the heartbeat went stale")
        lines = (out / "metrics.jsonl").read_text().splitlines()
        steps = [json.loads(x)["step"] for x in lines]
        if steps != list(range(WHISPER_TRAIN_STEPS)):
            raise AssertionError(f"{name}: metrics.jsonl steps {steps}")
        runs[name] = (result["metrics"]["loss"], t.ckpt.steps(),
                      time.perf_counter() - t0, len(stale))
    (got, ckpts, secs, n), (want, whole_ckpts, whole_secs, _) = \
        runs["resumed"], runs["whole"]
    if not math.isclose(got, want, rel_tol=RESUME_RTOL):
        raise AssertionError(f"resumed loss {got!r} against {want!r}")
    print(f"lm train: {describe(TRAIN_WHISPER)} through Trainer "
          f"({WHISPER_TRAIN_STEPS} steps of {WHISPER_TRAIN_BATCH} streams x "
          f"{TRAIN_WHISPER.encoder_seq} N(0, 1) frames and "
          f"{WHISPER_TRAIN_SEQ} tokens, checkpoints every "
          f"{WHISPER_CKPT_EVERY}): preempted at call {WHISPER_PREEMPT}, "
          f"auto-resumed, final loss {got!r} against {want!r} uninterrupted "
          f"(rel {abs(got - want) / abs(want)!r}, tolerance {RESUME_RTOL}); "
          f"checkpoints {ckpts} and {whole_ckpts}, metrics.jsonl steps "
          f"0-{WHISPER_TRAIN_STEPS - 1}, heartbeat fresh at all {n} "
          f"resumed steps; {secs!r} s (both legs, checkpoints included) and "
          f"{whole_secs!r} s uninterrupted, on {smi}")


def check_reduced_training(seed: int, dev) -> None:
    """Phase 8f: each arch at ``reduce_config``, float32: the loss and
    every gradient leaf on the card against the CPU (``LM_GRAD_TOL``),
    then one ``make_train_step`` step from the same parameters: the loss
    and each updated parameter (``UPDATE_TOL``, ``G_FLOOR``)."""
    from repro_torch.configs.archs import ALL_ARCHS
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import OptimizerConfig

    for arch in registry.list_archs():
        cfg = registry.reduce_config(ALL_ARCHS[arch])
        api = registry.get_model(arch, cfg)
        cpu = api.init(torch.Generator().manual_seed(seed), device="cpu")
        batch = lm_batch(cfg, 2, REDUCED_PROMPT, seed, 2)
        out = {}
        for where, device in (("cpu", torch.device("cpu")), ("card", dev)):
            p = tree_map(lambda t: t.to(device), cpu)  # noqa: B023
            loss, grads = loss_and_grads(api, p, on(device, batch))
            ocfg = OptimizerConfig(lr=STEP_LR, warmup_steps=0,
                                   decay_steps=10)
            state, m = make_train_step(api, ocfg)(
                {"params": p, "opt": opt_lib.init_opt_state(p, ocfg)},
                on(device, batch))
            out[where] = (float(loss), grads, float(m["loss"]),
                          tree_leaves(state["params"]),
                          min(1.0, ocfg.grad_clip / float(m["grad_norm"])))
        (l_cpu, g_cpu, s_cpu, p_cpu, clip), (l_dev, g_dev, s_dev, p_dev, _) \
            = out["cpu"], out["card"]
        if not (math.isclose(l_dev, l_cpu, rel_tol=1e-5)
                and math.isclose(s_dev, s_cpu, rel_tol=1e-5)):
            raise AssertionError(f"{arch}: loss {l_dev!r} / {s_dev!r} on "
                                 f"{dev}, {l_cpu!r} / {s_cpu!r} on cpu")
        worst = close_leaves(g_dev, g_cpu, LM_GRAD_TOL, f"{arch} gradients")
        near = 0
        for g, a, b in zip(g_cpu, p_dev, p_cpu, strict=True):
            d = (a.cpu() - b).abs()
            zero = g.abs() * clip < G_FLOOR
            near += int(zero.sum())
            if torch.where(zero, 0.0, d).max() > UPDATE_TOL * STEP_LR or \
                    d.max() > (2 + UPDATE_TOL) * STEP_LR:
                raise AssertionError(f"{arch}: an updated parameter is off "
                                     f"by {d.max().item()!r}")
        print(f"lm train reduced: {arch}: loss {dev} against cpu rel "
              f"{abs(l_dev - l_cpu) / l_cpu!r}, gradients within {worst!r} "
              f"of each leaf's largest (tolerance {LM_GRAD_TOL}); one step "
              f"(adamw, lr {STEP_LR}): parameters within {UPDATE_TOL} lr, "
              f"{near} of {sum(t.numel() for t in p_cpu)} near-zero-"
              f"gradient elements within {2 + UPDATE_TOL} lr")


def check_example_training(dev, smi: str) -> None:
    """Phase 8g: examples/serve_lm_torch.py's flow (``run``) on the card:
    the reduced gemma2 fitted for ``EXAMPLE_FIT_STEPS`` steps, then
    ``ServeLoop`` answering ``EXAMPLE_REQUESTS`` requests; the last fit
    loss below the first."""
    example = load_example("serve_lm_torch")
    t0 = time.perf_counter()
    out = example.run("gemma2-2b", EXAMPLE_FIT_STEPS, EXAMPLE_REQUESTS, dev)
    secs = time.perf_counter() - t0
    losses = out["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"serve_lm_torch: fit loss {losses[0]!r} -> "
                             f"{losses[-1]!r}")
    tokens = sum(len(r.out) for r in out["done"])
    print(f"lm train example: serve_lm_torch.run on {dev}: fit loss "
          f"{losses[0]!r} -> {losses[-1]!r} over {EXAMPLE_FIT_STEPS} steps, "
          f"{len(out['done'])} requests served, {tokens} tokens in "
          f"{out['seconds']!r} s; {secs!r} s in all, on {smi}")


def check_lm_training(seed: int, dev, smi: str, tmp: Path) -> dict:
    """Phase 8: the token-LM train path on the card (``launch/steps.py``
    ``make_train_step``, ``data/pipeline.py``, ``training/trainer.py``),
    plain PyTorch: no kernel of the port lies on it, and every launch
    counter stays 0.  (b) gemma2 float32: a block card against CPU, remat
    against none; (a) gemma2-2b bf16 trained at full width; (c) the
    spiking xlstm-350m; (d) zamba2-7b over 12 layers; (e) whisper-base
    through the Trainer, preempted and resumed; (f) the ten reduced archs,
    card against CPU; (g) the example.  Seconds a step, tokens/s and peak
    memory printed beside the card.  Returns each check's result by name
    (8a's: the median seconds of a gemma2-2b step)."""
    t0 = time.perf_counter()
    print(f"phase 8 on {smi}")
    set_counts(0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()  # the allocator's statistics need the context
    results = {}
    for name, check in (("8b gemma2-2b float32", check_remat),
                        ("8a gemma2-2b", check_gemma2_training),
                        ("8c xlstm-350m", check_xlstm_training),
                        ("8d zamba2-7b", check_zamba2_training),
                        ("8e whisper-base", functools.partial(
                            check_whisper_trainer, tmp=tmp))):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        results[name] = check(seed, dev, smi)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        print(f"lm train: {name}: {time.perf_counter() - t1!r} s, peak "
              f"memory {peak!r} B (max_memory_allocated), on {smi}")
    if cuda:
        torch.cuda.empty_cache()
    check_reduced_training(seed, dev)
    check_example_training(dev, smi)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 8 launched kernels: {counts}")
    print(f"phase 8: {time.perf_counter() - t0!r} s; no kernel launched")
    return results


# ------------------------------------------ examples, yardstick (phase 9)

# phase 9b: the compression example's functions at gemma2-2b's published
# widths and config (bf16), at the example's prune fraction
EXAMPLE_GEMMA2 = GEMMA2_2B
EXAMPLE_PRUNE, EXAMPLE_TOKENS = 0.4, (2, 16)
H100_BF16_FLOPS = 989e12  # dense bf16, the H100 SXM data sheet


def run_recorded(example, argv: list[str]) -> dict:
    """``example.main(argv)``, which calls ``example.run`` once; returns
    what ``run`` returned.  A nonzero exit raises."""
    got = []
    real = example.run
    example.run = lambda *a, **kw: got.append(real(*a, **kw))
    try:
        code = example.main(argv)
    finally:
        example.run = real
    if code != 0 or len(got) != 1:
        raise AssertionError(f"{example.__name__} {argv}: exit {code}, "
                             f"{len(got)} runs")
    return got[0]


def expect_launches(what: str, dev, want: dict) -> dict:
    """Every launch counter as ``want`` says, the others 0 (on the CPU,
    where the plain versions run, all 0)."""
    counts = read_counts()
    want = {n: want.get(n, 0) if dev.type == "cuda" else 0 for n in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")
    return {n: c for n, c in counts.items() if c}


@torch.no_grad()
def cell_near_threshold(stim, s_prev, w, u0, h0, beta, vth) -> torch.Tensor:
    """(B, H) elements whose potential comes within ``TOL`` of
    the threshold at some time step, the chain replayed in float64."""
    stim, s_prev, w, u, h, beta, vth = (
        t.double() for t in (stim, s_prev, w, u0, h0, beta, vth))
    near = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for t in range(s_prev.shape[0]):
        u = stim[t] + s_prev[t] @ w + beta * u * (1.0 - h)
        near |= (u - vth).abs() <= TOL * (1.0 + u.abs())
        h = (u >= vth).double()
    return near


def check_quickstart(dev, smi: str) -> None:
    """Phase 9a: ``examples/quickstart_torch.py``'s ``main``: 30 QAT steps,
    the accounting, then K1 and K3 once each on the trained weights, held
    against their plain versions on the same tensors."""
    from repro_torch.kernels import ref

    example = load_example("quickstart_torch")
    set_counts(0)
    t0 = time.perf_counter()
    out = run_recorded(example, ["--device", dev.type])
    secs = time.perf_counter() - t0
    launched = expect_launches("9a quickstart", dev,
                               {"rsnn_cell": 1, "merged_spike_fc": 1})
    losses = [loss for loss, _ in out["history"]]
    if len(losses) != example.STEPS or not (
            math.isfinite(losses[0]) and math.isfinite(losses[-1])
            and losses[-1] < losses[0]):
        raise AssertionError(f"9a quickstart: losses {losses}")
    k = out["kernels"]
    spikes, u = ref.rsnn_cell_ref(*k["cell_args"])
    near = cell_near_threshold(*k["cell_args"])
    flipped = (k["spikes"] != spikes).any(dim=0)
    ok = ~(flipped | near)
    du = ((k["u"] - u).abs() / (1.0 + u.abs()))[ok].max().item()
    if (flipped & ~near).any() or du > TOL:
        raise AssertionError(f"9a quickstart: K1 against its plain version: "
                             f"{int((flipped & ~near).sum())} spikes off "
                             f"the threshold differ, |du| / (1 + |u|) "
                             f"{du!r}")
    logits = ref.merged_spike_fc_ref(*k["fc_args"])
    dl = ((k["logits"] - logits).abs() / (1.0 + logits.abs())).max().item()
    if dl > TOL:
        raise AssertionError(f"9a quickstart: K3 off its plain version by "
                             f"{dl!r} of (1 + |y|)")
    acc = out["accounting"]
    print(f"examples: quickstart_torch.py --device {dev.type}: loss "
          f"{losses[0]!r} -> {losses[-1]!r} over {len(losses)} steps, frame "
          f"error rate {out['history'][0][1]!r} -> "
          f"{out['history'][-1][1]!r}; {acc['size_kb']!r} KB, "
          f"{acc['mmac']!r} MMAC/s, {acc['cycles']!r} cycles a frame; "
          f"launches {launched}; K1 spike rate "
          f"{k['spikes'].mean().item()!r}, spikes equal to the plain "
          f"version's off {int(near.sum())} near-threshold elements, "
          f"largest |du| / (1 + |u|) {du!r}; K3 logits "
          f"{tuple(k['logits'].shape)}, largest |d| / (1 + |y|) {dl!r} "
          f"(tolerance {TOL}); {secs!r} s, on {smi}")


def check_compress(seed: int, dev, smi: str) -> None:
    """Phase 9b: ``examples/compress_pipeline_torch.py``'s ``main`` at its
    default (yi-6b reduced), K2 launched once and within ``TOL`` of
    the dequantized product; then its ``compress`` and ``drift`` on
    gemma2-2b at its published widths, drawn on the card."""
    from repro_torch.models import registry

    example = load_example("compress_pipeline_torch")
    set_counts(0)
    t0 = time.perf_counter()
    out = run_recorded(example, ["--device", dev.type])
    secs = time.perf_counter() - t0
    launched = expect_launches("9b compress_pipeline", dev,
                               {"int4_matmul": 1})
    bound = TOL * (1.0 + out["int4_y"].abs().max().item())
    if not out["int4_err"] <= bound:
        raise AssertionError(f"9b compress_pipeline: K2 off the dequantized "
                             f"product by {out['int4_err']!r} (> {bound!r})")
    print(f"examples: compress_pipeline_torch.py --device {dev.type} (yi-6b "
          f"reduced): {out['fp32_bytes']!r} B fp32 -> "
          f"{out['quant_bytes']!r} B int4+prune, {out['pruned']} pruned, "
          f"drift {out['drift']!r} (scale {out['scale']!r}); launches "
          f"{launched}, K2 largest |d| {out['int4_err']!r} (bound "
          f"{bound!r}); {secs!r} s, on {smi}")

    cfg = EXAMPLE_GEMMA2
    api = registry.get_model(cfg.name, cfg)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    set_counts(0)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    params = api.init(gen.manual_seed(seed), device=dev)
    count_params(params, cfg, GEMMA2_PARAMS)
    cparams, rep = example.compress(params, EXAMPLE_PRUNE)
    tokens = torch.randint(0, cfg.vocab_size, EXAMPLE_TOKENS, device=dev,
                           generator=gen.manual_seed(seed + 1))
    drift, scale = example.drift(api, params, cparams,
                                 example.make_batch(cfg, tokens))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del params, cparams
    if cuda:
        torch.cuda.empty_cache()
    expect_launches("9b gemma2-2b", dev, {})
    selected = (rep["fp32_bytes"] - rep["quant_bytes"]) / 3.5
    if rep["fp32_bytes"] != 4 * GEMMA2_PARAMS or not (
            0 < rep["pruned"] <= EXAMPLE_PRUNE * selected) or not (
            math.isfinite(drift) and drift > 0):
        raise AssertionError(f"9b gemma2-2b: {rep['fp32_bytes']} fp32 B, "
                             f"{rep['pruned']} of {selected} pruned, drift "
                             f"{drift}")
    print(f"examples: compress and drift on {describe(cfg)}, prune "
          f"{EXAMPLE_PRUNE}: {len(rep['paths'])} leaves selected "
          f"({selected!r} weights), {rep['fp32_bytes']!r} B fp32 -> "
          f"{rep['quant_bytes']!r} B int4+prune, {rep['pruned']} pruned "
          f"(ties of the threshold kept); logit drift {drift!r} (scale "
          f"{scale!r}) over {EXAMPLE_TOKENS[0]} x {EXAMPLE_TOKENS[1]} "
          f"tokens; {secs!r} s, peak memory {peak!r} B "
          f"(max_memory_allocated); no kernel launched, on {smi}")


def check_yardstick(dev, smi: str, step_s: float) -> None:
    """Phase 9c: ``analysis/model_flops.py`` for the ten archs (on the meta
    device) and phase 8a's gemma2-2b step against its 6 N T bound."""
    from repro_torch.analysis.model_flops import model_flops, param_counts
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import registry

    set_counts(0)
    for arch in registry.list_archs():
        print(f"yardstick: {arch} param_counts {param_counts(arch)}")
    shape = ShapeConfig("phase_8a", GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_BATCH,
                        "train")
    flops = model_flops(TRAIN_GEMMA2.name, shape)
    bound = flops / H100_BF16_FLOPS
    expect_launches("9c yardstick", dev, {})
    print(f"yardstick: {TRAIN_GEMMA2.name} train step of "
          f"{GEMMA2_TRAIN_BATCH} x {GEMMA2_TRAIN_SEQ} tokens (phase 8a): "
          f"model_flops {flops!r} (6 N_active T, remat's recomputed forward "
          f"not counted) = {bound!r} s at "
          f"{H100_BF16_FLOPS!r} FLOP/s dense bf16; 8a's median step "
          f"{step_s!r} s, {bound / step_s!r} of it the bound; no kernel "
          f"launched, on {smi}")


def check_examples(seed: int, dev, smi: str, step_s: float) -> None:
    """Phase 9: the two examples on the card (9a quickstart: K1, K3; 9b
    compress_pipeline: K2, then gemma2-2b at its published widths) and the
    LM yardstick (9c)."""
    t0 = time.perf_counter()
    print(f"phase 9 on {smi}")
    check_quickstart(dev, smi)
    check_compress(seed, dev, smi)
    check_yardstick(dev, smi, step_s)
    print(f"phase 9: {time.perf_counter() - t0!r} s")


# ------------------------------------------------ distributed layer (phase 10)

# phase 10a: the rules on the production meshes, over meta devices
DIST_MESHES = {"16x16": False, "2x16x16": True}  # name: multi_pod
H100_MEMORY_BYTES = 80e9  # the card's 80 GB, what the dry run holds against
# phase 10b: gemma2-2b at its published widths (bf16) with its AdamW state,
# placed on the card's (1, 1) elastic mesh; then launch/train.py's main,
# reduced as the reference forces, against a direct Trainer run
PLACE_GEMMA2 = GEMMA2_2B
MAIN_STEPS, MAIN_BATCH, MAIN_SEQ = 3, 8, 128
# phase 10c: the int8 codec over one gemma2-2b gradient at phase 8a's
# batch; these leaves also through the codec on the CPU, bit for bit
CODEC_LEAVES = ("['embed']['tok']", "['layers']['mlp']['w_down']",
                "['final_norm']['scale']")
# phase 10d: compressed_psum over a one-rank process group of this backend
PSUM_BACKEND = "nccl"


def device_bytes(tree, specs, mesh) -> tuple[int, int]:
    """The largest and the smallest bytes a device of ``mesh`` holds of
    ``tree`` placed by ``specs``: each leaf's block from
    ``runtime/elastic.py`` ``shard_slices``, which raises on a sharded
    dimension that does not divide."""
    from repro_torch.runtime.elastic import shard_slices

    total = np.zeros(mesh.devices.shape, dtype=np.int64)
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs), strict=True):
        size = leaf.element_size()
        for coord, sl in shard_slices(tuple(leaf.shape), spec,
                                      mesh).items():
            total[coord] += size * math.prod(
                len(range(*s.indices(d))) for s, d in zip(sl, leaf.shape))
    return int(total.max()), int(total.min())


def check_specs(smi: str) -> None:
    """Phase 10a: for the ten archs at full width on the meta device, on
    the 16 x 16 and 2 x 16 x 16 production meshes (meta devices): the
    parameter specs, ``state_specs`` for the arch's optimizer, the
    ``train_4k`` batch specs and the ``decode_32k`` cache specs; every
    sharded dimension divides; per-device bytes of parameters plus
    optimizer state, and of the cache."""
    from repro_torch.configs.base import DECODE_32K, TRAIN_4K
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import batch_shapes
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt_lib

    meta = torch.device("meta")
    for arch in registry.list_archs():
        t0 = time.perf_counter()
        api = registry.get_model(arch)
        params = api.init(torch.Generator(), device=meta)
        ocfg = opt_lib.OptimizerConfig(name=api.cfg.optimizer)
        opt = opt_lib.init_opt_state(params, ocfg)
        cache = api.init_cache(DECODE_32K.global_batch, DECODE_32K.seq_len,
                               device=meta)
        batch = batch_shapes(api.cfg, TRAIN_4K)
        line = []
        for name, multi_pod in DIST_MESHES.items():
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        devices=[meta] * (512 if multi_pod
                                                          else 256))
            pspecs = shd.tree_param_specs(params, mesh)
            state = {"params": params, "opt": opt}
            sspecs = {"params": pspecs,
                      "opt": opt_lib.state_specs(pspecs, params, ocfg)}
            hi, lo = device_bytes(state, sspecs, mesh)
            c_hi, _ = device_bytes(cache, shd.tree_cache_specs(
                cache, mesh, DECODE_32K.global_batch), mesh)
            bspecs = shd.batch_specs(batch, mesh)
            device_bytes(batch, bspecs, mesh)
            line.append(f"{name}: params+{ocfg.name} {hi!r} B a device (min "
                        f"{lo!r}; {hi / H100_MEMORY_BYTES!r} of 80 GB), "
                        f"decode_32k cache {c_hi!r} B a device "
                        f"({c_hi / H100_MEMORY_BYTES!r} of 80 GB), train_4k "
                        f"tokens {tuple(bspecs['tokens'])}")
        n = sum(t.numel() for t in tree_leaves(params))
        print(f"specs: {arch} ({n} parameters, {len(tree_leaves(params))} "
              f"leaves): " + "; ".join(line) + f"; every sharded dim "
              f"divides; {time.perf_counter() - t0!r} s")


def train_losses(out: Path) -> dict:
    """``{step: loss}`` of a Trainer's ``metrics.jsonl``."""
    recs = [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r["loss"] for r in recs}


def check_train_main(dev, smi: str, tmp: Path) -> None:
    """Phase 10b (second half): ``launch/train.py`` ``main`` on the card
    (a world of one NCCL rank: its host mesh of ranks, specs and
    ``reshard_state``, which keeps one rank's leaves plain), losses and
    final state bit-equal to a direct ``Trainer`` run of the same seed
    without them."""
    from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.trainer import Trainer, TrainerConfig

    arch = PLACE_GEMMA2.name
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        got = train.main(["--arch", arch, "--steps", str(MAIN_STEPS),
                          "--batch", str(MAIN_BATCH), "--seq", str(MAIN_SEQ),
                          "--out", str(tmp / "train_main"), "--no-resume",
                          "--device", dev.type])
    t_main = time.perf_counter() - t0
    axes = {a: shd.axis_size(a) for a in ("data", "model")}
    shd.set_activation_axes(None)
    cfg = registry.reduce_config(registry.get_model(arch).cfg)
    api = registry.get_model(arch, cfg)
    ocfg = opt_lib.OptimizerConfig(name="adamw", lr=TRAIN_LR,
                                   warmup_steps=max(MAIN_STEPS // 20, 2),
                                   decay_steps=MAIN_STEPS)
    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size))

    def init_state():  # main's draw: the CPU generator, then the card
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        params = tree_map(lambda t: t.to(dev), params)
        return {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}

    tcfg = TrainerConfig(total_steps=MAIN_STEPS, log_every=1, ckpt_every=10,
                         out_dir=str(tmp / "train_direct"), resume=False)
    with contextlib.redirect_stdout(io.StringIO()):
        want = Trainer(tcfg, steps_lib.make_train_step(api, ocfg,
                                                       donate=True),
                       init_state, lambda s: {"tokens": stream.batch(
                           MAIN_BATCH, MAIN_SEQ, s)["tokens"]},
                       device=dev).run()
    got_l, want_l = train_losses(tmp / "train_main"), train_losses(
        tmp / "train_direct")
    if not got_l or any(got_l[s] != want_l[s] for s in got_l):
        raise AssertionError(f"launch/train.py main: losses {got_l}, direct "
                             f"Trainer {want_l}")
    # main's state on its (1, 1) mesh of one rank: the plain leaves
    differ = [p for (p, a), b in zip(tree_leaves_with_path(got["state"]),
                                     tree_leaves(want["state"]), strict=True)
              if type(a) is not torch.Tensor or not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"launch/train.py main: final state differs from "
                             f"the direct Trainer's at {differ}")
    print(f"distributed: launch/train.py main --arch {arch} (reduced) "
          f"--steps {MAIN_STEPS} --batch {MAIN_BATCH} --seq {MAIN_SEQ} on "
          f"{dev}: mesh axes {axes}, losses {got_l!r} bit-equal to a direct "
          f"Trainer's {want_l!r}, final state bit-equal; main {t_main!r} s, "
          f"on {smi}")


def check_placement(seed: int, dev, smi: str, tmp: Path):
    """Phase 10b: gemma2-2b at its published widths, bf16 parameters and
    AdamW state on the card, placed through ``reshard_state`` on
    ``make_elastic_mesh(devices=[dev])``, (1, 1): every leaf the same
    tensor, ``memory_allocated`` unchanged.  Returns the parameters."""
    from repro_torch.models import registry
    from repro_torch.runtime.elastic import make_elastic_mesh, reshard_state
    from repro_torch.training import optimizer as opt_lib

    cfg = PLACE_GEMMA2
    api = registry.get_model(cfg.name, cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    count_params(params, cfg, GEMMA2_PARAMS)
    ocfg = opt_lib.OptimizerConfig(name=cfg.optimizer)
    state = {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}
    mesh = make_elastic_mesh(devices=[dev])
    if mesh.shape != {"data": 1, "model": 1}:
        raise AssertionError(f"elastic mesh of one card: {mesh.shape}")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev) if cuda else None
    t0 = time.perf_counter()
    (placed,) = reshard_state(state, mesh)
    secs = time.perf_counter() - t0
    after = torch.cuda.memory_allocated(dev) if cuda else None
    pairs = list(zip(tree_leaves(placed), tree_leaves(state), strict=True))
    if not all(a is b and a.data_ptr() == b.data_ptr() for a, b in pairs):
        raise AssertionError("reshard_state on a (1, 1) mesh copied a leaf")
    if before != after:
        raise AssertionError(f"reshard_state allocated: {before} -> {after}")
    n_opt = sum(t.numel() * t.element_size()
                for t in tree_leaves(state["opt"]))
    n_par = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"distributed: {cfg.name} bf16 {n_par!r} B parameters + "
          f"{ocfg.name} {n_opt!r} B state ({len(pairs)} leaves) placed on "
          f"make_elastic_mesh([{dev}]) {mesh.shape}: every leaf the same "
          f"storage, memory_allocated {before!r} B before and after; "
          f"{secs!r} s, on {smi}")
    del state, placed, pairs
    check_train_main(dev, smi, tmp)
    return params


def check_codec(params, seed: int, dev, smi: str):
    """Phase 10c: ``compress_grads`` over one gemma2-2b gradient at phase
    8a's batch: three leaves' q and scale bit-equal to the codec on the
    CPU, each residual exactly ``g - dq``, two identical steps shrink each
    leaf's accumulated error (the reference's test), and the per-leaf
    relative error range.  Returns the gradient tree."""
    from repro_torch.distributed import compression as gc
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import registry

    cfg = PLACE_GEMMA2
    api = registry.get_model(cfg.name, cfg)
    batch = on(dev, lm_batch(cfg, GEMMA2_TRAIN_BATCH, GEMMA2_TRAIN_SEQ,
                             seed, 0))
    loss, grads = loss_and_grads(api, params, batch)
    grads = tree_unflatten(params, iter(grads))
    t0 = time.perf_counter()
    comp, res = gc.compress_grads(grads, gc.init_error_feedback(grads))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    paths = [p for p, _ in tree_leaves_with_path(grads)]
    g_by = dict(tree_leaves_with_path(grads))
    c_by = {p: c for p, c in zip(paths, tree_leaves(
        comp, is_leaf=lambda x: isinstance(x, dict) and set(x) == {
            "q", "scale"}), strict=True)}
    for p in CODEC_LEAVES:
        g = g_by[p].cpu()
        c_cpu, _ = gc.compress_grads([g], gc.init_error_feedback([g]))
        q, s = c_by[p]["q"].cpu(), c_by[p]["scale"].cpu()
        if not (torch.equal(q, c_cpu[0]["q"])
                and torch.equal(s, c_cpu[0]["scale"])):
            raise AssertionError(f"codec of {p}: card and CPU differ")
    back = gc.decompress_grads(comp)
    rels = {}
    for p, r, b in zip(paths, tree_leaves(res), tree_leaves(back),
                       strict=True):
        g = g_by[p].to(torch.float32)
        if not torch.equal(r, g - b):
            raise AssertionError(f"residual of {p} is not g - dq")
        rels[p] = (torch.linalg.norm(b - g) / torch.linalg.norm(g)).item()
    del back
    comp2, res2 = gc.compress_grads(grads, res)
    shrink = {}
    for p, c1, c2 in zip(paths, tree_leaves(comp, is_leaf=lambda x: isinstance(
            x, dict) and set(x) == {"q", "scale"}), tree_leaves(
            comp2, is_leaf=lambda x: isinstance(x, dict) and set(x) == {
                "q", "scale"}), strict=True):
        g = g_by[p].to(torch.float32)
        total = gc.dequantize_leaf(c1["q"], c1["scale"]) + \
            gc.dequantize_leaf(c2["q"], c2["scale"])
        shrink[p] = (torch.linalg.norm(total - 2 * g)
                     / torch.linalg.norm(2 * g)).item()
        if not (shrink[p] < rels[p] or shrink[p] == rels[p] == 0.0):
            raise AssertionError(f"error feedback on {p}: {shrink[p]} after "
                                 f"two steps, {rels[p]} after one")
    n_res = sum(t.numel() * t.element_size() for t in tree_leaves(res))
    n_q = sum(c["q"].numel() for c in c_by.values())
    worst = max(rels, key=rels.get)
    print(f"distributed: compress_grads over {cfg.name}'s gradient of "
          f"{GEMMA2_TRAIN_BATCH} x {GEMMA2_TRAIN_SEQ} tokens (loss "
          f"{loss.item()!r}): {n_q!r} B int8, {n_res!r} B float32 residual, "
          f"{t_comp!r} s; {', '.join(CODEC_LEAVES)} q and scale bit-equal "
          f"to the CPU's; every residual exactly g - dq; per-leaf relative "
          f"error {min(rels.values())!r} to {rels[worst]!r} ({worst}; "
          f"{sum(v > 0.02 for v in rels.values())} of {len(rels)} leaves "
          f"above the reference test's 0.02), after two steps "
          f"{min(shrink.values())!r} to {max(shrink.values())!r}, smaller on "
          f"every leaf, on {smi}")
    for p in paths:
        print(f"distributed: codec {p}: relative error {rels[p]!r}, two "
              f"steps {shrink[p]!r}")
    return grads


def check_psum(grads, dev, smi: str) -> None:
    """Phase 10d: ``compressed_psum`` over the embedding gradient on a
    one-rank ``PSUM_BACKEND`` process group (a ``HashStore``: no network),
    bit-equal to the leaf's own codec round trip; the group destroyed."""
    import torch.distributed as dist

    from repro_torch.distributed import compression as gc

    x = grads["embed"]["tok"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(PSUM_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        got = gc.compressed_psum(x)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want = gc.dequantize_leaf(*gc.quantize_leaf(x))
        if not torch.equal(got, want):
            raise AssertionError("compressed_psum at world size 1 differs "
                                 "from the codec's round trip")
    finally:
        dist.destroy_process_group()
    print(f"distributed: compressed_psum of {tuple(x.shape)} {x.dtype} "
          f"over a {PSUM_BACKEND} group of world size 1: bit-equal to "
          f"dequantize_leaf(*quantize_leaf(x)); {secs!r} s; group "
          f"destroyed, on {smi}")


def check_distributed(seed: int, dev, smi: str, tmp: Path) -> None:
    """Phase 10: the distributed layer (``distributed/sharding.py``,
    ``training/optimizer.py`` ``state_specs``, ``launch/mesh.py``,
    ``runtime/elastic.py``, ``distributed/compression.py``,
    ``launch/train.py``'s placement); plain PyTorch, no kernel launched."""
    t0 = time.perf_counter()
    print(f"phase 10 on {smi}")
    set_counts(0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    check_specs(smi)
    t_a = time.perf_counter() - t0
    params = check_placement(seed, dev, smi, tmp)
    grads = check_codec(params, seed, dev, smi)
    del params
    check_psum(grads, dev, smi)
    del grads
    expect_launches("phase 10", dev, {})
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t0!r} s (10a {t_a!r} s), peak "
          f"memory {peak!r} B (max_memory_allocated); no kernel launched, "
          f"on {smi}")


# --------------------------------------------------- the dry run (phase 11)

# phase 11a: launch/dryrun.py for every cell at --mesh both and
# launch/rsnn_cells.py --both, as child processes on the CPU (no GPU, one
# torch thread, no JAX), started before phase 1 and joined here.
# xlstm-350m's two long cells step the sLSTM a token at a time in the
# trace: each gets a lane of its own; a third lane runs the other 38 cells
# in one child, then the RSNN cells in another.  Each lane runs on a core
# of its own, phases 1-10 on the others (``DryRunLanes``).
DRYRUN_ALONE = (("xlstm-350m", "prefill_32k"), ("xlstm-350m", "train_4k"))
# the child: argv[1] a module, argv[2] a JSON list of argument lists,
# argv[3] the cores to run on (JSON, null: any); the module run as
# ``python -m module ARGS`` would run it, once for each, then the check
# that it imported neither JAX nor the JAX package
DRYRUN_CHILD = """
import json, os, runpy, sys
module, runs, cores = sys.argv[1], *map(json.loads, sys.argv[2:4])
if cores:
    os.sched_setaffinity(0, cores)
for args in runs:
    sys.argv[:] = [module, *args]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "repro")]
sys.exit(f"imported {bad}" if bad else 0)
"""
# the timed rows on the CPU: a child of phase 11a's third lane, after its
# dry-run cells (``python -m repro_torch.benchmarks.run`` with these
# arguments), whose CSV lines phase 12 holds the card's rows against
BENCH_CPU = ("repro_torch.benchmarks.run",
             ["--device", "cpu", "--only", "bench_"])
# phase 11b: the dry run's prediction of two cells held against the card,
# each on a (1, 1) mesh: 8a's gemma2-2b train step and the paper's RSNN
# serve step at 65,536 streams
PREDICT_LM = ("gemma2-2b", "phase8a")  # shape: GEMMA2_TRAIN_BATCH x _SEQ
PREDICT_RSNN = ("rsnn_serve", "paper")
PREDICT_STEPS = 7  # timed steps after the counted one; the median is kept
PEAK_BAND = (0.95, 1.10, 64 * 2 ** 20)  # measured within [lo p, hi p + B]
ALLOC_ROUND = 512  # the CUDA caching allocator's rounding of a tensor
ALLOC_SLACK = 2 ** 20  # a large block keeps up to 1 MiB of unsplit slack


def dryrun_lanes(out: Path) -> list[list[tuple[str, list[list[str]]]]]:
    """Phase 11a's lanes, each a list of children run one after the
    other: (module, the argument lists the child runs it with); the third
    ends with phase 12's timed rows on the CPU (``BENCH_CPU``)."""
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models import registry

    def cell(arch, shape):
        return ["--arch", arch, "--shape", shape, "--mesh", "both", "--out",
                str(out / "dryrun_torch")]

    dryrun = "repro_torch.launch.dryrun"
    rest = [cell(a, s.name) for a in registry.list_archs() for s in LM_SHAPES
            if (a, s.name) not in DRYRUN_ALONE]
    return [[(dryrun, [cell(*c)])] for c in DRYRUN_ALONE] + \
        [[(dryrun, rest), ("repro_torch.launch.rsnn_cells", [["--both"]]),
          (BENCH_CPU[0], [BENCH_CPU[1]])]]


def pin_process(cores) -> None:
    """Every thread of this process on ``cores`` (threads it starts later
    inherit the set)."""
    for tid in os.listdir("/proc/self/task"):
        with contextlib.suppress(ProcessLookupError):  # a thread that ended
            os.sched_setaffinity(int(tid), cores)


class DryRunLanes:
    """Phase 11a's children, started at the top of the script and run
    beside phases 1-10: one thread a lane starts its children one after
    the other, each child pinned to the lane's core; this process keeps
    the other cores (and as many ``torch`` threads) until ``release``.
    ``stop`` kills what still runs."""

    def __init__(self, out: Path):
        import threading

        self.out = out
        self.results: list[dict] = []
        self.lane_secs: dict[int, float] = {}
        self.procs: dict[int, subprocess.Popen] = {}
        self.stopped = False
        self.env = dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent / "src"), CUDA_VISIBLE_DEVICES="",
            OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.env.pop("XLA_FLAGS", None)
        lanes = dryrun_lanes(out)
        self.cores = sorted(os.sched_getaffinity(0))
        self.threads_before = torch.get_num_threads()
        # a core a lane, from the last; none if that leaves this process
        # fewer than two
        own = len(self.cores) - len(lanes) >= 2
        self.lane_cores = [{self.cores[-1 - i]} if own else None
                           for i in range(len(lanes))]
        self.t0 = time.perf_counter()
        self.threads = [threading.Thread(target=self._lane,
                                         args=(i, cmds), daemon=True)
                        for i, cmds in enumerate(lanes)]
        for t in self.threads:
            t.start()
        if own:
            keep = self.cores[:len(self.cores) - len(lanes)]
            pin_process(keep)
            torch.set_num_threads(len(keep))

    def _lane(self, lane: int, cmds) -> None:
        t_lane = time.perf_counter()
        cores = self.lane_cores[lane]
        for module, runs in cmds:
            if self.stopped:
                return
            t0 = time.perf_counter()
            p = subprocess.Popen(
                [sys.executable, "-c", DRYRUN_CHILD, module,
                 json.dumps(runs), json.dumps(cores and sorted(cores))],
                cwd=self.out, env=self.env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            self.procs[lane] = p
            out, _ = p.communicate()
            self.results.append({
                "lane": lane, "module": module, "cells": len(runs),
                "argv": runs[0], "rc": p.returncode,
                "secs": time.perf_counter() - t0, "out": out})
        self.lane_secs[lane] = time.perf_counter() - t_lane

    def join(self) -> list[dict]:
        for t in self.threads:
            t.join()
        return self.results

    def release(self) -> None:
        """This process back on every core it had, at its thread count."""
        pin_process(set(self.cores))
        torch.set_num_threads(self.threads_before)

    def stop(self) -> None:
        self.stopped = True
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def roofline_terms(rec: dict) -> str:
    """A record's roofline row at the H100's rates
    (``benchmarks/roofline.py``); an RSNN cell has no ``model_flops``, so
    its compute and memory terms only."""
    from repro_torch.benchmarks import roofline

    t = rec["tripaware"]
    if rec["arch"] == "rsnn-timit":
        return (f"compute {t['flops'] / roofline.PEAK_FLOPS!r} s, memory "
                f"{t['hbm_bytes'] / roofline.HBM_BW!r} s, collective —")
    r = roofline.roofline_row(rec)
    return (f"compute {r['compute_s']!r} s, memory {r['memory_s']!r} s, "
            f"collective —, dominant {r['dominant']}, MODEL/FLOPs "
            f"{r['useful_fraction']!r}, roofline fraction "
            f"{r['roofline_fraction']!r}")


def check_dryrun(lanes: DryRunLanes, smi: str) -> None:
    """Phase 11a: join the children; every child exited 0 (its import
    check included), every runnable LM cell wrote an ``ok`` record at both
    meshes, every other cell is ``cell_is_runnable``'s skip and wrote
    none, and the twenty RSNN records are ``ok``; each cell's trace
    seconds, per-device argument bytes against the card's 80 GB and
    roofline row printed."""
    from repro_torch.benchmarks import report
    from repro_torch.configs.base import LM_SHAPES, cell_is_runnable
    from repro_torch.launch.rsnn_cells import RSNN_VARIANTS
    from repro_torch.models import registry

    t_wait = time.perf_counter()
    results = [r for r in lanes.join() if r["module"] != BENCH_CPU[0]]
    waited = time.perf_counter() - t_wait
    lanes.release()
    for r in results:
        print(f"dryrun child (lane {r['lane']}, core "
              f"{lanes.lane_cores[r['lane']]}): {r['module']} "
              f"{' '.join(r['argv'])}" + (f" and {r['cells'] - 1} more"
                                          if r["cells"] > 1 else "")
              + f": exit {r['rc']}, {r['secs']!r} s")
    for lane, secs in sorted(lanes.lane_secs.items()):
        print(f"dryrun lane {lane}: {secs!r} s")
    failed = [r for r in results if r["rc"] != 0]
    if failed:
        raise AssertionError("dry-run children failed: " + "; ".join(
            f"{r['module']} {' '.join(r['argv'])}: exit {r['rc']}: "
            f"{r['out'][-2000:]}" for r in failed))
    stdout = "".join(r["out"] for r in results)
    recs, n_ok, n_skip = {}, 0, 0
    for arch in registry.list_archs():
        for shape in LM_SHAPES:
            runnable, why = cell_is_runnable(arch, shape)
            for mesh in ("pod", "multipod"):
                tag = f"{arch}__{shape.name}__{mesh}"
                path = lanes.out / "dryrun_torch" / f"{tag}.json"
                if not runnable:
                    if path.exists() or f"{tag}: SKIP {why[:40]}" \
                            not in stdout:
                        raise AssertionError(f"{tag}: not skipped as "
                                             f"cell_is_runnable says")
                    n_skip += 1
                    continue
                rec = json.loads(path.read_text())
                if not rec.get("ok") or rec.get("error"):
                    raise AssertionError(f"{tag}: {rec.get('error')}")
                recs[tag] = rec
                n_ok += 1
    for kind in ("rsnn_train", "rsnn_serve"):
        for variant in RSNN_VARIANTS:
            for mesh in ("pod", "multipod"):
                tag = f"rsnn-timit__{kind}__{mesh}__{variant}"
                rec = json.loads((lanes.out / "results" / "hillclimb_torch"
                                  / f"{tag}.json").read_text())
                if not rec.get("ok"):
                    raise AssertionError(f"{tag}: {rec.get('error')}")
                recs[tag] = rec
    for tag, rec in recs.items():
        ma = rec["memory_analysis"]
        arg = ma["argument_size_in_bytes"]
        print(f"dryrun {tag}: trace {rec['lower_s']!r} s, "
              f"{rec['num_devices']} devices, arguments {arg!r} B a device "
              f"({arg / H100_MEMORY_BYTES!r} of 80 GB), temp "
              f"{ma['temp_size_in_bytes']!r} B, FLOPs "
              f"{rec['tripaware']['flops']!r} a device, "
              f"{roofline_terms(rec)}")
    report.BASE = lanes.out  # the tables of benchmarks/report.py
    report.main()
    print(f"phase 11a: {n_ok} LM records ok ({n_ok // 2} cells x 2 meshes), "
          f"{n_skip // 2} cells skipped as cell_is_runnable says, "
          f"{len(recs) - n_ok} RSNN records ok; {len(results)} children, "
          f"all exit 0, none imported JAX or the JAX package; "
          f"{time.perf_counter() - lanes.t0!r} s since their start, "
          f"{waited!r} s of it waited for here, on {smi}")


def predict_cell(name: str, specs, dev, smi: str) -> None:
    """Phase 11b for one cell: ``specs(mesh)`` is the dry run's
    ``input_specs`` on a (1, 1) mesh.  The meta trace's counts against
    the same counter around the step on ``dev``; the predicted argument
    bytes against ``memory_allocated``; arguments + temp against
    ``max_memory_allocated`` over a step; the measured step (CUDA events,
    median) against the roofline's larger term."""
    from repro_torch.benchmarks import roofline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    step, args, _, sh = specs(make_mesh((1, 1), ("data", "model"),
                                        ["meta"]))
    _, meta, secs = dryrun.trace(step, args)
    del step, args
    leaves = tree_leaves(sh)
    arg_bytes = sum(s.block_bytes for s in leaves)
    rounded = sum(-(-s.block_bytes // ALLOC_ROUND) * ALLOC_ROUND
                  for s in leaves)
    n_large = sum(s.block_bytes > ALLOC_SLACK for s in leaves)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
    step, args, _, _ = specs(make_mesh((1, 1), ("data", "model"), [dev]))
    if cuda:
        torch.cuda.synchronize()
        built = torch.cuda.memory_allocated(dev) - base
        if not rounded <= built <= rounded + n_large * ALLOC_SLACK:
            raise AssertionError(
                f"{name}: memory_allocated rose {built} B for predicted "
                f"arguments of {arg_bytes} B ({rounded} B rounded to "
                f"{ALLOC_ROUND} B a tensor, {n_large} tensors over 1 MiB)")
        torch.cuda.reset_peak_memory_stats(dev)
    out, card, _ = dryrun.trace(step, args)
    del out
    diff = {op: (meta.by_op.get(op), card.by_op.get(op))
            for op in sorted(set(meta.by_op) | set(card.by_op))
            if meta.by_op.get(op) != card.by_op.get(op)}
    same = meta.flops == card.flops and meta.hbm_bytes == card.hbm_bytes
    print(f"predict {name}: meta trace {secs!r} s, {meta.ops} ops: FLOPs "
          f"{meta.flops!r}, bytes {meta.hbm_bytes!r}, peak {meta.peak_bytes!r}"
          f" B; on {dev}: FLOPs {card.flops!r}, bytes {card.hbm_bytes!r}, "
          f"peak {card.peak_bytes!r} B, {card.ops} ops: "
          + ("equal" if same else "differ, by op (calls, FLOPs, bytes) "
             "meta / card: " + "; ".join(f"{op} {a} / {b}" for op, (a, b)
                                        in diff.items())))
    if not same and not diff:
        raise AssertionError(f"{name}: counts differ with no op named")
    ms = []
    for i in range(PREDICT_STEPS + 1):
        if cuda:
            torch.cuda.synchronize()
            if i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        out = step(*args)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            if i == 1:
                peak = torch.cuda.max_memory_allocated(dev) - base
        else:
            ms.append((time.perf_counter() - t0) * 1e3)
        del out
    med = statistics.median(ms[1:])
    compute_s = meta.flops / roofline.PEAK_FLOPS
    memory_s = meta.hbm_bytes / roofline.HBM_BW
    bound_s = max(compute_s, memory_s)
    line = (f"predict {name}: arguments {arg_bytes!r} B predicted "
            f"({rounded!r} B rounded)")
    if cuda:
        predicted = rounded + meta.peak_bytes
        lo, hi, extra = PEAK_BAND
        line += (f", memory_allocated +{built!r} B; peak predicted "
                 f"{predicted!r} B (arguments + temp), measured {peak!r} B "
                 f"(max_memory_allocated over a step), "
                 f"{peak / predicted!r} of it, band [{lo}, {hi}] + "
                 f"{extra} B")
        if not lo * predicted <= peak <= hi * predicted + extra:
            raise AssertionError(line)
    print(line + f"; step {med!r} ms (median of {PREDICT_STEPS} after the "
          f"first: {ms!r}), roofline max(compute {compute_s!r} s, memory "
          f"{memory_s!r} s) = {bound_s!r} s, {bound_s * 1e3 / med!r} of the "
          f"step, on {smi}")
    del step, args
    if cuda:
        torch.cuda.empty_cache()


def check_prediction(dev, smi: str) -> None:
    """Phase 11b: ``PREDICT_LM`` (8a's gemma2-2b step) and
    ``PREDICT_RSNN`` (the paper's serve step at 65,536 streams)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, rsnn_cells

    arch, shape = PREDICT_LM
    lm_shape = ShapeConfig(shape, GEMMA2_TRAIN_SEQ, GEMMA2_TRAIN_BATCH,
                           "train")
    predict_cell(f"{arch} {shape} ({GEMMA2_TRAIN_BATCH} x "
                 f"{GEMMA2_TRAIN_SEQ} train, donated)",
                 lambda mesh: dryrun.input_specs(arch, lm_shape, mesh), dev,
                 smi)
    kind, variant = PREDICT_RSNN
    predict_cell(f"rsnn-timit {kind} {variant} "
                 f"({rsnn_cells.SERVE_BATCH} streams)",
                 lambda mesh: rsnn_cells.input_specs(kind, variant, mesh),
                 dev, smi)


def check_dry_run(lanes: DryRunLanes, dev, smi: str) -> None:
    """Phase 11: the dry run (11a) and its prediction against the card
    (11b); plain PyTorch, no kernel launched."""
    t0 = time.perf_counter()
    print(f"phase 11 on {smi}")
    set_counts(0)
    check_dryrun(lanes, smi)
    t_a = time.perf_counter() - t0
    check_prediction(dev, smi)
    expect_launches("phase 11", dev, {})
    print(f"phase 11: {time.perf_counter() - t0!r} s (11a {t_a!r} s); no "
          f"kernel launched, on {smi}")


# ------------------------------------------------------------- phase 12

# the kernels each timed row of ``benchmarks/run.py`` launches on the card
# (every other entry launches none)
BENCH_LAUNCHES = {
    "bench_merged_spike_fc": ("merged_spike_fc",),
    "bench_sparse_fc": ("sparse_fc",),
    "bench_nm_fc": ("sparse_fc", "nm_fc"),
    "bench_stream_engine": ("sparse_fc",),
    "bench_megastep": ("rsnn_cell", "int4_matmul", "sparse_fc", "megastep"),
    "bench_delta": ("delta_step", "spike_cell"),
    "bench_spike_broadcast": ("spike_cell", "spike_broadcast", "sparse_fc",
                              "megastep", "megastep_spike"),
}
# the fields of a timed row that do not depend on where it ran (sizes,
# counts, the input's densities, the bit-identities the rows raise on)
BENCH_FIELDS = {
    "bench_sparse_fc": ("sparsity_profile",),
    "bench_nm_fc": ("nnz", "nm_group_bytes", "padded_csc_bytes",
                    "bytes_saved_vs_csc", "bit_identical_to_csc"),
    "bench_stream_sharded": ("devices", "slots", "frames"),
    "bench_stream_pipeline": ("workload", "sync_host_syncs_per_frame",
                              "pipelined_host_syncs_per_frame",
                              "host_syncs_saved_per_frame",
                              "pipelined_dispatches_per_frame",
                              "chunked_dispatches_per_frame"),
    "bench_artifact_roundtrip": ("bit_identical_vs_in_memory", "disk_bytes",
                                 "broadcast_total_bytes", "schema_version"),
    "bench_spike_broadcast": ("analytic_density",
                              "accumulates_per_frame_analytic"),
}
# the rows of the reduced model (H = 64) whose launches 12b holds
BENCH_REDUCED = ("bench_megastep", "bench_delta", "bench_spike_broadcast")


def bench_fields(name: str, derived: dict) -> dict:
    """A timed row's fields that must be the same on the card and on the
    CPU (``BENCH_FIELDS``; the op-table dispatches a frame of
    ``bench_megastep``; the delta input density at each threshold of
    ``bench_delta``)."""
    if name == "bench_megastep":
        return {b: derived[b]["dispatches_per_frame"]
                for b in ("jnp", "pallas", "fused")}
    if name == "bench_delta":
        return {t: v["delta_input_density"]
                for t, v in derived["thresholds"].items()}
    return {k: derived[k] for k in BENCH_FIELDS.get(name, ())}


def csv_rows(text: str) -> dict[str, tuple[float, dict]]:
    """The CSV lines of ``benchmarks/run.py`` in ``text`` (other lines,
    such as a child's warnings, are passed over): name -> (us,
    derived)."""
    from repro_torch.benchmarks import run

    rows = {}
    for line in text.splitlines():
        name, _, rest = line.partition(",")
        if name in run.all_names():
            us, derived = rest.split(",", 1)
            rows[name] = (float(us), json.loads(derived))
    return rows


class HeldLaunches:
    """While entered, each call of a kernel wrapper (K1, K2, K4, K6/K7,
    K8, K9, K10) runs the kernel, then its plain version on the same
    inputs, and holds the two by phase 2's rules (``check_call``; K6/K7
    by ``megastep_replay`` and ``check_mega``).  ``held`` counts the
    calls held a kernel; ``errs`` keeps each one's largest |kernel -
    plain|."""

    def __init__(self):
        from repro_torch.kernels import (delta_step, int4_matmul, megastep,
                                         ref, rsnn_cell, sparse_fc,
                                         spike_broadcast)

        self.targets = {
            "rsnn_cell": (rsnn_cell, "rsnn_cell", ref.rsnn_cell_ref),
            "int4_matmul": (int4_matmul, "int4_matmul", ref.int4_matmul_ref),
            "sparse_fc": (sparse_fc, "sparse_fc", ref.sparse_fc_ref),
            "delta_step": (delta_step, "delta_step", ref.delta_step_ref),
            "spike_broadcast": (spike_broadcast, "spike_broadcast",
                                ref.spike_broadcast_ref),
            "spike_cell": (spike_broadcast, "spike_cell",
                           ref.spike_cell_ref),
            "megastep": (megastep, "megastep", ref.megastep_ref)}
        self.held: dict[str, int] = {}
        self.errs: dict[str, float] = {}
        self.saved = {}

    def _wrap(self, name: str, kernel, plain):
        def held(*args, **kw):
            got = kernel(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            if name == "megastep":
                row = "megastep_spike" if kw.get("spike") else "megastep"
                fc_mode = kw["fc_mode"]
                e = max(check_mega(f"12b {row} fc_mode={fc_mode}", got,
                                   want, megastep_replay(args)).values())
            else:
                row = name
                e = check_call(name, got, want, args, kw.get("capacity"))
            self.held[row] = self.held.get(row, 0) + 1
            self.errs[row] = max(self.errs.get(row, 0.0), e)
            return got

        return held

    def __enter__(self):
        for name, (module, attr, plain) in self.targets.items():
            self.saved[name] = getattr(module, attr)
            setattr(module, attr, self._wrap(name, self.saved[name], plain))
        return self

    def __exit__(self, *exc):
        for name, (module, attr, _) in self.targets.items():
            setattr(module, attr, self.saved[name])


def check_bench_rows(lanes: DryRunLanes, dev, smi: str) -> None:
    """Phase 12: ``benchmarks/run.py`` on the card, an entry at a time
    (``run.main(name)``, every launch counter set to 0 before it), each
    row printed.  (a) Each entry launches exactly the kernels
    ``BENCH_LAUNCHES`` names; the deterministic fields of each timed row
    (``bench_fields``) equal those of the same row run on the CPU on the
    same CPU-drawn weights (the ``BENCH_CPU`` child); ``roofline_summary``
    reads phase 11's records (``roofline.RESULTS`` pointed there) and
    counts one cell an ``ok`` single-pod record.  (b) The three rows of
    the reduced model again, their loops eager, every launch of K1, K2,
    K4, K6/K7, K8, K9 and K10 at H = 64 held against its plain version
    (``HeldLaunches``)."""
    from repro_torch.benchmarks import paper_tables, roofline, run

    t0 = time.perf_counter()
    print(f"phase 12 on {smi}")
    child = [r for r in lanes.results if r["module"] == BENCH_CPU[0]]
    if len(child) != 1 or child[0]["rc"] != 0:
        raise AssertionError(f"12: the CPU rows' child: {child}")
    cpu = csv_rows(child[0]["out"])
    print(f"12: the CPU rows (child, lane {child[0]['lane']}): "
          f"{child[0]['secs']!r} s")
    roofline.RESULTS = lanes.out / "dryrun_torch"
    pod = len(list(roofline.RESULTS.glob("*__pod.json")))
    timed = dict(run.TIMED)
    for name in run.all_names():
        set_counts(0)
        out = io.StringIO()
        t_row = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if run.main(name, dev) != 1:
                raise AssertionError(f"12 {name}: not one entry")
        secs = time.perf_counter() - t_row
        (us, derived), = csv_rows(out.getvalue()).values()
        print(out.getvalue().splitlines()[1])
        launched = {n: c for n, c in read_counts().items() if c}
        if set(launched) != set(BENCH_LAUNCHES.get(name, ())):
            raise AssertionError(f"12 {name}: launched {launched}, want "
                                 f"{BENCH_LAUNCHES.get(name, ())}")
        note = ""
        if name in timed:
            got = bench_fields(name, derived)
            want = bench_fields(name, cpu[name][1])
            if got != want:
                raise AssertionError(f"12 {name}: card {got}, CPU {want}")
            note = (f"; {list(got) or 'no fields'} equal to the CPU's "
                    f"({cpu[name][0]!r} us there)")
        if name == "roofline_summary" and (
                derived.get("cells") != pod or derived.get("ok") != pod):
            raise AssertionError(f"12 roofline_summary: {derived}, want "
                                 f"{pod} cells, all ok")
        print(f"12 {name}: {secs!r} s, {us!r} us, launches {launched}"
              f"{note}")
    set_counts(0)
    t_b = time.perf_counter()
    graph_loop = paper_tables.StreamLoop
    # eager loops: every launch a Python call that can be held
    paper_tables.StreamLoop = functools.partial(graph_loop, aot_warmup=False)
    try:
        with HeldLaunches() as held:
            for row in BENCH_REDUCED:
                getattr(paper_tables, row)(dev)
    finally:
        paper_tables.StreamLoop = graph_loop
    launched = {n: c for n, c in read_counts().items() if c}
    if held.held != launched:
        raise AssertionError(f"12b: held {held.held}, launched {launched}")
    print(f"12b: {BENCH_REDUCED} with eager loops, every launch at H = 64 "
          f"held against its plain version: {held.held}, largest "
          f"|kernel - plain| {held.errs} (away from the threshold for "
          f"K1, K10 and K6/K7); {time.perf_counter() - t_b!r} s")
    print(f"phase 12: {time.perf_counter() - t0!r} s, on {smi}")


# Phase 13: the load generator's sweep at PRUNED's width, every backend of
# the reference's sweep over both layouts of the 2:4 FC
LOADGEN_CFG = RSNNConfig(hidden_dim=128, fc_dim=1920)
LOADGEN_LAYOUTS = ("csc", "nm")
LOADGEN_BACKENDS = ("jnp", "pallas", "fused", "delta", "spike")
LOADGEN_DEPTHS = (0, 2)
LOADGEN_CHUNKS = (1, MEGA_FRAMES)
LOADGEN_STREAMS = (512, 12, 48)  # streams, their fewest and most frames
LOADGEN_SAT_ITERS = 2
# closed-loop repetitions a cell (the fastest kept): 2, not run_cell's 3,
# to hold the phase near 150 s on a slow host (159.6 s at 3); the
# saturation search never bisects here (512 streams cannot pass the
# backlog bound of 512), so LOADGEN_SAT_ITERS costs nothing
LOADGEN_REPS = 2
# launches of each kernel a frame (the mega-step's: a dispatch), by
# (backend, layout): ``sparse_fc`` routes the FC to K4 or K5
LOADGEN_LAUNCHES = {
    **{("jnp", lay): {} for lay in LOADGEN_LAYOUTS},
    **{("fused", lay): {"megastep": 1} for lay in LOADGEN_LAYOUTS},
    **{("delta", lay): {"spike_cell": 2, "delta_step": 1}
       for lay in LOADGEN_LAYOUTS},
    ("pallas", "csc"): {"rsnn_cell": 2, "int4_matmul": 2, "sparse_fc": 1},
    ("pallas", "nm"): {"rsnn_cell": 2, "int4_matmul": 2, "nm_fc": 1},
    ("spike", "csc"): {"spike_cell": 2, "spike_broadcast": 1,
                       "sparse_fc": 1},
    ("spike", "nm"): {"spike_cell": 2, "spike_broadcast": 1, "nm_fc": 1},
}


def loadgen_workload():
    from repro_torch.benchmarks import loadgen

    streams, lo, hi = LOADGEN_STREAMS
    return loadgen.Workload(seed=0, num_streams=streams, min_frames=lo,
                            max_frames=hi)


def loadgen_sweep(dev, smi: str) -> dict:
    """13a-b: ``loadgen.run_sweep`` over every cell on ``dev`` at
    ``SLOTS`` slots, the document written to ``results/loadgen_torch/`` and
    validated by the port's ``trajectory``; each cell's kernels (every
    counter set to 0 before ``run_cell``, read after it: warm-up, the
    closed and open runs and the saturation probes, each step a graph
    replay that credits its launches) exactly ``LOADGEN_LAUNCHES``'."""
    from repro_torch.benchmarks import loadgen, trajectory

    launched = []
    cell = loadgen.run_cell

    def counted(engine, layout, backend, *args, **kw):
        set_counts(0)
        out = cell(engine, layout, backend, *args, **kw)
        got = {n: c for n, c in read_counts().items() if c}
        want = LOADGEN_LAUNCHES[backend, layout]
        if set(got) != set(want):
            raise AssertionError(f"13b {out['key']}: launched {got}, want "
                                 f"{sorted(want)}")
        launched.append((out["key"], got))
        return out

    loadgen.run_cell = counted
    try:
        doc = loadgen.run_sweep(
            LOADGEN_CFG, [SLOTS], LOADGEN_DEPTHS, LOADGEN_LAYOUTS, [1],
            loadgen_workload(), LOADGEN_SAT_ITERS, backends=LOADGEN_BACKENDS,
            chunks=LOADGEN_CHUNKS, device=dev, latency_reps=LOADGEN_REPS)
    finally:
        loadgen.run_cell = cell
    out = trajectory.RESULTS / f"BENCH_{loadgen.BENCH_INDEX}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")
    doc = trajectory.load_doc(out)  # raises on a schema error
    want = (len(LOADGEN_LAYOUTS) * len(LOADGEN_BACKENDS)
            * len(LOADGEN_DEPTHS) * len(LOADGEN_CHUNKS))
    if len(doc["cells"]) != want:
        raise AssertionError(f"13a: {len(doc['cells'])} cells, want {want}")
    print(f"13a: {len(doc['cells'])} cells written to {out} and validated; "
          f"machine {doc['machine']}")
    for c, (key, got) in zip(doc["cells"], launched):
        f = c["frame_latency_us"]
        print(f"13a {key}: frame p50/p95/p99 {f['p50']!r}/{f['p95']!r}/"
              f"{f['p99']!r} us, {c['throughput_frames_per_s']!r} frames/s, "
              f"service {c['service_streams_per_s']!r} / saturation "
              f"{c['saturation_streams_per_s']!r} streams/s, dispatches "
              f"{c['dispatches_per_frame']!r} / host syncs "
              f"{c['host_syncs_per_frame']!r} a frame, "
              f"{c['measured_mmac_per_s']!r} MMAC/s; open-loop completion "
              f"p50/p99 {c['stream_completion_ms']['p50']!r}/"
              f"{c['stream_completion_ms']['p99']!r} ms; launches {got}")
    return doc


def loadgen_logits(dev) -> dict:
    """13c: each (layout, backend) engine serves the closed-loop workload
    once more through ``build_loop`` + ``run_workload`` in every (depth,
    chunk) loop: each kernel's launches exactly dispatches x (1 for the
    mega-step, else the chunk's frames) x its launches a frame, and the
    per-stream logits bit-equal across the loops.  Returns the logits of
    each (layout, backend)."""
    from repro_torch.benchmarks import loadgen

    wl = loadgen_workload()
    logits = {}
    for layout in LOADGEN_LAYOUTS:
        for backend in LOADGEN_BACKENDS:
            engine = loadgen.build_engine(LOADGEN_CFG, layout,
                                          backend=backend, device=dev)
            per_frame = LOADGEN_LAUNCHES[backend, layout]
            runs = {}
            for depth in LOADGEN_DEPTHS:
                for chunk in LOADGEN_CHUNKS:
                    loop = loadgen.build_loop(engine, SLOTS, depth, 1,
                                              wl.max_frames, chunk)
                    set_counts(0)
                    res = loadgen.run_workload(loop, wl)
                    a_dispatch = 1 if backend == "fused" else chunk
                    got = {n: c for n, c in read_counts().items() if c}
                    want = {n: loop.dispatches * a_dispatch * k
                            for n, k in per_frame.items()}
                    if got != want:
                        raise AssertionError(
                            f"13c {layout} {backend} depth {depth} chunk "
                            f"{chunk}: launched {got}, want {want}")
                    done = sorted(loop.finished, key=lambda r: r.sid)
                    if res.streams != wl.num_streams or loop.pending_steps:
                        raise AssertionError(f"13c {layout} {backend}: "
                                             f"{res.streams} streams done, "
                                             f"{loop.pending_steps} steps "
                                             f"in flight")
                    runs[depth, chunk] = [r.stacked_logits() for r in done]
            first, *rest = runs.values()
            for key, lg in runs.items():
                if not all(np.array_equal(a, b) for a, b in zip(lg, first)):
                    raise AssertionError(f"13c {layout} {backend}: loop "
                                         f"{key} logits differ")
            logits[layout, backend] = first
    for backend in LOADGEN_BACKENDS:
        csc, nm = (logits[lay, backend] for lay in LOADGEN_LAYOUTS)
        if not all(np.array_equal(a, b) for a, b in zip(csc, nm)):
            raise AssertionError(f"13c {backend}: csc and nm logits differ")
    loops = len(LOADGEN_DEPTHS) * len(LOADGEN_CHUNKS)
    print(f"13c: logits bit-equal over the {loops} loops (depth x chunk) of "
          f"every backend and layout, and between csc and nm within every "
          f"backend; launches dispatches x a dispatch's in every loop")
    return logits


def check_loadgen(dev, smi: str) -> None:
    """Phase 13: ``repro_torch/benchmarks/loadgen.py`` on the card
    (``loadgen_sweep``, ``loadgen_logits``), then each backend's logits
    against ``jnp``'s over the same workload (largest |d logit| and
    argmax agreement, printed, not asserted: only ``jnp`` runs no
    kernel)."""
    t0 = time.perf_counter()
    print(f"phase 13 on {smi}")
    loadgen_sweep(dev, smi)
    t_c = time.perf_counter()
    print(f"13a-b: {t_c - t0!r} s")
    logits = loadgen_logits(dev)
    print(f"13c: {time.perf_counter() - t_c!r} s")
    for backend in LOADGEN_BACKENDS[1:]:
        got = np.concatenate(logits["csc", backend])
        base = np.concatenate(logits["csc", "jnp"])
        print(f"13c {backend} against jnp on {dev} over "
              f"{len(got)} frames: max |d logit| "
              f"{float(np.abs(got - base).max())!r}, argmax agreement "
              f"{float(np.mean(got.argmax(1) == base.argmax(1)))!r}")
    print(f"phase 13: {time.perf_counter() - t0!r} s, on {smi}")


# ------------------------------------ the sharded LM train step (phase 14)

# phase 14a: 8a's gemma2-2b step (published widths, bf16, remat "full",
# AdamW) on a (1, 1) mesh of ranks over one NCCL rank (a HashStore group):
# SPMD_STEPS steps plain, then sharded (DTensor leaves) through
# make_train_step, from the same seeded init; then the same at
# SPMD_TRAINER_LAYERS layers, plain and sharded through the Trainer
SPMD_GEMMA2 = TRAIN_GEMMA2
SPMD_STEPS = 2
SPMD_BACKEND = "nccl"
# the Trainer's run cut in depth to SPMD_TRAINER_LAYERS (published widths):
# its final checkpoint gathers every leaf to the host and writes it, 26 GB
# and ~50 s at full depth
SPMD_TRAINER_LAYERS = 2
# phase 14b: one CPU child of SPMD_RANKS gloo ranks, the reduced archs
# SPMD_CHILD_ARCHS each on a (2, 2) mesh of ranks: SPMD_STEPS sharded AdamW
# steps against the one-device step (losses and grad norms within
# SPMD_LOSS_TOL, parameters within SPMD_PARAM_TOL x lr: an AdamW step
# divides each gradient element by its running magnitude, so an element
# whose gradient is near zero moves by up to lr whatever its rounding)
SPMD_RANKS, SPMD_MESH = 4, (2, 2)
SPMD_CHILD_ARCHS = ("deepseek-v3-671b", "xlstm-350m", "zamba2-7b")
SPMD_LOSS_TOL, SPMD_PARAM_TOL, SPMD_LR = 1e-5, 0.1, 3e-4
SPMD_CHILD_TIMEOUT = 600
# one rank of the child: argv[1] the rank, argv[2] the FileStore's path,
# argv[3] a JSON [archs, mesh shape, steps, lr, loss tol, param tol],
# argv[4] the cores to run on (JSON, null: any); rank
# 0 prints one JSON line of results; every rank exits non-zero if it
# imported JAX or the JAX package
SPMD_CHILD = r'''
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist

import os
rank, store = int(sys.argv[1]), sys.argv[2]
archs, shape, steps, lr, loss_tol, param_tol = json.loads(sys.argv[3])
if json.loads(sys.argv[4]) is not None:
    os.sched_setaffinity(0, json.loads(sys.argv[4]))
world = int(np.prod(shape))
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import registry
from repro_torch.runtime.elastic import reshard_state
from repro_torch.training import optimizer as opt_lib

mesh = make_rank_mesh(tuple(shape), ("data", "model"), "cpu")
shd.set_activation_axes(mesh)


def gathered(arch, batch):
    """The most bytes of gathered layers alive at once (at each gather)
    in one sharded loss_and_grads with remat "full" and with none, and
    one gathered layer's bytes (the groups leaves split on their inner
    layer axis)."""
    import dataclasses
    from torch.distributed.tensor import Shard
    from repro_torch.core import tree
    from repro_torch.core.tree import tree_leaves_with_path
    real, res = tree._gather_layer, {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(registry.reduce_config(
            registry.get_model(arch).cfg), remat=remat)
        api = registry.get_model(arch, cfg)
        (placed,) = reshard_state(api.init(torch.Generator().manual_seed(0),
                                           device="cpu"), mesh)
        held, most = [], [0]

        def tracked(t, i):
            got = real(t, i)
            held.append(got.to_local().untyped_storage())
            most[0] = max(most[0], sum(
                s.nbytes() for s in held
                if torch._C._storage_Use_Count(s._cdata) > 1))
            return got

        tree._gather_layer = tracked
        try:
            steps_lib.loss_and_grads(api, placed, batch)
        finally:
            tree._gather_layer = real
        res[remat] = most[0]
    res["layer"] = sum(
        t.numel() // (t.shape[0] * t.shape[1]) * t.element_size()
        for p, t in tree_leaves_with_path(placed)
        if p.startswith("['groups']") and Shard(1) in t.placements)
    return res


out = {}
for arch in archs:
    cfg = registry.reduce_config(registry.get_model(arch).cfg)
    api = registry.get_model(arch, cfg)
    ocfg = opt_lib.OptimizerConfig(name="adamw", lr=lr, warmup_steps=1,
                                   decay_steps=10)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32))}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(8, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    step = steps_lib.make_train_step(api, ocfg, donate=True)
    runs = {}
    for kind in ("plain", "sharded"):
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        if kind == "sharded":
            pspecs = shd.tree_param_specs(params, mesh)
            ospecs = opt_lib.state_specs(pspecs, params, ocfg)
            (params,) = reshard_state(params, mesh)
        state = {"params": params, "opt": opt_lib.init_opt_state(params,
                                                                  ocfg)}
        t0 = time.perf_counter()
        metrics = []
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[kind] = (state, metrics, time.perf_counter() - t0)
    (plain, pm, tp), (sh, sm, ts) = runs["plain"], runs["sharded"]
    dparam = max(float((a.full_tensor() - b).abs().max()) for a, b in zip(
        tree_leaves(sh["params"]), tree_leaves(plain["params"])))
    got = [shd.placements_spec(t.placements, mesh.axis_names, t.dim())
           for t in tree_leaves(sh)]
    want = tree_leaves({"params": pspecs, "opt": ospecs})
    blocks = shd.with_shardings(sh, {"params": pspecs, "opt": ospecs}, mesh)
    local = sum(t.to_local().nbytes for t in tree_leaves(sh))
    out[arch] = {
        "losses": [l for l, _ in sm], "plain_losses": [l for l, _ in pm],
        "dloss": max(abs(a[0] - b[0]) for a, b in zip(sm, pm)),
        "dgrad_norm": max(abs(a[1] - b[1]) for a, b in zip(sm, pm)),
        "dparam": dparam, "param_bound": param_tol * lr,
        "placed_by_specs": [tuple(a) for a in got] == [tuple(b) for b in want],
        "local_bytes": local,
        "block_bytes": sum(s.block_bytes for s in tree_leaves(blocks)),
        "global_bytes": sum(t.numel() * t.element_size()
                            for t in tree_leaves(sh)),
        "sharded_s": ts, "plain_s": tp}
    if arch == "zamba2-7b":
        out[arch]["gathered"] = gathered(arch, batch)
dist.destroy_process_group()
bad = [m for m in sys.modules if m in ("jax", "repro")
       or m.startswith(("jax.", "repro."))]
if rank == 0:
    print(json.dumps(out))
sys.exit(3 if bad else 0)
'''


class SpmdRanks:
    """Phase 14b's child: ``SPMD_RANKS`` gloo ranks of ``SPMD_CHILD`` on
    the CPU (no GPU, one ``torch`` thread each, loopback only), pinned to
    the last cores while this process keeps the others (as
    ``DryRunLanes``); ``join`` waits for them (killing them at
    ``SPMD_CHILD_TIMEOUT``) and restores this process's cores."""

    def __init__(self, tmp: Path):
        self.cores = sorted(os.sched_getaffinity(0))
        self.threads_before = torch.get_num_threads()
        own = len(self.cores) - SPMD_RANKS >= 2
        env = dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent / "src"), CUDA_VISIBLE_DEVICES="",
            OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
            GLOO_SOCKET_IFNAME="lo")
        arg = json.dumps([list(SPMD_CHILD_ARCHS), list(SPMD_MESH),
                          SPMD_STEPS, SPMD_LR, SPMD_LOSS_TOL,
                          SPMD_PARAM_TOL])
        self.t0 = time.perf_counter()
        self.procs = []
        for r in range(SPMD_RANKS):
            cores = [self.cores[-1 - r]] if own else None
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", SPMD_CHILD, str(r),
                 str(tmp / "spmd_store"), arg, json.dumps(cores)], env=env,
                text=True, cwd=tmp, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
        if own:
            keep = self.cores[:len(self.cores) - SPMD_RANKS]
            pin_process(keep)
            torch.set_num_threads(len(keep))

    def join(self) -> tuple[dict, float]:
        try:
            outs = [p.communicate(timeout=SPMD_CHILD_TIMEOUT)
                    for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            pin_process(set(self.cores))
            torch.set_num_threads(self.threads_before)
        secs = time.perf_counter() - self.t0
        for r, (p, (_, err)) in enumerate(zip(self.procs, outs)):
            if p.returncode:
                raise AssertionError(f"phase 14b rank {r} exited "
                                     f"{p.returncode} (3: it imported JAX "
                                     f"or the JAX package): {err[-3000:]}")
        return json.loads(outs[0][0].strip().splitlines()[-1]), secs


def spmd_world(dev):
    """A one-rank ``SPMD_BACKEND`` process group from a ``HashStore`` (no
    network) and its (1, 1) mesh of ranks."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_mesh

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(SPMD_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=1)
    return make_rank_mesh((1, 1), ("data", "model"), dev.type)


def spmd_run(kind: str, cfg, ocfg, mesh, seed: int, dev, tmp: Path):
    """``SPMD_STEPS`` steps of 8a's batches from 8a's seeded init of
    ``cfg``: ``plain`` (tensors through ``make_train_step``), ``sharded``
    (``place_state`` on ``mesh``, then ``make_train_step``) or
    ``trainer`` (the sharded state through a ``Trainer`` in ``tmp``, which
    checkpoints at the end).  Returns (state, the step function, [losses,
    grad norms, seconds a step, peak bytes, seconds in all])."""
    from repro_torch.data.pipeline import PrefetchIterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry
    from repro_torch.distributed.sharding import tree_param_specs
    from repro_torch.runtime.elastic import place_state
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.trainer import Trainer, TrainerConfig

    api = registry.get_model(cfg.name, cfg)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def init_state():
        params = api.init(torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
        if kind != "plain":
            params = place_state(params, mesh,
                                 tree_param_specs(params, mesh))
        return {"params": params, "opt": opt_lib.init_opt_state(params,
                                                                 ocfg)}

    def make_batch(i: int) -> dict:
        return lm_batch(cfg, GEMMA2_TRAIN_BATCH, GEMMA2_TRAIN_SEQ, seed, i)

    step = make_train_step(api, ocfg, donate=True)
    t0 = time.perf_counter()
    if kind == "trainer":
        tcfg = TrainerConfig(total_steps=SPMD_STEPS, log_every=1,
                             ckpt_every=SPMD_STEPS + 1, out_dir=str(tmp),
                             resume=False)
        with contextlib.redirect_stdout(io.StringIO()):
            state = Trainer(tcfg, step, init_state, make_batch,
                            device=dev).run()["state"]
        recs = [json.loads(ln) for ln in
                (tmp / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in recs]
        norms = [r["grad_norm"] for r in recs]
        secs = [r["sec_per_step"] for r in recs]
    else:
        state = init_state()
        data = PrefetchIterator(make_batch, device=dev)
        try:
            state, losses, norms, ms = train_steps(
                step, state, itertools.islice(data, SPMD_STEPS), dev)
        finally:
            data.close()
        secs = [t / 1e3 for t in ms]
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return state, step, [losses, norms, secs, peak, total]


def spmd_placed(state, mesh, ocfg) -> tuple[list[str], int, int]:
    """The leaves of a sharded state whose placements are not their
    spec's (``tree_param_specs``, ``state_specs``), this rank's resident
    bytes and its ``with_shardings`` block bytes."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.training import optimizer as opt_lib

    pspecs = shd.tree_param_specs(state["params"], mesh)
    specs = {"params": pspecs, "opt": opt_lib.state_specs(
        pspecs, state["params"], ocfg)}
    wrong = [p for (p, t), spec in zip(tree_leaves_with_path(state),
                                       tree_leaves(specs), strict=True)
             if tuple(shd.placements_spec(t.placements, mesh.axis_names,
                                          t.dim())) != tuple(spec)]
    blocks = shd.with_shardings(state, specs, mesh)
    return (wrong, sum(t.to_local().nbytes for t in tree_leaves(state)),
            sum(s.block_bytes for s in tree_leaves(blocks)))


def spmd_against(kind: str, state, plain, runs: dict, mesh, ocfg) -> None:
    """A sharded run's state and metrics against the plain run's, bit for
    bit, and its leaves placed by their specs."""
    wrong, local, block = spmd_placed(state, mesh, ocfg)
    if wrong or local != block:
        raise AssertionError(f"phase 14a {kind}: leaves placed off their "
                             f"specs {wrong[:5]}, {local} B resident "
                             f"against {block} B of blocks")
    differ = [p for (p, a), b in zip(tree_leaves_with_path(state),
                                     tree_leaves(plain), strict=True)
              if not torch.equal(a.to_local(), b)]
    want = runs["plain" if kind == "sharded" else "plain cut"][:2]
    if differ or runs[kind][:2] != want:
        raise AssertionError(f"phase 14a {kind}: losses and grad norms "
                             f"{runs[kind][:2]} against the plain step's "
                             f"{want}; leaves differ: {differ[:5]}")


def check_spmd(seed: int, dev, smi: str, tmp: Path) -> None:
    """Phase 14: the sharded token-LM train step; plain PyTorch on
    DTensors, no kernel launched.  (b) starts first and runs beside (a)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.training.optimizer import OptimizerConfig

    t0 = time.perf_counter()
    print(f"phase 14 on {smi}")
    set_counts(0)
    ranks = SpmdRanks(tmp)
    try:
        cfg = SPMD_GEMMA2
        cut = dataclasses.replace(cfg, num_layers=SPMD_TRAINER_LAYERS)
        ocfg = OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR,
                               warmup_steps=max(SPMD_STEPS // 20, 2),
                               decay_steps=SPMD_STEPS)
        batch = on(dev, lm_batch(cfg, GEMMA2_TRAIN_BATCH, GEMMA2_TRAIN_SEQ,
                                 seed, SPMD_STEPS))
        mesh = spmd_world(dev)
        runs, profiles = {}, {}
        try:
            # the plain final state stays on the card beside each sharded
            # run (8a's peak plus one state: ~77 of the card's 85 GB)
            plain, plain_step, runs["plain"] = spmd_run(
                "plain", cfg, ocfg, mesh, seed, dev, tmp)
            state, step, runs["sharded"] = spmd_run(
                "sharded", cfg, ocfg, mesh, seed, dev, tmp)
            spmd_against("sharded", state, plain, runs, mesh, ocfg)
            state, profiles["sharded"] = profile_step(step, state, batch,
                                                      dev)
            del state
            _, profiles["plain"] = profile_step(plain_step, plain, batch,
                                                dev)
            del plain, _
            plain, _, runs["plain cut"] = spmd_run("plain", cut, ocfg, mesh,
                                                   seed, dev, tmp)
            out = tmp / "spmd_trainer"
            state, _, runs["trainer"] = spmd_run("trainer", cut, ocfg, mesh,
                                                 seed, dev, out)
            spmd_against("trainer", state, plain, runs, mesh, ocfg)
            del state, plain
            shutil.rmtree(out, ignore_errors=True)
        finally:
            dist.destroy_process_group()
        for kind, (losses, norms, secs, peak, total) in runs.items():
            shown = cut if kind in ("plain cut", "trainer") else cfg
            print(f"spmd: {describe(shown)}, remat {cfg.remat}, {ocfg.name}, {SPMD_STEPS} steps of "
                  f"{GEMMA2_TRAIN_BATCH} x {GEMMA2_TRAIN_SEQ} tokens, {kind}"
                  + ("" if kind.startswith("plain") else
                     f" on a (1, 1) mesh of one {SPMD_BACKEND} rank") +
                  f": loss {losses!r}, grad_norm {norms!r}, {secs!r} s a "
                  f"step, {total!r} s in all, max_memory_allocated "
                  f"{peak!r} B, on {smi}")
        for kind, prof in profiles.items():
            print(f"spmd: {kind} {prof}, on {smi}")
        print("spmd: the sharded step bit-equal to the plain one over "
              f"{SPMD_STEPS} steps at full depth, and the Trainer's run at "
              f"{SPMD_TRAINER_LAYERS} layers (checkpoint included) to the "
              "plain step at that depth: losses, grad norms and every "
              "parameter and AdamW leaf; every leaf placed by its spec, "
              "resident bytes its with_shardings blocks")
    finally:
        results, child_secs = ranks.join()
    for arch, r in results.items():
        if not (r["dloss"] <= SPMD_LOSS_TOL and r["dgrad_norm"]
                <= SPMD_LOSS_TOL * max(1.0, max(r["plain_losses"]))
                and r["dparam"] <= r["param_bound"] and r["placed_by_specs"]
                and r["local_bytes"] == r["block_bytes"]
                < r["global_bytes"]):
            raise AssertionError(f"phase 14b {arch}: {r}")
        g = r.get("gathered")
        if g and not 0 < g["layer"] == g["full"] < g["none"]:
            raise AssertionError(f"phase 14b {arch}: gathered layers alive "
                                 f"at once {g}, not one with remat")
        print(f"spmd ranks: {arch} (reduced) on a {SPMD_MESH} mesh of "
              f"{SPMD_RANKS} gloo ranks on the CPU, {SPMD_STEPS} AdamW "
              f"steps: losses {r['losses']!r} (one device "
              f"{r['plain_losses']!r}), |d loss| {r['dloss']!r}, |d "
              f"grad_norm| {r['dgrad_norm']!r}, |d param| {r['dparam']!r} "
              f"(bound {r['param_bound']!r}); placed by the specs, rank 0 "
              f"{r['local_bytes']!r} of {r['global_bytes']!r} B; sharded "
              f"{r['sharded_s']!r} s, one device {r['plain_s']!r} s"
              + (f"; gathered layers alive at once, rank 0: {g['full']!r} B"
                 f" with remat \"full\" (one layer {g['layer']!r} B), "
                 f"{g['none']!r} B with none" if g else ""))
    expect_launches("phase 14", dev, {})
    print(f"phase 14: {time.perf_counter() - t0!r} s (14b's child "
          f"{child_secs!r} s beside 14a); no kernel launched, on {smi}")


# ----------------------------------------------------------------- timing


def cuda_ms(fn, args, reps: int = 50) -> float:
    """Mean device time of ``fn(*args)`` from CUDA events over ``reps``
    back-to-back calls.  A wrapper's host work (checks, allocation, the
    ctypes call) takes longer than the smaller kernels, so events around
    calls made as the host issues them time the host.  The calls are
    therefore queued behind ``torch.cuda._sleep`` and run back to back
    once it ends; the sleep grows until the host finished queuing before
    it ended, which the host clock and the sleep's own events show."""
    for _ in range(10):
        fn(*args)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 10_000_000
    for _ in range(6):
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        queued_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if queued_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise RuntimeError(f"cuda_ms: the host took {queued_ms} ms to queue "
                       f"{reps} calls, longer than the longest sleep")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def events(x: torch.Tensor) -> tuple[float, int]:
    """(events, distinct rows named) of the lossless event lists of the
    rows of ``x`` (R, K): what a gather over them must read."""
    live = x != 0
    return float(live.sum()), int(live.any(dim=0).sum())


def work(name: str, args, fc_mode: str = "csc") -> tuple[int, float]:
    """(bytes moved, operations) of one kernel call on ``args``: each
    input read once (a broadcast stimulus counts its one row), each output
    written once; a sparse or gated call counts what these inputs need:
    the stored CSC or N:M entries, the events and the W rows they name,
    the recomputed K8 rows and the cached rows read in their place.  For
    K6/K7 (in ``fc_mode``) the operations are a pair: (float32 layer
    products and LIF chains, integer FC sums)."""
    if name.startswith("megastep"):
        return megastep_work(args, fc_mode)
    if name in ("rsnn_cell", "spike_cell"):
        stim, s, w, u0, h0, beta, vth = args
        ts, b, h = s.shape
        stim_b = b * h * 4 if stim.stride(0) == 0 else nbytes(stim)
        io = stim_b + nbytes(s, u0, h0, beta, vth) + nbytes(s, u0)
        if name == "rsnn_cell":
            return io + nbytes(w), 2.0 * ts * b * h * h + 5.0 * ts * b * h
        ev, named = events(s.reshape(ts * b, h))
        return io + named * h * 4, 2.0 * ev * h + 5.0 * ts * b * h
    if name == "int4_matmul":
        x, p, sc = args
        m, k = x.shape
        n = p.shape[1]
        return nbytes(x, p, sc) + m * n * 4, 2.0 * m * k * n
    if name == "merged_spike_fc":
        s, p, sc = args
        ts, b, h = s.shape
        n = p.shape[1]
        return (nbytes(s, p, sc) + b * n * 4,
                (ts - 1.0) * b * h + 2.0 * b * h * n)
    if name == "delta_step":
        x, xp, pp, w, thr = args
        b, d = x.shape
        h = w.shape[1]
        changed = int(((x - xp).abs() > thr).any(dim=1).sum())
        w_b = nbytes(w) if changed else 0
        return (nbytes(x, xp) + (b - changed) * h * 4 + w_b
                + 2 * nbytes(x) + b * h * 4,
                2.0 * changed * d * h + 2.0 * b * d)
    if name == "spike_broadcast":
        x, w = args
        merged = x.sum(dim=0) if x.dim() == 3 else x
        r, k = merged.shape
        n = w.shape[1]
        ev, named = events(merged)
        return (nbytes(x) + named * n * 4 + r * n * 4,
                2.0 * ev * n + (x.numel() - merged.numel()))
    s, *fc, sc = args  # sparse_fc: indices, values; nm_fc: packed
    ts, b, h = s.shape
    stored = stored_entries(*fc)
    return (nbytes(s, *fc, sc) + b * fc[0].shape[1] * 4,
            (ts - 1.0) * b * h + 2.0 * b * stored)


def stored_entries(*fc) -> float:
    """Nonzero weights of a CSC (indices, values) or N:M (packed) FC."""
    vals = fc[-1] & 0xF if fc[-1].dtype == torch.int8 else fc[-1]
    return float((vals != 0).sum())


def megastep_work(args, fc_mode: str) -> tuple[int, tuple[float, float]]:
    """``work`` of one K6/K7 call: every operand read once and every output
    written once; float32 operations of the L0 feed-forward, the three
    spike products (2 x H per event of the trains each frame reads, which
    the plain version's trains of this call give) and both LIF chains;
    integer operations of the merged-spike FC (the stored CSC or N:M
    entries; dense_int4: the merged union's events), or, with float weights
    (``dense_float``), its float32 operations (the merged union's events).
    K6 and K7 compute one function on the same inputs, so both count only
    the events: a product with a 0 spike is work neither needs."""
    x, s0, u0, h0, s1, u1, h1, b0, v0, b1, v1, wq, fc = args
    frames, b, d = x.shape
    ts, _, h = s0.shape
    n = fc[0].shape[1]
    moved = (nbytes(x, s0, u0, h0, s1, u1, h1, b0, v0, b1, v1, *wq, *fc)
             + nbytes(s0, u0, s1, u1) + frames * b * n * 4
             + 2 * frames * ts * b * 4 + 2 * frames * b * 4)
    f32 = frames * (2.0 * b * d * h + 2 * 5.0 * ts * b * h)
    merge = frames * (ts - 1.0) * b * h
    dense_fc = fc_mode in ("dense_int4", "dense_float")
    sparse_ops = 0.0 if dense_fc else 2.0 * b * stored_entries(*fc[:-1])
    fc_ops = 0.0
    plain = megastep_pair(fc_mode, False)[1]
    for f in range(frames):  # the trains each frame reads
        out = plain(x[f:f + 1], s0, u0, h0, s1, u1, h1, b0, v0, b1, v1, wq,
                    fc)
        ev = sum(events(t.reshape(-1, h))[0] for t in (s0, out[0], s1))
        f32 += 2.0 * h * ev
        fc_ops += (2.0 * n * events(out[2].sum(dim=0))[0] if dense_fc
                   else sparse_ops)
        s0, u0, s1, u1 = out[:4]
        h0, h1 = s0[-1], s1[-1]
    if fc_mode == "dense_float":
        return moved, (f32 + merge + fc_ops, 0.0)
    return moved, (f32, merge + fc_ops)


def bound_parts(name: str, args,
                fc_mode: str = "csc") -> tuple[float, float]:
    """(seconds for the bytes at the memory rate, seconds for the
    operations at the peak rate of their type) of one call on the H100
    (K6/K7 in ``fc_mode``)."""
    moved, ops = work(name, args, fc_mode)
    if name.startswith("megastep"):
        f32, ints = ops
        return (moved / HBM_BYTES_PER_S,
                f32 / PEAK_OPS_PER_S[name] + ints / INT8_OPS_PER_S)
    return moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[name]


def library_fn(name: str, args):
    """One PyTorch call computing (close to) the same function, timed as a
    yardstick only: the port never calls it.  None where there is none."""
    if name == "int4_matmul":
        from repro_torch.kernels.ref import unpack_int4_ref

        x, p, sc = args
        w = unpack_int4_ref(p).float() * sc
        return torch.matmul, (x, w)
    if name == "merged_spike_fc":
        from repro_torch.kernels.ref import unpack_int4_ref

        s, p, sc = args
        w = unpack_int4_ref(p).float() * sc
        return (lambda s_, w_: torch.einsum("tbh,hn->bn", s_, w_)), (s, w)
    if name == "spike_broadcast":  # lossless: the dense product
        x, w = args
        if x.dim() == 3:
            return (lambda s_, w_: torch.einsum("tbk,kn->bn", s_, w_)), args
        return torch.matmul, args
    if name == "nm_fc":  # the same matrix decoded, then as for sparse_fc
        from repro_torch.core.layouts.nm import (NMGroupPacked, entry_rows,
                                                 split_nibbles)

        s, p, sc = args
        t = NMGroupPacked(p, sc, None, NM[0], NM[1], p.shape[0] // NM[0]
                          * NM[1])
        return library_fn("sparse_fc", (s, entry_rows(t),
                                        split_nibbles(p)[0], sc))
    if name == "sparse_fc":
        s, idx, val, sc = args
        h, n = s.shape[-1], idx.shape[1]
        dense = torch.zeros((h, n), device=s.device)
        cols = torch.arange(n, device=s.device).expand_as(idx)
        dense.index_put_((idx.long(), cols), val * sc.reshape(1, -1),
                         accumulate=True)
        with warnings.catch_warnings():  # CSR support is marked beta
            warnings.simplefilter("ignore", UserWarning)
            wt = dense.t().contiguous().to_sparse_csr()  # (N, H)
        merged_t = s.sum(dim=0).t().contiguous()
        return torch.sparse.mm, (wt, merged_t)
    return None


def time_kernels(packs: dict, floats: dict, dev, seed: int, launches: dict,
                 errs: dict):
    """Phase 5: per-frame time of each kernel at B = 256 (K9/K10
    lossless, K8 at ``DELTA_THRESHOLD``, K5 over the 2:4 FC, K6/K7 as
    served with ``sparse_fc`` over the ``csc`` artifact, and with float
    weights at ``BASELINE``); K1, K8-K10 with float weights at
    ``BASELINE``; then K6/K7 in every FC mode over chunks of 1 and
    ``MEGA_FRAMES`` frames, the float ones at both widths of
    ``floats``."""
    gen = torch.Generator().manual_seed(seed + 7)
    calls = kernel_calls(kernel_inputs(packs, 256, gen, dev))
    float_calls = kernel_calls(float_kernel_inputs(floats["BASELINE"], 256,
                                                   gen, dev))
    calls.update({row: float_calls.pop(row) for row in FLOAT_ROWS})
    rows = []
    for name, items in calls.items():
        ms = plain_ms = bound = 0.0
        lib_ms: float | None = 0.0
        by_bytes = True
        # the plain mega-step issues ~100-150 launches a call, the plain K5
        # ~20: few enough calls that they all queue behind the sleep
        plain_reps = 4 if name.startswith("megastep") else \
            {"nm_fc": 10}.get(name, 50)
        per_call = []
        for kern, plain, args in items:
            per_call.append(cuda_ms(kern, args))
            ms += per_call[-1]
            plain_ms += cuda_ms(plain, args, plain_reps)
            t_bytes, t_ops = bound_parts(name, args,
                                         ROW_FC_MODE.get(name, "csc"))
            bound += max(t_bytes, t_ops) * 1e3
            by_bytes &= t_bytes >= t_ops
            lib = library_fn(name, args)
            lib_ms = None if lib is None or lib_ms is None else \
                lib_ms + cuda_ms(*lib)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES[name][0]}",
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes" if by_bytes else
            "operations", "library_ms": lib_ms})
        plan = ""
        if name.startswith("megastep"):
            from repro_torch.kernels import megastep

            spike = name.startswith("megastep_spike")
            shape = mega_shape(items[0][2], ROW_FC_MODE[name], spike)
            plan = "; plan " + plan_text(megastep.resident_plan(*shape),
                                         items[0][2], ROW_FC_MODE[name],
                                         spike)
        print(f"time {name} (per frame, B=256, {len(items)} call(s)): "
              f"{ms!r} ms, plain {plain_ms!r} ms, library {lib_ms!r} ms, "
              f"bound {bound!r} ms; by call {per_call!r}{plan}")
    for name, items in float_calls.items():  # K1, K8-K10 at H = 256
        per_call = [cuda_ms(kern, args) for kern, _, args in items]
        ms = sum(per_call)
        plain_ms = sum(cuda_ms(plain, args) for _, plain, args in items)
        bound = sum(max(bound_parts(name, args)) for _, _, args in items)
        libs = [library_fn(name, args) for _, _, args in items]
        lib_ms = None if None in libs else sum(cuda_ms(*lib) for lib in libs)
        print(f"time {name} BASELINE float (per frame, B=256, {len(items)} "
              f"call(s)): {ms!r} ms, plain {plain_ms!r} ms, library "
              f"{lib_ms!r} ms, bound {bound * 1e3!r} ms; by call "
              f"{per_call!r}")
    sweeps = [(kernel_inputs(packs, 256, gen, dev), FC_MODES, "")] + [
        (float_kernel_inputs(params, 256, gen, dev), ("dense_float",),
         f" {width}") for width, params in floats.items()]
    for a, fc_modes, width in sweeps:  # every FC mode, and chunks
        for fc_mode in fc_modes:
            for frames in (1, MEGA_FRAMES):
                for spike in (False, True):
                    name = "megastep_spike" if spike else "megastep"
                    args = megastep_args(a, frames, fc_mode)
                    ms = cuda_ms(megastep_pair(fc_mode, spike)[0], args)
                    bound = max(bound_parts(name, args, fc_mode)) * 1e3
                    print(f"time {name}{width} fc_mode={fc_mode} "
                          f"F={frames} (B=256): {ms / frames!r} ms a frame, "
                          f"bound {bound / frames!r} ms a frame")
    return rows


def sweep_tiles(packs: dict, floats: dict, dev, seed: int) -> None:
    """Every tile plan K6/K7 (``sweep_megastep``), K1, K10, K8, K5, K9, K4,
    K2 and K3 take at the main path's shapes (B = 256, phase 5's inputs; K1
    and K10 (lossless) on their L0 and L1 calls, K8 at
    ``DELTA_THRESHOLD`` and K9 on both of its calls, at H = 128 and again
    with float weights at ``BASELINE``; K5 over the 2:4 FC; K2 on the L0
    and L1 feed-forward), each launched through its launch function, held
    against the plain version and timed as phase 5 times a kernel; the
    plan the wrapper picks is marked.  What ``tile_plan``'s choice rests
    on.  First the time of a one-element ``zero_`` timed the same way: the
    floor of a launch."""
    from repro_torch.kernels import (_build, delta_step, int4_matmul,
                                     merged_spike_fc, nm_fc, ref, rsnn_cell,
                                     sparse_fc, spike_broadcast)

    gen = torch.Generator().manual_seed(seed + 7)
    a = kernel_inputs(packs, 256, gen, dev)
    fa = float_kernel_inputs(floats["BASELINE"], 256, gen, dev)
    sb_fn = _build.function("spike_broadcast_launch",
                            spike_broadcast._SB_ARGS)
    sf_fn = _build.function("sparse_fc_launch", sparse_fc._ARGS)

    def k9(x3, w, rows, cols):
        ts, r, k = x3.shape
        out = torch.empty((r, w.shape[1]), device=dev)
        _build.check(sb_fn(x3.data_ptr(), w.data_ptr(), out.data_ptr(), ts,
                           r, k, w.shape[1], k, rows, cols,
                           _build.stream(dev)), "spike_broadcast")
        return out

    def k4(s, idx, val, sc, rows, cols):
        ts, b, h = s.shape
        out = torch.empty((b, idx.shape[1]), device=dev)
        _build.check(sf_fn(s.data_ptr(), idx.data_ptr(), val.data_ptr(),
                           sc.data_ptr(), out.data_ptr(), ts, b, h,
                           idx.shape[0], idx.shape[1], rows, cols,
                           _build.stream(dev)), "sparse_fc")
        return out

    k1_fn = _build.function("rsnn_cell_launch", rsnn_cell._ARGS)
    k5_fn = _build.function("nm_fc_launch", nm_fc._ARGS)

    def k1(stim, s, w, u0, h0, beta, vth, rows, cols):
        ts, b, h = s.shape
        spikes = torch.empty_like(s)
        u = torch.empty_like(u0)
        _build.check(k1_fn(stim.data_ptr(), stim.stride(0), stim.stride(1),
                           s.data_ptr(), w.data_ptr(), u0.data_ptr(),
                           h0.data_ptr(), beta.data_ptr(), vth.data_ptr(),
                           spikes.data_ptr(), u.data_ptr(), ts, b, h, rows,
                           cols, _build.stream(dev)), "rsnn_cell")
        return spikes, u

    def k5(s, p, sc, rows, cols):
        ts, b, h = s.shape
        out = torch.empty((b, p.shape[1]), device=dev)
        _build.check(k5_fn(s.data_ptr(), p.data_ptr(), sc.data_ptr(),
                           out.data_ptr(), ts, b, h, p.shape[0], p.shape[1],
                           *NM, rows, cols, _build.stream(dev)), "nm_fc")
        return out

    def k1_case(what, stim, s, w, u0, h0, beta, vth):
        args = (stim, s, w, u0, h0, beta, vth)
        return (f"rsnn_cell {what}", k1, args, rsnn_cell.tile_plans(*s.shape),
                ref.rsnn_cell_ref(*args))

    k10_fn = _build.function("spike_cell_launch", spike_broadcast._CELL_ARGS)
    k8_fn = _build.function("delta_step_launch", delta_step._ARGS)

    def k10(stim, s, w, u0, h0, beta, vth, rows, cols):
        ts, b, h = s.shape
        spikes = torch.empty_like(s)
        u = torch.empty_like(u0)
        _build.check(k10_fn(stim.data_ptr(), stim.stride(0), stim.stride(1),
                            s.data_ptr(), w.data_ptr(), u0.data_ptr(),
                            h0.data_ptr(), beta.data_ptr(), vth.data_ptr(),
                            spikes.data_ptr(), u.data_ptr(), ts, b, h, h,
                            rows, cols, _build.stream(dev)), "spike_cell")
        return spikes, u

    def k10_case(what, stim, s, w, u0, h0, beta, vth):
        args = (stim, s, w, u0, h0, beta, vth)
        return (f"spike_cell {what}", k10, args,
                spike_broadcast.cell_tile_plans(*s.shape),
                ref.spike_cell_ref(*args))

    def k8(x, x_prev, pre_prev, w, thr, rows, cols):
        b, d = x.shape
        h = w.shape[1]
        x_hat, mask = torch.empty_like(x), torch.empty_like(x)
        pre = torch.empty_like(pre_prev)
        _build.check(k8_fn(x.data_ptr(), x_prev.data_ptr(),
                           pre_prev.data_ptr(), w.data_ptr(), thr,
                           x_hat.data_ptr(), pre.data_ptr(), mask.data_ptr(),
                           b, d, h, rows, cols, _build.stream(dev)),
                     "delta_step")
        return x_hat, pre, mask

    def k8_case(what, x):
        args = (x["x"], x["x_prev"], x["pre_prev"], x["w0x"],
                DELTA_THRESHOLD)
        return (f"delta_step {what}", k8, args,
                delta_step.tile_plans(*x["x"].shape, x["w0x"].shape[1]),
                ref.delta_step_ref(*args))

    i4_fn = _build.function("int4_matmul_launch", int4_matmul._ARGS)
    mfc_fn = _build.function("merged_spike_fc_launch", merged_spike_fc._ARGS)

    def k2(x, p, sc, rows, cols):
        m, k = x.shape
        out = torch.empty((m, p.shape[1]), device=dev)
        _build.check(i4_fn(x.data_ptr(), p.data_ptr(), sc.data_ptr(),
                           out.data_ptr(), m, k, p.shape[1], rows, cols,
                           _build.stream(dev)), "int4_matmul")
        return out

    def k3(s, p, sc, rows, cols):
        ts, b, h = s.shape
        out = torch.empty((b, p.shape[1]), device=dev)
        _build.check(mfc_fn(s.data_ptr(), p.data_ptr(), sc.data_ptr(),
                            out.data_ptr(), ts, b, h, p.shape[1], rows, cols,
                            _build.stream(dev)), "merged_spike_fc")
        return out

    def k2_case(what, x, p, sc):
        return (f"int4_matmul {what}", k2, (x, p, sc),
                int4_matmul.tile_plans(*x.shape, p.shape[1]),
                ref.int4_matmul_ref(x, p, sc))

    def k9_case(what, x, w):
        x3 = x.unsqueeze(0) if x.dim() == 2 else x
        return (f"spike_broadcast {what}", k9, (x3, w),
                spike_broadcast.tile_plans(*x3.shape, w.shape[1]),
                ref.spike_broadcast_ref(x3, w))

    s1, (idx, val, sc) = a["s1"], a["csc"]
    cells = [case(f"{layer}{width}", x[f"stim{i}"], x[f"s{i}"], x[f"w{i}h"],
                  x["u0"], x["h0"], x["beta"], x["vth"])
             for case in (k1_case, k10_case)
             for x, width in ((a, ""), (fa, " BASELINE float"))
             for i, layer in enumerate(("L0 (stride-0 stimulus)", "L1"))]
    cases = cells + [k8_case("H=128", a), k8_case("H=256 BASELINE float", fa),
             ("nm_fc", k5, (s1, *a["nm"]),
              nm_fc.tile_plans(*s1.shape, *a["nm"][0].shape),
              ref.nm_fc_ref(s1, *a["nm"], n=NM[0], m=NM[1])),
             k9_case("L1 feed-forward", a["s0"].reshape(-1, 128), a["w1x"]),
             k9_case("FC union", a["s1"], a["wfc"]),
             k9_case("L1 feed-forward BASELINE float",
                     fa["s0"].reshape(-1, 256), fa["w1x"]),
             k9_case("FC union BASELINE float", fa["s1"], fa["wfc"]),
             ("sparse_fc", k4, (s1, idx, val, sc),
              sparse_fc.tile_plans(*s1.shape, *idx.shape),
              ref.sparse_fc_ref(s1, idx, val, sc)),
             k2_case("L0 feed-forward", a["x"], *a["l0"]),
             k2_case("L1 feed-forward", a["s0"].reshape(-1, 128), *a["l1"]),
             ("merged_spike_fc", k3, (s1, *a["fc"]),
              merged_spike_fc.tile_plans(*s1.shape, a["fc"][0].shape[1]),
              ref.merged_spike_fc_ref(s1, *a["fc"]))]
    one = torch.zeros(1, device=dev)
    print(f"sweep launch floor (one-element zero_, timed alike): "
          f"{cuda_ms(torch.Tensor.zero_, (one,))!r} ms")
    sweep_megastep(a, fa)
    for name, fn, args, plans, want in cases:
        picked = _build.pick_tiles(plans)
        for p in plans:
            if p.shared_bytes > _build.MAX_SHARED_BYTES:
                continue
            got = fn(*args, p.rows, p.cols)
            torch.cuda.synchronize()
            check_call(name.split()[0], got, want, args, None)
            ms = cuda_ms(fn, (*args, p.rows, p.cols))
            mark = ", picked" if p == picked else ""
            print(f"sweep {name} {p.rows}x{p.cols} ({p.blocks} blocks, "
                  f"{p.shared_bytes} B shared, cost {p.cost}{mark}): "
                  f"{ms!r} ms")


def sweep_megastep(a: dict, fa: dict) -> None:
    """Every plan K6 and K7 take at the main path's shapes (B = 256, one
    frame; ``csc``, ``nm`` and ``dense_int4`` over ``kernel_inputs`` ``a``,
    ``dense_float`` over the ``BASELINE`` float inputs ``fa``), each held
    against the plain version by ``check_mega``'s rule and timed as phase
    5 times a kernel; the plan ``resident_plan`` picks is marked."""
    from repro_torch.kernels import _build, megastep

    for fc_mode, x in (("csc", a), ("nm", a), ("dense_int4", a),
                       ("dense_float", fa)):
        args = megastep_args(x, 1, fc_mode)
        rep = megastep_replay(args)
        for spike in (False, True):
            name = mega_row("megastep_spike" if spike else "megastep",
                            fc_mode)
            kern, plain = megastep_pair(fc_mode, spike)
            want = plain(*args)
            shape = mega_shape(args, fc_mode, spike)
            picked = megastep.resident_plan(*shape)
            ts, b, d, h, _, _, entries, _, _, _ = shape
            for p in megastep.tile_plans(ts, b, d, h, fc_mode, entries,
                                         spike):
                if p.shared_bytes > _build.MAX_SHARED_BYTES:
                    continue
                run = functools.partial(kern, plan=p)
                got = run(*args)
                torch.cuda.synchronize()
                check_mega(f"{name} {p}", got, want, rep,
                           fc_mode == "dense_float")
                ms = cuda_ms(run, args)
                mark = ", picked" if p == picked else ""
                print(f"sweep {name} {plan_text(p, args, fc_mode, spike)}"
                      f"{mark}: {ms!r} ms")


# ------------------------------------------------------------------- main


def set_counts(value: int) -> None:
    """Every kernel's launch counter (``kernels/ops.py`` ``COUNTERS``) to
    ``value``."""
    from repro_torch.kernels import ops

    ops.set_launch_counts(dict.fromkeys(ops.COUNTERS, value))


def read_counts() -> dict[str, int]:
    from repro_torch.kernels import ops

    return ops.launch_counts()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks)")
    ap.add_argument("--sweep-tiles", action="store_true",
                    help="with --kernels-only: time every tile plan of "
                         "megastep, rsnn_cell, spike_cell, delta_step, "
                         "nm_fc, spike_broadcast, sparse_fc, int4_matmul and "
                         "merged_spike_fc before stopping")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    # the plain versions' products on the card run in IEEE float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    if args.kernels_only:
        return run_phases(args, dev, smi, None)
    with tempfile.TemporaryDirectory(prefix="dryrun") as out:
        lanes = DryRunLanes(Path(out))  # phase 11a, beside phases 1-10
        try:
            return run_phases(args, dev, smi, lanes)
        finally:
            lanes.stop()


def run_phases(args, dev, smi: str, lanes: DryRunLanes | None) -> int:
    """Phases 1-14, the kernel line and the last line."""
    t_script = time.perf_counter()
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0!r} s (nvcc "
          f"{_build.build_seconds!r} s)")
    for src, out in sorted(_build.compiler_output.items()):
        for kernel, regs, stack, spill_st, spill_ld in \
                _build.ptxas_report(out):
            if "int4_tile_kernel" in kernel and src not in (
                    "int4_matmul.cu", "merged_spike_fc.cu"):
                continue  # common.cuh's, instantiated in every source
            print(f"ptxas {src} {kernel}: {regs} registers, {stack} B "
                  f"stack, spills {spill_st} B stored / {spill_ld} B loaded")

    utts = utterances(args.seed, STREAMS)
    with tempfile.TemporaryDirectory() as tmp:
        paths, arts = {}, {}
        for i, (key, (prune, layout)) in enumerate(ARTIFACTS.items()):
            paths[key] = write_artifact(Path(tmp) / f"art{i}", args.seed,
                                        utts, prune=prune, fc_layout=layout)
            arts[key] = load_artifact(paths[key])
            fc = arts[key].packed.sparse["fc_w"]
            print(f"artifact {key}: layouts {arts[key].layouts}, FC pruned "
                  f"{arts[key].fc_prune_fraction}, entries a column "
                  f"{fc[0].shape[0]}")
        print(f"cfg {arts['csc'].cfg}")
        paths["float"] = write_float_artifact(Path(tmp) / "float", args.seed,
                                              utts)
        arts["float"] = load_artifact(paths["float"])
        n_params = sum(t.numel() for n, t in arts["float"].params.items()
                       if n in BASELINE.layer_shapes)
        print(f"artifact float: cfg {arts['float'].cfg}, {n_params} float32 "
              f"weights = {n_params * 4} B")
        path, art = paths["csc"], arts["csc"]
        packs = {k: a.packed for k, a in arts.items() if a.packed is not None}
        floats = {"BASELINE": float_params(args.seed, BASELINE),
                  "PRUNED": float_params(args.seed, PRUNED)}
        errs = check_kernels(packs, floats, dev, args.seed)
        if args.kernels_only:
            if args.sweep_tiles:
                sweep_tiles(packs, floats, dev, args.seed)
            return 0
        launches, engines = serve_all(paths, arts, utts)
        served = {name: lg for name, (_, lg) in engines.items()}
        for a, b in zip(served["pallas"], served["sparse"]):
            if not np.array_equal(a, b):
                raise AssertionError("pallas and sparse logits differ")
        print("serve: pallas and sparse logits bit-equal")
        for k6, k7 in (("fused", "fused_spike"),
                       ("fused sparse_fc=False",
                        "fused_spike sparse_fc=False"),
                       ("fused nm", "fused_spike nm"),
                       ("fused float", "fused_spike float")):
            if not all(np.array_equal(a, b)
                       for a, b in zip(served[k6], served[k7])):
                raise AssertionError(f"{k6} and {k7} logits differ")
        print("serve: fused and fused_spike logits bit-equal, with and "
              "without sparse_fc, over the N:M artifact and over the float "
              "one")
        for key in ("csc", "float"):
            for backend in ("fused", "fused_spike"):
                check_chunk(paths[key], arts[key], utts, backend)
        check_forward(paths["float"], arts["float"], utts)
        serve_graphs(engines, utts)
        check_sharded(engines, utts, dev, smi)
        check_packing(args.seed, utts, Path(tmp), dev)
        run_example(Path(tmp), dev)
        check_training(args.seed, utts, Path(tmp), dev)
        check_paper_claims(args.seed, Path(tmp), dev)
        check_lm_serving(args.seed, dev, smi)
        check_lm_families(args.seed, dev, smi)
        lm = check_lm_training(args.seed, dev, smi, Path(tmp))
        check_examples(args.seed, dev, smi, lm["8a gemma2-2b"])
        check_distributed(args.seed, dev, smi, Path(tmp))
        print(f"phases 1-10: {time.perf_counter() - t_script!r} s, on {smi}")
        check_dry_run(lanes, dev, smi)
        check_bench_rows(lanes, dev, smi)
        check_loadgen(dev, smi)
        check_spmd(args.seed, dev, smi, Path(tmp))
        rows = time_kernels(packs, floats, dev, args.seed, launches, errs)

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
