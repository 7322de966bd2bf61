"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel of the port, all nvcc runs at once;
  3. each kernel against its plain PyTorch version at the full-width
     llama3.2-3b shapes of the serving path: attention on valid rows, each
     query row within 2 bf16 ulps of its own largest output of the plain
     version run in fp32 on the same bf16 inputs (paged decode over 8 slots
     of 128-576 tokens and over 2 slots of 4096 and 1500 tokens, 4 rotated
     pool sets each, rows of length 0 exactly zero, a decode call under
     torch.cuda.set_sync_debug_mode("error"): no host synchronisation; the
     paged prefill's 64 rows, padding rows too; each call one device
     kernel under the profiler; the worst rows printed on a [paged]
     line), the top-k/top-p
     filter bitwise against the bisection and the sort-based oracle (the
     serve's 8 rows, their first 4, one row with top-k off, 8 adversarial
     rows: ties at the k-th value across a tile edge, k = 1, k >= V, all
     -inf, one finite entry, top_p * Z under T_FLOOR, a nucleus edge in a
     dense tail, top-k off; and 8 rows at mamba2-1.3b's V 50304), one
     device kernel a call; the draw kernels' device uniforms (threefry2x32
     from seeds and positions) bitwise against ref.row_uniforms over
     65,536 (seed, position) pairs, 0 and 2^32 - 1 among both, int64 and
     int32 positions; the token draw bitwise against the plain draw of
     those uniforms (the filter's 8 rows and the same rows unfiltered, 8
     adversarial rows filtered, one row of a single finite entry, [1, V],
     8 filtered rows at mamba2's V; rows at uniforms 0 and 1 - 2^-23), one
     device kernel a call, its device time beside the parent's in PERF.md;
     the fused add +
     norm with x + y bitwise and the norm within
     1 bf16 ulp (8, 64 and 300 rows at D 3072, rmsnorm and layernorm +
     bias; D 12288; D 3070 and 40000 through the wide variant; one device
     kernel a call; device time from the profiler at 8 and 64 rows beside
     one torch.add over the same rows, a one-pass yardstick that is not the
     same function), the fused LM head's tokens and probe
     bitwise on inputs whose GEMM is exact in any order (greedy,
     temperature-only and filtered steps; 16 rows, one row with top-k
     off, 8 rows; two device kernels a call), and its greedy tokens on
     random bf16 inputs wherever the plain top-2 margin exceeds 2 bf16
     ulps, at
     llama3.2-3b's D 3072 / V 128256 and again at mamba2-1.3b's D 2048 /
     V 50304 (the mamba2 serve's shape); the filter, draw and head also
     under short torch.profiler windows; then the
     training kernels at full-width bert-large shapes: the fused residual
     add + layernorm at [1024, 1024] and [4096, 1024] (B8 with S128 and
     S512) within 1 bf16 ulp of max(|output|, |output before the bias|),
     bias + GeLU at [1024, 4096] and [4096, 4096] and on a tail-heavy
     [1024, 4096] (h over [-12, 12]) within 1 bf16 ulp + |h| 2^-22 of its
     plain version run in fp32 on the same bf16 inputs, its device time
     at both sizes beside F.gelu's and the byte bound,
     and both LAMB stages on the wqkv, embedding and bias shapes and a
     ragged 4099 (m', v' within 2 fp32 ulps, the trust ratio within 1e-5
     relative), and on a dp=2 rank's ZeRO shards of the embedding ([1,
     15663104]) and of an expert leaf ([8, 1441792]) in one call of the
     shard path; and the mamba mixer's gated RMSNorm at mamba2's width
     (C 4096) on 8, 64, 1 and 300 rows and at jamba's C 8192 on 8 and 300,
     z read in place from an in_proj row, within 1 bf16 ulp of the row's
     largest |output|, one device kernel a call (device time and the
     one-pass yardstick as for the add + norm), then C 32768 and the
     wrapper's largest C through the wide variant, and one C past it
     refused; and the flash
     attention forward with block_kv 1024 (as attention_core passes it) in
     six cases: at llama3.2-3b's heads the static prefill's q [4, 4096, 24,
     128] against k/v [4, 4096, 8, 128] causal, a ragged causal Sq = Sk =
     1500 (a length the TPU kernel rejects), Sq 256 against Sk 4096
     non-causal with ragged kv_len and a kv_len = 0 row, window 512 with
     q_offset 1024, and the prefill's shape with q, k and v as column views
     of one QKV tensor; at bert-large's heads (16 and 16, D 64) [2, 2048]
     causal with kv_len [2048, 1311]; each query row within 2 bf16 ulps of
     its own largest output of the plain version run in fp32, beside SDPA;
     each kernel timed by CUDA events and the profiler beside its bound,
     its plain version and a library yardstick (SDPA's device time from
     the profiler too, for the flash and both paged kernels);
  3b. the fused scale + causal mask + softmax (the paper's "Scale, Mask,
     Softmax" phase; no model path calls it, as in the JAX package) at
     bert-large's Phase 2 scores [64, 512, 512] and Phase 1 [512, 128,
     128] in fp32, Phase 2 in bf16, a ragged causal Sq 1500, the last
     256-row chunk of a 4096-token prompt (q_offset 3840), q_offset -1 (row
     0 fully masked: uniform), Sk 12288 (a 48 KB row) and Sk 32768, the
     kernel's largest, each with the plan ops.softmax_plan gave it (a warp
     or a CTA a row); every launch counter set to 0 just before the
     phase's run (one launch a case) and read just after; fp32 within
     2^-21 of each row's largest output with rows summing to 1 within
     1e-5, bf16 within 1 bf16 ulp of each plain output, masked entries
     exactly 0; each case timed beside its byte bound (valid entries read,
     every output written) and its share of it, its plain version and
     torch.softmax of the
     scores already scaled and masked in s's dtype; then the analytical
     model's attn_scale_mask_softmax for bert-large at B4, n 512, fp32 on
     the H100 (four kernels a layer, dropout included) beside 24 measured
     launches of the kernel;
  4. the full-width model's logits through the paged kernels, unfused and
     fused layer bodies, against a dense plain-PyTorch forward of the same
     weights: the final prefill chunk, then four decode steps across a page
     edge;
  5. serving, two paths: 8 requests through ContinuousEngine (8 slots, page
     16, prefill chunk 64, prompts of 128-512 tokens with 4 sharing a
     100-token prefix, 32 new tokens, half greedy and half at temperature
     0.8 / top-k 40 / top-p 0.95), first with fused_decode=False (the
     attention, filter and draw kernels), then with fused decode, the
     engine's default (attention, fused add + norm and fused head). Every
     kernel's launch counter is set to 0 just before each run and read
     just after; launches are split between decode steps and prefill
     chunks; the unfused run compares the decoded rows' top-2 logit
     margins with the logit error of phase 4, the fused run checks the
     head's finite probe on live rows, and the two runs' streams are
     compared (they may fork on near-tied logits); the plain (eager)
     ref.row_uniforms is counted on card tensors through every serve that
     follows, and must never run;
  5b. the multi-step loop (decode_steps=N; serving/graphs.py): the fused
     llama serve at N in 1 and 4 and the unfused one at N=4, each on
     an engine that first served a warm-up trace of other prompts (its
     graphs captured), then phase 5's trace with every launch counter set
     to 0 just before and read just after: streams bitwise phase 5's N=1
     streams, exact launches from the engine's steps, chunks and prefills
     (a replay counts the launches it captured), dispatches fewer than
     steps, no variant captured twice (trace_stats()["excess"] 0), every
     dispatch run under torch.cuda.set_sync_debug_mode("warn") with its
     graph replays under "error", and every dispatch that captured
     nothing making exactly one synchronising call; one steady dispatch
     of the warm-up trace (the 4th, or the first after it that captured
     nothing) under torch.profiler (the host's kernel-launch,
     graph-launch and copy calls for it: at N > 1 no kernel launch); the
     fused N=4 then serves a third trace under torch.profiler (wall, device
     busy, idle share, device kernels, host kernel-launch calls and graph
     launches a decode step; N=1's profile is phase 6's); the fused serve
     at N=4 with sanitize=True gives the same streams, and a smoke llama
     (head dim 128) with NaN weights raises SanitizerError at its first
     final chunk; the mamba2 phase adds its serve at N = 1 and 4 the same
     way, N=4 profiled;
  6. the fused trace (the default path) under torch.profiler, recording
     the card's activity only: device time
     by kernel and kind, kernel launches, and the device's idle share, the
     launch total printed beside the parent's in PERF.md and the fall the
     eager threefry accounts for (its launches, counted by the profiler,
     times the sampled head calls);
     then the static engine (launch/serve.py run_static) on the same
     llama3.2-3b weights with attn_impl="flash": 4 prompts of 4096 tokens,
     32 new tokens, greedy and then at T 0.8 / top-k 40 / top-p 0.95, every
     launch counter set to 0 just before each run and read just after
     (exactly 28 flash launches in the prefill, none in decode, one filter
     and one draw a token when sampled), the flash prefill's last logits
     against the same prefill with attn_impl="chunked" (plain PyTorch; rel
     L2 0.05, argmax agreement where the top-2 margin exceeds the error),
     prefill ms, decode ms a token, tok/s and peak memory, and one flash
     prefill under torch.profiler (flash against GEMM device time);
     then the llama model is freed and the mamba2 phase runs: full-width
     mamba2-1.3b (48 layers, d_model 2048, 64 SSD heads of 64, state 128,
     bf16, seeded random weights), the logits of a 200-token prompt through
     64-token paged prefill chunks (the last padded) and of four decode
     steps beside an idle slot against the plain full-sequence forward
     (rel L2 0.05, and against the fp32 forward no further than 1.25 x
     the plain bf16 forward is; the idle slot's state must stay zero), the
     same trace of 8 requests served through the default fused engine
     (the prefix cache reports its off reason) with every launch counter
     set to 0
     just before and read just after (exactly 48 gated_rmsnorm launches a
     decode step and a prefill chunk, one head_tokens a step and final
     chunk), a window of it (two requests, 8 new tokens each) under
     torch.profiler, and the static engine on 4 prompts of 512 tokens (two
     SSD chunks) with 16 new tokens, greedy: the prefill's last logits
     within rel L2 0.05 of the plain full-sequence forward (and against
     its fp32 run within 1.25 x the plain bf16 forward's distance),
     exactly 48 gated_rmsnorm launches in the prefill and 48 a decode
     step; before the mamba2 phase, one call each of the eager
     row_uniforms, the unfused sampler and the fused head at the serve's
     8 rows under the profiler: each selection must launch fewer kernels
     than the eager threefry alone, and no serve may have called it;
  6b. the moe and hybrid families: in phase 3 (beside the other kernel
     checks), the fused head with an untied head [D, V] (its own GEMV,
     head_gemv_wgmma_kernel: a TMA ring into wgmma on ops.untied_plan)
     bitwise against its plain version on exact-arithmetic inputs (16, 1,
     8 and 24 rows; greedy, temperature-only, filtered) at
     deepseek-moe-16b's D 2048 / V 102400 (and V 102384, a ragged last
     tile), internlm2-1.8b's V 92544 and jamba's D 4096 / V 65536, the
     random-input workspace and partials bitwise across two calls, its
     plan printed and timed beside its bound and torch.matmul (the GEMV
     only, also at 16 rows); paged decode and prefill at G 1
     (deepseek, 16 / 16 heads), 2 (internlm2) and 4 (jamba) held as in
     phase 3; the add + norm at D 2048; the filter and draw bitwise at V
     102400, 92544 and 65536. Here, deepseek-moe-16b at full width and depth
     (28 layers, 64 routed experts of 1408, top-6, 2 shared; 16.9 B
     parameters, bf16, seeded): its logits through the paged path (110
     tokens in 64-token chunks, four decode steps, unfused and fused)
     against the plain full-sequence forward at a capacity factor raised
     so nothing drops (rel L2 0.05), with the count of (layer, token) pairs
     whose top-6 expert set differs between the two; one MoE layer bitwise
     repeatable at [8, 1] and [1, 64]; phase 5's trace served unfused and
     fused at the config's capacity factor 1.25 (exact launches as for
     llama), the fused serve at decode_steps=4 as in phase 5b (streams
     bitwise, one synchronising call a dispatch, no host kernel launch in
     a steady dispatch), a window of the fused trace (two requests, 8
     new tokens each) profiled (device time split into GEMMs, the MoE's
     routing ops by kernel name, and the rest), and the
     static engine on 4 prompts of 512 tokens with 16 new, greedy, its
     last logits against the plain forward (rel L2 0.05). Then jamba at
     full width, one period of its 32 layers (8: 1 attention, 7 mamba, 4
     MoE of 16 experts of 14336; the whole model does not fit one card):
     the logits check at a raised capacity factor, and 4 requests of the
     trace (16 new tokens, greedy) served unfused then fused with exact
     launches from the steps and chunks, the streams compared;
  6c. the vlm and encdec families: in phase 3 (after the other kernel
     checks), the tied fused head at qwen2-vl-2b's D 1536 / V 151936 held
     as at llama's shape (bitwise on exact inputs at 16, 1 and 8 rows),
     paged decode and prefill at its G 6 (12 / 2 heads) within 2 bf16
     ulps, the add + norm at D 1536, the filter and draw bitwise at V
     151936 and whisper-base's 51968, and flash without a causal mask at
     whisper's heads (8 / 8, D 64) over 1500 keys (the encoder's
     self-attention [4, 1500] on column views of one QKV tensor, the
     prefill's cross-attention of [4, 64] queries) and causal at
     qwen2-vl's static prefill [4, 2048] (G 6, D 128), each query row
     within 2 bf16 ulps, beside its bound and SDPA. Here, qwen2-vl-2b at
     full width and depth (28 layers, d_model 1536, 12 / 2 heads of 128,
     vocab 151936 tied, M-RoPE with text-only positions; 1.54 B
     parameters, bf16, seeded, every bias perturbed by 0.1 N(0, 1)): the
     logits check of phase 4, phase 5's trace unfused then fused (exact
     launches as for llama) and fused at decode_steps=4 (streams bitwise
     N=1's, one synchronising call a dispatch, no host kernel launch in a
     steady dispatch), tok/s, TTFT, peak memory and launches a decode
     step; the static engine on 4 prompts of 2048 tokens, 32 new, greedy,
     with attn_impl="flash" (exactly 28 flash launches in the prefill,
     none in decode) and "chunked", last logits compared (rel L2 0.05).
     Then whisper-base at full width (6 encoder + 6 decoder layers,
     d_model 512, biases perturbed) through the static engine: 4 prompts
     of 64 tokens with 1500 frames of the stub frontend, 32 new, greedy
     then sampled, with "flash" (exactly 6 flash launches in the encoder
     and 6 in the decoder prefill's cross-attention, none in decode) and
     "chunked"; prefill ms split into encoder, cross K/V fill and
     decoder; last logits compared (rel L2 0.05); greedy streams equal or
     each first divergence printed with its top-2 margin;
  6d. the registry's last three archs: in phase 3 (after the vlm and
     encdec kernel checks), the tied fused head at command-r-35b's D 8192
     / V 256000 held as at llama's shape (bitwise on exact inputs at 16,
     1 and 8 rows), the filter and draw bitwise at [1, 256000] (top-k
     off: the whole-row search), [8, 256000] and [16, 256000] (the filter
     also against the sort-based oracle; one kernel a call; device time
     of each beside the [8, V] call's bound, plain version and, for the
     filter, the sort-based filter), the untied head at
     mistral-large-123b's D 12288 / V 32768 and llama4's D 5120 / V
     202048 (as at deepseek's), paged decode and prefill at G 8
     (command-r), 12 (mistral) and 5 (llama4), the add + norm as a
     LayerNorm with bias at D 8192 and an RMSNorm at D 5120, the filter and
     draw at llama4's and mistral's vocabularies, and flash causal at the
     three archs' heads (4 x 2048 at G 8, 1 x 2048 at G 12, 2 x 2048 at G
     5). Here, after the whisper phase, command-r-35b at full width and
     depth (40 layers, d_model 8192, 64 / 8 heads, LayerNorm with biases
     perturbed, tied vocab 256000; 30,284,201,984 parameters on the card,
     the LayerNorm biases and the final norm included): the logits check
     of phase 4, phase 5's trace unfused (the filter and draw at [S,
     256000]) then fused (the head's epilogue at 256,000) and fused at
     decode_steps=4 (streams bitwise N=1's), a window of the fused serve
     (4 requests, 16 new) profiled, and the static engine on 4 prompts of
     2048 tokens, 32 new, flash greedy and sampled (exactly 40 flash
     launches in the prefill, none in decode) and chunked greedy, last
     logits compared (rel L2 0.05); then mistral-large-123b (2 of 88
     layers) and llama4-maverick-400b-a17b (2 of 48: a dense layer, then
     a MoE of 128 experts, top-1, one shared) at full width: the logits
     check (llama4's gated on the fp32 forward at a raised capacity
     factor, as deepseek's), then the trace's first 4 requests, 16 new
     tokens, half sampled, served unfused and fused, the streams compared;
  7. one full-width bert-large post-norm block, fused (kernel forward,
     plain backward) against unfused in bf16 and both against fp32: the
     output and the gradient of the input and of every block parameter
     within rel L2 0.03;
  8. training: full-width bert-large (24 layers, d_model 1024, vocab
     30522, bf16 compute, fp32 master weights, seeded random weights), B8
     S128, LAMB at 1e-3, 6 steps through build_train_step and train_loop
     with REPRO_FUSED_BLOCKS=1 and fused_optimizer_kernel=True through
     bundle.fn (step 1 eager on a side stream, step 2 captured as a CUDA
     graph and replayed, then one replay a step), then 6 through
     bundle.eager from the same weights and batches: losses, grad norms
     and the final master weights, m, v and parameters bitwise equal;
     launch counters set to 0 just before each run, read just after:
     exactly 96 norms, 48 GeLUs and 296 launches of each LAMB stage a step
     on both (a replay adds the launches its capture counted); one more
     replayed step under torch.cuda.set_sync_debug_mode counting the calls
     that made the host wait for the card (none allowed), one replayed and
     one eager step under torch.profiler (device time by kind, "other"
     split into its largest kernels by name, host time by part of the
     step, and each LAMB stage's device time summed over its 296 launches
     beside its byte bound summed over the leaves; the eager step also
     under an optrace recorder with its op ranges), 5 more steps of each
     back to back, the graph pool and peak memory; then 6 unfused steps
     (graphed) from the same weights and batches; every loss finite, the
     last below the first on every run, the fused and unfused step-1
     losses within 1 bf16 ulp of each other; then the characterization
     (repro_torch.core.characterize): one eager fused step on a copy of
     the eager run's state priced op by op (FLOPs and bytes by category
     and by bucket, the H100 roofline terms, kernel ops equal to the
     launches a step, GEMM FLOPs within GEMM_TOL of the analytical model
     plus the recomputed block forwards), and the profiled eager step's
     device time given to the op that launched each kernel (within 1% of
     the busy time) by bucket, category, pass and paper phase beside the
     trace's roofline and analytical.phase_times (H100, MI100), Fig. 4
     and Fig. 5 shares, the unscoped share;
  8b. the training families after bert-large: the add + norm and the gated
     norm at the training steps' shapes ([1024, 3072], [1024, 4096]) held
     as in phase 3 beside their byte bounds and F.rms_norm of the
     precomputed input; llama3.2-3b at full width and depth (28 layers,
     3,212,749,824 parameters, tied vocab 128256), B8 S128, causal LM,
     LAMB at 1e-3 with fp32 master weights: one unfused plain step (plain
     LAMB) against step 1 of the fused path (REPRO_FUSED_BLOCKS=1: each
     block's mixer add + ln2 through decode_residual_norm; the fused LAMB
     kernels) from the same seeded weights, the loss, grad norm and
     updated params compared (bitwise where they are, else the gaps in
     bf16 ulps), 6 fused steps eager and 6 graphed (step 1 the warm-up,
     step 2 the capture, then one replay a step), bitwise equal (losses,
     grad norms, bit digests of every state leaf), exactly 56 add + norm
     launches (28 a pass, twice with the recompute) and one launch of each
     LAMB stage a leaf in every step, the loss falling, one replayed step
     profiled, 5 more back to back, peak memory and the graph pool; then
     the graph released and 3 eager steps at B1 S4096 through the chunked
     attention's VJP (168 chunked calls), and one llama layer's attention
     at that length through the VJP and through autodiff of the same
     forward loop (the bytes held after the forward: the VJP less than one
     score tile); mamba2-1.3b at full width and depth (48 layers), 6 steps
     graphed and 6 eager, every state leaf bitwise equal, exactly 96
     gated_rmsnorm launches a step, one replayed step profiled; then
     checkpoint/restart at smoke size (llama3.2-3b-smoke, bf16, B4 S32):
     4 graphed steps, the same with ckpt_every 2, a restart from step 2
     into a new bundle (one warm-up, one capture) and into the
     checkpointing run's own tensors (no new capture), each bitwise the
     uninterrupted run, and save_async followed at once by the next step:
     the checkpoint holds the state before it, bitwise;
  8c. after the tensor-parallel serving phase (tp_phase), data-parallel
     ZeRO-1 training (dp_phase): full-width bert-large B8 S128, fused
     (REPRO_FUSED_BLOCKS=1, the LAMB kernels), fp32 master weights; dp=1
     with zero1=True against zero1=False (step-1 loss bitwise, params
     within STEP1_PARAM_ULPS), then dp=2: two gloo ranks sharing the card
     (launch.mesh.spawn with a ("data",) mesh), 4 rows a rank, 4 eager
     steps: the ranks' params bitwise equal after every step, the step-1
     loss within STEP1_LOSS_ULPS of dp=1's and the step-1 params within
     STEP1_PARAM_ULPS of dp=1's computation of the same split step and of
     dp=1's own step as a master update rel-L2 a flat leaf within
     UPDATE_REL_L2 (with a dropped-rank control beyond it), a
     rank's m / v / master bytes exactly half of dp=1's, LAMB launches a
     step equal to dp=1's and the collectives a step equal to
     train.steps.zero_collectives, the bytes reduce-scattered and
     all-gathered (dp-1)/dp (4 + 2) N_flat beside core.distmodel's
     replicated all-reduce, the step times and peaks printed; nccl with a
     card a rank (the step captured) and llama3.2-3b only where the call
     has two cards;
  8d. after 8c, training on a (data, model) mesh (mp_phase) under
     make_rules()'s defaults (tensor, sequence and expert parallelism,
     FSDP), gloo ranks sharing the card: rows 4 and 6-9 held once against
     their plain versions at their TP shapes; bert-large (full width and
     depth, B8 S128, fused, LAMB kernels, fp32 master) on (1, 2), 3 eager
     steps, and on (2, 2), 2 steps: the step-1 loss within
     STEP1_LOSS_ULPS of dp=1's (8c); against dp=1's own step 1, a leaf:
     the master update within TP_UPDATE_REL_L2 (its median within
     TP_UPDATE_MEDIAN_REL_L2), m (the normalized gradient) within
     TP_MOMENT_REL_L2, the update's norm within TP_UPDATE_NORM_REL of
     dp=1's where w != 0 (a control step with model rank 1's partial sums
     dropped beyond the update limit at every leaf, and one with
     MP_PLANTED_LEAF's model-axis gradient sum dropped failing a gate
     there), the ranks holding a block of a leaf bitwise equal after
     every step, launches a step equal to tp=1's, the collectives equal
     train.steps.zero_collectives; deepseek-moe-16b at full width with 2
     of 28 layers on (1, 2), 2 steps, 32 experts a rank holding half the
     expert bytes, row 4's launches a step equal to 2 a layer; a rank's
     bytes, ring bytes beside core.distmodel.model_parallel's, step times
     and peaks printed; nccl only where the call has two cards;
  9. one JSON line of per-kernel numbers (times from CUDA events; the
     untied head its own entry; each kernel of phase 6c's paths with its
     numbers at the new shapes under "vlm_encdec_shapes" or, for flash,
     "vlm_encdec_cases"; the training kernels' library yardsticks also as
     profiler device time; the head, filter and draw at command-r-35b's
     shapes as rows of their own, launches from its serves) and of the
     serves (llama unfused and fused, mamba2 fused, static llama with
     flash and static mamba2, under "moe" the deepseek and jamba phases,
     under "vlm_encdec" the qwen2-vl and whisper phases and under
     "registry_archs" phase 6d's, under "training_families" phase 8b's;
     rows 4, 8, 9 and 11 also carry their launches and numbers on the
     training families' paths, rows 8 and 9 their ZeRO shards' check and
     their launches on the dp=2 path, rows 6-9 their TP shapes and
     launches under "model_parallel"; "data_parallel" phase 8c's numbers,
     "model_parallel" phase 8d's);
     a [time] line before it gives the seconds of every phase.
TF32 is off for matmuls and cuDNN (torch.backends), so fp32 references are
fp32. Every bound reads the card's peaks from repro_torch.core.roofline
(H100, H100_FP32).
The last line is {"ok": true, "device": {...}}. Weights are random, made on
the card from a seeded torch.Generator; nothing is downloaded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ATTN_ULPS = 2.0                # attention tolerance, in bf16 ulps (8
                               # significant bits) at each query row's
                               # largest |output|: against an fp32 plain
                               # version the kernel's only error is
                               # rounding its fp32 result to bf16 (half an
                               # ulp)
ATTN_TOL = f"{ATTN_ULPS:g} bf16 ulps of each query row's largest |output|"
LSE_ULPS = 16.0                # the flash kernel's row log-sum-exp, in fp32
                               # ulps of max(|lse|, 1) of the plain
                               # version's: its scores' products summed in
                               # another order, m kept in log2 units and
                               # ex2.approx (2^-22 relative) in l; a row
                               # with no valid key exactly the masked score
LSE_TOL = f"{LSE_ULPS:g} fp32 ulps of max(|lse|, 1); empty rows exactly"
SEED = 0


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def _profiled_ms(fn, names, iters: int = 10, floor_ms: float | None = None):
    """Device ms per call of the kernels whose names contain one of
    ``names`` (``("",)``: every kernel the call launches, as for a library
    call), from torch.profiler over ``iters`` calls. The profiler now and
    then drops records, so a window is kept only if it holds ``iters``
    times the records of a one-call window taken just before it (which is
    also the warm-up) and, with ``floor_ms`` (the call's least time on the
    card), reads no less than that; a window that fails is taken again, up
    to three times, and then the result is None."""
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(k in e.key for k in names)]
        return (sum(e.count for e in ev),
                sum(e.self_device_time_total for e in ev) / 1e3 / n)

    for _ in range(3):
        per_call, _ = window(1)
        count, ms = window(iters)
        if per_call and count == per_call * iters and \
                (floor_ms is None or ms >= floor_ms):
            return ms
    return None


def _ms(t) -> str:
    """A device time for a line of output (None: the profiler failed)."""
    return "null" if t is None else f"{t:.5f}"


def _attn_err(out: torch.Tensor, plain: torch.Tensor, name: str):
    """Hold each query row (the last dim) of ``out`` to ATTN_ULPS bf16 ulps
    of that row's own largest |plain|, so that rows averaging many values
    (small |o|) are held as tightly as rows with few. Returns the max abs
    error and the worst row's error in its own ulps."""
    diff = (out.float() - plain).abs().amax(-1)
    top = plain.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    err, ulps = diff.max().item(), (diff / ulp).max().item()
    if not ulps <= ATTN_ULPS:
        _fail(f"{name} error {ulps} bf16 ulps of its row's largest |output| "
              f"> {ATTN_ULPS} (max abs err {err})")
    return err, ulps


def _bound(nbytes: float, flops: float, fp32: bool = False):
    """The least time for ``nbytes`` of device memory traffic and ``flops``
    operations on the card: H100's HBM rate and its dense bf16 tensor-core
    peak, or H100_FP32's peak for fp32 work outside the tensor cores."""
    from repro_torch.core.roofline import H100, H100_FP32
    spec = H100_FP32 if fp32 else H100
    t_bytes, t_ops = nbytes / spec.hbm_bw, flops / spec.peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------- phase 3 ---
KERNEL_WINDOWS = 10     # profiler windows _kernels_a_call may take


def _kernels_a_call(fn, name):
    """Fail unless one call of ``fn`` launches exactly the device kernels
    ``DEVICE_NAMES[name]``, one each (torch.profiler; the call is made once
    before, outside the window). The profiler now and then drops a
    window's records, all of them or some: a window that holds fewer
    records than the call's kernels, each of them one it should launch, is
    taken again, up to KERNEL_WINDOWS windows, a little later each time. A
    window that holds a kernel the call should not launch, or more
    records than its kernels, fails at once: a profiler drops records but
    does not make them up."""
    from torch.profiler import ProfilerActivity, profile
    want = DEVICE_NAMES[name]
    fn()
    torch.cuda.synchronize()
    for attempt in range(KERNEL_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = [e.key for e in prof.key_averages() for _ in range(e.count)
                if e.device_type == torch.autograd.DeviceType.CUDA]
        stray = [k for k in seen if not any(n in k for n in want)]
        if stray or len(seen) > len(want):
            break
        if len(seen) == len(want) and all(any(n in k for k in seen)
                                          for n in want):
            return
        time.sleep(0.1 * (attempt + 1))
    _fail(f"{name}: one call launched {seen} on the card, not one kernel "
          f"each named {want} (window {attempt + 1} of at most "
          f"{KERNEL_WINDOWS}; the profiler's dropped windows are retaken)")


def _paged_decode_case(arch, rng, dev, seq_lens, max_pages):
    """Decode inputs at llama3.2-3b's heads, page 16: q, 4 rotated K/V pool
    sets (so K/V come from HBM), the page table and the lengths."""
    b, page = len(seq_lens), 16
    hq, hkv, d = arch.num_heads, arch.num_kv_heads, arch.resolved_head_dim
    num_pages = b * max_pages + 1
    sets = []
    for _ in range(4):
        kp = torch.randn((num_pages, page, hkv, d), device=dev,
                         dtype=torch.bfloat16)
        sets.append((kp, torch.randn_like(kp)))
    ids = rng.permutation(np.arange(1, num_pages))[:b * max_pages]
    pt = torch.as_tensor(ids.reshape(b, max_pages).astype(np.int32),
                         device=dev)
    sl = torch.as_tensor(np.asarray(seq_lens, np.int32), device=dev)
    q = torch.randn((b, hq, d), device=dev, dtype=torch.bfloat16)
    return q, sets, pt, sl


def _time_paged_decode(q, sets, pt, sl, name):
    """Check one decode case against its plain version and time it: events
    and device time over the rotated pool sets, the plain version, and
    SDPA on K/V already gathered to a dense layout (events and device)."""
    from repro_torch.kernels.decode_attention import ops, ref
    import torch.nn.functional as F
    b, hq, d = q.shape
    hkv = sets[0][0].shape[2]
    kp, vp = sets[0]
    out = ops.paged_decode_attention(q, kp, vp, pt, sl)
    plain = ref.paged_decode_attention(q.float(), kp.float(), vp.float(), pt,
                                       sl)
    torch.cuda.synchronize()
    live = sl > 0
    err, ulps = _attn_err(out[live], plain[live], name)
    if out[~live].any():
        _fail(f"{name}: rows with seq_len 0 are not exactly zero")
    torch.cuda.set_sync_debug_mode("error")    # the lengths stay on the card
    try:
        ops.paged_decode_attention(q, kp, vp, pt, sl)
    except RuntimeError as e:
        _fail(f"{name}: the wrapper waited on the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    state = {"i": 0}

    def kernel():
        k, v = sets[state["i"] % 4]
        state["i"] += 1
        ops.paged_decode_attention(q, k, v, pt, sl)
    _kernels_a_call(kernel, "paged_decode_attention")
    ms = _time_ms(kernel, 200)
    device_ms = _profiled_ms(kernel, DEVICE_NAMES["paged_decode_attention"],
                             iters=40)
    plain_ms = _time_ms(lambda: ref.paged_decode_attention(q, kp, vp, pt, sl),
                        20)
    # library yardstick: SDPA on the gathered dense K/V with a length mask
    kd = kp[pt.long()].reshape(b, -1, hkv, d).transpose(1, 2)
    vd = vp[pt.long()].reshape(b, -1, hkv, d).transpose(1, 2)
    mask = (torch.arange(kd.shape[2], device=q.device)[None] <
            sl[:, None].long())[:, None, None, :]
    sdpa = (lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True))
    library_ms = _time_ms(sdpa, 200)
    library_device_ms = _profiled_ms(sdpa, ("",), iters=50)
    tokens = int(sl.sum().item())
    nbytes = (tokens * hkv * d * 2 * 2 + 2 * q.numel() * 2 + pt.numel() * 4
              + sl.numel() * 4)
    bound_ms, bound_by = _bound(nbytes, 4.0 * tokens * hq * d)
    return {"max_abs_err": err, "tol": ATTN_TOL, "max_err_row_ulps": ulps,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "split": ops.decode_plan(b, hkv, pt.shape[1], kp.shape[1])}


def check_decode_attention(arch, rng, dev):
    """The serve's decode shape (8 slots, 128-576 tokens), then a long
    context: 2 slots of 4096 and 1500 tokens (4 pool sets of 2 x 16.8 MB,
    beyond L2), where one CTA a (slot, KV head) would leave most SMs idle."""
    seq_lens = np.asarray(rng.integers(128, 577, 8), np.int32)
    seq_lens[0], seq_lens[1] = 576, 17     # the longest row; a page edge
    row = _time_paged_decode(*_paged_decode_case(arch, rng, dev, seq_lens, 36),
                             "paged_decode_attention")
    long_row = _time_paged_decode(       # its own rng: later phases draw
        *_paged_decode_case(arch, np.random.default_rng(SEED + 11), dev,
                            [4096, 1500], 256),
        "paged_decode_attention (4096, 1500)")
    torch.cuda.empty_cache()
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      "paged_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:164",
            **row, "long_context": dict(long_row, seq_lens=[4096, 1500])}


def check_prefill_attention(arch, rng, dev):
    """The last chunk of a 498-token prompt: every row of the chunk, the
    padding rows too (they attend to the valid prefix), held to the plain
    version."""
    from repro_torch.kernels.decode_attention import ops, ref
    import torch.nn.functional as F
    c, page = 64, 16
    hq, hkv, d = arch.num_heads, arch.num_kv_heads, arch.resolved_head_dim
    max_pages, num_pages = 35, 64
    start, valid = 448, 50                 # last chunk of a 498-token prompt
    total = start + valid
    kp = torch.randn((num_pages, page, hkv, d), device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    row = rng.permutation(np.arange(1, num_pages))[:max_pages]
    pr = torch.as_tensor(row.astype(np.int32), device=dev)
    q = torch.randn((c, hq, d), device=dev, dtype=torch.bfloat16)
    out = ops.paged_prefill_attention(q, kp, vp, pr, start, total)
    plain = ref.paged_prefill_attention(q.float(), kp.float(), vp.float(), pr,
                                        start, total)
    torch.cuda.synchronize()
    err, ulps = _attn_err(out, plain, "paged_prefill_attention")
    kernel = (lambda: ops.paged_prefill_attention(q, kp, vp, pr, start,
                                                  total))
    _kernels_a_call(kernel, "paged_prefill_attention")
    ms = _time_ms(kernel, 200)
    device_ms = _profiled_ms(kernel, DEVICE_NAMES["paged_prefill_attention"],
                             iters=40)
    plain_ms = _time_ms(lambda: ref.paged_prefill_attention(
        q, kp, vp, pr, start, total), 20)
    kd = kp[pr.long()].reshape(1, -1, hkv, d).transpose(1, 2)
    vd = vp[pr.long()].reshape(1, -1, hkv, d).transpose(1, 2)
    cols = torch.arange(kd.shape[2], device=dev)[None]
    rows = start + torch.arange(c, device=dev)[:, None]
    mask = ((cols <= rows) & (cols < total))[None, None]
    sdpa = (lambda: F.scaled_dot_product_attention(
        q.transpose(0, 1)[None], kd, vd, attn_mask=mask, enable_gqa=True))
    library_ms = _time_ms(sdpa, 200)
    library_device_ms = _profiled_ms(sdpa, ("",), iters=50)
    visible = sum(min(start + r + 1, total) for r in range(valid))
    nbytes = total * hkv * d * 2 * 2 + 2 * valid * hq * d * 2 + max_pages * 4
    flops = 4.0 * visible * hq * d
    bound_ms, bound_by = _bound(nbytes, flops)
    return {"name": "paged_prefill_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      "paged_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:113",
            "max_abs_err": err, "tol": ATTN_TOL, "max_err_row_ulps": ulps,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "split": ops.prefill_plan(c, hq, hkv, start, total, page,
                                      max_pages)[0]}


def print_paged(dec, pre):
    """The paged kernels' phase-3 line: worst rows, device times beside
    SDPA's, the long-context case."""
    lc = dec["long_context"]
    print(f"[paged] decode: worst row {dec['max_err_row_ulps']:.4f} ulps, "
          f"device {dec['device_ms']} ms (events {dec['ms']:.5f}; SDPA "
          f"device {dec['library_device_ms']}; bound {dec['bound_ms']:.5f}; "
          f"split {dec['split']}); prefill: worst row "
          f"{pre['max_err_row_ulps']:.4f} ulps, device {pre['device_ms']} ms "
          f"(events {pre['ms']:.5f}; SDPA device {pre['library_device_ms']}; "
          f"bound {pre['bound_ms']:.5f}; split {pre['split']}); decode at "
          f"[4096, 1500]: worst row {lc['max_err_row_ulps']:.4f} ulps, device "
          f"{lc['device_ms']} ms (events {lc['ms']:.5f}; SDPA device "
          f"{lc['library_device_ms']}; bound {lc['bound_ms']:.5f}; split "
          f"{lc['split']}); one kernel a call")


def _valid_pairs(sq, sk, kv_len, causal, q_offset, window) -> int:
    """(query, key) pairs that these masks leave valid, summed over the
    batch rows of ``kv_len``: the work the inputs need."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    total = 0
    for n in kv_len:
        hi = np.minimum(min(int(n), sk), pos + 1) if causal else \
            np.full(sq, min(int(n), sk))
        lo = np.maximum(0, pos - window + 1) if window > 0 else 0
        total += int(np.maximum(hi - lo, 0).sum())
    return total


def _sdpa_fn(q, k, v, mask):
    """One SDPA call on the same inputs ([B, H, S, D] views), GQA through
    ``enable_gqa``."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **kw)


FLASH_CASES = {
    # name: (B, Sq, Sk, causal, q_offset, window, kv_len, (Hq, Hkv, D) or
    # None for llama3.2-3b's, q/k/v as column views of one QKV tensor)
    "static prefill": (4, 4096, 4096, True, 0, 0, None, None, False),
    "ragged causal": (4, 1500, 1500, True, 0, 0, None, None, False),
    "kv_len, non-causal": (4, 256, 4096, False, 0, 0, [4096, 3001, 0, 1777],
                           None, False),
    "window, q_offset": (4, 1024, 2048, True, 1024, 512, None, None, False),
    "D 64 (bert-large heads)": (2, 2048, 2048, True, 0, 0, [2048, 1311],
                                (16, 16, 64), False),
    "strided QKV views": (4, 4096, 4096, True, 0, 0, None, None, True),
}


def _flash_inputs(gen, dev, b, sq, sk, hq, hkv, d, strided):
    """q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D] bf16; ``strided`` (Sq =
    Sk): column views of one [B, S, (Hq + 2 Hkv) D] tensor, as
    ``qkv_project`` gives them (row stride 5120 at llama3.2-3b's heads)."""
    if strided:
        qkv = torch.randn((b, sq, (hq + 2 * hkv) * d), generator=gen,
                          device=dev, dtype=torch.bfloat16)
        return (qkv[..., :hq * d].unflatten(-1, (hq, d)),
                qkv[..., hq * d:(hq + hkv) * d].unflatten(-1, (hkv, d)),
                qkv[..., (hq + hkv) * d:].unflatten(-1, (hkv, d)))
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((b, sk, hkv, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    return q, k, torch.randn_like(k)


def _flash_case(gen, dev, name, spec, heads, block_kv):
    """One flash case ``spec`` (a FLASH_CASES value; its heads, or
    ``heads``): within ATTN_ULPS of the plain version run in fp32 on the
    same bf16 inputs, timed beside its bound, the plain version and SDPA
    (events and the profiler's device time)."""
    from repro_torch.kernels.flash_attention import ops, ref
    b, sq, sk, causal, off, win, lens, case_heads, strided = spec
    hq, hkv, d = case_heads or heads
    q, k, v = _flash_inputs(gen, dev, b, sq, sk, hq, hkv, d, strided)
    lens = [sk] * b if lens is None else lens
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len, window=win,
              block_kv=block_kv)
    out = ops.flash_attention(q, k, v, **kw)
    plain, plain_lse = ref.flash_attention_fwd(
        *(t.float().transpose(1, 2) for t in (q, k, v)), kv_len,
        causal=causal, q_offset=off, window=win, block_kv=block_kv,
        return_lse=True)
    plain = plain.transpose(1, 2)
    torch.cuda.synchronize()
    err, ulps = _attn_err(out, plain, f"flash_attention ({name})")
    del plain
    # the training forward's lse beside the same output
    out_l, lse = ops.flash_attention_with_lse(q, k, v, **kw)
    if not torch.equal(out_l, out):
        _fail(f"flash_attention ({name}): the output written beside the "
              "lse differs from the output alone")
    lse_err, lse_ulps, empty = _lse_err(lse, plain_lse, name)
    del out_l, lse, plain_lse
    ms = _time_ms(lambda: ops.flash_attention(q, k, v, **kw), 10)
    ms_lse = _time_ms(lambda: ops.flash_attention_with_lse(q, k, v, **kw),
                      10)
    dev_ms = _profiled_ms(lambda: ops.flash_attention(q, k, v, **kw),
                          ("flash_fwd_kernel",), iters=5)
    plain_ms = _time_ms(lambda: ref.flash_attention_fwd(
        *(t.transpose(1, 2) for t in (q, k, v)), kv_len, causal=causal,
        q_offset=off, window=win, block_kv=block_kv), 3, warmup=1)
    mask = None
    if not (causal and off == 0 and win == 0 and min(lens) == sk):
        pos = torch.arange(sq, device=dev)[:, None] + off
        cols = torch.arange(sk, device=dev)[None]
        mask = (cols[None] < kv_len.long()[:, None, None])[:, None]
        if causal:
            mask = mask & (cols <= pos)
        if win > 0:
            mask = mask & (cols > pos - win)
    sdpa = _sdpa_fn(q, k, v, mask)
    library_ms = _time_ms(sdpa, 10)
    library_device_ms = _profiled_ms(sdpa, ("",), iters=5)
    pairs = _valid_pairs(sq, sk, lens, causal, off, win)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + 4 * b
    bound_ms, bound_by = _bound(nbytes, 4.0 * pairs * hq * d)
    del q, k, v, out
    torch.cuda.empty_cache()
    return {"case": name, "shape": {
        "q": [b, sq, hq, d], "kv": [b, sk, hkv, d], "causal": causal,
        "q_offset": off, "window": win, "kv_len": lens,
        "qkv_views": strided},
        "max_abs_err": err, "tol": ATTN_TOL, "max_err_row_ulps": ulps,
        "lse_max_abs_err": lse_err, "lse_max_ulps": lse_ulps,
        "lse_tol": LSE_TOL, "lse_empty_rows": empty, "ms": ms,
        "ms_with_lse": ms_lse,
        "profiler_device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library_device_ms": library_device_ms, "valid_pairs": pairs}


def _lse_err(lse: torch.Tensor, plain: torch.Tensor, name: str):
    """Hold the kernel's row log-sum-exp to LSE_ULPS fp32 ulps of the plain
    version's max(|lse|, 1), and a row with no valid key (the plain lse at
    the masked score) exactly. Returns the max abs error over the rows
    with a key, the worst in its ulps and the count of empty rows."""
    from repro_torch.kernels.flash_attention import ref
    empty = plain <= 0.5 * ref.NEG_INF
    if not torch.equal(lse[empty], plain[empty]):
        _fail(f"flash_attention ({name}): the lse of a row with no valid key "
              f"is not the plain version's {ref.NEG_INF}")
    keyed = ~empty
    diff = (lse[keyed] - plain[keyed]).abs()
    top = plain[keyed].abs().clamp_min(1.0)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 23)
    err = diff.max().item() if diff.numel() else 0.0
    ulps = (diff / ulp).max().item() if diff.numel() else 0.0
    if not ulps <= LSE_ULPS:
        _fail(f"flash_attention ({name}): lse {ulps} fp32 ulps of max(|lse|, "
              f"1) from the plain version's > {LSE_ULPS} (max abs {err})")
    return err, ulps, int(empty.sum())


def _print_flash(rows):
    print("[flash] " + "; ".join(
        f"{r['case']}: err {r['max_abs_err']:.3e} "
        f"({r['max_err_row_ulps']:.3f} row ulps), lse "
        f"{r['lse_max_abs_err']:.3e} ({r['lse_max_ulps']:.2f} fp32 ulps; "
        f"{r['lse_empty_rows']} empty rows exact; with it "
        f"{r['ms_with_lse']:.4f} ms), "
        f"{r['ms']:.4f} ms (device {r['profiler_device_ms']}), bound "
        f"{r['bound_ms']:.4f} ({r['bound_by']}), plain {r['plain_ms']:.3f}, "
        f"SDPA {r['library_ms']:.4f} (device {r['library_device_ms']})"
        for r in rows))


def check_flash_attention(arch, dev):
    """The flash kernel with block_kv 1024 (attn_chunk, as attention_core
    passes it), at llama3.2-3b's heads (24 query, 8 KV, D 128, bf16): the
    static prefill's shape, then a ragged length, ragged kv_len with an
    empty row, and a window with a q_offset; then at bert-large's heads (16
    and 16, D 64) with a ragged kv_len, and the prefill's shape read from
    column views of one QKV tensor (the TMA descriptors' strides); each
    within ATTN_ULPS of the plain version run in fp32 on the same bf16
    inputs, timed beside its bound, the plain version and SDPA (events and
    the profiler's device time). Returns the prefill shape's row with the
    other cases under ``cases``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    heads = (arch.num_heads, arch.num_kv_heads, arch.resolved_head_dim)
    rows = [_flash_case(gen, dev, name, spec, heads, arch.attn_chunk)
            for name, spec in FLASH_CASES.items()]
    _print_flash(rows)
    main = dict(rows[0])
    main.pop("case")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:64",
            **main, "cases": rows[1:]}


FILTER_ADVERSARIAL = ("ties at the k-th value across a tile edge", "k = 1",
                      "k >= V", "all -inf", "one finite entry",
                      "T clamped to T_FLOOR", "nucleus edge in a dense tail",
                      "top-k off, top-p 0.95")


def _adversarial_filter_rows(v, dev, rng):
    """One row [v] a corner of the filter's search (FILTER_ADVERSARIAL), as
    [8, v] logits with their top_k and top_p."""
    lg = rng.normal(size=(8, v)).astype(np.float32) * 3.0
    top_k = np.full(8, 40, np.int32)
    top_p = np.full(8, 0.95, np.float32)
    lg[0, 100:160] = lg[0].max() - 1.0     # 60 equal values over tile 0/1
    top_k[0] = 20
    top_k[1], top_p[1] = 1, 0.9
    top_k[2], top_p[2] = v + 3, 0.99
    lg[3] = -np.inf
    lg[4] = -np.inf
    lg[4, v // 3] = 2.5
    top_k[4] = 0
    top_k[5], top_p[5] = 0, 1e-40          # top_p * Z below T_FLOOR
    lg[6] = -4.0 + 1e-6 * rng.normal(size=v).astype(np.float32)
    lg[6, :8] = [6.0, 5.5, 5.0, 4.5, 4.0, 3.5, 3.0, 2.5]
    top_k[6], top_p[6] = 0, 0.9
    top_k[7] = 0
    return (torch.as_tensor(lg, device=dev), torch.as_tensor(top_k, device=dev),
            torch.as_tensor(top_p, device=dev))


def check_filter(arch, rng, dev):
    """The top-k / top-p filter bitwise against its plain version (the
    bisection) and the sort-based oracle: the serve's 8 rows at llama's
    padded vocab, their first 4, one row (top-k off, top-p 0.95: the
    search over the whole row), 8 adversarial rows (FILTER_ADVERSARIAL), and
    8 rows at mamba2-1.3b's padded vocab; one device kernel a call. Timed at
    [8, V] beside its bound, its plain version and the sort-based filter;
    device times of every case from the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_sampling import ops, ref
    from repro_torch.models.layers import pad_vocab
    s, v = 8, pad_vocab(arch.vocab_size)
    lg = torch.as_tensor(rng.normal(size=(s, v)).astype(np.float32) * 3.0,
                         device=dev)
    lg[3, :40] = lg[3, 40]                 # ties across the k-th value
    top_k = torch.as_tensor([40, 40, 0, 40, 1, 40, 0, v + 5], dtype=torch.int32,
                            device=dev)
    top_p = torch.as_tensor([0.95, 1.0, 0.95, 0.95, 0.5, 0.95, 1.0, 0.99],
                            dtype=torch.float32, device=dev)
    vm = pad_vocab(get_config("mamba2-1.3b").vocab_size)
    lm = torch.as_tensor(rng.normal(size=(s, vm)).astype(np.float32) * 3.0,
                         device=dev)
    cases = {f"[8, {v}]": (lg, top_k, top_p),
             f"[4, {v}]": (lg[:4], top_k[:4], top_p[:4]),
             f"[1, {v}] top-k off, top-p 0.95": (lg[2:3].contiguous(),
                                                 top_k[2:3], top_p[2:3]),
             f"[8, {v}] adversarial": _adversarial_filter_rows(v, dev, rng),
             f"[8, {vm}] (mamba2-1.3b)": (lm, torch.as_tensor(
                 [40, 40, 0, 40, 1, 40, 0, vm + 5], dtype=torch.int32,
                 device=dev), top_p)}
    device, sizes = {}, {}
    for case, args in cases.items():
        out = ops.filter_logits(*args)
        plain = ref.filter_logits_bisect(*args)
        oracle = ref.filter_logits_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), plain.view(torch.int32)):
            bad = (out.view(torch.int32) != plain.view(torch.int32)).sum(1)
            _fail(f"filter_logits {case} differs from its plain version in "
                  f"{bad.tolist()} entries a row (contract: bitwise equal)")
        if not torch.equal(out.view(torch.int32), oracle.view(torch.int32)):
            _fail(f"filter_logits {case} differs from the sort-based oracle")
        _kernels_a_call(lambda: ops.filter_logits(*args), "filter_logits")
        device[case] = _profiled_ms(lambda: ops.filter_logits(*args),
                                    ("filter_kernel",))
        sizes[case] = ops.cluster_plan(*args[0].shape)
    out = ops.filter_logits(lg, top_k, top_p)
    ms = _time_ms(lambda: ops.filter_logits(lg, top_k, top_p), 20)
    plain_ms = _time_ms(lambda: ref.filter_logits_bisect(lg, top_k, top_p),
                        2, warmup=1)
    library_ms = _time_ms(lambda: ref.filter_logits_ref(lg, top_k, top_p),
                          2, warmup=1)
    bound_ms, bound_by = _bound(2 * lg.numel() * 4 + s * 8, 0.0, fp32=True)
    print("[filter] device ms a call by case (CTAs a row): " + "; ".join(
        f"{c}: {device[c]} ({sizes[c]})" for c in cases) + "; all bitwise "
        "equal to the bisection and the sort-based oracle, one kernel a call")
    return {"name": "filter_logits", "route": "cuda",
            "profiler_device_ms_per_call": device[f"[8, {v}]"],
            "source": "src/repro_torch/kernels/fused_sampling/csrc/"
                      "sampling.cu",
            "replaces": "src/repro/kernels/fused_sampling/kernel.py:73",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms_by_case": device,
            "ctas_a_row_by_case": sizes}, out, lg


# (seed, position) pairs whose uniform is 0 (the first token with mass) and
# 1 - 2^-23, the largest (found by a search over positions at seed 7)
U_ZERO, U_TOP = (7, 20069659), (7, 353642)
DRAW_PARENT_MS = (0.08533, 0.08543)   # PERF.md's draw row before the
                                      # cluster draw: device ms at [8,
                                      # 128256] filtered, two runs


def _draw_keys(s, dev, pos_dtype=torch.int32):
    """Seeds idx + 11 and positions idx * 37, rows 0 and 1 at U_ZERO and
    U_TOP: int64 seeds and ``pos_dtype`` positions, as the engines pass."""
    idx = torch.arange(s, device=dev)
    seeds, pos = idx + 11, (idx * 37).to(pos_dtype)
    for r, (sd, p) in enumerate((U_ZERO, U_TOP)[:s]):
        seeds[r], pos[r] = sd, p
    return seeds, pos


def check_uniforms(dev):
    """The draw kernels' device uniforms (sampling_device.cuh row_uniform)
    bitwise against ``ref.row_uniforms`` over 65,536 (seed, position)
    pairs, 0 and 2^32 - 1 among both, positions int64 and int32."""
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    seeds = torch.randint(0, 2 ** 32, (65536,), generator=gen, device=dev)
    pos = torch.randint(0, 2 ** 32, (65536,), generator=gen, device=dev)
    seeds[:4] = torch.tensor([0, 2 ** 32 - 1, 0, 2 ** 32 - 1])
    pos[:4] = torch.tensor([0, 0, 2 ** 32 - 1, 2 ** 32 - 1])
    seeds[4:6] = torch.tensor([U_ZERO[0], U_TOP[0]])
    pos[4:6] = torch.tensor([U_ZERO[1], U_TOP[1]])
    for p in (pos, pos.to(torch.int32)):      # int32: the low 32 bits
        got = ops.device_row_uniforms(seeds, p)
        want = head_ref.row_uniforms(seeds, p)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            _fail(f"device uniforms ({p.dtype} positions) differ from "
                  f"ref.row_uniforms in {bad} of 65536 pairs (contract: "
                  "bitwise)")
    if not (float(want[4]) == 0.0 and float(want[5]) == 1 - 2 ** -23):
        _fail(f"U_ZERO / U_TOP give {want[4:6].tolist()}")
    print("[uniforms] device threefry2x32 uniforms bitwise equal to "
          "ref.row_uniforms over 65536 (seed, position) pairs, positions "
          "int64 and int32, 0 and 2^32 - 1 in both")


def check_draw(lg_f, lg, dev):
    """The inverse-CDF draw bitwise against its plain version (the plain
    draw of ref.row_uniforms of the same seeds and positions): the filter's
    output rows and the same rows unfiltered at [8, V], 8 adversarial rows
    filtered (FILTER_ADVERSARIAL: an all -inf row, one finite entry among
    them), one row of a single finite entry, [1, V], and 8 filtered rows at
    mamba2-1.3b's V; rows 0 and 1 at uniforms 0 and 1 - 2^-23. One device
    kernel a call; device time of every case from the profiler, beside the
    parent's in PERF.md."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ops
    from repro_torch.models.layers import pad_vocab
    s, v = lg_f.shape
    rng = np.random.default_rng(SEED + 21)
    adv = ops.filter_logits(*_adversarial_filter_rows(v, dev, rng))
    one = torch.full((1, v), -float("inf"), device=dev)
    one[0, v // 3 + 5] = 0.25
    vm = pad_vocab(get_config("mamba2-1.3b").vocab_size)
    lm = torch.as_tensor(rng.normal(size=(s, vm)).astype(np.float32) * 3.0,
                         device=dev)
    lm = ops.filter_logits(lm, torch.full((s,), 40, dtype=torch.int32,
                                          device=dev),
                           torch.full((s,), 0.95, device=dev))
    cases = {f"[8, {v}] filtered": lg_f, f"[8, {v}] unfiltered": lg,
             f"[8, {v}] adversarial, filtered": adv,
             f"[1, {v}] one finite entry": one,
             f"[1, {v}] filtered": lg_f[2:3].contiguous(),
             f"[8, {vm}] filtered (mamba2-1.3b)": lm}
    device, sizes, toks = {}, {}, {}
    for case, x in cases.items():
        seeds, pos = _draw_keys(x.shape[0], dev)
        out = ops.draw_tokens(x, seeds, pos)
        plain = head_ref.draw_tokens(x, head_ref.row_uniforms(seeds, pos))
        torch.cuda.synchronize()
        if not torch.equal(out, plain):
            _fail(f"draw_tokens {case}: {out.tolist()} differs from its "
                  f"plain version {plain.tolist()} (contract: equal tokens)")
        finite = torch.isfinite(x.gather(1, out.long()[:, None]))[:, 0]
        if not bool((finite | ~torch.isfinite(x).any(1)).all()):
            _fail(f"draw_tokens {case} drew a masked-out token")
        _kernels_a_call(lambda: ops.draw_tokens(x, seeds, pos), "draw_tokens")
        device[case] = _profiled_ms(lambda: ops.draw_tokens(x, seeds, pos),
                                    ("draw_kernel",))
        sizes[case] = ops.cluster_plan(*x.shape)
        toks[case] = out.tolist()
    if toks[f"[1, {v}] one finite entry"] != [v // 3 + 5]:
        _fail(f"the one finite entry was not drawn: {toks}")
    seeds, pos = _draw_keys(s, dev)
    ms = _time_ms(lambda: ops.draw_tokens(lg_f, seeds, pos), 200)
    plain_ms = _time_ms(lambda: head_ref.draw_tokens(
        lg_f, head_ref.row_uniforms(seeds, pos)), 5, warmup=1)
    # the row read once, seeds (8 bytes) and positions (4) read and tokens
    # written; about four operations an entry (max, subtract, exp, add)
    bound_ms, bound_by = _bound(lg_f.numel() * 4 + s * (8 + 4 + 4),
                                4.0 * lg_f.numel(), fp32=True)
    main_case = f"[8, {v}] filtered"
    print("[draw] device ms a call by case (CTAs a row): " + "; ".join(
        f"{c}: {device[c]} ({sizes[c]})" for c in cases)
        + f"; bound {bound_ms:.5f} ({bound_by}) at [8, {v}], parent "
        f"(PERF.md, the one-CTA draw) {DRAW_PARENT_MS[0]} / "
        f"{DRAW_PARENT_MS[1]}; all bitwise equal to the plain draw of the "
        "plain uniforms, one kernel a call")
    return {"name": "draw_tokens", "route": "cuda",
            "profiler_device_ms_per_call": device[main_case],
            "source": "src/repro_torch/kernels/fused_sampling/csrc/"
                      "sampling.cu",
            "replaces": "src/repro/kernels/fused_lm_head/ref.py:90",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms_by_case": device, "ctas_a_row_by_case": sizes}


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp (8 significant bits) at each |t|, floored at the
    smallest normal."""
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _norm_times(name, cases):
    """Device ms a call from the profiler, over 50 calls, of the norm
    kernel ``name`` (its DEVICE_NAMES) and of a one-pass yardstick (every
    kernel it launches), for each row count of ``cases`` {rows: (norm,
    one_pass)}; the decode shape's yardstick is ``one_pass_ms``."""
    out = {}
    for r, (f, o) in cases.items():
        out[f"device_ms_{r}_rows"] = _profiled_ms(f, DEVICE_NAMES[name], 50)
        key = "one_pass_ms" if r == 8 else f"one_pass_ms_{r}_rows"
        out[key] = _profiled_ms(o, ("",), 50)
    return out


ONE_PASS_NOTE = ("device time of one torch.add over the same rows: one "
                 "launch and one memory round trip, not the same function")


def check_residual_norm(arch, dev):
    """The fused add + norm (rmsnorm, as llama3.2-3b, and layernorm + bias)
    at the decode shape [8, D], a prefill chunk [64, D], a ragged 300 rows,
    mistral-large's D 12288, and D 3070 and 40000 (the wide variant, the
    second past 48 KB of shared memory): x + y bitwise, the norm within 1
    bf16 ulp of the plain version; one device kernel a call. Device time
    from the profiler at [8, D] and [64, D] beside one torch.add's."""
    from repro_torch.kernels.fused_layernorm import ops, ref
    d = arch.d_model
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    err, out, plans = 0.0, {}, {}
    cases = [(8, d, arch.norm), (64, d, arch.norm), (8, d, "layernorm"),
             (300, d, arch.norm), (300, d, "layernorm"),
             (8, 12288, "rmsnorm"), (8, 12288, "layernorm"),
             (300, 12288, "rmsnorm"), (8, d - 2, "rmsnorm"),
             (8, d - 2, "layernorm"), (2, 40000, "rmsnorm")]
    for rows, dd, kind in cases:
        x = torch.randn((rows, dd), generator=gen, device=dev).bfloat16()
        y = (torch.randn((rows, dd), generator=gen, device=dev)
             * 0.5).bfloat16()
        scale = (1.0 + 0.1 * torch.randn((dd,), generator=gen,
                                         device=dev)).bfloat16()
        bias = (0.1 * torch.randn((dd,), generator=gen,
                                  device=dev)).bfloat16() \
            if kind == "layernorm" else None
        h, x2 = ops.decode_residual_norm(y, x, scale, bias, kind=kind)
        ph, px2 = ref.decode_residual_norm(y, x, scale, bias, kind=kind)
        torch.cuda.synchronize()
        if not torch.equal(x2.view(torch.int16), px2.view(torch.int16)):
            _fail(f"decode_residual_norm [{rows}, {dd}] {kind}: x + y is not "
                  "bitwise equal to the plain version")
        diff = (h.float() - ph.float()).abs()
        if not bool((diff <= _bf16_ulp(ph)).all()):
            _fail(f"decode_residual_norm [{rows}, {dd}] {kind}: norm differs "
                  f"by more than 1 bf16 ulp (max abs {diff.max().item()})")
        err = max(err, diff.max().item())
        plans[f"[{rows}, {dd}]"] = ops.norm_plan(rows, dd)
        if kind == arch.norm and dd == d:
            out[rows] = (y, x, scale)
    for rows in (8, 300):
        y, x, scale = out[rows]
        _kernels_a_call(lambda: ops.decode_residual_norm(
            y, x, scale, kind=arch.norm), "decode_residual_norm")
    print(f"[residual_norm] {len(cases)} cases within 1 bf16 ulp, x + y "
          f"bitwise, one kernel a call; plans (threads, vectors a thread, "
          f"CTAs a row; 0 vectors: the wide variant): {plans}")
    times = {rows: _time_ms(lambda: ops.decode_residual_norm(
        y, x, scale, kind=arch.norm), 200)
        for rows, (y, x, scale) in out.items() if rows in (8, 64)}
    device = _norm_times("decode_residual_norm", {
        rows: ((lambda y=y, x=x, s=s: ops.decode_residual_norm(
            y, x, s, kind=arch.norm)), (lambda y=y, x=x: torch.add(x, y)))
        for rows, (y, x, s) in out.items() if rows in (8, 64)})
    y, x, scale = out[8]
    plain_ms = _time_ms(lambda: ref.decode_residual_norm(
        y, x, scale, kind=arch.norm), 200)
    bound_ms, bound_by = _bound(4 * 8 * d * 2 + d * 2, 4.0 * 8 * d,
                                fp32=True)
    bound_64, _ = _bound(4 * 64 * d * 2 + d * 2, 4.0 * 64 * d, fp32=True)
    return {"name": "decode_residual_norm", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_layernorm/csrc/"
                      "residual_norm.cu",
            "replaces": "src/repro/kernels/fused_layernorm/kernel.py:85",
            "max_abs_err": err, "tol": "1 bf16 ulp of each output; x + y "
                                      "bitwise",
            "ms": times[8], "ms_64_rows": times[64], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_64_rows": bound_64, "library_ms": None,
            "library_note": "no single PyTorch call adds and normalizes",
            **device, "one_pass_note": ONE_PASS_NOTE, "plans": plans}


def _exact_head_inputs(arch, dev, gen):
    """x [16, D] on k/8 and W [V, D] on k/64, |k| <= 8: every partial sum of
    a logit is a multiple of 2^-9 below 2^9, exact in fp32 in any order.
    W[:, 0] = 1/64 > 0 so rows 4 (x[4, 0] = +inf) and 5 (x[5, 0] = -inf)
    have all-infinite logits; rows 126-130 copy row 1's argmax row, a
    6-way tie at row 1's top that crosses the 128-lane tile edge."""
    from repro_torch.models.layers import pad_vocab
    v, d = pad_vocab(arch.vocab_size), arch.d_model
    w = torch.randint(-8, 9, (v, d), generator=gen, device=dev,
                      dtype=torch.int8).to(torch.bfloat16) / 64
    x = torch.randint(-8, 9, (16, d), generator=gen, device=dev,
                      dtype=torch.int8).to(torch.bfloat16) / 8
    w[:, 0] = 1.0 / 64
    top = int((x[1:2].float() @ w.float().T).argmax())
    w[126:131] = w[top]
    x[4, 0], x[5, 0] = float("inf"), float("-inf")
    return x, w, top


def check_head_tokens(arch, dev, untied: bool = False):
    """The fused LM head at ``arch``'s width and padded vocab against its
    plain version (cuBLAS bf16 GEMM with fp32 reduction, then the plain
    epilogue) on exact-arithmetic inputs: tokens and probe bitwise for
    greedy, temperature-only and filtered steps, at 8 rows (the serve's
    slots) and 16 (two row groups of the GEMV). Then random bf16 inputs:
    greedy tokens equal on every row whose plain top-2 margin exceeds 2
    bf16 ulps of the largest |logit|. Run for llama3.2-3b (D 3072, V
    128256) and for mamba2-1.3b (D 2048, V 50304), whose cluster epilogue
    splits a row into narrower slices; with ``untied``, the same inputs
    with the weight laid out as an untied head [D, V] (its own GEMV,
    ``head_gemv_wgmma_kernel`` on ``ops.untied_plan``), for
    deepseek-moe-16b (D 2048, V 102400), internlm2-1.8b (V 92544) and
    jamba-v0.1-52b (D 4096, V 65536), also at 24 rows (a group of 16 and a
    ragged one of 8) and, for deepseek, at V 102384 (a ragged last tile),
    greedy and filtered; then the random-input bf16 workspace and partials
    of two calls bitwise equal (no atomics, a fixed summation order)."""
    from repro_torch.kernels.fused_lm_head import ops, ref
    from repro_torch.kernels.fused_sampling import ops as samp_ops
    from repro_torch.models.layers import unembed
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x, w, top = _exact_head_inputs(arch, dev, gen)
    d, v = x.shape[1], w.shape[0]
    kname = "head_tokens_untied" if untied else "head_tokens"

    def layout(w):
        """The weight as the call under test takes it."""
        return w.T.contiguous() if untied else w

    def plain_logits(x, wk):
        return unembed({"head": wk}, x, None) if untied else unembed({}, x, wk)
    wk = layout(w)
    idx = torch.arange(16, device=dev)
    seeds, pos = _draw_keys(16, dev)
    temps = torch.tensor([0.0, 1.0, 0.8, 1.0, 0.0, 1.0, 1.3, 0.7,
                          1.0, 0.0, 0.9, 1.0, 0.6, 1.0, 0.0, 1.2], device=dev)
    top_k = torch.tensor([0, 3, 40, 0, 0, 40, 1, v + 5,
                          40, 0, 5, 0, 40, 1, 0, 100], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 0.95, 0.95, 1.0, 1.0, 0.9, 1.0, 0.5,
                          0.95, 1.0, 0.8, 0.9, 1.0, 1.0, 1.0, 0.7],
                         device=dev)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    lines = []

    def exact_case(s, sel, wk, sampled, filtered, label=""):
        """Tokens and probe of rows ``sel`` bitwise the plain version's."""
        xs, sd, ps, tm, tk, tp = (t[sel].contiguous() for t in (
            x, seeds, pos, temps, top_k, top_p))
        tok, ok = ops.head_tokens(xs, wk, sd, ps, tm, tk, tp,
                                  sampled=sampled, filtered=filtered,
                                  untied=untied)
        ptok, pok = ref.head_tokens(xs, wk, ref.row_uniforms(sd, ps), tm,
                                    tk, tp, sampled=sampled,
                                    filtered=filtered, untied=untied)
        torch.cuda.synchronize()
        if not (torch.equal(tok, ptok) and torch.equal(ok, pok)):
            _fail(f"head_tokens {arch.name} S={s}{label} (sampled={sampled}, "
                  f"filtered={filtered}) tokens {tok.tolist()} ok "
                  f"{ok.tolist()} differ from the plain version's "
                  f"{ptok.tolist()} {pok.tolist()} (contract: bitwise on "
                  "exact-arithmetic inputs)")
        lines.append(f"S={s}{label} sampled={sampled} filtered={filtered}: "
                     f"{tok.tolist()}")
        return tok, ok
    # 16 rows: two groups of the tied GEMV, one of the untied; row 11 alone
    # (top-k off, top-p 0.9: the nucleus search over the whole row); the
    # serve's 8 rows last
    for s, sel in ((16, slice(0, 16)), (1, slice(11, 12)), (8, slice(0, 8))):
        for sampled, filtered in ((False, False), (True, False),
                                  (True, True)):
            tok, ok = exact_case(s, sel, wk, sampled, filtered)
        if s > 1 and (ok[4] or ok[5] or not ok[[i for i in range(s)
                                                if i not in (4, 5)]].all()):
            _fail(f"head_tokens probe {ok.tolist()}: rows 4 and 5 must be "
                  "non-finite, the rest finite")
    if untied:
        # 24 rows: a group of 16 and a ragged one of 8 (W read twice); for
        # deepseek also V 102384, whose last 64-column tile is ragged
        rows24 = list(range(16)) + [0, 1, 2, 3, 6, 7, 8, 9]
        for sampled, filtered in ((False, False), (True, True)):
            exact_case(24, rows24, wk, sampled, filtered)
        if v == 102400:
            w_r = wk[:, :102384].contiguous()
            for s, sel in ((8, slice(0, 8)), (24, rows24)):
                for sampled, filtered in ((False, False), (True, True)):
                    exact_case(s, sel, w_r, sampled, filtered, " V=102384")
            del w_r
    s = 8                                  # the serve's rows, timed below
    if tok[4] != 0 or tok[5] != 0 or int(tok[1]) not in (top, 126, 127, 128,
                                                         129, 130):
        _fail(f"head_tokens corners: row 4 (all +inf, greedy) and row 5 "
              f"(all -inf, masked) must give 0, row 1 a tied top token; got "
              f"{tok.tolist()}")

    # random full-width bf16 inputs (the weight buffer is reused)
    w.normal_(0.0, 0.02, generator=gen)
    del wk
    wk = layout(w)
    if untied:
        del w
    xr = torch.randn((16, d), generator=gen, device=dev).bfloat16()
    rargs16 = (xr, wk, seeds, pos, temps, top_k, top_p)
    xr, seeds, pos, temps, top_k, top_p = (t[:s] for t in (
        xr, seeds, pos, temps, top_k, top_p))
    rargs = (xr, wk, seeds, pos, temps, top_k, top_p)
    tok, _ = ops.head_tokens(*rargs, sampled=False, filtered=False,
                             untied=untied)
    logits = plain_logits(xr, wk)
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * _bf16_ulp(
        logits.abs().max(dim=-1).values)
    same = tok == logits.argmax(dim=-1).int()
    if not bool(same[clear].all()):
        _fail(f"head_tokens greedy tokens {tok.tolist()} differ from the "
              f"plain argmax on rows with a clear top-2 margin "
              f"({clear.tolist()})")
    lines.append(f"random bf16: {int(clear.sum())} of {s} rows with top-2 "
                 f"margin > 2 bf16 ulps, all equal; {int(same.sum())} of {s}"
                 " equal in all")

    head = functools.partial(ops.head_tokens, untied=untied)
    plan = None
    if untied:
        # the bf16 workspace and the partials of two calls bitwise equal
        plan = ops.untied_plan(s, d, v, ops.sm_count(dev.index or 0))
        outs = []
        for _ in range(2):
            tk_ = torch.empty((s,), dtype=torch.int32, device=dev)
            ok_ = torch.empty((s,), dtype=torch.bool, device=dev)
            outs.append(ops._launch(xr, wk, seeds, pos, 0, temps, top_k,
                                    top_p, tk_, ok_, True, True,
                                    samp_ops.cluster_plan(s, v),
                                    untied=True))
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b)
                   for a, b in zip(*outs)):
            _fail(f"head_tokens {arch.name}: the untied GEMV's workspace or "
                  "partials differ between two calls on the same inputs")
        lines.append("random bf16 workspace and partials bitwise equal "
                     "across two calls")
        del outs
    _kernels_a_call(lambda: head(*rargs, sampled=True, filtered=True), kname)
    device = {step: _profiled_ms(lambda: head(
        *rargs, sampled=sampled, filtered=filtered), DEVICE_NAMES[kname])
        for step, sampled, filtered in (("filtered", True, True),
                                        ("sampled", True, False),
                                        ("greedy", False, False))}
    device["filtered epilogue"] = _profiled_ms(lambda: head(
        *rargs, sampled=True, filtered=True), ("head_epilogue_kernel",))
    # no call reads W [V, D] in less than its bytes take
    w_ms = _bound(v * d * 2, 0.0)[0]
    if untied:
        device["greedy GEMV"] = _profiled_ms(lambda: head(
            *rargs, sampled=False, filtered=False), (UNTIED_GEMV,),
            floor_ms=w_ms)
        device["greedy GEMV 16 rows"] = _profiled_ms(lambda: head(
            *rargs16, sampled=False, filtered=False), (UNTIED_GEMV,),
            floor_ms=w_ms)
    ms = _time_ms(lambda: head(*rargs, sampled=True, filtered=True), 20)
    ms_greedy = _time_ms(lambda: head(*rargs, sampled=False,
                                      filtered=False), 20)
    ms_16 = _time_ms(lambda: head(*rargs16, sampled=True, filtered=True), 20)
    plain_ms = _time_ms(lambda: ref.head_tokens(
        xr, wk, ref.row_uniforms(seeds, pos), temps, top_k, top_p,
        sampled=True, filtered=True, untied=untied), 3, warmup=1)
    library = (lambda: torch.matmul(xr, wk)) if untied else \
        (lambda: torch.matmul(xr, wk.T))
    library_ms = _time_ms(library, 20)
    library_device_ms = _profiled_ms(library, ("",), 20, floor_ms=w_ms)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))

    def unfused_head():
        lg = plain_logits(xr, wk)
        torch.argmax(lg, dim=-1)
        torch.isfinite(lg).all(dim=-1)
        samp_ops.draw_tokens(samp_ops.filter_logits(lg / safe_t[:, None],
                                                    top_k, top_p), seeds, pos)
    unfused_ms = _time_ms(unfused_head, 20)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    wshape = f"[{d}, {v}] (untied head)" if untied else f"[{v}, {d}]"
    print(f"[head_tokens] {arch.name} x [{s}, {d}], W {wshape}: "
          + "; ".join(lines))
    if untied:
        sizes = [b - a for a, b in plan.ranges]
        print(f"[head_tokens] {arch.name} untied GEMV plan at S={s}: "
              f"{plan.ctas} CTAs of {min(sizes)}-{max(sizes)} tiles of 64 "
              f"(busiest {max(sizes) / (sum(sizes) / len(sizes)):.4f}x the "
              f"mean), panel {plan.panel} x {ops.UNTIED_BK} K rows, "
              f"{plan.rows} rows a group ({len(plan.groups)} group), "
              f"{plan.stages} stages, {plan.smem_bytes} B shared; device ms: "
              f"GEMV {_ms(device['greedy GEMV'])} (16 rows "
              f"{_ms(device['greedy GEMV 16 rows'])}), greedy "
              f"{_ms(device['greedy'])}, filtered {_ms(device['filtered'])}; "
              f"torch.matmul {_ms(library_device_ms)}")
    # W and x read once; seeds (8 bytes), positions, temps, top_k, top_p
    # (4 each) read; tokens and the probe written
    nbytes = v * d * 2 + s * d * 2 + s * 24 + s * 4 + s
    bound_ms, bound_by = _bound(nbytes, 2.0 * s * v * d)
    return {"name": "head_tokens (untied head)" if untied else "head_tokens",
            "route": "cuda",
            "source": "src/repro_torch/kernels/fused_lm_head/csrc/"
                      "head_tokens.cu",
            "replaces": "src/repro/kernels/fused_lm_head/kernel.py:64",
            "shape": f"x [{s}, {d}], W {wshape} bf16 ({arch.name})",
            "max_abs_err": 0.0, "ms": ms, "ms_greedy": ms_greedy,
            "ms_16_rows": ms_16,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "library_note": ("torch.matmul of x [8, D] by the [D, V] head "
                             "(the GEMV only)" if untied else
                             "torch.matmul of x [8, D] by the [V, D] weight "
                             "transposed"),
            "unfused_head_ms": unfused_ms,
            "profiler_device_ms_by_step": device,
            "ctas_a_row": samp_ops.cluster_plan(s, v),
            **({"plan": {k: getattr(plan, k) for k in (
                "tile", "panel", "rows", "ctas", "stages",
                "smem_bytes")} | {"bk": ops.UNTIED_BK, "tiles_a_cta": [
                    min(b - a for a, b in plan.ranges),
                    max(b - a for a, b in plan.ranges)]}}
               if untied else {}),
            "random_rows_clear_margin": int(clear.sum())}


def check_gated_rmsnorm(arch, dev):
    """The mamba mixer's gated RMSNorm at mamba2's width C = inner: the
    decode shape [8, C], a prefill chunk [64, C], one row and a ragged 300
    rows, then jamba's C 8192 at 8 and 300 rows, z read in place as columns
    [0, C) of an in_proj output row as the layer gives it. Every output
    within 1 bf16 ulp of the row's largest |output| of the plain version
    (the kernel's statistics sum in another order); one device kernel a
    call. Then two wide rows that need the shared-memory opt-in: C 32768
    (64 KB) and the wrapper's largest C; one C past it must be refused.
    Device time from the profiler at [8, C] and [64, C] beside one
    torch.add's."""
    from repro_torch.kernels.fused_layernorm import ops, ref
    from repro_torch.models import ssm
    import torch.nn.functional as F
    c = ssm.inner_dim(arch)
    extra = 2 * arch.ssm.ngroups * arch.ssm.state_dim + ssm.num_ssm_heads(arch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    err, same, total, keep, plans = 0.0, 0, 0, {}, {}
    for rows, cc in ((8, c), (64, c), (1, c), (300, c), (8, 8192),
                     (300, 8192)):
        sc = (1.0 + 0.1 * torch.randn((cc,), generator=gen,
                                      device=dev)).bfloat16()
        zx = (2.0 * torch.randn((rows, 2 * cc + extra), generator=gen,
                                device=dev)).bfloat16()
        y = torch.randn((rows, cc), generator=gen, device=dev).bfloat16()
        z = zx[:, :cc]
        out = ops.gated_rmsnorm(y, z, sc)
        plain = ref.gated_rmsnorm(y, z, sc)
        torch.cuda.synchronize()
        diff = (out.float() - plain.float()).abs()
        tol = _bf16_ulp(plain.float().abs().amax(dim=-1, keepdim=True))
        if not bool((diff <= tol).all()):
            _fail(f"gated_rmsnorm [{rows}, {cc}]: differs from its plain "
                  f"version by more than 1 bf16 ulp of the row's largest "
                  f"|output| (max abs {diff.max().item()})")
        err = max(err, diff.max().item())
        same += int((out.view(torch.int16) == plain.view(torch.int16)).sum())
        total += out.numel()
        plans[f"[{rows}, {cc}]"] = ops.norm_plan(rows, cc, True)
        if cc == c:
            keep[rows] = (y, z, sc)
    for rows in (8, 300):
        y, z, sc = keep[rows]
        _kernels_a_call(lambda: ops.gated_rmsnorm(y, z, sc), "gated_rmsnorm")
    scale = keep[8][2]
    for wide in (32768, ops._GATED_MAX_C):
        y, z = torch.randn((2, 2, wide), generator=gen, device=dev).bfloat16()
        sc = scale.repeat(wide // c + 1)[:wide].contiguous()
        diff = (ops.gated_rmsnorm(y, z, sc).float()
                - ref.gated_rmsnorm(y, z, sc).float()).abs()
        tol = _bf16_ulp(ref.gated_rmsnorm(y, z, sc).float().abs()
                        .amax(dim=-1, keepdim=True))
        if not bool((diff <= tol).all()):
            _fail(f"gated_rmsnorm [2, {wide}]: differs from its plain "
                  f"version by more than 1 bf16 ulp of the row's largest "
                  f"|output| (max abs {diff.max().item()})")
        plans[f"[2, {wide}]"] = ops.norm_plan(2, wide, True)
    try:
        big = torch.zeros((1, ops._GATED_MAX_C + 8), dtype=torch.bfloat16,
                          device=dev)
        ops.gated_rmsnorm(big, big, big[0])
        _fail(f"gated_rmsnorm took C = {ops._GATED_MAX_C + 8}, past its "
              "shared row")
    except ValueError:
        pass
    print(f"[gated_rmsnorm] 8 cases within 1 bf16 ulp of the row's largest "
          f"|output|, one kernel a call, C {ops._GATED_MAX_C + 8} refused; "
          f"plans (threads, vectors a thread, CTAs a row; 0 vectors: the "
          f"wide variant): {plans}")
    times = {rows: _time_ms(lambda: ops.gated_rmsnorm(y, z, sc), 200)
             for rows, (y, z, sc) in keep.items() if rows != 300}
    device = _norm_times("gated_rmsnorm", {
        rows: ((lambda y=y, z=z, s=s: ops.gated_rmsnorm(y, z, s)),
               (lambda y=y, z=z: torch.add(y, z)))
        for rows, (y, z, s) in keep.items() if rows in (8, 64)})
    y, z, scale = keep[8]
    plain_ms = _time_ms(lambda: ref.gated_rmsnorm(y, z, scale), 200)
    gated = y * (z * torch.sigmoid(z))
    library_ms = _time_ms(lambda: F.rms_norm(gated, (c,), scale, 1e-5), 200)
    # per element: exp, add, divide, 3 products, square-add, 2 products
    bound_ms, bound_by = _bound(3 * 8 * c * 2 + c * 2, 9.0 * 8 * c,
                                fp32=True)
    bound_64, _ = _bound(3 * 64 * c * 2 + c * 2, 9.0 * 64 * c, fp32=True)
    return {"name": "gated_rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_layernorm/csrc/"
                      "gated_rmsnorm.cu",
            "replaces": "src/repro/kernels/fused_layernorm/kernel.py:127",
            "max_abs_err": err,
            "tol": "1 bf16 ulp of the row's largest |output|",
            "bitwise_equal_share": same / total,
            "ms": times[8], "ms_64_rows": times[64], "ms_1_row": times[1],
            "profiler_device_ms_per_call": device["device_ms_8_rows"],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_64_rows": bound_64,
            "library_ms": library_ms,
            "library_note": "F.rms_norm of a precomputed bf16 gated product: "
                            "the norm only, not the gate",
            **device, "one_pass_note": ONE_PASS_NOTE, "plans": plans}


# ---------------------------------------------------------------- phase 4 ---
def dense_reference_logits(model, tokens):
    """Plain dense forward (naive causal attention, no pages, no kernels)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_mlp, apply_norm, dense
    arch = model.arch
    x = model._embed(tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for blk in model.params["blocks"]:
        h = apply_norm(arch.norm, blk["ln1"], x)
        q, k, v = attn.qkv_project(arch, blk["attn"], h)
        q, k = attn.position_encode(arch, q, k, pos)
        o = attn.naive_attention(q, k, v, causal=True)
        x = x + dense(o.reshape(*x.shape[:2], -1), blk["attn"]["wo"],
                      blk["attn"].get("bo"))
        x = x + apply_mlp(arch.mlp, blk["mlp"],
                          apply_norm(arch.norm, blk["ln2"], x))
    return model._logits(x[:, -1:])[0, 0]


def check_model_logits(model, rng, dev) -> float:
    """The final prefill chunk's logits (positions 0-109 in chunks of 64),
    then four decode steps (positions 110-113, across the page edge at 112,
    beside an empty slot as the engine runs idle slots), each against the
    dense plain forward of the same prefix, through the unfused and the
    fused layer bodies (each with its own pools). Returns the largest max
    abs logit error."""
    from repro_torch.models import transformer as tf
    arch = model.arch
    blocks = model.params["blocks"]
    n_pre, n_dec, page = 110, 4, 16
    toks = torch.as_tensor(rng.integers(5, arch.vocab_size,
                                        (1, n_pre + n_dec)), device=dev)
    with torch.inference_mode():
        refs = [dense_reference_logits(model, toks[:, :n + 1])
                for n in range(n_pre - 1, n_pre + n_dec)]
        got = {}
        for fused in (False, True):
            pools = tf.init_serving_state(arch, 9, page, 2, model.dtype, dev)
            row = torch.arange(1, 9, dtype=torch.int32, device=dev)
            chunk = torch.zeros((1, 64), dtype=torch.long, device=dev)
            for start in (0, 64):
                end = min(start + 64, n_pre)
                chunk.zero_()
                chunk[0, :end - start] = toks[0, start:end]
                x = tf.paged_prefill_stack(arch, blocks, pools,
                                           model._embed(chunk), row, start,
                                           end, fused=fused)
            out = [model._logits(tf.chunk_final_hidden(x, 64, n_pre))[0, 0]]
            table = torch.zeros((2, 8), dtype=torch.int32, device=dev)
            table[0] = row
            for pos in range(n_pre, n_pre + n_dec):
                tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
                tok[0, 0] = toks[0, pos]
                sl = torch.tensor([pos, 0], dtype=torch.int32, device=dev)
                x = tf.paged_decode_stack(arch, blocks, pools,
                                          model._embed(tok), table, sl,
                                          fused=fused)
                out.append(model._logits(x)[0, 0])
            got[fused] = out
    worst, lines = 0.0, []
    for fused, out in got.items():
        for i, (g, r) in enumerate(zip(out, refs)):
            if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
                _fail("non-finite logits in the model check")
            rel = ((g - r).norm() / r.norm()).item()
            err = (g - r).abs().max().item()
            top2 = torch.topk(r, 2).values
            worst = max(worst, err)
            lines.append(f"{'fused' if fused else 'unfused'} "
                         f"{'prefill' if i == 0 else 'decode'} pos "
                         f"{n_pre - 1 + i}: rel L2 {rel:.3e}, max abs "
                         f"{err:.3e}, argmax equal "
                         f"{int(g.argmax()) == int(r.argmax())}, ref top-2 "
                         f"margin {(top2[0] - top2[1]).item():.3e}")
            if not rel <= 0.05:
                _fail(f"model logits rel L2 error {rel} > 0.05 at position "
                      f"{n_pre - 1 + i} (bf16, 28 layers, fused={fused})")
    print(f"[model] {arch.name} {arch.num_layers}L logits via the paged "
          f"kernels vs dense plain forward (bf16, tol rel L2 0.05): "
          + "; ".join(lines))
    return worst


# ---------------------------------------------------------------- phase 5 ---
def trace(arch, seed):
    """The serving trace: 8 requests, prompts of 128-512 tokens (4 sharing
    a 100-token prefix), 32 new tokens, half greedy and half sampled."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(seed)
    n_req, gen = 8, 32
    shared = list(map(int, rng.integers(5, arch.vocab_size, 100)))
    lens = rng.integers(128, 513, n_req)
    lens[0], lens[2] = 137, max(int(lens[2]), 200)
    prompts = []
    for i in range(n_req):
        tail = list(map(int, rng.integers(5, arch.vocab_size, int(lens[i]))))
        prompts.append((shared + tail)[:int(lens[i])] if i < 4 else tail)
    # request 2 continues request 0's whole prompt, whose last page is
    # partial: its admission shares 8 full pages and copies the 9th (CoW)
    prompts[2] = (prompts[0] + prompts[2])[:int(lens[2])]
    return [Request(uid=i, prompt=prompts[i], max_new_tokens=gen,
                    sampling=SamplingParams() if i % 2 == 0 else
                    SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                   seed=seed + i))
            for i in range(n_req)]


def make_engine(model, fused: bool):
    from repro_torch.serving import ContinuousEngine
    return ContinuousEngine(model, num_slots=8, num_pages=320, page_size=16,
                            max_seq_len=512 + 32 + 16, prefill_chunk=64,
                            fused_decode=fused)


def _counters():
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.fused_layernorm import ops as ln_ops
    from repro_torch.kernels.fused_lm_head import ops as head_ops
    from repro_torch.kernels.fused_sampling import ops as samp_ops
    return (attn_ops.LAUNCHES, samp_ops.LAUNCHES, ln_ops.LAUNCHES,
            head_ops.LAUNCHES, flash_ops.LAUNCHES)


def _snapshot():
    return {k: v for d in _counters() for k, v in d.items()}


def _counted(into: dict, fn):
    """``fn`` wrapped to add the launches each call makes to ``into``."""
    def run(*args, **kw):
        before = _snapshot()
        out = fn(*args, **kw)
        for k, v in _snapshot().items():
            into[k] += v - before[k]
        return out
    return run


EAGER_UNIFORMS = {"calls": 0}   # plain row_uniforms calls on card tensors
PROFILE_PARENT_LAUNCHES = (206151, 206591)   # PERF.md §5: the fused llama
                                             # profile with the eager
                                             # threefry, two runs


def _count_eager_uniforms():
    """Replace ``fused_lm_head.ref.row_uniforms`` with a wrapper that
    counts its calls on card tensors in EAGER_UNIFORMS (each one the
    threefry in eager int64 tensor ops, some 350 launches); returns the
    plain function, to be put back."""
    from repro_torch.kernels.fused_lm_head import ref
    plain = ref.row_uniforms

    def counted(seeds, positions):
        if seeds.device.type == "cuda":
            EAGER_UNIFORMS["calls"] += 1
        return plain(seeds, positions)
    ref.row_uniforms = counted
    return plain


def _device_launches(fn, calls: int = 4) -> float:
    """Device kernel records a call of ``fn``, over ``calls`` calls under
    torch.profiler (made once before, outside the window); a window with
    none, as the profiler delivers now and then, is taken again, up to
    five times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n / calls
    return 0.0


def check_sampled_step_launches(model):
    """What a sampled step's token selection launches on the card, by the
    profiler at the serve's 8 rows: the plain (eager) row_uniforms alone,
    the unfused sampler (sample_tokens, filtered) and the fused head
    (head_tokens, filtered). Fails unless each selection launches fewer
    kernels than the eager threefry alone, and unless no serve so far
    called the eager threefry on the card (EAGER_UNIFORMS)."""
    from repro_torch.kernels.fused_lm_head import ops as head_ops
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.serving.sampling import sample_tokens
    dev, emb = model.device, model.params["embed"]["embedding"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    seeds, pos = _draw_keys(8, dev)
    logits = 3 * torch.randn((8, emb.shape[0]), generator=gen, device=dev)
    x = torch.randn((8, emb.shape[1]), generator=gen, device=dev).bfloat16()
    temps = torch.full((8,), 0.8, device=dev)
    tk = torch.full((8,), 40, dtype=torch.int32, device=dev)
    tp = torch.full((8,), 0.95, device=dev)
    calls = EAGER_UNIFORMS["calls"]
    counts = {
        "eager row_uniforms": _device_launches(
            lambda: head_ref.row_uniforms(seeds, pos)),
        "unfused sampler": _device_launches(lambda: sample_tokens(
            logits, seeds, pos, temps, tk, tp, filtered=True)),
        "fused head": _device_launches(lambda: head_ops.head_tokens(
            x, emb, seeds, pos, temps, tk, tp, sampled=True,
            filtered=True))}
    EAGER_UNIFORMS["calls"] = calls          # the probe's own calls above
    eager = counts["eager row_uniforms"]
    if not all(0 < counts[k] < eager for k in ("unfused sampler",
                                               "fused head")):
        _fail(f"a sampled selection launches no kernel, or as many as the "
              f"eager threefry: {counts}")
    if EAGER_UNIFORMS["calls"]:
        _fail(f"the serves called the eager row_uniforms on the card "
              f"{EAGER_UNIFORMS['calls']} times")
    print(f"[eager uniforms] device launches of one call at 8 rows: "
          f"{counts}; the serves' calls of the eager row_uniforms on the "
          f"card: {EAGER_UNIFORMS['calls']}")
    return counts


PATH_KERNELS = {False: ("paged_decode_attention", "paged_prefill_attention",
                        "filter_logits", "draw_tokens"),
                True: ("paged_decode_attention", "paged_prefill_attention",
                       "decode_residual_norm", "head_tokens")}


def serve(model, logit_err: float, fused: bool, reqs=None):
    """Serve the trace (or ``reqs``, a shorter one) with every launch
    counter set to 0 just before the run; count launches per decode step
    and per prefill chunk. Unfused: probe the logits for finiteness and
    count the decoded rows whose top-2 logit margin is below
    ``logit_err``. Fused: the head returns no logits, so probe its
    all-finite flag on live rows. The whole trace must hit the prefix
    cache and copy a page on write."""
    arch = model.arch
    whole = reqs is None
    reqs = trace(arch, SEED) if whole else reqs
    n_req, gen = len(reqs), reqs[0].max_new_tokens
    engine = make_engine(model, fused)
    if engine.fused_decode != fused:
        _fail(f"engine fused_decode={engine.fused_decode}, asked {fused}: "
              f"{engine.fused_decode_off_reason}")
    finite, margins, last = [], [], {}
    phase = {"decode": dict.fromkeys(_snapshot(), 0),
             "prefill": dict.fromkeys(_snapshot(), 0)}
    flagged = {"sampled": 0, "filtered": 0}
    logits_fn, head_fn = model._logits, engine._fused_head
    decode_fn, prefill_fn = engine._decode, engine._prefill

    def probed_logits(x):
        out = logits_fn(x)
        finite.append(torch.isfinite(out).all())
        last["logits"] = out
        return out

    def probed_head(*args, **kw):
        tok, ok = head_fn(*args, **kw)
        last["ok"] = ok
        return tok, ok

    def decode(page_table, seq_lens, tokens, sampling_args, *, sampled,
               filtered):
        out = _counted(phase["decode"], decode_fn)(
            page_table, seq_lens, tokens, sampling_args, sampled=sampled,
            filtered=filtered)
        flagged["sampled"] += bool(sampled)
        flagged["filtered"] += bool(filtered)
        live = np.flatnonzero(seq_lens > 0)
        if fused:
            finite.append(last["ok"][torch.as_tensor(
                live, device=last["ok"].device)].all())
        else:
            rows = torch.as_tensor(live, device=last["logits"].device)
            top2 = torch.topk(last["logits"][rows, 0].float(), 2,
                              dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
        return out

    def prefill(*args, final, **kw):
        out = _counted(phase["prefill"], prefill_fn)(*args, final=final,
                                                     **kw)
        if fused and final:
            finite.append(last["ok"][0])
        return out

    if not fused:
        model._logits = probed_logits
    engine._fused_head = probed_head
    engine._decode, engine._prefill = decode, prefill
    for d in _counters():
        for k in d:
            d[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _snapshot()
    model.__dict__.pop("_logits", None)     # no model -> method -> model cycle
    for i in range(n_req):
        r = res.get(i)
        if r is None or "error" in r or len(r["tokens"]) != gen:
            _fail(f"request {i} did not finish: {r}")
    if not all(bool(f) for f in finite):
        _fail("non-finite logits during serving")
    if whole and (engine.cow_copies < 1 or engine.cached_prefill_tokens < 1):
        _fail("the shared-prefix trace did not hit the prefix cache / CoW")
    for name in PATH_KERNELS[fused]:
        if launches[name] <= 0:
            _fail(f"kernel {name} was not launched on the "
                  f"{'fused' if fused else 'unfused'} path")
    if fused:
        want = {"decode_residual_norm":
                arch.num_layers * (engine.steps + engine.prefill_chunks),
                "head_tokens": engine.steps + engine.prefills}
        for name, n in want.items():
            if launches[name] != n:
                _fail(f"{name}: {launches[name]} launches, expected {n} "
                      "(one per layer per decode step and prefill chunk; "
                      "one head per decode step and final chunk)")
        for name in ("filter_logits", "draw_tokens"):
            if launches[name]:
                _fail(f"the fused path launched {name}")
    ntok = sum(len(r["tokens"]) for r in res.values())
    ttft = float(np.mean([res[i]["token_times"][0] for i in range(n_req)]))
    print(f"[serve] {'fused' if fused else 'unfused'} decode, {arch.name} "
          f"{arch.num_layers}L d{arch.d_model} bf16: "
          f"{n_req} requests x {gen} tokens in {wall:.3f}s "
          f"({ntok / wall:.1f} tok/s, mean TTFT {ttft * 1e3:.1f} ms); "
          f"steps {engine.steps} ({flagged['sampled']} sampled, "
          f"{flagged['filtered']} filtered), prefills {engine.prefills}, "
          f"prefill chunks {engine.prefill_chunks}, prefill_tokens "
          f"{engine.prefill_tokens}, cached_prefill_tokens "
          f"{engine.cached_prefill_tokens}, cow_copies {engine.cow_copies}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches in decode {phase['decode']}, in prefill "
          f"{phase['prefill']}")
    if not fused:
        m = torch.cat(margins)
        print(f"[margins] decoded rows: {m.numel()}, top-2 logit margin min "
              f"{m.min().item():.3e} median {m.median().item():.3e}; rows "
              f"with margin below the model check's max abs logit error "
              f"{logit_err:.3e}: {int((m < logit_err).sum())}")
    return {"launches": launches, "phase": phase, "flagged": flagged,
            "steps": engine.steps, "prefill_chunks": engine.prefill_chunks,
            "prefills": engine.prefills, "results": res, "wall": wall,
            "tok_per_s": ntok / wall, "mean_ttft_s": ttft,
            "peak": torch.cuda.max_memory_allocated()}


def profile_serve(model, engine=None, reqs=None):
    """The same trace again (or ``reqs``) on the fused (default) path under
    torch.profiler, recording the card's activity only: device time by
    kernel, by kind, kernel launches, and the device's idle share of the
    wall time. Returns {kernel name: (device ms, launches)}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import optrace
    engine = engine or make_engine(model, True)
    reqs = reqs or trace(model.arch, SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        print("[profile] fused: device time: not measured (the profiler "
              "recorded no CUDA kernel time)")
        return {}
    kinds = {"paged attention": 0.0, "residual norm": 0.0,
             "gated rmsnorm": 0.0, "fused head": 0.0, "gemm": 0.0,
             "other": 0.0}
    if model.arch.moe is not None:
        kinds["moe routing"] = 0.0
    other_by = {}               # "other" by the launching op's class
    for name, ms, _ in kernels:
        low = name.lower()
        if "moe routing" in kinds and any(w in low for w in MOE_ROUTING):
            kinds["moe routing"] += ms
        elif "decode_kernel" in low or "prefill_kernel" in low:
            kinds["paged attention"] += ms
        elif "resnorm_kernel" in low:
            kinds["residual norm"] += ms
        elif "gated_rmsnorm_kernel" in low:
            kinds["gated rmsnorm"] += ms
        elif any(w in low for w in ("head_gemv_kernel", UNTIED_GEMV,
                                      "head_epilogue_kernel")):
            kinds["fused head"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                      "cutlass")):
            kinds["gemm"] += ms
        else:
            kinds["other"] += ms
            cat = optrace.kernel_category(name)
            other_by[cat] = other_by.get(cat, 0.0) + ms
    n_launch = sum(k[2] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    PROFILE_KINDS[model.arch.name] = {"wall_ms": wall_ms, "busy_ms": busy,
                                      "idle": 1 - busy / wall_ms,
                                      "launches": n_launch, **kinds,
                                      "other_by_category": other_by}
    print(f"[profile] {model.arch.name} fused trace ({len(reqs)} requests) "
          f"under torch.profiler: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; kernel launches {n_launch} "
          f"({engine.steps} decode steps, {engine.prefill_chunks} prefill "
          f"chunks); by kind (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items())
          + "; top kernels " + "; ".join(
              f"{n[:48]} {ms:.1f} ms x{c}" for n, ms, c in top))
    print(f"[profile] {model.arch.name} \"other\" by the class of the op "
          f"each kernel's name shows (ms): " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(other_by.items(),
                                                key=lambda kv: -kv[1])))
    return {name: (ms, c) for name, ms, c in kernels}


# the device kernels of the MoE's routing, dispatch and combine, by name
# (cub radix sorts, torch's sort and top-k, searchsorted, the gathers and
# scatters, the router's softmax): no other op of the serving paths
# launches them
MOE_ROUTING = ("sort", "radix", "topk", "searchsorted", "scatter_gather",
               "softmax")
PROFILE_KINDS = {}          # arch -> the profiled window's device split


# ------------------------------------------------------- multi-step phase ---
# The continuous engine's decode_steps=N: each dispatch is k replays of a
# captured loop iteration (serving/graphs.py), one host synchronisation.
MULTI_STEPS = (1, 4)        # no N=16: at 1, 4 and 16 the phase took about
                            # 266 s of the script's 1200 s limit
MULTI_PAGES = 640           # room for a warm-up trace's cached prefixes


def make_multistep_engine(model, n: int, fused: bool = True, **kw):
    from repro_torch.serving import ContinuousEngine
    return ContinuousEngine(model, num_slots=8, num_pages=MULTI_PAGES,
                            page_size=16, max_seq_len=512 + 32 + 16,
                            prefill_chunk=64, fused_decode=fused,
                            decode_steps=n, **kw)


def _sync_warnings(caught) -> int:
    """Calls that made the host wait for the card, among the warnings of
    torch.cuda.set_sync_debug_mode("warn") (without its one-time notice
    that the mode is a prototype)."""
    return sum(1 for w in caught if "synchroniz" in str(w.message)
               and "prototype" not in str(w.message))


def _runtime_calls(prof) -> dict:
    """CUDA runtime calls the host made in a profiler window (kernel
    launches, graph launches, copies) and the device kernels and copies
    that ran."""
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    return {"host_launch_calls": sum(e.count for e in events
                                     if "LaunchKernel" in e.key),
            "graph_launches": sum(e.count for e in events
                                  if "GraphLaunch" in e.key),
            "host_copy_calls": sum(e.count for e in events
                                   if e.device_type != cuda
                                   and "emcpy" in e.key),
            "device_kernels": sum(e.count for e in events
                                  if e.device_type == cuda)}


PROFILED_DISPATCH = 3       # from the 4th dispatch of the warm-up trace


def instrument_dispatches(engine, profiled: bool = False):
    """Wrap the decode dispatches of ``engine`` (an instance attribute over
    the method). By default each runs under set_sync_debug_mode("warn"),
    its graph replays under "error" (a synchronising call among them
    raises); one record a dispatch: the synchronising calls it made,
    whether it captured a graph, its replays, its host seconds. With
    ``profiled``, the dispatches from the PROFILED_DISPATCH-th on run under
    torch.profiler until one captures nothing (its runtime calls: what the
    host issued for a steady dispatch), the others as they are."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    records = []
    multi = engine.decode_steps > 1
    loop = engine._loop
    if multi and not profiled:
        replay = loop.replay

        def strict_replay(entry, k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                replay(entry, k)
            finally:
                torch.cuda.set_sync_debug_mode("warn")
        loop.replay = strict_replay
    name = "_decode_multi" if multi else "_decode"
    dispatch = getattr(engine, name)

    def counted(*args, **kw):
        before = (loop.captures, loop.replays) if multi else (0, 0)
        t0 = time.perf_counter()
        calls = syncs = None
        if profiled:
            done = any(r["runtime_calls"] and not r["captured"]
                       for r in records)
            if len(records) >= PROFILED_DISPATCH and not done:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = dispatch(*args, **kw)
                    torch.cuda.synchronize()
                calls = _runtime_calls(prof)
            else:
                out = dispatch(*args, **kw)
        else:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = dispatch(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = _sync_warnings(caught)
        records.append({
            "syncs": syncs, "seconds": time.perf_counter() - t0,
            "captured": multi and loop.captures > before[0],
            "replays": loop.replays - before[1] if multi else 0,
            "runtime_calls": calls})
        return out
    setattr(engine, name, counted)
    return records


def profile_window(engine, reqs):
    """One run of ``reqs`` on ``engine`` under torch.profiler (the card's
    activity and the CUDA runtime calls): wall, device busy, idle share,
    device kernels, host kernel-launch calls and graph launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    steps = engine.steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    host_launches = sum(e.count for e in events
                        if "LaunchKernel" in e.key)
    graph_launches = sum(e.count for e in events if "GraphLaunch" in e.key)
    return {"wall_ms": wall_ms, "busy_ms": busy if busy > 0 else None,
            "idle": 1 - busy / wall_ms if busy > 0 else None,
            "device_kernels": sum(e.count for e in kernels),
            "host_launch_calls": host_launches or None,
            "graph_launches": graph_launches or None,
            "decode_steps": engine.steps - steps}


def serve_multistep(model, n: int, ref, label: str, fused: bool = True,
                    want: dict = None, profile_reqs=None, **kw):
    """Serve the llama (or mamba2) trace at decode_steps=``n``: a warm-up
    trace first (other prompts, the same mix: graphs captured, the first
    uses made), then the trace itself with every launch counter set to 0
    just before and read just after, each dispatch instrumented. Fails
    unless every request finished with its stream bitwise ``ref``'s, every
    dispatch that captured nothing made exactly one synchronising call,
    dispatches < steps at n > 1, no variant was captured twice, and the
    launches of ``want`` (kernel -> expected count from the engine's steps
    and chunks) are exact; at n > 1 a steady dispatch of the warm-up trace,
    profiled, must launch no kernel from the host. With ``profile_reqs``,
    those requests are served once more under the profiler."""
    arch = model.arch
    engine = make_multistep_engine(model, n, fused, **kw)
    warm = instrument_dispatches(engine, profiled=True)
    t0 = time.perf_counter()
    engine.run(trace(arch, SEED + 1))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    engine.__dict__.pop("_decode_multi" if n > 1 else "_decode")
    profiled = next((r for r in warm if r["runtime_calls"]
                     and not r["captured"]), None)
    if n > 1 and (profiled is None
                  or profiled["runtime_calls"]["host_launch_calls"]):
        _fail(f"{label}: no steady dispatch profiled, or it launched "
              f"kernels from the host: {profiled}")
    captures0 = engine._loop.captures if n > 1 else 0
    replays0 = engine._loop.replays if n > 1 else 0
    steps0, disp0, chunks0, prefills0 = (
        engine.steps, engine.decode_dispatches, engine.prefill_chunks,
        engine.prefills)
    exits0 = dict(engine.decode_exits)
    records = instrument_dispatches(engine)
    reqs = trace(arch, SEED)
    for d in _counters():
        for k in d:
            d[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _snapshot()
    steps = engine.steps - steps0
    dispatches = engine.decode_dispatches - disp0
    chunks = engine.prefill_chunks - chunks0
    prefills = engine.prefills - prefills0
    exits = {k: v - exits0[k] for k, v in engine.decode_exits.items()}
    streams = {i: r["tokens"] for i, r in res.items()}
    for i, r in ref.items():
        got = streams.get(i)
        if got != r:
            first = next((j for j, (a, b) in enumerate(zip(got or [], r))
                          if a != b), None)
            _fail(f"{label}: request {i} diverged from N=1 at token "
                  f"{first}: {got} vs {r}")
    if n > 1 and not dispatches < steps:
        _fail(f"{label}: {dispatches} dispatches for {steps} steps")
    stats = engine.trace_stats()
    if stats["excess"]:
        _fail(f"{label}: variants captured twice: {stats}")
    steady = [r for r in records if not r["captured"]]
    if n > 1 and any(r["syncs"] != 1 for r in steady):
        _fail(f"{label}: dispatches with other than one synchronising "
              f"call: {[r['syncs'] for r in steady]}")
    for name, expect in (want or {}).items():
        n_want = expect(steps, chunks, prefills)
        if launches[name] != n_want:
            _fail(f"{label}: {name} launched {launches[name]} times, "
                  f"expected {n_want}")
    ntok = sum(len(t) for t in streams.values())
    out = {"n": n, "wall_s": wall, "tok_per_s": ntok / wall,
           "warm_up_s": warm_s, "steps": steps, "dispatches": dispatches,
           "exits": exits, "prefill_chunks": chunks,
           "syncs_per_dispatch": sorted({r["syncs"] for r in steady}),
           "capturing_dispatches": [
               {"syncs": r["syncs"], "seconds": r["seconds"]}
               for r in records if r["captured"]],
           "trace_stats": stats,
           "launches": {k: v for k, v in launches.items() if v},
           "cached_prefill_tokens": engine.cached_prefill_tokens,
           "profiled_dispatch": profiled,
           "identical_to_n1": True}
    if n > 1:
        loop = engine._loop
        out.update(
            replays=loop.replays - replays0,
            captures=loop.captures, captures_in_run=loop.captures
            - captures0, graph_pool_bytes=loop.pool_bytes,
            captured_launches_per_iteration={
                str(k): v.launches for k, v in loop.graphs.items()},
            replays_per_dispatch=(loop.replays - replays0) / dispatches)
    else:
        out["syncs_per_step"] = sorted({r["syncs"] for r in steady})
    if profile_reqs:
        out["profile"] = profile_window(engine, profile_reqs)
        p = out["profile"]
        p["device_kernels_per_decode_step"] = (
            p["device_kernels"] / p["decode_steps"])
        if p["host_launch_calls"]:
            p["host_launch_calls_per_decode_step"] = (
                p["host_launch_calls"] / p["decode_steps"])
    prof = out.get("profile", {})
    print(f"[multi-step] {label} N={n}: {ntok} tokens in {wall:.3f}s "
          f"({ntok / wall:.1f} tok/s; warm-up trace {warm_s:.3f}s); "
          f"steps {steps}, dispatches {dispatches}, exits {exits}; "
          + (f"replays {out['replays']} ({out['replays_per_dispatch']:.2f} "
             f"a dispatch), graphs {out['captures']} (pool "
             f"{out['graph_pool_bytes']} bytes), launches captured an "
             f"iteration {out['captured_launches_per_iteration']}; "
             f"synchronising calls a dispatch {out['syncs_per_dispatch']} "
             f"(capturing dispatches {out['capturing_dispatches']}); "
             if n > 1 else
             f"synchronising calls a step {out['syncs_per_step']}; ")
          + f"trace_stats {stats}; streams bitwise N=1's"
          + (f"; a steady dispatch of the warm-up trace under the "
             f"profiler ({profiled['replays']} replays): "
             f"{profiled['runtime_calls']}" if profiled else "")
          + (f"; profiled window: wall {prof['wall_ms']:.1f} ms, busy "
             f"{prof['busy_ms']} ms, idle {prof['idle']}, device kernels "
             f"{prof['device_kernels']} "
             f"({prof['device_kernels_per_decode_step']:.1f} a decode "
             f"step), host launch calls {prof['host_launch_calls']}, graph "
             f"launches {prof['graph_launches']}, decode steps "
             f"{prof['decode_steps']}" if prof else ""))
    return out


def _fused_llama_launches(arch):
    """Exact launches of the fused llama serve from its steps, chunks and
    prefills: every loop iteration of this trace is live (no EOS)."""
    layers = arch.num_layers
    return {"paged_decode_attention": lambda s, c, p: layers * s,
            "paged_prefill_attention": lambda s, c, p: layers * c,
            "decode_residual_norm": lambda s, c, p: layers * (s + c),
            "head_tokens": lambda s, c, p: s + p}


def check_sanitizer_on_card(model, ref):
    """The sanitizer on the card: the fused llama serve at N=4 with
    sanitize=True gives the streams of the run without it; a smoke llama
    (head dim 128, bf16) with NaN weights raises SanitizerError at its
    first final chunk."""
    from repro_torch import tree
    from repro_torch.analysis.sanitize import SanitizerError
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousEngine, Request
    engine = make_multistep_engine(model, 4, sanitize=True)
    t0 = time.perf_counter()
    res = engine.run(trace(model.arch, SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if {i: r["tokens"] for i, r in res.items()} != ref:
        _fail("the sanitized N=4 serve's streams differ from the plain one")
    arch = dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=128)
    smoke = Model.init(arch, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    nan = Model(arch, tree.map(lambda t: t * float("nan")
                               if t.is_floating_point() else t,
                               smoke.params))
    eng = ContinuousEngine(nan, num_slots=2, num_pages=16, page_size=16,
                           max_seq_len=64, decode_steps=4, sanitize=True)
    try:
        eng.run([Request(uid=0, prompt=list(range(5, 17)),
                         max_new_tokens=4)])
    except SanitizerError as e:
        msg = str(e)
    else:
        _fail("NaN weights did not raise SanitizerError")
    if not msg.startswith("[sanitize:finite]") or "final=True" not in msg:
        _fail(f"the NaN model raised elsewhere than its first final "
              f"chunk: {msg}")
    print(f"[sanitize] fused llama serve at N=4 with sanitize=True: "
          f"streams equal the plain run's, {wall:.3f}s; NaN smoke weights: "
          f"{msg}")
    return {"wall_s": wall, "nan_message": msg}


def multistep_phase(model, runs):
    """Fused llama at N in MULTI_STEPS (N > 1 profiled: phase 6 profiles
    N=1), unfused at N=4 and the sanitizer checks: streams bitwise phase
    5's N=1 serves."""
    ref = {True: {i: r["tokens"] for i, r in runs[True]["results"].items()},
           False: {i: r["tokens"] for i, r in
                   runs[False]["results"].items()}}
    want = _fused_llama_launches(model.arch)
    fused = {n: serve_multistep(model, n, ref[True], "fused llama3.2-3b",
                                want=want,
                                profile_reqs=trace(model.arch, SEED + 2)
                                if n > 1 else None)
             for n in MULTI_STEPS}
    layers = model.arch.num_layers
    unfused = serve_multistep(
        model, 4, ref[False], "unfused llama3.2-3b", fused=False,
        want={"paged_decode_attention": lambda s, c, p: layers * s,
              "paged_prefill_attention": lambda s, c, p: layers * c})
    if not unfused["launches"].get("filter_logits") or \
            not unfused["launches"].get("draw_tokens"):
        _fail("the unfused N=4 serve launched no filter or draw")
    sanitized = check_sanitizer_on_card(model, ref[True])
    return {"fused": fused, "unfused_n4": unfused, "sanitizer": sanitized}


# ----------------------------------------------------------- static phase ---
# The static engine: the whole prompt prefilled at once into a dense cache,
# then lock-step decode (launch/serve.py run_static).
STATIC_BATCH, STATIC_PROMPT, STATIC_GEN = 4, 4096, 32
STATIC_SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)


def static_args(batch, prompt_len, gen_len, **kw):
    import argparse
    base = dict(batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                temperature=0.0, top_k=0, top_p=1.0, seed=SEED)
    return argparse.Namespace(**{**base, **kw})


def run_static_counted(model, args):
    """``run_static`` with every launch counter set to 0 just before the run
    and read just after, launches split between the prefill, the decode
    steps and, for an encdec arch, the encoder with the cross K/V fill
    ("encode"); keeps the prefill's last-position logits [B, Vp]."""
    from repro_torch.launch.serve import run_static
    phase = {"prefill": dict.fromkeys(_snapshot(), 0),
             "decode": dict.fromkeys(_snapshot(), 0),
             "encode": dict.fromkeys(_snapshot(), 0)}
    got = {}
    prefill_fn, decode_fn = model.prefill, model.decode_step

    def prefill(*a, **kw):
        logits, caches = _counted(phase["prefill"], prefill_fn)(*a, **kw)
        got["logits"] = logits[:, 0]
        return logits, caches
    model.prefill = prefill
    model.decode_step = _counted(phase["decode"], decode_fn)
    model.encode = _counted(phase["encode"], model.encode)
    model.fill_cross_kv = _counted(phase["encode"], model.fill_cross_kv)
    for d in _counters():
        for k in d:
            d[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_static(model, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _snapshot()
    for name in ("prefill", "decode_step", "encode", "fill_cross_kv"):
        model.__dict__.pop(name, None)      # no model -> fn -> model cycle
    b, glen = args.batch, args.gen_len
    if res["tokens"].shape != (b, glen):
        _fail(f"static serve returned tokens {res['tokens'].shape}")
    return dict(res, phase=phase, launches=launches, logits=got["logits"],
                wall=wall, peak=torch.cuda.max_memory_allocated(),
                tok_per_s=b * glen / wall,
                decode_ms_per_token=res["t_decode"] / max(glen - 1, 1) * 1e3)


def _expect_launches(run, want, what):
    """``want``: {kernel: (launches in the prefill, in decode, outside
    both)}; every other kernel must not have launched."""
    for name, n in run["launches"].items():
        exp = want.get(name, (0, 0, 0))
        pre, dec = run["phase"]["prefill"][name], run["phase"]["decode"][name]
        if (pre, dec, n - pre - dec) != exp:
            _fail(f"{what}: {name} launched {pre} times in the prefill, "
                  f"{dec} in decode and {n - pre - dec} outside both; "
                  f"expected {exp}")


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _compare_logits(got, want, what):
    """Per batch row: rel L2 (gated at 0.05), max abs error, and whether the
    argmax agrees where the reference's top-2 margin exceeds the error."""
    lines = []
    for i in range(want.shape[0]):
        g, r = got[i].float(), want[i].float()
        if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
            _fail(f"{what}: non-finite logits in row {i}")
        rel, err = _rel_l2(g, r), (g - r).abs().max().item()
        top2 = torch.topk(r, 2).values
        margin = (top2[0] - top2[1]).item()
        same = int(g.argmax()) == int(r.argmax())
        lines.append(f"row {i}: rel L2 {rel:.3e}, max abs {err:.3e}, top-2 "
                     f"margin {margin:.3e}, argmax "
                     + ("equal" if same else "differs")
                     + (" (margin above the error)" if margin > err else
                        " (margin below the error)"))
        if not rel <= 0.05:
            _fail(f"{what}: row {i} logits rel L2 {rel} > 0.05")
    return lines


def profile_prefill(model, tokens, max_len):
    """One static prefill under torch.profiler, the card's activity only:
    device ms of the flash kernel, GEMMs and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import optrace
    caches = model.init_caches(tokens.shape[0], max_len)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(caches, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"flash attention": 0.0, "gemm": 0.0, "other": 0.0}
    other_by = {}               # "other" by the launching op's class
    n = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, low = e.self_device_time_total / 1e3, e.key.lower()
        n += e.count
        if "flash_fwd_kernel" in low:
            kinds["flash attention"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                      "cutlass")):
            kinds["gemm"] += ms
        else:
            kinds["other"] += ms
            cat = optrace.kernel_category(e.key)
            other_by[cat] = other_by.get(cat, 0.0) + ms
    busy = sum(kinds.values())
    if busy <= 0:
        print("[profile] static prefill: device time: not measured")
        return {}
    print(f"[profile] static flash prefill {tuple(tokens.shape)} under "
          f"torch.profiler: wall {wall_ms:.1f} ms, device busy {busy:.1f} "
          f"ms, idle share {1 - busy / wall_ms:.3f}, {n} kernel launches; "
          "by kind (ms) " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in kinds.items())
          + "; \"other\" by the class of the op each kernel's name shows "
          "(ms) " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
              other_by.items(), key=lambda kv: -kv[1])))
    return {"wall_ms": wall_ms, "busy_ms": busy, "launches": n, **kinds,
            "other_by_category": other_by}


def static_phase(model):
    """llama3.2-3b through the static engine with attn_impl="flash": 4
    prompts of 4096 tokens (above attn_chunk 1024), 32 new tokens, greedy,
    then sampled. Exactly one flash launch a layer in the prefill and none
    in decode (one query: naive). The flash prefill's last logits against
    the same prefill with attn_impl="chunked" (plain PyTorch), rel L2 0.05;
    then one flash prefill profiled."""
    from repro_torch.models.model import Model
    arch = model.arch
    flash = Model(dataclasses.replace(arch, attn_impl="flash"), model.params)
    runs = {}
    for name, kw in (("greedy", {}), ("sampled", STATIC_SAMPLED)):
        args = static_args(STATIC_BATCH, STATIC_PROMPT, STATIC_GEN, **kw)
        run = run_static_counted(flash, args)
        want = {"flash_attention": (arch.num_layers, 0, 0)}
        if kw:      # the sampler: one filter and one draw a token
            want.update(filter_logits=(0, 0, STATIC_GEN),
                        draw_tokens=(0, 0, STATIC_GEN))
        _expect_launches(run, want, f"static llama3.2-3b ({name})")
        runs[name] = run
        print(f"[static] llama3.2-3b {arch.num_layers}L flash, {name}: "
              f"{STATIC_BATCH} prompts x {STATIC_PROMPT} tokens + "
              f"{STATIC_GEN} new: prefill {run['t_prefill'] * 1e3:.1f} ms, "
              f"decode {run['decode_ms_per_token']:.2f} ms/token, wall "
              f"{run['wall']:.3f} s ({run['tok_per_s']:.1f} tok/s), peak "
              f"memory {run['peak'] / 2**30:.2f} GiB; launches in prefill "
              f"{_nonzero(run['phase']['prefill'])}, in decode "
              f"{_nonzero(run['phase']['decode'])}, in all "
              f"{_nonzero(run['launches'])}")
    greedy = runs["greedy"]
    tokens = torch.as_tensor(greedy["prompt"], device=model.device)
    chunked = Model(dataclasses.replace(arch, attn_impl="chunked"),
                    model.params)
    before = _snapshot()["flash_attention"]
    ref, _ = chunked.prefill(chunked.init_caches(STATIC_BATCH,
                                                 STATIC_PROMPT), tokens)
    if _snapshot()["flash_attention"] != before:
        _fail("the chunked prefill launched the flash kernel")
    lines = _compare_logits(greedy["logits"], ref[:, 0],
                            "static flash vs chunked prefill")
    print("[static] flash vs chunked (plain) prefill, last-position logits "
          "(bf16, tol rel L2 0.05): " + "; ".join(lines))
    del ref
    cache_bytes = (arch.num_layers * 2 * STATIC_BATCH
                   * (STATIC_PROMPT + STATIC_GEN) * arch.kv_dim * 2)
    prof = profile_prefill(flash, tokens, STATIC_PROMPT + STATIC_GEN)
    return {name: {k: run[k] for k in (
        "t_prefill", "decode_ms_per_token", "wall", "tok_per_s", "peak")}
        | {"launches_prefill": run["phase"]["prefill"]["flash_attention"],
           "launches_decode": run["phase"]["decode"]["flash_attention"]}
        for name, run in runs.items()} | {
        "profile": prof, "dense_cache_bytes": cache_bytes,
        "logits_vs_chunked": lines}


def static_mamba(model):
    """mamba2-1.3b through the static engine: 4 prompts of 512 tokens (two
    SSD chunks of 256), 16 new tokens, greedy. The prefill's last logits
    within rel L2 0.05 of the plain full-sequence forward, and no further
    from its fp32 run than 1.25 x the plain bf16 forward is (so their
    difference is bf16 rounding); exactly 48 gated_rmsnorm launches in the
    prefill and 48 a decode step."""
    from repro_torch import tree
    from repro_torch.models.model import Model
    arch = model.arch
    gen = 16
    run = run_static_counted(model, static_args(4, 512, gen))
    _expect_launches(run, {"gated_rmsnorm": (
        arch.num_layers, arch.num_layers * (gen - 1), 0)},
        "static mamba2-1.3b")
    tokens = torch.as_tensor(run["prompt"], device=model.device)
    with torch.inference_mode():
        ref = torch.stack([mamba_reference_logits(model, tokens[i:i + 1])
                           for i in range(tokens.shape[0])])
        m32 = Model(dataclasses.replace(arch, dtype="float32"),
                    tree.map(lambda t: t.float(), model.params))
        ref32 = torch.stack([mamba_reference_logits(m32, tokens[i:i + 1])
                             for i in range(tokens.shape[0])])
        del m32
    lines = _compare_logits(run["logits"], ref,
                            "static mamba2 prefill vs plain forward")
    for i, line in enumerate(lines):
        got32, plain32 = (_rel_l2(run["logits"][i], ref32[i]),
                          _rel_l2(ref[i], ref32[i]))
        lines[i] = (f"{line}; vs fp32: static {got32:.3e}, plain bf16 "
                    f"{plain32:.3e}")
        if not got32 <= 1.25 * plain32:
            _fail(f"static mamba2 row {i}: {got32} from the fp32 forward, "
                  f"more than 1.25 x the plain bf16 forward's {plain32}")
    print(f"[static] mamba2-1.3b {arch.num_layers}L: 4 prompts x 512 tokens "
          f"+ {gen} new: prefill {run['t_prefill'] * 1e3:.1f} ms, decode "
          f"{run['decode_ms_per_token']:.2f} ms/token, wall "
          f"{run['wall']:.3f} s ({run['tok_per_s']:.1f} tok/s), peak memory "
          f"{run['peak'] / 2**30:.2f} GiB; gated_rmsnorm launches: prefill "
          f"{run['phase']['prefill']['gated_rmsnorm']}, decode "
          f"{run['phase']['decode']['gated_rmsnorm']} ({gen - 1} steps); "
          "last logits vs the plain full-sequence forward (bf16, tol rel L2 "
          "0.05): " + "; ".join(lines))
    return {k: run[k] for k in ("t_prefill", "decode_ms_per_token", "wall",
                                "tok_per_s", "peak")} | {
        "launches_prefill": run["phase"]["prefill"]["gated_rmsnorm"],
        "launches_decode": run["phase"]["decode"]["gated_rmsnorm"],
        "logits_vs_plain": lines}


# ------------------------------------------------------------ mamba phase ---
# The SSM serving slice: mamba2-1.3b at full width on the continuous engine.

def mamba_reference_logits(model, tokens):
    """Plain full-sequence mamba2 forward: ``apply_mamba`` over the whole
    prefix (one SSD chunk, no slot state, no pages) with the gated norm's
    plain version in place of the kernel."""
    from repro_torch.kernels.fused_layernorm import ref as ln_ref
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm
    arch = dataclasses.replace(model.arch, ssm=dataclasses.replace(
        model.arch.ssm, chunk=tokens.shape[1]))
    x = model._embed(tokens)
    kernel = ssm._gated_rmsnorm
    ssm._gated_rmsnorm = ln_ref.gated_rmsnorm
    try:
        for blk in model.params["blocks"]:
            x = x + ssm.apply_mamba(arch, blk["mamba"],
                                    apply_norm(arch.norm, blk["ln1"], x))
    finally:
        ssm._gated_rmsnorm = kernel
    return model._logits(x[:, -1:])[0, 0]


def check_mamba_logits(model, rng, dev) -> float:
    """A 200-token prompt through 64-token paged prefill chunks (the last
    padded) in slot 1 of a 2-slot pool, then four decode steps beside the
    idle slot 0, each final logit row against the plain full-sequence
    forward of the same prefix (bf16, rel L2 0.05); the idle slot's state
    must stay zero. Both bf16 paths are also measured against the plain
    forward in fp32 (the same weights upcast): the paged path must be no
    further from it than 1.25 x the plain bf16 forward is, so their
    difference is bf16 rounding and not the paged path's. Returns the
    largest max abs logit error against the bf16 plain forward."""
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    arch = model.arch
    blocks = model.params["blocks"]
    n_pre, n_dec, chunk = 200, 4, 64
    toks = torch.as_tensor(rng.integers(5, arch.vocab_size,
                                        (1, n_pre + n_dec)), device=dev)
    with torch.inference_mode():
        prefixes = [toks[:, :n + 1] for n in range(n_pre - 1, n_pre + n_dec)]
        refs = [mamba_reference_logits(model, p) for p in prefixes]
        m32 = Model(dataclasses.replace(arch, dtype="float32"),
                    tree.map(lambda t: t.float(), model.params))
        refs32 = [mamba_reference_logits(m32, p) for p in prefixes]
        del m32
        pools = tf.init_serving_state(arch, 1, 16, 2, model.dtype, dev)
        row = torch.zeros((1,), dtype=torch.int32, device=dev)
        buf = torch.zeros((1, chunk), dtype=torch.long, device=dev)
        for start in range(0, n_pre, chunk):
            end = min(start + chunk, n_pre)
            buf.zero_()
            buf[0, :end - start] = toks[0, start:end]
            x = tf.paged_prefill_stack(arch, blocks, pools, model._embed(buf),
                                       row, start, end, 1)
        got = [model._logits(tf.chunk_final_hidden(x, start, n_pre))[0, 0]]
        table = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        for pos in range(n_pre, n_pre + n_dec):
            tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
            tok[1, 0] = toks[0, pos]
            sl = torch.tensor([0, pos], dtype=torch.int32, device=dev)
            x = tf.paged_decode_stack(arch, blocks, pools, model._embed(tok),
                                      table, sl)
            got.append(model._logits(x)[1, 0])
        idle = max(max(p["state"][0].abs().max().item(),
                       p["conv"][0].float().abs().max().item())
                   for p in pools)
    if idle != 0.0:
        _fail(f"the idle slot's mamba state changed (max abs {idle})")
    worst, lines = 0.0, []
    for i, (g, r, r32) in enumerate(zip(got, refs, refs32)):
        if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
            _fail("non-finite logits in the mamba2 model check")
        rel = ((g - r).norm() / r.norm()).item()
        err = (g - r).abs().max().item()
        top2 = torch.topk(r, 2).values
        worst = max(worst, err)
        lines.append(f"{'prefill' if i == 0 else 'decode'} pos "
                     f"{n_pre - 1 + i}: rel L2 {rel:.3e}, max abs {err:.3e}, "
                     f"argmax equal {int(g.argmax()) == int(r.argmax())}, "
                     f"ref top-2 margin {(top2[0] - top2[1]).item():.3e}; "
                     f"vs fp32: paged {_rel_l2(g, r32):.3e}, plain bf16 "
                     f"{_rel_l2(r, r32):.3e}")
        if not rel <= 0.05:
            _fail(f"mamba2 logits rel L2 error {rel} > 0.05 at position "
                  f"{n_pre - 1 + i} (bf16, {arch.num_layers} layers)")
        if not _rel_l2(g, r32) <= 1.25 * _rel_l2(r, r32):
            _fail(f"mamba2 logits at position {n_pre - 1 + i}: the paged "
                  f"path is {_rel_l2(g, r32)} from the fp32 forward, more "
                  f"than 1.25 x the plain bf16 forward's {_rel_l2(r, r32)}")
    print(f"[model] mamba2-1.3b {arch.num_layers}L logits via 64-token paged "
          f"prefill chunks and slot-state decode vs the plain full-sequence "
          f"forward (bf16, tol rel L2 0.05; vs the fp32 forward within 1.25 "
          f"x the plain bf16 forward's rel L2): " + "; ".join(lines))
    return worst


def make_mamba_engine(model):
    """The engine as a user makes it: fused decode and the prefix cache
    left at their defaults (the cache is gated off for an SSM arch)."""
    from repro_torch.serving import ContinuousEngine
    return ContinuousEngine(model, num_slots=8, num_pages=320, page_size=16,
                            max_seq_len=512 + 32 + 16, prefill_chunk=64)


def serve_mamba(model):
    """The serving trace on mamba2 (8 requests on 8 slots, prompts of
    128-512 tokens, 32 new tokens, half greedy and half at T 0.8 / top-k
    40 / top-p 0.95) through the default fused engine, every launch
    counter set to 0 just before the run and read just after: exactly one
    gated_rmsnorm a layer per decode step and per prefill chunk, one
    head_tokens per decode step and final chunk, no residual norm. The
    prefix cache must report its off reason in the engine and in every
    result."""
    arch = model.arch
    reqs = trace(arch, SEED)
    n_req, gen = len(reqs), reqs[0].max_new_tokens
    engine = make_mamba_engine(model)
    if not engine.fused_decode:
        _fail(f"the mamba2 engine is not fused by default: "
              f"{engine.fused_decode_off_reason}")
    if not engine.prefix_cache_off_reason:
        _fail("the mamba2 engine did not gate the prefix cache off")
    phase = {"decode": dict.fromkeys(_snapshot(), 0),
             "prefill": dict.fromkeys(_snapshot(), 0)}
    finite, last = [], {}
    head_fn = engine._fused_head
    decode_fn, prefill_fn = engine._decode, engine._prefill

    def probed_head(*args, **kw):
        tok, ok = head_fn(*args, **kw)
        last["ok"] = ok
        return tok, ok

    def decode(page_table, seq_lens, *args, **kw):
        out = _counted(phase["decode"], decode_fn)(page_table, seq_lens,
                                                   *args, **kw)
        live = torch.as_tensor(np.flatnonzero(seq_lens > 0),
                               device=last["ok"].device)
        finite.append(last["ok"][live].all())
        return out

    def prefill(*args, final, **kw):
        out = _counted(phase["prefill"], prefill_fn)(*args, final=final,
                                                     **kw)
        if final:
            finite.append(last["ok"][0])
        return out

    engine._fused_head = probed_head
    engine._decode, engine._prefill = decode, prefill
    for d in _counters():
        for k in d:
            d[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _snapshot()
    for i in range(n_req):
        r = res.get(i)
        if r is None or "error" in r or len(r["tokens"]) != gen:
            _fail(f"mamba2 request {i} did not finish: {r}")
        if not r.get("prefix_cache", "").startswith("off: "):
            _fail(f"mamba2 request {i} lacks the prefix-cache off stat: {r}")
    if not all(bool(f) for f in finite):
        _fail("non-finite logits during the mamba2 serve")
    want = {"gated_rmsnorm": {"decode": arch.num_layers * engine.steps,
                              "prefill": arch.num_layers
                              * engine.prefill_chunks},
            "head_tokens": {"decode": engine.steps,
                            "prefill": engine.prefills}}
    for name, parts in want.items():
        for part, n in parts.items():
            if phase[part][name] != n:
                _fail(f"mamba2 serve: {name} launched {phase[part][name]} "
                      f"times in {part}, expected {n}")
    for name, n in launches.items():
        if name not in want and n:
            _fail(f"the mamba2 serve launched {name} {n} times")
    state_bytes = sum(t.numel() * t.element_size() for p in engine.pools
                      for t in p.values())
    ntok = sum(len(r["tokens"]) for r in res.values())
    ttft = float(np.mean([res[i]["token_times"][0] for i in range(n_req)]))
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] mamba2-1.3b {arch.num_layers}L d{arch.d_model} bf16, "
          f"fused decode (default): {n_req} requests x {gen} tokens in "
          f"{wall:.3f}s ({ntok / wall:.1f} tok/s, mean TTFT "
          f"{ttft * 1e3:.1f} ms); steps {engine.steps}, prefills "
          f"{engine.prefills}, prefill chunks {engine.prefill_chunks}, "
          f"prefill_tokens {engine.prefill_tokens}; prefix cache off: "
          f"{engine.prefix_cache_off_reason}; SSM slot state "
          f"{state_bytes} bytes ({state_bytes / 2**20:.1f} MiB); peak "
          f"memory {peak / 2**30:.2f} GiB; launches in decode "
          f"{phase['decode']}, in prefill {phase['prefill']}")
    return {"launches": launches, "phase": phase, "steps": engine.steps,
            "prefill_chunks": engine.prefill_chunks,
            "prefills": engine.prefills, "wall": wall,
            "results": {i: r["tokens"] for i, r in res.items()},
            "tok_per_s": ntok / wall, "mean_ttft_s": ttft,
            "peak_bytes": peak, "ssm_state_bytes": state_bytes,
            "prefill_tokens": engine.prefill_tokens}


def mamba_phase(dev, rng, marks):
    """Init mamba2-1.3b at full width on the card (48 layers, d_model 2048,
    64 SSD heads of 64 channels, state 128, bf16, seeded), check its logits,
    serve the trace and profile a window of it (its first two requests, 8
    new tokens each)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    arch = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    model = Model.init(arch, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(model.params))
    print(f"[init] mamba2-1.3b full width, {arch.num_layers} layers, "
          f"{n_params} parameters, bf16 weights on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    logit_err = check_mamba_logits(model, rng, dev)
    marks["mamba2 checks"] = time.perf_counter()
    run = serve_mamba(model)
    marks["mamba2 serve"] = time.perf_counter()
    layers = arch.num_layers
    ref = run.pop("results")
    run["multistep"] = {n: serve_multistep(
        model, n, ref, "fused mamba2-1.3b",
        profile_reqs=trace(arch, SEED + 2)[:3] if n > 1 else None,
        want={"gated_rmsnorm": lambda s, c, p: layers * (s + c),
              "head_tokens": lambda s, c, p: s + p}) for n in (1, 4)}
    marks["mamba2 multi-step"] = time.perf_counter()
    window = [dataclasses.replace(r, max_new_tokens=8)
              for r in trace(arch, SEED)[:2]]
    run["profile"] = profile_serve(model, make_mamba_engine(model), window)
    run["logit_err"] = logit_err
    marks["mamba2 profile"] = time.perf_counter()
    run["static"] = static_mamba(model)
    marks["static mamba2"] = time.perf_counter()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return run


# -------------------------------------------------------------- MoE phase ---
# The moe family (deepseek-moe-16b at full width and depth) and the hybrid
# family (jamba-v0.1-52b, one period of its layers at full width) through
# both engines, with the head kernel reading their untied heads.
JAMBA_LAYERS = 8            # one period of jamba's 32: 1 attention, 7 mamba
                            # layers, 4 of them MoE


def check_paged_heads(arch, rng, dev):
    """Paged decode (8 slots of 128-576 tokens) and prefill (the last chunk
    of a 498-token prompt, every row of it) at ``arch``'s heads against
    their plain versions, each query row within ATTN_TOL as in phase 3
    (llama's G 3): deepseek-moe-16b's G 1 (16 / 16 heads), internlm2-1.8b's
    G 2 and jamba's G 4. Timed by CUDA events beside the bound (phase 3
    counts the kernels a call and takes the profiler's device time)."""
    from repro_torch.kernels.decode_attention import ops, ref
    seq_lens = np.asarray(rng.integers(128, 577, 8), np.int32)
    seq_lens[0], seq_lens[1] = 576, 17
    q, sets, pt, sl = _paged_decode_case(arch, rng, dev, seq_lens, 36)
    kp, vp = sets[0]
    out = ops.paged_decode_attention(q, kp, vp, pt, sl)
    plain = ref.paged_decode_attention(q.float(), kp.float(), vp.float(), pt,
                                       sl)
    torch.cuda.synchronize()
    live = sl > 0
    _, dec_ulps = _attn_err(out[live], plain[live],
                            f"paged_decode_attention ({arch.name})")
    dec_ms = _time_ms(lambda: ops.paged_decode_attention(q, kp, vp, pt, sl),
                      100)
    hq, hkv, d = arch.num_heads, arch.num_kv_heads, arch.resolved_head_dim
    tokens = int(sl.sum().item())
    dec_bound, _ = _bound(tokens * hkv * d * 2 * 2 + 2 * q.numel() * 2,
                          4.0 * tokens * hq * d)
    del sets, kp, vp
    c, page, max_pages, num_pages = 64, 16, 35, 64
    start, valid = 448, 50
    total = start + valid
    kp = torch.randn((num_pages, page, hkv, d), device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    pr = torch.as_tensor(rng.permutation(np.arange(1, num_pages))[
        :max_pages].astype(np.int32), device=dev)
    qp = torch.randn((c, hq, d), device=dev, dtype=torch.bfloat16)
    out = ops.paged_prefill_attention(qp, kp, vp, pr, start, total)
    plain = ref.paged_prefill_attention(qp.float(), kp.float(), vp.float(),
                                        pr, start, total)
    torch.cuda.synchronize()
    _, pre_ulps = _attn_err(out, plain,
                            f"paged_prefill_attention ({arch.name})")
    pre_ms = _time_ms(lambda: ops.paged_prefill_attention(
        qp, kp, vp, pr, start, total), 100)
    visible = sum(min(start + r + 1, total) for r in range(valid))
    pre_bound, _ = _bound(total * hkv * d * 2 * 2 + 2 * valid * hq * d * 2,
                          4.0 * visible * hq * d)
    torch.cuda.empty_cache()
    g = hq // hkv
    res = {"G": g, "decode": {"max_err_row_ulps": dec_ulps, "ms": dec_ms,
                              "bound_ms": dec_bound,
                              "split": ops.decode_plan(8, hkv, 36, page)},
           "prefill": {"max_err_row_ulps": pre_ulps, "ms": pre_ms,
                       "bound_ms": pre_bound,
                       "split": ops.prefill_plan(c, hq, hkv, start, total,
                                                 page, max_pages)[0]}}
    print(f"[paged] {arch.name} (G {g}: {hq} / {hkv} heads): decode worst "
          f"row {dec_ulps:.4f} ulps, {dec_ms:.5f} ms (bound "
          f"{dec_bound:.5f}); prefill worst row {pre_ulps:.4f} ulps, "
          f"{pre_ms:.5f} ms (bound {pre_bound:.5f}) (tol {ATTN_TOL})")
    return res


def check_residual_norm_width(d, dev,
                              label="deepseek-moe-16b, internlm2-1.8b",
                              kind="rmsnorm"):
    """The fused add + norm (``kind``: rmsnorm, or layernorm with a bias)
    at [8, d] and [64, d]: x + y bitwise, the norm within 1 bf16 ulp of
    the plain version; device time a call. ``label``: the archs of this
    width, for the printed line."""
    from repro_torch.kernels.fused_layernorm import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    out = {}
    for rows in (8, 64):
        x = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        y = (torch.randn((rows, d), generator=gen, device=dev)
             * 0.5).bfloat16()
        scale = (1.0 + 0.1 * torch.randn((d,), generator=gen,
                                         device=dev)).bfloat16()
        bias = (0.1 * torch.randn((d,), generator=gen,
                                  device=dev)).bfloat16() \
            if kind == "layernorm" else None
        h, x2 = ops.decode_residual_norm(y, x, scale, bias, kind=kind)
        ph, px2 = ref.decode_residual_norm(y, x, scale, bias, kind=kind)
        torch.cuda.synchronize()
        diff = (h.float() - ph.float()).abs()
        if not torch.equal(x2.view(torch.int16), px2.view(torch.int16)) or \
                not bool((diff <= _bf16_ulp(ph)).all()):
            _fail(f"decode_residual_norm [{rows}, {d}] {kind}: x + y not "
                  f"bitwise or the norm off by more than 1 bf16 ulp "
                  f"({diff.max().item()})")
        out[f"device_ms_{rows}_rows"] = _profiled_ms(
            lambda: ops.decode_residual_norm(y, x, scale, bias, kind=kind),
            DEVICE_NAMES["decode_residual_norm"], 50)
        # x, y read, x + y and the norm written; the scale (and bias) read
        out[f"bound_ms_{rows}_rows"] = _bound(
            4 * rows * d * 2 + d * 2 * (1 + (bias is not None)),
            4.0 * rows * d, fp32=True)[0]
        out[f"plan_{rows}_rows"] = ops.norm_plan(rows, d)
    print(f"[residual_norm] D {d} {kind} ({label}): [8, "
          f"{d}] and [64, {d}] within 1 bf16 ulp, x + y bitwise; {out}")
    return out


def check_sampler_vocab(v, dev, rng):
    """The filter and the draw at [8, v] bitwise against their plain
    versions (the bisection; the plain draw of ref.row_uniforms)."""
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ops, ref
    s = 8
    lg = torch.as_tensor(rng.normal(size=(s, v)).astype(np.float32) * 3.0,
                         device=dev)
    top_k = torch.as_tensor([40, 40, 0, 40, 1, 40, 0, v + 5],
                            dtype=torch.int32, device=dev)
    top_p = torch.as_tensor([0.95, 1.0, 0.95, 0.95, 0.5, 0.95, 1.0, 0.99],
                            dtype=torch.float32, device=dev)
    out = ops.filter_logits(lg, top_k, top_p)
    plain = ref.filter_logits_bisect(lg, top_k, top_p)
    seeds, pos = _draw_keys(s, dev)
    tok = ops.draw_tokens(out, seeds, pos)
    ptok = head_ref.draw_tokens(out, head_ref.row_uniforms(seeds, pos))
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), plain.view(torch.int32)) or \
            not torch.equal(tok, ptok):
        _fail(f"filter or draw at [8, {v}] differ from the plain versions")
    return {"ctas_a_row": ops.cluster_plan(s, v),
            "filter_device_ms": _profiled_ms(lambda: ops.filter_logits(
                lg, top_k, top_p), DEVICE_NAMES["filter_logits"]),
            "draw_device_ms": _profiled_ms(lambda: ops.draw_tokens(
                out, seeds, pos), DEVICE_NAMES["draw_tokens"])}


def moe_kernel_checks(dev, rng):
    """The kernels at the shapes the moe and hybrid paths give them: the
    untied head at deepseek's, internlm2's and jamba's (D, V); paged
    attention at G 1, 2 and 4; the add + norm at D 2048; the filter and
    draw at V 102400, 92544 and 65536 (jamba's gated norm at C 8192 is in
    phase 3)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import pad_vocab
    archs = [get_config(n) for n in ("deepseek-moe-16b", "internlm2-1.8b",
                                     "jamba-v0.1-52b")]
    heads = [check_head_tokens(a, dev, untied=True) for a in archs]
    torch.cuda.empty_cache()
    paged = {a.name: check_paged_heads(a, rng, dev) for a in archs}
    norm = check_residual_norm_width(archs[0].d_model, dev)
    sampler = {f"[8, {pad_vocab(a.vocab_size)}]": check_sampler_vocab(
        pad_vocab(a.vocab_size), dev, rng) for a in archs}
    print(f"[sampler] filter and draw bitwise at the new vocabularies "
          f"(CTAs a row, device ms): {sampler}")
    row = dict(heads[0])
    row["other_shapes"] = {h["shape"]: {k: h[k] for k in (
        "ms", "ms_greedy", "plain_ms", "bound_ms", "library_ms",
        "library_device_ms", "profiler_device_ms_by_step", "ctas_a_row",
        "plan")} for h in heads[1:]}
    return {"row": row, "paged": paged, "residual_norm_d2048": norm,
            "sampler": sampler}


def moe_reference_logits(model, tokens, fp32: bool = False):
    """The plain full-sequence forward (``transformer.apply_block`` layer
    by layer: naive causal attention, each MoE layer at
    ``capacity_per_row(S)`` of the model's arch, mamba layers over one SSD
    chunk with the gated norm's plain version): fp32 logits [S, Vp] of
    every position. With ``fp32`` the activations are fp32 and each
    layer's weights are upcast as the layer runs (a whole fp32 copy of
    deepseek-moe-16b, 67.5 GB, would not fit beside the bf16 one; see
    ``_upcast_block``)."""
    from repro_torch.kernels.fused_layernorm import ref as ln_ref
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    arch = model.arch
    if arch.ssm is not None:
        arch = dataclasses.replace(arch, ssm=dataclasses.replace(
            arch.ssm, chunk=tokens.shape[1]))
    if fp32:
        arch = dataclasses.replace(arch, dtype="float32")
    kernel = ssm._gated_rmsnorm
    ssm._gated_rmsnorm = ln_ref.gated_rmsnorm
    try:
        x = model_lib.embed(arch, model.params, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        for blk, kind in zip(model.params["blocks"], tf._stack_kinds(arch)):
            if fp32:
                blk = _upcast_block(blk)
            x, _ = tf.apply_block(arch, blk, x, pos, causal=True,
                                  fused=False, mixer=kind)
        return model_lib.logits(arch, model.params, x)[0]
    finally:
        ssm._gated_rmsnorm = kernel


def _upcast_block(blk):
    """A block's weights in fp32, but for a MoE's experts: ``apply_moe``
    upcasts each expert tensor to the activations' dtype as it runs, so at
    most one fp32 expert tensor lives at a time (llama4's 128 experts of
    8192 are 64 GB in fp32, 21 GB a tensor)."""
    from repro_torch import tree
    out = {k: v if k == "moe" else tree.map(lambda t: t.float(), v)
           for k, v in blk.items()}
    if "moe" in blk:
        out["moe"] = {k: v if k == "experts" else tree.map(
            lambda t: t.float(), v) for k, v in blk["moe"].items()}
    return out


def _rel_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rel L2 of each row of ``a`` against the same row of ``b``."""
    return (a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1)


def _stats(r: torch.Tensor) -> str:
    q = torch.quantile(r, torch.tensor([0.5, 0.9], device=r.device))
    return (f"median {q[0].item():.3e}, p90 {q[1].item():.3e}, max "
            f"{r.max().item():.3e}")


MOE_LOGIT_RATIO = 1.25      # the paged path's RMS distance from the fp32
                            # forward, at most this times the plain bf16
                            # forward's (as the mamba2 check holds its own)


def check_moe_logits(model, rng, dev):
    """The logits of every position of a 114-token sequence through the
    paged path (110 prompt tokens in 64-token chunks, every valid row of
    each chunk, then four decode steps beside an idle slot; unfused and
    fused layer bodies) against the plain full-sequence forward in bf16
    and in fp32. The arch's capacity factor is raised to ceil(E / top_k),
    so no capacity drops a token on either path and chunking cannot change
    the drops (JAX's consistency test does the same). With random weights
    the router's top-k boundary is close for many tokens, so two bf16
    evaluations of the same prefix route many (layer, token) pairs to
    different experts, and their logits differ by 4-11% (rel L2, the
    prompt decides; the plain bf16 forward is as far from the fp32 one):
    no fixed bound against another bf16 evaluation separates a fault from
    that. The gate is therefore on the fp32 forward: the paged path's RMS
    rel L2 from it over all positions within MOE_LOGIT_RATIO x the plain
    bf16 forward's, so what separates the two bf16 paths is rounding and
    the routes it flips, not the paged path. Prints the distances and, per
    MoE layer, the tokens whose top-k expert set differs between the
    unfused paged path and the plain bf16 forward. Returns the largest max
    abs logit error against the plain bf16 forward, and the numbers."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    cf = float(math.ceil(model.arch.moe.num_experts / model.arch.moe.top_k))
    arch = dataclasses.replace(model.arch, moe=dataclasses.replace(
        model.arch.moe, capacity_factor=cf))
    m = Model(arch, model.params)
    blocks = m.params["blocks"]
    n_moe = sum("moe" in b for b in blocks)
    n_pre, n_dec, page = 110, 4, 16
    toks = torch.as_tensor(rng.integers(5, arch.vocab_size,
                                        (1, n_pre + n_dec)), device=dev)
    route, seen = moe_lib._route, []

    def recording(*args, **kw):
        r = route(*args, **kw)
        seen.append(torch.sort(r["ids"], dim=-1).values)
        return r
    try:
        with torch.inference_mode():
            moe_lib._route = recording
            ref = moe_reference_logits(m, toks)
            moe_lib._route = route
            plain_ids = [t[0] for t in seen]
            seen.clear()
            ref32 = moe_reference_logits(m, toks, fp32=True)
            got = {}
            for fused in (False, True):
                moe_lib._route = route if fused else recording
                pools = tf.init_serving_state(arch, 9, page, 2, m.dtype, dev)
                row = torch.arange(1, 9, dtype=torch.int32, device=dev)
                chunk = torch.zeros((1, 64), dtype=torch.long, device=dev)
                rows = []
                for start in (0, 64):
                    end = min(start + 64, n_pre)
                    chunk.zero_()
                    chunk[0, :end - start] = toks[0, start:end]
                    x = tf.paged_prefill_stack(arch, blocks, pools,
                                               m._embed(chunk), row, start,
                                               end, fused=fused)
                    rows.append(m._logits(x[:, :end - start])[0])
                table = torch.zeros((2, 8), dtype=torch.int32, device=dev)
                table[0] = row
                for pos in range(n_pre, n_pre + n_dec):
                    tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
                    tok[0, 0] = toks[0, pos]
                    sl = torch.tensor([pos, 0], dtype=torch.int32,
                                      device=dev)
                    x = tf.paged_decode_stack(arch, blocks, pools,
                                              m._embed(tok), table, sl,
                                              fused=fused)
                    rows.append(m._logits(x)[0])
                got[fused] = torch.cat(rows)
    finally:
        moe_lib._route = route
    parts = [seen[j * n_moe:(j + 1) * n_moe] for j in range(2 + n_dec)]
    changed = []
    for i in range(n_moe):
        paged = torch.cat([parts[0][i][0], parts[1][i][0][:n_pre - 64]]
                          + [parts[2 + j][i][0] for j in range(n_dec)])
        changed.append(int((paged != plain_ids[i]).any(dim=-1).sum()))
    if not (torch.isfinite(ref).all() and torch.isfinite(ref32).all()):
        _fail(f"non-finite logits in the {arch.name} plain forward")
    plain32 = _rel_rows(ref, ref32)
    rms_plain = plain32.square().mean().sqrt().item()
    worst, lines, bad = 0.0, [], []
    out = {"plain_bf16_vs_fp32": _stats(plain32),
           "expert_sets_changed": changed}
    for fused, g in got.items():
        if not torch.isfinite(g).all():
            _fail(f"non-finite logits in the {arch.name} paged path")
        d_plain, d32 = _rel_rows(g, ref), _rel_rows(g, ref32)
        rms = d32.square().mean().sqrt().item()
        worst = max(worst, (g - ref).abs().max().item())
        name = "fused" if fused else "unfused"
        agree = int((g.argmax(-1) == ref32.argmax(-1)).sum())
        lines.append(f"{name}: vs plain bf16 {_stats(d_plain)} ("
                     f"{int((d_plain > 0.05).sum())} positions above "
                     f"0.05); vs fp32 {_stats(d32)}, RMS {rms:.3e} against "
                     f"the plain bf16 forward's {rms_plain:.3e} (ratio "
                     f"{rms / rms_plain:.3f}); argmax equal to fp32's at "
                     f"{agree} of {g.shape[0]}")
        out[name] = {"vs_plain_bf16": _stats(d_plain), "vs_fp32":
                     _stats(d32), "rms_vs_fp32": rms,
                     "rms_plain_bf16_vs_fp32": rms_plain,
                     "last_prefill_vs_plain_bf16": d_plain[n_pre - 1].item(),
                     "decode_vs_plain_bf16": d_plain[n_pre:].tolist()}
        if not rms <= MOE_LOGIT_RATIO * rms_plain:
            bad.append(f"{name}: RMS rel L2 from the fp32 forward {rms}, "
                       f"above {MOE_LOGIT_RATIO} x the plain bf16 "
                       f"forward's {rms_plain}")
    print(f"[model] {arch.name} {arch.num_layers}L logits of all "
          f"{n_pre + n_dec} positions via the paged kernels (prompt chunks "
          f"of 64, then 4 decode steps) vs the plain full-sequence forward "
          f"(capacity factor raised to {cf:g}: nothing drops; gate: RMS rel "
          f"L2 from the fp32 forward within {MOE_LOGIT_RATIO} x the plain "
          f"bf16 forward's): plain bf16 vs "
          f"fp32 {_stats(plain32)}; " + "; ".join(lines)
          + f"; tokens whose top-{arch.moe.top_k} expert set differs "
          f"between the paged path and the plain bf16 forward, by MoE layer "
          f"(of {n_pre + n_dec}): {changed}")
    if bad:
        _fail(f"{arch.name} logits: {bad}")
    return worst, out


def _layer_ms(fn, iters: int = 20):
    """A layer of many kernels, a call: (CUDA events over ``iters`` eager
    calls, CUDA events over ``iters`` replays of the call captured as one
    CUDA graph). The replay runs the layer's kernels back to back with no
    host launch between them, so its time is the layer's device time;
    the profiler cannot give it (its window over the MoE layer never held
    the same whole number of records a call, PRs 24-30)."""
    eager = _time_ms(fn, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    replay = _time_ms(graph.replay, iters)
    del graph
    return eager, replay


def check_moe_layer(model, dev):
    """One MoE layer of the model called twice on the same input, at the
    decode shape [8, 1, D] and a prefill chunk's [1, 64, D]: bitwise equal
    outputs (gathers, no float atomics). The time a call (eager, and as
    a graph replay: its device time, ``_layer_ms``) beside the bytes of
    its experts' weights read once."""
    from repro_torch.models import moe as moe_lib
    arch = model.arch
    p = next(b["moe"] for b in model.params["blocks"] if "moe" in b)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    nbytes = sum(t.numel() * t.element_size() for t in p["experts"].values())
    bound_ms, _ = _bound(nbytes, 0.0)
    out = {"expert_bytes": nbytes, "bound_ms": bound_ms}
    with torch.inference_mode():
        for b, s in ((8, 1), (1, 64)):
            x = torch.randn((b, s, arch.d_model), generator=gen,
                            device=dev).bfloat16()
            y1 = moe_lib.apply_moe(arch, p, x, aux_loss=False)[0]
            y2 = moe_lib.apply_moe(arch, p, x, aux_loss=False)[0]
            torch.cuda.synchronize()
            if not (torch.isfinite(y1).all() and torch.equal(y1, y2)):
                _fail(f"{arch.name}: one MoE layer at [{b}, {s}] is not "
                      "bitwise repeatable (or not finite)")
            ev, dms = _layer_ms(
                lambda: moe_lib.apply_moe(arch, p, x, aux_loss=False))
            out[f"device_ms_[{b}, {s}]"] = dms
            out[f"events_ms_[{b}, {s}]"] = ev
    print(f"[moe] {arch.name} one MoE layer ({arch.moe.num_experts} experts "
          f"of {arch.moe.expert_ff}, top-{arch.moe.top_k}, "
          f"{arch.moe.num_shared_experts} shared) bitwise repeatable at [8, "
          f"1] and [1, 64]; ms a call (device: a graph replay; events: "
          f"eager) and the bound of its experts' bytes: {out}")
    return out


def static_moe(model):
    """deepseek-moe-16b through the static engine at its own capacity
    factor: 4 prompts of 512 tokens, 16 new, greedy (no kernel on this
    path); the prefill's last logits against the plain full-sequence
    forward of each prompt (each batch row routes on its own in both)."""
    gen = 16
    run = run_static_counted(model, static_args(4, 512, gen))
    _expect_launches(run, {}, f"static {model.arch.name}")
    tokens = torch.as_tensor(run["prompt"], device=model.device)
    with torch.inference_mode():
        ref = torch.stack([moe_reference_logits(model, tokens[i:i + 1])[-1]
                           for i in range(tokens.shape[0])])
    lines = _compare_logits(run["logits"], ref, f"static {model.arch.name} "
                            "prefill vs plain forward")
    print(f"[static] {model.arch.name} {model.arch.num_layers}L: 4 prompts "
          f"x 512 tokens + {gen} new, greedy: prefill "
          f"{run['t_prefill'] * 1e3:.1f} ms, decode "
          f"{run['decode_ms_per_token']:.2f} ms/token, wall "
          f"{run['wall']:.3f} s ({run['tok_per_s']:.1f} tok/s), peak memory "
          f"{run['peak'] / 2**30:.2f} GiB; last logits vs the plain forward "
          "(bf16, tol rel L2 0.05): " + "; ".join(lines))
    return {k: run[k] for k in ("t_prefill", "decode_ms_per_token", "wall",
                                "tok_per_s", "peak")} | {
        "logits_vs_plain": lines}


def deepseek_phase(dev, rng, marks):
    """deepseek-moe-16b at full width and depth (28 layers, 64 experts of
    1408, top-6, 2 shared; 16.9 B parameters, bf16, seeded): the logits
    check, one MoE layer's repeatability, the llama serving trace unfused
    then fused at the config's capacity factor 1.25, the fused serve at
    decode_steps=4 (streams bitwise N=1's, no host kernel launch in a
    steady dispatch), a two-request window of the fused trace profiled,
    and the static engine."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    arch = get_config("deepseek-moe-16b")
    t0 = time.perf_counter()
    model = Model.init(arch, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(model.params))
    if n_params != arch.param_count() + arch.d_model:
        _fail(f"{arch.name}: {n_params} parameters, param_count says "
              f"{arch.param_count()} and the final norm {arch.d_model}")
    print(f"[init] {arch.name} full width, {arch.num_layers} layers, "
          f"{n_params} parameters ({n_params * 2 / 1e9:.1f} GB), bf16 "
          f"weights on the card in {time.perf_counter() - t0:.1f}s")
    logit_err, logits = check_moe_logits(model, rng, dev)
    layer = check_moe_layer(model, dev)
    marks["deepseek checks"] = time.perf_counter()
    runs = {fused: serve(model, logit_err, fused) for fused in (False, True)}
    same = sum(runs[False]["results"][i]["tokens"]
               == runs[True]["results"][i]["tokens"]
               for i in runs[False]["results"])
    print(f"[streams] {arch.name} fused vs unfused serve: {same} of "
          f"{len(runs[False]['results'])} request streams identical (bf16 "
          "streams may fork on near-tied logits; not a failure)")
    marks["deepseek serves"] = time.perf_counter()
    ref = {i: r["tokens"] for i, r in runs[True]["results"].items()}
    multi = serve_multistep(model, 4, ref, f"fused {arch.name}",
                            want=_fused_llama_launches(arch))
    marks["deepseek multi-step"] = time.perf_counter()
    # a window of the trace (two requests, 8 new tokens each), as mamba2's:
    # the whole trace under the profiler took 97.3 s (PR 28)
    window = [dataclasses.replace(r, max_new_tokens=8)
              for r in trace(arch, SEED)[:2]]
    prof = profile_serve(model, make_engine(model, True), window)
    marks["deepseek profile"] = time.perf_counter()
    static = static_moe(model)
    marks["static deepseek"] = time.perf_counter()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    serves = {("fused" if f else "unfused"): {
        "wall_s": r["wall"], "decode_steps": r["steps"],
        "prefill_chunks": r["prefill_chunks"], "prefills": r["prefills"],
        "launches": _nonzero(r["launches"])} for f, r in runs.items()}
    return {"n_params": n_params, "logit_err": logit_err,
            "logits": logits, "layer": layer,
            "serves": serves, "identical_streams": same,
            "head_launches": runs[True]["launches"]["head_tokens"],
            "multistep_n4": multi, "profile": PROFILE_KINDS.get(arch.name),
            "profile_launches": sum(c for _, c in prof.values()),
            "static": static}


def jamba_phase(dev, rng):
    """jamba-v0.1-52b at full width, one period of its layers (8 of 32: 1
    attention, 7 mamba, 4 MoE of 16 experts of 14336; about 25.5 GB in
    bf16; the whole model's 51.46 B parameters, 103 GB, exceed one H100's
    80 GB): the logits check at a raised capacity factor, then 4 requests
    of the trace (16 new tokens, greedy) served unfused and fused, every
    launch counter set to 0 just before each run and read just after, with
    exact launches from the steps and chunks."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousEngine, SamplingParams
    full = get_config("jamba-v0.1-52b")
    arch = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    t0 = time.perf_counter()
    model = Model.init(arch, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(model.params))
    print(f"[init] {full.name} at full width, {JAMBA_LAYERS} of its "
          f"{full.num_layers} layers (one period: 1 attention, 7 mamba, 4 "
          f"MoE): {n_params} parameters ({n_params * 2 / 1e9:.1f} GB), bf16 "
          f"weights on the card in {time.perf_counter() - t0:.1f}s; reduced "
          f"because the whole model's {full.param_count()} parameters "
          f"({full.param_count() * 2 / 1e9:.1f} GB in bf16) exceed one "
          f"H100's 80 GB")
    logit_err, logits = check_moe_logits(model, rng, dev)
    reqs = [dataclasses.replace(r, max_new_tokens=16,
                                sampling=SamplingParams())
            for r in trace(arch, SEED)[:4]]
    n_attn = sum(arch.is_attention_layer(i) for i in range(arch.num_layers))
    n_mamba = arch.num_layers - n_attn
    out, streams = {}, {}
    for fused in (False, True):
        engine = ContinuousEngine(model, num_slots=8, num_pages=320,
                                  page_size=16, max_seq_len=512 + 32 + 16,
                                  prefill_chunk=64, fused_decode=fused)
        for d in _counters():
            for k in d:
                d[k] = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _snapshot()
        st, ch, pf = engine.steps, engine.prefill_chunks, engine.prefills
        want = {"paged_decode_attention": n_attn * st,
                "paged_prefill_attention": n_attn * ch,
                "gated_rmsnorm": n_mamba * (st + ch)}
        if fused:
            want.update(decode_residual_norm=arch.num_layers * (st + ch),
                        head_tokens=st + pf)
        for name, n in launches.items():
            if n != want.get(name, 0):
                _fail(f"{arch.name} {'fused' if fused else 'unfused'} serve:"
                      f" {name} launched {n} times, expected "
                      f"{want.get(name, 0)}")
        for i, r in enumerate(reqs):
            if len(res[i]["tokens"]) != r.max_new_tokens:
                _fail(f"{arch.name} request {i} did not finish: {res[i]}")
        streams[fused] = {i: res[i]["tokens"] for i in res}
        ntok = sum(len(t) for t in streams[fused].values())
        out["fused" if fused else "unfused"] = {
            "wall_s": wall, "tok_per_s": ntok / wall, "steps": st,
            "prefill_chunks": ch, "peak": torch.cuda.max_memory_allocated(),
            "launches": _nonzero(launches)}
        print(f"[serve] {arch.name} ({JAMBA_LAYERS} layers) "
              f"{'fused' if fused else 'unfused'}, greedy: {len(reqs)} "
              f"requests x 16 tokens in {wall:.3f}s ({ntok / wall:.1f} "
              f"tok/s); steps {st}, prefill chunks {ch}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {_nonzero(launches)} (exact)")
    same = sum(streams[True][i] == streams[False][i] for i in streams[True])
    print(f"[streams] {arch.name} fused vs unfused serve: {same} of "
          f"{len(reqs)} greedy streams identical (bf16 streams may fork on "
          "near-tied logits; not a failure)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": JAMBA_LAYERS, "n_params": n_params,
            "logit_err": logit_err, "logits": logits,
            "serves": out, "identical_streams": same,
            "head_launches": out["fused"]["launches"].get("head_tokens", 0)}


def moe_phase(dev, rng, marks, kernels):
    """deepseek-moe-16b, then jamba; ``kernels``: moe_kernel_checks' result
    (run in phase 3, beside the other kernel checks)."""
    deepseek = deepseek_phase(dev, rng, marks)
    jamba = jamba_phase(dev, rng)
    marks["jamba"] = time.perf_counter()
    row = kernels.pop("row")
    row.update(launches=deepseek["head_launches"],
               launches_path="deepseek-moe-16b fused serve (the engine's "
                             "default)",
               launches_jamba_fused_serve=jamba["head_launches"])
    return {"row": row, "kernels": kernels, "deepseek": deepseek,
            "jamba": jamba}


# --------------------------------------------------------- phase 6c ---
# The vlm and encdec families: qwen2-vl-2b (M-RoPE, biases on every
# projection) on both engines and whisper-base (encoder, cross-attention
# cache) on the static engine, at full width.
FLASH_NEW_CASES = {
    # whisper-base's heads (8 / 8, D 64), no causal mask, 1500 frames: the
    # encoder's self-attention on column views of its QKV projection, and
    # the decoder prefill's cross-attention of 64 queries; qwen2-vl-2b's
    # static prefill (12 / 2 heads, D 128: 6 query heads a KV head)
    "whisper encoder self-attention": (4, 1500, 1500, False, 0, 0, None,
                                       (8, 8, 64), True),
    "whisper prefill cross-attention": (4, 64, 1500, False, 0, 0, None,
                                        (8, 8, 64), False),
    "qwen2-vl static prefill": (4, 2048, 2048, True, 0, 0, None,
                                (12, 2, 128), False),
}
QWEN_STATIC = (4, 2048, 32)     # batch, prompt, new tokens
WHISPER_STATIC = (4, 64, 32)
BIAS_NAMES = ("bias", "bqkv", "bq", "bk", "bv", "bo", "b1", "b2", "b3")
BIAS_SCALE = 0.1


def vlm_encdec_kernel_checks(dev, rng):
    """The kernels at the shapes the vlm and encdec paths give them, held
    as in phase 3: the tied head at qwen2-vl's D 1536 / V 151936 (bitwise
    on exact inputs at 8 and 16 rows), paged decode and prefill at its G 6
    (12 / 2 heads), the add + norm at D 1536, the filter and draw at V
    151936 and whisper's 51968, and flash without a causal mask at
    whisper's heads (D 64) over 1500 keys (self- and cross-attention) and
    causal at qwen2-vl's (G 6, D 128)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import pad_vocab
    qwen, whisper = get_config("qwen2-vl-2b"), get_config("whisper-base")
    head = check_head_tokens(qwen, dev)
    torch.cuda.empty_cache()
    paged = check_paged_heads(qwen, rng, dev)
    norm = check_residual_norm_width(qwen.d_model, dev, qwen.name)
    sampler = {f"[8, {v}]": check_sampler_vocab(v, dev, rng)
               for v in (pad_vocab(qwen.vocab_size),
                         pad_vocab(whisper.vocab_size))}
    print(f"[sampler] filter and draw bitwise at qwen2-vl-2b's and "
          f"whisper-base's vocabularies (CTAs a row, device ms): {sampler}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    flash = [_flash_case(gen, dev, name, spec, None, 1024)
             for name, spec in FLASH_NEW_CASES.items()]
    _print_flash(flash)
    return {"head": head, "paged": paged, "residual_norm": norm,
            "sampler": sampler, "flash": flash}


def _perturb_biases(params, gen) -> int:
    """Add BIAS_SCALE N(0, 1) to every bias leaf in place (the init makes
    them 0, which would hide a dropped bias from every check); returns
    the number of leaves."""
    n = 0

    def walk(tree):
        nonlocal n
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if isinstance(v, (dict, list)):
                walk(v)
            elif k in BIAS_NAMES:
                v.add_((BIAS_SCALE * torch.randn(
                    v.shape, generator=gen, device=v.device)).to(v.dtype))
                n += 1
    walk(params)
    return n


def _init_biased(name, dev):
    """A full-width arch's seeded random bf16 weights on the card, biases
    perturbed; prints its parameters and init time."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    arch = get_config(name)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Model.init(arch, gen, device=dev)
    biases = _perturb_biases(model.params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(model.params))
    print(f"[init] {arch.name} full width, {arch.num_layers} layers"
          + (f" + {arch.enc_layers} encoder layers" if arch.enc_layers
             else "")
          + f", {n_params} parameters ({n_params * 2 / 1e9:.2f} GB), bf16 "
          f"weights on the card in {time.perf_counter() - t0:.1f}s; "
          f"{biases} bias leaves set to {BIAS_SCALE} N(0, 1)")
    return model, n_params


def _divergence(ref_model, run, want, got, frames=None):
    """The first position where two greedy static streams part, for each
    row that differs, with ``ref_model``'s top-2 logit margin there (its
    prefill over the prompt and the tokens before it)."""
    out = []
    for r in range(want.shape[0]):
        a, b = want[r].tolist(), got[r].tolist()
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        toks = torch.as_tensor([list(run["prompt"][r]) + a[:j]],
                               device=ref_model.device)
        caches = ref_model.init_caches(1, toks.shape[1])
        lg, _ = ref_model.prefill(caches, toks, None if frames is None
                                  else frames[r:r + 1])
        top2 = torch.topk(lg[0, 0].float(), 2).values
        out.append({"row": r, "token": j, "top2_margin":
                    (top2[0] - top2[1]).item()})
    return out


def static_qwen(model):
    """qwen2-vl-2b through the static engine, 4 prompts of 2048 tokens (two
    attn_chunk blocks), 32 new, greedy: with attn_impl="flash" (exactly 28
    flash launches in the prefill, none in decode) and "chunked" (plain
    PyTorch, no kernel); the flash prefill's last logits against the
    chunked one's (rel L2 0.05), the streams compared."""
    from repro_torch.models.model import Model
    arch = model.arch
    b, plen, glen = QWEN_STATIC
    runs = {}
    for impl in ("flash", "chunked"):
        m = Model(dataclasses.replace(arch, attn_impl=impl), model.params)
        run = run_static_counted(m, static_args(b, plen, glen))
        _expect_launches(run, {"flash_attention": (arch.num_layers, 0, 0)}
                         if impl == "flash" else {},
                         f"static {arch.name} ({impl})")
        runs[impl] = run
        print(f"[static] {arch.name} {arch.num_layers}L {impl}, greedy: {b} "
              f"prompts x {plen} tokens + {glen} new: prefill "
              f"{run['t_prefill'] * 1e3:.1f} ms, decode "
              f"{run['decode_ms_per_token']:.2f} ms/token, wall "
              f"{run['wall']:.3f} s ({run['tok_per_s']:.1f} tok/s), peak "
              f"memory {run['peak'] / 2**30:.2f} GiB; launches in prefill "
              f"{_nonzero(run['phase']['prefill'])}, in decode "
              f"{_nonzero(run['phase']['decode'])}")
    lines = _compare_logits(runs["flash"]["logits"], runs["chunked"]["logits"],
                            f"static {arch.name} flash vs chunked prefill")
    same = int(sum((runs["flash"]["tokens"][i] == runs["chunked"]["tokens"][i])
                   .all() for i in range(b)))
    print(f"[static] {arch.name} flash vs chunked (plain) prefill, last-"
          f"position logits (bf16, tol rel L2 0.05): " + "; ".join(lines)
          + f"; greedy streams identical: {same} of {b} (bf16 streams may "
          "fork on near-tied logits; not a failure)")
    return {impl: {k: run[k] for k in ("t_prefill", "decode_ms_per_token",
                                       "wall", "tok_per_s", "peak")}
            | {"launches_prefill": run["phase"]["prefill"]["flash_attention"],
               "launches_decode": run["phase"]["decode"]["flash_attention"]}
            for impl, run in runs.items()} | {
        "logits_flash_vs_chunked": lines, "identical_streams": same}


def qwen_phase(dev, rng, marks):
    """qwen2-vl-2b at full width and depth (28 layers, d_model 1536, 12 / 2
    heads, vocab 151936 tied, M-RoPE with text-only positions, biases on
    every projection perturbed; bf16, seeded): the paged path's logits
    against the dense plain forward, the llama trace unfused, fused and
    fused at decode_steps=4 (streams bitwise N=1's), then the static
    engine with flash and chunked prefill."""
    model, n_params = _init_biased("qwen2-vl-2b", dev)
    arch = model.arch
    if n_params != arch.param_count() + arch.d_model:
        _fail(f"{arch.name}: {n_params} parameters, param_count says "
              f"{arch.param_count()} and the final norm {arch.d_model}")
    logit_err = check_model_logits(model, rng, dev)
    marks["qwen2-vl checks"] = time.perf_counter()
    runs = {fused: serve(model, logit_err, fused) for fused in (False, True)}
    same = sum(runs[False]["results"][i]["tokens"]
               == runs[True]["results"][i]["tokens"]
               for i in runs[False]["results"])
    print(f"[streams] {arch.name} fused vs unfused serve: {same} of "
          f"{len(runs[False]['results'])} request streams identical (bf16 "
          "streams may fork on near-tied logits; not a failure)")
    ref = {i: r["tokens"] for i, r in runs[True]["results"].items()}
    multi = serve_multistep(model, 4, ref, f"fused {arch.name}",
                            want=_fused_llama_launches(arch))
    marks["qwen2-vl serves"] = time.perf_counter()
    static = static_qwen(model)
    marks["static qwen2-vl"] = time.perf_counter()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    serves = {}
    for fused, r in runs.items():
        serves["fused" if fused else "unfused"] = {
            "wall_s": r["wall"], "tok_per_s": r["tok_per_s"],
            "mean_ttft_s": r["mean_ttft_s"], "peak": r["peak"],
            "decode_steps": r["steps"], "prefill_chunks": r["prefill_chunks"],
            "launches": _nonzero(r["launches"]),
            "launches_a_decode_step": {
                k: v / r["steps"] for k, v in r["phase"]["decode"].items()
                if v}}
    print(f"[qwen2-vl] {arch.name}: tok/s unfused "
          f"{serves['unfused']['tok_per_s']:.1f}, fused "
          f"{serves['fused']['tok_per_s']:.1f}, fused N=4 "
          f"{multi['tok_per_s']:.1f}; mean TTFT unfused "
          f"{serves['unfused']['mean_ttft_s'] * 1e3:.1f} ms, fused "
          f"{serves['fused']['mean_ttft_s'] * 1e3:.1f} ms; peak memory "
          f"{max(s['peak'] for s in serves.values()) / 2**30:.2f} GiB; "
          f"kernel launches a decode step: unfused "
          f"{serves['unfused']['launches_a_decode_step']}, fused "
          f"{serves['fused']['launches_a_decode_step']}")
    return {"n_params": n_params, "logit_err": logit_err, "serves": serves,
            "identical_streams": same, "multistep_n4": multi,
            "static": static,
            "launches": {("fused" if f else "unfused"): r["launches"]
                         for f, r in runs.items()}}


def whisper_phase(dev):
    """whisper-base at full width (6 encoder + 6 decoder layers, d_model
    512, 8 / 8 heads of 64, vocab 51865 padded to 51968, tied; layernorm,
    GeLU, biases perturbed; bf16, seeded) through the static engine: 4
    prompts of 64 tokens and 1500 frames of the stub frontend, 32 new
    tokens, greedy then at T 0.8 / top-k 40 / top-p 0.95, with
    attn_impl="flash" (exactly 6 flash launches in the encoder, 6 in the
    decoder prefill's cross-attention, none in decode) and "chunked" (no
    kernel but the sampler's); the flash prefill's last logits against the
    chunked one's (rel L2 0.05); greedy streams equal, or each first
    divergence printed with the chunked path's top-2 margin there."""
    from repro_torch.models.model import Model
    model, n_params = _init_biased("whisper-base", dev)
    arch = model.arch
    b, plen, glen = WHISPER_STATIC
    n = arch.num_layers
    runs = {}
    for impl in ("flash", "chunked"):
        m = Model(dataclasses.replace(arch, attn_impl=impl), model.params)
        for mode, kw in (("greedy", {}), ("sampled", STATIC_SAMPLED)):
            run = run_static_counted(m, static_args(b, plen, glen, **kw))
            flash = {k: run["phase"][k]["flash_attention"]
                     for k in ("encode", "prefill", "decode")}
            if flash != ({"encode": arch.enc_layers, "prefill": n,
                          "decode": 0} if impl == "flash" else
                         {"encode": 0, "prefill": 0, "decode": 0}) or \
                    run["launches"]["flash_attention"] != sum(flash.values()):
                _fail(f"static {arch.name} ({impl}, {mode}): flash launches "
                      f"{flash} (all {run['launches']['flash_attention']}), "
                      f"expected {arch.enc_layers} in the encoder, {n} in "
                      "the prefill and none in decode (flash only)")
            want = {"filter_logits": glen, "draw_tokens": glen} if kw else {}
            for k, v in run["launches"].items():
                if k != "flash_attention" and v != want.get(k, 0):
                    _fail(f"static {arch.name} ({impl}, {mode}): {k} "
                          f"launched {v} times, expected {want.get(k, 0)}")
            runs[(impl, mode)] = run
            print(f"[static] {arch.name} {impl}, {mode}: {b} prompts x "
                  f"{plen} tokens and {arch.enc_seq_len} frames + {glen} new:"
                  f" prefill {run['t_prefill'] * 1e3:.2f} ms (encoder "
                  f"{run['t_encode'] * 1e3:.2f}, cross K/V fill "
                  f"{run['t_cross_fill'] * 1e3:.2f}, decoder "
                  f"{run['t_decoder_prefill'] * 1e3:.2f}), decode "
                  f"{run['decode_ms_per_token']:.2f} ms/token, wall "
                  f"{run['wall']:.3f} s ({run['tok_per_s']:.1f} tok/s), peak "
                  f"memory {run['peak'] / 2**30:.3f} GiB; flash launches "
                  f"{flash}, all launches {_nonzero(run['launches'])}")
    fl, ch = runs[("flash", "greedy")], runs[("chunked", "greedy")]
    lines = _compare_logits(fl["logits"], ch["logits"],
                            f"static {arch.name} flash vs chunked prefill")
    chunked = Model(dataclasses.replace(arch, attn_impl="chunked"),
                    model.params)
    forks = _divergence(chunked, ch, ch["tokens"], fl["tokens"],
                        ch["frames"])
    sampled_same = int(sum(
        (runs[("flash", "sampled")]["tokens"][i]
         == runs[("chunked", "sampled")]["tokens"][i]).all()
        for i in range(b)))
    print(f"[static] {arch.name} flash vs chunked (plain) prefill, last-"
          f"position logits (bf16, tol rel L2 0.05): " + "; ".join(lines)
          + f"; greedy streams identical: {b - len(forks)} of {b}"
          + (f", first divergences (chunked top-2 margin there): {forks}"
             if forks else "")
          + f"; sampled streams identical: {sampled_same} of {b}")
    del model, chunked
    gc.collect()
    torch.cuda.empty_cache()
    return {"n_params": n_params,
            "runs": {f"{impl} {mode}": {
                k: run[k] for k in ("t_prefill", "t_encode", "t_cross_fill",
                                    "t_decoder_prefill",
                                    "decode_ms_per_token", "wall",
                                    "tok_per_s", "peak")}
                | {"flash_launches": {k: run["phase"][k]["flash_attention"]
                                      for k in ("encode", "prefill",
                                                "decode")}}
                for (impl, mode), run in runs.items()},
            "logits_flash_vs_chunked": lines, "greedy_forks": forks,
            "sampled_identical": sampled_same}


# --------------------------------------------------------- phase 6d ---
# The registry's last three archs: command-r-35b at full width and depth
# (its 256,000-entry rows through the sampler's cluster kernels),
# mistral-large-123b and llama4-maverick-400b-a17b at full width with their
# depth cut to fit one card.
COMMAND_R = "command-r-35b"
CUT_DEPTH = {"mistral-large-123b": 2,            # of 88 layers
             "llama4-maverick-400b-a17b": 2}     # one period of 48: a dense
                                                 # layer, then a MoE one
CUT_GEN = 16                    # new tokens a request in the cut serves
COMMAND_R_STATIC = (4, 2048, 32)    # batch, prompt, new tokens
NEW_FLASH_CASES = {
    # the static prefills at the new archs' heads (D 128): command-r's 64 /
    # 8 (G 8) at its static shape, mistral's 96 / 8 (G 12), llama4's 40 /
    # 8 (G 5)
    "command-r-35b static prefill": (4, 2048, 2048, True, 0, 0, None,
                                     (64, 8, 128), False),
    "mistral-large-123b prefill": (1, 2048, 2048, True, 0, 0, None,
                                   (96, 8, 128), False),
    "llama4-maverick-400b-a17b prefill": (2, 2048, 2048, True, 0, 0, None,
                                          (40, 8, 128), False),
}


def check_wide_sampler(v, dev, rng):
    """The filter and the draw at rows of ``v`` entries (command-r-35b's
    256,000) bitwise against their plain versions (the bisection, and the
    sort-based oracle for the filter; the plain draw of ref.row_uniforms)
    at [1, v] (top-k off, top-p 0.95: the search over the whole row), [8,
    v] (the serve's rows) and [16, v], each call one device kernel;
    device times of every case from the profiler, the [8, v] call timed
    beside its bound, its plain version and (the filter) the sort-based
    filter. Returns the filter's and the draw's rows."""
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ops, ref
    lg = torch.as_tensor(rng.normal(size=(16, v)).astype(np.float32) * 3.0,
                         device=dev)
    lg[3, :40] = lg[3, 40]                 # ties across the k-th value
    top_k = torch.as_tensor([40, 40, 0, 40, 1, 40, 0, v + 5] * 2,
                            dtype=torch.int32, device=dev)
    top_p = torch.as_tensor([0.95, 1.0, 0.95, 0.95, 0.5, 0.95, 1.0, 0.99]
                            * 2, dtype=torch.float32, device=dev)
    cases = {f"[1, {v}] top-k off, top-p 0.95": (lg[2:3].contiguous(),
                                                 top_k[2:3], top_p[2:3]),
             f"[8, {v}]": (lg[:8], top_k[:8], top_p[:8]),
             f"[16, {v}]": (lg, top_k, top_p)}
    filt, draw, sizes, kept = {}, {}, {}, {}
    for case, args in cases.items():
        s = args[0].shape[0]
        out = ops.filter_logits(*args)
        plain = ref.filter_logits_bisect(*args)
        oracle = ref.filter_logits_ref(*args)
        seeds, pos = _draw_keys(s, dev)
        tok = ops.draw_tokens(out, seeds, pos)
        ptok = head_ref.draw_tokens(out, head_ref.row_uniforms(seeds, pos))
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), plain.view(torch.int32)):
            bad = (out.view(torch.int32) != plain.view(torch.int32)).sum(1)
            _fail(f"filter_logits {case} differs from its plain version in "
                  f"{bad.tolist()} entries a row (contract: bitwise equal)")
        if not torch.equal(out.view(torch.int32), oracle.view(torch.int32)):
            _fail(f"filter_logits {case} differs from the sort-based oracle")
        if not torch.equal(tok, ptok):
            _fail(f"draw_tokens {case}: {tok.tolist()} differs from its "
                  f"plain version {ptok.tolist()} (contract: equal tokens)")
        _kernels_a_call(lambda: ops.filter_logits(*args), "filter_logits")
        _kernels_a_call(lambda: ops.draw_tokens(out, seeds, pos),
                        "draw_tokens")
        filt[case] = _profiled_ms(lambda: ops.filter_logits(*args),
                                  ("filter_kernel",))
        draw[case] = _profiled_ms(lambda: ops.draw_tokens(out, seeds, pos),
                                  ("draw_kernel",))
        sizes[case] = ops.cluster_plan(s, v)
        kept[case] = (out, seeds, pos)
    main = f"[8, {v}]"
    lg8, tk8, tp8 = cases[main]
    out8, seeds8, pos8 = kept[main]
    f_ms = _time_ms(lambda: ops.filter_logits(lg8, tk8, tp8), 20)
    f_plain = _time_ms(lambda: ref.filter_logits_bisect(lg8, tk8, tp8), 2,
                       warmup=1)
    f_lib = _time_ms(lambda: ref.filter_logits_ref(lg8, tk8, tp8), 2,
                     warmup=1)
    f_bound, f_by = _bound(2 * lg8.numel() * 4 + 8 * 8, 0.0, fp32=True)
    d_ms = _time_ms(lambda: ops.draw_tokens(out8, seeds8, pos8), 200)
    d_plain = _time_ms(lambda: head_ref.draw_tokens(
        out8, head_ref.row_uniforms(seeds8, pos8)), 5, warmup=1)
    d_bound, d_by = _bound(out8.numel() * 4 + 8 * (8 + 4 + 4),
                           4.0 * out8.numel(), fp32=True)
    print(f"[sampler] {COMMAND_R}'s rows: filter and draw bitwise (the "
          f"filter also against the sort-based oracle), one kernel a call;"
          f" device ms by case (CTAs a row): " + "; ".join(
              f"{c}: filter {_ms(filt[c])}, draw {_ms(draw[c])} "
              f"({sizes[c]})" for c in cases)
          + f"; at {main}: filter {f_ms:.5f} ms (bound {f_bound:.5f}, "
          f"plain {f_plain:.3f}, sort-based {f_lib:.3f}), draw "
          f"{d_ms:.5f} ms (bound {d_bound:.5f}, plain {d_plain:.3f})")
    common = {"route": "cuda", "source": "src/repro_torch/kernels/"
              "fused_sampling/csrc/sampling.cu", "max_abs_err": 0.0,
              "ctas_a_row_by_case": sizes}
    return (dict(common, name=f"filter_logits ({COMMAND_R}, V {v})",
                 replaces="src/repro/kernels/fused_sampling/kernel.py:73",
                 ms=f_ms, plain_ms=f_plain, bound_ms=f_bound, bound_by=f_by,
                 library_ms=f_lib,
                 library_note="the sort-based filter (ref.filter_logits_ref)",
                 profiler_device_ms_per_call=filt[main],
                 device_ms_by_case=filt),
            dict(common, name=f"draw_tokens ({COMMAND_R}, V {v})",
                 replaces="src/repro/kernels/fused_lm_head/ref.py:90",
                 ms=d_ms, plain_ms=d_plain, bound_ms=d_bound, bound_by=d_by,
                 library_ms=None, profiler_device_ms_per_call=draw[main],
                 device_ms_by_case=draw))


def new_arch_kernel_checks(dev, rng):
    """The kernels at the shapes the new archs' paths give them, held as in
    phase 3: command-r-35b's tied head [256000, 8192] (bitwise on exact
    inputs at 16, 1 and 8 rows), the filter and draw at its 256,000-entry
    rows (check_wide_sampler), the untied head at mistral-large's (12288,
    32768) and llama4's (5120, 202048), paged decode and prefill at G 8
    (command-r), 12 (mistral) and 5 (llama4), the add + norm as a
    LayerNorm with bias at D 8192 (command-r) and an RMSNorm at D 5120
    (llama4; mistral's D 12288 is in phase 3), the filter and draw at
    llama4's and mistral's vocabularies, and flash at the three archs'
    heads (NEW_FLASH_CASES)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import pad_vocab
    cr = get_config(COMMAND_R)
    ml, l4 = (get_config(n) for n in CUT_DEPTH)
    head = check_head_tokens(cr, dev)
    head["name"] = f"head_tokens ({COMMAND_R}, tied W [256000, 8192])"
    torch.cuda.empty_cache()
    wide = check_wide_sampler(pad_vocab(cr.vocab_size), dev, rng)
    untied = {a.name: check_head_tokens(a, dev, untied=True)
              for a in (ml, l4)}
    torch.cuda.empty_cache()
    paged = {a.name: check_paged_heads(a, rng, dev) for a in (cr, ml, l4)}
    norm = {cr.name: check_residual_norm_width(cr.d_model, dev, cr.name,
                                               kind="layernorm"),
            l4.name: check_residual_norm_width(l4.d_model, dev, l4.name)}
    sampler = {f"[8, {pad_vocab(a.vocab_size)}]": check_sampler_vocab(
        pad_vocab(a.vocab_size), dev, rng) for a in (l4, ml)}
    print(f"[sampler] filter and draw bitwise at llama4's and "
          f"mistral-large's vocabularies (CTAs a row, device ms): {sampler}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    flash = [_flash_case(gen, dev, name, spec, None, 1024)
             for name, spec in NEW_FLASH_CASES.items()]
    _print_flash(flash)
    return {"head": head, "wide": wide, "untied": untied, "paged": paged,
            "residual_norm": norm, "sampler": sampler, "flash": flash}


def static_command_r(model):
    """command-r-35b through the static engine, 4 prompts of 2048 tokens,
    32 new: attn_impl="flash" greedy and at T 0.8 / top-k 40 / top-p 0.95
    (exactly one flash launch a layer in the prefill, none in decode; one
    filter and one draw a token when sampled), then "chunked" greedy
    (plain PyTorch); the flash prefill's last logits against the chunked
    one's (rel L2 0.05), the greedy streams compared."""
    from repro_torch.models.model import Model
    arch = model.arch
    b, plen, glen = COMMAND_R_STATIC
    runs = {}
    for impl, mode, kw in (("flash", "greedy", {}),
                           ("flash", "sampled", STATIC_SAMPLED),
                           ("chunked", "greedy", {})):
        m = Model(dataclasses.replace(arch, attn_impl=impl), model.params)
        run = run_static_counted(m, static_args(b, plen, glen, **kw))
        want = {"flash_attention": (arch.num_layers, 0, 0)} \
            if impl == "flash" else {}
        if kw:
            want.update(filter_logits=(0, 0, glen), draw_tokens=(0, 0, glen))
        _expect_launches(run, want, f"static {arch.name} ({impl}, {mode})")
        runs[(impl, mode)] = run
        print(f"[static] {arch.name} {arch.num_layers}L {impl}, {mode}: {b} "
              f"prompts x {plen} tokens + {glen} new: prefill "
              f"{run['t_prefill'] * 1e3:.1f} ms, decode "
              f"{run['decode_ms_per_token']:.2f} ms/token, wall "
              f"{run['wall']:.3f} s ({run['tok_per_s']:.1f} tok/s), peak "
              f"memory {run['peak'] / 2**30:.2f} GiB; launches in prefill "
              f"{_nonzero(run['phase']['prefill'])}, in decode "
              f"{_nonzero(run['phase']['decode'])}, in all "
              f"{_nonzero(run['launches'])}")
    flash, chunked = runs[("flash", "greedy")], runs[("chunked", "greedy")]
    lines = _compare_logits(flash["logits"], chunked["logits"],
                            f"static {arch.name} flash vs chunked prefill")
    same = int(sum((flash["tokens"][i] == chunked["tokens"][i]).all()
                   for i in range(b)))
    print(f"[static] {arch.name} flash vs chunked (plain) prefill, last-"
          f"position logits (bf16, tol rel L2 0.05): " + "; ".join(lines)
          + f"; greedy streams identical: {same} of {b} (bf16 streams may "
          "fork on near-tied logits; not a failure)")
    return {f"{impl} {mode}": {k: run[k] for k in (
        "t_prefill", "decode_ms_per_token", "wall", "tok_per_s", "peak")}
        | {"launches": _nonzero(run["launches"])}
        for (impl, mode), run in runs.items()} | {
        "logits_flash_vs_chunked": lines, "identical_greedy_streams": same}


def _serve_summary(runs) -> dict:
    out = {}
    for fused, r in runs.items():
        out["fused" if fused else "unfused"] = {
            "wall_s": r["wall"], "tok_per_s": r["tok_per_s"],
            "mean_ttft_s": r["mean_ttft_s"], "peak": r["peak"],
            "decode_steps": r["steps"], "prefill_chunks": r["prefill_chunks"],
            "prefills": r["prefills"], "launches": _nonzero(r["launches"]),
            "launches_a_decode_step": {
                k: v / r["steps"] for k, v in r["phase"]["decode"].items()
                if v}}
    return out


def _same_streams(runs, label) -> int:
    same = sum(runs[False]["results"][i]["tokens"]
               == runs[True]["results"][i]["tokens"]
               for i in runs[False]["results"])
    print(f"[streams] {label} fused vs unfused serve: {same} of "
          f"{len(runs[False]['results'])} request streams identical (bf16 "
          "streams may fork on near-tied logits; not a failure)")
    return same


def command_r_phase(dev, rng, marks):
    """command-r-35b at full width and depth (40 layers, d_model 8192, 64 /
    8 heads, d_ff 22528, LayerNorm with its bias, vocab 256000 tied; 30.28
    B parameters, 60.6 GB in bf16, seeded, the LayerNorm biases perturbed):
    its parameter count on the card, the paged path's logits against the
    dense plain forward, the llama trace unfused (the filter and the draw
    at [S, 256000]) then fused (the head's epilogue at 256,000) and fused
    at decode_steps=4 (streams bitwise N=1's), a window of the fused serve
    profiled (4 requests, 16 new tokens), then the static engine."""
    model, n_params = _init_biased(COMMAND_R, dev)
    arch = model.arch
    # param_count counts the blocks' norm scales; the card also holds the
    # final norm's scale and bias and every block norm's bias (LayerNorm)
    want = arch.param_count() + (2 + 2 * arch.num_layers) * arch.d_model
    if n_params != want:
        _fail(f"{arch.name}: {n_params} parameters, expected {want} "
              f"(param_count {arch.param_count()} + the LayerNorm biases "
              f"and the final norm)")
    logit_err = check_model_logits(model, rng, dev)
    marks["command-r checks"] = time.perf_counter()
    runs = {fused: serve(model, logit_err, fused) for fused in (False, True)}
    same = _same_streams(runs, arch.name)
    ref = {i: r["tokens"] for i, r in runs[True]["results"].items()}
    multi = serve_multistep(model, 4, ref, f"fused {arch.name}",
                            want=_fused_llama_launches(arch))
    marks["command-r serves"] = time.perf_counter()
    window = [dataclasses.replace(r, max_new_tokens=CUT_GEN)
              for r in trace(arch, SEED)[:4]]
    prof = profile_serve(model, make_engine(model, True), window)
    marks["command-r profile"] = time.perf_counter()
    static = static_command_r(model)
    marks["static command-r"] = time.perf_counter()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    serves = _serve_summary(runs)
    print(f"[command-r] {arch.name}: tok/s unfused "
          f"{serves['unfused']['tok_per_s']:.1f}, fused "
          f"{serves['fused']['tok_per_s']:.1f}, fused N=4 "
          f"{multi['tok_per_s']:.1f}; mean TTFT unfused "
          f"{serves['unfused']['mean_ttft_s'] * 1e3:.1f} ms, fused "
          f"{serves['fused']['mean_ttft_s'] * 1e3:.1f} ms; peak memory "
          f"{max(s['peak'] for s in serves.values()) / 2**30:.2f} GiB")
    return {"n_params": n_params, "logit_err": logit_err, "serves": serves,
            "identical_streams": same, "multistep_n4": multi,
            "profile": PROFILE_KINDS.get(arch.name),
            "profile_launches": sum(c for _, c in prof.values()),
            "static": static,
            "launches": {("fused" if f else "unfused"): r["launches"]
                         for f, r in runs.items()}}


def cut_depth_phase(name, dev, rng):
    """``name`` at full width with CUT_DEPTH[name] of its layers (the whole
    model does not fit one H100's 80 GB), seeded bf16 weights: the logits
    check (the dense one, or for a MoE the fp32-gated one at a raised
    capacity factor), then the trace's first 4 requests (CUT_GEN new tokens,
    half sampled at T 0.8 / top-k 40 / top-p 0.95) served unfused and
    fused with every launch counter set to 0 just before each run and read
    just after, the streams compared."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.layers import pad_vocab
    from repro_torch.models.model import Model
    full = get_config(name)
    arch = dataclasses.replace(full, num_layers=CUT_DEPTH[name])
    t0 = time.perf_counter()
    model = Model.init(arch, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(model.params))
    # the final norm, and the rows padding the vocabulary to a multiple of
    # 128 in the embedding and the untied head (llama4: 202048 -> 202112)
    pad = (pad_vocab(arch.vocab_size) - arch.vocab_size) * arch.d_model
    want = arch.param_count() + arch.d_model + pad * (
        1 if arch.tie_embeddings else 2)
    if n_params != want:
        _fail(f"{arch.name}: {n_params} parameters, expected {want} "
              f"(param_count {arch.param_count()}, the final norm, "
              f"{pad} a padded table)")
    reduced = (f"num_layers {full.num_layers} -> {arch.num_layers}: the "
               f"whole model's {full.param_count()} parameters "
               f"({full.param_count() * 2 / 1e9:.1f} GB in bf16) exceed one "
               f"H100's 80 GB")
    print(f"[init] {name} at full width, {arch.num_layers} of its "
          f"{full.num_layers} layers: {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB), bf16 weights on the card in "
          f"{time.perf_counter() - t0:.1f}s; reduced: {reduced}")
    logits = None
    if arch.moe is not None:
        logit_err, logits = check_moe_logits(model, rng, dev)
    else:
        logit_err = check_model_logits(model, rng, dev)
    reqs = [dataclasses.replace(r, max_new_tokens=CUT_GEN)
            for r in trace(arch, SEED)[:4]]
    runs = {fused: serve(model, logit_err, fused, reqs=reqs)
            for fused in (False, True)}
    same = _same_streams(runs, f"{name} ({arch.num_layers} layers)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": arch.num_layers, "reduced": reduced,
            "n_params": n_params, "logit_err": logit_err, "logits": logits,
            "serves": _serve_summary(runs), "identical_streams": same}


# ---------------------------------------------------------------- phase 7 ---
# The training slice: bert-large MLM, B8 / S128 (the paper's Phase 1).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 6
GELU_TAIL = 2.0 ** -22         # the fp32 tanh-GeLU formula's own error per
                               # |h|: 0.5 |h| times tanh's error in its
                               # cancelling tail (h < -4, 1 + tanh ~ 0)
BLOCK_REL_L2 = 0.03            # one block's output and grads, two bf16
                               # paths (or bf16 vs fp32): a few roundings
                               # of 2^-8 each through forward and backward


def _ln_tol(p: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
    """1 bf16 ulp of max(|output|, |output before the bias|): the kernel's
    only freedom is the order of its fp32 statistics, and cancellation
    against the bias can lift that difference above an ulp of a small
    output."""
    return _bf16_ulp(torch.maximum(p.float().abs(), pre.float().abs()))


def check_residual_layernorm(dev):
    """The training block's add + norm (layernorm + bias, bf16 params) at
    [B*S, 1024] for B8 with S128 and S512."""
    from repro_torch.kernels.fused_layernorm import ops, ref
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    d, err, times, keep = 1024, 0.0, {}, None
    for rows in (1024, 4096):
        x = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        r = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        s = (1 + 0.1 * torch.randn((d,), generator=gen,
                                   device=dev)).bfloat16()
        b = (0.1 * torch.randn((d,), generator=gen, device=dev)).bfloat16()
        y = ops.fused_residual_layernorm(x, r, s, b)
        p = ref.fused_residual_layernorm(x, r, s, b)
        pre = ref.fused_residual_layernorm(x, r, s)
        torch.cuda.synchronize()
        diff = (y.float() - p.float()).abs()
        if not bool((diff <= _ln_tol(p, pre)).all()):
            _fail(f"fused_residual_layernorm [{rows}, {d}]: differs from its "
                  f"plain version beyond 1 bf16 ulp (max abs "
                  f"{diff.max().item()})")
        err = max(err, diff.max().item())
        times[rows] = _time_ms(
            lambda: ops.fused_residual_layernorm(x, r, s, b), 200)
        if rows == 1024:
            keep = (x, r, s, b)
    x, r, s, b = keep
    plain_ms = _time_ms(lambda: ref.fused_residual_layernorm(x, r, s, b), 50)
    h = x + r
    library_ms = _time_ms(lambda: F.layer_norm(h, (d,), s, b), 200)
    library_device_ms = _profiled_ms(lambda: F.layer_norm(h, (d,), s, b),
                                     ("",))
    dev_ms = _profiled_ms(lambda: ops.fused_residual_layernorm(x, r, s, b),
                          ("resln_kernel",))
    bound_ms, bound_by = _bound(3 * 1024 * d * 2 + 2 * d * 2,
                                10.0 * 1024 * d, fp32=True)
    return {"name": "fused_residual_layernorm", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_layernorm/csrc/"
                      "residual_layernorm.cu",
            "replaces": "src/repro/kernels/fused_layernorm/kernel.py:36",
            "max_abs_err": err,
            "tol": "1 bf16 ulp of max(|output|, |output before the bias|)",
            "ms": times[1024], "ms_4096_rows": times[4096],
            "profiler_device_ms_per_call": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "library_note": "F.layer_norm of a precomputed bf16 x + "
                            "residual: the norm only, not the add"}


def check_bias_gelu(dev):
    """bias + tanh-GeLU at [B*S, 4096] for B8 with S128 and S512, and a
    tail-heavy [1024, 4096] (h = x + b spread over [-12, 12]), against the
    plain version run in fp32 on the same bf16 inputs (the kernel's
    arithmetic; the plain version itself adds in bf16, as JAX's). Device
    time at both sizes beside F.gelu's on a precomputed sum and the byte
    bound."""
    from repro_torch.kernels.bias_gelu import ops, ref
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    f, err, err_bf16, keep = 4096, 0.0, 0.0, None
    times, dev_ms, lib_ms, bounds = {}, {}, {}, {}
    for rows in (1024, 4096, "tail"):
        n = 1024 if rows == "tail" else rows
        b = (0.5 * torch.randn((f,), generator=gen, device=dev)).bfloat16()
        if rows == "tail":
            x = (24 * torch.rand((n, f), generator=gen, device=dev) - 12
                 - b.float()).bfloat16()
        else:
            x = (2 * torch.randn((n, f), generator=gen,
                                 device=dev)).bfloat16()
        y = ops.bias_gelu(x, b).float()
        h = x.float() + b.float()
        p32 = ref.bias_gelu(x.float(), b.float()).bfloat16().float()
        pbf = ref.bias_gelu(x, b).float()
        torch.cuda.synchronize()
        diff = (y - p32).abs()
        if not bool((diff <= _bf16_ulp(p32) + h.abs() * GELU_TAIL).all()):
            _fail(f"bias_gelu [{n}, {f}] ({rows}): differs from its plain "
                  f"version in fp32 beyond 1 bf16 ulp + |h| 2^-22 (max abs "
                  f"{diff.max().item()})")
        if rows == "tail":
            tail = {"max_abs_err": diff.max().item(),
                    "h_range": [h.min().item(), h.max().item()],
                    "worst_of_gate": (diff / (_bf16_ulp(p32) + h.abs()
                                              * GELU_TAIL)).max().item()}
            continue
        err = max(err, diff.max().item())
        err_bf16 = max(err_bf16, (y - pbf).abs().max().item())
        times[rows] = _time_ms(lambda: ops.bias_gelu(x, b), 200)
        hb = x + b
        dev_ms[rows] = _profiled_ms(lambda: ops.bias_gelu(x, b),
                                    ("bias_gelu_kernel",))
        lib_ms[rows] = _profiled_ms(lambda: F.gelu(hb, approximate="tanh"),
                                    ("",))
        # x read and y written once, the bias once; about 9 fp32
        # operations an element (the add, h * h, an FMA, a multiply, ex2,
        # an add, a reciprocal, a multiply)
        bounds[rows] = _bound(2 * rows * f * 2 + f * 2, 9.0 * rows * f,
                              fp32=True)
        if rows == 1024:
            keep = (x, b, hb)
    x, b, hb = keep
    plain_ms = _time_ms(lambda: ref.bias_gelu(x, b), 50)
    library_ms = _time_ms(lambda: F.gelu(hb, approximate="tanh"), 200)
    share = {r: (bounds[r][0] / dev_ms[r] if dev_ms[r] else None)
             for r in dev_ms}
    lib_share = {r: (bounds[r][0] / lib_ms[r] if lib_ms[r] else None)
                 for r in lib_ms}
    print("[bias_gelu] " + "; ".join(
        f"[{r}, {f}]: device {_ms(dev_ms[r])} ms against F.gelu "
        f"{_ms(lib_ms[r])} (x{(dev_ms[r] or 0) / (lib_ms[r] or 1):.3f}), "
        f"bound {bounds[r][0]:.6f} ({bounds[r][1]}); share of the bound "
        f"{share[r] or 0:.3f} (F.gelu {lib_share[r] or 0:.3f}); events "
        f"{times[r]:.5f}" for r in dev_ms)
        + f"; tail-heavy h in [{tail['h_range'][0]:.2f}, "
        f"{tail['h_range'][1]:.2f}]: {tail['worst_of_gate']:.3f} of the "
        f"gate; plan {tuple(ops.gelu_plan(1024, f, _sms(dev)))}")
    return {"name": "bias_gelu", "route": "cuda",
            "source": "src/repro_torch/kernels/bias_gelu/csrc/bias_gelu.cu",
            "replaces": "src/repro/kernels/bias_gelu/kernel.py:28",
            "max_abs_err": err, "max_abs_err_vs_bf16_plain": err_bf16,
            "tail_heavy": tail,
            "tol": "1 bf16 ulp + |h| 2^-22 of the plain version in fp32",
            "ms": times[1024], "ms_4096_rows": times[4096],
            "profiler_device_ms_per_call": dev_ms[1024],
            "profiler_device_ms_4096_rows": dev_ms[4096],
            "plain_ms": plain_ms,
            "bound_ms": bounds[1024][0], "bound_by": bounds[1024][1],
            "bound_ms_4096_rows": bounds[4096][0],
            "share_of_bound": share[1024],
            "share_of_bound_4096_rows": share[4096],
            "library_ms": library_ms,
            "library_device_ms": lib_ms[1024],
            "library_device_ms_4096_rows": lib_ms[4096],
            "library_share_of_bound": lib_share[1024],
            "library_share_of_bound_4096_rows": lib_share[4096],
            "plan": ops.gelu_plan(1024, f, _sms(dev))._asdict(),
            "library_note": "F.gelu(approximate='tanh') of a precomputed "
                            "bf16 x + bias: the activation only"}


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def check_lamb(dev):
    """Both LAMB stages on the leaf shapes of bert-large (wqkv, the
    embedding, a bias), a ragged length, and the largest leaves the
    training phase gives them (llama3.2-3b's tied embedding [128256,
    3072], 394 M elements, the most partial sums and the widest indices,
    and mamba2-1.3b's [50304, 2048]), g in bf16 as under master weights:
    m', v' within 2 fp32 ulps (they follow the plain version's operation
    order), the trust ratio within 1e-5 relative (sums in another order),
    w' within 2^-22 of the leaf's largest |w|; then one ratio a row of an
    expert leaf and one over a group of leaves, held the same way, and a
    dp=2 rank's ZeRO shards (``check_lamb_shards``). Timed at bert-large's
    embedding."""
    from repro_torch.kernels.fused_lamb import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    lr = 1e-3
    sc = torch.tensor([0.7, 10.0, 1000.0], device=dev)   # ginv, c1, c2
    lines, r_err, mv_err, w_err, bitwise = [], 0.0, 0.0, 0.0, True
    for shape in ((1024, 3072), (30592, 1024), (1024,), (4099,),
                  (128256, 3072), (50304, 2048)):
        w = 0.02 * torch.randn(shape, generator=gen, device=dev)
        g = (1e-3 * torch.randn(shape, generator=gen, device=dev)).bfloat16()
        m = 1e-4 * torch.randn(shape, generator=gen, device=dev)
        v = 1e-7 * torch.rand(shape, generator=gen, device=dev)
        pw, pm, pv, pr = ref.lamb_stage12(w, g, m, v, ginv=sc[0], c1=sc[1],
                                          c2=sc[2], lr=lr, **hyper)
        r = ops.lamb_update_(w, g, m, v, sc, lr=lr, **hyper)
        torch.cuda.synchronize()
        ulp32 = torch.exp2(torch.floor(torch.log2(
            torch.maximum(pm.abs(), pv.abs()).clamp_min(2.0 ** -126))) - 23)
        mv = max((m - pm).abs().max().item(), (v - pv).abs().max().item())
        if not bool(((m - pm).abs() <= 2 * ulp32).all()
                    and ((v - pv).abs() <= 2 * ulp32).all()):
            _fail(f"lamb_stage1 {shape}: m' or v' differ from the plain "
                  f"version beyond 2 fp32 ulps (max abs {mv})")
        rel = abs(r.item() / pr.item() - 1.0)
        werr = (w - pw).abs().max().item()
        if not (rel <= 1e-5 and werr <= 2.0 ** -22 * pw.abs().max().item()):
            _fail(f"lamb_stage2 {shape}: trust ratio rel err {rel} (tol "
                  f"1e-5) or w' max abs err {werr}")
        r_err, mv_err, w_err = max(r_err, rel), max(mv_err, mv), max(w_err,
                                                                   werr)
        bitwise &= torch.equal(m, pm) and torch.equal(v, pv)
        lines.append(f"{shape}: m'/v' max abs {mv:.3e}, r rel {rel:.3e}, "
                     f"w' max abs {werr:.3e}")
        if shape == (30592, 1024):
            keep = (w, g, m, v)
    del w, g, m, v, pw, pm, pv, ulp32
    torch.cuda.empty_cache()

    def mv_close(a, p):
        ulp = torch.exp2(torch.floor(torch.log2(p.abs().clamp_min(
            2.0 ** -126))) - 23)
        return bool(((a - p).abs() <= 2 * ulp).all())

    # one ratio a row (a MoE expert leaf: deepseek-moe-16b's [64, 2048,
    # 1408] cut to 8 experts) and one ratio over a group of leaves
    # (whisper's encoder layers), each against its plain version
    ew = 0.02 * torch.randn((8, 2048, 1408), generator=gen, device=dev)
    eg = (1e-3 * torch.randn(ew.shape, generator=gen, device=dev)).bfloat16()
    em = 1e-4 * torch.randn(ew.shape, generator=gen, device=dev)
    ev = 1e-7 * torch.rand(ew.shape, generator=gen, device=dev)
    pw, pm, pv, pr = ref.lamb_stage12(ew, eg, em, ev, ginv=sc[0], c1=sc[1],
                                      c2=sc[2], lr=lr, rows=8, **hyper)
    r = ops.lamb_update_(ew, eg, em, ev, sc, lr=lr, rows=8, **hyper)
    rows_rel = (r / pr - 1).abs().max().item()
    rows_w = (ew - pw).abs().max().item()
    if not (mv_close(em, pm) and mv_close(ev, pv) and rows_rel <= 1e-5
            and rows_w <= 2.0 ** -22 * pw.abs().max()):
        _fail(f"lamb per-row ratios [8, 2048, 1408]: m'/v' within 2 fp32 "
              f"ulps {mv_close(em, pm) and mv_close(ev, pv)}, ratio rel err "
              f"{rows_rel}, w' max abs err {rows_w}")
    del ew, eg, em, ev, pw, pm, pv
    group = [[t(shape) for t in (
        lambda s: 0.02 * torch.randn(s, generator=gen, device=dev),
        lambda s: (1e-3 * torch.randn(s, generator=gen, device=dev)
                   ).bfloat16(),
        lambda s: 1e-4 * torch.randn(s, generator=gen, device=dev),
        lambda s: 1e-7 * torch.rand(s, generator=gen, device=dev))]
        for shape in ((512, 1536), (512, 1536), (4099,))]
    want_w, want_m, want_v, gr = ref.lamb_stage12(
        *(list(x) for x in zip(*group)), ginv=sc[0], c1=sc[1], c2=sc[2],
        lr=lr, **hyper)
    r = ops.lamb_update_(*(list(x) for x in zip(*group)), sc, lr=lr,
                         **hyper)
    group_rel = abs(r.item() / gr.item() - 1)
    group_w = max((lf[0] - w).abs().max().item()
                  for lf, w in zip(group, want_w))
    if not (group_rel <= 1e-5 and group_w <= 2.0 ** -22 * max(
            w.abs().max().item() for w in want_w) and all(
            mv_close(lf[2], pm_) and mv_close(lf[3], pv_)
            for lf, pm_, pv_ in zip(group, want_m, want_v))):
        _fail(f"lamb group update: ratio rel err {group_rel}, w' max abs "
              f"err {group_w}, or m'/v' beyond 2 fp32 ulps of the plain "
              f"version's")
    lines.append(f"per-row ratios [8, 2048, 1408]: r rel {rows_rel:.3e}, w' "
                 f"max abs {rows_w:.3e}; a group of 3 leaves: r rel "
                 f"{group_rel:.3e}, w' max abs {group_w:.3e}")
    r_err = max(r_err, rows_rel, group_rel)
    del group, want_w, want_m, want_v
    zero_shards = check_lamb_shards(dev, gen, sc, lr, hyper, mv_close)
    lines.append(f"ZeRO dp={DP} shards {zero_shards['shapes']}: r rel "
                 f"{zero_shards['ratio_rel_err']:.3e}, w' max abs "
                 f"{zero_shards['w_max_abs_err']:.3e}")
    r_err = max(r_err, zero_shards["ratio_rel_err"])
    w_err = max(w_err, zero_shards["w_max_abs_err"])
    w, g, m, v = keep
    n = w.numel()
    u = torch.empty_like(w)
    parts = torch.empty(2 * ops.grid_blocks(n), device=dev)
    rr = torch.empty(1, device=dev)
    ms1 = _time_ms(lambda: ops.stage1(w, g, m, v, sc, u, parts, **hyper), 50)
    ms2 = _time_ms(lambda: ops.stage2(w, u, parts, rr, lr=lr), 50)
    dev1 = _profiled_ms(lambda: ops.stage1(w, g, m, v, sc, u, parts,
                                           **hyper), ("stage1_kernel",))
    dev2 = _profiled_ms(lambda: ops.stage2(w, u, parts, rr, lr=lr),
                        ("stage2_kernel",))
    plain1 = _time_ms(lambda: ref.lamb_stage1(w, g, m, v, ginv=sc[0],
                                              c1=sc[1], c2=sc[2], **hyper),
                      10)
    plain2 = _time_ms(lambda: ref.lamb_stage2(
        w, u, lr=lr, r=ref.trust_ratio(w, u)), 10)
    b1, by1 = _bound(n * (4 + 2 + 4 + 4) + n * 12, 20.0 * n, fp32=True)
    b2, by2 = _bound(n * 8 + n * 4, 3.0 * n, fp32=True)
    print("[lamb] " + "; ".join(lines) + f"; m'/v' bitwise equal: {bitwise}")
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/fused_lamb/csrc/"
                        "fused_lamb.cu",
              "library_ms": None,
              "library_note": "no single PyTorch call computes a LAMB "
                              "stage", "timed_shape": "[30592 x 1024] fp32, "
                                                      "g bf16"}
    return [dict(common, name="lamb_stage1",
                 replaces="src/repro/kernels/fused_lamb/kernel.py:49",
                 zero_shards=zero_shards,
                 max_abs_err=mv_err, tol="m', v' within 2 fp32 ulps",
                 ms=ms1, profiler_device_ms_per_call=dev1, plain_ms=plain1,
                 bound_ms=b1, bound_by=by1),
            dict(common, name="lamb_stage2",
                 replaces="src/repro/kernels/fused_lamb/kernel.py:78",
                 max_abs_err=w_err, trust_ratio_rel_err=r_err,
                 tol="trust ratio 1e-5 relative; w' 2^-22 of max |w|",
                 ms=ms2, profiler_device_ms_per_call=dev2, plain_ms=plain2,
                 bound_ms=b2, bound_by=by2)]


def check_lamb_shards(dev, gen, sc, lr, hyper, mv_close, shapes=None):
    """Both LAMB stages on a data-parallel rank's ZeRO shards, the way the
    dp phase's step runs them (``ops.lamb_update_shards_``, one buffer of
    partial norms for every leaf): rank 0 of dp=DP's shard of bert-large's
    embedding flat leaf ([1, 31326208] -> [1, 15663104], one row) and of
    deepseek-moe-16b's expert leaf cut to 8 experts ([8, 2883584] -> [8,
    1441792], a row an expert), g fp32 as the reduce-scatter leaves it,
    each against its plain version (``ref.lamb_stage12`` with the leaf's
    rows): m'/v' within 2 fp32 ulps, the ratio 1e-5 relative, w' 2^-22 of
    the leaf's largest |w|. No exchange: one rank alone, the same launches
    and buffer layout as the phase's."""
    from repro_torch.kernels.fused_lamb import ops, ref
    shapes = shapes or ((1, 31326208 // DP), (8, 2883584 // DP))
    leaves = []
    for shape in shapes:
        leaves.append((0.02 * torch.randn(shape, generator=gen, device=dev),
                       1e-3 * torch.randn(shape, generator=gen, device=dev),
                       1e-4 * torch.randn(shape, generator=gen, device=dev),
                       1e-7 * torch.rand(shape, generator=gen, device=dev),
                       shape[0]))
    want = [ref.lamb_stage12(w, g, m, v, ginv=sc[0], c1=sc[1], c2=sc[2],
                             lr=lr, rows=rows, **hyper)
            for w, g, m, v, rows in leaves]
    ratios = ops.lamb_update_shards_(leaves, sc, lr=lr, **hyper)
    torch.cuda.synchronize()
    rel = max((r.reshape(-1) / pr.reshape(-1) - 1).abs().max().item()
              for r, (_, _, _, pr) in zip(ratios, want))
    werr = max((leaf[0] - pw).abs().max().item()
               for leaf, (pw, _, _, _) in zip(leaves, want))
    ok = all(mv_close(leaf[2], pm) and mv_close(leaf[3], pv)
             and (leaf[0] - pw).abs().max() <= 2.0 ** -22 * pw.abs().max()
             for leaf, (pw, pm, pv, _) in zip(leaves, want))
    if not (ok and rel <= 1e-5):
        _fail(f"lamb on ZeRO shards {shapes}: m'/v' beyond 2 fp32 ulps or "
              f"w' beyond 2^-22 of max |w| (w' max abs {werr}), or ratio "
              f"rel err {rel} > 1e-5")
    del leaves, want
    torch.cuda.empty_cache()
    return {"shapes": [list(s) for s in shapes], "ratio_rel_err": rel,
            "w_max_abs_err": werr, "dp": DP,
            "tol": "m', v' within 2 fp32 ulps; ratio 1e-5 relative; w' "
                   "2^-22 of max |w|"}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def check_block_gradients(arch, dev):
    """One full-width post-norm block (bert-large's, biases perturbed: JAX
    and the port start them at 0, which would hide a bias fault) on x [8,
    128, 1024]: the fused block (kernel forward, plain backward) against
    the unfused block in bf16 and both against the unfused block in fp32,
    output and the gradient of every block parameter and of the input,
    rel L2 within BLOCK_REL_L2."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import init_params
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    one = dataclasses.replace(arch, num_layers=1, remat=False)
    blk = init_params(one, gen, dev, torch.float32)["blocks"][0]
    for name in ("bqkv", "bo"):
        blk["attn"][name] += 0.02 * torch.randn(blk["attn"][name].shape,
                                                generator=gen, device=dev)
    for name in ("b1", "b2"):
        blk["mlp"][name] += 0.02 * torch.randn(blk["mlp"][name].shape,
                                               generator=gen, device=dev)
    for ln in ("ln1", "ln2"):
        blk[ln]["bias"] += 0.1 * torch.randn((arch.d_model,), generator=gen,
                                             device=dev)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, arch.d_model), generator=gen,
                    device=dev)
    ct = torch.randn(x.shape, generator=gen, device=dev)
    pos = torch.arange(TRAIN_SEQ, device=dev)[None]

    def run(fused, dtype):
        p = tree.map(lambda t: t.to(dtype).requires_grad_(True), blk)
        xx = x.to(dtype).requires_grad_(True)
        y, _ = tf.apply_block(one, p, xx, pos, causal=False, fused=fused)
        grads = torch.autograd.grad((y.float() * ct).sum(),
                                    [xx] + tree.leaves(p))
        return [y.detach()] + list(grads)
    fused, plain, exact = (run(True, torch.bfloat16),
                           run(False, torch.bfloat16),
                           run(False, torch.float32))
    names = ["output", "d input"] + [
        "d " + n for n in ("attn.bo", "attn.bqkv", "attn.wo", "attn.wqkv",
                           "ln1.bias", "ln1.scale", "ln2.bias", "ln2.scale",
                           "mlp.b1", "mlp.b2", "mlp.w1", "mlp.w2")]
    worst = {"fused vs unfused": 0.0, "fused vs fp32": 0.0,
             "unfused vs fp32": 0.0}
    for n, f, u, e in zip(names, fused, plain, exact):
        for k, (a, b) in (("fused vs unfused", (f, u)),
                          ("fused vs fp32", (f, e)),
                          ("unfused vs fp32", (u, e))):
            err = _rel_l2(a, b)
            worst[k] = max(worst[k], err)
            if not err <= BLOCK_REL_L2:
                _fail(f"block gradient check: {n} {k} rel L2 {err:.3e} > "
                      f"{BLOCK_REL_L2}")
    print(f"[block grads] bert-large post-norm block, x [{TRAIN_BATCH}, "
          f"{TRAIN_SEQ}, {arch.d_model}] bf16, output and {len(names) - 1} "
          f"gradients; worst rel L2 (tol {BLOCK_REL_L2}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


TRAIN_KERNELS = ("fused_residual_layernorm", "bias_gelu", "lamb_stage1",
                 "lamb_stage2")


def _train_counters():
    from repro_torch.kernels.bias_gelu import ops as bg_ops
    from repro_torch.kernels.fused_lamb import ops as lamb_ops
    from repro_torch.kernels.fused_layernorm import ops as ln_ops
    return (ln_ops.LAUNCHES, bg_ops.LAUNCHES, lamb_ops.LAUNCHES)


def expected_train_launches(arch, n_leaves: int):
    """Launches per step of the fused path: two norm sites and one GeLU per
    block, again when remat recomputes the block in backward; both LAMB
    stages once per parameter leaf."""
    passes = 2 if arch.remat else 1
    return {"fused_residual_layernorm": 2 * arch.num_layers * passes,
            "bias_gelu": arch.num_layers * passes,
            "lamb_stage1": n_leaves, "lamb_stage2": n_leaves}


def train(arch, params0, fused: bool, graphed: bool = True):
    """TRAIN_STEPS steps of bert-large through build_train_step and
    train_loop, LAMB at 1e-3 with fp32 master weights, from ``params0``,
    on the synthetic MLM batches of SEED: through ``bundle.fn`` (step 1 the
    warm-up, step 2 the capture, then one CUDA-graph replay a step), or
    with ``graphed=False`` through ``bundle.eager``. ``fused`` turns on
    both switches: REPRO_FUSED_BLOCKS and RunConfig.fused_optimizer_kernel.
    Every launch counter is set to 0 just before the loop and read just
    after."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.steps import build_train_step
    os.environ["REPRO_FUSED_BLOCKS"] = "1" if fused else "0"
    tag = ("fused" if fused else "unfused") + ("" if graphed else " eager")
    run = RunConfig(arch=arch, shape=ShapeConfig(
        "chip", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, kind="train"),
        optimizer="lamb", learning_rate=1e-3, zero1=False,
        fused_optimizer_kernel=fused, master_weights=True)
    bundle = build_train_step(run, "cuda")
    step_fn = bundle.fn if graphed else bundle.eager
    state = bundle.init(params=params0)
    data = SyntheticPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, objective="mlm", seed=SEED))
    for d in _counters() + _train_counters():
        for k in d:
            d[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = train_loop(step_fn, state, data,
                     LoopConfig(max_steps=TRAIN_STEPS, log_every=1),
                     log=lambda s: print(f"[train {tag}] {s}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for d in _train_counters() for k, v in d.items()}
    serve_launches = _snapshot()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        _fail(f"{tag} training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"{tag} training: loss did not fall over {TRAIN_STEPS} steps: "
              f"{losses}")
    # after the warm-up (step 1) and the capture (step 2)
    step_s = float(np.median([h["dt"] for h in hist[2:]]))
    graph = ({"captures": bundle.fn.captures, "replays": bundle.fn.replays,
              "pool_bytes": bundle.fn.pool_bytes,
              "capture_step_s": hist[1]["dt"]} if graphed else None)
    print(f"[train {tag}] bert-large {arch.num_layers}L d{arch.d_model} "
          f"B{TRAIN_BATCH} S{TRAIN_SEQ} LAMB, fp32 master, bf16 compute: "
          f"losses {[round(x, 4) for x in losses]}; step time (median of "
          f"steps 3-{TRAIN_STEPS}) {step_s * 1e3:.2f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s; wall "
          f"{wall:.2f} s; peak memory {peak / 2**30:.2f} GiB ("
          f"{(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB "
          f"held when the loop started); launches {launches}"
          + (f"; graph: {graph['captures']} captured, {graph['replays']} "
             f"replays, pool {graph['pool_bytes'] / 2**30:.3f} GiB, the "
             f"capture step {graph['capture_step_s'] * 1e3:.1f} ms"
             if graph else ""))
    return {"losses": losses, "step_s": step_s, "wall": wall, "peak": peak,
            "peak_above_start": peak - base, "graph": graph,
            "launches": launches, "serve_launches": serve_launches,
            "bundle": bundle, "step_fn": step_fn, "state": state,
            "data": data, "grad_norms": [h.get("grad_norm") for h in hist]}


def compare_runs(graphed, eager):
    """The graphed run against the eager one from the same weights and
    batches: losses and grad norms as floats, the final master weights,
    m, v and the bf16 parameters, all bitwise. Fails on any difference."""
    from repro_torch import tree
    bad = [k for k in ("losses", "grad_norms") if graphed[k] != eager[k]]
    sg, se = graphed["state"], eager["state"]
    leaves = 0
    for part, a, b in (("master", sg["opt"]["master"], se["opt"]["master"]),
                       ("m", sg["opt"]["m"], se["opt"]["m"]),
                       ("v", sg["opt"]["v"], se["opt"]["v"]),
                       ("params", sg["params"], se["params"])):
        la, lb = tree.leaves(a), tree.leaves(b)
        leaves += len(la)
        diff = sum(not torch.equal(x, y) for x, y in zip(la, lb))
        if diff:
            bad.append(f"{part} ({diff} of {len(la)} leaves)")
    if bad:
        _fail(f"the graphed fused run differs from the eager fused run in "
              f"{bad}: losses {graphed['losses']} vs {eager['losses']}, "
              f"grad norms {graphed['grad_norms']} vs {eager['grad_norms']}")
    print(f"[graph] {TRAIN_STEPS} graphed fused steps bitwise the eager "
          f"ones: losses, grad norms and {leaves} leaves of master, m, v "
          f"and params")
    return leaves


def count_step_syncs(res) -> int:
    """One more step under torch.cuda.set_sync_debug_mode("warn"): the
    number of calls in it that made the host wait for the card. A step
    makes none (train_loop reads its metrics a step later); any fails."""
    import warnings
    batch = res["data"].batch(TRAIN_STEPS)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res["step_fn"](res["state"], batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # PyTorch warns "called a synchronizing CUDA operation" at each one,
    # after a one-time notice that the debug mode is a prototype
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    print(f"[syncs] one replayed fused training step: {len(syncs)} "
          f"synchronizing calls"
          + (f"; first: {sorted(set(syncs))[:3]}" if syncs else ""))
    if syncs:
        _fail(f"a training step made {len(syncs)} synchronizing calls")
    return len(syncs)


def steady_step_ms(res, steps: int = 5) -> float:
    """Host ms a step over ``steps`` more steps queued back to back and
    ended by a synchronize (no metric read in between)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        res["step_fn"](res["state"], res["data"].batch(TRAIN_STEPS + 2 + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def lamb_bounds(leaf_sizes):
    """The byte bounds of one fused step's LAMB stages summed over its
    leaves, with check_lamb's bytes an element (stage 1 reads w, g in
    bf16, m, v and writes m, v, u; stage 2 reads w, u and writes w)."""
    b1 = sum(_bound(n * (4 + 2 + 4 + 4) + n * 12, 20.0 * n, fp32=True)[0]
             for n in leaf_sizes)
    b2 = sum(_bound(n * 8 + n * 4, 3.0 * n, fp32=True)[0]
             for n in leaf_sizes)
    return {"lamb_stage1": b1, "lamb_stage2": b2}


def profile_train_step(res, leaf_sizes, tag: str, attribute: bool = False):
    """One more fused step under torch.profiler: device time of GEMMs, the
    norm, GeLU, LAMB and everything else ("other", also split into its
    largest kernels by name), launches, idle share; and each LAMB stage's
    device time summed over its launches beside its byte bound summed over
    the leaves (``lamb_bounds``): launches x gap. With ``attribute`` (an
    eager step) the step also runs under an ``optrace`` recorder with its
    op ranges, so each kernel's device time goes to the op that launched
    it (``optrace.device_times``; the recorder's host work lengthens the
    wall, not the device time): the trace and the attribution return
    under "_trace" and "attribution" for ``characterize_phase``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import optrace
    batch = res["data"].batch(TRAIN_STEPS + 1)
    rec = optrace.Recorder(profile=True) if attribute else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with rec if rec is not None else contextlib.nullcontext():
            _, met = res["step_fn"](res["state"], batch)
            float(met["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host = {}
    for e in events:            # each range is a host and a device event
        if e.key.startswith("train_step/"):
            k = e.key.split("/")[-1]
            host[k] = max(host.get(k, 0.0), e.cpu_time_total / 1e3)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith(("train_step/", "optrace#"))]
    busy = sum(k[1] for k in kernels)
    cpu_top = sorted((e for e in events if e.self_cpu_time_total > 0
                      and not e.key.startswith("optrace#")),
                     key=lambda e: -e.self_cpu_time_total)[:8]
    print(f"[profile train {tag}] host time by part of the step (ms, "
          f"profiled): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
          + "; top host ops by self time: " + "; ".join(
              f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms x{e.count}"
              for e in cpu_top))
    if busy <= 0:
        print(f"[profile train {tag}] device time: not measured (the "
              f"profiler recorded no CUDA kernel time)")
        return {"wall_ms": wall_ms, "host_ms": host}
    kinds = {"gemm": 0.0, "norm": 0.0, "gelu": 0.0, "lamb": 0.0,
             "other": 0.0}
    other = []
    for name, ms, count in kernels:
        low = name.lower()
        if any(k in low for k in ("resln_kernel", "resnorm_kernel",
                                  "gated_rmsnorm_kernel")):
            kinds["norm"] += ms
        elif "bias_gelu_kernel" in low:
            kinds["gelu"] += ms
        elif "stage1_kernel" in low or "stage2_kernel" in low:
            kinds["lamb"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                      "cutlass")):
            kinds["gemm"] += ms
        else:
            kinds["other"] += ms
            other.append((name, ms, count))
    bounds = lamb_bounds(leaf_sizes)
    lamb = {}
    for name, key in (("lamb_stage1", "stage1_kernel"),
                      ("lamb_stage2", "stage2_kernel")):
        hits = [(ms, c) for n, ms, c in kernels if key in n]
        ms = sum(h[0] for h in hits)
        lamb[name] = {"device_ms": ms, "launches": sum(h[1] for h in hits),
                      "bound_ms": bounds[name],
                      "gap_ms": ms - bounds[name]}
    print(f"[profile train {tag}] LAMB in one fused step: " + "; ".join(
        f"{k} {v['launches']} launches, device {v['device_ms']:.4f} ms "
        f"against a summed byte bound of {v['bound_ms']:.4f} ms (launches "
        f"x gap {v['gap_ms']:.4f} ms)" for k, v in lamb.items()))
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    other_top = [{"kernel": n, "device_ms": ms, "launches": c}
                 for n, ms, c in sorted(other, key=lambda k: -k[1])[:12]]
    # the host ops that launched the device time, by self device time (an
    # eager step; a replay's kernels all belong to its graph launch)
    by_op = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                    for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.self_device_time_total > 0
                    and not e.key.startswith("optrace#")),
                   key=lambda k: -k[1])[:16]
    print(f"[profile train {tag}] one fused step under torch.profiler: "
          f"wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; kernel launches "
          f"{sum(k[2] for k in kernels)}; by kind (ms) "
          + ", ".join(f"{k} {v:.2f}" for k, v in kinds.items())
          + "; top kernels " + "; ".join(
              f"{n[:48]} {ms:.2f} ms x{c}" for n, ms, c in top))
    print(f"[profile train {tag}] \"other\" by kernel: " + "; ".join(
        f"{_short_kernel(o['kernel'])} {o['device_ms']:.3f} ms "
        f"x{o['launches']}" for o in other_top))
    print(f"[profile train {tag}] device time by launching op: " + "; ".join(
        f"{n} {ms:.3f} ms x{c}" for n, ms, c in by_op))
    out = {"wall_ms": wall_ms, "busy_ms": busy, "kinds": kinds,
           "launches": sum(k[2] for k in kernels), "host_ms": host,
           "lamb": lamb, "other_top": other_top,
           "by_op": [{"op": n, "device_ms": ms, "calls": c}
                     for n, ms, c in by_op]}
    if rec is not None:
        att = optrace.device_times(prof)
        out["_trace"] = rec.ops
        out["attribution"] = {k: att[k] for k in ("busy_ms",
                                                  "unattributed_ms",
                                                  "kernels")}
        out["attribution"]["per_op"] = att["per_op"]
    return out


def _short_kernel(name: str) -> str:
    """An at::native kernel's name cut to its functor: the op it runs."""
    name = name.replace("void ", "").replace("at::native::", "")
    for cut in ("(anonymous namespace)::", "gpu_kernel_impl_nocast<",
                "gpu_kernel_impl<"):
        name = name.replace(cut, "")
    return name[:110]


def check_training(dev):
    """The training slice end to end: fused through the graphed step, then
    through the eager step from the same weights and batches (bitwise
    equal), then unfused (graphed); exact launch counts a step; step-1
    losses of fused and unfused within 1 bf16 ulp of the loss's magnitude
    (the forward of the two paths differs by bf16 rounding only)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    arch = get_config("bert-large")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params0 = init_params(arch, gen, dev, torch.float32)
    leaf_sizes = [p.numel() for p in tree.leaves(params0)]
    n_leaves, n_params = len(leaf_sizes), sum(leaf_sizes)
    torch.cuda.synchronize()
    print(f"[init] bert-large full width, {arch.num_layers} layers, "
          f"{n_leaves} leaves, {n_params} parameters (fp32 master) on the "
          f"card in {time.perf_counter() - t0:.1f}s")
    want = expected_train_launches(arch, n_leaves)
    fused = train(arch, params0, True)
    eager = train(arch, params0, True, graphed=False)
    for run in (fused, eager):
        for name, per_step in want.items():
            if run["launches"][name] != per_step * TRAIN_STEPS:
                _fail(f"{name}: {run['launches'][name]} launches in "
                      f"{TRAIN_STEPS} fused steps "
                      f"({'graphed' if run is fused else 'eager'}), "
                      f"expected {per_step * TRAIN_STEPS} ({per_step} a "
                      f"step)")
    # step 1 is the warm-up; step 2 captures and replays; then one a step
    if fused["graph"]["captures"] != 1 or \
            fused["graph"]["replays"] != TRAIN_STEPS - 1:
        _fail(f"the graphed run captured {fused['graph']['captures']} "
              f"graphs and replayed {fused['graph']['replays']}, expected 1 "
              f"and {TRAIN_STEPS - 1}")
    leaves = compare_runs(fused, eager)
    syncs = count_step_syncs(fused)
    prof = {"graphed": profile_train_step(fused, leaf_sizes, "graphed"),
            "eager": profile_train_step(eager, leaf_sizes, "eager",
                                        attribute=True)}
    steady = {"graphed": steady_step_ms(fused),
              "eager": steady_step_ms(eager)}
    print(f"[train] fused step, {TRAIN_STEPS} steps through train_loop "
          f"(median of steps 3-{TRAIN_STEPS}): graphed "
          f"{fused['step_s'] * 1e3:.2f} ms vs eager "
          f"{eager['step_s'] * 1e3:.2f} ms; 5 more steps back to back: "
          f"graphed {steady['graphed']:.2f} ms vs eager "
          f"{steady['eager']:.2f} ms a step; graph pool "
          f"{fused['graph']['pool_bytes'] / 2**30:.3f} GiB, peak memory "
          f"graphed {fused['peak'] / 2**30:.2f} GiB, eager "
          f"{eager['peak'] / 2**30:.2f} GiB")
    # the eager run's state stays for characterize_phase
    del fused["bundle"], fused["state"], fused["step_fn"]
    gc.collect()
    torch.cuda.empty_cache()
    plain = train(arch, params0, False)
    del plain["bundle"], plain["state"], plain["step_fn"]
    for name, per_step in want.items():
        if plain["launches"][name]:
            _fail(f"the unfused training path launched {name}")
    served = {k: v for k, v in fused["serve_launches"].items()
              if k not in TRAIN_KERNELS and v}
    if served:
        _fail(f"training launched serving kernels: {served}")
    l_f, l_u = fused["losses"][0], plain["losses"][0]
    tol = _bf16_ulp(torch.tensor(l_u)).item()
    if not abs(l_f - l_u) <= tol:
        _fail(f"step-1 losses differ: fused {l_f} vs unfused {l_u} (tol "
              f"{tol}, 1 bf16 ulp)")
    print(f"[train] step-1 loss fused {l_f:.6f} vs unfused {l_u:.6f} "
          f"(|diff| {abs(l_f - l_u):.3e}, tol {tol}); fused step "
          f"{fused['step_s'] * 1e3:.2f} ms vs unfused "
          f"{plain['step_s'] * 1e3:.2f} ms (both graphed)")
    return {"fused": fused, "fused_eager": eager, "unfused": plain,
            "fused_eager_state": {k: eager.pop(k) for k in (
                "bundle", "state", "step_fn", "data")},
            "profile": prof, "steady_step_ms": steady,
            "bitwise_leaves": leaves, "syncs_in_a_step": syncs,
            "per_step": want, "n_leaves": n_leaves, "n_params": n_params}


# --------------------------------------------------------- characterize ---
# The paper's method (repro.core.characterize, ported as
# repro_torch.core.{optrace,characterize}) over the fused bert-large step.
# The trace's GEMMs against the analytical model's Table 3 rows (fwd +
# both gradients) plus the recomputed block forwards: Table 3 has no row
# for BERT's MLM transform, a D x D dense priced 3 x 2 t D^2 (6.4 GFLOP,
# 0.24% of the step at B8 S128); nothing else differs (the CPU tests hold
# the smoke step's GEMMs by bucket to the inventory plus that dense
# exactly). So the trace may exceed the model by at most 0.3%.
GEMM_TOL = 0.003
ATTRIBUTED_TOL = 0.01       # attributed device time against the busy time
FIG5 = ("attn_linear", "attn_bgemm", "fc", "attn_softmax", "activation",
        "drn")


def _fmt(d: dict, scale: float = 1.0, digits: int = 3) -> str:
    return ", ".join(f"{k} {v * scale:.{digits}f}"
                     for k, v in sorted(d.items(), key=lambda kv: -kv[1]))


def _fig4(phases: dict) -> dict:
    """Fig. 4's split of a phase -> time dict: GEMMs outside LAMB, LAMB,
    the rest, as shares."""
    gemm_phases = ("attn_linear", "attn_bgemm", "fc", "head", "moe", "ssm")
    total = sum(phases.values()) or 1.0
    lamb = phases.get("lamb", 0.0)
    gemm = sum(phases.get(p, 0.0) for p in gemm_phases)
    return {"gemm": gemm / total, "lamb": lamb / total,
            "non_gemm": (total - gemm - lamb) / total}


def characterize_phase(training):
    """``characterize.analyze`` over one eager fused bert-large B8 S128 step
    on a copy of the eager run's state: FLOPs and bytes by category and by
    bucket, the H100 roofline terms, the kernel ops (each must equal the
    launches a step); the trace's GEMM FLOPs against the analytical model
    (``GEMM_TOL``). Then the eager step that ``profile_train_step``
    profiled with its op ranges: device ms by bucket, category, pass and
    paper phase beside the trace's per-op roofline ms and
    ``analytical.phase_times`` on the H100 and the MI100, with Fig. 4's
    shares; the attributed device time must be within ``ATTRIBUTED_TOL``
    of the profiled busy time."""
    from repro_torch import tree
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import analytical, characterize, roofline
    arch = get_config("bert-large")
    eager = training.pop("fused_eager_state")
    os.environ["REPRO_FUSED_BLOCKS"] = "1"
    state = tree.map(lambda t: t.detach().clone().requires_grad_(
        t.requires_grad), eager["state"])
    batch = eager["data"].batch(TRAIN_STEPS + 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cost = characterize.analyze(eager["bundle"].eager, state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del state, eager
    gc.collect()
    torch.cuda.empty_cache()
    kernels = cost.kernels()
    if kernels != training["per_step"]:
        _fail(f"characterize: kernel ops {kernels} in one traced step, "
              f"launches a step {training['per_step']}")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    passes = ("fwd", "bwd_act", "bwd_w")
    model = sum(g.flops for ph in passes
                for g in analytical.transformer_gemms(arch, b, s, ph))
    remat = sum(g.flops for g in analytical.transformer_gemms(arch, b, s)
                if g.layer != "head")
    gemm = cost.by_category["gemm"]
    gap = (gemm - model - remat) / (model + remat)
    if not 0 <= gap <= GEMM_TOL:
        _fail(f"characterize: the trace's GEMM FLOPs {gemm:.6e} against "
              f"the analytical model's {model:.6e} + recomputed block "
              f"forwards {remat:.6e}: {gap:+.4%} (tolerance 0 to "
              f"{GEMM_TOL:.1%})")
    terms = roofline.compute_terms(
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        colls=cost.summary().collectives(), n_devices=1, arch=arch,
        shape=ShapeConfig("chip", seq_len=s, global_batch=b, kind="train"),
        dev=roofline.H100)
    f_bucket = characterize.bucket_scopes(cost.by_scope)
    b_bucket = characterize.bucket_scopes(cost.by_scope_bytes)
    print(f"[characterize] one eager fused bert-large B{b} S{s} step traced "
          f"on the card in {secs:.2f} s: {len(cost.ops)} ops, "
          f"{cost.flops:.6e} FLOPs, {cost.bytes:.6e} bytes; GEMM FLOPs "
          f"{gemm:.6e} against the analytical model's {model:.6e} + "
          f"recomputed block forwards {remat:.6e} ({gap:+.4%}, tolerance "
          f"{GEMM_TOL:.1%}); kernel ops {kernels} (= launches a step)")
    print(f"[characterize] GFLOP by category: "
          f"{_fmt(cost.by_category, 1e-9)}; GB by category: "
          f"{_fmt(cost.by_category_bytes, 1e-9)}")
    print(f"[characterize] GFLOP by bucket: {_fmt(f_bucket, 1e-9)}; GB by "
          f"bucket: {_fmt(b_bucket, 1e-9)}")
    print(f"[characterize] H100 roofline (roofline.compute_terms): "
          f"compute_s {terms.compute_s:.6e}, memory_s {terms.memory_s:.6e}, "
          f"dominant {terms.dominant}, useful ratio "
          f"{terms.useful_ratio:.4f}")
    # the profiled eager step, its device time given to the ops of its trace
    prof = training["profile"]["eager"]
    trace, att = prof.pop("_trace"), prof["attribution"]
    per_op = att.pop("per_op")
    attributed = sum(per_op.values())
    busy = prof.get("busy_ms", 0.0)
    if not busy or abs(attributed - busy) > ATTRIBUTED_TOL * busy:
        _fail(f"characterize: {attributed:.3f} ms of device time attributed "
              f"to the trace's ops against {busy:.3f} ms busy in the "
              f"profiled eager step (tolerance {ATTRIBUTED_TOL:.0%})")
    measured = characterize.split(trace, per_op)
    roof = characterize.split(trace, characterize.roofline_ms(trace))
    unscoped = sum(per_op.get(op.index, 0.0) for op in trace if not op.scope)
    model_s = {dev.name: analytical.phase_times(arch, b, s, dev=dev)
               for dev in (roofline.H100, roofline.MI100)}
    print(f"[characterize] the profiled eager step: busy {busy:.3f} ms, "
          f"attributed to its ops {attributed:.3f} ms "
          f"({attributed / busy:.4f}; the profiler's own count "
          f"{att['busy_ms']:.3f} ms over {att['kernels']} device "
          f"activities, {att['unattributed_ms']:.3f} ms to no op); unscoped "
          f"{unscoped:.3f} ms ({unscoped / busy:.3f} of busy)")
    for key in ("bucket", "category", "pass"):
        print(f"[characterize] device ms by {key}: "
              f"{_fmt(measured[key])}; the trace's roofline ms (H100, each "
              f"op max(FLOPs / 989e12, bytes / 3.35e12)): "
              f"{_fmt(roof[key])}")
    top = sorted(measured["cell"].items(), key=lambda kv: -kv[1])[:14]
    print("[characterize] device ms by bucket/category, largest first "
          "(roofline ms): " + "; ".join(
              f"{k} {v:.3f} ({roof['cell'].get(k, 0.0):.3f})"
              for k, v in top))
    print("[characterize] paper phases, device ms / roofline ms / "
          "analytical H100 ms / analytical MI100 ms: " + "; ".join(
              f"{p} {measured['paper'].get(p, 0.0):.3f} / "
              f"{roof['paper'].get(p, 0.0):.3f} / "
              f"{model_s['h100-sxm'].get(p, 0.0) * 1e3:.3f} / "
              f"{model_s['mi100'].get(p, 0.0) * 1e3:.3f}"
              for p in sorted(set(measured["paper"]) | set(model_s["mi100"]),
                              key=lambda p: -measured["paper"].get(p, 0.0))))
    def shares(d):
        total = sum(d.values()) or 1.0
        return {k: d.get(k, 0.0) / total for k in ("gemm", "lamb",
                                                   "non_gemm")}
    # measured and roofline by the ops' category; the model by its phases
    fig4 = {"measured": shares(measured["fig4"]),
            "roofline": shares(roof["fig4"]),
            **{k: _fig4(v) for k, v in model_s.items()}}
    fig5_total = {k: sum(v.get(p, 0.0) for p in FIG5) for k, v in (
        ("measured", measured["paper"]), ("roofline", roof["paper"]),
        *model_s.items())}
    fig5 = {k: {p: v.get(p, 0.0) / (fig5_total[k] or 1.0) for p in FIG5}
            for k, v in (("measured", measured["paper"]),
                         ("roofline", roof["paper"]), *model_s.items())}
    print("[characterize] Fig. 4 shares (GEMM / LAMB / non-GEMM): " + "; ".join(
        f"{k} {v['gemm']:.3f} / {v['lamb']:.3f} / {v['non_gemm']:.3f}"
        for k, v in fig4.items()))
    print("[characterize] Fig. 5 shares of the block phases ("
          + ", ".join(FIG5) + "): " + "; ".join(
              f"{k} " + " / ".join(f"{v[p]:.3f}" for p in FIG5)
              for k, v in fig5.items()))
    return {"seconds": secs, "ops": len(cost.ops), "flops": cost.flops,
            "bytes": cost.bytes, "gemm_flops": gemm,
            "analytical_gemm_flops": model, "remat_gemm_flops": remat,
            "gemm_gap": gap, "kernel_ops": kernels,
            "flops_by_category": dict(cost.by_category),
            "bytes_by_category": dict(cost.by_category_bytes),
            "flops_by_bucket": f_bucket, "bytes_by_bucket": b_bucket,
            "roofline": {"compute_s": terms.compute_s,
                         "memory_s": terms.memory_s,
                         "dominant": terms.dominant},
            "busy_ms": busy, "attributed_ms": attributed,
            "unscoped_ms": unscoped, "device_ms": measured,
            "roofline_ms": roof,
            "analytical_ms": {k: {p: t * 1e3 for p, t in v.items()}
                              for k, v in model_s.items()},
            "fig4": fig4, "fig5": fig5}


# ------------------------------------------------------------- phase 3b ---
# The paper's "Scale, Mask, Softmax" phase (Fig. 8): the last TPU kernel,
# which no model path of the JAX package calls; the analytical model names
# its work attn_scale_mask_softmax.
SOFTMAX_SCALE = 0.125          # 1 / sqrt(64), bert-large's head dim
SOFTMAX_FP32_TOL = 2.0 ** -21  # fp32: of each row's largest output (the
                               # kernel and the plain version differ only
                               # in the order of the row sum)
SOFTMAX_CASES = {
    # name: (N, Sq, Sk, dtype, causal, q_offset); N = batch x heads
    "bert-large Phase 2, B4 x 16 heads": (64, 512, 512, torch.float32,
                                          False, 0),
    "bert-large Phase 1, B32 x 16 heads": (512, 128, 128, torch.float32,
                                           False, 0),
    "Phase 2 in bf16": (64, 512, 512, torch.bfloat16, False, 0),
    "ragged Sq 1500, causal": (24, 1500, 1500, torch.bfloat16, True, 0),
    "last chunk of a long prompt, q_offset 3840": (24, 256, 4096,
                                                   torch.bfloat16, True,
                                                   3840),
    "q_offset -1, row 0 fully masked": (16, 128, 128, torch.float32, True,
                                        -1),
    "Sk 12288, a 48 KB row": (4, 64, 12288, torch.bfloat16, False, 0),
    "Sk 32768, the kernel's largest": (2, 8, 32768, torch.bfloat16, True,
                                       32760),
}


def _softmax_valid(sq, sk, causal, off):
    """Score entries of one [Sq, Sk] slice that the function must read: all
    of them, or where causal the columns 0..row + q_offset of each row (a
    fully masked row reads none; its output is 1/Sk whatever s holds)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, r + off + 1)) for r in range(sq))


def _softmax_check(name, out, plain, causal, off):
    """fp32 within SOFTMAX_FP32_TOL of each row's largest output and rows
    summing to 1 within 1e-5; bf16 within 1 bf16 ulp of each plain output;
    masked entries exactly 0 and a row with no valid column exactly 1/Sk,
    as the plain version's. Returns (max abs err, worst err / tol)."""
    o, p = out.float(), plain.float()
    diff = (o - p).abs()
    if out.dtype == torch.float32:
        tol = SOFTMAX_FP32_TOL * p.amax(-1, keepdim=True)
        sums = (o.double().sum(-1) - 1).abs().max().item()
        if not sums <= 1e-5:
            _fail(f"scale_mask_softmax ({name}): a row sums to 1 +- {sums}")
    else:
        tol = _bf16_ulp(p)
    worst = (diff / tol).max().item()
    if not worst <= 1.0:
        _fail(f"scale_mask_softmax ({name}): {worst} x its tolerance (max "
              f"abs err {diff.max().item()})")
    if causal:
        sq, sk = out.shape[-2:]
        rows = torch.arange(sq, device=out.device)[:, None] + off
        cols = torch.arange(sk, device=out.device)[None]
        empty = rows[:, 0] < 0                     # rows with no valid column
        masked = (cols > rows) & ~empty[:, None]
        if bool((out[:, masked] != 0).any()):
            _fail(f"scale_mask_softmax ({name}): a masked entry is not 0")
        if bool(empty.any()) and not torch.equal(
                out[:, empty], torch.full_like(out[:, empty], 1.0 / sk)):
            _fail(f"scale_mask_softmax ({name}): a fully masked row is not "
                  f"uniform 1/{sk}")
    return diff.max().item(), worst


SOFTMAX_KERNELS = ("softmax_warp_kernel", "softmax_cta_kernel")


def _plan_text(plan: dict) -> str:
    """A softmax plan as "warp a row, 16 a lane, loads of 4" say."""
    if plan["cta"]:
        return (f"CTA of {plan['threads']} a row, {plan['per']} a thread, "
                f"loads of {plan['vec']}")
    return (f"warp a row ({plan['threads'] // 32} a CTA), {plan['per']} a "
            f"lane, loads of {plan['vec']}")


def check_scale_mask_softmax(dev):
    """The fused scale + mask + softmax against its plain version at the
    bert-large attention shapes the paper profiles and at serving-like
    causal shapes. The phase's run (one launch a case, every count set to
    0 just before and read just after) is checked; then each case is timed
    beside its byte bound (the valid entries read once, every output
    written once), the plain version and torch.softmax of the scores
    already scaled and masked, in s's dtype (the softmax only). Last, the
    analytical model's instance for bert-large at B4, n 512 (four kernels a
    layer, scale, mask, softmax and dropout, as the paper profiled them)
    beside 24 launches of the kernel at that shape, one a layer."""
    from repro_torch.configs import get_config
    from repro_torch.core import analytical
    from repro_torch.core.roofline import H100
    from repro_torch.kernels.fused_softmax import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    inputs = {}
    for name, (n, sq, sk, dt, causal, off) in SOFTMAX_CASES.items():
        # raw q.k scores of unit vectors at head dim 64: std 8
        inputs[name] = (8 * torch.randn((n, sq, sk), generator=gen,
                                        device=dev)).to(dt)
    counts = _counters() + _train_counters() + (ops.LAUNCHES,)
    for d in counts:
        for k in d:
            d[k] = 0
    outs = {name: ops.scale_mask_softmax(inputs[name], scale=SOFTMAX_SCALE,
                                         causal=c, q_offset=off)
            for name, (_, _, _, _, c, off) in SOFTMAX_CASES.items()}
    torch.cuda.synchronize()
    seen = {k: v for d in counts for k, v in d.items() if v}
    launches = ops.LAUNCHES["scale_mask_softmax"]
    if seen != {"scale_mask_softmax": len(SOFTMAX_CASES)}:
        _fail(f"scale_mask_softmax: launches {seen} in the phase's run, "
              f"expected {len(SOFTMAX_CASES)} of scale_mask_softmax only "
              "(one a case)")
    rows = []
    for name, (n, sq, sk, dt, causal, off) in SOFTMAX_CASES.items():
        s = inputs[name]
        kw = dict(scale=SOFTMAX_SCALE, causal=causal, q_offset=off)
        plain = ref.scale_mask_softmax(s, **kw)
        err, worst = _softmax_check(name, outs.pop(name), plain, causal, off)
        del plain
        ms = _time_ms(lambda: ops.scale_mask_softmax(s, **kw), 20)
        dev_ms = _profiled_ms(lambda: ops.scale_mask_softmax(s, **kw),
                              SOFTMAX_KERNELS)
        plain_ms = _time_ms(lambda: ref.scale_mask_softmax(s, **kw), 5)
        x = s.float() * SOFTMAX_SCALE
        if causal:
            pos = torch.arange(sq, device=dev)[:, None] + off
            x = torch.where(torch.arange(sk, device=dev)[None] <= pos, x,
                            ref.NEG_INF)
        x = x.to(dt)   # bf16 in, bf16 out, fp32 statistics: as the kernel
        library_ms = _time_ms(lambda: torch.softmax(x, dim=-1), 20)
        del x
        # a read of each valid entry and a write of every output; about six
        # operations a valid entry (scale, max, subtract, exp, add, divide)
        # on the fp32 units
        valid = n * _softmax_valid(sq, sk, causal, off)
        bound_ms, bound_by = _bound((valid + s.numel()) * s.element_size(),
                                    6.0 * valid, fp32=True)
        plan = ops.softmax_plan(n * sq, sk, dt)
        rows.append({"case": name, "shape": [n, sq, sk],
                     "dtype": str(dt).replace("torch.", ""),
                     "causal": causal, "q_offset": off,
                     "plan": plan._asdict(),
                     "share_of_bound": (bound_ms / dev_ms if dev_ms
                                        else None),
                     "valid_fraction": valid / s.numel(),
                     "max_abs_err": err, "max_err_over_tol": worst,
                     "ms": ms, "profiler_device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
        torch.cuda.empty_cache()
    print("[softmax] " + "; ".join(
        f"{r['case']}: plan {_plan_text(r['plan'])}, err "
        f"{r['max_abs_err']:.3e} ({r['max_err_over_tol']:.3f} of tol), "
        f"{r['ms']:.5f} ms (device {r['profiler_device_ms']}), bound "
        f"{r['bound_ms']:.5f} ({r['bound_by']}; share "
        f"{r['share_of_bound'] or 0:.3f} of device time), plain "
        f"{r['plain_ms']:.4f}, torch.softmax {r['library_ms']:.5f}"
        for r in rows)
        + f"; {launches} launches in the phase's run (one a case)")

    # the paper's claim: four separate kernels a layer, against one fused
    bert = get_config("bert-large")
    b, seq = 4, 512
    op = next(e for e in analytical.nongemm_ops(bert, b, seq, 4)
              if e.name == "attn_scale_mask_softmax")
    model_s = analytical.phase_times(bert, b, seq, H100, 4,
                                     train=False)["attn_softmax"]
    s = inputs[next(iter(SOFTMAX_CASES))]
    kw = dict(scale=SOFTMAX_SCALE, causal=False)
    layers_ms = _time_ms(lambda: [ops.scale_mask_softmax(s, **kw)
                                  for _ in range(bert.num_layers)], 5)
    paper = {"arch": bert.name, "batch": b, "seq": seq, "dtype": "float32",
             "device": H100.name, "op": op.name,
             "instances": op.count, "bytes_per_instance": op.bytes,
             "flops_per_instance": op.flops,
             "analytical_ms": model_s * 1e3,
             "fused_launches": bert.num_layers,
             "fused_measured_ms": layers_ms,
             "ratio_analytical_over_fused": model_s * 1e3 / layers_ms,
             "note": "the modelled instances include dropout, which the "
                     "fused kernel does not compute; the H100 spec has no "
                     "launch overhead"}
    print(f"[paper] {op.name} for bert-large at B{b}, n {seq}, fp32 on "
          f"{H100.name}: the analytical model's {op.count} kernels (4 a "
          f"layer x {bert.num_layers}: scale, mask, softmax and dropout, "
          f"{op.bytes / 1e6:.1f} MB each) take {model_s * 1e3:.4f} ms at "
          f"{H100.hbm_bw / 1e12:g} TB/s with no launch overhead; "
          f"{bert.num_layers} launches of the fused kernel, which computes "
          f"no dropout, measured {layers_ms:.4f} ms; ratio "
          f"{paper['ratio_analytical_over_fused']:.3f} (informative, not "
          "asserted: the two sides differ by the dropout as well)")
    del inputs, s
    torch.cuda.empty_cache()
    main = dict(rows[0])
    main.pop("case")
    return {"name": "scale_mask_softmax", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_softmax/csrc/"
                      "scale_mask_softmax.cu",
            "replaces": "src/repro/kernels/fused_softmax/kernel.py:33",
            **main, "launches": launches,
            "launches_path": "the softmax phase's run: one launch a case (no "
                             "model path calls the kernel, as in the JAX "
                             "package)",
            "tol": "fp32: 2^-21 of each row's largest output, rows sum to "
                   "1 within 1e-5; bf16: 1 bf16 ulp of each plain output; "
                   "masked entries exactly 0",
            "library_note": "torch.softmax of the scores already scaled and "
                            "masked, in s's dtype (fp32 statistics): the "
                            "softmax only",
            "bound_note": "the valid entries of s read once (causal: columns "
                          "0..row + q_offset), every output written once",
            "cases": rows[1:], "paper": paper}


# ------------------------------------------------------- phase 8b ---
# Training beyond bert-large: llama3.2-3b (the dense pre-norm family, each
# block's mixer add + ln2 through decode_residual_norm) and mamba2-1.3b
# (gated_rmsnorm in every block) at full width and depth, B8 S128, llama's
# long-context step through the chunked attention's VJP, and checkpoint /
# restart on the card at smoke size.
FAMILY_STEPS = 6
LONG_SEQ, LONG_STEPS, LONG_CHUNK = 4096, 3, 1024
FLASH_LOSS_ULPS = 0.1   # flash step 1's loss against the chunked forward's
                        # on the same state and batch, in bf16 ulps of the
                        # loss: the two attentions differ in p's rounding
                        # (bf16 before p V in the chunked path, fp32 in the
                        # kernel), a bf16 ulp or so an element, averaged
                        # over 4096 tokens. A sanity gate: a loss after a
                        # few steps from a random init barely sees the
                        # mask; the one layer's dq/dk/dv and lse checks
                        # decide
FLASH_GRAPH_LAYERS = 2  # the graphed-against-eager flash check's depth
CKPT_BATCH, CKPT_SEQ, CKPT_STEPS = 4, 32, 4
# step 1 fused (decode_residual_norm, the LAMB kernels) against the unfused
# plain step from the same weights: each updated bf16 param leaf within 1
# bf16 ulp of its largest |value| (the fp32 master weights differ in their
# last bits, so a cast may round the other way), the loss within 1 bf16
# ulp of itself (as phase 8 holds bert-large's fused step 1)
STEP1_PARAM_ULPS, STEP1_LOSS_ULPS = 1.0, 1.0


def _zero_counters() -> None:
    from repro_torch.graphs import launch_counters
    for d in launch_counters():
        for k in d:
            d[k] = 0


def _all_launches() -> dict:
    from repro_torch.graphs import launch_counters
    return {k: v for d in launch_counters() for k, v in d.items() if v}


def _family_bundle(arch, fused, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """The train step of ``arch``: LAMB at 1e-3, fp32 master weights, bf16
    compute; ``fused`` the fused LAMB kernels (and, set by each run,
    REPRO_FUSED_BLOCKS)."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.train.steps import build_train_step
    return build_train_step(RunConfig(
        arch=arch, shape=ShapeConfig("chip", seq_len=seq, global_batch=batch,
                                     kind="train"),
        optimizer="lamb", learning_rate=1e-3, zero1=False,
        fused_optimizer_kernel=fused, master_weights=True), "cuda")


def _family_data(arch, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.data import DataConfig, SyntheticPipeline
    return SyntheticPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=seq, global_batch=batch,
        objective="causal", seed=SEED))


def _family_run(name, arch, fused, *, graphed=True, steps=FAMILY_STEPS,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, state=None, bundle=None,
                start=0, data=None):
    """``steps`` causal-LM steps of ``arch`` through ``train_loop`` (from
    ``start``), on ``bundle.fn`` (step 1 the warm-up, step 2 the capture,
    then one replay a step) or with ``graphed=False`` on ``bundle.eager``;
    ``fused`` turns on both REPRO_FUSED_BLOCKS and the fused LAMB kernels.
    A new bundle, a state from the seeded init and the seeded batches
    unless given. Every launch counter is set to 0 just before the loop
    and read just after."""
    from repro_torch.train.loop import LoopConfig, train_loop
    os.environ["REPRO_FUSED_BLOCKS"] = "1" if fused else "0"
    bundle = bundle or _family_bundle(arch, fused, batch, seq)
    state = state if state is not None else bundle.init(SEED)
    data = data or _family_data(arch, batch, seq)
    step_fn = bundle.fn if graphed else bundle.eager
    tag = f"{name} {'fused' if fused else 'unfused'}" + (
        "" if graphed else " eager")
    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = train_loop(step_fn, state, data, LoopConfig(
        max_steps=start + steps, log_every=1), start_step=start,
        log=lambda s: print(f"[train {tag}] {s}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        _fail(f"{tag} training: non-finite loss {losses}")
    steady = [h["dt"] for h in hist[2:]]
    return {"losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
            "step_s": float(np.median(steady)) if steady else None,
            "wall": wall, "peak": torch.cuda.max_memory_allocated(),
            "base": base, "launches": _all_launches(), "bundle": bundle,
            "state": state, "step_fn": step_fn, "data": data, "tag": tag}


def _state_digest(state) -> list:
    """Two exact integer sums of every leaf's bits (their sum, and their
    sum weighted by position mod 65521): equal digests mean bitwise equal
    states but for a collision."""
    from repro_torch import tree
    out = []
    for t in tree.leaves(state):
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((int(bits.sum()), int((bits * w).sum())))
        del bits, w
    return out


def _ulp_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| in bf16 ulps of b's largest |value| (a weight
    near 0 would make an ulp of its own meaningless)."""
    return ((a.float() - b.float()).abs().max()
            / _bf16_ulp(b.float().abs().max())).item()


def _drop_graph(bundle) -> None:
    """Release a StepGraph's captured graph and its memory pool."""
    g = bundle.fn
    g.entry, g._pool, g.out, g.inputs, g._key = None, None, None, {}, None
    gc.collect()
    torch.cuda.empty_cache()


def _free(*runs) -> None:
    for r in runs:
        for k in ("bundle", "state", "step_fn"):
            r.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()


def _expect(run, want: dict, what: str) -> None:
    """Exact launches of the run: ``want`` a step for every kernel named,
    and no other kernel."""
    n = len(run["losses"])
    got = run["launches"]
    exp = {k: v * n for k, v in want.items() if v}
    if got != exp:
        _fail(f"{what}: launches {got} in {n} steps, expected {exp}")


ROTATE = 8   # input sets a timing at a training shape cycles through


def _cycling(fn, sets):
    """A call of ``fn(*sets[i])``, i cycling over ``sets``: with ROTATE
    sets of a training shape's inputs (8 x 12.6 MB or more) every call
    reads inputs that the 50 MB L2 no longer holds, so the time can be
    held against the HBM byte bound."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def training_norm_shapes(dev):
    """Rows 4 and 11 at the training steps' shapes: the add + norm at
    llama's [B8 x S128, 3072] and the gated norm at mamba2's [1024, 4096]
    (z in place as columns of an in_proj row), held as in phase 3 (x + y
    bitwise, the norm within 1 bf16 ulp; the gated norm within 1 bf16 ulp
    of the row's largest |output|); device ms from the profiler beside the
    byte bound and F.rms_norm of a precomputed sum or gated product (the
    norm only), each timed over ROTATE sets of inputs (L2-cold reads)."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_layernorm import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    rows = TRAIN_BATCH * TRAIN_SEQ
    out = {}
    d = 3072
    sets = [((0.5 * torch.randn((rows, d), generator=gen, device=dev)
              ).bfloat16(), torch.randn((rows, d), generator=gen,
                                        device=dev).bfloat16())
            for _ in range(ROTATE)]
    y, x = sets[0]
    sc = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).bfloat16()
    h, x2 = ops.decode_residual_norm(y, x, sc, kind="rmsnorm")
    ph, px2 = ref.decode_residual_norm(y, x, sc, kind="rmsnorm")
    if not torch.equal(x2.view(torch.int16), px2.view(torch.int16)) or \
            not bool(((h.float() - ph.float()).abs() <= _bf16_ulp(ph)).all()):
        _fail(f"decode_residual_norm [{rows}, {d}]: beyond 1 bf16 ulp")
    drn = _cycling(lambda a, b: ops.decode_residual_norm(
        a, b, sc, kind="rmsnorm"), sets)
    sums = [(b + a,) for a, b in sets]
    ev_ms = _time_ms(drn, 200)
    dev_ms = _profiled_ms(drn, DEVICE_NAMES["decode_residual_norm"], 50)
    lib = _profiled_ms(_cycling(lambda t: F.rms_norm(t, (d,), sc, 1e-5),
                                sums), ("",), 50)
    bound, by = _bound(4 * rows * d * 2 + d * 2, 5.0 * rows * d, fp32=True)
    out["decode_residual_norm"] = {
        "shape": [rows, d], "device_ms": dev_ms, "ms": ev_ms,
        "bound_ms": bound,
        "bound_by": by, "library_ms": lib, "plan": ops.norm_plan(rows, d),
        "input_sets": ROTATE,
        "bitwise_h_share": float((h.view(torch.int16) == ph.view(
            torch.int16)).float().mean()),
        "h_max_gap_bf16_ulps": ((h.float() - ph.float()).abs()
                                / _bf16_ulp(ph)).max().item(),
        "library_note": "F.rms_norm of the precomputed bf16 sum: the norm "
                        "only"}
    del sets, sums
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    arch = get_config("mamba2-1.3b")
    c = ssm.inner_dim(arch)
    width = 2 * c + 2 * arch.ssm.state_dim + ssm.num_ssm_heads(arch)
    sets = [(torch.randn((rows, c), generator=gen, device=dev).bfloat16(),
             (2 * torch.randn((rows, width), generator=gen, device=dev)
              ).bfloat16()[:, :c]) for _ in range(ROTATE)]
    yy, z = sets[0]
    scg = (1 + 0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()
    g = ops.gated_rmsnorm(yy, z, scg)
    pg = ref.gated_rmsnorm(yy, z, scg)
    tol = _bf16_ulp(pg.float().abs().amax(dim=-1, keepdim=True))
    if not bool(((g.float() - pg.float()).abs() <= tol).all()):
        _fail(f"gated_rmsnorm [{rows}, {c}]: beyond 1 bf16 ulp of the "
              "row's largest |output|")
    gnorm = _cycling(lambda a, b: ops.gated_rmsnorm(a, b, scg), sets)
    gated = [(a * (b * torch.sigmoid(b)),) for a, b in sets]
    ev_g = _time_ms(gnorm, 200)
    dev_g = _profiled_ms(gnorm, DEVICE_NAMES["gated_rmsnorm"], 50)
    lib_g = _profiled_ms(_cycling(lambda t: F.rms_norm(t, (c,), scg, 1e-5),
                                  gated), ("",), 50)
    del sets, gated
    bound_g, by_g = _bound(3 * rows * c * 2 + c * 2, 9.0 * rows * c,
                           fp32=True)
    out["gated_rmsnorm"] = {
        "shape": [rows, c], "device_ms": dev_g, "ms": ev_g,
        "bound_ms": bound_g,
        "bound_by": by_g, "library_ms": lib_g,
        "plan": ops.norm_plan(rows, c, True), "input_sets": ROTATE,
        "library_note": "F.rms_norm of the precomputed bf16 gated product: "
                        "the norm only, not the gate"}
    print(f"[train norms] at the training steps' shapes, each timed over "
          f"{ROTATE} input sets (device ms; events ms; bound; F.rms_norm of "
          f"the precomputed input, device ms): "
          + "; ".join(
              f"{k} {v['shape']} {_ms(v['device_ms'])} ({v['ms']:.5f}; bound "
              f"{v['bound_ms']:.5f} by {v['bound_by']}, F.rms_norm "
              f"{_ms(v['library_ms'])}, plan {v['plan']})"
              for k, v in out.items()))
    return out


def attention_tiles(dev):
    """One llama attention layer at B1 S4096 (24 / 8 heads of 128, bf16,
    causal, chunks of LONG_CHUNK), forward then backward: through the
    chunked VJP, through autodiff of the same forward loop and through the
    flash kernel's Function (its lse beside the output, the chunked
    backward over LONG_CHUNK tiles). The bytes still held after the
    forward (what each saves for its backward) and the peak above the
    inputs; a score tile is [1, 24, 4096, 1024] fp32. The VJP and the
    flash Function must hold less than one tile, and the flash dq / dk /
    dv must lie within BLOCK_REL_L2 of the chunked VJP's."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention as attn_lib
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    q = torch.randn((1, LONG_SEQ, 24, 128), generator=gen, device=dev)
    k, v = (torch.randn((1, LONG_SEQ, 8, 128), generator=gen, device=dev)
            for _ in range(2))
    q, k, v = (t.bfloat16().requires_grad_(True) for t in (q, k, v))
    ct = torch.randn((1, LONG_SEQ, 24, 128), generator=gen,
                     device=dev).bfloat16()
    tile = 24 * LONG_SEQ * LONG_CHUNK * 4
    out = {"tile_bytes": tile}

    def run(label, fwd):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        o = fwd()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(o, (q, k, v), ct)
        torch.cuda.synchronize()
        out[label] = {"held_after_forward": held,
                      "peak_above_inputs": torch.cuda.max_memory_allocated()
                      - base}
        return o.detach(), grads
    o1, g1 = run("vjp", lambda: attn_lib.chunked_attention(
        q, k, v, causal=True, chunk=LONG_CHUNK))
    o2, g2 = run("autodiff", lambda: attn_lib._chunked_forward(
        q, k, v, None, True, LONG_CHUNK, 0, 0)[0])
    n0 = flash_ops.LAUNCHES["flash_attention"]
    o3, g3 = run("flash", lambda: flash_ops.flash_attention(
        q, k, v, causal=True, block_kv=LONG_CHUNK))
    out["flash_launches"] = flash_ops.LAUNCHES["flash_attention"] - n0
    out["max_rel_l2_grads"] = max(_rel_l2(a, b) for a, b in zip(g1, g2))
    out["outputs_bitwise"] = torch.equal(o1, o2)
    out["flash_rel_l2_grads_vs_vjp"] = [_rel_l2(a, b)
                                        for a, b in zip(g3, g1)]
    out["flash_rel_l2_out_vs_vjp"] = _rel_l2(o3, o1)
    print(f"[chunked vjp] one llama layer's attention, B1 S{LONG_SEQ}, "
          f"chunks of {LONG_CHUNK} (a score tile {tile / 2**20:.0f} MiB): "
          f"held after the forward {out['vjp']['held_after_forward'] / 2**20:.1f}"
          f" MiB through the VJP against "
          f"{out['autodiff']['held_after_forward'] / 2**20:.1f} MiB through "
          f"autodiff of the loop; peak above the inputs "
          f"{out['vjp']['peak_above_inputs'] / 2**20:.1f} against "
          f"{out['autodiff']['peak_above_inputs'] / 2**20:.1f} MiB; outputs "
          f"bitwise {out['outputs_bitwise']}, dq/dk/dv rel L2 "
          f"{out['max_rel_l2_grads']:.2e}")
    fl = out["flash"]
    print(f"[flash vjp] the same layer through the flash Function "
          f"({out['flash_launches']} kernel launch): held after the forward "
          f"{fl['held_after_forward'] / 2**20:.1f} MiB (out and lse; the "
          f"chunked VJP {out['vjp']['held_after_forward'] / 2**20:.1f}), "
          f"peak above the inputs {fl['peak_above_inputs'] / 2**20:.1f} "
          f"MiB; against the chunked VJP: out rel L2 "
          f"{out['flash_rel_l2_out_vs_vjp']:.2e}, dq/dk/dv rel L2 "
          + ", ".join(f"{x:.2e}" for x in out["flash_rel_l2_grads_vs_vjp"])
          + f" (tol {BLOCK_REL_L2})")
    if not out["vjp"]["held_after_forward"] < tile:
        _fail("the chunked VJP held a score tile or more after its forward")
    if not (fl["held_after_forward"] < tile and out["flash_launches"] == 1):
        _fail(f"the flash Function held {fl['held_after_forward']} bytes "
              f"after its forward (a tile {tile}) in "
              f"{out['flash_launches']} launches")
    if not max(out["flash_rel_l2_grads_vs_vjp"]
               + [out["flash_rel_l2_out_vs_vjp"]]) <= BLOCK_REL_L2:
        _fail(f"flash Function against the chunked VJP: out and dq/dk/dv "
              f"rel L2 {out['flash_rel_l2_out_vs_vjp']}, "
              f"{out['flash_rel_l2_grads_vs_vjp']} > {BLOCK_REL_L2}")
    if not out["max_rel_l2_grads"] <= BLOCK_REL_L2:
        _fail(f"chunked VJP gradients against autodiff of the loop: rel L2 "
              f"{out['max_rel_l2_grads']} > {BLOCK_REL_L2}")
    return out


def llama_training(dev, norms):
    """llama3.2-3b at full width and depth, B8 S128: one unfused plain step
    (eager, plain LAMB), 6 fused steps eager and 6 graphed from the same
    seeded weights (bitwise equal: losses, grad norms and a digest of every
    state leaf), exact launches a step, the replayed step profiled; then
    B1 S4096 through the chunked VJP on the graphed run's state."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_lib
    arch = get_config("llama3.2-3b")
    held = torch.cuda.memory_allocated()
    # 1. the unfused plain step 1
    t0 = time.perf_counter()
    plain = _family_run("llama3.2-3b", arch, False, graphed=False, steps=1)
    init_s = time.perf_counter() - t0 - plain["wall"]
    n_params = sum(t.numel() for t in tree.leaves(plain["state"]["params"]))
    print(f"[train llama] {arch.name} {arch.num_layers}L d{arch.d_model}, "
          f"{n_params} parameters: bf16 params and grads, fp32 master, m and "
          f"v = 16 B each, {n_params * 16 / 1e9:.1f} GB before the clip's "
          f"temporaries and the graph pool; held at the phase's start "
          f"{held / 2**30:.2f} GiB; the seeded init {init_s:.1f} s")
    params_1 = [p.detach().clone() for p in tree.leaves(
        plain["state"]["params"])]
    _free(plain)
    # 2. fused eager: step 1 (against the plain step), then 5 more
    eager = _family_run("llama3.2-3b", arch, True, graphed=False, steps=1)
    fused_1 = tree.leaves(eager["state"]["params"])
    gap = max(_ulp_gap(a, b) for a, b in zip(fused_1, params_1))
    same = sum(torch.equal(a, b) for a, b in zip(fused_1, params_1))
    equal = sum(int((a == b).sum()) for a, b in zip(fused_1, params_1)) \
        / sum(a.numel() for a in fused_1)
    del params_1, fused_1
    step1 = {"loss_fused": eager["losses"][0], "loss_plain":
             plain["losses"][0], "loss_bitwise": eager["losses"][0]
             == plain["losses"][0], "grad_norm_fused":
             eager["grad_norms"][0], "grad_norm_plain":
             plain["grad_norms"][0], "params_bitwise_leaves": same,
             "params_max_gap_bf16_ulps": gap, "params_equal_share": equal,
             "loss_gap_bf16_ulps": abs(eager["losses"][0]
                                       - plain["losses"][0])
             / _bf16_ulp(torch.tensor(plain["losses"][0])).item()}
    print(f"[train llama] step 1 fused (decode_residual_norm, fused LAMB) "
          f"against the unfused plain step from the same weights: loss "
          f"{step1['loss_fused']!r} vs {step1['loss_plain']!r} (bitwise "
          f"{step1['loss_bitwise']}, {step1['loss_gap_bf16_ulps']:.3f} bf16 "
          f"ulps), grad norm {step1['grad_norm_fused']!r} vs "
          f"{step1['grad_norm_plain']!r}; updated bf16 params: {same} of "
          f"{len(tree.leaves(eager['state']['params']))} leaves and "
          f"{equal:.6f} of the elements bitwise, largest gap {gap:.3f} bf16 "
          f"ulps of its leaf's largest |value|; the add + norm kernel's h "
          f"is bitwise the plain norm's in "
          f"{norms['decode_residual_norm']['bitwise_h_share']:.7f} of its "
          f"elements at this shape (the rest 1 ulp: its fp32 sums run in "
          f"another order), and LAMB's kernel and plain versions sum the "
          f"trust ratio's norms in other orders")
    if not (gap <= STEP1_PARAM_ULPS
            and step1["loss_gap_bf16_ulps"] <= STEP1_LOSS_ULPS):
        _fail(f"llama step 1 fused against the unfused plain step: updated "
              f"bf16 params {gap} bf16 ulps of a leaf's largest |value| "
              f"apart (tol {STEP1_PARAM_ULPS}), loss "
              f"{step1['loss_gap_bf16_ulps']} bf16 ulps of the loss apart "
              f"(tol {STEP1_LOSS_ULPS})")
    rest = _family_run("llama3.2-3b", arch, True, graphed=False,
                       steps=FAMILY_STEPS - 1, start=1,
                       state=eager["state"], bundle=eager["bundle"],
                       data=eager["data"])
    eager_losses = eager["losses"] + rest["losses"]
    eager_norms = eager["grad_norms"] + rest["grad_norms"]
    digest = _state_digest(rest["state"])
    leaf_sizes = [t.numel() for t in tree.leaves(rest["state"]["params"])]
    n_leaves = len(leaf_sizes)
    want = {"decode_residual_norm": 2 * arch.num_layers,
            "lamb_stage1": n_leaves, "lamb_stage2": n_leaves}
    for r in (eager, rest):
        _expect(r, want, "llama3.2-3b fused eager")
    _expect(plain, {}, "llama3.2-3b unfused plain step")
    _free(eager, rest)
    # 3. fused graphed
    run = _family_run("llama3.2-3b", arch, True)
    _expect(run, want, "llama3.2-3b fused graphed")
    g = run["bundle"].fn
    if (g.captures, g.replays) != (1, FAMILY_STEPS - 1):
        _fail(f"llama graphed run: {g.captures} captures, {g.replays} "
              f"replays")
    if run["losses"] != eager_losses or run["grad_norms"] != eager_norms:
        _fail(f"llama: the graphed steps differ from the eager ones: "
              f"{run['losses']} vs {eager_losses}")
    if _state_digest(run["state"]) != digest:
        _fail("llama: the graphed run's final state differs from the eager "
              "run's (bit digests)")
    graph = {"captures": g.captures, "replays": g.replays,
             "pool_bytes": g.pool_bytes}
    prof = profile_train_step(run, leaf_sizes, "llama3.2-3b graphed")
    steady = steady_step_ms(run)
    print(f"[train llama] {FAMILY_STEPS} graphed fused steps bitwise the "
          f"eager ones (losses, grad norms, digests of {len(digest)} state "
          f"leaves); losses {[round(x, 4) for x in run['losses']]}; median "
          f"step (3-{FAMILY_STEPS}) {run['step_s'] * 1e3:.2f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / run['step_s']:.0f} tokens/s; 5 more "
          f"back to back {steady:.2f} ms a step; peak "
          f"{run['peak'] / 2**30:.2f} GiB ({run['base'] / 2**30:.2f} held "
          f"at the loop's start); graph pool {g.pool_bytes / 2**30:.3f} GiB;"
          f" launches a step {want}")
    if not run["losses"][-1] < run["losses"][0]:
        _fail(f"llama training: loss did not fall: {run['losses']}")
    # 4. B1 S4096 through the chunked VJP, on the same state
    _drop_graph(run["bundle"])
    calls = {"n": 0}
    real = attn_lib.chunked_attention

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    attn_lib.chunked_attention = counted
    try:
        long = _family_run(
            "llama3.2-3b S4096", arch, True, graphed=False,
            steps=LONG_STEPS, batch=1, seq=LONG_SEQ, state=run["state"],
            bundle=run["bundle"], start=FAMILY_STEPS,
            data=_family_data(arch, 1, LONG_SEQ))
    finally:
        attn_lib.chunked_attention = real
    if calls["n"] != 2 * arch.num_layers * LONG_STEPS:
        _fail(f"llama S{LONG_SEQ}: {calls['n']} chunked attention calls, "
              f"expected {2 * arch.num_layers * LONG_STEPS}")
    _expect(long, want, f"llama3.2-3b S{LONG_SEQ}")
    print(f"[train llama] B1 S{LONG_SEQ} (attn_chunk {arch.attn_chunk}), "
          f"{LONG_STEPS} eager fused steps through the chunked VJP "
          f"({calls['n']} calls): losses "
          f"{[round(x, 4) for x in long['losses']]}, wall {long['wall']:.2f}"
          f" s, peak {long['peak'] / 2**30:.2f} GiB "
          f"({(long['peak'] - long['base']) / 2**30:.2f} above the state)")
    t_flash = time.perf_counter()
    flash = flash_training(arch, run, long)
    flash_s = time.perf_counter() - t_flash
    _free(run, long, flash)
    tiles = attention_tiles(dev)
    t_flash = time.perf_counter()
    flash["graphed"] = flash_graphed(arch)
    flash["added_s"] = flash_s + time.perf_counter() - t_flash
    return {"n_params": n_params, "n_leaves": n_leaves, "step1": step1,
            "losses": run["losses"], "eager_losses": eager_losses,
            "grad_norms": run["grad_norms"], "step_s": run["step_s"],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / run["step_s"],
            "steady_step_ms": steady, "peak": run["peak"],
            "held_at_start": run["base"], "graph": graph, "profile": prof,
            "per_step": want, "launches": run["launches"],
            "long": {"losses": long["losses"], "wall": long["wall"],
                     "peak": long["peak"], "held_at_start": long["base"],
                     "chunked_calls": calls["n"], "tiles": tiles,
                     "flash": {k: v for k, v in flash.items()
                               if k not in ("bundle", "state", "step_fn",
                                            "data")}},
            "init_s": init_s}


def flash_training(arch, run, long):
    """B1 S4096 through the flash kernel (``attn_impl="flash"``: its
    Function, forward kernel with the lse, chunked backward) on the state
    the chunked run left: LONG_STEPS eager fused steps, exactly 2 x layers
    flash launches a step (each block's forward and its recompute), and
    step 1's loss against the chunked forward's loss on the same state and
    batch within FLASH_LOSS_ULPS bf16 ulps; the step times beside the
    chunked run's."""
    from repro_torch import tree
    from repro_torch.models import model as model_lib
    flash_arch = dataclasses.replace(arch, attn_impl="flash")
    start = FAMILY_STEPS + LONG_STEPS
    data = _family_data(arch, 1, LONG_SEQ)
    first = {k: torch.as_tensor(v).cuda()
             for k, v in data.batch(start).items()}
    os.environ["REPRO_FUSED_BLOCKS"] = "1"
    with torch.no_grad():
        chunked_loss = model_lib.loss(arch, run["state"]["params"],
                                      first)[0].item()
    del first
    bundle = _family_bundle(flash_arch, True, 1, LONG_SEQ)
    fl = _family_run(f"llama3.2-3b S{LONG_SEQ} flash", flash_arch, True,
                     graphed=False, steps=LONG_STEPS, batch=1, seq=LONG_SEQ,
                     state=run["state"], bundle=bundle, start=start,
                     data=data)
    n_leaves = len(tree.leaves(run["state"]["params"]))
    want = {"decode_residual_norm": 2 * arch.num_layers,
            "flash_attention": 2 * arch.num_layers,
            "lamb_stage1": n_leaves, "lamb_stage2": n_leaves}
    _expect(fl, want, f"llama3.2-3b S{LONG_SEQ} flash")
    gap = abs(fl["losses"][0] - chunked_loss) \
        / _bf16_ulp(torch.tensor(chunked_loss)).item()
    step = (fl["wall"] / LONG_STEPS, long["wall"] / LONG_STEPS)
    print(f"[train llama flash] B1 S{LONG_SEQ}, {LONG_STEPS} eager fused "
          f"steps with attn_impl='flash' on the state the chunked run left: "
          f"losses {[round(x, 4) for x in fl['losses']]}; step 1 "
          f"{fl['losses'][0]!r} against the chunked forward's "
          f"{chunked_loss!r} on the same state and batch ({gap:.3f} bf16 "
          f"ulps, tol {FLASH_LOSS_ULPS}); "
          f"{fl['launches'].get('flash_attention', 0)}"
          f" flash launches ({want['flash_attention']} a step); "
          f"{step[0]:.3f} s a step (wall / steps) against the chunked "
          f"run's {step[1]:.3f} in this call; peak "
          f"{fl['peak'] / 2**30:.2f} GiB "
          f"({(fl['peak'] - fl['base']) / 2**30:.2f} above the state)")
    if not gap <= FLASH_LOSS_ULPS:
        _fail(f"flash step 1 loss {fl['losses'][0]} is {gap} bf16 ulps from "
              f"the chunked forward's {chunked_loss} (tol "
              f"{FLASH_LOSS_ULPS})")
    fl.update(chunked_loss=chunked_loss, loss_gap_bf16_ulps=gap,
              step_s=step[0], chunked_step_s=step[1], per_step=want)
    return fl


def flash_graphed(arch):
    """The flash Function inside a captured training step: llama3.2-3b at
    full width cut to FLASH_GRAPH_LAYERS layers, B1 S4096, 3 fused steps
    through ``bundle.fn`` (step 1 the warm-up, step 2 the capture and its
    replay, step 3 a replay) and 3 through ``bundle.eager`` from the same seeded weights:
    losses, grad norms and every state leaf bitwise equal, and exactly 2 x
    layers flash launches a step on both (a replay adds what its capture
    counted)."""
    from repro_torch import tree
    cut = dataclasses.replace(arch, attn_impl="flash",
                              num_layers=FLASH_GRAPH_LAYERS)
    runs = {}
    for graphed in (True, False):
        r = _family_run(f"llama3.2-3b {FLASH_GRAPH_LAYERS}L S{LONG_SEQ} "
                        "flash", cut, True, graphed=graphed, steps=3,
                        batch=1, seq=LONG_SEQ)
        n_leaves = len(tree.leaves(r["state"]["params"]))
        _expect(r, {"decode_residual_norm": 2 * cut.num_layers,
                    "flash_attention": 2 * cut.num_layers,
                    "lamb_stage1": n_leaves, "lamb_stage2": n_leaves},
                f"llama {FLASH_GRAPH_LAYERS}L flash "
                f"{'graphed' if graphed else 'eager'}")
        g = r["bundle"].fn
        runs[graphed] = {"losses": r["losses"],
                         "grad_norms": r["grad_norms"],
                         "digest": _state_digest(r["state"]),
                         "captures": g.captures, "replays": g.replays}
        _free(r)
    a, b = runs[True], runs[False]
    same = (a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
            and a["digest"] == b["digest"])
    print(f"[train llama flash] {FLASH_GRAPH_LAYERS} layers at full width, "
          f"B1 S{LONG_SEQ}: 3 graphed steps ({a['captures']} capture, "
          f"{a['replays']} replays) bitwise the 3 eager ones: {same} (losses "
          f"{[round(x, 4) for x in a['losses']]}; digests of "
          f"{len(a['digest'])} state leaves)")
    if not (same and (a["captures"], a["replays"]) == (1, 2)):
        _fail(f"flash graphed steps against eager: bitwise {same}, "
              f"{a['captures']} captures, {a['replays']} replays")
    return {"losses": a["losses"], "bitwise": same,
            "captures": a["captures"], "replays": a["replays"]}


def mamba_training(dev):
    """mamba2-1.3b at full width and depth, B8 S128: 6 steps graphed and 6
    eager from the same seeded weights, both states held and compared
    bitwise; exact launches a step (48 gated norms a pass, twice with the
    recompute; one LAMB launch of each stage a leaf); the replayed step
    profiled."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    arch = get_config("mamba2-1.3b")
    run = _family_run("mamba2-1.3b", arch, True)
    eager = _family_run("mamba2-1.3b", arch, True, graphed=False)
    leaf_sizes = [t.numel() for t in tree.leaves(run["state"]["params"])]
    n_leaves = len(leaf_sizes)
    want = {"gated_rmsnorm": 2 * arch.num_layers, "lamb_stage1": n_leaves,
            "lamb_stage2": n_leaves}
    for r in (run, eager):
        _expect(r, want, r["tag"])
    diff = sum(not torch.equal(a, b) for a, b in zip(
        tree.leaves(run["state"]), tree.leaves(eager["state"])))
    if diff or run["losses"] != eager["losses"] or \
            run["grad_norms"] != eager["grad_norms"]:
        _fail(f"mamba2: graphed and eager runs differ ({diff} state leaves;"
              f" losses {run['losses']} vs {eager['losses']})")
    g = run["bundle"].fn
    if (g.captures, g.replays) != (1, FAMILY_STEPS - 1):
        _fail(f"mamba2 graphed run: {g.captures} captures, {g.replays} "
              f"replays")
    if not run["losses"][-1] < run["losses"][0]:
        _fail(f"mamba2 training: loss did not fall: {run['losses']}")
    n_state = sum(t.numel() * t.element_size()
                  for t in tree.leaves(run["state"]))
    graph = {"captures": g.captures, "replays": g.replays,
             "pool_bytes": g.pool_bytes}
    _free(eager)
    prof = profile_train_step(run, leaf_sizes, "mamba2-1.3b graphed")
    steady = steady_step_ms(run)
    print(f"[train mamba2] {arch.name} {arch.num_layers}L d{arch.d_model}, "
          f"{sum(leaf_sizes)} parameters in {n_leaves} leaves, state "
          f"{n_state / 1e9:.1f} GB: {FAMILY_STEPS} graphed fused steps "
          f"bitwise the eager ones (every state leaf); losses "
          f"{[round(x, 4) for x in run['losses']]}; median step "
          f"{run['step_s'] * 1e3:.2f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / run['step_s']:.0f} tokens/s; 5 more "
          f"back to back {steady:.2f} ms; peak {run['peak'] / 2**30:.2f} "
          f"GiB; graph pool {g.pool_bytes / 2**30:.3f} GiB; launches a step "
          f"{want}")
    out = {"n_params": sum(leaf_sizes), "n_leaves": n_leaves,
           "state_bytes": n_state, "losses": run["losses"],
           "grad_norms": run["grad_norms"], "step_s": run["step_s"],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / run["step_s"],
           "steady_step_ms": steady, "peak": run["peak"],
           "held_at_start": run["base"], "graph": graph,
           "profile": prof, "per_step": want, "launches": run["launches"]}
    _free(run)
    return out


def checkpoint_on_card(dev):
    """Checkpoint / restart on the card at smoke size (llama3.2-3b-smoke,
    bf16, fused blocks and LAMB kernels, B4 S32): a run of 4 graphed steps;
    the same with ckpt_every 2; a restart from step 2 into a new bundle's
    tensors (as a new process would: its own warm-up and one capture) and
    into the checkpointing run's own tensors (its captured graph replayed,
    no new capture), each giving steps 3-4's losses and the final state
    bitwise the uninterrupted run's; then save_async, the next step at
    once, and the restored checkpoint bitwise the state before that step
    (the manager's own host copy: the tree it is given holds the card
    tensors the step updates). The directory is made under build/ and
    removed."""
    import shutil
    import tempfile
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.models.convert import load_state_, state_to_jax
    from repro_torch.models.transformer import period_length
    from repro_torch.train.loop import LoopConfig, train_loop
    arch = smoke_config("llama3.2-3b")
    shape = dict(batch=CKPT_BATCH, seq=CKPT_SEQ)
    data = _family_data(arch, **shape)
    ref_run = _family_run("llama smoke", arch, True, steps=CKPT_STEPS,
                          data=data, **shape)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_", dir=build)
    try:
        mgr = CheckpointManager(root)
        b = _family_bundle(arch, True, **shape)
        st = b.init(SEED)
        out = train_loop(b.fn, st, data, LoopConfig(
            max_steps=CKPT_STEPS, ckpt_every=2), ckpt=mgr,
            ckpt_tree=lambda x: state_to_jax(x, period_length(arch)),
            log=lambda s: None)
        if [h["loss"] for h in out["history"]] != ref_run["losses"]:
            _fail("checkpointing changed the losses")
        if mgr.latest_step() != CKPT_STEPS:
            _fail(f"checkpoints: latest step {mgr.latest_step()}")
        results = {}
        fresh = _family_bundle(arch, True, **shape)
        for label, (bundle, state) in (
                ("new bundle", (fresh, fresh.init(SEED + 1))),
                ("same bundle", (b, st))):
            before = [t.data_ptr() for t in tree.leaves(state)]
            load_state_(state, mgr.restore(2)["state"])
            captures = bundle.fn.captures
            res = _family_run("llama smoke", arch, True, steps=2, start=2,
                              state=state, bundle=bundle, data=data,
                              **shape)
            kept = [t.data_ptr() for t in tree.leaves(state)] == before
            same = all(torch.equal(x, y) for x, y in zip(
                tree.leaves(state), tree.leaves(ref_run["state"])))
            results[label] = {
                "losses": res["losses"],
                "bitwise": res["losses"] == ref_run["losses"][2:] and same,
                "new_captures": bundle.fn.captures - captures,
                "addresses_kept": kept}
            if not (kept and results[label]["bitwise"]):
                _fail(f"restart from step 2 ({label}): losses "
                      f"{res['losses']} vs {ref_run['losses'][2:]}, state "
                      f"bitwise {same}, addresses kept {kept}")
        if results["new bundle"]["new_captures"] != 1 or \
                results["same bundle"]["new_captures"] != 0:
            _fail(f"restart captures: {results}")
        # save_async of card tensors that the next step (a replay) updates
        # in place, then that step at once
        live = {"params": {k: st["params"][k] for k in ("embed",
                                                        "final_norm")},
                "opt": {"step": st["opt"]["step"]}}
        snap = [t.detach().cpu() for t in tree.leaves(live)]
        mgr.save_async(99, live, extra={"data_step": 99})
        b.fn(st, data.batch(CKPT_STEPS))
        torch.cuda.synchronize()
        mgr.wait()
        back = tree.leaves(mgr.restore(99)["state"])
        snap_ok = len(back) == len(snap) and all(
            torch.equal(x, y) for x, y in zip(snap, back))
        stepped = any(not torch.equal(x, y.cpu()) for x, y in zip(
            snap, tree.leaves(live)))
        if not (snap_ok and stepped):
            _fail(f"save_async: restored bitwise the pre-step state "
                  f"{snap_ok}, the step changed the state {stepped}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _free(ref_run)
    print(f"[checkpoint] llama smoke on the card, {CKPT_STEPS} graphed fused"
          f" steps, ckpt_every 2: restart from step 2 bitwise the "
          f"uninterrupted run (losses and every state leaf) into a new "
          f"bundle ({results['new bundle']['new_captures']} capture) and "
          f"into the same bundle's tensors "
          f"({results['same bundle']['new_captures']} captures); save_async "
          f"then the next step at once: restored bitwise the pre-step state")
    return {"restarts": results, "save_async_snapshot_bitwise": snap_ok}


def train_families_phase(dev, marks):
    """Phase 8b: the training families after bert-large."""
    t0 = time.perf_counter()
    norms = training_norm_shapes(dev)
    marks["train norms"] = time.perf_counter()
    llama = llama_training(dev, norms)
    marks["train llama"] = time.perf_counter()
    mamba = mamba_training(dev)
    marks["train mamba2"] = time.perf_counter()
    ckpt = checkpoint_on_card(dev)
    marks["checkpoint"] = time.perf_counter()
    secs = time.perf_counter() - t0
    print(f"[train families] phase {secs:.1f} s")
    return {"norm_shapes": norms, "llama3.2-3b": llama,
            "mamba2-1.3b": mamba, "checkpoint": ckpt, "phase_s": secs}


# ------------------------------------------------------------ phase 9 ---
# Tensor-parallel continuous serving: llama3.2-3b at full width and depth,
# tp=2 ranks (one process each) against tp=1 on the same seeded weights.
TP = 2
TP_LOGIT_REL_L2 = 0.05   # the first final chunk's logits, tp=2 against
                         # tp=1: the row-parallel products are fp32 sums of
                         # two bf16-input halves where tp=1 runs one bf16
                         # GEMM (a bf16 rounding a reduce site, 56 a pass),
                         # as the logits checks' 0.05 elsewhere
TP_MARGIN = 0.25         # a greedy fork is a near-tie where tp=1's top-2
                         # logit margin at the first differing token is
                         # under this (logits of std about 1)
TP_DRAW_WINDOW = 0.05    # a sampled fork is a draw near an edge of the
                         # CDF: tp=1's and tp=2's tokens at the first
                         # differing token must both own an interval of the
                         # dense reference's filtered distribution within
                         # this of the request's uniform (logits that differ
                         # by bf16 reassociation move an edge of a 40-token
                         # top-k distribution at T 0.8 by about 0.01); a
                         # wrong seed or position draws a far token
TP_PEAK_SLACK = 256 << 20  # a rank's peak over its own baseline against
                           # tp=1's less (1 - 1/tp) of the blocks' bytes:
                           # the fp32 partial sums and the rank's half of
                           # the pools fit well inside this


def _nbytes(tensors) -> int:
    """The bytes of the storages behind ``tensors``, each counted once (a
    view keeps its whole storage alive)."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _draw_window(logits, sp, position, dev):
    """The plain draw at a sampled fork, on the dense reference's logits:
    -> (the request's uniform at ``position``, the tokens whose interval of
    the filtered distribution lies within TP_DRAW_WINDOW of it). The draw
    takes the first token whose prefix mass exceeds u, so a token's
    interval is [prefix before it, prefix through it)."""
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ref as samp_ref
    lg = samp_ref.filter_logits_ref(
        logits.float()[None] / sp.temperature,
        torch.tensor([sp.top_k], dtype=torch.int32, device=dev),
        torch.tensor([sp.top_p], dtype=torch.float32, device=dev))[0]
    u = head_ref.row_uniforms(torch.tensor([sp.seed]),
                              torch.tensor([position])).item()
    p = torch.softmax(lg.double(), dim=0)
    hi = p.cumsum(0)
    lo = hi - p
    near = (p > 0) & (lo < u + TP_DRAW_WINDOW) & (hi > u - TP_DRAW_WINDOW)
    return u, near.nonzero().flatten().tolist()


def row_parallel_products(arch, dev):
    """One row-parallel partial product at tp=2 at llama's decode rows (8)
    and a prefill chunk (64), for ``wo`` [q_dim / 2, D] and ``w2`` [F / 2,
    D] in bf16: the fp32 product of upcast copies of x and w (JAX's
    expression taken literally) against the GEMM with an fp32 output that
    ``layers.row_parallel_dense`` runs, each timed by CUDA events over 100
    calls, and their largest difference over the largest |y| (the same
    exact products summed in another order)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = {}
    for name, k in (("wo", arch.q_dim // TP), ("w2", arch.d_ff // TP)):
        w = (torch.randn((k, arch.d_model), generator=gen, device=dev)
             / math.sqrt(k)).bfloat16()
        for m in (8, 64):
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()

            def upcast(x=x, w=w):
                return x.float() @ w.float()

            def fp32_out(x=x, w=w):
                return torch.mm(x, w, out_dtype=torch.float32)
            a, b = upcast(), fp32_out()
            rel = ((a - b).abs().max() / a.abs().max()).item()
            if not rel <= 1e-3:
                _fail(f"row-parallel {name} [{m}, {k}]: the fp32-output "
                      f"GEMM differs from the upcast product by {rel}")
            rows[f"{name} [{m}, {k}] x [{k}, {arch.d_model}]"] = {
                "upcast_ms": _time_ms(upcast, 100),
                "fp32_out_ms": _time_ms(fp32_out, 100), "max_rel": rel}
    print(f"[tp] row-parallel partial product, bf16 x and w: upcast copies "
          f"against one GEMM with an fp32 output (ms, CUDA events): "
          + "; ".join(f"{k} {v['upcast_ms']:.5f} / {v['fp32_out_ms']:.5f}"
                      f" (rel {v['max_rel']:.2e})" for k, v in rows.items()))
    return rows


def _tp_modes(nccl: bool):
    """(label, fused decode, decode_steps): the captured loop at tp > 1
    needs nccl (gloo's collectives cannot be captured)."""
    modes = [("fused N=1", True, 1), ("unfused N=1", False, 1)]
    return modes + ([("fused N=4", True, 4)] if nccl else [])


def _tp_serve(group, rank, device, modes):
    """One rank of the TP phase (``group`` None: the tp=1 reference, in
    this process): llama3.2-3b at full width from the seeded init, the
    serving trace through ``ContinuousEngine(tp, group)`` in each mode,
    every launch counter set to 0 just before a run and read just after,
    the launches split between decode and prefill, the selection flags
    counted, the first final chunk's logits kept (unfused), and the
    engine's counters and ``tp_stats()``."""
    import faulthandler
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch import tree
    from repro_torch.models.model import Model
    from repro_torch.parallel import sharding
    from repro_torch.serving import ContinuousEngine
    # a rank that hangs in a collective shows where (its threads' stacks
    # on stderr) before the phase's timeout stops it
    faulthandler.dump_traceback_later(240)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = 1 if group is None else dist.get_world_size(group)
    arch = get_config("llama3.2-3b")
    base = torch.cuda.memory_allocated(device)
    model = Model.init(arch, torch.Generator(device=device).manual_seed(SEED),
                       device=device, shard=None if tp == 1 else (rank, tp))
    blocks = model.params["blocks"]
    split = [] if tp == 1 else [
        t for t, d in zip(tree.leaves(blocks),
                          tree.leaves(sharding.serving_param_spec(blocks)))
        if d is not None]
    weights = {"all": _nbytes(tree.leaves(model.params)),
               "blocks": _nbytes(tree.leaves(blocks)),
               "blocks_split": _nbytes(split)}
    out = {}
    for label, fused, n in modes:
        engine = ContinuousEngine(
            model, num_slots=8, num_pages=MULTI_PAGES, page_size=16,
            max_seq_len=512 + 32 + 16, prefill_chunk=64, fused_decode=fused,
            decode_steps=n, tp=tp, group=group)
        phase = {"decode": dict.fromkeys(_snapshot(), 0),
                 "prefill": dict.fromkeys(_snapshot(), 0)}
        flags = {"sampled": 0, "filtered": 0, "sampled_final": 0,
                 "filtered_final": 0}
        first = {}
        decode_fn = engine._decode if n == 1 else engine._decode_multi
        prefill_fn, logits_fn = engine._prefill, model._logits

        def decode(*a, sampled, filtered, fn=decode_fn):
            flags["sampled"] += bool(sampled)
            flags["filtered"] += bool(filtered)
            return _counted(phase["decode"], fn)(*a, sampled=sampled,
                                                 filtered=filtered)

        def prefill(*a, final, fn=prefill_fn, **kw):
            sp = a[5]
            if final and not sp.greedy:
                flags["sampled_final"] += 1
                flags["filtered_final"] += bool(sp.filtered)
            return _counted(phase["prefill"], fn)(*a, final=final, **kw)

        def probed_logits(x):
            lg = logits_fn(x)
            if "logits" not in first and x.shape[:2] == (1, 1):
                # numpy: a tensor would cross to the parent by a shared
                # memory handle that dies with this process
                first["logits"] = lg[0, 0].float().cpu().numpy()
            return lg
        if n == 1:
            engine._decode = decode
        else:
            engine._decode_multi = decode
        engine._prefill = prefill
        if not fused:
            model._logits = probed_logits
        _zero_counters()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = engine.run(trace(arch, SEED))
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        model.__dict__.pop("_logits", None)
        out[label] = {
            "tokens": {u: r["tokens"] for u, r in res.items()},
            "ttft_s": float(np.mean([r["token_times"][0]
                                     for r in res.values()])),
            "wall": wall, "launches": {k: dict(v) for k, v in phase.items()},
            "flags": flags, "logits": first.get("logits"),
            "counters": {k: getattr(engine, k) for k in (
                "steps", "decode_dispatches", "prefills", "prefill_chunks",
                "cow_copies", "collective_bytes")},
            "tp_stats": engine.tp_stats(), "weights": weights,
            "peak": torch.cuda.max_memory_allocated(device) - base,
            "backend": None if group is None else dist.get_backend(group)}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[tp] rank {rank} of {tp}: {label} served in {wall:.3f} s",
              flush=True)
    faulthandler.cancel_dump_traceback_later()
    return out


def _tp_expect_launches(run, arch, fused, label):
    """(d): exact launches from the rank's own steps, chunks and flags."""
    c, f, ph = run["counters"], run["flags"], run["launches"]
    layers = arch.num_layers
    want = {"decode": {"paged_decode_attention": layers * c["steps"]},
            "prefill": {"paged_prefill_attention":
                        layers * c["prefill_chunks"]}}
    if fused:
        want["decode"].update(decode_residual_norm=layers * c["steps"],
                              head_tokens=c["steps"])
        want["prefill"].update(
            decode_residual_norm=layers * c["prefill_chunks"],
            head_tokens=c["prefills"])
    else:
        want["decode"].update(filter_logits=f["filtered"],
                              draw_tokens=f["sampled"])
        want["prefill"].update(filter_logits=f["filtered_final"],
                               draw_tokens=f["sampled_final"])
    for where in ("decode", "prefill"):
        got = {k: v for k, v in ph[where].items() if v}
        exp = {k: v for k, v in want[where].items() if v}
        if got != exp:
            _fail(f"tp {label}: launches in {where} {got}, expected {exp}")


def tp_phase(dev, smi):
    """Phase 9: tensor-parallel serving. With two or more cards, tp=2 over
    nccl (a card a rank): fused N=1, unfused and fused N=4 (the captured
    loop with its collectives); with one card, two ranks share it over
    gloo, fused and unfused at N=1 (nccl and the loop at tp > 1 not
    exercised). Each rank builds only its shards (``Model.init(...,
    shard=)``). Gates: (a) every rank's streams bitwise rank 0's; (b) the
    first final chunk's logits within TP_LOGIT_REL_L2 of tp=1's; (c) the
    streams equal tp=1's but for a fork at a near-tie: greedy, tp=1's
    top-2 margin under TP_MARGIN there; sampled, both tokens within
    TP_DRAW_WINDOW of the draw's uniform on tp=1's CDF; (d) exact launches
    a rank from its steps and chunks (28 paged calls a step and a chunk;
    fused: 28 norms, one head); (e) ``collective_bytes`` JAX's formula;
    (f) a rank's split block leaves 1 / tp of tp=1's bytes, and its peak
    under tp=1's less (1 - 1/tp) of the blocks (TP_PEAK_SLACK). Then the
    row-parallel partial product timed both ways."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    from repro_torch.models.model import Model
    cards = torch.cuda.device_count()
    nccl = cards >= TP
    backend = "nccl" if nccl else "gloo"
    modes = _tp_modes(nccl)
    print(f"[tp] {cards} card(s): tp={TP} over {backend}"
          + ("" if nccl else " (two ranks share cuda:0; nccl and the "
             "captured loop at tp > 1 not exercised: they need a card a "
             "rank)") + f"; modes {[m[0] for m in modes]}")
    arch = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    ref = _tp_serve(None, 0, dev, modes)
    t1 = time.perf_counter()
    ranks = mesh.spawn(_tp_serve, TP, modes, backend=backend,
                       device=None if nccl else str(dev), timeout=300)
    t2 = time.perf_counter()
    psums = 2 * arch.num_layers
    per = lambda n: psums * n * arch.d_model * 4 * 2 * (TP - 1) // TP  # noqa
    out = {"backend": backend, "cards": cards, "card": smi,
           "tp1_s": t1 - t0, "tp2_s": t2 - t1, "modes": {}}
    reqs = trace(arch, SEED)
    ref_model = []

    def ref_logits(uid, toks):
        """tp=1's dense plain forward (the same seeded weights) after
        request ``uid``'s prompt and ``toks``: the last position's logits."""
        if not ref_model:
            ref_model.append(Model.init(arch, torch.Generator(
                device=dev).manual_seed(SEED), device=dev))
        with torch.inference_mode():
            return dense_reference_logits(ref_model[0], torch.tensor(
                [list(reqs[uid].prompt) + toks], device=dev)).float()

    for label, fused, _ in modes:
        lead, one = ranks[0][label], ref[label]
        # (a)
        for r, rk in enumerate(ranks[1:], 1):
            if rk[label]["tokens"] != lead["tokens"]:
                _fail(f"tp {label}: rank {r}'s streams differ from rank 0's")
        # (d), each rank
        for rk in ranks:
            _tp_expect_launches(rk[label], arch, fused, label)
        _tp_expect_launches(one, arch, fused, f"{label} tp=1")
        # (e)
        c = lead["counters"]
        want_bytes = c["steps"] * per(8) + c["prefill_chunks"] * per(64)
        if c["collective_bytes"] != want_bytes:
            _fail(f"tp {label}: collective_bytes {c['collective_bytes']}, "
                  f"JAX's formula {want_bytes}")
        # (c): a fork from tp=1 at a near-tie: greedy, tp=1's top-2 margin
        # under TP_MARGIN; sampled, both tokens' intervals near the uniform
        forks, draws = [], []
        for uid, want in one["tokens"].items():
            got = lead["tokens"][uid]
            if got == want:
                continue
            step = next(i for i, (x, y) in enumerate(zip(want, got))
                        if x != y)
            lg = ref_logits(uid, want[:step])
            sp = reqs[uid].sampling
            if sp.greedy:
                top2 = torch.topk(lg, 2).values
                margin = (top2[0] - top2[1]).item()
                forks.append({"uid": uid, "step": step, "margin": margin})
                if not margin < TP_MARGIN:
                    _fail(f"tp {label}: greedy request {uid} forks from "
                          f"tp=1 at token {step} where tp=1's top-2 margin "
                          f"is {margin} >= {TP_MARGIN}")
                continue
            u, near = _draw_window(lg, sp, len(reqs[uid].prompt) + step, dev)
            draws.append({"uid": uid, "step": step, "u": u,
                          "tokens": [want[step], got[step]], "near": near})
            if want[step] not in near or got[step] not in near:
                _fail(f"tp {label}: sampled request {uid} forks from tp=1 "
                      f"at token {step} ({want[step]} / {got[step]}), not "
                      f"both within {TP_DRAW_WINDOW} of the draw's uniform "
                      f"{u} on tp=1's CDF (tokens there: {near})")
        # a rank holds its shards only: the split leaves' bytes 1 / tp of
        # tp=1's, and its peak below tp=1's by the rest of the blocks
        w1 = one["weights"]
        cap = one["peak"] - (TP - 1) * w1["blocks"] // TP + TP_PEAK_SLACK
        for r, rk in enumerate(ranks):
            w = rk[label]["weights"]
            if w["blocks_split"] * TP + w["blocks"] - w["blocks_split"] \
                    != w1["blocks"]:
                _fail(f"tp {label}: rank {r}'s blocks {w} are not 1 / {TP} "
                      f"of tp=1's {w1['blocks']} bytes beside the "
                      "replicated leaves")
            if not rk[label]["peak"] <= cap:
                _fail(f"tp {label}: rank {r}'s peak {rk[label]['peak']} "
                      f"bytes over tp=1's {one['peak']} less "
                      f"{TP - 1}/{TP} of the blocks' {w1['blocks']}")
        row = {"wall_tp1": one["wall"], "wall_tp2": lead["wall"],
               "ttft_tp1_s": one["ttft_s"], "ttft_tp2_s": lead["ttft_s"],
               "counters": c, "tp_stats": lead["tp_stats"],
               "tp1_tp_stats": one["tp_stats"], "peak_rank0": lead["peak"],
               "peak_tp1": one["peak"], "weights_rank0": lead["weights"],
               "weights_tp1": w1, "greedy_forks": forks,
               "sampled_forks": draws,
               "streams_equal_tp1": sum(lead["tokens"][u] == w for u, w in
                                        one["tokens"].items()),
               "launches_rank0": lead["launches"]}
        if not fused:
            # (b)
            rel = _rel_l2(torch.from_numpy(lead["logits"]),
                          torch.from_numpy(one["logits"]))
            row["first_logits_rel_l2"] = rel
            if not rel <= TP_LOGIT_REL_L2:
                _fail(f"tp {label}: the first final chunk's logits rel L2 "
                      f"{rel} from tp=1's > {TP_LOGIT_REL_L2}")
        out["modes"][label] = row
        st = lead["tp_stats"]
        shown = [{k: d[k] for k in ("uid", "step", "u", "tokens")}
                 for d in draws]
        print(f"[tp] {label}: tp=2 ({backend}) {lead['wall']:.3f} s against "
              f"tp=1 {one['wall']:.3f} s (TTFT {lead['ttft_s'] * 1e3:.1f} / "
              f"{one['ttft_s'] * 1e3:.1f} ms); streams equal tp=1's "
              f"{row['streams_equal_tp1']} of {len(one['tokens'])}, greedy "
              f"forks {forks}, sampled forks {shown} (each within "
              f"{TP_DRAW_WINDOW} of u); every rank's streams "
              f"bitwise rank 0's; weights a rank {lead['weights']['all']} B "
              f"against tp=1's {w1['all']}, peak over the rank's baseline "
              f"{lead['peak']} against tp=1's {one['peak']} (cap {cap}); "
              f"launches exact a rank (decode "
              f"{_nonzero(lead['launches']['decode'])}); collective_bytes {c['collective_bytes']} = JAX's formula;"
              f" tp_stats {st}; KV bytes a rank "
              f"{st['per_device']['kv_bytes']} against tp=1's "
              f"{one['tp_stats']['per_device']['kv_bytes']}"
              + (f"; first final chunk's logits rel L2 "
                 f"{row['first_logits_rel_l2']:.3e}" if not fused else "")
              + f"; {smi}")
    del ref_model
    gc.collect()
    torch.cuda.empty_cache()
    out["row_parallel"] = row_parallel_products(arch, dev)
    print(f"[tp] phase: tp=1 reference {out['tp1_s']:.1f} s, tp=2 ranks "
          f"(spawn, init and serves) {out['tp2_s']:.1f} s")
    return out


# ----------------------------------------------------------- phase 8c ---
# Data-parallel ZeRO-1 training: bert-large at full width, B8 S128, the
# fused configuration (REPRO_FUSED_BLOCKS=1, the LAMB kernels, fp32 master
# weights), dp=1 in this process, then dp=2 ranks.
DP, DP_STEPS = 2, 4
DP1_STEPS = 8        # dp=1's runs: seven steps to time after the first
# dp=2's step-1 update of the fp32 master weights against dp=1's own, a
# flat leaf at a time: ||du_2 - du_1|| / ||du_1||. The ranks run their
# rows' forward and backward at B4, one device at B8, and the bf16 backward
# is not batch-invariant (other GEMM shapes round other partial sums), so
# the two whole-batch gradients differ by far more than one rounding where
# a sum cancels; LAMB's first step is about lr r sign(g), and each flipped
# sign moves an element by 2 lr r. The limit sits between two readings on
# the H100 (PERF.md): dp=1's computation of the split step (the ranks'
# shapes in one process) reaches 0.0828 at its worst leaf, and a control
# step with rank 1's gradients dropped no less than 0.2765 at its best.
UPDATE_REL_L2 = 0.15


def _dp_train(mesh, rank, device, spec):
    """One rank's (``mesh`` None: one device's) run of the dp phase:
    bert-large (or ``spec["arch"]``) from the seeded fp32 init, LAMB at
    1e-3, ``spec["steps"]`` steps through ``bundle.eager`` (``graphed``:
    ``bundle.fn``), each ended by reading its loss. A step's LAMB launches,
    collectives by kind and bytes, host time and a digest of the bf16
    params are kept; step 1's params are saved to ``spec["save"]`` and held
    against each file of ``spec["refs"]`` (the largest gap over the leaves
    in bf16 ulps of the leaf's largest |value|, and that leaf); the
    optimizer's m / v / master bytes and the peak memory above the
    state's."""
    import faulthandler
    from repro_torch import tree
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.kernels.fused_lamb import ops as lamb_ops
    from repro_torch.models.model import init_params
    from repro_torch.optim import zero
    from repro_torch.parallel import collectives
    from repro_torch.train.steps import build_train_step, zero_collectives
    faulthandler.dump_traceback_later(240)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["REPRO_FUSED_BLOCKS"] = "1"
    dev = torch.device(device)
    arch = get_config(spec.get("arch", "bert-large"))
    run = RunConfig(arch=arch, shape=ShapeConfig(
        "dp", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, kind="train"),
        optimizer="lamb", learning_rate=1e-3, zero1=spec["zero1"],
        fused_optimizer_kernel=True, master_weights=True)
    bundle = build_train_step(run, dev, mesh=mesh)
    state = bundle.init(params=init_params(
        arch, torch.Generator(device=dev).manual_seed(SEED), dev,
        torch.float32))
    gc.collect()
    torch.cuda.empty_cache()
    data = SyntheticPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, objective="mlm" if arch.bidirectional
        else "causal", seed=SEED))
    step_fn = bundle.fn if spec.get("graphed") else bundle.eager
    opt_bytes = {k: sum(t.numel() * t.element_size()
                        for t in tree.leaves(state["opt"][k]))
                 for k in ("m", "v", "master")}
    master0 = ([t.cpu() for t in tree.leaves(state["opt"]["master"])]
               if spec.get("update") else None)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = {"losses": [], "grad_norms": [], "step_s": [], "lamb": [],
           "collectives": [], "digests": [], "opt_bytes": opt_bytes,
           "rank": rank, "backend": None if mesh is None else
           torch.distributed.get_backend(), "gaps": {}}
    kinds = ("all_reduce", "reduce_scatter", "all_gather",
             "reduce_scatter_bytes", "all_gather_bytes", "all_reduce_bytes")
    for i in range(spec["steps"]):
        lamb0 = dict(lamb_ops.LAUNCHES)
        coll0 = {k: collectives.COUNTS[k] for k in kinds}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, met = step_fn(state, data.batch(i))
        out["losses"].append(float(met["loss"]))
        out["step_s"].append(time.perf_counter() - t0)
        out["grad_norms"].append(float(met["grad_norm"]))
        out["lamb"].append({k: lamb_ops.LAUNCHES[k] - lamb0[k]
                            for k in lamb0})
        out["collectives"].append({k: collectives.COUNTS[k] - coll0[k]
                                   for k in kinds})
        params = tree.leaves(state["params"])
        out["digests"].append(_state_digest(params))
        if i == 0 and spec.get("save"):
            torch.save([p.detach().cpu() for p in params], spec["save"])
        for name, path in (spec.get("refs", {}).items() if i == 0 else ()):
            ref = torch.load(path)
            gaps = [_ulp_gap(a, b.to(dev)) for a, b in zip(params, ref)]
            worst = int(np.argmax(gaps))
            path = list(zero.leaf_paths(state["params"]))[worst][0]
            out["gaps"][name] = {"bf16_ulps": gaps[worst],
                                 "leaf": "/".join(map(str, path))}
            del ref
        if i == 0 and master0 is not None:
            out["update_sq"] = _update_sq(
                bundle.plan, master0, state["opt"]["master"], spec, dev)
            del master0
            if spec["update"].get("m_path"):     # phase 8d's reference
                torch.save([t.cpu() for t in tree.leaves(state["opt"]["m"])],
                           spec["update"]["m_path"])
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["peak_above_state"] = out["peak"] - base
    out["n_params"] = sum(p.numel() for p in tree.leaves(state["params"]))
    plan = bundle.plan
    out["flat_elements"] = plan.flat_elements if plan else None
    out["flat_paths"] = [u.path for u in plan.units] if plan else None
    out["leaf_paths"] = [p for p, _ in zero.leaf_paths(state["params"])]
    out["shards"] = ([[u.rows, u.padded // plan.dp] for u in plan.units]
                     if plan else None)
    out["stated"] = zero_collectives(run, plan.dp) if plan else None
    out["graph"] = ({"captures": bundle.fn.captures,
                     "replays": bundle.fn.replays}
                    if spec.get("graphed") else None)
    faulthandler.cancel_dump_traceback_later()
    del state, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _update_sq(plan, master0, master, spec, dev) -> list:
    """Step 1's update of this rank's fp32 master shards (``master`` less
    ``master0``): saved whole to ``spec["update"]["path"]`` with
    ``"save"`` (one device), else held against this rank's columns of the
    one saved there: for every flat leaf (sum of the difference's squares,
    sum of the saved update's squares). ``master0`` and the saved update
    stay on the host and come to the card a leaf at a time, so the peak
    memory read after the steps is the step's own."""
    from repro_torch import tree
    from repro_torch.optim import zero
    save = spec["update"]["save"]
    ref = [None] * len(master0) if save else torch.load(
        spec["update"]["path"])
    out = []
    for u, a, b, r in zip(plan.units, tree.leaves(master), master0, ref):
        d = a - b.to(dev)
        if save:
            out.append(d.cpu())
            continue
        lo, hi = zero.shard_range(u.padded, plan.rank, plan.dp)
        r = r[:, lo:hi].to(dev)
        out.append((float(torch.sum(torch.square(d - r))),
                    float(torch.sum(torch.square(r)))))
    if save:
        torch.save(out, spec["update"]["path"])
        return []
    return out


def _dp_split_step1(dev, paths):
    """dp=DP's step 1 computed in one process (dp=1's state): each rank's
    rows' bf16 gradients (the masked mean over the whole batch's count,
    the forward and backward at the ranks' B / DP rows) flattened and
    summed in fp32 in rank order (the reduce-scatter's sum of DP terms),
    the clip over the flat leaves and the LAMB kernels on the whole
    flat leaves, then the cast; step 1's params saved to
    ``paths["split"]``. Returned, against dp=1's own step (its master
    update saved at ``paths["update"]``): each flat leaf's master update
    rel-L2 for this split step and, as the control that the limit
    catches a fault, for a step whose reduce dropped rank 1's
    gradients; and each parameter leaf's gradient rel-L2, the ranks' sum
    against the whole batch's at B rows."""
    from repro_torch import tree
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.models.model import init_params
    from repro_torch.optim import grad as grad_lib
    from repro_torch.optim import make_optimizer
    from repro_torch.train.steps import build_train_step
    os.environ["REPRO_FUSED_BLOCKS"] = "1"
    arch = get_config("bert-large")
    run = RunConfig(arch=arch, shape=ShapeConfig(
        "dp", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, kind="train"),
        optimizer="lamb", learning_rate=1e-3, zero1=True,
        fused_optimizer_kernel=True, master_weights=True)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in SyntheticPipeline(
        DataConfig(vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH, objective="mlm",
                   seed=SEED)).batch(0).items()}
    denom = torch.clamp_min(batch["loss_mask"].float().sum(), 1.0)
    rows = TRAIN_BATCH // DP
    ref = [r.to(dev) for r in torch.load(paths["update"])]

    def step(ranks):
        """Step 1 from the seeded init with the gradients of ``ranks``'
        rows summed in the flat layout -> (its params, each flat leaf's
        master update rel-L2 against dp=1's, each parameter leaf's
        gradient rel-L2, all ranks' sum against the whole batch's)."""
        bundle = build_train_step(run, dev)
        state = bundle.init(params=init_params(
            arch, torch.Generator(device=dev).manual_seed(SEED), dev,
            torch.float32))
        plan, params = bundle.plan, state["params"]
        leaves = tree.leaves(params)
        master0 = [t.clone() for t in tree.leaves(state["opt"]["master"])]
        acc = plan.accumulator(dev)
        summed = None
        for r in range(DP):
            mb = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            loss, _ = model_lib.loss(arch, params, mb, None, denom)
            g = torch.autograd.grad(loss, leaves)
            summed = ([x.float() for x in g] if summed is None else
                      [s_ + x.float() for s_, x in zip(summed, g)])
            if r in ranks:
                plan.accumulate_(acc, g)
        loss, _ = model_lib.loss(arch, params, batch, None, denom)
        whole = torch.autograd.grad(loss, leaves)
        grad_rel = [_rel_l2(a, b) for a, b in zip(summed, whole)]
        del summed, whole
        grads, _ = grad_lib.clip_by_global_norm(plan.views(acc),
                                                run.grad_clip)
        make_optimizer(run).update(grads, state["opt"], params, plan)
        upd = [_rel_l2(m - m0, r) for m, m0, r in zip(
            tree.leaves(state["opt"]["master"]), master0, ref)]
        return [p.detach() for p in leaves], upd, grad_rel

    params, split, grad_rel = step(range(DP))
    torch.save([p.cpu() for p in params], paths["split"])
    del params
    _, dropped, _ = step((0,))
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"split": split, "dropped_rank": dropped, "grad": grad_rel}


def _dp_nccl(mesh, rank, device, specs):
    """A nccl rank (a card of its own): each spec of ``specs`` in turn."""
    return [_dp_train(mesh, rank, device, sp) for sp in specs]


def dp_phase(dev, smi):
    """Phase 8c: data-parallel ZeRO-1 training, bert-large B8 S128 fused.
    (a) dp=1 zero1=True against zero1=False from the same weights and
    batches: the step-1 loss bitwise, every updated bf16 param leaf within
    STEP1_PARAM_ULPS of its largest |value| (the norms' partials summed in
    another order). (b) dp=2, two gloo ranks sharing the card, 4 rows a
    rank, DP_STEPS eager steps: the ranks' params bitwise equal after
    every step (digests), the step-1 loss within STEP1_LOSS_ULPS of
    dp=1's, the step-1 params within STEP1_PARAM_ULPS of dp=1's
    computation of the same split step (``_dp_split_step1``: the ranks'
    bf16 gradients summed in fp32), the step-1 master update within
    UPDATE_REL_L2 of dp=1's own a flat leaf (rel-L2; the split step's
    readings printed, and a control step with rank 1's gradients dropped
    beyond the limit), the losses finite and falling. (c)
    a rank's m, v and master bytes exactly 1/dp of dp=1's;
    its peak printed beside dp=1's. (d) LAMB launches a rank a step equal
    dp=1's; the collectives a step by kind equal ``zero_collectives``. (e)
    the bytes reduce-scattered and all-gathered a rank a step equal
    (dp - 1)/dp (4 + 2) N_flat (N_flat: the flat layout's elements, the
    parameters and their padding), beside ``core.distmodel``'s replicated
    all-reduce of the paper. (f) the step times (dp=2's bound by gloo's
    host round trips: not a speed figure); with two or more cards, nccl
    with a card a rank, the step captured (``bundle.fn``), and
    llama3.2-3b at full width."""
    from repro_torch.configs import get_config
    from repro_torch.core import distmodel
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = os.path.join(here, "build", "dp_phase")
    os.makedirs(tmp, exist_ok=True)
    paths = {n: os.path.join(tmp, f"{n}.pt")
             for n in ("replicated", "dp1", "split", "update", "m")}
    rep = _dp_train(None, 0, dev, {"zero1": False, "steps": DP1_STEPS,
                                   "save": paths["replicated"]})
    one = _dp_train(None, 0, dev, {"zero1": True, "steps": DP1_STEPS,
                                   "save": paths["dp1"],
                                   "refs": {"replicated":
                                            paths["replicated"]},
                                   "update": {"path": paths["update"],
                                              "save": True,
                                              "m_path": paths["m"]}})
    split = _dp_split_step1(dev, paths)

    def spread(rel, paths_):
        i = int(np.argmax(rel))
        return (f"max {rel[i]:.4g} ({'/'.join(map(str, paths_[i]))}), "
                f"median {float(np.median(rel)):.4g}")
    print(f"[dp] against dp=1's own step, a flat leaf at a time: dp=1's "
          f"computation of the dp={DP} split step, master update rel-L2 "
          f"{spread(split['split'], one['flat_paths'])}, its gradient sum "
          f"against the whole batch's, rel-L2 a parameter leaf "
          f"{spread(split['grad'], one['leaf_paths'])}; control, the step "
          f"with rank 1's gradients dropped, update rel-L2 min "
          f"{min(split['dropped_rank']):.4g}, median "
          f"{float(np.median(split['dropped_rank'])):.4g} (limit "
          f"{UPDATE_REL_L2}); {smi}", flush=True)
    t1 = time.perf_counter()
    ranks = mesh_lib.spawn(_dp_train, DP, {
        "zero1": True, "steps": DP_STEPS,
        "refs": {"split": paths["split"], "dp1": paths["dp1"]},
        "update": {"path": paths["update"], "save": False}},
        backend="gloo", device=str(dev), mesh=((DP,), ("data",)),
        timeout=600)
    t2 = time.perf_counter()
    arch = get_config("bert-large")
    loss_ulp = _bf16_ulp(torch.tensor(one["losses"][0])).item()
    # (a)
    if one["losses"][0] != rep["losses"][0]:
        _fail(f"dp=1 zero1 step-1 loss {one['losses'][0]!r} is not the "
              f"replicated step's {rep['losses'][0]!r}")
    gap_a = one["gaps"]["replicated"]["bf16_ulps"]
    if not gap_a <= STEP1_PARAM_ULPS:
        _fail(f"dp=1 zero1 step-1 params {gap_a} bf16 ulps from the "
              f"replicated step's (tol {STEP1_PARAM_ULPS})")
    # (b)
    lead = ranks[0]
    for r in ranks[1:]:
        if r["digests"] != lead["digests"] or r["losses"] != lead["losses"]:
            _fail(f"dp={DP}: rank {r['rank']}'s params or losses differ "
                  "from rank 0's")
    loss_gap = abs(lead["losses"][0] - one["losses"][0]) / loss_ulp
    gap_b = max(r["gaps"]["split"]["bf16_ulps"] for r in ranks)
    if not (loss_gap <= STEP1_LOSS_ULPS and gap_b <= STEP1_PARAM_ULPS):
        _fail(f"dp={DP} step 1: loss {loss_gap} bf16 ulps from dp=1's (tol "
              f"{STEP1_LOSS_ULPS}), params {gap_b} bf16 ulps from dp=1's "
              f"computation of the ranks' split step (tol "
              f"{STEP1_PARAM_ULPS})")
    # a flat leaf's rel-L2 over the ranks' columns, as _rel_l2 of the whole
    direct = [math.sqrt(sum(n for n, _ in sq)
                        / max(sum(d for _, d in sq), 1e-60))
              for sq in zip(*(r["update_sq"] for r in ranks))]
    worst = int(np.argmax(direct))
    if not direct[worst] <= UPDATE_REL_L2:
        _fail(f"dp={DP} step 1: the master update's rel-L2 to dp=1's own "
              f"step {direct[worst]} at "
              f"{'/'.join(map(str, one['flat_paths'][worst]))} (limit "
              f"{UPDATE_REL_L2}); {spread(direct, one['flat_paths'])}")
    control = min(split["dropped_rank"])
    if not control > UPDATE_REL_L2:
        _fail(f"the control step without rank 1's gradients lands within "
              f"the limit {UPDATE_REL_L2} of dp=1's at a flat leaf (update "
              f"rel-L2 {control}): the gate would not see a dropped reduce "
              "there")
    losses = lead["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        _fail(f"dp={DP} losses {losses}: not finite and falling")
    # (c)
    for r in ranks:
        for k, b in r["opt_bytes"].items():
            if b * DP != one["opt_bytes"][k]:
                _fail(f"rank {r['rank']}'s {k} holds {b} bytes, dp=1's "
                      f"{one['opt_bytes'][k]}: not 1/{DP}")
    # (d)
    for r in ranks:
        for i, (lamb, coll) in enumerate(zip(r["lamb"], r["collectives"])):
            if lamb != one["lamb"][i]:
                _fail(f"rank {r['rank']} step {i + 1}: LAMB launches {lamb}, "
                      f"dp=1's {one['lamb'][i]}")
            got = {k: coll[k] for k in r["stated"]}
            if got != r["stated"]:
                _fail(f"rank {r['rank']} step {i + 1}: collectives {got}, "
                      f"stated {r['stated']}")
    # (e)
    n_flat = lead["flat_elements"]
    want_rs = (DP - 1) * 4 * n_flat // DP
    want_ag = (DP - 1) * 2 * n_flat // DP
    for r in ranks:
        for c in r["collectives"]:
            if (c["reduce_scatter_bytes"], c["all_gather_bytes"]) != \
                    (want_rs, want_ag):
                _fail(f"rank {r['rank']}: {c['reduce_scatter_bytes']} bytes "
                      f"reduce-scattered and {c['all_gather_bytes']} "
                      f"all-gathered a step, (dp-1)/dp (4 + 2) N_flat gives "
                      f"{want_rs} and {want_ag}")
    model = distmodel.data_parallel(arch, TRAIN_BATCH // DP, TRAIN_SEQ, DP,
                                    overlap=False)
    ring = 2 * (DP - 1) / DP * model.comm_bytes
    n = lead["n_params"]
    step_one = float(np.median(one["step_s"][1:]))
    step_two = float(np.median(lead["step_s"][1:]))
    cards = torch.cuda.device_count()
    print(f"[dp] bert-large B{TRAIN_BATCH} S{TRAIN_SEQ} fused, LAMB kernels, "
          f"fp32 master; {n} parameters, {n_flat} flat elements (padding "
          f"{n_flat - n}, {(n_flat - n) / n:.2e} of them); (a) dp=1 zero1 "
          f"vs replicated: step-1 loss {one['losses'][0]!r} bitwise, params "
          f"within {gap_a:.3f} bf16 ulps (tol {STEP1_PARAM_ULPS}); (b) "
          f"dp={DP} over gloo, two ranks on one card, {DP_STEPS} eager steps: "
          f"ranks bitwise equal every step, losses "
          f"{[round(x, 5) for x in losses]} against dp=1's "
          f"{[round(x, 5) for x in one['losses'][:DP_STEPS]]}, step-1 loss "
          f"{loss_gap:.3f} bf16 ulps from dp=1's; step-1 params "
          f"{gap_b:.3f} bf16 ulps from dp=1's computation of the ranks' "
          f"split step (tol {STEP1_PARAM_ULPS}) and "
          f"{max(r['gaps']['dp1']['bf16_ulps'] for r in ranks):.3f} from "
          f"dp=1's own step; against dp=1's own step the master update "
          f"rel-L2 a flat leaf {spread(direct, one['flat_paths'])} (limit "
          f"{UPDATE_REL_L2}; the ranks' rows run at B{TRAIN_BATCH // DP}, "
          f"whose bf16 backward rounds other partial sums than B"
          f"{TRAIN_BATCH}'s, and LAMB's first step is about lr r sign(g)); "
          f"{smi}")
    print(f"[dp] (c) optimizer bytes a rank {lead['opt_bytes']} = 1/{DP} of "
          f"dp=1's {one['opt_bytes']}; peak memory rank 0 "
          f"{lead['peak'] / 2**30:.3f} GiB ({lead['peak_above_state'] / 2**30:.3f}"
          f" above its state) against dp=1's {one['peak'] / 2**30:.3f} GiB "
          f"({one['peak_above_state'] / 2**30:.3f}); (d) LAMB launches a "
          f"step {lead['lamb'][0]} = dp=1's; collectives a step "
          f"{ {k: lead['collectives'][0][k] for k in lead['stated']} } = "
          f"stated {lead['stated']}; (e) a rank a step reduce-scatters "
          f"{want_rs} B and all-gathers {want_ag} B = (dp-1)/dp (4 + 2) "
          f"N_flat = {(DP - 1) * 6 * n_flat // DP} B, against the paper's "
          f"replicated gradient all-reduce (core.distmodel.data_parallel "
          f"comm_bytes {model.comm_bytes:.0f} B x ring 2(dp-1)/dp) "
          f"{ring:.0f} B; {smi}")
    step_rep = float(np.median(rep["step_s"][1:]))
    print(f"[dp] (f) step time (host, each step ended by reading its "
          f"loss; medians of steps 2-{DP1_STEPS} at dp=1, 2-{DP_STEPS} at "
          f"dp={DP}): dp=1 replicated (zero1=False) {step_rep * 1e3:.1f} "
          f"ms, dp=1 zero1 {step_one * 1e3:.1f} ms (steps "
          f"{[round(t * 1e3, 1) for t in rep['step_s']]} and "
          f"{[round(t * 1e3, 1) for t in one['step_s']]}), "
          f"dp={DP} over gloo {step_two * 1e3:.1f} ms: bound by gloo's host "
          f"round trips (every collective copies through host memory), not "
          f"a speed figure; {smi}")
    out = {"card": smi, "cards": cards, "backend": "gloo",
           "n_params": n, "flat_elements": n_flat,
           "dp1_replicated": {k: rep[k] for k in ("losses", "grad_norms",
                                                  "step_s")},
           "split_vs_dp1_update_rel_l2": split["split"],
           "dropped_rank_vs_dp1_update_rel_l2": split["dropped_rank"],
           "split_vs_dp1_grad_rel_l2": split["grad"],
           "dp2_vs_dp1_update_rel_l2": direct,
           "flat_paths": ["/".join(map(str, p)) for p in one["flat_paths"]],
           "dp1": {k: one[k] for k in (
               "losses", "grad_norms", "step_s", "opt_bytes", "peak",
               "peak_above_state", "lamb", "gaps")},
           "dp2": {k: lead[k] for k in (
               "losses", "grad_norms", "step_s", "opt_bytes", "peak",
               "peak_above_state", "lamb", "collectives", "stated", "gaps",
               "shards")},
           "dp2_rank_peaks": [r["peak"] for r in ranks],
           "bytes_a_step": {"reduce_scatter": want_rs, "all_gather": want_ag,
                            "distmodel_allreduce_ring": ring},
           "step_ms": {"dp1_replicated": step_rep * 1e3,
                       "dp1": step_one * 1e3, "dp2_gloo": step_two * 1e3},
           "dp1_s": t1 - t0, "dp2_s": t2 - t1}
    if cards >= DP:
        t3 = time.perf_counter()
        nccl = mesh_lib.spawn(
            _dp_nccl, DP, [{"zero1": True, "steps": DP_STEPS,
                            "graphed": True},
                           {"zero1": True, "steps": 2, "graphed": True,
                            "arch": "llama3.2-3b"}],
            backend="nccl", mesh=((DP,), ("data",)), timeout=900)
        for name, i in (("bert-large", 0), ("llama3.2-3b", 1)):
            a = nccl[0][i]
            if any(r[i]["digests"] != a["digests"] for r in nccl[1:]) or \
                    not all(math.isfinite(x) for x in a["losses"]):
                _fail(f"dp={DP} over nccl, {name}: ranks differ or a loss "
                      f"is not finite ({a['losses']})")
        b = nccl[0][0]
        gap = abs(b["losses"][0] - lead["losses"][0]) / loss_ulp
        if not gap <= STEP1_LOSS_ULPS:
            _fail(f"dp={DP} over nccl: step-1 loss {gap} bf16 ulps from "
                  "gloo's")
        out["nccl"] = {name: {k: nccl[0][i][k] for k in (
            "losses", "step_s", "peak", "graph", "opt_bytes")}
            for name, i in (("bert-large", 0), ("llama3.2-3b", 1))}
        print(f"[dp] nccl, a card a rank, the step captured: bert-large "
              f"losses {b['losses']} (graph {b['graph']}), step "
              f"{np.median(b['step_s'][2:]) * 1e3:.1f} ms; llama3.2-3b "
              f"losses {nccl[0][1]['losses']}; {time.perf_counter() - t3:.1f}"
              " s")
    else:
        print(f"[dp] {cards} card: nccl with a card a rank, its captured "
              f"step and llama3.2-3b at dp={DP} were not run (they need "
              f"{DP} cards; llama's training state alone is about 42 GiB at "
              f"dp=1)")
        out["nccl"] = "not run: one card"
    for name, path in paths.items():
        if name not in ("update", "m"):     # phase 8d reads these two
            os.remove(path)
    out["update_path"], out["m_path"] = paths["update"], paths["m"]
    out["phase_s"] = time.perf_counter() - t0
    print(f"[dp] phase {out['phase_s']:.1f} s (dp=1 runs {t1 - t0:.1f} s, "
          f"dp={DP} spawn and steps {t2 - t1:.1f} s)")
    return out


# ----------------------------------------------------------- phase 8d ---
# Training on a (data, model) mesh: bert-large at full width and depth, B8
# S128, fused blocks and the LAMB kernels, fp32 master, make_rules()'s
# defaults (tensor, sequence and expert parallelism, FSDP), gloo ranks
# sharing the card; deepseek-moe-16b at full width with 2 of its layers.
MP_STEPS, MP4_STEPS, MP_MOE_STEPS, MP_MOE_LAYERS = 3, 2, 2, 2
# the (1, 2) step-1 update of the fp32 master weights against dp=1's own
# step (phase 8c), a parameter leaf at a time: ||du_tp - du_1|| / ||du_1||.
# Predicted in PERF.md before the first reading; the control step (model
# rank 1's partial sums dropped at every exit of the tensor-parallel
# region) must land beyond it at every leaf.
TP_UPDATE_REL_L2 = 0.15
# LAMB's step 1 is about lr r sign(g), so that gate reads sign flips of
# cancelling sums and is loose for most leaves. Three tighter gates, each
# predicted in PERF.md before its first reading: the median leaf's update
# rel-L2 (the control's median reads 1.408); step 1's m, which is
# (1 - beta1) g / ||g||, the gradient itself, rel-L2 a leaf; and the norm
# of each update whose trust ratio comes from norms (w != 0), which a
# right ratio makes lr ||w|| exactly, so a ratio off by 1e-3 shows.
TP_UPDATE_MEDIAN_REL_L2 = 0.05
TP_MOMENT_REL_L2 = 0.05
TP_UPDATE_NORM_REL = 1e-3
# the planted fault: this leaf's gradient left as model rank r's partial
# sum (its model-axis sum dropped); it must fail a gate at that leaf
MP_PLANTED_LEAF = "blocks/0/attn/bo"


def _mp_train(mesh, rank, device, specs):
    """One rank's runs of phase 8d, ``specs`` in turn (a list: each a
    dict with ``arch``, ``layers`` (None: all), ``steps``, ``rules``
    (``make_rules`` keywords), ``ref`` (the files of dp=1's param-shaped
    step-1 master update and ``m``, or None), ``control`` (model rank 1's
    partial sums dropped at every ``Parallel.exit``) and ``plant`` (a
    leaf whose gradient keeps the rank's partial sum: its model-axis sum
    dropped)). Each from the seeded fp32 init, LAMB at 1e-3, eager steps
    each ended by reading its loss; kept a step: the loss, grad norm,
    launches of the training kernels, the collectives by kind and their
    ring bytes, the host time and a digest of each bf16 param block; the
    rank's bytes (params, m, v, master, the experts' params), its peak
    memory, and against ``ref`` each leaf's sums on this rank's block
    (``_mp_update_sums``)."""
    import faulthandler
    from repro_torch import tree
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.kernels.bias_gelu import ops as bg_ops
    from repro_torch.kernels.fused_lamb import ops as lamb_ops
    from repro_torch.kernels.fused_layernorm import ops as ln_ops
    from repro_torch.models.model import init_params
    from repro_torch.parallel import collectives, sharding
    from repro_torch.train.steps import build_train_step, zero_collectives
    faulthandler.dump_traceback_later(300)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["REPRO_FUSED_BLOCKS"] = "1"
    dev = torch.device(device)
    outs = []
    kinds = ("all_reduce", "reduce_scatter", "all_gather",
             "all_reduce_bytes", "reduce_scatter_bytes", "all_gather_bytes")
    counters = (ln_ops.LAUNCHES, bg_ops.LAUNCHES, lamb_ops.LAUNCHES)
    for spec in specs:
        arch = get_config(spec["arch"])
        if spec["layers"]:
            arch = dataclasses.replace(arch, num_layers=spec["layers"])
        run = RunConfig(arch=arch, shape=ShapeConfig(
            "mp", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, kind="train"),
            optimizer="lamb", learning_rate=1e-3, zero1=True,
            fused_optimizer_kernel=True, master_weights=True)
        bundle = build_train_step(run, dev, mesh=mesh,
                                  rules=sharding.make_rules(**spec["rules"]))
        state = bundle.init(params=init_params(
            arch, torch.Generator(device=dev).manual_seed(SEED), dev,
            torch.float32))
        gc.collect()
        torch.cuda.empty_cache()
        plan, ax = bundle.plan, bundle.mesh
        data = SyntheticPipeline(DataConfig(
            vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, objective="mlm" if arch.bidirectional
            else "causal", seed=SEED))

        def nbytes(t):
            return sum(x.numel() * x.element_size() for x in tree.leaves(t))
        out = {"arch": arch.name, "layers": arch.num_layers,
               "rules": spec["rules"], "coords": ax.coords,
               "sizes": ax.sizes, "specs": bundle.specs,
               "control": spec.get("control", False),
               "bytes": {"params": nbytes(state["params"]),
                         **{k: nbytes(state["opt"][k])
                            for k in ("m", "v", "master")},
                         "experts": sum(
                             t.numel() * t.element_size()
                             for path, t in sharding.leaf_items(
                                 state["params"]) if "experts" in path)},
               "stated": zero_collectives(run, ax.dp, ax.tp, ax.rules,
                                          bundle.specs),
               "losses": [], "grad_norms": [], "step_s": [], "launches": [],
               "collectives": [], "digests": []}
        master0 = plan.blocks(state["opt"]["master"], state["params"]) \
            if spec.get("ref") else None
        if spec.get("plant"):
            paths = ["/".join(p) for p, _ in
                     sharding.leaf_items(bundle.specs)]
            bundle.partial.remove(paths.index(spec["plant"]))
        restore = None
        if spec.get("control"):
            restore = collectives.Parallel.exit

            def dropped(self, y, _exit=restore):
                return _exit(self, y * 0 if self.mrank == 1 else y)
            collectives.Parallel.exit = dropped
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(spec["steps"]):
            before = [dict(c) for c in counters]
            coll0 = {k: collectives.COUNTS[k] for k in kinds}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, met = bundle.eager(state, data.batch(i))
            out["losses"].append(float(met["loss"]))
            out["step_s"].append(time.perf_counter() - t0)
            out["grad_norms"].append(float(met["grad_norm"]))
            out["launches"].append({k: c[k] - b[k] for c, b in
                                    zip(counters, before) for k in c})
            out["collectives"].append({k: collectives.COUNTS[k] - coll0[k]
                                       for k in kinds})
            out["digests"].append(_state_digest(state["params"]))
            if i == 0 and master0 is not None:
                out["update_sq"] = _mp_update_sums(
                    bundle, state, master0, spec["ref"], arch, dev)
                master0 = None
        if restore is not None:
            collectives.Parallel.exit = restore
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        out["units"] = [[u.rows, plan.cols(i)]
                        for i, u in enumerate(plan.units)]
        outs.append(out)
        del state, bundle, plan
        gc.collect()
        torch.cuda.empty_cache()
    faulthandler.cancel_dump_traceback_later()
    return outs


def _mp_update_sums(bundle, state, master0, ref, arch, dev) -> list:
    """Step 1 against dp=1's on this rank's block of every leaf, each a
    dict of sums: ``sq`` / ``ref_sq`` / ``own_sq``, the squares of the
    master update's difference, of dp=1's update and of this one;
    ``w_sq``, the squares of the weights before the step; ``flips``, the
    elements whose update has the other sign than dp=1's, ``flip_sq``
    their share of ``sq`` and ``flip_m``, the sum of their dp=1 |m|;
    ``m_sq`` / ``m_ref_sq``, the squares of step 1's ``m`` difference and
    of dp=1's ``m``; ``n``, the elements."""
    from repro_torch import tree
    from repro_torch.parallel import sharding
    plan, ax = bundle.plan, bundle.mesh
    upd = tree.leaves(plan.blocks(state["opt"]["master"], state["params"]))
    mom = tree.leaves(plan.blocks(state["opt"]["m"], state["params"]))
    refs = [torch.load(ref[k]) for k in ("update", "m")]
    out = []
    for (path, sp), a, b, m, r, rm in zip(
            sharding.leaf_items(bundle.specs), upd, tree.leaves(master0),
            mom, *refs):
        idx = sharding.train_block_index(path, r.shape, sp, arch, ax.sizes,
                                         ax.coords)
        r, rm = r[idx].to(dev), rm[idx].to(dev)
        d = a - b
        flip = d * r < 0
        gap = torch.square(d - r)
        out.append({k: float(v) for k, v in {
            "sq": gap.sum(), "ref_sq": torch.square(r).sum(),
            "own_sq": torch.square(d).sum(),
            "w_sq": torch.square(b).sum(), "flips": flip.sum(),
            "flip_sq": gap[flip].sum(), "flip_m": rm.abs()[flip].sum(),
            "m_sq": torch.square(m - rm).sum(),
            "m_ref_sq": torch.square(rm).sum(), "n": r.numel()}.items()})
    return out


def _mp_leaf_readings(held) -> dict:
    """A leaf's step-1 readings from the sums of the ranks holding its
    distinct blocks: the update rel-L2, the m rel-L2, the update norm's
    ratio to dp=1's (None where the weights are 0: the ratio is then 1 by
    definition), the share of elements whose update sign flips, those
    flips' share of the squared gap, and their mean dp=1 |m| over the
    leaf's RMS |m| (and the flips and elements themselves)."""
    tot = {k: sum(r[k] for r in held) for k in held[0]}
    return {
        "update": math.sqrt(tot["sq"] / max(tot["ref_sq"], 1e-60)),
        "m": math.sqrt(tot["m_sq"] / max(tot["m_ref_sq"], 1e-60)),
        "norm": (math.sqrt(tot["own_sq"] / max(tot["ref_sq"], 1e-60))
                 if tot["w_sq"] > 0 else None),
        "flips": tot["flips"], "n": tot["n"],
        "flip_share": tot["flips"] / tot["n"],
        "flip_gap_share": tot["flip_sq"] / max(tot["sq"], 1e-60),
        "flip_m_over_rms": (tot["flip_m"] / max(tot["flips"], 1)
                            / max(math.sqrt(tot["m_ref_sq"] / tot["n"]),
                                  1e-60))}


def _distinct(ranks, j, axes_of):
    """The ranks holding distinct blocks of leaf ``j`` (one a block)."""
    seen, out = set(), []
    for r in ranks:
        key = tuple(r["coords"][a] for a in axes_of)
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


def _leaf_axes(sp) -> list:
    from repro_torch.parallel import sharding
    return sorted({a for e in sp for a in sharding._axes(e)})


def _mp_kernel_checks(dev) -> dict:
    """Rows 4 and 6-9 at their shapes on the TP path, each held once
    against its plain version with phase 3's tolerances: the add +
    layernorm on a rank's [B S / tp, 1024] rows at tp 2 (and at the (2, 2)
    mesh's [B S / (dp tp), 1024]), bias + GeLU on [B S / dp, 4096 / tp]
    for both meshes, deepseek's add + RMSNorm (row 4) on a (1, 2) rank's
    [B S / tp, 2048] rows, the LAMB stages on a rank's shards (the (2, 2)
    mesh's FSDP slice of the embedding, a norm's ZeRO columns, and
    deepseek's 32 experts of a (1, 2) rank); event and device times
    beside the byte bounds (the profiler's window may fail: then null)."""
    from repro_torch.kernels.bias_gelu import ops as bg, ref as bg_ref
    from repro_torch.kernels.fused_layernorm import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    d, out = 1024, {}
    for rows in (TRAIN_BATCH * TRAIN_SEQ // 2, TRAIN_BATCH * TRAIN_SEQ // 4):
        x = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        r = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
        s = (1 + 0.1 * torch.randn((d,), generator=gen,
                                   device=dev)).bfloat16()
        b = (0.1 * torch.randn((d,), generator=gen, device=dev)).bfloat16()
        y = ops.fused_residual_layernorm(x, r, s, b)
        p = ref.fused_residual_layernorm(x, r, s, b)
        pre = ref.fused_residual_layernorm(x, r, s)
        diff = (y.float() - p.float()).abs()
        if not bool((diff <= _ln_tol(p, pre)).all()):
            _fail(f"fused_residual_layernorm [{rows}, {d}] (TP rows): "
                  f"beyond 1 bf16 ulp of its plain version (max abs "
                  f"{diff.max().item()})")
        bound, by = _bound(3 * rows * d * 2 + 2 * d * 2, 10.0 * rows * d,
                           fp32=True)
        out[f"fused_residual_layernorm [{rows}, {d}]"] = {
            "max_abs_err": diff.max().item(),
            "ms": _time_ms(lambda: ops.fused_residual_layernorm(x, r, s, b),
                           200),
            "device_ms": _profiled_ms(
                lambda: ops.fused_residual_layernorm(x, r, s, b),
                ("resln_kernel",)), "bound_ms": bound, "bound_by": by}
    f = 4096 // 2
    for rows in (TRAIN_BATCH * TRAIN_SEQ, TRAIN_BATCH * TRAIN_SEQ // 2):
        b = (0.5 * torch.randn((f,), generator=gen, device=dev)).bfloat16()
        x = (2 * torch.randn((rows, f), generator=gen,
                             device=dev)).bfloat16()
        y = bg.bias_gelu(x, b).float()
        h = x.float() + b.float()
        p32 = bg_ref.bias_gelu(x.float(), b.float()).bfloat16().float()
        diff = (y - p32).abs()
        if not bool((diff <= _bf16_ulp(p32) + h.abs() * GELU_TAIL).all()):
            _fail(f"bias_gelu [{rows}, {f}] (TP columns): beyond 1 bf16 ulp "
                  f"+ |h| 2^-22 of its plain version in fp32 (max abs "
                  f"{diff.max().item()})")
        bound, by = _bound(2 * rows * f * 2 + f * 2, 9.0 * rows * f,
                           fp32=True)
        out[f"bias_gelu [{rows}, {f}]"] = {
            "max_abs_err": diff.max().item(),
            "ms": _time_ms(lambda: bg.bias_gelu(x, b), 200),
            "device_ms": _profiled_ms(lambda: bg.bias_gelu(x, b),
                                      ("bias_gelu_kernel",)),
            "bound_ms": bound, "bound_by": by}
        del x, y, h, p32, diff
    # deepseek's pre-norm blocks on a (1, 2) rank's sequence shard
    rows, d = TRAIN_BATCH * TRAIN_SEQ // 2, 2048
    x = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
    y = (0.5 * torch.randn((rows, d), generator=gen, device=dev)).bfloat16()
    sc = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).bfloat16()
    h, x2 = ops.decode_residual_norm(y, x, sc, kind="rmsnorm")
    ph, px2 = ref.decode_residual_norm(y, x, sc, kind="rmsnorm")
    diff = (h.float() - ph.float()).abs()
    if not torch.equal(x2.view(torch.int16), px2.view(torch.int16)) or \
            not bool((diff <= _bf16_ulp(ph)).all()):
        _fail(f"decode_residual_norm [{rows}, {d}] (TP rows): x + y not "
              f"bitwise or the norm off by more than 1 bf16 ulp (max abs "
              f"{diff.max().item()})")
    # x, y read, x + y and the norm written; the scale read
    bound, by = _bound(4 * rows * d * 2 + d * 2, 5.0 * rows * d, fp32=True)
    out[f"decode_residual_norm [{rows}, {d}]"] = {
        "max_abs_err": diff.max().item(),
        "ms": _time_ms(lambda: ops.decode_residual_norm(
            y, x, sc, kind="rmsnorm"), 200),
        "device_ms": _profiled_ms(lambda: ops.decode_residual_norm(
            y, x, sc, kind="rmsnorm"), DEVICE_NAMES["decode_residual_norm"]),
        "bound_ms": bound, "bound_by": by}
    del x, y, h, x2, ph, px2, diff
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    sc = torch.tensor([0.7, 10.0, 1000.0], device=dev)

    def mv_close(a, p):
        ulp = torch.exp2(torch.floor(torch.log2(p.abs().clamp_min(
            2.0 ** -126))) - 23)
        return bool(((a - p).abs() <= 2 * ulp).all())
    shapes = ((1, 30592 // 2 * 1024 // 2), (1, 1024 // 2),
              (32, 2048 * 1408))
    out["lamb shards"] = check_lamb_shards(dev, gen, sc, 1e-3, hyper,
                                           mv_close, shapes=shapes)
    torch.cuda.empty_cache()
    return out


def mp_phase(dev, smi, dp_out, tp1_per_step):
    """Phase 8d: training on a (data, model) mesh, gloo ranks sharing the
    card. (a) (1, 2): bert-large MP_STEPS eager steps; deepseek-moe-16b
    at MP_MOE_LAYERS layers, MP_MOE_STEPS steps, 32 experts a rank; a
    control step of bert-large with model rank 1's partial sums dropped;
    and one with MP_PLANTED_LEAF's model-axis gradient sum dropped. (b)
    (2, 2): bert-large MP4_STEPS steps, FSDP live. Gated: the step-1 loss
    within STEP1_LOSS_ULPS of dp=1's (phase 8c, the same weights and
    batch); against dp=1's own step 1, a leaf (over the ranks' distinct
    blocks): the master update within TP_UPDATE_REL_L2 and its median
    within TP_UPDATE_MEDIAN_REL_L2, m within TP_MOMENT_REL_L2, and the
    update's norm within 1 +- TP_UPDATE_NORM_REL of dp=1's where w != 0;
    the first control beyond the update limit at every leaf, the planted
    leaf failing a gate on each model rank; the ranks holding the same
    block of a leaf bitwise equal after every step; the training kernels'
    launches a step equal to tp=1's (phase 8), deepseek's equal to its
    stated count; the collectives a step by kind equal
    ``zero_collectives``; deepseek's expert bytes a rank half of the
    whole; losses finite. Printed: a rank's bytes, the collectives' ring
    bytes beside ``core.distmodel.model_parallel``'s, step times, peaks.
    With two or more cards, nccl at (1, 2) with a card a rank."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import distmodel
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.model import init_params
    from repro_torch.optim import zero
    t0 = time.perf_counter()
    kern = _mp_kernel_checks(dev)
    # dp=1's step-1 master update and m, param-shaped (their flat leaves
    # unflattened)
    arch = get_config("bert-large")
    shapes = init_params(arch, torch.Generator(device=dev).manual_seed(SEED),
                         dev, torch.bfloat16)
    tp1_param_bytes = sum(t.numel() * t.element_size()
                          for t in tree.leaves(shapes))
    plan = zero.Plan(shapes, layer_rows=True)
    ref = {}
    for k in ("update", "m"):
        ref[k] = os.path.join(os.path.dirname(dp_out[f"{k}_path"]),
                              f"{k}_params.pt")
        flat = [t.to(dev) for t in torch.load(dp_out[f"{k}_path"])]
        torch.save([t.cpu() for t in tree.leaves(
            plan.blocks(plan.state(flat), shapes))], ref[k])
        os.remove(dp_out[f"{k}_path"])
    del shapes, plan, flat
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    bert = {"arch": "bert-large", "layers": None, "rules": {}}
    two = mesh_lib.spawn(_mp_train, 2, [
        dict(bert, steps=MP_STEPS, ref=ref),
        dict(bert, steps=1, ref=ref, control=True),
        {"arch": "deepseek-moe-16b", "layers": MP_MOE_LAYERS,
         "rules": {}, "steps": MP_MOE_STEPS, "ref": None},
        dict(bert, steps=1, ref=ref, plant=MP_PLANTED_LEAF)],
        backend="gloo", device=str(dev), mesh=((1, 2), ("data", "model")),
        timeout=600)
    t2 = time.perf_counter()
    four = mesh_lib.spawn(_mp_train, 4, [dict(bert, steps=MP4_STEPS,
                                              ref=ref)],
                          backend="gloo", device=str(dev),
                          mesh=((2, 2), ("data", "model")), timeout=600)
    t3 = time.perf_counter()
    for path in ref.values():
        os.remove(path)
    dp1_loss = dp_out["dp1"]["losses"][0]
    loss_ulp = _bf16_ulp(torch.tensor(dp1_loss)).item()

    def check_run(ranks, i, name):
        runs = [r[i] for r in ranks]
        lead = runs[0]
        for r in runs[1:]:
            if r["losses"] != lead["losses"]:
                _fail(f"{name}: ranks' losses differ")
        specs = lead["specs"]
        from repro_torch.parallel import sharding
        items = sharding.leaf_items(specs)
        for step in range(len(lead["digests"])):
            for j, (path, sp) in enumerate(items):
                axes = _leaf_axes(sp)
                seen = {}
                for r in runs:
                    key = tuple(r["coords"][a] for a in axes)
                    dg = r["digests"][step][j]
                    if seen.setdefault(key, dg) != dg:
                        _fail(f"{name} step {step + 1}: the ranks holding "
                              f"block {key} of {'/'.join(path)} differ")
        for r in runs:
            for k, c in enumerate(r["collectives"]):
                got = {kk: c[kk] for kk in r["stated"]}
                if got != r["stated"]:
                    _fail(f"{name} step {k + 1} rank {r['coords']}: "
                          f"collectives {got}, stated {r['stated']}")
        if not all(math.isfinite(x) for x in lead["losses"]):
            _fail(f"{name}: losses {lead['losses']}")
        return lead, _readings(runs), ["/".join(p) for p, _ in items]

    def _readings(runs):
        """Each leaf's step-1 readings (``_mp_leaf_readings``) over the
        ranks holding its distinct blocks, by kind; None without a
        reference."""
        if "update_sq" not in runs[0]:
            return None
        from repro_torch.parallel import sharding
        per = [_mp_leaf_readings([r["update_sq"][j] for r in _distinct(
            runs, j, _leaf_axes(sp))]) for j, (_, sp) in enumerate(
                sharding.leaf_items(runs[0]["specs"]))]
        return {k: [x[k] for x in per] for k in per[0]}

    def gates(rd):
        """The step-1 gates a run's readings ``rd`` fail, by name, each
        with its worst leaf index and reading."""
        out = {}
        worst = int(np.argmax(rd["update"]))
        if not rd["update"][worst] <= TP_UPDATE_REL_L2:
            out["update"] = (worst, rd["update"][worst])
        med = float(np.median(rd["update"]))
        if not med <= TP_UPDATE_MEDIAN_REL_L2:
            out["update median"] = (None, med)
        worst = int(np.argmax(rd["m"]))
        if not rd["m"][worst] <= TP_MOMENT_REL_L2:
            out["m"] = (worst, rd["m"][worst])
        dev_ = [abs(x - 1) if x is not None else -1.0 for x in rd["norm"]]
        worst = int(np.argmax(dev_))
        if not dev_[worst] <= TP_UPDATE_NORM_REL:
            out["update norm"] = (worst, rd["norm"][worst])
        return out

    results = {}
    for label, ranks, i in (("(1, 2)", two, 0), ("(2, 2)", four, 0)):
        lead, rd, paths = check_run(ranks, i, f"bert-large {label}")
        gap = abs(lead["losses"][0] - dp1_loss) / loss_ulp
        if not gap <= STEP1_LOSS_ULPS:
            _fail(f"bert-large {label}: step-1 loss {lead['losses'][0]} is "
                  f"{gap} bf16 ulps from dp=1's {dp1_loss} (tol "
                  f"{STEP1_LOSS_ULPS})")
        for name, (j, x) in gates(rd).items():
            _fail(f"bert-large {label}: step-1 {name} reads {x}"
                  + (f" at {paths[j]}" if j is not None else "")
                  + f" (limits: update {TP_UPDATE_REL_L2}, its median "
                  f"{TP_UPDATE_MEDIAN_REL_L2}, m {TP_MOMENT_REL_L2}, norm "
                  f"ratio 1 +- {TP_UPDATE_NORM_REL})")
        update = rd["update"]
        for k, per in enumerate(lead["launches"]):
            for name, want in tp1_per_step.items():
                if per[name] != want:
                    _fail(f"bert-large {label} step {k + 1}: {name} "
                          f"{per[name]} launches, tp=1's {want}")
        results[label] = {"lead": lead, "update": update, "paths": paths,
                          "readings": rd, "loss_gap_ulps": gap,
                          "peaks": [r[i]["peak"] for r in ranks]}
    control, crd, cpaths = check_run(two, 1, "bert-large control")
    cupdate = crd["update"]
    best = int(np.argmin(cupdate))
    if not cupdate[best] > TP_UPDATE_REL_L2:
        _fail(f"the control step (model rank 1's partial sums dropped) "
              f"lands within {TP_UPDATE_REL_L2} of dp=1's update at "
              f"{cpaths[best]} ({cupdate[best]}): the gate would not see it")
    # the planted fault: the ranks hold other values of the leaf, so each
    # model rank's own reading of it is judged
    j = cpaths.index(MP_PLANTED_LEAF)
    planted = [_mp_leaf_readings([r[3]["update_sq"][j]]) for r in two]
    caught = [sorted(k for k, (jj, _) in gates(
        {k: [p[k]] for k in p}).items() if jj is not None)
        for p in planted]
    if not all(caught):
        _fail(f"the planted fault ({MP_PLANTED_LEAF}'s model-axis sum "
              f"dropped) fails no gate on a model rank: {planted}")
    moe, _, _ = check_run(two, 2, "deepseek-moe-16b (1, 2)")
    ds = dataclasses.replace(get_config("deepseek-moe-16b"),
                             num_layers=MP_MOE_LAYERS)
    moe_layers = sum(ds.is_moe_layer(i) for i in range(ds.num_layers))
    eff = ds.moe.expert_ff or ds.d_ff
    whole_experts = moe_layers * 3 * ds.moe.num_experts * ds.d_model * eff * 2
    if moe["bytes"]["experts"] * 2 != whole_experts:
        _fail(f"deepseek (1, 2): a rank holds {moe['bytes']['experts']} "
              f"expert bytes, not half of the whole {whole_experts}")
    # its pre-norm blocks: a mixer add + ln2 a layer (twice under remat),
    # on the rank's B S / tp rows; a LAMB stage a flat leaf
    moe_want = {"decode_residual_norm": (2 if ds.remat else 1)
                * ds.num_layers, "fused_residual_layernorm": 0,
                "bias_gelu": 0, "lamb_stage1": len(moe["units"]),
                "lamb_stage2": len(moe["units"])}
    for k, per in enumerate(moe["launches"]):
        got = {name: per[name] for name in moe_want}
        if got != moe_want:
            _fail(f"deepseek (1, 2) step {k + 1}: launches {got}, stated "
                  f"{moe_want}")
    one = dp_out["dp1"]
    lead2, lead4 = results["(1, 2)"]["lead"], results["(2, 2)"]["lead"]
    model = distmodel.model_parallel(arch, TRAIN_BATCH, TRAIN_SEQ, 2)

    def spread(rel, names):
        i = int(np.argmax(rel))
        return (f"max {rel[i]:.4g} ({names[i]}), median "
                f"{float(np.median(rel)):.4g}")

    def ring(c):
        return {k: c[f"{k}_bytes"] for k in ("all_reduce", "reduce_scatter",
                                              "all_gather")}
    for label in ("(1, 2)", "(2, 2)"):
        res = results[label]
        ld = res["lead"]
        print(f"[mp] bert-large {label} (data, model) over gloo, ranks on "
              f"one card, make_rules() defaults, B{TRAIN_BATCH} "
              f"S{TRAIN_SEQ}, fused, LAMB kernels, fp32 master: losses "
              f"{[round(x, 5) for x in ld['losses']]} (dp=1 "
              f"{[round(x, 5) for x in one['losses'][:len(ld['losses'])]]}); "
              f"step-1 loss {res['loss_gap_ulps']:.3f} bf16 ulps from "
              f"dp=1's; master update rel-L2 against dp=1's a leaf "
              f"{spread(res['update'], res['paths'])} (limit "
              f"{TP_UPDATE_REL_L2}); ranks holding a block bitwise equal "
              f"every step; launches a step {ld['launches'][0]} (tp=1 "
              f"{tp1_per_step}); collectives a step "
              f"{ {k: ld['collectives'][0][k] for k in ld['stated']} } = "
              f"stated; ring bytes a rank a step {ring(ld['collectives'][0])}"
              f"; rank bytes {ld['bytes']} against dp=1's params "
              f"{tp1_param_bytes} and optimizer bytes {one['opt_bytes']}; step "
              f"{[round(t * 1e3, 1) for t in ld['step_s']]} ms (gloo host "
              f"round trips: not a speed figure); peaks "
              f"{[round(p / 2**30, 3) for p in res['peaks']]} GiB (dp=1 "
              f"{one['peak'] / 2**30:.3f}); {smi}", flush=True)
    print(f"[mp] the paper's M1 (core.distmodel.model_parallel(bert-large, "
          f"{TRAIN_BATCH}, {TRAIN_SEQ}, 2)): comm_bytes "
          f"{model.comm_bytes:.0f} B (4 activation all-reduces a layer, "
          f"fp32, no remat, no embedding or cross entropy); the (1, 2) "
          f"step's ring bytes a rank {ring(lead2['collectives'][0])}: "
          f"sequence parallelism turns each all-reduce into a reduce-"
          f"scatter and an all-gather (the same ring bytes), remat "
          f"re-runs the forward's, and the vocab-parallel embedding, "
          f"logits, cross entropy and the partial gradients' sum add "
          f"theirs; control: update rel-L2 min {cupdate[best]:.4g} "
          f"({cpaths[best]}), median {float(np.median(cupdate)):.4g}, m "
          f"rel-L2 min {min(crd['m']):.4g}; planted ({MP_PLANTED_LEAF}'s "
          f"model-axis sum dropped), model ranks 0 / 1: update rel-L2 "
          f"{planted[0]['update']:.4g} / {planted[1]['update']:.4g}, m "
          f"rel-L2 {planted[0]['m']:.4g} / {planted[1]['m']:.4g}, gates "
          f"failed {caught}")
    for label in ("(1, 2)", "(2, 2)"):
        rd, names = results[label]["readings"], results[label]["paths"]
        norm = [abs(x - 1) for x in rd["norm"] if x is not None]
        w = int(np.argmax(rd["update"]))
        print(f"[mp] bert-large {label} step 1 against dp=1's, a leaf: m "
              f"rel-L2 {spread(rd['m'], names)} (limit {TP_MOMENT_REL_L2});"
              f" update median {float(np.median(rd['update'])):.4g} (limit "
              f"{TP_UPDATE_MEDIAN_REL_L2}); |update norm ratio - 1| max "
              f"{max(norm):.3e} over the {len(norm)} leaves with w != 0 "
              f"(limit {TP_UPDATE_NORM_REL}); worst update leaf "
              f"{names[w]}: {rd['flips'][w]:.0f} of {rd['n'][w]:.0f} "
              f"elements flip sign, carrying "
              f"{rd['flip_gap_share'][w]:.4f} of its squared gap, their "
              f"dp=1 |m| {rd['flip_m_over_rms'][w]:.4g} of the leaf's RMS; "
              f"all leaves: flips {spread(rd['flip_share'], names)}; {smi}")
    print(f"[mp] deepseek-moe-16b (1, 2), {MP_MOE_LAYERS} of "
          f"{get_config('deepseek-moe-16b').num_layers} layers (depth cut "
          f"to fit the phase), full width, 32 experts a rank: losses "
          f"{[round(x, 5) for x in moe['losses']]}, grad norms "
          f"{[round(x, 4) for x in moe['grad_norms']]}, rank bytes "
          f"{moe['bytes']} (experts half the whole's {whole_experts}); "
          f"collectives a step {moe['collectives'][0]}; step "
          f"{[round(t * 1e3, 1) for t in moe['step_s']]} ms; {smi}")
    print("[mp] kernels at TP shapes: " + "; ".join(
        f"{k}: max abs err {v['max_abs_err']:.3e}, events {v['ms']:.5f} "
        f"ms, device {_ms(v['device_ms'])} ms, bound {v['bound_ms']:.6f}"
        for k, v in kern.items() if k != "lamb shards")
        + f"; LAMB shards {kern['lamb shards']['shapes']}: ratio rel "
        f"{kern['lamb shards']['ratio_rel_err']:.3e}")
    cards = torch.cuda.device_count()
    out = {"card": smi, "cards": cards, "backend": "gloo",
           "kernels": kern, "control_update_rel_l2": cupdate,
           "tp1_param_bytes": tp1_param_bytes,
           "distmodel_m1_comm_bytes": model.comm_bytes,
           "deepseek_moe_16b": {k: moe[k] for k in (
               "layers", "losses", "grad_norms", "step_s", "bytes",
               "collectives", "stated", "peak", "units", "launches")},
           "planted": {"leaf": MP_PLANTED_LEAF, "model_ranks": planted,
                       "gates_failed": caught},
           "spawn_s": {"(1, 2)": t2 - t1, "(2, 2)": t3 - t2}}
    for label, res in results.items():
        ld = res["lead"]
        out[label] = {"losses": ld["losses"], "grad_norms": ld["grad_norms"],
                      "step_s": ld["step_s"], "bytes": ld["bytes"],
                      "launches": ld["launches"],
                      "collectives": ld["collectives"],
                      "stated": ld["stated"], "peaks": res["peaks"],
                      "update_rel_l2": res["update"],
                      "step1_readings": {k: res["readings"][k] for k in
                                         ("m", "norm", "flips")},
                      "loss_gap_bf16_ulps": res["loss_gap_ulps"]}
    out["leaf_paths"] = results["(1, 2)"]["paths"]
    if cards >= 2:
        t4 = time.perf_counter()
        nccl = mesh_lib.spawn(_mp_train, 2, [dict(bert, steps=2, ref=None)],
                              backend="nccl",
                              mesh=((1, 2), ("data", "model")), timeout=600)
        lead, _, _ = check_run(nccl, 0, "bert-large (1, 2) nccl")
        out["nccl"] = {k: lead[k] for k in ("losses", "step_s", "peak")}
        print(f"[mp] nccl (1, 2), a card a rank: losses {lead['losses']}, "
              f"step {[round(t * 1e3, 1) for t in lead['step_s']]} ms; "
              f"{time.perf_counter() - t4:.1f} s")
    else:
        out["nccl"] = "not run: one card"
        print(f"[mp] {cards} card: nccl with a card a rank was not run "
              f"(it needs 2 cards)")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[mp] phase {out['phase_s']:.1f} s (kernel checks and the "
          f"reference {t1 - t0:.1f} s, (1, 2) spawn {t2 - t1:.1f} s, (2, 2) "
          f"spawn {t3 - t2:.1f} s)")
    return out


UNTIED_GEMV = "head_gemv_wgmma_kernel"   # pass 1 of an untied head

DEVICE_NAMES = {"filter_logits": ("filter_kernel",),
                "draw_tokens": ("draw_kernel",),
                "paged_decode_attention": ("decode_kernel",),
                "paged_prefill_attention": ("prefill_kernel",),
                "decode_residual_norm": ("resnorm_kernel",),
                "gated_rmsnorm": ("gated_rmsnorm_kernel",),
                "head_tokens": ("head_gemv_kernel", "head_epilogue_kernel"),
                "head_tokens_untied": (UNTIED_GEMV, "head_epilogue_kernel")}


def _new_slice_s(marks, families) -> float:
    """Seconds of the flash-training additions to phase 8b (the llama
    phase's share) and the tensor-parallel phase."""
    keys = list(marks)
    tp_s = marks["tp"] - marks[keys[keys.index("tp") - 1]]
    return tp_s + families["llama3.2-3b"]["long"]["flash"]["added_s"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels.fused_lm_head import ref as head_ref
        from repro_torch.models.model import Model
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    t_start = time.perf_counter()
    built = _build.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in built["ptxas"].items()}
    print(f"[build] {built['built']} in {built['seconds']:.1f}s (nvcc, "
          f"parallel); ptxas: {regs}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    arch = get_config("llama3.2-3b")
    marks = {"build": time.perf_counter()}
    rows = [check_decode_attention(arch, rng, dev),
            check_prefill_attention(arch, rng, dev)]
    print_paged(*rows)
    flash_row = check_flash_attention(arch, dev)
    filt, lg_f, lg = check_filter(arch, rng, dev)
    check_uniforms(dev)
    rows += [filt, check_draw(lg_f, lg, dev)]
    del lg_f, lg
    rows += [check_residual_norm(arch, dev), check_head_tokens(arch, dev)]
    head_mamba = check_head_tokens(get_config("mamba2-1.3b"), dev)
    # its own rng: the later phases draw from ``rng``
    moe_kernels = moe_kernel_checks(dev, np.random.default_rng(SEED + 30))
    mamba_rows = [check_gated_rmsnorm(get_config("mamba2-1.3b"), dev)]
    train_rows = [check_residual_layernorm(dev), check_bias_gelu(dev)]
    train_rows += check_lamb(dev)
    torch.cuda.empty_cache()
    print("[kernels vs plain] " + "; ".join(
        f"{r['name']}: max abs err {r['max_abs_err']:.3e}"
        + (f" (tol {r['tol']})" if isinstance(r.get("tol"), str) else
           f" (tol {r['tol']:.3e})" if "tol" in r else " (bitwise)")
        for r in rows + [flash_row]
        + [dict(head_mamba, name="head_tokens at mamba2-1.3b")]
        + mamba_rows + train_rows))

    marks["kernel checks"] = time.perf_counter()
    # its own rng, as the MoE checks
    new_kernels = vlm_encdec_kernel_checks(dev,
                                           np.random.default_rng(SEED + 40))
    marks["vlm/encdec kernel checks"] = time.perf_counter()
    arch_kernels = new_arch_kernel_checks(dev,
                                          np.random.default_rng(SEED + 50))
    marks["new-arch kernel checks"] = time.perf_counter()
    softmax_row = check_scale_mask_softmax(dev)
    marks["softmax"] = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = Model.init(arch, gen, device=dev)
    torch.cuda.synchronize()
    print(f"[init] llama3.2-3b full width, {arch.num_layers} layers, bf16 "
          f"weights on the card in {time.perf_counter() - t0:.1f}s")
    logit_err = check_model_logits(model, rng, dev)
    marks["model checks"] = time.perf_counter()
    plain_uniforms = _count_eager_uniforms()
    runs = {fused: serve(model, logit_err, fused) for fused in (False, True)}
    marks["serves"] = time.perf_counter()
    same = sum(runs[False]["results"][i]["tokens"]
               == runs[True]["results"][i]["tokens"]
               for i in runs[False]["results"])
    print(f"[streams] fused vs unfused serve: {same} of "
          f"{len(runs[False]['results'])} request streams identical (bf16 "
          "streams may fork on near-tied logits; not a failure)")
    prof = profile_serve(model)
    marks["profile"] = time.perf_counter()
    multi = multistep_phase(model, runs)
    marks["multi-step"] = time.perf_counter()
    static = static_phase(model)
    marks["static llama"] = time.perf_counter()
    eager = check_sampled_step_launches(model)
    run = runs[True]
    n_sampled = sum(r.sampling.temperature > 0 for r in trace(arch, SEED))
    heads = {"sampled": run["flagged"]["sampled"] + n_sampled,
             "greedy": run["steps"] - run["flagged"]["sampled"]
             + run["prefills"] - n_sampled}
    prof_launches = sum(c for _, c in prof.values())
    fall = eager["eager row_uniforms"] * heads["sampled"] + heads["greedy"]
    print(f"[launches] the profiled fused llama serve: {prof_launches} "
          f"kernel launches; with the eager threefry (PERF.md §5, two runs) "
          f"{PROFILE_PARENT_LAUNCHES[0]} / {PROFILE_PARENT_LAUNCHES[1]}; the "
          f"fall the eager threefry accounts for: "
          f"{eager['eager row_uniforms']} x {heads['sampled']} sampled head "
          f"calls + {heads['greedy']} greedy ones (a zeros_like each) = "
          f"{fall}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mamba = mamba_phase(dev, rng, marks)
    moe = moe_phase(dev, rng, marks, moe_kernels)
    qwen = qwen_phase(dev, rng, marks)
    whisper = whisper_phase(dev)
    marks["whisper"] = time.perf_counter()
    command_r = command_r_phase(dev, rng, marks)
    cut = {}
    for name in CUT_DEPTH:
        cut[name] = cut_depth_phase(name, dev, rng)
        marks[name] = time.perf_counter()
    if EAGER_UNIFORMS["calls"]:
        _fail(f"the mamba2, deepseek, jamba, qwen2-vl, whisper, command-r, "
              f"mistral-large and llama4 serves called the eager "
              f"row_uniforms on the card {EAGER_UNIFORMS['calls']} times")
    head_ref.row_uniforms = plain_uniforms
    mamba_launches = sum(c for _, c in mamba["profile"].values())
    print(f"[launches] the profiled mamba2 window: {mamba_launches} kernel "
          f"launches (parent: not recorded in PERF.md); no eager "
          f"row_uniforms call in any serve")
    check_block_gradients(get_config("bert-large"), dev)
    marks["block grads"] = time.perf_counter()
    training = check_training(dev)
    marks["training"] = time.perf_counter()
    training["characterize"] = characterize_phase(training)
    marks["characterize"] = time.perf_counter()
    families = train_families_phase(dev, marks)
    tensor_parallel = tp_phase(dev, smi)
    marks["tp"] = time.perf_counter()
    data_parallel = dp_phase(dev, smi)
    marks["dp"] = time.perf_counter()
    model_parallel = mp_phase(dev, smi, data_parallel, training["per_step"])
    marks["mp"] = time.perf_counter()
    prev = t_start
    spans = []
    for name, t in marks.items():
        spans.append(f"{name} {t - prev:.1f}")
        prev = t
    new_phase = (marks["vlm/encdec kernel checks"] - marks["kernel checks"]
                 + marks["whisper"] - marks["jamba"])
    arch_phase = (marks["new-arch kernel checks"]
                  - marks["vlm/encdec kernel checks"]
                  + marks[list(CUT_DEPTH)[-1]] - marks["whisper"])
    print(f"[time] seconds by phase: {', '.join(spans)}; total "
          f"{prev - t_start:.1f}; the vlm and encdec phase (its kernel "
          f"checks, qwen2-vl-2b, whisper-base) {new_phase:.1f}; the "
          f"registry's last archs (their kernel checks, command-r-35b, "
          f"mistral-large-123b, llama4-maverick-400b-a17b) "
          f"{arch_phase:.1f}; the training families (llama3.2-3b, "
          f"mamba2-1.3b, checkpoint) {families['phase_s']:.1f}; the "
          f"flash training and tensor-parallel additions "
          f"{_new_slice_s(marks, families):.1f}; the data-parallel ZeRO-1 "
          f"phase {marks['dp'] - marks['tp']:.1f}; the model-axis training "
          f"phase {marks['mp'] - marks['dp']:.1f}")
    # the kernels on the training families' paths: their launches there
    # and their numbers at the training shapes
    llama_t, mamba_t = families["llama3.2-3b"], families["mamba2-1.3b"]
    fam_path = (f"{FAMILY_STEPS} graphed fused training steps, B"
                f"{TRAIN_BATCH} S{TRAIN_SEQ}")
    for r in rows:
        if r["name"] == "decode_residual_norm":
            r["training"] = dict(
                families["norm_shapes"]["decode_residual_norm"],
                launches_llama_training=llama_t["launches"][r["name"]],
                launches_per_step=llama_t["per_step"][r["name"]],
                launches_path=f"llama3.2-3b, {fam_path}")
            ds_mp = model_parallel["deepseek_moe_16b"]
            r["model_parallel"] = dict(
                {k: v for k, v in model_parallel["kernels"].items()
                 if k.startswith(r["name"])},
                launches_per_step={"(1, 2)": ds_mp["launches"][0][
                    r["name"]]},
                launches_path=f"deepseek-moe-16b at {MP_MOE_LAYERS} "
                              "layers on a (1, 2) mesh of gloo ranks, eager "
                              "fused steps, rank 0")
    for r in mamba_rows:
        r["training"] = dict(
            families["norm_shapes"]["gated_rmsnorm"],
            launches_mamba2_training=mamba_t["launches"][r["name"]],
            launches_per_step=mamba_t["per_step"][r["name"]],
            launches_path=f"mamba2-1.3b, {fam_path}")
    for r in train_rows:
        if r["name"].startswith("lamb_stage"):
            r["training_families"] = {
                name: {"launches": t["launches"][r["name"]],
                       "launches_per_step": t["per_step"][r["name"]],
                       "step": t["profile"].get("lamb", {}).get(r["name"])}
                for name, t in (("llama3.2-3b", llama_t),
                                ("mamba2-1.3b", mamba_t))}
    for r in rows:
        name = r["name"]
        path = name in PATH_KERNELS[True]   # the fused serve is the default
        run = runs[path]
        per_step = {"paged_decode_attention": run["steps"],
                    "paged_prefill_attention": None,
                    "filter_logits": run["flagged"]["filtered"],
                    "draw_tokens": run["flagged"]["sampled"],
                    "decode_residual_norm": run["steps"],
                    "head_tokens": run["steps"]}[name]
        r["launches"] = run["launches"][name]
        r["launches_path"] = "fused serve" if path else "unfused serve"
        r["launches_unfused_serve"] = runs[False]["launches"][name]
        r["launches_fused_serve"] = runs[True]["launches"][name]
        r["launches_in_decode"] = run["phase"]["decode"][name]
        r["launches_in_prefill"] = run["phase"]["prefill"][name]
        r["launches_per_eligible_decode_step"] = (
            run["phase"]["decode"][name] / per_step if per_step else None)
        r["launches_per_prefill_chunk"] = (run["phase"]["prefill"][name]
                                           / run["prefill_chunks"])
        if path:            # filter and draw: from their phase-3 window
            dev_ms = [v for k, v in prof.items()
                      if any(n in k for n in DEVICE_NAMES[name])]
            r["profiler_device_ms_per_call"] = (
                sum(v[0] for v in dev_ms) / r["launches"]
                if dev_ms and r["launches"] else None)
    for r in rows:
        if r["name"] == "head_tokens":
            r["mamba2_shape"] = {k: head_mamba[k] for k in (
                "shape", "max_abs_err", "ms", "ms_greedy", "ms_16_rows",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "unfused_head_ms", "profiler_device_ms_by_step",
                "ctas_a_row", "random_rows_clear_margin")}
            r["launches_mamba2_serve"] = mamba["launches"]["head_tokens"]
    flash_long = llama_t["long"]["flash"]
    flash_row["training"] = {
        "launches_llama_training_flash": flash_long["launches"][
            "flash_attention"],
        "launches_per_step": flash_long["per_step"]["flash_attention"],
        "launches_path": f"llama3.2-3b B1 S{LONG_SEQ}, {LONG_STEPS} eager "
                         "fused steps with attn_impl='flash' (a forward and "
                         "its recompute a layer)",
        "step_s": flash_long["step_s"],
        "chunked_step_s": flash_long["chunked_step_s"],
        "loss_gap_bf16_ulps": flash_long["loss_gap_bf16_ulps"],
        "layer": {k: llama_t["long"]["tiles"][k] for k in (
            "flash", "flash_rel_l2_grads_vs_vjp", "flash_rel_l2_out_vs_vjp",
            "vjp")},
        "graphed": flash_long["graphed"]}
    flash_row.update(
        launches=static["greedy"]["launches_prefill"]
        + static["greedy"]["launches_decode"],
        launches_path="static llama3.2-3b serve, attn_impl='flash' (greedy "
                      f"run: one prefill of {STATIC_BATCH} x {STATIC_PROMPT} "
                      f"tokens, {STATIC_GEN - 1} decode steps)",
        launches_in_prefill=static["greedy"]["launches_prefill"],
        launches_in_decode=static["greedy"]["launches_decode"],
        launches_sampled_run=static["sampled"]["launches_prefill"]
        + static["sampled"]["launches_decode"],
        static_prefill_profile=static["profile"])
    for r in mamba_rows:
        name, ph = r["name"], mamba["phase"]
        r["launches"] = mamba["launches"][name]
        r["launches_path"] = "mamba2-1.3b fused serve (the engine's default)"
        r["launches_in_decode"] = ph["decode"][name]
        r["launches_in_prefill"] = ph["prefill"][name]
        r["launches_per_decode_step"] = ph["decode"][name] / mamba["steps"]
        r["launches_per_prefill_chunk"] = (ph["prefill"][name]
                                           / mamba["prefill_chunks"])
        hits = [v for k, v in mamba["profile"].items()
                if "gated_rmsnorm_kernel" in k]
        r["serve_profiler_device_ms_per_call"] = (
            sum(v[0] for v in hits) / sum(v[1] for v in hits)
            if hits else None)
    for r in train_rows:
        if r["name"].startswith("lamb_stage"):
            dp2 = data_parallel["dp2"]
            r["zero1_dp2"] = {
                "shard_shapes": dp2["shards"],
                "launches_per_step_a_rank": dp2["lamb"][0][r["name"]],
                "launches_rank0": sum(s[r["name"]] for s in dp2["lamb"]),
                "launches_path": f"bert-large dp={DP} ZeRO-1 over gloo, "
                                 f"{DP_STEPS} eager fused steps, rank 0"}
    for r in train_rows:
        mp_shapes = {k: v for k, v in model_parallel["kernels"].items()
                     if k.startswith(r["name"])}
        if r["name"].startswith("lamb_stage"):
            mp_shapes = {"shard_shapes": model_parallel["kernels"][
                "lamb shards"]["shapes"]}
        r["model_parallel"] = dict(
            mp_shapes, launches_per_step={
                mesh: model_parallel[mesh]["launches"][0][r["name"]]
                for mesh in ("(1, 2)", "(2, 2)")},
            launches_path="bert-large on (data, model) meshes of gloo "
                          "ranks, eager fused steps, rank 0")
    for r in train_rows:
        name = r["name"]
        r["launches"] = training["fused"]["launches"][name]
        r["launches_path"] = (f"fused training, {TRAIN_STEPS} steps "
                              f"(REPRO_FUSED_BLOCKS=1, "
                              f"fused_optimizer_kernel=True)")
        r["launches_per_step"] = training["per_step"][name]
        r["launches_unfused_training"] = training["unfused"]["launches"][name]
    # the kernels at the vlm and encdec paths' shapes, and their launches
    nk = new_kernels
    qwen_fused = qwen["launches"]["fused"]
    new_shapes = {
        "paged_decode_attention": dict(
            nk["paged"]["decode"], G=nk["paged"]["G"],
            launches_qwen2_vl_fused_serve=qwen_fused[
                "paged_decode_attention"]),
        "paged_prefill_attention": dict(
            nk["paged"]["prefill"], G=nk["paged"]["G"],
            launches_qwen2_vl_fused_serve=qwen_fused[
                "paged_prefill_attention"]),
        "filter_logits": {k: {"ctas_a_row": v["ctas_a_row"], "device_ms":
                              v["filter_device_ms"]}
                          for k, v in nk["sampler"].items()},
        "draw_tokens": {k: {"ctas_a_row": v["ctas_a_row"], "device_ms":
                            v["draw_device_ms"]}
                        for k, v in nk["sampler"].items()},
        "decode_residual_norm": dict(
            nk["residual_norm"], launches_qwen2_vl_fused_serve=qwen_fused[
                "decode_residual_norm"]),
        "head_tokens": {k: nk["head"][k] for k in (
            "shape", "max_abs_err", "ms", "ms_greedy", "ms_16_rows",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "profiler_device_ms_by_step",
            "ctas_a_row", "random_rows_clear_margin")}
        | {"launches_qwen2_vl_fused_serve": qwen_fused["head_tokens"]}}
    for r in rows:
        r["vlm_encdec_shapes"] = new_shapes[r["name"]]
    flash_row["vlm_encdec_cases"] = nk["flash"]
    flash_row["launches_whisper_static"] = {
        k: v["flash_launches"] for k, v in whisper["runs"].items()}
    flash_row["launches_qwen2_vl_static_flash"] = {
        k: qwen["static"]["flash"][k]
        for k in ("launches_prefill", "launches_decode")}
    # the kernels at command-r-35b's shapes: launches from its serves (the
    # head on the fused path, the filter and draw on the unfused one)
    cr_launches = command_r["launches"]
    arch_rows = [dict(arch_kernels["head"],
                      launches=cr_launches["fused"]["head_tokens"],
                      launches_path=f"{COMMAND_R} fused serve (the engine's "
                                    "default)")]
    for r, kname in zip(arch_kernels["wide"], ("filter_logits",
                                               "draw_tokens")):
        arch_rows.append(dict(r, launches=cr_launches["unfused"][kname],
                              launches_path=f"{COMMAND_R} unfused serve"))
    trained = {run: {k: training[run][k] for k in (
        "losses", "grad_norms", "step_s", "wall", "peak", "peak_above_start",
        "graph")} for run in ("fused", "fused_eager", "unfused")}
    print(json.dumps({"kernels": rows + [flash_row] + mamba_rows + train_rows
                      + [softmax_row, moe["row"]] + arch_rows,
                      "training": dict(
        trained, profile=training["profile"],
        steady_step_ms=training["steady_step_ms"],
        bitwise_leaves=training["bitwise_leaves"],
        syncs_in_a_step=training["syncs_in_a_step"],
        n_leaves=training["n_leaves"],
        n_params=training["n_params"], batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        characterize=training["characterize"]),
        "serves": {
        ("fused" if f else "unfused"): {
            "wall_s": run["wall"], "decode_steps": run["steps"],
            "decode_steps_sampled": run["flagged"]["sampled"],
            "decode_steps_filtered": run["flagged"]["filtered"],
            "prefill_chunks": run["prefill_chunks"],
            "prefills": run["prefills"]}
        for f, run in runs.items()} | {"mamba2-1.3b fused": {
            k: mamba[k] for k in ("wall", "tok_per_s", "mean_ttft_s",
                                  "steps", "prefill_chunks", "prefills",
                                  "prefill_tokens", "peak_bytes",
                                  "ssm_state_bytes", "logit_err")}} | {
            "static llama3.2-3b flash": {
                k: v for k, v in static.items() if k != "profile"},
            "static mamba2-1.3b": mamba["static"]},
        "identical_streams": same,
        "multistep": dict(multi, mamba2=mamba["multistep"]),
        "moe": {"deepseek-moe-16b": moe["deepseek"],
                "jamba-v0.1-52b": moe["jamba"], **moe["kernels"]},
        "vlm_encdec": {"qwen2-vl-2b": qwen, "whisper-base": whisper,
                       "phase_s": new_phase},
        "registry_archs": {COMMAND_R: command_r, **cut, "kernels": {
            k: v for k, v in arch_kernels.items()
            if k not in ("head", "wide")}, "phase_s": arch_phase},
        "training_families": families,
        "tensor_parallel": tensor_parallel,
        "data_parallel": data_parallel,
        "model_parallel": model_parallel,
        "sampled_step_launches": eager,
        "profiled_launches": {
            "llama3.2-3b fused": prof_launches,
            "eager threefry fall": fall, "head calls": heads,
            "mamba2-1.3b window": mamba_launches},
        "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
