#!/usr/bin/env python3
"""Drive the PyTorch port (the DVV store, gemma2-9b, mamba2-780m,
qwen3-moe-30b-a3b, grok-1-314b (full width, 6 layers), jamba-1.5-large-398b
(full width, the first 5 layers of its block, and its long_500k decode
step), qwen3-14b and granite-8b serving, qwen2-vl-7b prefill,
decode and training with image-style M-RoPE positions, gemma-2b, mamba2-780m
and qwen3-moe-30b-a3b training, hubert-xlarge prefill and training, every
config's smoke size, the nine examples) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each printed as one JSON line with at_s, the seconds since the
script was loaded; a failure in any phase raises and exits non-zero:

  device   the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the time to build the kernels with nvcc (one
           nvcc per kernel package, all started together), with ptxas's
           registers and spills for every kernel.
  kernels  each CUDA kernel against its plain torch version on the card,
           with kernel and plain times from CUDA events and the bound
           (bytes or operations) computed from the inputs.  dvv_ops: on
           random clock sets from --seed, at the store's bucket shapes and
           at one large shape, exact equality (bool and int outputs, so no
           tolerance), each row naming the path the wrapper took (tiled or
           general); beside each sweep a front_end row: the store's front
           end (numpy in, numpy out: one pinned copy in, the kernel, one
           copy out, one wait) timed by the host's clock per call, its
           result equal to the kernel's.  flash_attention: at gemma2-9b's
           prefill shapes (q [1, 8192, 16, 256], k/v with 8 heads, bf16)
           for a local
           layer (window 4096, softcap 50), a global layer (causal,
           softcap 50) and causal without softcap, to max abs err 2e-2 and
           to BF16_ROW_TOL of each output row's RMS (ref.row_scaled_err);
           fp32 at [1, 1024, 16, 256], causal with softcap, to 1e-5; and
           masked by M-RoPE-style positions at qwen2-vl-7b's widths (q
           [1, 8192, 28, 128], 4 KV heads, bf16, causal; an image of 4,096
           patches sharing one temporal id between text runs); at
           qwen3-moe-30b-a3b's prefill shape (q [1, 4096, 32, 128], 4 KV
           heads, bf16, causal, no softcap); at qwen3-14b's,
           granite-8b's, grok-1-314b's and jamba-1.5-large-398b's (q
           [1, 8192, 40, 32, 48 or 64, 128], 8 KV heads, bf16, causal:
           GQA groups of 5, 4, 6 and 8); and
           at hubert-xlarge's
           (bidirectional, 16 heads of 80 on 16 KV heads: bf16 [1, 32768],
           the audio_model prefill's, and fp32 [1, 1024]; where one call's
           fp32 scores would pass PLAIN_SCORE_BYTES, the plain version runs
           one KV head at a time).
           Beside each, one PyTorch call of the same function, timed as a
           yardstick the port never calls: FlexAttention (compiled, with
           the softcap as score_mod and a causal or sliding-window block
           mask) for the softcap rows and with the positions' mask for the
           M-RoPE row, scaled_dot_product_attention for the others.
           ssd_scan: at mamba2-780m's widths (48 heads of 64, state 128,
           chunk 256) on inputs drawn as
           tests/test_kernels.py draws them, bf16 [1, 32768] and fp32
           [1, 4096], and bf16 at the main path's [4, 32768]; and at
           jamba-1.5-large-398b's 256 heads, bf16 [1, 8192]; y and
           h_final to 5e-2 (bf16) or 1e-5 (fp32) of the largest value,
           against the plain version run in fp32 on the upcast inputs.
           The bf16 rows take the wgmma path (three passes, three CUDA
           kernels a call), fp32 the simple kernel; each row names its
           path.  No PyTorch call computes the SSD scan: no library
           yardstick.  flash_attention_bwd: dq, dk and dv against the
           plain version's (autograd through ref.flash_attention_ref) at
           gemma-2b's training shape (q [1, 4096, 8, 256], 1 KV head,
           bf16, causal), gemma2-9b's global and local layers, the global
           layer at S 4096 with q drawn 30 times larger (scores where the
           softcap bends), qwen2-vl-7b's M-RoPE row, vl_train's (the same
           at [1, 4096], where kv_splits gives each of a group's 7 query
           heads its own block) and moe_train's (q [1, 4096, 32, 128], 4
           KV heads, causal), fp32
           [1, 1024, 16, 256], and hubert-xlarge's training shape (q
           [4, 4096, 16, 80], 16 KV heads, bf16, bidirectional) and fp32
           [1, 1024, 16, 80]; and at head_dim 16 and 32 (the forward rows
           too): the examples' own shapes (quickstart.py's Trainer [4, 16],
           4 heads on 1, bf16; train_e2e.py's [8, 128], 8 heads of 32 on
           2, bf16; the smoke_configs phase's fp32 [2, 64], 4 heads of 16
           on 2), then [4, 4096] with 8 heads of 32 or 4 heads of 16 on 2
           KV heads, causal and bidirectional, bf16 and fp32, beside SDPA:
           bf16 against the exact gradient (the plain
           version in fp32 on the upcast inputs) within
           ref.BF16_GRAD_RMS_RATIO times the plain bf16 version's own
           error by ref.grad_rms_err, and each row within
           ref.BF16_GRAD_ROW_TOL of the plain version by ref.grad_row_err
           (bf16 runs on wgmma from the forward's row statistics, as
           autograd's FlashAttention hands them over); fp32 to 1e-4 of
           the largest magnitude (FMAs); two launches bitwise equal.  Each
           row has each kernel's device ms (delta, dq, dkdv, reduce) and
           the share of the bound reached.  The yardstick is the
           backward of scaled_dot_product_attention (causal and
           bidirectional rows) or of compiled FlexAttention (softcap,
           window, positions).
           ssd_scan_bwd: the SSD scan's gradient (dy given, dh_final none,
           from the forward's fp32 statistics as autograd's SSDScan hands
           them over) at mamba2-780m's training shape (bf16 [1, 4096], 48
           heads of 64, state 128, chunk 256) and fp32 [1, 1024]: bf16
           within the flash backward's two gates against the plain
           backward passes (ref.ssd_passes_bwd, with the rounding of the
           path bwd_path picks, and in fp32 as the exact gradient); fp32
           to 1e-4 of the plain version's autograd; two launches bitwise
           equal, both on the row's path (bf16 at these widths: the
           wgmma backward, six kernels; fp32: the simple one, four); each
           kernel's device ms, the bound and its share, and each bf16
           tensor's RMS error against the exact gradient over that of the
           simple path's plain rounding (simple_rms_err_ratio: what the
           wgmma path's own roundings cost).  No PyTorch call computes
           the SSD gradient: no library yardstick.
           decode_attention: one decode step's attention over the live
           keys of a cache (no TPU kernel: the JAX package's is jnp) at
           grok-1's decode shape (32 slots over 8,192, 48 heads over 8 of
           128, softcap 30) at positions 600 and 8,191, and at jamba's
           long_500k step (batch 1 over 524,288 slots, 64 heads over 8) at
           its last position, bf16, to BF16_ROW_TOL of each output row's
           RMS against the plain version (full cache, mask, softmax) in
           fp32 on the upcast inputs; the bound is bytes (the live keys'
           K and V once); beside it scaled_dot_product_attention over the
           same live keys (without grok's softcap, which it cannot
           apply), a yardstick the port never calls.
  store    the port's KVClient/KVCluster on the card, deployed as Riak KV's
           documented DVV setup (5 nodes, n_val=3, r=w=2, a 64-partition
           ring): put 262,144 keys with 64-byte values, partition
           {n0,n1}|{n2,n3,n4}, overwrite 10% of the keys on both sides
           with their pre-partition contexts, heal, run delta rounds until
           every shard's replicas agree, read every key at quorum 2, and
           check every acknowledged write comes back.  The launch counters
           are zeroed just before and read just after.
  parity   the same schedule at 16,384 keys through the kernels and
           through the numpy twins (use_kernel=False): identical digest and
           value roots for every store, identical reads.
  trace    the 16,384-key schedule once more under torch.profiler,
           tracing the card only: device-busy seconds against wall seconds
           (the device's idle share), each kernel's device time per
           launch at the shapes the store gives it, and the host-to-device
           and device-to-host copies per sweep (at most one each; the
           sweeps counted by the launch counters, zeroed just before).
  store_workload  the closed-loop serving workload of
           `python -m repro_torch.launch.serve --store-workload` (the JAX
           package's BENCH_serving.json coalescing deployment at its
           largest session count: 5 nodes, n_val 3, r = w = 2, packed DVV,
           read-repair; 1,000,000 sessions, 10,000 keys, zipf 0.9,
           concurrency 256, max_batch 256, max_delay 2.0) with a
           GossipDriver of period 10, 1,500 steps (3,000 ops) in each mode,
           coalesced (OpScheduler) and direct.  Per mode: the engine's
           summary, gossip rounds and wire bytes, and each DVV kernel's
           launches (counts zeroed just before the run, read just after).
           Checks: no op failed, both sweeps launched, the same mode through
           the numpy twins (use_kernel=False) gives the same summary (wall
           fields aside) and the same digest and value roots for every
           store; after replication drains and gossip converges the
           cluster, a quorum-2 read of every written key returns the last
           acknowledged PUT among its values.  Then 500 coalesced steps
           under torch.profiler: device-busy against wall seconds.
  geo      a two-datacenter KVCluster on the card (east e0-e2, west w0-w2,
           as tests/test_geo.py lays them out; LAN 1 +- 0.5 and WAN 30 +- 10
           ticks): put 16,384 keys from both DCs and ship them, cut the WAN,
           write 10% of the keys in each DC with their pre-cut contexts,
           read snapshots of every key in each DC through an OpScheduler
           (one snapshot_get_many a flush; no WAN message may be sent),
           heal, let the WanShipper ship until the cluster converges, and
           quorum-read every key from each DC: every acknowledged write
           comes back in both.  The numpy twins give the same roots,
           snapshots and reads.
  smoke_configs  every registry config's .smoke() (head_dim 16; jamba-
           1.5-large-398b runs on the card only here), fp32
           compute, parameters from --seed made on the host: a prefill of
           SMOKE_TOKENS, 4 decode steps from an empty cache (decoders),
           the loss, every gradient leaf and one make_train_step through
           launch/steps.py (the MoE configs' routers real), on the card
           against the port's CPU run of the same parameters within 1e-4
           (logits and loss absolutely, each gradient leaf over its largest
           magnitude); each config's flash_attention and ssd_scan launches
           (zeroed just before its card run, read just after) as many as
           its attention and Mamba layers ask.
  examples the nine examples_torch scripts, each a subprocess on the card
           (5 at a time), the six store ones also with --device cpu:
           every run exits 0, each store script's stdout on the card
           equals its CPU stdout (PYTHONHASHSEED=0), train_e2e (granite-
           mini at d_model 256, head_dim 32, --steps 60) ends in its
           bitwise-resume PASS, the store scripts launch the DVV sweeps
           and quickstart and train_e2e the flash forward and backward
           (each run's counts, printed by the subprocess on its stderr).
  model    gemma2-9b at full width and depth (42 layers, 9.24 B fp32
           parameters from a torch.Generator seeded by --seed): one warm-up
           and one timed prefill of tokens [1, 8192] through
           make_prefill_step, each launching flash_attention exactly 42
           times (the counts are zeroed just before the timed prefill and
           read just after); then 8 requests of 16 tokens through
           BatchScheduler (4 slots, max_len 256) with session state in the
           port's KVCluster on the card, and every session/<rid> read back
           with its 16 tokens.  Parameter bytes and peak device memory.
  model_trace  one prefill and 16 decode steps under torch.profiler on
           the card: device-busy seconds against the wall seconds of the
           same traced run (the device's idle share), the top device
           events, and the device seconds and share of the hand-written
           kernel (flash_fwd_*) by kernel name.
  model_parity  the same config cut to 2 groups (4 layers) at full width
           with fp32 compute: prefill logits of 4,608 tokens (past the
           4,096 window) against the same tokens fed one by one through
           decode_step, to PREFILL_DECODE_TOL (the CPU twin,
           tests/test_torch_models.py, holds the same bound).
  ssm_model  mamba2-780m at full width and depth (48 layers, 780 M fp32
           parameters from --seed, bf16 compute), after gemma2-9b's
           parameters are freed: one warm-up and one timed prefill of
           tokens [4, 32768], each launching ssd_scan exactly 48 times;
           then the same 8 requests of 16 tokens through BatchScheduler,
           sessions in a KVCluster on the card, all read back.
  ssm_trace  as model_trace, for mamba2-780m at [4, 32768]; the kernel
           share sums the SSD scan's kernels (ssd_*).
  ssm_parity  mamba2-780m cut to 4 layers at full width, fp32 compute:
           prefill logits of 1,024 tokens (four chunks) against
           token-by-token decode (decode_ssm's recurrence), to
           PREFILL_DECODE_TOL.
  moe_model  qwen3-moe-30b-a3b at full width and depth (48 layers, d_model
           2048, 128 experts top-8) with bf16 parameters from --seed (the
           published checkpoint's dtype; the config's fp32 master weights
           would take 122 GB), after mamba2-780m's are freed: as model, a
           warm-up and a timed prefill of tokens [1, 4096], each launching
           flash_attention exactly 48 times, then the same 8 requests of 16
           tokens through BatchScheduler, sessions in a KVCluster on the
           card, all read back.  The timed prefill also reports every MoE
           layer's fraction_dropped and the summed aux (load-balance and z
           losses), read through a wrapper around the LM's moe_ffn.
  moe_trace  as model_trace, for qwen3-moe-30b-a3b at [1, 4096]; then one
           more prefill traced with the host's ops, the MoE's parts and
           the attention layers each inside a profiler range: device time
           by part (flash_attention, counted by kernel name, and the rest of
           the attention, router, capacity assignment, the dispatch and
           combine products, expert products, the dense MLPs, the head, the
           rest) and by kernel class (GEMM, flash_attention forward and
           backward, the SSD scan, the rest).
  moe_parity  qwen3-moe-30b-a3b cut to 2 layers at full width, fp32: (a)
           prefill logits of 8 tokens against token-by-token decode,
           within 2e-4 (at 8 tokens or fewer a group's capacity is
           8, so no token is dropped on either side); (b) a [1, 4096]
           prefill's first-layer fraction_dropped equals a host recount
           (numpy, the per-slot occupancy loop) over the experts the card's
           router chose for that layer's input.
  grok_model  grok-1-314b at its published widths (d_model 6144, 48 heads
           over 8 KV heads of 128, 8 experts top-2 of d_ff 32,768 on
           every layer, vocab 131,072, tied embeddings) cut to 6 layers,
           30.33 B bf16 parameters (60.65 GB) from --seed, after
           qwen3-moe's parity: as moe_model at tokens [1, 8192] (each
           prefill launching flash_attention 6 times, every layer's
           fraction_dropped), the 8 requests served and read back; beside
           decode seconds a step, the step's bytes floor (every expert's
           weights, read by the one-hot dispatch).
  grok_trace  as moe_trace, for grok at [1, 8192].
  grok_parity  the 2-layer cut in fp32 (42.58 GB): (a) as moe_parity's;
           (b) logits of a [1, 2048] prefill through the kernels against
           the plain versions on the card, within 1e-4; (c) that
           prefill's first-layer fraction_dropped against the host's
           recount.
  jamba_model  jamba-1.5-large-398b, the hybrid, at its published widths
           (d_model 8192; Mamba-2 of d_inner 16,384 in 256 SSD heads of 64,
           state 128, chunk 256; 64 heads over 8 KV heads of 128; 16
           experts top-2 of d_ff 24,576; vocab 65,536, tied) cut to the
           first 5 layers of its 8-layer block (Mamba-2 at 0-3, MoE at 1
           and 3, the attention layer at 4), 23.46 B bf16 parameters (46.91
           GB) from --seed, after grok's parity: as moe_model at tokens
           [1, 8192], each prefill launching flash_attention once and
           ssd_scan 4 times on its wgmma path (model_phase expects each
           kernel's launches from the pattern: attention layers and Mamba
           layers times groups), every MoE layer's fraction_dropped, the 8
           requests served (a KV cache and SSM state carried in each
           BatchScheduler step) and read back; beside decode seconds a
           step, its bytes floor (parameters and cache).
  jamba_long  the long_500k decode step: batch 1 over a cache of 524,288
           slots built by init_cache (2.15 GB of bf16 keys and values for
           the attention layer, the four Mamba layers' conv windows and
           state), a warm-up step at position 8,192 and 16 timed steps
           after it through make_decode_step; then the same over
           SERVE_MAX_LEN's 256 slots (seconds a step only: the host sets
           a decode step's wall, so the cache's share is jamba_trace's,
           from device time).  Each with its bytes floor (every
           parameter, the Mamba layers' state and the live keys and
           values read once); the decode_attention kernel reads the keys
           up to the position only, so a step at position 8,192 reads
           the same attention bytes over either cache.
  jamba_trace  one prefill of [1, 8192] and one decode step over
           long_500k's 524,288 slots and over 256, each timed untraced,
           traced on the card alone (the idle share, against the traced and
           the untraced wall) and then with the
           host's ops, the LM's parts inside profiler ranges: device time of
           the SSD scan kernels, the Mamba mixer's GEMMs and plain-torch
           parts (conv, gate, norm), flash_attention and the rest of the
           attention, the router, capacity assignment, expert products,
           dispatch and combine, the dense MLPs, the head, the rest; and
           the long cache's share of a decode step (1 - the 256-slot
           step's device time over the 524,288-slot step's).
  jamba_parity  the cut pattern[3:5] (Mamba-2 with MoE, then the attention
           layer with its MLP) in fp32 (45.45 GB): (a) prefill logits of
           256 tokens (one SSD chunk) against token-by-token decode, at a
           capacity factor of 8 so that capacity(256) = 256 and nothing
           drops on either side (1.25 gives 40), within 2e-4; (b) logits
           of a [1, 2048] prefill through the kernels against the plain
           versions on the card, within 1e-4; (c) that prefill's MoE
           layer's fraction_dropped against the host's recount.
  qwen3_14b_model, granite_8b_model  as model, for qwen3-14b (40 layers,
           40 heads over 8 KV heads of 128, QK-norm; 14.77 B parameters in
           bf16, its published checkpoint's dtype: fp32 would leave no room
           for the prefill) and granite-8b (36 layers, 32 heads over 8;
           8.05 B fp32 parameters): a warm-up and a timed prefill of tokens
           [1, 8192], each launching flash_attention once a layer, then
           the 8 requests served through BatchScheduler, sessions in a
           KVCluster on the card, all read back.
  qwen3_14b_parity, granite_8b_parity  each cut to 2 layers at full
           width, fp32: prefill logits of [1, 2048] tokens through the
           kernels against the plain versions on the card, to
           PREFILL_DECODE_TOL.
  vl_model  qwen2-vl-7b at full width and depth (28 layers, d_model 3584,
           28 heads over 4 KV heads of 128, M-RoPE sections 16/24/24; 7.07
           B fp32 parameters, bf16 compute) on embeddings (the vision
           tower is a stub, as in the JAX package) with image-style
           positions [3, 1, 8192]: text, an image of 4,096 patches whose
           temporal id repeats while the height and width rows walk a 64 x
           64 grid, text.  A warm-up and a timed prefill through
           make_prefill_step, each launching the flash kernel's position
           instance 28 times (counts by instance zeroed just before, read
           just after); then 16 decode steps of embeddings from an empty
           cache.  No BatchScheduler: the JAX package's serve.py refuses
           embedding-input models.
  vl_trace  that prefill and the 16 decode steps traced on the card:
           device time by kernel class, the flash share, the idle share.
  vl_parity  the 2-layer cut, fp32, [1, 2048] with the same kind of
           positions: logits through the kernels against the plain
           versions on the card, to PREFILL_DECODE_TOL; the same prefill
           masked by index differs by more than 1e-2.
  vl_train  qwen2-vl-7b cut to 8 layers at full width (2.41 B fp32
           parameters and AdamW moments; bf16 compute, remat) through
           make_train_step on embeddings, labels and image-style positions
           [1, 4096]: as audio_train (4 timed steps, one traced), every
           flash launch, forward and backward, by position.
  vl_train_parity  the 2-layer cut, [1, 2048]: the loss and every
           gradient leaf through the kernels against the plain versions,
           fp32 within 1e-4, bf16 within the RMS gate (the row errors,
           read beside each side's against the exact gradient, are not
           gated: the unembedding's rows over a 152,064-wide vocabulary
           carry 2,048 label columns, where one bf16 step of the final
           hidden state reads up to 0.4 of a row's RMS).
  train    gemma-2b at full width and depth (18 layers, 2.51 B fp32
           parameters and fp32 AdamW moments, bf16 compute, each group
           checkpointed) trained as `python -m repro_torch.launch.train`
           builds it (a KVCluster control plane on the card, a
           CheckpointManager): tokens [1, 4096] from the port's
           SyntheticTokens (seed --seed), 4 timed steps (seconds, tokens/s,
           loss, gradient norm and flash launches a step: 36 forward with
           the recompute, 18 backward; counts zeroed just before, read just
           after), one more step traced (device time by kernel class),
           peak device memory; losses and norms must be finite and the
           parameters must move.  Then one save of the whole state (30.1
           GB) through the manager: seconds and GB/s (on the 2-layer cut
           where the disk has less than twice that free, said in the line).
  train_parity  gemma-2b cut to 2 layers at full width, fp32, tokens
           [1, 1024]: the loss and every gradient leaf through the kernels
           against the same through the plain versions on the card (1e-4);
           2 steps, a save, a restore into a fresh Trainer and 2 more steps
           give the state_fingerprint of 4 uninterrupted steps.
  ssm_train  mamba2-780m at full width and depth (48 layers, 780 M fp32
           parameters and fp32 AdamW moments, 9.4 GB; bf16 compute, remat)
           trained as train trains gemma-2b, tokens [1, 4096]: 4 timed
           steps (ssd_scan launches a step: 96 forward with the
           recompute, 48 backward, every backward on the wgmma path:
           bwd_path_launches), one traced step (device time by kernel
           class), peak memory; finite losses and norms, parameters that
           move.  No save (train saves once).
  ssm_train_parity  mamba2-780m cut to 2 layers at full width, fp32,
           remat, tokens [1, 1024]: the loss and every gradient leaf
           through the ssd_scan kernels against the same through the plain
           version (autograd through ref.ssd_chunked) on the card (1e-4),
           the worst leaves named; then each layer's scan, on the inputs
           and dy of the kernels' run, reduced into its A_log and dt_bias
           by the kernels and by the plain version in fp32, each held to
           the plain version in float64 (the kernels' within 1e-4).
  moe_train  qwen3-moe-30b-a3b cut to 2 layers at full width (128
           experts top-8; 1.87 B fp32 parameters and AdamW moments; bf16
           compute, remat; 4 layers peaked at 75.7 GB) trained as train
           trains gemma-2b through the Trainer on SyntheticTokens
           [1, 4096]: 4 timed steps (each with every MoE layer's
           fraction_dropped), no save; the traced step reports device
           time by part as moe_trace's (the flash backward's kernels by
           name, the other parts the forward and remat's recompute) and by
           kernel class, and every MoE layer's fraction_dropped.
  moe_train_parity  qwen3-moe-30b-a3b cut to 2 layers at full width, fp32,
           real fp32 routers, tokens [1, 1024]: the loss and every gradient
           leaf through the kernels against the plain versions on the card
           within 1e-4, both runs routing every token to the same experts.
  audio_model  hubert-xlarge, the audio encoder, at full width and depth
           (48 layers, d_model 1280, 16 heads of 80, bidirectional, 1.26 B
           fp32 parameters from --seed, bf16 compute), after mamba2-780m's
           training: one warm-up and AUDIO_PREFILL_REPS timed prefills of
           frame embeddings [1, 32768] through make_prefill_step, each
           launching flash_attention exactly 48 times; the median seconds,
           frames/s, peak device memory.  No serving: an encoder has no
           decode step.
  audio_trace  one such prefill traced on the card: device time by kernel
           class (flash forward, cuBLAS GEMMs, the rest), the flash
           kernel's share, the idle share, the top device events.
  audio_parity  hubert-xlarge cut to 2 layers at full width, fp32 compute:
           prefill logits of [1, 2048] frames through the kernels against
           the same parameters and frames through the plain versions on
           the card, to PREFILL_DECODE_TOL.
  audio_train  hubert-xlarge at full width and depth (fp32 parameters and
           AdamW moments, 20.1 GB; bf16 compute, remat) through
           make_train_step on one seeded batch of frame embeddings and
           labels in [0, 504), [4, 4096]: 4 timed steps (seconds, frames/s,
           loss, gradient norm and flash launches a step: 96 forward with
           the recompute, 48 backward), one traced step (device time by
           kernel class), peak memory; finite losses and norms, parameters
           that move.  Not the Trainer: the token pipeline yields no frame
           embeddings (tests/test_arch_smoke.py trains it the same way).
  audio_train_parity  the 2-layer cut, remat, frames [1, 2048]: the loss
           and every gradient leaf through the kernels against the plain
           versions on the card, fp32 compute within TRAIN_PARITY_TOL, and
           bf16 compute under the flash backward's two gates (each leaf
           within ref.BF16_GRAD_ROW_TOL of the plain bf16 version's by
           grad_row_err; its RMS distance from the exact gradient, the
           fp32 plain one, within ref.BF16_GRAD_RMS_RATIO of the plain bf16
           version's); the worst leaves named.
  dryrun   the multi-device dry run (python -m repro_torch.launch.dryrun)
           in a subprocess of its own (its fake 256-rank process group
           never shares a process with CUDA; DRYRUN_TIMEOUT): gemma-2b's
           train_4k cell at full width and depth on the 16x16 mesh,
           priced per device on meta tensors (compute, memory and
           collective seconds, the bound, roofline_fraction, per-device
           argument bytes, collective bytes by kind); then the one-chip
           pricing (a 1x1 mesh) of the two steps train and ssm_train time,
           gemma-2b and mamba2-780m at tokens [1, 4096], each beside the
           card's measured seconds a step as estimate_s / measured_s.  The
           estimates are priced with the H100 SXM data sheet's constants
           (launch/roofline.py), the measured side is this card's.  Every
           term must be positive and finite.

Kernel "ms"/"plain_ms" are CUDA-event times per call, so they include the
host's cost of issuing each call; "device_ms" is the profiler's device
time of one call: for each CUDA kernel of the call, the mean over the
launches the trace recorded ("device_launches_traced" of "device_reps"
calls), summed over the call's kernels ("device_kernels_ms" gives each;
the SSD scan's wgmma path has three, its backward four, the flash
backward up to four, every other call one).  The trace
phases give the kernels' share of traced prefill device time.  The model
phases report the peak device memory of the timed prefill itself, before
the checks of its logits (isfinite builds temporaries as large as the
logits), and of serving.  The MoE FFN has no kernel of its own (nor has
the JAX package's); its products are cuBLAS's, named in the traces.

The last lines are the per-kernel JSON summary, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
non-zero before printing any result.  Every run of a phase and every read
of the launch counters happens on the card, in this process.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOADED = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import roofline  # noqa: E402

# torch.compile (the FlexAttention yardstick) caches under build/, compiling
# in this process
for _var, _sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / "torch_compile" / _sub))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

NODES = ("n0", "n1", "n2", "n3", "n4")
SIDE_A, SIDE_B = frozenset({"n0", "n1"}), frozenset({"n2", "n3", "n4"})
STORE_KEYS = 262144          # cut from 1,048,576 for the run's time limit
PARITY_KEYS = 16384
BATCH = 4096
VALUE_BYTES = 64
KERNEL_SHAPES = ((64, 2, 8), (4096, 4, 8), (16384, 4, 8), (1048576, 8, 8))
SUMMARY_SHAPE = (4096, 4, 8)
# the store workload: the launcher's own defaults (the JAX package's CLI
# and BENCH_serving.json's 1M-session coalescing row) with gossip on
WORKLOAD_ARGV = ("--store-workload", "--gossip-period", "10",
                 "--store-steps", "1500")
WORKLOAD_TRACE_STEPS = 500
#: the engine's summary fields read from the host's clock
WALL_FIELDS = ("wall_s", "ops_per_sec_wall")
GEO_DCS = {"east": ("e0", "e1", "e2"), "west": ("w0", "w1", "w2")}
GEO_KEYS = 16384
GEO_SNAPSHOT_KEYS = 64        # keys a snapshot op reads
GEO_SNAPSHOT_BATCH = 64       # ops a scheduler flush takes
#: the dvv_ops kernels' names in profiler traces contain these
DVV_KERNELS = ("dvv_sync_mask", "dvv_read_sweep", "dvv_leq")

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): 3.35 TB/s of
# HBM3; int32 outside the tensor cores is 64 lanes per SM on 132 SMs at the
# 1.98 GHz boost clock.  The HBM rate and the bf16 peak are the dry run's
# (src/repro_torch/launch/roofline.py), so the kernels' bounds and the
# cells' pricing read one set of constants.
HBM_BYTES_PER_S = roofline.HBM_BW
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_COLUMN = 2            # one compare and one fold per column
# Dense peaks of the H100 SXM data sheet: bf16 on the tensor cores, fp32
# outside them.
FLOPS_PER_S = {"bfloat16": roofline.PEAK_FLOPS, "float32": 67e12}

# gemma2-9b serving (src/repro_torch/configs/gemma2_9b.py)
ARCH = "gemma2-9b"
PREFILL_TOKENS = 8192         # cut from prefill_32k's [32, 32768]: its fp32
                              # logits alone would be 1 TB
SERVE_REQUESTS, SERVE_TOKENS, SERVE_SLOTS, SERVE_MAX_LEN = 8, 16, 4, 256
TRACE_DECODE_STEPS = 16
PARITY_GROUPS, PARITY_TOKENS = 2, 4608   # past the 4,096 window, 9 x 512
#: fp32 prefill against token-by-token decode: max abs logit difference.
#: The CPU twin (tests/test_torch_models.py::PREFILL_DECODE_TOL) holds the
#: same bound; logits are softcapped to +-30.
PREFILL_DECODE_TOL = 2e-3
# flash_attention rows: (variant, dtype, B, S, causal, window, softcap,
# tol, (heads, KV heads, head_dim)); gemma2-9b's widths but for the
# qwen3-moe-30b-a3b and hubert-xlarge rows
FLASH_HEADS = (16, 8, 256)
MOE_FLASH_HEADS = (32, 4, 128)          # qwen3-moe-30b-a3b's attention
AUDIO_HEADS = (16, 16, 80)              # hubert-xlarge's: bidirectional
# head_dim 16 (every config's .smoke()) and 32 (examples/train_e2e.py's
# granite-mini at its default d_model 256)
SMOKE_HEADS = (4, 2, 16)                # a smoke config's attention
QUICKSTART_HEADS = (4, 1, 16)           # gemma-2b's smoke config (MQA)
E2E_HEADS = (8, 2, 32)                  # granite-mini, d_model 256
# GQA groups of 5 and 8 at head_dim 128: qwen3-14b's and granite-8b's
# attention (served at full width and depth, [1, 8192])
QWEN3_14B_HEADS = (40, 8, 128)
GRANITE_8B_HEADS = (32, 8, 128)
# a GQA group of 6: grok-1-314b's attention (served at full width, a cut of
# GROK_LAYERS layers, [1, 8192])
GROK_HEADS = (48, 8, 128)
# 64 query heads over 8 KV heads of 128: jamba-1.5-large-398b's attention
# (its one attention layer in eight, served at full width, [1, 8192])
JAMBA_HEADS = (64, 8, 128)
FLASH_ROWS = (
    ("local", "bfloat16", 1, 8192, True, 4096, 50.0, 2e-2, FLASH_HEADS),
    ("global", "bfloat16", 1, 8192, True, 0, 50.0, 2e-2, FLASH_HEADS),
    ("causal", "bfloat16", 1, 8192, True, 0, 0.0, 2e-2, FLASH_HEADS),
    ("global_fp32", "float32", 1, 1024, True, 0, 50.0, 1e-5, FLASH_HEADS),
    ("qwen3_moe", "bfloat16", 1, 4096, True, 0, 0.0, 2e-2, MOE_FLASH_HEADS),
    ("qwen3_14b", "bfloat16", 1, 8192, True, 0, 0.0, 2e-2, QWEN3_14B_HEADS),
    ("granite_8b", "bfloat16", 1, 8192, True, 0, 0.0, 2e-2,
     GRANITE_8B_HEADS),
    ("grok", "bfloat16", 1, 8192, True, 0, 0.0, 2e-2, GROK_HEADS),
    ("jamba", "bfloat16", 1, 8192, True, 0, 0.0, 2e-2, JAMBA_HEADS),
    ("hubert", "bfloat16", 1, 32768, False, 0, 0.0, 2e-2, AUDIO_HEADS),
    ("hubert_fp32", "float32", 1, 1024, False, 0, 0.0, 1e-5, AUDIO_HEADS),
    # head_dim 16 and 32: the examples' own shapes (quickstart.py's
    # Trainer, train_e2e.py's, the smoke_configs phase's fp32 prefill), then
    # [4, 4096] bidirectional and causal, bf16 and fp32
    ("quickstart", "bfloat16", 4, 16, True, 0, 0.0, 2e-2, QUICKSTART_HEADS),
    ("train_e2e", "bfloat16", 8, 128, True, 0, 0.0, 2e-2, E2E_HEADS),
    ("smoke_fp32", "float32", 2, 64, True, 0, 0.0, 1e-5, SMOKE_HEADS),
    ("d32_causal", "bfloat16", 4, 4096, True, 0, 0.0, 2e-2, E2E_HEADS),
    ("d32_bidir", "bfloat16", 4, 4096, False, 0, 0.0, 2e-2, E2E_HEADS),
    ("d16_causal", "bfloat16", 4, 4096, True, 0, 0.0, 2e-2, SMOKE_HEADS),
    ("d16_bidir", "bfloat16", 4, 4096, False, 0, 0.0, 2e-2, SMOKE_HEADS),
    ("d32_causal_fp32", "float32", 4, 4096, True, 0, 0.0, 1e-5, E2E_HEADS),
    ("d32_bidir_fp32", "float32", 4, 4096, False, 0, 0.0, 1e-5, E2E_HEADS),
    ("d16_causal_fp32", "float32", 4, 4096, True, 0, 0.0, 1e-5,
     SMOKE_HEADS),
    ("d16_bidir_fp32", "float32", 4, 4096, False, 0, 0.0, 1e-5,
     SMOKE_HEADS),
)
#: the plain version's fp32 scores of one call at most this many bytes;
#: past it (hubert's [1, 32768] row: 68.7 GB) it runs one KV head at a time
PLAIN_SCORE_BYTES = 16 << 30
# the M-RoPE row: qwen2-vl-7b's attention (src/repro_torch/configs/
# qwen2_vl_7b.py: 28 heads, 4 KV heads, head_dim 128), bf16, causal, masked
# by the temporal positions of text, an image of 4,096 patches, text; at
# another length S the text and the image scale with S (vl_positions)
MROPE_HEADS, MROPE_KV_HEADS, MROPE_HEAD_DIM = 28, 4, 128
MROPE_TEXT, MROPE_IMAGE, MROPE_S = 512, 4096, 8192
MROPE_GRID_WIDTH = 64         # the image's patches a row

# mamba2-780m serving (src/repro_torch/configs/mamba2_780m.py)
SSM_ARCH = "mamba2-780m"
SSM_PREFILL = (4, 32768)      # cut from prefill_32k's [32, 32768]: its fp32
                              # logits alone would be 211 GB (26.4 GB here)
SSM_PARITY_LAYERS, SSM_PARITY_TOKENS = 4, 1024   # 4 chunks of 256
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, SSD_CHUNK = 48, 64, 128, 256
#: jamba-1.5-large-398b's SSD heads: d_inner 16,384 in heads of 64 (its
#: head dim, state and chunk are mamba2-780m's)
JAMBA_SSD_HEADS = 256
# ssd_scan rows: (variant, dtype, B, S, tol, heads), at mamba2-780m's
# widths but the jamba row's 256 heads; the error is max |y - y_ref| /
# max |y_ref| (and the same for h_final) against the plain version run in
# fp32 on the upcast inputs (tests/test_kernels.py)
SSD_ROWS = (
    ("prefill_bf16", "bfloat16", 1, 32768, 5e-2, SSD_HEADS),
    ("fp32", "float32", 1, 4096, 1e-5, SSD_HEADS),
    ("main_path", "bfloat16", *SSM_PREFILL, 5e-2, SSD_HEADS),
    ("jamba", "bfloat16", 1, 8192, 5e-2, JAMBA_SSD_HEADS),
)
#: the common part of the names of the SSD scan's CUDA kernels (both paths
#: of the forward, and the backward's)
SSD_KERNELS = "ssd_"
#: the common part of the names of the SSD backward's CUDA kernels
SSD_BWD_KERNELS = "ssd_bwd_"
# ssd_scan backward rows at mamba2-780m's widths: (variant, dtype, B, S);
# the first is ssm_train's shape.  fp32 gradients to BWD_FP32_TOL of the
# plain version's (autograd through ref.ssd_chunked); bf16 ones within the
# flash backward's two gates (ref.BF16_GRAD_ROW_TOL by grad_row_err against
# the plain backward passes with the bf16 kernel's rounding,
# ref.ssd_passes_bwd, and ref.BF16_GRAD_RMS_RATIO by grad_rms_err against
# the exact gradient, those passes in fp32).
SSD_BWD_ROWS = (
    ("train_bf16", "bfloat16", 1, 4096),
    ("fp32", "float32", 1, 1024),
)

# qwen3-moe-30b-a3b serving (src/repro_torch/configs/qwen3_moe_30b_a3b.py)
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PARAM_DTYPE = "bfloat16"  # the published checkpoint's (hf:Qwen/Qwen3-
                              # 30B-A3B); fp32 master weights take 122 GB
                              # (grok-1-314b's 19.7 GB a layer)
MOE_PREFILL = (1, 4096)       # cut from prefill_32k's [32, 32768]: its fp32
                              # logits alone would be 637 GB (2.5 GB here)
MOE_PARITY_LAYERS = 2
#: prefill tokens for (a): capacity(8) == capacity(1) == 8, nothing drops
MOE_PARITY_TOKENS = 8
#: every MoE parity's bounds (qwen3-moe, grok, jamba; fp32 cuts), the max
#: abs logit difference of (a) prefill against decode and (b) kernels
#: against plain versions.  On an H100 80GB HBM3 (a) reads 4.47e-6 for
#: qwen3-moe, 1.70e-5 for grok and 1.72e-4 for jamba (256 tokens through
#: an SSD chunk and a Mamba-2 decode), (b) 5.57e-5 for grok and 5.85e-5 for
#: jamba, of logits up to 16.6
MOE_PARITY_TOLS = (2e-4, 1e-4)
MOE_TRAIN_LAYERS = 2          # cut from 48 (1.87 B parameters, 29.9 GB of
                              # fp32 parameters, gradients and moments);
                              # 4 layers (3.11 B) peaked at 75.7 GB

# grok-1-314b (src/repro_torch/configs/grok_1_314b.py) at its published
# widths, cut in depth, served as qwen3-moe-30b-a3b is (moe_phases)
GROK_ARCH = "grok-1-314b"
GROK_LAYERS = 6               # cut from 64: 30.33 B parameters, 60.65 GB
GROK_PREFILL = (1, PREFILL_TOKENS)
#: the parity cut's [1, 2048] prefill (42.58 GB of fp32 parameters), the
#: kernels against the plain versions and the drop recount
GROK_PARITY_TOKENS = (1, 2048)
#: moe_phases' arguments by phase tag.  Only grok's parity holds the
#: kernels against the plain versions: among qwen3-moe's 128 experts a
#: token's 8th and 9th probabilities lie within fp32's rounding of each
#: other far more often than grok's 2nd and 3rd of 8, and one token
#: routed apart moves the logits of every later token (capacity, attention)
MOE_SERVE = {
    "moe": dict(arch=MOE_ARCH, tokens=MOE_PREFILL,
                parity_tokens=MOE_PREFILL),
    "grok": dict(arch=GROK_ARCH, layers=GROK_LAYERS, tokens=GROK_PREFILL,
                 parity_tokens=GROK_PARITY_TOKENS, plain=True),
}

# jamba-1.5-large-398b (src/repro_torch/configs/jamba_1_5_large_398b.py),
# the hybrid: at its published widths, in MOE_PARAM_DTYPE parameters, cut to
# the first layers of its 8-layer block (jamba_phases)
JAMBA_ARCH = "jamba-1.5-large-398b"
#: pattern[:5]: Mamba-2 mixers at 0-3 (d_inner 16,384, 256 SSD heads of 64,
#: state 128, chunk 256), the block's one attention layer at 4 (64 heads over
#: 8 KV heads of 128), 16-expert top-2 MoE at 1 and 3, dense MLPs at 0, 2
#: and 4, the tied 65,536 vocabulary: 23,455,301,632 parameters, 46.91 GB in
#: bf16.  pattern[:6] (67.05 GB) leaves too little beside the init's 12.9
#: GB fp32 draw of one stacked expert tensor and the prefill.
JAMBA_LAYERS = slice(0, 5)
JAMBA_PREFILL = (1, PREFILL_TOKENS)
#: the long_500k decode step (524,288 slots, batch 1): a warm-up step at
#: JAMBA_LONG_POS, then JAMBA_LONG_STEPS timed steps
JAMBA_LONG_POS, JAMBA_LONG_STEPS = PREFILL_TOKENS, 16
#: the parity cut, pattern[3:5] (Mamba-2 with MoE, then the attention layer
#: with its MLP): 11,362,641,920 parameters, 45.45 GB in fp32
JAMBA_PARITY_LAYERS = slice(3, 5)
#: (a)'s prefill: one SSD chunk (a prefill's length is a multiple of it), at
#: a capacity factor that gives capacity(256) = 256, so that nothing drops
#: in prefill or decode (the config's 1.25 gives 40)
JAMBA_PARITY_DECODE_TOKENS, JAMBA_PARITY_CAPACITY = 256, 8.0
JAMBA_PARITY_TOKENS = (1, 2048)

# qwen3-14b and granite-8b served at full width and depth through
# model_phase: qwen3-14b in bf16 parameters, its published checkpoint's
# dtype (hf:Qwen/Qwen3-14B; in fp32 its 59 GB leave no room for the
# prefill), granite-8b in fp32 as gemma2-9b; each with a cut of
# DENSE_PARITY_LAYERS at full width, fp32, kernels against plain versions
DENSE_SERVE = (("qwen3-14b", "bfloat16"), ("granite-8b", "float32"))
DENSE_PARITY_LAYERS, DENSE_PARITY_TOKENS = 2, 2048

# qwen2-vl-7b (src/repro_torch/configs/qwen2_vl_7b.py): embeddings and
# image-style M-RoPE positions [3, B, S] through launch/steps.py's steps
# (the JAX package's serve.py refuses embedding-input models, so no
# BatchScheduler); fp32 parameters, bf16 compute, as gemma2-9b
VL_ARCH = "qwen2-vl-7b"
VL_PREFILL = (1, 8192)        # cut from prefill_32k's [32, 32768]: its fp32
                              # logits alone would be 638 GB (5.0 GB here)
VL_DECODE_STEPS = 16
VL_PARITY_LAYERS, VL_PARITY_TOKENS = 2, 2048
VL_TRAIN_LAYERS = 8           # cut from 28: 2.41 B parameters, 38.6 GB of
                              # fp32 parameters, gradients and moments
VL_TRAIN = (1, 4096)          # cut from train_4k's [256, 4096]

#: cuBLAS's GEMM kernels on Hopper carry one of these in their names
GEMM_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")

# flash_attention backward rows: (variant, dtype, S, (heads, KV heads,
# head_dim), causal, window, softcap, masked by M-RoPE positions, q's
# scale, B).  N(0, 1) inputs give scores near N(0, 1), where a softcap of 50
# leaves 1 - (s/cap)^2 above 0.99; "global_capped" draws q at 30 times
# that, so a row's leading scores sit where tanh bends (the factor between
# about 0.9 and 0.1).
BWD_ROWS = (
    ("gemma_2b", "bfloat16", 4096, (8, 1, 256), True, 0, 0.0, False, 1.0, 1),
    ("global", "bfloat16", 8192, FLASH_HEADS, True, 0, 50.0, False, 1.0, 1),
    ("local", "bfloat16", 8192, FLASH_HEADS, True, 4096, 50.0, False, 1.0,
     1),
    ("global_capped", "bfloat16", 4096, FLASH_HEADS, True, 0, 50.0, False,
     30.0, 1),
    ("mrope_positions", "bfloat16", MROPE_S,
     (MROPE_HEADS, MROPE_KV_HEADS, MROPE_HEAD_DIM), True, 0, 0.0, True, 1.0,
     1),
    # the training shapes of vl_train (positions; kv_splits gives each of
    # the 7 query heads of a group its own block) and of moe_train
    ("vl_train", "bfloat16", VL_TRAIN[1],
     (MROPE_HEADS, MROPE_KV_HEADS, MROPE_HEAD_DIM), True, 0, 0.0, True, 1.0,
     VL_TRAIN[0]),
    ("qwen3_moe_train", "bfloat16", 4096, MOE_FLASH_HEADS, True, 0, 0.0,
     False, 1.0, 1),                    # TRAIN_TOKENS
    ("global_fp32", "float32", 1024, FLASH_HEADS, True, 0, 50.0, False, 1.0,
     1),
    # hubert-xlarge's training shape (audio_train's [4, 4096])
    ("hubert", "bfloat16", 4096, AUDIO_HEADS, False, 0, 0.0, False, 1.0, 4),
    ("hubert_fp32", "float32", 1024, AUDIO_HEADS, False, 0, 0.0, False, 1.0,
     1),
    # head_dim 16 and 32, as FLASH_ROWS takes them
    ("quickstart", "bfloat16", 16, QUICKSTART_HEADS, True, 0, 0.0, False,
     1.0, 4),
    ("train_e2e", "bfloat16", 128, E2E_HEADS, True, 0, 0.0, False, 1.0, 8),
    ("smoke_fp32", "float32", 64, SMOKE_HEADS, True, 0, 0.0, False, 1.0, 2),
    ("d32_causal", "bfloat16", 4096, E2E_HEADS, True, 0, 0.0, False, 1.0,
     4),
    ("d32_bidir", "bfloat16", 4096, E2E_HEADS, False, 0, 0.0, False, 1.0,
     4),
    ("d16_causal", "bfloat16", 4096, SMOKE_HEADS, True, 0, 0.0, False, 1.0,
     4),
    ("d16_bidir", "bfloat16", 4096, SMOKE_HEADS, False, 0, 0.0, False, 1.0,
     4),
    ("d32_causal_fp32", "float32", 4096, E2E_HEADS, True, 0, 0.0, False,
     1.0, 4),
    ("d32_bidir_fp32", "float32", 4096, E2E_HEADS, False, 0, 0.0, False,
     1.0, 4),
    ("d16_causal_fp32", "float32", 4096, SMOKE_HEADS, True, 0, 0.0, False,
     1.0, 4),
    ("d16_bidir_fp32", "float32", 4096, SMOKE_HEADS, False, 0, 0.0, False,
     1.0, 4),
)
#: fp32 dq, dk, dv: max abs error over the plain version's largest
#: magnitude (sums in another order).  bf16 dq, dk, dv: each by
#: ref.grad_rms_err against the exact gradient (the plain version run in
#: fp32 on the upcast inputs) within ref.BF16_GRAD_RMS_RATIO times the
#: plain version's own bf16 gradient's, and each row within
#: ref.BF16_GRAD_ROW_TOL of the plain version's by ref.grad_row_err.
BWD_FP32_TOL = 1e-4
#: bf16 rows: the forward's statistics for the backward against the plain
#: version's (ref.flash_attention_stats_ref): each row's logsumexp within
#: this of max(1, |lse|) (fp32 sums in another order, ex2.approx), the
#: fp32 output within ref.BF16_ROW_TOL by row_scaled_err (its p is rounded
#: to bf16 against the running maximum, the plain version's against the
#: final one).
BWD_LSE_TOL = 1e-4

# gemma-2b training (src/repro_torch/configs/gemma_2b.py)
# the dry run (src/repro_torch/launch/dryrun.py): gemma-2b's train_4k cell
# on the single-pod 16x16 mesh, and the one-chip pricing of the train and
# ssm_train phases' steps at their tokens
DRYRUN_CELL = ("gemma-2b", "train_4k", "single")
DRYRUN_TIMEOUT = 300          # seconds; the phase takes about 30 on a CPU
DRYRUN_SCRIPT = """
import json, sys, time
from dataclasses import replace
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
arch, shape, mesh, tokens = sys.argv[1:5]
B, S = json.loads(tokens)
t = time.perf_counter()
cell = dryrun.run_cell(arch, shape, mesh, verbose=False)
cell["seconds"] = time.perf_counter() - t
one = {}
for name in sys.argv[5:]:
    t = time.perf_counter()
    one[name] = dryrun.price_cell(get_config(name), replace(
        SHAPES["train_4k"], global_batch=B, seq_len=S))
    one[name]["seconds"] = time.perf_counter() - t
print(json.dumps({"cell": cell, "one_chip": one}))
"""

TRAIN_ARCH = "gemma-2b"
TRAIN_TOKENS = (1, 4096)      # cut from train_4k's [256, 4096]: the global
                              # batch does not fit one card
TRAIN_STEPS = 4
TRAIN_LR = 3e-4               # launch/train.py's default
TRAIN_PARITY_LAYERS, TRAIN_PARITY_TOKENS = 2, 1024
#: fp32 loss and gradient leaves through the kernels against the plain
#: versions on the card: the loss absolutely, each leaf over its largest
#: magnitude (the kernels' fp32 sums run in another order; the CPU twins
#: hold the plain versions to the JAX package within the same bound)
TRAIN_PARITY_TOL = 1e-4

# hubert-xlarge, the audio encoder (src/repro_torch/configs/hubert_xlarge.py):
# bidirectional attention over frame embeddings, 16 heads of 80, no decode
AUDIO_ARCH = "hubert-xlarge"
AUDIO_PREFILL = (1, 32768)    # cut from prefill_32k's [32, 32768] for time:
                              # the batch of 32 would take ~35 s a prefill
AUDIO_PREFILL_REPS = 3        # timed prefills after the warm-up (median)
AUDIO_TRAIN = (4, 4096)       # cut from train_4k's [256, 4096]: the global
                              # batch does not fit one card
AUDIO_PARITY_LAYERS, AUDIO_PARITY_TOKENS = 2, 2048
# mamba2-780m training: TRAIN_TOKENS as gemma-2b's, no save (train saves
# once); its parity cut, 2 layers at full width, fp32, tokens [1, 1024]
SSM_TRAIN_PARITY_LAYERS, SSM_TRAIN_PARITY_TOKENS = 2, 1024

# smoke_configs: every registry config's .smoke() (head_dim 16), fp32, on
# the card against the port's CPU run of the same parameters
SMOKE_TOKENS = (2, 64)
SMOKE_DECODE_STEPS = 4
#: the CPU twins' tolerances (tests/test_torch_cuda.py): logits and the
#: loss absolutely, each gradient leaf over its largest magnitude
SMOKE_TOL = 1e-4
# examples: the nine examples_torch/ scripts on the card, each in a
# subprocess of its own; the store ones also with --device cpu, whose
# stdout the card's must equal
EXAMPLES = ("kvstore_demo", "shopping_cart", "sharded_cluster",
            "gossip_churn", "geo_replication", "durable_restart",
            "quickstart", "serve_replicated", "train_e2e")
STORE_EXAMPLES = EXAMPLES[:6]
EXAMPLE_ARGS = {"train_e2e": ("--steps", "60")}
EXAMPLE_TIMEOUT = 300         # seconds a script
EXAMPLE_WORKERS = 5           # scripts at a time
#: runs an example as ``python <script>`` would, then prints the kernels'
#: launch counts of the run as the last line of stderr
EXAMPLE_RUNNER = """
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
from repro_torch.kernels import dvv_ops, flash_attention, ssd_scan
print(json.dumps({**dvv_ops.launches, **flash_attention.launches,
                  **flash_attention.bwd_launches, **ssd_scan.launches,
                  **ssd_scan.bwd_launches}), file=sys.stderr)
"""


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase line also gets ``at_s``, the
    seconds since the script was loaded, so that each phase's wall time is
    the difference from the line before."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - LOADED}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def clock_sets(rng, N, K, R):
    """Random encoded clock sets: ranges 0..5, a dot above its column on
    most clocks, about 15% invalid slots."""
    import numpy as np
    vvs = rng.integers(0, 6, (N, K, R), dtype=np.int32)
    dids = rng.integers(-1, R, (N, K), dtype=np.int32)
    at = np.take_along_axis(vvs, np.clip(dids, 0, None)[..., None],
                            axis=-1)[..., 0]
    dns = np.where(dids >= 0, at + rng.integers(1, 3, (N, K)),
                   0).astype(np.int32)
    valid = rng.random((N, K)) < 0.85
    return vvs, dids, dns, valid


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """Run ``fn`` under torch.profiler tracing the card only (CUPTI).
    Returns the total device-busy microseconds, ``{name: (count,
    total_us)}`` per device event (``(0.0, {})`` if the trace holds no
    device time) and the wall seconds of ``fn`` inside the trace, without
    the profiler's start and stop."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    per = {e.key: (e.count, e.self_device_time_total)
           for e in prof.key_averages() if e.self_device_time_total > 0}
    return sum(us for _, us in per.values()), per, wall_s


def device_ms(fn, reps: int):
    """Mean device milliseconds per call from the profiler, after one
    warm-up; None where the trace shows no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    busy_us, _, _ = device_profile(lambda: [fn() for _ in range(reps)])
    return busy_us / reps / 1e3 if busy_us else None


def kernel_name(key: str, kernel: str):
    """The bare name (no namespace, template arguments or parameters) of
    the profiler's device event ``key`` if it contains ``kernel``."""
    found = re.search(r"\w*" + re.escape(kernel) + r"\w*", key)
    return found.group(0) if found else None


def kernel_device_ms(fn, reps: int, kernel: str):
    """The device milliseconds of one call of ``fn``, from ``reps`` calls
    under the profiler after one warm-up.  Each CUDA kernel whose symbol
    contains ``kernel`` is averaged over the launches the trace recorded,
    which can be fewer than ``reps`` (dividing the busy time by ``reps``
    then reads low), and a call launches each once: ``device_ms`` is the
    sum of those means, ``device_kernels_ms`` each mean by kernel name."""
    import torch
    fn()
    torch.cuda.synchronize()
    _, per, _ = device_profile(lambda: [fn() for _ in range(reps)])
    by = {}
    for key, (n, us) in per.items():
        name = kernel_name(key, kernel)
        if name:
            c, t = by.get(name, (0, 0.0))
            by[name] = (c + n, t + us)
    each = {name: us / n / 1e3 for name, (n, us) in by.items()}
    return {"device_ms": sum(each.values()) if each else None,
            "device_kernels_ms": each,
            "device_launches_traced": sum(n for n, _ in by.values()),
            "device_reps": reps}


def bound(nbytes: int, ops: int, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> int:
    import torch
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0


def front_ms(front, args, reps: int) -> float:
    """Host milliseconds per call of a front end (numpy in, numpy out; it
    waits for the card itself), after one warm-up."""
    front(*args)
    t = time.perf_counter()
    for _ in range(reps):
        front(*args)
    return (time.perf_counter() - t) / reps * 1e3


def dvv_rows(seed: int):
    import numpy as np
    import torch
    from repro_torch.kernels.dvv_ops import dvv_ops as C, ops, ref

    dev = torch.device("cuda")
    rows = []
    for N, K, R in KERNEL_SHAPES:
        rng = np.random.default_rng([seed, N, K, R])
        host = clock_sets(rng, N, K, R)
        vvs, dids, dns, valid = (torch.from_numpy(a).to(dev) for a in host)
        nv = valid.sum(dim=1, dtype=torch.int64)
        pairs = int((nv * (nv - 1)).sum())      # ordered valid pairs
        sweep_ops = 2 * pairs * R * OPS_PER_COLUMN
        sweep_in = N * K * (4 * R + 9)
        reps = 5 if N >= 1 << 20 else 50
        plain_reps = 2 if N >= 1 << 20 else 10

        mask = ops.dvv_sync_mask(vvs, dids, dns, valid)
        smask, ceil = ops.dvv_read_sweep(vvs, dids, dns, valid)
        want_mask, want_ceil = ref.read_sweep_ref(vvs, dids, dns, valid)
        torch.cuda.synchronize()
        errs = {"dvv_sync_mask": max_abs_err(mask, want_mask),
                "dvv_read_sweep": max(max_abs_err(smask, want_mask),
                                      max_abs_err(ceil, want_ceil))}
        # dvv_leq on the key's first two slots as N flat pairs
        vx, vy = vvs[:, 0].contiguous(), vvs[:, 1 % K].contiguous()
        ix, iy = dids[:, 0].contiguous(), dids[:, 1 % K].contiguous()
        nx, ny = dns[:, 0].contiguous(), dns[:, 1 % K].contiguous()
        errs["dvv_leq"] = max_abs_err(ops.dvv_leq(vx, ix, nx, vy, iy, ny),
                                      ref.leq_ref(vx, ix, nx, vy, iy, ny))
        specs = {
            "dvv_sync_mask": (
                lambda: ops.dvv_sync_mask(vvs, dids, dns, valid),
                lambda: ref.sync_mask_ref(vvs, dids, dns, valid),
                sweep_in + N * K, sweep_ops),
            "dvv_read_sweep": (
                lambda: ops.dvv_read_sweep(vvs, dids, dns, valid),
                lambda: ref.read_sweep_ref(vvs, dids, dns, valid),
                sweep_in + N * K + N * R * 8,
                sweep_ops + N * K * R),
            "dvv_leq": (
                lambda: ops.dvv_leq(vx, ix, nx, vy, iy, ny),
                lambda: ref.leq_ref(vx, ix, nx, vy, iy, ny),
                N * (8 * R + 16) + N, N * R * OPS_PER_COLUMN),
        }
        fronts = {"dvv_sync_mask": ops.BucketedSweep(dev),
                  "dvv_read_sweep": ops.BucketedReadSweep(dev)}
        got = fronts["dvv_read_sweep"](*host)
        if not (np.array_equal(fronts["dvv_sync_mask"](*host),
                               mask.cpu().numpy())
                and np.array_equal(got[0], mask.cpu().numpy())
                and np.array_equal(got[1], ceil.cpu().numpy())):
            raise AssertionError(f"a front end disagrees with the kernels "
                                 f"at {(N, K, R)}")
        for name, (kern, plain, nbytes, nops) in specs.items():
            if errs[name]:
                raise AssertionError(
                    f"{name} disagrees with its plain version at "
                    f"{(N, K, R)}: max abs err {errs[name]}")
            b_ms, b_by = bound(nbytes, nops)
            C.reset_launches()
            kern()
            path = [p for p, n in C.path_launches.items() if n]
            rows.append({"name": name, "shape": [N, K, R],
                         "path": path[0] if path else None,
                         "max_abs_err": errs[name],
                         "ms": cuda_ms(kern, reps),
                         "plain_ms": cuda_ms(plain, plain_reps),
                         **kernel_device_ms(kern, reps, name),
                         "plain_device_ms": device_ms(plain, plain_reps),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bytes": nbytes, "int32_ops": nops})
            if name in fronts:
                front = fronts[name]
                rows.append({"name": name, "variant": "front_end",
                             "shape": [N, K, R], "max_abs_err": 0,
                             "ms": front_ms(front, host, reps),
                             "h2d_copies": front.h2d_copies,
                             "d2h_copies": front.d2h_copies,
                             "calls": front.hits + front.misses})
        del vvs, dids, dns, valid, mask, smask, ceil, want_mask, want_ceil
        torch.cuda.empty_cache()
    return rows


def live_pairs(S: int, causal: bool, window: int) -> int:
    """(q, k) pairs that pass the masks, positions 0..S-1 on both sides."""
    if not causal:
        return S * S
    if not window:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def compiled_flex():
    """A fresh torch.compile of FlexAttention for one yardstick.  Each
    yardstick closes over its own mask, which dynamo guards on, so past
    its recompile limit a shared compile would run FlexAttention's unfused
    path (every score in memory) and time that instead: dynamo's caches
    are emptied first."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    torch._dynamo.reset()
    return torch.compile(flex_attention, dynamic=False)


def flex_attention_call(S: int, window: int, cap: float):
    """FlexAttention computing a causal row's function on [B, H, S, D]
    tensors: the softcap as score_mod, causal (and window) as the block
    mask, GQA by enable_gqa.  Compiled once per variant; the port never
    calls it."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask

    def mask(b, h, qi, ki):
        ok = ki <= qi
        return ok & (ki > qi - window) if window else ok

    def score(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    block_mask = create_block_mask(mask, None, None, S, S, device="cuda")
    fn = compiled_flex()
    return lambda q, k, v: fn(q, k, v, score_mod=score,
                              block_mask=block_mask, enable_gqa=True)


def plain_flash(q, k, v, **kw):
    """flash_attention_ref, one KV head (and its query heads) at a time
    where one call's fp32 scores would pass PLAIN_SCORE_BYTES."""
    import torch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    if B * H * Sq * k.shape[1] * 4 <= PLAIN_SCORE_BYTES:
        return flash_attention_ref(q, k, v, **kw)
    G = H // KV
    return torch.cat([flash_attention_ref(
        q[:, :, j * G:(j + 1) * G], k[:, :, j:j + 1], v[:, :, j:j + 1], **kw)
        for j in range(KV)], dim=2)


def flash_rows(seed: int):
    """flash_attention against its plain version at gemma2-9b's,
    qwen3-moe-30b-a3b's and hubert-xlarge's prefill shapes, each row beside
    one PyTorch call of the same function on the same tensors (a yardstick
    the port never calls)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import (
        BF16_ROW_TOL, row_scaled_err,
    )

    dev = torch.device("cuda")
    rows = []
    for variant, dtype, B, S, causal, window, cap, tol, (H, KV, D) in \
            FLASH_ROWS:
        assert causal or not cap, "FlexAttention below is built causal"
        rng = np.random.default_rng([seed, S, window, int(cap)])
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, h, D), dtype=np.float32)).to(dev, getattr(torch, dtype))
            for h in (H, KV, KV))
        kw = dict(causal=causal, window=window, softcap=cap)
        got = FA.gqa_flash_attention(q, k, v, **kw)
        want = plain_flash(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        row_err = row_scaled_err(got, want)
        row_tol = BF16_ROW_TOL if dtype == "bfloat16" else None
        if not err <= tol or (row_tol and not row_err <= row_tol):
            raise AssertionError(
                f"flash_attention {variant} disagrees with its plain "
                f"version: max abs err {err} (tolerance {tol}), row-scaled "
                f"err {row_err} (tolerance {row_tol})")
        del want
        pairs = B * live_pairs(S, causal, window)
        nbytes = B * (2 * H + 2 * KV) * S * D * q.element_size()
        b_ms, b_by = bound(nbytes, 4 * H * D * pairs, FLOPS_PER_S[dtype])
        row = {"name": "flash_attention", "variant": variant,
               "shape": [B, S, H, KV, D], "dtype": dtype, **kw,
               "max_abs_err": err, "tol": tol,
               "row_scaled_err": row_err, "row_tol": row_tol,
               "ms": cuda_ms(lambda: FA.gqa_flash_attention(q, k, v, **kw),
                             10),
               "plain_ms": cuda_ms(lambda: plain_flash(q, k, v, **kw), 3),
               **kernel_device_ms(
                   lambda: FA.gqa_flash_attention(q, k, v, **kw), 10,
                   "flash_fwd_"),
               "bound_ms": b_ms, "bound_by": b_by, "live_pairs": pairs,
               "flops": 4 * H * D * pairs, "bytes": nbytes}
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if cap:
            row["library"] = "flex_attention"
            library = partial(flex_attention_call(S, window, cap),
                              qt, kt, vt)
        else:
            row["library"] = "scaled_dot_product_attention"
            library = partial(F.scaled_dot_product_attention, qt, kt, vt,
                              is_causal=causal, enable_gqa=True)
        lib = library().transpose(1, 2)
        row["library_max_abs_diff"] = float(
            (lib.float() - got.float()).abs().max())
        row["library_row_scaled_diff"] = row_scaled_err(lib, got)
        row["library_ms"] = cuda_ms(library, 10)
        rows.append(row)
        del q, k, v, qt, kt, vt, got, lib
        torch.cuda.empty_cache()
    return rows


#: decode_attention's rows: (variant, (B, Smax, KV, G, D, softcap, window),
#: pos): grok-1's decode shape in the benchmark's decode cells at a
#: position its 30 s window reaches and at a full cache, and jamba's
#: long_500k step at its last position
DECODE_ROWS = (
    ("grok_pos600", (32, 8192, 8, 6, 128, 30.0, 0), 600),
    ("grok_pos8191", (32, 8192, 8, 6, 128, 30.0, 0), 8191),
    ("jamba_long_500k", (1, 524288, 8, 8, 128, 0.0, 0), 524287),
)


def decode_attention_rows(seed: int):
    """decode_attention against its plain version (full cache, mask,
    softmax) run in fp32 on the upcast inputs, at DECODE_ROWS' shapes,
    bf16, to BF16_ROW_TOL of each output row's RMS (beside it the bf16
    plain version's own row error against the same); the bound is bytes
    (the live keys' K and V rows, q and the output, each once).  Beside
    each, scaled_dot_product_attention over
    the same live keys (strided [B, KV, L, D] views of the cache), a
    yardstick the port never calls; it takes no softcap, so at grok's rows
    it times the attention without the cap."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, live_keys,
    )
    from repro_torch.kernels.flash_attention.ref import (
        BF16_ROW_TOL, row_scaled_err,
    )

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for variant, (B, Smax, KV, G, D, cap, window), pos in DECODE_ROWS:
        gen = torch.Generator(device=dev).manual_seed(seed + pos)
        q, k, v = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((B, 1, KV, G, D), (B, Smax, KV, D),
                                 (B, Smax, KV, D)))
        kw = dict(window=window, softcap=cap)
        DA.reset_launches()
        got = DA.decode_attend(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        launched = dict(DA.launches)
        # the gate: the plain version in fp32 on the upcast inputs; beside
        # it the bf16 plain version, which rounds scores and p to bf16
        want = decode_attention_ref(q.float(), k.float(), v.float(), pos,
                                    **kw)
        err = float((got.float() - want).abs().max())
        row_err = row_scaled_err(got, want)
        if not row_err <= BF16_ROW_TOL:
            raise AssertionError(
                f"decode_attention {variant} disagrees with its plain "
                f"version: row-scaled err {row_err} (tolerance "
                f"{BF16_ROW_TOL})")
        plain = decode_attention_ref(q, k, v, pos, **kw)
        plain_err = row_scaled_err(plain, want)
        del want, plain
        keys = live_keys(pos, window)
        L = len(keys)
        nbytes = 2 * B * L * KV * D * 2 + 2 * B * KV * G * D * 2
        flops = 4 * B * KV * G * D * L
        b_ms, b_by = bound(nbytes, flops, FLOPS_PER_S["bfloat16"])

        def kernel():
            return DA.decode_attend(q, k, v, pos, **kw)

        row = {"name": "decode_attention", "variant": variant,
               "shape": [B, Smax, KV * G, KV, D], "dtype": "bfloat16",
               "pos": pos, "live_keys": L, **kw,
               "splits": DA.decode_attention.splits(B, KV, L, sms)[0],
               "launches_a_call": launched, "max_abs_err": err,
               "row_scaled_err": row_err, "row_tol": BF16_ROW_TOL,
               "plain_bf16_row_scaled_err": plain_err,
               "ms": cuda_ms(kernel, 20),
               "plain_ms": cuda_ms(
                   lambda: decode_attention_ref(q, k, v, pos, **kw), 3),
               **kernel_device_ms(kernel, 20, "decode_attention"),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops}
        row["bound_share"] = b_ms / row["device_ms"] \
            if row["device_ms"] else None
        qt = q.reshape(B, KV * G, 1, D)
        kt, vt = (t[:, keys.start:keys.stop].transpose(1, 2) for t in (k, v))
        library = partial(F.scaled_dot_product_attention, qt, kt, vt,
                          enable_gqa=True)
        lib = library().reshape(q.shape)
        row["library"] = "scaled_dot_product_attention" + \
            (" (without the softcap)" if cap else "")
        row["library_row_scaled_diff"] = None if cap else \
            row_scaled_err(lib, got)
        row["library_ms"] = cuda_ms(library, 20)
        rows.append(row)
        del q, k, v, got, lib, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def vl_positions(S: int = MROPE_S):
    """Image-style M-RoPE positions [3, S] (data.image_positions):
    MROPE_TEXT text tokens, an image of MROPE_IMAGE patches (both scaled by
    S / MROPE_S) on a grid MROPE_GRID_WIDTH patches wide, then text."""
    from repro_torch.data import image_positions
    return image_positions(S, MROPE_TEXT * S // MROPE_S,
                           MROPE_IMAGE * S // MROPE_S, MROPE_GRID_WIDTH)


def mrope_positions(S: int = MROPE_S):
    """The temporal row of ``vl_positions``: the positions the attention
    masks by."""
    return vl_positions(S)[0]


def flash_mrope_row(seed: int):
    """flash_attention masked by positions at qwen2-vl-7b's widths against
    its plain version, beside FlexAttention with the same mask."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import (
        BF16_ROW_TOL, flash_attention_ref, row_scaled_err,
    )
    from torch.nn.attention.flex_attention import create_block_mask

    H, KV, D, S = MROPE_HEADS, MROPE_KV_HEADS, MROPE_HEAD_DIM, MROPE_S
    rng = np.random.default_rng([seed, S, H])
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, S, h, D), dtype=np.float32)).to("cuda", torch.bfloat16)
        for h in (H, KV, KV))
    pos_np = mrope_positions(S)
    pos = torch.from_numpy(pos_np).cuda()
    kw = dict(causal=True, positions=pos)
    got = FA.gqa_flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    row_err = row_scaled_err(got, want)
    if not (err <= 2e-2 and row_err <= BF16_ROW_TOL):
        raise AssertionError(f"flash_attention with positions disagrees "
                             f"with its plain version: {err}, {row_err}")
    del want
    srt = np.sort(pos_np)
    pairs = int(np.searchsorted(srt, pos_np, side="right").sum())
    nbytes = (2 * H + 2 * KV) * S * D * 2 + S * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * pairs, FLOPS_PER_S["bfloat16"])
    call = partial(FA.gqa_flash_attention, q, k, v, **kw)
    row = {"name": "flash_attention", "variant": "mrope_positions",
           "shape": [1, S, H, KV, D], "dtype": "bfloat16", "causal": True,
           "positions": f"text {MROPE_TEXT}, image {MROPE_IMAGE}, text",
           "max_abs_err": err, "tol": 2e-2, "row_scaled_err": row_err,
           "row_tol": BF16_ROW_TOL, "ms": cuda_ms(call, 10),
           "plain_ms": cuda_ms(partial(flash_attention_ref, q, k, v, **kw),
                               3),
           **kernel_device_ms(call, 10, "flash_fwd_"),
           "bound_ms": b_ms, "bound_by": b_by, "live_pairs": pairs,
           "flops": 4 * H * D * pairs, "bytes": nbytes,
           "library": "flex_attention"}

    def mask(b, h, qi, ki):
        return pos[ki] <= pos[qi]

    block_mask = create_block_mask(mask, None, None, S, S, device="cuda")
    fn = compiled_flex()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = partial(fn, qt, kt, vt, block_mask=block_mask,
                      enable_gqa=True)
    lib = library().transpose(1, 2)
    row["library_max_abs_diff"] = float((lib.float() - got.float()).abs()
                                        .max())
    row["library_row_scaled_diff"] = row_scaled_err(lib, got)
    row["library_ms"] = cuda_ms(library, 10)
    del q, k, v, qt, kt, vt, got, lib
    torch.cuda.empty_cache()
    return [row]


def bwd_library_call(q, k, v, dout, causal: bool, window: int, cap: float,
                     pos):
    """One PyTorch call of the same backward on the same tensors (a
    yardstick the port never calls): autograd.grad of
    scaled_dot_product_attention for the plain causal rows, of compiled
    FlexAttention (the forward rows' score_mod and masks) otherwise.
    Returns (name, call, (dq, dk, dv) in the kernel's layout)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()
    if cap or window or pos is not None:
        from torch.nn.attention.flex_attention import create_block_mask
        S = q.shape[1]

        def mask(b, h, qi, ki):
            if pos is not None:
                return pos[ki] <= pos[qi]
            ok = ki <= qi
            return ok & (ki > qi - window) if window else ok

        kw = dict(block_mask=create_block_mask(mask, None, None, S, S,
                                               device="cuda"),
                  enable_gqa=True)
        if cap:
            kw["score_mod"] = lambda s, b, h, qi, ki: cap * torch.tanh(
                s / cap)
        name, out = "flex_attention", compiled_flex()(qt, kt, vt, **kw)
    else:
        name, out = "scaled_dot_product_attention", \
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dt, retain_graph=True)

    return name, call, [g.transpose(1, 2) for g in call()]


def bwd_row_faults(row) -> list:
    """What a flash_attention_bwd row of flash_bwd_rows got wrong, if
    anything (BWD_FP32_TOL says how each dtype is held)."""
    from repro_torch.kernels.flash_attention.ref import (
        BF16_GRAD_RMS_RATIO, BF16_GRAD_ROW_TOL, BF16_ROW_TOL,
    )

    faults = []
    if not row["bitwise_repeatable"]:
        faults.append("two launches differ")
    if row["launches"] != 2:
        faults.append(f"{row['launches']} launches counted for 2 calls")
    if row["dtype"] == "float32":
        faults += [f"{n} rel err {e}" for n, e in row["rel_err"].items()
                   if not e <= BWD_FP32_TOL]
        return faults
    if not row["lse_rel_err"] <= BWD_LSE_TOL:
        faults.append(f"forward lse err {row['lse_rel_err']}")
    if not row["out32_row_scaled_err"] <= BF16_ROW_TOL:
        faults.append(f"forward fp32 output err "
                      f"{row['out32_row_scaled_err']}")
    faults += [f"{n} row-scaled err {e}"
               for n, e in row["row_scaled_err"].items()
               if not e <= BF16_GRAD_ROW_TOL]
    faults += [f"{n} rms err {row['rms_err'][n]} against the exact "
               f"gradient, plain bf16's {row['plain_rms_err'][n]}"
               for n, r in row["rms_err_ratio"].items()
               if not r <= BF16_GRAD_RMS_RATIO]
    return faults


def bwd_inputs(seed: int, row):
    """One BWD_ROWS row's inputs on the card, drawn from ``seed``: q, k, v,
    dout, the forward's output and the keyword arguments of attend_bwd
    (the masks and, for bf16, the forward's statistics, as FlashAttention
    keeps them)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as K

    variant, dtype, S, (H, KV, D), causal, window, cap, by_pos, \
        q_scale, B = row
    dev = torch.device("cuda")
    rng = np.random.default_rng([seed, S, H, window, int(cap)])
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (B, S, h, D), dtype=np.float32) * x).to(dev, getattr(torch, dtype))
        for h, x in ((H, q_scale), (KV, 1.0), (KV, 1.0), (H, 1.0)))
    pos = torch.from_numpy(mrope_positions(S)).to(dev) if by_pos else None
    kw = dict(causal=causal, window=window, softcap=cap, positions=pos)
    if dtype == "bfloat16":
        out, lse, out32 = K.attend(q, k, v, stats=True, **kw)
        return q, k, v, dout, out, dict(kw, lse=lse, out32=out32)
    return q, k, v, dout, K.attend(q, k, v, **kw), kw


def flash_bwd_rows(seed: int):
    """The flash_attention backward kernel against its plain version
    (autograd through ref.flash_attention_ref) at gemma-2b's and
    hubert-xlarge's training shapes and at gemma2-9b's, qwen2-vl-7b's and
    fp32 shapes: dq, dk and dv
    errors (bf16 also against the exact gradient beside the plain
    version's own), two launches bitwise equal, times (each kernel's
    device ms too), bound and the share of it reached, beside the
    backward of one PyTorch call of the same function."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_stats_ref, grad_rms_err,
        grad_row_err, row_scaled_err,
    )

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for bwd_row in BWD_ROWS:
        variant, dtype, S, (H, KV, D), causal, window, cap, by_pos, \
            q_scale, B = bwd_row
        q, k, v, dout, out, kw_stats = bwd_inputs(seed, bwd_row)
        pos = kw_stats["positions"]
        kw = dict(causal=causal, window=window, softcap=cap, positions=pos)
        K.reset_launches()
        got = K.attend_bwd(q, k, v, out, dout, **kw_stats)
        again = K.attend_bwd(q, k, v, out, dout, **kw_stats)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        launched = K.bwd_launches["flash_attention_bwd"]
        del again
        names = ("dq", "dk", "dv")
        want = flash_attention_bwd_ref(q, k, v, out, dout, **kw)
        torch.cuda.synchronize()
        err = {n: float((g.float() - w.float()).abs().max())
               for n, g, w in zip(names, got, want)}
        rel = {n: err[n] / float(w.float().abs().max())
               for n, w in zip(names, want)}
        row_err = rms = plain_rms = exact_row_err = plain_exact_row_err = \
            lse_err = out32_err = None
        if dtype == "bfloat16":
            want32, want_lse = flash_attention_stats_ref(q, k, v, **kw)
            lse_err = float(((kw_stats["lse"] - want_lse).abs()
                             / want_lse.abs().clamp_min(1.0)).max())
            out32_err = row_scaled_err(kw_stats["out32"], want32)
            del want32, want_lse
            row_err = {n: grad_row_err(g, w)
                       for n, g, w in zip(names, got, want)}
            exact = flash_attention_bwd_ref(
                *(t.float() for t in (q, k, v, out, dout)), **kw)
            rms = {n: grad_rms_err(g, w) for n, g, w in zip(names, got, exact)}
            plain_rms = {n: grad_rms_err(g, w)
                         for n, g, w in zip(names, want, exact)}
            exact_row_err = {n: grad_row_err(g, w)
                             for n, g, w in zip(names, got, exact)}
            plain_exact_row_err = {n: grad_row_err(g, w)
                                   for n, g, w in zip(names, want, exact)}
            del exact
        del want
        if pos is None:
            pairs = B * live_pairs(S, causal, window)
        else:
            srt = np.sort(mrope_positions(S))
            pairs = int(np.searchsorted(srt, mrope_positions(S),
                                        side="right").sum())
        flops = 10 * H * D * pairs           # five products of 2 pairs D
        # q, dout, dq and k, v, dk, dv in the inputs' dtype; the output
        # (bf16: its fp32 copy and the rows' fp32 logsumexp) and positions
        nbytes = B * ((3 * H + 4 * KV) * S * D * q.element_size() +
                      4 * H * S * D +
                      (4 * H * S if dtype == "bfloat16" else 0)) + \
            (S * 4 if pos is not None else 0)
        b_ms, b_by = bound(nbytes, flops, FLOPS_PER_S[dtype])
        call = partial(K.attend_bwd, q, k, v, out, dout, **kw_stats)
        slow = B * S * H >= 8192 * 16
        row = {"name": "flash_attention_bwd", "variant": variant,
               "shape": [B, S, H, KV, D], "dtype": dtype,
               "causal": causal, "window": window, "softcap": cap,
               "positions": by_pos, "q_scale": q_scale,
               "kv_splits": K.kv_splits(B, KV, S, H // KV, sms,
                                        K.bwd_key_tile(q.dtype)),
               "launches": launched,
               "max_abs_err": max(err.values()), "abs_err": err,
               "rel_err": rel, "row_scaled_err": row_err,
               "fp32_plain_row_scaled_err": exact_row_err,
               "plain_fp32_row_scaled_err": plain_exact_row_err,
               "rms_err": rms, "plain_rms_err": plain_rms,
               "rms_err_ratio": rms and {
                   n: rms[n] / max(plain_rms[n], 1e-30) for n in names},
               "lse_rel_err": lse_err, "out32_row_scaled_err": out32_err,
               "bitwise_repeatable": bitwise}
        faults = bwd_row_faults(row)
        if faults:
            raise AssertionError(f"flash_attention backward {variant}: "
                                 f"{'; '.join(faults)}")
        row.update({
            "ms": cuda_ms(call, 3 if slow else 10),
            "plain_ms": cuda_ms(partial(flash_attention_bwd_ref, q, k, v,
                                        out, dout, **kw), 2),
            **kernel_device_ms(call, 3 if slow else 5, "flash_bwd_"),
            "bound_ms": b_ms, "bound_by": b_by, "live_pairs": pairs,
            "flops": flops, "bytes": nbytes})
        row["bound_share"] = b_ms / row["ms"]
        t = time.perf_counter()
        try:
            name, library, lib_grads = bwd_library_call(
                q, k, v, dout, causal, window, cap, pos)
            row["library"] = name
            row["library_rel_diff"] = {
                n: float((a.float() - g.float()).abs().max()
                         / g.float().abs().max())
                for n, a, g in zip(names, lib_grads, got)}
            del lib_grads
            row["library_ms"] = cuda_ms(library, 3 if slow else 10)
        except Exception as e:              # a yardstick, not the port
            row.update(library=None, library_ms=None,
                       library_error=f"{type(e).__name__}: {e}"[:300])
        row["library_setup_s"] = time.perf_counter() - t
        rows.append(row)
        del q, k, v, dout, out, got, kw_stats
        library = None
        torch.cuda.empty_cache()
    return rows


def ssd_inputs(B: int, S: int, dtype, seed: int, H: int = SSD_HEADS):
    """tests/test_kernels.py's distribution, drawn on the card: x, B, C, D
    ~ N(0, 1), dt in [0.01, 0.2], A in [-2, -0.5]; xh is the [B,S,H,P]
    view of a [B,S,H*P] tensor, as ssm_forward passes it."""
    import torch
    P, N = SSD_HEAD_DIM, SSD_STATE
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def uniform(lo, hi, *shape):
        return (torch.rand(shape, generator=g, device="cuda")
                * (hi - lo) + lo).to(dtype)

    return (normal(B, S, H * P).view(B, S, H, P), uniform(0.01, 0.2, B, S, H),
            -uniform(0.5, 2.0, H), normal(B, S, N), normal(B, S, N),
            normal(H))


def ssd_ops(B: int, S: int, H: int = SSD_HEADS) -> int:
    """c^2 N per (batch, chunk): C.B^T on the lower triangle (B and C have
    no head axis, so the function needs it once, however many heads the
    kernel recomputes it for); c^2 P + 4 c P N per (batch, head, chunk):
    scores.x on the lower triangle, C.h^T and the state update."""
    c, P, N = SSD_CHUNK, SSD_HEAD_DIM, SSD_STATE
    return B * (S // c) * (c * c * N + H * (c * c * P + 4 * c * P * N))


def ssd_rows(seed: int):
    """ssd_scan against its plain version at mamba2-780m's widths (48
    heads of 64, state 128, chunk 256) and at jamba-1.5-large-398b's 256
    heads.  No single PyTorch call computes the SSD scan, so there is no
    library yardstick."""
    import torch
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.kernels.ssd_scan.ssd_scan import wgmma_path

    rows = []
    for i, (variant, dtype, B, S, tol, H) in enumerate(SSD_ROWS):
        args = ssd_inputs(B, S, getattr(torch, dtype), seed + i, H)
        y, h = SS.ssd_scan(*args, chunk=SSD_CHUNK)
        torch.cuda.synchronize()
        want_y, want_h = ssd_chunked(*(a.float() for a in args), SSD_CHUNK)
        err = {}
        for key, got, want in (("y", y, want_y), ("h_final", h, want_h)):
            err[key] = float((got.float() - want).abs().max()
                             / want.abs().max())
            err[f"max_abs_{key}"] = float(want.abs().max())
        abs_err = float((y.float() - want_y).abs().max())
        del want_y, want_h
        torch.cuda.empty_cache()
        if not (err["y"] < tol and err["h_final"] < tol):
            raise AssertionError(f"ssd_scan {variant} disagrees with its "
                                 f"plain version: {err} (tolerance {tol})")
        elem = args[0].element_size()
        nbytes = (2 * B * S * H * SSD_HEAD_DIM + B * S * H
                  + 2 * B * S * SSD_STATE + 2 * H) * elem \
            + B * H * SSD_HEAD_DIM * SSD_STATE * 4
        nops = ssd_ops(B, S, H)
        b_ms, b_by = bound(nbytes, nops, FLOPS_PER_S[dtype])
        kern = partial(SS.ssd_scan, *args, chunk=SSD_CHUNK)
        plain = partial(ssd_chunked, *args, SSD_CHUNK)
        rows.append({"name": "ssd_scan", "variant": variant,
                     "shape": [B, S, H, SSD_HEAD_DIM, SSD_STATE],
                     "chunk": SSD_CHUNK, "dtype": dtype,
                     "path": wgmma_path(args[0], args[3], args[4],
                                        SSD_CHUNK),
                     "max_abs_err": abs_err, "rel_err": err, "tol": tol,
                     "ms": cuda_ms(kern, 5), "plain_ms": cuda_ms(plain, 2),
                     **kernel_device_ms(kern, 5, SSD_KERNELS),
                     "bound_ms": b_ms, "bound_by": b_by, "flops": nops,
                     "bytes": nbytes, "library": None, "library_ms": None})
        del args, y, h, kern, plain
        torch.cuda.empty_cache()
    return rows


def ssd_bwd_ops(B: int, S: int) -> int:
    """The products the SSD gradient needs, on the (c/64)(c/64 + 1)/2
    64 x 64 tile pairs at or below each chunk's diagonal: per (batch,
    chunk) C B^T, and dCB B and dCB^T C taken once on the heads' sum of dCB
    (B and C are shared by the heads; N deep); per (batch, chunk, head)
    dy x^T and scores^T dy (P deep), and dy h, x dS, B dS and pass (a)'s
    exp(acs) dy^T C (c P N each).  The simple path's kernel takes all five
    tile products per head; the wgmma path takes C B^T once per pair but
    forms dy x^T twice and C h^T once more per head
    (csrc/ssd_scan_bwd_wgmma.cu's note)."""
    c, P, N = SSD_CHUNK, SSD_HEAD_DIM, SSD_STATE
    n = c // 64
    tiles = n * (n + 1) // 2 * 64 * 64
    macs = tiles * 3 * N + SSD_HEADS * (tiles * 2 * P + 4 * c * P * N)
    return 2 * B * (S // c) * macs


def ssd_bwd_rows(seed: int):
    """The ssd_scan backward kernel against its plain versions at
    mamba2-780m's widths (SSD_BWD_ROWS), from the forward's statistics as
    autograd's SSDScan hands them over, dh_final None (the training path):
    the gates of SSD_BWD_ROWS, two launches bitwise equal, times (each
    kernel's device ms too), bound and the share of it reached.  No
    PyTorch call computes the SSD gradient: no library yardstick."""
    import importlib

    import torch
    from repro_torch.kernels.flash_attention.ref import (
        BF16_GRAD_RMS_RATIO, BF16_GRAD_ROW_TOL, grad_rms_err, grad_row_err,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_passes_bwd
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    names = ("dxh", "ddt", "dA", "dBc", "dCc", "dD")
    paths = {"wgmma": "ssd_scan_bwd_wgmma.cu", "simple": "ssd_scan_bwd.cu"}

    def autograd_plain(args, dy):
        leaves = [a.detach().float().requires_grad_() for a in args]
        with torch.enable_grad():
            y, _ = ssd_chunked(*leaves, SSD_CHUNK)
            return torch.autograd.grad(y, leaves, dy.float())

    rows = []
    for i, (variant, dtype, B, S) in enumerate(SSD_BWD_ROWS):
        bf16 = dtype == "bfloat16"
        args = ssd_inputs(B, S, getattr(torch, dtype), seed + 10 + i)
        g = torch.Generator(device="cuda").manual_seed(seed + 20 + i)
        dy = torch.randn(args[0].shape, generator=g,
                         device="cuda").to(args[0].dtype)
        _, _, h_before = K.scan(*args, chunk=SSD_CHUNK, stats=True)
        path = K.bwd_path(args[0], args[3], args[4], dy, SSD_CHUNK)
        call = partial(K.scan_bwd, *args, dy, None, h_before,
                       chunk=SSD_CHUNK)
        K.reset_launches()
        got = call()
        again = call()
        torch.cuda.synchronize()
        launched = K.bwd_launches["ssd_scan_bwd"]
        on_path = K.bwd_path_launches[path]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        if bf16:
            plain_call = partial(ssd_passes_bwd, *args, dy, None, SSD_CHUNK,
                                 operand_dtype=torch.bfloat16, path=path)
            want = plain_call()
            exact = ssd_passes_bwd(*(a.float() for a in args), dy.float(),
                                   None, SSD_CHUNK)
            simple = ssd_passes_bwd(*args, dy, None, SSD_CHUNK,
                                    operand_dtype=torch.bfloat16)
            row_err = {n: grad_row_err(a, w)
                       for n, a, w in zip(names, got, want)}
            rms = {n: grad_rms_err(a, e) for n, a, e in zip(names, got, exact)}
            plain_rms = {n: grad_rms_err(w, e)
                         for n, w, e in zip(names, want, exact)}
            ratio = {n: rms[n] / max(plain_rms[n], 1e-30) for n in names}
            simple_ratio = {n: rms[n] / max(grad_rms_err(w, e), 1e-30)
                            for n, w, e in zip(names, simple, exact)}
            faults = [f"{n}: row {row_err[n]:.3g}" for n in names
                      if not row_err[n] <= BF16_GRAD_ROW_TOL] + \
                     [f"{n}: rms ratio {ratio[n]:.3g}" for n in names
                      if not ratio[n] <= BF16_GRAD_RMS_RATIO]
            del exact, simple
        else:
            plain_call = partial(autograd_plain, args, dy)
            want = plain_call()
            row_err = rms = plain_rms = ratio = simple_ratio = None
            faults = []
        err = {n: float((a.float() - w.float()).abs().max())
               for n, a, w in zip(names, got, want)}
        rel = {n: err[n] / max(float(w.float().abs().max()), 1e-30)
               for n, w in zip(names, want)}
        if not bf16:
            faults = [f"{n}: rel {rel[n]:.3g}" for n in names
                      if not rel[n] <= BWD_FP32_TOL]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        if faults or not bitwise or not finite or launched != 2 or \
                on_path != 2:
            raise AssertionError(
                f"ssd_scan backward {variant}: {'; '.join(faults)}; bitwise "
                f"{bitwise}, finite {finite}, launches {launched} "
                f"({on_path} on the {path} path)")
        del got, want
        torch.cuda.empty_cache()
        elem = args[0].element_size()
        H, P, N = SSD_HEADS, SSD_HEAD_DIM, SSD_STATE
        # x, dy, dx; dt, ddt; B, C, dB, dC; A, D, dA, dD; h_before (fp32)
        nbytes = (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * N
                  + 4 * H) * elem + B * (S // SSD_CHUNK) * H * P * N * 4
        nops = ssd_bwd_ops(B, S)
        b_ms, b_by = bound(nbytes, nops, FLOPS_PER_S[dtype])
        row = {"name": "ssd_scan_bwd", "variant": variant,
               "shape": [B, S, H, P, N], "chunk": SSD_CHUNK, "dtype": dtype,
               "path": path, "source": "src/repro_torch/kernels/ssd_scan/"
               f"csrc/{paths[path]}",
               "launches": launched, "max_abs_err": max(err.values()),
               "abs_err": err, "rel_err": rel, "row_scaled_err": row_err,
               "rms_err": rms, "plain_rms_err": plain_rms,
               "rms_err_ratio": ratio, "simple_rms_err_ratio": simple_ratio,
               "bitwise_repeatable": bitwise,
               "ms": cuda_ms(call, 5), "plain_ms": cuda_ms(plain_call, 2),
               **kernel_device_ms(call, 5, SSD_BWD_KERNELS),
               "bound_ms": b_ms, "bound_by": b_by, "flops": nops,
               "bytes": nbytes, "library": None, "library_ms": None}
        row["bound_share"] = b_ms / row["ms"]
        rows.append(row)
        del args, dy, h_before, call, plain_call
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

def values_for(seed: int, n: int, tag: str):
    """``n`` distinct 64-byte string values made from ``seed``: the tag, the
    index in hex, and random hex filler."""
    import numpy as np
    hexed = np.random.default_rng([seed, *tag.encode()]).bytes(
        VALUE_BYTES * n // 2).hex()
    head = len(tag) + 8
    return [f"{tag}{i:08x}" + hexed[i * VALUE_BYTES + head:
                                    (i + 1) * VALUE_BYTES]
            for i in range(n)]


def converged(c) -> bool:
    """Every shard's replica set agrees on digest and value roots."""
    for s, owners in enumerate(c._placement):
        roots = {(c.nodes[n].shard_stores[s].digest_root(),
                  c.nodes[n].shard_stores[s].value_root()) for n in owners}
        if len(roots) != 1:
            return False
    return True


def run_schedule(n_keys: int, seed: int, *, device="cuda",
                 use_kernel=True, max_rounds: int = 4):
    """The store phase's schedule; returns the cluster, the reads, the
    expected value set per key and seconds per step."""
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.store import KVClient, KVCluster, SimNetwork

    secs = {}
    c = KVCluster(NODES, DVV_MECHANISM, replication=3, read_quorum=2,
                  write_quorum=2, shards=64, seed=seed,
                  network=SimNetwork(seed=seed), device=device)
    cl = KVClient(c, "smoke", via="n0", use_kernel=use_kernel)
    keys = [f"key-{i:08d}" for i in range(n_keys)]
    vals = values_for(seed, n_keys, "v0-")
    expect = {k: {v} for k, v in zip(keys, vals)}

    t = time.perf_counter()
    acked = 0
    for i in range(0, n_keys, BATCH):
        acked += len(cl.put_many(dict(zip(keys[i: i + BATCH],
                                          ((v, None) for v in
                                           vals[i: i + BATCH])))))
    c.deliver_replication()
    secs["put"] = time.perf_counter() - t

    # Fork 10% of the keys: those whose replicas sit on both sides.  Each
    # side overwrites them with the pre-partition context, so both writes
    # supersede the first value and neither sees the other.
    t = time.perf_counter()
    forked = [k for k in keys if SIDE_A & set(c.replicas_for(k))
              and SIDE_B & set(c.replicas_for(k))][: n_keys // 10]
    ctx = {}
    for i in range(0, len(forked), BATCH):
        ctx.update({k: r.context for k, r in
                    cl.get_many(forked[i: i + BATCH], quorum=2).items()})
    c.network.partition(SIDE_A, SIDE_B)
    sides = {via: values_for(seed, len(forked), tag)
             for via, tag in (("n0", "a-"), ("n2", "b-"))}
    for via, fvals in sides.items():
        for i in range(0, len(forked), BATCH):
            part = forked[i: i + BATCH]
            acked += len(cl.put_many(
                {k: (v, ctx[k]) for k, v in zip(part, fvals[i: i + BATCH])},
                via=via, quorum=1))
    for k, a, b in zip(forked, sides["n0"], sides["n2"]):
        expect[k] = {a, b}
    c.deliver_replication()
    c.network.heal()
    secs["fork"] = time.perf_counter() - t

    t = time.perf_counter()
    rounds = 0
    while not converged(c):
        if rounds == max_rounds:
            raise AssertionError(f"not converged after {rounds} rounds")
        c.delta_antientropy_round(use_kernel=use_kernel, max_ranges=None)
        rounds += 1
    secs["heal"] = time.perf_counter() - t

    t = time.perf_counter()
    reads = {}
    for i in range(0, n_keys, BATCH):
        reads.update(cl.get_many(keys[i: i + BATCH], quorum=2))
    secs["read"] = time.perf_counter() - t
    return c, keys, forked, expect, reads, acked, rounds, secs


def check_reads(keys, expect, reads) -> None:
    """Every acknowledged write is read back, and nothing else: a forked
    key shows exactly its two siblings, any other key its one value."""
    for k in keys:
        if set(reads[k].values) != expect[k] or \
                reads[k].siblings != len(expect[k]):
            raise AssertionError(f"{k}: read {reads[k].values}, "
                                 f"expected {sorted(expect[k])}")


def store_phase(n_keys: int, seed: int, device="cuda"):
    from repro_torch.kernels import dvv_ops
    from repro_torch.kernels.dvv_ops.dvv_ops import path_launches

    fronts = {"sync_mask": dvv_ops.dvv_sync_mask_bucketed(device),
              "read_sweep": dvv_ops.dvv_read_sweep_bucketed(device)}
    copies0 = {k: (f.h2d_copies, f.d2h_copies) for k, f in fronts.items()}
    dvv_ops.reset_launches()
    c, keys, forked, expect, reads, acked, rounds, secs = run_schedule(
        n_keys, seed, device=device)
    launches = dict(dvv_ops.launches)
    paths = dict(path_launches)
    check_reads(keys, expect, reads)
    if c.device.type == "cuda":
        for name in ("dvv_sync_mask", "dvv_read_sweep"):
            if launches[name] == 0:
                raise AssertionError(f"{name} never launched in the store "
                                     f"phase: {launches}")
    return {"phase": "store", "keys": n_keys, "forked": len(forked),
            "acked_writes": acked, "delta_rounds": rounds,
            "seconds": secs, "launches": launches, "path_launches": paths,
            "front_end_copies": {
                k: {"h2d": f.h2d_copies - copies0[k][0],
                    "d2h": f.d2h_copies - copies0[k][1]}
                for k, f in fronts.items()},
            "buckets": {
                "sync_mask": dvv_ops.dvv_sync_mask_bucketed(device)
                .cache_info(),
                "read_sweep": dvv_ops.dvv_read_sweep_bucketed(device)
                .cache_info()}}


def parity_phase(n_keys: int, seed: int, device="cuda"):
    runs = {}
    for use_kernel in (True, False):
        c, keys, forked, expect, reads, _, _, _ = run_schedule(
            n_keys, seed, device=device, use_kernel=use_kernel)
        check_reads(keys, expect, reads)
        runs[use_kernel] = (
            store_roots(c),
            {k: (r.values, r.context.to_bytes(), r.resolution)
             for k, r in reads.items()})
    if runs[True][0] != runs[False][0]:
        raise AssertionError("store roots differ between kernel and twin")
    if runs[True][1] != runs[False][1]:
        raise AssertionError("reads differ between kernel and twin")
    return {"phase": "parity", "keys": n_keys,
            "stores_compared": len(runs[True][0]),
            "reads_compared": len(runs[True][1])}


def traced_dvv_kernels(per):
    """Launches and device microseconds per launch of each dvv_ops kernel
    in a trace's device events."""
    kernels = {}
    for name in DVV_KERNELS:
        hits = [(n, us) for key, (n, us) in per.items()
                if kernel_name(key, name)]
        n = sum(c for c, _ in hits)
        kernels[name] = {"launches": n, "device_us_per_launch":
                         sum(us for _, us in hits) / n if n else None}
    return kernels


def top_device_events(per, n: int = 8):
    return sorted(({"name": k[:80], "count": c, "us": us}
                   for k, (c, us) in per.items()), key=lambda e: -e["us"])[:n]


def trace_phase(n_keys: int, seed: int):
    """The store schedule once more, traced on the card alone: how busy
    the device was over the run's wall time, and per-launch device time
    of each dvv_ops kernel at the main path's own shapes.  The sweeps are
    the front ends' own launch counts (zeroed just before the schedule),
    so that a trace which loses events can only read fewer copies, never
    more copies than sweeps."""
    from repro_torch.kernels import dvv_ops

    dvv_ops.reset_launches()
    busy_us, per, wall_s = device_profile(lambda: run_schedule(n_keys, seed))
    sweeps = sum(dvv_ops.launches.values())
    kernels = traced_dvv_kernels(per)
    copies = {way: sum(c for key, (c, _) in per.items()
                       if key.startswith(f"Memcpy {way}"))
              for way in ("HtoD", "DtoH")}
    if not sweeps or any(n > sweeps for n in copies.values()):
        raise AssertionError(f"{copies} copies for {sweeps} sweeps: the "
                             f"front ends make one each way a sweep")
    return {"phase": "trace", "keys": n_keys, "wall_s": wall_s,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / 1e6 / wall_s
            if busy_us else None,
            "kernels": kernels, "sweeps": sweeps,
            "sweeps_traced": sum(k["launches"] for k in kernels.values()),
            "copies": copies,
            "copies_per_sweep": {k: n / sweeps for k, n in copies.items()},
            "top_device_events": top_device_events(per)}


def store_roots(c):
    """Every store's digest and value roots, by (node, shard)."""
    return {(n, s): (st.digest_root(), st.value_root())
            for n, node in c.nodes.items()
            for s, st in enumerate(node.shard_stores)}


def record_acks(client, mode: str):
    """Wrap the engine's client so that every acknowledged PUT is recorded:
    returns ``{key: value of its last acknowledged put}``, filled as the
    run goes.  Coalesced puts are acknowledged when their op completes
    without error (ops complete in submission order), direct puts when
    put_many returns."""
    acked = {}

    def note(items):
        acked.update((k, v) for k, (v, _) in items.items())

    if mode == "coalesced":
        submit = client.submit_put

        def submit_put(items, **kw):
            op = submit(items, **kw)
            op.on_done(lambda op: op.error is None and note(op.items))
            return op
        client.submit_put = submit_put
    else:
        put_many = client.put_many

        def put(items, **kw):
            acks = put_many(items, **kw)
            note(items)
            return acks
        client.put_many = put
    return acked


def workload_run(args, mode: str, *, use_kernel=True):
    """One mode of the store workload; returns its summary (with gossip
    rounds and wire bytes), the DVV kernels' launches in the run, the
    cluster, the still-running gossip driver and the acknowledged puts."""
    from repro_torch.kernels import dvv_ops
    from repro_torch.launch.serve import store_workload

    cluster, driver, eng = store_workload(mode, args, use_kernel=use_kernel)
    acked = record_acks(eng.client, mode)
    dvv_ops.reset_launches()
    out = eng.run(args.store_steps)
    launches = dict(dvv_ops.launches)
    out["gossip"] = {"rounds": driver.rounds,
                     "wire_bytes": driver.wire_bytes()}
    return out, launches, cluster, driver, acked


def converge(c, advance: float, max_steps: int = 100) -> float:
    """Drain replication, then advance simulated time in ``advance`` steps
    (gossip or WAN shipping run on its timers) until every live node holds
    the same state; returns the simulated ticks it took."""
    from repro_torch.store import cluster_converged
    t0 = c.network.now
    c.deliver_replication()
    for _ in range(max_steps):
        if cluster_converged(c):
            return c.network.now - t0
        c.network.advance(advance)
        c.deliver_replication()
    raise AssertionError(f"not converged after {max_steps} steps of "
                         f"{advance} ticks")


def quorum_read(c, keys, via: str, use_kernel=True):
    from repro_torch.store import KVClient
    cl = KVClient(c, "reader", via=via, use_kernel=use_kernel)
    reads = {}
    for i in range(0, len(keys), BATCH):
        reads.update(cl.get_many(keys[i: i + BATCH], quorum=2))
    return reads


def store_workload_phase(seed: int, device="cuda"):
    """The closed-loop store workload in both modes on the card, each held
    against its numpy-twin rerun, then read back after convergence; then
    a traced coalesced run.  ``seed`` is added to the launcher's default
    workload seed."""
    from repro_torch.launch.serve import parse_args, store_workload

    t0 = time.perf_counter()
    args = parse_args([*WORKLOAD_ARGV, "--device", str(device)])
    args.seed += seed
    out = {"phase": "store_workload", "argv": list(WORKLOAD_ARGV),
           "seed": args.seed, "modes": {}}
    for mode in ("coalesced", "direct"):
        summary, launches, c, driver, acked = workload_run(args, mode)
        if summary["ops_failed"]:
            raise AssertionError(f"{mode}: {summary['ops_failed']} ops "
                                 f"failed")
        if c.device.type == "cuda":
            for name in ("dvv_sync_mask", "dvv_read_sweep"):
                if launches[name] == 0:
                    raise AssertionError(f"{mode}: {name} never launched: "
                                         f"{launches}")
        twin, twin_launches, tc, tdriver, _ = workload_run(
            args, mode, use_kernel=False)
        tdriver.stop()
        if any(twin_launches.values()):
            raise AssertionError(f"the numpy twins launched {twin_launches}")
        strip = lambda d: {k: v for k, v in d.items()
                           if k not in WALL_FIELDS}
        if strip(summary) != strip(twin):
            raise AssertionError(f"{mode}: summaries differ between kernel "
                                 f"and twin: {summary} vs {twin}")
        if store_roots(c) != store_roots(tc):
            raise AssertionError(f"{mode}: store roots differ between "
                                 f"kernel and twin")
        t = time.perf_counter()
        ticks = converge(c, driver.period)
        driver.stop()
        keys = sorted(acked)
        reads = quorum_read(c, keys, "n0")
        lost = [k for k in keys if acked[k] not in reads[k].values]
        if lost:
            raise AssertionError(f"{mode}: {len(lost)} keys lost their last "
                                 f"acknowledged put, e.g. {lost[:3]}")
        out["modes"][mode] = {
            **summary, "launches": launches,
            "twin_wall_s": twin["wall_s"],
            "converge_ticks": ticks, "keys_read_back": len(keys),
            "gossip_after_run": {"rounds": driver.rounds,
                                 "wire_bytes": driver.wire_bytes()},
            "converge_read_s": time.perf_counter() - t}

    _, driver, eng = store_workload("coalesced", args)
    busy_us, per, wall_s = device_profile(
        lambda: eng.run(WORKLOAD_TRACE_STEPS))
    driver.stop()
    out["trace"] = {"steps": WORKLOAD_TRACE_STEPS, "wall_s": wall_s,
                    "device_busy_s": busy_us / 1e6,
                    "device_idle_share": 1 - busy_us / 1e6 / wall_s
                    if busy_us else None,
                    "kernels": traced_dvv_kernels(per),
                    "top_device_events": top_device_events(per)}
    out["phase_seconds"] = time.perf_counter() - t0
    return out


def geo_schedule(n_keys: int, seed: int, *, device="cuda", use_kernel=True):
    """The geo phase's schedule; returns the cluster, the snapshot reads
    per DC, the quorum reads per DC, the expected value set per key, and
    counts and seconds along the way."""
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.store import KVClient, KVCluster, OpScheduler, \
        SimNetwork

    east, west = GEO_DCS["east"], GEO_DCS["west"]
    net = SimNetwork(seed=seed)
    net.set_latency_classes(lan=(1.0, 0.5), wan=(30.0, 10.0))
    g = KVCluster(east + west, DVV_MECHANISM, network=net, seed=seed,
                  datacenters=GEO_DCS, device=device)
    g.geo.shipper.use_kernel = use_kernel
    cl = KVClient(g, "geo", use_kernel=use_kernel)
    keys = [f"key-{i:08d}" for i in range(n_keys)]
    vals = values_for(seed, n_keys, "g0-")
    expect = {k: {v} for k, v in zip(keys, vals)}
    secs, acked = {}, 0

    t = time.perf_counter()
    half = n_keys // 2
    for via, lo, hi in (("e0", 0, half), ("w0", half, n_keys)):
        for i in range(lo, hi, BATCH):
            j = min(i + BATCH, hi)
            acked += len(cl.put_many(
                {k: (v, None) for k, v in zip(keys[i:j], vals[i:j])},
                via=via))
    ship_ticks = converge(g, g.geo.shipper.period)
    secs["put_ship"] = time.perf_counter() - t

    # every 10th key: both DCs overwrite it with its pre-cut context
    t = time.perf_counter()
    forked = keys[::10]
    ctx = {k: r.context for k, r in
           quorum_read(g, forked, "e0", use_kernel).items()}
    net.partition(set(east), set(west))
    sides = {via: values_for(seed, len(forked), tag)
             for via, tag in (("e0", "ge-"), ("w0", "gw-"))}
    for via, fvals in sides.items():
        for i in range(0, len(forked), BATCH):
            part = forked[i: i + BATCH]
            acked += len(cl.put_many(
                {k: (v, ctx[k]) for k, v in zip(part, fvals[i: i + BATCH])},
                via=via))
    for k, a, b in zip(forked, sides["e0"], sides["w0"]):
        expect[k] = {a, b}
    g.deliver_replication()
    net.advance(2 * g.geo.shipper.period)   # shipping ticks fail on the cut
    secs["fork"] = time.perf_counter() - t

    t = time.perf_counter()
    wan0 = net.wan_messages
    snaps, sched_stats = {}, {}
    for via in (east[0], west[0]):
        sched = OpScheduler(g, via=via, max_batch=GEO_SNAPSHOT_BATCH,
                            use_kernel=use_kernel)
        s = sched.session(f"snap-{via}")
        ops = [s.submit_snapshot_get(keys[i: i + GEO_SNAPSHOT_KEYS])
               for i in range(0, n_keys, GEO_SNAPSHOT_KEYS)]
        sched.flush()
        snaps[via] = {}
        for op in ops:
            snaps[via].update(op.result())
        sched_stats[via] = sched.stats()
    snapshot_wan = net.wan_messages - wan0
    secs["snapshots"] = time.perf_counter() - t

    t = time.perf_counter()
    net.heal()
    ticks0 = g.geo.wan_ticks
    heal_ticks = converge(g, g.geo.shipper.period)
    wan_ticks = g.geo.wan_ticks - ticks0
    secs["heal"] = time.perf_counter() - t

    t = time.perf_counter()
    reads = {via: quorum_read(g, keys, via, use_kernel)
             for via in (east[0], west[0])}
    secs["read"] = time.perf_counter() - t
    return {"cluster": g, "keys": keys, "first": vals, "forked": forked,
            "sides": sides,
            "expect": expect, "snaps": snaps, "reads": reads,
            "acked": acked, "sched_stats": sched_stats,
            "snapshot_wan_messages": snapshot_wan, "ship_ticks": ship_ticks,
            "heal_ticks": heal_ticks, "wan_ticks": wan_ticks, "secs": secs}


def check_snapshots(run) -> None:
    """During the cut, each DC's snapshot of a key is one value: the first
    one or this DC's own overwrite, never the other DC's."""
    for via in ("e0", "w0"):
        own = dict(zip(run["forked"], run["sides"][via]))
        for k, first in zip(run["keys"], run["first"]):
            got = run["snaps"][via][k].values
            if got not in ((first,), (own.get(k),)):
                raise AssertionError(f"snapshot of {k} at {via}: {got}")


def geo_phase(n_keys: int, seed: int, device="cuda"):
    from repro_torch.kernels import dvv_ops

    dvv_ops.reset_launches()
    t0 = time.perf_counter()
    run = geo_schedule(n_keys, seed, device=device)
    wall = time.perf_counter() - t0
    launches = dict(dvv_ops.launches)
    g = run["cluster"]
    for via in ("e0", "w0"):
        check_reads(run["keys"], run["expect"], run["reads"][via])
    check_snapshots(run)
    if run["snapshot_wan_messages"]:
        raise AssertionError(f"snapshot reads sent "
                             f"{run['snapshot_wan_messages']} WAN messages")
    for via, st in run["sched_stats"].items():
        if st["ops_failed"] or st["snapshot_calls"] != st["flushes"]:
            raise AssertionError(f"snapshot scheduler at {via}: {st}")
    if g.device.type == "cuda":
        for name in ("dvv_sync_mask", "dvv_read_sweep"):
            if launches[name] == 0:
                raise AssertionError(f"{name} never launched in the geo "
                                     f"phase: {launches}")
    twin = geo_schedule(n_keys, seed, device=device, use_kernel=False)
    if store_roots(g) != store_roots(twin["cluster"]):
        raise AssertionError("geo store roots differ between kernel and twin")
    view = lambda res: {k: (r.values, r.context.to_bytes())
                        for k, r in res.items()}
    for part in ("snaps", "reads"):
        for via in run[part]:
            if view(run[part][via]) != view(twin[part][via]):
                raise AssertionError(f"geo {part} at {via} differ between "
                                     f"kernel and twin")
    return {"phase": "geo", "keys": n_keys, "forked": len(run["forked"]),
            "acked_writes": run["acked"], "seconds": wall,
            "phase_seconds": time.perf_counter() - t0,
            "step_seconds": run["secs"], "launches": launches,
            "snapshot_wan_messages": run["snapshot_wan_messages"],
            "snapshot_schedulers": run["sched_stats"],
            "ship_ticks": run["ship_ticks"], "heal_ticks": run["heal_ticks"],
            "heal_wan_ticks": run["wan_ticks"],
            "wan_ticks": g.geo.wan_ticks, "wan_rounds": g.geo.wan_rounds,
            "ship_bytes": g.geo.ship_bytes,
            "wan_messages": g.network.wan_messages}


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def requests(cfg, n: int, tokens: int, seed: int):
    import numpy as np
    from repro_torch.launch.serve import Request
    prompts = np.random.default_rng([seed, n]).integers(0, cfg.vocab_size, n)
    return [Request(rid=i, prompt_token=int(p), max_tokens=tokens)
            for i, p in enumerate(prompts)]


def prefill_launches(cfg) -> dict:
    """The launches a forward of ``cfg`` asks of each kernel it runs: one
    flash_attention an attention layer, one ssd_scan a Mamba layer (the
    pattern's count times the groups); a kernel it does not run is left
    out."""
    n = {"flash_attention": sum(s.mixer.startswith("attn")
                                for s in cfg.pattern),
         "ssd_scan": sum(s.mixer == "mamba" for s in cfg.pattern)}
    return {k: v * cfg.n_groups for k, v in n.items() if v}


def model_kernels():
    """The model kernels' packages by counter name."""
    from repro_torch.kernels import flash_attention as FA, ssd_scan as SS
    return {"flash_attention": FA, "ssd_scan": SS}


def reset_model_kernels() -> None:
    for k in model_kernels().values():
        k.reset_launches()


def model_launches(names) -> dict:
    """The launch counts of the model kernels ``names``."""
    kernels = model_kernels()
    return {n: kernels[n].launches[n] for n in names}


def model_phase(cfg, params, seed: int, *, phase="model",
                tokens=(1, PREFILL_TOKENS)):
    """Prefill and serve ``cfg`` on the card through the port's entry
    points; the launch counters are zeroed just before each run and read
    just after.  Each prefill must launch each kernel as often as
    ``prefill_launches`` says (a hybrid both), the SSD scan on its wgmma
    path."""
    import torch
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.kernels import decode_attention as DA, dvv_ops
    from repro_torch.kernels.ssd_scan.ssd_scan import path_launches
    from repro_torch.launch.serve import BatchScheduler, serve_requests
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.store import KVCluster, SimNetwork

    expect = prefill_launches(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, tokens, generator=gen,
                         device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    out = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
           "param_bytes": tree_bytes(params),
           "prefill_tokens": list(tokens)}
    secs, launches, paths = [], [], []
    for _ in ("warm-up", "timed"):
        torch.cuda.reset_peak_memory_stats()
        reset_model_kernels()
        t = time.perf_counter()
        with moe_calls() as calls:
            logits = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        launches.append(model_launches(expect))
        paths.append(dict(path_launches))
        peak = torch.cuda.max_memory_allocated()   # before the checks' own
        if tuple(logits.shape) != (*tokens, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()) or \
                (cfg.final_softcap and
                 float(logits.abs().max()) > cfg.final_softcap):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"are not finite or exceed the softcap")
        del logits
    ssd_paths = {"wgmma": expect.get("ssd_scan", 0), "simple": 0}
    if launches != [expect] * 2 or paths != [ssd_paths] * 2:
        raise AssertionError(f"launches per prefill {launches}, SSD scan "
                             f"paths {paths}, expected {expect} and "
                             f"{ssd_paths}")
    n_tok = tokens[0] * tokens[1]
    out.update({"prefill_s": {"warm_up": secs[0], "timed": secs[1]},
                "prefill_tokens_per_s": n_tok / secs[1],
                **{f"{n}_launches": c for n, c in launches[1].items()},
                "prefill_peak_bytes": peak})
    if "ssd_scan" in expect:
        out["ssd_scan_path_launches"] = paths[1]
    if calls:                       # the timed prefill's MoE layers
        drops = [float(m["fraction_dropped"]) for _, _, m in calls]
        out["moe"] = {
            "layers": len(calls), "aux": float(sum(
                m["aux_loss"] + m["z_loss"] for _, _, m in calls)),
            "fraction_dropped": {"mean": sum(drops) / len(drops),
                                 "min": min(drops), "max": max(drops),
                                 "per_layer": drops}}
        del calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    store = KVCluster(("srv1", "srv2"), DVV_MECHANISM,
                      network=SimNetwork(seed=0))
    sched = BatchScheduler(cfg, params, SERVE_SLOTS, SERVE_MAX_LEN, store,
                           "srv1")
    queue = requests(cfg, SERVE_REQUESTS, SERVE_TOKENS, seed)
    done = list(queue)
    reset_model_kernels()
    dvv_ops.reset_launches()
    DA.reset_launches()
    t = time.perf_counter()
    steps = serve_requests(sched, queue)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    serve_launches = {**model_launches(expect), **dvv_ops.launches,
                      **DA.launches}
    if DA.launches["decode_attention"] != steps * expect.get(
            "flash_attention", 0):
        raise AssertionError(f"decode_attention launched {DA.launches} in "
                             f"{steps} steps, expected one an attention "
                             f"layer a step")
    keys = [f"session/{r.rid}" for r in done]
    reads = store.get_many(keys, via="srv1")
    for r in done:
        got = reads[f"session/{r.rid}"].values
        if len(got) != 1 or json.loads(got[0])["tokens"] != r.generated \
                or len(r.generated) != SERVE_TOKENS:
            raise AssertionError(f"session/{r.rid} read back {got}, "
                                 f"expected {r.generated}")
    # a step reads every parameter at least once (the MoE's one-hot
    # dispatch every expert's, a tied head the whole embedding); the
    # decode_attention kernel reads the cache's live keys only, which
    # grow from none
    floor = out["param_bytes"]
    out.update(serve={
        "requests": SERVE_REQUESTS, "tokens_each": SERVE_TOKENS,
        "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
        "decode_steps": steps, "seconds": serve_s,
        "s_per_decode_step": serve_s / steps,
        "cache_bytes": tree_bytes(sched.cache),
        "bytes_floor_per_step": floor,
        "floor_s_per_step": floor / HBM_BYTES_PER_S,
        "tokens_per_s": SERVE_REQUESTS * SERVE_TOKENS / serve_s,
        "launches_while_serving": serve_launches,
        "read_back_launches": {k: v - serve_launches[k]
                               for k, v in dvv_ops.launches.items()},
        "sessions_read_back": len(done)},
        serve_peak_bytes=torch.cuda.max_memory_allocated())
    return out


def model_trace_phase(cfg, params, seed: int, *, phase="model_trace",
                      tokens=(1, PREFILL_TOKENS), kernel="flash_fwd_"):
    """One prefill and TRACE_DECODE_STEPS decode steps, each traced on the
    card: device-busy seconds and the top device events, the idle share
    against the wall seconds of the same traced run (the profiler's cost on
    the host's side of each launch is in that wall time), and the device
    time and share of the hand-written kernels whose symbols contain
    ``kernel``, by kernel name."""
    import torch
    from repro_torch.launch.serve import BatchScheduler
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.store import KVCluster, SimNetwork
    from repro_torch.core import DVV_MECHANISM

    toks = torch.zeros(tokens, dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(cfg)
    sched = BatchScheduler(
        cfg, params, SERVE_SLOTS, SERVE_MAX_LEN,
        KVCluster(("srv1", "srv2"), DVV_MECHANISM,
                  network=SimNetwork(seed=0)), "srv1")
    sched.admit(requests(cfg, SERVE_SLOTS, SERVE_MAX_LEN, seed))
    out = {"phase": phase, "prefill_tokens": list(tokens),
           "decode_steps": TRACE_DECODE_STEPS}
    for name, fn in (
            ("prefill", lambda: prefill(params, {"tokens": toks})),
            ("decode", lambda: [sched.step()
                                for _ in range(TRACE_DECODE_STEPS)])):
        busy_us, per, wall_s = device_profile(fn)
        mine = {}
        for key, (c, us) in per.items():
            kname = kernel_name(key, kernel)
            if kname:
                mine[kname] = mine.get(kname, 0.0) + us / 1e6
        out[name] = {
            "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / 1e6 / wall_s
            if busy_us else None,
            "kernel_device_s": mine,
            "kernel_share": sum(mine.values()) / (busy_us / 1e6)
            if busy_us else None,
            "device_events": sum(c for c, _ in per.values()),
            "top_device_events": sorted(
                ({"name": k[:80], "count": c, "us": us}
                 for k, (c, us) in per.items()),
                key=lambda e: -e["us"])[:10]}
        torch.cuda.empty_cache()
    return out


def model_parity_phase(seed: int):
    """gemma2-9b cut to PARITY_GROUPS groups at full width, fp32 compute:
    prefill logits at every position against token-by-token decode."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache, init_params

    base = get_config(ARCH)
    cfg = replace(base, n_layers=PARITY_GROUPS * len(base.pattern),
                  compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    params = init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, PARITY_TOKENS),
                         generator=gen, device="cuda", dtype=torch.int32)
    FA.reset_launches()
    t = time.perf_counter()
    pre = make_prefill_step(cfg)(params, {"tokens": toks})[0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    launches = FA.launches["flash_attention"]
    step = make_decode_step(cfg)
    cache = init_cache(cfg, 1, PARITY_TOKENS)
    errs = torch.empty(PARITY_TOKENS, device="cuda")
    t = time.perf_counter()
    for i in range(PARITY_TOKENS):
        logits, cache = step(params, cache, toks[:, i], i)
        errs[i] = (logits[0] - pre[i]).abs().max()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    err = float(errs.max())
    out = {"phase": "model_parity", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype, "tokens": PARITY_TOKENS,
           "flash_attention_launches": launches,
           "max_abs_logit_diff": err,
           "max_abs_logit_diff_past_window": float(
               errs[base.sliding_window:].max()),
           "tol": PREFILL_DECODE_TOL, "prefill_s": prefill_s,
           "decode_s_per_token": decode_s / PARITY_TOKENS}
    if launches != cfg.n_layers:
        raise AssertionError(f"parity prefill launched flash_attention "
                             f"{launches} times, expected {cfg.n_layers}")
    if not err <= PREFILL_DECODE_TOL:
        raise AssertionError(f"prefill and decode logits differ by {err} > "
                             f"{PREFILL_DECODE_TOL}")
    return out


def ssm_parity_phase(seed: int):
    """mamba2-780m cut to SSM_PARITY_LAYERS layers at full width, fp32
    compute: prefill logits of SSM_PARITY_TOKENS tokens (four chunks, so
    the state crosses chunk boundaries in the kernel) against the same
    tokens fed one by one through decode_step (decode_ssm's recurrence)."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache, init_params

    cfg = replace(get_config(SSM_ARCH), n_layers=SSM_PARITY_LAYERS,
                  compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    params = init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, SSM_PARITY_TOKENS),
                         generator=gen, device="cuda", dtype=torch.int32)
    SS.reset_launches()
    t = time.perf_counter()
    pre = make_prefill_step(cfg)(params, {"tokens": toks})[0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    launches = SS.launches["ssd_scan"]
    step = make_decode_step(cfg)
    cache = init_cache(cfg, 1, SSM_PARITY_TOKENS)
    errs = torch.empty(SSM_PARITY_TOKENS, device="cuda")
    t = time.perf_counter()
    for i in range(SSM_PARITY_TOKENS):
        logits, cache = step(params, cache, toks[:, i], i)
        errs[i] = (logits[0] - pre[i]).abs().max()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    err = float(errs.max())
    out = {"phase": "ssm_parity", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype, "tokens": SSM_PARITY_TOKENS,
           "chunk": cfg.ssm_chunk, "ssd_scan_launches": launches,
           "max_abs_logit_diff": err,
           "max_abs_logit_diff_per_chunk": [
               float(errs[i:i + cfg.ssm_chunk].max())
               for i in range(0, SSM_PARITY_TOKENS, cfg.ssm_chunk)],
           "max_abs_logit": float(pre.abs().max()),
           "tol": PREFILL_DECODE_TOL, "prefill_s": prefill_s,
           "decode_s_per_token": decode_s / SSM_PARITY_TOKENS}
    if launches != cfg.n_layers:
        raise AssertionError(f"parity prefill launched ssd_scan {launches} "
                             f"times, expected {cfg.n_layers}")
    if not err <= PREFILL_DECODE_TOL:
        raise AssertionError(f"prefill and decode logits differ by {err} > "
                             f"{PREFILL_DECODE_TOL}")
    return out


# ---------------------------------------------------------------------------
# qwen3-moe-30b-a3b
# ---------------------------------------------------------------------------

@contextmanager
def moe_calls(keep_inputs: bool = False):
    """Wrap the LM's ``moe_ffn`` (``repro_torch.models.lm`` calls it by
    that name): each call appends (its parameters, its input if
    ``keep_inputs``, its metrics) to the yielded list and returns what the
    port's function returned.  Adds no device work."""
    from repro_torch.models import lm

    calls, original = [], lm.moe_ffn

    def recording(params, x, spec):
        out, metrics = original(params, x, spec)
        calls.append((params, x if keep_inputs else None, metrics))
        return out, metrics

    lm.moe_ffn = recording
    try:
        yield calls
    finally:
        lm.moe_ffn = original


def kernel_class(name: str) -> str:
    """A device kernel's class: the SSD scan's (forward and backward), the
    flash forward's, the flash backward's, cuBLAS's GEMMs or the rest."""
    low = name.lower()
    return "ssd_scan" if SSD_KERNELS in low else \
        "flash_attention" if "flash_fwd" in low else \
        "flash_attention_bwd" if "flash_bwd" in low else \
        "gemm" if any(g in low for g in GEMM_KERNELS) else "other"


def lm_breakdown(fn, cfg, decode: bool = False):
    """``fn`` (warmed by the caller: a prefill or a training step of
    ``cfg``, or with ``decode`` a decode step) traced with the host's ops
    and the port's own spans on (``repro_torch.runtime.tracing``): device
    microseconds by part and by kernel class.  A span holds the kernels
    its host ops launched, spans inside it included: the forward's, and in
    a training step remat's recompute, never the backward's, which falls
    in "rest".  The hand-written kernels, launched through ctypes, are
    recorded under no host op, so the SSD scan's and flash's (forward and
    backward) are counted by kernel name, and the attention's span and,
    where ``cfg`` has Mamba layers, the Mamba mixer's are split by kernel
    class."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import tracing

    spans = {
        "attention": "lm.decode_attention" if decode else "lm.attention",
        "moe.route": "lm.moe.route", "moe.assign": "lm.moe.assign",
        "moe.experts": "lm.moe.experts", "moe.ffn": "lm.moe",
        "mlp": "lm.mlp", "head": "lm.head"}
    if cfg.has_ssm:
        spans["mamba"] = "lm.mamba"
    torch.cuda.synchronize()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        tracing.disable()
        tracing.drain()

    def kernels_under(e):
        yield from e.kernels
        for child in e.cpu_children:
            yield from kernels_under(child)

    zero = dict.fromkeys(("ssd_scan", "flash_attention",
                          "flash_attention_bwd", "gemm", "other"), 0.0)
    part_of = {name: part for part, name in spans.items()}
    ranges = {part: dict(zero) for part in spans}
    for e in prof.events():
        if e.name in part_of and e.device_type == DeviceType.CPU:
            for k in kernels_under(e):
                ranges[part_of[e.name]][kernel_class(k.name)] += k.duration
    classes = dict(zero)
    for e in prof.key_averages():
        us = e.self_device_time_total
        # the kernels' own rows: not the host ops that launched them, nor
        # the spans' device-side rows
        if us > 0 and e.device_type == DeviceType.CUDA and \
                not e.key.startswith("lm."):
            classes[kernel_class(e.key)] += us
    busy = sum(classes.values())
    total = {t: sum(c.values()) for t, c in ranges.items()}
    attn = ranges["attention"]
    parts = {"flash_attention": classes["flash_attention"],
             "flash_attention_bwd": classes["flash_attention_bwd"],
             "attention_rest": attn["gemm"] + attn["other"],
             "router": total["moe.route"],
             "capacity_assignment": total["moe.assign"],
             "expert_products": total["moe.experts"],
             "dispatch_combine_products_and_losses": total["moe.ffn"]
             - total["moe.route"] - total["moe.assign"]
             - total["moe.experts"],
             "dense_mlps": total["mlp"], "head": total["head"]}
    if cfg.has_ssm:
        mixer = ranges["mamba"]
        parts.update(ssd_scan_kernels=classes["ssd_scan"],
                     mamba_projection_gemms=mixer["gemm"],
                     mamba_plain_torch=mixer["other"])
    parts["rest"] = busy - sum(parts.values())
    return {"device_busy_us": busy, "by_part_us": parts,
            "by_part_share": {k: v / busy for k, v in parts.items()}
            if busy else None,
            "by_kernel_class_us": classes}


def moe_prefill_breakdown(cfg, params, tokens):
    """``lm_breakdown`` of one prefill of zero tokens ``tokens`` after an
    untraced one."""
    import torch
    from repro_torch.launch.steps import make_prefill_step

    toks = torch.zeros(tokens, dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": toks})                 # warm, untraced
    return lm_breakdown(lambda: prefill(params, {"tokens": toks}), cfg)


def moe_train_phases(seed: int):
    """Run and emit moe_train (qwen3-moe-30b-a3b cut to MOE_TRAIN_LAYERS,
    through the Trainer) and moe_train_parity (its 2-layer cut, fp32 only:
    bf16 near-ties turn expert pairs, ROADMAP Queue 3); returns the
    moe_train line (the kernels line reads its launches)."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    moe_train = train_phase(
        seed, cfg=replace_layers(cfg, MOE_TRAIN_LAYERS), phase="moe_train",
        save=False, trace=moe_train_trace)
    emit(moe_train)
    emit(grad_parity_phase(
        "moe_train_parity", replace_layers(cfg, MOE_PARITY_LAYERS),
        (1, TRAIN_PARITY_TOKENS), seed, dtypes=("float32",)))
    return moe_train


def moe_train_trace(trainer):
    """One more step of ``trainer`` traced by ``lm_breakdown`` (device
    time by MoE part in the forward and its recompute, and by kernel
    class, the flash backward's included), with every MoE layer's
    fraction_dropped in that step's forward."""
    cfg = trainer.model_cfg
    n_moe = cfg.n_groups * sum(s.ffn == "moe" for s in cfg.pattern)
    with moe_calls() as calls:
        out = lm_breakdown(lambda: trainer.run(steps=1), cfg)
    # the forward's calls: remat's recompute stops inside a group's last
    # MoE call once the tensors the backward saved are back (torch's
    # non-reentrant checkpoint), so those calls never return
    out["moe_calls"] = len(calls)
    out["fraction_dropped_per_layer"] = [
        float(m["fraction_dropped"]) for _, _, m in calls[:n_moe]]
    return out


def recount_dropped(idx, n_experts: int, C: int):
    """fraction_dropped recounted on the host from the chosen experts
    ``idx`` [G,S,K] (numpy): slot by slot, token by token, an expert keeps
    its first C assignments, its count running on across slots.  Returns
    (fraction as float32, kept)."""
    import numpy as np
    G, S, K = idx.shape
    kept = 0
    for g in range(G):
        used = np.zeros(n_experts, np.int64)
        for k in range(K):
            for e in idx[g, :, k]:
                kept += int(used[e] < C)
                used[e] += 1
    return np.float32(1) - np.float32(kept) / np.float32(G * S * K), kept


def moe_parity_phase(phase: str, cfg, tokens, seed: int, *,
                     plain: bool = False,
                     decode_tokens: int = MOE_PARITY_TOKENS,
                     capacity_factor=None):
    """``cfg`` (a MoE config cut at full width; fp32 here): (a) prefill
    logits of ``decode_tokens`` tokens against token-by-token decode, at
    ``capacity_factor`` where given (else the config's), whose capacity
    for a group of that many tokens must hold them all, so that nothing
    drops on either side; then one prefill of ``tokens`` through the
    kernels: with ``plain``, (b) its logits against the same prefill
    through the plain versions on the card; and (c) its first MoE layer's
    fraction_dropped against the host's recount over the experts the
    card's router chose.  MOE_PARITY_TOLS bound (a) and (b); every
    prefill launches each kernel as ``prefill_launches`` says."""
    from dataclasses import replace

    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.lm import moe_spec
    from repro_torch.models.moe import capacity, route

    expect = prefill_launches(cfg)

    def launched():
        return {f"{n}_launches": c for n, c in model_launches(expect).items()}

    dec_cfg = replace(cfg, capacity_factor=capacity_factor or
                      cfg.capacity_factor)
    spec, dec_spec = moe_spec(cfg), moe_spec(dec_cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    params = init_params(gen, cfg)
    S = decode_tokens
    if capacity(S, dec_spec) < S:
        raise AssertionError(f"a group of {S} tokens can drop: capacity "
                             f"{capacity(S, dec_spec)}")
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    reset_model_kernels()
    pre = make_prefill_step(dec_cfg)(params, {"tokens": toks})[0]
    launches = launched()
    step = make_decode_step(dec_cfg)
    cache = init_cache(dec_cfg, 1, S)
    errs = torch.stack([(step(params, cache, toks[:, i], i)[0][0]
                         - pre[i]).abs().max() for i in range(S)])
    err = float(errs.max())
    out = {"phase": phase, "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype,
           "prefill_vs_decode": {
               "tokens": S, "capacity": capacity(S, dec_spec),
               **({"capacity_factor": capacity_factor}
                  if capacity_factor else {}),
               **launches, "max_abs_logit_diff": err,
               "max_abs_logit": float(pre.abs().max()), "tol": MOE_PARITY_TOLS[0]}}
    del cache, pre

    prefill = make_prefill_step(cfg)
    toks = torch.randint(0, cfg.vocab_size, tokens, generator=gen,
                         device="cuda", dtype=torch.int32)
    reset_model_kernels()
    with moe_calls(keep_inputs=True) as calls:
        logits = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    kernel_launches = launched()
    finite = bool(torch.isfinite(logits).all())
    if plain:
        with plain_attention(), plain_ssd():
            reset_model_kernels()
            want = prefill(params, {"tokens": toks})
            plain_launches = sum(launched().values())
        plain_err = float((logits - want).abs().max())
        out["kernels_vs_plain"] = {
            "tokens": list(tokens), **kernel_launches,
            "plain_launches": plain_launches,
            "max_abs_logit_diff": plain_err,
            "max_abs_logit": float(want.abs().max()), "tol": MOE_PARITY_TOLS[1]}
        del want
    del logits
    layer, x, metrics = calls[0]
    idx = route(layer, x, spec)[3].cpu().numpy()
    C = capacity(x.shape[1], spec)
    host, kept = recount_dropped(idx, spec.n_experts, C)
    card = metrics["fraction_dropped"].cpu().numpy()
    out["fraction_dropped"] = {
        "tokens": list(tokens), "capacity": C,
        "card_layer0": float(card), "host_recount": float(host),
        "kept": kept, "slots": idx.size,
        "per_layer": [float(m["fraction_dropped"]) for _, _, m in calls],
        "logits_finite": finite}
    del params, calls, layer, x
    torch.cuda.empty_cache()
    want_launches = {f"{n}_launches": c for n, c in expect.items()}
    if launches != want_launches or kernel_launches != want_launches:
        raise AssertionError(f"parity prefills launched {launches} and "
                             f"{kernel_launches}, expected "
                             f"{want_launches}")
    if not err <= MOE_PARITY_TOLS[0]:
        raise AssertionError(f"prefill and decode logits differ by {err} > "
                             f"{MOE_PARITY_TOLS[0]}")
    if plain and (plain_launches or not plain_err <= MOE_PARITY_TOLS[1]):
        raise AssertionError(f"logits through the kernels differ from the "
                             f"plain versions' by {plain_err} > {MOE_PARITY_TOLS[1]} "
                             f"(plain launches {plain_launches})")
    if card != host or not finite:
        raise AssertionError(f"fraction_dropped on the card {card!r}, host "
                             f"recount {host!r}; logits finite: {finite}")
    return out


def moe_phases(tag: str, arch: str, seed: int, *, tokens, parity_tokens,
               layers=None, plain: bool = False):
    """``arch`` in MOE_PARAM_DTYPE parameters, at its published widths
    (cut to ``layers`` layers where given): <tag>_model (model_phase at
    ``tokens``, every MoE layer's fraction_dropped, the requests served),
    <tag>_trace (model_trace_phase and the device time by MoE part), then
    <tag>_parity on its MOE_PARITY_LAYERS-layer cut in fp32
    (moe_parity_phase at ``parity_tokens``, ``plain``); emits the lines,
    returns <tag>_model's."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    base = get_config(arch)
    cfg = replace(replace_layers(base, layers) if layers else base,
                  param_dtype=MOE_PARAM_DTYPE)
    params, init_s = init_timed(cfg, seed)
    line = model_phase(cfg, params, seed, phase=f"{tag}_model",
                       tokens=tokens)
    line.update(param_count=count_params(cfg),
                active_param_count=count_params(cfg, active_only=True),
                init_s=init_s, heads=[cfg.n_heads, cfg.n_kv_heads,
                                      cfg.resolved_head_dim])
    emit(line)
    trace = model_trace_phase(cfg, params, seed, phase=f"{tag}_trace",
                              tokens=tokens)
    trace["breakdown"] = moe_prefill_breakdown(cfg, params, tokens)
    emit(trace)
    del params
    torch.cuda.empty_cache()
    emit(moe_parity_phase(
        f"{tag}_parity", replace(replace_layers(base, MOE_PARITY_LAYERS),
                                 compute_dtype="float32"),
        parity_tokens, seed, plain=plain))
    return line


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def make_trainer(cfg, tokens, blob: Path, seed: int, store=None,
                 device="cuda", steps: int = TRAIN_STEPS):
    """A Trainer and its store as ``python -m repro_torch.launch.train``
    builds them (a three-node KVCluster control plane on the card, a
    CheckpointManager, AdamW with launch/train.py's schedule), for
    ``steps`` steps of ``tokens`` = (batch, sequence)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.data import PipelineConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.store import KVCluster, SimNetwork

    store = store or KVCluster(("cp1", "cp2", "cp3"), DVV_MECHANISM,
                               network=SimNetwork(seed=seed), device=device)
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=TRAIN_LR, warmup_steps=max(steps // 20, 1),
                    total_steps=steps),
        PipelineConfig(vocab_size=cfg.vocab_size, seq_len=tokens[1],
                       global_batch=tokens[0], seed=seed),
        TrainerConfig(total_steps=steps, ckpt_every=10 ** 9,
                      log_every=1, seed=seed),
        CheckpointManager(store, str(blob), f"{cfg.name}-train", "cp1"),
        device=device)
    return trainer, store


def state_bytes(trainer) -> int:
    from repro_torch.optim.adamw import tree_leaves
    return sum(t.numel() * t.element_size() for tree in (
        trainer.params, trainer.opt_state) for t in tree_leaves(tree))


def train_phase(seed: int, device="cuda", *, arch=TRAIN_ARCH, cfg=None,
                phase="train", kernel=None, save=True,
                trace=None):
    """``arch`` at full width and depth (fp32 parameters and moments, bf16
    compute, remat) trained TRAIN_STEPS steps on TRAIN_TOKENS from the
    port's SyntheticTokens, as launch/train.py drives it, and one more
    step traced on the card (device time by kernel class); then, with
    ``save``, one save of the whole state through the CheckpointManager.
    ``kernel`` is the kernel package whose forward and backward every
    layer launches each step (flash_attention by default); ``cfg``, if
    given, is trained in place of ``arch``'s config (a cut of its depth);
    ``trace(trainer)`` runs and reports the traced step
    (``traced_train_step`` by default)."""
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dvv_ops, flash_attention as FA
    from repro_torch.models import count_params

    kernel = kernel or FA
    (fwd_name,), (bwd_name,) = kernel.launches, kernel.bwd_launches
    cfg, tokens = cfg or get_config(arch), TRAIN_TOKENS
    blob = ROOT / "build" / "chip_smoke_ckpt" / phase
    shutil.rmtree(blob, ignore_errors=True)
    blob.mkdir(parents=True)
    trainer, store = make_trainer(cfg, tokens, blob, seed,
                                  device=device, steps=TRAIN_STEPS + 1)
    t = time.perf_counter()
    restored = trainer.try_restore()
    torch.cuda.synchronize()
    out = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "param_count": count_params(cfg),
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "tokens": list(tokens), "restored": restored,
           "init_s": time.perf_counter() - t,
           "state_bytes": state_bytes(trainer)}
    layer0 = trainer.params["blocks"]["layer0"]
    first = layer0["attn"]["wq"] if "attn" in layer0 else \
        layer0["mamba"]["in_x"]
    probe = {"embed": trainer.params["embed"][:8].clone(),
             "layer0": first[0].clone()}
    n_moe = cfg.n_groups * sum(s.ffn == "moe" for s in cfg.pattern)
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    dvv_ops.reset_launches()
    steps = []
    with moe_calls() as calls:
        for _ in range(TRAIN_STEPS):
            fwd = kernel.launches[fwd_name]
            bwd = kernel.bwd_launches[bwd_name]
            start = len(calls)
            t = time.perf_counter()
            trainer.run(steps=1)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            row = trainer.metrics_log[-1]
            steps.append({"step": row["step"], "s": sec,
                          "tokens_per_s": tokens[0] * tokens[1] / sec,
                          "loss": row["loss"], "grad_norm": row["grad_norm"],
                          fwd_name: kernel.launches[fwd_name] - fwd,
                          bwd_name: kernel.bwd_launches[bwd_name] - bwd})
            if n_moe:               # the forward's MoE layers (moe_train_trace)
                steps[-1]["fraction_dropped"] = [
                    float(m["fraction_dropped"])
                    for _, _, m in calls[start:start + n_moe]]
    del calls
    launches = {**kernel.launches, **kernel.bwd_launches,
                **dvv_ops.launches}
    if hasattr(kernel, "bwd_path_launches"):
        out["bwd_path_launches"] = dict(kernel.bwd_path_launches)
    out.update(steps=steps, launches=launches,
               peak_bytes=torch.cuda.max_memory_allocated(),
               s_per_step_after_first=sum(r["s"] for r in steps[1:])
               / max(len(steps) - 1, 1))
    if device == "cuda":
        out["trace"] = (trace or traced_train_step)(trainer)
    moved = {n: not torch.equal(t, ref) for n, t, ref in (
        ("embed", trainer.params["embed"][:8], probe["embed"]),
        ("layer0", first[0], probe["layer0"]))}
    out["params_moved"] = moved
    bad = [r for r in steps if not (math.isfinite(r["loss"])
                                    and math.isfinite(r["grad_norm"]))]
    if bad or not all(moved.values()):
        raise AssertionError(f"training gave non-finite losses or norms "
                             f"{bad}, or left parameters in place {moved}")
    per_step = [(r[fwd_name], r[bwd_name]) for r in steps]
    want = (2 * cfg.n_layers, cfg.n_layers) if cfg.remat \
        else (cfg.n_layers, cfg.n_layers)
    if device == "cuda" and per_step != [want] * TRAIN_STEPS:
        raise AssertionError(f"{fwd_name} launches per step {per_step}, "
                             f"expected {want} (forward with its "
                             f"recompute, backward)")
    by_path = out.get("bwd_path_launches")
    if device == "cuda" and by_path is not None and \
            by_path != {"wgmma": cfg.n_layers * TRAIN_STEPS, "simple": 0}:
        raise AssertionError(f"{bwd_name} calls by path {by_path}: every "
                             f"bf16 backward of the {TRAIN_STEPS} steps "
                             f"should take the wgmma kernels")
    if not save:
        del trainer
        shutil.rmtree(blob, ignore_errors=True)
        torch.cuda.empty_cache()
        return out

    need = 2 * out["state_bytes"]
    free = shutil.disk_usage(blob).free
    saver, label = trainer, "full"
    del trainer
    if free < need:                   # save the 2-layer cut instead
        saver = None
        torch.cuda.empty_cache()
        saver, _ = make_trainer(replace_layers(cfg, TRAIN_PARITY_LAYERS),
                                tokens, blob, seed, store=store,
                                device=device)
        saver.init_fresh()
        label = f"{TRAIN_PARITY_LAYERS}-layer cut: {free} bytes free, " \
                f"{need} wanted"
    dvv_ops.reset_launches()
    nbytes = state_bytes(saver)
    t = time.perf_counter()
    saver.save()
    sec = time.perf_counter() - t
    out["save"] = {"state": label, "bytes": nbytes, "s": sec,
                   "gb_per_s": nbytes / sec / 1e9,
                   "dvv_launches": dict(dvv_ops.launches),
                   "disk_free_bytes": free}
    del saver
    shutil.rmtree(blob, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def traced_train_step(trainer):
    """One more step of ``trainer`` under torch.profiler on the card
    (``traced_by_class``)."""
    return traced_by_class(lambda: trainer.run(steps=1))


def traced_by_class(fn):
    """``fn`` under torch.profiler on the card: device-busy against wall
    seconds and device time by kernel class (the flash forward and
    backward kernels, the SSD scan's forward and backward kernels,
    cuBLAS's GEMMs, the rest)."""
    busy_us, per, wall_s = device_profile(fn)
    classes = {"flash_fwd": 0.0, "flash_bwd": 0.0, "ssd_fwd": 0.0,
               "ssd_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    for key, (_, us) in per.items():
        name = key.lower()
        cls = "flash_fwd" if "flash_fwd_" in name else \
            "flash_bwd" if "flash_bwd_" in name else \
            "ssd_bwd" if SSD_BWD_KERNELS in name else \
            "ssd_fwd" if SSD_KERNELS in name else \
            "gemm" if any(g in name for g in GEMM_KERNELS) else "other"
        classes[cls] += us / 1e6
    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / 1e6 / wall_s
            if busy_us else None,
            "device_s_by_class": classes,
            "device_share_by_class": {
                c: t / (busy_us / 1e6) if busy_us else None
                for c, t in classes.items()},
            "device_events": sum(c for c, _ in per.values()),
            "top_device_events": sorted(
                ({"name": k[:80], "count": c, "us": us}
                 for k, (c, us) in per.items()),
                key=lambda e: -e["us"])[:10]}


def replace_layers(cfg, n_layers: int):
    from dataclasses import replace
    return replace(cfg, n_layers=n_layers * len(cfg.pattern))


@contextmanager
def plain_attention():
    """The LM's attention through the flash kernels' plain version
    (``repro_torch.models.attention`` calls ``gqa_flash_attention`` by that
    name) on card tensors too: the reference side of train_parity."""
    import importlib

    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # the package's ``attention`` function shadows its module's name
    attention = importlib.import_module("repro_torch.models.attention")
    original = attention.gqa_flash_attention

    def plain(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
              positions=None):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   positions=positions)

    attention.gqa_flash_attention = plain
    try:
        yield
    finally:
        attention.gqa_flash_attention = original


def leaf_paths(tree, prefix: str = ""):
    """The names of ``tree``'s leaves ("blocks/layer0/mamba/in_x"), in
    tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def loss_and_grads(params, batch, cfg):
    """The loss and the gradient of every parameter leaf (tree_leaves
    order), the parameters' requires_grad flags left alone."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def train_parity_phase(seed: int, device="cuda"):
    """gemma-2b cut to TRAIN_PARITY_LAYERS layers at full width, fp32
    compute, tokens [1, TRAIN_PARITY_TOKENS]: (a) the loss and every
    gradient leaf through the kernels against the same through the plain
    versions on the card; (b) 2 steps, a save, a restore into a fresh
    Trainer and 2 more steps give the state_fingerprint of 4 uninterrupted
    steps (tests/test_fault_tolerance.py's resume, on the card)."""
    import shutil
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params

    cfg = replace(replace_layers(get_config(TRAIN_ARCH), TRAIN_PARITY_LAYERS),
                  compute_dtype="float32")
    tokens = (1, TRAIN_PARITY_TOKENS)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    params = init_params(gen, cfg, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticTokens(
        PipelineConfig(cfg.vocab_size, tokens[1], tokens[0], seed=seed))
        .next_batch().items()}
    FA.reset_launches()
    loss, grads = loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    launches = {**FA.launches, **FA.bwd_launches}
    with plain_attention():
        FA.reset_launches()
        want_loss, want = loss_and_grads(params, batch, cfg)
        plain_launches = {**FA.launches, **FA.bwd_launches}
    loss_diff = abs(float(loss) - float(want_loss))
    rel = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for g, w in zip(grads, want)]
    del params, grads, want
    torch.cuda.empty_cache()
    out = {"phase": "train_parity", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "tokens": list(tokens), "loss": float(loss),
           "loss_abs_diff": loss_diff, "grad_leaves": len(rel),
           "grad_max_rel_diff": max(rel), "tol": TRAIN_PARITY_TOL,
           "kernel_launches": launches, "plain_launches": plain_launches}
    if not (loss_diff <= TRAIN_PARITY_TOL and max(rel) <= TRAIN_PARITY_TOL):
        raise AssertionError(f"loss or gradients through the kernels differ "
                             f"from the plain versions': {out}")
    if device == "cuda" and launches != {
            "flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers} or \
            set(plain_launches.values()) != {0}:
        raise AssertionError(f"parity launches {launches}, plain "
                             f"{plain_launches}")

    blob = ROOT / "build" / "chip_smoke_ckpt" / "parity"
    fingerprints = {}
    for run in ("uninterrupted", "resumed"):
        shutil.rmtree(blob, ignore_errors=True)
        blob.mkdir(parents=True)
        trainer, store = make_trainer(cfg, tokens, blob, seed, device=device)
        trainer.init_fresh()
        t = time.perf_counter()
        if run == "uninterrupted":
            trainer.run()
        else:
            trainer.run(steps=TRAIN_STEPS // 2)
            trainer.save()
            del trainer
            trainer, _ = make_trainer(cfg, tokens, blob, seed, store=store,
                                      device=device)
            if not trainer.try_restore() or \
                    trainer.step != TRAIN_STEPS // 2:
                raise AssertionError("the fresh Trainer found no checkpoint")
            trainer.run()
        torch.cuda.synchronize()
        fingerprints[run] = trainer.state_fingerprint()
        out[f"{run}_s"] = time.perf_counter() - t
        out[f"{run}_losses"] = [r["loss"] for r in trainer.metrics_log]
        del trainer
        torch.cuda.empty_cache()
    shutil.rmtree(blob, ignore_errors=True)
    out["fingerprints"] = fingerprints
    if fingerprints["uninterrupted"] != fingerprints["resumed"]:
        raise AssertionError(f"resumed training is not bitwise the "
                             f"uninterrupted run's: {fingerprints}")
    return out


@contextmanager
def plain_ssd():
    """The SSM mixer's scan through the plain version (``repro_torch.
    models.ssm`` calls ``ssd_scan`` by that name) on card tensors too,
    with autograd's gradient: the reference side of ssm_train_parity."""
    import importlib

    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    ssm = importlib.import_module("repro_torch.models.ssm")
    original = ssm.ssd_scan

    def plain(xh, dt, A, Bc, Cc, D, *, chunk):
        y, h = ssd_chunked(xh, dt, A, Bc, Cc, D, chunk)
        return y, h.float()

    ssm.ssd_scan = plain
    try:
        yield
    finally:
        ssm.ssd_scan = original


@contextmanager
def recorded_ssd(calls: list):
    """The SSM mixer's scan (``repro_torch.models.ssm`` calls ``ssd_scan``
    by that name) as it is, each call that autograd records appended to
    ``calls``: its inputs and, once the backward reaches it, dy, the
    cotangent of y.  A remat recompute's call gets no dy (its graph is
    not walked)."""
    import importlib

    ssm = importlib.import_module("repro_torch.models.ssm")
    original = ssm.ssd_scan

    def record(*args, chunk):
        y, h = original(*args, chunk=chunk)
        if y.requires_grad:
            entry = {"inputs": [a.detach() for a in args]}
            y.register_hook(lambda g: entry.__setitem__("dy", g.detach()))
            calls.append(entry)
        return y, h

    ssm.ssd_scan = record
    try:
        yield
    finally:
        ssm.ssd_scan = original


def ssd_float64_witness(entry, chunk: int):
    """One recorded scan's gradient on its own inputs and dy three ways:
    through the kernels (fp32), autograd through the plain version in
    fp32, and the same in float64.  Reduced as the model reduces them
    into the leaves A_log (dA A, since A = -exp(A_log)) and dt_bias (sum
    over (b, s) of ddt (1 - exp(-dt)), the derivative of the softplus
    that made dt), each side's error against float64 over the largest
    float64 magnitude, and kernels against plain fp32."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    args, dy = entry["inputs"], entry["dy"]

    def leaves(fn, dtype):
        xs = [a.detach().to(dtype).requires_grad_() for a in args]
        with torch.enable_grad():
            y, _ = fn(*xs)
        _, ddt, dA, *_ = torch.autograd.grad(y, xs, dy.to(dtype))
        dt, A = args[1].double(), args[2].double()
        return {"A_log": dA.double() * A,
                "dt_bias": (ddt.double() * -torch.expm1(-dt)).sum((0, 1))}

    sides = {"kernels": leaves(partial(ssd_scan, chunk=chunk), torch.float32),
             "plain": leaves(lambda *a: ssd_chunked(*a, chunk),
                             torch.float32),
             "float64": leaves(lambda *a: ssd_chunked(*a, chunk),
                               torch.float64)}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    return {leaf: {"kernels_vs_float64": rel(sides["kernels"][leaf], w),
                   "plain_vs_float64": rel(sides["plain"][leaf], w),
                   "kernels_vs_plain": rel(sides["kernels"][leaf],
                                           sides["plain"][leaf])}
            for leaf, w in sides["float64"].items()}


def ssm_grad_parity(seed: int, device="cuda"):
    """mamba2-780m cut to SSM_TRAIN_PARITY_LAYERS layers at full width,
    fp32 compute, remat, tokens [1, SSM_TRAIN_PARITY_TOKENS]: the loss and
    every gradient leaf through the ssd_scan kernels (forward, recompute,
    backward) against the same through the plain version on the card,
    with the launches of each side; then each layer's scan, on the inputs
    and dy the kernels' run gave it, reduced into its A_log and dt_bias
    leaves by the kernels, the plain version in fp32 and in float64
    (``ssd_float64_witness``).  Reads only: ``ssm_train_parity_phase``
    holds them to their bounds."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import init_params

    cfg = replace(replace_layers(get_config(SSM_ARCH),
                                 SSM_TRAIN_PARITY_LAYERS),
                  compute_dtype="float32")
    tokens = (1, SSM_TRAIN_PARITY_TOKENS)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    params = init_params(gen, cfg, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticTokens(
        PipelineConfig(cfg.vocab_size, tokens[1], tokens[0], seed=seed))
        .next_batch().items()}
    calls = []
    SS.reset_launches()
    with recorded_ssd(calls):
        loss, grads = loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    launches = {**SS.launches, **SS.bwd_launches}
    with plain_ssd():
        SS.reset_launches()
        want_loss, want = loss_and_grads(params, batch, cfg)
        plain_launches = {**SS.launches, **SS.bwd_launches}
    loss_diff = abs(float(loss) - float(want_loss))
    rel = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for g, w in zip(grads, want)]
    finite = {"kernels": all(bool(torch.isfinite(g).all()) for g in grads),
              "plain": all(bool(torch.isfinite(w).all()) for w in want)}
    names = leaf_paths(params)
    worst = sorted(zip(rel, names), reverse=True)[:4]
    del params, grads, want
    witness = {f"layer{i}": ssd_float64_witness(c, cfg.ssm_chunk)
               for i, c in enumerate(c for c in calls if "dy" in c)}
    del calls
    torch.cuda.empty_cache()
    return {"phase": "ssm_train_parity", "arch": cfg.name, "seed": seed,
            "finite": finite, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype,
            "remat": cfg.remat, "tokens": list(tokens), "loss": float(loss),
            "loss_abs_diff": loss_diff, "grad_leaves": len(rel),
            "grad_max_rel_diff": max(rel),
            "grad_rel_diff_worst": {name: r for r, name in worst},
            "float64_witness": witness, "tol": TRAIN_PARITY_TOL,
            "kernel_launches": launches, "plain_launches": plain_launches}


def ssm_train_parity_phase(seed: int, device="cuda"):
    """``ssm_grad_parity``, held to its bounds: the loss and every leaf
    within TRAIN_PARITY_TOL, finite on both sides, the layers' scans
    through the kernels (twice a step with remat) and their backward,
    the plain side through none, and each layer's A_log and dt_bias
    through the kernels within TRAIN_PARITY_TOL of float64."""
    out = ssm_grad_parity(seed, device)
    n_layers = out["n_layers"]
    if not (out["loss_abs_diff"] <= TRAIN_PARITY_TOL and
            out["grad_max_rel_diff"] <= TRAIN_PARITY_TOL and
            all(out["finite"].values())):
        raise AssertionError(f"loss or gradients through the kernels differ "
                             f"from the plain version's: {out}")
    want_launches = {"ssd_scan": (2 if out["remat"] else 1) * n_layers,
                     "ssd_scan_bwd": n_layers}
    if device == "cuda" and out["kernel_launches"] != want_launches or \
            set(out["plain_launches"].values()) != {0}:
        raise AssertionError(f"parity launches {out['kernel_launches']}, "
                             f"plain {out['plain_launches']}")
    witness = out["float64_witness"]
    if len(witness) != n_layers or any(
            not side["kernels_vs_float64"] <= TRAIN_PARITY_TOL
            for layer in witness.values() for side in layer.values()):
        raise AssertionError(f"the kernels' A_log or dt_bias is not within "
                             f"{TRAIN_PARITY_TOL} of float64 in every "
                             f"layer: {witness}")
    return out


# ---------------------------------------------------------------------------
# inputs, parity cuts and make_train_step training of any config
# ---------------------------------------------------------------------------

def embedding_batch(cfg, tokens, seed: int, labels: bool = False,
                    device="cuda"):
    """Embeddings [B, S, d_model] ~ N(0, 1), rounded to bf16 (so a bf16 and
    an fp32 run read the same values) and held in the config's compute
    dtype; with ``labels`` classes in [0, vocab_size); for an M-RoPE config
    (qwen2-vl-7b) every batch row's image-style positions (``vl_positions``,
    [3, B, S]); drawn on ``device`` from ``seed``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn((*tokens, cfg.d_model), generator=gen, device=device)
    batch = {"embeddings": emb.to(torch.bfloat16).to(
        getattr(torch, cfg.compute_dtype))}
    if labels:
        batch["labels"] = torch.randint(0, cfg.vocab_size, tokens,
                                        generator=gen, device=device,
                                        dtype=torch.int32)
    if cfg.mrope:
        B, S = tokens
        batch["positions"] = torch.from_numpy(vl_positions(S)).to(
            device)[:, None].expand(3, B, S).contiguous()
    return batch


def model_batch(cfg, tokens, seed: int, labels: bool = False,
                device="cuda"):
    """``embedding_batch`` for an embedding-input config; for a token
    config, tokens (and with ``labels``, labels) in [0, vocab_size) drawn
    on ``device`` from ``seed``."""
    import torch
    if cfg.input_mode != "tokens":
        return embedding_batch(cfg, tokens, seed, labels, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {n: torch.randint(0, cfg.vocab_size, tokens, generator=gen,
                             device=device, dtype=torch.int32)
            for n in (("tokens", "labels") if labels else ("tokens",))}


def expect_instances(cfg, batch, calls: int) -> dict:
    """The flash launches by mask instance that ``calls`` launches a layer
    give: by position where the batch has positions, else by index."""
    n = calls * cfg.n_groups * sum(s.mixer.startswith("attn")
                                   for s in cfg.pattern)
    by_pos = "positions" in batch
    return {"index": 0 if by_pos else n, "positions": n if by_pos else 0}


def prefill_parity_phase(phase: str, cfg, tokens, seed: int, device="cuda"):
    """``cfg`` (a cut at full width, fp32 compute): prefill logits of
    ``model_batch`` [tokens] through the kernels against the same
    parameters and inputs through the plain versions on the card, to
    PREFILL_DECODE_TOL, each attention layer launching the flash kernel
    once (by position where the batch has positions).  With positions,
    the same prefill masked by index must differ by more than 1e-2: the
    positions count."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    gen = torch.Generator(device=device).manual_seed(seed + 4)
    params = init_params(gen, cfg, device=device)
    batch = model_batch(cfg, tokens, seed + 5, device=device)
    prefill = make_prefill_step(cfg)
    FA.reset_launches()
    got = prefill(params, batch)
    torch.cuda.synchronize()
    launches = dict(FA.instance_launches)
    with plain_attention():
        FA.reset_launches()
        want = prefill(params, batch)
        plain_launches = FA.launches["flash_attention"]
    err = float((got - want).abs().max())
    out = {"phase": phase, "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
           "compute_dtype": cfg.compute_dtype, "tokens": list(tokens),
           "flash_attention_launches": launches,
           "plain_launches": plain_launches, "max_abs_logit_diff": err,
           "max_abs_logit": float(want.abs().max()),
           "tol": PREFILL_DECODE_TOL}
    by_pos = "positions" in batch
    if by_pos:
        index = prefill(params, {k: t for k, t in batch.items()
                                 if k != "positions"})
        out["index_masked_max_abs_logit_diff"] = float(
            (index - want).abs().max())
        del index
    del params, got, want
    torch.cuda.empty_cache()
    expect = expect_instances(cfg, batch, 1)
    if device == "cuda" and launches != expect or plain_launches:
        raise AssertionError(f"parity prefill launched flash_attention "
                             f"{launches} (plain {plain_launches}), "
                             f"expected {expect} (0)")
    if not err <= PREFILL_DECODE_TOL:
        raise AssertionError(f"logits through the kernels differ from the "
                             f"plain versions' by {err} > "
                             f"{PREFILL_DECODE_TOL}")
    if by_pos and not out["index_masked_max_abs_logit_diff"] > 1e-2:
        raise AssertionError(f"masks by index give the logits of masks by "
                             f"position: {out}")
    return out


def step_train_phase(phase: str, cfg, tokens, seed: int, device="cuda"):
    """``cfg`` (fp32 parameters and AdamW moments, bf16 compute, remat)
    through make_train_step, as tests/test_arch_smoke.py trains an
    embedding-input config (the Trainer's token pipeline yields no
    embeddings): TRAIN_STEPS timed steps on one seeded ``model_batch`` with
    labels [tokens], each launching the flash forward twice a layer
    (remat's recompute) and its backward once (by position where the
    batch has positions; counts zeroed just before the steps and read
    after each), then one more step traced on the card (device time by
    kernel class); finite losses and norms, parameters that move."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import count_params, init_params
    from repro_torch.optim import AdamWConfig, init_opt_state

    gen = torch.Generator(device=device).manual_seed(seed)
    t = time.perf_counter()
    params = init_params(gen, cfg, device=device)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          total_steps=TRAIN_STEPS + 1)
    opt_state = init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    out = {"phase": phase, "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
           "param_count": count_params(cfg), "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "tokens": list(tokens), "init_s": time.perf_counter() - t,
           "state_bytes": tree_bytes(params) + tree_bytes(opt_state)}
    batch = model_batch(cfg, tokens, seed + 6, labels=True, device=device)
    step = make_train_step(cfg, opt_cfg)
    wq = params["blocks"]["layer0"]["attn"]["wq"]
    probe = {"wq": wq[0].clone(), "unembed": params["unembed"].clone()}
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    steps = []
    for _ in range(TRAIN_STEPS):
        fwd = FA.launches["flash_attention"]
        bwd = FA.bwd_launches["flash_attention_bwd"]
        t = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        steps.append({"s": sec, "tokens_per_s": tokens[0] * tokens[1] / sec,
                      "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "flash_attention": FA.launches["flash_attention"] - fwd,
                      "flash_attention_bwd":
                          FA.bwd_launches["flash_attention_bwd"] - bwd})
    instances = {"fwd": dict(FA.instance_launches),
                 "bwd": dict(FA.bwd_instance_launches)}
    out.update(steps=steps, launches={**FA.launches, **FA.bwd_launches},
               instance_launches=instances,
               peak_bytes=torch.cuda.max_memory_allocated(),
               s_per_step_after_first=sum(r["s"] for r in steps[1:])
               / max(len(steps) - 1, 1))
    state = [params, opt_state]

    def traced():
        state[:] = step(*state, batch)[:2]
    out["trace"] = traced_by_class(traced)
    moved = {n: not torch.equal(a, b) for n, a, b in (
        ("wq", wq[0], probe["wq"]),
        ("unembed", params["unembed"], probe["unembed"]))}
    out["params_moved"] = moved
    bad = [r for r in steps if not (math.isfinite(r["loss"])
                                    and math.isfinite(r["grad_norm"]))]
    if bad or not all(moved.values()):
        raise AssertionError(f"training gave non-finite losses or norms "
                             f"{bad}, or left parameters in place {moved}")
    calls = 2 if cfg.remat else 1
    want = (calls * cfg.n_layers, cfg.n_layers)
    per_step = [(r["flash_attention"], r["flash_attention_bwd"])
                for r in steps]
    want_instances = {
        "fwd": expect_instances(cfg, batch, calls * TRAIN_STEPS),
        "bwd": expect_instances(cfg, batch, TRAIN_STEPS)}
    if device == "cuda" and (per_step != [want] * TRAIN_STEPS
                             or instances != want_instances):
        raise AssertionError(f"flash launches per step {per_step}, expected "
                             f"{want} (forward with its recompute, "
                             f"backward); by instance {instances}, expected "
                             f"{want_instances}")
    del state, params, opt_state, batch
    torch.cuda.empty_cache()
    return out


@contextmanager
def recorded_routes(calls: list):
    """Append every call's chosen experts (``moe.route``'s [G,S,K]) to
    ``calls`` while the context is open (``moe_ffn`` looks ``route`` up in
    its module at each call)."""
    from repro_torch.models import moe

    original = moe.route

    def recording(*args, **kw):
        out = original(*args, **kw)
        calls.append(out[3])
        return out

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = original


def grad_parity_phase(phase: str, base, tokens, seed: int, device="cuda", *,
                      dtypes=("float32", "bfloat16")):
    """``base`` (a cut at full width, remat) on ``model_batch`` with labels
    [tokens]: the loss and every gradient leaf through the flash kernels
    against the same through the plain versions on the card, (a) in fp32
    compute within TRAIN_PARITY_TOL (the FMA kernels), (b) where
    ``dtypes`` has bf16, in bf16 compute (the wgmma kernels) under the
    flash backward's two gates: each leaf within ref.BF16_GRAD_ROW_TOL of
    the plain bf16 version's by grad_row_err, and its RMS distance from
    the exact gradient (the plain versions in fp32, (a)'s reference)
    within ref.BF16_GRAD_RMS_RATIO of the plain bf16 version's by
    grad_rms_err.  A leaf that the plain bf16 version itself gets no
    closer than BF16_GRAD_ROW_TOL to the exact gradient by rows (qwen2-vl's
    unembedding: its rows span a 152,064-wide vocabulary of which a few
    thousand label columns carry weight, so one bf16 step of the final
    hidden state, which two runs round apart, is 0.4 of a row's RMS)
    cannot be held to that version by rows: its row error against the
    exact gradient is held within BF16_GRAD_RMS_RATIO of the plain bf16
    version's instead, and the leaf is named.  The worst leaves are named,
    and beside the bf16 row errors each side's against the exact
    gradient.  A MoE config routes for real (its routers are fp32): both
    runs must choose the same experts."""
    from dataclasses import replace

    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import (
        BF16_GRAD_RMS_RATIO, BF16_GRAD_ROW_TOL, grad_rms_err, grad_row_err,
    )
    from repro_torch.models import init_params

    gen = torch.Generator(device=device).manual_seed(seed + 7)
    params = init_params(gen, base, device=device)
    names = leaf_paths(params)
    out = {"phase": phase, "arch": base.name,
           "n_layers": base.n_layers, "d_model": base.d_model,
           "heads": [base.n_heads, base.n_kv_heads, base.resolved_head_dim],
           "remat": base.remat, "tokens": list(tokens),
           "grad_leaves": len(names)}
    calls = 2 if base.remat else 1
    grads = {}
    for dtype in dtypes:
        cfg = replace(base, compute_dtype=dtype)
        batch = model_batch(cfg, tokens, seed + 8, labels=True,
                            device=device)
        want_launches = {
            "fwd": expect_instances(cfg, batch, calls),
            "bwd": expect_instances(cfg, batch, 1)}
        FA.reset_launches()
        with recorded_routes([]) as routes:
            loss, got = loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
        launches = {"fwd": dict(FA.instance_launches),
                    "bwd": dict(FA.bwd_instance_launches)}
        with plain_attention(), recorded_routes([]) as plain_routes:
            FA.reset_launches()
            want_loss, want = loss_and_grads(params, batch, cfg)
            plain = {**FA.launches, **FA.bwd_launches}
        if device == "cuda" and launches != want_launches or \
                set(plain.values()) != {0}:
            raise AssertionError(f"{dtype} parity launches {launches}, "
                                 f"expected {want_launches}; plain {plain}")
        grads[dtype] = got, want
        out[dtype] = {"loss": float(loss),
                      "loss_abs_diff": abs(float(loss) - float(want_loss)),
                      "kernel_launches": launches}
        if routes:
            same = len(routes) == len(plain_routes) and all(
                torch.equal(a, b) for a, b in zip(routes, plain_routes))
            out[dtype]["routes_equal"] = same
            if not same:
                raise AssertionError(f"{dtype}: the kernels' run routes "
                                     f"tokens to other experts than the "
                                     f"plain versions' run: {out}")
    got, exact = grads["float32"]
    rel = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for g, w in zip(got, exact)]
    f32 = out["float32"]
    f32.update(grad_max_rel_diff=max(rel), tol=TRAIN_PARITY_TOL,
               worst_leaves=sorted(zip(rel, names), reverse=True)[:3])
    row_faults, ratio = [], [0.0]
    if "bfloat16" in grads:
        got, plain = grads["bfloat16"]
        row = [grad_row_err(g, w) for g, w in zip(got, plain)]
        ratio = [grad_rms_err(g, e) / max(grad_rms_err(w, e), 1e-30)
                 for g, w, e in zip(got, plain, exact)]
        exact_row = {side: [grad_row_err(g, e) for g, e in zip(grads, exact)]
                     for side, grads in (("kernels", got), ("plain", plain))}
        against_exact = {}
        for n, r, k, w in zip(names, row, exact_row["kernels"],
                              exact_row["plain"]):
            if w > BF16_GRAD_ROW_TOL:
                against_exact[n] = {"kernels": k, "plain": w,
                                    "ratio": k / w}
                if not k <= BF16_GRAD_RMS_RATIO * w:
                    row_faults.append(n)
            elif not r <= BF16_GRAD_ROW_TOL:
                row_faults.append(n)
        out["bfloat16"].update(
            grad_max_row_err=max(row), row_tol=BF16_GRAD_ROW_TOL,
            worst_row_leaves=sorted(zip(row, names), reverse=True)[:3],
            worst_row_leaves_against_exact={
                side: sorted(zip(errs, names), reverse=True)[:3]
                for side, errs in exact_row.items()},
            rows_held_against_exact=against_exact,
            grad_max_rms_err_ratio=max(ratio),
            rms_ratio_tol=BF16_GRAD_RMS_RATIO,
            worst_ratio_leaves=sorted(zip(ratio, names), reverse=True)[:3])
    del params, grads, got, exact
    torch.cuda.empty_cache()
    if not (f32["loss_abs_diff"] <= TRAIN_PARITY_TOL
            and max(rel) <= TRAIN_PARITY_TOL):
        raise AssertionError(f"fp32 loss or gradients through the kernels "
                             f"differ from the plain versions': {out}")
    if row_faults or not max(ratio) <= BF16_GRAD_RMS_RATIO:
        raise AssertionError(f"bf16 gradients through the kernels fail the "
                             f"flash backward's gates: {out}")
    return out


def init_timed(cfg, seed: int):
    """``cfg``'s parameters on the card from ``seed``, and the seconds."""
    import torch
    from repro_torch.models import init_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = time.perf_counter()
    params = init_params(gen, cfg)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t


# ---------------------------------------------------------------------------
# jamba-1.5-large-398b, the hybrid
# ---------------------------------------------------------------------------

def pattern_cut(cfg, layers: slice):
    """``cfg`` cut to one group of ``cfg.pattern[layers]``."""
    from dataclasses import replace
    pattern = cfg.pattern[layers]
    return replace(cfg, n_layers=len(pattern), pattern=pattern)


def long_decode_phase(cfg, params, seed: int):
    """long_500k's decode step: batch 1 over a cache of its 524,288 slots
    built by init_cache, a warm-up step at JAMBA_LONG_POS and
    JAMBA_LONG_STEPS timed steps after it through make_decode_step; then
    the same steps over a cache of SERVE_MAX_LEN slots (at its last
    positions): seconds a step, whose difference the host's time hides
    (jamba_trace reads the cache's share from device time).
    Beside each, the step's bytes floor: every parameter and the whole
    cache read once."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import init_cache

    shape = SHAPES["long_500k"]
    B, n = shape.global_batch, JAMBA_LONG_STEPS
    step = make_decode_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    toks = torch.randint(0, cfg.vocab_size, (n + 1, B), generator=gen,
                         device="cuda", dtype=torch.int32)
    param_bytes = tree_bytes(params)
    out = {"phase": "jamba_long", "arch": cfg.name, "shape": shape.name,
           "batch": B, "steps": n, "param_bytes": param_bytes,
           "note": "the decode_attention kernel reads the keys up to "
                   "pos only: a step at one position reads the same "
                   "attention bytes over either cache"}
    for name, slots, first in (("long", shape.seq_len, JAMBA_LONG_POS),
                               ("short", SERVE_MAX_LEN,
                                SERVE_MAX_LEN - n - 1)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = init_cache(cfg, B, slots)
        step(params, cache, toks[0], first)             # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(1, n + 1):
            logits, cache = step(params, cache, toks[i], first + i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        if tuple(logits.shape) != (B, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"decode logits {tuple(logits.shape)} "
                                 f"over {slots} slots are not finite")
        kv_bytes = sum(tree_bytes(c) for c in cache.values() if "k" in c)
        # every parameter, the Mamba state, and the keys 0..last position
        floor = param_bytes + tree_bytes(cache) - kv_bytes + \
            kv_bytes * (first + n + 1) // slots
        out[name] = {
            "slots": slots, "positions": [first + 1, first + n],
            "cache_bytes": tree_bytes(cache),
            "kv_cache_bytes": kv_bytes,
            "seconds": secs, "s_per_step": secs / n,
            "bytes_floor_per_step": floor,
            "floor_s_per_step": floor / HBM_BYTES_PER_S,
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del cache, logits
    return out


def jamba_trace_phase(cfg, params):
    """One prefill of [JAMBA_PREFILL] and one decode step of batch 1 over
    long_500k's 524,288 slots and over SERVE_MAX_LEN's, each timed once
    untraced and then traced on the card alone (device-busy against wall
    seconds: the idle share, against the traced and the untraced wall) and
    with the host's ops (``lm_breakdown``: device time by part); the
    long cache's share of a decode step, from device time."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache

    shape = SHAPES["long_500k"]
    B = shape.global_batch
    toks = torch.zeros(JAMBA_PREFILL, dtype=torch.int32, device="cuda")
    prefill, step = make_prefill_step(cfg), make_decode_step(cfg)
    tok = torch.zeros(B, dtype=torch.int32, device="cuda")
    caches = {n: init_cache(cfg, B, n)
              for n in (shape.seq_len, SERVE_MAX_LEN)}
    out = {"phase": "jamba_trace", "arch": cfg.name,
           "prefill_tokens": list(JAMBA_PREFILL)}
    for name, fn, decode in (
            ("prefill", lambda: prefill(params, {"tokens": toks}), False),
            ("long_decode", lambda: step(params, caches[shape.seq_len], tok,
                                         JAMBA_LONG_POS), True),
            ("short_decode", lambda: step(params, caches[SERVE_MAX_LEN],
                                          tok, SERVE_MAX_LEN - 1), True)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        untraced_s = time.perf_counter() - t
        busy_us, per, wall_s = device_profile(fn)
        busy_s = busy_us / 1e6
        out[name] = {
            "wall_s": wall_s, "wall_untraced_s": untraced_s,
            "device_busy_s": busy_s,
            "device_idle_share": 1 - busy_s / wall_s if busy_us else None,
            "device_idle_share_untraced_wall": 1 - busy_s / untraced_s
            if busy_us else None,
            "device_events": sum(c for c, _ in per.values()),
            "top_device_events": top_device_events(per),
            "breakdown": lm_breakdown(fn, cfg, decode)}
    out["decode_slots"] = {"long_decode": shape.seq_len,
                           "short_decode": SERVE_MAX_LEN}
    out["long_cache_share"] = 1 - out["short_decode"][
        "device_busy_s"] / out["long_decode"]["device_busy_s"] \
        if out["long_decode"]["device_busy_s"] else None
    del caches
    torch.cuda.empty_cache()
    return out


def jamba_phases(seed: int):
    """jamba-1.5-large-398b at its published widths cut to JAMBA_LAYERS,
    in MOE_PARAM_DTYPE parameters: jamba_model (model_phase at
    JAMBA_PREFILL: one flash launch and four SSD scans on the wgmma path a
    prefill, every MoE layer's fraction_dropped, the requests served and
    read back), jamba_long (long_decode_phase), jamba_trace, then
    jamba_parity on the JAMBA_PARITY_LAYERS cut in fp32
    (moe_parity_phase: (a) at JAMBA_PARITY_DECODE_TOKENS tokens and
    JAMBA_PARITY_CAPACITY, (b) and (c) at JAMBA_PARITY_TOKENS); emits the
    lines, returns jamba_model's."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    base = get_config(JAMBA_ARCH)
    cfg = replace(pattern_cut(base, JAMBA_LAYERS),
                  param_dtype=MOE_PARAM_DTYPE)
    params, init_s = init_timed(cfg, seed)
    line = model_phase(cfg, params, seed, phase="jamba_model",
                       tokens=JAMBA_PREFILL)
    line.update(param_count=count_params(cfg),
                active_param_count=count_params(cfg, active_only=True),
                init_s=init_s, heads=[cfg.n_heads, cfg.n_kv_heads,
                                      cfg.resolved_head_dim],
                ssm_heads=[cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state],
                pattern=[f"{s.mixer}+{s.ffn}" for s in cfg.pattern])
    emit(line)
    emit(long_decode_phase(cfg, params, seed))
    emit(jamba_trace_phase(cfg, params))
    del params
    torch.cuda.empty_cache()
    emit(moe_parity_phase(
        "jamba_parity", replace(pattern_cut(base, JAMBA_PARITY_LAYERS),
                                compute_dtype="float32"),
        JAMBA_PARITY_TOKENS, seed, plain=True,
        decode_tokens=JAMBA_PARITY_DECODE_TOKENS,
        capacity_factor=JAMBA_PARITY_CAPACITY))
    return line


# ---------------------------------------------------------------------------
# qwen3-14b and granite-8b, served
# ---------------------------------------------------------------------------

def dense_phases(seed: int):
    """Each DENSE_SERVE config at full width and depth through model_phase
    (prefill [1, PREFILL_TOKENS], served requests, sessions in the store),
    then its cut of DENSE_PARITY_LAYERS layers, fp32, through
    prefill_parity_phase; emits the lines, returns the model lines by
    arch."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    lines = {}
    for arch, param_dtype in DENSE_SERVE:
        tag = arch.replace("-", "_")
        cfg = replace(get_config(arch), param_dtype=param_dtype)
        params, init_s = init_timed(cfg, seed)
        line = model_phase(cfg, params, seed, phase=f"{tag}_model")
        line.update(param_count=count_params(cfg), init_s=init_s,
                    heads=[cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim])
        emit(line)
        lines[arch] = line
        del params
        torch.cuda.empty_cache()
        emit(prefill_parity_phase(
            f"{tag}_parity", replace(replace_layers(
                get_config(arch), DENSE_PARITY_LAYERS),
                compute_dtype="float32"), (1, DENSE_PARITY_TOKENS), seed))
    return lines


# ---------------------------------------------------------------------------
# hubert-xlarge, the audio encoder
# ---------------------------------------------------------------------------

def audio_model_phase(cfg, params, seed: int, device="cuda"):
    """hubert-xlarge's prefill through make_prefill_step on frame
    embeddings [AUDIO_PREFILL]: one warm-up and AUDIO_PREFILL_REPS timed
    prefills, each launching flash_attention once a layer (the count is
    zeroed just before each and read just after); seconds (the median),
    frames/s and the peak device memory of a prefill."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(cfg)
    batch = embedding_batch(cfg, AUDIO_PREFILL, seed + 1, device=device)
    secs, launches, peaks = [], [], []
    for _ in range(1 + AUDIO_PREFILL_REPS):
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        t = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        launches.append(FA.launches["flash_attention"])
        peaks.append(torch.cuda.max_memory_allocated())
        if tuple(logits.shape) != (*AUDIO_PREFILL, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"are not finite or of the wrong shape")
        del logits
    if device == "cuda" and launches != [cfg.n_layers] * len(launches):
        raise AssertionError(f"flash_attention launches per prefill "
                             f"{launches}, expected {cfg.n_layers}")
    timed = sorted(secs[1:])
    median = timed[len(timed) // 2]
    torch.cuda.empty_cache()
    return {"phase": "audio_model", "arch": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "causal": cfg.causal, "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype,
            "param_bytes": tree_bytes(params),
            "prefill_tokens": list(AUDIO_PREFILL),
            "prefill_s": {"warm_up": secs[0], "timed": secs[1:],
                          "median": median},
            "prefill_tokens_per_s":
                AUDIO_PREFILL[0] * AUDIO_PREFILL[1] / median,
            "flash_attention_launches": launches[-1],
            "prefill_peak_bytes": max(peaks[1:])}


def audio_trace_phase(cfg, params, seed: int):
    """One hubert-xlarge prefill at AUDIO_PREFILL traced on the card:
    device time by kernel class, the flash kernel's share, the idle share
    and the top device events."""
    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(cfg)
    batch = embedding_batch(cfg, AUDIO_PREFILL, seed + 1)
    out = {"phase": "audio_trace", "prefill_tokens": list(AUDIO_PREFILL),
           **traced_by_class(lambda: prefill(params, batch))}
    out["flash_share"] = out["device_share_by_class"]["flash_fwd"]
    return out


def audio_phases(seed: int):
    """Run and emit the five audio phases in order; returns the
    audio_model and audio_train lines (the kernels line reads their
    launches)."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    cfg = get_config(AUDIO_ARCH)
    params, init_s = init_timed(cfg, seed)
    audio = audio_model_phase(cfg, params, seed)
    audio.update(param_count=count_params(cfg), init_s=init_s)
    emit(audio)
    emit(audio_trace_phase(cfg, params, seed))
    del params
    torch.cuda.empty_cache()
    cut = replace_layers(cfg, AUDIO_PARITY_LAYERS)
    emit(prefill_parity_phase(
        "audio_parity", replace(cut, compute_dtype="float32"),
        (1, AUDIO_PARITY_TOKENS), seed))
    audio_train = step_train_phase("audio_train", cfg, AUDIO_TRAIN, seed)
    emit(audio_train)
    emit(grad_parity_phase("audio_train_parity", cut,
                           (1, AUDIO_PARITY_TOKENS), seed))
    return audio, audio_train


# ---------------------------------------------------------------------------
# qwen2-vl-7b: embeddings and image-style M-RoPE positions
# ---------------------------------------------------------------------------

def vl_model_phase(cfg, params, seed: int):
    """qwen2-vl-7b's prefill of embeddings [VL_PREFILL] with image-style
    positions through make_prefill_step: a warm-up and a timed run, each
    launching the flash kernel's position instance once a layer and the
    index instance never (counts zeroed just before each run, read just
    after); then VL_DECODE_STEPS decode steps of embeddings through
    make_decode_step from an empty cache of SERVE_MAX_LEN.  Seconds and
    the peak device memory of each."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache

    prefill = make_prefill_step(cfg)
    batch = embedding_batch(cfg, VL_PREFILL, seed + 1)
    out = {"phase": "vl_model", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype,
           "param_bytes": tree_bytes(params),
           "prefill_tokens": list(VL_PREFILL),
           "positions": f"text {MROPE_TEXT}, image {MROPE_IMAGE} "
                        f"({MROPE_IMAGE // MROPE_GRID_WIDTH} x "
                        f"{MROPE_GRID_WIDTH} patches), text"}
    secs, launches = [], []
    for _ in ("warm-up", "timed"):
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        t = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        launches.append(dict(FA.instance_launches))
        peak = torch.cuda.max_memory_allocated()   # before the checks' own
        if tuple(logits.shape) != (*VL_PREFILL, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"are not finite or of the wrong shape")
        del logits
    want = expect_instances(cfg, batch, 1)
    if launches != [want] * 2:
        raise AssertionError(f"flash_attention launches per prefill by "
                             f"instance {launches}, expected {want}")
    n_tok = VL_PREFILL[0] * VL_PREFILL[1]
    out.update({"prefill_s": {"warm_up": secs[0], "timed": secs[1]},
                "prefill_tokens_per_s": n_tok / secs[1],
                "flash_attention_launches": launches[1],
                "prefill_peak_bytes": peak})
    del batch
    torch.cuda.empty_cache()

    step = make_decode_step(cfg)
    cache = init_cache(cfg, VL_PREFILL[0], SERVE_MAX_LEN)
    emb = embedding_batch(cfg, (VL_DECODE_STEPS, VL_PREFILL[0]),
                          seed + 2)["embeddings"]
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    finite = []
    t = time.perf_counter()
    for pos in range(VL_DECODE_STEPS):
        logits, cache = step(params, cache, emb[pos], pos)
        finite.append(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    if not bool(torch.stack(finite).all()):
        raise AssertionError("decode logits are not finite")
    out["decode"] = {"steps": VL_DECODE_STEPS, "max_len": SERVE_MAX_LEN,
                     "seconds": decode_s,
                     "s_per_decode_step": decode_s / VL_DECODE_STEPS,
                     "flash_attention_launches": FA.launches[
                         "flash_attention"],
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    del cache, emb
    torch.cuda.empty_cache()
    return out


def vl_trace_phase(cfg, params, seed: int):
    """One qwen2-vl-7b prefill at VL_PREFILL and VL_DECODE_STEPS decode
    steps, each traced on the card: device time by kernel class, the
    flash kernel's share, the idle share and the top device events."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache

    prefill = make_prefill_step(cfg)
    batch = embedding_batch(cfg, VL_PREFILL, seed + 1)
    out = {"phase": "vl_trace", "prefill_tokens": list(VL_PREFILL),
           "decode_steps": VL_DECODE_STEPS,
           "prefill": traced_by_class(lambda: prefill(params, batch))}
    out["flash_share"] = out["prefill"]["device_share_by_class"][
        "flash_fwd"]
    del batch
    torch.cuda.empty_cache()
    step = make_decode_step(cfg)
    cache = init_cache(cfg, VL_PREFILL[0], SERVE_MAX_LEN)
    emb = embedding_batch(cfg, (VL_DECODE_STEPS, VL_PREFILL[0]),
                          seed + 2)["embeddings"]
    out["decode"] = traced_by_class(lambda: [
        step(params, cache, emb[pos], pos) for pos in range(VL_DECODE_STEPS)])
    return out


def vl_phases(seed: int):
    """Run and emit the five qwen2-vl-7b phases in order (vl_model,
    vl_trace, vl_parity, vl_train, vl_train_parity); returns the vl_model
    and vl_train lines (the kernels line reads their launches)."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    cfg = get_config(VL_ARCH)
    params, init_s = init_timed(cfg, seed)
    vl = vl_model_phase(cfg, params, seed)
    vl.update(param_count=count_params(cfg), init_s=init_s)
    emit(vl)
    emit(vl_trace_phase(cfg, params, seed))
    del params
    torch.cuda.empty_cache()
    emit(prefill_parity_phase(
        "vl_parity", replace(replace_layers(cfg, VL_PARITY_LAYERS),
                             compute_dtype="float32"),
        (1, VL_PARITY_TOKENS), seed))
    vl_train = step_train_phase(
        "vl_train", replace_layers(cfg, VL_TRAIN_LAYERS), VL_TRAIN, seed)
    emit(vl_train)
    emit(grad_parity_phase(
        "vl_train_parity", replace_layers(cfg, VL_PARITY_LAYERS),
        (1, VL_PARITY_TOKENS), seed))
    return vl, vl_train


# ---------------------------------------------------------------------------
# every smoke config, and the examples
# ---------------------------------------------------------------------------

def tree_to(tree, device):
    """A copy of a parameter tree on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def smoke_run(cfg, params, batch, device):
    """One prefill of ``batch``, SMOKE_DECODE_STEPS decode steps over its
    first positions from an empty cache (decoders), the loss and every
    gradient leaf and one make_train_step, through launch/steps.py on
    ``device``: the results on the host and the kernels' launches (zeroed
    just before, read just after)."""
    import torch
    from repro_torch.kernels import flash_attention as FA, ssd_scan as SS
    from repro_torch.launch.steps import (
        make_decode_step, make_prefill_step, make_train_step,
    )
    from repro_torch.models import init_cache
    from repro_torch.optim import AdamWConfig, init_opt_state

    p = tree_to(params, device)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    inputs = {k: b[k] for k in ("tokens", "embeddings") if k in b}
    (name, x), = inputs.items()
    FA.reset_launches()
    SS.reset_launches()
    t = time.perf_counter()
    out = {"logits": make_prefill_step(cfg)(p, inputs).cpu(), "decode": []}
    if cfg.is_decoder:
        step = make_decode_step(cfg)
        cache = init_cache(cfg, x.shape[0], SMOKE_DECODE_STEPS,
                           device=device)
        for pos in range(SMOKE_DECODE_STEPS):
            logits, cache = step(p, cache, x[:, pos], pos)
            out["decode"].append(logits.cpu())
    loss, grads = loss_and_grads(p, b, cfg)
    out["loss"], out["grads"] = float(loss), [g.cpu() for g in grads]
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    _, _, m = make_train_step(cfg, opt)(p, init_opt_state(p, opt), b)
    out["step"] = (float(m["loss"]), float(m["grad_norm"]))
    out["seconds"] = time.perf_counter() - t
    out["launches"] = {**FA.launches, **FA.bwd_launches, **SS.launches,
                       **SS.bwd_launches}
    return out


def smoke_configs_phase(seed: int):
    """Every registry config's .smoke() (head_dim 16), fp32 compute, random
    parameters from --seed made on the host: its prefill of tokens (or
    frame embeddings) SMOKE_TOKENS, SMOKE_DECODE_STEPS decode steps, the
    loss, every gradient leaf and one make_train_step (the MoE configs'
    with real fp32 routers, as tests/test_torch_train.py holds them against
    the JAX package), on the card against the port's CPU run of the same
    parameters and inputs, within SMOKE_TOL; each layer's kernels launched as often as the path asks
    (flash_attention for attention, ssd_scan for Mamba layers)."""
    from dataclasses import replace

    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    rows, faults = [], []
    for i, arch in enumerate(ARCH_IDS):
        cfg = replace(get_config(arch).smoke(), compute_dtype="float32")
        params = init_params(torch.Generator().manual_seed(seed), cfg,
                             device="cpu")
        rng = np.random.default_rng([seed, i])
        B, S = SMOKE_TOKENS
        batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        if cfg.input_mode == "tokens":
            batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)
        else:
            batch["embeddings"] = rng.normal(
                size=(B, S, cfg.d_model)).astype(np.float32)
        want = smoke_run(cfg, params, batch, "cpu")
        got = smoke_run(cfg, params, batch, "cuda")
        row = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "head_dim": cfg.head_dim, "tokens": list(SMOKE_TOKENS),
               "cpu_s": want["seconds"], "card_s": got["seconds"],
               "launches": got["launches"],
               "prefill_max_abs_diff": float(
                   (got["logits"] - want["logits"]).abs().max()),
               "decode_max_abs_diff": max(
                   (float((g - w).abs().max())
                    for g, w in zip(got["decode"], want["decode"])),
                   default=None)}
        mixers = [spec.mixer for spec in cfg.pattern]
        n_attn = cfg.n_groups * sum(m.startswith("attn") for m in mixers)
        n_ssm = cfg.n_groups * mixers.count("mamba")
        passes = 3                          # prefill, gradients, the step
        rel = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(got["grads"], want["grads"])]
        worst = max(range(len(rel)), key=rel.__getitem__)
        row.update(
            loss=want["loss"], loss_abs_diff=abs(got["loss"] - want["loss"]),
            grad_leaves=len(rel), grad_max_rel_diff=rel[worst],
            worst_leaf=leaf_paths(params)[worst],
            step_loss_abs_diff=abs(got["step"][0] - want["step"][0]),
            step_grad_norm_rel_diff=abs(got["step"][1] - want["step"][1])
            / max(1.0, want["step"][1]))
        expect = {"flash_attention": passes * n_attn,
                  "flash_attention_bwd": (passes - 1) * n_attn,
                  "ssd_scan": passes * n_ssm,
                  "ssd_scan_bwd": (passes - 1) * n_ssm}
        row["launches_expected"] = expect
        diffs = [row[k] for k in ("prefill_max_abs_diff",
                                  "decode_max_abs_diff", "loss_abs_diff",
                                  "grad_max_rel_diff", "step_loss_abs_diff",
                                  "step_grad_norm_rel_diff")
                 if row.get(k) is not None]
        if not all(d <= SMOKE_TOL for d in diffs):
            faults.append(f"{cfg.name}: card against CPU {diffs}")
        if got["launches"] != expect:
            faults.append(f"{cfg.name}: launches {got['launches']}, "
                          f"expected {expect}")
        rows.append(row)
        del params, want, got
    torch.cuda.empty_cache()
    out = {"phase": "smoke_configs", "configs": rows, "tol": SMOKE_TOL,
           "seconds": time.perf_counter() - t0,
           "launches": {k: sum(r["launches"][k] for r in rows)
                        for k in rows[0]["launches"]}}
    if faults:
        raise AssertionError(f"smoke_configs: {'; '.join(faults)}: {out}")
    return out


def run_example(name: str, device: str):
    """One examples_torch script in a subprocess on ``device``: (seconds,
    stdout lines, the run's kernel launches)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="0")
    args = [str(ROOT / "examples_torch" / f"{name}.py"),
            *EXAMPLE_ARGS.get(name, ()), "--device", device]
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER, *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=EXAMPLE_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"examples_torch/{name}.py --device {device} "
                             f"exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return (time.perf_counter() - t, proc.stdout.splitlines(),
            json.loads(proc.stderr.strip().splitlines()[-1]))


def examples_phase():
    """The nine examples_torch scripts on the card, EXAMPLE_WORKERS
    subprocesses at a time: each must exit 0; the store examples' stdout
    must equal the same script's --device cpu stdout; train_e2e (granite-
    mini, head_dim 32, --steps 60) must end in its bitwise-resume PASS.
    Each run's kernel launches (from zero in a fresh process): the store
    examples must launch the DVV sweeps, quickstart and train_e2e the flash
    forward and backward."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    jobs = [(n, "cuda") for n in EXAMPLES] + \
        [(n, "cpu") for n in STORE_EXAMPLES]
    with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        done = dict(zip(jobs, pool.map(lambda j: run_example(*j), jobs)))
    out = {"phase": "examples", "workers": EXAMPLE_WORKERS, "runs": {
        n: {"device": d, "seconds": s, "lines": len(lines),
            "launches": launches}
        for (n, d), (s, lines, launches) in done.items() if d == "cuda"}}
    faults = []
    for n in STORE_EXAMPLES:
        same = done[(n, "cuda")][1] == done[(n, "cpu")][1]
        out["runs"][n]["stdout_equals_cpu"] = same
        if not same:
            faults.append(f"{n}: the card's stdout differs from the CPU's")
    dvv = sum(out["runs"][n]["launches"][k] for n in STORE_EXAMPLES
              for k in ("dvv_sync_mask", "dvv_read_sweep", "dvv_leq"))
    if not dvv:
        faults.append("the store examples launched no DVV sweep")
    for n in ("quickstart", "train_e2e"):
        got = out["runs"][n]["launches"]
        if not (got["flash_attention"] and got["flash_attention_bwd"]):
            faults.append(f"{n}: flash launches {got}")
    last = done[("train_e2e", "cuda")][1][-1]
    out["runs"]["train_e2e"]["last_line"] = last
    if not last.startswith("PASS: crash/resume is bitwise identical"):
        faults.append(f"train_e2e ends with {last!r}")
    out["seconds"] = time.perf_counter() - t0
    if faults:
        raise AssertionError(f"examples: {'; '.join(faults)}: {out}")
    return out


# ---------------------------------------------------------------------------

def terms(report) -> dict:
    """A roofline report's three terms, its bound and the bound's time."""
    t = {k: report[k] for k in ("compute_s", "memory_s", "collective_s")}
    return {**t, "bound": report["bound"], "bound_s": max(t.values())}


def dryrun_phase(smi: str, measured: dict):
    """The dry run's gemma-2b cell and one-chip estimates (see the module's
    docstring); ``measured`` maps each arch to the card's seconds a step.
    The subprocess's failure or timeout raises."""
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", DRYRUN_SCRIPT, *DRYRUN_CELL,
         json.dumps(list(TRAIN_TOKENS)), *measured],
        capture_output=True, text=True, timeout=DRYRUN_TIMEOUT, env=env,
        cwd=ROOT, check=True)
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    cell = got["cell"]
    out = {"phase": "dryrun", "card": smi,
           "estimate": "priced per device with the H100 SXM data sheet's "
                       "constants (src/repro_torch/launch/roofline.py), no "
                       "card involved",
           "measured": f"this card's seconds a step ({smi})",
           "production": {
               "arch": cell["arch"], "shape": cell["shape"],
               "mesh": cell["mesh"], "chips": cell["roofline"]["chips"],
               **terms(cell["roofline"]),
               "roofline_fraction": cell["roofline"]["roofline_fraction"],
               "useful_flops_ratio":
                   cell["roofline"]["useful_flops_ratio"],
               "flops_per_device": cell["cost"]["flops"],
               "bytes_per_device": cell["cost"]["bytes accessed"],
               "argument_bytes": cell["memory"]["argument_bytes"],
               "temp_bytes": cell["memory"]["temp_bytes"],
               "collectives": cell["collectives"],
               "counted_run_s": cell["seconds"]},
           "one_chip": []}
    bad = [k for k in ("compute_s", "memory_s", "collective_s")
           if not (math.isfinite(out["production"][k])
                   and out["production"][k] > 0)]
    for arch, s_step in measured.items():
        est = got["one_chip"][arch]
        row = {"arch": arch, "tokens": list(TRAIN_TOKENS),
               **terms(est["roofline"]),
               "flops": est["cost"]["flops"],
               "bytes": est["cost"]["bytes accessed"],
               "argument_bytes": est["memory"]["argument_bytes"],
               "measured_s": s_step}
        row["estimate_over_measured"] = row["bound_s"] / s_step
        out["one_chip"].append(row)
        bad += [f"{arch} {k}" for k in ("compute_s", "memory_s", "bound_s")
                if not (math.isfinite(row[k]) and row[k] > 0)]
    if bad or out["production"]["argument_bytes"] <= 0:
        raise AssertionError(f"dry run terms not positive and finite: {bad}")
    out["seconds"] = time.perf_counter() - t
    return out


def ptxas_lines(log: str):
    """ptxas's registers, spills and shared memory for each kernel, and
    its warnings and performance notes (an ignored setmaxnreg, wgmma
    serialised by the compiler)."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("Compiling entry", "spill", "Used",
                                     "warning", "Performance"))]


#: the phase lines kernels_summary reads launches from
SUMMARY_LINES = ("store", "trace", "model", "moe", "ssm", "ssm_train",
                 "train", "audio", "audio_train", "smoke", "examples",
                 "qwen3-14b", "granite-8b", "vl", "vl_train", "moe_train",
                 "grok", "jamba")


def kernels_summary(rows, lines):
    """The last lines' per-kernel summary: one entry per main-path row of
    ``rows`` (the kernels line), its launches read from the phase line of
    ``lines`` (keyed by SUMMARY_LINES) that drives it."""
    replaces = {
        "dvv_sync_mask": "src/repro/kernels/dvv_ops/dvv_ops.py:95",
        "dvv_read_sweep": "src/repro/kernels/dvv_ops/ops.py:47",
        "dvv_leq": "src/repro/kernels/dvv_ops/dvv_ops.py:140",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:93",
        # the gradient of that kernel's function, which the JAX package
        # takes by autodiff of its jnp attention (models/attention.py:105)
        "flash_attention_bwd":
            "src/repro/kernels/flash_attention/flash_attention.py:93",
        "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:77",
        # the gradient of that kernel's function, which the JAX package
        # takes by autodiff of its jnp ssd_chunked (models/ssm.py:106)
        "ssd_scan_bwd": "src/repro/kernels/ssd_scan/ssd_scan.py:77",
        # none: the JAX package's decode attention is jnp
        "decode_attention": "none (jnp: src/repro/models/attention.py:192)",
    }
    # the flash rows in the kernels line and the main-path run whose
    # launches each reads: the models' own, and at head_dim 16 and 32 the
    # launches of the run that drives that width in that dtype (quickstart
    # bf16 at 16, train_e2e bf16 at 32, smoke_configs fp32 at 16)
    store, trace, model, moe, ssm, ssm_train, train, audio, audio_train, \
        smoke, examples, qwen3_14b, granite_8b, vl, vl_train, moe_train, \
        grok, jamba = (lines[k] for k in SUMMARY_LINES)
    runs = examples["runs"]
    flash_paths = {
        "global": ("model", model["flash_attention_launches"], None),
        "qwen3_moe": ("moe_model", moe["flash_attention_launches"], None),
        "qwen3_14b": ("qwen3_14b_model",
                      qwen3_14b["flash_attention_launches"], None),
        "granite_8b": ("granite_8b_model",
                       granite_8b["flash_attention_launches"], None),
        "grok": ("grok_model", grok["flash_attention_launches"], None),
        "jamba": ("jamba_model", jamba["flash_attention_launches"], None),
        # the position instance: qwen2-vl-7b's prefill and training
        "mrope_positions": ("vl_model",
                            vl["flash_attention_launches"]["positions"],
                            None),
        "vl_train": ("vl_train", None,
                     vl_train["instance_launches"]["bwd"]["positions"]),
        "qwen3_moe_train": ("moe_train", None,
                            moe_train["launches"]["flash_attention_bwd"]),
        "hubert": ("audio_model, audio_train",
                   audio["flash_attention_launches"],
                   audio_train["launches"]["flash_attention_bwd"]),
        "gemma_2b": ("train", None,
                     train["launches"]["flash_attention_bwd"])}
    for variants, phase, launched in (
            (("quickstart", "d16_causal", "d16_bidir"),
             "examples: quickstart", runs["quickstart"]["launches"]),
            (("train_e2e", "d32_causal", "d32_bidir"),
             "examples: train_e2e", runs["train_e2e"]["launches"]),
            (("smoke_fp32", "d16_causal_fp32", "d16_bidir_fp32"),
             "smoke_configs", smoke["launches"])):
        for v in variants:
            flash_paths[v] = (phase, launched["flash_attention"],
                              launched["flash_attention_bwd"])
    summary = []
    for r in rows:
        if r["name"] == "flash_attention":
            if flash_paths.get(r["variant"], (0, None))[1] is None:
                continue
            phase, launches, _ = flash_paths[r["variant"]]
            source = "src/repro_torch/kernels/flash_attention/csrc/" \
                     "flash_attention.cu"
            extra = {"variant": r["variant"], "dtype": r["dtype"],
                     "library": r["library"], "main_path": phase,
                     "row_scaled_err": r["row_scaled_err"]}
        elif r["name"] == "flash_attention_bwd":
            if flash_paths.get(r["variant"], (0, 0, None))[2] is None:
                continue
            phase, _, launches = flash_paths[r["variant"]]
            source = "src/repro_torch/kernels/flash_attention/csrc/" \
                     "flash_attention_bwd.cu"
            extra = {"variant": r["variant"], "dtype": r["dtype"],
                     "library": r["library"], "main_path": phase,
                     "row_scaled_err": r["row_scaled_err"],
                     "rms_err_ratio": r["rms_err_ratio"],
                     "device_kernels_ms": r["device_kernels_ms"]}
        elif r["name"] == "ssd_scan":
            if r["variant"] not in ("main_path", "jamba"):
                continue
            phase, line = ("ssm_model", ssm) if r["variant"] == "main_path" \
                else ("jamba_model", jamba)
            launches = line["ssd_scan_launches"]
            source = "src/repro_torch/kernels/ssd_scan/csrc/" + (
                "ssd_passes.cu" if r["path"] == "wgmma" else "ssd_scan.cu")
            extra = {"variant": r["variant"], "dtype": r["dtype"],
                     "main_path": phase,
                     "library": None, "rel_err": r["rel_err"],
                     "path": r["path"],
                     "device_kernels_ms": r["device_kernels_ms"]}
        elif r["name"] == "ssd_scan_bwd":
            if r["variant"] != "train_bf16":
                continue
            launches = ssm_train["launches"]["ssd_scan_bwd"]
            source = r["source"]
            extra = {"variant": r["variant"], "dtype": r["dtype"],
                     "path": r["path"], "library": None,
                     "row_scaled_err": r["row_scaled_err"],
                     "rms_err_ratio": r["rms_err_ratio"],
                     "simple_rms_err_ratio": r["simple_rms_err_ratio"],
                     "bwd_path_launches": ssm_train["bwd_path_launches"],
                     "device_kernels_ms": r["device_kernels_ms"]}
        elif r["name"] == "decode_attention":
            phase, line = ("grok_model", grok) if r["variant"].startswith(
                "grok") else ("jamba_model", jamba)
            launches = line["serve"]["launches_while_serving"][
                "decode_attention"]
            source = "src/repro_torch/kernels/decode_attention/csrc/" \
                     "decode_attention.cu"
            extra = {"variant": r["variant"], "dtype": r["dtype"],
                     "pos": r["pos"], "library": r["library"],
                     "main_path": f"{phase} (serving)",
                     "row_scaled_err": r["row_scaled_err"],
                     "bound_share": r["bound_share"],
                     "device_kernels_ms": r["device_kernels_ms"]}
        elif tuple(r["shape"]) == SUMMARY_SHAPE and "variant" not in r:
            launches = store["launches"][r["name"]]
            source = "src/repro_torch/kernels/dvv_ops/csrc/dvv_ops.cu"
            front = [f["ms"] for f in rows if f.get("variant") == "front_end"
                     and f["name"] == r["name"]
                     and tuple(f["shape"]) == SUMMARY_SHAPE]
            extra = {"path": r["path"],
                     "front_end_ms": front[0] if front else None,
                     "main_path_device_us_per_launch":
                     trace["kernels"][r["name"]]["device_us_per_launch"]}
        else:
            continue
        summary.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces[r["name"]], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "shape": r["shape"], "device_ms": r["device_ms"], **extra})
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build_info
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.dvv_ops import dvv_ops
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import build as build_ssd
    from repro_torch.models import count_params

    # IEEE fp32 for every fp32 product, the plain versions' included
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    start = t = time.perf_counter()
    builds = (dvv_ops.build, flash_attention.build, build_ssd,
              decode_attention.build)
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each, together
        list(pool.map(lambda build: build(), builds))
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": time.perf_counter() - t,
          "nvcc_seconds": {n: i["seconds"] for n, i in build_info.items()},
          "ptxas": {n: ptxas_lines(str(i["log"]))
                    for n, i in build_info.items()}})

    rows = dvv_rows(args.seed) + flash_rows(args.seed) + \
        flash_mrope_row(args.seed) + flash_bwd_rows(args.seed) + \
        ssd_rows(args.seed) + ssd_bwd_rows(args.seed) + \
        decode_attention_rows(args.seed)
    emit({"phase": "kernels", "rows": rows})
    store = store_phase(STORE_KEYS, args.seed)
    emit(store)
    emit(parity_phase(PARITY_KEYS, args.seed))
    trace = trace_phase(PARITY_KEYS, args.seed)
    emit(trace)
    emit(store_workload_phase(args.seed))
    emit(geo_phase(GEO_KEYS, args.seed))
    smoke = smoke_configs_phase(args.seed)
    emit(smoke)
    examples = examples_phase()
    emit(examples)

    cfg = get_config(ARCH)
    params, init_s = init_timed(cfg, args.seed)
    model = model_phase(cfg, params, args.seed)
    model.update(param_count=count_params(cfg), init_s=init_s)
    emit(model)
    emit(model_trace_phase(cfg, params, args.seed))
    del params
    torch.cuda.empty_cache()
    emit(model_parity_phase(args.seed))

    cfg = get_config(SSM_ARCH)
    params, init_s = init_timed(cfg, args.seed)
    ssm = model_phase(cfg, params, args.seed, phase="ssm_model",
                      tokens=SSM_PREFILL)
    ssm.update(param_count=count_params(cfg), init_s=init_s)
    emit(ssm)
    emit(model_trace_phase(cfg, params, args.seed, phase="ssm_trace",
                           tokens=SSM_PREFILL, kernel=SSD_KERNELS))
    del params
    torch.cuda.empty_cache()
    emit(ssm_parity_phase(args.seed))

    moe, grok = (moe_phases(tag, seed=args.seed, **kw)
                 for tag, kw in MOE_SERVE.items())
    jamba = jamba_phases(args.seed)
    dense = dense_phases(args.seed)
    vl = vl_phases(args.seed)

    train = train_phase(args.seed)
    emit(train)
    emit(train_parity_phase(args.seed))
    ssm_train = train_phase(args.seed, arch=SSM_ARCH, phase="ssm_train",
                            kernel=SS, save=False)
    emit(ssm_train)
    emit(ssm_train_parity_phase(args.seed))
    moe_train = moe_train_phases(args.seed)
    audio, audio_train = audio_phases(args.seed)
    emit(dryrun_phase(smi, {
        TRAIN_ARCH: train["s_per_step_after_first"],
        SSM_ARCH: ssm_train["s_per_step_after_first"]}))

    summary = kernels_summary(rows, dict(
        store=store, trace=trace, model=model, moe=moe, ssm=ssm,
        ssm_train=ssm_train, train=train, audio=audio,
        audio_train=audio_train, smoke=smoke, examples=examples, **dense,
        vl=vl[0], vl_train=vl[1], moe_train=moe_train, grok=grok,
        jamba=jamba))
    emit({"phase": "wall", "seconds": time.perf_counter() - start})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
