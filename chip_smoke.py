#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(nvcc, at first use), holds each kernel against its plain PyTorch version
on the card, checks the port on the card against the port on the CPU, and
drives these paths through the public entry points: the paper's §VIII
saturation path at PolarFly PF(31) (993 routers, p = 16 endpoints each,
about 16k endpoints) and on the five other topologies of the paper's
Table V at the paper's sizes (Slim Fly, two Dragonflies, Jellyfish, a fat
tree), the paper's Fig. 9 (PF(31)'s adversarial permutations: saturation,
latency, truncation error), Fig. 11 (PF(31) grown by quadric and
non-quadric replication) and Fig. 14 (diameters under link failure up to
5551 routers, a damaged PolarStar's saturation through the blocked
routing stack), the flit-level packet engine (tail latency, bursts,
a link-failure transient) at PF(31), the structural-analysis path (the
§IV-D routing table, the §IX diameters under link failure, the blocked
routing on the device BFS) at PF(31) and at the repo's PF(79) scale tier
(6321 routers), the reference's scale tier through the blocked routing
stack (PF(79) and PF(157) saturations, the PF(79) packet point), the
paper's Fig. 10 size sweep (PF(13) .. PF(43)), Fig. 8's PF(79) point and
Fig. 15's measured cost ratios, and the
prefill and serve paths of the dense transformer
(Gemma2-9B), the MoE family (deepseek-moe-16b, qwen2-moe-a2.7b), the
Griffin hybrid (recurrentgemma-9b), the SSM (falcon-mamba-7b) and the
encoder-decoder (whisper-base), each at its full published width, and
the training path (qwen2-0.5b at its full width, through the
tensor-core flash-attention backward kernel), the sharded path (the
same training and the deepseek-moe-16b prefill on a (1, 1) DeviceMesh),
the launch tools' cells on one card (qwen2-0.5b's decode_32k and
train_4k at their planned memory), and the sharded path with one process
a card over every visible card (up to four: qwen3-4b's train_4k step at
the plan that needs four cards, expert parallelism, GPipe, elastic
restarts, decode).  Each path's kernel counts are set to 0 just before
it and read just after.  Phases, one JSON line each
(``python3 chip_smoke.py train`` runs the named phases alone, a
development run that then fails for the kernels it did not launch):

  lint       first, on the host: the port's linter (`python -m
             repro_torch.analysis.lint`, reprolint-torch) over
             src/repro_torch and this script, resolved from this
             script's directory; any finding fails the run.  Its
             files_scanned and suppressed findings by rule.  And its
             host-sync rule held against the card's own detector: on the
             lines that the certified and packet phases run under
             torch.cuda.set_sync_debug_mode("error")
             (fluid._saturation_batch_traced and what it calls in
             fluid.py, packet._BatchedRun.run / .cycle and what they
             call, the path_costs wrapper), the rule reports nothing,
             raw or suppressed
  device     the card's name and power limit
  build      the nvcc build and its seconds, ptxas's register and spill
             report, and `cuobjdump -sass`'s HGMMA count of each
             tensor-core kernel (the build fails without one)
  kernels    each kernel against its plain version (the first four bit
             for bit, tolerance 0), at the test shapes, at one shape per
             route its launch plan can choose, and at the paths' shapes:
             path_costs in fp32 and fp64 (L = 1..5, a misaligned base,
             PF(31) uniform ugal_pf); minplus (float) with INF entries, at
             one and several k ranges, with and without the wrapper's
             padded copy, on APSP's first two squarings of damaged PF(31)
             (padded 996 x 996 and 993 x 993) and a 256-row slice of
             PF(79)'s; minplus_hops (the int16 DPX route `apsp` takes) on
             the same squarings and whole damaged PF(31) and PF(79) APSPs
             against the float route's and PF(31)'s against the plain
             float APSP; gf_crossprod at every q in 2..79, composite
             and prime, at 121, 1290, 46337 and 46340 (the largest q the
             wrapper takes), at n m = 0, 1, 2, 3 mod 4, and on PF(31)'s
             and PF(79)'s full vertex lists.  Kernel, plain and library times
             (CUDA events, median of 30 (3 for a plain version slower than
             0.1 s), L2 emptied of the inputs before each sample) beside
             the bound
  parity     PF(13), p = 7, random_perm: the port on the card against the
             port on the CPU; certified saturations too (ugal, ugal_pf; tol
             0.05, cert_iters 512: values within 0.06, brackets
             overlapping, the same kind)
  main_path  PF(31), p = 16, seed 0: uniform and random_perm x {min, ugal,
             ugal_pf} saturations (tol 0.01; iters 250 for min, 1500 for
             the adaptive modes), each with its wall seconds and kernel
             launches, against the JAX package's values recorded in
             tests/fixtures/torch_port_pf31_reference.json
  table5     the paper's Table V comparison: bench_fig8_saturation.py's
             grid on the five competitors of `paper_table5_configs(seed=0)`
             at the paper's sizes, Slim Fly SF(23) (1058 routers),
             Dragonflies DF(12, 6) and DF(6, 27) (876, 978), Jellyfish
             (993, radix 32) and the three-level fat tree FT(18, 3) (972
             switches, traffic on its 324 leaf switches): uniform and
             random_perm, p = max(2, radix // 2), seed 0, min / ugal /
             ugal_pf (ecmp alone on the fat tree), k_candidates 10,
             `saturation_throughput(tol=0.01, engine="batched")` at 250
             iterations (oblivious) or 1500 (adaptive), the grid read from
             tests/fixtures/torch_port_table5_reference.json's `config`.
             Routing tables, patterns and FlowPaths equal to the fixture's
             sha256; oblivious saturations equal to the JAX package's,
             adaptive ones above 0, within 0.05 and within one bisection
             step (1/128) of the reference's, or of the band its own runs
             with the demand one ulp up and down span where the fixture
             has them (`ulp_band`, scripts/table5_sensitivity.py);
             path-cost
             launches iters + the
             probes' schedule an adaptive run (the generic L > 4 kernel on
             the Dragonflies and Jellyfish, whose paths are L = 6), 0 an
             oblivious one.  Each run's [F, K, L], launch plan (`rows`, 0
             for the generic kernel), link-load route (`loads`: "pad" or
             "scatter"), stage seconds and the reference
             beside the port; the PF(31) row from main_path, so the whole
             Table V prints; then path_costs at each adaptive
             topology's uniform ugal_pf shape (DF(6, 27)'s [112,651, 11,
             6] among them) against its plain version (bit for bit) and
             `embedding_bag`, timed beside its bytes bound.  The kernel
             line's path_costs entry takes `launches_table5` and
             `table5_shapes`
  figures    the paper's remaining fluid figures, the grid read from
             tests/fixtures/torch_port_figures_reference.json's `config`
             and every solve on the card.  Fig. 9
             (bench_fig9_adaptive.py) at PF(31), p = 16, seed 0,
             k_candidates 10, tol 0.01, 250 / 1500 steps: perm1hop,
             perm2hop and tornado under min, ugal and ugal_pf, each run's
             saturation, its `latency_curve` mean latency at the
             reference's `fig9_load` and, adaptive, its
             `truncation_error` at the reference's saturation; random_perm
             the latency and truncation rows alone (main_path holds its
             saturations).  Fig. 11 (bench_fig11_expansion.py): PF(31)
             and `expand(layout, 2 | 4, "quadric" | "nonquadric")`, each
             routed by `build_routing(g)` alone (the base with its
             PolarFly), uniform p = 16, ugal_pf, k_candidates 8, tol
             0.02, 1500 steps (the non-quadric graphs have diameter 3:
             paths of L = 6 through the generic kernel).  Fig. 14
             (bench_fig14_resilience.py): diameter and ASPL of PF(13),
             SF(9), JF(183, 14), DF(6, 3) at 0.05 / 0.2 / 0.4 / 0.55 and
             of PS(9, 61), JF(5551, 40) at 0.05 / 0.2 links removed in
             `resilience_sweep`'s order, seed 1, on the device BFS; and
             `_run_large_fluid`'s point: PS(9, 61) less default_rng(1)'s
             5 % of its links, `build_blocked_routing` on the device BFS
             (diameter 4), 512 host routers, p = 20, min, tol 0.02.
             Bars: graphs, routing tables, patterns and FlowPaths equal
             to the fixture's sha256; oblivious saturations equal;
             adaptive ones above 0, within 0.05 and within one bisection
             step of the band the reference's runs span with the demand
             moved up to 2 ulps each way (Fig. 11: 1), `table5_bar`;
             latencies within LATENCY_REL (1e-3) relative of theirs or
             of that band; truncation gaps finite, >= 0 and in their
             band over the one-ulp moves widened each way by the
             fixture's `truncation_factor` (scripts/table5_sensitivity.py
             --figures); diameters and
             ASPLs equal; path-cost launches iters + the probes'
             schedule an adaptive saturation, iters + 1 an adaptive
             latency point (1 an oblivious one), iters a truncation gap,
             0 an oblivious saturation.  Each run's [F, K, L], launch
             plan, link-load route (`loads`) and stage seconds; then
             path_costs at fig9's [993, 11, 4] and the non-quadric x4
             graph's [114,329, 9, 6] against its plain version (bit for
             bit) and `embedding_bag`, timed beside its bytes bound.  The
             kernel line's path_costs entry takes `launches_figures` and
             `figures_shapes`
  certified  the same PF(31) flows through the certified engine
             (`certify=True`, tol 0.01, the default budget): random_perm
             ugal and ugal_pf and uniform ugal (the kernel at full width)
             against the JAX package's certified saturations in
             tests/fixtures/torch_port_pf31_certified.json: value within
             0.06, sat_lo and sat_hi each within one tol step of the
             range the reference's own bracket end spans when its demand
             moves one ulp up or down (its `ulp_runs`), sat_lo <= value,
             the same kind, the uncertified fixture value within [sat_lo
             - 0.06, sat_hi + 0.06]; path-cost launches equal to (probes
             + 1) + 33 * iters / 32 in each; one float64 certified
             `evaluate_load` on uniform ugal at half its saturation,
             512 steps (path_costs_f64 launches only, 2 + 33 * iters /
             32 of them).  Tracing: the random_perm ugal_pf certified
             saturation twice at `CERT_TRACE_ITERS` steps a solve (a depth
             cut), untraced and with trace=True, bit-identical and with
             trace.final_gap == cert.gap; the main path's
             random_perm ugal uncertified saturation with trace=True,
             bit-identical to main_path's value, its solve run under
             torch.cuda.set_sync_debug_mode("error") (it reads nothing
             back on the host)
  packet     the flit-level packet engine at PF(31) (31,744 directed
             links), bench_fig_tail.py's settings (p = 16, k_candidates
             8, seed 0, 600 cycles, 4-flit packets, 32-packet queues):
             uniform min and ugal_pf at offered 0.3, steady and on-off
             bursts (BurstSchedule(20, 60)); random_perm min, ugal and
             valiant at 0.1; uniform ugal at 0.3 with 3 links failed at
             cycle 250.  Each run held against the JAX package's in
             tests/fixtures/torch_port_pf31_packet.json (sha256 of the
             workload's arrays and of delivered, dropped,
             deliver_t[delivered], occ_sum, occ_max; counts; tails) and
             tests/test_packet_engine.py's conservation spot checks; its
             wall seconds (a second run after the checked one), cycles
             and delivered packets a second, packet_peak_bytes.  Four
             same-shape replicas of the random_perm valiant workload
             through simulate_packets_batch against their single runs;
             the failure run again under
             torch.cuda.set_sync_debug_mode("error"); one cycle of it
             under torch.profiler (launches, device time, idle share).
             The engine has no hand-written kernel (the reference's has
             no Pallas kernel either): it launches PyTorch's own, so it
             adds no row to the kernel line
  analysis   §IV-D: `intermediate_table` at PF(31) against the host
             `intermediates_all_pairs()` off the diagonal, and at PF(79)
             on 4096 seeded random pairs against the host
             `intermediate(s, d)`.  §IX, Fig. 14's failure fractions in
             `resilience_sweep`'s cumulative order, seed 1: PF(31)
             `diameter_from_adj` at 0.05/0.2/0.4/0.55 against the host
             sweep's diameters (-1 <-> inf); PF(79) at 0.05/0.2, the APSP
             distance matrix against the device BFS
             (`distance_blocks(backend="sharded")`) over all pairs, and
             `diameter_and_aspl(backend="sharded")` against it.  Blocked
             routing: PF(31) `build_blocked_routing(backend="sharded")`
             next-hop columns against the host backend's.  Wall seconds
             and launches for each (10 minplus_hops launches per PF(31)
             APSP, 13 per PF(79) one, none of the float minplus kernel, 1
             gf_crossprod launch per table)
  scale      the reference's scale tier through the blocked routing
             stack (never an [n, n] table), every BFS sweep on the card,
             spread over every visible card (`devices=
             torch.cuda.device_count()`; each card's context made before
             the first timed stage), the points' settings read from the
             fixture's `config`: fig10's PF(79) point (6321
             routers, `build_blocked_routing` with its n-source BFS,
             diameter 2; uniform p = 40, 60,000 sampled flows, ugal_pf,
             k_candidates 8, seed 0; `saturation_throughput(tol=0.02,
             engine="batched")` at 3000 iterations within one bisection
             step (1/64) of the JAX package's, fig10's 1500-iteration
             reading beside it);
             bench_fig_tail.py's PF(79) packet point on that routing
             (p = 8, ugal_pf, `make_workload(0.3, 400 cycles,
             flow_sample=8000, max_packets=1,500,000)`: workload and
             result hashes, counts and p50/p99/p999 equal, a second run
             equal, packet_peak_bytes beside the card's memory); and
             bench_blockwise_scaling.py's LARGE tier at PF(157) (24,807
             routers): 24 blocks of 8 destinations from default_rng(0)
             through `destination_blocks` on the card, bit for bit the
             JAX host engine's columns (the fixture's hashes), then
             `build_blocked_routing(block=8, diameter=2)`, uniform p = 79,
             60,000 flows, min, `tol=0.005`, 250 iterations, equal to
             the JAX package's.  Every FlowPaths (pattern, edges, hops,
             valid, is_min, first_edge) equal to
             tests/fixtures/torch_port_scale_reference.json's sha256.
             Per point the wall seconds of graph, routing (the device
             BFS), pattern, path build, saturation or packet run, the
             path-cost launches of each saturation (iters + the probes'
             schedule for ugal_pf, 0 for min) and the cards used; then
             path_costs at the two points' shapes (PF(79) ugal_pf [F, 9,
             4], PF(157) min [F, 1, 4]) against its plain version (bit for
             bit) and `embedding_bag`, timed beside its bytes bound (the
             table entries the flows touch, read once), each with the
             launches its point made (`on_path` false at PF(157): min
             bypasses the kernel, so that shape is timed off the path).
             The scale path's launches go on the kernel line as
             `launches_scale`
  sizes      the paper's last device figures, the grid read from
             tests/fixtures/torch_port_sizes_reference.json's `config`,
             every solve on the card.  Fig. 15 (bench_fig15_cost.py):
             fig8's PF(13), SF(9), DF(6, 3) and FT(8, 3) (traffic on the
             fat tree's leaf switches), ugal_pf (ecmp on the fat tree) at
             uniform and random_perm, k_candidates 10, tol 0.01, and the
             cost ratios from the benchmark's PORTS, each inside the
             interval its held saturations allow.  Fig. 8's large point
             (`_run_large`): PF(79) on the scale phase's blocked routing,
             p = 40, uniform and random_perm at 60,000 flows, min and
             ugal_pf, k_candidates 10, tol 0.01.  Fig. 10
             (bench_fig10_sizes.py) at PF(13 .. 43), p = (q + 1) // 2,
             uniform, ugal_pf (150,000 flows) then min (all pairs, up to
             3.58M flows at PF(43)), k_candidates 8, tol 0.02
             (`SIZES_PHASE_MODES`, `SIZES_PHASE_POINTS`; SF(23), SF(27),
             PS(7, 49) and the large tier PS(9, 61), SF(43), PF(79),
             JF(6321, 80) run in scripts/sizes_cards.py).  Bars: graphs, routing tables,
             patterns and FlowPaths equal to the fixture's sha256;
             oblivious saturations equal, or one step above where the
             reference refused that load by a tie, its max link
             utilization there within TIE_REL of 1 and the card's too
             (`oblivious_bar`, `tie_loads`: PF(13), PF(25) and PF(43)
             min, whose links are filled exactly to capacity at load 1);
             adaptive ones above 0,
             within 0.05 and within one bisection step of the
             reference's or of its ±1-ulp band where the fixture has one
             (`figure_bars`; Fig. 15's PF and SF random_perm);
             ugal_pf truncation gaps at the reference's saturation in the
             reference's band widened by the figures fixture's
             `truncation_factor` each way; path-cost launches iters + the
             probes' schedule a saturation, iters a gap.  Each run's
             [F, K, L], launch plan, link-load route (`loads`) and stage
             seconds; then path_costs at the largest PolarFly ugal_pf
             shape and the longest paths' against its plain version (bit
             for bit) and `embedding_bag`, timed beside its bytes bound.
             The kernel line's path_costs entry takes `launches_sizes`
             (the run fails at 0) and `sizes_shapes`
  model      Gemma2-9B at its published widths (d_model 3584, 16/8 heads
             of 256, d_ff 14336, vocab 256000, window 4096, softcaps
             50/30), bf16, random parameters from seed 0, all 42 layers
             (no depth cut): the prefill (`forward` on B = 1, S = 8192)
             with its wall seconds, flash-attention launches (one a
             layer, all of them the sm90 tensor-core kernel: 42) and
             finite logits, and a torch.profiler breakdown of one more
             prefill; `launch.serve.generate` answering 4
             greedy requests (prompt 16, 16 new tokens) after one warm-up
             run, two timed runs and their median tokens/s (a smoke
             reading, not a serve rate), and one profiled decode step;
             then float32 at full width with 4 layers (two local/global
             pairs), B = 2, 48 tokens, TF32 off: step-by-step
             `decode_step` logits against the kernel-backed `forward`
             (4 launches, all of them the CUDA-core kernel),
             and the card's `forward` against the port's on the CPU from
             the same parameters, both at rtol = atol = 2e-3
             (tests/test_models.py's decode-vs-forward bar)
  moe        the same three steps (`drive_lm`) for deepseek-moe-16b (dense
             layer0 + MoE layers, 64 experts top-6, 2 shared) and
             qwen2-moe-a2.7b (MoE layers, 60 experts padded to 64, top-4,
             QKV bias), one after the other, every expert and vocabulary
             entry, each depth cut to a quarter of its layers
             (`DEPTH_CUT`: 7 of 28, 6 of 24; the sharded phase runs
             deepseek-moe-16b's prefill at all 28), each model freed
             before the next is built: the prefill on B = 1, S = 4096 (the
             capacity buffers grow with S) with one sm90 launch an
             attention layer (7, 6) and a torch.profiler
             breakdown (attention, the router, dispatch + combine, the
             expert GEMMs); the 4-request serve run, dropless; float32
             at 2 layers (`CONSISTENCY_LAYERS`: deepseek's layer0 and one
             MoE layer) with the capacity factor at the padded expert
             count, so the forward drops nothing either
  hybrid     the same for recurrentgemma-9b (38 layers: 12 (rec, rec,
             attn) groups + 2 recurrent ones; windowed MQA, 16 q heads on
             one kv head of 256, window 2048; 17.2 GB), depth cut to 19
             of them (`DEPTH_CUT`: 6 groups + 1 recurrent layer): 6 sm90
             launches a prefill, the RG-LRU scan's device time in the
             breakdown;
             float32 at 5 layers (one group + 2 tail layers, 1 CUDA-core
             launch)
  ssm        the same for falcon-mamba-7b at its published widths (d_model
             4096, d_inner 8192, state 16, dt_rank 256, vocab 65024),
             depth cut to 16 of its 64 layers (`DEPTH_CUT`): the
             S = 4096 prefill is 16 scan chunks of 256 a layer and
             launches no flash kernel; the selective scan's share of the
             prefill's device time in the breakdown; float32 at 4 layers
  encdec     the same for whisper-base (6 + 6 layers, d_model 512, 8 heads
             of 64, 1500 frames; no depth cut anywhere): random bf16 frames
             (the model's dtype, so the encoder keeps the sm90 route; the
             serve CLI draws float32 ones, as the reference) with every
             forward and every `init_cache`; the prefill on 1500 frames and 448 tokens
             (the published text context) with 12 sm90 launches (6
             non-causal at S = 1500, 6 causal at S = 448); the serve run
             with 6 launches an `init_cache` (the encoder) and none a
             decode step; float32 of the whole model (12 CUDA-core
             launches) on 1500 frames
  train      the training path (`train.make_train_step`, as
             `launch.train --preset full --data fixed` builds it): both
             flash-attention backward kernels (through the autograd
             Function around both forward kernels: the tensor-core
             csrc/flash_attention_bwd_sm90.cu for bf16 at D = 64 and
             128, fed the sm90 forward's logsumexp, the CUDA-core
             csrc/flash_attention_bwd.cu for the rest) against their
             plain version (autograd through `attention_ref`) at
             FLASH_CASES in both dtypes, at a qwen2-0.5b train layer (B =
             4, 14/2 heads, S = 2048, D = 64, causal; bf16 and fp32),
             Gemma2-9B's local layer (16/8 heads, D = 256, softcap 50,
             window 4096, S = 4096; fp32) and whisper-base's encoder (8/8
             heads, D = 64, non-causal, S = 1500; bf16 and fp32), each
             gradient within FLASH_BWD_TOL of its largest magnitude, with
             the routed kernel's time (CUDA events, median of 10; the
             tensor-core one given the forward's lse, its forward left
             out), the
             CUDA-core kernel's on the same bf16 inputs, the plain
             version's and SDPA's backward beside the bound (10 D flops a
             pair and head at the bf16 tensor-core rate); then
             qwen2-0.5b at its published widths (24 layers, d_model 896,
             14/2 heads of 64, d_ff 4864, vocab 151,936, tied), bf16,
             remat "full", AdamW(cosine_schedule(1e-3, 10, 11),
             weight_decay 0), one fixed batch of B = 4, S = 2048, 11 steps
             (the first a warm-up): per step the loss, grad norm and wall
             ms, 48 sm90 and 24 tensor-core backward launches (0
             CUDA-core) a step, the loss finite
             and falling by at least 0.5, tokens/s, peak memory, a
             torch.profiler breakdown of one more step (the backward
             kernel's share) and its forward / backward / optimizer
             split beside TRAIN_BEFORE_UNBIND's, the first loss equal to
             TRAIN_BEFORE_UNBIND's (the layers' stacked parameters are
             taken apart by one unbind a leaf, which must not move it)
             and no select_backward writing a whole layer stack in the
             step's backward (one stack a stacked leaf); remat "2level"
             on the same model, state and batch (6 outer groups of 4),
             two steps from the initial state beside two of "full": the
             losses and every gradient leaf bit for bit "full"'s, 66 sm90
             and 24 tensor-core backward launches a step (each layer's
             forward, then its outer group's recompute, which stops at
             the group's last input, then its own), wall ms, device ms
             and peak memory beside "full"'s; float32 without remat (B =
             2, S = 512, 3 steps: 24 CUDA-core forward and 24 CUDA-core
             backward launches a step, finite and falling); one float32 step at full width and 2 layers (B =
             2, S = 128, TF32 off) on the card against the CPU (loss
             within 1e-5 relative, grad norm 1e-4, every gradient leaf
             within 1e-4 of its largest magnitude, every attention weight
             with a nonzero gradient); and a restart: the state after
             step 1 saved with `train.checkpoint.save`, restored, and
             step 2 run from both, bit for bit
  sharded    the sharded path on a ("data", "model") = (1, 1) CUDA mesh
             (NCCL, a world of one through a FileStore in a temp dir,
             DEFAULT_RULES): every collective an identity, every DTensor
             path and kernel under it run.  `local_map` attention against
             `ops.attention` at the qwen2 train layer (output and
             gradients bit for bit; a DTensor straight to the wrapper
             raising); qwen2-0.5b as in `train` (bf16, remat, B = 4, S =
             2048, the fixed batch), its state placed by
             `elastic.reshard_state` (every leaf a DTensor): one warm-up
             step and 3 more through `make_train_step(param_specs=,
             mesh=)` beside as many meshless ones, 48 sm90 + 24
             tensor-core backward launches a step, the first loss bit for
             bit the meshless one, both medians, both peaks, a profile of
             one sharded step; elastic: that state saved, restored onto a
             fresh (1, 1) mesh and onto none, one step each, the losses
             bit for bit; float32 at 2 layers (B = 2, S = 128): loss within
             1e-6 relative and every gradient leaf within 1e-5 of its
             largest magnitude of the meshless step's; deepseek-moe-16b's
             S = 4096 prefill through expert parallelism (64 local
             experts, an all-reduce over a group of one; the parameters
             the meshless model's, not copied): logits bit for bit, 28
             sm90 launches, both walls after a warm-up at the same shape.
             `parallel.pipeline.gpipe` runs its card check in ``cards``
             (one stage a card)
  launch     the launch tools on one card (`launch.cells`, `roofline`,
             `cost`, `dryrun`, `memdebug`): the card's name and power
             limit, a measured bf16 GEMM rate (8192^3 `torch.matmul`) and
             device-to-device copy rate (4 GiB) beside `roofline.H100_SXM`;
             decode on a (1, 1) mesh (qwen2-0.5b and deepseek-moe-16b at
             full width, 2 layers, 8 steps) bit for bit the meshless
             decode's; qwen2-0.5b's `decode_32k` cell (B = 128, a 32,768-slot
             bf16 KV cache) planned by `plan_cell` at the card's memory on a
             (1, 1) `MeshShape`, one warm and one timed `decode_step`: the
             plan's estimate beside `max_memory_allocated` and the step's
             wall; its `train_4k` cell (256 sequences of 4096) at the
             plan's microbatch size (the planner's candidates stop at 32,
             so one sequence a microbatch), cut to 32 of the sequences
             (`LAUNCH["train_batch"]`, 32 microbatches, 131,072 tokens):
             one step under `launch.cost`'s trace, 2 * 24 * 32 sm90 and
             24 * 32 tensor-core backward launches, the estimate beside
             the peak, the step's per-device FLOPs equal to the dry run's
             for the same cut cell on a world of one (`dryrun --mesh one
             --batch 64 --microbatches 64`, meta tensors on the CPU, in a
             subprocess beside the card's work),
             `roofline`'s step_bound_s on the datasheet rates beside the
             wall; and memdebug's card mode: the 10 largest blocks live at
             the peak of a step of 8 sequences at the same microbatch
             size, under `torch.cuda.memory._record_memory_history`
  cards      the sharded path with one process a card (``launch.ranks.
             run_ranks``: torch.multiprocessing spawn, NCCL through a
             FileStore in a temp dir, ``cuda:r`` for rank r, a deadline)
             over every visible card, rounded down to a world of 4, 2 or
             1 ranks: a (2, 2), (1, 2) or (1, 1) ("data", "model") mesh.
             Card 0 is freed of this script's tensors and cached blocks
             first.  The rank functions are ``launch.cards``'
             (``CARD_PARTS``), each part held against the port's own
             meshless run on card 0, every rank's seeded draws held bit
             for bit equal: qwen3-4b float32 at full width, 2 layers (B =
             4, S = 512): one sharded step under DEFAULT_RULES, with
             sequence parallelism, under FSDP_RULES and with 2
             microbatches against the meshless step (loss 1e-5, every
             gradient leaf 2e-5 of its largest magnitude, every updated
             parameter 2e-5 where its gradient is at least 1e-6);
             greedy decode of qwen2-0.5b and deepseek-moe-16b (full
             width, 2 layers, float32, B = 4, 8 steps): tokens equal,
             logits within 1e-5; deepseek-moe-16b's S = 4096 prefill
             through expert parallelism on (1, world) (16 local experts
             a card on four), float32 at 4 layers with every MoE
             routing observed: the ranks' logits and routes and a second
             run bit for bit equal, every token whose experts differ
             from the meshless run's a near tie (or a capacity drop
             after one in its group), the tokens no such token reaches
             within 1e-5 (relative RMS), each MoE layer alone within
             1e-5 at every token; bf16 at 28 layers: the greedy next
             token equal, the EP logits' distance from the float32
             prefill of the same parameter values within 1.1x the
             meshless bf16 logits', 28 sm90 launches a rank, both walls;
             elastic: the 2-layer qwen3-4b state after 2 steps saved on
             the world, restored onto a new world of half the cards and
             onto no mesh, one step each and one on the live state, the
             losses within 1e-4 (a world of one runs neither elastic,
             having no smaller world, nor the bf16 prefill, which the
             ``sharded`` phase runs on (1, 1)); on four cards qwen3-4b `train_4k` at full depth,
             bf16, planned by `plan_cell` on the live (2, 2) mesh at the
             card's memory, one step of 2 of the plan's microbatches
             (the state whole, the peak one microbatch): a finite loss,
             wall, 144 sm90 + 72 tensor-core backward launches a rank,
             the peak beside the plan's estimate, a profile (NCCL
             kernels by name, device busy and idle share), the bus rates
             of the step's collectives and its roofline bound at that
             link rate (with fewer cards the line says this part needs
             four); both sm90 flash kernels timed on each rank's card at
             that step's local attention shape; `gpipe` of tanh(x @ w_i)
             over one stage a card (D = 4096, 8 microbatches of 256,
             float32) within 2e-5 of the stack run in order on card 0.
             Each rank's flash launches (and the cards their inputs lay
             on) are on the phase's line, not in the kernel line.  The
             per-rank records go to build/chip_smoke_cards.json

The kernels phase also holds both flash-attention kernels against their
plain version: the sm90 tensor-core kernel (csrc/flash_attention_sm90.cu,
where `ops.attention` sends bf16 at D = 64, 128, 192, 256) and the
CUDA-core kernel (csrc/flash_attention.cu, where it sends float32, and in
bf16 through `ops._launch`, the route bf16 takes at other head dims), at
tests/test_kernels.py's five cases, a ragged S = 200, nemotron's head dim
(D = 192, 12 q heads a kv head) and a ragged S = 333 at D = 256, and at the
prefill's shapes (B = 1, 16/8 heads, S = 8192, D = 256, softcap 50,
causal, window 4096 and none), and the sm90 kernel at the MoE prefill's
(B = 1, 16/16 heads, S = 4096, D = 128, causal, no softcap, no window:
SDPA computes the same function there, and its time is the library time)
and the hybrid prefill's (B = 1, 16/1 heads, S = 4096, D = 256, window
2048), and both kernels (fp32, bf16) at whisper-base's encoder (B = 1
and 4, 8/8 heads, S = 1500, D = 64, non-causal: 1500 is ragged against
every tile) and decoder (B = 1, S = 448, causal), with SDPA's time beside
them (the same function).  fp32 is held at 2e-6, the JAX test's bar.
bf16 is held at the JAX test's 2e-2 and, element by element, within one
bf16 rounding of the plain version (2^-7 |ref| + 1e-5): the kernels and
the plain version compute in fp32 (the sm90 kernel with p split into two
bf16 operands) and round once, and at the prefill's shapes, where |out|
is about 0.01, 2e-2 alone would pass a kernel that drops a key.  Both
kernels' times (bf16), the plain version's and the bound at the prefill's
shapes and, at the same shape without softcap, the kernels' beside
`scaled_dot_product_attention`'s (the library time; the port never calls
it).  In the kernel table the sm90 kernel's launches are the Gemma2-9B
bf16 prefill's (the MoE, hybrid, SSM and encoder-decoder prefills' in
`launches_by_path`, its times at their shapes in `other_path_shapes`),
the CUDA-core kernel's those of the Gemma2-9B float32 consistency run
(whisper-base's and the float32 train run's in `launches_by_path`), the
tensor-core backward's those of the bf16 train run (11 steps), the
CUDA-core backward's those of the float32 train run (3 steps), both
backwards' times the qwen2-0.5b bf16 train layer's; the sharded path's
launches (through `local_map`) are in each kernel's `launches_by_path`.

Then the kernel table, the card's `nvidia-smi` name and power limit, and
last the result line.  Any failed phase makes the exit code non-zero and
suppresses the result line; so does a missing card or a checkout without
`src/repro_torch`.  A full record goes to build/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_pf31_reference.json")
CERT_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "torch_port_pf31_certified.json")
PACKET_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_pf31_packet.json")
# the scale tier's settings (its `config`) and the JAX package's results:
# fig10's PF(79) adaptive point (held at 3000 iterations, fig10's 1500
# printed beside it), bench_blockwise_scaling.py's LARGE tier at PF(157)
# and bench_fig_tail.py's PF(79) packet point
SCALE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "torch_port_scale_reference.json")
# the paper's Table V comparison: bench_fig8_saturation.py's grid on Slim
# Fly, the two Dragonflies, Jellyfish and the fat tree of
# paper_table5_configs(seed=0) (the PF row is main_path's), its `config`
# and the JAX package's results
TABLE5_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_table5_reference.json")
# the paper's remaining fluid figures: Fig. 9's adaptive permutations,
# Fig. 11's incremental expansion, Fig. 14's failure sweeps and its
# PS(9, 61) throughput point; its `config` and the JAX package's results
FIGURES_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "torch_port_figures_reference.json")
# the paper's last device figures: Fig. 10's size sweep with its large
# tier, Fig. 8's PF(79) point and Fig. 15's cost ratios; its `config` and
# the JAX package's results
SIZES_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "torch_port_sizes_reference.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# Issue rates in lane-instructions a second, 132 SMs x lanes x 1.98 GHz.
# fp32 add (67 TFLOP/s counts an FMA as two) and int32 add at 128 lanes;
# fp32 min (FMNMX) and int32 multiply at 64 (scripts/fp32_issue_rate.py
# measures all four on the card).  A (min,+) candidate is one FADD and one
# FMNMX: 2 instructions at 128 lanes or one FMNMX at 64 give the same
# least time.
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
INT32_ALU_PER_S = 132 * 128 * 1.98e9
INT32_MUL_PER_S = 132 * 64 * 1.98e9
TEST_SHAPES = [(5, 3, 4), (300, 8, 5), (1, 1, 1)]
# path_costs' other vector-row widths (L = 2, 3) beside TEST_SHAPES' L = 4,
# 5 (the generic kernel) and 1
PATH_COST_ROUTE_SHAPES = [(999, 3, 2), (999, 3, 3)]
MINPLUS_SHAPES = [(1, 1, 1), (130, 70, 50), (257, 129, 65)]
# (m, k, n) for minplus' other plans: one k range (289 tiles) with rows
# aligned and with a padded copy of a, and k split with rows aligned
MINPLUS_ROUTE_SHAPES = [(2048, 64, 2048), (2048, 67, 2048), (512, 1000, 512)]
# Hopper's DPX add-then-min on int16 pairs (VIADDMNMX): 64 lanes a clock
# on each of 132 SMs at 1.98 GHz, two candidates a lane
# (scripts/fp32_issue_rate.py measures it on the card)
DPX_S16X2_CANDIDATES_PER_S = 132 * 64 * 1.98e9 * 2
GF_SIZES = [(1, 1), (5, 7), (300, 257)]
FIG14_FRACTIONS = {31: [0.05, 0.2, 0.4, 0.55], 79: [0.05, 0.2]}
NO_LIBRARY = "no single PyTorch call computes it"
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
# tests/test_kernels.py's flash-attention CASES, then a ragged S, then
# nemotron's head dim (192, 12 q heads a kv head) and a ragged S at D = 256:
# b, hq, hkv, s, d, causal, softcap, window
FLASH_CASES = [(2, 4, 2, 128, 64, True, None, None),
               (1, 4, 4, 256, 64, True, 50.0, None),
               (1, 8, 2, 256, 128, True, None, 128),
               (1, 2, 1, 128, 64, False, None, None),
               (1, 2, 2, 128, 256, True, 30.0, 64),
               (1, 4, 2, 200, 64, True, 50.0, 48),
               (1, 12, 1, 256, 192, True, None, None),
               (1, 4, 2, 333, 256, True, 50.0, None)]
# the JAX test's own bars; the kernel and cuBLAS sum in other orders
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
# bf16 is also held element by element within one bf16 rounding of the
# plain version, 2^-7 |ref| + 1e-5: kernel and plain version both compute
# in float32 and round once at the end, so one unit in the last place (at
# most 2^-7 of the value) is all they may differ by.  At the prefill's
# shapes |out| is about 0.01 and 2e-2 would pass a wrong kernel; a key
# dropped from a 4096-key window moves outputs by about 1e-4, ten times
# this bar
FLASH_BF16_BAR = {"atol": 1e-5, "rtol": 2.0 ** -7}
GEMMA = "gemma2-9b"
PREFILL_S = 8192
# serve: 4 requests of 16 prompt tokens, 16 new ones each, one warm-up
# run and two timed ones (cut from 32 tokens and three runs for the
# script's time limit)
SERVE = {"batch": 4, "prompt": 16, "tokens": 16, "runs": 2}
# fp32 consistency at full width: two local/global pairs, B = 2, 48 tokens
CONSISTENCY = {"layers": 4, "batch": 2, "seq": 48, "tol": 2e-3}
# the MoE family and the hybrid: their prefill at S = 4096 (the capacity
# buffers grow with S, and three models share the script's time limit);
# float32 consistency at full width and these depths: deepseek's layer0 +
# 1 MoE layer, qwen2-moe's 2 (the padded-expert mask, the QKV bias; both
# cut from 4 for the script's time limit, the CPU's forward ~11 s each at
# 4), recurrentgemma's one (rec, rec, attn) group + 2 tail layers
MOE = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]
HYBRID = "recurrentgemma-9b"
NEW_PREFILL_S = 4096
# the SSM (falcon-mamba-7b: S = 4096 is 16 chunks of 256, float32
# consistency at 4 layers) and the encoder-decoder (whisper-base: 1500
# frames, its published 448-token text context, every layer at every step)
SSM = "falcon-mamba-7b"
ENCDEC = "whisper-base"
# depth cuts of the bf16 prefill and serve runs, to keep the whole script
# inside its time: falcon-mamba-7b at 16 of its 64 layers, the MoE pair at
# a quarter of theirs (every layer past deepseek's dense layer0 alike, so
# the shares and the launch counts a layer stand; the sharded phase runs
# deepseek-moe-16b's prefill uncut), recurrentgemma-9b at 19 of its 38
# (six (rec, rec, attn) groups and one rec layer)
DEPTH_CUT = {SSM: 16, "deepseek-moe-16b": 7, "qwen2-moe-a2.7b": 6,
             HYBRID: 19}
# the certified phase's traced saturation and its untraced twin: each
# solve's step budget (a depth cut; the default is 2016)
CERT_TRACE_ITERS = 256
WHISPER_TEXT_S = 448
CONSISTENCY_LAYERS = {GEMMA: CONSISTENCY["layers"], "deepseek-moe-16b": 2,
                      "qwen2-moe-a2.7b": 2, HYBRID: 5, SSM: 4, ENCDEC: 6}
# the training path: qwen2-0.5b (the reference CLI's default --arch and
# tests/test_train.py's config) at its published widths, bf16 with remat
# "full", B = 4, S = 2048, one warm-up step and ten more on one fixed batch;
# float32 without remat at B = 2, S = 512, 3 steps; float32 at 2 layers,
# B = 2, S = 128, the card against the CPU (and the restart)
TRAIN = {"arch": "qwen2-0.5b", "batch": 4, "seq": 2048, "steps": 11,
         "lr": 1e-3, "warmup": 10}
# the bf16 run's first loss, and its forward / backward / optimizer split
# (device ms, CUDA events), as the layers' per-layer t[i] views of the
# stacked parameters gave them (PERF.md §5-6): one unbind a stacked leaf
# must not move the loss
TRAIN_BEFORE_UNBIND = {"loss_first": 12.289473533630371,
                       "split_ms": {"forward_ms": 97.0, "backward_ms": 186.9,
                                    "optimizer_ms": 34.7}}
# remat "2level" beside "full" on the bf16 model: steps from the initial
# state
TRAIN_2LEVEL = {"steps": 2}
TRAIN_FP32 = {"batch": 2, "seq": 512, "steps": 3}
TRAIN_CHECK = {"layers": 2, "batch": 2, "seq": 128, "loss_rel": 1e-5,
               "norm_rel": 1e-4, "leaf_of_max": 1e-4}
# the backward kernel against its plain version on the card: each gradient
# within this share of its largest magnitude (the kernel sums keys, heads
# and D in other orders than cuBLAS; in bf16 the plain version works from
# the float32 output, the kernel from the bf16 one the forward returns),
# plus, in float32, 1e-7 absolute where a gradient is 0 but for rounding
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_BWD_ATOL = {"float32": 1e-7, "bfloat16": 0.0}
# the sharded path on a (1, 1) mesh: qwen2-0.5b bf16 steps after a warm-up
# one (TRAIN's model, batch and schedule), the float32 2-layer step's bars
# against the meshless one (the one-hot embedding's gradient sums in a
# GEMM where the gather's backward adds rows), the EP prefill's model
SHARDED = {"steps": 3, "loss_rel": 1e-6, "leaf_of_max": 1e-5,
           "moe_arch": "deepseek-moe-16b"}
# the launch tools' cells on one card: qwen2-0.5b (the reference dry run
# test's arch) at decode_32k and train_4k; the card's GEMM (n^3 bf16) and
# copy rates; decode on a (1, 1) mesh at 2 layers; memdebug's step at the
# train cell's microbatch size (one sequence) over 8 sequences
LAUNCH = {"arch": "qwen2-0.5b", "gemm_n": 8192, "copy_bytes": 4 << 30,
          "mesh_decode": {"archs": ["qwen2-0.5b", "deepseek-moe-16b"],
                          "layers": 2, "batch": 4, "max_seq": 64,
                          "steps": 8},
          "memdebug_batch": 8, "top": 10,
          # the train_4k step at 32 of the cell's 256 sequences, one a
          # microbatch as the plan has them: an eighth of its microbatches
          # (depth cut for the script's time limit; ~137 s at 256)
          "train_batch": 32}
# the cards phase (`launch.cards.CARD_PARTS`): the deadlines of its two
# worlds; a rank still running then is killed and the phase fails
CARDS = {"deadline_s": 600, "restore_deadline_s": 240}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def gpu_ms(torch, fn, samples=30, flush_bytes=128 << 20, warmup=3):
    """Median device time of `fn()` in ms: CUDA events around one call,
    right after a read of `flush_bytes`, which leaves the 50 MB L2 holding
    none of `fn`'s inputs (and no dirty lines), and a 1 ms device-side
    spin that keeps the stream busy while the host enqueues the timed call,
    so host launch cost stays out of the window."""
    from repro_torch.parallel.compat import cuda_sleep

    scratch = torch.ones(flush_bytes // 4, dtype=torch.float32,
                         device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        scratch.sum()
        cuda_sleep(2_000_000)  # about 1 ms of clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


class Smoke:
    def __init__(self):
        self.record = {"phases": {}}
        self.failed = []

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            ok = True
        except Exception:  # report every phase, fail the run at the end
            traceback.print_exc()
            out, ok = {"error": traceback.format_exc(limit=3)}, False
            self.failed.append(name)
        line = {"phase": name, "ok": ok,
                "seconds": round(time.perf_counter() - t0, 3), **out}
        self.record["phases"][name] = line
        emit(line)
        return ok


# what the certified and packet phases run under
# torch.cuda.set_sync_debug_mode("error"): the entry functions of each file
LINT_SYNC_FREE = {
    "src/repro_torch/simulation/fluid.py": ["_saturation_batch_traced"],
    "src/repro_torch/simulation/packet.py": ["_BatchedRun.run",
                                             "_BatchedRun.cycle"],
    "src/repro_torch/kernels/minplus/ops.py": ["path_costs"],
}


def phase_lint():
    """The port's lint gate, and its host-sync rule against the card's
    sync detector (see the module docstring)."""
    from repro_torch.analysis.lint import DEFAULT_PATHS, lint_paths
    from repro_torch.analysis.rules import FileContext
    from repro_torch.analysis.rules.host_sync import (HostSyncRule,
                                                      reached_lines)

    here = os.getcwd()
    os.chdir(ROOT)  # DEFAULT_SCOPE's patterns are relative to the root
    try:
        res = lint_paths(list(DEFAULT_PATHS))
        sync_free = {}
        for path, roots in LINT_SYNC_FREE.items():
            with open(path) as fh:
                ctx = FileContext(path, fh.read())
            lines = reached_lines(ctx, roots)
            sync_free[path] = {
                "roots": roots, "lines": len(lines),
                "host_sync": [f"{f.location()} {f.message}"
                              for f in HostSyncRule().check(ctx)
                              if f.line in lines]}
    finally:
        os.chdir(here)
    out = {"python": sys.version.split()[0],
           "files_scanned": res.files_scanned,
           "findings": [f"{f.location()}: {f.rule}: {f.message}"
                        for f in sorted(res.findings)],
           "suppressed": res.suppressed,
           "suppressed_by_rule": dict(sorted(res.suppressed_by_rule.items())),
           "host_sync_vs_sync_debug": sync_free}
    if (res.findings or not res.suppressed
            or any(v["host_sync"] for v in sync_free.values())):
        emit({"phase": "lint.detail", **out})
        raise AssertionError(
            f"lint: {len(res.findings)} finding(s); host-sync on the "
            "sync-free lines: "
            f"{[v['host_sync'] for v in sync_free.values()]}")
    return out


def phase_device(torch):
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def kernel_name(mangled):
    """The kernel's own name in an Itanium-mangled nested name, with its
    template arguments as mangled (e.g. "flash_attention_sm90_kernelILi256")."""
    i, names = 3 if mangled.startswith("_ZN") else 0, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    if not names:
        return mangled[:48]
    return names[-1] + mangled[i:].split("Ev")[0].rstrip("E")[:24]


# the tensor-core kernels, whose SASS must hold wgmma (HGMMA) instructions
HGMMA_KERNELS = ("flash_attention_sm90_kernel", "bwd_sm90_dq_kernel",
                 "bwd_sm90_dkdv_kernel")


def sass_hgmma(lib):
    """{kernel name: HGMMA instructions in its SASS} for the functions of
    the shared library `lib` whose names hold one of HGMMA_KERNELS
    (`cuobjdump -sass`)."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed: {out.stderr[-400:]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        name = kernel_name(part.split(None, 1)[0])
        if any(k in name for k in HGMMA_KERNELS):
            counts[name] = part.count("HGMMA")
    return counts


def phase_build():
    from repro_torch.kernels import _build

    _build.build_all()
    ptxas, spills = {}, []
    for name, log in _build.build_logs().items():
        rows, kernel = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln and "'" in ln:
                kernel = kernel_name(ln.split("'")[1])
            elif "registers" in ln or "spill" in ln:
                rows.append(f"{kernel}: {ln.strip()}")
                if "spill" in ln and " 0 bytes spill stores" not in ln:
                    spills.append(rows[-1])
            elif "C7512" in ln:  # wgmma serialised for want of registers
                rows.append(ln.strip())
        ptxas[name] = rows
    hgmma = sass_hgmma(_build._target("flash_attention")[0])
    missing = [k for k in HGMMA_KERNELS
               if not any(k in name and n > 0 for name, n in hgmma.items())]
    if missing:
        raise AssertionError(f"no HGMMA in the SASS of {missing}: {hgmma}")
    return {"libraries": sorted(_build.LIBRARIES), "ptxas": ptxas,
            "spills": spills, "sass_hgmma": hgmma}


def main_path_inputs(torch):
    """The PF(31) uniform ugal_pf path-cost inputs the main path gives the
    kernel: its edge ids and a delay table from a real load vector."""
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import build_flow_paths, make_pattern

    pf = build_polarfly(31)
    rt = build_routing(pf.graph, pf)
    pat = make_pattern("uniform", rt, p=16, seed=0)
    return path_cost_inputs(torch, build_flow_paths(
        rt, pat, "ugal_pf", k_candidates=10, seed=0))


def path_cost_inputs(torch, fp):
    """(edge ids, delay table) that the FW loop gives path_costs on `fp`:
    the delays of the load at half the offered range."""
    from repro_torch.simulation import fluid

    fw, demand, _, _ = fluid._pieces(fp, torch.device("cuda"))
    rho = fw.loads(fw.init, demand * 0.5)
    delay = torch.cat([1.0 + fluid._queue_delay(rho),
                       rho.new_zeros(1)]).contiguous()
    return fp.device_arrays("cuda")[0], delay


def kernel_path_costs(torch, state):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import path_costs_ref

    checks = []
    rng = np.random.default_rng(0)
    for shape in TEST_SHAPES + PATH_COST_ROUTE_SHAPES:
        e = 37
        delay = np.concatenate([rng.random(e) * 5, np.zeros(1)])
        eidx = rng.integers(0, e + 1, size=shape).astype(np.int32)
        for dtype in (torch.float32, torch.float64):
            d = torch.from_numpy(delay).to("cuda", dtype)
            x = torch.from_numpy(eidx).cuda()
            checks.append((f"{shape}", dtype, d, x))
    # a base 4 bytes past 16-byte alignment: the generic kernel at L = 4
    x = torch.from_numpy(rng.integers(0, 38, 1 + 999 * 4).astype(
        np.int32)).cuda()[1:].view(333, 3, 4)
    checks.append(("(333, 3, 4) misaligned base", torch.float32,
                   checks[0][2], x))
    eidx, delay = main_path_inputs(torch)
    for dtype in (torch.float32, torch.float64):
        checks.append(("pf31_uniform_ugal_pf", dtype, delay.to(dtype), eidx))
    rows, worst = [], 0.0
    for label, dtype, d, x in checks:
        out = ops.path_costs(d, x)
        ref = path_costs_ref(d, x)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max()) if out.numel() else 0.0
        same = bool(torch.equal(out, ref))
        worst = max(worst, err)
        plan = ops._path_costs_plan(out.numel(), x.shape[-1], x.data_ptr())
        rows.append({"shape": label, "dtype": str(dtype).split(".")[-1],
                     **plan, "bit_identical": same, "max_abs_err": err})
        if not same:
            raise AssertionError(f"path_costs differs from its plain version "
                                 f"at {label} {dtype}: max abs err {err}")
    f, k, l = eidx.shape
    n_out = f * k
    times = {}
    for dtype in (torch.float32, torch.float64):
        d = delay.to(dtype)
        size = d.element_size()
        bytes_moved = n_out * l * 4 + n_out * size + d.numel() * size
        bound = max(bytes_moved / HBM_BYTES_PER_S,
                    n_out * l / FP32_OPS_PER_S) * 1e3
        ms = gpu_ms(torch, lambda: ops.path_costs(d, eidx))
        times[str(dtype).split(".")[-1]] = {
            "kernel_ms": ms, "bound_ms": bound, "bound_share": bound / ms,
            "bytes": bytes_moved,
            "plan": ops._path_costs_plan(n_out, l, eidx.data_ptr())}
    t32 = times["float32"]
    flat = eidx.view(-1, l)
    table = delay.view(-1, 1)
    plain_ms = gpu_ms(torch, lambda: path_costs_ref(delay, eidx))
    library_ms = gpu_ms(torch, lambda: F.embedding_bag(flat, table,
                                                       mode="sum"))
    lib = F.embedding_bag(flat, table, mode="sum").view(f, k)
    lib_err = float((lib - ops.path_costs(delay, eidx)).abs().max())
    state["path_costs"] = {
        "name": "path_costs", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/path_costs.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:50",
        "max_abs_err": worst, "ms": t32["kernel_ms"], "plain_ms": plain_ms,
        "bound_ms": t32["bound_ms"], "bound_by": "bytes",
        "library_ms": library_ms}
    return {"checks": rows, "shape": [f, k, l], "table": delay.numel(),
            "times": times, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err}


def damaged(g, fractions, seed=1):
    """`g` with each of `fractions` of its links removed, in
    `resilience_sweep`'s cumulative shuffled order (Fig. 14)."""
    import numpy as np

    edges = g.edge_list.copy()
    np.random.default_rng(seed).shuffle(edges)
    return [g.subgraph_without_edges(edges[:int(round(f * len(edges)))])
            for f in fractions]


def graphs(state):
    """PF(31) and PF(79) (built once) and their damaged copies."""
    from repro_torch.core.polarfly import build_polarfly

    if "pf" not in state:
        t0 = time.perf_counter()
        state["pf"] = {q: build_polarfly(q) for q in (31, 79)}
        state["pf_build_s"] = time.perf_counter() - t0
        state["damaged"] = {q: damaged(state["pf"][q].graph, fr)
                            for q, fr in FIG14_FRACTIONS.items()}
    return state["pf"], state["damaged"]


def held(torch, label, out, ref):
    torch.cuda.synchronize()
    same = bool(torch.equal(out, ref))
    err = float((out.double() - ref.double()).abs().max()) \
        if out.numel() else 0.0
    if not same:
        raise AssertionError(f"kernel differs from its plain version at "
                             f"{label}: max abs err {err}")
    return {"shape": label, "bit_identical": same, "max_abs_err": err}


def squarings(torch, dmg, dist0, square):
    """The damaged (0.05) PF(31) and PF(79) matrices of APSP's first two
    squarings, as `apsp` builds them (`dist0`) and squares them."""
    mats = {}
    for q in (31, 79):
        d0 = dist0(torch.from_numpy(dmg[q][0].adjacency).cuda())
        mats[q] = (d0, square(d0))
    return mats


def kernel_minplus(torch, state):
    import numpy as np

    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import INF, minplus_ref

    _, dmg = graphs(state)
    rng = np.random.default_rng(0)
    rows = []
    for m, k, n in MINPLUS_SHAPES + MINPLUS_ROUTE_SHAPES:
        a = rng.random((m, k), dtype=np.float32) * 10
        b = rng.random((k, n), dtype=np.float32) * 10
        a[rng.random((m, k)) < 0.3] = INF
        b[rng.random((k, n)) < 0.3] = INF
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        rows.append({**held(torch, f"{(m, k, n)} with INF",
                            ops.minplus(a, b), minplus_ref(a, b)),
                     "plan": ops._minplus_plan(m, n, k),
                     "padded_copy": k % 4 != 0 or n % 4 != 0})
    # APSP's first two squarings on damaged PF(31) and PF(79) (0.05), on
    # the padded matrices `apsp`'s float route squares, and PF(31)'s on the
    # n x n matrix (the wrapper's padded copy)
    mats = squarings(torch, dmg, ops.apsp_dist0, lambda d: ops.minplus(d, d))
    for step in (0, 1):
        d = mats[31][step]
        rows.append(held(torch, f"pf31 damaged 0.05, squaring {step + 1}",
                         ops.minplus(d, d), minplus_ref(d, d)))
        d = d[:993, :993].contiguous()
        rows.append(held(torch, f"pf31 damaged 0.05, squaring {step + 1}, "
                         f"993 x 993", ops.minplus(d, d), minplus_ref(d, d)))
        d = mats[79][step]
        a = d[:256].contiguous()
        rows.append(held(torch, f"pf79 damaged 0.05, squaring {step + 1}, "
                         f"rows 0-255", ops.minplus(a, d),
                         minplus_ref(a, d)))
    times = {}
    for q in (31, 79):
        d = mats[q][1]
        n = d.shape[0]
        ms = gpu_ms(torch, lambda: ops.minplus(d, d))
        plain = gpu_ms(torch, lambda: minplus_ref(d, d),
                       samples=30 if q == 31 else 3,
                       warmup=3 if q == 31 else 1)
        bytes_moved = 3 * n * n * 4
        ops_count = 2 * n ** 3
        bound = max(bytes_moved / HBM_BYTES_PER_S,
                    ops_count / FP32_INSTR_PER_S) * 1e3
        times[f"pf{q}"] = {"n": n, "plan": ops._minplus_plan(n, n, n),
                           "kernel_ms": ms, "plain_ms": plain,
                           "bound_ms": bound, "bound_share": bound / ms,
                           "bytes": bytes_moved, "lane_instructions":
                           ops_count}
    worst = max(r["max_abs_err"] for r in rows)
    t79 = times["pf79"]
    state["minplus"] = {
        "name": "minplus", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:80",
        "max_abs_err": worst, "ms": t79["kernel_ms"],
        "plain_ms": t79["plain_ms"], "bound_ms": t79["bound_ms"],
        "bound_by": "operations", "library_ms": None}
    return {"checks": rows, "times": times, "timed_at": "pf79",
            "library": None, "library_reason": NO_LIBRARY}


def kernel_minplus_hops(torch, state):
    """The integer (DPX) route `apsp` takes: each squaring held against its
    plain version, whole damaged PF(31) and PF(79) APSPs against the float
    route's (float kernel) and PF(31)'s against the plain float APSP."""
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import (apsp_ref, apsp_steps,
                                                 minplus_hops_ref,
                                                 minplus_ref)

    _, dmg = graphs(state)
    rows = []
    mats = squarings(torch, dmg, ops.apsp_hops0, ops.minplus_hops)
    for step in (0, 1):
        d = mats[31][step]
        rows.append(held(torch, f"pf31 damaged 0.05, squaring {step + 1}",
                         ops.minplus_hops(d), minplus_hops_ref(d)))
        d = mats[79][step]
        out = ops.minplus_hops(d)[:256].float()
        rows.append(held(torch, f"pf79 damaged 0.05, squaring {step + 1}, "
                         f"rows 0-255", out,
                         minplus_ref(d[:256].float().contiguous(),
                                     d.float())))
    apsps = []
    for q in (31, 79):
        for f, g in zip(FIG14_FRACTIONS[q][:2], dmg[q][:2]):
            adj = torch.from_numpy(g.adjacency).cuda()
            n = g.n
            hops = ops._apsp_device(g.adjacency, "cuda")
            d = ops.apsp_dist0(adj)
            for _ in range(apsp_steps(n)):
                d = ops.minplus(d, d)
            flt = d[:n, :n]
            rows.append(held(torch, f"pf{q} damaged {f} apsp, float route",
                             hops, flt))
            if q == 31:
                rows.append(held(torch, f"pf31 damaged {f} apsp, plain",
                                 hops, apsp_ref(adj)))
            apsps.append({"q": q, "fraction": f, "route": ops._apsp_route(
                n, bool(torch.equal(adj, adj.T)))})
    times = {}
    for q in (31, 79):
        d = mats[q][1]
        n = d.shape[0]
        ms = gpu_ms(torch, lambda: ops.minplus_hops(d))
        plain = gpu_ms(torch, lambda: minplus_hops_ref(d),
                       samples=30 if q == 31 else 3,
                       warmup=3 if q == 31 else 1)
        bytes_moved = 2 * n * n * 2
        by_ops = n ** 3 / DPX_S16X2_CANDIDATES_PER_S * 1e3
        bound = max(bytes_moved / HBM_BYTES_PER_S * 1e3, by_ops)
        times[f"pf{q}"] = {"n": n, "plan": ops._hops_plan(n),
                           "kernel_ms": ms, "plain_ms": plain,
                           "bound_ms": bound, "bound_share": bound / ms,
                           "float_bound_ms": 2 * n ** 3 / FP32_INSTR_PER_S
                           * 1e3, "bytes": bytes_moved, "candidates": n ** 3}
    t79 = times["pf79"]
    state["minplus_hops"] = {
        "name": "minplus_hops", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus_dpx.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:80",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": t79["kernel_ms"], "plain_ms": t79["plain_ms"],
        "bound_ms": t79["bound_ms"], "bound_by": "operations",
        "library_ms": None}
    return {"checks": rows, "apsp_routes": apsps, "times": times,
            "timed_at": "pf79", "library": None,
            "library_reason": NO_LIBRARY}


def gf_ops_per_pair():
    """(int32 multiplies, all integer instructions) of one (i, j) pair in
    csrc/crossprod.cu, counted from its code.  A remainder (mod_q) is the
    four instructions it compiles to: umulhi, multiply-add, subtract, min
    (two of them multiplies); a cross-product term is two multiply-adds
    and its remainder; the inverse one index and one shared-memory load.
    The power table's prologue (q entries a block, 2 log2 q remainders
    each) is left out: it is not work of the function, and at PF(79) it is
    under 0.3 % of the pair work."""
    mod = (2, 4)  # (multiplies, instructions)
    cross = (3 * (2 + mod[0]), 3 * (2 + mod[1]))  # 3 terms
    lead = (0, 4)  # two compares, two selects
    inverse = (0, 2)  # index, LDS.U16
    normalise = (3 * (1 + mod[0]), 3 * (1 + mod[1]))
    loads = (1, 4)  # the d row's index and its three loads
    walk = (0, 2)  # next column, compare
    store = (0, 3)  # 3 STS.128 + 3 LDS.128 + 3 STG.128 for 4 pairs
    parts = (cross, lead, inverse, normalise, loads, walk, store)
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


# q the kernel is held at besides 2..79: a prime (46337) and a composite
# (46340) at the top of the range the wrapper takes (a 92.7 KB power
# table).  Shapes: n m = 1, 2, 3 mod 4 in the scalar tail ((7, 1) to
# (129, 131)); m < 4 over whole 128-pair chunks, where rows change inside
# a lane's four pairs ((300, 1) on); and, at GF_STRIDE_Q, m < 4 with more
# chunks than the launcher's wave has warps, so the stride step runs
GF_LARGE_Q = [46337, 46340]
GF_EDGE_SIZES = [(7, 1), (9, 2), (11, 3), (129, 131), (300, 1), (97, 2),
                 (131, 3), (129, 3)]
GF_STRIDE_Q = [2, 9, 79, 46337]
GF_STRIDE_SIZES = [(900001, 1), (500001, 2), (300001, 3)]


def kernel_gf_crossprod(torch, state):
    import numpy as np

    from repro_torch.kernels.gf_crossprod import ops
    from repro_torch.kernels.gf_crossprod.ref import crossprod_normalized_ref

    pf, _ = graphs(state)
    rng = np.random.default_rng(0)
    rows = []
    for q in list(range(2, 80)) + [121, 1290] + GF_LARGE_Q:
        for n, m in GF_SIZES + GF_EDGE_SIZES:
            s = torch.from_numpy(rng.integers(0, q, (n, 3)).astype(
                np.int32)).cuda()
            d = torch.from_numpy(rng.integers(0, q, (m, 3)).astype(
                np.int32)).cuda()
            d[: min(n, m) // 2] = s[: min(n, m) // 2]  # parallel -> zero
            rows.append(held(torch, f"q={q} {(n, m)}",
                             ops.crossprod_normalized(s, d, q),
                             crossprod_normalized_ref(s, d, q)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for q in GF_STRIDE_Q:
        for n, m in GF_STRIDE_SIZES:
            s = torch.randint(0, q, (n, 3), generator=gen, device="cuda",
                              dtype=torch.int32)
            d = torch.randint(0, q, (m, 3), generator=gen, device="cuda",
                              dtype=torch.int32)
            d[: m // 2] = s[: m // 2]  # parallel -> zero
            rows.append(held(torch, f"q={q} {(n, m)}",
                             ops.crossprod_normalized(s, d, q),
                             crossprod_normalized_ref(s, d, q)))
    # every check above raised unless bit-identical; keep a few in the record
    checked = {"count": len(rows), "q": "2..79, 121, 1290, 46337, 46340",
               "sizes": GF_SIZES + GF_EDGE_SIZES,
               "stride_sizes": {"q": GF_STRIDE_Q, "sizes": GF_STRIDE_SIZES},
               "max_abs_err": max(r["max_abs_err"] for r in rows)}
    rows = [r for r in rows if r["shape"].startswith(("q=2 ", "q=9 ",
                                                      "q=79 ", "q=4634"))]
    times = {}
    for q in (31, 79):
        v = torch.from_numpy(pf[q].vertices.astype(np.int32)).cuda()
        rows.append(held(torch, f"pf{q} vertices x vertices",
                         ops.crossprod_normalized(v, v, q),
                         crossprod_normalized_ref(v, v, q)))
        n = v.shape[0]
        ms = gpu_ms(torch, lambda: ops.crossprod_normalized(v, v, q))
        plain = gpu_ms(torch, lambda: crossprod_normalized_ref(v, v, q))
        bytes_moved = 12 * n * n + 2 * 12 * n
        muls, int_ops = gf_ops_per_pair()
        by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        by_ops = max(muls / INT32_MUL_PER_S,
                     int_ops / INT32_ALU_PER_S) * n * n * 1e3
        times[f"pf{q}"] = {"n": n, "kernel_ms": ms, "plain_ms": plain,
                           "bound_ms": max(by_bytes, by_ops),
                           "bytes_ms": by_bytes, "ops_ms": by_ops,
                           "ops_per_pair": int_ops,
                           "multiplies_per_pair": muls,
                           "bound_share": max(by_bytes, by_ops) / ms}
    t79 = times["pf79"]
    state["gf_crossprod"] = {
        "name": "gf_crossprod", "route": "cuda",
        "source": "src/repro_torch/kernels/gf_crossprod/csrc/crossprod.cu",
        "replaces": "src/repro/kernels/gf_crossprod/kernel.py:52",
        "max_abs_err": max([checked["max_abs_err"]]
                           + [r["max_abs_err"] for r in rows]),
        "ms": t79["kernel_ms"], "plain_ms": t79["plain_ms"],
        "bound_ms": t79["bound_ms"],
        "bound_by": ("bytes" if t79["bytes_ms"] >= t79["ops_ms"]
                     else "operations"),
        "library_ms": None}
    return {"checked": checked, "checks": rows, "times": times,
            "timed_at": "pf79", "library": None,
            "library_reason": NO_LIBRARY}


def attention_pairs(s, causal, window):
    """Unmasked (query, key) pairs of one head at sequence length s."""
    total = 0
    for i in range(s):
        hi = i if causal else s - 1
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo + 1
    return total


def flash_bound_ms(b, hq, hkv, s, d, causal, window, itemsize):
    """(bound ms, flop-bound ms, byte-bound ms): 4 D flops per unmasked
    pair and head at the dense bf16 tensor-core rate; q, k, v, o read or
    written once at HBM rate."""
    flops = 4 * d * attention_pairs(s, causal, window) * hq * b
    nbytes = (2 * hq + 2 * hkv) * b * s * d * itemsize
    by_ops = flops / BF16_TC_FLOPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), by_ops, by_bytes


def gemma_attention_shape():
    """(B, Hq, Hkv, S, D, softcap, window) of one Gemma2-9B prefill layer."""
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA)
    return (1, cfg.num_heads, cfg.num_kv_heads, PREFILL_S, cfg.head_dim,
            cfg.attn_softcap, cfg.local_window)


def new_attention_shapes():
    """[(label, (B, Hq, Hkv, S, D, softcap, window))] of one prefill
    attention layer of the MoE family and of the hybrid, at their
    published widths and NEW_PREFILL_S."""
    from repro_torch.configs import get_config

    out = []
    for label, arch in (("moe_prefill", MOE[0]), ("hybrid_prefill", HYBRID)):
        cfg = get_config(arch)
        window = cfg.local_window if cfg.family == "hybrid" else None
        out.append((label, (1, cfg.num_heads, cfg.num_kv_heads,
                            NEW_PREFILL_S, cfg.head_dim, cfg.attn_softcap,
                            window)))
    return out


def whisper_attention_shapes():
    """[(label, (B, Hq, Hkv, S, D, causal))] of whisper-base's attention:
    the encoder's (non-causal over the 1500 frames, at B = 1 and at the
    serve run's 4) and the decoder's prefill (causal over 448 tokens)."""
    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f = cfg.encoder_frames
    return [("whisper_encoder_b1", (1, h, kv, f, d, False)),
            ("whisper_encoder_b4", (SERVE["batch"], h, kv, f, d, False)),
            ("whisper_decoder_b1", (1, h, kv, WHISPER_TEXT_S, d, True))]


def kernel_flash_attention(torch, state):
    """Both flash-attention kernels against the plain version: the sm90
    tensor-core kernel (bf16 at D in {64, 128, 192, 256}, where
    `ops.attention` sends bf16) and the CUDA-core kernel in float32 (where
    `ops.attention` sends float32) and in bf16 (`ops._launch`, the route
    bf16 takes at other head dims), at FLASH_CASES, at the Gemma2-9B
    prefill shapes and at whisper-base's (non-causal at the ragged
    S = 1500, causal at S = 448); then both kernels' times at those shapes
    beside the plain version's, the bound and SDPA's."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_chunked,
                                                         attention_ref)

    def inputs(b, hq, hkv, s, d, dtype, seed=0):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(shape) * 0.5).to(
            "cuda", dtype) for shape in ((b, hq, s, d), (b, hkv, s, d),
                                         (b, hkv, s, d))]

    rows = []
    worst = {"sm90": {"bfloat16": 0.0},
             "simt": {"float32": 0.0, "bfloat16": 0.0}}

    def hold(label, route, out, want):
        """Every element within the dtype's bar of the plain version: the
        JAX test's (FLASH_TOL) and, in bf16, one rounding (FLASH_BF16_BAR)."""
        torch.cuda.synchronize()
        name = str(out.dtype).split(".")[-1]
        o, w = out.float(), want.float()
        diff = (o - w).abs()
        err = float(diff.max())
        bar = FLASH_BF16_BAR if name == "bfloat16" else \
            {"atol": FLASH_TOL[name], "rtol": 0.0}
        share = float((diff / (bar["atol"] + bar["rtol"] * w.abs())).max())
        ok = bool(torch.isfinite(o).all()) and err <= FLASH_TOL[name] \
            and share <= 1.0
        worst[route][name] = max(worst[route][name], err)
        rows.append({"case": label, "kernel": route, "dtype": name,
                     "max_abs_err": err, "tol": FLASH_TOL[name], **bar,
                     "worst_share_of_bar": share, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention differs from its plain "
                                 f"version at {label} {name}: {rows[-1]}")

    def routed(x, **kw):
        """`ops.attention` and the kernel its launch went through."""
        before = dict(ops.LAUNCHES_BY_KERNEL)
        out = ops.attention(*x, **kw)
        used = [k for k, n in ops.LAUNCHES_BY_KERNEL.items()
                if n != before[k]]
        if len(used) != 1 or used[0] != ops._route(x[0].dtype,
                                                    x[0].shape[3]):
            raise AssertionError(f"attention launched {used} for "
                                 f"{x[0].dtype} at D = {x[0].shape[3]}")
        return used[0], out

    def simt(x, causal=True, softcap=None, window=None):
        return ops._launch(*x, causal, softcap, window, None, "simt")

    def timed(x, causal, softcap, window, plain):
        """Both kernels' bf16 times on `x`, the plain version's and the
        bound, as in the rows below."""
        b_, hq_, hkv_, s_, d_ = (*x[0].shape[:2], x[1].shape[1],
                                 *x[0].shape[2:])
        kw = {"causal": causal, "softcap": softcap, "window": window}
        bound, by_ops, by_bytes = flash_bound_ms(b_, hq_, hkv_, s_, d_,
                                                 causal, window, 2)
        sm90_ms = gpu_ms(torch, lambda: ops.attention(*x, **kw), samples=10)
        simt_ms = gpu_ms(torch, lambda: simt(x, **kw), samples=10)
        return {"shape": [b_, hq_, hkv_, s_, d_], "causal": causal,
                "softcap": softcap, "window": window, "sm90_ms": sm90_ms,
                "simt_bf16_ms": simt_ms,
                "plain_ms": gpu_ms(torch, lambda: plain(*x, **kw), samples=3,
                                   warmup=1),
                "bound_ms": bound, "flops_ms": by_ops, "bytes_ms": by_bytes,
                "bound_by": "operations" if by_ops >= by_bytes else "bytes",
                "sm90_bound_share": bound / sm90_ms,
                "simt_bound_share": bound / simt_ms}

    for case in FLASH_CASES:
        b, hq, hkv, s, d, causal, cap, win = case
        kw = {"causal": causal, "softcap": cap, "window": win}
        for dtype in (torch.float32, torch.bfloat16):
            x = inputs(b, hq, hkv, s, d, dtype)
            want = attention_ref(*x, **kw)
            hold(str(case), *routed(x, **kw), want)
            if dtype == torch.bfloat16:
                hold(str(case), "simt", simt(x, **kw), want)
    # the prefill's shapes: Gemma2-9B, local (window) and global, in bf16
    # (both kernels) and in float32 on the same (bf16-exact) inputs
    b, hq, hkv, s, d, cap, win = gemma_attention_shape()
    q, k, v = inputs(b, hq, hkv, s, d, torch.bfloat16, seed=1)
    times = {}
    for layer, window in (("local", win), ("global", None)):
        label = f"{GEMMA} {layer} {(b, hq, hkv, s, d)} softcap {cap}"
        want = attention_chunked(q, k, v, softcap=cap, window=window)
        hold(label, *routed((q, k, v), softcap=cap, window=window), want)
        hold(label, "simt", simt((q, k, v), softcap=cap, window=window),
             want)
        x32 = (q.float(), k.float(), v.float())
        hold(label, *routed(x32, softcap=cap, window=window),
             attention_chunked(*x32, softcap=cap, window=window))
        del x32, want
        bound, by_ops, by_bytes = flash_bound_ms(b, hq, hkv, s, d, True,
                                                 window, 2)
        sm90_ms = gpu_ms(torch, lambda: ops.attention(
            q, k, v, softcap=cap, window=window), samples=10)
        simt_ms = gpu_ms(torch, lambda: simt((q, k, v), softcap=cap,
                                             window=window), samples=10)
        plain = gpu_ms(torch, lambda: attention_chunked(
            q, k, v, softcap=cap, window=window), samples=3, warmup=1)
        times[layer] = {"window": window, "sm90_ms": sm90_ms,
                        "simt_bf16_ms": simt_ms, "plain_ms": plain,
                        "bound_ms": bound, "flops_ms": by_ops,
                        "bytes_ms": by_bytes,
                        "sm90_bound_share": bound / sm90_ms,
                        "simt_bound_share": bound / simt_ms}
    # where SDPA computes the same function: causal, no softcap, no window
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().float() - ops.attention(q, k, v).float()
                     ).abs().max())
    times["causal_no_softcap"] = {
        "sm90_ms": gpu_ms(torch, lambda: ops.attention(q, k, v),
                          samples=10),
        "simt_bf16_ms": gpu_ms(torch, lambda: simt((q, k, v)), samples=10),
        "library_ms": gpu_ms(torch, sdpa, samples=10),
        "library_max_abs_err": lib_err,
        "bound_ms": flash_bound_ms(b, hq, hkv, s, d, True, None, 2)[0]}
    del q, k, v
    # the MoE and hybrid prefills' shapes: MHA at D = 128 with neither
    # softcap nor window (deepseek-moe-16b and qwen2-moe-a2.7b: there SDPA
    # computes the same function), and windowed MQA at D = 256, 16 q heads
    # on one kv head (recurrentgemma-9b; SDPA has no window but an explicit
    # mask, so no library time)
    for label, (b2, hq2, hkv2, s2, d2, cap2, win2) in new_attention_shapes():
        x = inputs(b2, hq2, hkv2, s2, d2, torch.bfloat16, seed=2)
        kw = {"softcap": cap2, "window": win2}
        full = f"{label} {(b2, hq2, hkv2, s2, d2)} window {win2}"
        hold(full, *routed(x, **kw), attention_chunked(*x, **kw))
        bound, by_ops, by_bytes = flash_bound_ms(b2, hq2, hkv2, s2, d2,
                                                 True, win2, 2)
        row = {"shape": [b2, hq2, hkv2, s2, d2], "softcap": cap2,
               "window": win2,
               "sm90_ms": gpu_ms(torch, lambda: ops.attention(*x, **kw),
                                 samples=10),
               "plain_ms": gpu_ms(torch, lambda: attention_chunked(*x, **kw),
                                  samples=3, warmup=1),
               "bound_ms": bound, "flops_ms": by_ops, "bytes_ms": by_bytes,
               "library_ms": None,
               "library_reason": "scaled_dot_product_attention takes a "
                                 "window only as an explicit mask"}
        row["sm90_bound_share"] = bound / row["sm90_ms"]
        if cap2 is None and win2 is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *x, is_causal=True)
            row["library_ms"] = gpu_ms(torch, lib, samples=10)
            row["library_max_abs_err"] = float(
                (lib().float() - ops.attention(*x).float()).abs().max())
            row["library_reason"] = "the same function: causal, no softcap, " \
                                    "no window"
        times[label] = row
        del x
    # whisper-base's encoder (non-causal, S = 1500: ragged against the
    # sm90 kernel's 128-row q tiles and 64-key tiles, so every q tile's
    # last key tile is masked past S) and decoder (causal, S = 448); no
    # softcap, no window: SDPA computes the same function
    for label, (b2, hq2, hkv2, s2, d2, causal2) in whisper_attention_shapes():
        x = inputs(b2, hq2, hkv2, s2, d2, torch.bfloat16, seed=3)
        full = f"{label} {(b2, hq2, hkv2, s2, d2)} causal {causal2}"
        want = attention_ref(*x, causal=causal2)
        hold(full, *routed(x, causal=causal2), want)
        hold(full, "simt", simt(x, causal=causal2), want)
        x32 = [t.float() for t in x]
        hold(full, *routed(x32, causal=causal2),
             attention_ref(*x32, causal=causal2))
        del x32, want
        row = timed(x, causal2, None, None, attention_ref)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            *x, is_causal=causal2)
        row["library_ms"] = gpu_ms(torch, lib, samples=10)
        row["library_max_abs_err"] = float(
            (lib().float() - ops.attention(*x, causal=causal2).float()
             ).abs().max())
        row["library_reason"] = "the same function: no softcap, no window, " \
                                f"is_causal={causal2}"
        times[label] = row
        del x
    library_ms = times["causal_no_softcap"]["library_ms"]
    g = times["global"]
    common = {
        "route": "cuda",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": "operations" if g["flops_ms"] >= g["bytes_ms"]
        else "bytes",
        "library_ms": library_ms,
        "library_computes": "scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True) at the same shape: causal "
                            "attention without the softcap (less than the "
                            "kernels do)"}
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    state["flash_attention_sm90"] = {
        "name": "flash_attention_sm90", **common,
        "source": src + "flash_attention_sm90.cu",
        "max_abs_err": worst["sm90"]["bfloat16"], "ms": g["sm90_ms"],
        "timed_at": f"{GEMMA} global layer, bf16",
        "other_path_shapes": {
            label: {key: times[label][key] for key in (
                "shape", "window", "sm90_ms", "plain_ms", "bound_ms",
                "library_ms")} for label, _ in new_attention_shapes()
            + whisper_attention_shapes()}}
    state["flash_attention"] = {
        "name": "flash_attention", **common,
        "source": src + "flash_attention.cu",
        "max_abs_err": max(worst["simt"].values()), "ms": g["simt_bf16_ms"],
        "timed_at": f"{GEMMA} global layer, bf16 (the prefill runs float32 "
                    f"through it only in the consistency run)",
        "other_path_shapes": {
            label: {key: times[label][key] for key in (
                "shape", "causal", "simt_bf16_ms", "plain_ms", "bound_ms",
                "library_ms")} for label, _ in whisper_attention_shapes()}}
    return {"checks": rows, "max_abs_err": worst, "times": times,
            "timed_at": f"{GEMMA} prefill layer, S={s}, bf16",
            "smem_bytes_d256": {"sm90": ops.smem_bytes(d, "sm90"),
                                "simt": ops.smem_bytes(d)}}


def phase_kernels(torch, state):
    return {"path_costs": kernel_path_costs(torch, state),
            "minplus": kernel_minplus(torch, state),
            "minplus_hops": kernel_minplus_hops(torch, state),
            "gf_crossprod": kernel_gf_crossprod(torch, state),
            "flash_attention": kernel_flash_attention(torch, state)}


def phase_parity(torch):
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import (build_flow_paths, latency_curve,
                                        make_pattern, saturation_throughput)

    pf = build_polarfly(13)
    rt = build_routing(pf.graph, pf)
    pat = make_pattern("random_perm", rt, p=7, seed=0)
    rows = []
    for mode in ("min", "ugal", "ugal_pf"):
        fp = build_flow_paths(rt, pat, mode, k_candidates=10, seed=0)
        sat_cpu = saturation_throughput(fp, tol=0.01, device="cpu")
        sat_gpu = saturation_throughput(fp, tol=0.01, device="cuda")
        # below saturation: past it the 250-step iterate is chaotic in its
        # last bits and no two arithmetics agree to 1e-3 (see
        # tests/test_torch_fluid.py)
        loads = [f * sat_cpu for f in (0.25, 0.5, 0.75)]
        cpu = latency_curve(fp, loads, iters=250, device="cpu")
        gpu = latency_curve(fp, loads, iters=250, device="cuda")
        rel = max(abs(g.max_util - c.max_util) / c.max_util
                  for c, g in zip(cpu, gpu))
        lat = max(abs(g.mean_latency - c.mean_latency) / c.mean_latency
                  for c, g in zip(cpu, gpu))
        sat_tol = 0.01 if mode == "min" else 0.05
        rows.append({"mode": mode, "sat_cpu": sat_cpu, "sat_gpu": sat_gpu,
                     "max_util_rel": rel, "latency_rel": lat})
        if rel > 1e-3 or abs(sat_gpu - sat_cpu) > sat_tol + 1e-9:
            raise AssertionError(f"card and CPU disagree: {rows[-1]}")
        if mode == "min":
            continue
        # the certified engine, held as tests/test_torch_certified.py's
        # card test holds it
        kw = {"tol": 0.05, "certify": True, "cert_iters": 512}
        cpu = saturation_throughput(fp, device="cpu", **kw)
        gpu = saturation_throughput(fp, device="cuda", **kw)
        overlap = max(cpu.sat_lo, gpu.sat_lo) <= min(cpu.sat_hi,
                                                      gpu.sat_hi) + 1e-9
        rows.append({"mode": mode, "certified": True,
                     "value_cpu": cpu.value, "value_gpu": gpu.value,
                     "bracket_cpu": [cpu.sat_lo, cpu.sat_hi],
                     "bracket_gpu": [gpu.sat_lo, gpu.sat_hi],
                     "iters_cpu": cpu.cert.iters, "iters_gpu": gpu.cert.iters,
                     "kind": gpu.cert.kind})
        if (abs(gpu.value - cpu.value) > 0.06 or not overlap
                or gpu.cert.kind != cpu.cert.kind):
            raise AssertionError(f"certified card and CPU disagree: "
                                 f"{rows[-1]}")
    return {"config": "PF(13) p=7 random_perm seed 0", "runs": rows}


def phase_main_path(torch, state):
    import numpy as np

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import (build_flow_paths, make_pattern,
                                        saturation_throughput)
    from repro_torch.simulation.fluid import _probe_schedule

    with open(FIXTURE) as fh:
        ref = {(r["pattern"], r["mode"]): r["saturation"]
               for r in json.load(fh)["saturations"]}
    tol, probes = 0.01, 7
    iters = {"min": 250, "ugal": 1500, "ugal_pf": 1500}
    t0 = time.perf_counter()
    pf = build_polarfly(31)
    rt = build_routing(pf.graph, pf)
    setup_s = time.perf_counter() - t0
    rows, problems = [], []
    ops.LAUNCHES = 0  # the main path's count starts here
    for pattern in ("uniform", "random_perm"):
        pat = make_pattern(pattern, rt, p=16, seed=0)
        for mode, it in iters.items():
            fp = build_flow_paths(rt, pat, mode, k_candidates=10, seed=0)
            fp.device_arrays("cuda")
            torch.cuda.synchronize()
            before = ops.LAUNCHES
            t = time.perf_counter()
            sat = saturation_throughput(fp, tol=tol, iters=it, device="cuda")
            wall = time.perf_counter() - t
            launches = ops.LAUNCHES - before
            want = it + sum(_probe_schedule(it, probes)) \
                if mode != "min" else 0
            diff = abs(sat - ref[pattern, mode])
            ok = (np.isfinite(sat) and 0.0 <= sat <= 1.0
                  and launches == want
                  and (diff == 0.0 if mode == "min" else diff <= 0.05))
            f, k, l = fp.edges.shape
            rows.append({"pattern": pattern, "mode": mode, "iters": it,
                         "flows": f, "candidates": k, "path_len": l,
                         "saturation": sat, "reference": ref[pattern, mode],
                         "wall_s": wall, "launches": launches,
                         "launches_expected": want, "ok": bool(ok)})
            emit({"phase": "main_path.run", **rows[-1]})
            if not ok:
                problems.append(rows[-1])
    state["launches"] = ops.LAUNCHES
    sats = {(r["pattern"], r["mode"]): r["saturation"] for r in rows}
    state["pf31_routing"], state["main_sats"] = rt, sats
    ratio = sats["random_perm", "ugal"] / max(sats["random_perm", "min"],
                                              1e-9)
    if ratio < 3.5:
        problems.append({"sanity": "ugal < 3.5 x min on random_perm",
                         "ratio": ratio})
    if problems:
        raise AssertionError(f"main path failed its checks: {problems}")
    return {"config": "PF(31) p=16 seed 0 k_candidates 10 tol 0.01",
            "routing_setup_s": setup_s, "ugal_over_min_random_perm": ratio,
            "kernel_launches": state["launches"], "runs": rows}


def phase_certified(torch, state):
    """The certified engine and `trace=True` on the main path's PF(31)
    flows.  The path-cost counts start at 0 here and are read at the
    end."""
    import math

    import numpy as np

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import (build_flow_paths, evaluate_load,
                                        make_pattern, saturation_throughput)
    from repro_torch.simulation import fluid

    with open(CERT_FIXTURE) as fh:
        cref = {(r["pattern"], r["mode"]): r
                for r in json.load(fh)["saturations"]}
    with open(FIXTURE) as fh:
        uref = {(r["pattern"], r["mode"]): r["saturation"]
                for r in json.load(fh)["saturations"]}
    tol = 0.01
    probes = max(1, int(math.ceil(math.log2(1.0 / tol))))
    rt = state.get("pf31_routing")
    if rt is None:
        pf = build_polarfly(31)
        rt = build_routing(pf.graph, pf)
    pats = {p: make_pattern(p, rt, p=16, seed=0)
            for p in ("random_perm", "uniform")}
    fps = {}

    def flows(pattern, mode):
        if (pattern, mode) not in fps:
            fp = build_flow_paths(rt, pats[pattern], mode, k_candidates=10,
                                  seed=0)
            fp.device_arrays("cuda")
            fps[pattern, mode] = fp
        return fps[pattern, mode]

    rows, problems = [], []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    def certified(pattern, mode, **kw):
        fp = flows(pattern, mode)
        torch.cuda.synchronize()
        before = ops.LAUNCHES
        t = time.perf_counter()
        res = saturation_throughput(fp, tol=tol, certify=True,
                                    device="cuda", **kw)
        wall = time.perf_counter() - t
        launches = ops.LAUNCHES - before
        want = (probes + 1) + 33 * res.cert.iters // 32
        row = {"pattern": pattern, "mode": mode, "wall_s": wall,
               "value": res.value, "sat_lo": res.sat_lo,
               "sat_hi": res.sat_hi, "iters": res.cert.iters,
               "converged": res.cert.converged, "gap": res.cert.gap,
               "util_lb": res.cert.util_lb, "util_ub": res.cert.util_ub,
               "kind": res.cert.kind, "dtype": res.cert.dtype,
               "launches": launches, "launches_expected": want,
               "trace": "trace" in kw,
               "cert_iters": kw.get("cert_iters"),
               "ok": check(launches == want and np.isfinite(res.value)
                           and res.sat_lo <= res.value + 1e-9,
                           f"{pattern} {mode} launches or bracket")}
        return res, row

    ops.LAUNCHES = 0  # the certified path's counts start here
    ops.LAUNCHES_BY_DTYPE.update(float32=0, float64=0)
    results = {}
    for pattern, mode in (("random_perm", "ugal"), ("random_perm", "ugal_pf"),
                          ("uniform", "ugal")):
        res, row = certified(pattern, mode)
        ref, unc = cref[pattern, mode], uref[pattern, mode]
        # a bracket end within one bisection step of where the reference
        # puts it at its demand or at its demand moved one ulp either way
        runs = [ref] + ref["ulp_runs"]
        band = {end: (min(r[end] for r in runs) - tol - 1e-9,
                      max(r[end] for r in runs) + tol + 1e-9)
                for end in ("sat_lo", "sat_hi")}
        row.update({"reference": {k: ref[k] for k in
                                  ("value", "sat_lo", "sat_hi")},
                    "reference_iters": ref["cert"]["iters"],
                    "reference_ulp_runs": ref["ulp_runs"],
                    "uncertified_fixture": unc})
        row["ok"] &= check(
            abs(res.value - ref["value"]) <= 0.06
            and band["sat_lo"][0] <= res.sat_lo <= band["sat_lo"][1]
            and band["sat_hi"][0] <= res.sat_hi <= band["sat_hi"][1]
            and res.cert.kind == ref["cert"]["kind"]
            and res.sat_lo - 0.06 <= unc <= res.sat_hi + 0.06,
            f"{pattern} {mode} against the certified fixture")
        results[pattern, mode] = res
        rows.append(row)
        emit({"phase": "certified.run", **row})

    # float64 at half the uniform saturation: path_costs_f64 only.  It
    # does not converge within the default 2016 steps either, and it is
    # held on its launches, dtype and gap, so 512 steps show as much
    fp = flows("uniform", "ugal")
    before = (ops.LAUNCHES, dict(ops.LAUNCHES_BY_DTYPE))
    torch.cuda.synchronize()
    t = time.perf_counter()
    el = evaluate_load(fp, 0.5 * results["uniform", "ugal"].value,
                       certify=True, dtype="float64", cert_iters=512,
                       device="cuda")
    wall = time.perf_counter() - t
    launches = ops.LAUNCHES - before[0]
    by_dtype = {k: ops.LAUNCHES_BY_DTYPE[k] - before[1][k]
                for k in before[1]}
    want = 2 + 33 * el.cert.iters // 32
    rows.append({"pattern": "uniform", "mode": "ugal", "dtype": "float64",
                 "offered": el.value.offered, "wall_s": wall,
                 "max_util": el.value.max_util, "iters": el.cert.iters,
                 "converged": el.cert.converged, "gap": el.cert.gap,
                 "util_lb": el.cert.util_lb, "util_ub": el.cert.util_ub,
                 "launches": launches, "launches_by_dtype": by_dtype,
                 "launches_expected": want,
                 "ok": check(el.cert.dtype == "float64"
                             and np.isfinite(el.cert.gap)
                             and launches == want
                             and by_dtype == {"float32": 0,
                                              "float64": want},
                             "float64 evaluate_load")})
    emit({"phase": "certified.run", **rows[-1]})

    # trace=True: a certified saturation twice, untraced and traced, bit
    # identical (ugal_pf's at CERT_TRACE_ITERS a solve, a depth cut: the
    # default budget took 25-28 s a run)
    plain, row = certified("random_perm", "ugal_pf",
                           cert_iters=CERT_TRACE_ITERS)
    rows.append(row)
    emit({"phase": "certified.run", **row})
    res, row = certified("random_perm", "ugal_pf", trace=True,
                         cert_iters=CERT_TRACE_ITERS)
    same = (res.value, res.sat_lo, res.sat_hi, res.cert) == (
        plain.value, plain.sat_lo, plain.sat_hi, plain.cert)
    row.update({"bit_identical": check(same, "traced certified result"),
                "final_gap_is_cert_gap": check(
                    res.trace.final_gap == res.cert.gap,
                    "trace.final_gap != cert.gap"),
                "samples": res.trace.num_samples,
                "probes": res.trace.num_probes})
    rows.append(row)
    emit({"phase": "certified.run", **row})

    # trace=True on the uncertified batched saturation: the solve reads
    # nothing back on the host, so it runs with synchronising calls made
    # errors
    fp = flows("random_perm", "ugal")
    iters = 1500
    sched = fluid._probe_schedule(iters, probes)
    before = ops.LAUNCHES
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sat_t, yss, brs = fluid._saturation_batch_traced(
            fp, iters, sched, torch.device("cuda"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sat_t = float(sat_t)
    wall = time.perf_counter() - t
    launches = ops.LAUNCHES - before
    pub = saturation_throughput(fp, tol=tol, iters=iters, trace=True,
                                device="cuda")
    main = state.get("main_sats", {}).get(("random_perm", "ugal"))
    rows.append({"pattern": "random_perm", "mode": "ugal",
                 "uncertified_trace": True, "iters": iters,
                 "saturation": sat_t, "public_trace": pub.saturation,
                 "main_path": main, "wall_s": wall, "launches": launches,
                 "samples": pub.trace.num_samples,
                 "ok": check(sat_t == pub.saturation == main
                             and launches == iters + sum(sched)
                             and pub.trace.num_samples == iters + sum(sched),
                             "traced uncertified saturation")})
    emit({"phase": "certified.run", **rows[-1]})
    state["certified_launches"] = ops.LAUNCHES
    state["certified_launches_by_dtype"] = dict(ops.LAUNCHES_BY_DTYPE)
    check(ops.LAUNCHES > 0, "the certified path launched no kernel")
    if problems:
        raise AssertionError(f"certified path failed its checks: {problems}")
    return {"config": "PF(31) p=16 seed 0 k_candidates 10 tol 0.01, "
                      "default budget",
            "kernel_launches": ops.LAUNCHES,
            "kernel_launches_by_dtype": dict(ops.LAUNCHES_BY_DTYPE),
            "runs": rows}


def sha(a):
    """sha256 of an array's dtype, shape and bytes (the hash
    scripts/make_torch_port_reference.py --packet records)."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def phase_packet(torch, state):
    """The flit-level packet engine at PF(31) (993 routers, 31,744
    directed links), bench_fig_tail.py's settings: every run of
    tests/fixtures/torch_port_pf31_packet.json held against the JAX
    package's workload and result hashes, counts and tails, a four-replica
    batch against single runs, one profiled cycle, and one whole run with
    synchronising calls made errors."""
    import dataclasses

    import numpy as np

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import (BurstSchedule,
                                        build_failure_workload,
                                        build_flow_paths, make_pattern,
                                        make_workload, packet_peak_bytes,
                                        simulate_packets,
                                        simulate_packets_batch)
    from repro_torch.simulation import packet

    with open(PACKET_FIXTURE) as fh:
        fixture = json.load(fh)
    c = fixture["config"]
    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    t0 = time.perf_counter()
    rt = state.get("pf31_routing")
    if rt is None:
        pf = build_polarfly(c["q"])
        rt = build_routing(pf.graph, pf)
    g = rt.graph
    el = g.edge_list
    rng = np.random.default_rng(0)  # bench_fig_tail.py's failed links
    rt2 = build_routing(g.subgraph_without_edges(
        el[rng.choice(len(el), c["failed_links"], replace=False)]))
    pats = {p: make_pattern(p, rt, p=c["p"], seed=c["seed"])
            for p in ("uniform", "random_perm")}
    setup_s = time.perf_counter() - t0
    kw = dict(size=c["size"], capacity=c["capacity"],
              max_packets=c["max_packets"])
    dev = torch.device("cuda")
    rows, wls = [], {}
    for ref in fixture["runs"]:
        key = (ref["pattern"], ref["mode"], ref["scenario"])
        t = time.perf_counter()
        if ref["scenario"] == "failure":
            wl = build_failure_workload(
                rt, rt2, pats[ref["pattern"]], ref["mode"], ref["offered"],
                c["cycles"], c["switch_cycle"],
                k_candidates=c["k_candidates"], seed=c["seed"], **kw)
        else:
            fp = build_flow_paths(rt, pats[ref["pattern"]], ref["mode"],
                                  k_candidates=c["k_candidates"],
                                  seed=c["seed"])
            burst = (BurstSchedule(*c["burst"])
                     if ref["scenario"] == "burst" else None)
            wl = make_workload(fp, ref["offered"], c["cycles"], burst=burst,
                               seed=c["seed"], **kw)
        host_s = time.perf_counter() - t
        wls[key] = wl
        wl_ok = check({k: sha(getattr(wl, k)) for k in ref["workload_sha256"]}
                      == ref["workload_sha256"], f"{key} workload hashes")
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = simulate_packets(wl, device="cuda")  # the checked warm-up
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        again = simulate_packets(wl, device="cuda")
        wall = time.perf_counter() - t
        got = {"delivered": sha(res.delivered), "dropped": sha(res.dropped),
               "deliver_t_delivered": sha(res.deliver_t[res.delivered]),
               "occ_sum": sha(res.occ_sum), "occ_max": sha(res.occ_max)}
        spot = ((res.occ_max <= wl.capacity).all()
                and not (res.delivered & res.dropped).any()
                and res.num_delivered + res.num_dropped
                + int(res.occ_sum[-1]) <= wl.num_packets
                and (res.deliver_t[res.delivered]
                     >= res.inject_t[res.delivered]).all())
        row = {"pattern": ref["pattern"], "mode": ref["mode"],
               "offered": ref["offered"], "scenario": ref["scenario"],
               "flows": wl.num_flows, "packets": wl.num_packets,
               "delivered": res.num_delivered, "dropped": res.num_dropped,
               "tails": res.tails(), "workload_hashes_equal": wl_ok,
               "result_hashes_equal": check(
                   got == ref["result_sha256"], f"{key} result hashes"),
               "counts_and_tails_equal": check(
                   (wl.num_packets, res.num_delivered, res.num_dropped,
                    res.tails()) == (ref["packets"], ref["delivered"],
                                     ref["dropped"], ref["tails"]),
                   f"{key} counts or tails"),
               "spot_checks": check(spot, f"{key} conservation"),
               "rerun_equal": check(
                   all(np.array_equal(getattr(res, f), getattr(again, f))
                       for f in ("delivered", "dropped", "deliver_t",
                                 "occ_sum", "occ_max")),
                   f"{key} second run differs"),
               "host_workload_s": host_s, "first_run_s": first_s,
               "wall_s": wall, "cycles_per_s": wl.cycles / wall,
               "delivered_per_s": res.num_delivered / wall,
               "ms_per_cycle": 1e3 * wall / wl.cycles,
               "packet_peak_bytes": packet_peak_bytes(wl)}
        if ref["scenario"] == "failure":
            check(res.num_dropped > 0, "the failure run dropped nothing")
        rows.append(row)
        emit({"phase": "packet.run", **row})

    # four same-shape replicas of the random_perm valiant workload, as
    # tests/test_packet_engine.py's batch test builds them
    wl = wls["random_perm", "valiant", "steady"]
    rng = np.random.default_rng(5)
    reps = [wl] + [dataclasses.replace(
        wl, pkt_cand=wl.pkt_cand[:, rng.permutation(wl.num_packets)])
        for _ in range(3)]
    t = time.perf_counter()
    batch = simulate_packets_batch(reps, device="cuda")
    batch_s = time.perf_counter() - t
    singles = [simulate_packets(w, device="cuda") for w in reps]
    same = all(np.array_equal(getattr(a, f), getattr(b, f))
               for a, b in zip(batch, singles)
               for f in ("delivered", "dropped", "deliver_t", "occ_sum",
                         "occ_max"))
    rows.append({"batch": len(reps), "pattern": "random_perm",
                 "mode": "valiant", "wall_s": batch_s,
                 "equal_to_single_runs": check(same, "batch != singles"),
                 "delivered": [r.num_delivered for r in batch]})
    emit({"phase": "packet.batch", **rows[-1]})

    # one whole run (both epochs and the failure transform) with
    # synchronising calls made errors: the loop reads nothing back
    key = ("uniform", "ugal", "failure")
    wl = wls[key]
    ref = next(r for r in fixture["runs"]
               if (r["pattern"], r["mode"], r["scenario"]) == key)
    run = packet._BatchedRun([wl], np.zeros(0, np.int64), dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            run.run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = run.fetch()
    rows.append({"sync_debug_error_run": list(key), "equal": check(
        sha(out["occ_max"][:, 0]) == ref["result_sha256"]["occ_max"]
        and sha(out["delivered"]) == ref["result_sha256"]["delivered"],
        "the sync-debug run differs")})
    emit({"phase": "packet.sync", **rows[-1]})

    # one profiled cycle in the middle of the adaptive failure run's
    # epoch 1, beside the unprofiled per-cycle wall of the same run
    mid = (wl.switch_cycle + wl.cycles) // 2
    run = packet._BatchedRun([wl], np.zeros(0, np.int64), dev)
    with torch.no_grad():
        run.run(mid)
        torch.cuda.synchronize()
        prof = device_time_by_kernel(torch, lambda: run.cycle(mid, 1))
    per_cycle_ms = next(r["ms_per_cycle"] for r in rows
                        if (r.get("pattern"), r.get("mode"),
                            r.get("scenario")) == key)
    profile = {"cycle": mid, "run": list(key), **prof,
               "unprofiled_ms_per_cycle": per_cycle_ms}
    if prof.get("kernels"):  # the profiler saw the card's work
        profile["idle_share_profiled"] = 1 - prof["device_ms"] / max(
            prof["wall_ms"], 1e-9)
        profile["idle_share_unprofiled"] = 1 - prof["device_ms"] / max(
            per_cycle_ms, 1e-9)
    emit({"phase": "packet.profile", **profile})
    if problems:
        raise AssertionError(f"packet phase failed its checks: {problems}")
    return {"config": f"PF({c['q']}) p={c['p']} k_candidates "
                      f"{c['k_candidates']} seed {c['seed']}, {c['cycles']} "
                      f"cycles, {c['size']}-flit packets, {c['capacity']}"
                      "-packet queues",
            "num_links": wls[key].num_links, "routing_setup_s": setup_s,
            "profile": profile, "runs": rows}


def phase_analysis(torch, state):
    """The structural-analysis path on the card: the §IV-D routing table,
    the §IX diameters under link failure, the blocked routing on the
    device BFS.  The kernel counts start at 0 here and are read at the
    end; the checks against plain versions launch no kernel."""
    import numpy as np

    from repro_torch.core.metrics import diameter_and_aspl, resilience_sweep
    from repro_torch.core.routing import (build_blocked_routing,
                                          distance_blocks)
    from repro_torch.kernels.gf_crossprod import ops as gf_ops
    from repro_torch.kernels.minplus import ops as mp_ops
    from repro_torch.kernels.minplus.ref import apsp_steps

    pf, dmg = graphs(state)
    out, problems = {"pf_build_s": state["pf_build_s"]}, []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    gf_ops.LAUNCHES = 0  # the analysis path's counts start here
    mp_ops.MINPLUS_LAUNCHES = 0
    mp_ops.MINPLUS_HOPS_LAUNCHES = 0

    # §IV-D: the table of 2-hop intermediate routers
    p31, p79 = pf[31], pf[79]
    t = time.perf_counter()
    table = gf_ops.intermediate_table(p31.vertices, 31)
    wall = time.perf_counter() - t
    off = ~np.eye(p31.n, dtype=bool)
    host = p31.intermediates_all_pairs()
    out["table_pf31"] = {"wall_s": wall, "shape": list(table.shape),
                         "equal_off_diagonal": check(
                             np.array_equal(table[off], host[off]),
                             "pf31 intermediate table")}
    t = time.perf_counter()
    table = gf_ops.intermediate_table(p79.vertices, 79)
    wall = time.perf_counter() - t
    rng = np.random.default_rng(0)
    src = rng.integers(0, p79.n, 4096)
    dst = (src + rng.integers(1, p79.n, 4096)) % p79.n  # never src
    want = np.array([p79.intermediate(int(a), int(b))
                     for a, b in zip(src, dst)])
    out["table_pf79"] = {"wall_s": wall, "shape": list(table.shape),
                         "pairs_checked": len(src), "equal": check(
                             np.array_equal(table[src, dst], want),
                             "pf79 intermediate table")}
    del table
    out["gf_crossprod_launches"] = gf_ops.LAUNCHES
    check(gf_ops.LAUNCHES == 2, "one gf_crossprod launch per table")

    # §IX at PF(31): card diameters against the host resilience sweep
    fr = FIG14_FRACTIONS[31]
    t = time.perf_counter()
    sweep = resilience_sweep(p31.graph, fr, seed=1)
    host_s = time.perf_counter() - t
    rows = []
    for f, g, pt in zip(fr, dmg[31], sweep):
        before = mp_ops.MINPLUS_HOPS_LAUNCHES
        t = time.perf_counter()
        diam = mp_ops.diameter_from_adj(g.adjacency)
        wall = time.perf_counter() - t
        launches = mp_ops.MINPLUS_HOPS_LAUNCHES - before
        want = np.inf if pt.diameter == -1 else float(pt.diameter)
        rows.append({"fraction": f, "diameter": diam,
                     "host_diameter": pt.diameter, "wall_s": wall,
                     "launches": launches,
                     "ok": check(diam == want and launches == apsp_steps(
                         g.n), f"pf31 diameter at {f}")})
    out["fig14_pf31"] = {"host_sweep_s": host_s, "runs": rows}

    # §IX at PF(79): APSP against the device BFS over all pairs
    rows = []
    for f, g in zip(FIG14_FRACTIONS[79], dmg[79]):
        before = mp_ops.MINPLUS_HOPS_LAUNCHES
        t = time.perf_counter()
        d = mp_ops.apsp(g.adjacency)
        apsp_s = time.perf_counter() - t
        launches = mp_ops.MINPLUS_HOPS_LAUNCHES - before
        t = time.perf_counter()
        same, blocks = True, 0
        for srcs, db, _ in distance_blocks(g, backend="sharded"):
            bfs = db.astype(np.float32)
            bfs[db < 0] = np.inf
            same &= bool(np.array_equal(d[srcs], bfs))
            blocks += 1
        bfs_s = time.perf_counter() - t
        t = time.perf_counter()
        diam, aspl = diameter_and_aspl(g, backend="sharded")
        metric_s = time.perf_counter() - t
        apsp_diam = float(d.max())
        want_diam = np.inf if diam == -1 else float(diam)
        finite = np.isfinite(d).all()
        apsp_aspl = (float(d.sum(dtype=np.float64)) / (g.n * (g.n - 1))
                     if finite else float("inf"))
        rows.append({"fraction": f, "links": g.num_edges,
                     "apsp_s": apsp_s, "launches": launches,
                     "bfs_s": bfs_s, "bfs_blocks": blocks,
                     "diameter_and_aspl_s": metric_s,
                     "diameter": diam, "aspl": aspl,
                     "apsp_diameter": apsp_diam, "apsp_aspl": apsp_aspl,
                     "equal_all_pairs": check(same, f"pf79 apsp at {f}"),
                     "ok": check(apsp_diam == want_diam and aspl == apsp_aspl
                                 and launches == apsp_steps(g.n),
                                 f"pf79 diameter at {f}")})
        del d
    out["fig14_pf79"] = {"runs": rows}

    # blocked routing on the device BFS against the host backend
    g = p31.graph
    t = time.perf_counter()
    dev = build_blocked_routing(g, backend="sharded")
    cols_same = True
    for a, b in zip(build_blocked_routing(g, backend="host").dest_blocks(),
                    dev.dest_blocks()):
        cols_same &= all(np.array_equal(x, y) for x, y in zip(a, b))
    out["blocked_routing_pf31"] = {
        "wall_s": time.perf_counter() - t, "diameter": dev.diameter,
        "block": dev.block, "equal_columns": check(
            cols_same and dev.diameter == 2, "pf31 blocked routing")}

    # `apsp` takes the integer route on these symmetric graphs: the float
    # kernel is launched by no call of the path
    check(mp_ops.MINPLUS_LAUNCHES == 0, "float minplus launched by apsp")
    state["minplus_launches"] = mp_ops.MINPLUS_LAUNCHES
    state["minplus_hops_launches"] = mp_ops.MINPLUS_HOPS_LAUNCHES
    state["gf_launches"] = gf_ops.LAUNCHES
    out["minplus_launches"] = mp_ops.MINPLUS_LAUNCHES
    out["minplus_hops_launches"] = mp_ops.MINPLUS_HOPS_LAUNCHES
    if problems:
        raise AssertionError(f"analysis path failed its checks: {problems}")
    return out


def sweep_dests(n, block, blocks):
    """bench_blockwise_scaling.py's sweep: `blocks` blocks of `block`
    destinations drawn with default_rng(0), sorted."""
    import numpy as np

    rng = np.random.default_rng(0)
    return np.sort(rng.choice(n, size=block * blocks, replace=False))


def flow_hashes(fp):
    """sha256 of a FlowPaths' pattern and path arrays (the hashes
    scripts/make_torch_port_reference.py --scale records)."""
    return {**{k: sha(getattr(fp.pattern, k)) for k in ("src", "dst",
                                                        "demand")},
            **{k: sha(getattr(fp, k)) for k in ("edges", "hops", "valid",
                                                "is_min", "first_edge")}}


def routing_hashes(rt):
    """sha256 of a RoutingTables' distance and next-hop tables."""
    return {"dist": sha(rt.dist), "next_hop": sha(rt.next_hop)}


def graph_hash(g):
    """sha256 of a graph's sorted undirected edge list."""
    return sha(g.edge_list)


def figure_graph(builder, args, topologies, build_polarfly):
    """The graph of a Fig. 14 entry (`[builder, arguments]`), built by the
    package whose `topologies` module and `build_polarfly` are passed."""
    if builder == "build_polarfly":
        return build_polarfly(*args).graph
    return getattr(topologies, builder)(*args)


LATENCY_REL = 1e-3  # a figure's latency point against the reference's


def fig9_load(sat):
    """bench_fig9_adaptive.py's latency point: 0.9 of the saturation, or
    of 0.02 where the saturation is below it."""
    return 0.9 * max(sat, 0.02)


def table5_traffic(g):
    """bench_fig8_saturation.py's traffic on Table V topology `g`: (p,
    hosts), p = max(2, radix // 2) endpoints a router; on a graph with leaf
    switches (the fat tree) the hosts are those, else every router."""
    import numpy as np

    p = max(2, g.params.get("radix", 8) // 2)
    hosts = (np.arange(g.params["leaf_switches"], dtype=np.int32)
             if "leaf_switches" in g.params else None)
    return p, hosts


def fig10_p(builder, args, g, blocked):
    """bench_fig10_sizes.py's endpoints a router: (q + 1) // 2 on a
    PolarFly of its sweep, radix // 2 on every other graph and on the
    blocked tier."""
    if builder == "build_polarfly" and not blocked:
        return (args[0] + 1) // 2
    return g.params["radix"] // 2


def fig10_max_flows(c, mode, n):
    """bench_fig10_sizes.py's flow sample: `c["max_flows"]` (the fixture's
    fig10 `config`) for `mode`, the adaptive one halved past
    `above_n` routers."""
    mf = c["max_flows"]
    if mode == "min":
        return mf["min"]
    return mf["adaptive"] if n <= mf["above_n"] else mf["adaptive_above"]


def fig15_ratios(sats, ports, floor):
    """bench_fig15_cost.py's cost per node normalised to PolarFly: {traffic:
    {topology: (ports / max(sat, floor)) / PF's}} from `sats`, {(topology,
    traffic): saturation}."""
    out = {}
    for (name, key), sat in sats.items():
        base = ports["PF"] / max(sats["PF", key], floor)
        out.setdefault(key, {})[name] = ports[name] / max(sat, floor) / base
    return out


def table5_bar(run, step, band=None):
    """(lo, hi) that an adaptive saturation must lie in, besides being
    above 0: the reference's `run["saturation"]`, or the least and greatest
    of it and its runs with the demand moved by whole ulps (`band`, or
    Table V's `run["ulp_band"]`, scripts/table5_sensitivity.py) where
    measured, widened by one bisection `step` (the adaptive iterate may end
    a step away on another device)."""
    lo, hi = band or run.get("ulp_band", [run["saturation"]] * 2)
    return lo - step, hi + step


def checker(problems):
    """check(ok, what): `what` goes into `problems` when `ok` is false;
    returns bool(ok)."""
    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)
    return check


def held_paths(torch, check, rt, pat, mode, c, want, label):
    """(FlowPaths, row): `build_flow_paths` of `pat` under `mode` at `c`'s
    k_candidates and seed, its seconds and [F, K, L], its pattern and path
    arrays held by their hashes and its shape against the fixture row
    `want`."""
    from repro_torch.simulation import build_flow_paths

    fp, paths_s = synced(torch, lambda: build_flow_paths(
        rt, pat, mode, k_candidates=c["k_candidates"], seed=c["seed"]))
    f, k, l = fp.edges.shape
    return fp, {
        "flows": f, "candidates": k, "path_len": l,
        "num_links": fp.num_links, "paths_s": paths_s,
        "hashes_equal": check(
            flow_hashes(fp) == want["sha256"]
            and [f, k, l, fp.num_links] == [want["flows"], want["candidates"],
                                            want["path_len"],
                                            want["num_links"]],
            f"{label} FlowPaths hashes")}


def loads_route(fp):
    """How `fp`'s solves on the card sum link loads ("pad": a padded
    per-link gather; "scatter": index_add_ past the pad table's entry cap)
    and the path-cost kernel's row plan at its shape."""
    from repro_torch.kernels.minplus import ops

    eidx, loads_rep = fp.device_arrays("cuda")[:2]
    f, k, l = eidx.shape
    return {"loads": loads_rep[0],
            "rows": ops._path_costs_plan(f * k, l, eidx.data_ptr())["rows"]}


def held_saturation(torch, check, fp, tol, iters, engine, want, label,
                    bar=None):
    """`saturation_throughput` of `fp` on the card, held against the
    reference's `want["saturation"]`: finite, in (0, 1], within 0.05 and
    inside `bar` -- by default `table5_bar` for an adaptive mode, and
    equal for an oblivious one, which has no iterate to drift -- with
    `iters + sum(_probe_schedule)` path-cost launches adaptive and 0
    oblivious.  Returns the row, with `loads_route`."""
    import numpy as np

    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import saturation_throughput
    from repro_torch.simulation.fluid import _probe_schedule

    route = loads_route(fp)
    before = ops.LAUNCHES
    sat, wall = synced(torch, lambda: saturation_throughput(
        fp, tol=tol, iters=iters, engine=engine, device="cuda"))
    launches = ops.LAUNCHES - before
    ref = want["saturation"]
    if fp.mode in ("ugal", "ugal_pf"):
        probes = max(1, int(np.ceil(np.log2(1.0 / tol))))
        want_l = iters + sum(_probe_schedule(iters, probes))
        bar = bar or table5_bar(want, bisection_step(tol))
    else:
        want_l, bar = 0, bar or (ref, ref)
    diff = abs(sat - ref)
    return {**route, "saturation": sat, "reference": ref, "diff": diff,
            "bar": list(bar), "wall_s": wall, "launches": launches,
            "launches_expected": want_l,
            "ok": check(np.isfinite(sat) and 0.0 < sat <= 1.0
                        and diff <= 0.05 and bar[0] <= sat <= bar[1]
                        and launches == want_l,
                        f"{label} saturation {sat} (reference {ref}, bar "
                        f"{bar}), launches {launches} (want {want_l})")}


def kernel_path_costs_at(torch, label, fp, path_launches):
    """path_costs on a scale point's own flows (`path_cost_inputs`)
    against its plain version (bit for bit) and `embedding_bag`, timed
    beside the bytes bound.  The bound reads the table entries these
    flows touch, once (the work depends on the data).  `path_launches`
    is what the point's run launched: a shape the path never gives the
    kernel (min bypasses the FW loop) is marked off the path."""
    import torch.nn.functional as F

    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ref import path_costs_ref

    eidx, delay = path_cost_inputs(torch, fp)
    f, k, l = eidx.shape
    n_out = f * k
    out = ops.path_costs(delay, eidx)
    same = bool(torch.equal(out, path_costs_ref(delay, eidx)))
    if not same:
        raise AssertionError(f"path_costs differs from its plain version "
                             f"at {label}")
    touched = int(torch.unique(eidx).numel())
    bytes_moved = n_out * l * 4 + n_out * 4 + touched * 4
    bound = bytes_moved / HBM_BYTES_PER_S * 1e3
    ms = gpu_ms(torch, lambda: ops.path_costs(delay, eidx))
    flat, table = eidx.view(-1, l), delay.view(-1, 1)
    return {"shape": label, "eidx": [f, k, l], "table": delay.numel(),
            "path_launches": path_launches, "on_path": path_launches > 0,
            "table_entries_touched": touched, "bit_identical": same,
            "max_abs_err": 0.0, "kernel_ms": ms,
            "plain_ms": gpu_ms(torch, lambda: path_costs_ref(delay, eidx)),
            "library_ms": gpu_ms(torch, lambda: F.embedding_bag(
                flat, table, mode="sum")),
            "bound_ms": bound, "bound_by": "bytes", "bytes": bytes_moved,
            "bound_share": bound / ms,
            "plan": ops._path_costs_plan(n_out, l, eidx.data_ptr())}


def synced(torch, fn):
    """(fn(), its wall seconds), the card synchronised before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def bisection_step(tol):
    """The width of `saturation_throughput`'s last bisection bracket:
    2^-ceil(log2(1 / tol)), the resolution every saturation it returns
    is a multiple of."""
    import numpy as np

    return 2.0 ** -max(1, int(np.ceil(np.log2(1.0 / tol))))


def phase_scale(torch, state):
    """The reference's scale tier on the card through the blocked routing
    stack, which never holds an [n, n] table: PF(79) ugal_pf and PF(157)
    min saturations, the PF(157) destination sweep, the PF(79) packet
    point, each held against tests/fixtures/torch_port_scale_reference.json
    (the JAX package's run), whose `config` gives the points' settings.
    Every card the sweeps use is set up before the first timed stage.
    The path-cost count starts at 0 here and is read before the kernel is
    held and timed at the points' shapes."""
    import numpy as np

    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import (build_blocked_routing,
                                          destination_blocks)
    from repro_torch.kernels.minplus import ops
    from repro_torch.parallel.blockwise import resolve_devices
    from repro_torch.simulation import (make_pattern, make_workload,
                                        packet_peak_bytes, simulate_packets)

    with open(SCALE_FIXTURE) as fh:
        fixture = json.load(fh)
    config, ref = fixture["config"], fixture["points"]
    ndev = torch.cuda.device_count()
    cards = resolve_devices(ndev)
    for d in cards:  # each card's context, outside the timed stages
        torch.empty(1, device=d)
        torch.cuda.synchronize(d)
    problems, out = [], {"cards": len(cards)}
    check = checker(problems)
    paths_fp, path_launches = {}, {}

    def paths(rt, key):
        c = config[key]
        pat, pattern_s = synced(torch, lambda: make_pattern(
            "uniform", rt, p=c["p"], seed=c["seed"],
            max_flows=c["max_flows"]))
        fp, row = held_paths(torch, check, rt, pat, c["mode"], c, ref[key],
                             key)
        return fp, {"pattern_s": pattern_s, **row}

    ops.LAUNCHES = 0  # the scale path's count starts here
    # (a) PF(79) adaptive: fig10's scale tier, the n-source BFS on the card
    key = "pf79_ugal_pf"
    c = config[key]
    g79, graph_s = synced(torch, lambda: build_polarfly(c["q"]).graph)
    rt79, routing_s = synced(torch, lambda: build_blocked_routing(
        g79, backend="sharded", devices=ndev))
    row = {"routers": g79.n, "graph_s": graph_s,
           "routing_s": routing_s,  # the n-source BFS sweep on the card
           "diameter": rt79.diameter, "dest_block": rt79.block,
           "diameter_ok": check(rt79.diameter == 2, "pf79 diameter")}
    fp, prow = paths(rt79, key)
    row.update(prow)
    # within one bisection step of the reference's (`table5_bar`): the
    # adaptive iterate may end a step away on another device
    row.update(held_saturation(torch, check, fp, c["tol"], c["iters"],
                               "batched", ref[key], key))
    it10 = c["fig10_iters"]
    row[f"at_{it10}_iters"] = held_saturation(
        torch, check, fp, c["tol"], it10, "batched",
        {"saturation": ref[key]["saturation_fig10"]}, f"{key} at {it10}")
    paths_fp[key] = fp
    path_launches[key] = (row["launches"]
                          + row[f"at_{it10}_iters"]["launches"])
    out[key] = row
    emit({"phase": "scale.run", "point": key, **row})

    # (c) the PF(79) packet point, on (a)'s routing
    key = "pf79_packet"
    c = config[key]
    fp8, row = paths(rt79, key)
    want = ref[key]
    wl, workload_s = synced(torch, lambda: make_workload(
        fp8, c["offered"], c["cycles"], seed=c["seed"],
        flow_sample=c["flow_sample"], max_packets=c["max_packets"]))
    row["workload_s"] = workload_s
    row["workload_hashes_equal"] = check(
        {k: sha(getattr(wl, k)) for k in want["workload_sha256"]}
        == want["workload_sha256"], "pf79 packet workload hashes")
    del fp8
    torch.cuda.reset_peak_memory_stats()
    res, first_s = synced(torch, lambda: simulate_packets(wl,
                                                          device="cuda"))
    again, wall = synced(torch, lambda: simulate_packets(wl, device="cuda"))
    got = {"delivered": sha(res.delivered), "dropped": sha(res.dropped),
           "deliver_t_delivered": sha(res.deliver_t[res.delivered]),
           "occ_sum": sha(res.occ_sum), "occ_max": sha(res.occ_max)}
    row.update({
        "packets": wl.num_packets, "workload_flows": wl.num_flows,
        "links": wl.num_links, "delivered": res.num_delivered,
        "dropped": res.num_dropped, "tails": res.tails(),
        "result_hashes_equal": check(got == want["result_sha256"],
                                     "pf79 packet result hashes"),
        "counts_and_tails_equal": check(
            (wl.num_packets, res.num_delivered, res.num_dropped,
             res.tails()) == (want["packets"], want["delivered"],
                              want["dropped"], want["tails"]),
            "pf79 packet counts or tails"),
        "rerun_equal": check(all(np.array_equal(getattr(res, f),
                                                getattr(again, f))
                                 for f in ("delivered", "dropped",
                                           "deliver_t", "occ_sum",
                                           "occ_max")),
                             "pf79 packet second run differs"),
        "first_run_s": first_s, "wall_s": wall,
        "ms_per_cycle": 1e3 * wall / wl.cycles,
        "packet_peak_bytes": packet_peak_bytes(wl),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "card_memory": torch.cuda.get_device_properties(0).total_memory})
    # the sizes phase's Fig. 8 point runs on this routing (k does not
    # enter it)
    state["pf79_routed"] = (g79, rt79, {
        "routers": g79.n, "radix": g79.params["radix"],
        "links": g79.num_edges, "diameter": rt79.diameter, "blocked": True,
        "graph_s": graph_s, "routing_s": routing_s})
    del wl, res, again
    out[key] = row
    emit({"phase": "scale.run", "point": key, **row})

    # (b) PF(157) oblivious: the blockwise-scaling LARGE tier
    key = "pf157_min"
    c, want = config[key], ref[key]
    g, graph_s = synced(torch, lambda: build_polarfly(c["q"]).graph)
    dests = sweep_dests(g.n, c["block"], c["sweep_blocks"])
    cols, sweep_s = synced(torch, lambda: list(destination_blocks(
        g, dests=dests, block=c["block"], backend="sharded",
        devices=ndev)))
    # the fixture's hashes are the JAX package's host backend's columns
    dist = np.concatenate([d for _, d, _ in cols], axis=1)
    nh = np.concatenate([h for _, _, h in cols], axis=1)
    row = {"routers": g.n, "graph_s": graph_s, "sweep_blocks": len(cols),
           "sweep_s": sweep_s,
           "sweep_hashes_equal": check(
               {"dests": sha(dests), "dist_cols": sha(dist),
                "nh_cols": sha(nh)} == want["sweep_sha256"],
               "pf157 sweep hashes")}
    del cols, dist, nh
    rt, routing_s = synced(torch, lambda: build_blocked_routing(
        g, block=c["block"], diameter=c["diameter"], backend="sharded",
        devices=ndev))
    row["routing_s"] = routing_s
    fp, prow = paths(rt, key)
    row.update(prow)
    # oblivious: held to the bit, as the main path holds min
    row.update(held_saturation(torch, check, fp, c["tol"], c["iters"],
                               "batched", want, key))
    paths_fp[key] = fp
    path_launches[key] = row["launches"]
    out[key] = row
    emit({"phase": "scale.run", "point": key, **row})
    state["scale_launches"] = ops.LAUNCHES  # the scale path's, read here

    # path_costs at the points' shapes (launches made here are not the
    # path's)
    shapes = [kernel_path_costs_at(torch, k, v, path_launches[k])
              for k, v in paths_fp.items()]
    state["path_costs_scale_shapes"] = shapes
    out["path_costs"] = shapes
    emit({"phase": "scale.path_costs", "shapes": shapes})
    out["path_costs_launches"] = state["scale_launches"]
    if problems:
        raise AssertionError(f"scale tier failed its checks: {problems}")
    return out


def phase_table5(torch, state):
    """The paper's Table V comparison on the card: bench_fig8_saturation.py's
    grid on Slim Fly, the two Dragonflies, Jellyfish and the fat tree of
    `paper_table5_configs(seed=0)`, every stage through the port, held
    against tests/fixtures/torch_port_table5_reference.json (the JAX
    package's run), whose `config` gives the grid: routing tables, patterns
    and FlowPaths by their hashes, oblivious saturations equal, adaptive
    ones above 0, within 0.05 and inside `table5_bar` (one bisection step
    about the reference's, or about its ±1-ulp band where measured),
    path-cost launches `iters + sum(_probe_schedule)` an adaptive
    saturation and 0 an oblivious one (`held_saturation`).  PolarFly's row is
    main_path's PF(31) run beside its fixture, so the phase prints the
    whole Table V, port beside reference; which topology wins is not
    checked.  The path-cost count starts at 0 here and is read before the
    kernel is held and timed at each adaptive topology's uniform ugal_pf
    shape."""
    from repro_torch.core.routing import build_routing
    from repro_torch.core.topologies import paper_table5_configs
    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import make_pattern

    with open(TABLE5_FIXTURE) as fh:
        fixture = json.load(fh)
    config, ref = fixture["config"], fixture["topologies"]
    problems, rows, tops = [], [], {}
    check = checker(problems)
    timed_fp, shape_launches = {}, {}

    graphs, graphs_s = synced(torch, lambda: paper_table5_configs(
        seed=config["seed"]))
    ops.LAUNCHES = 0  # the Table V path's count starts here
    for name in config["topologies"]:
        g, want = graphs[name], ref[name]
        rt, routing_s = synced(torch, lambda: build_routing(g))
        p, hosts = table5_traffic(g)
        top = {"routers": g.n, "radix": g.params["radix"], "p": p,
               "hosts": g.n if hosts is None else len(hosts),
               "diameter": int(rt.diameter), "routing_s": routing_s}
        top["shape_ok"] = check(
            {k: top[k] for k in ("routers", "radix", "p", "hosts",
                                 "diameter")}
            == {k: want[k] for k in ("routers", "radix", "p", "hosts",
                                     "diameter")}, f"{name} shape")
        top["routing_hashes_equal"] = check(
            routing_hashes(rt) == want["routing_sha256"],
            f"{name} routing tables")
        runs = {(r["pattern"], r["mode"]): r for r in want["runs"]}
        for pattern in config["patterns"]:
            pat, pattern_s = synced(torch, lambda: make_pattern(
                pattern, rt, p=p, hosts=hosts, seed=config["seed"]))
            for mode in config["modes"][name]:
                r, it = runs[pattern, mode], config["iters"][mode]
                label = f"{name} {pattern} {mode}"
                fp, row = held_paths(torch, check, rt, pat, mode, config, r,
                                     label)
                rows.append({"topology": name, "pattern": pattern,
                             "mode": mode, "iters": it,
                             "pattern_s": pattern_s, **row,
                             **held_saturation(torch, check, fp,
                                               config["tol"], it,
                                               config["engine"], r, label)})
                emit({"phase": "table5.run", **rows[-1]})
                # the launches each [F, K, L] shape took (uniform ugal and
                # ugal_pf share theirs)
                shape = (name, *fp.edges.shape)
                shape_launches[shape] = (shape_launches.get(shape, 0)
                                         + rows[-1]["launches"])
                if (pattern, mode) == ("uniform", "ugal_pf"):
                    timed_fp[name] = fp
        tops[name] = top
        emit({"phase": "table5.topology", "topology": name, **top})
    state["table5_launches"] = ops.LAUNCHES  # the Table V path's, read here

    # path_costs at each adaptive topology's uniform ugal_pf shape, the
    # generic (L > 4) route among them (launches here are not the path's)
    shapes = [kernel_path_costs_at(torch, f"{k} uniform ugal_pf", v,
                                   shape_launches[(k, *v.edges.shape)])
              for k, v in timed_fp.items()]
    state["path_costs_table5_shapes"] = shapes
    emit({"phase": "table5.path_costs", "shapes": shapes})

    # Table V: PF(31) from main_path (when it ran) beside its fixture
    with open(FIXTURE) as fh:
        pf_ref = {(r["pattern"], r["mode"]): r["saturation"]
                  for r in json.load(fh)["saturations"]}
    grid = {"PF": {f"{pt}.{m}": {"port": state.get("main_sats", {}).get(
        (pt, m)), "reference": v} for (pt, m), v in pf_ref.items()}}
    for r in rows:
        grid.setdefault(r["topology"], {})[
            f"{r['pattern']}.{r['mode']}"] = {"port": r["saturation"],
                                              "reference": r["reference"]}
    if problems:
        raise AssertionError(f"Table V failed its checks: {problems}")
    return {"config": config, "graphs_s": graphs_s, "topologies": tops,
            "runs": rows, "table5": grid, "path_costs": shapes,
            "path_costs_launches": state["table5_launches"]}


def band(run, quantity, moves=None):
    """[least, greatest] of the reference's `run[quantity]` and its runs
    with the demand moved by up to `moves` whole ulps (every run, where
    None), where scripts/table5_sensitivity.py --figures measured them."""
    vals = [run[quantity]] + [
        r[quantity] for k, r in run.get("ulp_runs", {}).items()
        if quantity in r
        and (moves is None or int(k.split("_")[1][:-3]) <= moves)]
    return min(vals), max(vals)


def figure_bars(run, step, factor):
    """{quantity: (lo, hi)} that a Fig. 9, 10, 11 or 8 adaptive run's
    readings must lie in: the saturation in its band widened by one
    bisection `step` (`table5_bar`), the mean latency in its band widened
    by LATENCY_REL, the truncation gap in its band over the one-ulp moves
    widened by `factor` (the figures fixture's `truncation_factor`, the
    widest spread of a gap under a one-ulp move) each way."""
    bars = {"saturation": table5_bar(run, step, band(run, "saturation"))}
    if "latency_load" in run:
        lo, hi = band(run, "mean_latency")
        bars["mean_latency"] = (lo * (1 - LATENCY_REL),
                                hi * (1 + LATENCY_REL))
    if "truncation_error" in run:
        lo, hi = band(run, "truncation_error", moves=1)
        bars["truncation_error"] = (lo / factor, hi * factor)
    return bars


def phase_figures(torch, state):
    """The paper's remaining fluid figures on the card, every stage
    through the port and every solve on the card, held against
    tests/fixtures/torch_port_figures_reference.json (the JAX package's
    run), whose `config` gives the grid (module docstring, ``figures``).
    The path-cost count starts at 0 here and is read before the kernel is
    held and timed at fig9's and the non-quadric x4 graph's shapes."""
    import numpy as np

    from repro_torch.core import topologies
    from repro_torch.core.expansion import expand
    from repro_torch.core.layout import build_layout
    from repro_torch.core.metrics import diameter_and_aspl
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_blocked_routing, build_routing
    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import (latency_curve, make_pattern,
                                        truncation_error)

    with open(FIGURES_FIXTURE) as fh:
        fixture = json.load(fh)
    config = fixture["config"]
    factor = fixture["truncation_factor"]
    problems, out, timed_fp = [], {"truncation_factor": factor}, {}
    check = checker(problems)

    def inside(v, lo_hi):
        return bool(np.isfinite(v) and lo_hi[0] <= v <= lo_hi[1])

    def counted(fn):
        """(fn(), wall seconds, path-cost launches it made)."""
        before = ops.LAUNCHES
        res, wall = synced(torch, fn)
        return res, wall, ops.LAUNCHES - before

    ops.LAUNCHES = 0  # the figures path's count starts here
    # Fig. 9: PolarFly's adversarial permutations at PF(31)
    c, ref = config["fig9"], fixture["fig9"]
    step = bisection_step(c["tol"])
    t = time.perf_counter()
    pf = build_polarfly(c["q"])
    rt = build_routing(pf.graph, pf)
    setup_s = time.perf_counter() - t
    fig9 = {"routers": pf.n, "routing_s": setup_s, "runs": [],
            "routing_hashes_equal": check(
                routing_hashes(rt) == ref["routing_sha256"]
                and (pf.n, int(rt.diameter)) == (ref["routers"],
                                                 ref["diameter"]),
                "fig9 PF(31) routing tables")}
    runs = {(r["pattern"], r["mode"]): r for r in ref["runs"]}
    for pattern in c["patterns"]:
        pat, pattern_s = synced(torch, lambda: make_pattern(
            pattern, rt, p=c["p"], seed=c["seed"]))
        for mode in c["modes"]:
            want, it = runs[pattern, mode], c["iters"][mode]
            label = f"fig9 {pattern} {mode}"
            adaptive = mode in ("ugal", "ugal_pf")
            fp, row = held_paths(torch, check, rt, pat, mode, c, want,
                                 label)
            row = {"pattern": pattern, "mode": mode, "iters": it,
                   "pattern_s": pattern_s, **row}
            bars = figure_bars(want, step, factor) if adaptive else {}
            if want["saturation_source"] != "pf31":  # else main_path's
                row.update(held_saturation(torch, check, fp, c["tol"], it,
                                           c["engine"], want, label,
                                           bars.get("saturation")))
            else:
                row.update(loads_route(fp))
            res, wall, launches = counted(lambda: latency_curve(
                fp, [want["latency_load"]], iters=it, engine=c["engine"],
                device="cuda"))
            lat = res[0].mean_latency
            lo_hi = bars.get("mean_latency", (
                want["mean_latency"] * (1 - LATENCY_REL),
                want["mean_latency"] * (1 + LATENCY_REL)))
            # one path-cost call a Frank-Wolfe step and one for the
            # metrics; an oblivious split takes no step
            want_l = it + 1 if adaptive else 1
            row["latency"] = {
                "load": want["latency_load"], "mean_latency": lat,
                "reference": want["mean_latency"],
                "rel": abs(lat - want["mean_latency"])
                / want["mean_latency"], "bar": list(lo_hi),
                "wall_s": wall, "launches": launches,
                "ok": check(inside(lat, lo_hi) and launches == want_l,
                            f"{label} latency {lat} (reference "
                            f"{want['mean_latency']}, bar {lo_hi}), "
                            f"launches {launches} (want {want_l})")}
            if adaptive:
                gap, wall, launches = counted(lambda: truncation_error(
                    fp, want["saturation"], it, device="cuda"))
                lo_hi = bars["truncation_error"]
                row["truncation"] = {
                    "offered": want["saturation"], "gap": gap,
                    "reference": want["truncation_error"],
                    "bar": list(lo_hi), "wall_s": wall,
                    "launches": launches,
                    "ok": check(gap >= 0.0 and inside(gap, lo_hi)
                                and launches == it,
                                f"{label} truncation gap {gap} "
                                f"(reference {want['truncation_error']}, "
                                f"bar {lo_hi}), launches {launches}")}
            fig9["runs"].append(row)
            emit({"phase": "figures.fig9", **row})
            if (pattern, mode) == (c["patterns"][0], c["modes"][-1]):
                timed_fp[f"fig9 {pattern} {mode}"] = fp
    out["fig9"] = fig9

    # Fig. 11: quadric and non-quadric replication, routed without the
    # PolarFly structure (the base with it, as the benchmark)
    c, ref = config["fig11"], fixture["fig11"]
    step = bisection_step(c["tol"])
    lay, layout_s = synced(torch, lambda: build_layout(pf))
    out["fig11"] = {"layout_s": layout_s, "graphs": []}
    for name, method, steps in c["graphs"]:
        want, label = ref[name], f"fig11 {name}"
        g, graph_s = synced(torch, lambda: pf.graph if method is None
                            else expand(lay, steps, method).graph)
        rt, routing_s = synced(torch, lambda: build_routing(
            g, pf if method is None else None))
        deg = g.degrees
        row = {"graph": name, "routers": g.n, "links": g.num_edges,
               "diameter": int(rt.diameter), "degree_min": int(deg.min()),
               "degree_max": int(deg.max()), "graph_s": graph_s,
               "routing_s": routing_s}
        row["graph_equal"] = check(
            graph_hash(g) == want["graph_sha256"]
            and routing_hashes(rt) == want["routing_sha256"]
            and {k: row[k] for k in ("routers", "links", "diameter",
                                     "degree_min", "degree_max")}
            == {k: want[k] for k in ("routers", "links", "diameter",
                                     "degree_min", "degree_max")},
            f"{label} graph or routing tables")
        pat, row["pattern_s"] = synced(torch, lambda: make_pattern(
            "uniform", rt, p=c["p"], seed=c["seed"]))
        fp, prow = held_paths(torch, check, rt, pat, c["mode"], c, want,
                              label)
        row.update(prow)
        row.update(held_saturation(
            torch, check, fp, c["tol"], c["iters"], c["engine"], want, label,
            figure_bars(want, step, factor)["saturation"]))
        out["fig11"]["graphs"].append(row)
        emit({"phase": "figures.fig11", **row})
        if name == c["graphs"][-1][0]:
            timed_fp[f"fig11 {name}"] = fp
        else:
            del fp
    del lay, rt, pat

    # Fig. 14: diameter and ASPL under cumulative random link failures,
    # every BFS on the card
    c, ref = config["fig14"], fixture["fig14"]
    out["fig14"] = {}
    for name, (builder, args, fractions) in c["graphs"].items():
        want = ref["sweeps"][name]
        g, graph_s = synced(torch, lambda: figure_graph(
            builder, args, topologies, build_polarfly))
        row = {"routers": g.n, "links": g.num_edges, "graph_s": graph_s,
               "graph_equal": check(graph_hash(g) == want["graph_sha256"],
                                    f"fig14 {name} graph"), "points": []}
        for f, dg, pt in zip(fractions, damaged(g, fractions, c["seed"]),
                             want["points"]):
            (diam, aspl), wall = synced(torch, lambda: diameter_and_aspl(
                dg, engine="sparse", backend="sharded", device="cuda"))
            row["points"].append({
                "fraction": f, "diameter": diam, "aspl": aspl,
                "reference": [pt["diameter"], pt["aspl"]], "wall_s": wall,
                "ok": check((diam, aspl) == (pt["diameter"], pt["aspl"]),
                            f"fig14 {name} at {f}: ({diam}, {aspl})")})
        out["fig14"][name] = row
        emit({"phase": "figures.fig14", "graph": name, **row})

    # Fig. 14's throughput point: damaged PS(9, 61) through the blocked
    # stack, its BFS and column sweeps on the card
    c, want = c["point"], ref["point"]
    g, graph_s = synced(torch, lambda: figure_graph(
        *c["graph"], topologies, build_polarfly))
    edges = g.edge_list
    drop = edges[np.random.default_rng(c["drop_seed"]).choice(
        len(edges), int(c["drop"] * len(edges)), replace=False)]
    dg = g.subgraph_without_edges(drop)
    rt, routing_s = synced(torch, lambda: build_blocked_routing(
        dg, backend="sharded", device="cuda"))
    row = {"routers": dg.n, "links": dg.num_edges, "graph_s": graph_s,
           "routing_s": routing_s, "diameter": rt.diameter,
           "dest_block": rt.block,
           "graph_equal": check(
               graph_hash(dg) == want["graph_sha256"]
               and (rt.diameter, rt.block) == (want["diameter"],
                                               want["dest_block"]),
               "fig14 point graph, diameter or block")}
    pat, row["pattern_s"] = synced(torch, lambda: make_pattern(
        "uniform", rt, p=c["p"], seed=c["seed"],
        hosts=np.arange(c["hosts"], dtype=np.int32)))
    fp, prow = held_paths(torch, check, rt, pat, c["mode"], c, want,
                          "fig14 point")
    row.update(prow)
    row.update(held_saturation(torch, check, fp, c["tol"], c["iters"],
                               c["engine"], want, "fig14 point"))
    out["fig14_point"] = row
    emit({"phase": "figures.fig14_point", **row})
    del fp, rt, dg, g
    state["figures_launches"] = ops.LAUNCHES  # the figures path's

    # path_costs at fig9's and the non-quadric x4 graph's shapes (the
    # generic L = 6 kernel); launches here are not the path's
    def shape_launches(shape):
        """The launches the path made at `shape` ([F, K, L]), every run
        of that shape summed."""
        return sum(r.get("launches", 0)
                   + r.get("latency", {}).get("launches", 0)
                   + r.get("truncation", {}).get("launches", 0)
                   for r in fig9["runs"] + out["fig11"]["graphs"]
                   if [r["flows"], r["candidates"], r["path_len"]] == shape)

    shapes = [kernel_path_costs_at(torch, label, fp,
                                   shape_launches(list(fp.edges.shape)))
              for label, fp in timed_fp.items()]
    state["path_costs_figures_shapes"] = shapes
    out["path_costs"] = shapes
    out["path_costs_launches"] = state["figures_launches"]
    emit({"phase": "figures.path_costs", "shapes": shapes})
    if problems:
        raise AssertionError(f"figures failed their checks: {problems}")
    return out


# the Fig. 10 runs the `sizes` phase drives after Fig. 15 and Fig. 8's
# PF(79) point, each mode at every point in turn, within about 90 s on
# the card host; scripts/sizes_cards.py drives every run of the fixture
SIZES_PHASE_MODES = ("ugal_pf", "min")
SIZES_PHASE_POINTS = ("pf13", "pf19", "pf25", "pf31", "pf37", "pf43")


def sizes_graph(builder, args, topologies, build_polarfly):
    """(graph, its PolarFly or None) of a `[builder, arguments]` entry,
    built by the package whose `topologies` module and `build_polarfly`
    are passed."""
    if builder == "build_polarfly":
        pf = build_polarfly(*args)
        return pf.graph, pf
    return figure_graph(builder, args, topologies, build_polarfly), None


def sizes_routing(torch, builder, args, blocked):
    """(graph, routing, row) of a Fig. 10 / Fig. 8 graph: `build_routing(g,
    pf)`, or the blocked stack with every BFS sweep on the cards
    (`backend="sharded"`), as the scale phase routes PF(79)."""
    from repro_torch.core import topologies
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_blocked_routing, build_routing

    (g, pf), graph_s = synced(torch, lambda: sizes_graph(
        builder, args, topologies, build_polarfly))
    if blocked:
        rt, routing_s = synced(torch, lambda: build_blocked_routing(
            g, backend="sharded", devices=torch.cuda.device_count()))
    else:
        rt, routing_s = synced(torch, lambda: build_routing(g, pf))
    return g, rt, {"routers": g.n, "radix": g.params["radix"],
                   "links": g.num_edges, "diameter": int(rt.diameter),
                   "blocked": blocked, "graph_s": graph_s,
                   "routing_s": routing_s}


def held_graph(check, g, rt, top, want, label):
    """`top`'s sizes, the graph's hash and the routing's (its tables'
    hashes, or a blocked routing's destination block) against the fixture's
    `want`; sets `top["graph_equal"]`."""
    keys = [k for k in ("routers", "radix", "links", "hosts", "p",
                        "diameter") if k in want]
    ok = ({k: top[k] for k in keys} == {k: want[k] for k in keys}
          and graph_hash(g) == want["graph_sha256"])
    if "routing_sha256" in want:
        ok = ok and routing_hashes(rt) == want["routing_sha256"]
    else:
        top["dest_block"] = rt.block
        ok = ok and rt.block == want["dest_block"]
    top["graph_equal"] = check(ok, f"{label} graph, routing or sizes")


TIE_REL = 1e-6  # a link at capacity up to float32 summation: 8 ulps of 1


def tie_loads(want):
    """The loads of `want["max_util_at"]` (the reference's max link
    utilization at its saturation and one bisection step above,
    scripts/table5_sensitivity.py --sizes) where it is within TIE_REL of
    1: a link filled exactly to capacity that float32 sums in another
    order put on either side of it."""
    return [x for x, u in want.get("max_util_at", [])
            if abs(u - 1.0) <= TIE_REL]


def oblivious_bar(want, step):
    """(lo, hi) an oblivious saturation must lie in: the reference's, or
    the bisection step next to it where the reference decided that step
    by a tie (`tie_loads`)."""
    ref, ties = want["saturation"], tie_loads(want)
    up = min(ref + step, 1.0)
    return (ref - step if ref in ties else ref, up if up in ties else ref)


def held_sized_run(torch, check, rt, pat, mode, c, want, label, factor):
    """(FlowPaths, row) of one run of the sizes fixture on the card:
    `held_paths`, `held_saturation` (an adaptive one inside `figure_bars`'
    saturation bar, an oblivious one inside `oblivious_bar`, with the
    card's own max link utilization within TIE_REL of 1 at each load where
    that bar admits a tie), and where the reference measured it the
    truncation gap at the reference's saturation, inside its bar, with
    `iters` path-cost launches."""
    import numpy as np

    from repro_torch.kernels.minplus import ops
    from repro_torch.simulation import evaluate_load, truncation_error

    it = c["iters"][mode]
    fp, row = held_paths(torch, check, rt, pat, mode, c, want, label)
    step = bisection_step(c["tol"])
    bars = (figure_bars(want, step, factor) if mode in ("ugal", "ugal_pf")
            else {"saturation": oblivious_bar(want, step)})
    row = {"mode": mode, "iters": it, **row,
           **held_saturation(torch, check, fp, c["tol"], it, c["engine"],
                             want, label, bars.get("saturation"))}
    util = dict(want.get("max_util_at", []))
    row["ties"] = []
    for load in tie_loads(want):
        got = float(evaluate_load(fp, load, it, device="cuda").max_util)
        row["ties"].append({
            "load": load, "max_util": got, "reference": util[load],
            "ok": check(abs(got - 1.0) <= TIE_REL,
                        f"{label} max link utilization {got} at load "
                        f"{load}, not within {TIE_REL} of 1 (reference "
                        f"{util[load]})")})
    if "truncation_error" in want:
        before = ops.LAUNCHES
        gap, wall = synced(torch, lambda: truncation_error(
            fp, want["saturation"], it, device="cuda"))
        launches = ops.LAUNCHES - before
        lo, hi = bars["truncation_error"]
        row["truncation"] = {
            "offered": want["saturation"], "gap": gap,
            "reference": want["truncation_error"], "bar": [lo, hi],
            "wall_s": wall, "launches": launches,
            "ok": check(np.isfinite(gap) and gap >= 0.0 and lo <= gap <= hi
                        and launches == it,
                        f"{label} truncation gap {gap} (reference "
                        f"{want['truncation_error']}, bar {[lo, hi]}), "
                        f"launches {launches} (want {it})")}
    return fp, row


def fig15_ratio_bars(bars, ports, floor):
    """{traffic: {topology: (lo, hi)}}: the interval each Fig. 15 cost
    ratio may lie in when each saturation lies in its bar (`bars`,
    {(topology, traffic): (lo, hi)}); PolarFly's own ratio is 1."""
    out = {}
    for (name, key), (lo, hi) in bars.items():
        pf_lo, pf_hi = bars["PF", key]
        scale = ports[name] / ports["PF"]
        out.setdefault(key, {})[name] = (1.0, 1.0) if name == "PF" else (
            scale * max(pf_lo, floor) / max(hi, floor),
            scale * max(pf_hi, floor) / max(lo, floor))
    return out


def sizes_fig15(torch, check, fixture, factor):
    """Fig. 15 on the card: fig8's q = 13-class graphs under ugal_pf (ecmp
    on the fat tree) at uniform and random_perm, each held by
    `held_sized_run`, then the cost ratios, each inside the interval its
    saturations' bars allow.  Returns (record, {label: FlowPaths} of the adaptive
    runs)."""
    from repro_torch.core import topologies
    from repro_torch.core.polarfly import build_polarfly
    from repro_torch.core.routing import build_routing
    from repro_torch.simulation import make_pattern

    c, ref = fixture["config"]["fig15"], fixture["fig15"]
    out, sats, bars, fps = {"topologies": {}}, {}, {}, {}
    for name, (builder, args) in c["graphs"].items():
        want, mode = ref["topologies"][name], c["modes"][name]
        (g, pf), graph_s = synced(torch, lambda: sizes_graph(
            builder, args, topologies, build_polarfly))
        rt, routing_s = synced(torch, lambda: build_routing(g, pf))
        p, hosts = table5_traffic(g)
        top = {"routers": g.n, "radix": g.params["radix"], "p": p,
               "hosts": g.n if hosts is None else len(hosts),
               "diameter": int(rt.diameter), "graph_s": graph_s,
               "routing_s": routing_s, "runs": []}
        held_graph(check, g, rt, top, want, f"fig15 {name}")
        runs = {r["traffic"]: r for r in want["runs"]}
        for key, pattern in c["patterns"].items():
            label = f"fig15 {name} {key}"
            pat, pattern_s = synced(torch, lambda: make_pattern(
                pattern, rt, p=p, hosts=hosts, seed=c["seed"]))
            fp, row = held_sized_run(torch, check, rt, pat, mode, c,
                                     runs[key], label, factor)
            row = {"figure": "fig15", "topology": name, "traffic": key,
                   "pattern": pattern, "pattern_s": pattern_s, **row}
            sats[name, key], bars[name, key] = row["saturation"], row["bar"]
            top["runs"].append(row)
            emit({"phase": "sizes.run", **row})
            if mode in ("ugal", "ugal_pf"):
                fps[label] = fp
        out["topologies"][name] = top
    ratios = fig15_ratios(sats, c["ports"], c["sat_floor"])
    ratio_bars = fig15_ratio_bars(bars, c["ports"], c["sat_floor"])
    out["ratios"] = {key: {name: {
        "port": v, "reference": ref["ratios"][key][name],
        "bar": list(ratio_bars[key][name]),
        "ok": check(ratio_bars[key][name][0] <= v <= ratio_bars[key][name][1],
                    f"fig15 {name} {key} cost ratio {v} (bar "
                    f"{ratio_bars[key][name]})")}
        for name, v in row_.items()} for key, row_ in ratios.items()}
    out["paper_ft"] = c["paper_ft"]
    emit({"phase": "sizes.fig15_ratios", "ratios": out["ratios"],
          "paper_ft": c["paper_ft"]})
    return out, fps


def sizes_fig8_large(torch, check, fixture, factor, routed=None):
    """Fig. 8's PF(79) point on the card: the blocked routing (`routed`,
    (graph, routing, row), where the scale phase built it), p = 40,
    uniform and random_perm at 60,000 flows, min and ugal_pf, each held by
    `held_sized_run`.  Returns (record, {label: FlowPaths} of the adaptive
    runs)."""
    from repro_torch.simulation import make_pattern

    c, want = fixture["config"]["fig8_large"], fixture["fig8_large"]
    g, rt, top = routed or sizes_routing(torch, *c["graph"], True)
    top = {**top, "p": g.params.get("radix", 80) // 2, "runs": []}
    held_graph(check, g, rt, top, want, "fig8 PF(79)")
    runs = {(r["pattern"], r["mode"]): r for r in want["runs"]}
    fps = {}
    for pattern in c["patterns"]:
        pat, pattern_s = synced(torch, lambda: make_pattern(
            pattern, rt, p=top["p"], seed=c["seed"],
            max_flows=c["max_flows"]))
        for mode in c["modes"]:
            label = f"fig8 PF(79) {pattern} {mode}"
            fp, row = held_sized_run(torch, check, rt, pat, mode, c,
                                     runs[pattern, mode], label, factor)
            row = {"figure": "fig8_large", "pattern": pattern,
                   "pattern_s": pattern_s, **row}
            top["runs"].append(row)
            emit({"phase": "sizes.run", **row})
            if mode in ("ugal", "ugal_pf"):
                fps[label] = fp
    return top, fps


def sizes_fig10_point(torch, check, fixture, name, modes, factor,
                      routed=None):
    """Fig. 10's point `name` on the card under `modes`: routed as the
    benchmark routes it (`routed`, (graph, routing, row), where built
    already), uniform at `fig10_p` endpoints a router and
    `fig10_max_flows` flows, each run held by `held_sized_run`.  Returns
    (record, {label: FlowPaths} of the adaptive runs, (graph, routing,
    row))."""
    from repro_torch.simulation import make_pattern

    c, want = fixture["config"]["fig10"], fixture["fig10"][name]
    builder, args, blocked = c["points"][name]
    routed = routed or sizes_routing(torch, builder, args, blocked)
    g, rt, top = routed
    top = {**top, "p": fig10_p(builder, args, g, blocked), "runs": []}
    held_graph(check, g, rt, top, want, f"fig10 {name}")
    runs = {r["mode"]: r for r in want["runs"]}
    fps = {}
    for mode in modes:
        label = f"fig10 {name} {mode}"
        mf = fig10_max_flows(c, mode, g.n)
        pat, pattern_s = synced(torch, lambda: make_pattern(
            "uniform", rt, p=top["p"], seed=c["seed"], max_flows=mf))
        fp, row = held_sized_run(torch, check, rt, pat, mode, c, runs[mode],
                                 label, factor)
        row = {"figure": "fig10", "point": name, "max_flows": mf,
               "pattern_s": pattern_s, **row}
        top["runs"].append(row)
        emit({"phase": "sizes.run", **row})
        if mode in ("ugal", "ugal_pf"):
            fps[label] = fp
        del fp
    return top, fps, routed


def sizes_shape_launches(records, shape):
    """The path-cost launches the sizes runs in `records` made at `shape`
    ([F, K, L]): saturations and truncation gaps of that shape summed."""
    return sum(r.get("launches", 0) + r.get("truncation", {}).get(
        "launches", 0) for r in records
        if [r["flows"], r["candidates"], r["path_len"]] == shape)


def sizes_factor():
    """The truncation gap's widening: the figures fixture's
    `truncation_factor`, the widest spread of a Fig. 9 gap under a one-ulp
    move of the demand."""
    with open(FIGURES_FIXTURE) as fh:
        return json.load(fh)["truncation_factor"]


def phase_sizes(torch, state):
    """The paper's last device figures on the card, held against
    tests/fixtures/torch_port_sizes_reference.json (the JAX package's
    run), whose `config` gives the grid: Fig. 15 whole, Fig. 8's PF(79)
    point whole (on the scale phase's PF(79) routing when it ran), and
    Fig. 10's `SIZES_PHASE_MODES` at `SIZES_PHASE_POINTS`
    (scripts/sizes_cards.py runs every one).  The path-cost count starts at 0 here and is read before
    the kernel is held and timed at the largest PolarFly ugal_pf shape and
    the longest paths' shape the phase ran."""
    from repro_torch.kernels.minplus import ops

    with open(SIZES_FIXTURE) as fh:
        fixture = json.load(fh)
    factor = sizes_factor()
    problems, records, fps = [], [], {}
    check = checker(problems)
    out = {"truncation_factor": factor}

    ops.LAUNCHES = 0  # the sizes path's count starts here
    out["fig15"], got = sizes_fig15(torch, check, fixture, factor)
    fps.update(got)
    records += [r for t in out["fig15"]["topologies"].values()
                for r in t["runs"]]
    out["fig8_large"], got = sizes_fig8_large(
        torch, check, fixture, factor, state.pop("pf79_routed", None))
    fps.update(got)
    records += out["fig8_large"]["runs"]
    out["fig10"], routed = {}, {}
    for mode in SIZES_PHASE_MODES:
        for name in SIZES_PHASE_POINTS:
            top, got, routed[name] = sizes_fig10_point(
                torch, check, fixture, name, [mode], factor,
                routed.get(name))
            fps.update(got)
            records += top["runs"]
            out["fig10"][f"{name} {mode}"] = top
    del routed
    state["sizes_launches"] = ops.LAUNCHES  # the sizes path's, read here

    # path_costs at the largest PolarFly ugal_pf shape and at the longest
    # paths' (launches here are not the path's)
    pf = [k for k in fps if k.startswith(("fig10 pf", "fig8 PF"))]
    pick = {max(pf, key=lambda k: fps[k].edges.size),
            max(fps, key=lambda k: (fps[k].edges.shape[2],
                                    fps[k].edges.size))}
    shapes = [kernel_path_costs_at(torch, k, fps[k], sizes_shape_launches(
        records, list(fps[k].edges.shape))) for k in sorted(pick)]
    del fps
    state["path_costs_sizes_shapes"] = shapes
    out["path_costs"] = shapes
    out["path_costs_launches"] = state["sizes_launches"]
    emit({"phase": "sizes.path_costs", "shapes": shapes})
    if problems:
        raise AssertionError(f"sizes failed their checks: {problems}")
    return out

def scope_device_ms(events, scopes):
    """{name: device ms of the kernels and copies that ran inside the
    device-side ranges of the `named_scope`s called `name`}, for the names
    that start with one of `scopes`, read off the profiler's timeline
    (`events`: `prof.events()`).  The profiler's own `device_time_total` of
    a scope sums the kernels it links to the scope's CPU events; in a
    falcon-mamba prefill (45k kernels) that sum exceeded the whole device
    time, while at 2 layers it equals this one
    (scripts/profiler_scopes.py)."""
    import bisect

    from torch.autograd import DeviceType

    runs = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    starts = [r[0] for r in runs]
    out = {}
    for a in events:
        if a.device_type == DeviceType.CUDA and a.is_user_annotation \
                and a.name.startswith(scopes):
            lo, hi = a.time_range.start, a.time_range.end
            inside = runs[bisect.bisect_left(starts, lo):
                          bisect.bisect_right(starts, hi)]
            out[a.name] = out.get(a.name, 0.0) + sum(
                end - start for start, end in inside if end <= hi) / 1e3
    return out


def device_time_by_kernel(torch, fn, scopes=(), ops=()):
    """Run `fn` once under torch.profiler: {"wall_ms", "device_ms" (the sum
    of the device's kernel and copy times), "kernels" (their number),
    "flash_ms" (both flash-attention kernels), "top" (the largest by
    device time), "scopes" (the device ms of the kernels that ran inside
    each `named_scope` whose name starts with one of `scopes`, e.g.
    "moe.experts": `scope_device_ms`), "ops" (for each aten op named in
    `ops`, e.g. "aten::select_backward", its calls and the device ms of
    the kernels it launched)}.
    An error of `fn` (a kernel's launch or a CUDA fault) propagates; one of
    the profiler itself is reported in the result under "error", since the
    breakdown checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof, error = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]), None
    try:
        prof.start()
    except Exception:  # noqa: BLE001 -- the profiler's own failure
        error = traceback.format_exc(limit=2)
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if error is None:
        try:
            prof.stop()
            events = prof.key_averages()
            named = scope_device_ms(prof.events(), tuple(scopes))
        except Exception:  # noqa: BLE001 -- the profiler's own failure
            error = traceback.format_exc(limit=2)
    if error is not None:
        return {"wall_ms": wall * 1e3, "error": error}
    rows = [(evt.key, evt.self_device_time_total / 1e3, evt.count)
            for evt in events
            if evt.device_type == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    by_op = {name: {"calls": 0, "device_ms": 0.0} for name in ops}
    for evt in events:
        if evt.key in by_op and evt.device_type == DeviceType.CPU:
            by_op[evt.key]["calls"] += evt.count
            by_op[evt.key]["device_ms"] += evt.device_time_total / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": total, "scopes": named,
            "ops": by_op,
            "kernels": sum(r[2] for r in rows),
            "flash_ms": sum(r[1] for r in rows
                            if "flash_attention_kernel" in r[0]
                            or "flash_attention_sm90_kernel" in r[0]),
            "flash_bwd_ms": sum(r[1] for r in rows
                                if "bwd_dq_kernel" in r[0]
                                or "bwd_dkdv_kernel" in r[0]
                                or "bwd_sm90_" in r[0]),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:6]]}


def attention_layers(cfg):
    """Self-attention layers of `cfg`'s model (one flash launch each in a
    forward): every layer of a transformer (deepseek's layer0 included),
    one of each (rec, rec, attn) group of the Griffin hybrid, none of the
    SSM, the encoder's and the decoder's of the encoder-decoder."""
    if cfg.family == "hybrid":
        return cfg.num_layers // 3
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.encoder_layers + cfg.num_layers
    return cfg.num_layers


def frames_kw(torch, cfg, batch, dtype, gen):
    """{"frames": [batch, encoder_frames, d_model] * 0.1 in `dtype`} from
    `gen` for the encoder-decoder (the serve CLI's frames), {} for every
    other family."""
    if cfg.family != "encdec":
        return {}
    return {"frames": torch.randn((batch, cfg.encoder_frames, cfg.d_model),
                                  generator=gen, device="cuda",
                                  dtype=dtype) * 0.1}


def config_record(cfg):
    rec = {"arch": cfg.name, "family": cfg.family, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "window": cfg.local_window,
           "softcaps": [cfg.attn_softcap, cfg.final_softcap],
           "dtype": "bfloat16", "depth_cut": None}
    if cfg.family == "moe":
        rec.update(experts=[cfg.num_experts, cfg.experts_padded],
                   top_k=cfg.top_k, shared_d_ff=cfg.shared_d_ff,
                   first_dense_d_ff=cfg.first_dense_d_ff,
                   capacity_factor=cfg.moe_capacity_factor)
    if cfg.family == "hybrid":
        rec["lru_width"] = cfg.lru_width
    if cfg.family == "ssm":
        rec.update(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                   ssm_conv=cfg.ssm_conv, dt_rank=cfg.dt_rank,
                   scan_chunk=256, tie_embeddings=cfg.tie_embeddings,
                   unembed="embedding (the reference's, whatever the flag)")
    if cfg.family == "encdec":
        rec.update(encoder_layers=cfg.encoder_layers,
                   encoder_frames=cfg.encoder_frames, mlp=cfg.mlp,
                   text_context=WHISPER_TEXT_S,
                   frames_dtype="bfloat16 (the model's)")
    return rec


def breakdown(prof):
    """Prefill device ms by part from a `device_time_by_kernel` profile:
    attention (both flash kernels), the MoE router, dispatch + combine and
    expert GEMMs, the recurrence's scan (Griffin's RG-LRU or Mamba's
    selective scan), Whisper's cross-attention, and the rest; the parts
    add up to the device time.  Whisper's encoder ("whisper.encode", its
    attention included) is reported beside them, not among them."""
    if not prof.get("device_ms"):
        return {"error": "the profiler traced no device time"}
    sc = prof["scopes"]
    parts = {"attention": prof["flash_ms"],
             "moe_route": sc.get("moe.route", 0.0),
             "moe_dispatch_combine": sc.get("moe.dispatch", 0.0)
             + sc.get("moe.combine", 0.0),
             "moe_experts": sc.get("moe.experts", 0.0),
             "scan": sc.get("griffin.scan", 0.0) + sc.get("mamba.scan", 0.0),
             "cross_attention": sc.get("whisper.cross", 0.0)}
    parts["other"] = prof["device_ms"] - sum(parts.values())
    return {**parts, "share": {k: v / prof["device_ms"]
                               for k, v in parts.items()},
            "encoder_incl_attention": sc.get("whisper.encode", 0.0)}


def drive_lm(torch, arch, seq):
    """`_drive_lm` under ``torch.inference_mode()``: the models' ``forward``
    runs under the caller's grad mode, and serve runs without autograd."""
    with torch.inference_mode():
        return _drive_lm(torch, arch, seq)


def _drive_lm(torch, arch, seq):
    """`arch` at its published widths, bf16, random parameters from seed 0
    on the card: the prefill (`forward`, B = 1, S = `seq`, all layers, one
    sm90 flash-attention launch an attention layer and no CUDA-core one),
    then `launch.serve.generate` answering 4 requests, then float32
    consistency at full width and CONSISTENCY_LAYERS[arch] layers.  The
    encoder-decoder gets random frames (`frames_kw`) with every forward
    and every `init_cache`, which runs its encoder: `encoder_layers`
    launches an `init_cache`, none a decode step.
    Returns (record, sm90 launches of the prefill, CUDA-core launches of
    the float32 forward); raises if a check failed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.api import model_parts
    from repro_torch.models.common import tree_map

    out, problems = {}, []
    scopes = ("moe.", "griffin.", "mamba.", "whisper.")

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    t0 = time.perf_counter()
    cfg = get_config(arch)
    published = cfg.num_layers
    if arch in DEPTH_CUT:
        cfg = cfg.with_(num_layers=DEPTH_CUT[arch])
    n_attn = attention_layers(cfg)
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    out["config"] = {**config_record(cfg),
                     "depth_cut": (f"{cfg.num_layers} of {published} "
                                   f"layers" if arch in DEPTH_CUT else None),
                     "init_s": time.perf_counter() - t,
                     "param_bytes": sum(p.numel() * p.element_size()
                                        for p in model.parameters())}

    # prefill: one warm-up forward (cuBLAS set-up) outside the count
    gen = torch.Generator(device="cuda").manual_seed(0)
    fr1 = frames_kw(torch, cfg, 1, torch.bfloat16, gen)
    model.forward(torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                                device="cuda"), **fr1)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts(ops)  # the prefill path's counts start here
    t = time.perf_counter()
    logits = model.forward(tokens, **fr1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ops.LAUNCHES
    by_kernel = dict(ops.LAUNCHES_BY_KERNEL)
    sm90_launches = by_kernel["sm90"]
    finite = bool(torch.isfinite(logits).all())
    out["prefill"] = {
        "batch": 1, "seq": seq, "frames": cfg.encoder_frames if fr1 else 0,
        "wall_s": wall,
        "tokens_per_s": seq / wall, "flash_launches": launches,
        "flash_launches_by_kernel": by_kernel,
        "attention_layers": n_attn,
        "logits_shape": list(logits.shape),
        "logits_finite": check(finite, "prefill logits not finite"),
        "logits_abs_max": float(logits.abs().max()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_ok": check(by_kernel == {"sm90": n_attn, "simt": 0,
                                           "bwd": 0, "bwd_sm90": 0},
                             f"flash launches {by_kernel} for {n_attn} "
                             f"bf16 attention layers")}
    del logits
    prof = device_time_by_kernel(torch, lambda: model.forward(tokens, **fr1),
                                 scopes)
    out["prefill"]["profile"] = prof
    out["prefill"]["breakdown_ms"] = breakdown(prof)
    del tokens
    torch.cuda.empty_cache()

    # serve: 4 requests, greedy, through launch.serve.generate; one
    # warm-up run of the same shapes, then SERVE["runs"] timed ones
    b, plen, ntok = SERVE["batch"], SERVE["prompt"], SERVE["tokens"]
    prompt = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                           device="cuda")
    frs = frames_kw(torch, cfg, b, torch.bfloat16, gen)  # the 4 requests'
    generate(model, model.init_cache(b, plen + ntok, **frs), prompt, ntok)
    walls, answers, init_launches, serve_launches = [], [], [], 0
    for _ in range(SERVE["runs"]):
        before = ops.LAUNCHES
        cache = model.init_cache(b, plen + ntok, **frs)
        init_launches.append(ops.LAUNCHES - before)  # the encoder's
        torch.cuda.synchronize()
        before = ops.LAUNCHES
        t = time.perf_counter()
        answers.append(generate(model, cache, prompt, ntok))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        serve_launches += ops.LAUNCHES - before  # decode runs no kernel: 0
    answer, wall = answers[0], sorted(walls)[len(walls) // 2]
    # one more decode step, profiled (a breakdown only)
    step_profile = device_time_by_kernel(
        torch, lambda: model.decode_step(cache, answer[:, -1:],
                                         plen + ntok - 1), scopes)
    # greedy tokens against the argmax of one forward over prompt + answer
    # (an MoE forward routes with drops, its decode dropless)
    full = model.forward(torch.cat([prompt, answer], dim=1), **frs)
    agree = float((full[:, plen - 1:-1].argmax(-1) == answer).float().mean())
    out["serve"] = {
        "requests": b, "prompt": plen, "new_tokens": ntok,
        "reading": "smoke: one batch of 4 requests after one warm-up run, "
                   "not a serve rate",
        "wall_s": wall, "wall_s_runs": walls,
        "tokens_per_s": b * (plen + ntok) / wall,
        "new_tokens_per_s": b * ntok / wall,
        "ms_per_step": wall / (plen + ntok) * 1e3,
        "answers_equal_across_runs": all(bool((a == answer).all())
                                         for a in answers),
        "decode_steps": plen + ntok, "flash_launches": serve_launches,
        "init_cache_flash_launches": init_launches,
        "greedy_agreement_with_forward_argmax": agree,
        "answer_ok": check(answer.shape == (b, ntok) and bool(
            ((answer >= 0) & (answer < cfg.vocab_size)).all()),
            "serve answer shape or range"),
        "answers": answer.tolist(), "decode_step_profile": step_profile,
        "card": torch.cuda.get_device_name(0)}
    check(serve_launches == 0, f"decode launched {serve_launches} flash "
                               f"kernels")
    enc = cfg.encoder_layers if cfg.family == "encdec" else 0
    check(init_launches == [enc] * SERVE["runs"],
          f"init_cache launched {init_launches} flash kernels, not {enc} each")
    del model, cache, full, frs
    torch.cuda.empty_cache()

    # float32 consistency at full width and reduced depth
    c = CONSISTENCY
    over = {"num_layers": CONSISTENCY_LAYERS[arch], "dtype": "float32"}
    if cfg.family == "moe":
        # capacity = int(E * T * K / E) = T * K exactly: the forward drops
        # nothing, as the dropless decode; a factor of E / K can round one
        # below T * K and drop a slot
        over["moe_capacity_factor"] = float(cfg.experts_padded)
    cfg_c = cfg.with_(**over)
    model = build_model(cfg_c, device="cuda", seed=1)
    toks = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                         generator=gen, device="cuda")
    frc = frames_kw(torch, cfg, c["batch"], torch.float32, gen)
    reset_flash_counts(ops)  # the float32 path's counts start here
    full = model.forward(toks, **frc)
    fwd_launches = dict(ops.LAUNCHES_BY_KERNEL)
    cache = model.init_cache(c["batch"], c["seq"], **frc)
    steps = []
    for pos in range(c["seq"]):
        lg, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, dim=1)
    dec_err = float((dec - full).abs().max())
    dec_ok = bool(torch.allclose(dec, full, rtol=c["tol"], atol=c["tol"]))
    t = time.perf_counter()
    cpu = model_parts(cfg_c)[1](cfg_c, tree_map(lambda a: a.detach().cpu(),
                                                model.params.tree()))
    cpu_full = cpu.forward(toks.cpu(),
                           **{k: v.cpu() for k, v in frc.items()})
    cpu_s = time.perf_counter() - t
    full_cpu = full.cpu()
    cpu_err = float((full_cpu - cpu_full).abs().max())
    cpu_ok = bool(torch.allclose(full_cpu, cpu_full, rtol=c["tol"],
                                 atol=c["tol"]))
    out["consistency_fp32"] = {
        "layers": cfg_c.num_layers, "batch": c["batch"], "seq": c["seq"],
        "encoder_layers": cfg_c.encoder_layers,
        "frames": cfg.encoder_frames if frc else 0,
        "tol": c["tol"], "tf32": torch.backends.cuda.matmul.allow_tf32,
        "capacity_factor": cfg_c.moe_capacity_factor
        if cfg.family == "moe" else None,
        "forward_flash_launches": fwd_launches,
        "launches_ok": check(fwd_launches == {
            "sm90": 0, "simt": attention_layers(cfg_c), "bwd": 0,
            "bwd_sm90": 0},
            f"fp32 flash launches {fwd_launches}"),
        "decode_vs_forward_max_abs_err": dec_err,
        "decode_vs_forward_ok": check(dec_ok, "fp32 decode vs forward"),
        "card_vs_cpu_max_abs_err": cpu_err, "cpu_forward_s": cpu_s,
        "card_vs_cpu_ok": check(cpu_ok, "fp32 card forward vs CPU forward"),
        "logits_abs_max": float(full.abs().max())}
    del model, cpu, cache, full, frc
    torch.cuda.empty_cache()
    out["model_seconds"] = time.perf_counter() - t0
    if problems:
        raise AssertionError(f"{arch} failed its checks: {problems}")
    return out, sm90_launches, fwd_launches["simt"]


def phase_model(torch, state):
    """Gemma2-9B: the prefill at S = 8192 (all 42 layers), serve, float32
    consistency at 4 layers (`drive_lm`)."""
    out, sm90, simt = drive_lm(torch, GEMMA, PREFILL_S)
    state["flash_sm90_launches"] = sm90
    state["flash_simt_launches"] = simt
    return out


def phase_moe(torch, state):
    """deepseek-moe-16b, then qwen2-moe-a2.7b (`drive_lm`, S = 4096, at
    `DEPTH_CUT`'s depths): one sm90 launch a layer of a prefill."""
    out = {}
    for arch in MOE:
        out[arch], sm90, _ = drive_lm(torch, arch, NEW_PREFILL_S)
        state.setdefault("flash_sm90_launches_by_path", {})[arch] = sm90
    return out


def phase_hybrid(torch, state):
    """recurrentgemma-9b (`drive_lm`, S = 4096, at `DEPTH_CUT`'s depth):
    6 sm90 launches a prefill, the RG-LRU scan on the other 13 layers."""
    out, sm90, _ = drive_lm(torch, HYBRID, NEW_PREFILL_S)
    state.setdefault("flash_sm90_launches_by_path", {})[HYBRID] = sm90
    return {HYBRID: out}


def phase_ssm(torch, state):
    """falcon-mamba-7b (`drive_lm`, S = 4096: 16 scan chunks of 256): no
    attention, so no flash launch; the selective scan's share of the
    prefill's device time in the breakdown."""
    out, sm90, _ = drive_lm(torch, SSM, NEW_PREFILL_S)
    state.setdefault("flash_sm90_launches_by_path", {})[SSM] = sm90
    return {SSM: out}


def phase_encdec(torch, state):
    """whisper-base (`drive_lm`, 1500 frames and 448 tokens): 12 sm90
    launches a prefill (6 non-causal at S = 1500, 6 causal at S = 448), 6
    an `init_cache`, 12 CUDA-core launches in the float32 run."""
    out, sm90, simt = drive_lm(torch, ENCDEC, WHISPER_TEXT_S)
    state.setdefault("flash_sm90_launches_by_path", {})[ENCDEC] = sm90
    state.setdefault("flash_simt_launches_by_path", {})[ENCDEC] = simt
    return {ENCDEC: out}


# -- the training path -----------------------------------------------------

def flash_bwd_bound_ms(b, hq, hkv, s, d, causal, window, itemsize):
    """(bound ms, flop-bound ms, byte-bound ms) of one attention backward:
    10 D flops per unmasked pair and head (FlashAttention-2's count: five
    products of 2 D) at the dense bf16 tensor-core rate; q, o, do, dq
    ([B, Hq, S, D]) and k, v, dk, dv ([B, Hkv, S, D]) read or written once
    at HBM rate."""
    flops = 10 * d * attention_pairs(s, causal, window) * hq * b
    nbytes = 4 * (hq + hkv) * b * s * d * itemsize
    by_ops = flops / BF16_TC_FLOPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), by_ops, by_bytes


def train_attention_shapes():
    """[(label, (B, Hq, Hkv, S, D, causal, softcap, window), dtypes)] where
    the backward kernels are held and timed: one qwen2-0.5b train layer (B
    = 4, S = 2048), Gemma2-9B's local layer at S = 4096 (softcap, window,
    D = 256) and whisper-base's encoder (non-causal, the ragged S = 1500)."""
    from repro_torch.configs import get_config

    q, g, w = (get_config(a) for a in (TRAIN["arch"], GEMMA, ENCDEC))
    return [("qwen2_train", (TRAIN["batch"], q.num_heads, q.num_kv_heads,
                             TRAIN["seq"], q.head_dim, True, None, None),
             ("bfloat16", "float32")),
            ("gemma2_local", (1, g.num_heads, g.num_kv_heads, NEW_PREFILL_S,
                              g.head_dim, True, g.attn_softcap,
                              g.local_window), ("float32",)),
            ("whisper_encoder", (1, w.num_heads, w.num_kv_heads,
                                 w.encoder_frames, w.head_dim, False, None,
                                 None), ("bfloat16", "float32"))]


def kernel_flash_bwd(torch, state):
    """Both backward kernels through autograd (`ops.attention` on leaves
    that require grad: csrc/flash_attention_bwd_sm90.cu for bf16 at D = 64
    and 128, csrc/flash_attention_bwd.cu for the rest) against their plain
    version (`attention_backward_ref`: autograd through `attention_ref`) on
    the card, each gradient within FLASH_BWD_TOL of its largest magnitude:
    at FLASH_CASES in both dtypes and at `train_attention_shapes`; then,
    at those shapes, the routed kernel's time (in bf16 at D = 64 and 128
    the tensor-core one, fed the forward's lse) beside the CUDA-core
    kernel's on the same bf16 inputs, the plain version's and (where it
    computes the same function) SDPA's backward, and the bound."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_backward_ref

    rows, times = [], {}
    worst = {"bwd": {"float32": 0.0, "bfloat16": 0.0}, "bwd_sm90": 0.0}

    def inputs(shape, dtype, seed):
        b, hq, hkv, s, d = shape[:5]
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(sh) * sc).to(
            "cuda", dtype) for sh, sc in (((b, hq, s, d), 0.5),
                                          ((b, hkv, s, d), 0.5),
                                          ((b, hkv, s, d), 0.5),
                                          ((b, hq, s, d), 1.0))]

    def hold(label, x, causal, cap, win):
        """Gradients through the autograd Function against the plain
        backward."""
        q, k, v, do = x
        route = ops._bwd_route(q.dtype, q.shape[3])
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        before = ops.LAUNCHES_BY_KERNEL[route]
        out = ops.attention(*leaves, causal=causal, softcap=cap, window=win)
        got = torch.autograd.grad(out, leaves, do)
        want = attention_backward_ref(q, k, v, do, causal=causal,
                                      softcap=cap, window=win)
        torch.cuda.synchronize()
        name = str(q.dtype).split(".")[-1]
        row = {"case": label, "dtype": name, "route": route}
        ok = ops.LAUNCHES_BY_KERNEL[route] == before + 1
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            err, top = float((g - w).abs().max()), float(w.abs().max())
            bar = FLASH_BWD_TOL[name] * top + FLASH_BWD_ATOL[name]
            row[grad] = {"max_abs_err": err, "max_abs_ref": top,
                         "share_of_bar": err / bar}
            ok = ok and bool(torch.isfinite(g).all()) and err <= bar
            if route == "bwd":
                worst[route][name] = max(worst[route][name], err)
            else:
                worst[route] = max(worst[route], err)
        row["ok"] = ok
        rows.append(row)
        if not ok:
            raise AssertionError(f"flash_attention backward differs from "
                                 f"its plain version: {row}")

    def timed(x, causal, cap, win):
        """Times at one shape: the routed backward (the tensor-core one fed
        the forward's lse where it takes the shape), the CUDA-core one on
        the same bf16 inputs beside it, the plain version and SDPA."""
        q, k, v, do = x
        b, hq, s, d = q.shape
        hkv = k.shape[1]
        route = ops._bwd_route(q.dtype, d)
        if route == "bwd_sm90":
            o, lse = ops._launch(q, k, v, causal, cap, win, None, "sm90",
                                 with_lse=True)
        else:
            o, lse = ops._launch(q, k, v, causal, cap, win, None,
                                 ops._route(q.dtype, d)), None
        bound, by_ops, by_bytes = flash_bwd_bound_ms(
            b, hq, hkv, s, d, causal, win, q.element_size())
        kernel = lambda r, l: (lambda: ops._launch_bwd(  # noqa: E731
            q, k, v, o, do, causal, cap, win, None, lse=l, route=r))
        ms = gpu_ms(torch, kernel(route, lse), samples=10)
        row = {"shape": [b, hq, hkv, s, d], "causal": causal,
               "softcap": cap, "window": win, "route": route, "ms": ms,
               "plain_ms": gpu_ms(torch, lambda: attention_backward_ref(
                   q, k, v, do, causal=causal, softcap=cap, window=win),
                   samples=3, warmup=1),
               "plain_includes": "its forward (autograd through "
                                 "attention_ref)",
               "bound_ms": bound, "flops_ms": by_ops, "bytes_ms": by_bytes,
               "bound_by": "operations" if by_ops >= by_bytes else "bytes",
               "bound_share": bound / ms, "library_ms": None,
               "library_reason": "scaled_dot_product_attention has no "
                                 "softcap and takes a window only as a mask"}
        if route == "bwd_sm90":
            row["bwd_ms"] = gpu_ms(torch, kernel("bwd", None), samples=10)
            row["speedup_over_bwd"] = row["bwd_ms"] / ms
        if cap is None and win is None:
            row["library_reason"] = (
                f"the same function: the backward of scaled_dot_product_"
                f"attention(is_causal={causal}, enable_gqa={hq != hkv})")
            try:  # the yardstick only: the port never calls it
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                sdpa = F.scaled_dot_product_attention(
                    *leaves, is_causal=causal, enable_gqa=hq != hkv)
                lib = lambda: torch.autograd.grad(  # noqa: E731
                    sdpa, leaves, do, retain_graph=True)
                row["library_ms"] = gpu_ms(torch, lib, samples=10)
                row["library_dq_max_abs_err"] = float(
                    (lib()[0].float() - kernel(route, lse)()[0].float()
                     ).abs().max())
            except RuntimeError:  # noqa: BLE001 -- SDPA's own refusal
                row["library_error"] = traceback.format_exc(limit=1)
        return row

    for case in FLASH_CASES:
        b, hq, hkv, s, d, causal, cap, win = case
        for dtype in (torch.float32, torch.bfloat16):
            hold(str(case), inputs(case, dtype, 0), causal, cap, win)
    for label, shape, dtypes in train_attention_shapes():
        b, hq, hkv, s, d, causal, cap, win = shape
        for dname in dtypes:
            x = inputs(shape, getattr(torch, dname), 5)
            full = f"{label} {(b, hq, hkv, s, d)} causal {causal} " \
                   f"softcap {cap} window {win}"
            hold(full, x, causal, cap, win)
            times[f"{label}_{dname}"] = {"dtype": dname,
                                         **timed(x, causal, cap, win)}
            del x
            torch.cuda.empty_cache()
    main = times["qwen2_train_bfloat16"]
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    replaces = ("src/repro/kernels/flash_attention/ref.py:13 (no Pallas "
                "counterpart: the reference differentiates attention_ref by "
                "XLA autodiff)")
    at = "one qwen2-0.5b train layer (B 4, 14/2 heads, S 2048, D 64, " \
         "causal), bf16"
    def shapes(route):
        """The kernel of `route`'s time at the other shapes: where it is
        the routed kernel, and (CUDA-core) beside the tensor-core one."""
        key = {"bwd_sm90": "ms", "bwd": "bwd_ms"}[route]
        return {k: {"shape": v["shape"], "dtype": v["dtype"],
                    "ms": v[key] if key in v else v["ms"],
                    **{f: v[f] for f in ("plain_ms", "bound_ms",
                                         "library_ms")}}
                for k, v in times.items() if k != "qwen2_train_bfloat16"
                and (v["route"] == route or key in v)}

    state["flash_attention_bwd_sm90"] = {
        "name": "flash_attention_bwd_sm90", "route": "cuda",
        "source": src + "flash_attention_bwd_sm90.cu", "replaces": replaces,
        "max_abs_err": worst["bwd_sm90"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_computes": main["library_reason"],
        "timed_at": at, "speedup_over_bwd": main["speedup_over_bwd"],
        "other_shapes": shapes("bwd_sm90")}
    state["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": src + "flash_attention_bwd.cu", "replaces": replaces,
        "max_abs_err": max(worst["bwd"].values()),
        "max_abs_err_by_dtype": worst["bwd"],
        "ms": main["bwd_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_computes": main["library_reason"],
        "timed_at": at + " (the inputs the tensor-core kernel is timed on; "
                         "the train path sends it float32)",
        "other_shapes": shapes("bwd")}
    return {"checks": rows, "max_abs_err": worst, "times": times,
            "tol_of_max": FLASH_BWD_TOL, "atol": FLASH_BWD_ATOL}


def reset_flash_counts(ops):
    ops.LAUNCHES = 0
    ops.LAUNCHES_BY_KERNEL.update(sm90=0, simt=0, bwd=0, bwd_sm90=0)


def run_steps(torch, step_fn, st, pipe, steps, label, ops):
    """`steps` train steps from `st` on `pipe`'s batches 0, 1, ...: per
    step the loss, grad norm, lr, wall ms (ending in a device sync) and
    flash launches by kernel, one JSON line each.  Returns (state, rows)."""
    rows = []
    for i in range(steps):
        before = dict(ops.LAUNCHES_BY_KERNEL)
        t = time.perf_counter()
        st, m = step_fn(st, pipe.batch_at(i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rows.append({"run": label, "step": i, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "wall_ms": wall * 1e3,
                     "flash_launches": {k: ops.LAUNCHES_BY_KERNEL[k] - n
                                        for k, n in before.items()}})
        emit({"phase": "train.step", **rows[-1]})
    return st, rows


def step_split_ms(torch, model, opt, st, batch):
    """Device ms of one train step's forward, backward (the remat recompute
    included) and optimizer update: CUDA events between the pieces that
    `train_step.value_and_grad` and `make_train_step` run."""
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.train.losses import model_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    items = tree_items(st["params"])
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
    tree = tree_from_items((p, leaf) for (p, _), leaf in zip(items, leaves))
    ev[0].record()
    with torch.enable_grad():
        loss = model_loss(model, tree, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    opt.update(tree_from_items((p, g) for (p, _), g in zip(items, grads)),
               st["opt"], st["params"])
    ev[3].record()
    torch.cuda.synchronize()
    return {"forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "optimizer_ms": ev[2].elapsed_time(ev[3])}


def stacked_writes(torch, model, params, batch):
    """{"select_backward": n, "stack": m}: the ops of one `value_and_grad`
    of `model` at `params` on `batch` whose output is a whole layer stack
    (leading dim the stacked layers'), counted by a dispatch mode (which
    autograd's thread inherits).  Per-layer t[i] views write a zero-filled
    stack a layer and leaf (select_backward); one unbind a leaf writes one
    stack."""
    from repro_torch.parallel.compat import TorchDispatchMode
    from repro_torch.train.train_step import value_and_grad

    n = model.cfg.num_layers
    counts = {"select_backward": 0, "stack": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in counts and isinstance(out, torch.Tensor) \
                    and out.dim() > 1 and out.shape[0] == n:
                counts[name] += 1
            return out

    with Count():
        value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    return counts


def train_two_level(torch, model, opt, pipe, ops, check):
    """remat "2level" on `model`'s parameters (shared, not copied) beside
    `model` ("full"): TRAIN_2LEVEL["steps"] steps of each from the initial
    state on `pipe`'s fixed batch -- the losses and the first step's
    gradients bit for bit, the flash launches a step against what the
    path implies, wall ms, the device ms of one profiled step and
    ``max_memory_allocated`` of each."""
    from repro_torch.models.api import model_parts
    from repro_torch.models.common import tree_items, two_level_split
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.train_step import value_and_grad

    cfg = model.cfg
    n, g = cfg.num_layers, len(cfg.layer_pattern)
    outer, inner = two_level_split(n // g)
    two = model_parts(cfg)[1](cfg, model.params.tree(), remat="2level")
    # each layer's forward runs once, again in its outer group's recompute
    # (non-reentrant checkpoint stops that recompute once it holds what
    # the outer group saved: inner - 1 of its groups run, the last
    # group's input is the last saved tensor) and again in its own
    want = {"full": {"sm90": 2 * n, "simt": 0, "bwd": 0, "bwd_sm90": n},
            "2level": {"sm90": 2 * n + outer * (inner - 1) * g, "simt": 0,
                       "bwd": 0, "bwd_sm90": n}}
    batch = pipe.batch_at(0)
    out, grads, losses = {"outer": outer, "inner": inner,
                          "launches_expected": want}, {}, {}
    for name, m in (("full", model), ("2level", two)):
        st = init_state(m, opt)
        loss, gr = value_and_grad(m, st["params"], batch)
        if name == "full":
            grads["full"] = gr
        else:
            same = [torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8))
                    for (_, a), (_, b) in zip(tree_items(grads["full"]),
                                              tree_items(gr))]
            out["grads_bit_identical"] = check(
                all(same), f"2level gradients differ from full's in "
                f"{same.count(False)} of {len(same)} leaves")
            out["grad_leaves"] = len(same)
        del gr
        step_fn = make_train_step(m, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts(ops)
        st, rows = run_steps(torch, step_fn, st, pipe,
                             TRAIN_2LEVEL["steps"], f"bf16 {name}", ops)
        peak = torch.cuda.max_memory_allocated()
        losses[name] = [r["loss"] for r in rows]
        launches = dict(ops.LAUNCHES_BY_KERNEL)
        prof = device_time_by_kernel(torch, lambda: step_fn(st, batch))
        out[name] = {
            "steps": rows, "wall_ms": [r["wall_ms"] for r in rows],
            "device_ms": prof.get("device_ms"), "profile": prof,
            "max_memory_allocated": peak,
            "launches_ok": check(all(r["flash_launches"] == want[name]
                                     for r in rows),
                                 f"{name} flash launches a step "
                                 f"{[r['flash_launches'] for r in rows]}, "
                                 f"not {want[name]}")}
        if name == "2level":
            out["launches_2level"] = launches
        del st, step_fn
        torch.cuda.empty_cache()
    out["losses"] = losses
    out["losses_bit_identical"] = check(
        losses["2level"] == losses["full"],
        f"2level losses {losses['2level']} differ from full's "
        f"{losses['full']}")
    return out


def phase_train(torch, state):
    """The training path (`train.make_train_step` as `launch.train` builds
    it): the backward kernels' holds and times (`kernel_flash_bwd`);
    qwen2-0.5b at its published widths in bf16 with remat, TRAIN["steps"]
    steps on one fixed batch (`--data fixed`: the markov generator's V x V
    matrix would take 185 GB at this vocabulary) -- the loss finite and
    falling by at least 0.5, 2 sm90 launches and 1 tensor-core backward
    launch a layer and step, tokens/s, peak memory, a profile and a split
    of one more step; the same model in float32 without remat (the
    CUDA-core forward and backward); one float32 step at full width
    and 2 layers on the card against the same on the CPU; and a restart
    from a checkpoint, bit for bit."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model
    from repro_torch.models.api import model_parts
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.train import (AdamW, DataConfig, SyntheticPipeline,
                                   cosine_schedule, init_state,
                                   make_train_step)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import value_and_grad

    out, problems = {}, []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    out["kernel"] = kernel_flash_bwd(torch, state)
    torch.cuda.empty_cache()

    # qwen2-0.5b, bf16, remat "full", as `launch.train --preset full
    # --data fixed` builds it
    cfg = get_config(TRAIN["arch"])
    n = cfg.num_layers
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0, remat="full")
    opt = AdamW(learning_rate=cosine_schedule(TRAIN["lr"], TRAIN["warmup"],
                                              TRAIN["steps"]),
                weight_decay=0.0)
    step_fn = make_train_step(model, opt)
    pipe = SyntheticPipeline(DataConfig(TRAIN["batch"], TRAIN["seq"],
                                        cfg.vocab_size, "fixed", seed=0),
                             device="cuda")
    st = init_state(model, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts(ops)  # the train path's counts start here
    st, rows = run_steps(torch, step_fn, st, pipe, TRAIN["steps"], "bf16",
                         ops)
    launches = dict(ops.LAUNCHES_BY_KERNEL)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in rows]
    walls = sorted(r["wall_ms"] for r in rows[1:])  # step 0 warms up
    step_ms = walls[len(walls) // 2]
    per_step = {"sm90": 2 * n, "simt": 0, "bwd": 0, "bwd_sm90": n}
    batch = pipe.batch_at(0)
    prof = device_time_by_kernel(torch, lambda: step_fn(st, batch),
                                 ("train.",), ("aten::select_backward",
                                               "aten::stack"))
    split = step_split_ms(torch, model, opt, st, batch)
    stacked = stacked_writes(torch, model, st["params"], batch)
    stacked_leaves = sum(1 for _, t in tree_items(st["params"]["layers"]))
    out["bf16"] = {
        "config": {**config_record(cfg), "remat": "full", "optimizer":
                   "AdamW(cosine_schedule(1e-3, 10, steps), weight_decay=0)",
                   "data": "fixed (one memorizable batch)",
                   "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                   "init_s": init_s},
        "steps": rows, "loss_first": losses[0], "loss_last": losses[-1],
        "loss_ok": check(all(np.isfinite(losses))
                         and losses[-1] <= losses[0] - 0.5,
                         f"bf16 losses {losses}"),
        "step_ms_median": step_ms, "step_ms_runs": walls,
        "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / step_ms * 1e3,
        "peak_mem_gb": peak, "flash_launches": launches,
        "flash_launches_per_step": rows[-1]["flash_launches"],
        "launches_ok": check(all(r["flash_launches"] == per_step
                                 for r in rows),
                             f"flash launches a step "
                             f"{[r['flash_launches'] for r in rows]}, "
                             f"not {per_step}"),
        "loss_first_before_unbind": TRAIN_BEFORE_UNBIND["loss_first"],
        "loss_first_ok": check(
            losses[0] == TRAIN_BEFORE_UNBIND["loss_first"],
            f"bf16 first loss {losses[0]!r}, not "
            f"{TRAIN_BEFORE_UNBIND['loss_first']!r}"),
        "stacked_writes": stacked, "stacked_leaves": stacked_leaves,
        "stacked_writes_ok": check(
            stacked == {"select_backward": 0, "stack": stacked_leaves},
            f"whole-stack writes in a step's backward {stacked}, not one "
            f"stack for each of {stacked_leaves} stacked leaves"),
        "profile": prof, "split_ms": split,
        "split_ms_before_unbind": TRAIN_BEFORE_UNBIND["split_ms"],
        "backward_kernel_share": prof.get("flash_bwd_ms", 0.0)
        / prof["device_ms"] if prof.get("device_ms") else None,
        "card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()}
    state["flash_bwd_sm90_launches"] = launches["bwd_sm90"]
    state.setdefault("flash_bwd_sm90_launches_by_path", {})[
        "qwen2-0.5b train bf16"] = launches["bwd_sm90"]
    state.setdefault("flash_sm90_launches_by_path", {})[
        "qwen2-0.5b train bf16"] = launches["sm90"]
    del st, step_fn
    torch.cuda.empty_cache()

    # remat "2level" beside "full" on the same model, state and batch
    two = train_two_level(torch, model, opt, pipe, ops, check)
    out["remat_2level"] = two
    path = f"qwen2-0.5b train bf16 2level ({TRAIN_2LEVEL['steps']} steps)"
    state["flash_sm90_launches_by_path"][path] = two["launches_2level"][
        "sm90"]
    state["flash_bwd_sm90_launches_by_path"][path] = two["launches_2level"][
        "bwd_sm90"]
    del model, pipe, batch
    torch.cuda.empty_cache()

    # the same model in float32 without remat
    f = TRAIN_FP32
    cfg32 = cfg.with_(dtype="float32")
    model = build_model(cfg32, device="cuda", seed=0, remat="none")
    opt32 = AdamW(learning_rate=cosine_schedule(TRAIN["lr"], TRAIN["warmup"],
                                                f["steps"]), weight_decay=0.0)
    pipe = SyntheticPipeline(DataConfig(f["batch"], f["seq"], cfg.vocab_size,
                                        "fixed", seed=0), device="cuda")
    reset_flash_counts(ops)
    st, rows = run_steps(torch, make_train_step(model, opt32),
                         init_state(model, opt32), pipe, f["steps"], "fp32",
                         ops)
    launches32 = dict(ops.LAUNCHES_BY_KERNEL)
    losses = [r["loss"] for r in rows]
    out["fp32"] = {
        "layers": n, "batch": f["batch"], "seq": f["seq"], "remat": "none",
        "steps": rows, "flash_launches": launches32,
        "loss_ok": check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                         f"fp32 losses {losses}"),
        "launches_ok": check(launches32 == {"sm90": 0, "simt": n * f["steps"],
                                            "bwd": n * f["steps"],
                                            "bwd_sm90": 0},
                             f"fp32 flash launches {launches32}")}
    state["flash_bwd_launches"] = launches32["bwd"]
    state.setdefault("flash_bwd_launches_by_path", {})[
        "qwen2-0.5b train fp32"] = launches32["bwd"]
    state.setdefault("flash_simt_launches_by_path", {})[
        "qwen2-0.5b train fp32"] = launches32["simt"]
    del model, st, pipe
    torch.cuda.empty_cache()

    # card against CPU: float32, full width, 2 layers, TF32 off
    c = TRAIN_CHECK
    cfg_c = cfg.with_(num_layers=c["layers"], dtype="float32")
    cls = model_parts(cfg_c)[1]
    cpu = build_model(cfg_c, device="cpu", seed=1, remat="full")
    card = cls(cfg_c, tree_map(lambda a: a.detach().cuda(),
                               cpu.params.tree()), remat="full")
    pipe = SyntheticPipeline(DataConfig(c["batch"], c["seq"], cfg.vocab_size,
                                        "random", seed=1), device="cpu")
    batch = pipe.batch_at(0)
    reset_flash_counts(ops)
    loss_g, grads_g = value_and_grad(card, card.params.tree(),
                                     {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    check_launches = dict(ops.LAUNCHES_BY_KERNEL)
    t = time.perf_counter()
    loss_c, grads_c = value_and_grad(cpu, cpu.params.tree(), batch)
    cpu_s = time.perf_counter() - t
    leaves, zero_attn = {}, []
    for (path, g), (_, w) in zip(tree_items(grads_g), tree_items(grads_c)):
        g = g.cpu()
        err, top = float((g - w).abs().max()), float(w.abs().max())
        leaves["/".join(path)] = err / top if top else err
        if path[-2:-1] == ("attn",) and not float(g.abs().max()) > 0:
            zero_attn.append("/".join(path))
    norm_g, norm_c = float(global_norm(grads_g)), float(global_norm(grads_c))
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    norm_rel = abs(norm_g - norm_c) / norm_c
    out["card_vs_cpu"] = {
        "layers": c["layers"], "batch": c["batch"], "seq": c["seq"],
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss_card": float(loss_g), "loss_cpu": float(loss_c),
        "loss_rel": loss_rel, "grad_norm_card": norm_g,
        "grad_norm_cpu": norm_c, "grad_norm_rel": norm_rel,
        "worst_leaf": max(leaves, key=leaves.get),
        "worst_leaf_err_of_max": max(leaves.values()),
        "leaf_err_of_max": leaves, "cpu_s": cpu_s,
        "flash_launches": check_launches,
        "ok": check(loss_rel <= c["loss_rel"] and norm_rel <= c["norm_rel"]
                    and max(leaves.values()) <= c["leaf_of_max"],
                    "card and CPU train steps disagree"),
        "attention_grads_nonzero": check(not zero_attn,
                                         f"zero attention grads {zero_attn}"),
        "launches_ok": check(check_launches == {
            "sm90": 0, "simt": 2 * c["layers"], "bwd": c["layers"],
            "bwd_sm90": 0},
            f"card-vs-CPU flash launches {check_launches}")}
    del cpu, grads_c, grads_g

    # restart: save after step 1, restore, step 2 from both: bit for bit
    opt_r = AdamW(learning_rate=cosine_schedule(TRAIN["lr"], TRAIN["warmup"],
                                                3), weight_decay=0.0)
    step_r = make_train_step(card, opt_r)
    batches = [{k: v.cuda() for k, v in pipe.batch_at(i).items()}
               for i in (1, 2)]
    s1, _ = step_r(init_state(card, opt_r), batches[0])
    d = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    t = time.perf_counter()
    ckpt.save(s1, d, 1)
    back = ckpt.restore(s1, d, 1)
    io_s = time.perf_counter() - t
    nbytes = sum(os.path.getsize(os.path.join(d, "step_1", x))
                 for x in os.listdir(os.path.join(d, "step_1")))
    shutil.rmtree(d, ignore_errors=True)
    same = all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(s1), tree_items(back)))
    r1, m1 = step_r(s1, batches[1])
    r2, m2 = step_r(back, batches[1])
    bits = float(m1["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for (_, a), (_, b)
        in zip(tree_items(r1), tree_items(r2)))
    out["restart"] = {
        "model": f"{cfg.name} float32, {c['layers']} layers, full width",
        "checkpoint_bytes": nbytes, "save_restore_s": io_s,
        "restored_bit_identical": check(same, "restored state differs"),
        "step2_bit_identical": check(bits, "step 2 after a restart differs"),
        "loss_step2": float(m1["loss"])}
    del card, s1, back, r1, r2
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"train path failed its checks: {problems}")
    return out


def world_of_one(torch):
    """A process group of one rank on this card (NCCL), rendezvous through
    a FileStore in a fresh temp dir (no MASTER_ADDR, no port).  Returns the
    temp dir, which `end_world` removes."""
    import tempfile

    import torch.distributed as dist

    d = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(d, "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    return d


def end_world(d):
    import shutil

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(d, ignore_errors=True)


def sharded_attention_check(torch, mesh):
    """`models.attention`'s `local_map` call against `ops.attention` on the
    same tensors at the qwen2 train layer's shape (bf16, 14/2 heads of 64,
    B = 4, S = 2048, causal): output and q/k/v gradients bit for bit, and a
    DTensor passed straight to `ops.attention` raising TypeError."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import _attention_on_mesh

    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(4, 14, 2048, 64), (4, 2, 2048, 64), (4, 2, 2048, 64)]
    qkv = [torch.randn(s, generator=gen, device="cuda",
                       dtype=torch.bfloat16) for s in shapes]
    dout = torch.randn(shapes[0], generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    plain = [t.clone().requires_grad_(True) for t in qkv]
    out = ops.attention(*plain, causal=True)
    out.backward(dout)
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    rep = [Replicate(), Replicate()]
    dts = [DTensor.from_local(t, mesh, rep, run_check=False) for t in leaves]
    out_m = _attention_on_mesh(*dts, None, causal=True, softcap=None,
                               window=None)
    out_m.backward(DTensor.from_local(dout, mesh, rep, run_check=False))
    try:
        ops.attention(*dts, causal=True)
        raised = False
    except TypeError:
        raised = True
    return {"shape": {"q": shapes[0], "kv": shapes[1]},
            "out_bit_identical": bool(torch.equal(out_m.to_local(), out)),
            "grads_bit_identical": all(
                torch.equal(a.grad, b.grad) for a, b in zip(leaves, plain)),
            "dtensor_to_ops_raises": raised}


def phase_sharded(torch, state):
    """The sharded path (`parallel.sharding`, `launch.mesh`, the models on a
    mesh, `make_train_step(param_specs=, mesh=)`, `train.elastic.
    reshard_state`, `checkpoint.restore(shardings=)`, expert parallelism)
    on a ("data", "model") = (1, 1) CUDA mesh (NCCL, a world of one, a
    FileStore): every collective is an identity, every DTensor path and
    every kernel under it runs.  qwen2-0.5b at its published widths, bf16,
    remat, B = 4, S = 2048, the train phase's fixed batch and schedule, its
    state placed by `reshard_state` (every leaf a DTensor): one warm-up step
    and 3 more through the mesh, 48 sm90 + 24 tensor-core backward
    launches a step through `local_map`, the first step's loss bit for bit
    the meshless step's from the same state and batch, both step times and
    the peak memory; float32 at full width and 2 layers: loss within 1e-6
    relative and every gradient leaf within 1e-5 of its largest magnitude
    of the meshless step's (the one-hot embedding's gradient named);
    deepseek-moe-16b's S = 4096 prefill through expert parallelism (64
    local experts, an all-reduce over a group of one): logits bit for bit
    the meshless prefill's, 28 sm90 launches, both wall times; elastic:
    the mesh state saved, restored onto a fresh (1, 1) mesh and onto no
    mesh, one step each, the losses bit for bit equal.  Pipelining
    (`parallel.pipeline.gpipe`) has no card check: one card is one stage.
    """
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.api import model_parts
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.parallel.sharding import P, tree_specs_to_shardings
    from repro_torch.train import (AdamW, DataConfig, SyntheticPipeline,
                                   cosine_schedule, init_state,
                                   make_train_step)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.train_step import value_and_grad

    out, problems = {}, []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    store = world_of_one(torch)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        out["mesh"] = {"shape": list(mesh.shape),
                       "axes": list(mesh.mesh_dim_names),
                       "backend": "nccl", "world": 1}
        att = sharded_attention_check(torch, mesh)
        out["attention_local_map"] = att
        check(att["out_bit_identical"] and att["grads_bit_identical"],
              "local_map attention differs from ops.attention")
        check(att["dtensor_to_ops_raises"], "a DTensor reached ops.attention")
        torch.cuda.empty_cache()

        # 1. qwen2-0.5b bf16 through the mesh beside the meshless step
        s = SHARDED
        cfg = get_config(TRAIN["arch"])
        n = cfg.num_layers
        cls = model_parts(cfg)[1]
        plain = build_model(cfg, device="cuda", seed=0, remat="full")
        meshed = cls(cfg, plain.params.tree(), remat="full", mesh=mesh)
        opt = AdamW(learning_rate=cosine_schedule(TRAIN["lr"],
                                                  TRAIN["warmup"],
                                                  TRAIN["steps"]),
                    weight_decay=0.0)
        pspecs = meshed.param_pspecs(mesh)
        sspecs = {"params": pspecs, "opt": opt.state_pspecs(pspecs),
                  "step": P()}
        pipe = SyntheticPipeline(DataConfig(TRAIN["batch"], TRAIN["seq"],
                                            cfg.vocab_size, "fixed",
                                            seed=0), device="cuda")
        st0 = init_state(plain, opt)
        st_m = reshard_state(st0, sspecs, mesh)
        n_dt = sum(type(leaf).__name__ == "DTensor"
                   for _, leaf in tree_items(st_m))
        step_p = make_train_step(plain, opt)
        step_m = make_train_step(meshed, opt, param_specs=pspecs, mesh=mesh)
        steps = s["steps"] + 1  # the first warms up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, rows_p = run_steps(torch, step_p, st0, pipe, steps, "meshless",
                              ops)
        peak_p = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts(ops)  # the sharded path's counts start here
        st_m, rows_m = run_steps(torch, step_m, st_m, pipe, steps,
                                 "sharded 1x1", ops)
        launches = dict(ops.LAUNCHES_BY_KERNEL)
        peak = torch.cuda.max_memory_allocated() / 1e9
        batch0 = pipe.batch_at(0)
        prof = device_time_by_kernel(torch, lambda: step_m(st_m, batch0),
                                     ("train.",))
        del batch0
        per_step = {"sm90": 2 * n, "simt": 0, "bwd": 0, "bwd_sm90": n}
        ms_p = sorted(r["wall_ms"] for r in rows_p[1:])
        ms_m = sorted(r["wall_ms"] for r in rows_m[1:])
        out["bf16"] = {
            "config": {**config_record(cfg), "remat": "full",
                       "batch": TRAIN["batch"], "seq": TRAIN["seq"],
                       "rules": "DEFAULT_RULES",
                       "state_leaves_dtensor": n_dt,
                       "state_leaves": len(tree_items(st_m))},
            "steps": rows_m, "meshless_steps": rows_p,
            "loss_step1_sharded": rows_m[0]["loss"],
            "loss_step1_meshless": rows_p[0]["loss"],
            "loss_step1_bit_identical": check(
                rows_m[0]["loss"] == rows_p[0]["loss"],
                f"step-1 loss {rows_m[0]['loss']} on the mesh, "
                f"{rows_p[0]['loss']} without"),
            "losses_finite": check(all(np.isfinite(r["loss"])
                                       for r in rows_m),
                                   "sharded losses not finite"),
            "every_leaf_dtensor": check(n_dt == len(tree_items(st_m)),
                                        "a state leaf is not a DTensor"),
            "step_ms_median": ms_m[len(ms_m) // 2], "step_ms_runs": ms_m,
            "meshless_step_ms_median": ms_p[len(ms_p) // 2],
            "meshless_step_ms_runs": ms_p,
            "peak_mem_gb": peak, "meshless_peak_mem_gb": peak_p,
            "profile": prof, "flash_launches": launches,
            "launches_ok": check(all(r["flash_launches"] == per_step
                                     for r in rows_m),
                                 f"sharded flash launches a step "
                                 f"{[r['flash_launches'] for r in rows_m]}"
                                 f", not {per_step}"),
            "card": torch.cuda.get_device_name(0),
            "nvidia_smi": nvidia_smi()}
        state.setdefault("flash_sm90_launches_by_path", {})[
            "qwen2-0.5b train bf16 sharded 1x1"] = launches["sm90"]
        state.setdefault("flash_bwd_sm90_launches_by_path", {})[
            "qwen2-0.5b train bf16 sharded 1x1"] = launches["bwd_sm90"]

        # 4. elastic: the mesh state saved, restored onto a fresh (1, 1)
        # mesh and onto no mesh, one step each
        d = os.path.join(ROOT, "build", "sharded_ckpt")
        shutil.rmtree(d, ignore_errors=True)
        t = time.perf_counter()
        ckpt.save(st_m, d, steps)
        save_s = time.perf_counter() - t
        mesh2 = make_mesh((1, 1), ("data", "model"))
        t = time.perf_counter()
        st_a = ckpt.restore(st0, d, steps, shardings=tree_specs_to_shardings(
            sspecs, mesh2))
        st_b = ckpt.restore(st0, d, steps)
        restore_s = time.perf_counter() - t
        shutil.rmtree(d, ignore_errors=True)
        del st_m
        meshed2 = cls(cfg, plain.params.tree(), remat="full", mesh=mesh2)
        batch = pipe.batch_at(steps)
        _, ma = make_train_step(meshed2, opt, param_specs=pspecs,
                                mesh=mesh2)(st_a, batch)
        _, mb = step_p(st_b, batch)
        la, lb = float(ma["loss"]), float(mb["loss"])
        out["elastic"] = {
            "saved_step": steps, "save_s": save_s,
            "restore_both_s": restore_s,
            "loss_restored_mesh": la, "loss_restored_meshless": lb,
            "bit_identical": check(la == lb, f"elastic losses {la} / {lb}")}
        del st_a, st_b, st0, meshed, meshed2, plain, step_p, step_m
        torch.cuda.empty_cache()

        # 2. float32 at full width and 2 layers: one step on the mesh
        # against the meshless step
        c = TRAIN_CHECK
        cfg_c = cfg.with_(num_layers=c["layers"], dtype="float32")
        plain = build_model(cfg_c, device="cuda", seed=1, remat="full")
        meshed = cls(cfg_c, plain.params.tree(), remat="full", mesh=mesh)
        batch = {k: v.cuda() for k, v in SyntheticPipeline(DataConfig(
            c["batch"], c["seq"], cfg.vocab_size, "random", seed=1),
            device="cpu").batch_at(0).items()}
        loss_p, grads_p = value_and_grad(plain, plain.params.tree(), batch)
        reset_flash_counts(ops)
        loss_m, grads_m = value_and_grad(meshed, meshed.params.tree(), batch)
        torch.cuda.synchronize()
        l32 = dict(ops.LAUNCHES_BY_KERNEL)
        leaves = {}
        for (path, g), (_, w) in zip(tree_items(grads_m),
                                     tree_items(grads_p)):
            g = g.full_tensor()
            err, top = float((g - w).abs().max()), float(w.abs().max())
            leaves["/".join(path)] = err / top if top else err
        rel = abs(float(loss_m) - float(loss_p)) / abs(float(loss_p))
        worst = max(leaves, key=leaves.get)
        out["fp32"] = {
            "layers": c["layers"], "batch": c["batch"], "seq": c["seq"],
            "loss_sharded": float(loss_m), "loss_meshless": float(loss_p),
            "loss_rel": rel, "leaf_err_of_max": leaves, "worst_leaf": worst,
            "worst_leaf_err_of_max": leaves[worst],
            "embedding_err_of_max": leaves["embedding"],
            "flash_launches": l32,
            "ok": check(rel <= s["loss_rel"]
                        and max(leaves.values()) <= s["leaf_of_max"],
                        f"fp32 sharded step: loss rel {rel}, worst leaf "
                        f"{worst} {leaves[worst]}")}
        state.setdefault("flash_simt_launches_by_path", {})[
            "qwen2-0.5b fp32 2-layer step sharded 1x1"] = l32["simt"]
        state.setdefault("flash_bwd_launches_by_path", {})[
            "qwen2-0.5b fp32 2-layer step sharded 1x1"] = l32["bwd"]
        del plain, meshed, grads_p, grads_m
        torch.cuda.empty_cache()

        # 3. deepseek-moe-16b prefill through expert parallelism
        cfg_e = get_config(s["moe_arch"])
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.inference_mode():
            plain = build_model(cfg_e, device="cuda", seed=0)
            meshed = model_parts(cfg_e)[1](cfg_e, plain.params.tree(),
                                           mesh=mesh)
            shared = all(a.to_local().data_ptr() == b.data_ptr()
                         for (_, a), (_, b)
                         in zip(tree_items(meshed.params.tree()),
                                tree_items(plain.params.tree())))
            warm = torch.randint(0, cfg_e.vocab_size, (1, NEW_PREFILL_S),
                                 generator=gen, device="cuda")
            tokens = torch.randint(0, cfg_e.vocab_size, (1, NEW_PREFILL_S),
                                   generator=gen, device="cuda")
            # one warm-up forward each at the timed shape (cuBLAS, and
            # DTensor's sharding-propagation cache, keyed by shapes)
            plain.forward(warm)
            meshed.forward(warm)
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref = plain.forward(tokens)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t
            reset_flash_counts(ops)  # the EP prefill's counts start here
            t = time.perf_counter()
            got = meshed.forward(tokens)
            torch.cuda.synchronize()
            wall_m = time.perf_counter() - t
            ep = dict(ops.LAUNCHES_BY_KERNEL)
            got = got.to_local()
            same = bool(torch.equal(got, ref))
            n_attn = attention_layers(cfg_e)
        out["moe_ep"] = {
            "arch": cfg_e.name, "batch": 1, "seq": NEW_PREFILL_S,
            "experts_local": cfg_e.experts_padded // mesh.size(1),
            "expert_start": 0, "params_shared_with_meshless": shared,
            "wall_s": wall_m, "meshless_wall_s": wall_p,
            "logits_bit_identical": check(same, "EP logits differ"),
            "logits_finite": check(bool(torch.isfinite(got).all()),
                                   "EP logits not finite"),
            "flash_launches": ep,
            "launches_ok": check(ep == {"sm90": n_attn, "simt": 0,
                                        "bwd": 0, "bwd_sm90": 0},
                                 f"EP prefill flash launches {ep}")}
        state["flash_sm90_launches_by_path"][
            f"{cfg_e.name} EP prefill 1x1"] = ep["sm90"]
        del plain, meshed, ref, got
        torch.cuda.empty_cache()
    finally:
        end_world(store)
    if problems:
        raise AssertionError(f"sharded path failed its checks: {problems}")
    return out


def mesh_decode_check(torch):
    """Decode on a (1, 1) mesh against the meshless decode: each arch of
    LAUNCH["mesh_decode"] at full width and 2 layers, bf16, one model's
    parameters, `steps` steps on a cache laid out per `cache_pspecs`;
    every step's logits bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.api import model_parts

    c = LAUNCH["mesh_decode"]
    store = world_of_one(torch)
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for arch in c["archs"]:
            cfg = get_config(arch).with_(num_layers=c["layers"])
            plain = build_model(cfg, device="cuda", seed=5)
            meshed = model_parts(cfg)[1](cfg, plain.params.tree(), mesh=mesh)
            gen = torch.Generator(device="cuda").manual_seed(5)
            tok = torch.randint(0, cfg.vocab_size, (c["batch"], c["steps"]),
                                generator=gen, device="cuda")
            c0 = plain.init_cache(c["batch"], c["max_seq"])
            c1 = meshed.init_cache(c["batch"], c["max_seq"])
            same = []
            for t in range(c["steps"]):
                a, c0 = plain.decode_step(c0, tok[:, t:t + 1], t)
                b, c1 = meshed.decode_step(c1, tok[:, t:t + 1], t)
                same.append(bool(torch.equal(a, b.to_local())))
            out[arch] = {"steps": c["steps"], "bit_identical": all(same),
                         "cache_dtensor": type(c1["p0"]["k"]).__name__}
            del plain, meshed, c0, c1
            torch.cuda.empty_cache()
    finally:
        end_world(store)
    return out


def gemm_and_copy_rates(torch):
    """The card's measured bf16 GEMM rate (n^3 `torch.matmul`) and
    device-to-device copy rate (read + write bytes a second), CUDA events,
    median of 30."""
    n = LAUNCH["gemm_n"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((n, n), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    ms_gemm = gpu_ms(torch, lambda: torch.matmul(a, b))
    del a, b
    src = torch.empty(LAUNCH["copy_bytes"], dtype=torch.uint8,
                      device="cuda")
    dst = torch.empty_like(src)
    ms_copy = gpu_ms(torch, lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    return {"gemm_n": n, "gemm_ms": ms_gemm,
            "gemm_flops_per_s": 2.0 * n ** 3 / (ms_gemm / 1e3),
            "copy_bytes": LAUNCH["copy_bytes"], "copy_ms": ms_copy,
            "copy_bytes_per_s": 2.0 * LAUNCH["copy_bytes"] / (ms_copy / 1e3)}


def phase_launch(torch, state):
    """The launch tools on one card (module docstring, ``launch``)."""
    import tempfile

    import numpy as np

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import H100_SXM, roofline_terms

    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    arch = LAUNCH["arch"]
    hbm = dryrun.hbm_bytes(None)
    # the same cell on a world of one, traced on meta tensors on the CPU
    # (the card hidden from it), beside the card's work
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "one",
         "--arch", arch, "--shape", "train_4k", "--hbm-gb", repr(hbm / 1e9),
         "--batch", str(LAUNCH["train_batch"]),
         "--microbatches", str(LAUNCH["train_batch"]), "--out", out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = {"card": torch.cuda.get_device_name(0),
               "nvidia_smi": nvidia_smi(), "hbm_bytes": hbm,
               "h100_sxm_datasheet": {"peak_flops": H100_SXM.peak_flops,
                                      "hbm_bw": H100_SXM.hbm_bw}}
        out["rates"] = rates = gemm_and_copy_rates(torch)
        rates["gemm_of_datasheet"] = rates["gemm_flops_per_s"] \
            / H100_SXM.peak_flops
        rates["copy_of_datasheet"] = rates["copy_bytes_per_s"] \
            / H100_SXM.hbm_bw
        md = mesh_decode_check(torch)
        out["mesh_decode"] = md
        check(all(r["bit_identical"] and r["cache_dtensor"] == "DTensor"
                  for r in md.values()), f"mesh decode differs: {md}")

        # decode_32k: B = 128 over a 32,768-slot KV cache
        reset_flash_counts(ops)
        dec = dryrun.card_step(arch, "decode_32k", repeat=2)
        logits = dec.pop("out")[0]
        out["decode_32k"] = {
            "plan": dec["plan"], "est_bytes": dec["plan"]["est_bytes_per_chip"],
            "max_memory_allocated": dec["max_memory_allocated"],
            "peak_of_est": dec["max_memory_allocated"]
            / dec["plan"]["est_bytes_per_chip"],
            "step_wall_s": dec["wall_s"], "cost": dec["cost"],
            "flash_launches": dec["launches"],
            "logits_shape": list(logits.shape),
            "logits_finite": check(bool(torch.isfinite(logits).all()),
                                   "decode_32k logits not finite"),
            "shape_ok": check(list(logits.shape) == [128, 1, 151936],
                              f"decode logits {list(logits.shape)}")}
        del dec, logits
        torch.cuda.empty_cache()

        # train_4k: one step at the plan's microbatch size, over
        # LAUNCH["train_batch"] of its sequences
        reset_flash_counts(ops)
        nb = LAUNCH["train_batch"]
        tr = dryrun.card_step(arch, "train_4k", batch=nb,
                              extra={"num_microbatches": nb})
        metrics = tr.pop("out")[1]
        mb = tr["plan"]["num_microbatches"]
        layers = 24
        want = {"sm90": 2 * layers * mb, "simt": 0, "bwd": 0,
                "bwd_sm90": layers * mb}
        loss = float(metrics["loss"])
        tokens = nb * 4096
        bound = roofline_terms(tr["cost"]["dot_flops"],
                               tr["cost"]["dot_bytes_flash"], 0.0, 1,
                               tr["model_flops"], H100_SXM)
        out["train_4k"] = t4 = {
            "plan": tr["plan"], "microbatches": mb, "batch": nb,
            "cell_batch": 256, "tokens": tokens,
            "wall_s": tr["wall_s"], "tokens_per_s": tokens / tr["wall_s"],
            "wall_note": "one step under launch.cost's trace",
            "loss": loss, "loss_finite": check(np.isfinite(loss),
                                               f"train_4k loss {loss}"),
            "est_bytes": tr["plan"]["est_bytes_per_chip"],
            "max_memory_allocated": tr["max_memory_allocated"],
            "peak_of_est": tr["max_memory_allocated"]
            / tr["plan"]["est_bytes_per_chip"],
            "cost": tr["cost"], "model_flops": tr["model_flops"],
            "roofline_h100_sxm": bound,
            "wall_of_step_bound": tr["wall_s"] / bound["step_bound_s"],
            "flash_launches": tr["launches"],
            "launches_ok": check(tr["launches"] == want,
                                 f"train_4k launches {tr['launches']}, not "
                                 f"{want}")}
        state.setdefault("flash_sm90_launches_by_path", {})[
            f"{arch} train_4k (launch)"] = tr["launches"]["sm90"]
        state.setdefault("flash_bwd_sm90_launches_by_path", {})[
            f"{arch} train_4k (launch)"] = tr["launches"]["bwd_sm90"]
        del tr, metrics
        torch.cuda.empty_cache()

        # memdebug's card mode at the train cell's microbatch size
        n = LAUNCH["memdebug_batch"]
        md = dryrun.card_step(arch, "train_4k", memory_history=True,
                              top=LAUNCH["top"], batch=n,
                              extra={"num_microbatches": n})
        md.pop("out")
        out["memdebug_card"] = {
            "batch": n, "microbatches": n,
            "peak_bytes_recorded": md["peak_bytes"],
            "max_memory_allocated": md["max_memory_allocated"],
            "top": [{"bytes": s, "address": a, "where": w}
                    for s, a, w in md["top"]]}
        del md
        torch.cuda.empty_cache()

        # the dry run of the same cell on a world of one
        text, _ = dry.communicate(timeout=600)
        with open(os.path.join(out_dir,
                               f"{arch}__train_4k__one.json")) as fh:
            res = json.load(fh)
        out["dryrun_one"] = {
            "rc": dry.returncode, "ok": res.get("ok"),
            "trace_s": res.get("trace_s"),
            "dot_flops": res.get("cost", {}).get("dot_flops"),
            "kernel_calls": res.get("cost", {}).get("kernel_calls"),
            "peak_bytes_per_device": res.get("memory", {}).get(
                "peak_bytes_per_device"),
            "tail": text[-600:] if dry.returncode else ""}
        t4["dot_flops_card"] = t4["cost"]["dot_flops"]
        t4["dot_flops_dryrun_one"] = out["dryrun_one"]["dot_flops"]
        t4["flops_equal"] = check(
            res.get("ok") and t4["cost"]["dot_flops"]
            == out["dryrun_one"]["dot_flops"]
            and t4["cost"]["kernel_calls"]
            == out["dryrun_one"]["kernel_calls"],
            f"card FLOPs {t4['cost']['dot_flops']} "
            f"{t4['cost']['kernel_calls']}, dry run {out['dryrun_one']}")
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        import shutil

        shutil.rmtree(out_dir, ignore_errors=True)
    if problems:
        raise AssertionError(f"launch phase failed its checks: {problems}")
    return out


def free_card(torch, state):
    """Drop every CUDA tensor that `state` holds (at any depth of its
    dicts), then the allocator's cached blocks: card 0 is rank 0's in
    ``cards``.  What is left on it: allocated and reserved bytes."""
    import gc

    def walk(d):
        for k in list(d):
            if isinstance(d[k], torch.Tensor) and d[k].is_cuda:
                del d[k]
            elif isinstance(d[k], dict):
                walk(d[k])

    walk(state)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved()}


def cards_summary(ranks, restore):
    """The phase line's view of the per-rank records: each rank's card,
    flash launches by part and the cards they ran on, peaks, walls."""
    out = []
    for r in ranks:
        row = {"rank": r["rank"], "device": r["device"],
               "card": r.get("card")}
        for part, rec in r.items():
            if not isinstance(rec, dict):
                continue
            if part == "train_check":
                row[part] = {n: {"flash_launches": v["flash_launches"],
                                 "flash_devices": v["flash_devices"],
                                 "step_wall_s": v["step_wall_s"]}
                             for n, v in rec["variants"].items()}
            elif part == "decode":
                row[part] = {a: {"flash_launches": v["flash_launches"],
                                 "flash_devices": v["flash_devices"]}
                             for a, v in rec.items() if isinstance(v, dict)}
            else:
                row[part] = {k: rec[k] for k in (
                    "flash_launches", "flash_devices", "wall_s",
                    "fwd_sm90_ms", "bwd_sm90_ms", "max_memory_allocated",
                    "part_peak_bytes", "part_s", "loss") if k in rec}
        out.append(row)
    return {"ranks": out, "restore_ranks": restore}


def phase_cards(torch, state):
    """The sharded path with one rank a card (module docstring,
    ``cards``)."""
    import shutil
    import tempfile

    from repro_torch.launch import cards
    from repro_torch.launch.ranks import RankFailure, run_ranks

    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)
        return bool(ok)

    n = torch.cuda.device_count()
    world = cards.world_for(n)
    parts = dict(cards.CARD_PARTS)
    out = {"cards_visible": n, "world": world,
           "mesh": list(cards.MESH_SHAPES[world]), "backend": "nccl",
           "nvidia_smi": nvidia_smi(),
           "card0_before_spawn": free_card(torch, state)}
    if world < 4:
        del parts["train_4k"]
        out["train_4k"] = (f"not run: qwen3-4b train_4k at its plan needs "
                           f"four cards, {n} visible")
    if world == 1:  # on (1, 1) every collective is an identity
        del parts["elastic_save"], parts["moe_prefill"]
        out["elastic"] = ("not run: a world of one has no smaller world to "
                          "restore onto")
        out["moe_prefill"] = ("not run on a world of one: the sharded "
                              "phase ran the bf16 EP prefill on (1, 1)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    full = {}
    try:
        t = time.perf_counter()
        try:
            ranks = run_ranks(cards.rank_cards, world, tmp, "cuda", parts,
                              timeout=CARDS["deadline_s"])
        except RankFailure:
            full["partial"] = [json.load(open(os.path.join(tmp, f)))
                               for f in sorted(os.listdir(tmp))
                               if f.endswith(".parts.json")]
            raise
        out["world_s"] = time.perf_counter() - t
        full["ranks"] = ranks
        restore = None
        if "elastic_save" in parts:
            t = time.perf_counter()
            restore = run_ranks(cards.rank_elastic_restore, world // 2, tmp,
                                "cuda", parts["elastic_save"],
                                timeout=CARDS["restore_deadline_s"])
            out["restore_world_s"] = time.perf_counter() - t
            full["restore"] = restore
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with open(os.path.join(ROOT, "build", "chip_smoke_cards.json"),
                  "w") as fh:
            json.dump(full, fh, indent=1)
    out.update(cards_record(ranks, restore, check))
    if problems:
        raise AssertionError(f"cards phase failed its checks: {problems}")
    return out


def cards_record(ranks, restore, check):
    """The cards phase's line from its ranks' records (`launch.cards.
    rank_cards`) and the restore world's (None where no part ``elastic_
    save`` ran), each bar held through `check(ok, what)`."""
    import numpy as np

    from repro_torch.launch import cards

    out = {}
    r0 = ranks[0]
    for r in ranks:
        own = f"cuda:{r['rank']}"
        check(r["device"] == own, f"rank {r['rank']} on {r['device']}")
        for part, rec in r.items():
            if not isinstance(rec, dict):
                continue
            recs = list(rec["variants"].values()) if part == "train_check" \
                else [v for v in rec.values() if isinstance(v, dict)
                      and "flash_devices" in v] if part == "decode" \
                else [rec]
            for x in recs:
                check(set(x.get("flash_devices", {})) <= {own},
                      f"rank {r['rank']} {part}: flash launches on "
                      f"{x.get('flash_devices')}")
            draws = [rec.get("draws_equal", True)] if part != "decode" \
                else [v["draws_equal"] for v in rec.values()
                      if isinstance(v, dict)]
            check(all(draws), f"rank {r['rank']} {part}: seeded draws "
                              f"differ between ranks")

    # qwen3-4b float32, one step a variant
    tc = r0["train_check"]
    out["train_check"] = {
        "mesh": tc["mesh"], "layers": tc["layers"], "batch": tc["batch"],
        "seq": tc["seq"], "bars": cards.TRAIN_BARS,
        "variants": {n: {k: v[k] for k in (
            "loss", "loss_meshless", "loss_err", "worst_grad_leaf",
            "worst_grad_of_max", "worst_param_err", "params_past_bar",
            "step_wall_s", "ok")} for n, v in tc["variants"].items()}}
    for name, v in tc["variants"].items():
        check(v["ok"], f"train_check {name}: loss err {v['loss_err']}, "
                       f"{v['worst_grad_leaf']} {v['worst_grad_of_max']}, "
                       f"params past the bar {v['params_past_bar']}")
        for r in ranks:
            fl = r["train_check"]["variants"][name]["flash_launches"]
            check(fl["simt"] > 0 and fl["bwd"] > 0,
                  f"rank {r['rank']} train_check {name}: flash {fl}")

    # decode
    dec = {a: {k: v[k] for k in ("tokens_equal", "logits_max_abs_err",
                                 "logits_within", "ok")}
           for a, v in r0["decode"].items() if isinstance(v, dict)}
    out["decode"] = {"mesh": r0["decode"]["mesh"], "tol": cards.DECODE_TOL,
                     "archs": dec}
    for r in ranks:
        for a, v in r["decode"].items():
            if isinstance(v, dict):
                check(v["ok"], f"rank {r['rank']} decode {a}: tokens "
                               f"{v['tokens_equal']}, logits err "
                               f"{v['logits_max_abs_err']}")

    # EP prefill, float32 at cut depth
    me = r0["moe_ep"]
    out["moe_ep"] = {k: me[k] for k in (
        "mesh", "config", "layers", "dtype", "seq", "experts_local", "tol",
        "deterministic", "ranks_equal", "whole", "alone", "wall_s",
        "meshless_wall_s", "ok")}
    check(me["ok"], f"float32 EP prefill: {out['moe_ep']}")
    want = {"sm90": 0, "simt": me["layers"], "bwd": 0, "bwd_sm90": 0}
    for r in ranks:
        fl = r["moe_ep"]["flash_launches"]
        check(fl == want, f"rank {r['rank']} float32 EP prefill flash {fl}")
        check(r["moe_ep"]["ranks_equal"]
              and all(a["ranks_equal"] for a in r["moe_ep"]["alone"]),
              f"rank {r['rank']} float32 EP: ranks' logits or routes "
              f"differ")

    # EP prefill, bf16 at full depth
    if "moe_prefill" in r0:
        mp = r0["moe_prefill"]
        out["moe_prefill"] = {k: mp[k] for k in (
            "mesh", "config", "layers", "dtype", "seq", "experts_local",
            "meshless_vs_float32", "ep_vs_float32", "ep_vs_float32_bar",
            "ep_over_meshless", "rel_rms", "max_abs_err", "logits_max_abs",
            "argmax_agree_share", "next_token", "next_token_meshless",
            "next_margin", "next_margin_meshless", "held_tokens",
            "meshless_vs_float32_held", "ep_vs_float32_held",
            "ep_over_meshless_held", "wall_s", "meshless_wall_s", "ok")}
        out["moe_prefill"]["flips"] = [
            {k: f[k] for k in ("layer", "flips", "unexplained", "median_gap")}
            for f in mp["flips"]]
        out["moe_prefill"]["slack"] = cards.EP_BF16_SLACK
        out["moe_prefill"]["wall_s_by_rank"] = [
            r["moe_prefill"]["wall_s"] for r in ranks]
        check(mp["ok"], f"EP prefill: next token {mp['next_token']} / "
                        f"{mp['next_token_meshless']}, from float32 "
                        f"{mp['ep_vs_float32']} (meshless "
                        f"{mp['meshless_vs_float32']})")
        want = {"sm90": mp["layers"], "simt": 0, "bwd": 0, "bwd_sm90": 0}
        for r in ranks:
            fl = r["moe_prefill"]["flash_launches"]
            check(fl == want, f"rank {r['rank']} EP prefill flash {fl}")

    # elastic
    if restore is not None:
        es = r0["elastic_save"]
        losses = {"live": es["loss_next_live"],
                  "restored_mesh": restore[0]["loss_restored_mesh"],
                  "restored_meshless": restore[0]["loss_restored_meshless"]}
        spread = max(losses.values()) - min(losses.values())
        out["elastic"] = {
            "saved_on": es["mesh"], "restored_on": restore[0]["mesh"],
            "saved_step": es["saved_step"], "losses_before": es["losses"],
            "save_s": es["save_s"], "restore_s": restore[0]["restore_s"],
            "step_losses": losses, "spread": spread,
            "tol": cards.ELASTIC_TOL,
            "ok": check(np.isfinite(list(losses.values())).all()
                        and spread <= cards.ELASTIC_TOL,
                        f"elastic losses {losses}")}

    # GPipe
    gp = r0["gpipe"]
    out["gpipe"] = {k: gp[k] for k in (
        "stages", "d", "layers", "microbatches", "mb", "max_abs_err",
        "wall_s", "in_order_wall_s", "ok")}
    out["gpipe"]["tol"] = cards.GPIPE_TOL
    check(gp["ok"], f"gpipe max abs err {gp['max_abs_err']}")

    # the flash kernels on each card
    out["flash_by_card"] = [r["flash"] for r in ranks if "flash" in r]

    # qwen3-4b train_4k, four cards
    if "train_4k" in r0:
        out["train_4k"], problems = cards.train_4k_summary(ranks)
        for what in problems:
            check(False, what)
    out["per_rank"] = cards_summary(ranks, restore)
    return out


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch is not next to this script",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke, state = Smoke(), {}
    phases = [("kernels", phase_kernels, (torch, state)),
              ("parity", phase_parity, (torch,)),
              ("main_path", phase_main_path, (torch, state)),
              ("table5", phase_table5, (torch, state)),
              ("figures", phase_figures, (torch, state)),
              ("certified", phase_certified, (torch, state)),
              ("packet", phase_packet, (torch, state)),
              ("analysis", phase_analysis, (torch, state)),
              ("scale", phase_scale, (torch, state)),
              ("sizes", phase_sizes, (torch, state)),
              ("model", phase_model, (torch, state)),
              ("moe", phase_moe, (torch, state)),
              ("hybrid", phase_hybrid, (torch, state)),
              ("ssm", phase_ssm, (torch, state)),
              ("encdec", phase_encdec, (torch, state)),
              ("train", phase_train, (torch, state)),
              ("sharded", phase_sharded, (torch, state)),
              ("launch", phase_launch, (torch, state)),
              ("cards", phase_cards, (torch, state))]
    # `python3 chip_smoke.py train ...` runs the named phases alone (a
    # development run: the kernel line then misses the others' kernels and
    # the run fails)
    wanted = set(sys.argv[1:]) or {name for name, _, _ in phases}
    smoke.phase("lint", phase_lint)
    smoke.phase("device", phase_device, torch)
    if smoke.phase("build", phase_build):
        for name, fn, args in phases:
            if name in wanted:
                smoke.phase(name, fn, *args)
    launches = {"path_costs": state.get("launches", 0),
                "minplus": state.get("minplus_launches", 0),
                "minplus_hops": state.get("minplus_hops_launches", 0),
                "gf_crossprod": state.get("gf_launches", 0),
                "flash_attention": state.get("flash_simt_launches", 0),
                "flash_attention_sm90": state.get("flash_sm90_launches", 0),
                "flash_attention_bwd": state.get("flash_bwd_launches", 0),
                "flash_attention_bwd_sm90": state.get(
                    "flash_bwd_sm90_launches", 0)}
    kernels = [{**state[name], "launches": launches[name]}
               for name in launches if name in state]
    for k in kernels:
        if k["name"] == "flash_attention_sm90":
            # `launches` is the Gemma2-9B prefill's; the MoE, hybrid, SSM
            # and encoder-decoder prefills' beside it
            k["launches_by_path"] = {
                GEMMA: k["launches"],
                **state.get("flash_sm90_launches_by_path", {})}
        if k["name"] == "flash_attention":
            # `launches` is the Gemma2-9B float32 run's; whisper-base's
            # (its whole model in float32) and the float32 train run's
            # beside it
            k["launches_by_path"] = {
                GEMMA: k["launches"],
                **state.get("flash_simt_launches_by_path", {})}
        if k["name"] == "flash_attention_bwd":
            # `launches` is the float32 train run's (bf16 takes the
            # tensor-core backward at qwen2's D = 64)
            k["launches_by_path"] = state.get("flash_bwd_launches_by_path")
        if k["name"] == "flash_attention_bwd_sm90":
            # `launches` is the bf16 train run's
            k["launches_by_path"] = state.get(
                "flash_bwd_sm90_launches_by_path")
        if k["name"] == "path_costs":
            # the main path's count is `launches`; the certified path's,
            # the scale tier's and Table V's beside it
            k["launches_certified"] = state.get("certified_launches", 0)
            k["launches_certified_by_dtype"] = state.get(
                "certified_launches_by_dtype")
            k["launches_scale"] = state.get("scale_launches", 0)
            k["scale_shapes"] = state.get("path_costs_scale_shapes")
            k["launches_table5"] = state.get("table5_launches", 0)
            k["table5_shapes"] = state.get("path_costs_table5_shapes")
            k["launches_figures"] = state.get("figures_launches", 0)
            k["figures_shapes"] = state.get("path_costs_figures_shapes")
            k["launches_sizes"] = state.get("sizes_launches", 0)
            k["sizes_shapes"] = state.get("path_costs_sizes_shapes")
    smoke.record["kernels"] = kernels
    smi = nvidia_smi()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({**smoke.record, "nvidia_smi": smi,
                   "failed": smoke.failed}, fh, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    # every kernel a path routes to was launched by it; the float minplus
    # kernel serves `ops.minplus` alone since `apsp` takes the integer
    # route (the analysis phase checks it stays at 0), and the kernels
    # phase holds and times it
    on_path = [n for name, n in launches.items() if name != "minplus"]
    on_path.append(state.get("sizes_launches", 0))  # the sizes path's
    if (smoke.failed or len(kernels) != len(launches)
            or not all(on_path)):
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
