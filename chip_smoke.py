#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase (what CI on a GPU runs)
    python3 chip_smoke.py --only kernels   # build + hold the kernels only
    python3 chip_smoke.py --only mixed-tree  # build + phase 11b (a tree of mixed dtypes)
    python3 chip_smoke.py --only group-mode  # build + phase 18 (a) (gmf_select's group mode)
    python3 chip_smoke.py --only dryrun    # build + phase 21 (the dry run) only
    python3 chip_smoke.py --only analysis  # build + phase 22 (static analysis) only
    python3 chip_smoke.py --profile        # + where a ResNet-56 and a Shakespeare
                                           #   round's, each serving run's and a dense
                                           #   training step's time goes

Phases, in order; any failure exits nonzero:

1. **Build.** ``nvcc`` compiles ``src/repro_torch/kernels/csrc/gmf_compress.cu``,
   ``csrc/flash_attention.cu`` and ``csrc/flash_attention_sm90.cu`` for
   ``sm_90a`` into ``build/torch_kernels/``, all three at once (the
   compiler's register reports and the build time are printed).
2. **Kernels.** Each CUDA kernel runs against its plain PyTorch version
   (``kernels/ref.py``) on the card, on numpy-seeded inputs rounded to
   1/16 so many elements tie exactly at the top-k threshold. K1 is two
   kernels over the flat ``[clients, N]`` stacks (``utils/flat.py``):
   ``gmf_select`` (per (client, leaf) segment the inverse norms and the
   exact top-k threshold; and its |z| mode, DGC's top-k mask) and the mask
   pass ``gmf_compress``. They are held over the ResNet-56 layout for 20
   clients, a layout of segments of 1, 3, 10, 16, 36,864 and 35 elements
   (one all zeros and one all equal in every client; the mask pass also on
   misaligned views) and single leaves of 1,000, 65,537 and 2²⁴+3, at
   τ ∈ {0, 0.3, 1} and mixed per client: the inverse norms within 1e-6
   relative of the plain version's (sums in another order), the thresholds
   bitwise ``torch.topk``'s on the z of the kernel's own scalars, two runs
   bitwise equal, the |z| mode's thresholds and mask bitwise, and the mask
   pass's G, U, V and mask bitwise given the same scalars: both sides do
   the same float32 operations in the same order with no fused
   multiply-add. ``gmf_select`` is held again, in both modes, with a
   per-row keep table of distinct counts (row 0 keeps 1 of every segment,
   row 1 all of it, the others at rates from 0.001 to 0.9) over the
   char-LSTM's layout for 10 clients, the tiny-segment layout and ResNet-56
   for 4 clients: thresholds bitwise ``torch.topk``'s per segment, the |z|
   mask bitwise its plain version's, and the table as a stride-0 broadcast
   bitwise the shared ``[L]`` counts. ``gmf_select`` splits a leaf longer
   than its layout's tile over many blocks, so it is held, in both modes
   and twice (two runs bitwise), where the tiles can go wrong: leaves of t −
   1, t and t + 1 elements for t = 16,384 and 65,536, an all-equal leaf of
   70,000 and one of 1,000,003 whose largest scores are runs of one tied
   value across every tile border, each at tile t and at the layout's own
   tile, 4 rows keeping 100 (inside the ties), 1, all and a tenth of each
   leaf. K2 and K3 are held bitwise on stacks of 1, 5, 1000,
   65,537, 3×1001, 20×36,864 and 2²⁴+3 elements and one misaligned view;
   K2, one multi-tensor launch per tree, also over the 169 ResNet-56 leaves
   for 20 clients in one launch, over the same tree with a misaligned leaf,
   and over a tree of more leaves than its table holds (one launch per
   table). K4 runs against its plain version in float32 and
   bfloat16, causal and not, G ∈ {1, 2, 4, 8} query heads per kv head (8 is
   MQA at H 8), head dim 16, 32, 64, 128, and T ∈ {1, 64, 1000, 2048} (1000
   is no tile multiple): bf16 at D 64/128 on the tensor-core kernel
   (``flash_attention_tc``), the rest on the CUDA-core kernel
   (``flash_attention_cc``), each case's launch checked against
   ``kernel_for``; kimi-k2's head dim 112 and recurrentgemma-9b's 256,
   bf16 on the tensor-core kernel and float32 on the CUDA-core kernel,
   causal and not, G ∈ {1, 8, 16} at H 16, T ∈ {1, 64, 1000, 2048}; the
   tensor-core kernel at yi-34b's G 7 and command-r-plus-104b's G 12 (D
   128, T 1000 and 2048, causal and not); plus the (BH, T, D) interface on
   the tensor-core kernel at D 64, 112, 128 and 256, and misaligned bf16
   inputs at D 64, 112 and 256, which must raise naming the tensor-core
   kernel with no launch. Tolerances: atol 3e-5 /
   rtol 1e-4 in float32 and 3e-2 in bfloat16 (``tests/test_flash_attention.py``'s:
   the two sum in other orders), and each output within 1e-5 (float32) or
   5e-4 (bfloat16) relative L2 of the plain version's; the timing phase
   holds both K4 kernels to both bounds again at the serving shape.
3. **Path.** ``FLSimulator`` + ``CifarTask(depth=56)`` with 20 clients,
   batch 64, lr 0.1, ``SynthCIFAR(num_train=20000)``: 3 rounds of
   ``dgcwgmf`` (τ 0.6, ``use_kernels=True``) and 3 of ``dgc``. Launch counts
   are reset before each run and read after it: a round of ``dgcwgmf`` must
   launch ``gmf_select``, ``gmf_compress`` (K1) and ``momentum_correction``
   (K2) once each, a round of ``dgc`` K2, ``gmf_select`` (|z| mode) and
   ``apply_mask`` (K3) once each. Every client's upload nnz must be at
   least the exact-k sum 85,654; params must stay finite.
4. **Card vs CPU.** Round 0 of ``dgcwgmf`` at depth 8 through the same port
   on the card and with ``device="cpu"``: per-client upload nnz equal, and
   the broadcast within 1e-2 relative L2. Per-element gradients agree to
   ~1e-6 (convolution sums run in another order), so a few elements at a
   top-k boundary can flip; each flip moves the broadcast by one
   threshold-sized entry. Then, under ``--profile``, a ``torch.profiler``
   trace of one steady round of each preset: its device activities, the device's busy share
   (the union of the activities' intervals, so overlap is not counted
   twice), and the device time under each of the engine's phase ranges
   (``round.client_grads``, ``round.client_compress``,
   ``round.server_aggregate``, ``round.apply_update``), beside the client
   gradients' synchronised host-clock time.
5. **Serving.** ``repro_torch.launch.serve.run_fixed`` on llama3.2-1b at
   full width and depth (16 layers, d_model 2048, bfloat16, random params
   from seed 0 on the card), batch 4, prompt 2048, 32 generated tokens:
   one untimed warm-up run, then the measured one. Counts are reset before
   each run: K4 must launch exactly 16 times (one per layer) and K1–K3
   never; the prefill logits must be finite and every sequence must get 32
   tokens; all 16 K4 launches must be the tensor-core kernel's. Then the
   prefill alone and ``run_fixed``'s decode loop (``serve.decode``) alone
   must launch K4 16 and 0 times.
6. **Serving, card vs CPU.** llama3.2-1b width at depth 2 in float32,
   batch 2, prompt 256, the same params on both devices (K4 on the card,
   naive attention on the CPU): the prefill's last logits and 4 decode
   steps, both sides fed the CPU's greedy tokens, within 1e-4 relative L2
   per step. The float32 prefill runs on the CUDA-core K4 (2 launches).
   Then the same check for the moe (granite-moe), ssm (mamba2), hybrid
   (recurrentgemma, its smoke's 5 layers so that its attention block is
   in), vlm (qwen2-vl) and audio (musicgen) families at their smoke widths,
   2 layers, and kimi-k2's attention (H 64, KV 8, head dim 112) at d_model
   1024 with 16 experts: batch 2, prompt 64, float32, K4 launched once per
   attention block of the card's prefill (CUDA-core kernel); these
   launches join llama's in the CUDA-core kernel's row.
7. **ResNet-56 under the other stage kinds.** Phase 3's task, 2 rounds
   each of ``dgcwgmf`` (τ 0.6, fused) with the int8 and the bf16 wire,
   ``dgcwgmf_dl`` (a top-k downlink: one more ``gmf_select`` launch a
   round, on the ``[1, N]`` broadcast) and ``adaptive_dgcwgmf`` with
   ``rate_wire_threshold`` 0.5 (per-client rates take the staged path: K2,
   ``gmf_select`` in its |z| mode with a ``[20, L]`` keep table, K3). Launch
   counts exact; every client's nnz at least its exact-k sum at its own
   rate; the downlink's nnz at least 85,654; some client on the int8 wire
   and the rates moving under the controller; the ledger's bytes equal to
   the cost model's on the read-back counts.
8. **Shakespeare**, the paper's Table 4 preset at full width:
   ``SynthShakespeare`` (100 clients × 4,000 chars, sequences of 80),
   ``ShakespeareTask`` on the card, the char-LSTM at hidden 256 (292,560
   params in 6 leaves), 10 clients a round, batch 8, lr 0.5: 3 rounds each
   of ``dgc``, ``gmc``, ``dgcwgm`` and ``dgcwgmf`` (τ 0.6, fused) over the
   flat ``[100, 292,560]`` state. Each path kernel launches once a round;
   every client's nnz is at least 29,258; the ledger equals the cost
   model's; then round 0 runs twice more from the same initial state and
   everything it leaves (params, client and server state, broadcast) must
   be bitwise equal: the embedding's gradient and every reduction of the
   round are deterministic.
9. **Shakespeare, card vs CPU.** Round 0 of ``dgcwgmf`` at full width, 4
   of 10 clients, on the card and the CPU: nnz equal, broadcast within
   1e-2 relative L2 (phase 4's tolerance). Then, under ``--profile``, a
   profile of one steady Shakespeare round of ``dgcwgmf`` and ``dgc``, as
   phase 4's.
10. **ResNet-56 under the remaining stage kinds.** Phase 3's task (built
   anew), 2 rounds each of ``randomk`` (rate 0.1), ``fetchsgd`` at
   ``benchmarks/ablations.py:176``'s settings (a 5 × 20,000 sketch,
   ``sketch_k_frac`` 0.02), ``dgcwgmf`` (τ 0.6, fused) with the probquant
   wire and ``dgc`` with the Hadamard rotation ahead of the int8 wire.
   randomk: every client's mask identical and its nnz equal each round,
   the density within 5σ (σ ≈ 277) of 0.1·N, a new mask each round.
   fetchsgd: 100,000 sketch values up a client (8,000,000 bytes a round,
   value bytes only) and k = 17,111 heavy hitters down (136,888 bytes to
   each of 20 clients: 2,737,760 a round); the client state empty, params
   and ``s_mom``/``s_err`` finite; round 0 run twice from the same state
   bitwise equal in params, sketch-space state and broadcast under cuDNN's
   deterministic algorithms (its default fp32 weight gradient sums with
   atomics; a pair under the default algorithms is reported). probquant: within each 256-block of each leaf every payload
   value in {−s, 0, +s}; 0.25 byte a value; ``gmf_select``, K1's mask pass
   and K2 once a round. Hadamard: 1,515,504 values up a client (the 169
   leaves padded to powers of two), so the dense int8 charge (855,578
   bytes a client); K2, ``gmf_select`` (|z| mode) and K3 once a round.
   randomk and fetchsgd launch none of K1–K3. Every preset's ledger equals
   the cost model's on the read-back counts, and its ms/round after round
   0 is printed beside the card's name and power limit. Then round 0 of
   each at depth 8 (8 clients, batch 32) on the card and the CPU: the
   keyed draws (randomk's uniforms and masks, probquant's keep draws, the
   Hadamard diagonal) bitwise equal on both, the fetchsgd and Hadamard
   broadcasts within phase 4's 1e-2 relative L2.
11. **ResNet-56 under the async, ring, hierarchical and shard engines.**
   Phase 10's task (phase 3's settings), ``dgcwgmf`` family at τ 0.6 on the
   fused path, which launches ``gmf_select``, K1's mask pass and K2 once
   per compression call: an async dispatch, a ring hop, a hierarchical
   tier. (1) ``async_dgcwgmf`` with no delay model and a cohort-sized
   buffer, 2 ticks, bitwise 2 vmap rounds in params, client and server
   state, broadcast and ledger. (2) Geometric delays (mean 1, max 4),
   dropout 0.1, buffer 10, 6 ticks: each kernel once a tick; every tick's
   arrivals, flush gaps, pending and in-flight counts equal a plain
   schedule drawn from the engine's own availability stream; dispatched =
   arrived + dropped + in flight, applied = 10 per flush, fewer than 10
   pending; the staleness histogram counts 10 a flush, some gap > 0; upload
   bytes the cost model's on the arrived nnz only, download its bytes × 10
   a flush; every arrived nnz at least 85,654; params and the server
   momentum M finite. (3) The ring, 3 hops (5 segments of 4), broadcast
   every 2 rounds, 2 rounds: 4 launches of each kernel a round; 15 + 5
   (peer + ingress) payloads a round, each nnz at least 85,654; round 0
   charges no download and leaves ``gbar_prev`` zero, round 1 charges it
   to 20 clients. (4) ``hier_dgcwgmf``, 4 groups, tier rate 0.1, 2 rounds:
   2 launches of each kernel a round; 20 + 4 (leaf + tier) payloads a round,
   each at least 85,654; the tier state a finite ``[4, N]`` stack with a
   nonzero M; the leaf uploads and the relay to 20 leaves peer bytes. (5)
   ``ring_hops=0`` with ``dgc`` and ``groups=1`` with ``dgcwgmf``, 2 rounds
   each, bitwise the star. (6) A one-rank NCCL group (``file://`` store in
   ``build/dist_store``), ``backend="shard"``, bitwise the vmap run, the
   group destroyed after. (1), (5) and (6) run under cuDNN's deterministic
   algorithms (ROADMAP R8), restored after. (7) Depth 8, 4 clients, card
   vs CPU: round 0 of the ring (1 hop) and the hierarchy (2 groups), 3
   async ticks with (2)'s stragglers and a buffer of 2: the same async
   schedule on both, broadcasts within phase 4's 1e-2 relative L2. Each
   engine's ms per round (tick) after round 0 is printed beside the card's
   name and power limit.
11b. **A tree of mixed dtypes through every cross-leaf stage and engine**
   (ROADMAP item 15): granite-moe-1b-a400m at its published widths, 2 of
   24 layers, bf16 beside its float32 routers (two dtype groups). First
   global top-k's select over the groups' ``[2, N_g]`` scores, the radix
   select against ``torch.topk`` over their concatenation, the same
   masks, each timed. (a) Global top-k (dgc; and dgcwgmf_dl's uplink and
   downlink), random-k, FetchSGD (and its server), the probquant wire
   (dgcwgmf, fused), the Hadamard rotation with int8 (dgc) and adaptive
   rates (per tensor, with an int8 drop; and global) through
   ``client_compress`` on 2 clients: each kernel one launch per dtype
   group, then the same call on the plain versions bitwise (FetchSGD's
   payload and sketch error within 1e-5: atomics; ``gmf_select``'s
   inverse norms within 1e-6 relative of the plain sums', its thresholds
   bitwise on its own norms, as phase 2 holds it), ms a call. (b) LMTask
   (8 clients, 4 a round, batch 2, sequence 128) through the async engine
   (phase 11's stragglers, buffer 4, 4 ticks) under global top-k (dgc),
   the ring (1 hop), the hierarchy (2 groups, hier_dgcwgmf) and a one-rank
   NCCL shard under dgcwgmf, 2 rounds each: every compression call (and
   the tier's) held against the plain versions on the same gradients,
   each kernel's launches (one per dtype group a call), the params moved
   and finite, ms a tick or round after the first with the holds' time
   taken out, beside the card's name and power limit.
12. **Telemetry** (``repro_torch.obs``). Phase 10's task: (1) 3 rounds of
   ``dgcwgmf`` (τ 0.6, fused) with telemetry off, then 3 with it on into
   ``build/obs/resnet56``, from the same seed under cuDNN's deterministic
   algorithms: params, client and server state, broadcast and ledger
   bitwise equal, the kernels' launches equal (one of each a round), and
   the off run writes or changes no file in the checkout. (2) The on run's
   ``events.jsonl`` valid with 3 ``round`` and 3 ``health`` events,
   ``python -m repro_torch.obs.report --strict`` exit 0, the ``comm.*``
   counters equal to the ledger, each health norm within 1e-5 relative of
   a float64 recomputation from the returned stacks, and a NaN in a copy
   of the broadcast trips one ``anomaly`` event (``health.anomalies`` 1).
   (3) 4 ``async_dgcwgmf`` ticks with phase 11's stragglers (buffer 10):
   the ``flush`` events carry the ledger's gaps, and
   ``global_momentum_norm`` is ``engine._gmom``'s within 1e-5; 2
   ``hier_dgcwgmf`` rounds at 4 groups: an ``aggregator`` health block a
   round, finite, with a nonzero tier M. (4) ms per round after round 0
   with telemetry off and on, in turns (off, on, on, off), 4 rounds each,
   under cuDNN's default algorithms. (5) A ``torch.profiler`` trace of one
   round with telemetry on: the device time under each of the four
   ``round.*`` ranges (all four must show) and the busy share (union).
   (6) ``launch/serve.py --obs`` in fixed mode at llama3.2-1b, batch 4,
   prompt 2048, 8 tokens: ``events.jsonl``, ``metrics.prom`` and
   ``summary.json`` written, ``run_start`` and ``summary`` events,
   ``--strict`` exit 0, and K4's 16 tensor-core launches (the prefill's).
13. **Serving every other architecture at its published widths.**
   ``run_fixed`` in bfloat16 with random params from seed 0 drawn on the
   card, a warm-up run and the measured one, on qwen2.5-3b (18 of 36
   layers), yi-34b (16 of 60), command-r-plus-104b (8 of 64),
   granite-moe-1b-a400m (12 of 24), kimi-k2-1t-a32b (1 of 61; batch 1,
   prompt 256, 8 tokens), mamba2-780m (24 of 48), recurrentgemma-9b (19
   of 38), qwen2-vl-72b (16 of 80; 1024 patches + a 1024-token prompt) and
   musicgen-large (24 of 48; 4 codebooks),
   batch 4, prompt 2048, 16 tokens unless stated (``SERVE_FAMILIES``).
   Before each config's params are drawn, K4 is held against its plain
   version on random bf16 q/k/v at the shapes that config's prefill gives
   it (B, prompt + patches, H, KV, head dim; causal), on the kernel
   ``kernel_for`` names, at phase 2's tolerances. Counts reset before each
   run: K4 launches once per attention block on the kernel ``kernel_for``
   names (the tensor cores at every served head dim: 64, 128, kimi's 112
   and recurrentgemma's 256; 6 launches a recurrentgemma-9b prefill at
   19 layers, 1 a kimi-k2 one), the CUDA-core kernel and K1–K3 never; then the prefill
   alone launches K4 that many times and the decode loop alone none. The
   prefill logits finite, every sequence (every codebook) complete, the
   decode cache's shapes unchanged by the decode loop; ``prefill_ms``,
   ``ms_per_step`` and ``tokens_per_s`` printed beside the card's name and
   power limit. Each model is freed before the next.

Phase 2 also holds K1–K3's bfloat16 and mixed instances against their
plain versions, bitwise: K2 with (state, gradient) dtypes (bf16, bf16),
(f32, bf16), (bf16, f32) and the last storing the state's dtype, and K3
with a bf16 state and a float32 or bf16 mask (into the promotion or the
state's dtype), on stacks of 1 to 2²⁴+3 elements and a misaligned view;
``gmf_select`` (both modes) and K1's mask pass with v, u bf16 and m bf16
or v, u float32 and m bf16, over ResNet-56 (4 clients), the toy layout
and the char-LSTM (10 clients); all four bf16 instances over llama3.2-1b's
whole one-client row (1,498,482,688 elements, 3.0 GB: byte offsets past
2³¹), each then timed beside its plain version and its bytes bound (the
bf16 rows of the kernels line; ``gmf_select`` held twice in each mode, and
its |z| mode over the row timed too, ``at_abs_mode``); and ``client_compress`` (dgcwgmf, fused
and staged) over granite-moe's mixed tree at 2 layers (a bf16 and a
float32 group, 3 clients) against the same call on the plain versions,
each kernel launching once per dtype group.

14. **Training llama3.2-1b at its published size.** ``launch/train.py``'s
    ``run_dist`` (mesh=None) on llama3.2-1b (16 layers, d_model 2048,
    bf16, 1,498,482,688 params from seed 0, remat honoured): gmf_data (one
    GMF client) with dgcwgmf at rate 0.1 on the fused kernel path, batch
    8, sequence 256, 4 steps; then dense sync. Per step: the loss, the
    step's ms, every upload count against the exact-k sum (≥), K1–K3's
    launches by dtype instance (one K2, one ``gmf_select`` and one K1
    mask pass a step, all bf16); then one more profiled step of gmf_data
    (and, under ``--profile``, of dense) on a fresh state (the kernels and
    the allocator warm from the run): the device busy share and the device time in each of the step's
    ranges (``round.client_grads``, ``round.client_compress``,
    ``round.server_aggregate``, ``round.apply_update``).
15. **LMTask through the FL engines.** ``run_fl`` at llama3.2-1b's widths
    cut to 2 layers (646,981,632 params), 4 clients, 2 a round, batch 2,
    sequence 256, 3 rounds of dgcwgmf on the staged path (K2 in bf16,
    ``gmf_select``'s |z| mode on the float32 scores, K3 from the bf16
    state to float32): launches, ms a round, upload counts against the
    exact-k sum; the params read at init and after each round must change
    in every round, and the held-out loss taken in float32 must drop in
    round 0 (the task's own, the reference's, is bf16: it moves in steps
    of 0.0625 at 12 and cannot show a change that small). Then each of the ten architectures at ``smoke()``
    through ``LMTask`` on the card and on the CPU from the same params, 2
    rounds of fused dgcwgmf: params and broadcast within 1e-2 relative L2,
    upload counts within 1e-4 of each other and at least the exact-k sum.
    The client gradients are ``vmap(grad)``, so the RG-LRU scan's and the
    MoE's gradient paths (F4, F5) run on the card.
16. **Serving llama3.2-1b through the continuous-batching engine**
    (``repro_torch.serve``: the paged KV pool, its codecs, the paged steps)
    at its published size (bf16, random params from seed 0), 4 slots, page
    16, 130 pages a slot (2080 tokens: prompt_pad 2048 + 32 generated).
    (a) 4 prompts of 2048 prefilled by the fixed ``make_prefill_step`` at
    cache_len 2080, the same K/V bytes written into a float32 pool with
    ``codec.write_pages`` over a scrambled page table, then 8 decode steps
    each way at S = 4: logits and tokens bitwise equal at every step (the
    same shapes on both sides, so cuBLAS runs the same products). (b) 8
    requests of lengths 2048, 1999, 1537, 2048, 1024, 2047, 1800 and 2048,
    32 tokens each, float32 codec, arriving 2 ticks apart and all at tick
    0: every request's tokens equal between the two (both prefill at 1 x
    2048 and decode at S = 4); 4 slots at the peak, a request that waited
    for a slot, the allocator back to every page free; printed, not gated:
    how many of the 2048-token requests' tokens equal a fixed batch's. (c)
    The float32, float16, bfloat16 and int8 codecs, each a warm-up run of
    (b)'s staggered requests (logits checked finite on the device, read
    once) and the measured one: every request complete with in-range ids,
    K4 16 launches a request on the tensor-core kernel, the CUDA-core
    kernel and K1–K3 none; tokens/s, p50/p99 latency, decode ticks, peak
    pages, pool bytes, bytes a page and the slots an 8 GiB pool holds,
    beside the card's name and power limit, and each codec's tokens equal
    to float32's (the float32 run's must all be). (d) ``launch/serve.py
    --mode engine --requests 8 --prompt-len 2048 --gen 32 --stagger 2
    --max-slots 4 --pages-per-slot 130 --warmup`` exits 0 with the
    reference's summary keys. (e) Under ``--profile``, one more float32
    run traced: the device's busy share in all and inside the decode
    ticks' ``serve.decode`` host ranges, the costliest kernels, and the
    ``cudaStreamSynchronize`` / ``cudaMemcpy*`` calls inside each of the
    engine's ranges (``serve.admit``, ``serve.decode``, ``serve.finish``):
    none inside ``serve.decode``.
17. **The mesh's data axes** (``launch/mesh.py``, ``dist/sharding.py``,
    the steps over a ``DeviceMesh``, ``moe.moe_ep``) at one rank. (d)
    first, while this process holds least of the card's memory: ``python
    -m repro_torch.launch.train --backend dist --mesh-shape 1,1
    --grad-sync gmf_data --steps 4 --use-kernels`` on llama3.2-1b in a one-rank
    ``torchrun``-style environment (``RANK`` 0, ``WORLD_SIZE`` 1,
    ``MASTER_ADDR`` 127.0.0.1, a free ``MASTER_PORT``) exits 0 and prints
    its mesh; ``--mesh-shape 2,1`` there exits nonzero with the reference's
    message (both processes at once; phase 18's two processes start with
    them and run beside this phase). Then one world of one rank from a
    ``file://`` store in ``build/mesh`` (NCCL for the card's tensors, gloo
    for the CPU's), torn down at the end: (a) gmf_data at mesh (1, 1) on
    llama3.2-1b at its widths, 2 of 16 layers, with phase 14's settings
    (bf16, batch 8 × 256, lr 3e-3 cosine,
    fused dgcwgmf at rate 0.1, seed 0), 4 steps, bitwise the mesh-less run
    (params, opt, u/v/m, server state, ``gbar``, each step's loss and
    counts), one ``gmf_select``, K1 mask pass and K2 a step, ms/step of both
    runs; (b) dense at (1, 1) bitwise dense without a mesh, and gmf_pod at
    (1, 1, 1) bitwise gmf_data at (1, 1), 2 steps each; (c)
    granite-moe-1b-a400m at its widths, 12 of 24 layers, bf16, batch 4,
    prompt 2048, 16 tokens through ``run_fixed`` over the (1, 1) mesh:
    ``moe_ep`` once a layer of the prefill and of each decode step, K4 12
    tensor-core launches a prefill, K1–K3 none, two runs bitwise, the
    dropped (token, expert) assignments of a prefill counted, prefill_ms
    and ms_per_step beside phase 13's dense dispatch (reported, not gated);
    then phase 6's granite check (smoke widths, 2 layers, float32) through
    ``moe_ep`` on both the card and the CPU, within 1e-4 relative L2.
18. **The model axis** (tensor parallelism, ``--only model-axis``): (a)
    (``--only group-mode``) ``gmf_select``'s group mode at a group of one
    (one-rank NCCL), both modes, over llama3.2-1b's bf16 row, a ResNet-56
    round, the tie layouts and three inputs built for its full reads (every
    score tied, the candidate slots overflowed, the sample misled): bitwise
    the single launch (and its plain version but on llama's row), its
    launches (6 fused, 5 |z|) and all-reduces (4, 3) a call counted, how
    many segments and tiles counted their candidates or read in full (the
    kernel's count against the rule's) and the bytes an element that
    implies printed, the built inputs each reading some tile in full in
    both modes; llama's row and ResNet-56 timed beside the single launch,
    and the group mode's device time alone; (b)-(c) two processes on the card
    over gloo (``--tp-worker``) at mesh (1, 2): the group select over the
    two ranks bitwise, llama3.2-1b at 2 layers trained gmf_data and dense
    against the mesh-less run, served at 2 layers in float32 against the
    one-rank run.
19. **FSDP, EP at model 2, the engine at model 2** (``--only fsdp``; FSDP
    forced: ``dist.step._FSDP_PARAM_THRESHOLD`` 0 in the two processes for
    the FSDP runs, the depth-cut configs falling under 40e9 params). The
    one-rank witnesses in this process (kimi-k2 served without a mesh;
    llama3.2-1b's engine in float32, float32 and int8 codecs), then two
    processes over gloo (``--fsdp-worker``; FSDP needs a data axis over 1,
    so no one-rank mesh runs it): (b) the group select over the data group
    with a leaf only rank 0 owns, bitwise the single launch and the plain
    group select; qwen2-vl-72b (full width, 1 of 80 layers, remat: each
    layer gathered inside its checkpoint and again in the backward) dense
    at (2, 1) and llama3.2-1b (2 of 16 layers) gmf_pod at (1, 2, 1), two
    steps each, against the mesh-less runs (losses and each rank's param
    pieces within 1e-2, the params' change within ``FSDP_DELTA_TOL`` of the
    mesh-less run's at its worst leaf, upload nnz within
    ``FSDP_NNZ_FLIPS`` and at least the exact-k sum, the group mode's
    launches and all-reduces); the group mode over the pod's data group
    timed; (c) granite-moe at its published widths, 12 of 24 layers (EP),
    trained at (1, 2) (24 ``moe_ep`` calls in two steps, the same checks,
    the change within
    ``EP_DELTA_TOL``) and kimi-k2 (1 of 61 layers,
    1 × 256, 8 tokens) served at (1, 2): tokens equal to the one-rank
    run's, one tensor-core K4 launch a rank at D 112, the dropped
    assignments printed, logits within 1e-2 where nothing drops; (d)
    llama3.2-1b's engine at (1, 2), phase 16's slots, pages and 8
    requests of ``ENGINE_MESH_GEN`` tokens: tokens equal to the one-rank
    engine's, tokens/s beside it.
    Every process's peak memory is printed.
20. **Every compression stage over leaves cut across the model axis**
    (``--only stages-cut``; two processes over gloo, ``--stages-worker``,
    at mesh (1, 2)): (a) each configuration whose stages cut or key a
    leaf by flat coordinate, and the top-k downlink's global, sampled,
    int8 and probquant variants, through ``client_compress`` and
    ``server_aggregate`` on each rank's pieces of TP_SELECT's leaves
    (the layout ``over`` the model group with each piece's box), bitwise
    the whole leaves' run (the sketch within STAGES_SKETCH_REL); (b)
    llama3.2-1b at its published widths, 2 of 16 layers, bf16, two steps
    of each of STAGES_CUT (the eight configurations at (1, 2); sampled
    dgcwgmf and the int8 wire under gmf_pod FSDP at (1, 2, 1)) against
    rank 0's mesh-less run: losses within TP_TRAIN_TOL, the params'
    change within TP_DELTA_TOL, K1-K3's launches a step as counted.
21. **The dry run** (``--only dryrun``; ``launch/dryrun.py``, a fake-tensor
    pass: nothing of a step runs on the card). Started together: (a) in a
    process of its own, llama3.2-1b as phase 14 trains it (bf16, 8 x 256,
    gmf_data, fused dgcwgmf, mesh-less): ``max_memory_allocated`` over step
    2 and the live bytes of its inputs against the fake pass of the same
    step, the arguments equal and the reckoned peak within
    DRYRUN_CALIB_TOL of the measured; (b) two processes over gloo at (1, 2)
    (``--dryrun-worker``) tallying the first gmf_data step of llama3.2-1b
    (2 layers, fused: the group mode's all-reduces in) with
    ``obs.collectives.CollectiveTally``, equal kind by kind to the fake
    pass's in a fake world of two; (c) ``python -m repro_torch.launch.dryrun``
    at ``--shape train_4k`` and ``--shape prefill_32k --mesh multi``, each
    exit 0, their record lines printed; and, meanwhile in this process, (d)
    each kernel's fake outputs (shapes, dtypes) against its real launch's
    in float32 and bf16.
22. **Static analysis** (``--only analysis``; ``repro_torch.analysis``; in
    the whole script it runs while phase 19's two processes run): (a)
    ``python -m repro_torch.analysis --all`` in a process of its own (the
    lints, the contracts and the audit on fake CUDA tensors), exit 0, its
    finding counts printed; meanwhile in this process (b) round 1 of phase
    3's dgcwgmf path (ResNet-56, 20 clients, batch 64, ``use_kernels``)
    audited on the card by ``jaxpr_audit.audit_round`` and as its fake pass
    (``fake_twin``): host reads, host-to-device copies, collectives and
    the K1–K3 launches equal, no finding; (c) ``contracts.check_all`` at
    ResNet-56's params on the card's tensors and on fake ones: the same
    findings, none.

Timing: ``gmf_select`` (its printed line beside its PR 21 time, when it
ran one block a segment; the ``kernels`` line holds only this run's
times), the K1 mask pass, K2 and K3 over one round's flat ResNet-56
stacks (20 clients), one launch each as the path makes them (and
``gmf_select``'s |z| mode as the new paths call it: a Shakespeare
round's stack with a per-row keep table and with shared counts, a ResNet
round's with a per-row table, the ResNet broadcast of the downlink)
(CUDA events around the wrapper call, host time in), each beside its
plain version and bytes bound; K1 as a round runs it (select + mask
pass); K2's device time alone; one large launch of the mask pass, K2 and
K3; K4 at the serving shape on the tensor-core kernel,
the CUDA-core kernel (a bf16 comparison), the plain version and SDPA (a
yardstick only: the port never calls it), beside the operations bound;
the tensor-core kernel at D 128; the CUDA-core kernel at the float32
shape phase 6 gives it, which is its row's time; and the tensor-core
kernel at recurrentgemma-9b's (B 4, T 2048, H 16, KV 1, D 256) and
kimi-k2-1t-a32b's (B 1, T 256, H 64, KV 8, D 112) prefill shapes beside
the CUDA-core kernel on the same inputs (called past ``kernel_for``: where
these inputs went before), the plain version, SDPA and the bound at the
bf16 peak, in turns. Phase 1 prints each ``flash_fwd_sm90<D>`` instance's
registers and spills from the compiler's report.

TF32 is off for matrix products and convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False), so float32 means
float32 on both devices.

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
line of per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# HBM bandwidth (bytes/s), float32 non-tensor-core peak and bf16 dense
# tensor-core peak (FLOP/s) by card name, from NVIDIA's data sheets.
CARDS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM5 80GB HBM3
    "H200": (4.8e12, 67e12, 989e12),
}

# K-id, kernel name, the Pallas function it replaces, bytes per element,
# float operations per element. gmf_select is K1's glue (norms, score and
# exact top-k threshold of every segment) as a kernel: it reads v and m once
# (each radix pass reads them again), two squares and sums, then the score
# (5 operations) in each of the three passes.
KERNELS = [
    ("K1", "gmf_select", "src/repro/kernels/gmf_compress.py:101", 8, 19),
    ("K1", "gmf_compress", "src/repro/kernels/gmf_compress.py:101", 28, 10),
    ("K2", "momentum_correction", "src/repro/kernels/gmf_compress.py:64", 20, 3),
    ("K3", "apply_mask", "src/repro/kernels/gmf_compress.py:146", 24, 4),
]
RATE = 0.1
EPS = 1e-16
# gmf_select's times before its split over tiles (one block a segment), on
# an NVIDIA H100 80GB HBM3 at 700 W: PR 21's chip_smoke.py run (PERF.md).
# Printed beside this run's times on the timing lines, never in the
# ``kernels`` line.
PR21_MS = {"gmf_select": 0.3827, "gmf_select_bf16": 1485.4166, "k1_round": 0.5706,
           "Shakespeare round (10 clients), per-row keep table": 0.7685,
           "Shakespeare round (10 clients), shared counts (dgc)": 0.8382,
           "ResNet-56 round (20 clients), per-row keep table (adaptive)": 0.3157,
           "ResNet-56 broadcast (the top-k downlink)": 0.1525}
PORT_SOURCE = "src/repro_torch/kernels/csrc/gmf_compress.cu"
RESNET56_LEAVES, RESNET56_PARAMS, RESNET56_KEEP = 169, 855_578, 85_654
K4_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
K4_TC_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
K4_REPLACES = "src/repro/kernels/flash_attention.py:81"
K4_TOL = {torch.float32: dict(atol=3e-5, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
# Relative L2 of K4 against its plain version over a whole output. The
# elementwise bf16 bound is about half of a typical output element at
# T 2048, so this second bound is what catches a masking or tile-edge error
# there. On an H100 the two summation orders give at most 8.4e-7 (float32)
# and 5.3e-5 (bfloat16) over every held case; the bounds are about 10x that.
K4_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
# The serving run: llama3.2-1b, batch 4, prompt 2048, 32 tokens.
SERVE = dict(batch=4, prompt_len=2048, gen=32)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return rates
    fail(f"no bandwidth figure for card {name!r}; add it to CARDS")


def device_us(event) -> float:
    """Self device time (µs) of a ``torch.profiler`` ``key_averages()`` row."""
    return getattr(event, "self_device_time_total", 0) or getattr(
        event, "self_cuda_time_total", 0)


def timed_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def kernel_inputs(rng, rows, n, dev, misalign=False):
    """u, v, m (or g) of shape [rows, n], rounded to 1/16 so many elements
    tie; ``misalign`` returns views one float past a 16-byte boundary."""

    def one():
        a = np.round(rng.normal(size=rows * n) * 16.0) / 16.0
        t = torch.tensor(a.astype(np.float32), device=dev)
        if misalign:
            buf = torch.empty(rows * n + 1, dtype=torch.float32, device=dev)
            buf[1:] = t
            t = buf[1:]
        return t.reshape(rows, n)

    return one(), one(), one()


def hold_kernels(gk, ref, dev):
    """K2 and K3 against their plain versions on the card over single
    stacks; returns the largest absolute difference seen per kernel (0 when
    bitwise)."""
    rng = np.random.default_rng(0)
    cases = [(1, 1, False), (1, 5, False), (1, 1000, False), (1, 65_537, False),
             (3, 1001, False), (20, 36_864, False), (1, 2**24 + 3, False),
             (3, 1001, True)]
    worst = {"momentum_correction": 0.0, "apply_mask": 0.0}
    for rows, n, mis in cases:
        u, v, m = kernel_inputs(rng, rows, n, dev, mis)
        for alpha in (0.0, 0.9):
            got = gk.momentum_correction_flat(u, v, m, alpha)
            want = ref.momentum_correction_leaf(u, v, m, alpha)
            for what, a, b in zip(("U", "V"), got, want, strict=True):
                same(worst, "momentum_correction", a, b, what)
        mask = (torch.tensor(rng.random((rows, n)) > 0.7, device=dev)).float()
        if mis:
            buf = torch.empty(rows * n + 1, dtype=torch.float32, device=dev)
            buf[1:] = mask.reshape(-1)
            mask = buf[1:].reshape(rows, n)
        got = gk.apply_mask_flat(u, v, mask)
        want = ref.apply_mask_update_leaf(u, v, mask)
        for what, a, b in zip(("G", "U", "V"), got, want, strict=True):
            same(worst, "apply_mask", a, b, what)
        print(f"  held {rows}x{n}{' misaligned' if mis else ''}: K2, K3 bitwise", flush=True)
    torch.cuda.synchronize()
    return worst


def max_abs(a, b) -> float:
    """The largest |a - b| (float64), 0 for empty tensors."""
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def same(worst, name, got, want, what):
    """Fail unless ``got`` is bitwise ``want``; track the largest difference."""
    check(got.shape == want.shape, f"{name}: {what} shape {tuple(got.shape)}")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    worst[name] = max(worst[name], err)
    check(torch.equal(got, want), f"{name}: {what} differs from the plain version "
          f"(max abs {err:.3e}) at shape {tuple(got.shape)}")


def select_layouts(rt, resnet_params, dev):
    """(label, layout, rows, toy) of every case ``hold_select`` runs: ResNet-56
    for 20 clients (the path's), a layout of tiny and odd segments (1, 3,
    10, 16 elements, none 16-byte aligned inside a row, beside a 36,864
    one), and single leaves."""
    flat = rt.flat.FlatLayout
    toy = {"a": torch.empty(1), "b": torch.empty(3), "c": torch.empty(10),
           "d": torch.empty(16), "e": torch.empty(64, 64, 3, 3), "f": torch.empty(5, 7)}
    toy = {k: x.to(dev) for k, x in toy.items()}
    return [("ResNet-56, 20 clients", flat.of(resnet_params), 20, False),
            ("segments 1/3/10/16/36864/35, 5 clients", flat.of(toy), 5, True),
            ("one leaf of 1000, 3 clients", flat.of(torch.empty(1000, device=dev)), 3, False),
            ("one leaf of 65537, 1 client", flat.of(torch.empty(65_537, device=dev)), 1, False),
            ("one leaf of 2^24+3, 1 client", flat.of(torch.empty(2**24 + 3, device=dev)), 1,
             False)]


def hold_select(rt, resnet_params, dev):
    """gmf_select (both modes) and the flat K1 mask pass against their plain
    versions on the card, on inputs rounded to 1/16 so that scores tie:
    the inverse norms within 1e-6 relative (the kernel sums in another
    order), the thresholds bitwise torch.topk's on the z of the kernel's own
    scalars, two runs bitwise equal, and given the same scalars the mask
    pass bitwise. The toy layout's 10-element segment is all zeros and its
    16-element one all equal, in every client; its mask pass runs once more
    on misaligned views. Returns the largest differences seen."""
    gk, ref, sparsify = rt.gk, rt.ref, rt.sparsify
    rng = np.random.default_rng(3)
    worst = {"gmf_select": 0.0, "gmf_compress": 0.0, "norm_rel": 0.0}
    for label, layout, rows, toy in select_layouts(rt, resnet_params, dev):
        u, v, m = kernel_inputs(rng, rows, layout.total, dev)
        if toy:
            for x in (v, m):
                x[:, layout.offsets[2]:layout.offsets[3]] = 0.0
                x[:, layout.offsets[3]:layout.offsets[4]] = 0.5
        keep_host, keep = layout.keep(RATE)
        offs = layout.offsets_dev
        w = torch.tensor(rng.uniform(0.5, 2.0, rows).astype(np.float32), device=dev)
        for tau_vals in ((0.0,), (0.3,), (1.0,), (0.0, 0.3, 0.6, 1.0)):
            tau = torch.tensor([tau_vals[i % len(tau_vals)] for i in range(rows)],
                               dtype=torch.float32, device=dev)
            kw = dict(offsets=offs, plan=layout.select_plan(), keep=keep, w=w, tau=tau, eps=EPS)
            inv_nv, inv_nm, thr = gk.gmf_select_flat(v, m, **kw)
            again = gk.gmf_select_flat(v, m, **kw)
            for what, a, b in zip(("inv_nv", "inv_nm", "thr"), (inv_nv, inv_nm, thr), again,
                                  strict=True):
                check(torch.equal(a, b), f"gmf_select over {label}: two runs differ in {what}")
            p_nv, p_nm, _ = ref.gmf_select(v, m, layout, RATE, w=w, tau=tau, eps=EPS)
            for a, b in ((inv_nv, p_nv), (inv_nm, p_nm)):
                rel = ((a - b).abs() / b.abs()).max().item()
                worst["norm_rel"] = max(worst["norm_rel"], rel)
                check(rel <= 1e-6, f"gmf_select over {label}: inverse norms {rel:.3e} "
                      f"relative from the plain version's")
            z = ref.gmf_fusion_score(v, m, inv_norm_v=layout.expand(inv_nv),
                                     inv_norm_m=layout.expand(inv_nm), tau=tau)
            same(worst, "gmf_select", thr, sparsify.segment_thresholds(z, layout, RATE),
                 f"threshold over {label}")
            scal = dict(inv_norm_v=inv_nv, inv_norm_m=inv_nm, tau=tau, threshold=thr)
            got = gk.gmf_compress_flat(u, v, m, offsets=offs, **scal)
            want = ref.gmf_compress_segments(u, v, m, layout=layout, **scal)
            for what, a, b in zip(("G", "U", "V", "mask"), got, want, strict=True):
                same(worst, "gmf_compress", a, b, f"{what} over {label}")
            kept = torch.stack([s.sum(1) for s in layout.segments(got[3])], dim=1)
            check(bool((kept >= torch.tensor(keep_host, device=dev)).all()),
                  f"gmf_compress over {label}: a segment kept fewer than k_i")
        thr_a, mask_a = gk.topk_abs_select_flat(v, offsets=offs, plan=layout.select_plan(),
                                                keep=keep)
        p_thr, p_mask = sparsify.segment_topk_mask(v, layout, RATE)
        same(worst, "gmf_select", thr_a, p_thr, f"|z| threshold over {label}")
        same(worst, "gmf_select", mask_a, p_mask, f"|z| mask over {label}")
        if toy:
            mu, mv, mm = kernel_inputs(rng, rows, layout.total, dev, misalign=True)
            mv.copy_(v)
            mm.copy_(m)
            got = gk.gmf_compress_flat(mu, mv, mm, offsets=offs, **scal)
            want = ref.gmf_compress_segments(mu, mv, mm, layout=layout, **scal)
            for what, a, b in zip(("G", "U", "V", "mask"), got, want, strict=True):
                same(worst, "gmf_compress", a, b, f"{what} over {label}, misaligned")
        print(f"  held gmf_select (τ 0, 0.3, 1, mixed; and |z|) and the K1 mask pass over "
              f"{label} ({layout.num_leaves} leaves, {rows * layout.num_leaves} segments): "
              f"bitwise, inverse norms within {worst['norm_rel']:.3e} relative", flush=True)
    torch.cuda.synchronize()
    return worst


def keep_rows(rt, layout, rows, dev):
    """A per-row keep table ``[rows, L]`` of distinct counts: row 0 keeps 1
    of every segment, row 1 all of it, the rest at rates spread over
    (0.001, 0.9), each through ``num_keep_dynamic`` as the path makes it."""
    rates = torch.tensor(np.geomspace(0.001, 0.9, max(rows - 2, 1))[:rows - 2],
                         dtype=torch.float32, device=dev)
    table = rt.sparsify.keep_table(layout, torch.cat([torch.zeros(min(rows, 2), device=dev),
                                                      rates]))
    table[0] = 1
    if rows > 1:
        table[1] = layout.sizes_dev
    return table.contiguous()


def topk_per_segment(z, layout, keep):
    """The keep[r, i]-th largest of every (row, leaf) segment by torch.topk."""
    keep = keep.cpu()
    return torch.stack([torch.stack([torch.topk(seg[r], int(keep[r, i])).values[-1]
                                     for r in range(z.shape[0])])
                        for i, seg in enumerate(layout.segments(z))], dim=1)


def hold_select_keep(rt, layouts, dev):
    """``gmf_select`` in both modes with a per-row keep table of distinct
    counts (k = 1 and k = n included), on the card against torch.topk per
    segment (thresholds bitwise) and the plain versions (|z| mask bitwise,
    inverse norms within 1e-6); the table as a stride-0 broadcast of one
    row's counts is bitwise the shared ``[L]`` path. ``layouts`` are
    (label, layout, rows). Returns the largest threshold difference (0
    when bitwise)."""
    gk, ref, sparsify = rt.gk, rt.ref, rt.sparsify
    rng = np.random.default_rng(7)
    worst = {"gmf_select": 0.0}
    for label, layout, rows in layouts:
        _, v, m = kernel_inputs(rng, rows, layout.total, dev)
        keep = keep_rows(rt, layout, rows, dev)
        offs, plan = layout.offsets_dev, layout.select_plan()
        thr, mask = gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=keep)
        same(worst, "gmf_select", thr, topk_per_segment(v.abs(), layout, keep),
             f"per-row keep |z| threshold vs torch.topk over {label}")
        p_thr, p_mask = sparsify.segment_topk_mask_keep(v, layout, keep)
        same(worst, "gmf_select", thr, p_thr, f"per-row keep |z| threshold over {label}")
        same(worst, "gmf_select", mask, p_mask, f"per-row keep |z| mask over {label}")
        w = torch.tensor(rng.uniform(0.5, 2.0, rows).astype(np.float32), device=dev)
        tau = torch.tensor(rng.choice([0.0, 0.3, 0.6, 1.0], rows).astype(np.float32),
                           device=dev)
        inv_nv, inv_nm, thr = gk.gmf_select_flat(v, m, offsets=offs, plan=plan, keep=keep, w=w,
                                                 tau=tau, eps=EPS)
        z = ref.gmf_fusion_score(v, m, inv_norm_v=layout.expand(inv_nv),
                                 inv_norm_m=layout.expand(inv_nm), tau=tau)
        same(worst, "gmf_select", thr, topk_per_segment(z, layout, keep),
             f"per-row keep threshold vs torch.topk over {label}")
        p_nv, p_nm, _ = ref.gmf_select(v, m, layout, keep=keep, w=w, tau=tau, eps=EPS)
        for a, b in ((inv_nv, p_nv), (inv_nm, p_nm)):
            rel = ((a - b).abs() / b.abs()).max().item()
            check(rel <= 1e-6, f"per-row keep gmf_select over {label}: inverse norms {rel:.3e} "
                  f"relative from the plain version's")
        shared = layout.keep(RATE)[1]
        a = gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=shared)
        b = gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=shared.expand(rows, -1))
        for x, y in zip(a, b, strict=True):
            check(torch.equal(x, y), f"a stride-0 keep table differs from [L] over {label}")
        print(f"  held gmf_select (|z| and fused) with a per-row keep table (k = 1, k = n, "
              f"{rows - 2} rates in between) over {label} ({rows * layout.num_leaves} "
              f"segments): thresholds bitwise torch.topk's, |z| mask bitwise", flush=True)
    torch.cuda.synchronize()
    return worst["gmf_select"]


def tile_layouts(rt, dev):
    """(label, layout, plan) of the cases ``hold_select_tiles`` runs: for a
    tile t of 16,384 (the least ``select_tile`` gives) and of 65,536 (the
    most), leaves of t - 1, t and t + 1 elements (whole, whole, split in
    two), an all-equal one of 70,000 and one of 1,000,003 whose k-th largest
    value is tied across tile borders, each held at tile t and at the
    layout's own tile; and llama3.2-1b's smallest tile split in 4,096."""
    flat, gk = rt.flat.FlatLayout, rt.gk
    out = []
    for t in (16_384, 65_536):
        layout = flat.of_sizes([t - 1, t, t + 1, 70_000, 1_000_003], dev)
        plans = (gk.select_table(gk.plan_select(layout.sizes, t), dev), layout.select_plan())
        for plan in {id(p): p for p in plans}.values():
            out.append((f"leaves of {t - 1}, {t}, {t + 1}, 70000 (all equal), 1000003 (ties "
                        f"across borders) at tile {plan.plan.tile}", layout, plan))
    return out


def tied_across_borders(rt, layout, rows, dev):
    """v and m ``[rows, N]`` (normal draws rounded to 1/16, from a seed), the
    fourth leaf all 0.5 in both (every score equal), and the fifth within
    [-1.5, 1.5] but for runs of 2.0 in both (the largest scores, tied) over
    every multiple of 16,384 in it (every border of a tile of 16,384 or
    65,536), 64 elements each side; with a per-row keep table: row 0 keeps
    100 of every leaf (inside the runs of ties), row 1 one, row 2 all, row 3
    a tenth."""
    rng = np.random.default_rng(17)
    v, m = (torch.tensor(np.round(rng.normal(size=(rows, layout.total)) * 16) / 16,
                         dtype=torch.float32, device=dev) for _ in range(2))
    o = layout.offsets
    for x in (v, m):
        x[:, o[3]:o[4]] = 0.5
        x[:, o[4]:o[5]].clamp_(-1.5, 1.5)
        for b in range(16_384, layout.sizes[4], 16_384):
            x[:, o[4] + b - 64:o[4] + b + 64] = 2.0
    sizes = layout.sizes_dev
    keep = torch.stack([torch.full_like(sizes, 100), torch.ones_like(sizes), sizes,
                        rt.sparsify.keep_table(layout, torch.full((1,), RATE, device=dev))[0]])
    return v, m, keep[:rows].contiguous()


def hold_select_tiles(rt, dev, rows=4):
    """``gmf_select`` in both modes where the tiles can go wrong
    (``tile_layouts``): thresholds bitwise torch.topk's per segment (on the
    z of the kernel's own scalars), the |z| threshold and mask bitwise the
    plain version's, inverse norms within 1e-6 relative, two runs bitwise.
    Returns the largest threshold difference (0 when bitwise)."""
    gk, ref, sparsify = rt.gk, rt.ref, rt.sparsify
    worst = {"gmf_select": 0.0}
    for label, layout, plan in tile_layouts(rt, dev):
        v, m, keep = tied_across_borders(rt, layout, rows, dev)
        offs, o4 = layout.offsets_dev, layout.offsets[4]
        w = torch.tensor([1.0, 0.5, 2.0, 1.0][:rows], device=dev)
        tau = torch.tensor([0.0, 0.3, 1.0, 0.6][:rows], device=dev)
        kw = dict(offsets=offs, plan=plan, keep=keep, w=w, tau=tau, eps=EPS)
        got, again = gk.gmf_select_flat(v, m, **kw), gk.gmf_select_flat(v, m, **kw)
        for what, a, b in zip(("inv_nv", "inv_nm", "thr"), got, again, strict=True):
            check(torch.equal(a, b), f"gmf_select over {label}: two runs differ in {what}")
        p_nv, p_nm, _ = ref.gmf_select(v, m, layout, keep=keep, w=w, tau=tau, eps=EPS)
        for a, b in ((got[0], p_nv), (got[1], p_nm)):
            rel = ((a - b).abs() / b.abs()).max().item()
            check(rel <= 1e-6, f"gmf_select over {label}: inverse norms {rel:.3e} relative "
                  f"from the plain version's")
        z = ref.gmf_fusion_score(v, m, inv_norm_v=layout.expand(got[0]),
                                 inv_norm_m=layout.expand(got[1]), tau=tau)
        same(worst, "gmf_select", got[2], topk_per_segment(z, layout, keep),
             f"threshold vs torch.topk over {label}")
        thr, mask = gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=keep)
        thr2, mask2 = gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=keep)
        check(torch.equal(thr, thr2) and torch.equal(mask, mask2),
              f"gmf_select's |z| mode over {label}: two runs differ")
        same(worst, "gmf_select", thr, topk_per_segment(v.abs(), layout, keep),
             f"|z| threshold vs torch.topk over {label}")
        p_thr, p_mask = sparsify.segment_topk_mask_keep(v, layout, keep)
        same(worst, "gmf_select", thr, p_thr, f"|z| threshold over {label}")
        same(worst, "gmf_select", mask, p_mask, f"|z| mask over {label}")
        check(float(thr[0, 4]) == 2.0 and float(got[2][0, 4]) == float(z[0, o4 + 16_384]),
              f"over {label}: row 0's 100th largest score of the fifth leaf is not the tied "
              f"value")
        print(f"  held gmf_select (fused and |z|, two runs each; k = 100 in the ties, 1, n and "
              f"a tenth) over {label}: {plan.n_split} leaves split over {plan.n_tiles} tiles, "
              f"{plan.n_local} whole; bitwise, inverse norms within 1e-6", flush=True)
    torch.cuda.synchronize()
    return worst["gmf_select"]


def plan_of(layout) -> str:
    """A layout's gmf_select plan in words."""
    plan = layout.select_plan()
    return (f"tile {plan.plan.tile}: {plan.n_split} leaves split over {plan.n_tiles} tiles, "
            f"{plan.n_local} whole")


def time_select_paths(rt, layouts, bw, peak, dev):
    """``gmf_select``'s |z| mode as the Shakespeare, downlink and adaptive
    paths call it: each (label, layout, rows, per_row) case timed with a
    per-row keep table or the shared ``[L]`` counts, beside its plain
    version and its bound (z
    read once, the mask written once: 8 bytes an element; the |z|, three
    radix passes' compares and the mask compare, 5 operations)."""
    gk, sparsify = rt.gk, rt.sparsify
    rng = np.random.default_rng(8)
    out = {}
    for label, layout, rows, per_row in layouts:
        _, z, _ = kernel_inputs(rng, rows, layout.total, dev)
        if per_row:
            keep = sparsify.keep_table(layout, torch.full((rows,), RATE, device=dev))
        else:
            keep = layout.keep(RATE)[1]
        plan = layout.select_plan()
        kern = lambda: gk.topk_abs_select_flat(z, offsets=layout.offsets_dev, plan=plan,
                                               keep=keep)
        plain = ((lambda: sparsify.segment_topk_mask_keep(z, layout, keep)) if per_row
                 else (lambda: sparsify.segment_topk_mask(z, layout, RATE)))
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        elems = rows * layout.total
        bound_bytes, bound_ops = 8 * elems / bw * 1e3, 5 * elems / peak * 1e3
        out[label] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(bound_bytes, bound_ops),
                          bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                          at=f"[{rows}, {layout.total}], {layout.num_leaves} leaves, "
                             f"{'per-row keep table' if per_row else 'shared keep counts'}",
                          plan=plan_of(layout))
        print(f"  gmf_select |z| mode, {label} ({out[label]['at']}; {out[label]['plan']}): "
              f"kernel {ms:.4f} ms (PR 21: {PR21_MS[label]}), plain {plain_ms:.4f} ms, bound "
              f"{out[label]['bound_ms']:.4f} ms ({8 * elems / 1e6:.1f} MB)", flush=True)
    return out


def k2_tree(rng, leaf_shapes, clients, dev, misalign=None):
    """u, v, g trees (dicts of ``[clients, *shape]`` leaves, rounded to 1/16);
    leaf ``misalign`` of each is a view one float past a 16-byte boundary."""
    trees = ({}, {}, {})
    for i, shape in enumerate(leaf_shapes):
        n = math.prod(shape)
        for tree, x in zip(trees, kernel_inputs(rng, clients, n, dev, i == misalign),
                           strict=True):
            tree[f"leaf{i:03d}"] = x.reshape(clients, *shape)
    return trees


def hold_k2_trees(gk, ops, ref, leaf_shapes, dev):
    """K2 as the path calls it, one tree at a time: bitwise against its
    plain version, with its launch count; returns the largest absolute
    difference (0 when bitwise)."""
    rng = np.random.default_rng(2)
    capacity, chunk = gk.momentum_limits()
    small = [(3,)] * (capacity + 3) + [(0,), (5, 0)]  # past one table, and empty leaves
    cases = [("ResNet-56, 20 clients", leaf_shapes, 20, None),
             ("ResNet-56, 20 clients, leaf 7 misaligned", leaf_shapes, 20, 7),
             (f"{len(small)} leaves (2 empty, leaf 1 misaligned)", small, 2, 1)]
    worst = 0.0
    for label, shapes, clients, mis in cases:
        u, v, g = k2_tree(rng, shapes, clients, dev, mis)
        want_launches = -(-sum(1 for sh in shapes if math.prod(sh)) // capacity)
        for alpha in (0.0, 0.9):
            gk.reset_launches()
            got = ops.momentum_correction(u, v, g, alpha)
            launches = gk.LAUNCHES["momentum_correction"]
            want = ref.momentum_correction(u, v, g, alpha)
            check(launches == want_launches, f"K2 over {label}: {launches} launches, "
                  f"expected {want_launches}")
            for what, gt, wt in zip(("U", "V"), got, want, strict=True):
                for key in wt:
                    a, b = gt[key], wt[key]
                    check(a.shape == b.shape and torch.equal(a, b),
                          f"K2 over {label}: {what} of {key} differs from the plain version "
                          f"(max abs {(a - b).abs().max().item() if a.numel() else 0:.3e})")
                    if a.numel():
                        worst = max(worst, (a - b).abs().max().item())
        print(f"  held K2 over {label}: {launches} launch(es) a tree call, bitwise "
              f"(table capacity {capacity} leaves, {chunk} elements a block)", flush=True)
    gk.reset_launches()
    torch.cuda.synchronize()
    return worst


def k2_device_ms(gk, us, vs, gs, reps=20):
    """K2's device time per tree call over these leaves: the table is built
    once, then ``reps`` calls' launches go back to back, so the host's
    per-call work is out of the measure (the tree-call time has it in)."""
    table = gk.momentum_table(us, vs, gs, *gk.momentum_limits())  # the launches write there
    dev = us[0].device
    return timed_ms(lambda: [gk.launch_momentum(table, 0.9, dev) for _ in range(reps)],
                    reps=5) / reps


def time_kernels(rt, layout, clients, bw, peak, dev):
    """Each kernel over one round's flat ResNet-56 stacks (``[clients, N]``,
    one launch each, as the path calls them: K2 through
    ``ops.momentum_correction``), its plain version over the same inputs,
    and the bound; then K1 as the round runs it (select + mask pass), and
    one large launch of the mask pass, K2 and K3."""
    gk, ops, ref = rt.gk, rt.ops, rt.ref
    rng = np.random.default_rng(1)
    n = layout.total
    u, v, m = kernel_inputs(rng, clients, n, dev)
    mask = (torch.tensor(rng.random((clients, n)) > 0.9, device=dev)).float()
    w = torch.ones(clients, device=dev)
    tau = torch.full((clients,), 0.6, device=dev)
    offs, keep, plan = layout.offsets_dev, layout.keep(RATE)[1], layout.select_plan()
    select = lambda: gk.gmf_select_flat(v, m, offsets=offs, plan=plan, keep=keep, w=w, tau=tau,
                                        eps=EPS)
    inv_nv, inv_nm, thr = select()
    scal = dict(inv_norm_v=inv_nv, inv_norm_m=inv_nm, tau=tau, threshold=thr)
    elems = clients * n
    runs = {
        "gmf_select": (select, lambda: ref.gmf_select(v, m, layout, RATE, w=w, tau=tau,
                                                      eps=EPS)),
        "gmf_compress": (lambda: gk.gmf_compress_flat(u, v, m, offsets=offs, **scal),
                         lambda: ref.gmf_compress_segments(u, v, m, layout=layout, **scal)),
        "momentum_correction": (lambda: ops.momentum_correction(u, v, m, 0.9),
                                lambda: ref.momentum_correction_leaf(u, v, m, 0.9)),
        "apply_mask": (lambda: gk.apply_mask_flat(u, v, mask),
                       lambda: ref.apply_mask_update_leaf(u, v, mask)),
    }
    out = {}
    for kid, name, _, bpe, flops in KERNELS:
        kern, plain = runs[name]
        gk.reset_launches()
        kern()
        launched = gk.LAUNCHES[name]
        ms = timed_ms(kern)
        plain_ms = timed_ms(plain)
        nbytes = bpe * elems
        bound_bytes = nbytes / bw * 1e3
        bound_ops = flops * elems / peak * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations")
        pr21 = f" (PR 21: {PR21_MS[name]})" if name in PR21_MS else ""
        print(f"  {kid} {name}: {launched} launch(es), {nbytes / 1e6:.1f} MB, kernel "
              f"{ms:.4f} ms{pr21} ({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
              f"bound {out[name]['bound_ms']:.4f} ms", flush=True)

    def k1_round():
        nv, nm, th = select()
        return gk.gmf_compress_flat(u, v, m, offsets=offs, inv_norm_v=nv, inv_norm_m=nm,
                                    tau=tau, threshold=th)

    k1 = timed_ms(k1_round)
    bound = 36 * elems / bw * 1e3
    print(f"  K1 a round (gmf_select + gmf_compress, host-inclusive): {k1:.4f} ms (PR 21: "
          f"{PR21_MS['k1_round']}), bound {bound:.4f} ms ({36 * elems / 1e6:.1f} MB)", flush=True)
    out["k1_round_ms"] = k1
    k2_dev = k2_device_ms(gk, [u], [v], [m])
    print(f"  K2 momentum_correction device time per call (launches back to back): "
          f"{k2_dev:.4f} ms ({20 * elems / k2_dev / 1e6:.1f} GB/s); the call "
          f"{out['momentum_correction']['ms']:.4f} ms", flush=True)
    # One large launch per elementwise kernel: the bandwidth it reaches when
    # the launch overhead is amortised.
    big = rt.flat.FlatLayout.of(torch.empty(2**24 + 3, device=dev))
    u, v, m = kernel_inputs(rng, 1, big.total, dev)
    mask = (v.abs() > 1.0).float()
    one = dict(inv_norm_v=torch.full((1, 1), 1e-3, device=dev),
               inv_norm_m=torch.full((1, 1), 1e-3, device=dev),
               tau=torch.full((1,), 0.6, device=dev),
               threshold=torch.full((1, 1), 1e-3, device=dev))
    large = {"gmf_compress": (lambda: gk.gmf_compress_flat(u, v, m, offsets=big.offsets_dev,
                                                           **one),
                              lambda: ref.gmf_compress_segments(u, v, m, layout=big, **one)),
             "momentum_correction": (lambda: gk.momentum_correction_flat(u, v, m, 0.9),
                                     lambda: ref.momentum_correction_leaf(u, v, m, 0.9)),
             "apply_mask": (lambda: gk.apply_mask_flat(u, v, mask),
                            lambda: ref.apply_mask_update_leaf(u, v, mask))}
    for kid, name, _, bpe, _ in KERNELS:
        if name not in large:
            continue
        kern, plain = large[name]
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        nb = bpe * big.total
        print(f"  {kid} {name} at {big.total} elements: {nb / 1e6:.1f} MB, kernel {ms:.4f} ms "
              f"({nb / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, bound "
              f"{nb / bw * 1e3:.4f} ms", flush=True)
    return out


def k4_err(got, want):
    """(max abs difference, relative L2 difference, count of elements
    beyond K4_TOL) of K4's output against its plain version's."""
    tol = K4_TOL[want.dtype]
    diff, ref_ = got.float() - want.float(), want.float()
    err = diff.abs()
    bad = (err > tol["atol"] + tol["rtol"] * ref_.abs()).sum().item()
    rel = (diff.norm() / ref_.norm()).item()
    return err.max().item(), rel, bad


def check_k4(got, want, what):
    """Fail unless K4's output is within both K4_TOL and K4_REL_L2 of its
    plain version's; returns (max abs, relative L2)."""
    err, rel, bad = k4_err(got, want)
    check(bad == 0, f"K4 differs from its plain version at {what}: {bad} elements beyond "
          f"{K4_TOL[want.dtype]}, max abs {err:.3e}")
    check(math.isfinite(rel) and rel <= K4_REL_L2[want.dtype],
          f"K4 differs from its plain version at {what}: relative L2 {rel:.3e} > "
          f"{K4_REL_L2[want.dtype]}")
    return err, rel


def hold_k4(k4, ref, dev):
    """Both K4 kernels against their plain version on the card at every
    listed dtype, mask, grouping, head dim and length, each case on the
    kernel ``kernel_for`` names; returns the largest absolute difference
    seen per kernel ({"tc": ..., "cc": ...}), the tensor-core kernel's bf16
    cases at D 112 and 256 apart ("tc_d112", "tc_d256")."""
    rng = np.random.default_rng(4)
    worst = {"tc": 0.0, "cc": 0.0, "tc_d112": 0.0, "tc_d256": 0.0}
    cases = {"tc": 0, "cc": 0}
    worst_rel = {}

    def hold(run, want, kern, what, key=None):
        k4.reset_launches()
        got = run()
        check(k4.LAUNCHES[f"flash_attention_{kern}"] == 1 and k4.LAUNCHES["flash_attention"] == 1,
              f"K4 at {what}: launches {k4.LAUNCHES}, expected one of the {kern} kernel")
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"K4: {got.dtype} {tuple(got.shape)} at {what}")
        err, rel = check_k4(got, want, f"{what} ({kern} kernel)")
        key = key or kern
        worst[key] = max(worst[key], err)
        worst_rel[key, want.dtype] = max(worst_rel.get((key, want.dtype), 0.0), rel)
        cases[kern] += 1

    for t in (1, 64, 1000, 2048):
        for d in (16, 32, 64, 128):
            b = 1 if t == 2048 else 2
            q = torch.tensor(rng.normal(size=(b, t, 8, d)).astype(np.float32), device=dev)
            kf = torch.tensor(rng.normal(size=(b, t, 8, d)).astype(np.float32), device=dev)
            vf = torch.tensor(rng.normal(size=(b, t, 8, d)).astype(np.float32), device=dev)
            for g in (1, 2, 4, 8):
                kv = 8 // g
                for dtype in K4_TOL:
                    qq = q.to(dtype)
                    k, v = kf[:, :, :kv].to(dtype), vf[:, :, :kv].to(dtype)
                    kern = k4.kernel_for(dtype, d)
                    for causal in (True, False):
                        hold(lambda: k4.flash_attention(qq, k, v, causal=causal),
                             ref.flash_attention(qq, k, v, causal=causal), kern,
                             f"B {b} T {t} H 8 KV {kv} D {d} {dtype} causal={causal}")
        print(f"  held K4 at T {t}: D 16/32/64/128 x G 1/2/4/8 x f32/bf16 x causal/not, "
              f"max abs so far tc {worst['tc']:.3e}, cc {worst['cc']:.3e}", flush=True)
    # kimi-k2's head dim 112 and recurrentgemma-9b's 256: bf16 on the
    # tensor-core kernel (D 112 as two 64-column boxes whose last 16 columns
    # TMA fills with zeros), float32 on the CUDA-core kernel; G 1/8/16 at
    # H 16 (16 is MQA), causal and not.
    for t in (1, 64, 1000, 2048):
        for d in (112, 256):
            b = 1 if t == 2048 else 2
            q, kf, vf = (torch.tensor(rng.normal(size=(b, t, 16, d)).astype(np.float32),
                                      device=dev) for _ in range(3))
            for g in (1, 8, 16):
                kv = 16 // g
                for dtype in K4_TOL:
                    qq = q.to(dtype)
                    k, v = kf[:, :, :kv].to(dtype), vf[:, :, :kv].to(dtype)
                    kern = k4.kernel_for(dtype, d)
                    expected = "tc" if dtype == torch.bfloat16 else "cc"
                    check(kern == expected, f"K4 at D {d} {dtype} goes to the {kern} kernel, "
                          f"not the {expected} kernel")
                    for causal in (True, False):
                        hold(lambda: k4.flash_attention(qq, k, v, causal=causal),
                             ref.flash_attention(qq, k, v, causal=causal), kern,
                             f"B {b} T {t} H 16 KV {kv} D {d} {dtype} causal={causal}",
                             f"tc_d{d}" if kern == "tc" else "cc")
        print(f"  held K4 at T {t}: D 112/256 x G 1/8/16 x f32/bf16 x causal/not, max abs so "
              f"far tc D 112 {worst['tc_d112']:.3e}, tc D 256 {worst['tc_d256']:.3e}, cc "
              f"{worst['cc']:.3e}", flush=True)
    # The tensor-core kernel at yi-34b's 7 and command-r-plus-104b's 12 query
    # heads per kv head (D 128, bf16).
    for t in (1000, 2048):
        for h, kv in ((14, 2), (24, 2)):
            q, k, v = (torch.tensor(rng.normal(size=(1, t, n, 128)).astype(np.float32),
                                    device=dev).to(torch.bfloat16) for n in (h, kv, kv))
            for causal in (True, False):
                hold(lambda: k4.flash_attention(q, k, v, causal=causal),
                     ref.flash_attention(q, k, v, causal=causal), "tc",
                     f"B 1 T {t} H {h} KV {kv} (G {h // kv}) D 128 bf16 causal={causal}")
    print(f"  held the tensor-core K4 at G 7 and 12, D 128, T 1000/2048: max abs so far "
          f"{worst['tc']:.3e}", flush=True)
    # The (BH, T, D) interface: strides that are not ordered by size.
    for d in (64, 112, 128, 256):
        q, k, v = (torch.tensor(rng.normal(size=(n, 1000, d)).astype(np.float32),
                                device=dev).to(torch.bfloat16) for n in (16, 4, 4))
        for causal in (True, False):
            hold(lambda: k4.flash_attention_bhsd(q, k, v, causal=causal),
                 ref.flash_attention_bhsd(q, k, v, causal=causal), "tc",
                 f"(BH, T, D) = (16, 1000, {d}), BKV 4, bf16, causal={causal}",
                 f"tc_d{d}" if d in (112, 256) else "tc")
    # No fallback: a bf16 input the tensor maps cannot take raises, at D 64
    # and at the new head dims (head stride D + 4 elements: 136, 232 and
    # 520 bytes, none a multiple of 16).
    for d in (64, 112, 256):
        buf = torch.zeros(2 * 64 * 4 * (d + 4), dtype=torch.bfloat16, device=dev)
        bad = buf.view(2, 64, 4, d + 4)[..., :d]
        k4.reset_launches()
        try:
            k4.flash_attention(bad, bad, bad)
            fail(f"K4 took a bf16 D {d} input whose strides TMA cannot take")
        except ValueError as exc:
            check("tensor-core" in str(exc) and k4.LAUNCHES["flash_attention"] == 0,
                  f"K4 on a misaligned bf16 D {d} input: {exc}; launches {k4.LAUNCHES}")
    torch.cuda.synchronize()
    name = lambda dt: str(dt).split(".")[-1]
    rels = ", ".join(f"{key} {name(dt)} {rel:.3e}" for (key, dt), rel in worst_rel.items())
    bounds = ", ".join(f"{name(dt)} {bound}" for dt, bound in K4_REL_L2.items())
    print(f"  K4: {cases['tc']} cases on the tensor-core kernel, {cases['cc']} on the "
          f"CUDA-core kernel, within tolerance; misaligned bf16 inputs at D 64/112/256 "
          f"raised with no launch; largest "
          f"relative L2 {rels} (bounds {bounds})", flush=True)
    return worst


def k4_cc_past_kernel_for(k4, q, k, v):
    """The CUDA-core K4 on bf16 (B, T, H, D) q and (B, S, KV, D) k, v,
    causal, called past ``kernel_for`` (which sends bf16 at these head dims
    to the tensor-core kernel): a comparison only, counted nowhere."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *o.stride()[:3])
    err = k4.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, d, b, h, kv, t, s,
        strides, d**-0.5, 1, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"CUDA-core K4 launch failed with cudaError_t {err}")
    return o


def time_k4(k4, ref, bw, peak, bf16_peak, dev):
    """K4 at the serving shape (B 4, T 2048, H 32, KV 8, D 64, bf16,
    causal): the tensor-core kernel, the CUDA-core kernel (a bf16
    comparison: ``kernel_for`` never sends it this input), the plain
    version and SDPA (timed only), and the bounds; then the tensor-core
    kernel at D 128 (B 4, T 2048, H 16, KV 2). Returns the numbers of the
    two kernels' rows, each at the shape its launches on the path have."""
    b, t, h, kv, d = 4, 2048, 32, 8, 64
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(b, t, n, d)).astype(np.float32),
                            device=dev).to(torch.bfloat16) for n in (h, kv, kv))

    def old():  # the CUDA-core kernel on the same inputs, called past kernel_for
        return k4_cc_past_kernel_for(k4, q, k, v)

    want = ref.flash_attention(q, k, v)
    err, rel = check_k4(k4.flash_attention(q, k, v), want, "the serving shape (tc kernel)")
    err_cc, rel_cc = check_k4(old(), want, "the serving shape (cc kernel)")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = (lib.float() - want.float()).abs().max().item()
    # in turns: tc, cc, plain, SDPA, then again in reverse
    ms, cc_ms, plain_ms, library_ms = [], [], [], []
    for order in (0, 1):
        runs = [(ms, lambda: k4.flash_attention(q, k, v)), (cc_ms, old),
                (plain_ms, lambda: ref.flash_attention(q, k, v)),
                (library_ms, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))]
        for out, fn in (runs if order == 0 else runs[::-1]):
            out.append(timed_ms(fn))
    ms, cc_ms, plain_ms, library_ms = (min(x) for x in (ms, cc_ms, plain_ms, library_ms))
    pairs = t * (t + 1) // 2  # (query, key) pairs the causal mask keeps
    flops = 4 * b * h * d * pairs  # QK^T and PV, 2 FLOP per multiply-add
    nbytes = 2 * (2 * b * t * h * d + 2 * b * t * kv * d)  # q, o, k, v in bf16
    bound_ops, bound_bytes = flops / bf16_peak * 1e3, nbytes / bw * 1e3
    bound = max(bound_ops, bound_bytes)
    print(f"  K4 at B {b} T {t} H {h} KV {kv} D {d} bf16 causal: tensor-core kernel "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), CUDA-core kernel {cc_ms:.4f} ms "
          f"({flops / cc_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s); "
          f"{flops / 1e9:.2f} GFLOP -> {bound_ops:.4f} ms at {bf16_peak / 1e12:.0f} TFLOP/s, "
          f"{nbytes / 1e6:.1f} MB -> {bound_bytes:.4f} ms; vs plain: tc max abs {err:.3e} "
          f"relative L2 {rel:.3e}, cc max abs {err_cc:.3e} relative L2 {rel_cc:.3e} (bound "
          f"{K4_REL_L2[torch.bfloat16]}), SDPA max abs {lib_err:.3e}; 16 launches per "
          f"prefill: tc {16 * ms:.3f} ms, cc {16 * cc_ms:.3f} ms, bound {16 * bound:.3f} ms "
          f"(the better of 2 medians each, in turns)", flush=True)
    # D 128 (the head dim of the dense configs queued next)
    h2, kv2, d2 = 16, 2, 128
    q2, k2, v2 = (torch.tensor(rng.normal(size=(b, t, n, d2)).astype(np.float32),
                               device=dev).to(torch.bfloat16) for n in (h2, kv2, kv2))
    err2, rel2 = check_k4(k4.flash_attention(q2, k2, v2), ref.flash_attention(q2, k2, v2),
                          "B 4 T 2048 H 16 KV 2 D 128 (tc kernel)")
    ms2 = timed_ms(lambda: k4.flash_attention(q2, k2, v2))
    q2t, k2t, v2t = (x.transpose(1, 2) for x in (q2, k2, v2))
    lib2 = timed_ms(lambda: sdpa(q2t, k2t, v2t, is_causal=True, enable_gqa=True))
    flops2 = 4 * b * h2 * d2 * pairs
    print(f"  K4 at B {b} T {t} H {h2} KV {kv2} D {d2} bf16 causal: tensor-core kernel "
          f"{ms2:.4f} ms ({flops2 / ms2 / 1e9:.1f} TFLOP/s), SDPA {lib2:.4f} ms, bound "
          f"{flops2 / bf16_peak * 1e3:.4f} ms; vs plain max abs {err2:.3e}, relative L2 "
          f"{rel2:.3e}", flush=True)
    tc = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
              bound_by="operations" if bound_ops >= bound_bytes else "bytes",
              library_ms=library_ms, at=f"B {b} T {t} H {h} KV {kv} D {d} bf16 causal")
    cc = time_k4_cc(k4, ref, bw, peak, dev)
    cc["bf16"] = time_k4_cc_bf16(k4, ref, bw, bf16_peak, dev)
    return {"tc": tc, "cc": cc}


def time_k4_cc_bf16(k4, ref, bw, bf16_peak, dev):
    """The CUDA-core K4's bf16 instances at D 16 and 32 (the head dims
    ``kernel_for`` sends there in bf16; the smoke configs' D 32) at phase
    6's prefill shape otherwise (B 2, T 256, H 32, KV 8, causal), each
    beside its plain version, SDPA (a yardstick) and its bound (operations
    at the bf16 peak, or bytes). Returns {D: numbers}."""
    b, t, h, kv = 2, 256, 32, 8
    rng = np.random.default_rng(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for d in (16, 32):
        q, k, v = (torch.tensor(rng.normal(size=(b, t, n, d)).astype(np.float32),
                                device=dev).to(BF16) for n in (h, kv, kv))
        check(k4.kernel_for(q.dtype, d) == "cc", f"bf16 K4 at D {d} is not on the CUDA cores")
        err, rel = check_k4(k4.flash_attention(q, k, v), ref.flash_attention(q, k, v),
                            f"bf16 at D {d} (cc kernel)")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = timed_ms(lambda: k4.flash_attention(q, k, v))
        plain_ms = timed_ms(lambda: ref.flash_attention(q, k, v))
        library_ms = timed_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        flops = 4 * b * h * d * (t * (t + 1) // 2)
        nbytes = 2 * (2 * b * t * h * d + 2 * b * t * kv * d)
        bound_ops, bound_bytes = flops / bf16_peak * 1e3, nbytes / bw * 1e3
        out[d] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_ops, bound_bytes),
                      bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                      library_ms=library_ms, max_abs_err=err, rel_l2=rel,
                      at=f"B {b} T {t} H {h} KV {kv} D {d} bf16 causal")
        print(f"  K4 at B {b} T {t} H {h} KV {kv} D {d} bf16 causal: CUDA-core kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{out[d]['bound_ms']:.4f} ms ({out[d]['bound_by']}); vs plain max abs "
              f"{err:.3e}, relative L2 {rel:.3e}", flush=True)
    return out


def time_k4_cc(k4, ref, bw, peak, dev):
    """The CUDA-core K4 at the shape phase 6's float32 prefill gives it (B 2,
    T 256, H 32, KV 8, D 64, float32, causal), beside its plain version,
    SDPA (a yardstick) and its bound at the float32 CUDA-core peak."""
    b, t, h, kv, d = 2, 256, 32, 8, 64
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(rng.normal(size=(b, t, n, d)).astype(np.float32), device=dev)
               for n in (h, kv, kv))
    check(k4.kernel_for(q.dtype, d) == "cc", "float32 K4 is not on the CUDA-core kernel")
    err, rel = check_k4(k4.flash_attention(q, k, v), ref.flash_attention(q, k, v),
                        "phase 6's float32 shape (cc kernel)")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timed_ms(lambda: k4.flash_attention(q, k, v))
    plain_ms = timed_ms(lambda: ref.flash_attention(q, k, v))
    library_ms = timed_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    flops = 4 * b * h * d * (t * (t + 1) // 2)
    nbytes = 4 * (2 * b * t * h * d + 2 * b * t * kv * d)
    bound_ops, bound_bytes = flops / peak * 1e3, nbytes / bw * 1e3
    print(f"  K4 at B {b} T {t} H {h} KV {kv} D {d} float32 causal (phase 6's prefill): "
          f"CUDA-core kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms; {flops / 1e9:.3f} GFLOP -> "
          f"{bound_ops:.4f} ms at {peak / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB -> "
          f"{bound_bytes:.4f} ms; vs plain max abs {err:.3e}, relative L2 {rel:.3e}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                library_ms=library_ms, at=f"B {b} T {t} H {h} KV {kv} D {d} float32 causal")


# K4's prefill shapes at head dims 256 and 112, bf16 causal (phase 13's
# runs of recurrentgemma-9b and kimi-k2), on the tensor-core kernel.
K4_NEW_DIMS = {"tc_d256": ("recurrentgemma-9b", 4, 2048, 16, 1, 256),
               "tc_d112": ("kimi-k2-1t-a32b", 1, 256, 64, 8, 112)}


def time_k4_new_dims(k4, ref, bw, bf16_peak, dev):
    """The tensor-core K4 at recurrentgemma-9b's and kimi-k2-1t-a32b's
    prefill shapes (bf16, causal), beside the CUDA-core kernel on the same
    inputs called past ``kernel_for`` (where these inputs went before), its
    plain version and SDPA (a yardstick), in turns, and its bound: the
    operations at the bf16 tensor-core peak, or the bytes."""
    rng = np.random.default_rng(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for key, (arch, b, t, h, kv, d) in K4_NEW_DIMS.items():
        q, k, v = (torch.tensor(rng.normal(size=(b, t, n, d)).astype(np.float32),
                                device=dev).to(torch.bfloat16) for n in (h, kv, kv))
        check(k4.kernel_for(q.dtype, d) == "tc", f"K4 at D {d} is not on the tensor-core kernel")
        at = f"B {b} T {t} H {h} KV {kv} D {d} bf16 causal ({arch}'s prefill)"
        want = ref.flash_attention(q, k, v)
        err, rel = check_k4(k4.flash_attention(q, k, v), want, f"{at} (tc kernel)")
        err_cc, rel_cc = check_k4(k4_cc_past_kernel_for(k4, q, k, v), want, f"{at} (cc kernel)")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, cc_ms, plain_ms, library_ms = [], [], [], []
        runs = [(ms, lambda: k4.flash_attention(q, k, v)),
                (cc_ms, lambda: k4_cc_past_kernel_for(k4, q, k, v)),
                (plain_ms, lambda: ref.flash_attention(q, k, v)),
                (library_ms, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))]
        for order in (runs, runs[::-1]):  # in turns
            for sink, fn in order:
                sink.append(timed_ms(fn))
        ms, cc_ms, plain_ms, library_ms = (min(x) for x in (ms, cc_ms, plain_ms, library_ms))
        flops = 4 * b * h * d * (t * (t + 1) // 2)
        nbytes = 2 * (2 * b * t * h * d + 2 * b * t * kv * d)
        bound_ops, bound_bytes = flops / bf16_peak * 1e3, nbytes / bw * 1e3
        bound = max(bound_ops, bound_bytes)
        print(f"  K4 at {at}: tensor-core kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"roofline share {bound / ms:.1%}), CUDA-core kernel {cc_ms:.4f} ms "
              f"({flops / cc_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms; {flops / 1e9:.2f} GFLOP -> {bound_ops:.4f} ms at "
              f"{bf16_peak / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB -> {bound_bytes:.4f} ms; "
              f"vs plain: tc max abs {err:.3e} relative L2 {rel:.3e}, cc max abs {err_cc:.3e} "
              f"relative L2 {rel_cc:.3e} (the better of 2 medians each, in turns)", flush=True)
        out[key] = dict(ms=ms, cc_ms=cc_ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                        library_ms=library_ms, at=at)
    return out


# ---------------------------------------------------------------------------
# path phases
# ---------------------------------------------------------------------------


def run_path(rt, task, scheme_kw, rounds, clients, batch, launches, lr=0.1, per_round=0,
             before=None, **fl_kw):
    """``rounds`` rounds of the FL path; the kernels' launch counts are
    reset just before and read just after, and added into ``launches``.
    ``before(sim)``, if given, runs on the simulator before its rounds;
    ``fl_kw`` are more ``FLConfig`` fields (the backend, the topology)."""
    comp = rt.core.CompressionConfig(rate=0.1, **scheme_kw)
    fl = rt.fl.FLConfig(num_clients=clients, clients_per_round=per_round, rounds=rounds,
                        batch_size=batch, learning_rate=lr, eval_every=rounds, **fl_kw)
    sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, task.eval_fn,
                            device=task.device)
    if before is not None:
        before(sim)
    rt.gk.reset_launches()
    hist = sim.run(task.batch_provider(batch))
    torch.cuda.synchronize()
    counts = dict(rt.gk.LAUNCHES)
    for name, n in counts.items():
        launches[name] += n
    return sim, hist, counts


def check_ledger(rt, sim, hist, label):
    """The ledger's bytes against the CostModel's on the read-back counts:
    per-client upload nnz (at 1 byte a value for a client the rate
    controller dropped to int8), the broadcast's nnz unicast to each."""
    cost = sim.engine.scheme.cost_model()
    up = down = 0.0
    for rec in hist:
        nnz = np.asarray(rec["upload_nnz"], np.float64)
        vb = None
        if "wire_levels" in rec:
            vb = np.where(np.asarray(rec["wire_levels"]) > 0, 1.0, float(cost.value_bytes))
        u, d = cost.round_bytes(nnz, rec["download_nnz"], sim.total_params, len(nnz), vb)
        up += float(u)
        down += float(d)
    check(up == sim.ledger.upload_bytes and down == sim.ledger.download_bytes,
          f"{label}: ledger {sim.ledger.upload_bytes} / {sim.ledger.download_bytes} bytes, "
          f"the cost model on the read-back nnz {up} / {down}")


def path_phase(rt, dev):
    data = rt.synthetic.SynthCIFAR(num_train=20000)
    task = rt.fl.CifarTask(num_clients=20, depth=56, data=data, device=dev)
    launches = {name: 0 for name in rt.gk.LAUNCHES}
    # Launches per round: one of each kernel of the preset's path, over the
    # flat [20, N] stacks of all clients and leaves.
    expect = {
        "dgcwgmf": ({"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True},
                    {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1,
                     "apply_mask": 0}),
        "dgc": ({"scheme": "dgc"},
                {"gmf_select": 1, "gmf_compress": 0, "momentum_correction": 1,
                 "apply_mask": 1}),
    }
    for label, (kw, per_round) in expect.items():
        t0 = time.perf_counter()
        sim, hist, counts = run_path(rt, task, kw, 3, 20, 64, launches)
        leaves = rt.utils.tree_leaves(sim.params)
        leaf_shapes = [tuple(x.shape) for x in leaves]
        check(len(leaves) == RESNET56_LEAVES == sim.layout.num_leaves,
              f"{len(leaves)} leaves, expected 169")
        check(sim.total_params == RESNET56_PARAMS, f"{sim.total_params} params")
        keep = sum(rt.sparsify.num_keep(math.prod(s), 0.1) for s in leaf_shapes)
        check(keep == RESNET56_KEEP, f"exact-k sum {keep}, expected {RESNET56_KEEP}")
        for rec in hist:
            nnz = rec["upload_nnz"]
            check(len(nnz) == 20 and min(nnz) >= keep,
                  f"{label} round {rec['round']}: upload nnz {nnz} below {keep}")
        check(all(bool(torch.isfinite(x).all()) for x in leaves), f"{label}: params not finite")
        want = {k: 3 * v for k, v in per_round.items()}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        ms = [round(r["round_ms"], 3) for r in hist[1:]]
        print(f"  {label}: launches {counts}; upload nnz per client (round 0) "
              f"{hist[0]['upload_nnz']}; ms/round after round 0 {ms}; ledger "
              f"{json.dumps(sim.ledger.summary())}; accuracy {sim.final_accuracy()}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, task


RESNET_PROFILE = (("dgcwgmf", {"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True}),
                  ("dgc", {"scheme": "dgc"}))
# The engine's names for a round's phases (obs.trace.annotate_scope).
ROUND_PHASES = ("round.client_grads", "round.client_compress", "round.server_aggregate",
                "round.apply_update")


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_split(prof, ranges=ROUND_PHASES):
    """The device side of a ``torch.profiler`` trace: (device activities,
    the device's busy ms as the union of their intervals (no overlap
    counted twice), {range: (ms of the kernels launched inside the host
    range, busy ms in the range's device window)}) for each name in
    ``ranges`` the trace holds.

    A range's device window runs from the device start of the first kernel
    launched inside it to that of the next range's (the last range's ends
    with its own last kernel). On one stream the kernels run in launch
    order, so the windows share out the device's time between the phases,
    including kernels launched from other host threads: the autograd
    engine launches a CUDA backward from its own device thread, outside
    the caller's host range."""
    acts, device_ranges, launched = [], {}, {}
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False):
                acts.append(iv)
            elif e.name in ranges:
                device_ranges.setdefault(e.name, []).append(iv)
        elif e.name in ranges:
            launched[e.name] = launched.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = merged(acts)
    starts = {name: min(lo for lo, _ in ivs) for name, ivs in device_ranges.items()}
    order = sorted(starts, key=starts.get)
    window = {}
    for i, name in enumerate(order):
        end = (starts[order[i + 1]] if i + 1 < len(order)
               else max(hi for _, hi in device_ranges[name]))
        window[name] = overlap(busy, [[starts[name], end]]) / 1e3
    split = {name: (launched[name], window.get(name, float("nan")))
             for name in ranges if name in launched}
    return len(acts), sum(hi - lo for lo, hi in busy) / 1e3, split


def profile_round(sim, provide):
    """One more round of ``sim`` under ``torch.profiler``: (host ms of the
    profiled round, the profile)."""
    from torch.profiler import ProfilerActivity, profile

    sim.fl.rounds = 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(provide)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, prof


def print_split(split):
    for name, (inside, window) in split.items():
        print(f"    {name}: device busy in its window {window:.3f} ms (kernels launched from "
              f"inside its host range {inside:.3f} ms)", flush=True)


def profile_phase(rt, task, presets=RESNET_PROFILE, clients=20, per_round=0, batch=64,
                  lr=0.1):
    """Where a round's time goes: in 3 steady rounds, the client-gradient
    share (host clock around ``engine._grads`` inside the round, with a
    synchronise on each side), and a ``torch.profiler`` trace of one more
    round: the device's busy share (the union of its activities'
    intervals), the device time under each of the engine's phase ranges
    and the costliest kernels. Returns {preset: numbers}."""
    out = {}
    for label, kw in presets:
        comp = rt.core.CompressionConfig(rate=0.1, **kw)
        fl = rt.fl.FLConfig(num_clients=clients, clients_per_round=per_round, rounds=2,
                            batch_size=batch, learning_rate=lr)
        sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=task.device)
        provide = task.batch_provider(batch)
        sim.run(provide)  # warm-up rounds
        grads_ms, grads = [], sim.engine._grads

        def timed_grads(params, batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = grads(params, batches)
            torch.cuda.synchronize()
            grads_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        sim.engine._grads = timed_grads
        sim.fl.rounds = 3
        hist = sim.run(provide)
        sim.engine._grads = grads
        round_ms = statistics.median(r["round_ms"] for r in hist[-3:])
        wall, prof = profile_round(sim, provide)
        launched, busy, split = device_split(prof)
        # device-side rows only (kernels, copies, fills), not the ranges: the
        # operator rows carry their kernels' time too and would count it twice
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)]
        top = sorted(kernels, key=device_us, reverse=True)[:12]
        grads = statistics.median(grads_ms)
        grads_dev = split.get("round.client_grads", (float("nan"),) * 2)
        print(f"  {label}: round {round_ms:.3f} ms (median of 3), client grads "
              f"{grads:.3f} ms (host clock, synchronised), the rest (compression, "
              f"aggregation, update) {round_ms - grads:.3f} ms; profiled round {wall:.3f} ms "
              f"with {launched} device activities, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f} % of the profiled round, the union of the "
              f"activities' intervals); device time in round.client_grads's window "
              f"{grads_dev[1]:.3f} ms ({grads_dev[0]:.3f} ms launched from inside its host "
              f"range)", flush=True)
        print_split(split)
        for e in top:
            print(f"    {device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
        out[label] = dict(round_ms=round_ms, grads_ms=grads, activities=launched,
                          busy_share=busy / wall, split=split)
    return out


def card_vs_cpu_phase(rt, dev, tol=1e-2):
    data = rt.synthetic.SynthCIFAR(num_train=2000, num_test=200)
    out = {}
    for device in (dev, "cpu"):
        task = rt.fl.CifarTask(num_clients=8, depth=8, data=data, device=device)
        comp = rt.core.CompressionConfig(scheme="dgcwgmf", rate=0.1, tau=0.6, use_kernels=True)
        fl = rt.fl.FLConfig(num_clients=8, rounds=1, batch_size=32, learning_rate=0.1)
        sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=device)
        hist = sim.run(task.batch_provider(32))
        out[device if device == "cpu" else "cuda"] = (hist[0]["upload_nnz"], sim.gbar_prev.cpu())
    (nnz_g, b_g), (nnz_c, b_c) = out["cuda"], out["cpu"]
    check(nnz_g == nnz_c, f"card vs CPU upload nnz differ: {nnz_g} vs {nnz_c}")
    rel = float((b_g - b_c).norm() / b_c.norm())
    check(math.isfinite(rel) and rel <= tol,
          f"card vs CPU broadcast relative L2 {rel:.3e} > {tol}")
    flips = int(((b_g != 0) != (b_c != 0)).sum())
    print(f"  card vs CPU: upload nnz equal {nnz_g}; broadcast relative L2 {rel:.3e} "
          f"(tolerance {tol}); support flips {flips}", flush=True)


# The paper's Shakespeare preset (benchmarks/common.py:run_shakespeare):
# 100 clients of 4,000 chars, sequences of 80, 10 clients a round, batch 8,
# lr 0.5, the char-LSTM at hidden 256 (292,560 params in 6 leaves).
SHAKESPEARE = dict(clients=100, per_round=10, batch=8, lr=0.5)
LSTM_LEAVES, LSTM_PARAMS, LSTM_KEEP = 6, 292_560, 29_258
SHAKESPEARE_PRESETS = {
    "dgc": ({"scheme": "dgc"},
            {"gmf_select": 1, "gmf_compress": 0, "momentum_correction": 1, "apply_mask": 1}),
    "gmc": ({"scheme": "gmc"},
            {"gmf_select": 1, "gmf_compress": 0, "momentum_correction": 0, "apply_mask": 0}),
    "dgcwgm": ({"scheme": "dgcwgm"},
               {"gmf_select": 1, "gmf_compress": 0, "momentum_correction": 1, "apply_mask": 1}),
    "dgcwgmf": ({"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True},
                {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1, "apply_mask": 0}),
}


def state_tensors(rt, sim):
    """Everything a round leaves behind, as named tensors."""
    out = {f"params/{i}": x for i, x in enumerate(rt.utils.tree_leaves(sim.params))}
    for name, x in zip(("u", "v", "m"), sim.cstates, strict=True):
        if torch.is_tensor(x):
            out[f"client/{name}"] = x
    for name, x in zip(("momentum", "residual"), sim.sstate, strict=True):
        if torch.is_tensor(x):
            out[f"server/{name}"] = x
        elif isinstance(x, dict):  # the sketch's s_mom and s_err
            out.update({f"server/{name}/{k}": v for k, v in x.items()})
    out["gbar_prev"] = sim.gbar_prev
    return out


def shakespeare_phase(rt, dev):
    """The Shakespeare path at the paper's preset, full width: 3 rounds of
    each preset with its launch counts and nnz, then round 0 twice from
    the same state, bitwise equal. Returns (launches, task)."""
    t0 = time.perf_counter()
    data = rt.synthetic.SynthShakespeare(num_clients=SHAKESPEARE["clients"],
                                         chars_per_client=4000, seq_len=80, seed=0)
    task = rt.fl.ShakespeareTask(num_clients=SHAKESPEARE["clients"], data=data, device=dev)
    print(f"  SynthShakespeare: {SHAKESPEARE['clients']} clients x 4000 chars, "
          f"{int(task.counts.sum())} sequences of 80, measured EMD {task.measured_emd:.4f}; "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {name: 0 for name in rt.gk.LAUNCHES}
    run_kw = dict(clients=SHAKESPEARE["clients"], batch=SHAKESPEARE["batch"],
                  lr=SHAKESPEARE["lr"], per_round=SHAKESPEARE["per_round"])
    for label, (kw, per_round) in SHAKESPEARE_PRESETS.items():
        t0 = time.perf_counter()
        sim, hist, counts = run_path(rt, task, kw, 3, launches=launches, **run_kw)
        sizes = sim.layout.sizes
        check(sim.layout.num_leaves == LSTM_LEAVES and sim.total_params == LSTM_PARAMS,
              f"LSTM layout: {sim.layout.num_leaves} leaves, {sim.total_params} params")
        keep = sum(rt.sparsify.num_keep(n, 0.1) for n in sizes)
        check(keep == LSTM_KEEP, f"LSTM exact-k sum {keep}, expected {LSTM_KEEP}")
        for rec in hist:
            nnz = rec["upload_nnz"]
            check(len(nnz) == SHAKESPEARE["per_round"] and min(nnz) >= keep,
                  f"Shakespeare {label} round {rec['round']}: upload nnz {nnz} below {keep}")
        check(all(bool(torch.isfinite(x).all()) for x in rt.utils.tree_leaves(sim.params)),
              f"Shakespeare {label}: params not finite")
        want = {k: 3 * v for k, v in per_round.items()}
        check(counts == want, f"Shakespeare {label}: launches {counts}, expected {want}")
        check_ledger(rt, sim, hist, f"Shakespeare {label}")
        state_mb = sum(x.numel() * 4 for x in sim.cstates if torch.is_tensor(x)) / 1e6
        fields = ", ".join(n for n, x in zip("uvm", sim.cstates, strict=True)
                           if torch.is_tensor(x))
        ms = [round(r["round_ms"], 3) for r in hist]
        del sim
        # round 0 twice from the same state: the same bits (the embedding's
        # gradient and every reduction of the round are deterministic)
        runs = []
        for _ in range(2):
            again, h0, _ = run_path(rt, task, kw, 1, launches={n: 0 for n in launches},
                                    **run_kw)
            runs.append(({k: v.clone() for k, v in state_tensors(rt, again).items()},
                         h0[0]["upload_nnz"], h0[0]["download_nnz"]))
            del again
        (a, nnz_a, down_a), (b, nnz_b, down_b) = runs
        check(nnz_a == nnz_b == hist[0]["upload_nnz"] and down_a == down_b,
              f"Shakespeare {label}: round 0 twice gave nnz {nnz_a} / {nnz_b}")
        for key in a:
            check(torch.equal(a[key], b[key]), f"Shakespeare {label}: round 0 twice differs "
                  f"in {key} (max abs {(a[key] - b[key]).abs().max().item():.3e})")  # repro-noqa: REP004 (the phase's clock; a check's message)
        print(f"  {label}: launches {counts}; upload nnz per client (round 0) "
              f"{hist[0]['upload_nnz']}; ms/round {ms} (round 0 first); ledger "
              f"{json.dumps(sim_summary(hist))}; flat client state ({fields}) {state_mb:.1f} MB; "
              f"round 0 twice bitwise equal ({len(a)} tensors); "
              f"{time.perf_counter() - t0:.1f} s",
              flush=True)
    return launches, task


def sim_summary(hist):
    return {"rounds": len(hist), "comm_gb": hist[-1]["comm_gb"],
            "accuracy": hist[-1].get("accuracy")}


def shakespeare_card_vs_cpu_phase(rt, dev, clients=10, per_round=4, tol=1e-2):
    """Round 0 of ``dgcwgmf`` (fused) on the char-LSTM at full width, 10
    clients (4 a round), on the card and with ``device="cpu"`` from the same
    params and batches: upload nnz equal, broadcast within ``tol``
    relative L2 (the ResNet phase's)."""
    data = rt.synthetic.SynthShakespeare(num_clients=clients, chars_per_client=4000, seed=0)
    out = {}
    for device in (dev, "cpu"):
        task = rt.fl.ShakespeareTask(num_clients=clients, data=data, device=device)
        comp = rt.core.CompressionConfig(scheme="dgcwgmf", rate=0.1, tau=0.6, use_kernels=True)
        fl = rt.fl.FLConfig(num_clients=clients, clients_per_round=per_round, rounds=1,
                            batch_size=SHAKESPEARE["batch"], learning_rate=SHAKESPEARE["lr"])
        sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=device)
        hist = sim.run(task.batch_provider(SHAKESPEARE["batch"]))
        out[device if device == "cpu" else "cuda"] = (hist[0]["upload_nnz"], sim.gbar_prev.cpu())
    (nnz_g, b_g), (nnz_c, b_c) = out["cuda"], out["cpu"]
    check(nnz_g == nnz_c, f"Shakespeare card vs CPU upload nnz differ: {nnz_g} vs {nnz_c}")
    rel = float((b_g - b_c).norm() / b_c.norm())
    check(math.isfinite(rel) and rel <= tol,
          f"Shakespeare card vs CPU broadcast relative L2 {rel:.3e} > {tol}")
    flips = int(((b_g != 0) != (b_c != 0)).sum())
    print(f"  card vs CPU (char-LSTM, hidden 256, {per_round} of {clients} clients): upload nnz "
          f"equal {nnz_g}; broadcast relative L2 {rel:.3e} (tolerance {tol}); support flips "
          f"{flips}", flush=True)


# The ResNet-56 path under the other stage kinds: the int8 and bf16 wires,
# the top-k downlink (one more gmf_select launch a round, on the [1, N]
# broadcast) and per-client rates (the staged path: K2, gmf_select in its
# |z| mode with a [k, L] keep table, K3).
RESNET_PRESETS = {
    "dgcwgmf, int8 wire": ({"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True,
                            "wire_dtype": "int8"},
                           {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1,
                            "apply_mask": 0}),
    "dgcwgmf, bf16 wire": ({"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True,
                            "wire_dtype": "bfloat16"},
                           {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1,
                            "apply_mask": 0}),
    "dgcwgmf_dl": ({"scheme": "dgcwgmf_dl", "tau": 0.6, "use_kernels": True},
                   {"gmf_select": 2, "gmf_compress": 1, "momentum_correction": 1,
                    "apply_mask": 0}),
    "adaptive_dgcwgmf": ({"scheme": "adaptive_dgcwgmf", "tau": 0.6, "use_kernels": True,
                          "rate_wire_threshold": 0.5},
                         {"gmf_select": 1, "gmf_compress": 0, "momentum_correction": 1,
                          "apply_mask": 1}),
}


def resnet_presets_phase(rt, task):
    """2 rounds of each of ``RESNET_PRESETS`` on ResNet-56 (20 clients,
    batch 64): launch counts, nnz against the exact-k sums (per client at
    its own rate under the controller), the ledger against the cost model,
    and for the controller some client on the int8 wire."""
    launches = {name: 0 for name in rt.gk.LAUNCHES}
    for label, (kw, per_round) in RESNET_PRESETS.items():
        t0 = time.perf_counter()
        sim, hist, counts = run_path(rt, task, kw, 2, 20, 64, launches)
        want = {k: 2 * v for k, v in per_round.items()}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        sizes = np.asarray(sim.layout.sizes, np.float32)
        for rec in hist:
            # num_keep_dynamic in float32 at each client's rate, or num_keep
            keep = ([int(np.clip(np.ceil(np.float32(r) * sizes), 1, sizes).sum())
                     for r in rec["rates"]] if "rates" in rec else [RESNET56_KEEP] * 20)
            check(all(n >= k for n, k in zip(rec["upload_nnz"], keep, strict=True)),
                  f"{label} round {rec['round']}: upload nnz {rec['upload_nnz']} below the "
                  f"exact-k sums {keep}")
        if "dl" in label:
            check(all(r["download_nnz"] >= RESNET56_KEEP for r in hist),
                  f"{label}: download nnz {[r['download_nnz'] for r in hist]}")
        if "adaptive" in label:
            check(any(1 in r["wire_levels"] for r in hist), f"{label}: no client dropped to int8")
            check(any(r["rate_mean"] != np.float32(0.1) for r in hist[1:]),
                  f"{label}: rates never moved: {[r['rate_mean'] for r in hist]}")
        check(all(bool(torch.isfinite(x).all()) for x in rt.utils.tree_leaves(sim.params)),
              f"{label}: params not finite")
        check_ledger(rt, sim, hist, label)
        extra = ""
        if "adaptive" in label:
            extra = (f"; rates round 1 {[round(r, 4) for r in hist[1]['rates']]}; wire levels "
                     f"{[r['wire_levels'] for r in hist]}")
        print(f"  {label}: launches {counts}; upload nnz (round 1) {hist[1]['upload_nnz']}; "
              f"download nnz {[r['download_nnz'] for r in hist]}; ledger "
              f"{json.dumps(sim.ledger.summary())}{extra}; ms/round "
              f"{[round(r['round_ms'], 3) for r in hist]}; {time.perf_counter() - t0:.1f} s",
              flush=True)
    return launches


# The ResNet-56 path under the remaining stage kinds: random-k (its mask
# shared by every client), FetchSGD at benchmarks/ablations.py:176's
# settings (a 5 x 20,000 sketch, k_frac 0.02), the probquant wire on the
# fused dgcwgmf path and the Hadamard rotation ahead of the int8 wire on
# dgc's staged path. randomk (ef) and fetchsgd launch none of K1-K3.
REMAINING = {
    "randomk": ({"scheme": "randomk"},
                {"gmf_select": 0, "gmf_compress": 0, "momentum_correction": 0,
                 "apply_mask": 0}),
    "fetchsgd": ({"scheme": "fetchsgd", "sketch_rows": 5, "sketch_cols": 20_000,
                  "sketch_k_frac": 0.02},
                 {"gmf_select": 0, "gmf_compress": 0, "momentum_correction": 0,
                  "apply_mask": 0}),
    "dgcwgmf, probquant wire": ({"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True,
                                 "wire_dtype": "probquant"},
                                {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1,
                                 "apply_mask": 0}),
    "dgc, hadamard + int8 wire": ({"scheme": "dgc", "rotation_stage": "hadamard",
                                   "wire_dtype": "int8"},
                                  {"gmf_select": 1, "gmf_compress": 0,
                                   "momentum_correction": 1, "apply_mask": 1}),
}
# FetchSGD at ResNet-56: 5 x 20,000 sketch values up a client; k =
# int(0.02 * 855,578) heavy hitters down, 8 bytes each, to 20 clients.
# Hadamard: the 169 leaves padded to powers of two cross the wire dense.
FETCHSGD_UPLOAD, FETCHSGD_K, HADAMARD_WIRE = 100_000, 17_111, 1_515_504
RANDOMK_SIGMA = math.sqrt(RESNET56_PARAMS * 0.1 * 0.9)  # ~277: binomial(N, 0.1)


@contextlib.contextmanager
def recording(obj, method, sink):
    """Append every result of ``obj.method`` to ``sink`` while inside."""
    inner = getattr(obj, method)

    def record(*args, **kwargs):
        out = inner(*args, **kwargs)
        sink.append(out)
        return out

    setattr(obj, method, record)
    try:
        yield sink
    finally:
        delattr(obj, method)


def capture_payloads(sink):
    """A ``run_path`` hook: every round's ``[k, ·]`` payload stack into ``sink``."""
    def before(sim):
        inner = sim.engine._compress_stack

        def capture(*args, **kwargs):
            out = inner(*args, **kwargs)
            sink.append(out[0].clone())
            return out

        sim.engine._compress_stack = capture

    return before


def ternary_per_block(payload, layout, block=256):
    """Is every value of each row's 256-blocks of each leaf in {-s, 0, +s},
    s the block's largest magnitude?"""
    nblocks, idx = layout.blocks(block)
    mag = payload.abs()
    amax = torch.zeros(payload.shape[0], nblocks, device=payload.device).scatter_reduce_(
        1, idx.expand(payload.shape[0], -1), mag, "amax")
    return bool(((payload == 0) | (mag == amax.index_select(1, idx))).all())


def remaining_stages_phase(rt, task):
    """2 rounds of each of ``REMAINING`` on ResNet-56 (20 clients, batch 64),
    each preset's checks, then FetchSGD's round 0 twice bitwise. Returns
    (launches, ms/round after round 0 per preset)."""
    launches = {name: 0 for name in rt.gk.LAUNCHES}
    stages, ms_after = rt.stages, {}
    for label, (kw, per_round) in REMAINING.items():
        t0 = time.perf_counter()
        masks, payloads = [], []
        with recording(stages.get_stage("selector", "randomk"), "select", masks):
            sim, hist, counts = run_path(rt, task, kw, 2, 20, 64, launches,
                                         before=capture_payloads(payloads))
        want = {k: 2 * v for k, v in per_round.items()}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        check(all(bool(torch.isfinite(x).all()) for x in rt.utils.tree_leaves(sim.params)),
              f"{label}: params not finite")
        check_ledger(rt, sim, hist, label)
        nnz = [r["upload_nnz"] for r in hist]
        extra = ""
        if label == "randomk":
            check(len(masks) == 2, f"randomk: {len(masks)} selections in 2 rounds")
            for t, (m, n) in enumerate(zip(masks, nnz, strict=True)):
                check(bool((m == m[0:1]).all()), f"randomk round {t}: client masks differ")
                check(len(set(n)) == 1 and n[0] == int(m[0].sum()),
                      f"randomk round {t}: upload nnz {n} not each client's shared mask's")
                check(abs(n[0] - 0.1 * RESNET56_PARAMS) <= 5 * RANDOMK_SIGMA,
                      f"randomk round {t}: density {n[0]} outside 0.1 N +- 5 sigma")
            check(not torch.equal(masks[0][0], masks[1][0]), "randomk: the same mask twice")
            extra = f"; nnz/N {[round(n[0] / RESNET56_PARAMS, 5) for n in nnz]}"
        elif label == "fetchsgd":
            check(all(n == [FETCHSGD_UPLOAD] * 20 for n in nnz), f"fetchsgd: upload nnz {nnz}")
            check(all(r["download_nnz"] == FETCHSGD_K for r in hist),
                  f"fetchsgd: download nnz {[r['download_nnz'] for r in hist]}")
            check(sim.ledger.upload_bytes == 2 * 8_000_000.0
                  and sim.ledger.download_bytes == 2 * 2_737_760.0,
                  f"fetchsgd: ledger {sim.ledger.upload_bytes} / {sim.ledger.download_bytes} "
                  f"bytes in 2 rounds, expected 16,000,000 / 5,475,520")
            check(all(p.shape == (20, FETCHSGD_UPLOAD) for p in payloads),
                  f"fetchsgd: payload stacks {[tuple(p.shape) for p in payloads]}")
            server = sim.sstate.momentum
            check(all(bool(torch.isfinite(server[k]).all()) and server[k].shape == (5, 20_000)
                      for k in ("s_mom", "s_err")), "fetchsgd: s_mom / s_err")
            check(sim.cstates == rt.core.ClientState(u={}, v={}, m={}),
                  "fetchsgd: the client state is not empty")
            extra = "; " + fetchsgd_repeats(rt, task, kw)
        elif label.startswith("dgcwgmf"):
            check(sim.engine.scheme.cost_model().value_bytes == 0.25,
                  "probquant: not charged 0.25 byte a value")
            check(all(ternary_per_block(p, sim.layout) for p in payloads),
                  "probquant: a payload value outside {-s, 0, +s} of its block")
            check(all(min(n) >= RESNET56_KEEP for n in nnz),
                  f"probquant: upload nnz {nnz} below {RESNET56_KEEP}")
            sent = [float((p != 0).float().mean()) for p in payloads]
            extra = f"; share of payload values sent (nonzero) {[round(x, 5) for x in sent]}"
        else:
            check(all(n == [HADAMARD_WIRE] * 20 for n in nnz), f"hadamard: upload nnz {nnz}")
            dense = 2 * 20 * RESNET56_PARAMS * 1.0  # the int8 wire's dense charge
            check(sim.ledger.upload_bytes == dense,
                  f"hadamard: upload {sim.ledger.upload_bytes} bytes, the dense charge {dense}")
        ms_after[label] = [r["round_ms"] for r in hist[1:]]
        print(f"  {label}: launches {counts}; upload nnz (round 1) {nnz[1][:3]}...; download "
              f"nnz {[r['download_nnz'] for r in hist]}; ledger "
              f"{json.dumps(sim.ledger.summary())}{extra}; ms/round "
              f"{[r['round_ms'] for r in hist]}; {time.perf_counter() - t0:.1f} s", flush=True)
        del sim, payloads, masks
    return launches, ms_after


def fetchsgd_repeats(rt, task, kw):
    """FetchSGD's round 0 twice from the same initial state: params, the
    sketch-space state and the broadcast bitwise equal. cuDNN runs its
    deterministic algorithms for the checked pair: its default fp32
    weight-gradient kernel sums with atomics. A pair with cuDNN's default
    algorithms is reported, not checked."""
    def pair():
        runs = []
        for _ in range(2):
            again, h0, _ = run_path(rt, task, kw, 1, 20, 64, {n: 0 for n in rt.gk.LAUNCHES})
            runs.append(({k: v.clone() for k, v in state_tensors(rt, again).items()},
                         h0[0]["download_nnz"]))
            del again
        return runs

    (a, _), (b, _) = pair()
    default_equal = sum(torch.equal(a[key], b[key]) for key in a)
    torch.backends.cudnn.deterministic = True
    (a, down_a), (b, down_b) = pair()
    torch.backends.cudnn.deterministic = False
    check(down_a == down_b == FETCHSGD_K, f"fetchsgd: round 0 twice gave {down_a} / {down_b}")
    for key in a:
        check(torch.equal(a[key], b[key]), f"fetchsgd: round 0 twice differs in {key} "
              f"(max abs {(a[key] - b[key]).abs().max().item():.3e})")
    return (f"round 0 twice bitwise equal ({len(a)} tensors, cuDNN deterministic; with "
            f"cuDNN's default algorithms {default_equal} of {len(a)} equal)")


def remaining_card_vs_cpu_phase(rt, dev, tol=1e-2):
    """Round 0 of each of ``REMAINING`` at depth 8 (8 clients, batch 32) on
    the card and the CPU: the keyed draws (randomk's uniforms, probquant's
    keep draws, the Hadamard diagonal) and randomk's masks bitwise equal;
    fetchsgd's and hadamard's broadcasts within ``tol`` relative L2
    (phase 4's)."""
    data = rt.synthetic.SynthCIFAR(num_train=2000, num_test=200)
    stages = rt.stages
    draw_of = {"randomk": (stages.get_stage("selector", "randomk"), "uniforms"),
               "dgcwgmf, probquant wire": (stages.get_stage("wire", "probquant"), "uniforms"),
               "dgc, hadamard + int8 wire": (stages.get_stage("rotation", "hadamard"),
                                             "diagonal")}
    for label, (kw, _) in REMAINING.items():
        out = {}
        for side, device in (("cuda", dev), ("cpu", "cpu")):
            task = rt.fl.CifarTask(num_clients=8, depth=8, data=data, device=device)
            comp = rt.core.CompressionConfig(rate=0.1, **kw)
            fl = rt.fl.FLConfig(num_clients=8, rounds=1, batch_size=32, learning_rate=0.1)
            sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=device)
            drawn, masks = [], []
            obj, method = draw_of.get(label, (None, None))
            with contextlib.ExitStack() as stack:
                if obj is not None:
                    stack.enter_context(recording(obj, method, drawn))
                stack.enter_context(recording(stages.get_stage("selector", "randomk"),
                                              "select", masks))
                hist = sim.run(task.batch_provider(32))
            out[side] = (hist[0]["upload_nnz"], sim.gbar_prev.cpu(),
                         [d.cpu() for d in drawn + masks])
        (nnz_g, b_g, d_g), (nnz_c, b_c, d_c) = out["cuda"], out["cpu"]
        rel = float((b_g - b_c).norm() / b_c.norm())
        check(math.isfinite(rel), f"{label}: card vs CPU broadcast not finite")
        if label in draw_of:
            check(len(d_g) == len(d_c) > 0 and all(torch.equal(x, y) for x, y in
                                                   zip(d_g, d_c, strict=True)),
                  f"{label}: the draws differ between the card and the CPU")
        if label in ("fetchsgd", "dgc, hadamard + int8 wire"):
            check(rel <= tol, f"{label}: card vs CPU broadcast relative L2 {rel:.3e} > {tol}")
        if label == "randomk":
            check(nnz_g == nnz_c, f"randomk: card vs CPU nnz {nnz_g} vs {nnz_c}")
        print(f"  {label}: card vs CPU upload nnz equal {nnz_g == nnz_c}; broadcast relative "
              f"L2 {rel:.3e}; draws compared bitwise: {len(d_g)} tensors", flush=True)


# ---------------------------------------------------------------------------
# phase 11: the async, ring, hierarchical and shard engines
# ---------------------------------------------------------------------------

# dgcwgmf's fused path (gmf_select + K1's mask pass + K2) and dgc's staged
# one (K2 + gmf_select's |z| mode + K3), each launch once per compression
# call: once an async dispatch, once a ring hop, once a hierarchical tier.
ENGINE_DGCWGMF = {"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True}
FUSED = {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1, "apply_mask": 0}
STRAGGLERS = dict(delay_model="geometric", delay_mean=1.0, delay_max=4, dropout_rate=0.1)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside (its default fp32 weight
    gradient sums with atomics, ROADMAP R8), its default restored after."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def capture(method, sink):
    """A ``run_path`` hook: every result of ``sim.engine.<method>`` into ``sink``."""
    def before(sim):
        inner = getattr(sim.engine, method)

        def record(*args, **kwargs):
            out = inner(*args, **kwargs)
            sink.append(out)
            return out

        setattr(sim.engine, method, record)

    return before


def times(counts, n):
    return {k: n * v for k, v in counts.items()}


def same_state(rt, a, b, label):
    """Every tensor two runs leave (params, client and server state,
    broadcast) bitwise equal."""
    sa, sb = state_tensors(rt, a), state_tensors(rt, b)
    check(sa.keys() == sb.keys(), f"{label}: state {sorted(sa)} vs {sorted(sb)}")
    for key in sa:
        check(torch.equal(sa[key], sb[key]), f"{label}: differs in {key} (max abs "
              f"{(sa[key] - sb[key]).abs().max().item():.3e})")
    return len(sa)


def plain_schedule(rt, fl_kw, seed, k, ticks, buffer):
    """The async queue by hand, from the engine's own availability draws
    (``np.random.default_rng(seed + 2)``, delays then dropouts each tick):
    arrivals in (tick, dispatch) order, a flush per ``buffer`` waiting. Per
    tick: (arrived, dropped, each flush's gaps, pending, in flight)."""
    avail = rt.fl.Availability(model=fl_kw["delay_model"], mean=fl_kw["delay_mean"],
                               max_delay=fl_kw["delay_max"], dropout=fl_kw["dropout_rate"])
    rng = np.random.default_rng(seed + 2)
    inflight, pending, out = [], [], []
    for t in range(ticks):
        delays, drops = avail.sample_delays(rng, k), avail.sample_dropout(rng, k)
        inflight += [(t + int(delays[i]), t) for i in range(k) if not drops[i]]
        landed = sorted((r for r in inflight if r[0] <= t), key=lambda r: r[0])
        inflight = [r for r in inflight if r[0] > t]
        pending += landed
        flushes = []
        while len(pending) >= buffer:
            flushes.append([t - r[1] for r in pending[:buffer]])
            pending = pending[buffer:]
        out.append((len(landed), int(drops.sum()), flushes, len(pending), len(inflight)))
    return out


def async_phase(rt, task, launches, ms):
    """11.1, the zero-delay identity, and 11.2, stragglers."""
    # 11.1: no delay model and a cohort-sized buffer is the vmap round, bitwise
    kw = {**ENGINE_DGCWGMF, "scheme": "async_dgcwgmf"}
    with deterministic_cudnn():
        sync, _, c_sync = run_path(rt, task, kw, 2, 20, 64, launches)
        ticks, hist, c_async = run_path(rt, task, kw, 2, 20, 64, launches, backend="async")
    n = same_state(rt, sync, ticks, "async zero delay vs vmap")
    check(c_sync == c_async == times(FUSED, 2), f"async identity: launches {c_sync} / {c_async}")
    check(ticks.ledger.upload_bytes == sync.ledger.upload_bytes
          and ticks.ledger.download_bytes == sync.ledger.download_bytes
          and ticks.ledger.rounds == sync.ledger.rounds == 2,
          f"async identity: ledger {ticks.ledger.summary()} vs {sync.ledger.summary()}")
    check(ticks.ledger.staleness_counts == {0: 40}, "async identity: staleness "
          f"{ticks.ledger.staleness_counts}")
    print(f"  async, zero delay, buffer 20: 2 ticks bitwise 2 vmap rounds ({n} tensors and "
          f"the ledger, cuDNN deterministic); launches {c_async}", flush=True)
    del sync, ticks

    # 11.2: geometric stragglers, dropouts, a buffer of half the cohort
    rounds, buffer = 6, 10
    seen = []
    sim, hist, counts = run_path(rt, task, kw, rounds, 20, 64, launches, backend="async",
                                 buffer_size=buffer, before=capture("async_round", seen),
                                 **STRAGGLERS)
    check(counts == times(FUSED, rounds), f"async stragglers: launches {counts}, one of each "
          f"a tick expected")
    plain = plain_schedule(rt, STRAGGLERS, sim.fl.seed, 20, rounds, buffer)
    arrived = [out[4] for out in seen]
    applies = [out[5] for out in seen]
    for t, ((n_in, _, gaps, pending, inflight), rec) in enumerate(zip(plain, hist, strict=True)):
        got = ([list(map(int, a.gaps)) for a in applies[t]], rec["pending"], rec["in_flight"])
        check(len(arrived[t]) == n_in and got == (gaps, pending, inflight),
              f"async tick {t}: arrived {len(arrived[t])}, (flush gaps, pending, in flight) "
              f"{got}; the plain schedule {n_in}, {(gaps, pending, inflight)}")
    dropped = sum(p[1] for p in plain)
    n_arrived = sum(len(a) for a in arrived)
    flushes = sum(len(a) for a in applies)
    check(20 * rounds == n_arrived + dropped + sim.engine.in_flight,
          f"async: dispatched {20 * rounds} != arrived {n_arrived} + dropped {dropped} + in "
          f"flight {sim.engine.in_flight}")
    check(n_arrived == buffer * flushes + sim.engine.pending and sim.engine.pending < buffer,
          f"async: {n_arrived} arrived, {flushes} flushes of {buffer}, {sim.engine.pending} "
          f"pending")
    counts_hist = sim.ledger.staleness_counts
    check(sum(counts_hist.values()) == buffer * flushes > 0 and max(counts_hist) > 0,
          f"async: staleness histogram {counts_hist} for {flushes} flushes")
    cost = sim.engine.scheme.cost_model()
    nnz = np.concatenate(arrived)
    up = float(np.sum(cost.upload_payload_bytes(nnz, sim.total_params)))
    down = sum(float(cost.payload_bytes(a.down_nnz, sim.total_params)) * buffer
               for ap in applies for a in ap)
    check(up == sim.ledger.upload_bytes and down == sim.ledger.download_bytes,
          f"async: ledger {sim.ledger.upload_bytes} / {sim.ledger.download_bytes}, the cost "
          f"model on the arrived nnz {up} / {down}")
    check(nnz.min() >= RESNET56_KEEP, f"async: an arrived payload of nnz {nnz.min()} < "
          f"{RESNET56_KEEP}")
    check(all(bool(torch.isfinite(x).all()) for x in rt.utils.tree_leaves(sim.params))
          and bool(torch.isfinite(sim.engine._gmom).all()) and bool(sim.engine._gmom.any()),
          "async: params or the server momentum M not finite (or M zero)")
    ms["async (ms/tick)"] = [r["round_ms"] for r in hist[1:]]
    print(f"  async, geometric delays (mean 1, max 4), dropout 0.1, buffer {buffer}, {rounds} "
          f"ticks: launches {counts}; dispatched {20 * rounds} = arrived {n_arrived} + dropped "
          f"{dropped} + in flight {sim.engine.in_flight}; {flushes} flushes, {sim.engine.pending} "
          f"pending; applies a tick {[r['applies'] for r in hist]}; staleness "
          f"{json.dumps(sim.ledger.staleness_summary())}; arrived nnz min {int(nnz.min())}; "
          f"ledger {json.dumps(sim.ledger.summary())}; ms/tick {ms['async (ms/tick)']}",
          flush=True)


def topology_phase(rt, task, launches, ms):
    """11.3, the ring, and 11.4, the hierarchy."""
    # 11.3: 5 segments of 4 clients, the broadcast every 2 rounds
    infos, seen_zero, down_after = [], [], []

    def watch(t, sim):
        seen_zero.append(not bool(sim.gbar_prev.any()))
        down_after.append(sim.ledger.download_bytes)

    def before(sim):
        capture("topo_round", infos)(sim)
        sim.run = lambda provide, inner=sim.run: inner(provide, on_round=watch)

    sim, hist, counts = run_path(rt, task, ENGINE_DGCWGMF, 2, 20, 64, launches,
                                 topology="ring", ring_hops=3, sync_every=2, before=before)
    check(counts == times(FUSED, 8), f"ring: launches {counts}, 4 of each a round expected")
    cost = sim.engine.scheme.cost_model()
    for t, out in enumerate(infos):
        info = out[4]
        check(info.peer_nnz.shape == (15,) and info.ingress_nnz.shape == (5,)
              and min(info.peer_nnz.min(), info.ingress_nnz.min()) >= RESNET56_KEEP,
              f"ring round {t}: peer nnz {info.peer_nnz}, ingress nnz {info.ingress_nnz}")
    info1 = infos[1][4]
    check(seen_zero[0] and down_after[0] == 0.0 and not hist[0]["synced"],
          "ring: round 0 charged a download or moved gbar_prev")
    want_down = float(cost.payload_bytes(info1.down_nnz, sim.total_params)) * 20
    check(hist[1]["synced"] and not seen_zero[1] and sim.ledger.download_bytes == want_down,
          f"ring round 1: download {sim.ledger.download_bytes} bytes, expected {want_down} "
          f"(20 clients)")
    peer = sum(float(np.sum(cost.upload_payload_bytes(o[4].peer_nnz, sim.total_params)))
               for o in infos)
    check(sim.ledger.peer_bytes == peer, f"ring: peer {sim.ledger.peer_bytes}, expected {peer}")
    ms["ring (ms/round)"] = [r["round_ms"] for r in hist[1:]]
    print(f"  ring, 3 hops (5 segments of 4), sync every 2: launches {counts}; peer nnz min "
          f"{int(min(o[4].peer_nnz.min() for o in infos))}, ingress nnz "
          f"{[o[4].ingress_nnz.astype(int).tolist() for o in infos]}; download nnz round 1 "
          f"{int(info1.down_nnz)}; ledger {json.dumps(sim.ledger.summary())}; ms/round "
          f"{[r['round_ms'] for r in hist]}", flush=True)
    del sim, infos

    # 11.4: 4 edge aggregators re-compress with their own DGCwGMF state
    infos = []
    kw = {**ENGINE_DGCWGMF, "scheme": "hier_dgcwgmf", "tier_rate": 0.1}
    sim, hist, counts = run_path(rt, task, kw, 2, 20, 64, launches, topology="hierarchical",
                                 groups=4, before=capture("topo_round", infos))
    check(counts == times(FUSED, 4), f"hierarchical: launches {counts}, 2 of each a round "
          f"expected")
    for t, out in enumerate(infos):
        info = out[4]
        check(info.peer_nnz.shape == (20,) and info.ingress_nnz.shape == (4,)
              and min(info.peer_nnz.min(), info.ingress_nnz.min()) >= RESNET56_KEEP,
              f"hierarchical round {t}: leaf nnz {info.peer_nnz}, tier nnz {info.ingress_nnz}")
    tier = sim.engine.tier_cstates
    check(all(x.shape == (4, RESNET56_PARAMS) and bool(torch.isfinite(x).all())
              for x in tier) and bool(tier.m.any()),
          "hierarchical: the tier state is not a finite [4, N] stack with a nonzero M")
    cost = sim.engine.scheme.cost_model()
    down = [float(cost.payload_bytes(o[4].down_nnz, sim.total_params)) for o in infos]
    peer = sum(float(np.sum(cost.upload_payload_bytes(o[4].peer_nnz, sim.total_params)))
               for o in infos) + 20 * sum(down)
    check(sim.ledger.peer_bytes == peer and sim.ledger.download_bytes == 4 * sum(down),
          f"hierarchical: peer {sim.ledger.peer_bytes} / download {sim.ledger.download_bytes}, "
          f"expected {peer} (leaf uploads and the relay to 20) / {4 * sum(down)}")
    ms["hierarchical (ms/round)"] = [r["round_ms"] for r in hist[1:]]
    print(f"  hierarchical, 4 groups, tier rate 0.1: launches {counts}; leaf nnz min "
          f"{int(min(o[4].peer_nnz.min() for o in infos))}, tier nnz "
          f"{[o[4].ingress_nnz.astype(int).tolist() for o in infos]}; ledger "
          f"{json.dumps(sim.ledger.summary())}; ms/round {[r['round_ms'] for r in hist]}",
          flush=True)


def degenerate_and_shard_phase(rt, task, launches, ms):
    """11.5, ring(0) and hierarchical(1) against the star, and 11.6, a one-rank
    NCCL group against vmap, all under cuDNN's deterministic algorithms."""
    store = ROOT / "build" / "dist_store"
    with deterministic_cudnn():
        star_dgc, _, _ = run_path(rt, task, {"scheme": "dgc"}, 2, 20, 64, launches)
        ring0, _, c = run_path(rt, task, {"scheme": "dgc"}, 2, 20, 64, launches,
                               topology="ring", ring_hops=0)
        n = same_state(rt, star_dgc, ring0, "ring(0) vs the star (dgc)")
        check(c == times({"gmf_select": 1, "gmf_compress": 0, "momentum_correction": 1,
                          "apply_mask": 1}, 2), f"ring(0): launches {c}")
        del star_dgc, ring0
        star, _, _ = run_path(rt, task, ENGINE_DGCWGMF, 2, 20, 64, launches)
        hier1, _, c = run_path(rt, task, ENGINE_DGCWGMF, 2, 20, 64, launches,
                               topology="hierarchical", groups=1)
        same_state(rt, star, hier1, "hierarchical(1) vs the star (dgcwgmf)")
        check(c == times(FUSED, 2), f"hierarchical(1): launches {c}")
        del hier1
        print(f"  ring(0) with dgc and hierarchical(1) with dgcwgmf: 2 rounds each bitwise the "
              f"star ({n} tensors each, cuDNN deterministic)", flush=True)
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        t0 = time.perf_counter()
        torch.distributed.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                                             world_size=1)
        try:
            shard, hist, c = run_path(rt, task, ENGINE_DGCWGMF, 2, 20, 64, launches,
                                      backend="shard")
        finally:
            torch.distributed.destroy_process_group()
            store.unlink(missing_ok=True)
    check(c == times(FUSED, 2), f"shard: launches {c}")
    n = same_state(rt, star, shard, "one-rank NCCL shard vs vmap (dgcwgmf)")
    ms["shard, 1 rank (ms/round)"] = [r["round_ms"] for r in hist[1:]]
    print(f"  shard, one-rank NCCL group: 2 rounds bitwise vmap ({n} tensors, cuDNN "
          f"deterministic); group set up, run and torn down in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def engines_card_vs_cpu_phase(rt, dev, tol=1e-2):
    """11.7: round 0 of the ring (1 hop) and of the hierarchy (2 groups), and
    3 async ticks with 11.2's stragglers (buffer 2), at depth 8 with 4
    clients on the card and the CPU: the same async schedule, broadcasts
    within ``tol`` relative L2 (phase 4's)."""
    data = rt.synthetic.SynthCIFAR(num_train=2000, num_test=200)
    runs = {"ring, 1 hop": (ENGINE_DGCWGMF, 1, dict(topology="ring", ring_hops=1)),
            "hierarchical, 2 groups": ({**ENGINE_DGCWGMF, "scheme": "hier_dgcwgmf"}, 1,
                                       dict(topology="hierarchical", groups=2)),
            "async, stragglers, buffer 2": ({**ENGINE_DGCWGMF, "scheme": "async_dgcwgmf"}, 3,
                                            dict(backend="async", buffer_size=2, **STRAGGLERS))}
    for label, (kw, rounds, fl_kw) in runs.items():
        out = {}
        for side, device in (("cuda", dev), ("cpu", "cpu")):
            task = rt.fl.CifarTask(num_clients=4, depth=8, data=data, device=device)
            sim, hist, _ = run_path(rt, task, kw, rounds, 4, 32, {n: 0 for n in rt.gk.LAUNCHES},
                                    **fl_kw)
            schedule = [(r.get("applies"), r.get("pending"), r.get("in_flight")) for r in hist]
            out[side] = (schedule, sim.ledger.staleness_counts, sim.gbar_prev.cpu())
        (s_g, h_g, b_g), (s_c, h_c, b_c) = out["cuda"], out["cpu"]
        check(s_g == s_c and h_g == h_c, f"{label}: schedule card {s_g} {h_g} vs CPU {s_c} {h_c}")
        rel = float((b_g - b_c).norm() / b_c.norm())
        check(math.isfinite(rel) and rel <= tol,
              f"{label}: card vs CPU broadcast relative L2 {rel:.3e} > {tol}")
        print(f"  {label}: card vs CPU broadcast relative L2 {rel:.3e} (tolerance {tol}); "
              f"schedule (applies, pending, in flight) {s_g}, staleness {h_g}: the same on both",
              flush=True)


def engines_phase(rt, task, dev):
    """Phase 11 on ResNet-56 (phase 3's task). Returns (launches of its
    counted runs, ms per round or tick after round 0 per engine)."""
    launches = {name: 0 for name in rt.gk.LAUNCHES}
    ms = {}
    t0 = time.perf_counter()
    async_phase(rt, task, launches, ms)
    topology_phase(rt, task, launches, ms)
    degenerate_and_shard_phase(rt, task, launches, ms)
    print(f"  ResNet-56 engines in {time.perf_counter() - t0:.1f} s", flush=True)
    engines_card_vs_cpu_phase(rt, dev)
    return launches, ms


OBS_DIR = ROOT / "build" / "obs"  # phase 12's telemetry output (ignored by git)
OBS_ROUNDS = 3
HEALTH_NORMS = {"residual_u_norm": "u", "residual_v_norm": "v", "momentum_m_norm": "m",
                "server_momentum_norm": "server", "broadcast_norm": "bcast"}


def repo_files():
    """Every file under the checkout (bar ``__pycache__``) with its size and
    modification time: what a run that writes nothing leaves as it was."""
    out = set()
    for p in ROOT.rglob("*"):
        if "__pycache__" not in p.parts and p.is_file():
            st = p.stat()
            out.add((str(p), st.st_size, st.st_mtime_ns))
    return out


def f64_norm(x) -> float:
    """L2 norm of a state field in float64 (0.0 for an empty one)."""
    leaves = [x] if torch.is_tensor(x) else list(x.values())
    return math.sqrt(sum(float(t.double().square().sum()) for t in leaves))


def read_obs(rt, out):
    """The events a telemetry run wrote into ``out``, validated."""
    path = out / "events.jsonl"
    errors = rt.obs.events.validate_file(str(path))
    check(errors == [], f"{path}: schema errors {errors[:3]}")
    return rt.obs.events.read_events(str(path))


@contextlib.contextmanager
def telemetry(rt, out, run, backend):
    """Telemetry on into ``out`` for the body, as a launcher turns it on: a
    ``run_start`` event, the body, the exporters, then off again."""
    shutil.rmtree(out, ignore_errors=True)
    rec = rt.obs.configure(str(out))
    rec.event("run_start", run=run, argv=[], backend=backend)
    try:
        yield rec
        rt.obs.export.write_all(str(out))
    finally:
        rt.obs.shutdown()


def obs_off_on_phase(rt, task, launches, bw):
    """12.1 and 12.2: 3 rounds of dgcwgmf with telemetry off, then on, from
    the same seed under cuDNN's deterministic algorithms; then what the on
    run wrote."""
    kw = ENGINE_DGCWGMF
    out = OBS_DIR / "resnet56"
    with deterministic_cudnn():
        check(rt.obs.get() is rt.obs.metrics.NOOP, "telemetry is on before phase 12")
        before = repo_files()
        off, _, c_off = run_path(rt, task, kw, OBS_ROUNDS, 20, 64, launches)
        check(repo_files() == before, "the run with telemetry off wrote or changed a file")
        with telemetry(rt, out, "chip_smoke phase 12: ResNet-56 dgcwgmf", "vmap") as rec:
            on, _, c_on = run_path(rt, task, kw, OBS_ROUNDS, 20, 64, launches)
            rec.event("summary", **on.ledger.summary())
            snap = rec.registry
    n = same_state(rt, off, on, "telemetry off vs on")
    check(off.ledger.summary() == on.ledger.summary(),
          f"telemetry off vs on: ledger {off.ledger.summary()} vs {on.ledger.summary()}")
    check(c_off == c_on == times(FUSED, OBS_ROUNDS), f"telemetry off vs on: launches {c_off} "
          f"vs {c_on}")
    print(f"  telemetry off vs on, 3 rounds each: bitwise in {n} tensors and the ledger (cuDNN "
          f"deterministic); launches {c_on} both; the off run wrote no file", flush=True)
    del off

    evs = read_obs(rt, out)
    kinds = [e["kind"] for e in evs]
    check(kinds.count("round") == kinds.count("health") == OBS_ROUNDS,
          f"events: {kinds.count('round')} round and {kinds.count('health')} health, expected "
          f"{OBS_ROUNDS} each")
    report = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                             str(out / "events.jsonl"), "--strict"], capture_output=True,
                            text=True, env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120,
                            check=False)
    check(report.returncode == 0, f"obs.report --strict exited {report.returncode}: "
          f"{report.stderr[-2000:]}")
    led = on.ledger
    comm = {name: snap.counter(f"comm.{name}").value()
            for name in ("upload_bytes", "download_bytes", "peer_bytes", "rounds")}
    want = {"upload_bytes": led.upload_bytes, "download_bytes": led.download_bytes,
            "peer_bytes": led.peer_bytes, "rounds": float(led.rounds)}
    check(comm == want, f"comm.* counters {comm}, the ledger {want}")
    last = [e["data"] for e in evs if e["kind"] == "health"][-1]
    fields = {"u": on.cstates.u, "v": on.cstates.v, "m": on.cstates.m,
              "server": on.sstate.momentum, "bcast": on.gbar_prev}
    worst = 0.0
    for key, field in HEALTH_NORMS.items():
        want_norm = f64_norm(fields[field])
        rel = abs(last[key] - want_norm) / want_norm if want_norm else abs(last[key])
        worst = max(worst, rel)
        check(rel <= 1e-5, f"health {key} {last[key]!r} vs float64 {want_norm!r}: relative "
              f"{rel:.3e} > 1e-5")
    check(last["broadcast_finite"] is True and last["global_momentum_norm"] == 0.0,
          f"health block {last}")
    # the health block's cost alone: host clock around the call, which ends
    # in its one device read; the bytes it must read, each field once
    health_ms = []
    for _ in range(21):
        t0 = time.perf_counter()
        rt.obs.health.compensation_norms(on.cstates, on.sstate, on.gbar_prev)
        health_ms.append((time.perf_counter() - t0) * 1e3)
    read = 4 * (3 * on.cstates.u.numel() + on.gbar_prev.numel())
    # a NaN in a copy of the broadcast trips one anomaly
    bad = on.gbar_prev.clone()
    bad[0] = float("nan")
    with telemetry(rt, OBS_DIR / "anomaly", "chip_smoke phase 12: anomaly", "vmap") as rec:
        rt.obs.health.record_round_health(
            rec, round_idx=OBS_ROUNDS, cstates=on.cstates, sstate=on.sstate, bcast=bad,
            upload_nnz_mean=float(RESNET56_KEEP), total_params=on.total_params,
            target_rate=on.comp.rate)
        anomalies = rec.registry.counter("health.anomalies").value()
    bad_kinds = [e["kind"] for e in read_obs(rt, OBS_DIR / "anomaly")]
    check(anomalies == 1.0 and bad_kinds.count("anomaly") == 1,
          f"a NaN broadcast: health.anomalies {anomalies}, events {bad_kinds}")
    print(f"  events valid ({len(evs)}: {kinds.count('round')} round, {kinds.count('health')} "
          f"health), obs.report --strict exit 0; comm.* counters equal the ledger {comm}; "
          f"health norms within {worst:.3e} relative of float64 (tolerance 1e-5): "
          f"{json.dumps({k: last[k] for k in HEALTH_NORMS})}; a NaN broadcast copy: 1 anomaly "
          f"event, health.anomalies {anomalies}", flush=True)
    print(f"  the health block alone (compensation_norms on the [20, N] stacks, to its device "
          f"read): median {statistics.median(health_ms[1:]):.4f} ms of 20 after one warm-up "
          f"(min {min(health_ms[1:]):.4f}); it must read {read / 1e6:.1f} MB, "
          f"{read / bw * 1e3:.4f} ms at the card's "
          f"memory rate", flush=True)


def obs_engines_phase(rt, task, launches):
    """12.3: the async engine's flush events and global momentum, and the
    hierarchy's aggregator block, with telemetry on."""
    kw = {**ENGINE_DGCWGMF, "scheme": "async_dgcwgmf"}
    out = OBS_DIR / "async"
    with telemetry(rt, out, "chip_smoke phase 12: async", "async"):
        sim, _, counts = run_path(rt, task, kw, 4, 20, 64, launches, backend="async",
                                  buffer_size=10, **STRAGGLERS)
    check(counts == times(FUSED, 4), f"async with telemetry: launches {counts}")
    evs = read_obs(rt, out)
    flushes = [e["data"] for e in evs if e["kind"] == "flush"]
    gaps = sorted(g for f in flushes for g in f["staleness_gaps"])
    hist = sim.ledger.staleness_counts
    check(flushes and gaps == sorted(g for g, c in hist.items() for _ in range(c)),
          f"flush events' gaps {gaps} vs the ledger's histogram {hist}")
    last = [e["data"] for e in evs if e["kind"] == "health"][-1]
    gmom = f64_norm(sim.engine._gmom)
    rel = abs(last["global_momentum_norm"] - gmom) / gmom
    check(gmom > 0 and rel <= 1e-5, f"async global_momentum_norm "
          f"{last['global_momentum_norm']!r} vs engine._gmom {gmom!r} (relative {rel:.3e})")
    print(f"  async, stragglers, buffer 10, 4 ticks: {len(flushes)} flush events carrying "
          f"{len(gaps)} gaps (the ledger's {hist}); global_momentum_norm within {rel:.3e} of "
          f"engine._gmom; launches {counts}", flush=True)
    del sim

    kw = {**ENGINE_DGCWGMF, "scheme": "hier_dgcwgmf"}
    out = OBS_DIR / "hierarchical"
    with telemetry(rt, out, "chip_smoke phase 12: hierarchical", "vmap"):
        sim, _, counts = run_path(rt, task, kw, 2, 20, 64, launches, topology="hierarchical",
                                  groups=4)
    check(counts == times(FUSED, 4), f"hierarchical with telemetry: launches {counts}")
    evs = read_obs(rt, out)
    tier = [e["data"] for e in evs if e["kind"] == "health" and e["data"].get("tier")]
    check(len(tier) == 2 and all(b["tier"] == "aggregator" for b in tier),
          f"aggregator health blocks {tier}")
    norms = [b[k] for b in tier for k in HEALTH_NORMS]
    check(all(math.isfinite(x) for x in norms) and all(b["broadcast_finite"] for b in tier)
          and tier[-1]["momentum_m_norm"] > 0, f"aggregator health blocks {tier}")
    print(f"  hierarchical, 4 groups, 2 rounds: {len(tier)} aggregator health blocks, finite, "
          f"the tier's M norm {tier[-1]['momentum_m_norm']:.6g}; "
          f"{[e['kind'] for e in evs].count('topo_round')} topo_round events; launches {counts}",
          flush=True)


def obs_cost_phase(rt, task, launches, card):
    """12.4: ms per round after round 0 with telemetry off and on, in turns
    (off, on, on, off), under cuDNN's default algorithms."""
    ms = {"off": [], "on": []}
    for turn in ("off", "on", "on", "off"):
        if turn == "on":
            with telemetry(rt, OBS_DIR / "cost", "chip_smoke phase 12: cost", "vmap"):
                _, hist, _ = run_path(rt, task, ENGINE_DGCWGMF, 4, 20, 64, launches)
        else:
            _, hist, _ = run_path(rt, task, ENGINE_DGCWGMF, 4, 20, 64, launches)
        ms[turn].append([r["round_ms"] for r in hist[1:]])
    med = {k: statistics.median(x for run in v for x in run) for k, v in ms.items()}
    print(f"  ms/round after round 0 ({card}), turns off, on, on, off: {json.dumps(ms)}; "
          f"median off {med['off']:.3f}, on {med['on']:.3f}, on - off "
          f"{med['on'] - med['off']:.3f} ms", flush=True)
    return ms


def obs_profile_phase(rt, task):
    """12.5: a torch.profiler trace of one round with telemetry on: the
    device time under each round phase and the busy share (union)."""
    comp = rt.core.CompressionConfig(rate=0.1, **ENGINE_DGCWGMF)
    fl = rt.fl.FLConfig(num_clients=20, rounds=2, batch_size=64, learning_rate=0.1)
    sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=task.device)
    provide = task.batch_provider(64)
    rt.obs.configure()  # metrics in memory, no file
    try:
        sim.run(provide)
        wall, prof = profile_round(sim, provide)
    finally:
        rt.obs.shutdown()
    n, busy, split = device_split(prof)
    check(set(split) == set(ROUND_PHASES) and all(math.isfinite(w) for _, w in split.values()),
          f"the profile shows {split}, expected the four phases {ROUND_PHASES} on the device")
    print(f"  profiled round with telemetry on: {wall:.3f} ms, {n} device activities, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f} %, the union of their intervals)",
          flush=True)
    print_split(split)
    return split


def obs_serve_phase(rt):
    """12.6: ``launch/serve.py --obs`` in fixed mode at llama3.2-1b, batch 4,
    prompt 2048: the three files, their events, K4's 16 tensor-core
    launches in the prefill."""
    import io

    out, gen = OBS_DIR / "serve", 8
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--arch", "llama3.2-1b", "--batch", str(SERVE["batch"]), "--prompt-len",
            str(SERVE["prompt_len"]), "--gen", str(gen), "--obs", "--obs-dir", str(out)]
    rt.gk.reset_launches()
    rt.k4.reset_launches()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = rt.serve.main(argv)
    torch.cuda.synchronize()
    counts = {**rt.gk.LAUNCHES, **rt.k4.LAUNCHES}
    check(rc == 0 and counts["flash_attention_tc"] == counts["flash_attention"] == 16
          and sum(rt.gk.LAUNCHES.values()) == 0, f"serve --obs: exit {rc}, launches {counts}")
    files = sorted(p.name for p in out.iterdir())
    check(files == ["events.jsonl", "metrics.prom", "summary.json"], f"serve --obs wrote {files}")
    kinds = [e["kind"] for e in read_obs(rt, out)]
    check(kinds[0] == "run_start" and "summary" in kinds, f"serve --obs events {kinds}")
    with contextlib.redirect_stdout(io.StringIO()):
        strict = rt.obs_report.main([str(out / "events.jsonl"), "--strict"])
    check(strict == 0, f"obs.report --strict on the serve events exited {strict}")
    summary = printed.getvalue().strip().splitlines()[-1]
    print(f"  serve --obs, llama3.2-1b, batch {SERVE['batch']}, prompt {SERVE['prompt_len']}, "
          f"{gen} tokens: wrote {files}; events {kinds}; K4 launches {counts['flash_attention_tc']}"
          f" (tensor cores); {summary}", flush=True)


def obs_phase(rt, task, card, bw):
    """Phase 12, telemetry on the card. Returns the launches of its counted
    ResNet-56 runs."""
    launches = {name: 0 for name in rt.gk.LAUNCHES}
    t0 = time.perf_counter()
    obs_off_on_phase(rt, task, launches, bw)
    obs_engines_phase(rt, task, launches)
    obs_cost_phase(rt, task, launches, card)
    obs_profile_phase(rt, task)
    obs_serve_phase(rt)
    print(f"  phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def serve_phase(rt, dev, profile=False):
    """The port's fixed-batch serving path at llama3.2-1b full size; with
    ``profile``, a ``torch.profiler`` trace of one more run: the device's
    busy share of the prefill and of the decode loop, and their costliest
    kernels."""
    cfg = rt.configs.get_config("llama3.2-1b")
    args = rt.serve.parser().parse_args(
        ["--arch", "llama3.2-1b", "--batch", str(SERVE["batch"]), "--prompt-len",
         str(SERVE["prompt_len"]), "--gen", str(SERVE["gen"])])
    t0 = time.perf_counter()
    params = rt.serve.init_params(cfg, args.seed, dev)
    n = sum(x.numel() for x in rt.utils.tree_leaves(params))
    check(n == cfg.param_count() == 1_498_482_688, f"{n} params")
    torch.cuda.synchronize()
    print(f"  llama3.2-1b: {n} params in {cfg.param_dtype} on the card, initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for label in ("warm-up", "measured"):
        rt.gk.reset_launches()
        rt.k4.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        run = rt.serve.run_fixed(cfg, params, args, dev)
        torch.cuda.synchronize()
        counts = {**rt.gk.LAUNCHES, **rt.k4.LAUNCHES}
        check(counts == {"gmf_select": 0, "gmf_compress": 0, "momentum_correction": 0,
                         "apply_mask": 0, "flash_attention": cfg.num_layers,
                         "flash_attention_tc": cfg.num_layers, "flash_attention_cc": 0},
              f"{label}: launches {counts}")
        check(bool(torch.isfinite(run.last_logits).all()), f"{label}: logits not finite")
        check(tuple(run.tokens.shape) == (SERVE["batch"], SERVE["gen"]),
              f"{label}: tokens {tuple(run.tokens.shape)}")
        check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
              f"{label}: token ids out of range")
        print(f"  {label}: {json.dumps(run.summary)}; launches {counts}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    # Which part launched K4: the prefill alone, then the decode loop alone.
    parts, _ = serve_parts(rt, cfg, params, args, dev)
    split = []
    for fn in parts:
        rt.k4.reset_launches()
        fn()
        split.append(rt.k4.LAUNCHES["flash_attention"])
        check(rt.k4.LAUNCHES["flash_attention_tc"] == split[-1],
              f"K4 launches {rt.k4.LAUNCHES}: not all on the tensor-core kernel")
    torch.cuda.synchronize()
    check(split == [cfg.num_layers, 0], f"K4 launches: prefill alone {split[0]}, decode "
          f"loop alone {split[1]}; expected {cfg.num_layers} and 0")
    print(f"  K4 launches: prefill alone {split[0]}, decode loop alone {split[1]}", flush=True)
    if profile:
        profile_serving(parts, args)
    return run, counts


def serve_parts(rt, cfg, params, args, dev):
    """``run_fixed``'s two parts as separate calls, through its steps and
    its decode loop (``serve.decode``): ((prefill, decode), state), the
    second continuing from the first's output, which ``state`` holds
    (``"logits"``, ``"cache"``)."""
    batch = rt.serve.prompt_batch(cfg, args.seed, args.batch, args.prompt_len, dev)
    cache_len = args.cache_len or (args.prompt_len + args.gen)  # as run_fixed sets it
    prefill_step = rt.dstep.make_prefill_step(cfg, cache_len=cache_len)
    serve = rt.dstep.make_serve_step(cfg)
    state = {}

    def prefill():
        state["logits"], state["cache"] = prefill_step(params, batch)

    def decode():
        tok = torch.argmax(state["logits"], dim=-1)
        pos = torch.full((), rt.serve.first_decode_pos(cfg, args.prompt_len),
                         dtype=torch.int64, device=dev)
        rt.serve.decode(serve, params, state["cache"], tok, pos, args.gen - 1)

    return (prefill, decode), state


def profile_serving(parts, args):
    from torch.profiler import ProfilerActivity, profile

    for label, fn in zip(("prefill", f"decode ({args.gen - 1} steps)"), parts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)]
        n, busy, _ = device_split(prof, ())
        print(f"  profiled {label}: {wall:.3f} ms wall, {n} device activities, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f} %, the union of their intervals)",
              flush=True)
        for e in sorted(kernels, key=device_us, reverse=True)[:10]:
            print(f"    {device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
        k4 = [e for e in kernels if "flash_fwd" in e.key]  # both K4 kernels' names
        if k4:
            k4_ms = sum(device_us(e) for e in k4) / 1e3
            print(f"    K4: {k4_ms:.3f} ms in {sum(e.count for e in k4)} launches "
                  f"({', '.join(e.key[e.key.find('flash_fwd'):].split('(')[0] for e in k4)}), "
                  f"{100 * k4_ms / busy:.1f} % of the device's busy time", flush=True)


def serve_card_vs_cpu_phase(rt, dev, tol=1e-4, steps=4):
    """llama3.2-1b width at depth 2, float32, the same params on the card
    (K4 prefill, on the CUDA-core kernel) and the CPU (naive prefill);
    returns the card prefill's K4 launches."""
    import dataclasses

    cfg = dataclasses.replace(rt.configs.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    b, prompt = 2, 256
    params = {"cuda": rt.serve.init_params(cfg, 1, dev)}
    params["cpu"] = rt.utils.tree_map(lambda x: x.cpu(), params["cuda"])
    out = {}
    rt.k4.reset_launches()
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        batch = rt.serve.prompt_batch(cfg, 1, b, prompt, device)
        prefill = rt.dstep.make_prefill_step(cfg, cache_len=prompt + steps)
        out[name] = prefill(params[name], batch)
    cc_launches = rt.k4.LAUNCHES["flash_attention_cc"]
    check(rt.k4.LAUNCHES["flash_attention"] == cc_launches == cfg.num_layers,
          f"card prefill (float32) launched K4 {rt.k4.LAUNCHES}; expected "
          f"{cfg.num_layers} launches of the CUDA-core kernel")
    serve = rt.dstep.make_serve_step(cfg)
    (lg, cache_g), (lc, cache_c) = out["cuda"], out["cpu"]
    errs = []
    for i in range(steps + 1):
        lg, lc = lg.float().cpu(), lc.float()
        rel = float((lg - lc).norm() / lc.norm())
        errs.append(rel)
        check(math.isfinite(rel) and rel <= tol,
              f"card vs CPU serving: step {i} logits relative L2 {rel:.3e} > {tol}")
        if i == steps:
            break
        tok = torch.argmax(lc, dim=-1)  # the CPU's greedy tokens feed both sides
        pos = torch.tensor(prompt + i)
        _, lg, cache_g = serve(params["cuda"], cache_g, tok.to(dev), pos.to(dev))
        _, lc, cache_c = serve(params["cpu"], cache_c, tok, pos)
    print(f"  card (K4) vs CPU (naive), llama3.2-1b width, 2 layers, float32, batch {b}, "
          f"prompt {prompt}: logits relative L2 prefill {errs[0]:.3e}, decode steps "
          f"{', '.join(f'{e:.3e}' for e in errs[1:])} (tolerance {tol})", flush=True)
    return cc_launches


# Phase 6's other families: (label, arch, depth) at the smoke widths in
# float32. The hybrid keeps its smoke's 5 layers (rec, rec, attn and a tail
# of two rec), the shortest that holds its attention block.
FAMILY_CASES = (("moe", "granite-moe-1b-a400m", 2), ("ssm", "mamba2-780m", 2),
                ("hybrid", "recurrentgemma-9b", 5), ("vlm", "qwen2-vl-72b", 2),
                ("audio", "musicgen-large", 2))


def n_attn(cfg) -> int:
    """Attention blocks of ``cfg``: K4's launches in one of its prefills."""
    return sum(bt == "attn" for bt in cfg.layer_types)


def family_card_vs_cpu_phase(rt, dev, tol=1e-4, steps=4, b=2, prompt=64):
    """Each family at its smoke width (FAMILY_CASES) and kimi-k2-1t-a32b's
    attention at reduced width (H 64, KV 8, head dim 112; d_model 1024, 16
    experts of width 256, vocabulary 4096), 2 layers, float32: the same
    params on the card (K4 prefill, CUDA-core kernel) and the CPU (naive),
    the prefill's last logits and ``steps`` decode steps, both sides fed
    the CPU's greedy tokens, within ``tol`` relative L2 per step. Returns
    the card prefills' K4 launches."""
    import dataclasses

    f32 = dict(dtype="float32", param_dtype="float32")
    cases = [(label, dataclasses.replace(rt.configs.get_smoke(arch), num_layers=depth, **f32))
             for label, arch, depth in FAMILY_CASES]
    cases.append(("kimi D 112", dataclasses.replace(
        rt.configs.get_config("kimi-k2-1t-a32b"), num_layers=2, d_model=1024, d_ff=256,
        num_experts=16, vocab_size=4096, **f32)))
    return sum(card_vs_cpu_case(rt, dev, label, cfg, tol, steps, b, prompt)
               for label, cfg in cases)


def card_vs_cpu_case(rt, dev, label, cfg, tol, steps, b, prompt, meshes=(None, None)):
    """One config of ``family_card_vs_cpu_phase`` (the steps built over
    ``meshes``, the card's and the CPU's, when given). Returns the card
    prefill's K4 launches."""
    params = {"cuda": rt.serve.init_params(cfg, 1, dev)}
    params["cpu"] = rt.utils.tree_map(lambda x: x.cpu(), params["cuda"])
    out = {}
    rt.k4.reset_launches()
    for (name, device), mesh in zip((("cuda", dev), ("cpu", torch.device("cpu"))), meshes,
                                    strict=True):
        batch = rt.serve.prompt_batch(cfg, 1, b, prompt, device)
        prefill = rt.dstep.make_prefill_step(cfg, mesh, cache_len=prompt + steps)
        out[name] = prefill(params[name], batch)
    want = n_attn(cfg)
    check(rt.k4.LAUNCHES["flash_attention"] == rt.k4.LAUNCHES["flash_attention_cc"] == want,
          f"{label}: card prefill (float32) launched K4 {rt.k4.LAUNCHES}; expected {want} "
          f"launches of the CUDA-core kernel")
    serve = {name: rt.dstep.make_serve_step(cfg, mesh)
             for name, mesh in zip(("cuda", "cpu"), meshes, strict=True)}
    (lg, cache_g), (lc, cache_c) = out["cuda"], out["cpu"]
    pos0 = rt.serve.first_decode_pos(cfg, prompt)
    errs = []
    for i in range(steps + 1):
        lg, lc = lg.float().cpu(), lc.float()
        rel = float((lg - lc).norm() / lc.norm())
        errs.append(rel)
        check(math.isfinite(rel) and rel <= tol,
              f"{label} card vs CPU: step {i} logits relative L2 {rel:.3e} > {tol}")
        if i == steps:
            break
        tok = torch.argmax(lc, dim=-1)  # the CPU's greedy tokens feed both sides
        pos = torch.tensor(pos0 + i)
        _, lg, cache_g = serve["cuda"](params["cuda"], cache_g, tok.to(dev), pos.to(dev))
        _, lc, cache_c = serve["cpu"](params["cpu"], cache_c, tok, pos)
    print(f"  {label} ({cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, head dim "
          f"{cfg.head_dim}): {want} K4 launches; logits relative L2 prefill {errs[0]:.3e}, "
          f"decode {', '.join(f'{e:.3e}' for e in errs[1:])} (tolerance {tol})", flush=True)
    return want


# Phase 13: (arch, depth run or None for the full depth, batch, prompt,
# generated tokens). Each is served at its published widths in bfloat16.
# Depths: cut where one card's memory forces it (yi, command-r, kimi,
# qwen2-vl) and, to keep the script's time, to half elsewhere.
SERVE_FAMILIES = (
    ("qwen2.5-3b", 18, 4, 2048, 16),
    ("yi-34b", 16, 4, 2048, 16),
    ("command-r-plus-104b", 8, 4, 2048, 16),
    ("granite-moe-1b-a400m", 12, 4, 2048, 16),
    ("kimi-k2-1t-a32b", 1, 1, 256, 8),
    ("mamba2-780m", 24, 4, 2048, 16),
    ("recurrentgemma-9b", 19, 4, 2048, 16),
    ("qwen2-vl-72b", 16, 4, 1024, 16),
    ("musicgen-large", 24, 4, 2048, 16),
)
NO_COMPRESSION = {"gmf_select": 0, "gmf_compress": 0, "momentum_correction": 0, "apply_mask": 0}


def serve_families_phase(rt, dev, card, profile=False):
    """Phase 13: every config of SERVE_FAMILIES at its published widths
    (depths cut as listed), bfloat16, random params from seed 0 drawn on
    the card (``serve_family``), each model freed before the next. Returns
    ({arch: summary}, {arch: K4 launches by kernel in the measured run},
    {``hold_k4`` key: max abs difference of K4 held at these prefills})."""
    import gc

    summaries, launches, worst = {}, {}, {}
    for arch, depth, b, prompt, gen in SERVE_FAMILIES:
        summaries[arch], launches[arch], held = serve_family(rt, dev, card, arch, depth, b,
                                                             prompt, gen, profile)
        if held:
            worst[held[0]] = max(worst.get(held[0], 0.0), held[1])
        gc.collect()
        torch.cuda.empty_cache()
    return summaries, launches, worst


def hold_family_k4(rt, dev, cfg, b, prompt):
    """K4 against its plain version on random bf16 q/k/v at the shapes
    ``cfg``'s served prefill gives it (B ``b``, T the prompt plus any
    patches, H, KV, head dim; causal), on the kernel ``kernel_for`` names,
    at phase 2's tolerances. Returns (the ``hold_k4`` key of that kernel,
    max abs difference)."""
    rng = np.random.default_rng(13)
    t, h, kv, d = rt.serve.first_decode_pos(cfg, prompt), cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    q, k, v = (torch.tensor(rng.normal(size=(b, t, n, d)).astype(np.float32),
                            device=dev).to(torch.bfloat16) for n in (h, kv, kv))
    kern = rt.k4.kernel_for(torch.bfloat16, d)
    at = f"B {b} T {t} H {h} KV {kv} (G {h // kv}) D {d} bf16 causal ({cfg.name}'s prefill)"
    rt.k4.reset_launches()
    got = rt.k4.flash_attention(q, k, v)
    check(rt.k4.LAUNCHES[f"flash_attention_{kern}"] == 1 == rt.k4.LAUNCHES["flash_attention"],
          f"K4 at {at}: launches {rt.k4.LAUNCHES}, expected one of the {kern} kernel")
    want = rt.ref.flash_attention(q, k, v)
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"K4: {got.dtype} {tuple(got.shape)} at {at}")
    err, rel = check_k4(got, want, f"{at} ({kern} kernel)")
    print(f"  held K4 at {at} on the {kern} kernel: max abs {err:.3e}, relative L2 {rel:.3e}",
          flush=True)
    del q, k, v, got, want
    return (f"tc_d{d}" if kern == "tc" and d in (112, 256) else kern), err


def serve_family(rt, dev, card, arch, depth, b, prompt, gen, profile=False):
    """``run_fixed`` on one config: K4 held against its plain version at
    the config's prefill shapes (``hold_family_k4``), then a warm-up run and
    the measured one, counts reset before each, then the prefill alone and
    the decode loop alone (profiled with ``profile``). Returns (the measured
    run's summary, its K4 launches by kernel, the held K4's (key, max abs
    difference) or None without attention)."""
    import dataclasses

    cfg = rt.configs.get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    held = hold_family_k4(rt, dev, cfg, b, prompt) if n_attn(cfg) else None
    args = rt.serve.parser().parse_args(["--arch", arch, "--batch", str(b), "--prompt-len",
                                         str(prompt), "--gen", str(gen)])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = rt.serve.init_params(cfg, args.seed, dev)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in rt.utils.tree_leaves(params))
    nbytes = sum(x.numel() * x.element_size() for x in rt.utils.tree_leaves(params))
    print(f"  {arch} ({cfg.family}, {cfg.num_layers} of {rt.configs.get_config(arch).num_layers} "
          f"layers): {n} params, {nbytes / 1e9:.2f} GB, initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s (peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB)", flush=True)
    want = n_attn(cfg)
    kern = rt.k4.kernel_for(torch.bfloat16, cfg.head_dim) if want else "tc"
    expect = {**NO_COMPRESSION, "flash_attention": want, f"flash_attention_{kern}": want,
              "flash_attention_tc" if kern == "cc" else "flash_attention_cc": 0}
    tokens_shape = (b, cfg.num_codebooks, gen) if cfg.family == "audio" else (b, gen)
    for label in ("warm-up", "measured"):
        rt.gk.reset_launches()
        rt.k4.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        run = rt.serve.run_fixed(cfg, params, args, dev)
        torch.cuda.synchronize()
        counts = {**rt.gk.LAUNCHES, **rt.k4.LAUNCHES}
        check(counts == expect, f"{arch} {label}: launches {counts}, expected {expect}")
        check(bool(torch.isfinite(run.last_logits).all()),
              f"{arch} {label}: prefill logits not finite")
        check(tuple(run.tokens.shape) == tokens_shape,
              f"{arch} {label}: tokens {tuple(run.tokens.shape)}, expected {tokens_shape}")
        check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
              f"{arch} {label}: token ids out of range")
    summary = dict(run.summary, depth=cfg.num_layers,
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    # The prefill alone launches K4 once per attention block, the decode
    # loop never; the recurrent caches keep their shapes across steps.
    parts, state = serve_parts(rt, cfg, params, args, dev)
    split = []
    for i, part in enumerate(parts):
        rt.k4.reset_launches()
        if i == 1:
            shapes = [tuple(x.shape) for x in rt.utils.tree_leaves(state["cache"])]
        part()
        split.append(rt.k4.LAUNCHES["flash_attention"])
    torch.cuda.synchronize()
    check(split == [want, 0], f"{arch}: K4 launches prefill alone {split[0]}, decode loop "
          f"alone {split[1]}; expected {want} and 0")
    check([tuple(x.shape) for x in rt.utils.tree_leaves(state["cache"])] == shapes,
          f"{arch}: the decode cache changed shape")
    print(f"  {arch} measured ({card}): {json.dumps(summary)}; K4 {want} launches per "
          f"prefill ({kern if want else 'none'}), 0 per decode step", flush=True)
    if profile:
        profile_serving(parts, args)
    return summary, {k: counts[k] for k in ("flash_attention_tc", "flash_attention_cc")}, held


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# bfloat16 and mixed-dtype compression state: K1–K3's bf16 instances (phase 2)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# The bf16 instances the training paths launch (kernel, its instance in
# gk.INSTANCES, bytes and float operations per element, row name): K1 and
# K2 in bf16 on the trainer's fused path (every operand bf16), K2 in bf16
# and K3 promoting bf16 state with a float32 mask to float32 on the LM-FL
# phase's staged path. gmf_select reads v and m once (each radix pass
# reads them again).
BF16_KERNELS = [
    ("K1", "gmf_select", "bf16,bf16", 4, 19, "gmf_select_bf16"),
    ("K1", "gmf_compress", "bf16,bf16", 14, 10, "gmf_compress_bf16"),
    ("K2", "momentum_correction", "bf16,bf16->bf16", 10, 3, "momentum_correction_bf16"),
    ("K3", "apply_mask", "bf16,f32->f32", 20, 4, "apply_mask_bf16_to_f32"),
    ("K3", "apply_mask", "bf16,bf16->bf16", 12, 4, "apply_mask_bf16"),
]
LLAMA = "llama3.2-1b"
LLAMA_PARAMS = 1_498_482_688


def as_dtype(x, dtype, misalign=False):
    """``x`` in ``dtype`` (inputs rounded to 1/16 are exact in bf16), as a view
    one element past an aligned address when ``misalign``."""
    x = x.to(dtype)
    if not misalign:
        return x
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].reshape(x.shape)


def hold_bf16_elementwise(rt, dev):
    """K2 and K3's bf16 and mixed instances against their plain versions on
    the card, bitwise, over stacks of 1, 5, 3×1001, 20×36,864 and 2²⁴+3
    elements and a misaligned view: K2 with (state, gradient) dtypes
    (bf16, bf16), (f32, bf16), (bf16, f32) and the last again storing the
    state's dtype; K3 with a bf16 state and a float32 or bf16 mask, and
    storing the state's dtype. Returns the largest differences (0 when
    bitwise)."""
    gk, ref = rt.gk, rt.ref
    rng = np.random.default_rng(11)
    worst = {"momentum_correction": 0.0, "apply_mask": 0.0}
    cases = [(1, 1, False), (1, 5, False), (3, 1001, False), (20, 36_864, False),
             (1, 2**24 + 3, False), (3, 1001, True)]
    k2 = [(BF16, BF16, None), (torch.float32, BF16, None), (BF16, torch.float32, None),
          (BF16, torch.float32, BF16)]
    for rows, n, mis in cases:
        u, v, g = kernel_inputs(rng, rows, n, dev)
        for s, gd, out in k2:
            us, vs, gs = as_dtype(u, s, mis), as_dtype(v, s, mis), as_dtype(g, gd, mis)
            got = gk.momentum_correction_flat(us, vs, gs, 0.9, out)
            want = ref.momentum_correction_leaf(us, vs, gs, 0.9, out)
            for what, a, b in zip(("U", "V"), got, want, strict=True):
                check(a.dtype == b.dtype, f"K2 {s}/{gd}: {what} dtype {a.dtype} vs {b.dtype}")
                same(worst, "momentum_correction", a, b, f"{what} ({s}, {gd}, out {out})")
        mask = (torch.tensor(rng.random((rows, n)) > 0.7, device=dev)).float()
        ub, vb = as_dtype(u, BF16, mis), as_dtype(v, BF16, mis)
        for mk, out in ((as_dtype(mask, torch.float32, mis), None),
                        (as_dtype(mask, BF16, mis), None), (as_dtype(mask, torch.float32, mis),
                                                            BF16)):
            got = gk.apply_mask_flat(ub, vb, mk, out_dtype=out)
            want = ref.apply_mask_update_leaf(ub, vb, mk if out is None else mk.to(out))
            for what, a, b in zip(("G", "U", "V"), got, want, strict=True):
                check(a.dtype == b.dtype, f"K3 mask {mk.dtype}: {what} dtype {a.dtype}")
                same(worst, "apply_mask", a, b, f"{what} (mask {mk.dtype}, out {out})")
        print(f"  held {rows}x{n}{' misaligned' if mis else ''}: K2 (bf16/bf16, f32/bf16, "
              f"bf16/f32, bf16/f32 into bf16) and K3 (bf16 with a f32 or bf16 mask, into "
              f"f32 or bf16) bitwise", flush=True)
    torch.cuda.synchronize()
    return worst


def hold_bf16_select(rt, layout, u, v, m, label, dev):
    """gmf_select (both modes) and K1's mask pass over the ``[rows, N]``
    stacks u and v (of one dtype) and m: thresholds bitwise torch.topk's on
    the z of the kernel's own scalars, inverse norms within 1e-6 relative
    of the plain version's, the mask pass bitwise given the same scalars
    with every segment keeping at least its k, and the |z| mode's threshold
    and mask bitwise. Returns (largest differences, the fused mode's
    scalars)."""
    gk, ref, sparsify = rt.gk, rt.ref, rt.sparsify
    worst = {"gmf_select": 0.0, "gmf_compress": 0.0}
    rows = v.shape[0]
    keep_host, keep = layout.keep(RATE)
    offs = layout.offsets_dev
    w = torch.ones(rows, device=dev)
    tau = torch.tensor([(0.3, 0.0, 1.0)[i % 3] for i in range(rows)], device=dev)
    plan = layout.select_plan()
    inv_nv, inv_nm, thr = gk.gmf_select_flat(v, m, offsets=offs, plan=plan, keep=keep, w=w,
                                             tau=tau, eps=EPS)
    again = gk.gmf_select_flat(v, m, offsets=offs, plan=plan, keep=keep, w=w, tau=tau, eps=EPS)
    for what, a, b in zip(("inv_nv", "inv_nm", "thr"), (inv_nv, inv_nm, thr), again,
                          strict=True):
        check(torch.equal(a, b), f"gmf_select over {label}: two runs differ in {what}")
    p_nv, p_nm, _ = ref.gmf_select(v, m, layout, RATE, w=w, tau=tau, eps=EPS)
    for a, b in ((inv_nv, p_nv), (inv_nm, p_nm)):
        rel = ((a - b).abs() / b.abs()).max().item()
        check(rel <= 1e-6, f"gmf_select over {label}: inverse norms {rel:.3e} from the plain "
                           f"version's")
    z = ref.gmf_fusion_score(v, m, inv_norm_v=layout.expand(inv_nv),
                             inv_norm_m=layout.expand(inv_nm), tau=tau)
    same(worst, "gmf_select", thr, sparsify.segment_thresholds(z, layout, RATE),
         f"threshold over {label}")
    del z
    scal = dict(inv_norm_v=inv_nv, inv_norm_m=inv_nm, tau=tau, threshold=thr)
    got = gk.gmf_compress_flat(u, v, m, offsets=offs, **scal)
    want = ref.gmf_compress_segments(u, v, m, layout=layout, **scal)
    for what, a, b in zip(("G", "U", "V", "mask"), got, want, strict=True):
        check(a.dtype == v.dtype, f"gmf_compress over {label}: {what} is {a.dtype}")
        same(worst, "gmf_compress", a, b, f"{what} over {label}")
    kept = torch.stack([(x != 0).sum(1) for x in layout.segments(got[3])], dim=1)
    check(bool((kept >= torch.tensor(keep_host, device=dev)).all()),
          f"gmf_compress over {label}: a segment kept fewer than k_i")
    del got, want
    thr_a, mask_a = gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=keep)
    p_thr, p_mask = sparsify.segment_topk_mask(v, layout, RATE)
    same(worst, "gmf_select", thr_a, p_thr, f"|z| threshold over {label}")
    same(worst, "gmf_select", mask_a, p_mask, f"|z| mask over {label}")
    del p_mask
    thr_b, mask_b = gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=keep)
    check(torch.equal(thr_a, thr_b) and torch.equal(mask_a, mask_b),
          f"gmf_select's |z| mode over {label}: two runs differ")
    del mask_a, mask_b
    torch.cuda.synchronize()
    print(f"  held gmf_select (both modes, two runs each) and the K1 mask pass, v {v.dtype}, "
          f"m {m.dtype}, over {label} (tile {plan.plan.tile}: {plan.n_split} leaves split over "
          f"{plan.n_tiles} tiles, {plan.n_local} whole): bitwise", flush=True)
    return worst, scal


def f32_launches(instances):
    """Launches per kernel of its all-float32 instances only (the rows the
    float32 kernels report) from ``gk.INSTANCES``-style counts."""
    out = {name: 0 for _, name, _, _, _ in KERNELS}
    for (name, inst), n in instances.items():
        if "bf16" not in inst:
            out[name] = out.get(name, 0) + n
    return out


def llama_layout(rt, dev, num_layers=None):
    """(the config, its bf16 params on the card from a seed, their layout)."""
    from repro_torch.models import transformer

    cfg = rt.configs.get_config(LLAMA)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    return cfg, params, rt.flat.FlatLayout.of(params)


def hold_bf16_big_row(rt, layout, bw, peak, dev):
    """The bf16 instances over llama3.2-1b's whole flat row at one client
    (1,498,482,688 elements, 3.0 GB in bf16, so byte offsets pass 2^31 and
    the embedding's segment alone is 262.7M elements): each held bitwise
    against its plain version, then timed beside it with its bound. Returns
    (largest differences, {row name: timings})."""
    gk, ref = rt.gk, rt.ref
    n = layout.total
    check(n == LLAMA_PARAMS and 2 * n > 2**31, f"llama3.2-1b has {n} params")
    gen = torch.Generator(device=dev).manual_seed(13)

    def draw():  # normal, rounded to 1/16 (exact in bf16), [1, N] bf16
        x = torch.randn(n, generator=gen, device=dev)
        return x.mul_(16).round_().div_(16).to(BF16).reshape(1, n)

    worst = {"momentum_correction": 0.0, "apply_mask": 0.0}
    times = {}

    def timing(kid, name, inst, bpe, flops, row, kern, plain, reps=(5, 3)):
        # one rep, and no warm-up, for a call of a second or more: the hold
        # has just made the same call
        ms, plain_ms = (timed_ms(fn, reps=r, warmup=int(r > 1)) for fn, r in zip((kern, plain),
                                                                             reps, strict=True))
        bound_bytes, bound_ops = bpe * n / bw * 1e3, flops * n / peak * 1e3
        times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
                          bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                          at=f"llama3.2-1b's row [1, {n}], {layout.num_leaves} leaves")
        pr21 = f" (PR 21: {PR21_MS[row]})" if row in PR21_MS else ""
        print(f"  {kid} {name} [{inst}] at [1, {n}]: kernel {ms:.4f} ms{pr21} "
              f"({bpe * n / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, bound "
              f"{times[row]['bound_ms']:.4f} ms ({bpe * n / 1e9:.2f} GB)", flush=True)

    u, v, g = draw(), draw(), draw()
    got = gk.momentum_correction_flat(u, v, g, 0.9)
    want = ref.momentum_correction_leaf(u, v, g, 0.9)
    for what, a, b in zip(("U", "V"), got, want, strict=True):
        same(worst, "momentum_correction", a, b, f"{what} over the llama3.2-1b row")
    del got, want
    timing("K2", "momentum_correction", "bf16,bf16->bf16", 10, 3, "momentum_correction_bf16",
           lambda: gk.momentum_correction_flat(u, v, g, 0.9),
           lambda: ref.momentum_correction_leaf(u, v, g, 0.9))
    del g
    mask = torch.rand(1, n, generator=gen, device=dev).gt_(0.9).float()
    got = gk.apply_mask_flat(u, v, mask)
    want = ref.apply_mask_update_leaf(u, v, mask)
    for what, a, b in zip(("G", "U", "V"), got, want, strict=True):
        check(a.dtype == torch.float32, f"K3 over the llama row: {what} is {a.dtype}")
        same(worst, "apply_mask", a, b, f"{what} over the llama3.2-1b row")
    del got, want
    timing("K3", "apply_mask", "bf16,f32->f32", 20, 4, "apply_mask_bf16_to_f32",
           lambda: gk.apply_mask_flat(u, v, mask), lambda: ref.apply_mask_update_leaf(u, v, mask))
    mask = mask.to(BF16)  # the fused paths' instance: every operand bf16
    got = gk.apply_mask_flat(u, v, mask)
    want = ref.apply_mask_update_leaf(u, v, mask)
    for what, a, b in zip(("G", "U", "V"), got, want, strict=True):
        check(a.dtype == BF16, f"K3 over the llama row: {what} is {a.dtype}")
        same(worst, "apply_mask", a, b, f"{what} (bf16 mask) over the llama3.2-1b row")
    del got, want
    timing("K3", "apply_mask", "bf16,bf16->bf16", 12, 4, "apply_mask_bf16",
           lambda: gk.apply_mask_flat(u, v, mask), lambda: ref.apply_mask_update_leaf(u, v, mask))
    del mask
    torch.cuda.empty_cache()
    m = draw()
    sel, scal = hold_bf16_select(rt, layout, u, v, m, f"llama3.2-1b's row [1, {n}] (byte "
                                 f"offsets past 2^31)", dev)
    worst.update(sel)
    offs, keep, plan = layout.offsets_dev, layout.keep(RATE)[1], layout.select_plan()
    w, tau = torch.ones(1, device=dev), scal["tau"]
    timing("K1", "gmf_select", "bf16,bf16", 4, 19, "gmf_select_bf16",
           lambda: gk.gmf_select_flat(v, m, offsets=offs, plan=plan, keep=keep, w=w, tau=tau,
                                      eps=EPS),
           lambda: ref.gmf_select(v, m, layout, RATE, w=w, tau=tau, eps=EPS), reps=(10, 1))
    timing("K1", "gmf_select", "abs:bf16", 6, 5, "gmf_select_abs_bf16",
           lambda: gk.topk_abs_select_flat(v, offsets=offs, plan=plan, keep=keep),
           lambda: rt.sparsify.segment_topk_mask(v, layout, RATE), reps=(10, 1))
    timing("K1", "gmf_compress", "bf16,bf16", 14, 10, "gmf_compress_bf16",
           lambda: gk.gmf_compress_flat(u, v, m, offsets=offs, **scal),
           lambda: ref.gmf_compress_segments(u, v, m, layout=layout, **scal), reps=(5, 1))
    print(f"  gmf_select's plan here: tile {plan.plan.tile}, {plan.n_split} leaves split over "
          f"{plan.n_tiles} tiles, {plan.n_local} whole (the largest segment, {max(layout.sizes)} "
          f"elements, over {-(-max(layout.sizes) // plan.plan.tile)} blocks)", flush=True)
    del u, v, m
    torch.cuda.empty_cache()
    return worst, times


def hold_mixed_tree(rt, dev):
    """A tree of mixed dtypes through ``client_compress`` on the card:
    granite-moe-1b-a400m at its published widths, cut to 2 layers, in bf16
    with its float32 routers (two dtype groups), 3 clients, the fused and
    the staged dgcwgmf paths. The kernels' run is held bitwise against the
    same call on the plain versions (``kernels.ops`` told the tensors are
    not on the card), payloads, state and counts; each kernel launches once
    per group a call. Returns the largest differences."""
    from repro_torch.models import transformer

    core, flat = rt.core, rt.flat
    cfg = dataclasses.replace(rt.configs.get_config(GRANITE), num_layers=2)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    layout = flat.FlatLayout.of(params)
    check(layout.groups is not None and len(layout.groups) == 2,
          "granite-moe in bf16 should have a bf16 and a float32 group")
    gen = torch.Generator(device=dev).manual_seed(14)
    k = 3
    worst = {"gmf_select": 0.0, "gmf_compress": 0.0, "momentum_correction": 0.0,
             "apply_mask": 0.0}

    def stacks():  # normal, rounded to 1/16, [k, N_g] in each group's dtype
        return mixed_stacks(layout, k, gen, dev)

    grad = stacks()
    for label, kw, want_counts in (
            ("fused", {"use_kernels": True}, {"gmf_select": 2, "gmf_compress": 2,
                                              "momentum_correction": 2, "apply_mask": 0}),
            ("staged", {}, {"gmf_select": 2, "gmf_compress": 0, "momentum_correction": 2,
                            "apply_mask": 2})):
        scheme = core.resolve(core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3,
                                                     **kw))
        state = core.ClientState(u=stacks(), v=stacks(), m=stacks())
        gbar = tuple(x[0].clone() for x in stacks())
        rt.gk.reset_launches()
        got = scheme.client_compress(state, grad, gbar, 1, layout=layout)
        torch.cuda.synchronize()
        counts = dict(rt.gk.LAUNCHES)
        check(counts == want_counts, f"mixed tree, {label}: launches {counts}, expected "
                                     f"{want_counts} (one per dtype group)")
        with plain_versions(rt):
            want = scheme.client_compress(state, grad, gbar, 1, layout=layout)
        pairs = [(got[0], want[0], "payload")] + [
            (getattr(got[1], f), getattr(want[1], f), f) for f in ("u", "v", "m")]
        for a_t, b_t, what in pairs:
            for i, (a, b) in enumerate(zip(a_t, b_t, strict=True)):
                check(a.dtype == b.dtype, f"mixed tree {label}: {what} group {i} dtype")
                same(worst, "gmf_compress", a, b, f"{what} group {i} ({label})")
        check(torch.equal(got[2].upload_nnz, want[2].upload_nnz),
              f"mixed tree {label}: upload nnz {got[2].upload_nnz} vs {want[2].upload_nnz}")
        print(f"  held dgcwgmf ({label}) over granite-moe's mixed tree at 2 layers "
              f"({[str(d) for d in layout.dtypes]}, {[g.total for g in layout.groups]} "
              f"elements, {k} clients): bitwise, launches {counts}, nnz "
              f"{got[2].upload_nnz.tolist()}", flush=True)
    return worst


@contextlib.contextmanager
def plain_versions(rt, selects=None, worst=None):
    """Inside, every kernel wrapper takes its plain version (``kernels.ops``
    told that no tensor is on the card): the same call, no launch. With
    ``selects`` (the results of the kernels' ``gmf_select`` calls, in
    order, from ``recorded_selects``), each plain ``gmf_select`` is held as
    phase 2 holds it and then takes the kernel's scalars: the inverse norms
    within 1e-6 relative of the plain sums' (the kernel sums in another
    order), the thresholds bitwise the plain exact select's on the z of
    the kernel's own norms; so the rest of the call is held bitwise."""
    ops = rt.ops
    saved = ops._on_card, ops.momentum_correction, ops.gmf_select
    ops._on_card = lambda x: False
    ops.momentum_correction = lambda u, v, g, alpha, state_dtype=False: \
        rt.ref.momentum_correction(u, v, g, float(alpha), state_dtype)
    if selects is not None:
        ops.gmf_select = lambda *a, **k: held_select(rt, selects.pop(0), worst, *a, **k)
    try:
        yield
    finally:
        ops._on_card, ops.momentum_correction, ops.gmf_select = saved
    check(not selects, f"{len(selects or ())} gmf_select calls of the kernels' run not made "
                       f"again by the plain run")


@contextlib.contextmanager
def recorded_selects(rt, sink):
    """Inside, every ``ops.gmf_select`` result goes into ``sink`` too."""
    inner = rt.ops.gmf_select

    def record(*args, **kwargs):
        out = inner(*args, **kwargs)
        sink.append(out)
        return out

    rt.ops.gmf_select = record
    try:
        yield sink
    finally:
        rt.ops.gmf_select = inner


def held_select(rt, kernel_out, worst, v, m, layout, rate=None, *, keep=None, w, tau, eps):
    """The plain ``gmf_select`` held against the kernel's result on the same
    inputs (phase 2's hold): returns the kernel's scalars."""
    from repro_torch.core import fusion

    inv_nv, inv_nm, thr = kernel_out
    p_nv = fusion.rows(w, v) / (fusion.segment_norms(v, layout) + eps)
    p_nm = 1.0 / (fusion.segment_norms(m, layout) + eps)
    for a, b, what in ((inv_nv, p_nv, "inv_nv"), (inv_nm, p_nm, "inv_nm")):
        rel = ((a - b).abs() / b.abs()).max().item()
        worst["norm_rel"] = max(worst.get("norm_rel", 0.0), rel)
        check(rel <= 1e-6, f"gmf_select: {what} {rel:.3e} relative from the plain sums'")
    z = rt.ref.gmf_fusion_score(v, m, inv_norm_v=layout.expand(inv_nv),
                                inv_norm_m=layout.expand(inv_nm), tau=tau)
    want = (rt.sparsify.segment_thresholds(z, layout, rate) if keep is None
            else rt.sparsify.segment_keep_thresholds(z, layout, keep))
    same(worst, "mixed", thr, want, "gmf_select's thresholds on its own norms")
    return inv_nv, inv_nm, thr


def mixed_stacks(layout, k, gen, dev):
    """Normal draws rounded to 1/16, one ``[k, N_g]`` stack per dtype group
    in the group's dtype (exact in bf16)."""
    return tuple(torch.randn(k, g.total, generator=gen, device=dev).mul_(16).round_()
                 .div_(16).to(g.dtype) for g in layout.groups)


# ---------------------------------------------------------------------------
# phase 11b: a tree of mixed dtypes through every stage and engine
# ---------------------------------------------------------------------------

# The stages that work across leaves or key their draws by leaf (ROADMAP item
# 15), through client_compress over granite-moe's two dtype groups: each
# kernel's launches a call per group, and whether the server step runs too.
MIXED_STAGES = {
    "global top-k (dgc)": (dict(scheme="dgc", per_tensor=False, use_kernels=True),
                           {"momentum_correction": 1, "apply_mask": 1}, False),
    "global top-k up and down (dgcwgmf_dl)": (
        dict(scheme="dgcwgmf_dl", per_tensor=False, tau=0.3),
        {"momentum_correction": 1, "apply_mask": 1}, True),
    "random-k": (dict(scheme="randomk"), {}, False),
    "FetchSGD": (dict(scheme="fetchsgd"), {}, True),
    "probquant wire (dgcwgmf, fused)": (
        dict(scheme="dgcwgmf", wire_dtype="probquant", tau=0.3, use_kernels=True),
        {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1}, False),
    "Hadamard + int8 (dgc)": (dict(scheme="dgc", rotation_stage="hadamard", wire_dtype="int8"),
                              {"momentum_correction": 1, "gmf_select": 1, "apply_mask": 1},
                              False),
    "adaptive rates (dgcwgmf)": (dict(scheme="adaptive_dgcwgmf", tau=0.3,
                                      rate_wire_threshold=0.5),
                                 {"momentum_correction": 1, "gmf_select": 1, "apply_mask": 1},
                                 False),
    "adaptive rates, global top-k": (dict(scheme="adaptive_dgcwgmf", per_tensor=False, tau=0.3),
                                     {"momentum_correction": 1, "apply_mask": 1}, False),
}
MIXED_SKETCH_REL = 1e-5  # the sketch's atomics, of its largest magnitude (phase 20's)
MIXED_RATES = (0.05, 0.3)  # the adaptive cases' per-client rates (int8 for the second)


def groups_of(x):
    return x if isinstance(x, tuple) else (x,)


def hold_groups(worst, got, want, what, rel=None):
    """Each dtype group's tensor of ``got`` bitwise ``want`` (within ``rel``
    of its largest magnitude where given), dtypes equal."""
    for i, (a, b) in enumerate(zip(groups_of(got), groups_of(want), strict=True)):
        check(a.dtype == b.dtype, f"{what} group {i}: dtype {a.dtype} vs {b.dtype}")
        if rel is None:
            same(worst, "mixed", a, b, f"{what} group {i}")
        else:
            err = max_abs(a, b) / max(b.abs().max().item(), 1e-30)
            check(err <= rel, f"{what} group {i}: {err:.3e} of its largest magnitude > {rel}")


def hold_compress(worst, got, want, what, sketch=False):
    """A ``client_compress`` result against the plain version's."""
    hold_groups(worst, got[0], want[0], f"{what}: payload", MIXED_SKETCH_REL if sketch else None)
    for f in ("u", "v", "m"):
        a, b = getattr(got[1], f), getattr(want[1], f)
        if isinstance(a, (tuple, torch.Tensor)):
            hold_groups(worst, a, b, f"{what}: {f}")
    check(torch.equal(got[2].upload_nnz, want[2].upload_nnz),
          f"{what}: upload nnz {got[2].upload_nnz} vs {want[2].upload_nnz}")


def hold_mixed_stages(rt, dev):
    """(a) Each stage of ``MIXED_STAGES`` through ``client_compress`` (and
    the server step where it has one) over granite-moe at its published
    widths, 2 of 24 layers, bf16 beside its float32 routers, 2 clients: the
    launches (each kernel once per dtype group), then the same call on the
    plain versions, bitwise (FetchSGD's payload and sketch error within
    MIXED_SKETCH_REL: its buckets sum with atomics; its server on the
    card's summed sketch, hitters bitwise). Returns (the largest
    differences, each call's ms)."""
    from repro_torch.models import transformer
    from repro_torch.utils import tree_map

    core = rt.core
    cfg = dataclasses.replace(rt.configs.get_config(GRANITE), num_layers=2)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    layout = rt.flat.FlatLayout.of(params)
    gen = torch.Generator(device=dev).manual_seed(15)
    k = 2
    worst, ms = {"mixed": 0.0}, {}
    grad = mixed_stacks(layout, k, gen, dev)
    for label, (kw, per_group, server) in MIXED_STAGES.items():
        scheme = core.resolve(core.CompressionConfig(rate=RATE, **kw))
        fields = (scheme.uses_u, scheme.uses_v, scheme.uses_m)
        state = core.ClientState(*(mixed_stacks(layout, k, gen, dev) if used else {}
                                   for used in fields))
        gbar = tuple(x[0].clone() for x in mixed_stacks(layout, k, gen, dev))
        extra = dict(client_ids=torch.arange(k, device=dev) + 5)
        if scheme.rate_adaptive:
            extra.update(rates=torch.tensor(MIXED_RATES, device=dev),
                         wire_levels=torch.tensor([0, 1], dtype=torch.int32, device=dev))
        call = lambda: scheme.client_compress(state, grad, gbar, 1, layout=layout,  # noqa: E731
                                              **extra)
        t0 = time.perf_counter()
        rt.gk.reset_launches()
        with recorded_selects(rt, []) as selects:
            got = call()
        torch.cuda.synchronize()
        counts = {n: c for n, c in rt.gk.LAUNCHES.items() if c}
        want_counts = {n: 2 * c for n, c in per_group.items()}
        check(counts == want_counts, f"mixed tree, {label}: launches {counts}, expected "
                                     f"{want_counts} (one per dtype group)")
        with plain_versions(rt, selects, worst):
            want = call()
        hold_compress(worst, got, want, f"mixed tree, {label}", sketch=scheme.is_sketch)
        ms[label] = timed_ms(call, reps=2, warmup=0)
        line = (f"  held {label} over granite-moe's mixed tree ({k} clients): launches "
                f"{counts}, nnz {got[2].upload_nnz.tolist()}, {ms[label]:.3f} ms a call")
        if server:
            sst = core.ServerState(
                momentum=({"s_mom": torch.zeros(scheme.cfg.sketch_rows, scheme.cfg.sketch_cols,
                                                device=dev),
                           "s_err": torch.zeros(scheme.cfg.sketch_rows, scheme.cfg.sketch_cols,
                                                device=dev)}
                          if scheme.is_sketch else {}),
                residual=layout.zeros() if scheme.downlink_residual else {})
            g_sum = tree_map(lambda x: x.sum(0), got[0])
            srv = lambda: scheme.server_aggregate(sst, g_sum, float(k),  # noqa: E731
                                                  layout=layout, lr=0.1)
            rt.gk.reset_launches()
            b_got = srv()
            with plain_versions(rt):
                b_want = srv()
            hold_groups(worst, b_got[0], b_want[0], f"mixed tree, {label}: broadcast")
            if scheme.is_sketch:  # the hitters in each group's dtype, the error within rel
                check([x.dtype for x in b_got[0]] == list(layout.dtypes),
                      f"mixed tree, {label}: broadcast dtypes {[x.dtype for x in b_got[0]]}")
                hold_groups(worst, b_got[1].momentum["s_err"], b_want[1].momentum["s_err"],
                            f"mixed tree, {label}: sketch error", MIXED_SKETCH_REL)
            else:
                hold_groups(worst, b_got[1].residual, b_want[1].residual,
                            f"mixed tree, {label}: residual")
            check(int(b_got[2].download_nnz) == int(b_want[2].download_nnz) > 0,
                  f"mixed tree, {label}: download nnz {b_got[2].download_nnz}")
            line += f"; server bitwise, download nnz {int(b_got[2].download_nnz)}"
        print(line + " (bitwise the plain versions" +
              (", sketch within 1e-5" if scheme.is_sketch else "") +
              f"; {time.perf_counter() - t0:.1f} s)", flush=True)
        del got, want, state
    return worst, ms


# (b) the engines on LMTask at granite-moe's published widths (2 of 24 layers):
# 8 clients, 4 a round or tick, batch 2, sequence 128
MIXED_LM = dict(layers=2, clients=8, per_round=4, batch=2, seq_len=128)
MIXED_ENGINES = {  # label -> (CompressionConfig fields, rounds, FLConfig fields, launches
    #                            of each kernel a round or tick, both groups)
    "async, stragglers, buffer 4, global top-k (dgc)": (
        dict(scheme="dgc", per_tensor=False, use_kernels=True), 4,
        dict(backend="async", buffer_size=4, **STRAGGLERS),
        {"momentum_correction": 2, "apply_mask": 2}),
    "ring, 1 hop (dgcwgmf)": (ENGINE_DGCWGMF, 2, dict(topology="ring", ring_hops=1),
                              {"gmf_select": 4, "gmf_compress": 4, "momentum_correction": 4}),
    "hierarchical, 2 groups (hier_dgcwgmf)": (
        {**ENGINE_DGCWGMF, "scheme": "hier_dgcwgmf", "tier_rate": 0.1}, 2,
        dict(topology="hierarchical", groups=2),
        {"gmf_select": 4, "gmf_compress": 4, "momentum_correction": 4}),
    "shard, one-rank NCCL (dgcwgmf)": (ENGINE_DGCWGMF, 2, dict(backend="shard"),
                                       {"gmf_select": 2, "gmf_compress": 2,
                                        "momentum_correction": 2}),
}


def holding(rt, sim, worst, holds):
    """Wrap ``sim``'s compression calls (the engine's ``_compress_stack``;
    under the hierarchy the tier's ``client_compress`` too): each result
    held against the same call on the plain versions right after it, on
    the same inputs (the gradients the engine computed). ``holds`` gets
    (round, seconds) of each hold. Returns the undo."""
    eng = sim.engine

    def wrap(fn, what):
        def call(*args, **kwargs):
            with recorded_selects(rt, []) as selects:
                out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with plain_versions(rt, selects, worst):
                want = fn(*args, **kwargs)
            hold_compress(worst, out, want, f"{what}, round {len(sim.history)}")
            del want
            torch.cuda.synchronize()
            holds.append((len(sim.history), time.perf_counter() - t0))
            return out

        return call

    eng._compress_stack = wrap(eng._compress_stack, "the leaves' compression")
    tier = getattr(eng, "tier_scheme", None)
    if tier is None:
        return lambda: None
    # the tier's scheme behind a stand-in: its own calls (one per dtype group)
    # stay unwrapped, so a tier call is held once
    eng.tier_scheme = argparse.Namespace(
        **{name: getattr(tier, name) for name in ("is_sketch", "wire", "init_states")},
        client_compress=wrap(tier.client_compress, "the tier's compression"))

    def undo():
        eng.tier_scheme = tier

    return undo


def mixed_engines(rt, dev, card):
    """(b) ``MIXED_ENGINES`` on LMTask at granite-moe's published widths:
    every compression call held bitwise against the plain versions on the
    same gradients, each kernel's launches (once per dtype group a call),
    the upload counts, the params moved and finite. Returns (f32 launches,
    instances, the largest differences, ms a round or tick after round 0
    with the holds' time taken out)."""
    fl = rt.fl
    cfg = dataclasses.replace(rt.configs.get_config(GRANITE), num_layers=MIXED_LM["layers"])
    worst, ms, inst = {"mixed": 0.0}, {}, {}
    store = ROOT / "build" / "dist_store"
    for label, (kw, rounds, fl_kw, per_round) in MIXED_ENGINES.items():
        task = fl.LMTask(cfg, num_clients=MIXED_LM["clients"], batch_size=MIXED_LM["batch"],
                         seq_len=MIXED_LM["seq_len"], device=dev)
        comp = rt.core.CompressionConfig(rate=RATE, **kw)
        flc = fl.FLConfig(num_clients=MIXED_LM["clients"], clients_per_round=MIXED_LM["per_round"],
                          rounds=rounds, batch_size=MIXED_LM["batch"], learning_rate=0.1,
                          **fl_kw)
        shard = fl_kw.get("backend") == "shard"
        if shard:
            store.parent.mkdir(parents=True, exist_ok=True)
            store.unlink(missing_ok=True)
            torch.distributed.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                                                 world_size=1)
        holds = []
        try:
            sim = fl.FLSimulator(flc, comp, task.init_fn, task.loss_fn, device=dev)
            check(sim.layout.groups is not None, f"{label}: granite-moe is not a mixed tree")
            before = [x.clone() for x in rt.utils.tree_leaves(sim.params)]
            undo = holding(rt, sim, worst, holds)
            rt.gk.reset_launches()
            try:
                hist = sim.run(task.batch_provider)
            finally:
                undo()
            torch.cuda.synchronize()
        finally:
            if shard:
                torch.distributed.destroy_process_group()
                store.unlink(missing_ok=True)
        counts = {n: c for n, c in rt.gk.LAUNCHES.items() if c}
        for key, n in rt.gk.INSTANCES.items():
            inst[key] = inst.get(key, 0) + n
        peak = torch.cuda.max_memory_allocated()
        want = {n: rounds * c for n, c in per_round.items()}
        check(counts == want, f"{label}: launches {counts}, expected {want} (once per dtype "
                              f"group a compression call)")
        calls = rounds * (2 if "ring" in label or "hierarchical" in label else 1)
        check(len(holds) == calls, f"{label}: {len(holds)} compression calls held, {calls} "
                                   f"expected")
        leaves = rt.utils.tree_leaves(sim.params)
        check(all(bool(torch.isfinite(x).all()) for x in leaves)
              and any(not torch.equal(a, b) for a, b in zip(leaves, before, strict=True)),
              f"{label}: the params did not move, or are not finite")
        held = {r: sum(s for q, s in holds if q == r) for r in range(rounds)}
        ms[label] = [rec["round_ms"] - 1e3 * held[t] for t, rec in enumerate(hist)][1:]
        ups = [n for rec in hist for n in rec.get("upload_nnz", [])]
        print(f"  {label}: {rounds} {'ticks' if 'async' in label else 'rounds'}, launches "
              f"{counts}, {len(holds)} compression calls bitwise the plain versions (holds "
              f"{sum(s for _, s in holds):.1f} s); upload nnz min "
              f"{min(ups) if ups else 'n/a'}; ledger {json.dumps(sim.ledger.summary())}; "
              f"ms a {'tick' if 'async' in label else 'round'} after the first, holds out "
              f"({card}): {[round(x, 3) for x in ms[label]]}; peak so far {peak} B", flush=True)
        del sim, task, before, leaves
        gc.collect()  # the held wrappers close over the engine: a cycle
        torch.cuda.empty_cache()
    return f32_launches(inst), inst, worst, ms


def time_global_select(rt, dev, card, k=2):
    """Global top-k's select over granite-moe's two dtype groups (``[k,
    N_g]`` float32 scores each): the radix select over the groups' keys
    (``sparsify.group_kth_largest``, the path of groups cut over ranks)
    against ``torch.topk`` over their concatenation (the path of
    ``sparsify.grouped_topk_masks`` here): the same masks, each timed.
    Returns (radix ms, topk ms)."""
    from repro_torch.models import transformer

    sp = rt.sparsify
    cfg = dataclasses.replace(rt.configs.get_config(GRANITE), num_layers=2)
    layout = rt.flat.FlatLayout.of(transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1)))
    z = tuple(x.float().abs() for x in mixed_stacks(layout, k, torch.Generator(device=dev)
                                                    .manual_seed(16), dev))

    keep = torch.full((k,), sp.num_keep(layout.full_total, RATE), dtype=torch.int64,
                      device=dev)

    def by_radix():
        thr = sp.group_kth_largest([x.view(torch.int32) for x in z], keep, 31).to(
            torch.int32).view(torch.float32)
        return tuple((x >= thr[:, None]).float() for x in z)

    got = []
    radix = timed_ms(lambda: got.append(by_radix()), reps=1, warmup=0)  # one call: ~1 s
    want = sp.grouped_topk_masks(z, layout, RATE)
    for a, b in zip(got[0], want, strict=True):
        check(torch.equal(a, b), "global top-k: the radix select's masks differ from topk's")
    topk = timed_ms(lambda: sp.grouped_topk_masks(z, layout, RATE), reps=2, warmup=0)
    print(f"  global top-k's select over [{k}, {layout.full_total}] ({card}): radix select "
          f"over the groups' keys {radix:.3f} ms, torch.topk over their concatenation "
          f"{topk:.3f} ms; the same masks", flush=True)
    return radix, topk


def mixed_tree_phase(rt, dev, card):
    """Phase 11b (ROADMAP item 15): granite-moe at its published widths, 2
    of 24 layers, bf16 beside its float32 routers, through (a) every stage
    that works across leaves or keys its draws by leaf and (b) the async,
    ring, hierarchical and one-rank shard engines. Returns (f32 launches of
    (b), its instances, the largest differences, the ms)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    time_global_select(rt, dev, card)
    worst, stage_ms = hold_mixed_stages(rt, dev)
    print(f"  (a) in {time.perf_counter() - t0:.1f} s, peak {torch.cuda.max_memory_allocated()} "
          f"B allocated; ms a call ({card}): {json.dumps(stage_ms)}", flush=True)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches, inst, engine_worst, engine_ms = mixed_engines(rt, dev, card)
    print(f"  (b) in {time.perf_counter() - t1:.1f} s, peak {torch.cuda.max_memory_allocated()} "
          f"B allocated; phase 11b in {time.perf_counter() - t0:.1f} s", flush=True)
    worst["mixed"] = max(worst["mixed"], engine_worst["mixed"])
    return launches, inst, worst, {"stages": stage_ms, "engines": engine_ms}


# ---------------------------------------------------------------------------
# training: the one-device trainer and LMTask through the FL engines
# ---------------------------------------------------------------------------

TRAIN = dict(batch=8, seq_len=256, steps=4)
LMFL = dict(depth=2, clients=4, cohort=2, batch=2, seq_len=256, rounds=3)
TRAIN_DIR = ROOT / "build" / "train"  # the runs' metrics files (ignored by git)


def train_args(dev, extra):
    from repro_torch.launch import train

    return train, train.parser().parse_args(["--arch", LLAMA, "--log-every", "1",
                                             "--device", str(dev), *extra])


def exact_k(layout):
    return sum(layout.keep(RATE)[0])


def train_phase(rt, dev, card, k_sum, profile=False):
    """``launch/train.py``'s ``run_dist`` at ``mesh=None`` on llama3.2-1b at
    its published size (16 layers, d_model 2048, bf16, 1,498,482,688
    params): gmf_data (one GMF client) with dgcwgmf at rate 0.1 on the fused
    kernel path (the state stays bf16: K2, gmf_select and K1 in bf16), batch
    8, sequence 256, 4 steps; then the same with dense sync. Checks each
    upload count against the exact-k sum, the launches per step, finite
    losses; then profiles one more step of gmf_data (device busy share,
    the step's phases), and of dense too under ``profile``. ``k_sum`` is
    the exact-k sum of llama3.2-1b's layout. Returns (launch counts, instance counts, numbers)."""
    core = rt.core
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    cfg = rt.configs.get_config(LLAMA)
    check(cfg.param_count() == LLAMA_PARAMS and cfg.param_dtype == "bfloat16",
          f"{LLAMA}: {cfg.param_count()} params in {cfg.param_dtype}")
    out = {}
    launches = {name: 0 for name in rt.gk.LAUNCHES}
    instances = {}
    for sync in ("gmf_data", "dense"):
        train, args = train_args(dev, ["--grad-sync", sync, "--steps", str(TRAIN["steps"]),
                                      "--batch", str(TRAIN["batch"]),
                                      "--seq-len", str(TRAIN["seq_len"]),
                                      "--metrics-out", str(TRAIN_DIR / f"{sync}.json")])
        ccfg = core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3, use_kernels=True)
        torch.cuda.reset_peak_memory_stats()
        rt.gk.reset_launches()
        t0 = time.perf_counter()
        code = train.run_dist(args, ccfg, cfg, core.resolve(ccfg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, inst = dict(rt.gk.LAUNCHES), dict(rt.gk.INSTANCES)
        hist = json.loads((TRAIN_DIR / f"{sync}.json").read_text())
        losses = [h["loss"] for h in hist]
        check(len(hist) == TRAIN["steps"] and all(math.isfinite(x) for x in losses),
              f"train {sync}: losses {losses}")
        steps = TRAIN["steps"]
        if sync == "gmf_data":
            want = {"gmf_select": steps, "gmf_compress": steps, "momentum_correction": steps,
                    "apply_mask": 0}
            check(counts == want, f"train gmf_data: launches {counts}, expected {want}")
            for name, n in counts.items():
                launches[name] += n
            for key, n in inst.items():
                instances[key] = instances.get(key, 0) + n
            check(set(inst) == {("gmf_select", "bf16,bf16"), ("gmf_compress", "bf16,bf16"),
                                ("momentum_correction", "bf16,bf16->bf16")},
                  f"train gmf_data: instances {inst}")
            for h in hist:
                check(min(h["upload_nnz"]) >= k_sum,
                      f"train step {h['step']}: upload nnz {h['upload_nnz']} < {k_sum}")
        else:
            check(sum(counts.values()) == 0, f"dense sync launched {counts}")
        step_ms = [round(h["step_ms"], 3) for h in hist]
        per_step = {f"{k[0]}[{k[1]}]": n / steps for k, n in inst.items()}
        print(f"  {sync} ({card}): exit code {code}; loss per step {losses}; step ms "
              f"{step_ms} (step 0 first use); upload nnz {[h.get('upload_nnz') for h in hist]} "
              f"vs the exact-k sum {k_sum}; "
              f"launches per step by instance {json.dumps(per_step)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; {wall:.1f} s", flush=True)
        out[sync] = dict(step_ms=step_ms[1:], loss=losses, exit=code,
                         upload_nnz=[h.get("upload_nnz") for h in hist],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches_per_step=per_step)
        if sync == "gmf_data" or profile:
            out[sync]["profile"] = profile_train_step(rt, cfg, sync, ccfg, dev)
    return launches, instances, out


def profile_train_step(rt, cfg, sync, ccfg, dev):
    """One profiled step of ``make_train_step`` at the train phase's shape,
    on a fresh state (the run before it warmed the kernels and the
    allocator): the device busy share (the union of its
    activities' intervals over the profiled step's wall time) and the
    device time in each of the step's phase ranges."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
    from repro_torch.models import transformer

    t_all = time.perf_counter()
    dstep = rt.dstep
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=10, grad_sync=sync,
                       lr_schedule="cosine", warmup_steps=1)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = dstep.init_train_state(cfg, tcfg, ccfg, params)
    del params
    step_fn = dstep.make_train_step(cfg, tcfg, ccfg)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                               batch_size=TRAIN["batch"], seed=1)
    batch = to_tensors(next(stream), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del state
    torch.cuda.empty_cache()
    n_acts, busy, split = device_split(prof)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    top = sorted(kernels, key=device_us, reverse=True)[:10]
    print(f"    profiled {sync} step: {wall:.3f} ms, {n_acts} device activities, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f} %); set-up, step and trace "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    print_split(split)
    for e in top:
        print(f"      {device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return dict(step_ms=wall, busy_ms=busy, busy_share=busy / wall,
                split={k: v[1] for k, v in split.items()})


def lmfl_phase(rt, dev, card):
    """``launch/train.py``'s ``run_fl``: ``LMTask`` through ``FLSimulator`` at
    llama3.2-1b's published widths (d_model 2048, vocab 128,256, bf16) cut
    to 2 layers, 4 clients, 2 a round, batch 2, sequence 256, 3 rounds of
    dgcwgmf on the staged path (K2 in bf16, gmf_select's |z| mode on the
    float32 scores, K3 from the bf16 state to float32), lr 0.1. Checks
    each client's upload count against the exact-k sum, the launches, and
    that the server step moved the params in every round and that round 0
    lowered the held-out loss taken in float32. The task's own held-out loss is the
    reference's, in bf16, whose steps of 0.0625 at 12 hide a change that
    small; ``run_fl``'s exit code reads that one. Returns (launch counts,
    instance counts, numbers)."""
    core = rt.core
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.replace(rt.configs.get_config(LLAMA), num_layers=LMFL["depth"])
    train, args = train_args(dev, ["--backend", "fl", "--clients", str(LMFL["clients"]),
                                  "--cohort", str(LMFL["cohort"]), "--batch", str(LMFL["batch"]),
                                  "--seq-len", str(LMFL["seq_len"]), "--steps",
                                  str(LMFL["rounds"]), "--lr", "0.1",
                                  "--metrics-out", str(TRAIN_DIR / "lmfl.json")])
    ccfg = core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3)
    loss32 = rt.dstep.make_loss_fn(cfg)  # float32 logits; llama has no aux and no -1 labels
    watch = []  # (float32 held-out loss, params changed, norm of the change) per read

    class WatchedLMTask(rt.fl.LMTask):
        """LMTask that also reads the params at init and after each round."""

        def _read(self, params):
            leaves = [p.detach() for p in rt.utils.tree_leaves(params)]
            before = getattr(self, "_before", None) or leaves
            changed = sum(int((p != q).sum()) for p, q in zip(leaves, before, strict=True))
            norm = math.sqrt(sum(float((p.float() - q.float()).square().sum())
                                 for p, q in zip(leaves, before, strict=True)))
            self._before = [p.clone() for p in leaves]
            with torch.no_grad():
                watch.append((float(loss32(params, self.held_out)[0]), changed, norm))

        def init_fn(self, generator):
            params = super().init_fn(generator)
            self._read(params)
            return params

        def held_out_loss(self, params):
            self._read(params)
            return super().held_out_loss(params)

    torch.cuda.reset_peak_memory_stats()
    rt.gk.reset_launches()
    saved, rt.fl.LMTask = rt.fl.LMTask, WatchedLMTask  # run_fl imports it at call time
    t0 = time.perf_counter()
    try:
        code = train.run_fl(args, ccfg, cfg)
    finally:
        rt.fl.LMTask = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, inst = dict(rt.gk.LAUNCHES), dict(rt.gk.INSTANCES)
    hist = json.loads((TRAIN_DIR / "lmfl.json").read_text())
    r = LMFL["rounds"]
    want = {"gmf_select": r, "gmf_compress": 0, "momentum_correction": r, "apply_mask": r}
    check(counts == want, f"LM-FL: launches {counts}, expected {want}")
    check(inst.get(("momentum_correction", "bf16,bf16->bf16")) == r
          and inst.get(("apply_mask", "bf16,f32->f32")) == r,
          f"LM-FL: instances {inst}")
    k_sum = exact_k(llama_layout(rt, dev, LMFL["depth"])[2])
    for h in hist:
        check(len(h["upload_nnz"]) == LMFL["cohort"] and min(h["upload_nnz"]) >= k_sum,
              f"LM-FL round {h['round']}: upload nnz {h['upload_nnz']} < {k_sum}")
        check(math.isfinite(h["loss"]), f"LM-FL round {h['round']}: loss {h['loss']}")
    losses32 = [x[0] for x in watch]
    check(len(watch) == r + 1 and all(math.isfinite(x) for x in losses32),
          f"LM-FL: float32 held-out losses {losses32}")
    for t, (_, changed, norm) in enumerate(watch[1:]):
        check(changed > 0 and norm > 0, f"LM-FL round {t}: the params did not move")
    check(losses32[1] < losses32[0], f"LM-FL: round 0 did not lower the float32 held-out "
                                     f"loss: {losses32}")
    ms = [round(h["round_ms"], 3) for h in hist]
    print(f"  LM-FL ({card}): exit code {code} (the bf16 held-out loss); {cfg.param_count()} "
          f"params; held-out loss per round {[h['loss'] for h in hist]} (bf16), "
          f"{losses32} (float32, at init then after each round); params changed per round "
          f"{[x[1] for x in watch[1:]]}, norm of the change {[x[2] for x in watch[1:]]}; "
          f"ms/round {ms} (round 0 first use); upload "
          f"nnz {[h['upload_nnz'] for h in hist]} vs the exact-k sum {k_sum}; launches "
          f"{counts}; instances {json.dumps({f'{k[0]}[{k[1]}]': n for k, n in inst.items()})}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; {wall:.1f} s",
          flush=True)
    return counts, inst, dict(round_ms=ms[1:], loss=[h["loss"] for h in hist], exit=code,
                              loss_f32=losses32, changed=[x[1] for x in watch[1:]],
                              params=cfg.param_count())


def lmtask_card_vs_cpu_phase(rt, dev, tol=1e-2):
    """Each of the ten architectures at ``smoke()``: ``LMTask`` through
    ``FLSimulator`` on the card and on the CPU from the same params, 2
    rounds of dgcwgmf (the fused kernels on the card), 4 clients, 2 a
    round: the broadcast and the params within ``tol`` relative L2, every
    upload count at least the exact-k sum and within 1e-4 relative of the
    other device's (a score that ties a threshold on one device may not on
    the other). The client gradients are ``vmap(grad)`` on both,
    so the RG-LRU scan's and the MoE's gradient paths run on the card."""
    from repro_torch.models import transformer

    out = {}
    for arch in rt.configs.ARCH_IDS:
        cfg = rt.configs.get_smoke(arch)
        params = transformer.init_params(cfg, torch.Generator().manual_seed(3))
        runs = {}
        for device in ("cpu", dev):
            task = rt.fl.LMTask(cfg, num_clients=4, batch_size=2, seq_len=32, device=device)
            comp = rt.core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3,
                                             use_kernels=True)
            fl = rt.fl.FLConfig(num_clients=4, clients_per_round=2, rounds=2, batch_size=2,
                                learning_rate=0.1)
            sim = rt.fl.FLSimulator(
                fl, comp, lambda gen, d=device: rt.utils.tree_map(lambda x: x.to(d), params),
                task.loss_fn, device=device)
            hist = sim.run(task.batch_provider)
            runs[str(device)] = ([h["upload_nnz"] for h in hist],
                                 sim.layout.flatten(sim.params).float().cpu(),
                                 sim.gbar_prev.float().cpu())
        (n_c, p_c, b_c), (n_g, p_g, b_g) = runs["cpu"], runs[str(dev)]
        k_sum = exact_k(rt.flat.FlatLayout.of(params))
        for a, b in zip(np.ravel(n_g), np.ravel(n_c), strict=True):
            # each keeps at least the exact k; a score that ties the
            # threshold on one device may not on the other
            check(min(a, b) >= k_sum and abs(a - b) <= 1e-4 * b,
                  f"{arch} card vs CPU: upload nnz {n_g} vs {n_c} (exact-k sum {k_sum})")
        rel_p = float((p_g - p_c).norm() / p_c.norm())
        rel_b = float((b_g - b_c).norm() / b_c.norm())
        check(rel_p <= tol and rel_b <= tol,
              f"{arch} card vs CPU: params {rel_p:.3e}, broadcast {rel_b:.3e} relative L2")
        out[arch] = dict(params_rel_l2=rel_p, broadcast_rel_l2=rel_b)
    print(f"  LMTask card vs CPU, 2 rounds each (tolerance {tol}): {json.dumps(out)}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 16: llama3.2-1b through the continuous-batching engine
# ---------------------------------------------------------------------------

# Page 16, 130 pages a slot (2080 tokens: prompt_pad 2048 + 32 generated), 4
# slots; eight requests of these lengths, arriving 2 ticks apart.
ENGINE = dict(max_slots=4, page_size=16, pages_per_slot=130, prompt_pad=2048, gen=32,
              lengths=(2048, 1999, 1537, 2048, 1024, 2047, 1800, 2048), stagger=2)
ENGINE_WIRES = ("float32", "float16", "bfloat16", "int8")
# The keys of the reference's engine summary (src/repro/launch/serve.py:run_engine);
# tests/test_torch_serve.py holds this set equal to the JAX package's.
ENGINE_SUMMARY_KEYS = frozenset((
    "mode", "arch", "wire", "requests", "prompt_len", "gen", "max_slots", "page_size",
    "pages_per_slot", "decode_ticks", "generated_tokens", "wall_s", "tokens_per_s",
    "latency_p50_s", "latency_p99_s", "admit_wait_ticks_mean", "admit_wait_ticks_p99",
    "peak_active_slots", "peak_pages", "pool_pages", "page_pool_occupancy", "pool_bytes"))
POOL_BUDGET = 8 * 2**30  # the capacity line: slots an 8 GiB pool holds
ENGINE_RANGES = ("serve.admit", "serve.decode", "serve.finish")  # the engine's host ranges


def engine_config(rt, wire, gen=ENGINE["gen"]):
    return rt.serving.ServeConfig(
        max_slots=ENGINE["max_slots"], page_size=ENGINE["page_size"],
        pages_per_slot=ENGINE["pages_per_slot"], prompt_pad=ENGINE["prompt_pad"],
        max_new_tokens=gen, wire=wire)


def engine_prompts(rt, cfg):
    """The eight requests' prompts: rows of ``prompt_batch``'s draw (seed 0)
    cut to their lengths."""
    rows = rt.serve.prompt_batch(cfg, 0, len(ENGINE["lengths"]), ENGINE["prompt_pad"],
                                 "cpu")["tokens"].numpy().astype(np.int32)
    return [rows[i, :n] for i, n in enumerate(ENGINE["lengths"])]


def watch_logits(eng):
    """Wrap the engine's two steps so that every logits tensor's finiteness
    is ANDed into one device flag, read after the run (no read a tick)."""
    flag = torch.ones((), dtype=torch.bool, device=eng.device)
    for name in ("_prefill", "_step"):
        def watched(*args, fn=getattr(eng, name)):
            out = fn(*args)
            flag.logical_and_(torch.isfinite(out[1]).all())
            return out

        setattr(eng, name, watched)
    return flag


def engine_run(rt, cfg, params, wire, prompts, stagger, watch=False):
    """One engine run of ``prompts`` arriving ``stagger`` ticks apart:
    (engine, completions, metrics); with ``watch``, the logits are checked
    finite."""
    eng = rt.serving.ServeEngine(cfg, params, engine_config(rt, wire))
    for i, p in enumerate(prompts):
        eng.submit(p, arrival_tick=i * stagger)
    flag = watch_logits(eng) if watch else None
    comps, metrics = eng.run()
    label = f"engine {wire}, stagger {stagger}"
    check(len(comps) == len(prompts) and [c.rid for c in comps] == list(range(len(prompts))),
          f"{label}: {len(comps)} of {len(prompts)} requests completed")
    for c in comps:
        check(c.tokens.shape == (ENGINE["gen"],) and bool(
            ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"{label}: request {c.rid} tokens {c.tokens.shape} out of range or short")
    check(eng.alloc.num_free == eng.scfg.num_pages - 1 and not eng.alloc.live,
          f"{label}: the allocator holds {eng.alloc.num_live} pages after the drain")
    if watch:
        check(bool(flag), f"{label}: logits not finite")
    return eng, comps, metrics


def paged_equals_ring(rt, cfg, params, dev, steps=8):
    """16(a): 4 prompts of 2048 prefilled by the fixed step into the ring
    cache (cache_len 2080); the same K/V bytes written into a float32 pool
    over a scrambled page table; then ``steps`` decode steps each way at
    S = 4, logits and tokens bitwise equal at every step."""
    b, plen, ps, pps = (ENGINE[k] for k in ("max_slots", "prompt_pad", "page_size",
                                            "pages_per_slot"))
    tokens = rt.serve.prompt_batch(cfg, 0, b, plen, dev)["tokens"]
    last, cache = rt.dstep.make_prefill_step(cfg, cache_len=pps * ps)(params,
                                                                     {"tokens": tokens})
    codec = rt.serving.make_kv_codec("float32", cfg)
    num_pages = 1 + b * pps
    pool = rt.serving.init_pool(cfg, codec, num_pages, ps, device=dev)
    order = np.random.default_rng(16).permutation(np.arange(1, num_pages)).reshape(b, pps)
    tables = torch.from_numpy(order).to(dev)

    def write(entry, ring):
        for s in range(b):
            codec.write_pages(entry, ring["k"][s].reshape(pps, ps, *ring["k"].shape[2:]),
                              ring["v"][s].reshape(pps, ps, *ring["v"].shape[2:]), tables[s])

    for pe, ce in zip(pool["groups"], cache["groups"], strict=True):
        for layer in range(ce["k"].shape[0]):
            write({key: a[layer] for key, a in pe.items()},
                  {key: a[layer] for key, a in ce.items()})
    for pe, ce in zip(pool["tail"], cache["tail"], strict=True):
        write(pe, ce)
    serve = rt.dstep.make_serve_step(cfg)
    paged = rt.dstep.make_paged_serve_step(cfg, codec)
    tok_r = tok_p = torch.argmax(last, dim=-1)
    pos = torch.full((), plen, dtype=torch.int64, device=dev)
    lengths = torch.full((b,), plen, dtype=torch.int64, device=dev)
    for i in range(steps):
        tok_r, lg_r, cache = serve(params, cache, tok_r, pos)
        tok_p, lg_p, pool = paged(params, pool, tables, lengths, tok_p)
        check(torch.equal(lg_r, lg_p) and torch.equal(tok_r, tok_p),
              f"paged vs ring, step {i}: max |difference| "
              f"{float((lg_r - lg_p).abs().max()):.3e}, tokens {tok_r.tolist()} vs "
              f"{tok_p.tolist()}")
        pos = pos + 1
        lengths = lengths + 1
    print(f"  (a) paged float32 pool (scrambled table) vs ring cache, {b} x {plen} prompts, "
          f"{steps} decode steps at S = {b}: logits and tokens bitwise equal at every step",
          flush=True)


def engine_orders(rt, cfg, params, dev, prompts):
    """16(b): the eight requests staggered and all at tick 0, float32:
    every request's tokens equal; 4 slots at the peak, a later request
    waited for one, the pool drained. Prints, ungated, how many tokens of
    the 2048-token requests equal a fixed batch's of the same prompts.
    Returns the staggered run's completions."""
    runs = {}
    for stagger in (ENGINE["stagger"], 0):
        _, comps, metrics = engine_run(rt, cfg, params, "float32", prompts, stagger,
                                       watch=True)
        runs[stagger] = comps, metrics
    staggered, metrics = runs[ENGINE["stagger"]]
    together, _ = runs[0]
    for a, b in zip(staggered, together, strict=True):
        check(np.array_equal(a.tokens, b.tokens),
              f"request {a.rid}: staggered tokens {a.tokens.tolist()} vs simultaneous "
              f"{b.tokens.tolist()}")
    waited = [c.rid for c in staggered if c.admit_tick > ENGINE["stagger"] * c.rid]
    check(metrics["peak_active_slots"] == ENGINE["max_slots"] and waited,
          f"staggered: peak {metrics['peak_active_slots']} slots, waited {waited}")
    full = [i for i, n in enumerate(ENGINE["lengths"]) if n == ENGINE["prompt_pad"]]
    tokens = torch.from_numpy(np.stack([prompts[i] for i in full])).long().to(dev)
    prefill = rt.dstep.make_prefill_step(cfg, cache_len=ENGINE["prompt_pad"] + ENGINE["gen"])
    last, cache = prefill(params, {"tokens": tokens})
    pos = torch.full((), ENGINE["prompt_pad"], dtype=torch.int64, device=dev)
    fixed, _ = rt.serve.decode(rt.dstep.make_serve_step(cfg), params, cache,
                               torch.argmax(last, dim=-1), pos, ENGINE["gen"] - 1)
    fixed = torch.stack(fixed, dim=-1).cpu().numpy()
    same = sum(int((fixed[j] == staggered[i].tokens).sum()) for j, i in enumerate(full))
    print(f"  (b) 8 requests (lengths {list(ENGINE['lengths'])}), float32: staggered "
          f"({ENGINE['stagger']} ticks apart) and simultaneous tokens equal for every request;"
          f" peak {metrics['peak_active_slots']} slots, requests {waited} waited for a slot, "
          f"{metrics['decode_ticks']} decode ticks; the pool drained. Not gated: "
          f"{same} of {len(full) * ENGINE['gen']} tokens of requests {full} equal a fixed "
          f"batch's ({len(full)} x {ENGINE['prompt_pad']}, other GEMM shapes)", flush=True)
    return staggered


def engine_codecs(rt, cfg, params, prompts, card, f32_tokens):
    """16(c): each codec's staggered run, a warm-up (logits checked finite;
    float32's is 16(b)'s) then the measured one, K4's launches counted in
    it. Returns ({wire: numbers}, the float32 run's K4 launches)."""
    out, f32_k4 = {}, 0
    pages = engine_config(rt, "float32").num_pages
    for wire in ENGINE_WIRES:
        if wire != "float32":
            engine_run(rt, cfg, params, wire, prompts, ENGINE["stagger"], watch=True)
        rt.gk.reset_launches()
        rt.k4.reset_launches()
        eng, comps, m = engine_run(rt, cfg, params, wire, prompts, ENGINE["stagger"])
        counts = {**rt.gk.LAUNCHES, **rt.k4.LAUNCHES}
        n = cfg.num_layers * len(prompts)
        check(counts == {**NO_COMPRESSION, "flash_attention": n, "flash_attention_tc": n,
                         "flash_attention_cc": 0}, f"engine {wire}: launches {counts}")
        agree = sum(int((c.tokens == t).sum()) for c, t in zip(comps, f32_tokens, strict=True))
        if wire == "float32":
            check(agree == len(prompts) * ENGINE["gen"], "float32: the measured run's tokens "
                  f"differ from 16(b)'s staggered run's ({agree} equal)")
            f32_k4 = counts["flash_attention_tc"]
        bpp = rt.serving.bytes_per_page(eng.pool, pages)
        out[wire] = dict(tokens_per_s=m["tokens_per_s"], latency_p50_s=m["latency_p50_s"],
                         latency_p99_s=m["latency_p99_s"], decode_ticks=m["decode_ticks"],
                         peak_pages=m["peak_pages"], pool_bytes=m["pool_bytes"],
                         bytes_per_page=bpp,
                         slots_in_8gib=int(POOL_BUDGET // (bpp * ENGINE["pages_per_slot"])),
                         tokens_equal_float32=f"{agree} of {len(prompts) * ENGINE['gen']}",
                         k4_tc=counts["flash_attention_tc"])
        print(f"  (c) {wire} ({card}): {json.dumps(out[wire])}", flush=True)
        del eng
    return out, f32_k4


def engine_entry_point(rt):
    """16(d): ``launch/serve.py --mode engine`` at llama3.2-1b, the eight
    requests' shape (all of length 2048), with ``--warmup``: exit 0, and the
    reference's summary keys."""
    import io

    argv = ["--arch", "llama3.2-1b", "--mode", "engine", "--requests", "8", "--prompt-len",
            str(ENGINE["prompt_pad"]), "--gen", str(ENGINE["gen"]), "--stagger",
            str(ENGINE["stagger"]), "--max-slots", str(ENGINE["max_slots"]),
            "--pages-per-slot", str(ENGINE["pages_per_slot"]), "--warmup"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = rt.serve.main(argv)
    summary = json.loads(printed.getvalue().strip().splitlines()[-1])
    check(rc == 0 and set(summary) == ENGINE_SUMMARY_KEYS,
          f"serve --mode engine: exit {rc}, keys {sorted(summary)}")
    check(summary["requests"] == 8 and summary["generated_tokens"] == 8 * ENGINE["gen"],
          f"serve --mode engine: {summary}")
    print(f"  (d) python -m repro_torch.launch.serve {' '.join(argv)}: exit 0; "
          f"{json.dumps(summary)}", flush=True)


def profile_engine(rt, cfg, params, prompts):
    """16(e): a ``torch.profiler`` trace of one more float32 staggered run:
    the device's busy share (the union of its activities) in all and inside
    the decode ticks' host ranges, the costliest kernels, and the
    synchronize and ``cudaMemcpy*`` calls inside each of the engine's ranges
    by the op that made them and the copies' directions: no synchronize
    call and no device-to-host copy inside ``serve.decode``."""
    from torch.profiler import ProfilerActivity, profile

    eng = rt.serving.ServeEngine(cfg, params, engine_config(rt, "float32"))
    for i, p in enumerate(prompts):
        eng.submit(p, arrival_tick=i * ENGINE["stagger"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = eng.run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    acts, ranges, calls = [], {name: [] for name in ENGINE_RANGES}, []
    launched = dict.fromkeys(ENGINE_RANGES, 0.0)
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False):
                acts.append(iv)
        elif e.name in ranges:
            ranges[e.name].append(iv)
            launched[e.name] += e.device_time_total / 1e3
        elif e.name.startswith(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                "cudaEventSynchronize", "cudaMemcpy")):
            ops, up = [], e.cpu_parent
            while up is not None and len(ops) < 3 and up.name not in ranges:
                ops.append(up.name)
                up = up.cpu_parent
            kinds = sorted({k.name.split(" (")[0] for k in e.kernels}) or [
                "sync" if "Synchronize" in e.name else "no device activity linked"]
            calls.append((e.time_range.start, e.name, " < ".join(ops) or "-", "/".join(kinds)))
    busy = merged(acts)
    busy_ms = sum(hi - lo for lo, hi in busy) / 1e3
    decode = merged(ranges["serve.decode"])
    decode_ms = sum(hi - lo for lo, hi in decode) / 1e3
    inside = {}
    for at, call, ops, kind in calls:
        where = next((name for name, ivs in ranges.items()
                      if any(lo <= at <= hi for lo, hi in ivs)), "outside the ranges")
        inside[(where, call, ops, kind)] = inside.get((where, call, ops, kind), 0) + 1
    ticks = metrics["decode_ticks"]
    busy_decode = overlap(busy, decode) / 1e3
    print(f"  (e) profiled float32 run: {wall:.3f} ms wall, {len(acts)} device activities, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall:.1f} %); {ticks} decode ticks "
          f"in {decode_ms:.3f} ms of serve.decode host ranges, device busy inside them "
          f"{busy_decode:.3f} ms ({100 * busy_decode / decode_ms:.1f} %), kernels launched "
          f"from them {launched['serve.decode']:.3f} ms "
          f"({launched['serve.decode'] / ticks:.3f} ms a tick); admissions "
          f"{launched['serve.admit']:.3f} ms of kernels; synchronize and memcpy calls:",
          flush=True)
    for (where, call, ops, kind), n in sorted(inside.items()):
        print(f"    {where}: {n:5d}x {call} ({kind}) under {ops}", flush=True)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    for e in sorted(kernels, key=device_us, reverse=True)[:10]:
        print(f"    {device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    gathers = [e for e in kernels if "gather" in e.key]  # the page gathers (and the embedding's)
    gather_ms = sum(device_us(e) for e in gathers) / 1e3
    print(f"    gather kernels: {gather_ms:.3f} ms in {sum(e.count for e in gathers)} launches, "
          f"{gather_ms / ticks:.3f} ms a decode tick", flush=True)
    bad = {key: n for key, n in inside.items() if key[0] == "serve.decode"
           and (key[3] == "sync" or "DtoH" in key[3])}
    check(not bad, f"decode ticks: synchronize calls or device-to-host copies {bad}")


def engine_phase(rt, dev, card, profile=False):
    """Phase 16. Returns ({wire: numbers}, K4's launches in the measured
    float32 run)."""
    cfg = rt.configs.get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = rt.serve.init_params(cfg, 0, dev)
    paged_equals_ring(rt, cfg, params, dev)
    prompts = engine_prompts(rt, cfg)
    f32 = engine_orders(rt, cfg, params, dev, prompts)
    codecs, k4 = engine_codecs(rt, cfg, params, prompts, card, [c.tokens for c in f32])
    engine_entry_point(rt)
    if profile:
        profile_engine(rt, cfg, params, prompts)
    del params
    print(f"  phase 16 in {time.perf_counter() - t0:.1f} s", flush=True)
    return codecs, k4


# ---------------------------------------------------------------------------
# Phase 17: the mesh's data axes over a one-rank NCCL world
# ---------------------------------------------------------------------------

MESH_DIR = ROOT / "build" / "mesh"  # phase 17's store and metrics (ignored by git)
MESH_STEPS = 4  # (a)'s steps; (b)'s runs take MESH_STEPS // 2
# (a) and (b)'s depth: llama3.2-1b at its published widths, 2 of 16 layers
# (each run's whole state is copied to the host for the bitwise comparison)
MESH_LAYERS = 2
GRANITE = "granite-moe-1b-a400m"


def host_state(rt, state):
    """A host copy of what a train step leaves (params, opt, compression
    state, server state, broadcast), for a bitwise comparison."""
    return [x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x
            for x in rt.utils.tree_leaves((state.params, state.opt, state.cstate,
                                           state.sstate, state.gbar))]


def same_leaves(a, b, what):
    check(len(a) == len(b), f"{what}: {len(a)} leaves vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        equal = torch.equal(x, y) if torch.is_tensor(x) else x == y
        check(equal, f"{what}: leaf {i} differs")
    return len(a)


def mesh_train_run(rt, cfg, dev, sync, mesh, steps, snapshot_at=None):
    """``make_train_step`` as ``launch/train.py:run_dist`` drives it:
    llama3.2-1b's params from seed 0 on the card, the seeded stream (batch
    8 × 256), lr 3e-3 cosine over 4 steps, dgcwgmf at rate 0.1 on the fused
    path; over ``mesh`` each batch is cut to the rank's piece (the whole at
    one rank). Launch counts reset before the run and read after it.
    Returns (host state, per-step records, ms per step, launches by
    instance, host state after step ``snapshot_at``)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
    from repro_torch.dist import sharding as shr
    from repro_torch.models import transformer

    tcfg = TrainConfig(learning_rate=3e-3, total_steps=MESH_STEPS, grad_sync=sync,
                       lr_schedule="cosine", warmup_steps=max(1, MESH_STEPS // 20))
    ccfg = rt.core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3, use_kernels=True)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = rt.dstep.init_train_state(cfg, tcfg, ccfg, params, mesh)
    del params
    step = rt.dstep.make_train_step(cfg, tcfg, ccfg, mesh)
    b_sh = (shr.named_shardings(mesh, rt.dstep.step_batch_specs(cfg, tcfg, mesh))
            if mesh is not None else None)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                               batch_size=TRAIN["batch"], seed=0,
                               num_codebooks=cfg.num_codebooks, num_patches=cfg.num_patches,
                               d_model=cfg.d_model)
    rt.gk.reset_launches()
    recs, ms, snap = [], [], None
    for t, b in zip(range(steps), stream, strict=False):
        batch = to_tensors(b, dev)
        if b_sh is not None:
            batch = shr.local_tree(batch, b_sh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        rec = {"loss": float(m["loss"])}
        ms.append((time.perf_counter() - t0) * 1e3)
        if sync != "dense":
            rec.update(upload_nnz=m["upload_nnz"].tolist(), download_nnz=int(m["download_nnz"]))
        recs.append(rec)
        if t == snapshot_at:
            snap = host_state(rt, state)
    torch.cuda.synchronize()
    inst = dict(rt.gk.INSTANCES)
    out = host_state(rt, state)
    del state, step
    torch.cuda.empty_cache()
    return out, recs, ms, inst, snap


def mesh_training(rt, dev, card, mesh2, mesh3):
    """(a) gmf_data at (1, 1) bitwise the mesh-less run, 4 steps, ms/step of
    both; (b) dense at (1, 1) bitwise dense without a mesh and gmf_pod at
    (1, 1, 1) bitwise gmf_data at (1, 1), 2 steps each. Returns the mesh
    runs' launches by instance."""
    cfg = dataclasses.replace(rt.configs.get_config(LLAMA), num_layers=MESH_LAYERS)
    fused = {("gmf_select", "bf16,bf16"): 1, ("gmf_compress", "bf16,bf16"): 1,
             ("momentum_correction", "bf16,bf16->bf16"): 1}
    less, less_recs, less_ms, less_inst, _ = mesh_train_run(rt, cfg, dev, "gmf_data", None,
                                                            MESH_STEPS)
    meshed, recs, ms, inst, two = mesh_train_run(rt, cfg, dev, "gmf_data", mesh2, MESH_STEPS,
                                                 snapshot_at=MESH_STEPS // 2 - 1)
    n = same_leaves(meshed, less, "(a) gmf_data at (1, 1) vs no mesh")
    check(recs == less_recs, f"(a) records {recs} vs {less_recs}")
    want = {k: MESH_STEPS * v for k, v in fused.items()}
    check(inst == want == less_inst, f"(a) launches {inst} (no mesh {less_inst}), "
                                     f"expected {want}")
    print(f"  (a) gmf_data at mesh (1, 1) ({card}): {MESH_STEPS} steps bitwise the mesh-less "
          f"run ({n} tensors; losses {[r['loss'] for r in recs]}, upload nnz "
          f"{[r['upload_nnz'] for r in recs]}); ms/step after step 0: mesh "
          f"{[round(x, 3) for x in ms[1:]]}, no mesh {[round(x, 3) for x in less_ms[1:]]}; "
          f"launches {json.dumps({f'{k[0]}[{k[1]}]': v for k, v in inst.items()})}",
          flush=True)
    del less, meshed
    half = MESH_STEPS // 2
    d_less, d_recs_less, d_ms_less, d_inst, _ = mesh_train_run(rt, cfg, dev, "dense", None, half)
    d_mesh, d_recs, d_ms, d_inst_mesh, _ = mesh_train_run(rt, cfg, dev, "dense", mesh2, half)
    n = same_leaves(d_mesh, d_less, "(b) dense at (1, 1) vs no mesh")
    check(d_recs == d_recs_less and not d_inst and not d_inst_mesh,
          f"(b) dense: records {d_recs} vs {d_recs_less}; launches {d_inst_mesh}")
    del d_less, d_mesh
    pod, p_recs, p_ms, p_inst, _ = mesh_train_run(rt, cfg, dev, "gmf_pod", mesh3, half)
    m = same_leaves(pod, two, "(b) gmf_pod at (1, 1, 1) vs gmf_data at (1, 1)")
    check(p_recs == recs[:half], f"(b) gmf_pod records {p_recs} vs {recs[:half]}")
    want = {k: half * v for k, v in fused.items()}
    check(p_inst == want, f"(b) gmf_pod launches {p_inst}, expected {want}")
    print(f"  (b) dense at (1, 1) ({card}): {half} steps bitwise dense without a mesh ({n} "
          f"tensors), ms/step {[round(x, 3) for x in d_ms]} vs {[round(x, 3) for x in d_ms_less]}"
          f"; gmf_pod at (1, 1, 1): {half} steps bitwise gmf_data at (1, 1) ({m} tensors), "
          f"ms/step {[round(x, 3) for x in p_ms]}", flush=True)
    del pod, two
    torch.cuda.empty_cache()
    return {k: inst.get(k, 0) + p_inst.get(k, 0) for k in set(inst) | set(p_inst)}


def counting(module, name, sink, fn):
    """``module.name`` wrapped to append ``fn(result)`` to ``sink``;
    returns the original, to put back."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        out = real(*a, **k)
        sink.append(fn(out))
        return out

    setattr(module, name, wrapped)
    return real


def mesh_ep_serving(rt, dev, card, mesh2, cpu_mesh, served):
    """(c) granite-moe-1b-a400m at its published widths, 12 of 24 layers
    (phase 13's cut), bf16, batch 4, prompt 2048, 16 tokens, through
    ``run_fixed`` over the (1, 1) mesh: every MoE layer of the prefill and
    of each decode step runs ``moe_ep`` (its all-to-all body at one rank);
    a warm-up run, the measured run and a second one bitwise equal to it;
    K4 12 launches a prefill, K1–K3 none; the dropped (token, expert)
    assignments counted in one more prefill; then card vs CPU at phase 6's
    granite shape (smoke widths, 2 layers, float32) through EP on both
    sides. Returns the measured run's tensor-core K4 launches."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(rt.configs.get_config(GRANITE), num_layers=12)
    check(cfg.moe_impl == "ep", f"{GRANITE}: moe_impl {cfg.moe_impl}, expected ep")
    args = rt.serve.parser().parse_args(["--arch", GRANITE, "--batch", "4", "--prompt-len",
                                         "2048", "--gen", "16"])
    params = rt.serve.init_params(cfg, args.seed, dev)
    want = n_attn(cfg)
    expect = {**NO_COMPRESSION, "flash_attention": want, "flash_attention_tc": want,
              "flash_attention_cc": 0}
    calls = []
    real = counting(moe, "moe_ep", calls, lambda out: 1)
    try:
        runs = []
        for label in ("warm-up", "measured", "again"):
            rt.gk.reset_launches()
            rt.k4.reset_launches()
            calls.clear()
            run = rt.serve.run_fixed(cfg, params, args, dev, mesh=mesh2)
            torch.cuda.synchronize()
            counts = {**rt.gk.LAUNCHES, **rt.k4.LAUNCHES}
            check(counts == expect, f"(c) {label}: launches {counts}, expected {expect}")
            ep = cfg.num_layers * args.gen  # the prefill's and 15 decode steps' layers
            check(len(calls) == ep, f"(c) {label}: moe_ep ran {len(calls)} times, expected {ep}")
            check(bool(torch.isfinite(run.last_logits).all()), f"(c) {label}: logits not finite")
            runs.append(run)
    finally:
        moe.moe_ep = real
    check(torch.equal(runs[1].tokens, runs[2].tokens)
          and torch.equal(runs[1].last_logits, runs[2].last_logits),
          "(c) two card runs through moe_ep differ")
    dropped = []
    real = counting(moe, "dispatch_local", dropped,
                    lambda out: (out[3].numel(), out[3].numel() - out[3].sum()))
    try:
        prefill = rt.dstep.make_prefill_step(cfg, mesh2, cache_len=args.prompt_len + args.gen)
        prefill(params, rt.serve.prompt_batch(cfg, args.seed, args.batch, args.prompt_len, dev))
    finally:
        moe.dispatch_local = real
    total = sum(n for n, _ in dropped)
    lost = int(sum(d for _, d in dropped))
    summary = runs[1].summary
    print(f"  (c) {GRANITE} through moe_ep at mesh (1, 1) ({card}, {cfg.num_layers} of 24 "
          f"layers): prefill_ms {summary['prefill_ms']}, ms_per_step {summary['ms_per_step']}, "
          f"tokens_per_s {summary['tokens_per_s']} (phase 13's dense dispatch: prefill_ms "
          f"{served.get(GRANITE, {}).get('prefill_ms')}, ms_per_step "
          f"{served.get(GRANITE, {}).get('ms_per_step')}); capacity "
          f"{moe.capacity_per_expert(args.batch * args.prompt_len, cfg)} a layer; dropped "
          f"{lost} of {total} (token, expert) assignments in a prefill; K4 {want} a prefill; two "
          f"runs bitwise", flush=True)
    del params, runs
    torch.cuda.empty_cache()
    small = dataclasses.replace(rt.configs.get_smoke(GRANITE), num_layers=2, dtype="float32",
                                param_dtype="float32", moe_impl="ep")
    card_vs_cpu_case(rt, dev, "(c) granite-moe through moe_ep", small, 1e-4, 4, 2, 64,
                     meshes=(mesh2, cpu_mesh))
    return want


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_entry_point(card):
    """(d) ``python -m repro_torch.launch.train`` in a one-rank ``torchrun``-
    style environment: ``--mesh-shape 1,1`` gmf_data on llama3.2-1b (4
    steps, ``--use-kernels``: phase 14's fused path; the staged path's
    float32 state does not fit the card at this size) exits 0 and prints
    its mesh; ``--mesh-shape 2,1`` exits nonzero with the reference's
    message."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--backend", "dist", "--arch",
            LLAMA, "--grad-sync", "gmf_data", "--steps", "4", "--log-every", "1",
            "--use-kernels"]
    out = {}
    procs = {}
    t0 = time.perf_counter()
    for shape, ok in (("1,1", True), ("2,1", False)):  # both at once
        env = dict(os.environ, PYTHONPATH=str(SRC), RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        extra = ["--metrics-out", str(MESH_DIR / "entry.json")] if ok else []
        procs[shape] = subprocess.Popen([*base, "--mesh-shape", shape, *extra], env=env,
                                        cwd=ROOT, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
    logs = {}
    try:
        for shape, p in procs.items():
            logs[shape] = p.communicate(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for shape, ok in (("1,1", True), ("2,1", False)):
        rc, (stdout, stderr) = procs[shape].returncode, logs[shape]
        if ok:
            check(rc == 0 and "mesh={'data': 1, 'model': 1}" in stdout,
                  f"(d) --mesh-shape 1,1 exited {rc}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
            hist = json.loads((MESH_DIR / "entry.json").read_text())
            out[shape] = [round(h["step_ms"], 3) for h in hist]
            print(f"  (d) launch.train --mesh-shape 1,1 ({card}): exit 0; "
                  f"{[ln for ln in stdout.splitlines() if 'mesh=' in ln][0]}; step ms "
                  f"{out[shape]} (step 0 first use)", flush=True)
        else:
            msg = "Number of devices 1 must be >= the product of mesh_shape (2, 1)"
            check(rc != 0 and msg in stderr,
                  f"(d) --mesh-shape 2,1 on one rank exited {rc}:\n{stderr[-3000:]}")
            print(f"  (d) --mesh-shape 2,1 on one rank: exit {rc} with the reference's "
                  f"message ({msg!r})", flush=True)
    print(f"  (d) both entry points in {wall:.1f} s", flush=True)
    return out


def mesh_phase(rt, dev, card, served):
    """Phase 17: (d) first, while this process holds the least of the
    card's memory (the entry point trains full llama3.2-1b in a process of
    its own); then one world of one rank (NCCL for the card's tensors, gloo
    for the CPU's, from a ``file://`` store in ``build/mesh``), (a)–(c)
    over meshes of it, torn down at the end. Returns (the mesh training
    runs' launches by instance, the EP serving run's tensor-core K4
    launches)."""
    import gc

    from repro_torch.launch.mesh import make_mesh

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"  this process holds {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB; "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card", flush=True)
    mesh_entry_point(card)
    store = MESH_DIR / "store"
    store.unlink(missing_ok=True)
    torch.distributed.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                                         rank=0, world_size=1)
    try:
        mesh2 = make_mesh((1, 1), ("data", "model"))
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
        cpu_mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        check(torch.distributed.get_backend(mesh2.get_group("data")) in ("nccl",
                                                                         "cpu:gloo,cuda:nccl"),
              f"the card's mesh runs {torch.distributed.get_backend(mesh2.get_group('data'))}")
        inst = mesh_training(rt, dev, card, mesh2, mesh3)
        k4 = mesh_ep_serving(rt, dev, card, mesh2, cpu_mesh, served)
    finally:
        torch.distributed.destroy_process_group()
        store.unlink(missing_ok=True)
    return inst, k4


# ---------------------------------------------------------------------------
# phase 18: the model axis (tensor parallelism)
# ---------------------------------------------------------------------------

TP_DIR = ROOT / "build" / "tp"  # phase 18's stores and the workers' results (ignored by git)
# (b): llama3.2-1b at full width, 2 of 16 layers, bf16, batch 8 x 256, 2 steps
TP_TRAIN = dict(layers=2, batch=8, seq_len=256, steps=2)
# (c): llama3.2-1b at full width, 2 layers, float32, batch 4, prompt 256, 8 tokens
TP_SERVE = dict(layers=2, batch=4, prompt_len=256, gen=8)
TP_TRAIN_TOL, TP_SERVE_TOL = 1e-2, 1e-4  # phase 14's bf16 tolerance; phase 6's float32 one
# (b)'s gmf_data against the mesh-less run, a step: the upload counts may
# differ by TP_NNZ_FLIPS entries (bf16 gradients that differ in their last
# bit move tied scores across a threshold), and the change of the params
# (final minus initial, bf16: an update near half a unit in the last place
# rounds either way) by TP_DELTA_TOL relative L2. On an H100 a sound run
# read at most 33,188 and 0.108; with the norms' all-reduce dropped from
# the group mode 193,547 and 0.110 (the group select over the two ranks
# catches that one); with the histograms' dropped over 75 million and at
# least 0.367 (PERF.md)
TP_NNZ_FLIPS, TP_DELTA_TOL = 100_000, 0.2
# (b)'s group select over the two ranks: leaf -> (whole shape, the dim cut
# over the ranks or None), [TP_SELECT_ROWS, *shape] stacks; "a" and "e" are
# cut along columns (a rank's piece strided in the leaf's order), "d" is
# whole on each rank but spans several tiles (a split segment after the
# cut ones), "b" is one tile
TP_SELECT = {"a": ((512, 512), 1), "b": ((4096,), None), "c": ((256, 512), 0),
             "d": ((200_000,), None), "e": ((64, 8), 1)}
TP_SELECT_ROWS = 3


def group_table(rt, layout, dev):
    """The group mode's plan of ``layout`` with every segment counted as cut
    over the group: at a group of one each takes the tiles, the sums and the
    scans the group mode gives a cut segment."""
    gk = rt.gk
    plan = gk.plan_select(layout.sizes, gk.select_tile(layout.sizes))
    return gk.select_table(plan, dev, group=[True] * layout.num_leaves)


# gmf_select's group mode: its launches a call where every segment is split
# (the first, (fused) the sample, three radix passes, the last) and its
# all-reduces a call over a group (GROUP_SUMS)
GROUP_STEPS = {"fused": 6, "abs": 5}
GROUP_ALL_REDUCES = {"fused": 4, "abs": 3}


def group_record(gk, plan, rows, dev, elt: int, fused: bool) -> dict:
    """The last group-mode call's paths over ``plan``
    (``gk.group_select_paths``; the kernel's own count of full-read tiles
    held against the rule's) and the bytes an element they imply: two full
    reads of ``elt`` bytes an element (fused: the norms and pass 0; |z|:
    pass 0 and the mask's read, beside the mask's 4-byte write), the tiles
    read in full again in passes 1 and 2, the samples, and 4 bytes a
    candidate written in pass 0 and read in each of passes 1 and 2."""
    rec = gk.group_select_paths(plan, rows, dev)
    check(rec["full_tiles"] == rec["full_tiles_by_rule"],
          f"the group mode read {rec['full_tiles']} tiles in full, its brackets and counts give "
          f"{rec['full_tiles_by_rule']}")
    n = rec["elements"]
    moved = (2 * n * elt + 2 * rec["full_elements"] * elt + rec["sampled"] * elt
             + 4 * rec["kept"] + 8 * rec["counted"] + (0 if fused else 4 * n))
    rec.update(bytes_per_element=moved / n, candidate_share=rec["kept"] / n)
    return rec


def paths_words(rec) -> str:
    return (f"{rec['segments'] - rec['full_segments']} of {rec['segments']} segments counted "
            f"their candidates alone in passes 1-2, {rec['full_tiles']} of the tiles read in "
            f"full ({rec['missed_tiles']} by a missed bracket, {rec['overflowed_tiles']} "
            f"overflowed); candidates {100 * rec['candidate_share']:.2f} % of the elements, "
            f"{rec['bytes_per_element']:.3f} bytes an element moved")


def host_ms(fn, calls: int = 20) -> float:
    """ms of the host's clock a call of ``fn`` takes to issue its work
    (``calls`` calls in a row after a warm-up, no synchronize between)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return out


def device_ms(fn, calls: int = 20) -> float:
    """ms a call of ``fn`` from CUDA events around ``calls`` calls in a row
    after a warm-up: the device's time where it, not the host, is behind."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def group_steps_ms(gk, op_name, call, reps: int = 5) -> dict:
    """Each group-mode step's device ms (median over ``reps`` calls, after
    a warm-up): CUDA events around each of ``call()``'s launches of the
    module's ``op_name`` operator, called with no group (no all-reduce
    between the steps). Keyed "step/pass"."""
    real, marks = getattr(gk, op_name), []

    def timed(step, p, *a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        real(step, p, *a)
        end.record()
        marks.append((f"{step}/{p}", start, end))

    call()
    setattr(gk, op_name, timed)
    try:
        for _ in range(reps):
            call()
    finally:
        setattr(gk, op_name, real)
    torch.cuda.synchronize()
    by = {}
    for key, start, end in marks:
        by.setdefault(key, []).append(start.elapsed_time(end))
    return {k: statistics.median(x) for k, x in by.items()}


def hold_group_one(rt, label, layout, v, m, keep, w, tau, group, dev, timing=False,
                   plain=True):
    """``gmf_select``'s group mode over a one-rank NCCL ``group``, both modes,
    against the single launch on the same inputs: thresholds, inverse norms,
    the |z| mask and its keep counts bitwise; with ``plain``, against its
    plain version too (thresholds bitwise ``torch.topk``'s per segment on the
    z of its own scalars, the |z| threshold and mask the plain version's).
    Each mode's steps (``GROUP_STEPS``) and all-reduces a call are counted
    and its paths read back (``group_record``). With ``timing`` both
    launches are timed (CUDA events around the wrapper call, host in), and
    the group mode's device time alone (``device_ms`` over calls with no
    group: no all-reduce between the steps). Returns the times, the paths
    and the largest absolute difference from the single launch
    (``max_abs_err``)."""
    gk = rt.gk
    offs, one, grp = layout.offsets_dev, layout.select_plan(), group_table(rt, layout, dev)
    rows = v.shape[0]
    kw = dict(offsets=offs, keep=keep, w=w, tau=tau, eps=EPS)
    single = gk.gmf_select_flat(v, m, plan=one, **kw)
    steps, sums = [], sum(gk.GROUP_SUMS.values())
    real = counting(gk, "_select_group_op", steps, lambda _: 1)
    try:
        grouped = gk.gmf_select_flat(v, m, plan=grp, group=group, **kw)
    finally:
        gk._select_group_op = real
    counts = {"fused": (len(steps), sum(gk.GROUP_SUMS.values()) - sums)}
    out = {"paths": group_record(gk, grp, rows, dev, v.element_size() + m.element_size(), True)}
    err = 0.0
    for what, a, b in zip(("inv_nv", "inv_nm", "thr"), grouped, single, strict=True):
        err = max(err, max_abs(a, b))
        check(torch.equal(a, b), f"(a) group mode over {label}: {what} differs from the single "
                                 f"launch's")
    steps, sums = [], sum(gk.GROUP_SUMS.values())
    real = counting(gk, "_select_abs_group_op", steps, lambda _: 1)
    try:
        thr, mask = gk.topk_abs_select_flat(v, offsets=offs, plan=grp, keep=keep, group=group)
    finally:
        gk._select_abs_group_op = real
    counts["abs"] = (len(steps), sum(gk.GROUP_SUMS.values()) - sums)
    out["abs_paths"] = group_record(gk, grp, rows, dev, v.element_size(), False)
    for mode, (n_steps, n_sums) in counts.items():
        check(n_steps == GROUP_STEPS[mode] and n_sums == GROUP_ALL_REDUCES[mode],
              f"(a) group mode's {mode} mode over {label}: {n_steps} launches and {n_sums} "
              f"all-reduces a call, expected {GROUP_STEPS[mode]} and {GROUP_ALL_REDUCES[mode]}")
    thr1, mask1 = gk.topk_abs_select_flat(v, offsets=offs, plan=one, keep=keep)
    err = max(err, max_abs(thr, thr1), max_abs(mask, mask1))
    check(torch.equal(thr, thr1) and torch.equal(mask, mask1),
          f"(a) group mode's |z| mode over {label}: threshold or mask differs")
    kept = [int(torch.count_nonzero(seg)) for seg in layout.segments(mask)]
    check(kept == [int(torch.count_nonzero(seg)) for seg in layout.segments(mask1)],
          f"(a) group mode's |z| mode over {label}: keep counts differ")
    if plain:  # the plain version: torch.topk per segment, on the group mode's own scalars
        z = rt.ref.gmf_fusion_score(v, m, inv_norm_v=layout.expand(grouped[0]),
                                    inv_norm_m=layout.expand(grouped[1]), tau=tau)
        table = keep if keep.dim() == 2 else keep.expand(v.shape[0], -1)
        check(torch.equal(grouped[2], topk_per_segment(z, layout, table)),
              f"(a) group mode over {label}: thresholds differ from torch.topk's")
        p_thr, p_mask = rt.sparsify.segment_topk_mask_keep(v, layout, table)
        check(torch.equal(thr, p_thr) and torch.equal(mask, p_mask),
              f"(a) group mode's |z| mode over {label}: differs from its plain version")
    del grouped, single, mask, mask1
    out["max_abs_err"] = err
    if timing:
        fused = lambda g: gk.gmf_select_flat(v, m, plan=grp, group=g, **kw)  # noqa: E731
        absz = lambda g: gk.topk_abs_select_flat(  # noqa: E731
            v, offsets=offs, plan=grp, keep=keep, group=g)
        out |= {"ms": timed_ms(lambda: fused(group), reps=10, warmup=2),
                "single_ms": timed_ms(lambda: gk.gmf_select_flat(v, m, plan=one, **kw),
                                      reps=10, warmup=2),
                "abs_ms": timed_ms(lambda: absz(group), reps=10, warmup=2),
                "abs_single_ms": timed_ms(lambda: gk.topk_abs_select_flat(
                    v, offsets=offs, plan=one, keep=keep), reps=10, warmup=2),
                "device_ms": device_ms(lambda: fused(None)),
                "abs_device_ms": device_ms(lambda: absz(None)),
                "host_ms": host_ms(lambda: fused(None)),
                "group_host_ms": host_ms(lambda: fused(group)),
                "steps_ms": group_steps_ms(gk, "_select_group_op", lambda: fused(None)),
                "abs_steps_ms": group_steps_ms(gk, "_select_abs_group_op", lambda: absz(None))}
    print(f"  (a) group mode at a group of one over {label}: {grp.n_split} segments cut over "
          f"{grp.n_tiles} tiles; bitwise the single launch in both modes (thresholds, inverse "
          f"norms, |z| mask, keep counts)" + (" and its plain version" if plain else "")
          + f"; {GROUP_STEPS['fused']} / {GROUP_STEPS['abs']} launches and "
            f"{GROUP_ALL_REDUCES['fused']} / {GROUP_ALL_REDUCES['abs']} all-reduces a call"
          + (f"; ms group {out['ms']:.4f} (device {out['device_ms']:.4f}) vs single "
             f"{out['single_ms']:.4f}, |z| group {out['abs_ms']:.4f} (device "
             f"{out['abs_device_ms']:.4f}) vs single {out['abs_single_ms']:.4f}"
             if timing else "")
          + f"\n      fused: {paths_words(out['paths'])}\n      |z|: "
            f"{paths_words(out['abs_paths'])}"
          + (f"\n      device ms a step (step/pass), fused {json.dumps(out['steps_ms'])}, |z| "
             f"{json.dumps(out['abs_steps_ms'])}; host ms to issue a fused call "
             f"{out['host_ms']:.4f}, with the group's all-reduces {out['group_host_ms']:.4f}"
             if timing else ""), flush=True)
    torch.cuda.synchronize()
    return out


def full_read_inputs(rt, dev, rows=2):
    """Inputs built for the group mode's full reads in passes 1 and 2: a
    layout of 131,072 (8 times the sample: the sample reads every eighth
    element), 70,000 and 4,096 elements, float32 v = m ``[rows, N]``, and
    (label, v, must): every score tied (every tile overflows its slots);
    the capacity exceeded (5 % of the magnitudes in [2, 64), 30 % in [1,
    1.001), the rest in [0.01, 0.5), signs at random: the k-th largest's bin
    holds 30 % of each tile); the sample misled (normal draws, but 1e-3 at
    the first leaf's sampled places: its bracket misses). Returns the
    layout and the cases."""
    gk = rt.gk
    layout = rt.flat.FlatLayout.of_sizes([8 * gk.GROUP_SAMPLE, 70_000, 4096], dev)
    rng = np.random.default_rng(29)
    shape = (rows, layout.total)
    u = rng.random(shape)
    cap = np.where(u < 0.05, rng.uniform(2.0, 64.0, shape),
                   np.where(u < 0.35, rng.uniform(1.0, 1.001, shape),
                            rng.uniform(0.01, 0.5, shape))) * rng.choice([-1.0, 1.0], shape)
    misled = rng.normal(size=shape)
    misled[:, 0:8 * gk.GROUP_SAMPLE:8] = 1e-3
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    return layout, [("every score tied", torch.full(shape, 0.5, device=dev)),
                    ("the capacity exceeded", as_t(cap)), ("the sample misled", as_t(misled))]


def group_one_phase(rt, dev, bw, peak, resnet_params):
    """(a) in a one-rank world (NCCL for the card's tensors): the group mode
    over llama3.2-1b's bf16 row, a ResNet-56 round's float32 stacks (20
    clients), ``hold_select_tiles``' tie layouts and ``full_read_inputs``
    (each of which must read some tile in full in both modes). Returns the
    llama row's times with its bound and plain version's time."""
    from repro_torch.models import transformer

    gk, flat = rt.gk, rt.flat
    TP_DIR.mkdir(parents=True, exist_ok=True)
    store = TP_DIR / "store_one"
    store.unlink(missing_ok=True)
    torch.distributed.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                                         rank=0, world_size=1)
    try:
        group = torch.distributed.group.WORLD
        cfg = rt.configs.get_config(LLAMA)
        sizes = [x.numel() for x in rt.utils.tree_leaves(transformer.abstract_params(cfg))]
        layout = flat.FlatLayout.of_sizes(sizes, dev)
        n = layout.total
        gen = torch.Generator(device=dev).manual_seed(23)
        v, m = (torch.randn(n, generator=gen, device=dev).mul_(16).round_().div_(16)
                .to(BF16).reshape(1, n) for _ in range(2))
        w, tau = torch.ones(1, device=dev), torch.full((1,), 0.3, device=dev)
        times = hold_group_one(rt, f"llama3.2-1b's bf16 row [1, {n}]", layout, v, m,
                               layout.keep(RATE)[1], w, tau, group, dev, timing=True,
                               plain=False)
        times["plain_ms"] = timed_ms(lambda: rt.ref.gmf_select(v, m, layout, RATE, w=w, tau=tau,
                                                                eps=EPS), reps=1, warmup=0)
        bound_bytes, bound_ops = 4 * n / bw * 1e3, 19 * n / peak * 1e3
        times.update(bound_ms=max(bound_bytes, bound_ops),
                     bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                     at=f"llama3.2-1b's row [1, {n}], every segment cut (a group of one)")
        del v, m
        torch.cuda.empty_cache()
        rlayout = flat.FlatLayout.of(resnet_params)
        rng = np.random.default_rng(31)
        _, v, m = kernel_inputs(rng, 20, rlayout.total, dev)
        w = torch.ones(20, device=dev)
        tau = torch.linspace(0.0, 1.0, 20, device=dev)
        times["resnet56"] = hold_group_one(rt, "a ResNet-56 round's f32 stacks [20, "
                                               f"{rlayout.total}]", rlayout, v, m,
                                           rlayout.keep(RATE)[1], w, tau, group, dev,
                                           timing=True)
        errs = [times["max_abs_err"], times["resnet56"]["max_abs_err"]]
        for label, tl, _ in tile_layouts(rt, dev):
            v, m, keep = tied_across_borders(rt, tl, 4, dev)
            w = torch.tensor([1.0, 0.5, 2.0, 1.0], device=dev)
            tau = torch.tensor([0.0, 0.3, 1.0, 0.6], device=dev)
            errs.append(hold_group_one(rt, label, tl, v, m, keep, w, tau, group, dev)[
                "max_abs_err"])
        flayout, cases = full_read_inputs(rt, dev)
        w, tau = torch.ones(2, device=dev), torch.tensor([0.3, 0.6], device=dev)
        times["full_read_inputs"] = {}
        for label, x in cases:
            rec = hold_group_one(rt, f"{label} ({list(flayout.sizes)})", flayout, x, x,
                                 flayout.keep(RATE)[1], w, tau, group, dev)
            errs.append(rec["max_abs_err"])
            for mode in ("paths", "abs_paths"):
                check(rec[mode]["full_tiles"] > 0,
                      f"(a) {label}: the group mode's {mode} read no tile in full")
            times["full_read_inputs"][label] = {k: rec[k] for k in ("paths", "abs_paths")}
        times["max_abs_err"] = max(errs)
    finally:
        torch.distributed.destroy_process_group()
        store.unlink(missing_ok=True)
    return times


def tp_probe(dev):
    """Whether gloo takes the card's tensors across the two processes: an
    all_reduce (sum, and max) of each dtype the port sums, and an
    all_gather. Returns {what: "ok" or the error}."""
    import torch.distributed as dist

    out = {}
    r = dist.get_rank()
    for dtype in (torch.float32, BF16, torch.int32, torch.int64, torch.float64):
        for op in ("SUM", "MAX"):
            try:
                x = torch.full((3,), r + 1, dtype=dtype, device=dev)
                dist.all_reduce(x, op=getattr(dist.ReduceOp, op))
                want = 3 if op == "SUM" else 2
                out[f"all_reduce {op} {dtype}"] = ("ok" if x.tolist() == [want] * 3
                                                   else f"wrong: {x.tolist()}")
            except Exception as e:  # noqa: BLE001 - recorded and reported, not swallowed
                out[f"all_reduce {op} {dtype}"] = f"{type(e).__name__}: {e}"[:200]
    for dtype in (torch.float32, BF16):  # FSDP gathers bf16 params (phase 19)
        try:
            parts = [torch.empty(2, dtype=dtype, device=dev) for _ in range(2)]
            dist.all_gather(parts, torch.full((2,), float(r), dtype=dtype, device=dev))
            out[f"all_gather {dtype}"] = ("ok" if [p.tolist() for p in parts] ==
                                          [[0.0] * 2, [1.0] * 2] else "wrong")
        except Exception as e:  # noqa: BLE001 - recorded and reported, not swallowed
            out[f"all_gather {dtype}"] = f"{type(e).__name__}: {e}"[:200]
    return out


def tp_group_select(rt, group, dev, leaves=None):
    """(b) ``gmf_select``'s group mode over the real two-rank ``group``, each
    rank its pieces of ``leaves``' (TP_SELECT's by default; a leaf marked
    ``"shared"`` is held alike by both ranks, cut as a whole of twice its
    size whose piece only rank 0 owns, as FSDP's pod group holds a leaf cut
    over one of its axes alone), TP_SELECT_ROWS rows (the cut
    segments' scratch indexed split-major), in float32 and bf16: against
    the plain group select (``fusion.segment_norms`` summed over the group,
    the cut segments' scores all-gathered before ``torch.topk``) and the
    single launch over the whole leaves, each rank comparing its pieces.
    The fused mode on integers in [-6, 6] (every sum of squares exact in
    float32 and float64, so the inverse norms are bitwise too), the |z|
    mode on normal draws rounded to 1/16. Returns the record: the largest
    absolute difference, whether each comparison is bitwise, the keep counts
    and the masks' counts over the group."""
    import torch.distributed as dist

    gk, flat = rt.gk, rt.flat
    leaves = TP_SELECT if leaves is None else leaves
    r, n = dist.get_rank(group), dist.get_world_size(group)
    gen = torch.Generator(device=dev).manual_seed(41)
    rows = TP_SELECT_ROWS
    shared = {k for k, (_, d) in leaves.items() if d == "shared"}

    def draw(ints):
        out = {}
        for k, (shape, _) in sorted(leaves.items()):
            if ints:
                out[k] = torch.randint(-6, 7, (rows, *shape), generator=gen, device=dev).float()
            else:
                out[k] = torch.randn((rows, *shape), generator=gen, device=dev).mul_(16).round_() \
                    .div_(16)
        return out

    def piece(tree):
        return {k: x if leaves[k][1] in (None, "shared") else
                x.chunk(n, dim=leaves[k][1] + 1)[r].contiguous() for k, x in tree.items()}

    w = torch.tensor([1.0, 0.5, 2.0], device=dev)
    tau = torch.tensor([0.0, 0.3, 1.0], device=dev)
    rec = {"equal": {}, "max_abs_err": 0.0}

    def held(what, a, b):
        rec["max_abs_err"] = max(rec["max_abs_err"], max_abs(a, b))
        rec["equal"][what] = bool(a.shape == b.shape and torch.equal(a, b))

    for dtype in (torch.float32, BF16):
        tag = "bf16" if dtype == BF16 else "f32"
        v, m, z = ({k: x.to(dtype) for k, x in draw(ints).items()} for ints in (1, 1, 0))
        whole = flat.FlatLayout.of({k: x[0] for k, x in v.items()})
        small = flat.FlatLayout.of({k: x[0] for k, x in piece(v).items()})
        names = sorted(leaves)
        lay = small.over(group, [s * (n if k in shared else 1) for k, s in
                                 zip(names, whole.sizes, strict=True)],
                         [([k not in shared or q == 0 for k in names], None) for q in range(n)])
        plan = lay.select_plan(group=True)
        rec[f"{tag}/plan"] = [plan.n_group, plan.n_split, plan.n_tiles]
        rec[f"{tag}/cut"] = list(lay.cut_flags)
        rec[f"{tag}/owners"] = list(lay.owner_flags)
        keep = lay.keep(RATE)[1]
        if not shared:
            held(f"{tag} keep counts (from the whole sizes)", keep, whole.keep(RATE)[1])
        vc, mc, zc = (small.flatten(piece(x)) for x in (v, m, z))
        vw, mw, zw = (whole.flatten(x) for x in (v, m, z))
        got = gk.gmf_select_flat(vc, mc, offsets=lay.offsets_dev, plan=plan, keep=keep, w=w,
                                 tau=tau, eps=EPS, group=group)
        plain = rt.ref.gmf_select(vc, mc, lay, RATE, w=w, tau=tau, eps=EPS)
        single = gk.gmf_select_flat(vw, mw, offsets=whole.offsets_dev, plan=whole.select_plan(),
                                    keep=keep, w=w, tau=tau, eps=EPS)
        for name, a, b, c in zip(("inv_nv", "inv_nm", "thr"), got, plain, single, strict=True):
            held(f"{tag} {name} vs the plain group select", a, b)
            held(f"{tag} {name} vs the single launch over the whole leaves", a, c)
        # the K1 mask pass on the rank's rows with the group's scalars, its
        # count over the group against the whole leaves'
        zero = torch.zeros_like(vc)
        mask = gk.gmf_compress_flat(zero, vc, mc, offsets=lay.offsets_dev, inv_norm_v=got[0],
                                    inv_norm_m=got[1], tau=tau, threshold=got[2])[3]
        mask_w = gk.gmf_compress_flat(torch.zeros_like(vw), vw, mw, offsets=whole.offsets_dev,
                                      inv_norm_v=single[0], inv_norm_m=single[1], tau=tau,
                                      threshold=single[2])[3]
        held(f"{tag} mask vs the whole leaves'", mask,
             small.flatten(piece(whole.unflatten(mask_w))))
        rec[f"{tag}/nnz"] = [lay.nnz(mask).tolist(), whole.nnz(mask_w).tolist()]
        held(f"{tag} nnz over the group", lay.nnz(mask), whole.nnz(mask_w))
        thr, amask = gk.topk_abs_select_flat(zc, offsets=lay.offsets_dev, plan=plan, keep=keep,
                                             group=group)
        p_thr, p_mask = rt.sparsify.segment_topk_mask(zc, lay, RATE)
        s_thr, s_mask = gk.topk_abs_select_flat(zw, offsets=whole.offsets_dev,
                                                plan=whole.select_plan(), keep=keep)
        held(f"{tag} |z| thr vs the plain group select", thr, p_thr)
        held(f"{tag} |z| mask vs the plain group select", amask, p_mask)
        held(f"{tag} |z| thr vs the single launch over the whole leaves", thr, s_thr)
        held(f"{tag} |z| mask vs the whole leaves'", amask,
             small.flatten(piece(whole.unflatten(s_mask))))
        held(f"{tag} |z| nnz over the group", lay.nnz(amask), whole.nnz(s_mask))
    torch.cuda.synchronize()
    return rec


def tp_train_worker(rt, rank, mesh, sh_of, dev):
    """(b) on this rank: gmf_data then dense, TP_TRAIN's steps each over the
    (1, 2) mesh, then the same without a mesh in this process, one rank
    after the other (two mesh-less runs at once would not fit beside the
    main process on the card); each rank compares its pieces. Returns the
    records."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
    from repro_torch.dist import sharding as shr
    from repro_torch.models import transformer

    gk, k4 = rt.gk, rt.k4
    cfg = dataclasses.replace(rt.configs.get_config(LLAMA), num_layers=TP_TRAIN["layers"])
    out = {}
    for sync in ("gmf_data", "dense"):
        tcfg = TrainConfig(learning_rate=3e-3, total_steps=TP_TRAIN["steps"], grad_sync=sync,
                           lr_schedule="cosine", warmup_steps=1)
        ccfg = rt.core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3, use_kernels=True)
        runs = {}
        for tag, m in (("tp", mesh), ("one", None)):
            if m is None and rank == 1:  # rank 0's mesh-less run first
                torch.distributed.barrier()
            params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            sh = sh_of(params)
            if m is not None:
                params = shr.local_tree(params, sh)
            state = rt.dstep.init_train_state(cfg, tcfg, ccfg, params, m)
            init = [x.clone() for x in rt.utils.tree_leaves(
                params if m is not None else shr.local_tree(params, sh))]
            del params
            step = rt.dstep.make_train_step(cfg, tcfg, ccfg, m)
            stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=TP_TRAIN["seq_len"],
                                       batch_size=TP_TRAIN["batch"], seed=0)
            gk.reset_launches()
            k4.reset_launches()
            recs, ms = [], []
            for _, b in zip(range(TP_TRAIN["steps"]), stream, strict=False):
                batch = to_tensors(b, dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, batch)
                loss = float(met["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
                recs.append({"loss": loss, "upload_nnz": met["upload_nnz"].tolist()})
            torch.cuda.synchronize()
            final = state.params if m is not None else shr.local_tree(state.params, sh)
            delta = [x.float() - y.float() for x, y in zip(rt.utils.tree_leaves(final), init,
                                                          strict=True)]
            del init
            runs[tag] = dict(recs=recs, ms=ms, params=final, delta=delta,
                             total=int(met["total_params"]),
                             inst={f"{k[0]}[{k[1]}]": n for k, n in gk.INSTANCES.items()},
                             sums=dict(gk.GROUP_SUMS), k4=dict(k4.LAUNCHES))
            del state, step
            torch.cuda.empty_cache()
            if m is None and rank == 0:
                torch.distributed.barrier()
        errs = [float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
                for a, b in zip(rt.utils.tree_leaves(runs["tp"]["params"]),
                                rt.utils.tree_leaves(runs["one"]["params"]), strict=True)]
        # the change of the params: each leaf's, and all leaves' together
        d_tp, d_one = runs["tp"]["delta"], runs["one"]["delta"]
        delta_errs = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                      for a, b in zip(d_tp, d_one, strict=True)]
        delta_all = math.sqrt(sum(float((a - b).norm()) ** 2 for a, b in zip(d_tp, d_one,
                                                                             strict=True))
                              / max(sum(float(b.norm()) ** 2 for b in d_one), 1e-60))
        cut = [a.numel() != b.numel() for a, b in zip(
            rt.utils.tree_leaves(runs["tp"]["params"]),
            rt.utils.tree_leaves(transformer.abstract_params(cfg)), strict=True)]
        out[sync] = {tag: {k: v for k, v in run.items() if k not in ("params", "delta")}
                     for tag, run in runs.items()}
        out[sync].update(param_rel_l2=max(errs), delta_rel_l2=delta_all,
                         delta_rel_l2_leaves=delta_errs, cut_leaves=sum(cut), leaves=len(cut),
                         exact_k=sum(rt.sparsify.num_keep(n, RATE)
                                     for n in rt.dstep.full_sizes(cfg)),
                         local_params=sum(x.numel() for x in rt.utils.tree_leaves(
                             runs["tp"]["params"])))
        del runs
        torch.cuda.empty_cache()
    return out


def tp_serve_worker(rt, rank, mesh, sh_of, dev):
    """(c) on this rank: ``run_fixed`` over the (1, 2) mesh and without one,
    float32, TP_SERVE's shape; K4's launches in the mesh run's prefill."""
    from repro_torch.dist import sharding as shr

    k4 = rt.k4
    cfg = dataclasses.replace(rt.configs.get_config(LLAMA), num_layers=TP_SERVE["layers"],
                              dtype="float32", param_dtype="float32")
    args = rt.serve.parser().parse_args([
        "--arch", LLAMA, "--batch", str(TP_SERVE["batch"]), "--prompt-len",
        str(TP_SERVE["prompt_len"]), "--gen", str(TP_SERVE["gen"])])
    whole = rt.serve.init_params(cfg, args.seed, dev)
    local = shr.local_tree(whole, sh_of(whole))
    k4.reset_launches()
    tp = rt.serve.run_fixed(cfg, local, args, dev, mesh=mesh)
    torch.cuda.synchronize()
    launches = dict(k4.LAUNCHES)
    one = rt.serve.run_fixed(cfg, whole, args, dev)
    a, b = tp.last_logits.double(), one.last_logits.double()
    return dict(rel_l2=float((a - b).norm() / b.norm()), tokens_equal=torch.equal(tp.tokens,
                                                                                   one.tokens),
                tokens=tp.tokens[:, :8].tolist(), k4=launches, summary=tp.summary,
                summary_one=one.summary)


def tp_worker(rank: int, init: str, dest: str) -> None:
    """One of phase 18's two processes on the one card: a gloo world of two
    over ``init`` (the card's tensors cross it), the mesh (data 1, model 2),
    the probe, then (b) (the group select over the two ranks, then the
    training runs) and (c) where gloo takes the card's tensors; the
    records to ``dest`` (JSON)."""
    sys.path.insert(0, str(SRC))
    import datetime

    import repro_torch.configs as configs
    import repro_torch.core as core
    import repro_torch.utils as utils
    from repro_torch.core import sparsify
    from repro_torch.dist import sharding as shr
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import flat

    rt = argparse.Namespace(core=core, utils=utils, gk=gk, k4=k4, configs=configs, dstep=dstep,
                            serve=serve, sparsify=sparsify, ref=ref, flat=flat)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                                         timeout=datetime.timedelta(seconds=600))
    out = {"rank": rank}
    try:
        out["probe"] = tp_probe(dev)
        if all(v == "ok" for k, v in out["probe"].items() if k.startswith("all_reduce")):
            mesh = make_mesh((1, 2), ("data", "model"))

            def sh_of(params):
                return shr.named_shardings(mesh, shr.param_specs(params, fsdp=False, mesh=mesh))

            out["select"] = tp_group_select(rt, mesh.get_group("model"), dev)
            t0 = time.perf_counter()
            out["train"] = tp_train_worker(rt, rank, mesh, sh_of, dev)
            out["train_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["serve"] = tp_serve_worker(rt, rank, mesh, sh_of, dev)
            out["serve_s"] = time.perf_counter() - t0
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    Path(dest).write_text(json.dumps(out))


def tp_pair_start():
    """(b) and (c)'s two processes on the one card (``chip_smoke.py
    --tp-worker``), started together -> (processes, their records' paths,
    the store)."""
    TP_DIR.mkdir(parents=True, exist_ok=True)
    store = TP_DIR / "store_two"
    store.unlink(missing_ok=True)
    dests = [TP_DIR / f"rank{r}.json" for r in range(2)]
    for d in dests:
        d.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--tp-worker", str(r),
                               "--tp-init", f"file://{store}", "--tp-out", str(dests[r])],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    return procs, dests, store


def tp_pair_stop(pair) -> None:
    """Kill what is left of the pair and remove its store."""
    procs, _, store = pair
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    store.unlink(missing_ok=True)


def tp_pair_phase(rt, card, pair=None):
    """(b) and (c): the two processes (``tp_pair_start``; started here unless
    ``pair`` was started before), waited for with a time limit and killed
    past it. Checks their records; returns (rank 0's records, the two
    ranks' compression launches by instance in (b)'s gmf_data run)."""
    pair = tp_pair_start() if pair is None else pair
    procs, dests, _ = pair
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        tp_pair_stop(pair)
    check(all(p.returncode == 0 for p in procs),
          "phase 18 workers failed:\n" + "\n".join(f"--- rank {r} (rc {p.returncode}):\n"
                                                   f"{log[-3000:]}" for r, (p, log) in
                                                   enumerate(zip(procs, logs, strict=True))))
    res = [json.loads(d.read_text()) for d in dests]
    print(f"  gloo on the card's tensors, two processes: {json.dumps(res[0]['probe'])}",
          flush=True)
    if "train" not in res[0]:
        print("  (b) and (c) left out: gloo refuses an all_reduce of the card's tensors (above); "
              "a model axis over 1 has run only on gloo CPU ranks", flush=True)
        return res[0], {}
    steps = TP_TRAIN["steps"]
    # the readings first, so that a failing run shows them all
    for r, rec in enumerate(res):
        sel = rec["select"]
        print(f"  (b) gmf_select's group mode over the two ranks, rank {r}: plan (cut, split, "
              f"tiles) f32 {sel['f32/plan']} bf16 {sel['bf16/plan']}, {TP_SELECT_ROWS} rows; "
              f"counts over the group (group, whole leaves) {sel['f32/nnz']}; largest difference "
              f"{sel['max_abs_err']:.3e}; not bitwise: "
              f"{[k for k, ok in sel['equal'].items() if not ok] or 'none'}", flush=True)
    layout_k = res[0]["train"]["gmf_data"]
    print(f"  (b) llama3.2-1b, {TP_TRAIN['layers']} of 16 layers, bf16, batch "
          f"{TP_TRAIN['batch']} x {TP_TRAIN['seq_len']}, mesh (1, 2) over gloo, two processes on "
          f"one card ({card}): {layout_k['cut_leaves']} of {layout_k['leaves']} leaves cut, "
          f"{layout_k['local_params']} params a rank", flush=True)
    for sync in ("gmf_data", "dense"):
        for r, rec in enumerate(res):
            tr = rec["train"][sync]
            t, o = tr["tp"], tr["one"]
            print(f"    {sync} rank {r}: losses {[x['loss'] for x in t['recs']]} (no mesh "
                  f"{[x['loss'] for x in o['recs']]}), params within "
                  f"{tr['param_rel_l2']:.3e} relative L2, their change within "
                  f"{tr['delta_rel_l2']:.3e} (worst leaf {max(tr['delta_rel_l2_leaves']):.3e}); "
                  f"upload nnz {[x['upload_nnz'] for x in t['recs']]} (no mesh "
                  f"{[x['upload_nnz'] for x in o['recs']]}; exact-k sum {tr.get('exact_k')}); "
                  f"ms/step {[round(x, 3) for x in t['ms']]}"
                  f" (no mesh {[round(x, 3) for x in o['ms']]}; reported only: two processes share "
                  f"the card); launches {json.dumps(t['inst'])}, group all-reduces "
                  f"{json.dumps(t['sums'])}, K4 {t['k4']['flash_attention']}", flush=True)
    for r, rec in enumerate(res):
        sv = rec["serve"]
        print(f"  (c) run_fixed at (1, 2), llama3.2-1b {TP_SERVE['layers']} layers float32, batch "
              f"{TP_SERVE['batch']}, prompt {TP_SERVE['prompt_len']}, {TP_SERVE['gen']} tokens, "
              f"rank {r}: logits within {sv['rel_l2']:.3e} relative L2 of the one-rank run, "
              f"tokens equal {sv['tokens_equal']}; K4 {json.dumps(sv['k4'])} (16 q and 4 kv heads "
              f"a rank); prefill_ms {sv['summary']['prefill_ms']} vs "
              f"{sv['summary_one']['prefill_ms']}, ms_per_step {sv['summary']['ms_per_step']} vs "
              f"{sv['summary_one']['ms_per_step']} (reported only)", flush=True)
    inst_sum = {}
    for r, rec in enumerate(res):
        sel = rec["select"]
        bad = [k for k, ok in sel["equal"].items() if not ok]
        check(not bad, f"(b) group select over the two ranks, rank {r}: not bitwise in {bad}")
        check(sel["f32/cut"] == [TP_SELECT[k][1] is not None for k in sorted(TP_SELECT)],
              f"(b) group select: cut flags {sel['f32/cut']}")
        tr = rec["train"]
        for sync in ("gmf_data", "dense"):
            t, o = tr[sync]["tp"], tr[sync]["one"]
            for a, b in zip(t["recs"], o["recs"], strict=True):
                check(abs(a["loss"] - b["loss"]) <= TP_TRAIN_TOL * abs(b["loss"]),
                      f"(b) {sync} rank {r}: loss {a['loss']} vs {b['loss']} without a mesh")
                if sync == "gmf_data":
                    flips = max(abs(x - y) for x, y in zip(a["upload_nnz"], b["upload_nnz"],
                                                           strict=True))
                    check(flips <= TP_NNZ_FLIPS,
                          f"(b) gmf_data rank {r}: upload nnz {a['upload_nnz']} vs "
                          f"{b['upload_nnz']} without a mesh ({flips} > {TP_NNZ_FLIPS})")
            check(tr[sync]["param_rel_l2"] <= TP_TRAIN_TOL,
                  f"(b) {sync} rank {r}: params {tr[sync]['param_rel_l2']:.3e} relative L2 from "
                  f"the mesh-less run's")
            check(tr[sync]["delta_rel_l2"] <= TP_DELTA_TOL,
                  f"(b) {sync} rank {r}: the params' change {tr[sync]['delta_rel_l2']:.3e} "
                  f"relative L2 from the mesh-less run's")
            check(t["total"] == o["total"], f"(b) {sync}: total_params {t['total']} vs "
                                            f"{o['total']}")
            check(tr[sync]["cut_leaves"] > 0, f"(b) {sync} rank {r}: no leaf cut")
            check(sum(t["k4"].values()) == 0, f"(b) {sync}: K4 in training {t['k4']}")
        g = tr["gmf_data"]["tp"]
        for x in g["recs"]:
            check(min(x["upload_nnz"]) >= tr["gmf_data"]["exact_k"],
                  f"(b) gmf_data rank {r}: upload nnz {x['upload_nnz']} < the exact-k sum "
                  f"{tr['gmf_data']['exact_k']}")
        want = {"gmf_select[group:bf16,bf16]": steps, "gmf_compress[bf16,bf16]": steps,
                "momentum_correction[bf16,bf16->bf16]": steps}
        check(g["inst"] == want, f"(b) gmf_data rank {r}: launches {g['inst']}, expected {want}")
        check(g["sums"] == {"group:bf16,bf16": 4 * steps},
              f"(b) gmf_data rank {r}: the group's all-reduces {g['sums']}")
        check(tr["gmf_data"]["one"]["inst"].get("gmf_select[bf16,bf16]") == steps,
              f"(b) the mesh-less run's launches {tr['gmf_data']['one']['inst']}")
        check(not tr["dense"]["tp"]["inst"], f"(b) dense launched {tr['dense']['tp']['inst']}")
        for k, n in g["inst"].items():
            inst_sum[k] = inst_sum.get(k, 0) + n
        sv = rec["serve"]
        check(sv["rel_l2"] <= TP_SERVE_TOL and sv["tokens_equal"],
              f"(c) rank {r}: logits {sv['rel_l2']:.3e} relative L2 from the one-rank run's, "
              f"tokens equal {sv['tokens_equal']}")
        check(sv["k4"]["flash_attention_cc"] == TP_SERVE["layers"],
              f"(c) rank {r}: K4 launches {sv['k4']}")
    print(f"  (b)/(c) workers: train {res[0]['train_s']:.1f} s, serve {res[0]['serve_s']:.1f} s",
          flush=True)
    rec = dict(res[0], select_max_abs_err=max(x["select"]["max_abs_err"] for x in res))
    return rec, inst_sum


def model_axis_phase(rt, dev, card, bw, peak, resnet_params, pair=None):
    """Phase 18: (a) in a one-rank NCCL world, then (b) and (c) in two
    processes (``pair``, where they started before: in the whole script
    they run beside phase 17 and (a)). Returns ((a)'s times, rank 0's
    records, (b)'s launches by instance over both ranks)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    times = group_one_phase(rt, dev, bw, peak, resnet_params)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"  this process holds {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB; "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card", flush=True)
    rec, inst = tp_pair_phase(rt, card, pair)
    return times, rec, inst


# ---------------------------------------------------------------------------
# phase 19: FSDP over data, the expert-parallel MoE at model 2, the engine at
# model 2 (ROADMAP item 11 part C2a)
# ---------------------------------------------------------------------------

FSDP_DIR = ROOT / "build" / "fsdp"  # phase 19's stores and the workers' records (ignored by git)
QWEN, KIMI = "qwen2-vl-72b", "kimi-k2-1t-a32b"
# the depth-cut configs FSDP runs on, at full width (FSDP forced: they fall
# under dist.step's 40e9 threshold, so this script sets it to 0 in its own
# processes). qwen2-vl-72b at 1 of 80 layers (3.4 B params, most of them
# the embedding and the unembedding, 6.8 GB in bf16) under dense;
# llama3.2-1b at 2 of 16 layers (phase 20's depth) under the gmf modes: a
# gmf step holds ~13 param-sized arrays (params, the gradient row, U, V, M
# old and new, gbar, the payload and mask), ~110 GB at qwen2-vl's 2 layers
# on one rank (PERF.md). Phase 19 ran qwen2-vl at 2 and llama at 8 layers
# until the whole script had to fit half its time limit (PERF.md)
FSDP_LAYERS = {QWEN: 1, LLAMA: 2}
# (b)'s steps, two at least so that a loss after an update is compared:
# over gloo a qwen2-vl step took 17-23 s at 2 layers (~17 GB through host
# memory), a llama one ~4 s at 8 layers (PERF.md)
PAIR_STEPS = {QWEN: 2, LLAMA: 2}
FSDP_TOL = 1e-2  # phase 14's bf16 tolerance: losses, and the params (relative L2)
# (b) and (c)'s params' change (final minus initial) against the mesh-less
# run's, relative L2, at the worst leaf that the mesh-less run changed: the
# params alone move by about a bf16 unit in the last place a step and
# cannot tell a wrong gradient from a sound one. On an H100 a sound run
# read at most 0.172 under FSDP (llama gmf_pod; qwen2-vl dense 0.079) and
# 0.530 under EP (granite: moe_ep drops assignments that the mesh-less
# run's dense dispatch keeps, another function); with the gathers'
# reduce-scatter replaced by the rank's own slice at least 0.868, with the
# update skipped 1.0 (PERF.md)
FSDP_DELTA_TOL, EP_DELTA_TOL = 0.5, 0.8
# (b)'s gmf_pod against the mesh-less run, a step: the upload counts may
# differ by FSDP_NNZ_FLIPS entries (bf16 gradient pieces summed over the
# data ranks in another order move tied scores across a threshold). Set
# between a sound run and one with the once-counting dropped (PERF.md)
FSDP_NNZ_FLIPS = 500_000
# (b)'s group select over the data group: TP_SELECT's leaves and "s", held
# alike by both ranks (a piece only rank 0 owns)
FSDP_SELECT = {**TP_SELECT, "s": ((256, 512), "shared")}
EP_STEPS = 2  # (c) granite-moe at its published widths, dense sync
EP_LAYERS = 12  # (c) granite-moe's depth, 12 of 24 layers (phases 13 and 17 serve it so)
KIMI_SERVE = dict(layers=1, batch=1, prompt_len=256, gen=8)  # (c), phase 13's kimi shape
EP_SERVE_TOL = 1e-2  # bf16 logits, relative L2, where nothing drops
# (c)'s second kimi run: a capacity at which no assignment drops (E / k: an
# expert's buffer holds every token a rank sends), so that moe_ep computes
# dense dispatch's function; at the published capacity it drops ~9 % and
# is another function (ROADMAP S12)
KIMI_NO_DROP = 384 / 8
ENGINE_MESH_WIRES = ("float32", "int8")  # (d), llama3.2-1b in float32 (as phase 18 (c))
# (d)'s tokens a request (phase 16 generates ENGINE["gen"]): over gloo a
# decode tick at (1, 2) takes ~0.4 s, a tick a token
ENGINE_MESH_GEN = 8


def fsdp_witnesses(rt, dev, card):
    """The one-rank runs (c) and (d) are held against, in this process before
    the pair starts (never beside it): kimi-k2 at KIMI_SERVE through
    ``run_fixed`` without a mesh (dense dispatch: the reference's function,
    nothing dropped), and llama3.2-1b's engine (phase 16's slots, pages and
    eight requests) with each of ENGINE_MESH_WIRES. Returns the records;
    kimi's logits go to FSDP_DIR."""
    import gc

    out = {}
    cfg = dataclasses.replace(rt.configs.get_config(KIMI), num_layers=KIMI_SERVE["layers"])
    args = kimi_args(rt)
    params = rt.serve.init_params(cfg, args.seed, dev)
    run = rt.serve.run_fixed(cfg, params, args, dev)
    torch.cuda.synchronize()
    torch.save(run.last_logits.cpu(), FSDP_DIR / "kimi_one.pt")
    out["kimi"] = dict(tokens=run.tokens.tolist(), summary=run.summary)
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    cfg = engine_f32(rt)
    params = rt.serve.init_params(cfg, 0, dev)
    prompts = engine_prompts(rt, cfg)
    for wire in ENGINE_MESH_WIRES:
        eng = rt.serving.ServeEngine(cfg, params, engine_config(rt, wire, ENGINE_MESH_GEN))
        for i, p in enumerate(prompts):
            eng.submit(p, arrival_tick=i * ENGINE["stagger"])
        comps, metrics = eng.run()
        out[f"engine/{wire}"] = dict(tokens=[c.tokens.tolist() for c in comps],
                                     tokens_per_s=metrics["tokens_per_s"])
        del eng
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  witnesses ({card}): {KIMI} one rank, dense dispatch, tokens "
          f"{out['kimi']['tokens']}; llama3.2-1b's engine one rank, tokens/s "
          f"{ {w: round(out[f'engine/{w}']['tokens_per_s'], 3) for w in ENGINE_MESH_WIRES} }",
          flush=True)
    return out


def engine_f32(rt):
    """(d)'s config: llama3.2-1b at full size in float32, where the model
    axis's sums in another order move logits by ~1e-6 (phase 18 (c)), not
    by bf16's ~1e-2 that flips greedy tokens."""
    return dataclasses.replace(rt.configs.get_config(LLAMA), dtype="float32",
                               param_dtype="float32")


def kimi_args(rt):
    return rt.serve.parser().parse_args([
        "--arch", KIMI, "--batch", str(KIMI_SERVE["batch"]), "--prompt-len",
        str(KIMI_SERVE["prompt_len"]), "--gen", str(KIMI_SERVE["gen"])])


def pieces_of(rt, whole, mesh, fsdp):
    """This rank's pieces of ``whole`` by the specs (FSDP's with ``fsdp``),
    copied so that the whole can be freed, and the specs."""
    from repro_torch.dist import sharding as shr

    specs = shr.param_specs(whole, fsdp=fsdp, mesh=mesh)
    return rt.utils.tree_map(lambda x, sp: piece_of(x, sp, mesh).clone(
        memory_format=torch.contiguous_format), whole, specs), specs


def piece_of(x, spec, mesh):
    """This rank's piece of the whole leaf ``x`` by ``spec``: a view, no
    copy and no collective (``sharding.local_tree`` builds DTensors,
    whose copies and functional collectives this script keeps off the card
    in two gloo processes)."""
    from repro_torch.launch.mesh import axis_size

    names = list(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate(), strict=True))
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None and axis_size(mesh, a) > 1:
                x = x.chunk(axis_size(mesh, a), dim=d)[coord[a]]
    return x


def one_at_a_time(rank, fn):
    """``fn()`` on rank 0, then on rank 1 (the other waits): two whole
    models at once would not fit beside each other on the card."""
    out = None
    for r in range(2):
        if r == rank:
            out = fn()
            torch.cuda.synchronize()
        torch.distributed.barrier()
    return out


def diff_norms(a, b, x0, dev, chunk=1 << 26):
    """||a − b||, ||b|| and ||b − x0|| of three host tensors of one shape,
    taken on ``dev`` in float32 a chunk of ``chunk`` elements at a time (the
    host's float32 arithmetic over a model's pieces took longer than the
    copies), summed in float64."""
    a, b, x0 = (t.reshape(-1) for t in (a, b, x0))
    sums = [0.0, 0.0, 0.0]
    for i in range(0, b.numel(), chunk):
        aa, bb, xx = (t[i:i + chunk].to(dev).float() for t in (a, b, x0))
        for j, t in enumerate((aa - bb, bb, bb - xx)):
            sums[j] += float(torch.linalg.vector_norm(t)) ** 2
    return tuple(math.sqrt(x) for x in sums)


def pair_train(rt, rank, cfg, sync, mesh, dev, twin, steps, fsdp):
    """A training run over ``mesh`` (each rank its pieces, FSDP's with
    ``fsdp``), then the mesh-less run of ``twin`` on the same params and
    batches (a rank at a time; the params go to the host in between), and
    each rank's comparison of its pieces with the mesh-less run's. Returns
    the record."""
    import gc

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
    from repro_torch.dist import sharding as shr
    from repro_torch.models import moe, transformer

    def run(m):
        tcfg = TrainConfig(learning_rate=3e-3, total_steps=steps + 1,
                           grad_sync=sync if m is not None else twin, lr_schedule="cosine",
                           warmup_steps=1)
        ccfg = rt.core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3, use_kernels=True)
        whole = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        specs = None
        if m is not None:
            params, specs = pieces_of(rt, whole, m, fsdp)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        else:
            params = whole
        if m is not None:  # this rank's pieces before the steps, for the params' change
            init = [x.to("cpu") for x in rt.utils.tree_leaves(params)]
        state = rt.dstep.init_train_state(cfg, tcfg, ccfg, params, m)
        del params
        step = rt.dstep.make_train_step(cfg, tcfg, ccfg, m)
        b_sh = (shr.named_shardings(m, rt.dstep.step_batch_specs(cfg, tcfg, m))
                if m is not None else None)
        stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                                   batch_size=TRAIN["batch"], seed=0,
                                   num_patches=cfg.num_patches, d_model=cfg.d_model)
        rt.gk.reset_launches()
        calls = []
        real = counting(moe, "moe_ep", calls, lambda out: 1)
        torch.cuda.reset_peak_memory_stats(dev)
        recs, ms = [], []
        try:
            for _, b in zip(range(steps), stream, strict=False):
                batch = to_tensors(b, dev)
                if b_sh is not None:
                    batch = shr.local_tree(batch, b_sh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, batch)
                rec = {"loss": float(met["loss"])}
                ms.append((time.perf_counter() - t0) * 1e3)
                if sync != "dense":
                    rec["upload_nnz"] = met["upload_nnz"].tolist()
                recs.append(rec)
        finally:
            moe.moe_ep = real
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        final = [x.to("cpu") for x in rt.utils.tree_leaves(state.params)]
        if m is not None:
            final = (final, init)
        inst = {f"{k[0]}[{k[1]}]": n for k, n in rt.gk.INSTANCES.items()}
        sums = dict(rt.gk.GROUP_SUMS)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        return dict(recs=recs, ms=ms, peak_gib=peak, inst=inst, sums=sums, moe_ep=len(calls),
                    total=int(met["total_params"])), final

    rt.gk.GROUP_SUMS.clear()
    meshed, (final, init) = run(mesh)
    torch.distributed.barrier()
    less, want = one_at_a_time(rank, lambda: run(None))  # the mesh-less run, a rank at a time
    specs = rt.utils.tree_leaves(shr.param_specs(transformer.abstract_params(cfg), fsdp=fsdp,
                                                 mesh=mesh))
    errs, moved, off = [], [], []
    for a, w, x0, sp in zip(final, want, init, specs, strict=True):
        diff, norm, change = diff_norms(a, piece_of(w, sp, mesh), x0, dev)
        errs.append(diff / max(norm, 1e-30))
        moved.append(change)  # the mesh-less run's change
        off.append(diff)
    del final, want, init
    gc.collect()
    # the params' change against the mesh-less run's: at the worst leaf the
    # mesh-less run changed, and over all leaves
    delta = [d / c for d, c in zip(off, moved, strict=True) if c > 0]
    return {"mesh": meshed, "less": less, "param_rel_l2": max(errs), "leaves": len(errs),
            "delta_rel_l2": max(delta), "delta_all": math.sqrt(sum(d * d for d in off))
            / max(math.sqrt(sum(c * c for c in moved)), 1e-30), "moved": len(delta),
            "exact_k": sum(rt.sparsify.num_keep(n, RATE) for n in rt.dstep.full_sizes(cfg)),
            "cut_data": sum(d is not None for d in rt.utils.tree_leaves(
                shr.fsdp_dims(transformer.abstract_params(cfg), mesh))) if fsdp else 0}


def pair_kimi(rt, rank, mesh, dev):
    """(c) kimi-k2 at KIMI_SERVE served over (1, 2) through ``run_fixed``: the
    rank's pieces (the whole drawn one rank at a time and cut), K4's
    launches, the dropped (token, expert) assignments of a prefill, tokens
    and logits (the logits to FSDP_DIR)."""
    import gc

    from repro_torch.models import moe

    cfg = dataclasses.replace(rt.configs.get_config(KIMI), num_layers=KIMI_SERVE["layers"])
    args = kimi_args(rt)

    def draw():  # the pieces through host memory: the whole and a copy would not fit
        from repro_torch.dist import sharding as shr

        whole = rt.serve.init_params(cfg, args.seed, dev)
        host = rt.utils.tree_map(lambda x, sp: piece_of(x, sp, mesh).to("cpu"), whole,
                                 shr.param_specs(whole, fsdp=False, mesh=mesh))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        return rt.utils.tree_map(lambda x: x.to(dev), host)

    params = one_at_a_time(rank, draw)
    torch.cuda.reset_peak_memory_stats(dev)
    rt.k4.reset_launches()
    calls = []
    real = counting(moe, "moe_ep", calls, lambda out: 1)
    try:
        run = rt.serve.run_fixed(cfg, params, args, dev, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        moe.moe_ep = real
    k4 = dict(rt.k4.LAUNCHES)
    dropped = []
    real = counting(moe, "dispatch_local", dropped,
                    lambda out: (out[3].numel(), int(out[3].numel() - out[3].sum())))
    try:
        prefill = rt.dstep.make_prefill_step(cfg, mesh, cache_len=args.prompt_len + args.gen)
        prefill(params, rt.serve.prompt_batch(cfg, args.seed, args.batch, args.prompt_len, dev))
        torch.cuda.synchronize()
    finally:
        moe.dispatch_local = real
    # again where nothing drops: dense dispatch's function (a prefill's
    # drops counted: its all-to-all body routes every assignment, so each
    # one not kept is a drop)
    whole = dataclasses.replace(cfg, capacity_factor=KIMI_NO_DROP)
    again = rt.serve.run_fixed(whole, params, args, dev, mesh=mesh)
    dropped_whole = []
    real = counting(moe, "dispatch_local", dropped_whole,
                    lambda out: int(out[3].numel() - out[3].sum()))
    try:
        rt.dstep.make_prefill_step(whole, mesh, cache_len=args.prompt_len + args.gen)(
            params, rt.serve.prompt_batch(cfg, args.seed, args.batch, args.prompt_len, dev))
        torch.cuda.synchronize()
    finally:
        moe.dispatch_local = real
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.save(run.last_logits.cpu(), FSDP_DIR / f"kimi_rank{rank}.pt")
    torch.save(again.last_logits.cpu(), FSDP_DIR / f"kimi_rank{rank}_no_drop.pt")
    out = dict(tokens=run.tokens.tolist(), summary=run.summary, k4=k4, moe_ep=len(calls),
               assignments=sum(n for n, _ in dropped), dropped=sum(d for _, d in dropped),
               no_drop_tokens=again.tokens.tolist(), no_drop_dropped=sum(dropped_whole),
               peak_gib=peak, local_params=sum(x.numel() for x in rt.utils.tree_leaves(params)))
    del params, run, again
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pair_engine(rt, mesh, dev):
    """(d) llama3.2-1b's engine over (1, 2): the rank's pieces of the params
    and of the pool, phase 16's slots, pages and eight requests, each of
    ENGINE_MESH_WIRES. Returns tokens, tokens/s and the pool's kv heads."""
    import gc

    cfg = engine_f32(rt)
    params, _ = pieces_of(rt, rt.serve.init_params(cfg, 0, dev), mesh, False)
    gc.collect()
    torch.cuda.empty_cache()
    prompts = engine_prompts(rt, cfg)
    out = {}
    for wire in ENGINE_MESH_WIRES:
        rt.k4.reset_launches()
        eng = rt.serving.ServeEngine(cfg, params, engine_config(rt, wire, ENGINE_MESH_GEN),
                                     mesh=mesh)
        for i, p in enumerate(prompts):
            eng.submit(p, arrival_tick=i * ENGINE["stagger"])
        comps, metrics = eng.run()
        torch.cuda.synchronize()
        out[wire] = dict(tokens=[c.tokens.tolist() for c in comps],
                         tokens_per_s=metrics["tokens_per_s"], k4=dict(rt.k4.LAUNCHES),
                         kv_heads=int(eng.pool["groups"][0]["k"].shape[-2]),
                         scale_heads=(int(eng.pool["groups"][0]["k_scale"].shape[-1])
                                      if "k_scale" in eng.pool["groups"][0] else None))
        del eng
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_group_pod(rt, mesh, dev):
    """(b) ``gmf_select``'s group mode over the pod's data group of the
    gmf_pod run (llama3.2-1b at FSDP_LAYERS, FSDP's pieces, bf16 rows of
    the rank's pieces, the fused mode at RATE), timed (CUDA events around
    the wrapper call, host and the two processes' gloo all-reduces in)
    beside the single launch over the same row taken whole on the rank,
    and its bytes bound (v and m read once)."""
    from repro_torch.dist import sharding as shr
    from repro_torch.models import transformer

    cfg = dataclasses.replace(rt.configs.get_config(LLAMA), num_layers=FSDP_LAYERS[LLAMA])
    whole = transformer.abstract_params(cfg)
    specs = shr.param_specs(whole, fsdp=True, mesh=mesh)
    pieces = rt.utils.tree_map(lambda x, sp: torch.empty(piece_of(x, sp, mesh).shape,
                                                          dtype=x.dtype, device=dev),
                               whole, specs)
    axes = ("data", "model")
    layout = rt.flat.FlatLayout.of(pieces).over(
        rt.dstep.mesh_group(mesh, axes), rt.dstep.full_sizes(cfg),
        shr.places(whole, specs, mesh, axes, owners=True))
    gen = torch.Generator(device=dev).manual_seed(7)
    v, m = (torch.randn((1, layout.total), generator=gen, device=dev).to(BF16) for _ in range(2))
    w, tau = torch.ones(1, device=dev), torch.full((1,), 0.3, device=dev)
    ms = timed_ms(lambda: rt.ops.gmf_select(v, m, layout, RATE, w=w, tau=tau, eps=EPS),
                  reps=5, warmup=2)
    one = rt.flat.FlatLayout.of(pieces)
    single = timed_ms(lambda: rt.ops.gmf_select(v, m, one, RATE, w=w, tau=tau, eps=EPS),
                      reps=5, warmup=2)
    bw = card_rates(torch.cuda.get_device_name(0))[0]
    return dict(ms=ms, single_ms=single, elements=layout.total,
                bound_ms=4 * layout.total / bw * 1e3, plan=[
                    layout.select_plan(group=True).n_group,
                    layout.select_plan(group=True).n_split,
                    layout.select_plan(group=True).n_tiles])


def fsdp_worker(rank: int, init: str, dest: str) -> None:
    """One of phase 19's two processes on the one card: a gloo world of two
    over ``init`` (the card's tensors cross it), then (b) the group select
    over the data group and the two FSDP runs (FSDP forced for them: the
    threshold at 0 in this process), (c) granite-moe's training and
    kimi-k2's serving at model 2, (d) the engine at model 2; the records to
    ``dest`` (JSON)."""
    sys.path.insert(0, str(SRC))
    import datetime
    import faulthandler

    import repro_torch.configs as configs
    import repro_torch.core as core
    import repro_torch.serve as serving
    import repro_torch.utils as utils
    from repro_torch.core import sparsify
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import flat

    rt = argparse.Namespace(core=core, utils=utils, gk=gk, k4=k4, configs=configs, dstep=dstep,
                            serve=serve, sparsify=sparsify, ref=ref, flat=flat, serving=serving,
                            ops=ops)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    faulthandler.enable()  # a crash prints where it happened
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                                         timeout=datetime.timedelta(seconds=900))
    out = {"rank": rank}

    def stage(name):
        print(f"rank {rank}: {name} at {time.perf_counter() - T_START:.1f} s", flush=True)

    try:
        out["probe"] = tp_probe(dev)
        m21 = make_mesh((2, 1), ("data", "model"))
        m121 = make_mesh((1, 2, 1), ("pod", "data", "model"))
        m12 = make_mesh((1, 2), ("data", "model"))
        t0 = time.perf_counter()
        stage("(b) the group select")
        out["select"] = tp_group_select(rt, m21.get_group("data"), dev, FSDP_SELECT)
        qwen = dataclasses.replace(configs.get_config(QWEN), num_layers=FSDP_LAYERS[QWEN])
        llama = dataclasses.replace(configs.get_config(LLAMA), num_layers=FSDP_LAYERS[LLAMA])
        dstep._FSDP_PARAM_THRESHOLD = 0  # FSDP forced: the depth-cut configs fall under 40e9
        try:
            stage("(b) qwen2-vl dense")
            out["dense"] = pair_train(rt, rank, qwen, "dense", m21, dev, "dense",
                                      PAIR_STEPS[QWEN], True)
            stage("(b) llama gmf_pod")
            out["gmf_pod"] = pair_train(rt, rank, llama, "gmf_pod", m121, dev, "gmf_data",
                                        PAIR_STEPS[LLAMA], True)
            stage("(b) the group mode over the pod's data group, timed")
            out["group_pod"] = time_group_pod(rt, m121, dev)
        finally:
            dstep._FSDP_PARAM_THRESHOLD = 40e9
        out["b_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stage("(c) granite-moe")
        granite = dataclasses.replace(configs.get_config(GRANITE), num_layers=EP_LAYERS)
        out["ep_train"] = pair_train(rt, rank, granite, "dense", m12, dev, "dense", EP_STEPS,
                                     False)
        stage("(c) kimi-k2")
        gc.collect()  # the whole layer is drawn on the card beside the other rank's pieces
        torch.cuda.empty_cache()
        out["kimi"] = pair_kimi(rt, rank, m12, dev)
        out["c_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stage("(d) the engine")
        out["engine"] = pair_engine(rt, m12, dev)
        out["d_s"] = time.perf_counter() - t0
        stage("done")
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    Path(dest).write_text(json.dumps(out))


def fsdp_pair_phase(rt, card, wit, beside=None):
    """(b)-(d): two processes on the one card (``chip_smoke.py
    --fsdp-worker``), started together, waited for with a time limit and
    killed past it, ``beside()`` running here meanwhile. Prints the
    readings, then checks them. Returns rank 0's records."""
    FSDP_DIR.mkdir(parents=True, exist_ok=True)
    store = FSDP_DIR / "store_two"
    store.unlink(missing_ok=True)
    dests = [FSDP_DIR / f"rank{r}.json" for r in range(2)]
    for d in dests:
        d.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--fsdp-worker",
                               str(r), "--tp-init", f"file://{store}", "--tp-out", str(dests[r])],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        if beside is not None:
            beside()
            gc.collect()  # what beside() leaves cached would crowd the workers' kimi-k2
            torch.cuda.empty_cache()
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.unlink(missing_ok=True)
    check(all(p.returncode == 0 for p in procs),
          "phase 19 workers failed:\n" + "\n".join(f"--- rank {r} (rc {p.returncode}):\n"
                                                   f"{log[-3000:]}" for r, (p, log) in
                                                   enumerate(zip(procs, logs, strict=True))))
    res = [json.loads(d.read_text()) for d in dests]
    print(f"  gloo on the card's tensors, two processes: {json.dumps(res[0]['probe'])}",
          flush=True)
    print("  the workers' stages (seconds since each process started): " + "; ".join(
        ln.split(": ", 1)[1] for ln in logs[0].splitlines()
        if ln.startswith("rank 0: ") and ln.endswith(" s")), flush=True)
    fsdp_pair_report(rt, card, wit, res)
    return res[0]


def fsdp_pair_report(rt, card, wit, res):
    """(b)-(d)'s readings, then their checks, from the two ranks' records."""
    for r, rec in enumerate(res):  # the readings first, so that a failing run shows them all
        sel = rec["select"]
        print(f"  (b) gmf_select's group mode over the data group, rank {r}: plan (cut, split, "
              f"tiles) f32 {sel['f32/plan']} bf16 {sel['bf16/plan']}, owners {sel['f32/owners']};"
              f" counts over the group (group, whole leaves) {sel['f32/nnz']}; largest "
              f"difference {sel['max_abs_err']:.3e}; not bitwise: "
              f"{[k for k, ok in sel['equal'].items() if not ok] or 'none'}", flush=True)
    for key, arch, mesh in (("dense", QWEN, "(2, 1)"), ("gmf_pod", LLAMA, "(1, 2, 1)"),
                            ("ep_train", GRANITE, "(1, 2)")):
        rec = res[0][key]
        t, o = rec["mesh"], rec["less"]
        print(f"  ({'c' if key == 'ep_train' else 'b'}) {arch} "
              f"({ {**FSDP_LAYERS, GRANITE: EP_LAYERS}[arch]} layers), {key} at {mesh}, two "
              f"processes over gloo"
              f" ({card}): {rec['cut_data']} of {rec['leaves']} leaves cut over data; losses "
              f"{[x['loss'] for x in t['recs']]} (no mesh {[x['loss'] for x in o['recs']]}), "
              f"params within {[round(x[key]['param_rel_l2'], 9) for x in res]} relative L2 "
              f"(worst leaf, each rank's pieces); the params' change within "
              f"{[round(x[key]['delta_rel_l2'], 6) for x in res]} of the mesh-less run's "
              f"(worst of the {[x[key]['moved'] for x in res]} leaves it changed; all leaves "
              f"{[round(x[key]['delta_all'], 6) for x in res]})"
              + (f"; upload nnz {[x['upload_nnz'] for x in t['recs']]} (no mesh "
                 f"{[x['upload_nnz'] for x in o['recs']]}; exact-k sum {rec['exact_k']})"
                 if key == "gmf_pod" else "")
              + f"; ms/step {[round(x, 3) for x in t['ms']]} (no mesh "
              f"{[round(x, 3) for x in o['ms']]}; reported only: gloo through host memory); "
              f"peak GiB a process {[round(x[key]['mesh']['peak_gib'], 3) for x in res]} (no mesh "
              f"{round(o['peak_gib'], 3)}); launches {json.dumps(t['inst'])}, group all-reduces "
              f"{json.dumps(t['sums'])}, moe_ep {t['moe_ep']}", flush=True)
    one = torch.load(FSDP_DIR / "kimi_one.pt").double()
    kimi_err, kimi_whole = [], []
    for r, rec in enumerate(res):
        k = rec["kimi"]
        for sink, tag in ((kimi_err, ""), (kimi_whole, "_no_drop")):
            got = torch.load(FSDP_DIR / f"kimi_rank{r}{tag}.pt").double()
            sink.append(float((got - one).norm() / one.norm()))
        print(f"  (c) {KIMI}, {KIMI_SERVE['layers']} of 61 layers, served at (1, 2), rank {r} "
              f"({card}): tokens {k['tokens']} (one rank, dense dispatch: "
              f"{wit['kimi']['tokens']}); logits within {kimi_err[-1]:.3e} relative L2 at the "
              f"published capacity, {kimi_whole[-1]:.3e} where nothing drops (capacity factor "
              f"{KIMI_NO_DROP}: {k['no_drop_dropped']} dropped, tokens {k['no_drop_tokens']}); K4 "
              f"{json.dumps(k['k4'])} (D 112, 32 q and 4 kv heads a rank); moe_ep {k['moe_ep']};"
              f" dropped {k['dropped']} of {k['assignments']} (token, expert) assignments in a "
              f"prefill; prefill_ms {k['summary']['prefill_ms']} vs "
              f"{wit['kimi']['summary']['prefill_ms']}, ms_per_step "
              f"{k['summary']['ms_per_step']} vs {wit['kimi']['summary']['ms_per_step']}; peak "
              f"{k['peak_gib']:.3f} GiB, {k['local_params']} params a rank", flush=True)
    for wire in ENGINE_MESH_WIRES:
        e = res[0]["engine"][wire]
        differ = sum(a != b for x, y in zip(e["tokens"], wit[f"engine/{wire}"]["tokens"],
                                            strict=True) for a, b in zip(x, y, strict=True))
        print(f"  (d) llama3.2-1b (float32)'s engine at (1, 2), {wire} codec ({card}): "
              f"{differ} of {sum(len(x) for x in e['tokens'])} tokens differ from one rank's; "
              f"tokens/s "
              f"{e['tokens_per_s']} (one rank {wit[f'engine/{wire}']['tokens_per_s']}; these "
              f"times measure gloo); kv heads a rank {e['kv_heads']} (scales "
              f"{e['scale_heads']}); K4 {json.dumps(e['k4'])}", flush=True)
    for r, rec in enumerate(res):
        g = rec["group_pod"]
        print(f"  (b) gmf_select's group mode over the pod's data group, llama3.2-1b "
              f"({FSDP_LAYERS[LLAMA]} layers) gmf_pod's bf16 row of {g['elements']} elements a "
              f"rank, rank {r} ({card}): plan (cut, split, tiles) {g['plan']}; {g['ms']:.4f} ms "
              f"(gloo's all-reduces in) vs the single launch over the rank's row "
              f"{g['single_ms']:.4f}; bound {g['bound_ms']:.4f} ms (bytes)", flush=True)
    print(f"  (b) {res[0]['b_s']:.1f} s, (c) {res[0]['c_s']:.1f} s, (d) {res[0]['d_s']:.1f} s; "
          f"peak GiB a process {[round(x['peak_gib'], 3) for x in res]}", flush=True)
    # the checks
    for r, rec in enumerate(res):
        sel = rec["select"]
        bad = [k for k, ok in sel["equal"].items() if not ok]
        check(not bad, f"(b) group select over the data group, rank {r}: not bitwise in {bad}")
        check(sel["f32/owners"] == [k != "s" or r == 0 for k in sorted(FSDP_SELECT)],
              f"(b) group select, rank {r}: owners {sel['f32/owners']}")
        e = rec["engine"]
        for wire in ENGINE_MESH_WIRES:
            check(e[wire]["tokens"] == wit[f"engine/{wire}"]["tokens"],
                  f"(d) rank {r}, {wire}: the engine's tokens at (1, 2) differ from one rank's")
            check(e[wire]["kv_heads"] == 4, f"(d) rank {r}: {e[wire]['kv_heads']} kv heads a rank")
            check(e[wire]["k4"]["flash_attention"] == 16 * len(ENGINE["lengths"]),
                  f"(d) rank {r}, {wire}: K4 launches {e[wire]['k4']}")
        k = rec["kimi"]
        check(k["tokens"] == wit["kimi"]["tokens"],
              f"(c) kimi rank {r}: tokens {k['tokens']} vs one rank's {wit['kimi']['tokens']}")
        check(k["no_drop_dropped"] == 0 and k["no_drop_tokens"] == wit["kimi"]["tokens"]
              and kimi_whole[r] <= EP_SERVE_TOL,
              f"(c) kimi rank {r}, nothing dropped: {k['no_drop_dropped']} dropped, tokens "
              f"{k['no_drop_tokens']}, logits {kimi_whole[r]:.3e} relative L2 from one rank's")
        check(k["k4"].get("flash_attention_tc") == KIMI_SERVE["layers"] and k["moe_ep"] > 0,
              f"(c) kimi rank {r}: K4 {k['k4']}, moe_ep {k['moe_ep']}")
    for key in ("dense", "gmf_pod", "ep_train"):
        rec = res[0][key]
        t, o = rec["mesh"], rec["less"]
        for a, b in zip(t["recs"], o["recs"], strict=True):
            check(abs(a["loss"] - b["loss"]) <= FSDP_TOL * abs(b["loss"]),
                  f"({key}) loss {a['loss']} vs {b['loss']} without a mesh")
        for r, x in enumerate(res):
            check(x[key]["param_rel_l2"] <= FSDP_TOL,
                  f"({key}) rank {r}: params {x[key]['param_rel_l2']:.3e} relative L2 from the "
                  f"mesh-less run's")
            tol = EP_DELTA_TOL if key == "ep_train" else FSDP_DELTA_TOL
            check(x[key]["delta_rel_l2"] <= tol,
                  f"({key}) rank {r}: the params' change {x[key]['delta_rel_l2']:.3e} relative "
                  f"L2 from the mesh-less run's at its worst leaf (> {tol})")
        check(t["total"] == o["total"], f"({key}) total_params {t['total']} vs {o['total']}")
        if key != "ep_train":
            check(rec["cut_data"] > 0, f"({key}) no leaf cut over data")
    g = res[0]["gmf_pod"]
    for a, b in zip(g["mesh"]["recs"], g["less"]["recs"], strict=True):
        flips = max(abs(x - y) for x, y in zip(a["upload_nnz"], b["upload_nnz"], strict=True))
        check(min(a["upload_nnz"]) >= g["exact_k"],
              f"(b) gmf_pod: upload nnz {a['upload_nnz']} < the exact-k sum {g['exact_k']}")
        check(flips <= FSDP_NNZ_FLIPS, f"(b) gmf_pod: upload nnz {a['upload_nnz']} vs "
                                       f"{b['upload_nnz']} without a mesh ({flips} > "
                                       f"{FSDP_NNZ_FLIPS})")
    n = PAIR_STEPS[LLAMA]
    want = {"gmf_select[group:bf16,bf16]": n, "gmf_compress[bf16,bf16]": n,
            "momentum_correction[bf16,bf16->bf16]": n}
    for r, rec in enumerate(res):
        check(rec["gmf_pod"]["mesh"]["inst"] == want,
              f"(b) gmf_pod rank {r}: launches {rec['gmf_pod']['mesh']['inst']}, expected {want}")
        check(not rec["dense"]["mesh"]["inst"], f"(b) dense launched {rec['dense']['mesh']['inst']}")
        check(rec["ep_train"]["mesh"]["moe_ep"] == EP_STEPS * EP_LAYERS,
              f"(c) granite rank {r}: moe_ep {rec['ep_train']['mesh']['moe_ep']}")


def fsdp_phase(rt, dev, card, beside=None):
    """Phase 19: the witnesses of (c) and (d) in this process, then (b)-(d)
    in two processes, ``beside()`` running in this process meanwhile (the
    pair is bound by gloo's copies through host memory and holds ~40 GiB of
    the card). (FSDP runs only on a data axis over 1, so a one-rank mesh
    runs phase 17's steps: the pair is where FSDP runs.)"""
    import gc

    FSDP_DIR.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    wit = fsdp_witnesses(rt, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"  this process holds {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB; "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card", flush=True)
    return fsdp_pair_phase(rt, card, wit, beside)


# ---------------------------------------------------------------------------
# phase 20: every compression stage over leaves cut across the model axis
# (ROADMAP item 11 part C2b)
# ---------------------------------------------------------------------------

PHASE20 = ("phase 20: every compression stage over leaves cut across the model axis: the "
           "stage-level check, then llama3.2-1b (2 layers) under the eight configurations at "
           "(1, 2) and two under FSDP at (1, 2, 1), two processes on the card (gloo)")
# the paths whose runs launch gmf_select's group mode (the kernel table's row)
GROUP_PATHS = ("llama_tp", "llama_fsdp", "llama_stages_cut")
STAGES_DIR = ROOT / "build" / "stages"  # phase 20's store and the workers' records (ignored)
# (b)'s runs: llama3.2-1b at its published widths, 2 of 16 layers (646,981,632
# params), bf16, batch 2 x 128, 2 steps a configuration over the mesh and
# without one
STAGES_TRAIN = dict(layers=2, batch=2, seq_len=128, steps=2)
# the fused GMF path's launches a step (gmf_select, the K1 mask pass, K2); the
# staged top-k path's (K2, gmf_select's |z| mode, K3)
_FUSED = {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1}
_STAGED = {"momentum_correction": 1, "gmf_select": 1, "apply_mask": 1}
# name -> (CompressionConfig keywords, grad_sync, mesh shape, the compression
# kernels' launches a step). Global top-k selects by a radix select in torch
# ops (K2 and K3 still launch); random-k and FetchSGD's sketch launch none of
# K1-K3 (error feedback and the sketch are torch ops)
STAGES_CUT = {
    "sampled": (dict(scheme="dgcwgmf", selector="sampled"), "gmf_data", (1, 2), _FUSED),
    "global": (dict(scheme="dgc", per_tensor=False), "gmf_data", (1, 2),
               {"momentum_correction": 1, "apply_mask": 1}),
    "randomk": (dict(scheme="randomk"), "gmf_data", (1, 2), {}),
    "fetchsgd": (dict(scheme="fetchsgd"), "gmf_data", (1, 2), {}),
    "int8": (dict(scheme="dgc", wire_stage="int8"), "gmf_data", (1, 2), _STAGED),
    "probquant": (dict(scheme="dgc", wire_stage="probquant"), "gmf_data", (1, 2), _STAGED),
    "hadamard": (dict(scheme="dgc", rotation_stage="hadamard"), "gmf_data", (1, 2), _STAGED),
    "adaptive": (dict(scheme="adaptive_dgcwgmf"), "gmf_data", (1, 2), _FUSED),
    "fsdp_sampled": (dict(scheme="dgcwgmf", selector="sampled"), "gmf_pod", (1, 2, 1), _FUSED),
    "fsdp_int8": (dict(scheme="dgcwgmf", wire_stage="int8"), "gmf_pod", (1, 2, 1), _FUSED),
}
# (a)'s stage-level check: the configurations whose stages cut or key a leaf
# by flat coordinate, and the top-k downlink's global, sampled, int8 and
# probquant variants, on TP_SELECT's leaves (TP_SELECT_ROWS rows)
STAGES_CHECK = {name: kw for name, (kw, *_) in STAGES_CUT.items() if not name.startswith("fsdp")}
STAGES_CHECK |= {"dl_global": dict(scheme="dgcwgmf_dl", per_tensor=False),
                 "dl_sampled": dict(scheme="dgcwgmf_dl", selector="sampled"),
                 "dl_int8": dict(scheme="dgcwgmf_dl", wire_stage="int8"),
                 "dl_probquant": dict(scheme="dgcwgmf_dl", wire_stage="probquant")}
# the sketch over two ranks sums its buckets in another order (atomics on
# the card): its payload and error within this of their largest magnitude
STAGES_SKETCH_REL = 1e-5


def stages_check(rt, group, dev):
    """(a) on this rank: each of STAGES_CHECK through ``client_compress`` and
    ``server_aggregate`` on the rank's pieces of TP_SELECT's leaves (the
    layout ``over`` the model group with each piece's box) and on the whole
    leaves (no group), on the same rows: which outputs are bitwise the
    whole run's pieces (the sketch's payload and error within
    STAGES_SKETCH_REL, its hitters bitwise on the whole run's summed
    sketch). Integer-valued inputs in [-6, 6] under GMF (every norm exact in
    any order), normal draws elsewhere. Returns {name: {output: bool}} and
    the largest relative difference of the sketch."""
    import torch.distributed as dist

    from repro_torch.core.state import ClientState, ServerState
    from repro_torch.utils.flat import Box

    r, n = dist.get_rank(group), dist.get_world_size(group)
    names = sorted(TP_SELECT)
    whole_lay = rt.flat.FlatLayout.of({k: torch.zeros(TP_SELECT[k][0], device=dev) for k in names})
    places = [(None, [Box(s, tuple(q * (e // n) if j == d else 0 for j, e in enumerate(s)))
                      for s, d in (TP_SELECT[k] for k in names)]) for q in range(n)]

    # the pieces in their own shapes (the sampled estimator reads them)
    small = rt.flat.FlatLayout.of({k: torch.zeros(
        [e // n if j == d else e for j, e in enumerate(TP_SELECT[k][0])], device=dev)
        for k, d in ((k, TP_SELECT[k][1]) for k in names)})

    def piece(x):  # [rows, N] of the whole leaves -> the rank's pieces
        return small.flatten({k: t if TP_SELECT[k][1] is None else
                              t.chunk(n, dim=TP_SELECT[k][1] + 1)[r]
                              for k, t in whole_lay.unflatten(x).items()})

    lay = small.over(group, whole_lay.sizes, places)
    out, worst = {}, 0.0
    rows = TP_SELECT_ROWS
    for name, kw in STAGES_CHECK.items():
        cfg = rt.core.CompressionConfig(rate=RATE, downlink_rate=RATE, tau=0.3, **kw)
        scheme = rt.core.resolve(cfg)
        gen = torch.Generator(device=dev).manual_seed(43)
        ints = scheme.fusion.name == "gmf"

        def draw():
            if ints:
                return torch.randint(-6, 7, (rows, whole_lay.total), generator=gen,
                                     device=dev).float()
            return torch.randn((rows, whole_lay.total), generator=gen, device=dev)

        u, v, m, res, smom, grad, gbar = (draw() for _ in range(7))
        extra = dict(client_ids=torch.tensor([3, 8, 1], device=dev))
        if name == "adaptive":
            extra.update(rates=torch.tensor([0.05, 0.2, 0.5], device=dev),
                         wire_levels=torch.tensor([0, 1, 0], device=dev))
        zero_sk = lambda: torch.zeros(cfg.sketch_rows, cfg.sketch_cols, device=dev)  # noqa: E731

        def run(layout, cut, g_sum=None):
            st = ClientState(u=cut(u) if scheme.uses_u else {}, v=cut(v) if scheme.uses_v else {},
                             m=cut(m) if scheme.uses_m else {})
            g, new, info = scheme.client_compress(st, cut(grad), cut(gbar)[0], 2, layout=layout,
                                                  **extra)
            sst = ServerState(momentum=({"s_mom": zero_sk(), "s_err": zero_sk()}
                                        if scheme.is_sketch else cut(smom)[0]
                                        if scheme.server_momentum else {}),
                              residual=cut(res)[0] if scheme.downlink_residual else {})
            bc, sst, ainfo = scheme.server_aggregate(sst, g.sum(0) if g_sum is None else g_sum,
                                                     3.0, layout=layout, lr=0.05)
            return g, new, info, bc, sst, ainfo

        got, want = run(lay, piece), run(whole_lay, lambda x: x)
        held = {}

        def same(what, a, b):
            held[what] = bool(a.shape == b.shape and torch.equal(a, b))

        if scheme.is_sketch:
            err = float((got[0] - want[0]).abs().max() / want[0].abs().max())
            held["payload (within the tolerance)"] = err <= STAGES_SKETCH_REL
            worst = max(worst, err)
            got = run(lay, piece, want[0].sum(0))  # the server on the whole run's sketch
            se = got[4].momentum["s_err"] - want[4].momentum["s_err"]
            err = float(se.abs().max() / want[4].momentum["s_err"].abs().max())
            held["s_err (within the tolerance)"] = err <= STAGES_SKETCH_REL
            worst = max(worst, err)
        else:
            same("payload", got[0], piece(want[0]))
        for f in ("u", "v", "m"):
            if isinstance(getattr(got[1], f), torch.Tensor):
                same(f, getattr(got[1], f), piece(getattr(want[1], f)))
        same("upload_nnz", got[2].upload_nnz, want[2].upload_nnz)
        same("bcast", got[3], piece(want[3][None])[0])
        if scheme.downlink_residual:
            same("residual", got[4].residual, piece(want[4].residual[None])[0])
        same("download_nnz", got[5].download_nnz, want[5].download_nnz)
        held["total_params"] = got[2].total_params == want[2].total_params == whole_lay.total
        out[name] = held
    torch.cuda.synchronize()
    return out, worst


def stages_train(rt, rank, name, dev):
    """(b) one configuration of STAGES_CUT: STAGES_TRAIN's steps over its mesh
    (each rank its pieces, FSDP's under gmf_pod), then rank 0's mesh-less run
    of gmf_data on the same params and batches (rank 1 waits). Returns the
    record: losses and counts of both runs, the compression kernels'
    launches by instance, and on rank 0 its pieces' params and their change
    against the mesh-less run's (relative L2 over all leaves)."""
    import gc

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
    from repro_torch.dist import sharding as shr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer

    kw, sync, shape, _ = STAGES_CUT[name]
    cfg = dataclasses.replace(rt.configs.get_config(LLAMA), num_layers=STAGES_TRAIN["layers"])
    mesh = make_mesh(shape, ("pod", "data", "model")[-len(shape):])
    fsdp = sync == "gmf_pod"
    steps = STAGES_TRAIN["steps"]

    def run(m):
        tcfg = TrainConfig(learning_rate=3e-3, total_steps=steps + 1,
                           grad_sync=sync if m is not None else "gmf_data",
                           lr_schedule="cosine", warmup_steps=1)
        ccfg = rt.core.CompressionConfig(rate=RATE, tau=0.3, use_kernels=True, **kw)
        params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        if m is not None:
            params = pieces_of(rt, params, m, fsdp)[0]
        init = [x.clone() for x in rt.utils.tree_leaves(params)]
        state = rt.dstep.init_train_state(cfg, tcfg, ccfg, params, m)
        del params
        step = rt.dstep.make_train_step(cfg, tcfg, ccfg, m)
        b_sh = (shr.named_shardings(m, rt.dstep.step_batch_specs(cfg, tcfg, m))
                if m is not None else None)
        stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=STAGES_TRAIN["seq_len"],
                                   batch_size=STAGES_TRAIN["batch"], seed=0)
        rt.gk.reset_launches()
        recs, ms = [], []
        for _, b in zip(range(steps), stream, strict=False):
            batch = to_tensors(b, dev)
            if b_sh is not None:
                batch = shr.local_tree(batch, b_sh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            recs.append({"loss": float(met["loss"]), "upload_nnz": met["upload_nnz"].tolist()})
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        final = rt.utils.tree_leaves(state.params)
        if m is None:  # rank 0's pieces of the mesh-less run's params
            specs = rt.utils.tree_leaves(shr.param_specs(transformer.abstract_params(cfg),
                                                         fsdp=fsdp, mesh=mesh))
            final = [piece_of(x, sp, mesh) for x, sp in zip(final, specs, strict=True)]
            init = [piece_of(x, sp, mesh) for x, sp in zip(init, specs, strict=True)]
        delta = [a.float() - b.float() for a, b in zip(final, init, strict=True)]
        rec = dict(recs=recs, ms=ms, total=int(met["total_params"]),
                   inst={f"{k[0]}[{k[1]}]": c for k, c in rt.gk.INSTANCES.items()},
                   launches=dict(rt.gk.LAUNCHES))
        out = (rec, [x.clone() for x in final], delta)
        del state, step, init, final
        gc.collect()
        torch.cuda.empty_cache()
        return out

    dstep = rt.dstep
    dstep._FSDP_PARAM_THRESHOLD = 0 if fsdp else 40e9  # FSDP forced: 2 layers fall under 40e9
    try:
        meshed, m_final, m_delta = run(mesh)
    finally:
        dstep._FSDP_PARAM_THRESHOLD = 40e9
    torch.distributed.barrier()
    out = {"mesh": meshed, "cut_leaves": sum(
        a.numel() != b.numel() for a, b in zip(m_final, rt.utils.tree_leaves(
            transformer.abstract_params(cfg)), strict=True))}
    if rank == 0:
        less, l_final, l_delta = run(None)
        out["less"] = less
        out["param_rel_l2"] = max(float((a.float() - b.float()).norm() / b.float().norm()
                                        .clamp_min(1e-30)) for a, b in zip(m_final, l_final,
                                                                           strict=True))
        off = sum(float((a - b).norm()) ** 2 for a, b in zip(m_delta, l_delta, strict=True))
        moved = sum(float(b.norm()) ** 2 for b in l_delta)
        out["delta_rel_l2"] = math.sqrt(off / max(moved, 1e-60))
        del l_final, l_delta
    del m_final, m_delta
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return out


def stages_worker(rank: int, init: str, dest: str) -> None:
    """One of phase 20's two processes on the one card: a gloo world of two
    over ``init`` (the card's tensors cross it), (a) the stage-level check
    over the model group of the mesh (1, 2), then (b) each configuration's
    training runs; the records to ``dest`` (JSON)."""
    sys.path.insert(0, str(SRC))
    import datetime
    import faulthandler

    import repro_torch.configs as configs
    import repro_torch.core as core
    import repro_torch.utils as utils
    from repro_torch.core import sparsify
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import flat

    rt = argparse.Namespace(core=core, utils=utils, gk=gk, configs=configs, dstep=dstep,
                            sparsify=sparsify, flat=flat)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    faulthandler.enable()
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                                         timeout=datetime.timedelta(seconds=600))
    out = {"rank": rank}
    try:
        t0 = time.perf_counter()
        group = make_mesh((1, 2), ("data", "model")).get_group("model")
        out["check"], out["sketch_rel"] = stages_check(rt, group, dev)
        out["check_s"] = time.perf_counter() - t0
        out["train"] = {}
        for name in STAGES_CUT:
            t0 = time.perf_counter()
            out["train"][name] = stages_train(rt, rank, name, dev)
            out["train"][name]["s"] = time.perf_counter() - t0
            print(f"rank {rank}: {name} in {out['train'][name]['s']:.1f} s", flush=True)
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    Path(dest).write_text(json.dumps(out))


def stages_cut_phase(rt, card):
    """Phase 20: two processes on the one card (``chip_smoke.py
    --stages-worker``), started together, waited for with a time limit and
    killed past it; prints the readings, then checks them. Returns (rank
    0's records, the compression kernels' launches by (kernel, instance)
    over both ranks' mesh runs and rank 0's mesh-less runs)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    STAGES_DIR.mkdir(parents=True, exist_ok=True)
    store = STAGES_DIR / "store_two"
    store.unlink(missing_ok=True)
    dests = [STAGES_DIR / f"rank{r}.json" for r in range(2)]
    for d in dests:
        d.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--stages-worker",
                               str(r), "--tp-init", f"file://{store}", "--tp-out", str(dests[r])],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.unlink(missing_ok=True)
    check(all(p.returncode == 0 for p in procs),
          "phase 20 workers failed:\n" + "\n".join(f"--- rank {r} (rc {p.returncode}):\n"
                                                   f"{log[-3000:]}" for r, (p, log) in
                                                   enumerate(zip(procs, logs, strict=True))))
    res = [json.loads(d.read_text()) for d in dests]
    return res[0], stages_report(res, card)


def stages_report(res, card):
    """Phase 20's readings, then their checks, from the two ranks' records.
    Returns the compression kernels' launches by (kernel, instance) over
    both ranks' mesh runs and rank 0's mesh-less runs."""
    steps = STAGES_TRAIN["steps"]
    for r, rec in enumerate(res):  # the readings first, so that a failing run shows them all
        bad = {n: [k for k, ok in h.items() if not ok] for n, h in rec["check"].items()}
        print(f"  (a) rank {r}: {len(rec['check'])} configurations on TP_SELECT's leaves over "
              f"the two ranks against the whole leaves in {rec['check_s']:.1f} s; not bitwise: "
              f"{ {n: b for n, b in bad.items() if b} or 'none'}; the sketch within "
              f"{rec['sketch_rel']:.3e} of its largest magnitude", flush=True)
    print(f"  (b) llama3.2-1b, {STAGES_TRAIN['layers']} of 16 layers, bf16, batch "
          f"{STAGES_TRAIN['batch']} x {STAGES_TRAIN['seq_len']}, {steps} steps a configuration, "
          f"two processes on one card over gloo ({card}):", flush=True)
    r0 = res[0]["train"]
    for name, tr in r0.items():
        t, o = tr["mesh"], tr["less"]
        print(f"    {name} at {STAGES_CUT[name][2]} ({STAGES_CUT[name][1]}): losses "
              f"{[x['loss'] for x in t['recs']]} (no mesh {[x['loss'] for x in o['recs']]}); "
              f"params within {tr['param_rel_l2']:.3e}, their change within "
              f"{tr['delta_rel_l2']:.3e} relative L2 (rank 0's pieces); upload nnz "
              f"{[x['upload_nnz'] for x in t['recs']]} (no mesh "
              f"{[x['upload_nnz'] for x in o['recs']]}); ms/step {[round(x, 1) for x in t['ms']]}"
              f" (no mesh {[round(x, 1) for x in o['ms']]}; reported only); launches "
              f"{json.dumps(t['inst'])} (no mesh {json.dumps(o['inst'])}); {tr['s']:.1f} s",
              flush=True)
    print(f"  phase 20 workers' peak GiB: {[round(x['peak_gib'], 2) for x in res]}", flush=True)
    inst = {}
    for r, rec in enumerate(res):
        bad = {n: [k for k, ok in h.items() if not ok] for n, h in rec["check"].items()}
        check(not any(bad.values()), f"(a) rank {r}: not the whole leaves' pieces: {bad}")
        check(set(rec["check"]) == set(STAGES_CHECK), f"(a) rank {r}: ran {list(rec['check'])}")
        for name, tr in rec["train"].items():
            want = {k: steps * n for k, n in STAGES_CUT[name][3].items()}
            got = {k: n for k, n in tr["mesh"]["launches"].items() if n}
            check(got == want, f"(b) {name} rank {r}: launches {got}, expected {want}")
            check(tr["cut_leaves"] > 0, f"(b) {name} rank {r}: no leaf cut")
            for k, n in tr["mesh"]["inst"].items():
                key = tuple(k[:-1].split("[", 1))
                inst[key] = inst.get(key, 0) + n
    for name, tr in r0.items():
        t, o = tr["mesh"], tr["less"]
        for a, b in zip(t["recs"], o["recs"], strict=True):
            check(abs(a["loss"] - b["loss"]) <= TP_TRAIN_TOL * abs(b["loss"]),
                  f"(b) {name}: loss {a['loss']} vs {b['loss']} without a mesh")
        check(tr["delta_rel_l2"] <= TP_DELTA_TOL,
              f"(b) {name}: the params' change {tr['delta_rel_l2']:.3e} relative L2 from the "
              f"mesh-less run's")
        check(t["total"] == o["total"], f"(b) {name}: total_params {t['total']} vs {o['total']}")
        want = {k: steps * n for k, n in STAGES_CUT[name][3].items()}
        got = {k: n for k, n in o["launches"].items() if n}
        check(got == want, f"(b) {name}: the mesh-less run's launches {got}, expected {want}")
        for k, n in o["inst"].items():
            key = tuple(k[:-1].split("[", 1))
            inst[key] = inst.get(key, 0) + n
    return inst


# ---------------------------------------------------------------------------
# Phase 21: the dry run (launch/dryrun.py) against the card
# ---------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "build" / "dryrun" / "phase21"  # stores and records (ignored by git)
DRYRUN_CALIB = dict(batch=8, seq_len=256)  # (a): phase 14's step
DRYRUN_CALIB_TOL = 0.10  # (a): the reckoned peak within 10 % of the measured one
DRYRUN_TALLY_LAYERS = 2  # (b): llama3.2-1b's depth at (1, 2)
DRYRUN_CLI = (("--arch", LLAMA, "--shape", "train_4k"),
              ("--arch", LLAMA, "--shape", "prefill_32k", "--mesh", "multi"))
PHASE21 = ("phase 21: the dry run (launch/dryrun.py): the reckoned peak against the card's, the "
           "collective tally at (1, 2) against the fake pass's, the CLI, the fake kernels")


def dryrun_train_cfgs(rt, sync="gmf_data"):
    from repro_torch.configs.base import TrainConfig

    tcfg = TrainConfig(learning_rate=3e-3, total_steps=10, grad_sync=sync)
    ccfg = rt.core.CompressionConfig(scheme="dgcwgmf", rate=RATE, tau=0.3, use_kernels=True)
    return tcfg, ccfg


def dryrun_calib_worker(dest: str) -> None:
    """(a), a process of its own: llama3.2-1b at its published size as phase
    14 trains it (bf16, batch 8 x 256, gmf_data, fused dgcwgmf at rate 0.1,
    mesh-less) for two steps on the card; over step 2 (after
    ``reset_peak_memory_stats``) ``max_memory_allocated`` and the live bytes
    of its inputs; then the fake-tensor pass of the same step. The records
    to ``dest`` (JSON)."""
    sys.path.insert(0, str(SRC))
    import repro_torch.core as core
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    rt = argparse.Namespace(core=core)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = configs.get_config(LLAMA)
    tcfg, ccfg = dryrun_train_cfgs(rt)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = dstep.init_train_state(cfg, tcfg, ccfg, params, None)
    del params
    step = dstep.make_train_step(cfg, tcfg, ccfg, None)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=DRYRUN_CALIB["seq_len"],
                               batch_size=DRYRUN_CALIB["batch"], seed=0)
    state, _ = step(state, to_tensors(next(stream), dev))
    batch = to_tensors(next(stream), dev)
    torch.cuda.synchronize()
    args = dryrun.storage_bytes((state, batch))
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gk.reset_launches()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    real_launches = dict(gk.LAUNCHES)
    loss = float(m["loss"])
    batch_meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    del state, m, batch
    t0 = time.perf_counter()
    got = dryrun.trace_train(cfg, tcfg, ccfg, None, batch_meta)
    out = {"measured": {"argument_bytes": args, "peak_bytes": peak,
                        "allocated_before_bytes": before, "launches": real_launches,
                        "loss": loss},
           "reckoned": {**got["memory"], "kernels": got["kernels"], "cost": got["cost"],
                        "trace_s": time.perf_counter() - t0}}
    Path(dest).write_text(json.dumps(out))


def dryrun_tally_worker(rank: int, init: str, dest: str) -> None:
    """(b), one of three processes: rank 0 or 1 of a gloo world of two over
    ``init`` (the card's tensors cross it) tallying the first gmf_data step
    of llama3.2-1b (``DRYRUN_TALLY_LAYERS`` layers, bf16, fused dgcwgmf) at
    the mesh (1, 2); or (rank -1) rank 0's fake-tensor pass of the same
    step in a fake world of two. The tally to ``dest`` (JSON)."""
    sys.path.insert(0, str(SRC))
    import datetime

    import repro_torch.core as core
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
    from repro_torch.dist import sharding as shr
    from repro_torch.dist import step as dstep
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.obs.collectives import CollectiveTally

    rt = argparse.Namespace(core=core)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = dataclasses.replace(configs.get_config(LLAMA), num_layers=DRYRUN_TALLY_LAYERS)
    tcfg, ccfg = dryrun_train_cfgs(rt)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=DRYRUN_CALIB["seq_len"],
                               batch_size=DRYRUN_CALIB["batch"], seed=0)
    batch = to_tensors(next(stream), dev)
    if rank < 0:
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
        with dryrun.fake_world(2):
            got = dryrun.trace_train(cfg, tcfg, ccfg, make_mesh((1, 2), ("data", "model")), meta)
        out = {"counts": got["collective_counts"],
               "bytes": {k: int(v) for k, v in got["collectives"].items()
                         if k not in ("num_collectives", "total_bytes")},
               "kernels": got["kernels"]}
        Path(dest).write_text(json.dumps(out))
        return
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                                         timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 2), ("data", "model"))
        params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        params = shr.local_tree(params, shr.named_shardings(
            mesh, shr.param_specs(params, fsdp=False, mesh=mesh)))
        state = dstep.init_train_state(cfg, tcfg, ccfg, params, mesh)
        del params
        step = dstep.make_train_step(cfg, tcfg, ccfg, mesh)
        batch = shr.local_tree(batch, shr.named_shardings(
            mesh, dstep.step_batch_specs(cfg, tcfg, mesh)))
        with CollectiveTally() as tally:
            state, m = step(state, batch)
            torch.cuda.synchronize()
        out = {"counts": tally.counts, "bytes": tally.bytes, "loss": float(m["loss"])}
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    Path(dest).write_text(json.dumps(out))


def dryrun_kernel_calls(rt, dev, dtype):
    """Every kernel wrapper once on ``dev`` (the card, or fake tensors on
    it): {kernel: outputs}."""
    gen = torch.Generator().manual_seed(5)
    tree = {"a": torch.zeros(3, 700, device=dev), "b": torch.zeros(5000, device=dev)}
    lay = rt.flat.FlatLayout.of(tree)
    x = torch.randn(3, lay.total, generator=gen).to(dev, dtype)
    mask = (torch.rand(3, lay.total, generator=gen) > 0.5).float().to(dev)
    w, tau = torch.ones(3, device=dev), torch.full((3,), 0.3, device=dev)
    sel = rt.ops.gmf_select(x, x, lay, RATE, w=w, tau=tau, eps=EPS)
    out = {"momentum_correction": rt.ops.momentum_correction(x, x, x, 0.9),
           "apply_mask": rt.ops.apply_mask_update(x, x, mask),
           "gmf_select": sel,
           "gmf_compress": rt.ops.gmf_compress(x, x, x, layout=lay, inv_norm_v=sel[0],
                                               inv_norm_m=sel[1], tau=tau, threshold=sel[2]),
           "topk_abs_select": rt.ops.topk_abs_select(x, lay, RATE)}
    for d in (64, 128) if dtype == BF16 else (64,):  # the tensor-core / CUDA-core kernels
        q = torch.randn(2, 128, 4, d, generator=gen).to(dev, dtype)
        k = torch.randn(2, 128, 2, d, generator=gen).to(dev, dtype)
        out[f"flash_attention_{rt.k4.kernel_for(dtype, d)}_d{d}"] = rt.k4.flash_attention(q, k, k)
    return out


def dryrun_kernel_shapes(rt, dev):
    """(d): each kernel's fake outputs against its real launch's on the card,
    shapes and dtypes, in float32 and bf16 -> {kernel/dtype: equal}."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun

    def described(outs):
        return {name: [(tuple(t.shape), t.dtype) for t in
                       (out if isinstance(out, (tuple, list)) else (out,))]
                for name, out in outs.items()}

    res = {}
    for dtype in (torch.float32, BF16):
        real = described(dryrun_kernel_calls(rt, dev, dtype))
        with dryrun.fresh_caches(), FakeTensorMode():
            fake = described(dryrun_kernel_calls(rt, dev, dtype))
        for name in real:
            res[f"{name}/{str(dtype).replace('torch.', '')}"] = real[name] == fake[name]
    torch.cuda.synchronize()
    return res


def dryrun_phase(rt, dev, card):
    """Phase 21: (a) the calibration, (b) the tally's three processes and (c)
    the CLI's two, all started together; (d) in this process meanwhile.
    Checks and prints each."""
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    store = DRYRUN_DIR / "store"
    store.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    me = [sys.executable, str(ROOT / "chip_smoke.py")]
    calib = DRYRUN_DIR / "calib.json"
    tallies = [DRYRUN_DIR / f"tally{r}.json" for r in (0, 1, -1)]
    for f in (calib, *tallies):
        f.unlink(missing_ok=True)
    jobs = {"calib": me + ["--dryrun-worker", "calib", "--tp-out", str(calib)]}
    for r, dest in zip((0, 1, -1), tallies, strict=True):
        jobs[f"tally{r}"] = me + ["--dryrun-worker", str(r), "--tp-init", f"file://{store}",
                                  "--tp-out", str(dest)]
    for i, cli in enumerate(DRYRUN_CLI):
        jobs[f"cli{i}"] = [sys.executable, "-m", "repro_torch.launch.dryrun", *cli,
                           "--out", str(DRYRUN_DIR / "records")]
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for k, cmd in jobs.items()}
    try:
        shapes = dryrun_kernel_shapes(rt, dev)
        logs = {k: p.communicate(timeout=240)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        store.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    for k, p in procs.items():
        check(p.returncode == 0, f"phase 21 {k} failed (rc {p.returncode}):\n{logs[k][-3000:]}")
    # (a) the calibration
    cal = json.loads(calib.read_text())
    meas, reck = cal["measured"], cal["reckoned"]
    ratio = reck["peak_bytes_per_chip"] / meas["peak_bytes"]
    print(f"  (a) llama3.2-1b, bf16, batch {DRYRUN_CALIB['batch']} x {DRYRUN_CALIB['seq_len']}, "
          f"gmf_data, fused dgcwgmf, mesh-less, step 2 ({card}): measured peak "
          f"{meas['peak_bytes']} B (max_memory_allocated; {meas['allocated_before_bytes']} B "
          f"allocated before the step), arguments {meas['argument_bytes']} B; reckoned by the "
          f"fake pass: peak {reck['peak_bytes_per_chip']} B, arguments "
          f"{reck['argument_bytes_per_chip']} B, temp {reck['temp_bytes_per_chip']} B; "
          f"reckoned / measured peak {ratio:.4f}; launches real {meas['launches']}, fake "
          f"{reck['kernels']}; fake pass {reck['trace_s']:.1f} s", flush=True)
    check(reck["argument_bytes_per_chip"] == meas["argument_bytes"],
          f"phase 21 (a): reckoned arguments {reck['argument_bytes_per_chip']} B != measured "
          f"{meas['argument_bytes']} B")
    check(abs(ratio - 1.0) <= DRYRUN_CALIB_TOL,
          f"phase 21 (a): reckoned peak / measured peak = {ratio:.4f}, not within "
          f"{DRYRUN_CALIB_TOL:.0%}")
    # (b) the tally
    real = [json.loads(t.read_text()) for t in tallies[:2]]
    fake = json.loads(tallies[2].read_text())
    print(f"  (b) the first gmf_data step of llama3.2-1b ({DRYRUN_TALLY_LAYERS} layers, bf16, "
          f"fused) at (1, 2), two processes over gloo on the card: tally rank 0 "
          f"{json.dumps({'counts': real[0]['counts'], 'bytes': real[0]['bytes']})}, rank 1 "
          f"{json.dumps({'counts': real[1]['counts'], 'bytes': real[1]['bytes']})}; the fake "
          f"pass's {json.dumps({'counts': fake['counts'], 'bytes': fake['bytes']})} (fake "
          f"launches {fake['kernels']})", flush=True)
    for r, rec in enumerate(real):
        check(rec["counts"] == fake["counts"] and rec["bytes"] == fake["bytes"],
              f"phase 21 (b): rank {r}'s tally {rec['counts']} {rec['bytes']} != the fake "
              f"pass's {fake['counts']} {fake['bytes']}")
    # (c) the CLI
    for i, cli in enumerate(DRYRUN_CLI):
        lines = [ln for ln in logs[f"cli{i}"].splitlines()
                 if ln.startswith(("torch ", "===", "    ", "done;"))]
        print(f"  (c) python -m repro_torch.launch.dryrun {' '.join(cli)}: exit 0\n    "
              + "\n    ".join(lines), flush=True)
    # (d) the fake kernels
    print(f"  (d) the fake kernels' outputs (shapes, dtypes) against the launches': "
          f"{json.dumps(shapes)}", flush=True)
    check(all(shapes.values()), f"phase 21 (d): {[k for k, ok in shapes.items() if not ok]}")
    print(f"  phase 21's processes in {wall:.1f} s", flush=True)
    return {"ratio": ratio, "calib": cal, "tally": fake}


PHASE22 = ("phase 22: static analysis (repro_torch.analysis): the CLI's --all, a ResNet-56 "
           "round audited on the card against its fake pass, the contracts at ResNet-56's "
           "params on the card against fake tensors")


def analysis_audit(rt, dev, card):
    """(b) Round 1 of phase 3's dgcwgmf path (ResNet-56, 20 clients, batch 64,
    use_kernels) audited on the card (``jaxpr_audit.audit_round`` over the
    engine's ``round_fn`` after round 0 built the layout's caches) and the
    same round's fake pass (``fake_twin``, fake CUDA tensors of the same
    shapes): host reads, host-to-device copies, collectives and kernel
    launches equal."""
    from repro_torch.analysis import jaxpr_audit as ja

    task = rt.fl.CifarTask(num_clients=20, depth=56,
                           data=rt.synthetic.SynthCIFAR(num_train=20000), device=dev)
    comp = rt.core.CompressionConfig(scheme="dgcwgmf", rate=0.1, tau=0.6, use_kernels=True)
    fl = rt.fl.FLConfig(num_clients=20, rounds=1, batch_size=64, learning_rate=0.1)
    sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=dev)
    provide = task.batch_provider(64)
    sim.run(provide)  # round 0
    ids = sim._sample_ids(1)
    batches = provide(1, ids, sim._rng)
    args = (sim.params, sim.cstates, sim.sstate, sim.gbar_prev, rt.utils.to_device(ids, dev),
            batches, 1, sim._lr_at(1), None)
    torch.cuda.synchronize()
    real = ja.audit_round(sim.engine.round_fn, args, where="jaxpr:resnet56_dgcwgmf")
    torch.cuda.synchronize()
    with ja.fake_tensors():
        twin, fake_args = ja.fake_twin(sim.engine, args)
        fake = ja.audit_two_rounds(twin, fake_args, where="jaxpr:resnet56_dgcwgmf")
    runs = {}
    for label, a in (("card", real), ("fake", fake)):
        runs[label] = {"host_reads": a.host_reads, "transfers": a.transfers,
                       "collectives": ja.collective_counts(a.tally), "kernels": a.kernels,
                       "findings": [f.format() for f in a.findings]}
    print(f"  (b) ResNet-56 dgcwgmf round 1 (20 clients, batch 64, use_kernels) audited on the "
          f"card ({card}) and as its fake pass: {json.dumps(runs)}", flush=True)
    for key in ("host_reads", "transfers", "collectives", "kernels"):
        same_count = len(runs["card"][key]) == len(runs["fake"][key])
        check(same_count if key in ("host_reads", "transfers")
              else runs["card"][key] == runs["fake"][key],
              f"phase 22 (b): the card's {key} {runs['card'][key]} against the fake pass's "
              f"{runs['fake'][key]}")
    check(real.kernels == {"gmf_select": 1, "gmf_compress": 1, "momentum_correction": 1},
          f"phase 22 (b): the round's launches {real.kernels}")
    check(not real.findings and not fake.findings,
          f"phase 22 (b): findings {runs['card']['findings']} / {runs['fake']['findings']}")
    return runs


def analysis_contracts(rt, dev, card):
    """(c) ``contracts.check_all`` at ResNet-56's params on the card's tensors
    and on fake ones of the same shapes: the same findings (none)."""
    from repro_torch.analysis import contracts

    params = _resnet56_params(dev)
    t0 = time.perf_counter()
    real = contracts.check_all(params=params, fake=False)
    torch.cuda.synchronize()
    t_real = time.perf_counter() - t0
    t0 = time.perf_counter()
    fake = contracts.check_all(params=params)
    t_fake = time.perf_counter() - t0
    pairs = [sorted((f.rule, f.path) for f in found) for found in (real, fake)]
    print(f"  (c) check_all at ResNet-56's params ({card}): on the card {pairs[0]} in "
          f"{t_real:.1f} s, on fake tensors {pairs[1]} in {t_fake:.1f} s", flush=True)
    check(pairs[0] == pairs[1] == [], f"phase 22 (c): {[f.format() for f in real + fake]}")


def analysis_phase(rt, dev, card):
    """Phase 22: (a) ``python -m repro_torch.analysis --all`` in a process of
    its own, while (b) and (c) run in this one."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.analysis", "--all"], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        analysis_audit(rt, dev, card)
        analysis_contracts(rt, dev, card)
        log = cli.communicate(timeout=300)[0]
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    check(cli.returncode == 0, f"phase 22 (a): python -m repro_torch.analysis --all exited "
                               f"{cli.returncode}:\n{log[-3000:]}")
    print(f"  (a) python -m repro_torch.analysis --all: exit 0, "
          f"{log.strip().splitlines()[-1]}", flush=True)
    print(f"  phase 22 in {time.perf_counter() - t0:.1f} s", flush=True)


T_START = time.perf_counter()
PHASE11B = ("phase 11b: granite-moe's mixed tree (bf16 beside float32 routers, published "
            "widths, 2 of 24 layers) through every cross-leaf stage and the async, ring, "
            "hierarchical and shard engines")


def phase(title: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    print(f"{title} [{time.perf_counter() - T_START:.1f} s]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("kernels", "mixed-tree", "group-mode", "model-axis",
                                       "fsdp", "stages-cut", "dryrun", "analysis"),
                    default=None,
                    help="run only the build and kernel phases, or the build and phase 11b, "
                         "18 (a), 18, 19, 20, 21 or 22")
    ap.add_argument("--tp-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fsdp-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stages-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="also break down where a ResNet-56 and a Shakespeare round's, "
                         "each serving run's, a dense training step's and the serving "
                         "engine's time goes (torch.profiler; phases 4, 5, 9, 13, 14 and 16)")
    args = ap.parse_args()
    # Before CUDA starts. Phase 15 peaks at 71.2 GiB run alone; after the
    # earlier phases it ran out of memory with 8.8 GiB reserved by the
    # caching allocator but unallocated (free blocks in segments that live
    # blocks keep), even after empty_cache. Expandable segments map memory
    # in pages that empty_cache and reuse can take back one by one.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if args.tp_worker is not None:  # one of phase 18's two processes
        tp_worker(args.tp_worker, args.tp_init, args.tp_out)
        return
    if args.fsdp_worker is not None:  # one of phase 19's two processes
        fsdp_worker(args.fsdp_worker, args.tp_init, args.tp_out)
        return
    if args.stages_worker is not None:  # one of phase 20's two processes
        stages_worker(args.stages_worker, args.tp_init, args.tp_out)
        return
    if args.dryrun_worker is not None:  # one of phase 21's processes
        if args.dryrun_worker == "calib":
            dryrun_calib_worker(args.tp_out)
        else:
            dryrun_tally_worker(int(args.dryrun_worker), args.tp_init, args.tp_out)
        return
    if not all((SRC / "repro_torch" / "kernels" / "csrc" / f).is_file()
               for f in ("gmf_compress.cu", "flash_attention.cu", "flash_attention_sm90.cu")):
        fail(f"{SRC / 'repro_torch'} is missing: run this script from a checkout of the repo")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    import repro_torch.configs as configs
    import repro_torch.core as core
    import repro_torch.fl as fl
    import repro_torch.obs as obs
    import repro_torch.serve as serving
    import repro_torch.utils as utils
    from repro_torch.core import sparsify, stages
    from repro_torch.data import synthetic
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.obs import report as obs_report
    from repro_torch.utils import flat

    rt = argparse.Namespace(core=core, fl=fl, utils=utils, gk=gk, k4=k4, synthetic=synthetic,
                            sparsify=sparsify, stages=stages, configs=configs, dstep=dstep,
                            serve=serve, ops=ops, ref=ref, flat=flat, obs=obs,
                            obs_report=obs_report, serving=serving)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=False)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    kind = torch.cuda.get_device_name(0)
    bw, peak, bf16_peak = card_rates(kind)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}; "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("phase 1: build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:  # one nvcc per source, at once
        libs = list(pool.map(lambda make: make(), (gk.build, k4.build, k4.build_tc)))
    gk.library()
    k4.library()
    k4.library_tc()
    for lib in libs:
        log = (lib.parent / "build.log").read_text()
        print(f"  {lib.relative_to(ROOT)}:\n  " + "\n  ".join(
            ln for ln in log.splitlines() if "ptxas" in ln or "error" in ln or "warning" in ln
            or "spill" in ln))
    tc_ptxas = build.ptxas_report((libs[2].parent / "build.log").read_text(), "flash_fwd_sm90")
    print(f"  flash_fwd_sm90 by head dim: {json.dumps(tc_ptxas)}", flush=True)
    print(f"  built all three in {time.perf_counter() - t0:.1f} s", flush=True)

    if args.only in ("mixed-tree", "group-mode", "model-axis", "fsdp", "stages-cut", "dryrun",
                     "analysis"):
        if args.only == "mixed-tree":
            phase(PHASE11B)
            mixed_tree_phase(rt, dev, card)
        elif args.only == "dryrun":
            phase(PHASE21)
            dryrun_phase(rt, dev, card)
        elif args.only == "analysis":
            phase(PHASE22)
            analysis_phase(rt, dev, card)
        elif args.only == "group-mode":
            phase("phase 18 (a): gmf_select's group mode at a group of one")
            times = group_one_phase(rt, dev, bw, peak, _resnet56_params(dev))
            print(json.dumps({"group_mode": times}), flush=True)
        elif args.only == "model-axis":
            phase("phase 18: the model axis (gmf_select's group mode at a group of one; two "
                  "processes on the card over gloo)")
            model_axis_phase(rt, dev, card, bw, peak, _resnet56_params(dev))
        elif args.only == "fsdp":
            phase("phase 19: FSDP over data, the expert-parallel MoE and the engine at model 2 "
                  "(two processes on the card over gloo)")
            fsdp_phase(rt, dev, card)
        else:
            phase(PHASE20)
            t20 = time.perf_counter()
            stages_cut_phase(rt, card)
            print(f"  phase 20 in {time.perf_counter() - t20:.1f} s", flush=True)
        phase("results")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    phase("phase 2: kernels vs plain versions")
    resnet_params = _resnet56_params(dev)
    lstm_layout = flat.FlatLayout.of(_lstm_params(dev))
    resnet_layout = flat.FlatLayout.of(resnet_params)
    leaf_shapes = [tuple(x.shape) for x in utils.tree_leaves(resnet_params)]
    worst = {**hold_kernels(gk, ref, dev), **hold_select(rt, resnet_params, dev)}
    toy = select_layouts(rt, resnet_params, dev)[1]
    worst["gmf_select"] = max(worst["gmf_select"], hold_select_keep(rt, [
        ("the char-LSTM, 10 clients", lstm_layout, 10), (toy[0], toy[1], toy[2]),
        ("ResNet-56, 4 clients", resnet_layout, 4)], dev))
    worst["gmf_select"] = max(worst["gmf_select"], hold_select_tiles(rt, dev))
    worst["momentum_correction"] = max(worst["momentum_correction"],
                                       hold_k2_trees(gk, ops, ref, leaf_shapes, dev))
    k4_worst = hold_k4(k4, ref, dev)
    phase("phase 2: K1-K3 over bf16 and mixed-dtype state")
    bf16_worst = hold_bf16_elementwise(rt, dev)
    toy_label, toy_layout, _, _ = toy
    rng = np.random.default_rng(12)
    # bf16 state over the three layouts; float32 state with a bf16 m over the
    # odd segments only
    for label, layout, rows, s_dtype in (("ResNet-56, 4 clients", resnet_layout, 4, BF16),
                                         (toy_label, toy_layout, 5, BF16),
                                         (toy_label, toy_layout, 5, torch.float32),
                                         ("the char-LSTM, 10 clients", lstm_layout, 10, BF16)):
        u, v, m = kernel_inputs(rng, rows, layout.total, dev)
        errs, _ = hold_bf16_select(rt, layout, u.to(s_dtype), v.to(s_dtype), m.to(BF16), label,
                                   dev)
        for key, err in errs.items():
            bf16_worst[key] = max(bf16_worst.get(key, 0.0), err)
    _, llama_params, llama_lay = llama_layout(rt, dev)
    del llama_params
    big_worst, bf16_times = hold_bf16_big_row(rt, llama_lay, bw, peak, dev)
    for part in (big_worst, hold_mixed_tree(rt, dev)):
        for key, err in part.items():
            bf16_worst[key] = max(bf16_worst.get(key, 0.0), err)
    print(json.dumps({"kernels_held": [
        "K1 gmf_select (and its |z| mode)", "K1 gmf_select with a per-row keep table (both modes)",
        "K1 gmf_select split over tiles (tile - 1, tile, tile + 1; all equal; ties across tile "
        "borders; k = 1 and n; both modes)",
        "K1 gmf_compress (flat mask pass)",
        "K2 momentum_correction (multi-tensor)", "K3 apply_mask",
        "K4 flash_attention_tc (tensor cores; G 7 and 12 at D 128; D 112 and 256)",
        "K4 flash_attention_cc (CUDA cores; float32 at D 112 and 256)",
        "K1 gmf_select and gmf_compress over bf16 and (f32 state, bf16 m) stacks and "
        "llama3.2-1b's 3.0 GB bf16 row", "K2 bf16, (f32, bf16), (bf16, f32) and into bf16",
        "K3 bf16 with a f32 or bf16 mask, into f32 or bf16",
        "K1-K3 per dtype group over granite-moe's mixed tree"]}),
        flush=True)

    launches = {name: 0 for _, name, _, _, _ in KERNELS}
    launches.update(flash_attention_tc=0, flash_attention_cc=0)
    by_path = {}  # the compression kernels' launches in each path's run
    bf16_by_path = {}  # the training paths' launches by kernel instance
    served_k4 = {}  # phase 13's K4 launches by config
    tp_times = {}  # phase 18 (a)'s times of gmf_select's group mode
    fsdp_rec = {}  # phase 19's records (rank 0's)
    k4_tc_by_path = {}  # the tensor-core K4's launches in phase 5's and phase 16's runs
    if args.only != "kernels":
        phase("phase 3: ResNet-56 FL path, 20 clients, batch 64")
        by_path["resnet56"], task = path_phase(rt, dev)
        phase("phase 4: card vs CPU, round 0 at depth 8")
        card_vs_cpu_phase(rt, dev)
        if args.profile:
            phase("profile: where a ResNet-56 round's time goes")
            profile_phase(rt, task)
        phase("phase 5: serving llama3.2-1b, batch 4, prompt 2048, 32 tokens")
        _, counts = serve_phase(rt, dev, args.profile)
        k4_tc_by_path["serve_fixed"] = counts["flash_attention_tc"]
        phase("phase 6: serving, card vs CPU, llama3.2-1b width at depth 2")
        launches["flash_attention_cc"] = serve_card_vs_cpu_phase(rt, dev)
        phase("phase 6: serving, card vs CPU, the moe, ssm, hybrid, vlm and audio families "
              "and kimi-k2's head dim 112")
        launches["flash_attention_cc"] += family_card_vs_cpu_phase(rt, dev)
        phase("phase 7: ResNet-56 under the int8 and bf16 wires, the top-k downlink and "
              "per-client rates, 2 rounds each")
        by_path["resnet56_stages"] = resnet_presets_phase(rt, task)
        del task
        phase("phase 8: Shakespeare (char-LSTM, hidden 256), 100 clients, 10 a round, batch "
              "8, lr 0.5, 3 rounds a preset")
        by_path["shakespeare"], task = shakespeare_phase(rt, dev)
        phase("phase 9: Shakespeare card vs CPU, round 0 at full width")
        shakespeare_card_vs_cpu_phase(rt, dev)
        if args.profile:
            phase("profile: where a Shakespeare round's time goes")
            profile_phase(rt, task, [(k, SHAKESPEARE_PRESETS[k][0]) for k in ("dgcwgmf", "dgc")],
                          clients=SHAKESPEARE["clients"], per_round=SHAKESPEARE["per_round"],
                          batch=SHAKESPEARE["batch"], lr=SHAKESPEARE["lr"])
        del task
        phase("phase 10: ResNet-56 under the remaining stage kinds (randomk, fetchsgd, the "
              "probquant wire, the Hadamard rotation), 2 rounds each")
        task = rt.fl.CifarTask(num_clients=20, depth=56,
                               data=rt.synthetic.SynthCIFAR(num_train=20000), device=dev)
        by_path["resnet56_remaining"], remaining_ms = remaining_stages_phase(rt, task)
        print(f"  ms/round after round 0 ({card}): {json.dumps(remaining_ms)}", flush=True)
        phase("phase 10: the remaining stage kinds, card vs CPU, round 0 at depth 8")
        remaining_card_vs_cpu_phase(rt, dev)
        phase("phase 11: ResNet-56 under the async, ring, hierarchical and shard engines")
        by_path["resnet56_engines"], engine_ms = engines_phase(rt, task, dev)
        print(f"  ms/round (ms/tick) after round 0 ({card}): {json.dumps(engine_ms)}",
              flush=True)
        phase(PHASE11B)
        mixed = mixed_tree_phase(rt, dev, card)
        by_path["granite_mixed"], bf16_by_path["granite_mixed"] = mixed[0], mixed[1]
        for key in ("gmf_select", "gmf_compress", "momentum_correction", "apply_mask"):
            bf16_worst[key] = max(bf16_worst.get(key, 0.0), mixed[2]["mixed"])
        phase("phase 12: telemetry (repro_torch.obs) on the card")
        by_path["resnet56_obs"] = obs_phase(rt, task, card, bw)
        del task
        phase("phase 13: serving every remaining architecture at its published widths")
        t13 = time.perf_counter()
        served, served_k4, held = serve_families_phase(rt, dev, card, args.profile)
        for key, err in held.items():
            k4_worst[key] = max(k4_worst[key], err)
        print(f"  phase 13 in {time.perf_counter() - t13:.1f} s ({card}): "
              f"{json.dumps(served)}", flush=True)
        phase("phase 14: training llama3.2-1b at its published size on the one-device "
              "trainer (gmf_data and dense), batch 8, sequence 256, 4 steps")
        t14 = time.perf_counter()
        _, train_inst, _ = train_phase(rt, dev, card, exact_k(llama_lay), args.profile)
        phase("phase 15: LMTask through FLSimulator at llama3.2-1b's widths, 2 layers, 4 "
              "clients, 2 a round, 3 rounds")
        _, lmfl_inst, _ = lmfl_phase(rt, dev, card)
        phase("phase 15: LMTask card vs CPU, the ten architectures at smoke()")
        lmtask_card_vs_cpu_phase(rt, dev)
        print(f"  phases 14-15 in {time.perf_counter() - t14:.1f} s", flush=True)
        for path, inst in (("llama_train", train_inst), ("llama_lmfl", lmfl_inst)):
            by_path[path] = f32_launches(inst)
            bf16_by_path[path] = inst
        phase("phase 16: serving llama3.2-1b through the continuous-batching engine (paged KV "
              "pool, 4 slots, page 16, 130 pages a slot), 8 requests, the four codecs")
        _, k4_tc_by_path["serve_engine"] = engine_phase(rt, dev, card, args.profile)
        phase("phase 17: the mesh's data axes over a one-rank NCCL world: llama3.2-1b (2 "
              "layers) gmf_data, dense and gmf_pod bitwise the mesh-less steps, granite-moe "
              "through moe_ep, launch.train --mesh-shape")
        t17 = time.perf_counter()
        tp_pair = tp_pair_start()  # phase 18's two processes, beside phase 17 and 18 (a)
        try:
            mesh_inst, k4_tc_by_path["mesh_ep_serve"] = mesh_phase(rt, dev, card, served)
            by_path["llama_mesh"] = f32_launches(mesh_inst)
            bf16_by_path["llama_mesh"] = mesh_inst
            print(f"  phase 17 in {time.perf_counter() - t17:.1f} s", flush=True)
            phase("phase 18: the model axis: gmf_select's group mode at a group of one, then "
                  "llama3.2-1b over the mesh (1, 2) in two processes on the card (gloo)")
            t18 = time.perf_counter()
            tp_times, tp_rec, tp_inst = model_axis_phase(rt, dev, card, bw, peak, resnet_params,
                                                         tp_pair)
        finally:
            tp_pair_stop(tp_pair)
        tp_times["max_abs_err"] = max(tp_times["max_abs_err"],
                                      tp_rec.get("select_max_abs_err", 0.0))
        bf16_by_path["llama_tp"] = {tuple(k[:-1].split("[", 1)): n for k, n in tp_inst.items()}
        print(f"  phase 18 in {time.perf_counter() - t18:.1f} s", flush=True)
        phase("phase 19: FSDP over data (qwen2-vl-72b, llama3.2-1b), the expert-parallel MoE "
              "at model 2 (granite-moe, kimi-k2) and the engine at model 2 (llama3.2-1b)")
        t19 = time.perf_counter()

        def analysis():  # phase 22 beside phase 19's pair
            phase(PHASE22)
            analysis_phase(rt, dev, card)

        fsdp_rec = fsdp_phase(rt, dev, card, analysis)
        bf16_by_path["llama_fsdp"] = {
            tuple(k[:-1].split("[", 1)): n
            for k, n in fsdp_rec["gmf_pod"]["mesh"]["inst"].items()}
        k4_tc_by_path["kimi_ep_model2"] = fsdp_rec["kimi"]["k4"].get("flash_attention_tc", 0)
        print(f"  phase 19 in {time.perf_counter() - t19:.1f} s", flush=True)
        phase(PHASE20)
        t20 = time.perf_counter()
        _, bf16_by_path["llama_stages_cut"] = stages_cut_phase(rt, card)
        print(f"  phase 20 in {time.perf_counter() - t20:.1f} s", flush=True)
        phase(PHASE21)
        torch.cuda.empty_cache()
        dryrun_phase(rt, dev, card)
        launches["flash_attention_tc"] = sum(k4_tc_by_path.values())
        for counts in by_path.values():
            for name, n in counts.items():
                launches[name] += n

    phase("timing: one round's flat ResNet-56 stacks, 20 clients")
    times = time_kernels(rt, resnet_layout, 20, bw, peak, dev)
    phase("timing: gmf_select's |z| mode on the Shakespeare, downlink and adaptive paths")
    select_paths = time_select_paths(rt, [
        ("Shakespeare round (10 clients), per-row keep table", lstm_layout, 10, True),
        ("Shakespeare round (10 clients), shared counts (dgc)", lstm_layout, 10, False),
        ("ResNet-56 round (20 clients), per-row keep table (adaptive)", resnet_layout, 20, True),
        ("ResNet-56 broadcast (the top-k downlink)", resnet_layout, 1, False)], bw, peak, dev)
    phase("timing: K4 at the serving shape")
    k4_times = time_k4(k4, ref, bw, peak, bf16_peak, dev)
    phase("timing: K4 at recurrentgemma-9b's and kimi-k2-1t-a32b's prefill shapes")
    k4_times.update(time_k4_new_dims(k4, ref, bw, bf16_peak, dev))
    torch.cuda.synchronize()

    rows = []
    for kid, name, replaces, _, _ in KERNELS:
        row = {"name": name, "id": kid, "route": "cuda", "source": PORT_SOURCE,
               "replaces": replaces, "launches": launches[name],
               "launches_by_path": {path: c[name] for path, c in by_path.items()},
               "max_abs_err": worst[name], **times[name], "library_ms": None}
        if name == "gmf_select":
            row.update(plan=plan_of(resnet_layout), k1_round_ms=times["k1_round_ms"])
            row["at_other_paths"] = select_paths
        rows.append(row)
    # K1-K3's bf16 instances: launches in the training paths' runs (phases 14
    # and 15), held and timed over llama3.2-1b's bf16 row in phase 2.
    replaces = {name: rep for _, name, rep, _, _ in KERNELS}
    for kid, name, inst, _, _, row_name in BF16_KERNELS:
        by = {path: c.get((name, inst), 0) for path, c in bf16_by_path.items()}
        rows.append({"name": row_name, "id": kid, "route": "cuda", "source": PORT_SOURCE,
                     "replaces": replaces[name], "instance": inst,
                     "launches": sum(by.values()), "launches_by_path": by,
                     "max_abs_err": bf16_worst[name], **bf16_times[row_name],
                     "library_ms": None})
        if row_name == "gmf_select_bf16":
            rows[-1].update(plan=plan_of(llama_lay),
                            at_abs_mode=bf16_times["gmf_select_abs_bf16"])
    # gmf_select's group mode: its launches in phase 18 (b)'s gmf_data run
    # (both ranks), held bitwise against the single launch at a group of one
    # in (a) and over the two ranks in (b) (and there against its plain
    # version), its largest difference from both; timed over llama3.2-1b's
    # bf16 row in phase 18 (a).
    if tp_times:
        rows.append({"name": "gmf_select_group", "id": "K1", "route": "cuda",
                     "source": PORT_SOURCE, "replaces": replaces["gmf_select"],
                     "instance": "group:bf16,bf16",
                     "launches": sum(bf16_by_path.get(p, {}).get(
                         ("gmf_select", "group:bf16,bf16"), 0) for p in GROUP_PATHS),
                     "launches_by_path": {p: bf16_by_path.get(p, {}).get(
                         ("gmf_select", "group:bf16,bf16"), 0) for p in GROUP_PATHS},
                     "launches_in": "phase 18 (b): llama3.2-1b gmf_data at mesh (1, 2), both "
                                    "ranks; phase 19 (b): llama3.2-1b (2 layers) gmf_pod at "
                                    "(1, 2, 1) under FSDP, rank 0; phase 20 (b): llama3.2-1b "
                                    "(2 layers), the fused configurations at (1, 2) and "
                                    "(1, 2, 1), both ranks",
                     "abs_mode_launches": sum(bf16_by_path.get(p, {}).get(
                         ("gmf_select", "group:abs:bf16"), 0) for p in GROUP_PATHS),
                     "max_abs_err": tp_times["max_abs_err"],
                     **{k: tp_times[k] for k in ("ms", "bound_ms", "bound_by", "at")},
                     "plain_ms": tp_times["plain_ms"], "library_ms": None,
                     "single_launch_ms": tp_times["single_ms"],
                     "device_ms": tp_times["device_ms"], "paths": tp_times["paths"],
                     "launches_a_call": GROUP_STEPS, "all_reduces_a_call": GROUP_ALL_REDUCES,
                     "over_a_data_group": fsdp_rec.get("group_pod"),
                     "abs_mode": {"ms": tp_times["abs_ms"],
                                  "single_launch_ms": tp_times["abs_single_ms"],
                                  "device_ms": tp_times["abs_device_ms"],
                                  "paths": tp_times["abs_paths"]},
                     "resnet56_round": tp_times["resnet56"],
                     "full_read_inputs": tp_times["full_read_inputs"]})
    # K4's tensor-core kernel launches in the bf16 serving run (phase 5); its
    # CUDA-core kernel serves float32 and D 16/32, and its launches and times
    # are those of phase 6's float32 prefill.
    for kern, source, run in (("tc", K4_TC_SOURCE, "phase 5: bf16 serving, run_fixed; phase "
                                                    "16: the engine's float32-codec run, a "
                                                    "prefill per request; phase 17: "
                                                    "granite-moe's run_fixed through moe_ep"),
                              ("cc", K4_SOURCE, "phase 6: float32 prefills of llama3.2-1b, "
                                                 "the families and kimi-k2's D 112")):
        rows.append({"name": f"flash_attention_{kern}", "id": "K4", "route": "cuda",
                     "source": source, "replaces": K4_REPLACES,
                     "launches": launches[f"flash_attention_{kern}"], "launches_in": run,
                     "launches_in_phase13": {arch: c[f"flash_attention_{kern}"]
                                             for arch, c in served_k4.items()
                                             if c[f"flash_attention_{kern}"]},
                     "max_abs_err": k4_worst[kern], **k4_times[kern]})
        if kern == "tc":
            rows[-1]["launches_by_path"] = dict(k4_tc_by_path)
    # The tensor-core kernel at D 256 and 112: its launches in phase 13's
    # measured run of the config that has that head dim; "cc_ms" is the
    # CUDA-core kernel (where these inputs went before) on the same inputs;
    # "ptxas" the compiler's report of the instance.
    for key, (arch, *_, d) in K4_NEW_DIMS.items():
        rows.append({"name": f"flash_attention_{key}", "id": "K4", "route": "cuda",
                     "source": K4_TC_SOURCE, "replaces": K4_REPLACES,
                     "launches": served_k4.get(arch, {}).get("flash_attention_tc", 0),
                     "launches_in": f"phase 13: {arch}, run_fixed (bf16)",
                     "max_abs_err": k4_worst[key], **k4_times[key],
                     "ptxas": tc_ptxas.get(d)})
    phase("results")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


def _resnet56_params(dev):
    from repro_torch.models import resnet

    return resnet.init_resnet(torch.Generator().manual_seed(0), depth=56, device=dev)


def _lstm_params(dev):
    from repro_torch.data.synthetic import VOCAB
    from repro_torch.models import lstm

    return lstm.init_lstm(torch.Generator().manual_seed(0), vocab=VOCAB, device=dev)


if __name__ == "__main__":
    main()
