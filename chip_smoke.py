#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds the port's kernels from ``src/repro_torch/kernels/csrc``
(into ``build/repro_torch/``), holds each kernel against its plain PyTorch
version at the main path's shapes, times it, and then drives the training
main path at full width -- the paper's CIFAR-10 CNN (McMahan et al.:
conv5x5x32, pool, conv5x5x64, pool, fc512, fc10; N = 2,156,490 float32
parameters) over 10 groups x 10 clients at batch 50, on synthetic data of
CIFAR-10's 32x32x3 shape -- uncompressed at full participation, with
compressed uploads, under partial participation, under faults, with
async group rounds, with virtual client populations, through
checkpoints, on the multilevel backend over a 4 x 5 x 5 tree, and
through the reference's low-level surface (``make_global_round``,
``make_round_step``, SCAFFOLD, the optimizers). Depth is cut: E = 2
group rounds of H = 5 local steps, 1 or 2 global rounds per path. The
serving phases serve qwen3-14b, rwkv6-1.6b, qwen2.5-32b, gemma3-27b,
hymba-1.5b, granite-moe-1b-a400m, whisper-medium (with its stub frames)
and internvl2-26b (with its stub patches) at their full widths and depths.
After them it trains glm4-9b
at full width (depth 2 of 40) on the sharded backend, plain, with compressed uploads, under partial
participation, under faults, with async group rounds and with a virtual
client population; rwkv6-1.6b at full width and full depth (24
layers), through the scan's backward kernel; and granite-moe-1b-a400m at
full width and full depth (24 layers), through the moe dispatch kernels;
hymba-1.5b at full width and full depth (32 layers), through the
selective scan's forward and backward kernels; and whisper-medium at full
width and full depth (24 encoder and 24 decoder layers) with its frames in
every sample. The tree variants of the last three ((v2), (w2), (y2)) run 4
layers, so that the script stays under 1,000 s. Path (i)'s round also runs
on ``torch.distributed`` meshes of the one card (phase (mesh)), and
mixtral-8x22b serves and takes its loss and backward at full width with 2
of its 56 layers (phase (mx)).
The CNN's learning rate is 0.01: at 0.1 the loss of this CNN on the
synthetic images spikes into the thousands and then settles at chance (ln
10) in both packages
(``tests/test_torch_driver.py::test_cifar_cnn_loss_spike_tracks_reference``).

Phases (any failure raises, so the script exits non-zero and prints no
final line):
 1. device line (``nvidia-smi`` name and power limit) and kernel build:
    registers and spills of every kernel (``nvcc -Xptxas -v``; the
    backward's wgmma kernels and the selective scan must not spill), the
    dynamic shared memory of
    the LM kernels, and the HGMMA (wgmma) and UTMALDG (TMA load)
    instructions in the built forward and backward flash libraries
    (``cuobjdump -sass``), both required to be present, and the HMMA
    (mma.sync) and LDGSTS (cp.async) instructions of the scan backward's
    library, a tensor-core and an asynchronous-load instruction required,
    and the LDGSTS and MUFU.EX2 instructions of the selective scan's two
    libraries, both required in each;
 2. kernels against their plain versions on the card: bit-exact in
    float32 at [10, 10, 2156490] (unmasked and masked) and on every CNN
    leaf shape; bfloat16 within one bfloat16 ulp; a ragged N; NaN rows;
    then kernel, plain and bound times;
 3. main path, flat layout + fused step: build -> pack_arrays -> fit for 2
    rounds with an eval; ``mtgc_update_flat`` must launch E * H * rounds
    times; then one more round timed, and one traced with
    ``torch.profiler`` (device busy share; device time by stream, and by
    kernel as a share of the busy time);
 4. tree layout + fused step, one round; ``mtgc_update`` must launch
    E * H * 8 (leaves) times;
 5. fused against unfused, one round from the same state and batches;
 6. the quantize kernels (``int8_roundtrip``, ``topk_mask``) against their
    plain versions, bit for bit (NaN for NaN), at the client link's
    [100, 2156490] and the group link's [10, 2156490] in float32, a ragged
    N in bfloat16, and rows of zeros, +-Inf and NaN; then times, and the
    time of the top-k threshold (``torch.topk``) the engine takes outside
    the kernel;
 7. compressed main path, flat + fused, int8 on both links with error
    feedback (the fig7 plan ``mtgc_int8_ef``), 2 rounds through ``fit``:
    ``int8_roundtrip`` must launch rounds * (E + 1) times, ``comm_bytes``
    must equal the wire model, the residuals must be finite and not all
    zero; then one round timed, and peak memory;
 8. the compressed round fused against unfused, from one state with the
    same injected draws, deterministic cuDNN: params and both residuals
    bit-identical;
 9. partial participation (fig7's ``mtgc_topk_ef``: top-k client link,
    bf16 group link, at client_participation 0.5, fixed, inverse_prob),
    one round through ``fit``: ``topk_mask`` launches E times,
    ``mtgc_update_flat`` E * H times with a mask, frozen replicas keep
    their bits, ``comm_bytes`` counts E * 50 client uploads and the active
    groups;
10. tree + fused with int8 on both links, one round: ``int8_roundtrip``
    launches 8 * E + 8 times (8 CNN leaves);
10b. phase (m), HFL under faults on the simulator engine, the CNN path of
    phase 3: one fixed fault realization (crash 0.05, timeout 0.1, corrupt
    0.2 over 4 rounds, drawn on the host from ``FAULT_SEED`` and injected
    through ``RoundDraws``), ``fit`` in chunks of 2: undefended NaN uploads
    (the state must turn non-finite), defended by the non-finite screen and
    guarded (finite, ``screened`` equal to E times the corrupted uploads),
    the same unguarded (timed), and int8 on both links with error feedback
    under exploded uploads, the norm screen and the clip; ``mtgc_update_flat``
    held against its plain version on every tenth call's own operands (NaN
    positions, not payload bits; frozen rows keep x's bits) and every
    crashed replica's params and z held to their bits across its round;
    then a forced rollback (every upload NaN, undefended: the guard raises
    after 2 retries and every retry starts from the snapshot's bits) and
    the guard's zero-fault overhead (guarded against unguarded rounds, in
    turns);
10c. phase (o), async group rounds on the simulator engine, the CNN path
    with group 9 at one group round to the others' two (it reports every
    second window): (o1) flat + fused, delay-compensated, 4 windows through
    ``fit`` in chunks of 2 -- every ``mtgc_update_flat`` launch masked
    (``em x cmask``), every tenth held bit for bit against its plain
    version on its own operands, group 9's rows kept through each step of
    its idle iteration, its z (and params, in a window it does not report)
    kept through the masked mean, its ``snap`` changed only at windows 1
    and 3, ``global_model`` = group 0's replica; then two windows timed
    against (a) and the peak; (o2) tree + fused, discount, one window:
    ``mtgc_update`` once per leaf per step; (o3) flat + fused, naive, a
    timeout injected in each of two windows: ``dl`` = ``rep x any_obs`` and
    the timed-out group's y kept;
10d. phases (r) and (t), the CNN path (a) with virtual client
    populations and checkpoints: (r0) population 10 = K, 2 rounds in
    chunks of 1, bit for bit (a)'s from the same state and shard ids, the
    store the final z; (r1) population 100 a group (an 8.63 GB float32
    store), 4 rounds in chunks of 1 with injected cohorts, overlapped and
    sequential bit for bit in state and store, clients that sat out keeping
    their rows' bits; then (a), (r1) overlapped and sequential, (r2)
    population 50 and (a) again timed in turns (4 rounds each), the store's
    host steps apart, one cohort's copies alone (gather, page-locked H2D
    and D2H, scatter) and the page-locking, and the device peaks ((r)'s
    within 0.01 GB of (a)'s); (r3) ``client_state="stateless"``, 2 rounds:
    no store, z zero at each round's start; (r4) the tree layout at
    population 100, 2 rounds: ``mtgc_update`` once per leaf per step, the
    last cohort's store rows the final z. (t) ``fit(checkpoint_every=2)``
    over 4 rounds into a temp directory (its free space printed first;
    under 12 GB fails), the round-4 files deleted, ``resume=True`` bit for
    bit the uninterrupted state; ``{"state", "population"}`` at population
    20 a group saved, restored and continued 2 rounds bit for bit the
    original continuation; file bytes, save and restore seconds. Every
    bit-for-bit comparison between two card runs under deterministic cuDNN;
10e. phase (u), the multilevel backend (Appendix E) on the same CNN over
    fig11's 4 x 5 x 5 tree at periods (8, 4, 2) (``phase_multilevel_hfl``):
    (u1) tree and (u2) flat at full participation, (u3) tree at
    ``level_participation=(1.0, 0.8, 0.6)`` with inverse_prob weighting,
    each 2 warm-up rounds, 3 timed and one traced: no kernel launched,
    the leaves equal and the corrections summing to zero over the children
    (u1), a round on the card against the CPU (u1), flat against tree (u2),
    frozen subtrees' bits (u3), round ms and peaks;
10f. phase (ls), the reference's low-level surface on path (a)
    (``phase_low_level_surface``): (ls1) ``make_global_round`` on
    ``hfl_init``'s flat state (fused), driven by ``make_round_step`` for 2
    rounds, bit for bit ``run_rounds``' state and losses on the same shard
    ids (deterministic cuDNN), ``mtgc_update_flat`` E * H times a round;
    (ls2) one tree + fused round on (ls1)'s first ids within 1e-5 of max|x|
    of (ls1)'s first, ``mtgc_update`` E * H * 8 times; (ls3)
    ``bench_round.py``'s host loop: ``sample_round_batches`` on the host,
    the upload, one round and the streaming ``accuracy``, each timed, and
    the host's share; (ls4) MTGC at G = 1, E = 1 with the gradient init
    (flat + fused) against ``make_scaffold_round`` option I, 3 rounds of 10
    clients, within 1e-4 of max|x|; (ls5) ``resnet_gn(100, (32, 32, 3))``
    and ``lstm(64)`` (``make_language`` sequences of 80 tokens): per-client
    losses and gradients under ``vmap`` over 2 x 5 clients at batch 16, card
    against CPU within 1e-4 of the largest entry; (ls6) ten ``sgd``
    (momentum) and ``adamw`` (warmup + cosine) steps over the CNN's tree,
    card against CPU: sgd within one ulp of each entry, adamw within one ulp
    of each leaf's largest entry a step (the CPU's float32 ``sqrt`` is not
    correctly rounded);
11. the port on the card against the port on the CPU (the kernels' plain
    versions) on a small input: the uncompressed round, a compressed round
    under partial participation with injected draws, and two async windows
    (group_rounds (2, 1), delay-compensated);
12. the LM kernels (``flash_attention``, ``rwkv6_scan``) against their plain
    versions on the card: at the serving shapes (q [4, 2048, 40, 128]
    against a [4, 2080, 8, 128] cache, causal; the scan at B = 4,
    T = 2048, H = 32, Dh = 64, C = 64 from a nonzero state) in float32 (5e-5
    abs for attention, rtol/atol 1e-4 for the scan) and in bfloat16 (the
    tensor-core attention within half a bfloat16 ulp plus 5e-5 of the plain
    version in float32 on the same inputs), and at small ragged shapes in
    both dtypes (GQA, MQA, a window that is not tile-aligned,
    ``q_offset > 0``, S and T not multiples of the tile or chunk), and in
    bfloat16 at (f5)'s and (f6)'s prefill shapes (q [4, 416, 16, 64]
    against a [4, 448, 16, 64] cache, MHA; q [4, 2304, 48, 128] against a
    [4, 2336, 8, 128] cache), within half an ulp plus 5e-5; then
    a strong-decay scan (logw in [-20, -5]) at the serving shape against
    ``rwkv6_chunk_parallel_ref`` (the kernel's arithmetic in PyTorch; the
    plain version's chunk-wide sums lose more than the tolerance there);
    then kernel, plain, bound (and the kernel's share of it) and, for
    attention, ``scaled_dot_product_attention`` times, and a trace of
    three calls of each kernel (the scan's three launches apart); the
    flash forward at the windowed serving shapes (gemma3-27b's local layers:
    q [4, 2048, 32, 128], kv 16 heads; hymba-1.5b: q [4, 2048, 25, 64], kv
    5 heads; window 1024) within half a bf16 ulp plus 5e-5, timed against
    its plain version, its bound from the live pairs under the window and
    SDPA with the window's boolean mask; ``selective_scan``
    (``csrc/ssm_scan.cu``) against ``selective_scan_ref`` at hymba's
    prefill shape (u [4, 2048, 3200] in bf16 and float32, S = 16) and at
    ragged shapes (T 1, 37, 2049; Di 37, 33; S 5; weak decays), every case
    from a nonzero state, within 1e-5 of max|y| and max|h|; at hymba's
    training shape (u [1, 2048, 3200]) likewise, and with its chunk-start
    states (the same y and final state bit for bit; each state within 1e-5
    of max|h| of the plain loop's h at its token); a second call bit for
    bit; kernel, plain and bound times (the SFU's floor for the
    exponentials beside the bound) and a trace of 100 calls; at the
    training shape the kernel also from a CUDA graph over operand sets that
    do not fit in L2;
12b. the scan's backward (``csrc/rwkv6_scan_bwd.cu``, four launches) at
    rwkv6-1.6b's training shape (r/k/v [1, 2048, 32, 64], C = 64) on the
    forward kernel's saved chunk states, bf16 and float32, no final-state
    gradient (training's case), against ``rwkv6_scan_bwd_ref`` within 5e-6
    of each gradient's largest entry (dlogw 2e-5; bf16 dr/dk/dv one bf16
    ulp more); T = 1100 with a nonzero final-state gradient and state
    likewise; logw down to -20 against the float64 definition of the
    gradients (kernel and plain version, half an ulp for bf16); every case
    called twice, bit for bit; then kernel, plain and bound times, and in
    the log line alone (reckoned, not measured) the float32-operations
    time, the bytes the design's four passes move and its products' time
    in 3xTF32 at the TF32 peak; each pass's resident blocks an SM (C' must
    keep two in bf16) and traced time, the forward at this shape, registers
    and spills (none allowed), the library's tag, flags and the ``nvcc
    --version`` that built it, and a trace of 200 calls by kernel;
12c. the moe family's dispatch (``moe_gather``), combine (``moe_combine``)
    and gate gradient (``moe_gate_grad``; ``csrc/moe_dispatch.cu``) against
    the reference's one-hot einsums at granite-moe-1b-a400m's training
    shape (S 2048, k 8, E 32, C 640, D 1024), serving's prefill (S 8192, C
    2560) and decode (S 4, C 4) shapes, a ragged shape with heavy drops (S
    300, C 40) and the scalar path (D 100, k 3), bf16 and float32: dispatch
    bit for bit, the combine and the gate gradient within a float32
    rounding a term of the sum of magnitudes plus one rounding of the
    output, a second call bit for bit, no spills; each launch's grid and
    warps an SM; kernel, bound and one-call library (``index_select``,
    ``embedding_bag``) times at the three shapes, each from a CUDA graph of
    calls over operand sets that do not fit in L2 (``graph_ms``, the
    kernels line's ``graph_ms``; ``ms`` the wrappers called eagerly, as for
    every kernel), plain times at the training shape;
12d. the selective scan's backward (``csrc/ssm_scan_bwd.cu``, four
    launches: carry pass, fold, chunk pass, reduction) on the forward
    kernel's chunk states at hymba's training shape, bf16 and float32, each
    with and without a final-state gradient, and at ragged shapes (a partial
    block of chains, a ragged last chunk, S 5, strong and weak decays, T 1,
    64, 65 and 4096), from nonzero states, against ``selective_scan_bwd_ref``:
    each gradient within 1e-5 of its largest entry, the sums over channels
    or tokens (dB, dC, dlog_a, dd_skip) within 1e-5 of the largest sum of
    their terms' magnitudes, a bf16 du one bf16 ulp more; every case called
    twice, bit for bit; kernel (eager and from a CUDA graph over operands in
    HBM), plain and bound times (the bound and the SFU's floor from what the
    gradients need; the bytes and ex2 of the design's passes reckoned in the
    log), each kernel's traced time, grid, blocks an SM, shared memory,
    registers and spills (none);
13. LM serving at full width through ``repro_torch.launch.serve.generate``:
    qwen3-14b (40 layers, d 5120, bf16, 14.77 B params), rwkv6-1.6b (24
    layers, d 2048), qwen2.5-32b (64 layers, 32.76 B params, QKV bias),
    gemma3-27b (62 layers, 27.01 B params, 52 layers at window 1024 and 10
    global, tied 262,144-token embedding), hymba-1.5b (32 layers of
    windowed attention and the selective SSM in parallel) and (f4)
    granite-moe-1b-a400m (24 layers, 32 experts, top 8; 1.386 B params),
    each from random params (seed 0), 4 prompts of 2048 tokens, 32
    generated tokens: in the prefill ``flash_attention`` must launch once a
    layer (40, 64, 62, 32, 24), ``rwkv6_scan`` 72 times (three kernels a
    layer) and ``selective_scan`` 32 times on hymba, and none of them in
    decode; granite's ``moe_gather`` and ``moe_combine`` once a layer in
    the prefill (8192 tokens: capacity 2560) and in each decode step
    (dropless), 768 each in all; finite logits, tokens in
    range; init s, prefill ms, decode ms per step, tokens/s, the peak and
    the memory held before the phase, busy shares and traces. Then (f5)
    whisper-medium (24 + 24 layers, d 1024, 1.015 B params): 4 requests of
    1500 stub frames, a 416-token prompt and 32 generated (448 positions,
    its text context), the encoder run once at admission and timed apart,
    its output the ``memory`` of the prefill and of every decode step;
    flash once a decoder layer in the prefill (24; the encoder and the
    cross-attention are plain products, as the reference's); and (f6)
    internvl2-26b (48 layers, d 6144, 19.93 B params): 4 requests of 256
    stub patch embeddings (width 3200, through the projector) before 2048
    prompt tokens, 32 generated, the cache at 2336 positions; flash 48;
14. reduced qwen3-14b, rwkv6-1.6b, qwen2.5-32b, gemma3-27b (7 layers: one
    global), hymba-1.5b and granite-moe-1b-a400m (float32) from the same
    params on the card and
    on the CPU: prefill logits within rtol/atol 1e-4, 8 greedy tokens
    equal;
15. the attention backward at glm4-9b's training shape (q [1, 2048, 32,
    128], k/v [1, 2048, 2, 128], causal) in float32 and bfloat16, and in
    bfloat16 at whisper's (q, k/v [1, 2048, 16, 64], MHA) and internvl2's
    (q [1, 2304, 48, 128], k/v [1, 2304, 8, 128]): dq, dk,
    dv against ``flash_attention_bwd_ref`` within 1e-5 of each gradient's
    largest entry (bf16: beyond the outputs' own half-ulp rounding), the
    forward's output within 5e-5 (bf16: plus half an ulp) and its row
    statistics m and l within 1e-5; a second backward call bit-identical
    to the first; the autograd ``FlashAttention`` on the card against the
    CPU at [1, 300, 8, 64]; then kernel, plain, bound and
    ``scaled_dot_product_attention``'s backward times, a trace of three
    calls with each launch's time, and the forward at this shape with the
    statistics off and on;
16. LM training, tree + fused (phase (h)): glm4-9b at its published
    widths with 2 of its 40 layers (bf16, remat, random params from seed
    0), ``ExperimentSpec(backend="sharded", levels=(2, 2))``, E = H = A = 2,
    lr 0.05, tokens from ``make_lm_tokens`` (seed 0, 400,000) packed by
    ``pack_tokens`` at batch 1 x 2048 (every layer takes the flash path):
    a warm-up round; then ``mtgc_update_flat`` on the trained state itself
    (bf16, g_scale = 1/A, a random g, in place on a copy of x, with and
    without a mask that freezes a replica) against ``mtgc_update_flat_ref``
    bit for bit on column slices of every leaf, one of them past element
    2^31; then one round with the launch counts required equal to the
    reckoned ones (flash forward 2 x layers x replicas x microbatches x
    steps under remat, backward three kernels for each of those passes,
    ``mtgc_update_flat`` once per leaf per step), finite losses, round ms,
    training tokens/s, peak memory, and a traced round;
17. LM training, flat + fused (phase (i)): the same, ``mtgc_update_flat``
    once per step, its check on the one [2, 2, N] buffer (6.6e9 elements);
17a. phase (mesh), the sharded round on a ``torch.distributed`` mesh
    (``phase_mesh``): path (i)'s round from a fresh state, its spec, params,
    packed tokens and shard draws, through ``api.build(..., mesh=)`` and
    ``fit`` on (mesh1) a (group 2, client 1, fsdp 1, model 1) mesh and
    (mesh2) a (1, 2, 1, 1) mesh, two ranks each, started by this script
    (``chip_smoke.py --mesh-rank R ...``) on cuda:0 over a gloo group
    (NCCL refuses two ranks on one device), and (mesh3) a (1, 1, 1, 1) mesh
    of one NCCL rank in this process: each rank's rows of params and z and
    its groups' rows of y against (i)'s warm-up round by their float64
    sums and sums of squares (within 1e-5, plus 1e-6 / (H lr) an entry for
    z and 1e-6 / (H E lr) for y) and by the sums of their 16-bit patterns
    ((mesh3) must have every row's bits), the launches per rank (flash
    forward 2 x layers x the rank's replicas x A x E x H, backward three
    kernels a call, ``mtgc_update_flat`` once a step), round ms, the time in
    all-reduces (the device synchronized around each) and the peak per rank;
    then a reduced glm4 round (float32, T = 256) on each mesh entry by entry
    against one device's ((mesh3) bit for bit);
17b. phase (s), a virtual population on the sharded backend: the training
    of (i) at population 4 a group (3 when MemAvailable, printed first, is
    under 70 GB; a 26.4 GB bf16 store, two page-locked cohort buffers of
    13.2 GB, their locking timed alone), overlapped, 4 rounds in chunks of
    2 with two injected cohorts (printed): at the first round of the second
    chunk the installed z equals the second cohort's store rows bit for
    bit, and a first-cohort client the second cohort does not draw keeps
    its store bits; then 4 more rounds timed (the store's own draws,
    printed): each chunk's time, each host step, the launch counts of (i),
    the device peak within 0.5 GB of (i)'s, the host bytes. It runs before
    (n), whose 33 GB page-locked snapshot stays in PyTorch's host cache;
18-20. the same training with compressed uploads and partial
    participation (a warm-up round, a timed one and a traced one each):
    (j) flat, client link ``int8_stochastic`` with error feedback; (k) flat,
    client participation 0.5 (fixed masks, inverse_prob), uncompressed; (l)
    tree, participation 0.5 (fixed, realized-count weighting), group link
    top-k 0.01 with error feedback. The quantize kernels' launches are
    required equal to the reckoned ones (one per [K, piece] block of each
    group's client uploads a group round, one per [G, piece] block of the
    group reports a round; pieces of 2^26 columns), beside the flash and
    update counts; the warm-up round's own upload blocks (recorded column
    slices, many past element 2^31 of the flat state) held bit for bit
    against the plain versions (``int8_roundtrip`` and ``topk_mask``); the
    piecewise top-k threshold against ``torch.topk`` on a report row slice
    of 2^27 elements, both timed; ``comm_bytes`` equal to the wire model;
    the residuals finite and not all zero; under a mask, the frozen
    replicas' params and z with their bits; and (k)'s peak within 0.5 GB of
    (i)'s; on (l) each ``topk_mask`` launch of the warm-up round is timed
    again on its own block by CUDA events, against its per-block bound;
20b. phase (n), LM training under faults: the flat + fused training of
    (i) with the defense (non-finite screen, norm screen, clip) and the
    guard, one ``fit`` call a round with injected masks: a guarded warm-up
    round without faults (it allocates the guard's page-locked host
    buffers), then round 1 (client (1, 1) crashes, (0, 0) uploads an
    exploded delta) and round 2 (group 1 times out, (0, 1) uploads NaN):
    ``screened`` equal to the injected count, the crashed replica's params
    and z and the timed-out group's y kept to their bits, the launch counts
    of (i), a finite state (read in 2^26 pieces), round ms with and without
    the guard's snapshot, each round's peak memory, and a traced round;
20c. phases (p) and (q), async LM training: the training of (i) at
    ``group_rounds = (2, 1)`` -- (p) flat + fused, delay-compensated; (q)
    tree + fused, discount, client participation 0.5 (fixed masks,
    injected; inverse_prob) with a timeout of group 1 injected in the
    second window -- a warm-up window (t = 0: only group 0 reports), a timed
    one (t = 1: group 1's stale report is due) and a traced one: the launch
    counts of (i) (per-client gradients at the static shape, the idle
    replicas' updates masked), the frozen and timed-out rows' bits, ``dl``,
    ``snap``/``glob`` after the stale report, a finite state, the window
    time, the tokens of computed microbatches and the tokens that entered
    an update a second, and the peak;
21. a reduced glm4-9b (float32, remat) sharded round at T = 1100 on the
    card against the CPU (params within rtol 1e-4), two async windows
    (flat + fused, group_rounds (2, 1), delay-compensated) likewise, and the
    fused step against the unfused one on the card, bit for bit;
23. phase (v), ssm training: rwkv6-1.6b at its published widths and all 24
    layers (1.678 B params, bf16, remat, random params from seed 0),
    trained as (h)/(i) are (2 x 2 clients, E = H = A = 2, lr 0.05, 1 x 2048
    tokens a microbatch): (v1) flat + fused (two state buffers: bf16 and
    the float32 ``u``/``decay_base``), (v2) tree + fused at 4 layers; a
    warm-up and a timed round each, and a traced round of (v1) (the trace
    records the device alone: the round makes about 283,000 launches);
    launches required as reckoned (on (v1) ``rwkv6_scan`` 4608 and its
    backward 3072 over 768 layer passes, ``mtgc_update_flat`` 8; on (v2)
    over 128 passes, 76 leaf launches); finite
    losses and params, round ms, tokens/s, peak, busy share and the scan's
    shares; (v3) a reduced rwkv6 round (float32, remat, chunk 64, T = 1100)
    on the card against the CPU and fused against unfused, as phase 21;
24. phase (w), moe training: granite-moe-1b-a400m at its published widths
    and all 24 layers (1.386 B params, bf16, remat), trained as (v) is:
    (w1) flat + fused, (w2) tree + fused at 4 layers, a warm-up and a timed
    round each and a traced one (the device alone) of (w1); launches
    required as reckoned ((w1)'s 768 layer passes: ``moe_gather`` and
    ``moe_combine`` 2304 each -- two forwards and one backward a pass --,
    ``moe_gate_grad`` 768, flash 1536 forward and 2304 backward); (w3) a
    reduced granite round (float32,
    remat, T = 1100, capacity routing) on the card against the CPU and
    fused against unfused, as phase 21;
25. phase (y), hybrid training: hymba-1.5b at its published widths and all
    32 layers (d 1600, Di 3200, S 16, 25 / 5 heads of 64, window 1024; bf16,
    remat), trained as (v) is: (y1) flat + fused, (y2) tree + fused at 4
    layers, a warm-up and a timed round each and a traced one (the device
    alone) of (y1); launches required as reckoned ((y1)'s 1024 layer passes: the selective
    scan 2048 -- two forwards a pass --, its backward 4096 -- four kernels
    a pass --, flash 2048 forward and 3072 backward); (y3) a reduced hymba
    round (float32, remat, T = 1100: windowed flash and the selective scan
    forward and backward) on the card against the CPU and fused against
    unfused, as phase 21;
26. phase (z), audio training: whisper-medium at its published widths and
    all 24 + 24 layers (bf16, remat in the decoder, none in the encoder, as
    the reference's scan), trained as (v) is, ``pack_arrays`` carrying a
    stub frame embedding [1500, 1024] beside every sample's 2048 tokens:
    (z1) flat + fused, a warm-up, a timed and a traced round (the device
    alone), (z2) tree + fused, a warm-up and a timed round; launches
    required as reckoned (768 decoder layer passes: flash 1536 forward and
    2304 backward; ``mtgc_update_flat`` 4 on (z1)'s one bf16 buffer, 108 on
    (z2)'s 27 leaves); the encoder's gradient on one packed sample of the
    trained state finite and nonzero in every leaf;
27. phase (z3): a reduced whisper round (frames) and a reduced internvl2
    round (patches) on the card against the CPU and fused against unfused,
    as phase 21; the reduced models' loss and every gradient with the stub
    at 1100 text tokens, their prefill logits and 8 greedy tokens card
    against CPU; internvl2 at full width with 2 of its 48 layers (2.0 B
    params, bf16): the loss and backward with 256 patches before 2048
    tokens (flash q [1, 2304, 48, 128], k/v [1, 2304, 8, 128]), finite
    gradients, the projector's nonzero, the loss and every gradient against
    the same model's with the attention kernels' plain versions swapped in
    (VLM_LOSS_GAP of the loss, VLM_GRAD_GAP of each gradient's largest
    entry), its time and peak;
28. phase (mx), mixtral-8x22b at its published widths with 2 of its 56
    layers (5.41 B params, bf16): served through ``generate`` (4 prompts of
    8192 tokens, past its 4096-token window, and 32 generated: the flash
    forward once a layer in the prefill, the moe dispatch and combine once a
    routed chunk of 16384 tokens a layer in the prefill and once a layer a
    decode step), then its loss and backward at 1 x 8192 (remat; chunks of
    4096 tokens) with the kernels and again with the flash reference and
    the one-hot einsums swapped in, on the kernels' routing (each routing
    call replayed: the plain attention's rounding flips some tokens' top-2
    experts, a discrete choice, and the share it would flip is reported):
    the loss and every gradient within MX_LOSS_GAP and MX_GRAD_GAP of
    theirs, every gradient finite and nonzero, the launches as reckoned,
    times and peaks;
29. phase (audit): right after the build (1b, ``phase_audit_matrix``)
    ``launch/audit.py``'s 17 cases on the card -- every invariant, the
    counted FLOPs, bytes and collective bytes equal to the CPU's stamp
    (``budgets.check_route``), each case's kernel launches three ways,
    wrapper by wrapper (the wrappers' calls and launches,
    ``torch.profiler``'s kernels), equal to its expected calls, no host
    sync outside the known table --; after (mx) (``phase_audit``) the dry
    run's cost counter on ``meta`` over path (i)'s round and (f)'s prefill:
    counted FLOPs and bytes beside the measured ms and each roofline term's
    share, (i)'s state bytes equal to the card's, and the live-bytes
    tracker's peak beside (i)'s ``max_memory_allocated``. Every kernel
    phase's bound comes from its kernel module's ``cost(...)``, held to the
    phase's own reckoning;
22. a JSON line of the serving and training runs, one per phase of 18-20,
    (n), (p), (q) and (s), one of (m), one of (o), one of (r), one of (t),
    one of (u), one each of (v1), (v2), (v3), (w1), (w2), (w3), (y1), (y2),
    (y3), (z1), (z2) and (z3), one of (ls), one of (mesh), one of (mx), one
    of (audit), and one per kernel, then
    ``{"ok": true,
    "device": {...}}`` last.

TF32 is switched off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``) for the whole run, so every
float32 convolution and product runs in full float32 as the comparisons
assume. The script needs one card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, TF32 tensor cores, dense
FLOPS_PER_ELEMENT = 5          # g*gs, +z, +y, lr*d, x-...
INT8_FLOPS = 6                 # u/s, +noise, floor, two clip compares, q*s
TOPK_FLOPS = 2                 # |u|, compare
TOPK_FRAC = 0.1
E, H, ROUNDS, GROUPS, CLIENTS, BATCH = 2, 5, 2, 10, 10, 50
IMAGE = (32, 32, 3)
LR = 0.01
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32      # the serving traffic of phase 13
# Phase 13's archs after qwen3-14b and rwkv6-1.6b: the windowed dense archs
# and the hybrid one (window 1024: gemma3's local layers, all of hymba's).
WINDOW, HYMBA_DI, HYMBA_S = 1024, 3200, 16
# LM training (phases 15-17): glm4-9b at full width, 2 of its 40 layers, the
# reference trainer's 2 x 2 clients and lr, E = H = A = 2, 1 x 2048 tokens a
# microbatch (every layer takes the flash path: T > 1024).
LM_TRAIN_ARCH, LM_TRAIN_LAYERS, LM_TRAIN_LEVELS, LM_TRAIN_LR = "glm4-9b", 2, (2, 2), 0.05
LM_TRAIN_E, LM_TRAIN_H, LM_TRAIN_A = 2, 2, 2
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_TOKENS = 1, 2048, 400_000
# Phase (v): rwkv6-1.6b at its published widths and full depth (24 layers),
# trained as glm4-9b is above.
SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS = "rwkv6-1.6b", 24
# Phases (f4) and (w): granite-moe-1b-a400m at its published widths and full
# depth, served at phase 13's traffic and trained as rwkv6-1.6b is; its
# dispatch kernels are held at the training shape (one microbatch's tokens).
MOE_ARCH, MOE_LAYERS, MOE_TRAIN_TOKENS = "granite-moe-1b-a400m", 24, LM_TRAIN_BATCH * LM_TRAIN_SEQ
# Phase (y): hymba-1.5b at its published widths and full depth (32 layers),
# trained as rwkv6-1.6b is; its selective scan and the scan's backward are
# held at the training shape (one microbatch's tokens).
HYBRID_TRAIN_ARCH, HYBRID_TRAIN_LAYERS = "hymba-1.5b", 32
# The tree variants (v2), (w2) and (y2) run 4 layers (their flat variants
# keep full depth), so that the script stays under 1,000 s with (f5)-(z3).
TREE_VARIANT_LAYERS = 4
# (f5), (z): whisper-medium served (a 416-token prompt and 32 generated: its
# 448-position text context; 1500 stub frames a request, encoded once at
# admission) and trained at full width and depth (24 + 24 layers) with its
# frames in every sample. (f6), (z3): internvl2-26b served at full width and
# all 48 layers (256 stub patch embeddings before 2048 prompt tokens), and
# its loss and backward at full width with 2 of the 48 layers.
AUDIO_ARCH, AUDIO_LAYERS, AUDIO_PROMPT = "whisper-medium", 24, 416
# whisper's params tree: 14 stacked decoder leaves (3 norms, self- and
# cross-attention's 8 matrices, 3 of the MLP), 9 stacked encoder leaves,
# embed, unembed, ln_f and enc_pos.
AUDIO_LEAVES = 27
VLM_ARCH, VLM_LAYERS, VLM_LOSS_LAYERS = "internvl2-26b", 48, 2
# (z3)'s full-width internvl2 loss and gradients with the attention kernels
# against the same bf16 model with their plain versions: relative gap of the
# loss, and each gradient's largest gap over its largest entry. Read on an
# H100 at 6.3e-6 and 0.0115 at worst (the unembedding's; bf16 roundings,
# 1-2 ulps of the largest entry); the limits are 8 and 4 times that.
VLM_LOSS_GAP, VLM_GRAD_GAP = 5e-5, 5e-2
# The special-function unit's 2^x: 16 results a clock on each of the H100
# SXM's 132 SMs (the CUDA programming guide's throughput table for compute
# capability 9.0) at its 1.98 GHz boost clock, as tools/sfu_rate.cu measures
# it (4.185e12 a second); the selective scan forms one decay a (b, t, di, s)
# on it, its backward two.
SFU_EXP2_PER_S = 16 * 132 * 1.98e9
# Phases 19-21 ((j)-(l)): the same training, with compressed uploads and
# partial participation (client_participation 0.5, fixed masks); top-k keeps
# 1% of a row. Recorded column slices of an upload block are 2^16 wide.
LM_TRAIN_PARTIAL, LM_TRAIN_TOPK_FRAC, UPLOAD_SPAN = 0.5, 0.01, 1 << 16


def log(*args):
    print(*args, flush=True)


def kernel_names(wrapper: str) -> tuple:
    """The ``__global__`` functions ``wrapper`` launches, in launch order
    (``kernels/ops.py::KERNEL_NAMES``): the scan backward's four passes A',
    B', C', D', the selective scan backward's carry, fold, chunk and
    reduction kernels."""
    from repro_torch.kernels import ops

    return ops.KERNEL_NAMES[wrapper]


def cost_bound(cost, old_bytes: float, old_flops: float, peak: float, what: str) -> dict:
    """A kernel's bound from its module's ``cost(...)`` (FLOPs, bytes), held
    to the phase's own reckoning of the same work (within 1e-4: the cost
    counts every operand, the reckoning left out a few bytes of u in the
    RWKV scan)."""
    flops, nbytes = cost
    require(abs(nbytes - old_bytes) <= 1e-4 * old_bytes
            and abs(flops - old_flops) <= 1e-4 * max(old_flops, 1.0),
            f"{what}: cost(...) gives {flops} FLOP, {nbytes} bytes; the phase reckons "
            f"{old_flops} FLOP, {old_bytes} bytes")
    b, by = bound_ms(nbytes, flops, peak)
    return {"bound_ms": b, "bound_by": by, "bytes": nbytes, "flops": flops}


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean milliseconds per call over ``iters`` calls, timed with CUDA
    events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def l2_bytes(torch) -> int:
    """The card's L2 cache in bytes (50 MiB on an H100 SXM)."""
    return int(getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 * 2 ** 20))


def cold_copies(torch, tensors: tuple, nbytes: int) -> list:
    """``tensors`` and enough clones of them that one call on each set, of
    ``nbytes`` bytes a call, moves at least four times the L2 cache: timed
    in turns (``graph_ms``), each call finds its operands in HBM."""
    n = max(2, -(-4 * l2_bytes(torch) // max(int(nbytes), 1)))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def graph_ms(torch, fns, iters=50, replays=4) -> float:
    """Mean device milliseconds per call from a CUDA graph: the callables
    ``fns`` called in turn, at least ``iters`` calls (whole turns) captured
    after one warm-up turn, the graph replayed ``replays`` times between
    CUDA events. No host work runs between the launches, so a kernel of a
    few microseconds is timed by the card and not by the host's dispatch of
    its wrapper. Each call's result is held until its callable runs again,
    so no output buffer is written twice in a turn. With each callable on
    its own operands and a turn that moves several times the L2 cache
    (``cold_copies``), every call reads its inputs from HBM and its writes
    reach HBM; a single callable on the same operands finds them in L2 as
    far as they fit, and can run faster than HBM allows."""
    n = len(fns)
    calls = n * -(-iters // n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    held = [None] * n
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            held[i % n] = fns[i % n]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph, held
    return start.elapsed_time(end) / (calls * replays)


def timed(torch, kernel, plain, iters=20, plain_iters=20) -> dict:
    """Kernel and plain times in turns (kernel, plain, plain, kernel); each
    is the mean of its two readings, and the spread of the kernel's two is
    kept beside it."""
    warm = min(3, iters)
    k1 = cuda_ms(torch, kernel, iters, warm)
    p1 = cuda_ms(torch, plain, plain_iters, min(3, plain_iters))
    p2 = cuda_ms(torch, plain, plain_iters, min(3, plain_iters))
    k2 = cuda_ms(torch, kernel, iters, warm)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "ms_readings": [k1, k2],
            "plain_ms_readings": [p1, p2]}


def bound_ms(nbytes: int, flops: float, peak: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs ``flops`` over the
    ``peak`` rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_entries(text: str) -> list:
    """(kernel, registers, spills) for each entry function in ``nvcc -Xptxas
    -v`` output, the name demangled by ``c++filt`` where the host has it."""
    out, entry, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("info    :")[-1].strip()
            out.append((entry, regs, spills))
            entry = None
    names = [e for e, _, _ in out]
    try:
        dem = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=30, check=True).stdout.splitlines()
        if len(dem) == len(names):
            names = [d.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                     for d in dem]
    except (OSError, subprocess.SubprocessError):
        pass
    return [(n, r, s) for n, (_, r, s) in zip(names, out)]


def sass_counts(path: Path, build) -> dict:
    """Counts of HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA load) and
    LDGSTS (cp.async) instructions in a built library's SASS."""
    sass = sass_text(path, build)
    return {op: sum(1 for line in sass.splitlines() if op in line)
            for op in ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")}


def sass_text(path: Path, build) -> str:
    """A built library's SASS, from ``cuobjdump -sass`` of the toolkit that
    built it (else the one Triton ships)."""
    tools = [Path(build.nvcc_path()).parent / "cuobjdump"]
    try:
        import triton
        tools.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    tool = next((t for t in tools if t.is_file()), None)
    require(tool is not None, f"no cuobjdump found (looked at {[str(t) for t in tools]})")
    return subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def log_kernel_resources(build, logs: dict) -> None:
    """Registers at launch, spills (ptxas) and dynamic shared memory of the
    LM kernels as launched on the main path, the wgmma/TMA instructions in
    the two flash libraries (both counts must be > 0; the backward's wgmma
    kernels must not spill), and the scan backward's resident blocks an SM
    per pass and its tensor-core (HMMA or HGMMA) and asynchronous-load
    (LDGSTS or UTMALDG) instructions, both required; the selective scan's
    kernels must not spill (``logs``: the build's ptxas output, empty for a
    library that was already built)."""
    fl, sc = build.load("flash_attention"), build.load("rwkv6_scan")
    log(f"  flash_fwd_wgmma_kernel<128>: {fl.flash_attention_smem_bytes(128)} B of dynamic "
        f"shared memory, 384 threads (registers: 24 producer / 240 consumer after setmaxnreg)")
    for i, name in enumerate(("rwkv6_chunk_state_kernel", "rwkv6_state_scan_kernel",
                              "rwkv6_chunk_out_kernel")):
        log(f"  {name}: {sc.rwkv6_scan_smem_bytes(i)} B of dynamic shared memory")
    sb = build.load("rwkv6_scan_bwd")
    for i, name in enumerate(kernel_names("rwkv6_scan_bwd")):
        log(f"  {name}: {sb.rwkv6_scan_bwd_smem_bytes(i, 1)} B (bf16) / "
            f"{sb.rwkv6_scan_bwd_smem_bytes(i, 0)} B (float32) of dynamic shared memory, "
            f"{sb.rwkv6_scan_bwd_blocks_per_sm(i, 1)} / {sb.rwkv6_scan_bwd_blocks_per_sm(i, 0)} "
            f"blocks an SM")
    bw = build.load("flash_attention_bwd")
    log(f"  flash_bwd_dq_wgmma_kernel<128>, flash_bwd_dkdv_wgmma_kernel<128> (bf16): "
        f"{bw.flash_attention_bwd_smem_bytes(2, 128)} B of dynamic shared memory each, 384 "
        f"threads (registers: 24 producer / 240 consumer after setmaxnreg); "
        f"flash_bwd_dq_kernel<float,128>: {bw.flash_attention_bwd_smem_bytes(0, 128)} B, "
        f"flash_bwd_dkdv_kernel<float,128>: {bw.flash_attention_bwd_smem_bytes(1, 128)} B, 256 "
        f"threads each (float32)")
    wg = [(e, r, sp) for e, r, sp in ptxas_entries(logs.get("flash_attention_bwd", ""))
          if "wgmma" in e]
    for entry, regs, spills in wg:
        log(f"  {entry}: {regs}; {spills}")
        require("0 bytes spill stores" in spills and "0 bytes spill loads" in spills,
                f"{entry} spills registers: {spills}")
    if not wg:
        log("  flash_attention_bwd was built before this run: its ptxas report is not here")
    # The selective scan keeps its states and its decays in registers: a
    # spill would put them in local memory. Both of its libraries stage their
    # operands by cp.async (LDGSTS) and form their decays on the SFU.
    for name in ("ssm_scan", "ssm_scan_bwd"):
        for entry, regs, spills in ptxas_entries(logs.get(name, "")):
            require("0 bytes spill stores" in spills and "0 bytes spill loads" in spills,
                    f"{entry} spills registers: {spills}")
        sass = sass_text(build.library_path(name), build)
        counts = {op: sum(1 for line in sass.splitlines() if op in line)
                  for op in ("LDGSTS", "MUFU.EX2")}
        log(f"  {name} SASS: {counts['LDGSTS']} LDGSTS, {counts['MUFU.EX2']} MUFU.EX2")
        require(counts["LDGSTS"] > 0 and counts["MUFU.EX2"] > 0,
                f"the built {name} library holds no cp.async or no ex2")
    counts = sass_counts(build.library_path("rwkv6_scan_bwd"), build)
    log(f"  rwkv6_scan_bwd SASS: {counts['HMMA']} HMMA, {counts['HGMMA']} HGMMA, "
        f"{counts['LDGSTS']} LDGSTS, {counts['UTMALDG']} UTMALDG")
    require(counts["HMMA"] + counts["HGMMA"] > 0 and counts["LDGSTS"] + counts["UTMALDG"] > 0,
            "the built rwkv6_scan_bwd library holds no tensor-core product or no asynchronous load")
    for name in ("flash_attention", "flash_attention_bwd"):
        counts = sass_counts(build.library_path(name), build)
        log(f"  {name} SASS: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")
        require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                f"the built {name} library holds no wgmma or no TMA load")
        require("serialized" not in logs.get(name, "") and
                "setmaxnreg ignored" not in logs.get(name, ""),
                f"ptxas serialised the wgmma of {name} or ignored its setmaxnreg (see its "
                f"build log)")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase_kernels(torch, mu, N, leaf_shapes):
    """Phase 2: correctness at the main path's shapes, then times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G, K = GROUPS, CLIENTS

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {"flat": 0.0, "leaf": 0.0}
    for masked in (False, True):
        x, g, z = (randn(G, K, N) for _ in range(3))
        y = randn(G, N)
        m = (torch.rand(G, K, generator=gen, device=dev) < 0.5).float() if masked else None
        got = mu.mtgc_update_flat(x, g, z, y, m, lr=0.1, g_scale=1.0)
        torch.cuda.synchronize()
        want = mu.mtgc_update_flat_ref(x, g, z, y, m, 0.1, 1.0)
        err = (got - want).abs().max().item()
        errs["flat"] = max(errs["flat"], err)
        log(f"flat f32 [{G},{K},{N}] masked={masked}: bit-exact={torch.equal(got, want)} "
            f"max_abs_err={err}")
        require(torch.equal(got, want), "mtgc_update_flat is not bit-exact in float32")
        if masked:
            frozen = m == 0
            require(torch.equal(got[frozen], x[frozen]), "a frozen row changed")
        del x, g, z, y, got, want

    # bfloat16: within one bfloat16 ulp of the plain version (2^-8 relative).
    x, g, z = (randn(G, K, N, dtype=torch.bfloat16) for _ in range(3))
    y = randn(G, N, dtype=torch.bfloat16)
    m = (torch.rand(G, K, generator=gen, device=dev) < 0.5).float()
    got = mu.mtgc_update_flat(x, g, z, y, m, lr=0.1).float()
    want = mu.mtgc_update_flat_ref(x, g, z, y, m, 0.1).float()
    excess = ((got - want).abs() - 2.0 ** -8 * want.abs()).max().item()
    log(f"flat bf16 [{G},{K},{N}] masked: max_abs_err={(got - want).abs().max().item()} "
        f"bit-exact={torch.equal(got, want)}")
    require(excess <= 0.0, "mtgc_update_flat bf16 is more than one ulp off")
    del x, g, z, y, got, want

    # Ragged N (not a multiple of the block tile, nor of 4) and NaN rows.
    x, g, z = (randn(3, 2, 1001) for _ in range(3))
    y = randn(3, 1001)
    g[0, 1] = float("nan")
    z[0, 1] = float("inf")
    g[2, 0] = float("nan")
    m = torch.ones(3, 2, device=dev)
    m[0, 1] = 0.0
    got = mu.mtgc_update_flat(x, g, z, y, m, lr=0.07, g_scale=0.5)
    want = mu.mtgc_update_flat_ref(x, g, z, y, m, 0.07, 0.5)
    torch.cuda.synchronize()
    require(torch.equal(got[0, 1], x[0, 1]), "a frozen NaN row changed")
    require(bool(torch.isnan(got[2, 0]).all()), "an active NaN row did not propagate")
    require(torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)),
            "ragged/NaN case differs from the plain version")
    log("flat f32 ragged N=1001 with NaN rows: ok")

    for shape in leaf_shapes:
        a = [randn(*shape) for _ in range(4)]
        got = mu.mtgc_update(*a, lr=0.1)
        torch.cuda.synchronize()
        want = mu.mtgc_update_ref(*a, 0.1)
        errs["leaf"] = max(errs["leaf"], (got - want).abs().max().item())
        require(torch.equal(got, want), f"mtgc_update is not bit-exact on leaf {shape}")
    log(f"leaf f32 on {len(leaf_shapes)} CNN leaf shapes: bit-exact")

    # Times at the main path's shapes. Each flat launch moves ~3.5 GB,
    # far beyond the 50 MB L2, so every launch finds its operands cold.
    x, g, z = (randn(G, K, N) for _ in range(3))
    y = randn(G, N)
    flat = timed(torch, lambda: mu.mtgc_update_flat(x, g, z, y, None, lr=0.1),
                 lambda: mu.mtgc_update_flat_ref(x, g, z, y, None, 0.1))
    nbytes = sum(t.numel() * t.element_size() for t in (x, g, z, y)) + x.numel() * 4
    flat.update(cost_bound(mu.mtgc_update_flat_cost(x, g, z, y), nbytes,
                           FLOPS_PER_ELEMENT * x.numel(), F32_FLOPS_PER_S, "mtgc_update_flat"))
    del x, g, z, y
    leaves = [[randn(*s) for _ in range(4)] for s in leaf_shapes]

    def step(fn):
        return lambda: [fn(*a) for a in leaves]

    leaf = timed(torch, step(lambda *a: mu.mtgc_update(*a, lr=0.1)),
                 step(lambda *a: mu.mtgc_update_ref(*a, 0.1)))
    nbytes = sum(5 * a[0].numel() * 4 for a in leaves)
    costs = [mu.mtgc_update_cost(*a) for a in leaves]
    leaf.update(cost_bound((sum(c[0] for c in costs), sum(c[1] for c in costs)), nbytes,
                           FLOPS_PER_ELEMENT * sum(a[0].numel() for a in leaves),
                           F32_FLOPS_PER_S, "mtgc_update"))
    del leaves
    torch.cuda.empty_cache()
    for name, t in (("mtgc_update_flat", flat), ("mtgc_update (8 leaves)", leaf)):
        log(f"{name}: kernel {t['ms']:.4f} ms {t['ms_readings']}, plain "
            f"{t['plain_ms']:.4f} ms {t['plain_ms_readings']}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} bytes)")
    return errs, flat, leaf


def same_bits(torch, got, want) -> bool:
    """Bit-exact, NaN for NaN: NaN at the same places, every other entry
    with the same bits (so -0.0 and +0.0 differ)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        return False
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got[~nan].view(ints), want[~nan].view(ints))


def phase_quantize(torch, qz, N):
    """Phase 6: the quantize kernels bit for bit against their plain
    versions at the compressed paths' shapes, then times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    R = GROUPS * CLIENTS

    def operands(rows, n, dtype=torch.float32):
        u = (torch.randn(rows, n, generator=gen, device=dev) * 1e-2).to(dtype)
        noise = torch.rand(rows, n, generator=gen, device=dev)
        amax = u.abs().float().amax(dim=1)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        k = max(1, math.ceil(TOPK_FRAC * n))
        thresh = torch.topk(u.abs(), k, dim=1).values[:, -1]
        return u, noise, scale, thresh

    def check(tag, u, noise, scale, thresh):
        got = qz.int8_roundtrip(u, scale, noise)
        want = qz.int8_roundtrip_ref(u, scale, noise)
        torch.cuda.synchronize()
        require(same_bits(torch, got, want), f"int8_roundtrip is not bit-exact ({tag})")
        fin = torch.isfinite(want)
        errs["int8_roundtrip"] = max(errs["int8_roundtrip"],
                                     (got[fin].float() - want[fin].float()).abs().max().item()
                                     if bool(fin.any()) else 0.0)
        got = qz.topk_mask(u, thresh)
        want = qz.topk_mask_ref(u, thresh)
        torch.cuda.synchronize()
        require(same_bits(torch, got, want), f"topk_mask is not bit-exact ({tag})")
        errs["topk_mask"] = max(errs["topk_mask"], (got.float() - want.float()).abs().max().item())
        log(f"quantize {tag}: int8_roundtrip and topk_mask bit-exact")

    errs = {"int8_roundtrip": 0.0, "topk_mask": 0.0}
    check(f"f32 [{R},{N}] (client link)", *operands(R, N))
    check(f"f32 [{GROUPS},{N}] (group link)", *operands(GROUPS, N))
    check("bf16 [7,1001] (ragged N)", *operands(7, 1001, torch.bfloat16))
    u, noise, scale, thresh = operands(5, 3001)
    u[0] = 0.0
    scale[0] = 1.0                       # a zero row's scale, as the engine sets it
    u[1, ::7] = float("inf")
    u[1, 3::7] = -float("inf")
    u[2, ::5] = float("nan")
    u[3, 5] = -0.0
    thresh[3] = 0.0                      # keeps -0.0 (|-0| >= 0)
    check("f32 [5,3001] zero/+-Inf/NaN rows", u, noise, scale, thresh)
    got = qz.int8_roundtrip(u, scale, noise)
    require(bool((got[0] == 0).all()) and bool(torch.isnan(got[2, ::5]).all())
            and bool((got[1, ::7] == 127.0 * scale[1]).all()),
            "int8_roundtrip special rows: zero row, NaN or Inf clip wrong")

    times = {}
    for tag, rows in (("client", R), ("group", GROUPS)):
        u, noise, scale, thresh = operands(rows, N)
        t = timed(torch, lambda: qz.int8_roundtrip(u, scale, noise),
                  lambda: qz.int8_roundtrip_ref(u, scale, noise))
        t.update(cost_bound(qz.int8_roundtrip_cost(u, scale, noise), 3 * u.numel() * 4 + rows * 4,
                            INT8_FLOPS * u.numel(), F32_FLOPS_PER_S, "int8_roundtrip"))
        times[f"int8_roundtrip/{tag}"] = t
        t = timed(torch, lambda: qz.topk_mask(u, thresh), lambda: qz.topk_mask_ref(u, thresh))
        t.update(cost_bound(qz.topk_mask_cost(u, thresh), 2 * u.numel() * 4 + rows * 4,
                            TOPK_FLOPS * u.numel(), F32_FLOPS_PER_S, "topk_mask"))
        times[f"topk_mask/{tag}"] = t
        k = max(1, math.ceil(TOPK_FRAC * N))
        times[f"threshold/{tag}"] = {"ms": cuda_ms(torch, lambda: torch.topk(
            u.abs(), k, dim=1).values[:, -1], iters=5, warmup=1), "k": k}
        del u, noise, scale, thresh
    torch.cuda.empty_cache()
    for name, t in times.items():
        if "bound_ms" in t:
            log(f"{name}: kernel {t['ms']:.4f} ms {t['ms_readings']}, plain "
                f"{t['plain_ms']:.4f} ms {t['plain_ms_readings']}, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} bytes)")
        else:
            log(f"{name}: torch.topk(|u|, k={t['k']}) {t['ms']:.4f} ms")
    return errs, times


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_time(events) -> dict:
    """Device time in a Chrome trace's events (``ts``/``dur`` in us).

    Kernels, copies and fills are read with their stream; an event whose
    correlation id (one per launch) was seen already is dropped and
    counted. ``busy`` is the union of all intervals. Where intervals
    overlap -- on one stream too, since a Hopper kernel may start before
    its predecessor ends -- each instant of busy time is split evenly
    between the events running then, so the per-name ``attributed`` times
    sum to ``busy``; ``summed`` keeps the plain sum of durations."""
    spans, seen, dropped = [], set(), 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        corr = args.get("correlation")
        if corr is not None:
            if (e["cat"], corr) in seen:
                dropped += 1
                continue
            seen.add((e["cat"], corr))
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                      args.get("stream", -1)))
    by_name: dict[str, dict] = {}
    by_stream: dict[int, dict] = {}
    marks = []
    for i, (start, end, name, stream) in enumerate(spans):
        n = by_name.setdefault(name, {"summed": 0.0, "attributed": 0.0, "count": 0})
        n["summed"] += end - start
        n["count"] += 1
        st = by_stream.setdefault(stream, {"summed": 0.0, "count": 0, "spans": []})
        st["summed"] += end - start
        st["count"] += 1
        st["spans"].append((start, end))
        marks += [(start, 1, i), (end, 0, i)]
    marks.sort()
    busy, active, last = 0.0, set(), None
    for t, is_start, i in marks:
        if active and t > last:
            busy += t - last
            for j in active:
                by_name[spans[j][2]]["attributed"] += (t - last) / len(active)
        last = t
        (active.add if is_start else active.discard)(i)
    for st in by_stream.values():
        st["union"] = _union(st.pop("spans"))
    return {"busy": busy, "dropped": dropped, "by_name": by_name, "by_stream": by_stream}


def _union(spans) -> float:
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total if cur_end is None else total + cur_end - cur_start


def profile_round(torch, run, host: bool = True) -> dict:
    """Trace one call of ``run`` with ``torch.profiler``; return the wall
    time and ``device_time`` of its Chrome trace (written to a temporary
    directory and removed), or {} when the trace holds no device time.
    ``host=False`` records the device's activity alone (no host operator
    events: for a run of hundreds of thousands of launches)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "round.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    dev = device_time(events)
    if not dev["by_name"]:
        return {}
    return {"wall_us": wall_us, **dev}


def log_trace(tag: str, trace: dict, top_n: int = 12) -> None:
    """Print a ``profile_round`` result: busy share, streams, and the
    ``top_n`` kernels by their share of the busy time."""
    if not trace:
        log(f"{tag}: the trace holds no device time (not measured)")
        return
    busy = trace["busy"]
    summed = sum(n["summed"] for n in trace["by_name"].values())
    log(f"{tag}: wall {trace['wall_us'] / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms (busy share {busy / trace['wall_us']:.3f}); summed "
        f"durations {summed / 1e3:.1f} ms in {len(trace['by_name'])} kernels; "
        f"{trace['dropped']} events with a repeated correlation id dropped")
    for sid, st in sorted(trace["by_stream"].items()):
        log(f"  stream {sid}: {st['count']} events, summed {st['summed'] / 1e3:.1f} ms, "
            f"busy {st['union'] / 1e3:.1f} ms")
    top = sorted(trace["by_name"].items(), key=lambda kv: -kv[1]["attributed"])[:top_n]
    for name, n in top:
        log(f"  {n['attributed'] / 1e3:9.3f} ms {100 * n['attributed'] / busy:5.1f}% "
            f"of busy (summed {n['summed'] / 1e3:.3f} ms) x{n['count']:<4d} {name[:90]}")


def finite_metrics(np, hz) -> None:
    for f in hz.metrics._fields:
        v = np.asarray(getattr(hz.metrics, f))
        require(np.isfinite(v).all(), f"metric {f} is not finite: {v}")


def causal_pairs(T: int, S: int, q_offset: int = 0) -> int:
    """Live (query, key) pairs of one causal head without a window: query t
    sees keys 0 .. min(q_offset + t, S - 1)."""
    return sum(min(q_offset + t + 1, S) for t in range(T))


def phase_lm_kernels(torch, fa, rs):
    """Phase 12: the LM kernels against their plain versions on the card,
    then times at the serving shapes."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    B, T, H, Kv, Dh = LM_BATCH, LM_PROMPT, 40, 8, 128
    S = LM_PROMPT + LM_GEN
    errs = {}
    # The prefill's call: the prompt's K/V in the first T cache slots, the
    # LM_GEN slots not yet written are zero.
    q = randn(B, T, H, Dh)
    k, v = randn(B, S, Kv, Dh), randn(B, S, Kv, Dh)
    k[:, T:] = 0.0
    v[:, T:] = 0.0
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    errs["flash_attention/f32"] = (got - want).abs().max().item()
    log(f"flash_attention f32 q [{B},{T},{H},{Dh}] kv [{B},{S},{Kv},{Dh}] causal: "
        f"max_abs_err {errs['flash_attention/f32']}")
    require(errs["flash_attention/f32"] < 5e-5, "flash_attention differs from its plain version")
    # bf16, the main path's dtype (the tensor-core kernel), against the
    # plain version in float32 on the same bf16 inputs: within half a bf16
    # ulp (the output's own rounding) plus 5e-5.
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    del q, k, v, got, want
    got = fa.flash_attention(qb, kb, vb).float()
    want = fa.flash_attention_ref(qb.float(), kb.float(), vb.float())
    err = (got - want).abs()
    excess = (err - 2.0 ** -8 * want.abs()).max().item()
    errs["flash_attention"] = err.max().item()
    plain16 = fa.flash_attention_ref(qb, kb, vb).float()
    log(f"flash_attention bf16 at the same shape: max |kernel - plain in f32| "
        f"{errs['flash_attention']} (beyond half an ulp: {excess}); "
        f"{int((got != plain16).sum())} of {got.numel()} outputs differ from the bf16 plain "
        f"version, by at most {(got - plain16).abs().max().item()}")
    require(excess < 5e-5, "flash_attention bf16 is off by more than half an ulp + 5e-5")
    del got, want, err, plain16
    for (b, t, s, h, kv, dh, causal, win, off) in (
            (2, 128, 128, 4, 2, 64, True, 0, 0),     # GQA
            (1, 256, 256, 2, 1, 32, True, 64, 0),    # MQA + window
            (2, 256, 256, 8, 2, 128, True, 100, 0),  # window not tile-aligned
            (1, 24, 70, 6, 3, 64, True, 0, 30),      # q_offset > 0
            (2, 33, 81, 4, 4, 128, True, 9, 40),     # window + q_offset + ragged S
            (1, 100, 170, 5, 5, 32, False, 0, 7)):   # bidirectional, ragged
        q, k, vv = randn(b, t, h, dh), randn(b, s, kv, dh), randn(b, s, kv, dh)
        for dtype, half_ulp in ((torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)):
            q, k, vv = q.to(dtype).float(), k.to(dtype).float(), vv.to(dtype).float()
            got = fa.flash_attention(q.to(dtype), k.to(dtype), vv.to(dtype), causal=causal,
                                     window=win, q_offset=off).float()
            want = fa.flash_attention_ref(q, k, vv, causal=causal, window=win, q_offset=off,
                                          block=64)
            excess = ((got - want).abs() - half_ulp * want.abs()).max().item()
            require(excess < 5e-5, f"flash_attention {dtype} differs at "
                    f"{(b, t, s, h, kv, dh, win, off)}")
            key = "flash_attention/f32" if dtype == torch.float32 else "flash_attention"
            errs[key] = max(errs[key], (got - want).abs().max().item())
    log("flash_attention small ragged shapes (GQA, MQA, window 64/100/9, q_offset 30/40/7, "
        "ragged S), f32 and bf16: within 5e-5 (bf16: plus half an ulp)")
    # The prefill calls of (f5) and (f6) in bf16, the serving dtype: whisper's
    # self-attention (MHA at head size 64) and internvl2's (6 query heads a kv
    # head at 128, the patches' positions before the prompt's), each cache's
    # last LM_GEN slots not yet written; against the plain version in float32
    # on the same inputs, within half an ulp plus 5e-5.
    for arch, t in ((AUDIO_ARCH, AUDIO_PROMPT),
                    (VLM_ARCH, get_arch(VLM_ARCH).vision_tokens + LM_PROMPT)):
        c = get_arch(arch)
        h, kv, dh, s = c.num_heads, c.num_kv_heads, c.d_head, t + LM_GEN
        q = randn(LM_BATCH, t, h, dh).bfloat16()
        k, vv = randn(LM_BATCH, s, kv, dh).bfloat16(), randn(LM_BATCH, s, kv, dh).bfloat16()
        k[:, t:] = 0.0
        vv[:, t:] = 0.0
        got = fa.flash_attention(q, k, vv).float()
        want = fa.flash_attention_ref(q.float(), k.float(), vv.float())
        err = (got - want).abs()
        excess = (err - 2.0 ** -8 * want.abs()).max().item()
        errs[f"flash_attention/{arch}"] = err.max().item()
        errs["flash_attention"] = max(errs["flash_attention"], err.max().item())
        log(f"flash_attention bf16 at {arch}'s prefill, q [{LM_BATCH},{t},{h},{dh}] kv "
            f"[{LM_BATCH},{s},{kv},{dh}] causal: max |kernel - plain in f32| "
            f"{errs[f'flash_attention/{arch}']} (beyond half an ulp: {excess})")
        require(excess < 5e-5, f"flash_attention bf16 at {arch}'s prefill shape is off by more "
                               f"than half an ulp + 5e-5")
        del q, k, vv, got, want, err

    # RWKV-6 at the serving shape, in the model's [B, T, H, Dh] layout, from
    # a nonzero state; the decays are the model's -exp(-1 + tanh(.)).
    Hr, Dr, C = 32, 64, 64
    r, kk, vv = (randn(LM_BATCH, T, Hr, Dr) for _ in range(3))
    logw = -torch.exp(-1.0 + torch.tanh(randn(LM_BATCH, T, Hr, Dr)))
    u = 0.1 * randn(Hr, Dr)
    s0 = 0.1 * randn(LM_BATCH, Hr, Dr, Dr)
    for tt in (T, T - 45):          # T - 45: not a chunk multiple, padded in the kernel
        args = [a[:, :tt].contiguous() for a in (r, kk, vv, logw)] + [u, s0]
        go, gs = rs.rwkv6_scan_bthd(*args, chunk=C)
        wo, ws = rs.rwkv6_chunked_ref(*args, chunk=C)
        torch.cuda.synchronize()
        require(torch.allclose(go, wo, rtol=1e-4, atol=1e-4) and
                torch.allclose(gs, ws, rtol=1e-4, atol=1e-4),
                f"rwkv6_scan differs from its plain version at T={tt}")
        err = max((go - wo).abs().max().item(), (gs - ws).abs().max().item())
        errs["rwkv6_scan/f32"] = max(errs.get("rwkv6_scan/f32", 0.0), err)
        log(f"rwkv6_scan f32 [{LM_BATCH},{tt},{Hr},{Dr}] C={C}, nonzero state: max_abs_err {err} "
            f"(max |o| {wo.abs().max().item():.3g})")
    rb, kb_, vb_ = r.bfloat16(), kk.bfloat16(), vv.bfloat16()
    go, gs = rs.rwkv6_scan_bthd(rb, kb_, vb_, logw, u, s0, chunk=C)
    wo, ws = rs.rwkv6_chunked_ref(rb, kb_, vb_, logw, u, s0, chunk=C)
    require(torch.allclose(go, wo, rtol=1e-4, atol=1e-4) and
            torch.allclose(gs, ws, rtol=1e-4, atol=1e-4), "rwkv6_scan bf16 inputs differ")
    errs["rwkv6_scan"] = max((go - wo).abs().max().item(), (gs - ws).abs().max().item())
    log(f"rwkv6_scan with bf16 r/k/v (the model's dtype): within rtol/atol 1e-4, max_abs_err "
        f"{errs['rwkv6_scan']}")
    # Strong decays (logw in [-20, -5]): against rwkv6_chunk_parallel_ref, the
    # kernel's arithmetic in PyTorch (held against the sequential recurrence
    # on the CPU); the plain version's chunk-wide sums lose more than the
    # tolerance here, and its distance is printed beside.
    logw_s = -5.0 - 15.0 * torch.rand(LM_BATCH, T, Hr, Dr, generator=gen, device=dev)
    go, gs = rs.rwkv6_scan_bthd(rb, kb_, vb_, logw_s, u, s0, chunk=C)
    wo, ws = rs.rwkv6_chunk_parallel_ref(rb, kb_, vb_, logw_s, u, s0, chunk=C)
    require(bool(torch.isfinite(go).all()) and torch.allclose(go, wo, rtol=1e-4, atol=1e-4) and
            torch.allclose(gs, ws, rtol=1e-4, atol=1e-4), "rwkv6_scan differs at strong decays")
    errs["rwkv6_scan/strong"] = max((go - wo).abs().max().item(), (gs - ws).abs().max().item())
    po, _ = rs.rwkv6_chunked_ref(rb, kb_, vb_, logw_s, u, s0, chunk=C)
    log(f"rwkv6_scan at strong decays (logw in [-20, -5]), bf16 r/k/v: within rtol/atol 1e-4 of "
        f"the chunk-parallel plain form, max_abs_err {errs['rwkv6_scan/strong']}; the plain "
        f"version is {(po - go).abs().max().item()} from the kernel")
    del r, kk, vv, go, gs, wo, ws, po, logw_s

    # Times at the serving shapes, in the model's dtypes.
    flash = timed(torch, lambda: fa.flash_attention(qb, kb, vb),
                  lambda: fa.flash_attention_ref(qb, kb, vb), iters=10, plain_iters=3)
    qt, kt, vt = (a.transpose(1, 2) for a in (qb, kb, vb))
    flash["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=10, warmup=2)
    # The row statistics the training path asks for (serving never does).
    flash["stats_ms"] = cuda_ms(torch, lambda: fa.flash_attention(qb, kb, vb, return_stats=True),
                                iters=10)
    lib_err = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
               .transpose(1, 2).float() - fa.flash_attention(qb, kb, vb).float()).abs().max().item()
    pairs = B * H * causal_pairs(T, S)
    nbytes = 2 * qb.numel() * 2 + 2 * kb.numel() * 2     # q read, o written, k and v read
    flash.update(cost_bound(fa.flash_attention_cost(qb, kb, vb), nbytes, 4 * Dh * pairs,
                            BF16_FLOPS_PER_S, "flash_attention"))
    flash.update(pairs=pairs, sdpa_max_abs_diff=lib_err)
    flash["passes"] = profile_round(torch, lambda: [fa.flash_attention(qb, kb, vb)
                                                     for _ in range(3)])
    del qb, kb, vb, qt, kt, vt
    scan = timed(torch, lambda: rs.rwkv6_scan_bthd(rb, kb_, vb_, logw, u, s0, chunk=C),
                 lambda: rs.rwkv6_chunked_ref(rb, kb_, vb_, logw, u, s0, chunk=C),
                 iters=10, plain_iters=3)
    nc = T // C
    nbytes = 3 * rb.numel() * 2 + logw.numel() * 4 * 2 + 2 * s0.numel() * 4  # r/k/v, logw + o, S
    flops = LM_BATCH * Hr * nc * (2 * 2 * C * Dr * Dr + 2 * 2 * C * C * Dr)
    scan.update(cost_bound(rs.rwkv6_scan_cost(rb, kb_, vb_, logw, u, s0, chunk=C), nbytes, flops,
                           BF16_FLOPS_PER_S, "rwkv6_scan"))
    sub = rs.SUB_CHUNK
    exps_per_chunk = ((C // sub) * (sub * (sub - 1) // 2) + 4 * C) * Dr   # pairs + rx, kq, ra, A
    scan.update(library_ms=None, exps=LM_BATCH * Hr * nc * exps_per_chunk,
                passes=profile_round(torch, lambda: [rs.rwkv6_scan_bthd(rb, kb_, vb_, logw, u, s0,
                                                                        chunk=C)
                                                     for _ in range(3)]))
    del rb, kb_, vb_, logw, u, s0
    torch.cuda.empty_cache()
    for name, t in (("flash_attention", flash), ("rwkv6_scan", scan)):
        t["bound_share"] = t["bound_ms"] / t["ms"]
        log(f"{name}: kernel {t['ms']:.4f} ms {t['ms_readings']}, plain {t['plain_ms']:.4f} ms "
            f"{t['plain_ms_readings']}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"{t['bytes']} bytes, {t['flops']:.4g} FLOP; bound share {t['bound_share']:.3f}), "
            f"library {t['library_ms']}" + (f", with row statistics {t['stats_ms']:.4f} ms"
                                             if "stats_ms" in t else ""))
        log_trace(f"  {name}, three calls (traced)", t.pop("passes"), top_n=4)
    log(f"  flash_attention: {flash['pairs']} live pairs; SDPA against the kernel: max abs "
        f"diff {flash['sdpa_max_abs_diff']}; rwkv6_scan: {scan['exps']} exponentials")
    return errs, {"flash_attention": flash, "rwkv6_scan": scan}


def window_pairs(T: int, S: int, window: int) -> int:
    """Live (query, key) pairs of one causal head under a sliding window
    (q_offset 0): query t sees keys max(0, t - window + 1) .. min(t, S - 1)."""
    return sum(min(t + 1, window, S) for t in range(T))


def phase_window_kernels(torch, fa):
    """Phase 12 (cont.): the flash forward at the windowed serving shapes --
    gemma3-27b's local layers (q [4, 2048, 32, 128], kv 16 heads) and
    hymba-1.5b's layers (q [4, 2048, 25, 64], kv 5 heads), window 1024 --
    against its plain version, with times, the bound from the live pairs
    under the window, and SDPA with the equivalent boolean mask."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(121)
    B, T, S, W = LM_BATCH, LM_PROMPT, LM_PROMPT + LM_GEN, WINDOW
    out = {}
    for arch, H, Kv, Dh in (("gemma3-27b", 32, 16, 128), ("hymba-1.5b", 25, 5, 64)):
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, Kv, Dh, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, Kv, Dh, generator=gen, device=dev).bfloat16()
        k[:, T:] = 0.0
        v[:, T:] = 0.0
        got = fa.flash_attention(q, k, v, window=W).float()
        want = fa.flash_attention_ref(q.float(), k.float(), v.float(), window=W)
        err = (got - want).abs()
        excess = (err - 2.0 ** -8 * want.abs()).max().item()
        max_err = err.max().item()
        log(f"flash_attention bf16 {arch} q [{B},{T},{H},{Dh}] kv [{B},{S},{Kv},{Dh}] window "
            f"{W}: max |kernel - plain in f32| {max_err} (beyond half an ulp: {excess})")
        require(excess < 5e-5, f"flash_attention at {arch}'s windowed shape is off by more than "
                               f"half an ulp + 5e-5")
        del got, want, err
        t = timed(torch, lambda: fa.flash_attention(q, k, v, window=W),
                  lambda: fa.flash_attention_ref(q, k, v, window=W), iters=10, plain_iters=3)
        qpos = torch.arange(T, device=dev)[:, None]
        kpos = torch.arange(S, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - W)
        qt = q.transpose(1, 2)
        kt, vt = (fa._expand_kv(a, H).transpose(1, 2) for a in (k, v))
        t["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=10, warmup=2)
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask).transpose(1, 2)
        t["sdpa_max_abs_diff"] = (lib.float() - fa.flash_attention(q, k, v, window=W).float()
                                  ).abs().max().item()
        pairs = B * H * window_pairs(T, S, W)
        t.update(cost_bound(fa.flash_attention_cost(q, k, v, window=W),
                            2 * q.numel() * 2 + 2 * k.numel() * 2, 4 * Dh * pairs,
                            BF16_FLOPS_PER_S, "flash_attention (windowed)"))
        t.update(pairs=pairs, max_abs_err=max_err,
                 bound_share=t["bound_ms"] / t["ms"],
                 shape=f"q [{B},{T},{H},{Dh}] bf16, k/v [{B},{S},{Kv},{Dh}], window {W}")
        log(f"  kernel {t['ms']:.4f} ms {t['ms_readings']}, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {pairs} live pairs; share "
            f"{t['bound_share']:.3f}), SDPA with the window's mask {t['library_ms']:.4f} ms "
            f"(max abs diff {t['sdpa_max_abs_diff']})")
        out[arch] = t
        del q, k, v, qt, kt, vt, lib, mask
    torch.cuda.empty_cache()
    return out


def scan_inputs(torch, gen, B, T, Di, S, udtype, dt_shift=0.0):
    """Selective-scan operands as hymba's gates make them: u = silu(.) in
    ``udtype``, dt = softplus(.) (``dt_shift`` < 0: weak decays, a long
    memory), B and C normal, log_a the init's log(1..S) plus noise, d_skip
    near 1, a nonzero state."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    u = F.silu(randn(B, T, Di)).to(udtype)
    dt = F.softplus(randn(B, T, Di) + dt_shift)
    Bm, Cm = randn(B, T, S), randn(B, T, S)
    log_a = torch.log(torch.linspace(1.0, S, S, device="cuda"))[None] + 0.2 * randn(Di, S)
    d_skip = 1.0 + 0.1 * randn(Di)
    s0 = 0.5 * randn(B, Di, S)
    return u, dt, Bm, Cm, log_a, d_skip, s0


def phase_ssm_kernel(torch, ss):
    """Phase 12 (cont.): ``selective_scan`` against ``selective_scan_ref`` at
    hymba's prefill shape (u [4, 2048, 3200], S = 16) with u in bfloat16
    (the model's dtype) and float32, and at small ragged shapes (T = 1, 37,
    2049; Di = 37, not a multiple of a block's 32 chains; S = 5; weak
    decays), each from a nonzero state. Tolerance: within 1e-5 of max|y|
    for y and of max|h| for the final state (both compute the same float32
    recurrence token by token; the kernel fuses h's update into an FMA and
    takes its decays from ex2.approx).
    Then a second call's bits, the kernel's time against its bound and its
    plain version, and a trace of 100 calls."""
    gen = torch.Generator(device="cuda").manual_seed(122)
    Bh, Th, Di, S = LM_BATCH, LM_PROMPT, HYMBA_DI, HYMBA_S
    worst = {}

    def check(args, tag):
        got = ss.selective_scan(*args)
        want = ss.selective_scan_ref(*args)
        torch.cuda.synchronize()
        rel = max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                  for g, w in zip(got, want))
        key = "selective_scan" if args[0].dtype == torch.bfloat16 else "selective_scan/f32"
        worst[key] = max(worst.get(key, 0.0), max((g - w).abs().max().item()
                                                  for g, w in zip(got, want)))
        require(all(g.dtype == torch.float32 and g.shape == w.shape for g, w in zip(got, want)),
                f"selective_scan {tag}: outputs' dtype or shape")
        require(rel <= 1e-5, f"selective_scan differs from its plain version at {tag}: "
                             f"{rel} of the largest entry")
        return rel, got

    for udtype in (torch.bfloat16, torch.float32):
        args = scan_inputs(torch, gen, Bh, Th, Di, S, udtype)
        rel, got = check(args, f"hymba's prefill shape, u {udtype}")
        log(f"selective_scan u {udtype} [{Bh},{Th},{Di}] S {S}, nonzero state: within "
            f"{rel:.3g} of the largest entry (max|y| {got[0].abs().max().item():.3g}, max|h| "
            f"{got[1].abs().max().item():.3g})")
    for B, T, Dr, Sr, shift in ((2, 1, 37, 16, 0.0), (2, 37, 37, 16, 0.0),
                                (1, 2049, 37, 16, -3.0), (3, 50, 33, 5, 0.0),
                                (2, 300, 64, 16, -6.0)):
        for udtype in (torch.bfloat16, torch.float32):
            check(scan_inputs(torch, gen, B, T, Dr, Sr, udtype, shift),
                  f"[{B},{T},{Dr}] S {Sr}, dt shift {shift}, u {udtype}")
    log("selective_scan ragged shapes (T 1, 37, 2049; Di 37, 33, 64; S 16 and 5; weak "
        "decays), u bf16 and f32, nonzero states: within 1e-5 of the largest entry")
    # The training shape (one microbatch), with the chunk-start states the
    # backward starts from, each against the plain loop's h at its token.
    Bt, Tt = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    for udtype in (torch.bfloat16, torch.float32):
        args = scan_inputs(torch, gen, Bt, Tt, Di, S, udtype)
        rel, got = check(args, f"hymba's training shape, u {udtype}")
        y, s_out, states = ss.selective_scan(*args, keep_states=True)
        require(torch.equal(y, got[0]) and torch.equal(s_out, got[1]),
                "selective_scan with its chunk states differs from the call without them")
        worst_states = chunk_states_error(torch, ss, args, states)
        require(worst_states <= 1e-5, f"selective_scan's chunk states differ from the plain "
                                      f"loop's h: {worst_states} of max|h|")
        log(f"selective_scan u {udtype} [{Bt},{Tt},{Di}] S {S} (training), nonzero state: "
            f"within {rel:.3g} of the largest entry; its {states.shape[1]} chunk-start states "
            f"within {worst_states:.3g} of max|h| of the plain loop's h at those tokens")
        del args, got, y, s_out, states

    args = scan_inputs(torch, gen, Bh, Th, Di, S, torch.bfloat16)
    first = ss.selective_scan(*args)
    again = ss.selective_scan(*args)
    require(all(torch.equal(a, b) for a, b in zip(first, again)),
            "selective_scan: two calls on the same inputs give different bits")
    del first, again
    t = timed(torch, lambda: ss.selective_scan(*args), lambda: ss.selective_scan_ref(*args),
              iters=20, plain_iters=1)
    u = args[0]
    elems = u.numel()
    # u read (bf16), dt read, y written per (b, t, di); B and C per (b, t);
    # log_a, d_skip; the state in and out.
    nbytes = (elems * (2 + 4 + 4) + 2 * Bh * Th * S * 4 + Di * S * 4 + Di * 4
              + 2 * Bh * Di * S * 4)
    # dt * A, exp, (dt u) B, h's multiply-add, y's multiply-add per state;
    # dt * u and the skip's multiply-add per (b, t, di).
    flops = elems * S * 7 + elems * 3
    t.update(cost_bound(ss.selective_scan_cost(*args), nbytes, flops, F32_FLOPS_PER_S,
                        "selective_scan"))
    t.update(exps=elems * S, library_ms=None,
             bound_share=t["bound_ms"] / t["ms"], sfu_floor_ms=elems * S / SFU_EXP2_PER_S * 1e3)
    # A trace of a few milliseconds this late in the script may come back
    # without device events (phase 12b's note): 100 calls take about 45 ms.
    trace = profile_round(torch, lambda: [ss.selective_scan(*args) for _ in range(100)])
    log(f"selective_scan [{Bh},{Th},{Di}] S {S}, u bf16: kernel {t['ms']:.4f} ms "
        f"{t['ms_readings']}, plain {t['plain_ms']:.4f} ms {t['plain_ms_readings']}, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {nbytes} bytes, {flops:.4g} FLOP, "
        f"{t['exps']} exponentials; bound share {t['bound_share']:.3f}); the SFU's floor for "
        f"the exponentials {t['sfu_floor_ms']:.4f} ms (16 a clock an SM at 1.98 GHz); "
        f"library: none (no one PyTorch call computes the scan)")
    log_trace("  selective_scan, 100 calls (traced)", trace, top_n=4)
    del args, u
    # The training shape: the kernel from a CUDA graph over operand sets that
    # move four times the L2 cache (its 65 MB a call would otherwise partly
    # stay in the 50 MB L2), beside eager calls and the plain loop.
    args = scan_inputs(torch, gen, Bt, Tt, Di, S, torch.bfloat16)
    elems = args[0].numel()
    nbytes = (elems * (2 + 4 + 4) + 2 * Bt * Tt * S * 4 + Di * S * 4 + Di * 4
              + 2 * Bt * Di * S * 4)
    sets = cold_copies(torch, args, nbytes)
    tt = timed(torch, lambda: ss.selective_scan(*args), lambda: ss.selective_scan_ref(*args),
               iters=20, plain_iters=1)
    tt["graph_ms"] = graph_ms(torch, [lambda a=a: ss.selective_scan(*a) for a in sets])
    tt.update(cost_bound(ss.selective_scan_cost(*args), nbytes, elems * S * 7 + elems * 3,
                         F32_FLOPS_PER_S, "selective_scan (training shape)"))
    tt.update(exps=elems * S, cold_sets=len(sets),
              sfu_floor_ms=elems * S / SFU_EXP2_PER_S * 1e3,
              bound_share=tt["bound_ms"] / tt["graph_ms"])
    t["training"] = tt
    log(f"selective_scan [{Bt},{Tt},{Di}] S {S} (training), u bf16: kernel {tt['graph_ms']:.4f} "
        f"ms from a CUDA graph over {len(sets)} operand sets ({tt['ms']:.4f} ms called eagerly "
        f"{tt['ms_readings']}), plain {tt['plain_ms']:.4f} ms, bound {tt['bound_ms']:.4f} ms "
        f"({tt['bound_by']}; share {tt['bound_share']:.3f}), the SFU's floor "
        f"{tt['sfu_floor_ms']:.4f} ms")
    del args, sets
    torch.cuda.empty_cache()
    return worst, t


def chunk_states_error(torch, ss, args, states) -> float:
    """The largest difference of the forward's chunk-start states from the
    plain loop's h at those tokens, over max|h| there (chunk 0 must be the
    initial state itself)."""
    u, dt, Bm, _, log_a, _, h = args
    require(torch.equal(states[:, 0], h), "the first chunk state is not the initial state")
    A = -torch.exp(log_a)
    worst = 0.0
    for t in range(u.shape[1]):
        if t and t % ss.CHUNK == 0:
            worst = max(worst, (states[:, t // ss.CHUNK] - h).abs().max().item()
                        / h.abs().max().item())
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t].float())[:, :, None] \
            * Bm[:, t, None]
    return worst


def ssm_bwd_scales(ss, args, dy, dfin) -> dict:
    """The sums' scales: the largest sum of their terms' magnitudes (dB, dC
    over Di; dlog_a, dd_skip over (b, t)), from the plain backward on the
    operands' absolute values (decays stay positive, so its h and g bound
    the true ones term by term)."""
    ab = [a.float().abs() for a in args[:4]] + [args[4], args[5].abs(), args[6].abs()]
    mags = ss.selective_scan_bwd_ref(*ab, dy.abs(), None if dfin is None else dfin.abs())
    return {"dB": mags[2].max().item(), "dC": mags[3].max().item(),
            "dlog_a": mags[4].abs().max().item(), "dd_skip": mags[5].max().item()}


SSM_GRADS = ("du", "ddt", "dB", "dC", "dlog_a", "dd_skip", "dstate0")
# The selective scan backward's four kernels, in launch order.
# Phase 12d's ragged cases (B, T, Di, S, dt shift, d_final): a ragged last
# chunk over a partial block of chains; S 5 with Di not 16-byte pieces;
# strong decays (every chunk's decay product underflows to 0); weak decays;
# one token; one whole chunk; a chunk of one token after a whole one; 64
# chunks (the fold's longest carry here).
SSM_BWD_RAGGED = ((2, 130, 40, 16, 0.0, True), (3, 50, 33, 5, 0.0, True),
                  (2, 300, 64, 16, 3.0, True), (1, 700, 96, 16, -4.0, False),
                  (1, 1, 40, 16, 0.0, True), (1, 64, 32, 16, 0.0, True),
                  (1, 65, 40, 16, 0.0, True), (1, 4096, 64, 16, -2.0, False))


def ssm_bwd_errors(torch, got, want, scales, udtype) -> dict:
    """Each gradient's largest error over its bound's scale (its largest
    entry; a sum's largest sum of terms' magnitudes), a bf16 du less one bf16
    ulp of its largest entry (each side rounds once from float32)."""
    out = {}
    for name, g, w in zip(SSM_GRADS, got, want):
        require(g.dtype == w.dtype and g.shape == w.shape, f"selective_scan_bwd {name}: "
                                                          f"dtype or shape")
        top = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        if name == "du" and udtype == torch.bfloat16:
            err = max(0.0, err - 2.0 ** (math.floor(math.log2(top)) - 7))
        out[name] = {"abs": (g.float() - w.float()).abs().max().item(),
                     "of_scale": err / max(scales.get(name, top), 1e-30)}
    return out


def phase_ssm_backward(torch, ss, logs: dict):
    """Phase 12d: the selective scan's backward (``csrc/ssm_scan_bwd.cu``,
    four launches: the carry pass, the fold, the chunk pass, the reduction)
    on the forward kernel's chunk-start states, against
    ``selective_scan_bwd_ref`` (a float32 reverse loop on the card): at
    hymba's training shape (u [1, 2048, 3200], S = 16) in bf16 and float32,
    each without a final-state gradient (training's case) and with one; at
    ragged shapes (a partial block of chains and a ragged last chunk; S = 5
    with Di not 16-byte pieces; strong decays, where every chunk's decay
    product underflows to 0; weak decays; one token; one whole chunk; 65
    tokens; 64 chunks), every case from a nonzero state. Each gradient within
    1e-5 of its largest entry; dB, dC, dlog_a and dd_skip within 1e-5 of the
    largest sum of their terms' magnitudes (``ssm_bwd_scales``); a bf16 du
    one bf16 ulp more. A second call gives the same bits. Then kernel (eager
    and from a CUDA graph over operand sets that move four times the L2),
    plain and bound times (the bound from what the gradients need, not from
    what the design moves), the SFU's floor, the bytes and ex2 the design's
    passes are reckoned to move and form (logged), and each kernel's traced
    time, grid, blocks an SM, shared memory, registers and spills (none
    allowed)."""
    from repro_torch.kernels import build

    bwd_lib = build.load("ssm_scan_bwd")
    require(bwd_lib.selective_scan_bwd_state_interval() == ss.CHUNK,
            "the backward reads states at another interval than the forward keeps them")
    gen = torch.Generator(device="cuda").manual_seed(124)
    Bt, Tt, Di, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ, HYMBA_DI, HYMBA_S
    worst = {}

    def check(B, T, D, Sr, udtype, d_final, shift, tag):
        args = scan_inputs(torch, gen, B, T, D, Sr, udtype, shift)
        dy = torch.randn(B, T, D, generator=gen, device="cuda")
        dfin = torch.randn(B, D, Sr, generator=gen, device="cuda") if d_final else None
        _, _, states = ss.selective_scan(*args, keep_states=True)
        before = ss.selective_scan_bwd.launches
        got = ss.selective_scan_bwd(*args, dy, dfin, states=states)
        require(ss.selective_scan_bwd.launches == before + ss.BWD_LAUNCHES,
                f"selective_scan_bwd at {tag}: {ss.selective_scan_bwd.launches - before} "
                f"launches counted, expected {ss.BWD_LAUNCHES}")
        want = ss.selective_scan_bwd_ref(*args, dy, dfin)
        torch.cuda.synchronize()
        errs = ssm_bwd_errors(torch, got, want, ssm_bwd_scales(ss, args, dy, dfin), udtype)
        bad = {n: e["of_scale"] for n, e in errs.items() if not e["of_scale"] <= 1e-5}
        require(not bad, f"selective_scan_bwd differs from its plain version at {tag}: {bad}")
        again = ss.selective_scan_bwd(*args, dy, dfin, states=states)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"selective_scan_bwd at {tag}: two calls give different bits")
        key = "bf16" if udtype == torch.bfloat16 else "f32"
        for n, e in errs.items():
            worst.setdefault(key, {})[n] = max(worst.get(key, {}).get(n, 0.0), e["abs"])
        return errs

    for udtype in (torch.bfloat16, torch.float32):
        for d_final in (False, True):
            errs = check(Bt, Tt, Di, S, udtype, d_final, 0.0,
                         f"the training shape, u {udtype}, d_final {d_final}")
            share = {n: float(f"{e['of_scale']:.3g}") for n, e in errs.items()}
            log(f"selective_scan_bwd u {udtype} [{Bt},{Tt},{Di}] S {S} (training), nonzero "
                f"state, {'a' if d_final else 'no'} final-state gradient: error over scale "
                f"{share}; a second call bit for bit")
    for B, T, D, Sr, shift, d_final in SSM_BWD_RAGGED:
        for udtype in (torch.bfloat16, torch.float32):
            check(B, T, D, Sr, udtype, d_final, shift, f"[{B},{T},{D}] S {Sr}, dt shift {shift}")
    log(f"selective_scan_bwd ragged shapes {[c[:4] for c in SSM_BWD_RAGGED]} (a partial block "
        f"and a ragged chunk; S 5, Di 33; strong and weak decays; T 1, 64, 65, 4096), u bf16 "
        f"and f32, nonzero states: within 1e-5 of each gradient's scale, a second call bit "
        f"for bit")

    args = scan_inputs(torch, gen, Bt, Tt, Di, S, torch.bfloat16)
    dy = torch.randn(Bt, Tt, Di, generator=gen, device="cuda")
    _, _, states = ss.selective_scan(*args, keep_states=True)
    t = timed(torch, lambda: ss.selective_scan_bwd(*args, dy, states=states),
              lambda: ss.selective_scan_bwd_ref(*args, dy), iters=20, plain_iters=1)
    elems = args[0].numel()
    rows = 2 * Bt * Tt * S * 4                                   # B and C, or dB and dC
    # The bound's bytes are what the gradients need, whatever the design:
    # u (bf16), dt, dy, B, C, log_a, d_skip and state0 read; du (bf16), ddt,
    # dB, dC, dlog_a, dd_skip and dstate0 written. The states the forward
    # keeps for the recompute are a design's, and are not counted.
    nbytes = (elems * (2 + 4 + 4) + rows + Di * S * 4 + Di * 4 + Bt * Di * S * 4
              + elems * (2 + 4) + rows + Di * S * 4 + Di * 4 + Bt * Di * S * 4)
    # Per (b, t, di, s): the recompute's dt * a and (dt u) B and h's FMA, the
    # sweep's dt * a, g's FMA, the carry, dec h, dlog_a's FMA and its
    # product, du's and ddt's terms and their sums, dB's and dC's terms and
    # their sums: about 20 float32 operations, and two exponentials.
    flops = elems * S * 20
    t.update(cost_bound(ss.selective_scan_bwd_cost(*args, dy), nbytes, flops, F32_FLOPS_PER_S,
                        "selective_scan_bwd"))
    # Reckoned for this design from the library's own queries, not measured:
    # the bound's bytes with the kept states in place of state0, the carry
    # pass's second read of dt, dy and C, and each scratch float written and
    # read once; the ex2 its passes form.
    scratch = [bwd_lib.selective_scan_bwd_scratch_floats(i, Bt, Tt, Di, S) for i in range(3)]
    design = (nbytes - Bt * Di * S * 4 + states.numel() * 4 + elems * 8 + rows // 2
              + 2 * 4 * sum(scratch))
    design_exps = bwd_lib.selective_scan_bwd_exp2_count(Bt, Tt, Di, S)
    sets = cold_copies(torch, (*args, dy, states), design)
    t["graph_ms"] = graph_ms(torch, [lambda a=a: ss.selective_scan_bwd(*a[:7], a[7], states=a[8])
                                     for a in sets])
    smem = {n: {"bf16": bwd_lib.selective_scan_bwd_smem_bytes(i, 1),
                "f32": bwd_lib.selective_scan_bwd_smem_bytes(i, 0)}
            for i, n in enumerate(kernel_names("selective_scan_bwd"))}
    per_sm = {n: {"bf16": bwd_lib.selective_scan_bwd_blocks_per_sm(i, 1),
                  "f32": bwd_lib.selective_scan_bwd_blocks_per_sm(i, 0)}
              for i, n in enumerate(kernel_names("selective_scan_bwd"))}
    grid = {n: bwd_lib.selective_scan_bwd_grid(i, Bt, Tt, Di, S)
            for i, n in enumerate(kernel_names("selective_scan_bwd"))}
    t.update(bytes=nbytes, flops=flops, exps=2 * elems * S, library_ms=None,
             sfu_floor_ms=2 * elems * S / SFU_EXP2_PER_S * 1e3,
             reckoned_design_bytes=design, reckoned_design_exps=design_exps,
             bound_share=t["bound_ms"] / t["ms"], graph_bound_share=t["bound_ms"] / t["graph_ms"],
             cold_sets=len(sets), smem_bytes=smem, blocks_per_sm=per_sm, grid=grid)
    del sets
    trace = profile_round(torch, lambda: [ss.selective_scan_bwd(*args, dy, states=states)
                                          for _ in range(50)])
    t["kernel_ms"] = ({name: n["attributed"] / 1e3 / 50 for name, n in trace["by_name"].items()
                       if "ssm_bwd" in name} if trace else None)
    entries = ptxas_entries(logs.get("ssm_scan_bwd", ""))
    for entry, regs, spills in entries:
        require("0 bytes spill stores" in spills and "0 bytes spill loads" in spills,
                f"{entry} spills registers: {spills}")
    t["ptxas"] = [f"{e}: {r}; {sp}" for e, r, sp in entries] or None
    log(f"selective_scan_bwd [{Bt},{Tt},{Di}] S {S}, u bf16, no final-state gradient: kernel "
        f"{t['graph_ms']:.4f} ms from a CUDA graph over {t['cold_sets']} operand sets, "
        f"{t['ms']:.4f} ms called eagerly {t['ms_readings']} (traced, by kernel: "
        f"{t['kernel_ms']}), plain {t['plain_ms']:.4f} ms {t['plain_ms_readings']}, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {nbytes} bytes, {flops:.4g} FLOP; share "
        f"{t['graph_bound_share']:.3f} of the graph time, {t['bound_share']:.3f} of the eager "
        f"one); the SFU's floor for the gradients' {t['exps']} exponentials "
        f"{t['sfu_floor_ms']:.4f} ms; reckoned, not measured: this design's passes move "
        f"{design} bytes ({design / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s) and form "
        f"{design_exps} exponentials ({design_exps / SFU_EXP2_PER_S * 1e3:.4f} ms); grid "
        f"{grid} blocks, blocks an SM {per_sm}, dynamic shared memory {smem}; registers "
        f"{t['ptxas']}; library: none")
    log_trace("  selective_scan_bwd, 50 calls (traced)", trace, top_n=4)
    del args, dy, states
    torch.cuda.empty_cache()
    return worst, t


def moe_case(torch, md, gen, S, k, E, C, D, dtype):
    """Random routing of S tokens to k distinct experts of E, positions by
    the reference's cumulative sum (later tokens dropped past C), and
    operands: (routing, x [S, D], y [E, C, D], dout [S, D], w [S, k])."""
    dev = torch.device("cuda")
    idx = torch.rand(S, E, generator=gen, device=dev).argsort(-1)[:, :k]
    flat = torch.nn.functional.one_hot(idx, E).reshape(S * k, E)
    pos = ((torch.cumsum(flat, 0) - 1) * flat).sum(-1).reshape(S, k)
    r = md.make_routing(idx, pos, pos < C, E, C)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    w = torch.softmax(torch.randn(S, k, generator=gen, device=dev), -1).to(dtype)
    return r, randn(S, D), randn(E, C, D), randn(S, D), w


def moe_errors(torch, md, r, x, y, dout, w) -> dict:
    """The three kernels against their plain versions: dispatch bit for
    bit; the scaled gather within one rounding of each output; combine (k
    float32 terms in j order against the einsum's (e, c) order) and the
    gate gradient (a float32 dot over D) within one float32 rounding a term
    of the sum of magnitudes plus one rounding of the output; a second call
    of each bit for bit. Returns the largest absolute errors."""
    dtype, D, k = x.dtype, x.shape[1], r.gate_idx.shape[1]
    bits = 7 if dtype == torch.bfloat16 else 23

    def ulps(t):
        return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126))) - bits)

    got = {"gather": md.moe_gather(x, r), "gather_scaled": md.moe_gather(dout, r, w),
           "combine": md.moe_combine(y, r, w), "combine_unit": md.moe_combine(y, r),
           "gate_grad": md.moe_gate_grad(dout, y, r)}
    want = {"gather": md.moe_gather_ref(x, r), "gather_scaled": md.moe_gather_ref(dout, r, w),
            "combine": md.moe_combine_ref(y, r, w), "combine_unit": md.moe_combine_ref(y, r),
            "gate_grad": md.moe_gate_grad_ref(dout, y, r)}
    yabs = y.float().abs()
    bound = {"gather": torch.zeros_like(want["gather"], dtype=torch.float32),
             "gather_scaled": ulps(want["gather_scaled"]),
             "combine": k * 2.0 ** -23 * md.moe_combine_ref(yabs, r, w.float().abs())
             + ulps(want["combine"]),
             "combine_unit": k * 2.0 ** -23 * md.moe_combine_ref(yabs, r)
             + ulps(want["combine_unit"]),
             "gate_grad": D * 2.0 ** -23 * md.moe_gate_grad_ref(dout.float().abs(), yabs, r)
             + ulps(want["gate_grad"])}
    torch.cuda.synchronize()
    errs = {}
    for name, g in got.items():
        diff = (g.float() - want[name].float()).abs()
        require(g.dtype == dtype and g.shape == want[name].shape, f"moe {name}: dtype or shape")
        require(bool((diff <= bound[name]).all()),
                f"moe {name} differs from its plain version beyond its bound at S {x.shape[0]}, "
                f"C {r.capacity}, D {D}, {dtype}: max {diff.max().item():.3g}")
        errs[name] = diff.max().item()
    require(bool((got["gate_grad"][~r.keep] == 0).all()), "moe_gate_grad: a dropped choice's "
            "gradient is not 0")
    again = {"gather": md.moe_gather(x, r), "gather_scaled": md.moe_gather(dout, r, w),
             "combine": md.moe_combine(y, r, w), "combine_unit": md.moe_combine(y, r),
             "gate_grad": md.moe_gate_grad(dout, y, r)}
    require(all(torch.equal(got[n], again[n]) for n in got),
            "moe kernels: two calls on the same inputs give different bits")
    return errs


def moe_bytes(r, D: int, elt: int) -> dict:
    """Bytes each kernel must move at this routing: each input read once
    (the combine and the gate gradient read only the kept rows of y), each
    output written once, the index maps as int32."""
    S, k = r.gate_idx.shape
    n_slots, kept = r.num_experts * r.capacity, int(r.keep.sum())
    return {"moe_gather": S * D * elt + n_slots * 4 + n_slots * D * elt,
            "moe_gather_scaled": S * D * elt + n_slots * 4 + S * k * elt + n_slots * D * elt,
            "moe_combine": kept * D * elt + S * k * (4 + elt) + S * D * elt,
            "moe_gate_grad": S * D * elt + kept * D * elt + S * k * 4 + S * k * elt}


# The moe kernels' shapes at granite-moe-1b-a400m's widths (S tokens, k, E,
# C, D): a training layer's microbatch, the serving prefill of phase 13
# (capacity 2560, past the dropless limit) and one decode step (4 tokens,
# dropless).
MOE_SHAPES = {"training": (MOE_TRAIN_TOKENS, 8, 32, 640, 1024),
              "prefill": (LM_BATCH * LM_PROMPT, 8, 32, 2560, 1024),
              "decode": (LM_BATCH, 8, 32, LM_BATCH, 1024)}


def moe_library(torch, r, x, y, w) -> dict:
    """One PyTorch call of each kernel's function at this routing (unused by
    the port): ``index_select`` of the slots' token rows for the dispatch
    (it leaves no zero rows for empty slots) and ``embedding_bag`` with
    per-sample weights for the combine."""
    k = r.gate_idx.shape[1]
    tok = (r.slot.long() // k).clamp_min(0)
    bag = r.row.long().clamp_min(0)
    yflat = y.reshape(-1, y.shape[-1])
    wk = w * r.keep.to(w.dtype)
    return {"moe_gather": lambda: torch.index_select(x, 0, tok),
            "moe_combine": lambda: torch.nn.functional.embedding_bag(
                bag, yflat, mode="sum", per_sample_weights=wk)}


def moe_plans(md, S, k, E, C, D, dtype) -> dict:
    """The grids the dispatch, the scaled gather and the combine launch at a
    shape, each logged with its warps an SM."""
    plans = {}
    for name, rows in (("gather", E * C), ("gather_scaled", E * C), ("combine", S)):
        p = md.launch_plan(name, rows, D, k, dtype)
        plans[name] = p
        what = "warps a token" if name == "combine" else "warp a slot row"
        log(f"  moe {name} launch at S {S} C {C}: {p['blocks']} blocks of {md.WARPS} warps "
            f"({p['warps_per_sm']:.2f} warps an SM of {p['sms']}; at most {p['blocks_per_sm']} "
            f"blocks fit on one), {p['tasks']} warp tasks, {p['per']} {what}")
    return plans


def phase_moe_kernels(torch, md, logs: dict):
    """Phase 12c: the moe family's dispatch, combine and gate-gradient
    kernels (``csrc/moe_dispatch.cu``) against their plain versions (the
    reference's one-hot einsums) at granite-moe-1b-a400m's training, prefill
    and decode shapes (``MOE_SHAPES``), at a ragged shape with heavy drops
    (S 300, C 40) and at the scalar path's width (D 100, k 3), in bf16 and
    float32: ``moe_errors``' checks and a second call bit for bit; no
    spills. Then, in bf16, each launch's grid and warps an SM, and at each
    of the three shapes the kernels' times, bounds and one PyTorch call of
    the same function (``moe_library``), from CUDA graphs over operand sets
    that together move four times the L2 cache (``graph_ms``,
    ``cold_copies``) and called eagerly; at the training shape also the
    plain versions' times and the gate gradient's (at the prefill shape the
    plain one-hot would be 10.7 GB a layer and is not timed), and the
    routing's cumulative sum for the positions in two layouts."""
    for entry, regs, spills in ptxas_entries(logs.get("moe_dispatch", "")):
        log(f"  moe_dispatch: {entry}: {regs}; {spills}")
        require("0 bytes spill stores" in spills and "0 bytes spill loads" in spills,
                f"{entry} spills registers: {spills}")
    gen = torch.Generator(device="cuda").manual_seed(126)
    worst = {}
    for S, k, E, C, D in (*MOE_SHAPES.values(), (300, 8, 32, 40, 1024), (37, 3, 5, 9, 100)):
        for dtype in (torch.bfloat16, torch.float32):
            case = moe_case(torch, md, gen, S, k, E, C, D, dtype)
            errs = moe_errors(torch, md, *case)
            key = "" if dtype == torch.bfloat16 else "/f32"
            for name, e in errs.items():
                worst[name + key] = max(worst.get(name + key, 0.0), e)
            log(f"moe kernels S {S} k {k} E {E} C {C} D {D} {dtype}: {int(case[0].keep.sum())} "
                f"of {S * k} choices kept; dispatch bit for bit, max abs errors "
                f"{ {n: float(f'{e:.3g}') for n, e in errs.items()} }, two calls bit for bit")
            del case
            torch.cuda.empty_cache()
    times = {"moe_gather": {}, "moe_combine": {}, "moe_gate_grad": {}}
    for shape, (S, k, E, C, D) in MOE_SHAPES.items():
        r, x, y, dout, w = moe_case(torch, md, gen, S, k, E, C, D, torch.bfloat16)
        plans = moe_plans(md, S, k, E, C, D, torch.bfloat16)
        nbytes = moe_bytes(r, D, 2)
        # Operand sets for timing from HBM: the routing maps (at most 80 KB)
        # are shared and stay in L2, as they do after the routing's kernels.
        sets = cold_copies(torch, (x, y, dout, w), min(nbytes.values()))
        flops = {"moe_gather": 0, "moe_combine": 2 * int(r.keep.sum()) * D,
                 "moe_gate_grad": 2 * int(r.keep.sum()) * D}
        kern = {"moe_gather": lambda x, y, dout, w: md.moe_gather(x, r),
                "moe_combine": lambda x, y, dout, w: md.moe_combine(y, r, w),
                "moe_gate_grad": lambda x, y, dout, w: md.moe_gate_grad(dout, y, r)}
        library = [moe_library(torch, r, op[0], op[1], op[3]) for op in sets]
        for name, call in kern.items():
            if name == "moe_gate_grad" and shape != "training":
                continue
            fns = [lambda op=op: call(*op) for op in sets]
            lib_fns = [lib[name] for lib in library] if name in library[0] else None
            # The kernel's device time: calls replayed from a CUDA graph over
            # operand sets that do not fit in L2, in turns with the library
            # call. Beside it the wrapper called eagerly (``ms``), whose host
            # dispatch (checks, allocation, the stream) outlasts a kernel of
            # a few tens of microseconds.
            g = [graph_ms(torch, fns)]
            lg = [graph_ms(torch, lib_fns), graph_ms(torch, lib_fns)] if lib_fns else []
            g.append(graph_ms(torch, fns))
            t = {"graph_ms": sum(g) / 2, "graph_ms_readings": g, "cold_sets": len(sets),
                 "library_graph_ms": sum(lg) / 2 if lg else None,
                 "library_graph_ms_readings": lg}
            if shape == "training":
                plain = {"moe_gather": lambda: md.moe_gather_ref(x, r),
                         "moe_combine": lambda: md.moe_combine_ref(y, r, w),
                         "moe_gate_grad": lambda: md.moe_gate_grad_ref(dout, y, r)}[name]
                t.update(timed(torch, fns[0], plain, iters=50, plain_iters=5))
            else:
                e = [cuda_ms(torch, fns[0], 50), cuda_ms(torch, fns[0], 50)]
                t.update(ms=sum(e) / 2, ms_readings=e)
            t["library_ms"] = cuda_ms(torch, lib_fns[0], 50) if lib_fns else None
            t.update(cost_bound({"moe_gather": lambda: md.moe_gather_cost(x, r),
                                 "moe_combine": lambda: md.moe_combine_cost(y, r, w),
                                 "moe_gate_grad": lambda: md.moe_gate_grad_cost(dout, y, r)}[
                                     name](), nbytes[name], flops[name], F32_FLOPS_PER_S, name))
            t.update(bound_share=t["bound_ms"] / t["ms"],
                     graph_bound_share=t["bound_ms"] / t["graph_ms"],
                     plan=plans.get(name.removeprefix("moe_")))
            if shape == "training":
                times[name].update(t)
            else:
                times[name][f"{shape}_shape"] = t
            log(f"{name} at the {shape} shape (S {S} k {k} E {E} C {C} D {D} bf16): kernel "
                f"{t['graph_ms']:.4f} ms from a graph over {len(sets)} operand sets "
                f"{t['graph_ms_readings']} ({t['ms']:.4f} called eagerly), plain "
                f"{t.get('plain_ms', 'not timed')}, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}; {nbytes[name]} bytes; bound share "
                f"{t['graph_bound_share']:.3f} from the graph), library "
                f"{t['library_graph_ms']} from a graph ({t['library_ms']} eagerly)")
        if shape == "training":
            scaled = [lambda op=op: md.moe_gather(op[2], r, op[3]) for op in sets]
            g = times["moe_gather"]
            g["scaled_graph_ms"] = (graph_ms(torch, scaled) + graph_ms(torch, scaled)) / 2
            g["scaled_ms"] = cuda_ms(torch, scaled[0], 50)
            g["scaled_bound_ms"] = nbytes["moe_gather_scaled"] / HBM_BYTES_PER_S * 1e3
            g["scaled_plan"] = plans["gather_scaled"]
            log(f"moe_gather with the gates as the scale (the combine's backward): "
                f"{g['scaled_graph_ms']:.4f} ms from a graph ({g['scaled_ms']:.4f} eagerly), "
                f"bound {g['scaled_bound_ms']:.4f} ms")
        del r, x, y, dout, w, library, kern, sets
        torch.cuda.empty_cache()
    # The routing's positions (``models/moe.py::route``): PyTorch's
    # cumulative sum along the outer dim of the reference's [S k, E]
    # one-hot, against the last dim of the [E, S k] copy the port scans.
    scans = {}
    for S in (MOE_TRAIN_TOKENS, LM_BATCH * LM_PROMPT):
        idx = torch.rand(S, 32, generator=gen, device="cuda").argsort(-1)[:, :8]
        flat = torch.nn.functional.one_hot(idx.reshape(-1), 32)
        scans[S] = {"outer_dim_ms": cuda_ms(torch, lambda: torch.cumsum(flat, 0), 10),
                    "last_dim_with_copy_ms": cuda_ms(
                        torch, lambda: torch.cumsum(flat.t().contiguous(), 1), 10)}
    times["moe_gather"]["positions_scan"] = scans
    log(f"routing positions, cumulative sum of the int64 one-hot of S x 8 choices over 32 "
        f"experts (S: ms): along the outer dim of [S 8, 32] "
        f"{ {S: round(v['outer_dim_ms'], 4) for S, v in scans.items()} }, along the last dim "
        f"of an [32, S 8] copy (copy included) "
        f"{ {S: round(v['last_dim_with_copy_ms'], 4) for S, v in scans.items()} }")
    torch.cuda.empty_cache()
    return worst, times


def scan_bwd_oracle(torch, r, k, v, logw, u, s0, do, d_final):
    """The scan's gradients by their definition, token by token in float64
    on the card, over all (b, h) at once: with G_t the gradient of the state
    after token t (G_T = d_final, G_{t-1} = r_t do_t^T + diag(w_t) G_t),
    dr_t = S_{t-1} do_t + (u k_t)(v_t . do_t), dk_t = G_t v_t +
    (u r_t)(v_t . do_t), dv_t = G_t^T k_t + (r_t . u k_t) do_t,
    dlogw_t = w_t sum_j S_{t-1} G_t, du = sum (r k)(v . do), dstate = G_0."""
    f64 = torch.float64
    r, k, v, logw, do = (a.to(f64).transpose(1, 2) for a in (r, k, v, logw, do))  # [B, H, T, Dh]
    u = u.to(f64)
    B, H, T, Dh = r.shape
    S = s0.to(f64).clone()
    before = torch.empty((T, B, H, Dh, Dh), dtype=f64, device=r.device)
    for t in range(T):
        before[t] = S
        S = torch.exp(logw[:, :, t])[..., None] * S + k[:, :, t, :, None] * v[:, :, t, None, :]
    G = (torch.zeros_like(S) if d_final is None else d_final.to(f64).clone())
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in reversed(range(T)):
        rt, kt, vt, dt_ = r[:, :, t], k[:, :, t], v[:, :, t], do[:, :, t]
        wt, vd = torch.exp(logw[:, :, t]), (vt * dt_).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhde,bhe->bhd", before[t], dt_) + u * kt * vd
        dk[:, :, t] = torch.einsum("bhde,bhe->bhd", G, vt) + u * rt * vd
        dv[:, :, t] = (torch.einsum("bhde,bhd->bhe", G, kt)
                       + (rt * u * kt).sum(-1, keepdim=True) * dt_)
        dlogw[:, :, t] = wt * (before[t] * G).sum(-1)
        du += (rt * kt * vd).sum(0)
        G = rt[..., :, None] * dt_[..., None, :] + wt[..., None] * G
    del before
    return [a.transpose(1, 2) for a in (dr, dk, dv, dlogw)] + [du, G]


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at magnitude x."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8)


def scan_bwd_errors(got, want, dtype, ulps: float) -> dict:
    """Each gradient's max abs error and its error over its largest entry,
    required within 5e-6 of that entry (dlogw 2e-5: its per-chunk suffix
    sums of r dr' and k dk' cancel to a value far below their terms; see
    tests/test_torch_ssm_train.py), plus, for bf16 dr/dk/dv, ``ulps`` bf16
    ulps of the largest entry (each side rounds its own float32 value: half
    an ulp against an exact value, one between two roundings)."""
    out = {}
    for i, (name, g, w) in enumerate(zip(("dr", "dk", "dv", "dlogw", "du", "dstate"), got, want)):
        scale = w.double().abs().max().item()
        err = (g.double() - w.double()).abs().max().item()
        allow = (2e-5 if name == "dlogw" else 5e-6) * scale
        if dtype != "float32" and i < 3:
            allow += ulps * bf16_ulp(scale)
        require(err <= allow, f"rwkv6_scan_bwd {name}: max abs err {err:.3g} over {allow:.3g} "
                              f"(largest entry {scale:.3g})")
        out[name] = {"max_abs_err": err, "of_largest": err / scale}
    return out


def scan_bwd_pass_bytes(B: int, T: int, H: int, Dh: int, C: int, elt: int,
                        d_final: bool) -> dict:
    """Bytes each pass of ``csrc/rwkv6_scan_bwd.cu`` moves, each array it
    reads or writes counted once a pass (``elt``: bytes of an r/k/v
    element): A' reads r, do, logw and writes dG and the log-decays; B'
    reads them (and d_final) and writes Gend over dG and dstate; C' reads
    r, k, v, logw, do, u and three states a chunk (S_c, Gend, Send) and
    writes dr, dk, dv, dlogw and the du partials; D' sums those."""
    nc = -(-T // C)
    n, st, per = B * T * H * Dh, nc * B * H * Dh * Dh * 4, nc * B * H * Dh * 4
    state = B * H * Dh * Dh * 4
    return {"A'": n * elt + 2 * n * 4 + st + per,
            "B'": st + per + (state if d_final else 0) + st + state,
            "C'": 3 * n * elt + 2 * n * 4 + H * Dh * 4 + 3 * st + 3 * n * elt + n * 4 + per,
            "D'": per + H * Dh * 4}


def phase_scan_backward(torch, rs, logs: dict):
    """Phase 12b: the scan's backward kernel (``csrc/rwkv6_scan_bwd.cu``) on
    the forward kernel's saved chunk states, at rwkv6-1.6b's training shape
    [1, 2048, 32, 64] (C = 64) in bfloat16 and float32 against
    ``rwkv6_scan_bwd_ref``, the final state's gradient None as in training;
    a ragged T (1100) with a nonzero final-state gradient and state; strong
    decays (logw down to -20) against the float64 definition; a second call
    bit for bit; then kernel, plain and bound times and a trace of 200
    calls (each of its four kernels)."""
    dev = torch.device("cuda")
    B, T, H, Dh, C = LM_TRAIN_BATCH, LM_TRAIN_SEQ, 32, 64, 64
    gen = torch.Generator(device=dev).manual_seed(12)

    def inputs(T_, dtype, strong=False, d_final=False):
        r, k, v, do = (torch.randn(B, T_, H, Dh, generator=gen, device=dev) for _ in range(4))
        logw = (-20.0 * torch.rand(B, T_, H, Dh, generator=gen, device=dev) if strong else
                -torch.exp(-1.0 + torch.tanh(torch.randn(B, T_, H, Dh, generator=gen, device=dev))))
        u = 0.5 * torch.randn(H, Dh, generator=gen, device=dev)
        s0 = torch.randn(B, H, Dh, Dh, generator=gen, device=dev)
        dfin = torch.randn(B, H, Dh, Dh, generator=gen, device=dev) if d_final else None
        return tuple(a.to(dtype) for a in (r, k, v)) + (logw, u, s0, do, dfin)

    def run(args, saved=None):
        return rs.rwkv6_scan_bwd(*args, chunk=C, saved=saved)

    checks = {}
    for tag, T_, dtype, strong, dfin in (("train/bf16", T, torch.bfloat16, False, False),
                                         ("train/f32", T, torch.float32, False, False),
                                         ("ragged/bf16", 1100, torch.bfloat16, False, True),
                                         ("ragged/f32", 1100, torch.float32, False, True),
                                         ("strong/bf16", T, torch.bfloat16, True, True)):
        args = inputs(T_, dtype, strong, dfin)
        got, again = run(args), run(args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"rwkv6_scan_bwd ({tag}): a second call gave other bits")
        require([g.dtype for g in got] == [args[0].dtype] * 3 + [torch.float32] * 3,
                f"rwkv6_scan_bwd ({tag}): gradient dtypes {[g.dtype for g in got]}")
        name = str(dtype).removeprefix("torch.")
        if strong:
            want = scan_bwd_oracle(torch, *args)
            checks[tag] = {"against": "float64 definition",
                           **scan_bwd_errors(got, want, name, 0.5)}
            ref = rs.rwkv6_scan_bwd_ref(*args, chunk=C)
            checks[tag + "/plain"] = {"against": "float64 definition",
                                      **scan_bwd_errors(ref, want, name, 0.5)}
        else:
            want = rs.rwkv6_scan_bwd_ref(*args, chunk=C)
            checks[tag] = {"against": "rwkv6_scan_bwd_ref",
                           **scan_bwd_errors(got, want, name, 1.0)}
        log(f"rwkv6_scan_bwd {tag} [{B},{T_},{H},{Dh}] C={C}"
            f"{', logw in (-20, 0]' if strong else ''}{', dS_final and state nonzero' if dfin else ''}"
            f": two calls bit-identical; against {checks[tag]['against']}: "
            + ", ".join(f"{n} {e['max_abs_err']:.3g} ({e['of_largest']:.2g} of its largest)"
                        for n, e in checks[tag].items() if n != "against"))
        if strong:
            log("  its plain version against the same definition: " + ", ".join(
                f"{n} {e['of_largest']:.2g}" for n, e in checks[tag + "/plain"].items()
                if n != "against"))
        del got, again, want, args
    torch.cuda.empty_cache()
    # Times at the training shape in the model's dtypes, on the saved states.
    args = inputs(T, torch.bfloat16)
    r, k, v, logw, u, s0, do, _ = args
    _, s_fin, states = rs._launch(r, k, v, logw, u, s0, C, B, H, T, Dh, 0)
    t = timed(torch, lambda: run(args, (states, s_fin)),
              lambda: rs.rwkv6_scan_bwd_ref(*args, chunk=C), iters=20, plain_iters=3)
    nc = T // C
    n = r.numel()
    nbytes = (3 * n * 2 + 2 * n * 4 + states.numel() * 4 + s_fin.numel() * 4 + u.numel() * 4
              + 3 * n * 2 + n * 4 + u.numel() * 4 + s_fin.numel() * 4)
    flops = B * H * nc * (8 * C * Dh * Dh + 10 * C * C * Dh)
    t.update(cost_bound(rs.rwkv6_scan_bwd_cost(r, k, v, logw, u, s0, do, chunk=C), nbytes, flops,
                        BF16_FLOPS_PER_S, "rwkv6_scan_bwd"))
    t["f32_operations_ms"] = flops / F32_FLOPS_PER_S * 1e3
    t["tf32x3_operations_ms"] = 3 * flops / TF32_FLOPS_PER_S * 1e3
    t["pass_bytes"] = scan_bwd_pass_bytes(B, T, H, Dh, C, 2, False)
    t["design_bytes"] = sum(t["pass_bytes"].values())
    t["design_bytes_ms"] = t["design_bytes"] / HBM_BYTES_PER_S * 1e3
    from repro_torch.kernels import build
    sb = build.load("rwkv6_scan_bwd")
    t["blocks_per_sm"] = {name: {"bf16": sb.rwkv6_scan_bwd_blocks_per_sm(i, 1),
                                 "float32": sb.rwkv6_scan_bwd_blocks_per_sm(i, 0)}
                          for i, name in enumerate(kernel_names("rwkv6_scan_bwd"))}
    require(t["blocks_per_sm"]["rwkv6_bwd_chunk_out_kernel"]["bf16"] >= 2,
            f"rwkv6_bwd_chunk_out_kernel keeps fewer than two blocks an SM: {t['blocks_per_sm']}")
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t.update(bytes=nbytes, flops=flops, library_ms=None, checks=checks,
             ptxas=[[e, rg, sp] for e, rg, sp in ptxas_entries(logs.get("rwkv6_scan_bwd", ""))],
             library=build.library_path("rwkv6_scan_bwd").name, toolkit=build.toolkit_version(),
             flags=" ".join(build.nvcc_flags("rwkv6_scan_bwd")))
    for e, rg, sp in t["ptxas"]:
        require("0 bytes spill stores" in sp and "0 bytes spill loads" in sp,
                f"{e} spills registers: {sp}")
    # A trace of a few milliseconds this late in the script comes back without
    # device events (phase 12's three calls do); 200 calls take about 50 ms.
    n_traced = 200
    trace = profile_round(torch, lambda: [run(args, (states, s_fin)) for _ in range(n_traced)],
                          host=False)
    t["pass_ms"] = {re.search(r"rwkv6_bwd_\w+", name).group(0): nn["summed"] / n_traced / 1e3
                    for name, nn in trace.get("by_name", {}).items() if "rwkv6_bwd" in name}
    t["fwd_ms"] = cuda_ms(torch, lambda: rs._launch(r, k, v, logw, u, s0, C, B, H, T, Dh, 0),
                          iters=20)
    log(f"rwkv6_scan_bwd [{B},{T},{H},{Dh}] bf16 on the saved states: kernel {t['ms']:.4f} ms "
        f"{t['ms_readings']}, plain {t['plain_ms']:.4f} ms {t['plain_ms_readings']}, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {nbytes} bytes, {flops:.4g} FLOP; float32 "
        f"operations alone {t['f32_operations_ms']:.4f} ms; bound share {t['bound_share']:.3f}); "
        f"the design's passes move {t['design_bytes']} bytes ({t['design_bytes_ms']:.4f} ms at "
        f"HBM rate; by pass {t['pass_bytes']}); its products in 3xTF32 "
        f"{t['tf32x3_operations_ms']:.4f} ms at the TF32 peak; library none; traced per "
        f"call {t['pass_ms'] or 'not measured'}; blocks an SM {t['blocks_per_sm']}; the forward "
        f"kernel at this shape {t['fwd_ms']:.4f} ms; registers "
        f"{[(e, rg, sp) for e, rg, sp in t['ptxas']]}; library {t['library']} built by "
        f"{t['toolkit']} with {t['flags']}")
    log_trace(f"  rwkv6_scan_bwd, {n_traced} calls (traced)", trace, top_n=4)
    del args, r, k, v, logw, u, s0, do, states, s_fin
    torch.cuda.empty_cache()
    errs = {"rwkv6_scan_bwd": max(c[n]["max_abs_err"] for key, c in checks.items()
                                  if key.endswith("bf16") for n in ("dr", "dk", "dv")),
            "rwkv6_scan_bwd/f32": max(c[n]["max_abs_err"] for key, c in checks.items()
                                      if key.endswith("f32") for n in c if n != "against")}
    return errs, t


def serve_launches(fa, rw, ss, md) -> dict:
    """The LM kernels' launch counters, by kernel."""
    return {"flash_attention": fa.flash_attention.launches,
            "rwkv6_scan": rw.rwkv6_scan.launches,
            "selective_scan": ss.selective_scan.launches,
            "moe_gather": md.moe_gather.launches, "moe_combine": md.moe_combine.launches,
            "moe_gate_grad": md.moe_gate_grad.launches}


def serve_stub(torch, np, cfg, batch: int, seed: int) -> dict:
    """The modality stub a request of ``cfg`` brings (float32 on the card,
    from a numpy seed): whisper's 1500 frame embeddings, internvl2's 256
    patch embeddings of width 3200; none for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        shape, key = (batch, cfg.encoder_frames, cfg.d_model), "frames"
    elif cfg.arch_type == "vlm":
        shape, key = (batch, cfg.vision_tokens, cfg.vision_dim), "patches"
    else:
        return {}
    return {key: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()}


def phase_serve(torch, np, arch, counter, prompt: int = LM_PROMPT, layers: int | None = None):
    """Phase 13, (f5), (f6) and (mx): serve the full-width ``arch`` (its
    depth cut to ``layers`` when given) through
    ``generate`` (``prompt`` tokens a request, whisper's frames and
    internvl2's patches beside them): warm-up with 2 tokens, then the main
    path (counts set to 0 just before, read just after), with the launches
    of the prefill recorded apart. ``counter()`` returns the launch counts
    by kernel; the device memory held when the phase starts is logged
    beside the peak; whisper's encoder, run once at admission, is timed
    apart from the prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    bundle = build_model(cfg)
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in tree_leaves(params))
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (LM_BATCH, prompt)).astype(np.int32)).cuda()
    stub = serve_stub(torch, np, cfg, LM_BATCH, 13)
    P = cfg.vision_tokens if "patches" in stub else 0
    in_prefill = []

    def prefill(p, batch, cache):
        out = bundle.prefill(p, batch, cache)
        in_prefill.append(counter())
        return out

    spied = bundle._replace(prefill=prefill)
    serve.generate(spied, params, toks, 2, **stub)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.generate(spied, params, toks, LM_GEN, **stub)
    launches, prefill_launches = counter(), in_prefill[-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logits = res.prefill_logits.float()
    require(tuple(logits.shape) == (LM_BATCH, cfg.vocab_padded), f"{arch}: logits shape")
    require(bool(torch.isfinite(logits).all()), f"{arch}: prefill logits are not finite")
    tok = res.tokens
    require(tuple(tok.shape) == (LM_BATCH, LM_GEN) and int(tok.min()) >= 0
            and int(tok.max()) < cfg.vocab_padded, f"{arch}: generated tokens out of range")
    require(bool(torch.isfinite(res.last_logits.float()).all()),
            f"{arch}: the last decode step's logits are not finite")
    # Traces of one prefill and of one decode step after it (whisper's
    # encoder output computed once before them, as at admission).
    cache = bundle.init_cache(LM_BATCH, P + prompt + 1)
    with torch.no_grad():
        extra = ({"memory": bundle.memory(params, {"frames": stub["frames"]})}
                 if "frames" in stub else {})
        pre = profile_round(torch, lambda: bundle.prefill(
            params, {"tokens": toks, **extra, **{k: v for k, v in stub.items()
                                                 if k == "patches"}}, cache))
        dec = profile_round(torch, lambda: bundle.decode_step(
            params, {"token": tok[:, :1], "index": P + prompt, **extra}, cache))
    del cache, extra
    step_ms = res.decode_ms / (LM_GEN - 1)
    out = {"arch": arch, "params": n_params, "init_s": init_s, "prefill_ms": res.prefill_ms,
           "decode_ms_per_step": step_ms, "prompt": prompt,
           "stub": {k: list(v.shape) for k, v in stub.items()},
           "encode_ms": res.encode_ms if "frames" in stub else None,
           "prefill_tokens_per_s": LM_BATCH * prompt / res.prefill_ms * 1e3,
           "decode_tokens_per_s": LM_BATCH / step_ms * 1e3,
           "tokens_per_s": (LM_BATCH * LM_GEN
                            / (res.encode_ms + res.prefill_ms + res.decode_ms) * 1e3),
           "peak_gb": peak_gb, "init_peak_gb": init_peak_gb, "held_gb": held_gb,
           "launches": launches, "prefill_launches": prefill_launches,
           "prefill_busy_share": pre["busy"] / pre["wall_us"] if pre else None,
           "decode_busy_share": dec["busy"] / dec["wall_us"] if dec else None,
           "sample": tok[0, :8].tolist()}
    with_stub = "".join(f" + {k} {list(v.shape[1:])}" for k, v in stub.items())
    enc = f", encoder at admission {res.encode_ms:.1f} ms" if "frames" in stub else ""
    log(f"serve {arch} ({n_params / 1e9:.2f} B params, init {init_s:.1f} s): batch {LM_BATCH} x "
        f"prompt {prompt}{with_stub}, {LM_GEN} generated: prefill {res.prefill_ms:.1f} ms, "
        f"decode {step_ms:.2f} ms/step{enc}, {out['tokens_per_s']:.1f} generated tokens/s end "
        f"to end, "
        f"peak memory {peak_gb:.2f} GB (init {init_peak_gb:.2f} GB; {held_gb:.2f} GB held "
        f"before the phase); kernel launches {launches} ({prefill_launches} in the prefill); "
        f"tokens[0] {out['sample']}")
    log_trace(f"  {arch} prefill (traced)", pre)
    log_trace(f"  {arch} decode step (traced)", dec)
    del params, res, stub
    torch.cuda.empty_cache()
    return out


def phase_lm_card_vs_cpu(torch, np, convert):
    """Phase 14: reduced float32 models from one set of params on the card
    (kernels) and on the CPU (plain versions)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import build_model

    worst = 0.0
    archs = (("qwen3-14b", {}), ("rwkv6-1.6b", {}), ("qwen2.5-32b", {}),
             ("gemma3-27b", dict(num_layers=7)), ("hymba-1.5b", {}), (MOE_ARCH, {}))
    for arch, over in archs:
        bundle = build_model(get_arch(arch).reduced(**over))
        params = bundle.init(0, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(14).integers(
            0, 256, (2, 37)).astype(np.int32))
        card = generate(bundle, convert.params_from_numpy(convert.to_numpy(params), "cuda"),
                        toks.cuda(), 8)
        cpu = generate(bundle, params, toks, 8)
        gl, cl = card.prefill_logits.cpu(), cpu.prefill_logits
        worst = max(worst, (gl - cl).abs().max().item())
        require(torch.allclose(gl, cl, rtol=1e-4, atol=1e-4),
                f"reduced {arch}: prefill logits differ between card and CPU")
        require(torch.equal(card.tokens.cpu(), cpu.tokens),
                f"reduced {arch}: greedy tokens differ between card and CPU")
    log(f"card vs CPU, reduced {', '.join(a for a, _ in archs)} (f32, gemma3 at 7 layers, one "
        f"global; 37 prompt tokens, past the reduced window of 16): prefill logits within "
        f"rtol/atol 1e-4 (max abs diff {worst:.3g}), 8 greedy tokens equal")


def phase_lm_backward(torch, fa):
    """Phase 15: the attention backward (and the forward's row statistics)
    against their plain versions at the training shapes, the autograd
    Function on the card against the plain versions on the CPU at a reduced
    shape, then the backward's time against its bound, its plain version and
    the backward of ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    B, T, H, Kv, Dh = LM_TRAIN_BATCH, LM_TRAIN_SEQ, 32, 2, 128   # glm4-9b's attention
    q32, k32, v32, do32 = randn(B, T, H, Dh), randn(B, T, Kv, Dh), randn(B, T, Kv, Dh), \
        randn(B, T, H, Dh)
    errs = {}

    def check(q32, k32, v32, do32, dt, tag, case):
        """The forward with statistics and the backward against their plain
        versions at one shape, in dtype ``dt``."""
        b, t, h, dh = q32.shape
        kv = k32.shape[2]
        q, k, v, do = (a.to(dt) for a in (q32, k32, v32, do32))
        o, m, l = fa.flash_attention(q, k, v, return_stats=True)
        wo, wm, wl = fa.flash_attention_ref(q.float(), k.float(), v.float(), block=64,
                                            return_stats=True)
        em = (m - wm).abs().max().item()
        el = ((l - wl).abs() / wl).max().item()
        # The statistics to float32 rounding (bf16: the base-2 exponentials
        # of the tensor-core kernel): |dm| <= 1e-5, |dl| / l <= 1e-5.
        require(em <= 1e-5 and el <= 1e-5, f"flash_attention {tag} row statistics differ at "
                f"{case}: max |dm| {em}, max |dl|/l {el}")
        # The output as in phase 12: within 5e-5 of the plain version in
        # float32 (bf16: plus half an ulp, the output's own rounding).
        half_ulp = 2.0 ** -8 if dt == torch.bfloat16 else 0.0
        eo = (o.float() - wo).abs()
        errs[f"{tag}/o"] = eo.max().item()
        eo = (eo - half_ulp * wo.abs()).max().item()
        require(eo < 5e-5, f"flash_attention {tag} output differs from its plain version at "
                f"{case} by {eo} beyond {'half an ulp' if half_ulp else 'nothing'}")
        del wo
        got = fa.flash_attention_bwd(q, k, v, o, do, m, l)
        again = fa.flash_attention_bwd(q, k, v, o, do, m, l)
        want = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                          do.float(), m, l, block=512)
        torch.cuda.synchronize()
        # No atomics: a second call on the same inputs gives the same bits.
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash_attention_bwd {tag}: two calls on the same inputs differ at {case}")
        del again
        worst = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = w.abs().max().item()
            excess = (g.float() - w).abs()
            if dt == torch.bfloat16:
                excess = excess - 2.0 ** -8 * w.abs()     # the output's rounding to bf16
            rel = excess.max().item() / scale
            worst = max(worst, rel)
            # float32 rounding: within 1e-5 of the gradient's largest entry.
            require(rel <= 1e-5, f"flash_attention_bwd {tag} {name} differs from its plain "
                    f"version at {case}: {rel} of max |{name}| {scale}")
            errs[f"{tag}/{name}"] = (g.float() - w).abs().max().item()
        log(f"flash_attention_bwd {tag} ({case}) q [{b},{t},{h},{dh}] k/v [{b},{t},{kv},{dh}] "
            f"causal: max abs err dq {errs[f'{tag}/dq']:.3g} dk {errs[f'{tag}/dk']:.3g} dv "
            f"{errs[f'{tag}/dv']:.3g} (worst beyond the output rounding: {worst:.3g} of the "
            f"largest entry); forward max |do| {errs[f'{tag}/o']:.3g}, statistics max |dm| "
            f"{em:.3g}, max |dl|/l {el:.3g}")

    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        check(q32, k32, v32, do32, dt, tag, "glm4-9b")
    # The training calls of (z1)/(z2) and (z3) in bf16, the training dtype:
    # whisper's decoder self-attention (MHA at head size 64, 2048 tokens)
    # and internvl2's (6 query heads a kv head, 256 patches before 2048
    # tokens).
    for arch, t in ((AUDIO_ARCH, LM_TRAIN_SEQ),
                    (VLM_ARCH, get_arch(VLM_ARCH).vision_tokens + LM_TRAIN_SEQ)):
        c = get_arch(arch)
        h, kv, dh = c.num_heads, c.num_kv_heads, c.d_head
        check(randn(1, t, h, dh), randn(1, t, kv, dh), randn(1, t, kv, dh), randn(1, t, h, dh),
              torch.bfloat16, f"bf16/{arch}", arch)
    errs["flash_attention_bwd"] = max(errs[f"{tag}/{n}"] for n in ("dq", "dk", "dv")
                                      for tag in ("bf16", f"bf16/{AUDIO_ARCH}",
                                                  f"bf16/{VLM_ARCH}"))
    errs["flash_attention_bwd/f32"] = max(errs[f"f32/{n}"] for n in ("dq", "dk", "dv"))

    # The Function on the card against the plain versions on the CPU.
    cpu = [randn(*s).cpu() for s in ((1, 300, 8, 64), (1, 300, 2, 64), (1, 300, 2, 64),
                                     (1, 300, 8, 64))]
    outs = {}
    for d in ("cuda", "cpu"):
        q, k, v = (a.to(d).requires_grad_() for a in cpu[:3])
        o = fa.FlashAttention.apply(q, k, v, True, 0, 0, 64)
        o.backward(cpu[3].to(d))
        outs[d] = [t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)]
    fn_err = max((a - b).abs().max().item() for a, b in zip(outs["cuda"], outs["cpu"]))
    require(fn_err < 5e-5, f"FlashAttention on the card differs from the CPU by {fn_err}")
    log(f"FlashAttention (autograd) f32 [1,300,8,64] / [1,300,2,64]: card vs CPU o, dq, dk, dv "
        f"within {fn_err:.3g} (< 5e-5)")

    # Times at the training shape in bf16 (the model's dtype).
    q, k, v, do = (a.bfloat16() for a in (q32, k32, v32, do32))
    o, m, l = fa.flash_attention(q, k, v, return_stats=True)
    bwd = timed(torch, lambda: fa.flash_attention_bwd(q, k, v, o, do, m, l),
                lambda: fa.flash_attention_bwd_ref(q, k, v, o, do, m, l), iters=10, plain_iters=3)
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    except TypeError:           # a PyTorch without enable_gqa: the kv heads expanded
        kt, vt = (a.repeat_interleave(H // Kv, dim=1).detach().requires_grad_()
                  for a in (kt, vt))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    bwd["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10, warmup=2)
    del out
    pairs = B * H * causal_pairs(T, T)
    nbytes = (4 * q.numel() + 2 * k.numel()) * 2 + 2 * k.numel() * 2 + 2 * m.numel() * 4
    bwd.update(cost_bound(fa.flash_attention_bwd_cost(q, k, v, o, do, m, l), nbytes,
                          10 * Dh * pairs, BF16_FLOPS_PER_S, "flash_attention_bwd"))
    bwd.update(pairs=pairs)
    bwd["bound_share"] = bwd["bound_ms"] / bwd["ms"]
    fwd_off = cuda_ms(torch, lambda: fa.flash_attention(q, k, v), iters=20)
    fwd_on = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, return_stats=True), iters=20)
    log(f"flash_attention_bwd bf16: kernel {bwd['ms']:.4f} ms {bwd['ms_readings']}, plain "
        f"{bwd['plain_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}; "
        f"{nbytes} bytes, {bwd['flops']:.4g} FLOP, {pairs} live pairs; bound share "
        f"{bwd['bound_share']:.3f}), SDPA backward {bwd['library_ms']:.4f} ms; forward at this "
        f"shape {fwd_off:.4f} ms (statistics on: {fwd_on:.4f} ms)")
    trace = profile_round(torch, lambda: [fa.flash_attention_bwd(q, k, v, o, do, m, l)
                                          for _ in range(3)])
    log_trace("  flash_attention_bwd, three calls (traced)", trace, top_n=4)
    # Each launch's device time a call, from the trace (summed over its three calls).
    bwd["pass_ms"] = {re.search(r"flash_bwd_\w+", name).group(0): n["summed"] / 3e3
                      for name, n in (trace or {}).get("by_name", {}).items()
                      if "flash_bwd" in name}
    bwd["busy_ms"] = trace["busy"] / 3e3 if trace else None
    # The host's share: wall time to enqueue a call (wrapper, tensor maps,
    # launches) with the card idle, no synchronisation inside.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fa.flash_attention_bwd(q, k, v, o, do, m, l)
    bwd["enqueue_ms"] = (time.perf_counter() - t0) * 1e2
    torch.cuda.synchronize()
    log(f"  flash_attention_bwd bf16, ms a call by launch (traced): "
        f"{bwd['pass_ms'] or 'not measured'}; device busy {bwd['busy_ms']} ms a call; the "
        f"host enqueues a call in {bwd['enqueue_ms']:.4f} ms")
    bwd["fwd_train_ms"], bwd["fwd_train_stats_ms"] = fwd_off, fwd_on
    del q, k, v, do, o, m, l, qt, kt, vt, q32, k32, v32, do32
    torch.cuda.empty_cache()
    return errs, bwd


def lm_train_launches(cfg, n_update: int, rounds: int = 1) -> dict:
    """The kernel launches one LM training round must make: every layer of
    every replica and microbatch runs its sequence mixer's forward (twice
    under remat: the forward and its recompute in the backward pass) and its
    backward once -- the flash forward and the flash backward's three
    kernels (dense, moe), or the scan's three kernels and its backward's four
    (ssm); a moe layer's dispatch (``moe_gather``) and combine
    (``moe_combine``) run in each forward, and its backward runs the
    combine's two (``moe_gather`` for the experts' rows, ``moe_gate_grad``)
    and the dispatch's (``moe_combine``); the fused update launches once per
    leaf (tree) or dtype buffer (flat) per local step; a hybrid layer runs
    the selective scan's forward beside the flash forward and its backward's
    four kernels beside the flash backward's three."""
    from repro_torch.kernels import ssm_scan as ss

    G, K = LM_TRAIN_LEVELS
    passes = rounds * LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * G * K * cfg.num_layers
    forwards = passes * (2 if cfg.remat else 1)
    ssm, moe = cfg.arch_type == "ssm", cfg.arch_type == "moe"
    hybrid = cfg.arch_type == "hybrid"
    return {"flash_attention": 0 if ssm else forwards,
            "flash_attention_bwd": 0 if ssm else 3 * passes,
            "rwkv6_scan": 3 * forwards if ssm else 0,
            "rwkv6_scan_bwd": 4 * passes if ssm else 0,
            "mtgc_update_flat": rounds * LM_TRAIN_E * LM_TRAIN_H * n_update,
            "mtgc_update": 0, "selective_scan": forwards if hybrid else 0,
            "selective_scan_bwd": ss.BWD_LAUNCHES * passes if hybrid else 0,
            "moe_gather": forwards + passes if moe else 0,
            "moe_combine": forwards + passes if moe else 0,
            "moe_gate_grad": passes if moe else 0}


def check_update_on_state(torch, mu, state, lr: float, g_scale: float) -> dict:
    """``mtgc_update_flat`` at the training path's own shapes: on every leaf
    of the trained bf16 state (x, z, y; the flat layout's one [G, K, N]
    buffer) with a random g and the path's ``g_scale``, in place on a copy of
    x as the fused step runs it, with no mask and with one that freezes
    replica (1, 0). The update is element-wise, so each column slice of the
    result must equal the plain version on that slice: within one bf16 ulp
    (phase 2's tolerance), and a frozen replica keeps its exact bits. Slices
    at both ends of each row and, where the leaf has more elements, one
    around element 2^31 (the 64-bit offsets)."""
    from repro_torch.core.tree import tree_leaves

    G, K = LM_TRAIN_LEVELS
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    freeze = torch.ones(G, K, device=dev)
    freeze[1, 0] = 0.0
    span = 1 << 16
    res = {"slices": 0, "past_2_31": 0, "bit_exact": True, "max_abs_err": 0.0}
    for x, z, y in zip(tree_leaves(state.params), tree_leaves(state.z), tree_leaves(state.y)):
        x3, z3, y2 = x.view(G, K, -1), z.view(G, K, -1), y.view(G, -1)
        N = x3.shape[-1]
        L = min(span, N)
        starts = {0, N - L}
        if x3.numel() > 2 ** 31:
            r, c = divmod(2 ** 31, N)
            starts.add(max(0, min(c - L // 2, N - L)))
        g = torch.empty_like(x3)
        for row in g.view(G * K, N):             # rows below 2^31 elements each
            row.normal_(generator=gen)
        for mask in (None, freeze):
            out = x3.clone()
            mu.mtgc_update_flat(out, g, z3, y2, mask, lr=lr, g_scale=g_scale, out=out)
            for a in sorted(starts):
                sl = slice(a, a + L)
                want = mu.mtgc_update_flat_ref(x3[:, :, sl], g[:, :, sl], z3[:, :, sl],
                                               y2[:, sl], mask, lr, g_scale).float()
                got = out[:, :, sl].float()
                err = (got - want).abs()
                require((err - 2.0 ** -8 * want.abs()).max().item() <= 0.0,
                        f"mtgc_update_flat on the training state {tuple(x3.shape)} differs "
                        f"from its plain version at columns {a}:{a + L} (mask={mask is not None})")
                res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
                res["bit_exact"] &= bool(torch.equal(got, want))
                res["slices"] += 1
                res["past_2_31"] += int((G * K - 1) * N + a + L > 2 ** 31)
            if mask is not None:
                require(torch.equal(out[1, 0], x3[1, 0]),
                        f"a frozen replica changed in place on {tuple(x3.shape)}")
            del out
        del g
    require(res["past_2_31"] > 0, "no slice of the update check lay past element 2^31")
    torch.cuda.empty_cache()
    return res


class UploadRecorder:
    """Stands in for ``ops.int8_roundtrip`` and ``ops.topk_mask`` during one
    round: each call goes to the real wrapper (which launches the kernel and
    counts it), and the recorder keeps, of the first ``keep`` calls, the
    row parameter and the first and last ``UPLOAD_SPAN`` columns of the
    block's operands and result; with ``rows`` set, also the whole of row 0
    of the first two full-width blocks (``row0``), and a host copy of every
    ``topk_mask`` block's operands (``topk_blocks``) for timing each launch
    again."""

    def __init__(self, ops, keep: int, rows: bool = False):
        self.ops, self.keep, self.rows = ops, keep, rows
        self.real = (ops.int8_roundtrip, ops.topk_mask)
        self.calls, self.row0, self.topk_blocks = [], [], []

    def _record(self, name, u, param, noise, out):
        if len(self.calls) < self.keep:
            L = min(UPLOAD_SPAN, u.shape[1])
            cols = sorted({0, u.shape[1] - L})
            self.calls.append({"name": name, "width": u.shape[1], "param": param.clone(),
                               "slices": [(a, u[:, a:a + L].clone(),
                                           None if noise is None else noise[:, a:a + L].clone(),
                                           out[:, a:a + L].clone()) for a in cols]})
        if self.rows and len(self.row0) < 2 and u.shape[1] == self.full:
            self.row0.append(u[0].clone())

    def __enter__(self):
        from repro_torch.core import compression as cmp

        self.full = cmp._CHUNK
        int8, topk = self.real

        def int8_spy(u, scale, noise):
            out = int8(u, scale, noise)
            self._record("int8_roundtrip", u, scale, noise, out)
            return out

        def topk_spy(u, thresh):
            out = topk(u, thresh)
            self._record("topk_mask", u, thresh, None, out)
            if self.rows:
                self.topk_blocks.append((u.cpu(), thresh.cpu()))
            return out

        self.ops.int8_roundtrip, self.ops.topk_mask = int8_spy, topk_spy
        return self

    def __exit__(self, *exc):
        self.ops.int8_roundtrip, self.ops.topk_mask = self.real


def check_uploads(torch, qz, rec: UploadRecorder, offsets) -> dict:
    """The quantize kernels on the training path's own uploads: every
    recorded column slice of a block the round launched a kernel on, held
    bit for bit (NaN for NaN) against the kernel's plain version with the
    block's own scale/threshold and noise. Each slice of an int8 block also
    goes through ``topk_mask`` against its plain version, with the slice
    row's k-th magnitude (k = 1% of the slice) as the threshold. Calls on
    the card made here are comparisons, not the path's. ``offsets[c]`` is
    the element offset of call c's block (its row 0, column 0) in the
    state's buffer, and its row stride there; a slice counts as past 2^31
    where its last element lies past element 2^31 of the buffer."""
    res = {"slices": 0, "past_2_31": 0, "bit_exact": True, "int8": 0, "topk": 0}
    for c, call in enumerate(rec.calls):
        base, stride = offsets[c]
        for a, u, noise, out in call["slices"]:
            R, L = u.shape
            if call["name"] == "int8_roundtrip":
                want = qz.int8_roundtrip_ref(u, call["param"], noise)
                res["int8"] += 1
                k = max(1, math.ceil(LM_TRAIN_TOPK_FRAC * L))
                th = torch.topk(u.abs(), k, dim=1).values[:, -1]
                res["bit_exact"] &= same_bits(torch, qz.topk_mask(u, th), qz.topk_mask_ref(u, th))
                res["topk"] += 1
            else:
                want = qz.topk_mask_ref(u, call["param"])
                res["topk"] += 1
            res["bit_exact"] &= same_bits(torch, out, want)
            res["slices"] += 1
            res["past_2_31"] += int(base + (R - 1) * stride + a + L > 2 ** 31)
    require(res["bit_exact"], "a quantize kernel disagrees with its plain version on the "
                              "training path's uploads")
    return res


def time_topk_blocks(torch, qz, blocks) -> dict:
    """Each recorded ``topk_mask`` launch of a round timed again on its own
    block (back on the card) by CUDA events: one warm-up launch, then the
    mean of 5; its bound counts the block read once and the result written
    once (and two operations an element). Launches made here time the
    kernel; they are not the path's."""
    per, ms, bound = [], 0.0, 0.0
    for u_host, th_host in blocks:
        u, th = u_host.cuda(), th_host.cuda()
        t = cuda_ms(torch, lambda: qz.topk_mask(u, th), iters=5, warmup=1)
        b = cost_bound(qz.topk_mask_cost(u, th),
                       2 * u.numel() * u.element_size() + th.numel() * th.element_size(),
                       TOPK_FLOPS * u.numel(), F32_FLOPS_PER_S, "topk_mask block")["bound_ms"]
        per.append({"shape": list(u.shape), "ms": t, "bound_ms": b})
        ms, bound = ms + t, bound + b
        del u, th
    return {"launches": len(blocks), "ms": ms, "bound_ms": bound,
            "share": bound / ms if ms else None, "blocks": per}


def check_threshold(torch, row: torch.Tensor) -> dict:
    """The piecewise top-k threshold (``row_params``, pieces of ``_CHUNK``)
    against ``torch.topk`` over the whole row slice, bit for bit, and both
    timed with CUDA events."""
    from repro_torch.core import compression as cmp

    n = row.numel()
    k = max(1, math.ceil(LM_TRAIN_TOPK_FRAC * n))
    u = row[None]

    def piecewise():
        return cmp.row_params("topk", (u[:, sl] for sl in cmp.row_pieces(n)), n,
                              LM_TRAIN_TOPK_FRAC)

    def whole():
        return torch.topk(u.abs(), k, dim=1).values[:, -1]

    got, want = piecewise(), whole()
    require(same_bits(torch, got, want), f"the piecewise threshold {got.item()} is not "
                                         f"torch.topk's {want.item()} on a row of {n}")
    return {"elements": n, "k": k, "pieces": len(cmp.row_pieces(n)),
            "threshold": float(got.item()), "ms": cuda_ms(torch, piecewise, iters=5, warmup=1),
            "topk_ms": cuda_ms(torch, whole, iters=5, warmup=1)}


def finite_and_nonzero(torch, t) -> tuple[bool, bool]:
    """Whether every element of ``t`` is finite, and whether any is nonzero,
    read in pieces of 2^26 elements: ``torch.isfinite`` of a whole
    full-width buffer forms temporaries twice its size."""
    flat, finite, nonzero = t.view(-1), True, False
    for s in range(0, flat.numel(), 1 << 26):
        piece = flat[s:s + (1 << 26)]
        finite &= bool(torch.isfinite(piece).all())
        nonzero |= bool((piece != 0).any())
    return finite, nonzero


def replica_fingerprints(torch, fields, replicas) -> list:
    """Of each listed [G, K, ...] replica of each leaf of ``fields``: the
    int64 sum of its bit patterns and its first and last ``UPLOAD_SPAN``
    elements (a frozen replica must keep all three)."""
    from repro_torch.core.tree import tree_leaves

    G, K = LM_TRAIN_LEVELS
    out = []
    for tree in fields:
        for t in tree_leaves(tree):
            t3 = t.view(G, K, -1)
            for g, k in replicas:
                r = t3[g, k]
                bits = r.view({2: torch.int16, 4: torch.int32}[r.element_size()])
                out.append((int(bits.sum(dtype=torch.int64)), r[:UPLOAD_SPAN].clone(),
                            r[-UPLOAD_SPAN:].clone()))
    return out


def pack_lm_frames(torch, np, engine, cfg, toks, rng):
    """Whisper's training data: ``LM_TRAIN_SEQ``-token windows of the
    stream (targets shifted by one) beside a frame-embedding stub
    ``[encoder_frames, d_model]`` a sample (float32, from ``rng``), four
    samples a client, through ``engine.pack_arrays``."""
    G, K = LM_TRAIN_LEVELS
    per_client = 4
    n = G * K * per_client
    starts = rng.integers(0, len(toks) - LM_TRAIN_SEQ - 1, size=n)
    win = np.stack([toks[s:s + LM_TRAIN_SEQ + 1] for s in starts]).astype(np.int32)
    frames = rng.standard_normal((n, cfg.encoder_frames, cfg.d_model), dtype=np.float32)
    pools = [[np.arange((g * K + k) * per_client, (g * K + k + 1) * per_client)
              for k in range(K)] for g in range(G)]
    return engine.pack_arrays(
        {"tokens": win[:, :-1], "targets": win[:, 1:], "frames": frames}, pools,
        batch_size=LM_TRAIN_BATCH, shards=2, rng=rng, generator=torch.Generator().manual_seed(1))


def encoder_grad(torch, bundle, state, data) -> dict:
    """The whisper loss's gradient on the encoder's leaves (and its learned
    positions) at replica (0, 0) of the trained state, on the first packed
    sample with its frames: finite and not all zero."""
    from repro_torch.core.packer import is_flat
    from repro_torch.core.tree import tree_leaves, tree_map

    tree = state.params.to_tree() if is_flat(state.params) else state.params
    p = tree_map(lambda t: t[0, 0].detach().requires_grad_(), tree)
    leaves = tree_leaves({"encoder": p["encoder"], "enc_pos": p["enc_pos"]})
    with torch.enable_grad():
        loss = bundle.loss(p, {k: v[0, 0, 0, 0] for k, v in data.arrays.items()})
        grads = torch.autograd.grad(loss, leaves)
    sq = float(sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads))
    fz = [finite_and_nonzero(torch, g) for g in grads]
    require(all(f for f, _ in fz) and all(z for _, z in fz),
            "the encoder's gradient is not finite, or a leaf of it is all zero")
    return {"loss": float(loss.detach()), "encoder_grad_norm": sq ** 0.5, "leaves": len(grads)}


def phase_lm_train(torch, np, layout: str, rounds: int, trace: bool, tag: str = "",
                   spec_kw: dict | None = None, arch: str = LM_TRAIN_ARCH,
                   layers: int = LM_TRAIN_LAYERS) -> dict:
    """Phases 16-17, 19-21, (v), (w), (y) and (z): HFL LM training at
    ``arch``'s full width (glm4-9b's depth cut to ``LM_TRAIN_LAYERS``;
    rwkv6-1.6b's and granite's all 24, hymba's all 32, whisper's 24 + 24;
    the tree variants (v2), (w2), (y2) at 4)
    through ``build``/``pack_tokens``/``fit`` on the sharded backend (whisper:
    ``pack_arrays``, with its frames in every sample), fused,
    with the spec fields ``spec_kw`` (compressed uploads, partial
    participation). ``rounds`` rounds after a warm-up round; the launch
    counts are set to 0 just before them and read just after. The check of
    ``mtgc_update_flat`` on the trained state runs on glm4-9b's plain
    phases (h) and (i)."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.core import compression as cmp
    from repro_torch.core.participation import sample_hfl_masks
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.lm import make_lm_tokens
    from repro_torch.kernels import mtgc_update as mu
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz
    from repro_torch.models.transformer import build_model

    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    require(cfg.remat and cfg.param_dtype == "bfloat16", f"{arch} trains in bf16 with remat")
    bundle = build_model(cfg)
    G, K = LM_TRAIN_LEVELS
    spec = api.ExperimentSpec(
        levels=(G, K), backend="sharded", algorithm="mtgc", lr=LM_TRAIN_LR, fusion="fused",
        state_layout=layout, schedule=api.RoundSchedule(
            group_rounds=LM_TRAIN_E, local_steps=LM_TRAIN_H, microbatches=LM_TRAIN_A),
        **(spec_kw or {}))
    plan = spec.compression if spec.compressed else None
    engine = api.build(spec, bundle.loss)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    toks, _ = make_lm_tokens(rng, cfg.vocab_size, LM_TRAIN_TOKENS)
    if cfg.arch_type == "audio":
        data = pack_lm_frames(torch, np, engine, cfg, toks, rng)
    else:
        data = engine.pack_tokens(toks, batch_size=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                                  shards=2, rng=rng, generator=torch.Generator().manual_seed(1))
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9          # left by earlier phases
    params = bundle.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = engine.init(params)
    del params
    torch.cuda.synchronize()
    n_update = len(tree_leaves(state.params))
    state_gb = sum(t.numel() * t.element_size()
                   for f in (state.params, state.z, state.y, state.efc, state.efg)
                   if f is not None for t in tree_leaves(f)) / 1e9
    leaves = tree_leaves(state.params)
    # Uploads a round launches a quantize kernel on: each group round's
    # client link on [K, piece] blocks of each group, and the group link
    # once on [G, piece] blocks (pieces of cmp._CHUNK columns of each row).
    blocks = sum(len(cmp.row_pieces(t[0, 0].numel())) for t in leaves)
    quant = {"int8_roundtrip": 0, "topk_mask": 0}
    if plan is not None:
        for mode, n in ((plan.client_mode, LM_TRAIN_E * G * blocks), (plan.group_mode, blocks)):
            name = {"int8_stochastic": "int8_roundtrip", "topk": "topk_mask"}.get(mode)
            if name:
                quant[name] += n
    t0 = time.perf_counter()
    with UploadRecorder(ops, keep=G * blocks if plan is not None else 0,
                        rows=plan is not None and plan.group_mode == "topk") as rec:
        state, hz0 = api.fit(engine, data, 1, state=state)         # warm-up
        torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # (i)'s warm-up round, from a fresh state, is what the (mesh) phase's
    # rounds are held against: its rows' fingerprints.
    rows = row_fingerprints(torch, state) if tag == "i" else None
    upd = uploads = threshold = topk_timing = None
    if spec_kw is None and arch == LM_TRAIN_ARCH:
        upd = check_update_on_state(torch, mu, state, LM_TRAIN_LR, 1.0 / LM_TRAIN_A)
        log(f"mtgc_update_flat on the trained {layout} state (bf16, g_scale 1/{LM_TRAIN_A}, "
            f"in place, with and without a mask): {upd['slices']} column slices within one "
            f"ulp of the plain version ({upd['past_2_31']} past element 2^31; bit-exact "
            f"{upd['bit_exact']}; max abs err {upd['max_abs_err']:.3g})")
    if plan is not None:
        # Offsets of the recorded blocks in their state buffer: the client
        # link's run group by group over the [G, K, n] buffer, the group
        # link's leaf by leaf over [G, n] leaves.
        offsets = []
        for t in leaves:
            n = t[0, 0].numel()
            for g in (range(G) if plan.client_mode != "none" else [None]):
                for sl in cmp.row_pieces(n):
                    offsets.append((sl.start, n) if g is None else (g * K * n + sl.start, n))
        uploads = check_uploads(torch, qz, rec, offsets)
        require(uploads["past_2_31"] > 0 or plan.client_mode == "none",
                f"({tag}) no checked slice of the client uploads lay past element 2^31")
        log(f"({tag}) quantize kernels on the warm-up round's own uploads: {uploads['slices']} "
            f"column slices of {len(rec.calls)} blocks bit-exact against the plain versions "
            f"({uploads['int8']} int8_roundtrip, {uploads['topk']} topk_mask; "
            f"{uploads['past_2_31']} past element 2^31 of the state)")
        if rec.topk_blocks:
            topk_timing = time_topk_blocks(torch, qz, rec.topk_blocks)
            log(f"({tag}) topk_mask's {topk_timing['launches']} launches of the warm-up round, "
                f"each timed again on its own block by CUDA events: {topk_timing['ms']:.4f} ms "
                f"in all against a {topk_timing['bound_ms']:.4f} ms bound (share "
                f"{topk_timing['share']:.3f})")
        if rec.row0:
            threshold = check_threshold(torch, torch.cat(rec.row0))
            log(f"({tag}) top-k threshold on a report row slice of {threshold['elements']} "
                f"elements (k = {threshold['k']}, {threshold['pieces']} pieces): equal to "
                f"torch.topk's ({threshold['threshold']:.6g}); piecewise {threshold['ms']:.3f} "
                f"ms, one torch.topk {threshold['topk_ms']:.3f} ms")
        del rec
    frozen, prints = [], None
    if not spec.full_participation:
        # The masks the timed round draws first from the state's generator.
        mgen = torch.Generator(device=state.rng.device)
        mgen.set_state(state.rng.get_state())
        masks = sample_hfl_masks(mgen, G, K, spec.client_participation,
                                 spec.group_participation, spec.participation_mode)
        frozen = [tuple(i) for i in (masks.client == 0).nonzero().tolist()]
        prints = replica_fingerprints(torch, (state.params, state.z), frozen)
        require(len(frozen) == G * K // 2, f"{len(frozen)} frozen replicas, expected {G * K // 2}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hz = api.fit(engine, data, rounds, state=state)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / rounds
    # Peak over init, the warm-up and the timed rounds (not the checks).
    timed_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = all_launches()
    want = dict(lm_train_launches(cfg, n_update, rounds),
                **{k: v * rounds for k, v in quant.items()})
    require(got == want, f"LM training ({tag or layout}) launched {got}, expected {want}")
    if prints is not None:
        require(all(a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
                    for a, b in zip(prints, replica_fingerprints(
                        torch, (state.params, state.z), frozen))),
                f"({tag}) a frozen replica's params or z changed")
    sizes = cmp.model_leaf_sizes(state.params)
    active = [(g, k) for g in range(G) for k in range(K) if (g, k) not in frozen]
    wire = (LM_TRAIN_E * len(active) * cmp.upload_bytes(
                sizes, plan.client_mode if plan else "none", LM_TRAIN_TOPK_FRAC)
            + len({g for g, _ in active}) * cmp.upload_bytes(
                sizes, plan.group_mode if plan else "none", LM_TRAIN_TOPK_FRAC))
    comm = float(np.asarray(hz.metrics.comm_bytes)[-1])
    require(abs(comm - wire) <= wire * 2.0 ** -22,
            f"({tag}) comm_bytes {comm} is not the wire model {wire}")
    residuals = {}
    for name, flag in (("efc", "ef_client"), ("efg", "ef_group")):
        r = getattr(state, name)
        require((r is not None) == bool(plan is not None and getattr(plan, flag)),
                f"({tag}) the state's {name} does not match the plan")
        if r is not None:
            rl = tree_leaves(r)
            fz = [finite_and_nonzero(torch, t) for t in rl]
            require(all(f for f, _ in fz) and any(z for _, z in fz),
                    f"({tag}) the {name} residual is not finite or is all zero")
            residuals[name] = float(sum(torch.linalg.vector_norm(t, dtype=torch.float32) ** 2
                                        for t in rl))
    peak_gb = max(warm_peak_gb, timed_peak_gb)
    finite_metrics(np, hz0)
    finite_metrics(np, hz)
    losses = np.concatenate([hz0.metrics.loss.reshape(-1), hz.metrics.loss.reshape(-1)])
    require(hz.metrics.loss.shape == (rounds, LM_TRAIN_E, LM_TRAIN_H), "loss shape")
    for t in tree_leaves(state.params):
        require(finite_and_nonzero(torch, t)[0], f"LM training ({tag}): params not finite")
    enc = encoder_grad(torch, bundle, state, data) if cfg.arch_type == "audio" else None
    tokens = G * K * LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    out = {"phase": tag, "arch": arch, "layers": cfg.num_layers, "layout": layout,
           "spec": {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
                    for k, v in (spec_kw or {}).items()},
           "state_buffers": ({k: [tuple(b.shape), str(b.dtype)] for k, b in state.params.bufs.items()}
                             if layout == "flat" else None),
           "params": n_params, "state_gb": state_gb, "warmup_round_ms": warm_ms,
           "round_ms": round_ms, "tokens_per_round": tokens,
           "tokens_per_s": tokens / round_ms * 1e3, "peak_gb": peak_gb, "launches": got,
           "update_check": upd, "upload_check": uploads, "threshold": threshold,
           "topk_timing": topk_timing,
           "comm_bytes": comm, "residual_sq_norms": residuals, "frozen_replicas": frozen,
           "held_gb": held_gb, "warmup_peak_gb": warm_peak_gb,
           "timed_peak_gb": timed_peak_gb,
           "losses": [float(x) for x in losses], "data_s": data_s,
           "grad_norm": float(hz.metrics.grad_norm[-1]), "z_norm": float(hz.metrics.z_norm[-1]),
           "y_norm": float(hz.metrics.y_norm[-1]), "encoder_grad": enc, "rows": rows,
           "warmup_losses": [float(x) for x in np.asarray(hz0.metrics.loss).reshape(-1)],
           "data": {k: [list(v.shape), str(v.dtype)] for k, v in data.arrays.items()}}
    log(f"({tag}) LM training {arch} ({cfg.num_layers} of {full.num_layers} layers, full width, "
        f"{n_params / 1e9:.3f} B params, bf16, remat), {layout} + fused, {G}x{K} clients, "
        f"{json.dumps(out['spec'])}, "
        f"E={LM_TRAIN_E} H={LM_TRAIN_H} A={LM_TRAIN_A}, {LM_TRAIN_BATCH}x{LM_TRAIN_SEQ} tokens a "
        f"microbatch: warm-up round {warm_ms:.1f} ms, then {round_ms:.1f} ms a round "
        f"({out['tokens_per_s']:.0f} training tokens/s, {tokens} a round); state "
        f"{state_gb:.2f} GB, peak memory {peak_gb:.2f} GB (of which {held_gb:.2f} GB was held "
        f"before the phase; warm-up {warm_peak_gb:.2f} GB, timed round {timed_peak_gb:.2f} GB); "
        f"launches {got} (reckoned {want})")
    log(f"  loss per step {np.round(losses, 4).tolist()}; grad_norm {out['grad_norm']:.4g} "
        f"z_norm {out['z_norm']:.4g} y_norm {out['y_norm']:.4g}; comm_bytes {comm} (wire "
        f"model {wire}); residuals {residuals}; frozen replicas {frozen} kept their bits")
    if enc is not None:
        log(f"  ({tag}) packed {out['data']}; the encoder's gradient at replica (0, 0) on one "
            f"sample with its frames: finite, every one of its {enc['leaves']} leaves nonzero, "
            f"norm {enc['encoder_grad_norm']:.4g} (loss {enc['loss']:.4f})")
    if trace:
        # rwkv6's round makes about 283,000 launches, granite's, hymba's and
        # whisper's like numbers: their traces record the device alone, as
        # the busy share and the time by kernel need.
        tr = profile_round(torch, lambda: api.fit(engine, data, 1, state=state),
                           host=cfg.arch_type not in ("ssm", "moe", "hybrid", "audio"))
        out["busy_share"] = tr["busy"] / tr["wall_us"] if tr else None
        log_trace(f"  ({tag}) LM training round ({layout}, traced)", tr, top_n=20)
        if tr:
            def busy_ms(match) -> float:
                return sum(n["attributed"] for name, n in tr["by_name"].items()
                           if match(name)) / 1e3

            gemm = busy_ms(lambda name: name.startswith("nvjet") or "gemm" in name.lower())
            bwd = busy_ms(lambda name: "flash_bwd" in name)
            scan_f = busy_ms(lambda name: "rwkv6_" in name and "rwkv6_bwd" not in name)
            scan_b = busy_ms(lambda name: "rwkv6_bwd" in name)
            quant = busy_ms(lambda name: "int8_kernel" in name or "topk_kernel" in name)
            topk = busy_ms(lambda name: "topk_kernel" not in name and any(
                w in name for w in ("TopK", "topk", "radix", "Sort", "sort", "KthValue")))
            busy = tr["busy"] / 1e3
            out["gemm_share"], out["flash_bwd_share"] = gemm / busy, bwd / busy
            out["quantize_share"], out["threshold_share"] = quant / busy, topk / busy
            out["scan_share"], out["scan_bwd_share"] = scan_f / busy, scan_b / busy
            out["busy_ms"] = busy
            if cfg.arch_type == "moe":
                moe = {n: busy_ms(lambda name, n=n: f"{n}_kernel" in name)
                       for n in ("moe_gather", "moe_combine", "moe_gate_grad")}
                out["moe_ms"] = moe
                out["moe_share"] = sum(moe.values()) / busy
                log(f"  the moe kernels: {moe} ms, {out['moe_share']:.3f} of busy")
            if cfg.arch_type == "hybrid":
                sel = {"forward": busy_ms(lambda name: "selective_scan_kernel" in name),
                       "backward": busy_ms(lambda name: "ssm_bwd" in name)}
                out["selective_scan_ms"] = sel
                out["selective_scan_share"] = sum(sel.values()) / busy
                log(f"  the selective scan's forward (both passes under remat) and backward "
                    f"kernels: {sel} ms, {out['selective_scan_share']:.3f} of busy")
            if cfg.arch_type == "ssm":
                out["scan_bwd_pass_ms"] = {p: busy_ms(lambda name, p=p: p in name)
                                           for p in kernel_names("rwkv6_scan_bwd")}
                log(f"  the scan's forward kernels (both passes under remat): {scan_f:.1f} ms, "
                    f"{out['scan_share']:.3f} of busy; its backward's four kernels: "
                    f"{scan_b:.1f} ms, {out['scan_bwd_share']:.3f} of busy (by pass, ms: "
                    f"{out['scan_bwd_pass_ms']})")
            log(f"  cuBLAS products (nvjet/gemm kernels): {gemm:.1f} ms, "
                f"{out['gemm_share']:.3f} of busy; the attention backward's three kernels: "
                f"{bwd:.1f} ms, {out['flash_bwd_share']:.3f} of busy; the quantize kernels: "
                f"{quant:.1f} ms, {out['quantize_share']:.3f}; torch.topk's (threshold): "
                f"{topk:.1f} ms, {out['threshold_share']:.3f}")
    del state, engine, data
    torch.cuda.empty_cache()
    return out


def phase_lm_train_card_vs_cpu(torch, np, convert, arch: str = LM_TRAIN_ARCH) -> dict:
    """Phases 21, (v3), (w3), (y3) and (z3): one sharded round of the
    reduced ``arch`` (float32, remat, T = 1100: glm4-9b's, granite's,
    hymba's, whisper's and internvl2's layers run the flash kernels forward
    and backward (T > 1024), granite's the moe kernels with capacity
    routing, hymba's the selective scan forward and backward, rwkv6's the
    scan's at chunk 64 with a ragged last chunk; whisper's samples carry
    frames, internvl2's patches) on the card against the same round on the
    CPU (the plain versions), tree + fused; the fused step against the
    unfused one on the card; and, for glm4-9b, two async windows card
    against CPU."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model

    dense = arch == LM_TRAIN_ARCH
    bundle = build_model(get_arch(arch).reduced(remat=True, **(
        dict(rwkv_chunk=64) if arch == SSM_TRAIN_ARCH else dict(attn_block=128))))
    params = bundle.init(0, device="cpu")
    rs = np.random.default_rng(18)
    batch = {k: torch.from_numpy(rs.integers(0, 256, (1, 1, 2, 2, 2, 1, 1100)).astype(np.int32))
             for k in ("tokens", "targets")}
    batch.update({k: v.cpu().reshape((1, 1, 2, 2, 2, 1) + tuple(v.shape[1:]))
                  for k, v in serve_stub(torch, np, bundle.cfg, 8, 19).items()})
    outs = {}
    # Deterministic algorithms: the embedding's backward (an index_put with
    # accumulation) otherwise adds with atomics in a varying order, and the
    # fused and unfused steps are compared bit for bit.
    torch.use_deterministic_algorithms(True, warn_only=True)
    for dev, fusion in (("cuda", "fused"), ("cpu", "fused"), ("cuda", "none")):
        spec = api.ExperimentSpec(levels=(2, 2), backend="sharded", lr=0.05, fusion=fusion,
                                  state_layout="tree", schedule=api.RoundSchedule(
                                      group_rounds=1, local_steps=1, microbatches=2))
        eng = api.build(spec, bundle.loss, device=dev)
        st, met = eng.round_fn(eng.init(convert.params_from_numpy(convert.to_numpy(params),
                                                                  dev)),
                               {k: v.to(dev) for k, v in batch.items()})
        outs[(dev, fusion)] = (convert.to_numpy(st), met.loss.cpu().numpy())
    if not dense:
        torch.use_deterministic_algorithms(False)
        return lm_round_card_vs_cpu(np, outs, arch)
    # Two async windows (group_rounds (2, 1), delay-compensated, flat + fused)
    # of the same data: the window t = 1 merges group 1's stale report.
    abatch = {k: v[0, 0][:, None, None].contiguous() for k, v in batch.items()}
    aspec = api.ExperimentSpec(levels=(2, 2), backend="sharded", lr=0.05, fusion="fused",
                               state_layout="flat", staleness="delay_compensated",
                               schedule=api.RoundSchedule(group_rounds=(2, 1), local_steps=1,
                                                          microbatches=1))
    for dev in ("cuda", "cpu"):
        eng = api.build(aspec, bundle.loss, device=dev)
        st = eng.init(convert.params_from_numpy(convert.to_numpy(params), dev))
        for _ in range(2):
            st, met = eng.round_fn(st, {k: v.to(dev) for k, v in abatch.items()})
        outs[(dev, "async")] = (convert.to_numpy(st), met.loss.cpu().numpy())
    torch.use_deterministic_algorithms(False)
    worst_async = 0.0
    card, cpu = outs[("cuda", "async")], outs[("cpu", "async")]
    require(np.allclose(card[1], cpu[1], rtol=1e-5), f"async losses differ: {card[1]} vs {cpu[1]}")
    for name in ("params", "z", "y", "snap", "glob"):
        for key, c in cpu[0][name].items():
            g = card[0][name][key]
            worst_async = max(worst_async, float(np.max(np.abs(g - c) / (1e-5 + np.abs(c)))))
            require(np.allclose(g, c, rtol=1e-4, atol=1e-5 if name != "z" and name != "y"
                                else 1e-4), f"async reduced LM round: {name}/{key} differs "
                                            f"between card and CPU")
    log(f"card vs CPU, reduced glm4-9b (f32, remat) async sharded windows, flat + fused, "
        f"group_rounds (2, 1), delay_compensated, T=1100: params, z, y, snap, glob within rtol "
        f"1e-4 (worst {worst_async:.2e})")
    return dict(lm_round_card_vs_cpu(np, outs, arch), worst_async=worst_async)


def lm_round_card_vs_cpu(np, outs: dict, arch: str) -> dict:
    """The reduced sharded round's checks: card against CPU (losses within
    rtol 1e-5, params within rtol 1e-4 / atol 1e-5, z and y atol 1e-4) and
    the fused step against the unfused one on the card, bit for bit."""
    worst = 0.0
    card, cpu = outs[("cuda", "fused")], outs[("cpu", "fused")]
    require(np.allclose(card[1], cpu[1], rtol=1e-5), f"losses differ: {card[1]} vs {cpu[1]}")
    for name in ("params", "z", "y"):
        for (path, g), (_, c) in zip(_leaf_paths(card[0][name]), _leaf_paths(cpu[0][name])):
            worst = max(worst, float(np.max(np.abs(g - c) / (1e-5 + np.abs(c)))))
            require(np.allclose(g, c, rtol=1e-4, atol=1e-5 if name == "params" else 1e-4),
                    f"reduced LM round: {name}{path} differs between card and CPU")
    unf = outs[("cuda", "none")][0]
    for name in ("params", "z", "y"):
        for (path, g), (_, u) in zip(_leaf_paths(card[0][name]), _leaf_paths(unf[name])):
            require(np.array_equal(g, u), f"fused and unfused LM steps differ in {name}{path}")
    log(f"card vs CPU, reduced {arch} (f32, remat) sharded round, 2x2, A=2, T=1100: losses "
        f"{card[1].reshape(-1).tolist()}; params within rtol 1e-4 (worst {worst:.2e}); fused "
        f"and unfused steps on the card bit-identical")
    return {"arch": arch, "losses": card[1].reshape(-1).tolist(), "worst_rel": worst,
            "fused_equals_unfused": True}


def phase_audio_vlm_checks(torch, np, convert) -> dict:
    """(z3), the model checks. Reduced whisper and internvl2 (float32,
    remat, attn_block 128) from one set of params on the card and on the
    CPU: the loss (rtol 1e-5) and every gradient (rtol 1e-4 / atol 1e-5) at
    1100 text tokens with frames or patches, the flash kernels twice
    forward and once backward a layer, the encoder's or projector's
    gradients nonzero; the prefill logits (rtol/atol 1e-4) and 8 greedy
    tokens through ``generate`` with the stub. Then internvl2 at full width
    with 2 of its 48 layers (bf16, remat) on the card: the loss and backward
    with 256 patches before 2048 tokens (the flash kernels at [1, 2304, 48,
    128] / [1, 2304, 8, 128]), every gradient finite, the projector's
    nonzero; then the same loss and backward with the kernels' plain
    versions swapped into ``FlashAttention``: the loss within VLM_LOSS_GAP
    and each gradient within VLM_GRAD_GAP of its largest entry of theirs;
    ms, and the peak."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import build_model

    out = {}
    stub_keys = {AUDIO_ARCH: ("encoder", "enc_pos"), VLM_ARCH: ("projector",)}
    for arch in (AUDIO_ARCH, VLM_ARCH):
        bundle = build_model(get_arch(arch).reduced(remat=True, attn_block=128))
        params = bundle.init(0, device="cpu")
        rs = np.random.default_rng(20)
        batch = {k: torch.from_numpy(rs.integers(0, 256, (1, 1100)).astype(np.int32))
                 for k in ("tokens", "targets")}
        batch.update({k: v.cpu() for k, v in serve_stub(torch, np, bundle.cfg, 1, 21).items()})
        res = []
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.requires_grad_(),
                         convert.params_from_numpy(convert.to_numpy(params), dev))
            ops.reset_launch_counts()
            loss = bundle.loss(p, {k: v.to(dev) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, tree_leaves(p))
            res.append((float(loss.detach()), [g.cpu() for g in grads], all_launches()))
        (card_loss, card, launches), (cpu_loss, cpu, _) = res
        require(launches["flash_attention"] == 4 and launches["flash_attention_bwd"] == 6,
                f"reduced {arch} loss launched {launches}: 2 layers, remat")
        require(abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss),
                f"reduced {arch}: loss {card_loss} on the card, {cpu_loss} on the CPU")
        worst = 0.0
        for (path, _), g, c in zip(_leaf_paths(params), card, cpu):
            worst = max(worst, float(((g - c).abs() / (1e-5 + c.abs())).max()))
            require(torch.allclose(g, c, rtol=1e-4, atol=1e-5),
                    f"reduced {arch}: gradient {path} differs between card and CPU")
            if path.split("/")[1] in stub_keys[arch]:
                require(bool(c.abs().max() > 0), f"reduced {arch}: gradient {path} is zero")
        toks = torch.from_numpy(rs.integers(0, 256, (2, 37)).astype(np.int32))
        stub = {k: v.cpu() for k, v in serve_stub(torch, np, bundle.cfg, 2, 22).items()}
        gen_card = generate(bundle, convert.params_from_numpy(convert.to_numpy(params), "cuda"),
                            toks.cuda(), 8, **{k: v.cuda() for k, v in stub.items()})
        gen_cpu = generate(bundle, params, toks, 8, **stub)
        gl, cl = gen_card.prefill_logits.cpu(), gen_cpu.prefill_logits
        require(torch.allclose(gl, cl, rtol=1e-4, atol=1e-4),
                f"reduced {arch}: prefill logits differ between card and CPU")
        require(torch.equal(gen_card.tokens.cpu(), gen_cpu.tokens),
                f"reduced {arch}: greedy tokens differ between card and CPU")
        out[arch] = {"loss": card_loss, "cpu_loss": cpu_loss, "worst_grad_rel": worst,
                     "prefill_max_abs_diff": float((gl - cl).abs().max()),
                     "launches": launches}
        log(f"card vs CPU, reduced {arch} (f32, remat) with its {', '.join(stub)}: loss "
            f"{card_loss:.6f} / {cpu_loss:.6f}, {len(card)} gradients within rtol 1e-4 (worst "
            f"{worst:.2e}), launches {launches['flash_attention']} flash forward, "
            f"{launches['flash_attention_bwd']} backward; prefill logits within 1e-4 (max "
            f"{out[arch]['prefill_max_abs_diff']:.3g}), 8 greedy tokens equal")

    # internvl2 at full width, 2 of 48 layers, on the card.
    full = get_arch(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_LOSS_LAYERS)
    bundle = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    params = bundle.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    rs = np.random.default_rng(24)
    batch = {k: torch.from_numpy(rs.integers(0, cfg.vocab_size, (1, LM_TRAIN_SEQ))
                                 .astype(np.int32)).cuda() for k in ("tokens", "targets")}
    batch.update(serve_stub(torch, np, cfg, 1, 25))
    p = tree_map(lambda t: t.requires_grad_(), params)
    ms = []
    for _ in range(2):                                  # the first call warms up
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = bundle.loss(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches["flash_attention"] == 2 * VLM_LOSS_LAYERS
            and launches["flash_attention_bwd"] == 3 * VLM_LOSS_LAYERS,
            f"full-width {VLM_ARCH} loss launched {launches}")
    for (path, _), g in zip(_leaf_paths(params), grads):
        f, nz = finite_and_nonzero(torch, g)
        require(f, f"full-width {VLM_ARCH}: gradient {path} is not finite")
        if path.startswith("/projector"):
            require(nz, f"full-width {VLM_ARCH}: gradient {path} is zero")
    kernel_loss = float(loss.detach())
    # The same loss and backward with the attention kernels' plain versions
    # swapped into ``FlashAttention`` (float32 inside, bf16 in and out, as
    # the kernels): every other operation is the same, so the gaps are the
    # attention's rounding carried through the 2 layers.
    ops.reset_launch_counts()
    kernels = fa.flash_attention, fa.flash_attention_bwd
    fa.flash_attention, fa.flash_attention_bwd = fa.flash_attention_ref, fa.flash_attention_bwd_ref
    try:
        loss = bundle.loss(p, batch)
        plain = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
    finally:
        fa.flash_attention, fa.flash_attention_bwd = kernels
    require(sum(all_launches().values()) == 0, f"full-width {VLM_ARCH}: the plain run launched "
            f"{all_launches()}")
    plain_loss = float(loss.detach())
    loss_gap = abs(kernel_loss - plain_loss) / abs(plain_loss)
    grad_gap = {path: float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for (path, _), g, w in zip(_leaf_paths(params), grads, plain)}
    worst_path = max(grad_gap, key=grad_gap.get)
    log(f"(z3) {VLM_ARCH} full width, kernels against their plain versions in the same bf16 "
        f"model: loss {kernel_loss:.6f} / {plain_loss:.6f} (relative gap {loss_gap:.3g}); each "
        f"gradient's max gap over its max entry: worst {grad_gap[worst_path]:.3g} "
        f"({worst_path}), {json.dumps({k: float(f'{v:.3g}') for k, v in grad_gap.items()})}")
    require(loss_gap <= VLM_LOSS_GAP, f"full-width {VLM_ARCH}: loss {kernel_loss} with the "
            f"kernels, {plain_loss} with their plain versions")
    require(grad_gap[worst_path] <= VLM_GRAD_GAP, f"full-width {VLM_ARCH}: gradient "
            f"{worst_path} with the kernels is {grad_gap[worst_path]} of its max from the "
            f"plain versions'")
    del grads, plain, p, loss, params
    torch.cuda.empty_cache()
    out["full_width"] = {"arch": VLM_ARCH, "layers": VLM_LOSS_LAYERS, "params": n_params,
                         "tokens": LM_TRAIN_SEQ, "patches": cfg.vision_tokens,
                         "loss": kernel_loss, "plain_loss": plain_loss, "loss_gap": loss_gap,
                         "grad_gap": grad_gap, "ms": ms[-1], "warmup_ms": ms[0],
                         "peak_gb": peak_gb, "held_gb": held_gb, "launches": launches}
    log(f"(z3) {VLM_ARCH} at full width, {VLM_LOSS_LAYERS} of {full.num_layers} layers "
        f"({n_params / 1e9:.3f} B params, bf16, remat): loss and backward with "
        f"{cfg.vision_tokens} patches before {LM_TRAIN_SEQ} tokens {ms[-1]:.1f} ms (warm-up "
        f"{ms[0]:.1f}), loss {kernel_loss:.5f}, every gradient finite, the projector's "
        f"nonzero, within {VLM_LOSS_GAP:g} (loss) and {VLM_GRAD_GAP:g} (gradients) of the "
        f"plain versions'; launches {launches['flash_attention']} flash forward, "
        f"{launches['flash_attention_bwd']} backward; peak {peak_gb:.2f} GB ({held_gb:.2f} "
        f"held before)")
    return out


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


# Phase (m): HFL under faults on the simulator engine (the CNN at full
# width), and phase (n): LM training under faults on the sharded backend.
FAULT_RATES = dict(crash_rate=0.05, timeout_rate=0.1, corrupt_rate=0.2)
FAULT_ROUNDS, FAULT_CHUNK, FAULT_SEED = 4, 2, 1
M_SCREEN_NORM, M_CLIP_NORM = 50.0, 5.0       # (m)'s third run: explode, screen and clip
N_SCREEN_NORM, N_CLIP_NORM = 100.0, 100.0    # (n)'s defense


class UpdateChecker:
    """Stands in for ``ops.mtgc_update_flat`` during a run: every call goes
    to the real wrapper (which launches the kernel and counts it), and every
    ``every``-th call's result is held against ``mtgc_update_flat_ref`` on
    the same operands -- NaN positions, not NaN payload bits, and every
    other element bit for bit -- and its frozen rows against x's bits."""

    def __init__(self, ops, mu, every: int):
        self.ops, self.mu, self.every = ops, mu, every
        self.real, self.calls, self.checked, self.nan_inputs = ops.mtgc_update_flat, 0, 0, 0

    def __enter__(self):
        def spy(x, g, z, y, mask=None, **kw):
            out = self.real(x, g, z, y, mask, **kw)
            if self.calls % self.every == 0:
                import torch

                want = self.mu.mtgc_update_flat_ref(x, g, z, y, mask, kw["lr"],
                                                    kw.get("g_scale", 1.0))
                require(same_bits(torch, out, want),
                        "mtgc_update_flat disagrees with its plain version on a faulty "
                        "round's own operands")
                if mask is not None:
                    frozen = mask == 0
                    require(same_bits(torch, out[frozen], x[frozen]),
                            "a frozen replica changed in mtgc_update_flat")
                self.nan_inputs += int(any(bool(torch.isnan(t).any()) for t in (x, g, z, y)))
                self.checked += 1
            self.calls += 1
            return out

        self.ops.mtgc_update_flat = spy
        return self

    def __exit__(self, *exc):
        self.ops.mtgc_update_flat = self.real


def phase_faults_hfl(torch, np, api, spec, data, p0, loss_fn) -> dict:
    """Phase (m): the CNN at full width on the simulator engine under one
    fixed fault realization (crash 0.05, timeout 0.1, corrupt 0.2, injected
    through ``RoundDraws``), ``FAULT_ROUNDS`` rounds in chunks of
    ``FAULT_CHUNK`` through ``fit``: undefended NaN corruption (the state
    turns non-finite), defended by the non-finite screen and guarded
    (finite, ``screened`` = every corrupted upload), the same defended and
    unguarded (timed), and int8 on both links with error feedback under
    exploded uploads, the norm screen and the clip. Then one forced rollback
    (always NaN, undefended: the guard raises after ``max_retries``, every
    retry starting from the snapshot's bits) and the guard's zero-fault
    overhead (guarded against unguarded rounds, in turns). The masked
    ``mtgc_update_flat`` is held against its plain version on the rounds'
    own operands, and every crashed replica keeps its bits."""
    from repro_torch.core import driver as drv
    from repro_torch.core.engine import RoundDraws
    from repro_torch.core.faults import DefensePlan, FaultPlan, fault_masks
    from repro_torch.kernels import mtgc_update as mu
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz

    G, K = spec.levels
    # The fixed realization: masks drawn on the host from a seeded generator.
    gen = torch.Generator().manual_seed(FAULT_SEED)
    real = [fault_masks(gen, FaultPlan(**FAULT_RATES), G, K) for _ in range(FAULT_ROUNDS)]
    crash = sum(int(m.crash.sum()) for m in real)
    timeouts = sum(int(m.timeout.sum()) for m in real)
    bad = [int((m.corrupt * (1 - m.crash)).sum()) for m in real]
    require(crash > 0 and timeouts > 0 and sum(bad) > 0,
            f"the fault realization has {crash} crashes, {timeouts} timeouts, {bad} corruptions")
    draws = [RoundDraws(faults=m) for m in real]
    sids = torch.randint(0, data.num_shards, (FAULT_ROUNDS, E, G, K),
                         generator=torch.Generator().manual_seed(11))
    out = {"realization": {"crashes": crash, "timeouts": timeouts,
                           "corrupted_uploads_per_round": bad}, "runs": {}}
    launches = {"mtgc_update_flat": 0, "int8_roundtrip": 0}

    def crash_check(rf):
        """The round function, holding each crashed replica's params and z
        to their bits across the round."""
        def run(state, batches, draws=None):
            rows = (draws.faults.crash != 0).nonzero().tolist()
            before = [(state.params.bufs["float32"][g, k].clone(),
                       state.z.bufs["float32"][g, k].clone()) for g, k in rows]
            new, met = rf(state, batches, draws=draws)
            for (g, k), (x0, z0) in zip(rows, before):
                require(same_bits(torch, new.params.bufs["float32"][g, k], x0)
                        and same_bits(torch, new.z.bufs["float32"][g, k], z0),
                        f"crashed replica ({g}, {k}) changed")
            out["crashed_replicas_checked"] = out.get("crashed_replicas_checked", 0) + len(rows)
            return new, met
        return run

    def drive(tag, eng, guard=None, want_int8=0):
        eng.round_fn = crash_check(eng.round_fn)
        ops.reset_launch_counts()
        with UpdateChecker(ops, mu, E * H) as chk:
            t0 = time.perf_counter()
            st, hz = api.fit(eng, data, FAULT_ROUNDS, params=p0, chunk=FAULT_CHUNK,
                             shard_ids=sids, draws=draws, guard=guard)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / FAULT_ROUNDS
        rounds = FAULT_ROUNDS + (hz.guard.retries * FAULT_CHUNK if hz.guard else 0)
        got = {"mtgc_update_flat": mu.mtgc_update_flat.launches,
               "int8_roundtrip": qz.int8_roundtrip.launches}
        require(got == {"mtgc_update_flat": E * H * rounds,
                        "int8_roundtrip": want_int8 * rounds},
                f"({tag}) launched {got} over {rounds} rounds")
        for k, v in got.items():
            launches[k] += v
        fields = {f: getattr(st, f).bufs["float32"] for f in ("params", "z", "y")}
        finite = {f: bool(torch.isfinite(t).all()) for f, t in fields.items()}
        run = {"round_ms": ms, "screened": hz.metrics.screened.tolist(),
               "loss": np.round(hz.metrics.loss.reshape(FAULT_ROUNDS, -1).mean(1), 5).tolist(),
               "finite": finite, "launches": got, "kernel_checks": chk.checked,
               "kernel_checks_with_nan_operands": chk.nan_inputs,
               "guard": None if hz.guard is None else hz.guard._asdict()}
        out["runs"][tag] = run
        log(f"(m) {tag}: {ms:.1f} ms a round over {FAULT_ROUNDS} rounds (chunk {FAULT_CHUNK}); "
            f"screened {run['screened']}; mean loss a round {run['loss']}; finite {finite}; "
            f"launches {got}; mtgc_update_flat held against its plain version on "
            f"{chk.checked} calls ({chk.nan_inputs} with NaN operands); guard {run['guard']}")
        return st, hz

    nan_plan = FaultPlan(**FAULT_RATES, corrupt_kind="nan")
    st, _ = drive("undefended nan", api.build(dataclasses.replace(spec, faults=nan_plan), loss_fn))
    require(not out["runs"]["undefended nan"]["finite"]["params"]
            and not out["runs"]["undefended nan"]["finite"]["y"],
            "undefended NaN corruption left the state finite")
    require(out["runs"]["undefended nan"]["kernel_checks_with_nan_operands"] > 0,
            "the kernel never saw a NaN operand in the undefended run")
    defended = dataclasses.replace(spec, faults=nan_plan, defense=DefensePlan())
    st, hz = drive("defended nan, guarded", api.build(defended, loss_fn), guard=True)
    run = out["runs"]["defended nan, guarded"]
    require(all(run["finite"].values()), "the defended run is not finite")
    require(sum(run["screened"]) == E * sum(bad),
            f"screened {run['screened']}, expected {E} x {bad}")
    st, hz = drive("defended nan, unguarded", api.build(defended, loss_fn))
    require(all(out["runs"]["defended nan, unguarded"]["finite"].values()),
            "the defended unguarded run is not finite")
    int8 = dataclasses.replace(
        spec, compression=api.CompressionPlan("int8_stochastic", "int8_stochastic"),
        faults=FaultPlan(**FAULT_RATES, corrupt_kind="explode"),
        defense=DefensePlan(screen_norm=M_SCREEN_NORM, clip_norm=M_CLIP_NORM))
    st, hz = drive("int8/int8 EF, explode, screen and clip", api.build(int8, loss_fn),
                   want_int8=E + 1)
    run = out["runs"]["int8/int8 EF, explode, screen and clip"]
    require(all(run["finite"].values()), "the compressed defended run is not finite")
    require(sum(run["screened"]) >= E * sum(bad),
            f"screened {run['screened']}: not every exploded upload ({E} x {bad})")
    for name in ("efc", "efg"):
        r = getattr(st, name).bufs["float32"]
        require(bool(torch.isfinite(r).all()), f"the {name} residual is not finite")
    del st, hz

    # One forced rollback: undefended, every upload NaN. Each attempt's first
    # round must start from the snapshot's bits.
    eng = api.build(dataclasses.replace(spec, faults=FaultPlan(corrupt_rate=0.999,
                                                               corrupt_kind="nan")), loss_fn)
    st0 = eng.init(p0)
    snap = [t.cpu() for t in drv._state_tensors(st0)]
    all_bad = [RoundDraws(faults=m._replace(corrupt=torch.ones(G, K), crash=torch.zeros(G, K),
                                            timeout=torch.zeros(G)))
               for m in real[:FAULT_CHUNK]]
    calls, starts = [0], []

    def spy(state, batches, draws=None):
        if calls[0] % FAULT_CHUNK == 0:
            starts.append(all(same_bits(torch, t, s.cuda()) for t, s in
                              zip(drv._state_tensors(state), snap)))
        calls[0] += 1
        return eng.round_fn(state, batches, draws=draws)

    max_retries = 2
    try:
        drv.run_rounds(spy, st0, data, FAULT_CHUNK, chunk=FAULT_CHUNK, shard_ids=sids[:FAULT_CHUNK],
                       draws=all_bad, guard=drv.GuardSpec(max_retries=max_retries,
                                                          round_fn_for_retry=lambda a: spy))
        raise AssertionError("the guard did not raise")
    except RuntimeError as err:
        require("exhausted" in str(err), f"the guard raised {err}")
    require(calls[0] == (max_retries + 1) * FAULT_CHUNK and all(starts),
            f"forced rollback: {calls[0]} rounds run, attempt starts equal to the snapshot "
            f"{starts}")
    out["forced_rollback"] = {"attempts": len(starts), "restored_bit_exact": starts[1:]}
    log(f"(m) forced rollback (undefended, every upload NaN): the guard raised after "
        f"{max_retries} retries; each of {len(starts)} attempts started from the snapshot's "
        f"bits")
    del st0, snap, eng

    # The guard's zero-fault overhead, in turns.
    plain = api.build(spec, loss_fn)
    times = {"unguarded": [], "guarded": []}
    for tag in ("unguarded", "guarded", "guarded", "unguarded"):
        t0 = time.perf_counter()
        st, hz = api.fit(plain, data, FAULT_ROUNDS, params=p0, chunk=FAULT_CHUNK, shard_ids=sids,
                         guard=tag == "guarded")
        torch.cuda.synchronize()
        times[tag].append((time.perf_counter() - t0) * 1e3 / FAULT_ROUNDS)
        if hz.guard is not None:
            require(hz.guard.rollbacks == 0, "the zero-fault guarded run rolled back")
            out["guard_snapshot"] = hz.guard._asdict()
    u, g = (sum(times[k]) / 2 for k in ("unguarded", "guarded"))
    out["guard_overhead"] = {"unguarded_ms": times["unguarded"], "guarded_ms": times["guarded"],
                             "overhead": g / u - 1.0}
    log(f"(m) the guard's zero-fault overhead: unguarded {times['unguarded']} ms a round, "
        f"guarded {times['guarded']} ms ({100 * (g / u - 1):.1f}%); a snapshot "
        f"{out['guard_snapshot']['snapshot_bytes'] / 1e9:.2f} GB, "
        f"{out['guard_snapshot']['snapshot_s']:.3f} s for {FAULT_ROUNDS // FAULT_CHUNK} chunks")
    out["launches"] = launches
    return out


def phase_lm_train_faults(torch, np) -> dict:
    """Phase (n): glm4-9b at its published widths (2 of 40 layers), 2 x 2,
    flat + fused, uncompressed, on the sharded backend through ``fit`` with
    the defense (non-finite screen, norm screen, clip) and the guard: a
    warm-up round with no faults, then two rounds with injected masks --
    round 1: client (1, 1) crashes and (0, 0) uploads an exploded delta;
    round 2: group 1 times out and (0, 1) uploads NaN. ``screened`` must be
    the injected count, the crashed replica's params and z and the timed-out
    group's y must keep their bits, the state must be finite; round ms,
    tokens/s, peak memory and the guard's snapshot seconds and bytes."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import RoundDraws
    from repro_torch.core.faults import DefensePlan, FaultMasks, FaultPlan
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.lm import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model

    meminfo = {line.split(":")[0]: int(line.split()[1]) * 1024
               for line in Path("/proc/meminfo").read_text().splitlines()
               if line.split(":")[0] in ("MemTotal", "MemAvailable")}
    log(f"(n) host memory: MemTotal {meminfo['MemTotal'] / 1e9:.1f} GB, MemAvailable "
        f"{meminfo['MemAvailable'] / 1e9:.1f} GB")
    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH), num_layers=LM_TRAIN_LAYERS)
    bundle = build_model(cfg)
    G, K = LM_TRAIN_LEVELS
    defense = DefensePlan(screen_nonfinite=True, screen_norm=N_SCREEN_NORM,
                          clip_norm=N_CLIP_NORM)

    def engine(kind):
        return api.build(api.ExperimentSpec(
            levels=(G, K), backend="sharded", algorithm="mtgc", lr=LM_TRAIN_LR, fusion="fused",
            state_layout="flat", schedule=api.RoundSchedule(
                group_rounds=LM_TRAIN_E, local_steps=LM_TRAIN_H, microbatches=LM_TRAIN_A),
            faults=FaultPlan(crash_rate=0.05, timeout_rate=0.05, corrupt_rate=0.05,
                             corrupt_kind=kind), defense=defense), bundle.loss)

    explode, nan = engine("explode"), engine("nan")
    rng = np.random.default_rng(0)
    toks, _ = make_lm_tokens(rng, cfg.vocab_size, LM_TRAIN_TOKENS)
    data = explode.pack_tokens(toks, batch_size=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ, shards=2,
                               rng=rng, generator=torch.Generator().manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    params = bundle.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = explode.init(params)
    del params
    n_update = len(tree_leaves(state.params))

    def masks(crash=(), timeout=(), corrupt=()):
        fm = FaultMasks(torch.zeros(G, K), torch.zeros(G), torch.zeros(G, K))
        for g, k in crash:
            fm.crash[g, k] = 1.0
        for g in timeout:
            fm.timeout[g] = 1.0
        for g, k in corrupt:
            fm.corrupt[g, k] = 1.0
        return RoundDraws(faults=fm)

    # A warm-up round with no faults, guarded: it also allocates the guard's
    # page-locked host buffers, which PyTorch caches for the later rounds.
    t0 = time.perf_counter()
    state, hz0 = api.fit(explode, data, 1, state=state, draws=[masks()], guard=True)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    require(float(hz0.metrics.screened[0]) == 0.0, "the warm-up round screened an upload")
    log(f"(n) warm-up round (no faults, guarded): {warm_ms:.1f} ms, of which "
        f"{hz0.guard.alloc_s:.3f} s allocating {hz0.guard.snapshot_bytes / 1e9:.2f} GB of "
        f"page-locked host memory and {hz0.guard.snapshot_s:.3f} s copying the state into it")
    (x,), (z,), (y,) = (tree_leaves(getattr(state, f)) for f in ("params", "z", "y"))
    x, z, y = x.view(G, K, -1), z.view(G, K, -1), y.view(G, -1)

    def fingerprint(t):
        bits = t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
        return (int(bits.sum(dtype=torch.int64)), t[:UPLOAD_SPAN].clone(),
                t[-UPLOAD_SPAN:].clone())

    def same(a, b):
        return a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])

    rounds = []
    want = dict(lm_train_launches(cfg, n_update, 1), int8_roundtrip=0, topk_mask=0)
    for r, (eng, draw, kept) in enumerate((
            (explode, masks(crash=[(1, 1)], corrupt=[(0, 0)]),
             {"x[1,1]": lambda: x[1, 1], "z[1,1]": lambda: z[1, 1]}),
            (nan, masks(timeout=[1], corrupt=[(0, 1)]), {"y[1]": lambda: y[1]}))):
        before = {k: fingerprint(f()) for k, f in kept.items()}
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hz = api.fit(eng, data, 1, state=state, draws=[draw], guard=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        round_peak = torch.cuda.max_memory_allocated() / 1e9
        got = all_launches()
        require(got == want, f"(n) round {r + 1} launched {got}, expected {want}")
        screened = float(hz.metrics.screened[0])
        require(screened == LM_TRAIN_E, f"(n) round {r + 1} screened {screened}, expected "
                                        f"{LM_TRAIN_E} (one upload in each group round)")
        for k, f in kept.items():
            require(same(before[k], fingerprint(f())), f"(n) round {r + 1}: {k} changed")
        require(hz.guard.rollbacks == 0, f"(n) round {r + 1} rolled back")
        finite_metrics(np, hz)
        rounds.append({"round_ms": ms, "round_ms_less_snapshot": ms - 1e3 * hz.guard.snapshot_s,
                       "peak_gb": round_peak,
                       "screened": screened, "launches": got, "guard": hz.guard._asdict(),
                       "loss": hz.metrics.loss.reshape(-1).tolist(),
                       "kept_bits": sorted(kept)})
        log(f"(n) round {r + 1}: {ms:.1f} ms ({ms - 1e3 * hz.guard.snapshot_s:.1f} ms less the "
            f"guard's snapshot of {hz.guard.snapshot_bytes / 1e9:.2f} GB in "
            f"{hz.guard.snapshot_s:.3f} s); peak {round_peak:.2f} GB; screened {screened}; "
            f"{sorted(kept)} kept their bits; launches {got}")
    peak_gb = max(r["peak_gb"] for r in rounds)
    for name in ("params", "z", "y"):
        for t in tree_leaves(getattr(state, name)):
            require(finite_and_nonzero(torch, t)[0], f"(n): {name} is not finite")
    # A traced round with round 2's faults (a timeout, a NaN upload), guarded.
    tr = profile_round(torch, lambda: api.fit(nan, data, 1, state=state, draws=[
        masks(timeout=[1], corrupt=[(0, 1)])], guard=True))
    log_trace("  (n) LM training round under faults (flat, defended, guarded, traced)", tr,
              top_n=25)
    tokens = G * K * LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    ms = sum(r["round_ms"] for r in rounds) / len(rounds)
    ms_less = sum(r["round_ms_less_snapshot"] for r in rounds) / len(rounds)
    out = {"phase": "n", "arch": LM_TRAIN_ARCH, "layers": cfg.num_layers, "layout": "flat",
           "params": n_params, "defense": dataclasses.asdict(defense), "warmup_round_ms": warm_ms,
           "rounds": rounds, "round_ms": ms, "round_ms_less_snapshot": ms_less,
           "tokens_per_round": tokens, "tokens_per_s": tokens / ms * 1e3,
           "tokens_per_s_less_snapshot": tokens / ms_less * 1e3, "peak_gb": peak_gb,
           "held_gb": held_gb, "host_memory": meminfo,
           "warmup_guard": hz0.guard._asdict(),
           "busy_share": tr["busy"] / tr["wall_us"] if tr else None,
           "launches": {k: sum(r["launches"][k] for r in rounds) for k in want}}
    log(f"(n) LM training under faults, {LM_TRAIN_ARCH} ({cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B params), flat + fused, defended and guarded: {ms:.1f} ms a "
        f"round ({ms_less:.1f} ms less the snapshot; {out['tokens_per_s']:.0f} training "
        f"tokens/s); peak memory {peak_gb:.2f} GB over the two faulty rounds (of which "
        f"{held_gb:.2f} GB was held before the phase)")
    del state, explode, nan, data, x, z, y
    torch.cuda.empty_cache()
    return out


# Phases (o)-(q): async group rounds. The CNN's straggler shape is
# benchmarks/bench_async.py's: one group at E_g = 1 while the others run
# E = 2, so it reports every second window (staleness 1). glm4-9b runs two
# groups at (2, 1).
CNN_ASYNC_ROUNDS = (E,) * (GROUPS - 1) + (1,)
CNN_ASYNC_WINDOWS, CNN_ASYNC_CHUNK = 4, 2
LM_ASYNC_ROUNDS = (LM_TRAIN_E, 1)


def phase_async_hfl(torch, np, api, spec, data, p0, loss_fn) -> dict:
    """Phase (o): the CNN at full width on the simulator engine with group 9
    at E_9 = 1 of e_pad = 2 group rounds (it reports every second window).

    (o1) flat + fused, delay-compensated, ``CNN_ASYNC_WINDOWS`` windows
    through ``fit`` in chunks of 2 (a report cycle crosses a chunk): every
    ``mtgc_update_flat`` launch carries a mask, every tenth is held against
    its plain version on its own operands, group 9's rows keep their bits
    through each step of its idle iteration, and after each window its z
    (and, in a window it does not report, its params) are the ones its idle
    iteration started from; its ``snap`` changes only at windows 1 and 3;
    ``global_model`` is group 0's replica. Then two windows timed, and the
    peak. (o2) tree + fused, discount, one window: ``mtgc_update`` once per
    leaf per step. (o3) flat + fused, naive, a timeout injected in each of
    two windows (group 3, then the straggler in its report window): after
    each window ``dl`` is ``rep x any_obs`` and the timed-out group's y kept
    its bits."""
    from repro_torch.core.engine import RoundDraws
    from repro_torch.core.faults import FaultMasks, FaultPlan
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import mtgc_update as mu
    from repro_torch.kernels import ops

    G, K = spec.levels
    slow = G - 1
    out = {"group_rounds": list(CNN_ASYNC_ROUNDS)}
    launches = {"o1": {}, "o2": {}, "o3": {}}

    # --- (o1) ---
    o1 = dataclasses.replace(spec, schedule=api.RoundSchedule(CNN_ASYNC_ROUNDS, H),
                             staleness="delay_compensated")
    eng = api.build(o1, loss_fn)
    plan = o1.staleness_plan()
    require(plan.periods == (1,) * (G - 1) + (2,) and plan.fastest_group == 0,
            f"(o1) plan periods {plan.periods}")
    calls = {"n": 0, "masked": 0, "checked": 0, "idle_steps_kept": 0}
    idle_start = {}
    real = ops.mtgc_update_flat

    def spy(x, g, z, y, mask=None, **kw):
        i = calls["n"]
        calls["n"] += 1
        e, h, w = (i // H) % E, i % H, i // (E * H)
        if e == 1 and h == 0:
            idle_start[w] = (x[slow].clone(), z[slow].clone())
        before = x[slow].clone() if e == 1 else None
        res = real(x, g, z, y, mask, **kw)
        calls["masked"] += int(mask is not None)
        if e == 1:
            require(mask is not None and not bool(mask[slow].any())
                    and same_bits(torch, res[slow], before),
                    f"(o1) group {slow}'s rows changed in its idle iteration (call {i})")
            calls["idle_steps_kept"] += 1
        if i % 10 == 0:
            want = mu.mtgc_update_flat_ref(x, g, z, y, mask, kw["lr"], kw.get("g_scale", 1.0))
            require(same_bits(torch, res, want),
                    f"(o1) mtgc_update_flat disagrees with its plain version (call {i})")
            calls["checked"] += 1
        return res

    snap_changes = []

    def check(prev, st):
        w = int(prev.round)
        x0, z0 = idle_start[w]
        x, z = st.params.bufs["float32"], st.z.bufs["float32"]
        require(same_bits(torch, z[slow], z0), f"(o1) window {w}: group {slow}'s z changed after "
                                               f"its idle iteration began")
        if w % 2 == 0:
            require(same_bits(torch, x[slow], x0), f"(o1) window {w}: group {slow} did not "
                                                   f"report, yet its params changed")
        else:
            require(torch.equal(x[slow], x[0]), f"(o1) window {w}: group {slow} reported but "
                                                f"did not download")
        changed = not same_bits(torch, st.snap.bufs["float32"][slow],
                                prev.snap.bufs["float32"][slow])
        snap_changes.append(changed)
        gm, g0 = eng.global_model(st), st.params.packer.unflatten(
            {k: b[0, 0] for k, b in st.params.bufs.items()})
        require(all(torch.equal(gm[a][b], g0[a][b]) for a in gm for b in gm[a]),
                f"(o1) window {w}: global_model is not group 0's replica")
        return {"snap_changed": float(changed)}

    ops.reset_launch_counts()
    ops.mtgc_update_flat = spy
    try:
        st, hz = api.fit(eng, data, CNN_ASYNC_WINDOWS, params=p0, chunk=CNN_ASYNC_CHUNK,
                         eval_every=1, eval_fn=check)
        torch.cuda.synchronize()
    finally:
        ops.mtgc_update_flat = real
    n_launch = E * H * CNN_ASYNC_WINDOWS
    require(mu.mtgc_update_flat.launches == n_launch and calls["masked"] == n_launch,
            f"(o1) mtgc_update_flat launched {mu.mtgc_update_flat.launches} times "
            f"({calls['masked']} with a mask), expected {n_launch} masked")
    require(mu.mtgc_update.launches == 0, "(o1) the flat path launched the per-leaf kernel")
    require(snap_changes == [False, True, False, True],
            f"(o1) group {slow}'s snap changed at windows {snap_changes}, expected 1 and 3")
    finite_metrics(np, hz)
    launches["o1"] = {"mtgc_update_flat": mu.mtgc_update_flat.launches}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, hz2 = api.fit(eng, data, 2, state=st, chunk=2)
    torch.cuda.synchronize()
    o1_ms = (time.perf_counter() - t0) * 1e3 / 2
    o1_peak = torch.cuda.max_memory_allocated() / 1e9
    finite_metrics(np, hz2)
    for f in ("params", "z", "y", "snap", "glob"):
        require(bool(torch.isfinite(getattr(st, f).bufs["float32"]).all()), f"(o1) {f} not finite")
    out["o1"] = {"policy": "delay_compensated", "windows": CNN_ASYNC_WINDOWS,
                 "chunk": CNN_ASYNC_CHUNK, "window_ms": o1_ms, "peak_gb": o1_peak,
                 "launches": calls["n"], "masked_launches": calls["masked"],
                 "kernel_checks": calls["checked"], "idle_steps_kept": calls["idle_steps_kept"],
                 "snap_changed": snap_changes,
                 "loss": np.round(hz.metrics.loss.reshape(CNN_ASYNC_WINDOWS, -1).mean(1),
                                  5).tolist(),
                 "comm_bytes": hz.metrics.comm_bytes.tolist()}
    log(f"(o1) async CNN, flat + fused, delay_compensated, group_rounds (2 x 9, 1): "
        f"{CNN_ASYNC_WINDOWS} windows in chunks of {CNN_ASYNC_CHUNK}; mtgc_update_flat "
        f"{calls['n']} launches, all masked, {calls['checked']} held bit-exact against the "
        f"plain version; group {slow}'s rows kept their bits in {calls['idle_steps_kept']} "
        f"idle steps; its snap changed at windows {snap_changes}; global_model = group 0's "
        f"replica; then {o1_ms:.1f} ms a window, peak {o1_peak:.2f} GB; mean loss a window "
        f"{out['o1']['loss']}")
    del st, hz, eng, idle_start

    # --- (o2) ---
    eng = api.build(dataclasses.replace(o1, staleness="discount", state_layout="tree"), loss_fn)
    st = eng.init(p0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st, hz = api.fit(eng, data, 1, state=st)
    torch.cuda.synchronize()
    o2_ms = (time.perf_counter() - t0) * 1e3
    n_leaves = len(tree_leaves(st.params))
    require(mu.mtgc_update.launches == E * H * n_leaves and mu.mtgc_update_flat.launches == 0,
            f"(o2) mtgc_update launched {mu.mtgc_update.launches} times, expected "
            f"{E * H * n_leaves}")
    finite_metrics(np, hz)
    launches["o2"] = {"mtgc_update": mu.mtgc_update.launches}
    out["o2"] = {"policy": "discount", "layout": "tree", "window_ms": o2_ms,
                 "launches": mu.mtgc_update.launches}
    log(f"(o2) async CNN, tree + fused, discount: one window {o2_ms:.1f} ms (first window of "
        f"this spec); mtgc_update launches {mu.mtgc_update.launches}")
    del st, hz, eng

    # --- (o3) ---
    o3 = dataclasses.replace(o1, staleness="naive", faults=FaultPlan(timeout_rate=0.1))
    eng = api.build(o3, loss_fn)
    plan = o3.staleness_plan()
    timed_out = (3, slow)

    def tdraw(g):
        t = torch.zeros(G)
        t[g] = 1.0
        return RoundDraws(faults=FaultMasks(torch.zeros(G, K), t, torch.zeros(G, K)))

    dls = []

    def check3(prev, st):
        w = int(prev.round)
        g = timed_out[w]
        rep = plan.report_mask(torch.tensor(w, dtype=torch.int32)).cpu()
        rep[g] = 0.0
        require(torch.equal(st.dl.cpu(), rep), f"(o3) window {w}: dl {st.dl.tolist()}, "
                                               f"expected {rep.tolist()}")
        require(same_bits(torch, st.y.bufs["float32"][g], prev.y.bufs["float32"][g]),
                f"(o3) window {w}: the timed-out group {g}'s y changed")
        dls.append(st.dl.tolist())
        return {"dl_sum": st.dl.sum()}

    ops.reset_launch_counts()
    st, hz = api.fit(eng, data, 2, params=p0, chunk=1, eval_every=1, eval_fn=check3,
                     draws=[tdraw(g) for g in timed_out])
    torch.cuda.synchronize()
    require(mu.mtgc_update_flat.launches == E * H * 2, "(o3) mtgc_update_flat launches")
    finite_metrics(np, hz)
    launches["o3"] = {"mtgc_update_flat": mu.mtgc_update_flat.launches}
    out["o3"] = {"policy": "naive", "timed_out": list(timed_out), "dl": dls,
                 "launches": mu.mtgc_update_flat.launches}
    log(f"(o3) async CNN, flat + fused, naive, timeouts of groups {timed_out} in windows 0 and "
        f"1: dl after each window {dls} (= rep x any_obs); the timed-out groups' y kept their "
        f"bits")
    del st, hz, eng
    out["launches"] = launches
    return out


def phase_lm_train_async(torch, np, tag: str, layout: str, spec_kw: dict, draws: list,
                         kept: list) -> dict:
    """Phases (p) and (q): glm4-9b at its published widths (2 of 40 layers),
    2 x 2, bf16, remat, on the sharded backend at ``group_rounds = (2, 1)``
    (``LM_ASYNC_ROUNDS``) with the spec fields ``spec_kw``: a warm-up window
    (t = 0: only group 0 reports), a timed window (t = 1: group 1 reports one
    window stale) and a traced one, with ``draws`` (one ``RoundDraws`` or
    None per window). The launch counts of one window are (i)'s reckoning
    (per-client gradients run at the static shape; the idle replicas'
    updates are masked); ``kept`` (replica rows ``("x"|"z", g, k)`` or
    ``("y", g)``) keep their bits through the timed window. Two token rates:
    every computed microbatch's tokens, and the tokens that entered an
    update (live iterations of active clients)."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.lm import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH), num_layers=LM_TRAIN_LAYERS)
    bundle = build_model(cfg)
    G, K = LM_TRAIN_LEVELS
    spec = api.ExperimentSpec(
        levels=(G, K), backend="sharded", algorithm="mtgc", lr=LM_TRAIN_LR, fusion="fused",
        state_layout=layout, schedule=api.RoundSchedule(
            group_rounds=LM_ASYNC_ROUNDS, local_steps=LM_TRAIN_H, microbatches=LM_TRAIN_A),
        **spec_kw)
    plan = spec.staleness_plan()
    engine = api.build(spec, bundle.loss)
    rng = np.random.default_rng(0)
    toks, _ = make_lm_tokens(rng, cfg.vocab_size, LM_TRAIN_TOKENS)
    data = engine.pack_tokens(toks, batch_size=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ, shards=2,
                              rng=rng, generator=torch.Generator().manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    params = bundle.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = engine.init(params)
    del params
    torch.cuda.synchronize()
    n_update = len(tree_leaves(state.params))
    state_gb = sum(t.numel() * t.element_size()
                   for f in ("params", "z", "y", "snap", "glob") if getattr(state, f) is not None
                   for t in tree_leaves(getattr(state, f))) / 1e9
    t0 = time.perf_counter()
    state, hz0 = api.fit(engine, data, 1, state=state, draws=[draws[0]])       # t = 0
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_peak = torch.cuda.max_memory_allocated() / 1e9

    def rows(t, lead):
        return t.view(*lead, -1)

    x_l, z_l, y_l = (tree_leaves(getattr(state, f)) for f in ("params", "z", "y"))
    # Before the stale report: group 1 has not downloaded window 0's global
    # model, and (delay compensation) its snapshot lags the global one.
    spans = [slice(0, UPLOAD_SPAN), slice(-UPLOAD_SPAN, None)]
    m0 = draws[0].masks.client if draws[0] is not None and draws[0].masks is not None else None
    k0, k1 = (0, 0) if m0 is None else (int(m0[0].argmax()), int(m0[1].argmax()))
    require(not all(torch.equal(rows(t, (G, K))[1, k1, s], rows(t, (G, K))[0, k0, s])
                    for t in x_l for s in spans),
            f"({tag}) group 1 downloaded in window 0")
    if state.snap is not None:
        require(not all(torch.equal(rows(sn, (G,))[1, s], gl.view(-1)[s])
                        for sn, gl in zip(tree_leaves(state.snap), tree_leaves(state.glob))
                        for s in spans),
                f"({tag}) glob - snap_1 is zero before the stale report")

    def fingerprints():
        out = []
        for what, *idx in kept:
            leaves = {"x": (x_l, (G, K)), "z": (z_l, (G, K)), "y": (y_l, (G,))}[what]
            for t in leaves[0]:
                r = rows(t, leaves[1])[tuple(idx)]
                bits = r.view({2: torch.int16, 4: torch.int32}[r.element_size()])
                out.append((int(bits.sum(dtype=torch.int64)), r[:UPLOAD_SPAN].clone(),
                            r[-UPLOAD_SPAN:].clone()))
        return out

    before = fingerprints()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, hz = api.fit(engine, data, 1, state=state, draws=[draws[1]])        # t = 1
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    timed_peak = torch.cuda.max_memory_allocated() / 1e9
    got = all_launches()
    want = dict(lm_train_launches(cfg, n_update, 1), int8_roundtrip=0, topk_mask=0)
    require(got == want, f"({tag}) launched {got}, expected {want}")
    require(all(a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
                for a, b in zip(before, fingerprints())),
            f"({tag}) a kept row ({kept}) changed in the timed window")
    finite_metrics(np, hz0)
    finite_metrics(np, hz)
    for f in ("params", "z", "y", "snap", "glob"):
        if getattr(state, f) is not None:
            for t in tree_leaves(getattr(state, f)):
                require(finite_and_nonzero(torch, t)[0], f"({tag}) {f} is not finite")
    after = {"round": int(state.round), "dl": None if state.dl is None else state.dl.tolist()}
    if state.snap is not None:
        require(all(torch.equal(rows(sn, (G,))[g, s], gl.view(-1)[s])
                    for sn, gl in zip(tree_leaves(state.snap), tree_leaves(state.glob))
                    for g in range(G) for s in spans),
                f"({tag}) a group that reported at t = 1 did not record the global model")
    res = {}
    tr = profile_round(torch, lambda: res.setdefault(                             # t = 2
        "fit", api.fit(engine, data, 1, state=state, draws=[draws[2]])))
    log_trace(f"  ({tag}) async LM training window ({layout}, traced)", tr, top_n=20)
    finite_metrics(np, res["fit"][1])
    tok = LM_TRAIN_H * LM_TRAIN_A * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    computed = G * K * plan.e_pad * tok
    masks = draws[1].masks if draws[1] is not None and draws[1].masks is not None else None
    active = (K * np.ones(G) if masks is None
              else np.asarray(masks.client.cpu()).sum(axis=1))
    live = int(sum(e * a for e, a in zip(LM_ASYNC_ROUNDS, active))) * tok
    peak = max(warm_peak, timed_peak)
    out = {"phase": tag, "arch": LM_TRAIN_ARCH, "layers": cfg.num_layers, "layout": layout,
           "group_rounds": list(LM_ASYNC_ROUNDS),
           "spec": {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
                    for k, v in spec_kw.items()},
           "params": n_params, "state_gb": state_gb, "warmup_round_ms": warm_ms,
           "round_ms": round_ms, "tokens_computed_per_round": computed,
           "tokens_computed_per_s": computed / round_ms * 1e3,
           "tokens_updating_per_round": live, "tokens_updating_per_s": live / round_ms * 1e3,
           "peak_gb": peak, "warmup_peak_gb": warm_peak, "timed_peak_gb": timed_peak,
           "held_gb": held_gb, "launches": got, "kept_rows": [list(k) for k in kept],
           "after_timed_window": after,
           "busy_share": tr["busy"] / tr["wall_us"] if tr else None,
           "losses": [float(v) for v in np.concatenate([hz0.metrics.loss.reshape(-1),
                                                        hz.metrics.loss.reshape(-1)])]}
    log(f"({tag}) async LM training {LM_TRAIN_ARCH} ({cfg.num_layers} of 40 layers, "
        f"{n_params / 1e9:.3f} B params, bf16, remat), {layout} + fused, group_rounds "
        f"{LM_ASYNC_ROUNDS}, {json.dumps(out['spec'])}: warm-up window {warm_ms:.1f} ms, timed "
        f"window (t = 1: group 1's stale report is due) {round_ms:.1f} ms: "
        f"{out['tokens_computed_per_s']:.0f} tokens/s of computed microbatches ({computed} a "
        f"window), {out['tokens_updating_per_s']:.0f} tokens/s that entered an update ({live} a "
        f"window); state {state_gb:.2f} GB, peak {peak:.2f} GB (of which {held_gb:.2f} GB was "
        f"held before the phase; warm-up {warm_peak:.2f}, timed {timed_peak:.2f}); launches "
        f"{got} (reckoned as (i)); kept rows {kept} with their bits; after the timed window "
        f"{after}")
    del state, engine, data, res, x_l, z_l, y_l
    torch.cuda.empty_cache()
    return out


# Phases (r)-(t): virtual client populations and checkpoints. (r) runs path
# (a) (the CNN, 10 x 10 materialized) with a host store of P clients a group,
# (s) glm4-9b's flat path (i) with P = 4 a group (3 when the host has less
# than 70 GB available), (t) checkpoints of path (a). Cohorts, shard ids and
# the checks' draws come from CPU generators seeded with POP_SEED.
POP_ROUNDS, POP_SEED = 4, 3
POP_P1, POP_P2, POP_TREE_P, POP_CKPT_P = 100, 50, 100, 20
POP_SAT_OUT_ROWS = 8                      # rows (r1) records for its sat-out check
LM_POP_P, LM_POP_P_LOW, LM_POP_MIN_AVAILABLE = 4, 3, 70e9
LM_POP_ROUNDS, LM_POP_CHUNK = 4, 2
CKPT_MIN_FREE = 12e9


def host_memory() -> dict:
    """MemTotal and MemAvailable in bytes, from /proc/meminfo."""
    return {line.split(":")[0]: int(line.split()[1]) * 1024
            for line in Path("/proc/meminfo").read_text().splitlines()
            if line.split(":")[0] in ("MemTotal", "MemAvailable")}


def update_launches() -> dict:
    from repro_torch.kernels import mtgc_update as mu

    return {"mtgc_update_flat": mu.mtgc_update_flat.launches,
            "mtgc_update": mu.mtgc_update.launches}


def same_state(torch, a, b, fields=("params", "z", "y")) -> bool:
    """Every tensor of the named fields of two flat or tree states holds
    the same bits (float32 compared as int32, so NaN positions count)."""
    from repro_torch.core.tree import tree_leaves

    return all(same_bits(torch, x, y) for f in fields
               for x, y in zip(tree_leaves(getattr(a, f)), tree_leaves(getattr(b, f))))


def same_store(np, a, b) -> bool:
    return a.fields == b.fields and all(np.array_equal(a.data[f][k], b.data[f][k])
                                        for f in a.fields for k in a.data[f])


def store_steps(store, before: dict | None = None) -> dict:
    """The store's host-step seconds (less ``before``'s)."""
    return {k: v - (before or {}).get(k, 0.0) for k, v in store.seconds.items()}


def phase_population_hfl(torch, np, api, spec, data, p0, loss_fn) -> dict:
    """Phase (r): path (a) with a virtual population on the simulator engine.

    (r0) population 10 = K: 2 rounds in chunks of 1 against (a) from the
    same state and shard ids, deterministic cuDNN: the state bit for bit,
    and the store equal to the final z. (r1) population 100 a group (an
    8.63 GB float32 store): 4 rounds in chunks of 1 with the same injected
    cohorts and shard ids, overlapped and sequential, deterministic cuDNN:
    the same bits in state and store; clients that sat out keep the rows
    their last chunk left; then (a) and (r1) timed in the same run (4 rounds
    each, chunk 1, the store's own draws), the host steps apart, the
    page-locked copies alone, and the device peaks. (r2) population 50,
    overlapped, timed. (r3) ``client_state="stateless"``: 2 rounds, no
    store, z zero at each round's start. (r4) tree layout at population
    100: 2 rounds, ``mtgc_update`` once per leaf per step; the store's rows
    of the last cohort are the final z through the segment table."""
    from repro_torch.core.population import (
        CohortBuffers,
        draw_cohort,
        run_population_rounds,
        stateless_round,
    )
    from repro_torch.kernels import ops

    G, K = spec.levels
    out, launches = {}, {}
    mem = host_memory()
    log(f"(r) host memory: MemTotal {mem['MemTotal'] / 1e9:.1f} GB, MemAvailable "
        f"{mem['MemAvailable'] / 1e9:.1f} GB")
    out["host_memory"] = mem
    gen = torch.Generator().manual_seed(POP_SEED)
    sids = torch.randint(0, data.num_shards, (POP_ROUNDS, E, G, K), generator=gen)

    def fit(sp, T, **kw):
        """One ``fit`` through ``sp``'s engine from a fresh state, the
        counts and the peak reset just before it; its store is made
        beforehand unless ``store=False``."""
        make_store = kw.pop("store", True)
        eng = api.build(sp, loss_fn)
        st = eng.init(p0)
        store = (eng.init_population(st, torch.Generator().manual_seed(POP_SEED))
                 if make_store and sp.population is not None and sp.client_state == "stateful"
                 else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        before = dict(store.seconds) if store is not None else None
        t0 = time.perf_counter()
        st, hz = api.fit(eng, data, T, state=st, population_store=store, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        finite_metrics(np, hz)
        run = {"ms_per_round": sec * 1e3 / T, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": update_launches()}
        if store is not None:
            run["host_steps_s"] = store_steps(store, before)
        return eng, st, hz, run

    # --- (r0) P == K against (a) ---
    torch.backends.cudnn.deterministic = True
    try:
        _, s_a, _, _ = fit(spec, 2, shard_ids=sids[:2], chunk=1)
        _, s_r0, hz_r0, run = fit(dataclasses.replace(spec, population=K), 2,
                                  shard_ids=sids[:2], chunk=1)
    finally:
        torch.backends.cudnn.deterministic = False
    require(same_state(torch, s_a, s_r0), "(r0) population == K: the state differs from (a)'s")
    z = s_r0.z.bufs["float32"].cpu().numpy()
    require(np.array_equal(hz_r0.population.data["z"]["float32"].view(np.uint32),
                           z.view(np.uint32)), "(r0) the store is not the final z")
    require(run["launches"]["mtgc_update_flat"] == 2 * E * H, f"(r0) launches {run['launches']}")
    launches["r0"] = run["launches"]
    out["r0"] = run
    log(f"(r0) population {K} = cohort: 2 rounds bit for bit (a)'s (deterministic cuDNN, same "
        f"state and shard ids); the store is the final z")
    del s_a, s_r0, hz_r0, z

    # --- (r1) population 100: overlapped against sequential ---
    cohorts = np.stack([draw_cohort(gen, G, POP_P1, K) for _ in range(POP_ROUNDS)])
    last = {}                                  # (g, client) -> (last chunk drawn, slot)
    for c, co in enumerate(cohorts):
        for g in range(G):
            for k, client in enumerate(co[g]):
                last[(g, int(client))] = (c, k)
    sat_out = sorted((key for key, (c, _) in last.items() if c < POP_ROUNDS - 1),
                     key=lambda key: last[key])[:POP_SAT_OUT_ROWS]
    require(sat_out, "(r1) no client sat out after its last chunk")
    p1 = dataclasses.replace(spec, population=POP_P1)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for overlap in (True, False):
            rows, rnd = {}, {"i": 0}

            def record(prev, st):
                for g, client in sat_out:
                    c, k = last[(g, client)]
                    if c == rnd["i"]:
                        row = st.z.bufs["float32"][g, k]
                        rows[(g, client)] = row.to("cpu", copy=True).numpy()
                rnd["i"] += 1
                return {"n": torch.zeros(())}

            eng, st, hz, run = fit(p1, POP_ROUNDS, chunk=1, overlap=overlap, cohorts=cohorts,
                                   shard_ids=sids, eval_fn=record)
            runs[overlap] = (st, hz.population, rows, run)
        del eng, st, hz
    finally:
        torch.backends.cudnn.deterministic = False
    (s_o, store_o, rows_o, run_o), (s_s, store_s, rows_s, _) = runs[True], runs[False]
    require(same_state(torch, s_o, s_s), "(r1) overlapped and sequential states differ")
    require(same_store(np, store_o, store_s), "(r1) overlapped and sequential stores differ")
    for (g, client), row in rows_o.items():
        require(np.array_equal(store_o.data["z"]["float32"][g, client].view(np.uint32),
                               row.view(np.uint32)) and np.array_equal(row, rows_s[(g, client)]),
                f"(r1) client ({g}, {client}) sat out and lost its row's bits")
    drawn = np.zeros((G, POP_P1), bool)
    for co in cohorts:
        drawn[np.arange(G)[:, None], co] = True
    require(not any(store_o.data["z"]["float32"][g, c].any()
                    for g, c in zip(*np.nonzero(~drawn))),
            "(r1) a client never drawn has a nonzero row")
    require(run_o["launches"]["mtgc_update_flat"] == POP_ROUNDS * E * H,
            f"(r1) launches {run_o['launches']}")
    launches["r1"] = run_o["launches"]
    out["r1_check"] = {"cohorts": cohorts.tolist(), "sat_out_rows_checked": len(rows_o),
                       "store_bytes": store_o.state_bytes(),
                       "refresh_s": store_o.seconds["refresh"]}
    log(f"(r1) population {POP_P1} a group ({store_o.state_bytes() / 1e9:.2f} GB store): "
        f"{POP_ROUNDS} rounds in chunks of 1, cohorts injected, overlapped and sequential "
        f"bit for bit in state and store (deterministic cuDNN); {len(rows_o)} clients that "
        f"sat out kept their rows' bits; never-drawn rows zero")
    del runs, s_o, s_s, store_o, store_s, rows_o, rows_s

    # --- (r1)/(r2) timed against (a), in turns ---
    timing = {}
    for tag, sp, kw in (("a", spec, {}), ("r1", p1, {"overlap": True}),
                        ("r1_sequential", p1, {"overlap": False}),
                        ("r2", dataclasses.replace(spec, population=POP_P2), {"overlap": True}),
                        ("a_again", spec, {})):
        _, st, hz, run = fit(sp, POP_ROUNDS, chunk=1, **kw)
        timing[tag] = run
        del st, hz
    for tag in ("r1", "r1_sequential", "r2"):
        require(timing[tag]["peak_gb"] <= timing["a"]["peak_gb"] + 0.01,
                f"({tag}) peak {timing[tag]['peak_gb']:.4f} GB above (a)'s "
                f"{timing['a']['peak_gb']:.4f} GB")
    out["timing"] = timing
    a_ms = (timing["a"]["ms_per_round"] + timing["a_again"]["ms_per_round"]) / 2
    for tag in ("r1", "r1_sequential", "r2"):
        t = timing[tag]
        log(f"({tag}) {t['ms_per_round']:.1f} ms a round against (a)'s {a_ms:.1f} "
            f"({timing['a']['ms_per_round']:.1f}, {timing['a_again']['ms_per_round']:.1f}); "
            f"peak {t['peak_gb']:.4f} GB against {timing['a']['peak_gb']:.4f}; host steps "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in t["host_steps_s"].items())
            + f" over {POP_ROUNDS} chunks")

    # The copies alone, one cohort: page-locked H2D (install) and D2H
    # (extract), each waited for; the host row copies (gather, scatter).
    # The buffers come from PyTorch's page-locked host cache here; (s) times
    # the locking itself.
    eng = api.build(p1, loss_fn)
    st = eng.init(p0)
    store = eng.init_population(st)
    bufs = [CohortBuffers(store, K, pin=True) for _ in range(2)]
    idx = cohorts[0]
    steps = {}
    for _ in range(2):                                   # the second reading is kept
        t0 = time.perf_counter()
        store.gather(idx, out=bufs[0])
        steps["gather_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.install(st, bufs[0])
        torch.cuda.synchronize()
        steps["install_h2d_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = store.extract(st, out=bufs[1])
        steps["extract_d2h_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        store.scatter(idx, host)
        steps["scatter_ms"] = (time.perf_counter() - t0) * 1e3
    nbytes = bufs[0].nbytes
    steps.update(cohort_bytes=nbytes, h2d_gb_per_s=nbytes / steps["install_h2d_ms"] / 1e6,
                 d2h_gb_per_s=nbytes / steps["extract_d2h_ms"] / 1e6,
                 gather_gb_per_s=nbytes / steps["gather_ms"] / 1e6,
                 scatter_gb_per_s=nbytes / steps["scatter_ms"] / 1e6)
    out["copies"] = steps
    log(f"(r1) one cohort's {nbytes / 1e9:.3f} GB alone: gather {steps['gather_ms']:.1f} ms "
        f"({steps['gather_gb_per_s']:.1f} GB/s), install (H2D, page-locked) "
        f"{steps['install_h2d_ms']:.1f} ms ({steps['h2d_gb_per_s']:.1f} GB/s), extract (D2H) "
        f"{steps['extract_d2h_ms']:.1f} ms ({steps['d2h_gb_per_s']:.1f} GB/s), scatter "
        f"{steps['scatter_ms']:.1f} ms ({steps['scatter_gb_per_s']:.1f} GB/s); each the second "
        f"of two readings (the first touches the rows)")
    del eng, st, store, bufs, host

    # --- (r3) stateless ---
    base = api.build(spec, loss_fn)
    less = api.build(dataclasses.replace(spec, population=POP_P1, client_state="stateless"),
                     loss_fn)
    zero_starts = []

    def spy(state, batches, **kw):
        zero_starts.append(not bool(state.z.bufs["float32"].any()))
        return base.round_fn(state, batches, **kw)

    less.round_fn = stateless_round(spy, ("z", "dyn"))
    ops.reset_launch_counts()
    st, hz = api.fit(less, data, 2, params=p0)
    torch.cuda.synchronize()
    finite_metrics(np, hz)
    require(hz.population is None, "(r3) a stateless run made a store")
    require(zero_starts == [True, True], f"(r3) z at the rounds' starts zero: {zero_starts}")
    require(bool(st.z.bufs["float32"].any()), "(r3) z stayed zero within the rounds")
    launches["r3"] = update_launches()
    require(launches["r3"]["mtgc_update_flat"] == 2 * E * H, f"(r3) launches {launches['r3']}")
    log("(r3) stateless: 2 rounds, no store, z zero at each round's start")
    del base, less, st, hz

    # --- (r4) tree layout at population 100 ---
    tree = dataclasses.replace(spec, population=POP_TREE_P, state_layout="tree")
    tco = np.stack([draw_cohort(gen, G, POP_TREE_P, K) for _ in range(2)])
    eng, st, hz, run = fit(tree, 2, chunk=1, cohorts=tco)
    store = hz.population
    n_leaves = len(store.packers["z"].segments)
    require(run["launches"] == {"mtgc_update_flat": 0, "mtgc_update": 2 * E * H * n_leaves},
            f"(r4) launches {run['launches']}")
    flat_z = store.packers["z"].flatten(st.z).bufs["float32"].cpu().numpy()
    rows = store.data["z"]["float32"][np.arange(G)[:, None], tco[-1]]
    require(np.array_equal(rows.view(np.uint32), flat_z.view(np.uint32)),
            "(r4) the store's rows of the last cohort are not the final z")
    launches["r4"] = run["launches"]
    out["r4"] = run
    log(f"(r4) tree layout, population {POP_TREE_P}: 2 rounds, {run['ms_per_round']:.1f} ms a "
        f"round (the first tree rounds of the run); mtgc_update launches "
        f"{run['launches']['mtgc_update']}; the last cohort's store rows are the final z")
    del eng, st, hz, store
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def phase_checkpoint_hfl(torch, np, api, spec, data, p0, loss_fn) -> dict:
    """Phase (t): checkpoints of path (a), deterministic cuDNN. ``fit`` over
    4 rounds with ``checkpoint_every=2``; the round-4 files deleted;
    ``resume=True`` gives the uninterrupted state bit for bit. Then
    ``{"state", "population"}`` at population 20 a group saved, restored,
    and continued 2 rounds: bit for bit the original continuation. File
    bytes, save and restore seconds."""
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.kernels import ops

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(tmp).free
    log(f"(t) checkpoint directory {tmp}: {free / 1e9:.1f} GB free")
    require(free >= CKPT_MIN_FREE, f"(t) {free / 1e9:.1f} GB free in the temp directory; the "
                                   f"checkpoints need {CKPT_MIN_FREE / 1e9:.0f} GB")
    out = {"free_bytes": free}
    torch.backends.cudnn.deterministic = True
    try:
        eng = api.build(spec, loss_fn)
        run_dir = os.path.join(tmp, "fit")
        gen0 = data.generator.get_state()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        s_a, h_a = api.fit(eng, data, 4, params=p0, checkpoint_every=2, checkpoint_path=run_dir)
        torch.cuda.synchronize()
        out["fit_with_autosave_s"] = time.perf_counter() - t0
        out["launches"] = update_launches()
        files = sorted(os.listdir(run_dir))
        require(files == ["ckpt_00000002.json", "ckpt_00000002.npz", "ckpt_00000004.json",
                          "ckpt_00000004.npz"], f"(t) autosaved files {files}")
        out["state_file_bytes"] = os.path.getsize(os.path.join(run_dir, "ckpt_00000004.npz"))
        for name in ("ckpt_00000004.npz", "ckpt_00000004.json"):
            os.remove(os.path.join(run_dir, name))
        data.generator.set_state(gen0)
        t0 = time.perf_counter()
        s_b, h_b = api.fit(eng, data, 4, params=p0, checkpoint_every=2, checkpoint_path=run_dir,
                           resume=True)
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t0
        require(len(h_b.metrics.loss) == 2 and np.array_equal(h_b.metrics.loss,
                                                               h_a.metrics.loss[2:]),
                "(t) the resumed run did not run rounds 3-4 with the same losses")
        require(same_state(torch, s_a, s_b, ("params", "z", "y", "dyn")),
                "(t) the resumed state is not the uninterrupted one")
        log(f"(t) fit(checkpoint_every=2) over 4 rounds ({out['fit_with_autosave_s']:.2f} s with "
            f"two saves of {out['state_file_bytes'] / 1e9:.3f} GB); round-4 files deleted; "
            f"resume=True ({out['resume_s']:.2f} s) gives the uninterrupted state bit for bit")
        del s_a, s_b, eng

        pe = api.build(dataclasses.replace(spec, population=POP_CKPT_P), loss_fn)
        st = pe.init(p0)
        store = pe.init_population(st)
        st, hz = api.fit(pe, data, 2, state=st, population_store=store, chunk=1)
        torch.cuda.synchronize()
        gen1 = data.generator.get_state()
        pair_dir = os.path.join(tmp, "pair")
        t0 = time.perf_counter()
        path = checkpoint.save(pair_dir, 2, {"state": st, "population": store})
        out["pair_save_s"] = time.perf_counter() - t0
        out["pair_file_bytes"] = os.path.getsize(path)
        like_state = pe.init(p0)
        like = {"state": like_state, "population": pe.init_population(like_state)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = checkpoint.restore(pair_dir, 2, like)
        torch.cuda.synchronize()
        out["pair_restore_s"] = time.perf_counter() - t0
        del like, like_state
        require(same_state(torch, back["state"], st, ("params", "z", "y", "dyn"))
                and same_store(np, back["population"], store)
                and torch.equal(back["population"].generator.get_state(),
                                store.generator.get_state()),
                "(t) the restored {state, population} differs from the saved one")
        a, _ = api.fit(pe, data, 2, state=st, population_store=store, chunk=1)
        data.generator.set_state(gen1)
        b, _ = api.fit(pe, data, 2, state=back["state"], population_store=back["population"],
                       chunk=1)
        torch.cuda.synchronize()
        require(same_state(torch, a, b, ("params", "z", "y", "dyn"))
                and same_store(np, store, back["population"]),
                "(t) the restored pair's continuation differs from the original's")
        out["store_bytes"] = store.state_bytes()
        log(f"(t) {{state, population}} at population {POP_CKPT_P} a group (store "
            f"{store.state_bytes() / 1e9:.3f} GB): file {out['pair_file_bytes'] / 1e9:.3f} GB, "
            f"save {out['pair_save_s']:.2f} s, restore {out['pair_restore_s']:.2f} s; 2 more "
            f"rounds from the restored pair bit for bit the original continuation")
        del pe, st, store, back, a, b
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def phase_lm_population(torch, np, peak_i_gb: float) -> dict:
    """Phase (s): path (i) (glm4-9b at full width, 2 of 40 layers, flat +
    fused, bf16, 2 x 2) with a virtual population of ``LM_POP_P`` clients a
    group (``LM_POP_P_LOW`` when MemAvailable is under 70 GB), overlapped,
    in chunks of ``LM_POP_CHUNK``. A checked run of 4 rounds (two injected
    cohorts, printed): at the first round of the second chunk the installed
    z equals the store rows of the second cohort bit for bit, and a
    first-cohort client the second cohort does not draw keeps its store
    bits to the end. Then a timed run of 4 more rounds (the store's own
    draws, printed beforehand): each chunk's time, each host step, the
    device peak against (i)'s, the host bytes."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.core.population import CohortBuffers, draw_cohort
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.lm import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model

    empty_host_cache = getattr(torch._C, "_host_emptyCache", None)
    if empty_host_cache is not None:
        empty_host_cache()          # return earlier phases' cached page-locked memory
    mem = host_memory()
    P = LM_POP_P if mem["MemAvailable"] >= LM_POP_MIN_AVAILABLE else LM_POP_P_LOW
    log(f"(s) host memory: MemTotal {mem['MemTotal'] / 1e9:.1f} GB, MemAvailable "
        f"{mem['MemAvailable'] / 1e9:.1f} GB: population {P} a group")
    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH), num_layers=LM_TRAIN_LAYERS)
    bundle = build_model(cfg)
    G, K = LM_TRAIN_LEVELS
    spec = api.ExperimentSpec(
        levels=(G, K), backend="sharded", algorithm="mtgc", lr=LM_TRAIN_LR, fusion="fused",
        state_layout="flat", population=P, schedule=api.RoundSchedule(
            group_rounds=LM_TRAIN_E, local_steps=LM_TRAIN_H, microbatches=LM_TRAIN_A))
    engine = api.build(spec, bundle.loss)
    rng = np.random.default_rng(0)
    toks, _ = make_lm_tokens(rng, cfg.vocab_size, LM_TRAIN_TOKENS)
    data = engine.pack_tokens(toks, batch_size=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                              shards=2, rng=rng, generator=torch.Generator().manual_seed(1))
    state = engine.init(bundle.init(0))
    torch.cuda.synchronize()
    n_update = len(tree_leaves(state.params))
    t0 = time.perf_counter()
    store = engine.init_population(state, torch.Generator().manual_seed(POP_SEED))
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bufs = [CohortBuffers(store, K, pin=True) for _ in range(2)]
    pin_s = time.perf_counter() - t0
    cohort_bytes = bufs[0].nbytes
    del bufs                        # cached by PyTorch's host allocator for the runs
    key = "bfloat16"
    N = store.data["z"][key].shape[-1]
    log(f"(s) store [{G}, {P}, {N}] bf16: {store.state_bytes() / 1e9:.2f} GB on the host "
        f"(made and seeded from the state in {store_s:.2f} s); two page-locked cohort buffers "
        f"of {cohort_bytes / 1e9:.2f} GB each locked in {pin_s:.2f} s")

    # --- the checked run ---
    co = np.array([[[0, 1], [P - 1, 0]], [[1, 2], [0, 1]]])
    log(f"(s) checked run: cohorts {co.tolist()} (chunks of {LM_POP_CHUNK} rounds)")
    seen = {"round": 0, "checked": False}
    kept = {}
    real = engine.round_fn

    def spy(st, batches, **kw):
        if seen["round"] == LM_POP_CHUNK:                  # first round of the second chunk
            z = st.z.bufs[key]
            for g in range(G):
                for k in range(K):
                    row = z[g, k].view(torch.int16).cpu().numpy().view(np.uint16)
                    require(np.array_equal(row, store.data["z"][key][g, co[1][g, k]]),
                            f"(s) slot ({g}, {k}): the installed z is not the store row of "
                            f"client {co[1][g, k]}")
            for g in range(G):
                for c in set(co[0][g].tolist()) - set(co[1][g].tolist()):
                    kept[(g, c)] = store.data["z"][key][g, c].copy()
            seen["checked"] = True
        seen["round"] += 1
        return real(st, batches, **kw)

    engine.round_fn = spy
    try:
        state, hz = api.fit(engine, data, LM_POP_ROUNDS, state=state, population_store=store,
                            chunk=LM_POP_CHUNK, cohorts=co)
        torch.cuda.synchronize()
    finally:
        engine.round_fn = real
    finite_metrics(np, hz)
    require(seen["checked"] and kept, "(s) the second chunk's install was not checked")
    for (g, c), row in kept.items():
        require(np.array_equal(store.data["z"][key][g, c], row),
                f"(s) client ({g}, {c}) sat out the second chunk and lost its store bits")
        require(bool(row.any()), f"(s) client ({g}, {c})'s row is zero after its chunk")
    log(f"(s) the second cohort's installed z equals its store rows bit for bit; clients "
        f"{sorted(kept)} sat out the second chunk and kept their store bits")
    del kept

    # --- the timed run ---
    replay = torch.Generator().manual_seed(0)
    replay.set_state(store.generator.get_state())
    drawn = [draw_cohort(replay, G, P, K).tolist() for _ in range(LM_POP_ROUNDS // LM_POP_CHUNK)]
    log(f"(s) timed run: the store's cohorts {drawn}")
    marks = []
    cls = type(store)
    extract = cls.extract

    def timed_extract(self, *a, **kw):
        res = extract(self, *a, **kw)
        marks.append(time.perf_counter())          # a chunk ends at its extract
        return res

    cls.extract = timed_extract
    before = dict(store.seconds)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        state, hz = api.fit(engine, data, LM_POP_ROUNDS, state=state, population_store=store,
                            chunk=LM_POP_CHUNK)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    finally:
        cls.extract = extract
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = lm_train_launches(cfg, n_update, LM_POP_ROUNDS)
    got = {k: v for k, v in all_launches().items() if k in want}
    require(got == want, f"(s) launched {got}, expected {want}")
    finite_metrics(np, hz)
    for t in tree_leaves(state.params):
        require(finite_and_nonzero(torch, t)[0], "(s) params not finite")
    require(peak_gb <= peak_i_gb + 0.5,
            f"(s) peak {peak_gb:.2f} GB is not within 0.5 GB of (i)'s {peak_i_gb:.2f} GB")
    chunk_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    steps = store_steps(store, before)
    out = {"phase": "s", "population": P, "store_bytes": store.state_bytes(),
           "cohort_buffer_bytes": cohort_bytes,
           "host_bytes": store.state_bytes() + 2 * cohort_bytes,
           "store_make_s": store_s, "pin_s": pin_s, "cohorts_checked": co.tolist(),
           "cohorts_timed": drawn, "chunk_s": chunk_s, "total_s": total_s,
           "round_ms": total_s * 1e3 / LM_POP_ROUNDS, "host_steps_s": steps, "peak_gb": peak_gb,
           "peak_i_gb": peak_i_gb, "launches": got, "host_memory": mem,
           "losses": [float(x) for x in hz.metrics.loss.reshape(-1)]}
    log(f"(s) {LM_POP_ROUNDS} rounds in chunks of {LM_POP_CHUNK}: chunks "
        f"{[round(c, 3) for c in chunk_s]} s ({out['round_ms']:.1f} ms a round); host steps "
        + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
        + f"; device peak {peak_gb:.2f} GB against (i)'s {peak_i_gb:.2f} GB; host "
        f"{out['host_bytes'] / 1e9:.2f} GB (store + two cohort buffers); launches {got}")
    del state, engine, data, store
    torch.cuda.empty_cache()
    return out


# Phase (u): the multilevel backend over fig11's --full tree, periods cut to
# examples/three_level.py's; (u3)'s per-level live-uplink fractions.
ML_LEVELS, ML_PERIODS, ML_PART = (4, 5, 5), (8, 4, 2), (1.0, 0.8, 0.6)
ML_WARM, ML_TIMED, ML_SHARDS = 2, 3, 4
ML_AGREE = 1e-4           # (u2) against (u1), and the card against the CPU: relative


def all_launches() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import mtgc_update as mu
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssm_scan as ss

    return {"mtgc_update_flat": mu.mtgc_update_flat.launches,
            "mtgc_update": mu.mtgc_update.launches,
            "int8_roundtrip": qz.int8_roundtrip.launches, "topk_mask": qz.topk_mask.launches,
            "flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "rwkv6_scan": rw.rwkv6_scan.launches, "rwkv6_scan_bwd": rw.rwkv6_scan_bwd.launches,
            "selective_scan": ss.selective_scan.launches,
            "selective_scan_bwd": ss.selective_scan_bwd.launches,
            "moe_gather": md.moe_gather.launches, "moe_combine": md.moe_combine.launches,
            "moe_gate_grad": md.moe_gate_grad.launches}


def phase_multilevel_hfl(torch, np, api, train, p0, loss_fn) -> dict:
    """Phase (u): the multilevel backend (Appendix E's M-level MTGC) at the
    CIFAR CNN's full width over fig11's ``--full`` tree ``levels=(4, 5,
    5)`` (100 clients, as (a)'s 10 x 10), batch 50, lr 0.01. The periods are
    cut from fig11's (500, 100, 10) to ``examples/three_level.py``'s (8, 4,
    2): at the full periods one round's selected batches alone, ``[500, 4,
    5, 5, 50, 3, 32, 32]`` float32, would take 30.7 GB. The client pools
    follow fig11 (``partition(both_noniid)`` over 4 groups of 25, re-nested
    ``[4][5][5]``) at alpha 0.5, not 0.1: at 0.1 the 16,000 training images
    leave some of the 100 clients under ``partition``'s 8 samples. Every run
    takes the same shard ids.

    (u1) tree layout, full participation, ``build`` -> ``fit``: 2 warm-up
    rounds, then 3 timed; finite losses; all 100 leaves equal; each level's
    nu summing to zero over the children of every aggregator, within the
    rounding of the means carried through the quotient (rounds x children
    x 2^-20 x max|x| / (lr P_m); the deeper nus are re-initialized at the
    round's last aggregation, so exactly zero); one round on the card
    against the same round on the CPU from the same state and shard ids
    (params within rtol and atol 1e-4 of max|x|). (u2) the flat layout,
    same spec and shard ids: after the warm-up (both runs' under
    deterministic cuDNN) its params within 1e-4 of max|x| of (u1)'s; timed
    the same way. A nu is a sum over rounds of
    (s - a) / (lr P_m), s and a each within the params' bound, so nu_m is
    held to 2 x rounds x that bound / (lr P_m).
    (u3) ``level_participation=(1.0, 0.8, 0.6)``, uniform, inverse_prob,
    tree: in each warm-up round (its masks replayed from a copy of the
    state's generator) every leaf outside the active chains keeps its
    params' bits and every node without an active leaf its nu's bits;
    timed. Its losses are reported, not required finite: Horvitz-Thompson
    weighting of whole models rescales a subtree's model by its realized
    over its expected live-child count, and the corrections carry that
    rescale over lr P_m, so the CNN can diverge, in the reference as here.
    A ``torch.profiler`` trace of one round of each. No kernel runs
    on this path: every wrapper's count stays 0."""
    from repro_torch.core.driver import select_round
    from repro_torch.core.multilevel import MultiLevelState
    from repro_torch.core.packer import as_tree
    from repro_torch.core.participation import sample_axis_mask
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import partition
    from repro_torch.kernels import ops

    dims, periods, M = ML_LEVELS, ML_PERIODS, len(ML_LEVELS)
    E = periods[0] // periods[-1]
    rounds = ML_WARM + ML_TIMED
    flat_idx = partition(train.y, dims[0], dims[1] * dims[2], mode="both_noniid", alpha=0.5,
                         seed=0)
    idx = [[[flat_idx[a][b * dims[2] + c] for c in range(dims[2])] for b in range(dims[1])]
           for a in range(dims[0])]
    spec = api.ExperimentSpec(levels=dims, backend="multilevel", lr=LR, state_layout="tree",
                              schedule=api.RoundSchedule(periods=periods))
    engine = api.build(spec, loss_fn)
    t0 = time.perf_counter()
    data = engine.pack_arrays({"x": train.x, "y": train.y}, idx, batch_size=BATCH,
                              shards=ML_SHARDS, rng=np.random.default_rng(1),
                              generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    out = {"levels": list(dims), "periods": list(periods), "pack_s": time.perf_counter() - t0,
           "packed_gb": sum(t.numel() * t.element_size() for t in data.arrays.values()) / 1e9,
           "launches": {}}
    log(f"(u) packed {tuple(data.arrays['x'].shape)} ({out['packed_gb']:.2f} GB) in "
        f"{out['pack_s']:.2f} s")
    sid = torch.randint(0, ML_SHARDS, (rounds + 1, E) + dims,
                        generator=torch.Generator().manual_seed(11))

    def leaf_max(tree) -> float:
        leaves = tree if isinstance(tree, list) else tree_leaves(tree)
        return max(float(t.abs().max()) for t in leaves)

    def run(tag, eng, warm, extra=None, finite=True):
        """Warm-up (``warm(state) -> state``), then ML_TIMED rounds timed; the
        launch counts, peak and a traced round. Returns (state after the
        warm-up, state after the timed rounds)."""
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        st_w = warm(eng.init(p0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, hz = api.fit(eng, data, ML_TIMED, state=st_w, shard_ids=sid[ML_WARM:rounds])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ML_TIMED
        launches = all_launches()
        require(not any(launches.values()), f"({tag}) launched a kernel: {launches}")
        if finite:
            finite_metrics(np, hz)
        require(hz.metrics.loss.shape == (ML_TIMED, periods[0]),
                f"({tag}) loss shape {hz.metrics.loss.shape}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        trace = profile_round(torch, lambda: api.fit(eng, data, 1, state=st))
        log_trace(f"({tag}) profiled round", trace)
        out[tag] = {"round_ms": ms, "peak_gb": peak, "held_gb": held,
                    "busy_share": trace["busy"] / trace["wall_us"] if trace else None,
                    "loss": hz.metrics.loss[-1].tolist(),
                    "finite": bool(np.isfinite(hz.metrics.loss).all()), **(extra or {})}
        out["launches"][tag] = launches
        log(f"({tag}) {ML_TIMED} rounds: {ms:.1f} ms a round; peak {peak:.2f} GB ({held:.2f} GB "
            f"held before); loss {np.round(hz.metrics.loss[-1], 4).tolist()}")
        return st_w, st

    def warm_fit(eng):
        """The warm-up rounds under deterministic cuDNN: (u2)'s are held
        against (u1)'s, and the default algorithms' atomics would add the
        run-to-run spread to the layouts' own rounding."""
        def warm(st):
            torch.backends.cudnn.deterministic = True
            try:
                st = api.fit(eng, data, ML_WARM, state=st, shard_ids=sid[:ML_WARM])[0]
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.deterministic = False
            return st

        return warm

    # --- (u1) tree, full participation --------------------------------------
    st1_w, st1 = run("u1", engine, warm_fit(engine))
    for t in tree_leaves(st1.params):
        require(torch.equal(t, t[0, 0, 0].expand_as(t)), "(u1) the 100 leaves differ")
    x_max = leaf_max(st1.params)
    worst = []
    for m, nu in enumerate(st1.nus):
        bound = rounds * dims[m] * 2.0 ** -20 * x_max / (LR * periods[m])
        err = max(float(t.sum(dim=m).abs().max()) for t in tree_leaves(nu))
        require(err <= bound, f"(u1) nus[{m}] sums to {err} over the children, bound {bound}")
        require(m == 0 or err == 0.0, f"(u1) nus[{m}] is not re-initialized")
        worst.append(err)
    out["u1"]["nu_child_sums"] = worst
    log(f"(u1) all 100 leaves equal; |sum of nu over the children| per level {worst}")
    # One round on the card against the same round on the CPU.
    batches = select_round(data, sid[rounds])
    s_card, m_card = engine.round_fn(st1, batches)
    cpu_eng = api.build(spec, loss_fn, device="cpu")
    st_cpu = MultiLevelState(tree_map(lambda t: t.cpu(), st1.params),
                             tuple(tree_map(lambda t: t.cpu(), nu) for nu in st1.nus),
                             torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    s_cpu, m_cpu = cpu_eng.round_fn(st_cpu, {k: v.cpu() for k, v in batches.items()})
    out["u1"]["cpu_round_s"] = time.perf_counter() - t0
    gx = [t[0, 0, 0].cpu() for t in tree_leaves(s_card.params)]
    cx = [t[0, 0, 0] for t in tree_leaves(s_cpu.params)]
    tol = ML_AGREE * leaf_max(cx)
    err = max(float((g - c).abs().max()) for g, c in zip(gx, cx))
    nu_ok, nu_err = [], []
    for m in range(M):
        for g, c in zip(tree_leaves(s_card.nus[m]), tree_leaves(s_cpu.nus[m])):
            g = g.cpu()
            nu_ok.append(torch.allclose(g, c, rtol=ML_AGREE, atol=2 * tol / (LR * periods[m])))
            nu_err.append(float((g - c).abs().max()))
    out["u1"]["card_vs_cpu"] = {"max_abs_dx": err, "atol": tol, "max_abs_dnu": max(nu_err),
                                "max_abs_nu": leaf_max(s_cpu.nus[0]),
                                "loss_card": m_card.loss.tolist(), "loss_cpu": m_cpu.loss.tolist()}
    log(f"(u1) one round on the card against the CPU ({out['u1']['cpu_round_s']:.1f} s there): "
        f"max |dx| {err:.3e} (atol {tol:.3e}), max |dnu| {max(nu_err):.3e} (max |nu_1| "
        f"{out['u1']['card_vs_cpu']['max_abs_nu']:.3e})")
    require(all(torch.allclose(g, c, rtol=ML_AGREE, atol=tol) for g, c in zip(gx, cx)),
            f"(u1) the card's round differs from the CPU's: max |dx| {err}, atol {tol}")
    require(all(nu_ok), "(u1) a nu differs between the card and the CPU")
    del s_card, s_cpu, st_cpu, cpu_eng, batches, st1

    # --- (u2) flat, same spec and shard ids ---------------------------------
    eng2 = api.build(dataclasses.replace(spec, state_layout="flat"), loss_fn)
    st2_w, st2 = run("u2", eng2, warm_fit(eng2))
    def max_diff(a, b) -> float:
        return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a),
                                                              tree_leaves(as_tree(b))))

    tol = ML_AGREE * leaf_max(st1_w.params)
    dx = max_diff(st1_w.params, st2_w.params)
    dnu = [max_diff(st1_w.nus[m], st2_w.nus[m]) for m in range(M)]
    nu_bound = [2 * ML_WARM * tol / (LR * periods[m]) for m in range(M)]
    out["u2"]["vs_u1"] = {"max_abs_dx": dx, "bound": tol, "max_abs_dnu": dnu,
                          "nu_bound": nu_bound, "max_abs_nu": leaf_max(st1_w.nus[0])}
    log(f"(u2) flat against (u1) tree after {ML_WARM} rounds: max |dx| {dx:.3e} (bound "
        f"{tol:.3e}), max |dnu| per level {dnu} (bounds {nu_bound}; max |nu_1| "
        f"{out['u2']['vs_u1']['max_abs_nu']:.3e})")
    require(dx <= tol, f"(u2) flat and tree params differ by {dx} after the warm-up, bound {tol}")
    require(all(d <= b for d, b in zip(dnu, nu_bound)), "(u2) flat and tree nus differ")
    del st1_w, st2_w, st2, eng2

    # --- (u3) partial participation, inverse_prob, tree -----------------------
    eng3 = api.build(dataclasses.replace(spec, level_participation=ML_PART,
                                         participation_weighting="inverse_prob"), loss_fn)
    frozen = []

    def warm_partial(st):
        for r in range(ML_WARM):
            gen = torch.Generator(device=st.rng.device)
            gen.set_state(st.rng.get_state())
            masks = [sample_axis_mask(gen, dims[:m + 1], ML_PART[m], "uniform") for m in range(M)]
            leaf = masks[0]
            for m in range(1, M):
                leaf = leaf[..., None] * masks[m]
            before = st
            st, _ = api.fit(eng3, data, 1, state=st, shard_ids=sid[r:r + 1])
            off = leaf == 0
            for a, b in zip(tree_leaves(before.params), tree_leaves(st.params)):
                require(same_bits(torch, b[off], a[off]), "(u3) a frozen leaf's params changed")
            for m in range(M):
                off_m = leaf.reshape(dims[:m + 1] + (-1,)).amax(dim=-1) == 0
                for a, b in zip(tree_leaves(before.nus[m]), tree_leaves(st.nus[m])):
                    require(same_bits(torch, b[off_m], a[off_m]),
                            f"(u3) a frozen node's nus[{m}] changed")
            frozen.append(int(off.sum()))
            require(0 < frozen[-1] < leaf.numel(), f"(u3) {frozen[-1]} frozen leaves")
        return st

    run("u3", eng3, warm_partial, {"frozen_leaves": frozen}, finite=False)
    log(f"(u3) frozen leaves a warm-up round {frozen}: their params and nus kept their bits")
    del eng3, engine, data
    torch.cuda.empty_cache()
    return out


# Phase (ls), the low-level surface: (ls4)'s SCAFFOLD reduction at G = 1,
# K = 10, E = 1 over LS_SCAFFOLD_ROUNDS rounds; (ls5)'s 2 x 5 clients at
# batch 16 (lstm on make_language sequences of 80 tokens); (ls6)'s steps.
# LS_AGREE bounds (ls2) against (ls1) (phase 5's fused-against-unfused
# bound), and LS_CNN_AGREE (ls4) and (ls5): ROADMAP queue 3 item 1's CNN
# bound, relative to the largest entry.
LS_SCAFFOLD_ROUNDS, LS_CLIENTS, LS_BATCH, LS_SEQ, LS_OPT_STEPS = 3, (2, 5), 16, 80, 10
LS_AGREE, LS_CNN_AGREE = 1e-5, 1e-4
# (ls5): the card against the CPU in float64, relative to the largest
# entry; resnet_gn's float32 gradients against float64: a few ReLU units
# on the other side of zero, each about 1e-3 (see the phase).
LS_F64_AGREE, LS_RELU_GRAD = 1e-9, 1e-2


def _max_gap(torch, got: dict, want: dict) -> tuple[float, float]:
    """(max |got - want|, max |want|) over the leaves of two trees (a CPU
    copy of ``got`` is taken)."""
    from repro_torch.core.tree import tree_leaves

    gap = scale = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        gap = max(gap, (g.cpu() - w.cpu()).abs().max().item())
        scale = max(scale, w.abs().max().item())
    return gap, scale


def phase_low_level_surface(torch, np, api, spec, data, p0, loss_fn, apply, train, test,
                            idx) -> dict:
    """Phase (ls): the reference's low-level surface on path (a) -- the
    legacy ``make_global_round`` driven by ``make_round_step``, flat (ls1)
    and tree (ls2), ``bench_round.py``'s host loop (ls3), SCAFFOLD against
    MTGC (ls4), ``resnet_gn`` and ``lstm`` (ls5) and the optimizers (ls6)
    on the card against the CPU."""
    import warnings

    from torch.func import grad_and_value, vmap

    from repro_torch import core, optim
    from repro_torch.core.driver import select_round
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import make_language, sample_round_batches
    from repro_torch.kernels import mtgc_update as mu
    from repro_torch.models import small

    t_phase = time.perf_counter()
    out = {"launches": {}, "ms": {}, "readings": {}, "peak_gb": {}}
    packer = core.make_packer(p0)
    n_leaves = len(packer.segments)
    cfg = core.HFLConfig(num_groups=GROUPS, clients_per_group=CLIENTS, local_steps=H,
                         group_rounds=E, lr=LR, algorithm="mtgc", use_fused_update=True)
    tree_cfg = dataclasses.replace(cfg, use_flat_state=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rf, rf_tree = (core.make_global_round(loss_fn, c) for c in (cfg, tree_cfg))
    sids = torch.randint(0, data.num_shards, (ROUNDS, E, GROUPS, CLIENTS),
                         generator=torch.Generator().manual_seed(31))

    # (ls1) flat + fused through make_round_step, against run_rounds on the
    # same shard ids; (ls2) one tree + fused round from (ls1)'s first ids.
    torch.backends.cudnn.deterministic = True
    try:
        engine = api.build(spec, loss_fn)
        want, _, hz = core.run_rounds(engine.round_fn, engine.init(p0), data, ROUNDS,
                                      shard_ids=sids)
        torch.cuda.synchronize()
        del engine
        torch.cuda.reset_peak_memory_stats()
        step = core.make_round_step(rf)
        state = core.hfl_init(p0, cfg)
        launches, ms = [], []
        for t in range(ROUNDS):
            mu.reset_launch_counts()
            t0 = time.perf_counter()
            state, _, m = step(state, data, sids[t])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append([mu.mtgc_update_flat.launches, mu.mtgc_update.launches])
            require(np.array_equal(m.loss.cpu().numpy(), hz.metrics.loss[t]),
                    f"(ls1) round {t + 1}'s losses differ from run_rounds'")
            if t == 0:
                first = state.params.bufs["float32"].clone()
        out["peak_gb"]["ls1"] = torch.cuda.max_memory_allocated() / 1e9
        require(all(c == [E * H, 0] for c in launches),
                f"(ls1) launched [flat, leaf] {launches} a round, expected [{E * H}, 0]")
        for f in ("params", "z", "y", "dyn"):
            require(torch.equal(getattr(state, f).bufs["float32"], getattr(want, f).bufs["float32"]),
                    f"(ls1) make_round_step's {f} differs from run_rounds'")
        require(torch.equal(state.round, want.round), "(ls1) round counters differ")
        out["launches"]["ls1"] = {"mtgc_update_flat": sum(c[0] for c in launches),
                                  "mtgc_update": sum(c[1] for c in launches)}
        out["ms"]["ls1"] = ms
        del want, hz, state
        mu.reset_launch_counts()
        t0 = time.perf_counter()
        tstate, _, _ = core.make_round_step(rf_tree)(core.hfl_init(p0, tree_cfg), data, sids[0])
        torch.cuda.synchronize()
        out["ms"]["ls2"] = (time.perf_counter() - t0) * 1e3
        out["launches"]["ls2"] = {"mtgc_update_flat": mu.mtgc_update_flat.launches,
                                  "mtgc_update": mu.mtgc_update.launches}
        require(out["launches"]["ls2"] == {"mtgc_update_flat": 0,
                                           "mtgc_update": E * H * n_leaves},
                f"(ls2) launched {out['launches']['ls2']}, expected mtgc_update "
                f"{E * H * n_leaves}")
        gap = (packer.flatten(tstate.params).bufs["float32"] - first).abs().max().item()
        scale = first.abs().max().item()
        out["readings"]["ls2_tree_vs_flat"] = {"max_abs": gap, "max_x": scale}
        require(gap <= LS_AGREE * scale,
                f"(ls2) tree and flat rounds differ by {gap} (max |x| {scale})")
        del tstate, first
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"(ls1) make_global_round + make_round_step, flat + fused, {ROUNDS} rounds: bit for "
        f"bit run_rounds' state and losses; mtgc_update_flat {launches} [flat, leaf] a round; "
        f"{[round(x, 1) for x in ms]} ms; peak {out['peak_gb']['ls1']:.2f} GB. (ls2) tree + "
        f"fused, one round: {out['ms']['ls2']:.1f} ms, mtgc_update "
        f"{out['launches']['ls2']['mtgc_update']}, max |dx| {gap} against (ls1)'s (max |x| "
        f"{scale})")

    # (ls3) bench_round.py's host loop: batches sampled on the host, moved
    # to the card, one round, a streaming eval.
    state = core.hfl_init(p0, cfg)
    torch.cuda.synchronize()
    mu.reset_launch_counts()
    t0 = time.perf_counter()
    b = sample_round_batches(train.x, train.y, idx, np.random.default_rng(41), E, H, BATCH)
    t1 = time.perf_counter()
    bt = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, m = rf(state, bt)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    acc = small.accuracy(apply, core.global_model(state), test.x, test.y)
    t4 = time.perf_counter()
    require(bool(torch.isfinite(m.loss).all()) and 0.0 <= acc <= 1.0,
            f"(ls3) losses not finite or accuracy {acc}")
    out["launches"]["ls3"] = {"mtgc_update_flat": mu.mtgc_update_flat.launches,
                              "mtgc_update": mu.mtgc_update.launches}
    require(out["launches"]["ls3"] == {"mtgc_update_flat": E * H, "mtgc_update": 0},
            f"(ls3) launched {out['launches']['ls3']}")
    host = {"sample_ms": (t1 - t0) * 1e3, "upload_ms": (t2 - t1) * 1e3,
            "round_ms": (t3 - t2) * 1e3, "eval_ms": (t4 - t3) * 1e3,
            "batch_bytes": int(sum(v.nbytes for v in b.values()))}
    host["host_share"] = (host["sample_ms"] + host["upload_ms"]) / ((t3 - t0) * 1e3)
    out["ms"]["ls3"] = host
    out["readings"]["ls3_accuracy"] = acc
    log(f"(ls3) host loop: sample {host['sample_ms']:.1f} ms, upload {host['upload_ms']:.1f} ms "
        f"({host['batch_bytes'] / 1e6:.1f} MB), round {host['round_ms']:.1f} ms, eval "
        f"{host['eval_ms']:.1f} ms; host share of sample + upload + round "
        f"{host['host_share']:.3f}; accuracy {acc}")
    del state, b, bt

    # (ls4) MTGC at G = 1, E = 1, gradient init (flat + fused) against
    # SCAFFOLD option I on the same batches, deterministic cuDNN. Neither
    # carries anything but the model across rounds, so each round is held
    # from a common start: SCAFFOLD from MTGC's pre-round model. The two
    # round their corrections in another order; from p0 the CNN's early
    # loss spike (ROADMAP queue 3 item 3) grows such one-ulp differences a
    # thousandfold in a round. So each round also measures that growth:
    # SCAFFOLD from the start model moved by one ulp. A round is held within
    # LS_CNN_AGREE of max|x|, or within that growth where it is larger. The
    # chained runs from p0 are logged.
    k1 = dataclasses.replace(cfg, num_groups=1, group_rounds=1, correction_init="gradient")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rf1 = core.make_global_round(loss_fn, k1)
    s1, sc = core.hfl_init(p0, k1), core.scaffold_init(p0, CLIENTS)
    sc_round = core.make_scaffold_round(loss_fn, CLIENTS, H, LR, option="I")
    gen = torch.Generator().manual_seed(43)
    per_round, chained, growth = [], [], []
    mu.reset_launch_counts()
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        for _ in range(LS_SCAFFOLD_ROUNDS):
            sb = select_round(data, torch.randint(0, data.num_shards, (E, GROUPS, CLIENTS),
                                                  generator=gen))
            bs = {k: v[0, :, 0].contiguous() for k, v in sb.items()}
            start = core.scaffold_init(core.global_model(s1), CLIENTS)
            s1, _ = rf1(s1, {k: v[:1, :, :1].contiguous() for k, v in sb.items()})
            sc, _ = sc_round(sc, bs)
            synced, _ = sc_round(start, bs)
            moved, _ = sc_round(start._replace(params=tree_map(
                lambda x: torch.nextafter(x, torch.full_like(x, math.inf)), start.params)), bs)
            x_m, x_s = core.global_model(s1), tree_map(lambda x: x[0], synced.params)
            per_round.append(_max_gap(torch, x_m, x_s))
            growth.append(_max_gap(torch, tree_map(lambda x: x[0], moved.params), x_s))
            chained.append(_max_gap(torch, x_m, tree_map(lambda x: x[0], sc.params)))
        torch.cuda.synchronize()
        out["ms"]["ls4"] = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cudnn.deterministic = False
    out["launches"]["ls4"] = {"mtgc_update_flat": mu.mtgc_update_flat.launches,
                              "mtgc_update": mu.mtgc_update.launches}
    require(out["launches"]["ls4"]["mtgc_update_flat"] == LS_SCAFFOLD_ROUNDS * H,
            f"(ls4) mtgc_update_flat launched {out['launches']['ls4']}")
    rel = [g / x for g, x in per_round]
    ulp = [g / x for g, x in growth]
    out["readings"]["ls4_mtgc_vs_scaffold"] = {
        "per_round": [{"max_abs": g, "max_x": x} for g, x in per_round],
        "one_ulp_growth": [{"max_abs": g, "max_x": x} for g, x in growth],
        "chained": [{"max_abs": g, "max_x": x} for g, x in chained]}
    log(f"(ls4) MTGC (G=1, E=1, gradient init, flat + fused) against SCAFFOLD I, "
        f"{LS_SCAFFOLD_ROUNDS} rounds of {CLIENTS} clients x {H} steps: each round from a "
        f"common start max |dx| / max |x| {[f'{r:.3e}' for r in rel]}; SCAFFOLD from a start "
        f"one ulp away {[f'{r:.3e}' for r in ulp]}; chained from p0 "
        f"{[f'{g / x:.3e}' for g, x in chained]}; {out['ms']['ls4']:.1f} ms")
    require(all(r <= max(LS_CNN_AGREE, u) for r, u in zip(rel, ulp)),
            "(ls4) a round of MTGC is not a round of SCAFFOLD")
    del s1, sc, start, synced, moved

    # (ls5) resnet_gn and lstm: per-client losses and gradients under vmap
    # on the card, in float64 against the CPU's float64 (the same code path;
    # no rounding reaches the limit), and in float32 against that float64.
    # A ReLU net's float32 gradient is not within the CNN's 1e-4 of float64:
    # a ReLU input within float32's rounding of zero lands on the other side
    # of it (in one draw of these shapes on the CPU, 3 of 10 clients had one
    # such input among their 2.1 M), and that unit moves a stage-2 weight's
    # gradient by
    # about 1 / (16 x 8 x 8) of its sum: up to 7.8e-4 of the largest entry
    # (the reference's float32, which rounds otherwise, had none on those
    # clients). So resnet_gn's float32 is held within LS_RELU_GRAD, lstm's
    # (no kink) within LS_CNN_AGREE.
    G5, K5 = LS_CLIENTS
    rng = np.random.default_rng(45)
    lang, _ = make_language(rng, num_styles=10, vocab=64, samples_per_style=G5 * K5 * LS_BATCH
                            // 10, seq_len=LS_SEQ)
    cases = {
        "resnet_gn": (small.resnet_gn(100, IMAGE), {
            "x": rng.normal(size=(G5, K5, LS_BATCH) + IMAGE).astype(np.float32),
            "y": rng.integers(0, 100, size=(G5, K5, LS_BATCH)).astype(np.int32)}),
        "lstm": (small.lstm(64), {"x": lang.x.reshape(G5, K5, LS_BATCH, LS_SEQ),
                                  "y": lang.y.reshape(G5, K5, LS_BATCH, LS_SEQ)}),
    }
    f32, f64 = torch.float32, torch.float64
    for name, ((init, mapply), batch) in cases.items():
        params = init(torch.Generator().manual_seed(47), device="cpu")
        stacked = tree_map(lambda x: x.expand((G5, K5) + tuple(x.shape)).contiguous(), params)
        fn = vmap(vmap(grad_and_value(small.make_loss(mapply))))
        res, times = {}, {}
        for dev, dtype in (("cuda", f32), ("cpu", f32), ("cuda", f64), ("cpu", f64)):
            p = tree_map(lambda x: x.to(dev, dtype), stacked)
            bt = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            if bt["x"].is_floating_point():
                bt["x"] = bt["x"].to(dtype)
            t0 = time.perf_counter()
            grads, losses = fn(p, bt)
            if dev == "cuda":
                torch.cuda.synchronize()
            tag = f"{dev}_{'f32' if dtype == f32 else 'f64'}"
            times[tag] = (time.perf_counter() - t0) * 1e3
            res[tag] = (tree_map(lambda x: x.double().cpu(), grads), losses.double().cpu())
        oracle_g, oracle_l = res["cpu_f64"]
        gmax = max(g.abs().max().item() for g in tree_leaves(oracle_g))
        lmax = oracle_l.abs().max().item()

        def rel(a, b):
            return {"grad": _max_gap(torch, res[a][0], res[b][0])[0] / gmax,
                    "loss": (res[a][1] - res[b][1]).abs().max().item() / lmax}

        reading = {"cuda_f64_vs_cpu_f64": rel("cuda_f64", "cpu_f64"),
                   "cuda_f32_vs_cpu_f64": rel("cuda_f32", "cpu_f64"),
                   "cpu_f32_vs_cpu_f64": rel("cpu_f32", "cpu_f64"),
                   "cuda_f32_vs_cpu_f32": rel("cuda_f32", "cpu_f32")}
        finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(res["cuda_f32"][0]))
        out["readings"][f"ls5_{name}"] = dict(reading, grad_max=gmax, loss_max=lmax)
        out["ms"][f"ls5_{name}"] = times
        log(f"(ls5) {name}: per-client losses and gradients, {G5} x {K5} clients x {LS_BATCH}, "
            f"relative to float64's largest entry: {reading}; "
            f"{ {k: round(v, 1) for k, v in times.items()} } ms")
        limit = LS_RELU_GRAD if name == "resnet_gn" else LS_CNN_AGREE
        f64_gap, f32_gap = reading["cuda_f64_vs_cpu_f64"], reading["cuda_f32_vs_cpu_f64"]
        require(finite and f64_gap["grad"] <= LS_F64_AGREE and f64_gap["loss"] <= LS_F64_AGREE,
                f"(ls5) {name} in float64 differs between card and CPU: {f64_gap}")
        require(f32_gap["grad"] <= limit and f32_gap["loss"] <= LS_CNN_AGREE,
                f"(ls5) {name}'s float32 on the card misses float64 beyond {limit}: {f32_gap}")
    del cases, res

    # (ls6) ten sgd (momentum) and adamw (warmup + cosine) steps over the
    # CNN's tree from random gradients, card against CPU.
    gen = torch.Generator().manual_seed(49)
    grads = [tree_map(lambda x: torch.randn(x.shape, generator=gen), p0)
             for _ in range(LS_OPT_STEPS)]
    for name, opt in (("sgd", optim.sgd(LR, momentum=0.9)),
                      ("adamw", optim.adamw(optim.linear_warmup_cosine(1e-3, 3, LS_OPT_STEPS),
                                            weight_decay=0.01))):
        finals = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda x: x.to(dev), p0)
            st = opt.init(p)
            for i, g in enumerate(grads):
                p, st = opt.update(tree_map(lambda x: x.to(dev), g), st, p, i)
            finals[dev] = tree_map(lambda x: x.cpu(), p)
        worst_leaf = worst_entry = 0.0
        for gp, cp in zip(tree_leaves(finals["cuda"]), tree_leaves(finals["cpu"])):
            d = (gp - cp).abs().numpy()
            c = cp.abs().numpy()
            worst_leaf = max(worst_leaf, float(d.max() / np.spacing(np.float32(c.max()))))
            worst_entry = max(worst_entry, float((d / np.spacing(c)).max()))
        out["readings"][f"ls6_{name}"] = {"ulps_of_entry": worst_entry,
                                          "ulps_of_leaf_max": worst_leaf}
        log(f"(ls6) {name}, {LS_OPT_STEPS} steps over the CNN's tree, card against CPU: "
            f"{worst_entry} ulps of an entry's magnitude at most, {worst_leaf} of its leaf's "
            f"largest entry")
        # sgd: one ulp of each entry (mul and sub round alike on both); adamw:
        # the CPU's float32 sqrt is not correctly rounded (ROADMAP queue 3),
        # so one ulp of each leaf's largest entry a step.
        require(worst_entry <= 1.0 if name == "sgd" else worst_leaf <= LS_OPT_STEPS,
                f"(ls6) {name} differs between card and CPU")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(ls) the low-level surface: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# (mesh) the sharded round on a torch.distributed mesh, on the one card, and
# (mx) mixtral-8x22b at full width.

MESH_NAMES = ("group", "client", "fsdp", "model")
# (mesh1) and (mesh2): two ranks each, spawned by the script, on cuda:0 over
# a gloo group (NCCL refuses two ranks on one device); (mesh3): one rank
# over NCCL, in the script's own process.
MESH_RUNS = (("mesh1", (2, 1), "gloo"), ("mesh2", (1, 2), "gloo"), ("mesh3", (1, 1), "nccl"))
MESH_RTOL = 1e-5
# The whole-state comparison's reduced glm4: float32, T = 256 a microbatch.
MESH_REDUCED_SEQ = 256
MESH_RANK_TIMEOUT_S = 420
# (mx): mixtral-8x22b at its published widths, 2 of its 56 layers: served
# at 4 prompts of 8192 tokens (past its 4096 window) and 32 generated, its
# loss and backward at 1 x 8192 against the plain attention and one-hot moe.
MX_ARCH, MX_LAYERS, MX_PROMPT, MX_SEQ = "mixtral-8x22b", 2, 8192, 8192
# A moe layer routes its tokens in chunks of 16384 when serving and 4096 in
# training (``models/transformer.py``'s ``chunk_tokens``), one dispatch and
# one combine a chunk: 2 chunks a layer at 4 x 8192 and at 1 x 8192.
MX_SERVE_CHUNKS = LM_BATCH * MX_PROMPT // 16384
MX_TRAIN_CHUNKS = MX_SEQ // 4096
# The limits of (mx)'s kernels-against-plain gaps (loss, gradients), as
# (z3)'s for internvl2.
MX_LOSS_GAP, MX_GRAD_GAP = VLM_LOSS_GAP, VLM_GRAD_GAP


class CollectiveClock:
    """Times each ``torch.distributed.all_reduce`` of this process, the
    device synchronized before and after (what a rank waits on the
    collective, its host copies on gloo included), with its calls and
    bytes."""

    def __init__(self, torch):
        import torch.distributed as dist

        self.torch, self.dist = torch, dist
        self.seconds, self.calls, self.bytes = 0.0, 0, 0

    def __enter__(self):
        self.orig = self.dist.all_reduce

        def timed(t, *args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(t, *args, **kw)
            self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
            return out

        self.dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig


def row_fingerprints(torch, state, g0: int = 0, k0: int = 0) -> dict:
    """Each [g, k] row of params and z and each [g] row of y (by their
    whole-topology indices: this block starts at (g0, k0)): the float64 sum
    and sum of squares of its entries, and the sum and sum of squares of
    their 16-bit patterns (int64), read in 2^26-element pieces."""
    import itertools

    from repro_torch.core.tree import tree_leaves

    out = {}
    for field, lead in (("params", 2), ("z", 2), ("y", 1)):
        for li, t in enumerate(tree_leaves(getattr(state, field))):
            rows = t.reshape(tuple(t.shape[:lead]) + (-1,))
            for idx in itertools.product(*(range(s) for s in rows.shape[:lead])):
                row = rows[idx]
                s = sq = 0.0
                b1 = b2 = 0
                for st in range(0, row.numel(), 1 << 26):
                    p = row[st:st + (1 << 26)]
                    d = p.double()
                    s += float(d.sum())
                    sq += float((d * d).sum())
                    del d
                    bits = p.view(torch.int16).to(torch.int64)
                    b1 += int(bits.sum())
                    b2 += int((bits * bits).sum())
                    del bits
                key = f"{field}/{li}/" + ",".join(str(i + o) for i, o in zip(idx, (g0, k0)))
                out[key] = {"sum": s, "sumsq": sq, "bits": [b1, b2],
                            "n": row.numel()}
    return out


def mesh_train_round(torch, np, mesh) -> dict:
    """Path (i)'s first round (glm4-9b at full width, 2 of 40 layers, flat +
    fused, 2 x 2 clients, E = H = A = 2, 1 x 2048 tokens a microbatch) from
    a fresh state on ``mesh``: the same spec, params, packed tokens and
    shard draws as ``phase_lm_train``'s warm-up round, through
    ``api.build(..., mesh=)`` and ``fit``. Returns this rank's row
    fingerprints, round ms, collective time, peak and launches."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    from repro_torch.sharding.state import MeshAxes

    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH), num_layers=LM_TRAIN_LAYERS)
    bundle = build_model(cfg)
    G, K = LM_TRAIN_LEVELS
    spec = api.ExperimentSpec(
        levels=(G, K), backend="sharded", algorithm="mtgc", lr=LM_TRAIN_LR, fusion="fused",
        state_layout="flat", schedule=api.RoundSchedule(
            group_rounds=LM_TRAIN_E, local_steps=LM_TRAIN_H, microbatches=LM_TRAIN_A))
    engine = api.build(spec, bundle.loss, mesh=mesh)
    rng = np.random.default_rng(0)
    toks, _ = make_lm_tokens(rng, cfg.vocab_size, LM_TRAIN_TOKENS)
    data = engine.pack_tokens(toks, batch_size=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                              shards=2, rng=rng, generator=torch.Generator().manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    params = bundle.init(0)
    state = engine.init(params)
    del params
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with CollectiveClock(torch) as clock:
        t0 = time.perf_counter()
        state, hz = api.fit(engine, data, 1, state=state)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
    launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite_metrics(np, hz)
    ax = MeshAxes(mesh)
    gs, ks = ax.block(G, K)
    rows = row_fingerprints(torch, state, gs.start, ks.start)
    out = {"round_ms": round_ms, "collective_ms": clock.seconds * 1e3,
           "collective_calls": clock.calls, "collective_bytes": clock.bytes,
           "peak_gb": peak_gb, "held_gb": held_gb, "launches": launches,
           "block": [gs.start, gs.stop, ks.start, ks.stop], "rows": rows,
           "losses": [float(x) for x in np.asarray(hz.metrics.loss).reshape(-1)]}
    del state, engine, data, hz
    torch.cuda.empty_cache()
    return out


def mesh_reduced_round(torch, np, mesh) -> dict:
    """One round of the reduced glm4-9b (float32, flat + fused, 2 x 2
    clients, E = H = A = 2, 1 x MESH_REDUCED_SEQ tokens a microbatch,
    random tokens from a numpy seed) on the card, on ``mesh`` or on one
    device (None): this rank's block of the flat params, z and y (numpy)
    and where the block lies."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.sharding.state import MeshAxes

    cfg = get_arch(LM_TRAIN_ARCH).reduced()
    bundle = build_model(cfg)
    G, K = LM_TRAIN_LEVELS
    spec = api.ExperimentSpec(
        levels=(G, K), backend="sharded", algorithm="mtgc", lr=LM_TRAIN_LR, fusion="fused",
        state_layout="flat", schedule=api.RoundSchedule(
            group_rounds=LM_TRAIN_E, local_steps=LM_TRAIN_H, microbatches=LM_TRAIN_A))
    engine = api.build(spec, bundle.loss, mesh=mesh)
    rs = np.random.default_rng(31)
    shape = (LM_TRAIN_E, LM_TRAIN_H, LM_TRAIN_A, G, K, 1, MESH_REDUCED_SEQ)
    batches = {k: torch.from_numpy(rs.integers(0, cfg.vocab_size, shape).astype(np.int32)).cuda()
               for k in ("tokens", "targets")}
    state, _ = engine.round_fn(engine.init(bundle.init(0)), batches)
    gs, ks = (slice(0, G), slice(0, K)) if mesh is None else MeshAxes(mesh).block(G, K)
    out = {"block": [gs.start, gs.stop, ks.start, ks.stop]}
    for f in ("params", "z", "y"):
        out[f] = {k: b.cpu().numpy() for k, b in getattr(state, f).bufs.items()}
    return out


def mesh_rank_main(argv) -> int:
    """One rank of (mesh1)/(mesh2): ``chip_smoke.py --mesh-rank R --world W
    --mesh G,C --out DIR`` on cuda:0, over a gloo group whose store is a
    file in DIR; writes DIR/rank<R>.pt."""
    import argparse
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import smoke_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    out = Path(args.out)
    g, c = (int(v) for v in args.mesh.split(","))
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), args.world),
                            rank=args.mesh_rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S))
    try:
        mesh = smoke_mesh((g, c, 1, 1), MESH_NAMES)
        backend = dist.get_backend(mesh.get_group("group"))
        full = mesh_train_round(torch, np, mesh)
        reduced = mesh_reduced_round(torch, np, mesh)
        torch.save({"full": full, "reduced": reduced, "backend": backend,
                    "coordinate": list(mesh.get_coordinate())}, out / f"rank{args.mesh_rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _rows_agree(got: dict, want: dict, H: int, E: int, lr: float) -> tuple[int, float]:
    """(rows with the same bits, the worst gap over its limit) of a rank's
    rows against the single-card round's: each float64 sum and sum of
    squares within MESH_RTOL of the single card's plus, for z and y, the
    atol 1e-6 / (H lr) (y: / (H E lr)) a row entry."""
    same, worst = 0, 0.0
    for key, g in got.items():
        w = want[key]
        same += int(g["bits"] == w["bits"])
        field = key.split("/")[0]
        atol = {"params": 0.0, "z": 1e-6 / (H * lr), "y": 1e-6 / (H * E * lr)}[field]
        for stat, a in (("sum", atol * g["n"]), ("sumsq", atol * atol * g["n"])):
            lim = MESH_RTOL * abs(w[stat]) + a
            gap = abs(g[stat] - w[stat])
            worst = max(worst, gap / lim if lim > 0 else (0.0 if gap == 0 else math.inf))
    return same, worst


def phase_mesh(torch, np, lm_flat: dict) -> dict:
    """(mesh): path (i)'s round on three meshes of the one card, each held
    against (i)'s warm-up round (the same start and batches) by its rows'
    fingerprints, and the reduced glm4's round entry by entry against the
    same round on one device. (mesh1) (group 2, client 1) and (mesh2)
    (group 1, client 2) spawn two ranks each (gloo); (mesh3) runs one rank
    over NCCL in this process and must give the single card's bits."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import smoke_mesh

    H, E, lr = LM_TRAIN_H, LM_TRAIN_E, LM_TRAIN_LR
    ref_rows = lm_flat["rows"]
    ref_red = mesh_reduced_round(torch, np, None)
    torch.cuda.empty_cache()
    out = {}
    for tag, (g, c), backend in MESH_RUNS:
        tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"))
        try:
            t0 = time.perf_counter()
            if backend == "gloo":
                world = g * c
                procs = [subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(r),
                     "--world", str(world), "--mesh", f"{g},{c}", "--out", str(tmp)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                    for r in range(world)]
                logs = []
                try:
                    for p in procs:
                        logs.append(p.communicate(timeout=MESH_RANK_TIMEOUT_S)[0])
                finally:
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                            p.wait()
                for r, (p, text) in enumerate(zip(procs, logs)):
                    require(p.returncode == 0, f"({tag}) rank {r} exited {p.returncode}: "
                            f"{text[-3000:]}")
                ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                         for r in range(world)]
            else:
                dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "store"), 1),
                                        rank=0, world_size=1,
                                        timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT_S))
                try:
                    mesh = smoke_mesh((g, c, 1, 1), MESH_NAMES)
                    ranks = [{"full": mesh_train_round(torch, np, mesh),
                              "reduced": mesh_reduced_round(torch, np, mesh),
                              "backend": dist.get_backend(mesh.get_group("group")),
                              "coordinate": list(mesh.get_coordinate())}]
                finally:
                    dist.destroy_process_group()
            wall_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        require(all(r["backend"] == backend for r in ranks),
                f"({tag}) the mesh's groups run {[r['backend'] for r in ranks]}, not {backend}")
        # Full width: each rank's rows against (i)'s warm-up round.
        same = total = 0
        worst = 0.0
        for r in ranks:
            s, w = _rows_agree(r["full"]["rows"], ref_rows, H, E, lr)
            same, total, worst = same + s, total + len(r["full"]["rows"]), max(worst, w)
        require(worst <= 1.0, f"({tag}) a row's sum or sum of squares is {worst:.3g} of its "
                f"limit away from (i)'s")
        if tag == "mesh3":
            require(same == total, f"({tag}) {total - same} of {total} rows differ in their bits "
                    "from (i)'s warm-up round")
        # Reduced: the ranks' blocks, entry by entry, against one device.
        red_gap = 0.0
        red_same = True
        for r in ranks:
            g0, g1, k0, k1 = r["reduced"]["block"]
            for f in ("params", "z", "y"):
                for key, got in r["reduced"][f].items():
                    want = ref_red[f][key][g0:g1] if f == "y" else ref_red[f][key][g0:g1, k0:k1]
                    red_same &= bool(np.array_equal(got, want))
                    atol = {"params": 1e-6, "z": 1e-6 / (H * lr), "y": 1e-6 / (H * E * lr)}[f]
                    gap = np.abs(got.astype(np.float64) - want) - MESH_RTOL * np.abs(want)
                    red_gap = max(red_gap, float(gap.max() / atol))
        require(red_gap <= 1.0, f"({tag}) the reduced round's state departs from one device's "
                f"by {red_gap:.3g} of its tolerance")
        if tag == "mesh3":
            require(red_same, f"({tag}) the reduced round's state is not one device's, bit for bit")
        G, K = LM_TRAIN_LEVELS
        passes = LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * (G // g) * (K // c) * LM_TRAIN_LAYERS
        want = {"flash_attention": 2 * passes, "flash_attention_bwd": 3 * passes,
                "mtgc_update_flat": LM_TRAIN_E * LM_TRAIN_H}
        for i, r in enumerate(ranks):
            got = {k: r["full"]["launches"][k] for k in want}
            require(got == want, f"({tag}) rank {i} launched {got}, expected {want}")
        res = {"mesh": {"group": g, "client": c, "fsdp": 1, "model": 1}, "backend": backend,
               "wall_s": wall_s, "rows_same_bits": same, "rows": total,
               "rows_worst_over_limit": worst, "reduced_same_bits": red_same,
               "reduced_worst_over_limit": red_gap,
               "ranks": [{k: r["full"][k] for k in (
                   "round_ms", "collective_ms", "collective_calls", "collective_bytes",
                   "peak_gb", "held_gb", "launches", "block", "losses")}
                   for r in ranks]}
        out[tag] = res
        per_rank = "; ".join(
            f"rank {i} block {r['block']}: round {r['round_ms']:.1f} ms, collectives "
            f"{r['collective_ms']:.1f} ms ({r['collective_calls']} all-reduces, "
            f"{r['collective_bytes'] / 1e9:.2f} GB), peak {r['peak_gb']:.2f} GB "
            f"({r['held_gb']:.2f} held), mtgc_update_flat {r['launches']['mtgc_update_flat']}, "
            f"flash forward {r['launches']['flash_attention']}, backward "
            f"{r['launches']['flash_attention_bwd']}" for i, r in enumerate(res["ranks"]))
        log(f"({tag}) path (i)'s round on a (group {g}, client {c}, 1, 1) mesh over {backend} "
            f"({len(ranks)} rank(s) on cuda:0, {wall_s:.1f} s with start-up): {per_rank}; "
            f"against (i)'s warm-up round ({lm_flat['warmup_round_ms']:.1f} ms): {same} of "
            f"{total} rows with the same bits, worst sum gap {worst:.3g} of its limit; reduced "
            f"glm4 entry by entry: same bits {red_same}, worst {red_gap:.3g} of the tolerance")
    return out


def phase_mixtral(torch, np, fa, md, counter) -> dict:
    """(mx): mixtral-8x22b at full width with MX_LAYERS of its 56 layers:
    served through ``generate`` (4 prompts of MX_PROMPT tokens, 32
    generated: the window of 4096 binds in the prefill), then its loss and
    backward at 1 x MX_SEQ tokens with the kernels, and again with the
    attention kernels' and the moe kernels' plain versions swapped in (the
    flash reference, the one-hot einsums)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import build_model

    full = get_arch(MX_ARCH)
    serve = phase_serve(torch, np, MX_ARCH, counter, MX_PROMPT, layers=MX_LAYERS)
    want = {k: 0 for k in serve["launches"]}
    moe = MX_LAYERS * MX_SERVE_CHUNKS
    want.update(flash_attention=MX_LAYERS, moe_gather=moe, moe_combine=moe)
    # Each of the LM_GEN - 1 decode steps: one dispatch and combine a layer.
    dec = MX_LAYERS * (LM_GEN - 1)
    total = dict(want, moe_gather=moe + dec, moe_combine=moe + dec)
    require(serve["prefill_launches"] == want and serve["launches"] == total,
            f"(mx) launched {serve['prefill_launches']} in the prefill and {serve['launches']} "
            f"in all; expected {want} and {total}")
    cfg = dataclasses.replace(full, num_layers=MX_LAYERS)
    require(cfg.remat and cfg.param_dtype == "bfloat16", f"{MX_ARCH} trains in bf16 with remat")
    bundle = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    params = bundle.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    rs = np.random.default_rng(27)
    batch = {k: torch.from_numpy(rs.integers(0, cfg.vocab_size, (1, MX_SEQ))
                                 .astype(np.int32)).cuda() for k in ("tokens", "targets")}
    p = tree_map(lambda t: t.requires_grad_(), params)
    # The routing of each call of the kernels' run, replayed in the plain
    # run: a token's top-2 experts are a discrete choice, and the plain
    # attention's rounding flips it for a share of the tokens (each flip
    # moves that token's output by a whole expert's), so the two runs are
    # held on one routing; the share the plain run would have flipped is
    # reported.
    route, routes, flips = moe_mod.route, [], []

    def recording(*args, **kw):
        out = route(*args, **kw)
        routes.append(out[2])
        return out

    def pinned(p_, xf, **kw):
        probs, _, own = route(p_, xf, **kw)
        r = routes[len(flips)]
        flips.append(float((own.gate_idx != r.gate_idx).any(1).float().mean()))
        gate = probs.gather(1, r.gate_idx)
        return probs, gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), r

    ms = []
    for i in range(2):                                  # the first call warms up
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        moe_mod.route = recording if i == 1 else route
        try:
            t0 = time.perf_counter()
            loss = bundle.loss(p, batch)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            moe_mod.route = route
        launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Under remat a layer runs its forward twice and its backward once; its
    # moe block routes MX_TRAIN_CHUNKS chunks in each.
    passes, chunks = MX_LAYERS, MX_LAYERS * MX_TRAIN_CHUNKS
    want = {"flash_attention": 2 * passes, "flash_attention_bwd": 3 * passes,
            "moe_gather": 3 * chunks, "moe_combine": 3 * chunks, "moe_gate_grad": chunks}
    require({k: launches[k] for k in want} == want,
            f"(mx) the loss and backward launched {launches}, expected {want}")
    for (path, _), g in zip(_leaf_paths(params), grads):
        f, nz = finite_and_nonzero(torch, g)
        require(f and nz, f"(mx) gradient {path} is not finite or is zero")
    kernel_loss = float(loss.detach())
    ops.reset_launch_counts()
    saved = (fa.flash_attention, fa.flash_attention_bwd, md.moe_gather, md.moe_combine,
             md.moe_gate_grad)
    (fa.flash_attention, fa.flash_attention_bwd, md.moe_gather, md.moe_combine,
     md.moe_gate_grad) = (fa.flash_attention_ref, fa.flash_attention_bwd_ref,
                          md.moe_gather_ref, md.moe_combine_ref, md.moe_gate_grad_ref)
    moe_mod.route = pinned
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = bundle.loss(p, batch)
        plain = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        (fa.flash_attention, fa.flash_attention_bwd, md.moe_gather, md.moe_combine,
         md.moe_gate_grad) = saved
        moe_mod.route = route
    require(sum(all_launches().values()) == 0, f"(mx) the plain run launched {all_launches()}")
    require(len(flips) == len(routes), f"(mx) the plain run routed {len(flips)} times, the "
            f"kernels' {len(routes)}")
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain_loss = float(loss.detach())
    loss_gap = abs(kernel_loss - plain_loss) / abs(plain_loss)
    grad_gap = {path: float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for (path, _), g, w in zip(_leaf_paths(params), grads, plain)}
    worst_path = max(grad_gap, key=grad_gap.get)
    log(f"(mx) {MX_ARCH} kernels against their plain versions in the same bf16 model, on the "
        f"kernels' routing (the plain attention would have changed the top-2 choice of "
        f"{min(flips):.4f}-{max(flips):.4f} of the tokens of its {len(flips)} routing calls): "
        f"loss {kernel_loss:.6f} / {plain_loss:.6f} (relative gap {loss_gap:.3g}); each gradient's "
        f"max gap over its max entry: worst {grad_gap[worst_path]:.3g} ({worst_path}), "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in grad_gap.items()})}")
    require(loss_gap <= MX_LOSS_GAP, f"(mx) loss {kernel_loss} with the kernels, {plain_loss} "
            f"with their plain versions")
    require(grad_gap[worst_path] <= MX_GRAD_GAP, f"(mx) gradient {worst_path} with the kernels "
            f"is {grad_gap[worst_path]} of its max from the plain versions'")
    del grads, plain, p, loss, params
    torch.cuda.empty_cache()
    out = {"arch": MX_ARCH, "layers": MX_LAYERS, "params": n_params, "serve": serve,
           "tokens": MX_SEQ, "loss": kernel_loss, "plain_loss": plain_loss,
           "loss_gap": loss_gap, "grad_gap": grad_gap, "ms": ms[-1], "warmup_ms": ms[0],
           "plain_route_flips": flips,
           "plain_ms": plain_ms, "peak_gb": peak_gb, "plain_peak_gb": plain_peak_gb,
           "held_gb": held_gb, "launches": launches}
    log(f"(mx) {MX_ARCH} at full width, {MX_LAYERS} of {full.num_layers} layers "
        f"({n_params / 1e9:.3f} B params, bf16, remat): serve 4 x {MX_PROMPT} prompt tokens, "
        f"prefill {serve['prefill_ms']:.1f} ms, decode {serve['decode_ms_per_step']:.2f} ms a "
        f"step, peak {serve['peak_gb']:.2f} GB; loss and backward at 1 x {MX_SEQ} "
        f"{ms[-1]:.1f} ms (warm-up {ms[0]:.1f}; plain versions {plain_ms:.1f}), loss "
        f"{kernel_loss:.5f}, every gradient finite and nonzero, within {MX_LOSS_GAP:g} (loss) "
        f"and {MX_GRAD_GAP:g} (gradients) of the plain versions'; launches {launches}; peak "
        f"{peak_gb:.2f} GB, {plain_peak_gb:.2f} with the plain versions ({held_gb:.2f} held)")
    return out


# Phase (audit): the auditor's matrix on the card, and the dry run's cost
# counter on path (i)'s round and (f)'s prefill beside their measured times.
# NVLink 450 GB/s each way (H100 SXM data sheet): the collective term's
# rate, which one card's round never uses.
NVLINK_BYTES_PER_S = 450e9
AUDIT_PREFILL_ARCH = "qwen3-14b"


def counted_shares(costs, ms: float) -> dict:
    """The roofline terms (ms) of counted work on the data sheet's peaks,
    and each term's share of a measured time."""
    from repro_torch.launch.cost_analysis import roofline

    terms = roofline(costs, bf16_flops_per_s=BF16_FLOPS_PER_S, f32_flops_per_s=F32_FLOPS_PER_S,
                     hbm_bytes_per_s=HBM_BYTES_PER_S, link_bytes_per_s=NVLINK_BYTES_PER_S)
    terms_ms = {k.replace("_s", "_ms"): v * 1e3 for k, v in terms.items()}
    return {"flops": costs.flops, "flops_by_kind": dict(costs.by_kind), "bytes": costs.bytes,
            "collective_bytes": costs.collective_bytes, "measured_ms": ms, "terms_ms": terms_ms,
            "shares": {k: v / ms for k, v in terms_ms.items()},
            "kernels": {k: v["calls"] for k, v in costs.kernels.items()}}


def audit_on_card(case_names=None, tag: str = "(audit)") -> dict:
    """``launch/audit.py``'s cases (all, or ``case_names``) on the card, held
    to: every invariant; each case's kernel launches three ways, wrapper by
    wrapper -- the wrappers' calls and launches, ``torch.profiler``'s
    kernels -- equal to its ``expected_by_wrapper``; no host sync outside
    the known table; and its counted FLOPs, bytes and collective bytes equal
    to the CPU's stamp in ``analysis/budgets.json`` (``budgets.check_route``:
    the count does not depend on the route)."""
    from repro_torch.analysis import budgets
    from repro_torch.launch import audit

    report = audit.run_audit(case_names=case_names, device="cuda", strict_budgets=True,
                             verbose=False)
    for name, prog in report["programs"].items():
        three = (prog["calls_by_wrapper"], prog["launches_by_wrapper"],
                 prog["profiled_by_wrapper"])
        require(three == (prog["expected_by_wrapper"],) * 3,
                f"{tag} {name}: calls, launches and profiled kernels by wrapper {three}, "
                f"expected {prog['expected_by_wrapper']}")
    route = budgets.check_route({n: {m: p[m] for m in budgets.METRICS}
                                 for n, p in report["programs"].items()})
    require(not route, f"{tag} the card's counts against the CPU's stamp: "
            f"{[str(f) for f in route]}")
    require(report["ok"], f"{tag} the auditor on the card: {report['errors']}")
    return report


def phase_audit_matrix(torch) -> dict:
    """Phase (audit), its first part, right after the build: the full
    matrix on the card (:func:`audit_on_card`). It runs first because the
    profiler's count of a chunk's kernels is exact early in a process and
    not late in this script: after (mx) a case's trace has kept 9 of 14
    kernels with no pad at its ends, 5 of 8 with 0.05 s and 5 of 8 with 0.5
    s (``core/driver.py::_TRACE_PAD_S``; PERF.md, open questions)."""
    t_phase = time.perf_counter()
    report = audit_on_card()
    sites = {}
    for prog in report["programs"].values():
        for site in prog["syncs"] or []:
            key = f"{site[0]}:{site[1]} ({site[2]}: {site[3]})" if site else "outside the port"
            sites[key] = sites.get(key, 0) + 1
    audit_s = time.perf_counter() - t_phase
    launched = {n: p["launches_by_wrapper"] for n, p in report["programs"].items()
                if p["kernel_launches"]}
    log(f"(audit) {len(report['cases'])} cases on the card in {audit_s:.1f} s: ok; launches "
        f"{launched} (calls = launches = profiled = expected, wrapper by wrapper); counts "
        f"equal to the CPU's stamp; host syncs seen (known sites "
        f"only): {sites}")
    return {"cases": report["cases"], "programs": {
        n: {k: p[k] for k in ("kernel_calls", "kernel_launches", "profiled_launches",
                              "expected_calls", "expected_by_wrapper", "flops", "bytes",
                              "collective_bytes")}
        for n, p in report["programs"].items()}, "syncs": sites, "audit_s": audit_s,
        "notes": len(report["notes"])}


def phase_audit(torch, np, lm_flat: dict, prefill: dict, matrix: dict) -> dict:
    """Phase (audit), its second part: the dry run's counter
    (``launch/cost_analysis.py`` on ``meta``) on path (i)'s round and on
    (f)'s prefill at the shapes the script runs: the counted FLOPs and bytes
    beside the measured ms and the share of each roofline term, the state's
    bytes (equal to (i)'s on the card) and the tracker's peak beside (i)'s
    ``max_memory_allocated``; ``matrix`` is the first part's record."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import param_specs
    from repro_torch.core.device import MetaFactories
    from repro_torch.core.driver import _state_tensors
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.models.transformer import build_model

    t_phase = time.perf_counter()
    # (i)'s round, counted on meta.
    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH), num_layers=LM_TRAIN_LAYERS)
    bundle = build_model(cfg)
    G, K = LM_TRAIN_LEVELS
    spec = api.ExperimentSpec(
        levels=(G, K), backend="sharded", algorithm="mtgc", lr=LM_TRAIN_LR, fusion="fused",
        state_layout="flat", schedule=api.RoundSchedule(
            group_rounds=LM_TRAIN_E, local_steps=LM_TRAIN_H, microbatches=LM_TRAIN_A))
    engine = api.build(spec, bundle.loss)
    t0 = time.perf_counter()
    state = engine.abstract_state(param_specs(cfg, bundle))
    lead = (LM_TRAIN_E, LM_TRAIN_H, LM_TRAIN_A, G, K, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    batch = {k: torch.empty(lead, dtype=torch.int32, device="meta") for k in ("tokens", "targets")}
    state_bytes = sum(t.numel() * t.element_size() for t in _state_tensors(state))
    held = state_bytes + sum(t.numel() * t.element_size() for t in batch.values())
    with CostCounter(track_live=True) as cc:
        engine.round_fn(state, batch)
    count_i_s = time.perf_counter() - t0
    card_state = lm_flat["state_gb"] * 1e9
    require(abs(state_bytes - card_state) <= 1e-9 * card_state,
            f"(audit) the meta state of (i) holds {state_bytes} bytes, the card's {card_state}")
    i_out = counted_shares(cc.costs, lm_flat["round_ms"])
    i_out.update(state_bytes=state_bytes, tracker_peak_bytes=held + cc.peak_bytes,
                 card_peak_gb=lm_flat["peak_gb"], card_held_gb=lm_flat["held_gb"],
                 count_s=count_i_s)
    want = lm_train_launches(cfg, 1)
    for name in ("flash_attention", "flash_attention_bwd"):
        calls = i_out["kernels"].get(name, 0)
        require(calls * (3 if name == "flash_attention_bwd" else 1) == want[name],
                f"(audit) the meta round of (i) called {name} {calls} times; the card's round "
                f"launched {want[name]}")
    # (f)'s prefill, counted on meta.
    pcfg = get_arch(AUDIT_PREFILL_ARCH)
    pbundle = build_model(pcfg)
    t0 = time.perf_counter()
    params = param_specs(pcfg, pbundle)
    with MetaFactories():
        cache = pbundle.init_cache(LM_BATCH, LM_PROMPT + LM_GEN, device="cuda")
    tokens = torch.empty((LM_BATCH, LM_PROMPT), dtype=torch.int32, device="meta")
    with torch.no_grad(), CostCounter(track_live=True) as pc:
        pbundle.prefill(params, {"tokens": tokens}, cache)
    f_out = counted_shares(pc.costs, prefill["prefill_ms"])
    f_out["count_s"] = time.perf_counter() - t0
    require(f_out["kernels"].get("flash_attention") == pcfg.num_layers,
            f"(audit) the meta prefill called flash {f_out['kernels']}")
    out = dict(matrix, i=i_out, f=f_out)
    for tag, r in (("(i) round", i_out), ("(f) prefill", f_out)):
        log(f"(audit) {tag}: counted {r['flops']:.4e} FLOP ({r['flops_by_kind']['bf16']:.4e} "
            f"on the tensor cores), {r['bytes']:.4e} bytes; measured {r['measured_ms']:.1f} ms; "
            f"terms (data sheet) { {k: round(v, 3) for k, v in r['terms_ms'].items()} } ms; "
            f"achieved shares { {k: round(v, 4) for k, v in r['shares'].items()} }")
    log(f"(audit) (i)'s state: {state_bytes} bytes on meta = the card's; tracker peak "
        f"{i_out['tracker_peak_bytes'] / 1e9:.2f} GB against the card's "
        f"max_memory_allocated {lm_flat['peak_gb']:.2f} GB ({lm_flat['held_gb']:.2f} GB held "
        f"by earlier phases)")
    out["counts_s"] = time.perf_counter() - t_phase
    out["seconds"] = out["audit_s"] + out["counts_s"]
    log(f"(audit) phase: {out['seconds']:.1f} s ({out['audit_s']:.1f} s the matrix, "
        f"{out['counts_s']:.1f} s the counts)")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_main(sys.argv[1:])
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout (src/repro_torch not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch import api, convert
    from repro_torch.core.compression import upload_bytes
    from repro_torch.core.driver import select_round
    from repro_torch.core.engine import RoundDraws
    from repro_torch.core.packer import make_packer
    from repro_torch.core.participation import ParticipationMasks, round_masks
    from repro_torch.data import make_classification, partition, train_test_split
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import mtgc_update as mu
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import small

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # --- 1. device and build ------------------------------------------
    smi = device_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    built = build.build_all()
    log(f"kernel build: {built['seconds']:.2f} s")
    for name, text in built["log"].items():
        for entry, regs, spills in ptxas_entries(text):
            log(f"  {name}: {entry}: {regs}; {spills}")
    log_kernel_resources(build, built["log"])
    # --- 1b. (audit) the auditor's matrix on the card ----------------------
    audit_matrix = phase_audit_matrix(torch)

    init, apply = small.cnn(10, IMAGE)
    p0 = init(torch.Generator().manual_seed(0), device="cuda")
    packer = make_packer(p0)
    N = packer.num_params
    require(N == 2_156_490, f"the CIFAR-10 CNN has {N} params, expected 2,156,490")
    leaf_shapes = [(GROUPS, CLIENTS) + s.shape for s in packer.segments]

    # --- 2. kernels ---------------------------------------------------
    errs, flat_t, leaf_t = phase_kernels(torch, mu, N, leaf_shapes)

    # --- 3. main path: flat + fused -----------------------------------
    rng = np.random.default_rng(0)
    ds = make_classification(rng, num_samples=20000, num_classes=10,
                             dim=math.prod(IMAGE), image_shape=IMAGE)
    train, test = train_test_split(ds, rng)
    # Group i.i.d., client non-i.i.d. with Dirichlet(0.1) (paper Sec. 5.1).
    idx = partition(train.y, GROUPS, CLIENTS, mode="group_iid", alpha=0.1, seed=0)
    loss_fn = small.make_loss(apply)
    acc = small.make_accuracy(apply, torch.from_numpy(test.x).cuda(),
                              torch.from_numpy(test.y).cuda())
    schedule = api.RoundSchedule(group_rounds=E, local_steps=H)
    spec = api.ExperimentSpec(levels=(GROUPS, CLIENTS), schedule=schedule,
                              algorithm="mtgc", fusion="fused", lr=LR)
    engine = api.build(spec, loss_fn)
    require(engine.device.type == "cuda", "the engine is not on the card")
    t0 = time.perf_counter()
    data = engine.pack_arrays({"x": train.x, "y": train.y}, idx, batch_size=BATCH,
                              shards=4, rng=np.random.default_rng(1),
                              generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    log(f"packed {tuple(data.arrays['x'].shape)} in {time.perf_counter() - t0:.2f} s")

    def eval_fn(prev, st):
        return {"acc": acc(engine.global_model(st))}

    torch.cuda.reset_peak_memory_stats()
    mu.reset_launch_counts()
    t0 = time.perf_counter()
    state, hz = api.fit(engine, data, ROUNDS, params=p0, eval_every=ROUNDS, eval_fn=eval_fn)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    flat_launches, leaf_in_flat = mu.mtgc_update_flat.launches, mu.mtgc_update.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(flat_launches == E * H * ROUNDS,
            f"mtgc_update_flat launched {flat_launches} times, expected {E * H * ROUNDS}")
    require(leaf_in_flat == 0, "the flat path launched the per-leaf kernel")
    finite_metrics(np, hz)
    require(hz.metrics.loss.shape == (ROUNDS, E, H), f"loss shape {hz.metrics.loss.shape}")
    x_fin = state.params.bufs["float32"]
    require(tuple(x_fin.shape) == (GROUPS, CLIENTS, N) and bool(torch.isfinite(x_fin).all()),
            "final params are not finite [G, K, N]")
    t0 = time.perf_counter()
    state, hz1 = api.fit(engine, data, 1, state=state)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) * 1e3
    finite_metrics(np, hz1)
    log(f"flat+fused: fit {ROUNDS} rounds in {fit_s:.3f} s (first round includes warm-up); "
        f"one more round {steady_ms:.1f} ms; peak memory {peak_gb:.2f} GB; "
        f"mtgc_update_flat launches {flat_launches}")
    log(f"  loss per step {np.round(hz.metrics.loss.reshape(-1), 4).tolist()}")
    log_trace("profiled round", profile_round(torch, lambda: api.fit(engine, data, 1,
                                                                      state=state)))
    log(f"  eval rounds {hz.eval_rounds.tolist()} acc {hz.evals['acc'].tolist()}; "
        f"z_norm {hz.metrics.z_norm.tolist()} y_norm {hz.metrics.y_norm.tolist()} "
        f"comm_bytes {hz.metrics.comm_bytes.tolist()}")

    # --- 4. tree + fused, one round -------------------------------------
    tree_spec = api.ExperimentSpec(levels=(GROUPS, CLIENTS), schedule=schedule,
                                   algorithm="mtgc", fusion="fused", lr=LR,
                                   state_layout="tree")
    tree_engine = api.build(tree_spec, loss_fn)
    tree_state = tree_engine.init(p0)
    torch.cuda.synchronize()
    mu.reset_launch_counts()
    t0 = time.perf_counter()
    tree_state, hz_t = api.fit(tree_engine, data, 1, state=tree_state)
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t0) * 1e3
    leaf_launches, flat_in_tree = mu.mtgc_update.launches, mu.mtgc_update_flat.launches
    n_leaves = len(packer.segments)
    require(leaf_launches == E * H * n_leaves,
            f"mtgc_update launched {leaf_launches} times, expected {E * H * n_leaves}")
    require(flat_in_tree == 0, "the tree path launched the flat kernel")
    finite_metrics(np, hz_t)
    log(f"tree+fused: one round {tree_ms:.1f} ms (first tree round); mtgc_update launches "
        f"{leaf_launches}; loss {np.round(hz_t.metrics.loss.reshape(-1), 4).tolist()}")
    del tree_state, tree_engine

    # --- 5. fused against unfused, same state and batches --------------
    unfused = api.build(api.ExperimentSpec(levels=(GROUPS, CLIENTS), schedule=schedule,
                                           algorithm="mtgc", lr=LR), loss_fn)
    sid = torch.randint(0, data.num_shards, (E, GROUPS, CLIENTS),
                        generator=torch.Generator().manual_seed(7))
    batches = select_round(data, sid)
    torch.backends.cudnn.deterministic = True
    s_f, m_f = engine.round_fn(state, batches)
    s_u, m_u = unfused.round_fn(state, batches)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    xf, xu = s_f.params.bufs["float32"][0, 0], s_u.params.bufs["float32"][0, 0]
    diff = (xf - xu).abs().max().item()
    scale = xu.abs().max().item()
    loss_diff = (m_f.loss - m_u.loss).abs().max().item()
    log(f"fused vs unfused (deterministic cuDNN): max |dx| {diff} (max |x| {scale}), "
        f"max |dloss| {loss_diff}")
    require(diff <= 1e-5 * scale, "fused and unfused rounds disagree beyond 1e-5 relative")
    del s_f, s_u, batches, state, engine, unfused
    torch.cuda.empty_cache()

    # --- 6. quantize kernels ------------------------------------------
    q_errs, q_t = phase_quantize(torch, qz, N)

    # --- 7. compressed main path: flat + fused, int8 on both links ------
    sizes = ((N, "float32"),)
    int8_spec = dataclasses.replace(
        spec, compression=api.CompressionPlan("int8_stochastic", "int8_stochastic"))
    c_engine = api.build(int8_spec, loss_fn)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    c_state, hz_c = api.fit(c_engine, data, ROUNDS, params=p0)
    torch.cuda.synchronize()
    c_fit_s = time.perf_counter() - t0
    int8_launches = qz.int8_roundtrip.launches
    c_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(int8_launches == ROUNDS * (E + 1),
            f"int8_roundtrip launched {int8_launches} times, expected {ROUNDS * (E + 1)}")
    require(mu.mtgc_update_flat.launches == E * H * ROUNDS and qz.topk_mask.launches == 0,
            "the compressed flat path launched the wrong kernels")
    finite_metrics(np, hz_c)
    wire = upload_bytes(sizes, "int8_stochastic") * (E * GROUPS * CLIENTS + GROUPS)
    comm = np.asarray(hz_c.metrics.comm_bytes, np.float64)
    require(bool(np.all(np.abs(comm - wire) <= wire * 2.0 ** -22)),
            f"comm_bytes {comm.tolist()} is not the int8 wire model {wire}")
    for name in ("efc", "efg"):
        r = getattr(c_state, name).bufs["float32"]
        require(bool(torch.isfinite(r).all()) and bool((r != 0).any()),
                f"the {name} residual is not finite or is all zero")
    t0 = time.perf_counter()
    c_state, hz_c1 = api.fit(c_engine, data, 1, state=c_state)
    torch.cuda.synchronize()
    c_ms = (time.perf_counter() - t0) * 1e3
    finite_metrics(np, hz_c1)
    log_trace("profiled compressed round", profile_round(
        torch, lambda: api.fit(c_engine, data, 1, state=c_state)), top_n=20)
    log(f"compressed flat+fused (int8/int8, EF): fit {ROUNDS} rounds in {c_fit_s:.3f} s; one "
        f"more round {c_ms:.1f} ms; peak memory {c_peak_gb:.2f} GB; int8_roundtrip launches "
        f"{int8_launches}; comm_bytes {comm.tolist()} (uncompressed "
        f"{hz.metrics.comm_bytes.tolist()}); loss "
        f"{np.round(hz_c.metrics.loss.reshape(-1), 4).tolist()}")

    # --- 8. compressed: fused against unfused, same state and draws ------
    c_unfused = api.build(dataclasses.replace(int8_spec, fusion="none"), loss_fn)
    batches = select_round(data, sid)
    gen = torch.Generator(device="cuda").manual_seed(8)
    draws = RoundDraws(
        client_noise=[[torch.rand((GROUPS * CLIENTS, N), generator=gen, device="cuda")]
                      for _ in range(E)],
        group_noise=[torch.rand((GROUPS, N), generator=gen, device="cuda")])
    torch.backends.cudnn.deterministic = True
    s_f, m_f = c_engine.round_fn(c_state, batches, draws=draws)
    s_u, m_u = c_unfused.round_fn(c_state, batches, draws=draws)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    for name in ("params", "z", "y", "efc", "efg"):
        require(torch.equal(getattr(s_f, name).bufs["float32"],
                            getattr(s_u, name).bufs["float32"]),
                f"compressed fused and unfused rounds differ in {name}")
    require(torch.equal(m_f.loss, m_u.loss), "compressed fused and unfused losses differ")
    log("compressed fused vs unfused (deterministic cuDNN, injected draws): params, z, y, "
        "efc, efg bit-identical")
    del s_f, s_u, batches, draws, c_state, c_engine, c_unfused
    torch.cuda.empty_cache()

    # --- 9. partial participation, top-k client link, bf16 group link ----
    part_spec = dataclasses.replace(
        spec, compression=api.CompressionPlan("topk", "bf16", topk_frac=TOPK_FRAC),
        client_participation=0.5, participation_mode="fixed",
        participation_weighting="inverse_prob")
    p_engine = api.build(part_spec, loss_fn)
    p_state0 = p_engine.init(p0)
    mgen = torch.Generator(device="cuda")
    mgen.set_state(p_state0.rng.get_state())
    masks = round_masks(mgen, part_spec.to_hfl_config())  # the draw the round makes
    masked_calls = []
    flat_launch = ops.mtgc_update_flat

    def spy(x, g, z, y, mask=None, **kw):
        masked_calls.append(mask is not None)
        return flat_launch(x, g, z, y, mask, **kw)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.mtgc_update_flat = spy
    try:
        t0 = time.perf_counter()
        p_state, hz_p = api.fit(p_engine, data, 1, state=p_state0)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops.mtgc_update_flat = flat_launch
    topk_launches, flat_in_partial = qz.topk_mask.launches, mu.mtgc_update_flat.launches
    p_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(topk_launches == E, f"topk_mask launched {topk_launches} times, expected {E}")
    require(flat_in_partial == E * H and len(masked_calls) == E * H and all(masked_calls),
            f"mtgc_update_flat launched {flat_in_partial} times ({sum(masked_calls)} with a "
            f"mask), expected {E * H} masked")
    require(qz.int8_roundtrip.launches == 0, "the top-k/bf16 path launched int8_roundtrip")
    finite_metrics(np, hz_p)
    frozen = masks.client == 0
    n_active = int(masks.client.sum().item())
    require(n_active == GROUPS * CLIENTS // 2, f"{n_active} active clients, expected 50")
    for name in ("params", "z", "efc"):
        before = getattr(p_state0, name).bufs["float32"][frozen]
        after = getattr(p_state, name).bufs["float32"][frozen]
        require(torch.equal(before.view(torch.int32), after.view(torch.int32)),
                f"a frozen replica's {name} changed")
    gact = int((masks.client.sum(dim=1) > 0).sum().item())
    wire = (upload_bytes(sizes, "topk", TOPK_FRAC) * E * n_active
            + upload_bytes(sizes, "bf16") * gact)
    comm = float(hz_p.metrics.comm_bytes[0])
    require(abs(comm - wire) <= wire * 2.0 ** -22,
            f"partial comm_bytes {comm} is not the wire model {wire}")
    require(abs(float(hz_p.metrics.participation[0]) - 0.5) < 1e-7, "participation is not 0.5")
    t0 = time.perf_counter()
    api.fit(p_engine, data, 1, state=p_state)
    torch.cuda.synchronize()
    p2_ms = (time.perf_counter() - t0) * 1e3
    log(f"partial (C=0.5 fixed, inverse_prob; top-k 0.1 / bf16, EF): one round {p_ms:.1f} ms "
        f"(first round of this spec), the next {p2_ms:.1f} ms; peak memory {p_peak_gb:.2f} GB; "
        f"topk_mask launches "
        f"{topk_launches}; masked mtgc_update_flat launches {sum(masked_calls)}; "
        f"{int(frozen.sum())} frozen replicas bit-identical; comm_bytes {comm} "
        f"({E} x {n_active} client uploads + {gact} groups)")
    del p_state, p_state0, p_engine

    # --- 10. tree + fused, int8 on both links, one round ----------------
    tc_engine = api.build(dataclasses.replace(int8_spec, state_layout="tree"), loss_fn)
    tc_state = tc_engine.init(p0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tc_state, hz_tc = api.fit(tc_engine, data, 1, state=tc_state)
    torch.cuda.synchronize()
    tc_ms = (time.perf_counter() - t0) * 1e3
    tree_int8 = qz.int8_roundtrip.launches
    require(tree_int8 == n_leaves * E + n_leaves,
            f"tree int8_roundtrip launched {tree_int8} times, expected {n_leaves * (E + 1)}")
    require(mu.mtgc_update.launches == E * H * n_leaves, "the tree path's leaf launches")
    finite_metrics(np, hz_tc)
    log(f"tree+fused int8/int8: one round {tc_ms:.1f} ms (first round of this spec); "
        f"int8_roundtrip launches {tree_int8}")
    del tc_state, tc_engine

    # --- 10b. (m) HFL under faults on the simulator engine ---------------
    hfl_m = phase_faults_hfl(torch, np, api, spec, data, p0, loss_fn)
    # --- 10c. (o) async group rounds on the simulator engine -------------
    hfl_o = phase_async_hfl(torch, np, api, spec, data, p0, loss_fn)
    log(f"(o1) against the same run's (a): {hfl_o['o1']['window_ms']:.1f} ms a window against "
        f"{steady_ms:.1f} ms a round; peak {hfl_o['o1']['peak_gb']:.2f} GB against "
        f"{peak_gb:.2f} GB")
    # --- 10d. (r) virtual populations, (t) checkpoints, path (a) ---------
    hfl_r = phase_population_hfl(torch, np, api, spec, data, p0, loss_fn)
    hfl_t = phase_checkpoint_hfl(torch, np, api, spec, data, p0, loss_fn)
    # --- 10f. (ls) the low-level surface on path (a) ---------------------
    surface = phase_low_level_surface(torch, np, api, spec, data, p0, loss_fn, apply, train,
                                      test, idx)
    del data
    torch.cuda.empty_cache()
    # --- 10e. (u) the multilevel backend over a 4 x 5 x 5 tree -----------
    hfl_u = phase_multilevel_hfl(torch, np, api, train, p0, loss_fn)

    # --- 11. card against CPU on a small input ---------------------------
    small_init, small_apply = small.cnn(10, (8, 8, 1))
    ps = small_init(torch.Generator().manual_seed(3), device="cpu")
    rs = np.random.default_rng(3)
    b = {"x": torch.from_numpy(rs.normal(size=(2, 2, 2, 3, 4, 8, 8, 1)).astype(np.float32)),
         "y": torch.from_numpy(rs.integers(0, 10, size=(2, 2, 2, 3, 4)).astype(np.int32))}
    worst = 0.0
    for layout in ("flat", "tree"):
        sp = api.ExperimentSpec(levels=(2, 3), schedule=api.RoundSchedule(2, 2),
                                fusion="fused", state_layout=layout)
        outs = []
        for dev in ("cuda", "cpu"):
            eng = api.build(sp, small.make_loss(small_apply), device=dev)
            st, met = eng.round_fn(eng.init(ps), {k: v.to(dev) for k, v in b.items()})
            outs.append(convert.to_numpy(eng.global_model(st)))
        for name in outs[1]:
            for leaf in outs[1][name]:
                gpu, cpu = outs[0][name][leaf], outs[1][name][leaf]
                err = float(np.max(np.abs(gpu - cpu) / (1e-5 + np.abs(cpu))))
                worst = max(worst, err)
                require(np.allclose(gpu, cpu, rtol=1e-4, atol=1e-5),
                        f"{layout}: {name}/{leaf} differs between card and CPU")
    log(f"card vs CPU on cnn(8x8x1), G=2 K=3 E=2 H=2: agree within rtol 1e-4 "
        f"(worst {worst:.2e})")

    # A compressed round under partial participation, draws injected, on an
    # elementwise quadratic model (both devices compute it in one order, so
    # no one-ulp difference can move an int8 step; the CNN's convolutions
    # would, see ROADMAP queue 3).
    def quad_loss(p, bt):
        r = bt["a"] * p["w"] - bt["b"]
        return 0.5 * torch.sum(r * r) + 0.5 * torch.sum((bt["c"] * p["v"] - bt["e"]) ** 2)

    pq = {"w": torch.zeros(200), "v": torch.zeros(30)}
    bq = {k: torch.from_numpy((rs.normal(size=(2, 2, 2, 3, n)) + off).astype(np.float32))
          for k, n, off in (("a", 200, 1.0), ("b", 200, 0.0), ("c", 30, 1.0), ("e", 30, 0.0))}
    dq = RoundDraws(
        masks=ParticipationMasks(torch.ones(2), torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]])),
        client_noise=[[torch.from_numpy(rs.random((6, 230)).astype(np.float32))]
                      for _ in range(2)])
    for layout in ("flat", "tree"):
        sp = api.ExperimentSpec(levels=(2, 3), schedule=api.RoundSchedule(2, 2),
                                fusion="fused", state_layout=layout, client_participation=0.5,
                                compression=api.CompressionPlan("int8_stochastic", "topk",
                                                                topk_frac=0.2))
        outs = []
        for dev in ("cuda", "cpu"):
            eng = api.build(sp, quad_loss, device=dev)
            draws = dq if layout == "flat" else dq._replace(client_noise=[
                [n[0][:, 200:], n[0][:, :200]] for n in dq.client_noise])  # leaves v, w
            st, met = eng.round_fn(eng.init(pq), {k: v.to(dev) for k, v in bq.items()},
                                   draws=draws)
            outs.append(convert.to_numpy(st))
        for name in ("params", "z", "y", "efc", "efg"):
            for key, cpu in outs[1][name].items():
                gpu = outs[0][name][key]
                require(np.allclose(gpu, cpu, rtol=1e-5, atol=1e-6),
                        f"compressed partial {layout}: {name}/{key} differs between card and CPU")
    log("card vs CPU, compressed (int8 client, top-k group) at C=0.5 with injected draws, "
        "flat and tree: agree within rtol 1e-5")
    # Two async windows (group_rounds (2, 1), delay-compensated) of the small
    # CNN, flat + fused, at the uncompressed round's tolerance.
    worst = 0.0
    sp = api.ExperimentSpec(levels=(2, 3), schedule=api.RoundSchedule((2, 1), 2), fusion="fused",
                            staleness="delay_compensated")
    outs = []
    for dev in ("cuda", "cpu"):
        eng = api.build(sp, small.make_loss(small_apply), device=dev)
        st = eng.init(ps)
        for _ in range(2):
            st, met = eng.round_fn(st, {k: v.to(dev) for k, v in b.items()})
        outs.append(convert.to_numpy(st))
    for name in ("params", "snap", "glob"):
        for key, cpu in outs[1][name].items():
            gpu = outs[0][name][key]
            worst = max(worst, float(np.max(np.abs(gpu - cpu) / (1e-5 + np.abs(cpu)))))
            require(np.allclose(gpu, cpu, rtol=1e-4, atol=1e-5),
                    f"async: {name}/{key} differs between card and CPU")
    log(f"card vs CPU, async (2, 1) delay_compensated, two windows of cnn(8x8x1): params, snap, "
        f"glob agree within rtol 1e-4 (worst {worst:.2e})")

    # --- 12. LM kernels ------------------------------------------------
    del acc, p0, ds, train, test
    torch.cuda.empty_cache()
    lm_errs, lm_t = phase_lm_kernels(torch, fa, rw)
    win_t = phase_window_kernels(torch, fa)
    ss_errs, ss_t = phase_ssm_kernel(torch, ss)
    # --- 12b. the scan's backward at the training shape -----------------
    sb_errs, sb_t = phase_scan_backward(torch, rw, built["log"])
    # --- 12c. the moe dispatch kernels ------------------------------------
    moe_errs, moe_t = phase_moe_kernels(torch, md, built["log"])
    # --- 12d. the selective scan's backward at the training shape --------
    ssb_errs, ssb_t = phase_ssm_backward(torch, ss, built["log"])

    # --- 13. LM serving at full width -----------------------------------
    # Launches reckoned for one served batch, all in the prefill: flash one
    # a layer (qwen3 40, qwen2.5 64, gemma3 62 -- 52 windowed, 10 global --,
    # hymba 32, windowed), rwkv6_scan three a layer (24 layers), hymba's
    # selective scan one a layer; decode runs none of them. (f4) granite:
    # flash and the moe dispatch and combine once a layer in the prefill,
    # and the dispatch and combine once a layer in each of the 31 decode
    # steps (dropless, 4 tokens).
    # (f5) whisper: flash once a decoder layer in the prefill (its encoder and
    # cross-attention are plain products, as the reference's); (f6)
    # internvl2: once a layer.
    served = []
    moe_serve = {"moe_gather": MOE_LAYERS, "moe_combine": MOE_LAYERS}
    for arch, want, prompt in (
            ("qwen3-14b", {"flash_attention": 40}, LM_PROMPT),
            ("rwkv6-1.6b", {"rwkv6_scan": 72}, LM_PROMPT),
            ("qwen2.5-32b", {"flash_attention": 64}, LM_PROMPT),
            ("gemma3-27b", {"flash_attention": 62}, LM_PROMPT),
            ("hymba-1.5b", {"flash_attention": 32, "selective_scan": 32}, LM_PROMPT),
            (MOE_ARCH, {"flash_attention": MOE_LAYERS, **moe_serve}, LM_PROMPT),
            (AUDIO_ARCH, {"flash_attention": AUDIO_LAYERS}, AUDIO_PROMPT),
            (VLM_ARCH, {"flash_attention": VLM_LAYERS}, LM_PROMPT)):
        run = phase_serve(torch, np, arch, lambda: serve_launches(fa, rw, ss, md), prompt)
        want = {k: want.get(k, 0) for k in run["launches"]}
        total = dict(want, **{k: v * LM_GEN for k, v in want.items() if k in moe_serve})
        require(run["prefill_launches"] == want and run["launches"] == total,
                f"{arch} launched {run['prefill_launches']} in the prefill and "
                f"{run['launches']} in all; expected {want} and {total} (the moe dispatch "
                f"and combine in decode)")
        served.append(run)
    qwen, rwkv, hymba, granite = served[0], served[1], served[4], served[5]

    # --- 14. LM: card against CPU, reduced ------------------------------
    phase_lm_card_vs_cpu(torch, np, convert)

    # --- 15. the attention backward at the training shape ---------------
    bwd_errs, bwd_t = phase_lm_backward(torch, fa)

    # --- 16. LM training, tree + fused ------------------------------------
    lm_tree = phase_lm_train(torch, np, "tree", rounds=1, trace=True, tag="h")
    # --- 17. LM training, flat + fused ------------------------------------
    lm_flat = phase_lm_train(torch, np, "flat", rounds=1, trace=False, tag="i")
    # --- 17a. (mesh) path (i)'s round on torch.distributed meshes ----------
    mesh_runs = phase_mesh(torch, np, lm_flat)
    # --- 17b. (s) a virtual population on the sharded backend ------------
    lm_s = phase_lm_population(torch, np, lm_flat["peak_gb"])
    # --- 18-20. LM training: compressed uploads, partial participation ---
    part = dict(client_participation=LM_TRAIN_PARTIAL, participation_mode="fixed")
    lm_j = phase_lm_train(torch, np, "flat", rounds=1, trace=True, tag="j", spec_kw=dict(
        compression=api.CompressionPlan("int8_stochastic", "none")))
    lm_k = phase_lm_train(torch, np, "flat", rounds=1, trace=True, tag="k", spec_kw=dict(
        part, participation_weighting="inverse_prob"))
    lm_l = phase_lm_train(torch, np, "tree", rounds=1, trace=True, tag="l", spec_kw=dict(
        part, participation_weighting="none",
        compression=api.CompressionPlan("none", "topk", topk_frac=LM_TRAIN_TOPK_FRAC)))
    require(abs(lm_k["peak_gb"] - lm_flat["peak_gb"]) <= 0.5,
            f"(k)'s peak {lm_k['peak_gb']:.2f} GB is not within 0.5 GB of (i)'s "
            f"{lm_flat['peak_gb']:.2f} GB")
    # --- 20b. (n) LM training under faults on the sharded backend --------
    lm_n = phase_lm_train_faults(torch, np)
    log(f"(n) against the same run's (i) {lm_flat['round_ms']:.1f} ms / "
        f"{lm_flat['peak_gb']:.2f} GB and (k) {lm_k['round_ms']:.1f} ms / "
        f"{lm_k['peak_gb']:.2f} GB: {lm_n['round_ms_less_snapshot']:.1f} ms less the snapshot, "
        f"{lm_n['peak_gb']:.2f} GB")
    # --- 20c. (p), (q) async LM training on the sharded backend ----------
    from repro_torch.core.faults import FaultMasks, FaultPlan
    lm_p = phase_lm_train_async(torch, np, "p", "flat", dict(staleness="delay_compensated"),
                                [None, None, None], kept=[])
    G2, K2 = LM_TRAIN_LEVELS
    qmasks = ParticipationMasks(torch.ones(G2), torch.tensor([[1.0, 0.0], [0.0, 1.0]]))

    def qdraw(timeout):
        return RoundDraws(masks=qmasks, faults=FaultMasks(
            torch.zeros(G2, K2), torch.tensor(timeout), torch.zeros(G2, K2)))

    lm_q = phase_lm_train_async(
        torch, np, "q", "tree", dict(staleness="discount", client_participation=LM_TRAIN_PARTIAL,
                                     participation_mode="fixed",
                                     participation_weighting="inverse_prob",
                                     faults=FaultPlan(timeout_rate=0.05)),
        [qdraw([0.0, 0.0]), qdraw([0.0, 1.0]), qdraw([0.0, 0.0])],
        kept=[("x", 0, 1), ("z", 0, 1), ("x", 1, 0), ("z", 1, 0), ("y", 1)])
    require(lm_q["after_timed_window"]["dl"] == [1.0, 0.0],
            f"(q) dl after the timeout {lm_q['after_timed_window']['dl']}, expected [1, 0]")
    log(f"(p)/(q) against the same run's (i) {lm_flat['round_ms']:.1f} ms / "
        f"{lm_flat['peak_gb']:.2f} GB and (k) {lm_k['round_ms']:.1f} ms / "
        f"{lm_k['peak_gb']:.2f} GB: (p) {lm_p['round_ms']:.1f} ms / {lm_p['peak_gb']:.2f} GB, "
        f"(q) {lm_q['round_ms']:.1f} ms / {lm_q['peak_gb']:.2f} GB")
    # --- 21. LM training: card against CPU, reduced -----------------------
    phase_lm_train_card_vs_cpu(torch, np, convert)

    # --- 23. (v) rwkv6-1.6b training at full width and depth ---------------
    # Only (v1) is traced: (v2) is the same model on the tree layout, and
    # the phases (w) added after it share the script's time limit.
    lm_v = [phase_lm_train(torch, np, layout, rounds=1, trace=tag == "v1", tag=tag,
                           arch=SSM_TRAIN_ARCH, layers=layers)
            for tag, layout, layers in (("v1", "flat", SSM_TRAIN_LAYERS),
                                        ("v2", "tree", TREE_VARIANT_LAYERS))]
    for run, n_update in zip(lm_v, (2, 19)):
        passes = LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * math.prod(LM_TRAIN_LEVELS) * run["layers"]
        want = {"rwkv6_scan": 3 * 2 * passes, "rwkv6_scan_bwd": 4 * passes,
                "mtgc_update_flat": LM_TRAIN_E * LM_TRAIN_H * n_update}
        require({k: run["launches"][k] for k in want} == want,
                f"({run['phase']}) launched {run['launches']}: {passes} passes of the scan and "
                f"its backward, the fused step on {n_update} buffers or leaves, expected {want}")
    lm_v3 = phase_lm_train_card_vs_cpu(torch, np, convert, arch=SSM_TRAIN_ARCH)

    # --- 24. (w) granite-moe-1b-a400m training at full width and depth ----
    # (w2) is not traced: its round is (w1)'s on the tree layout, and the
    # script's time limit is shared by every phase.
    lm_w = [phase_lm_train(torch, np, layout, rounds=1, trace=tag == "w1", tag=tag,
                           arch=MOE_ARCH, layers=layers)
            for tag, layout, layers in (("w1", "flat", MOE_LAYERS),
                                        ("w2", "tree", TREE_VARIANT_LAYERS))]
    for run in lm_w:
        passes = LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * math.prod(LM_TRAIN_LEVELS) * run["layers"]
        # Under remat: two forwards and a backward a layer pass.
        want = {"moe_gather": 3 * passes, "moe_combine": 3 * passes, "moe_gate_grad": passes,
                "flash_attention": 2 * passes, "flash_attention_bwd": 3 * passes}
        require({k: run["launches"][k] for k in want} == want,
                f"({run['phase']}) launched {run['launches']}: {passes} layer passes, "
                f"expected {want}")
    lm_w3 = phase_lm_train_card_vs_cpu(torch, np, convert, arch=MOE_ARCH)
    # --- 25. (y) hymba-1.5b training at full width and depth ---------------
    # (y2) is not traced: its round is (y1)'s on the tree layout.
    lm_y = [phase_lm_train(torch, np, layout, rounds=1, trace=tag == "y1", tag=tag,
                           arch=HYBRID_TRAIN_ARCH, layers=layers)
            for tag, layout, layers in (("y1", "flat", HYBRID_TRAIN_LAYERS),
                                        ("y2", "tree", TREE_VARIANT_LAYERS))]
    for run in lm_y:
        passes = LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * math.prod(LM_TRAIN_LEVELS) * run["layers"]
        # Under remat: two forwards and a backward a layer pass.
        want = {"selective_scan": 2 * passes, "selective_scan_bwd": ss.BWD_LAUNCHES * passes,
                "flash_attention": 2 * passes, "flash_attention_bwd": 3 * passes}
        require({k: run["launches"][k] for k in want} == want,
                f"({run['phase']}) launched {run['launches']}: {passes} layer passes, "
                f"expected {want}")
    lm_y3 = phase_lm_train_card_vs_cpu(torch, np, convert, arch=HYBRID_TRAIN_ARCH)
    # --- 26. (z) whisper-medium training at full width and depth, frames ----
    # 32 microbatches a round (E x H x A x G x K) through 24 decoder layers:
    # flash forward twice a layer pass under remat (1536), its backward three
    # kernels once (768 calls, 2304 launches); the encoder and the
    # cross-attention are plain products. The fused step once a step on the
    # flat state's one bf16 buffer, once a leaf a step on the tree layout.
    lm_z = [phase_lm_train(torch, np, layout, rounds=1, trace=tag == "z1", tag=tag,
                           arch=AUDIO_ARCH, layers=AUDIO_LAYERS)
            for tag, layout in (("z1", "flat"), ("z2", "tree"))]
    passes = LM_TRAIN_E * LM_TRAIN_H * LM_TRAIN_A * math.prod(LM_TRAIN_LEVELS) * AUDIO_LAYERS
    for run, n_update in zip(lm_z, (1, AUDIO_LEAVES)):
        want = {"flash_attention": 2 * passes, "flash_attention_bwd": 3 * passes,
                "mtgc_update_flat": LM_TRAIN_E * LM_TRAIN_H * n_update}
        require({k: run["launches"][k] for k in want} == want,
                f"({run['phase']}) launched {run['launches']}: {passes} decoder layer passes, "
                f"the fused step on {n_update} buffers or leaves, expected {want}")
    # --- 27. (z3) audio and vlm: card against CPU, and internvl2's loss -----
    lm_z3 = {arch: phase_lm_train_card_vs_cpu(torch, np, convert, arch=arch)
             for arch in (AUDIO_ARCH, VLM_ARCH)}
    av_z3 = phase_audio_vlm_checks(torch, np, convert)
    # --- 28. (mx) mixtral-8x22b at full width, 2 of 56 layers ---------------
    mx = phase_mixtral(torch, np, fa, md, lambda: serve_launches(fa, rw, ss, md))
    # --- 29. (audit) the auditor on the card; the dry run's counter -------
    audit_out = phase_audit(torch, np, lm_flat, qwen, audit_matrix)

    # --- 22. results -----------------------------------------------------
    kernels = [
        {"name": "mtgc_update_flat", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mtgc_update.cu",
         "replaces": "src/repro/kernels/mtgc_update.py:94",
         "launches": flat_launches, "max_abs_err": errs["flat"],
         "ms": flat_t["ms"], "plain_ms": flat_t["plain_ms"], "bound_ms": flat_t["bound_ms"],
         "bound_by": flat_t["bound_by"], "library_ms": None,
         "shape": f"x/g/z [{GROUPS},{CLIENTS},{N}] f32, y [{GROUPS},{N}], no mask"},
        {"name": "mtgc_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mtgc_update.cu",
         "replaces": "src/repro/kernels/mtgc_update.py:52",
         "launches": leaf_launches, "max_abs_err": errs["leaf"],
         "ms": leaf_t["ms"], "plain_ms": leaf_t["plain_ms"], "bound_ms": leaf_t["bound_ms"],
         "bound_by": leaf_t["bound_by"], "library_ms": None,
         "shape": f"one local step: {n_leaves} CNN leaves [{GROUPS},{CLIENTS},...] f32"},
    ]
    for name, launches, replaces in (("int8_roundtrip", int8_launches, 66),
                                     ("topk_mask", topk_launches, 96)):
        t, tg = q_t[f"{name}/client"], q_t[f"{name}/group"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": f"src/repro/kernels/quantize.py:{replaces}",
            "launches": launches, "max_abs_err": q_errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": f"u [{GROUPS * CLIENTS},{N}] f32 (client link)",
            "group_link": {"shape": f"u [{GROUPS},{N}] f32", "ms": tg["ms"],
                           "plain_ms": tg["plain_ms"], "bound_ms": tg["bound_ms"]},
            "threshold_ms": q_t["threshold/client"]["ms"] if name == "topk_mask" else None})
    for name, run, replaces, shape in (
            ("flash_attention", qwen, "src/repro/kernels/flash_attention.py:87",
             f"q [{LM_BATCH},{LM_PROMPT},40,128] bf16, k/v [{LM_BATCH},{LM_PROMPT + LM_GEN},8,128],"
             " causal (one qwen3-14b prefill layer)"),
            ("rwkv6_scan", rwkv, "src/repro/kernels/rwkv6_scan.py:79",
             f"r/k/v [{LM_BATCH},{LM_PROMPT},32,64] bf16, logw f32, C=64 (one rwkv6-1.6b "
             "prefill layer)")):
        t = lm_t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": lm_errs[name],
            "max_abs_err_f32": lm_errs[f"{name}/f32"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": shape})
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/flash_jnp.py:100",
        "launches": lm_tree["launches"]["flash_attention_bwd"],
        "max_abs_err": bwd_errs["flash_attention_bwd"],
        "max_abs_err_f32": bwd_errs["flash_attention_bwd/f32"],
        "ms": bwd_t["ms"], "plain_ms": bwd_t["plain_ms"], "bound_ms": bwd_t["bound_ms"],
        "bound_by": bwd_t["bound_by"], "library_ms": bwd_t["library_ms"],
        "bound_share": bwd_t["bound_share"], "pass_ms": bwd_t["pass_ms"],
        "shape": f"q/o/do [{LM_TRAIN_BATCH},{LM_TRAIN_SEQ},32,128] bf16, k/v "
                 f"[{LM_TRAIN_BATCH},{LM_TRAIN_SEQ},2,128], causal (one glm4-9b training layer)",
        "forward_at_this_shape_ms": bwd_t["fwd_train_ms"],
        "forward_with_statistics_ms": bwd_t["fwd_train_stats_ms"]})
    kernels.append({
        "name": "rwkv6_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        "replaces": "src/repro/models/rwkv6.py:72",
        "launches": lm_v[0]["launches"]["rwkv6_scan_bwd"],
        "max_abs_err": sb_errs["rwkv6_scan_bwd"], "max_abs_err_f32": sb_errs["rwkv6_scan_bwd/f32"],
        "ms": sb_t["ms"], "plain_ms": sb_t["plain_ms"], "bound_ms": sb_t["bound_ms"],
        "bound_by": sb_t["bound_by"], "library_ms": None, "bound_share": sb_t["bound_share"],
        "pass_ms": sb_t["pass_ms"], "blocks_per_sm": sb_t["blocks_per_sm"],
        "library": sb_t["library"], "toolkit": sb_t["toolkit"], "ptxas": sb_t["ptxas"],
        "checks": sb_t["checks"],
        "forward_at_this_shape_ms": sb_t["fwd_ms"],
        "shape": f"r/k/v and dr/dk/dv [{LM_TRAIN_BATCH},{LM_TRAIN_SEQ},32,64] bf16, logw/do/dlogw "
                 "f32, C=64, on the forward's saved chunk states (one rwkv6-1.6b training "
                 "layer)"})
    kernels.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/models/ssm.py:80",
        "launches": hymba["launches"]["selective_scan"],
        "max_abs_err": ss_errs["selective_scan"], "max_abs_err_f32": ss_errs["selective_scan/f32"],
        "ms": ss_t["ms"], "plain_ms": ss_t["plain_ms"], "bound_ms": ss_t["bound_ms"],
        "bound_by": ss_t["bound_by"], "library_ms": None, "bound_share": ss_t["bound_share"],
        "sfu_floor_ms": ss_t["sfu_floor_ms"], "ms_readings": ss_t["ms_readings"],
        "training_launches": {run["phase"]: run["launches"]["selective_scan"] for run in lm_y},
        "training_shape": {k: ss_t["training"][k] for k in (
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "bound_share", "sfu_floor_ms",
            "cold_sets")},
        "shape": f"u [{LM_BATCH},{LM_PROMPT},{HYMBA_DI}] bf16, dt [{LM_BATCH},{LM_PROMPT},"
                 f"{HYMBA_DI}] f32, B/C [{LM_BATCH},{LM_PROMPT},{HYMBA_S}] f32, nonzero state "
                 "(one hymba-1.5b prefill layer)"})
    kernels.append({
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:80",
        "launches": lm_y[0]["launches"]["selective_scan_bwd"],
        "max_abs_err": max(ssb_errs["bf16"].values()),
        "max_abs_err_f32": max(ssb_errs["f32"].values()),
        "errors_by_gradient": ssb_errs,
        "ms": ssb_t["ms"], "plain_ms": ssb_t["plain_ms"], "bound_ms": ssb_t["bound_ms"],
        "bound_by": ssb_t["bound_by"], "library_ms": None, "bound_share": ssb_t["bound_share"],
        "sfu_floor_ms": ssb_t["sfu_floor_ms"], "ms_readings": ssb_t["ms_readings"],
        "kernel_ms": ssb_t["kernel_ms"], "smem_bytes": ssb_t["smem_bytes"],
        "ptxas": ssb_t["ptxas"], "graph_ms": ssb_t["graph_ms"],
        "graph_bound_share": ssb_t["graph_bound_share"], "grid": ssb_t["grid"],
        "blocks_per_sm": ssb_t["blocks_per_sm"],
        "shape": f"u/du [{LM_TRAIN_BATCH},{LM_TRAIN_SEQ},{HYMBA_DI}] bf16, dt/dy/ddt f32, "
                 f"B/C [{LM_TRAIN_BATCH},{LM_TRAIN_SEQ},{HYMBA_S}] f32, on the forward's chunk "
                 "states, no final-state gradient (one hymba-1.5b training layer)"})
    for name, replaces in (("moe_gather", 92), ("moe_combine", 99), ("moe_gate_grad", 98)):
        t = moe_t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
            "replaces": f"src/repro/models/moe.py:{replaces}",
            "launches": lm_w[0]["launches"][name],
            "max_abs_err": moe_errs[name.removeprefix("moe_")],
            "max_abs_err_f32": moe_errs[name.removeprefix("moe_") + "/f32"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "bound_share": t["bound_share"], "bytes": t["bytes"],
            "serving_launches": granite["launches"][name],
            **{k: t[k] for k in ("graph_ms", "library_graph_ms", "graph_bound_share",
                                 "cold_sets", "prefill_shape", "decode_shape", "scaled_ms",
                                 "scaled_graph_ms", "scaled_bound_ms", "plan",
                                 "scaled_plan", "positions_scan")
               if k in t},
            "shape": f"S {MOE_TRAIN_TOKENS}, k 8, E 32, C 640, D 1024, bf16 (one granite-moe "
                     "training layer's microbatch)"})
    by_name = {k["name"]: k for k in kernels}
    # The flash forward's launches on each served arch, and its times at the
    # windowed serving shapes (gemma3's local layers, hymba's layers).
    by_name["flash_attention"]["serving_launches"] = {
        run["arch"]: run["launches"]["flash_attention"] for run in served}
    by_name["flash_attention"]["windowed"] = {
        arch: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "max_abs_err", "bound_share", "shape")}
        for arch, t in win_t.items()}
    by_name["flash_attention"]["training_launches"] = lm_tree["launches"]["flash_attention"]
    by_name["flash_attention"]["statistics_on_ms"] = lm_t["flash_attention"]["stats_ms"]
    by_name["mtgc_update_flat"]["training_launches"] = {
        "tree": lm_tree["launches"]["mtgc_update_flat"],
        "flat": lm_flat["launches"]["mtgc_update_flat"],
        **{r["phase"]: r["launches"]["mtgc_update_flat"] for r in (lm_j, lm_k, lm_l)}}
    by_name["int8_roundtrip"]["training_launches"] = {"j": lm_j["launches"]["int8_roundtrip"]}
    by_name["topk_mask"]["training_launches"] = {"l": lm_l["launches"]["topk_mask"]}
    by_name["topk_mask"]["training_threshold"] = lm_l["threshold"]
    by_name["topk_mask"]["training_event_timed"] = {
        k: v for k, v in lm_l["topk_timing"].items() if k != "blocks"}
    by_name["flash_attention"]["training_launches"] = {
        "h": lm_tree["launches"]["flash_attention"]}
    for name, k in by_name.items():
        # Phase (m) and (n)'s launches: the sum over (m)'s runs; (n)'s two
        # faulty rounds; (o)'s runs; (p) and (q)'s timed window.
        k.setdefault("training_launches", {})
        k["training_launches"]["m"] = hfl_m["launches"].get(name, 0)
        k["training_launches"]["n"] = lm_n["launches"].get(name, 0)
        for run, counts in hfl_o["launches"].items():
            k["training_launches"][run] = counts.get(name, 0)
        k["training_launches"]["p"] = lm_p["launches"].get(name, 0)
        k["training_launches"]["q"] = lm_q["launches"].get(name, 0)
        # Phase (r)'s checked and timed runs, (s)'s timed run, (t)'s
        # autosaving fit.
        for run, counts in hfl_r["launches"].items():
            k["training_launches"][run] = counts.get(name, 0)
        k["training_launches"]["s"] = lm_s["launches"].get(name, 0)
        k["training_launches"]["t"] = hfl_t["launches"].get(name, 0)
        # Phase (ls)'s runs of the fused step.
        for run, counts in surface["launches"].items():
            k["training_launches"][run] = counts.get(name, 0)
        # Phase (u)'s timed runs: the multilevel backend runs no kernel.
        for run, counts in hfl_u["launches"].items():
            k["training_launches"][run] = counts[name]
        for run in lm_v + lm_w + lm_y + lm_z:
            k["training_launches"][run["phase"]] = run["launches"].get(name, 0)
        # (mesh)'s rounds, rank by rank; (mx)'s loss and backward.
        for tag, run in mesh_runs.items():
            k["training_launches"][tag] = [r["launches"].get(name, 0) for r in run["ranks"]]
        k["training_launches"]["mx"] = mx["launches"].get(name, 0)
        k["serving_launches_mx"] = mx["serve"]["launches"].get(name, 0)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serving": served}))
    print(json.dumps({"training": [lm_tree, lm_flat]}))
    for run in (lm_j, lm_k, lm_l, lm_n):
        print(json.dumps({f"training_{run['phase']}": run}))
    print(json.dumps({"faults_m": hfl_m}))
    print(json.dumps({"async_o": hfl_o}))
    for run in (lm_p, lm_q, lm_s):
        print(json.dumps({f"training_{run['phase']}": run}))
    print(json.dumps({"population_r": hfl_r}))
    print(json.dumps({"checkpoint_t": hfl_t}))
    print(json.dumps({"multilevel_u": hfl_u}))
    for run in lm_v:
        print(json.dumps({f"training_{run['phase']}": run}))
    print(json.dumps({"training_v3": lm_v3}))
    for run in lm_w:
        print(json.dumps({f"training_{run['phase']}": run}))
    print(json.dumps({"training_w3": lm_w3}))
    for run in lm_y:
        print(json.dumps({f"training_{run['phase']}": run}))
    print(json.dumps({"training_y3": lm_y3}))
    for run in lm_z:
        print(json.dumps({f"training_{run['phase']}": run}))
    print(json.dumps({"training_z3": {"rounds": lm_z3, "models": av_z3}}))
    print(json.dumps({"surface_ls": surface}))
    print(json.dumps({"mesh": mesh_runs}))
    print(json.dumps({"mixtral_mx": {k: v for k, v in mx.items() if k != "serve"},
                      "serving_mx": mx["serve"]}))
    print(json.dumps({"audit": audit_out}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
