#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vattention_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (A-H and the layer's four elementwise
kernels) from the seven sources of ``vattention_tpu_torch/csrc`` (one
nvcc per source, in parallel) and
prints ptxas's registers and spills of kernels A, B, C, E, F, G and H,
with the shared memory per block of the bf16 prefill body's instances and
of kernel C, for each K/V storage type, and the registers the bf16
prefill body's roles keep after setmaxnreg (and any ptxas note on wgmma
or setmaxnreg), then
runs its phases; any failure raises and the script exits non-zero without
printing a result.  Every engine serves with the port's defaults: async
execution (samples read up to two steps late, the next step's tokens fed
on the device) and each step signature captured once as a CUDA graph and
replayed after; the launch counts count the kernels a replay runs.  Kernel A rotates Q and K and appends K/V in one launch
per layer on the serving path (``rope_kv_append``); ``kv_append`` is the
same kernel with the rotation off, held and timed in (a) as before.

(a) Kernels at the main paths' shapes (Yi-6B-200K geometry, bf16, the
    2048-token blocks the allocator gives fa_vattn_2mb; for the paged
    prefill kernel E, blocks of 16 and 256 tokens drawn as a seeded
    permutation of the pool, every table entry past a run's last valid
    block set to 2**30): each kernel is held against its plain PyTorch
    version on the same inputs and timed beside that version, a one-call
    library yardstick and its roofline bound.  E is also held against
    kernel B on the same rows (the same body: expected bit for bit), and
    kernel C is timed over 16-token blocks as the paged engine calls it.
    Kernel F (POD) runs B's chunk 512 at kv_len 4096 (and then B's
    multi-run case) with C's batch of 8 slots in one launch; it is held
    against its plain version with B's and C's tolerances and against B
    and C on the same inputs (the same bodies: expected bit for bit), and
    timed beside B then C launched serially in one loop (no single
    PyTorch call computes both outputs, so F has no library time; the two
    SDPA calls' sum is logged), and each of its roles alone (the other
    role's blocks given no work) beside B or C alone.  The timer's mode
    (``microbenchmarks/timing.py``, ``VATTN_TIMER``) is logged first.
    Kernel A is also timed against ``index_copy_`` in 5 passes in turns,
    and the wrappers of A, B, C and F (with ``index_copy_`` and C's SDPA
    call) for their host microseconds per call (200 enqueues, no sync).
    The shared prefill body's edge cases
    (``microbenchmarks/prefill_edges.py``, at Yi geometry: kv_len 1-4133,
    q_start 40, 56 and 60 mod 64, the empty run, E and H over 16-token
    blocks with poisoned tails, G over unaligned extents) are held against
    the plain versions and E = B, F = B and C, G = B, H = E bit for bit.
    The decode body's edge cases (``microbenchmarks/decode_edges.py``:
    depths 1-257 at C's tile and split edges and 4133, idle slots, shallow
    slots in tables 32768 positions deep, at sub 256 and 16 and G 1, 2, 4
    and 8) are held against C's plain version; idle slots must be exactly
    zero.  Then the prefill body at depth: G and H (16-token blocks) at chunk 2048 at
    kv_len 32768, each held against its plain version and timed beside
    one SDPA call on the same gathered K/V and its bound (logged only).
    Tolerances: kv_append and arena_relocate bit for bit; prefill and
    decode attention within atol = rtol = 2e-2 in bf16 (one bf16 rounding
    of outputs of magnitude ~1, summed in another order) and, for each
    output row (a query token or decode slot), a max error within 2^-6 of
    that row's largest output (deep outputs are small, so 2e-2 alone
    would let a wrong kernel through).
(a e4m3), (a int8) The same on 1-byte arenas (the seeded arena quantized
    as kernel A writes it, int8 in steps of 0.04 folded into sm_scale, bf16
    queries): A bit for bit against its plain version on the
    quantization's edges (the flush cutoff and its neighbours, 448 and
    past it, int8 half steps); B, C, E, F, G, H with (a)'s tolerances and
    F = B then C, G = B, H = E bit for bit; the edge cases; every finite
    e4m3 pattern (every int8 value) widened exactly by every body (zero
    queries at kv_len 1: each output row is V's row); D on 1-byte rows;
    each timed beside its plain version, its bound at one byte per K/V
    element and SDPA over K/V widened to bf16 once, outside the timed
    call (so reading twice the bytes); A has no library yardstick.
(a rope) Kernel A with the rotation at (a)'s step of 520 tokens (positions
    to 199999, rows of -1): Yi-6B's heads with bf16 into bf16, e4m3 and
    int8 arenas (V carrying the quantization's edges) and f32 into f32,
    and Mistral-7B's heads in bf16; q and the arena bit for bit against
    ``rope_kv_append_plain``; each timed beside its plain version and the
    eager sequence it replaces (the rope with its per-call inv_freq copy,
    the K and V copies, then ``kv_append``), with its bytes bound (qkv read
    once, q written once, each valid token's K/V written once) and host
    microseconds per call of both; no single PyTorch call computes it, so
    its library time is null.
(a norm) The layer's elementwise kernels (``ops/norm_act.py``): add_rms_norm
    and silu_and_mul at Yi-6B's, Mistral-7B's and Qwen-14B's widths,
    add_layer_norm (x + (o + mlp)) and gelu_new at Falcon-7B's, at T = 1,
    8, 520 and 2048 rows in bf16 and float32: the residual output bit for
    bit against the plain add, the outputs within
    ``timing.check_elementwise`` (1e-6 of the output's scale; bf16 also
    one ulp of each value); each timed beside its plain version, one
    library call (``F.rms_norm`` after the add, ``F.layer_norm`` after the
    adds, ``F.silu(g) * u``, ``F.gelu(approximate="tanh")``) and its bytes
    bound.  At Qwen-14B's heads (40 q, 40 kv), kernel A with a qkv bias at
    the same T, q and the arena bit for bit against its plain version.
    Before the timed rows, add_rms_norm (with and without r) at every
    hidden width of the registry (``bench_norm_act.HIDDEN_WIDTHS``), and
    silu_and_mul and gelu_new at every MLP width (``MLP_WIDTHS``), at T =
    1, 2, 3, 8, 16, 127, 520 and 2048 in bf16 and float32, held the same
    way (not timed).
(b) f32 parity: tiny-llama-debug, float32, sarathi chunk 128 on the
    two-prompt workload of tests/test_e2e.py, through fa_vattn, then
    (b') fa_paged_16 and (b'') fa_pod (whose mixed step must run through
    kernel F); the engine's greedy tokens must equal a dense
    full-recompute reference's.  (b sync) fa_vattn again with
    ``enable_async_execution=False``: the synchronous engine's tokens
    against the same reference, its launches equal to (b)'s.  (b8) The
    same with ``kv_quant`` fp8 and int8 on the three backends, the
    reference's K and V taken through the arena's round trip (quantized,
    widened, times the int8 step); E's and F's launches on 1-byte arenas
    are read here.
(c) Serving at full width: yi-6b-200k (32 layers, bf16, random weights
    from a seed) through LLMEngine with fa_vattn_2mb, sarathi chunk 512,
    max_model_len 8192, max_batch_size 8: 8 requests of seeded prompt
    lengths in [1024, 4096] and 32 greedy tokens each, the launch counts
    zeroed just before and read just after.  rope_kv_append, prefill and
    decode attention, add_rms_norm and silu_and_mul must have launched, the
    paged prefill, kv_append (A without the rotation) and falcon's
    add_layer_norm and gelu_new not (so in every serving phase: each
    model family's elementwise kernels launch, the other's do not);
    arena_relocate launches once per relocation the allocator plans, and
    at these sizes it plans none (a request spans at most 4 blocks and
    may hold 8 extents), so phase (a) is what holds it.  Then 2 short
    prompts whose first token is held against a dense float32 reference
    on the same bf16 weights.  Then (h c), below.  Last, 4 more requests
    run under
    torch.profiler (``microbenchmarks/serving_profile.py``), lines "(p)":
    device time by family (kernel A under every name it has had), each
    port kernel's time and launches, the wall and idle share, kernel
    launches, host launch calls (cudaLaunchKernel, cudaGraphLaunch),
    cudaStreamSynchronize calls and host milliseconds outside waits per
    step, and the device time of the rope and KV append.
(h c), (h d), (h e) The captured step (``microbenchmarks/captured_step.py``)
    on the engines of (c), (d) and (e) after they served: two requests
    (700 and 1100 prompt tokens) meet a prompt's, mixed and decode
    signatures, and the first replay of each is held bit for bit against
    the eager ``_step`` on the same staged inputs (the samples, the arena
    rows the step writes, the token buffer); the decode-only and the mixed
    signature (fused through F on fa_pod) must be among them.  The
    engine's graphs are listed with their capture times and the port
    kernels' launches per replay.  Then a prompt's, a mixed and a decode
    step, their signatures captured first, each run as a whole async
    engine step under ``torch.cuda.set_sync_debug_mode("error")``: the run
    fails on any stream synchronization from ``_prepare_inputs`` through
    the replay to the next dispatch, or if kernel A does not launch once
    per layer and step.  Every graph must launch, per replay, A once a
    layer, add_rms_norm twice a layer and once for the final norm,
    silu_and_mul once a layer, and no falcon kernel.  Then the op
    profiler's rows (``profile_op_level``: A′ as the KV-save row, B or E
    prefill, C decode, the projections, the fused norm and activation,
    head and sampler, by CUDA events).
(h step) After (c): the captured decode step's device milliseconds per
    replay (``scripts/profile_decode_step``: yi-6b-200k-l16, zero weights,
    fa_vattn_256kb, batch 8 at ctx 1024, 30 replays between CUDA events),
    beside 30 whole engine steps and the host's input staging.
(c8) (c)'s 8 requests and 2 short prompts with ``kv_quant`` fp8, then
    int8 (fresh engines, no profile): A, B and C must launch; the tokens
    per 2 MB page, tok/s, and how many greedy tokens equal (c)'s
    (information only) are printed; first tokens within (c)'s 0.25 of a
    quantizing dense reference in the model's bf16 arithmetic (attention
    in float32 over K/V taken through the arena's round trip).  A float32
    reference quantizes K/V that differ from the engine's by bf16
    rounding, which e4m3's 3-bit mantissa turns into whole steps on the
    values near a rounding boundary; its gap is printed beside.
(d) The same through a fresh engine with fa_paged_256 (the (c) engine
    freed first): rope_kv_append, paged prefill and decode attention must
    have launched, prefill_attention and arena_relocate not; the tokens
    are compared with (c)'s and the short prompts held as in (c).
(e) The same through a fresh engine with fa_pod (2 MB pages, the (c)
    arena; the (d) engine freed first): kernel F, A, B and C must have
    launched, E and D not, and since the schedule is (c)'s, F's launches
    plus B's must equal B's in (c), and F's plus C's C's in (c); the tokens
    are compared with (c)'s and the short prompts held as in (c).
    Kernels G and H must not launch in (c), (d) or (e): no serving path
    runs them.
(f) The kernel-level A/B entry points (``vattention_tpu_torch/
    microbenchmarks``) at Yi-6B's attention geometry in bf16, G's and H's
    launch counts zeroed just before and read just after: kernel_sweep at
    ctx 1024-32768 with blocks of 256 (the JAX default) and then 16 tokens
    (vLLM's default block), bench_pagesize, bench_pod and probe_pod_depth
    at depths 16384, 32768, 65536 and 131072 and with 3 prefill runs at
    16384.  The sweep and the probe run with ``--check``: every G, H and C
    output they make (G and H at chunk 2048 to depth 32768, G at chunk 512
    to depth 131072) is held against its plain version on the same inputs
    with (a)'s tolerances, the plain prefill run 256 query tokens at a
    time.  Besides, G must equal H in the sweep and each probe's F must
    equal G then C, bit for bit.  Then kernel_sweep --check on an e4m3
    arena (ctx 1024-32768, batch 16: C's time against the 1-byte bytes
    bound) and on an int8 arena (ctx 1024, 4096); G's and H's launches
    on 1-byte arenas are read there.

(a w), (a w e4m3), (a w int8) The sliding window at mistral-7b's
    attention geometry (Hq 32, Hkv 8, D 128, bf16 queries, window 4096) on
    each arena: B at chunk 512 to kv_len 16384 and C at B = 8 to depth
    16384 held against their windowed plain versions with (a)'s
    tolerances; E (256-token blocks), G (8 extents), H and F on the same
    rows, expected to equal B, B, E and B then C bit for bit; B and C
    under a window past every depth equal to their unwindowed bits; the
    edge cases of both bodies under windows 1, 63, 64, 65 and 4096.  Each
    timed beside its plain version, its bound over the attended pairs
    (4*Hq*D FLOPs each) and rows (2*Hkv*D elements each) and one SDPA call
    on the gathered K/V (a boolean window mask for prefill, the last 4096
    rows for decode; F none); B's and C's windowed times are logged beside
    their unwindowed times at 4096 and 16384.
(b w) (b)'s parity through tiny-mistral-debug (tiny-llama-debug with a
    window of 96, which the 200-token prompt passes) on fa_vattn,
    fa_paged_16 and fa_pod, f32, then on e4m3 and int8 arenas, against a
    windowed dense reference; the windowed 1-byte instances' launches are
    read here.
(g) The slice's path at full width: mistral-7b (32 layers, its published
    widths and window 4096, bf16, random weights from seed 0) through
    LLMEngine with fa_vattn_2mb, sarathi chunk 512, max_model_len 16384:
    8 requests of seeded prompt lengths in [5000, 12000] (all past the
    window) and 32 greedy tokens, the launch counts zeroed just before and
    read just after (A, B and C must launch; E, F, G and H not).  Each
    request's first token is held within 0.25 logits of a windowed dense
    reference in the model's bf16 arithmetic (attention in float32 by
    blocks of 1024 queries), and the largest |windowed - unwindowed|
    reference logit must exceed that gap; processed tok/s, the wall and
    (p g), a profile of 2 requests of 6144 tokens, are printed.
(g') The same requests through fa_paged_256 (E, A, C must launch) and
    fa_pod (F, A, B, C; F's launches plus B's must equal B's in (g), and
    F's plus C's C's), each held to (g)'s windowed reference; how many
    tokens agree with (g)'s is printed.
(q) qwen-14b (40 q and 40 kv heads of 128, hidden 5120, MLP 13696, vocab
    152064) cut to 4 layers (a config.json in a temporary directory),
    bf16, seed-0 dummy weights with the qkv bias drawn from N(0, 0.5^2),
    on fa_vattn_2mb, chunk 512, batch 4: 4 requests of 1024-3072 prompt
    and 16 greedy tokens, the bias added inside kernel A; A, B, C,
    add_rms_norm and silu_and_mul launch, falcon's kernels and the other
    paths' do not; each first token within 0.25 logits of a dense float32
    reference, which, without the bias, moves some logit by more than
    that.
(f w) kernel_sweep --window 4096 --check at Hkv 8 on the bf16, e4m3 and
    int8 arenas (ctx 4096, 16384; bf16 also 32768); G's and H's windowed
    launches are read there.
(a falcon), (a falcon e4m3), (a falcon int8) (a)'s phase at Falcon-7B's
    attention geometry (71 query heads on 1 kv head, head dim 64 padded to
    the arena's 128, sm_scale of 64, the arena's 8192-token blocks): A, B,
    C (depths 0..2048), E, F, G, H and D each held and timed as in (a),
    the prefill and decode bodies' edge cases at G = 71 (71 q heads on one
    kv head; the decode edges at G 1, 2, 4, 8 and 71), and with the bf16
    arena G and H at chunk 2048 at kv_len 32768 and C at B = 4 at depths
    16384-32768 beside SDPA.  Each row adds ``bound_real_ms``, the bound
    at the real head dim 64 (half the padded bytes and operations); the
    JSON rows are ``<name>[falcon]``, ``<name>[falcon e4m3]``, ...
(b falcon) (b)'s exact greedy tokens through a tiny f32 falcon (a
    config.json in a temporary directory: 2 layers, 71 query heads, 1 kv
    head, head dim 64, hidden 256) on fa_vattn, fa_paged_16 and fa_pod,
    then on e4m3 and int8 arenas, against a dense reference with
    falcon's own layer written in ``dense_logits`` (one LayerNorm,
    attention and a tanh-GELU MLP in parallel); the 1-byte falcon
    instances' launches are read here.
(k) falcon-7b at full width (32 layers, 71 query heads on 1 kv head,
    hidden 4544, vocab 65024, bf16, seed-0 weights) through LLMEngine on
    fa_vattn_2mb, sarathi chunk 512, max_model_len 2048, batch 8: 8
    requests of 512-1900 prompt tokens and 32 greedy tokens (A, B, C,
    add_layer_norm and gelu_new must launch; E, F, G, H and the llama
    family's norm kernels not), then (k paged) fa_paged_256 and (k pod)
    fa_pod on the same requests (F's launches plus B's equal B's in (k),
    and F's plus C's C's); each request's first token within 0.25 logits
    of a dense reference in the model's bf16 arithmetic; tok/s and the
    graphs captured are printed.
(k long) falcon-7b-32k-l8 (falcon's widths, 8 layers) written as a
    safetensors checkpoint in falcon's ``transformer.h.*`` layout (4.5 GB,
    a temporary directory, deleted after), loaded back bit for bit (load
    GB/s printed), then served from that directory on fa_vattn_2mb: 4
    requests of 16K-30K prompt tokens, 16 greedy tokens, first tokens
    held as in (k).
(f falcon) kernel_sweep --check at falcon's heads on bf16, e4m3 and int8
    arenas (ctx 1024, 4096); the falcon G and H rows' launches.
(s) The serving entry points at full width
    (``microbenchmarks/server_phase.py``): yi-6b-200k-l16 (yi-6b's widths,
    16 layers, bf16, random weights from seed 0) written as a local HF
    safetensors checkpoint (one file per layer plus one for the embeddings
    and head, ~6.5 GB, with a word-level tokenizer whose token i is the
    word t<i>) into a temporary directory, loaded back through
    ``load_safetensors`` and held bit for bit (write and load seconds and
    GB/s logged); then the port's OpenAI server on 127.0.0.1 at an
    ephemeral port over AsyncLLMEngine (fa_vattn_2mb, the default native
    allocator, sarathi chunk 512, batch 8, max_model_len 8192) answers 8
    concurrent /v1/completions of seeded 1024-4096 token-id prompts (2
    streamed, one with logprobs) and one /v1/chat/completions from one
    aiohttp client, 32 greedy tokens each, the launch counts zeroed just
    before and read just after (A, B and C must launch; E, F, G, H and A
    without the rotation not; D once per planned relocation).  Each
    completion's first token is held within 0.25 logits of a dense
    reference in the model's bf16 arithmetic.  The same 8 prompts in
    order through a synchronous-API LLMEngine on the checkpoint with
    ``use_native_allocator=True`` and then False must give identical
    tokens and extent tables after every step.  Requests/s, processed
    tok/s, the streamed requests' TTFT p50 and max, and the checkpoint's
    load GB/s are printed, each beside the card's name and power limit.
(r) The benchmark package (``vattention_tpu_torch/benchmark``, driven
    through ``microbenchmarks/benchmark_phase.py``) on bench.py's headline
    workload: yi-6b-200k-l16 (bf16, seed-0 dummy weights), sarathi chunk
    2048, batch 8, max_model_len 32896, gpu_memory_utilization 0.93, a
    static trace of 8 requests of 32444 prompt + 324 decode tokens, through
    ``BenchmarkRunner`` with its warm-up on fa_vattn_2mb, then (r paged)
    fa_paged_256 and (r pod) fa_pod; the launch counts zeroed after the
    warm-up and read after the timed run.  Each run completes 8 of 8 with
    no preemption and the trace's processed and decode token totals,
    captures no CUDA graph in the timed run, launches its backend's kernels
    (A, B, C; A, E, C; A, F, B, C) and not the others', and D once per
    relocation plan; the three backends' tokens are equal, F + B and F + C
    on fa_pod equal B and C on fa_vattn_2mb, and request 0's first token
    is within 0.25 logits of a dense reference in the model's bf16
    arithmetic at 32444 tokens.  Processed tok/s (processed tokens over
    the makespan, bench.py's metric), the wall, the steps with their
    prefill and decode seconds, and vs_baseline (fa_vattn_2mb over
    fa_paged_256) are printed beside the card's name and power limit.
(r dyn) Arrivals over time under memory pressure: 48 requests of the
    lengths of data/processed_traces/arxiv_synthetic_v2.csv (its first 48
    rows), Poisson arrivals at 2 requests/s, through ``BenchmarkRunner`` on
    fa_vattn_64kb (64-token blocks, 8 extents per request), batch 16,
    chunk 512, max_model_len 32768, the arena sized to 2 GiB (65536
    tokens): every request completes, no graph is captured in the timed
    run, A, B and C launch and E, F, G, H do not, D launches once per
    relocation plan; request e2e time per token p50/p90/p99, TTFT p50/p99,
    TBT p99, scheduling delay p99, the moves, D's launches and the
    fragmentation are printed.  Then D's row at this geometry (JSON
    ``arena_relocate[r dyn]``): the allocator's plan of
    ``bench_relocate``'s rdyn geometry on the engine's arena, byte for
    byte against the plain version, timed beside it, one ``copy_`` per
    move, a ``copy_`` of its bytes and its bound, as (a)'s D rows.
(r rep) ``BenchmarkRunnerLauncher``: 2 replicas of yi-6b-200k-l16 on the
    card (each arena from half of gpu_memory_utilization 0.9), 8 static
    requests of 2048 + 32 tokens on fa_vattn_2mb: 4 completed per replica,
    the merged totals the sums, the device memory back after cleanup.
    (r cap) ``CapacitySearch`` over 16 requests of the trace's lengths,
    qps 1 to 4, one bisection step, scheduling delay p99 SLO 0.3 s: the
    probe history is printed.  (r yaml) ``main.run_from_flat`` on a YAML file
    that cuts default.yml to 2 requests of 1024 + 16 tokens.

(a tp2), (a tp4) (a)'s phase at the heads of one tensor-parallel rank of
    Yi-6B (16 query heads on 2 kv heads, and 8 on 1), without (a)'s host
    times and long-context extras: A, B, C, E, F, G, H and D each held
    against its plain version and timed beside it, its bound and its
    library call; (a rope) holds kernel A with the rotation at those heads
    too.  The JSON rows are ``<name>[tp2]`` and ``<name>[tp4]``, with the
    launches of the (t yi) ranks that ran those heads, summed.
(t b) Tensor and pipeline parallelism on the card, ranks as processes
    sharing it over gloo (NCCL refuses two ranks on one device), each with
    gpu_memory_utilization 0.9 / ranks: tiny-llama-debug in float32 on
    fa_vattn, fa_paged_256 and fa_pod at tp2, pp2 and tp2 pp2 (three
    engines per layout, one process group, ``python -m
    vattention_tpu_torch.parallel.multihost`` per rank); every rank's
    greedy tokens must equal the one-rank engine's exactly, no step may be
    captured (gloo's collectives run on the host) and each backend's
    kernels must launch.  Then ``LLMEngine(tensor_parallel_size=2)`` from
    this process, its second rank a child, on fa_vattn: the same tokens.
(t yi) yi-6b-200k-l16 (Yi-6B's widths, 32 q / 4 kv heads, head dim 128, cut
    to 16 of its 32 layers to keep the script's time; bf16, dummy weights
    from seed 0) with (c)'s 8 requests on
    fa_vattn_2mb at tp2, pp2, tp2 pp2 and tp4, the ranks processes on the
    card: every rank serves all 8 x 32 tokens, the same on every rank; A,
    B and C launch on every rank and E, F, G, H and A without the rotation
    on none, D once per relocation plan; request s0's first token within
    0.25 logits of a dense float32 reference's top.  Per layout: processed
    tok/s beside the card's name and power limit, each rank's launches,
    the backend and the graphs captured (0).  The NCCL path (one rank per
    GPU, each step a CUDA graph with its collectives) needs a card per
    rank and is not run here.
(l) The long-context grid's north-star pairs on the card
    (``vattention_tpu_torch/scripts/longctx_grid``'s ``pairs`` group at
    64K and 128K; its 32K pair is (r)'s workload): first B over the last
    128 queries of one run at kv_len 131,072, E on the same rows through
    256-token block tables (bit for bit equal to B) and C over 2 slots at
    depth 131,072, each held against its plain version with (a)'s
    tolerances and timed beside it, one SDPA call and its bound (the JSON
    rows ``<name>[128K]``).  Then yi-6b-200k-l16 (bf16, seed-0 dummy
    weights) on fa_vattn_2mb and fa_paged_256 at P:D 100: 6 requests of
    64,888 + 648 tokens at batch 4 and 4 of 129,775 + 1,297 at batch 2,
    chunk 2048, max_model_len ctx + 128, memory utilization 0.93, each
    cell's engine and trace built from the grid's flags and served through
    ``BenchmarkRunner`` with its warm-up, the launch counts zeroed after
    the warm-up and read after the timed run: every request completes
    with none preempted and the trace's totals, no graph is captured in
    the timed run, A, B and C launch on fa_vattn_2mb and A, E and C on
    fa_paged_256 (F, G, H and A without the rotation on neither), the
    first generated token of every request is equal across each pair, and
    at 64K request 0's first token is within 0.25 logits of a dense
    reference in the model's bf16 arithmetic (at 128K the cross-backend
    check alone holds it).  ``collect_longctx_grid`` reads the cells'
    files: makespan, processed tok/s, vs_paged, preemptions, the stall
    audit's stall_s, with each cell's launches and peak device memory.
    Then ``scripts/profile_backend_step``'s ``drive`` at ctx 131,072,
    batch 2, bf16 K/V on both backends (prefill and steady decode between
    CUDA events), and ``microbenchmarks/bench_decode_kernel`` at depths
    65,536 (batch 4) and 131,072 (batch 2) over C's plan points 4:2 (the
    defaults), 1:2, 16:2 and 4:4, each point held against C's plain
    version before it is timed.

Kernels G (single-run arena prefill, rows from the extent table) and H
(single-run paged prefill) run only in (a), (a w), (f) and (f w).  In (a) each is held
against its plain version at B's shape (chunk 512 at kv_len 4096): G over
8 extents of 512 tokens at 2048-token block starts, and against B on the
same rows; H over a seeded permutation of 16- and 256-token blocks with
its tail poisoned to 2**30, and against E on one run (both expected bit for
bit).

Prints the phase results, then ``{"kernels": [...]}`` (A-H, then their
e4m3 and int8 instances, ``<name>[e4m3]``, then the windowed instances,
``<name>[w4096]`` and ``<name>[e4m3 w4096]``, with launches from (g) and
(g') for bf16 B, C, E, F, (b w) for the 1-byte ones and (f w) for G and
H, then the falcon instances ``<name>[falcon]`` with launches from (k),
(k paged), (k pod) and (f falcon), and ``<name>[falcon e4m3]`` and
``[falcon int8]`` from (b falcon) and (f falcon), each with
``bound_real_ms``; then ``rope_kv_append`` and its ``[e4m3]``,
``[int8]``, ``[f32]``, ``[mistral]`` and falcon instances with launches
from (c), (c8), (b), (g), (k) and (b falcon); the bf16 ``arena_relocate``
row's launches from (r dyn), the one serving run that relocates, and
``arena_relocate[r dyn]`` (D at that run's geometry) with the same; every
D row also gives ``copy_ms``, a ``copy_`` of its bytes;
``kv_append``, which serving no longer runs, shows 0; the ``[tp2]`` and
``[tp4]`` rows from (t yi); the ``[128K]`` rows of B, E and C with
launches from (l)'s fa_vattn_2mb, fa_paged_256 and all four cells; the
(a norm) rows ``<kernel>[<model> T<n>]`` with launches from (c), (g), (k)
and (q), their ``[... f32]`` rows from (b) and (b falcon)), the card's
name
and power limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

try:
    from vattention_tpu_torch.microbenchmarks.decode_edges import (
        EDGE_DEPTHS, EDGE_GROUPS, check_decode_edges, edge_depths)
    from vattention_tpu_torch.microbenchmarks.prefill_edges import (
        check_prefill_edges)
    from vattention_tpu_torch.microbenchmarks.captured_step import (
        check_replays, check_step_does_not_sync, graph_report)
    from vattention_tpu_torch.microbenchmarks.parallel_serving import (
        LAYOUTS as RANK_LAYOUTS)
    from vattention_tpu_torch.microbenchmarks.serving_profile import (
        profile_window, serve)
    from vattention_tpu_torch.microbenchmarks.timing import (
        ATTN_TOL, Timer, bound, check_attention, seeded)
    from vattention_tpu_torch.microbenchmarks.bench_relocate import (
        relocation_bytes, slice_copies, strict_relocation_plan)
except ImportError as e:  # chip_smoke.py without the port beside it
    sys.exit(f"chip_smoke: the port is not importable here ({e})")

PREFILL_TOL = DECODE_TOL = ATTN_TOL
MISTRAL = dict(HQ=32, HKV=8, D=128)   # mistral-7b's attention geometry
WINDOW = 4096                 # mistral-7b's sliding window
EDGE_WINDOWS = (1, 63, 64, 65, WINDOW)
LOGIT_GAP_TOL = 0.25          # engine token's logit vs the reference top
# a kernel phase's geometry: layers, heads, the arena's head dim D and the
# model's DR (Falcon-7B's 64, padded to 128), decode depths of the batch of
# 8, and the instance tag
YI = dict(L=32, HQ=32, HKV=4, D=128, DR=128,
          DEC=[0, 1, 17, 512, 1000, 2048, 3000, 4096], tag="")
FALCON = dict(L=32, HQ=71, HKV=1, D=128, DR=64,
              DEC=[0, 1, 17, 300, 512, 1000, 1500, 2048], tag="falcon")
# Yi-6B's heads on one rank of tp 2 and tp 4 (16 q on 2 kv heads, 8 on 1);
# "lean" drops the host-time and long-context extras of (a)
YI_TP = {tp: dict(YI, HQ=32 // tp, HKV=4 // tp, tag=f"tp{tp}", lean=True)
         for tp in (2, 4)}
INT8_STEP = 0.04              # KV_INT8_SCALE's default
# the 1-byte arenas: kv_quant name, instance tag
QUANT = {torch.float8_e4m3fn: ("fp8", "e4m3"), torch.int8: ("int8", "int8")}


def arena_setup(arena, geo=YI):
    """(name suffix, log label, sm_scale, int8 step) of phase (a) at
    ``geo`` on an arena of dtype ``arena``: sm_scale from the model's head
    dim, an int8 arena's step folded into it, as the backends fold it."""
    tag = "" if arena == torch.bfloat16 else QUANT[arena][1]
    step = INT8_STEP if arena == torch.int8 else None
    words = " ".join(w for w in (geo["tag"], tag) if w)
    return (f"[{words}]" if words else "", f"(a {words})" if words else "(a)",
            geo["DR"] ** -0.5 * (step or 1.0), step)


def log(*args):
    print(*args, flush=True)


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn``: ``n`` enqueues after a
    warm-up, no synchronisation inside the loop (the wrapper's checks, its
    ctypes call and the launch; not device time)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


# --------------------------------------------------------------------- #
# (a) kernels
# --------------------------------------------------------------------- #
def kernel_phase(dev, arena=torch.bfloat16, geo=YI):
    """Phase (a) at ``geo`` (Yi-6B's heads, or Falcon-7B's: instances
    named ``<kernel>[falcon]``) over an arena of dtype ``arena``: bf16 (the
    main path), or 1-byte e4m3 or int8 (instances named
    ``<kernel>[e4m3]``, ``<kernel>[falcon e4m3]``, ...), whose values are
    the seeded bf16 arena's quantized as kernel A writes them and whose
    library yardsticks read K/V widened to bf16 once, outside the timed
    call (twice the bytes the kernel reads).  The 1-byte runs skip the
    host-time and long-context extras, and the falcon runs the 5 passes
    and the widening check (Yi's kv heads hold every 1-byte value; one kv
    head of 128 lanes cannot)."""
    from vattention_tpu_torch.memory.allocator import VAttentionAllocator
    from vattention_tpu_torch.ops import (arena_copy, cache_append,
                                          flash_decode, flash_prefill,
                                          pod_fused)
    from vattention_tpu_torch.ops.utils import (quantize_kv, select_kv_tile,
                                                tile_rows_from_segments)

    L, HQ, HKV, D = geo["L"], geo["HQ"], geo["HKV"], geo["D"]
    dt = torch.bfloat16
    es = 2                                    # q, outputs, the model's K/V
    suffix, lbl, sm, step = arena_setup(arena, geo)
    main = arena == dt
    out_scale = step or 1.0   # an int8 arena's outputs count in its steps
    check = functools.partial(check_attention, scale=out_scale)
    probe = VAttentionAllocator()
    probe.init_kvcache(num_layers=L, num_kv_heads=HKV, head_size=D,
                       max_batch_size=8, max_context_length=8192,
                       dtype_bytes=es, page_size=2 * 2**20)
    bt = probe.block_tokens                   # 2048 for fa_vattn_2mb
    sub = select_kv_tile(bt, 256)
    R = 24 * bt
    n_sub = 8192 // sub                       # row tables of max_model_len 8192
    randn, _ = seeded(dev)
    cache = randn(L, 2, HKV, R + bt, D)
    if not main:
        cache = quantize_kv(cache, arena, step)
    kv_es = cache.element_size()              # the arena's K/V bytes
    timer = Timer(dev)
    log(f"{lbl} timer: {timer.mode}")
    results = []

    def table(extents_per_seq):
        S = 8
        seg_row = np.zeros((len(extents_per_seq), S), np.int32)
        seg_cum = np.zeros((len(extents_per_seq), S + 1), np.int32)
        for b, ext in enumerate(extents_per_seq):
            t = 0
            for j, (row, n) in enumerate(ext):
                seg_row[b, j], seg_cum[b, j] = row, t
                t += n
            seg_cum[b, len(ext):] = t
        return torch.from_numpy(
            tile_rows_from_segments(seg_row, seg_cum, sub, n_sub)).to(dev)

    # -- A: kv_append, 512 prefill rows (two extent runs) + 8 decode rows
    layer = 5
    T = 512 + 8
    rows = np.full(T, -1, np.int32)
    rows[:300] = np.arange(3 * bt + 1000, 3 * bt + 1300)
    rows[300:480] = np.arange(9 * bt, 9 * bt + 180)      # 480..511: padding
    rows[512:518] = [bt * i + 17 * i for i in (11, 12, 13, 14, 15, 16)]
    k, v = randn(T, HKV, D), randn(T, HKV, D)
    if not main:
        # the quantization's edges: the flush cutoff and its bf16
        # neighbours, e4m3's largest value and past it, int8 half steps
        s_ = step or 1.0
        edge = torch.tensor([15 * 2 ** -10, 1.8671875 * 2 ** -7,
                             1.8828125 * 2 ** -7, 448, 500, 1000, 0.5 * s_,
                             1.5 * s_, 126.5 * s_, 300 * s_], device=dev)
        edge = torch.cat([edge, -edge]).to(dt)
        k.view(-1)[:512:512 // edge.numel()][:edge.numel()] = edge
        v.view(-1)[1::997][:edge.numel()] = edge
    rows_d = torch.from_numpy(rows).to(dev)
    expect = cache.clone()
    cache_append.kv_append_plain(expect, k, v, rows_d, layer, step)
    got = cache.clone()
    cache_append.kv_append(got, k, v, rows_d, layer, kv_scale=step)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.uint8), expect.view(torch.uint8)):
        raise AssertionError(f"kv_append{suffix} differs from its plain "
                             "version")
    del expect
    valid = rows >= 0
    nvalid = int(valid.sum())
    rv = torch.from_numpy(rows[valid].astype(np.int64)).to(dev)
    kv_src = torch.stack([k[torch.from_numpy(valid).to(dev)],
                          v[torch.from_numpy(valid).to(dev)]]).transpose(1, 2)
    b_ms, b_by = bound(nvalid * 2 * HKV * D * (es + kv_es) + T * 4, 0)
    results.append(dict(
        name="kv_append" + suffix, route="cuda",
        source="vattention_tpu_torch/csrc/kv_append.cu",
        replaces="vattention_tpu/ops/cache_append.py:152,274",
        max_abs_err=0.0,
        ms=timer(lambda: cache_append.kv_append(got, k, v, rows_d, layer,
                                                kv_scale=step)),
        plain_ms=timer(lambda: cache_append.kv_append_plain(
            got, k, v, rows_d, layer, step)),
        # no one PyTorch call quantizes and scatters
        library_ms=(timer(lambda: got[layer].index_copy_(2, rv, kv_src))
                    if main else None),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"T={T} ({nvalid} valid) Hkv={HKV} D={D} bf16 -> "
              f"{cache.dtype}"))
    host = {}
    if main and geo is YI:
        passes = [(timer(lambda: cache_append.kv_append(got, k, v, rows_d,
                                                        layer)),
                   timer(lambda: got[layer].index_copy_(2, rv, kv_src)))
                  for _ in range(5)]
        log("(a) kv_append against index_copy_, 5 passes in turns: "
            + "; ".join(f"{a:.4f} / {b:.4f}" for a, b in passes) + " ms")
    if main and not geo.get("lean"):
        host = {"kv_append": host_us(lambda: cache_append.kv_append(
            got, k, v, rows_d, layer)),
                "index_copy_": host_us(lambda: got[layer].index_copy_(
                    2, rv, kv_src))}
    del got

    # -- B: prefill; case 1 = chunk 512 at kv_len 4096 over two extents
    pad = 128
    ext1 = [(2 * bt, bt), (6 * bt, 2 * bt)]
    q = randn(512, HQ, D)
    qt_run = torch.tensor([[0, i] for i in range(4)], dtype=torch.int32,
                          device=dev)
    qinfo = torch.tensor([[3584, 4096], [0, 0]], dtype=torch.int32,
                         device=dev)
    trows = table([ext1, []])
    args = (q, cache, qt_run, qinfo, trows, layer)
    kw = dict(sub=sub, pad_tile=pad, sm_scale=sm)
    got = flash_prefill.prefill_attention(*args, **kw)
    ref = flash_prefill.prefill_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel = check("prefill case 1", got, ref, PREFILL_TOL)
    checks = [f"chunk 512 at kv_len 4096: {err} (row worst {rel:.5f})"]
    # case 2: 3 runs + the empty padding run in one launch
    ext2 = [[(bt, 1024)], [(4 * bt, bt), (12 * bt, bt)], [(14 * bt, 64)], []]
    qinfo2 = torch.tensor([[0, 128], [2000, 2100], [0, 60], [0, 0]],
                          dtype=torch.int32, device=dev)
    qt_run2 = torch.tensor([[0, 0], [1, 0], [2, 0], [3, 0]],
                           dtype=torch.int32, device=dev)
    args2 = (q, cache, qt_run2, qinfo2, table(ext2), layer)
    got2 = flash_prefill.prefill_attention(*args2, **kw)
    ref2 = flash_prefill.prefill_attention_plain(*args2, **kw)
    torch.cuda.synchronize()
    if got2[384:].abs().max().item() != 0.0:
        raise AssertionError("prefill: the empty run's tile is not zero")
    for lo, n, depth in ((0, 128, 128), (128, 100, 2100), (256, 60, 60)):
        e, r = check(f"prefill case 2, run at {lo}",
                               got2[lo:lo + n], ref2[lo:lo + n], PREFILL_TOL)
        checks.append(f"run of {n} rows to depth {depth}: {e} "
                      f"(row worst {r:.5f})")
        err = max(err, e)
    log(f"{lbl} prefill_attention max abs err per case: "
        + "; ".join(checks))
    # yardstick: SDPA over the case-1 K/V gathered (and widened) once,
    # bottom-right causal
    pos = torch.arange(4096, device=dev)
    grow = trows[0].long()[pos // sub] + pos % sub
    kg = cache[layer, 0][:, grow][None].to(dt)   # [1, Hkv, 4096, D]
    vg = cache[layer, 1][:, grow][None].to(dt)
    qg = q.transpose(0, 1)[None]                 # [1, Hq, 512, D]
    mask = (3584 + torch.arange(512, device=dev))[:, None] >= pos[None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = int(mask.sum().item())
    b_ms, b_by = bound(2 * 512 * HQ * D * es + 4096 * 2 * HKV * D * kv_es,
                       4 * HQ * D * pairs)
    results.append(dict(
        name="prefill_attention" + suffix, route="cuda",
        source="vattention_tpu_torch/csrc/prefill_attention.cu",
        replaces="vattention_tpu/ops/flash_prefill.py:273",
        max_abs_err=err,
        ms=timer(lambda: flash_prefill.prefill_attention(*args, **kw)),
        plain_ms=timer(lambda: flash_prefill.prefill_attention_plain(
            *args, **kw), iters=3),
        library_ms=timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                      enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"chunk 512 at kv_len 4096, Hq={HQ} Hkv={HKV} D={D} bf16, "
              f"{cache.dtype} K/V"))
    del kg, vg

    # -- C: decode, B=8 at depths 0..4096 (falcon 0..2048)
    seqlens_l = geo["DEC"]
    deepest = max(seqlens_l)
    ext_d = [[], [(0, bt)], [(bt, bt)], [(2 * bt, bt)], [(3 * bt, bt)],
             [(4 * bt, bt)], [(5 * bt, bt), (15 * bt, bt)],
             [(7 * bt, 2 * bt)]]
    qd = randn(8, HQ, D)
    seqlens = torch.tensor(seqlens_l, dtype=torch.int32, device=dev)
    trows_d = table(ext_d)
    dargs = (qd, cache, trows_d, seqlens, layer)
    dkw = dict(sub=sub, sm_scale=sm)
    got = flash_decode.decode_attention(*dargs, **dkw)
    ref = flash_decode.decode_attention_plain(*dargs, **dkw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
        raise AssertionError("decode: the seqlen-0 slot is not zero")
    err, checks = 0.0, []
    for b, n in enumerate(seqlens_l):
        if n:
            e, r = check(f"decode slot {b} at depth {n}",
                                   got[b:b + 1], ref[b:b + 1], DECODE_TOL)
            checks.append(f"depth {n}: {e} (row worst {r:.5f})")
            err = max(err, e)
    log(f"{lbl} decode_attention max abs err per slot: "
        + "; ".join(checks))
    kpad = torch.zeros((8, HKV, deepest, D), dtype=dt, device=dev)
    vpad = torch.zeros_like(kpad)
    for b, n in enumerate(seqlens_l):
        if n:
            r = trows_d[b].long()[torch.arange(n, device=dev) // sub] + \
                torch.arange(n, device=dev) % sub
            kpad[b, :, :n] = cache[layer, 0][:, r]
            vpad[b, :, :n] = cache[layer, 1][:, r]
    dmask = (torch.arange(deepest, device=dev)[None, :]
             < seqlens[:, None])[:, None, None, :]
    b_ms, b_by = bound(sum(seqlens_l) * 2 * HKV * D * kv_es
                       + 2 * 8 * HQ * D * es + 8 * 4,
                       4 * HQ * D * sum(seqlens_l))
    results.append(dict(
        name="decode_attention" + suffix, route="cuda",
        source="vattention_tpu_torch/csrc/decode_attention.cu",
        replaces="vattention_tpu/ops/flash_decode.py:157",
        max_abs_err=err,
        ms=timer(lambda: flash_decode.decode_attention(*dargs, **dkw)),
        plain_ms=timer(lambda: flash_decode.decode_attention_plain(
            *dargs, **dkw), iters=3),
        library_ms=timer(lambda: sdpa(qd[:, :, None], kpad, vpad,
                                      attn_mask=dmask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B=8 depths {seqlens_l}, Hq={HQ} Hkv={HKV} D={D} bf16, "
              f"{cache.dtype} K/V"))

    f1 = (q, qd, cache, qt_run, qinfo, trows, trows_d, seqlens, layer)
    fkw = dict(sub=sub, pad_tile=pad, sm_scale=sm)
    if main and not geo.get("lean"):
        host.update({
            "prefill_attention": host_us(
                lambda: flash_prefill.prefill_attention(*args, **kw)),
            "decode_attention": host_us(
                lambda: flash_decode.decode_attention(*dargs, **dkw)),
            "pod_attention": host_us(lambda: pod_fused.pod_attention(
                *f1, **fkw)),
            "SDPA (decode)": host_us(lambda: sdpa(
                qd[:, :, None], kpad, vpad, attn_mask=dmask,
                enable_gqa=True))})
        log(f"{lbl} host us per call (200 enqueues, no sync): " + ", ".join(
            f"{name} {us:.1f}" for name, us in host.items()))
    del kpad, vpad
    results.append(pod_kernel(timer, args, args2, dargs, seqlens_l, sub,
                              results[-2]["library_ms"]
                              + results[-1]["library_ms"], sm, suffix, lbl,
                              out_scale, geo))
    results.append(paged_kernels(dev, cache, R, timer, randn, layer, sm,
                                 suffix, lbl, out_scale, geo))
    results += single_run_kernels(dev, cache, R, bt, sub, n_sub, timer,
                                  randn, layer, sm, suffix, lbl, out_scale,
                                  geo)
    err, rel = check_prefill_edges(cache, HQ, layer, sm_scale=sm,
                                   out_scale=out_scale)
    log(f"{lbl} prefill body edge cases (kv_len 1, 63, 64, 65, 127, 128, "
        "129, 200, 257, 4133; q_start 40, 56, 60 mod 64 and 104, 120, 124 "
        "mod 128; the empty run; B over 16-token block "
        "tables with poisoned tails and over unaligned extents): max abs err "
        f"{err} (row worst {rel:.5f}); E = B, F = B and C, G = B, H = E bit "
        "for bit")
    err, rel = check_decode_edges(cache, layer, sm_scale=sm,
                                  out_scale=out_scale)
    log(f"{lbl} decode body edge cases (depths {EDGE_DEPTHS}, tables "
        f"32768 positions deep, sub 256 and 16, G {EDGE_GROUPS}, Hkv {HKV}): "
        f"max abs err {err} (row worst {rel:.5f}); idle slots exactly zero")
    if main and not geo.get("lean"):
        long_context(dev, cache, R, bt, timer, randn, layer, geo, lbl)
    elif geo is YI:
        widening_check(dev, arena, sm, lbl)

    # -- D: a chained plan from the allocator in strict mode (the bf16
    # arena's 2048-row blocks on every arena: D moves bytes)
    plan, live = strict_relocation_plan(L, HKV, D, es)
    n_moves = len(plan.moves)
    src = torch.tensor([m.src for m in plan.moves], dtype=torch.int32,
                       device=dev)
    dst = torch.tensor([m.dst for m in plan.moves], dtype=torch.int32,
                       device=dev)
    before = cache.clone()
    expect = cache.clone()
    arena_copy.arena_relocate_plain(expect, src, dst, n_moves, bt)
    arena_copy.arena_relocate(cache, src, dst, n_moves, bt)
    torch.cuda.synchronize()
    if not torch.equal(cache.view(torch.uint8), expect.view(torch.uint8)):
        raise AssertionError(f"arena_relocate{suffix} differs from its "
                             "plain version")
    del expect
    for old_rows, new_rows in live:
        o = torch.from_numpy(old_rows).to(dev)
        nw = torch.from_numpy(new_rows).to(dev)
        if not torch.equal(before[:, :, :, o].view(torch.uint8),
                           cache[:, :, :, nw].view(torch.uint8)):
            raise AssertionError("a live slot's KV did not survive relocation")
    del before
    moves = [(m.src, m.dst) for m in plan.moves]
    results.append(relocation_row(
        cache, src, dst, bt, timer, suffix,
        f"{n_moves} chained moves {moves} of {bt}-row blocks, L={L} "
        f"Hkv={HKV} D={D} {cache.dtype}"))
    del cache
    torch.cuda.empty_cache()
    for r in results:
        if geo["DR"] != D:
            # every byte and operation counted is proportional to the head
            # dim but for a few bytes of int32 tables
            r["bound_real_ms"] = r["bound_ms"] * geo["DR"] / D
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        real = ("" if "bound_real_ms" not in r else
                f", at head dim {geo['DR']} {r['bound_real_ms']:.5f} "
                f"({100 * r['bound_real_ms'] / r['ms']:.1f}%)")
        copy = ("" if "copy_ms" not in r else
                f"; a copy_ of its bytes {r['copy_ms']:.4f}")
        log(f"{lbl} {r['name']}: {r['shape']}: max_abs_err {r['max_abs_err']}"
            f" ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library {lib} "
            f"bound {r['bound_ms']:.5f} ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}%){real}{copy}"
            + (f"; host us per call {host[r['name'].split('[')[0]]:.1f}"
               if r["name"].split("[")[0] in host else ""))
    return results


# --------------------------------------------------------------------- #
# (a rope) kernel A with the rotation
# --------------------------------------------------------------------- #
# instance suffix -> (model, model dtype, arena dtype[, tp: the heads of
# one tp rank]); launches from (c), (c8), (b) (the f32 tiny model), (g),
# (k) (falcon, bf16), (b falcon) (falcon on 1-byte arenas) and (t yi)
# (Yi's tp ranks)
ROPE_INSTANCES = {
    "": ("yi-6b-200k", torch.bfloat16, torch.bfloat16),
    "[e4m3]": ("yi-6b-200k", torch.bfloat16, torch.float8_e4m3fn),
    "[int8]": ("yi-6b-200k", torch.bfloat16, torch.int8),
    "[f32]": ("yi-6b-200k", torch.float32, torch.float32),
    "[mistral]": ("mistral-7b", torch.bfloat16, torch.bfloat16),
    "[falcon]": ("falcon-7b", torch.bfloat16, torch.bfloat16),
    "[falcon e4m3]": ("falcon-7b", torch.bfloat16, torch.float8_e4m3fn),
    "[falcon int8]": ("falcon-7b", torch.bfloat16, torch.int8),
    "[tp2]": ("yi-6b-200k", torch.bfloat16, torch.bfloat16, 2),
    "[tp4]": ("yi-6b-200k", torch.bfloat16, torch.bfloat16, 4),
}


def rope_append_phase(dev):
    """(a rope): kernel A with the rotation (``rope_kv_append``) at (a)'s
    step of 520 tokens (two prefill runs, 32 padding tokens, 6 decode
    slots at positions to 199999 and 2 idle ones) on Yi-6B's heads (bf16
    into bf16, e4m3 and int8 arenas; f32 into f32), Mistral-7B's (bf16)
    and Falcon-7B's (71 query heads, 1 kv head, head dim 64 into the
    arena's 128 lanes; bf16 into bf16, e4m3 and int8):
    q and the arena bit for bit against the plain version (the port's rope,
    then kv_append_plain), V carrying the quantization's edges; each timed
    beside the plain version and the eager sequence it replaces (the rope
    with its per-call copy of inv_freq, the K and V copies, then kernel A
    without the rotation), with its bytes bound and the host microseconds
    per call of it and of the eager sequence."""
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.model_executor.layers.rotary_embedding import (
        get_rope)
    from vattention_tpu_torch.ops import cache_append
    from vattention_tpu_torch.ops.cache_append import split_qkv
    from vattention_tpu_torch.ops.utils import pad_heads, quantize_kv

    layer, L, bt = 5, 8, 2048
    T = 512 + 8
    rows = np.full(T, -1, np.int32)
    rows[:300] = np.arange(3 * bt + 1000, 3 * bt + 1300)
    rows[300:480] = np.arange(9 * bt, 9 * bt + 180)      # 480..511: padding
    rows[512:518] = [bt * i + 17 * i for i in (11, 12, 13, 14, 15, 16)]
    pos = np.zeros(T, np.int32)
    pos[:300] = np.arange(1000, 1300)
    pos[300:480] = np.arange(180)
    pos[512:518] = [4095, 8191, 65535, 131071, 199999, 17]
    rows_d = torch.from_numpy(rows).to(dev)
    pos_d = torch.from_numpy(pos).to(dev)
    nvalid = int((rows >= 0).sum())
    timer = Timer(dev)
    results = []
    for suffix, (model, dt, arena, *tp) in ROPE_INSTANCES.items():
        a = get_model_arch(model)
        tp = tp[0] if tp else 1
        HQ, HKV, D = a.num_q_heads // tp, a.num_kv_heads // tp, a.head_dim
        Dp = -(-D // 128) * 128   # the arena pads the head dim to 128
        rope = get_rope(D, D, a.max_position_embeddings, a.rope_theta,
                        a.rope_scaling)
        step = INT8_STEP if arena == torch.int8 else None
        gen = torch.Generator(device=dev).manual_seed(9)
        qkv = (torch.randn(T, (HQ + 2 * HKV) * D, generator=gen, device=dev)
               * 3).to(dt)
        cache = torch.randn(L, 2, HKV, 24 * bt, Dp, generator=gen,
                            device=dev)
        cache = quantize_kv(cache, arena, step)
        if arena != dt:
            # the quantization's edges in V (not rotated): the flush cutoff
            # and its bf16 neighbours, e4m3's largest value and past it,
            # int8 half steps
            s_ = step or 1.0
            edge = torch.tensor([15 * 2 ** -10, 1.8671875 * 2 ** -7,
                                 1.8828125 * 2 ** -7, 448, 500, 1000,
                                 0.5 * s_, 1.5 * s_, 126.5 * s_, 300 * s_],
                                device=dev)
            edge = torch.cat([edge, -edge]).to(dt)
            qkv[:edge.numel(), (HQ + HKV) * D] = edge
        args = (qkv, pos_d, rows_d, layer, rope, step)
        expect = cache.clone()
        q_ref = cache_append.rope_kv_append_plain(expect, *args)
        got = cache.clone()
        q = cache_append.rope_kv_append(got, *args)
        torch.cuda.synchronize()
        if not (torch.equal(q.view(torch.uint8), q_ref.view(torch.uint8))
                and torch.equal(got.view(torch.uint8),
                                expect.view(torch.uint8))):
            bad = (q.float() != q_ref.float()).sum().item()
            raise AssertionError(f"rope_kv_append{suffix} differs from its "
                                 f"plain version ({bad} q values)")
        del expect, q_ref

        def eager():
            # the serving path before kernel A rotated: the rope, which
            # copied inv_freq to the card at every call (a wait), K and V
            # made contiguous (padded to the arena's head dim), then
            # kernel A without the rotation
            rope.inv_freq.to(dev)
            q_, k_, v_ = split_qkv(qkv, HKV, D)
            q_, k_ = rope(pos_d, q_, k_)
            cache_append.kv_append(got, pad_heads(k_, Dp).contiguous(),
                                   pad_heads(v_, Dp).contiguous(), rows_d,
                                   layer, kv_scale=step)
            return q_

        es = qkv.element_size()
        b_ms, b_by = bound(T * (2 * HQ + 2 * HKV) * D * es + T * 8 + D * 2
                          + nvalid * 2 * HKV * Dp * got.element_size(), 0)
        fused = functools.partial(cache_append.rope_kv_append, got, *args)
        r = dict(
            name="rope_kv_append" + suffix, route="cuda",
            source="vattention_tpu_torch/csrc/kv_append.cu",
            replaces="vattention_tpu/ops/cache_append.py:152,274",
            max_abs_err=0.0, ms=timer(fused),
            plain_ms=timer(lambda: cache_append.rope_kv_append_plain(
                got, *args)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            eager_ms=timer(eager), host_us=host_us(fused),
            eager_host_us=host_us(eager),
            shape=f"T={T} ({nvalid} valid) Hq={HQ} Hkv={HKV} D={D} "
                  f"{str(dt)[6:]} -> {str(arena)[6:]}")
        log(f"(a rope) rope_kv_append{suffix} [{r['shape']}]: q and arena "
            f"== plain bit for bit; ms {r['ms']:.4f}, bound "
            f"{b_ms:.5f} ({b_by}), {100 * b_ms / r['ms']:.0f}% of it; plain "
            f"{r['plain_ms']:.4f}; eager rope + copies + kernel A "
            f"{r['eager_ms']:.4f} ms; host us per call {r['host_us']:.1f}, "
            f"eager {r['eager_host_us']:.1f}")
        results.append(r)
        del got, cache, qkv
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------- #
# (a norm) the layer's elementwise kernels, and kernel A with a qkv bias
# --------------------------------------------------------------------- #
# the widths of each model whose serving phase gives the launches: (c),
# (g), (k) and (q) in bf16; (b) and (b falcon) in float32
NORM_MODELS = {"yi": "yi-6b-200k", "mistral": "mistral-7b",
               "falcon": "falcon-7b", "qwen": "qwen-14b"}
# a decode row, (c)'s decode batch, (a)'s step, (r)'s chunk
NORM_ROWS = (1, 8, 520, 2048)
# the JAX functions each kernel fuses (XLA fuses them into the jitted step:
# no pallas_call)
NORM_REPLACES = {
    "add_rms_norm": "vattention_tpu/model_executor/layers/layernorm.py:13",
    "silu_and_mul": "vattention_tpu/model_executor/layers/activation.py:10",
    "add_layer_norm": "vattention_tpu/model_executor/models/falcon.py:22",
    "gelu_new": "vattention_tpu/model_executor/layers/activation.py:16",
}


def norm_act_phase(dev):
    """(a norm): ``ops/norm_act.py``'s kernels at the widths of Yi-6B,
    Mistral-7B, Qwen-14B (add_rms_norm, silu_and_mul) and Falcon-7B
    (add_layer_norm, gelu_new), at T = 1, 8, 520 and 2048 rows in bf16 and
    float32: the residual output bit for bit against the plain add, the
    normalized and activated outputs within ``check_elementwise``; each
    timed beside its plain version, one library call (``F.rms_norm`` after
    the add, ``F.layer_norm`` after the adds, ``F.silu(g) * u``,
    ``F.gelu(approximate="tanh")``) and its bytes bound (each input read
    once, each output written once).  At Qwen-14B's heads (40 q, 40 kv,
    D 128) kernel A with a qkv bias at the same T (every fifth row -1,
    positions to 8191), q and the arena bit for bit against its plain
    version, timed beside it and its bytes bound; no library call."""
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.microbenchmarks.bench_norm_act import (
        HIDDEN_WIDTHS, MLP_WIDTHS, PLAN_ROWS)
    from vattention_tpu_torch.microbenchmarks.timing import check_elementwise
    from vattention_tpu_torch.ops import norm_act

    F = torch.nn.functional
    # add_rms_norm, silu_and_mul and gelu_new at every registry width
    # and the launch plans' rows: held, not timed
    n = 0
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(18)

        def draw(*shape, scale=1.0, shift=0.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale
                    + shift).to(dt)
        for H in HIDDEN_WIDTHS:
            w = draw(H, scale=0.2, shift=1)
            for T in PLAN_ROWS:
                x, r = draw(T, H, scale=2, shift=0.5), draw(T, H, scale=0.7)
                for addend in (r, None):
                    got = norm_act.add_rms_norm(x, addend, w, 1e-5)
                    ref = norm_act.add_rms_norm_plain(x, addend, w, 1e-5)
                    torch.cuda.synchronize()
                    what = f"add_rms_norm[{H} T{T} {str(dt)[6:]}]"
                    if not torch.equal(got[0], ref[0]):
                        raise AssertionError(f"{what}: the residual differs "
                                             "from x + r")
                    check_elementwise(what, got[1], ref[1])
                    n += 1
        for inter in MLP_WIDTHS:
            for T in PLAN_ROWS:
                g = draw(T, 2 * inter, scale=4)
                got = norm_act.silu_and_mul(g)
                torch.cuda.synchronize()
                check_elementwise(f"silu_and_mul[{inter} T{T} {str(dt)[6:]}]",
                                  got, norm_act.silu_and_mul_plain(g))
                u = g[:, :inter].contiguous()
                got = norm_act.gelu_new(u)
                torch.cuda.synchronize()
                check_elementwise(f"gelu_new[{inter} T{T} {str(dt)[6:]}]",
                                  got, norm_act.gelu_new_plain(u))
                n += 2
        del x, r, g, u
        torch.cuda.empty_cache()
    log(f"(a norm) add_rms_norm (with and without r) at hidden widths "
        f"{HIDDEN_WIDTHS}, silu_and_mul and gelu_new at MLP widths "
        f"{MLP_WIDTHS}, T {PLAN_ROWS}, bf16 and float32: {n} cases == plain "
        "(residuals bit for bit, outputs within check_elementwise)")
    timer = Timer(dev)
    results = []
    for tag, model in NORM_MODELS.items():
        a = get_model_arch(model)
        H, I = a.hidden_size, a.intermediate_size
        eps = 1e-5 if a.parallel_attn else a.rms_norm_eps
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(16)

            def randn(*shape, scale=1.0, shift=0.0):
                return (torch.randn(shape, generator=gen, device=dev) * scale
                        + shift).to(dt)
            w = randn(H, scale=0.2, shift=1)
            b = randn(H, scale=0.1)
            for T in NORM_ROWS:
                words = f"{tag} T{T}" + (" f32" if dt == torch.float32
                                         else "")
                x = randn(T, H, scale=2, shift=0.5)
                o = randn(T, H, scale=0.7)
                m = randn(T, H, scale=0.7)
                es = x.element_size()
                if a.parallel_attn:
                    u = randn(T, I, scale=3)
                    cases = [
                        ("add_layer_norm",
                         lambda: norm_act.add_layer_norm(x, o, m, w, b, eps),
                         lambda: norm_act.add_layer_norm_plain(x, o, m, w, b,
                                                               eps),
                         lambda: F.layer_norm(x + (o + m), (H,), w, b, eps),
                         (5 * T * H + 2 * H) * es, f"[{T}, {H}]"),
                        ("gelu_new", lambda: norm_act.gelu_new(u),
                         lambda: norm_act.gelu_new_plain(u),
                         lambda: F.gelu(u, approximate="tanh"),
                         2 * T * I * es, f"[{T}, {I}]")]
                else:
                    g = randn(T, 2 * I, scale=4)
                    cases = [
                        ("add_rms_norm",
                         lambda: norm_act.add_rms_norm(x, o, w, eps),
                         lambda: norm_act.add_rms_norm_plain(x, o, w, eps),
                         lambda: F.rms_norm(x + o, (H,), w, eps),
                         (4 * T * H + H) * es, f"[{T}, {H}]"),
                        ("silu_and_mul", lambda: norm_act.silu_and_mul(g),
                         lambda: norm_act.silu_and_mul_plain(g),
                         lambda: F.silu(g[:, :I]) * g[:, I:],
                         3 * T * I * es, f"[{T}, 2 x {I}]")]
                for name, fn, plain, lib, n_bytes, shape in cases:
                    got, ref = fn(), plain()
                    torch.cuda.synchronize()
                    if isinstance(got, tuple):
                        if not torch.equal(got[0], ref[0]):
                            raise AssertionError(f"{name}[{words}]: the "
                                                 "residual differs from x + r")
                        got, ref = got[1], ref[1]
                    err = check_elementwise(f"{name}[{words}]", got, ref)
                    b_ms, b_by = bound(n_bytes, 0)
                    r = dict(name=f"{name}[{words}]", route="cuda",
                             source="vattention_tpu_torch/csrc/norm_act.cu",
                             replaces=NORM_REPLACES[name], max_abs_err=err,
                             ms=timer(fn), plain_ms=timer(plain),
                             library_ms=timer(lib), bound_ms=b_ms,
                             bound_by=b_by)
                    log(f"(a norm) {name}[{words}] {shape} {str(dt)[6:]}: "
                        f"== plain (residual bit for bit), max err {err:.3g}; "
                        f"ms {r['ms']:.4f}, bound {b_ms:.5f} ({b_by}), "
                        f"{100 * b_ms / r['ms']:.1f}% of it; plain "
                        f"{r['plain_ms']:.4f}; library {r['library_ms']:.4f}")
                    results.append(r)
                if a.qkv_bias:
                    results.append(biased_append(dev, timer, a, dt, T,
                                                 words))
                del x, o, m
            torch.cuda.empty_cache()
    return results


def biased_append(dev, timer, a, dt, T, words):
    """Kernel A with a qkv bias at ``a``'s heads over T tokens (rows
    distinct, every fifth -1), bit for bit against its plain version."""
    from vattention_tpu_torch.model_executor.layers.rotary_embedding import (
        get_rope)
    from vattention_tpu_torch.ops.cache_append import (
        rope_kv_append as fused, rope_kv_append_plain as plain)

    HQ, HKV, D = a.num_q_heads, a.num_kv_heads, a.head_dim
    rope = get_rope(D, D, a.max_position_embeddings, a.rope_theta,
                    a.rope_scaling)
    gen = torch.Generator(device=dev).manual_seed(17)
    W = (HQ + 2 * HKV) * D
    qkv = (torch.randn(T, W, generator=gen, device=dev) * 3).to(dt)
    bias = (torch.randn(W, generator=gen, device=dev) * 2).to(dt)
    R = max(T, 2048)
    cache = torch.randn(2, 2, HKV, R, D, generator=gen, device=dev).to(dt)
    rows = torch.randperm(R, generator=gen, device=dev)[:T].int()
    rows[::5] = -1
    pos = torch.randint(0, 8192, (T,), generator=gen, device=dev,
                        dtype=torch.int32)
    args = (qkv, pos, rows, 1, rope)
    expect = cache.clone()
    q_ref = plain(expect, *args, bias=bias)
    q = fused(cache, *args, bias=bias)
    torch.cuda.synchronize()
    if not (torch.equal(q.view(torch.uint8), q_ref.view(torch.uint8))
            and torch.equal(cache.view(torch.uint8),
                            expect.view(torch.uint8))):
        raise AssertionError(f"rope_kv_append[{words}] with a bias differs "
                             "from its plain version")
    nvalid = int((rows >= 0).sum())
    es = qkv.element_size()
    b_ms, b_by = bound(T * (2 * HQ + 2 * HKV) * D * es + T * 8 + D * 2
                       + W * es + nvalid * 2 * HKV * D * es, 0)
    r = dict(name=f"rope_kv_append[{words}]", route="cuda",
             source="vattention_tpu_torch/csrc/kv_append.cu",
             replaces="vattention_tpu/ops/cache_append.py:152,274",
             max_abs_err=0.0,
             ms=timer(lambda: fused(cache, *args, bias=bias)),
             plain_ms=timer(lambda: plain(expect, *args, bias=bias)),
             library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(f"(a norm) rope_kv_append[{words}] with the qkv bias, Hq={HQ} "
        f"Hkv={HKV} D={D}, {nvalid} valid rows: q and arena == plain bit "
        f"for bit; ms {r['ms']:.4f}, bound {b_ms:.5f} ({b_by}), "
        f"{100 * b_ms / r['ms']:.1f}% of it; plain {r['plain_ms']:.4f}")
    return r


def widening_check(dev, arena, sm, lbl):
    """(a) on a 1-byte arena: row 0's V holds every finite e4m3 pattern (or
    every int8 value) in each kv head; zero queries at kv_len 1 give that
    key weight 1, so every output row of C, B, E, G, H and F must be V's
    row widened to bf16, exactly."""
    from vattention_tpu_torch.ops import (flash_decode, flash_prefill,
                                          paged_attention, pod_fused)

    HQ, HKV, D = YI["HQ"], YI["HKV"], YI["D"]
    if arena == torch.float8_e4m3fn:
        raw = torch.tensor([b for b in range(256) if b & 0x7F != 0x7F]
                           + [0, 0], dtype=torch.uint8)
    else:
        raw = torch.arange(-128, 128, dtype=torch.int16).to(
            torch.int8).view(torch.uint8)
    # the bytes, then reversed: Yi's 4 kv heads x 128 lanes
    row = torch.cat([raw, raw.flip(0)]).view(HKV, D)
    row = row.view(arena)
    cache = torch.zeros((1, 2, HKV, 4096, D), dtype=torch.uint8)
    cache[0, 1, :, 0] = row.view(torch.uint8)
    cache = cache.view(arena)
    expect = row.to(torch.bfloat16).repeat_interleave(HQ // HKV, 0)
    cache = cache.to(dev)
    expect = expect.to(dev)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    qp = torch.zeros((128, HQ, D), dtype=torch.bfloat16, device=dev)
    qd = torch.zeros((2, HQ, D), dtype=torch.bfloat16, device=dev)
    qinfo, qt_run, table, rows = i32([[0, 1]]), i32([[0, 0]]), i32([[0]]), \
        i32([[0], [0]])
    outs = {
        "C": flash_decode.decode_attention(qd, cache, rows, i32([1, 1]), 0,
                                           sub=256, sm_scale=sm),
        "B": flash_prefill.prefill_attention(qp, cache, qt_run, qinfo, table,
                                             0, sub=256, pad_tile=128,
                                             sm_scale=sm),
        "E": paged_attention.paged_prefill_attention(
            qp, cache, qt_run, qinfo, table, 0, block_size=16, pad_tile=128,
            sm_scale=sm),
        "G": flash_prefill.segment_prefill_attention(
            qp, cache, i32([0]), i32([0, 1]), i32([0, 1]), 0, sm_scale=sm),
        "H": paged_attention.paged_prefill_attention_single(
            qp, cache, i32([0]), i32([0, 1]), 0, block_size=16,
            sm_scale=sm)}
    outs["F prefill"], outs["F decode"] = pod_fused.pod_attention(
        qp, qd, cache, qt_run, qinfo, table, rows, i32([1, 1]), 0, sub=256,
        pad_tile=128, sm_scale=sm)
    torch.cuda.synchronize()
    for name, out in outs.items():
        if not torch.equal(out, expect.expand_as(out)):
            raise AssertionError(f"{lbl} {name} does not widen every "
                                 f"{arena} value exactly")
    what = "int8 value" if arena == torch.int8 else "finite e4m3 pattern"
    log(f"{lbl} widening: every {what} ({raw.numel()} values) widens "
        "exactly in C, B, E, G, H and F")


def pod_kernel(timer, pre1, pre2, dec, depths, sub, sdpa_ms, sm, suffix,
               lbl, out_scale, geo=YI):
    """(a) for kernel F: each of kernel B's two cases (``pre1``: chunk 512
    at kv_len 4096; ``pre2``: 3 runs and the empty run) fused with kernel
    C's batch (``dec``) in one launch, held against F's plain version and
    against B and C on the same inputs (bit for bit: a difference raises);
    F timed on ``pre1`` beside B then C.  ``sdpa_ms`` is the sum of B's and
    C's SDPA times."""
    from vattention_tpu_torch.ops import flash_decode, flash_prefill, pod_fused

    HQ, HKV, D = geo["HQ"], geo["HKV"], geo["D"]
    es = 2
    qd, cache, trows_d, seqlens, layer = dec
    kv_es = cache.element_size()
    check = functools.partial(check_attention, scale=out_scale)
    kw = dict(sub=sub, pad_tile=128, sm_scale=sm)
    dkw = dict(sub=sub, sm_scale=sm)
    err, checks = 0.0, []
    # (prefill args, real row ranges, first row of the empty run's tile)
    for pre, ranges, empty in ((pre1, [(0, 512)], None),
                               (pre2, [(0, 128), (128, 100), (256, 60)], 384)):
        q, _, qt_run, qinfo, trows, _ = pre
        fargs = (q, qd, cache, qt_run, qinfo, trows, trows_d, seqlens, layer)
        got_p, got_d = pod_fused.pod_attention(*fargs, **kw)
        ref_p, ref_d = pod_fused.pod_attention_plain(*fargs, **kw)
        got_b = flash_prefill.prefill_attention(*pre, **kw)
        got_c = flash_decode.decode_attention(*dec, **dkw)
        torch.cuda.synchronize()
        if empty is not None and got_p[empty:].abs().max().item() != 0.0:
            raise AssertionError("pod: the empty run's tile is not zero")
        if not torch.isfinite(got_d).all() or got_d[0].abs().max().item() != 0.0:
            raise AssertionError("pod: the seqlen-0 slot is not zero")
        case_err = 0.0
        for lo, n in ranges:
            e, _ = check(f"pod prefill rows {lo}..{lo + n}",
                                   got_p[lo:lo + n], ref_p[lo:lo + n],
                                   PREFILL_TOL)
            case_err = max(case_err, e)
        for b, n in enumerate(depths):
            if n:
                e, _ = check(f"pod decode slot {b} at depth {n}",
                                       got_d[b:b + 1], ref_d[b:b + 1],
                                       DECODE_TOL)
                case_err = max(case_err, e)
        err = max(err, case_err)
        vs_b = (got_p.float() - got_b.float()).abs().max().item()
        vs_c = (got_d.float() - got_c.float()).abs().max().item()
        checks.append(f"{len(ranges)} run(s): max |F - plain| {case_err}, "
                      f"max |F - B| {vs_b}, max |F - C| {vs_c}")
        if not (torch.equal(got_p, got_b) and torch.equal(got_d, got_c)):
            raise AssertionError(f"pod_attention{suffix} differs from B "
                                 "then C")
    log(f"{lbl} pod_attention, prefill fused with B=8 decode slots at depths "
        f"{depths}: " + "; ".join(checks))
    f1 = (pre1[0], qd, cache, *pre1[2:5], trows_d, seqlens, layer)
    pairs = 512 * 3584 + 512 * 513 // 2   # causal (query, key) pairs of pre1
    b_ms, b_by = bound(
        (2 * 512 * HQ * D + 2 * 8 * HQ * D) * es
        + (4096 + sum(depths)) * 2 * HKV * D * kv_es + 8 * 4,
        4 * HQ * D * (pairs + sum(depths)))
    res = dict(
        name="pod_attention" + suffix, route="cuda",
        source="vattention_tpu_torch/csrc/pod_attention.cu",
        replaces="vattention_tpu/ops/pod_fused.py:341",
        max_abs_err=err,
        ms=timer(lambda: pod_fused.pod_attention(*f1, **kw)),
        serial_ms=timer(lambda: (flash_prefill.prefill_attention(*pre1, **kw),
                                 flash_decode.decode_attention(*dec, **dkw))),
        plain_ms=timer(lambda: pod_fused.pod_attention_plain(*f1, **kw),
                       iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"chunk 512 at kv_len 4096 + B=8 depths {depths}, "
              f"Hq={HQ} Hkv={HKV} D={D} bf16, {cache.dtype} K/V")
    log(f"{lbl} pod_attention: {res['shape']}: ms {res['ms']:.4f}, B then C "
        f"serially {res['serial_ms']:.4f}, plain {res['plain_ms']:.4f}, "
        f"SDPA prefill + SDPA decode {sdpa_ms:.4f}, bound {b_ms:.4f} "
        f"({b_by})")
    # each role of F alone in F's grid (the other role's blocks have no
    # work: every slot idle, or every prefill run empty) beside the kernel
    # that runs that body alone
    idle = torch.zeros_like(seqlens)
    empty = torch.zeros_like(pre1[3])
    f_pre = (*f1[:7], idle, layer)
    f_dec = (*f1[:4], empty, *f1[5:])
    log(f"{lbl} pod_attention by role: prefill role alone (every slot idle) "
        f"{timer(lambda: pod_fused.pod_attention(*f_pre, **kw)):.4f} ms, "
        f"B {timer(lambda: flash_prefill.prefill_attention(*pre1, **kw)):.4f}"
        " ms; decode role alone (every run empty) "
        f"{timer(lambda: pod_fused.pod_attention(*f_dec, **kw)):.4f} ms, C "
        f"{timer(lambda: flash_decode.decode_attention(*dec, **dkw)):.4f} ms")
    return res


def ptxas_report(names=("prefill_attention", "paged_prefill_attention",
                        "decode_attention", "pod_attention", "kv_append")):
    """Registers, spills and shared memory per block of the bf16 prefill
    body's kernels (B, G, E and H, named by their q map and row map) and
    of the G = 8 instances of the others (C's shared memory in both
    dtypes), and registers and spills of each instance of kernel A, from
    each library's ptxas log (written when the library is built) and the
    dynamic shared memory the launchers ask for.  An instance that runs
    the bf16 prefill body (B, E, F, G, H) gives its registers at launch,
    then the producer's and the consumers' after setmaxnreg; ptxas's notes
    on wgmma and setmaxnreg, if any, follow."""
    import ctypes

    from vattention_tpu_torch.ops.cuda_build import library, library_path

    pre = library("prefill_attention").vattn_prefill_smem_bytes
    pre.argtypes = [ctypes.c_int, ctypes.c_int]
    role_regs = library("prefill_attention").vattn_prefill_role_regs
    role_regs.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    dec = library("decode_attention").vattn_decode_smem_bytes
    dec.argtypes = [ctypes.c_int, ctypes.c_int]

    def storage(fn):
        """The K/V storage type of a mangled instance: e4m3, int8 (signed
        char, mangled "a", right after the compute type) or the compute
        type."""
        if "fp8" in fn:
            return "e4m3", 2
        if re.search(r"kernelI(?:f|13__nv_bfloat16)?a", fn):
            return "int8", 3
        return None, None

    for name in names:
        path = library_path(name).with_suffix(".so.log")
        if not path.exists():
            log(f"ptxas {name}.cu: no build log (built by an earlier run)")
            continue
        fn = None
        for line in path.read_text().splitlines():
            if "wgmma" in line or "setmaxnreg" in line:
                log(f"ptxas {name}.cu: {line.strip()}")
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spills = m.group(1), "spills not reported"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                spills = f"{m.group(1)}/{m.group(2)} bytes spilled"
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and name == "kv_append":
                kv = ("e4m3" if "ToFp8" in fn else "int8" if "ToInt8" in fn
                      else "the model's type")
                log(f"ptxas kv_append.cu: rope_kv_append_kernel "
                    f"({'bf16' if 'bfloat16' in fn else 'f32'} into {kv}): "
                    f"{m.group(1)} registers, {spills}")
                continue
            if m and fn and ("tc_kernel" in fn or "Li8E" in fn):
                bf16 = "bfloat16" in fn
                kernel = re.search(r"\d+([a-z_]+_kernel)", fn).group(1)
                maps = re.findall(r"RunTiles|OneRun|TileRows|BlockTables|"
                                  r"Segments", fn)
                if maps:
                    kernel += f"<{', '.join(maps)}>"
                smem = regs = ""
                kv, code = storage(fn)
                if name == "decode_attention":
                    code = int(bf16) if code is None else code
                    smem = (f", shared memory {dec(int(bf16), code)} B "
                            "dynamic per block")
                elif bf16:
                    # F's bf16 blocks carve the prefill body's buffer,
                    # which is larger than C's
                    static = re.search(r"(\d+) bytes smem", line)
                    smem = (f", shared memory {pre(1, code or 1)} B dynamic + "
                            f"{static.group(1) if static else 0} B static "
                            "per block")
                    seg = int("Segments" in maps)
                    pr = role_regs(code or 1, seg, 0)
                    cr = role_regs(code or 1, seg, 1)
                    regs = (f" at launch, then producer {pr} / consumers "
                            f"{cr} after setmaxnreg" if pr != cr else
                            " in every role (no setmaxnreg)")
                log(f"ptxas {name}.cu: {kernel} "
                    f"({'bf16' if bf16 else 'f32'}"
                    f"{f', {kv} K/V' if kv else ''}"
                    f"{'' if 'tc_kernel' in fn else ', G=8'}): "
                    f"{m.group(1)} registers{regs}, {spills}{smem}")


def paged_kernels(dev, cache, pool_rows, timer, randn, layer, sm, suffix,
                  lbl, out_scale, geo=YI):
    """(a) for the paged engine: kernel E at blocks of 16 and 256 tokens
    over the first ``pool_rows`` rows of ``cache``, E against B on the
    same rows, and kernel C over 16-token blocks.  Returns E's result at
    256-token blocks (fa_paged_256, the engine of phase (d))."""
    from vattention_tpu_torch.ops import (flash_decode, flash_prefill,
                                          paged_attention)
    from vattention_tpu_torch.ops.utils import cdiv

    HQ, HKV, D = geo["HQ"], geo["HKV"], geo["D"]
    es = 2
    kv_es = cache.element_size()
    check = functools.partial(check_attention, scale=out_scale)
    pad = 128
    poison = 2 ** 30
    rng = np.random.default_rng(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def tables_for(depths, bs):
        """Block tables of a seeded permutation of the pool, one row per
        depth, 8192 // bs wide, 2**30 past each row's last valid block."""
        perm = rng.permutation(pool_rows // bs)
        tables = np.full((len(depths), 8192 // bs), poison, np.int32)
        used = 0
        for r, n in enumerate(depths):
            k = cdiv(n, bs)
            tables[r, :k] = perm[used:used + k]
            used += k
        return torch.from_numpy(tables).to(dev)

    # K=4 runs (q_start, kv_len, chunk) and the empty run a tail tile maps to
    runs = [(3584, 4096, 512), (0, 128, 128), (2000, 2100, 100), (0, 60, 60)]
    qt_run, offs, off = [], [], 0
    for r, (_, _, chunk) in enumerate(runs):
        offs.append(off)
        qt_run += [(r, i) for i in range(cdiv(chunk, pad))]
        off += cdiv(chunk, pad) * pad
    qt_run.append((len(runs), 0))
    qt_run = torch.tensor(qt_run, dtype=torch.int32, device=dev)
    depths = [n for _, n, _ in runs] + [0]
    qinfo = torch.tensor([(q0, n) for q0, n, _ in runs] + [(0, 0)],
                         dtype=torch.int32, device=dev)
    q = randn(qt_run.shape[0] * pad, HQ, D)
    # the timed case: chunk 512 at kv_len 4096 alone, as kernel B's
    qt_run1 = torch.tensor([[0, i] for i in range(4)], dtype=torch.int32,
                           device=dev)
    qinfo1 = torch.tensor([[3584, 4096], [0, 0]], dtype=torch.int32,
                          device=dev)
    pos = torch.arange(4096, device=dev)
    mask = (3584 + torch.arange(512, device=dev))[:, None] >= pos[None, :]
    b_ms, b_by = bound(2 * 512 * HQ * D * es + 4096 * 2 * HKV * D * kv_es,
                       4 * HQ * D * int(mask.sum().item()))
    out = None
    for bs in (16, 256):
        tables = tables_for(depths, bs)
        args = (q, cache, qt_run, qinfo, tables, layer)
        kw = dict(block_size=bs, pad_tile=pad, sm_scale=sm)
        got = paged_attention.paged_prefill_attention(*args, **kw)
        ref = paged_attention.paged_prefill_attention_plain(*args, **kw)
        # kernel B on the same rows: the block table as a row table
        rows_b = paged_attention.paged_tile_rows(
            torch.where(tables == poison, 0, tables), qinfo[:, 1], bs)
        got_b = flash_prefill.prefill_attention(
            q, cache, qt_run, qinfo, rows_b, layer, sub=bs, pad_tile=pad,
            sm_scale=sm)
        torch.cuda.synchronize()
        if got[off:].abs().max().item() != 0.0:
            raise AssertionError(
                f"paged prefill bs {bs}: the empty run's tile is not zero")
        err, checks = 0.0, []
        for r, (q0, n, chunk) in enumerate(runs):
            e, rel = check(
                f"paged prefill bs {bs}, run {r}",
                got[offs[r]:offs[r] + chunk], ref[offs[r]:offs[r] + chunk],
                PREFILL_TOL)
            checks.append(f"chunk {chunk} at kv_len {n}: {e} "
                          f"(row worst {rel:.5f})")
            err = max(err, e)
        vs_b = (got.float() - got_b.float()).abs().max().item()
        log(f"{lbl} paged_prefill_attention bs {bs}, tables poisoned past "
            f"each run's last block: " + "; ".join(checks)
            + f"; max |E - B| on the same rows {vs_b}")
        t1 = (q[:512], cache, qt_run1, qinfo1,
              tables_for([4096, 0], bs), layer)
        grow = paged_attention.block_rows(t1[4][0], 4096, bs)
        kg = cache[layer, 0][:, grow][None].to(torch.bfloat16)
        vg = cache[layer, 1][:, grow][None].to(torch.bfloat16)
        qg = q[:512].transpose(0, 1)[None]
        res = dict(
            name="paged_prefill_attention" + suffix, route="cuda",
            source="vattention_tpu_torch/csrc/paged_prefill_attention.cu",
            replaces="vattention_tpu/ops/paged_attention.py:107",
            max_abs_err=err,
            ms=timer(lambda: paged_attention.paged_prefill_attention(
                *t1, **kw)),
            plain_ms=timer(
                lambda: paged_attention.paged_prefill_attention_plain(
                    *t1, **kw), iters=3),
            library_ms=timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                          enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"chunk 512 at kv_len 4096 over {bs}-token blocks, "
                  f"Hq={HQ} Hkv={HKV} D={D} bf16, {cache.dtype} K/V")
        del kg, vg
        log(f"{lbl} paged_prefill_attention: {res['shape']}: ms "
            f"{res['ms']:.4f} plain {res['plain_ms']:.4f} library "
            f"{res['library_ms']:.4f} bound {b_ms:.4f} ({b_by})")
        out = res

    # kernel C over 16-token blocks: B=8 at (a)'s depths
    bs = 16
    seqlens_l = geo["DEC"]
    deepest = max(seqlens_l)
    seqlens = torch.tensor(seqlens_l, dtype=torch.int32, device=dev)
    tables = tables_for(seqlens_l, bs)
    qd = randn(8, HQ, D)
    dargs = (qd, cache, tables, seqlens, layer)
    dkw = dict(block_size=bs, sm_scale=sm)
    got = paged_attention.paged_decode_attention(*dargs, **dkw)
    rows = paged_attention.paged_tile_rows(tables, seqlens, bs)
    cargs = (qd, cache, rows, seqlens, layer)
    ckw = dict(sub=bs, sm_scale=sm)
    ref = flash_decode.decode_attention_plain(*cargs, **ckw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got[0].abs().max().item() != 0.0:
        raise AssertionError("paged decode: the seqlen-0 slot is not zero")
    err = 0.0
    for b, n in enumerate(seqlens_l):
        if n:
            e, _ = check(f"paged decode slot {b} at depth {n}",
                                   got[b:b + 1], ref[b:b + 1], DECODE_TOL)
            err = max(err, e)
    kpad = torch.zeros((8, HKV, deepest, D), dtype=torch.bfloat16,
                       device=dev)
    vpad = torch.zeros_like(kpad)
    for b, n in enumerate(seqlens_l):
        if n:
            r = paged_attention.block_rows(tables[b], n, bs)
            kpad[b, :, :n] = cache[layer, 0][:, r]
            vpad[b, :, :n] = cache[layer, 1][:, r]
    dmask = (torch.arange(deepest, device=dev)[None, :]
             < seqlens[:, None])[:, None, None, :]
    c_bound, c_by = bound(sum(seqlens_l) * 2 * HKV * D * kv_es
                          + 2 * 8 * HQ * D * es + 8 * 4,
                          4 * HQ * D * sum(seqlens_l))
    ms = timer(lambda: flash_decode.decode_attention(*cargs, **ckw))
    plain_ms = timer(lambda: flash_decode.decode_attention_plain(
        *cargs, **ckw), iters=3)
    library_ms = timer(lambda: sdpa(qd[:, :, None], kpad, vpad,
                                    attn_mask=dmask, enable_gqa=True))
    log(f"{lbl} decode_attention over {bs}-token blocks (sub={bs}), B=8 "
        f"depths {seqlens_l}: max_abs_err {err} ms {ms:.4f} plain "
        f"{plain_ms:.4f} library {library_ms:.4f} bound {c_bound:.4f} "
        f"({c_by})")
    return out


def single_run_kernels(dev, cache, pool_rows, bt, sub, n_sub, timer, randn,
                       layer, sm, suffix, lbl, out_scale, geo=YI):
    """(a) for kernels G and H at kernel B's shape (chunk 512 at kv_len
    4096): G over 8 extents of 512 tokens starting at 2048-token block
    starts, held against its plain version and against B on the same rows;
    H over a seeded permutation of the pool's 16- and 256-token blocks, its
    table poisoned past the run's last block, held against its plain
    version and against E on one run.  Returns G's result and H's at
    256-token blocks."""
    from vattention_tpu_torch.ops import flash_prefill, paged_attention
    from vattention_tpu_torch.ops.utils import cdiv, tile_rows_from_segments

    HQ, HKV, D = geo["HQ"], geo["HKV"], geo["D"]
    es = 2
    kv_es = cache.element_size()
    check = functools.partial(check_attention, scale=out_scale)
    poison = 2 ** 30
    rng = np.random.default_rng(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(512, HQ, D)
    qinfo = torch.tensor([3584, 4096], dtype=torch.int32, device=dev)
    qt_run = torch.tensor([[0, i] for i in range(4)], dtype=torch.int32,
                          device=dev)
    pos = torch.arange(4096, device=dev)
    mask = (3584 + torch.arange(512, device=dev))[:, None] >= pos[None, :]
    b_ms, b_by = bound(2 * 512 * HQ * D * es + 4096 * 2 * HKV * D * kv_es,
                       4 * HQ * D * int(mask.sum().item()))
    qg = q.transpose(0, 1)[None]

    def timed(name, source, replaces, err, fn, plain, grow, shape):
        kg = cache[layer, 0][:, grow][None].to(torch.bfloat16)
        vg = cache[layer, 1][:, grow][None].to(torch.bfloat16)
        res = dict(
            name=name + suffix, route="cuda", source=source,
            replaces=replaces,
            max_abs_err=err, ms=timer(fn), plain_ms=timer(plain, iters=3),
            library_ms=timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                          enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, shape=shape)
        log(f"{lbl} {name}: {shape}: ms {res['ms']:.4f} plain "
            f"{res['plain_ms']:.4f} library {res['library_ms']:.4f} bound "
            f"{b_ms:.4f} ({b_by})")
        return res

    # -- G: 8 extents at block starts, in no order
    starts = [3, 9, 1, 14, 6, 11, 20, 17]
    seg_row = np.array([s * bt for s in starts], np.int32)
    seg_cum = np.arange(9, dtype=np.int32) * 512
    sr = torch.from_numpy(seg_row).to(dev)
    sc = torch.from_numpy(seg_cum).to(dev)
    gargs = (q, cache, sr, sc, qinfo, layer)
    got = flash_prefill.segment_prefill_attention(*gargs, sm_scale=sm)
    ref = flash_prefill.segment_prefill_attention_plain(*gargs, sm_scale=sm)
    rows_b = torch.from_numpy(tile_rows_from_segments(
        seg_row[None], seg_cum[None], sub, n_sub)).to(dev)
    got_b = flash_prefill.prefill_attention(
        q, cache, qt_run, qinfo[None], rows_b, layer, sub=sub, pad_tile=128,
        sm_scale=sm)
    torch.cuda.synchronize()
    err, rel = check("segment prefill", got, ref, PREFILL_TOL)
    vs_b = (got.float() - got_b.float()).abs().max().item()
    log(f"{lbl} segment_prefill_attention, 8 extents of 512 tokens: max abs "
        f"err {err} (row worst {rel:.5f}); max |G - B| on the same rows "
        f"{vs_b}")
    if not torch.equal(got, got_b):
        raise AssertionError("G differs from B on the same rows")
    out = [timed(
        "segment_prefill_attention",
        "vattention_tpu_torch/csrc/prefill_attention.cu",
        "vattention_tpu/ops/flash_prefill.py:178", err,
        lambda: flash_prefill.segment_prefill_attention(*gargs, sm_scale=sm),
        lambda: flash_prefill.segment_prefill_attention_plain(
            *gargs, sm_scale=sm),
        flash_prefill.segment_rows(sr, sc, 4096),
        f"chunk 512 at kv_len 4096 over 8 extents, Hq={HQ} Hkv={HKV} "
        f"D={D} bf16, {cache.dtype} K/V")]

    # -- H: a permutation of the pool's blocks, the tail poisoned
    for bs in (16, 256):
        n = cdiv(4096, bs)
        table = np.full(8192 // bs, poison, np.int32)
        table[:n] = rng.permutation(pool_rows // bs)[:n]
        table = torch.from_numpy(table).to(dev)
        hargs = (q, cache, table, qinfo, layer)
        hkw = dict(block_size=bs, sm_scale=sm)
        got = paged_attention.paged_prefill_attention_single(*hargs, **hkw)
        ref = paged_attention.paged_prefill_attention_single_plain(*hargs,
                                                                   **hkw)
        got_e = paged_attention.paged_prefill_attention(
            q, cache, qt_run, qinfo[None], table[None], layer,
            block_size=bs, pad_tile=128, sm_scale=sm)
        torch.cuda.synchronize()
        err, rel = check(f"paged prefill single bs {bs}", got, ref,
                                   PREFILL_TOL)
        vs_e = (got.float() - got_e.float()).abs().max().item()
        log(f"{lbl} paged_prefill_attention_single bs {bs}, table poisoned "
            f"past the run's last block: max abs err {err} (row worst "
            f"{rel:.5f}); max |H - E| on one run {vs_e}")
        if not torch.equal(got, got_e):
            raise AssertionError(f"H differs from E on one run (bs {bs})")
        res = timed(
            "paged_prefill_attention_single",
            "vattention_tpu_torch/csrc/paged_prefill_attention.cu",
            "vattention_tpu/ops/paged_attention.py:32", err,
            lambda: paged_attention.paged_prefill_attention_single(
                *hargs, **hkw),
            lambda: paged_attention.paged_prefill_attention_single_plain(
                *hargs, **hkw),
            paged_attention.block_rows(table, 4096, bs),
            f"chunk 512 at kv_len 4096 over {bs}-token blocks, Hq={HQ} "
            f"Hkv={HKV} D={D} bf16, {cache.dtype} K/V")
    return out + [res]


def long_context(dev, cache, pool_rows, bt, timer, randn, layer, geo=YI,
                 lbl="(a)"):
    """(a) the prefill body at the sweep's deepest prefill, chunk 2048 at
    kv_len 32768: G over 8 extents of 4096 tokens at 2048-token block
    starts, H over a seeded permutation of the pool's 16-token blocks with
    its tail poisoned; each held against its plain version (256 query
    tokens at a time) and timed beside one SDPA call on the same gathered
    K/V and beside its bound.  At falcon's geometry also kernel C at depth:
    4 slots at 16384-32768 positions over permuted 256-row blocks, held and
    timed the same way.  Logged only: the JSON line keeps (a)'s 512@4096
    shape."""
    from vattention_tpu_torch.ops import (flash_decode, flash_prefill,
                                          paged_attention)

    HQ, HKV, D = geo["HQ"], geo["HKV"], geo["D"]
    es = 2
    sm = geo["DR"] ** -0.5
    n, chunk, bs = 32768, 2048, 16
    q = randn(chunk, HQ, D)
    qinfo = torch.tensor([n - chunk, n], dtype=torch.int32, device=dev)
    pos = torch.arange(n, device=dev)
    mask = (n - chunk + torch.arange(chunk, device=dev))[:, None] \
        >= pos[None, :]
    pairs = chunk * (n - chunk) + chunk * (chunk + 1) // 2
    b_ms, b_by = bound((2 * chunk * HQ * D + n * 2 * HKV * D) * es,
                       4 * HQ * D * pairs)
    qg = q.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    starts = [10, 2, 18, 6, 14, 0, 22, 8]      # pairs of 2048-token blocks
    sr = torch.tensor([s_ * bt for s_ in starts], dtype=torch.int32,
                      device=dev)
    sc = torch.arange(9, dtype=torch.int32, device=dev) * (n // 8)
    table = np.full(n // bs + 8, 2 ** 30, np.int32)
    table[:n // bs] = np.random.default_rng(3).permutation(
        pool_rows // bs)[:n // bs]
    table = torch.from_numpy(table).to(dev)
    cases = (
        ("segment_prefill_attention (G), 8 extents",
         lambda: flash_prefill.segment_prefill_attention(
             q, cache, sr, sc, qinfo, layer, sm_scale=sm),
         lambda: flash_prefill.segment_prefill_attention_plain(
             q, cache, sr, sc, qinfo, layer, sm_scale=sm),
         flash_prefill.segment_rows(sr, sc, n)),
        ("paged_prefill_attention_single (H), 16-token blocks",
         lambda: paged_attention.paged_prefill_attention_single(
             q, cache, table, qinfo, layer, block_size=bs, sm_scale=sm),
         lambda: paged_attention.paged_prefill_attention_single_plain(
             q, cache, table, qinfo, layer, block_size=bs, sm_scale=sm),
         paged_attention.block_rows(table, n, bs)))
    for what, fn, plain, grow in cases:
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = check_attention(f"{what} at chunk {chunk}, kv_len {n}",
                                   got, ref, PREFILL_TOL)
        del got, ref
        kg = cache[layer, 0][:, grow][None]
        vg = cache[layer, 1][:, grow][None]
        ms = timer(fn)
        lib = timer(lambda: sdpa(qg, kg, vg, attn_mask=mask,
                                 enable_gqa=True))
        del kg, vg
        log(f"{lbl} {what}: chunk {chunk} at kv_len {n}, Hq={HQ} Hkv={HKV} "
            f"D={D} bf16: max abs err {err} (row worst {rel:.5f}) ms "
            f"{ms:.4f} library {lib:.4f} (SDPA, gathered K/V) bound "
            f"{b_ms:.4f} ({b_by}, {100 * b_ms / ms:.1f}%)")
    if geo is YI:
        return
    # kernel C at depth: 4 slots at 16K-32K over permuted 256-row blocks
    depths = [16384, 24576, 30000, 32768]
    sub = 256
    rows = np.stack([np.random.default_rng(4 + b).permutation(
        pool_rows // sub)[:n // sub] * sub for b in range(4)]).astype(np.int32)
    tile_rows = torch.from_numpy(rows).to(dev)
    seqlens = torch.tensor(depths, dtype=torch.int32, device=dev)
    qd = randn(4, HQ, D)
    dargs = (qd, cache, tile_rows, seqlens, layer)
    got = flash_decode.decode_attention(*dargs, sub=sub, sm_scale=sm)
    ref = flash_decode.decode_attention_plain(*dargs, sub=sub, sm_scale=sm)
    torch.cuda.synchronize()
    err, rel = check_attention("decode at depth 16K-32K", got, ref,
                               DECODE_TOL)
    kpad = torch.zeros((4, HKV, n, D), dtype=torch.bfloat16, device=dev)
    vpad = torch.zeros_like(kpad)
    for b, d in enumerate(depths):
        r = flash_decode.gather_rows(tile_rows[b], d, sub)
        kpad[b, :, :d] = cache[layer, 0][:, r]
        vpad[b, :, :d] = cache[layer, 1][:, r]
    dmask = (torch.arange(n, device=dev)[None, :]
             < seqlens[:, None])[:, None, None, :]
    c_ms, c_by = bound(sum(depths) * 2 * HKV * D * es + 2 * 4 * HQ * D * es,
                       4 * HQ * D * sum(depths))
    ms = timer(lambda: flash_decode.decode_attention(*dargs, sub=sub,
                                                     sm_scale=sm))
    lib = timer(lambda: sdpa(qd[:, :, None], kpad, vpad, attn_mask=dmask,
                             enable_gqa=True))
    del kpad, vpad
    log(f"{lbl} decode_attention at depth, B=4 depths {depths}, Hq={HQ} "
        f"Hkv={HKV} D={D} bf16: max abs err {err} (row worst {rel:.5f}) ms "
        f"{ms:.4f} library {lib:.4f} (SDPA, gathered K/V) bound {c_ms:.5f} "
        f"({c_by}, {100 * c_ms / ms:.1f}%), at head dim {geo['DR']} "
        f"{c_ms * geo['DR'] / D:.5f}")


# --------------------------------------------------------------------- #
# (a w) the sliding window at Mistral-7B's attention geometry
# --------------------------------------------------------------------- #
def window_phase(dev, arena=torch.bfloat16):
    """(a w) over an arena of dtype ``arena`` (bf16, or 1-byte as in (a)):
    B at chunk 512 to kv_len 16384 and C at B = 8 to depth 16384, under
    mistral-7b's window, each held against its windowed plain version; E
    (256-token blocks), G (8 extents), H and F on the same rows, expected
    to equal B, B, E and B then C bit for bit; B and C under a window past
    every depth, expected to equal their unwindowed bits; the windowed
    edge cases of both bodies.  Each kernel is timed beside its plain
    version, one SDPA call on the gathered K/V (a boolean window mask for
    prefill, the last ``window`` rows for decode) and its bound over the
    attended pairs and rows; B and C also beside their unwindowed times at
    4096 and 16384.  Returns the kernels' results."""
    from vattention_tpu_torch.ops import (flash_decode, flash_prefill,
                                          paged_attention, pod_fused)
    from vattention_tpu_torch.ops.utils import quantize_kv

    HQ, HKV, D = MISTRAL["HQ"], MISTRAL["HKV"], MISTRAL["D"]
    W, N, chunk, bs = WINDOW, 16384, 512, 256
    dt = torch.bfloat16
    es = 2
    main = arena == dt
    kv_tag = "" if main else QUANT[arena][1]
    suffix = f"[{kv_tag + ' ' if kv_tag else ''}w{W}]"
    lbl = f"(a w{' ' + kv_tag if kv_tag else ''})"
    step = INT8_STEP if arena == torch.int8 else None
    sm = D ** -0.5 * (step or 1.0)
    out_scale = step or 1.0
    check = functools.partial(check_attention, scale=out_scale)
    layer = 0
    R = 36 * 2048
    randn, i32 = seeded(dev, 8)
    cache = randn(1, 2, HKV, R, D)
    if not main:
        cache = quantize_kv(cache, arena, step)
    kv_es = cache.element_size()
    timer = Timer(dev)
    rng = np.random.default_rng(8)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # the prefill run: 8 extents of 2048 tokens in no order
    starts = rng.permutation(R // 2048)[:8]
    pos = torch.arange(N, device=dev)
    prow = torch.from_numpy(starts).to(dev).long()[pos // 2048] * 2048 \
        + pos % 2048
    q = randn(chunk, HQ, D)
    qt_run = i32([[0, i] for i in range(chunk // 128)])

    def run(q_start, kv_len):
        return i32([[q_start, kv_len]])

    trows = prow[::bs].to(torch.int32)[None].contiguous()
    qinfo = run(N - chunk, N)
    b_args = (q, cache, qt_run, qinfo, trows, layer)
    bkw = dict(sub=bs, pad_tile=128, sm_scale=sm)
    # the decode batch: each slot over a seeded permutation of 256-row blocks
    depths = [0, 1, 17, 2048, W - 1, W + 1, 8192, N]
    seqlens = i32(depths)
    drows = i32(np.stack([rng.permutation(R // bs)[:N // bs] * bs
                          for _ in depths]))
    qd = randn(len(depths), HQ, D)
    c_args = (qd, cache, drows, seqlens, layer)
    ckw = dict(sub=bs, sm_scale=sm)

    b = flash_prefill.prefill_attention(*b_args, **bkw, window=W)
    c = flash_decode.decode_attention(*c_args, **ckw, window=W)
    b_ref = flash_prefill.prefill_attention_plain(*b_args, **bkw, window=W)
    c_ref = flash_decode.decode_attention_plain(*c_args, **ckw, window=W)
    torch.cuda.synchronize()
    err_b, rel_b = check(f"{lbl} B", b, b_ref, PREFILL_TOL)
    if not torch.isfinite(c).all() or c[0].abs().max().item() != 0.0:
        raise AssertionError(f"{lbl} decode: the seqlen-0 slot is not zero")
    err_c, rel_c = 0.0, 0.0
    for i, n in enumerate(depths):
        if n:
            e, r = check(f"{lbl} C slot {i} at depth {n}", c[i:i + 1],
                         c_ref[i:i + 1], DECODE_TOL)
            err_c, rel_c = max(err_c, e), max(rel_c, r)
    # a window past every depth: the unwindowed bits
    b_none = flash_prefill.prefill_attention(*b_args, **bkw)
    c_none = flash_decode.decode_attention(*c_args, **ckw)
    b_past = flash_prefill.prefill_attention(*b_args, **bkw, window=N)
    c_past = flash_decode.decode_attention(*c_args, **ckw, window=N)
    torch.cuda.synchronize()
    if not (torch.equal(b_past, b_none) and torch.equal(c_past, c_none)):
        raise AssertionError(f"{lbl} a window past every depth changes B's "
                             "or C's bits")
    log(f"{lbl} B (chunk {chunk} at kv_len {N}, window {W}): max abs err "
        f"{err_b} (row worst {rel_b:.5f}); C (B=8, depths {depths}): max "
        f"abs err {err_c} (row worst {rel_c:.5f}); window {N} equals no "
        "window bit for bit in B and C")

    # E, G, H and F on the same rows
    table = (prow[::bs] // bs).to(torch.int32)[None].contiguous()
    ekw = dict(block_size=bs, pad_tile=128, sm_scale=sm, window=W)
    e = paged_attention.paged_prefill_attention(q, cache, qt_run, qinfo,
                                                table, layer, **ekw)
    seg_row = i32(starts * 2048)
    seg_cum = i32(np.arange(9) * 2048)
    qinfo1 = qinfo[0].clone()
    g_args = (q, cache, seg_row, seg_cum, qinfo1, layer)
    h_args = (q, cache, table[0].clone(), qinfo1, layer)
    hkw = dict(block_size=bs, sm_scale=sm, window=W)
    g = flash_prefill.segment_prefill_attention(*g_args, sm_scale=sm,
                                                window=W)
    h = paged_attention.paged_prefill_attention_single(*h_args, **hkw)
    f_args = (q, qd, cache, qt_run, qinfo, trows, drows, seqlens, layer)
    fkw = dict(sub=bs, pad_tile=128, sm_scale=sm, window=W)
    f_p, f_d = pod_fused.pod_attention(*f_args, **fkw)
    torch.cuda.synchronize()
    for what, got, want in (("E = B", e, b), ("G = B", g, b), ("H = E", h, e),
                            ("F = B", f_p, b), ("F = C", f_d, c)):
        if not torch.equal(got, want):
            raise AssertionError(f"{lbl} {what} fails: "
                                 f"{(got.float() - want.float()).abs().max()}")
    errs = {}
    for name, got, ref in (
            ("E", e, paged_attention.paged_prefill_attention_plain(
                q, cache, qt_run, qinfo, table, layer, **ekw)),
            ("G", g, flash_prefill.segment_prefill_attention_plain(
                *g_args, sm_scale=sm, window=W)),
            ("H", h, paged_attention.paged_prefill_attention_single_plain(
                *h_args, **hkw))):
        errs[name] = check(f"{lbl} {name}", got, ref, PREFILL_TOL)[0]
    log(f"{lbl} E, G, H and F on B's rows and C's slots: E = B, G = B, "
        f"H = E, F = B then C bit for bit; max abs err against the plain "
        f"versions E {errs['E']}, G {errs['G']}, H {errs['H']}")

    # yardsticks and bounds over the attended work
    q_pos = N - chunk + torch.arange(chunk, device=dev)
    lo = N - chunk - W + 1
    kpos = torch.arange(lo, N, device=dev)
    mask = (kpos[None, :] <= q_pos[:, None]) & (kpos[None, :]
                                                > q_pos[:, None] - W)
    pairs = int(mask.sum().item())
    kg = cache[layer, 0][:, prow[lo:]][None].to(dt)
    vg = cache[layer, 1][:, prow[lo:]][None].to(dt)
    qg = q.transpose(0, 1)[None]
    pre_bytes = 2 * chunk * HQ * D * es + (N - lo) * 2 * HKV * D * kv_es
    b_ms, b_by = bound(pre_bytes, 4 * HQ * D * pairs)
    rows_att = sum(min(n, W) for n in depths)
    dec_bytes = rows_att * 2 * HKV * D * kv_es + 2 * 8 * HQ * D * es + 8 * 4
    c_ms, c_by = bound(dec_bytes, 4 * HQ * D * rows_att)
    f_ms, f_by = bound(pre_bytes + dec_bytes,
                       4 * HQ * D * (pairs + rows_att))
    kpad = torch.zeros((8, HKV, W, D), dtype=dt, device=dev)
    vpad = torch.zeros_like(kpad)
    for i, n in enumerate(depths):
        if n:
            p_ = torch.arange(max(0, n - W), n, device=dev)
            r_ = drows[i].long()[p_ // bs] + p_ % bs
            kpad[i, :, :len(p_)] = cache[layer, 0][:, r_]
            vpad[i, :, :len(p_)] = cache[layer, 1][:, r_]
    dmask = (torch.arange(W, device=dev)[None, :]
             < torch.tensor([min(n, W) for n in depths],
                            device=dev)[:, None])[:, None, None, :]

    def pre_lib():
        return sdpa(qg, kg, vg, attn_mask=mask, enable_gqa=True)

    def dec_lib():
        return sdpa(qd[:, :, None], kpad, vpad, attn_mask=dmask,
                    enable_gqa=True)

    shape_b = (f"chunk {chunk} at kv_len {N}, window {W}, Hq={HQ} Hkv={HKV} "
               f"D={D} bf16, {cache.dtype} K/V")
    results = []

    def add(name, source, replaces, err, fn, plain, lib, bms, bby, shape):
        res = dict(name=name + suffix, route="cuda", source=source,
                   replaces=replaces, max_abs_err=err, ms=timer(fn),
                   plain_ms=timer(plain, iters=3),
                   library_ms=None if lib is None else timer(lib),
                   bound_ms=bms, bound_by=bby, shape=shape)
        results.append(res)
        lib_s = "-" if lib is None else f"{res['library_ms']:.4f}"
        log(f"{lbl} {res['name']}: {shape}: ms {res['ms']:.4f} plain "
            f"{res['plain_ms']:.4f} library {lib_s} bound {bms:.4f} ({bby}, "
            f"{100 * bms / res['ms']:.1f}%)")

    add("prefill_attention", "vattention_tpu_torch/csrc/prefill_attention.cu",
        "vattention_tpu/ops/flash_prefill.py:273", err_b,
        lambda: flash_prefill.prefill_attention(*b_args, **bkw, window=W),
        lambda: flash_prefill.prefill_attention_plain(*b_args, **bkw,
                                                      window=W),
        pre_lib, b_ms, b_by, shape_b)
    add("decode_attention", "vattention_tpu_torch/csrc/decode_attention.cu",
        "vattention_tpu/ops/flash_decode.py:157", err_c,
        lambda: flash_decode.decode_attention(*c_args, **ckw, window=W),
        lambda: flash_decode.decode_attention_plain(*c_args, **ckw,
                                                    window=W),
        dec_lib, c_ms, c_by,
        f"B=8 depths {depths}, window {W}, sub {bs}, Hq={HQ} Hkv={HKV} "
        f"D={D} bf16, {cache.dtype} K/V")
    add("paged_prefill_attention",
        "vattention_tpu_torch/csrc/paged_prefill_attention.cu",
        "vattention_tpu/ops/paged_attention.py:107", errs["E"],
        lambda: paged_attention.paged_prefill_attention(
            q, cache, qt_run, qinfo, table, layer, **ekw),
        lambda: paged_attention.paged_prefill_attention_plain(
            q, cache, qt_run, qinfo, table, layer, **ekw),
        pre_lib, b_ms, b_by, shape_b + f", {bs}-token blocks")
    add("pod_attention", "vattention_tpu_torch/csrc/pod_attention.cu",
        "vattention_tpu/ops/pod_fused.py:341", max(err_b, err_c),
        lambda: pod_fused.pod_attention(*f_args, **fkw),
        lambda: pod_fused.pod_attention_plain(*f_args, **fkw), None,
        f_ms, f_by, shape_b + f" + B=8 depths {depths}")
    add("segment_prefill_attention",
        "vattention_tpu_torch/csrc/prefill_attention.cu",
        "vattention_tpu/ops/flash_prefill.py:178", errs["G"],
        lambda: flash_prefill.segment_prefill_attention(*g_args, sm_scale=sm,
                                                        window=W),
        lambda: flash_prefill.segment_prefill_attention_plain(
            *g_args, sm_scale=sm, window=W),
        pre_lib, b_ms, b_by, shape_b + ", 8 extents")
    add("paged_prefill_attention_single",
        "vattention_tpu_torch/csrc/paged_prefill_attention.cu",
        "vattention_tpu/ops/paged_attention.py:32", errs["H"],
        lambda: paged_attention.paged_prefill_attention_single(*h_args,
                                                               **hkw),
        lambda: paged_attention.paged_prefill_attention_single_plain(
            *h_args, **hkw),
        pre_lib, b_ms, b_by, shape_b + f", {bs}-token blocks")
    del kg, vg, kpad, vpad

    # the windowed walk against the unwindowed one at 4096 and 16384
    b4 = (q, cache, qt_run, run(4096 - chunk, 4096), trows, layer)
    clip = i32([min(n, W) for n in depths])
    t = {"B w": results[0]["ms"],
         "B 4096": timer(lambda: flash_prefill.prefill_attention(*b4, **bkw)),
         "B 16384": timer(lambda: flash_prefill.prefill_attention(*b_args,
                                                                  **bkw)),
         "C w": results[1]["ms"],
         "C 4096": timer(lambda: flash_decode.decode_attention(
             qd, cache, drows, clip, layer, **ckw)),
         "C 16384": timer(lambda: flash_decode.decode_attention(*c_args,
                                                                **ckw))}
    for k_ in ("B", "C"):
        w_, a_, z_ = t[f"{k_} w"], t[f"{k_} 4096"], t[f"{k_} 16384"]
        verdict = ("near the 4096 time: the tiles before the window are "
                   "skipped" if abs(w_ - a_) < abs(w_ - z_) else
                   "nearer the 16384 time: the tiles before the window "
                   "are NOT skipped")
        what = (f"chunk {chunk}" if k_ == "B" else
                "B=8, depths clipped to the window for 4096")
        log(f"{lbl} {k_} ({what}): window {W} at 16384 {w_:.4f} ms; no "
            f"window at 4096 {a_:.4f} ms, at 16384 {z_:.4f} ms: {verdict}")

    for w in EDGE_WINDOWS:
        e1, r1 = check_prefill_edges(cache, HQ, layer, sm_scale=sm,
                                     out_scale=out_scale, window=w)
        e2, r2 = check_decode_edges(cache, layer, sm_scale=sm,
                                    out_scale=out_scale, window=w)
        log(f"{lbl} edge cases under window {w}: prefill body max abs err "
            f"{e1} (row worst {r1:.5f}), E = B, F = B and C, G = B, H = E "
            f"bit for bit; decode body (depths {edge_depths(w)}) max abs err "
            f"{e2} (row worst {r2:.5f}), idle slots exactly zero")
    del cache
    torch.cuda.empty_cache()
    return results


def relocation_row(cache, src, dst, bt, timer, suffix, shape):
    """Kernel D's row for the plan ``src``, ``dst`` (int32 on the card) on
    ``cache``: its time beside its plain version's, one ``copy_`` per move
    of the block slices (the library call), a ``copy_`` of a contiguous
    buffer of its bytes (``copy_ms``, the practical ceiling) and its bytes
    bound.  The caller has held D's result against the plain version's."""
    from vattention_tpu_torch.ops import arena_copy

    n = src.numel()
    n_bytes = relocation_bytes(cache.shape, bt, n, cache.element_size())
    pair = torch.empty(2, n_bytes // 2, dtype=torch.uint8,
                       device=cache.device)
    b_ms, b_by = bound(n_bytes, 0)
    row = dict(
        name="arena_relocate" + suffix, route="cuda",
        source="vattention_tpu_torch/csrc/arena_relocate.cu",
        replaces="vattention_tpu/ops/arena_copy.py:59",
        max_abs_err=0.0,
        ms=timer(lambda: arena_copy.arena_relocate(cache, src, dst, n, bt)),
        plain_ms=timer(lambda: arena_copy.arena_relocate_plain(
            cache, src, dst, n, bt)),
        library_ms=timer(slice_copies(cache, src.tolist(), dst.tolist(),
                                      bt)),
        copy_ms=timer(lambda: pair[1].copy_(pair[0])),
        bound_ms=b_ms, bound_by=b_by, shape=shape)
    del pair
    return row


# --------------------------------------------------------------------- #
# dense references (plain PyTorch, float32)
# --------------------------------------------------------------------- #
def attend_blocked(q, k, v, sm_scale, window, block=1024):
    """Causal attention of ``mha_reference`` (float32) by blocks of
    ``block`` queries, each over the keys it can see (from ``q - window +
    1`` under a window), so an 8K x 8K score tensor is never formed."""
    from vattention_tpu_torch.ops.attention_ref import mha_reference

    outs = []
    for a in range(0, q.shape[0], block):
        lo = max(0, a - window + 1) if window else 0
        outs.append(mha_reference(q[a:a + block], k[lo:a + block],
                                  v[lo:a + block], causal=True, q_start=a - lo,
                                  sm_scale=sm_scale, window=window))
    return torch.cat(outs)


def dense_logits(model, params, ids, dev, arena=None, dtype=torch.float32,
                 unwindowed=False, block=1024):
    """Last-position logits of a full-recompute forward in ``dtype``
    (float32, or the model's bfloat16 arithmetic), attention in float32
    (by blocks of ``block`` queries) under the model's sliding window
    (none with ``unwindowed``); with a 1-byte ``arena`` dtype, K and V go
    through the arena's round trip (quantized as kernel A stores them,
    widened, times the int8 step).  Falcon's layer (``parallel_attn``) is
    written here from torch's own layer_norm and tanh GELU: attention and
    the MLP from one LayerNorm, ``x + (o + mlp)``.  A qkv bias (qwen) is
    added to the projection.  The norms and activations are the plain
    ones (``layers/``), never the kernels."""
    from vattention_tpu_torch.model_executor.layers.activation import (
        silu_and_mul)
    from vattention_tpu_torch.model_executor.layers.layernorm import rms_norm
    from vattention_tpu_torch.ops.utils import quantize_kv

    step = INT8_STEP if arena == torch.int8 else None
    window = None if unwindowed else model.arch.sliding_window

    def round_trip(x):
        if arena is None:
            return x
        return quantize_kv(x, arena, step).float() * (step or 1.0)

    a, D = model.arch, model.head_dim
    lp = params["layers"]
    T = len(ids)
    x = params["embed"][torch.tensor(ids, device=dev)].to(dtype)
    positions = torch.arange(T, device=dev)
    F = torch.nn.functional

    def ln(x, w, b):   # falcon's LayerNorm: float32, eps 1e-5
        return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                            1e-5).to(dtype)

    for l in range(a.num_layers):
        if a.parallel_attn:
            h = ln(x, lp["input_norm"][l], lp["input_norm_b"][l])
        else:
            h = rms_norm(x, lp["input_norm"][l].to(dtype), a.rms_norm_eps)
        qkv = h @ lp["qkv_w"][l].to(dtype)
        if "qkv_b" in lp:
            qkv = qkv + lp["qkv_b"][l].to(dtype)
        q = qkv[:, :model.hq * D].reshape(T, model.hq, D)
        k = qkv[:, model.hq * D:(model.hq + model.hkv) * D].reshape(
            T, model.hkv, D)
        v = qkv[:, (model.hq + model.hkv) * D:].reshape(T, model.hkv, D)
        q, k = model.rope(positions, q, k)
        k, v = round_trip(k), round_trip(v)
        attn = attend_blocked(q, k, v, model.sm_scale, window,
                              block).to(dtype)
        o = attn.reshape(T, model.hq * D) @ lp["o_w"][l].to(dtype)
        if a.parallel_attn:
            up = (h @ lp["up_w"][l].to(dtype)).float()
            mlp = F.gelu(up, approximate="tanh").to(dtype) \
                @ lp["down_w"][l].to(dtype)
            x = x + (o + mlp)
            continue
        x = x + o
        h2 = rms_norm(x, lp["post_norm"][l].to(dtype), a.rms_norm_eps)
        x = x + silu_and_mul(h2 @ lp["gate_up_w"][l].to(dtype)) \
            @ lp["down_w"][l].to(dtype)
    if a.parallel_attn:
        x = F.layer_norm(x.float(), (x.shape[-1],),
                         params["final_norm"].float(),
                         params["final_norm_b"].float(), 1e-5)
    else:
        x = rms_norm(x.float(), params["final_norm"].float(), a.rms_norm_eps)
    return x[-1] @ params["lm_head"].float()


def fresh_metrics():
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None


# --------------------------------------------------------------------- #
# (b) f32 parity
# --------------------------------------------------------------------- #
def parity_phase(dev, backend, tag, arena=None, kernels=(),
                 model="tiny-llama-debug", async_execution=True):
    """(b): greedy tokens of the f32 tiny ``model`` on ``backend`` against
    the dense reference's (under the model's window, if any: (b w) serves
    tiny-mistral-debug); with a 1-byte ``arena`` (b8) the engine serves
    ``kv_quant`` and the reference takes the arena's round trip; with
    ``async_execution=False`` (b sync) the engine serves synchronously,
    each step resolved before the next (still a replay of its graph).
    Returns the launches of ``kernels``, zeroed just before serving."""
    from vattention_tpu_torch import LLMEngine

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model=model, dtype="float32", attention_backend=backend,
        scheduler_type="sarathi", max_model_len=512, max_batch_size=4,
        max_num_seqs=4, chunk_size=128, gpu_memory_utilization=0.9,
        kv_quant=QUANT[arena][0] if arena is not None else "none",
        enable_async_execution=async_execution)
    if engine.async_execution != async_execution:
        raise AssertionError(f"({tag}) the engine ignored "
                             f"enable_async_execution={async_execution}")
    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([200, 37])}
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    got = serve(engine, [(s, p, 6) for s, p in prompts.items()])
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels}
    runner = engine.worker.model_runner
    kv = str(engine.worker.cache_engine.kv_cache.dtype)
    for seq_id, ids in prompts.items():
        ids = list(ids)
        for _ in range(6):
            ids.append(int(torch.argmax(dense_logits(
                runner.model, runner.params, ids, dev, arena))))
        expect = ids[len(prompts[seq_id]):]
        if got[seq_id] != expect:
            raise AssertionError(
                f"({tag}) {seq_id}: engine {got[seq_id]} != dense {expect}")
        log(f"({tag}) f32 parity, {model}, {backend}, {kv} arena, "
            f"{seq_id}: engine == dense {expect}")
    mode = "async" if async_execution else "sync"
    log(f"({tag}) served {mode}, {len(runner.graphs)} step graphs "
        f"captured")
    if not runner.graphs:
        raise AssertionError(f"({tag}) no step was captured")
    pod_steps = getattr(runner.backend, "pod_steps", None)
    if pod_steps is not None:
        log(f"({tag}) steps through kernel F: {pod_steps}")
        if pod_steps <= 0:
            raise AssertionError(f"({tag}) no step ran through kernel F")
    if counts:
        log(f"({tag}) launches: " + ", ".join(f"{s_} {n}"
                                              for s_, n in counts.items()))
    engine.cleanup()
    return counts


# --------------------------------------------------------------------- #
# (c) full-width serving
# --------------------------------------------------------------------- #
def serving_phase(dev, kernels, backend, tag, required, idle,
                  reference=None, arena=None):
    """Serve the 8 requests through a fresh full-width engine on
    ``backend``; the kernels named in ``required`` must launch in that run
    and those in ``idle`` must not.  Returns the launch counts and the
    tokens; with ``reference`` (another run's tokens) prints how many
    agree.  With a 1-byte ``arena`` dtype (c8) the engine serves
    ``kv_quant``, the dense reference takes the arena's round trip, and no
    profile follows."""
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="yi-6b-200k", dtype="bfloat16", attention_backend=backend,
        scheduler_type="sarathi", chunk_size=512, max_model_len=8192,
        max_batch_size=8, max_num_seqs=8, seed=0,
        kv_quant=QUANT[arena][0] if arena is not None else "none")
    rng = np.random.default_rng(0)
    lens = rng.integers(1024, 4097, 8)
    requests = [(f"s{i}", rng.integers(1, 64000, int(n)).tolist(), 32)
                for i, n in enumerate(lens)]
    cache_engine = engine.worker.cache_engine

    # the main path: the 8 requests, with the launch counts read around it
    stats = {}
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = serve(engine, requests, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.symbol: k.launches for k in kernels}
    moves = getattr(cache_engine, "pending_moves", 0)
    n_gen = sum(len(v) for v in out.values())
    n_prompt = int(lens.sum())
    if len(out) != 8 or n_gen != 8 * 32:
        raise AssertionError(
            f"({tag}) served {len(out)} requests, {n_gen} tokens")
    log(f"({tag}) {backend}: served {len(out)} requests in {stats['steps']} "
        f"steps: prompt tokens {n_prompt} (lengths {lens.tolist()}), "
        f"generated tokens {n_gen}, wall {wall:.3f} s, "
        f"{n_gen / wall:.2f} generated tok/s, "
        f"{(n_prompt + n_gen) / wall:.2f} processed tok/s")
    log(f"({tag}) arena {cache_engine.kv_cache.dtype}, "
        f"{cache_engine.block_tokens} tokens per block"
        + (" (one 2 MB page)" if backend.endswith("2mb") else ""))
    log(f"({tag}) launches in the 8-request run: "
        + ", ".join(f"{s} {n}" for s, n in counts.items())
        + f"; the allocator planned {moves} block moves")
    if any(counts[k.symbol] <= 0 for k in required):
        raise AssertionError(f"({tag}) a kernel never launched: {counts}")
    if any(counts[k.symbol] > 0 for k in idle):
        raise AssertionError(f"({tag}) a kernel of another path launched: "
                             f"{counts}")
    # kernel D runs once per non-empty relocation plan.  A request here
    # spans at most 4 blocks of 2048 tokens (max_model_len 8192) and may
    # hold 8 extents, so the allocator grows it without a copy and D has
    # nothing to do; phase (a) holds D at this path's shapes.  The paged
    # pool never relocates.
    relocate = ARENA_RELOCATE.symbol
    if (counts[relocate] > 0) != (moves > 0):
        raise AssertionError(f"({tag}) {moves} block moves but {relocate} "
                             f"launched {counts[relocate]} times")
    if reference is not None:
        same = sum(a == b for s in out for a, b in zip(out[s], reference[s]))
        log(f"({tag}) {same} of {n_gen} generated tokens equal (c)'s "
            f"({same / n_gen:.3f}; information only)")

    # 2 short prompts: first token against a dense f32 reference
    short = [(f"p{i}", rng.integers(1, 64000, n).tolist(), 1)
             for i, n in enumerate((64, 200))]
    first = serve(engine, short)

    runner = engine.worker.model_runner
    for seq_id, ids, _ in short:
        tok = first[seq_id][0]
        # a 1-byte arena's reference runs the model's own bf16 arithmetic:
        # rounding K/V to e4m3 turns the small bf16-against-f32 differences
        # of K/V into whole e4m3 steps on the values near a rounding
        # boundary, so a float32 forward quantizes other values than the
        # engine (its gap is printed, not held)
        ref_dtype = torch.float32 if arena is None else torch.bfloat16
        logits = dense_logits(runner.model, runner.params, ids, dev, arena,
                              ref_dtype)
        gap = float(logits.max() - logits[tok])
        extra = ""
        if arena is not None:
            f32 = dense_logits(runner.model, runner.params, ids, dev, arena)
            extra = (f"; float32 reference top {int(f32.argmax())}, gap "
                     f"{float(f32.max() - f32[tok]):.5f} (information only)")
        log(f"({tag}) {seq_id} ({len(ids)} tokens): engine token {tok}, "
            f"dense {'bf16' if arena is not None else 'f32'} top "
            f"{int(logits.argmax())}, logit gap {gap:.5f} "
            f"(tolerance {LOGIT_GAP_TOL}){extra}")
        if not gap <= LOGIT_GAP_TOL:
            raise AssertionError(f"({tag}) {seq_id}: logit gap {gap}")
    if arena is None:
        captured_phase(engine, rng, f"h {tag}")
        op_rows(engine, tag)
        profile_serving(engine, rng, tag)
    engine.cleanup()
    return counts, out


def captured_phase(engine, rng, tag):
    """(h) The captured step on a full-width engine that has served: the
    first replay of each greedy signature two requests meet (a prompt's
    steps, mixed steps, decodes) against the eager step on the same inputs
    (samples, the arena rows the step writes, the token buffer: bit for
    bit); the engine's graphs, their capture times and the port kernels'
    launches per replay; then whole async steps (a prompt's, a mixed and a
    decode step) under ``torch.cuda.set_sync_debug_mode("error")``."""
    runner = engine.worker.model_runner
    vocab = runner.model.arch.vocab_size
    reqs = [(f"h{i}", rng.integers(1, vocab, n).tolist(), 4)
            for i, n in enumerate((700, 1100))]
    checked = check_replays(engine, reqs, serve)
    for sig, same in checked.items():
        log(f"({tag}) signature (n_pre, pod, sampler) {sig}: replay == "
            "eager step: " + ", ".join(f"{k} {v}" for k, v in same.items()))
        if not all(same.values()):
            raise AssertionError(f"({tag}) {sig}: the replay differs from the "
                                 f"eager step: {same}")
    met = {(sig[0] > 0, sig[1]) for sig in checked}
    want = {(False, False), (True, runner.backend.__class__.__name__
                             == "PodAttentionBackend")}
    if not want <= met:
        raise AssertionError(f"({tag}) checked signatures {sorted(checked)} "
                             "miss the decode-only or the mixed step")
    report = graph_report(runner)
    # per replay: A once per layer; two add_rms_norm a layer and the final
    # norm's, one silu_and_mul a layer (falcon: one add_layer_norm a layer
    # and the final norm's, one gelu_new a layer); no other norm kernel
    L = runner.model.arch.num_layers
    if runner.model.parallel_attn:
        per_replay = {"vattn_add_layer_norm": L + 1, "vattn_gelu_new": L,
                      "vattn_add_rms_norm": 0, "vattn_silu_and_mul": 0}
    else:
        per_replay = {"vattn_add_rms_norm": 2 * L + 1,
                      "vattn_silu_and_mul": L, "vattn_add_layer_norm": 0,
                      "vattn_gelu_new": 0}
    per_replay["vattn_rope_kv_append"] = L
    for r in report:
        got = {k: r["launches"].get(k, 0) for k in per_replay}
        if got != per_replay:
            raise AssertionError(f"({tag}) graph {r['signature']} launches "
                                 f"{got} per replay, expected {per_replay}")
    log(f"({tag}) every graph launches, per replay, " + ", ".join(
        f"{k} {n}" for k, n in per_replay.items()))
    log(f"({tag}) {len(report)} graphs captured: " + "; ".join(
        f"{r['signature']} in {r['capture_s']:.3f} s, "
        f"{sum(r['launches'].values())} port-kernel launches per replay ("
        + ", ".join(f"{k} {n}" for k, n in r["launches"].items()) + ")"
        for r in report))
    a_launches = check_step_does_not_sync(engine)
    n_layers = runner.model.arch.num_layers
    log(f"({tag}) whole async steps under torch.cuda.set_sync_debug_mode("
        f"'error'): a prompt's, a mixed and a decode step ran without a "
        f"stream synchronization; kernel A launches per step {a_launches}")
    if a_launches != [n_layers] * 3:
        raise AssertionError(f"({tag}) kernel A launched {a_launches} times "
                             "per step, not once per layer")


def decode_step_phase():
    """(h step): the captured decode step's device ms per replay on
    yi-6b-200k-l16 at batch 8 (``scripts/profile_decode_step``)."""
    from vattention_tpu_torch.scripts import profile_decode_step

    t0 = time.perf_counter()
    got = profile_decode_step.main(["--model", "yi-6b-200k-l16",
                                    "--batch", "8"])
    if not got["graph"]:
        raise AssertionError("(h step) the decode step ran without a graph")
    log(f"(h step) yi-6b-200k-l16, fa_vattn_256kb, batch 8, ctx 1024: the "
        f"captured decode step {1e3 * got['device_step_s']:.4f} ms per "
        f"replay (30 replays), engine.step() "
        f"{1e3 * got['engine_step_s']:.4f} ms, input staging "
        f"{1e3 * got['prepare_s']:.4f} ms; {time.perf_counter() - t0:.1f} s")


def op_rows(engine, tag):
    """The op profiler's rows (``BaseWorker.profile_op_level``: CUDA events
    around 8 calls of each op at the engine's serving shapes, ctx 1024);
    every row must be timed."""
    ops = engine.worker.profile_op_level()
    log(f"({tag}) op rows, ms per call at batch 8, ctx 1024: " + ", ".join(
        f"{k} {1e3 * v:.4f}" for k, v in ops.items()))
    if "attn_rope" in ops or not all(v > 0 for v in ops.values()) or not {
            "attn_prefill", "attn_decode", "attn_kv_cache_save"} <= set(ops):
        raise AssertionError(f"({tag}) op rows: {ops}")


def profile_serving(engine, rng, tag, n=4, prompt=2048):
    """Where the serving time goes: ``n`` requests of ``prompt`` tokens and
    16 greedy tokens under torch.profiler (``serving_profile.
    profile_window``): device time by kernel family, the device's busy
    share of the wall time (one stream, no overlap), kernel launches and
    cudaStreamSynchronize calls per step, and the rope and KV append's
    device time."""
    vocab = engine.worker.model_runner.model.arch.vocab_size
    reqs = [(f"t{i}", rng.integers(1, vocab, prompt).tolist(), 16)
            for i in range(n)]
    profile_window(engine, reqs, tag)


# --------------------------------------------------------------------- #
# (f) the kernel-level A/B entry points
# --------------------------------------------------------------------- #
def quant_sweeps(kernels):
    """(f) on 1-byte arenas: kernel_sweep --check with an e4m3 arena at its
    default ctx 1024-32768 and batch 16 (C's time against the 1-byte bytes
    bound: batch x ctx x 2 x Hkv x D bytes over 3.35 TB/s), then with an
    int8 arena at ctx 1024 and 4096.  Returns the launches of ``kernels``
    (G, H) in each sweep, zeroed just before it."""
    from vattention_tpu_torch.microbenchmarks import kernel_sweep

    out = {}
    for kv, ctx in (("fp8", []), ("int8", ["--ctx", "1024", "4096"])):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        log(f"(f) kernel_sweep --kv-dtype {kv} --check {' '.join(ctx)}")
        args = kernel_sweep.parser().parse_args(
            ["--kv-dtype", kv, "--check", *ctx])
        rows = kernel_sweep.sweep(args)
        torch.cuda.synchronize()
        counts = {k.symbol: k.launches for k in kernels}
        out[QUANT[kernel_sweep.KV_DTYPES[kv]][1]] = counts
        for phase, kernel, c, ms, gbps in rows:
            if phase == "decode" and kernel == "vattn_contig":
                b_ms, _ = bound(args.batch * c * 2 * args.kv_heads
                                * args.head_dim, 0)
                log(f"(f) {kv} decode sweep: C at batch {args.batch}, ctx "
                    f"{c}: {ms:.4f} ms, {gbps:.0f} GB/s, "
                    f"{100 * b_ms / ms:.1f}% of the 1-byte bytes bound "
                    f"{b_ms:.4f} ms")
        log(f"(f) launches in the {kv} sweep: " + ", ".join(
            f"{s_} {n}" for s_, n in counts.items()))
        if any(n <= 0 for n in counts.values()):
            raise AssertionError(f"(f) a kernel never launched: {counts}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def harness_phase(kernels):
    """Run the four harnesses at Yi-6B's attention geometry (their
    defaults) on the card; ``kernels`` (G, H) have their launch counts
    zeroed just before and read just after.  The sweep and the probe run
    with ``--check``: each G, H and C output they make is held against its
    plain version on the same inputs.  Raises when a kernel disagrees with
    its plain version or with a kernel it should equal."""
    from vattention_tpu_torch.microbenchmarks import (bench_pagesize,
                                                      bench_pod,
                                                      kernel_sweep,
                                                      probe_pod_depth)

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for bs in ("256", "16"):
        log(f"(f) kernel_sweep --block-size {bs}")
        kernel_sweep.main(["--block-size", bs, "--check"])
        gc.collect()
        torch.cuda.empty_cache()
    log("(f) bench_pagesize")
    bench_pagesize.main([])
    log("(f) bench_pod")
    bench_pod.main([])
    probes = [["--depth", str(d), "--check"]
              for d in (16384, 32768, 65536, 131072)]
    probes.append(["--depth", "16384", "--n-prefill", "3", "--check"])
    for argv in probes:
        log(f"(f) probe_pod_depth {' '.join(argv)}")
        if probe_pod_depth.main(argv) != 0:
            raise AssertionError(f"(f) probe_pod_depth {argv}: F differs "
                                 "from G then C")
    torch.cuda.synchronize()
    counts = {k.symbol: k.launches for k in kernels}
    log(f"(f) harnesses ran in {time.perf_counter() - t0:.1f} s; launches: "
        + ", ".join(f"{s} {n}" for s, n in counts.items()))
    if any(n <= 0 for n in counts.values()):
        raise AssertionError(f"(f) a kernel never launched: {counts}")
    return counts


# --------------------------------------------------------------------- #
# (g) mistral-7b past its window
# --------------------------------------------------------------------- #
def mistral_phase(dev, kernels, backend, tag, required, idle,
                  reference=None):
    """Serve 8 requests of 5000-12000 prompt tokens (all past the 4096
    window) and 32 greedy tokens through a fresh full-width mistral-7b
    engine on ``backend``; the kernels named in ``required`` must launch
    and those in ``idle`` not.  Each request's first token is held within
    LOGIT_GAP_TOL of a windowed dense reference in the model's bf16
    arithmetic, and the unwindowed reference's logits must differ from the
    windowed one's by more than that gap.  ``reference`` is (g)'s (tokens,
    windowed logits, max |windowed - unwindowed| per request): (g') holds
    its first tokens to those logits and prints how many tokens agree
    with (g)'s.  Returns (launch counts, reference)."""
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="mistral-7b", dtype="bfloat16", attention_backend=backend,
        scheduler_type="sarathi", chunk_size=512, max_model_len=16384,
        max_batch_size=8, max_num_seqs=8, seed=0)
    rng = np.random.default_rng(8)
    lens = rng.integers(5000, 12001, 8)
    vocab = engine.worker.model_runner.model.arch.vocab_size
    requests = [(f"m{i}", rng.integers(1, vocab, int(n)).tolist(), 32)
                for i, n in enumerate(lens)]
    cache_engine = engine.worker.cache_engine
    stats = {}
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = serve(engine, requests, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.symbol: k.launches for k in kernels}
    moves = getattr(cache_engine, "pending_moves", 0)
    n_gen = sum(len(v) for v in out.values())
    n_prompt = int(lens.sum())
    if len(out) != 8 or n_gen != 8 * 32:
        raise AssertionError(f"({tag}) served {len(out)} requests, "
                             f"{n_gen} tokens")
    log(f"({tag}) mistral-7b (window "
        f"{engine.worker.model_runner.model.arch.sliding_window}), {backend}: served "
        f"{len(out)} requests in {stats['steps']} steps: prompt tokens "
        f"{n_prompt} (lengths {lens.tolist()}), generated tokens {n_gen}, "
        f"wall {wall:.3f} s, {n_gen / wall:.2f} generated tok/s, "
        f"{(n_prompt + n_gen) / wall:.2f} processed tok/s; arena "
        f"{cache_engine.kv_cache.dtype}, {cache_engine.block_tokens} tokens "
        "per block")
    log(f"({tag}) launches in the 8-request run: "
        + ", ".join(f"{s_} {n}" for s_, n in counts.items())
        + f"; the allocator planned {moves} block moves")
    if any(counts[k.symbol] <= 0 for k in required):
        raise AssertionError(f"({tag}) a kernel never launched: {counts}")
    if any(counts[k.symbol] > 0 for k in idle):
        raise AssertionError(f"({tag}) a kernel of another path launched: "
                             f"{counts}")
    relocate = ARENA_RELOCATE.symbol
    if (counts[relocate] > 0) != (moves > 0):
        raise AssertionError(f"({tag}) {moves} block moves but {relocate} "
                             f"launched {counts[relocate]} times")

    runner = engine.worker.model_runner
    first = reference is None   # (g): the reference is computed here
    if first:
        windowed, delta = {}, {}
        with torch.no_grad():
            for seq_id, ids, _ in requests:
                w = dense_logits(runner.model, runner.params, ids, dev,
                                 dtype=torch.bfloat16)
                u = dense_logits(runner.model, runner.params, ids, dev,
                                 dtype=torch.bfloat16, unwindowed=True)
                windowed[seq_id] = w
                delta[seq_id] = float((w - u).abs().max())
        reference = (out, windowed, delta)
    else:
        same = sum(a == b for s_ in out for a, b in zip(out[s_],
                                                        reference[0][s_]))
        log(f"({tag}) {same} of {n_gen} generated tokens equal (g)'s "
            f"({same / n_gen:.3f}; information only)")
    _, windowed, delta = reference
    top = 0
    for seq_id, ids, _ in requests:
        tok = out[seq_id][0]
        w = windowed[seq_id]
        gap = float(w.max() - w[tok])
        top += tok == int(w.argmax())
        log(f"({tag}) {seq_id} ({len(ids)} tokens): engine token {tok}, "
            f"windowed dense bf16 top {int(w.argmax())}, logit gap "
            f"{gap:.5f} (tolerance {LOGIT_GAP_TOL}); max |windowed - "
            f"unwindowed| reference logit {delta[seq_id]:.5f}")
        if not gap <= LOGIT_GAP_TOL:
            raise AssertionError(f"({tag}) {seq_id}: logit gap {gap}")
        if not delta[seq_id] > gap:
            raise AssertionError(f"({tag}) {seq_id}: the window moves the "
                                 f"reference by {delta[seq_id]}, not more "
                                 f"than the engine's gap {gap}")
    log(f"({tag}) first tokens equal to the windowed reference's argmax: "
        f"{top} of 8")
    if first:
        profile_serving(engine, rng, tag, n=2, prompt=6144)
    engine.cleanup()
    return counts, reference


# --------------------------------------------------------------------- #
# (q) qwen-14b at full width, cut to 4 layers: the qkv bias inside A
# --------------------------------------------------------------------- #
QWEN_LAYERS = 4
QWEN_BIAS_SCALE = 0.5   # the drawn qkv bias's std (dummy weights draw 0)


def qwen_config(root) -> str:
    """qwen-14b's config.json (its registry widths: 40 q and 40 kv heads of
    128, hidden 5120, MLP 13696, vocab 152064, a qkv bias) with
    QWEN_LAYERS layers, in a directory under ``root``."""
    from vattention_tpu_torch.config import get_model_arch

    a = get_model_arch("qwen-14b")
    path = os.path.join(root, "qwen-14b-l4")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(model_type=a.model_type,
                       num_hidden_layers=QWEN_LAYERS,
                       num_attention_heads=a.num_q_heads,
                       num_key_value_heads=a.num_kv_heads,
                       head_dim=a.head_dim, hidden_size=a.hidden_size,
                       intermediate_size=a.intermediate_size,
                       vocab_size=a.vocab_size,
                       max_position_embeddings=a.max_position_embeddings,
                       rope_theta=a.rope_theta, rms_norm_eps=a.rms_norm_eps,
                       tie_word_embeddings=a.tie_word_embeddings), f)
    return path


def qwen_phase(dev, kernels, smi, required, idle):
    """(q): qwen-14b at full width cut to QWEN_LAYERS layers (a config.json
    in a temporary directory), bf16, seed-0 dummy weights with the qkv
    bias drawn from N(0, QWEN_BIAS_SCALE^2) (the dummy draw leaves it 0),
    through LLMEngine on fa_vattn_2mb (sarathi chunk 512, max_model_len
    4096, batch 4): 4 requests of 1024-3072 prompt tokens and 16 greedy
    tokens, the launch counts zeroed just before and read just after;
    ``required`` must launch, ``idle`` not.  Each request's first token is
    held within LOGIT_GAP_TOL of a dense float32 reference's top, and for
    the first request the reference without the bias must move some logit
    by more than that tolerance (so a dropped bias would show).  Returns
    the launch counts."""
    import shutil
    import tempfile

    from vattention_tpu_torch import LLMEngine

    root = tempfile.mkdtemp(prefix="vattn-qwen-")
    try:
        fresh_metrics()
        engine = LLMEngine.from_engine_args(
            model=qwen_config(root), dtype="bfloat16",
            attention_backend="fa_vattn_2mb", scheduler_type="sarathi",
            chunk_size=512, max_model_len=4096, max_batch_size=4,
            max_num_seqs=4, seed=0)
        counts = serve_qwen(dev, engine, kernels, smi, required, idle)
        engine.cleanup()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def serve_qwen(dev, engine, kernels, smi, required, idle):
    """(q)'s requests and checks on ``engine``; returns the launches."""
    runner = engine.worker.model_runner
    a = runner.model.arch
    bias = runner.params["layers"]["qkv_b"]
    gen = torch.Generator(device=dev).manual_seed(14)
    bias.copy_(torch.randn(bias.shape, generator=gen, device=dev)
               * QWEN_BIAS_SCALE)
    rng = np.random.default_rng(14)
    lens = rng.integers(1024, 3073, 4)
    requests = [(f"q{i}", rng.integers(1, a.vocab_size, int(n)).tolist(), 16)
                for i, n in enumerate(lens)]
    stats = {}
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = serve(engine, requests, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.symbol: k.launches for k in kernels}
    n_gen = sum(len(v) for v in out.values())
    n_prompt = int(lens.sum())
    if len(out) != 4 or n_gen != 4 * 16:
        raise AssertionError(f"(q) served {len(out)} requests, {n_gen} "
                             "tokens")
    log(f"(q) qwen-14b x {QWEN_LAYERS} layers (Hq {a.num_q_heads}, Hkv "
        f"{a.num_kv_heads}, hidden {a.hidden_size}, MLP "
        f"{a.intermediate_size}, vocab {a.vocab_size}, qkv bias std "
        f"{QWEN_BIAS_SCALE}), fa_vattn_2mb: served {len(out)} requests in "
        f"{stats['steps']} steps: prompt tokens {n_prompt} (lengths "
        f"{lens.tolist()}), generated {n_gen}, wall {wall:.3f} s, "
        f"{(n_prompt + n_gen) / wall:.2f} processed tok/s; "
        f"{len(runner.graphs)} step graphs captured; on {smi}")
    log("(q) launches in the 4-request run: "
        + ", ".join(f"{s_} {n}" for s_, n in counts.items()))
    if any(counts[k.symbol] <= 0 for k in required):
        raise AssertionError(f"(q) a kernel never launched: {counts}")
    if any(counts[k.symbol] > 0 for k in idle):
        raise AssertionError(f"(q) a kernel of another path launched: "
                             f"{counts}")
    if not runner.graphs:
        raise AssertionError("(q) no step was captured")
    with torch.no_grad():
        for i, (seq_id, ids, _) in enumerate(requests):
            tok = out[seq_id][0]
            logits = dense_logits(runner.model, runner.params, ids, dev)
            gap = float(logits.max() - logits[tok])
            log(f"(q) {seq_id} ({len(ids)} tokens): engine token {tok}, "
                f"dense f32 top {int(logits.argmax())}, logit gap "
                f"{gap:.5f} (tolerance {LOGIT_GAP_TOL})")
            if not gap <= LOGIT_GAP_TOL:
                raise AssertionError(f"(q) {seq_id}: logit gap {gap}")
            if i:
                continue
            kept = bias.clone()
            bias.zero_()
            unbiased = dense_logits(runner.model, runner.params, ids, dev)
            bias.copy_(kept)
            moved = float((logits - unbiased).abs().max())
            log(f"(q) {seq_id}: the reference without the bias moves a "
                f"logit by up to {moved:.5f} (must exceed {LOGIT_GAP_TOL})")
            if not moved > LOGIT_GAP_TOL:
                raise AssertionError(f"(q) the bias moves no logit past "
                                     f"{LOGIT_GAP_TOL}: {moved}")
    return counts


# --------------------------------------------------------------------- #
# (k) falcon-7b at full width, (k long) its long-context geometry
# --------------------------------------------------------------------- #
# the tiny f32 falcon of (b falcon): falcon-7b's attention heads at a
# narrow width
TINY_FALCON = dict(model_type="falcon", num_hidden_layers=2,
                   num_attention_heads=71, num_key_value_heads=1,
                   head_dim=64, hidden_size=256, intermediate_size=1024,
                   vocab_size=2048, max_position_embeddings=2048,
                   parallel_attn=True)


def tiny_falcon(root) -> str:
    """TINY_FALCON's config.json in a directory under ``root``."""
    import os

    path = os.path.join(root, "tiny-falcon")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(TINY_FALCON, f)
    return path


def falcon_phase(dev, kernels, backend, tag, required, idle, smi,
                 reference=None):
    """(k): falcon-7b at full width (32 layers, 71 query heads on 1 kv
    head, head dim 64, vocab 65024, bf16, seed-0 weights) through a fresh
    LLMEngine on ``backend`` (sarathi chunk 512, max_model_len 2048, batch
    8): 8 requests of 512-1900 prompt tokens and 32 greedy tokens, the
    launch counts zeroed just before and read just after; the kernels in
    ``required`` must launch, those in ``idle`` not.  Each request's first
    token is held within LOGIT_GAP_TOL of a dense reference in the model's
    bf16 arithmetic (computed on the first backend and passed on as
    ``reference``).  Returns (launch counts, reference)."""
    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE

    fresh_metrics()
    engine = LLMEngine.from_engine_args(
        model="falcon-7b", dtype="bfloat16", attention_backend=backend,
        scheduler_type="sarathi", chunk_size=512, max_model_len=2048,
        max_batch_size=8, max_num_seqs=8, seed=0)
    runner = engine.worker.model_runner
    vocab = runner.model.arch.vocab_size
    rng = np.random.default_rng(12)
    lens = rng.integers(512, 1901, 8)
    requests = [(f"k{i}", rng.integers(1, vocab, int(n)).tolist(), 32)
                for i, n in enumerate(lens)]
    cache_engine = engine.worker.cache_engine
    stats = {}
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = serve(engine, requests, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.symbol: k.launches for k in kernels}
    moves = getattr(cache_engine, "pending_moves", 0)
    n_gen = sum(len(v) for v in out.values())
    n_prompt = int(lens.sum())
    if len(out) != 8 or n_gen != 8 * 32:
        raise AssertionError(f"({tag}) served {len(out)} requests, "
                             f"{n_gen} tokens")
    log(f"({tag}) falcon-7b, {backend}: served {len(out)} requests in "
        f"{stats['steps']} steps: prompt tokens {n_prompt} (lengths "
        f"{lens.tolist()}), generated tokens {n_gen}, wall {wall:.3f} s, "
        f"{n_gen / wall:.2f} generated tok/s, "
        f"{(n_prompt + n_gen) / wall:.2f} processed tok/s; arena "
        f"{tuple(cache_engine.kv_cache.shape)} {cache_engine.kv_cache.dtype}"
        f"; {len(runner.graphs)} step graphs captured; on {smi}")
    log(f"({tag}) launches in the 8-request run: "
        + ", ".join(f"{s_} {n}" for s_, n in counts.items())
        + f"; the allocator planned {moves} block moves")
    if any(counts[k.symbol] <= 0 for k in required):
        raise AssertionError(f"({tag}) a kernel never launched: {counts}")
    if any(counts[k.symbol] > 0 for k in idle):
        raise AssertionError(f"({tag}) a kernel of another path launched: "
                             f"{counts}")
    relocate = ARENA_RELOCATE.symbol
    if (counts[relocate] > 0) != (moves > 0):
        raise AssertionError(f"({tag}) {moves} block moves but {relocate} "
                             f"launched {counts[relocate]} times")
    if not runner.graphs:
        raise AssertionError(f"({tag}) no step was captured")
    if reference is None:
        with torch.no_grad():
            reference = {s_: dense_logits(runner.model, runner.params, ids,
                                          dev, dtype=torch.bfloat16)
                         for s_, ids, _ in requests}
    top = 0
    for seq_id, ids, _ in requests:
        tok, w = out[seq_id][0], reference[seq_id]
        gap = float(w.max() - w[tok])
        top += tok == int(w.argmax())
        log(f"({tag}) {seq_id} ({len(ids)} tokens): engine token {tok}, "
            f"dense bf16 top {int(w.argmax())}, logit gap {gap:.5f} "
            f"(tolerance {LOGIT_GAP_TOL})")
        if not gap <= LOGIT_GAP_TOL:
            raise AssertionError(f"({tag}) {seq_id}: logit gap {gap}")
    log(f"({tag}) first tokens equal to the reference's argmax: {top} of 8")
    engine.cleanup()
    return counts, reference


def falcon_long_phase(dev, kernels, required, idle, smi):
    """(k long): falcon-7b-32k-l8 (falcon-7b's widths, 8 layers, bf16,
    seed-0 weights) written as a safetensors checkpoint in falcon's
    ``transformer.h.*`` layout into a temporary directory and loaded back
    bit for bit (``server_phase.round_trip``; load GB/s logged), then
    served from that directory (load_format safetensors) on fa_vattn_2mb:
    4 requests of 16K-30K prompt tokens and 16 greedy tokens, sarathi chunk
    512, max_model_len 32768, the launch counts zeroed just before and read
    just after (``required`` must launch, ``idle`` not); each first token
    within LOGIT_GAP_TOL of a dense reference in the model's bf16
    arithmetic (attention by blocks of 256 queries).  The directory is
    deleted after.  Returns the launch counts."""
    import shutil
    import tempfile

    from vattention_tpu_torch import LLMEngine
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.microbenchmarks.server_phase import round_trip
    from vattention_tpu_torch.model_executor.models import get_model_class

    name = "falcon-7b-32k-l8"
    arch = get_model_arch(name)
    model = get_model_class(arch.model_type)(arch, dtype=torch.bfloat16)
    path = tempfile.mkdtemp(prefix="vattn-falcon-")
    try:
        res = round_trip(model, dev, path, seed=0)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"(k long) checkpoint of {name} in falcon's layout: "
            f"{res['hf_tensors']} tensors, {res['bytes'] / 1e9:.3f} GB, "
            f"written in {res['write_s']:.3f} s "
            f"({res['bytes'] / 1e9 / res['write_s']:.3f} GB/s), loaded in "
            f"{res['load_s']:.3f} s ({res['bytes'] / 1e9 / res['load_s']:.3f}"
            f" GB/s, file to cuda); every tensor bit for bit; on {smi}")
        fresh_metrics()
        engine = LLMEngine.from_engine_args(
            model=path, load_format="safetensors", dtype="bfloat16",
            attention_backend="fa_vattn_2mb", scheduler_type="sarathi",
            chunk_size=512, max_model_len=32768, max_batch_size=4,
            max_num_seqs=4, gpu_memory_utilization=0.5)
        runner = engine.worker.model_runner
        rng = np.random.default_rng(13)
        lens = rng.integers(16384, 30001, 4)
        requests = [(f"l{i}", rng.integers(1, arch.vocab_size,
                                           int(n)).tolist(), 16)
                    for i, n in enumerate(lens)]
        stats = {}
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = serve(engine, requests, stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.symbol: k.launches for k in kernels}
        n_gen = sum(len(v) for v in out.values())
        n_prompt = int(lens.sum())
        if len(out) != 4 or n_gen != 4 * 16:
            raise AssertionError(f"(k long) served {len(out)} requests, "
                                 f"{n_gen} tokens")
        log(f"(k long) {name} from the checkpoint, fa_vattn_2mb: served "
            f"{len(out)} requests in {stats['steps']} steps: prompt tokens "
            f"{n_prompt} (lengths {lens.tolist()}), generated tokens "
            f"{n_gen}, wall {wall:.3f} s, {n_gen / wall:.2f} generated "
            f"tok/s, {(n_prompt + n_gen) / wall:.2f} processed tok/s; "
            f"{len(runner.graphs)} step graphs captured; on {smi}")
        log("(k long) launches: " + ", ".join(
            f"{s_} {n}" for s_, n in counts.items()))
        if any(counts[k.symbol] <= 0 for k in required):
            raise AssertionError(f"(k long) a kernel never launched: "
                                 f"{counts}")
        if any(counts[k.symbol] > 0 for k in idle):
            raise AssertionError(f"(k long) a kernel of another path "
                                 f"launched: {counts}")
        with torch.no_grad():
            for seq_id, ids, _ in requests:
                tok = out[seq_id][0]
                w = dense_logits(runner.model, runner.params, ids, dev,
                                 dtype=torch.bfloat16, block=256)
                gap = float(w.max() - w[tok])
                log(f"(k long) {seq_id} ({len(ids)} tokens): engine token "
                    f"{tok}, dense bf16 top {int(w.argmax())}, logit gap "
                    f"{gap:.5f} (tolerance {LOGIT_GAP_TOL})")
                if not gap <= LOGIT_GAP_TOL:
                    raise AssertionError(f"(k long) {seq_id}: logit gap "
                                         f"{gap}")
        engine.cleanup()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return counts


def falcon_sweeps(kernels):
    """(f falcon) kernel_sweep --check at falcon's attention heads (71 on 1
    kv head, the arena's 128 lanes) on the bf16, e4m3 and int8 arenas at
    ctx 1024 and 4096: G, H and C against their plain versions, G = H bit
    for bit.  Returns the launches of ``kernels`` (G, H) per arena tag."""
    from vattention_tpu_torch.microbenchmarks import kernel_sweep

    out = {}
    for kv in ("bf16", "fp8", "int8"):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        argv = ["--q-heads", "71", "--kv-heads", "1", "--kv-dtype", kv,
                "--ctx", "1024", "4096", "--batch", "8", "--check"]
        log(f"(f falcon) kernel_sweep {' '.join(argv)}")
        kernel_sweep.sweep(kernel_sweep.parser().parse_args(argv))
        torch.cuda.synchronize()
        arena = kernel_sweep.KV_DTYPES[kv]
        out["" if arena is None else QUANT[arena][1]] = {
            k.symbol: k.launches for k in kernels}
    return out


def window_sweeps(kernels):
    """(f w) kernel_sweep --window 4096 --check at mistral-7b's attention
    geometry (Hkv 8) on the bf16, e4m3 and int8 arenas, ctx 4096 and 16384
    (bf16 also 32768): G and H under the window, and C over each
    sequence's last 4096 positions, held against their plain versions.
    Returns the launches of ``kernels`` (G, H) in each sweep, by arena
    tag ("" for bf16), zeroed just before it."""
    from vattention_tpu_torch.microbenchmarks import kernel_sweep

    out = {}
    for kv in ("bf16", "fp8", "int8"):
        ctx = ["4096", "16384"] + (["32768"] if kv == "bf16" else [])
        argv = ["--window", str(WINDOW), "--kv-heads", "8", "--kv-dtype", kv,
                "--check", "--ctx", *ctx]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        log(f"(f w) kernel_sweep {' '.join(argv)}")
        kernel_sweep.main(argv)
        torch.cuda.synchronize()
        counts = {k.symbol: k.launches for k in kernels}
        out["" if kv == "bf16" else QUANT[kernel_sweep.KV_DTYPES[kv]][1]] = \
            counts
        log(f"(f w) launches in the {kv} sweep: " + ", ".join(
            f"{s_} {n}" for s_, n in counts.items()))
        if any(n <= 0 for n in counts.values()):
            raise AssertionError(f"(f w) a kernel never launched: {counts}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# (s) the serving entry points at full width
# --------------------------------------------------------------------- #
def server_phase(dev, kernels, required, idle, smi):
    """(s): ``microbenchmarks/server_phase.run`` at yi-6b-200k-l16's width
    (16 layers, bf16): the checkpoint's round trip, the OpenAI server over
    AsyncLLMEngine on fa_vattn_2mb with the native allocator (sarathi chunk
    512, batch 8, max_model_len 8192) answering 8 completions of 1024-4096
    prompt tokens (2 streamed, one with logprobs) and a chat at once, 32
    greedy tokens each, the first tokens within LOGIT_GAP_TOL of a dense
    reference in the model's bf16 arithmetic, and the native and Python
    allocators' identical tokens and extent tables.  The kernels in
    ``required`` must launch while the server answers, those in ``idle``
    not; D launches once per planned relocation.  Returns the launch
    counts."""
    from vattention_tpu_torch.microbenchmarks import server_phase as phase
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE

    def reference(model, params, ids):
        return dense_logits(model, params, ids, dev, dtype=torch.bfloat16)

    fresh_metrics()
    res = phase.run("yi-6b-200k-l16", dev, kernels=kernels,
                    reference=reference, tol=LOGIT_GAP_TOL, log=log)
    counts = res["counts"]
    if any(counts[k.symbol] <= 0 for k in required):
        raise AssertionError(f"(s) a kernel never launched: {counts}")
    if any(counts[k.symbol] > 0 for k in idle):
        raise AssertionError(f"(s) a kernel of another path launched: "
                             f"{counts}")
    relocate = ARENA_RELOCATE.symbol
    if (counts[relocate] > 0) != (res["moves"] > 0):
        raise AssertionError(f"(s) {res['moves']} block moves but {relocate} "
                             f"launched {counts[relocate]} times")
    log(f"(s) requests/s {res['requests_per_s']:.4f} ({res['requests']} "
        f"requests in {res['wall_s']:.3f} s) on {smi}")
    log(f"(s) processed tok/s {res['processed_tok_s']:.2f} "
        f"({res['prompt_tokens']} prompt + {res['generated_tokens']} "
        f"generated tokens) on {smi}")
    log(f"(s) TTFT of the 2 streamed requests: p50 {res['ttft_p50_s']:.4f} s,"
        f" max {res['ttft_max_s']:.4f} s on {smi}")
    log(f"(s) checkpoint load {res['bytes'] / 1e9 / res['load_s']:.3f} GB/s "
        f"({res['bytes'] / 1e9:.3f} GB in {res['load_s']:.3f} s), write "
        f"{res['bytes'] / 1e9 / res['write_s']:.3f} GB/s on {smi}")
    return counts


# --------------------------------------------------------------------- #
# (r) the benchmark package: bench.py's headline workload, arrivals over
# time, replicas, the capacity search, the YAML config
# --------------------------------------------------------------------- #
# bench.py's serving workload (bench.py:123-157, 239-240): yi-6b-200k-l16,
# 8 requests of 32768 - 324 prompt and 324 decode tokens, chunk 2048
BENCH_MODEL = "yi-6b-200k-l16"
BENCH_REQUESTS, BENCH_PREFILL, BENCH_DECODE = 8, 32444, 324
TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "processed_traces", "arxiv_synthetic_v2.csv")


def bench_kwargs(output_dir, **kw):
    """A full-width engine of the benchmark phases: yi-6b-200k-l16, bf16,
    seed-0 dummy weights (zero weights would make every token 0)."""
    return dict(model=BENCH_MODEL, dtype="bfloat16", load_format="dummy",
                seed=0, scheduler_type="sarathi", write_metrics=True,
                output_dir=output_dir, **kw)


def bench_phase(dev, kernels, smi, out_dir):
    """(r): bench.py's headline workload through ``BenchmarkRunner`` on
    fa_vattn_2mb, fa_paged_256 and fa_pod (``microbenchmarks/
    benchmark_phase.serve``), the launch counts zeroed after the warm-up
    and read after the timed run.  Every request completes with none
    preempted and the trace's token totals; no CUDA graph is captured in
    the timed run; the backends' tokens are equal; request 0's first token
    is within LOGIT_GAP_TOL of a dense reference in the model's bf16
    arithmetic; each backend's kernels launch and the others' do not; D
    launches once per relocation plan.  Returns each backend's counts."""
    from vattention_tpu_torch.microbenchmarks import benchmark_phase as phase
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE
    from vattention_tpu_torch.ops.cache_append import (KV_APPEND,
                                                       ROPE_KV_APPEND)
    from vattention_tpu_torch.ops.flash_decode import DECODE_ATTENTION
    from vattention_tpu_torch.ops.flash_prefill import (
        PREFILL_ATTENTION, SEGMENT_PREFILL_ATTENTION)
    from vattention_tpu_torch.ops.paged_attention import (
        PAGED_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE)
    from vattention_tpu_torch.ops.pod_fused import POD_ATTENTION

    a, b, c, d, e, f = (ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                        ARENA_RELOCATE, PAGED_PREFILL_ATTENTION, POD_ATTENTION)
    never = [KV_APPEND, SEGMENT_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE]
    cases = (("fa_vattn_2mb", "r", [a, b, c], [e, f]),
             ("fa_paged_256", "r paged", [a, e, c], [b, f, d]),
             ("fa_pod", "r pod", [a, f, b, c], [e]))
    gen = dict(num_requests=BENCH_REQUESTS, prefill_tokens=BENCH_PREFILL,
               decode_tokens=BENCH_DECODE, interval_generator="static",
               length_generator="fixed", seed=0)
    counts, tokens, tok_s = {}, {}, {}
    for backend, tag, required, idle in cases:
        kw = bench_kwargs(out_dir, attention_backend=backend,
                          chunk_size=2048, max_batch_size=8, max_num_seqs=8,
                          max_model_len=BENCH_PREFILL + BENCH_DECODE + 128,
                          gpu_memory_utilization=0.93)
        res = phase.serve(kw, gen, kernels=kernels)
        phase.check_static(res, BENCH_REQUESTS, BENCH_PREFILL, BENCH_DECODE,
                           tag)
        runner = res["runner"]
        engine = runner.engine
        got = res["counts"]
        t, ps = res["summary"]["totals"], res["summary"]["phase_stats"]
        log(f"({tag}) {backend}: {t['completed_requests']} requests of "
            f"{BENCH_PREFILL} + {BENCH_DECODE} tokens, chunk 2048, batch 8, "
            f"max_model_len {kw['max_model_len']}: processed tok/s "
            f"{res['tok_s']:.2f} (processed {t['processed_tokens']} / "
            f"makespan {t['makespan_s']:.4f} s), wall {res['wall_s']:.4f} s, "
            f"{t['num_steps']} steps ({ps['prefill_steps']} with prefill "
            f"{ps['prefill_time_s']:.4f} s, {ps['decode_steps']} decode-only "
            f"{ps['decode_time_s']:.4f} s), preemptions {t['preemptions']}, "
            f"on {smi}")
        log(f"({tag}) CUDA graphs: {res['graphs_warm']} after the warm-up, "
            f"{res['graphs_end']} after the timed run; launches: "
            + ", ".join(f"{s_} {n}" for s_, n in got.items())
            + f"; {res['plans']} relocation plans of {res['moves']} block "
            "moves")
        if any(got[k.symbol] <= 0 for k in required):
            raise AssertionError(f"({tag}) a kernel never launched: {got}")
        if any(got[k.symbol] > 0 for k in idle + never):
            raise AssertionError(f"({tag}) a kernel of another path "
                                 f"launched: {got}")
        if got[d.symbol] != res["plans"]:
            raise AssertionError(f"({tag}) {res['plans']} relocation plans "
                                 f"but {d.symbol} launched {got[d.symbol]} "
                                 "times")
        if backend == "fa_pod" and engine.worker.model_runner.backend \
                .pod_steps <= 0:
            raise AssertionError(f"({tag}) no step ran through kernel F")
        if tag == "r":
            # request 0's first token against the dense reference at
            # 32,444 tokens (bf16 arithmetic, attention in float32)
            model_runner = engine.worker.model_runner
            ids = res["prompts"]["bench0"]
            tok = res["tokens"]["bench0"][0]
            with torch.no_grad():
                logits = dense_logits(model_runner.model,
                                      model_runner.params, ids, dev,
                                      dtype=torch.bfloat16)
            gap = float(logits.max() - logits[tok])
            log(f"({tag}) bench0 ({len(ids)} tokens): first token {tok}, "
                f"dense bf16 top {int(logits.argmax())}, logit gap "
                f"{gap:.5f} (tolerance {LOGIT_GAP_TOL})")
            if not gap <= LOGIT_GAP_TOL:
                raise AssertionError(f"({tag}) bench0: logit gap {gap}")
            del logits, model_runner
        counts[backend], tokens[backend], tok_s[backend] = (
            got, res["tokens"], res["tok_s"])
        engine.cleanup()
        del res, runner, engine
        phase.free(dev)
    ref = tokens["fa_vattn_2mb"]
    for backend in ("fa_paged_256", "fa_pod"):
        same = sum(x == y for s_ in ref for x, y in zip(ref[s_],
                                                        tokens[backend][s_]))
        log(f"(r) {backend}: {same} of {BENCH_REQUESTS * BENCH_DECODE} "
            "generated tokens equal fa_vattn_2mb's")
        if tokens[backend] != ref:
            raise AssertionError(f"(r) {backend}'s tokens differ from "
                                 "fa_vattn_2mb's")
    v, p = counts["fa_vattn_2mb"], counts["fa_pod"]
    log(f"(r pod) F + B = {p[f.symbol]} + {p[b.symbol]} against B on vattn "
        f"{v[b.symbol]}; F + C = {p[f.symbol]} + {p[c.symbol]} against C "
        f"{v[c.symbol]}")
    if (p[f.symbol] + p[b.symbol] != v[b.symbol]
            or p[f.symbol] + p[c.symbol] != v[c.symbol]):
        raise AssertionError("(r pod) the fused launches do not add up to "
                             "fa_vattn_2mb's")
    log(f"(r) vs_baseline (fa_vattn_2mb / fa_paged_256 processed tok/s): "
        f"{tok_s['fa_vattn_2mb'] / tok_s['fa_paged_256']:.4f} "
        f"({tok_s['fa_vattn_2mb']:.2f} / {tok_s['fa_paged_256']:.2f}); "
        f"fa_pod {tok_s['fa_pod']:.2f}, on {smi}")
    return counts


def arrivals_phase(dev, kernels, smi, out_dir, required, idle):
    """(r dyn): 48 requests of the trace's lengths (the arxiv_synthetic_v2
    rows in order) arriving as a Poisson process at 2 requests/s, through
    ``BenchmarkRunner`` on fa_vattn_64kb (64-token blocks, 8 extents per
    request), batch 16, chunk 512, max_model_len 32768, the arena sized to
    2 GiB (65,536 tokens) so extents run out and the allocator relocates.
    Every request completes; no graph is captured in the timed run; the
    kernels in ``required`` launch, those in ``idle`` do not, and D
    launches once per relocation plan.  Each plan is held against
    ``arena_relocate_plain`` on a clone of the arena taken just before it,
    byte for byte (the plans' moves reach D through the engine's pinned,
    non-blocking copy; the plain version gets them from the plan).  Then
    D's row at this geometry, on the engine's arena ([16, 2, 4, R, 128]
    bf16, 64-token blocks) with the allocator's plan of ``bench_relocate``
    rdyn (990 moves), held byte for byte against the plain version and
    timed as (a)'s D rows.  Returns the counts and that row."""
    from vattention_tpu_torch.microbenchmarks import benchmark_phase as phase
    from vattention_tpu_torch.microbenchmarks.bench_relocate import (
        GEOMETRIES, dynamic_relocation_plan)
    from vattention_tpu_torch.ops import arena_copy
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE

    kw = bench_kwargs(out_dir, attention_backend="fa_vattn_64kb",
                      chunk_size=512, max_batch_size=16, max_num_seqs=16,
                      max_model_len=32768)
    kw["gpu_memory_utilization"] = phase.utilization_for_kv(kw, 2 * 1024**3)
    n = 48
    gen = dict(num_requests=n, interval_generator="poisson", qps=2.0,
               length_generator="trace", trace_file=TRACE, max_tokens=32768,
               seed=0)
    res = phase.serve(kw, gen, kernels=kernels, check_relocations=True)
    engine = res["runner"].engine
    ce = engine.worker.cache_engine
    arena_tokens = ce.allocator.num_arena_blocks * ce.block_tokens
    s = res["summary"]
    t, ps = s["totals"], s["phase_stats"]
    got = res["counts"]
    prompts = [len(v) for v in res["prompts"].values()]
    log(f"(r dyn) fa_vattn_64kb: {len(prompts)} requests (prompts "
        f"{min(prompts)}-{max(prompts)}, {sum(prompts)} tokens), Poisson at "
        f"2/s, arena {arena_tokens} tokens ({ce.allocator.num_arena_blocks} "
        f"blocks of {ce.block_tokens}), gpu_memory_utilization "
        f"{kw['gpu_memory_utilization']:.5f}: completed "
        f"{t['completed_requests']}, preemptions {t['preemptions']}, "
        f"processed {t['processed_tokens']}, wall {res['wall_s']:.3f} s, "
        f"{ps['prefill_steps'] + ps['decode_steps']} steps dispatched, "
        f"graphs {res['graphs_warm']} -> {res['graphs_end']}, on {smi}")
    q = {k: s[k] for k in ("request_e2e_time_normalized", "ttft", "tbt",
                           "scheduling_delay")}
    frag = s.get("fragmentation_overhead", {})
    log(f"(r dyn) request e2e normalized s/token p50 "
        f"{q['request_e2e_time_normalized']['p50']:.6f} p90 "
        f"{q['request_e2e_time_normalized']['p90']:.6f} p99 "
        f"{q['request_e2e_time_normalized']['p99']:.6f}; TTFT p50 "
        f"{q['ttft']['p50']:.4f} p99 {q['ttft']['p99']:.4f} s; TBT p99 "
        f"{q['tbt']['p99']:.5f} s; scheduling delay p99 "
        f"{q['scheduling_delay']['p99']:.4f} s; fragmentation mean "
        f"{frag.get('mean', 0.0):.5f} max {frag.get('max', 0.0):.5f}; "
        f"{res['plans']} relocation plans of {res['moves']} block moves, "
        f"{ARENA_RELOCATE.symbol} launched {got[ARENA_RELOCATE.symbol]} "
        f"times; launches: " + ", ".join(f"{k} {v}" for k, v in got.items()))
    log(f"(r dyn) {ARENA_RELOCATE.symbol} against arena_relocate_plain at "
        f"{ce.block_tokens}-token blocks, {tuple(ce.kv_cache.shape)} arena: "
        + ", ".join(f"plan of {m} moves "
                    f"{'equal byte for byte' if ok else 'DIFFERS'}"
                    for m, ok in res["relocations"]))
    if t["completed_requests"] != n:
        raise AssertionError(f"(r dyn) {t['completed_requests']} of {n} "
                             "requests completed")
    if any(got[k.symbol] <= 0 for k in required):
        raise AssertionError(f"(r dyn) a kernel never launched: {got}")
    if any(got[k.symbol] > 0 for k in idle):
        raise AssertionError(f"(r dyn) a kernel of another path launched: "
                             f"{got}")
    if got[ARENA_RELOCATE.symbol] != res["plans"]:
        raise AssertionError(f"(r dyn) {res['plans']} relocation plans but "
                             f"{ARENA_RELOCATE.symbol} launched "
                             f"{got[ARENA_RELOCATE.symbol]} times")
    if (len(res["relocations"]) != res["plans"]
            or not all(ok for _, ok in res["relocations"])):
        raise AssertionError(f"(r dyn) relocation checks "
                             f"{res['relocations']} for {res['plans']} plans")
    # D at this geometry on the engine's arena, with the allocator's plan
    # of bench_relocate's rdyn geometry (the run itself may plan none)
    g = GEOMETRIES["rdyn"]
    bt, plan = dynamic_relocation_plan(g["L"], g["HKV"], g["D"], 2,
                                       g["page"], g["segments"], g["blocks"])
    cache = ce.kv_cache
    if (bt != ce.block_tokens or cache.shape[3] < g["blocks"] * bt
            or tuple(cache.shape[:3]) != (g["L"], 2, g["HKV"])):
        raise AssertionError(f"(r dyn) arena {tuple(cache.shape)} at "
                             f"{ce.block_tokens}-token blocks is not "
                             "bench_relocate's rdyn")
    src, dst = (torch.tensor([getattr(m, k) for m in plan.moves],
                             dtype=torch.int32, device=dev)
                for k in ("src", "dst"))
    n = src.numel()
    expect = cache.clone()
    arena_copy.arena_relocate_plain(expect, src, dst, n, bt)
    arena_copy.arena_relocate(cache, src, dst, n, bt)
    torch.cuda.synchronize()
    if not torch.equal(cache.view(torch.uint8), expect.view(torch.uint8)):
        raise AssertionError("(r dyn) D differs from arena_relocate_plain on "
                             "the allocator's plan")
    del expect
    batches = arena_copy.relocation_batches(src.tolist(), dst.tolist(), n,
                                            arena_copy.BATCH_VECS)
    row = relocation_row(
        cache, src, dst, bt, Timer(dev), "[r dyn]",
        f"the allocator's plan of {n} moves of {bt}-row blocks (at most "
        f"{len(batches)} batches; equal byte for byte to the plain "
        f"version's), arena {tuple(cache.shape)} {cache.dtype}")
    del cache
    log(f"(r dyn) {row['name']}: {row['shape']}: ms {row['ms']:.4f} plain "
        f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
        f"{row['bound_ms']:.5f} ({row['bound_by']}, "
        f"{100 * row['bound_ms'] / row['ms']:.1f}%); a copy_ of its bytes "
        f"{row['copy_ms']:.4f}; on {smi}")
    engine.cleanup()
    del res, engine, ce
    phase.free(dev)
    return got, row


def launcher_phases(dev, smi, out_dir):
    """(r rep): ``BenchmarkRunnerLauncher`` with 2 replicas of
    yi-6b-200k-l16 on the one card (each arena from half of
    gpu_memory_utilization 0.9), 8 static requests of 2048 + 32 tokens on
    fa_vattn_2mb: 4 completed per replica, the merged totals the sums, the
    device memory back after ``cleanup``.  (r cap): ``CapacitySearch``
    over 16 requests of the trace's lengths, qps 1 to 4, one bisection
    step, a scheduling delay p99 SLO of 0.3 s (at 2 s it does not bind
    for so few requests, and the search probes up to 64 qps); its probes
    are printed.  (r yaml): ``main.run_from_flat`` on a
    YAML file that cuts default.yml to 2 requests of 1024 + 16 tokens."""
    from vattention_tpu_torch.benchmark.capacity_search import CapacitySearch
    from vattention_tpu_torch.benchmark.capacity_search.capacity_search \
        import SLOConfig
    from vattention_tpu_torch.microbenchmarks import benchmark_phase as phase

    kw = bench_kwargs(out_dir, attention_backend="fa_vattn_2mb",
                      chunk_size=2048, max_batch_size=8, max_num_seqs=8,
                      max_model_len=4096, gpu_memory_utilization=0.9)
    t0 = time.perf_counter()
    res = phase.replicas(kw, dict(num_requests=8, prefill_tokens=2048,
                                  decode_tokens=32,
                                  interval_generator="static",
                                  length_generator="fixed", seed=0), 2)
    t = res["summary"]["totals"]
    log(f"(r rep) 2 replicas of {BENCH_MODEL} on one card, arenas "
        + ", ".join(f"{x / 2**30:.3f}" for x in res["arenas"])
        + f" GiB: per replica completed "
        f"{[p['completed_requests'] for p in res['summary']['per_replica_totals']]}"
        f", merged {t['completed_requests']} requests, processed "
        f"{t['processed_tokens']}, {t['tokens_per_s']:.2f} tok/s, "
        f"{t['num_steps']} steps; device memory allocated "
        f"{res['allocated_before'] / 2**20:.1f} MiB before, "
        f"{res['allocated_after'] / 2**20:.1f} MiB after cleanup; "
        f"{time.perf_counter() - t0:.1f} s, on {smi}")
    if res["allocated_after"] > res["allocated_before"] + 64 * 2**20:
        raise AssertionError("(r rep) cleanup did not free the replicas' "
                             "memory")

    t0 = time.perf_counter()
    kw = bench_kwargs(out_dir, attention_backend="fa_vattn_2mb",
                      chunk_size=512, max_batch_size=8, max_num_seqs=8,
                      max_model_len=32768, gpu_memory_utilization=0.9)
    search = CapacitySearch(
        kw, dict(length_generator="trace", trace_file=TRACE,
                 max_tokens=32768, seed=0),
        SLOConfig(scheduling_delay_slo_s=0.3), num_requests=16,
        time_limit_s=120.0)
    qps = search.search(qps_low=1.0, qps_high=4.0, max_iters=1)
    phase.free(dev)
    log(f"(r cap) CapacitySearch, 16 requests of the trace's lengths, "
        f"scheduling delay p99 SLO 0.3 s: {qps} qps after "
        f"{len(search.probes)} probes {search.probes} in "
        f"{time.perf_counter() - t0:.1f} s, on {smi}")

    t0 = time.perf_counter()
    summary = phase.from_yaml(
        {"output_dir": out_dir,
         "model": {"name": BENCH_MODEL, "load_format": "dummy",
                   "attention_backend": "fa_vattn_2mb",
                   "max_model_len": 4096, "max_batch_size": 8},
         "replica_scheduler": {"max_batch_size": 8},
         "synthetic_request_generator": {"num_requests": 2},
         "fixed_request_length_generator": {"prefill_tokens": 1024,
                                            "decode_tokens": 16}},
        out_dir, "cuda", log=log)
    phase.free(dev)
    t = summary["totals"]
    log(f"(r yaml) completed {t['completed_requests']}, processed "
        f"{t['processed_tokens']}, decode {t['decode_tokens']}, "
        f"{time.perf_counter() - t0:.1f} s")
    if (t["completed_requests"], t["processed_tokens"]) != (2, 2 * 1039):
        raise AssertionError(f"(r yaml) totals {t}")


# --------------------------------------------------------------------- #
# (l) the long-context grid's north-star pairs at 64K and 128K
# --------------------------------------------------------------------- #
LONG_CTX = (65536, 131072)      # the pairs' cells run here (32K is (r)'s)
LONG_DEPTH, LONG_Q, LONG_BATCH = 131072, 128, 2
# kernel C's plan points for bench_decode_kernel (MIN_SPLIT_TILES:
# BLOCKS_PER_SM), today's defaults first
LONG_PLANS = ("4:2", "1:2", "16:2", "4:4")
LONG_BACKENDS = ("fa_vattn_2mb", "fa_paged_256")


def long_kernels(dev):
    """(l) the kernels at depth 131,072 that the 128K cells run there: B
    over one run of the last 128 queries at kv_len 131,072 (so that the
    plain version's [T, Hq, S] float32 scores stay ~2 GB), E on the same
    rows through 256-token block tables (the same body: expected bit for
    bit), and C over 2 slots (the 128K cell's batch) at depth 131,072, the
    rows in a seeded permutation of 2048-token blocks.  Each is held
    against its plain version with (a)'s tolerances and timed beside it,
    one SDPA call on the gathered K/V and its bound.  Returns the rows of
    the JSON line, ``<name>[128K]``."""
    from vattention_tpu_torch.ops import (flash_decode, flash_prefill,
                                          paged_attention)

    HQ, HKV, D = YI["HQ"], YI["HKV"], YI["D"]
    n, T, B, bt, sub, es = LONG_DEPTH, LONG_Q, LONG_BATCH, 2048, 256, 2
    sm = D ** -0.5
    randn, i32 = seeded(dev, 15)
    timer = Timer(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    blocks = B * n // bt
    cache = randn(1, 2, HKV, blocks * bt, D)
    perm = np.random.default_rng(15).permutation(blocks)
    pos = np.arange(n // sub) * sub
    rows_np = np.stack([perm[b * (n // bt) + pos // bt] * bt + pos % bt
                        for b in range(B)]).astype(np.int32)
    tile_rows = i32(rows_np)
    grow = [flash_decode.gather_rows(tile_rows[b], n, sub) for b in range(B)]
    results = []

    def row(name, src, replaces, fn, plain, lib, b_ms, b_by, err, shape):
        ms = timer(fn)
        results.append(dict(
            name=f"{name}[128K]", route="cuda", source=src,
            replaces=replaces, max_abs_err=err, ms=ms,
            plain_ms=timer(plain, iters=2, warmup=1),
            library_ms=timer(lib), bound_ms=b_ms, bound_by=b_by,
            shape=shape))
        log(f"(l) {name} at depth {n}: {shape}: max abs err {err} ms "
            f"{ms:.4f} plain {results[-1]['plain_ms']:.4f} library "
            f"{results[-1]['library_ms']:.4f} (SDPA, gathered K/V) bound "
            f"{b_ms:.4f} ({b_by}, {100 * b_ms / ms:.1f}%)")

    # B and E: the last T queries of one run at kv_len n
    q = randn(T, HQ, D)
    qt_run = i32([[0, 0]])
    qinfo = i32([[n - T, n], [0, 0]])
    trows = torch.stack([tile_rows[0], torch.zeros_like(tile_rows[0])])
    btab = trows // sub
    bkw = dict(pad_tile=128, sm_scale=sm)
    args = (q, cache, qt_run, qinfo, trows, 0)
    eargs = (q, cache, qt_run, qinfo, btab, 0)
    got = flash_prefill.prefill_attention(*args, sub=sub, **bkw)
    got_e = paged_attention.paged_prefill_attention(*eargs, block_size=sub,
                                                    **bkw)
    ref = flash_prefill.prefill_attention_plain(*args, sub=sub, **bkw)
    torch.cuda.synchronize()
    err, rel = check_attention(f"(l) prefill_attention at kv_len {n}", got,
                               ref, PREFILL_TOL)
    if not torch.equal(got, got_e):
        raise AssertionError(f"(l) E differs from B at kv_len {n} on the "
                             "same rows")
    del got, got_e, ref
    kg = cache[0, 0][:, grow[0]][None]
    vg = cache[0, 1][:, grow[0]][None]
    mask = (n - T + torch.arange(T, device=dev))[:, None] \
        >= torch.arange(n, device=dev)[None, :]
    pairs = T * (n - T) + T * (T + 1) // 2
    b_ms, b_by = bound((2 * T * HQ * D + n * 2 * HKV * D) * es,
                       4 * HQ * D * pairs)
    shape = (f"the last {T} queries at kv_len {n}, one run over permuted "
             f"2048-token blocks, Hq={HQ} Hkv={HKV} D={D} bf16")

    def lib_prefill():
        return sdpa(q.transpose(0, 1)[None], kg, vg, attn_mask=mask,
                    enable_gqa=True)

    row("prefill_attention", "vattention_tpu_torch/csrc/prefill_attention.cu",
        "vattention_tpu/ops/flash_prefill.py:273",
        lambda: flash_prefill.prefill_attention(*args, sub=sub, **bkw),
        lambda: flash_prefill.prefill_attention_plain(*args, sub=sub, **bkw),
        lib_prefill, b_ms, b_by, err, shape)
    row("paged_prefill_attention",
        "vattention_tpu_torch/csrc/paged_prefill_attention.cu",
        "vattention_tpu/ops/paged_attention.py:107",
        lambda: paged_attention.paged_prefill_attention(
            *eargs, block_size=sub, **bkw),
        lambda: paged_attention.paged_prefill_attention_plain(
            *eargs, block_size=sub, **bkw),
        lib_prefill, b_ms, b_by, err, shape + ", 256-token blocks")
    del kg, vg, mask

    # C: B slots at depth n
    qd = randn(B, HQ, D)
    seqlens = i32([n] * B)
    dargs = (qd, cache, tile_rows, seqlens, 0)
    got = flash_decode.decode_attention(*dargs, sub=sub, sm_scale=sm)
    ref = flash_decode.decode_attention_plain(*dargs, sub=sub, sm_scale=sm)
    torch.cuda.synchronize()
    err, rel = check_attention(f"(l) decode_attention at depth {n}", got,
                               ref, DECODE_TOL)
    del got, ref
    kd = torch.stack([cache[0, 0][:, g] for g in grow])
    vd = torch.stack([cache[0, 1][:, g] for g in grow])
    c_ms, c_by = bound(B * n * 2 * HKV * D * es + 2 * B * HQ * D * es,
                       4 * HQ * D * B * n)
    row("decode_attention", "vattention_tpu_torch/csrc/decode_attention.cu",
        "vattention_tpu/ops/flash_decode.py:157",
        lambda: flash_decode.decode_attention(*dargs, sub=sub, sm_scale=sm),
        lambda: flash_decode.decode_attention_plain(*dargs, sub=sub,
                                                    sm_scale=sm),
        lambda: sdpa(qd[:, :, None], kd, vd, enable_gqa=True),
        c_ms, c_by, err,
        f"B={B} slots at depth {n} over permuted 2048-token blocks "
        f"(sub {sub}), Hq={HQ} Hkv={HKV} D={D} bf16")
    del kd, vd, cache
    return results


def longctx_phase(dev, kernels, smi, out_dir):
    """(l): ``longctx_grid``'s ``pairs`` cells at 64K (batch 4, 6 requests)
    and 128K (batch 2, 4 requests), fa_vattn_2mb against fa_paged_256 at
    P:D 100 on yi-6b-200k-l16, each cell's engine and trace built from the
    grid's flags (``longctx_grid.cell_configs``) but with seed-0 dummy
    weights (the grid's zero weights make every token 0), served through
    ``BenchmarkRunner`` with its warm-up (``benchmark_phase.serve``: the
    launch counts zeroed after the warm-up and read after the timed run, no
    graph captured in the timed run).  Every request completes, none
    preempted, with the trace's totals; each backend's kernels launch and
    the others' do not; the first generated token of every request is
    equal across each pair; at 64K request 0's first token is within
    LOGIT_GAP_TOL of a dense reference in the model's bf16 arithmetic (at
    128K the cross-backend check alone holds it: a dense forward there
    takes minutes).  ``collect_longctx_grid`` then reads the cells' files:
    stall_s and vs_paged.  Returns the summed counts of each backend."""
    from vattention_tpu_torch.microbenchmarks import benchmark_phase as phase
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE
    from vattention_tpu_torch.ops.cache_append import (KV_APPEND,
                                                       ROPE_KV_APPEND)
    from vattention_tpu_torch.ops.flash_decode import DECODE_ATTENTION
    from vattention_tpu_torch.ops.flash_prefill import (
        PREFILL_ATTENTION, SEGMENT_PREFILL_ATTENTION)
    from vattention_tpu_torch.ops.paged_attention import (
        PAGED_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE)
    from vattention_tpu_torch.ops.pod_fused import POD_ATTENTION
    from vattention_tpu_torch.scripts import (collect_longctx_grid,
                                              longctx_grid)

    a, b, c, d, e, f = (ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                        ARENA_RELOCATE, PAGED_PREFILL_ATTENTION, POD_ATTENTION)
    never = [KV_APPEND, SEGMENT_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE, f]
    uses = {"fa_vattn_2mb": ([a, b, c], [e]), "fa_paged_256": ([a, e, c],
                                                               [b, d])}
    cells = [x for x in longctx_grid.group_cells("pairs") if x.ctx in LONG_CTX]
    counts = {bk: {k.symbol: 0 for k in kernels} for bk in LONG_BACKENDS}
    first, info = {}, {}
    for cell in cells:
        tag = f"l {cell.tag}"
        kw, gen = longctx_grid.cell_configs(cell, out_dir, "cuda")
        kw.update(load_format="dummy", seed=0)
        phase.free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = phase.serve(kw, gen, kernels=kernels)
        phase.check_static(res, cell.nreq, cell.prefill, cell.decode, tag)
        peak = torch.cuda.max_memory_allocated(dev)
        engine = res["runner"].engine
        got = res["counts"]
        required, idle = uses[cell.backend]
        if any(got[k.symbol] <= 0 for k in required):
            raise AssertionError(f"({tag}) a kernel never launched: {got}")
        if any(got[k.symbol] > 0 for k in idle + never):
            raise AssertionError(f"({tag}) a kernel of another path "
                                 f"launched: {got}")
        if got[d.symbol] != res["plans"]:
            raise AssertionError(f"({tag}) {res['plans']} relocation plans "
                                 f"but {d.symbol} launched {got[d.symbol]}")
        for k, v in got.items():
            counts[cell.backend][k] += v
        first[cell.tag] = {s: toks[0] for s, toks in res["tokens"].items()}
        info[cell.tag] = dict(tokens=res["tokens"], peak=peak,
                              tok_s=res["tok_s"], counts=got)
        t, ps = res["summary"]["totals"], res["summary"]["phase_stats"]
        log(f"({tag}) {cell.backend}: {t['completed_requests']} requests of "
            f"{cell.prefill} + {cell.decode} tokens, chunk 2048, batch "
            f"{cell.batch}, max_model_len {cell.max_model_len}: makespan "
            f"{t['makespan_s']:.4f} s, processed tok/s {res['tok_s']:.2f} "
            f"over the makespan ({t['tokens_per_s']:.2f} over the store's "
            f"wall), wall {res['wall_s']:.4f} s, {t['num_steps']} steps "
            f"({ps['prefill_steps']} with prefill {ps['prefill_time_s']:.4f}"
            f" s, {ps['decode_steps']} decode-only "
            f"{ps['decode_time_s']:.4f} s), preemptions {t['preemptions']}, "
            f"peak device memory {peak / 2**30:.2f} GiB, graphs "
            f"{res['graphs_warm']} / {res['graphs_end']}; launches "
            + ", ".join(f"{s_} {v}" for s_, v in got.items() if v)
            + f"; on {smi}")
        if cell.ctx == LONG_CTX[0] and cell.backend == "fa_vattn_2mb":
            model_runner = engine.worker.model_runner
            ids = res["prompts"]["bench0"]
            tok = res["tokens"]["bench0"][0]
            t1 = time.perf_counter()
            with torch.no_grad():
                logits = dense_logits(model_runner.model,
                                      model_runner.params, ids, dev,
                                      dtype=torch.bfloat16)
            gap = float(logits.max() - logits[tok])
            log(f"({tag}) bench0 ({len(ids)} tokens): first token {tok}, "
                f"dense bf16 top {int(logits.argmax())}, logit gap "
                f"{gap:.5f} (tolerance {LOGIT_GAP_TOL}; the reference took "
                f"{time.perf_counter() - t1:.1f} s)")
            if not gap <= LOGIT_GAP_TOL:
                raise AssertionError(f"({tag}) bench0: logit gap {gap}")
            del logits, model_runner
        engine.cleanup()
        del res, engine
        phase.free(dev)
        log(f"({tag}) in {time.perf_counter() - t0:.1f} s")
    grid = collect_longctx_grid.collect(out_dir)
    by_tag = {r["tag"]: r for r in grid["configs"]}
    ratio = {(r["ctx"], r["backend"]): r for r in grid["vs_paged"]}
    for ctx in LONG_CTX:
        v, p = (f"{bk}_c{ctx}_pd100" for bk in LONG_BACKENDS)
        if first[v] != first[p]:
            raise AssertionError(f"(l) first tokens differ at {ctx}: "
                                 f"{first[v]} against {first[p]}")
        same = sum(x == y for s_ in info[v]["tokens"] for x, y in zip(
            info[v]["tokens"][s_], info[p]["tokens"][s_]))
        total = sum(len(t_) for t_ in info[v]["tokens"].values())
        r = ratio[ctx, "fa_vattn_2mb"]
        log(f"(l) {ctx}: first tokens equal on {len(first[v])} of "
            f"{len(first[v])} requests; {same} of {total} generated tokens "
            f"equal; vs_paged (tok/s) {r['tokens_ratio_vs_paged']}, "
            f"makespan paged / vattn {r['makespan_ratio_paged_over_this']}")
        for t_ in (v, p):
            g = by_tag[t_]
            log(f"(l) {t_}: makespan {g['makespan_s']:.4f} s, tok/s "
                f"{g['tokens_per_s']:.2f}, preemptions {g['preemptions']}, "
                f"stall_s {g.get('stall_s')}, peak "
                f"{info[t_]['peak'] / 2**30:.2f} GiB, launches A' "
                f"{info[t_]['counts'][a.symbol]} B "
                f"{info[t_]['counts'][b.symbol]} E "
                f"{info[t_]['counts'][e.symbol]} C "
                f"{info[t_]['counts'][c.symbol]}, on {smi}")
    return counts


def long_tools(smi):
    """(l) the step profiler at ctx 131,072, batch 2, bf16 K/V, on both
    backends (``scripts/profile_backend_step.drive``), then C's plan sweep
    (``microbenchmarks/bench_decode_kernel``) at depth 65,536 (batch 4) and
    131,072 (batch 2), 16 calls per timed program, each point checked
    against C's plain version first."""
    from vattention_tpu_torch.microbenchmarks import bench_decode_kernel
    from vattention_tpu_torch.scripts.profile_backend_step import drive

    for backend in LONG_BACKENDS:
        t0 = time.perf_counter()
        tp, ns, td = drive(BENCH_MODEL, backend, LONG_DEPTH, LONG_BATCH, 30,
                           "none", "cuda")
        log(f"(l profile) {backend}: ctx {LONG_DEPTH} x {LONG_BATCH}, bf16: "
            f"prefill {tp:.4f} s in {ns} steps, decode "
            f"{td * 1e3:.4f} ms per step (CUDA events; "
            f"{time.perf_counter() - t0:.1f} s), on {smi}")
    for ctx, batch in ((65536, 4), (LONG_DEPTH, LONG_BATCH)):
        rows = bench_decode_kernel.sweep(bench_decode_kernel.parser()
                                         .parse_args([
            "--batch", str(batch), "--ctx", str(ctx), "--layers", "16",
            "--plans", *LONG_PLANS]))
        log(f"(l sweep) C at depth {ctx}, batch {batch}: " + "; ".join(
            f"{r['min_split_tiles']}:{r['blocks_per_sm']} grid {r['grid']} "
            f"{r['ms']:.4f} ms / 16 calls, {r['pct_bound']:.1f}% of "
            f"{r['bound_ms']:.4f}, err {r['max_abs_err']:.3g}"
            for r in rows) + f", on {smi}")


# --------------------------------------------------------------------- #
# (t b), (t yi) tensor and pipeline parallelism: ranks as processes on the
# card (gloo: NCCL refuses two ranks on one device)
# --------------------------------------------------------------------- #
# layout name -> (pp, tp): every layout of more than one rank
LAYOUTS = {k: v for k, v in RANK_LAYOUTS.items() if v != (1, 1)}
# (t yi)'s model: Yi-6B's widths at half its depth (the script's time)
T_YI_MODEL = "yi-6b-200k-l16"
PARITY_BACKENDS = ("fa_vattn", "fa_paged_256", "fa_pod")


def rank_lines(tag, out, kernels):
    """Log each rank's launches of ``kernels``; their sum over the ranks."""
    total = dict.fromkeys((k.symbol for k in kernels), 0)
    for res in out:
        n = {k.symbol: res["launches"][k.symbol] for k in kernels}
        log(f"({tag}) rank (dp, pp, tp) {res['coords']}: arena "
            f"{list(res['arena'])}, backend {res['backend']}, "
            f"{res['graphs']} step graphs, launches "
            + ", ".join(f"{s_} {v}" for s_, v in n.items()))
        for s_, v in n.items():
            total[s_] += v
    return total


def parallel_parity_phase(dev, kernels):
    """(t b): tiny-llama-debug in float32 on fa_vattn, fa_paged_256 and
    fa_pod at tp2, pp2 and tp2 pp2, each layout's ranks processes on the
    card (``run_ranks``), every rank's greedy tokens equal to the one-rank
    engine's exactly; then the same tp2 engine through ``LLMEngine`` from
    this process (its second rank a child), equal too."""
    from vattention_tpu_torch import LLMEngine, SamplingParams
    from vattention_tpu_torch.ops.flash_decode import DECODE_ATTENTION
    from vattention_tpu_torch.ops.flash_prefill import PREFILL_ATTENTION
    from vattention_tpu_torch.ops.paged_attention import (
        PAGED_PREFILL_ATTENTION)
    from vattention_tpu_torch.ops.pod_fused import POD_ATTENTION
    from vattention_tpu_torch.parallel.multihost import (run_ranks,
                                                         serve_requests)

    rng = np.random.default_rng(5)
    prompts = {f"r{i}": rng.integers(1, 2000, int(n)).tolist()
               for i, n in enumerate([200, 37])}
    base = dict(model="tiny-llama-debug", dtype="float32",
                scheduler_type="sarathi", max_model_len=512,
                max_batch_size=4, max_num_seqs=4, chunk_size=128)
    used = {"fa_vattn": (PREFILL_ATTENTION, DECODE_ATTENTION),
            "fa_paged_256": (PAGED_PREFILL_ATTENTION,),
            "fa_pod": (POD_ATTENTION,)}
    ref = {}
    for backend in PARITY_BACKENDS:
        fresh_metrics()
        engine = LLMEngine.from_engine_args(**base, attention_backend=backend,
                                            gpu_memory_utilization=0.9)
        ref[backend] = serve(engine, [(s_, p, 6) for s_, p in prompts.items()])
        engine.cleanup()
    requests = [dict(prompt=None, prompt_token_ids=ids,
                     sampling_params=SamplingParams(
                         temperature=0.0, max_tokens=6, ignore_eos=True),
                     seq_id=seq_id) for seq_id, ids in prompts.items()]
    for name, (pp, tp) in LAYOUTS.items():
        if tp > 2:
            continue  # tiny-llama-debug has 2 kv heads
        world = pp * tp
        t0 = time.perf_counter()
        runs = [dict(engine_args=dict(base, attention_backend=b,
                                      pipeline_parallel_size=pp,
                                      tensor_parallel_size=tp,
                                      gpu_memory_utilization=0.9 / world),
                     requests=requests) for b in PARITY_BACKENDS]
        out = run_ranks(serve_requests, world, dict(runs=runs),
                        device="cuda", timeout_s=300)
        for i, backend in enumerate(PARITY_BACKENDS):
            per_rank = [o[i] for o in out]
            for res in per_rank:
                if res["outputs"] != ref[backend]:
                    raise AssertionError(
                        f"(t b {name}) {backend} rank {res['coords']}: "
                        f"{res['outputs']} != one rank's {ref[backend]}")
                if res["backend"] != "gloo" or res["graphs"]:
                    raise AssertionError(f"(t b {name}) {res['backend']}, "
                                         f"{res['graphs']} graphs")
            total = rank_lines(f"t b {name} {backend}", per_rank, kernels)
            if any(total[k.symbol] <= 0 for k in used[backend]):
                raise AssertionError(f"(t b {name}) {backend}: a kernel of "
                                     f"its path never launched: {total}")
            log(f"(t b {name}) {backend}: {world} ranks, every rank's tokens "
                f"== the one-rank engine's {ref[backend]}")
        log(f"(t b {name}) {world} ranks on one card, gpu_memory_utilization"
            f" {0.9 / world:.3f} each, three engines in "
            f"{time.perf_counter() - t0:.1f} s")
    fresh_metrics()
    t0 = time.perf_counter()
    engine = LLMEngine.from_engine_args(**base, attention_backend="fa_vattn",
                                        tensor_parallel_size=2,
                                        gpu_memory_utilization=0.45)
    got = serve(engine, [(s_, p, 6) for s_, p in prompts.items()])
    backend, graphs = engine.mesh.backend, len(engine.worker.model_runner.graphs)
    engine.cleanup()
    if got != ref["fa_vattn"] or graphs:
        raise AssertionError(f"(t b facade) {got} != {ref['fa_vattn']} or "
                             f"{graphs} graphs")
    log(f"(t b facade) LLMEngine(tensor_parallel_size=2) from this process "
        f"(rank 1 a child, backend {backend}, steps eager): tokens == the "
        f"one-rank engine's, {time.perf_counter() - t0:.1f} s")


def parallel_serving_phase(dev, kernels, smi, required, idle):
    """(t yi): (c)'s 8 requests on T_YI_MODEL (Yi-6B's widths at half
    depth; bf16, dummy weights from seed 0, fa_vattn_2mb, chunk 512, batch
    8, max_model_len 8192) as the ranks of each layout, processes sharing
    the card (each with gpu_memory_utilization 0.9 / ranks), the launch
    counts zeroed in
    each rank just before serving and read just after.  Every rank serves
    8 x 32 tokens, the same on every rank; the kernels of ``required``
    launch on every rank and those of ``idle`` on none; request s0's first
    token is held within 0.25 logits of a dense float32 reference's top.
    Returns the launches summed over the ranks that ran each tp's heads
    ({tp: {symbol: n}})."""
    from vattention_tpu_torch.config import get_model_arch
    from vattention_tpu_torch.microbenchmarks.parallel_serving import (
        ENGINE_ARGS, requests, serve_layout)
    from vattention_tpu_torch.model_executor.models import get_model_class
    from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE

    reqs = requests()
    n_prompt = sum(len(r["prompt_token_ids"]) for r in reqs)
    n_gen = 8 * 32
    by_tp = {}
    first = {}
    engine_args = dict(ENGINE_ARGS, model=T_YI_MODEL)
    for name, (pp, tp) in LAYOUTS.items():
        world = pp * tp
        t0 = time.perf_counter()
        out = serve_layout(pp, tp, engine_args, reqs)
        total_s = time.perf_counter() - t0
        per_rank = [o[0] for o in out]
        got = per_rank[0]["outputs"]
        if (len(got) != 8 or sum(len(v) for v in got.values()) != n_gen
                or any(r["outputs"] != got for r in per_rank)):
            raise AssertionError(f"(t yi {name}) the ranks served "
                                 "different or incomplete outputs")
        if any(r["backend"] != "gloo" or r["graphs"] for r in per_rank):
            raise AssertionError(f"(t yi {name}) expected gloo and no graph")
        total = rank_lines(f"t yi {name}", per_rank, kernels)
        for r in per_rank:
            if any(r["launches"][k.symbol] <= 0 for k in required):
                raise AssertionError(f"(t yi {name}) rank {r['coords']}: a "
                                     "kernel of the path never launched")
            if any(r["launches"][k.symbol] > 0 for k in idle):
                raise AssertionError(f"(t yi {name}) rank {r['coords']}: a "
                                     "kernel of another path launched")
        relocate = ARENA_RELOCATE.symbol
        for r in per_rank:
            if (r["launches"][relocate] > 0) != (r["moves"] > 0):
                raise AssertionError(f"(t yi {name}) {r['moves']} block moves"
                                     f" but {relocate} launched "
                                     f"{r['launches'][relocate]} times")
        if tp > 1:
            acc = by_tp.setdefault(tp, dict.fromkeys(total, 0))
            for s_, v in total.items():
                acc[s_] += v
        wall = per_rank[0]["wall"]
        first[name] = got["s0"][0]
        log(f"(t yi {name}) {T_YI_MODEL} as {world} ranks (pp {pp} x tp "
            f"{tp}) on one card, backend gloo, steps eager (0 graphs), "
            f"gpu_memory_utilization {0.9 / world:.3f} each: prompt tokens "
            f"{n_prompt}, generated {n_gen}, serving wall {wall:.3f} s, "
            f"{(n_prompt + n_gen) / wall:.2f} processed tok/s "
            f"[{smi}]; with the ranks' start {total_s:.1f} s")
    arch = get_model_arch(T_YI_MODEL)
    model = get_model_class(arch.model_type)(arch, dtype=torch.bfloat16)
    params = model.init_params(dev, seed=0)
    ids = reqs[0]["prompt_token_ids"]
    logits = dense_logits(model, params, ids, dev)
    del params
    for name, tok in first.items():
        gap = float(logits.max() - logits[tok])
        log(f"(t yi {name}) s0 ({len(ids)} tokens): first token {tok}, "
            f"dense f32 top {int(logits.argmax())}, logit gap {gap:.5f} "
            f"(tolerance {LOGIT_GAP_TOL})")
        if not gap <= LOGIT_GAP_TOL:
            raise AssertionError(f"(t yi {name}) s0: logit gap {gap}")
    return by_tp


# --------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from vattention_tpu_torch.ops import cuda_build
        from vattention_tpu_torch.ops.arena_copy import ARENA_RELOCATE
        from vattention_tpu_torch.ops.cache_append import (KV_APPEND,
                                                           ROPE_KV_APPEND)
        from vattention_tpu_torch.ops.flash_decode import DECODE_ATTENTION
        from vattention_tpu_torch.ops.flash_prefill import (
            PREFILL_ATTENTION, SEGMENT_PREFILL_ATTENTION)
        from vattention_tpu_torch.ops.norm_act import (ADD_LAYER_NORM,
                                                       ADD_RMS_NORM, GELU_NEW,
                                                       SILU_AND_MUL)
        from vattention_tpu_torch.ops.paged_attention import (
            PAGED_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE)
        from vattention_tpu_torch.ops.pod_fused import POD_ATTENTION
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()
    secs = cuda_build.build_all()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {', '.join(f'{k} {v:.1f}' for k, v in secs.items())})")
    ptxas_report()

    single = [SEGMENT_PREFILL_ATTENTION, PAGED_PREFILL_SINGLE]
    # the layer's elementwise kernels of the llama family and of falcon
    llama_norms = [ADD_RMS_NORM, SILU_AND_MUL]
    falcon_norms = [ADD_LAYER_NORM, GELU_NEW]
    kernels = [ROPE_KV_APPEND, KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
               ARENA_RELOCATE, PAGED_PREFILL_ATTENTION, POD_ATTENTION,
               *single, *llama_norms, *falcon_norms]
    results = kernel_phase(dev)
    for arena in QUANT:
        results += kernel_phase(dev, arena)
    for arena in (torch.bfloat16, *QUANT):
        results += window_phase(dev, arena)
    # (a falcon): every kernel at falcon-7b's heads (71 on 1 kv head)
    for arena in (torch.bfloat16, *QUANT):
        results += kernel_phase(dev, arena, FALCON)
    # (a tp2), (a tp4): every kernel at the heads of one tp rank of Yi-6B
    for geo in YI_TP.values():
        results += kernel_phase(dev, geo=geo)
    results += rope_append_phase(dev)
    results += norm_act_phase(dev)
    counts_b = parity_phase(dev, "fa_vattn", "b", kernels=kernels)
    if counts_b[ROPE_KV_APPEND.symbol] <= 0:
        raise AssertionError("(b) the f32 model never launched kernel A")
    # (b sync): the synchronous engine (enable_async_execution=False)
    counts_bs = parity_phase(dev, "fa_vattn", "b sync", kernels=kernels,
                             async_execution=False)
    if counts_bs != counts_b:
        raise AssertionError(f"(b sync) launches {counts_bs} != (b)'s "
                             f"{counts_b}")
    parity_phase(dev, "fa_paged_16", "b'")
    parity_phase(dev, "fa_pod", "b''")
    # (b8): the f32 tiny model on 1-byte arenas; E's and F's launches on
    # them come from here (the full-width quantized run is fa_vattn only)
    counts_b8 = {}
    for arena, (quant, tag) in QUANT.items():
        counts_b8[tag] = {}
        for backend, kernel in (("fa_vattn", None),
                                ("fa_paged_16", PAGED_PREFILL_ATTENTION),
                                ("fa_pod", POD_ATTENTION)):
            counts = parity_phase(dev, backend, f"b8 {tag}", arena,
                                  kernels)
            if kernel is not None:
                counts_b8[tag][kernel.symbol] = counts[kernel.symbol]
                if counts[kernel.symbol] <= 0:
                    raise AssertionError(f"(b8 {tag}) {kernel.symbol} never "
                                         f"launched on {backend}")
    # (b w): the windowed tiny model (window 96) on the three backends, f32
    # and 1-byte arenas; the windowed 1-byte instances' launches come from
    # here (fa_vattn: B and C; fa_paged_16: E; fa_pod: F)
    counts_bw = {}
    for arena in (None, *QUANT):
        tag = "" if arena is None else QUANT[arena][1]
        counts_bw[tag] = {}
        for backend, used in (
                ("fa_vattn", (PREFILL_ATTENTION, DECODE_ATTENTION)),
                ("fa_paged_16", (PAGED_PREFILL_ATTENTION,)),
                ("fa_pod", (POD_ATTENTION,))):
            counts = parity_phase(dev, backend, f"b w {tag}".strip(), arena,
                                  kernels, model="tiny-mistral-debug")
            for k in used:
                counts_bw[tag][k.symbol] = counts[k.symbol]
                if counts[k.symbol] <= 0:
                    raise AssertionError(f"(b w {tag}) {k.symbol} never "
                                         f"launched on {backend}")
    # (b falcon): the tiny f32 falcon (71 query heads on 1 kv head) on the
    # three backends, f32 and 1-byte arenas; the 1-byte falcon instances'
    # launches come from here (A-D from fa_vattn, E from fa_paged_16, F
    # from fa_pod)
    import shutil
    import tempfile

    falcon_dir = tempfile.mkdtemp(prefix="vattn-tiny-falcon-")
    counts_bf = {}
    try:
        for arena in (None, *QUANT):
            tag = "" if arena is None else QUANT[arena][1]
            for backend, used in (
                    ("fa_vattn", None),
                    ("fa_paged_16", PAGED_PREFILL_ATTENTION),
                    ("fa_pod", POD_ATTENTION)):
                counts = parity_phase(dev, backend,
                                      f"b falcon {tag}".strip(), arena,
                                      kernels, model=tiny_falcon(falcon_dir))
                if used is None:
                    counts_bf[tag] = dict(counts)
                else:
                    counts_bf[tag][used.symbol] = counts[used.symbol]
                k = used or PREFILL_ATTENTION
                if counts[k.symbol] <= 0:
                    raise AssertionError(f"(b falcon {tag}) {k.symbol} "
                                         f"never launched on {backend}")
    finally:
        shutil.rmtree(falcon_dir, ignore_errors=True)
    counts_c, tokens_c = serving_phase(
        dev, kernels, "fa_vattn_2mb", "c",
        required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                  *llama_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
              *falcon_norms])
    # free the (c) engine's memory before the next engine sizes its arena
    gc.collect()
    torch.cuda.empty_cache()
    decode_step_phase()
    gc.collect()
    torch.cuda.empty_cache()
    counts_c8 = {}
    for arena, (_, tag) in QUANT.items():
        counts_c8[tag], _ = serving_phase(
            dev, kernels, "fa_vattn_2mb", f"c8 {tag}",
            required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                      *llama_norms],
            idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
                  *falcon_norms],
            reference=tokens_c, arena=arena)
        gc.collect()
        torch.cuda.empty_cache()
    counts_d, _ = serving_phase(
        dev, kernels, "fa_paged_256", "d",
        required=[ROPE_KV_APPEND, PAGED_PREFILL_ATTENTION, DECODE_ATTENTION,
                  *llama_norms],
        idle=[KV_APPEND, PREFILL_ATTENTION, ARENA_RELOCATE, POD_ATTENTION,
              *single, *falcon_norms],
        reference=tokens_c)
    gc.collect()
    torch.cuda.empty_cache()
    counts_e, _ = serving_phase(
        dev, kernels, "fa_pod", "e",
        required=[POD_ATTENTION, ROPE_KV_APPEND, PREFILL_ATTENTION,
                  DECODE_ATTENTION, *llama_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, ARENA_RELOCATE, *single,
              *falcon_norms],
        reference=tokens_c)
    f, b, c = (POD_ATTENTION.symbol, PREFILL_ATTENTION.symbol,
               DECODE_ATTENTION.symbol)
    log(f"(e) F + B = {counts_e[f]} + {counts_e[b]} against B in (c) "
        f"{counts_c[b]}; F + C = {counts_e[f]} + {counts_e[c]} against C in "
        f"(c) {counts_c[c]}")
    if (counts_e[f] + counts_e[b] != counts_c[b]
            or counts_e[f] + counts_e[c] != counts_c[c]):
        raise AssertionError("(e) the fused launches do not add up to (c)'s")
    gc.collect()
    torch.cuda.empty_cache()
    # (t b), (t yi): tensor and pipeline parallelism, ranks as processes
    t0 = time.perf_counter()
    parallel_parity_phase(dev, kernels)
    log(f"(t b) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_t = parallel_serving_phase(
        dev, kernels, smi,
        required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                  *llama_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
              *falcon_norms])
    log(f"(t yi) in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # (g): mistral-7b past its window, the slice's path at full width;
    # (g') the same requests on the paged and POD backends
    counts_g, ref_g = mistral_phase(
        dev, kernels, "fa_vattn_2mb", "g",
        required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                  *llama_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
              *falcon_norms])
    gc.collect()
    torch.cuda.empty_cache()
    counts_gp, _ = mistral_phase(
        dev, kernels, "fa_paged_256", "g' paged",
        required=[ROPE_KV_APPEND, PAGED_PREFILL_ATTENTION, DECODE_ATTENTION,
                  *llama_norms],
        idle=[KV_APPEND, PREFILL_ATTENTION, ARENA_RELOCATE, POD_ATTENTION,
              *single, *falcon_norms],
        reference=ref_g)
    gc.collect()
    torch.cuda.empty_cache()
    counts_gf, _ = mistral_phase(
        dev, kernels, "fa_pod", "g' pod",
        required=[POD_ATTENTION, ROPE_KV_APPEND, PREFILL_ATTENTION,
                  DECODE_ATTENTION, *llama_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, *single,
              *falcon_norms], reference=ref_g)
    del ref_g
    log(f"(g' pod) F + B = {counts_gf[f]} + {counts_gf[b]} against B in (g) "
        f"{counts_g[b]}; F + C = {counts_gf[f]} + {counts_gf[c]} against C "
        f"in (g) {counts_g[c]}")
    if (counts_gf[f] + counts_gf[b] != counts_g[b]
            or counts_gf[f] + counts_gf[c] != counts_g[c]):
        raise AssertionError("(g' pod) the fused launches do not add up to "
                             "(g)'s")
    gc.collect()
    torch.cuda.empty_cache()
    # (q): qwen-14b's widths with the qkv bias inside kernel A
    t0 = time.perf_counter()
    counts_q = qwen_phase(
        dev, kernels, smi,
        required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                  *llama_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
              *falcon_norms])
    log(f"(q) in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # (k): falcon-7b at full width on the three backends; (k long): its
    # long-context geometry from a checkpoint in falcon's layout
    counts_k, ref_k = falcon_phase(
        dev, kernels, "fa_vattn_2mb", "k", smi=smi,
        required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                  *falcon_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
              *llama_norms])
    gc.collect()
    torch.cuda.empty_cache()
    counts_kp, _ = falcon_phase(
        dev, kernels, "fa_paged_256", "k paged", smi=smi,
        required=[ROPE_KV_APPEND, PAGED_PREFILL_ATTENTION, DECODE_ATTENTION,
                  *falcon_norms],
        idle=[KV_APPEND, PREFILL_ATTENTION, ARENA_RELOCATE, POD_ATTENTION,
              *single, *llama_norms],
        reference=ref_k)
    gc.collect()
    torch.cuda.empty_cache()
    counts_kf, _ = falcon_phase(
        dev, kernels, "fa_pod", "k pod", smi=smi,
        required=[POD_ATTENTION, ROPE_KV_APPEND, PREFILL_ATTENTION,
                  DECODE_ATTENTION, *falcon_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, *single,
              *llama_norms], reference=ref_k)
    del ref_k
    log(f"(k pod) F + B = {counts_kf[f]} + {counts_kf[b]} against B in (k) "
        f"{counts_k[b]}; F + C = {counts_kf[f]} + {counts_kf[c]} against C "
        f"in (k) {counts_k[c]}")
    if (counts_kf[f] + counts_kf[b] != counts_k[b]
            or counts_kf[f] + counts_kf[c] != counts_k[c]):
        raise AssertionError("(k pod) the fused launches do not add up to "
                             "(k)'s")
    gc.collect()
    torch.cuda.empty_cache()
    falcon_long_phase(
        dev, kernels, smi=smi,
        required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                  *falcon_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
              *llama_norms])
    gc.collect()
    torch.cuda.empty_cache()
    counts_f = harness_phase(single)
    counts_f8 = quant_sweeps(single)
    counts_fw = window_sweeps(single)
    counts_ff = falcon_sweeps(single)
    gc.collect()
    torch.cuda.empty_cache()
    # (s): the serving entry points (checkpoint, OpenAI server, allocators)
    counts_s = server_phase(
        dev, kernels, smi=smi,
        required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                  *llama_norms],
        idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION, *single,
              *falcon_norms])
    gc.collect()
    torch.cuda.empty_cache()
    # (r) ... (r yaml): the benchmark package (its output in a temporary
    # directory)
    bench_dir = tempfile.mkdtemp(prefix="vattn-benchmark-")
    try:
        t0 = time.perf_counter()
        bench_phase(dev, kernels, smi, bench_dir)
        log(f"(r) three backends in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        counts_rdyn, row = arrivals_phase(
            dev, kernels, smi, bench_dir,
            required=[ROPE_KV_APPEND, PREFILL_ATTENTION, DECODE_ATTENTION,
                      *llama_norms],
            idle=[KV_APPEND, PAGED_PREFILL_ATTENTION, POD_ATTENTION,
                  *single, *falcon_norms])
        results.append(row)
        log(f"(r dyn) in {time.perf_counter() - t0:.1f} s")
        launcher_phases(dev, smi, bench_dir)
    finally:
        shutil.rmtree(bench_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # (l): the long-context grid's pairs at 64K and 128K, the kernels at
    # depth 131,072, the step profiler and C's plan sweep there
    t0 = time.perf_counter()
    results += long_kernels(dev)
    grid_dir = tempfile.mkdtemp(prefix="vattn-longctx-")
    try:
        counts_l = longctx_phase(dev, kernels, smi, grid_dir)
    finally:
        shutil.rmtree(grid_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    long_tools(smi)
    log(f"(l) in {time.perf_counter() - t0:.1f} s")

    # launches: E's from the paged run (d), F's from the POD run (e), G's
    # and H's from the harnesses (f), A-D's from the vattn run (c); on
    # 1-byte arenas A-D's from (c8), E's and F's from (b8), G's and H's
    # from the quantized sweeps
    launches = {
        "rope_kv_append": (ROPE_KV_APPEND, counts_c),
        "kv_append": (KV_APPEND, counts_c),
        "prefill_attention": (PREFILL_ATTENTION, counts_c),
        "decode_attention": (DECODE_ATTENTION, counts_c),
        # D launches on a serving path only under memory pressure
        "arena_relocate": (ARENA_RELOCATE, counts_rdyn),
        "arena_relocate[r dyn]": (ARENA_RELOCATE, counts_rdyn),
        "paged_prefill_attention": (PAGED_PREFILL_ATTENTION, counts_d),
        "pod_attention": (POD_ATTENTION, counts_e),
        "segment_prefill_attention": (SEGMENT_PREFILL_ATTENTION, counts_f),
        "paged_prefill_attention_single": (PAGED_PREFILL_SINGLE, counts_f)}
    for _, tag in QUANT.values():
        for name, (k, counts) in list(launches.items()):
            if "[" in name:
                continue
            source = (counts_b8[tag] if k in (PAGED_PREFILL_ATTENTION,
                                              POD_ATTENTION)
                      else counts_f8[tag] if k in single
                      else counts_c8[tag])
            launches[f"{name}[{tag}]"] = (k, source)
    # the windowed instances: bf16 from (g) (B, C), (g') (E, F) and the
    # windowed sweeps (G, H); 1-byte from (b w) and the windowed sweeps
    for tag in ("", *(t_ for _, t_ in QUANT.values())):
        by_kernel = {
            PREFILL_ATTENTION: counts_g, DECODE_ATTENTION: counts_g,
            PAGED_PREFILL_ATTENTION: counts_gp, POD_ATTENTION: counts_gf,
        } if not tag else {k: counts_bw[tag] for k in (
            PREFILL_ATTENTION, DECODE_ATTENTION, PAGED_PREFILL_ATTENTION,
            POD_ATTENTION)}
        for k in single:
            by_kernel[k] = counts_fw[tag]
        for k, counts in by_kernel.items():
            name = next(n for n, (k_, _) in launches.items()
                        if k_ is k and "[" not in n)
            launches[f"{name}[{tag + ' ' if tag else ''}w{WINDOW}]"] = (
                k, counts)
    # falcon's instances: bf16 A-D from (k) on fa_vattn_2mb, E from (k
    # paged), F from (k pod); on 1-byte arenas A-F from (b falcon); G and H
    # from (f falcon)
    for tag in ("", *(t_ for _, t_ in QUANT.values())):
        for name, (k, _) in [(n, v) for n, v in launches.items()
                             if "[" not in n]:
            if k in single:
                counts = counts_ff[tag]
            elif tag:
                counts = counts_bf[tag]
            else:
                counts = {PAGED_PREFILL_ATTENTION: counts_kp,
                          POD_ATTENTION: counts_kf}.get(k, counts_k)
            launches[f"{name}[falcon{' ' + tag if tag else ''}]"] = (
                k, counts)
    # Yi's heads on one tp rank: the launches of the (t yi) ranks that ran
    # them, summed (D: once per relocation plan, none at (c)'s sizes)
    for tp in YI_TP:
        counts = counts_t.get(tp, {k.symbol: 0 for k in kernels})
        for name, (k, _) in [(n, v) for n, v in launches.items()
                             if "[" not in n]:
            launches[f"{name}[tp{tp}]"] = (k, counts)
    # kernel A with the rotation in float32 from (b), at mistral's heads
    # from (g)
    # the kernels at depth 131,072 from (l): B from its fa_vattn_2mb cells,
    # E from its fa_paged_256 cells, C from all four
    launches["prefill_attention[128K]"] = (PREFILL_ATTENTION,
                                           counts_l["fa_vattn_2mb"])
    launches["paged_prefill_attention[128K]"] = (PAGED_PREFILL_ATTENTION,
                                                 counts_l["fa_paged_256"])
    launches["decode_attention[128K]"] = (DECODE_ATTENTION, {
        DECODE_ATTENTION.symbol: sum(v[DECODE_ATTENTION.symbol]
                                     for v in counts_l.values())})
    launches["rope_kv_append[f32]"] = (ROPE_KV_APPEND, counts_b)
    launches["rope_kv_append[mistral]"] = (ROPE_KV_APPEND, counts_g)
    # (a norm)'s rows: bf16 from the serving phase at each model's widths,
    # float32 from the tiny f32 models of (b) and (b falcon) on fa_vattn
    by_model = {"yi": counts_c, "mistral": counts_g, "qwen": counts_q,
                "falcon": counts_k}
    by_name = {"add_rms_norm": ADD_RMS_NORM, "silu_and_mul": SILU_AND_MUL,
               "add_layer_norm": ADD_LAYER_NORM, "gelu_new": GELU_NEW,
               "rope_kv_append": ROPE_KV_APPEND}
    for r in results:
        name, _, words = r["name"].partition("[")
        words = words.rstrip("]").split()
        if len(words) < 2 or words[0] not in NORM_MODELS or not re.fullmatch(
                r"T\d+", words[1]):
            continue
        model, f32 = words[0], words[-1] == "f32"
        counts = (by_model[model] if not f32 else
                  counts_bf[""] if model == "falcon" else counts_b)
        launches[r["name"]] = (by_name[name], counts)
    for r in results:
        k, counts = launches[r["name"]]
        r["launches"] = counts[k.symbol]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s, "
        "the kernels' build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # falcon's rows add the bound at the real head dim (bound_real_ms), D's
    # a copy_ of its bytes (copy_ms)
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: r[k] for k in ("bound_real_ms", "copy_ms") if k in r}}
        for r in results]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
